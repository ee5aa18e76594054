#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bigdl_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi``), the torch / CUDA versions and the
   kernel build time;
2. holds each kernel against its plain PyTorch version on the card at the
   serving, LM training and ResNet-50 shapes, and times kernel, plain
   version and the PyTorch call computing the same function
   (``scaled_dot_product_attention``, its backward for K1-bwd; for the
   fused ResNet kernels, which no single call computes, the bare product
   alone: cuBLAS ``x @ w``, or cuDNN's conv for K4) with CUDA events, over
   CUDA graphs of back-to-back launches on inputs rotated past the 50 MB
   L2 where the call can be captured. The flash kernels are checked on
   their routes (bf16: the tensor-core kernels; float32: in 3xTF32 on the
   tensor cores, the forward at every D up to 256 - past D = 112 the wide
   kernel, Q raw in shared memory and P V in slices - and the backward up
   to D = 192 - past D = 64 the wide pair, 64 raw fixed rows a block and
   the products shared out between its two consumer warpgroups) at ragged
   T, D = 32/64/128, the chunk form and kv_len = 0, the backward also in
   the ring form (external delta, float32 gradients, at D = 64, 128 and a
   padded 100) and for bitwise-equal reruns; the float32 forward and
   backward timed at (8,16,256,64) and (2,16,1024,64) on 3xTF32, the wide
   forward at (8,16,256,D) for D = 128, 192 and 256, causal, and in the
   chunk form at D = 128, and checked non-causal and in the chunk form at
   each of those D, and the wide backward timed at (8,8,256,D) for D = 96,
   128 and 192, causal; then one float32 forward of a 2-layer
   TransformerLM at the flagship's widths with 8 heads (D = 128) against
   the CPU, its flash launches two on ``f32_sm90``, and one training step
   of it (forward, ``lm_loss_chunked``, ``torch.autograd.grad``) against
   the CPU, two ``flash_fwd`` and two ``flash_bwd`` launches on
   ``f32_sm90``;
   K2 (split-K, ``paged_attention_sm90``)
   at decode in float32 and bf16 pages, at positions up to 4096, in the
   chunk form (S = 32) and at the speculative verify (B8, S = 5), each
   timed beside the unsplit kernel it succeeds
   (``paged_attention.cu``), with grouped-query heads, the padded slot at
   position 0, a table one split wide and bitwise-equal reruns; then
   every other head dim the attention kernels are instantiated for (each
   multiple of 16 up to 128 on the bf16 flash kernels, up to 256 on the
   float32 forward's 3xTF32 route and on K2, up to 192 on the float32
   backward's, causal and, past 64, non-causal) and their padded route (a
   D not a multiple of 16),
   with the launches by route, and the bf16 flash pair timed at D = 96
   (hidden 768, 8 heads) at the training shape. The fused ResNet kernels
   are checked on all four routes (bf16 and float32 in 3xTF32 on the
   tensor cores, aligned and, at any other K and N (K4: C and N), with
   the cores' ragged load / store policy, K4's with a ragged 3x3 gather
   over taps zero-padded in its weight's scratch) at small and ragged
   shapes (K ending mid-k8 / mid-k16; K4 at C = 50, 20 and 7, N odd), at
   pad taps where relu(b) != 0, K3 and K5 also without statistics at M = 147
   and K5 at the ReLU's tie, with the float32 launches by route, and,
   with two launches bit for bit equal, at every distinct ResNet-50
   B256/224 shape of K3 (forward and backward), K4 and K5 in bf16 and
   every B32/224 shape of K3, K4 and K5 in float32 (also forced onto the
   ragged route, for comparison; K5's h also written into a NaN-filled
   buffer, which must come back whole), and K3 / K5 at truly ragged
   shapes in both dtypes (K3 K 63 / N 255, K5 K 255 / N 63; each call's
   peak memory beyond its outputs held to its weight-sized scratch) and
   K4 at the width-50 chain's 3x3 (C = N = 50, float32 B32/56 and bf16
   B64/56) and the bf16 stage-0 shape forced onto ``bf16_ragged``, each
   timed with its library call and bound; then the width-50
   ``FusedBottleneckChain``'s training step beside the width-48 one in
   both dtypes, their 3x3 convs through K4 (``fused_conv2``; card against
   CPU, launches by route, device ms, peak memory: no activation copied
   or padded); the launches a step times the
   time of each family is printed against the measured steps of phases 7
   and 8. K5's bf16 stage-0 junction must take at most 1.0 ms forward and
   3.0 ms backward; in float32 at B32, K3's stage-0 conv3 at most 0.12 /
   0.40 ms and K5's stage-0 junction 0.20 / 0.60 ms; the float32 flash
   forward and backward at (8,16,256,64) must beat SDPA (forward,
   backward) and K4's float32 stage-0 call, on its aligned route and
   forced onto the ragged one, cuDNN's float32 conv, timed in the same
   run, and K2's decode case must take at most a third of the unsplit
   kernel's time.
   The tensor-core libraries (``*_sm90``) must build without spills (the
   ragged ``fused_matmul`` / ``fused_chain`` report theirs: the bf16 ragged
   dw kernels' consumers spill at the 224 registers they leave their
   producer's batched loads);
3. runs ``Transformer.generate`` on the flagship TransformerLM (vocab
   32000, hidden 1024, 16 heads, filter 4096, 12 layers, bf16 weights,
   batch 8, prompt 128) and checks ``prefill`` (causal flash kernel)
   against ``prefill_chunked`` (rectangular-causal flash kernel);
4. serves 16 greedy requests of mixed lengths through
   ``DecodeScheduler`` and checks each against a solo decode of its prompt
   up to the first near-tie;
5. trains the flagship with the repository's bf16 LM recipe (float32
   masters, ``bf16_params``, ``hidden_states(training=True)``,
   ``lm_loss_chunked(chunk=128)``, ``SGD(0.01, momentum=0.9)``) at batch
   16 x 1024 tokens, remat off and on: 1 warmup step and 5 steps on one
   fixed batch, each loss and gradient finite and the last loss below
   the first;
6. trains through the normal entry point, ``LocalOptimizer`` with
   ``LMCriterion`` and ``SGD(0.01, momentum=0.9)``, 4 iterations of
   batch 8 x 256 tokens on float32 parameters;
7. runs one training step of ResNet-50 (``fused="pallas"``, NHWC,
   ``fused_conv2``) at B2/224 on the card and on the CPU with the same
   weights, in float32 and through the bf16 recipe (logits, running
   statistics, gradients; the max pool's ties in float32),
   then trains full-width, full-depth ResNet-50 with the repository's
   recipe (``bench.py`` ``_build_resnet_step``: float32 masters,
   ``bf16_params``, bf16 images, ``CrossEntropyCriterion`` on float32
   logits, ``SGD(0.1, momentum=0.9)``) at B256/224, ``fused_conv2`` off
   and on: 1 warmup step and 4 steps on one fixed batch, then (off arm)
   2 steps under ``torch.profiler``: CUDA kernel time a step against the
   untraced step, and the largest kernels;
8. trains ResNet-50 through ``Optimizer.create`` (a ``LocalOptimizer``)
   over a DataSet of image Samples, 3 iterations of B32/224, float32, then
   2 more under ``torch.profiler``: CUDA kernel time a step by family;
9. serves the flagship again (vocab 32000, hidden 1024, 16 heads, filter
   4096, 12 layers, ``max_len`` 512, bf16 weights, float32 pages) through
   ``DecodeScheduler(max_slots=8, block_size=16, prefill_chunk=32)`` with
   the serving depth on: (a) the prefix cache - 6 system prompts of 448
   tokens with 4 suffixes of 8 each, one request a prompt and then the
   other 18, without the cache and with it: 18 hits reusing 448 tokens
   each, only the tail chunk rerun, an exact aligned repeat over
   copy-on-write forks with the registrant's and a third request's tokens
   unchanged, ``defrag()`` then a warm hit, every block back and the
   audit clean at shutdown, cold and warm TTFT; (b) speculative decoding
   (``spec_k=4``) with a draft whose target adds zero past it
   (``bench_serving.py`` ``_build_spec_pair``; at least 3.0 of 4 accepted
   a row round) and a 2-layer draft of its own seed whose final LayerNorm
   gain is negated (under 1 of 4 accepted: a random LM of this width
   repeats its last token, so an unchanged random draft would agree), 16
   requests against
   the plain scheduler, tokens/s of each, and ``speculative_generate`` at
   batch 8 against ``generate``, the verify's K2 launches (S = 5) 12 a
   speculative round; (c) the host tier under a pool that holds 2 of the
   6 chains, without the tier, with it (each spill staged before the next
   request) and with it unsettled (refills overlapping the spills their
   admission starts: the timed run): spills, refills, bytes and GB/s each
   way, tokens against the run without the tier; then a priority-1
   request into a pool full of priority-0 ones (preempted, resumed,
   tokens unchanged), no swap thread left. Tokens are held against a
   dense teacher-forced forward (or the other run) up to the first step
   whose top-2 margin is under 0.1. A random LM of this width repeats its
   last token, so its tokens say little of the KV pages; the pages are
   checked themselves: each prompt's resident chain against the dense
   prefill's K / V (within ``PAGE_TOL`` of each layer's largest value),
   the chains bit for bit unchanged by the copy-on-write repeat and by
   defrag and equal between the runs with and without the tier, every
   page copy (fork, defrag) bit for bit equal to its source, and every
   refill (a chain's, the preempted request's) bit for bit equal to what
   its spills captured, gathered right after its scatter;
10. drives the serving control plane (``bigdl_tpu_torch.observability``,
   ``parallel.chaos``, ``parallel.failure``): (a) the flagship of phase 9
   under ``DecodeScheduler(fault_policy=FaultPolicy(max_restarts=2,
   backoff_base_s=0))``, each request submitted before the loop starts,
   once fault-free and once with chaos at ``serving/prefill`` and
   ``serving/scheduler_step`` and two transient faults raised after a
   forward wrote its pages, then the same with phase 9's accepting draft
   pair and chaos at ``serving/spec_round``: tokens and every resident
   chain bit for bit the fault-free run's, ``step_replays`` the chaos
   fires plus the post-write faults, K2 on ``f32_split`` only, launched
   the fault-free run's count plus exactly the failed units' launches;
   (b) a phantom block reference under the running loop with
   ``audit_every=1``: ``kv_corruptions`` 1, quarantined, one
   ``health/kv_corruption`` event and one crash bundle in a temporary
   directory, the in-flight requests finish and a repeat adopts no
   prefix; (c) two replicas ``r0`` / ``r1`` (``stall_deadline_s=1.0``)
   behind ``Router``: a 3 s chaos wedge at r1's second decode step raises
   ``health/stall``, the router drains r1 and every request finishes on
   r0, r1 rejoins on ``health/stall_recovered``, a repeated system prompt
   goes to its holder; (d) ``ServingEngine`` over ResNet-50 (NHWC,
   ``fused="pallas"``, ``fused_conv2``, float32, eval, 224x224,
   ``max_batch=32``): 64 requests, one transient fault at
   ``serving/engine_dispatch``, a hot swap in mid-traffic; every row bit
   for bit its version's direct ``apply(training=False)`` on the padded
   bucket, one bucket within 1e-4 of the CPU plain path, 24 K3, 12 K5 and
   16 K4 a batch on ``f32_sm90`` without statistics and no other kernel;
   images/s and latency p50 / p99 printed as smoke readings; (e)
   ``health.sample_device_memory()`` reports bytes in use; and K3, K4 and
   K5's no-statistics calls at their stage-0 B32 shapes against their
   plain versions, timed (the ``_eval`` rows);
11. drives generation depth: (a) ``generate_beam`` on the flagship of
   phase 9 (bf16 weights) at batch 8, prompt 128, 32 new tokens, beam 4:
   one prefill on the un-repeated batch (12 K1-fwd launches on
   ``bf16_sm90``, no other kernel), shape, id range, the prompt kept, and
   ``beam_size=1`` token for token ``generate``'s greedy ids; (b) the
   Transformer "base" of Vaswani et al. 2017 (6 + 6 layers, d_model 512,
   8 heads, d_ff 2048, the 37000 shared vocabulary of WMT14 En-De,
   ``max_len`` 256, float32, random weights from seed 0) trained through
   ``LocalOptimizer`` for 4 iterations on one repeated batch of 64
   synthetic pairs (source and target lengths drawn in 16-64, padded with
   0 by ``PaddingParam`` into ``Table`` batches) with
   ``TimeDistributedMaskCriterion(CrossEntropyCriterion(), 0)`` and
   ``SGD(0.1, momentum=0.9)``, validated every 2 iterations with ``Loss``
   and ``Top1Accuracy`` on 128 held-out pairs: losses finite and
   falling, ``state["score"]`` written, validation results finite; then
   ``translate`` and ``translate_beam`` (beam 4) at batch 8, source 64,
   64 new tokens: ids in range, ``beam_size=1`` bit for bit
   ``translate``; no kernel launched by any of (b), whose attention is the
   masked einsum as in JAX; (c) the same initial weights cut to 2 layers,
   full width, float32, on the CPU and on the card: logits within 1e-4 of
   the largest, greedy tokens equal up to the first step whose top-2
   margin is under that tolerance;
12. drives the training loop's depth on ResNet-50 (NHWC, ``fused="pallas"``,
   float32, B32/224, built once from seed 0, its initial weights kept on
   the host) through ``Optimizer.create`` over 256 image Samples (8
   batches), ``CrossEntropyCriterion`` and ``SGD(0.1, momentum=0.9)``,
   with cuDNN deterministic (restored afterwards): (a) the reference,
   ``set_prefetch(0)``, 'sync', checkpoints every 4 iterations
   (``overwrite=False``), 8 iterations, run twice as the determinism
   control (when the two differ, ``torch.use_deterministic_algorithms``
   names the op and the other runs are held to 4x their spread instead
   of bit for bit); (b) ``set_prefetch(2)``, 'window:4', ``set_superstep
   (4)`` and async checkpoints: parameters, model state, every step's
   loss and both checkpoints as (a)'s, ``optim/loss_syncs`` 2 against 8,
   (a)'s launches, no stager thread left; (c) a fresh start that loads
   (a)'s iteration-4 checkpoint and trains the epoch's other four
   batches (the loop restarts its epoch, as JAX's does): (a)'s end state
   and optimizer state; (d) (a) with 'resume' and a NaN image in batch
   6: one restore, the state right after it the iteration-4 checkpoint's
   bit for bit, a finite loss, neval / epoch 8 / 2 (what the CPU test
   shows JAX's loop gives); (e) the stem and the first stage frozen, 2
   iterations, also with ``fused_conv2``: the frozen parameters bit for
   bit, every other module moved, the same K3 / K5 launches (16 K4 an
   iteration with ``fused_conv2``); (f) ``Adagrad``, ``Adadelta``,
   ``Adamax``, ``RMSprop``, ``Ftrl``, ``LarsSGD``, ``ParallelAdam`` and
   SGD under ``Plateau``, 2 iterations each (finite losses, parameters
   moved), then one update of ResNet-50's parameter tree with seeded
   gradients on the card within 1e-6 (relative to each leaf's largest
   value) of the same update on the CPU; (g) a regularized conv / linear
   net trained 2 steps on the card and on the CPU, within 1e-5; it
   prints (a)'s and (b)'s step_time and data_time medians and wall
   times and a checkpoint's bytes and seconds, sync and async, with the
   card's name and power limit, and two timing arms without checkpoints:
   (a) with cuDNN's default algorithms and (b) with its groups stacked
   inline (``set_prefetch(0)``; its end state held to (a)'s);
13. drives the Torch-style layer library and the classic image zoo in
   float32 with TF32 off, where no port kernel may launch: (a) LeNet-5
   through ``Optimizer`` (``ClassNLLCriterion``, ``SGD(0.05,
   learningrate_decay=0.0002)``, ``max_epoch(2)``, B128) on 2048
   seeded synthetic digits with ``set_validation(every_epoch(), ...,
   [Top1Accuracy(), Top5Accuracy(), Loss()])`` (the loss falls), then
   one manual Torch-protocol step (``forward``, criterion ``forward`` /
   ``backward``, ``backward``, ``get_parameters``) on the card against
   the CPU within 1e-4; (b) Inception v1 at B64/224 through
   ``Optimizer.create`` (``SGD(0.01, momentum=0.9)``, 1 warmup
   iteration then 4) and (c) the three-head Inception v2 at B32/224 (3
   iterations; the mean NLL of its heads), each with one evaluation-mode
   step at B2/224 on the card against the CPU (logits and the median
   gradient leaf within 1e-4, the worst leaf 1e-2); (d) VGG-16 at
   B32/224 and VggForCifar10 at B128/32, 3 iterations each; (e) JAX's
   default ResNet-50 (NCHW, ``fused="none"``) at phase 8's recipe
   (B32/224, ``CrossEntropyCriterion``, ``SGD(0.1, momentum=0.9)``, 3
   iterations, then 2 under ``torch.profiler``), its step and CUDA
   kernel time by family printed beside phase 8's fused step, and one
   NHWC and one ``stem="s2d"`` run (B8, 2 iterations); (f) ResNetCifar-20
   (shortcut A) at B128/32, 3 iterations. Every model trains on one
   fixed batch: every loss finite, the batch's loss with the same
   dropout draws lower after than before and its gradients finite; it
   prints each model's step ms, images/s and peak memory and the
   phase's time;
14. drives the sequence zoo in float32 with TF32 off, where no port
   kernel may launch: (a) PTBModel at PTB's medium width (vocab 10000,
   hidden 650, 2 LSTM layers, T35, B64) through ``Optimizer.create``
   (``TimeDistributedCriterion(ClassNLLCriterion())``, ``SGD(0.01)``, 6
   iterations) on one fixed batch of ``ptb_synthetic``'s stream, then two
   iterations under ``torch.profiler`` (CUDA kernel ms by family,
   launches a step, the device's busy share) and two ``cell_type="gru"``
   iterations; (b) TextClassifier (20 classes, embedding 50, sequence 500,
   256 filters or LSTM units; ``cnn`` and ``lstm``) at B128 on
   ``tokenize_to_glove_sequences`` of ``news20.synthetic`` with
   ``set_validation(every_epoch(), ..., [Top1Accuracy()])``; (c)
   BinaryTreeLSTM (embedding 300, hidden 150) under a Linear +
   LogSoftMax head on the root at B25 on random binary trees of 30 leaves
   (59 nodes, the full sweep) with ``TreeNNAccuracy``; each model trains
   on one fixed batch, checked as in phase 13, and prints its step ms,
   tokens (documents, trees)/s and peak memory; (d) every other new
   class (the rest of ``nn/linear.py``, each cell under ``Recurrent``,
   ``MultiRNNCell``, ``BiRecurrent``, ``RecurrentDecoder``,
   ``TimeDistributed``, ``ConvLSTMPeephole``, the temporal, connection-
   table, volumetric and locally connected convolutions,
   ``BinaryTreeLSTM``, ``SimpleRNN``) on the card against the CPU, one
   training-mode forward and every gradient within 1e-4 of the largest
   value; (e) ``LBFGS.optimize`` with its line search on a softmax
   regression on the card against the CPU, the losses within 1e-4;
15. drives the training loop's remainder on the flagship at full width
   (float32 parameters, B8/T256, ``LMCriterion``, ``SGD(0.01,
   momentum=0.9)``, 6 iterations): (a0) plainly, then (a) with
   observability on, a ``FuncTransformer`` chain over the samples,
   ``prepare_input``, train and validation summaries (validation every 3
   iterations, ``LearningRate`` every 2), anomaly detection and a stall
   deadline, the event files read back with ``read_scalar`` and the
   flight ring checked; (b) the same with a ``FaultPolicy`` and one
   ``TransientDeviceError`` raised after the third step wrote its tensors,
   the final parameters bit for bit (a)'s; (c) a data set that blocks
   before batch 3 until ``RemediationPolicy(halt_on_stall=True)`` queued
   its halt (2 s deadline after the grace): ``TrainingHalted`` with the
   side thread's checkpoint at neval 2, equal to the parameters after
   step 2, and no thread left; (d) lr 0 on one repeated batch with
   ``Plateau`` and an early stop at the first plateau; (e) ``save`` /
   ``load`` of (a)'s model (logits bit for bit), a ``clone`` stepped once
   beside the unchanged original, ``predict`` over a chained data set
   with a ragged last batch against the per-batch forward, and
   ``predict_class`` on float32 ResNet-50 (``fused_conv2``) at B32/224
   against the argmax of its eval forward, with its BatchNorm state
   through ``get_extra_parameter`` / ``set_extra_parameter``; (f)
   ``flash_attention_fused`` (forward and gradient) and
   ``flash_chunk_attention`` against the plain versions at phase 2's
   tolerances. It prints each run's step ms: (a) against (a0) is the
   cost of observability, (b) against (a) the fault policy's snapshot.
16. drives the image input pipeline into ResNet-50's three fused arms,
   the counterpart of ``examples/imagenet_folder_train.py`` at its
   defaults: (a) a folder of 4 classes of 128 JPEGs at 256x256, written
   with the port's ``encode_jpeg``, through ``JpegFolderPrefetcher(
   out="bf16_nhwc", augment=True, stage_to_device=True)`` (pinned slots,
   non-blocking copies, a CUDA event a slot) into the bf16 recipe at
   B256/224 (SGD(0.05, momentum=0.9)) under ``fused="xla"`` (no kernel),
   ``fused="pallas"`` chained (24 K3 and 12 K5 a step, forward and
   backward) and ``fused_chain=False`` (36 K3, no K5), printing per arm
   the step ms, images/s, peak memory, the host's decode images/s and the
   share of the step spent in ``pf_next``; without libjpeg in the native
   build it says so on its own line and feeds the arms from
   ``NativePrefetcher`` over raw uint8 arrays; (b) the three arms on one
   float32 batch, TF32 off, with the same weights carried across their
   layouts, against the ``"xla"`` arm; (c) ``ImageNetDataSet(train=False)``
   over a validation folder into the chained model with ``fused_conv2``
   (K3 / K4 / K5 without statistics), LeNet-5 and ResNetCifar-20 trained
   through ``LocalOptimizer`` from ``NativePrefetcher`` over the MNIST /
   CIFAR ``synthetic`` arrays, and ``read_tfrecords_native`` against the
   Python reader.
17. drives the recommender and detection slice: (a) ``MoETransformerLM``
   at ``bench_extra.py bench_moe_lm``'s width (vocab 32000, hidden 1024,
   16 heads, filter 4096, 12 layers, 8 experts on every second block) at
   B8/T1024 through its bf16 recipe (``bf16_params``,
   ``hidden_states(training=True)``, ``lm_loss_chunked(chunk=128) + 0.01
   aux``, SGD(0.01, momentum=0.9)), remat off and on, 2 warm-up and 5
   timed steps each: step ms, tokens/s, peak memory, the K1 launches a
   step by route (12 K1-fwd, 24 with remat, and 12 K1-bwd, all on
   ``bf16_sm90``) and each MoE layer's dropped tokens and shared capacity
   slots; the bf16 flash pair at its shape (8,16,1024,64) timed with SDPA
   and its bound; (b) ``generate`` at batch 8, prompt 128, 32 new tokens
   (12 K1-fwd launches), and the full-width model at depth 2 in float32
   against the CPU at 1e-4; (c) ``top1_routing`` on seed-0 bf16 logits at
   8192 tokens over 8 experts, card against CPU bit for bit (the bf16
   queue positions share slots past 256 on both); (d) NeuralCF and
   Wide&Deep at ``examples/ncf_movielens.py``'s widths on MovieLens'
   synthetic stand-in at ML-1M's counts (its leave-one-out split runs in
   a process of its own from the start of the run) through
   ``LocalOptimizer`` (B256, Adam(0.02), BCECriterion, 300 steps over a
   seeded sample of the training pairs), HitRatio@10 and NDCG@10 over
   every user, step ms and samples/s, and one batch card against CPU; (e)
   LeNet-5 as a ``Graph`` against its ``Sequential`` twin (bit for bit)
   and against the CPU, and a ``DynamicGraph`` with ``Switch`` /
   ``Merge`` down both branches; (f) SSD300-VOC's post-processing (six
   ``PriorBox`` maps, 8732 priors, ``DetectionOutputSSD(21, nms_topk 400,
   keep_topk 200)`` at B8) and Faster R-CNN VGG-16's test settings
   (``Proposal(6000, 300)`` on a 38x50 map, ``RoiPooling(7, 7, 1/16)``
   and ``RoiAlign`` over its rois of a (1, 512, 38, 50) map,
   ``DetectionOutputFrcnn``), each card against CPU with the detections,
   labels and scores equal, and ms a call.

18. trains across GPUs through ``DistriOptimizer`` (phase 18,
   ``distributed``; sizes in ``DIST18``): (a) the flagship at
   ``bench_transformer_lm``'s width, float32 parameters, B16/T1024, on a
   one-rank NCCL group - replicated equal to ``LocalOptimizer`` after 3
   steps, then ``replicated``, ``zero1``, ``zero1`` with
   ``compress="bf16"`` and with ``wire_dtype="bf16"``, 1 warm-up and 2
   timed steps each (step ms, tokens/s, peak GiB, K1 launches by route,
   the collectives' bytes a step, NCCL's kernel ms in a profiled step);
   (b) ResNet-50 fused NHWC float32 B32/224, local / replicated (equal
   running statistics) / ZeRO-1 with ``fused_conv2``; (c) two ranks
   sharing the card over gloo (this script with ``--phase18-rank``), every
   mode on the flagship cut to 2 layers against one rank, and a
   BatchNorm model in replicated mode; (d) ``probe_mesh``, a
   ``Heartbeat`` and a ``StragglerMonitor`` over the two ranks and an
   ``ElasticRunner`` drill (ZeRO-1 halts after step 2 on both ranks, rank
   0 resumes alone on one NCCL rank from the canonical checkpoint to
   step 4, against an uninterrupted one-rank run).
19. model parallelism (phase 19, ``model_parallel``; sizes in ``MP19``),
   on two gloo ranks sharing the card (this script with
   ``--phase19-rank``): (a) the flagship (bf16 weights, float32 pages)
   served by ``DecodeScheduler(mesh=<('model',) of 2>)`` over a
   tensor-parallel registry, the first 4 of phase 4's requests, tokens
   against the one-rank scheduler, each rank's pages (8 of 16 kv heads) against the
   one-rank pool's heads, K2 launches and resident bytes per rank, and
   ``generate`` over the placed weights (K1-fwd at 8 heads); (a2) the same
   tensor-parallel scheduler with the host KV tier and a 24-block pool,
   three requests in turn (the second spills the first's chain, the
   third refills it): spill / refill counts and bytes equal on both
   ranks, each rank's refilled pages bit for bit as spilled; (b) the first
   4 of the same requests, budgets capped at 32, under FSDP on a ('data',)
   mesh (the flagship cut to 4 layers), peak memory per rank; (c) ``ServingEngine(mesh=,
   placement="fsdp")`` on the flagship's forward at 4 layers against one
   rank, the model's per-block gathers beside the whole-tree gather, peak
   memory per rank; (d) ``Attention(seq_axis='seq')`` by
   ring and all-to-all, bf16 and float32, B2/T2048, forward and gradients
   against one rank's flash, the hop's route; (e) the time-sharded decode
   across the shard edge; (f) tensor-parallel and FSDP training of the
   depth-2 flagship against one rank; (g) ``gpipe`` and ``moe_ffn`` over
   the two ranks.
20. the serving fleet across processes (phase 20, ``fleet``; sizes in
   ``FLEET20``): three agent processes (``python -m
   bigdl_tpu_torch.serving.fleet``) of the flagship, bf16 weights from
   one float32 parameter file, started at once: (a) ``Router`` over the
   replica r0 serves phase 4's requests, tokens against phase 4's up to
   the first near-tie; (b) ``DisaggregatedFleet`` from the prefill agent
   to the decode agent: every aligned prompt hands off (none failed or
   refused), the decode agent's adopted pages bit for bit the export,
   the export against the dense prefill; (c) a fleet swap to a second
   version over the three agents with requests in flight, no response
   mixing versions; (d) ``FleetController.tick()`` scales up by a fourth
   agent warmed from r0 and back down, no request lost. The agents report
   their kernel launches through the ``stats`` op.
21. int8 quantization (phase 21, ``quantized``; sizes in ``Q21``): (a) the
   int8 GEMM ``csrc/int8_gemm_sm90.cu`` bit for bit an exact reference, in
   int32 and with the quantized layers' fused epilogue (float32 acc * s +
   bias), at Inception's first convolution (K = 147), a 3x3 at K = 1440,
   a depthwise 3x3 (G = C, K = 9) and a ragged shape (int32 on the host)
   and at every distinct contraction of (b)'s forward (a float64 product
   on the card), the kernel timed alone (CUDA graphs) beside
   ``torch._int_mm`` where it takes the shape, a bf16 product and the
   bound, and summed over the forward's 58; (b) int8 Inception v1
   (``calibrate`` on 8 images, ``quantize(calibration=)``, B32/224)
   against the float model (top-1 agreement >= 0.5, relative logit error
   < 0.25), images/s and the kernel's launches by route (57 + 1, their
   shapes (a)'s), and a profile of two forwards split by family (the
   GEMM, the im2col / pad copies, the activation quantize, what is left
   of the rescale, everything else), launches and busy share; (c) the flagship served from bf16, int8 and int4
   weights published with ``transform=quantize_lm_params``: logits
   against bf16 (0.08 / 0.2), served pages against the dense prefill,
   ``lm_quantized_bytes`` against its formula, tokens/s; (d) phase 5's
   remat-off step runs through ``observability.perf``: its ``perf/mfu``
   in (0, 1] and its counted FLOPs 0.98 - 1.25 x bench_extra.py's
   analytic count. ``int8_gemm`` in the kernels line carries phase 21
   (b)'s launches and routes (the comparisons of (a) are not counted),
   the fused ms and (a)'s sums over the 58.
22. the model-file formats and the TF-style ops (phase 22, ``loaders``;
   sizes in ``L22``): (a) phase 4's flagship with bf16 weights through
   ``loaders.bigdl_proto.save_bigdl`` and ``load_bigdl(device=None)``:
   every leaf bit for bit, ``generate`` at B8 / prompt 128 token for
   token the original's (12 K1-fwd launches each on ``bf16_sm90``), 4 of
   phase 4's requests through ``DecodeScheduler`` on both models with
   tokens and each prompt's resident pages bit for bit, request 0's pages
   against the loaded model's dense prefill, K2 on ``f32_split``; save
   and load seconds and the file's bytes; (b) B8/224 against the original
   in evaluation mode, TF32 off: ResNet-50 through ``save_tf`` ->
   ``load_tf_graph``, Inception v1 through ``save_caffe`` ->
   ``load_caffe`` and ``save_bigdl`` -> ``load_bigdl``, VGG-16 through
   ``save_torch`` -> ``load_torch``, bit for bit where the loaded layers
   are the original's classes (bigdl.proto, Torch7), else within a
   relative ``LOAD22_TOL``; each round trip's seconds; (c) every op of
   ``ops.__all__`` on the card against the CPU (integers, booleans and
   strings equal, floats within ``OPS22_TOL``; ties in top-k, segment
   sums, gathers out of range, a shrinking resize). The K1-fwd and K2
   launches of (a) are on the ``flash_fwd`` / ``paged_attention`` rows.
23. the Keras-1.2 API and converter, dlframes and util (phase 23,
   ``keras_frames``; sizes in ``K23``): (a) Keras 1.2.2's ResNet-50 as
   its functional JSON (``keras_resnet_json``) through
   ``model_from_json(device=)`` and ``load_weights`` of Keras-layout
   weights, ``predict`` at B8/224 against the CPU and against its "tf"
   spelling within ``KERAS23_TOL`` (TF32 off), ``compile`` / ``fit`` of 2
   steps / ``evaluate``; (b) Keras 1.2.2's ``imdb_cnn_lstm.py``
   ``Sequential`` trained at batch 30, 3 losses against the CPU's
   (Dropout p = 0), the real model's step ms; (c) ``DLClassifier`` over
   float32 ResNet-50 (NHWC, ``fused="pallas"``) fit on a dict of columns
   at B32/224 for an epoch, ``fused_conv2`` off and on, K3 / K5 (K4)
   launches on ``f32_sm90``, ``transform`` equal to 1 + argmax of the
   eval forward; (d) ``util.common`` and ``DLImageTransformer`` on a
   dict image column. (c)'s and (d)'s launches are on the ``_f32`` and
   ``_eval`` rows.

The kernels' launch counters are set to 0 just before each path is driven
(``generate``, ``prefill_chunked``, serving after the scheduler's warmup,
each training step, each ``LocalOptimizer`` run, each phase 9 scheduler
run and ``speculative_generate``, phase 11's ``generate_beam`` and each of
its translation paths, each phase 12 run, each phase 13 and 14 model, each
phase 15 run, ``predict_class`` and flash entry, each phase 17 training
step and ``generate``, each phase 23 fit and transform) and read just
after; a
path's kernel launched other than its expected number of times (once per
layer and prefill piece or LM training step, twice for the forward with
remat; per ResNet-50 step 24 K3 and 12 K5 forwards and as many backwards,
16 K4 forwards with ``fused_conv2``), or any other kernel launched, fails
the run; so does a flash, K3, K4 or K5 launch on another route than the
path's dtype and shapes give (``bf16_sm90`` in ``generate``,
``prefill_chunked`` and the bf16 recipes; in the ``LocalOptimizer`` run
``f32_sm90`` for the flash forward and backward; ``f32_split`` for K2 in
serving, phase 9 included, where K2 is the only kernel; ``f32_sm90`` for
K3, K4 and K5 in phases 7 and 8). Every check
that fails exits non-zero. The line before the last is one JSON object with
each kernel's numbers (``flash_fwd`` at the serving prefill shape with the
launches of ``generate`` and of phase 11's ``generate_beam``, ``flash_fwd_train`` at the training shape with the
launches of the five remat-off training steps, ``flash_bwd`` likewise,
``flash_fwd_chunk`` with the ``prefill_chunked`` launches, the ``_f32``
rows at the ``LocalOptimizer`` shape with its launches by route, the
wide 3xTF32 forward's row (``flash_fwd_f32_wide``) at D = 128 with the
D = 128 LM forward's and training step's launches, the wide backward's
(``flash_bwd_f32_wide``) at D = 128 with the training step's; K2's rows at
the decode and long decode cases with the serving launches by route, its
verify row with the verify launches (S = 5) of phase 9's two speculative
runs, and the unsplit kernel's row at the decode case; the fused ResNet kernels at
their timed shapes with the launches of the four ResNet-50 steps of the arm
that runs them, their ``_f32`` rows (3xTF32) at phase 8's stage-0 shape
with its launches (K4's with those of phase 7's float32 step, and its
ragged routes' rows beside it, ``fused_conv_f32_ragged`` at the stage-0
shape forced onto ``f32`` and ``fused_conv_bf16_ragged`` at the width-50
chain's 3x3, each with the chain step's launches on its route; each with
phase 12's launches added;
phase 15's K1 launches on the ``_f32`` rows and its flash entries' on
their routes' rows, its ``predict_class`` launches on the ``_eval``
rows; phase 16's bf16 K3 / K5 launches on the bf16 rows, its float32
ones on the ``_f32`` rows and its validation's on the ``_eval`` rows;
``flash_fwd_moe`` / ``flash_bwd_moe`` at the MoE LM's shape with phase
17's training launches, and its ``generate`` launches on ``flash_fwd``);
the flash, K3, K4 and K5 rows carry their
``dtype_route``, K4's aligned float32 row its ragged route's
``ragged_ms``);
phase 18's float32 K1 / K3 / K4 / K5 launches on the ``_f32`` rows;
phase 19's K1 launches, both ranks, on ``flash_fwd`` / ``flash_bwd``
(bf16) and the ``_f32`` rows, its K2 serving launches on
``paged_attention``; phase 20's agents' K2 launches on
``paged_attention`` and their flash launches on ``flash_fwd_chunk``;
phase 23's DLClassifier fits on the ``_f32`` K3 / K5 / K4 rows and its
transforms on the ``_eval`` rows; the four ragged K3 / K5 rows
(``fused_matmul_f32_ragged``, ``fused_chain_f32_ragged`` and their bf16
twins) at the truly ragged shapes, the backward's readings beside the
forward's, with the width-50 chain step's launches on their routes);
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""
import atexit
import contextlib
import datetime
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TF32_FLOPS = 494.7e12            # dense tf32 tensor cores (data sheet)
L2_BYTES = 50 * 2**20


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def only_on(counts, route, n):
    """A wrapper's launches by route are ``n`` on ``route`` and none on
    any other (the padded routes and ``bf16_ragged`` included)."""
    return counts == {r: (n if r == route else 0) for r in counts}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


_CAPTURE = {}


def graph_ms(torch, fn, n_sets, reps=20, iters=7):
    """Median device milliseconds of one ``fn(i)`` call: ``reps`` calls
    (i = 0, 1, ...; callers rotate over ``n_sets`` input copies) are
    captured in one CUDA graph and replayed ``iters`` times between CUDA
    events. All captures share one side stream: cuBLAS keeps a workspace
    for every stream it has run on for the life of the process, so a new
    stream per capture would leave tens of MiB allocated per timed call
    and inflate the later phases' peak-memory readings."""
    s = _CAPTURE.get("stream")
    if s is None:
        s = _CAPTURE["stream"] = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(2):
            fn(i % n_sets)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(i % n_sets)
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def event_ms(torch, fn, reps=5, iters=5):
    """Median device milliseconds of one ``fn()`` call, timed with CUDA
    events around ``reps`` eager calls (for calls a CUDA graph cannot
    capture, such as an autograd backward)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def host_call_ms(torch, fn, n=50):
    """Median host milliseconds to return from one ``fn()`` call (checks,
    tensor-map encoding and launch; the device is idle at each call)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def launch_ms(torch, fn, n=10):
    """{kernel: device ms a call} of the launches one ``fn()`` call makes
    (a 3xTF32 wrapper: its split kernel, then its product kernel), from
    ``torch.profiler`` over ``n`` eager calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^void |<.*|\(.*", "", e.key).split("::")[-1]
            out[name] = out.get(name, 0.0) + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0)) / 1e3 / n
    return out


def n_copies(bytes_per_set):
    return max(1, math.ceil(2 * L2_BYTES / bytes_per_set))


def bound(nbytes, flops, dtype, route=None):
    """(bound ms, 'bytes' | 'operations'): the larger of the two times. The
    3xTF32 route (``f32_sm90``; K3's, K4's and K5's ``f32`` too, whose
    callers pass ``f32_sm90``) runs three tf32 products for each float32
    one, so its operations count three times at the tf32 rate; other work
    counts at its dtype's peak rate."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    if route == "f32_sm90":
        t_ops = 3 * flops / TF32_FLOPS * 1e3
    else:
        t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


# -- phase 2: kernels against their plain versions ---------------------------

@contextlib.contextmanager
def unsplit_paged():
    """K2 calls on the kernel the split-K one succeeds (csrc/paged_attention.cu:
    one block per batch row and kv head walking the whole history; routes
    ``f32`` and ``bf16``)."""
    from bigdl_tpu_torch.kernels import paged_attention as pa
    rule = pa.route
    pa.route = lambda page_dtype, d: rule(page_dtype, d)[:-len("_split")]
    try:
        yield
    finally:
        pa.route = rule


def flash_case(torch, K, B, H, Tq, Tkv, D, dtype, causal, q_offset, kv_len,
               timed):
    """K1-fwd against flash_fwd_reference; timed: the wrapper's call (on
    the 3xTF32 route the split kernel and the attention kernel), the plain
    version and SDPA."""
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + Tq)
    esz = torch.empty((), dtype=dtype).element_size()
    per_set = esz * (B * H * Tq * D * 2 + 2 * B * H * Tkv * D) + 4 * B * H * Tq
    sets = n_copies(per_set) if timed else 1

    def mk(t):
        return torch.randn(B, H, t, D, device="cuda", generator=g).to(dtype)
    qs = [mk(Tq) for _ in range(sets)]
    ks = [mk(Tkv) for _ in range(sets)]
    vs = [mk(Tkv) for _ in range(sets)]
    o, lse = K.flash_fwd(qs[0], ks[0], vs[0], causal=causal,
                         q_offset=q_offset, kv_len=kv_len)
    ro, rlse = K.flash_fwd_reference(qs[0], ks[0], vs[0], causal, q_offset,
                                     kv_len)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    # rows that see no key (kv_len = 0) give lse = -inf on both sides
    seen = torch.isfinite(rlse)
    lerr = ((lse[seen] - rlse[seen]).abs().max().item() if seen.any()
            else 0.0)
    same_inf = torch.equal(torch.isneginf(lse), ~seen)
    # bf16: o is rounded to bf16 on both sides (one ulp is 2^-8 relative,
    # 0.0078 at |o| in [1, 2)) and p is rounded to bf16 before the PV
    # product on both sides, but at running (kernel) against final (plain)
    # maxima, so the two roundings of one p can differ by an ulp; lse is a
    # float32 sum of unrounded p on both sides
    tol = 2e-5 if dtype == torch.float32 else 1.6e-2
    check(torch.isfinite(o).all().item(), "flash_fwd: non-finite output")
    rec = {"shape": [B, H, Tq, Tkv, D], "dtype": str(dtype),
           "route": K.flash_attention.fwd_route(dtype, D),
           "causal": causal, "q_offset": q_offset, "kv_len": kv_len,
           "max_abs_err": err, "lse_err": lerr, "tol": tol}
    print(f"  K1 flash_fwd {rec}", flush=True)
    check(err <= tol and lerr <= 1e-4 and same_inf,
          f"flash_fwd disagrees with its plain version: {rec}")
    if not timed:
        return rec
    rows = q_offset + np.arange(Tq)
    seen = np.minimum(kv_len, rows + 1) if causal else np.full(Tq, kv_len)
    flops = 4.0 * D * B * H * float(seen.sum())
    nbytes = (esz * (2 * B * H * Tq * D + 2 * B * H * kv_len * D)
              + 4 * B * H * Tq)
    bound_ms, bound_by = bound(nbytes, flops, dtype, rec["route"])
    F = torch.nn.functional
    if q_offset == 0 and kv_len == Tkv:
        lib = lambda i: F.scaled_dot_product_attention(
            qs[i], ks[i], vs[i], is_causal=causal)
    else:
        cols = torch.arange(kv_len, device="cuda")
        mask = cols[None, :] <= (q_offset + torch.arange(
            Tq, device="cuda"))[:, None]
        lib = lambda i: F.scaled_dot_product_attention(
            qs[i], ks[i][:, :, :kv_len], vs[i][:, :, :kv_len],
            attn_mask=mask)
    rec.update(
        ms=graph_ms(torch, lambda i: K.flash_fwd(
            qs[i], ks[i], vs[i], causal=causal, q_offset=q_offset,
            kv_len=kv_len), sets),
        plain_ms=graph_ms(torch, lambda i: K.flash_fwd_reference(
            qs[i], ks[i], vs[i], causal, q_offset, kv_len), sets),
        library_ms=graph_ms(torch, lib, sets),
        host_ms=host_call_ms(torch, lambda: K.flash_fwd(
            qs[0], ks[0], vs[0], causal=causal, q_offset=q_offset,
            kv_len=kv_len)),
        bound_ms=bound_ms, bound_by=bound_by)
    if rec["route"] == "f32_sm90":
        rec["launch_ms"] = launch_ms(torch, lambda: K.flash_fwd(
            qs[0], ks[0], vs[0], causal=causal, q_offset=q_offset,
            kv_len=kv_len))
    print(f"  K1 timing {rec}", flush=True)
    return rec


def bwd_case(torch, K, B, H, T, D, dtype, causal, timed, ring=False):
    """K1-bwd (dK/dV kernel, then dQ kernel) against flash_bwd_reference
    on the residuals of the K1-fwd kernel. ``ring``: with an external
    delta and float32 gradients (``out_dtype``), as a ring backward calls
    it. bf16 inputs: two launches must give bitwise-equal gradients (no
    atomics)."""
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + T + D)
    q, k, v, do = [torch.randn(B, H, T, D, device="cuda",
                               generator=g).to(dtype) for _ in range(4)]
    o, lse = K.flash_fwd(q, k, v, causal=causal)
    kw = {}
    if ring:
        kw = dict(delta=(do.float() * o.float()).sum(-1),
                  out_dtype=torch.float32)
    got = K.flash_bwd(q, k, v, o, lse, do, causal, **kw)
    ref = K.flash_bwd_reference(q, k, v, o, lse, do, causal, **kw)
    again = K.flash_bwd(q, k, v, o, lse, do, causal, **kw)
    torch.cuda.synchronize()
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(got, ref)]
    mag = max(b.float().abs().max().item() for b in ref)
    # both sides round p and ds to the input type before their products
    # (as the JAX kernels do) and sum in float32: float32 differs by
    # summation order (~1e-6 relative over T <= 1024 terms); bf16 by a
    # rounding of p or ds that falls the other way (2^-8 relative on one
    # term) and by the rounding of the gradients (2^-9 relative) - the
    # tolerances leave a factor of 5-100 over that
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * max(1.0, mag)
    check(all(torch.isfinite(x).all().item() for x in got),
          "flash_bwd: non-finite gradient")
    want_dt = torch.float32 if ring else dtype
    check(all(x.dtype == want_dt for x in got),
          f"flash_bwd returned {[x.dtype for x in got]}, expected {want_dt}")
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    rec = {"shape": [B, H, T, D], "dtype": str(dtype),
           "route": K.flash_attention.bwd_route(dtype, D), "causal": causal,
           "external_delta_f32_out": ring, "max_abs_err": max(errs),
           "err_dq_dk_dv": errs, "max_abs_grad": mag, "tol": tol,
           "rerun_bitwise_equal": bitwise}
    print(f"  K1-bwd flash_bwd {rec}", flush=True)
    check(max(errs) <= tol,
          f"flash_bwd disagrees with its plain version: {rec}")
    check(bitwise, f"flash_bwd: two launches differ: {rec}")
    if not timed:
        return rec
    esz = torch.empty((), dtype=dtype).element_size()
    seen = np.arange(1, T + 1) if causal else np.full(T, T)
    # five products of 2 * D operations per (row, visible key) pair: 2.5
    # times the forward's; q, k, v, o, dO, lse and delta read once, dq,
    # dk and dv written once
    flops = 10.0 * D * B * H * float(seen.sum())
    nbytes = esz * 8 * B * H * T * D + 4 * 2 * B * H * T
    bound_ms, bound_by = bound(nbytes, flops, dtype, rec["route"])
    F = torch.nn.functional
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    rec.update(
        ms=graph_ms(torch, lambda i: K.flash_bwd(q, k, v, o, lse, do,
                                                 causal), 1, reps=5, iters=5),
        # the wrapper's delta = rowsum(dO * O) (one torch expression) and the
        # kernel pair alone, given that delta
        delta_ms=graph_ms(torch, lambda i: (do.float() * o.float()).sum(-1),
                          1, reps=5, iters=5),
        kernels_ms=graph_ms(torch, lambda i: K.flash_bwd(
            q, k, v, o, lse, do, causal, delta=delta), 1, reps=5, iters=5),
        plain_ms=graph_ms(torch, lambda i: K.flash_bwd_reference(
            q, k, v, o, lse, do, causal), 1, reps=3, iters=5),
        library_ms=event_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True)),
        bound_ms=bound_ms, bound_by=bound_by)
    if rec["route"] == "f32_sm90":
        rec["launch_ms"] = launch_ms(torch, lambda: K.flash_bwd(
            q, k, v, o, lse, do, causal))
    print(f"  K1-bwd timing {rec}", flush=True)
    return rec


def wide_head_lm(torch, K, B=2, T=256):
    """One float32 forward of a 2-layer TransformerLM at the flagship's
    widths (hidden 1024, filter 4096, vocab 32000) with 8 heads, D = 128:
    the wide 3xTF32 flash forward on a user's path. The card's logits
    against the CPU's on the same weights and tokens (within CPU_TOL of
    the largest |logit|: float32 with TF32 off, sums in other orders), and
    its K1-fwd launches by route, counted from 0 just before the forward:
    exactly one a layer, on ``f32_sm90``, and no other kernel."""
    from bigdl_tpu_torch.models import TransformerLM
    cfg = dict(FLAGSHIP, num_heads=8, num_layers=2)
    cpu = TransformerLM(**cfg, device="cpu", seed=27)
    gpu = TransformerLM(**cfg)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.RandomState(27).randint(
        0, cfg["vocab_size"], (B, T)).astype(np.int64))
    with torch.no_grad():
        want = cpu.call(cpu.params, tokens)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        got = gpu.call(gpu.params, tokens.cuda())
        torch.cuda.synchronize()
        routes = K.launches_by_route()["flash_fwd"]
        counts = K.launch_counts()
    got = got.float().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    rec = {"shape": [B, T], "head_dim": cfg["hidden_size"] // 8,
           "logit_err": err, "largest_logit": scale, "tol": CPU_TOL,
           "routes": {r: n for r, n in routes.items() if n},
           "launches": counts}
    print(f"  K1 wide-head LM forward {rec}", flush=True)
    check(tuple(got.shape) == (B, T, cfg["vocab_size"])
          and torch.isfinite(got).all().item(),
          f"the D = 128 LM forward: logits {tuple(got.shape)} not finite "
          f"or of the wrong shape")
    check(err <= CPU_TOL * scale, f"the D = 128 LM forward's logits "
          f"{err:.3g} from the CPU's (largest |logit| {scale:.3g}, "
          f"tolerance {CPU_TOL} of it)")
    check(rec["routes"] == {"f32_sm90": 2}
          and {n: c for n, c in counts.items() if c} == {"flash_fwd": 2},
          f"the D = 128 LM forward launched {rec['routes']} / {counts}: "
          f"expected flash_fwd twice on f32_sm90 (one a layer)")
    del cpu, gpu
    torch.cuda.empty_cache()
    return rec


def wide_head_step(torch, K, B=2, T=256):
    """One float32 training step of wide_head_lm's model (2 layers at the
    flagship's widths, 8 heads, D = 128): hidden_states in training mode,
    lm_loss_chunked(chunk=128), torch.autograd.grad of every parameter, on
    the card and on the CPU from the same weights and tokens. The loss
    within CPU_TOL of the CPU's; every parameter's gradient within CPU_TOL
    of its largest |gradient| on the CPU (float32 with TF32 off on both
    sides, sums taken in other orders: the CPU's float32 step reads within
    2e-6 of a float64 one at this shape); launches counted from 0 just
    before the step: exactly one flash_fwd and one flash_bwd a layer, on
    ``f32_sm90``, and no other kernel."""
    from bigdl_tpu_torch.convert import flatten
    from bigdl_tpu_torch.models import TransformerLM, lm_loss_chunked
    cfg = dict(FLAGSHIP, num_heads=8, num_layers=2)
    cpu = TransformerLM(**cfg, device="cpu", seed=27)
    gpu = TransformerLM(**cfg)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.RandomState(28).randint(
        0, cfg["vocab_size"], (B, T + 1)).astype(np.int64))
    out = {}
    for m, dev in ((cpu, "cpu"), (gpu, "cuda")):
        x, y = tokens[:, :-1].to(dev), tokens[:, 1:].to(dev)
        leaves = flatten(m.params)
        if dev == "cuda":
            torch.cuda.synchronize()
            K.reset_launch_counts()
        h = m.hidden_states(m.params, x, training=True)
        loss = lm_loss_chunked(h, m.params["embed"], y, chunk=128)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if dev == "cuda":
            torch.cuda.synchronize()
            routes = K.launches_by_route()
            counts = K.launch_counts()
        out[dev] = (loss.item(), {k: g.float().cpu()
                                  for k, g in zip(leaves, grads)})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    errs = {k: float((gg[k] - gc[k]).abs().max())
            / max(float(gc[k].abs().max()), 1e-30) for k in gc}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    rec = {"shape": [B, T], "head_dim": cfg["hidden_size"] // 8,
           "loss": lg, "loss_cpu": lc, "loss_err": abs(lg - lc),
           "grad_err_worst3": worst, "tol": CPU_TOL,
           "routes": {n: {r: c for r, c in routes[n].items() if c}
                      for n in ("flash_fwd", "flash_bwd")},
           "launches": {n: c for n, c in counts.items() if c}}
    print(f"  K1 wide-head LM training step {rec}", flush=True)
    check(math.isfinite(lg) and all(torch.isfinite(g).all().item()
                                    for g in gg.values()),
          f"the D = 128 LM step: loss {lg} or a gradient not finite")
    check(abs(lg - lc) <= CPU_TOL * max(1.0, abs(lc)),
          f"the D = 128 LM step's loss {lg} from the CPU's {lc}")
    check(worst[0][1] <= CPU_TOL, f"the D = 128 LM step's gradients from "
          f"the CPU's (error over the leaf's largest |gradient|, tolerance "
          f"{CPU_TOL}): {worst}")
    check(rec["routes"] == {"flash_fwd": {"f32_sm90": 2},
                            "flash_bwd": {"f32_sm90": 2}}
          and rec["launches"] == {"flash_fwd": 2, "flash_bwd": 2},
          f"the D = 128 LM step launched {rec['routes']} / "
          f"{rec['launches']}: expected flash_fwd and flash_bwd twice each "
          f"on f32_sm90 (one a layer)")
    del cpu, gpu
    torch.cuda.empty_cache()
    return rec


def paged_case(torch, K, B, nH, kvH, S, D, bs, pdtype, timed, max_pos=320):
    """K2 against paged_attention_reference, and a second launch bit for
    bit against the first (no atomics); positions drawn from 32 ..
    max_pos, the last row a padded slot (the null table at position 0)
    when B > 1. timed: the wrapper's call (split kernel, and the combine
    kernel when the table is wider than one split), the plain version, and
    the kernel the split-K one succeeds, at the same inputs."""
    from bigdl_tpu_torch.kernels import paged_attention as pa
    rng = np.random.RandomState(B * 100 + S + kvH)
    nblk = -(-(max_pos + S) // bs)
    NB = 1 + B * nblk
    esz = torch.empty((), dtype=pdtype).element_size()
    per_set = 2 * NB * kvH * bs * D * esz
    sets = n_copies(per_set) if timed else 1
    g = torch.Generator(device="cuda").manual_seed(S * 7 + kvH)
    kps = [torch.randn(NB, kvH, bs, D, device="cuda",
                       generator=g).to(pdtype) for _ in range(sets)]
    vps = [torch.randn(NB, kvH, bs, D, device="cuda",
                       generator=g).to(pdtype) for _ in range(sets)]
    tables = np.zeros((B, nblk), np.int32)
    for b in range(B):
        tables[b] = rng.permutation(np.arange(1, NB))[:nblk]
    pos = rng.randint(32, max_pos, size=B).astype(np.int32)
    if B > 1:               # a padded slot: the null table at position 0
        tables[-1] = 0
        pos[-1] = 0
    tb = torch.from_numpy(tables).cuda()
    ps = torch.from_numpy(pos).cuda()
    q = torch.randn(B, nH, S, D, device="cuda", generator=g).to(pdtype)
    o = K.paged_decode_attention(q, kps[0], vps[0], tb, ps)
    again = K.paged_decode_attention(q, kps[0], vps[0], tb, ps)
    ro = K.paged_attention_reference(q, kps[0], vps[0], tb, ps)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    tol = 2e-5 if pdtype == torch.float32 else 1.6e-2
    check(torch.isfinite(o).all().item(), "paged_attention: non-finite")
    w = K.flash_attention.head_dim_width("paged_attention", "t", D, pa._DIMS)
    splits, span = pa.split_plan(B, kvH, nH // kvH * S, nblk * bs, w,
                                 pa._sm_count(q.device))
    rec = {"shape": [B, nH, kvH, S, D, bs], "dtype": str(pdtype),
           "route": pa.route(pdtype, D), "max_pos": max_pos,
           "splits": splits, "span": span, "max_abs_err": err, "tol": tol,
           "rerun_bitwise_equal": torch.equal(o, again)}
    print(f"  K2 paged_attention {rec}", flush=True)
    check(err <= tol, f"paged_attention disagrees with its plain version: "
          f"{rec}")
    check(rec["rerun_bitwise_equal"], f"paged_attention: two launches "
          f"differ: {rec}")
    if not timed:
        return rec
    G = nH // kvH
    need_blocks = sum(-(-(int(p) + S) // bs) for p in pos)
    nbytes = (2 * need_blocks * kvH * bs * D * esz      # the pages read
              + 2 * B * nH * S * D * esz                # q in, o out
              + 4 * need_blocks + 4 * B)                # table rows, pos
    keys = sum(int(p) + s + 1 for p in pos for s in range(S))
    flops = 4.0 * D * kvH * G * keys
    bound_ms, bound_by = bound(nbytes, flops, pdtype)
    call = lambda i: K.paged_decode_attention(q, kps[i], vps[i], tb, ps)
    rec.update(
        ms=graph_ms(torch, call, sets),
        plain_ms=graph_ms(torch, lambda i: K.paged_attention_reference(
            q, kps[i], vps[i], tb, ps), sets),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        launch_ms=launch_ms(torch, lambda: call(0)))
    with unsplit_paged():
        uo = call(0)
        torch.cuda.synchronize()
        rec["unsplit_err"] = (uo.float() - ro.float()).abs().max().item()
        check(rec["unsplit_err"] <= tol, f"paged_attention.cu (unsplit "
              f"route) disagrees with its plain version: {rec}")
        rec["unsplit_ms"] = graph_ms(torch, call, sets)
    rec["hbm_share"] = bound_ms / rec["ms"]
    print(f"  K2 timing {rec}", flush=True)
    return rec


# -- phase 2, the fused ResNet kernels (K3, K3-nhwc, K5, K4) -----------------

def _rel_err(got, want):
    """Largest |got - want| over max(1, largest |want|)."""
    return ((got.float() - want.float()).abs().max().item()
            / max(1.0, want.float().abs().max().item()))


FUSED_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 1e-2}


def _esz(torch, dtype):
    return torch.empty((), dtype=dtype).element_size()


def _same(torch, got, again):
    """Two launches on the same inputs agree bit for bit (no atomics)."""
    return all((p is None and q is None) or torch.equal(p, q)
               for p, q in zip(got, again))


def _tc_route(rec):
    """The route whose bound a K3 / K5 record takes: both float32 routes
    run 3xTF32."""
    return "f32_sm90" if rec["dtype"] == "torch.float32" else rec["route"]


def extra_peak(torch, fn):
    """Bytes one ``fn()`` call holds on the card at its peak beyond the
    storage of the tensors it returns (its scratch, partials and any copy
    it makes), and those returned bytes."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    kept = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in out if t is not None}
    return peak - sum(kept.values()), sum(kept.values())


def _weight_sized(rt, M, Kd, N, bwd, esz):
    """Bytes of a K3 / K5 call's scratch that is not M-sized activation
    (its weight's scratch, column-sum partials, dw partials, float32
    parameter copies), plus 2 MiB of the allocator's rounding: what a call
    may hold beyond its outputs if it copies or pads no activation."""
    from bigdl_tpu_torch.kernels import fused_matmul as fm
    cols = Kd if bwd else N
    b = 4 * fm.wsplit_elems(rt, Kd, N, not bwd)
    b += 4 * 2 * -(-M // fm._PART_ROWS[rt]) * cols
    if bwd:
        b += 4 * 2 * fm._TC_SPLITS[rt](M, Kd, N)[0] * Kd * N
        b += esz * Kd * N
    return b + 4 * 8 * (Kd + N) + 2 * 2**20


def _mem_check(torch, what, rec, fwd_fn, bwd_fn, M, Kd, N, esz, act):
    """Each call's peak bytes beyond its outputs against its weight-sized
    scratch (``_weight_sized``); ``act``: the smallest M-sized operand's
    bytes, which a copied or padded activation would add."""
    for tag, fn, bwd in (("fwd", fwd_fn, False), ("bwd", bwd_fn, True)):
        extra, kept = extra_peak(torch, fn)
        allowed = _weight_sized(rec["route"], M, Kd, N, bwd, esz)
        rec[f"{tag}_extra_bytes"] = extra
        rec[f"{tag}_allowed_bytes"] = allowed
        check(extra <= allowed < act, f"{what} {tag}: {extra} bytes held "
              f"beyond its {kept} bytes of outputs, over its weight-sized "
              f"scratch {allowed} (an M-sized operand: {act} bytes): {rec}")
    print(f"  {what} peak bytes beyond the outputs: fwd "
          f"{rec['fwd_extra_bytes']} (weight-sized scratch "
          f"{rec['fwd_allowed_bytes']}), bwd {rec['bwd_extra_bytes']} "
          f"({rec['bwd_allowed_bytes']}); smallest M-sized operand {act}",
          flush=True)


def k3_case(torch, K, M, Kd, N, dtype, prologue, relu, stats, timed, bwd=True,
            plain=True, mem=False):
    """K3 forward (and backward) against the plain versions on one set of
    inputs, and a second launch bit for bit against the first; timed:
    kernel, plain version (with ``plain``) and the bare product (cuBLAS
    ``x @ w``; for the backward ``dz @ w.T`` and ``x.T @ dz``), which
    computes the product alone, without the prologue and statistics.
    ``mem``: each call's peak memory beyond its outputs is held to its
    weight-sized scratch (no activation copied or padded)."""
    from bigdl_tpu_torch.kernels.fused_matmul import route
    g = torch.Generator(device="cuda").manual_seed(M + Kd + N)
    x = torch.randn(M, Kd, device="cuda", generator=g).to(dtype)
    w = (0.1 * torch.randn(Kd, N, device="cuda", generator=g)).to(dtype)
    a = b = None
    if prologue:
        a = (torch.rand(Kd, device="cuda", generator=g) + 0.5).to(dtype)
        b = torch.randn(Kd, device="cuda", generator=g).to(dtype)
    got = K.fused_matmul_fwd(x, w, a, b, relu, stats)
    ref = K.fused_matmul_fwd_reference(x, w, a, b, relu, stats)
    errs = [_rel_err(p, q) for p, q in zip(got, ref) if q is not None]
    same = _same(torch, got, K.fused_matmul_fwd(x, w, a, b, relu, stats))
    rec = {"shape": [M, Kd, N], "dtype": str(dtype), "prologue": prologue,
           "relu": relu, "stats": stats, "route": route(dtype, Kd, N),
           "err_z_s1_s2": errs}
    if bwd:
        z = ref[0]
        dz = torch.randn(M, N, device="cuda", generator=g).to(dtype)
        ds1 = torch.randn(N, device="cuda", generator=g) if stats else None
        ds2 = (0.01 * torch.randn(N, device="cuda", generator=g)
               if stats else None)
        gb = K.fused_matmul_bwd(x, w, a, b, z, dz, ds1, ds2, relu, stats)
        rb = K.fused_matmul_bwd_reference(x, w, a, b, z, dz, ds1, ds2, relu,
                                          stats)
        rec["err_dx_dw_da_db"] = [_rel_err(p, q) for p, q in zip(gb, rb)
                                  if q is not None]
        errs = errs + rec["err_dx_dw_da_db"]
        same = same and _same(torch, gb, K.fused_matmul_bwd(
            x, w, a, b, z, dz, ds1, ds2, relu, stats))
    torch.cuda.synchronize()
    tol = FUSED_TOL[str(dtype)]
    rec.update(max_abs_err=max(errs), tol=tol, reruns_equal=same)
    print(f"  K3 fused_matmul {rec}", flush=True)
    check(max(errs) <= tol, f"fused_matmul disagrees with its plain version: "
          f"{rec}")
    check(same, f"fused_matmul: two launches differ: {rec}")
    if mem:
        _mem_check(torch, f"K3 {M}x{Kd}x{N} {dtype}", rec,
                   lambda: K.fused_matmul_fwd(x, w, a, b, relu, stats),
                   lambda: K.fused_matmul_bwd(x, w, a, b, z, dz, ds1, ds2,
                                              relu, stats),
                   M, Kd, N, _esz(torch, dtype),
                   _esz(torch, dtype) * M * min(Kd, N))
    if not timed:
        return rec
    e = _esz(torch, dtype)
    nbytes = e * (M * Kd + Kd * N + M * N) + 4 * (2 * N + (2 * Kd if prologue
                                                           else 0))
    rec["fwd"] = dict(
        ms=graph_ms(torch, lambda i: K.fused_matmul_fwd(x, w, a, b, relu,
                                                        stats), 1, reps=10),
        plain_ms=graph_ms(torch, lambda i: K.fused_matmul_fwd_reference(
            x, w, a, b, relu, stats), 1, reps=5) if plain else None,
        library_ms=graph_ms(torch, lambda i: x @ w, 1, reps=10))
    rec["fwd"]["bound_ms"], rec["fwd"]["bound_by"] = bound(
        nbytes, 2.0 * M * Kd * N, dtype, _tc_route(rec))
    if bwd:
        # reads x, w, a, b, dz, z, ds1, ds2; writes dx, dw, da, db
        nbytes = (e * (2 * M * Kd + 2 * Kd * N + 2 * M * N)
                  + 4 * (2 * N + (4 * Kd if prologue else 0)))
        rec["bwd"] = dict(
            ms=graph_ms(torch, lambda i: K.fused_matmul_bwd(
                x, w, a, b, z, dz, ds1, ds2, relu, stats), 1, reps=5,
                iters=5),
            plain_ms=graph_ms(torch, lambda i: K.fused_matmul_bwd_reference(
                x, w, a, b, z, dz, ds1, ds2, relu, stats), 1, reps=3,
                iters=5) if plain else None,
            library_ms=graph_ms(torch, lambda i: (dz @ w.T, x.T @ dz), 1,
                                reps=5, iters=5))
        rec["bwd"]["bound_ms"], rec["bwd"]["bound_by"] = bound(
            nbytes, 4.0 * M * Kd * N, dtype, _tc_route(rec))
    print(f"  K3 timing {rec}", flush=True)
    return rec


def _k5_nan_h(torch, K, z, r, a, b, w, h_ref):
    """The K5 forward's C entry on its route, with an h pre-filled with NaN:
    True when every element of h came back as the plain version's."""
    import ctypes
    from bigdl_tpu_torch.kernels import _build, fused_chain as fc
    from bigdl_tpu_torch.kernels.fused_matmul import _PART_ROWS, _wsplit, route
    M, Kd = z.shape
    N = w.shape[1]
    rt = route(z.dtype, Kd, N)
    h = torch.full_like(z, float("nan"))
    zo = torch.empty((M, N), dtype=z.dtype, device="cuda")
    part = torch.empty((2, -(-M // _PART_ROWS[rt]), N), device="cuda")
    st = torch.empty((2, N), device="cuda")
    af, bf = a.float().contiguous(), b.float().contiguous()
    wsp, extra = _wsplit(rt, Kd, N, z.device)
    fn = _build.function(*fc._FWD_FN[rt], fc._FWD_ARGTYPES
                         + [ctypes.c_void_p] * len(extra))
    err = fn(z.data_ptr(), r.data_ptr(), af.data_ptr(), bf.data_ptr(),
             w.data_ptr(), h.data_ptr(), zo.data_ptr(), part.data_ptr(),
             part[1].data_ptr(), st.data_ptr(), st[1].data_ptr(),
             fc._DTYPES[z.dtype], M, Kd, N, 1,
             torch.cuda.current_stream().cuda_stream, *extra)
    check(err == 0, f"fused_chain forward C entry: CUDA error {err}")
    torch.cuda.synchronize()
    return bool(torch.equal(h, h_ref))


def k5_case(torch, K, B, H, Kd, N, dtype, timed, plain=True, stats=True,
            tie=False, nan_h=False, mem=False):
    """K5 forward and backward against the plain versions, and a second
    launch bit for bit against the first; timed like K3, the bare product
    being ``h @ w`` (and ``dzo @ w.T``, ``h.T @ dzo``). ``tie``: z = r = 0
    and b = 0 on every other channel, so u = z a + b + r is exactly 0 there
    (the ReLU's tie, whose gradient is 0 on both sides). ``nan_h``: the
    forward's C entry is also called on an h pre-filled with NaN, which
    must come back equal to the plain version's h everywhere (written in
    full by the kernel). ``mem``: as K3's."""
    from bigdl_tpu_torch.kernels.fused_matmul import route
    g = torch.Generator(device="cuda").manual_seed(B + H + Kd + N)
    M = B * H * H
    z = torch.randn(M, Kd, device="cuda", generator=g).to(dtype)
    r = torch.randn(M, Kd, device="cuda", generator=g).to(dtype)
    w = (0.1 * torch.randn(Kd, N, device="cuda", generator=g)).to(dtype)
    a = (torch.rand(Kd, device="cuda", generator=g) + 0.5).to(dtype)
    b = torch.randn(Kd, device="cuda", generator=g).to(dtype)
    if tie:
        z[:, ::2] = 0
        r[:, ::2] = 0
        b[::2] = 0
    got = K.fused_chain_fwd(z, r, a, b, w, stats)
    ref = K.residual_chain_reference(z, r, a, b, w, stats)
    same = _same(torch, got, K.fused_chain_fwd(z, r, a, b, w, stats))
    h, zo = ref[0], ref[1]
    dh = torch.randn(M, Kd, device="cuda", generator=g).to(dtype)
    dzo = torch.randn(M, N, device="cuda", generator=g).to(dtype)
    ds1 = torch.randn(N, device="cuda", generator=g) if stats else None
    ds2 = 0.01 * torch.randn(N, device="cuda", generator=g) if stats else None
    gb = K.fused_chain_bwd(z, r, a, b, w, zo, dh, dzo, ds1, ds2, stats)
    rb = K.residual_chain_bwd_reference(z, r, a, b, w, zo, dh, dzo, ds1, ds2,
                                        stats)
    same = same and _same(torch, gb, K.fused_chain_bwd(
        z, r, a, b, w, zo, dh, dzo, ds1, ds2, stats))
    torch.cuda.synchronize()
    errs = [_rel_err(p, q) for p, q in zip(got + gb, ref + rb)
            if q is not None]
    tol = FUSED_TOL[str(dtype)]
    rec = {"shape": [B, H, H, Kd, N], "M": M, "dtype": str(dtype),
           "stats": stats, "tie": tie, "route": route(dtype, Kd, N),
           "err_h_zo_s1_s2_dz_dr_da_db_dw": errs, "max_abs_err": max(errs),
           "tol": tol, "reruns_equal": same}
    if nan_h:
        rec["nan_h_equal"] = _k5_nan_h(torch, K, z, r, a, b, w, h)
    print(f"  K5 fused_chain {rec}", flush=True)
    check(max(errs) <= tol, f"fused_chain disagrees with its plain version: "
          f"{rec}")
    check(same, f"fused_chain: two launches differ: {rec}")
    check(rec.get("nan_h_equal", True), f"fused_chain: h not written in full "
          f"(NaN left in a pre-filled h): {rec}")
    if mem:
        _mem_check(torch, f"K5 {M}x{Kd}x{N} {dtype}", rec,
                   lambda: K.fused_chain_fwd(z, r, a, b, w, stats),
                   lambda: K.fused_chain_bwd(z, r, a, b, w, zo, dh, dzo, ds1,
                                             ds2, stats),
                   M, Kd, N, _esz(torch, dtype),
                   _esz(torch, dtype) * M * min(Kd, N))
    if not timed:
        return rec
    e = _esz(torch, dtype)
    rec["fwd"] = dict(
        ms=graph_ms(torch, lambda i: K.fused_chain_fwd(z, r, a, b, w, True),
                    1, reps=10),
        plain_ms=graph_ms(torch, lambda i: K.residual_chain_reference(
            z, r, a, b, w, True), 1, reps=5) if plain else None,
        library_ms=graph_ms(torch, lambda i: h @ w, 1, reps=10))
    # reads z, r, w, a, b; writes h, zo, s1, s2
    rec["fwd"]["bound_ms"], rec["fwd"]["bound_by"] = bound(
        e * (3 * M * Kd + Kd * N + M * N) + 4 * (2 * Kd + 2 * N),
        2.0 * M * Kd * N, dtype, _tc_route(rec))
    rec["bwd"] = dict(
        ms=graph_ms(torch, lambda i: K.fused_chain_bwd(
            z, r, a, b, w, zo, dh, dzo, ds1, ds2, True), 1, reps=5, iters=5),
        plain_ms=graph_ms(torch, lambda i: K.residual_chain_bwd_reference(
            z, r, a, b, w, zo, dh, dzo, ds1, ds2, True), 1, reps=3, iters=5)
        if plain else None,
        library_ms=graph_ms(torch, lambda i: (dzo @ w.T, h.T @ dzo), 1,
                            reps=5, iters=5))
    # reads z, r, w, a, b, dh, dzo, zo, ds1, ds2; writes dz, dr, da, db, dw
    rec["bwd"]["bound_ms"], rec["bwd"]["bound_by"] = bound(
        e * (5 * M * Kd + 2 * Kd * N + 2 * M * N) + 4 * (4 * Kd + 2 * N),
        4.0 * M * Kd * N, dtype, _tc_route(rec))
    print(f"  K5 timing {rec}", flush=True)
    return rec


def k4_case(torch, K, B, H, C, N, stride, dtype, timed, bias=None,
            plain=True):
    """K4 forward against its plain version, and a second launch bit for
    bit against the first; ``bias`` (a constant b) instead of random
    ones: with b > 0 every tap in the zero padding would give relu(b) != 0
    if the kernel applied the prologue after the padding. Timed like K3,
    the library call being cuDNN's bare conv (``F.conv2d`` on the
    channels-last view, without the prologue and statistics)."""
    from bigdl_tpu_torch.kernels.fused_conv import route
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(B + H + C + stride)
    x = torch.randn(B, H, H, C, device="cuda", generator=g).to(dtype)
    w = (0.1 * torch.randn(3, 3, C, N, device="cuda", generator=g)).to(dtype)
    a = (torch.rand(C, device="cuda", generator=g) + 0.5).to(dtype)
    b = (torch.randn(C, device="cuda", generator=g) if bias is None
         else torch.full((C,), float(bias), device="cuda")).to(dtype)
    got = K.fused_conv_fwd(x, w, a, b, stride, True)
    ref = K.conv3x3_reference(x, w, a, b, stride, True)
    same = _same(torch, got, K.fused_conv_fwd(x, w, a, b, stride, True))
    torch.cuda.synchronize()
    errs = [_rel_err(p, q) for p, q in zip(got, ref)]
    tol = FUSED_TOL[str(dtype)]
    rec = {"shape": [B, H, H, C, N], "stride": stride, "dtype": str(dtype),
           "bias": bias, "route": route(dtype, C, N), "err_z_s1_s2": errs,
           "max_abs_err": max(errs), "tol": tol, "reruns_equal": same}
    print(f"  K4 fused_conv {rec}", flush=True)
    check(max(errs) <= tol, f"fused_conv disagrees with its plain version: "
          f"{rec}")
    check(same, f"fused_conv: two launches differ: {rec}")
    if not timed:
        return rec
    H2 = -(-H // stride)
    e = _esz(torch, dtype)
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    rec.update(
        ms=graph_ms(torch, lambda i: K.fused_conv_fwd(x, w, a, b, stride,
                                                      True), 1, reps=5),
        plain_ms=graph_ms(torch, lambda i: K.conv3x3_reference(
            x, w, a, b, stride, True), 1, reps=3) if plain else None,
        library_ms=graph_ms(torch, lambda i: F.conv2d(
            xc, wc, stride=stride, padding=1), 1, reps=10))
    # both float32 routes run 3xTF32 (the bound counts C, not the padded
    # taps: the function's own work)
    rec["bound_ms"], rec["bound_by"] = bound(
        e * (B * H * H * C + 9 * C * N + B * H2 * H2 * N) + 4 * (2 * C + 2 * N),
        2.0 * B * H2 * H2 * 9 * C * N, dtype,
        "f32_sm90" if rec["route"] == "f32" else rec["route"])
    if rec["route"] != "bf16_sm90":
        rec["launch_ms"] = launch_ms(torch, lambda: K.fused_conv_fwd(
            x, w, a, b, stride, True))
    print(f"  K4 timing {rec}", flush=True)
    return rec


# ResNet-50 at B256/224 (models/resnet.py): the fused calls of one training
# step, (name, shape, launches a step). K3: (M, K, N, prologue BN2 + ReLU);
# K4: (H, C, N, stride); K5: (H, K, N).
RB = 256
RESNET_K3 = [("s0 conv1", (RB * 56 * 56, 64, 64, False), 1),
             ("s1 conv1", (RB * 56 * 56, 256, 128, False), 1),
             ("s2 conv1", (RB * 28 * 28, 512, 256, False), 1),
             ("s3 conv1", (RB * 14 * 14, 1024, 512, False), 1),
             ("s0 conv3", (RB * 56 * 56, 64, 256, True), 3),
             ("s1 conv3", (RB * 28 * 28, 128, 512, True), 4),
             ("s2 conv3", (RB * 14 * 14, 256, 1024, True), 6),
             ("s3 conv3", (RB * 7 * 7, 512, 2048, True), 3),
             ("s0 proj", (RB * 56 * 56, 64, 256, False), 1),
             ("s1 proj", (RB * 28 * 28, 256, 512, False), 1),
             ("s2 proj", (RB * 14 * 14, 512, 1024, False), 1),
             ("s3 proj", (RB * 7 * 7, 1024, 2048, False), 1)]
RESNET_K4 = [("s0 3x3", (56, 64, 64, 1), 3),
             ("s1 3x3/2", (56, 128, 128, 2), 1),
             ("s2 3x3/2", (28, 256, 256, 2), 1),
             ("s3 3x3/2", (14, 512, 512, 2), 1),
             ("s1 3x3", (28, 128, 128, 1), 3),
             ("s2 3x3", (14, 256, 256, 1), 5),
             ("s3 3x3", (7, 512, 512, 1), 2)]
RESNET_K5 = [("s0 junction", (56, 256, 64), 2),
             ("s1 junction", (28, 512, 128), 3),
             ("s2 junction", (14, 1024, 256), 5),
             ("s3 junction", (7, 2048, 512), 2)]
# the shapes whose plain versions are timed too (the kernels line's rows)
JSON_SHAPES = ("s0 conv3", "s3 proj", "s0 3x3", "s1 3x3/2", "s0 junction")
# ms a call the 3xTF32 route must keep to at phase 8's stage-0 shapes (B32):
# about the bf16 routes' distance from their bounds
F32_LIMITS = {"K3 fwd": 0.12, "K3 bwd": 0.40, "K5 fwd": 0.20, "K5 bwd": 0.60}


def resnet_shapes(torch, K):
    """Every distinct ResNet-50 B256/224 shape of K3 (forward and backward)
    and K4 held against the plain versions (bf16, two launches bit for
    bit) and timed with the library call and the bound, and K5 (forward
    and backward) likewise. Returns ({family: [(name, launches a step,
    timing)]}, {name: case record})."""
    bf = torch.bfloat16
    fam = {"K3 fwd": [], "K3 bwd": [], "K4": [], "K5 fwd": [], "K5 bwd": []}
    recs = {}
    for name, (M, Kd, N, pro), n in RESNET_K3:
        r = recs[name] = k3_case(torch, K, M, Kd, N, bf, pro, pro, True, True,
                                 plain=name in JSON_SHAPES)
        fam["K3 fwd"].append((name, n, r["fwd"]))
        fam["K3 bwd"].append((name, n, r["bwd"]))
    for name, (H, C, N, st), n in RESNET_K4:
        r = recs[name] = k4_case(torch, K, RB, H, C, N, st, bf, True,
                                 plain=name in JSON_SHAPES)
        fam["K4"].append((name, n, r))
    for name, (H, Kd, N), n in RESNET_K5:
        r = recs[name] = k5_case(torch, K, RB, H, Kd, N, bf, True,
                                 plain=name in JSON_SHAPES, nan_h=True)
        fam["K5 fwd"].append((name, n, r["fwd"]))
        fam["K5 bwd"].append((name, n, r["bwd"]))
    _print_families(fam)
    return fam, recs


# phase 8's batch: Optimizer.create at B32/224 on float32 parameters
FB = 32
# the bottleneck chain of phase 2's ragged step: two FusedBottleneck blocks
# at width w (nin 2 w -> w -> 4 w, then 4 w -> w -> 4 w), w = 50 (conv1
# ragged in N, conv3 in K, the junction's next conv1 in N) against w = 48
# (all aligned), at (batch, image side) per dtype
CHAIN_RAGGED, CHAIN_ALIGNED = 50, 48
CHAIN_SHAPE = {"torch.float32": (32, 56), "torch.bfloat16": (64, 56)}
# the batch (x 56 x 56 rows) of phase 2's truly ragged K3 / K5 shapes per
# dtype: phase 8's in float32, the B256 training step's in bf16
RAGGED_BATCH = {"torch.float32": FB, "torch.bfloat16": RB}


@contextlib.contextmanager
def ragged_route(torch):
    """K3, K4 and K5 calls on their dtype's ragged route (``f32``,
    ``bf16_ragged``), the route of shapes outside the aligned rules, at any
    shape: K3, K5 and K4 on csrc/fused_matmul.cu, csrc/fused_chain.cu and
    csrc/fused_conv.cu (3xTF32 or bf16 wgmma with the ragged load / store
    policy; K4 with its ragged 3x3 gather)."""
    from bigdl_tpu_torch.kernels import (fused_chain as fc, fused_conv as fcv,
                                         fused_matmul as fm)
    rule, conv_rule = fm.route, fcv.route
    fm.route = fc.route = lambda dtype, k, n: (
        "f32" if dtype == torch.float32 else "bf16_ragged")
    fcv.route = lambda dtype, c, n: (
        "f32" if dtype == torch.float32 else "bf16_ragged")
    try:
        yield
    finally:
        fm.route = fc.route = rule
        fcv.route = conv_rule


def resnet_shapes_f32(torch, K):
    """Every distinct ResNet-50 B32/224 shape of K3 and K5 (forward and
    backward) in float32, the calls of phase 8, and of K4 (phase 7's
    float32 step runs it), held against the plain versions (two launches
    bit for bit; K5's h also into a NaN-filled buffer) and timed with the
    library call and the bound, on the 3xTF32 route and then forced onto
    the ragged route (``ragged_route``: K3 / K5 / K4 on 3xTF32 with the
    ragged policy, K4 with its ragged 3x3 gather); the plain versions are
    timed at stage 0.
    Returns ({family: [(name, launches a step, timing)]} of each route,
    {name: case record} of each route)."""
    f32 = torch.float32
    fams, recs_by_route = [], []
    for cc in (False, True):
        fam = {"K3 fwd": [], "K3 bwd": [], "K5 fwd": [], "K5 bwd": [],
               "K4": []}
        recs = {}
        with (ragged_route(torch) if cc else contextlib.nullcontext()):
            for name, (M, Kd, N, pro), n in RESNET_K3:
                r = recs[name] = k3_case(
                    torch, K, M // RB * FB, Kd, N, f32, pro, pro, True, True,
                    plain=name == "s0 conv3" and not cc)
                fam["K3 fwd"].append((name, n, r["fwd"]))
                fam["K3 bwd"].append((name, n, r["bwd"]))
            for name, (H, Kd, N), n in RESNET_K5:
                r = recs[name] = k5_case(
                    torch, K, FB, H, Kd, N, f32, True,
                    plain=name == "s0 junction" and not cc, nan_h=True)
                fam["K5 fwd"].append((name, n, r["fwd"]))
                fam["K5 bwd"].append((name, n, r["bwd"]))
            for name, (H, C, N, st), n in RESNET_K4:
                r = recs[name] = k4_case(torch, K, FB, H, C, N, st, f32, True,
                                         plain=name == "s0 3x3" and not cc)
                fam["K4"].append((name, n, r))
        want = "f32" if cc else "f32_sm90"
        check(all(r["route"] == want for r in recs.values()),
              f"float32 ResNet-50 shapes off the {want} route: "
              f"{ {k: r['route'] for k, r in recs.items()} }")
        fams.append(fam)
        recs_by_route.append(recs)
    for f, rows in fams[0].items():
        for (name, n, r), (_, _, o) in zip(rows, fams[1][f]):
            print(f"  float32 B{FB} {f} {name}: {n} a step x {r['ms']:.4f} "
                  f"ms 3xTF32, {o['ms']:.4f} ms on the ragged route "
                  f"(3xTF32, the ragged policy; library "
                  f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                  f"{r['bound_by']}; the ragged route's bound "
                  f"{o['bound_ms']:.4f})", flush=True)
    return fams, recs_by_route


def _chain(torch, width, dev, seed=0):
    """A FusedBottleneckChain of two FusedBottleneck blocks at ``width``
    (nin 2 w -> w -> 4 w, then 4 w -> w -> 4 w; the 3x3 convs through K4,
    ``fused_conv2``), its weights drawn from ``seed`` on the CPU, on
    ``dev``."""
    from bigdl_tpu_torch.models import FusedBottleneck, FusedBottleneckChain
    torch.manual_seed(seed)
    m = FusedBottleneckChain([
        FusedBottleneck(2 * width, width, 1, 4, False, fused_conv2=True),
        FusedBottleneck(4 * width, width, 1, 4, False, fused_conv2=True)])
    return m.to(dev)


def _chain_step(torch, m, x, bf16):
    """One training step of a chain: the forward in training mode (bf16:
    ``bf16_params`` of the float32 masters, as the bf16 recipe) and the
    gradients of sum(sin(out / 2)) by autograd. Returns (out, new state,
    {leaf: gradient})."""
    from bigdl_tpu_torch.convert import flatten
    from bigdl_tpu_torch.utils.amp import bf16_params
    params = m.params
    out, ns = m.apply(bf16_params(params) if bf16 else params, m.state, x,
                      training=True)
    loss = torch.sin(out.float() * 0.5).sum()
    leaves = flatten(params)
    return out, ns, dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


def chain_ms(torch, step, n=2):
    """A training step's device ms (the kernels' summed device time a step,
    ``torch.profiler`` over ``n`` steps; the eager step is host-paced), the
    fused K3 / K5 / K4 kernels' share of it (the cores' rs / dw / weight
    preparation / sum kernels), and the eager wall ms a step (CUDA
    events)."""
    per = launch_ms(torch, step, n)
    fused = ("rs_kernel", "dw_kernel", "split_w_kernel", "pad_cols_kernel",
             "split_taps_kernel", "pad_taps_kernel", "sum_rows_kernel",
             "gemm_rs_kernel")
    return {"ms": sum(per.values()),
            "fused_ms": sum(v for k, v in per.items() if k in fused),
            "wall_ms": event_ms(torch, step, reps=2, iters=3)}


def _chain_errs(got, want):
    (o, s, g), (ow, sw, gw) = got, want
    return {"out": _rel_err(o, ow),
            "state": max(_rel_err(s[k], sw[k]) for k in sw),
            "grads": max(_rel_err(g[k], gw[k]) for k in gw)}


def ragged_chain(torch, K):
    """The ragged routes on the path a user reaches them by: a
    FusedBottleneckChain at width 50 (CHAIN_RAGGED: conv1 ragged in N,
    conv3 in K, the junction's next conv1 in N; bf16 also the projection,
    K = 100; the 3x3 convs through K4 at C = N = 50, on the ragged route in
    both dtypes) beside the same chain at width 48 (K3 / K5 aligned; K4 at
    C = 48 on the float32 ragged route, 48 not being a multiple of 32, and
    on bf16_sm90), in float32 and bf16 (the bf16 recipe). Per dtype: the
    width-50 chain's training
    step on a B2/28 batch on the card against the CPU on the same weights
    and inputs (float32: card against CPU; bf16: each against the CPU's
    float32 step, the card at most twice the CPU's distance plus 1e-3);
    then per width the step at CHAIN_SHAPE: its K3 / K5 / K4 launches by
    route (counts set to 0 just before the first step, read just after:
    every call on the route its (K, N) or (C, N) gives; K4's backward is
    plain ops), its device ms (``chain_ms``) and
    its peak memory beyond the model and batch. The width-50 step's peak
    must stay within half a width-50 activation of the width-48 step's
    scaled by 50 / 48: no activation is copied or padded. TF32 off (the 3x3
    convs' backward runs on cuDNN, as K4's backward is plain ops). Returns
    {dtype: {width: record}}."""
    from collections import Counter
    from bigdl_tpu_torch.convert import flatten
    from bigdl_tpu_torch.kernels.fused_conv import route as conv_route
    from bigdl_tpu_torch.kernels.fused_matmul import route
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        bf16 = dt == torch.bfloat16
        B, S = CHAIN_SHAPE[str(dt)]
        recs = out[str(dt)] = {}
        w = CHAIN_RAGGED
        xs = np.random.RandomState(w).randn(2, 28, 28, 2 * w).astype(
            np.float32)
        runs = {}
        for where, rdt in (("cuda", dt), ("cpu", dt)) + (
                (("truth", torch.float32),) if bf16 else ()):
            dev = "cpu" if where == "truth" else where
            o, ns, g = _chain_step(torch, _chain(torch, w, dev),
                                   torch.from_numpy(xs).to(dev, rdt),
                                   rdt == torch.bfloat16)
            runs[where] = (o.detach().float().cpu(),
                           {k: v.float().cpu()
                            for k, v in flatten(ns).items()},
                           {k: v.float().cpu() for k, v in g.items()})
        rec = recs[w] = {"width": w, "dtype": str(dt)}
        if bf16:
            rec["card_vs_f32"] = _chain_errs(runs["cuda"], runs["truth"])
            rec["cpu_vs_f32"] = _chain_errs(runs["cpu"], runs["truth"])
            ok = all(rec["card_vs_f32"][k] <= 2 * rec["cpu_vs_f32"][k]
                     + 1e-3 for k in rec["card_vs_f32"])
        else:
            # float32 everywhere, sums in other orders; the gradients pass
            # back through the one-pass BatchNorm variances of the B2 batch
            # (1568 pixels), which amplify the rounding
            rec["card_vs_cpu"] = _chain_errs(runs["cuda"], runs["cpu"])
            e = rec["card_vs_cpu"]
            ok = e["out"] <= 1e-4 and e["state"] <= 1e-4 and \
                e["grads"] <= 1e-3
        check(ok, f"the width-{w} chain's step on the card disagrees with "
              f"the CPU: {rec}")
        for w in (CHAIN_RAGGED, CHAIN_ALIGNED):
            rec = recs.setdefault(w, {"width": w, "dtype": str(dt)})
            m = _chain(torch, w, "cuda")
            x = torch.from_numpy(np.random.RandomState(w).randn(
                B, S, S, 2 * w).astype(np.float32)).to("cuda", dt)
            step = lambda: _chain_step(torch, m, x, bf16)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            step()
            torch.cuda.synchronize()
            routes = K.launches_by_route()
            k3 = Counter(route(dt, k, n) for k, n in (
                (2 * w, w), (w, 4 * w), (2 * w, 4 * w), (w, 4 * w)))
            k5 = Counter([route(dt, 4 * w, w)])
            k4 = Counter([conv_route(dt, w, w)] * 2)   # one a block
            want = {"fused_matmul_fwd": k3, "fused_matmul_bwd": k3,
                    "fused_chain_fwd": k5, "fused_chain_bwd": k5,
                    "fused_conv_fwd": k4}
            rec["routes"] = {n: {r: c for r, c in routes[n].items() if c}
                             for n in want}
            check(all(rec["routes"][n] == dict(c) for n, c in want.items()),
                  f"the width-{w} chain's step ({dt}) launched "
                  f"{rec['routes']}, expected {want}")
            rec.update(chain_ms(torch, step))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            rec["peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
            del m, x
        r, a = recs[CHAIN_RAGGED], recs[CHAIN_ALIGNED]
        scaled = a["peak_extra_bytes"] * CHAIN_RAGGED / CHAIN_ALIGNED
        act = B * S * S * CHAIN_RAGGED * _esz(torch, dt)
        r["excess_over_aligned_bytes"] = r["peak_extra_bytes"] - scaled
        print(f"  width-{CHAIN_RAGGED} chain step ({dt}, B{B}/{S}): "
              f"{r['ms']:.4f} device ms against {a['ms']:.4f} at width "
              f"{CHAIN_ALIGNED} (ratio {r['ms'] / a['ms']:.3f}, widths "
              f"{CHAIN_RAGGED / CHAIN_ALIGNED:.3f}; K3 / K5 / K4 kernels "
              f"{r['fused_ms']:.4f} against {a['fused_ms']:.4f}; eager wall "
              f"{r['wall_ms']:.4f} against {a['wall_ms']:.4f}); launches "
              f"{r['routes']} "
              f"against {a['routes']}; card against CPU "
              f"{r.get('card_vs_cpu', r.get('card_vs_f32'))} (CPU bf16 "
              f"{r.get('cpu_vs_f32')}); peak memory beyond model and batch "
              f"{r['peak_extra_bytes']} bytes against {a['peak_extra_bytes']}"
              f" at width {CHAIN_ALIGNED} ({scaled:.0f} scaled by the widths:"
              f" {r['excess_over_aligned_bytes']:.0f} over it; half a "
              f"width-{CHAIN_RAGGED} activation {act // 2})", flush=True)
        check(r["excess_over_aligned_bytes"] < act // 2,
              f"the width-{CHAIN_RAGGED} chain step ({dt}) holds "
              f"{r['excess_over_aligned_bytes']:.0f} bytes more than the "
              f"aligned step scaled: an activation copied or padded?")
    return out


def _print_families(fam):
    for f, rows in fam.items():
        for name, n, r in rows:
            print(f"  {f} {name}: {n} a step x {r['ms']:.4f} ms (library "
                  f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                  f"{r['bound_by']})", flush=True)


# -- phase 4 helper ------------------------------------------------------------

def solo_greedy(torch, model, params, prompt, n):
    """Dense solo greedy decode of one prompt: (tokens, top-2 margins)."""
    logits, caches = model.prefill(params, prompt[None], model.max_len)
    toks, margins = [], []
    pos = prompt.size
    for i in range(n):
        top = logits[0].float().topk(2).values
        margins.append(float(top[0] - top[1]))
        toks.append(int(logits[0].argmax()))
        if i < n - 1:
            logits, caches = model.decode_one(params, [toks[-1]], pos,
                                              caches)
            pos += 1
    return toks, margins


# -- phases 5 and 6: training ---------------------------------------------------

def _lm_model_flops(B, T, H, F, L, V, causal=True):
    """Analytic model FLOPs of one LM training step (forward and twice it
    backward), bench_extra.py ``_lm_model_flops``: per layer the four
    projections, the two T^2 attention products (halved when causal), the
    two FFN products; plus the tied vocab projection."""
    per_layer = (4 * 2 * B * T * H * H
                 + (2 * 2 * B * T * T * H) * (0.5 if causal else 1.0)
                 + 2 * 2 * B * T * H * F)
    return 3.0 * (L * per_layer + 2 * B * T * H * V)


def _lm_counted_flops(B, T, H, F, L, V):
    """The matrix-product FLOPs the cost notes count for the bf16 recipe
    step (remat off): the projections and FFN forward and twice it
    backward, each layer's attention whole (the plain versions' products:
    4 B T^2 H forward, 10 backward, tallied by the flash wrappers on the
    card), and the vocab projection forward, again in the chunked loss's
    backward, and twice backward."""
    per_layer = 3 * (8 * B * T * H * H + 4 * B * T * H * F) \
        + 14 * B * T * T * H
    return L * per_layer + 8 * B * T * H * V


def train_recipe(torch, K, model, init, x, y, remat, steps=5, cost=False):
    """The bf16 LM training recipe (bench_extra.py bench_transformer_lm):
    float32 masters, cast to bf16 inside the loss, hidden_states in
    training mode, lm_loss_chunked(chunk=128), gradients to the masters,
    SGD(0.01, momentum=0.9) in place. 1 warmup step, then ``steps`` on the
    same batch; launch counts are read per step. With ``cost`` the step
    runs through the program cost notes (``observability.perf``, with
    observability on): the warmup step is the counted one and every later
    step publishes the live MFU (``note_step``)."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.convert import flatten, unflatten
    from bigdl_tpu_torch.models import lm_loss_chunked
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.amp import bf16_params
    model.load_state_dict(init)
    model.remat = remat
    params = model.params
    leaves = flatten(params)
    optim = SGD(learningrate=0.01, momentum=0.9)
    opt_state = optim.init_state(params)

    def step(x, y):
        p16 = bf16_params(params)
        h = model.hidden_states(p16, x, training=True)
        loss = lm_loss_chunked(h, p16["embed"], y, chunk=128)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        optim.update(unflatten(dict(zip(leaves, grads))), params, opt_state,
                     0.01)
        return loss, grads

    L = len(model.blocks)
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(flash_fwd=2 * L if remat else L, flash_bwd=L)
    run = step
    if cost:
        obs.enable()
        obs.perf.reset()
        run = obs.perf.instrument_jit(step, name="optim/step",
                                      kind="train_step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, total = [], [], {n: 0 for n in want}
    mfus = []
    for i in range(steps + 1):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = run(x, y)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if cost and not run.last_call_compiled:
            obs.perf.note_step(run.last_artifact, wall_s=dt)
            mfus.append(obs.registry().gauge("perf/mfu").value)
        counts = K.launch_counts()
        check(counts == want, f"training step (remat={remat}) launched "
              f"{counts}, expected {want}")
        routes = K.launches_by_route()
        check(all(only_on(routes[n], "bf16_sm90", want[n])
                  for n in ("flash_fwd", "flash_bwd")),
              f"training step (remat={remat}): flash launches by route "
              f"{routes}, all expected on bf16_sm90")
        check(torch.stack([torch.isfinite(g).all() for g in grads])
              .all().item(), f"non-finite gradient (remat={remat})")
        losses.append(loss.item())
        if i > 0:                      # step 0 is the warmup
            times.append(dt)
            for n in total:
                total[n] += counts[n]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss "
          f"{losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    # the seed-0 model's loss on the seed-0 batch before any update, as the
    # CUDA-core kernels gave it (10.5815 with p kept in float32)
    check(abs(losses[0] - 10.5815) <= 1e-3, f"first loss {losses[0]} is "
          f"not within 1e-3 of 10.5815")
    out = {"remat": remat, "losses": losses,
           "step_s": statistics.median(times), "step_s_all": times,
           "max_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": total}
    if cost:
        art = run.last_artifact
        obs.disable()
        out["cost"] = {"artifact": art.to_dict(), "mfu": mfus,
                       "mfu_mean": obs.registry().gauge(
                           "perf/mfu_mean").value}
    return out


def local_optimizer_run(torch, K, model, init, V, B=8, T=256, iters=4):
    """The normal entry point: LocalOptimizer over a DataSet of samples,
    LMCriterion, SGD(0.01, momentum=0.9), float32 parameters."""
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.nn import LMCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim import max_iteration
    model.load_state_dict(init)
    model.remat = False
    rng = np.random.RandomState(2)
    ids = rng.randint(1, V, (B * iters, T + 1)).astype(np.int32)
    samples = [Sample(r[:-1], r[1:]) for r in ids]
    losses = []
    stop = max_iteration(iters)
    end = Trigger(lambda st: losses.append(st["loss"]) or stop(st))
    opt = LocalOptimizer(model, DataSet.array(samples), LMCriterion(),
                         SGD(learningrate=0.01, momentum=0.9), end,
                         batch_size=B)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    L = len(model.blocks)
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(flash_fwd=L * iters, flash_bwd=L * iters)
    check(counts == want, f"LocalOptimizer launched {counts}, expected "
          f"{want}")
    routes = K.launches_by_route()
    check(only_on(routes["flash_fwd"], "f32_sm90", want["flash_fwd"])
          and only_on(routes["flash_bwd"], "f32_sm90", want["flash_bwd"]),
          f"LocalOptimizer (float32 params): flash launches by route "
          f"{routes}, expected the forward and the backward all on "
          f"f32_sm90")
    check(len(losses) == iters and all(math.isfinite(v) for v in losses),
          f"LocalOptimizer losses {losses}")
    return {"losses": losses, "wall_s": dt,
            "step_s": opt.metrics.values["step_time"], "launches": counts,
            "routes": routes}


# -- phases 7 and 8: ResNet-50 training ---------------------------------------------

def _step_errs(got, want):
    """Relative errors of one ResNet-50 training step's (logits, running
    statistics, gradients) against another's."""
    (lc, sc, gc), (lp, sp, gp) = got, want
    gerr = sorted(((_rel_err(gc[k], gp[k]), k) for k in gp), reverse=True)
    return {"logits": _rel_err(lc, lp),
            "state": max(_rel_err(sc[k], sp[k]) for k in sp),
            "grad_fc": _rel_err(gc["10.weight"], gp["10.weight"]),
            "grad_all": gerr[0][0], "grad_worst3": gerr[:3]}


STEP_METRICS = ("logits", "state", "grad_fc", "grad_all")


def resnet_card_vs_cpu(torch, K, dtype, truth=None, B=2, S=224):
    """The model on the card (the kernels) against the same weights on the
    CPU (the kernels' plain versions), TF32 off: logits, new running
    statistics and gradients of one training step on a small batch, in
    float32, or through the bf16 recipe (``bf16_params`` of float32
    masters, bf16 images, float32 logits into the loss) with every fused
    launch on the card on the ``bf16_sm90`` route, where both bf16 runs are
    also held against ``truth``, the float32 step on the CPU; in float32
    also the exact max pool's tie routing on the card against the CPU's.
    Returns (record, the CPU's step)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.convert import flatten
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.utils.amp import bf16_params
    rng = np.random.RandomState(3)
    x = rng.randn(B, S, S, 3).astype(np.float32)
    y = torch.from_numpy(rng.randint(1, 1001, size=B))
    bf16 = dtype == torch.bfloat16
    out = {}
    for dev in ("cuda", "cpu"):
        m = ResNet50(format="NHWC", fused="pallas", fused_conv2=True,
                     zero_init_residual=False, device=dev, seed=5)
        if dev == "cpu":
            m.load_state_dict({k: v.cpu() for k, v in card_sd.items()})
        else:
            card_sd = m.state_dict()
        params = m.params
        K.reset_launch_counts()
        logits, ns = m.apply(bf16_params(params) if bf16 else params, m.state,
                             torch.from_numpy(x).to(dev, dtype),
                             training=True)
        loss = nn.CrossEntropyCriterion()._forward(logits.float(), y.to(dev))
        leaves = flatten(params)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if dev == "cuda":
            routes = K.launches_by_route()
        out[dev] = (logits.detach().float().cpu(),
                    {k: v.float().cpu() for k, v in flatten(ns).items()},
                    {k: g.float().cpu() for k, g in zip(leaves, grads)})
    rec = dict(dtype=str(dtype), **_step_errs(out["cuda"], out["cpu"]))
    rec["fused_routes"] = {n: routes[n] for n in (
        "fused_matmul_fwd", "fused_matmul_bwd", "fused_chain_fwd",
        "fused_chain_bwd", "fused_conv_fwd")}
    # bf16: every fused launch on bf16_sm90; float32: every one on the
    # 3xTF32 route
    want = {n: "bf16_sm90" if bf16 else "f32_sm90"
            for n in rec["fused_routes"]}
    check(all(r[want[n]] > 0 and sum(r.values()) == r[want[n]]
              for n, r in rec["fused_routes"].items()),
          f"ResNet-50 on the card ({dtype}): fused launches by route "
          f"{rec['fused_routes']}, expected {want}")
    if bf16:
        card = _step_errs(out["cuda"], truth)
        cpu = _step_errs(out["cpu"], truth)
        rec["card_vs_f32"] = {k: card[k] for k in STEP_METRICS}
        rec["cpu_vs_f32"] = {k: cpu[k] for k in STEP_METRICS}
        print(f"[7] ResNet-50 card vs CPU (B{B}/{S}, bf16 recipe, "
              f"fused_conv2, one training step): {rec}", flush=True)
        # bf16 keeps 8 significant bits, and the two runs round every
        # activation at the same points but after float32 sums taken in
        # other orders, so a sum that lands on the other side of a bf16
        # rounding boundary moves by one ulp (2^-8) and carries that
        # through 50 layers and the one-pass BatchNorm variances of the B2
        # batch (cancellation in stage 3): the two bf16 runs differ by
        # percents, and by more in the deep gradients. What the kernels
        # must not do is add error: the card's bf16 step has to be as close
        # to the float32 step as the CPU's bf16 step is (at most twice its
        # distance, plus 1e-3)
        check(all(card[k] <= 2 * cpu[k] + 1e-3 for k in STEP_METRICS),
              f"ResNet-50 bf16 on the card is further from float32 than "
              f"bf16 on the CPU: {rec}")
        return rec, out["cpu"]
    # ties, as after the stem's ReLU: the first maximum of each window
    pool = nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format="NHWC")
    xp = torch.relu(torch.from_numpy(rng.randn(4, 56, 56, 64).astype(
        np.float32)))
    gpool = {}
    for dev in ("cuda", "cpu"):
        t = xp.to(dev).requires_grad_()
        pool.forward(t).sum().backward()
        gpool[dev] = t.grad.cpu()
    rec["pool_grad_equal"] = bool(torch.equal(gpool["cuda"], gpool["cpu"]))
    print(f"[7] ResNet-50 card vs CPU (B{B}/{S}, float32, fused_conv2, one "
          f"training step): {rec}", flush=True)
    # float32 everywhere, sums in other orders: the logits, statistics and
    # classifier gradients agree to ~1e-5 (1e-4 allowed); the deeper
    # gradients pass backwards through the one-pass BatchNorm variances of
    # stage 3 (98 pixels each at B2), whose cancellation amplifies the
    # rounding differences (the JAX package's own plain and kernel paths
    # differ by 2-8% there at small batches; 1e-1 allowed)
    check(rec["logits"] <= 1e-4 and rec["state"] <= 1e-4
          and rec["grad_fc"] <= 1e-4 and rec["grad_all"] <= 1e-1,
          f"ResNet-50 on the card disagrees with the CPU: {rec}")
    check(rec["pool_grad_equal"], "max pool ties routed differently on the "
          "card and the CPU")
    return rec, out["cpu"]


def _first_diffs(torch, got, want, n=4):
    """The first ``n`` elements (flat index, got, want) where two tensors of
    one shape differ."""
    g, w = got.flatten(), want.flatten()
    idx = torch.nonzero(g != w).flatten()[:n].tolist()
    return [(i, g[i].item(), w[i].item()) for i in idx]


def trace_steps(torch, step, n=2, top=20, per_call=1, convs=True):
    """``n`` calls of ``step`` (each ``per_call`` training steps) under
    ``torch.profiler``: the wall ms per step (profiled, so inflated by
    the profiler's own host work), the
    device ms per step (the sum of the CUDA kernels' own times), the
    kernel launches per step, the device ms per step of each family of
    kernels (the port's own, cuDNN's convolutions, cuBLAS's products,
    PyTorch's elementwise / reduction / copy kernels, the rest) and the
    ``top`` kernels by time, (name, ms per step, launches per step). On a
    path without convolutions (``convs=False``) the ``xmma`` kernels are
    cuBLAS's GEMMs, not cuDNN's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (n * per_call)
    n *= per_call
    own = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3 / n
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted(((e.key, own(e), e.count / n) for e in kern),
                  key=lambda r: -r[1])

    def family(name):
        low = name.lower()
        if "bigdl" in low:
            return "port kernels"
        if "nccl" in low:
            return "NCCL"
        if not convs and "xmma_gemm" in low:
            return "cuBLAS"
        if any(w in low for w in ("conv", "cudnn", "xmma", "dgrad",
                                  "wgrad", "implicit")):
            return "cuDNN conv"
        if "gemm" in low or "cutlass" in low or "cublas" in low:
            return "cuBLAS"
        if "at::native" in low:
            return "PyTorch elementwise/reduce/copy"
        return "other"
    fams = {}
    for k, ms, _ in rows:
        fams[family(k)] = fams.get(family(k), 0.0) + ms
    return {"wall_ms": wall, "device_ms": sum(r[1] for r in rows),
            "launches": sum(r[2] for r in rows),
            "families": {f: round(ms, 2) for f, ms in sorted(
                fams.items(), key=lambda f: -f[1])},
            "top": [(k[:90], round(ms, 3), c) for k, ms, c in rows[:top]]}


def resnet_recipe(torch, K, model, init, x, y, steps=4, trace=False):
    """The repository's ResNet-50 recipe (bench.py _build_resnet_step):
    float32 masters, ``bf16_params`` inside the loss, bf16 images, the
    model's functional ``apply`` in training mode, ``CrossEntropyCriterion``
    on float32 logits, SGD(0.1, momentum=0.9) in place, the new running
    statistics written back. 1 warmup step, then ``steps`` on the same
    batch; launch counts are read per step. ``trace``: then two more steps
    under the profiler (:func:`trace_steps`)."""
    from bigdl_tpu_torch.convert import flatten, unflatten
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.module import assign_state
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.amp import bf16_params
    model.load_state_dict(init)
    params, mstate = model.params, model.state
    leaves = flatten(params)
    crit = CrossEntropyCriterion()
    optim = SGD(learningrate=0.1, momentum=0.9)
    opt_state = optim.init_state(params)

    def step():
        out, new_state = model.apply(bf16_params(params), mstate, x,
                                     training=True)
        loss = crit._forward(out.float(), y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        optim.update(unflatten(dict(zip(leaves, grads))), params, opt_state,
                     0.1)
        assign_state(mstate, new_state)
        return loss, grads

    conv2 = model[4].blocks[0].fused_conv2
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(fused_matmul_fwd=24, fused_matmul_bwd=24, fused_chain_fwd=12,
                fused_chain_bwd=12, fused_conv_fwd=16 if conv2 else 0)
    # every bf16 K3 / K4 / K5 launch on the tensor-core route
    fused = ("fused_matmul_fwd", "fused_matmul_bwd", "fused_chain_fwd",
             "fused_chain_bwd", "fused_conv_fwd")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, total = [], [], dict.fromkeys(want, 0)
    for i in range(steps + 1):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        check(counts == want, f"ResNet-50 step (fused_conv2={conv2}) "
              f"launched {counts}, expected {want}")
        routes = K.launches_by_route()
        check(all(only_on(routes[n], "bf16_sm90", want[n]) for n in fused),
              f"ResNet-50 step (fused_conv2={conv2}) launches by route "
              f"{routes}, expected all on bf16_sm90")
        check(torch.stack([torch.isfinite(g).all() for g in grads])
              .all().item(), f"non-finite gradient (fused_conv2={conv2})")
        losses.append(loss.item())
        if i > 0:                      # step 0 is the warmup
            times.append(dt)
            for n in total:
                total[n] += counts[n]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    moved = float(model[1].running_mean.abs().max())
    check(moved > 0, "the stem BatchNorm's running mean never moved")
    out = {"fused_conv2": conv2, "losses": losses,
           "step_s": statistics.median(times), "step_s_all": times,
           "max_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "launches": total}
    if trace:
        out["trace"] = trace_steps(torch, step)
    return out


def resnet_local_optimizer(torch, K, model, init, B=32, S=224, iters=3):
    """The normal entry point: ``Optimizer.create`` (a LocalOptimizer) over
    a DataSet of image Samples (H, W, 3) with 1-based labels,
    CrossEntropyCriterion, SGD(0.1, momentum=0.9), float32 parameters."""
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger, max_iteration
    model.load_state_dict(init)
    rng = np.random.RandomState(4)
    imgs = rng.randn(B * iters, S, S, 3).astype(np.float32)
    labels = rng.randint(1, 1001, size=B * iters)
    samples = [Sample(imgs[i], labels[i]) for i in range(B * iters)]
    losses = []
    stop = max_iteration(iters)
    end = Trigger(lambda st: losses.append(st["loss"]) or stop(st))
    opt = Optimizer.create(model, DataSet.array(samples),
                           CrossEntropyCriterion(), end, batch_size=B,
                           optim_method=SGD(learningrate=0.1, momentum=0.9))
    before = model[1].running_mean.clone()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    routes = K.launches_by_route()
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(fused_matmul_fwd=24 * iters, fused_matmul_bwd=24 * iters,
                fused_chain_fwd=12 * iters, fused_chain_bwd=12 * iters)
    check(counts == want, f"ResNet-50 LocalOptimizer launched {counts}, "
          f"expected {want}")
    # float32 parameters: every K3 and K5 launch on the 3xTF32 route
    for n in ("fused_matmul_fwd", "fused_matmul_bwd", "fused_chain_fwd",
              "fused_chain_bwd"):
        check(only_on(routes[n], "f32_sm90", want[n]),
              f"ResNet-50 LocalOptimizer {n} launches by route {routes[n]}")
    check(len(losses) == iters and all(math.isfinite(v) for v in losses),
          f"ResNet-50 LocalOptimizer losses {losses}")
    check(not torch.equal(model[1].running_mean, before),
          "LocalOptimizer left the running statistics where they were")
    # two more iterations (a new Optimizer over the first two batches)
    # under the profiler: the device's busy time a step against the step
    again = Optimizer.create(model, DataSet.array(samples[:2 * B]),
                             CrossEntropyCriterion(), max_iteration(2),
                             batch_size=B,
                             optim_method=SGD(learningrate=0.1, momentum=0.9))
    trace = trace_steps(torch, again.optimize, n=1, per_call=2)
    return {"losses": losses, "wall_s": dt,
            "step_s": opt.metrics.values["step_time"], "launches": counts,
            "routes": routes, "trace": trace}


# -- phase 9: serving depth ----------------------------------------------------

# bf16 logits through two paths (dense against paged, S = 1 against the
# verify's S = 5, another batch bucket): a step whose top-2 margin is under
# this is a near-tie, where two correct paths may choose apart
SERVE_TOL = 0.1


def forced_greedy(torch, model, params, prompt, toks):
    """(greedy ids, top-2 margins) of one dense forward over prompt + toks
    at each position of toks (teacher-forced): while toks follow them,
    these are the tokens a solo greedy decode emits."""
    ids = torch.from_numpy(np.concatenate([prompt, toks])[None, :-1]).cuda()
    with torch.no_grad():
        lg = model.call(params, ids)[0, prompt.size - 1:].float()
    top = lg.topk(2, dim=-1)
    return (top.indices[:, 0].cpu().numpy(),
            (top.values[:, 0] - top.values[:, 1]).cpu().numpy())


def agree(what, got, want, margins, tol=SERVE_TOL):
    """got equals want position by position up to the first near-tie;
    returns the positions compared."""
    n = 0
    for t in range(len(want)):
        if margins[t] < tol:
            break
        g = int(got[t]) if t < len(got) else None
        check(g == int(want[t]), f"{what} step {t}: {g} against "
              f"{int(want[t])} (margin {margins[t]:.3g})")
        n += 1
    return n


def drive(sched, prompts, budgets, **kw):
    """Submit every request at once: (tokens, traces, wall seconds)."""
    t0 = time.perf_counter()
    futs = [sched.submit(p, n, **kw) for p, n in zip(prompts, budgets)]
    res = [f.result(600) for f in futs]
    return res, [f.trace for f in futs], time.perf_counter() - t0


def settle_spills(sched, deadline_s=60.0):
    """Spills stage asynchronously: wait until none is still in flight (a
    lookup that meets one takes the cold path instead of waiting)."""
    from bigdl_tpu_torch.serving.kv_cache import SPILL_PENDING
    t0 = time.monotonic()
    while True:
        with sched.prefix._lock:
            pending = [h for h, _ in sched.prefix._spilled.values()
                       if h.state == SPILL_PENDING]
        if not pending:
            return
        check(time.monotonic() - t0 < deadline_s, "spills never staged")
        time.sleep(0.002)


def path_counts(torch, K, what, n_paged=None):
    """Read the launch counters after a serving path: K2 launched (only on
    f32_split, the pools' float32 pages), no other kernel."""
    torch.cuda.synchronize()
    counts = K.launch_counts()
    routes = K.launches_by_route()["paged_attention"]
    n = counts["paged_attention"]
    check(n > 0 and only_on(routes, "f32_split", n),
          f"{what}: K2 launches by route {routes}")
    others = {k: v for k, v in counts.items() if k != "paged_attention"}
    check(not any(others.values()), f"{what}: other kernels launched "
          f"{others}")
    return n


def p50(xs):
    return statistics.median(xs)


# the float32 pages the scheduler's paged prefill (K2) wrote for a prompt,
# held against the K / V of the dense prefill (flash) of the same tokens
# from the same bf16 weights: per layer and half, the largest difference
# over the reference's largest magnitude. Both round K / V to bf16 (2^-8
# relative) after layers that summed in different orders; a page of
# another position or prompt is off by the order of the magnitude itself
PAGE_TOL = 0.05


def gather_pages(torch, kv, blocks):
    """Device copies of ``blocks``' pages, per layer (k, v), queued on the
    current stream (after every write queued before)."""
    idx = torch.as_tensor(list(blocks), dtype=torch.long, device=kv.device)
    return [(k.index_select(0, idx), v.index_select(0, idx))
            for k, v in kv.pages()]


def dense_pages(torch, model, params, tokens, bs):
    """K / V of the dense prefill of ``tokens`` (its whole blocks), laid
    out as pages of ``bs`` positions in float32."""
    n = tokens.size // bs * bs
    ids = torch.from_numpy(tokens[None, :n]).cuda()
    with torch.no_grad():
        _, caches = model.prefill(params, ids, n)
    return [tuple(t[0].reshape(t.shape[1], n // bs, bs, t.shape[3])
                  .transpose(0, 1).float() for t in kv) for kv in caches]


def page_err(got, want):
    return max(float((g.float() - w).abs().max() / w.abs().max())
               for gl, wl in zip(got, want) for g, w in zip(gl, wl))


def same_pages(a, b):
    """Bit for bit equal, every layer and half."""
    return len(a) == len(b) and all(x.equal(y) for la, lb in zip(a, b)
                                    for x, y in zip(la, lb))


def resident_chain(torch, sched, tokens):
    """The prefix cache's resident chain of ``tokens`` (recency left as it
    is) and a device copy of its pages. Call with the scheduler idle."""
    blocks = sched.prefix._walk(tokens, sched.registry.current().version,
                                touch=False)[0]
    return blocks, gather_pages(torch, sched.kv, blocks)


def trace_copies(torch, kv):
    """Record each page copy of the pool (copy-on-write forks, defrag) as
    (source pages before it, target pages after it). Returns the list."""
    copies, plain = [], kv._copy_pages

    def traced(moves):
        before = gather_pages(torch, kv, [s for s, _ in moves])
        plain(moves)
        copies.append((before, gather_pages(torch, kv, [d for _, d in moves])))

    kv._copy_pages = traced
    return copies


def trace_swaps(torch, swap):
    """Record the pages each spill captures (at its boundary, before the
    blocks go back) and the pages each refill lands (right after its
    scatter, in stream order), and the blocks of each stager job:
    ({handle: pages}, [(handles, pages)], [blocks a job])."""
    kv, spilled, refills, jobs = swap.kv, {}, [], []
    spill_many, refill_many, refill = (swap.spill_many, swap.refill_many,
                                       swap.refill)

    def spill_many_t(groups, tag=None):
        groups = [[int(b) for b in g] for g in groups]
        flat = [b for g in groups for b in g]
        before = gather_pages(torch, kv, flat) if flat else None
        hs = spill_many(groups, tag=tag)
        if any(h is not None for h in hs):
            jobs.append(sum(len(g) for g, h in zip(groups, hs)
                            if h is not None))
        s = 0
        for g, h in zip(groups, hs):
            if h is not None:
                spilled[h] = [(k[s:s + len(g)], v[s:s + len(g)])
                              for k, v in before]
            s += len(g)
        return hs

    def refill_many_t(owner, handles):
        ids, consumed, dropped = refill_many(owner, handles)
        if consumed:
            refills.append((list(handles[:consumed]),
                            gather_pages(torch, kv, ids)))
        return ids, consumed, dropped

    def refill_t(owner, handle):
        ids = refill(owner, handle)
        if ids is not None:
            refills.append(([handle], gather_pages(torch, kv, ids)))
        return ids

    swap.spill_many, swap.refill_many, swap.refill = (
        spill_many_t, refill_many_t, refill_t)
    return spilled, refills, jobs


def check_swaps(torch, what, spilled, refills):
    """Each refill landed, bit for bit, the pages its spills captured.
    Returns the blocks compared."""
    n = 0
    for hs, got in refills:
        want = [tuple(torch.cat([spilled[h][li][half] for h in hs])
                      for half in (0, 1)) for li in range(len(got))]
        check(same_pages(got, want), f"{what}: a refill of {len(hs)} "
              f"spilled segments landed other bytes than they captured")
        n += int(got[0][0].shape[0])
    return n


def serving_depth(torch, K):
    """Phase 9: the flagship at full width (vocab 32000, hidden 1024, 16
    heads, filter 4096, 12 layers, max_len 512, bf16 weights, float32
    pages) through DecodeScheduler(max_slots=8, block_size=16,
    prefill_chunk=32): (a) the prefix cache, (b) speculative decoding,
    (c) the host tier and preemption. Returns the readings."""
    import copy
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import speculative_generate
    from bigdl_tpu_torch.serving import (DecodeScheduler, blocks_for_tokens,
                                         kv_swap_threads_alive)
    V, L, BS = 32000, 12, 16
    cfg = dict(vocab_size=V, hidden_size=1024, num_heads=16,
               filter_size=4096, max_len=512)
    sk = dict(max_slots=8, block_size=BS, prefill_chunk=32)
    r9 = {}
    t0 = time.perf_counter()
    model = TransformerLM(num_layers=L, seed=0, **cfg).to(torch.bfloat16)
    params = model.params
    print(f"[9] serving depth on the flagship (bf16 weights, float32 pages; "
          f"built in {time.perf_counter() - t0:.1f} s)", flush=True)

    # (a) the prefix cache: 6 system prompts of 448 tokens, 4 suffixes of
    # 8 each; one request a prompt first, then the other 18 together;
    # without the cache, then with it (JAX's default)
    rng = np.random.RandomState(9)
    systems = [rng.randint(1, V, 448).astype(np.int32) for _ in range(6)]
    reqs = [[np.concatenate([s, rng.randint(1, V, 8).astype(np.int32)])
             for _ in range(4)] for s in systems]
    first = [r[0] for r in reqs]
    rest = [q for r in reqs for q in r[1:]]
    chain = 448 // BS
    refs = [dense_pages(torch, model, params, s, BS) for s in systems]
    runs = {}
    for pc in (False, True):
        sched = DecodeScheduler(model, max_seq_len=512, prefix_cache=pc,
                                **sk)
        copies = trace_copies(torch, sched.kv)
        sched.start()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        r1, _, w1 = drive(sched, first, [32] * 6)
        r2, t2, w2 = drive(sched, rest, [32] * 18)
        n_k2 = path_counts(torch, K, f"prefix_cache={pc}")
        st = sched.stats()
        runs[pc] = dict(tokens=r1 + r2, ttft=[t["ttft_ms"] for t in t2],
                        chunks=st["prefill_chunks"], wall=w1 + w2,
                        k2=n_k2, stats=st)
        if not pc:
            sched.shutdown()
            check(sched.stats()["kv"]["blocks_in_use"] == 0,
                  "cold run leaked blocks")
            continue
        check(st["prefix_hits"] == 18 and st["prefix_misses"] == 6
              and st["prefix_reused_tokens"] == 448 * 18,
              f"prefix hits {st['prefix_hits']} misses "
              f"{st['prefix_misses']} reused {st['prefix_reused_tokens']}")
        # each warm request reruns only its 8-token tail chunk
        check(st["prefill_chunks"] == 6 * 15 + 18,
              f"warm prefill chunks {st['prefill_chunks']}")
        # the pages every warm request read: each prompt's resident chain
        # against the dense prefill of its tokens
        chains, errs = [], []
        for i, sp_ in enumerate(systems):
            blocks, pages = resident_chain(torch, sched, sp_)
            check(len(blocks) == chain, f"(a) prompt {i}: {len(blocks)} of "
                  f"{chain} chain blocks resident")
            errs.append(page_err(pages, refs[i]))
            check(errs[-1] <= PAGE_TOL, f"(a) prompt {i}'s chain pages off "
                  f"the dense prefill's K / V by {errs[-1]:.3g}")
            chains.append(pages)
        # an exact aligned repeat reruns its last chunk over
        # copy-on-write forks; the registrant and a third request then
        # read the shared pages unchanged
        forks0 = st["prefix_cow_forks"]
        cow = sched.generate(systems[0], 32, timeout=600)
        third = sched.generate(reqs[0][1], 32, timeout=600)
        again = sched.generate(reqs[0][0], 32, timeout=600)
        st = sched.stats()
        check(st["prefix_cow_forks"] >= forks0 + 1 and copies,
              f"copy-on-write forks {st['prefix_cow_forks']}, page copies "
              f"{len(copies)}")
        n_fork = len(copies)
        check(same_pages(resident_chain(torch, sched, systems[0])[1],
                         chains[0]),
              "(a) the shared chain's pages changed under the copy-on-write "
              "repeat")
        # defrag at a boundary, then a warm hit
        frag = sched.kv.frag_blocks()
        check(sched.defrag() == -1, "defrag not deferred to a boundary")
        t0 = time.monotonic()
        while frag and sched.stats()["defrags"] == st["defrags"]:
            check(time.monotonic() - t0 < 30, "defrag never ran")
            time.sleep(0.002)
        frag_after = sched.kv.frag_blocks()
        after_defrag = sched.generate(reqs[1][2], 32, timeout=600)
        st = sched.stats()
        # every chain reads its old bytes through the remapped index, and
        # every page copy (fork or defrag) landed its source's bytes
        for i, sp_ in enumerate(systems):
            blocks, pages = resident_chain(torch, sched, sp_)
            check(len(blocks) == chain and same_pages(pages, chains[i]),
                  f"(a) prompt {i}'s chain pages changed across defrag")
        for before, after in copies:
            check(same_pages(before, after), "(a) a page copy (fork or "
                  "defrag) landed other bytes than its source held")
        sched.shutdown()
        check(sched.stats()["kv"]["blocks_in_use"] == 0
              and sched.audit()["ok"], f"warm run: blocks "
              f"{sched.stats()['kv']} audit {sched.audit()}")
        check(frag == 0 or (st["defrags"] >= 1 and frag_after == 0
                            and len(copies) > n_fork),
              f"defrag: {frag} holes before, {frag_after} after, "
              f"{len(copies) - n_fork} copies")
        runs[pc].update(cow_forks=st["prefix_cow_forks"], frag=frag,
                        frag_after=frag_after, page_err=max(errs),
                        copied=sum(int(b[0][0].shape[0]) for b, _ in copies),
                        fork_copies=n_fork,
                        defrag_copies=len(copies) - n_fork)
        del chains, copies
    cold, warm = runs[False], runs[True]
    compared = 0
    for i, p in enumerate(first + rest):
        want, margins = forced_greedy(torch, model, params, p,
                                      warm["tokens"][i])
        compared += agree(f"(a) warm request {i}", warm["tokens"][i], want,
                          margins)
        agree(f"(a) cold request {i}", cold["tokens"][i], want, margins)
        if i == 0:
            agree("(a) registrant after the fork", again, want, margins)
        if i == 6:
            agree("(a) third request after the fork", third, want, margins)
        if i == 6 + 4:
            agree("(a) warm hit after defrag", after_defrag, want, margins)
    want, margins = forced_greedy(torch, model, params, systems[0], cow)
    agree("(a) the aligned repeat", cow, want, margins)
    r9["a"] = dict(cold_ttft_p50=p50(cold["ttft"]),
                   warm_ttft_p50=p50(warm["ttft"]),
                   cold_chunks=cold["chunks"], warm_chunks=warm["chunks"],
                   cold_wall=cold["wall"], warm_wall=warm["wall"],
                   k2=warm["k2"], compared=compared,
                   cow_forks=warm["cow_forks"], frag=warm["frag"],
                   page_err=warm["page_err"], copied_blocks=warm["copied"])
    print(f"    (a) prefix cache: 24 requests (6 x 448-token system prompts "
          f"+ 8-token suffixes, 32 new tokens); second wave TTFT p50 cold "
          f"{r9['a']['cold_ttft_p50']:.1f} ms, warm "
          f"{r9['a']['warm_ttft_p50']:.1f} ms; prefill chunks cold "
          f"{cold['chunks']}, warm {warm['chunks']}; wall cold "
          f"{cold['wall']:.2f} s, warm {warm['wall']:.2f} s; hits 18, "
          f"reused tokens {448 * 18}; copy-on-write forks "
          f"{warm['cow_forks']}; {warm['frag']} holes before defrag, "
          f"{warm['frag_after']} after; K2 launches {warm['k2']} (cold "
          f"{cold['k2']}); tokens equal greedy on {compared} steps; pages: "
          f"the 6 chains within {warm['page_err']:.3g} of the dense "
          f"prefill's K / V (tolerance {PAGE_TOL}), bit for bit unchanged "
          f"by the repeat and by defrag; {warm['fork_copies']} fork and "
          f"{warm['defrag_copies']} defrag copies ({warm['copied']} blocks) "
          f"bit for bit equal to their sources", flush=True)

    # (b) speculative decoding, spec_k = 4: draft pair 1 is the target's
    # own embed / ln_f / block0 (its deeper blocks add zero to the
    # residual: bench_serving.py _build_spec_pair), pair 2 a 2-layer draft
    # of its own seed. A random LM of this width with tied embeddings
    # greedily repeats its last token whatever its seed, so a random draft
    # agrees with the target; pair 2's final LayerNorm gain is negated, so
    # it proposes the token least like the one the target repeats and its
    # rounds take the rejection path
    target = copy.deepcopy(model)
    draft1 = TransformerLM(num_layers=1, seed=1, **cfg).to(torch.bfloat16)
    draft2 = TransformerLM(num_layers=2, seed=2, **cfg).to(torch.bfloat16)
    with torch.no_grad():
        draft2.ln_f.weight.neg_()
        tsd = target.state_dict()
        for k, v in draft1.state_dict().items():
            tsd[k].copy_(v)
        for i in range(1, L):
            for k in ("attn.wo", "ffn.w2", "ffn.b2"):
                tsd[f"block{i}.{k}"].zero_()
    tparams = target.params
    sp = [rng.randint(1, V, rng.randint(4, 33)).astype(np.int32)
          for _ in range(16)]
    sb = [int(rng.randint(32, 65)) for _ in range(16)]
    spec = {}
    for name, draft in (("plain", None), ("pair1", draft1),
                        ("pair2", draft2)):
        sched = DecodeScheduler(target, max_seq_len=128, draft_model=draft,
                                spec_k=4, **sk).start()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        res, _, wall = drive(sched, sp, sb)
        n_k2 = path_counts(torch, K, f"(b) {name}")
        # the verify is the only call at S = spec_k + 1 (decode and draft
        # steps run at 1, prefill chunks and catch-up at powers of two)
        n_verify = K.paged_decode_attention.launches_by_s.get(4 + 1, 0)
        sched.shutdown()
        st = sched.stats()
        check(st["kv"]["blocks_in_use"] == 0 and sched.audit()["ok"],
              f"(b) {name}: blocks {st['kv']} audit {sched.audit()}")
        check(draft is None or st["spec_rounds"] > 0,
              f"(b) {name} ran no speculative round")
        check(n_verify == L * st["spec_rounds"], f"(b) {name}: {n_verify} "
              f"K2 launches at S = 5, {st['spec_rounds']} verify rounds of "
              f"{L} layers")
        spec[name] = dict(tokens=res, tps=sum(r.size for r in res) / wall,
                          wall=wall, k2=n_k2, verify=n_verify, st=st,
                          accept=(st["spec_accepted"]
                                  / max(st["spec_row_rounds"], 1)))
    compared = 0
    for i, p in enumerate(sp):
        want, margins = forced_greedy(torch, target, tparams, p,
                                      spec["plain"]["tokens"][i])
        compared += agree(f"(b) plain request {i}",
                          spec["plain"]["tokens"][i], want, margins)
        for name in ("pair1", "pair2"):
            agree(f"(b) {name} request {i}", spec[name]["tokens"][i],
                  spec["plain"]["tokens"][i], margins)
    check(spec["pair1"]["accept"] >= 3.0, f"draft pair 1 accepted "
          f"{spec['pair1']['accept']:.3f} of 4 a row round")
    check(spec["pair2"]["accept"] < 1.0, f"draft pair 2 accepted "
          f"{spec['pair2']['accept']:.3f} of 4 a row round: the rejection "
          f"path did not run")
    # speculative_generate at batch 8 against generate
    sg = rng.randint(1, V, (8, 32)).astype(np.int32)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    ids_spec, sst = speculative_generate(target, tparams, draft1,
                                         draft1.params, sg, 32, 4,
                                         return_stats=True)
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    sg_counts = K.launch_counts()
    sg_routes = K.launches_by_route()["flash_fwd"]
    check(only_on(sg_routes, "bf16_sm90", L + 1)
          and sg_counts["flash_fwd"] == L + 1,
          f"speculative_generate's flash launches {sg_counts} {sg_routes} "
          f"(one a layer for each prefill)")
    t0 = time.perf_counter()
    ids_gen = target.generate(tparams, sg, 32)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    sg_cmp = 0
    for b in range(8):
        want, margins = forced_greedy(torch, target, tparams, sg[b],
                                      ids_gen[b, 32:].cpu().numpy())
        sg_cmp += agree(f"(b) speculative_generate row {b}",
                        ids_spec[b, 32:].cpu().numpy(),
                        ids_gen[b, 32:].cpu().numpy(), margins)
    r9["b"] = dict({n: dict(tokens_per_s=v["tps"], wall=v["wall"], k2=v["k2"],
                            spec_rounds=v["st"]["spec_rounds"],
                            accepted_per_row_round=v["accept"],
                            fallbacks=v["st"]["spec_fallbacks"])
                    for n, v in spec.items()},
                   compared=compared, sg_compared=sg_cmp,
                   sg_accepted=int(sst.accepted), sg_drafted=int(sst.drafted),
                   sg_s=t_spec, gen_s=t_gen)
    print(f"    (b) speculative decoding, spec_k 4, 16 requests (prompts "
          f"4-32, budgets 32-64): tokens/s plain "
          f"{spec['plain']['tps']:.1f}, pair 1 {spec['pair1']['tps']:.1f} "
          f"(accepted {spec['pair1']['accept']:.3f} of 4 a row round), pair "
          f"2 {spec['pair2']['tps']:.1f} (accepted "
          f"{spec['pair2']['accept']:.3f}); spec rounds / fallbacks pair 1 "
          f"{spec['pair1']['st']['spec_rounds']} / "
          f"{spec['pair1']['st']['spec_fallbacks']}, pair 2 "
          f"{spec['pair2']['st']['spec_rounds']} / "
          f"{spec['pair2']['st']['spec_fallbacks']}; K2 launches plain "
          f"{spec['plain']['k2']}, pair 1 {spec['pair1']['k2']} (verify "
          f"{spec['pair1']['verify']}), pair 2 {spec['pair2']['k2']} (verify "
          f"{spec['pair2']['verify']}), all f32_split; tokens equal plain on "
          f"{compared} steps; speculative_generate batch 8 x 32 in "
          f"{t_spec:.3f} s ({int(sst.accepted)} of {int(sst.drafted)} "
          f"drafts accepted) against generate {t_gen:.3f} s, equal on "
          f"{sg_cmp} steps", flush=True)
    r9["verify_k2"] = spec["pair1"]["verify"] + spec["pair2"]["verify"]
    del target, draft1, draft2, tparams
    torch.cuda.empty_cache()

    # (c) the host tier: a pool that holds 2 of the 6 chains beside two
    # requests' worst case (bench_serving.py's sizing); the prompts rotate
    # twice, so chains spill and refill. Without the tier; with it, every
    # spill staged before the next request (its spills and refills traced
    # page by page); and with it untraced and unsettled, so refills and
    # the spills their admission starts overlap (the timed run)
    worst = blocks_for_tokens(448 + 8 + 16, BS)
    tight, host = 1 + 2 * chain + 2 * worst, 2 * 6 * chain + 16
    rot = [np.concatenate([s, rng.randint(1, V, 8).astype(np.int32)])
           for _ in range(2) for s in systems]
    tiers = {}
    for name, hb in (("none", 0), ("tier", host), ("overlap", host)):
        sched = DecodeScheduler(model, max_seq_len=512, num_blocks=tight,
                                host_blocks=hb, **sk)
        spilled, refills, jobs = (trace_swaps(torch, sched.kv_swap)
                                  if name == "tier" else ({}, [], []))
        sched.start()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        res, chains = [], []
        t0 = time.perf_counter()
        for p in rot:
            if name == "tier":
                settle_spills(sched)
            res.append(sched.generate(p, 16, timeout=600))
            # the chain this request read (refilled, or prefilled cold)
            blocks, pages = resident_chain(torch, sched, p)
            check(len(blocks) == chain, f"(c) {name}: {len(blocks)} of "
                  f"{chain} chain blocks resident")
            chains.append(pages)
        wall = time.perf_counter() - t0
        n_k2 = path_counts(torch, K, f"(c) {name}")
        st = sched.stats()
        sched.shutdown()
        end = sched.stats()
        check(end["kv"]["blocks_in_use"] == 0 and sched.audit()["ok"]
              and (not hb or end["host"]["host_blocks_in_use"] == 0),
              f"(c) {name}: {end['kv']} {end['host']}")
        tiers[name] = dict(tokens=res, st=st, wall=wall, k2=n_k2,
                           chains=chains, jobs=jobs,
                           swapped=check_swaps(torch, f"(c) {name}", spilled,
                                               refills))
        del spilled, refills
    page_errs = [page_err(c, refs[i % 6])
                 for i, c in enumerate(tiers["none"]["chains"])]
    check(max(page_errs) <= PAGE_TOL, f"(c) no-tier chain pages off the "
          f"dense prefill's K / V by {max(page_errs):.3g}")
    for name in ("tier", "overlap"):
        ps = tiers[name]["st"]["prefix"]
        check(ps["spills"] > 0, f"(c) {name}: no spill {ps}")
        for i, (a, b) in enumerate(zip(tiers[name]["chains"],
                                       tiers["none"]["chains"])):
            check(same_pages(a, b), f"(c) {name} request {i}: its chain's "
                  f"pages differ from the no-tier run's")
    tier = tiers["tier"]["st"]
    hs, ps = tier["host"], tier["prefix"]
    check(ps["refills"] > 0 and ps["hits_after_spill"] > 0
          and hs["swap_failures"] == 0 and hs["swap_out_bytes"] > 0
          and hs["swap_in_bytes"] > 0 and tiers["tier"]["swapped"] > 0,
          f"(c) host tier: prefix {ps} host {hs}, "
          f"{tiers['tier']['swapped']} blocks traced")
    compared = 0
    for i, p in enumerate(rot):
        want, margins = forced_greedy(torch, model, params, p,
                                      tiers["none"]["tokens"][i])
        compared += agree(f"(c) no-tier request {i}",
                          tiers["none"]["tokens"][i], want, margins)
        for name in ("tier", "overlap"):
            agree(f"(c) {name} request {i}", tiers[name]["tokens"][i],
                  tiers["none"]["tokens"][i], margins)
    for t in tiers.values():
        del t["chains"]
    gbs = {}
    for name in ("tier", "overlap"):
        h = tiers[name]["st"]["host"]
        gbs[name] = (h["swap_out_bytes"] / h["swap_out_s"] / 1e9,
                     (h["swap_in_bytes"] / h["swap_in_s"] / 1e9
                      if h["swap_in_s"] else 0.0))
    out_gbs, in_gbs = gbs["tier"]
    # priority preemption: 7 priority-0 requests fill the pool; a
    # priority-1 request arrives into it
    pp = [rng.randint(1, V, 64).astype(np.int32) for _ in range(7)]
    hi = rng.randint(1, V, 32).astype(np.int32)
    sched = DecodeScheduler(model, max_seq_len=256, num_blocks=1 + 7 * 8,
                            prefix_cache=False, host_blocks=64, **sk)
    spilled, refills, _ = trace_swaps(torch, sched.kv_swap)
    sched.start()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    lows = [sched.submit(p, 64) for p in pp]
    t0 = time.monotonic()
    while sched.stats()["active"] < 7:
        check(time.monotonic() - t0 < 120, "(c) the pool never filled")
        time.sleep(0.002)
    high = sched.submit(hi, 16, priority=1)
    r_hi = high.result(600)
    r_lo = [f.result(600) for f in lows]
    n_k2p = path_counts(torch, K, "(c) preemption")
    pst = sched.stats()
    sched.shutdown()
    end = sched.stats()
    check(pst["preemptions"] >= 1 and pst["resumes"] >= 1
          and pst["host"]["swap_failures"] == 0,
          f"(c) preemptions {pst['preemptions']} resumes {pst['resumes']} "
          f"recomputes {pst['resume_recomputes']} host {pst['host']}")
    check(end["kv"]["blocks_in_use"] == 0
          and end["host"]["host_blocks_in_use"] == 0 and sched.audit()["ok"],
          f"(c) preemption run: {end['kv']} {end['host']}")
    # the preempted request resumed over the bytes its spill captured
    p_swapped = check_swaps(torch, "(c) preemption", spilled, refills)
    check(p_swapped > 0, "(c) no resume went through a refill")
    del spilled, refills
    pcmp = 0
    for i, (p, r) in enumerate(zip(pp + [hi], r_lo + [r_hi])):
        want, margins = forced_greedy(torch, model, params, p, r)
        pcmp += agree(f"(c) preemption request {i}", r, want, margins)
    check(kv_swap_threads_alive() == 0, "swap stager threads left running")
    ov = tiers["overlap"]["st"]
    r9["c"] = dict(spills=ps["spills"], refills=ps["refills"],
                   hits_after_spill=ps["hits_after_spill"],
                   out_bytes=hs["swap_out_bytes"], out_s=hs["swap_out_s"],
                   in_bytes=hs["swap_in_bytes"], in_s=hs["swap_in_s"],
                   out_gbs=out_gbs, in_gbs=in_gbs,
                   wall_tier=tiers["tier"]["wall"],
                   wall_none=tiers["none"]["wall"],
                   wall_overlap=tiers["overlap"]["wall"],
                   overlap_gbs=gbs["overlap"],
                   overlap_spills=ov["prefix"]["spills"],
                   overlap_refills=ov["prefix"]["refills"],
                   chunks_tier=tier["prefill_chunks"],
                   chunks_none=tiers["none"]["st"]["prefill_chunks"],
                   chunks_overlap=ov["prefill_chunks"],
                   page_err=max(page_errs),
                   swapped_blocks=tiers["tier"]["swapped"],
                   spill_jobs=len(tiers["tier"]["jobs"]),
                   compared=compared, preemptions=pst["preemptions"],
                   resumes=pst["resumes"], preempt_swapped=p_swapped,
                   recomputes=pst["resume_recomputes"], preempt_cmp=pcmp,
                   k2=tiers["tier"]["k2"], k2_preempt=n_k2p)
    print(f"    (c) host tier: pool {tight} blocks, host {host} blocks; 12 "
          f"requests rotating the 6 prompts twice. Settled (each spill "
          f"staged before the next request): spills {ps['spills']}, "
          f"refills {ps['refills']} ({ps['hits_after_spill']} hits after a "
          f"spill); device to host {hs['swap_out_bytes']} B in "
          f"{hs['swap_out_s'] * 1e3:.3f} ms = {out_gbs:.2f} GB/s in "
          f"{len(tiers['tier']['jobs'])} stager jobs of "
          f"{min(tiers['tier']['jobs'])}-{max(tiers['tier']['jobs'])} "
          f"blocks ({2 * L} copies each), host to "
          f"device {hs['swap_in_bytes']} B in {hs['swap_in_s'] * 1e3:.3f} "
          f"ms = {in_gbs:.2f} GB/s (CUDA events on the copies); prefill "
          f"chunks {tier['prefill_chunks']} with the tier, "
          f"{tiers['none']['st']['prefill_chunks']} without; wall "
          f"{tiers['tier']['wall']:.2f} s / {tiers['none']['wall']:.2f} s. "
          f"Unsettled and untraced: spills {ov['prefix']['spills']}, "
          f"refills {ov['prefix']['refills']}, {gbs['overlap'][0]:.2f} / "
          f"{gbs['overlap'][1]:.2f} GB/s, prefill chunks "
          f"{ov['prefill_chunks']}, wall {tiers['overlap']['wall']:.2f} s. "
          f"Tokens equal the no-tier run on {compared} steps; pages: the "
          f"no-tier chains within {max(page_errs):.3g} of the dense "
          f"prefill's K / V, both tier runs' chains bit for bit equal to "
          f"the no-tier run's, {tiers['tier']['swapped']} refilled blocks "
          f"bit for bit equal to what their spills captured; preemption: "
          f"{pst['preemptions']} preempted, {pst['resumes']} resumed over "
          f"{p_swapped} refilled blocks bit for bit equal to their spill, "
          f"{pst['resume_recomputes']} recomputed, tokens equal greedy on "
          f"{pcmp} steps; K2 launches {n_k2p}", flush=True)
    del model, params
    torch.cuda.empty_cache()
    return r9


# -- phase 10: the serving control plane ----------------------------------------

# phase 9's flagship: vocab 32000, hidden 1024, 16 heads, filter 4096, 12
# layers, max_len 512 (bf16 weights, float32 pages)
FLAGSHIP = dict(vocab_size=32000, hidden_size=1024, num_heads=16,
                filter_size=4096, num_layers=12, max_len=512)
# (d): ResNet-50's image side, the engine's max_batch, the requests
IMAGE, ENGINE_BATCH, ENGINE_REQUESTS = 224, 32, 64

def eval_case(torch, K, kind):
    """The served ResNet-50's no-statistics forward of K3 (stage-0 conv3,
    BN2 + ReLU prologue), K4 (stage-0 3x3) or K5 (stage-0 junction) at
    B32/224 in float32: against its plain version, a rerun bit for bit,
    timed with the plain version, the bare product (cuBLAS, cuDNN's conv)
    and the bound of the no-statistics call."""
    from bigdl_tpu_torch.kernels.fused_conv import route as conv_route
    from bigdl_tpu_torch.kernels.fused_matmul import route
    F = torch.nn.functional
    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(10)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=g)

    def affine(n):
        return torch.rand(n, device="cuda", generator=g) + 0.5, rnd(n)

    if kind == "K3":
        M, Kd, N = FB * 56 * 56, 64, 256
        x, w = rnd(M, Kd), rnd(Kd, N, scale=0.1)
        a, b = affine(Kd)
        call = lambda: K.fused_matmul_fwd(x, w, a, b, True, False)  # noqa: E731
        plain = lambda: K.fused_matmul_fwd_reference(x, w, a, b, True,  # noqa: E731
                                                     False)
        lib = lambda: x @ w  # noqa: E731
        rt, shape = route(f32, Kd, N), [M, Kd, N]
        nbytes, flops = 4 * (M * Kd + Kd * N + M * N + 2 * Kd), 2.0 * M * Kd * N
    elif kind == "K5":
        M, Kd, N = FB * 56 * 56, 256, 64
        z, r, w = rnd(M, Kd), rnd(M, Kd), rnd(Kd, N, scale=0.1)
        a, b = affine(Kd)
        call = lambda: K.fused_chain_fwd(z, r, a, b, w, False)  # noqa: E731
        plain = lambda: K.residual_chain_reference(z, r, a, b, w, False)  # noqa: E731
        h = plain()[0]
        lib = lambda: h @ w  # noqa: E731
        rt, shape = route(f32, Kd, N), [FB, 56, 56, Kd, N]
        # reads z, r, w, a, b; writes h and zo
        nbytes = 4 * (3 * M * Kd + Kd * N + M * N + 2 * Kd)
        flops = 2.0 * M * Kd * N
    else:
        B, H, C, N = FB, 56, 64, 64
        x, w = rnd(B, H, H, C), rnd(3, 3, C, N, scale=0.1)
        a, b = affine(C)
        call = lambda: K.fused_conv_fwd(x, w, a, b, 1, False)  # noqa: E731
        plain = lambda: K.conv3x3_reference(x, w, a, b, 1, False)  # noqa: E731
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        lib = lambda: F.conv2d(xc, wc, padding=1)  # noqa: E731
        rt, shape = conv_route(f32, C, N), [B, H, H, C, N]
        nbytes = 4 * (B * H * H * C + 9 * C * N + B * H * H * N + 2 * C)
        flops = 2.0 * B * H * H * 9 * C * N
    got, ref, again = call(), plain(), call()
    torch.cuda.synchronize()
    outs = [(p, q) for p, q in zip(got, ref) if q is not None]
    errs = [_rel_err(p, q) for p, q in outs]
    rec = {"kind": kind, "shape": shape, "route": rt, "stats": False,
           "outputs": len(outs), "max_abs_err": max(errs),
           "tol": FUSED_TOL[str(f32)],
           "no_sums": all(q is None for q in ref[len(outs):]),
           "reruns_equal": _same(torch, got, again)}
    check(rt == "f32_sm90" and max(errs) <= rec["tol"] and rec["no_sums"]
          and rec["reruns_equal"], f"[10] {kind} no-statistics forward: "
          f"{rec}")
    rec.update(ms=graph_ms(torch, lambda i: call(), 1, reps=10),
               plain_ms=graph_ms(torch, lambda i: plain(), 1, reps=5),
               library_ms=graph_ms(torch, lambda i: lib(), 1, reps=10))
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, f32, rt)
    print(f"  [10] {kind} eval {rec}", flush=True)
    return rec


def submit_all(sched, prompts, budgets, prepare=None):
    """Warm the scheduler, call ``prepare()``, zero the launch counters,
    submit every request before the loop starts (so two runs batch
    alike), serve them: (tokens, wall seconds)."""
    import torch
    import bigdl_tpu_torch.kernels as K
    sched.warmup()
    if prepare is not None:
        prepare()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [sched.submit(p, n) for p, n in zip(prompts, budgets)]
    sched.start(warmup=False)
    res = [f.result(600) for f in futs]
    return res, time.perf_counter() - t0


def fault_after_write(sched, hit):
    """Raise a transient fault from the scheduler's ``_forward`` after it
    returned (the step's K / V already in the pages) where ``hit(call
    number, query rows S)`` says so, and count the K2 launches of every
    failed dispatch unit (a replay must add exactly those). Returns
    ``{"raised": n, "launches": n}``, updated as the run goes."""
    import bigdl_tpu_torch.kernels as K
    from bigdl_tpu_torch.parallel.failure import TransientDeviceError
    fwd, replay = sched._forward, sched._replay_group
    calls, out = [0], {"raised": 0, "launches": 0}

    def forward(model, params, kv, tokens, positions, tables):
        res = fwd(model, params, kv, tokens, positions, tables)
        calls[0] += 1
        if hit(calls[0], int(tokens.shape[1])):
            out["raised"] += 1
            raise TransientDeviceError(f"after the page write, call "
                                       f"{calls[0]}")
        return res

    def replay_group(stage, rows, fn):
        def unit():
            k0 = K.launch_counts()["paged_attention"]
            try:
                return fn()
            except BaseException:
                out["launches"] += K.launch_counts()["paged_attention"] - k0
                raise
        return replay(stage, rows, unit)

    sched._forward, sched._replay_group = forward, replay_group
    return out


def replay_drill(torch, K, model, prompts, budgets, sk, plan, hit, **kw):
    """One fault-free and one faulted run of the same requests on fresh
    schedulers: the faulted one with ``plan`` armed and faults raised
    after the page write where ``hit`` says (``fault_after_write``).
    Tokens and every prompt's resident chain must be bit for bit equal,
    ``step_replays`` the chaos fires plus the post-write faults, K2 on
    ``f32_split`` only, and the faulted run's K2 launches the clean run's
    plus those of its failed units."""
    from bigdl_tpu_torch.parallel import chaos
    from bigdl_tpu_torch.parallel.failure import FaultPolicy
    from bigdl_tpu_torch.serving import DecodeScheduler
    out = {}
    for name in ("clean", "faulted"):
        sched = DecodeScheduler(model, max_seq_len=512, fault_policy=FaultPolicy(
            max_restarts=2, backoff_base_s=0.0), **sk, **kw)
        box = {"faults": {"raised": 0, "launches": 0}}

        def prepare():
            chaos.arm(plan)
            box["faults"] = fault_after_write(sched, hit)
        res, wall = submit_all(sched, prompts, budgets,
                               prepare if name == "faulted" else None)
        n_k2 = path_counts(torch, K, f"(a) {name}")
        fired = chaos.stats().get("fires", 0)
        chaos.disarm()
        chains = [resident_chain(torch, sched, p)[1] for p in prompts]
        st = sched.stats()
        sched.shutdown()
        check(sched.stats()["kv"]["blocks_in_use"] == 0
              and sched.audit()["ok"], f"(a) {name}: {sched.stats()['kv']}")
        out[name] = dict(tokens=res, wall=wall, k2=n_k2,
                         extra=box["faults"]["launches"],
                         raised=box["faults"]["raised"], fired=fired, st=st,
                         chains=chains)
    c, f = out["clean"], out["faulted"]
    check(all(np.array_equal(a, b) for a, b in zip(c["tokens"],
                                                  f["tokens"])),
          "(a) replayed tokens differ from the fault-free run's")
    check(all(same_pages(a, b) for a, b in zip(c["chains"], f["chains"]))
          and sum(len(ch[0][0]) for ch in c["chains"]) > 0,
          "(a) a resident chain's pages differ after the replays")
    check(f["raised"] > 0
          and f["st"]["step_replays"] == f["fired"] + f["raised"],
          f"(a) step_replays {f['st']['step_replays']}, chaos fires "
          f"{f['fired']} + {f['raised']} post-write faults")
    check(f["extra"] > 0 and f["k2"] == c["k2"] + f["extra"],
          f"(a) K2 launches {f['k2']} faulted, {c['k2']} clean, "
          f"{f['extra']} in the failed units")
    return out


def control_plane(torch, K, card):
    """Phase 10: (a) step replay under chaos and after faults past the page
    write, (b) the audit's quarantine, (c) the stall watchdog behind a
    Router with prefix affinity and failover, on the flagship; (d) a
    ServingEngine over ResNet-50; (e) device-memory telemetry; and the
    kernels' no-statistics calls of (d) against their plain versions.
    Returns the readings."""
    import copy
    import tempfile
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.models import ResNet50, TransformerLM
    from bigdl_tpu_torch.models import resnet as resnet_mod
    from bigdl_tpu_torch.observability import health
    from bigdl_tpu_torch.parallel import chaos
    from bigdl_tpu_torch.serving import DecodeScheduler, Router, ServingEngine
    cfg = dict(FLAGSHIP)
    V, L, BS = cfg["vocab_size"], cfg.pop("num_layers"), 16
    sk = dict(max_slots=8, block_size=BS, prefill_chunk=32)
    r10 = {}
    print(f"[10] the serving control plane ({card})", flush=True)
    model = TransformerLM(num_layers=L, seed=0, **cfg).to(torch.bfloat16)
    params = model.params
    rng = np.random.RandomState(10)

    # (a) replay: chaos at serving/prefill and serving/scheduler_step, and
    # two faults raised after a forward wrote its pages
    systems = [rng.randint(1, V, 96).astype(np.int32) for _ in range(3)]
    prompts = [np.concatenate([systems[i % 3], rng.randint(
        1, V, rng.randint(1, 40)).astype(np.int32)]) for i in range(8)]
    budgets = [24] * 8
    plan = {"sites": {
        "serving/prefill": [{"kind": "transient", "nth": 3}],
        "serving/scheduler_step": [{"kind": "transient", "every": 5,
                                    "max_fires": 3}]}}
    a = replay_drill(torch, K, model, prompts, budgets, sk, plan,
                     lambda n, s: n in (7, 40))
    compared = 0
    for p, t in zip(prompts, a["clean"]["tokens"]):
        want, margins = forced_greedy(torch, model, params, p, t)
        compared += agree("(a) clean", t, want, margins)
    # the speculative round: phase 9's accepting pair (the target adds
    # zero past the draft's layer), chaos at serving/spec_round and one
    # fault after a round's verify wrote its pages
    target = copy.deepcopy(model)
    draft = TransformerLM(num_layers=1, seed=1, **cfg).to(torch.bfloat16)
    with torch.no_grad():
        tsd = target.state_dict()
        for k, v in draft.state_dict().items():
            tsd[k].copy_(v)
        for i in range(1, L):
            for k in ("attn.wo", "ffn.w2", "ffn.b2"):
                tsd[f"block{i}.{k}"].zero_()
    splan = {"sites": {"serving/spec_round": [
        {"kind": "transient", "every": 3, "max_fires": 2}]}}
    verifies = [0]

    def second_verify(n, s):
        """The second verify (S = spec_k + 1), after its pages and the
        round's draft pages were written: the replay reruns the round."""
        verifies[0] += s == 5
        return s == 5 and verifies[0] == 2
    sa = replay_drill(torch, K, target, prompts, budgets, sk, splan,
                      second_verify, draft_model=draft, spec_k=4)
    check(sa["faulted"]["st"]["spec_rounds"] > 0, "(a) no speculative round")
    r10["a"] = dict(
        replays=a["faulted"]["st"]["step_replays"],
        fires=a["faulted"]["fired"], k2_clean=a["clean"]["k2"],
        k2_faulted=a["faulted"]["k2"], k2_failed_units=a["faulted"]["extra"],
        wall_clean=a["clean"]["wall"], wall_faulted=a["faulted"]["wall"],
        spec_replays=sa["faulted"]["st"]["step_replays"],
        spec_fires=sa["faulted"]["fired"],
        spec_rounds=sa["faulted"]["st"]["spec_rounds"],
        spec_k2_clean=sa["clean"]["k2"], spec_k2_faulted=sa["faulted"]["k2"],
        spec_k2_failed_units=sa["faulted"]["extra"], compared=compared)
    print(f"    (a) replay: 8 requests (3 system prompts of 96 tokens), 24 "
          f"new tokens each: {r10['a']['fires']} chaos fires + 2 post-write "
          f"faults = {r10['a']['replays']} step replays; tokens and every "
          f"resident chain bit for bit the fault-free run's; K2 launches "
          f"{r10['a']['k2_faulted']} = {r10['a']['k2_clean']} + "
          f"{r10['a']['k2_failed_units']} of the failed units, all "
          f"f32_split (no K1-fwd: the scheduler's chunked prefill runs "
          f"K2); wall {r10['a']['wall_clean']:.2f} s clean, "
          f"{r10['a']['wall_faulted']:.2f} s faulted; tokens equal greedy "
          f"on {compared} steps. Speculative (spec_k 4): "
          f"{r10['a']['spec_fires']} chaos fires + 1 post-write fault "
          f"(after the second verify's write) = "
          f"{r10['a']['spec_replays']} replays in "
          f"{r10['a']['spec_rounds']} rounds, bit for bit; K2 "
          f"{r10['a']['spec_k2_faulted']} = {r10['a']['spec_k2_clean']} + "
          f"{r10['a']['spec_k2_failed_units']}", flush=True)
    del target, draft, a, sa
    torch.cuda.empty_cache()

    # (b) the audit: a refcount corrupted under the running loop
    # (audit_every=1) quarantines the ledger with one health event and one
    # crash bundle; in-flight requests finish, a repeat adopts no prefix
    flight_dir = tempfile.mkdtemp(prefix="bigdl_flight_")
    os.environ["BIGDL_TPU_FLIGHT_DIR"] = flight_dir
    obs.enable()
    events = []
    sched = DecodeScheduler(model, max_seq_len=512, audit_every=1, **sk)
    sched.start()
    with health.listen(events.append):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        futs = [sched.submit(p, 24) for p in prompts[:4]]
        t0 = time.monotonic()
        while sched.stats()["active"] == 0:
            check(time.monotonic() - t0 < 60, "(b) nothing became active")
            time.sleep(0.001)
        with sched.kv._lock:
            phantom = sched.kv._free[0]
            sched.kv._refs[phantom] = 1
        first = [f.result(600) for f in futs]
        rep = sched.submit(prompts[0], 24)
        rep_tokens = rep.result(600)
        n_k2 = path_counts(torch, K, "(b)")
        st = sched.stats()
        with sched.kv._lock:
            sched.kv._refs.pop(phantom)
        sched.shutdown()
    kinds = [e["kind"] for e in events]
    bundles = [n for n in os.listdir(flight_dir) if n.startswith("flight_")]
    check(st["kv_corruptions"] == 1 and st["quarantined"]
          and kinds.count("health/kv_corruption") == 1 and len(bundles) == 1,
          f"(b) corruptions {st['kv_corruptions']} quarantined "
          f"{st['quarantined']} events {kinds} bundles {bundles}")
    check(rep.trace["prefix_hit_tokens"] == 0 and st["completed"] == 5
          and sched.stats()["kv"]["blocks_in_use"] == 0,
          f"(b) repeat hit {rep.trace['prefix_hit_tokens']}, completed "
          f"{st['completed']}, blocks {sched.stats()['kv']}")
    compared = 0
    for p, t in zip(prompts[:4] + [prompts[0]], first + [rep_tokens]):
        want, margins = forced_greedy(torch, model, params, p, t)
        compared += agree("(b)", t, want, margins)
    with open(os.path.join(flight_dir, bundles[0])) as fh:
        bundle = json.load(fh)
    r10["b"] = dict(corruptions=st["kv_corruptions"],
                    quarantined=st["quarantined"], bundles=len(bundles),
                    triaged=len(bundle["context"]["requests"]), k2=n_k2,
                    compared=compared)
    print(f"    (b) audit: one phantom reference under the running loop -> "
          f"kv_corruptions 1, quarantined, 1 health/kv_corruption event, 1 "
          f"crash bundle ({r10['b']['triaged']} requests triaged) in a "
          f"temporary directory; the 4 in-flight requests and the repeat "
          f"finished (repeat adopted 0 prefix tokens); K2 {n_k2}; tokens "
          f"equal greedy on {compared} steps", flush=True)

    # (c) the stall watchdog behind a Router: a 3 s wedge at r1's second
    # decode step silences its beacon (stall_deadline_s=1.0); the router
    # drains r1, its requests finish on r0, r1 rejoins on recovery
    events = []
    reps = [DecodeScheduler(model, max_seq_len=512, name=f"r{i}",
                            stall_deadline_s=1.0, **sk) for i in range(2)]
    router = Router(reps).start()
    with health.listen(events.append):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        sysp = systems[0]
        warm = router.submit(prompts[0], max_new_tokens=16)
        warm_tokens = warm.result(600)
        holder = warm.trace["router"]["replica"]
        check(holder == "r1", f"(c) the first request went to {holder}")
        chaos.arm({"sites": {"serving/scheduler_step": [
            {"kind": "wedge", "nth": 2, "wedge_s": 3.0, "tag": "r1"}]}})
        late = [np.concatenate([sysp, rng.randint(1, V, 8).astype(np.int32)])
                ] + [rng.randint(1, V, rng.randint(20, 120)).astype(np.int32)
                     for _ in range(5)]
        t0 = time.perf_counter()
        futs = [router.submit(p, max_new_tokens=16) for p in late]
        res = [f.result(600) for f in futs]
        wall = time.perf_counter() - t0
        served = [f.trace["router"]["replica"] for f in futs]
        t0 = time.monotonic()
        while router.healthy_replicas() != ["r0", "r1"]:
            check(time.monotonic() - t0 < 60, "(c) r1 never rejoined")
            time.sleep(0.01)
        n_k2 = path_counts(torch, K, "(c)")
        rst = router.stats()
    router.shutdown()
    chaos.disarm()
    stalls = [e for e in events if e["kind"] == "health/stall"]
    check(stalls and stalls[0]["component"] == reps[1].beacon_name
          and any(e["kind"] == "health/stall_recovered"
                  and e["component"] == reps[1].beacon_name for e in events),
          f"(c) health events {[(e['kind'], e.get('component')) for e in events]}")
    check(served == ["r0"] * len(late) and rst["drains"] >= 1
          and rst["failovers"] >= 1 and rst["rejoins"] >= 1
          and rst["affinity_hits"] >= 1,
          f"(c) served by {served}; router stats {rst}")
    compared = 0
    for p, t in zip([prompts[0]] + late, [warm_tokens] + res):
        want, margins = forced_greedy(torch, model, params, p, t)
        compared += agree("(c)", t, want, margins)
    r10["c"] = dict(stall_s=stalls[0]["age_s"], drains=rst["drains"],
                    failovers=rst["failovers"], rejoins=rst["rejoins"],
                    affinity_hits=rst["affinity_hits"], wall=wall, k2=n_k2,
                    compared=compared)
    print(f"    (c) watchdog + router: r1 wedged 3 s at its second decode "
          f"step; health/stall after {r10['c']['stall_s']} s of silence "
          f"(deadline 1.0 s); drains {rst['drains']}, failovers "
          f"{rst['failovers']}, rejoins {rst['rejoins']} (on "
          f"health/stall_recovered), affinity hits {rst['affinity_hits']}; "
          f"the {len(late)} requests all served by r0 in {wall:.2f} s; K2 "
          f"{n_k2}; tokens equal greedy on {compared} steps", flush=True)
    obs.disable()
    health.reset()
    del model, params, reps, router
    torch.cuda.empty_cache()

    # (d) ServingEngine over ResNet-50 (NHWC, fused="pallas", fused_conv2,
    # float32, eval): 64 concurrent requests, one transient fault at
    # serving/engine_dispatch, a hot swap in mid-traffic
    m0 = ResNet50(format="NHWC", fused="pallas", fused_conv2=True,
                  zero_init_residual=False, seed=5).evaluate()
    m1 = ResNet50(format="NHWC", fused="pallas", fused_conv2=True,
                  zero_init_residual=False, seed=6)
    S, NB, NR = IMAGE, ENGINE_BATCH, ENGINE_REQUESTS
    eng = ServingEngine(m0, input_shape=(S, S, 3), max_batch=NB)
    check(eng.device.type == "cuda", f"(d) engine on {eng.device}")
    eng.start()
    stats_seen = []
    spied = {}
    for name in ("fused_bn_relu_matmul_nhwc", "fused_residual_matmul_nhwc",
                 "fused_bn_relu_conv3x3"):
        fn = getattr(resnet_mod, name)

        def spy(*a, _fn=fn, **kw):
            stats_seen.append(kw.get("stats"))
            return _fn(*a, **kw)
        spied[name] = fn
        setattr(resnet_mod, name, spy)
    imgs = [rng.randn(S, S, 3).astype(np.float32) for _ in range(NR)]
    chaos.arm({"sites": {"serving/engine_dispatch": [
        {"kind": "transient", "nth": 2}]}})
    torch.cuda.synchronize()
    K.reset_launch_counts()
    done, t_sub = {}, {}

    def submit(i):
        t_sub[i] = time.perf_counter()
        f = eng.submit(imgs[i])
        f.add_done_callback(lambda _f, i=i: done.__setitem__(
            i, time.perf_counter()))
        return f
    t0 = time.perf_counter()
    futs = [submit(i) for i in range(NR // 2)]
    futs[0].result(600)       # the swap lands while the rest is in flight
    eng.swap(m1.params, m1.state, version="v1")
    futs += [submit(i) for i in range(NR // 2, NR)]
    outs = [f.result(600) for f in futs]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts, routes = K.launch_counts(), K.launches_by_route()
    est = eng.stats()
    eng.shutdown()
    chaos.disarm()
    for name, fn in spied.items():
        setattr(resnet_mod, name, fn)
    nb = est["batches"]
    fused = {"fused_matmul_fwd": 24 * nb, "fused_chain_fwd": 12 * nb,
             "fused_conv_fwd": 16 * nb}
    check(all(only_on(routes[k], "f32_sm90", n) and counts[k] == n
              for k, n in fused.items())
          and not any(v for k, v in counts.items() if k not in fused)
          and stats_seen and not any(stats_seen),
          f"(d) {nb} batches: launches {counts}, routes "
          f"{ {k: routes[k] for k in fused} }, statistics asked "
          f"{sum(bool(s) for s in stats_seen)} of {len(stats_seen)} calls")
    check(est["transient_retries"] == 1 and est["completed"] == NR
          and est["swaps"] == 1 and est["batch_errors"] == 0,
          f"(d) engine stats {est}")
    vers = [f.version for f in futs]
    check(vers[0] == "v0" and set(vers[NR // 2:]) == {"v1"}
          and set(vers) <= {"v0", "v1"}, f"(d) versions {vers}")
    # each batch again, directly: apply(training=False) of its version on
    # the same padded bucket, bit for bit; one bucket also on the CPU
    batches = {}
    for i, f in enumerate(futs):
        t = f.trace
        batches.setdefault((t["version"], t["dispatch_ms"], t["bucket"]),
                           []).append(i)
    check(sum(len(v) for v in batches.values()) == NR
          and len(batches) == nb, f"(d) {nb} batches, {len(batches)} found")
    models = {"v0": m0, "v1": m1}
    worst_cpu = None
    for (ver, _, bucket), rows in batches.items():
        x = np.zeros((bucket, S, S, 3), np.float32)
        x[:len(rows)] = np.stack([imgs[i] for i in rows])
        m = models[ver]
        with torch.inference_mode():
            direct = m.apply(m.params, m.state, torch.from_numpy(x).cuda(),
                             training=False)[0].cpu()
        check(all(torch.equal(torch.from_numpy(outs[i]), direct[j])
                  for j, i in enumerate(rows)),
              f"(d) a {ver} batch of {len(rows)} differs from its direct "
              f"apply on the padded bucket")
        if worst_cpu is None:
            cpu = ResNet50(format="NHWC", fused="pallas", fused_conv2=True,
                           zero_init_residual=False, device="cpu")
            cpu.load_state_dict({k: v.cpu() for k, v in
                                 m.state_dict().items()})
            with torch.inference_mode():
                want = cpu.apply(cpu.params, cpu.state, torch.from_numpy(x),
                                 training=False)[0]
            worst_cpu = _rel_err(direct, want)
            check(worst_cpu <= 1e-4, f"(d) the card's logits off the CPU's "
                  f"plain path by {worst_cpu:.3g}")
            del cpu
    lat = sorted((done[i] - t_sub[i]) * 1e3 for i in range(NR))
    r10["d"] = dict(batches=nb, images_per_s=NR / wall,
                    p50_ms=statistics.median(lat),
                    p99_ms=lat[int(round(0.99 * (NR - 1)))],
                    cpu_rel_err=worst_cpu, launches=dict(fused))
    print(f"    (d) ServingEngine ResNet-50 float32 eval, {S}x{S}, max_batch "
          f"{NB}: {NR} requests in {nb} batches, 1 transient retry, a swap to v1 "
          f"mid-traffic; every row bit for bit its version's direct apply "
          f"on the padded bucket, one bucket within {worst_cpu:.3g} of the "
          f"CPU plain path; launches {fused} on f32_sm90 without "
          f"statistics. Smoke readings, not benchmark cells: "
          f"{r10['d']['images_per_s']:.1f} images/s, latency p50 "
          f"{r10['d']['p50_ms']:.1f} ms, p99 {r10['d']['p99_ms']:.1f} ms",
          flush=True)
    del m0, m1, eng
    torch.cuda.empty_cache()

    # (e) device-memory telemetry from torch.cuda.memory_stats
    mem = health.sample_device_memory()
    check(health.memory_stats_available() and mem is not None
          and mem["live_bytes"] > 0, f"(e) memory telemetry {mem}")
    r10["e"] = mem
    print(f"    (e) memory telemetry: {mem}", flush=True)
    # the kernels' no-statistics calls of (d), at their stage-0 B32 shapes
    r10["eval"] = {k: eval_case(torch, K, k) for k in ("K3", "K4", "K5")}
    return r10


# -- phase 11: generation depth: beam search and the translation model -----------

# Transformer "base" of Vaswani et al. 2017, Table 3 (N = 6, d_model 512,
# 8 heads, d_ff 2048) with the 37000 shared BPE vocabulary of WMT14 En-De
# (section 5.1); max_len 256
TRANSLATION = dict(vocab_size=37000, hidden_size=512, num_heads=8,
                   filter_size=2048, num_hidden_layers=6, mode="translation",
                   max_len=256)
# (b): training batch, source / target lengths, held-out pairs, decode shape
TR_BATCH, TR_LENGTHS, TR_HELD, TR_ITERS = 64, (16, 64), 128, 4
DEC_BATCH, DEC_SRC, DEC_NEW, BEAM = 8, 64, 64, 4
# (c): the model tolerance of the port's parity tests, relative to the
# largest logit
CPU_TOL = 1e-4


def pair_samples(rng, n, V, lengths):
    """Synthetic translation pairs: Sample([src, tgt_in], tgt_out) with
    source and target lengths drawn in ``lengths`` and ids in 1..V-1 (0 is
    padding); the label is the target shifted by one."""
    from bigdl_tpu_torch.dataset import Sample
    lo, hi = lengths
    out = []
    for _ in range(n):
        src = rng.randint(1, V, rng.randint(lo, hi + 1)).astype(np.int32)
        tgt = rng.randint(1, V, rng.randint(lo, hi + 1) + 1).astype(np.int32)
        out.append(Sample([src, tgt[:-1]], tgt[1:]))
    return out


def block_index(key):
    """The layer of a ``block{i}.`` / ``enc_block{i}.`` state_dict key; -1
    for the embedding and the final LayerNorm."""
    m = re.match(r"(?:enc_)?block(\d+)\.", key)
    return int(m.group(1)) if m else -1


def no_launches(K, what):
    counts = K.launch_counts()
    check(not any(counts.values()), f"{what} launched kernels {counts}; the "
          f"translation mode runs the masked einsum only, as in JAX")


def greedy_margins(torch, model, params, src, n):
    """Greedy translation through ``decode_one`` with each step's top-2
    logit margin (the smallest over the batch), as float32 host values."""
    enc, mask = model._encode_src(params, model._ids(src))
    cross = [b.cross_kv(params[f"block{i}"], enc)
             for i, b in enumerate(model.blocks)]
    caches = model.init_cache(src.shape[0], n + 1, enc.dtype)
    tok = torch.ones(src.shape[0], dtype=torch.long, device=model.device)
    toks, margins = [], []
    for pos in range(n):
        logits, caches = model.decode_one(params, tok, pos, caches, cross,
                                          mask)
        top = logits.float().topk(2, -1).values
        margins.append(float((top[:, 0] - top[:, 1]).min()))
        tok = logits.argmax(-1)
        toks.append(tok.cpu())
    return torch.stack(toks, 1), margins


def generation_depth(torch, K, card):
    """Phase 11: (a) ``generate_beam`` on the flagship (bf16 weights); (b)
    the Transformer-base translation model trained through
    ``LocalOptimizer`` on padded Table batches with validation, then
    ``translate`` / ``translate_beam``; (c) the translation model's
    logits and greedy tokens on the card against the CPU. Returns the
    readings."""
    from bigdl_tpu_torch.dataset import DataSet, PaddingParam, ShardedDataSet
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import (CrossEntropyCriterion, Transformer,
                                    TimeDistributedMaskCriterion)
    from bigdl_tpu_torch.optim import (SGD, Loss, LocalOptimizer,
                                       Top1Accuracy, Trigger, max_iteration,
                                       several_iteration)
    from bigdl_tpu_torch.utils.table import Table
    r11 = {}
    print(f"[11] generation depth: beam search and the translation model "
          f"({card})", flush=True)

    # (a) generate_beam on the flagship: one prefill on the un-repeated
    # batch (12 flash launches), then dense beam decode steps (no kernel)
    cfg = dict(FLAGSHIP)
    L = cfg.pop("num_layers")
    V = cfg["vocab_size"]
    B, TP, NEW = 8, 128, 32
    t0 = time.perf_counter()
    model = TransformerLM(num_layers=L, seed=0, **cfg).to(torch.bfloat16)
    params = model.params
    build_s = time.perf_counter() - t0
    prompt = np.random.RandomState(11).randint(1, V, (B, TP)) \
        .astype(np.int32)
    model.generate_beam(params, prompt[:, :16], 2, beam_size=BEAM)  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate_beam(params, prompt, NEW, beam_size=BEAM)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, routes = K.launch_counts(), K.launches_by_route()
    want = dict.fromkeys(K.WRAPPERS, 0)
    want["flash_fwd"] = L
    check(counts == want, f"(a) generate_beam launched {counts}, expected "
          f"{want}")
    check(only_on(routes["flash_fwd"], "bf16_sm90", L),
          f"(a) generate_beam's flash launches by route {routes}")
    check(tuple(out.shape) == (B, TP + NEW), f"(a) shape {out.shape}")
    check(bool(((out >= 0) & (out < V)).all()), "(a) ids out of range")
    check(torch.equal(out[:, :TP].cpu(), torch.from_numpy(prompt).long()),
          "(a) generate_beam: prompt not preserved")
    greedy = model.generate(params, prompt, NEW)
    beam1 = model.generate_beam(params, prompt, NEW, beam_size=1)
    check(torch.equal(beam1, greedy), "(a) generate_beam(beam_size=1) is "
          "not generate's greedy tokens")
    r11["beam_flash"] = counts["flash_fwd"]
    r11["beam_tokens_s"] = B * NEW / dt
    print(f"    (a) generate_beam: flagship built in {build_s:.1f} s; "
          f"{B}x{NEW} new tokens, beam {BEAM}, prompt {TP}: {dt:.3f} s = "
          f"{r11['beam_tokens_s']:.1f} tokens/s (prefill included); "
          f"launches {counts}; beam_size=1 == generate, token for token",
          flush=True)
    del model, params, out, greedy, beam1
    torch.cuda.empty_cache()

    # (b) Transformer-base: LocalOptimizer on padded Table batches, float32
    V = TRANSLATION["vocab_size"]
    t0 = time.perf_counter()
    tr = Transformer(seed=0, **TRANSLATION)
    n_params = sum(p.numel() for p in tr.parameters())
    init = {k: v.detach().cpu().clone() for k, v in tr.state_dict().items()}
    rng = np.random.RandomState(12)
    batch = pair_samples(rng, TR_BATCH, V, TR_LENGTHS)   # one batch, again
    held = pair_samples(rng, TR_HELD, V, TR_LENGTHS)
    pad = PaddingParam(0)
    train = ShardedDataSet(DataSet.array(batch), TR_BATCH,
                           feature_padding=pad, label_padding=pad)
    crit = TimeDistributedMaskCriterion(CrossEntropyCriterion(),
                                        padding_value=0)
    methods = [Loss(crit), Top1Accuracy()]
    losses = {}
    stop = max_iteration(TR_ITERS)

    def record_and_stop(st):    # asked after each step and at epoch ends
        losses[st["neval"]] = st["loss"]
        return stop(st)
    end = Trigger(record_and_stop)
    opt = LocalOptimizer(tr, train, crit, SGD(learningrate=0.1,
                                              momentum=0.9),
                         end, batch_size=TR_BATCH)
    opt.set_validation(several_iteration(2), held, methods)
    print(f"    (b) Transformer-base translation: {n_params / 1e6:.1f}M "
          f"params, float32, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    no_launches(K, "(b) translation training")
    peak = torch.cuda.max_memory_allocated()
    st = opt.optim_method.state
    loss = [losses[i] for i in sorted(losses)]
    check(len(loss) == TR_ITERS and all(math.isfinite(v) for v in loss)
          and loss[-1] < loss[0], f"(b) losses {loss}: not finite and "
          f"falling on one repeated batch")
    check("score" in st and math.isfinite(st["score"]),
          f"(b) validation wrote no finite state['score']: {st}")
    step_ms = [s * 1e3 for s in opt.metrics.values["step_time"]]
    # target tokens the loss counts a step (the batch's non-pad labels),
    # over the median step after the first
    n_tgt = sum(int(smp.labels[0].size) for smp in batch)
    train_tokens_s = n_tgt / (statistics.median(step_ms[1:]) / 1e3)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    val = tr.evaluate_dataset(DataSet.array(held), methods, TR_BATCH)
    val_s = time.perf_counter() - t0
    no_launches(K, "(b) validation")
    val = {repr(m): r.result()[0] for m, r in zip(methods, val)}
    check(all(math.isfinite(v) for v in val.values())
          and 0.0 <= val["Top1Accuracy"] <= 1.0, f"(b) validation {val}")
    r11.update(losses=loss, step_ms=step_ms, val_ms=val_s * 1e3,
               score=st["score"], peak_gb=peak / 1e9, val=val,
               train_tokens_s=train_tokens_s)
    print(f"    (b) LocalOptimizer B{TR_BATCH}, lengths {TR_LENGTHS}: "
          f"losses {loss}; step ms {[round(s, 3) for s in step_ms]} "
          f"({train_tokens_s:.0f} target tokens/s at the median after the "
          f"first, {n_tgt} a step); "
          f"{train_s:.3f} s with validation on {TR_HELD} pairs every 2 "
          f"iterations; "
          f"validation alone {val_s * 1e3:.1f} ms ({val}); state['score'] "
          f"{st['score']:.6g}; peak {peak / 1e9:.2f} GB; no kernel "
          f"launched", flush=True)

    # decode: greedy and beam at batch 8, source 64, 64 new tokens
    tr.evaluate()
    p = tr.params
    src = np.random.RandomState(13).randint(1, V, (DEC_BATCH, DEC_SRC)) \
        .astype(np.int32)
    src[1::2, DEC_SRC // 2:] = 0                     # padded rows
    tr.translate(p, src[:, :8], 2)
    tr.translate_beam(p, src[:, :8], 2, beam_size=BEAM)      # warm-up
    rates = {}
    K.reset_launch_counts()
    for name, fn in (("translate", lambda: tr.translate(p, src, DEC_NEW)),
                     ("translate_beam", lambda: tr.translate_beam(
                         p, src, DEC_NEW, beam_size=BEAM))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = fn()
        torch.cuda.synchronize()
        rates[name] = DEC_BATCH * DEC_NEW / (time.perf_counter() - t0)
        check(tuple(ids.shape) == (DEC_BATCH, DEC_NEW)
              and bool(((ids >= 0) & (ids < V)).all()),
              f"(b) {name}: shape {ids.shape} or ids out of range")
    no_launches(K, "(b) translate / translate_beam")
    check(torch.equal(tr.translate_beam(p, src, DEC_NEW, beam_size=1),
                      tr.translate(p, src, DEC_NEW)),
          "(b) translate_beam(beam_size=1) is not translate, bit for bit")
    r11["decode_tokens_s"] = rates
    print(f"    (b) batch {DEC_BATCH}, source {DEC_SRC}, {DEC_NEW} new "
          f"tokens: translate {rates['translate']:.1f} tokens/s, "
          f"translate_beam (beam {BEAM}) {rates['translate_beam']:.1f} "
          f"tokens/s; beam_size=1 == translate, bit for bit", flush=True)
    del tr, opt, p
    torch.cuda.empty_cache()

    # (c) the same weights cut to 2 layers, full width, float32: the card
    # against the CPU
    cut = dict(TRANSLATION, num_hidden_layers=2)
    keep = {k: v for k, v in init.items() if block_index(k) < 2}
    cpu = Transformer(device="cpu", **cut)
    cpu.load_state_dict(keep)
    gpu = Transformer(**cut)
    gpu.load_state_dict(keep)
    rng = np.random.RandomState(14)
    src = rng.randint(1, V, (2, 24)).astype(np.int32)
    src[1, 17:] = 0
    tgt = rng.randint(1, V, (2, 16)).astype(np.int32)
    with torch.no_grad():
        want = cpu.call(cpu.params, Table(src, tgt))
        got = gpu.call(gpu.params, Table(src, tgt)).cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= CPU_TOL * scale, f"(c) card logits {err:.3g} from the "
          f"CPU's (largest |logit| {scale:.3g}, tolerance {CPU_TOL} of it)")
    n = 16
    tc, margins = greedy_margins(torch, cpu, cpu.params, src, n)
    tg, _ = greedy_margins(torch, gpu, gpu.params, src, n)
    low = [i for i, m in enumerate(margins) if m < CPU_TOL * scale]
    trusted = low[0] + 1 if low else n
    check(torch.equal(tg[:, :trusted], tc[:, :trusted]),
          f"(c) greedy tokens differ before the first near-tie (step "
          f"{trusted}): card {tg.tolist()}, CPU {tc.tolist()}")
    check(torch.equal(gpu.translate(gpu.params, src, n).cpu(),
                      tg), "(c) translate is not its own decode_one loop")
    r11["cpu"] = {"max_abs_err": err, "scale": scale, "trusted": trusted}
    print(f"    (c) 2 layers, full width, float32: logits max |card - CPU| "
          f"{err:.3g} (largest |logit| {scale:.3g}, tolerance "
          f"{CPU_TOL * scale:.3g}); greedy tokens equal for {trusted} of "
          f"{n} steps (up to the first top-2 margin under the tolerance)",
          flush=True)
    return r11


# -- phase 12: the training loop's depth ---------------------------------------

LOOP_B, LOOP_N, LOOP_S = 32, 256, 224     # 8 batches of B32/224 images


class FixedBatches:
    """A batch-level data set of fixed MiniBatches in a fixed order (what
    ``Optimizer`` takes beside Sample data sets): the epoch's tail for a
    resume, a NaN image at a known iteration."""

    def __init__(self, mbs):
        self.mbs = list(mbs)

    def size(self):
        return sum(len(m.get_input()) for m in self.mbs)

    def batches_per_epoch(self):
        return len(self.mbs)

    def shuffle(self):
        return self

    def data(self, train=True):
        return iter(self.mbs)


def host_trees(model, opt_state=None):
    """Host copies of a model's parameters and state (and an optimizer
    state tree)."""
    from bigdl_tpu_torch.convert import host_copy_tree
    out = {"params": host_copy_tree(model.params),
           "model_state": host_copy_tree(model.state)}
    if opt_state is not None:
        out["opt_state"] = opt_state
    return out


def tree_diff(a, b):
    """Largest absolute difference between two host trees of one
    structure (0.0: bit for bit equal)."""
    from bigdl_tpu_torch.convert import flatten
    fa, fb = flatten(a), flatten(b)
    if set(fa) != set(fb):
        return float("inf")
    return max([float(np.max(np.abs(np.asarray(fa[k], np.float64)
                                    - np.asarray(fb[k], np.float64))))
                for k in fa if np.size(fa[k])] + [0.0])


def loop_run(torch, K, model, init, data, iters, method=None, setup=None,
             dev="cuda"):
    """Load ``init`` into ``model``, train it through ``Optimizer.create``
    (CrossEntropyCriterion, SGD(0.1, momentum=0.9) unless ``method``)
    for ``iters`` iterations after ``setup(opt)``, with the launch
    counters set to 0 just before and read just after. Returns the
    optimizer and the readings: every step's loss (the device tensors
    the step returns, read after the run), wall time, launches, routes,
    checkpoint submit times and the observability counters."""
    import bigdl_tpu_torch.observability as obs
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    model.load_state_dict(init)
    opt = Optimizer.create(model, data, CrossEntropyCriterion(),
                           max_iteration(iters), LOOP_B,
                           method or SGD(0.1, momentum=0.9), device=dev)
    opt.set_prefetch(0)
    losses, ckpt_s = [], []
    step, ckpt = opt._step, opt._checkpoint
    opt._step = lambda *a: losses.append(step(*a)) or losses[-1]

    def timed_checkpoint(*a, **kw):
        t0 = time.perf_counter()
        path = ckpt(*a, **kw)
        ckpt_s.append((path, time.perf_counter() - t0))
        return path
    opt._checkpoint = timed_checkpoint
    if setup is not None:
        setup(opt)
    obs.enable()
    obs.registry().reset()
    try:
        if dev == "cuda":
            torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        opt.optimize()
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routes = K.launch_counts(), K.launches_by_route()
        reg = obs.registry()
        syncs = reg.counter("optim/loss_syncs").value
    finally:
        obs.disable()
        obs.registry().reset()
    return opt, {"losses": [float(v) for v in losses], "wall_s": wall,
                 "counts": counts, "routes": routes, "loss_syncs": syncs,
                 "step_s": opt.metrics.values.get("step_time", []),
                 "data_s": opt.metrics.values.get("data_time", []),
                 "checkpoints": ckpt_s}


def resnet_launches(K, n, conv2=False):
    """The launch counts ``n`` ResNet-50 float32 training steps make: 24
    K3 and 12 K5 forwards and as many backwards (16 K4 forwards with
    ``fused_conv2``), nothing else."""
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(fused_matmul_fwd=24 * n, fused_matmul_bwd=24 * n,
                fused_chain_fwd=12 * n, fused_chain_bwd=12 * n)
    if conv2:
        want["fused_conv_fwd"] = 16 * n
    return want


def check_resnet_launches(K, r, n, what, conv2=False):
    want = resnet_launches(K, n, conv2)
    check(r["counts"] == want, f"{what} launched {r['counts']}, expected "
          f"{want}")
    for name, cnt in want.items():
        if cnt:
            check(only_on(r["routes"][name], "f32_sm90", cnt),
                  f"{what} {name} launches by route {r['routes'][name]}")


def loop_depth(torch, K, card, S=LOOP_S, dev="cuda", tmp=None):
    """Phase 12: ResNet-50 (NHWC, ``fused="pallas"``, float32) trained
    through ``Optimizer.create`` with the training loop's depth: (a) the
    reference run twice, (b) prefetch / window / superstep / async
    checkpoints, (c) a resume, (d) 'resume' on a NaN, (e) frozen stem and
    first stage (and ``fused_conv2``), (f) the new optim methods, (g)
    regularizers card against CPU. Returns the readings."""
    import tempfile
    from bigdl_tpu_torch.convert import flatten, host_copy_tree, unflatten
    from bigdl_tpu_torch.dataset import (DataSet, MiniBatch, Sample,
                                         ShardedDataSet)
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn.module import copy_tree_into
    from bigdl_tpu_torch.optim import (SGD, Adadelta, Adagrad, Adamax, Ftrl,
                                       L1L2Regularizer, L2Regularizer,
                                       LarsSGD, ParallelAdam, Plateau,
                                       RMSprop, several_iteration)
    from bigdl_tpu_torch.optim.staging import stager_threads_alive
    r12 = {}
    print(f"[12] the training loop's depth: ResNet-50 B{LOOP_B}/{S} float32 "
          f"through Optimizer.create, 8 batches ({card})", flush=True)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    tmp = tmp or tempfile.mkdtemp(prefix="loop_depth_")
    try:
        model = ResNet50(format="NHWC", fused="pallas", seed=0, device=dev)
        init = {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}
        rng = np.random.RandomState(12)
        imgs = rng.randn(LOOP_N, S, S, 3).astype(np.float32)
        labels = rng.randint(1, 1001, size=LOOP_N)
        samples = [Sample(imgs[i], labels[i]) for i in range(LOOP_N)]
        epoch = ShardedDataSet(DataSet.array(samples), LOOP_B).shuffle()
        mbs = list(epoch.data(train=True))      # the epoch's batches

        # (a) the reference, twice: the determinism control
        def ref_setup(opt, d):
            opt.set_checkpoint(several_iteration(4), d, overwrite=False)
        runs = []
        for i in range(2):
            d = os.path.join(tmp, f"a{i}")
            opt, r = loop_run(torch, K, model, init,
                              DataSet.array(samples), 8,
                              setup=lambda o, d=d: ref_setup(o, d), dev=dev)
            r["end"] = host_trees(model)
            r["dir"] = d
            check(len(r["losses"]) == 8 and all(
                math.isfinite(v) for v in r["losses"]),
                f"(a) losses {r['losses']}")
            check(r["loss_syncs"] == 8, f"(a) loss syncs {r['loss_syncs']}")
            check_resnet_launches(K, r, 8, "(a)")
            runs.append(r)
        a = runs[0]
        spread = max(tree_diff(runs[0]["end"], runs[1]["end"]),
                     max(abs(x - y) for x, y in zip(runs[0]["losses"],
                                                    runs[1]["losses"])))
        r12["spread"] = spread
        culprit = None
        if spread > 0:
            # name the op with no deterministic implementation
            prev = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True)
            try:
                loop_run(torch, K, model, init, FixedBatches(mbs[:1]), 1,
                         dev=dev)
            except RuntimeError as e:
                culprit = str(e).splitlines()[0]
            finally:
                torch.use_deterministic_algorithms(prev)
        r12["culprit"] = culprit
        tol = 4 * spread
        print(f"    (a) reference twice: losses "
              f"{[round(v, 5) for v in a['losses']]}; the two runs "
              + ("bit for bit equal" if spread == 0 else
                 f"differ by up to {spread:.3g} (the op: {culprit}); the "
                 f"other runs are held to {tol:.3g}"), flush=True)

        def same(x, y, what):
            d = tree_diff(x, y)
            check(d <= tol, f"{what}: differs by {d:.3g} (control "
                  f"{spread:.3g})")
            return d

        def ckpt(d, n, e=1):
            with open(os.path.join(d, f"checkpoint_e{e}_i{n}.bigdl"),
                      "rb") as f:
                return pickle.load(f)

        # (b) the loop's options on
        db = os.path.join(tmp, "b")

        def opts(o):
            o.set_prefetch(2)
            o.set_sync_policy("window:4")
            o.set_superstep(4)
            o.set_checkpoint(several_iteration(4), db, overwrite=False,
                             async_write=True)
        _, b = loop_run(torch, K, model, init, DataSet.array(samples), 8,
                        setup=opts, dev=dev)
        b["end"] = host_trees(model)
        same(b["end"], a["end"], "(b) end state against (a)")
        check(max(abs(x - y) for x, y in zip(b["losses"], a["losses"]))
              <= tol, f"(b) losses {b['losses']} against {a['losses']}")
        for n in (4, 8):
            pa, pb = ckpt(a["dir"], n), ckpt(db, n)
            for part in ("params", "opt_state", "model_state"):
                same(pb[part], pa[part], f"(b) checkpoint i{n} {part}")
        check(b["loss_syncs"] == 2, f"(b) loss syncs {b['loss_syncs']}")
        check(b["counts"] == a["counts"], f"(b) launches {b['counts']}")
        check_resnet_launches(K, b, 8, "(b)")
        check(stager_threads_alive() == 0, "(b) left a stager thread")
        a_opt_end = ckpt(a["dir"], 8)["opt_state"]

        # timing arms, no checkpoints: (a) with cuDNN's default algorithms
        # (the cost of determinism), and (b) with its groups stacked
        # inline (the stager thread's share of (b)'s step)
        torch.backends.cudnn.deterministic = False
        _, a_fast = loop_run(torch, K, model, init, DataSet.array(samples), 8,
                             dev=dev)
        torch.backends.cudnn.deterministic = True
        check_resnet_launches(K, a_fast, 8, "(a) with cuDNN's defaults")

        def inline(o):
            o.set_sync_policy("window:4")
            o.set_superstep(4)
        _, b_inline = loop_run(torch, K, model, init, DataSet.array(samples),
                               8, setup=inline, dev=dev)
        same(host_trees(model), a["end"], "(b) stacked inline, end state")
        check_resnet_launches(K, b_inline, 8, "(b) stacked inline")

        # (c) resume from (a)'s iteration-4 checkpoint: the loop restarts
        # its epoch, so the data set is the epoch's other four batches
        def resume(o):
            o.load_checkpoint(os.path.join(a["dir"],
                                           "checkpoint_e1_i4.bigdl"))
            o.set_checkpoint(several_iteration(4), os.path.join(tmp, "c"),
                             overwrite=False)
        _, c = loop_run(torch, K, model, init, FixedBatches(mbs[4:]),
                        8, setup=resume, dev=dev)
        same(host_trees(model), a["end"], "(c) resumed end state")
        same(ckpt(os.path.join(tmp, "c"), 8)["opt_state"], a_opt_end,
             "(c) resumed optimizer state")
        check_resnet_launches(K, c, 4, "(c)")

        # (d) 'resume' on a NaN image in batch 6
        poisoned = [MiniBatch(m.get_input().copy(), m.get_target())
                    for m in mbs]
        poisoned[5].get_input()[0, 0, 0, 0] = np.nan
        dd, restored = os.path.join(tmp, "d"), []

        def nan_resume(o):
            ref_setup(o, dd)
            o.set_nan_policy("resume")
            restore = o._restore_step_state

            def spy(payload, params, opt_state, mstate):
                restore(payload, params, opt_state, mstate)
                restored.append(host_trees(o.model,
                                           host_copy_tree(opt_state)))
            o._restore_step_state = spy
        dopt, dr = loop_run(torch, K, model, init, FixedBatches(poisoned), 8,
                            setup=nan_resume, dev=dev)
        state = dopt.optim_method.state
        check(len(dopt.metrics.values.get("nan_resumes", [])) == 1,
              f"(d) nan resumes {dopt.metrics.values.get('nan_resumes')}")
        check(len(restored) == 1, f"(d) restores {len(restored)}")
        i4 = ckpt(dd, 4)
        for part in ("params", "opt_state", "model_state"):
            check(tree_diff(restored[0][part], i4[part]) == 0,
                  f"(d) state after the restore: {part} is not the "
                  f"iteration-4 checkpoint's")
        check(math.isfinite(state["loss"]), f"(d) loss {state['loss']}")
        check((state["neval"], state["epoch"]) == (8, 2),
              f"(d) neval / epoch {state['neval']} / {state['epoch']}, "
              f"expected 8 / 2 (the CPU test's schedule)")
        check_resnet_launches(K, dr, 10, "(d)")
        print(f"    (b) prefetch 2, window:4, superstep 4, async "
              f"checkpoints: end state and checkpoints within {tol:.3g} of "
              f"(a), loss syncs {b['loss_syncs']:.0f} against "
              f"{a['loss_syncs']:.0f}; (c) resumed from (a)'s iteration 4: "
              f"end state as (a)'s; (d) 'resume' on a NaN in batch 6: 1 "
              f"restore to the iteration-4 checkpoint, neval / epoch "
              f"{state['neval']} / {state['epoch']}, loss "
              f"{state['loss']:.5f}", flush=True)

        # (e) fine-tuning: stem and first stage frozen
        e_counts = {}
        for conv2 in (False, True):
            m = model if not conv2 else ResNet50(
                format="NHWC", fused="pallas", seed=0, device=dev,
                fused_conv2=True)
            m.freeze(m[0].name, m[1].name, m[4].name)
            _, e = loop_run(torch, K, m, init, FixedBatches(mbs[:2]), 2,
                            dev=dev)
            got = flatten(host_trees(m)["params"])
            start = flatten({k: v.numpy() for k, v in init.items()})
            moved = {k for k, v in got.items()
                     if not np.array_equal(v, start[k])}
            # every frozen leaf keeps its bits; every other module with
            # parameters moves (a leaf alone may not: BN3's zero gamma
            # scales its block's first gradients to below a float32 ulp
            # of the other gammas' 1.0)
            check(not {k for k in moved
                       if k.split(".")[0] in ("0", "1", "4")},
                  f"(e) fused_conv2={conv2}: frozen leaves moved")
            check({k.split(".")[0] for k in moved} == {"5", "6", "7", "10"},
                  f"(e) fused_conv2={conv2}: modules moved "
                  f"{sorted({k.split('.')[0] for k in moved})}")
            check_resnet_launches(K, e, 2, f"(e) fused_conv2={conv2}",
                                  conv2)
            e_counts[conv2] = e["counts"]
            m.unfreeze()
            if conv2:
                del m
        print(f"    (e) stem and stage 1 frozen, 2 iterations: frozen "
              f"parameters bit for bit unchanged, the others moved; "
              f"launches {e_counts[False]}, with fused_conv2 "
              f"{e_counts[True]}", flush=True)

        # (f) the new optim methods: 2 iterations each, then one update on
        # ResNet-50's parameter tree on the card against the CPU
        methods = {
            "Adagrad": lambda: Adagrad(0.01), "Adadelta": lambda: Adadelta(),
            "Adamax": lambda: Adamax(0.002), "RMSprop": lambda: RMSprop(1e-3),
            "Ftrl": lambda: Ftrl(0.01, l1_regularization_strength=1e-4,
                                 l2_regularization_strength=1e-4),
            "LarsSGD": lambda: LarsSGD(0.1, 0.001),
            "ParallelAdam": lambda: ParallelAdam(1e-3),
            "SGD+Plateau": lambda: SGD(0.1, momentum=0.9,
                                       learningrate_schedule=Plateau("loss"))}
        grng = np.random.RandomState(7)
        shapes = {k: tuple(v.shape) for k, v in flatten(model.params).items()}
        grads = {k: (1e-2 * grng.randn(*s)).astype(np.float32)
                 for k, s in shapes.items()}
        f_out = {}
        start = unflatten({k: init[k].numpy() for k in shapes})
        for name, make in methods.items():
            _, f = loop_run(torch, K, model, init, FixedBatches(mbs[:2]), 2,
                            method=make(), dev=dev)
            check(all(math.isfinite(v) for v in f["losses"]),
                  f"(f) {name} losses {f['losses']}")
            check(tree_diff(host_trees(model)["params"], start) > 0,
                  f"(f) {name} left the parameters where they were")
            errs = []
            outs = {}
            for where in (dev, "cpu"):
                p = unflatten({k: init[k].to(where).clone() for k in shapes})
                g = unflatten({k: torch.from_numpy(v).to(where)
                               for k, v in grads.items()})
                meth = make()
                st = meth.init_state(p)
                meth.update(g, p, st, 0.05)
                outs[where] = flatten(p)
            for k, v in outs["cpu"].items():
                ref = float(v.abs().max()) or 1.0
                errs.append((float((outs[dev][k].cpu() - v).abs().max())
                             / ref, k))
            bad = [e for e in errs if not e[0] <= 1e-6]    # NaN included
            worst, leaf = bad[0] if bad else max(errs)
            f_out[name] = {"losses": f["losses"], "rel_err": worst}
            check(not bad, f"(f) {name} update on the card against "
                  f"the CPU: relative error {worst:.3g} at leaf {leaf}, "
                  f"first differing elements (index, card, CPU) "
                  f"{_first_diffs(torch, outs[dev][leaf].cpu(), outs['cpu'][leaf])}"
                  f", its start {init[leaf].flatten()[:4].tolist()} and "
                  f"gradient {grads[leaf].flatten()[:4].tolist()}")
        print(f"    (f) 2 iterations each, losses finite, parameters moved; "
              f"one update of ResNet-50's tree on the card against the CPU "
              f"(relative): " + ", ".join(
                  f"{n} {v['rel_err']:.2g}" for n, v in f_out.items()),
              flush=True)

        # (g) regularizers, card against CPU
        r12["g"] = regularized_card_vs_cpu(torch, dev)

        # readings
        med = lambda xs: statistics.median(xs) if xs else float("nan")
        sync_ck = [t for _, t in a["checkpoints"]]
        async_ck = [t for _, t in b["checkpoints"]]
        ck_bytes = os.path.getsize(a["checkpoints"][0][0])
        r12.update(a=a, b=b, a_fast=a_fast, b_inline=b_inline, c=c, d=dr,
                   e=e_counts, f=f_out,
                   ckpt_bytes=ck_bytes, sync_ckpt_s=sync_ck,
                   async_ckpt_s=async_ck)
        launches = {n: sum(r["counts"][n] for r in
                           runs + [b, a_fast, b_inline, c, dr])
                    + sum(e_counts[cv][n] for cv in e_counts)
                    for n in ("fused_matmul_fwd", "fused_matmul_bwd",
                              "fused_chain_fwd", "fused_chain_bwd",
                              "fused_conv_fwd")}
        r12["launches"] = launches
        print(f"    readings ({card}): (a) step_time median "
              f"{med(a['step_s'][1:]) * 1e3:.2f} ms, data_time median "
              f"{med(a['data_s'][1:]) * 1e3:.2f} ms, 8 iterations "
              f"{a['wall_s']:.3f} s (second run {runs[1]['wall_s']:.3f} s); "
              f"(b) a group of 4: step_time median "
              f"{med(b['step_s']) * 1e3:.2f} ms "
              f"({med(b['step_s']) * 1e3 / 4:.2f} ms a step), data_time "
              f"median {med(b['data_s']) * 1e3:.2f} ms, 8 iterations "
              f"{b['wall_s']:.3f} s; (a) with cuDNN's default algorithms: "
              f"step_time median {med(a_fast['step_s'][1:]) * 1e3:.2f} ms, "
              f"8 iterations {a_fast['wall_s']:.3f} s (no checkpoint); (b) "
              f"stacked inline (prefetch 0): a group "
              f"{med(b_inline['step_s']) * 1e3:.2f} ms, data_time median "
              f"{med(b_inline['data_s']) * 1e3:.2f} ms, 8 iterations "
              f"{b_inline['wall_s']:.3f} s (no checkpoint); one checkpoint "
              f"{ck_bytes} bytes: "
              f"synchronous {[round(t, 3) for t in sync_ck]} s, async "
              f"(the loop's share) {[round(t, 3) for t in async_ck]} s; "
              f"phase 12 launches {launches}", flush=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
    return r12


def regularized_card_vs_cpu(torch, dev, S=16, B=16, steps=2):
    """(g): conv3x3 (L2 on its weight) -> ReLU -> View -> Linear (L1L2 on
    its weight), the same weights trained ``steps`` steps on the card and
    on the CPU: losses and parameters within 1e-5."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.convert import host_copy_tree
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.optim import (SGD, L1L2Regularizer, L2Regularizer,
                                       LocalOptimizer, max_iteration)
    rng = np.random.RandomState(3)
    data = [Sample(rng.randn(S, S, 3).astype(np.float32),
                   rng.randint(1, 11)) for _ in range(B * steps)]
    out = {}
    for where in ("cpu", dev):
        torch.manual_seed(0)
        m = nn.Sequential(
            nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1,
                                  w_regularizer=L2Regularizer(1e-3),
                                  format="NHWC"),
            nn.ReLU(), nn.View(8 * S * S),
            nn.Linear(8 * S * S, 10,
                      w_regularizer=L1L2Regularizer(1e-4, 1e-3)))
        m.reset(torch.Generator().manual_seed(0))
        m.to(where)
        losses = []
        opt = LocalOptimizer(m, DataSet.array(data),
                             nn.CrossEntropyCriterion(),
                             SGD(0.05, momentum=0.9), max_iteration(steps),
                             B, device=where)
        step = opt._step
        opt._step = lambda *a: losses.append(step(*a)) or losses[-1]
        opt.set_prefetch(0).optimize()
        out[where] = ([float(v) for v in losses], host_copy_tree(m.params))
    dl = max(abs(x - y) for x, y in zip(out["cpu"][0], out[dev][0]))
    dp = tree_diff(out["cpu"][1], out[dev][1])
    check(dl <= 1e-5 and dp <= 1e-5, f"(g) regularized training, card "
          f"against CPU: losses {dl:.3g}, parameters {dp:.3g}")
    print(f"    (g) regularizers (L2 on the conv, L1L2 on the linear), "
          f"{steps} steps card against CPU: losses within {dl:.2g}, "
          f"parameters within {dp:.2g}", flush=True)
    return {"loss_err": dl, "param_err": dp}


# -- phase 13: the layer library and the classic image zoo ---------------------

# (batch, input shape) of each phase 13 model; a CPU rehearsal shrinks them
ZOO = {"lenet": (128, (28, 28)), "lenet_n": 2048, "inception_v1": (64, 224),
       "inception_v2": (32, 224), "vgg16": (32, 224), "vgg_cifar": (128, 32),
       "resnet50": (32, 224), "resnet50_arms": (8, 224),
       "resnet_cifar": (128, 32), "check": (2, 224)}
ZOO_TOL = 1e-4          # card against CPU, float32 with TF32 off


class ThreeHeadNLL:
    """Inception v2's loss: the mean of ClassNLL over its three heads
    (its output is the three log-softmaxes side by side, (N, 3 C))."""

    def __init__(self, classes):
        from bigdl_tpu_torch.nn import ClassNLLCriterion
        self.classes, self.nll = classes, ClassNLLCriterion()

    def _forward(self, out, y):
        heads = out.reshape(out.shape[0], 3, self.classes)
        return sum(self.nll._forward(heads[:, i], y) for i in range(3)) / 3


def fixed_batch_loss(torch, model, crit, x, y, grads=False):
    """The training-mode loss of ``model`` on one fixed batch, with the same
    dropout draws every call (a generator seeded 7) and the running
    statistics left alone; with ``grads``, also whether every parameter
    gradient is finite."""
    from bigdl_tpu_torch.convert import flatten
    g = torch.Generator(device=y.device).manual_seed(7)
    with torch.set_grad_enabled(grads):
        out, _ = model.apply(model.params, model.state, x, training=True,
                             generator=g)
        loss = crit._forward(out, y)
    if not grads:
        return loss.item(), None
    gs = torch.autograd.grad(loss, list(flatten(model.params).values()))
    return loss.item(), bool(torch.stack([torch.isfinite(t).all()
                                          for t in gs]).all())


def zoo_images(shape, n, classes, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *shape).astype(np.float32),
            rng.randint(1, classes + 1, size=n))


def zoo_train(torch, K, name, model, crit, optim, B, shape, classes, iters,
              warmup=1, dev="cuda", seed=11):
    """``model`` trained by :func:`train_fixed` on one fixed batch of B
    seeded images of ``shape`` with labels in 1 .. ``classes``."""
    imgs, labels = zoo_images(shape, B, classes, seed)
    return train_fixed(torch, K, "[13]", name, model, crit, optim, [imgs],
                       labels, iters, warmup, dev)


def train_fixed(torch, K, tag, name, model, crit, optim, feats, labels,
                iters, warmup=1, dev="cuda", unit="images", per_sample=1,
                validation=None):
    """``model`` trained through ``Optimizer.create`` for ``iters``
    iterations on one fixed batch (``feats``: one numpy array a feature,
    a row a sample; several reach the model as a ``Table``): the losses,
    the steps' times (after ``warmup``), ``unit``/s (``per_sample`` units
    a row), peak memory, and the fixed batch's loss before and after
    (same dropout draws), every parameter gradient of the latter finite.
    ``validation`` (trigger, samples, methods) is set on the optimizer.
    Fails if a loss is not finite, the fixed batch's loss did not fall or
    a port kernel launched."""
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.optim import Optimizer, Trigger, max_iteration
    from bigdl_tpu_torch.utils.table import Table
    B = len(labels)
    xs = [torch.from_numpy(f).to(dev) for f in feats]
    x = xs[0] if len(xs) == 1 else Table(*xs)
    y = torch.from_numpy(labels).to(dev)
    before, _ = fixed_batch_loss(torch, model, crit, x, y)
    losses, stop = [], max_iteration(iters)

    def end(st):
        if not st.get("epoch_finished"):    # one call a step (B is one epoch)
            losses.append(st["loss"])
        return stop(st)
    opt = Optimizer.create(model, DataSet.array(
        [Sample([f[i] for f in feats] if len(feats) > 1 else feats[0][i],
                labels[i]) for i in range(B)]), crit, Trigger(end),
        batch_size=B, optim_method=optim, device=dev)
    if validation is not None:
        opt.set_validation(*validation)
    held = 0
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    check(not any(counts.values()), f"{tag} {name} launched port kernels "
          f"{counts}: no TPU kernel lies on the layer library's path")
    after, finite = fixed_batch_loss(torch, model, crit, x, y, grads=True)
    steps = opt.metrics.values["step_time"]
    step = statistics.median(steps[warmup:]) if len(steps) > warmup \
        else steps[-1]
    rec = {"losses": losses, "fixed_batch_loss": (before, after),
           "step_ms": step * 1e3, "step_ms_all": [t * 1e3 for t in steps],
           f"{unit}_per_s": B * per_sample / step, "wall_s": wall,
           "max_mem_gb": (torch.cuda.max_memory_allocated() / 2**30
                          if dev == "cuda" else None),
           "held_gb": held / 2**30}
    check(len(losses) == iters and all(math.isfinite(v) for v in losses),
          f"{tag} {name}: losses {losses}")
    check(finite, f"{tag} {name}: a gradient on the fixed batch is not "
          f"finite")
    check(after < before, f"{tag} {name}: the fixed batch's loss did not "
          f"fall: {before} -> {after}")
    print(f"{tag} {name} B{B}: losses {[round(v, 4) for v in losses]}, fixed "
          f"batch {before:.4f} -> {after:.4f}; step {rec['step_ms']:.2f} ms "
          f"(all {[round(t, 1) for t in rec['step_ms_all']]}), "
          f"{rec[f'{unit}_per_s']:.1f} {unit}/s, peak "
          f"{rec['max_mem_gb'] or 0:.2f} GiB ({rec['held_gb']:.2f} GiB held "
          f"before the run)", flush=True)
    return rec, opt


def card_vs_cpu_step(torch, name, make, crit, shape, classes, training,
                     dev="cuda", B=2):
    """One step of ``make(device)`` on the card against the same weights
    and inputs on the CPU (TF32 off): logits, then every parameter's
    gradient, as the largest error over the largest magnitude. The logits
    hold to ``ZOO_TOL``; the gradients' median leaf too and the worst to
    1e-2 (at full width a few pre-activations or pooled maxima sit within
    float32 rounding of a kink or a tie and take the other side in the
    other summation order - the CPU tests hold the same models to JAX in
    float64 to 1e-9)."""
    from bigdl_tpu_torch.convert import flatten
    card = make(dev)
    host = make("cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    imgs, labels = zoo_images(shape, B, classes, 5)
    out = {}
    for m, d in ((card, dev), (host, "cpu")):
        if not training:
            m.evaluate()
        params = m.params
        logits, _ = m.apply(params, m.state, torch.from_numpy(imgs).to(d),
                            training=training,
                            generator=torch.Generator(device=d).manual_seed(1)
                            if training else None)
        loss = crit._forward(logits, torch.from_numpy(labels).to(d))
        leaves = flatten(params)
        gs = torch.autograd.grad(loss, list(leaves.values()))
        out[d] = (logits.detach().cpu(), {k: g.cpu() for k, g in
                                          zip(leaves, gs)})
    (lc, gc), (lh, gh) = out[dev], out["cpu"]
    errs = sorted(_rel_err(gc[k], gh[k]) for k in gh)
    rec = {"logits": _rel_err(lc, lh), "grad_median": errs[len(errs) // 2],
           "grad_worst": errs[-1], "leaves": len(errs)}
    print(f"[13] {name} card vs CPU (B{B}, one "
          f"{'training' if training else 'evaluation'}-mode step): {rec}",
          flush=True)
    check(rec["logits"] <= ZOO_TOL and rec["grad_median"] <= ZOO_TOL
          and rec["grad_worst"] <= 1e-2,
          f"[13] {name} on the card disagrees with the CPU: {rec}")
    del card, host
    return rec


def lenet_data(n, seed):
    """MNIST-shaped images whose class is a bright bar at a class-dependent
    place on noise (the JAX package's synthetic MNIST, normalised), 1-based
    labels."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    imgs = rng.randint(0, 40, size=(n, 28, 28)).astype(np.float32)
    for c in range(10):
        r, col = 2 + (c // 5) * 12, 2 + (c % 5) * 5
        imgs[labels == c, r:r + 9, col:col + 4] = 220 + (c * 3) % 35
    return ((imgs / 255.0 - 0.1307) / 0.3081).astype(np.float32), labels + 1


def zoo(torch, K, card, r8, dev="cuda"):
    """Phase 13: the Torch-style layer library and the classic image zoo
    on the card, float32 with TF32 off, no port kernel launched: (a)
    LeNet-5 through ``Optimizer`` with validation, then one manual Torch
    protocol step card against CPU; (b) Inception v1 at B64/224, (c)
    Inception v2 at B32/224, each with an evaluation-mode step card against
    CPU; (d) VGG-16 at B32/224 and VggForCifar10 at B128/32; (e) the
    unfused ResNet-50 (NCHW, ``fused="none"``) at phase 8's B32/224 with a
    profiler trace beside phase 8's fused step, and one NHWC and one
    space-to-depth step; (f) ResNetCifar-20 at B128/32."""
    from bigdl_tpu_torch import models, nn
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.optim import (SGD, Loss, Optimizer, Top1Accuracy,
                                       Top5Accuracy, Trigger, every_epoch,
                                       max_epoch, max_iteration)
    t13 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[13] the layer library and the image zoo, float32, TF32 off "
          f"({card})", flush=True)
    r13 = {}
    nll = nn.ClassNLLCriterion()
    # (a) LeNet-5, the reference example
    B, shape = ZOO["lenet"]
    n = ZOO["lenet_n"]
    imgs, labels = lenet_data(n + 512, 3)
    train = [Sample(imgs[i], labels[i]) for i in range(n)]
    val = [Sample(imgs[i], labels[i]) for i in range(n, n + 512)]
    lenet = models.LeNet5(10, device=dev, seed=1)
    losses, scores, stop = [], [], max_epoch(2)

    def end(st):
        if st.get("epoch_finished"):     # after the epoch's validation
            scores.append(st.get("score"))
        else:
            losses.append(st["loss"])
        return stop(st)
    opt = Optimizer(model=lenet, training_set=DataSet.array(train),
                    criterion=nll,
                    optim_method=SGD(0.05, learningrate_decay=0.0002),
                    end_trigger=Trigger(end), batch_size=B, device=dev)
    opt.set_validation(every_epoch(), DataSet.array(val),
                       [Top1Accuracy(), Top5Accuracy(), Loss()])
    K.reset_launch_counts()
    t0 = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t0
    check(not any(K.launch_counts().values()), "[13] LeNet-5 launched port "
          "kernels")
    res = lenet.evaluate_dataset(DataSet.array(val), [Top1Accuracy(),
                                                     Top5Accuracy(), Loss()])
    val_res = [r.result()[0] for r in res]
    lenet.training()
    per_epoch = -(-n // B)
    check(len(losses) == 2 * per_epoch and all(math.isfinite(v)
                                               for v in losses),
          f"[13] LeNet-5 losses {losses}")
    first, last = (statistics.mean(losses[:4]), statistics.mean(losses[-4:]))
    check(last < first, f"[13] LeNet-5's loss did not fall: {losses}")
    steps = opt.metrics.values["step_time"]
    r13["lenet"] = {"losses": losses, "val_top1_by_epoch": scores,
                    "val": val_res, "wall_s": wall,
                    "step_ms": statistics.median(steps[1:]) * 1e3,
                    "images_per_s": B / statistics.median(steps[1:])}
    print(f"[13] (a) LeNet-5 through Optimizer, {n} images B{B}, "
          f"SGD(0.05, learningrate_decay=0.0002), 2 epochs: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 4 {first:.4f}, last 4 "
          f"{last:.4f}); validation Top1 by epoch {scores}, after "
          f"Top1/Top5/Loss {[round(v, 4) for v in val_res]}; {wall:.2f} s, "
          f"step {r13['lenet']['step_ms']:.2f} ms", flush=True)
    # one manual Torch-protocol step, card against the CPU
    x, yb = torch.from_numpy(imgs[:B]), labels[:B]
    flat = {}
    for d in (dev, "cpu"):
        m = models.LeNet5(10, device=d)
        m.load_state_dict({k: v.to(d) for k, v in lenet.state_dict().items()})
        m.zero_grad_parameters()
        out = m.forward(x.to(d))
        crit = nn.ClassNLLCriterion()
        loss = crit.forward(out, yb)
        gi = m.backward(x.to(d), crit.backward(out, yb))
        w, g, _ = m.get_parameters()
        flat[d] = (loss.item(), gi.cpu(), w.cpu(), g.cpu())
    (lc, gic, wc, gc), (lh, gih, wh, gh) = flat[dev], flat["cpu"]
    r13["lenet_protocol"] = {"loss": abs(lc - lh) / abs(lh),
                             "grad_input": _rel_err(gic, gih),
                             "weights": _rel_err(wc, wh),
                             "grads": _rel_err(gc, gh), "n": int(wh.numel())}
    print(f"[13] (a) LeNet-5 Torch protocol step (forward, criterion "
          f"forward/backward, backward, get_parameters) card vs CPU: "
          f"{r13['lenet_protocol']}", flush=True)
    check(all(v <= ZOO_TOL for k, v in r13["lenet_protocol"].items()
              if k != "n"), f"[13] LeNet-5 protocol step card vs CPU "
          f"{r13['lenet_protocol']}")
    del lenet, opt
    # (b) Inception v1 at full width
    B, S = ZOO["inception_v1"]
    m = models.Inception_v1_NoAuxClassifier(1000, device=dev, seed=2)
    r13["inception_v1"], _ = zoo_train(
        torch, K, "(b) Inception v1", m, nll, SGD(0.01, momentum=0.9), B,
        (3, S, S), 1000, 5, dev=dev)
    del m
    r13["inception_v1_check"] = card_vs_cpu_step(
        torch, "(b) Inception v1",
        lambda d: models.Inception_v1_NoAuxClassifier(1000, device=d,
                                                      seed=3),
        nll, (3, ZOO["check"][1], ZOO["check"][1]), 1000, False, dev,
        ZOO["check"][0])
    # (c) Inception v2, three heads
    B, S = ZOO["inception_v2"]
    three = ThreeHeadNLL(1000)
    m = models.Inception_v2(1000, device=dev, seed=2)
    r13["inception_v2"], _ = zoo_train(
        torch, K, "(c) Inception v2 (3 heads)", m, three,
        SGD(0.01, momentum=0.9), B, (3, S, S), 1000, 3, dev=dev)
    del m
    r13["inception_v2_check"] = card_vs_cpu_step(
        torch, "(c) Inception v2", lambda d: models.Inception_v2(
            1000, device=d, seed=3), three,
        (3, ZOO["check"][1], ZOO["check"][1]), 1000, False, dev,
        ZOO["check"][0])
    # (d) VGG
    B, S = ZOO["vgg16"]
    m = models.Vgg_16(1000, device=dev, seed=2)
    r13["vgg16"], _ = zoo_train(
        torch, K, "(d) VGG-16", m, nll, SGD(0.01, momentum=0.9), B,
        (3, S, S), 1000, 3, dev=dev)
    del m
    B, S = ZOO["vgg_cifar"]
    m = models.VggForCifar10(10, device=dev, seed=2)
    r13["vgg_cifar"], _ = zoo_train(
        torch, K, "(d) VggForCifar10", m, nll, SGD(0.01, momentum=0.9), B,
        (3, S, S), 10, 3, dev=dev)
    del m
    # (e) the unfused ResNet-50, JAX's default arm, at phase 8's recipe
    B, S = ZOO["resnet50"]
    ce = nn.CrossEntropyCriterion()
    m = models.ResNet50(device=dev, seed=0)
    r13["resnet50"], _ = zoo_train(
        torch, K, "(e) ResNet-50 NCHW fused='none'", m, ce,
        SGD(0.1, momentum=0.9), B, (3, S, S), 1000, 3, dev=dev)
    imgs, labels = zoo_images((3, S, S), 2 * B, 1000, 12)
    again = Optimizer.create(m, DataSet.array(
        [Sample(imgs[i], labels[i]) for i in range(2 * B)]), ce,
        max_iteration(2), batch_size=B,
        optim_method=SGD(0.1, momentum=0.9), device=dev)
    if dev == "cuda":
        tr = trace_steps(torch, again.optimize, n=1, per_call=2)
        r13["resnet50"]["trace"] = tr
        step8 = statistics.median(r8["step_s"][1:]) * 1e3
        tr8 = r8["trace"]
        print(f"[13] (e) unfused ResNet-50 B{B}/{S} float32 step "
              f"{r13['resnet50']['step_ms']:.2f} ms against phase 8's fused "
              f"(K3 / K5) step {step8:.2f} ms, same run; traced: "
              f"{tr['device_ms']:.1f} ms of CUDA kernels a step in "
              f"{tr['launches']:.0f} launches (phase 8: "
              f"{tr8['device_ms']:.1f} ms in {tr8['launches']:.0f}); ms a "
              f"step by family {tr['families']} (phase 8: "
              f"{tr8['families']}); largest kernels (ms a step, launches a "
              f"step): {tr['top'][:10]}", flush=True)
    del m, again
    B, S = ZOO["resnet50_arms"]
    for arm, kw in (("NHWC", dict(format="NHWC")),
                    ("NHWC stem='s2d'", dict(format="NHWC", stem="s2d"))):
        m = models.ResNet50(device=dev, seed=0, **kw)
        shape = (S, S, 3)
        r13[f"resnet50 {arm}"], _ = zoo_train(
            torch, K, f"(e) ResNet-50 {arm} fused='none'", m, ce,
            SGD(0.1, momentum=0.9), B, shape, 1000, 2, dev=dev)
        del m
    # (f) ResNetCifar-20, shortcut A, log-softmax
    B, S = ZOO["resnet_cifar"]
    m = models.ResNetCifar(10, 20, device=dev, seed=2)
    r13["resnet_cifar20"], _ = zoo_train(
        torch, K, "(f) ResNetCifar-20", m, nll, SGD(0.1, momentum=0.9), B,
        (3, S, S), 10, 3, dev=dev)
    del m
    if dev == "cuda":
        torch.cuda.empty_cache()
    r13["phase_s"] = time.perf_counter() - t13
    print(f"[13] phase 13: {r13['phase_s']:.1f} s", flush=True)
    return r13

# -- phase 14: the sequence zoo ----------------------------------------------------

# the sizes of phase 14: PTB's "medium" LSTM (Zaremba et al. 2014, JAX's
# bench_lstm_ptb), TextClassifier's defaults on 20 Newsgroups, the SST
# widths of the Tree-LSTM (Tai et al. 2015); a CPU rehearsal shrinks them
SEQ = {"ptb": dict(vocab=10000, hidden=650, layers=2, steps=35, batch=64,
                   iters=6),
       "text": dict(classes=20, emb=50, seq=500, filters=256, batch=128,
                    per_class=7, iters=3),
       "tree": dict(emb=300, hidden=150, leaves=30, batch=25, classes=5,
                    iters=4)}
SEQ_TOL = 1e-4        # card against CPU, float32 with TF32 off
LBFGS_TOL = 1e-4      # LBFGS losses, card against CPU (relative)


def ptb_batch(B, T, vocab, seed=0):
    """B rows of T + 1 consecutive ids from ``ptb_synthetic``'s corpus
    (1000 words, through the port's ``Dictionary``, 1-based): inputs the
    first T, targets the last T, as the PTB example batches its stream."""
    from bigdl_tpu_torch.dataset.text import Dictionary, ptb_synthetic
    n = B * (T + 1)
    sents = ptb_synthetic(n_sentences=max(16, n // 8), vocab=1000,
                          max_len=30, seed=seed)
    d = Dictionary(sents, vocab_size=vocab - 1)
    stream = np.array([d.get_index(w) + 1 for st in sents for w in st],
                      np.int64)
    check(len(stream) >= n and stream.max() <= vocab,
          f"[14] the PTB stream has {len(stream)} ids, {n} needed")
    rows = stream[:n].reshape(B, T + 1)
    return rows[:, :T].astype(np.float32), rows[:, 1:].astype(np.float32)


def random_tree(rng, n_leaves):
    """A random binary tree over ``n_leaves`` words in ``TensorTree`` rows
    (2 n - 1 nodes in preorder, node 1 the root with -1 in its word column,
    children 1-based, each leaf its word left to right)."""
    rows = []

    def build(lo, hi):
        at = len(rows)
        rows.append(None)
        if hi - lo == 1:
            rows[at] = [0, 0, lo + 1]
        else:
            cut = rng.randint(lo + 1, hi)
            left = build(lo, cut)
            rows[at] = [left, build(cut, hi), -1 if at == 0 else 0]
        return at + 1
    build(0, n_leaves)
    return np.array(rows, np.float32)


def tree_batch(n, n_leaves, emb, classes, seed):
    """n random trees with 0.5 N(0, 1) word vectors; the label a quantile
    class (1-based) of the words' summed first component."""
    rng = np.random.RandomState(seed)
    words = (0.5 * rng.randn(n, n_leaves, emb)).astype(np.float32)
    trees = np.stack([random_tree(rng, n_leaves) for _ in range(n)])
    score = words[:, :, 0].sum(1)
    cuts = np.quantile(score, np.linspace(0, 1, classes + 1)[1:-1])
    return words, trees, (np.digitize(score, cuts) + 1).astype(np.int64)


def _float_leaves(x):
    import torch
    if torch.is_tensor(x):
        return [x] if x.is_floating_point() else []
    return [t for item in x for t in _float_leaves(item)]


def module_card_vs_cpu(torch, name, make, inputs, dev="cuda", tag="[14]",
                       tol=SEQ_TOL):
    """One training-mode forward of ``make()`` (built on the CPU from
    torch's generator seeded 0) and the gradients of sum(sin(out / 2)) in
    its parameters and float inputs, on the card against the same module
    and inputs on the CPU: the largest error over the largest value
    (``_rel_err``) of every output and gradient."""
    import copy
    from bigdl_tpu_torch.convert import flatten
    from bigdl_tpu_torch.utils.table import Table
    torch.manual_seed(0)
    host = make()
    card = copy.deepcopy(host).to(dev)
    res = {}
    for m, d in ((card, dev), (host, "cpu")):
        xs = [torch.from_numpy(a).to(d) for a in inputs]
        fl = [t.requires_grad_() for t in xs if t.is_floating_point()]
        x = xs[0] if len(xs) == 1 else Table(*xs)
        params = m.params
        out, _ = m.apply(params, m.state, x, training=True)
        outs = _float_leaves(out)
        wrt = list(flatten(params).values()) + fl
        gs = torch.autograd.grad(sum(torch.sin(0.5 * o).sum() for o in outs),
                                 wrt)
        res[d] = [t.detach().cpu() for t in outs + list(gs)]
    err = max(_rel_err(a, b) for a, b in zip(res[dev], res["cpu"]))
    check(math.isfinite(err) and err <= tol,
          f"{tag} {name} on the card disagrees with the CPU: {err}")
    return err


def seq_cases(nn, r):
    """(name, constructor, numpy inputs) of every class of phase 14 not
    trained at full width, at small widths; ``r(*shape)`` draws N(0, 1)
    float32."""
    tree = random_tree(np.random.RandomState(5), 6)[None].repeat(3, 0)
    ids = np.random.RandomState(6).randint(0, 40, size=(4, 7))
    table = nn.SpatialConvolutionMap.random(6, 8, 3)
    return [
        ("Linear", lambda: nn.Linear(16, 8), [r(4, 16)]),
        ("Bilinear", lambda: nn.Bilinear(16, 12, 8), [r(4, 16), r(4, 12)]),
        ("Cosine", lambda: nn.Cosine(16, 8), [r(4, 16)]),
        ("Euclidean", lambda: nn.Euclidean(16, 8), [r(4, 16)]),
        ("Add", lambda: nn.Add(16), [r(4, 16)]),
        ("Mul", lambda: nn.Mul(), [r(4, 16)]),
        ("CMul", lambda: nn.CMul((4, 1)), [r(2, 3, 4, 5)]),
        ("CAdd", lambda: nn.CAdd((1, 5)), [r(2, 3, 5)]),
        ("Scale", lambda: nn.Scale((3, 1, 1)), [r(2, 3, 4, 4)]),
        ("Highway", lambda: nn.Highway(16), [r(4, 16)]),
        ("LookupTable max_norm mask_zero", lambda: nn.LookupTable(
            32, 8, max_norm=1.0, mask_zero=True), [ids]),
        ("Recurrent(RnnCell relu)", lambda: nn.Recurrent(nn.RnnCell(
            8, 16, "relu")), [r(4, 7, 8)]),
        ("Recurrent(LSTM)", lambda: nn.Recurrent(nn.LSTM(8, 16)),
         [r(4, 7, 8)]),
        ("Recurrent(LSTMPeephole)", lambda: nn.Recurrent(nn.LSTMPeephole(
            8, 16)), [r(4, 7, 8)]),
        ("Recurrent(GRU)", lambda: nn.Recurrent(nn.GRU(8, 16)),
         [r(4, 7, 8)]),
        ("Recurrent(MultiRNNCell)", lambda: nn.Recurrent(nn.MultiRNNCell(
            [nn.LSTM(8, 16), nn.GRU(16, 12)])), [r(4, 7, 8)]),
        ("Recurrent(ConvLSTMPeephole)", lambda: nn.Recurrent(
            nn.ConvLSTMPeephole(3, 4, 3, 3)), [r(2, 4, 3, 6, 6)]),
        ("BiRecurrent concat", lambda: nn.BiRecurrent("concat").add(
            nn.LSTM(8, 16)), [r(4, 7, 8)]),
        ("BiRecurrent add", lambda: nn.BiRecurrent().add(nn.GRU(8, 16)),
         [r(4, 7, 8)]),
        ("RecurrentDecoder", lambda: nn.RecurrentDecoder(5).add(
            nn.LSTM(8, 8)), [r(4, 8)]),
        ("TimeDistributed", lambda: nn.TimeDistributed(nn.Linear(8, 6)),
         [r(4, 7, 8)]),
        ("TemporalConvolution", lambda: nn.TemporalConvolution(8, 12, 3, 2),
         [r(4, 15, 8)]),
        ("SpatialConvolutionMap", lambda: nn.SpatialConvolutionMap(
            table, 3, 3, 1, 1, 1, 1), [r(2, 6, 9, 9)]),
        ("VolumetricConvolution", lambda: nn.VolumetricConvolution(
            3, 6, 3, 3, 3, 2, 2, 2, -1, -1, -1), [r(2, 3, 7, 8, 9)]),
        ("VolumetricFullConvolution adj >= stride", lambda:
         nn.VolumetricFullConvolution(3, 4, 3, 3, 3, 2, 2, 2, 1, 1, 1, 2, 1,
                                      3), [r(2, 3, 4, 5, 4)]),
        ("LocallyConnected1D", lambda: nn.LocallyConnected1D(12, 8, 6, 3, 2),
         [r(4, 12, 8)]),
        ("LocallyConnected2D", lambda: nn.LocallyConnected2D(
            3, 9, 8, 5, 3, 3, 2, 2, 1, 1), [r(2, 3, 8, 9)]),
        ("BinaryTreeLSTM", lambda: nn.BinaryTreeLSTM(8, 12),
         [r(3, 6, 8), tree.astype(np.int64)]),
    ]


def seq_zoo(torch, K, card, dev="cuda"):
    """Phase 14: the sequence zoo on the card, float32 with TF32 off, no
    port kernel launched (JAX computes these with XLA's scans, convolutions
    and gathers): (a) PTBModel at PTB's medium width through
    ``Optimizer.create`` (``TimeDistributedCriterion(ClassNLLCriterion())``,
    ``SGD(0.01)``) on one fixed batch of ``ptb_synthetic``'s stream, then
    two iterations under ``torch.profiler``, then two GRU iterations; (b)
    TextClassifier (cnn and lstm encoders; ``Adam``, JAX's example's) on
    ``news20.synthetic`` through ``tokenize_to_glove_sequences``, with
    ``set_validation(Top1Accuracy)``; (c) BinaryTreeLSTM under a Linear +
    LogSoftMax head on the root (``SGD(0.5, momentum=0.9)``, JAX's
    example's), with ``TreeNNAccuracy``; (d) every other class card
    against CPU; (e) ``LBFGS.optimize`` card against CPU."""
    from bigdl_tpu_torch import models, nn
    from bigdl_tpu_torch.dataset import DataSet, Sample, news20
    from bigdl_tpu_torch.models._build import placed
    from bigdl_tpu_torch.optim import (LBFGS, SGD, Adam, Optimizer,
                                       Top1Accuracy, TreeNNAccuracy,
                                       every_epoch, max_iteration)
    t14 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[14] the sequence zoo, float32, TF32 off ({card})", flush=True)
    r14 = {}
    # (a) PTBModel
    c = SEQ["ptb"]
    V, H, L, T, B = c["vocab"], c["hidden"], c["layers"], c["steps"], \
        c["batch"]
    x, y = ptb_batch(B, T, V)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    m = models.PTBModel(V, H, num_layers=L, device=dev, seed=1)
    rec, _ = train_fixed(
        torch, K, "[14]", f"(a) PTBModel V{V} H{H} L{L} T{T}", m, crit,
        SGD(learningrate=0.01), [x], y, c["iters"], dev=dev, unit="tokens",
        per_sample=T)
    # FLOPs a step: per token 2 (L 8 H^2 + H V) forward, 3x for training
    flops = 3 * 2 * B * T * (L * 8 * H * H + H * V)
    rec["flop_ms"] = flops / PEAK_FLOPS["torch.float32"] * 1e3
    if dev == "cuda":
        again = Optimizer.create(m, DataSet.array(
            [Sample(x[i], y[i]) for i in range(B)]), crit, max_iteration(2),
            batch_size=B, optim_method=SGD(learningrate=0.01), device=dev)
        tr = trace_steps(torch, again.optimize, n=1, per_call=2, convs=False)
        rec["trace"] = tr
        rec["busy"] = tr["device_ms"] / tr["wall_ms"]
        rec["busy_unprofiled"] = tr["device_ms"] / rec["step_ms"]
        print(f"[14] (a) PTBModel step {rec['step_ms']:.2f} ms against "
              f"{flops / 1e9:.1f} GFLOP = {rec['flop_ms']:.2f} ms at 67 "
              f"TFLOP/s float32 ({rec['step_ms'] / rec['flop_ms']:.1f}x); "
              f"traced: {tr['device_ms']:.1f} ms of CUDA kernels a step in "
              f"{tr['launches']:.0f} launches, profiled wall "
              f"{tr['wall_ms']:.1f} ms, device busy {rec['busy']:.1%} of it "
              f"({rec['busy_unprofiled']:.1%} of the unprofiled step); ms a "
              f"step by family {tr['families']}; largest kernels (ms a step, "
              f"launches a step): {tr['top'][:10]}", flush=True)
    r14["ptb"] = rec
    del m
    m = models.PTBModel(V, H, num_layers=L, cell_type="gru", device=dev,
                        seed=2)
    r14["ptb_gru"], _ = train_fixed(
        torch, K, "[14]", f"(a) PTBModel GRU V{V} H{H} L{L} T{T}", m, crit,
        SGD(learningrate=0.01), [x], y, 2, dev=dev, unit="tokens",
        per_sample=T)
    del m
    # (b) TextClassifier on GloVe-style sequences of 20 Newsgroups
    c = SEQ["text"]
    texts = news20.synthetic(n_per_class=c["per_class"],
                             class_num=c["classes"], doc_len=c["seq"])
    feats, labels = models.tokenize_to_glove_sequences(
        texts, None, c["seq"], c["emb"])
    order = np.random.RandomState(4).permutation(len(labels))
    tr_i, va_i = order[:c["batch"]], order[c["batch"]:]
    val = [Sample(feats[i], labels[i]) for i in va_i]
    # JAX's example's Adam(0.01) for the convolution; the LSTM over 500
    # steps takes 1e-3 (at 0.01 its fixed batch's loss rose on the card)
    for enc, lr in (("cnn", 0.01), ("lstm", 0.001)):
        m = models.TextClassifier(c["classes"], c["emb"], c["seq"], enc,
                                  c["filters"], device=dev, seed=3)
        rec, _ = train_fixed(
            torch, K, "[14]", f"(b) TextClassifier {enc} L{c['seq']} "
            f"D{c['emb']} {c['filters']}", m, nn.ClassNLLCriterion(),
            Adam(learningrate=lr), [feats[tr_i]],
            labels[tr_i], c["iters"], dev=dev, unit="documents",
            validation=(every_epoch(), val, [Top1Accuracy()]))
        rec["val_top1"] = m.evaluate_dataset(
            DataSet.array(val), [Top1Accuracy()])[0].result()[0]
        print(f"[14] (b) TextClassifier {enc}: validation Top1 "
              f"{rec['val_top1']:.3f} on {len(val)} held-out documents",
              flush=True)
        r14[f"text_{enc}"] = rec
        del m
    # (c) BinaryTreeLSTM on random binary trees
    c = SEQ["tree"]
    words, trees, ty = tree_batch(2 * c["batch"], c["leaves"], c["emb"],
                                  c["classes"], 6)
    B = c["batch"]
    m = placed(nn.Sequential(nn.BinaryTreeLSTM(c["emb"], c["hidden"]),
                             nn.Select(2, 1), nn.Linear(c["hidden"],
                                                        c["classes"]),
                             nn.LogSoftMax()), dev, 4)
    val = [Sample([words[i], trees[i]], ty[i]) for i in range(B, 2 * B)]
    rec, _ = train_fixed(
        torch, K, "[14]", f"(c) BinaryTreeLSTM D{c['emb']} H{c['hidden']} "
        f"{trees.shape[1]} nodes", m, nn.ClassNLLCriterion(),
        SGD(learningrate=0.5, momentum=0.9), [words[:B], trees[:B]], ty[:B],
        c["iters"], dev=dev, unit="trees",
        validation=(every_epoch(), val, [TreeNNAccuracy()]))
    rec["val_tree_acc"] = m.evaluate_dataset(
        DataSet.array(val), [TreeNNAccuracy()])[0].result()[0]
    print(f"[14] (c) BinaryTreeLSTM: {trees.shape[1]} nodes a tree, the "
          f"full sweep ({trees.shape[1]} compositions of every node); "
          f"TreeNNAccuracy {rec['val_tree_acc']:.3f} on {B} held-out trees",
          flush=True)
    r14["tree"] = rec
    del m
    # (d) every other class, card against CPU
    rng = np.random.RandomState(8)
    r = lambda *shape: rng.randn(*shape).astype(np.float32)
    errs = {name: module_card_vs_cpu(torch, name, make, inputs, dev)
            for name, make, inputs in seq_cases(nn, r)}
    errs["SimpleRNN"] = module_card_vs_cpu(
        torch, "SimpleRNN", lambda: models.SimpleRNN(8, 16, 5, device="cpu"),
        [r(4, 6, 8)], dev)
    r14["card_vs_cpu"] = errs
    worst = max(errs, key=errs.get)
    print(f"[14] (d) card vs CPU, one training-mode forward and every "
          f"gradient (largest error over largest value), {len(errs)} "
          f"classes: worst {worst} {errs[worst]:.2e}; "
          f"{ {k: float(f'{v:.2e}') for k, v in errs.items()} }", flush=True)
    # (e) LBFGS.optimize on a full-batch softmax regression
    rng = np.random.RandomState(9)
    X, Y = r(256, 32), rng.randint(0, 10, size=256)
    w0 = {"w": 0.1 * r(32, 10), "b": np.zeros(10, np.float32)}
    runs = {}
    for d in (dev, "cpu"):
        xt, yt = torch.from_numpy(X).to(d), torch.from_numpy(Y).to(d)

        def feval(p):
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            logp = torch.log_softmax(xt @ leaves["w"] + leaves["b"], -1)
            loss = -logp[torch.arange(len(yt), device=d), yt].mean() \
                + 0.01 * (leaves["w"] ** 2).sum()
            g = torch.autograd.grad(loss, list(leaves.values()))
            return loss.item(), dict(zip(leaves, g))
        K.reset_launch_counts()
        t0 = time.perf_counter()
        _, losses = LBFGS(max_iter=10, tol_fun=1e-12, line_search=True) \
            .optimize(feval, {k: torch.from_numpy(v).to(d)
                              for k, v in w0.items()})
        runs[d] = (losses, time.perf_counter() - t0)
        check(not any(K.launch_counts().values()), "[14] LBFGS launched "
              "port kernels")
    (lc, tc), (lh, _) = runs[dev], runs["cpu"]
    lerr = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    r14["lbfgs"] = {"losses": lc, "rel_err": lerr, "wall_s": tc}
    print(f"[14] (e) LBFGS.optimize (max_iter 10, Armijo line search) on "
          f"a 256 x 32 softmax regression: losses {[round(v, 5) for v in lc]}"
          f", card against CPU {lerr:.2e} (relative), {tc:.3f} s",
          flush=True)
    check(len(lc) == len(lh) and lerr <= LBFGS_TOL and lc[-1] < lc[0],
          f"[14] LBFGS on the card {lc} against the CPU {lh}")
    if dev == "cuda":
        torch.cuda.empty_cache()
    r14["phase_s"] = time.perf_counter() - t14
    print(f"[14] phase 14: {r14['phase_s']:.1f} s", flush=True)
    return r14


# -- phase 15: the training loop's remainder and module I/O ---------------------

# the sizes of phase 15 (a CPU rehearsal shrinks them): the flagship's
# LocalOptimizer shape (phase 6), samples an epoch, the held-out set, the
# predict set and ResNet-50's predict_class batch
LOOP15 = dict(B=8, T=256, iters=6, samples=40, held=8, pred_n=20, pred_T=64,
              image=224, image_B=32, stall_deadline_s=2.0, grace_s=600.0,
              plateau_iters=40)


class _Batches:
    """A batch-level data set of fixed MiniBatches (no shuffle) that, with
    ``at``, blocks before batch ``at`` until ``release()`` is true (polled,
    up to 60 s; ``waited_s`` stays None when it never was), then yields
    the rest."""

    def __init__(self, batches, at=None, release=None):
        self.batches, self.at, self.release = batches, at, release
        self.waited_s = None

    def size(self):
        return sum(len(b.get_input()) for b in self.batches)

    def batches_per_epoch(self):
        return len(self.batches)

    def shuffle(self):
        return self

    def data(self, train=True):
        for i, mb in enumerate(self.batches):
            if i == self.at:
                t0 = time.monotonic()
                while time.monotonic() - t0 < 60:
                    if self.release():
                        self.waited_s = time.monotonic() - t0
                        break
                    time.sleep(0.01)
            yield mb


def _lm_samples(V, n, T, seed):
    from bigdl_tpu_torch.dataset import Sample
    ids = np.random.RandomState(seed).randint(1, V, (n, T + 1)) \
        .astype(np.int32)
    return [Sample(r[:-1], r[1:]) for r in ids]


def _trees_equal(torch, a, b):
    from bigdl_tpu_torch.convert import flatten
    fa, fb = flatten(a), flatten(b)
    return set(fa) == set(fb) and all(
        torch.equal(torch.as_tensor(fa[k]), torch.as_tensor(fb[k]))
        for k in fa)


def _host_params(torch, model):
    from bigdl_tpu_torch.convert import host_copy_tree
    return host_copy_tree(model.params)


def loop_remainder(torch, K, card, dev="cuda", tmp=None):
    """Phase 15: the training loop's remainder on the flagship (float32
    parameters, B8/T256, ``LMCriterion``, ``SGD(0.01, momentum=0.9)``,
    observability on): (a) a clean run with a chained data set,
    ``prepare_input``, train and validation summaries, a LearningRate
    trigger, anomaly detection and a stall deadline, its event files read
    back; (b) the same run with a fault policy and one transient fault
    after the third step wrote its tensors, bit for bit (a); (c) a stall
    halted by the remediation with a checkpoint from its side thread; (d)
    a plateau that drives a ``Plateau`` schedule and stops the run; (e)
    save / load / clone / predict of (a)'s model, ``predict_class`` on
    float32 ResNet-50 (K3 / K4 / K5 on their no-statistics path) and its
    BatchNorm state through the extra parameters; (f) the JAX package's
    public flash entries against the plain versions."""
    import tempfile
    import threading
    import bigdl_tpu_torch.observability as obs
    from bigdl_tpu_torch.dataset import (DataSet, FuncTransformer,
                                         MiniBatch, Sample,
                                         TransformedDataSet)
    from bigdl_tpu_torch.models import ResNet50, TransformerLM
    from bigdl_tpu_torch.nn import LMCriterion
    from bigdl_tpu_torch.nn.module import Module
    from bigdl_tpu_torch.observability import flight, health
    from bigdl_tpu_torch.optim import (SGD, Loss, LocalOptimizer, Plateau,
                                       max_iteration, several_iteration)
    from bigdl_tpu_torch.optim.optimizer import RemediationPolicy
    from bigdl_tpu_torch.optim.staging import stager_threads_alive
    from bigdl_tpu_torch.parallel.failure import (FaultPolicy,
                                                  TrainingHalted,
                                                  TransientDeviceError)
    from bigdl_tpu_torch.visualization import (TrainSummary,
                                               ValidationSummary,
                                               read_scalar)
    t15 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = LOOP15
    B, T, iters = c["B"], c["T"], c["iters"]
    tmp = tmp or tempfile.mkdtemp(prefix="phase15_")
    os.environ["BIGDL_TPU_FLIGHT_DIR"] = os.path.join(tmp, "flight")
    print(f"[15] the training loop's remainder, flagship width, float32 "
          f"params, B{B}/T{T} ({card})", flush=True)
    cfg = dict(FLAGSHIP)
    V, L = cfg["vocab_size"], cfg["num_layers"]
    model = TransformerLM(**cfg, seed=0, device=dev)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    raw = _lm_samples(V, c["samples"], T, seed=3)
    held = _lm_samples(V, c["held"], T, seed=4)
    r15 = {}

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def train(tag, cls=LocalOptimizer, setup=None, data=None, method=None,
              end=None, observe=True):
        """One LocalOptimizer run from ``init`` with the launch counters
        and observability (on unless ``observe`` is False) reset just
        before it and read just after."""
        model.load_state_dict(init)
        model.remat = False
        ds = data if data is not None else DataSet.array(
            raw, FuncTransformer(lambda s: Sample(s.features[0],
                                                  s.labels[0])))
        opt = cls(model, ds, LMCriterion(),
                  method or SGD(learningrate=0.01, momentum=0.9),
                  end or max_iteration(iters), batch_size=B, device=dev)
        losses = []
        step = opt._step
        opt._step = lambda *a: losses.append(step(*a)) or losses[-1]
        if setup is not None:
            setup(opt)
        if observe:
            obs.enable()
        obs.registry().reset()
        flight.reset()
        err = None
        sync()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            opt.optimize()
        except TrainingHalted as e:
            err = e
        sync()
        wall = time.perf_counter() - t0
        rec = {"opt": opt, "halt": err, "wall_s": wall,
               "counts": K.launch_counts(), "routes": K.launches_by_route(),
               "losses": [float(v) for v in losses],
               "step_ms": [1e3 * s for s in
                           opt.metrics.values.get("step_time", [])],
               "flight": [(e["kind"], e.get("neval"))
                          for e in flight.recorder().events()],
               "fault_retries": opt.metrics.values.get("fault_retries", []),
               "snapshots": obs.registry().counter(
                   "optim/fault_snapshots").value}
        obs.disable()
        obs.registry().reset()
        steps = rec["step_ms"][1:] or rec["step_ms"]
        rec["step_ms_median"] = statistics.median(steps) if steps else None
        print(f"[15] ({tag}) {len(rec['step_ms'])} steps in {wall:.2f} s, "
              f"step ms {[round(s, 1) for s in rec['step_ms']]} (median "
              f"after the first {rec['step_ms_median']}); launches "
              f"{rec['counts']}", flush=True)
        return rec

    def check_k1(rec, n, tag, val_fwd=0):
        """n training steps' K1 launches, and ``val_fwd`` validation
        forwards (one K1-fwd a layer and batch), all on f32_sm90."""
        want = dict.fromkeys(K.WRAPPERS, 0)
        want.update(flash_fwd=n + val_fwd, flash_bwd=n)
        if dev == "cuda":
            check(rec["counts"] == want and only_on(
                rec["routes"]["flash_fwd"], "f32_sm90", n + val_fwd)
                and only_on(rec["routes"]["flash_bwd"], "f32_sm90", n),
                f"[15] ({tag}) launches {rec['counts']} by route "
                f"{rec['routes']}, expected {n} + {val_fwd} K1-fwd and "
                f"{n} K1-bwd on f32_sm90")

    # (a0) the plain run: observability off, no summary, no detector
    ra0 = train("a0", observe=False)
    check_k1(ra0, L * iters, "a0")
    # (a) the clean run
    logs = os.path.join(tmp, "logs")

    def setup_a(opt, log_dir=logs):
        opt.set_validation(several_iteration(3), held,
                           [Loss(LMCriterion())], B)
        opt.set_train_summary(TrainSummary(log_dir, "lm"))
        opt.set_val_summary(ValidationSummary(log_dir, "lm"))
        opt.set_summary_trigger("LearningRate", several_iteration(2))
        opt.set_anomaly_detection()
        opt.set_stall_deadline(120.0, startup_grace_s=c["grace_s"])
        opt.prepare_input()

    ra = train("a", setup=setup_a)
    check(len(ra["losses"]) == iters
          and all(math.isfinite(v) for v in ra["losses"]),
          f"[15] (a) losses {ra['losses']}")
    # two validations (at 3 and 6) of one held-out batch
    n_val = L * (iters // 3) * (-(-c["held"] // B))
    check_k1(ra, L * iters, "a", n_val)
    loss_rows = read_scalar(os.path.join(logs, "lm", "train"), "Loss")
    lr_rows = read_scalar(os.path.join(logs, "lm", "train"), "LearningRate")
    val_rows = read_scalar(os.path.join(logs, "lm", "validation"),
                           repr(Loss(LMCriterion())))
    f32 = [float(np.float32(v)) for v in ra["losses"]]
    check([s for s, _ in loss_rows] == list(range(1, iters + 1))
          and [v for _, v in loss_rows] == f32,
          f"[15] (a) Loss summary {loss_rows}, losses {ra['losses']}")
    check([s for s, _ in lr_rows] == list(range(2, iters + 1, 2)),
          f"[15] (a) LearningRate summary {lr_rows}")
    check([s for s, _ in val_rows] == list(range(3, iters + 1, 3))
          and all(math.isfinite(v) for _, v in val_rows),
          f"[15] (a) validation summary {val_rows}")
    kinds = [k for k, _ in ra["flight"] if not k.startswith("health/")]
    check(kinds[0] == "train/start" and kinds.count("step") == iters
          and kinds.count("epoch") == (iters * B) // c["samples"],
          f"[15] (a) flight records {ra['flight']}")
    print(f"[15] (a) event files: Loss at {[s for s, _ in loss_rows]} equal "
          f"the resolved losses, LearningRate at "
          f"{[s for s, _ in lr_rows]}, validation at "
          f"{[s for s, _ in val_rows]}; flight {kinds}", flush=True)
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    check(ra["losses"] == ra0["losses"], f"[15] (a) losses {ra['losses']} "
          f"against the plain run's {ra0['losses']}")
    r15["observability_ms"] = ra["step_ms_median"] - ra0["step_ms_median"]
    print(f"[15] (a) against (a0): step ms median {ra['step_ms_median']:.2f}"
          f" with observability, summaries and the detector on, "
          f"{ra0['step_ms_median']:.2f} off ({r15['observability_ms']:+.2f}"
          f" ms a step; validations excluded from both)", flush=True)

    # (b) the same run under a fault policy, a transient fault after the
    # third step's writes
    class Flaky(LocalOptimizer):
        calls = 0

        def _step(self, *a):
            Flaky.calls += 1
            loss = LocalOptimizer._step(self, *a)
            if Flaky.calls == 3:
                raise TransientDeviceError("injected after the writes")
            return loss

    def setup_b(opt):
        setup_a(opt, os.path.join(tmp, "logs_b"))
        opt.set_fault_policy(FaultPolicy(max_restarts=2, backoff_base_s=0))

    rb = train("b", cls=Flaky, setup=setup_b)
    check(_trees_equal(torch, model.state_dict(), trained)
          and rb["losses"][-1] == ra["losses"][-1],
          "[15] (b) the replayed run's parameters differ from (a)'s")
    check(rb["fault_retries"] == [1.0] and Flaky.calls == iters + 1,
          f"[15] (b) fault retries {rb['fault_retries']}, calls "
          f"{Flaky.calls}")
    check_k1(rb, L * (iters + 1), "b", n_val)
    r15["snapshot_ms"] = rb["step_ms_median"] - ra["step_ms_median"]
    print(f"[15] (b) replay bit for bit (a); fault_retries 1; step ms "
          f"median {rb['step_ms_median']:.1f} against (a)'s "
          f"{ra['step_ms_median']:.1f}: the per-dispatch device snapshot "
          f"of parameters and momentum costs {r15['snapshot_ms']:.1f} ms a "
          f"step ({int(rb['snapshots'])} snapshots)", flush=True)

    # (c) a stall: the data set blocks before batch 3 until the side
    # thread starts the halt checkpoint, and lets go while it copies; the
    # live parameters are read just before the copy (the loop is blocked
    # after step 2), and the loop must not run step 3 under the copy
    from bigdl_tpu_torch.dataset import ShardedDataSet
    mbs = list(ShardedDataSet(DataSet.array(raw), B).data(train=False))
    box = {}
    stall = _Batches(mbs, 2, lambda: "live" in box)

    def setup_c(opt):
        real = opt._checkpoint

        def checkpoint(*a, **kw):
            box["live"] = _host_params(torch, model)
            return real(*a, **kw)
        opt._checkpoint = checkpoint
        opt.set_checkpoint(several_iteration(10 ** 6),
                           os.path.join(tmp, "ck_c"))
        opt.set_stall_deadline(c["stall_deadline_s"],
                               startup_grace_s=c["grace_s"])
        opt.set_remediation(RemediationPolicy(halt_on_stall=True))

    rc = train("c", data=stall, setup=setup_c, end=max_iteration(len(mbs)))
    halt = rc["halt"]
    check(stall.waited_s is not None and halt is not None
          and halt.cause == "stall" and halt.neval == 2,
          f"[15] (c) expected TrainingHalted(cause='stall', neval=2), got "
          f"{halt!r}")
    with open(halt.checkpoint_path, "rb") as f:
        payload = pickle.load(f)
    check(payload["neval"] == 2
          and _trees_equal(torch, payload["params"], box["live"])
          and _trees_equal(torch, _host_params(torch, model), box["live"]),
          "[15] (c) the halt checkpoint, or the model after the halt, is "
          "not the state after step 2")
    check(halt.bundle_path and os.path.exists(halt.bundle_path),
          f"[15] (c) no flight bundle: {halt.bundle_path}")
    # steps 1 and 2 only: the batch that came during the copy is not run
    check_k1(rc, L * 2, "c")
    t0 = time.monotonic()
    while time.monotonic() - t0 < 10 and (
            health.watchdog_threads_alive() or stager_threads_alive()
            or any(t.name == "bigdl-stall-remediation"
                   for t in threading.enumerate())):
        time.sleep(0.02)
    left = [t.name for t in threading.enumerate()
            if t.name == "bigdl-stall-remediation"]
    check(health.watchdog_threads_alive() == 0 and not left
          and stager_threads_alive() == 0,
          f"[15] (c) threads left: watchdog "
          f"{health.watchdog_threads_alive()}, {left}, stagers "
          f"{stager_threads_alive()}")
    print(f"[15] (c) stall: TrainingHalted(cause='stall', neval=2) after "
          f"{stall.waited_s:.2f} s blocked (deadline "
          f"{c['stall_deadline_s']} s after the grace, the data let go "
          f"while the checkpoint copied), checkpoint from the side thread "
          f"and the model equal to the parameters after step 2, bundle "
          f"{os.path.basename(halt.bundle_path)}; no thread left",
          flush=True)
    os.remove(halt.checkpoint_path)

    # (d) a plateau: lr 0 on one repeated batch
    one = _Batches(mbs[:1] * c["plateau_iters"])
    sched = Plateau(factor=0.1, patience=10 ** 6)

    def setup_d(opt):
        opt.set_prefetch(0)
        opt.set_anomaly_detection(min_points=2, window=8, plateau_window=3,
                                  plateau_rel=1e-7)
        opt.set_remediation(RemediationPolicy(plateau_lr=True,
                                              early_stop_plateaus=1))

    rd = train("d", data=one, setup=setup_d,
               method=SGD(learningrate=0.0, learningrate_schedule=sched),
               end=max_iteration(c["plateau_iters"]))
    nd = rd["opt"].optim_method.state["neval"]
    check(rd["halt"] is None and nd < c["plateau_iters"]
          and abs(sched.multiplier - 0.1) < 1e-12,
          f"[15] (d) plateau: stopped at {nd}, multiplier "
          f"{sched.multiplier}")
    check_k1(rd, L * nd, "d")
    print(f"[15] (d) plateau: lr 0 on one batch, early stop at neval {nd} of "
          f"{c['plateau_iters']}, Plateau multiplier {sched.multiplier}",
          flush=True)

    # (e) module I/O on (a)'s model
    model.load_state_dict(trained)
    model.evaluate()
    x = torch.from_numpy(np.stack([s.features[0] for s in raw[:B]])).to(dev)
    with torch.no_grad():
        want = model.forward(x)
    path = os.path.join(tmp, "lm.bigdl")
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = Module.load(path, device=dev)
    load_s = time.perf_counter() - t0
    loaded.evaluate()
    with torch.no_grad():
        got = loaded.forward(x)
    check(torch.equal(got, want), "[15] (e) the loaded model's logits "
          "differ from the trained model's")
    del loaded
    os.remove(path)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    clone = model.clone()
    clone.training()
    LocalOptimizer(clone, raw[:B], LMCriterion(), SGD(learningrate=0.01),
                   max_iteration(1), batch_size=B, device=dev).optimize()
    check(_trees_equal(torch, model.state_dict(), before)
          and not _trees_equal(torch, clone.state_dict(), before),
          "[15] (e) stepping the clone moved the original (or nothing)")
    del clone
    pred = [Sample(s.features[0][:c["pred_T"]]) for s in
            _lm_samples(V, c["pred_n"], c["pred_T"], seed=5)]
    pds = DataSet.array(pred, FuncTransformer(lambda s: s))
    check(isinstance(pds, TransformedDataSet), "[15] (e) not chained")
    K.reset_launch_counts()
    out = model.predict(pds, B)
    with torch.no_grad():
        ref = torch.cat([model.forward(torch.from_numpy(np.stack(
            [s.features[0] for s in pred[i:i + B]])).to(dev)).cpu()
            for i in range(0, len(pred), B)]).numpy()
    perr = float(np.abs(out - ref).max())
    check(out.shape == ref.shape and perr <= 1e-5,
          f"[15] (e) predict {out.shape} against the per-batch forward "
          f"{ref.shape}: {perr}")
    print(f"[15] (e) save {save_s:.2f} s / load {load_s:.2f} s, logits bit "
          f"for bit; the clone stepped, the original unchanged; predict "
          f"over {len(pred)} samples at batch {B} (last batch ragged) "
          f"within {perr:.1e} of the per-batch forward", flush=True)
    model.training()
    del model, trained, before, init
    if dev == "cuda":
        torch.cuda.empty_cache()
    S, RB = c["image"], c["image_B"]
    rn = ResNet50(format="NHWC", fused="pallas", fused_conv2=True, seed=0,
                  device=dev)
    rng = np.random.RandomState(6)
    rn.set_extra_parameter([torch.from_numpy(
        (rng.rand(*t.shape) + 0.5).astype(np.float32))
        for t in rn.get_extra_parameter()])
    extra = rn.get_extra_parameter()
    imgs = rng.randn(RB, S, S, 3).astype(np.float32)
    rn.evaluate()
    sync()
    K.reset_launch_counts()
    classes = rn.predict_class(DataSet.array([Sample(i) for i in imgs]), RB)
    sync()
    pc_counts, pc_routes = K.launch_counts(), K.launches_by_route()
    with torch.no_grad():
        logits = rn.forward(torch.from_numpy(imgs).to(dev))
    want_cls = logits.argmax(-1).cpu().numpy() + 1
    check(np.array_equal(classes, want_cls),
          f"[15] (e) predict_class {classes} against argmax {want_cls}")
    if dev == "cuda":
        # one batch: 24 K3, 16 K4 and 12 K5 forwards, nothing else
        want = dict.fromkeys(K.WRAPPERS, 0)
        want.update(fused_matmul_fwd=24, fused_conv_fwd=16,
                    fused_chain_fwd=12)
        check(pc_counts == want
              and all(only_on(pc_routes[k], "f32_sm90", n)
                      for k, n in want.items() if n),
              f"[15] (e) predict_class launches {pc_counts} by route "
              f"{pc_routes}, expected {want} on f32_sm90")
    rn.set_extra_parameter([t * 0.5 for t in extra])
    rn.set_extra_parameter(extra)
    check(all(torch.equal(a, b) for a, b in
              zip(rn.get_extra_parameter(), extra)),
          "[15] (e) the extra parameters did not round-trip")
    print(f"[15] (e) ResNet-50 fused_conv2 float32 predict_class at "
          f"B{RB}/{S} equals argmax of the eval forward; launches "
          f"{ {k: v for k, v in pc_counts.items() if v} } by route "
          f"{ {k: {r: n for r, n in v.items() if n} for k, v in pc_routes.items() if any(v.values())} }"
          f"; {len(extra)} BatchNorm state leaves round-trip bit for bit",
          flush=True)
    r15["predict_class"] = pc_counts
    del rn
    if dev == "cuda":
        torch.cuda.empty_cache()

    # (f) the JAX package's public flash entries
    from bigdl_tpu_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(15)
    entries = {}
    entry_routes = {"flash_fwd": {}, "flash_bwd": {}}

    def add_routes(routes):
        for fn, acc in entry_routes.items():
            for r, n in routes[fn].items():
                acc[r] = acc.get(r, 0) + n
    for dtype, ftol, btol in ((torch.bfloat16, 1.6e-2, 1e-2),
                              (torch.float32, 2e-5, 1e-4)):
        q, k, v, do = [torch.randn(2, 16, 256, 64, device=dev, generator=g)
                       .to(dtype) for _ in range(4)]
        K.reset_launch_counts()
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = fa.flash_attention_fused(qq, kk, vv, causal=True)
        grads = torch.autograd.grad(o, (qq, kk, vv), do)
        sync()
        counts, routes = K.launch_counts(), K.launches_by_route()
        add_routes(routes)
        ro, _ = K.flash_fwd_reference(q, k, v, True)
        # the backward's plain version on the kernel's residuals, as in
        # phase 2
        ko, klse = K.flash_fwd(q, k, v, causal=True)
        rg = K.flash_bwd_reference(q, k, v, ko, klse, do, True)
        ferr = (o.float() - ro.float()).abs().max().item()
        mag = max(b.float().abs().max().item() for b in rg)
        berr = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(grads, rg))
        check(ferr <= ftol and berr <= btol * max(1.0, mag),
              f"[15] (f) flash_attention_fused {dtype}: forward {ferr}, "
              f"gradient {berr}")
        if dev == "cuda":
            check(counts["flash_fwd"] == 1 and counts["flash_bwd"] == 1,
                  f"[15] (f) flash_attention_fused launches {counts}")
        entries[f"fused {dtype}"] = {
            "fwd_err": ferr, "bwd_err": berr,
            "fwd": {r: n for r, n in routes["flash_fwd"].items() if n},
            "bwd": {r: n for r, n in routes["flash_bwd"].items() if n}}
    for dtype, ftol in ((torch.bfloat16, 1.6e-2), (torch.float32, 2e-5)):
        q = torch.randn(2, 16, 32, 64, device=dev, generator=g).to(dtype)
        k, v = [torch.randn(2, 16, 256, 64, device=dev, generator=g)
                .to(dtype) for _ in range(2)]
        K.reset_launch_counts()
        o = fa.flash_chunk_attention(q, k, v, 96, kv_len=128)
        sync()
        counts, routes = K.launch_counts(), K.launches_by_route()
        add_routes(routes)
        ro, _ = K.flash_fwd_reference(q, k, v, True, 96, 128)
        ferr = (o.float() - ro.float()).abs().max().item()
        check(ferr <= ftol, f"[15] (f) flash_chunk_attention {dtype}: "
              f"{ferr}")
        if dev == "cuda":
            check(counts["flash_fwd"] == 1, f"[15] (f) flash_chunk_attention "
                  f"launches {counts}")
        entries[f"chunk {dtype}"] = {
            "fwd_err": ferr,
            "fwd": {r: n for r, n in routes["flash_fwd"].items() if n}}
    print(f"[15] (f) the flash entries against the plain versions, "
          f"launches by route: {entries}", flush=True)
    r15.update(a0=ra0, a=ra, b=rb, c=rc, d=rd, flash_entries=entries,
               entry_routes=entry_routes,
               k1=sum(r["counts"]["flash_fwd"] for r in (ra0, ra, rb, rc, rd)),
               k1b=sum(r["counts"]["flash_bwd"] for r in (ra0, ra, rb, rc, rd)))
    for rec in (ra0, ra, rb, rc, rd):
        rec.pop("opt")
    r15["phase_s"] = time.perf_counter() - t15
    print(f"[15] phase 15: {r15['phase_s']:.1f} s", flush=True)
    return r15



# -- phase 16: the image input pipeline and ResNet-50's three fused arms ----------

# the sizes of phase 16 (a CPU rehearsal shrinks them): the example's
# defaults (examples/imagenet_folder_train.py: B256 at 224 from 256x256
# JPEGs, its mean / std, lr 0.05), the folder (classes x per_class), the
# measured steps of each arm, the arm-agreement batch, the validation
# folder and batch, and the small loaders' sizes
IMG16 = dict(B=256, S=224, src=256, classes=4, per_class=128, steps=4,
             agree_B=8, val_per_class=16, val_B=32, mnist_n=4096,
             mnist_B=128, mnist_iters=24, cifar_n=2048, cifar_B=128,
             cifar_iters=8, tfr_n=2000)
IMG_MEAN, IMG_STD = (124.0, 117.0, 104.0), (59.0, 57.0, 57.0)
# the three arms on one float32 batch (TF32 off, zero_init_residual off:
# with BN3's gamma at 0 every junction sits on the ReLU's kink, where
# K5's VJP passes no gradient and the written-out junction's max(u, 0)
# half), against the xla arm: the largest error over the largest value,
# the training gradients as the norm of all differences over the norm of
# all gradients. Training-mode gradients through the batch statistics are
# ill-conditioned: the port's own float32 and float64 runs of the xla arm
# on these inputs differ by a few percent in that norm and by up to a
# fifth on single stage-3 leaves, in evaluation mode by two orders of
# magnitude less (tools/torch_resnet_f32_spread.py, on the CPU)
AGREE_TOL = {"train_logits": 1e-3, "train_state": 1e-3, "train_grads": 0.1,
             "eval_logits": 1e-4, "eval_grads": 2e-2}
# the K3 / K5 launches of a training step of each arm (forwards; as many
# backwards)
ARM_LAUNCHES = {"xla": (0, 0), "pallas": (24, 12), "pallas_unchained": (36, 0)}


def _image_folder(root, classes, per_class, size, seed):
    """``root/c<k>/<i>.jpg``: per class a base colour with a bright bar at
    a class-dependent place, plus noise, written with the port's JPEG
    encoder. Returns ``scan_folder``'s (paths, labels, classes)."""
    from bigdl_tpu_torch.dataset.imagenet import scan_folder
    from bigdl_tpu_torch.native import encode_jpeg
    rng = np.random.RandomState(seed)
    for c in range(classes):
        d = os.path.join(root, f"c{c}")
        os.makedirs(d)
        base = np.zeros((size, size, 3), np.float32)
        base[:] = 40 + 50 * c
        lo = c * size // classes
        base[lo:lo + size // (2 * classes), :, c % 3] = 230
        for i in range(per_class):
            img = np.clip(base + rng.randn(size, size, 3) * 20, 0, 255)
            with open(os.path.join(d, f"{i:04d}.jpg"), "wb") as f:
                f.write(encode_jpeg(img.astype(np.uint8), 90))
    return scan_folder(root)


def _relayout(torch, src, dst):
    """``dst`` with ``src``'s weights and statistics: the arms' layouts
    (chained or not) list the same tensors in the same order."""
    a, b = src.state_dict(), dst.state_dict()
    check([tuple(v.shape) for v in a.values()]
          == [tuple(v.shape) for v in b.values()], "arm layouts differ")
    dst.load_state_dict(dict(zip(b, a.values())))
    return dst


def _arm(fused, chain, **kw):
    from bigdl_tpu_torch.models import ResNet
    return ResNet(format="NHWC", fused=fused, fused_chain=chain, **kw)


def image_pipeline(torch, K, card, dev="cuda", tmp=None):
    """Phase 16: the port's image input pipeline into ResNet-50's three
    fused arms, the counterpart of ``examples/imagenet_folder_train.py``
    at its defaults: (a) an image folder written with ``encode_jpeg`` (4
    classes of 128 JPEGs at 256x256) through
    ``JpegFolderPrefetcher(out="bf16_nhwc", augment=True,
    stage_to_device=True)`` into the bf16 recipe (float32 masters,
    ``bf16_params``, SGD(0.05, momentum=0.9)) at B256/224 under
    ``fused="xla"``, ``fused="pallas"`` chained and unchained: per arm the
    step ms, images/s, peak memory, the host's decode images/s, the share
    of the step spent in ``pf_next`` and the K3 / K4 / K5 launches a step
    (24 K3 + 12 K5 chained, 36 + 0 unchained, none for ``"xla"``, each
    forward and backward); without libjpeg in the native build it says so
    and feeds the arms from ``NativePrefetcher`` over raw uint8 arrays;
    (b) the three arms on one float32 batch (TF32 off) with the same
    weights: logits and every parameter gradient against the ``"xla"``
    arm's; (c) ``ImageNetDataSet(train=False)``'s Python pipeline into the
    evaluation of the chained model with ``fused_conv2`` (K3 / K4 / K5 on
    their no-statistics path) against the ``"xla"`` arm's logits,
    ``NativePrefetcher`` over MNIST / CIFAR ``synthetic`` arrays training
    LeNet-5 and ResNetCifar-20 through ``LocalOptimizer``, and
    ``read_tfrecords_native`` against the Python reader."""
    import shutil
    import tempfile
    import bigdl_tpu_torch.observability as obs
    from bigdl_tpu_torch import native, nn
    from bigdl_tpu_torch.convert import flatten, unflatten
    from bigdl_tpu_torch.dataset import cifar, mnist, tfrecord
    from bigdl_tpu_torch.dataset.imagenet import ImageNetDataSet
    from bigdl_tpu_torch.models import LeNet5, ResNetCifar
    from bigdl_tpu_torch.nn.module import assign_state
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Trigger,
                                       max_iteration)
    from bigdl_tpu_torch.utils.amp import bf16_params
    t16 = time.perf_counter()
    on_card = dev == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = IMG16
    B, S = cfg["B"], cfg["S"]
    root = tempfile.mkdtemp(prefix="phase16_", dir=tmp)
    r16 = {"launches": {"bf16": dict.fromkeys(K.WRAPPERS, 0),
                        "f32": dict.fromkeys(K.WRAPPERS, 0),
                        "eval": dict.fromkeys(K.WRAPPERS, 0)}}

    def add(kind, counts):
        for n, v in counts.items():
            r16["launches"][kind][n] += v

    # -- (a) the folder, the prefetcher, the three arms ----------------------
    jpeg = native.jpeg_available()
    workers = min(16, max(4, os.cpu_count() or 1))
    t0 = time.perf_counter()
    if jpeg:
        paths, labels, classes = _image_folder(
            os.path.join(root, "train"), cfg["classes"], cfg["per_class"],
            cfg["src"], 0)
        pf = native.JpegFolderPrefetcher(
            paths, labels, S, S, IMG_MEAN, IMG_STD, batch_size=B,
            n_workers=workers, queue_capacity=4, out="bf16_nhwc",
            augment=True, stage_to_device=True, device=dev)
        what = (f"{len(paths)} JPEGs ({cfg['classes']} classes, "
                f"{cfg['src']}x{cfg['src']}) through JpegFolderPrefetcher "
                f"(bf16 NHWC, augmented, pinned staging), {workers} workers")
    else:
        n = cfg["classes"] * cfg["per_class"]
        rng = np.random.RandomState(0)
        raw = rng.randint(0, 256, size=(n, 3, S, S)).astype(np.uint8)
        raw_labels = rng.randint(1, cfg["classes"] + 1, size=n)
        pf = native.NativePrefetcher(
            raw, raw_labels, IMG_MEAN, IMG_STD, batch_size=B,
            n_workers=workers, queue_capacity=4, stage_to_device=True,
            device=dev)
        print("[16] (a) the native library was built WITHOUT libjpeg on this "
              "machine: no JPEG is decoded; the arms are fed from "
              "NativePrefetcher over raw uint8 arrays (float32 CHW, cast to "
              "bf16 NHWC on the card)", flush=True)
        what = (f"{n} raw uint8 images through NativePrefetcher (float32 "
                f"CHW, pinned staging), {workers} workers")
    write_s = time.perf_counter() - t0
    bpe = pf.batches_per_epoch()
    check(bpe >= 2, f"[16] (a) {bpe} batches an epoch, want at least 2")
    print(f"[16] the image pipeline and ResNet-50's fused arms ({card}): "
          f"{what}; data written in {write_s:.1f} s, {bpe} batches an "
          f"epoch", flush=True)

    def batches():
        """(x bf16 NHWC, y int64) on the device for every step, epochs
        looped in one worker run."""
        for mb in pf.data(train=True, loop_epochs=
                          (cfg["steps"] + 1) // bpe + 1):
            x, y = mb.get_input(), mb.get_target()
            check(x.device.type == torch.device(dev).type,
                  f"[16] (a) a staged batch on {x.device}")
            if not jpeg:                        # float32 CHW
                x = x.permute(0, 2, 3, 1).to(torch.bfloat16)
            yield x, y.long()

    def decode_rate():
        """Images a second through the host pipeline alone (one epoch,
        decode and staging, no model)."""
        sync()
        t0 = time.perf_counter()
        n = 0
        for mb in pf.data(train=True):
            n += len(mb.get_target())
        sync()
        return n / (time.perf_counter() - t0)

    obs.enable()
    wait = obs.histogram("dataset/native_next_wait_s", unit="s")
    crit = nn.CrossEntropyCriterion()
    arms = (("xla", "xla", True), ("pallas", "pallas", True),
            ("pallas_unchained", "pallas", False))
    fused = ("fused_matmul_fwd", "fused_matmul_bwd", "fused_chain_fwd",
             "fused_chain_bwd", "fused_conv_fwd")
    trained = {}
    for name, arm_fused, chain in arms:
        model = _arm(arm_fused, chain, class_num=cfg["classes"], device=dev,
                     seed=0)
        params, mstate = model.params, model.state
        leaves = flatten(params)
        optim = SGD(learningrate=0.05, momentum=0.9)
        opt_state = optim.init_state(params)
        k3, k5 = ARM_LAUNCHES[name]
        want = dict.fromkeys(K.WRAPPERS, 0)
        want.update(fused_matmul_fwd=k3, fused_matmul_bwd=k3,
                    fused_chain_fwd=k5, fused_chain_bwd=k5)
        rate = decode_rate()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        losses, times, waits, per_step = [], [], [], None
        it = batches()
        for i in range(cfg["steps"] + 1):
            sync()
            K.reset_launch_counts()
            w0 = wait.total
            t0 = time.perf_counter()
            x, y = next(it)
            out, new_state = model.apply(bf16_params(params), mstate, x,
                                         training=True)
            loss = crit._forward(out.float(), y)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            optim.update(unflatten(dict(zip(leaves, grads))), params,
                         opt_state, 0.05)
            assign_state(mstate, new_state)
            sync()
            dt = time.perf_counter() - t0
            counts = K.launch_counts()
            losses.append(loss.item())
            if on_card:
                check(counts == want, f"[16] (a) {name} step launched "
                      f"{counts}, expected {want}")
                routes = K.launches_by_route()
                check(all(only_on(routes[n], "bf16_sm90", want[n])
                          for n in fused),
                      f"[16] (a) {name} launches by route {routes}")
            add("bf16", counts)
            per_step = {"K3": counts["fused_matmul_fwd"],
                        "K4": counts["fused_conv_fwd"],
                        "K5": counts["fused_chain_fwd"]}
            if i > 0:                           # step 0 is the warmup
                times.append(dt)
                waits.append(wait.total - w0)
        it.close()
        check(all(math.isfinite(v) for v in losses),
              f"[16] (a) {name} losses {losses}")
        step = statistics.median(times)
        rec = {"losses": losses, "step_ms": step * 1e3,
               "step_ms_all": [t * 1e3 for t in times],
               "images_per_s": B / step, "decode_images_per_s": rate,
               "wait_share": sum(waits) / sum(times),
               "max_mem_gb": (torch.cuda.max_memory_allocated() / 2**30
                              if on_card else float("nan")),
               "launches_a_step": per_step}
        r16[name] = rec
        print(f"[16] (a) {name}: losses {[round(v, 4) for v in losses]}; "
              f"step {rec['step_ms']:.1f} ms (median of {len(times)}; all "
              f"{[round(t, 1) for t in rec['step_ms_all']]}) = "
              f"{rec['images_per_s']:.1f} images/s; peak memory "
              f"{rec['max_mem_gb']:.2f} GiB; host decode "
              f"{rate:.1f} images/s; waiting in pf_next "
              f"{rec['wait_share']:.1%} of the step; launches a step "
              f"(forward, as many backward) {per_step}", flush=True)
        trained[name] = {k: v.detach().clone()
                         for k, v in model.state_dict().items()}
        del model, params, mstate, leaves, opt_state, grads, out
        if on_card:
            torch.cuda.empty_cache()
    obs.disable()
    del pf

    # -- (b) the three arms on one float32 batch ------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(16)
    xb = torch.from_numpy(rng.randn(cfg["agree_B"], S, S, 3).astype(
        np.float32)).to(dev)
    yb = torch.from_numpy(rng.randint(1, 1001, size=cfg["agree_B"])).to(dev)
    ref_model = _arm("xla", True, zero_init_residual=False, device=dev,
                     seed=5)
    agree = {}
    for name, arm_fused, chain in arms:
        model = _relayout(torch, ref_model, _arm(
            arm_fused, chain, zero_init_residual=False, device=dev, seed=0))
        params = model.params
        leaves = flatten(params)
        k3, k5 = ARM_LAUNCHES[name]
        got = {}
        for training in (True, False):
            sync()
            K.reset_launch_counts()
            out, ns = model.apply(params, model.state, xb, training=training)
            loss = crit._forward(out, yb)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            sync()
            counts = K.launch_counts()
            if on_card:
                check(counts["fused_matmul_fwd"] == counts["fused_matmul_bwd"]
                      == k3 and counts["fused_chain_fwd"] == k5
                      and counts["fused_chain_bwd"] == k5,
                      f"[16] (b) {name} launched {counts}")
            # training forwards with sums on the _f32 rows, evaluation
            # forwards (no sums) on the _eval rows, every backward on _f32
            add("f32", counts if training else {
                n: v for n, v in counts.items() if n.endswith("_bwd")})
            if not training:
                add("eval", {n: v for n, v in counts.items()
                             if n.endswith("_fwd")})
            got[training] = (out.detach(), [g.detach() for g in grads],
                             [v.detach() for v in flatten(ns).values()])
        agree[name] = got
        del model, params, leaves
    del ref_model

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()

    def norm_rel(a, b):     # over all the gradients at once
        num = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
        return math.sqrt(num / sum(float((y ** 2).sum()) for y in b))
    r16["agree"] = {}
    for name in ("pallas", "pallas_unchained"):
        (to, tg, ts), (eo, eg, _) = agree[name][True], agree[name][False]
        (rto, rtg, rts), (reo, reg, _) = agree["xla"][True], \
            agree["xla"][False]
        errs = {"train_logits": rel(to, rto),
                "train_state": max(rel(a, b) for a, b in zip(ts, rts)),
                "train_grads": norm_rel(tg, rtg),
                "eval_logits": rel(eo, reo),
                "eval_grads": max(rel(a, b) for a, b in zip(eg, reg))}
        r16["agree"][name] = errs
        for what, tol in AGREE_TOL.items():
            check(errs[what] <= tol, f"[16] (b) {name} against xla: {what} "
                  f"{errs[what]} > {tol}")
    print(f"[16] (b) the three arms on one float32 B{cfg['agree_B']}/{S} "
          f"batch, TF32 off, the same weights, against fused='xla' "
          f"(largest error over the largest value; training gradients: the "
          f"norm of all the differences over the norm of all the "
          f"gradients): {r16['agree']} (limits {AGREE_TOL})", flush=True)
    del agree

    # -- (c) validation through ImageNetDataSet's Python pipeline ------------
    val = os.path.join(root, "val")
    if jpeg:
        _image_folder(val, cfg["classes"], cfg["val_per_class"], cfg["src"],
                      1)
    vds = ImageNetDataSet(val if jpeg else None, cfg["val_B"], train=False,
                          crop_size=S, n_synthetic=cfg["classes"]
                          * cfg["val_per_class"])
    source = ("the folder, decoded by the native libjpeg codec"
              if vds.paths is not None else "the synthetic stand-in (no "
              "decoder on this machine)")
    chained = _arm("pallas", True, fused_conv2=True,
                   class_num=cfg["classes"], device=dev, seed=0)
    chained.load_state_dict(trained["pallas"])
    plain = _relayout(torch, chained, _arm("xla", True,
                                           class_num=cfg["classes"],
                                           device=dev, seed=0))
    t0 = time.perf_counter()
    correct = seen = 0
    verr = 0.0
    evals = dict.fromkeys(K.WRAPPERS, 0)
    with torch.no_grad():
        for mb in vds.data(train=False):
            x = torch.from_numpy(mb.get_input()).permute(0, 2, 3, 1) \
                .contiguous().to(dev)
            y = torch.from_numpy(mb.get_target()).to(dev)
            sync()
            K.reset_launch_counts()
            out, _ = chained.apply(chained.params, chained.state, x)
            sync()
            counts = K.launch_counts()
            if on_card:
                check(counts["fused_matmul_fwd"] == 24
                      and counts["fused_chain_fwd"] == 12
                      and counts["fused_conv_fwd"] == 16
                      and counts["fused_matmul_bwd"] == 0,
                      f"[16] (c) evaluation launched {counts}")
                routes = K.launches_by_route()
                check(only_on(routes["fused_matmul_fwd"], "f32_sm90", 24),
                      f"[16] (c) evaluation routes {routes}")
            for n, v in counts.items():
                evals[n] += v
            want, _ = plain.apply(plain.params, plain.state, x)
            verr = max(verr, rel(out, want))
            correct += int((out.argmax(1) + 1 == y.long()).sum())
            seen += len(y)
    add("eval", evals)
    check(seen == vds.batches_per_epoch() * cfg["val_B"] and
          verr <= AGREE_TOL["eval_logits"],
          f"[16] (c) validation: {seen} images, logits against xla {verr}")
    r16["val"] = {"images": seen, "top1": correct / seen, "err": verr,
                  "s": time.perf_counter() - t0, "launches": evals}
    print(f"[16] (c) validation of the chained model (fused_conv2, float32) "
          f"on {seen} images of {source} through ImageNetDataSet(train="
          f"False): top-1 {correct / seen:.3f}, logits within {verr:.2e} of "
          f"the xla arm's, {r16['val']['s']:.2f} s; launches {evals}",
          flush=True)
    del chained, plain, trained

    # LeNet-5 and ResNetCifar-20 fed by NativePrefetcher (the counterparts
    # of examples/lenet_mnist.py and resnet_cifar10.py)
    small = {}
    for name, (imgs, labels), mean, std, make, crit_s, method, bs, iters in (
            ("lenet5", mnist.synthetic(cfg["mnist_n"]), [mnist.TRAIN_MEAN],
             [mnist.TRAIN_STD], lambda: LeNet5(10, device=dev, seed=1),
             nn.ClassNLLCriterion(),
             SGD(learningrate=0.05, learningrate_decay=0.0002),
             cfg["mnist_B"], cfg["mnist_iters"]),
            ("resnet_cifar20", cifar.synthetic(cfg["cifar_n"]),
             cifar.TRAIN_MEAN, cifar.TRAIN_STD,
             lambda: ResNetCifar(10, 20, device=dev, seed=1),
             nn.CrossEntropyCriterion(),
             SGD(learningrate=0.1, momentum=0.9, weightdecay=1e-4,
                 nesterov=True), cfg["cifar_B"], cfg["cifar_iters"])):
        spf = native.NativePrefetcher(imgs, labels, mean, std,
                                      batch_size=bs, n_workers=workers,
                                      stage_to_device=name != "lenet5",
                                      device=dev)
        seen_losses = []
        stop = max_iteration(iters)
        end = Trigger(lambda st: seen_losses.append(st["loss"]) or stop(st))
        opt = LocalOptimizer(make(), spf, crit_s, method, end, bs,
                             device=dev)
        sync()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        opt.optimize()
        sync()
        wall = time.perf_counter() - t0
        check(set(K.launch_counts().values()) == {0},
              f"[16] (c) {name} launched a port kernel")
        check(len(seen_losses) == iters
              and all(math.isfinite(v) for v in seen_losses),
              f"[16] (c) {name} losses {seen_losses}")
        if name == "lenet5":
            check(seen_losses[-1] < seen_losses[0],
                  f"[16] (c) LeNet-5's loss did not fall: {seen_losses}")
        small[name] = {"losses": seen_losses, "s": wall,
                       "images_per_s": iters * bs / wall}
        print(f"[16] (c) {name} from NativePrefetcher "
              f"({'pinned staging' if name != 'lenet5' else 'host batches'}"
              f"), B{bs}, {iters} iterations: losses "
              f"{[round(v, 3) for v in seen_losses[::max(1, iters // 6)]]}"
              f"...{seen_losses[-1]:.3f}; {wall:.2f} s = "
              f"{small[name]['images_per_s']:.0f} images/s (with the first "
              f"step)", flush=True)
    r16["small"] = small

    # TFRecord: the C++ reader against the Python one
    rng = np.random.RandomState(7)
    recs = [tfrecord.make_example({"features": rng.rand(64).astype(
        np.float32), "label": np.array([i % 10 + 1])})
        for i in range(cfg["tfr_n"])]
    tp = os.path.join(root, "data.tfrecord")
    tfrecord.write_tfrecords(tp, recs)
    t0 = time.perf_counter()
    got = native.read_tfrecords_native(tp)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = list(tfrecord.read_tfrecords(tp, use_native=False))
    t_py = time.perf_counter() - t0
    check(got == want == recs, "[16] (c) read_tfrecords_native differs "
          "from the Python reader")
    mb = os.path.getsize(tp) / 1e6
    print(f"[16] (c) TFRecord: {len(got)} records ({mb:.2f} MB), the C++ "
          f"reader equal to the Python one; {mb / t_native:.0f} against "
          f"{mb / t_py:.1f} MB/s", flush=True)
    shutil.rmtree(root)
    r16["phase_s"] = time.perf_counter() - t16
    print(f"[16] phase 16: {r16['phase_s']:.1f} s; launches: bf16 "
          f"{ {n: v for n, v in r16['launches']['bf16'].items() if v} }, "
          f"float32 { {n: v for n, v in r16['launches']['f32'].items() if v} }"
          f", evaluation "
          f"{ {n: v for n, v in r16['launches']['eval'].items() if v} }",
          flush=True)
    return r16


# -- phase 17: the MoE LM, graph containers, recommenders and detection ---------

# bench_extra.py bench_moe_lm at its TPU sizes: the flagship's widths, 8
# experts on every second block, B8/T1024, bf16 recipe
MOE_LM = dict(vocab_size=32000, hidden_size=1024, num_heads=16,
              filter_size=4096, num_layers=12, n_experts=8, moe_every=2,
              capacity_factor=1.25, max_len=1024)
MOE17 = dict(B=8, T=1024, warmup=2, steps=5, gen=(8, 128, 32), cpu_T=128,
             route_t=8192, route_E=8)
# MovieLens-1M's counts (users, items, ratings) and the example's training
# (examples/ncf_movielens.py: batch 256, Adam(0.02), BCECriterion)
ML1M = (6040, 3706, 1000209)
REC17 = dict(batch=256, steps=300, eval_k=10)
# SSD300 on VOC (21 classes): each source map's (size, min, max, extra
# aspect ratios, step), 8732 priors in all
SSD300 = [(38, 30, 60, (2,), 8), (19, 60, 111, (2, 3), 16),
          (10, 111, 162, (2, 3), 32), (5, 162, 213, (2, 3), 64),
          (3, 213, 264, (2,), 100), (1, 264, 315, (2,), 300)]
DET17 = dict(ssd_batch=8, classes=21, frcnn_map=(38, 50), frcnn_c=512,
             rois=300, im=(600, 800))
MOE_TOL = 1e-4          # card against CPU, float32 with TF32 off


def movielens_split_start(root, tmp):
    """Start MovieLens' leave-one-out split at ML-1M's counts in a process
    of its own (a few minutes of host work, overlapped with phases 2-16);
    it writes an ``.npz`` into ``tmp``. Returns (process, path)."""
    path = os.path.join(tmp, "ml1m_split.npz")
    code = ("import sys, numpy as np\n"
            f"sys.path.insert(0, {root!r})\n"
            "from bigdl_tpu_torch.dataset import movielens as m\n"
            f"d = m.synthetic(*{ML1M!r}, seed=0)\n"
            "tr, y, eu, ei = m.train_test_split_leave_one_out(d)\n"
            f"np.savez({path!r}, n=len(d), train=tr, labels=y, "
            "ev_users=eu, ev_items=ei)\n")
    return subprocess.Popen([sys.executable, "-c", code]), path


def moe_recipe(torch, K, model, init, x, y, remat, warmup, steps):
    """bench_extra.py bench_moe_lm's step: float32 masters cast to bf16
    inside the loss, ``hidden_states(training=True)`` -> (h, aux),
    ``lm_loss_chunked(chunk=128) + 0.01 aux``, gradients to the masters,
    SGD(0.01, momentum=0.9) in place; ``warmup`` steps, then ``steps``
    timed, on one batch, the launches read per step."""
    from bigdl_tpu_torch.convert import flatten, unflatten
    from bigdl_tpu_torch.models import lm_loss_chunked
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.amp import bf16_params
    model.load_state_dict(init)
    model.remat = remat
    params = model.params
    leaves = flatten(params)
    optim = SGD(learningrate=0.01, momentum=0.9)
    opt_state = optim.init_state(params)

    def step():
        p16 = bf16_params(params)
        h, aux = model.hidden_states(p16, x, training=True)
        loss = lm_loss_chunked(h, p16["embed"], y, chunk=128) \
            + 0.01 * aux.float()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        optim.update(unflatten(dict(zip(leaves, grads))), params, opt_state,
                     0.01)
        return loss, grads

    L = len(model.blocks)
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(flash_fwd=2 * L if remat else L, flash_bwd=L)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, total = [], [], dict.fromkeys(K.WRAPPERS, 0)
    for i in range(warmup + steps):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts, routes = K.launch_counts(), K.launches_by_route()
        check(counts == want, f"[17] (a) MoE LM step (remat={remat}) "
              f"launched {counts}, expected {want}")
        check(all(only_on(routes[n], "bf16_sm90", want[n])
                  for n in ("flash_fwd", "flash_bwd")),
              f"[17] (a) MoE LM step (remat={remat}): flash launches by "
              f"route {routes}, all expected on bf16_sm90")
        check(torch.stack([torch.isfinite(g).all() for g in grads])
              .all().item(), f"[17] (a) non-finite gradient "
              f"(remat={remat})")
        losses.append(loss.item())
        for n in total:
            total[n] += counts[n]
        if i >= warmup:
            times.append(dt)
    check(all(math.isfinite(v) for v in losses),
          f"[17] (a) non-finite loss {losses}")
    check(losses[-1] < losses[0], f"[17] (a) loss did not fall: {losses}")
    return {"losses": losses, "step_s": statistics.median(times),
            "step_s_all": times,
            "max_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "launches": total,
            "per_step": {n: routes[n] for n in ("flash_fwd", "flash_bwd")}}


@contextlib.contextmanager
def routing_recorder(stats):
    """Record each MoE layer's routing (tokens dropped, slots holding more
    than one token, the fullest slot) while the block runs."""
    from bigdl_tpu_torch.nn import moe as nn_moe
    real = nn_moe.top1_routing

    def rec(logits, capacity):
        d, c, a = real(logits, capacity)
        occ = d.float().sum(0)
        stats.append({"tokens": logits.shape[0], "capacity": capacity,
                      "dropped": int(logits.shape[0] - occ.sum().item()),
                      "shared": int((occ > 1).sum().item()),
                      "fullest": int(occ.max().item())})
        return d, c, a
    nn_moe.top1_routing = rec
    try:
        yield stats
    finally:
        nn_moe.top1_routing = real


def _ms_calls(torch, fn, n=3):
    """Median wall ms of ``n`` calls of ``fn`` (synchronized)."""
    out, times = None, []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def _ssd_priors(nn, dev):
    """SSD300's six PriorBox layers over their maps: (1, 2, 8732 * 4)."""
    import torch
    maps = []
    for size, lo, hi, ars, step in SSD300:
        pb = nn.PriorBox([lo], [hi], list(ars), is_flip=True, is_clip=False,
                         variances=[0.1, 0.1, 0.2, 0.2], img_size=300,
                         step=float(step))
        maps.append(pb.call({}, torch.zeros((1, 1, size, size),
                                            device=dev)))
    return torch.cat(maps, 2)


def moe_zoo(torch, K, card, split=None, dev="cuda"):
    """Phase 17 (``examples`` and bench counterparts of the recommender and
    detection slice): (a) the MoE LM at ``bench_moe_lm``'s full width
    through its bf16 recipe, remat off and on, ``MOE17['warmup']`` + 5
    timed steps each, with the K1 launches a step by route and each MoE
    layer's routing (dropped tokens, shared slots); (b) ``generate`` at
    batch 8, prompt 128, 32 new tokens, and the full-width model at depth
    2 in float32 (TF32 off) against the CPU; (c) ``top1_routing`` on bf16
    logits at 8192 tokens over 8 experts, card against CPU bit for bit;
    (d) NeuralCF and Wide&Deep at the example's widths on MovieLens'
    synthetic stand-in at ML-1M's counts through ``LocalOptimizer``, then
    HitRatio@10 / NDCG@10, and one batch card against CPU; (e) LeNet-5 as a
    ``Graph`` against its ``Sequential`` twin and a ``DynamicGraph`` with
    ``Switch`` / ``Merge`` down both branches; (f) SSD300-VOC's
    post-processing and Faster R-CNN VGG-16's test-time heads at their
    published sizes, each card against CPU. Returns the launches and
    timings."""
    import copy
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.models import (LeNet5, MoETransformerLM, NeuralCF,
                                        WideAndDeep)
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.optim.validation import HitRatio, NDCG
    from bigdl_tpu_torch.parallel import moe as pmoe
    from bigdl_tpu_torch.utils.amp import bf16_params
    from bigdl_tpu_torch.utils.table import Table
    t17 = time.perf_counter()
    r17 = {}
    cfg = MOE17
    B, T = cfg["B"], cfg["T"]
    # the bf16 flash pair at the MoE LM's attention shape
    H = MOE_LM["num_heads"]
    D = MOE_LM["hidden_size"] // H
    r17["k1"] = flash_case(torch, K, B, H, T, T, D, torch.bfloat16, True, 0,
                           T, timed=True)
    r17["k1b"] = bwd_case(torch, K, B, H, T, D, torch.bfloat16, True,
                          timed=True)

    # -- (a) the MoE LM through the bf16 recipe ----------------------------
    t0 = time.perf_counter()
    model = MoETransformerLM(**MOE_LM, device=dev, seed=0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    L = len(model.blocks)
    print(f"[17] {card}: MoETransformerLM V{MOE_LM['vocab_size']} H"
          f"{MOE_LM['hidden_size']} heads {MOE_LM['num_heads']} F"
          f"{MOE_LM['filter_size']} L{L} E{MOE_LM['n_experts']} (MoE blocks "
          f"{sorted(model.moe_idx)}), {n_params / 1e6:.1f}M params, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ids = np.random.RandomState(0).randint(1, MOE_LM["vocab_size"],
                                           (B, T + 1))
    x = torch.from_numpy(ids[:, :-1]).to(dev)
    y = torch.from_numpy(ids[:, 1:]).to(dev)
    arms = []
    for remat in (False, True):
        r = moe_recipe(torch, K, model, init, x, y, remat, cfg["warmup"],
                       cfg["steps"])
        r["tokens_per_s"] = B * T / r["step_s"]
        arms.append(r)
        print(f"[17] (a) {card}: bf16 recipe B{B}/T{T}, remat={remat}: "
              f"losses {[round(v, 4) for v in r['losses']]}; step "
              f"{r['step_s'] * 1e3:.1f} ms (median of {cfg['steps']} after "
              f"{cfg['warmup']} warm-up; all "
              f"{[round(t * 1e3, 1) for t in r['step_s_all']]}) = "
              f"{r['tokens_per_s']:.0f} tokens/s; peak memory "
              f"{r['max_mem_gb']:.2f} GiB; K1 launches a step by route "
              f"{r['per_step']}", flush=True)
    check(abs(arms[0]["losses"][0] - arms[1]["losses"][0])
          <= 1e-3 * abs(arms[0]["losses"][0]),
          f"[17] (a) remat changed the first loss: "
          f"{arms[0]['losses'][0]} / {arms[1]['losses'][0]}")
    stats = []
    with torch.no_grad(), routing_recorder(stats):
        model.load_state_dict(init)
        model.hidden_states(bf16_params(model.params), x)
    print(f"[17] (a) routing of the first batch (bf16, capacity "
          f"{stats[0]['capacity']} of {stats[0]['tokens']} tokens an "
          f"expert queue): per MoE layer (dropped tokens, shared slots, "
          f"fullest slot) {[(s['dropped'], s['shared'], s['fullest']) for s in stats]}",
          flush=True)
    r17["arms"] = arms
    r17["routing"] = stats

    # -- (b) generate, and depth 2 in float32 against the CPU -------------
    bg, tp, new = cfg["gen"]
    with torch.no_grad():
        model.load_state_dict(init)
        p16 = bf16_params(model.params)
    prompt = np.random.RandomState(1).randint(1, MOE_LM["vocab_size"],
                                              (bg, tp))
    model.generate(p16, prompt[:, :16], 2)            # library warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(p16, prompt, new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gen_counts, gen_routes = K.launch_counts(), K.launches_by_route()
    check(tuple(out.shape) == (bg, tp + new)
          and torch.equal(out[:, :tp].cpu(), torch.from_numpy(prompt)),
          f"[17] (b) generate gave {tuple(out.shape)} or lost the prompt")
    check(gen_counts["flash_fwd"] == L
          and only_on(gen_routes["flash_fwd"], "bf16_sm90", L),
          f"[17] (b) generate's flash launches {gen_routes['flash_fwd']}, "
          f"expected {L} on bf16_sm90 (one prefill a layer)")
    r17["gen_flash"] = gen_counts["flash_fwd"]
    print(f"[17] (b) {card}: generate B{bg}, prompt {tp}, {new} new tokens: "
          f"{dt:.3f} s = {bg * new / dt:.1f} tokens/s (prefill included); "
          f"K1-fwd launches {gen_counts['flash_fwd']} "
          f"({gen_routes['flash_fwd']})", flush=True)
    del model, init, p16, arms
    torch.cuda.empty_cache()
    small = dict(MOE_LM, num_layers=2)
    ids_s = np.random.RandomState(2).randint(1, MOE_LM["vocab_size"],
                                             (1, cfg["cpu_T"]))
    logits = {}
    for d in (dev, "cpu"):
        m = MoETransformerLM(**small, device=d, seed=0)
        with torch.no_grad():
            logits[d], st = m.apply(m.params, m.state, ids_s)
            logits[d] = logits[d].float().cpu()
    err = _rel_err(logits[dev], logits["cpu"])
    check(math.isfinite(err) and err <= MOE_TOL,
          f"[17] (b) depth-2 float32 logits: card against CPU {err}")
    print(f"[17] (b) {card}: depth 2, float32, B1/T{cfg['cpu_T']}: logits "
          f"card against CPU {err:.3g} (tol {MOE_TOL})", flush=True)

    # -- (c) routing on the card against the CPU, bit for bit --------------
    t, E = cfg["route_t"], cfg["route_E"]
    cap = pmoe.expert_capacity(t, E, 1.25)
    lg = torch.from_numpy(np.random.RandomState(0).randn(t, E).astype(
        np.float32)).bfloat16()
    res = {d: [v.cpu() for v in pmoe.top1_routing(lg.to(d), cap)]
           for d in (dev, "cpu")}
    same = all(torch.equal(a, b) for a, b in zip(res[dev], res["cpu"]))
    occ = res[dev][0].float().sum(0)
    pos_same = torch.equal(res[dev][0].float().argmax(-1),
                           res["cpu"][0].float().argmax(-1))
    r17["route"] = {"same": same, "shared": int((occ > 1).sum()),
                    "fullest": int(occ.max())}
    print(f"[17] (c) {card}: top1_routing bf16, t={t}, E={E}, C={cap}: "
          f"dispatch, combine and aux card == CPU bit for bit: {same}; "
          f"positions equal: {pos_same}; slots holding more than one token "
          f"{r17['route']['shared']}, fullest {r17['route']['fullest']}",
          flush=True)
    check(same and pos_same, "[17] (c) routing differs between card and CPU")

    # -- (d) the recommenders ----------------------------------------------
    if isinstance(split, tuple):
        proc, path = split
        t0 = time.perf_counter()
        check(proc.wait(timeout=900) == 0, "[17] (d) the MovieLens split "
              "process failed")
        waited = time.perf_counter() - t0
        with np.load(path) as z:
            split = {k: z[k] for k in z.files}
        os.remove(path)
        print(f"[17] (d) MovieLens split (ML-1M counts, run beside phases "
              f"2-16) ready; waited {waited:.1f} s for it", flush=True)
    n_users, n_items = ML1M[0], ML1M[1]
    train, labels = split["train"], split["labels"]
    ev_users, ev_items = split["ev_users"], split["ev_items"]
    rc = REC17
    n_take = rc["batch"] * rc["steps"]
    take = np.random.RandomState(0).choice(len(train), n_take,
                                           replace=False)
    samples = [Sample(train[i].astype(np.float32),
                      np.float32(labels[i])) for i in take]
    builds = {"NeuralCF": lambda d: NeuralCF(n_users + 1, n_items + 1, 8, 16,
                                             (32, 16, 8), device=d),
              "WideAndDeep": lambda d: WideAndDeep(n_users + 1, n_items + 1,
                                                   16, device=d)}
    r17["rec"] = {}
    for name, build in builds.items():
        model = build(dev)
        losses = []
        stop = max_iteration(rc["steps"])
        end = Trigger(lambda st: losses.append(st["loss"]) or stop(st))
        opt = LocalOptimizer(model, DataSet.array(samples),
                             nn.BCECriterion(), Adam(learningrate=0.02),
                             end, batch_size=rc["batch"], device=dev)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(set(K.launch_counts().values()) == {0},
              f"[17] (d) {name} launched a port kernel")
        steps_s = opt.metrics.values["step_time"]
        step_ms = statistics.median(steps_s[1:]) * 1e3
        check(len(losses) == rc["steps"]
              and all(math.isfinite(v) for v in losses)
              and np.mean(losses[-20:]) < np.mean(losses[:20]),
              f"[17] (d) {name} losses {losses[:5]}...{losses[-5:]}")
        model.evaluate()
        pairs = np.stack([np.repeat(ev_users, ev_items.shape[1]),
                          ev_items.reshape(-1)], 1).astype(np.float32)
        with torch.no_grad():
            scores = model.forward(torch.from_numpy(pairs).to(dev))
        scores = scores.float().cpu().numpy().reshape(ev_items.shape)
        target = np.zeros(ev_items.shape[1], np.float32)
        target[0] = 1
        hr = HitRatio(rc["eval_k"], ev_items.shape[1] - 1)
        nd = NDCG(rc["eval_k"], ev_items.shape[1] - 1)
        hr_res = nd_res = None
        for row in scores:
            a, b = hr(row, target), nd(row, target)
            hr_res = a if hr_res is None else hr_res + a
            nd_res = b if nd_res is None else nd_res + b
        hit, ndcg = hr_res.result()[0], nd_res.result()[0]
        check(0.0 <= ndcg <= hit <= 1.0, f"[17] (d) {name} HR {hit} NDCG "
              f"{ndcg}")
        r17["rec"][name] = {"step_ms": step_ms,
                            "samples_per_s": rc["batch"] / step_ms * 1e3,
                            "hr": hit, "ndcg": ndcg}
        print(f"[17] (d) {card}: {name} (ML-1M counts: {n_users} users, "
              f"{n_items} items, {int(split['n'])} ratings after "
              f"de-duplication; {len(train)} training pairs, {n_take} "
              f"sampled), LocalOptimizer B{rc['batch']}, Adam(0.02), "
              f"{rc['steps']} steps: loss {np.mean(losses[:20]):.4f} -> "
              f"{np.mean(losses[-20:]):.4f} (means of 20 steps); step "
              f"{step_ms:.2f} ms (median) = "
              f"{r17['rec'][name]['samples_per_s']:.0f} samples/s; "
              f"{wall:.2f} s in all; HitRatio@{rc['eval_k']} {hit:.4f}, "
              f"NDCG@{rc['eval_k']} {ndcg:.4f} over {len(ev_users)} users",
              flush=True)
        batch = [train[take[:rc["batch"]]].astype(np.int64)]
        err = module_card_vs_cpu(torch, name, lambda: build("cpu"), batch,
                                 dev, tag="[17] (d)", tol=MOE_TOL)
        print(f"[17] (d) {card}: {name}, one batch of {rc['batch']}: scores "
              f"and every gradient card against CPU {err:.3g}", flush=True)
        del model, opt

    # -- (e) graphs ----------------------------------------------------------
    seq = LeNet5(device=dev)
    graph = _graph_of(nn, seq)
    imgs = torch.from_numpy(np.random.RandomState(3).randn(
        128, 28, 28).astype(np.float32)).to(dev)
    outs = []
    for m in (seq, graph):
        m.evaluate()
        with torch.no_grad():
            outs.append(m.forward(imgs))
    check(torch.equal(outs[0], outs[1]), "[17] (e) LeNet-5 as a Graph "
          "differs from its Sequential twin")
    err = module_card_vs_cpu(torch, "LeNet-5 Graph", lambda: _graph_of(
        nn, LeNet5(device="cpu")), [np.random.RandomState(4).randn(
            8, 28, 28).astype(np.float32)], dev, tag="[17] (e)",
        tol=MOE_TOL)
    sw_in, sw_p = nn.Input(), nn.Input()
    sw = nn.Switch()(sw_in, sw_p)
    lin = nn.Linear(64, 64)
    dyn = nn.DynamicGraph([sw_in, sw_p], nn.Merge()(
        nn.MulConstant(2.0)(nn.SelectTable(1)(sw)),
        lin(nn.SelectTable(2)(sw)))).to(dev)
    dyn.evaluate()
    xd = torch.randn(16, 64, device=dev)
    with torch.no_grad():
        f_out = dyn.forward(Table(xd, torch.tensor(False)))
        t_out = dyn.forward(Table(xd, torch.tensor(True)))
        want_t = lin.call(lin.params, xd)
    check(torch.equal(f_out, 2.0 * xd) and torch.equal(t_out, want_t),
          "[17] (e) DynamicGraph's branches give the wrong outputs")
    print(f"[17] (e) {card}: LeNet-5 as a Graph of {len(graph._modules)} "
          f"nodes equal to its Sequential twin bit for bit at B128; its "
          f"outputs and gradients card against CPU {err:.3g}; DynamicGraph "
          f"Switch / Merge: the false branch (x * 2) and the true branch "
          f"(Linear) each exact", flush=True)

    # -- (f) detection at published sizes -------------------------------------
    dc = DET17
    rng = np.random.RandomState(5)
    prior = _ssd_priors(nn, dev)
    n_pri = prior.shape[2] // 4
    check(n_pri == 8732, f"[17] (f) SSD300 priors {n_pri}, expected 8732")
    Bs, C = dc["ssd_batch"], dc["classes"]
    loc = torch.from_numpy((0.5 * rng.randn(Bs, n_pri * 4)).astype(
        np.float32))
    conf = torch.from_numpy((2.0 * rng.randn(Bs, n_pri * C)).astype(
        np.float32))
    ssd = nn.DetectionOutputSSD(C, nms_topk=400, keep_topk=200).evaluate()
    det = {}
    det["ssd"], ssd_ms = _ms_calls(torch, lambda: ssd.forward(Table(
        loc.to(dev), conf.to(dev), prior)))
    ssd_cpu = ssd.forward(Table(loc, conf, _ssd_priors(nn, "cpu")))
    _det_same(torch, "SSD300 DetectionOutputSSD", det["ssd"], ssd_cpu)
    n_det = det["ssd"][:, 0].int().tolist()
    # Faster R-CNN VGG-16 test settings
    A, (Hf, Wf) = 9, dc["frcnn_map"]
    cls = torch.from_numpy(rng.randn(1, 2 * A, Hf, Wf).astype(np.float32))
    dlt = torch.from_numpy((0.1 * rng.randn(1, 4 * A, Hf, Wf)).astype(
        np.float32))
    info = torch.tensor([[float(dc["im"][0]), float(dc["im"][1]), 1.0, 1.0]])
    prop = nn.Proposal(6000, dc["rois"], (0.5, 1, 2), (8, 16, 32)).evaluate()
    rois, prop_ms = _ms_calls(torch, lambda: prop.forward(Table(
        cls.to(dev), dlt.to(dev), info.to(dev))))
    rois_cpu = prop.forward(Table(cls, dlt, info))
    _det_same(torch, "Faster R-CNN Proposal", rois, rois_cpu)
    # the CPU's rois on both sides from here (a roi corner one ulp apart
    # can round into another pooling bin)
    rois = rois_cpu.to(dev)
    feats = torch.from_numpy(rng.randn(1, dc["frcnn_c"], Hf, Wf).astype(
        np.float32))
    pool = {}
    for name, mod in (("RoiPooling", nn.RoiPooling(7, 7, 1 / 16.0)),
                      ("RoiAlign", nn.RoiAlign(7, 7, 1 / 16.0))):
        mod.evaluate()
        with torch.no_grad():
            got, ms = _ms_calls(torch, lambda: mod.forward(Table(
                feats.to(dev), rois)))
            want = mod.forward(Table(feats, rois_cpu))
        e = _rel_err(got.cpu(), want)
        check(tuple(got.shape) == (rois.shape[0], dc["frcnn_c"], 7, 7)
              and e <= MOE_TOL, f"[17] (f) {name} card against CPU {e}")
        pool[name] = (ms, e)
    n_r = rois.shape[0]
    sc = np.exp(rng.randn(n_r, C).astype(np.float32))
    sc = torch.from_numpy(sc / sc.sum(1, keepdims=True))
    bd = torch.from_numpy((0.1 * rng.randn(n_r, 4 * C)).astype(np.float32))
    frcnn = nn.DetectionOutputFrcnn(0.3, C, max_per_image=100,
                                    thresh=0.05).evaluate()
    det["frcnn"], fr_ms = _ms_calls(torch, lambda: frcnn.forward(Table(
        info.to(dev), rois, bd.to(dev), sc.to(dev))))
    fr_cpu = frcnn.forward(Table(info, rois_cpu, bd, sc))
    _det_same(torch, "Faster R-CNN DetectionOutputFrcnn", det["frcnn"],
              fr_cpu)
    print(f"[17] (f) {card}: SSD300-VOC (8732 priors from six PriorBox "
          f"maps, 21 classes, nms_topk 400, keep_topk 200) at B{Bs}: "
          f"{ssd_ms:.1f} ms a call, detections per image {n_det}; Faster "
          f"R-CNN VGG-16 test settings: Proposal(6000, {dc['rois']}) on a "
          f"{Hf}x{Wf} map {prop_ms:.1f} ms -> {n_r} rois; RoiPooling(7, 7, "
          f"1/16) {pool['RoiPooling'][0]:.2f} ms and RoiAlign "
          f"{pool['RoiAlign'][0]:.2f} ms over (1, {dc['frcnn_c']}, {Hf}, "
          f"{Wf}) (card against CPU {pool['RoiPooling'][1]:.3g} / "
          f"{pool['RoiAlign'][1]:.3g}); DetectionOutputFrcnn {fr_ms:.1f} ms "
          f"-> {int(det['frcnn'][0, 0])} detections; every output equal to "
          f"the CPU's (detections, labels and scores exactly, boxes within "
          f"{MOE_TOL})", flush=True)
    r17["det_ms"] = {"ssd": ssd_ms, "proposal": prop_ms,
                     "roi_pooling": pool["RoiPooling"][0],
                     "roi_align": pool["RoiAlign"][0], "frcnn": fr_ms}
    r17["phase_s"] = time.perf_counter() - t17
    print(f"[17] phase 17: {r17['phase_s']:.1f} s", flush=True)
    return r17


def _graph_of(nn, seq):
    """A ``Graph`` chaining a ``Sequential``'s own modules in order."""
    x = nn.Input()
    node = x
    for m in seq._modules.values():
        node = m(node)
    return nn.Graph(x, node)


def _det_same(torch, name, got, want):
    """A detection output on the card against the CPU's: the same shape,
    the counts / labels / scores / rows exactly where they index, the box
    coordinates within MOE_TOL."""
    got = got.float().cpu()
    check(tuple(got.shape) == tuple(want.shape),
          f"[17] (f) {name}: card {tuple(got.shape)} against CPU "
          f"{tuple(want.shape)}")
    e = _rel_err(got, want)
    check(e <= MOE_TOL, f"[17] (f) {name}: card against CPU {e}")
    if got.dim() == 2 and got.shape[1] > 1 and got.shape[1] % 6 == 1:
        lab = lambda t: t[:, 1:].reshape(t.shape[0], -1, 6)[..., :2]
        check(torch.equal(got[:, 0], want[:, 0])
              and torch.equal(lab(got), lab(want)),
              f"[17] (f) {name}: the detections (count, label, score) "
              f"differ between card and CPU")



# -- phase 18: data-parallel training across GPUs -------------------------------

# (a) the flagship at bench_transformer_lm's width through DistriOptimizer,
# (b) ResNet-50 fused NHWC float32, (c) two ranks sharing the card over
# gloo, (d) the failure detectors and the elastic restart
DIST18 = dict(B=16, T=1024, warm=1, timed=2, local_steps=3, res_B=32,
              res_S=224, res_steps=3, gloo_layers=2, gloo_steps=2,
              gloo_lr=0.1, elastic_halt=2, elastic_steps=4)
# (c) and (d) train at lr 0.1 (SGD, momentum 0.9): at (a)'s 0.01 three
# steps moved the depth-2 flagship's parameters by 4.7e-5 at most, less
# than the 1e-4 tolerance and near float32's rounding of values ~1
# chosen before the run from a chip probe of gloo on CUDA tensors (PERF.md):
# gloo takes all_reduce, reduce_scatter_tensor, all_gather_into_tensor and
# all_to_all_single in float32 / bf16 / fp16 / int64 / float64, broadcast,
# barrier and all_gather_object; it refuses send / recv ("writev ... Bad
# address"), which data-parallel training does not use. So every mode runs.
MODES18 = [("replicated", {}), ("zero1", {}),
           ("zero1_compress", {"compress": "bf16"}),
           ("zero1_wire", {"wire_dtype": "bf16"})]
GLOO_TOL = 1e-4          # the CPU tests' tolerance after several steps
GLOO_BF16_TOL = 2e-3     # compress="bf16": the reduce-scatter sums in bf16
# ... and each error as a share of how far the one-rank run moved the
# parameters from their initial values (max |param - init|): a broken
# exchange (no all-reduce, half the batch, a 1/n too many) is off by a
# large share of that movement, float32 sums in another order by ~1e-5
# of it at most; both bf16 wires round each rank's gradient (up to 2^-9
# of it a rounding, on the one-rank and the two-rank side alike)
GLOO_REL = 1e-3
GLOO_BF16_REL = 3e-2
COLLECTIVE_COUNTERS = ("pmean", "psum", "reduce_scatter", "grad_wire",
                       "all_gather")


def _mode_kw(mode):
    name, kw = mode
    return ("zero1" if name.startswith("zero1") else name), kw


def _collective_bytes(obs):
    reg = obs.registry()
    out = {}
    for op in COLLECTIVE_COUNTERS:
        c = reg.get(f"collective/{op}_traced_bytes")
        if c is not None and c.value:
            out[op] = c.value
    return out


def _max_err(torch, a, b):
    from bigdl_tpu_torch.convert import flatten
    fa, fb = flatten(a), flatten(b)
    host = lambda t: torch.as_tensor(t).detach().float().cpu()
    return max(float((host(fa[k]) - host(fb[k])).abs().max()) for k in fa)


class _FixedBatches:
    """A batch-level data set of fixed global batches in a fixed order:
    a resumed run sees the batches an uninterrupted one sees."""

    def __init__(self, samples, B):
        from bigdl_tpu_torch.dataset import MiniBatch
        self._mbs = [MiniBatch(np.stack([s.feature() for s in samples[i:i + B]]),
                               np.stack([s.label() for s in samples[i:i + B]]))
                     for i in range(0, len(samples), B)]

    def size(self):
        return sum(len(m.get_input()) for m in self._mbs)

    def batches_per_epoch(self):
        return len(self._mbs)

    def shuffle(self):
        return self

    def data(self, train=True):
        return iter(self._mbs)


def _distri_lm(torch, model, samples, mode, steps, B, mesh, end=None,
               fixed=False, lr=0.01):
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import LMCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    pm, kw = _mode_kw(mode)
    data = _FixedBatches(samples, B) if fixed else DataSet.array(samples)
    return DistriOptimizer(model, data, LMCriterion(),
                           SGD(learningrate=lr, momentum=0.9),
                           end or max_iteration(steps), batch_size=B,
                           mesh=mesh, parameter_mode=pm, **kw)


def _bn_net(nn, dev, seed=0):
    import torch
    m = nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, with_bias=False,
                              format="NHWC"),
        nn.SpatialBatchNormalization(8, data_format="NHWC"), nn.ReLU(),
        nn.View(8 * 16 * 16), nn.Linear(8 * 16 * 16, 10))
    m.reset(torch.Generator().manual_seed(seed))
    return m.to(dev)


def _bn_run(torch, mesh, dev, steps=3, B=16):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.convert import host_copy_tree
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    rng = np.random.RandomState(8)
    x = rng.randn(B * steps, 16, 16, 3).astype(np.float32)
    y = rng.randint(1, 11, B * steps).astype(np.float32)
    m = _bn_net(nn, dev)
    DistriOptimizer(m, DataSet.array([Sample(a, b) for a, b in zip(x, y)]),
                    nn.CrossEntropyCriterion(), SGD(learningrate=0.1),
                    max_iteration(steps), batch_size=B, mesh=mesh).optimize()
    return {"params": host_copy_tree(m.params),
            "state": host_copy_tree(m.state)}


_GLOO_LM = {}


def _gloo_lm(torch, dev, seed=7):
    """The flagship cut to ``gloo_layers`` layers, built once a process
    and put back to its initial weights at every call (a run trains it in
    place)."""
    from bigdl_tpu_torch.models import TransformerLM
    if dev not in _GLOO_LM:
        cfg = dict(FLAGSHIP, num_layers=DIST18["gloo_layers"],
                   max_len=DIST18["T"])
        m = TransformerLM(**cfg, device=dev, seed=seed)
        _GLOO_LM[dev] = (m, {k: v.clone() for k, v in
                             m.state_dict().items()})
    m, init = _GLOO_LM[dev]
    m.load_state_dict(init)
    return m


def phase18_rank(rank, n, port, spec):
    """One of (c)'s two ranks sharing the card over gloo: every mode of
    MODES18 on the depth-cut flagship, the BatchNorm model, the heartbeat
    and the straggler monitor, then the elastic drill (rank 1 leaves,
    rank 0 resumes on one NCCL rank). Rank 0 compares against the
    one-rank references of ``spec`` and writes its findings."""
    import torch
    from bigdl_tpu_torch import kernels as K
    from bigdl_tpu_torch.convert import host_copy_tree
    from bigdl_tpu_torch.nn import LMCriterion
    from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, Trigger,
                                       several_iteration)
    from bigdl_tpu_torch.parallel import data_parallel_mesh
    from bigdl_tpu_torch.parallel.elastic import (ElasticRunner,
                                                  data_parallel_factory)
    from bigdl_tpu_torch.parallel.failure import (Heartbeat,
                                                  StragglerMonitor,
                                                  TrainingHalted)
    from bigdl_tpu_torch.utils import engine
    with open(spec, "rb") as f:
        cfg = pickle.load(f)
    DIST18.update(cfg["sizes"][0])
    FLAGSHIP.update(cfg["sizes"][1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = cfg["dev"]
    # two ranks share the one card: NCCL refuses that, so the group is
    # made over gloo here and the engine keeps it
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=300))
    engine.init_process_group(device=dev)
    mesh = data_parallel_mesh()
    samples = _lm_samples(FLAGSHIP["vocab_size"],
                          DIST18["B"] * DIST18["gloo_steps"], DIST18["T"],
                          seed=11)
    refs = torch.load(cfg["refs"], weights_only=False) if rank == 0 \
        else None
    out = {"modes": {}}
    for mode in MODES18:
        model = _gloo_lm(torch, dev)
        opt = _distri_lm(torch, model, samples, mode, DIST18["gloo_steps"],
                         DIST18["B"], mesh, lr=DIST18["gloo_lr"])
        K.reset_launch_counts()
        t0 = time.perf_counter()
        opt.optimize()
        _sync(torch, dev)
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        rec = {"wall_s": dt, "step_s": opt.metrics.values["step_time"],
               "flash": (counts["flash_fwd"], counts["flash_bwd"])}
        if rank == 0:
            rec["err"] = _max_err(torch, model.params, refs[mode[0]])
        out["modes"][mode[0]] = rec
        del model, opt
    bn = _bn_run(torch, mesh, dev)
    if rank == 0:
        out["bn_err"] = (_max_err(torch, bn["params"], refs["bn"]["params"]),
                         _max_err(torch, bn["state"], refs["bn"]["state"]))
    hb = Heartbeat(stale_after=2)
    out["heartbeat"] = [hb.beat(timeout_s=60) for _ in range(3)]
    sm = StragglerMonitor()
    for t in out["modes"]["replicated"]["step_s"]:
        sm.record(t)
    out["straggler"] = sm.report()
    # (d) the elastic drill: ZeRO-1 on both ranks halts after step 2 with
    # rank 1 lost; rank 0 resumes alone on one NCCL rank to step 4
    attempts = []

    def make(m):
        attempt = len(attempts)
        attempts.append((m.size(), str(engine.process_group()["backend"])))

        def end(st):
            if attempt == 0 and st["neval"] == DIST18["elastic_halt"]:
                raise TrainingHalted("drill", lost_processes=[1],
                                     neval=st["neval"])
            return st["neval"] >= DIST18["elastic_steps"]
        o = _distri_lm(torch, _gloo_lm(torch, dev),
                       samples[:2 * DIST18["B"]],
                       ("zero1", {}), 0, DIST18["B"], m, end=Trigger(end),
                       fixed=True, lr=DIST18["gloo_lr"])
        o.set_checkpoint(several_iteration(1), cfg["ckpt"])
        return o

    t0 = time.perf_counter()
    runner = ElasticRunner(data_parallel_factory(make), cfg["ckpt"],
                           max_restarts=1, aggregate_bundles=False)
    model = runner.run()
    out["elastic"] = {"attempts": attempts, "s": time.perf_counter() - t0,
                      "restarts": runner.restarts}
    if rank == 0:
        out["elastic"]["err"] = _max_err(torch, model.params,
                                         refs["elastic"])
    with open(cfg["out"] + f".{rank}", "wb") as f:
        pickle.dump(out, f)
    sys.stdout.flush()
    os._exit(0)


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _gloo_refs(torch, mesh, tmp, dev):
    """The one-rank references of (c) and (d), on this process's NCCL
    world of one, saved for the gloo ranks; returns their path and how far
    each reference moved from its initial values (max |param - init|, and
    for the BatchNorm model its running statistics too)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.convert import host_copy_tree
    from bigdl_tpu_torch.optim import max_iteration
    samples = _lm_samples(FLAGSHIP["vocab_size"],
                          DIST18["B"] * DIST18["gloo_steps"], DIST18["T"],
                          seed=11)
    init = host_copy_tree(_gloo_lm(torch, dev).params)
    refs, moves = {}, {}
    for mode in MODES18:
        model = _gloo_lm(torch, dev)
        _distri_lm(torch, model, samples, mode, DIST18["gloo_steps"],
                   DIST18["B"], mesh, lr=DIST18["gloo_lr"]).optimize()
        refs[mode[0]] = host_copy_tree(model.params)
        moves[mode[0]] = _max_err(torch, refs[mode[0]], init)
    bn0 = _bn_net(nn, dev)
    bn_init = (host_copy_tree(bn0.params), host_copy_tree(bn0.state))
    refs["bn"] = _bn_run(torch, mesh, dev)
    moves["bn"] = (_max_err(torch, refs["bn"]["params"], bn_init[0]),
                   _max_err(torch, refs["bn"]["state"], bn_init[1]))
    # the elastic drill's uninterrupted run: 2 batches an epoch, 4 steps
    model = _gloo_lm(torch, dev)
    _distri_lm(torch, model, samples[:2 * DIST18["B"]], ("zero1", {}),
               DIST18["elastic_steps"], DIST18["B"], mesh,
               fixed=True, lr=DIST18["gloo_lr"]).optimize()
    refs["elastic"] = host_copy_tree(model.params)
    moves["elastic"] = _max_err(torch, refs["elastic"], init)
    path = os.path.join(tmp, "refs18.pt")
    torch.save(refs, path)
    return path, moves


def distributed(torch, K, card, dev="cuda", tmp=None):
    """Phase 18: data-parallel training through ``DistriOptimizer``.
    (a) the flagship (vocab 32000, hidden 1024, 16 heads, filter 4096, 12
    layers, float32 parameters, B16/T1024, ``LMCriterion``, SGD 0.01
    momentum 0.9) on this process's one-rank NCCL group: LocalOptimizer 3
    steps, replicated 3 steps equal to it, then each of MODES18 1 warm-up
    and 2 timed steps (step ms, tokens/s, peak GiB, K1 launches by route,
    the collectives' bytes a step from the counters) and one more step
    under the profiler (NCCL's kernels' ms). (b) ResNet-50 fused NHWC
    float32 B32/224: LocalOptimizer, replicated (its BatchNorm running
    statistics equal the local run's) and ZeRO-1 with ``fused_conv2``,
    3 steps each, step ms, images/s, K3 / K4 / K5 launches by route.
    (c) two ranks on this card over gloo (processes of this script): each
    mode on the flagship cut to 2 layers, global B16/T1024 (8 rows a
    rank), SGD 0.1, ``gloo_steps`` (2) steps, against the one-rank runs
    on the same global
    batches, each error also as a share of how far the one-rank run moved
    the parameters, and a BatchNorm model in ``replicated`` against one
    rank. (d)
    ``probe_mesh`` on the NCCL group, a ``Heartbeat`` and a
    ``StragglerMonitor`` over (c)'s ranks, and ``ElasticRunner``: (c)'s
    ranks in ZeRO-1 halt after step 2, rank 0 resumes on one NCCL rank
    from the canonical checkpoint to step 4, against an uninterrupted
    one-rank run. Returns the launches a kernel row adds."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.convert import host_copy_tree
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.models import ResNet50, TransformerLM
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, LMCriterion
    from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, LocalOptimizer,
                                       max_iteration)
    from bigdl_tpu_torch.parallel import data_parallel_mesh, probe_mesh
    from bigdl_tpu_torch.utils import engine
    t18 = time.perf_counter()
    tmp = tmp or tempfile.mkdtemp(prefix="phase18_")
    grp = engine.init_process_group(device=dev)
    mesh = data_parallel_mesh()
    print(f"[18] data-parallel training ({card}): group {grp['backend']} "
          f"world {grp['world_size']} on {grp['device']}", flush=True)
    check(grp["backend"] == "nccl" and grp["world_size"] == 1,
          f"phase 18's group: {grp}")
    launches = dict.fromkeys(("flash_fwd", "flash_bwd", "fused_matmul_fwd",
                              "fused_matmul_bwd", "fused_chain_fwd",
                              "fused_chain_bwd", "fused_conv_fwd"), 0)
    L = FLAGSHIP["num_layers"]
    B, T = DIST18["B"], DIST18["T"]
    model = TransformerLM(**dict(FLAGSHIP, max_len=T), device=dev, seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    steps = DIST18["warm"] + DIST18["timed"]
    samples = _lm_samples(FLAGSHIP["vocab_size"], B * steps, T, seed=3)
    # (a) LocalOptimizer, then replicated: equal after 3 steps
    n3 = DIST18["local_steps"]
    local = LocalOptimizer(model, DataSet.array(samples[:B * n3]),
                           LMCriterion(), SGD(learningrate=0.01,
                                              momentum=0.9),
                           max_iteration(n3), batch_size=B, device=dev)
    local.optimize()
    want = host_copy_tree(model.params)
    model.load_state_dict(init)
    _distri_lm(torch, model, samples[:B * n3], ("replicated", {}), n3, B,
               mesh).optimize()
    err = _max_err(torch, model.params, want)
    del want
    print(f"    (a) replicated against LocalOptimizer after {n3} steps: "
          f"max abs err {err:.3e} ({card})", flush=True)
    check(err <= 1e-5, f"replicated DistriOptimizer {err} from "
          f"LocalOptimizer after {n3} steps")
    r18 = {"lm": {}, "resnet": {}}
    for mode in MODES18:
        model.load_state_dict(init)
        opt = _distri_lm(torch, model, samples, mode, steps, B, mesh)
        obs.enable()
        obs.registry().reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        opt.optimize()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        routes = K.launches_by_route()
        wire = _collective_bytes(obs)
        obs.disable()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = dict.fromkeys(K.WRAPPERS, 0)
        want.update(flash_fwd=L * steps, flash_bwd=L * steps)
        check(counts == want, f"(a) {mode[0]} launched {counts}, expected "
              f"{want}")
        check(only_on(routes["flash_fwd"], "f32_sm90", L * steps)
              and only_on(routes["flash_bwd"], "f32_sm90", L * steps),
              f"(a) {mode[0]} flash routes {routes['flash_fwd']} / "
              f"{routes['flash_bwd']}, expected f32_sm90")
        launches["flash_fwd"] += counts["flash_fwd"]
        launches["flash_bwd"] += counts["flash_bwd"]
        st = opt.metrics.values["step_time"][DIST18["warm"]:]
        ms = statistics.median(st) * 1e3
        loss = opt.optim_method.state["loss"]
        check(math.isfinite(loss), f"(a) {mode[0]} loss {loss}")
        # one more step under the profiler: NCCL's kernels a step
        again = _distri_lm(torch, model, samples[:B], mode, 1, B, mesh)
        tr = trace_steps(torch, again.optimize, n=1, convs=False)
        nccl = tr["families"].get("NCCL", 0.0)
        per_step = {k: v / steps for k, v in wire.items()}
        r18["lm"][mode[0]] = {"step_ms": ms, "tokens_s": B * T / ms * 1e3,
                              "peak_gib": peak, "bytes": per_step,
                              "nccl_ms": nccl,
                              "device_ms": tr["device_ms"], "loss": loss}
        print(f"    (a) {mode[0]:15s} step {ms:8.1f} ms  "
              f"{B * T / ms * 1e3:9.0f} tokens/s  peak {peak:5.1f} GiB  "
              f"K1 a step fwd {counts['flash_fwd'] // steps} / bwd "
              f"{counts['flash_bwd'] // steps} on f32_sm90  collectives a "
              f"step {per_step} B  NCCL {nccl:.3f} ms of "
              f"{tr['device_ms']:.1f} device ms  loss {loss:.4f}  "
              f"({card})", flush=True)
        del opt, again
        torch.cuda.empty_cache()
    del model, init
    torch.cuda.empty_cache()
    print(f"    (a) {time.perf_counter() - t18:.1f} s", flush=True)
    t_b = time.perf_counter()
    # (b) ResNet-50 fused NHWC float32 B32
    RB, S, n = DIST18["res_B"], DIST18["res_S"], DIST18["res_steps"]
    rng = np.random.RandomState(6)
    imgs = rng.randn(RB * n, S, S, 3).astype(np.float32)
    labels = rng.randint(1, 1001, RB * n)
    rs = [Sample(imgs[i], labels[i]) for i in range(RB * n)]
    states = {}
    # cuDNN's deterministic algorithms (as phase 12's reruns), so that the
    # replicated run can be held to the local one; restored afterwards
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    for arm, conv2 in (("local", False), ("replicated", False),
                       ("zero1", True)):
        m = ResNet50(format="NHWC", fused="pallas", fused_conv2=conv2,
                     zero_init_residual=False, device=dev, seed=5)
        args = (m, DataSet.array(rs), CrossEntropyCriterion(),
                SGD(learningrate=0.1, momentum=0.9), max_iteration(n))
        opt = LocalOptimizer(*args, batch_size=RB, device=dev) \
            if arm == "local" else \
            DistriOptimizer(*args, batch_size=RB, mesh=mesh,
                            parameter_mode=arm)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        opt.optimize()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        routes = K.launches_by_route()
        want = dict.fromkeys(K.WRAPPERS, 0)
        want.update(fused_matmul_fwd=24 * n, fused_matmul_bwd=24 * n,
                    fused_chain_fwd=12 * n, fused_chain_bwd=12 * n)
        if conv2:
            want.update(fused_conv_fwd=16 * n)
        check(counts == want, f"(b) {arm} launched {counts}, expected "
              f"{want}")
        for k in want:
            if want[k]:
                check(only_on(routes[k], "f32_sm90", want[k]),
                      f"(b) {arm} {k} routes {routes[k]}")
        if arm != "local":
            for k in launches:
                launches[k] += counts[k]
        ms = statistics.median(opt.metrics.values["step_time"][1:]) * 1e3
        states[arm] = host_copy_tree(m.state)
        r18["resnet"][arm] = {"step_ms": ms, "images_s": RB / ms * 1e3,
                              "steps_ms": [round(t * 1e3, 1) for t in
                                           opt.metrics.values["step_time"]]}
        print(f"    (b) ResNet-50 {arm:10s}{' fused_conv2' if conv2 else ''}"
              f" step {ms:7.1f} ms  {RB / ms * 1e3:7.1f} images/s  K3 "
              f"{counts['fused_matmul_fwd'] // n}+"
              f"{counts['fused_matmul_bwd'] // n} K5 "
              f"{counts['fused_chain_fwd'] // n}+"
              f"{counts['fused_chain_bwd'] // n} K4 "
              f"{counts['fused_conv_fwd'] // n} a step on f32_sm90 "
              f"(steps {r18['resnet'][arm]['steps_ms']} ms) ({card})",
              flush=True)
        del m, opt
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    err = _max_err(torch, states["replicated"], states["local"])
    print(f"    (b) replicated BatchNorm running statistics against "
          f"LocalOptimizer after {n} steps: max abs err {err:.3e} "
          f"({card})", flush=True)
    check(err <= 1e-5, f"(b) replicated running statistics {err} from "
          f"the local run's")
    print(f"    (b) {time.perf_counter() - t_b:.1f} s", flush=True)
    # (d) the mesh probe on the NCCL group
    p = probe_mesh(mesh, timeout_s=30)
    print(f"    (d) probe_mesh on the NCCL group: {p} ({card})", flush=True)
    check(p.ok and p.n_devices == 1, f"probe_mesh {p}")
    # (c) + (d) two ranks on the card over gloo
    print(f"    (c) gloo modes chosen before the run: "
          f"{[m[0] for m in MODES18]}; not run: none (gloo takes every "
          f"collective they use on CUDA tensors; it refuses only send / "
          f"recv, which ppermute_ring uses and data parallelism does not)",
          flush=True)
    t0 = time.perf_counter()
    refs, moves = _gloo_refs(torch, mesh, tmp, dev)
    ref_s = time.perf_counter() - t0
    spec = os.path.join(tmp, "spec18.pkl")
    out = os.path.join(tmp, "out18")
    with open(spec, "wb") as f:
        pickle.dump({"refs": refs, "out": out, "dev": dev,
                     "ckpt": os.path.join(tmp, "ckpt18"),
                     "sizes": (DIST18, FLAGSHIP)}, f)
    port = _free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--phase18-rank", str(r), "2", str(port),
                               spec], cwd=root) for r in range(2)]
    deadline = time.monotonic() + 240
    try:
        while any(p.poll() is None for p in procs):
            check(time.monotonic() < deadline,
                  "(c) the gloo ranks did not finish in 240 s")
            check(all(p.poll() in (None, 0) for p in procs),
                  f"(c) a gloo rank failed: "
                  f"{[p.poll() for p in procs]}")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    gloo_s = time.perf_counter() - t0
    check(all(p.returncode == 0 for p in procs),
          f"(c) gloo ranks exited {[p.returncode for p in procs]}")
    res = []
    for r in range(2):
        with open(out + f".{r}", "rb") as f:
            res.append(pickle.load(f))
    r0 = res[0]
    for name, rec in r0["modes"].items():
        tol = GLOO_BF16_TOL if name == "zero1_compress" else GLOO_TOL
        rel_tol = GLOO_BF16_REL if name in ("zero1_compress",
                                            "zero1_wire") else GLOO_REL
        rel = rec["err"] / moves[name]
        ms = statistics.median(rec["step_s"][1:]) * 1e3
        print(f"    (c) 2 ranks over gloo {name:15s} "
              f"{DIST18['gloo_steps']} steps in "
              f"{rec['wall_s']:.2f} s (step {ms:.0f} ms), K1 fwd/bwd "
              f"{rec['flash'][0]}/{rec['flash'][1]} a rank, max abs err "
              f"against one rank {rec['err']:.3e} (tol {tol:g}); the "
              f"one-rank run moved the parameters by {moves[name]:.3e}, "
              f"err / move {rel:.3e} (tol {rel_tol:g}) ({card})",
              flush=True)
        check(rec["err"] <= tol and rel <= rel_tol,
              f"(c) {name} on 2 gloo ranks {rec['err']} from one rank "
              f"({rel} of its movement)")
        n_k1 = DIST18["gloo_layers"] * DIST18["gloo_steps"]
        check(rec["flash"] == (n_k1, n_k1), f"(c) {name} K1 launches "
              f"{rec['flash']}")
    bn_rel = [e / m for e, m in zip(r0["bn_err"], moves["bn"])]
    print(f"    (c) BatchNorm model, replicated, 2 ranks against one: max "
          f"abs err params {r0['bn_err'][0]:.3e}, running statistics "
          f"{r0['bn_err'][1]:.3e}; the one-rank run moved them by "
          f"{moves['bn'][0]:.3e} and {moves['bn'][1]:.3e}, err / move "
          f"{bn_rel[0]:.3e} and {bn_rel[1]:.3e} (tol {GLOO_REL:g}) "
          f"({card})", flush=True)
    check(max(r0["bn_err"]) <= 1e-5 and max(bn_rel) <= GLOO_REL,
          f"(c) BatchNorm {r0['bn_err']} ({bn_rel} of the movement)")
    print(f"    (d) heartbeat over the gloo ranks: stale {r0['heartbeat']}; "
          f"straggler report {r0['straggler']['per_host_mean_s']} -> "
          f"stragglers {r0['straggler']['stragglers']} ({card})",
          flush=True)
    check(r0["heartbeat"] == [[], [], []], f"heartbeat {r0['heartbeat']}")
    el = r0["elastic"]
    el_rel = el["err"] / moves["elastic"]
    print(f"    (d) ElasticRunner: attempts (ranks, backend) "
          f"{el['attempts']}, restarts {el['restarts']}, "
          f"{el['s']:.1f} s; rank 0 resumed on one NCCL rank, max abs err "
          f"against an uninterrupted one-rank run {el['err']:.3e}, which "
          f"moved the parameters by {moves['elastic']:.3e}, err / move "
          f"{el_rel:.3e} (tol {GLOO_REL:g}) ({card})", flush=True)
    check(el["attempts"] == [(2, "gloo"), (1, "nccl")]
          and el["restarts"] == 1, f"elastic attempts {el}")
    check(res[1]["elastic"]["attempts"] == [(2, "gloo")],
          f"rank 1's elastic attempts {res[1]['elastic']}")
    check(el["err"] <= GLOO_TOL and el_rel <= GLOO_REL,
          f"(d) elastic resume {el['err']} from the uninterrupted run "
          f"({el_rel} of its movement)")
    r18.update(gloo=r0, moves=moves, refs_s=ref_s, gloo_s=gloo_s,
               phase_s=time.perf_counter() - t18, launches=launches)
    print(f"[18] phase 18: {r18['phase_s']:.1f} s (one-rank references "
          f"{ref_s:.1f} s, gloo ranks {gloo_s:.1f} s)", flush=True)
    return r18


# -- phase 19: model parallelism across GPUs ------------------------------------

# two gloo ranks of this script share the card (NCCL refuses two ranks on
# one card): (a) tensor-parallel and (b) FSDP serving of the flagship
# through DecodeScheduler(mesh=, placement=) with phase 4's requests, (d)
# sequence-parallel attention (ring-flash and all-to-all), (e) the
# time-sharded decode, (f) tensor-parallel and FSDP training, (g) GPipe
# and the expert-parallel MoE FFN; each against one rank in the same
# process. (b) serves the flagship cut to ``fsdp_layers`` layers: two ranks
# sharing one card gather FSDP slices through gloo at 0.3-0.6 GB/s
# (``tools/torch_gloo_gather_probe.py``: 0.32-0.66 s for the full depth's
# 184 MB a step, however the gathers are cut), which would make the full
# depth ~100 s; its resident bytes are read at full depth too, and it
# serves the first ``fsdp_req`` of the requests (tokens and pages
# checked as in (a)) so that the smoke with phase 20 stays under half its
# time limit; (a) serves the first ``n_req`` (4) of phase 4's 16 and (b)
# the first ``fsdp_req`` (4) with their budgets capped at ``fsdp_budget``
# (32: the serving time is the decode steps of the longest budget), and
# phase 18 (a) times 2 steps a mode after one warm step (3 until the ragged
# K3 / K5 checks joined phase 2), which leaves room for phases 22 and 23
# under that limit. (a2) adds the host KV tier under the tensor-parallel mesh,
# (c) the engine over FSDP on the same 4-layer cut.
MP19 = dict(n_req=4, prompt=(32, 257), budget=(16, 65), slots=8, block=16,
            chunk=32, max_seq=384, max_len=512,
            gen_B=8, gen_T=128, gen_new=8, seq_B=2, seq_T=2048, dec_B=4,
            dec_T=4096, dec_steps=64, train_layers=2, train_B=8,
            train_T=1024, train_steps=3, train_lr=0.1, fsdp_layers=4,
            fsdp_req=4, fsdp_budget=32,
            pipe_micro=4,
            pipe_rows=512, moe_tokens=2048, moe_filter=4096, moe_cap=1.25,
            tier_prefix=160, tier_tails=(8, 16), tier_other=200, tier_new=16,
            tier_seq=256,
            tier_blocks=24, eng_req=4, eng_T=128, eng_batch=4,
            timeout=300)
# sequence-parallel attention against one rank's flash, as a share of the
# reference's largest |value| (outputs and gradients): float32 with TF32
# off sums in another order (~1e-6); bf16 keeps 8 bits and the ring merges
# its blocks' bf16 outputs (JAX merges in o's dtype too)
SEQ19_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 3e-2}
DEC19_TOL = 1e-4     # the time-sharded decode, float32, relative
ENG19_TOL = 1e-4     # the engine over FSDP against one rank, float32
PIPE19_TOL = 1e-4    # GPipe / MoE against one rank, float32, relative
_MP_LM = {}


def _mp_flagship(torch, dev, layers=None, max_len=None, seed=0):
    """The flagship (``layers`` deep), built once a process per shape and
    put back to its initial weights at every call."""
    from bigdl_tpu_torch.models import TransformerLM
    key = (layers, max_len, seed)
    if key not in _MP_LM:
        cfg = dict(FLAGSHIP, max_len=max_len or MP19["max_len"])
        if layers is not None:
            cfg["num_layers"] = layers
        m = TransformerLM(**cfg, device=dev, seed=seed)
        _MP_LM[key] = (m, {k: v.clone() for k, v in m.state_dict().items()})
    m, init = _MP_LM[key]
    m.load_state_dict(init)
    return m


def _bytes(tree):
    from bigdl_tpu_torch.convert import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def _rel(got, want):
    """max |got - want| over max |want| (float32 on the host)."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))


def _forced_margins(torch, model, params, prompt, toks):
    """Top-2 margins of one dense teacher-forced forward over prompt +
    toks at each position of toks (:func:`forced_greedy` on the model's
    device)."""
    ids = torch.from_numpy(np.concatenate([prompt, toks])[None, :-1]) \
        .to(model.device)
    with torch.no_grad():
        lg = model.call(params, ids)[0, prompt.size - 1:].float()
    top = lg.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def _chains(torch, sched, prompts):
    """The prefix cache's resident chain of each prompt (None where it was
    evicted), with the scheduler idle."""
    v = sched.registry.current().version
    out = []
    for p in prompts:
        blocks = sched.prefix._walk(p, v, touch=False)[0]
        out.append(list(blocks) if blocks else None)
    return out


def _mp_serve(torch, K, dev, rank, n, placement):
    """(a) / (b): phase 4's requests through the one-rank scheduler and
    through ``DecodeScheduler(mesh=, placement=)`` over the two ranks (all
    submitted before ``start()``, so both admit alike); rank 0's tokens,
    every rank's pages of each prompt chain resident in both pools against
    the one-rank pool's matching heads, launches, resident bytes, peak
    memory and seconds."""
    import torch.distributed as dist
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import over
    from bigdl_tpu_torch.parallel.sharding import (place_with_specs,
                                                   serving_param_specs)
    from bigdl_tpu_torch.serving import DecodeScheduler, ModelRegistry
    from bigdl_tpu_torch.utils.amp import bf16_params
    layers = MP19["fsdp_layers"] if placement == "fsdp" else None
    model = _mp_flagship(torch, dev, layers=layers)
    with torch.no_grad():
        params = bf16_params(model.params)
    V = FLAGSHIP["vocab_size"]
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, V, rng.randint(*MP19["prompt"]))
               .astype(np.int32) for _ in range(MP19["n_req"])]
    budgets = [int(rng.randint(*MP19["budget"]))
               for _ in range(MP19["n_req"])]
    if placement == "fsdp":     # the first fsdp_req of the same requests,
        # their budgets capped at fsdp_budget
        prompts, budgets = (prompts[:MP19["fsdp_req"]],
                            [min(b, MP19["fsdp_budget"])
                             for b in budgets[:MP19["fsdp_req"]]])
    kw = dict(max_slots=MP19["slots"], block_size=MP19["block"],
              max_seq_len=MP19["max_seq"], prefill_chunk=MP19["chunk"])
    out = {}
    reg1 = ModelRegistry(device=model.device)
    reg1.publish(params, version="bf16", activate=True)
    solo = DecodeScheduler(model, registry=reg1, **kw)
    futs = [solo.submit(p, b) for p, b in zip(prompts, budgets)]
    solo.start()
    solo_tok = [f.result(600) for f in futs]
    solo_chains = _chains(torch, solo, prompts)
    solo.shutdown()
    axis = "model" if placement == "tp" else "data"
    mesh = make_mesh((n,), (axis,), device=dev)
    reg = ModelRegistry(mesh=mesh, param_specs=serving_param_specs(
        params, mesh, placement))
    reg.publish(params, version="bf16", activate=True)
    out["resident_bytes"] = _bytes(reg.current().params)
    out["whole_bytes"] = _bytes(params)
    out["layers"] = len(model.blocks)
    if layers is not None:      # the full depth's placement, not served
        full = _mp_flagship(torch, dev)
        with torch.no_grad():
            fp = bf16_params(full.params)
        out["full_resident_bytes"] = _bytes(place_with_specs(
            fp, mesh, serving_param_specs(fp, mesh, placement)))
        out["full_whole_bytes"] = _bytes(fp)
        del full, fp
    _sync(torch, dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sched = DecodeScheduler(model, registry=reg, mesh=mesh, **kw)
    out["page_shape"] = tuple(sched.kv.pages()[0][0].shape)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    if rank == 0:
        # warm up first (the other ranks replay it), then queue every
        # request before the loop starts, as the one-rank run did
        sched.warmup()
        _sync(torch, dev)
        out["warmup"] = K.launch_counts()
        K.reset_launch_counts()
        futs = [sched.submit(p, b) for p, b in zip(prompts, budgets)]
        t1 = time.perf_counter()
        sched.start(warmup=False)
    else:
        sched.start()
    if rank == 0:
        toks = [f.result(600) for f in futs]
        out["serve_s"] = time.perf_counter() - t1
        _sync(torch, dev)
        serve = (K.launch_counts(), K.launches_by_route())
        out["tokens"] = toks
        out["solo_tokens"] = solo_tok
        out["stats"] = {k: sched.stats()[k] for k in
                        ("decode_steps", "prefill_chunks", "tokens")}
        chains = _chains(torch, sched, prompts)
        margins = [_forced_margins(torch, model, params, p, t)
                   for p, t in zip(prompts, solo_tok)]
        out["margins"] = margins
    sched.shutdown()
    _sync(torch, dev)
    out["wall_s"] = time.perf_counter() - t0
    # rank 0: its serving steps (the margins' forwards came after); the
    # other ranks: every step they replayed, rank 0's warmup included
    out["counts"], out["routes"] = (serve if rank == 0 else
                                    (K.launch_counts(),
                                     K.launches_by_route()))
    if torch.device(dev).type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    box = [chains if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    chains = box[0]
    errs = []
    for mine, theirs in zip(chains, solo_chains):
        if not mine or not theirs or len(mine) != len(theirs):
            continue
        got = gather_pages(torch, sched.kv, mine)
        want = gather_pages(torch, solo.kv, theirs)
        h = got[0][0].shape[1]
        lo = rank * h if h < want[0][0].shape[1] else 0
        want = [tuple(t[:, lo:lo + h].float() for t in kv) for kv in want]
        errs.append(page_err(got, want))
    out["page_errs"] = errs
    if placement == "tp":
        # K1-fwd on the tensor-parallel prefill: generate over the placed
        # bf16 weights (this rank's heads), against one rank's prefill
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            1, V, (MP19["gen_B"], MP19["gen_T"])).astype(np.int64)).to(dev)
        placed = reg.current().params
        with torch.no_grad():
            want, _ = model.prefill(params, ids, MP19["gen_T"] + 1)
        _sync(torch, dev)
        K.reset_launch_counts()
        with over(mesh):
            gen = model.generate(placed, ids, MP19["gen_new"])
            got, _ = model.prefill(placed, ids, MP19["gen_T"] + 1)
        _sync(torch, dev)
        out["gen_counts"] = K.launch_counts()
        out["gen_routes"] = K.launches_by_route()
        out["gen_shape"] = tuple(gen.shape)
        out["gen_logit_err"] = _rel(got, want)
    del sched, solo
    return out


def _mp_seq(torch, K, dev, rank, n):
    """(d): ``Attention(seq_axis='seq')`` at hidden 1024 / 16 heads,
    causal, over the ranks' blocks of the sequence, by ring and by
    all-to-all, bf16 and float32: this rank's output block, its input
    gradient block and the parameters' gradients (summed over the ranks)
    against one rank's flash on the whole sequence; K1 launches by route
    and the hop's route."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import (_hop_route,
                                                     all_reduce_sum,
                                                     axis_group, over)
    mesh = make_mesh((n,), ("seq",), device=dev)
    B, T = MP19["seq_B"], MP19["seq_T"]
    Hd, heads = FLAGSHIP["hidden_size"], FLAGSHIP["num_heads"]
    tb = T // n
    out = {}
    r = np.random.RandomState(5)
    x_all = torch.from_numpy(r.randn(B, T, Hd).astype(np.float32))
    cot_all = torch.from_numpy(r.randn(B, T, Hd).astype(np.float32))
    for dt in (torch.bfloat16, torch.float32):
        ref = nn.Attention(Hd, heads, causal=True,
                           generator=torch.Generator().manual_seed(5))
        w = {k: v.detach().to(dev, dt) for k, v in ref.params.items()}
        x = x_all.to(dev, dt).requires_grad_(True)
        p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        o = ref.call(p, x)
        g = torch.autograd.grad((o.float() * cot_all.to(dev)).sum(),
                                [x] + [p[k] for k in sorted(p)])
        blk = slice(rank * tb, (rank + 1) * tb)
        want = (o[:, blk].detach(), g[0][:, blk],
                dict(zip(sorted(p), g[1:])))
        for impl in ("ring", "a2a"):
            m = nn.Attention(Hd, heads, causal=True, seq_axis="seq",
                             seq_impl=impl)
            xb = x_all[:, blk].to(dev, dt).contiguous().requires_grad_(True)
            pb = {k: v.clone().requires_grad_(True) for k, v in w.items()}
            _sync(torch, dev)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with over(mesh):
                ob = m.call(pb, xb)
                gb = torch.autograd.grad(
                    (ob.float() * cot_all[:, blk].to(dev)).sum(),
                    [xb] + [pb[k] for k in sorted(pb)])
                _sync(torch, dev)
                dt_s = time.perf_counter() - t0
                counts, routes = K.launch_counts(), K.launches_by_route()
                pg = {k: all_reduce_sum(v, "seq")
                      for k, v in zip(sorted(pb), gb[1:])}
                hop = _hop_route(xb.detach(), axis_group("seq")[0])
            out[(impl, str(dt))] = {
                "out_err": _rel(ob, want[0]), "dx_err": _rel(gb[0], want[1]),
                "dw_err": max(_rel(pg[k], want[2][k]) for k in pg),
                "counts": counts, "routes": routes, "s": dt_s, "hop": hop}
    return out


def _mp_decode(torch, dev, rank, n):
    """(e): the time-sharded decode, 16 heads, D 64, float32, ``dec_steps``
    steps across the shard edge against one rank's dense attention over
    the whole cache."""
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.seq_decode import make_seq_sharded_decoder
    mesh = make_mesh((n,), ("seq",), device=dev)
    dec = make_seq_sharded_decoder(mesh, "seq")
    B, T, S = MP19["dec_B"], MP19["dec_T"], MP19["dec_steps"]
    H, D = FLAGSHIP["num_heads"], FLAGSHIP["hidden_size"] // \
        FLAGSHIP["num_heads"]
    tl = T // n
    start = tl - S // 2                 # the steps cross the first edge
    r = np.random.RandomState(9)
    kf = torch.zeros(B, H, T, D, device=dev)
    vf = torch.zeros(B, H, T, D, device=dev)
    kf[:, :, :start] = torch.from_numpy(
        r.randn(B, H, start, D).astype(np.float32)).to(dev)
    vf[:, :, :start] = torch.from_numpy(
        r.randn(B, H, start, D).astype(np.float32)).to(dev)
    kc = kf[:, :, rank * tl:(rank + 1) * tl].clone()
    vc = vf[:, :, rank * tl:(rank + 1) * tl].clone()
    err, t0 = 0.0, time.perf_counter()
    for pos in range(start, start + S):
        q, kt, vt = (torch.from_numpy(r.randn(B, H, 1, D).astype(np.float32))
                     .to(dev) for _ in range(3))
        o, kc, vc = dec(q, kt, vt, kc, vc, pos)
        kf[:, :, pos], vf[:, :, pos] = kt[:, :, 0], vt[:, :, 0]
        s = torch.einsum("bhqd,bhtd->bhqt", q, kf[:, :, :pos + 1]) \
            / math.sqrt(D)
        want = torch.einsum("bhqt,bhtd->bhqd", torch.softmax(s, -1),
                            vf[:, :, :pos + 1])
        err = max(err, _rel(o, want))
    return {"err": err, "s": time.perf_counter() - t0, "start": start,
            "edge": tl}


def _mp_train(torch, K, dev, rank, n):
    """(f): the flagship cut to ``train_layers`` layers, float32,
    B8/T1024, ``train_steps`` SGD steps (lr 0.1, momentum 0.9) of the
    recipe, tensor-parallel (a ``model`` mesh, the whole batch a rank) and
    FSDP (a ``data`` mesh, this rank's rows, slices gathered a block at a
    time; each rank's loss its share and the replicated leaves' gradients
    summed), each against the one-rank run on the same batch: max |err|
    over this rank's blocks and the one-rank run's movement."""
    from bigdl_tpu_torch.convert import flatten, unflatten
    from bigdl_tpu_torch.models import lm_loss_chunked
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import all_reduce_sum, over
    from bigdl_tpu_torch.parallel.sharding import (_block_of, fsdp_specs,
                                                   gather_param,
                                                   place_with_specs,
                                                   shard_batch,
                                                   transformer_tp_specs)
    B, T, L = MP19["train_B"], MP19["train_T"], MP19["train_layers"]
    V = FLAGSHIP["vocab_size"]
    r = np.random.RandomState(13)
    x = r.randint(1, V, (B, T)).astype(np.int64)
    y = r.randint(1, V, (B, T)).astype(np.int64)

    def run(p, xb, yb, n_share, mesh, specs):
        leaves = flatten(p)
        for t in leaves.values():
            t.requires_grad_(True)
        fs = flatten(specs) if specs is not None else {}
        optim = SGD(learningrate=MP19["train_lr"], momentum=0.9)
        state = optim.init_state(p)
        for _ in range(MP19["train_steps"]):
            h = model.hidden_states(p, xb, training=False)
            emb = gather_param(p["embed"], model.embed.shape)
            loss = lm_loss_chunked(h, emb, yb, chunk=128) / n_share
            g = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
            if n_share > 1:
                for k in g:
                    if not fs[k]:
                        g[k] = all_reduce_sum(g[k], "data")
            with torch.no_grad():
                optim.update(unflatten(g), p, state, MP19["train_lr"])
        return p

    model = _mp_flagship(torch, dev, layers=L, max_len=T, seed=7)
    init = {k: v.detach().clone() for k, v in flatten(model.params).items()}
    ref = run(unflatten({k: v.clone() for k, v in init.items()}),
              torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), 1,
              None, None)
    ref = {k: v.detach() for k, v in flatten(ref).items()}
    move = max(float((ref[k] - init[k]).abs().max()) for k in ref)
    out = {"move": move}
    for placement in ("tp", "fsdp"):
        axis = "model" if placement == "tp" else "data"
        mesh = make_mesh((n,), (axis,), device=dev)
        whole = unflatten({k: v.clone() for k, v in init.items()})
        specs = (transformer_tp_specs(whole) if placement == "tp"
                 else fsdp_specs(whole, mesh))
        p = place_with_specs(whole, mesh, specs)
        xb, yb = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        if placement == "fsdp":
            xb, yb = shard_batch(x, mesh), shard_batch(y, mesh)
        _sync(torch, dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with over(mesh):
            p = run(p, xb, yb, n if placement == "fsdp" else 1, mesh, specs)
        _sync(torch, dev)
        fs = flatten(specs)
        err = max(float((t.detach() - _block_of(ref[k], mesh, fs[k]))
                        .abs().max()) for k, t in flatten(p).items())
        out[placement] = {"err": err, "s": time.perf_counter() - t0,
                          "counts": K.launch_counts(),
                          "routes": K.launches_by_route(),
                          "resident_bytes": _bytes(p),
                          "whole_bytes": _bytes(whole)}
        del p
    return out


def _mp_pipe_moe(torch, dev, rank, n):
    """(g): ``gpipe`` over the ranks as stages and ``moe_ffn`` with one
    expert a rank, at the MoE LM's width (hidden 1024, filter 4096),
    float32, against one rank holding every stage / expert."""
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import all_reduce_sum, over
    from bigdl_tpu_torch.parallel.moe import moe_ffn, top1_routing, \
        expert_capacity
    from bigdl_tpu_torch.parallel.pipeline import gpipe
    d, F = FLAGSHIP["hidden_size"], MP19["moe_filter"]   # the MoE LM's
    r = np.random.RandomState(17)

    def t(*s, scale=1.0):
        return torch.from_numpy((r.randn(*s) * scale).astype(np.float32)) \
            .to(dev)
    out = {}
    # GPipe: stage i is tanh(h @ w_i + b_i)
    w, b = t(n, d, d, scale=d ** -0.5), t(n, d, scale=0.1)
    x, y = t(MP19["pipe_micro"], MP19["pipe_rows"], d), \
        t(MP19["pipe_micro"], MP19["pipe_rows"], d)
    ws = {"w": w.clone().requires_grad_(True),
          "b": b.clone().requires_grad_(True)}
    h = x
    for i in range(n):
        h = torch.tanh(h @ ws["w"][i] + ws["b"][i])
    gw, gb = torch.autograd.grad(((h - y) ** 2).mean(), [ws["w"], ws["b"]])
    mesh = make_mesh((n,), ("pipe",), device=dev)
    p = {"w": w[rank:rank + 1].clone().requires_grad_(True),
         "b": b[rank:rank + 1].clone().requires_grad_(True)}
    run = gpipe(lambda sp, hh: torch.tanh(hh @ sp["w"] + sp["b"]), "pipe")
    t0 = time.perf_counter()
    with over(mesh):
        o = run(p, x)
        g = torch.autograd.grad(((o - y) ** 2).mean() / n, [p["w"], p["b"]])
    _sync(torch, dev)
    out["pipe"] = {"out_err": _rel(o, h), "dw_err": _rel(g[0], gw[rank:rank
                                                                   + 1]),
                   "db_err": _rel(g[1], gb[rank:rank + 1]),
                   "s": time.perf_counter() - t0}
    # MoE: expert e is relu(h @ w1_e) @ w2_e; this rank's tokens
    E, tl = n, MP19["moe_tokens"]
    router = t(d, E, scale=d ** -0.5)
    w1, w2 = t(E, d, F, scale=d ** -0.5), t(E, F, d, scale=F ** -0.5)
    xs = t(E * tl, d)
    xl = xs[rank * tl:(rank + 1) * tl]
    cap = expert_capacity(tl, E, MP19["moe_cap"])
    dispatch, combine, aux_ref = top1_routing(xl @ router, cap)
    e_in = torch.einsum("td,tec->ecd", xl, dispatch)
    back = torch.stack([torch.relu(e_in[e] @ w1[e]) @ w2[e]
                        for e in range(E)])
    want = torch.einsum("tec,ecd->td", combine, back)
    mesh = make_mesh((n,), ("expert",), device=dev)
    run = moe_ffn(lambda ep, hh: torch.relu(hh @ ep["w1"]) @ ep["w2"],
                  "expert", MP19["moe_cap"])
    t0 = time.perf_counter()
    with over(mesh), torch.no_grad():
        yl, aux = run(router, {"w1": w1[rank:rank + 1],
                               "w2": w2[rank:rank + 1]}, xl)
        aux_all = all_reduce_sum(aux_ref, "expert") / n
    _sync(torch, dev)
    out["moe"] = {"out_err": _rel(yl, want), "aux": float(aux),
                  "aux_ref": float(aux_all), "s": time.perf_counter() - t0,
                  "capacity": cap}
    return out


def _trace_mesh_swaps(torch, swap):
    """Each rank's spilled pages by handle id (at the gather, before the
    blocks go back) and its pages right after each refill (rank 0 in
    ``_adopt``, the others in ``_replay``): ({hid: pages}, [(hids,
    pages)])."""
    spilled, refills = {}, []
    stage_out, adopt, replay = swap._stage_out, swap._adopt, swap._replay

    def stage_out_t(plans, pages):
        for h, s, n in plans:
            spilled[h.hid] = [(k[s:s + n].clone(), v[s:s + n].clone())
                              for k, v in pages]
        return stage_out(plans, pages)

    def adopt_t(owner, layers, nbytes, handles):
        ids = adopt(owner, layers, nbytes, handles)
        refills.append(([h.hid for h in handles],
                        gather_pages(torch, swap.kv, ids)))
        return ids

    def replay_t(op, payload):
        replay(op, payload)
        if op == "refill":
            refills.append((list(payload[1]),
                            gather_pages(torch, swap.kv, payload[0])))

    swap._stage_out, swap._adopt, swap._replay = stage_out_t, adopt_t, \
        replay_t
    return spilled, refills


def _mp_host_tier(torch, K, dev, rank, n):
    """(a2): the tensor-parallel flagship (bf16 weights, float32 pages,
    8 of 16 kv heads a rank) with the host tier under the mesh, a device
    pool of ``tier_blocks`` blocks: three requests in turn, the second's
    admission spilling the first's chain and the third (the first's
    prefix) refilling it. Rank 0's tokens against the one-rank scheduler
    with the same settings, each rank's host-tier counts and bytes, and
    whether each refill wrote this rank's pages bit for bit as they were
    spilled."""
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.sharding import serving_param_specs
    from bigdl_tpu_torch.serving import DecodeScheduler, ModelRegistry
    from bigdl_tpu_torch.utils.amp import bf16_params
    model = _mp_flagship(torch, dev)
    with torch.no_grad():
        params = bf16_params(model.params)
    V = FLAGSHIP["vocab_size"]
    rng = np.random.RandomState(7)
    pre = rng.randint(1, V, MP19["tier_prefix"]).astype(np.int32)
    ta, tc = MP19["tier_tails"]
    prompts = [np.concatenate([pre, rng.randint(1, V, ta).astype(np.int32)]),
               rng.randint(1, V, MP19["tier_other"]).astype(np.int32),
               np.concatenate([pre, rng.randint(1, V, tc).astype(np.int32)])]
    kw = dict(max_slots=2, block_size=MP19["block"],
              max_seq_len=MP19["tier_seq"], prefill_chunk=MP19["chunk"],
              num_blocks=MP19["tier_blocks"], host_blocks=64)
    new = MP19["tier_new"]
    out = {}
    reg1 = ModelRegistry(device=model.device)
    reg1.publish(params, version="bf16", activate=True)
    with DecodeScheduler(model, registry=reg1, **kw) as solo:
        out["solo_tokens"] = [solo.submit(p, new).result(600)
                              for p in prompts]
    mesh = make_mesh((n,), ("model",), device=dev)
    reg = ModelRegistry(mesh=mesh, param_specs=serving_param_specs(
        params, mesh, "tp"))
    reg.publish(params, version="bf16", activate=True)
    sched = DecodeScheduler(model, registry=reg, mesh=mesh, **kw)
    spilled, refills = _trace_mesh_swaps(torch, sched.kv_swap)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    sched.start(warmup=False)
    if rank == 0:
        out["tokens"] = [sched.submit(p, new).result(600) for p in prompts]
        st = sched.stats()
        out["prefix"] = {k: st["prefix"][k] for k in
                         ("spills", "refills", "hits_after_spill")}
    sched.shutdown()
    _sync(torch, dev)
    out["s"] = time.perf_counter() - t0
    out["counts"], out["routes"] = K.launch_counts(), K.launches_by_route()
    if rank == 0:
        out["margins"] = [_forced_margins(torch, model, params, p, t)
                          for p, t in zip(prompts, out["solo_tokens"])]
    st = sched.kv_swap.stats()
    out["host"] = {k: st[k] for k in ("swap_out_bytes", "swap_in_bytes",
                                      "host_spills", "host_blocks_in_use")}
    out["n_refills"] = len(refills)
    same, blocks = [], 0
    for hids, got in refills:
        want = [tuple(torch.cat([spilled[h][li][half] for h in hids])
                      for half in (0, 1)) for li in range(len(got))]
        same.append(same_pages(got, want))
        blocks += int(got[0][0].shape[0])
    out["refilled_bitwise"], out["refilled_blocks"] = same, blocks
    out["page_heads"] = int(sched.kv.pages()[0][0].shape[1])
    del sched
    return out


def _mp_engine(torch, K, dev, rank, n):
    """(c): ``ServingEngine(mesh=<('data',) of 2>, placement="fsdp")`` on
    the flagship's forward cut to ``fsdp_layers`` layers (float32), the
    model's per-block gather, then the whole-tree gather the engine runs
    for a generic model, each with this rank's peak memory; rank 0's
    outputs against one rank's forward."""
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import ServingEngine
    model = _mp_flagship(torch, dev, layers=MP19["fsdp_layers"])
    V = FLAGSHIP["vocab_size"]
    xs = np.random.RandomState(9).randint(
        1, V, (MP19["eng_req"], MP19["eng_T"])).astype(np.int64)
    mesh = make_mesh((n,), ("data",), device=dev)
    out = {}
    for arm in ("per_block", "whole_tree"):
        eng = ServingEngine(model, input_shape=(MP19["eng_T"],),
                            max_batch=MP19["eng_batch"], mesh=mesh,
                            placement="fsdp", name=f"fsdp_{arm}",
                            warmup=False)
        eng._per_block = arm == "per_block"
        _sync(torch, dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with eng:
            if rank == 0:
                outs = [f.result(600) for f in
                        [eng.submit(x) for x in xs]]
        _sync(torch, dev)
        rec = {"s": time.perf_counter() - t0,
               "resident_bytes": _bytes(eng.registry.current().params)}
        if torch.device(dev).type == "cuda":
            rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        if rank == 0:
            with torch.no_grad():
                want = model.apply(model.params, None,
                                   torch.from_numpy(xs).to(dev), False)[0]
            rec["err"] = max(_rel(torch.from_numpy(np.asarray(o)), w)
                             for o, w in zip(outs, want))
        out[arm] = rec
        del eng
    out["whole_bytes"] = _bytes(model.params)
    return out


def phase19_rank(rank, n, port, spec):
    """One of phase 19's two ranks sharing the card over gloo: (a), (b),
    (d), (e), (f), (g) in order (every collective a path runs, both
    ranks run); writes its findings for the main process."""
    import torch
    from bigdl_tpu_torch import kernels as K
    from bigdl_tpu_torch.utils import engine
    with open(spec, "rb") as f:
        cfg = pickle.load(f)
    MP19.update(cfg["sizes"][0])
    FLAGSHIP.update(cfg["sizes"][1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = cfg["dev"]
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=MP19["timeout"]))
    engine.init_process_group(device=dev)
    out = {}
    for key, fn in (("a", lambda: _mp_serve(torch, K, dev, rank, n, "tp")),
                    ("a2", lambda: _mp_host_tier(torch, K, dev, rank, n)),
                    ("b", lambda: _mp_serve(torch, K, dev, rank, n, "fsdp")),
                    ("c", lambda: _mp_engine(torch, K, dev, rank, n)),
                    ("d", lambda: _mp_seq(torch, K, dev, rank, n)),
                    ("e", lambda: _mp_decode(torch, dev, rank, n)),
                    ("f", lambda: _mp_train(torch, K, dev, rank, n)),
                    ("g", lambda: _mp_pipe_moe(torch, dev, rank, n))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key + "_s"] = time.perf_counter() - t0
        _MP_LM.clear()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    with open(cfg["out"] + f".{rank}", "wb") as f:
        pickle.dump(out, f)
    sys.stdout.flush()
    os._exit(0)


def _route_sum(outs, name, route):
    return sum(o.get(name, {}).get(route, 0) for o in outs)


def model_parallel(torch, K, card, dev="cuda", tmp=None):
    """Phase 19: model parallelism on two gloo ranks sharing the card
    (processes of this script, ``--phase19-rank``; sizes in ``MP19`` and
    ``FLAGSHIP``). (a) the flagship (bf16 weights, float32 pages) served
    by ``DecodeScheduler(max_slots=8, block_size=16, prefill_chunk=32,
    mesh=<('model',) of 2>)`` over a tensor-parallel registry, the first
    ``n_req`` (4) of phase 4's requests: tokens against the one-rank
    scheduler up to the first
    near-tie, each rank's pages (8 of 16 kv heads) of every prompt chain
    resident in both pools against the one-rank pool's heads within
    ``PAGE_TOL``, K2 launches per rank, resident parameter bytes per rank,
    and ``generate`` over the placed weights (K1-fwd at 8 heads a rank);
    (b) the first ``fsdp_req`` (4) of the same requests (budgets capped at
    ``fsdp_budget``) under FSDP on a ('data',) mesh of 2, the
    flagship cut to ``fsdp_layers`` layers (pages whole), with peak memory
    per rank and the full depth's resident bytes; (d) ``Attention(seq_axis='seq')`` at 1024 / 16
    heads, causal, B2/T2048 split over the ranks, ring and a2a, bf16 and
    float32, forward and gradients against one rank's flash, K1 launches
    by route and the hop's route; (e) the time-sharded decode (16 heads, D
    64, Tmax 4096, 64 steps across the edge); (f) tensor-parallel and FSDP
    training of the flagship cut to 2 layers (float32, B8/T1024, 3 steps)
    against one rank, each error also as a share of the parameters'
    movement; (g) ``gpipe`` over 2 stages and ``moe_ffn`` over 2 experts
    at the MoE LM's width against one rank. Returns the model-parallel
    paths' launches by kernel and route, summed over the ranks."""
    t19 = time.perf_counter()
    tmp = tmp or tempfile.mkdtemp(prefix="phase19_")
    spec = os.path.join(tmp, "spec19.pkl")
    res_path = os.path.join(tmp, "out19")
    with open(spec, "wb") as f:
        pickle.dump({"dev": dev, "out": res_path,
                     "sizes": (MP19, FLAGSHIP)}, f)
    port = _free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    print(f"[19] model parallelism over 2 gloo ranks sharing the card "
          f"({card})", flush=True)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--phase19-rank", str(r), "2", str(port),
                               spec], cwd=root) for r in range(2)]
    deadline = time.monotonic() + MP19["timeout"]
    try:
        while any(p.poll() is None for p in procs):
            check(time.monotonic() < deadline, f"the phase 19 ranks did not "
                  f"finish in {MP19['timeout']} s")
            check(all(p.poll() in (None, 0) for p in procs),
                  f"a phase 19 rank failed: {[p.poll() for p in procs]}")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"phase 19 ranks exited {[p.returncode for p in procs]}")
    res = []
    for r in range(2):
        with open(res_path + f".{r}", "rb") as f:
            res.append(pickle.load(f))
    r0 = res[0]
    L = FLAGSHIP["num_layers"]
    heads = FLAGSHIP["num_heads"]
    serve_k2 = []
    for key, placement in (("a", "tp"), ("b", "fsdp")):
        a = r0[key]
        compared = 0
        for i, (got, want, m) in enumerate(zip(a["tokens"], a["solo_tokens"],
                                               a["margins"])):
            check(got.size == want.size, f"({key}) request {i}: {got.size} "
                  f"tokens, one rank {want.size}")
            compared += agree(f"({key}) request {i}", got, want, m)
        check(compared > 0, f"({key}) no served step cleared the margin")
        errs = [e for o in res for e in o[key]["page_errs"]]
        n_chains = [len(o[key]["page_errs"]) for o in res]
        kvh = [o[key]["page_shape"][1] for o in res]
        want_kvh = heads // 2 if placement == "tp" else heads
        check(min(n_chains) > 0, f"({key}) no prompt chain resident in "
              f"both pools: {n_chains}")
        check(max(errs) <= PAGE_TOL, f"({key}) pages against the one-rank "
              f"pool's heads: max relative err {max(errs)}")
        check(kvh == [want_kvh, want_kvh], f"({key}) pages hold {kvh} kv "
              f"heads a rank, expected {want_kvh}")
        k2 = [a["counts"]["paged_attention"],
              res[1][key]["counts"]["paged_attention"]
              - a["warmup"]["paged_attention"]]
        serve_k2.append(k2)
        check(k2[0] > 0 and k2[0] == k2[1], f"({key}) K2 launches per "
              f"rank {k2} (the worker replays every step of rank 0's)")
        check(only_on(a["routes"]["paged_attention"], "f32_split", k2[0]),
              f"({key}) K2 routes {a['routes']['paged_attention']}")
        check(all(o[key]["counts"]["flash_fwd"] == 0 for o in res),
              f"({key}) serving launched the flash kernel")
        rb = [o[key]["resident_bytes"] for o in res]
        check(all(b < a["whole_bytes"] for b in rb),
              f"({key}) resident parameter bytes {rb} of "
              f"{a['whole_bytes']}")
        peak = [o[key].get("peak_bytes") for o in res]
        st = a["stats"]
        if "full_resident_bytes" in a:
            fr = [o[key]["full_resident_bytes"] for o in res]
            check(all(b < a["full_whole_bytes"] for b in fr),
                  f"({key}) full-depth resident bytes {fr}")
            print(f"    ({key}) full-depth {placement} placement: resident "
                  f"parameter bytes per rank {fr} of "
                  f"{a['full_whole_bytes']} ({card})", flush=True)
        print(f"    ({key}) {placement} serving, {a['layers']} layers, "
              f"{len(a['tokens'])} requests: "
              f"{sum(t.size for t in a['tokens'])} tokens in "
              f"{a['serve_s']:.3f} s ({st['decode_steps']} decode steps, "
              f"{st['prefill_chunks']} prefill chunks); tokens equal to one "
              f"rank's at {compared} steps before a near-tie; pages "
              f"{kvh[0]} of {heads} kv heads a rank, {sum(n_chains)} chains "
              f"against the one-rank pool, max relative err {max(errs):.3e} "
              f"(tol {PAGE_TOL}); K2 launches per rank {k2}; resident "
              f"parameter bytes per rank {rb} of {a['whole_bytes']}"
              + (f"; peak memory per rank {[round(p / 2**30, 3) for p in peak]} GiB"
                 if peak[0] is not None else "")
              + f" ({card})", flush=True)
    # (a2) the host tier under the tensor-parallel mesh
    t2 = r0["a2"]
    compared = 0
    for i, (got, want) in enumerate(zip(t2["tokens"], t2["solo_tokens"])):
        check(got.size == want.size, f"(a2) request {i}: {got.size} tokens, "
              f"one rank {want.size}")
        compared += agree(f"(a2) request {i}", got, want, t2["margins"][i])
    hosts = [o["a2"]["host"] for o in res]
    check(all(h == hosts[0] for h in hosts), f"(a2) host-tier counts "
          f"differ across the ranks: {hosts}")
    check(hosts[0]["host_spills"] >= 2 and hosts[0]["swap_in_bytes"] > 0
          and hosts[0]["host_blocks_in_use"] == 0, f"(a2) the pool never "
          f"spilled and refilled: {hosts[0]} ({t2['prefix']})")
    check(t2["prefix"]["hits_after_spill"] == 1, f"(a2) prefix {t2['prefix']}")
    nref = [o["a2"]["n_refills"] for o in res]
    check(nref[0] > 0 and nref == [nref[0]] * 2 and all(
        o["a2"]["refilled_bitwise"] and all(o["a2"]["refilled_bitwise"])
        for o in res), f"(a2) refills per rank {nref}, bit for bit "
          f"{[o['a2']['refilled_bitwise'] for o in res]}")
    check(all(o["a2"]["page_heads"] == heads // 2 for o in res),
          "(a2) pages are not split over the ranks' kv heads")
    k2_a2 = [o["a2"]["counts"]["paged_attention"] for o in res]
    check(k2_a2[0] > 0 and k2_a2[0] == k2_a2[1] and all(
        only_on(o["a2"]["routes"]["paged_attention"], "f32_split", k)
        for o, k in zip(res, k2_a2)), f"(a2) K2 launches per rank {k2_a2}")
    serve_k2.append(k2_a2)
    print(f"    (a2) tensor-parallel serving with the host tier ("
          f"{MP19['tier_blocks']} device blocks, 3 requests in turn): "
          f"prefix {t2['prefix']}; per rank spills {hosts[0]['host_spills']}"
          f", bytes out {[h['swap_out_bytes'] for h in hosts]}, in "
          f"{[h['swap_in_bytes'] for h in hosts]}; refills per rank {nref}, "
          f"{[o['a2']['refilled_blocks'] for o in res]} blocks bit for bit "
          f"their pages before the spill; tokens equal to one rank's at "
          f"{compared} steps before a near-tie; K2 launches per rank "
          f"{k2_a2}; {t2['s']:.3f} s ({card})", flush=True)
    # (c) the engine over FSDP: the per-block gather against the whole tree
    c = r0["c"]
    errs = c["per_block"]["err"], c["whole_tree"]["err"]
    check(max(errs) <= ENG19_TOL, f"(c) engine outputs against one rank: "
          f"relative errs {errs} (tol {ENG19_TOL})")
    peaks = [(o["c"]["per_block"].get("peak_bytes"),
              o["c"]["whole_tree"].get("peak_bytes")) for o in res]
    if dev == "cuda":
        check(all(pb < wt for pb, wt in peaks), f"(c) the per-block "
              f"gather's peak memory is not under the whole tree's: {peaks}")
    print(f"    (c) ServingEngine(mesh=<('data',) of 2>, placement='fsdp') "
          f"on the flagship's forward at {MP19['fsdp_layers']} layers, "
          f"{MP19['eng_req']} requests of {MP19['eng_T']} tokens: relative "
          f"err against one rank per-block {errs[0]:.3e}, whole-tree "
          f"{errs[1]:.3e} (tol {ENG19_TOL}); dispatch peak memory per rank "
          f"(GiB, per-block / whole-tree) "
          f"{[tuple(round(x / 2**30, 3) for x in p) if p[0] else p for p in peaks]}"
          f"; resident bytes per rank "
          f"{[o['c']['per_block']['resident_bytes'] for o in res]} of "
          f"{c['whole_bytes']}; {c['per_block']['s']:.3f} / "
          f"{c['whole_tree']['s']:.3f} s ({card})", flush=True)
    a = r0["a"]
    gen = [o["a"]["gen_counts"]["flash_fwd"] for o in res]
    check(gen == [2 * L, 2 * L] and all(
        only_on(o["a"]["gen_routes"]["flash_fwd"], "bf16_sm90", 2 * L)
        for o in res), f"(a) tensor-parallel generate + prefill K1-fwd "
          f"launches {gen}, expected {2 * L} a rank on bf16_sm90")
    check(a["gen_logit_err"] <= 1e-2, f"(a) tensor-parallel prefill logits "
          f"against one rank: relative err {a['gen_logit_err']}")
    print(f"    (a) generate over the tensor-parallel weights: "
          f"{a['gen_shape']}, K1-fwd launches per rank {gen} at "
          f"{heads // 2} heads; prefill logits against one rank's, max "
          f"relative err {a['gen_logit_err']:.3e} ({card})", flush=True)
    for (impl, dt), rec in sorted(r0["d"].items()):
        errs = [max(o["d"][(impl, dt)][k] for k in ("out_err", "dx_err",
                                                   "dw_err")) for o in res]
        tol = SEQ19_TOL[dt]
        route = "bf16_sm90" if "bfloat16" in dt else "f32_sm90"
        launches = [(o["d"][(impl, dt)]["counts"]["flash_fwd"],
                     o["d"][(impl, dt)]["counts"]["flash_bwd"])
                    for o in res]
        want_l = ([(r + 1, r + 1) for r in range(2)] if impl == "ring"
                  else [(1, 1), (1, 1)])
        check(max(errs) <= tol, f"(d) {impl} {dt}: relative errs {errs} "
              f"(tol {tol})")
        check(launches == want_l, f"(d) {impl} {dt} K1 launches (fwd, bwd) "
              f"per rank {launches}, expected {want_l}")
        check(all(only_on(o["d"][(impl, dt)]["routes"]["flash_fwd"], route,
                          o["d"][(impl, dt)]["counts"]["flash_fwd"])
                  for o in res), f"(d) {impl} {dt} routes")
        hop = rec["hop"]
        check(hop == ("host_staged" if dev == "cuda" else "send_recv"),
              f"(d) the hop's route {hop}")
        print(f"    (d) Attention(seq_axis) {impl} {dt}: output / dx / dW "
              f"against one rank's flash, max relative err per rank "
              f"{[round(e, 8) for e in errs]} (tol {tol}); K1 (fwd, bwd) "
              f"launches per rank {launches} on {route}; hop "
              f"{hop}; {rec['s']:.3f} s ({card})", flush=True)
    e = [o["e"]["err"] for o in res]
    check(max(e) <= DEC19_TOL, f"(e) time-sharded decode errs {e}")
    print(f"    (e) time-sharded decode, {MP19['dec_steps']} steps from "
          f"{r0['e']['start']} across the edge at {r0['e']['edge']}: max "
          f"relative err per rank {e} (tol {DEC19_TOL}); "
          f"{r0['e']['s']:.3f} s ({card})", flush=True)
    move = r0["f"]["move"]
    for placement in ("tp", "fsdp"):
        errs = [o["f"][placement]["err"] for o in res]
        rel = [x / move for x in errs]
        fl = [(o["f"][placement]["counts"]["flash_fwd"],
               o["f"][placement]["counts"]["flash_bwd"]) for o in res]
        n_l = MP19["train_layers"] * MP19["train_steps"]
        check(max(errs) <= GLOO_TOL and max(rel) <= GLOO_REL,
              f"(f) {placement} training against one rank: errs {errs} "
              f"({rel} of the movement)")
        check(fl == [(n_l, n_l)] * 2, f"(f) {placement} K1 launches {fl}, "
              f"expected {n_l} each a rank")
        rb = [o["f"][placement]["resident_bytes"] for o in res]
        print(f"    (f) {placement} training, {MP19['train_layers']} layers, "
              f"B{MP19['train_B']}/T{MP19['train_T']}, "
              f"{MP19['train_steps']} steps: max abs err per rank against "
              f"one rank {errs}; the one-rank run moved the parameters by "
              f"{move:.3e}, err / move {[round(x, 8) for x in rel]} (tol "
              f"{GLOO_REL:g}); K1 (fwd, bwd) launches per rank {fl}; "
              f"resident parameter bytes per rank {rb} of "
              f"{r0['f'][placement]['whole_bytes']}; "
              f"{r0['f'][placement]['s']:.3f} s ({card})", flush=True)
    for o in res:
        g = o["g"]
        check(max(g["pipe"]["out_err"], g["pipe"]["dw_err"],
                  g["pipe"]["db_err"], g["moe"]["out_err"]) <= PIPE19_TOL
              and abs(g["moe"]["aux"] - g["moe"]["aux_ref"]) <= 1e-5,
              f"(g) gpipe / moe_ffn against one rank: {g}")
    g = r0["g"]
    print(f"    (g) gpipe over 2 stages: output / dW / db relative errs "
          f"{g['pipe']['out_err']:.3e} / {g['pipe']['dw_err']:.3e} / "
          f"{g['pipe']['db_err']:.3e}; moe_ffn over 2 experts (capacity "
          f"{g['moe']['capacity']}): output {g['moe']['out_err']:.3e}, aux "
          f"{g['moe']['aux']:.6f} against {g['moe']['aux_ref']:.6f} (tol "
          f"{PIPE19_TOL}) ({card})", flush=True)
    routes = [o["d"][k]["routes"] for o in res for k in o["d"]] \
        + [o["f"][p]["routes"] for o in res for p in ("tp", "fsdp")] \
        + [o["a"]["gen_routes"] for o in res]
    launches = {
        "flash_fwd_bf16": _route_sum(routes, "flash_fwd", "bf16_sm90"),
        "flash_bwd_bf16": _route_sum(routes, "flash_bwd", "bf16_sm90"),
        "flash_fwd_f32": _route_sum(routes, "flash_fwd", "f32_sm90"),
        "flash_bwd_f32": _route_sum(routes, "flash_bwd", "f32_sm90"),
        "paged_attention": sum(sum(k) for k in serve_k2)}
    secs = {k: round(r0[k + "_s"], 1)
            for k in ("a", "a2", "b", "c", "d", "e", "f", "g")}
    phase_s = time.perf_counter() - t19
    print(f"[19] phase 19: {phase_s:.1f} s (rank 0's parts {secs}); "
          f"launches on the model-parallel paths, both ranks {launches}",
          flush=True)
    return {"launches": launches, "phase_s": phase_s}


# -- phase 20: the serving fleet across processes -------------------------------

# three agent processes of ``python -m bigdl_tpu_torch.serving.fleet`` on the
# card, started at once: a replica r0, a prefill agent pf and a decode agent
# d0, each the flagship with bf16 weights (from one float32 parameter file)
# and float32 pages under phase 4's scheduler settings with the prefix
# cache; a pool of ``num_blocks`` blocks so the handed-off chains stay
# resident for the page checks
FLEET20 = dict(slots=8, block=16, chunk=32, max_seq=384, max_len=512,
               num_blocks=8 * 24 * 2 + 1, beat_s=0.25, start_timeout=240,
               swap_req=4, warm=2, timeout=600)


def _fleet_procs_alive(procs, what):
    dead = {n: p.poll() for n, p in procs.items() if p.poll() is not None}
    check(not dead, f"{what}: fleet agent processes exited {dead}")


def _agent_log(root, name):
    """Where an agent's output goes: under ``chiprun_out/`` of the
    checkout (listed in .gitignore), so it outlives the phase's temporary
    directory."""
    d = os.path.join(root, "chiprun_out", "phase20_agents")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"agent_{name}.log")


# an agent process: the fleet entry point with every health event written
# to its log as one "HEALTH {json}" line (quarantines, prefix inserts
# skipped, refused handoffs)
_AGENT_MAIN = (
    "import json, sys\n"
    "from bigdl_tpu_torch.observability import health\n"
    "health.listeners.append(lambda e: print('HEALTH', json.dumps(e, "
    "default=str), file=sys.stderr, flush=True))\n"
    "from bigdl_tpu_torch.serving.fleet import main\n"
    "raise SystemExit(main(['fleet', sys.argv[1]]))\n")


def _health_events(log_path):
    """The health events an agent's log holds, by kind."""
    kinds = {}
    try:
        with open(log_path) as f:
            for line in f:
                if line.startswith("HEALTH "):
                    k = json.loads(line[7:]).get("kind", "?")
                    kinds[k] = kinds.get(k, 0) + 1
    except OSError:
        pass
    return kinds


def _pf_report(pf, root, exports):
    """The prefill agent's ledger state after (b): quarantine,
    corruptions, prefix evictions, its health events (the
    ``prefix_insert_skipped`` ones among them) and the tokens each export
    carried."""
    st = pf.stats()
    pre = st.get("prefix") or {}
    return {"quarantined": st.get("quarantined"),
            "kv_corruptions": st.get("kv_corruptions"),
            "prefix_entries": pre.get("entries"),
            "prefix_evictions": pre.get("evictions"),
            "prefix_spills": pre.get("spills"),
            "kv_blocks_in_use": (st.get("kv") or {}).get("blocks_in_use"),
            "health_events": _health_events(_agent_log(root, "pf")),
            "export_tokens": [int(m["tokens"]) for _, m, _ in exports]}


def _spawn_agent(fd, name, role, params_path, dev, idx, root):
    from bigdl_tpu_torch.serving.fleet import member_path
    if os.path.exists(member_path(fd, name)):
        os.remove(member_path(fd, name))
    cfg = {"fleet_dir": fd, "name": name, "role": role,
           "beat_s": FLEET20["beat_s"], "process_index": idx,
           "model": dict(FLAGSHIP, max_len=FLEET20["max_len"]),
           "params_path": params_path, "device": dev, "dtype": "bfloat16",
           "scheduler": dict(max_slots=FLEET20["slots"],
                             block_size=FLEET20["block"],
                             max_seq_len=FLEET20["max_seq"],
                             prefill_chunk=FLEET20["chunk"],
                             num_blocks=FLEET20["num_blocks"])}
    path = os.path.join(fd, f"cfg_{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    log = open(_agent_log(root, name), "w")
    env = dict(os.environ, PYTHONPATH=root)
    p = subprocess.Popen([sys.executable, "-c", _AGENT_MAIN, path],
                         stdout=log, stderr=subprocess.STDOUT, cwd=root,
                         env=env)
    log.close()
    return p


def _wait_agents(fd, procs, timeout_s):
    """Every agent's member doc, failing as soon as one exits."""
    from bigdl_tpu_torch.serving.fleet import read_member
    deadline = time.monotonic() + timeout_s
    docs = {}
    while len(docs) < len(procs):
        _fleet_procs_alive(procs, "start-up")
        check(time.monotonic() < deadline, f"fleet agents not registered "
              f"in {timeout_s} s: {sorted(set(procs) - set(docs))}")
        for n in procs:
            if n not in docs:
                d = read_member(fd, n)
                if d is not None:
                    docs[n] = d
        time.sleep(0.05)
    return docs


def _agent_routes(rep):
    return rep.stats()["launches_by_route"]


def _route_delta(after, before, name, route):
    return after[name].get(route, 0) - before[name].get(route, 0)


def fleet(torch, K, card, p4, dev="cuda", tmp=None):
    """Phase 20: the serving fleet across processes at the flagship's full
    width. (a) ``Router`` over r0 serves phase 4's 16 requests, tokens
    against phase 4's up to the first near-tie; (b)
    ``DisaggregatedFleet(pf -> d0)`` serves them again: every prompt hands
    its aligned prefix off (none failed or refused), d0's adopted pages
    bit for bit pf's export, pf's export against the dense prefill's K / V
    within ``PAGE_TOL``, handoff ms and bytes; (c) a fleet swap to a
    perturbed second version over r0, pf and d0 with requests in flight:
    no response mixes versions; (d) a ``FleetController`` scale-up that
    spawns a fourth agent and warms it from r0, then a scale-down, no
    request lost. The agents' kernel launches (their ``stats`` op) count
    toward the kernels line."""
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import (DisaggregatedFleet, FleetController,
                                         FleetMonitor, RemoteReplica, Router,
                                         ScalePolicy, fleet_threads_alive,
                                         transport_threads_alive)
    from bigdl_tpu_torch.utils.amp import bf16_params
    t20 = time.perf_counter()
    own_tmp = tmp is None
    tmp = tmp or tempfile.mkdtemp(prefix="phase20_")
    fd = os.path.join(tmp, "fleet")
    os.makedirs(fd, exist_ok=True)
    root = os.path.dirname(os.path.abspath(__file__))
    print(f"[20] the serving fleet: three agent processes on the card "
          f"({card})", flush=True)
    model = TransformerLM(**dict(FLAGSHIP, max_len=FLEET20["max_len"]),
                          device=dev, seed=0)
    params_path = os.path.join(tmp, "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(convert.host_copy_tree(model.params), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    with torch.no_grad():
        params = bf16_params(model.params)
    procs = {n: _spawn_agent(fd, n, role, params_path, dev, i + 1, root)
             for i, (n, role) in enumerate((("r0", "replica"),
                                            ("pf", "prefill"),
                                            ("d0", "decode")))}
    reps, routers, mon, out = [], [], None, {}
    try:
        # the dense prefill's K / V of the first prompts, while the agents
        # start up
        bs, al = FLEET20["block"], max(FLEET20["block"], FLEET20["chunk"])
        dense = {i: dense_pages(torch, model, params, p[:p.size // al * al],
                                bs)
                 for i, p in enumerate(p4["prompts"]) if p.size >= al}
        dense = dict(list(dense.items())[:2])
        docs = _wait_agents(fd, procs, FLEET20["start_timeout"])
        t_up = time.perf_counter() - t20
        r0, pf, d0 = (RemoteReplica(docs[n], fleet_dir=fd)
                      for n in ("r0", "pf", "d0"))
        reps = [r0, pf, d0]
        pf.start()
        before = {r.name: _agent_routes(r.start()) for r in reps}
        prompts, budgets = p4["prompts"], p4["budgets"]

        # (a) Router over r0
        ra = Router([r0]).start()
        routers.append(ra)
        t0 = time.perf_counter()
        futs = [ra.submit(p, max_new_tokens=b) for p, b in
                zip(prompts, budgets)]
        toks_a = [f.result(FLEET20["timeout"]) for f in futs]
        dt_a = time.perf_counter() - t0
        cmp_a = sum(agree(f"(a) request {i}", g, w, m) for i, (g, w, m) in
                    enumerate(zip(toks_a, p4["results"], p4["margins"])))
        check(cmp_a > 0, "(a) no served step cleared the margin")
        n_a = sum(t.size for t in toks_a)
        print(f"    (a) Router over r0: {len(prompts)} requests, {n_a} "
              f"tokens in {dt_a:.3f} s = {n_a / dt_a:.1f} tokens/s; tokens "
              f"equal to phase 4's at {cmp_a} steps before a near-tie; "
              f"agents up {t_up:.1f} s after the phase began ({card})",
              flush=True)

        # (b) disaggregated prefill -> decode
        rb = Router([d0]).start()
        routers.append(rb)
        dis = DisaggregatedFleet(rb, [pf], [d0])
        exports, hand_ms = [], []
        export, handoff = pf.prefill_export, dis._handoff

        def export_t(prompt, timeout=None):
            meta, arrays = export(prompt, timeout=timeout)
            exports.append((np.asarray(prompt), meta, arrays))
            return meta, arrays

        def handoff_t(sub):
            t = time.perf_counter()
            handoff(sub)
            hand_ms.append((time.perf_counter() - t) * 1e3)

        pf.prefill_export, dis._handoff = export_t, handoff_t
        t0 = time.perf_counter()
        futs = [dis.submit(p, max_new_tokens=b) for p, b in
                zip(prompts, budgets)]
        toks_b = [f.result(FLEET20["timeout"]) for f in futs]
        dt_b = time.perf_counter() - t0
        pf.prefill_export, dis._handoff = export, handoff
        st = dis.stats()
        aligned = sum(1 for p in prompts if p.size >= dis.align)
        pf_state = _pf_report(pf, root, exports)
        print(f"    (b) pf after the handoffs: {pf_state} (agent logs "
              f"under chiprun_out/phase20_agents/)", flush=True)
        check(st["handoffs"] == aligned and st["handoff_failed"] == 0
              and st["handoff_refused"] == 0, f"(b) handoffs {st}, "
              f"{aligned} aligned prompts; pf {pf_state}")
        cmp_b = sum(agree(f"(b) request {i}", g, w, m) for i, (g, w, m) in
                    enumerate(zip(toks_b, p4["results"], p4["margins"])))
        check(cmp_b > 0, "(b) no served step cleared the margin")
        sd = d0.stats()
        check(sd["prefix_hits"] >= aligned, f"(b) d0 prefix hits "
              f"{sd['prefix_hits']} of {aligned} handoffs")
        # d0's adopted pages, exported back from its prefix cache, against
        # pf's export bit for bit; pf's against the dense prefill
        same, hand_bytes = 0, 0
        for sub, meta, arrays in exports:
            hand_bytes += sum(int(a.nbytes) for a in arrays[1:])
            n = int(meta["tokens"])
            if d0.cached_prefix_tokens(sub[:n]) < n:
                continue
            m2, back = d0.prefill_export(sub[:n])
            check(m2["tokens"] == n and m2["digest"] == meta["digest"]
                  and all(np.array_equal(x, y) for x, y in
                          zip(back[1:], arrays[1:])),
                  f"(b) d0's adopted pages of a {n}-token prefix are not "
                  f"pf's export")
            same += 1
        check(same == len(exports), f"(b) {same} of {len(exports)} adopted "
              f"chains checked resident on d0")
        errs = []
        aligned_i = [i for i, p in enumerate(prompts) if p.size >= dis.align]
        for j, i in enumerate(aligned_i[:2]):
            sub, meta, arrays = exports[j]
            want = dense[i]
            got = [(torch.from_numpy(arrays[1 + 2 * li]),
                    torch.from_numpy(arrays[2 + 2 * li]))
                   for li in range(len(want))]
            want = [tuple(t.cpu() for t in kv) for kv in want]
            errs.append(page_err(got, want))
        check(max(errs) <= PAGE_TOL, f"(b) exported pages against the "
              f"dense prefill: relative errs {errs} (tol {PAGE_TOL})")
        n_b = sum(t.size for t in toks_b)
        hs = sorted(hand_ms)
        out["handoff_ms"] = (p50(hs), hs[min(len(hs) - 1,
                                             int(0.99 * len(hs)))])
        print(f"    (b) DisaggregatedFleet(pf -> d0): {n_b} tokens in "
              f"{dt_b:.3f} s = {n_b / dt_b:.1f} tokens/s; handoffs "
              f"{st['handoffs']} of {aligned} aligned prompts "
              f"({st['handoff_tokens']} tokens), failed "
              f"{st['handoff_failed']}, refused {st['handoff_refused']}; "
              f"handoff (export + adopt) ms p50 {out['handoff_ms'][0]:.1f} "
              f"p99 {out['handoff_ms'][1]:.1f}; {hand_bytes / 2**20:.1f} "
              f"MiB of float32 pages handed off; d0's adopted pages bit for "
              f"bit pf's export on {same} chains; pf's pages against the "
              f"dense prefill max relative err {max(errs):.3e} (tol "
              f"{PAGE_TOL}); tokens equal to phase 4's at {cmp_b} steps "
              f"before a near-tie ({card})", flush=True)

        # (c) a fleet swap over r0, pf and d0 with requests in flight
        p2 = {k: dict(v) if isinstance(v, dict) else v
              for k, v in params.items()}
        p2["ln_f"]["weight"] = -p2["ln_f"]["weight"]
        k = FLEET20["swap_req"]
        # the second version's own greedy margins (dense, in this process)
        m1 = [solo_greedy(torch, model, p2, p, 8)[1] for p in prompts[:k]]
        pre = [ra.submit(p, max_new_tokens=b) for p, b in
               zip(prompts[:k], budgets[:k])]
        # swap once r0 has admitted them (they are pinned to v0 there)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            s0 = r0.stats()
            if s0["active"] + s0["prefilling"] >= k:
                break
            time.sleep(0.005)
        t0 = time.perf_counter()
        v1 = ra.swap(p2, version="v1")
        dis.swap(p2, version=v1)
        swap_s = time.perf_counter() - t0
        post_a = [ra.submit(p, max_new_tokens=8) for p in prompts[:k]]
        post_b = [dis.submit(p, max_new_tokens=8) for p in prompts[:k]]
        pre_t = [f.result(FLEET20["timeout"]) for f in pre]
        pa = [f.result(FLEET20["timeout"]) for f in post_a]
        pb = [f.result(FLEET20["timeout"]) for f in post_b]
        check([f.version for f in pre] == ["v0"] * k
              and [f.version for f in post_a + post_b] == [v1] * (2 * k),
              f"(c) versions: in flight {[f.version for f in pre]}, after "
              f"{[f.version for f in post_a + post_b]}")
        for i, (g, w, m) in enumerate(zip(pre_t, toks_a, p4["margins"])):
            agree(f"(c) in-flight request {i}", g, w, m)
        cmp_c = sum(agree(f"(c) r0 / d0 under {v1}, request {i}", x, y, m)
                    for i, (x, y, m) in enumerate(zip(pa, pb, m1)))
        check(not all(np.array_equal(x, y[:8]) for x, y in zip(pa, toks_a)),
              "(c) the new version serves the old version's tokens")
        st = dis.stats()
        check(st["handoff_failed"] == 0 and st["handoff_refused"] == 0,
              f"(c) handoffs after the swap {st}")
        wire = _bytes(p2)
        print(f"    (c) fleet swap to a second version (final LayerNorm "
              f"gain negated) over r0, pf and d0 with {k} requests in "
              f"flight: publish + activate {swap_s:.3f} s, "
              f"{3 * wire / 2**20:.1f} MiB of bf16 leaves on the wire "
              f"({wire / 2**20:.1f} MiB a replica, 2-byte buffers); in-"
              f"flight responses all v0, later ones all {v1}, r0 and d0 "
              f"alike at {cmp_c} steps before a near-tie ({card})",
              flush=True)
        after = {r.name: _agent_routes(r) for r in reps}
        out["routes"] = {n: {"paged_attention": _route_delta(
            after[n], before[n], "paged_attention", "f32_split"),
            "flash_fwd": _route_delta(after[n], before[n], "flash_fwd",
                                      "bf16_sm90")} for n in after}
        check(all(v["paged_attention"] > 0 for v in out["routes"].values()),
              f"(a-c) an agent never launched K2: {out['routes']}")
        rb.shutdown()
        pf.shutdown()
        routers.remove(rb)
        check(procs["pf"].wait(60) == 0 and procs["d0"].wait(60) == 0,
              f"(b) pf / d0 exited {procs['pf'].poll()} / "
              f"{procs['d0'].poll()}")

        # (d) the controller: scale up by a fourth agent warmed from r0,
        # then down, no request lost
        mon = FleetMonitor([r0], fleet_dir=fd, every_s=0.1,
                           stale_s=30.0).start()
        spawned = {}

        def spawn(name):
            procs[name] = _spawn_agent(fd, name, "replica", params_path, dev,
                                       len(procs) + 1, root)
            doc = _wait_agents(fd, {name: procs[name]},
                               FLEET20["start_timeout"])[name]
            rep = spawned[name] = RemoteReplica(doc, fleet_dir=fd).start()
            rep.registry.publish(p2, version=v1, activate=True)
            return rep

        pol = ScalePolicy(min_replicas=1, max_replicas=2, queue_high=0.5,
                          queue_low=0.5, up_ticks=1, down_ticks=1,
                          cooldown_s=0.0, warm_limit=FLEET20["warm"])
        ctl = FleetController(ra, mon, fleet_dir=fd, spawn=spawn,
                              policy=pol,
                              warm_prompts=prompts[:FLEET20["warm"]])
        t0 = time.perf_counter()
        load = [ra.submit(p, max_new_tokens=b) for p, b in
                zip(prompts, budgets)]
        deadline = time.monotonic() + FLEET20["start_timeout"]
        while ctl.stats()["scale_ups"] == 0 \
                and time.monotonic() < deadline:
            ctl.tick()
            time.sleep(0.05)
        up_s = time.perf_counter() - t0
        cs = ctl.stats()
        check(cs["scale_ups"] == 1 and cs["spawn_failed"] == 0,
              f"(d) scale-up {cs}")
        done = [f.result(FLEET20["timeout"]) for f in load]
        check(len(done) == len(load) and all(t.size == b for t, b in
                                             zip(done, budgets)),
              "(d) a request was lost or cut under the scale-up")
        deadline = time.monotonic() + 60
        while ctl.stats()["scale_downs"] == 0 \
                and time.monotonic() < deadline:
            ctl.tick()
            time.sleep(0.05)
        cs = ctl.stats()
        check(cs["scale_downs"] == 1 and ra.healthy_replicas() == ["r0"],
              f"(d) scale-down {cs}, router {ra.healthy_replicas()}")
        name = next(iter(spawned))
        check(procs[name].wait(60) == 0, f"(d) {name} exited "
              f"{procs[name].poll()}")
        rs = ra.stats()
        print(f"    (d) FleetController: scale-up to 2 replicas (spawn + "
              f"warm {cs['warm_prompts']} prompts from r0 + join) under "
              f"{len(load)} requests in {up_s:.1f} s, then a drain-retire "
              f"of {name}; {rs['completed']} requests completed, none lost "
              f"({card})", flush=True)
        mon.stop()
        mon = None
        ra.shutdown()
        routers.remove(ra)
        check(procs["r0"].wait(60) == 0, f"r0 exited {procs['r0'].poll()}")
    finally:
        if mon is not None:
            mon.stop()
        for r in routers:
            r.shutdown(drain=False)
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        if own_tmp:     # the parameter file and the fleet directory
            shutil.rmtree(tmp, True)
    check(fleet_threads_alive() == 0 and transport_threads_alive() == 0,
          "fleet or transport threads left running")
    out["phase_s"] = time.perf_counter() - t20
    print(f"[20] phase 20: {out['phase_s']:.1f} s; agents' launches by "
          f"kernel (f32_split / bf16_sm90) {out['routes']} ({card})",
          flush=True)
    return out


# -- phase 21: int8 quantization --------------------------------------------------

# the sizes of phase 21 (a CPU rehearsal shrinks them): (a) the int8 GEMM's
# shapes (name, (M, N, K) or a depthwise convolution's (B, C, H)), (b)
# Inception v1's calibration and timed batches, (c) the flagship's
# requests a version (prompts, budgets) and its scheduler
INT8_INT32_OPS = 1979e12         # H100 SXM dense int8 tensor cores
Q21 = dict(gemm=[("inception conv1 im2col", (8 * 112 * 112, 64, 147)),
                 ("inception 3x3 K1440", (8 * 14 * 14, 320, 1440)),
                 ("ragged", (1000, 77, 333))],
           dw=("depthwise 3x3", (8, 256, 28)), main="inception 3x3 K1440",
           calib=8, B=32, S=224, reps=3, n_req=4, prompt=(64, 129),
           budget=(24, 33), slots=4, block=16, max_seq=256)
QUANT_TOL = {8: 0.08, 4: 0.2}    # JAX's logit bounds (test_quantization.py)


def inception_int8_shapes(B=32):
    """(name, M, N, K) of the int8 Inception v1 forward at B/224
    (``models/inception.py``): its 57 convolutions in model order (M = B
    Ho Wo, N = output channels, K = C kh kw), then the classifier."""
    out = [("conv1/7x7_s2", B * 112 * 112, 64, 147),
           ("conv2/3x3_reduce", B * 56 * 56, 64, 64),
           ("conv2/3x3", B * 56 * 56, 192, 576)]
    blocks = [("3a", 28, 192, (64, 96, 128, 16, 32, 32)),
              ("3b", 28, 256, (128, 128, 192, 32, 96, 64)),
              ("4a", 14, 480, (192, 96, 208, 16, 48, 64)),
              ("4b", 14, 512, (160, 112, 224, 24, 64, 64)),
              ("4c", 14, 512, (128, 128, 256, 24, 64, 64)),
              ("4d", 14, 512, (112, 144, 288, 32, 64, 64)),
              ("4e", 14, 528, (256, 160, 320, 32, 128, 128)),
              ("5a", 7, 832, (256, 160, 320, 32, 128, 128)),
              ("5b", 7, 832, (384, 192, 384, 48, 128, 128))]
    for name, hw, cin, (c1, r3, c3, r5, c5, pp) in blocks:
        M = B * hw * hw
        out += [(f"{name}/1x1", M, c1, cin),
                (f"{name}/3x3_reduce", M, r3, cin),
                (f"{name}/3x3", M, c3, 9 * r3),
                (f"{name}/5x5_reduce", M, r5, cin),
                (f"{name}/5x5", M, c5, 25 * r5),
                (f"{name}/pool_proj", M, pp, cin)]
    out.append(("loss3/classifier", B, 1000, 1024))
    return out


def int8_bound(M, N, K, G=1, out_bytes=4, a_bytes=None):
    """(bound ms, 'bytes' or 'operations') of an int8 contraction: A
    (``a_bytes``, default G M K) and B read once, the output written once
    at 3.35 TB/s, against 2 G M N K operations at 1979 TOP/s."""
    nbytes = (G * M * K if a_bytes is None else a_bytes) + G * N * K \
        + out_bytes * G * M * N
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * G * M * N * K / INT8_INT32_OPS * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def _int8_case(torch, name, M, N, Kd, i8, g, dev="cuda", host=True,
               count=1):
    """The int8 GEMM at (M, N, K) on random int8 operands, bit for bit an
    exact reference twice: int32 out, and with the quantized layers' fused
    epilogue (float32 ``acc * s + bias``, random s and bias) against
    ``acc.to(float32) * s + bias`` by torch ops. ``host``: the reference
    is ``int8_matmul_reference`` on the host (its ms is the plain
    version's), else a float64 product on the card (exact: every |sum| <
    2^31 < 2^53). The kernel alone is timed (CUDA graphs) on the operands
    the convolution path hands it (rows padded to 16 bytes), int32 and
    fused, beside torch._int_mm where it takes the shape, a bf16 cuBLAS
    product of the same M, N, K and the bound."""
    import bigdl_tpu_torch.kernels.int8_matmul  # noqa: F401 (the module)
    I = sys.modules["bigdl_tpu_torch.kernels.int8_matmul"]
    a, b = i8(M, Kd), i8(N, Kd)
    s = torch.rand(N, device=dev, generator=g) * 1e-3
    bias = torch.randn(N, device=dev, generator=g)
    got = I.int8_matmul(a, b)
    gotf = I.int8_matmul(a, b, scale=s, bias=bias)
    t0 = time.perf_counter()
    if host:
        want = I.int8_matmul_reference(a.cpu(), b.cpu())
        plain_ms = (time.perf_counter() - t0) * 1e3
        wantf = want.to(torch.float32) * s.cpu() + bias.cpu()
    else:
        want = (a.double() @ b.double().T).to(torch.int32)
        plain_ms = None
        wantf = want.to(torch.float32) * s + bias
    check(torch.equal(got.cpu(), want.cpu()), f"[21] (a) int8 GEMM {name}: "
          f"int32 differs from the exact product")
    check(torch.equal(gotf.cpu(), wantf.cpu()), f"[21] (a) int8 GEMM {name}: "
          f"the fused epilogue differs from acc.to(float32) * s + bias")
    pl = I.plan(1, M, N, Kd, I._sm_count(torch.device(dev)) if dev == "cuda"
                else I.SMS)
    rec = {"name": name, "M": M, "N": N, "K": Kd, "G": 1, "count": count,
           "tile_n": pl.tile_n, "splits": pl.splits, "max_abs_err": 0.0,
           "plain_ms": plain_ms, "library_ms": None}
    rec["bound_ms"], rec["bound_by"] = int8_bound(M, N, Kd)
    if dev != "cuda":
        rec.update(ms=None, fused_ms=None, bf16_ms=None)
        return rec
    ap, lda = I._kmajor(a)
    bp, ldb = I._kmajor(b)
    c = torch.empty(M, N, dtype=torch.int32, device=dev)
    cf = torch.empty(M, N, dtype=torch.float32, device=dev)
    gemm = (1, M, N, Kd, lda, ldb, N, M * lda, N * ldb, M * N)
    rec["ms"] = graph_ms(torch, lambda i: I._launch(ap, bp, c, *gemm), 1)
    rec["fused_ms"] = graph_ms(
        torch, lambda i: I._launch(ap, bp, cf, *gemm, s, bias, 0), 1)
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    rec["bf16_ms"] = graph_ms(torch, lambda i: ab @ bb.T, 1, reps=10)
    if M > 16 and Kd % 8 == 0 and N % 8 == 0:    # what _int_mm takes
        bt = b.T
        rec["library_ms"] = graph_ms(
            torch, lambda i: torch._int_mm(a, bt), 1, reps=10)
    return rec


def _int8_depthwise(torch, name, B, C, H, i8, g, dev="cuda"):
    """A depthwise 3x3 (G = C groups, N = 1, K = 9) through
    ``int8_conv2d``, im2col included, bit for bit its plain version (int32
    on the host) in int32 and with the fused epilogue; timed beside a cuDNN
    bf16 depthwise convolution and the bound (the input read once)."""
    import torch.nn.functional as F
    import bigdl_tpu_torch.kernels.int8_matmul  # noqa: F401 (the module)
    I = sys.modules["bigdl_tpu_torch.kernels.int8_matmul"]
    x, w = i8(B, C, H, H), i8(C, 1, 3, 3)
    s = torch.rand(C, device=dev, generator=g) * 1e-3
    bias = torch.randn(C, device=dev, generator=g)
    got = I.int8_conv2d(x, w, 1, 1, 1, C)
    gotf = I.int8_conv2d(x, w, 1, 1, 1, C, scale=s, bias=bias)
    t0 = time.perf_counter()
    want = I.int8_conv2d_reference(x.cpu(), w.cpu(), 1, 1, 1, C)
    plain_ms = (time.perf_counter() - t0) * 1e3
    wantf = want.to(torch.float32) * s.cpu()[None, :, None, None] \
        + bias.cpu()[None, :, None, None]
    check(tuple(got.shape) == tuple(want.shape)
          and torch.equal(got.cpu(), want), f"[21] (a) int8 GEMM {name}: "
          f"differs from its plain version")
    check(torch.equal(gotf.cpu(), wantf), f"[21] (a) int8 GEMM {name}: the "
          f"fused epilogue differs from acc.to(float32) * s + bias")
    M = B * H * H
    rec = {"name": name, "M": M, "N": 1, "K": 9, "G": C, "count": 1,
           "max_abs_err": 0.0, "plain_ms": plain_ms, "library_ms": None}
    rec["bound_ms"], rec["bound_by"] = int8_bound(M, 1, 9, C,
                                                  a_bytes=x.numel())
    if dev != "cuda":
        rec.update(ms=None, fused_ms=None, bf16_ms=None)
        return rec
    rec["ms"] = graph_ms(torch, lambda i: I.int8_conv2d(x, w, 1, 1, 1, C), 1)
    rec["fused_ms"] = graph_ms(torch, lambda i: I.int8_conv2d(
        x, w, 1, 1, 1, C, scale=s, bias=bias), 1)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    rec["bf16_ms"] = graph_ms(torch, lambda i: F.conv2d(
        xb, wb, None, 1, 1, 1, C), 1, reps=10)
    return rec


def _int8_conv_layouts(torch, i8, g, dev="cuda"):
    """``int8_conv2d`` on NCHW and on channels-last inputs (the layout the
    kernel writes, which the next layer reads through its own strides) at
    Inception's kinds of convolution, bit for bit the plain version (int32
    on the host), int32 and with the fused epilogue. Returns the cases
    checked."""
    import bigdl_tpu_torch.kernels.int8_matmul  # noqa: F401 (the module)
    I = sys.modules["bigdl_tpu_torch.kernels.int8_matmul"]
    cases = [((2, 64, 28, 28), (48, 64, 1, 1), 1, 0),    # 1x1: no copy
             ((2, 96, 28, 28), (128, 96, 3, 3), 1, 1),
             ((2, 24, 14, 14), (64, 24, 5, 5), 1, 2),   # K = 600
             ((2, 3, 56, 56), (64, 3, 7, 7), 2, 3)]     # K = 147
    n = 0
    for xs, ws, st, pd in cases:
        x, w = i8(*xs), i8(*ws)
        s = torch.rand(ws[0], device=dev, generator=g) * 1e-3
        bias = torch.randn(ws[0], device=dev, generator=g)
        want = I.int8_conv2d_reference(x.cpu(), w.cpu(), st, pd)
        wantf = want.to(torch.float32) * s.cpu()[None, :, None, None] \
            + bias.cpu()[None, :, None, None]
        for fmt in (torch.contiguous_format, torch.channels_last):
            xf = x.contiguous(memory_format=fmt)
            got = I.int8_conv2d(xf, w, st, pd)
            gotf = I.int8_conv2d(xf, w, st, pd, scale=s, bias=bias)
            check(torch.equal(got.cpu(), want) and torch.equal(gotf.cpu(),
                                                               wantf),
                  f"[21] (a) int8_conv2d x{xs} w{ws} ({fmt}) differs from "
                  f"its plain version")
            n += 1
    return n


def _int8_profile(torch, fwd, n=2):
    """``n`` int8 forwards under ``torch.profiler``, the device ms a
    forward by family: the GEMM (``int8_matmul._launch``), the im2col and
    pad copies (``_conv_operands``, ``_kmajor``), the activation quantize
    (``quantize._activation``), what else the quantized layers launch (the
    rescale and bias left: now the ``xs * scale`` vector products), and
    everything else (ReLU, pools, LRN, concatenations, the softmax). Each
    family is a ``record_function`` range around those functions, patched
    in for the run; on the device timeline each kernel goes to the
    innermost range that holds it. Also the kernel launches and the device
    ms a forward (the kernels' own times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    import bigdl_tpu_torch.kernels.int8_matmul  # noqa: F401 (the module)
    import bigdl_tpu_torch.quantization.quantize  # noqa: F401 (the module)
    I = sys.modules["bigdl_tpu_torch.kernels.int8_matmul"]
    Q = sys.modules["bigdl_tpu_torch.quantization.quantize"]
    ranges = [(I, "_launch", "GEMM"), (I, "_conv_operands", "im2col / pad copies"),
              (I, "_kmajor", "im2col / pad copies"),
              (Q, "_activation", "activation quantize"),
              (Q.QuantizedSpatialConvolution, "call", "rescale / bias left"),
              (Q.QuantizedLinear, "call", "rescale / bias left")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in ranges]

    def wrap(fn, label):
        def ranged(*args, **kwargs):
            with record_function("int8/" + label):
                return fn(*args, **kwargs)
        return ranged
    try:
        for (obj, attr, label), (_, _, fn) in zip(ranges, saved):
            setattr(obj, attr, wrap(fn, label))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fwd()
            torch.cuda.synchronize()
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end, e.name[len("int8/"):])
             for e in dev if e.name.startswith("int8/")]
    kernels = [e for e in dev if not e.name.startswith("int8/")]
    fams = dict.fromkeys(["GEMM", "im2col / pad copies",
                          "activation quantize", "rescale / bias left",
                          "everything else"], 0.0)
    for k in kernels:
        t0, t1 = k.time_range.start, k.time_range.end
        inside = [sp for sp in spans if sp[0] <= t0 and t1 <= sp[1]]
        label = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside \
            else "everything else"
        fams[label] += (t1 - t0) / 1e3 / n
    gemm = sum(k.time_range.end - k.time_range.start for k in kernels
               if "int8_gemm_kernel" in k.name) / 1e3 / n
    return {"families_ms": {k: round(v, 4) for k, v in fams.items()},
            "gemm_kernels_ms": gemm, "device_ms": sum(fams.values()),
            "launches": len(kernels) / n, "ranges": len(spans) / n}


def _lm_quant_bytes(cfg, bits, group):
    """``lm_quantized_bytes``' 'quantized' count from the shapes: per
    layer wq, wk, wv, wo (H x H), w1 (H x F) and w2 (F x H), their codes
    (int4: two a byte) and float32 scales (int8: one a column; int4: one
    a column and group of K rows, the group fitted to K as
    ``quantize_lm_params`` fits it)."""
    H, F = cfg["hidden_size"], cfg["filter_size"]
    mats = [(H, H)] * 4 + [(H, F), (F, H)]
    fit = lambda k: group if k % group == 0 else math.gcd(k, group)
    per = sum((k * n if bits == 8 else (k * n + 1) // 2)
              + 4 * (n if bits == 8 else k // fit(k) * n) for k, n in mats)
    return cfg["num_layers"] * per


def quantized(torch, K, card, dev="cuda"):
    """Phase 21: (a) the int8 GEMM against exact references bit for bit,
    int32 and with the fused epilogue, at Inception's first convolution
    (K = 147), a 3x3 at K = 1440, a depthwise 3x3 (G = C, K = 9), a ragged
    shape and every distinct contraction of (b)'s forward, timed beside
    torch._int_mm, a bf16 product and the bound; (b) int8 Inception v1:
    ``calibrate`` on Q21['calib'] images, ``quantize(calibration=)``, a
    B32/224 forward against the float model's (top-1 agreement >= 0.5,
    relative logit error < 0.25, JAX's bounds; the logits are the
    LogSoftMax outputs less their row means), images/s of both, the
    kernel's launches by route and a profile split by family; (c) the flagship served from bf16, int8 and int4
    (group 128) weights published through ``ModelRegistry.publish(
    transform=quantize_lm_params)`` and ``DecodeScheduler`` over the paged
    pool: logits against the bf16 model's (0.08 / 0.2), the served pages
    against the dense prefill of the same weights, ``lm_quantized_bytes``
    against its formula, tokens/s of each."""
    from bigdl_tpu_torch import models
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.quantization import (calibrate, lm_quantized_bytes,
                                              quantize, quantize_lm_params)
    from bigdl_tpu_torch.serving import DecodeScheduler, ModelRegistry
    from bigdl_tpu_torch.utils.amp import bf16_params
    t21 = time.perf_counter()
    out = {"gemm": []}
    g = torch.Generator(device=dev).manual_seed(21)

    def i8(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                             generator=g)

    # (a) the kernel against exact references, int32 and fused, at Q21's
    # four shapes and at every distinct contraction of (b)'s forward
    for name, (M, N, Kd) in Q21["gemm"]:
        out["gemm"].append(_int8_case(torch, name, M, N, Kd, i8, g, dev))
    name, (B, C, H) = Q21["dw"]
    out["gemm"].append(_int8_depthwise(torch, name, B, C, H, i8, g, dev))
    n_layouts = _int8_conv_layouts(torch, i8, g, dev)
    print(f"[21] (a) int8_conv2d at 1x1, 3x3, 5x5 (K = 600) and 7x7 / 2 (K "
          f"= 147) on NCHW and channels-last inputs: {n_layouts} cases bit "
          f"for bit the plain version, int32 and fused", flush=True)
    distinct = {}
    for name, M, N, Kd in inception_int8_shapes(Q21["B"]):
        distinct.setdefault((M, N, Kd), []).append(name)
    out["model_gemm"] = [
        _int8_case(torch, names[0], M, N, Kd, i8, g, dev, host=False,
                   count=len(names))
        for (M, N, Kd), names in distinct.items()]
    if dev == "cuda":
        torch.cuda.empty_cache()
    fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
    for r in out["gemm"] + out["model_gemm"]:
        plan = f", plan {r['tile_n']} wide x {r['splits']}" \
            if "tile_n" in r else ""
        print(f"[21] (a) int8 GEMM {r['name']} (G {r['G']}, M {r['M']}, "
              f"N {r['N']}, K {r['K']}, x{r['count']}{plan}): int32 and "
              f"fused epilogue bit for bit; {fmt(r['ms'])} ms, fused "
              f"{fmt(r['fused_ms'])} ms, torch._int_mm "
              f"{fmt(r['library_ms'])}, bf16 product {fmt(r['bf16_ms'])}, "
              f"plain (host int32) {fmt(r['plain_ms'])} ms, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) ({card})", flush=True)
    mg = out["model_gemm"]
    out["model_sum"] = {"contractions": sum(r["count"] for r in mg),
                        "bound_ms": sum(r["count"] * r["bound_ms"]
                                        for r in mg)}
    if dev == "cuda":
        for key in ("ms", "fused_ms", "bf16_ms"):
            out["model_sum"][key] = sum(r["count"] * r[key] for r in mg)
        lib = [r for r in mg if r["library_ms"] is not None]
        out["model_sum"]["int_mm_ms"] = sum(r["count"] * r["library_ms"]
                                            for r in lib)
        out["model_sum"]["int_mm_contractions"] = sum(r["count"]
                                                      for r in lib)
        ms_ = out["model_sum"]
        print(f"[21] (a) the B{Q21['B']} forward's {ms_['contractions']} "
              f"contractions summed: int32 {ms_['ms']:.4f} ms, fused "
              f"{ms_['fused_ms']:.4f} ms, bound {ms_['bound_ms']:.4f} ms; "
              f"torch._int_mm {ms_['int_mm_ms']:.4f} ms over the "
              f"{ms_['int_mm_contractions']} it takes, bf16 products "
              f"{ms_['bf16_ms']:.4f} ms ({card})", flush=True)
    out["row"] = next(r for r in out["gemm"] if r["name"] == Q21["main"])

    # (b) int8 Inception v1 (bench_extra.py bench_inception_int8)
    rng = np.random.RandomState(21)
    S, B = Q21["S"], Q21["B"]
    model = models.Inception_v1_NoAuxClassifier(1000, device=dev, seed=21)
    model.evaluate()
    cal = torch.from_numpy(rng.randn(Q21["calib"], 3, S, S).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.randn(B, 3, S, S).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    scales = calibrate(model, [cal])
    qmodel = quantize(model, calibration=scales)
    t_q = time.perf_counter() - t0
    import bigdl_tpu_torch.kernels.int8_matmul  # noqa: F401 (the module)
    I = sys.modules["bigdl_tpu_torch.kernels.int8_matmul"]
    shapes = []
    launch = I._launch

    def recorded(a, b, c, G, M, N, Kd, *rest, **kw):
        shapes.append((G, M, N, Kd))
        return launch(a, b, c, G, M, N, Kd, *rest, **kw)
    with torch.no_grad():
        ref = model.forward(x).float()
        K.reset_launch_counts()
        I._launch = recorded
        try:
            got = qmodel.forward(x).float()
        finally:
            I._launch = launch
        if dev == "cuda":
            torch.cuda.synchronize()
        lc = K.launch_counts()
        routes = {"int8_conv2d": dict(I.int8_conv2d.launches_by_route),
                  "int8_matmul": dict(I.int8_matmul.launches_by_route)}
    n_conv = sum(1 for m in qmodel.modules()
                 if type(m).__name__ == "QuantizedSpatialConvolution")
    n_lin = sum(1 for m in qmodel.modules()
                if type(m).__name__ == "QuantizedLinear")
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(int8_conv2d=n_conv, int8_matmul=n_lin)
    if dev == "cuda":
        check(lc == want, f"[21] (b) int8 Inception launched {lc}, expected "
              f"{want}")
        check(all(sum(routes[f].values()) == want[f] for f in routes)
              and all(set(r) == {"tiles", "split_k"}
                      for r in routes.values()),
              f"[21] (b) int8 launches by route {routes}, expected {want}")
        table = sorted((1, M, N, Kd) for _, M, N, Kd in
                       inception_int8_shapes(B))
        check(sorted(shapes) == table and S == 224, f"[21] (b) the "
              f"forward's contractions {sorted(shapes)} are not (a)'s "
              f"{table}")
    check(tuple(got.shape) == (B, 1000) and bool(torch.isfinite(got).all()),
          f"[21] (b) int8 Inception output {tuple(got.shape)} or "
          f"non-finite")
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    # the model ends in LogSoftMax: its outputs are the logits less a
    # constant a row, so the error is taken on the outputs less their row
    # means (the logits' own deviations)
    gc, rc = got - got.mean(-1, keepdim=True), ref - ref.mean(-1, keepdim=True)
    rel = float((gc - rc).abs().max() / (rc.abs().max() + 1e-8))
    out["inception"] = {"agree": agree, "rel": rel, "launches": lc,
                        "routes": routes, "quantize_s": t_q,
                        "layers": (n_conv, n_lin)}
    if dev == "cuda":
        for tag, m in (("int8", qmodel), ("float", model)):
            with torch.no_grad():
                ms = event_ms(torch, lambda: m.forward(x), reps=Q21["reps"],
                              iters=3)
            out["inception"][f"{tag}_ms"] = ms
            out["inception"][f"{tag}_images_per_s"] = B / ms * 1e3
        with torch.no_grad():
            prof = _int8_profile(torch, lambda: qmodel.forward(x))
        prof["busy"] = prof["device_ms"] / out["inception"]["int8_ms"]
        out["inception"]["profile"] = prof
        print(f"[21] (b) int8 Inception v1 B{B}/{S} ({n_conv} int8 "
              f"convolutions, {n_lin} int8 Linear; calibrate + quantize "
              f"{t_q:.2f} s): top-1 agreement with float {agree:.3f}, "
              f"relative logit error {rel:.4f}; int8 "
              f"{out['inception']['int8_ms']:.2f} ms = "
              f"{out['inception']['int8_images_per_s']:.1f} images/s, float "
              f"{out['inception']['float_ms']:.2f} ms = "
              f"{out['inception']['float_images_per_s']:.1f} images/s; "
              f"launches {lc}, by route {routes} ({card})", flush=True)
        print(f"[21] (b) profile of two int8 forwards: device ms a forward "
              f"by family {prof['families_ms']} (the GEMM's kernels "
              f"{prof['gemm_kernels_ms']:.4f} ms), device "
              f"{prof['device_ms']:.3f} ms and {prof['launches']:.0f} "
              f"kernel launches a "
              f"forward, busy {prof['busy']:.3f} of the "
              f"{out['inception']['int8_ms']:.2f} ms forward; float model "
              f"{out['inception']['float_images_per_s']:.1f} images/s "
              f"({card})", flush=True)
    check(agree >= 0.5 and rel < 0.25, f"[21] (b) int8 Inception: "
          f"agreement {agree}, relative error {rel} (JAX's bounds: >= 0.5, "
          f"< 0.25)")
    del model, qmodel, cal, x, ref, got
    if dev == "cuda":
        torch.cuda.empty_cache()

    # (c) the flagship served from int8 and int4 weights
    cfg = dict(FLAGSHIP)
    lm = TransformerLM(**cfg, seed=21, device=dev)
    with torch.no_grad():
        p16 = bf16_params(lm.params)
    reg = ModelRegistry(device=lm.device)
    versions = {"bf16": reg.publish(p16, version="bf16", activate=True),
                "int8": reg.publish(p16, version="int8",
                                    transform=quantize_lm_params),
                "int4": reg.publish(p16, version="int4", transform=lambda p:
                                    quantize_lm_params(p, bits=4,
                                                       group=128))}
    V = cfg["vocab_size"]
    dense_b = lm_quantized_bytes(reg.get("bf16").params)["dense"]
    for v, bits in (("int8", 8), ("int4", 4)):
        b = lm_quantized_bytes(reg.get(v).params)
        w = reg.get(v).params["block0"]["attn"]["wq"]
        check(w.q.device.type == torch.device(dev).type
              and w.s.device.type == torch.device(dev).type,
              f"[21] (c) {v}: the registry left the carriers on "
              f"{w.q.device} / {w.s.device}")
        want_b = _lm_quant_bytes(cfg, bits, 128)
        mats = cfg["num_layers"] * (4 * cfg["hidden_size"] ** 2 + 2
                                    * cfg["hidden_size"] * cfg["filter_size"])
        check(b["quantized"] == want_b and b["dense"] == dense_b - 2 * mats,
              f"[21] (c) {v}: lm_quantized_bytes {b}, formula {want_b} "
              f"quantized and {dense_b - 2 * mats} dense")
        out[f"{v}_bytes"] = b
    rng = np.random.RandomState(22)
    prompts = [rng.randint(1, V, rng.randint(*Q21["prompt"])).astype(
        np.int32) for _ in range(Q21["n_req"])]
    budgets = [int(rng.randint(*Q21["budget"])) for _ in prompts]
    probe = torch.from_numpy(prompts[0][None]).to(dev)
    with torch.no_grad():
        ref_logits, _ = lm.prefill(reg.get("bf16").params, probe,
                                   probe.shape[1] + 1)
    sched = DecodeScheduler(lm, max_slots=Q21["slots"],
                            block_size=Q21["block"],
                            max_seq_len=Q21["max_seq"], registry=reg).start()
    bs = Q21["block"]
    try:
        for v, bits in (("bf16", 16), ("int8", 8), ("int4", 4)):
            reg.activate(v)
            params = reg.get(v).params
            if dev == "cuda":
                torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            futs = [sched.submit(p, n) for p, n in zip(prompts, budgets)]
            res = [f.result(600) for f in futs]
            if dev == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            lc = K.launch_counts()
            n_tok = sum(r.size for r in res)
            check(all(r.size == n for r, n in zip(res, budgets))
                  and all(((r >= 0) & (r < V)).all() for r in res),
                  f"[21] (c) {v}: served {[r.size for r in res]} tokens")
            if dev == "cuda":
                pr = K.launches_by_route()["paged_attention"]
                check(lc["paged_attention"] > 0 and lc["int8_matmul"] == 0
                      and lc["int8_conv2d"] == 0
                      and only_on(pr, "f32_split", lc["paged_attention"]),
                      f"[21] (c) {v}: launches {lc}, K2 by route {pr}")
            # the served pages against the dense prefill of these weights
            blocks, got_pages = resident_chain(torch, sched, prompts[0])
            check(len(blocks) > 0, f"[21] (c) {v}: no resident block of "
                  f"the first prompt")
            want_pages = dense_pages(torch, lm, params,
                                     prompts[0][:len(blocks) * bs], bs)
            perr = page_err(got_pages, want_pages)
            check(perr <= PAGE_TOL, f"[21] (c) {v}: served pages against "
                  f"the dense prefill {perr:.4g} > {PAGE_TOL}")
            with torch.no_grad():
                lg, _ = lm.prefill(params, probe, probe.shape[1] + 1)
            lerr = float((lg.float() - ref_logits.float()).abs().max()
                         / ref_logits.float().abs().max())
            if bits < 16:
                check(bool(torch.isfinite(lg.float()).all())
                      and lerr < QUANT_TOL[bits], f"[21] (c) {v}: logits "
                      f"against bf16 {lerr:.4f} (JAX's bound "
                      f"{QUANT_TOL[bits]})")
            out[v] = {"tokens": n_tok, "s": dt, "tokens_per_s": n_tok / dt,
                      "logit_err": lerr, "page_err": perr, "launches": lc}
            print(f"[21] (c) flagship {v}: {len(res)} requests, {n_tok} "
                  f"tokens in {dt:.3f} s = {n_tok / dt:.1f} tokens/s; "
                  f"last logits against bf16 {lerr:.4f}; pages against the "
                  f"dense prefill {perr:.4f}; launches {lc}"
                  + (f"; weight bytes {out[v + '_bytes']}" if bits < 16
                     else "") + f" ({card})", flush=True)
    finally:
        sched.shutdown()
    del lm, p16, reg, sched
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["routes"] = {rt: sum(r[rt] for r in out["inception"]["routes"].values())
                     for rt in ("tiles", "split_k")}
    out["launches"] = out["inception"]["launches"]["int8_conv2d"] \
        + out["inception"]["launches"]["int8_matmul"] + sum(
            out[v]["launches"]["int8_matmul"] + out[v]["launches"][
                "int8_conv2d"] for v in ("int8", "int4"))
    out["paged"] = sum(out[v]["launches"]["paged_attention"]
                       for v in ("bf16", "int8", "int4"))
    out["phase_s"] = time.perf_counter() - t21
    print(f"[21] phase 21: {out['phase_s']:.1f} s", flush=True)
    return out


# -- phase 22: the model-file formats and the TF-style ops --------------------
L22 = dict(gen=(8, 128, 32), n_req=4, slots=8, block=16, max_seq=384,
           conv_B=8, S=224)
LOAD22_TOL = 1e-5     # relative, float32 with TF32 off, where the loaded
#                       graph's layers differ from the original's
OPS22_TOL = 1e-5      # float results, card against CPU


def _ops22_cases(np):
    """(op name, constructor args, inputs) at the unit tests' shapes, with
    the cases where the card tends to differ: ties in top-k, segment sums,
    gathers out of range, a shrinking bilinear resize."""
    r = np.random.RandomState(22)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    a, b = f(3, 4), f(3, 4)
    pos = np.abs(f(3, 4)) + 0.1
    i1 = np.array([-7, -4, -1, 0, 3, 7, 9], np.int32)
    i2 = np.array([2, 3, -2, 5, -3, 2, 4], np.int32)
    f1 = np.array([-7.5, -4.0, -1.5, 0.5, 3.0, 7.25, 9.0], np.float32)
    f2 = np.array([2.0, 3.0, -2.0, 5.0, -3.0, 2.0, 4.0], np.float32)
    half = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    bools = np.array([[True, False, True], [True, True, True]])
    ties = np.array([[1., 3., 3., 2., 3.], [0., 0., 0., 0., 0.]],
                    np.float32)
    obj = lambda *xs: np.array(xs, dtype=object)  # noqa: E731
    return [
        ("Equal", (), [a, np.where(a > 0, a, b)]),
        ("NotEqual", (), [a, b]), ("Greater", (), [a, b]),
        ("GreaterEqual", (), [a, b]), ("Less", (), [a, b]),
        ("LessEqual", (), [a, b]), ("ApproximateEqual", (0.5,), [a, b]),
        ("LogicalAnd", (), [bools, bools[::-1].copy()]),
        ("LogicalOr", (), [bools, bools[::-1].copy()]),
        ("LogicalNot", (), [bools]), ("All", (1,), [bools]),
        ("Any", (0,), [bools]), ("Sum", ((0, 1), True), [a]),
        ("Sum", (1,), [i1.reshape(1, 7)]), ("Prod", (1,), [a]),
        ("Max", (1,), [a]), ("Min", (0,), [a]), ("Mean", (), [a]),
        ("Exp", (), [a]), ("Expm1", (), [a]), ("Log1p", (), [pos]),
        ("Floor", (), [f1]), ("Ceil", (), [f1]), ("Round", (), [half]),
        ("Rint", (), [half]), ("Sign", (), [f1]), ("Inv", (), [pos]),
        ("Erf", (), [a]), ("Erfc", (), [a]), ("Lgamma", (), [pos * 3]),
        ("Digamma", (), [pos * 3]),
        ("IsFinite", (), [np.array([1., np.inf, np.nan], np.float32)]),
        ("IsInf", (), [np.array([1., -np.inf, np.nan], np.float32)]),
        ("IsNan", (), [np.array([1., np.inf, np.nan], np.float32)]),
        ("Pow", (), [pos, b]), ("Maximum", (), [a, b]),
        ("Minimum", (), [a, b]), ("FloorDiv", (), [i1, i2]),
        ("FloorDiv", (), [f1, f2]), ("FloorMod", (), [i1, i2]),
        ("FloorMod", (), [f1, f2]), ("Mod", (), [i1, i2]),
        ("TruncateDiv", (), [i1, i2]), ("TruncateDiv", (), [f1, f2]),
        ("SquaredDifference", (), [a, b]), ("Shape", (), [f(2, 3, 5)]),
        ("Rank", (), [f(2, 3, 5)]), ("Cast", (np.int32,), [f1]),
        ("Gather", (0,), [f(5, 3), np.array([7, -1, -6, 2], np.int32)]),
        ("Gather", (0,), [np.arange(5, dtype=np.int32),
                          np.array([7, -1, -6, 2], np.int32)]),
        ("Select", (), [a > 0, a, b]), ("Slice", ([1, 0], [2, -1]), [a]),
        ("StridedSlice", ([2, 3], [0, 0], [-1, -2], 0, 0, 2), [a]),
        ("Tile", ([2, 1],), [a]),
        ("OneHot", (4, 2.0, -1.0), [np.array([0, 3, -1, 5], np.int32)]),
        ("TopK", (3,), [ties]), ("InTopK", (2,), [ties, np.array(
            [4, 2], np.int32)]), ("ArgMax", (1,), [ties]),
        ("BatchMatMul", (True, False), [f(2, 4, 3), f(2, 4, 5)]),
        ("SegmentSum", (3,), [f(7, 4), np.array([0, 0, 2, 1, 2, 9, -1],
                                                np.int32)]),
        ("SegmentSum", (4,), [np.arange(6, dtype=np.int32),
                              np.array([3, 3, 0, 1, 9, 0], np.int32)]),
        ("Pad", ([[1, 0], [0, 2]], 1.5), [a]), ("ExpandDims", (-1,), [a]),
        ("SplitAndSelect", (1, 1, 2), [a]),
        ("InvertPermutation", (), [np.array([2, 0, 3, 1], np.int32)]),
        ("Pack", (1,), [a, b]), ("Split", (2, 1), [a]),
        ("Unpack", (3, 0), [a]),
        ("ResizeBilinear", (6, 8), [f(2, 17, 23, 3)]),
        ("ResizeBilinear", (7, 9, True), [f(2, 4, 5, 2)]),
        ("Dilation2D", ([1, 2, 2, 1], [1, 1, 1, 1]),
         [f(1, 7, 6, 2), f(3, 3, 2)]),
        ("L2Loss", (), [a]),
        ("CrossEntropy", (), [a, np.eye(4, dtype=np.float32)[:3]]),
        ("BucketizedCol", ([0.0, 10.0, 100.0],),
         [np.array([-5.0, 0.0, 10.0, 500.0], np.float32)]),
        ("CategoricalColHashBucket", (16,), [obj("a", "b", "zz")]),
        ("CategoricalColVocaList", (["cat", "dog"], -1, 2),
         [obj("dog", "bird", "cat")]),
        ("CrossCol", (32,), [obj("a", "b"), obj("x", "y")]),
        ("IndicatorCol", (4,), [np.array([[0, 2], [3, 3]], np.int32)]),
        ("Kv2Tensor", (",", ":", 4), [obj("0:1.5,2:3.0", "1:2.0")]),
        ("MkString", ("-",), [np.array([[1, 2], [3, 4]], dtype=object)]),
        ("Substr", (1, 2), [obj("hello", "world")]),
        ("RangeOps", (), [np.int32(2), np.int32(14), np.int32(3)]),
        ("DepthwiseConv2D", (2, 1, 0, 1, "NHWC"),
         [f(2, 7, 7, 6), f(3, 3, 6, 2)]),
        ("NoOp", (), [a]), ("ControlDependency", (), [a]),
        ("BiasAdd", (), [f(2, 3, 4), np.arange(4, dtype=np.float32)]),
    ]


def _ops_card_vs_cpu(torch, ops, nn, Table, dev):
    """Every op of ``ops.__all__`` on ``dev`` against the same op on the
    CPU: (cases compared, largest float error, names covered)."""
    def to(x, d):
        if isinstance(x, np.ndarray) and x.dtype == object:
            return x
        return torch.from_numpy(np.array(x)).to(d)

    def flat(out):
        if isinstance(out, Table):
            return [t for o in out.to_list() for t in flat(o)]
        return [out]

    def run(op, xs, d):
        ins = [to(x, d) for x in xs]
        with torch.no_grad():
            return flat(op.forward(ins[0] if len(ins) == 1 else Table(*ins)))

    worst, n, covered = 0.0, 0, set()

    class Gt(ops.Compare):
        def _cmp(self, x, y):
            return x > y

    class Twice(ops.Operation):
        def _op(self, x):
            return 2 * x
    r = np.random.RandomState(23)
    x = r.randn(3, 4).astype(np.float32)
    cases = [(name, lambda n=name, a=args: getattr(ops, n)(*a), xs)
             for name, args, xs in _ops22_cases(np)] + [
        ("Compare", Gt, [x, x.T.copy().reshape(3, 4)]),
        ("Operation", Twice, [x]),
        ("ModuleToOperation", lambda: ops.ModuleToOperation(nn.Tanh()), [x]),
        ("TensorModuleWrapper",
         lambda: ops.TensorModuleWrapper(nn.AddConstant(2.0)), [x]),
        ("TensorOp", lambda: ops.TensorOp().abs().add(1.0).log().mul(2.0),
         [x]),
        ("Assert", ops.Assert, [np.bool_(True), x])]
    for name, make, xs in cases:
        op = make().evaluate()
        want, got = run(op, xs, "cpu"), run(op, xs, dev)
        check(len(want) == len(got), f"[22] (c) {name}: {len(got)} outputs "
              f"on the card, {len(want)} on the CPU")
        for w, g in zip(want, got):
            if isinstance(w, np.ndarray):          # host string ops
                check(isinstance(g, np.ndarray) and list(g.reshape(-1)) ==
                      list(w.reshape(-1)), f"[22] (c) {name}: strings")
                continue
            g = g.cpu()
            check(g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape),
                  f"[22] (c) {name}: {g.dtype} {tuple(g.shape)} on the card, "
                  f"{w.dtype} {tuple(w.shape)} on the CPU")
            if w.is_floating_point():
                ok = torch.isnan(g) == torch.isnan(w)
                d = (g - w).abs()[~torch.isnan(w)]
                e = float((d / w.abs()[~torch.isnan(w)].clamp(min=1.0))
                          .max()) if d.numel() else 0.0
                worst = max(worst, e)
                check(bool(ok.all()) and e <= OPS22_TOL,
                      f"[22] (c) {name}: error {e:.3g} (NaNs alike "
                      f"{bool(ok.all())})")
            else:
                check(torch.equal(g, w), f"[22] (c) {name}: {g} != {w}")
        covered.add(name)
        n += 1
    # the random ops: the card's stream is its own (not the CPU's): range,
    # moments and determinism under a seeded generator
    shape = torch.tensor([400, 50], dtype=torch.int32, device=dev)
    u = ops.RandomUniform(2.0, 3.0, seed=7)
    s1, _ = u.apply({}, {}, shape)
    s2, _ = u.apply({}, {}, shape)
    tn, _ = ops.TruncatedNormal(1.0, 2.0, seed=7).apply({}, {}, shape)
    zs = (tn - 1.0) / 2.0
    check(s1.device.type == torch.device(dev).type and torch.equal(s1, s2)
          and float(s1.min()) >= 2.0 and float(s1.max()) < 3.0
          and abs(float(s1.mean()) - 2.5) < 0.01
          and float(zs.abs().max()) <= 2.0 + 1e-5
          and abs(float(zs.var()) - 0.7737) < 0.02,
          "[22] (c) random ops: range, moments or determinism")
    covered |= {"RandomUniform", "TruncatedNormal"}
    missing = set(ops.__all__) - covered
    check(not missing, f"[22] (c) ops not run on the card: {missing}")
    return n + 2, worst, covered


def loaders(torch, K, card, p4, dev="cuda", tmp=None):
    """Phase 22: (a) phase 4's flagship with bf16 weights through
    ``save_bigdl`` -> ``load_bigdl(device=None)``: every leaf bit for bit,
    ``generate`` (B8, prompt 128) token for token the original's with 12
    K1-fwd launches each on ``bf16_sm90``, and ``DecodeScheduler`` over 4
    of phase 4's requests on both models: tokens bit for bit, each
    prompt's resident pages bit for bit, the loaded model's pages of
    request 0's prompt against its dense prefill, K2 on ``f32_split``; (b) B8/224 convnets
    through the formats against the original in evaluation mode (TF32
    off): ResNet-50 ``save_tf`` -> ``load_tf_graph``, Inception v1
    ``save_caffe`` -> ``load_caffe`` and ``save_bigdl`` -> ``load_bigdl``,
    VGG-16 ``save_torch`` -> ``load_torch``; bit for bit where the loaded
    layers are the original's classes (bigdl.proto, Torch7), else within
    LOAD22_TOL; (c) every op of ``ops.__all__`` on the card against the
    CPU."""
    from bigdl_tpu_torch import convert, models, nn, ops
    from bigdl_tpu_torch.loaders import (load_caffe, load_tf_graph,
                                         load_torch)
    from bigdl_tpu_torch.loaders.bigdl_proto import load_bigdl, save_bigdl
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import DecodeScheduler, ModelRegistry
    from bigdl_tpu_torch.utils.table import Table
    t22 = time.perf_counter()
    tmp = tmp or tempfile.mkdtemp(prefix="phase22_")
    out = {}
    sync = (torch.cuda.synchronize if dev == "cuda" else (lambda: None))

    # (a) the flagship from a .bigdl file
    B, TP, NEW = L22["gen"]
    model = TransformerLM(**FLAGSHIP, seed=0, device=dev)
    with torch.no_grad():          # phase 4's serving weights, held bf16
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
    params = model.params
    path = os.path.join(tmp, "flagship.bigdl")
    sync()
    t0 = time.perf_counter()
    save_bigdl(model, path)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    loaded = load_bigdl(path, device=None if dev == "cuda" else dev)
    sync()
    load_s = time.perf_counter() - t0
    os.remove(path)
    want, got = convert.flatten(params), convert.flatten(loaded.params)
    check(sorted(want) == sorted(got), "[22] (a) leaf names differ")
    for k in want:
        check(got[k].dtype == want[k].dtype == torch.bfloat16
              and got[k].device == want[k].device
              and torch.equal(got[k], want[k]),
              f"[22] (a) leaf {k} not bit for bit")
    prompt = np.random.RandomState(0).randint(
        1, FLAGSHIP["vocab_size"], (B, TP)).astype(np.int32)
    toks, gen_launches = [], 0
    for m in (model, loaded):
        sync()
        K.reset_launch_counts()
        toks.append(m.generate(m.params, prompt, NEW))
        sync()
        c, rt = K.launch_counts(), K.launches_by_route()
        L = FLAGSHIP["num_layers"]
        check(c["flash_fwd"] == L and only_on(rt["flash_fwd"], "bf16_sm90", L)
              and sum(c.values()) == L or dev != "cuda",
              f"[22] (a) generate launched {c}, routes {rt['flash_fwd']}")
        gen_launches += c["flash_fwd"]
    check(torch.equal(toks[0], toks[1]), "[22] (a) generate: the loaded "
          "model's tokens differ from the original's")
    prompts, budgets = p4["prompts"][:L22["n_req"]], \
        p4["budgets"][:L22["n_req"]]
    served, scheds, k2, serve_flash = [], [], 0, 0
    for m in (model, loaded):
        reg = ModelRegistry(device=m.device)
        reg.publish(m.params, version="bf16", activate=True)
        sched = DecodeScheduler(m, max_slots=L22["slots"],
                                block_size=L22["block"],
                                max_seq_len=L22["max_seq"], registry=reg)
        sched.warmup()
        sync()
        K.reset_launch_counts()
        futs = [sched.submit(p, n) for p, n in zip(prompts, budgets)]
        sched.start(warmup=False)     # every request queued: one batching
        res = [f.result(600) for f in futs]
        sync()
        c, rt = K.launch_counts(), K.launches_by_route()
        check(c["paged_attention"] > 0 and only_on(
            rt["paged_attention"], "f32_split", c["paged_attention"])
            or dev != "cuda", f"[22] (a) serving's K2 launches {rt}")
        k2 += c["paged_attention"]
        serve_flash += c["flash_fwd"]
        served.append(res)
        scheds.append(sched)
    for i, (x, y) in enumerate(zip(*served)):
        check(x.size == budgets[i] and np.array_equal(x, y),
              f"[22] (a) request {i}: served tokens differ")
    # the pages each request's prompt left resident in the prefix cache
    # (a pool's never-written blocks hold whatever the allocator gave it)
    n_blocks = 0
    for i, p in enumerate(prompts):
        (b0, pg0), (b1, pg1) = [resident_chain(torch, s, p) for s in scheds]
        check(len(b0) == len(b1) == len(p) // L22["block"] and len(b0) > 0
              and same_pages(pg0, pg1), f"[22] (a) request {i}: resident "
              f"pages not bit for bit ({len(b0)} / {len(b1)} blocks)")
        n_blocks += len(b0)
    blocks, pages = resident_chain(torch, scheds[1], prompts[0])
    dense = dense_pages(torch, loaded, loaded.params,
                        prompts[0][:len(blocks) * L22["block"]],
                        L22["block"]) if dev == "cuda" else pages
    perr = page_err(pages, dense) if dev == "cuda" else 0.0
    check(perr < PAGE_TOL, f"[22] (a) pages against the dense prefill "
          f"{perr:.4f}")
    for s in scheds:
        s.shutdown()
    print(f"[22] (a) flagship bf16: save_bigdl {save_s:.2f} s, load_bigdl "
          f"{load_s:.2f} s, {nbytes} bytes; {len(want)} leaves bit for bit; "
          f"generate {B}x{NEW} tokens equal, {gen_launches} K1-fwd launches "
          f"({FLAGSHIP['num_layers']} each, bf16_sm90); {len(prompts)} served "
          f"requests ({sum(r.size for r in served[0])} tokens) and their "
          f"{n_blocks} resident prompt blocks bit for bit; the "
          f"{len(blocks)} of request 0 within "
          f"{perr:.4f} of the dense prefill; K2 {k2} launches (f32_split), "
          f"flash {serve_flash} ({card})", flush=True)
    out.update(save_s=save_s, load_s=load_s, nbytes=nbytes,
               flash_fwd=gen_launches, paged_attention=k2,
               serve_flash=serve_flash)
    del model, loaded, params, scheds, reg, sched
    if dev == "cuda":
        torch.cuda.empty_cache()

    # (b) convnets through the formats, TF32 off
    if dev == "cuda":
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    S, CB = L22["S"], L22["conv_B"]
    x = torch.from_numpy(np.random.RandomState(3).randn(
        CB, 3, S, S).astype(np.float32)).to(dev)
    kw = {} if dev == "cuda" else {"device": dev}

    def via_tf(m):
        g = m.save_tf((3, S, S), os.path.join(tmp, "r.pb"))
        return load_tf_graph(os.path.join(tmp, "r.pb"), **kw), len(g)

    def via_caffe(m):
        m.save_caffe(os.path.join(tmp, "i.prototxt"),
                     os.path.join(tmp, "i.caffemodel"), (3, S, S))
        return load_caffe(os.path.join(tmp, "i.prototxt"),
                          os.path.join(tmp, "i.caffemodel"), **kw), \
            os.path.getsize(os.path.join(tmp, "i.caffemodel"))

    def via_bigdl(m):
        save_bigdl(m, os.path.join(tmp, "i.bigdl"))
        return load_bigdl(os.path.join(tmp, "i.bigdl"), **kw), \
            os.path.getsize(os.path.join(tmp, "i.bigdl"))

    def via_t7(m):
        m.save_torch(os.path.join(tmp, "v.t7"))
        return load_torch(os.path.join(tmp, "v.t7"), **kw), \
            os.path.getsize(os.path.join(tmp, "v.t7"))

    trips = [("ResNet-50", "TF GraphDef", lambda: models.ResNet50(
                  device=dev), via_tf, False),
             ("Inception v1", "Caffe", lambda: models.Inception_v1(
                 1000, device=dev), via_caffe, False),
             ("Inception v1", "bigdl.proto", lambda: models.Inception_v1(
                 1000, device=dev), via_bigdl, True),
             ("VGG-16", "Torch7", lambda: models.Vgg_16(1000, device=dev),
              via_t7, True)]
    out["trips"] = []
    try:
        for name, fmt, make, trip, bitwise in trips:
            m = make().evaluate()
            with torch.no_grad():
                want = m(x)
            sync()
            t0 = time.perf_counter()
            g, size = trip(m)
            g.evaluate()
            sync()
            dt = time.perf_counter() - t0
            with torch.no_grad():
                got = g(x).reshape(want.shape)
            same = bool(torch.equal(got, want))
            err = _rel_err(got, want)
            check(same if bitwise else err <= LOAD22_TOL,
                  f"[22] (b) {name} through {fmt}: bit for bit {same}, "
                  f"relative error {err:.3g}")
            print(f"[22] (b) {name} B{CB}/{S} through {fmt}: round trip "
                  f"{dt:.2f} s ({size} bytes); outputs "
                  + ("bit for bit" if same else f"within {err:.3g} "
                     f"(relative, tolerance {LOAD22_TOL})")
                  + f" of the original's ({card})", flush=True)
            out["trips"].append((name, fmt, dt, size, same, err))
            del m, g
            for f in os.listdir(tmp):
                os.remove(os.path.join(tmp, f))
    finally:
        if dev == "cuda":
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
            torch.cuda.empty_cache()

    # (c) every op on the card against the CPU
    t0 = time.perf_counter()
    n_ops, worst, covered = _ops_card_vs_cpu(torch, ops, nn, Table, dev)
    print(f"[22] (c) {n_ops} op cases over all {len(covered)} names of "
          f"ops.__all__ on the card against the CPU in "
          f"{time.perf_counter() - t0:.2f} s: integers, booleans and "
          f"strings equal, floats within {worst:.3g} (tolerance "
          f"{OPS22_TOL}) ({card})", flush=True)
    out["phase_s"] = time.perf_counter() - t22
    print(f"[22] phase 22: {out['phase_s']:.1f} s", flush=True)
    return out


# -- phase 23: the Keras-1.2 API and converter, dlframes and util ----------------

# Keras 1.2.2's keras/applications/resnet50.py (ResNet50, include_top): the
# bottleneck widths of each stage and its blocks; 224 images, 1000 classes
KERAS_RESNET = dict(blocks=(3, 4, 6, 3), widths=(64, 128, 256, 512),
                    size=224, classes=1000)


def keras_resnet_json(blocks=(3, 4, 6, 3), widths=(64, 128, 256, 512),
                      size=224, classes=1000, ordering="th"):
    """Keras 1.2.2's ResNet50 (``keras/applications/resnet50.py``) as its
    ``model.to_json()`` writes it: the functional ``Model`` config with
    Keras's layer names (``conv1``, ``bn_conv1``, ``res2a_branch2a``,
    ``bn2a_branch2a``, ..., ``avg_pool``, ``fc1000``; the unnamed layers
    ``input_1``, ``zeropadding2d_1``, ``activation_N``, ``merge_N``, ...),
    ``dim_ordering`` ``ordering`` and BatchNormalization on its channel
    axis. ``blocks`` / ``widths`` / ``size`` cut it for a test (the
    average pool spans what is left of the image)."""
    th = ordering == "th"
    layers, counts = [], {}

    def auto(kind):
        counts[kind] = counts.get(kind, 0) + 1
        return f"{kind}_{counts[kind]}"

    def add(cls, name, cfg, parents):
        layers.append({"class_name": cls, "name": name,
                       "config": dict(cfg, name=name, trainable=True),
                       "inbound_nodes": ([[[p, 0, 0] for p in parents]]
                                         if parents else [])})
        return name

    def conv(x, n, k, name, stride=1, same=False):
        return add("Convolution2D", name, {
            "nb_filter": n, "nb_row": k, "nb_col": k, "init": "glorot_uniform",
            "activation": "linear", "border_mode": "same" if same else "valid",
            "subsample": [stride, stride], "dim_ordering": ordering,
            "W_regularizer": None, "b_regularizer": None,
            "activity_regularizer": None, "W_constraint": None,
            "b_constraint": None, "bias": True}, [x])

    def bn(x, name):
        return add("BatchNormalization", name, {
            "epsilon": 0.001, "mode": 0, "axis": 1 if th else 3,
            "momentum": 0.99, "gamma_regularizer": None,
            "beta_regularizer": None}, [x])

    def relu(x):
        return add("Activation", auto("activation"), {"activation": "relu"},
                   [x])

    def block(x, stage, blk, width, stride, project):
        cb, bb = f"res{stage}{blk}_branch", f"bn{stage}{blk}_branch"
        y = relu(bn(conv(x, width, 1, cb + "2a", stride), bb + "2a"))
        y = relu(bn(conv(y, width, 3, cb + "2b", same=True), bb + "2b"))
        y = bn(conv(y, 4 * width, 1, cb + "2c"), bb + "2c")
        short = (bn(conv(x, 4 * width, 1, cb + "1", stride), bb + "1")
                 if project else x)
        m = add("Merge", auto("merge"), {
            "mode": "sum", "concat_axis": -1, "dot_axes": -1,
            "mode_type": "raw", "output_shape": None,
            "output_shape_type": "raw", "output_mask": None,
            "output_mask_type": "raw", "arguments": {}}, [y, short])
        return relu(m)

    shape = [3, size, size] if th else [size, size, 3]
    x = add("InputLayer", "input_1", {"batch_input_shape": [None] + shape,
                                      "input_dtype": "float32",
                                      "sparse": False}, [])
    x = add("ZeroPadding2D", auto("zeropadding2d"),
            {"padding": [3, 3], "dim_ordering": ordering}, [x])
    x = relu(bn(conv(x, 64, 7, "conv1", 2), "bn_conv1"))
    x = add("MaxPooling2D", auto("maxpooling2d"), {
        "pool_size": [3, 3], "strides": [2, 2], "border_mode": "valid",
        "dim_ordering": ordering}, [x])
    s = ((size + 6 - 7) // 2 + 1 - 3) // 2 + 1
    for i, (n, w) in enumerate(zip(blocks, widths)):
        stride = 1 if i == 0 else 2
        s = (s - 1) // stride + 1
        for j in range(n):
            x = block(x, i + 2, "abcdefghijklmnop"[j], w, stride if j == 0
                      else 1, j == 0)
    x = add("AveragePooling2D", "avg_pool", {
        "pool_size": [s, s], "strides": [s, s], "border_mode": "valid",
        "dim_ordering": ordering}, [x])
    x = add("Flatten", auto("flatten"), {}, [x])
    add("Dense", "fc1000", {"output_dim": classes, "init": "glorot_uniform",
                            "activation": "softmax", "W_regularizer": None,
                            "b_regularizer": None,
                            "activity_regularizer": None,
                            "W_constraint": None, "b_constraint": None,
                            "bias": True, "input_dim": None}, [x])
    return json.dumps({"class_name": "Model", "keras_version": "1.2.2",
                       "config": {"name": "resnet50", "layers": layers,
                                  "input_layers": [["input_1", 0, 0]],
                                  "output_layers": [["fc1000", 0, 0]]}})


def keras_resnet_weights(json_def, seed=0, ordering="th"):
    """Keras-layout weights for :func:`keras_resnet_json`'s model, drawn
    from ``seed`` in definition order: convolutions (out, in, kh, kw) for
    ``"th"`` and (kh, kw, in, out) for ``"tf"`` (He-scaled), each with its
    bias; BatchNormalization [gamma, beta, running mean, running
    variance]; ``fc1000`` (in, out). The draws are the same for both
    orderings, so the two models compute one function."""
    rng = np.random.RandomState(seed)
    spec = json.loads(json_def)["config"]["layers"]
    chans, out = {}, {}
    for ly in spec:
        c, name = ly["config"], ly["name"]
        parents = [p[0] for p in ly["inbound_nodes"][0]] \
            if ly["inbound_nodes"] else []
        cin = chans.get(parents[0]) if parents else None
        cls = ly["class_name"]
        if cls == "InputLayer":
            shp = c["batch_input_shape"][1:]
            chans[name] = shp[0] if ordering == "th" else shp[-1]
        elif cls == "Convolution2D":
            n, k = c["nb_filter"], c["nb_row"]
            w = (rng.randn(n, cin, k, k) * np.sqrt(2.0 / (cin * k * k)))
            b = 0.01 * rng.randn(n)
            if ordering == "tf":
                w = w.transpose(2, 3, 1, 0)
            out[name] = [w.astype(np.float32), b.astype(np.float32)]
            chans[name] = n
        elif cls == "BatchNormalization":
            out[name] = [(0.5 + 0.5 * rng.rand(cin)).astype(np.float32),
                         (0.1 * rng.randn(cin)).astype(np.float32),
                         (0.1 * rng.randn(cin)).astype(np.float32),
                         (0.5 + rng.rand(cin)).astype(np.float32)]
            chans[name] = cin
        elif cls == "Dense":
            out[name] = [(rng.randn(cin, c["output_dim"]) / np.sqrt(cin))
                         .astype(np.float32),
                         (0.01 * rng.randn(c["output_dim"]))
                         .astype(np.float32)]
        else:
            chans[name] = cin
    return out


# the sizes of phase 23 (a CPU rehearsal shrinks them): (a) the Keras
# ResNet-50's predict batch and fit set; (b) Keras 1.2.2's
# examples/imdb_cnn_lstm.py (max_features 20000, maxlen 100, embedding 128,
# 64 filters of 5, pool 4, LSTM 70, batch 30), the steps held against the
# CPU and the steps timed after them; (c) the DLClassifier's rows, batch
# and image side over the port's ResNet-50; (d) DLImageTransformer's images
K23 = dict(resnet=KERAS_RESNET, pred_B=8, fit_B=8, fit_steps=2,
           imdb=dict(vocab=20000, maxlen=100, emb=128, filters=64, kernel=5,
                     pool=4, lstm=70, batch=30, cpu_steps=3, timed=5),
           dl=dict(rows=64, B=32, size=224, classes=1000), img=(4, 256))
KERAS23_TOL = 1e-4    # card against CPU, float32 with TF32 off, relative to
#                       the largest output (the ResNet's softmax, the LSTM
#                       model's losses)


@contextlib.contextmanager
def step_record():
    """Records the loss every training step of any optimizer returns
    (device tensors, read after the run) and the optimizers that ran
    them: the Keras ``fit`` and the DLClassifier build their optimizer
    inside. ``rec["ms"]()``: the last optimizer's step times."""
    from bigdl_tpu_torch.optim.optimizer import BaseOptimizer
    step = BaseOptimizer._step
    rec = {"losses": [], "opts": []}

    def recording(self, *a):
        rec["losses"].append(step(self, *a))
        if self not in rec["opts"]:
            rec["opts"].append(self)
        return rec["losses"][-1]
    rec["ms"] = lambda: [v * 1e3 for v in rec["opts"][-1].metrics.values
                         .get("step_time", [])]
    BaseOptimizer._step = recording
    try:
        yield rec
    finally:
        BaseOptimizer._step = step


def _moved(before, after):
    """How many leaves of a host tree changed."""
    from bigdl_tpu_torch.convert import flatten
    fa, fb = flatten(before), flatten(after)
    return sum(not np.array_equal(fa[k], fb[k]) for k in fa)


def keras_frames(torch, K, card, dev="cuda", sizes=None):
    """Phase 23: the Keras-1.2 API and converter, dlframes and util on the
    card. (a) Keras 1.2.2's ResNet-50 written as its functional JSON
    (``keras_resnet_json``, "th"), ``model_from_json(device=)`` and
    ``load_weights`` of Keras-layout weights (BatchNorm statistics
    included), ``predict`` at B8/224 against the same model on the CPU
    (TF32 off, ``KERAS23_TOL``), the "tf" spelling with its kernels in
    Keras-tf layout giving the same predictions, then ``compile("sgd",
    "categorical_crossentropy", ["accuracy"])``, ``fit`` of 2 steps at B8
    and ``evaluate``: finite losses, the leaves moved. (b) The
    ``Sequential`` of Keras 1.2.2's ``examples/imdb_cnn_lstm.py`` trained
    with ``compile("adam", "binary_crossentropy", ["accuracy"])`` at batch
    30 on seeded token ids: 3 steps' losses against the CPU's (Dropout
    p = 0), then the real model's step ms. (c) ``DLClassifier`` over the
    port's ResNet-50 (NHWC, ``fused="pallas"``, float32), fit on a dict of
    columns (64 rows of 224x224x3, labels 1..1000) at B32 for an epoch,
    ``fused_conv2`` off and on: finite losses, the leaves moved, 24 K3
    and 12 K5 forwards and as many backwards a step (16 K4 forwards with
    ``fused_conv2``) on ``f32_sm90``; ``DLClassifierModel.transform``
    equal to 1 + argmax of the trained model's own evaluation-mode
    forward, with the no-statistics launches of its two batches. (d)
    ``util.common`` (``init_engine``, ``get_node_and_core_number``, a
    ``JTensor`` round trip of a card tensor, ``RNG.set_seed`` making the
    card's and the CPU's initial weights equal, ``to_sample_rdd`` into
    ``LocalOptimizer`` for 2 steps) and ``DLImageTransformer`` on a dict
    image column, fed to (c)'s model."""
    from bigdl_tpu_torch import dlframes, keras, nn
    from bigdl_tpu_torch.convert import flatten, host_copy_tree
    from bigdl_tpu_torch.keras.converter import load_weights, model_from_json
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.transform import vision
    from bigdl_tpu_torch.util import common
    from bigdl_tpu_torch.utils import engine
    c = sizes or K23
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t23 = time.perf_counter()
    out = {"cells_ms": {}, "launches": {}}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[23] the Keras-1.2 API and converter, dlframes and util "
          f"({card})", flush=True)
    try:
        # (a) Keras 1.2.2's ResNet-50 from its JSON
        t_a = time.perf_counter()
        r = c["resnet"]
        j_th = keras_resnet_json(**r, ordering="th")
        w_th = keras_resnet_weights(j_th, seed=0, ordering="th")
        t0 = time.perf_counter()
        m = model_from_json(j_th, device=dev)
        sync()
        json_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_weights(m, w_th)
        sync()
        load_s = time.perf_counter() - t0
        S, B = r["size"], c["pred_B"]
        rng = np.random.RandomState(23)
        x = rng.randn(B, 3, S, S).astype(np.float32)
        sync()
        t0 = time.perf_counter()
        p_card = m.predict(x, batch_size=B)
        pred_ms = (time.perf_counter() - t0) * 1e3
        cpu = model_from_json(j_th, device="cpu")
        load_weights(cpu, w_th)
        p_cpu = cpu.predict(x, batch_size=B)
        del cpu
        scale = float(np.abs(p_cpu).max())
        err = float(np.abs(p_card - p_cpu).max()) / scale
        check(p_card.shape == (B, r["classes"]) and np.isfinite(p_card).all()
              and err <= KERAS23_TOL, f"[23] (a) predict {p_card.shape} "
              f"against the CPU: relative err {err} (tol {KERAS23_TOL})")
        j_tf = keras_resnet_json(**r, ordering="tf")
        m_tf = model_from_json(j_tf, device=dev)
        load_weights(m_tf, keras_resnet_weights(j_tf, seed=0, ordering="tf"))
        check(m_tf._tf_ordered, "[23] (a) the tf spelling was not tf-ordered")
        p_tf = m_tf.predict(x, batch_size=B)
        err_tf = float(np.abs(p_tf - p_card).max()) / scale
        check(err_tf <= KERAS23_TOL, f"[23] (a) the tf spelling's "
              f"predictions against th: relative err {err_tf}")
        del m_tf
        n_fit = c["fit_B"] * c["fit_steps"]
        xf = rng.randn(n_fit, 3, S, S).astype(np.float32)
        yf = np.eye(r["classes"], dtype=np.float32)[
            rng.randint(0, r["classes"], n_fit)]
        before = host_copy_tree(m._module().params)
        m.compile("sgd", "categorical_crossentropy", ["accuracy"])
        with step_record() as rec:
            m.fit(xf, yf, batch_size=c["fit_B"], nb_epoch=1)
        losses = [float(v) for v in rec["losses"]]
        steps_a = rec["ms"]()
        moved = _moved(before, host_copy_tree(m._module().params))
        ev = m.evaluate(xf, yf, batch_size=c["fit_B"])
        check(len(losses) == c["fit_steps"] and np.isfinite(losses).all()
              and moved > 0 and np.isfinite(ev).all(),
              f"[23] (a) fit losses {losses}, leaves moved {moved}, "
              f"evaluate {ev}")
        n_leaves = len(flatten(before))
        del m, before
        out["a"] = dict(json_s=json_s, load_s=load_s, pred_ms=pred_ms,
                        err=err, err_tf=err_tf, losses=losses,
                        step_ms=steps_a)
        out["cells_ms"]["a"] = (time.perf_counter() - t_a) * 1e3
        print(f"    (a) Keras-1.2 ResNet-50 ({len(w_th)} weighted layers) "
              f"from JSON: model_from_json {json_s:.3f} s, load_weights "
              f"{load_s:.3f} s; predict B{B}/{S} {pred_ms:.1f} ms, against "
              f"the CPU relative err {err:.2e}, the tf spelling {err_tf:.2e} "
              f"(tol {KERAS23_TOL}); fit B{c['fit_B']} losses "
              f"{[round(v, 4) for v in losses]}, step ms "
              f"{[round(v, 1) for v in steps_a]}, {moved} of "
              f"{n_leaves} leaves moved; evaluate [loss, acc] "
              f"{[round(float(v), 4) for v in ev]}", flush=True)

        # (b) Keras 1.2.2's examples/imdb_cnn_lstm.py
        t_b = time.perf_counter()
        im = c["imdb"]

        def imdb(p, device):
            s = keras.Sequential(device=device)
            s.add(keras.Embedding(im["vocab"], im["emb"],
                                  input_length=im["maxlen"]))
            s.add(keras.Dropout(p))
            s.add(keras.Convolution1D(im["filters"], im["kernel"],
                                      border_mode="valid", activation="relu",
                                      subsample_length=1))
            s.add(keras.MaxPooling1D(pool_length=im["pool"]))
            s.add(keras.LSTM(im["lstm"]))
            s.add(keras.Dense(1))
            s.add(keras.Activation("sigmoid"))
            return s.compile("adam", "binary_crossentropy", ["accuracy"])
        n = im["batch"] * im["cpu_steps"]
        ids = rng.randint(0, im["vocab"], (n, im["maxlen"])).astype(
            np.float32)
        lab = rng.randint(0, 2, n).astype(np.float32)
        runs = {}
        for where in (dev, "cpu"):
            torch.manual_seed(23)         # the same initial weights
            s = imdb(0.0, where)
            with step_record() as rec:
                s.fit(ids, lab, batch_size=im["batch"], nb_epoch=1)
            runs[where] = [float(v) for v in rec["losses"]]
        lerr = max(abs(a - b) / max(abs(b), 1e-6)
                   for a, b in zip(runs[dev], runs["cpu"]))
        check(len(runs[dev]) == im["cpu_steps"]
              and np.isfinite(runs[dev]).all() and lerr <= KERAS23_TOL,
              f"[23] (b) losses {runs[dev]} against the CPU's "
              f"{runs['cpu']}: relative err {lerr}")
        nt = im["batch"] * (1 + im["timed"])
        real = imdb(0.25, dev)
        real.fit(rng.randint(0, im["vocab"], (nt, im["maxlen"])).astype(
            np.float32), rng.randint(0, 2, nt).astype(np.float32),
            batch_size=im["batch"], nb_epoch=1)
        steps_b = [v * 1e3 for v in
                   real.history.metrics.values.get("step_time", [])]
        del real, s
        out["b"] = dict(losses=runs[dev], cpu_losses=runs["cpu"], err=lerr,
                        step_ms=steps_b)
        out["cells_ms"]["b"] = (time.perf_counter() - t_b) * 1e3
        print(f"    (b) imdb_cnn_lstm Sequential (Embedding {im['vocab']} x "
              f"{im['emb']}, T {im['maxlen']}, LSTM {im['lstm']}), adam, "
              f"batch {im['batch']}: {im['cpu_steps']} losses "
              f"{[round(v, 6) for v in runs[dev]]} against the CPU's within "
              f"{lerr:.2e} (tol {KERAS23_TOL}, Dropout p = 0); Dropout 0.25 "
              f"step ms {[round(v, 2) for v in steps_b]} (median after the "
              f"first {statistics.median(steps_b[1:]):.2f})", flush=True)

        # (c) DLClassifier over the port's ResNet-50, fused_conv2 off, on
        t_c = time.perf_counter()
        dl = c["dl"]
        S, R, BB = dl["size"], dl["rows"], dl["B"]
        feats = rng.randn(R, S * S * 3).astype(np.float32)
        labels = (rng.randint(0, dl["classes"], R) + 1).astype(np.float32)
        frame = {"features": feats, "label": labels}
        steps = R // BB
        out["c"] = {}
        model_c = None
        for conv2 in (False, True):
            rn = ResNet50(format="NHWC", fused="pallas", fused_conv2=conv2,
                          seed=0, device=dev)
            before = host_copy_tree(rn.params)
            est = dlframes.DLClassifier(rn, nn.CrossEntropyCriterion(),
                                        [S, S, 3], device=dev)
            est.set_batch_size(BB).set_max_epoch(1)
            sync()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with step_record() as rec:
                fitted = est.fit(frame)
            sync()
            fit_s = time.perf_counter() - t0
            fit_counts, fit_routes = K.launch_counts(), K.launches_by_route()
            losses = [float(v) for v in rec["losses"]]
            steps_c = rec["ms"]()
            moved = _moved(before, host_copy_tree(rn.params))
            check(isinstance(fitted, dlframes.DLClassifierModel)
                  and fitted.model is rn and len(losses) == steps
                  and np.isfinite(losses).all() and moved > 0,
                  f"[23] (c) fused_conv2={conv2}: losses {losses}, leaves "
                  f"moved {moved}")
            if cuda:
                check_resnet_launches(K, {"counts": fit_counts,
                                          "routes": fit_routes}, steps,
                                      f"[23] (c) fit fused_conv2={conv2}",
                                      conv2)
            sync()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            res = fitted.transform(frame)
            sync()
            tr_ms = (time.perf_counter() - t0) * 1e3
            tr_counts, tr_routes = K.launch_counts(), K.launches_by_route()
            rn.evaluate()
            with torch.no_grad():
                want = np.concatenate([
                    rn.forward(torch.from_numpy(
                        feats[i:i + BB].reshape(-1, S, S, 3)).to(dev))
                    .argmax(-1).cpu().numpy() + 1
                    for i in range(0, R, BB)])
            check(set(res) == {"features", "label", "prediction"}
                  and np.array_equal(res["prediction"], want),
                  f"[23] (c) transform {res['prediction'][:8]} against 1 + "
                  f"argmax of the eval forward {want[:8]}")
            if cuda:
                ev_want = dict.fromkeys(K.WRAPPERS, 0)
                ev_want.update(fused_matmul_fwd=24 * steps,
                               fused_chain_fwd=12 * steps,
                               fused_conv_fwd=16 * steps if conv2 else 0)
                check(tr_counts == ev_want
                      and all(only_on(tr_routes[k], "f32_sm90", v)
                              for k, v in ev_want.items() if v),
                      f"[23] (c) transform launches {tr_counts} by route "
                      f"{tr_routes}, expected {ev_want} on f32_sm90")
            out["c"][conv2] = dict(losses=losses, fit_s=fit_s,
                                   step_ms=steps_c, transform_ms=tr_ms,
                                   fit=fit_counts, transform=tr_counts)
            print(f"    (c) DLClassifier ResNet-50 NHWC pallas float32 "
                  f"fused_conv2={conv2}: fit {R} rows at B{BB} {fit_s:.2f} s "
                  f"(the columns to Samples included), step ms "
                  f"{[round(v, 1) for v in steps_c]}, losses "
                  f"{[round(v, 4) for v in losses]}, "
                  f"{moved} leaves moved; launches "
                  f"{ {k: v for k, v in fit_counts.items() if v} }; "
                  f"transform {tr_ms:.1f} ms equal to 1 + argmax of the "
                  f"eval forward, launches "
                  f"{ {k: v for k, v in tr_counts.items() if v} }",
                  flush=True)
            if conv2:
                model_c = fitted
            else:
                del rn, fitted, est
        out["cells_ms"]["c"] = (time.perf_counter() - t_c) * 1e3

        # (d) util.common and DLImageTransformer
        t_d = time.perf_counter()
        saved = (dict(engine._state), torch.get_rng_state(),
                 np.random.get_state())
        try:
            common.init_engine(device=dev)
            nodes = common.get_node_and_core_number(device=dev)
            check(engine.is_initialized() and nodes[0] >= 1 and nodes[1] >= 1,
                  f"[23] (d) get_node_and_core_number {nodes}")
            t = torch.randn(3, 5, device=dev)
            jt = common.JTensor.from_ndarray(t.cpu().numpy())
            back = torch.from_numpy(jt.to_ndarray()).to(dev)
            check(torch.equal(back, t) and list(jt.shape) == [3, 5],
                  "[23] (d) JTensor round trip")
            r1 = common.RNG()
            r1.set_seed(7)
            draw = r1.uniform(0, 1, (4,))
            card_lin = nn.Linear(6, 4).to(dev)
            r1.set_seed(7)
            check(np.array_equal(r1.uniform(0, 1, (4,)), draw),
                  "[23] (d) RNG draws")
            cpu_lin = nn.Linear(6, 4)
            check(torch.equal(card_lin.weight.cpu(), cpu_lin.weight)
                  and card_lin.weight.device.type == dev,
                  "[23] (d) RNG.set_seed: the card's initial weights differ "
                  "from the CPU's")
            xs = rng.randn(16, 6).astype(np.float32)
            ys = (rng.randint(0, 4, 16) + 1).astype(np.float32)
            mlp = nn.Sequential(nn.Linear(6, 4), nn.LogSoftMax()).to(dev)
            w0 = host_copy_tree(mlp.params)
            with step_record() as rec:
                LocalOptimizer(mlp, common.to_sample_rdd(xs, ys),
                               nn.ClassNLLCriterion(), SGD(0.5),
                               max_iteration(2), 8, device=dev).optimize()
            lu = [float(v) for v in rec["losses"]]
            check(len(lu) == 2 and np.isfinite(lu).all()
                  and _moved(w0, host_copy_tree(mlp.params)) > 0,
                  f"[23] (d) to_sample_rdd -> LocalOptimizer losses {lu}")
        finally:
            if engine.process_group() is not None and \
                    saved[0].get("group") is None:
                engine.destroy_process_group()
            engine._state.clear()
            engine._state.update(saved[0])
            torch.set_rng_state(saved[1])
            np.random.set_state(saved[2])
        n_img, side = c["img"]
        S = c["dl"]["size"]
        col = {"image": [{"origin": f"img{i}", "height": side, "width": side,
                          "nChannels": 3, "mode": 3,
                          "data": rng.randint(0, 256, (side, side, 3))
                          .astype(np.uint8)} for i in range(n_img)]}
        tr = dlframes.DLImageTransformer(
            vision.Resize(S, S) | vision.ChannelNormalize(
                123.0, 117.0, 104.0, 58.0, 57.0, 57.0))
        res = tr.transform(col)
        outs = [r_["data"] for r_ in res["output"]]
        direct = list((vision.Resize(S, S) | vision.ChannelNormalize(
            123.0, 117.0, 104.0, 58.0, 57.0, 57.0))(
            [np.asarray(i["data"], np.float32) for i in col["image"]]))
        check(set(res) == {"image", "output"} and all(
            o.shape == (S, S, 3) and np.array_equal(o, np.asarray(d))
            for o, d in zip(outs, direct)),
            "[23] (d) DLImageTransformer's column against the transformer")
        sync()
        K.reset_launch_counts()
        pred = model_c.transform({"features": np.stack(
            [o.reshape(-1) for o in outs])})["prediction"]
        sync()
        img_counts = K.launch_counts()
        check(pred.shape == (n_img,) and pred.min() >= 1
              and pred.max() <= dl["classes"],
              f"[23] (d) the transformed images' classes {pred}")
        if cuda:
            want = dict.fromkeys(K.WRAPPERS, 0)
            want.update(fused_matmul_fwd=24, fused_chain_fwd=12,
                        fused_conv_fwd=16)
            check(img_counts == want, f"[23] (d) the transformed images' "
                  f"transform launched {img_counts}, expected {want}")
        out["d"] = dict(nodes=nodes, transform=img_counts)
        out["cells_ms"]["d"] = (time.perf_counter() - t_d) * 1e3
        print(f"    (d) init_engine / get_node_and_core_number {nodes}; "
              f"JTensor round trip bit for bit; RNG.set_seed: card and CPU "
              f"initial weights equal; to_sample_rdd -> LocalOptimizer "
              f"losses {[round(v, 4) for v in lu]}; DLImageTransformer "
              f"{n_img} images {side} -> {S} equal to the transformer's, "
              f"their classes {pred.astype(int).tolist()} from (c)'s model "
              f"(launches {({k: v for k, v in img_counts.items() if v})})",
              flush=True)
        del model_c
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        if cuda:
            torch.cuda.empty_cache()
    for k in ("fused_matmul_fwd", "fused_matmul_bwd", "fused_chain_fwd",
              "fused_chain_bwd", "fused_conv_fwd"):
        out["launches"][k] = sum(v["fit"][k] for v in out["c"].values())
    for k in ("fused_matmul_fwd", "fused_chain_fwd", "fused_conv_fwd"):
        out["launches"][k + "_eval"] = \
            sum(v["transform"][k] for v in out["c"].values()) \
            + out["d"]["transform"][k]
    out["wall_s"] = time.perf_counter() - t23
    print(f"[23] wall {out['wall_s']:.1f} s; cells ms "
          f"{ {k: round(v, 1) for k, v in out['cells_ms'].items()} } "
          f"({card})", flush=True)
    return out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "bigdl_tpu_torch")):
        fail("bigdl_tpu_torch not found beside chip_smoke.py: run from a "
             "checkout of the repository")
    sys.path.insert(0, root)
    # phase 17's MovieLens split: host work started now, read in phase 17
    split_tmp = tempfile.mkdtemp(prefix="phase17_")
    split17 = movielens_split_start(root, split_tmp)
    atexit.register(shutil.rmtree, split_tmp, True)
    atexit.register(split17[0].kill)
    import bigdl_tpu_torch.kernels as K
    from bigdl_tpu_torch.kernels import _build
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import (DecodeScheduler, ModelRegistry,
                                         PagedKVCache)
    from bigdl_tpu_torch.utils.amp import bf16_params

    t_start = time.perf_counter()

    def mark(n):
        """The smoke's wall clock where phase ``n`` starts (the phases'
        walls for the time budget)."""
        print(f"[t] phase {n} starts at {time.perf_counter() - t_start:.1f}"
              f" s", flush=True)

    card = card_line()
    print(f"[1] card: {card}", flush=True)
    print(f"    torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    build_s = _build.build_all()
    print(f"    kernel build: {build_s:.2f} s ({len(_build.SOURCES)} sources "
          f"in parallel)", flush=True)
    sm90_spills = {}
    for name in _build.SOURCES:     # nvcc -Xptxas -v, one line a library
        log = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", log)]
        if regs:
            print(f"    {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                  f"registers, static smem up to {max(smem or [0])} bytes, "
                  f"spill stores up to {max(spills or [0])} bytes")
        if name.endswith("_sm90"):
            sm90_spills[name] = max(spills or [-1])
            # ptxas note C7514: wgmma products serialised (a performance
            # loss, not an error)
            print(f"    {name}: wgmma serialisation notes (C7514): "
                  f"{log.count('C7514')}")

    # -- phase 2 ----------------------------------------------------------
    mark(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[2] kernels vs plain versions (allow_tf32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32})", flush=True)
    bf, f32 = torch.bfloat16, torch.float32
    # K1-fwd: bf16 (tensor-core route) at the three timed shapes (serving
    # prefill, prefill_chunked piece, training), ragged T, D = 32 and 128,
    # non-causal Tq != Tkv and kv_len = 0; float32 (3xTF32 route, D <= 112)
    # beside
    k1_main = flash_case(torch, K, 8, 16, 128, 128, 64, bf, True, 0, 128,
                         timed=True)
    flash_case(torch, K, 8, 16, 128, 128, 64, f32, True, 0, 128, False)
    flash_case(torch, K, 8, 16, 77, 77, 64, bf, True, 0, 77, False)
    flash_case(torch, K, 8, 16, 77, 77, 64, f32, True, 0, 77, False)
    flash_case(torch, K, 8, 16, 130, 130, 64, bf, True, 0, 130, False)
    flash_case(torch, K, 8, 16, 130, 130, 32, bf, True, 0, 130, False)
    flash_case(torch, K, 2, 8, 200, 200, 128, bf, True, 0, 200, False)
    flash_case(torch, K, 4, 16, 100, 260, 64, bf, False, 0, 260, False)
    flash_case(torch, K, 4, 16, 100, 260, 128, bf, False, 0, 200, False)
    flash_case(torch, K, 2, 4, 16, 64, 64, bf, False, 0, 0, False)
    flash_case(torch, K, 2, 4, 16, 64, 64, bf, True, 0, 0, False)
    k1_chunk = flash_case(torch, K, 8, 16, 32, 384, 64, bf, True, 96, 128,
                          timed=True)
    flash_case(torch, K, 8, 16, 32, 384, 64, f32, True, 96, 128, False)
    k1_train = flash_case(torch, K, 16, 16, 1024, 1024, 64, bf, True, 0,
                          1024, timed=True)
    # the float32 route at the LocalOptimizer shape (phase 6: B8/T256) and
    # at T = 1024; then the wide kernel (D past 112): causal at (8,16,256,D)
    # for D = 128, 192 and 256 and the chunk form at D = 128, timed, and
    # non-causal and chunk cases at each of those D
    k1_f32 = flash_case(torch, K, 8, 16, 256, 256, 64, f32, True, 0, 256,
                        timed=True)
    k1_f32_long = flash_case(torch, K, 2, 16, 1024, 1024, 64, f32, True, 0,
                             1024, timed=True)
    k1_wide = {D: flash_case(torch, K, 8, 16, 256, 256, D, f32, True, 0, 256,
                             timed=True) for D in (128, 192, 256)}
    k1_f32_wide = k1_wide[128]
    k1_wide_chunk = flash_case(torch, K, 8, 16, 32, 384, 128, f32, True, 96,
                               128, timed=True)
    for D in (128, 192, 256):
        flash_case(torch, K, 4, 8, 100, 260, D, f32, False, 0, 260, False)
        flash_case(torch, K, 4, 8, 32, 384, D, f32, True, 96, 200, False)
    check(all(r["route"] == "f32_sm90" for r in (
        k1_f32, k1_f32_long, k1_wide_chunk, *k1_wide.values())),
          f"float32 flash routes {k1_f32['route']}, {k1_f32_long['route']}, "
          f"{ {d: r['route'] for d, r in k1_wide.items()} }: expected "
          f"f32_sm90 at every D")
    # a user's path to the wide kernels: a float32 LM at the flagship's
    # widths with 8 heads (D = 128), a forward and a training step
    k1_lm = wide_head_lm(torch, K)
    k1_step = wide_head_step(torch, K)
    # K1-bwd: bf16 at the training shape, ragged T, D = 32 and 128, the
    # ring form (external delta, float32 gradients); float32 beside: the
    # 3xTF32 route timed at phase 6's shape and at T = 1024 (D = 64, the
    # narrow pair) and at (8,8,256,D) for D = 96, 128 and 192 (the wide
    # pair), ragged and non-causal, the ring form at D = 64, 128 and 100
    # (padded)
    k1b_main = bwd_case(torch, K, 16, 16, 1024, 64, bf, True, timed=True)
    k1b_f32 = bwd_case(torch, K, 8, 16, 256, 64, f32, True, timed=True)
    k1b_f32_long = bwd_case(torch, K, 2, 16, 1024, 64, f32, True, timed=True)
    bwd_case(torch, K, 8, 16, 77, 64, bf, True, False)
    bwd_case(torch, K, 8, 16, 77, 64, f32, False, False)
    bwd_case(torch, K, 4, 16, 130, 32, bf, True, False)
    bwd_case(torch, K, 4, 16, 130, 32, bf, False, False)
    bwd_case(torch, K, 4, 16, 130, 32, f32, False, False)
    bwd_case(torch, K, 2, 8, 200, 128, bf, True, False)
    bwd_case(torch, K, 2, 8, 200, 128, f32, True, False)
    bwd_case(torch, K, 4, 16, 300, 64, bf, False, False, ring=True)
    bwd_case(torch, K, 4, 16, 300, 64, f32, True, False, ring=True)
    bwd_case(torch, K, 4, 8, 300, 128, f32, True, False, ring=True)
    bwd_case(torch, K, 2, 4, 77, 100, f32, True, False, ring=True)
    bwd_case(torch, K, 4, 8, 100, 128, f32, False, False)
    k1b_wide = {D: bwd_case(torch, K, 8, 8, 256, D, f32, True, timed=True)
                for D in (96, 128, 192)}
    check(all(r["route"] == "f32_sm90" for r in (
        k1b_f32, k1b_f32_long, *k1b_wide.values())),
          f"float32 flash backward routes {k1b_f32['route']}, "
          f"{k1b_f32_long['route']}, "
          f"{ {d: r['route'] for d, r in k1b_wide.items()} }: expected "
          f"f32_sm90 at every D")
    # K2 (split-K) at the decode shape in float32 and bf16 pages and at
    # positions up to 4096, timed with the kernel it succeeds; the chunk
    # form (S = 32); GQA; a table one split wide (no combine kernel)
    k2_main = paged_case(torch, K, 8, 16, 16, 1, 64, 16, f32, timed=True)
    k2_bf16 = paged_case(torch, K, 8, 16, 16, 1, 64, 16, bf, timed=True)
    k2_long = paged_case(torch, K, 8, 16, 16, 1, 64, 16, f32, timed=True,
                         max_pos=4096)
    k2_chunk = paged_case(torch, K, 1, 16, 16, 32, 64, 16, f32, timed=True)
    # the speculative verify (phase 9): a decode bucket at S = spec_k + 1
    k2_verify = paged_case(torch, K, 8, 16, 16, 5, 64, 16, f32, timed=True)
    for kvh in (16, 4):
        for S in (1, 32):
            for pdt in (f32, bf):
                paged_case(torch, K, 8, 16, kvh, S, 64, 16, pdt, False)
    k2_one = paged_case(torch, K, 8, 16, 16, 1, 64, 16, f32, False,
                        max_pos=48)
    check(k2_one["splits"] == 1 and k2_main["splits"] > 1
          and all(r["route"] == "f32_split"
                  for r in (k2_main, k2_long, k2_chunk, k2_one, k2_verify))
          and k2_bf16["route"] == "bf16_split",
          f"K2 routes / splits {[(r['route'], r['splits']) for r in (k2_main, k2_bf16, k2_long, k2_chunk, k2_one)]}")
    check("paged_combine_kernel" in k2_main["launch_ms"],
          f"K2 decode case launched {k2_main['launch_ms']}")
    # head dims: every instantiation the first cases left out (each
    # multiple of 16 up to 128 on the bf16 flash kernels, up to 256 on the
    # float32 flash forward's 3xTF32 route and on K2, up to 192 on the
    # float32 backward's, causal and, past 64, non-causal too) and the
    # padded route of each kernel (a D not a multiple of 16), each against
    # its plain version; then the launches by route
    K.reset_launch_counts()
    new_dims = [d for d in range(16, 257, 16) if d not in (32, 64, 128)]
    for D in new_dims:
        flash_case(torch, K, 2, 4, 77, 77, D, f32, True, 0, 77, False)
        paged_case(torch, K, 4, 8, 4, 1, D, 16, f32, False)
        if D <= 192:
            bwd_case(torch, K, 2, 4, 77, D, f32, True, False)
        if 64 < D <= 192:
            bwd_case(torch, K, 2, 4, 77, D, f32, False, False)
        if D <= 128:
            flash_case(torch, K, 2, 4, 77, 77, D, bf, True, 0, 77, False)
            bwd_case(torch, K, 2, 4, 77, D, bf, True, False)
            paged_case(torch, K, 4, 8, 4, 1, D, 16, bf, False)
    flash_case(torch, K, 2, 4, 77, 77, 40, f32, True, 0, 77, False)
    bwd_case(torch, K, 2, 4, 77, 40, f32, False, False)
    flash_case(torch, K, 4, 4, 100, 260, 40, bf, False, 0, 200, False)
    bwd_case(torch, K, 2, 4, 77, 100, bf, True, False)
    paged_case(torch, K, 4, 8, 4, 4, 40, 16, f32, False)
    hd_routes = K.launches_by_route()
    n_f32 = len(new_dims)
    n_bwd = len([d for d in new_dims if d <= 192])
    n_bf = len([d for d in new_dims if d <= 128])
    n_wide = len([d for d in new_dims if 64 < d <= 192])
    # float32: flash_case launches the forward once, bwd_case the forward
    # once and the backward twice (the rerun check), both on 3xTF32 at
    # every D; paged_case launches K2 twice (the rerun check)
    hd_want = {
        "flash_fwd": {"bf16_sm90": 2 * n_bf, "bf16_sm90_padded": 2,
                      "f32_sm90": n_f32 + n_bwd + n_wide,
                      "f32_sm90_padded": 2},
        "flash_bwd": {"bf16_sm90": 2 * n_bf, "bf16_sm90_padded": 2,
                      "f32_sm90": 2 * (n_bwd + n_wide),
                      "f32_sm90_padded": 2},
        "paged_attention": {"f32_split": 2 * n_f32, "f32_split_padded": 2,
                            "bf16_split": 2 * n_bf, "bf16_split_padded": 0,
                            "f32": 0, "f32_padded": 0, "bf16": 0,
                            "bf16_padded": 0}}
    print(f"    head dims {new_dims} (bf16 flash and K2 up to 128, float32 "
          f"forward on 3xTF32 up to 256, float32 backward on 3xTF32 up to "
          f"192), padded D = 40 / 100; launches by route "
          f"{ {n: hd_routes[n] for n in hd_want} }", flush=True)
    check(all(hd_routes[n] == r for n, r in hd_want.items()),
          f"head-dim cases launched {hd_routes}, expected {hd_want}")
    # a TransformerLM with hidden 768 and 8 heads (D = 96) at the training
    # shape, both passes, timed
    k1_d96 = flash_case(torch, K, 16, 8, 1024, 1024, 96, bf, True, 0, 1024,
                        timed=True)
    k1b_d96 = bwd_case(torch, K, 16, 8, 1024, 96, bf, True, timed=True)
    # the fused ResNet kernels: small and ragged shapes in both dtypes (K
    # ending mid-k8 / mid-k16 and N not a multiple of 4 or 8 on the ragged
    # routes: K3 at K = 63 and 6, K5's junction at K = 24 / N = 6 with h
    # into a NaN-filled buffer and at K = 255 / N = 63 at the ReLU's tie),
    # then the three timed ResNet-50 shapes at B256/224
    for dt in (f32, bf):
        k3_case(torch, K, 300, 24, 40, dt, True, True, True, False)
        k3_case(torch, K, 257, 130, 70, dt, False, False, True, False)
        k3_case(torch, K, 129, 16, 8, dt, True, False, False, False)
        k3_case(torch, K, 129, 63, 50, dt, True, True, True, False)
        k3_case(torch, K, 77, 6, 24, dt, True, True, False, False)
        k5_case(torch, K, 2, 5, 48, 24, dt, False)
        k5_case(torch, K, 2, 5, 24, 6, dt, False, nan_h=True)
        k5_case(torch, K, 3, 7, 255, 63, dt, False, tie=True)
        k4_case(torch, K, 2, 8, 16, 24, 1, dt, False)
        k4_case(torch, K, 2, 7, 32, 40, 2, dt, False)
        # K4's ragged routes at truly ragged shapes: C = 50 (float32 rows
        # of 200 bytes, bf16 of 100), 20 and 7 (bf16 rows at odd element
        # addresses), N odd, pad taps at relu(b) = 1
        k4_case(torch, K, 2, 8, 50, 50, 1, dt, False, bias=1.0)
        k4_case(torch, K, 2, 7, 20, 13, 2, dt, False)
        k4_case(torch, K, 1, 6, 7, 13, 2, dt, False, bias=1.0)
    # bf16 pad taps that would give relu(b) = 1 or 2 if the prologue came
    # after the padding, at stride 1 and 2 and with C not a multiple of 64
    k4_case(torch, K, 2, 7, 64, 64, 1, bf, False, bias=1.0)
    k4_case(torch, K, 2, 9, 64, 64, 2, bf, False, bias=1.0)
    k4_case(torch, K, 2, 9, 72, 16, 1, bf, False, bias=2.0)
    # K5 on the tensor cores: M = 147 (not a multiple of 128) without
    # statistics, the ReLU's tie (u == 0 on every other channel), and a
    # bf16 shape outside the rule (K, N not multiples of 8: bf16_ragged)
    k5_case(torch, K, 3, 7, 256, 64, bf, False, stats=False)
    k5_case(torch, K, 3, 7, 256, 64, bf, False, tie=True)
    k5_case(torch, K, 2, 5, 44, 20, bf, False)
    # K3 and K5 in float32: the 3xTF32 route (K and N multiples of 4) at M
    # = 147 without statistics, contraction and column tails (K = 20 and
    # 132, N = 36 and 68) and the ReLU's tie; the ragged route for K or N
    # not a multiple of 4; K4 in float32 on the 3xTF32 route (C a
    # multiple of 32) at pad taps where relu(b) = 1, stride 1 and 2, and on
    # the ragged route at C = 72; then the launches by route (each K3 /
    # K5 case launches the forward and the backward twice, each K4 case the
    # forward twice: the rerun check)
    K.reset_launch_counts()
    k3_case(torch, K, 147, 64, 256, f32, True, True, False, False)
    k3_case(torch, K, 200, 20, 36, f32, True, True, True, False)
    k3_case(torch, K, 257, 132, 68, f32, False, False, True, False)
    k3_case(torch, K, 257, 130, 70, f32, False, False, True, False)
    k5_case(torch, K, 3, 7, 256, 64, f32, False, stats=False)
    k5_case(torch, K, 3, 7, 256, 64, f32, False, tie=True, nan_h=True)
    k5_case(torch, K, 2, 5, 42, 20, f32, False)
    k4_case(torch, K, 2, 7, 64, 64, 1, f32, False, bias=1.0)
    k4_case(torch, K, 2, 9, 64, 64, 2, f32, False, bias=1.0)
    k4_case(torch, K, 2, 9, 72, 16, 1, f32, False, bias=2.0)
    f32_routes = K.launches_by_route()
    f32_want = {"fused_matmul_fwd": {"f32_sm90": 6, "f32": 2},
                "fused_matmul_bwd": {"f32_sm90": 6, "f32": 2},
                "fused_chain_fwd": {"f32_sm90": 4, "f32": 2},
                "fused_chain_bwd": {"f32_sm90": 4, "f32": 2},
                "fused_conv_fwd": {"f32_sm90": 4, "f32": 2}}
    print(f"    float32 K3 / K4 / K5 cases, launches by route "
          f"{ {n: f32_routes[n] for n in f32_want} }", flush=True)
    check(all(f32_routes[n] == {r: w.get(r, 0) for r in f32_routes[n]}
              for n, w in f32_want.items()),
          f"float32 K3 / K4 / K5 cases launched {f32_routes}, expected "
          f"{f32_want}")
    # every ResNet-50 B256/224 shape of K3, K4 and K5, checked and timed
    fam, recs = resnet_shapes(torch, K)
    k3_s0, k3_s3, k5_s0 = recs["s0 conv3"], recs["s3 proj"], recs["s0 junction"]
    k4_s0, k4_s1 = recs["s0 3x3"], recs["s1 3x3/2"]
    # the float32 routes at phase 8's shapes (B32): every K3, K4 and K5
    # shape on the 3xTF32 route, then forced onto the ragged route (K3 /
    # K5 / K4: csrc/fused_matmul.cu / fused_chain.cu / fused_conv.cu)
    (fam32, fam_cc), (recs32, recs_cc) = resnet_shapes_f32(torch, K)
    k3_f32, k5_f32 = recs32["s0 conv3"], recs32["s0 junction"]
    k4_f32 = recs32["s0 3x3"]
    # K4's ragged float32 route's row (taken by float32 shapes with C not
    # a multiple of 32 or N of 4) at the same shape; the plain version is
    # the same function on the same inputs
    k4_cc = dict(recs_cc["s0 3x3"], plain_ms=k4_f32["plain_ms"])
    t_rag = time.perf_counter()
    # the ragged routes at truly ragged shapes: K3 at K = 63 / N = 255
    # (B32 x 56 x 56 rows in float32, B256 in bf16) and K5's stage-0
    # junction at K = 255 / N = 63, timed with the bare products and the
    # bound; each call's peak memory beyond its outputs held to its
    # weight-sized scratch (no activation copied or padded)
    rag = {}
    for dt in (f32, bf):
        rb = RAGGED_BATCH[str(dt)]
        rag[("K3", dt)] = k3_case(torch, K, rb * 56 * 56, 63, 255, dt, True,
                                  True, True, True, mem=True)
        rag[("K5", dt)] = k5_case(torch, K, rb, 56, 255, 63, dt, True,
                                  mem=True)
        check(rag[("K3", dt)]["route"] == rag[("K5", dt)]["route"]
              == {f32: "f32", bf: "bf16_ragged"}[dt],
              f"ragged shapes off the ragged route: {rag}")
    # K4's ragged routes timed: the width-50 chain's 3x3 (C = N = 50) at
    # its step's batch in each dtype, and the bf16 stage-0 shape forced
    # onto bf16_ragged (the float32 one is resnet_shapes_f32's)
    rag4 = {}
    for dt in (f32, bf):
        B50, S50 = CHAIN_SHAPE[str(dt)]
        rag4[dt] = k4_case(torch, K, B50, S50, CHAIN_RAGGED, CHAIN_RAGGED, 1,
                           dt, True, plain=dt == bf)
    with ragged_route(torch):
        rag4["s0", bf] = k4_case(torch, K, RAGGED_BATCH[str(bf)], 56, 64, 64,
                                 1, bf, True, plain=False)
    check(rag4[f32]["route"] == "f32"
          and rag4[bf]["route"] == rag4["s0", bf]["route"] == "bf16_ragged",
          f"K4's ragged shapes off their routes: "
          f"{ {k: r['route'] for k, r in rag4.items()} }")
    # the user-visible ragged path: a width-50 bottleneck chain's training
    # step beside the width-48 one, card against CPU, in both dtypes
    t_chain = time.perf_counter()
    chain = ragged_chain(torch, K)
    print(f"    truly ragged shapes {t_chain - t_rag:.1f} s, bottleneck chain "
          f"step {time.perf_counter() - t_chain:.1f} s", flush=True)
    # the K5 bf16 stage-0 junction's limits (ms a call)
    check(k5_s0["fwd"]["ms"] <= 1.0 and k5_s0["bwd"]["ms"] <= 3.0,
          f"K5 stage-0 junction over its limits (1.0 ms forward, 3.0 ms "
          f"backward): {k5_s0['fwd']['ms']:.4f} / {k5_s0['bwd']['ms']:.4f}")
    # the 3xTF32 stage-0 limits at B32 (ms a call)
    f32_ms = {"K3 fwd": k3_f32["fwd"]["ms"], "K3 bwd": k3_f32["bwd"]["ms"],
              "K5 fwd": k5_f32["fwd"]["ms"], "K5 bwd": k5_f32["bwd"]["ms"]}
    print(f"    3xTF32 stage-0 B32 ms {f32_ms}, limits {F32_LIMITS}",
          flush=True)
    check(all(f32_ms[k] <= v for k, v in F32_LIMITS.items()),
          f"3xTF32 stage-0 B32 calls over their limits {F32_LIMITS}: "
          f"{f32_ms}")
    # the float32 flash forward and K4 on 3xTF32 against one library call
    # computing the same function, timed in this run: SDPA at phase 6's
    # shape, cuDNN's float32 conv (TF32 off) at stage 0, B32
    lib_ms = {"K1-fwd f32 (8,16,256,64)": (k1_f32["ms"], k1_f32["library_ms"]),
              "K1-bwd f32 (8,16,256,64)": (k1b_f32["ms"],
                                           k1b_f32["library_ms"]),
              "K4 f32 s0 B32": (k4_f32["ms"], k4_f32["library_ms"]),
              "K4 f32 s0 B32, ragged route": (k4_cc["ms"],
                                              k4_cc["library_ms"])}
    print(f"    3xTF32 (ms, library ms) {lib_ms}", flush=True)
    check(all(ms < lib for ms, lib in lib_ms.values()),
          f"3xTF32 flash forward, backward or K4 not faster than the "
          f"library call: {lib_ms}")
    # K2's split-K kernel against the kernel it succeeds, same call
    k2_gain = {n: r["unsplit_ms"] / r["ms"] for n, r in (
        ("decode", k2_main), ("decode bf16", k2_bf16), ("long", k2_long),
        ("chunk", k2_chunk))}
    print(f"    K2 split-K speed-up over paged_attention.cu {k2_gain}; long "
          f"context at {k2_long['hbm_share']:.1%} of its bytes bound",
          flush=True)
    check(k2_gain["decode"] >= 3.0 and k2_gain["chunk"] > 1.0,
          f"K2 split-K under 3x the unsplit kernel at decode, or slower at "
          f"the chunk: {k2_gain}")

    # -- phase 3: generate on the flagship model ---------------------------
    mark(3)
    V, L, B, TP, NEW = 32000, 12, 8, 128, 32
    t0 = time.perf_counter()
    model = TransformerLM(vocab_size=V, hidden_size=1024, num_heads=16,
                          filter_size=4096, num_layers=L, max_len=512,
                          seed=0)
    with torch.no_grad():      # serving weights are leaves
        params = bf16_params(model.params)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[3] flagship TransformerLM: {n_params / 1e6:.1f}M params, bf16 "
          f"weights, built in {time.perf_counter() - t0:.1f} s", flush=True)
    prompt = np.random.RandomState(0).randint(1, V, (B, TP)).astype(np.int32)
    model.generate(params, prompt[:, :16], 2)          # library warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(params, prompt, NEW)
    torch.cuda.synchronize()
    dt_gen = time.perf_counter() - t0
    gen_counts = K.launch_counts()
    check(tuple(out.shape) == (B, TP + NEW), f"generate shape {out.shape}")
    check(bool(((out >= 0) & (out < V)).all()), "generate: ids out of range")
    check(torch.equal(out[:, :TP].cpu(), torch.from_numpy(prompt).long()),
          "generate: prompt not preserved")
    # generate = one causal prefill (one flash launch per layer), then
    # single-token dense decode steps, which take no kernel
    gen_routes = K.launches_by_route()
    check(gen_counts["flash_fwd"] == L, f"generate launched the flash kernel "
          f"{gen_counts['flash_fwd']} times, expected {L}")
    check(only_on(gen_routes["flash_fwd"], "bf16_sm90", L),
          f"generate's flash launches by route: {gen_routes}")
    lp, _ = model.prefill(params, prompt, TP + NEW)
    CH = 32
    K.reset_launch_counts()
    lc, _ = model.prefill_chunked(params, prompt, TP + NEW, chunk=CH)
    torch.cuda.synchronize()
    chunk_counts = K.launch_counts()
    chunk_routes = K.launches_by_route()
    check(only_on(chunk_routes["flash_fwd"], "bf16_sm90", L * -(-TP // CH)),
          f"prefill_chunked's flash launches by route: {chunk_routes}")
    check(chunk_counts["flash_fwd"] == L * -(-TP // CH),
          f"prefill_chunked launched the flash kernel "
          f"{chunk_counts['flash_fwd']} times, expected {L * -(-TP // CH)}")
    check(torch.isfinite(lp.float()).all().item()
          and torch.isfinite(lc.float()).all().item(), "non-finite logits")
    diff = (lp.float() - lc.float()).abs().max().item()
    scale = lp.float().abs().max().item()
    # the two forms differ only in how the projections and the attention
    # are cut into rows; bf16 keeps 8 significant bits (2^-8 = 0.4%), so a
    # few roundings apart stay well under 1% of the largest logit
    tol = 1e-2 * max(scale, 1.0)
    print(f"    generate: {B}x{NEW} new tokens in {dt_gen:.3f} s = "
          f"{B * NEW / dt_gen:.1f} tokens/s (prefill included); launches "
          f"{gen_counts}; prefill_chunked (chunk {CH}) launches "
          f"{chunk_counts}; prefill vs prefill_chunked last logits max "
          f"|diff| {diff:.4g} (|logits| <= {scale:.3g}, tol {tol:.3g})",
          flush=True)
    check(diff <= tol, "prefill and prefill_chunked disagree")

    # -- phase 4: continuous-batching serving ------------------------------
    mark(4)
    rng = np.random.RandomState(1)
    n_req = 16
    prompts = [rng.randint(1, V, rng.randint(32, 257)).astype(np.int32)
               for _ in range(n_req)]
    budgets = [int(rng.randint(16, 65)) for _ in range(n_req)]
    reg = ModelRegistry(device=model.device)
    reg.publish(params, version="bf16", activate=True)
    t0 = time.perf_counter()
    sched = DecodeScheduler(model, max_slots=8, block_size=16,
                            max_seq_len=384, registry=reg).start()
    t_warm = time.perf_counter() - t0
    torch.cuda.synchronize()
    K.reset_launch_counts()        # after start()'s warmup dispatches
    t0 = time.perf_counter()
    futs = [sched.submit(p, n) for p, n in zip(prompts, budgets)]
    results = [f.result(600) for f in futs]
    dt_serve = time.perf_counter() - t0
    sched.shutdown()
    torch.cuda.synchronize()
    serve_counts = K.launch_counts()
    st = sched.stats()
    traces = [f.trace for f in futs]
    ttft = sorted(t["ttft_ms"] for t in traces)
    n_tok = sum(r.size for r in results)
    print(f"[4] DecodeScheduler: {n_req} requests, prompts 32-256, budgets "
          f"16-64, warmup {t_warm:.2f} s; {n_tok} tokens in {dt_serve:.3f} s"
          f" = {n_tok / dt_serve:.1f} tokens/s; TTFT ms p50 "
          f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; decode steps "
          f"{st['decode_steps']}, prefill chunks {st['prefill_chunks']}; "
          f"launches {serve_counts}", flush=True)
    check(st["kv"]["blocks_in_use"] == 0, "KV blocks leaked")
    check(sched.audit()["ok"], "KV ledger audit failed")
    check(serve_counts["paged_attention"] > 0, "serving path never "
          "launched the paged-attention kernel")
    serve_routes = K.launches_by_route()["paged_attention"]
    check(only_on(serve_routes, "f32_split", serve_counts["paged_attention"]),
          f"serving's K2 launches by route {serve_routes}, expected all on "
          f"f32_split (the pool's float32 pages)")
    margin_tol = 0.1     # bf16 logits through two paths (dense vs paged)
    compared = 0
    p4_margins = []
    for i, (p, n, r) in enumerate(zip(prompts, budgets, results)):
        check(r.size == n, f"request {i}: {r.size} of {n} tokens")
        solo, margins = solo_greedy(torch, model, params, p, n)
        p4_margins.append(margins)
        for t in range(n):
            if margins[t] < margin_tol:
                break
            check(int(r[t]) == solo[t], f"request {i} step {t}: served "
                  f"{int(r[t])}, solo {solo[t]} (margin {margins[t]:.3g})")
            compared += 1
    check(compared > 0, "no served step cleared the margin")
    # phase 20 serves these requests again through the fleet
    p4 = {"prompts": prompts, "budgets": budgets, "results": results,
          "margins": p4_margins}

    # one serving decode step at the full bucket, eager (host-paced) and
    # replayed as a CUDA graph (device time only): the gap is host overhead
    kv = PagedKVCache(model, num_blocks=8 * 24 + 1, block_size=16,
                      max_blocks_per_seq=24)
    tbl = torch.arange(1, 8 * 24 + 1, dtype=torch.int32,
                       device="cuda").reshape(8, 24)
    posv = torch.full((8,), 256, dtype=torch.int32, device="cuda")
    tok = torch.from_numpy(prompt[:, :1]).cuda()
    step = lambda i: model.decode_paged(params, tok, posv, kv.pages(), tbl)
    host = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(0)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    dev_ms = graph_ms(torch, step, 1, reps=5)
    print(f"    decode step (bucket 8, pos 256, 12 layers): eager "
          f"{statistics.median(host[2:]):.3f} ms wall, CUDA-graph replay "
          f"{dev_ms:.3f} ms device", flush=True)
    print(f"    served tokens equal solo decode on {compared} steps "
          f"(each request up to its first top-2 margin < {margin_tol})",
          flush=True)
    del sched, kv, model, params
    torch.cuda.empty_cache()

    # -- phase 5: the bf16 training recipe on the flagship ------------------
    mark(5)
    TB, TT = 16, 1024
    t0 = time.perf_counter()
    tmodel = TransformerLM(vocab_size=V, hidden_size=1024, num_heads=16,
                           filter_size=4096, num_layers=L, max_len=TT, seed=0)
    init = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    print(f"[5] training recipe, flagship at B{TB}/T{TT} (model built in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    ids = np.random.RandomState(0).randint(1, V, (TB, TT + 1))
    tx = torch.from_numpy(ids[:, :-1]).cuda()
    ty = torch.from_numpy(ids[:, 1:]).cuda()
    attn_ms = L * (k1_train["ms"] + k1b_main["ms"])
    arms = []
    for remat in (False, True):
        r = train_recipe(torch, K, tmodel, init, tx, ty, remat,
                         cost=not remat)
        r["tokens_per_s"] = TB * TT / r["step_s"]
        fwd_extra = L * k1_train["ms"] if remat else 0.0
        r["attention_share"] = (attn_ms + fwd_extra) / (r["step_s"] * 1e3)
        arms.append(r)
        print(f"    remat={remat}: losses {[round(v, 4) for v in r['losses']]}"
              f"; step {r['step_s'] * 1e3:.1f} ms (median of 5; all "
              f"{[round(t * 1e3, 1) for t in r['step_s_all']]}) = "
              f"{r['tokens_per_s']:.0f} tokens/s (smoke reading); peak "
              f"memory {r['max_mem_gb']:.2f} GiB; launches over the 5 "
              f"steps {r['launches']}; {L} x (K1-fwd "
              f"{k1_train['ms']:.3f}{' x 2' if remat else ''} + K1-bwd "
              f"{k1b_main['ms']:.3f} ms) = {r['attention_share']:.1%} of "
              f"the step", flush=True)
        if "cost" in r:
            # phase 21 (d): the cost notes of this step. The counter sees
            # the plain versions' products, so attention counts whole (4
            # and 10 B H T^2 D, forward and backward), where the analytic
            # count halves it for the causal mask
            from bigdl_tpu_torch.observability import perf
            c = r["cost"]
            art = c["artifact"]
            flops = art["analysis"]["flops"]
            model_flops = _lm_model_flops(TB, TT, 1024, 4096, L, V)
            counted = _lm_counted_flops(TB, TT, 1024, 4096, L, V)
            ratio = flops / model_flops
            mfus = c["mfu"]
            print(f"    cost notes (phase 21 (d)): {flops:.6g} FLOPs "
                  f"counted = {ratio:.4f} x the analytic model FLOPs "
                  f"{model_flops:.6g} (bench_extra.py _lm_model_flops), "
                  f"{counted} expected from the products' shapes; "
                  f"perf/mfu {[round(m, 4) for m in mfus]} (mean "
                  f"{c['mfu_mean']:.4f}) against "
                  f"{perf.peak_flops(art['device_kind']):.4g} FLOP/s; memory "
                  f"{ {k: v for k, v in art['analysis'].items() if k != 'flops'} }"
                  f"; counted call {art['compile_seconds']:.2f} s ({card})",
                  flush=True)
            check(mfus and all(0 < m <= 1 for m in mfus),
                  f"[5] perf/mfu {mfus} outside (0, 1]")
            check(0.98 <= ratio <= 1.25, f"[5] counted FLOPs {flops} are "
                  f"{ratio:.4f} x the analytic {model_flops} (band 0.98 - "
                  f"1.25)")
            # exactly the products' count: without the flash wrappers'
            # tallies it would be 12 x 14 B T^2 H short
            check(flops == counted, f"[5] counted FLOPs {flops}, the "
                  f"products' shapes give {counted}")

    # -- phase 6: the normal entry point ------------------------------------
    mark(6)
    r6 = local_optimizer_run(torch, K, tmodel, init, V)
    print(f"[6] LocalOptimizer, flagship width, B8/T256, float32 params, "
          f"SGD(0.01, momentum=0.9), 4 iterations: losses "
          f"{[round(v, 4) for v in r6['losses']]}; {r6['wall_s']:.2f} s "
          f"(first step {r6['step_s'][0] * 1e3:.0f} ms, then "
          f"{[round(t * 1e3) for t in r6['step_s'][1:]]} ms); launches "
          f"{r6['launches']}", flush=True)

    del tmodel, init
    torch.cuda.empty_cache()

    # -- phase 7: ResNet-50, card against CPU, then the bf16 recipe ----------
    mark(7)
    from bigdl_tpu_torch.models import ResNet50
    r7, truth = resnet_card_vs_cpu(torch, K, torch.float32)
    r7b, _ = resnet_card_vs_cpu(torch, K, torch.bfloat16, truth)
    RB, RS = 256, 224
    rng = np.random.RandomState(0)
    rx = torch.from_numpy(rng.randn(RB, RS, RS, 3).astype(
        np.float32)).to("cuda", torch.bfloat16)
    ry = torch.from_numpy(rng.randint(1, 1001, size=RB)).cuda()
    rn_arms = []
    for conv2 in (False, True):
        t0 = time.perf_counter()
        rmodel = ResNet50(format="NHWC", fused="pallas", fused_conv2=conv2,
                          seed=0)
        if not conv2:
            rinit = {k: v.detach().clone()
                     for k, v in rmodel.state_dict().items()}
        built = time.perf_counter() - t0
        r = resnet_recipe(torch, K, rmodel, rinit, rx, ry,
                          trace=not conv2)
        r["images_per_s"] = RB / r["step_s"]
        rn_arms.append(r)
        print(f"    ResNet-50 B{RB}/{RS} bf16 recipe, fused_conv2={conv2} "
              f"(built in {built:.1f} s): losses "
              f"{[round(v, 4) for v in r['losses']]}; step "
              f"{r['step_s'] * 1e3:.1f} ms (median of 4; all "
              f"{[round(t * 1e3, 1) for t in r['step_s_all']]}) = "
              f"{r['images_per_s']:.1f} images/s (smoke reading); peak "
              f"memory {r['max_mem_gb']:.2f} GiB; launches over the 4 steps "
              f"{r['launches']}", flush=True)
        if "trace" in r:
            tr = r["trace"]
            busy = tr["device_ms"] / (r["step_s"] * 1e3)
            print(f"    traced (torch.profiler, 2 more steps): "
                  f"{tr['device_ms']:.1f} ms of CUDA kernels a step in "
                  f"{tr['launches']:.0f} launches = {busy:.1%} of the "
                  f"untraced median step (profiled wall "
                  f"{tr['wall_ms']:.1f} ms); ms a step by family "
                  f"{tr['families']}; largest kernels (ms a step, "
                  f"launches a step): {tr['top']}", flush=True)
        del rmodel
        torch.cuda.empty_cache()

    # -- phase 8: ResNet-50 through the normal entry point --------------------
    mark(8)
    r8 = resnet_local_optimizer(
        torch, K, ResNet50(format="NHWC", fused="pallas", seed=0), rinit)
    print(f"[8] Optimizer.create (LocalOptimizer), ResNet-50, B32/224 image "
          f"Samples, float32 params, SGD(0.1, momentum=0.9), 3 iterations: "
          f"losses {[round(v, 4) for v in r8['losses']]}; {r8['wall_s']:.2f} "
          f"s (steps {[round(t * 1e3) for t in r8['step_s']]} ms); launches "
          f"{r8['launches']}", flush=True)
    tr = r8["trace"]
    print(f"    traced (torch.profiler, 2 more iterations): "
          f"{tr['device_ms']:.1f} ms of CUDA kernels a step in "
          f"{tr['launches']:.0f} launches (profiled wall {tr['wall_ms']:.1f} "
          f"ms a step); ms a step by family {tr['families']}; largest "
          f"kernels (ms a step, launches a step): {tr['top'][:10]}",
          flush=True)

    # -- phase 9: serving depth ---------------------------------------------
    mark(9)
    r9 = serving_depth(torch, K)

    # -- phase 10: the serving control plane ----------------------------------
    mark(10)
    r10 = control_plane(torch, K, card)
    # -- phase 11: beam search and the translation model ----------------------
    mark(11)
    r11 = generation_depth(torch, K, card)
    # -- phase 12: the training loop's depth ----------------------------------
    mark(12)
    r12 = loop_depth(torch, K, card)
    l12 = r12["launches"]
    # -- phase 13: the layer library and the classic image zoo ----------------
    mark(13)
    r13 = zoo(torch, K, card, r8)
    # -- phase 14: the sequence zoo -------------------------------------------
    mark(14)
    seq_zoo(torch, K, card)
    # -- phase 15: the training loop's remainder and module I/O ---------------
    mark(15)
    r15 = loop_remainder(torch, K, card)
    # -- phase 16: the image input pipeline and ResNet-50's fused arms --------
    mark(16)
    r16 = image_pipeline(torch, K, card)
    l16 = r16["launches"]
    # -- phase 17: the MoE LM, graphs, recommenders and detection -----------
    mark(17)
    r17 = moe_zoo(torch, K, card, split=split17)
    l17 = {n: sum(a["launches"][n] for a in r17["arms"])
           for n in ("flash_fwd", "flash_bwd")}
    # -- phase 18: data-parallel training across GPUs ------------------------
    mark(18)
    r18 = distributed(torch, K, card)
    l18 = r18["launches"]
    # -- phase 19: model parallelism across GPUs -----------------------------
    mark(19)
    l19 = model_parallel(torch, K, card)["launches"]
    # -- phase 20: the serving fleet across processes -------------------------
    mark(20)
    r20 = fleet(torch, K, card, p4)
    l20 = {k: sum(v[k] for v in r20["routes"].values())
           for k in ("paged_attention", "flash_fwd")}
    # -- phase 21: int8 quantization ------------------------------------------
    mark(21)
    r21 = quantized(torch, K, card)
    # -- phase 22: the model-file formats and the TF-style ops --------------
    mark(22)
    r22 = loaders(torch, K, card, p4)
    # -- phase 23: the Keras-1.2 API and converter, dlframes and util --------
    mark(23)
    l23 = keras_frames(torch, K, card)["launches"]

    def kernel_rec(name, source, replaces, rec, launches):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"],
               "library_ms": rec["library_ms"]}
        if "route" in rec:          # the wrapper's route (dtype, shape rule)
            out["dtype_route"] = rec["route"]
        if "ragged_ms" in rec:      # K4 f32: its ragged route, same call
            out["ragged_ms"] = rec["ragged_ms"]
        if "launch_ms" in rec:      # ms covers these launches (profiler)
            out["launch_ms"] = rec["launch_ms"]
        if "unsplit_ms" in rec:     # K2: the kernel it succeeds, same call
            out["unsplit_ms"] = rec["unsplit_ms"]
        return out

    def ragged_rec(name, source, replaces, fam_name, dt, route, fwd, bwd):
        """A ragged route's row: the truly ragged shape's forward timing,
        its backward's beside it, and the launches of the width-50 chain
        step on the route (forward and backward)."""
        r = rag[(fam_name, dt)]
        launches = chain[str(dt)][CHAIN_RAGGED]["routes"]
        out = kernel_rec(name, source, replaces,
                         dict(r["fwd"], max_abs_err=r["max_abs_err"],
                              route=route),
                         launches[fwd].get(route, 0)
                         + launches[bwd].get(route, 0))
        out.update(shape=r["shape"], **{f"bwd_{k}": v for k, v in
                                        r["bwd"].items()})
        return out

    for name, rec in (
            ("flash_fwd serving prefill (8x16, T=128, causal, bf16)", k1_main),
            ("flash_fwd chunk form (8x16, S=32, q_offset=96, kv_len=128)",
             k1_chunk),
            ("flash_fwd training shape (16x16, T=1024, causal, bf16)",
             k1_train),
            ("flash_fwd float32 3xTF32 route, split + attention kernel "
             "(8x16, T=256, causal)", k1_f32),
            ("flash_fwd float32 3xTF32 route (2x16, T=1024, causal)",
             k1_f32_long),
            ("flash_fwd float32 3xTF32 wide kernel, D=128 (8x16, T=256, "
             "causal)", k1_wide[128]),
            ("flash_fwd float32 3xTF32 wide kernel, D=192 (8x16, T=256, "
             "causal)", k1_wide[192]),
            ("flash_fwd float32 3xTF32 wide kernel, D=256 (8x16, T=256, "
             "causal)", k1_wide[256]),
            ("flash_fwd float32 3xTF32 wide kernel, D=128, chunk form (8x16, "
             "S=32, q_offset=96, kv_len=128)", k1_wide_chunk),
            ("flash_bwd training shape (16x16, T=1024, causal, bf16)",
             k1b_main),
            ("flash_bwd float32 3xTF32 route, dK/dV + dQ kernels (8x16, "
             "T=256, causal)", k1b_f32),
            ("flash_bwd float32 3xTF32 route (2x16, T=1024, causal)",
             k1b_f32_long),
            ("flash_bwd float32 3xTF32 wide pair, D=96 (8x8, T=256, causal)",
             k1b_wide[96]),
            ("flash_bwd float32 3xTF32 wide pair, D=128 (8x8, T=256, causal)",
             k1b_wide[128]),
            ("flash_bwd float32 3xTF32 wide pair, D=192 (8x8, T=256, causal)",
             k1b_wide[192]),
            ("flash_fwd D=96 (16x8, T=1024, causal, bf16)", k1_d96),
            ("flash_bwd D=96 (16x8, T=1024, causal, bf16)", k1b_d96),
            ("flash_fwd MoE LM shape (8x16, T=1024, causal, bf16)",
             r17["k1"]),
            ("flash_bwd MoE LM shape (8x16, T=1024, causal, bf16)",
             r17["k1b"])):
        print(f"    {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
              f"sdpa {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
              f"({rec['bound_by']})"
              + (f", host call {rec['host_ms']:.4f} ms" if "host_ms" in rec
                 else "")
              + (f" (delta op {rec['delta_ms']:.4f} ms, kernel pair "
                 f"{rec['kernels_ms']:.4f} ms)" if "delta_ms" in rec else "")
              + (f"; launches (profiler, ms a call) {rec['launch_ms']}"
                 if "launch_ms" in rec else ""))
    for name, rec in (
            ("K2 decode (8x16, S=1, f32 pages, positions 32-320)", k2_main),
            ("K2 decode (8x16, S=1, bf16 pages, positions 32-320)", k2_bf16),
            ("K2 long decode (8x16, S=1, f32 pages, positions 32-4096)",
             k2_long),
            ("K2 chunk (1x16, S=32, f32 pages, positions 32-320)",
             k2_chunk),
            ("K2 verify (8x16, S=5, f32 pages, positions 32-320)",
             k2_verify)):
        print(f"    {name}: {rec['ms']:.4f} ms in {rec['splits']} splits of "
              f"{rec['span']} keys, plain {rec['plain_ms']:.4f}, unsplit "
              f"kernel {rec['unsplit_ms']:.4f}, bound {rec['bound_ms']:.4f} "
              f"({rec['bound_by']}, {rec['hbm_share']:.1%}); launches "
              f"(profiler, ms a call) {rec['launch_ms']}")
    off, on = rn_arms[0]["launches"], rn_arms[1]["launches"]
    for name, rec in (("K3-nhwc stage-0 conv3 fwd", k3_s0["fwd"]),
                      ("K3-nhwc stage-0 conv3 bwd", k3_s0["bwd"]),
                      ("K3 stage-3 projection fwd", k3_s3["fwd"]),
                      ("K5 stage-0 junction fwd", k5_s0["fwd"]),
                      ("K5 stage-0 junction bwd", k5_s0["bwd"]),
                      ("K3 float32 stage-0 conv3 fwd (B32)", k3_f32["fwd"]),
                      ("K3 float32 stage-0 conv3 bwd (B32)", k3_f32["bwd"]),
                      ("K5 float32 stage-0 junction fwd (B32)", k5_f32["fwd"]),
                      ("K5 float32 stage-0 junction bwd (B32)", k5_f32["bwd"]),
                      ("K4 stage-0 3x3", k4_s0), ("K4 stage-1 3x3/2", k4_s1),
                      ("K4 float32 stage-0 3x3 (B32)", k4_f32),
                      ("K4 float32 stage-0 3x3 (B32), ragged route", k4_cc),
                      ("K4 float32 3x3 C = N = 50 (B32/56), ragged route",
                       dict(rag4[f32], plain_ms=float("nan"))),
                      ("K4 bf16 3x3 C = N = 50 (B64/56), ragged route",
                       rag4[bf]),
                      ("K4 bf16 stage-0 3x3 (B256), forced onto the ragged "
                       "route", dict(rag4["s0", bf], plain_ms=float("nan")))):
        print(f"    {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
              f"bare product {rec['library_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f} ({rec['bound_by']})"
              + (f"; launches (profiler, ms a call) {rec['launch_ms']}"
                 if "launch_ms" in rec else ""))
    for name, rec in r10["eval"].items():
        print(f"    {name} no-statistics forward, stage 0, B32 float32 (the "
              f"served ResNet-50's call): {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f}, bare product {rec['library_ms']:.4f}, "
              f"bound {rec['bound_ms']:.4f} ({rec['bound_by']})")
    # launches x ms of each fused family over the ResNet-50 shapes, against
    # the measured steps (K4 runs in the fused_conv2 arm only)
    step_off, step_on = (r["step_s"] * 1e3 for r in rn_arms)
    for f, rows in fam.items():
        tot = sum(n * r["ms"] for _, n, r in rows)
        lib = sum(n * r["library_ms"] for _, n, r in rows)
        bnd = sum(n * r["bound_ms"] for _, n, r in rows)
        step = step_on if f == "K4" else step_off
        print(f"    {f}: {sum(n for _, n, _ in rows)} launches a step, "
              f"sum of launches x ms {tot:.3f} ms = {tot / step:.1%} of the "
              f"{step:.1f} ms step (fused_conv2={f == 'K4'}); library "
              f"{lib:.3f} ms, bound {bnd:.3f} ms", flush=True)
    # the same for the float32 K3, K4 and K5 calls at B32 against phase 8's
    # steps (the median of the steps after the first; K4 runs only with
    # fused_conv2, which phase 8 leaves off)
    step8 = statistics.median(r8["step_s"][1:]) * 1e3
    tot32 = tot_cc = 0.0
    for f, rows in fam32.items():
        tot = sum(n * r["ms"] for _, n, r in rows)
        cc = sum(n * r["ms"] for _, n, r in fam_cc[f])
        if f != "K4":
            tot32 += tot
            tot_cc += cc
        share = ("with fused_conv2 only, not in phase 8's step" if f == "K4"
                 else f"{tot / step8:.1%} of phase 8's {step8:.1f} ms step")
        print(f"    float32 {f} (B32): {sum(n for _, n, _ in rows)} launches "
              f"a step, sum of launches x ms {tot:.3f} ms = {share} "
              f"(forced onto the ragged route {cc:.3f} ms); library "
              f"{sum(n * r['library_ms'] for _, n, r in rows):.3f} ms, bound "
              f"{sum(n * r['bound_ms'] for _, n, r in rows):.3f} ms",
              flush=True)
    print(f"    float32 K3 + K5 a B32 step: {tot32:.3f} ms = "
          f"{tot32 / step8:.1%} of phase 8's step (forced onto the ragged "
          f"route {tot_cc:.3f} ms)", flush=True)
    for (fam_name, dt), r in rag.items():
        for tag in ("fwd", "bwd"):
            t = r[tag]
            print(f"    {fam_name} {tag} ragged {r['shape']} {dt} "
                  f"({r['route']}): {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f}, bare products {t['library_ms']:.4f},"
                  f" bound {t['bound_ms']:.4f} ({t['bound_by']})",
                  flush=True)
    # the tensor-core kernels keep their accumulators in registers: ptxas
    # must report no spill (-1: no build log)
    check(all(v == 0 for v in sm90_spills.values()),
          f"spill stores (bytes) in the tensor-core libraries: {sm90_spills}")
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": [
        kernel_rec("flash_fwd", "bigdl_tpu_torch/csrc/flash_fwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_main,
                   gen_counts["flash_fwd"] + r11["beam_flash"]
                   + r15["entry_routes"]["flash_fwd"].get("bf16_sm90", 0)
                   + r17["gen_flash"] + l19["flash_fwd_bf16"]
                   + r22["flash_fwd"]),
        kernel_rec("flash_fwd_chunk",
                   "bigdl_tpu_torch/csrc/flash_fwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_chunk,
                   chunk_counts["flash_fwd"] + l20["flash_fwd"]
                   + r22["serve_flash"]),
        kernel_rec("flash_fwd_train",
                   "bigdl_tpu_torch/csrc/flash_fwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_train,
                   arms[0]["launches"]["flash_fwd"]),
        kernel_rec("flash_bwd", "bigdl_tpu_torch/csrc/flash_bwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:263", k1b_main,
                   arms[0]["launches"]["flash_bwd"]
                   + r15["entry_routes"]["flash_bwd"].get("bf16_sm90", 0)
                   + l19["flash_bwd_bf16"]),
        kernel_rec("flash_fwd_moe",
                   "bigdl_tpu_torch/csrc/flash_fwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", r17["k1"],
                   l17["flash_fwd"]),
        kernel_rec("flash_bwd_moe", "bigdl_tpu_torch/csrc/flash_bwd_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:263", r17["k1b"],
                   l17["flash_bwd"]),
        kernel_rec("flash_fwd_f32",
                   "bigdl_tpu_torch/csrc/flash_fwd_tf32_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_f32,
                   r6["routes"]["flash_fwd"]["f32_sm90"] + r15["k1"]
                   + l18["flash_fwd"] + l19["flash_fwd_f32"]
                   + r15["entry_routes"]["flash_fwd"].get("f32_sm90", 0)),
        kernel_rec("flash_fwd_f32_wide",
                   "bigdl_tpu_torch/csrc/flash_fwd_tf32_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:128", k1_f32_wide,
                   k1_lm["routes"]["f32_sm90"]
                   + k1_step["routes"]["flash_fwd"]["f32_sm90"]),
        kernel_rec("flash_bwd_f32",
                   "bigdl_tpu_torch/csrc/flash_bwd_tf32_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:263", k1b_f32,
                   r6["routes"]["flash_bwd"]["f32_sm90"] + r15["k1b"]
                   + l18["flash_bwd"] + l19["flash_bwd_f32"]
                   + r15["entry_routes"]["flash_bwd"].get("f32_sm90", 0)),
        kernel_rec("flash_bwd_f32_wide",
                   "bigdl_tpu_torch/csrc/flash_bwd_tf32_sm90.cu",
                   "bigdl_tpu/kernels/flash_attention.py:263", k1b_wide[128],
                   k1_step["routes"]["flash_bwd"]["f32_sm90"]),
        kernel_rec("paged_attention",
                   "bigdl_tpu_torch/csrc/paged_attention_sm90.cu",
                   "bigdl_tpu/kernels/paged_attention.py:107", k2_main,
                   serve_routes["f32_split"] + l19["paged_attention"]
                   + l20["paged_attention"] + r21["paged"]
                   + r22["paged_attention"]),
        kernel_rec("paged_attention_long",
                   "bigdl_tpu_torch/csrc/paged_attention_sm90.cu",
                   "bigdl_tpu/kernels/paged_attention.py:107", k2_long,
                   serve_routes["f32_split"]),
        kernel_rec("paged_attention_verify",
                   "bigdl_tpu_torch/csrc/paged_attention_sm90.cu",
                   "bigdl_tpu/kernels/paged_attention.py:107", k2_verify,
                   r9["verify_k2"]),
        kernel_rec("paged_attention_unsplit",
                   "bigdl_tpu_torch/csrc/paged_attention.cu",
                   "bigdl_tpu/kernels/paged_attention.py:107",
                   {"max_abs_err": k2_main["unsplit_err"], "route": "f32",
                    "ms": k2_main["unsplit_ms"],
                    "plain_ms": k2_main["plain_ms"],
                    "bound_ms": k2_main["bound_ms"],
                    "bound_by": k2_main["bound_by"], "library_ms": None},
                   serve_routes["f32"]),
        kernel_rec("fused_matmul_nhwc",
                   "bigdl_tpu_torch/csrc/fused_matmul_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:688",
                   dict(k3_s0["fwd"], max_abs_err=k3_s0["max_abs_err"],
                        route=k3_s0["route"]),
                   off["fused_matmul_fwd"] + l16["bf16"]["fused_matmul_fwd"]),
        kernel_rec("fused_matmul", "bigdl_tpu_torch/csrc/fused_matmul_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:344",
                   dict(k3_s3["fwd"], max_abs_err=k3_s3["max_abs_err"],
                        route=k3_s3["route"]),
                   off["fused_matmul_fwd"] + l16["bf16"]["fused_matmul_fwd"]),
        kernel_rec("fused_matmul_bwd",
                   "bigdl_tpu_torch/csrc/fused_matmul_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:580",
                   dict(k3_s0["bwd"], max_abs_err=k3_s0["max_abs_err"],
                        route=k3_s0["route"]),
                   off["fused_matmul_bwd"] + l16["bf16"]["fused_matmul_bwd"]),
        kernel_rec("fused_matmul_f32",
                   "bigdl_tpu_torch/csrc/fused_matmul_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:344",
                   dict(k3_f32["fwd"], max_abs_err=k3_f32["max_abs_err"],
                        route=k3_f32["route"]),
                   r8["routes"]["fused_matmul_fwd"]["f32_sm90"]
                   + l12["fused_matmul_fwd"] + l16["f32"]["fused_matmul_fwd"]
                   + l18["fused_matmul_fwd"] + l23["fused_matmul_fwd"]),
        kernel_rec("fused_matmul_bwd_f32",
                   "bigdl_tpu_torch/csrc/fused_matmul_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:229",
                   dict(k3_f32["bwd"], max_abs_err=k3_f32["max_abs_err"],
                        route=k3_f32["route"]),
                   r8["routes"]["fused_matmul_bwd"]["f32_sm90"]
                   + l12["fused_matmul_bwd"] + l16["f32"]["fused_matmul_bwd"]
                   + l18["fused_matmul_bwd"] + l23["fused_matmul_bwd"]),
        kernel_rec("fused_chain", "bigdl_tpu_torch/csrc/fused_chain_sm90.cu",
                   "bigdl_tpu/kernels/fused_chain.py:318",
                   dict(k5_s0["fwd"], max_abs_err=k5_s0["max_abs_err"],
                        route=k5_s0["route"]),
                   off["fused_chain_fwd"] + l16["bf16"]["fused_chain_fwd"]),
        kernel_rec("fused_chain_bwd",
                   "bigdl_tpu_torch/csrc/fused_chain_sm90.cu",
                   "bigdl_tpu/kernels/fused_chain.py:214",
                   dict(k5_s0["bwd"], max_abs_err=k5_s0["max_abs_err"],
                        route=k5_s0["route"]),
                   off["fused_chain_bwd"] + l16["bf16"]["fused_chain_bwd"]),
        kernel_rec("fused_chain_f32",
                   "bigdl_tpu_torch/csrc/fused_chain_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_chain.py:318",
                   dict(k5_f32["fwd"], max_abs_err=k5_f32["max_abs_err"],
                        route=k5_f32["route"]),
                   r8["routes"]["fused_chain_fwd"]["f32_sm90"]
                   + l12["fused_chain_fwd"] + l16["f32"]["fused_chain_fwd"]
                   + l18["fused_chain_fwd"] + l23["fused_chain_fwd"]),
        kernel_rec("fused_chain_bwd_f32",
                   "bigdl_tpu_torch/csrc/fused_chain_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_chain.py:214",
                   dict(k5_f32["bwd"], max_abs_err=k5_f32["max_abs_err"],
                        route=k5_f32["route"]),
                   r8["routes"]["fused_chain_bwd"]["f32_sm90"]
                   + l12["fused_chain_bwd"] + l16["f32"]["fused_chain_bwd"]
                   + l18["fused_chain_bwd"] + l23["fused_chain_bwd"]),
        kernel_rec("fused_conv", "bigdl_tpu_torch/csrc/fused_conv_sm90.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188", k4_s0,
                   on["fused_conv_fwd"]),
        kernel_rec("fused_conv_s2", "bigdl_tpu_torch/csrc/fused_conv_sm90.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188", k4_s1,
                   on["fused_conv_fwd"]),
        kernel_rec("fused_conv_f32",
                   "bigdl_tpu_torch/csrc/fused_conv_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188",
                   dict(k4_f32, ragged_ms=k4_cc["ms"]),
                   r7["fused_routes"]["fused_conv_fwd"]["f32_sm90"]
                   + l12["fused_conv_fwd"] + l18["fused_conv_fwd"]
                   + l23["fused_conv_fwd"]),
        kernel_rec("fused_conv_f32_ragged",
                   "bigdl_tpu_torch/csrc/fused_conv.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188", k4_cc,
                   r7["fused_routes"]["fused_conv_fwd"]["f32"]
                   + chain[str(f32)][CHAIN_RAGGED]["routes"][
                       "fused_conv_fwd"].get("f32", 0)),
        kernel_rec("fused_conv_bf16_ragged",
                   "bigdl_tpu_torch/csrc/fused_conv.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188", rag4[bf],
                   chain[str(bf)][CHAIN_RAGGED]["routes"][
                       "fused_conv_fwd"].get("bf16_ragged", 0)),
        ragged_rec("fused_matmul_f32_ragged",
                   "bigdl_tpu_torch/csrc/fused_matmul.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:344", "K3", f32, "f32",
                   "fused_matmul_fwd", "fused_matmul_bwd"),
        ragged_rec("fused_chain_f32_ragged",
                   "bigdl_tpu_torch/csrc/fused_chain.cu",
                   "bigdl_tpu/kernels/fused_chain.py:318", "K5", f32, "f32",
                   "fused_chain_fwd", "fused_chain_bwd"),
        ragged_rec("fused_matmul_bf16_ragged",
                   "bigdl_tpu_torch/csrc/fused_matmul.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:344", "K3", bf,
                   "bf16_ragged", "fused_matmul_fwd", "fused_matmul_bwd"),
        ragged_rec("fused_chain_bf16_ragged",
                   "bigdl_tpu_torch/csrc/fused_chain.cu",
                   "bigdl_tpu/kernels/fused_chain.py:318", "K5", bf,
                   "bf16_ragged", "fused_chain_fwd", "fused_chain_bwd"),
        kernel_rec("fused_matmul_eval",
                   "bigdl_tpu_torch/csrc/fused_matmul_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_matmul.py:688", r10["eval"]["K3"],
                   r10["d"]["launches"]["fused_matmul_fwd"]
                   + r15["predict_class"]["fused_matmul_fwd"]
                   + l16["eval"]["fused_matmul_fwd"]
                   + l23["fused_matmul_fwd_eval"]),
        kernel_rec("fused_conv_eval",
                   "bigdl_tpu_torch/csrc/fused_conv_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_conv.py:188", r10["eval"]["K4"],
                   r10["d"]["launches"]["fused_conv_fwd"]
                   + r15["predict_class"]["fused_conv_fwd"]
                   + l16["eval"]["fused_conv_fwd"]
                   + l23["fused_conv_fwd_eval"]),
        kernel_rec("fused_chain_eval",
                   "bigdl_tpu_torch/csrc/fused_chain_tf32_sm90.cu",
                   "bigdl_tpu/kernels/fused_chain.py:318", r10["eval"]["K5"],
                   r10["d"]["launches"]["fused_chain_fwd"]
                   + r15["predict_class"]["fused_chain_fwd"]
                   + l16["eval"]["fused_chain_fwd"]
                   + l23["fused_chain_fwd_eval"]),
        # no Pallas twin: the JAX package's int8 contraction is XLA's
        dict(kernel_rec("int8_gemm", "bigdl_tpu_torch/csrc/int8_gemm_sm90.cu",
                        "bigdl_tpu/quantization/quantize.py:89", r21["row"],
                        r21["launches"]),
             bf16_ms=r21["row"]["bf16_ms"], fused_ms=r21["row"]["fused_ms"],
             routes=r21["routes"], model_sum=r21["model_sum"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--phase18-rank":
        # one of phase 18 (c)'s gloo ranks, started by the phase itself
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        phase18_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                     sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--phase19-rank":
        # one of phase 19's gloo ranks, started by the phase itself
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        phase19_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                     sys.argv[5])
    main()
