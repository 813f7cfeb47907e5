#!/usr/bin/env python3
"""Drive the PyTorch port (apex_example_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU

Phases, one or more lines each:

1. env     — the card's name and power limit (nvidia-smi, on a line of its
             own), torch and CUDA versions.
2. build   — compiles every kernel source of the port with nvcc (one
             process per source, all at once) and prints ptxas's
             register/spill report.
3. kernels — each kernel against its plain PyTorch version on the card.
             LayerNorm forward at the serving shape (slots * block_size
             rows x 768) and the three training paths' shapes (bert 4096
             x 768, transformer_xl 6144 x 410, gpt 8192 x 768), each in
             fp32 and bf16, at a ragged row count, at H = 64, at an odd H,
             at H = 1022 (pairs, a warp a row) and 1026 (pairs, a block a
             row) and at H = 8192: fp32 atol = rtol = 1e-5; bf16 one bf16
             ulp of the output plus 1e-5 (the fp32 rounding of a result that
             cancels to near zero).  LayerNorm backward at the three
             training shapes in fp32 and bf16, at 1000 rows, at 128 rows
             (the persistent grid, a warp a row), at H = 64, at an odd H and
             at H = 8192: dx as the forward's y; dgamma and dbeta rtol =
             atol = 1e-4 (sums over thousands of O(1) rows in another
             order; atol for sums that cancel near zero).  The
             multi-tensor L2 norm and LAMB stages 1 and 2 over 201 tensors
             shaped like bert_base's parameters (the stages read the
             step's lr, c1 and c2 from a row on the card and take a clear
             noop flag, as the trainer's steps do; so do Adam's checks and
             times in 7): norms rtol 1e-5; m, v, u and p atol 1e-6, rtol
             1e-5.  dgamma and the norms must repeat
             bitwise on a second call.  Then each kernel's, its plain
             version's and (where one exists) a PyTorch call's median
             device time, beside the kernel's bound; the LayerNorm kernels'
             at transformer_xl's 6144 x 410 too, the backward's also at
             few rows (128 x 768, 37 x 777, 64 x 8192).
4. main    — gpt_base at full width (random weights from seed 0) served
             through the port's run_serve on cuda: 32 requests with a
             shared prefix through 8 slots of a block-paged cache.  Every
             request must finish ok, the LayerNorm forward kernel must have
             been launched 26 times per compute tick (embeddings_ln, two per
             layer, final_ln) and the backward never, and a teacher-forced
             full forward must agree with each served greedy token of four
             requests: the token is the argmax there, or within 1e-4 of the
             top logit (fp32 sums in another order may flip a near-tie).
5. train   — bert_base at full width (random weights from seed 0) trained
             through the port's train.main on cuda: batch 32 x 128, 20
             steps of FusedLAMB (lr 1e-3, poly schedule, 5 warmup steps,
             weight decay 0.01).  Every loss must be finite, the mean loss
             of steps 16-20 below that of steps 1-5, and each step must
             launch the LayerNorm forward and backward 26 times each and
             the L2 norm and both LAMB stages once each.  Then one step of
             the same weights on one 2 x 128 batch on the card and on the
             CPU (the plain versions): loss rtol 1e-5, grad norm rtol 1e-4,
             every updated parameter atol 1e-5; the card's step must have
             launched the kernels (26, 26, 1, 1, 1) and the CPU's none.
6. profile — torch.profiler over three more bert_base steps: device time
             by kernel group and the device's idle share (informational).
7. optim   — Adam (fused_optim.cu) against its plain version over the 241
             tensors of transformer_xl's parameters (150.9 M elements) in
             fp32 and with bf16 p and g, in both adam_w_mode branches, over
             the 199 tensors of gpt_base's (109.3 M elements) in fp32, and
             over small odd lists (1 element, 65,537, mixed sizes, views
             off 16-byte alignment): p, m and v within rtol 1e-5 plus atol
             1e-6 of the tensor's largest magnitude (fp32 arithmetic up to
             fused multiply-adds); bf16 p within one bf16 ulp plus 1e-5.
             The L2 norm over the 241 tensors: rtol 1e-5.  The scale
             (multi_tensor.cu) over the same 241 tensors with a host scale,
             with the clip scale read from the device norm below and above
             max_norm, and with an inf and a nan planted: the outputs equal
             the plain version's exactly and the int32 flag is 1 exactly
             when an input is not finite.  Then each kernel's, its plain
             version's and a PyTorch call's median device time
             (torch._fused_adamw_, torch._amp_foreach_non_finite_check_and_
             unscale_, each checked against the kernel first), beside the
             kernel's bound.
8. txl     — transformer_xl at C5's published widths (vocab 267,735,
             d_model 410, 16 layers, 10 heads, d_inner 2100, mem_len 150;
             random weights from seed 0) trained through train.main on
             cuda: batch 32 x 192, 20 steps of FusedAdam (lr 2.5e-4) after
             the clip to global norm 0.25, the memory carried.  Every loss
             finite, the mean of steps 16-20 below that of steps 1-5, and
             each step launching the LayerNorm forward and backward 32
             times each, the L2 norm, the scale and Adam once each and
             LAMB never.  Then one step of the same weights on one 2 x 192
             batch on the card and on the CPU: loss rtol 1e-5, grad norm
             (before the clip) rtol 1e-4, the new memory rtol and atol
             1e-4; a ReLU input within fp32 rounding of zero passes on
             one device only and moves the grads below it by ~1e-3 of
             their norm.  The run measures that floor: the CPU's step
             against one with the embedding scaled by 1 + 1e-6.  Each kind
             of parameter's clipped grads within 3 x the floor's relative
             difference for that kind; since Adam's first step moves an
             element by about lr whatever its gradient's size, every
             parameter element within 2 lr + 1e-5, and no more than 3 x
             the floor's count of elements beyond 1e-5; the card's step
             launching the kernels (32, 32, 1, 1, 1) and the CPU's none.
9. gpt     — gpt_base trained through train.main on cuda: batch 64 x 128,
             10 steps of FusedAdam (lr 1e-4, weight decay 0.01): losses
             finite and falling, each step launching the LayerNorm forward
             and backward 26 times each, the L2 norm (the step's grad_norm)
             and Adam once each, the scale and LAMB never.
10. profile — torch.profiler over three transformer_xl steps, as in 6.
11. sgd     — momentum SGD (fused_optim.cu) against its plain version over
             the 161 tensors of resnet50's parameters (25.6 M elements) in
             fp32 and with bf16 p and g, in the plain, Nesterov, first-step
             and dampening branches, and over small odd lists and views off
             16-byte alignment: p and buf within rtol 1e-5 plus atol 1e-6
             of the tensor's largest magnitude, bf16 p within one bf16 ulp
             plus 1e-5; with the learning rate read from the card; with the
             noop flag set, p and buf bitwise unchanged.  Then its, the
             plain version's and torch._fused_sgd_'s times (that call
             checked against the kernel first), beside the bound.
12. bn      — the BatchNorm statistics and backward sums (batch_norm.cu)
             against their plain versions at resnet50's stem (3,211,264 x
             64), stage 3 (50,176 x 1024) and stage 4 (12,544 x 2048) at
             batch 256, in fp32 and bf16, at a ragged row count and an odd
             C: rtol 1e-4 plus 4e-6 of the sum of the terms' magnitudes
             (sums over many rows in another order, which may cancel to
             near zero), and bitwise equal on a second call.
             SyncBatchNorm built with fused_kernel=True against its
             composite branch at stage 3's shape, forward and backward,
             through the module (the launches of that run are the
             kernels' "syncbn" path): fp32 y and dx rtol = atol 1e-4; bf16
             y one bf16 ulp, dx two bf16 ulps of its largest magnitude
             (the composite rounds each of x's two cotangents to bf16);
             dscale, dbias as the sums; the running statistics rtol 1e-4,
             atol 1e-5.  Then each
             kernel's, its plain version's and torch.batch_norm_stats's /
             torch.batch_norm_backward_reduce's times (checked against the
             kernel first), beside the bound, and the kernel's TB/s.
13. c2      — resnet50 on ImageNet-shaped batches (224 px, 1000 classes)
             trained through train.main on cuda under amp O2 (bf16, fp32
             BatchNorm statistics and master weights): batch 256, 20 steps
             of FusedSGD (lr 0.01, momentum 0.9, weight decay 1e-4; at
             bench.py's lr 0.1 the first 20 steps' loss rises).  Losses
             finite, the mean of steps 16-20 below that of steps 1-5, each
             step launching SGD and the L2 norm once each and no other
             kernel (the identity scaler unscales nothing; BatchNorm is the
             composite form, as in the JAX ResNet).  If batch 256 runs out
             of device memory, the run says so and halves it.
14. c1      — resnet18 on CIFAR-shaped batches (32 px, 10 classes) at amp
             O0, batch 256, 10 steps, the same checks.
15. dynamic — resnet50 at O2 with --loss-scale dynamic, batch 64, 10 steps
             at lr 0.01 with FusedSGD:
             the scale, SGD and L2 norm kernels once each a step, the scale
             65536 throughout.  Then an overflow drill through the library:
             an inf planted in one grad by a hook; that step, run under
             torch.cuda.set_sync_debug_mode("error") (no host sync), must
             leave the parameters, the momentum buffers and the optimizer's
             step count bitwise unchanged and halve the scale; the next
             clean step moves them again.
16. c2 cross-check — one resnet50 O0 step on one 2-image batch on the card
             and on the CPU, limited by the floor measured in the same run,
             as in 8 (ReLU kinks again); kinds of parameter are the names
             without their block indices.  The card's step of every
             cross-check runs cuDNN's deterministic convolutions, chosen
             without timing, so that which kinks flip is the same each run.
17. profile — torch.profiler over three c2 steps, as in 6, and each
             BatchNorm input shape of a c2 step timed alone through the
             composite branch (forward and backward): the share of the
             step's device time that the composite BatchNorm takes; and
             through the fused_kernel branch, what the kernels would take
             in its place.

18. attention — the flash-attention kernels (attention.cu; run after 7,
             before 4) against their plain versions: at gpt_base's 8 x
             2048 x 12 heads x 64, causal, in fp32, bf16 and fp16; at
             bert_base's 8 x 512, bidirectional with a key bias masking a
             random suffix of each row and every key of the last row (a
             dead batch element); causal Sq 384 against Sk 1024
             (bottom-right); a ragged 1000 x 1000 with D = 16 (fp32, bf16)
             and D = 80 (bias; fp32, bf16, fp16); the same causal with D =
             24 (bf16: the tensor cores' padded depth); in fp32 the same
             causal with D = 128 (the fp32 backward's D-128 tiles) and
             with D = 64 as x[..., ::2] views of tensors twice as wide
             (with a key bias; the element loads); a non-zero lse
             cotangent in the last six.  The limits are ops/attention.py's:
             lse and fp32 O atol = rtol 2e-5, fp32 dQ, dK, dV 5e-5 (sums in
             another order); a half O 2e-2 from the reference's arithmetic,
             which rounds the normalised P; a half O against the kernels'
             own arithmetic in plain PyTorch (64-key tiles, P rounded before
             P V) and the half dQ, dK, dV against the plain backward by
             `half_result_check`: rtol 1e-2, atol 1e-3 (two ulps), at most
             1e-2 (bf16) or 8e-2 (fp16) of the elements off, each row of a
             dead batch element within 3 x the plain version's own distance
             from exact sums (the largest such floor printed).  At gpt_base's
             bf16 and fp16 shapes, the plain versions with one rounding
             point skipped (P before P V, P before dV, dS before dK and dQ)
             or moved (dS from the rounded P) must fail those limits, and so
             must the last key row of dK and the last query row of dQ of one
             (b, h) scaled by 1.05 (through either); a zeroed dead row of
             bert_base's bf16 dK is printed caught or not.  A second launch
             bitwise equal.  Then at gpt_base's shape in fp32, bf16 and
             fp16 each kernel's, the plain version's and SDPA's (forward;
             backward, which computes dQ, dK and dV in one call) device
             times beside the bound: the live flops (Sq * off + Sq (Sq + 1)
             / 2 scores a head under the causal mask; 4, 8 and 6 flops per
             score per head-dim element) over 67 TFLOP/s (fp32) or 989
             TFLOP/s (bf16 and fp16 tensor cores), or the bytes over 3.35
             TB/s, with ptxas's registers for the fp32 forward; and, from
             torch.profiler, the device kernels of SDPA's fp32 forward and
             backward at that shape, by name.
19. gpt2048 — the tentpole's entry point, bench.py's gpt row at sequence
             2048: gpt_base, batch 8 x 2048, FusedAdam (lr 1e-4, weight
             decay 0.01), 10 steps at amp O2 (bf16) and 5 at O0 (fp32):
             finite losses, the mean of the last 5 (O0: 2) steps below the
             first's, each step launching the three attention kernels 12
             times each, the LayerNorm forward and backward 26 times each,
             the L2 norm and Adam once; step time, tokens/s, peak memory.
20. route   — one fp32 step of gpt_base at 2 x 2048 through the kernels
             (fused_attention=True) and through the einsum path (False),
             both on the card: loss rtol 1e-5, each gradient within 1e-4 of
             its norm (the key biases, whose exact gradient is zero, of
             their layer's query-bias gradient).  Then six O2 steps at 8 x
             2048 through the trainer's state and step on each route: the
             median step time and peak memory of each, on one line (the
             kernels launched on the flash route only).  Then
             torch.profiler over three O2 gpt2048 steps and three O0 ones,
             as in 6, each with the attention kernels' share of the step's
             device time.

21. novograd — NovoGrad (fused_optim.cu: a per-tensor kernel for the
             second moments v and inv_denom, then the chunk kernel; run
             after 12) against its plain versions over bert_base's 201
             parameter shapes in fp32 and with bf16 p and g, on a first step
             and a later one, with grad averaging on and off, and over small
             odd lists, aligned and not: v and inv_denom rtol 1e-6, p and m
             as Adam's; a second call bitwise equal; under the noop flag p,
             m and v bitwise unchanged.  Its and the plain version's times
             beside the bound (no single PyTorch call computes it).
22. adagrad — Adagrad (fused_optim.cu) against its plain version over
             resnet50's 161 parameter shapes in fp32 and bf16, in both
             modes, with the learning rate from the card, over small odd
             lists in fp32, bf16 and fp16, aligned and not: p and h as SGD's;
             a second call bitwise equal; the noop flag; its, the plain
             version's and torch._fused_adagrad_'s times (where this torch
             takes CUDA tensors there; checked against the kernel first).
23. axpby   — a x + b y (multi_tensor.cu) against its plain version over
             bert_base's shapes in fp32, fp32 x with bf16 y and bf16 x with
             fp32 y, and over small odd lists in every pair of fp32, bf16
             and fp16, aligned and not: fp32 rtol 1e-5 plus 1e-6 of the
             largest magnitude, a half output one ulp of its dtype plus
             1e-5; a second call bitwise equal; its times.  axpby is a
             public op (the JAX package's multi_tensor_axpby): no path of
             the trainer launches it.
24. novograd path — bert_base as in 5 with FusedNovoGrad (lr NOVOGRAD_LR,
             the same poly schedule and decay), 20 steps: losses finite and
             falling, each step launching the LayerNorm kernels 26 times
             each, the L2 norm once (its per-tensor sums are the second
             moments' input and its norm the step's grad_norm) and NovoGrad
             once, LAMB never.  Then its card-vs-CPU first step at 2 x 128
             as in 5; the key projections' biases, whose exact gradient is
             zero, NovoGrad steps by up to lr in a direction of rounding
             noise, so they are held to 2 lr and their gradients, on each
             device, to 1e-3 of the query biases' (noise, not a gradient).
25. adagrad path — resnet50 as in 13 with FusedAdagrad (lr ADAGRAD_LR),
             20 steps at O2: Adagrad and the L2 norm once a step;
             `adagrad_o3`: resnet18 as in 14 at O3 (bf16 parameters beside
             fp32 BatchNorm parameters), 10 steps: Adagrad and the L2 norm
             twice a step (a table per dtype).  Then the resnet50 O0
             card-vs-CPU first step as in 16 (Adagrad's first step moves an
             element by about lr whatever its gradient's size, as Adam's).
26. drills  — the overflow drill of 15 with FusedNovoGrad, then
             FusedAdagrad, the inf planted on the optimizer's very first
             step (after a forward and backward that only warm cuDNN up):
             parameters, optimizer state and the step count bitwise
             unchanged with no host sync, the scale halved; the next clean
             step is the optimizer's first: count 1, and NovoGrad's second
             moments equal that step's squared grad norms exactly (the
             first-step branch, read from the count on the card).
27. rmsnorm — the RMSNorm forward and backward kernels (layer_norm.cu;
             run after 3, before 7) against their plain versions at the
             LayerNorm phase's path shapes (128, 4096, 8192 x 768 and
             6144 x 410) in fp32 and bf16, at 37 x 777 (the scalar path)
             and 64 x 8192 (the block layout) in both, and at 16384 x 4096
             in bf16 (LLaMA-7B's width): y, dx as LayerNorm's, rstd
             1e-5, dgamma rtol = atol 1e-4, and a second backward bitwise
             equal.  Each shape's kernel, plain and F.rms_norm times
             (forward; backward through autograd) beside the bound.  Then
             the `rmsnorm` path: FusedRMSNorm(768) and MixedFusedRMSNorm(
             768, param_dtype=bf16) forward and backward at 4096 x 768 in
             fp32 and bf16 on the card against the CPU (y and dx as above,
             dscale 1e-4, a bf16 dscale one bf16 ulp plus 1e-4), one
             forward and one backward launch each, none under no_grad;
             and at the end no RMSNorm launch on any other path.

28. c4, c5  — C4's and C5's contracts (run after 26): bert_base at amp
             O2 (bf16 over fp32 masters), batch 64 x 128, FusedLAMB as in
             5, 20 steps; transformer_xl at O2 as in 8 (32 x 192, FusedAdam
             after the clip, the memory carried), 20 steps: losses finite
             and falling, the launches a step of 5 and of 8, step time,
             tokens/s and peak memory; torch.profiler over three steps of
             each, as in 6.  Then each one's first O2 grads against its
             fp32 (O0) grads from the same weights (bert_base 2 x 128,
             transformer_xl 1 x 64), on the card and on the CPU: by kind of
             parameter the card's distance no more than twice the CPU's
             plus 1e-3 (bf16 rounds at other places on the two devices;
             BERT's key biases, whose exact gradient is zero, aside).
29. amp drills — the overflow drill of 15 with FusedLAMB on bert_base at
             O2 under dynamic scaling (batch 8, the inf in mlm_bias's grad)
             and FusedAdam on transformer_xl at O2 (batch 4, the memory
             carried, the inf in the first layer's u_bias), each after a
             clean step and on the optimizer's first step: parameters,
             moments and the step count bitwise unchanged with no host
             sync, the scale halved, 28's launches plus the unscale; the
             next clean step moves them and the count by one.
30. O3      — resnet18 as in 14 at O3 (bf16 convolutions beside fp32
             BatchNorm parameters) with FusedAdam (lr 1e-3) and FusedLAMB
             (lr 1e-2), 10 steps each: losses falling, each of the
             optimizer's kernels and the L2 norm twice a step (one launch
             per dtype table).

31. ddp     — C3 (run last): resnet50 on ImageNet shapes at amp O2 with
             FusedSGD and SyncBatchNorm (composite), global batch 256,
             through the library's data-parallel step
             (engine.make_sharded_train_step, the model's BatchNorms bound
             by convert_syncbn_model) in an NCCL group of this one
             process: first one step (at O0, batch 8) against the plain
             c2 step from the same weights with deterministic convolutions
             (loss rtol 1e-5, grad norm rtol 1e-4, parameters atol 1e-5;
             at O2 bf16 rounds the two steps' differently ordered fp32
             sums apart); then 20 steps:
             losses finite and falling, SGD and the L2 norm once a step;
             img/s, the median step time, the first step's, peak memory,
             and from torch.profiler the NCCL kernels' device time a step,
             its share of the device busy time, and the all-reduce calls'
             host time a step (at world 1 an in-place all-reduce may
             launch no kernel).
32. launch  — torchrun --standalone --nproc_per_node 1 -m
             apex_example_tpu_torch.train, the C3 command line
             (--sync_bn), 5 steps, in a process group of its own with a
             timeout: exit 0, the header naming NCCL at world 1, five step
             lines.  Its kernels launch in that process and are not
             counted in the JSON's paths.
33. ddp2    — two spawned processes on cuda:0 in a gloo group (NCCL
             refuses two ranks on one card), a join timeout: SyncBatchNorm
             in both branches at resnet50's stage-3 shape (each rank half
             of batch 256) against one process with the whole batch (y and
             dx rtol = atol 1e-4, the running statistics rtol 1e-4 atol
             1e-5, dscale and dbias summed over the ranks rtol 1e-4 plus
             1e-4 of their largest magnitude), the fused branch launching
             each BatchNorm-sum kernel once between the all-reduces and
             each rank's kernel sums held against their plain versions;
             resnet18 (CIFAR shapes, SyncBatchNorm, global batch 64) 3
             data-parallel steps with the default reduction,
             --gradient-predivide-factor 2 and --larc, the first step of
             each against one process with the whole batch (loss rtol
             1e-5, grad norm rtol 1e-4, parameters atol 1e-5 or 3 x the
             floor, that step against itself with the first parameter x
             (1 + 1e-6)), both ranks' parameters bitwise equal after each; the int8 exchange of
             resnet18's grads within world * scale / 2; DistributedFusedAdam
             over bert_base's 201 parameter shapes, 3 steps against
             FusedAdam with the mean grads in one process (rtol 1e-5 plus
             1e-6 of each tensor's largest magnitude), the first step's
             shard held against adam_update_plain, and a planted inf in
             rank 1's grad (in rank 0's shard) skipped by both ranks.

34. eval    — --eval through train.run_train on the LM archs at full width
             (run after 33): bert_base at O2 (64 x 128, FusedLAMB, 2 steps,
             2 eval batches), gpt_base at O2 at 8 x 2048 through the flash
             kernels (1 step, 1 eval batch) and transformer_xl at O2 (32 x
             192, 2 steps, 2 eval batches, the memory carried): the EVAL
             line, each training step's launches as in 28 and 19, and each
             eval batch's launches and time (CUDA-synchronised host clock):
             26, 26 + 12 flash forwards and 32 LayerNorm forwards, and no
             optimizer, scale or L2-norm launch (the "E:" paths of the
             JSON).  The timed bert_base run's first eval loss (O2, 64 x
             128, the weights after its 2 steps) against the same weights
             and batch on the CPU at O2 (plain versions): rtol 2e-2, the O2
             trails' limit.  Then bert_base's first eval batch (8 x 128) at
             O0 on the card against the CPU, the same weights from seed 0:
             loss rtol 1e-4.
35. resume  — c4 as the CLI runs it (bert_base, FusedLAMB, O2, --loss-scale
             dynamic, 64 x 128, 2 epochs of 3 steps): 4 steps without a
             break, then 2 steps with --save-every-steps 2 --checkpoint-dir
             (stopped at the next step boundary, as a killed process
             stops) and 2 with --resume, synchronous and with
             --async-checkpoint: every parameter, LAMB moment, the
             optimizer's step count, the train state's step, the scale and
             the growth counter bitwise equal to the unbroken run's (the
             kernels' reductions repeat bitwise); the checkpoint's bytes on
             disk, the time save blocks the loop, the restore's time; each
             resumed step launching c4's kernels and the unscale.  The
             checkpoints are written under build/ and removed.
36. serve_ckpt — gpt_base trained one step at O0 (8 x 128, lr 1e-2) with
             --checkpoint-dir, then served through run_serve from that
             directory, from the trained model held in memory and from the
             untrained model (seed 0): 4 greedy requests each, the first
             two token streams equal and the untrained model's other, the
             LayerNorm forward 26 times a compute tick and nothing else.

37. accum   — --grad-accum (run after 36): gpt2048's command (gpt_base O2
             8 x 2048, FusedAdam, the flash kernels) at K = 4 and at 1, 3
             steps each through the trainer: the first step's loss rtol
             1e-5, peak memory and step time of both, the launches a step
             (48 of each attention kernel, 104 + 104 LayerNorm, one each
             of Adam, the L2 norm and the scale, the /K); then the first
             step at K = 4 against its four microbatches run one by one on
             the same weights: the optimizer's input grads within 1e-6
             (relative L2, by kind of parameter) of theirs summed in fp32
             and scaled by 1/4, the loss their mean; torch.profiler over
             three K = 4 steps, as in 6.  C5's first step (transformer_xl
             O2 32 x 192) at K = 2 the same way, and its new memory their
             memories in stream order; its peak memory against K = 1's and
             the launches.
             adam_o3's command at K = 2, 10 steps: losses falling, axpby
             twice a step (the fold of the bf16 grads into fp32 sums and
             the mean), the scale once (the fp32 table's /K), Adam and the
             L2 norm twice; axpby at that path's shapes in both forms
             against its plain version.
38. remat   — C2's command at --remat none, conv and block: the first
             step of the same weights and batch with deterministic
             convolutions, conv's and block's loss rtol 1e-5, grad norm
             rtol 1e-4, every grad within 1e-4 of its tensor's largest
             magnitude and the running statistics bitwise none's; then the
             median step time and the peak memory of each.
39. s2d     — resnet50's stem at 256 x 224 x 224 x 3 in bf16 through the
             space-to-depth stem and the 7x7 convolution, one weight:
             outputs within two bf16 ulps plus 1e-4; the forward and the
             weight's backward of each timed.
40. host    — --host-pipeline on c2 and c4, 5 steps each through the
             trainer (launches): the card's first batch bitwise the
             library's on the CPU, the C++ worker's time a batch; then the
             loop's period (fetch, step, loss read) with host batches
             against batches made on the card, in blocks of 12 steps in
             turn (A, B, A, B) from one state, img/s or tokens/s, and
             whether the host holds the card back.
41. diag    — the trainer's diagnostics and resilience: (a) C2 (c2's
             command, --loss-scale dynamic) 6 steps with --tick-profile
             (every step), --trace, --profile-window 2:3,
             --numerics-check overflow, --inject-fault nan@4,
             --flight-recorder and --stall-timeout 120: one
             overflow_event, at step 4, naming modules; step 4 skipped
             (grads_finite 0) with the scale halved, steps 5-6 finite;
             no crash_dump or stall; each step's tick phases with a
             device phase above 0, summing to its wall within 1%; the
             host spans data and step in turn; the window's Chrome trace
             with the SGD kernel's 2 launches and the step's fwd_bwd,
             unscale_check and optimizer ranges, 2 each, inside its 2
             step ranges.  (b) c4 with --async-checkpoint 5 steps, then
             with --preempt-grace --inject-fault sigterm@3: exit 75, a
             preemption record (saved, checkpoint_step 3), an un-aborted
             summary; --resume runs steps 4-5: the losses and every leaf
             of the final state bitwise the unbroken run's, c4's launches
             a resumed step.  (c) C1 with --flight-recorder and
             --inject-fault crash@2: a crash_dump whose env names the card
             and whose memory is torch.cuda's, an aborted summary; a hang
             of DIAG_HANG_S at step 2 under --stall-timeout 1
             --stall-trace: one stall record naming the hang, and a trace
             from the stall to the recovery holding SGD launches.  Then
             the trainer's own loop on c2 and c4 with --numerics-check
             overflow, with --tick-profile and with neither, run in turn
             (off, numerics, tick, ..., off: 1 round of 6-step runs on
             c2, 4 rounds of 8-step runs on c4, whose LM loop the flag
             does not decompose, as in JAX), each arm's period against
             the off runs on either side (a numerics run writes an
             overflow_event for each step that overflowed and no other).
             The c2, c4, c5 and gpt2048 lines carry MFU (utils/flops,
             the card's bf16 peak).

Then one JSON line per the port's kernel table ({"kernels": [...]}) and,
last, {"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before the last line; so does a machine where torch sees no CUDA device.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 / fp16 tensor cores, dense
FP32_TOL = 1e-5
TIE_TOL = 1e-4
SLOTS, BLOCK = 8, 16
SOURCES = ["layer_norm", "multi_tensor", "fused_optim", "batch_norm",
           "attention"]
SUM_TOL = 1e-4            # dgamma, dbeta: rtol and atol
BN_SUM_ATOL = 4e-6        # BatchNorm sums: atol, of the sum of |terms|
NORM_TOL = 1e-5           # L2 norms, ||p||^2, ||u||^2, ratios: rtol
STATE_ATOL, STATE_RTOL = 1e-6, 1e-5     # m, v, u, p after a LAMB stage
FLOOR_X = 3               # TXL card-vs-CPU limits, in multiples of the floor
TRAIN_ROWS = 32 * 128     # LayerNorm rows of the train phase's steps
TXL_ROWS, TXL_H = 32 * 192, 410     # the txl phase's LayerNorm shape
GPT_ROWS = 64 * 128       # the gpt phase's LayerNorm rows (H = 768)
G2_ROWS = 8 * 2048        # the gpt2048 phase's LayerNorm rows (bf16 at O2)
TRAIN_ARGS = ["--device", "cuda", "--arch", "bert_base",
              "--batch-size", "32", "--seq-len", "128", "--epochs", "1",
              "--steps-per-epoch", "20", "--opt", "lamb", "--lr", "1e-3",
              "--warmup-steps", "5", "--lr-schedule", "poly",
              "--weight-decay", "0.01", "--seed", "0", "--print-freq", "5"]
TXL_ARGS = ["--device", "cuda", "--arch", "transformer_xl",
            "--vocab-size", "267735", "--batch-size", "32", "--seq-len",
            "192", "--epochs", "1", "--steps-per-epoch", "20", "--opt",
            "adam", "--lr", "2.5e-4", "--weight-decay", "0",
            "--max-grad-norm", "0.25", "--seed", "0", "--print-freq", "5"]
# C4's and C5's contracts (bench.py bench_c4 :192, bench_c5 :277; both at
# amp O2): bert_base MLM with FusedLAMB at 64 x 128, transformer_xl with
# FusedAdam and the clip at 32 x 192, its memory carried
C4_ARGS = TRAIN_ARGS + ["--batch-size", "64", "--opt-level", "O2"]
C5_ARGS = TXL_ARGS + ["--opt-level", "O2"]
# their overflow drills under dynamic loss scaling, at a few rows a step
C4_DYN_ARGS = C4_ARGS + ["--batch-size", "8", "--loss-scale", "dynamic"]
C5_DYN_ARGS = C5_ARGS + ["--batch-size", "4", "--loss-scale", "dynamic"]
# FusedAdam and FusedLAMB over amp O3's two dtypes (bf16 convolutions, fp32
# BatchNorm parameters): C1 at O3; LAMB's step is lr x ||p|| a tensor
GPT_ARGS = ["--device", "cuda", "--arch", "gpt_base", "--batch-size", "64",
            "--seq-len", "128", "--epochs", "1", "--steps-per-epoch", "10",
            "--opt", "adam", "--lr", "1e-4", "--weight-decay", "0.01",
            "--seed", "0", "--print-freq", "5"]
# the tentpole's entry point: bench.py's gpt row at sequence 2048
GPT2048_ARGS = ["--device", "cuda", "--arch", "gpt_base", "--opt", "adam",
                "--lr", "1e-4", "--weight-decay", "0.01", "--seq-len",
                "2048", "--batch-size", "8", "--epochs", "1", "--seed", "0",
                "--print-freq", "5"]
GPT2048_O2_ARGS = GPT2048_ARGS + ["--opt-level", "O2",
                                  "--steps-per-epoch", "10"]
GPT2048_O0_ARGS = GPT2048_ARGS + ["--opt-level", "O0",
                                  "--steps-per-epoch", "5"]
ROUTE_TOL = 1e-4          # flash vs dense step: |dgrad| / |grad|
# a gradient that is zero in exact arithmetic (BERT's key biases), held as
# rounding noise on each device: its norm against a real gradient of the
# same layer (the query bias's); ~1e-4 at bert_base's 2 x 128, fp32
NOISE_TOL = 1e-3
IMAGE_TAIL = ["--device", "cuda", "--opt", "sgd", "--momentum", "0.9",
              "--weight-decay", "1e-4", "--epochs", "1", "--seed", "0",
              "--print-freq", "5"]
# bench.py's c2 row, but at lr 0.01: at its lr 0.1, with no warmup, the
# loss of the first 20 steps rises (SGD lifts the logits of the ~230
# classes a batch holds before the features tell 1000 classes apart) and
# comes back to ln 1000 only after ~40 steps; the reference's own
# accuracy harness warms resnet50 up over 100 steps (accuracy.py:163)
C2_ARGS = ["--arch", "resnet50", "--dataset", "imagenet", "--opt-level", "O2",
           "--batch-size", "256", "--steps-per-epoch", "20",
           "--lr", "0.01"] + IMAGE_TAIL
C1_ARGS = ["--arch", "resnet18", "--dataset", "cifar10", "--opt-level", "O0",
           "--batch-size", "256", "--steps-per-epoch", "10",
           "--lr", "0.1"] + IMAGE_TAIL
DYN_ARGS = ["--arch", "resnet50", "--dataset", "imagenet", "--opt-level",
            "O2", "--loss-scale", "dynamic", "--batch-size", "64",
            "--steps-per-epoch", "10", "--lr", "0.01"] + IMAGE_TAIL
C2_CROSS_ARGS = ["--arch", "resnet50", "--dataset", "imagenet",
                 "--opt-level", "O0", "--batch-size", "2",
                 "--steps-per-epoch", "1", "--lr", "0.1"] + IMAGE_TAIL
# NovoGrad steps each tensor by about lr / sqrt(c2) in norm: its gradient
# normalised by the tensor's grad norm, and on the first step the second
# moment is ||g||^2 itself but still divided by 1 - beta2^t (c2 = 50 at
# t = 1, 3.0 at t = 20), so the step is ~0.14 lr at first and ~0.58 lr by
# step 20, after the 5 warmup steps.  bert_base's 768 x 768 weights have
# norm ~15.4 at init (std 0.02), its embeddings ~97: at TRAIN_ARGS' 1e-3
# (or 0.05) the loss stays flat for 20 steps; 0.5 moves the 768 x 768
# weights 0.5-1.9% of their norm a step
NOVOGRAD_LR = 0.5
NOVOGRAD_ARGS = TRAIN_ARGS + ["--opt", "novograd", "--lr", str(NOVOGRAD_LR)]
# Adagrad's first step moves each element by about lr (g / sqrt(g^2)):
# resnet50's convolution weights have std 0.02-0.18 (He init), so 1e-3 is a
# 0.5-5% step; torch's default 1e-2 would be up to half of a weight's size
ADAGRAD_LR = 1e-3
ADAGRAD_ARGS = C2_ARGS + ["--opt", "adagrad", "--lr", str(ADAGRAD_LR)]
ADAGRAD_O3_ARGS = C1_ARGS + ["--opt", "adagrad", "--lr", str(ADAGRAD_LR),
                             "--opt-level", "O3"]
O3_ADAM_ARGS = C1_ARGS + ["--opt", "adam", "--lr", "1e-3", "--opt-level",
                          "O3"]
O3_LAMB_ARGS = C1_ARGS + ["--opt", "lamb", "--lr", "1e-2", "--opt-level",
                          "O3"]
ADAGRAD_CROSS_ARGS = C2_CROSS_ARGS + ["--opt", "adagrad", "--lr",
                                      str(ADAGRAD_LR)]
BN_SHAPES = [(256 * 112 * 112, 64), (256 * 14 * 14, 1024),
             (256 * 7 * 7, 2048)]   # resnet50's stem, stage 3, stage 4
BN_MODULE_SHAPE = (256, 14, 14, 1024)  # stage 3's activations, NHWC
# C3 (BASELINE.json: ResNet-50 / ImageNet DDP with SyncBatchNorm): C2's
# command line with --sync_bn, global batch 256, 20 steps
DDP_ARGS = C2_ARGS + ["--sync_bn"]
# the same under torchrun, one process, 5 steps at the CLI's default batch
LAUNCH_ARGS = ["--arch", "resnet50", "--dataset", "imagenet", "--opt", "sgd",
               "--opt-level", "O2", "--sync_bn", "--steps-per-epoch", "5",
               "--print-freq", "1", "--lr", "0.01"]
LAUNCH_TIMEOUT = 300
# ddp2's trails: resnet18 on CIFAR shapes with SyncBatchNorm, global batch
# 64, 3 steps; DistributedFusedAdam's ZERO_STEPS clean steps; a rank that
# has not reported within DDP2_TIMEOUT seconds fails the phase
DDP2_IMAGE_ARGS = ["--arch", "resnet18", "--dataset", "cifar10",
                   "--opt-level", "O0", "--batch-size", "64",
                   "--steps-per-epoch", "3", "--lr", "0.01",
                   "--sync_bn"] + IMAGE_TAIL
ZERO_STEPS = 3
DDP2_TIMEOUT = 600
SERVE_ARGS = ["--device", "cuda", "--arch", "gpt_base",
              "--slots", str(SLOTS), "--max-len", "512",
              "--block-size", str(BLOCK), "--requests", "32",
              "--prompt-len", "32:192", "--shared-prefix", "32",
              "--max-new", "16:96", "--stagger", "2", "--seed", "0"]


def _bf16_tol(a, b):
    """One bf16 ulp at the larger magnitude of each pair, plus the fp32
    tolerance: near zero, (x - mean) * rstd * gamma + beta cancels and
    its fp32 rounding error (~1e-7 of the operands) exceeds the ulp."""
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()),
                        torch.full_like(a, 2.0 ** -126))
    return torch.exp2(torch.floor(torch.log2(mag)) - 7) + FP32_TOL


def _device_ms(fn, reps=200, warmup=20):
    """Median device time of one call of ``fn``: the calls are queued
    behind a spin kernel, so they run back to back and each interval
    between two events is device time, not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def _call_ms(fn, reps=200, warmup=20):
    """Median time per call as Python issues them (host overhead
    included): CUDA events around each call of an idle stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _close(got, want, rtol, atol):
    """max |got - want| and whether every element is within
    atol + rtol * |want|."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol + rtol * want.abs()).all())


def _bound(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"env: torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")


BUILD_REPORTS = {}   # source name -> ptxas's report, from phase_build


def _registers(source, mangled):
    """ptxas's register count of the first kernel of ``source`` whose
    mangled name contains ``mangled`` (None if none was built in this
    process)."""
    entry = None
    for line in BUILD_REPORTS.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None and mangled in entry:
            return int(m.group(1))
    return None


def phase_build(build):
    t0 = time.perf_counter()
    reports = build.build(SOURCES)
    BUILD_REPORTS.update(reports)
    dt = time.perf_counter() - t0
    print(f"build: {', '.join(n + '.cu' for n in SOURCES)} in {dt:.1f} s"
          + ("" if reports else " (already built)"))
    for name, text in reports.items():
        print(f"build: {name}.cu -> {build.library_path(name).name}")
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "Function" in line:
                print(f"build:   {line.strip()}")


def phase_kernels(ln):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    path_rows = SLOTS * BLOCK
    cases = [(path_rows, 768, torch.float32), (path_rows, 768, torch.bfloat16),
             (TRAIN_ROWS, 768, torch.float32),
             (TRAIN_ROWS, 768, torch.bfloat16),
             (1000, 768, torch.float32), (1000, 768, torch.bfloat16),
             (TXL_ROWS, TXL_H, torch.float32),
             (TXL_ROWS, TXL_H, torch.bfloat16),
             (GPT_ROWS, 768, torch.float32), (GPT_ROWS, 768, torch.bfloat16),
             (path_rows, 64, torch.float32), (path_rows, 64, torch.bfloat16),
             (37, 777, torch.float32), (64, 8192, torch.float32),
             (512, 1022, torch.float32), (64, 1026, torch.bfloat16)]
    path_shapes = {(path_rows, 768), (TRAIN_ROWS, 768), (TXL_ROWS, TXL_H),
                   (GPT_ROWS, 768)}
    path_err = 0.0
    for n, h, dtype in cases:
        x = (torch.randn(n, h, device=dev, generator=gen) * 2 + 0.5).to(dtype)
        g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
        b = torch.randn(h, device=dev, generator=gen) * 0.2
        got = ln.layer_norm_cuda(x, g, b)
        want = ln.layer_norm_plain(x, g, b)
        torch.cuda.synchronize()
        y, y_ref = got[0].float(), want[0].float()
        err = (y - y_ref).abs()
        if dtype == torch.float32:
            ok = bool((err <= FP32_TOL + FP32_TOL * y_ref.abs()).all())
        else:
            ok = bool((err <= _bf16_tol(y, y_ref)).all())
        stat_err = max(float((a - r).abs().max())
                       for a, r in zip(got[1:], want[1:]))
        stat_ok = all(bool((a - r).abs().le(FP32_TOL + FP32_TOL * r.abs())
                           .all()) for a, r in zip(got[1:], want[1:]))
        max_err = float(err.max())
        if not ok:
            y32 = ln.layer_norm_plain(x.float(), g, b)[0]
            bad = (err > _bf16_tol(y, y_ref)).nonzero()[:5].tolist()
            for r, c in bad:
                print(f"kernels:   row {r} col {c}: x {float(x[r, c])!r} "
                      f"kernel {float(y[r, c])!r} plain {float(y_ref[r, c])!r}"
                      f" fp32 {float(y32[r, c])!r} tol "
                      f"{float(_bf16_tol(y, y_ref)[r, c])!r}")
        print(f"kernels: layer_norm_fwd {n}x{h} {str(dtype)[6:]}: "
              f"max|dy| {max_err:.3g}  max|dmean|,|drstd| {stat_err:.3g}  "
              f"{'ok' if ok and stat_ok else 'MISMATCH'}")
        if not (ok and stat_ok):
            raise SystemExit(f"layer_norm kernel disagrees with its plain "
                             f"version at {n}x{h} {dtype}")
        if dtype == torch.float32 and (n, h) in path_shapes:
            path_err = max(path_err, max_err)

    by_shape = {}
    # the serving shape last: its times are the row's
    for n, h in ((TRAIN_ROWS, 768), (TXL_ROWS, TXL_H), (path_rows, 768)):
        x = torch.randn(n, h, device=dev, generator=gen)
        g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
        b = torch.randn(h, device=dev, generator=gen) * 0.2
        kernel = lambda: ln.layer_norm_cuda(x, g, b)           # noqa: E731
        plain = lambda: ln.layer_norm_plain(x, g, b)           # noqa: E731
        library = lambda: torch.nn.functional.layer_norm(      # noqa: E731
            x, (h,), g, b, 1e-5)
        ms = {name: _device_ms(fn) for name, fn in
              (("kernel", kernel), ("plain", plain), ("library", library))}
        call_ms = _call_ms(kernel)
        nbytes = n * h * (4 + 4) + 2 * h * 4 + 8 * n
        bound_ms, bound_by = _bound(nbytes, 8 * n * h)
        print(f"kernels: layer_norm_fwd {n}x{h} float32 device time: kernel "
              f"{ms['kernel']:.5f} ms  plain {ms['plain']:.5f} ms  "
              f"F.layer_norm {ms['library']:.5f} ms  bound {bound_ms:.6f} ms "
              f"({nbytes} bytes over 3.35 TB/s)  per call from Python "
              f"{call_ms:.5f} ms")
        by_shape[f"{n}x{h}"] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                                "bound_ms": bound_ms,
                                "library_ms": ms["library"]}
    return {"name": "layer_norm_fwd", "route": "cuda",
            "source": "apex_example_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_example_tpu/ops/layer_norm.py:66",
            "max_abs_err": path_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": ms["library"],
            "by_shape": by_shape}


def phase_ln_bwd(ln):
    """LayerNorm backward against its plain version, bitwise repeats, and
    its times at the paths' shapes and the few-rows ones."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(TRAIN_ROWS, 768, torch.float32),
             (TRAIN_ROWS, 768, torch.bfloat16),
             (TXL_ROWS, TXL_H, torch.float32),
             (TXL_ROWS, TXL_H, torch.bfloat16),
             (GPT_ROWS, 768, torch.float32), (GPT_ROWS, 768, torch.bfloat16),
             (G2_ROWS, 768, torch.bfloat16),
             (1000, 768, torch.float32), (1000, 768, torch.bfloat16),
             (SLOTS * BLOCK, 768, torch.float32),
             (SLOTS * BLOCK, 768, torch.bfloat16),
             (TRAIN_ROWS, 64, torch.float32), (37, 777, torch.float32),
             (64, 8192, torch.float32), (64, 8192, torch.bfloat16)]
    path_shapes = {(TRAIN_ROWS, 768), (TXL_ROWS, TXL_H), (GPT_ROWS, 768)}
    # the persistent grid at the paths' shapes and at few rows
    repeat = {(TRAIN_ROWS, 768, torch.float32),
              (TXL_ROWS, TXL_H, torch.float32),
              (G2_ROWS, 768, torch.bfloat16),
              (SLOTS * BLOCK, 768, torch.float32)}
    path_err = 0.0
    for n, h, dtype in cases:
        x = (torch.randn(n, h, device=dev, generator=gen) * 2 + 0.5).to(dtype)
        g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
        b = torch.randn(h, device=dev, generator=gen) * 0.2
        dy = torch.randn(n, h, device=dev, generator=gen).to(dtype)
        _, mean, rstd = ln.layer_norm_plain(x, g, b)
        dx, dg, db = ln.layer_norm_bwd_cuda(x, g, mean, rstd, dy)
        dx_p, dg_p, db_p = ln.layer_norm_bwd_plain(x, g, mean, rstd, dy)
        torch.cuda.synchronize()
        a, r = dx.float(), dx_p.float()
        dx_err = float((a - r).abs().max())
        if dtype == torch.float32:
            dx_ok = bool(((a - r).abs() <= FP32_TOL + FP32_TOL * r.abs())
                         .all())
        else:
            dx_ok = bool(((a - r).abs() <= _bf16_tol(a, r)).all())
        dg_err, dg_ok = _close(dg, dg_p, SUM_TOL, SUM_TOL)
        db_err, db_ok = _close(db, db_p, SUM_TOL, SUM_TOL)
        ok = dx_ok and dg_ok and db_ok and dx.dtype == dtype
        print(f"kernels: layer_norm_bwd {n}x{h} {str(dtype)[6:]}: max|ddx| "
              f"{dx_err:.3g}  max|ddgamma| {dg_err:.3g}  max|ddbeta| "
              f"{db_err:.3g}  {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"layer_norm backward kernel disagrees with its "
                             f"plain version at {n}x{h} {dtype}")
        if dtype == torch.float32 and (n, h) in path_shapes:
            path_err = max(path_err, dx_err, dg_err, db_err)
        if (n, h, dtype) in repeat:
            again = ln.layer_norm_bwd_cuda(x, g, mean, rstd, dy)
            same = all(torch.equal(u, w) for u, w in
                       zip(again, (dx, dg, db)))
            print(f"kernels: layer_norm_bwd {n}x{h} {str(dtype)[6:]} second "
                  f"call bitwise equal: {same}")
            if not same:
                raise SystemExit("layer_norm backward kernel does not "
                                 "repeat bitwise")

    by_shape = {}
    # few rows (a warp a row) and wide rows, then the paths' shapes; the
    # train phase's shape last: its times are the row's
    for n, h, dtype in ((SLOTS * BLOCK, 768, torch.float32),
                        (37, 777, torch.float32), (64, 8192, torch.float32),
                        (TXL_ROWS, TXL_H, torch.float32),
                        (GPT_ROWS, 768, torch.float32),
                        (G2_ROWS, 768, torch.bfloat16),
                        (TRAIN_ROWS, 768, torch.float32)):
        x = torch.randn(n, h, device=dev, generator=gen).to(dtype)
        g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
        b = torch.randn(h, device=dev, generator=gen) * 0.2
        dy = torch.randn(n, h, device=dev, generator=gen).to(dtype)
        _, mean, rstd = ln.layer_norm_plain(x, g, b)
        # the library's fused half path takes gamma and beta in x's dtype,
        # and its stats as its own forward leaves them
        gl, bl = g.to(dtype), b.to(dtype)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], gl, bl,
                                                           1e-5)
        kernel = lambda: ln.layer_norm_bwd_cuda(x, g, mean, rstd, dy)  # noqa
        plain = lambda: ln.layer_norm_bwd_plain(x, g, mean, rstd, dy)  # noqa
        library = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa
            dy, x, [h], lmean, lrstd, gl, bl, [True, True, True])
        ms = {name: _device_ms(fn) for name, fn in
              (("kernel", kernel), ("plain", plain), ("library", library))}
        call_ms = _call_ms(kernel)
        nbytes = n * h * x.element_size() * 3 + 3 * h * 4 + 8 * n
        bound_ms, bound_by = _bound(nbytes, 15 * n * h)
        what = f"{n}x{h} {str(dtype)[6:]}"
        print(f"kernels: layer_norm_bwd {what} device time: kernel "
              f"{ms['kernel']:.5f} ms  plain {ms['plain']:.5f} ms  "
              f"native_layer_norm_backward {ms['library']:.5f} ms  bound "
              f"{bound_ms:.6f} ms ({nbytes} bytes over 3.35 TB/s, "
              f"{ms['kernel'] / bound_ms:.2f} x)  per call from Python "
              f"{call_ms:.5f} ms")
        by_shape[what] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                          "bound_ms": bound_ms,
                          "library_ms": ms["library"]}
        del x, dy
    torch.cuda.empty_cache()
    registers = _persist_registers(True)
    print(f"kernels: layer_norm_bwd ln_bwd_persist_kernel registers "
          f"(ptxas) {registers}")
    return {"name": "layer_norm_bwd", "route": "cuda",
            "source": "apex_example_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_example_tpu/ops/layer_norm.py:82",
            "kernel": PERSIST_KERNEL, "registers": registers,
            "max_abs_err": path_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": ms["library"],
            "by_shape": by_shape}


# the norm backward's kernel on the paths' shapes and every other row of
# up to 1024 elements; ln_bwd_kernel with
# ln_bwd_colsum_kernel takes wider ones
PERSIST_KERNEL = "ln_bwd_persist_kernel"
# its instances there: (dtype in the mangled name, pack width, packs a lane)
PERSIST_SHAPES = {"768 float32": ("f", 4, 6), "410 float32": ("f", 2, 8),
                  "768 bfloat16": ("13__nv_bfloat16", 8, 3)}


def _persist_registers(kmean):
    """ptxas's registers of the persistent backward at the paths' rows
    (None where this process built nothing)."""
    return {what: _registers("layer_norm", f"{PERSIST_KERNEL}I{t}Li{v}ELi"
                             f"{c}ELb{int(kmean)}EE")
            for what, (t, v, c) in PERSIST_SHAPES.items()}


RMS_CASES = ([(SLOTS * BLOCK, 768, dt) for dt in (torch.float32,
                                                 torch.bfloat16)]
             + [(TRAIN_ROWS, 768, dt) for dt in (torch.float32,
                                                 torch.bfloat16)]
             + [(TXL_ROWS, TXL_H, dt) for dt in (torch.float32,
                                                 torch.bfloat16)]
             + [(GPT_ROWS, 768, dt) for dt in (torch.float32,
                                               torch.bfloat16)]
             + [(37, 777, dt) for dt in (torch.float32, torch.bfloat16)]
             + [(64, 8192, dt) for dt in (torch.float32, torch.bfloat16)]
             + [(G2_ROWS, 768, torch.bfloat16)]
             # LLaMA-7B's hidden size: 128 MiB of x
             + [(16384, 4096, torch.bfloat16)])
RMS_PATH_SHAPES = {(SLOTS * BLOCK, 768), (TRAIN_ROWS, 768),
                   (TXL_ROWS, TXL_H), (GPT_ROWS, 768)}


def _half_close(got, want, atol):
    """max |got - want| and whether every element is within one bf16 ulp
    of the larger magnitude plus ``atol`` (for a result rounded once to
    bf16 from fp32 values that differ in their last bits)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = _bf16_tol(got, want) - FP32_TOL + atol
    return float(err.max()), bool((err <= tol).all())


def _norm_close(got, want, dtype):
    """y or dx against the plain version: fp32 rtol = atol = 1e-5, a half
    output one bf16 ulp plus 1e-5."""
    if dtype == torch.float32:
        return _close(got, want, FP32_TOL, FP32_TOL)
    return _half_close(got, want, FP32_TOL)


def phase_rms_norm(ln, normalization, counted):
    """RMSNorm's kernels against their plain versions at every shape of
    RMS_CASES (y, rstd, dx, dgamma; dgamma and dx bitwise on a second
    launch), each timed beside its bound, its plain version and
    F.rms_norm (forward; the backward through autograd); then the
    module path (``rmsnorm``): FusedRMSNorm and MixedFusedRMSNorm forward
    and backward on the card against the CPU.  Returns the two kernel rows
    and the module path's launch counts."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    fwd_err = bwd_err = 0.0
    fwd_by, bwd_by = {}, {}
    for n, h, dtype in RMS_CASES:
        x = (torch.randn(n, h, device=dev, generator=gen) * 2 + 0.5).to(dtype)
        g = torch.randn(h, device=dev, generator=gen) * 0.2 + 1
        dy = torch.randn(n, h, device=dev, generator=gen).to(dtype)
        y, rstd = ln.rms_norm_cuda(x, g)
        y_p, rstd_p = ln.rms_norm_plain(x, g)
        dx, dg = ln.rms_norm_bwd_cuda(x, g, rstd_p, dy)
        dx_p, dg_p = ln.rms_norm_bwd_plain(x, g, rstd_p, dy)
        again = ln.rms_norm_bwd_cuda(x, g, rstd_p, dy)
        torch.cuda.synchronize()
        y_err, y_ok = _norm_close(y, y_p, dtype)
        r_err, r_ok = _close(rstd, rstd_p, FP32_TOL, FP32_TOL)
        dx_err, dx_ok = _norm_close(dx, dx_p, dtype)
        dg_err, dg_ok = _close(dg, dg_p, SUM_TOL, SUM_TOL)
        same = torch.equal(again[0], dx) and torch.equal(again[1], dg)
        ok = (y_ok and r_ok and dx_ok and dg_ok and same
              and y.dtype == dx.dtype == dtype)
        what = f"{n}x{h} {str(dtype)[6:]}"
        print(f"kernels: rms_norm {what}: max|dy| {y_err:.3g}  max|drstd| "
              f"{r_err:.3g}  max|ddx| {dx_err:.3g}  max|ddgamma| "
              f"{dg_err:.3g}  second backward bitwise equal: {same}  "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"rms_norm kernels disagree with their plain "
                             f"versions at {what}")
        if dtype == torch.float32 and (n, h) in RMS_PATH_SHAPES:
            fwd_err = max(fwd_err, y_err, r_err)
            bwd_err = max(bwd_err, dx_err, dg_err)

        # yardstick only: F.rms_norm forward, its autograd backward
        xr, gr = x.detach().requires_grad_(), g.detach().requires_grad_()
        yr = torch.nn.functional.rms_norm(xr, (h,), gr, 1e-5)
        dyr = dy.to(yr.dtype)
        lib_err = float((yr.detach().float() - y_p.float()).abs().max())
        esize = x.element_size()
        for direction, kernel, plain, library, nbytes, ops, by in (
                ("fwd", lambda: ln.rms_norm_cuda(x, g),
                 lambda: ln.rms_norm_plain(x, g),
                 lambda: torch.nn.functional.rms_norm(x, (h,), g, 1e-5),
                 n * h * 2 * esize + 4 * h + 4 * n, 4 * n * h, fwd_by),
                ("bwd", lambda: ln.rms_norm_bwd_cuda(x, g, rstd_p, dy),
                 lambda: ln.rms_norm_bwd_plain(x, g, rstd_p, dy),
                 lambda: torch.autograd.grad(yr, (xr, gr), dyr,
                                             retain_graph=True),
                 n * h * 3 * esize + 4 * h + 4 * n, 8 * n * h, bwd_by)):
            ms = {name: _device_ms(fn) for name, fn in
                  (("kernel", kernel), ("plain", plain),
                   ("library", library))}
            bound_ms, bound_by = _bound(nbytes, ops)
            print(f"kernels: rms_norm_{direction} {what} device time: kernel "
                  f"{ms['kernel']:.5f} ms  plain {ms['plain']:.5f} ms  "
                  f"F.rms_norm{'' if direction == 'fwd' else ' backward'} "
                  f"{ms['library']:.5f} ms  bound {bound_ms:.6f} ms "
                  f"({nbytes} bytes over 3.35 TB/s)"
                  + (f"  (F.rms_norm's y {str(yr.dtype)[6:]}, max|d| from "
                     f"the plain y {lib_err:.3g})" if direction == "fwd"
                     else ""))
            by[what] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": ms["library"]}
        if dtype != torch.float32 and esize == 2:
            # information only: F.rms_norm takes its fused path only for a
            # weight in x's dtype, a rounded gamma (not the same inputs)
            g_half = g.to(dtype)
            half_ms = _device_ms(lambda: torch.nn.functional.rms_norm(
                x, (h,), g_half, 1e-5))
            print(f"kernels: rms_norm_fwd {what} device time: F.rms_norm "
                  f"with gamma in {str(dtype)[6:]} {half_ms:.5f} ms")
            by[what]["library_half_gamma_ms"] = half_ms
        del xr, gr, yr, dyr
    torch.cuda.empty_cache()
    head = f"{TRAIN_ROWS}x768 float32"    # the module path's shape
    rows = []
    for name, line, err, by in (("rms_norm_fwd", 278, fwd_err, fwd_by),
                                ("rms_norm_bwd", 285, bwd_err, bwd_by)):
        extra = ({} if name == "rms_norm_fwd" else
                 {"kernel": PERSIST_KERNEL,
                  "registers": _persist_registers(False)})
        rows.append({"name": name, "route": "cuda",
                     "source": "apex_example_tpu_torch/csrc/layer_norm.cu",
                     "replaces": f"apex_example_tpu/ops/layer_norm.py:{line}",
                     **extra,
                     "max_abs_err": err, "ms": by[head]["ms"],
                     "plain_ms": by[head]["plain_ms"],
                     "bound_ms": by[head]["bound_ms"],
                     "bound_by": by[head]["bound_by"],
                     "library_ms": by[head]["library_ms"], "by_shape": by})
    counts = phase_rms_module(normalization, counted)
    print(f"rmsnorm: the RMSNorm phase took {time.perf_counter() - t0:.1f} s")
    return rows, counts


def phase_rms_module(normalization, counted):
    """The ``rmsnorm`` path: FusedRMSNorm(768) and MixedFusedRMSNorm(768,
    param_dtype=bf16), scale from a seeded generator, on 4096 x 768 fp32
    and bf16 inputs, forward and backward on the card and on the CPU with
    the same parameters and inputs.  y and dx as the kernels against their
    plain versions, dscale rtol = atol 1e-4 (bf16: one bf16 ulp plus
    1e-4); each forward launches one rms_norm_fwd and nothing else, each
    backward one rms_norm_bwd, a forward under no_grad no backward."""
    gen = torch.Generator().manual_seed(3)
    fwd_only = dict.fromkeys(counted, 0)
    fwd_only["rms_norm_fwd"] = 1
    bwd_only = dict.fromkeys(counted, 0)
    bwd_only["rms_norm_bwd"] = 1

    def delta(before):
        now = _counts(counted)
        return {k: now[k] - before[k] for k in now}

    _zero_counts(counted)
    for label, cls, kw in (("FusedRMSNorm", normalization.FusedRMSNorm, {}),
                           ("MixedFusedRMSNorm",
                            normalization.MixedFusedRMSNorm,
                            {"param_dtype": torch.bfloat16})):
        for dtype in (torch.float32, torch.bfloat16):
            cpu_m = cls(768, **kw)
            with torch.no_grad():
                cpu_m.scale.copy_(torch.randn(768, generator=gen) * 0.2 + 1)
            card_m = cls(768, device="cuda", **kw)
            card_m.load_state_dict(cpu_m.state_dict())
            x = (torch.randn(TRAIN_ROWS, 768, generator=gen) * 2
                 + 0.5).to(dtype)
            dy = torch.randn(TRAIN_ROWS, 768, generator=gen).to(dtype)
            xc = x.cuda().requires_grad_()
            before = _counts(counted)
            yc = card_m(xc)
            torch.cuda.synchronize()
            fwd = delta(before)
            before = _counts(counted)
            yc.backward(dy.cuda())
            torch.cuda.synchronize()
            bwd = delta(before)
            x.requires_grad_()
            y = cpu_m(x)
            y.backward(dy)
            y_err, y_ok = _norm_close(yc.detach().cpu(), y.detach(), dtype)
            dx_err, dx_ok = _norm_close(xc.grad.cpu(), x.grad, dtype)
            got, want = card_m.scale.grad.cpu(), cpu_m.scale.grad
            if got.dtype == torch.float32:
                ds_err, ds_ok = _close(got, want, SUM_TOL, SUM_TOL)
            else:
                ds_err, ds_ok = _half_close(got, want, SUM_TOL)
            ok = (y_ok and dx_ok and ds_ok and fwd == fwd_only
                  and bwd == bwd_only and yc.dtype == y.dtype == dtype
                  and got.dtype == want.dtype == card_m.scale.dtype)
            params = ", param_dtype=bfloat16" if kw else ""
            print(f"rmsnorm: {label}(768{params}) on {TRAIN_ROWS}x768 "
                  f"{str(dtype)[6:]}, card vs CPU: "
                  f"max|dy| {y_err:.3g}  max|ddx| {dx_err:.3g}  "
                  f"max|ddscale| {ds_err:.3g} ({str(got.dtype)[6:]})  "
                  f"launches forward {fwd['rms_norm_fwd']} backward "
                  f"{bwd['rms_norm_bwd']}  {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"rmsnorm path: {label} {dtype} "
                                 f"off the CPU's, or launches off: forward "
                                 f"{fwd}, backward {bwd}")
    before = _counts(counted)
    with torch.no_grad():
        card_m(xc)
    torch.cuda.synchronize()
    served = delta(before)
    counts = _counts(counted)
    want = dict.fromkeys(counted, 0)
    want.update(rms_norm_fwd=5, rms_norm_bwd=4)
    print(f"rmsnorm: a no_grad forward launched {served['rms_norm_fwd']} "
          f"forward, {served['rms_norm_bwd']} backward (want 1, 0); the "
          f"path's launches {counts} (want {want})")
    if served != fwd_only or counts != want:
        raise SystemExit("rmsnorm path: launches off")
    return counts


def _bert_base_shapes():
    """bert_base's parameter shapes, in named_parameters order: 201
    tensors, 109,512,762 elements."""
    V, H, F, L, P = 30522, 768, 3072, 12, 512
    shapes = [(V, H), (P, H), (H,), (H,)]
    for _ in range(L):
        shapes += [(H, H), (H,)] * 4 + [(H,), (H,), (F, H), (F,), (H, F),
                                        (H,), (H,), (H,)]
    shapes += [(H, H), (H,), (H,), (H,), (V,)]
    return shapes


def phase_optim_kernels(mt, fo):
    """The L2 norm and LAMB stages over bert_base-shaped tensors against
    their plain versions, bitwise repeat of the norms, and their times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = _bert_base_shapes()
    rnd = lambda s, std: torch.randn(s, device=dev,             # noqa
                                     generator=gen) * std
    p = [rnd(s, 0.05) for s in shapes]
    g = [rnd(s, 1e-3) for s in shapes]
    m = [rnd(s, 1e-3) for s in shapes]
    v = [torch.rand(s, device=dev, generator=gen) * 1e-6 for s in shapes]
    numel = sum(t.numel() for t in p)
    print(f"kernels: optimizer lists: {len(p)} tensors, {numel} elements")
    table = mt.TensorTable([p, g, m, v])
    u = torch.empty(table.total, dtype=torch.float32, device=dev)

    # K2: the global grad norm (list 1 = g)
    norm, sq = mt.multi_tensor_l2norm_cuda(table, 1)
    norm_p, sq_p = mt.multi_tensor_l2norm_plain(g)
    norm2, sq2 = mt.multi_tensor_l2norm_cuda(table, 1)
    torch.cuda.synchronize()
    n_err, n_ok = _close(norm, norm_p, NORM_TOL, 0.0)
    s_err, s_ok = _close(sq, sq_p, NORM_TOL, 0.0)
    same = torch.equal(norm, norm2) and torch.equal(sq, sq2)
    print(f"kernels: multi_tensor_l2norm: norm {float(norm):.6f} (plain "
          f"{float(norm_p):.6f}) max|dnorm| {n_err:.3g} max|dsq| {s_err:.3g}"
          f"  second call bitwise equal: {same}  "
          f"{'ok' if n_ok and s_ok and same else 'MISMATCH'}")
    if not (n_ok and s_ok and same):
        raise SystemExit("multi_tensor_l2norm kernel disagrees with its "
                         "plain version or does not repeat")
    l2_err = max(n_err, s_err)

    # K3 on copies of m, v; the plain version with the kernel's clip scale.
    # The kernels read the step's (lr, c1, c2) from a row on the card and
    # take the noop flag (clear): the path the trainer's steps take.
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                 bias_c1=1.0 / (1 - 0.9 ** 3), bias_c2=1.0 / (1 - 0.999 ** 3))
    lr = 1e-3
    flagged = dict(scalars_t=fo.step_scalars(lr, hyper["bias_c1"],
                                             hyper["bias_c2"], dev),
                   noop_flag=torch.zeros((), dtype=torch.int32, device=dev))
    k_hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                   max_grad_norm=1.0, **flagged)
    m0 = [t.clone() for t in m]
    v0 = [t.clone() for t in v]
    sums, ratio = fo.lamb_stage1_cuda(table, u, norm, **k_hyper)
    gscale = torch.where(norm > 1.0, 1.0 / (norm + 1e-6),
                         torch.ones_like(norm))
    errs, rel, ok = [], [], True
    u_views = torch.split(u, [t.numel() for t in p])
    p_sq, u_sq = [], []
    for i in range(len(p)):
        u_p, m_p, v_p, ps, us = fo.lamb_stage1_plain(
            p[i], g[i], m0[i], v0[i], grad_scale=gscale, **hyper)
        p_sq.append(ps)
        u_sq.append(us)
        for got, want in ((m[i], m_p), (v[i], v_p),
                          (u_views[i].view_as(p[i]), u_p)):
            e, o = _close(got, want, STATE_RTOL, STATE_ATOL)
            errs.append(e)
            ok = ok and o
    p_sq, u_sq = torch.stack(p_sq), torch.stack(u_sq)
    ratio_p = fo.trust_ratio_plain(p_sq, u_sq)
    for got, want in ((sums[0], p_sq), (sums[1], u_sq), (ratio, ratio_p)):
        e, o = _close(got, want, NORM_TOL, 0.0)
        rel.append(float(((got - want).abs() / want.abs()).max()))
        ok = ok and o
    torch.cuda.synchronize()
    lamb1_err = max(errs)
    print(f"kernels: lamb_stage1 (clip scale {float(gscale):.6f}): max "
          f"|d| over m, v, u {lamb1_err:.3g}  largest relative error of "
          f"||p||^2, ||u||^2, ratio {max(rel):.3g}  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("lamb_stage1 kernel disagrees with its plain "
                         "version")

    # K4 on a copy of p
    p0 = [t.clone() for t in p]
    fo.lamb_stage2_cuda(table, u, ratio, **flagged)
    errs, ok = [], True
    for i in range(len(p)):
        want = fo.lamb_stage2_plain(p0[i], u_views[i].view_as(p0[i]),
                                    lr * ratio[i])
        e, o = _close(p[i], want, STATE_RTOL, STATE_ATOL)
        errs.append(e)
        ok = ok and o
    torch.cuda.synchronize()
    lamb2_err = max(errs)
    print(f"kernels: lamb_stage2: max|dp| {lamb2_err:.3g}  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("lamb_stage2 kernel disagrees with its plain "
                         "version")

    # the library yardstick of K4: one foreach call with the ratios as 0-d
    # device tensors, held against the kernel's result, timed on copies
    ratios = list(ratio.unbind())
    u_list = [u_views[i].view_as(p[i]) for i in range(len(p))]
    p_lib = [t.clone() for t in p0]
    torch._foreach_addcmul_(p_lib, u_list, ratios, value=-lr)
    closes = [_close(a, b, STATE_RTOL, STATE_ATOL) for a, b in zip(p_lib, p)]
    lib_err = max(e for e, _ in closes)
    lib_ok = all(o for _, o in closes)
    print(f"kernels: lamb_stage2 library call torch._foreach_addcmul_ "
          f"against the kernel: max|dp| {lib_err:.3g}  "
          f"{'ok' if lib_ok else 'MISMATCH'}")
    if not lib_ok:
        raise SystemExit("torch._foreach_addcmul_ does not compute "
                         "lamb_stage2's function")

    def plain_stage1():
        for i in range(len(p)):
            fo.lamb_stage1_plain(p[i], g[i], m[i], v[i], grad_scale=gscale,
                                 **hyper)

    def plain_stage2():
        for i in range(len(p)):
            fo.lamb_stage2_plain(p[i], u_views[i].view_as(p[i]),
                                 lr * ratio[i])

    rows = []
    # library calls' reps: a per-tensor foreach call issues 201 launches,
    # so fewer of them fit behind _device_ms's spin kernel
    spec = [
        ("multi_tensor_l2norm", "multi_tensor.cu",
         "apex_example_tpu/ops/multi_tensor.py:203", l2_err,
         lambda: mt.multi_tensor_l2norm_cuda(table, 1),
         lambda: mt.multi_tensor_l2norm_plain(g),
         lambda: torch._foreach_norm(g, 2), "torch._foreach_norm", 100,
         4 * numel, 2 * numel),
        ("lamb_stage1", "fused_optim.cu",
         "apex_example_tpu/ops/fused_optim.py:137", lamb1_err,
         lambda: fo.lamb_stage1_cuda(table, u, norm, **k_hyper),
         plain_stage1, None, None, 0, 28 * numel, 20 * numel),
        ("lamb_stage2", "fused_optim.cu",
         "apex_example_tpu/ops/fused_optim.py:219", lamb2_err,
         lambda: fo.lamb_stage2_cuda(table, u, ratio, **flagged),
         plain_stage2,
         lambda: torch._foreach_addcmul_(p_lib, u_list, ratios, value=-lr),
         "torch._foreach_addcmul_", 40, 12 * numel, 2 * numel),
    ]
    for (name, src, replaces, err, kernel, plain, library, lib_name,
         lib_reps, nbytes, ops) in spec:
        k_ms = _device_ms(kernel, reps=100, warmup=5)
        p_ms = _device_ms(plain, reps=20, warmup=2)
        call_ms = _call_ms(kernel, reps=100, warmup=5)
        bound_ms, bound_by = _bound(nbytes, ops)
        l_ms, lib_txt = None, "no single PyTorch call computes it"
        if library:
            l_ms = _device_ms(library, reps=lib_reps, warmup=5)
            lib_txt = (f"{lib_name} {l_ms:.5f} ms (per call from Python "
                       f"{_call_ms(library, reps=lib_reps, warmup=5):.5f} "
                       f"ms)")
        print(f"kernels: {name} over {len(p)} tensors device time: kernel "
              f"{k_ms:.5f} ms  plain {p_ms:.5f} ms  {lib_txt}  bound "
              f"{bound_ms:.6f} ms ({nbytes} bytes over 3.35 TB/s)  per call "
              f"from Python {call_ms:.5f} ms")
        rows.append({"name": name, "route": "cuda",
                     "source": f"apex_example_tpu_torch/csrc/{src}",
                     "replaces": replaces, "max_abs_err": err, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": l_ms})
    return rows


def _txl_shapes(V=267735, d=410, layers=16, heads=10, inner=2100):
    """transformer_xl's parameter shapes, in named_parameters order: 241
    tensors, 150,850,870 elements."""
    shapes = [(V, d)]
    for _ in range(layers):
        shapes += [(heads, d // heads)] * 2 + [(d, d)] * 5 + [
            (d,), (d,), (inner, d), (inner,), (d, inner), (d,), (d,), (d,)]
    return shapes


def _gpt_shapes(V=30522, H=768, F=3072, L=12, P=1024):
    """gpt_base's parameter shapes, in named_parameters order: 199
    tensors, 109,315,386 elements."""
    shapes = [(V,), (V, H), (P, H), (H,), (H,)]
    for _ in range(L):
        shapes += [(H, H), (H,)] * 4 + [(H,), (H,), (F, H), (F,), (H, F),
                                        (H,), (H,), (H,)]
    return shapes + [(H,), (H,)]


def _close_scaled(got, want, rtol):
    """max |got - want| and whether every element is within rtol * |want|
    plus 1e-6 of the tensor's largest |want| (the rounding of sums that
    cancel near zero)."""
    return _close(got, want, rtol, 1e-6 * float(want.abs().max()))


def _elementwise_close(got, want):
    """(max |got - want|, within the limit): fp32 rtol 1e-5 plus 1e-6 of
    the tensor's largest magnitude (fp32 arithmetic up to fused
    multiply-adds); bf16 and fp16 one ulp of the dtype plus 1e-5."""
    if got.dtype == torch.float32:
        return _close_scaled(got, want, 1e-5)
    a, c = got.float(), want.float()
    bits = 7 if got.dtype == torch.bfloat16 else 10
    mag = torch.maximum(torch.maximum(a.abs(), c.abs()),
                        torch.full_like(a, 2.0 ** -126))
    tol = torch.exp2(torch.floor(torch.log2(mag)) - bits) + FP32_TOL
    return float((a - c).abs().max()), bool(((a - c).abs() <= tol).all())


def _misaligned(t):
    """A contiguous copy of ``t`` 4 bytes past 16-byte alignment, so the
    kernels take their scalar path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view_as(t)
    view.copy_(t)
    return view


def _adam_lists(shapes, dtype, gen):
    dev = torch.device("cuda")
    rnd = lambda s, std: torch.randn(s, device=dev,            # noqa: E731
                                     generator=gen) * std
    p = [rnd(s, 0.05).to(dtype) for s in shapes]
    g = [rnd(s, 1e-4).to(dtype) for s in shapes]
    m = [rnd(s, 1e-5) for s in shapes]
    v = [torch.rand(s, device=dev, generator=gen) * 1e-8 for s in shapes]
    return p, g, m, v


def _adam_kernel_args(fo, hyper):
    """The kernel's arguments for the plain version's ``hyper``: (lr, c1,
    c2) as the step's row on the card, and a clear noop flag (the path the
    trainer's steps take)."""
    kw = dict(hyper)
    kw["scalars_t"] = fo.step_scalars(kw.pop("lr"), kw.pop("bias_c1"),
                                      kw.pop("bias_c2"), "cuda")
    kw["noop_flag"] = torch.zeros((), dtype=torch.int32, device="cuda")
    return kw


def _check_adam(fo, mt, lists, hyper, what):
    """Adam's kernel over ``lists`` against its plain version; returns the
    largest |dp|, |dm|, |dv|."""
    p, g, m, v = lists
    p0, m0, v0 = ([t.clone() for t in lst] for lst in (p, m, v))
    fo.adam_cuda(mt.TensorTable([p, g, m, v]),
                 **_adam_kernel_args(fo, hyper))
    errs, ok = [0.0, 0.0, 0.0], True
    for i in range(len(p)):
        want = fo.adam_update_plain(p0[i], g[i], m0[i], v0[i], **hyper)
        for j, (got, w) in enumerate(zip((p[i], m[i], v[i]), want)):
            e, o = _elementwise_close(got, w)
            errs[j] = max(errs[j], e)
            ok = ok and o
    torch.cuda.synchronize()
    print(f"kernels: adam {what}: max|dp| {errs[0]:.3g}  max|dm| "
          f"{errs[1]:.3g}  max|dv| {errs[2]:.3g}  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(f"adam kernel disagrees with its plain version "
                         f"({what})")
    return max(errs)


def phase_adam(mt, fo):
    """Adam over transformer_xl-shaped tensors and small odd lists against
    its plain version; its, the plain version's and torch._fused_adamw_'s
    times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = _txl_shapes()
    numel = sum(math.prod(s) for s in shapes)
    print(f"kernels: transformer_xl parameter lists: {len(shapes)} tensors, "
          f"{numel} elements")
    step = 5
    hyper = dict(lr=2.5e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, bias_c1=1.0 / (1 - 0.9 ** step),
                 bias_c2=1.0 / (1 - 0.999 ** step))
    path_err = _check_adam(fo, mt, _adam_lists(shapes, torch.float32, gen),
                           dict(hyper, adam_w_mode=True),
                           f"adamw fp32, {len(shapes)} tensors")
    _check_adam(fo, mt, _adam_lists(shapes, torch.float32, gen),
                dict(hyper, adam_w_mode=False),
                f"adam fp32, {len(shapes)} tensors")
    _check_adam(fo, mt, _adam_lists(shapes, torch.bfloat16, gen),
                dict(hyper, adam_w_mode=True),
                f"adamw bf16 p and g, {len(shapes)} tensors")
    gpt = _gpt_shapes()         # the gpt phase's lr and decay
    path_err = max(path_err, _check_adam(
        fo, mt, _adam_lists(gpt, torch.float32, gen),
        dict(hyper, lr=1e-4, adam_w_mode=True),
        f"adamw fp32, gpt_base's {len(gpt)} tensors "
        f"({sum(math.prod(s) for s in gpt)} elements)"))
    odd = [(1,), (65537,), (3, 5), (7,), (65536,), (513, 129), (2,)]
    for dtype in (torch.float32, torch.bfloat16):
        for mode in (True, False):
            lists = _adam_lists(odd, dtype, gen)
            _check_adam(fo, mt, lists, dict(hyper, adam_w_mode=mode),
                        f"small odd list {str(dtype)[6:]} "
                        f"adam_w_mode={mode}")
            lists = [[_misaligned(t) for t in lst] for lst in
                     _adam_lists(odd, dtype, gen)]
            _check_adam(fo, mt, lists, dict(hyper, adam_w_mode=mode),
                        f"misaligned odd list {str(dtype)[6:]} "
                        f"adam_w_mode={mode}")

    # the timed lists, and torch._fused_adamw_ on copies of them
    p, g, m, v = _adam_lists(shapes, torch.float32, gen)
    lib = [[t.clone() for t in lst] for lst in (p, g, m, v)]
    table = mt.TensorTable([p, g, m, v])
    hw = dict(hyper, adam_w_mode=True)
    kw = _adam_kernel_args(fo, hw)
    steps = [torch.full((), float(step), device=dev) for _ in p]

    def library():
        torch._fused_adamw_(*lib, [], steps, lr=hyper["lr"],
                            beta1=hyper["beta1"], beta2=hyper["beta2"],
                            weight_decay=hyper["weight_decay"],
                            eps=hyper["eps"], amsgrad=False,
                            maximize=False)

    fo.adam_cuda(table, **kw)
    library()
    torch.cuda.synchronize()
    errs = [max(_close_scaled(a, b, 1e-4)[0] for a, b in zip(x, y))
            for x, y in ((lib[0], p), (lib[2], m), (lib[3], v))]
    lib_ok = all(_close_scaled(a, b, 1e-4)[1]
                 for x, y in ((lib[0], p), (lib[2], m), (lib[3], v))
                 for a, b in zip(x, y))
    print(f"kernels: adam library call torch._fused_adamw_ against the "
          f"kernel after one step: max|dp| {errs[0]:.3g}  max|dm| "
          f"{errs[1]:.3g}  max|dv| {errs[2]:.3g} (rtol 1e-4)  "
          f"{'ok' if lib_ok else 'MISMATCH'}")
    if not lib_ok:
        raise SystemExit("torch._fused_adamw_ does not compute adam's "
                         "function")

    def plain():
        for i in range(len(p)):
            fo.adam_update_plain(p[i], g[i], m[i], v[i], **hw)

    k_ms = _device_ms(lambda: fo.adam_cuda(table, **kw), reps=100, warmup=5)
    p_ms = _device_ms(plain, reps=10, warmup=2)
    l_ms = _device_ms(library, reps=100, warmup=5)
    call_ms = _call_ms(lambda: fo.adam_cuda(table, **kw), reps=100,
                       warmup=5)
    nbytes = 28 * numel
    bound_ms, bound_by = _bound(nbytes, 15 * numel)
    print(f"kernels: adam over {len(p)} tensors device time: kernel "
          f"{k_ms:.5f} ms  plain {p_ms:.5f} ms  torch._fused_adamw_ "
          f"{l_ms:.5f} ms  bound {bound_ms:.6f} ms ({nbytes} bytes over "
          f"3.35 TB/s)  per call from Python {call_ms:.5f} ms")
    return {"name": "adam", "route": "cuda",
            "source": "apex_example_tpu_torch/csrc/fused_optim.cu",
            "replaces": "apex_example_tpu/ops/fused_optim.py:53",
            "max_abs_err": path_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": l_ms}


def _same(got, want):
    """Elementwise equality, NaN equal to NaN."""
    return bool(((got == want) | (got.isnan() & want.isnan())).all())


def _finite_err(got, want):
    """max |got - want| over the elements finite in both."""
    both = got.isfinite() & want.isfinite()
    if not both.any():
        return 0.0
    return float((got[both].double() - want[both].double()).abs().max())


def phase_scale(mt):
    """The L2 norm of transformer_xl-shaped grads against its plain
    version; the scale over them against its plain version: a host scale,
    the clip scale from the device norm below and above max_norm, an inf
    and a nan planted; then its, the plain version's and
    torch._amp_foreach_non_finite_check_and_unscale_'s times.  Returns the
    scale's row and the L2 norm's largest error."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    shapes = _txl_shapes()
    numel = sum(math.prod(s) for s in shapes)
    x = [torch.randn(s, device=dev, generator=gen) * 1e-3 for s in shapes]
    out = [torch.empty_like(t) for t in x]
    norm, sq = mt.multi_tensor_l2norm_cuda(mt.TensorTable([x]))
    norm_p, sq_p = mt.multi_tensor_l2norm_plain(x)
    torch.cuda.synchronize()
    n_err, n_ok = _close(norm, norm_p, NORM_TOL, 0.0)
    s_err, s_ok = _close(sq, sq_p, NORM_TOL, 0.0)
    print(f"kernels: multi_tensor_l2norm over {len(x)} tensors: norm "
          f"{float(norm):.6f} (plain {float(norm_p):.6f}) max|dnorm| "
          f"{n_err:.3g} max|dsq| {s_err:.3g} (rtol {NORM_TOL:g})  "
          f"{'ok' if n_ok and s_ok else 'MISMATCH'}")
    if not (n_ok and s_ok):
        raise SystemExit("multi_tensor_l2norm kernel disagrees with its "
                         "plain version over transformer_xl's tensors")
    scale_err = 0.0
    cases = [("host scale 0.37", None, dict(scale=0.37)),
             ("clip above max_norm", None,
              dict(norm=norm, max_norm=0.25 * float(norm))),
             ("clip below max_norm", None,
              dict(norm=norm, max_norm=4.0 * float(norm))),
             ("inf planted", float("inf"), dict(scale=0.37)),
             ("nan planted", float("nan"), dict(scale=0.37)),
             ("clean again", None, dict(scale=0.37))]
    for what, planted, kw in cases:
        if planted is not None:
            x[0][123, 5] = planted
        flag = mt.multi_tensor_scale_cuda(mt.TensorTable([x, out]), 0, 1,
                                          **kw)
        s = kw.get("scale")
        if s is None:
            s = mt.clip_scale_plain(kw["norm"], kw["max_norm"])
        want, finite = mt.multi_tensor_scale_plain(x, s)
        torch.cuda.synchronize()
        same = all(_same(a, b) for a, b in zip(out, want))
        scale_err = max([scale_err] + [_finite_err(a, b)
                                       for a, b in zip(out, want)])
        flag_ok = int(flag) == int(not bool(finite)) == int(
            planted is not None)
        print(f"kernels: multi_tensor_scale {what} (scale {float(s):.6g}): "
              f"outputs equal to the plain version's: {same}  flag "
              f"{int(flag)} (plain all_finite {bool(finite)})  "
              f"{'ok' if same and flag_ok else 'MISMATCH'}")
        if not (same and flag_ok):
            raise SystemExit(f"multi_tensor_scale kernel disagrees with "
                             f"its plain version ({what})")
        if planted is not None:
            x[0][123, 5] = 0.0
    odd = [torch.randn(s, device=dev, generator=gen)
           for s in [(1,), (65537,), (3, 5), (7,), (513, 129)]]
    for name, lst in (("small odd list", odd),
                      ("misaligned odd list", [_misaligned(t) for t in odd])):
        o = [torch.empty_like(t) for t in lst]
        flag = mt.multi_tensor_scale_cuda(mt.TensorTable([lst, o]), 0, 1,
                                          0.37)
        want, _ = mt.multi_tensor_scale_plain(lst, 0.37)
        ok = int(flag) == 0 and all(torch.equal(a, b)
                                    for a, b in zip(o, want))
        scale_err = max([scale_err] + [_finite_err(a, b)
                                       for a, b in zip(o, want)])
        print(f"kernels: multi_tensor_scale {name}: "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"multi_tensor_scale kernel disagrees with its "
                             f"plain version ({name})")

    # in place at scale 1 for the times, so the data stay as they are;
    # the library call first checked against the kernel at 0.37 on copies
    lib = [t.clone() for t in x]
    found = torch.zeros((), device=dev)
    inv = torch.full((), 0.37, device=dev)
    torch._amp_foreach_non_finite_check_and_unscale_(lib, found, inv)
    mt.multi_tensor_scale_cuda(mt.TensorTable([x, out]), 0, 1, 0.37)
    torch.cuda.synchronize()
    lib_ok = float(found) == 0.0 and all(_close(a, b, 1e-6, 0.0)[1]
                                         for a, b in zip(lib, out))
    print(f"kernels: multi_tensor_scale library call "
          f"torch._amp_foreach_non_finite_check_and_unscale_ against the "
          f"kernel (rtol 1e-6): {'ok' if lib_ok else 'MISMATCH'}")
    if not lib_ok:
        raise SystemExit("torch._amp_foreach_non_finite_check_and_unscale_ "
                         "does not compute multi_tensor_scale's function")
    inv.fill_(1.0)
    table = mt.TensorTable([x])
    kernel = lambda: mt.multi_tensor_scale_cuda(table, 0, 0, 1.0)  # noqa
    k_ms = _device_ms(kernel, reps=100, warmup=5)
    p_ms = _device_ms(lambda: mt.multi_tensor_scale_plain(x, 1.0), reps=10,
                      warmup=2)
    l_ms = _device_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
        x, found, inv), reps=100, warmup=5)
    call_ms = _call_ms(kernel, reps=100, warmup=5)
    nbytes = 8 * numel
    bound_ms, bound_by = _bound(nbytes, 2 * numel)
    print(f"kernels: multi_tensor_scale over {len(x)} tensors device time: "
          f"kernel {k_ms:.5f} ms  plain {p_ms:.5f} ms  "
          f"torch._amp_foreach_non_finite_check_and_unscale_ {l_ms:.5f} ms  "
          f"bound {bound_ms:.6f} ms ({nbytes} bytes over 3.35 TB/s)  per "
          f"call from Python {call_ms:.5f} ms")
    return {"name": "multi_tensor_scale", "route": "cuda",
            "source": "apex_example_tpu_torch/csrc/multi_tensor.cu",
            "replaces": "apex_example_tpu/ops/multi_tensor.py:79",
            "max_abs_err": scale_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": l_ms}, max(n_err, s_err)


def _opt_lists(shapes, dtype, gen):
    """p, g of ``dtype`` and one fp32 state list, on the card."""
    dev = torch.device("cuda")
    rnd = lambda s, std: torch.randn(s, device=dev,            # noqa: E731
                                     generator=gen) * std
    return ([rnd(s, 0.05).to(dtype) for s in shapes],
            [rnd(s, 1e-3).to(dtype) for s in shapes],
            [rnd(s, 1e-3) for s in shapes])


def _check_sgd(fo, mt, lists, hyper, what, lr_t=None):
    """SGD's kernel over ``lists`` (p, g, buf) against its plain version;
    returns the largest |dp|, |dbuf|."""
    p, g, b = lists
    p0, b0 = [t.clone() for t in p], [t.clone() for t in b]
    fo.sgd_cuda(mt.TensorTable([p, g, b]), lr_t=lr_t, **hyper)
    plain = dict(hyper, lr=hyper["lr"] if lr_t is None else lr_t)
    errs, ok = [0.0, 0.0], True
    for i in range(len(p)):
        want = fo.sgd_update_plain(p0[i], g[i], b0[i], **plain)
        for j, (got, w) in enumerate(zip((p[i], b[i]), want)):
            e, o = _elementwise_close(got, w)
            errs[j] = max(errs[j], e)
            ok = ok and o
    torch.cuda.synchronize()
    print(f"kernels: sgd {what}: max|dp| {errs[0]:.3g}  max|dbuf| "
          f"{errs[1]:.3g}  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(f"sgd kernel disagrees with its plain version "
                         f"({what})")
    return max(errs)


def phase_sgd(fo, mt, resnet50):
    """SGD over resnet50-shaped tensors and small odd lists against its
    plain version, the learning rate from the card, the noop flag; its,
    the plain version's and torch._fused_sgd_'s times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = [tuple(p.shape) for p in resnet50(device="cpu").parameters()]
    numel = sum(math.prod(s) for s in shapes)
    print(f"kernels: resnet50 parameter lists: {len(shapes)} tensors, "
          f"{numel} elements")
    hyper = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, dampening=0.0,
                 nesterov=False, first_step=False)
    branches = [("", {}), (" nesterov", dict(nesterov=True)),
                (" first_step", dict(first_step=True)),
                (" dampening 0.1", dict(dampening=0.1))]
    path_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for what, kw in branches:
            err = _check_sgd(fo, mt, _opt_lists(shapes, dtype, gen),
                             dict(hyper, **kw),
                             f"{str(dtype)[6:]}{what}, {len(shapes)} "
                             f"tensors")
            if dtype == torch.float32 and not kw:
                path_err = err
    lr_t = torch.full((1,), 0.05, device=dev)
    _check_sgd(fo, mt, _opt_lists(shapes, torch.float32, gen),
               dict(hyper, lr=123.0), "float32, lr read from the card",
               lr_t=lr_t)
    odd = [(1,), (65537,), (3, 5), (7,), (65536,), (513, 129), (2,)]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for what, kw in branches[:2]:
            _check_sgd(fo, mt, _opt_lists(odd, dtype, gen), dict(hyper, **kw),
                       f"small odd list {str(dtype)[6:]}{what}")
            lists = [[_misaligned(t) for t in lst]
                     for lst in _opt_lists(odd, dtype, gen)]
            _check_sgd(fo, mt, lists, dict(hyper, **kw),
                       f"misaligned odd list {str(dtype)[6:]}{what}")

    p, g, b = _opt_lists(shapes, torch.float32, gen)
    table = mt.TensorTable([p, g, b])
    p0, b0 = [t.clone() for t in p], [t.clone() for t in b]
    noop = torch.ones((), dtype=torch.int32, device=dev)
    fo.sgd_cuda(table, noop_flag=noop, **hyper)
    torch.cuda.synchronize()
    kept = all(torch.equal(x, y) for x, y in zip(p + b, p0 + b0))
    print(f"kernels: sgd with the noop flag set: p and buf bitwise "
          f"unchanged: {kept}")
    if not kept:
        raise SystemExit("sgd kernel wrote with the noop flag set")

    lib = [[t.clone() for t in lst] for lst in (p, g, b)]
    l_ms = None
    if hasattr(torch, "_fused_sgd_"):
        def library():
            torch._fused_sgd_(*lib, weight_decay=hyper["weight_decay"],
                              momentum=hyper["momentum"], lr=hyper["lr"],
                              dampening=0.0, nesterov=False, maximize=False,
                              is_first_step=False)
        fo.sgd_cuda(table, **hyper)
        library()
        torch.cuda.synchronize()
        closes = [_close_scaled(x, y, 1e-5) for lst, ref in
                  ((lib[0], p), (lib[2], b)) for x, y in zip(lst, ref)]
        lib_ok = all(o for _, o in closes)
        print(f"kernels: sgd library call torch._fused_sgd_ against the "
              f"kernel after one step: max|d| "
              f"{max(e for e, _ in closes):.3g}  "
              f"{'ok' if lib_ok else 'MISMATCH'}")
        if not lib_ok:
            raise SystemExit("torch._fused_sgd_ does not compute sgd's "
                             "function")
        l_ms = _device_ms(library, reps=100, warmup=5)

    def plain():
        for i in range(len(p)):
            fo.sgd_update_plain(p[i], g[i], b[i], **hyper)

    kernel = lambda: fo.sgd_cuda(table, **hyper)               # noqa: E731
    k_ms = _device_ms(kernel, reps=100, warmup=5)
    p_ms = _device_ms(plain, reps=10, warmup=2)
    call_ms = _call_ms(kernel, reps=100, warmup=5)
    nbytes = 20 * numel
    bound_ms, bound_by = _bound(nbytes, 7 * numel)
    lib_txt = (f"torch._fused_sgd_ {l_ms:.5f} ms" if l_ms is not None
               else "torch._fused_sgd_ - (not in this torch)")
    print(f"kernels: sgd over {len(p)} tensors device time: kernel "
          f"{k_ms:.5f} ms  plain {p_ms:.5f} ms  {lib_txt}  bound "
          f"{bound_ms:.6f} ms ({nbytes} bytes over 3.35 TB/s)  per call "
          f"from Python {call_ms:.5f} ms")
    return {"name": "sgd", "route": "cuda",
            "source": "apex_example_tpu_torch/csrc/fused_optim.cu",
            "replaces": "apex_example_tpu/ops/fused_optim.py:259",
            "max_abs_err": path_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": l_ms}


def _lists_close(got, want):
    """(largest error, all within the limit) over pairs of tensor lists."""
    closes = [_elementwise_close(a, b) for a, b in zip(got, want)]
    return max(e for e, _ in closes), all(o for _, o in closes)


def _time_row(name, src, replaces, err, kernel, plain, nbytes, ops, what,
              library=None, lib_name=None):
    """A kernel's, its plain version's and (where one computes the same
    function) a PyTorch call's median device times beside the bound; the
    JSON row."""
    k_ms = _device_ms(kernel, reps=100, warmup=5)
    p_ms = _device_ms(plain, reps=10, warmup=2)
    call_ms = _call_ms(kernel, reps=100, warmup=5)
    l_ms = (None if library is None
            else _device_ms(library, reps=100, warmup=5))
    bound_ms, bound_by = _bound(nbytes, ops)
    lib_txt = (f"{lib_name} {l_ms:.5f} ms" if l_ms is not None
               else f"library - ({lib_name})")
    print(f"kernels: {name} over {what} device time: kernel {k_ms:.5f} ms  "
          f"plain {p_ms:.5f} ms  {lib_txt}  bound {bound_ms:.6f} ms "
          f"({nbytes} bytes over 3.35 TB/s)  per call from Python "
          f"{call_ms:.5f} ms")
    return {"name": name, "route": "cuda",
            "source": f"apex_example_tpu_torch/csrc/{src}",
            "replaces": replaces, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": l_ms}


NOVO_HYPER = dict(beta1=0.95, beta2=0.98, eps=1e-8, weight_decay=0.01)
ODD_SHAPES = [(1,), (65537,), (3, 5), (7,), (65536,), (513, 129), (2,)]


def _check_novograd(fo, mt, lists, v, what, first_step, ga):
    """NovoGrad's call (the per-tensor kernel, then the chunk kernel) over
    ``lists`` (p, g, m) and the second moments ``v`` against the plain
    versions: v and inv_denom rtol 1e-6, p and m as _elementwise_close;
    then the same inputs again, bitwise the same result.  Returns the
    largest error."""
    p, g, m = lists
    p0, m0, v0 = [t.clone() for t in p], [t.clone() for t in m], v.clone()
    table = mt.TensorTable([p, g, m])
    _, sq = mt.multi_tensor_l2norm_cuda(table, 1)
    c2 = 1.0 / (1.0 - 0.98 ** 4)
    lr_c1 = 0.05 / (1.0 - 0.95 ** 4)
    scal = torch.tensor([lr_c1, c2], device=v.device)
    step = torch.full((), 0 if first_step else 3, dtype=torch.int32,
                      device=v.device)
    hyper = dict(NOVO_HYPER, grad_avg_coeff=ga)
    inv = fo.novograd_cuda(table, sq, v, scal, step, **hyper)
    v_p, inv_p = fo.novograd_moment_plain(sq, v0, beta2=0.98, eps=1e-8,
                                          c2=scal[1], first_step=first_step)
    want = [fo.novograd_update_plain(p0[i], g[i], m0[i], inv_denom=inv_p[i],
                                     lr_c1=scal[0], beta1=0.95,
                                     weight_decay=0.01, grad_avg_coeff=ga)
            for i in range(len(p))]
    torch.cuda.synchronize()
    v_err, v_ok = _close(v, v_p, 1e-6, 0.0)
    i_err, i_ok = _close(inv, inv_p, 1e-6, 0.0)
    p_err, p_ok = _lists_close(p, [w[0] for w in want])
    m_err, m_ok = _lists_close(m, [w[1] for w in want])
    first = ([t.clone() for t in p + m], v.clone())
    for lst, ref in ((p, p0), (m, m0)):
        for a, b in zip(lst, ref):
            a.copy_(b)
    v.copy_(v0)
    fo.novograd_cuda(table, sq, v, scal, step, **hyper)
    torch.cuda.synchronize()
    same = (torch.equal(v, first[1])
            and all(torch.equal(a, b) for a, b in zip(p + m, first[0])))
    ok = v_ok and i_ok and p_ok and m_ok and same
    print(f"kernels: novograd {what}: max|dv| {v_err:.3g} max|dinv_denom| "
          f"{i_err:.3g} (rtol 1e-6)  max|dp| {p_err:.3g}  max|dm| "
          f"{m_err:.3g}  second call bitwise equal: {same}  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(f"novograd kernels disagree with their plain "
                         f"versions or do not repeat ({what})")
    return max(p_err, m_err, v_err)


def phase_novograd(fo, mt):
    """NovoGrad (fused_optim.cu: the per-tensor kernel, then the chunk
    kernel) against its plain versions over bert_base's 201 parameter
    shapes and small odd lists, on a first step and a later one, with
    grad averaging on and off; the noop flag; its times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = _bert_base_shapes()
    numel = sum(math.prod(s) for s in shapes)
    T = len(shapes)
    print(f"kernels: novograd lists: bert_base's {T} tensors, {numel} "
          f"elements")
    rand_v = lambda n: torch.rand(n, device=dev,               # noqa: E731
                                  generator=gen) * 1e-3
    path_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for first, ga, what in ((True, 0.05, "first step"),
                                (False, 0.05, "later step"),
                                (False, 1.0, "later step, no grad "
                                             "averaging")):
            err = _check_novograd(
                fo, mt, _opt_lists(shapes, dtype, gen), rand_v(T),
                f"{str(dtype)[6:]} {what}, {T} tensors", first, ga)
            if dtype == torch.float32:
                path_err = max(path_err, err)
    for dtype in (torch.float32, torch.bfloat16):
        _check_novograd(fo, mt, _opt_lists(ODD_SHAPES, dtype, gen),
                        rand_v(len(ODD_SHAPES)),
                        f"small odd list {str(dtype)[6:]}", False, 0.05)
        lists = [[_misaligned(t) for t in lst]
                 for lst in _opt_lists(ODD_SHAPES, dtype, gen)]
        _check_novograd(fo, mt, lists, rand_v(len(ODD_SHAPES)),
                        f"misaligned odd list {str(dtype)[6:]}", True, 0.05)

    p, g, m = _opt_lists(shapes, torch.float32, gen)
    v = rand_v(T)
    table = mt.TensorTable([p, g, m])
    _, sq = mt.multi_tensor_l2norm_cuda(table, 1)
    before = [t.clone() for t in p + m] + [v.clone()]
    scal = torch.tensor([0.05 / (1 - 0.95 ** 4), 1 / (1 - 0.98 ** 4)],
                        device=dev)
    step_t = torch.full((), 3, dtype=torch.int32, device=dev)
    hyper = dict(NOVO_HYPER, grad_avg_coeff=0.05)
    fo.novograd_cuda(table, sq, v, scal, step_t, noop_flag=torch.ones(
        (), dtype=torch.int32, device=dev), **hyper)
    torch.cuda.synchronize()
    kept = all(torch.equal(a, b) for a, b in zip(p + m + [v], before))
    print(f"kernels: novograd with the noop flag set: p, m and v bitwise "
          f"unchanged: {kept}")
    if not kept:
        raise SystemExit("novograd kernels wrote with the noop flag set")

    def plain():
        _, inv_p = fo.novograd_moment_plain(sq, v, beta2=0.98, eps=1e-8,
                                            c2=scal[1], first_step=False)
        for i in range(T):
            fo.novograd_update_plain(p[i], g[i], m[i], inv_denom=inv_p[i],
                                     lr_c1=scal[0], beta1=0.95,
                                     weight_decay=0.01, grad_avg_coeff=0.05)

    # p, g, m read and p, m written; per tensor sq read, v read and
    # written, inv_denom written
    return _time_row(
        "novograd", "fused_optim.cu",
        "apex_example_tpu/ops/fused_optim.py:274", path_err,
        lambda: fo.novograd_cuda(table, sq, v, scal, step_t, **hyper), plain,
        20 * numel + 16 * T, 7 * numel, f"{T} tensors",
        lib_name="no single PyTorch call computes it")


def _check_adagrad(fo, mt, lists, hyper, what, lr_t=None):
    """Adagrad's kernel over ``lists`` (p, g, h) against its plain
    version, then again on the same inputs, bitwise the same result.
    Returns the largest error."""
    p, g, h = lists
    p0, h0 = [t.clone() for t in p], [t.clone() for t in h]
    table = mt.TensorTable([p, g, h])
    fo.adagrad_cuda(table, lr_t=lr_t, **hyper)
    plain = dict(hyper, lr=hyper["lr"] if lr_t is None else lr_t)
    want = [fo.adagrad_update_plain(p0[i], g[i], h0[i], **plain)
            for i in range(len(p))]
    torch.cuda.synchronize()
    p_err, p_ok = _lists_close(p, [w[0] for w in want])
    h_err, h_ok = _lists_close(h, [w[1] for w in want])
    first = [t.clone() for t in p + h]
    for lst, ref in ((p, p0), (h, h0)):
        for a, b in zip(lst, ref):
            a.copy_(b)
    fo.adagrad_cuda(table, lr_t=lr_t, **hyper)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(p + h, first))
    ok = p_ok and h_ok and same
    print(f"kernels: adagrad {what}: max|dp| {p_err:.3g}  max|dh| "
          f"{h_err:.3g}  second call bitwise equal: {same}  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(f"adagrad kernel disagrees with its plain version "
                         f"or does not repeat ({what})")
    return max(p_err, h_err)


def _adagrad_lists(shapes, dtype, gen):
    p, g, _ = _opt_lists(shapes, dtype, gen)
    return p, g, [torch.rand(s, device="cuda", generator=gen) * 1e-6
                  for s in shapes]


def phase_adagrad(fo, mt, resnet50):
    """Adagrad (fused_optim.cu) against its plain version over resnet50's
    161 parameter shapes and small odd lists, in both modes, with the
    learning rate from the card; the noop flag; its times beside
    torch._fused_adagrad_'s where this torch takes CUDA tensors there."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = [tuple(p.shape) for p in resnet50(device="cpu").parameters()]
    numel = sum(math.prod(s) for s in shapes)
    print(f"kernels: adagrad lists: resnet50's {len(shapes)} tensors, "
          f"{numel} elements")
    hyper = dict(lr=1e-3, eps=1e-10, weight_decay=1e-4)
    path_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for w_mode in (False, True):
            err = _check_adagrad(
                fo, mt, _adagrad_lists(shapes, dtype, gen),
                dict(hyper, adagrad_w_mode=w_mode),
                f"{str(dtype)[6:]} adagrad_w_mode={w_mode}, {len(shapes)} "
                f"tensors")
            if dtype == torch.float32:
                path_err = max(path_err, err)
    _check_adagrad(fo, mt, _adagrad_lists(shapes, torch.float32, gen),
                   dict(hyper, lr=123.0), "float32, lr read from the card",
                   lr_t=torch.full((1,), 1e-3, device=dev))
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for w_mode in (False, True):
            _check_adagrad(fo, mt, _adagrad_lists(ODD_SHAPES, dtype, gen),
                           dict(hyper, adagrad_w_mode=w_mode),
                           f"small odd list {str(dtype)[6:]} "
                           f"adagrad_w_mode={w_mode}")
            lists = [[_misaligned(t) for t in lst]
                     for lst in _adagrad_lists(ODD_SHAPES, dtype, gen)]
            _check_adagrad(fo, mt, lists, dict(hyper, adagrad_w_mode=w_mode),
                           f"misaligned odd list {str(dtype)[6:]} "
                           f"adagrad_w_mode={w_mode}")

    p, g, h = _adagrad_lists(shapes, torch.float32, gen)
    table = mt.TensorTable([p, g, h])
    before = [t.clone() for t in p + h]
    fo.adagrad_cuda(table, noop_flag=torch.ones((), dtype=torch.int32,
                                                device=dev), **hyper)
    torch.cuda.synchronize()
    kept = all(torch.equal(a, b) for a, b in zip(p + h, before))
    print(f"kernels: adagrad with the noop flag set: p and h bitwise "
          f"unchanged: {kept}")
    if not kept:
        raise SystemExit("adagrad kernel wrote with the noop flag set")

    library, lib_name = None, "torch._fused_adagrad_ not in this torch"
    if hasattr(torch, "_fused_adagrad_"):
        lib = [[t.clone() for t in lst] for lst in (p, g, h)]
        steps = [torch.ones((), device=dev) for _ in p]

        def library():
            torch._fused_adagrad_(*lib, steps, lr=hyper["lr"], lr_decay=0.0,
                                  weight_decay=hyper["weight_decay"],
                                  eps=hyper["eps"], maximize=False)
        try:
            library()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as exc:
            library = None
            lib_name = (f"torch._fused_adagrad_ takes no CUDA tensors in "
                        f"this torch: {str(exc).splitlines()[0][:120]}")
        if library is not None:
            fo.adagrad_cuda(table, **hyper)
            torch.cuda.synchronize()
            err, lib_ok = _lists_close(lib[0] + lib[2], p + h)
            lib_name = "torch._fused_adagrad_"
            print(f"kernels: adagrad library call torch._fused_adagrad_ "
                  f"against the kernel after one step: max|d| {err:.3g}  "
                  f"{'ok' if lib_ok else 'MISMATCH'}")
            if not lib_ok:
                raise SystemExit("torch._fused_adagrad_ does not compute "
                                 "adagrad's function")

    def plain():
        for i in range(len(p)):
            fo.adagrad_update_plain(p[i], g[i], h[i], **hyper)

    return _time_row(
        "adagrad", "fused_optim.cu",
        "apex_example_tpu/ops/fused_optim.py:380", path_err,
        lambda: fo.adagrad_cuda(table, **hyper), plain, 20 * numel,
        7 * numel, f"{len(p)} tensors", library=library, lib_name=lib_name)


def phase_axpby(mt):
    """axpby (multi_tensor.cu) against its plain version over bert_base's
    201 parameter shapes in fp32 and with mixed dtypes (fp32 x, bf16 y;
    bf16 x, fp32 y), and over small odd lists, aligned and not, in every
    pair of fp32, bf16 and fp16; a second call bitwise equal; its times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    shapes = _bert_base_shapes()
    numel = sum(math.prod(s) for s in shapes)
    a, b = 0.7, -1.3
    rnd = lambda s, dt: torch.randn(s, device=dev,             # noqa: E731
                                    generator=gen).to(dt)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [(shapes, f32, f32, f"fp32, bert_base's {len(shapes)} tensors"),
             (shapes, f32, bf16, "fp32 x, bf16 y, bert_base's tensors"),
             (shapes, bf16, f32, "bf16 x, fp32 y, bert_base's tensors")]
    cases += [(ODD_SHAPES, xd, yd, f"small odd list {str(xd)[6:]} x, "
               f"{str(yd)[6:]} y") for xd in (f32, bf16, f16)
              for yd in (f32, bf16, f16)]
    path_err = 0.0
    for k, (shp, xd, yd, what) in enumerate(cases):
        for misaligned in ((False, True) if shp is ODD_SHAPES else (False,)):
            x = [rnd(s, xd) for s in shp]
            y = [rnd(s, yd) for s in shp]
            out = [torch.empty_like(t) for t in y]
            if misaligned:
                x, y, out = ([_misaligned(t) for t in lst]
                             for lst in (x, y, out))
            table = mt.TensorTable([x, y, out])
            mt.multi_tensor_axpby_cuda(table, a, b)
            want = mt.multi_tensor_axpby_plain(a, x, b, y)
            torch.cuda.synchronize()
            err, ok = _lists_close(out, want)
            first = [t.clone() for t in out]
            mt.multi_tensor_axpby_cuda(table, a, b)
            torch.cuda.synchronize()
            same = all(torch.equal(s, t) for s, t in zip(out, first))
            if k == 0:
                path_err = err
            print(f"kernels: axpby {what}{', misaligned' * misaligned}: "
                  f"max|dout| {err:.3g}  second call bitwise equal: {same}  "
                  f"{'ok' if ok and same else 'MISMATCH'}")
            if not (ok and same):
                raise SystemExit(f"axpby kernel disagrees with its plain "
                                 f"version or does not repeat ({what})")
    x = [rnd(s, f32) for s in shapes]
    y = [rnd(s, f32) for s in shapes]
    out = [torch.empty_like(t) for t in y]
    table = mt.TensorTable([x, y, out])
    return _time_row(
        "axpby", "multi_tensor.cu", "apex_example_tpu/ops/multi_tensor.py:151",
        path_err, lambda: mt.multi_tensor_axpby_cuda(table, a, b),
        lambda: mt.multi_tensor_axpby_plain(a, x, b, y), 12 * numel,
        3 * numel, f"{len(shapes)} tensors, fp32",
        lib_name="no single PyTorch call computes it")


def _bn_inputs(rows, C, dtype, gen):
    dev = torch.device("cuda")
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    x = (rnd(rows, C) * 2 + 0.5).to(dtype)
    dy = rnd(rows, C).to(dtype)
    c = rnd(C) * 0.5 + 0.5
    mean = c + rnd(C) * 0.1
    inv = torch.rand(C, device=dev, generator=gen) + 0.25
    return x, dy, c, mean, inv


def _bn_magnitudes(x, dy, c, mean, inv):
    """The sums of the terms' magnitudes of the four BatchNorm sums, per
    channel: sum|x - c|, sum (x - c)^2, sum|dy|, sum|dy * x_hat|."""
    xc = x.float() - c
    dyf = dy.float()
    return (xc.abs().sum(0), (xc * xc).sum(0), dyf.abs().sum(0),
            (dyf * (x.float() - mean) * inv).abs().sum(0))


def _bn_sums_close(got, want, mags):
    """max |got - want| and whether every sum is within rtol SUM_TOL plus
    BN_SUM_ATOL of the sum of its terms' magnitudes: a sum over thousands
    of rows that cancels to near zero carries the rounding of its terms,
    not of itself (a missing or doubled row moves it by far more)."""
    return _close(got, want, SUM_TOL, BN_SUM_ATOL * mags.double())


def _bn_library(x, dy, c, mean, inv, got):
    """torch.batch_norm_stats and torch.batch_norm_backward_reduce on the
    same (rows, C) inputs, held against the kernels' sums ``got``; returns
    the two calls, or None where this torch has not them."""
    try:
        lib_mean, lib_inv = torch.batch_norm_stats(x, 1e-5)
        sum_dy, sum_dy_xmu = torch.batch_norm_backward_reduce(
            dy, x, mean, inv, None, True, False, False)[:2]
    except (AttributeError, RuntimeError, TypeError) as exc:
        print(f"kernels: batch_norm library calls not available: "
              f"{str(exc).splitlines()[0]}")
        return None
    n = x.shape[0]
    s, ss, sdy, sdyx = got
    m_c = s / n
    checks = [(lib_mean, c + m_c),
              (lib_inv, torch.rsqrt(ss / n - m_c * m_c + 1e-5)),
              (sum_dy, sdy), (sum_dy_xmu * inv, sdyx)]
    mags = _bn_magnitudes(x, dy, c, mean, inv)
    closes = [_bn_sums_close(a, b, m) for (a, b), m in zip(checks, (
        torch.ones_like(mags[0]), torch.ones_like(mags[0]), mags[2],
        mags[3]))]
    ok = all(o for _, o in closes)
    print(f"kernels: torch.batch_norm_stats / batch_norm_backward_reduce "
          f"against the kernels: max|d| {max(e for e, _ in closes):.3g}  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("the batch_norm library calls do not compute the "
                         "kernels' sums")
    return (lambda: torch.batch_norm_stats(x, 1e-5),
            lambda: torch.batch_norm_backward_reduce(dy, x, mean, inv, None,
                                                     True, False, False))


def phase_bn(bn, sync_batchnorm_cls, counted):
    """The BatchNorm statistics and backward sums against their plain
    versions and bitwise repeat; SyncBatchNorm(fused_kernel=True) against
    its composite branch through the module (the "syncbn" path's
    launches); each kernel's, plain version's and library call's time.
    Returns the two rows and the syncbn path's launch counts."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [(r, c, d) for r, c in BN_SHAPES
             for d in (torch.float32, torch.bfloat16)]
    cases += [(BN_SHAPES[1][0] - 5, 1024, torch.float32),
              (777, 37, torch.float32), (777, 37, torch.bfloat16),
              (1000, 64, torch.float16)]
    errs = [0.0, 0.0]
    for rows, C, dtype in cases:
        x, dy, c, mean, inv = _bn_inputs(rows, C, dtype, gen)
        got = bn.bn_stats_cuda(x, c) + bn.bn_bwd_sums_cuda(x, dy, mean, inv)
        again = bn.bn_stats_cuda(x, c) + bn.bn_bwd_sums_cuda(x, dy, mean,
                                                              inv)
        want = bn.bn_stats_plain(x, c) + bn.bn_bwd_sums_plain(x, dy, mean,
                                                               inv)
        mags = _bn_magnitudes(x, dy, c, mean, inv)
        torch.cuda.synchronize()
        closes = [_bn_sums_close(a, w, m)
                  for a, w, m in zip(got, want, mags)]
        same = all(torch.equal(a, r) for a, r in zip(got, again))
        ok = same and all(o for _, o in closes)
        e_s = max(e for e, _ in closes[:2])
        e_b = max(e for e, _ in closes[2:])
        print(f"kernels: bn sums {rows}x{C} {str(dtype)[6:]}: max|ds|,|dss| "
              f"{e_s:.3g}  max|dsdy|,|dsdyx| {e_b:.3g}  second call bitwise "
              f"equal: {same}  {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"batch_norm kernels disagree with their plain "
                             f"versions or do not repeat at {rows}x{C} "
                             f"{dtype}")
        if (rows, C) in BN_SHAPES and dtype == torch.float32:
            errs = [max(errs[0], e_s), max(errs[1], e_b)]
        del x, dy
    torch.cuda.empty_cache()

    # the module, fused against composite, at stage 3's shape
    n, hw, _, C = BN_MODULE_SHAPE
    syncbn_counts = None
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(n, hw, hw, C, device=dev, generator=gen) * 2
             + 0.5).to(dtype)
        dy = torch.randn(n, hw, hw, C, device=dev, generator=gen).to(dtype)
        scale = torch.rand(C, device=dev, generator=gen) + 0.5
        bias = torch.randn(C, device=dev, generator=gen) * 0.2
        res = {}
        for fused in (True, False):
            m = sync_batchnorm_cls(C, dtype=dtype, stats_dtype=torch.float32,
                                   fused_kernel=fused, device=dev)
            with torch.no_grad():
                m.scale.copy_(scale)
                m.bias.copy_(bias)
            xg = x.clone().requires_grad_()
            if fused:
                _zero_counts(counted)
            y = m(xg)
            y.backward(dy)
            torch.cuda.synchronize()
            if fused and syncbn_counts is None:
                syncbn_counts = _counts(counted)
            res[fused] = [t.detach().float() for t in
                          (y, xg.grad, m.scale.grad, m.bias.grad, m.mean,
                           m.var)]
        (y_f, dx_f, ds_f, db_f, rm_f, rv_f), (y_c, dx_c, ds_c, db_c, rm_c,
                                              rv_c) = res[True], res[False]
        if dtype == torch.float32:
            io = [_close(a, b, 1e-4, 1e-4) for a, b in ((y_f, y_c),
                                                         (dx_f, dx_c))]
        else:
            # y: one bf16 ulp.  dx: two bf16 ulps of its largest magnitude,
            # since the composite's autograd rounds each of x's two
            # cotangents (through the moments and through the apply) to
            # bf16 before it adds them, and they cancel
            dx_tol = 2.0 * 2.0 ** (math.floor(math.log2(float(
                dx_c.abs().max()))) - 7)
            io = [(float((y_f - y_c).abs().max()),
                   bool(((y_f - y_c).abs() <= _bf16_tol(y_f, y_c)).all())),
                  _close(dx_f, dx_c, 0.0, dx_tol)]
        xf = x.double().reshape(-1, C)
        xhat = (xf - xf.mean(0)) * torch.rsqrt(xf.var(0, unbiased=False)
                                               + 1e-5)
        dyf = dy.double().reshape(-1, C)
        sums = [_bn_sums_close(a, b, m) for a, b, m in (
            (ds_f, ds_c, (dyf * xhat).abs().sum(0)),
            (db_f, db_c, dyf.abs().sum(0)))]
        stats = [_close(a, b, SUM_TOL, 1e-5) for a, b in ((rm_f, rm_c),
                                                           (rv_f, rv_c))]
        ok = all(o for _, o in io + sums + stats)
        print(f"kernels: SyncBatchNorm fused_kernel=True vs composite at "
              f"{n}x{hw}x{hw}x{C} {str(dtype)[6:]}: max|dy| {io[0][0]:.3g}  "
              f"max|ddx| {io[1][0]:.3g}  max|ddscale|,|ddbias| "
              f"{max(e for e, _ in sums):.3g}  max|drunning| "
              f"{max(e for e, _ in stats):.3g}  {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"SyncBatchNorm's fused branch disagrees with "
                             f"its composite branch ({dtype})")
        del x, dy, res
    want = dict.fromkeys(counted, 0)
    want.update(bn_stats=1, bn_bwd_sums=1)
    print(f"syncbn: launches of one fused forward and backward through the "
          f"module {syncbn_counts} (want {want})")
    if syncbn_counts != want:
        raise SystemExit("SyncBatchNorm(fused_kernel=True) did not launch "
                         "the batch_norm kernels once each")
    torch.cuda.empty_cache()

    rows_out, by_shape = [], {"bn_stats": {}, "bn_bwd_sums": {}}
    # the stem's shape last: its times are the rows'
    for rows, C in BN_SHAPES[::-1]:
        x, dy, c, mean, inv = _bn_inputs(rows, C, torch.float32, gen)
        got = bn.bn_stats_cuda(x, c) + bn.bn_bwd_sums_cuda(x, dy, mean, inv)
        lib = _bn_library(x, dy, c, mean, inv, got)
        spec = (("bn_stats", lambda: bn.bn_stats_cuda(x, c),
                 lambda: bn.bn_stats_plain(x, c),
                 4 * rows * C + 12 * C, 4 * rows * C),
                ("bn_bwd_sums", lambda: bn.bn_bwd_sums_cuda(x, dy, mean, inv),
                 lambda: bn.bn_bwd_sums_plain(x, dy, mean, inv),
                 8 * rows * C + 16 * C, 6 * rows * C))
        for k, (name, kernel, plain, nbytes, ops) in enumerate(spec):
            k_ms = _device_ms(kernel, reps=100, warmup=5)
            p_ms = _device_ms(plain, reps=20, warmup=2)
            l_ms = (_device_ms(lib[k], reps=100, warmup=5)
                    if lib is not None else None)
            bound_ms, bound_by = _bound(nbytes, ops)
            lib_name = ("torch.batch_norm_stats" if k == 0
                        else "torch.batch_norm_backward_reduce")
            lib_txt = (f"{lib_name} {l_ms:.5f} ms" if l_ms is not None
                       else f"{lib_name} -")
            print(f"kernels: {name} {rows}x{C} float32 device time: kernel "
                  f"{k_ms:.5f} ms ({nbytes / k_ms / 1e9:.3f} TB/s)  plain "
                  f"{p_ms:.5f} ms  {lib_txt}  bound {bound_ms:.6f} ms "
                  f"({nbytes} bytes over 3.35 TB/s)")
            by_shape[name][f"{rows}x{C}"] = {
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                "library_ms": l_ms}
            if (rows, C) == BN_SHAPES[0]:
                rows_out.append({
                    "name": name, "route": "cuda",
                    "source": "apex_example_tpu_torch/csrc/batch_norm.cu",
                    "replaces": ("apex_example_tpu/ops/batch_norm.py:74"
                                 if k == 0 else
                                 "apex_example_tpu/ops/batch_norm.py:88"),
                    "max_abs_err": errs[k], "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": l_ms, "by_shape": by_shape[name]})
        del x, dy
        torch.cuda.empty_cache()
    return rows_out, syncbn_counts


ATTN_CASES = (   # name, B, Sq, Sk, H, D, causal, key bias, dlse, dtypes
    ("gpt_base", 8, 2048, 2048, 12, 64, True, False, False,
     (torch.float32, torch.bfloat16, torch.float16)),
    ("bert_base", 8, 512, 512, 12, 64, False, True, False,
     (torch.float32, torch.bfloat16)),
    ("rectangular", 2, 384, 1024, 12, 64, True, False, True,
     (torch.float32,)),
    ("ragged", 2, 1000, 1000, 4, 16, True, False, True,
     (torch.float32, torch.bfloat16)),
    ("ragged", 2, 1000, 1000, 4, 80, False, True, True,
     (torch.float32, torch.bfloat16, torch.float16)),
    ("padded", 2, 1000, 1000, 4, 24, True, False, True, (torch.bfloat16,)),
    # the fp32 backward's tiles at D 128 (64 keys or queries a block, 48
    # streamed rows a tile); "strided": q, k, v and dO are x[..., ::2] of
    # tensors twice as wide, which the kernels load element by element
    ("wide", 2, 1000, 1000, 8, 128, True, False, True, (torch.float32,)),
    ("strided", 2, 1000, 1000, 8, 64, True, True, True, (torch.float32,)))


def _attn_inputs(b, sq, sk, h, d, dtype, gen, bias, dlse, step=1):
    """q, k, v, dO (normal; views x[..., ::step] of tensors step x as
    wide), dlse or None, and a (B, Sk) key bias masking a random suffix of
    each row at -1e9, the last row's every key, or None."""
    dev = "cuda"
    q, k, v, do = (torch.randn(b, s, h, step * d, device=dev, generator=gen)
                   .to(dtype)[..., ::step] for s in (sq, sk, sk, sq))
    dl = (torch.randn(b, h, sq, device=dev, generator=gen) if dlse
          else None)
    key_bias = None
    if bias:
        keep = torch.randint(sk // 4, sk + 1, (b,), device=dev,
                             generator=gen)
        keep[-1] = 0
        key_bias = torch.where(
            torch.arange(sk, device=dev)[None, :] < keep[:, None], 0.0, -1e9)
    return q, k, v, do, dl, key_bias


def _attn_work(b, sq, sk, h, d, causal, esize):
    """(live scores, bytes of fwd, dK/dV, dQ): each input read once, each
    output written once; the causal mask bottom-right aligned."""
    off = sk - sq
    live = b * h * (sq * off + sq * (sq + 1) // 2 if causal else sq * sk)
    qd, kd = b * sq * h * d * esize, b * sk * h * d * esize
    rows = b * h * sq * 4
    return live, (2 * qd + 2 * kd + rows, 2 * qd + 4 * kd + 2 * rows,
                  3 * qd + 2 * kd + 2 * rows)


def _attn_check(att, name, got, ref, half, dead=None, exact=None):
    """(max |got - ref|, the share of elements not equal, whether within
    the limits, the largest dead-row floor), by the limits of
    ops/attention.py: lse and an fp32 O against the reference
    ATTN_FWD_TOL, fp32 grads ATTN_BWD_TOL (atol = rtol), a half O against
    the reference ATTN_HALF_TOL; a half O against the kernels' arithmetic
    ("o_tiled") and the half grads ``half_result_check`` (``dead`` and
    ``exact`` the grads' dead batch elements and their exact sums)."""
    if half and name not in ("o", "lse"):
        r = att.half_result_check("o" if name == "o_tiled" else name, got,
                                  ref, None if name == "o_tiled" else dead,
                                  exact)
        return r.err, r.share, r.ok, r.floor
    tol = (att.ATTN_HALF_TOL if name == "o" and half
           else att.ATTN_FWD_TOL if name in ("o", "lse")
           else att.ATTN_BWD_TOL)
    err, ok = _close(got, ref, tol, tol)
    share = float((got != ref).float().mean())
    return err, share, ok and got.dtype == ref.dtype, 0.0


def _half_failure(att, got, ref, dead, exact):
    """Where a half result is furthest past part 1's bound (rtol 1e-2, atol
    1e-3) or its dead row's floor: dead or live element, index, |ref|,
    got - ref, the bound there, and (dead) exact - ref."""
    gd, rd = got.double(), ref.double()
    bound = att.ATTN_HALF_O_ATOL + att.ATTN_HALF_O_RTOL * rd.abs()
    if exact is not None:
        rows = att.DEAD_FLOOR_X * (rd[dead] - exact.double()).abs().amax(
            -1, keepdim=True)
        bound[dead] = torch.maximum(bound[dead], rows)
    ratio = (gd - rd).abs() / bound
    idx = tuple(int(i) for i in torch.unravel_index(ratio.argmax(),
                                                    ratio.shape))
    where = ("dead" if dead is not None and bool(dead[idx[0]]) else "live")
    text = (f"{int((ratio > 1).sum())} elements past their bound, the worst "
            f"at {idx} ({where}): |ref| {float(rd[idx].abs()):.4g}, got - "
            f"ref {float(gd[idx] - rd[idx]):.4g}, bound "
            f"{float(bound[idx]):.4g}")
    if where == "dead":
        j = int(dead[:idx[0]].sum())
        text += (f", exact - ref "
                 f"{float(exact.double()[(j,) + idx[1:]] - rd[idx]):.4g}")
    return text


def _planted_faults(att, q, k, v, causal, scale, o, lse, do, want):
    """The half limits against kernels that skip one rounding point each,
    built from the plain versions: P unrounded before P V (O), P before
    dV, dS before dK and dQ; against one that moves a rounding point: dS
    computed from the rounded P, for dK and dQ; and against one confined
    to under 1% of the elements: the last key row of dK and the last query
    row of dQ of one (b, h) scaled by 1.05, caught when either fails.
    Each must fail the limit that the kernels pass.  ``o`` and ``lse`` are
    the reference forward's, ``want`` the plain results by name
    ("o_tiled", "dq", "dk", "dv")."""
    dt = q.dtype
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    faults = {"o_tiled": att.attention_pair_tiled_plain(
        qf, kf, vf, None, causal, scale)[0].to(dt)}
    p = torch.exp(att.scores_plain(q, k, None, causal, scale)
                  - lse[..., None])
    faults["dv"] = torch.einsum("bhqk,bqhd->bkhd", p, dof).to(dt)
    dp = (torch.einsum("bqhd,bkhd->bhqk", dof, vf)
          - att.delta(o, do)[..., None])
    ds = p * dp * scale
    faults["dk"] = torch.einsum("bhqk,bqhd->bkhd", ds, qf).to(dt)
    faults["dq"] = torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(dt)
    ds = (p.to(dt).float() * dp * scale).to(dt).float()
    del p, dp
    moved = {"dk": torch.einsum("bhqk,bqhd->bkhd", ds, qf).to(dt),
             "dq": torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(dt)}
    del ds
    rows = {"dk": want["dk"].clone(), "dq": want["dq"].clone()}
    for t in rows.values():
        t[0, -1, 0] *= 1.05
    name_dt = str(dt)[6:]
    for what, bad_set, need_all in (
            ("one rounding point skipped (P before P V; P before dV; dS "
             "before dK and dQ)", faults, True),
            ("dS computed from the rounded P", moved, True),
            ("the last key row of dK and the last query row of dQ of (b 0, "
             "h 0) scaled by 1.05", rows, False)):
        text, caught = [], []
        for name, bad in bad_set.items():
            err, share, ok, _ = _attn_check(att, name, bad, want[name], True)
            caught.append(not ok)
            text.append(f"{name} max|d| {err:.3g} ({share:.2e} off) "
                        f"{'PASSED' if ok else 'caught'}")
        print(f"attention: planted fault {name_dt}, {what}: "
              + "  ".join(text))
        if not (all(caught) if need_all else any(caught)):
            raise SystemExit(f"the {name_dt} limit passes a planted fault: "
                             f"{what}")


def _device_kernels(fn):
    """The device kernels of one call of ``fn`` under torch.profiler, by
    name, with their device time (ms), the longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:100]
            ms[name] = ms.get(name, 0.0) + (e.time_range.end
                                            - e.time_range.start) / 1e3
    return sorted(ms.items(), key=lambda kv: -kv[1])


def phase_attention(att):
    """The three flash-attention kernels against their plain versions at
    the shapes of ATTN_CASES (O and lse, then dK/dV and dQ from the plain
    forward's lse and Delta) within the limits of ``_attn_check``, and the
    bf16 and fp16 limits against planted faults at gpt_base's shape; a
    second launch bitwise equal; then each kernel's, its plain version's
    and SDPA's times at gpt_base's shape in each dtype."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    names = ("attn_fwd", "attn_dkdv", "attn_dq")
    errs = dict.fromkeys(names, 0.0)
    t0 = time.perf_counter()
    for (label, b, sq, sk, h, d, causal, bias, dlse, dtypes) in ATTN_CASES:
        for dtype in dtypes:
            q, k, v, do, dl_in, kb = _attn_inputs(
                b, sq, sk, h, d, dtype, gen, bias, dlse,
                2 if label == "strided" else 1)
            scale = d ** -0.5
            o, lse = att.flash_attention_cuda(q, k, v, kb, causal, scale)
            o_p, lse_p = att.attention_pair_plain(q, k, v, kb, causal, scale)
            dl = att.delta(o_p, do, dl_in)
            bwd = (q, k, v, kb, causal, scale, do, lse_p, dl)
            dk, dv = att.flash_attention_dkdv_cuda(*bwd)
            dq = att.flash_attention_dq_cuda(*bwd)
            want = att.attention_bwd_plain(q, k, v, kb, causal, scale, o_p,
                                           lse_p, do, dl_in)
            again = (att.flash_attention_cuda(q, k, v, kb, causal, scale)
                     + att.flash_attention_dkdv_cuda(*bwd)
                     + (att.flash_attention_dq_cuda(*bwd),))
            torch.cuda.synchronize()
            half = dtype != torch.float32
            checks = (("attn_fwd", "o", o, o_p),
                      ("attn_fwd", "lse", lse, lse_p),
                      ("attn_dkdv", "dk", dk, want[1]),
                      ("attn_dkdv", "dv", dv, want[2]),
                      ("attn_dq", "dq", dq, want[0]))
            o_t, dead, exact = None, att.dead_batch(kb), {}
            if half:
                o_t = att.attention_pair_tiled_plain(q, k, v, kb, causal,
                                                     scale)[0]
                checks += (("attn_fwd", "o_tiled", o, o_t),)
                if dead is not None and bool(dead.any()):
                    exact = dict(zip(("dq", "dk", "dv"),
                                     att.attention_exact_sums(
                                         *(t[dead] for t in (q, k, v, kb)),
                                         causal, scale, do[dead], dl[dead],
                                         lse_p[dead])))
            ok, text, floor = True, [], 0.0
            for kernel, name, got, ref in checks:
                err, share, good, fl = _attn_check(att, name, got, ref, half,
                                                   dead, exact.get(name))
                ok, floor = ok and good, max(floor, fl)
                text.append(f"max|d{name}| {err:.3g}" + (
                    f" ({share:.2e} off)" if half and name != "lse" else "")
                    + ("" if good else " FAILS"))
                if half and not good and name not in ("o", "lse"):
                    print(f"attention: {label} {str(dtype)[6:]} {name}: "
                          + _half_failure(att, got, ref, dead,
                                          exact.get(name)))
                if label == "gpt_base" and not (half and name == "o"):
                    errs[kernel] = max(errs[kernel], err)
            if exact:
                text.append(f"largest dead-row floor {floor:.3g}")
            same = all(torch.equal(a, r) for a, r in
                       zip((o, lse, dk, dv, dq), again))
            print(f"attention: {label} B{b} Sq{sq} Sk{sk} H{h} D{d} "
                  f"{'causal' if causal else 'full'}"
                  f"{' bias' if bias else ''}{' dlse' if dlse else ''} "
                  f"{str(dtype)[6:]}: {'  '.join(text)}  bitwise repeat "
                  f"{same}  {'ok' if ok and same else 'MISMATCH'}")
            if not (ok and same):
                raise SystemExit(f"attention kernels disagree with their "
                                 f"plain versions ({label}, {dtype})")
            if label == "gpt_base" and half:
                _planted_faults(att, q, k, v, causal, scale, o_p, lse_p, do,
                                dict(zip(("o_tiled", "dq", "dk", "dv"),
                                         (o_t,) + tuple(want))))
            if label == "bert_base" and dtype == torch.bfloat16:
                bad = want[1].clone()
                bad[dead.nonzero()[0, 0], 0, 0] = 0
                err, share, good, _ = _attn_check(att, "dk", bad, want[1],
                                                  True, dead, exact["dk"])
                print(f"attention: planted fault bfloat16, key 0 of dK's dead "
                      f"batch element, head 0, zeroed: max|d| {err:.3g} "
                      f"{'passes the limit' if good else 'caught'} "
                      f"(printed, not required)")
            del o, lse, o_p, lse_p, o_t, dk, dv, dq, want, again, exact
            torch.cuda.empty_cache()
    print(f"attention: checks took {time.perf_counter() - t0:.1f} s")

    b, sq, sk, h, d, causal = 8, 2048, 2048, 12, 64, True
    by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, do, _, _ = _attn_inputs(b, sq, sk, h, d, dtype, gen, False,
                                         False)
        scale = d ** -0.5
        o, lse = att.attention_pair_plain(q, k, v, None, causal, scale)
        dl = att.delta(o, do)
        bwd = (q, k, v, None, causal, scale, do, lse, dl)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)

        out = sdpa()
        lib_err = float((out.detach().transpose(1, 2).float()
                         - att.flash_attention_cuda(q, k, v, None, causal,
                                                    scale)[0].float())
                        .abs().max())
        # The plain backward and SDPA's backward compute dQ, dK and dV in
        # one call: the dK/dV and dQ rows both carry that call's time.
        fwd_plain = _device_ms(lambda: att.attention_pair_plain(
            q, k, v, None, causal, scale), reps=5, warmup=1)
        bwd_plain = _device_ms(lambda: att.attention_bwd_plain(
            q, k, v, None, causal, scale, o, lse, do), reps=5, warmup=1)
        fwd_lib = _device_ms(sdpa, reps=20, warmup=3)
        bwd_lib = _device_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), reps=20, warmup=3)
        if dtype == torch.float32:
            for what, fn in (("forward", sdpa), ("backward", lambda:
                             torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True))):
                print(f"attention: SDPA's fp32 {what} at gpt_base's shape "
                      f"runs " + "; ".join(f"{n} {ms:.4f} ms" for n, ms in
                                           _device_kernels(fn)))
        kernels = (
            ("attn_fwd", lambda: att.flash_attention_cuda(
                q, k, v, None, causal, scale), fwd_plain, fwd_lib),
            ("attn_dkdv", lambda: att.flash_attention_dkdv_cuda(*bwd),
             bwd_plain, bwd_lib),
            ("attn_dq", lambda: att.flash_attention_dq_cuda(*bwd),
             bwd_plain, bwd_lib))
        live, nbytes = _attn_work(b, sq, sk, h, d, causal, q.element_size())
        peak = FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
        rows = {}
        for (name, kernel, plain_ms, lib_ms), flops, nb in zip(
                kernels, (4, 8, 6), nbytes):
            ms = _device_ms(kernel, reps=20, warmup=3)
            bound_ms, bound_by = _bound(nb, flops * d * live, peak)
            rows[name] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}
            regs = ""
            if name == "attn_fwd" and dtype == torch.float32:
                # attn_fwd_kernel<64> and <128> (the _tc ones: "_tcI")
                found = [_registers("attention", f"attn_fwd_kernelILi{dp}E")
                         for dp in (64, 128)]
                regs = (f"  ptxas {found[0]} / {found[1]} registers at D 64 "
                        f"/ 128" if None not in found else
                        "  ptxas registers: not built in this process")
            print(f"attention: {name} gpt_base {str(dtype)[6:]} device "
                  f"time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"SDPA {'forward' if name == 'attn_fwd' else 'backward'} "
                  f"{lib_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{flops * d * live / 1e9:.2f} GFLOP over "
                  f"{peak / 1e12:.0f} TFLOP/s, {nb} bytes)  "
                  f"{flops * d * live / ms / 1e9:.2f} TFLOP/s{regs}")
        print(f"attention: SDPA forward against the kernel, gpt_base "
              f"{str(dtype)[6:]}: max|diff| {lib_err:.3g} (the yardstick "
              f"computes the same function)")
        by_dtype[str(dtype)[6:]] = rows
        del q, k, v, do, o, lse, dl, bwd, qt, kt, vt, dot, out, kernels
        torch.cuda.empty_cache()
    sources = {"attn_fwd": 147, "attn_dkdv": 183, "attn_dq": 216}
    out_rows = []
    for name in names:
        # the row's times are bf16's: the O2 run, bench.py's gpt contract
        row = dict(by_dtype["bfloat16"][name])
        out_rows.append({
            "name": name, "route": "cuda",
            "source": "apex_example_tpu_torch/csrc/attention.cu",
            "replaces": f"apex_example_tpu/ops/attention.py:{sources[name]}",
            "max_abs_err": errs[name], **row,
            "by_dtype": {dt: r[name] for dt, r in by_dtype.items()}})
    return out_rows


def _zero_counts(counted):
    for fn in counted.values():
        fn.launches = 0


def _counts(counted):
    return {name: fn.launches for name, fn in counted.items()}


def phase_main(cli, gpt_base, counted):
    args = cli.build_parser().parse_args(SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(counted)
    t0 = time.perf_counter()
    completions, summary, rc = cli.run_serve(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(counted)
    launches = counts["layer_norm_fwd"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ok = sum(c.status == "ok" for c in completions)
    ticks = summary["compute_steps"]
    model = gpt_base(seed=args.seed, device="cuda").eval()
    per_tick = 2 * model.num_layers + 2
    print(f"main: gpt_base {ok}/{len(completions)} ok  compute ticks "
          f"{ticks} (steps {summary['steps']})  layer_norm launches "
          f"{launches} (want {per_tick} x {ticks} = {per_tick * ticks})  "
          f"tokens/s {summary['tokens_per_sec']}  ttft p50/p95 "
          f"{summary['ttft_ms']['p50']}/{summary['ttft_ms']['p95']} ms  "
          f"tpot p50/p95 {summary['tpot_ms']['p50']}/"
          f"{summary['tpot_ms']['p95']} ms  wall {wall:.1f} s  "
          f"max memory {peak_gib:.2f} GiB")
    if rc != 0 or ok != len(completions) or len(completions) != 32:
        raise SystemExit(f"serving run: rc {rc}, {ok} ok of "
                         f"{len(completions)} (want 32)")
    if launches != per_tick * ticks:
        raise SystemExit(f"layer_norm kernel launched {launches} times in "
                         f"{ticks} compute ticks (want {per_tick} each)")
    others = {k: v for k, v in counts.items() if k != "layer_norm_fwd"}
    print(f"main: other kernels' launches while serving: {others} (want 0)")
    if any(others.values()):
        raise SystemExit("serving launched a training kernel")

    longest = sorted(completions, key=lambda c: -len(c.tokens))[:4]
    worst, n_tok = 0.0, 0
    with torch.no_grad():
        for c in longest:
            prompt, toks = list(c.request.prompt), c.tokens
            ids = torch.tensor([prompt + toks[:-1]], device="cuda")
            logits = model(ids)[0, len(prompt) - 1:]
            served = torch.tensor(toks, device="cuda")
            gap = logits.max(-1).values - logits.gather(
                1, served[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            n_tok += len(toks)
    print(f"main: teacher-forced check, {len(longest)} requests, {n_tok} "
          f"served tokens: largest gap to the top logit {worst:.3g} "
          f"(limit {TIE_TOL:g})")
    if not math.isfinite(worst) or worst > TIE_TOL:
        raise SystemExit("served greedy tokens disagree with the full "
                         "forward")
    return counts


def phase_train(train, counted, label, argv, per_step, scale=None,
                falls=True, out=None, nan_steps=()):
    """A model trained through the port's trainer: finite, falling loss
    (the mean of the last five steps below that of the first five; of the
    last two below the first two in a run of five; not asked with
    ``falls=False``; a step of ``nan_steps``, 1-based, may have a NaN
    loss) and
    ``per_step`` launches of each kernel a step, none of the others; with
    ``scale``, every step's loss scale equal to it.  ``out``, a dict,
    receives the step records, the median step time and the peak
    memory."""
    path = os.path.join(ROOT, "build", f"chip_smoke_{label}.jsonl")
    args = train.build_parser().parse_args(argv + ["--metrics-jsonl", path])
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(counted)
    t0 = time.perf_counter()
    rc = train.run_train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(counted)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(path) as fh:
        records = [json.loads(line) for line in fh]
    steps = [r for r in records if r["record"] == "step"]
    n = len(steps)
    losses = [r["loss"] for r in steps]
    times = [r["step_time_ms"] for r in steps]
    steady = statistics.median(times[1:]) if n > 1 else float("nan")
    image = train.is_image(args)
    items = args.batch_size * (1 if image else args.seq_len)
    unit = "img/s" if image else "tokens/s"
    ppl = (f"  ppl first/last {steps[0]['ppl']:.1f}/{steps[-1]['ppl']:.1f}"
           if steps and "ppl" in steps[0] else "")
    w = min(5, n // 2)        # the first and last w steps' mean losses
    print(f"{label}: {args.arch} {n} steps  loss first/last {losses[0]:.4f}/"
          f"{losses[-1]:.4f}  mean steps 1-{w} "
          f"{statistics.fmean(losses[:w]):.4f}  mean steps {n - w + 1}-{n} "
          f"{statistics.fmean(losses[-w:]):.4f}{ppl}  grad norm first/last "
          f"{steps[0]['grad_norm']:.4f}/{steps[-1]['grad_norm']:.4f}")
    print(f"{label}: step time median {steady:.2f} ms (steps 2-{n})  first "
          f"step {times[0]:.2f} ms  {unit} {items / steady * 1e3:.1f}  "
          f"wall {wall:.1f} s  max memory {peak_gib:.2f} GiB")
    scales = sorted({r["scale"] for r in steps})
    if scale is not None:
        print(f"{label}: loss scale over the run {scales} (want {scale})")
    want = dict.fromkeys(counted, 0)
    want.update({k: v * n for k, v in per_step.items()})
    print(f"{label}: launches a step "
          f"{ {k: v / n for k, v in counts.items() if v} } (want "
          f"{per_step}); over the run {counts} (want {want})")
    if rc != 0 or n != args.steps_per_epoch:
        raise SystemExit(f"{label} run: rc {rc}, {n} step records (want "
                         f"{args.steps_per_epoch})")
    if not all(math.isfinite(x) for i, x in enumerate(losses)
               if i + 1 not in nan_steps):
        raise SystemExit(f"{label} loss is not finite: {losses}")
    if falls and not statistics.fmean(losses[-w:]) < statistics.fmean(
            losses[:w]):
        raise SystemExit(f"{label} loss did not fall over {n} steps")
    if counts != want:
        raise SystemExit(f"kernel launches per step off: {counts}")
    if scale is not None and scales != [scale]:
        raise SystemExit(f"{label} loss scale moved: {scales}")
    if out is not None:
        out.update(steps=steps, step_ms=steady, peak_gib=peak_gib)
    return counts


def phase_c2(train, counted, per_step, out=None):
    """C2 through the trainer at batch 256, or at 128 where 256 runs out of
    device memory (printed as a cut).  Returns the counts and the argv."""
    argv = list(C2_ARGS)
    try:
        return phase_train(train, counted, "c2", argv, per_step,
                           out=out), argv
    except torch.cuda.OutOfMemoryError as exc:
        print(f"c2: batch 256 does not fit in the card's memory ({exc}); "
              f"CUT: halved to 128")
    torch.cuda.empty_cache()
    argv[argv.index("--batch-size") + 1] = "128"
    return phase_train(train, counted, "c2", argv, per_step,
                       out=out), argv


def _loss(train, args, model, batch, mems):
    """The loss of one forward of ``args``'s model in train mode on
    ``batch`` (the memory ``mems`` for Transformer-XL), outside the
    trainer's step: for a backward that only warms the card up (cuDNN's
    algorithms, Transformer-XL's encodings), or for grads alone."""
    from apex_example_tpu_torch.workloads import lm_loss, mlm_loss
    x, y = batch
    model.train()
    if train.is_image(args):
        return torch.nn.functional.cross_entropy(model(x).float(), y)
    if train.is_txl(args):
        return lm_loss(model(x, mems)[0], y)
    return (mlm_loss if args.arch.startswith("bert") else lm_loss)(
        model(x), y)


def phase_overflow_drill(train, counted, per_step, label="dynamic",
                         argv=DYN_ARGS, first=False,
                         plant=lambda model: model.fc.bias,
                         plant_name="fc.bias"):
    """Dynamic loss scaling through the library: an inf planted in one grad
    (a hook on the parameter ``plant`` picks: the classifier's bias, or an
    LM's) must skip the step with no host sync: the parameters, the
    optimizer's state (its state dict: momentum, moments, sums of squares)
    and its step count bitwise unchanged, the scale halved, ``per_step``
    launches; the next clean step moves them.  Transformer-XL's memory is
    carried through the three steps.
    The inf lands after one clean step, or (``first``) on the optimizer's
    very first step, after a forward and backward that only warm the card
    up: then the next clean step is the optimizer's first (count 1), and
    NovoGrad's second moments are that step's squared grad norms exactly
    (its first-step branch, taken from the count on the card)."""
    from apex_example_tpu_torch.ops import multi_tensor as mt
    args = train.build_parser().parse_args(argv)
    state = train.build_state(args, "cuda")
    model, opt = state.model, state.optimizer
    step_fn, mems = _step_fn(train, args, model)
    batches = [train.batch_fn(args, getattr(model, "vocab_size", 0), i,
                              "cuda") for i in range(3)]

    def step(state, batch):
        nonlocal mems
        if mems is None:
            return step_fn(state, batch)
        state, mems, metrics = step_fn(state, mems, batch)
        return state, metrics

    if first:
        _loss(train, args, model, batches[0], mems).backward()
        opt.zero_grad()
    else:
        state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in opt.params]
    saved = opt.state_dict()
    count0, scale0 = saved["step"], float(state.scaler.scale)
    param = plant(model)
    planted = torch.zeros_like(param)
    planted.view(-1)[7 % planted.numel()] = float("inf")
    hook = param.register_hook(lambda g: g + planted)
    _zero_counts(counted)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
        hook.remove()
    torch.cuda.synchronize()
    counts = _counts(counted)
    after = opt.state_dict()
    kept = (all(torch.equal(a, b) for a, b in zip(opt.params, before))
            and all(torch.equal(a, b) for name in saved if name != "step"
                    for a, b in zip(after[name], saved[name])))
    count1, scale1 = after["step"], float(state.scaler.scale)
    finite = float(metrics["grads_finite"])
    state, _ = step(state, batches[2])
    torch.cuda.synchronize()
    moved = not all(torch.equal(a, b) for a, b in zip(opt.params, before))
    count2, scale2 = opt.step_count, float(state.scaler.scale)
    first_txt, first_ok = "", True
    if first and hasattr(opt, "_v"):        # NovoGrad's second moments
        _, sq = mt.multi_tensor_l2norm_cuda(opt.tables[0], 1)
        first_ok = torch.equal(torch.stack(opt.nu), sq)
        first_txt = (f", second moments equal to its squared grad norms "
                     f"(the first-step branch): {first_ok}")
    want = dict.fromkeys(counted, 0)
    want.update(per_step)
    print(f"{label}: overflow drill ({args.arch} {args.opt_level}, "
          f"{type(opt).__name__}, inf planted in {plant_name}'s grad"
          f"{' on the first step' if first else ''}, no host sync allowed): "
          f"grads_finite {finite}  parameters and optimizer state bitwise "
          f"unchanged: {kept}  step count {count0} -> {count1}  scale "
          f"{scale0:g} -> {scale1:g}  launches {counts}; next clean step: "
          f"parameters moved {moved}, step count {count2}, scale "
          f"{scale2:g}{first_txt}")
    if not (kept and finite == 0.0 and count1 == count0
            and scale1 == scale0 / 2 and counts == want and moved
            and count2 == count0 + 1 and scale2 == scale1 and first_ok):
        raise SystemExit(f"the {label} overflow step was not skipped as the "
                         f"JAX step skips it")
    del state, model, opt
    torch.cuda.empty_cache()


def _first_grads(train, argv, dev, batch):
    """The grads of the first loss of ``argv``'s model (fresh weights from
    its seed) on ``batch`` (numpy) on ``dev``, fp32 on the CPU."""
    args = train.build_parser().parse_args(argv)
    model = train.build_state(args, dev).model
    x, *rest = (torch.from_numpy(a).to(dev) for a in batch)
    mems = model.init_mems(x.shape[0]) if train.is_txl(args) else None
    _loss(train, args, model, (x, tuple(rest) if len(rest) > 1 else rest[0]),
          mems).backward()
    grads = {k: p.grad.float().cpu() for k, p in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    return grads


def _kind(name):
    """A parameter's kind: its name without layer indices."""
    return ".".join(w for w in name.split(".") if not w.isdigit())


def phase_o2_first_step(train, label, argv, batch):
    """The first O2 grads of ``argv``'s model against its fp32 (O0) grads
    from the same weights, on the card and on the CPU: by kind of
    parameter, the card's |O2 - fp32| / |fp32| no more than twice the
    CPU's plus 1e-3 (bf16 rounds at other places on the two devices; the
    key projections' biases, whose exact gradient is zero, aside)."""
    o2 = argv + ["--opt-level", "O2"]
    dist = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        g16 = _first_grads(train, o2, dev, batch)
        g32 = _first_grads(train, argv, dev, batch)
        sums = {}
        for k, g in g32.items():
            acc = sums.setdefault(_kind(k), [0.0, 0.0])
            acc[0] += float(((g16[k] - g) ** 2).sum())
            acc[1] += float((g ** 2).sum())
        dist[dev] = {n: math.sqrt(a / max(b, 1e-30))
                     for n, (a, b) in sums.items()}
        print(f"{label}: first O2 step on {dev}: grads O2 vs fp32 "
              f"({time.perf_counter() - t0:.1f} s)")
    kinds = [n for n in dist["cpu"] if not n.endswith("key.bias")]
    worst = sorted(kinds, key=lambda n: dist["cuda"][n] / max(
        dist["cpu"][n], 1e-30), reverse=True)[:4]
    ok = all(dist["cuda"][n] <= 2 * dist["cpu"][n] + 1e-3 for n in kinds)
    print(f"{label}: |O2 grad - fp32 grad| / |fp32 grad| by kind, card vs "
          f"CPU (limit 2 x the CPU's + 1e-3), the largest ratios: "
          + "; ".join(f"{n} {dist['cuda'][n]:.3e} {dist['cpu'][n]:.3e}"
                      for n in worst)
          + f"  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(f"the card's first {label} O2 step is further "
                         f"from fp32 than twice the CPU's")


def phase_bn_share(train, argv, sync_batchnorm_cls, busy_ms):
    """Each BatchNorm input of one step of ``argv``'s model, timed alone
    through the composite branch, forward and backward; the sum against
    the step's device busy time ``busy_ms`` (from the profile); and the
    same through the fused_kernel branch."""
    args = train.build_parser().parse_args(argv)
    state = train.build_state(args, "cuda")
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append((tuple(inp[0].shape), inp[0].dtype,
                                      mod.dtype, mod.stats_dtype)))
             for m in state.model.modules()
             if isinstance(m, sync_batchnorm_cls)]
    train.build_step(args)(state, train.batch_fn(args, 0, 0, "cuda"))
    for h in hooks:
        h.remove()
    del state
    torch.cuda.empty_cache()
    total, shapes = {False: 0.0, True: 0.0}, {}
    for key in seen:
        shapes[key] = shapes.get(key, 0) + 1
    for (shape, dtype, io, stats), count in shapes.items():
        x = torch.randn(shape, device="cuda").to(dtype).requires_grad_()
        dy = torch.randn(shape, device="cuda").to(io)
        for fused in total:
            m = sync_batchnorm_cls(shape[-1], dtype=io, stats_dtype=stats,
                                   fused_kernel=fused, device="cuda")
            total[fused] += count * _device_ms(lambda: m(x).backward(dy),
                                               reps=10, warmup=2)
        del x, dy
    torch.cuda.empty_cache()
    print(f"profile: {len(seen)} BatchNorm calls a {args.arch} step "
          f"({len(shapes)} shapes), forward and backward timed alone: the "
          f"composite branch {total[False]:.2f} ms a step, "
          f"{total[False] / busy_ms:.1%} of the profiled step's device busy "
          f"time ({busy_ms:.2f} ms); the fused_kernel branch "
          f"{total[True]:.2f} ms")


KERNEL_GROUPS = (            # device-time categories, first match wins
    ("collectives (NCCL)", ("nccl",)),
    ("ported: sgd", ("sgd_chunks",)),
    ("ported: layer_norm fwd", ("ln_fwd_kernel",)),
    ("ported: layer_norm bwd", ("ln_bwd_persist_kernel", "ln_bwd_kernel",
                                "ln_bwd_colsum")),
    ("ported: batch_norm sums", ("bn_sums_kernel",)),
    ("ported: multi_tensor_l2norm", ("sqsum_chunks", "global_norm",
                                     "tensor_sums")),
    ("ported: lamb stages", ("lamb1_chunks", "trust_ratio",
                             "lamb2_chunks")),
    ("ported: adam", ("adam_chunks",)),
    ("ported: novograd", ("novograd_chunks", "novograd_moment")),
    ("ported: adagrad", ("adagrad_chunks",)),
    ("ported: axpby", ("axpby_chunks",)),
    ("ported: attention", ("attn_fwd_kernel", "attn_dkdv_kernel",
                           "attn_dq_kernel")),
    ("ported: multi_tensor_scale", ("scale_chunks",)),
    ("convolutions", ("fprop", "dgrad", "wgrad", "conv", "winograd",
                      "nhwc", "nchw", "implicit")),
    ("matrix products", ("gemm", "cutlass", "xmma", "cublas")),
    ("softmax", ("softmax",)),
    ("embedding", ("embedding",)),
    ("reductions", ("reduce_kernel",)),
    ("memset, memcpy", ("memset", "memcpy")),
)


def _group(name):
    low = name.lower()
    for label, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return label
    return "other elementwise"


def _mfu_line(train, label, args, model, step_ms):
    """``label``'s model FLOPs utilisation at ``step_ms`` a step, from
    utils/flops (the card's peak for the run's product dtype)."""
    from apex_example_tpu_torch.utils import flops
    if train.is_image(args):
        spec = train.DATASETS[args.dataset]
        per_item = flops.resnet_train_flops_per_image(
            args.arch, spec["image_size"], spec["num_classes"])
        items, unit = args.batch_size, "image"
    else:
        per_item = flops.model_train_flops_per_token(model, args.seq_len)
        items, unit = args.batch_size * args.seq_len, "token"
    dtype = torch.float32 if args.opt_level == "O0" else torch.bfloat16
    peak = flops.device_peak_flops(dtype)
    rate = items / step_ms * 1e3
    print(f"{label}: MFU {flops.mfu_pct(rate, per_item, peak):.2f}% of the "
          f"card's {str(dtype).replace('torch.', '')} peak "
          f"({peak / 1e12:.1f} TFLOP/s): {per_item / 1e9:.4f} GFLOP a "
          f"trained {unit}, {per_item * items / 1e12:.3f} TFLOP a step at "
          f"{step_ms:.2f} ms (utils/flops)")


def phase_profile(train, argv, steps=3, mfu=None):
    """torch.profiler over a few train steps of the model ``argv`` names:
    device time by kernel group, and the share of the window the device sat
    idle.  With ``mfu`` (label, step ms of the trainer's run), that run's
    MFU first.  Returns the device busy time a step (ms), None without
    device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = train.build_parser().parse_args(argv)
    state = train.build_state(args, "cuda")
    model = state.model
    if mfu is not None:
        _mfu_line(train, mfu[0], args, model, mfu[1])
    step_fn, mems = _step_fn(train, args, model)
    batches = [train.batch_fn(args, getattr(model, "vocab_size", 0), i,
                              "cuda") for i in range(steps + 2)]

    def run(state, mems, batch):
        if mems is None:
            return step_fn(state, batch) + (None,)
        state, mems, metrics = step_fn(state, mems, batch)
        return state, metrics, mems

    for b in batches[:2]:
        state, _, mems = run(state, mems, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            state, metrics, mems = run(state, mems, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print("profile: the profiler recorded no device events")
        return None
    busy, end = 0.0, spans[0][0]
    by_group, by_name = {}, {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_group[_group(name)] = by_group.get(_group(name), 0.0) + (b - a)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    window = spans[-1][1] - spans[0][0]
    total = sum(by_group.values())
    print(f"profile: {steps} {args.arch} steps: host wall {wall_ms:.2f} ms "
          f"({wall_ms / steps:.2f} ms a step)  device window "
          f"{window / 1e3:.2f} ms  device busy {busy / 1e3:.2f} ms  idle "
          f"share {1 - busy / window:.4f}  {len(spans)} device events "
          f"({len(spans) // steps} a step)")
    for label, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"profile:   {label:30s} {us / 1e3 / steps:9.3f} ms a step  "
              f"{us / total:7.2%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile:   top kernel {us / 1e3 / steps:8.3f} ms a step  "
              f"{name[:90]}")
    norm_bwd = {}
    for a, b, name in spans:
        m = re.search(r"ln_bwd_\w*kernel", name)
        if m:
            n_us = norm_bwd.setdefault(m.group(0), [0, 0.0])
            n_us[0] += 1
            n_us[1] += b - a
    if norm_bwd:
        print(f"profile: {args.arch} norm backward a step: " + "  ".join(
            f"{k} {n // steps} launches {us / 1e3 / steps:.3f} ms"
            for k, (n, us) in sorted(norm_bwd.items())))
    if "ln_bwd_colsum_kernel" in norm_bwd:
        raise SystemExit(f"profile: {args.arch}'s norm backward took a "
                         f"second launch (ln_bwd_colsum_kernel)")
    attn = by_group.get("ported: attention", 0.0)
    if attn:
        print(f"profile: {args.arch} {args.opt_level}: the attention "
              f"kernels {attn / 1e3 / steps:.3f} ms a step, "
              f"{attn / busy:.2%} of the device busy time")
    del state, model
    torch.cuda.empty_cache()
    return busy / 1e3 / steps


def _step_fn(train, args, model):
    """The trainer's step for ``args`` and the memory it starts from (None
    but for Transformer-XL)."""
    return train.build_step(args), (model.init_mems(args.batch_size)
                                    if train.is_txl(args) else None)


def one_step(train, args, dev, batch, perturb=0.0):
    """One train step of freshly built weights on ``dev`` (the first
    parameter, the word embedding or the stem's convolution, scaled by 1 +
    ``perturb``); ``batch`` is
    the step's numpy arrays.  Returns (loss, grad norm, parameters after
    the step, largest update, the new memory or None, the clipped grads),
    the tensors on the CPU.  On the card the step's convolutions are
    cuDNN's deterministic ones, picked without timing: the algorithms
    ``cudnn.benchmark`` times vary from run to run, and with them which
    ReLU inputs within rounding of zero pass."""
    state = train.build_state(args, dev)
    cudnn = torch.backends.cudnn
    timed = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        return _one_step(train, args, state, dev, batch, perturb)
    finally:
        cudnn.benchmark, cudnn.deterministic = timed


def _one_step(train, args, state, dev, batch, perturb):
    model = state.model
    if perturb:
        with torch.no_grad():
            next(model.parameters()).mul_(1.0 + perturb)
    init = {k: p.detach().to("cpu", copy=True)
            for k, p in model.named_parameters()}
    step_fn, mems = _step_fn(train, args, model)
    arrays = [torch.from_numpy(a).to(dev) for a in batch]
    if mems is None:
        ids, *target = arrays
        target = tuple(target) if len(target) > 1 else target[0]
        state, metrics = step_fn(state, (ids, target))
    else:
        mems = model.init_mems(len(batch[0]))
        state, mems, metrics = step_fn(state, mems, tuple(arrays))
        mems = mems.cpu()
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    params = {k: p.detach().cpu() for k, p in model.named_parameters()}
    update = max(float((params[k] - init[k]).abs().max()) for k in init)
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return loss, gnorm, params, update, mems, grads


def _grad_differences(grads, above, params):
    """By kind of parameter (its name without layer and block indices,
    ``layers.3.ff.weight`` -> ``layers.ff.weight``, ``Bottleneck_3.Conv_1
    .weight`` -> ``Bottleneck.Conv.weight``): |card -
    CPU| / |CPU| and |floor - CPU| / |CPU| over the clipped grads, the
    elements beyond 1e-5 after the step, and the elements."""
    sums = {}
    for k, g in grads["cpu"].items():
        name = ".".join(re.sub(r"_\d+$", "", w) for w in k.split(".")
                        if not w.isdigit())
        acc = sums.setdefault(name, [0.0, 0.0, 0.0, 0, 0])
        acc[0] += float(((grads["cuda"][k] - g) ** 2).sum())
        acc[1] += float(((grads["floor"][k] - g) ** 2).sum())
        acc[2] += float((g ** 2).sum())
        acc[3] += above[k]
        acc[4] += params[k].numel()
    return {n: (math.sqrt(a / max(n2, 1e-30)), math.sqrt(b / max(n2, 1e-30)),
                c, e) for n, (a, b, n2, c, e) in sums.items()}


def phase_cross_check(train, counted, label, argv, batch, want,
                      mems_tol=None, flip_lr=None, zero_grad_lr=None):
    """One step of the same weights on one small batch, on the card (the
    kernels, launched ``want`` times) and on the CPU (the plain versions,
    no launch): loss rtol 1e-5, grad norm rtol 1e-4, every parameter atol
    1e-5 and, with ``mems_tol``, the new memory within it (rtol = atol).

    ``zero_grad_lr`` (NovoGrad's lr): the key projections' biases have a
    gradient of zero in exact arithmetic (softmax ignores a shift common to
    a row's logits), so each device's is rounding noise, and NovoGrad
    normalises each tensor's gradient by its norm: the noise becomes a step
    of up to lr in a direction of its own on each device.  Those biases'
    elements are held to 2 lr, and their gradients must be that noise on
    both devices: each below NOISE_TOL of the same layer's query-bias
    gradient.

    ``flip_lr`` (a ReLU model trained with Adam): a ReLU input within fp32
    rounding of zero passes on one device and not on the other; that
    moves the gradients of everything below it by ~1e-3 of their norm.
    The run measures this floor on the CPU alone, against a step whose
    first parameter (the word embedding, the stem's convolution) is scaled
    by 1 + 1e-6, and the limits are FLOOR_X
    times it: each kind of parameter's clipped grads within FLOOR_X times
    the floor's relative difference for that kind; and since Adam's first
    step moves an element by lr * g / (|g| + eps), about lr whatever g's
    size, an element whose small gradient changes sign moves 2 lr: every
    parameter element within 2 lr + 1e-5, and no more than FLOOR_X times
    as many elements beyond 1e-5 as the floor's step has."""
    args = train.build_parser().parse_args(argv)
    got = {}
    full = dict.fromkeys(counted, 0)
    full.update(want)
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _zero_counts(counted)
        got[dev] = one_step(train, args, dev, batch)
        loss, gnorm, _, update, _, _ = got[dev]
        counts = _counts(counted)
        print(f"{label}: cross-check on {dev}: loss {loss!r} grad norm "
              f"{gnorm!r} largest update {update:.3g}  kernel launches "
              f"{counts}  ({time.perf_counter() - t0:.1f} s)")
        if counts != (full if dev == "cuda" else dict.fromkeys(full, 0)):
            raise SystemExit(f"the {dev} step launched {counts}")
        torch.cuda.empty_cache()
    (l_g, n_g, p_g, _, m_g, g_g), (l_c, n_c, p_c, _, m_c, g_c) = \
        got["cuda"], got["cpu"]
    p_errs = {k: float((p_g[k] - p_c[k]).abs().max()) for k in p_c}
    noise = [k for k in p_c if zero_grad_lr is not None and "key.bias" in k]
    p_err = max(v for k, v in p_errs.items() if k not in noise)
    z_txt, z_ok = "", True
    if noise:
        z_err = max(p_errs[k] for k in noise)
        z_rel = max(float(g[k].norm() / g[k.replace("key.bias",
                                                    "query.bias")].norm())
                    for g in (g_g, g_c) for k in noise)
        z_ok = z_err <= 2 * zero_grad_lr and z_rel <= NOISE_TOL
        z_txt = (f"  the {len(noise)} key biases (zero exact gradient): "
                 f"max|dparam| {z_err:.3g} (limit 2 lr = "
                 f"{2 * zero_grad_lr:g}), largest |grad| / |query-bias "
                 f"grad| on either device {z_rel:.3g} (limit "
                 f"{NOISE_TOL:g})")
    above = {k: int(((p_g[k] - p_c[k]).abs() > 1e-5).sum()) for k in p_c}
    n_above, n_all = sum(above.values()), sum(t.numel() for t in p_c.values())
    worst = sorted((k for k in p_errs if k not in noise), key=p_errs.get,
                   reverse=True)[:3]

    def where(k):
        far = (p_g[k] - p_c[k]).abs() > 1e-5
        rows = (f" in {int(far.any(1).sum())} rows"
                if far.dim() == 2 and far.any() else "")
        return f"{k} {p_errs[k]:.3g} ({above[k]} of {p_c[k].numel()}{rows})"
    print(f"{label}: {n_above} of {n_all} parameter elements differ by more "
          f"than 1e-5; largest in " + ", ".join(where(k) for k in worst))
    l_ok = abs(l_g - l_c) <= 1e-5 * abs(l_c)
    n_ok = abs(n_g - n_c) <= 1e-4 * abs(n_c)
    if flip_lr is None:
        p_ok, p_txt = p_err <= 1e-5, "atol 1e-5"
    else:
        t0 = time.perf_counter()
        _, _, p_f, _, _, g_f = one_step(train, args, "cpu", batch,
                                        perturb=1e-6)
        n_floor = sum(int(((p_f[k] - p_c[k]).abs() > 1e-5).sum())
                      for k in p_c)
        f_err = max(float((p_f[k] - p_c[k]).abs().max()) for k in p_c)
        kinds = _grad_differences(
            {"cuda": g_g, "cpu": g_c, "floor": g_f}, above, p_c)
        print(f"{label}: the floor, CPU vs CPU with the first parameter "
              f"x (1 + 1e-6): {n_floor} of {n_all} parameter elements "
              f"differ by more than 1e-5, max|dparam| {f_err:.3g} "
              f"({time.perf_counter() - t0:.1f} s)")
        print(f"{label}: by kind of parameter, |grad difference| / |grad| "
              f"card vs CPU, the floor's, card over floor, and elements "
              f"beyond 1e-5: " + "; ".join(
                  f"{n} {a:.2e} {b:.2e} {a / max(b, 1e-30):.2f} {c}/{e}"
                  for n, (a, b, c, e) in kinds.items()))
        p_ok = (p_err <= 2 * flip_lr + 1e-5
                and n_above <= FLOOR_X * n_floor
                and all(a <= FLOOR_X * b for a, b, _, _ in kinds.values()))
        p_txt = (f"atol 1e-5, or 2 lr + 1e-5 for at most {FLOOR_X} x the "
                 f"floor's {n_floor} elements; each kind's grads within "
                 f"{FLOOR_X} x the floor's difference")
    m_txt, m_ok = "", True
    if mems_tol is not None:
        m_err, m_ok = _close(m_g, m_c, mems_tol, mems_tol)
        m_txt = f"  max|dmems| {m_err:.3g} (rtol = atol {mems_tol:g})"
    good = l_ok and n_ok and p_ok and m_ok and z_ok
    print(f"{label}: card vs CPU after one step: |dloss| "
          f"{abs(l_g - l_c):.3g} (rtol 1e-5)  |dgrad norm| "
          f"{abs(n_g - n_c):.3g} (rtol 1e-4)  max|dparam| {p_err:.3g} "
          f"({p_txt}){m_txt}{z_txt}  {'ok' if good else 'MISMATCH'}")
    if not good:
        raise SystemExit(f"the card's first {label} step disagrees with "
                         f"the CPU's")


def phase_route_cross_check(counted, lm_batch):
    """gpt_base at full width, sequence 2048, batch 2, fp32: the loss and
    every gradient of one step through the flash-attention kernels and
    through the dense einsum path, both on the card.  Loss rtol 1e-5; each
    gradient within ROUTE_TOL of its norm, but the key projections' biases,
    whose exact gradient is zero (softmax ignores a shift common to a
    row's logits): their rounding noise is held to ROUTE_TOL of the same
    layer's query-bias gradient."""
    from apex_example_tpu_torch.models.gpt import gpt_base
    from apex_example_tpu_torch.workloads import lm_loss
    toks = lm_batch(0, batch_size=2, seq_len=2048, vocab_size=30522, seed=0)
    ids, tgt = (torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                for a in (toks[:, :-1], toks[:, 1:]))
    got = {}
    for fused in (True, False):
        model = gpt_base(seed=0, device="cuda", max_position=2048,
                         fused_attention=fused)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(counted)
        t0 = time.perf_counter()
        loss = lm_loss(model(ids), tgt)
        loss.backward()
        torch.cuda.synchronize()
        counts = _counts(counted)
        route = "flash" if fused else "dense"
        loss = float(loss.detach())
        print(f"route: gpt_base 2 x 2048 fp32 {route} step: loss "
              f"{loss!r}  {time.perf_counter() - t0:.2f} s  max "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
              f"launches {counts}")
        want = 12 if fused else 0
        if any(counts[k] != want for k in ("attn_fwd", "attn_dkdv",
                                           "attn_dq")):
            raise SystemExit(f"the {route} step launched {counts}")
        got[route] = (loss, {n: p.grad for n, p in
                             model.named_parameters()})
        del model, loss
        torch.cuda.empty_cache()
    (l_f, g_f), (l_d, g_d) = got["flash"], got["dense"]
    rel = {}
    for name, gd in g_d.items():
        ref = g_d[name.replace("key.bias", "query.bias")]
        rel[name] = float((g_f[name] - gd).norm() / ref.norm())
    worst = sorted(rel, key=rel.get, reverse=True)[:4]
    l_ok = abs(l_f - l_d) <= 1e-5 * abs(l_d)
    g_ok = max(rel.values()) <= ROUTE_TOL
    print(f"route: flash vs dense: |dloss| {abs(l_f - l_d):.3g} (rtol 1e-5)"
          f"  largest |dgrad| / |grad| over {len(rel)} tensors "
          + ", ".join(f"{n} {rel[n]:.3g}" for n in worst)
          + f" (limit {ROUTE_TOL:g})  {'ok' if l_ok and g_ok else 'MISMATCH'}")
    if not (l_ok and g_ok):
        raise SystemExit("the flash and dense routes disagree")


def phase_route_times(train, counted, steps=6):
    """gpt_base at 8 x 2048 under amp O2, the trainer's state and step,
    once with the attention modules on the flash kernels and once on the
    dense einsum path (``fused_attention`` True / False; "auto" takes the
    kernels at 2048): the median step time over steps 2..N and the peak
    memory of each, on one line (a dense route that does not fit is
    printed so).  The flash route launches each attention kernel 12 times
    a step, the dense route none."""
    args = train.build_parser().parse_args(GPT2048_O2_ARGS)
    step_fn = train.build_step(args)
    text = []
    for fused in (True, False):
        route = "flash" if fused else "dense"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = train.build_state(args, "cuda")
        for mod in state.model.modules():
            if hasattr(mod, "fused_attention"):
                mod.fused_attention = fused
        _zero_counts(counted)
        times = []
        try:
            for i in range(steps):
                batch = train.batch_fn(args, state.model.vocab_size, i,
                                       "cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        except torch.cuda.OutOfMemoryError as exc:
            if fused:   # the kernels' route must fit; the dense one may not
                raise
            text.append(f"{route} does not fit in the card's memory ({exc})")
            del state
            continue
        counts = _counts(counted)
        want = 12 * steps if fused else 0
        if any(counts[k] != want for k in ("attn_fwd", "attn_dkdv",
                                           "attn_dq")):
            raise SystemExit(f"the {route} route launched {counts}")
        if not math.isfinite(loss):
            raise SystemExit(f"the {route} route's loss is {loss}")
        text.append(f"{route} {statistics.median(times[1:]):.2f} ms a step "
                    f"(median of steps 2-{steps}), max memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                    f"last loss {loss:.4f}")
        del state, metrics
    torch.cuda.empty_cache()
    print("route: gpt_base 8 x 2048 amp O2, the trainer's step: "
          + "; ".join(text))



# ---------------------------------------------------------------------------
# data parallelism (C3): ddp, launch, ddp2
# ---------------------------------------------------------------------------

def _counted_kernels():
    """Every kernel wrapper chip_smoke counts, by name: each adds one to
    its ``launches`` where it launches its kernel, and nowhere else."""
    from apex_example_tpu_torch.ops import attention as att
    from apex_example_tpu_torch.ops import batch_norm as bn
    from apex_example_tpu_torch.ops import fused_optim as fo
    from apex_example_tpu_torch.ops import layer_norm as ln
    from apex_example_tpu_torch.ops import multi_tensor as mt
    return {"layer_norm_fwd": ln.layer_norm_cuda,
            "layer_norm_bwd": ln.layer_norm_bwd_cuda,
            "multi_tensor_l2norm": mt.multi_tensor_l2norm_cuda,
            "lamb_stage1": fo.lamb_stage1_cuda,
            "lamb_stage2": fo.lamb_stage2_cuda,
            "adam": fo.adam_cuda,
            "multi_tensor_scale": mt.multi_tensor_scale_cuda,
            "sgd": fo.sgd_cuda,
            "bn_stats": bn.bn_stats_cuda,
            "bn_bwd_sums": bn.bn_bwd_sums_cuda,
            "attn_fwd": att.flash_attention_cuda,
            "attn_dkdv": att.flash_attention_dkdv_cuda,
            "attn_dq": att.flash_attention_dq_cuda,
            "novograd": fo.novograd_cuda,
            "adagrad": fo.adagrad_cuda,
            "axpby": mt.multi_tensor_axpby_cuda,
            "rms_norm_fwd": ln.rms_norm_cuda,
            "rms_norm_bwd": ln.rms_norm_bwd_cuda}


def _deterministic_convolutions():
    """cuDNN's deterministic convolutions, chosen without timing (after
    ``create_train_state``, which turns the timing on)."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def _timed_convolutions():
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = False


def _fresh(path):
    """``path`` for a FileStore: its directory there, the file gone
    before the group starts."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    return path


def _ddp_first_step(train, args, mesh):
    """One step of C3 (``args``: DDP_ARGS, O2, batch 256), the same
    weights and batch, through the plain c2 step and through the
    data-parallel step (NCCL group of 1, SyncBatchNorm's all-reduces, the
    grads' all-reduce), all with deterministic convolutions: loss rtol
    1e-5, grad norm rtol 1e-4, every parameter within atol 1e-5 or
    FLOOR_X times the floor, whichever is larger.  The floor is the
    largest parameter difference of the plain step against itself with
    the stem's convolution scaled by 1 + 1e-6, measured here: at O2 a
    bf16 rounding that moves by one ulp moves a parameter by up to lr
    times a grad's rounding, as in ``_ddp2_image``.  At world 1 the two
    steps do the same arithmetic, so the line also says whether they
    agreed bit for bit."""
    from apex_example_tpu_torch.engine import make_sharded_train_step
    from apex_example_tpu_torch.parallel import convert_syncbn_model
    out = {}
    for label, perturb in (("plain", 0.0), ("floor", 1e-6), ("ddp", 0.0)):
        state = train.build_state(args, "cuda")
        if perturb:
            with torch.no_grad():
                next(state.model.parameters()).mul_(1.0 + perturb)
        if label == "ddp":
            convert_syncbn_model(state.model, mesh)
            step = make_sharded_train_step(mesh)
        else:
            step = train.build_step(args)
        _deterministic_convolutions()
        try:
            state, met = step(state, train.batch_fn(args, 0, 0, "cuda"))
            out[label] = (float(met["loss"]), float(met["grad_norm"]),
                          {k: p.detach().float().cpu() for k, p in
                           state.model.named_parameters()})
        finally:
            _timed_convolutions()
        del state, step
        torch.cuda.empty_cache()
    (l_p, n_p, p_p), (l_d, n_d, p_d) = out["plain"], out["ddp"]
    p_err = max(float((p_d[k] - p_p[k]).abs().max()) for k in p_p)
    f_err = max(float((out["floor"][2][k] - p_p[k]).abs().max())
                for k in p_p)
    limit = max(1e-5, FLOOR_X * f_err)
    same = l_d == l_p and n_d == n_p and p_err == 0.0
    ok = (abs(l_d - l_p) <= 1e-5 * abs(l_p) and abs(n_d - n_p) <= 1e-4 *
          abs(n_p) and p_err <= limit)
    print(f"ddp: first step at {args.opt_level}, batch {args.batch_size}, "
          f"against the plain c2 step (deterministic convolutions): loss "
          f"{l_d!r} / {l_p!r}  grad norm {n_d!r} / {n_p!r}  max|dparam| "
          f"{p_err:.3g} (loss rtol 1e-5, grad norm rtol 1e-4, limit "
          f"{limit:.3g}: the floor {f_err:.3g})  "
          f"{'bit for bit' if same else 'not bit for bit'}  "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("ddp: the data-parallel step at world 1 disagrees "
                         "with the plain step")


def _nccl_ms(train, args, state, step, mesh, steps=3):
    """torch.profiler over ``steps`` data-parallel steps: the NCCL
    kernels' device time a step and the device busy time a step (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches = [train.batch_fn(args, 0, 100 + i, "cuda", mesh.rank,
                              mesh.world) for i in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA)
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name == "c10d::allreduce_"]
    host_ms = sum(e.time_range.end - e.time_range.start
                  for e in host) / 1e3 / steps
    if not spans:
        return None, None, 0, host_ms, len(host) // steps
    busy, end, nccl, n_nccl = 0.0, spans[0][0], 0.0, 0
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        if "nccl" in name.lower():
            nccl += b - a
            n_nccl += 1
    return (nccl / 1e3 / steps, busy / 1e3 / steps, n_nccl // steps,
            host_ms, len(host) // steps)


def phase_ddp(train, counted, per_step):
    """C3 through the library: resnet50 on ImageNet shapes at amp O2 with
    FusedSGD and SyncBatchNorm (composite), global batch 256, in an NCCL
    group of one process (this one, a FileStore under build/), through
    ``make_sharded_train_step``: 20 steps (finite and falling losses,
    ``per_step`` launches a step), img/s, the median step time, the first
    step's, peak memory and the NCCL kernels' device time a step
    (profiler); first the step against the plain c2 step."""
    import torch.distributed as dist
    from apex_example_tpu_torch.engine import make_sharded_train_step
    from apex_example_tpu_torch.parallel import (convert_syncbn_model,
                                                 make_data_mesh)
    store = _fresh(os.path.join(ROOT, "build", "chip_smoke_nccl_store"))
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_data_mesh()
        args = train.build_parser().parse_args(DDP_ARGS)
        _ddp_first_step(train, args, mesh)
        state = train.build_state(args, "cuda")
        convert_syncbn_model(state.model, mesh)
        step = make_sharded_train_step(mesh)
        n = args.steps_per_epoch
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(counted)
        times, losses = [], []
        for i in range(n):
            batch = train.batch_fn(args, 0, i, "cuda", mesh.rank, mesh.world)
            t0 = time.perf_counter()
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        counts = _counts(counted)
        peak = torch.cuda.max_memory_allocated() / 2**30
        nccl_ms, busy_ms, n_nccl, host_ms, n_host = _nccl_ms(
            train, args, state, step, mesh)
    finally:
        dist.destroy_process_group()
    steady = statistics.median(times[1:])
    want = dict.fromkeys(counted, 0)
    want.update({k: v * n for k, v in per_step.items()})
    w = min(5, n // 2)        # the first and last w steps' mean losses
    print(f"ddp: {args.arch} {n} steps over {mesh.backend} world "
          f"{mesh.world} "
          f"(SyncBatchNorm, batch {args.batch_size}, {args.opt_level})  "
          f"loss first/last {losses[0]:.4f}/{losses[-1]:.4f}  mean steps "
          f"1-{w} {statistics.fmean(losses[:w]):.4f}  mean steps "
          f"{n - w + 1}-{n} {statistics.fmean(losses[-w:]):.4f}")
    nccl_txt = ("the profiler recorded no device events" if nccl_ms is None
                else f"{nccl_ms:.3f} ms a step in {n_nccl} NCCL kernels "
                     f"({nccl_ms / busy_ms:.2%} of the device busy "
                     f"{busy_ms:.2f} ms)")
    nccl_txt += (f"; {n_host} all-reduce calls a step, {host_ms:.3f} ms of "
                 f"host time in them")
    print(f"ddp: step time median {steady:.2f} ms (steps 2-{n})  first "
          f"step {times[0]:.2f} ms  img/s {args.batch_size / steady * 1e3:.1f}"
          f"  max memory {peak:.2f} GiB  all-reduce device time: {nccl_txt}")
    print(f"ddp: launches a step { {k: v / n for k, v in counts.items() if v} }"
          f" (want {per_step})")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"ddp loss is not finite: {losses}")
    if not statistics.fmean(losses[-w:]) < statistics.fmean(losses[:w]):
        raise SystemExit(f"ddp loss did not fall over {n} steps")
    if counts != want:
        raise SystemExit(f"ddp kernel launches per step off: {counts}")
    del state, step
    torch.cuda.empty_cache()
    return counts


def phase_launch():
    """torchrun, one process on this card, the C3 command line
    (``--sync_bn``) for 5 steps: exit 0, the header naming NCCL at world 1
    and 5 step lines.  Its kernels launch in another process and are not
    counted here."""
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m",
           "apex_example_tpu_torch.train"] + LAUNCH_ARGS
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"launch: torchrun did not finish in "
                         f"{LAUNCH_TIMEOUT} s")
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith(("data parallel", "model ", "epoch ")):
            print(f"launch: {line}")
    steps = [ln for ln in out.splitlines() if ln.startswith("epoch 0 step ")]
    header = "data parallel: world 1, backend nccl" in out
    print(f"launch: torchrun --nproc_per_node 1 exit {proc.returncode}, "
          f"NCCL world 1 header {header}, {len(steps)} step lines, "
          f"{wall:.1f} s")
    if proc.returncode != 0 or not header or len(steps) != 5:
        print(err[-4000:], file=sys.stderr)
        raise SystemExit("launch: the torchrun run failed")


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rel_close(got, want, rtol):
    """||got - want|| <= rtol ||want|| over a tensor; the ratio."""
    d = float((got.double() - want.double()).norm())
    n = float(want.double().norm())
    return d / max(n, 1e-30), d <= rtol * max(n, 1e-30)


def _ddp2_syncbn(rank, world, fused, counted, lines):
    """SyncBatchNorm across the two processes at resnet50's stage-3 shape
    (each rank's half of batch 256) against one process with the whole
    batch (rank 0): y and dx rtol = atol 1e-4, the running statistics
    rtol 1e-4 atol 1e-5, dscale and dbias (summed over the ranks) rtol
    1e-4 plus 1e-4 of their largest magnitude.  The fused branch launches
    each BatchNorm-sum kernel once, between the all-reduces, and each
    rank's kernel sums are held against their plain versions."""
    import torch.distributed as dist
    from apex_example_tpu_torch.ops import batch_norm as bn
    from apex_example_tpu_torch.parallel import DATA_AXIS, SyncBatchNorm
    n, hw, _, C = BN_MODULE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(n, hw, hw, C, device="cuda", generator=gen) * 2 + 0.5
    dy = torch.randn(n, hw, hw, C, device="cuda", generator=gen)
    scale = torch.rand(C, device="cuda", generator=gen) + 0.5
    bias = torch.randn(C, device="cuda", generator=gen) * 0.1
    rows = slice(rank * n // world, (rank + 1) * n // world)

    def run(axis, xs, dys):
        m = SyncBatchNorm(C, fused_kernel=fused, axis_name=axis,
                          device="cuda")
        with torch.no_grad():
            m.scale.copy_(scale)
            m.bias.copy_(bias)
        xr = xs.clone().requires_grad_()
        y = m(xr)
        y.backward(dys)
        return {"y": y.detach(), "dx": xr.grad, "dscale": m.scale.grad,
                "dbias": m.bias.grad, "mean": m.mean, "var": m.var}

    _zero_counts(counted)
    got = run(DATA_AXIS, x[rows], dy[rows])
    torch.cuda.synchronize()
    counts = _counts(counted)
    for key in ("dscale", "dbias"):
        dist.all_reduce(got[key])
    want_launch = 1 if fused else 0
    ok = counts["bn_stats"] == counts["bn_bwd_sums"] == want_launch
    branch = "fused" if fused else "composite"
    txt = f"ddp2: SyncBatchNorm {branch} {n // world}x{hw}x{hw}x{C} a rank:"
    if fused:
        x2 = x[rows].reshape(-1, C)
        dy2 = dy[rows].reshape(-1, C)
        c = torch.zeros(C, device="cuda")
        mean = x2.mean(0)
        inv = torch.rsqrt(x2.var(0, unbiased=False) + 1e-5)
        kern = bn.bn_stats_cuda(x2, c) + bn.bn_bwd_sums_cuda(x2, dy2, mean,
                                                               inv)
        plain = bn.bn_stats_plain(x2, c) + bn.bn_bwd_sums_plain(x2, dy2,
                                                                 mean, inv)
        mags = _bn_magnitudes(x2, dy2, c, mean, inv)
        closes = [_bn_sums_close(a, b, m) for a, b, m in zip(kern, plain,
                                                              mags)]
        ok = ok and all(o for _, o in closes)
        txt += (f" the kernels' sums against their plain versions max|d| "
                f"{max(e for e, _ in closes):.3g};")
    if rank == 0:
        want = run(None, x, dy)
        errs = {}
        for key, (rtol, atol) in {"y": (1e-4, 1e-4), "dx": (1e-4, 1e-4),
                                  "mean": (1e-4, 1e-5), "var": (1e-4, 1e-5),
                                  "dscale": (1e-4, None),
                                  "dbias": (1e-4, None)}.items():
            w = want[key][rows] if key in ("y", "dx") else want[key]
            a = 1e-4 * float(w.abs().max()) if atol is None else atol
            errs[key], good = _close(got[key], w, rtol, a)
            ok = ok and good
        txt += (" against one process with the whole batch: " + "  ".join(
            f"max|d{k}| {e:.3g}" for k, e in errs.items()) + ";")
    lines.append(f"{txt} launches bn_stats {counts['bn_stats']} "
                 f"bn_bwd_sums {counts['bn_bwd_sums']} (want {want_launch} "
                 f"each)  {'ok' if ok else 'MISMATCH'}")
    return ok, counts


def _ddp2_trail(train, argv, rank, world, counted, ddp=None):
    """DDP2_STEPS data-parallel steps of ``argv``'s model (resnet18 on CIFAR
    shapes, SyncBatchNorm) in the gloo group, deterministic convolutions:
    per step (loss, grad norm), the parameters after the first step and
    after the last, the launches."""
    from apex_example_tpu_torch.engine import make_sharded_train_step
    from apex_example_tpu_torch.parallel import DATA_AXIS
    args = train.build_parser().parse_args(argv)
    state = train.build_state(args, "cuda")
    _deterministic_convolutions()
    step = make_sharded_train_step(DATA_AXIS, ddp=ddp)
    metrics, first = [], None
    _zero_counts(counted)
    for i in range(args.steps_per_epoch):
        state, met = step(state, train.batch_fn(args, 0, i, "cuda", rank,
                                                world))
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
        if i == 0:
            first = {k: p.detach().clone() for k, p in
                     state.model.named_parameters()}
    counts = _counts(counted)
    last = [p.detach().clone() for p in state.model.parameters()]
    return metrics, first, last, counts


def _ddp2_full(train, argv, perturb=0.0):
    """The first step in one process with the whole batch (no --sync_bn:
    this process's group is not the trail's), the first parameter scaled
    by 1 + ``perturb``: (loss, grad norm), the parameters after it."""
    from apex_example_tpu_torch.engine import make_train_step
    args = train.build_parser().parse_args(
        [a for a in argv if a != "--sync_bn"])
    state = train.build_state(args, "cuda")
    _deterministic_convolutions()
    if perturb:
        with torch.no_grad():
            next(state.model.parameters()).mul_(1.0 + perturb)
    state, met = make_train_step()(state, train.batch_fn(args, 0, 0, "cuda"))
    return (float(met["loss"]), float(met["grad_norm"])), {
        k: p.detach() for k, p in state.model.named_parameters()}


def _ddp2_image(train, rank, world, counted, lines):
    """resnet18 (CIFAR shapes, SyncBatchNorm, FusedSGD) over the two
    processes: the default reduction, --gradient-predivide-factor 2 and
    --larc, DDP2_STEPS steps each.  The first step against the same step
    in one process with the whole batch from the same weights (rank 0):
    loss rtol 1e-5, grad norm rtol 1e-4, every parameter within atol 1e-5
    or FLOOR_X times the floor, whichever is larger: the floor is the
    largest parameter difference of that one-process step against itself
    with the first parameter scaled by 1 + 1e-6 (a ReLU input within
    rounding of zero passes on one side only; the convolutions of batch
    32 and 64 round differently; on an H100 a parameter moved by 1.24e-5,
    and so did the floor).  (Later steps are not compared with a separate
    one-process trail: at this model's second step a perturbation of 1e-7
    of the parameters moves some BatchNorm bias grads by 7% in one
    process alone.)  Every step's loss finite, each rank's parameters
    equal bit for bit after the trail (the digests).  Then the int8
    exchange of one backward's grads within its bound."""
    from apex_example_tpu_torch.parallel import DDPConfig
    ok, counts, digests = True, dict.fromkeys(counted, 0), {}
    for label, extra, ddp in (
            ("default", [], DDPConfig()),
            ("predivide 2", [], DDPConfig(gradient_predivide_factor=2.0)),
            ("larc", ["--larc"], DDPConfig())):
        argv = DDP2_IMAGE_ARGS + extra
        metrics, first, last, c = _ddp2_trail(train, argv, rank, world,
                                              counted, ddp)
        for k in counts:
            counts[k] += c[k]
        digests[label] = _digest(last)
        n = len(metrics)
        want_c = {"sgd": n, "multi_tensor_l2norm": 0 if "--larc" in extra
                  else n}
        good = (all(c[k] == v for k, v in want_c.items())
                and sum(c.values()) == sum(want_c.values())
                and all(math.isfinite(m[0]) for m in metrics))
        txt = (f"ddp2: resnet18 {label}, {n} steps over gloo world {world}:"
               f" losses {[round(m[0], 5) for m in metrics]}")
        if rank == 0:
            (l_f, n_f), f_params = _ddp2_full(train, argv)
            _, floor = _ddp2_full(train, argv, perturb=1e-6)
            l_d, n_d = metrics[0]
            p_err = max(float((first[k] - f_params[k]).abs().max())
                        for k in first)
            f_err = max(float((floor[k] - f_params[k]).abs().max())
                        for k in first)
            limit = max(1e-5, FLOOR_X * f_err)
            good = (good and abs(l_d - l_f) <= 1e-5 * abs(l_f)
                    and abs(n_d - n_f) <= 1e-4 * abs(n_f) and p_err <= limit)
            txt += (f"; the first step against one process with the whole "
                    f"batch: loss {l_d!r} / {l_f!r}, grad norm {n_d!r} / "
                    f"{n_f!r}, max|dparam| {p_err:.3g} (rtol 1e-5, 1e-4; "
                    f"limit {limit:.3g}: the floor {f_err:.3g})")
        lines.append(f"{txt}; launches {c['sgd']} sgd, "
                     f"{c['multi_tensor_l2norm']} L2 norm (want {want_c})  "
                     f"{'ok' if good else 'MISMATCH'}")
        ok = ok and good
        torch.cuda.empty_cache()
    ok = _ddp2_int8(train, rank, world, lines) and ok
    return ok, counts, digests


def _ddp2_int8(train, rank, world, lines):
    """The int8 exchange of one backward's grads of resnet18 against the
    fp32 all-reduce of the same grads: every element within world * scale
    / 2 of the sum (over world, for the average), scale the chunk's shared
    max-abs over 127."""
    import torch.distributed as dist
    from apex_example_tpu_torch.parallel import DDPConfig, allreduce_grads
    args = train.build_parser().parse_args(
        [a for a in DDP2_IMAGE_ARGS if a != "--sync_bn"])
    state = train.build_state(args, "cuda")
    x, y = train.batch_fn(args, 0, 0, "cuda", rank, world)
    torch.nn.functional.cross_entropy(state.model(x), y).backward()
    grads = [p.grad for p in state.model.parameters()]
    q = allreduce_grads([g.clone() for g in grads],
                        DDPConfig(quantized_allreduce=True))
    exact = allreduce_grads([g.double() for g in grads])
    worst, ok = 0.0, True
    for g, gq, ge in zip(grads, q, exact):
        flat = g.float().reshape(-1)
        chunks = torch.nn.functional.pad(
            flat, (0, (-flat.numel()) % 1024)).view(-1, 1024)
        scale = chunks.abs().amax(1) * (1.0 / 127.0)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX)
        bound = (world * scale / 2).repeat_interleave(1024)[:flat.numel()]
        err = (gq.double().reshape(-1) - ge.reshape(-1)) * world
        worst = max(worst, float((err.abs() / bound.double()).max()))
        ok = ok and bool((err.abs() <= bound.double() * (1 + 1e-6)).all())
    lines.append(f"ddp2: int8 exchange of resnet18's grads (chunks of 1024, "
                 f"{sum(g.numel() for g in grads)} elements): largest error "
                 f"{worst:.3f} of its bound world * scale / 2  "
                 f"{'ok' if ok else 'MISMATCH'}")
    return ok


def _ddp2_zero(rank, world, counted, lines):
    """DistributedFusedAdam over bert_base's 201 parameter shapes (the
    same seeded values on both ranks, each rank its own seeded grads)
    against FusedAdam over the same parameters with the ranks' mean grads
    in one process (rank 0), ZERO_STEPS clean steps: every parameter
    within rtol 1e-5 plus 1e-6 of the tensor's largest magnitude.  The
    first step's shard: the Adam kernel's p, m and v against
    adam_update_plain on the same shard, the same limits.  A planted inf
    in rank 1's grad of element 0 (rank 0's shard) is skipped by both
    ranks: parameters, moments and count bitwise unchanged.  Returns
    (ok, launches, the parameters' digest)."""
    import torch.distributed as dist
    from apex_example_tpu_torch.ops.fused_optim import adam_update_plain
    from apex_example_tpu_torch.optim.distributed import DistributedFusedAdam
    from apex_example_tpu_torch.optim.fused import FusedAdam
    shapes = _bert_base_shapes()
    gen = torch.Generator(device="cuda").manual_seed(21)
    params = [torch.randn(s, device="cuda", generator=gen) * 0.02
              for s in shapes]
    hyper = dict(lr=1e-3, weight_decay=0.01)
    opt = DistributedFusedAdam(params, **hyper)
    ref = None
    if rank == 0:
        ref = FusedAdam([p.detach().clone() for p in params], **hyper)

    def grads_of(r, k):
        g = torch.Generator(device="cuda").manual_seed(1000 + 10 * k + r)
        return [torch.randn(s, device="cuda", generator=g) * 1e-3
                for s in shapes]

    ok, counts, worst = True, dict.fromkeys(counted, 0), 0.0
    plain_err, skipped_ok = None, None
    for k in range(ZERO_STEPS + 1):
        planted = k == 1
        with torch.no_grad():
            for p, g in zip(params, grads_of(rank, k)):
                p.grad.copy_(g)
            if planted and rank == 1:
                params[0].grad.view(-1)[0] = float("inf")
        if planted:
            before = ([p.clone() for p in params], opt.mu.clone(),
                      opt.nu.clone(), opt.step_count)
        _zero_counts(counted)
        opt.reduce_grads()
        if k == 0:                 # the shard the kernel will step
            flat = torch.cat([p.detach().reshape(-1) for p in params])
            flat = torch.nn.functional.pad(flat, (0, opt.padded -
                                                  flat.numel()))
            pre = (flat[opt.lo:opt.lo + opt.shard].clone(),
                   opt.g_shard / world, opt.mu.clone(), opt.nu.clone())
        opt.step()
        c = _counts(counted)
        for key in counts:
            counts[key] += c[key]
        ok = ok and c["adam"] == 1 and sum(c.values()) == 1
        if k == 0:
            lr, c1, c2 = opt._scalars_at(1)
            want = adam_update_plain(*pre, lr=lr, beta1=0.9, beta2=0.999,
                                     eps=1e-8, weight_decay=0.01,
                                     bias_c1=c1, bias_c2=c2)
            errs = [_close(g, w, STATE_RTOL, STATE_ATOL * float(
                w.abs().max())) for g, w in zip(
                (opt.p_shard, opt.mu, opt.nu), want)]
            plain_err = max(e for e, _ in errs)
            ok = ok and all(o for _, o in errs)
        if planted:
            skipped_ok = (all(torch.equal(a, b) for a, b in zip(params,
                                                                before[0]))
                          and torch.equal(opt.mu, before[1])
                          and torch.equal(opt.nu, before[2])
                          and opt.step_count == before[3])
            ok = ok and skipped_ok
        elif ref is not None:
            mean = [(a + b) / world for a, b in zip(grads_of(0, k),
                                                    grads_of(1, k))]
            with torch.no_grad():
                for p, g in zip(ref.params, mean):
                    p.grad.copy_(g)
            ref.step()
            errs = [_close(a, b, STATE_RTOL, STATE_ATOL * float(
                b.abs().max())) for a, b in zip(params, ref.params)]
            worst = max(worst, max(e for e, _ in errs))
            ok = ok and all(o for _, o in errs)
    torch.cuda.synchronize()
    dist.barrier()
    txt = (f"ddp2: DistributedFusedAdam over bert_base's {len(shapes)} "
           f"tensors ({opt.padded} elements padded, {opt.shard} a rank), "
           f"{ZERO_STEPS} steps and a planted inf: the first shard's kernel "
           f"step against adam_update_plain max|d| {plain_err:.3g}; the "
           f"overflow skipped on this rank: {skipped_ok}; step count "
           f"{opt.step_count}")
    if rank == 0:
        txt += (f"; against FusedAdam with the mean grads in one process: "
                f"max|dparam| {worst:.3g} (rtol {STATE_RTOL:g} + "
                f"{STATE_ATOL:g} of the largest magnitude)")
    lines.append(f"{txt}; launches {counts['adam']} adam (want "
                 f"{ZERO_STEPS + 1})  {'ok' if ok else 'MISMATCH'}")
    return ok and opt.step_count == ZERO_STEPS, counts, _digest(params)


def _ddp2_rank(rank, world, store, queue):
    """One of ddp2's processes: every part on cuda:0 in the gloo group;
    puts (rank, result) on ``queue``, or (rank, the traceback)."""
    try:
        sys.path.insert(0, ROOT)
        torch.cuda.set_device(0)
        import torch.distributed as dist
        from apex_example_tpu_torch import train
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            counted = _counted_kernels()
            lines, counts, t0 = [], dict.fromkeys(counted, 0), time.time()
            ok = True
            for fused in (False, True):
                good, c = _ddp2_syncbn(rank, world, fused, counted, lines)
                ok = ok and good
                counts = {k: counts[k] + c[k] for k in counts}
            torch.cuda.empty_cache()
            good, c, digests = _ddp2_image(train, rank, world, counted, lines)
            ok = ok and good
            counts = {k: counts[k] + c[k] for k in counts}
            torch.cuda.empty_cache()
            good, c, digests["zero"] = _ddp2_zero(rank, world, counted, lines)
            ok = ok and good
            counts = {k: counts[k] + c[k] for k in counts}
            lines.append(f"ddp2: rank {rank} took {time.time() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
        queue.put((rank, {"ok": ok, "lines": lines, "counts": counts,
                          "digests": digests}))
    except Exception:                # reported to the parent, which fails
        import traceback
        queue.put((rank, traceback.format_exc()))


def phase_ddp2():
    """Two processes on cuda:0 in a gloo group (NCCL refuses two ranks on
    one card), spawned, each part held against one process with the whole
    batch; a rank that hangs or dies fails the phase after DDP2_TIMEOUT
    seconds.  Returns rank 0's launches."""
    import queue as queue_mod
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = _fresh(os.path.join(ROOT, "build", "chip_smoke_gloo_store"))
    results = ctx.Queue()
    procs = [ctx.Process(target=_ddp2_rank, args=(r, 2, store, results))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + DDP2_TIMEOUT
        while len(got) < len(procs):
            left = deadline - time.monotonic()
            if left <= 0:
                raise SystemExit(f"ddp2: the ranks did not finish in "
                                 f"{DDP2_TIMEOUT} s")
            try:
                rank, res = results.get(timeout=min(left, 10.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise SystemExit(f"ddp2: a rank died (exit {dead})")
                continue
            got[rank] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    for rank, res in sorted(got.items()):
        if isinstance(res, str):
            raise SystemExit(f"ddp2: rank {rank} failed:\n{res}")
    for line in got[0]["lines"]:
        print(line)
    print(got[1]["lines"][-1])
    same = got[0]["digests"] == got[1]["digests"]
    print(f"ddp2: both ranks' parameters bitwise equal after every trail: "
          f"{same}  ({time.perf_counter() - t0:.1f} s with the spawn)")
    if not (got[0]["ok"] and got[1]["ok"] and same):
        for line in got[1]["lines"]:
            print(f"ddp2: rank 1: {line}")
        raise SystemExit("ddp2: a data-parallel check failed")
    return got[0]["counts"]


# --------------------------------------------------- eval, resume, serving

EVAL_TOL = 1e-4           # bert_base's eval loss, card against CPU: rtol
EVAL_O2_TOL = 2e-2        # the same at O2 (the O2 trails' loss limit)
EVAL_RUNS = (             # label, argv, per training step, per eval batch
    ("bert_base", C4_ARGS + ["--steps-per-epoch", "2", "--eval",
                             "--eval-batches", "2"],
     {"layer_norm_fwd": 26, "layer_norm_bwd": 26, "multi_tensor_l2norm": 1,
      "lamb_stage1": 1, "lamb_stage2": 1}, {"layer_norm_fwd": 26}),
    ("gpt2048", GPT2048_O2_ARGS + ["--steps-per-epoch", "1", "--eval",
                                   "--eval-batches", "1"],
     {"layer_norm_fwd": 26, "layer_norm_bwd": 26, "multi_tensor_l2norm": 1,
      "adam": 1, "attn_fwd": 12, "attn_dkdv": 12, "attn_dq": 12},
     {"layer_norm_fwd": 26, "attn_fwd": 12}),
    ("transformer_xl", C5_ARGS + ["--steps-per-epoch", "2", "--eval",
                                  "--eval-batches", "2"],
     {"layer_norm_fwd": 32, "layer_norm_bwd": 32, "multi_tensor_l2norm": 1,
      "multi_tensor_scale": 1, "adam": 1}, {"layer_norm_fwd": 32}))
# c4 as the CLI runs it, under dynamic scaling: 4 steps of 2 epochs of 3,
# the resume at step 2, in the middle of epoch 0
RESUME_ARGS = C4_ARGS + ["--loss-scale", "dynamic", "--epochs", "2",
                         "--steps-per-epoch", "3"]
# one step at lr 1e-2, large enough that the served tokens move off the
# untrained model's, which the phase requires
SERVE_CKPT_TRAIN = GPT_ARGS + ["--batch-size", "8", "--steps-per-epoch", "1",
                               "--lr", "1e-2"]
SERVE_CKPT_ARGS = ["--device", "cuda", "--arch", "gpt_base", "--slots", "4",
                   "--max-len", "256", "--requests", "4", "--prompt-len",
                   "16:64", "--max-new", "32", "--stagger", "0", "--seed",
                   "0"]


def _on_cpu(x):
    """``x`` (a tensor, or tuples of them) copied to the CPU."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    return type(x)(_on_cpu(v) for v in x)


def phase_eval(train, counted):
    """``--eval`` through the trainer on the LM archs at full width
    (bert_base and transformer_xl at O2, gpt_base at O2 and 8 x 2048
    through the flash kernels): the EVAL line, each training step's
    launches as its path's, and each eval batch's launches (the LayerNorm
    forward, and the flash forward at 2048) and time, and no optimizer,
    scale or L2-norm launch in an eval batch.  The timed bert_base run's
    first eval loss at O2 against the same trained weights and batch on
    the CPU (plain versions, O2), and bert_base's first eval batch at O0
    on the card against the CPU, the same weights from seed 0.  Returns
    the paths' counts: each run's training steps, and its eval batches
    under "E:<label>"."""
    import types
    from apex_example_tpu_torch import amp
    from apex_example_tpu_torch.workloads import make_bert_eval_step
    real = train.build_eval_step
    out, first = {}, None
    for label, argv, per_step, per_batch in EVAL_RUNS:
        tally = {"ms": [], "counts": dict.fromkeys(counted, 0)}

        def build(args, tally=tally, label=label):
            eval_fn = real(args)

            def timed(*batch):
                torch.cuda.synchronize()
                before = _counts(counted)
                t0 = time.perf_counter()
                result = eval_fn(*batch)
                torch.cuda.synchronize()
                tally["ms"].append((time.perf_counter() - t0) * 1e3)
                for k, v in _counts(counted).items():
                    tally["counts"][k] += v - before[k]
                if label == "bert_base" and "first" not in tally:
                    state, data = batch
                    tally["first"] = (
                        {k: v.detach().cpu()
                         for k, v in state.model.state_dict().items()},
                        _on_cpu(data), float(result["loss"]),
                        float(result["masked_acc"]))
                return result
            return timed

        args = train.build_parser().parse_args(argv)
        train.build_eval_step = build
        _zero_counts(counted)
        try:
            rc = train.run_train(args)
        finally:
            train.build_eval_step = real
        torch.cuda.synchronize()
        total = _counts(counted)
        n, batches = args.steps_per_epoch, len(tally["ms"])
        steps = {k: total[k] - tally["counts"][k] for k in total}
        want_steps = dict.fromkeys(counted, 0)
        want_steps.update({k: v * n for k, v in per_step.items()})
        want_eval = dict.fromkeys(counted, 0)
        want_eval.update({k: v * batches for k, v in per_batch.items()})
        print(f"eval: {label} {batches} eval batches, "
              f"{statistics.median(tally['ms']):.2f} ms per eval batch "
              f"(median; each {[round(x, 2) for x in tally['ms']]}), "
              f"launches per eval batch "
              f"{ {k: v / batches for k, v in tally['counts'].items() if v} }"
              f" (want {per_batch}); {n} training steps' launches "
              f"{ {k: v for k, v in steps.items() if v} }")
        if rc != 0 or batches != args.eval_batches:
            raise SystemExit(f"eval: {label} rc {rc}, {batches} eval "
                             f"batches (want {args.eval_batches})")
        if tally["counts"] != want_eval:
            raise SystemExit(f"eval: {label} eval batches launched "
                             f"{tally['counts']} (want {want_eval})")
        if steps != want_steps:
            raise SystemExit(f"eval: {label} training steps launched "
                             f"{steps} (want {want_steps})")
        out[f"eval_{label}"] = steps
        out[f"E:{label}"] = tally["counts"]
        first = tally.get("first", first)
        torch.cuda.empty_cache()

    params, data, loss, acc = first
    args = train.build_parser().parse_args(EVAL_RUNS[0][1]
                                           + ["--device", "cpu"])
    model = train.build_model(args, torch.device("cpu"),
                              amp.get_policy(args.opt_level))
    model.load_state_dict(params)
    t0 = time.perf_counter()
    metrics = make_bert_eval_step()(types.SimpleNamespace(model=model), data)
    cpu_s = time.perf_counter() - t0
    err = abs(loss - float(metrics["loss"])) / abs(float(metrics["loss"]))
    print(f"eval: bert_base {args.opt_level} first eval batch of the timed "
          f"run ({args.batch_size} x {args.seq_len}, after "
          f"{args.steps_per_epoch} LAMB steps), card against CPU ("
          f"{cpu_s:.1f} s): loss {loss:.6f} / {float(metrics['loss']):.6f} "
          f"(rel {err:.3g}, limit {EVAL_O2_TOL:g}), masked_acc {acc:.4f} / "
          f"{float(metrics['masked_acc']):.4f}")
    if not err <= EVAL_O2_TOL:
        raise SystemExit("eval: the card's bert_base O2 eval loss is off "
                         "the CPU's")
    del model, params, data
    got = {}
    for dev in ("cuda", "cpu"):
        args = train.build_parser().parse_args(
            TRAIN_ARGS + ["--batch-size", "8", "--device", dev])
        model = train.build_model(args, torch.device(dev))
        batch = train.batch_fn(args, model.vocab_size, 10_000_000, dev)
        metrics = make_bert_eval_step()(types.SimpleNamespace(model=model),
                                        batch)
        got[dev] = float(metrics["loss"]), float(metrics["masked_acc"])
        del model
    err = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    print(f"eval: bert_base O0 first eval batch (8 x 128), card against "
          f"CPU: loss {got['cuda'][0]:.6f} / {got['cpu'][0]:.6f} (rel "
          f"{err:.3g}, limit {EVAL_TOL:g}), masked_acc {got['cuda'][1]:.4f} "
          f"/ {got['cpu'][1]:.4f}")
    if not err <= EVAL_TOL:
        raise SystemExit("eval: the card's bert_base eval loss is off the "
                         "CPU's")
    return out


class _Stop(Exception):
    """Ends a trainer run at a step boundary, where a killed process
    would stop."""


def _stopped_run(train, argv, stop_at):
    """``train.run_train`` on ``argv``, stopped when it asks for the batch
    of step ``stop_at``; the train state it had then."""
    states = []
    build_state, batch_fn = train.build_state, train.batch_fn

    def keep(args, device):
        states.append(build_state(args, device))
        return states[-1]

    def stopping(args, vocab, step, *rest):
        if step == stop_at:
            raise _Stop
        return batch_fn(args, vocab, step, *rest)

    train.build_state, train.batch_fn = keep, stopping
    try:
        train.run_train(train.build_parser().parse_args(argv))
        raise SystemExit(f"resume: the run ended before step {stop_at}")
    except _Stop:
        pass
    finally:
        train.build_state, train.batch_fn = build_state, batch_fn
    return states[-1]


def _state_leaves(state):
    """Every leaf a checkpoint holds, by name: parameters and buffers,
    the optimizer's moments and step count, the train state's step, the
    scaler's scale and growth counter."""
    leaves = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name, value in state.optimizer.state_dict().items():
        if isinstance(value, list):
            leaves.update({f"optimizer.{name}[{i}]": t
                           for i, t in enumerate(value)})
        else:
            leaves[f"optimizer.{name}"] = value
    leaves.update({"state.step": state.step,
                   "scaler.scale": state.scaler.scale,
                   "scaler.growth_counter": state.scaler.growth_counter})
    return leaves


def _unequal(got, want):
    """The names of the leaves that are not bitwise equal."""
    bad = [k for k in want if k not in got]
    for k, w in want.items():
        g = got.get(k)
        if g is None:
            continue
        if torch.is_tensor(w):
            if not (g.dtype == w.dtype and torch.equal(g, w)):
                bad.append(k)
        elif g != w:
            bad.append(k)
    return bad


def phase_resume(train, counted):
    """c4 as the CLI runs it (bert_base, FusedLAMB, O2, dynamic scaling,
    64 x 128): 4 steps without a break, then 2 steps with
    ``--save-every-steps 2 --checkpoint-dir`` and 2 with ``--resume``,
    synchronous and with ``--async-checkpoint``.  Every leaf (parameters,
    LAMB moments, the optimizer's step count, the train state's step, the
    scale and growth counter) bitwise equal to the unbroken run's; the
    checkpoint's bytes on disk, the time ``save`` blocks the loop and the
    restore's time; each resumed step launching c4's kernels and the
    unscale.  Returns the counts of the resumed runs."""
    import shutil
    import tempfile
    from apex_example_tpu_torch.utils import checkpoint as ckpt
    times = {"save": [], "restore": [], "join": []}
    save, restore, join = (ckpt.CheckpointManager.save,
                           ckpt.CheckpointManager.restore,
                           ckpt.CheckpointManager.wait_until_finished)

    def timed(name, fn):
        def wrapper(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(self, *a, **kw)
            times[name].append(time.perf_counter() - t0)
            return result
        return wrapper

    want = _state_leaves(_stopped_run(train, RESUME_ARGS, 4))
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                            dir=os.path.join(ROOT, "build"))
    counts = dict.fromkeys(counted, 0)
    ckpt.CheckpointManager.save = timed("save", save)
    ckpt.CheckpointManager.restore = timed("restore", restore)
    ckpt.CheckpointManager.wait_until_finished = timed("join", join)
    try:
        for mode in ("sync", "async"):
            for name in times:
                times[name].clear()
            d = os.path.join(root, mode)
            extra = ["--async-checkpoint"] if mode == "async" else []
            _stopped_run(train, RESUME_ARGS + extra + [
                "--checkpoint-dir", d, "--save-every-steps", "2"], 2)
            step_dir = os.path.join(d, "2")
            nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
            save_s, joins = times["save"][0], list(times["join"])
            _zero_counts(counted)
            got = _stopped_run(train, RESUME_ARGS + ["--resume", d], 4)
            torch.cuda.synchronize()
            for k, v in _counts(counted).items():
                counts[k] += v
            bad = _unequal(_state_leaves(got), want)
            print(f"resume: {mode}: checkpoint of step 2 {nbytes} bytes on "
                  f"disk in {len(os.listdir(step_dir))} files, save blocked "
                  f"the loop {save_s:.3f} s"
                  + (f" (the write joined {max(joins):.3f} s later at the "
                     f"run's end)" if mode == "async" and joins else "")
                  + f", restore {times['restore'][0]:.3f} s; after the "
                  f"resume to step {got.step} (optimizer count "
                  f"{got.optimizer.step_count}, scale "
                  f"{float(got.scaler.scale):.0f}, growth counter "
                  f"{int(got.scaler.growth_counter)}): {len(want)} leaves, "
                  f"{len(bad)} not bitwise equal to the unbroken run's")
            if bad:
                raise SystemExit(f"resume: {mode}: leaves differ from the "
                                 f"unbroken run: {bad[:10]}")
            shutil.rmtree(d)
            del got
            torch.cuda.empty_cache()
    finally:
        (ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore,
         ckpt.CheckpointManager.wait_until_finished) = save, restore, join
        shutil.rmtree(root, ignore_errors=True)
    per_step = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                "multi_tensor_l2norm": 1, "lamb_stage1": 1,
                "lamb_stage2": 1, "multi_tensor_scale": 1}
    wanted = dict.fromkeys(counted, 0)
    wanted.update({k: v * 4 for k, v in per_step.items()})
    print(f"resume: the resumed runs' launches over 2 x 2 steps {counts} "
          f"(want {wanted})")
    if counts != wanted:
        raise SystemExit("resume: the resumed steps' launches are off")
    return counts


def phase_serve_ckpt(train, cli, counted):
    """gpt_base trained one step at O0 (8 x 128) with ``--checkpoint-dir``,
    then served from that directory, from the trained model held in
    memory and from the untrained model (the same seed): 4 greedy requests
    each, the first two token streams equal and the untrained model's
    other, so that a checkpoint that held the initial weights, or a restore
    that copied nothing, would fail.  Returns the counts of the serving run
    from the checkpoint."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_",
                            dir=os.path.join(ROOT, "build"))
    states, build_state = [], train.build_state

    def keep(args, device):
        states.append(build_state(args, device))
        return states[-1]

    train.build_state = keep
    try:
        rc = train.run_train(train.build_parser().parse_args(
            SERVE_CKPT_TRAIN + ["--checkpoint-dir", root]))
    finally:
        train.build_state = build_state
    trained = states[-1].model.eval()
    _zero_counts(counted)
    try:
        done, summary, rc_ckpt = cli.run_serve(cli.build_parser().parse_args(
            SERVE_CKPT_ARGS + ["--checkpoint-dir", root]))
        torch.cuda.synchronize()
        counts = _counts(counted)
        gpt_base = cli.gpt_base
        cli.gpt_base = lambda **kw: trained
        try:
            held, _, rc_mem = cli.run_serve(cli.build_parser().parse_args(
                SERVE_CKPT_ARGS))
        finally:
            cli.gpt_base = gpt_base
        del trained, states[:]
        torch.cuda.empty_cache()
        init, _, rc_init = cli.run_serve(cli.build_parser().parse_args(
            SERVE_CKPT_ARGS))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    streams = [[c.tokens for c in sorted(x, key=lambda c: c.request.uid)]
               for x in (done, held, init)]
    ticks = summary["compute_steps"]
    print(f"serve_ckpt: gpt_base trained 1 step (rc {rc}), served 4 "
          f"requests from its checkpoint (rc {rc_ckpt}, "
          f"{sum(len(t) for t in streams[0])} tokens, {ticks} compute "
          f"ticks, layer_norm launches {counts['layer_norm_fwd']}), from "
          f"memory (rc {rc_mem}) and untrained (rc {rc_init}): token "
          f"streams equal to memory's {streams[0] == streams[1]}, to the "
          f"untrained model's {streams[0] == streams[2]} (want True, False;"
          f" requests the untrained model answers otherwise: "
          f"{sum(a != b for a, b in zip(streams[0], streams[2]))} of 4)")
    if rc or rc_ckpt or rc_mem or rc_init or streams[0] != streams[1] \
            or len(streams[0]) != 4:
        raise SystemExit("serve_ckpt: serving from the checkpoint differs "
                         "from serving the trained model")
    if streams[0] == streams[2]:
        raise SystemExit("serve_ckpt: serving from the checkpoint gives "
                         "the untrained model's tokens")
    if counts["layer_norm_fwd"] != 26 * ticks or any(
            v for k, v in counts.items() if k != "layer_norm_fwd"):
        raise SystemExit(f"serve_ckpt: launches {counts} (want 26 layer "
                         f"norm forwards a tick, nothing else)")
    return counts


# The step options (train.py's --grad-accum, --remat, --host-pipeline and
# the ResNet's space-to-depth stem): gpt2048 at K = 4 against 1 for
# ACCUM_STEPS steps each; C5's first step at K = 2 against 1; C1 at O3 with
# Adam at K = 2 (the fp32 accumulators: axpby a microbatch); C2 at each
# remat; resnet50's stem both ways; c2 and c4 fed by the host pipeline.
ACCUM_STEPS = 3
ACCUM_GPT_ARGS = GPT2048_O2_ARGS + ["--steps-per-epoch", str(ACCUM_STEPS)]
# The first step at K held against its own microbatches, run one by one
# on the same weights outside the step: the optimizer's input, each kind of
# parameter's grads (relative L2), within ACCUM_REF_TOL of the microbatch
# grads summed in fp32 in order and scaled by 1 / K (the same kernels at
# the same shapes and the same fp32 sums: bitwise where the card repeats
# itself); the loss the mean of theirs (rtol 1e-6) and within the
# cross-checks' rtol 1e-5 of the whole batch's; C5's new memory their
# memories in stream order (ACCUM_REF_TOL).  Against K = 1 the bf16
# products tile M = B / K rows otherwise, and no floor measured by a
# perturbed run bounds that in every kind (PERF.md §6, PR 17)
ACCUM_REF_TOL = 1e-6
ACCUM_O3_ARGS = O3_ADAM_ARGS + ["--grad-accum", "2"]
REMAT_STEPS = 4           # timed C2 steps a remat mode (the first warms)
# the s2d stem against the 7x7 stem in bf16: two bf16 ulps of the larger
# output plus 1e-4 (147-term fp32 sums in two orders, then a rounding)
S2D_ULPS, S2D_ATOL = 2, 1e-4
HOST_STEPS = 5            # steps of each host-fed run through the trainer
# the A/B of the loop's period: blocks of HOST_AB_STEPS steps from one
# state, batches made on the card (A) and by the host pipeline (B), in the
# order A, B, A, B; each block's median over its steps after the first
# HOST_AB_SKIP (the prefetcher makes two batches ahead while an A block
# runs, and cuDNN times its algorithms in the first)
HOST_AB_STEPS, HOST_AB_SKIP = 12, 4


def _accum_counts(per_step, k, extra):
    """A step's launches at grad_accum ``k``: the model's kernels k times,
    the step's once, plus ``extra``."""
    model = ("layer_norm_fwd", "layer_norm_bwd", "attn_fwd", "attn_dkdv",
             "attn_dq")
    out = {n: v * (k if n in model else 1) for n, v in per_step.items()}
    for n, v in extra.items():
        out[n] = out.get(n, 0) + v
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _host_copy(t):
    """A fp32 copy of ``t`` in host memory (never a view of it)."""
    return t.detach().to("cpu", torch.float32, copy=True)


def _accum_first_step(train, counted, label, argv, k):
    """The first step at grad_accum ``k`` from seed 0's weights on step 0's
    batch (Transformer-XL's memory zeros), against its microbatches run one
    by one first (the module comment's limits).  Prints the readings;
    returns the step's launches, whether every reading is within its limit,
    and the peak memory of the step (GiB)."""
    from apex_example_tpu_torch import amp
    from apex_example_tpu_torch.engine import ordered_mean, split_batch
    from apex_example_tpu_torch.workloads import lm_loss
    args = train.build_parser().parse_args(argv + ["--grad-accum", str(k)])
    state = train.build_state(args, "cuda")
    step = train.build_step(args)
    model, opt = state.model, state.optimizer
    batch = train.batch_fn(args, model.vocab_size, 0, "cuda")
    txl = train.is_txl(args)
    mems = model.init_mems(args.batch_size) if txl else None
    rows = args.batch_size // k
    model.train()
    with torch.no_grad():
        whole = lm_loss(model(batch[0], mems)[0] if txl
                        else model(batch[0]), batch[1])
    ref, losses, parts = None, [], []
    for i, (x, y) in enumerate(split_batch(batch, k)):
        opt.zero_grad()
        if txl:
            logits, new = model(x, mems[:, i * rows:(i + 1) * rows])
            parts.append(_host_copy(new))
        else:
            logits = model(x)
        loss = lm_loss(logits, y)
        del logits
        amp.scale_loss(loss, state.scaler).backward()
        losses.append(loss.detach())
        grads = [_host_copy(p.grad) for p in model.parameters()]
        ref = grads if ref is None else [a + g for a, g in zip(ref, grads)]
    ref = [a * (1.0 / k) for a in ref]
    ref_loss = float(ordered_mean(losses))
    opt.zero_grad()
    # the optimizer's input: the grads when the step first calls the
    # optimizer (the clip or the update), after the mean and the unscale
    taken = []

    def snapshot(fn):
        def call(*a, **kw):
            if not taken:
                taken.append([_host_copy(p.grad)
                              for p in model.parameters()])
            return fn(*a, **kw)
        return call
    opt.clip_grad_norm, opt.step = (snapshot(opt.clip_grad_norm),
                                    snapshot(opt.step))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(counted)
    if txl:
        state, new_mems, metrics = step(state, mems, batch)
    else:
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts = _counts(counted)
    peak = torch.cuda.max_memory_allocated() / 2**30
    names = [n for n, _ in model.named_parameters()]
    got = dict(zip(names, taken[0]))
    want = dict(zip(names, ref))
    kinds = _grad_differences({"cuda": got, "cpu": want, "floor": want},
                              dict.fromkeys(names, 0), want)
    worst = max(a for a, _, _, _ in kinds.values())
    same = all(torch.equal(got[n], want[n]) for n in names)
    loss = float(metrics["loss"])
    ok = (worst <= ACCUM_REF_TOL and _rel(loss, ref_loss) <= 1e-6
          and _rel(loss, float(whole)) <= 1e-5)
    m_txt = ""
    if txl:
        new_mems, parts = _host_copy(new_mems), torch.cat(parts, 1)
        m_err = float((new_mems - parts).norm() / parts.norm())
        ok = ok and m_err <= ACCUM_REF_TOL
        m_txt = (f"  the new memory against the microbatches' in stream "
                 f"order: relative L2 {m_err:.3g} (bitwise "
                 f"{torch.equal(new_mems, parts)})")
    print(f"accum: {label}, the first step at K = {k} against its "
          f"microbatches one by one: grads by kind, |d| / |g|, largest "
          f"{worst:.3g} (limit {ACCUM_REF_TOL:g}; bitwise {same}); loss "
          f"{loss!r}, the microbatches' mean {ref_loss!r} (rtol 1e-6), the "
          f"whole batch's {float(whole)!r} (rtol 1e-5){m_txt}  peak memory "
          f"{peak:.2f} GiB  {'ok' if ok else 'MISMATCH'}")
    del state, step, model, opt, batch, mems, got, want, ref, taken
    torch.cuda.empty_cache()
    return counts, ok, peak


def phase_accum(train, counted, mt, gpt2048_step, txl_step, axpby_row):
    """--grad-accum on the card: gpt2048 at 4 against 1 through the
    trainer (the first step's loss, peak memory, step time, launches) and
    its first step against its microbatches one by one; C5's first step at
    2 the same way (and its new memory), its peak memory against 1's and
    its launches; C1
    at O3 with Adam at 2 (axpby once a microbatch), and axpby at that
    path's shapes against its plain version.  Returns the paths'
    launches."""
    t0 = time.perf_counter()
    by_path, runs = {}, {}
    for k in (1, 4):
        label = f"accum_gpt2048_k{k}"
        runs[k] = {}
        by_path[label] = phase_train(
            train, counted, label, ACCUM_GPT_ARGS + ["--grad-accum", str(k)],
            _accum_counts(gpt2048_step, k,
                          {"multi_tensor_scale": 1} if k > 1 else {}),
            falls=False, out=runs[k])
    first = [runs[k]["steps"][0]["loss"] for k in (1, 4)]
    print(f"accum: gpt2048 O2 8 x 2048 through the trainer, K = 4 / 1: "
          f"first step loss {first[1]!r} / {first[0]!r} (rel "
          f"{_rel(first[1], first[0]):.3g}, limit 1e-5)  peak memory "
          f"{runs[4]['peak_gib']:.2f} / {runs[1]['peak_gib']:.2f} GiB  step "
          f"{runs[4]['step_ms']:.2f} / {runs[1]['step_ms']:.2f} ms")
    _, ok, _ = _accum_first_step(train, counted, "gpt2048 O2 8 x 2048",
                                 ACCUM_GPT_ARGS, 4)
    if not (ok and _rel(first[1], first[0]) <= 1e-5):
        raise SystemExit("gpt2048 at --grad-accum 4 is not the mean of its "
                         "microbatches")
    c1, _, p1 = _accum_first_step(train, counted,
                                  "c5 transformer_xl O2 32 x 192", C5_ARGS, 1)
    c2, ok, p2 = _accum_first_step(train, counted,
                                   "c5 transformer_xl O2 32 x 192", C5_ARGS,
                                   2)
    if not ok:
        raise SystemExit("c5 at --grad-accum 2 is not the mean of its "
                         "microbatches")
    want = _accum_counts(txl_step, 2, {"multi_tensor_scale": 1})
    got = {n: v for n, v in c2.items() if v}
    print(f"accum: c5 at K = 2: peak memory {p2:.2f} / {p1:.2f} GiB at "
          f"K = 1; launches {got} (want {want})")
    if got != want:
        raise SystemExit(f"c5 at --grad-accum 2 launched {got}")
    by_path["accum_c5"] = c2
    by_path["accum_o3"] = phase_train(
        train, counted, "accum_o3", ACCUM_O3_ARGS,
        {"adam": 2, "multi_tensor_l2norm": 2, "axpby": 2,
         "multi_tensor_scale": 1})
    # axpby at that path's shapes: a fold (bf16 grads into fp32 sums) and
    # the mean (fp32 sums and bf16 grads, a = b = 1 / K, into bf16)
    args = train.build_parser().parse_args(ACCUM_O3_ARGS)
    state = train.build_state(args, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    half = [p for p in state.optimizer.params if p.dtype != torch.float32]
    g = [torch.randn(p.shape, device="cuda", generator=gen).to(p.dtype)
         for p in half]
    acc = [torch.randn(p.shape, device="cuda", generator=gen) for p in half]
    errs = []
    for x, y, a in ((g, acc, 1.0), (acc, g, 0.5)):
        out = [torch.empty_like(t) for t in y]
        mt.multi_tensor_axpby_cuda(mt.TensorTable([x, y, out]), a, a)
        want_out = mt.multi_tensor_axpby_plain(a, x, a, y)
        torch.cuda.synchronize()
        err, ok = _lists_close(out, want_out)
        errs.append(err)
        print(f"accum: axpby at accum_o3's {len(half)} bf16 tensors, "
              f"{'fold' if a == 1.0 else 'mean'} ({x[0].dtype} x, "
              f"{y[0].dtype} y): max|dout| {err:.3g}  "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit("axpby disagrees with its plain version at "
                             "the accumulation path's shapes")
    axpby_row["max_abs_err"] = max(axpby_row["max_abs_err"], *errs)
    del state
    torch.cuda.empty_cache()
    phase_profile(train, ACCUM_GPT_ARGS + ["--grad-accum", "4"])
    print(f"accum: took {time.perf_counter() - t0:.1f} s")
    return by_path


def phase_remat(train, counted, argv, per_step):
    """C2 at --remat none, conv and block: the first step of seed 0's
    weights on step 0's batch with deterministic convolutions (loss rtol
    1e-5, grad norm rtol 1e-4, every grad within 1e-4 of its tensor's
    largest magnitude against none's; the running statistics bitwise
    equal), then REMAT_STEPS timed steps: the median step time and peak
    memory of each.  Returns the first steps' launches."""
    t0 = time.perf_counter()
    ref, by_path = None, {}
    for remat in ("none", "conv", "block"):
        args = train.build_parser().parse_args(argv + ["--remat", remat])
        state = train.build_state(args, "cuda")
        step = train.build_step(args)
        _deterministic_convolutions()
        batch = train.batch_fn(args, 0, 0, "cuda")
        _zero_counts(counted)
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        by_path[f"remat_{remat}"] = _counts(counted)
        model = state.model
        got = (float(metrics["loss"]), float(metrics["grad_norm"]),
               {k: p.grad.detach().cpu() for k, p in
                model.named_parameters()},
               {k: b.detach().cpu() for k, b in model.named_buffers()})
        _timed_convolutions()
        times = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(1, REMAT_STEPS + 1):
            batch = train.batch_fn(args, 0, i, "cuda")
            t1 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(times[1:])
        line = (f"remat: c2 resnet50 O2 {args.batch_size} --remat {remat}: "
                f"step {ms:.2f} ms (median of steps 2-{REMAT_STEPS}; "
                f"{args.batch_size / ms * 1e3:.1f} img/s)  peak memory "
                f"{peak:.2f} GiB  first step loss {got[0]:.6f} grad norm "
                f"{got[1]:.5f}")
        if ref is None:
            ref = got
            print(line)
        else:
            worst = max(float((g - ref[2][k]).abs().max()) /
                        max(float(ref[2][k].abs().max()), 1e-30)
                        for k, g in got[2].items())
            same = all(torch.equal(g, ref[2][k]) for k, g in got[2].items())
            stats = all(torch.equal(b, ref[3][k]) for k, b in got[3].items())
            ok = (_rel(got[0], ref[0]) <= 1e-5 and _rel(got[1], ref[1])
                  <= 1e-4 and worst <= 1e-4 and stats)
            print(f"{line}  against none: grads' largest difference "
                  f"{worst:.3g} of their tensor's magnitude (bitwise "
                  f"{same})  running statistics bitwise equal {stats}  "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"--remat {remat}'s first step is not "
                                 f"none's")
        if by_path[f"remat_{remat}"] != {**dict.fromkeys(counted, 0),
                                         **per_step}:
            raise SystemExit(f"--remat {remat} launched "
                             f"{by_path[f'remat_{remat}']}")
        del state, step, model, got, batch
        torch.cuda.empty_cache()
    print(f"remat: took {time.perf_counter() - t0:.1f} s")
    return by_path


def phase_s2d():
    """resnet50's stem at 256 x 224 x 224 x 3 in bf16 through the
    space-to-depth stem and the 7x7 convolution, the same weight: outputs
    within S2D_ULPS bf16 ulps plus S2D_ATOL; each one's forward plus its
    weight's backward timed on the card."""
    from apex_example_tpu_torch.models.resnet import Conv, SpaceToDepthStem
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(23)
    plain = Conv(3, 64, 7, 2, dtype=bf16).to("cuda")
    s2d = SpaceToDepthStem(3, 64, dtype=bf16).to("cuda")
    with torch.no_grad():
        plain.weight.copy_(torch.randn(plain.weight.shape, device="cuda",
                                       generator=gen) * math.sqrt(2 / 147))
        s2d.weight.copy_(plain.weight)
    x = torch.randn(256, 224, 224, 3, device="cuda", generator=gen).to(bf16)
    with torch.no_grad():
        y0, y1 = plain(x).float(), s2d(x).float()
    torch.cuda.synchronize()
    limit = S2D_ULPS * (_bf16_tol(y1, y0) - FP32_TOL) + S2D_ATOL
    err = (y1 - y0).abs()
    ok = bool((err <= limit).all())
    dy = torch.randn(y0.shape, device="cuda", generator=gen).to(bf16)
    times = {}
    for name, stem in (("7x7", plain), ("space-to-depth", s2d)):
        times[name] = _device_ms(lambda: torch.autograd.grad(
            stem(x), stem.weight, dy), reps=20, warmup=3)
    print(f"s2d: resnet50's stem, 256 x 224 x 224 x 3 bf16: max|dy| "
          f"{float(err.max()):.3g}, {int((err != 0).sum())} of "
          f"{err.numel()} outputs not bitwise equal (limit {S2D_ULPS} bf16 "
          f"ulps + {S2D_ATOL:g})  forward + weight "
          f"backward: 7x7 {times['7x7']:.3f} ms, space-to-depth "
          f"{times['space-to-depth']:.3f} ms  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("the space-to-depth stem is not the 7x7 stem")
    del x, y0, y1, dy, plain, s2d
    torch.cuda.empty_cache()


def _host_ms(make, n=5):
    """Host time a batch of a native prefetcher, the card idle: the
    median over ``n`` ``next()`` calls after the first two (the worker
    thread makes one batch ahead, so each call waits for one batch; the
    pinned buffers come back from PyTorch's cache from the third)."""
    with make() as pf:
        next(pf)
        next(pf)
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            next(pf)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _ab_periods(train, argv):
    """The loop's period, ms a step (the batch's fetch, the step, the
    loss read back as the trainer's step record reads it), of ``argv``'s
    model with batches made on the card and with the host pipeline's, in
    blocks A, B, A, B from one state: {"card": [ms, ms], "host": [ms,
    ms]}."""
    args = train.build_parser().parse_args(argv + ["--host-pipeline"])
    state = train.build_state(args, "cuda")
    step = train.build_step(args)
    vocab = getattr(state.model, "vocab_size", 0)
    src = train.BatchSource(args, vocab, "cuda", 0, 1, 0)
    periods = {"card": [], "host": []}
    try:
        for block in ("card", "host", "card", "host"):
            times = []
            for i in range(HOST_AB_STEPS):
                t0 = time.perf_counter()
                batch = (src.train(i) if block == "host" else
                         train.batch_fn(args, vocab, i, "cuda"))
                state, metrics = step(state, batch)
                float(metrics["loss"])
                times.append((time.perf_counter() - t0) * 1e3)
            periods[block].append(statistics.median(times[HOST_AB_SKIP:]))
    finally:
        src.close()
    del state, step
    torch.cuda.empty_cache()
    return periods


def phase_host(train, counted, c2_argv, image_step, bert_step):
    """--host-pipeline on c2 and c4: the card's first batch bitwise the
    one the library gives on the CPU, the C++ worker's time a batch,
    HOST_STEPS steps through the trainer (launches), and the loop's
    period with host batches against on-device batches, in turn from one
    state (:func:`_ab_periods`).  Returns the paths' launches."""
    t0 = time.perf_counter()
    by_path = {}
    for label, argv, per_step in (("host_c2", c2_argv, image_step),
                                  ("host_c4", C4_ARGS, bert_step)):
        args = train.build_parser().parse_args(
            argv + ["--host-pipeline", "--steps-per-epoch", str(HOST_STEPS)])
        vocab = 0 if train.is_image(args) else args.vocab_size
        src = train.BatchSource(args, vocab, "cuda", 0, 1, 0)
        try:
            card = src.train(0)
        finally:
            src.close()
        cpu = train.BatchSource(args, vocab, "cpu", 0, 1, 0)
        try:
            want = cpu.train(0)
        finally:
            cpu.close()
        host_ms = _host_ms(lambda: src.producer(0))     # pinned, as trained
        flat = lambda b: [t for part in b for t in (           # noqa: E731
            part if isinstance(part, tuple) else (part,))]
        same = all(torch.equal(a.cpu(), b) for a, b in zip(flat(card),
                                                           flat(want)))
        if not same:
            raise SystemExit(f"{label}: the card's first batch is not the "
                             f"library's")
        by_path[label] = phase_train(train, counted, label,
                                     argv + ["--host-pipeline",
                                             "--steps-per-epoch",
                                             str(HOST_STEPS)],
                                     per_step, falls=False)
        ab = _ab_periods(train, argv)
        card_ms, host_ms_loop = (statistics.fmean(ab[b])
                                 for b in ("card", "host"))
        image = train.is_image(args)
        items = args.batch_size * (1 if image else args.seq_len)
        unit = "img/s" if image else "tokens/s"
        print(f"host: {label}: first batch on the card bitwise the "
              f"library's on the CPU: {same}  the C++ worker {host_ms:.2f} "
              f"ms a batch (pinned buffers, the card idle)  the loop's "
              f"period, blocks of {HOST_AB_STEPS} steps in turn (medians of "
              f"steps {HOST_AB_SKIP + 1}-{HOST_AB_STEPS}): card-made "
              f"{ab['card'][0]:.2f}, host {ab['host'][0]:.2f}, card-made "
              f"{ab['card'][1]:.2f}, host {ab['host'][1]:.2f} ms; host "
              f"{host_ms_loop:.2f} ms ({items / host_ms_loop * 1e3:.1f} "
              f"{unit}) against {card_ms:.2f} ms ({items / card_ms * 1e3:.1f}"
              f" {unit}), {host_ms_loop / card_ms:.3f} x  host-bound (host "
              f"blocks 5% slower than both card-made blocks): "
              f"{min(ab['host']) > 1.05 * max(ab['card'])}")
    print(f"host: took {time.perf_counter() - t0:.1f} s")
    return by_path


DIAG_STEPS = 6            # diag (a): c2's steps, the NaN batch at 4
DIAG_HANG_S = 2.0         # diag (c): the hang, under --stall-timeout 1
# the in-turn cost of --numerics-check and --tick-profile through the
# trainer: (steps a run, rounds) for c2 and for c4, whose host-bound
# periods spread more between runs, so it takes more rounds; the first
# DIAG_AB_SKIP gaps between step records are left out of a run's median
DIAG_AB_C2, DIAG_AB_C4 = (6, 1), (8, 4)
DIAG_AB_SKIP = 1


def _chrome_events(trace_dir, pattern):
    """The ph "X" events of the one Chrome trace in ``trace_dir`` whose
    name matches ``pattern``."""
    import glob
    paths = glob.glob(os.path.join(trace_dir, pattern))
    if len(paths) != 1:
        raise SystemExit(f"diag: {len(paths)} traces {pattern} in "
                         f"{trace_dir} (want 1)")
    with open(paths[0]) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"], paths[0]


def _diag_c2(train, counted, c2_argv, image_step, trace_dir):
    """(a): C2 with every diagnostic armed and a NaN batch at step 4."""
    from apex_example_tpu_torch.obs.metrics import read_jsonl
    label = "diag_c2"
    argv = c2_argv + [
        "--loss-scale", "dynamic", "--steps-per-epoch", str(DIAG_STEPS),
        "--tick-profile", "--tick-profile-every", "1", "--trace",
        "--profile-window", "2:3", "--numerics-check", "overflow",
        "--inject-fault", "nan@4", "--flight-recorder", "--stall-timeout",
        "120"]
    counts = phase_train(train, counted, label, argv,
                         dict(image_step, multi_tensor_scale=1), falls=False,
                         nan_steps=(4,))
    records = read_jsonl(os.path.join(ROOT, "build",
                                      f"chip_smoke_{label}.jsonl"))
    kinds = [r["record"] for r in records]
    steps = [r for r in records if r["record"] == "step"]
    events = [r for r in records if r["record"] == "overflow_event"]
    if "crash_dump" in kinds or "stall" in kinds:
        raise SystemExit(f"diag: a clean c2 run wrote {kinds}")
    if [e["step"] for e in events] != [4] or not events[0]["modules"]:
        raise SystemExit(f"diag: overflow events {events} (want one, at "
                         f"step 4, naming modules)")
    s3, s4 = steps[2], steps[3]
    if s4["grads_finite"] != 0.0 or s4["scale"] != s3["scale"] / 2:
        raise SystemExit(f"diag: step 4 not skipped: {s4}")
    if not all(math.isfinite(s["loss"]) and s["grads_finite"] == 1.0
               for s in steps[4:]):
        raise SystemExit(f"diag: c2 did not recover after the NaN batch: "
                         f"{steps[4:]}")
    ticks = [r for r in records if r["record"] == "tick_profile"]
    summary = next(r for r in records if r["record"] == "overhead_summary")
    total = sum(p["total_ms"] for p in summary["phases"].values())
    if len(ticks) != DIAG_STEPS or not all(
            t["phases"]["device"] > 0 and abs(sum(t["phases"].values())
                                              - t["wall_ms"])
            <= 0.01 * t["wall_ms"] for t in ticks) \
            or abs(total - summary["wall_ms"]) > 0.01 * summary["wall_ms"]:
        raise SystemExit(f"diag: the tick phases do not sum to the wall "
                         f"or the device phase is 0: {ticks}")
    spans = [r for r in records if r["record"] == "trace_event"]
    if [e["name"] for e in spans] != ["data", "step"] * DIAG_STEPS \
            or any("parent_id" in e for e in spans) \
            or any(a["ts"] + a["dur"] > b["ts"]
                   for a, b in zip(spans, spans[1:])):
        raise SystemExit(f"diag: the host spans are not data, step in "
                         f"turn: {[e['name'] for e in spans]}")
    xs, path = _chrome_events(trace_dir, "window_2_3.*.pt.trace.json")
    sgd = [e for e in xs if e.get("cat") == "kernel"
           and "sgd_chunks" in e["name"]]
    ranges = {name: [e for e in xs if e.get("cat") == "user_annotation"
                     and e["name"] == name]
              for name in ("step", "fwd_bwd", "unscale_check", "optimizer")}
    nested = all(any(s["ts"] <= e["ts"] and e["ts"] + e["dur"]
                     <= s["ts"] + s["dur"] for s in ranges["step"])
                 for name in ("fwd_bwd", "unscale_check", "optimizer")
                 for e in ranges[name])
    phases = {p: statistics.median(t["phases"][p] for t in ticks[1:])
              for p in ticks[0]["phases"]}
    print(f"diag: c2 with --tick-profile --trace --profile-window 2:3 "
          f"--numerics-check overflow --inject-fault nan@4 "
          f"--flight-recorder --stall-timeout 120: one overflow_event at "
          f"step 4 naming {len(events[0]['modules'])} modules "
          f"({', '.join(events[0]['modules'][:4])}, ...), the step "
          f"skipped (grads_finite 0), scale {s3['scale']:.0f} -> "
          f"{s4['scale']:.0f}, steps 5-{DIAG_STEPS} finite; no crash_dump "
          f"or stall; spans data, step x {DIAG_STEPS}")
    print(f"diag: c2 tick phases, medians of steps 2-{DIAG_STEPS} (ms): "
          + "  ".join(f"{p} {v:.3f}" for p, v in phases.items())
          + f"; over the run host_gap_ms {summary['host_gap_ms']:.3f} of "
          f"wall {summary['wall_ms']:.3f}, host_overhead_frac "
          f"{summary['host_overhead_frac']:.4f}, device_ms "
          f"{summary['device_ms']:.3f}")
    print(f"diag: c2 window trace {os.path.basename(path)}: {len(xs)} "
          f"events, {len(sgd)} SGD kernel launches (want 2), ranges "
          + ", ".join(f"{k} {len(v)}" for k, v in ranges.items())
          + f" (want 2 each), the phases inside step: {nested}")
    if len(sgd) != 2 or any(len(v) != 2 for v in ranges.values()) \
            or not nested:
        raise SystemExit("diag: the window trace lacks the SGD launches or "
                         "the phase ranges")
    return counts


def _diag_c4(train, counted, bert_step):
    """(b): c4 preempted at step 3 under --preempt-grace with an async
    save, then resumed: bitwise the unbroken run."""
    import shutil
    from apex_example_tpu_torch.obs.metrics import read_jsonl
    ck = os.path.join(ROOT, "build", "chip_smoke_diag_ck")
    shutil.rmtree(ck, ignore_errors=True)
    argv = C4_ARGS + ["--steps-per-epoch", "5", "--async-checkpoint"]
    paths = {k: os.path.join(ROOT, "build", f"chip_smoke_diag_c4_{k}.jsonl")
             for k in ("full", "pre", "res")}
    kept = []
    build_state = train.build_state

    def keep(args, device):
        kept.append(build_state(args, device))
        return kept[-1]

    def run(extra, key):
        rc = train.run_train(train.build_parser().parse_args(
            argv + extra + ["--metrics-jsonl", paths[key]]))
        return rc, read_jsonl(paths[key])

    train.build_state = keep
    try:
        rc_full, full = run([], "full")
        want = _state_leaves(kept.pop())
        torch.cuda.empty_cache()
        rc_pre, pre = run(["--preempt-grace", "--inject-fault", "sigterm@3",
                           "--checkpoint-dir", ck], "pre")
        kept.clear()
        torch.cuda.empty_cache()
        _zero_counts(counted)
        rc_res, res = run(["--resume", ck], "res")
        counts = _counts(counted)
        got = _state_leaves(kept.pop())
    finally:
        train.build_state = build_state
    losses = lambda recs: {r["step"]: r["loss"]             # noqa: E731
                           for r in recs if r["record"] == "step"}
    preempt = [r for r in pre if r["record"] == "preemption"]
    trail = {**losses(pre), **losses(res)}
    bad = _unequal(got, want)
    want_counts = dict.fromkeys(counted, 0)
    want_counts.update({k: 2 * v for k, v in bert_step.items()})
    print(f"diag: c4 --preempt-grace --inject-fault sigterm@3 "
          f"--async-checkpoint: rc {rc_pre} (want 75), {preempt}; the run "
          f"summary aborted: {pre[-1].get('aborted', False)}; --resume: rc "
          f"{rc_res}, steps {sorted(losses(res))}; the trail bitwise the "
          f"unbroken 5 steps': {trail == losses(full)}; {len(want)} leaves "
          f"of the final state, {len(bad)} unequal; the resumed steps' "
          f"launches {counts == want_counts}")
    if rc_full != 0 or rc_pre != 75 or rc_res != 0 or len(preempt) != 1 \
            or not preempt[0]["saved"] \
            or preempt[0].get("checkpoint_step") != 3 \
            or pre[-1]["record"] != "run_summary" or "aborted" in pre[-1]:
        raise SystemExit("diag: the c4 grace exit is not the contract's")
    if trail != losses(full) or sorted(trail) != [1, 2, 3, 4, 5] or bad:
        raise SystemExit(f"diag: the resumed c4 trail differs: {bad[:5]}")
    if counts != want_counts:
        raise SystemExit(f"diag: resumed c4 launches {counts}")
    shutil.rmtree(ck, ignore_errors=True)
    return counts


def _diag_c1(train, trace_dir):
    """(c): a crash under --flight-recorder and a hang under
    --stall-timeout 1 --stall-trace, on C1."""
    from apex_example_tpu_torch.obs.metrics import read_jsonl
    from apex_example_tpu_torch.resilience import faults
    crash = os.path.join(ROOT, "build", "chip_smoke_diag_crash.jsonl")
    try:
        train.run_train(train.build_parser().parse_args(
            C1_ARGS + ["--steps-per-epoch", "3", "--flight-recorder",
                       "--inject-fault", "crash@2", "--metrics-jsonl",
                       crash]))
        raise SystemExit("diag: crash@2 did not raise")
    except faults.FaultInjected:
        pass
    records = read_jsonl(crash)
    dump = next(r for r in records if r["record"] == "crash_dump")
    mem = dump.get("memory", {})
    ok = (dump["env"].get("device") == torch.cuda.get_device_name(0)
          and dump.get("step") == 2 and mem.get("bytes_in_use", 0) > 0
          and mem.get("bytes_limit") == torch.cuda.get_device_properties(
              0).total_memory and "FaultInjected" in dump["traceback"]
          and records[-1].get("aborted") is True)
    print(f"diag: crash@2 under --flight-recorder: crash_dump env "
          f"{ {k: dump['env'].get(k) for k in ('torch', 'cuda', 'device')} }"
          f", memory {mem}, last steps "
          f"{[r['step'] for r in dump.get('last_steps', [])]}, the summary "
          f"aborted: {records[-1].get('aborted')}: {ok}")
    if not ok:
        raise SystemExit("diag: the crash dump is not the contract's")
    hang = os.path.join(ROOT, "build", "chip_smoke_diag_hang.jsonl")
    before, faults.HANG_SECONDS = faults.HANG_SECONDS, DIAG_HANG_S
    try:
        rc = train.run_train(train.build_parser().parse_args(
            C1_ARGS + ["--steps-per-epoch", "4", "--inject-fault", "hang@2",
                       "--stall-timeout", "1", "--stall-trace",
                       "--metrics-jsonl", hang]))
    finally:
        faults.HANG_SECONDS = before
    records = read_jsonl(hang)
    stalls = [r for r in records if r["record"] == "stall"]
    xs, path = _chrome_events(trace_dir, "stall.*.pt.trace.json")
    kernels = [e for e in xs if e.get("cat") == "kernel"]
    sgd = [e for e in kernels if "sgd_chunks" in e["name"]]
    print(f"diag: hang@2 ({DIAG_HANG_S:g} s) under --stall-timeout 1 "
          f"--stall-trace: rc {rc}, {len(stalls)} stall record(s) at step "
          f"{[r['step'] for r in stalls]}, "
          f"{[r['seconds_since_step'] for r in stalls]} s since the step, "
          f"the stacks name the hang: "
          f"{all('maybe_fire' in r['thread_stacks'] for r in stalls)}; "
          f"trace {os.path.basename(path)}: {len(kernels)} kernels, "
          f"{len(sgd)} SGD launches of the steps that recovered")
    if rc != 0 or len(stalls) != 1 or stalls[0]["step"] != 2 \
            or "maybe_fire" not in stalls[0]["thread_stacks"] or not sgd:
        raise SystemExit("diag: the stall is not the contract's")


DIAG_ARMS = {"off": [],
             "numerics": ["--numerics-check", "overflow"],
             "tick": ["--tick-profile", "--tick-profile-every", "1"]}


def _diag_ab(train, label, argv, steps, rounds):
    """The cost of --numerics-check overflow and of --tick-profile on
    ``argv``'s cell, timed through the trainer's own loop: ``rounds``
    rounds of trainer runs in turn (off, numerics, tick; a last off run
    closes them), each ``steps`` steps from the seed's state under
    --loss-scale dynamic and --metrics-jsonl, the flag alone differing.
    The LM loop is not decomposed (as in JAX), so on an LM cell the tick
    arm times the flag doing nothing.  A run's period is the median gap
    between its step records' times (the loop's whole tick: the batch,
    the step, its record and the observers) after the first DIAG_AB_SKIP
    gaps.  An arm's cost in a
    round is its period over the mean of the off runs on either side, less
    1.  A numerics run writes one overflow_event for each step whose grads
    were not finite and no other; a tick run on an image cell its
    overhead_summary.  Returns {arm: [cost a round]}."""
    from apex_example_tpu_torch.obs.metrics import read_jsonl
    path = os.path.join(ROOT, "build", f"chip_smoke_diag_ab_{label}.jsonl")
    base = argv + ["--loss-scale", "dynamic", "--steps-per-epoch",
                   str(steps), "--print-freq", str(steps),
                   "--metrics-jsonl", path]
    image = train.is_image(train.build_parser().parse_args(base))
    periods = {arm: [] for arm in DIAG_ARMS}
    skipped = 0
    for arm in [*DIAG_ARMS] * rounds + ["off"]:
        if os.path.exists(path):
            os.remove(path)
        rc = train.run_train(train.build_parser().parse_args(
            base + DIAG_ARMS[arm]))
        records = read_jsonl(path)
        steps_ = [r for r in records if r["record"] == "step"]
        kinds = [r["record"] for r in records]
        overflowed = [r["step"] for r in steps_ if r["grads_finite"] < 1]
        events = [r["step"] for r in records
                  if r["record"] == "overflow_event"]
        if rc != 0 or len(steps_) != steps \
                or events != (overflowed if arm == "numerics" else []) \
                or (arm == "tick" and image) != ("overhead_summary"
                                                 in kinds):
            raise SystemExit(f"diag: {label} {arm} run: rc {rc}, "
                             f"{len(steps_)} steps, overflowed {overflowed},"
                             f" overflow_events {events}, records "
                             f"{set(kinds)}")
        skipped += len(overflowed)
        times = [r["time"] for r in steps_]
        gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
        periods[arm].append(statistics.median(gaps[DIAG_AB_SKIP:]))
        torch.cuda.empty_cache()
    off = periods["off"]
    cost = {arm: [t / ((off[i] + off[i + 1]) / 2) - 1
                  for i, t in enumerate(periods[arm])]
            for arm in ("numerics", "tick")}
    print(f"diag: {label}, the trainer's loop in turn, {rounds} round(s) "
          f"of runs off, numerics, tick and a closing off, {steps} steps "
          f"each (median of the step records' gaps {DIAG_AB_SKIP + 1}-"
          f"{steps - 1}; ms a step): "
          + "  ".join(f"{arm} " + " / ".join(f"{t:.2f}" for t in v)
                      for arm, v in periods.items())
          + "; cost a round against the off runs either side: "
          + "  ".join(f"{arm} " + " / ".join(f"{c:+.2%}" for c in v)
                      + f" (median {statistics.median(v):+.2%})"
                      for arm, v in cost.items())
          + f"; the off runs' spread {min(off):.2f}-{max(off):.2f} ms "
          f"({max(off) / min(off) - 1:.2%}); {skipped} steps overflowed"
          + ("" if image else "; --tick-profile does not decompose the LM "
             "loop (as in JAX)"))
    return cost


def phase_diag(train, counted, c2_argv, image_step, bert_step):
    """The trainer's diagnostics and resilience on the card: (a) C2 with
    them armed and a NaN batch, (b) c4 preempted and resumed, (c) a crash
    and a hang on C1; then the in-turn cost of --numerics-check overflow
    and --tick-profile on c2 and c4.  Returns the paths' launches."""
    import shutil
    from apex_example_tpu_torch.obs import profiler
    t0 = time.perf_counter()
    trace_dir = os.path.join(ROOT, "build", "chip_smoke_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    before, profiler.DEFAULT_TRACE_DIR = profiler.DEFAULT_TRACE_DIR, \
        trace_dir
    try:
        by_path = {"diag_c2": _diag_c2(train, counted, c2_argv, image_step,
                                       trace_dir)}
        torch.cuda.empty_cache()
        by_path["diag_c4"] = _diag_c4(train, counted, bert_step)
        torch.cuda.empty_cache()
        _diag_c1(train, trace_dir)
        torch.cuda.empty_cache()
        _diag_ab(train, "c2", c2_argv, *DIAG_AB_C2)
        _diag_ab(train, "c4", C4_ARGS, *DIAG_AB_C4)
    finally:
        profiler.DEFAULT_TRACE_DIR = before
        shutil.rmtree(trace_dir, ignore_errors=True)
    print(f"diag: took {time.perf_counter() - t0:.1f} s")
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from apex_example_tpu_torch import normalization, train
    from apex_example_tpu_torch.data.synthetic import (image_batch,
                                                       lm_batch, mlm_batch)
    from apex_example_tpu_torch.models.gpt import gpt_base
    from apex_example_tpu_torch.models.resnet import resnet50
    from apex_example_tpu_torch.ops import _build
    from apex_example_tpu_torch.ops import attention as att
    from apex_example_tpu_torch.ops import batch_norm as bn
    from apex_example_tpu_torch.ops import fused_optim as fo
    from apex_example_tpu_torch.ops import layer_norm as ln
    from apex_example_tpu_torch.ops import multi_tensor as mt
    from apex_example_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm
    from apex_example_tpu_torch.serve import cli

    counted = _counted_kernels()
    bert_step = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                 "multi_tensor_l2norm": 1, "lamb_stage1": 1,
                 "lamb_stage2": 1}
    txl_step = {"layer_norm_fwd": 32, "layer_norm_bwd": 32,
                "multi_tensor_l2norm": 1, "multi_tensor_scale": 1,
                "adam": 1}
    gpt_step = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                "multi_tensor_l2norm": 1, "adam": 1}
    gpt2048_step = dict(gpt_step, attn_fwd=12, attn_dkdv=12, attn_dq=12)
    t_start = time.perf_counter()
    image_step = {"sgd": 1, "multi_tensor_l2norm": 1}
    novograd_step = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                     "multi_tensor_l2norm": 1, "novograd": 1}
    adagrad_step = {"adagrad": 1, "multi_tensor_l2norm": 1}
    phase_env()
    phase_build(_build)
    rows = [phase_kernels(ln), phase_ln_bwd(ln)]
    rms_rows, rms_counts = phase_rms_norm(ln, normalization, counted)
    rows += rms_rows
    rows += phase_optim_kernels(mt, fo)
    rows.append(phase_adam(mt, fo))
    scale_row, l2_err = phase_scale(mt)
    rows.append(scale_row)
    l2_row = next(r for r in rows if r["name"] == "multi_tensor_l2norm")
    l2_row["max_abs_err"] = max(l2_row["max_abs_err"], l2_err)
    torch.cuda.empty_cache()
    rows += phase_attention(att)
    by_path = {"rmsnorm": rms_counts,
               "serve": phase_main(cli, gpt_base, counted),
               "train": phase_train(train, counted, "train", TRAIN_ARGS,
                                    bert_step)}
    phase_cross_check(train, counted, "train", TRAIN_ARGS, mlm_batch(
        0, batch_size=2, seq_len=128, vocab_size=30522, mask_token_id=30521,
        seed=0), bert_step)
    phase_profile(train, TRAIN_ARGS)
    by_path["txl"] = phase_train(train, counted, "txl", TXL_ARGS, txl_step)
    torch.cuda.empty_cache()
    toks = lm_batch(0, batch_size=2, seq_len=192, vocab_size=267735, seed=0)
    phase_cross_check(train, counted, "txl", TXL_ARGS,
                      (np.ascontiguousarray(toks[:, :-1]),
                       np.ascontiguousarray(toks[:, 1:])), txl_step,
                      mems_tol=1e-4, flip_lr=2.5e-4)
    by_path["gpt"] = phase_train(train, counted, "gpt", GPT_ARGS, gpt_step)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gpt2048_run = {}
    by_path["gpt2048"] = phase_train(train, counted, "gpt2048",
                                     GPT2048_O2_ARGS, gpt2048_step,
                                     out=gpt2048_run)
    torch.cuda.empty_cache()
    by_path["gpt2048_o0"] = phase_train(train, counted, "gpt2048_o0",
                                        GPT2048_O0_ARGS, gpt2048_step)
    torch.cuda.empty_cache()
    phase_route_cross_check(counted, lm_batch)
    phase_route_times(train, counted)
    phase_profile(train, GPT2048_O2_ARGS,
                  mfu=("gpt2048", gpt2048_run["step_ms"]))
    torch.cuda.empty_cache()
    phase_profile(train, GPT2048_O0_ARGS)
    torch.cuda.empty_cache()
    print(f"gpt2048: the sequence-2048 phases took "
          f"{time.perf_counter() - t0:.1f} s")
    phase_profile(train, TXL_ARGS)
    torch.cuda.empty_cache()
    rows.append(phase_sgd(fo, mt, resnet50))
    bn_rows, by_path["syncbn"] = phase_bn(bn, SyncBatchNorm, counted)
    rows += bn_rows
    rows += [phase_novograd(fo, mt), phase_adagrad(fo, mt, resnet50),
             phase_axpby(mt)]
    torch.cuda.empty_cache()
    c2_run = {}
    by_path["c2"], c2_args = phase_c2(train, counted, image_step,
                                      out=c2_run)
    torch.cuda.empty_cache()
    by_path["c1"] = phase_train(train, counted, "c1", C1_ARGS, image_step)
    by_path["dynamic"] = phase_train(
        train, counted, "dynamic", DYN_ARGS,
        dict(image_step, multi_tensor_scale=1), scale=2.0 ** 16)
    phase_overflow_drill(train, counted, dict(
        image_step, multi_tensor_scale=1))
    imgs, labels = image_batch(0, batch_size=2, image_size=224,
                               num_classes=1000, seed=0, device="cpu")
    phase_cross_check(train, counted, "c2", C2_CROSS_ARGS,
                      (imgs.numpy(), labels.numpy()), image_step,
                      flip_lr=0.1)
    busy_ms = phase_profile(train, c2_args, mfu=("c2", c2_run["step_ms"]))
    if busy_ms is not None:
        phase_bn_share(train, c2_args, SyncBatchNorm, busy_ms)
    t0 = time.perf_counter()
    by_path["novograd"] = phase_train(train, counted, "novograd",
                                      NOVOGRAD_ARGS, novograd_step)
    phase_cross_check(train, counted, "novograd", NOVOGRAD_ARGS, mlm_batch(
        0, batch_size=2, seq_len=128, vocab_size=30522, mask_token_id=30521,
        seed=0), novograd_step, zero_grad_lr=NOVOGRAD_LR)
    by_path["adagrad"] = phase_train(train, counted, "adagrad", ADAGRAD_ARGS,
                                     adagrad_step)
    torch.cuda.empty_cache()
    by_path["adagrad_o3"] = phase_train(
        train, counted, "adagrad_o3", ADAGRAD_O3_ARGS,
        {"adagrad": 2, "multi_tensor_l2norm": 2})
    phase_cross_check(train, counted, "adagrad", ADAGRAD_CROSS_ARGS,
                      (imgs.numpy(), labels.numpy()), adagrad_step,
                      flip_lr=ADAGRAD_LR)
    phase_overflow_drill(train, counted, {"multi_tensor_scale": 1,
                                          "novograd": 1,
                                          "multi_tensor_l2norm": 1},
                         "novograd", DYN_ARGS + ["--opt", "novograd"],
                         first=True)
    phase_overflow_drill(train, counted, dict(adagrad_step,
                                              multi_tensor_scale=1),
                         "adagrad", DYN_ARGS + ["--opt", "adagrad", "--lr",
                                                str(ADAGRAD_LR)], first=True)
    print(f"novograd, adagrad: their training phases took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    c4_run, c5_run = {}, {}
    by_path["c4"] = phase_train(train, counted, "c4", C4_ARGS, bert_step,
                                out=c4_run)
    torch.cuda.empty_cache()
    by_path["c5"] = phase_train(train, counted, "c5", C5_ARGS, txl_step,
                                out=c5_run)
    torch.cuda.empty_cache()
    phase_profile(train, C4_ARGS, mfu=("c4", c4_run["step_ms"]))
    phase_profile(train, C5_ARGS, mfu=("c5", c5_run["step_ms"]))
    phase_o2_first_step(train, "c4", TRAIN_ARGS, mlm_batch(
        0, batch_size=2, seq_len=128, vocab_size=30522, mask_token_id=30521,
        seed=0))
    toks = lm_batch(0, batch_size=1, seq_len=64, vocab_size=267735, seed=0)
    phase_o2_first_step(train, "c5", TXL_ARGS,
                        (np.ascontiguousarray(toks[:, :-1]),
                         np.ascontiguousarray(toks[:, 1:])))
    for first in (False, True):
        phase_overflow_drill(train, counted,
                             dict(bert_step, multi_tensor_scale=1),
                             "c4_dynamic", C4_DYN_ARGS, first=first,
                             plant=lambda model: model.mlm_bias,
                             plant_name="mlm_bias")
        phase_overflow_drill(train, counted,
                             dict(txl_step, multi_tensor_scale=2),
                             "c5_dynamic", C5_DYN_ARGS, first=first,
                             plant=lambda model: model.layers[0].attn.u_bias,
                             plant_name="layers.0.attn.u_bias")
    by_path["adam_o3"] = phase_train(
        train, counted, "adam_o3", O3_ADAM_ARGS,
        {"adam": 2, "multi_tensor_l2norm": 2})
    by_path["lamb_o3"] = phase_train(
        train, counted, "lamb_o3", O3_LAMB_ARGS,
        {"lamb_stage1": 2, "lamb_stage2": 2, "multi_tensor_l2norm": 2})
    print(f"c4, c5: the amp phases took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    by_path["ddp"] = phase_ddp(train, counted, image_step)
    torch.cuda.empty_cache()
    phase_launch()
    by_path["ddp2"] = phase_ddp2()
    print(f"ddp, launch, ddp2: the data-parallel phases took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    by_path.update(phase_eval(train, counted))
    torch.cuda.empty_cache()
    by_path["resume"] = phase_resume(train, counted)
    torch.cuda.empty_cache()
    by_path["serve_ckpt"] = phase_serve_ckpt(train, cli, counted)
    print(f"eval, resume, serve_ckpt: took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    by_path.update(phase_accum(train, counted, mt, gpt2048_step, txl_step,
                               next(r for r in rows if r["name"] == "axpby")))
    by_path.update(phase_remat(train, counted, c2_args, image_step))
    phase_s2d()
    by_path.update(phase_host(train, counted, c2_args, image_step,
                              bert_step))
    print(f"accum, remat, s2d, host: the step options took "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    by_path.update(phase_diag(train, counted, c2_args, image_step,
                              bert_step))
    for row in rows:
        row["launches_by_path"] = {k: v[row["name"]]
                                   for k, v in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    rms_elsewhere = {k: (v["rms_norm_fwd"], v["rms_norm_bwd"])
                     for k, v in by_path.items() if k != "rmsnorm"}
    print(f"rmsnorm: RMSNorm launches on the other paths {rms_elsewhere} "
          f"(want 0 each)")
    if any(any(v) for v in rms_elsewhere.values()):
        raise SystemExit("a path other than rmsnorm launched RMSNorm")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
