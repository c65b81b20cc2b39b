#!/usr/bin/env python3
"""On-card smoke run of `uformer_tpu_torch`, the PyTorch/CUDA port.

    python3 chip_smoke.py [--json PATH]   # on a machine with one CUDA
                                          # card (H100: kernels are sm_90a)

Phases, each raising on failure (no phase is caught):
  1. device  - fails at once without CUDA; prints the card and power limit.
  2. build   - nvcc builds the kernels of csrc/ (sm_90a), one process per
               source, in parallel.
  3. kernels - each kernel against its plain PyTorch version at every
               main-path shape of Uformer_B and of Uformer_T at 256^2
               (batch 2), in fp32 (TF32 off) and bf16: for Uformer_T the
               stage and attention-image kernels at head dim 16, the
               attention-block kernel at enc0 (LN and modulator each way,
               the windows at place 0 and 37, batch 1, 2 and 3), LeFF at
               C 16-64, and the window-attention core at every stage's
               heads and shifts, also on 37 windows more; kernels 4 and 5
               also at one Uformer_B (head dim 32) geometry; the
               attention-image
               kernel (its narrow and wide bf16 bodies) at every shape it
               runs at in serve B, serve T, train and train T, residual on
               and off; the depthwise kernel, per call and in its fused
               q/k/v form (also equal bits to three launches and a ReLU),
               at every serve B-conv stage's (Bw, 8, 8, C) windows, 4 x 4
               windows, a whole image, an odd C without bias and C = 8;
               then the tensor-core tiles' own shapes: the building block
               (mma.sync, cp.async ring) against torch.matmul, LeFF at
               every C 16-512 on an 8 x 8 image, non-square and
               partial-tile images and 64 x 64 at C = 32, the stage at
               C = 512 with 16 heads on 8 x 8 and at C = 256 with shift
               on 16 x 16; the fp32 stage on its three-pass TF32 bodies
               at every C 64-512 and head dim 16 and 32 (shift 0 and 4,
               modulator on and off, two windows an item with the last
               half dead; one launch of the new body each), and the fp32
               block alone (`f32_tile_timing`: three TF32 passes and the
               FMA yardstick against fp64, timed beside torch.matmul).
  4. golden  - Uformer_B at 128^2, fp32, through the kernels, stage by stage
               against the recorded torch activations of
               tests/golden/uformer_b_128.npz; then the conv-projection,
               Mlp, cross-modulator Uformer of
               tests/golden/uformer_convproj_crossmod.npz (64^2) through
               the depthwise kernel (9 fused q/k/v launches), output within
               1e-4.
  5. serve   - a bf16 Restorer for Uformer_B at 256^2 answers 4 requests of
               batch 8; launch counts per request, ms per request, MP/s,
               peak memory; the kernel path against the plain path.
  6. timing  - each kernel against its plain version at the bs8 256^2
               shapes, stage by stage (ms, plain ms, bound, TFLOP/s and
               share of the bound), and the whole forward.
  7. serve T - the same for Uformer_T (seeded numpy weights over the port's
               own parameter names): 4 requests of batch 8 at 256^2.
  8. timing T - as 6 for Uformer_T, and the window-attention core alone at
               its enc0 shape, at head dim 32 there and at four heads of
               512 windows, against its plain version and against
               F.scaled_dot_product_attention (a yardstick the port never
               calls).
  9. serve B-conv - Uformer_B's widths and depths with the conv token
               projection (seeded numpy weights over the port's parameter
               names): 4 bf16 requests of batch 8 at 256^2, 40 fused q/k/v
               depthwise and 40 LeFF launches each; host enqueue and
               device time.
 10. timing B-conv - per stage the depthwise kernel in both forms (the
               fused q/k/v launch the model runs, and three per-call
               launches) against its plain version, its bound and cuDNN
               (one grouped F.conv2d for the three convs; the depthwise
               F.conv2d per call: yardsticks the port never calls),
               eagerly and from CUDA graphs (device time alone), and how
               the forward splits
               between the depthwise kernel, the pointwise products, the
               plain attention, LeFF and the glue.
 11. train   - Uformer_B at 128^2 in training (drop path 0.1, mixup on):
               the forward kernels with residual=False and the backward
               kernels against their plain versions at every stage shape
               (shift 0 and 4, fp32 and bf16, every gradient) and one
               whole train step, kernel path against plain path (fp32 and
               bf16, loss and every parameter's gradient), at batch 2 and
               again at batch 32; bs 32 bf16 train steps: launches per
               step, loss, ms per step on both paths, peak memory; each
               kernel's time against its plain version at the bs 32
               shapes, forward and backward, and each backward's parts
               timed alone on the same buffers (kernel 7's A and B,
               kernel 6's body, the weight-gradient reductions beside
               torch.matmul(a.T, b), a yardstick the port never calls,
               and colsum); each backward kernel run twice on the same
               inputs must give equal bits.
 12. train T - the same for Uformer_T (its seeded weights): enc0's two
               blocks take the windowed branch, whose forward and backward
               kernels (attention_block, attention_block_bwd) are checked
               on its (Bw, 64, 16) windows, the other 16 blocks the image
               route at head dim 16; 16/2/18 forward and 16/2/18 backward
               launches (attention_image/attention_block/leff and
               attention_bwd/attention_block_bwd/leff_bwd) per step.
 13. train Mlp + cross-modulator - one bs 2 step of a linear-projection
               model with Mlp blocks and the cross-modulator (embed 16,
               Uformer_T's heads, depth 1), kernel path against plain
               path: its attention through kernels 1, 5 and 6, the Mlp and
               the cross-attention plain.
 14. eval    - the evaluation path: serve B's golden Uformer_B weights
               written as a reference-format .pth; the SIDD CLI
               (uformer_tpu_torch.eval.cli, in-process) restores a
               synthetic 2 x 32 x 256^2 validation set from it in bf16 and
               fp32 at batch 32, train_ps 128 (the bottleneck unshifted):
               6/4/4 launches per request and no plain call, Idenoised.mat
               and the model's outputs before the clamp against the plain
               path (the share of outputs outside [0, 1] printed);
               bf16_psnr_delta_db (bench.py's protocol, and on the SIDD
               score) within 0.05 dB; a 1280x720 GoPro frame padded per
               side (768 x 1280, bf16 and fp32), square-padded (1280^2,
               bf16) and tiled (256 tiles, overlap 32, 8 a call; bf16 and
               fp32), each against the plain path, clamped and before the
               clamp; the restore loop's MP/s on host arrays against the
               restorer's own at bs32 (and the plain path's), each kernel's
               fp32 time at bs32 256^2 against its plain version and its
               bound (4 bytes a value, the products three times at the
               TF32 rate and the rest at the float32 rate; the bound with
               every operation at the float32 rate beside it), every fp32
               stage and LeFF launch of the fp32 SIDD CLI and bs32 request
               on the three-pass TF32 bodies (`f32_bodies`), the
               scoring's seconds, the frame's ms and peak memory.
 15. train loop - the train CLI (uformer_tpu_torch.train.cli, in-process)
               with the reference denoise recipe: Uformer_B, bs32, 128^2,
               bf16, --warmup --warmup_epochs 1, on 256 seeded synthetic
               PNG pairs of 256^2 (8 steps an epoch, a validation every 2
               on 8 pairs of 256^2), two epochs with --checkpoint 2, then
               --resume --nepoch 3. Checks: 40/40/40/40 launches
               (attention_image, leff, attention_bwd, leff_bwd) every
               step, 6/4/4 every validation forward, no plain call; the
               first step (loss and every parameter after it) against
               make_train_step by hand (same weights, batch and generator
               state, cuDNN deterministic) within the bf16 whole-step
               rule; model_best, model_latest and model_epoch_2 load with
               weights_only, and model_best through a bf16 Restorer gives
               the logged best PSNR within 1e-3 dB; resume at epoch 3,
               step 16, weights and AdamW moments equal bits to the file,
               the logged LRs the schedule's; the native data plane built
               and equal bits to crop, dihedral and uint8 x float32(1/255)
               (within one ulp of the numpy plane, which divides).
               Numbers: the trainer's ms a step against the train phase's
               bare step, the device idle share between steps, the
               loader's MP/s (native and numpy, decoding and cached), the
               seconds per validation, save and resume, the checkpoint's
               MiB, peak memory.
 16. models  - UNet (the registry's dim 32, seeded numpy weights): 4 bf16
               requests of batch 8 at 256^2 through a Restorer (no kernel;
               against the fp32 result within the bf16 rule), ms a request,
               MP/s, peak memory; its weights as a reference-format .pth
               restored through the SIDD CLI with --arch UNet (equal bits
               to the restorer's output); one bs32 128^2 bf16 step against
               the fp32 step (the bf16 whole-step rule) and timed steps.
               Uformer_B and Uformer_T at bs32 128^2 bf16 (drop path 0.1,
               mixup on) with use_checkpoint and without, on the same
               weights, batch and generator state: loss, every gradient
               and the generator's state after the step in equal bits (a
               gradient that differs held within 1e-6 max(1, max|g|), and
               run twice unchecked to tell nondeterminism apart); launches
               80/80/40/40 and 32/4/36 + 16/2/18 a checkpointed step, no
               plain call; ms a step and peak memory both ways beside the
               reckoning (-0.4 to -0.5 GiB, +15-25%). LeFF with Eca1d at
               C 32, 128 and 512 (bs32 train shapes), fp32 and bf16: the
               forward through kernel 2 and every gradient through kernel
               7 against the plain version. Freeze: two bf16 steps of
               Uformer_B at bs2 with encoderlayer_* frozen: frozen tensors
               keep their bits, the others move with the unfrozen step's
               gradients, bit for bit. model_complexity of Uformer_B at
               256^2 over serve B's forward time (TFLOP/s and its share of
               989); serve B's forward under utils.debug.profile: the
               stage, LeFF and attention-image kernels named in
               summarize_trace and summed within 10% of phase 6's
               CUDA-event times; a NaN input under enable_nan_checks
               raises FloatingPointError naming input_proj.
 17. parallel - torch.distributed on the one card. NCCL at world size 1
               in this process: an all_reduce, and the DDP Uformer_B bs32
               128^2 bf16 step in equal bits to the bare step (same
               weights, batch and generator; 40/40/40/40 launches each),
               both timed in turns. Ranks spawned on cuda:0 over gloo
               (NCCL refuses two ranks on one GPU; their halos, rolls and
               gathers go through pinned host memory; a compute mode that
               keeps two processes off one card fails the phase): 2 ranks
               run the DDP step (bs32 global, 16 a rank, mixup on, drop
               path 0.1) against the one-process step (the bf16 whole-step
               rule; the generator's state in equal bits; 40/40/40/40
               launches a rank); serve B's Uformer_B forward of the
               1280x720 frame (padded to 768x1280) split along H, bf16 and
               fp32, against the unsharded model (fp32 within 1e-4 (1 +
               max|ref|), bf16 the serve rule; 40 kernel-5 and 40 kernel-2
               launches a rank, no plain call; ms a forward per rank and
               the exchanges' share of it); the eval CLI with --mesh_data
               2 --tile 256 on the frame against the one-process tiled
               output, and its GoPro harness (rank 0 writes). 4 ranks: the
               fp32 forward of 2 images of 256^2 (the bottleneck gathered
               and split again; kernel 5 once per image in a split stage,
               78 launches a rank). Kernel 5 alone at every (stage, rank)
               shape of both forwards, each rank's w_off, against its
               plain version, and timed at C 32-512 against its plain
               version and its bound. Windows 2, 4, 16 and 32
               (`--win_size`, embed 32): kernel 5 at every (stage, rank)
               shape, each rank's w_off, on 2 and 4 ranks (window 32: 2,
               at 512^2), and the 2-rank sharded forwards at windows 4,
               16 (256^2) and 32 (512^2, its side unpadded) against the
               unsharded kernel path; the 2-rank fp32 sharded forward of
               --embed_dim 48 at window 8 (256^2, head dim 48 in every
               block) against it too. Then `torchrun --nproc_per_node 2 -m
               uformer_tpu_torch.train.cli --mesh_data 2` (gloo, cuda:0)
               for an epoch of 2 steps: the weights' crc32 equal on both
               ranks, one log, rank 0's .pth files. The ranks time-slice
               one card: their ms are no scaling figure.
 18. geometries - windows 1-8 and head dim 8 in the forward kernels.
               Each extended kernel against its plain version, fp32 and
               bf16: kernel 5 at windows 1, 2, 3, 4, 6, 7 (shift 0, and
               win // 2 at w_off 37 with LN1) at head dim 8 (C 8, 16), at
               C 128-512 on 4- and 16-token windows (head dim 16, 32 and
               8) and at window 8, head dim 8; kernel 4 at every window
               1-8, head dim 8, 16, 32, shift 0 and win // 2; kernel 1 at
               head dim 8, C 32 and 64, shift 0 and 4, residual on and
               off; the stage at head dim 8, C 128, on 8^2 and 16^2; LeFF
               at C 8 with and without LN and residual on 8^2 and 64^2.
               The flagship golden (tests/golden/uformer_flagship.npz:
               embed 8, 64^2, the bottleneck at window 4) in fp32 through
               the kernels, stage by stage within 1e-4, 1/8/8/16 launches
               (stage/attention_image/attention_block/leff), no plain
               call. Serving (seeded numpy weights over each model's
               parameter names, as phase 5: 4 bf16 requests of batch 8 at
               256^2, launches each, no plain call, against the fp32
               plain path by the serve rule): Uformer_B at train_ps 64
               (5/4/2/6) and 32 (3/4/18/22), Uformer at embed 8
               (2/8/6/14), then Uformer at win_size 4 at batch 2
               (0/0/18/18); kernel 5 at the train_ps 64 and 32 stages and
               the stage and kernel 1 at head dim 8 timed against their
               plain versions and bounds, kernel 4 alone at those cells'
               cores beside SDPA; serve B's forward at train_ps
               64 against 128 in turns. The SIDD CLI at --train_ps 64 in
               bf16 from a .pth of seeded weights at that geometry (its
               launches, no plain call, Idenoised.mat against the plain
               path). Uformer at embed 8, window 2: the forward through
               the kernels (18 attention-block and 18 LeFF launches) and
               its train step (18 launches of each of kernels 5, 6, 2 and
               7, no plain call); an embed-20 step (head dim 20) refused
               before any launch.
 19. train geometries - the backward at windows 1-8 and head dim 8:
               kernel 6 on packed tiles at windows 1-7 (shift 0 and win //
               2, pad rows, partial last tiles) and at head dim 8 in both
               layouts (C 8-128), kernel 7 at C = 8 (LN and residual each
               way, its hidden unpadded and as the model pads it), kernel
               1's wide body at head dim 8, each against its plain version
               in fp32 and bf16; Uformer_B at train_ps 64, Uformer at embed
               8 and at win_size 4 (seeded 1244-1246): their kernels at
               every training geometry at bs2, one whole step kernel path
               against plain path (bs32 64², bs32 128², bs8 128²;
               38/2/40, 12/6/18 and 0/18/18 image-route / windowed / LeFF
               launches forward and backward; ps64's bf16 rows held and
               printed, its gate the step from the fp32 step's loss
               gradient at the output: `HELD_OWN_LOSS`), bf16 steps timed
               in turns
               and each backward call against its plain VJP and bound
               (kernel 6's: JAX's CostEstimate, 6 tokens C (4C + 2N)
               operations); the train CLI at the flagship golden's
               geometry (`--arch Uformer --embed_dim 8 --train_ps 64`, 16
               steps on seeded 64² pairs: 10/8/18 launches a step, no plain
               call, a loss that falls). Kernels 6 and 7 at C = 8 with LN
               (`c8_ln`) again at seeds 20-22 (DX_SEEDS), every gradient
               gated.
 20. wide windows - kernels 4, 5 and 6 at windows 9, 12 and 16 (N 81,
               144, 256), shift 0 and win // 2, head dim 8-32, LN and the
               modulator each way, against their plain versions (fp32,
               bf16 under phase 19's gates, each backward run twice: equal
               bits); `--arch Uformer --embed_dim 32 --win_size 16`
               (seeded 1247): 4 bf16 requests of batch 8 at 256^2 (18
               kernel-5 and 18 LeFF launches each, against the plain path)
               and each kernel's time per stage against its plain version
               and bound; at --train_ps 128 its kernels at every training
               geometry at bs2, one bs8 step kernel path against plain path
               (16/2/18 windowed / image / LeFF launches each way), bf16
               steps timed in turns with each backward call; a step with
               drop_rate 0.1 (18 windowed launches each way, the image
               route and the LeFF fold declined, as JAX routes it) and one
               with drop_rate = attn_drop_rate = 0.1 (no attention or LeFF
               kernel), each against the plain path on one generator and
               timed (masks drawn on the card); the train CLI at
               --win_size 16 (16 steps of bs4 on seeded 128^2 pairs);
               kernel 4 alone at N = 256 beside SDPA, and on the
               tensor-core core at N 256 (D 32, 64), 1024 and 4096
               beside SDPA, its bound and the CUDA-core core's earlier
               time (WIDE_CORE_ROWS); kernel 6's core alone at the same
               shapes, bf16 on the tensor cores and fp32 on the CUDA
               cores, beside autograd's backward of SDPA with one float
               mask that requires grad (its backend named) and the bound
               (`time_core_bwd`). Every kernel-6 call above window 8 in
               phases 17-25 is held to its body by dtype
               (`wide_bwd_bodies`: bf16 on the tensor cores, fp32 on the
               CUDA cores), and each bf16 train step prints its count.
 21. head dim 64 - `--arch Uformer --embed_dim 64` (every block at head
               dim 64, C 64-1024, hidden up to 4096) through the forward
               kernels. Each kernel against its plain version at every
               new shape, fp32 and bf16, each bf16 call timed beside its
               plain version and its bound: kernel 1 at C 64 (narrow body,
               one head, 2 x 256^2) and C 128-1024 (wide body, and one
               window a block at C 1024), shift 0 and 4, residual on and
               off; the stage at every stage of the model (C 128-1024,
               2 x 16^2-256^2); LeFF at C 64 and at C 1024 (hidden 4096)
               with LN and residual each way; kernel 5 at the train_ps-64
               bottleneck (window 4, C 1024, 16 heads), on windows 1-8 at
               C 64-1024, at w_off 0 and 37; kernel 4 at every window 1-8,
               head dim 64, shift 0 and win // 2, and alone beside SDPA at
               the cells' cores. Serving (seeded 1248, 1249): 4 bf16
               requests of batch 8 at 256^2 at train_ps 128 (8/2/0/2
               stage/attention-image/attention-block/LeFF launches) and 64
               (7/2/2/4), no plain call, against the plain path, each
               kernel per stage and the forward on both paths timed. The
               SIDD CLI in its default fp32 on one 256^2 frame at
               --embed_dim 64 (8/2/0/2, no plain call) against the plain
               path.
 22. head dim 64 training - head dim 64's backward. Kernel 6 in its
               three layouts (image, 8x8 windows, packed 4x4 windows) at
               head dim 64, C 64, 128, 512 and 1024, LN and the modulator
               each way, shift 0 and win // 2, windows split over heads and
               not; kernel 7 at C 1024 (hidden 4096), LN and residual each
               way, on 16^2 and 12^2 images; kernels 4, 5 and 6 at windows
               9, 12 and 16 at head dim 64 (C 64, 128, 1024): each against
               its plain version (fp32, bf16 under phase 19's gates), each
               backward run twice (equal bits), each call timed beside its
               plain version and bound; kernel 4 alone at N 256, head dim
               64, beside SDPA. Training cells (seeded 1248, 1249,
               1270): Uformer at --embed_dim 64, train_ps 128 (bs8; 18
               image-route and 18 LeFF launches each way) and 64 (bs32
               64^2; 16/2/18), and --win_size 16 (bs8 128^2; 16/2/18
               windowed / image / LeFF): their kernels at every training
               geometry, one whole step kernel path against plain path,
               bf16 steps timed in turns and each backward call against
               its plain VJP and bound; the win-16 model served (4 bf16
               requests of batch 8 at 256^2: 18 kernel-5 and 18 LeFF
               launches, no plain call, against the plain path, timed per
               kernel); the train CLI at --embed_dim 64 (16 steps of bs8 on
               seeded 128^2 pairs: 18/18/18/18 launches a step, no plain
               call, a loss that falls).
 23. windows above 16 - kernels 4, 5 and 6 at windows 17, 24 and 32 (N
               289, 576, 1024), shift 0 and win // 2, head dims 8, 32 and
               64, LN and the modulator each way, C 1024 at window 32, and
               kernels 5 and 6 at window 64 (N 4096): each against its
               plain version (fp32, bf16 under phase 19's gates), each
               backward run twice (equal bits) and at window 32 again with
               its dS in groups of one head of one window (equal bits on
               two runs, and to one group but dbias), each call timed
               beside its plain version and bound; kernel 4 alone at N
               1024 beside SDPA. The win-32 model (`--arch Uformer
               --embed_dim 32 --win_size 32`, seeded 1271) served (4 bf16
               requests of batch 8 at 256^2: 18 kernel-5 and 18 LeFF
               launches, no plain call, against the plain path, timed per
               kernel) and trained at --train_ps 128 (bs8: 16/2/18
               windowed / image / LeFF each way; its kernels at every
               training geometry, one whole step kernel path against
               plain path, bf16 steps and each backward call timed; the
               step's peak memory with dS in groups within the 256 MiB
               budget, beside a single group's buffer); the train CLI at
               --win_size 32 (16 steps of bs4 on seeded 128^2 pairs).
 24. head dims 24-56 - kernels 5, 3 and 2 at head dims 24, 40, 48 and 56
               (C = D nH for nH 1-16: 24-896, none a power of two):
               kernel 5 at window 8 at every (D, nH), LN and the modulator
               each way, w_off 0 and 37, and at window 4 (packed tiles)
               and 16 (csrc/attention_wide.cu) at two (D, nH) each; kernel
               3 at C 384 (head dims 24 and 48), 640, 768 and 896 on 16^2
               and 8^2; kernel 2 at every C, LN and residual each way;
               each against its plain version (fp32, bf16) and timed
               beside it and its bound. Uformer at --embed_dim 48 (seeded
               1283: 4 stage, 10 kernel-5 and 10 LeFF launches a request)
               and 24 (seeded 1284: 2/14/14) served (4 bf16 requests of
               batch 8 at 256^2, no plain call, against the plain path,
               timed per kernel, peak memory); one fp32 request of e48
               against the plain path. Phase 17 holds the 2-rank fp32
               sharded forward of e48 (seeded 1285) against the unsharded
               kernel path.
 25. train head dims 24-56 - the backward at head dims 24, 40, 48 and 56:
               kernel 1 and its VJP at C 384, 640, 768 and 896 (16
               heads, 2 x 16^2, the image route's widths); kernel 6 at
               window 8 at every (D, nH) of C 24-192 with LN and the
               modulator, on packed window-4 tiles and at window 16 at two
               (D, nH) each; kernel 7 at every new C, LN and residual each
               way; each against its plain version (fp32, bf16 pooled over
               4 draws), run twice (equal bits) and timed beside it and
               its bound. Training cells: Uformer at --embed_dim 48
               (seeded 1286: 8 image / 10 windowed / 18 LeFF launches
               each way a step) and 24 (seeded 1287: 4/14/18) at bs8
               128^2 by phase 19's rules (their kernels at every training
               geometry, one whole step kernel path against plain path in
               fp32 and bf16, bf16 steps timed with their peak memory,
               each backward call timed); the train CLI at --embed_dim 48
               (16 steps of bs8 on seeded 128^2 pairs, a save an epoch).

    python3 chip_smoke.py --only 25[,24,...]

runs the build and then only the named phases of 19-25 (by number or by
function name), each printing its result, then a kernels line of what
ran and the last line; it exits 1 without that line if a phase failed.

Tolerances: fp32 max-abs <= 1e-4 * (1 + max|ref|); bf16 error against the
fp32 plain result <= 1.5 x the bf16 plain version's error + 1e-3; for
gradients, per tensor, the bf16 term is 1e-3 * max(1, max|ref|), since
weight gradients are sums over every token, and phase 19 holds a gradient
of at most FEW_ENTRIES entries by its rms error instead; golden as
tests/test_golden_parity.py. --json PATH writes every check and timing
there. Each kernel's bound is the larger of its operations at the bf16
tensor-core peak and its bytes (inputs read once, outputs written once) at
the HBM rate of an H100 SXM (the depthwise kernel's operations, and the
eval phase's fp32 ones, at the float32 rate outside the tensor cores).
The line before the last lists every kernel (`launches_spatial` and
`launches_ddp`: rank 0's launches in phase 17's 2-rank bf16 spatial
forward and DDP step; `launches_ps64`, `_ps32`, `_e8`, `_win4`: a
request's in phase 18's serving, `launches_flagship` the golden's
forward, `launches_e8_win2_step` the embed-8 window-2 step's,
`launches_train_ps64`, `_e8`, `_win4` and `_cli` a step's in phase 19;
`launches_win16_serve` a request's in phase 20, `_train`, `_drop_*` and
`_cli` a step's there; `launches_head64_e64`, `_e64ps64` a request's in
phase 21, `_eval` the fp32 CLI frame's; `launches_e64train_e64`,
`_e64ps64`, `_e64win16` and `_cli` a step's in phase 22,
`_serve_win16` a request's; `launches_win32_serve` a request's in phase
23, `_train` and `_cli` a step's there; `launches_heads_e48`, `_e24` a
bf16 request's in phase 24, `_e48_fp32` the fp32 one's;
`launches_train_heads_e48`, `_e24` and `_cli` a step's in phase 25;
kernels 4, 5 and 6 carry `core_mma_launches` and `core_fma_launches`,
their core's launches above window 8 by body (bf16 on the tensor cores,
fp32 on the CUDA cores) summed over the sites in `core_bodies`: phase
20's kernel checks, a served request of each serve phase (kernel 5), a
bf16 train step of each train cell (kernel 6), phase 17's kernel 5 on
the spatial path; every bf16 request of phases 20, 22 and 23 runs the
tensor-core body at each kernel-5 launch and never the CUDA-core one,
every kernel-6 call above window 8 runs its dtype's body, and phase 17
holds each body's launches to its calls by dtype; kernel 6's entry adds
`wide_core_rows`, its core alone beside SDPA's backward);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import gc
import importlib.util
import itertools
import json
import queue
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
STARTED = time.perf_counter()  # the phases' clock (`phase`)
BATCH_CHECK, BATCH_SERVE, RES_SERVE, RES_GOLDEN = 2, 8, 256, 128
BATCH_TRAIN, RES_TRAIN, N_TRAIN_STEPS = 32, 128, 3
N_REQUESTS = 4
SEED_T = 1235  # Uformer_T's seeded weights
SEED_BCONV = 1236  # serve B-conv's seeded weights
EXPECTED_LAUNCHES = {"stage": 6, "attention_image": 4, "leff": 4,
                     "attention_bwd": 0, "attention_block_bwd": 0,
                     "leff_bwd": 0, "window_attention": 0,
                     "attention_block": 0, "dwconv3x3": 0,
                     "dwconv3x3_qkv": 0}
T_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0), stage=4,
                  attention_image=8, leff=10, attention_block=2)
TRAIN_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0), attention_image=40,
                      leff=40, attention_bwd=40, leff_bwd=40)
# a Uformer_T train step at 128^2: enc0's two blocks take the windowed
# branch (kernels 5 and 6 on windows), the other 16 the image route
T_TRAIN_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0),
                        attention_image=16, attention_block=2, leff=18,
                        attention_bwd=16, attention_block_bwd=2,
                        leff_bwd=18)
# the Mlp and cross-modulator model (embed 16, Uformer_T's heads, depth 1
# per stage, 128^2): attention through the kernels, Mlp and the
# cross-attention plain
MLP_CROSS = dict(img_size=RES_TRAIN, embed_dim=16, depths=(1,) * 9,
                 num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), win_size=8,
                 token_mlp="mlp", cross_modulator=True, modulator=True)
MLP_CROSS_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0),
                          attention_image=8, attention_bwd=8,
                          attention_block=1, attention_block_bwd=1)
SEED_MLP_CROSS = 1237
# serve B-conv: Uformer_B's widths and depths with the conv token
# projection (per block one launch of kernel 8 for the q, k and v
# depthwise convs: 40 launches)
BCONV = dict(img_size=RES_SERVE, embed_dim=32, depths=(1, 2, 8, 8, 2, 8, 8,
                                                       2, 1),
             num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), win_size=8,
             mlp_ratio=4.0, token_projection="conv", token_mlp="leff",
             modulator=True, shift_flag=True)
BCONV_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0), leff=40,
                      dwconv3x3_qkv=40)
GOLDEN_CONV_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0),
                            dwconv3x3_qkv=9)
# the eval phase: Uformer_B at the eval CLI's train_ps of 128 (its
# bottleneck unshifted), a synthetic SIDD validation set (images, blocks,
# side; SIDD's own is 40 x 32 x 256^2) restored at the reference's batch
# of 32 blocks, a GoPro frame (H, W) whole and in tiles
EVAL_TRAIN_PS, SIDD_SET, SIDD_BATCH = 128, (2, 32, 256), 32
GOPRO_HW, EVAL_TILE = (720, 1280), dict(tile=256, overlap=32, tile_batch=8)
BF16_PSNR_BUDGET_DB = 0.05  # BASELINE.json, ROADMAP.md
# H100 SXM (NVIDIA data sheet): dense bf16 tensor-core FLOP/s, float32
# FLOP/s outside the tensor cores, HBM bytes/s, dense TF32 tensor-core
# FLOP/s (the fp32 bodies' products take three TF32 passes)
PEAK_BF16, PEAK_FP32, PEAK_HBM = 989e12, 67e12, 3.35e12
PEAK_TF32 = 495e12
# the fp32 block alone (csrc/mma_tf32.cuh) at the stage's output
# projection: (rows, C) of the C x C product, enc2's and dec0's tokens of
# the bs32 256^2 fp32 eval request
F32_TILE_SHAPES = [(131072, 128), (32768, 512)]
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "stage": ("uformer_tpu_torch/csrc/stage.cu",
              "uformer_tpu/ops/pallas/stage.py:418"),
    "attention_image": ("uformer_tpu_torch/csrc/attention_image.cu",
                        "uformer_tpu/ops/pallas/attention_image.py:652"),
    "leff": ("uformer_tpu_torch/csrc/leff.cu",
             "uformer_tpu/ops/pallas/leff.py:1132"),
    "attention_bwd": ("uformer_tpu_torch/csrc/attention_bwd.cu",
                      "uformer_tpu/ops/pallas/attention_block.py:877"),
    "attention_block_bwd": ("uformer_tpu_torch/csrc/attention_block_bwd.cu",
                            "uformer_tpu/ops/pallas/attention_block.py:877"),
    "leff_bwd": ("uformer_tpu_torch/csrc/leff_bwd.cu",
                 "uformer_tpu/ops/pallas/leff.py:880"),
    "window_attention": ("uformer_tpu_torch/csrc/window_attention.cu",
                         "uformer_tpu/ops/pallas/window_attention.py:97"),
    "attention_block": ("uformer_tpu_torch/csrc/attention_block.cu",
                        "uformer_tpu/ops/pallas/attention_block.py:1152"),
    "dwconv3x3": ("uformer_tpu_torch/csrc/dwconv.cu",
                  "uformer_tpu/ops/pallas/dwconv.py:52"),
}
# the tensor-core tiles' own shapes (csrc/leff_mma.cuh): (M, N, K, n8
# tiles a warp takes) of the building block; LeFF images (B, H, W, C);
# stages (B, C, nH, res, n, use_shift, has_mod): the conv stage's 8 x 8
# at C = 512, shift at C = 256, then batches at which the host picks
# 16-row LeFF tiles and 2 or 4 windows per attention item
TILE_BLOCK_SHAPES = [(112, 64, 512, 4), (64, 512, 64, 4), (192, 64, 64, 4),
                     (128, 32, 64, 2), (128, 16, 64, 1), (100, 32, 128, 2)]
TILE_LEFF_SHAPES = ([(2, 8, 8, C) for C in (16, 32, 64, 128, 256, 512)]
                    + [(1, 16, 24, C) for C in (16, 32, 64, 128, 256, 512)]
                    + [(1, 24, 40, C) for C in (16, 32, 64, 128, 256, 512)]
                    + [(2, 64, 64, 32), (4, 64, 64, 128), (4, 64, 64, 256)])
TILE_STAGE_SHAPES = [(BATCH_CHECK, 512, 16, 8, 2, False, True),
                     (BATCH_CHECK, 256, 8, 16, 2, True, True),
                     (4, 256, 8, 64, 2, True, True),
                     (4, 128, 4, 64, 2, True, False),
                     (8, 128, 8, 64, 2, True, True)]
# kernel 1 on the main paths (cell, stage, B, res, C, heads, modulator):
# serve B and serve T at bs8 256^2, the train and train T steps at bs32
# 128^2 (train T's enc0 takes the windowed branch, kernel 5)
ATTN_IMAGE_SHAPES = (
    [("serve B", "enc0", 8, 256, 32, 1, False),
     ("serve B", "enc1", 8, 128, 64, 2, False),
     ("serve B", "dec3", 8, 256, 64, 2, True),
     ("serve T", "enc1", 8, 128, 32, 2, False),
     ("serve T", "enc2", 8, 64, 64, 4, False),
     ("serve T", "dec2", 8, 128, 64, 4, True),
     ("serve T", "dec3", 8, 256, 32, 2, True)]
    + [("train", f"enc{k}", 32, 128 >> k, 32 << k, 1 << k, False)
       for k in range(4)]
    + [("train", "conv", 32, 8, 512, 16, False),
       ("train", "dec0", 32, 16, 512, 16, True),
       ("train", "dec1", 32, 32, 256, 8, True),
       ("train", "dec2", 32, 64, 128, 4, True),
       ("train", "dec3", 32, 128, 64, 2, True)]
    + [("train T", f"enc{k + 1}", 32, 64 >> k, 32 << k, 2 << k, False)
       for k in range(3)]
    + [("train T", "conv", 32, 8, 256, 16, False),
       ("train T", "dec0", 32, 16, 256, 16, True),
       ("train T", "dec1", 32, 32, 128, 8, True),
       ("train T", "dec2", 32, 64, 64, 4, True),
       ("train T", "dec3", 32, 128, 32, 2, True)])
STAGES = (["input_proj"] + [f"encoderlayer_{k}" for k in range(4)]
          + [f"dowsample_{k}" for k in range(4)] + ["conv"]
          + [f"upsample_{k}" for k in range(4)]
          + [f"decoderlayer_{k}" for k in range(4)] + ["output_proj"])
LAYERS = ([f"encoderlayer_{k}" for k in range(4)] + ["conv"]
          + [f"decoderlayer_{k}" for k in range(4)])


def phase(name: str) -> None:
    """A phase's header, with the seconds since the script's import."""
    print(f"== {name} (at {time.perf_counter() - STARTED:.1f} s)",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def rms_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).pow(2).mean().sqrt())


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of fn() over reps, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, n: int = 20) -> float:
    """Device time of one fn() from a CUDA graph of n calls, replayed 5
    times: the kernels alone, without the host's cost of launching them."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay) / n


def attn_cost(tokens, C, nH, s=2, mod=True, ln=True, N=64):
    """(operations, bytes) of an attention sub-block (kernels 1 and 5) over
    `tokens` tokens of width C in windows of N tokens: the q, kv and output
    projections and two N x N x D products per head and window; x read and
    y written once, the weights, biases, bias table [, modulator, LN] read
    once."""
    weights = (4 * C * C * s + 4 * C * 4 + nH * N * N * 4
               + (N * C * s if mod else 0) + (2 * C * 4 if ln else 0))
    return 2 * tokens * C * (4 * C + 2 * N), 2 * tokens * C * s + weights


def leff_cost(tokens, C, Ch, s=2):
    """(operations, bytes) of a LeFF sub-block: two C x Ch products and
    the 3 x 3 depthwise taps per token; x, y and the weights once."""
    return (tokens * (4 * C * Ch + 18 * Ch),
            2 * tokens * C * s + (2 * C * Ch + 9 * Ch) * s
            + (2 * Ch + 3 * C) * 4)


def stage_cost(tokens, C, nH, Ch, n, s=2, mod=True):
    """n blocks of a stage: the stage image in and out once, every
    block's weights once."""
    fa, ba = attn_cost(tokens, C, nH, s, mod)
    fl, bl = leff_cost(tokens, C, Ch, s)
    act = 2 * tokens * C * s
    return n * (fa + fl), act + n * (ba + bl - 2 * act)


def core_cost(nH, Bw, D, s=2, N=64):
    """The window-attention core on windows of N tokens: q, k, v read and
    the output written."""
    return (4 * nH * Bw * N * N * D,
            4 * nH * Bw * N * D * s + nH * N * N * 4)


def dwconv_cost(pixels, C, s=2, ws=2, nq=1):
    """nq depthwise 3x3 convs of one input (nq = 3: the fused q/k/v form):
    nine multiply-adds and the bias per output value; x read once and each
    output written once, each weight set (ws bytes) and float32 bias
    once."""
    return (19 * nq * pixels * C,
            (1 + nq) * pixels * C * s + nq * (9 * C * ws + 4 * C))


def bwd_cost(fwd, tokens, C, s=2):
    """A backward kernel of a sub-block of cost `fwd`: twice its products
    (input and weight gradients); x and the output gradient read, dx
    written, the weights read and their float32 gradients written."""
    flops, nbytes = fwd
    weights = nbytes - 2 * tokens * C * s
    return 2 * flops, 3 * tokens * C * s + 3 * weights


def ptxas_report(text: str) -> list:
    """[name, registers (None for a device function), spill store bytes,
    spill load bytes] of each function in `nvcc -Xptxas -v` output."""
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            rows.append([name, None, int(m[1]), int(m[2])])
            name = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][1] is None:
            rows[-1][1] = int(m[1])
    return rows


def rate(cost, k_ms: float, b_ms: float) -> str:
    """TFLOP/s of a call of `cost` = (operations, bytes) taking k_ms, and
    its bound b_ms as a share of k_ms."""
    return (f"{cost[0] / (k_ms * 1e-3) / 1e12:7.2f} TFLOP/s, "
            f"{100.0 * b_ms / k_ms:5.1f}% of bound")


def tally(totals: dict, kernel: str, k_ms: float, p_ms: float, cost,
          n: int = 1, peak: float = PEAK_BF16,
          products: float = None) -> float:
    """Add n calls of `kernel` (its time, its plain version's, and the
    bound of `cost` = (operations, bytes), the operations at `peak`) to
    totals; returns the bound of the n calls in ms. With `products` (the
    operations of its matrix products, fp32): the operations' time is
    the products three times at the TF32 rate (the three-pass split) and
    the rest at the fp32 rate, and `bound_fp32_ms` keeps the bound with
    every operation at the fp32 rate beside it."""
    t = totals.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0,
                                   "launches": 0, "bound_ms": 0.0,
                                   "op_ms": 0.0, "byte_ms": 0.0})
    op, byte = cost[0] / peak * 1e3, cost[1] / PEAK_HBM * 1e3
    if products is not None:
        t.setdefault("bound_fp32_ms", 0.0)
        t["bound_fp32_ms"] += n * max(cost[0] / PEAK_FP32 * 1e3, byte)
        op = (3 * products / PEAK_TF32
              + (cost[0] - products) / PEAK_FP32) * 1e3
    t["ms"] += n * k_ms
    t["plain_ms"] += n * p_ms
    t["launches"] += n
    t["bound_ms"] += n * max(op, byte)
    t["op_ms"] += n * op
    t["byte_ms"] += n * byte
    return n * max(op, byte)


def bound_by(t: dict) -> str:
    return "operations" if t["op_ms"] >= t["byte_ms"] else "bytes"


def kernel_count(counts: dict, name: str) -> int:
    """Launches of the TPU kernel `name` in a launch_counts() dict: kernel
    8 in either of its forms (dwconv3x3, dwconv3x3_qkv)."""
    return counts[name] + (counts["dwconv3x3_qkv"] if name == "dwconv3x3"
                           else 0)


def wide_bwd_calls(model) -> int:
    """Kernel 6's calls above window 8 in one train step of `model`: each
    windowed block off the image route whose window passes 8 runs its
    backward once."""
    from uformer_tpu_torch.models.layers import LeWinBlock

    return sum(isinstance(b, LeWinBlock) and not b.image_route
               and b.win_size ** 2 > 64 for b in model.modules())


def wide_bodies_now() -> dict:
    from uformer_tpu_torch.ops import kernels as K

    return dict(K.core_counts()["attention_block_bwd"])


def wide_bodies_line(steps: dict) -> str:
    """A step's kernel-6 core launches above window 8 by body, in words."""
    b = steps["wide_bwd_bodies"]
    return (f"kernel 6 above window 8 {b['core_mma_launches']} tensor-core "
            f"and {b['core_fma_launches']} CUDA-core launches a step")


def wide_bwd_bodies(label: str, bf16_calls: int, fp32_calls: int,
                    before: dict = None) -> dict:
    """Kernel 6's core launches above window 8 by body (`K.core_counts`,
    since `before` or else since the last reset) against its calls there
    by dtype: every bf16 call on the tensor-core body and none on the
    CUDA-core one, every fp32 call on the CUDA-core body. Raises
    otherwise; returns the counts."""
    now = wide_bodies_now()
    got = {k: v - (before or {}).get(k, 0) for k, v in now.items()}
    want = {"core_mma_launches": bf16_calls, "core_fma_launches": fp32_calls}
    if got != want:
        raise RuntimeError(f"{label}: kernel 6's core above window 8 ran "
                           f"{got}, expected {want}")
    return got


@contextlib.contextmanager
def without_init():
    """Modules built inside skip torch.nn.init's random fills: for a model
    whose every parameter is then loaded (`load_numpy_state_dict` raises
    on a missing one), or whose parameters' names and shapes alone are
    read. The fills cost seconds a model on the host."""
    init = torch.nn.init
    fills = {n: getattr(init, n) for n in ("kaiming_uniform_", "uniform_",
                                           "normal_", "trunc_normal_")}
    for n in fills:
        setattr(init, n, lambda t, *a, **k: t)
    try:
        yield
    finally:
        for n, f in fills.items():
            setattr(init, n, f)


def golden_module():
    """tests/golden/generate.py, loaded by path: a site package named
    `tests` may shadow the repo's directory."""
    spec = importlib.util.spec_from_file_location(
        "golden_generate", REPO / "tests" / "golden" / "generate.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def seeded_weights():
    """The golden Uformer_B state_dict, regenerated from its seed (numpy)."""
    data = np.load(REPO / "tests" / "golden" / "uformer_b_128.npz")
    keys_shapes = json.loads(str(data["sd_manifest"]))
    return data, golden_module().seeded_state_dict(keys_shapes,
                                                   int(data["seed"]))


def bconv_weights():
    """serve B-conv's weights drawn with numpy from SEED_BCONV over the
    port's own parameter names, by the golden weights' rule."""
    from uformer_tpu_torch.models import Uformer

    model = Uformer(**BCONV)
    keys_shapes = [[k, list(v.shape)] for k, v in model.named_parameters()]
    return golden_module().seeded_state_dict(keys_shapes, SEED_BCONV)


def build_bconv(sd, device):
    from uformer_tpu_torch.convert import load_numpy_state_dict
    from uformer_tpu_torch.models import Uformer

    return load_numpy_state_dict(Uformer(**BCONV), sd).to(device).eval()


def build_model(sd, train_ps: int, device, arch: str = "Uformer_B"):
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.convert import load_numpy_state_dict

    with without_init():
        model = get_arch({"arch": arch, "train_ps": train_ps})
    return load_numpy_state_dict(model, sd).to(device).eval()


def t_weights():
    """Uformer_T's weights drawn with numpy from SEED_T over the port's own
    parameter names, by the golden weights' rule (N(0, 1/fan_in) matrices,
    LayerNorm scales near 1, small biases)."""
    from uformer_tpu_torch import get_arch

    with without_init():
        model = get_arch({"arch": "Uformer_T"})
    keys_shapes = [[k, list(v.shape)] for k, v in model.named_parameters()]
    return golden_module().seeded_state_dict(keys_shapes, SEED_T)


class Checks:
    """Collects comparisons of one phase; prints each failure, and at the
    phase's end the worst err/bound per dtype; raises if any failed. The
    --json report keeps every row."""

    def __init__(self):
        self.rows, self.failed = [], []

    def add(self, kernel: str, what: str, err: float, bound: float,
            dtype: str) -> None:
        ok = err <= bound
        self.rows.append({"kernel": kernel, "what": what, "dtype": dtype,
                          "err": err, "bound": bound, "ok": ok})
        if not ok:
            print(f"  FAIL {kernel:16s} {dtype:5s} {what:44s} err "
                  f"{err:.3e} > {bound:.3e}", flush=True)
            self.failed.append(f"{kernel} {dtype} {what}")

    def raise_if_failed(self, phase_name: str) -> None:
        for dt in ("fp32", "bf16", "bf16 rms"):
            rows = [r for r in self.rows if r["dtype"] == dt]
            if not rows:
                continue
            worst = max(rows, key=lambda r: r["err"] / r["bound"])
            print(f"  {phase_name}: {len(rows)} {dt} checks, worst "
                  f"err/bound {worst['err'] / worst['bound']:.3f} "
                  f"({worst['kernel']} {worst['what']})", flush=True)
        if self.failed:
            raise RuntimeError(f"{phase_name}: {len(self.failed)} failed: "
                               f"{self.failed}")


def compare(checks: Checks, kernel: str, what: str, fused, plain, x32):
    """fp32: kernel vs plain; bf16: the kernel's error against the fp32
    plain result within 1.5x the bf16 plain version's + 1e-3. x32 holds
    bf16-representable values, so both dtypes see the same input."""
    ref32 = plain(x32, torch.float32)
    checks.add(kernel, what, max_err(fused(x32, torch.float32), ref32),
               1e-4 * (1.0 + float(ref32.abs().max())), "fp32")
    x16 = x32.bfloat16()
    e_plain = max_err(plain(x16, torch.bfloat16), ref32)
    checks.add(kernel, what, max_err(fused(x16, torch.bfloat16), ref32),
               1.5 * e_plain + 1e-3, "bf16")


@torch.no_grad()
def kernel_phase(model, device) -> Checks:
    """Every kernel against its plain version at the main-path shapes of
    `model` at 256^2, batch BATCH_CHECK, with the model's own weights: the
    stage kernel, or per block the attention-image kernel or, off the
    image route, the attention-block kernel (block_checks), and LeFF."""
    from uformer_tpu_torch.ops import kernels as K

    checks = Checks()
    gen = torch.Generator(device="cpu").manual_seed(0)
    for name in LAYERS:
        layer = getattr(model, name)
        res = layer.resolution
        shape = (BATCH_CHECK, res, res, layer.dim)
        x32 = torch.randn(shape, generator=gen).bfloat16().float().to(device)
        if layer.stage_ok:
            prm = {dt: layer.kernel_params(dt)
                   for dt in (torch.float32, torch.bfloat16)}
            kw = dict(scale=layer.blocks[0].attn.scale,
                      num_heads=layer.num_heads, use_shift=layer.use_shift,
                      has_mod=layer.has_mod)
            compare(checks, "stage", f"{name} {shape} n={len(layer.blocks)} "
                    f"nH={layer.num_heads}",
                    lambda x, dt: K.fused_stage(x, prm[dt], **kw),
                    lambda x, dt: K.stage_reference(x, prm[dt], **kw), x32)
            continue
        for i, blk in enumerate(layer.blocks):
            prm = {dt: blk.kernel_params(dt)
                   for dt in (torch.float32, torch.bfloat16)}
            what = (f"{name}.{i} {shape} nH={blk.num_heads} "
                    f"shift={blk.shift_size}")

            def attn(fn):
                return lambda x, dt: fn(
                    x, prm[dt]["mod"], prm[dt]["ln1_s"], prm[dt]["ln1_b"],
                    prm[dt]["wq"], prm[dt]["bq"], prm[dt]["wkv"],
                    prm[dt]["bkv"], prm[dt]["wo"], prm[dt]["bo"],
                    prm[dt]["bias"], win=blk.win_size, shift=blk.shift_size,
                    scale=blk.attn.scale, num_heads=blk.num_heads)

            def leff(fn):
                return lambda x, dt: fn(
                    x, prm[dt]["w1"], prm[dt]["b1"], prm[dt]["wd"],
                    prm[dt]["bd"], prm[dt]["w2"], prm[dt]["b2"],
                    ln_s=prm[dt]["ln2_s"], ln_b=prm[dt]["ln2_b"],
                    residual=True)

            if blk.image_route:
                compare(checks, "attention_image", what,
                        attn(K.fused_attention_image),
                        attn(K.attention_image_reference), x32)
            else:
                block_checks(checks, blk, prm, shape, gen, device, what)
            compare(checks, "leff", what, leff(K.fused_leff),
                    leff(K.leff_reference), x32)
    torch.cuda.synchronize()
    return checks


def block_checks(checks: Checks, blk, prm, shape, gen, device,
                 what: str) -> None:
    """The attention-block kernel at blk's geometry on random windows of
    `shape` images at batch 1, B and 3 (tails of the persistent grid),
    with LN and a modulator each on and off (the model runs it with LN
    outside, and with the block's own modulator), the windows at place 0
    and at place 37 of the image's (wrapping past the last)."""
    from uformer_tpu_torch.ops import kernels as K

    B, H, W, C = shape
    mod = torch.randn((64, C), generator=gen).bfloat16().float().to(device)
    for batch in (1, B, 3):
        wnd = torch.randn((batch * H * W // 64, 64, C), generator=gen) \
            .bfloat16().float().to(device)
        for w_off, has_ln, with_mod in itertools.product(
                (0, 37), (False, True), (False, True)):
            def run(fn, has_ln=has_ln, with_mod=with_mod, w_off=w_off):
                return lambda x, dt: fn(
                    x, mod.to(dt) if with_mod else None, prm[dt]["ln1_s"],
                    prm[dt]["ln1_b"], *(prm[dt][k] for k in (
                        "wq", "bq", "wkv", "bkv", "wo", "bo", "bias")),
                    win=blk.win_size, shift=blk.shift_size, H=H, W=W,
                    scale=blk.attn.scale, num_heads=blk.num_heads,
                    has_ln=has_ln, w_off=w_off)

            compare(checks, "attention_block",
                    f"{what} Bw={wnd.shape[0]} w_off={w_off} "
                    f"ln={int(has_ln)} mod={int(with_mod)}",
                    run(K.fused_attention_block),
                    run(K.attention_block_reference), wnd)


def core_checks(checks: Checks, model, names, device, gen) -> None:
    """The window-attention core at the (resolution, heads) of each named
    stage of `model` at 256^2, batch BATCH_CHECK, and on 37 windows more
    (a range of work items that no grid divides), with the bias of the
    stage's first block, at each shift the stage runs."""
    from uformer_tpu_torch.ops import kernels as K

    for name in names:
        layer = getattr(model, name)
        res, nH = layer.resolution, layer.num_heads
        D = layer.dim // nH
        bias = layer.blocks[0].kernel_params(torch.float32)["bias"]
        for Bw in (BATCH_CHECK * (res // 8) ** 2,
                   BATCH_CHECK * (res // 8) ** 2 + 37):
            q, k, v = (torch.randn((nH, Bw, 64, D), generator=gen)
                       .bfloat16().float().to(device) for _ in range(3))
            for shift in ((0, 4) if layer.use_shift else (0,)):
                kw = dict(win=8, shift=shift, H=res, W=res, scale=D ** -0.5)

                def run(fn, kw=kw, k=k, v=v, bias=bias):
                    return lambda x, dt: fn(x, k.to(dt), v.to(dt), bias,
                                            **kw)

                compare(checks, "window_attention",
                        f"{name} (nH, Bw, 64, D)=({nH}, {Bw}, 64, {D}) "
                        f"shift={shift}", run(K.fused_window_attention),
                        run(K.window_attention_reference), q)


@torch.no_grad()
def kernel_phase_t(model_t, model_b, device) -> Checks:
    """Uformer_T's main-path shapes at 256^2 (head dim 16 throughout), the
    core at every stage, and kernels 4 and 5 at Uformer_B's enc1 (C 64,
    two heads of 32, shift 4)."""
    checks = kernel_phase(model_t, device)
    gen = torch.Generator(device="cpu").manual_seed(7)
    core_checks(checks, model_t, LAYERS, device, gen)
    core_checks(checks, model_b, ["encoderlayer_1"], device, gen)
    layer = model_b.encoderlayer_1
    blk = layer.blocks[1]
    prm = {dt: blk.kernel_params(dt) for dt in (torch.float32, torch.bfloat16)}
    block_checks(checks, blk, prm, (BATCH_CHECK, layer.resolution,
                                    layer.resolution, layer.dim), gen,
                 device, f"Uformer_B encoderlayer_1.1 shift={blk.shift_size}")
    torch.cuda.synchronize()
    return checks


@torch.no_grad()
def attention_image_phase(device) -> Checks:
    """Kernel 1 against its plain version at every ATTN_IMAGE_SHAPES shape
    (bf16: the narrow body at C 16-64, the wide one at C 128-512, windows
    per work item as the host plans them; fp32: a window per block),
    residual on and off (training runs both), shift 4 where the image is
    wider than a window, on random weights (matrices N(0, 1 / C))."""
    from uformer_tpu_torch.ops import kernels as K

    checks = Checks()
    gen = torch.Generator(device="cpu").manual_seed(12)
    low = ("mod", "wq", "wkv", "wo")

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    for cell, stage, B, R, C, nH, with_mod in ATTN_IMAGE_SHAPES:
        s = C ** -0.5
        w = dict(mod=rnd(64, C, scale=0.1) if with_mod else None,
                 ln_s=1.0 + rnd(C, scale=0.1), ln_b=rnd(C, scale=0.1),
                 wq=rnd(C, C, scale=s), bq=rnd(C, scale=0.1),
                 wkv=rnd(C, 2 * C, scale=s), bkv=rnd(2 * C, scale=0.1),
                 wo=rnd(C, C, scale=s), bo=rnd(C, scale=0.1),
                 bias=rnd(nH, 64, 64, scale=0.5))
        w = {k: v.bfloat16().float() if v is not None and k in low else v
             for k, v in w.items()}
        prm = {dt: [v.to(dt) if v is not None and k in low else v
                    for k, v in w.items()]
               for dt in (torch.float32, torch.bfloat16)}
        x32 = rnd(B, R, R, C).bfloat16().float()
        for residual in (True, False):
            kw = dict(win=8, shift=4 if R > 8 else 0, scale=(C // nH) ** -0.5,
                      num_heads=nH, residual=residual)

            def run(fn, kw=kw, prm=prm):
                return lambda x, dt: fn(x, *prm[dt], **kw)

            compare(checks, "attention_image",
                    f"{cell} {stage} ({B}, {R}, {R}, {C}) nH={nH} "
                    f"res={int(residual)}", run(K.fused_attention_image),
                    run(K.attention_image_reference), x32)
        del x32, prm, w
    torch.cuda.synchronize()
    return checks


@torch.no_grad()
def dwconv_phase(model, device) -> Checks:
    """The depthwise kernel against its plain version in fp32 and bf16 (bf16
    weights, fp32 bias): at every serve B-conv stage's (Bw, 8, 8, C)
    windows at 256^2, batch BATCH_CHECK, with the stage's first to_q
    weights and bias; then on random weights at the 64^2 golden's 4 x 4
    bottleneck windows, a whole image, an odd C without bias (the scalar
    path) and C = 8. The fused q/k/v form (dwconv3x3_qkv, ReLU on) at
    every stage's windows with the block's three weight sets, and at the
    other shapes on three random ones: against its plain version, and
    equal bits to three dwconv3x3 launches and F.relu (a check with bound
    0)."""
    from uformer_tpu_torch.ops import kernels as K

    checks = Checks()
    gen = torch.Generator(device="cpu").manual_seed(9)
    cases = []
    for name in LAYERS:
        layer = getattr(model, name)
        qkv = layer.blocks[0].attn.qkv
        w3 = torch.stack([getattr(qkv, n).depthwise.weight[:, 0]
                          .permute(1, 2, 0) for n in ("to_q", "to_k",
                                                      "to_v")])
        b3 = torch.stack([getattr(qkv, n).depthwise.bias
                          for n in ("to_q", "to_k", "to_v")])
        cases.append((f"{name} windows", (BATCH_CHECK * (layer.resolution
                                                         // 8) ** 2, 8, 8,
                                          layer.dim), w3, b3))
    for what, shape, with_bias in (("4x4 windows", (2, 4, 4, 128), True),
                                   ("image", (2, 64, 64, 128), True),
                                   ("odd C, no bias", (2, 24, 40, 12), False),
                                   ("C 8", (128, 8, 8, 8), True)):
        C = shape[-1]
        w3 = torch.randn((3, 3, 3, C), generator=gen) / 3
        b3 = torch.randn(3, C, generator=gen) * 0.1 if with_bias else None
        cases.append((what, shape, w3, b3))
    for what, shape, w3, b3 in cases:
        w3 = w3.detach().float().bfloat16().float().to(device).contiguous()
        b3 = None if b3 is None else b3.detach().float().to(device)
        ws = {torch.float32: w3, torch.bfloat16: w3.bfloat16()}
        b = None if b3 is None else b3[0]
        x32 = torch.randn(shape, generator=gen).bfloat16().float().to(device)
        compare(checks, "dwconv3x3", f"{what} {shape}",
                lambda x, dt, ws=ws, b=b: K.dwconv3x3(x, ws[dt][0], b),
                lambda x, dt, ws=ws, b=b: K.dwconv3x3_reference(
                    x, ws[dt][0], b), x32)
        compare(checks, "dwconv3x3", f"qkv {what} {shape}",
                lambda x, dt, ws=ws, b3=b3: torch.stack(K.dwconv3x3_qkv(
                    x, ws[dt], b3)),
                lambda x, dt, ws=ws, b3=b3: torch.stack(
                    K.dwconv3x3_qkv_reference(x, ws[dt], b3)), x32)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            fused = K.dwconv3x3_qkv(x, ws[dt], b3)
            # clones: a slice of the stacked weights need not be aligned
            differ = sum(not torch.equal(y, F.relu(K.dwconv3x3(
                x, ws[dt][i].clone(), None if b3 is None else b3[i].clone())))
                for i, y in enumerate(fused))
            checks.add("dwconv3x3", f"qkv = 3 launches + ReLU {what} {shape} "
                       f"{str(dt)[6:]}", float(differ), 0.0, "bits")
    torch.cuda.synchronize()
    return checks


@torch.no_grad()
def tile_phase(device) -> Checks:
    """The tensor-core tiles at their own shapes (TILE_*_SHAPES) on random
    weights (matrices N(0, 1 / fan-in)): the building block against
    torch.matmul on the same bf16 values (fp32, TF32 off: the products are
    exact, only the order of the sums differs); LeFF and the stage kernel
    against their plain versions in fp32 and bf16."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.kernels.mma import block_product

    checks = Checks()
    gen = torch.Generator(device="cpu").manual_seed(11)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)

    for M, N, Kd, nt in TILE_BLOCK_SHAPES:
        a = rnd(M, Kd, dtype=torch.bfloat16)
        b = rnd(Kd, N, dtype=torch.bfloat16)
        ref = torch.matmul(a.float(), b.float())
        checks.add("block_product", f"({M}, {Kd}) @ ({Kd}, {N}) nt={nt}",
                   max_err(block_product(a, b, nt), ref),
                   1e-4 * (1.0 + float(ref.abs().max())), "fp32")
    for shape in TILE_LEFF_SHAPES:
        C = shape[-1]
        Ch = 4 * C
        w = dict(w1=rnd(C, Ch, scale=C ** -0.5), b1=rnd(Ch, scale=0.1),
                 wd=rnd(3, 3, Ch, scale=1 / 3), bd=rnd(Ch, scale=0.1),
                 w2=rnd(Ch, C, scale=Ch ** -0.5), b2=rnd(C, scale=0.1))
        w = {k: v.bfloat16().float() for k, v in w.items()}
        ln = dict(ln_s=1.0 + rnd(C, scale=0.1), ln_b=rnd(C, scale=0.1))
        ws = {dt: {k: v.to(dt) if k in ("w1", "wd", "w2") else v
                   for k, v in w.items()}
              for dt in (torch.float32, torch.bfloat16)}
        x32 = rnd(*shape).bfloat16().float()

        def leff(fn, ws=ws, ln=ln):
            return lambda x, dt: fn(x, *(ws[dt][k] for k in (
                "w1", "b1", "wd", "bd", "w2", "b2")), residual=True, **ln)

        compare(checks, "leff", f"tile {shape}", leff(K.fused_leff),
                leff(K.leff_reference), x32)
    for B, C, nH, res, n, use_shift, has_mod in TILE_STAGE_SHAPES:
        Ch = 4 * C
        p = dict(ln1_s=1.0 + rnd(n, C, scale=0.1), ln1_b=rnd(n, C, scale=0.1),
                 wq=rnd(n, C, C, scale=C ** -0.5), bq=rnd(n, C, scale=0.1),
                 wk=rnd(n, C, C, scale=C ** -0.5), bk=rnd(n, C, scale=0.1),
                 wv=rnd(n, C, C, scale=C ** -0.5), bv=rnd(n, C, scale=0.1),
                 wo=rnd(n, C, C, scale=C ** -0.5), bo=rnd(n, C, scale=0.1),
                 bias=rnd(n, nH, 64, 64, scale=0.5),
                 mod=rnd(n, 64, C, scale=0.1),
                 ln2_s=1.0 + rnd(n, C, scale=0.1), ln2_b=rnd(n, C, scale=0.1),
                 w1=rnd(n, C, Ch, scale=C ** -0.5), b1=rnd(n, Ch, scale=0.1),
                 wd=rnd(n, 3, 3, Ch, scale=1 / 3), bd=rnd(n, Ch, scale=0.1),
                 w2=rnd(n, Ch, C, scale=Ch ** -0.5), b2=rnd(n, C, scale=0.1))
        low = ("wq", "wk", "wv", "wo", "mod", "w1", "wd", "w2")
        p = {k: v.bfloat16().float() if k in low else v for k, v in p.items()}
        prm = {dt: {k: v.to(dt) if k in low else v for k, v in p.items()}
               for dt in (torch.float32, torch.bfloat16)}
        kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=use_shift,
                  has_mod=has_mod)
        x32 = rnd(B, res, res, C).bfloat16().float()
        compare(checks, "stage", f"tile B={B} C={C} nH={nH} {res}^2 n={n} "
                f"shift={int(use_shift)}",
                lambda x, dt, prm=prm, kw=kw: K.fused_stage(x, prm[dt], **kw),
                lambda x, dt, prm=prm, kw=kw: K.stage_reference(x, prm[dt],
                                                                **kw), x32)
    f32_stage_checks(checks, device)
    torch.cuda.synchronize()
    return checks


def accumulation_bound(K: int, fma: bool) -> float:
    """The worst relative error (over sum_k |a_k| |b_k|) of the fp32
    block's accumulation at depth K: the FMA loop rounds each of its K
    adds to nearest (2^-24 of the running sum, at most sum |a||b|); the
    three-pass block sums the exact products of one or two k8 steps from
    zero on the tensor cores, rounding toward zero up to six times (2^-23
    of the group's sum each), and adds the sums to nearest."""
    if fma:
        return K * 2.0 ** -24
    return 6 * 2.0 ** -23 + (K // 8) * 2.0 ** -24


def f32_stage_checks(checks: Checks, device) -> None:
    """The fp32 stage on its three-pass TF32 bodies at every (C, head dim)
    they take (C 64-512, head dim 16 and 32), two blocks (shift 0, then
    4), with and without the modulator, on a 16 x 24 image and, where a
    work item may hold two windows, on 2 SMs - 3 windows (two an item, the
    last item half dead): against the plain fp32 version, one launch of
    the new body each (`K.core_counts`)."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.kernels import stage as S
    from uformer_tpu_torch.ops.kernels.wgrad import sm_count

    gen = torch.Generator(device="cpu").manual_seed(13)
    sms = sm_count(device)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    for C in S.F32_WIDTHS:
        for D in S.F32_HEAD_DIMS:
            nH, Ch, n = C // D, 4 * C, 2
            p = dict(ln1_s=1.0 + rnd(n, C, scale=0.1),
                     ln1_b=rnd(n, C, scale=0.1),
                     wq=rnd(n, C, C, scale=C ** -0.5), bq=rnd(n, C, scale=0.1),
                     wk=rnd(n, C, C, scale=C ** -0.5), bk=rnd(n, C, scale=0.1),
                     wv=rnd(n, C, C, scale=C ** -0.5), bv=rnd(n, C, scale=0.1),
                     wo=rnd(n, C, C, scale=C ** -0.5), bo=rnd(n, C, scale=0.1),
                     bias=rnd(n, nH, 64, 64, scale=0.5),
                     mod=rnd(n, 64, C, scale=0.1),
                     ln2_s=1.0 + rnd(n, C, scale=0.1),
                     ln2_b=rnd(n, C, scale=0.1),
                     w1=rnd(n, C, Ch, scale=C ** -0.5), b1=rnd(n, Ch, scale=0.1),
                     wd=rnd(n, 3, 3, Ch, scale=1 / 3), bd=rnd(n, Ch, scale=0.1),
                     w2=rnd(n, Ch, C, scale=Ch ** -0.5), b2=rnd(n, C, scale=0.1))
            shapes = [(2, 16, 24)]
            if C <= 128:  # where an item may hold two windows
                shapes.append((1, 8, 8 * (2 * sms - 3)))
            for B, H, W in shapes:
                for has_mod in (True, False):
                    kw = dict(scale=D ** -0.5, num_heads=nH, use_shift=True,
                              has_mod=has_mod)
                    x = rnd(B, H, W, C)
                    K.reset_counts()
                    got = K.fused_stage(x, p, **kw)
                    bodies = K.core_counts()["stage"]
                    if bodies != {"f32_mma_launches": 1,
                                  "f32_fma_launches": 0}:
                        raise RuntimeError(f"fp32 stage C {C} D {D}: bodies "
                                           f"{bodies}")
                    ref = K.stage_reference(x, p, **kw)
                    checks.add("stage", f"fp32 body C={C} D={D} ({B}, {H}, "
                               f"{W}) mod={has_mod}",
                               max_err(got, ref),
                               1e-4 * (1.0 + float(ref.abs().max())), "fp32")


def f32_tile_timing(checks: Checks, device, card: str) -> list:
    """The fp32 block alone (`csrc/mma_tf32.cuh`, `mma.f32_product`) at
    F32_TILE_SHAPES, 64 rows a block: (a) the three-pass TF32 product the
    fp32 bodies run and (b) the register-tiled FMA yardstick, each timed
    (CUDA events, 10 calls after one) and held against an fp64 product
    within its accumulation's bound; torch.matmul in fp32 (TF32 off; a
    yardstick the port never calls) timed beside them; the bound of the
    three-pass product (3 x its operations at the TF32 rate, or its bytes)
    and of fp32 on the CUDA cores."""
    from uformer_tpu_torch.ops.kernels.mma import f32_product

    gen = torch.Generator(device="cpu").manual_seed(12)
    rows = []
    for M, C in F32_TILE_SHAPES:
        a = torch.randn(M, C, generator=gen).to(device)
        b = (torch.randn(C, C, generator=gen) / C ** 0.5).to(device)
        ref = a.double() @ b.double()
        scale = a.double().abs() @ b.double().abs()
        ops, nbytes = 2 * M * C * C, 4 * (2 * M * C + C * C)
        row = {"shape": [M, C, C],
               "library_ms": cuda_ms(lambda: torch.matmul(a, b), reps=10),
               "library_max_abs_err": max_err(torch.matmul(a, b).double(),
                                              ref),
               "bound_ms": max(3 * ops / PEAK_TF32, nbytes / PEAK_HBM) * 1e3,
               "bound_fp32_ms": max(ops / PEAK_FP32,
                                    nbytes / PEAK_HBM) * 1e3}
        for key, fma in (("tf32x3", False), ("fma", True)):
            got = f32_product(a, b, fma=fma).double()
            rel = float(((got - ref).abs() / scale).max())
            checks.add("f32_block", f"{key} ({M}, {C}) @ ({C}, {C})", rel,
                       accumulation_bound(C, fma), "fp32")
            row.update({f"{key}_ms": cuda_ms(
                lambda fma=fma: f32_product(a, b, fma=fma), reps=10),
                f"{key}_max_abs_err": max_err(got, ref),
                f"{key}_rel_err": rel})
        rows.append(row)
        print(f"  fp32 block ({M}, {C}) @ ({C}, {C}): three-pass TF32 "
              f"{row['tf32x3_ms']:.4f} ms (err {row['tf32x3_max_abs_err']:.2e},"
              f" {row['tf32x3_rel_err']:.2e} of sum |a||b|), FMA "
              f"{row['fma_ms']:.4f} ms (err {row['fma_max_abs_err']:.2e}, "
              f"{row['fma_rel_err']:.2e}), torch.matmul fp32 "
              f"{row['library_ms']:.4f} ms (err "
              f"{row['library_max_abs_err']:.2e}); bound "
              f"{row['bound_ms']:.4f} ms (CUDA cores alone "
              f"{row['bound_fp32_ms']:.4f})  [{card}]", flush=True)
        del a, b, ref, scale
    torch.cuda.empty_cache()
    return rows


def to_nhwc(a: np.ndarray) -> np.ndarray:
    """Torch activation -> NHWC: (B, L, C) tokens via sqrt(L), (B, C, H, W)
    maps by transpose (as tests/test_golden_parity.py)."""
    if a.ndim == 3:
        B, L, C = a.shape
        s = int(round(np.sqrt(L)))
        return a.reshape(B, s, s, C)
    return a.transpose(0, 2, 3, 1)


def golden_phase(data, sd, device) -> Checks:
    """Uformer_B at 128^2, fp32, through the kernels, against the recorded
    torch activations (budget of tests/test_golden_parity.py:114-122)."""
    from uformer_tpu_torch.ops import kernels as K

    model = build_model(sd, RES_GOLDEN, device)
    acts = {}
    hooks = [getattr(model, s).register_forward_hook(
        lambda _m, _i, out, s=s: acts.__setitem__(s, out.float().cpu()))
        for s in STAGES]
    x = torch.from_numpy(data["input"].transpose(0, 2, 3, 1).copy())
    K.reset_counts()
    with torch.no_grad():
        y = model(x.to(device)).cpu()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    launched = K.launch_counts()
    print(f"  launches {launched}", flush=True)
    if launched != EXPECTED_LAUNCHES:
        raise RuntimeError(f"golden: launches {launched}, expected "
                           f"{EXPECTED_LAUNCHES}")
    checks = Checks()
    for s in STAGES:
        want = to_nhwc(data[f"act/{s}"].astype(np.float32))
        err = float(np.abs(acts[s].numpy() - want).max())
        checks.add("model", f"golden {s}", err,
                   1e-3 + 1e-3 * float(np.abs(want).max()), "fp32")
    want = data["output"].transpose(0, 2, 3, 1)
    checks.add("model", "golden output", float(np.abs(y.numpy() - want).max()),
               1e-3, "fp32")
    return checks


def golden_conv_phase(device) -> Checks:
    """The recorded torch golden of the conv-projection Uformer (64^2,
    embed 8, depths 1, Mlp, modulator, cross-modulator, shift) in fp32 on
    the card through the depthwise kernel: the output within 1e-4
    (tests/test_golden_parity.py:25)."""
    from uformer_tpu_torch.convert import load_numpy_state_dict
    from uformer_tpu_torch.models import Uformer
    from uformer_tpu_torch.ops import kernels as K

    kw = golden_module().CONVPROJ
    kw = dict(kw, depths=tuple(kw["depths"]), num_heads=tuple(kw["num_heads"]))
    data = np.load(REPO / "tests" / "golden" / "uformer_convproj_crossmod.npz")
    sd = {k[len("sd/"):]: data[k] for k in data.files if k.startswith("sd/")}
    model = load_numpy_state_dict(Uformer(**kw), sd).to(device).eval()
    x = torch.from_numpy(data["input"].transpose(0, 2, 3, 1).copy())
    K.reset_counts()
    with torch.no_grad():
        y = model(x.to(device)).cpu()
    torch.cuda.synchronize()
    launched = K.launch_counts()
    print(f"  launches {launched}", flush=True)
    if launched != GOLDEN_CONV_LAUNCHES:
        raise RuntimeError(f"golden conv: launches {launched}, expected "
                           f"{GOLDEN_CONV_LAUNCHES}")
    checks = Checks()
    want = data["output"].transpose(0, 2, 3, 1)
    checks.add("model", "golden conv output",
               float(np.abs(y.numpy() - want).max()), 1e-4, "fp32")
    return checks


def serve_phase(make_model, device, expected: dict, label: str,
                batch: int = BATCH_SERVE):
    """A bf16 Restorer of make_model() (a float32 model at 256^2 on the
    card) answers N_REQUESTS requests of `batch`, each launching
    `expected` and never the wide core's CUDA-core body; where the
    model's window is above 8, each kernel-5 launch runs the tensor-core
    body. Returns the summary, the per-kernel launch totals and the
    checks of kernel path against plain path."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.restore import Restorer

    restorer = Restorer(make_model(), torch.bfloat16, device)
    wide_core = any(getattr(m, "win_size", 0) > 8
                    for m in restorer.model.modules())
    gen = torch.Generator(device="cpu").manual_seed(1)
    shape = (batch, RES_SERVE, RES_SERVE, 3)
    requests = [torch.rand(shape, generator=gen)
                for _ in range(N_REQUESTS + 1)]
    restorer(requests[0])  # warm-up: cuDNN plans, kernel attributes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    K.reset_counts()
    per_request, ms, enqueue_ms, device_ms = [], [], [], []
    bodies = []
    for x in requests[1:]:
        before = K.launch_counts()
        body_before = K.core_counts()["attention_block"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        y = restorer(x)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        after = K.launch_counts()
        per_request.append({k: after[k] - before[k] for k in after})
        body_after = K.core_counts()["attention_block"]
        bodies.append({k: body_after[k] - body_before[k]
                       for k in body_after})
        if tuple(y.shape) != shape or not bool(torch.isfinite(y).all()) \
                or float(y.min()) < 0.0 or float(y.max()) > 1.0:
            raise RuntimeError(f"{label}: bad output {tuple(y.shape)}")
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    for i, c in enumerate(per_request):
        print(f"  request {i}: launches {c}  {ms[i]:.3f} ms (host enqueue "
              f"{enqueue_ms[i]:.3f}, device {device_ms[i]:.3f})", flush=True)
        if c != expected:
            raise RuntimeError(f"{label}: request {i} launched {c}, "
                               f"expected {expected}")
        wide = c["attention_block"] if wide_core else 0
        if bodies[i] != {"core_mma_launches": wide,
                         "core_fma_launches": 0}:
            raise RuntimeError(f"{label}: request {i} ran the wide core's "
                               f"bodies {bodies[i]}, expected {wide} "
                               f"tensor-core launches and no CUDA-core one")
    if wide_core:
        print(f"  wide core: {bodies[0]['core_mma_launches']} tensor-core "
              f"launches a request, no CUDA-core one", flush=True)
    med = float(np.median(ms))
    mps = batch * RES_SERVE * RES_SERVE / 1e6 / (med / 1e3)
    print(f"  median {med:.3f} ms/request  {mps:.2f} MP/s  peak "
          f"{peak / 2**20:.1f} MiB", flush=True)

    # kernel path against the plain path on the same weights (unclamped)
    x = requests[1].to(device)
    model16 = restorer.model
    model32 = make_model()
    from uformer_tpu_torch.utils.params import prepare_serving
    prepare_serving(model32, torch.float32)
    checks = Checks()
    with torch.no_grad():
        ref32 = model32(x, plain=True)
        e_plain = max_err(model16(x, plain=True), ref32)
        checks.add("model", f"{label} forward {shape}",
                   max_err(model16(x), ref32), 1.5 * e_plain + 1e-3, "bf16")
    del model32, ref32
    summary = {"ms_per_request": ms, "median_ms": med, "mp_per_s": mps,
               "host_enqueue_ms": enqueue_ms, "device_ms": device_ms,
               "max_memory_allocated_bytes": peak,
               "launches_per_request": per_request,
               "core_bodies_per_request": bodies}
    return restorer, requests[1].to(device), summary, launches, checks


def timing_phase(restorer, x, s: int = 2, peak: float = PEAK_BF16,
                 layers=LAYERS, forward: bool = True, reps: int = 5,
                 warmup: int = 1, tf32x3: bool = False):
    """Device time of each kernel and of its plain version on the inputs
    the forward of x (bs8 256^2 bf16 in the serve phases) gives it, stage
    by stage (the stages in `layers`), with each call's bound (s bytes a
    value, operations at `peak`; with `tf32x3`, fp32, the products three
    times at the TF32 rate and the rest at `peak`, the bound at `peak`
    alone kept beside it), and (with `forward`) of the whole
    forward on each path; each time a mean over `reps` calls after
    `warmup` (the forward's over reps // 2). Returns the rows, the per-kernel totals over
    those stages (ms, plain ms, launches, bound) and the forward's times
    (None without `forward`)."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.norm import layer_norm
    from uformer_tpu_torch.ops.window import cyclic_shift, window_partition

    model = restorer.model
    inputs = {}
    hooks = [getattr(model, n).register_forward_pre_hook(
        lambda _m, args, n=n: inputs.__setitem__(n, args[0]))
        for n in layers]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    rows, totals = [], {}
    with torch.no_grad():
        for name in layers:
            layer, xin = getattr(model, name), inputs[name]
            B, H, W, C = xin.shape
            tokens, nH = B * H * W, layer.num_heads
            if layer.uses_stage(xin):
                pair = [("stage", lambda: layer(xin),
                         lambda: layer(xin, plain=True),
                         stage_cost(tokens, C, nH, 4 * C, len(layer.blocks),
                                    s=s, mod=layer.has_mod))]
            else:
                pair = []
                for blk in layer.blocks:
                    p = blk.params_for(xin.dtype, xin.device)
                    args = (p["mod"], p["ln1_s"], p["ln1_b"], p["wq"],
                            p["bq"], p["wkv"], p["bkv"], p["wo"], p["bo"],
                            p["bias"])
                    largs = (p["w1"], p["b1"], p["wd"], p["bd"], p["w2"],
                             p["b2"])
                    lkw = dict(ln_s=p["ln2_s"], ln_b=p["ln2_b"],
                               residual=True)
                    has_mod = p["mod"] is not None
                    if blk.image_route:
                        kw = dict(win=blk.win_size, shift=blk.shift_size,
                                  scale=blk.attn.scale, num_heads=nH)
                        xa = K.fused_attention_image(xin, *args, **kw)
                        pair.append((
                            "attention_image",
                            lambda xin=xin, args=args, kw=kw:
                            K.fused_attention_image(xin, *args, **kw),
                            lambda xin=xin, args=args, kw=kw:
                            K.attention_image_reference(xin, *args, **kw),
                            attn_cost(tokens, C, nH, s=s, mod=has_mod)))
                    else:
                        # the windowed branch's kernel input: LN1, shift,
                        # partition (the model's own glue)
                        wnd = window_partition(cyclic_shift(
                            layer_norm(xin, p["ln1_s"], p["ln1_b"]),
                            blk.shift_size), blk.win_size)
                        bargs = (p["mod"], None, None) + args[3:]
                        kw = dict(win=blk.win_size, shift=blk.shift_size,
                                  H=H, W=W, scale=blk.attn.scale,
                                  num_heads=nH, has_ln=False)
                        xa = xin + blk.windowed_attention(xin, p)
                        pair.append((
                            "attention_block",
                            lambda wnd=wnd, bargs=bargs, kw=kw:
                            K.fused_attention_block(wnd, *bargs, **kw),
                            lambda wnd=wnd, bargs=bargs, kw=kw:
                            K.attention_block_reference(wnd, *bargs, **kw),
                            attn_cost(tokens, C, nH, s=s, mod=has_mod,
                                      ln=False, N=blk.win_size ** 2)))
                    pair.append(("leff",
                                 lambda xa=xa, largs=largs, lkw=lkw:
                                 K.fused_leff(xa, *largs, **lkw),
                                 lambda xa=xa, largs=largs, lkw=lkw:
                                 K.leff_reference(xa, *largs, **lkw),
                                 leff_cost(tokens, C, 4 * C, s=s)))
                    xin = K.fused_leff(xa, *largs, **lkw)
            for kernel, fused, plain, cost in pair:
                # plain, kernel, kernel, plain: alternate the order
                p1, k1, k2, p2 = (cuda_ms(f, reps, warmup) for f in (
                    plain, fused, fused, plain))
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                prod = None
                if tf32x3:  # all but LeFF's depthwise taps are products
                    taps = tokens * 18 * 4 * C
                    prod = cost[0] - {"stage": len(layer.blocks) * taps,
                                      "leff": taps}.get(kernel, 0)
                b_ms = tally(totals, kernel, k_ms, p_ms, cost, peak=peak,
                             products=prod)
                row = {"layer": name, "kernel": kernel,
                       "shape": list(inputs[name].shape),
                       "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "tflops": cost[0] / (k_ms * 1e-3) / 1e12}
                also = ""
                if tf32x3:
                    row["bound_fp32_ms"] = max(cost[0] / peak,
                                               cost[1] / PEAK_HBM) * 1e3
                    also = f" (CUDA cores alone {row['bound_fp32_ms']:.4f})"
                rows.append(row)
                print(f"  {name:16s} {kernel:16s} "
                      f"{str(tuple(inputs[name].shape)):22s} kernel "
                      f"{k_ms:8.3f} ms  plain {p_ms:8.3f} ms  bound "
                      f"{b_ms:7.4f} ms{also}  {rate(cost, k_ms, b_ms)}",
                      flush=True)
        if not forward:
            return rows, totals, None
        p1, k1, k2, p2 = (cuda_ms(f, max(1, reps // 2), warmup) for f in (
            lambda: model(x, plain=True), lambda: model(x), lambda: model(x),
            lambda: model(x, plain=True)))
    fwd = {"kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "runs_ms": {"plain": [p1, p2], "kernel": [k1, k2]}}
    for kernel, t in totals.items():
        also = (f"; every operation at {peak / 1e12:.0f} TFLOP/s "
                f"{t['bound_fp32_ms']:7.4f} ms" if "bound_fp32_ms" in t
                else "")
        print(f"  {kernel:16s} per forward: {t['launches']} launches, "
              f"kernel {t['ms']:8.3f} ms, plain {t['plain_ms']:8.3f} ms, "
              f"bound {t['bound_ms']:7.4f} ms ({bound_by(t)}){also}",
              flush=True)
    dt = "bf16" if model.dtype == torch.bfloat16 else "fp32"
    print(f"  forward bs{x.shape[0]} {x.shape[1]}^2 {dt}: kernel path "
          f"{fwd['kernel_ms']:.3f} ms, plain path {fwd['plain_ms']:.3f} ms",
          flush=True)
    return rows, totals, fwd


@torch.no_grad()
def bconv_timing(restorer, x):
    """serve B-conv's bs8 256^2 bf16 forward, block by block: for each
    stage and each shift it runs, one block timed on the stage's input and
    counted once per block of that shift. Kernel 8 in both forms on the
    same channels-last bf16 windows with bf16 weights: the fused q/k/v form
    (one launch a block, the model's; totals "dwconv3x3") against its
    plain version and against one grouped cuDNN F.conv2d computing the
    three convs (3C outputs, no ReLU), and the per-call form (three
    launches a block; totals "dwconv3x3 per call") against its plain
    version and cuDNN's depthwise F.conv2d (yardsticks the port never
    calls), each in the order plain, kernel, library, library, kernel,
    plain, and the kernels and cuDNN again from CUDA graphs (device time
    without the host's launch cost); the pointwise products (the three 1x1
    products and the output projection), the plain window attention, LeFF
    kernel and plain, and the whole block, whose remainder is the glue
    (LN1, roll, partition, modulator, reverse, residual). Then the whole
    forward on each path. Returns rows, per-kernel totals and the
    forward's split."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.attention import window_attention
    from uformer_tpu_torch.ops.norm import layer_norm
    from uformer_tpu_torch.ops.window import cyclic_shift, window_partition

    model = restorer.model
    inputs = {}
    hooks = [getattr(model, n).register_forward_pre_hook(
        lambda _m, args, n=n: inputs.__setitem__(n, args[0]))
        for n in LAYERS]
    model(x)
    for h in hooks:
        h.remove()
    rows, totals = [], {}
    split = dict.fromkeys(("dwconv3x3", "pointwise", "attention", "leff",
                           "glue"), 0.0)
    for name in LAYERS:
        layer, xin = getattr(model, name), inputs[name]
        B, H, W, C = xin.shape
        for shift in sorted({b.shift_size for b in layer.blocks}):
            blk = next(b for b in layer.blocks if b.shift_size == shift)
            n = sum(b.shift_size == shift for b in layer.blocks)
            p = blk.params_for(xin.dtype, xin.device)
            wnd = window_partition(cyclic_shift(
                layer_norm(xin, p["ln1_s"], p["ln1_b"]), shift), 8)
            if p["mod"] is not None:
                wnd = wnd + p["mod"]
            Bw = wnd.shape[0]
            xs = wnd.reshape(Bw, 8, 8, C)
            q = p["to_q"]
            wlib = q["wd"].permute(2, 0, 1).unsqueeze(1).contiguous()
            blib = q["bd"].to(xs.dtype)
            # the three weight sets as one grouped conv: output 3 c + i is
            # conv i of channel c
            wlib3 = p["wd3"].permute(3, 0, 1, 2).reshape(3 * C, 1, 3, 3) \
                .contiguous()
            blib3 = p["bd3"].t().reshape(3 * C).to(xs.dtype)
            xs_nchw = xs.permute(0, 3, 1, 2)  # a channels-last view

            def kern(q=q, xs=xs):
                return K.dwconv3x3(xs, q["wd"], q["bd"])

            def plain(q=q, xs=xs):
                return K.dwconv3x3_reference(xs, q["wd"], q["bd"])

            def library(xs_nchw=xs_nchw, wlib=wlib, blib=blib, C=C):
                return F.conv2d(xs_nchw, wlib, blib, padding=1, groups=C)

            def fused(p=p, xs=xs):
                return K.dwconv3x3_qkv(xs, p["wd3"], p["bd3"])

            def fused_plain(p=p, xs=xs):
                return K.dwconv3x3_qkv_reference(xs, p["wd3"], p["bd3"])

            def library3(xs_nchw=xs_nchw, wlib3=wlib3, blib3=blib3, C=C):
                return F.conv2d(xs_nchw, wlib3, blib3, padding=1, groups=C)

            times = {}
            for key, fn in (("plain", fused_plain), ("kernel", fused),
                            ("library", library3), ("library", library3),
                            ("kernel", fused), ("plain", fused_plain),
                            ("plain1", plain), ("kernel1", kern),
                            ("library1", library), ("library1", library),
                            ("kernel1", kern), ("plain1", plain)):
                times[key] = times.get(key, 0.0) + cuda_ms(fn) / 2
            dev = {"kernel": graph_ms(fused), "library": graph_ms(library3),
                   "kernel1": graph_ms(kern), "library1": graph_ms(library)}
            for kernel, sfx, nq, calls in (("dwconv3x3", "", 3, n),
                                           ("dwconv3x3 per call", "1", 1,
                                            3 * n)):
                tally(totals, kernel, times["kernel" + sfx],
                      times["plain" + sfx], dwconv_cost(Bw * 64, C, nq=nq),
                      calls, PEAK_FP32)
                t = totals[kernel]
                for key, v in (("library_ms", times["library" + sfx]),
                               ("device_ms", dev["kernel" + sfx]),
                               ("library_device_ms", dev["library" + sfx])):
                    t[key] = t.get(key, 0.0) + calls * v
            dw = [times["kernel"], times["plain"], times["library"]]
            ys = fused()

            def pointwise(p=p, ys=ys, nm=("to_q", "to_k", "to_v")):
                outs = [y @ p[k]["wp"] + p[k]["bp"].to(y.dtype)
                        for k, y in zip(nm, ys)]
                return outs[0].reshape(Bw, 64, C) @ p["wo"] + p["bo"].to(
                    outs[0].dtype)

            qkv = blk.attn.qkv(wnd, p, blk.num_heads)
            mask = blk.attention_mask(B, H, W, xin.device)

            def attention(qkv=qkv, mask=mask, p=p, blk=blk):
                return window_attention(*qkv, p["bias"], mask,
                                        scale=blk.attn.scale)

            xa = xin + blk.unfused_attention(xin, p)
            largs = (xa, p["w1"], p["b1"], p["wd"], p["bd"], p["w2"],
                     p["b2"])
            lkw = dict(ln_s=p["ln2_s"], ln_b=p["ln2_b"], residual=True)
            lp1, lk1 = (cuda_ms(lambda: K.leff_reference(*largs, **lkw)),
                        cuda_ms(lambda: K.fused_leff(*largs, **lkw)))
            lk2, lp2 = (cuda_ms(lambda: K.fused_leff(*largs, **lkw)),
                        cuda_ms(lambda: K.leff_reference(*largs, **lkw)))
            tally(totals, "leff", (lk1 + lk2) / 2, (lp1 + lp2) / 2,
                  leff_cost(B * H * W, C, 4 * C), n)
            pw_ms, at_ms = cuda_ms(pointwise), cuda_ms(attention)
            blk_ms = cuda_ms(lambda: blk(xin))
            leff_ms = (lk1 + lk2) / 2
            parts = {"dwconv3x3": dw[0], "pointwise": pw_ms,
                     "attention": at_ms, "leff": leff_ms,
                     "glue": blk_ms - dw[0] - pw_ms - at_ms - leff_ms}
            for k, v in parts.items():
                split[k] += n * v
            rows.append({"layer": name, "shift": shift, "blocks": n,
                         "windows": [Bw, 8, 8, C], "dwconv_qkv_ms": dw[0],
                         "dwconv_qkv_plain_ms": dw[1],
                         "dwconv_qkv_library_ms": dw[2],
                         "dwconv_qkv_device_ms": dev["kernel"],
                         "dwconv_qkv_library_device_ms": dev["library"],
                         "dwconv_qkv_bound_ms": max(
                             dwconv_cost(Bw * 64, C, nq=3)[0] / PEAK_FP32,
                             dwconv_cost(Bw * 64, C, nq=3)[1] / PEAK_HBM)
                         * 1e3,
                         "dwconv_ms": times["kernel1"],
                         "dwconv_plain_ms": times["plain1"],
                         "dwconv_library_ms": times["library1"],
                         "dwconv_device_ms": dev["kernel1"],
                         "dwconv_library_device_ms": dev["library1"],
                         "dwconv_bound_ms": max(
                             dwconv_cost(Bw * 64, C)[0] / PEAK_FP32,
                             dwconv_cost(Bw * 64, C)[1] / PEAK_HBM) * 1e3,
                         "leff_ms": leff_ms, "leff_plain_ms": (lp1 + lp2) / 2,
                         "pointwise_ms": pw_ms, "attention_ms": at_ms,
                         "block_ms": blk_ms})
            r = rows[-1]
            print(f"  {name:16s} s{shift} x{n} ({Bw}, 8, 8, {C}) dwconv "
                  f"q/k/v {dw[0]:.4f} ms (plain {dw[1]:.4f}, cuDNN "
                  f"{dw[2]:.4f}; graphed {dev['kernel']:.4f}, cuDNN "
                  f"{dev['library']:.4f}; bound "
                  f"{r['dwconv_qkv_bound_ms']:.4f}); per call "
                  f"{times['kernel1']:.4f} (cuDNN {times['library1']:.4f}; "
                  f"graphed {dev['kernel1']:.4f}, cuDNN "
                  f"{dev['library1']:.4f}; bound "
                  f"{r['dwconv_bound_ms']:.4f}); pointwise "
                  f"{pw_ms:.3f}, attention {at_ms:.3f}, leff {leff_ms:.3f}, "
                  f"block {blk_ms:.3f} ms", flush=True)
    p1 = cuda_ms(lambda: model(x, plain=True), reps=5)
    k1 = cuda_ms(lambda: model(x), reps=5)
    k2 = cuda_ms(lambda: model(x), reps=5)
    p2 = cuda_ms(lambda: model(x, plain=True), reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model(x)
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    fwd = {"kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "runs_ms": {"plain": [p1, p2], "kernel": [k1, k2]},
           "host_enqueue_ms": enqueue, "split_ms": split}
    split["outside blocks"] = fwd["kernel_ms"] - sum(split.values())
    for kernel, t in totals.items():
        print(f"  {kernel:16s} per forward: {t['launches']} launches, "
              f"kernel {t['ms']:8.3f} ms, plain {t['plain_ms']:8.3f} ms, "
              f"bound {t['bound_ms']:7.4f} ms ({bound_by(t)})"
              + (f", cuDNN {t['library_ms']:.3f} ms; graphed: kernel "
                 f"{t['device_ms']:.3f} ms, cuDNN "
                 f"{t['library_device_ms']:.3f} ms" if "library_ms" in t
                 else ""), flush=True)
    print(f"  forward bs{x.shape[0]} {x.shape[1]}^2 bf16: kernel path "
          f"{fwd['kernel_ms']:.3f} ms, plain path {fwd['plain_ms']:.3f} ms, "
          f"host enqueue {enqueue:.3f} ms; split "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    return rows, totals, fwd


# kernel 4 timed alone (nH, Bw, D, image side): Uformer_T's enc0 at bs8
# 256^2 (with its bias), head dim 32 there, four heads of 512 windows
CORE_TIMING_SHAPES = [(1, 8192, 16, 256), (1, 8192, 32, 256),
                      (4, 512, 16, 64)]


def time_core(q, k, v, bias, *, win: int, shift: int, res: int) -> dict:
    """Kernel 4 on (nH, Bw, N, D) q, k, v of windows of N = win² tokens
    (res x res images): the kernel, its plain version and
    F.scaled_dot_product_attention with the bias and shift mask as one
    additive bf16 mask (a yardstick; the port never calls it), in the
    order plain, kernel, library, library, kernel, plain; its bound."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.kernels.window_attention import window_mask

    nH, Bw, N, D = q.shape
    kw = dict(win=win, shift=shift, H=res, W=res, scale=D ** -0.5)
    full = bias[:, None, None].expand(nH, 1, 1, N, N)
    if shift:
        mask = window_mask(res, res, win, shift, Bw, 0, q.device)
        full = full + mask[None, None]
    nW = full.shape[2]
    full = full.expand(nH, Bw // nW, nW, N, N).reshape(nH, Bw, N, N) \
        .to(torch.bfloat16).contiguous()

    def fused():
        return K.fused_window_attention(q, k, v, bias, **kw)

    def plain():
        return K.window_attention_reference(q, k, v, bias, **kw)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=full,
                                              scale=D ** -0.5)

    p1, k1, l1 = cuda_ms(plain), cuda_ms(fused), cuda_ms(library)
    l2, k2, p2 = cuda_ms(library), cuda_ms(fused), cuda_ms(plain)
    t = {}
    tally(t, "window_attention", (k1 + k2) / 2, (p1 + p2) / 2,
          core_cost(nH, Bw, D, N=N))
    out = dict(t["window_attention"], library_ms=(l1 + l2) / 2,
               graph_ms=graph_ms(fused), shape=[nH, Bw, N, D], shift=shift,
               library_max_abs_err_vs_plain=max_err(library(), plain()))
    print(f"  window_attention {tuple(out['shape'])} shift {shift}: "
          f"kernel {out['ms']:.4f} ms ({out['graph_ms']:.4f} graphed), "
          f"plain {out['plain_ms']:.4f} ms, SDPA "
          f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({bound_by(out)})", flush=True)
    return out


@torch.no_grad()
def core_timing(model_t, device) -> dict:
    """The window-attention core alone, bf16, shift 4, at each
    CORE_TIMING_SHAPES shape (the first with the bias of Uformer_T's enc0,
    the others random), by `time_core`. Returns the first shape's timing,
    the others under "more"."""
    gen = torch.Generator(device="cpu").manual_seed(8)
    outs = []
    for nH, Bw, D, res in CORE_TIMING_SHAPES:
        q, k, v = (torch.randn((nH, Bw, 64, D), generator=gen)
                   .to(device, torch.bfloat16) for _ in range(3))
        bias = (model_t.encoderlayer_0.blocks[1].kernel_params(
            torch.float32)["bias"] if not outs else
            (0.5 * torch.randn((nH, 64, 64), generator=gen)).to(device))
        outs.append(time_core(q, k, v, bias, win=8, shift=4, res=res))
        del q, k, v
    return dict(outs[0], more=outs[1:])


# a gradient with at most this many entries a draw (the bias and LayerNorm
# gradients at C 8-32) is held in bf16 by its rms error: its max error
# over 8-64 entries flips about its bound with the draw (PERF.md §6)
FEW_ENTRIES = 64


def pooled_grad_bound(checks: Checks, kernel: str, what: str,
                      runs: list) -> None:
    """`grad_bound` over several independent draws of one call, runs =
    [(got, ref, low, got16)] as grad_bound takes them: fp32 per draw, bf16
    on each gradient of every draw taken as one tensor (its max errors and
    max|ref| over all of them); a gradient of at most FEW_ENTRIES entries
    a draw by its rms errors there instead ("bf16 rms": the kernel's
    within 1.5x the plain bf16 VJP's + 1e-3 max(1, max|ref|))."""
    for i, (got, ref, _, _) in enumerate(runs):
        for name, r in ref.items():
            if r is not None:
                checks.add(kernel, f"{what} draw {i} {name}",
                           max_err(got[name], r),
                           1e-4 * (1.0 + float(r.abs().max())), "fp32")

    def pool(j):
        return {n: None if runs[0][j][n] is None else torch.cat(
            [run[j][n].float().reshape(-1) for run in runs])
            for n in runs[0][j]}

    got, ref, low, got16 = (pool(j) for j in range(4))
    for name, r in ref.items():
        if r is None:
            if got[name] is not None or got16[name] is not None:
                raise RuntimeError(f"{kernel} {what} {name}: unexpected "
                                   f"gradient")
            continue
        floor = 1e-3 * max(1.0, float(r.abs().max()))
        if runs[0][1][name].numel() <= FEW_ENTRIES:
            checks.add(kernel, f"{what} x{len(runs)} {name}",
                       rms_err(got16[name], r),
                       1.5 * rms_err(low[name], r) + floor, "bf16 rms")
        else:
            checks.add(kernel, f"{what} x{len(runs)} {name}",
                       max_err(got16[name], r),
                       1.5 * max_err(low[name], r) + floor, "bf16")


def grad_bound(checks: Checks, kernel: str, what: str, got, ref, low,
               got16) -> None:
    """Per-gradient checks: fp32 kernel against fp32 plain within
    1e-4 (1 + max|ref|); bf16 kernel against fp32 plain within 1.5x the
    bf16 plain version's error + 1e-3 max(1, max|ref|)."""
    for name, r, k, p, k16 in zip(got.keys(), ref.values(), got.values(),
                                  low.values(), got16.values()):
        if r is None:
            if k is not None or k16 is not None:
                raise RuntimeError(f"{kernel} {what} {name}: unexpected "
                                   f"gradient")
            continue
        scale = float(r.abs().max())
        checks.add(kernel, f"{what} {name}", max_err(k, r),
                   1e-4 * (1.0 + scale), "fp32")
        checks.add(kernel, f"{what} {name}", max_err(k16, r),
                   1.5 * max_err(p, r) + 1e-3 * max(1.0, scale), "bf16")


ATTN_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")
LEFF_GRADS = ("dx", "dw1", "db1", "dwd", "dbd", "dw2", "db2", "dln_s",
              "dln_b")


def block_calls(layer, blk, residual, dtypes):
    """The four kernel calls of blk (a block of `layer`) and their plain
    versions, on its kernel weights in each of `dtypes`, each taking an
    image x (and g) of the block's input shape: attention_image and
    attention_bwd on the image route; off it the windowed branch's
    attention_block and attention_block_bwd on x's (Bw, N, C) windows (N =
    win²), LN outside (has_ln False) and the block's modulator, as the
    model runs them. Then leff and leff_bwd. Returns ({kernel: (fused, plain)},
    {backward kernel: parts(x, g, dt)}), parts giving the backward's
    launches unrun (`leff_bwd_parts` and its attention counterparts)."""
    from uformer_tpu_torch.ops import kernels as K

    prm = {dt: blk.kernel_params(dt) for dt in dtypes}
    akw = dict(win=blk.win_size, shift=blk.shift_size, scale=blk.attn.scale,
               num_heads=blk.num_heads)
    keys = ("mod", "ln1_s", "ln1_b", "wq", "bq", "wkv", "bkv", "wo", "bo",
            "bias")
    if blk.image_route:
        akw["residual"] = residual

        def args(dt):
            return tuple(prm[dt][k] for k in keys)

        def tok(t):
            return t
    else:
        akw.update(H=layer.resolution, W=layer.resolution, has_ln=False)

        def args(dt):
            return (prm[dt]["mod"], None, None) + tuple(
                prm[dt][k] for k in keys[3:])

        def tok(t):
            return t.reshape(-1, blk.win_size ** 2, t.shape[-1])

    def attn(fn):
        return lambda x, dt: fn(tok(x), *args(dt), **akw)

    def attn_bwd(fn):
        return lambda x, g, dt: dict(zip(ATTN_GRADS, fn(
            tok(x), tok(g), *args(dt), **akw)))

    def leff(fn):
        return lambda x, dt: fn(x, *(prm[dt][k] for k in (
            "w1", "b1", "wd", "bd", "w2", "b2")), ln_s=prm[dt]["ln2_s"],
            ln_b=prm[dt]["ln2_b"], residual=residual)

    def leff_bwd(fn):
        return lambda x, g, dt: dict(zip(LEFF_GRADS, fn(x, g, *(
            prm[dt][k] for k in ("w1", "b1", "wd", "bd", "w2", "ln2_s",
                                 "ln2_b")), residual=residual)))

    def parts_of(fn):
        return lambda x, g, dt: fn(tok(x), tok(g), *args(dt), **akw)

    from uformer_tpu_torch.ops.kernels.attention_block import \
        attention_block_bwd_parts
    from uformer_tpu_torch.ops.kernels.attention_image import \
        attention_image_bwd_parts
    from uformer_tpu_torch.ops.kernels.leff import leff_bwd_parts

    parts = {"leff_bwd": lambda x, g, dt: leff_bwd_parts(x, g, *(
        prm[dt][k] for k in ("w1", "b1", "wd", "bd", "w2", "ln2_s",
                             "ln2_b")), residual=residual)}
    if blk.image_route:
        parts["attention_bwd"] = parts_of(attention_image_bwd_parts)
    else:
        parts["attention_block_bwd"] = parts_of(attention_block_bwd_parts)

    if blk.image_route:
        calls = {"attention_image": (attn(K.fused_attention_image),
                                     attn(K.attention_image_reference)),
                 "attention_bwd": (attn_bwd(K.fused_attention_image_bwd),
                                   attn_bwd(
                                       K.attention_image_vjp_reference))}
    else:
        calls = {"attention_block": (attn(K.fused_attention_block),
                                     attn(K.attention_block_reference)),
                 "attention_block_bwd": (
                     attn_bwd(K.fused_attention_block_bwd),
                     attn_bwd(K.attention_block_vjp_reference))}
    calls.update({"leff": (leff(K.fused_leff), leff(K.leff_reference)),
                  "leff_bwd": (leff_bwd(K.fused_leff_bwd),
                               leff_bwd(K.leff_vjp_reference))})
    return calls, parts


def train_configs(model):
    """(layer name, block, shift, residual) for every training-path
    geometry of `model`: each stage at shift 0 and, where it shifts, 4;
    residual as the block runs it in training (outside under DropPath)."""
    out = []
    for name in LAYERS:
        layer = getattr(model, name)
        shifts = (0, layer.win_size // 2) if layer.use_shift else (0,)
        for shift in shifts:
            blk = next((b for b in layer.blocks if b.shift_size == shift),
                       layer.blocks[0])
            out.append((name, blk, shift, blk.drop_path1.rate == 0.0))
    return out


def with_shift(blk, shift):
    """blk, or a view of it run at another shift (the same weights)."""
    if blk.shift_size == shift:
        return blk
    view = copy.copy(blk)
    view.shift_size = shift
    return view


def train_kernel_checks(model, device, batch: int) -> Checks:
    """Forward kernels with residual=False on every block, and backward
    kernels against their plain VJPs at every training-path geometry of
    `model` (each stage at its resolution for the model's train_ps), at
    this batch, fp32 and bf16."""
    checks = Checks()
    dtypes = (torch.float32, torch.bfloat16)
    gen = torch.Generator(device="cpu").manual_seed(2)
    with torch.no_grad():
        for name in LAYERS:
            layer = getattr(model, name)
            shape = (batch, layer.resolution, layer.resolution, layer.dim)
            for i, blk in enumerate(layer.blocks):
                calls, _ = block_calls(layer, blk, False, dtypes)
                x32 = torch.randn(shape, generator=gen).bfloat16().float() \
                    .to(device)
                what = f"{name}.{i} {shape} shift={blk.shift_size} res=0"
                for kernel, pair in calls.items():
                    if not kernel.endswith("bwd"):
                        compare(checks, kernel, what, *pair, x32)
        for name, blk, shift, residual in train_configs(model):
            layer = getattr(model, name)
            shape = (batch, layer.resolution, layer.resolution, layer.dim)
            calls, _ = block_calls(layer, with_shift(blk, shift), residual,
                                   dtypes)
            x = torch.randn(shape, generator=gen).bfloat16().float() \
                .to(device)
            g = torch.randn(shape, generator=gen).bfloat16().float() \
                .to(device)
            what = f"{name} {shape} shift={shift} res={int(residual)}"
            for kernel, (fused, plain) in calls.items():
                if kernel.endswith("bwd"):
                    before = wide_bodies_now()
                    got16 = fused(x.bfloat16(), g.bfloat16(), torch.bfloat16)
                    grad_bound(checks, kernel, what,
                               fused(x, g, torch.float32),
                               plain(x, g, torch.float32),
                               plain(x.bfloat16(), g.bfloat16(),
                                     torch.bfloat16), got16)
                    # a second run on the same inputs: equal bits (fixed
                    # summation orders, no atomics)
                    again = fused(x.bfloat16(), g.bfloat16(), torch.bfloat16)
                    differ = sum(a is not None and not torch.equal(a, again[n])
                                 for n, a in got16.items())
                    checks.add(kernel, f"{what} repeat", float(differ), 0.0,
                               "bits")
                    wide = int(kernel == "attention_block_bwd"
                               and blk.win_size ** 2 > 64)
                    wide_bwd_bodies(f"{what} {kernel}", 2 * wide, wide,
                                    before)
    torch.cuda.synchronize()
    return checks


def train_batch(batch: int, seed: int, device, res: int = RES_TRAIN):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (batch, res, res, 3)
    target = torch.rand(shape, generator=gen)
    noisy = (target + 0.1 * torch.randn(shape, generator=gen)).clamp(0, 1)
    return {"input": noisy.to(device), "target": target.to(device)}


def run_step(model, plain: bool, dtype, batch, seed: int, lr_schedule):
    """One train step through the port's entry points, mixup active
    (epoch 6 > 5); returns the loss and the step's state."""
    from uformer_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    model.dtype = dtype
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lr_schedule), step=5)
    step = make_train_step(model, mixup_after_epoch=5, steps_per_epoch=1,
                           plain=plain)
    loss = step(state, batch, torch.Generator(device="cpu").manual_seed(seed))
    return loss, state, step


def whole_step_checks(make_model, device, batch_size: int, label: str,
                      expected: dict, res: int = RES_TRAIN,
                      fp32_cotangent: bool = False,
                      batch_seed: int = 3) -> tuple:
    """One train step of batch_size at res^2 (its batch from batch_seed),
    kernel path against plain path: same weights, batch and generator;
    loss and every parameter's gradient (norm_cross, built and never
    applied, has none), in fp32 and bf16. lr 0 keeps the weights for the
    next step. Each kernel path step
    must launch exactly `expected` and call no plain version. With
    fp32_cotangent both bf16 steps backpropagate the fp32 plain step's
    gradient of the loss at the model's output in place of their own (see
    `HELD_OWN_LOSS`). Returns the checks and {"launches": counted in the
    bf16 kernel path step, "cotangent": each bf16 step's own gradient at
    the output against the fp32 plain step's (its rms error over the
    latter's rms, the share of entries whose sign differs) and the share
    of the plain path's sign changes that the kernel path shares}."""
    from uformer_tpu_torch.ops import kernels as K

    model = make_model()
    batch = train_batch(batch_size, batch_seed, device, res)
    wide = wide_bwd_calls(model) if expected.get("attention_block_bwd") \
        else 0
    # the gradient at the output of each step, by (plain, bf16)
    counted, cot, step, bodies = {}, {}, [], {}

    def at_output(module, inputs, out):
        def swap(g):
            cot[step[-1]] = g.detach().clone()
            return cot[True, False] if fp32_cotangent and step[-1][1] \
                else None
        out.register_hook(swap)

    def grads(plain, dtype):
        K.reset_counts()
        step.append((plain, dtype == torch.bfloat16))
        hook = model.register_forward_hook(at_output)
        try:
            loss, _, _ = run_step(model, plain, dtype, batch, 4,
                                  lambda s: 0.0)
        finally:
            hook.remove()
        torch.cuda.synchronize()
        launched = K.launch_counts()
        if not plain and (launched != expected
                          or any(K.plain_counts().values())):
            raise RuntimeError(f"{label}: launched {launched}, plain calls "
                               f"{K.plain_counts()}, expected {expected} "
                               f"and none")
        if not plain:
            counted.update(launched)
            bf16 = dtype == torch.bfloat16
            bodies[str(dtype)] = wide_bwd_bodies(
                f"{label} {dtype}", wide if bf16 else 0, 0 if bf16 else wide)
        out = {"loss": loss.reshape(1)}
        out.update({n: p.grad.clone() for n, p in model.named_parameters()
                    if p.grad is not None})
        return out

    ref = grads(True, torch.float32)
    got = grads(False, torch.float32)
    low = grads(True, torch.bfloat16)
    got16 = grads(False, torch.bfloat16)
    torch.cuda.synchronize()
    checks = Checks()
    grad_bound(checks, "model", f"{label} bs{batch_size}", got, ref, low,
               got16)
    for n, v in got16.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"{label}: non-finite {n}")
    ref_g = cot[True, False]
    flips = {plain: torch.sign(cot[plain, True]) != torch.sign(ref_g)
             for plain in (True, False)}
    cotangent = {
        path: {"rms_rel": rms_err(cot[plain, True], ref_g)
               / float(ref_g.pow(2).mean().sqrt()),
               "sign_changed": float(flips[plain].float().mean())}
        for path, plain in (("plain", True), ("kernel", False))}
    cotangent["shared_sign_changes"] = float(
        (flips[True] & flips[False]).sum()
        / flips[True].sum().clamp(min=1))
    return checks, {"launches": counted, "cotangent": cotangent,
                    "wide_bwd_bodies": bodies}


def train_timing(make_model, device, expected: dict, label: str):
    """BATCH_TRAIN x RES_TRAIN^2 bf16 train steps: launches per step
    (`expected` on every kernel path step) and loss on the kernel path;
    ms per step (CUDA events) and peak memory on both paths, in the order
    plain, kernel, kernel..., plain."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.train import warmup_cosine_schedule

    model = make_model()
    batch = train_batch(BATCH_TRAIN, 5, device)
    sched = warmup_cosine_schedule(2e-4, 250, 100)
    out = {"kernel_ms": [], "plain_ms": [], "loss": [], "launches": []}

    def steps(plain, n, seed):
        model.dtype = torch.bfloat16
        _, state, step = run_step(model, plain, torch.bfloat16, batch, seed,
                                  sched)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for i in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            K.reset_counts()
            start.record()
            loss = step(state, batch, torch.Generator(device="cpu")
                        .manual_seed(seed + 1 + i))
            end.record()
            torch.cuda.synchronize()
            counts = K.launch_counts()
            key = "plain" if plain else "kernel"
            out[f"{key}_ms"].append(start.elapsed_time(end))
            if not plain:
                out["loss"].append(float(loss))
                out["launches"].append(counts)
                print(f"  step {i}: loss {float(loss):.6f}  "
                      f"{out['kernel_ms'][-1]:.3f} ms  launches {counts}",
                      flush=True)
                if counts != expected:
                    raise RuntimeError(f"{label}: step {i} launched "
                                       f"{counts}, expected {expected}")
                if not np.isfinite(float(loss)):
                    raise RuntimeError(f"{label}: step {i} loss "
                                       f"{float(loss)}")
        return torch.cuda.max_memory_allocated(device)

    steps(True, 1, 100)
    out["peak_bytes"] = steps(False, N_TRAIN_STEPS, 200)
    plain_peak = steps(True, 1, 300)
    out["plain_peak_bytes"] = plain_peak
    out["kernel_ms_median"] = float(np.median(out["kernel_ms"]))
    out["plain_ms_median"] = float(np.median(out["plain_ms"]))
    print(f"  {label} bs{BATCH_TRAIN} {RES_TRAIN}^2 bf16 step: kernel path "
          f"{out['kernel_ms_median']:.3f} ms (peak "
          f"{out['peak_bytes'] / 2**20:.1f} MiB), plain path "
          f"{out['plain_ms_median']:.3f} ms (peak "
          f"{plain_peak / 2**20:.1f} MiB)", flush=True)
    return model, out


def wgrad_cost(a, b):
    """(operations, bytes) of a^T b over the rows of a and b and the
    column sums of b: a and b read once, the fp32 product written once."""
    M, K1 = a.shape
    N = b.shape[1]
    return 2 * M * K1 * N, (M * (K1 + N)) * a.element_size() + 4 * K1 * N


def part_times(parts_fn, x, g, n: int, totals: dict, kernel: str) -> dict:
    """Each launch of one backward call (its parts, `*_bwd_parts`) timed
    alone on the same buffers after one run of all of them, and each
    weight-gradient part's yardstick, torch.matmul(a.T, b) on its operands
    (the port never calls it). Adds n calls to totals[kernel]["parts"]."""
    parts, _ = parts_fn(x, g, torch.bfloat16)
    for _, run in parts:
        run()
    out = {}
    for name, run in parts:
        out[name] = cuda_ms(run, reps=5)
        ops = getattr(run, "operands", ())
        if name.startswith("wgrad"):
            a, b = ops
            out[f"{name} matmul"] = cuda_ms(lambda: torch.matmul(a.T, b),
                                            reps=5)
            cost = wgrad_cost(a, b)
            out[f"{name} bound"] = max(cost[0] / PEAK_BF16,
                                       cost[1] / PEAK_HBM) * 1e3
    acc = totals[kernel].setdefault("parts", {})
    for name, ms in out.items():
        acc[name] = acc.get(name, 0.0) + n * ms
    del parts
    return out


def train_kernel_timing(model, device):
    """Device time of each kernel against its plain version at the bs
    BATCH_TRAIN bf16 shapes of one train step, and of each backward's
    parts (kernel 7's A and B, kernel 6's body, the weight-gradient
    reductions beside torch.matmul, colsum). One block per (stage, shift)
    is timed on random inputs and counted once per block of the stage
    with that shift; totals (ms, plain ms, launches, bound, parts) are per
    step."""
    gen = torch.Generator(device="cpu").manual_seed(6)
    rows, totals = [], {}
    with torch.no_grad():
        for name, blk, shift, residual in train_configs(model):
            layer = getattr(model, name)
            n = sum(b.shift_size == shift for b in layer.blocks)
            if n == 0:  # a geometry checked above but not on the step
                continue
            shape = (BATCH_TRAIN, layer.resolution, layer.resolution,
                     layer.dim)
            tokens, C = BATCH_TRAIN * layer.resolution ** 2, layer.dim
            attn = attn_cost(tokens, C, blk.num_heads,
                             mod=blk.modulator is not None,
                             ln=blk.image_route)
            leff = leff_cost(tokens, C, 4 * C)
            costs = {"attention_image": attn, "attention_block": attn,
                     "leff": leff,
                     "attention_bwd": bwd_cost(attn, tokens, C),
                     "attention_block_bwd": bwd_cost(attn, tokens, C),
                     "leff_bwd": bwd_cost(leff, tokens, C)}
            calls, parts = block_calls(layer, blk, residual,
                                       (torch.bfloat16,))
            x = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
            g = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
            for kernel, (fused, plain) in calls.items():
                args = (x, g) if kernel.endswith("bwd") else (x,)
                k_fn = (lambda f=fused, a=args: f(*a, torch.bfloat16))
                p_fn = (lambda f=plain, a=args: f(*a, torch.bfloat16))
                p1, k1, k2, p2 = (cuda_ms(p_fn, reps=5), cuda_ms(k_fn, reps=5),
                                  cuda_ms(k_fn, reps=5), cuda_ms(p_fn, reps=5))
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                b_ms = tally(totals, kernel, k_ms, p_ms, costs[kernel], n)
                row = {"layer": name, "shift": shift, "blocks": n,
                       "kernel": kernel, "shape": list(shape), "ms": k_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms / n,
                       "tflops": costs[kernel][0] / (k_ms * 1e-3) / 1e12}
                print(f"  {name:16s} s{shift} x{n} {kernel:19s} "
                      f"{str(shape):22s} kernel {k_ms:8.3f} ms  plain "
                      f"{p_ms:8.3f} ms  bound {b_ms / n:7.4f} ms  "
                      f"{rate(costs[kernel], k_ms, b_ms / n)}", flush=True)
                if kernel in parts:
                    row["parts"] = part_times(parts[kernel], x, g, n, totals,
                                              kernel)
                    print("      parts: " + ", ".join(
                        f"{k} {v:.3f}" for k, v in row["parts"].items()),
                        flush=True)
                rows.append(row)
    for kernel, t in totals.items():
        print(f"  {kernel:19s} per step: {t['launches']} launches, kernel "
              f"{t['ms']:8.3f} ms, plain {t['plain_ms']:8.3f} ms, bound "
              f"{t['bound_ms']:7.4f} ms ({bound_by(t)})", flush=True)
        if "parts" in t:
            print("      parts per step: " + ", ".join(
                f"{k} {v:.3f}" for k, v in t["parts"].items()), flush=True)
    return rows, totals


def train_checks(make_model, device, batch: int, label: str,
                 expected: dict):
    """Kernel checks and one whole step against the plain path at this
    batch, with cuDNN's deterministic algorithms, so that the plain
    references repeat bit for bit."""
    torch.backends.cudnn.deterministic = True
    model = make_model()
    kchecks = train_kernel_checks(model, device, batch)
    kchecks.raise_if_failed(f"{label} kernels bs{batch}")
    del model
    schecks, _ = whole_step_checks(make_model, device, batch, label,
                                   expected)
    schecks.raise_if_failed(f"{label} step bs{batch}")
    torch.backends.cudnn.deterministic = False
    return kchecks, schecks


def train_phase(make_model, device, expected: dict, label: str):
    """The train path of make_model() (a float32 model at RES_TRAIN^2 on
    the card): the checks at bs BATCH_CHECK; timed bs BATCH_TRAIN steps
    launching `expected` and per-kernel times (cuDNN's defaults); then the
    checks again at bs BATCH_TRAIN, the shapes the timed steps run. Those
    come last: their fp32 plain references take tens of GB, which the
    timings then need not share the allocator with."""
    kchecks, schecks = train_checks(make_model, device, BATCH_CHECK, label,
                                    expected)
    model, timing = train_timing(make_model, device, expected, label)
    rows, totals = train_kernel_timing(model, device)
    del model
    torch.cuda.empty_cache()
    kbig, sbig = train_checks(make_model, device, BATCH_TRAIN, label,
                              expected)
    kchecks.rows += kbig.rows
    schecks.rows += sbig.rows
    torch.cuda.empty_cache()
    return kchecks, schecks, timing, rows, totals


def mlp_cross_model(device):
    """The MLP_CROSS model on weights drawn with numpy from SEED_MLP_CROSS
    over the port's own parameter names, by the golden weights' rule."""
    from uformer_tpu_torch.convert import load_numpy_state_dict
    from uformer_tpu_torch.models import Uformer

    model = Uformer(**MLP_CROSS)
    keys_shapes = [[k, list(v.shape)] for k, v in model.named_parameters()]
    sd = golden_module().seeded_state_dict(keys_shapes, SEED_MLP_CROSS)
    return load_numpy_state_dict(model, sd).to(device)


def write_eval_inputs(root: Path, sd, name: str = "uformer_b_seeded",
                      sidd_set: tuple = SIDD_SET) -> tuple:
    """The weights sd (serve B's golden seeded Uformer_B weights by
    default) as a reference-format .pth ({'epoch', 'state_dict' with the
    DataParallel `module.` prefix, 'optimizer'}), and a synthetic SIDD
    validation pair of sidd_set (images, blocks, side) in sidd.py's
    layout: uint8 clean blocks (uniform, seed 7) and noisy = clean +
    N(0, 0.08^2), clipped."""
    import scipy.io as sio

    root.mkdir(parents=True, exist_ok=True)
    pth = root / f"{name}.pth"
    torch.save({"epoch": 1, "optimizer": {},
                "state_dict": {"module." + k: torch.from_numpy(v)
                               for k, v in sd.items()}}, pth)
    rng = np.random.default_rng(7)
    n, b, side = sidd_set
    clean = rng.uniform(0, 1, (n, b, side, side, 3))
    noisy = np.clip(clean + rng.normal(0, 0.08, clean.shape), 0, 1)
    sidd = root / "sidd"
    sidd.mkdir()
    sio.savemat(sidd / "ValidationGtBlocksSrgb.mat",
                {"ValidationGtBlocksSrgb": np.uint8(np.round(clean * 255))})
    sio.savemat(sidd / "ValidationNoisyBlocksSrgb.mat",
                {"ValidationNoisyBlocksSrgb":
                 np.uint8(np.round(noisy * 255))})
    return pth, sidd


def eval_restorers(pth, device, train_ps: int = EVAL_TRAIN_PS) -> dict:
    """Uformer_B loaded from the .pth as the eval CLI builds it, one
    Restorer per dtype: {dtype: Restorer}."""
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.convert import load_checkpoint
    from uformer_tpu_torch.restore import Restorer

    return {dt: Restorer(load_checkpoint(get_arch({
        "arch": "Uformer_B", "train_ps": train_ps}), str(pth)), dt, device)
        for dt in (torch.float32, torch.bfloat16)}


def model_numpy(restorer, plain: bool, raws: list):
    """restorer's model on host arrays, the input copied to the card as
    Restorer.numpy copies it: the kernel path, or with plain=True every
    kernel's plain version. Each output before the clamp is appended to
    raws; the clamped output is returned."""
    from uformer_tpu_torch.device import to_device_async

    @torch.no_grad()
    def fn(x):
        y = restorer.model(to_device_async(torch.from_numpy(
            np.ascontiguousarray(x, np.float32)), restorer.device),
            plain=plain).float().cpu().numpy()
        raws.append(y)
        return np.clip(y, 0, 1)

    return fn


def outside_share(raws: list) -> float:
    """The share of the values in raws that the clamp to [0, 1] moves."""
    y = np.concatenate([r.reshape(-1) for r in raws])
    return float(np.mean((y < 0) | (y > 1)))


def eval_compare(checks: Checks, what: str, got: dict, ref32, ref16):
    """got: {dtype: the kernel path's host output}. fp32 within 1e-4 (1 +
    max|ref|) of the fp32 plain output; bf16's error against that within
    1.5x the bf16 plain output's + 1e-3 (the serve phases' rule). Used on
    the clamped outputs and on the outputs before the clamp."""
    if torch.float32 in got:
        checks.add("model", what,
                   float(np.abs(got[torch.float32] - ref32).max()),
                   1e-4 * (1.0 + float(np.abs(ref32).max())), "fp32")
    if torch.bfloat16 in got:
        e_plain = float(np.abs(ref16 - ref32).max())
        checks.add("model", what,
                   float(np.abs(got[torch.bfloat16] - ref32).max()),
                   1.5 * e_plain + 1e-3, "bf16")


def host_run(fn, device) -> tuple:
    """(fn(), seconds on the host clock to its end on the card, peak
    device memory allocated meanwhile)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(device))


def f32_bodies(what: str, calls: int) -> dict:
    """Every fp32 stage and LeFF launch of the last `calls` forwards ran
    the three-pass TF32 bodies (EXPECTED_LAUNCHES' stage and leff each)
    and none the generic ones; returns the counts."""
    from uformer_tpu_torch.ops import kernels as K

    want = {k: {"f32_mma_launches": calls * EXPECTED_LAUNCHES[k],
                "f32_fma_launches": 0} for k in ("stage", "leff")}
    got = {k: K.core_counts()[k] for k in want}
    if got != want:
        raise RuntimeError(f"{what}: fp32 bodies {got}, expected {want}")
    print(f"  {what}: fp32 stage and LeFF launches by body {got}",
          flush=True)
    return got


def check_launches(what: str, calls: int) -> None:
    """Every forward of the last `calls` took the main path's kernels
    (EXPECTED_LAUNCHES each) and no plain version ran."""
    from uformer_tpu_torch.ops import kernels as K

    got, plain = K.launch_counts(), K.plain_counts()
    want = {k: calls * v for k, v in EXPECTED_LAUNCHES.items()}
    if got != want or any(plain.values()):
        raise RuntimeError(f"{what}: launches {got}, plain calls {plain}; "
                           f"expected {want} and no plain call")


def gopro_run(restore, frame: np.ndarray, kind: str) -> tuple:
    """The frame through restore (host arrays in and out): whole ('whole':
    padded per side, 'square': the reference's square) by
    gopro_hide.restore_image, or by tiled_inference ('tiled'). Returns
    (output, the shapes fed)."""
    from uformer_tpu_torch.eval.gopro_hide import restore_image
    from uformer_tpu_torch.eval.padding import tiled_inference

    fed = []

    def fn(x):
        fed.append(tuple(x.shape))
        return restore(x)

    if kind == "tiled":
        return tiled_inference(fn, frame[None], **EVAL_TILE)[0], fed
    return restore_image(fn, frame, 128, square_pad=kind == "square"), fed


def eval_phase(tmp: Path, sd, device, card: str):
    """The evaluation path, its files under tmp: the SIDD CLI from a
    reference-format .pth in bf16 and fp32 (the phase's main path), the
    same blocks on the plain path, bf16_psnr_delta_db (bench.py's protocol
    and the SIDD score), a GoPro frame whole, square-padded and tiled;
    times and peak memory. Returns the checks, the summary and the CLI
    runs' launches."""
    import scipy.io as sio

    from uformer_tpu_torch.eval import cli
    from uformer_tpu_torch.eval.metrics import psnr_clamped
    from uformer_tpu_torch.eval.sidd import (load_sidd_val_gt,
                                             load_sidd_val_noisy,
                                             restore_sidd, score_sidd)
    from uformer_tpu_torch.ops import kernels as K

    checks, summary = Checks(), {"card": card}
    n_img, n_blk, side = SIDD_SET
    requests = n_img * -(-n_blk // SIDD_BATCH)
    launches = dict.fromkeys(EXPECTED_LAUNCHES, 0)
    dtypes = (torch.float32, torch.bfloat16)
    pth, sidd = write_eval_inputs(tmp, sd)
    scores, restored = {}, {}
    for name in ("bfloat16", "float32"):
        K.reset_counts()
        t0 = time.perf_counter()
        scores[name] = cli.main([
            "sidd", "--input_dir", str(sidd), "--result_dir",
            str(tmp / name), "--weights", str(pth), "--dtype", name,
            "--device", "cuda"])
        secs = time.perf_counter() - t0
        check_launches(f"SIDD CLI {name}", requests)
        if name == "float32":
            summary["f32_bodies_sidd_cli"] = f32_bodies(
                f"SIDD CLI {name}", requests)
        for k, v in K.launch_counts().items():
            launches[k] += v
        out = sio.loadmat(tmp / name / "Idenoised.mat")["Idenoised"]
        if out.shape != (n_img, n_blk, side, side, 3) \
                or not np.isfinite(out).all():
            raise RuntimeError(f"SIDD CLI {name}: Idenoised {out.shape}")
        restored[getattr(torch, name)] = out
        summary[f"sidd_cli_{name}"] = {
            "psnr": scores[name][0], "ssim": scores[name][1], "s": secs}
        print(f"  SIDD CLI {name}: {requests} requests of {SIDD_BATCH} x "
              f"{side}^2, PSNR {scores[name][0]:.4f} SSIM "
              f"{scores[name][1]:.4f}, {secs:.2f} s with load and "
              f"scoring; launches {requests} x 6/4/4, no plain call",
              flush=True)
    noisy = load_sidd_val_noisy(str(sidd))
    gt = load_sidd_val_gt(str(sidd))

    rs = eval_restorers(pth, device)
    if rs[torch.float32].model.conv.use_shift:
        raise RuntimeError("eval: the bottleneck at train_ps 128 must run "
                           "unshifted")
    for dt in dtypes:
        K.reset_counts()
        rs[dt].numpy(noisy[0, :SIDD_BATCH])
        check_launches(f"SIDD request {dt}", 1)
        if dt == torch.float32:
            summary["f32_bodies_request"] = f32_bodies(
                f"SIDD bs{SIDD_BATCH} request {dt}", 1)
    # the plain path's outputs, and both paths' before the clamp: most of
    # the seeded model's output lies outside [0, 1]
    ref, raw, ref_raw = {}, {}, {}
    for dt in dtypes:
        raw[dt], ref_raw[dt] = [], []
        ref[dt] = restore_sidd(model_numpy(rs[dt], True, ref_raw[dt]),
                               noisy, SIDD_BATCH)
        restore_sidd(model_numpy(rs[dt], False, raw[dt]), noisy, SIDD_BATCH)
    what = f"SIDD CLI {n_img}x{n_blk} {side}^2"
    eval_compare(checks, what, restored, ref[torch.float32],
                 ref[torch.bfloat16])
    cat = {dt: np.concatenate(v) for dt, v in raw.items()}
    eval_compare(checks, f"{what} before the clamp", cat,
                 np.concatenate(ref_raw[torch.float32]),
                 np.concatenate(ref_raw[torch.bfloat16]))
    summary["sidd_outside_share"] = outside_share(ref_raw[torch.float32])
    print(f"  SIDD fp32 plain path: {100 * summary['sidd_outside_share']:.1f}"
          f"% of the output values lie outside [0, 1] before the clamp; "
          f"both paths compared before and after it", flush=True)
    del raw, ref_raw, cat

    # the restore loop on host arrays against the restorer alone at bs32
    mpix = n_img * n_blk * side * side / 1e6
    x_dev = torch.from_numpy(noisy[0, :SIDD_BATCH]).to(device)
    timing = {}
    for dt in dtypes:
        r = rs[dt]
        _, secs, peak = host_run(
            lambda r=r: restore_sidd(r.numpy, noisy, SIDD_BATCH), device)
        torch.cuda.reset_peak_memory_stats(device)
        ms = cuda_ms(lambda r=r: r(x_dev), reps=2)
        own = SIDD_BATCH * side * side / 1e6 / (ms / 1e3)
        timing[str(dt)] = {
            "loop_s": secs, "loop_mp_per_s": mpix / secs,
            "loop_peak_bytes": peak, "restorer_ms": ms,
            "restorer_mp_per_s": own,
            "restorer_peak_bytes": torch.cuda.max_memory_allocated(device),
            "host_share": 1.0 - requests * ms / 1e3 / secs,
            "plain_ms": cuda_ms(torch.no_grad()(
                lambda r=r: r.model(x_dev, plain=True).clamp_(0.0, 1.0)),
                reps=3, warmup=1)}
        t = timing[str(dt)]
        print(f"  SIDD restore loop {dt}: {t['loop_mp_per_s']:.2f} MP/s "
              f"(host arrays in and out; {secs:.3f} s, peak "
              f"{peak / 2**20:.1f} MiB) against the restorer's own "
              f"{own:.2f} MP/s at bs{SIDD_BATCH} ({ms:.3f} ms, peak "
              f"{t['restorer_peak_bytes'] / 2**20:.1f} MiB; plain path "
              f"{t['plain_ms']:.3f} ms): host share "
              f"{100 * t['host_share']:.1f}%  [{card}]", flush=True)
    # where an fp32 request's time goes: each kernel against its plain
    # version at bs32 256^2, 4 bytes a value, the products three times at
    # the TF32 rate and the rest at the float32 rate (the bound at the
    # float32 rate alone beside it; TF32 is off for the plain path); 1
    # call a time, each stage warm from the requests above
    rows, totals, fwd = timing_phase(rs[torch.float32], x_dev, s=4,
                                     peak=PEAK_FP32, reps=1, warmup=0,
                                     tf32x3=True)
    summary.update(fp32_timing=rows, fp32_totals=totals, fp32_forward=fwd)
    del x_dev
    t0 = time.perf_counter()
    score_sidd(restored[torch.bfloat16], gt)
    summary["sidd_score_s"] = time.perf_counter() - t0
    summary["sidd_timing"] = timing
    print(f"  SIDD scoring ({n_img} x {n_blk} blocks, MATLAB protocol): "
          f"{summary['sidd_score_s']:.2f} s on the host", flush=True)

    # a GoPro frame: whole (per side and square) and tiled
    frame = np.random.default_rng(8).uniform(0, 1, GOPRO_HW + (3,)) \
        .astype(np.float32)
    gopro = {}
    for kind, kdtypes in (("whole", dtypes), ("square", (torch.bfloat16,)),
                          ("tiled", dtypes)):
        ref, raw, ref_raw = {}, {}, {}
        for dt in dtypes:
            ref_raw[dt] = []
            ref[dt] = gopro_run(model_numpy(rs[dt], True, ref_raw[dt]),
                                frame, kind)[0]
        got = {}
        for dt in kdtypes:
            r = rs[dt]
            gopro_run(r.numpy, frame, kind)  # warm-up: cuDNN plans here
            raw[dt] = []
            gopro_run(model_numpy(r, False, raw[dt]), frame, kind)
            runs = []
            for _ in range(3):
                K.reset_counts()
                (out, fed), secs, peak = host_run(
                    lambda r=r: gopro_run(r.numpy, frame, kind), device)
                check_launches(f"GoPro {kind} {dt}", len(fed))
                runs.append(secs * 1e3)
            if out.shape != GOPRO_HW + (3,) or not np.isfinite(out).all():
                raise RuntimeError(f"GoPro {kind} {dt}: output {out.shape}")
            got[dt] = out
            gopro[f"{kind} {dt}"] = {"ms": float(np.median(runs)),
                                     "runs_ms": runs, "peak_bytes": peak,
                                     "fed": fed[0], "calls": len(fed)}
            print(f"  GoPro {GOPRO_HW[1]}x{GOPRO_HW[0]} {kind:6s} {dt}: "
                  f"{len(fed)} x {fed[0]}, {np.median(runs):.2f} ms "
                  f"(host arrays in and out), peak {peak / 2**20:.1f} MiB"
                  f"  [{card}]", flush=True)
        what = f"GoPro {kind} {len(fed)} x {fed[0]}"
        eval_compare(checks, what, got, ref[torch.float32],
                     ref[torch.bfloat16])
        eval_compare(checks, f"{what} before the clamp",
                     {dt: np.concatenate(v) for dt, v in raw.items()},
                     np.concatenate(ref_raw[torch.float32]),
                     np.concatenate(ref_raw[torch.bfloat16]))
        share = outside_share(ref_raw[torch.float32])
        gopro[f"{kind} outside_share"] = share
        print(f"  GoPro {kind}: {100 * share:.1f}% of the fp32 plain "
              f"path's output values lie outside [0, 1] before the clamp; "
              f"both paths compared before and after it", flush=True)
    summary["gopro"] = gopro
    del rs, ref, raw, ref_raw
    torch.cuda.empty_cache()

    # bf16_psnr_delta_db: bench.py's protocol (4 blocks, seed 7, noise
    # 0.1, train_ps 256, golden weights for init_params_fast's) and the
    # SIDD score's delta
    rs = eval_restorers(pth, device, train_ps=side)
    rng = np.random.default_rng(7)
    clean = rng.uniform(0, 1, (4, side, side, 3)).astype(np.float32)
    noisy4 = np.clip(clean + rng.normal(0, 0.1, clean.shape), 0, 1) \
        .astype(np.float32)
    psnr = {dt: float(np.mean([psnr_clamped(y, c) for y, c in
                               zip(rs[dt].numpy(noisy4), clean)]))
            for dt in dtypes}
    del rs
    torch.cuda.empty_cache()
    summary["bf16_psnr_delta_db"] = abs(psnr[torch.float32]
                                        - psnr[torch.bfloat16])
    summary["bf16_psnr_delta_db_sidd"] = abs(scores["float32"][0]
                                             - scores["bfloat16"][0])
    print(f"  bf16_psnr_delta_db {summary['bf16_psnr_delta_db']:.5f} "
          f"(bench protocol, PSNR fp32 {psnr[torch.float32]:.4f}), "
          f"{summary['bf16_psnr_delta_db_sidd']:.5f} (SIDD score); budget "
          f"{BF16_PSNR_BUDGET_DB}  [{card}]", flush=True)
    for key in ("bf16_psnr_delta_db", "bf16_psnr_delta_db_sidd"):
        if not summary[key] <= BF16_PSNR_BUDGET_DB:
            raise RuntimeError(f"eval: {key} {summary[key]:.5f} dB over "
                               f"the {BF16_PSNR_BUDGET_DB} dB budget")
    return checks, summary, launches


# the train loop phase: the train CLI's denoise recipe at Uformer_B's full
# width on seeded synthetic PNG pairs (training pairs, validation pairs,
# side), 8 steps an epoch at bs32 and a validation every 2
LOOP_SET, LOOP_SEED = (256, 8, 256), 11
LOOP_EPOCHS, LOOP_RESUME_EPOCHS = 2, 3
LOOP_VAL_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0), stage=6,
                         attention_image=4, leff=4)


def write_pairs(root: Path, n: int, side: int, seed: int) -> Path:
    """n PNG pairs of side^2 in the reference's layout (groundtruth/,
    input/): uint8 clean images (uniform) and clean + N(0, 0.08^2),
    clipped."""
    import cv2

    rng = np.random.default_rng(seed)
    for sub in ("groundtruth", "input"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        clean = rng.uniform(0, 1, (side, side, 3))
        noisy = np.clip(clean + rng.normal(0, 0.08, clean.shape), 0, 1)
        for sub, img in (("groundtruth", clean), ("input", noisy)):
            cv2.imwrite(str(root / sub / f"{i:04d}.png"),
                        np.uint8(np.round(img * 255)))
    return root


def data_plane_checks(train_dir: Path, card: str) -> tuple:
    """The native plane (native/augment.cpp, built by the port) against the
    numpy plane on the same draws, and both planes' MP/s at bs32 128^2 on
    this machine's host: the first epoch decodes the PNGs, the next two
    read the decode cache (bench.py's loader_mps)."""
    import cv2

    from uformer_tpu_torch.data import native
    from uformer_tpu_torch.data.datasets import (PairedTrainDataset,
                                                 _apply_dihedral,
                                                 batch_iterator)

    if not native.native_available():
        raise RuntimeError(f"train loop: the native data plane did not "
                           f"build ({native.SOURCE})")
    checks, summary = Checks(), {}
    nat = PairedTrainDataset(str(train_dir), RES_TRAIN, seed=3, native=True)
    num = PairedTrainDataset(str(train_dir), RES_TRAIN, seed=3, native=False)
    idx = list(range(BATCH_TRAIN))
    (g1, n1), (g2, n2) = nat.get_batch(idx), num.get_batch(idx)
    # the draws, again: the C++ plane's values are equal bits to
    # crop -> dihedral -> uint8 * float32(1/255); the numpy plane divides
    # by 255, within one float32 ulp of that
    rng = np.random.default_rng(3)
    inv = np.float32(1) / np.float32(255)
    differ = 0
    for j, i in enumerate(idx):
        H = W = LOOP_SET[2]
        r = int(rng.integers(0, H - RES_TRAIN + 1))
        c = int(rng.integers(0, W - RES_TRAIN + 1))
        k = int(rng.integers(0, 8))
        for sub, got in (("groundtruth", g1), ("input", n1)):
            u8 = cv2.cvtColor(cv2.imread(nat.gt_files[i] if sub ==
                                         "groundtruth" else nat.in_files[i]),
                              cv2.COLOR_BGR2RGB)
            want = _apply_dihedral(u8[r:r + RES_TRAIN, c:c + RES_TRAIN], k) \
                .astype(np.float32) * inv
            differ += int(not np.array_equal(got[j], want))
    ulps = max(int(np.abs(a.view(np.int32) - b.view(np.int32)).max())
               for a, b in ((g1, g2), (n1, n2)))
    checks.add("data plane", f"native bs{BATCH_TRAIN} batches differing "
               f"from crop, dihedral, uint8 x 1/255", float(differ), 0.0,
               "bits")
    checks.add("data plane", "native against numpy plane, float32 ulps",
               float(ulps), 1.0, "ulps")
    for ds in (nat, num):
        ds.close()
    for name, flag in (("native", True), ("numpy", False)):
        ds = PairedTrainDataset(str(train_dir), RES_TRAIN, seed=4,
                                native=flag)
        times = []
        for epoch in range(3):
            t0 = time.perf_counter()
            nb = sum(1 for _ in batch_iterator(ds, BATCH_TRAIN, seed=epoch))
            times.append(time.perf_counter() - t0)
        ds.close()
        mp = nb * BATCH_TRAIN * RES_TRAIN * RES_TRAIN / 1e6
        summary[f"loader_mps_{name}"] = {
            "decode_epoch": mp / times[0],
            "cached": 2 * mp / (times[1] + times[2]), "epoch_s": times}
        s = summary[f"loader_mps_{name}"]
        print(f"  loader {name}: {s['decode_epoch']:.2f} MP/s in the "
              f"epoch that decodes, {s['cached']:.2f} MP/s from the decode "
              f"cache (bs{BATCH_TRAIN} {RES_TRAIN}^2, {nb} batches an "
              f"epoch; host of this machine)  [{card}]", flush=True)
    return checks, summary


def loop_trainer_class():
    """The port's Trainer with probes around its step, validation, saves
    and resume: CUDA events at each step's start and end, the launches of
    each step and validation, the first step's inputs and result, and on
    resume the loaded state against the file. The loop itself runs as it
    is."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.train import checkpoints
    from uformer_tpu_torch.train.trainer import Trainer

    def diff(before):
        after = K.launch_counts()
        return {k: after[k] - before[k] for k in after}

    class LoopTrainer(Trainer):
        def __init__(self, opt):
            super().__init__(opt)
            self.steps, self.vals, self.saves = [], [], []
            self.first = self.resumed = None

        def build(self, steps_per_epoch):
            super().build(steps_per_epoch)
            step = self.train_step

            def probed(state, batch, gen):
                first = not self.steps and state.step == 0
                if first:
                    torch.backends.cudnn.deterministic = True
                    self.first = {
                        "weights": {k: v.clone() for k, v in
                                    self.model.state_dict().items()},
                        "batch": {k: v.clone() for k, v in batch.items()},
                        "gen": gen.get_state()}
                before = K.launch_counts()
                pending = checkpoints._PENDING
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                loss = step(state, batch, gen)
                end.record()
                self.steps.append({
                    "events": (start, end), "launches": diff(before),
                    "enqueue_ms": (time.perf_counter() - t0) * 1e3,
                    "save_writing": pending is not None
                    and not pending.done(), "after_val": False})
                if first:
                    torch.backends.cudnn.deterministic = False
                    self.first["loss"] = loss.clone()
                    self.first["after"] = {n: p.detach().clone() for n, p in
                                           self.model.named_parameters()}
                return loss

            self.train_step = probed

        def validate(self, state, val_batches):
            images = []

            def counted():
                for b in val_batches:
                    images.append(b["input"].shape[0])
                    yield b

            torch.cuda.synchronize()
            before = K.launch_counts()
            t0 = time.perf_counter()
            psnr = super().validate(state, counted())
            self.vals.append({"s": time.perf_counter() - t0,
                              "launches": diff(before),
                              "images": sum(images), "psnr": psnr})
            if self.steps:
                self.steps[-1]["after_val"] = True
            return psnr

        def _save(self, name, epoch, state, async_save=False):
            t0 = time.perf_counter()
            super()._save(name, epoch, state, async_save=async_save)
            self.saves.append({"name": name, "async": async_save,
                               "s": time.perf_counter() - t0})
            if self.steps:
                self.steps[-1]["after_val"] = True

        def init_state(self, resume=False):
            t0 = time.perf_counter()
            state = super().init_state(resume)
            torch.cuda.synchronize()
            if resume:
                secs = time.perf_counter() - t0
                ckpt = torch.load(checkpoints.checkpoint_path(
                    self.model_dir, "model_latest"), map_location="cpu",
                    weights_only=True)
                sd = self.model.state_dict()
                differ = [k for k, v in ckpt["state_dict"].items()
                          if not torch.equal(v, sd[k].cpu())]
                saved = ckpt["optimizer"]["state"]
                for i, s in state.optimizer.state_dict()["state"].items():
                    differ += [f"moment {i} {k}" for k, v in s.items()
                               if not torch.equal(v.cpu(), saved[i][k])]
                self.resumed = {"s": secs, "differ": differ,
                                "step": state.step,
                                "start_epoch": self.start_epoch,
                                "moments": len(saved)}
            return state

    return LoopTrainer


def run_train_cli(trainer_cls, argv):
    """uformer_tpu_torch.train.cli.main(argv), in-process, with its
    Trainer replaced by trainer_cls; returns main's result."""
    from uformer_tpu_torch.train import cli

    plain = cli.Trainer
    cli.Trainer = trainer_cls
    try:
        return cli.main(argv)
    finally:
        cli.Trainer = plain


def hand_step(first: dict, sched, steps_per_epoch: int, device,
              plain: bool, dtype) -> dict:
    """The trainer's first step again through make_train_step by hand:
    the same weights, batch and generator state, the trainer's schedule,
    cuDNN's deterministic algorithms. Returns the loss and every
    parameter after the step."""
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    torch.backends.cudnn.deterministic = True
    model = get_arch({"arch": "Uformer_B", "train_ps": RES_TRAIN,
                      "dtype": dtype}).to(device)
    model.load_state_dict(first["weights"])
    state = TrainState(model, make_optimizer(model.parameters(), sched))
    step = make_train_step(model, mixup_after_epoch=5,
                           steps_per_epoch=steps_per_epoch, plain=plain)
    gen = torch.Generator(device="cpu")
    gen.set_state(first["gen"])
    loss = step(state, first["batch"], gen)
    out = {"loss": loss.reshape(1).clone()}
    out.update({n: p.detach().clone() for n, p in model.named_parameters()})
    torch.backends.cudnn.deterministic = False
    del model, state
    torch.cuda.empty_cache()
    return out


def first_step_checks(trainer, device) -> tuple:
    """The loop adds nothing to the step: the trainer's first step (loss
    and every parameter after it) against make_train_step by hand on the
    kernel path (bf16), held to the train phase's bf16 whole-step rule
    against the plain path in fp32 and bf16; equal bits to the hand
    kernel step are reported."""
    first = trainer.first
    got = {"loss": first["loss"].reshape(1)}
    got.update(first["after"])
    spe = trainer.steps_per_epoch
    hand = hand_step(first, trainer.sched, spe, device, False,
                     torch.bfloat16)
    ref = hand_step(first, trainer.sched, spe, device, True, torch.float32)
    low = hand_step(first, trainer.sched, spe, device, True, torch.bfloat16)
    checks = Checks()
    for name, r in ref.items():
        scale = float(r.abs().max())
        checks.add("model", f"train loop first step {name}",
                   max_err(got[name], r),
                   1.5 * max_err(low[name], r) + 1e-3 * max(1.0, scale),
                   "bf16")
    unequal = [n for n in got if not torch.equal(got[n], hand[n])]
    print(f"  first step: loss {float(got['loss']):.6f} (hand kernel step "
          f"{float(hand['loss']):.6f}, plain fp32 {float(ref['loss']):.6f});"
          f" {len(got) - len(unequal)} of {len(got)} tensors equal bits to "
          f"the hand kernel step", flush=True)
    return checks, {"loss": float(got["loss"]),
                    "hand_kernel_loss": float(hand["loss"]),
                    "plain_fp32_loss": float(ref["loss"]),
                    "unequal_to_hand_kernel_step": unequal}


def loop_timing(trainers) -> dict:
    """Step times (CUDA events; the first step of each run, which picks
    cuDNN's algorithms, apart) and the device's idle share between steps
    that nothing but the loop separates (no validation or save): the gap
    from one step's end event to the next step's start event, over the
    time from one start to the next."""
    ms, gaps, spans, enqueue, writing = [], [], [], [], []
    for tr in trainers:
        steps = tr.steps
        ms += [s["events"][0].elapsed_time(s["events"][1])
               for s in steps[1:]]
        enqueue += [s["enqueue_ms"] for s in steps[1:]]
        writing += [s["save_writing"] for s in steps[1:]]
        for a, b in zip(steps, steps[1:]):
            if a["after_val"]:
                continue
            step_ms = a["events"][0].elapsed_time(a["events"][1])
            gap = a["events"][1].elapsed_time(b["events"][0])
            gaps.append(gap)
            spans.append(step_ms + gap)
    if not gaps:
        raise RuntimeError("train loop: no two steps in a row without a "
                           "validation or save between them")
    def median(flag):
        sel = [m for m, w in zip(ms, writing) if w == flag]
        return float(np.median(sel)) if sel else None

    return {"step_ms": ms, "step_ms_median": float(np.median(ms)),
            "enqueue_ms": enqueue, "save_writing": writing,
            "step_ms_median_save_writing": median(True),
            "step_ms_median_no_save_writing": median(False),
            "gaps_ms": gaps, "idle_share": sum(gaps) / sum(spans)}


def loop_log_lr(trainer) -> list:
    """The LRs the run's epoch lines logged (6 decimals, as written)."""
    with open(trainer.logname) as f:
        return [line.rsplit(" ", 1)[1] for line in f.read().splitlines()
                if line.startswith("Epoch: ")]


def refusal_checks(device) -> dict:
    """Uformer at embed 8, window 2 (every block at head dim 8 on 4-token
    windows, 16 windows a packed tile) on the card: its forward runs
    through the kernels (18 attention-block and 18 LeFF launches, no plain
    call, finite output), and so does its train step (18 attention-block,
    18 attention-block-backward, 18 LeFF and 18 LeFF-backward launches, no
    plain call, finite loss). A model at embed 20 (head dim 20 in every
    block, no multiple of 8: no kernel either way, ROADMAP queue 2 item
    9) has its step refused before any launch, naming the blocks. Returns
    the forward's and the step's launches."""
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    model = get_arch({"arch": "Uformer", "embed_dim": 8, "win_size": 2,
                      "train_ps": 32}).to(device)
    x = torch.rand(2, 32, 32, 3, device=device)
    K.reset_counts()
    with torch.no_grad():
        y = model.eval()(x)
    torch.cuda.synchronize()
    fwd = K.launch_counts()
    want = dict(NO_LAUNCHES, attention_block=18, leff=18)
    if fwd != want or any(K.plain_counts().values()) \
            or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"embed 8 window 2 forward on the card: launches "
                           f"{fwd}, plain calls {K.plain_counts()}; expected "
                           f"{want} and none")
    model.train()
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 2e-4))
    K.reset_counts()
    loss = make_train_step(model)(state, {"input": x, "target": x},
                                  torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    step = K.launch_counts()
    want = dict(NO_LAUNCHES, attention_block=18, attention_block_bwd=18,
                leff=18, leff_bwd=18)
    if step != want or any(K.plain_counts().values()) \
            or not np.isfinite(float(loss)):
        raise RuntimeError(f"embed 8 window 2 train step on the card: "
                           f"launches {step}, plain calls "
                           f"{K.plain_counts()}, loss {float(loss)}; "
                           f"expected {want}, none and a finite loss")
    odd = get_arch({"arch": "Uformer", "embed_dim": 20,
                    "train_ps": 32}).to(device)
    state = TrainState(odd, make_optimizer(odd.parameters(),
                                           lambda s: 2e-4))
    K.reset_counts()
    refused = None
    try:
        make_train_step(odd)(state, {"input": x, "target": x},
                             torch.Generator())
    except NotImplementedError as exc:
        refused = str(exc)
    launched = {k: v for k, v in K.launch_counts().items() if v}
    plain = {k: v for k, v in K.plain_counts().items() if v}
    if refused is None or launched or plain:
        raise RuntimeError(f"embed 20 train step on the card: refused "
                           f"{refused}, launches {launched}, plain calls "
                           f"{plain}; expected refused before any launch")
    print(f"  embed 8, window 2 on the card: forward 18 attention-block "
          f"and 18 LeFF launches; train step 18/18/18/18 forward and "
          f"backward launches, loss {float(loss):.6f}, no plain call; "
          f"embed 20 train step: {refused[:160]}", flush=True)
    return fwd, step


def train_loop_phase(tmp: Path, device, card: str, bare_ms: float):
    """The train CLI's denoise recipe (Uformer_B, bs32, 128^2, bf16,
    --warmup --warmup_epochs 1) in-process on seeded PNG pairs: two
    epochs with --checkpoint 2, then --resume --nepoch 3. Returns the
    checks, the summary and the loop's kernel launches."""
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.convert import load_checkpoint, load_pth
    from uformer_tpu_torch.eval.metrics import psnr_clamped
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.restore import Restorer

    n_train, n_val, side = LOOP_SET
    t0 = time.perf_counter()
    train_dir = write_pairs(tmp / "train", n_train, side, LOOP_SEED)
    val_dir = write_pairs(tmp / "val", n_val, side, LOOP_SEED + 1)
    summary = {"card": card, "write_s": time.perf_counter() - t0}
    checks, loader = data_plane_checks(train_dir, card)
    summary.update(loader)

    argv = ["--arch", "Uformer_B", "--batch_size", str(BATCH_TRAIN),
            "--train_ps", str(RES_TRAIN), "--mode", "denoising", "--warmup",
            "--warmup_epochs", "1", "--nepoch", str(LOOP_EPOCHS),
            "--checkpoint", "2", "--train_dir", str(train_dir), "--val_dir",
            str(val_dir), "--save_dir", str(tmp / "logs"),
            "--pretrain_weights", "", "--device", str(device)]
    cls = loop_trainer_class()
    benchmark = torch.backends.cudnn.benchmark
    K.reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer, state, best = run_train_cli(cls, argv)
    summary["run_s"] = time.perf_counter() - t0
    summary["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    launches = K.launch_counts()
    plain = K.plain_counts()
    spe = trainer.steps_per_epoch
    if spe != n_train // BATCH_TRAIN or state.step != LOOP_EPOCHS * spe:
        raise RuntimeError(f"train loop: {state.step} steps of {spe}")

    # 1. launches: every step and every validation forward, no plain call
    for i, s in enumerate(trainer.steps):
        if s["launches"] != TRAIN_LAUNCHES:
            raise RuntimeError(f"train loop: step {i} launched "
                               f"{s['launches']}, expected {TRAIN_LAUNCHES}")
    for i, v in enumerate(trainer.vals):
        want = {k: v["images"] * n for k, n in LOOP_VAL_LAUNCHES.items()}
        if v["launches"] != want or v["images"] != n_val:
            raise RuntimeError(f"train loop: validation {i} of "
                               f"{v['images']} images launched "
                               f"{v['launches']}, expected {want}")
    if len(trainer.vals) != LOOP_EPOCHS * (spe // max(spe // 4, 1)) \
            or any(plain.values()):
        raise RuntimeError(f"train loop: {len(trainer.vals)} validations, "
                           f"plain calls {plain}")

    # 3. checkpoints: each loads with weights_only; model_best gives the
    # logged best PSNR through a bf16 Restorer
    files = {name: Path(trainer.model_dir) / f"{name}.pth" for name in
             ("model_best", "model_latest", f"model_epoch_{LOOP_EPOCHS}")}
    for name, path in files.items():
        if len(load_pth(str(path))) != len(trainer.model.state_dict()):
            raise RuntimeError(f"train loop: {path} holds too few tensors")
    summary["checkpoint_mb"] = {n: p.stat().st_size / 2**20
                                for n, p in files.items()}
    restorer = Restorer(load_checkpoint(get_arch(
        {"arch": "Uformer_B", "train_ps": RES_TRAIN}),
        str(files["model_best"])), torch.bfloat16, device)
    from uformer_tpu_torch.data.datasets import PairedValDataset

    val = PairedValDataset(str(val_dir))
    K.reset_counts()
    psnr = sum(float(psnr_clamped(restorer(torch.from_numpy(
        np.ascontiguousarray(val[i][1][None]))), torch.from_numpy(
        np.ascontiguousarray(val[i][0][None])))) for i in range(len(val)))
    psnr /= len(val)
    del restorer
    checks.add("model", "model_best.pth bf16 Restorer PSNR against the "
               "logged best (dB)", abs(psnr - best), 1e-3, "dB")
    summary.update(best_psnr=best, restorer_psnr=psnr)

    # 2. the loop adds nothing to the step
    fchecks, summary["first_step"] = first_step_checks(trainer, device)
    checks.rows += fchecks.rows
    checks.failed += fchecks.failed
    trainer.first = None

    # 4. resume from model_latest: epoch, step, weights and moments
    K.reset_counts()
    t0 = time.perf_counter()
    trainer2, state2, _ = run_train_cli(cls, argv + [
        "--resume", "--nepoch", str(LOOP_RESUME_EPOCHS)])
    summary["resume_run_s"] = time.perf_counter() - t0
    for k, v in K.launch_counts().items():
        launches[k] += v
    if any(K.plain_counts().values()):
        raise RuntimeError(f"train loop resume: plain calls "
                           f"{K.plain_counts()}")
    for i, s in enumerate(trainer2.steps):
        if s["launches"] != TRAIN_LAUNCHES:
            raise RuntimeError(f"train loop resume: step {i} launched "
                               f"{s['launches']}")
    r = trainer2.resumed
    if r is None or r["start_epoch"] != LOOP_EPOCHS + 1 \
            or r["step"] != LOOP_EPOCHS * spe or r["differ"] \
            or r["moments"] != len(list(trainer2.model.parameters())):
        raise RuntimeError(f"train loop resume: {r}")
    if state2.step != LOOP_RESUME_EPOCHS * spe:
        raise RuntimeError(f"train loop resume: ended at step {state2.step}")
    lrs = loop_log_lr(trainer) + loop_log_lr(trainer2)
    # each run's own schedule (its nepoch): the LR after each epoch's
    # last step
    want = [f"{trainer.sched(e * spe):.6f}"
            for e in range(1, LOOP_EPOCHS + 1)] + [
        f"{trainer2.sched(e * spe):.6f}"
        for e in range(LOOP_EPOCHS + 1, LOOP_RESUME_EPOCHS + 1)]
    if lrs != want:
        raise RuntimeError(f"train loop: logged LRs {lrs}, expected {want}")
    summary["resume"] = {k: r[k] for k in ("s", "step", "start_epoch")}
    summary["logged_lr"] = lrs
    torch.backends.cudnn.benchmark = benchmark

    timing = loop_timing([trainer, trainer2])
    summary.update(timing)
    summary["bare_step_ms"] = bare_ms
    vals = trainer.vals + trainer2.vals
    saves = trainer.saves + trainer2.saves
    summary["validation_s"] = [v["s"] for v in vals]
    summary["saves"] = saves
    asyncs = [s["s"] for s in saves if s["async"]]
    syncs = [s["s"] for s in saves if not s["async"]]
    print(f"  train loop ({n_train} pairs, {spe} steps an epoch, "
          f"{len(timing['step_ms']) + 2} steps, {len(vals)} validations of "
          f"{n_val} x {side}^2, {len(saves)} saves): trainer "
          f"{timing['step_ms_median']:.3f} ms/step (median, CUDA events) "
          f"against the train phase's bare step {bare_ms:.3f} ms "
          f"({100 * (timing['step_ms_median'] / bare_ms - 1):+.1f}%)  "
          f"[{card}]", flush=True)
    print(f"  device idle share between steps {100 * timing['idle_share']:.2f}"
          f"% ({len(timing['gaps_ms'])} gaps, max "
          f"{max(timing['gaps_ms']):.3f} ms); host enqueue "
          f"{np.median(timing['enqueue_ms']):.3f} ms a step (median); step "
          f"{timing['step_ms_median_save_writing']} ms while a save is "
          f"written behind the loop, "
          f"{timing['step_ms_median_no_save_writing']} ms otherwise "
          f"(medians of {sum(timing['save_writing'])} and "
          f"{len(timing['save_writing']) - sum(timing['save_writing'])} "
          f"steps)  [{card}]", flush=True)
    print(f"  validation {np.mean(summary['validation_s']):.3f} s each "
          f"(mean of {len(vals)}); save: {np.mean(asyncs):.3f} s on the "
          f"loop's thread (best/latest, written behind it), "
          f"{np.mean(syncs):.3f} s in line (epoch-N), checkpoint "
          f"{summary['checkpoint_mb']['model_latest']:.1f} MiB; resume "
          f"{r['s']:.3f} s; peak {summary['peak_bytes'] / 2**20:.1f} MiB  "
          f"[{card}]", flush=True)
    print(f"  best PSNR {best:.4f} dB (logged), {psnr:.4f} dB from "
          f"model_best.pth through a bf16 Restorer; resume at epoch "
          f"{r['start_epoch']}, step {r['step']}, weights and "
          f"{r['moments']} AdamW states equal bits to the file; logged LRs "
          f"{lrs}", flush=True)
    return checks, summary, launches


# the models phase (16): UNet served and trained, checkpointed training,
# LeFF with Eca1d, freezing, the operation count, the profile and the NaN
# guard
SEED_UNET, SEED_ECA = 1238, 1239
NO_LAUNCHES = dict.fromkeys(EXPECTED_LAUNCHES, 0)
# a checkpointed step recomputes each block's forward in the backward
CKPT_LAUNCHES = dict(TRAIN_LAUNCHES, attention_image=80, leff=80)
T_CKPT_LAUNCHES = dict(T_TRAIN_LAUNCHES, attention_image=32,
                       attention_block=4, leff=36)
# LeFF with Eca1d at the bs32 128^2 train shapes of C 32, 128 and 512
ECA_SHAPES = [(BATCH_TRAIN, 128, 128, 32), (BATCH_TRAIN, 32, 32, 128),
              (BATCH_TRAIN, 8, 8, 512)]
FREEZE_PATTERN = "encoderlayer_"
N_CKPT_STEPS = 5
# the checkpointed bs32 128^2 step against the unchecked one, reckoned
# before the first run: one copy of every block's activation, ~484 MiB a
# batch, saved; one forward of the blocks added
CKPT_RECKONING = {"peak_mib": (-512.0, -409.6), "step_pct": (15.0, 25.0)}
# the CUDA functions of the kernels named in a profile of serve B
KERNEL_FAMILIES = {
    "stage": ("stage_kernel",),
    "leff": ("leff_kernel", "leff_narrow_kernel", "leff_wide_kernel"),
    "attention_image": ("attention_image_kernel", "attention_narrow_kernel",
                        "attention_wide_kernel")}


def unet_weights():
    """UNet's weights (the registry's dim 32) drawn with numpy from
    SEED_UNET over the port's own parameter names, by the golden weights'
    rule."""
    from uformer_tpu_torch import get_arch

    model = get_arch({"arch": "UNet"})
    keys_shapes = [[k, list(v.shape)] for k, v in model.named_parameters()]
    return golden_module().seeded_state_dict(keys_shapes, SEED_UNET)


def build_unet(sd, device):
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.convert import load_numpy_state_dict

    return load_numpy_state_dict(get_arch({"arch": "UNet"}), sd) \
        .to(device).eval()


def unet_eval_cli(tmp: Path, sd, restorer, card: str) -> dict:
    """serve UNet's weights as a reference-format .pth restored through
    the SIDD CLI with --arch UNet (bf16): Idenoised equal to the served
    restorer's own output on the same blocks, no kernel launched."""
    import scipy.io as sio

    from uformer_tpu_torch.eval import cli
    from uformer_tpu_torch.eval.sidd import load_sidd_val_noisy, \
        restore_sidd
    from uformer_tpu_torch.ops import kernels as K

    pth, sidd = write_eval_inputs(tmp, sd, "unet_seeded")
    K.reset_counts()
    t0 = time.perf_counter()
    psnr, ssim = cli.main(["sidd", "--input_dir", str(sidd), "--result_dir",
                           str(tmp / "out"), "--weights", str(pth),
                           "--arch", "UNet", "--dtype", "bfloat16",
                           "--device", "cuda"])
    secs = time.perf_counter() - t0
    if any(K.launch_counts().values()) or any(K.plain_counts().values()):
        raise RuntimeError("UNet SIDD CLI: a kernel wrapper was called")
    got = sio.loadmat(tmp / "out" / "Idenoised.mat")["Idenoised"]
    want = restore_sidd(restorer.numpy, load_sidd_val_noisy(str(sidd)),
                        SIDD_BATCH)
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or err > 0.0:
        raise RuntimeError(f"UNet SIDD CLI: Idenoised {got.shape} differs "
                           f"from the restorer's by {err}")
    print(f"  UNet SIDD CLI (--arch UNet, bf16, {SIDD_SET[0]} x "
          f"{SIDD_SET[1]} blocks of {SIDD_SET[2]}^2): PSNR {psnr:.4f} SSIM "
          f"{ssim:.4f}, {secs:.2f} s with load and scoring; Idenoised equal "
          f"bits to the served restorer's  [{card}]", flush=True)
    return {"psnr": psnr, "ssim": ssim, "s": secs}


def train_step_state(model, seed: int, lr: float = 0.0, mesh=None):
    """model's train step (bf16, mixup on: step 5 of 1-step epochs) with a
    fresh AdamW at lr, and a generator seeded with seed; over `mesh`'s
    data ranks where given."""
    from uformer_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    model.dtype = torch.bfloat16
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: lr), step=5)
    step = make_train_step(model, mixup_after_epoch=5, steps_per_epoch=1,
                           mesh=mesh)
    return state, step, torch.Generator(device="cpu").manual_seed(seed)


def counted_step(model, batch, seed: int, expected: dict, label: str,
                 lr: float = 0.0, mesh=None) -> dict:
    """One bf16 train step of model: its loss, every gradient, the
    generator's state after it and its launches, which must be `expected`
    with no plain call."""
    from uformer_tpu_torch.ops import kernels as K

    state, step, gen = train_step_state(model, seed, lr, mesh)
    K.reset_counts()
    loss = step(state, batch, gen)
    torch.cuda.synchronize()
    counts, plain = K.launch_counts(), K.plain_counts()
    if counts != expected or any(plain.values()):
        raise RuntimeError(f"{label}: launched {counts}, plain calls "
                           f"{plain}; expected {expected}, no plain call")
    return {"loss": loss.clone(), "gen": gen.get_state(), "counts": counts,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}}


def same_step(a: dict, b: dict, label: str) -> dict:
    """a and b (counted_step) in equal bits: the loss, the generator's
    state and every gradient. A gradient that differs must lie within
    1e-6 max(1, max|g|); returns {name: (err, bound)} of those."""
    if not torch.equal(a["loss"], b["loss"]) \
            or not torch.equal(a["gen"], b["gen"]) \
            or a["grads"].keys() != b["grads"].keys():
        raise RuntimeError(f"{label}: loss {float(a['loss'])} vs "
                           f"{float(b['loss'])}, or the generators or the "
                           f"gradient sets differ")
    differ = {}
    for n, g in a["grads"].items():
        if not torch.equal(g, b["grads"][n]):
            err = max_err(g, b["grads"][n])
            bound = 1e-6 * max(1.0, float(g.abs().max()))
            differ[n] = (err, bound)
            if err > bound:
                raise RuntimeError(f"{label}: {n} differs by {err:.3e} > "
                                   f"{bound:.3e}")
    return differ


def timed_steps(model, batch, n: int, mesh=None) -> tuple:
    """n bf16 steps of model after one warm-up, lr 0: ms per step (CUDA
    events), the host's ms to enqueue each, and the peak memory allocated
    over them."""
    state, step, gen = train_step_state(model, 21, mesh=mesh)
    step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, host_ms = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step(state, batch, gen)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms, host_ms, torch.cuda.max_memory_allocated()


def ckpt_phase(sd, arch: str, device, expected: dict, expected_ck: dict,
               card: str) -> dict:
    """arch at bs32 128^2 bf16 (drop path 0.1, mixup on), with
    use_checkpoint and without, on the same weights, batch and generator
    state: the checkpointed step equals the unchecked one (`same_step`),
    which also runs twice to tell nondeterminism from checkpointing; then
    ms a step and peak memory both ways, in the order unchecked, checked,
    checked, unchecked."""
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.convert import load_numpy_state_dict

    models = {ck: load_numpy_state_dict(get_arch({
        "arch": arch, "train_ps": RES_TRAIN, "use_checkpoint": ck}), sd)
        .to(device) for ck in (False, True)}
    batch = train_batch(BATCH_TRAIN, 6, device)
    torch.backends.cudnn.deterministic = True
    plain_run = counted_step(models[False], batch, 11, expected, arch)
    ck_run = counted_step(models[True], batch, 11, expected_ck,
                          f"{arch} checkpointed")
    again = counted_step(models[False], batch, 11, expected, arch)
    torch.backends.cudnn.deterministic = False
    differ = same_step(plain_run, ck_run, f"{arch} checkpointed")
    unsteady = sorted(n for n in differ
                      if not torch.equal(plain_run["grads"][n],
                                         again["grads"][n]))
    n_grads = len(plain_run["grads"])
    print(f"  {arch} bs{BATCH_TRAIN} {RES_TRAIN}^2 bf16, drop path 0.1, "
          f"mixup: checkpointed step against unchecked: loss "
          f"{float(ck_run['loss']):.6f} and the generator's state equal "
          f"bits, {n_grads - len(differ)} of {n_grads} gradients equal "
          f"bits; launches {ck_run['counts']} against "
          f"{plain_run['counts']}", flush=True)
    if differ:
        print(f"  {len(differ)} gradients within 1e-6 max(1, max|g|), "
              f"{len(unsteady)} of them differ between two unchecked runs "
              f"too: {sorted(differ)[:8]}", flush=True)
    del plain_run["grads"], ck_run["grads"], again
    times = {False: [], True: []}
    host, peaks = copy.deepcopy(times), copy.deepcopy(times)
    for ck in (False, True, True, False):
        # the model timed alone on the card: its peak is the step's own
        models[not ck].zero_grad(set_to_none=True)
        models[not ck].cpu()
        models[ck].to(device)
        torch.cuda.empty_cache()
        ms, host_ms, peak = timed_steps(models[ck], batch, N_CKPT_STEPS)
        times[ck] += ms
        host[ck] += host_ms
        peaks[ck].append(peak)
    med = {ck: float(np.median(v)) for ck, v in times.items()}
    host_med = {ck: float(np.median(v)) for ck, v in host.items()}
    peak = {ck: max(v) for ck, v in peaks.items()}
    d_mib = (peak[True] - peak[False]) / 2**20
    d_pct = 100.0 * (med[True] / med[False] - 1.0)
    print(f"  {arch} step: unchecked {med[False]:.3f} ms (host enqueue "
          f"{host_med[False]:.3f}), peak {peak[False] / 2**20:.1f} MiB; "
          f"checkpointed {med[True]:.3f} ms (host enqueue "
          f"{host_med[True]:.3f}), peak {peak[True] / 2**20:.1f} MiB: "
          f"{d_pct:+.1f}% a step, {d_mib:+.1f} MiB (reckoned "
          f"{CKPT_RECKONING['step_pct']} % and {CKPT_RECKONING['peak_mib']}"
          f" MiB for Uformer_B)  [{card}]", flush=True)
    del models
    torch.cuda.empty_cache()
    return {"launches": ck_run["counts"], "launches_unchecked":
            plain_run["counts"], "grads": n_grads,
            "grads_differ": {n: list(v) for n, v in differ.items()},
            "grads_differ_unchecked_twice": unsteady,
            "ms": {str(k): v for k, v in times.items()},
            "host_ms": {str(k): v for k, v in host.items()},
            "median_ms": {str(k): v for k, v in med.items()},
            "host_median_ms": {str(k): v for k, v in host_med.items()},
            "peak_bytes": {str(k): v for k, v in peak.items()},
            "step_pct": d_pct, "peak_mib": d_mib}


def eca_checks(device) -> tuple:
    """LeFF with Eca1d (seeded weights, LN2 on, residual after the gate)
    at ECA_SHAPES in fp32 and bf16: the forward through kernel 2 and the
    gradients of x, every weight, the gate's conv and LN through kernel 7,
    against the plain version under the phase's rules; one launch of each
    kernel per kernel-path call, no plain call."""
    from uformer_tpu_torch.convert import load_numpy_state_dict
    from uformer_tpu_torch.models.layers import LeFF
    from uformer_tpu_torch.ops import kernels as K

    checks = Checks()
    launches = dict.fromkeys(EXPECTED_LAUNCHES, 0)
    gen = torch.Generator(device="cpu").manual_seed(SEED_ECA)
    f32, b16 = torch.float32, torch.bfloat16
    for shape in ECA_SHAPES:
        C = shape[-1]
        mod = LeFF(C, 4 * C, use_eca=True)
        keys = [[k, list(v.shape)] for k, v in mod.named_parameters()]
        load_numpy_state_dict(mod, golden_module().seeded_state_dict(
            keys, SEED_ECA + C))
        mod.to(device)
        ln = [(1.0 + 0.05 * torch.randn(C, generator=gen)).to(device),
              (0.02 * torch.randn(C, generator=gen)).to(device)]
        what = f"eca {shape}"

        def fwd(x, dt, plain):
            with torch.no_grad():
                return mod(x.to(dt), ln_s=ln[0], ln_b=ln[1], residual=True,
                           plain=plain)

        def grads(x, g, dt, plain):
            xx = x.to(dt).requires_grad_(True)
            lns = [t.clone().requires_grad_(True) for t in ln]
            y = mod(xx, ln_s=lns[0], ln_b=lns[1], residual=True,
                    plain=plain)
            names = (["dx"] + [n for n, _ in mod.named_parameters()]
                     + ["dln_s", "dln_b"])
            return dict(zip(names, torch.autograd.grad(
                y, [xx] + list(mod.parameters()) + lns, g.to(dt))))

        x = torch.randn(shape, generator=gen).bfloat16().float().to(device)
        g = torch.randn(shape, generator=gen).bfloat16().float().to(device)
        K.reset_counts()
        compare(checks, "leff", what, lambda x, dt: fwd(x, dt, False),
                lambda x, dt: fwd(x, dt, True), x)
        got, got16 = grads(x, g, f32, False), grads(x, g, b16, False)
        torch.cuda.synchronize()
        counts, plain = K.launch_counts(), K.plain_counts()
        if counts["leff"] != 4 or counts["leff_bwd"] != 2 \
                or any(plain.values()):
            raise RuntimeError(f"{what}: launched {counts}, plain {plain}")
        for k, v in counts.items():
            launches[k] += v
        grad_bound(checks, "leff_bwd", what, got, grads(x, g, f32, True),
                   grads(x, g, b16, True), got16)
        del mod, x, g, got, got16
    torch.cuda.empty_cache()
    return checks, launches


def freeze_phase(sd, device, card: str) -> tuple:
    """Uformer_B at bs2 128^2, bf16, with every `encoderlayer_` tensor
    frozen: two steps at lr 2e-4 (cuDNN deterministic). The first step's
    gradients equal, bit for bit, those of the same step of the unfrozen
    model; after both the frozen tensors keep their bits and every other
    tensor has moved; 40/40/40/40 launches a step."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.utils.freeze import freeze, path_matches, \
        trainable_parameters

    batch = train_batch(BATCH_CHECK, 7, device)
    frozen = freeze(build_model(sd, RES_TRAIN, device),
                    lambda n: path_matches(n, FREEZE_PATTERN))
    whole = build_model(sd, RES_TRAIN, device)
    before = {n: p.detach().clone() for n, p in frozen.named_parameters()}
    torch.backends.cudnn.deterministic = True
    state, step, gen = train_step_state(frozen, 13, lr=2e-4)
    runs = []
    for i in range(2):
        K.reset_counts()
        step(state, batch, gen)
        torch.cuda.synchronize()
        if K.launch_counts() != TRAIN_LAUNCHES or any(
                K.plain_counts().values()):
            raise RuntimeError(f"freeze: step {i} launched "
                               f"{K.launch_counts()}")
        runs.append({n: p.grad.clone() for n, p in frozen.named_parameters()
                     if p.grad is not None})
    ref = counted_step(whole, batch, 13, TRAIN_LAUNCHES, "freeze unfrozen",
                       lr=2e-4)
    torch.backends.cudnn.deterministic = False
    n_frozen = n_moved = 0
    for n, p in frozen.named_parameters():
        if not p.requires_grad:
            if n in runs[0] or not torch.equal(p.detach(), before[n]):
                raise RuntimeError(f"freeze: frozen {n} moved")
            n_frozen += 1
            continue
        if not torch.equal(runs[0][n], ref["grads"][n]):
            raise RuntimeError(f"freeze: {n}'s gradient differs from the "
                               f"unfrozen step's by "
                               f"{max_err(runs[0][n], ref['grads'][n])}")
        if torch.equal(p.detach(), before[n]):
            raise RuntimeError(f"freeze: trainable {n} did not move")
        n_moved += 1
    if n_moved != len(trainable_parameters(frozen)) or not n_frozen:
        raise RuntimeError("freeze: no tensor frozen")
    print(f"  freeze {FREEZE_PATTERN}*: {n_frozen} tensors frozen (equal "
          f"bits after 2 bf16 steps at bs{BATCH_CHECK}), {n_moved} moved, "
          f"their first-step gradients equal bits to the unfrozen step's; "
          f"{TRAIN_LAUNCHES['attention_image']}/{TRAIN_LAUNCHES['leff']}/"
          f"{TRAIN_LAUNCHES['attention_bwd']}/{TRAIN_LAUNCHES['leff_bwd']} "
          f"launches a step  [{card}]", flush=True)
    del frozen, whole
    torch.cuda.empty_cache()
    return {"frozen": n_frozen, "moved": n_moved}, \
        {k: 2 * v for k, v in TRAIN_LAUNCHES.items()}


def family_ms(summary: dict, kernel: str) -> float:
    """A profile summary's ms of the CUDA functions of `kernel`."""
    names = KERNEL_FAMILIES[kernel]
    return sum(ms for fam, ms in summary.items()
               if fam.split("::")[-1] in names)


def flops_profile_phase(tmp: Path, sd, device, totals: dict, fwd: dict,
                        serve: dict, card: str) -> dict:
    """Serve B again: model_complexity at 256^2 (batch 1) over phase 6's
    forward time, as TFLOP/s and a share of the bf16 peak (the MFU the
    first benchmark will report); one forward under utils.debug.profile,
    whose summary must name the stage, LeFF and attention-image kernels
    and sum them within 10% of phase 6's CUDA-event times; a NaN fed to a
    card forward under enable_nan_checks raises FloatingPointError naming
    a module."""
    from uformer_tpu_torch.restore import Restorer
    from uformer_tpu_torch.utils import debug
    from uformer_tpu_torch.utils.flops import model_complexity

    restorer = Restorer(build_model(sd, RES_SERVE, device), torch.bfloat16,
                        device)
    t0 = time.perf_counter()
    info = model_complexity(restorer.model, (1, RES_SERVE, RES_SERVE, 3))
    count_s = time.perf_counter() - t0
    flop = BATCH_SERVE * info["gflops"] * 1e9
    tflops = flop / (fwd["kernel_ms"] * 1e-3) / 1e12
    tflops_req = flop / (serve["median_ms"] * 1e-3) / 1e12
    mfu = 100.0 * tflops * 1e12 / PEAK_BF16
    print(f"  Uformer_B at {RES_SERVE}^2: {info['params_m']:.3f} M "
          f"parameters, {info['gflops']:.3f} GFLOP and {info['bytes_gb']:.3f}"
          f" GB (unfused) a forward of one image (counted in {count_s:.1f} "
          f"s); serve B bs{BATCH_SERVE}: {fwd['kernel_ms']:.3f} ms a forward "
          f"(phase 6) = {tflops:.2f} TFLOP/s, {mfu:.2f}% of "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s; per request "
          f"({serve['median_ms']:.3f} ms) {tflops_req:.2f} TFLOP/s  "
          f"[{card}]", flush=True)

    x = torch.rand(BATCH_SERVE, RES_SERVE, RES_SERVE, 3,
                   generator=torch.Generator().manual_seed(3))
    restorer(x)
    torch.cuda.synchronize()
    trace_dir = tmp / "trace"
    with debug.profile(str(trace_dir)):
        restorer(x)
        torch.cuda.synchronize()
    summary = debug.summarize_trace(str(trace_dir), top=50)
    for fam, ms in list(summary.items())[:10]:
        print(f"    {ms:9.3f} ms  {fam}")
    prof = {k: family_ms(summary, k) for k in KERNEL_FAMILIES}
    events = {k: totals[k]["ms"] for k in KERNEL_FAMILIES}
    missing = [k for k, v in prof.items() if v <= 0.0]
    p_sum, e_sum = sum(prof.values()), sum(events.values())
    print(f"  profile: stage {prof['stage']:.3f}, leff {prof['leff']:.3f}, "
          f"attention_image {prof['attention_image']:.3f} ms (sum "
          f"{p_sum:.3f}) against phase 6's CUDA events {e_sum:.3f} ms "
          f"({100 * (p_sum / e_sum - 1):+.1f}%)  [{card}]", flush=True)
    if missing or abs(p_sum - e_sum) > 0.1 * e_sum:
        raise RuntimeError(f"profile: missing {missing}, or {p_sum:.3f} ms "
                           f"not within 10% of {e_sum:.3f}")

    bad = x.clone()
    bad[0, 17, 33, 1] = float("nan")
    try:
        debug.enable_nan_checks()
        restorer(bad)
    except FloatingPointError as exc:
        named = str(exc)
    else:
        raise RuntimeError("enable_nan_checks: a NaN input did not raise")
    finally:
        debug.enable_nan_checks(False)
    if "input_proj" not in named:
        raise RuntimeError(f"enable_nan_checks named {named!r}")
    print(f"  NaN guard on the card: {named}", flush=True)
    del restorer
    torch.cuda.empty_cache()
    return {"complexity": info, "tflops": tflops, "mfu_pct": mfu,
            "tflops_per_request": tflops_req, "profile_top": summary,
            "profile_ms": prof, "event_ms": events, "nan_error": named}


def models_phase(tmp: Path, sd, sd_t, device, totals: dict, fwd: dict,
                 serve: dict, card: str) -> tuple:
    """Phase 16. Returns the checks, the summary and each path's
    launches. Its peaks are torch.cuda.max_memory_allocated, which counts
    what earlier phases still hold: that base is printed first."""
    gc.collect()
    torch.cuda.empty_cache()
    checks = Checks()
    summary = {"base_bytes": torch.cuda.memory_allocated(device)}
    launches = {}
    print(f"  {summary['base_bytes'] / 2**20:.1f} MiB allocated at the "
          f"phase's start (every peak below includes it)", flush=True)
    sd_u = unet_weights()
    restorer, _, summary["serve_unet"], launches["serve_unet"], uchecks = \
        serve_phase(lambda: build_unet(sd_u, device), device, NO_LAUNCHES,
                    "serve UNet")
    uchecks.raise_if_failed("serve UNet")
    checks.rows += uchecks.rows
    su = summary["serve_unet"]
    print(f"  serve UNet bs{BATCH_SERVE} {RES_SERVE}^2 bf16: "
          f"{su['median_ms']:.3f} ms a request, {su['mp_per_s']:.2f} MP/s, "
          f"peak {su['max_memory_allocated_bytes'] / 2**20:.1f} MiB  "
          f"[{card}]", flush=True)
    summary["unet_cli"] = unet_eval_cli(tmp / "unet", sd_u, restorer, card)
    del restorer
    torch.backends.cudnn.deterministic = True
    tchecks, _ = whole_step_checks(
        lambda: build_unet(sd_u, device).train(), device, BATCH_TRAIN,
        "train UNet", NO_LAUNCHES)
    torch.backends.cudnn.deterministic = False
    tchecks.raise_if_failed("train UNet")
    checks.rows += tchecks.rows
    model, summary["train_unet"] = train_timing(
        lambda: build_unet(sd_u, device), device, NO_LAUNCHES, "train UNet")
    del model
    torch.cuda.empty_cache()
    tu = summary["train_unet"]
    print(f"  train UNet bs{BATCH_TRAIN} {RES_TRAIN}^2 bf16: "
          f"{tu['kernel_ms_median']:.3f} ms a step, peak "
          f"{tu['peak_bytes'] / 2**20:.1f} MiB  [{card}]", flush=True)

    summary["ckpt"] = ckpt_phase(sd, "Uformer_B", device, TRAIN_LAUNCHES,
                                 CKPT_LAUNCHES, card)
    launches["train_ckpt"] = summary["ckpt"]["launches"]
    summary["ckpt_t"] = ckpt_phase(sd_t, "Uformer_T", device,
                                   T_TRAIN_LAUNCHES, T_CKPT_LAUNCHES, card)
    launches["train_t_ckpt"] = summary["ckpt_t"]["launches"]

    echecks, launches["eca"] = eca_checks(device)
    echecks.raise_if_failed("LeFF with Eca1d")
    checks.rows += echecks.rows
    summary["freeze"], launches["freeze"] = freeze_phase(sd, device, card)
    summary["flops_profile"] = flops_profile_phase(tmp, sd, device, totals,
                                                   fwd, serve, card)
    return checks, summary, launches


# the parallel phase: NCCL at world size 1 in this process; 2 and 4 ranks
# spawned on the one card over gloo (NCCL refuses two ranks on one GPU:
# their halos, rolls and gathers go through pinned host memory)
PAR_SEED = 31
PAR_TIMEOUT_S = 600
PAR_SPATIAL4 = (2, RES_SERVE)  # batch, side of the 4-rank fp32 forward
PAR_CLI_SET = (64, 2, 256)  # train pairs (2 steps of 32), val pairs, side
SPATIAL_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0),
                        attention_block=40, leff=40)
# 4 ranks at 256^2: levels 0-3 split (38 blocks, kernel 5 once per image
# of the batch of 2), the bottleneck (2 blocks) gathered, one launch each
SPATIAL4_LAUNCHES = dict(SPATIAL_LAUNCHES, attention_block=38 * 2 + 2)
# the spatial path at windows other than 8: `--arch Uformer --embed_dim 32
# --win_size W` built at 256^2 (every stage at window W but the 16^2
# bottleneck at window 32, which runs at 16), seeded weights. Kernel 5
# alone at every (stage, rank) shape on SPATIAL_WIN_WORLDS ranks at
# windows 2 and 4 (packed tiles), 16 and 32 (csrc/attention_wide.cu); the
# whole sharded forward of one image on 2 ranks at windows 4, 16 and 32
# against the unsharded kernel path, 18 kernel-5 and 18 kernel-2 launches
# a rank. The image's side (SPATIAL_WIN_SIDE) is one the path takes
# unpadded, a multiple of 16 win: 512 at window 32
SPATIAL_WIN = {win: ({"arch": "Uformer", "embed_dim": 32, "win_size": win,
                      "train_ps": RES_SERVE}, 1250 + win)
               for win in (2, 4, 16, 32)}
SPATIAL_WIN_FORWARD = (4, 16, 32)
SPATIAL_WIN_SIDE = {2: RES_SERVE, 4: RES_SERVE, 16: RES_SERVE, 32: 512}
SPATIAL_WIN_WORLDS = {2: (2, 4), 4: (2, 4), 16: (2, 4), 32: (2,)}
SPATIAL_WIN_LAUNCHES = dict(SPATIAL_LAUNCHES, attention_block=18, leff=18)
# the spatial path at head dim 48: `--arch Uformer --embed_dim 48` built at
# 256^2 (seeded 1285), one image on 2 ranks in fp32 against the unsharded
# kernel path, 18 kernel-5 and 18 kernel-2 launches a rank
SPATIAL_E48 = ({"arch": "Uformer", "embed_dim": 48, "train_ps": RES_SERVE},
               1285)


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bits_crc(a: np.ndarray) -> int:
    import zlib

    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def launches_of(fn) -> tuple:
    """(fn(), kernel launches, plain calls) of one call on the card."""
    from uformer_tpu_torch.ops import kernels as K

    K.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, K.launch_counts(), K.plain_counts()


def expect_counts(what: str, counts: dict, plain: dict,
                  expected: dict) -> None:
    if counts != expected or any(plain.values()):
        raise RuntimeError(f"{what}: launched {counts}, plain calls {plain};"
                           f" expected {expected}, no plain call")


def rank_step(sd, device, world: int) -> dict:
    """This rank's DDP step of the bs32 batch (its 32 / world rows, bf16,
    mixup on, drop path 0.1): loss, generator state, launches, the
    gradients (rank 0; the others their crc32), then 3 timed steps."""
    from uformer_tpu_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(world, device=device)
    model = build_model(sd, RES_TRAIN, device)
    batch = shard_batch(mesh, train_batch(BATCH_TRAIN, PAR_SEED, device))
    torch.backends.cudnn.deterministic = True
    res = counted_step(model, batch, PAR_SEED + 1, TRAIN_LAUNCHES,
                       f"rank {mesh.rank} DDP step", mesh=mesh)
    torch.backends.cudnn.deterministic = False
    grads = {n: g.float().cpu().numpy() for n, g in res["grads"].items()}
    ms, host_ms, peak = timed_steps(model, batch, 3, mesh=mesh)
    return {"loss": float(res["loss"]), "gen": res["gen"].numpy(),
            "counts": res["counts"],
            "grads": grads if mesh.rank == 0 else None,
            "grads_crc": bits_crc(np.concatenate(
                [g.reshape(-1) for g in grads.values()])),
            "ms": ms, "host_ms": host_ms, "peak_bytes": peak}


def rank_spatial(sd, device, x: np.ndarray, dtypes: tuple,
                 reps: int = 1) -> dict:
    """Serve B's Uformer_B forward of x (the whole batch, on every rank)
    split along H over the ranks, bf16 and fp32: the result (rank 0; the
    others its crc32), launches and plain calls, ms a forward on the host
    clock and the exchanges' share of it."""
    import torch.distributed as dist

    from uformer_tpu_torch.parallel import spatial as S
    from uformer_tpu_torch.restore import Restorer

    model = build_model(sd, RES_SERVE, device)
    xt = torch.from_numpy(x).to(device)
    out = {}
    for dt in dtypes:
        r = Restorer(model, dt, device)

        def fwd(r=r):
            return S.run_uformer_spatially_sharded(r.model, xt,
                                                   dist.group.WORLD)

        y, counts, plain = launches_of(fwd)
        y = y.cpu().numpy()
        S.reset_exchange_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        ex = S.exchange_stats()
        out[str(dt)] = {
            "y": y if dist.get_rank() == 0 else None, "crc": bits_crc(y),
            "counts": counts, "plain": plain, "ms": ms,
            "exchange_ms": ex["seconds"] * 1e3 / reps,
            "exchange_calls": ex["calls"] / reps,
            "exchange_mib": ex["bytes"] / reps / 2**20}
    return out


def rank_spatial_win(device, x_win: dict) -> dict:
    """The sharded forward of x_win[win] over the ranks for each
    SPATIAL_WIN_FORWARD window's model, bf16 and fp32: the result (rank 0;
    the others its crc32), launches and plain calls."""
    import torch.distributed as dist

    from uformer_tpu_torch.parallel import spatial as S
    from uformer_tpu_torch.restore import Restorer

    out = {}
    for win in SPATIAL_WIN_FORWARD:
        xt = torch.from_numpy(x_win[win]).to(device)
        opt, seed = SPATIAL_WIN[win]
        model = build_arch(opt, seeded_for(opt, seed), device)
        for dt in (torch.bfloat16, torch.float32):
            r = Restorer(model, dt, device)
            y, counts, plain = launches_of(
                lambda r=r: S.run_uformer_spatially_sharded(
                    r.model, xt, dist.group.WORLD))
            y = y.float().cpu().numpy()
            out[(win, str(dt))] = {
                "y": y if dist.get_rank() == 0 else None,
                "crc": bits_crc(y), "counts": counts, "plain": plain}
    return out


def rank_spatial_e48(device, x: np.ndarray) -> dict:
    """The fp32 sharded forward of x over the ranks at --embed_dim 48
    (SPATIAL_E48): the result (rank 0; the others its crc32), launches and
    plain calls."""
    import torch.distributed as dist

    from uformer_tpu_torch.parallel import spatial as S
    from uformer_tpu_torch.restore import Restorer

    opt, seed = SPATIAL_E48
    r = Restorer(build_arch(opt, seeded_for(opt, seed), device),
                 torch.float32, device)
    xt = torch.from_numpy(x).to(device)
    y, counts, plain = launches_of(
        lambda: S.run_uformer_spatially_sharded(r.model, xt,
                                                dist.group.WORLD))
    y = y.float().cpu().numpy()
    return {"y": y if dist.get_rank() == 0 else None, "crc": bits_crc(y),
            "counts": counts, "plain": plain}


def eval_cli_args(gopro_dir: Path, pth, dtype: str, world: int) -> list:
    args = ["gopro", "--input_dir", str(gopro_dir), "--weights", str(pth),
            "--tile", str(EVAL_TILE["tile"]), "--tile_overlap",
            str(EVAL_TILE["overlap"]), "--tile_batch",
            str(EVAL_TILE["tile_batch"]), "--dtype", dtype]
    if world > 1:
        args += ["--mesh_data", str(world), "--device", "cuda:0",
                 "--dist_backend", "gloo"]
    return args


def rank_eval(gopro_dir: Path, pth, frame: np.ndarray, result_dir: Path,
              world: int) -> dict:
    """The eval CLI with --mesh_data: its restorer on the frame (this
    rank's tiles, the blend on every rank), bf16 and fp32, and its GoPro
    harness (rank 0 writes)."""
    import torch.distributed as dist

    from uformer_tpu_torch.eval import cli as ecli

    out = {}
    for name in ("bfloat16", "float32"):
        fn = ecli.build_restorer(ecli.eval_argparser().parse_args(
            eval_cli_args(gopro_dir, pth, name, world)))
        fn(frame[None])  # warm-up: cuDNN plans
        t0 = time.perf_counter()
        y, counts, plain = launches_of(lambda fn=fn: fn(frame[None])[0])
        out[name] = {"y": y if dist.get_rank() == 0 else None,
                     "crc": bits_crc(y), "counts": counts, "plain": plain,
                     "ms": (time.perf_counter() - t0) * 1e3}
    out["gopro"] = ecli.main(eval_cli_args(gopro_dir, pth, "bfloat16", world)
                             + ["--result_dir", str(result_dir),
                                "--save_images"])
    return out


def par_rank(rank: int, world: int, tasks: tuple, inputs: dict) -> dict:
    """One rank of phase 17 on cuda:0 (gloo): the tasks named."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    _, sd = seeded_weights()
    out = {}
    if "step" in tasks:
        out["step"] = rank_step(sd, device, world)
    if "spatial" in tasks:
        out["spatial"] = rank_spatial(sd, device, inputs["spatial"],
                                      inputs["dtypes"])
    if "spatial_win" in tasks:
        out["spatial_win"] = rank_spatial_win(device, inputs["x_win"])
    if "spatial_e48" in tasks:
        out["spatial_e48"] = rank_spatial_e48(device, inputs["x_e48"])
    if "eval" in tasks:
        out["eval"] = rank_eval(inputs["gopro_dir"], inputs["pth"],
                                inputs["frame"], inputs["result_dir"], world)
    return out


def nccl_world_one(sd, device, card: str) -> dict:
    """NCCL at world size 1 in this process: an all_reduce, and the DDP
    bs32 step in equal bits to the bare step (same weights, batch and
    generator; 40/40/40/40 launches each), then both timed in turns."""
    import torch.distributed as dist

    from uformer_tpu_torch.parallel import make_mesh
    from uformer_tpu_torch.parallel.multihost import init_multihost

    init_multihost("nccl", str(device), store=dist.HashStore(), rank=0,
                   world_size=1, timeout_s=300)
    try:
        t = torch.arange(4.0, device=device)
        dist.all_reduce(t)
        if not torch.equal(t, torch.arange(4.0, device=device)):
            raise RuntimeError(f"NCCL all_reduce at world 1: {t}")
        mesh = make_mesh(1, device=device)
        bare_m = build_model(sd, RES_TRAIN, device)
        ddp_m = build_model(sd, RES_TRAIN, device)
        batch = train_batch(BATCH_TRAIN, PAR_SEED, device)
        torch.backends.cudnn.deterministic = True
        bare = counted_step(bare_m, batch, PAR_SEED + 1, TRAIN_LAUNCHES,
                            "bare step")
        ddp = counted_step(ddp_m, batch, PAR_SEED + 1, TRAIN_LAUNCHES,
                           "DDP step, NCCL world 1", mesh=mesh)
        torch.backends.cudnn.deterministic = False
        differ = [n for n, g in bare["grads"].items()
                  if not torch.equal(g, ddp["grads"][n])]
        if not torch.equal(bare["loss"], ddp["loss"]) \
                or not torch.equal(bare["gen"], ddp["gen"]) or differ \
                or bare["grads"].keys() != ddp["grads"].keys():
            raise RuntimeError(f"DDP at NCCL world 1 against the bare step: "
                               f"loss {float(ddp['loss'])} vs "
                               f"{float(bare['loss'])}; gradients that "
                               f"differ: {differ[:5]}")
        del bare, ddp
        times = {"bare": [], "ddp": []}
        for name in ("bare", "ddp", "ddp", "bare"):
            ms, _, _ = timed_steps(bare_m if name == "bare" else ddp_m,
                                   batch, 5, mesh if name == "ddp" else None)
            times[name] += ms
    finally:
        dist.destroy_process_group()
    out = {k: float(np.median(v)) for k, v in times.items()}
    out["runs_ms"] = times
    print(f"  NCCL world 1: all_reduce; DDP bs{BATCH_TRAIN} "
          f"{RES_TRAIN}^2 bf16 step equal bits to the bare step (loss, "
          f"every gradient, generator; 40/40/40/40 launches each); median "
          f"{out['ddp']:.2f} ms a DDP step against {out['bare']:.2f} bare "
          f"(5 + 5 steps each, in turns)  [{card}]", flush=True)
    return out


@torch.no_grad()
def kernel5_spatial(checks: Checks, model, device, H: int, W: int,
                    world: int, card: str, timed_widths: bool = True) -> dict:
    """Kernel 5 alone at every (stage, rank) shape of model's forward over
    an H x W image split over `world` ranks (each rank's windows at its
    w_off, every shift the stage has, LN1 folded in as the spatial path
    runs it), at each stage's own window (packed tiles below 8,
    `csrc/attention_wide.cu` above), against attention_block_reference,
    fp32 and bf16; then, with timed_widths, timed at rank 0's shapes of
    each width C 32-512 (the encoder and the bottleneck), against its
    plain version and its bound."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.kernels import (attention_block_reference,
                                               fused_attention_block)
    from uformer_tpu_torch.parallel.spatial import stage_at

    gen = torch.Generator(device="cpu").manual_seed(PAR_SEED)
    timed = {}
    K.reset_counts()
    wide_calls = {torch.float32: 0, torch.bfloat16: 0}
    for k in range(9):
        layer = stage_at(model, k)
        lvl = k if k < 5 else 8 - k
        Hk, Wk = H >> lvl, W >> lvl
        win = layer.blocks[0].win_size
        split = Hk % world == 0 and (Hk // world) % win == 0
        per = (Hk // world if split else Hk) // win * (Wk // win)
        for blk in {b.shift_size: b for b in layer.blocks}.values():
            for r in (range(world) if split else (0,)):
                w_off = r * per if split else 0
                x32 = torch.randn((per, win * win, blk.dim),
                                  generator=gen).to(device)
                outs = {}
                for dt in (torch.float32, torch.bfloat16):
                    p = blk.kernel_params(dt)
                    kw = dict(win=win, shift=blk.shift_size, H=Hk, W=Wk,
                              scale=blk.attn.scale, num_heads=blk.num_heads,
                              has_ln=True, w_off=w_off)
                    args = (x32.to(dt), p["mod"], p["ln1_s"], p["ln1_b"],
                            p["wq"], p["bq"], p["wkv"], p["bkv"], p["wo"],
                            p["bo"], p["bias"])
                    wide_calls[dt] += win > 8
                    outs[dt] = (
                        fused_attention_block(*args, **kw).float(),
                        attention_block_reference(*args, **kw).float(),
                        lambda args=args, kw=kw:
                        fused_attention_block(*args, **kw),
                        lambda args=args, kw=kw:
                        attention_block_reference(*args, **kw))
                what = (f"spatial {world} ranks {layer_name(k)} C{blk.dim} "
                        f"win {win} shift {blk.shift_size} w_off {w_off}")
                ref = outs[torch.float32][1]
                checks.add("attention_block", what,
                           max_err(outs[torch.float32][0], ref),
                           1e-4 * (1.0 + float(ref.abs().max())), "fp32")
                checks.add("attention_block", what,
                           max_err(outs[torch.bfloat16][0], ref),
                           1.5 * max_err(outs[torch.bfloat16][1], ref)
                           + 1e-3, "bf16")
                if timed_widths and k <= 4 and r == 0 and (
                        blk.dim not in timed or blk.shift_size):
                    timed[blk.dim] = (per, blk, outs)
    # every bf16 call above window 8 on the tensor-core core, every fp32
    # one on the CUDA-core core; the forward ran kernel 6's core nowhere
    wide_bwd_bodies(f"kernel 5 on the spatial path, {world} ranks", 0, 0)
    ran = K.core_counts()["attention_block"]
    if (ran["core_mma_launches"], ran["core_fma_launches"]) != (
            wide_calls[torch.bfloat16], wide_calls[torch.float32]):
        raise RuntimeError(f"kernel 5 on the spatial path, {world} ranks: "
                           f"wide core bodies {ran} for "
                           f"{wide_calls[torch.bfloat16]} bf16 and "
                           f"{wide_calls[torch.float32]} fp32 calls")
    rows = []
    for C, (per, blk, outs) in sorted(timed.items()):
        row = {"C": C, "windows": per, "heads": blk.num_heads,
               "shift": blk.shift_size}
        for dt, s, peak in ((torch.bfloat16, 2, PEAK_BF16),
                            (torch.float32, 4, PEAK_FP32)):
            _, _, kern, plain = outs[dt]
            t = {}
            tally(t, "attention_block", cuda_ms(kern), cuda_ms(plain),
                  attn_cost(per * 64, C, blk.num_heads, s,
                            mod=blk.modulator is not None),
                  peak=peak)
            row[str(dt)] = dict(t["attention_block"],
                                bound_by=bound_by(t["attention_block"]))
        rows.append(row)
        b = row[str(torch.bfloat16)]
        f = row[str(torch.float32)]
        print(f"  kernel 5 on the spatial path, C {C:3d} ({per} windows "
              f"a rank, {blk.num_heads} heads): bf16 {b['ms']:.3f} ms "
              f"(plain {b['plain_ms']:.3f}, bound {b['bound_ms']:.4f} "
              f"{b['bound_by']}); fp32 {f['ms']:.3f} (plain "
              f"{f['plain_ms']:.3f}, bound {f['bound_ms']:.4f})  "
              f"[{card}]", flush=True)
    return {"rows": rows, "core_bodies": ran}


def spatial_window_checks(checks: Checks, two: list, x_win: dict,
                          device, card: str) -> dict:
    """The spatial path at windows 2, 4, 16 and 32 (SPATIAL_WIN): kernel 5
    at every (stage, rank) shape on SPATIAL_WIN_WORLDS ranks
    (`kernel5_spatial`), then the 2 ranks' sharded forwards of
    x_win[win] (`rank_spatial_win`) against
    the unsharded kernel path (fp32 within 1e-4 (1 + max|ref|), and
    whether the bits are equal) and the fp32 plain path (bf16 by the
    serve rule), SPATIAL_WIN_LAUNCHES a rank, no plain call."""
    from uformer_tpu_torch.restore import Restorer

    out = {}
    for win, (opt, seed) in SPATIAL_WIN.items():
        model = build_arch(opt, seeded_for(opt, seed), device)
        n = len(checks.rows)
        side = SPATIAL_WIN_SIDE[win]
        for world in SPATIAL_WIN_WORLDS[win]:
            out[f"kernel5_win{win}_{world}ranks"] = kernel5_spatial(
                checks, model, device, side, side, world, card,
                timed_widths=False)["core_bodies"]
        worst = max(r["err"] / r["bound"] for r in checks.rows[n:])
        print(f"  kernel 5 at window {win} on the spatial path: "
              f"{len(checks.rows) - n} (stage, rank, dtype) checks on "
              f"{SPATIAL_WIN_WORLDS[win]} ranks at {side}^2, worst "
              f"err/bound {worst:.3f}", flush=True)
        out[f"kernel5_win{win}_worst"] = worst
        if win not in SPATIAL_WIN_FORWARD:
            continue
        xt = torch.from_numpy(x_win[win]).to(device)
        with torch.no_grad():
            ref = {dt: {"kernel": Restorer(model, dt, device).model(xt)
                        .float().cpu().numpy(),
                        "plain": Restorer(model, dt, device).model(
                            xt, plain=True).float().cpu().numpy()}
                   for dt in (torch.float32, torch.bfloat16)}
        ref32 = ref[torch.float32]["plain"]
        for dt in (torch.bfloat16, torch.float32):
            rows = [res["spatial_win"][(win, str(dt))] for res in two]
            for r, row in enumerate(rows):
                expect_counts(f"spatial win {win} 2 ranks {dt} rank {r}",
                              row["counts"], row["plain"],
                              SPATIAL_WIN_LAUNCHES)
            if rows[0]["crc"] != rows[1]["crc"]:
                raise RuntimeError(f"spatial win {win} {dt}: the ranks' "
                                   f"results differ")
            y, kern = rows[0]["y"], ref[dt]["kernel"]
            what = (f"spatial win {win} 2 ranks {side}^2 bs1 against "
                    f"unsharded")
            equal = bool(np.array_equal(y, kern))
            if dt == torch.float32:
                checks.add("model", f"{what} kernel path",
                           float(np.abs(y - kern).max()),
                           1e-4 * (1.0 + float(np.abs(kern).max())), "fp32")
                checks.add("model", f"{what} plain path",
                           float(np.abs(y - ref32).max()),
                           1e-4 * (1.0 + float(np.abs(ref32).max())), "fp32")
            else:
                e_plain = float(np.abs(ref[dt]["plain"] - ref32).max())
                checks.add("model", f"{what} plain path",
                           float(np.abs(y - ref32).max()),
                           1.5 * e_plain + 1e-3, "bf16")
            diff = float(np.abs(y - kern).max())
            out[f"forward_win{win}_{dt}"] = {
                "equal_bits_vs_unsharded_kernels": equal,
                "max_diff_vs_unsharded_kernels": diff,
                "launches": rows[0]["counts"]}
            print(f"  spatial win {win} 2 ranks {dt}: 18 kernel-5 and 18 "
                  f"kernel-2 launches a rank, no plain call; against the "
                  f"unsharded kernel path: equal bits {equal}, max diff "
                  f"{diff:.3e}  [{card}]", flush=True)
        del model
        torch.cuda.empty_cache()
    return out


def spatial_e48_check(checks: Checks, two: list, x: np.ndarray, device,
                      card: str) -> dict:
    """The 2 ranks' fp32 sharded forward of x at --embed_dim 48
    (`rank_spatial_e48`) against the unsharded kernel path within 1e-4
    (1 + max|ref|), SPATIAL_WIN_LAUNCHES a rank, no plain call, equal
    results on both ranks."""
    from uformer_tpu_torch.restore import Restorer

    opt, seed = SPATIAL_E48
    model = build_arch(opt, seeded_for(opt, seed), device)
    with torch.no_grad():
        ref = Restorer(model, torch.float32, device).model(
            torch.from_numpy(x).to(device)).float().cpu().numpy()
    rows = [res["spatial_e48"] for res in two]
    for r, row in enumerate(rows):
        expect_counts(f"spatial e48 2 ranks fp32 rank {r}", row["counts"],
                      row["plain"], SPATIAL_WIN_LAUNCHES)
    if rows[0]["crc"] != rows[1]["crc"]:
        raise RuntimeError("spatial e48 fp32: the ranks' results differ")
    y = rows[0]["y"]
    diff = float(np.abs(y - ref).max())
    checks.add("model", f"spatial e48 2 ranks {x.shape[1]}^2 bs1 fp32 "
               f"against unsharded kernel path", diff,
               1e-4 * (1.0 + float(np.abs(ref).max())), "fp32")
    print(f"  spatial e48 2 ranks fp32: 18 kernel-5 and 18 kernel-2 "
          f"launches a rank, no plain call; against the unsharded kernel "
          f"path max diff {diff:.3e}  [{card}]", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"max_diff_vs_unsharded_kernels": diff,
            "launches": rows[0]["counts"]}


def layer_name(k: int) -> str:
    return (f"enc{k}" if k < 4 else "conv" if k == 4 else f"dec{k - 5}")


def run_group(cmd: list, timeout_s: float) -> tuple:
    """cmd in a session of its own, killed with every process it started
    where it passes timeout_s: (return code, stdout + stderr)."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"{cmd[:8]} passed {timeout_s} s:\n{out[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    return proc.returncode, out


def train_cli_two_ranks(tmp: Path, card: str) -> dict:
    """`torchrun --nproc_per_node 2 -m uformer_tpu_torch.train.cli
    --mesh_data 2` on the card (gloo, both ranks on cuda:0): one epoch of
    the denoise recipe (2 steps of 32 at 128^2): exit 0, the weights'
    crc32 equal on both ranks (the trainer's check at the end of fit),
    one log and rank 0's .pth files."""
    n_train, n_val, side = PAR_CLI_SET
    train = write_pairs(tmp / "train", n_train, side, PAR_SEED)
    val = write_pairs(tmp / "val", n_val, side, PAR_SEED + 1)
    save = tmp / "logs"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "uformer_tpu_torch.train.cli",
           "--mesh_data", "2", "--device", "cuda:0", "--dist_backend",
           "gloo", "--arch", "Uformer_B", "--batch_size", str(BATCH_TRAIN),
           "--train_ps", str(RES_TRAIN), "--mode", "denoising", "--warmup",
           "--warmup_epochs", "1", "--nepoch", "1", "--pretrain_weights", "",
           "--train_dir", str(train), "--val_dir", str(val), "--save_dir",
           str(save)]
    t0 = time.perf_counter()
    rc, out = run_group(cmd, 400)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"train CLI on 2 ranks: exit {rc}\n{out[-4000:]}")
    log_dir = save / "denoising" / "Uformer_B_"
    logs = sorted(log_dir.glob("*.txt"))
    models = sorted(p.name for p in (log_dir / "models").iterdir())
    text = logs[0].read_text() if len(logs) == 1 else ""
    m = re.search(r"weights crc32 (\w+), equal on 2 ranks", text)
    if len(logs) != 1 or not m or text.count("Epoch: 1\t") != 1 \
            or models != ["model_best.pth", "model_latest.pth"]:
        raise RuntimeError(f"train CLI on 2 ranks: logs {logs}, models "
                           f"{models}, crc line {bool(m)}\n{out[-4000:]}")
    print(f"  train CLI under torchrun, --mesh_data 2 (gloo, cuda:0): 1 "
          f"epoch of {n_train // BATCH_TRAIN} steps of {BATCH_TRAIN} at "
          f"{RES_TRAIN}^2, weights crc32 {m[1]} on both ranks, one log and "
          f"rank 0's {models}; {secs:.1f} s with start-up  [{card}]",
          flush=True)
    return {"s": secs, "crc32": m[1], "models": models}


def parallel_phase(tmp: Path, sd, device, card: str) -> tuple:
    """Phase 17. Returns the checks, the summary and the launches of the
    spatial path and the DDP step on rank 0."""
    import cv2

    from uformer_tpu_torch.parallel.multihost import spawn_ranks
    from uformer_tpu_torch.restore import Restorer

    mode = compute_mode()
    if "Exclusive_Process" in mode:
        raise RuntimeError(f"compute mode {mode}: two processes cannot "
                           f"share the card, and the phase needs them")
    gc.collect()
    torch.cuda.empty_cache()
    checks, summary = Checks(), {"compute_mode": mode}
    summary["nccl_world1"] = nccl_world_one(sd, device, card)

    # inputs: the GoPro frame (also as a PNG pair for the harness), a
    # reference-format .pth of serve B's weights for the eval CLI
    frame = np.random.default_rng(8).uniform(0, 1, GOPRO_HW + (3,)) \
        .astype(np.float32)
    gopro_dir = tmp / "gopro"
    for sub in ("groundtruth", "input"):
        (gopro_dir / sub).mkdir(parents=True)
        cv2.imwrite(str(gopro_dir / sub / "frame.png"),
                    np.uint8(np.round(frame * 255)))
    frame = np.round(frame * 255) / np.float32(255)  # the PNG's levels
    pth, _ = write_eval_inputs(tmp / "pth", sd)
    x4 = np.random.default_rng(PAR_SEED).uniform(
        0, 1, (PAR_SPATIAL4[0], PAR_SPATIAL4[1], PAR_SPATIAL4[1], 3)) \
        .astype(np.float32)
    # one image per forward window, at its side (windows 4 and 16 share
    # theirs)
    x_win = {win: np.random.default_rng(PAR_SEED + 2 + (side > RES_SERVE))
             .uniform(0, 1, (1, side, side, 3)).astype(np.float32)
             for win, side in SPATIAL_WIN_SIDE.items()
             if win in SPATIAL_WIN_FORWARD}
    x_e48 = np.random.default_rng(PAR_SEED + 4).uniform(
        0, 1, (1, RES_SERVE, RES_SERVE, 3)).astype(np.float32)
    inputs = {"spatial": frame[None], "gopro_dir": gopro_dir, "pth": pth,
              "frame": frame, "result_dir": tmp / "gopro_out",
              "dtypes": (torch.bfloat16, torch.float32), "x_win": x_win,
              "x_e48": x_e48}
    # the 2 ranks, the 4 ranks and the train CLI's 2 ranks under torchrun
    # run side by side (each group its own processes and store or port):
    # the ranks' times below share the card with the other groups
    pool = concurrent.futures.ThreadPoolExecutor(2)
    cli = pool.submit(train_cli_two_ranks, tmp / "cli", card)
    t0 = time.perf_counter()
    four = pool.submit(spawn_ranks, par_rank, 4, ("spatial",),
                       {"spatial": x4, "dtypes": (torch.float32,)},
                       backend="gloo", device="cuda:0",
                       timeout_s=PAR_TIMEOUT_S, num_threads=None)
    two = spawn_ranks(par_rank, 2, ("step", "spatial", "eval",
                                    "spatial_win", "spatial_e48"), inputs,
                      backend="gloo", device="cuda:0",
                      timeout_s=PAR_TIMEOUT_S, num_threads=None)
    four = four.result()
    summary["ranks_s"] = time.perf_counter() - t0

    # the 2-rank DDP step against the one-process bs32 step
    batch = train_batch(BATCH_TRAIN, PAR_SEED, device)
    model = build_model(sd, RES_TRAIN, device)
    torch.backends.cudnn.deterministic = True
    one = {}
    for plain, dt in ((True, torch.float32), (True, torch.bfloat16)):
        loss, _, _ = run_step(model, plain, dt, batch, PAR_SEED + 1,
                              lambda s: 0.0)
        one[dt] = {"loss": loss.reshape(1).float().cpu()}
        one[dt].update({n: p.grad.float().cpu()
                        for n, p in model.named_parameters()
                        if p.grad is not None})
    one_k = counted_step(model, batch, PAR_SEED + 1, TRAIN_LAUNCHES,
                         "one-process step")
    torch.backends.cudnn.deterministic = False
    del model
    steps = [r["step"] for r in two]
    for r, st in enumerate(steps):
        expect_counts(f"rank {r} DDP step", st["counts"], {},
                      TRAIN_LAUNCHES)
        if not np.array_equal(st["gen"], one_k["gen"].numpy()):
            raise RuntimeError(f"rank {r}: the generator's state after the "
                               f"DDP step differs from the one-process "
                               f"step's")
    if steps[0]["grads_crc"] != steps[1]["grads_crc"]:
        raise RuntimeError("the 2 ranks' averaged gradients differ")
    got = {"loss": torch.tensor([np.mean([st["loss"] for st in steps])])}
    got.update({n: torch.from_numpy(g)
                for n, g in steps[0]["grads"].items()})
    ref, low = one[torch.float32], one[torch.bfloat16]
    for n, r_ in ref.items():
        scale = float(r_.abs().max())
        checks.add("model", f"DDP 2 ranks bs{BATCH_TRAIN} {n}",
                   max_err(got[n], r_),
                   1.5 * max_err(low[n], r_) + 1e-3 * max(1.0, scale),
                   "bf16")
    summary["ddp2"] = {"ms_per_rank": [float(np.median(st["ms"]))
                                       for st in steps],
                       "max_diff_vs_one_process_kernels": max(
                           max_err(got[n], one_k["grads"][n].float().cpu())
                           for n in one_k["grads"]),
                       "runs_ms": [st["ms"] for st in steps],
                       "peak_bytes": [st["peak_bytes"] for st in steps]}
    del one, got, ref, low, one_k
    print(f"  DDP 2 ranks on cuda:0 (gloo): bs{BATCH_TRAIN} global, "
          f"{BATCH_TRAIN // 2} a rank, 40/40/40/40 launches a rank, "
          f"generator equal bits to the one-process step's, gradients "
          f"equal on both ranks; median "
          f"{summary['ddp2']['ms_per_rank']} ms a step per rank (the ranks "
          f"time-slice one card with the other groups: not a scaling "
          f"figure)  [{card}]",
          flush=True)

    # the spatial forward against the unsharded model on the padded frame
    model = build_model(sd, RES_SERVE, device)
    Hp = -(-GOPRO_HW[0] // 128) * 128
    xp = torch.from_numpy(np.pad(frame[None], (
        (0, 0), (0, Hp - GOPRO_HW[0]), (0, 0), (0, 0)))).to(device)
    x4d = torch.from_numpy(x4).to(device)
    refs = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            r = Restorer(model, dt, device)
            refs[dt] = {
                "plain": r.model(xp, plain=True)[:, :GOPRO_HW[0]]
                .float().cpu().numpy(),
                "kernel": r.model(xp)[:, :GOPRO_HW[0]].float().cpu().numpy()}
            if dt == torch.float32:
                refs["x4"] = r.model(x4d, plain=True).float().cpu().numpy()
    spatial = {}
    for world, results, label, expected in (
            (2, two, f"{GOPRO_HW[1]}x{GOPRO_HW[0]} bs1", SPATIAL_LAUNCHES),
            (4, four, f"{PAR_SPATIAL4[1]}^2 bs{PAR_SPATIAL4[0]}",
             SPATIAL4_LAUNCHES)):
        for dt in ((torch.bfloat16, torch.float32) if world == 2
                   else (torch.float32,)):
            rows = [res["spatial"][str(dt)] for res in results]
            for r, row in enumerate(rows):
                expect_counts(f"spatial {world} ranks {dt} rank {r}",
                              row["counts"], row["plain"], expected)
            if len({row["crc"] for row in rows}) != 1:
                raise RuntimeError(f"spatial {world} ranks {dt}: the ranks' "
                                   f"results differ")
            y = rows[0]["y"]
            ref32 = refs["x4"] if world == 4 else refs[torch.float32]["plain"]
            what = f"spatial {world} ranks {label} against unsharded"
            if dt == torch.float32:
                checks.add("model", what, float(np.abs(y - ref32).max()),
                           1e-4 * (1.0 + float(np.abs(ref32).max())), "fp32")
            else:
                e_plain = float(np.abs(refs[torch.bfloat16]["plain"]
                                       - ref32).max())
                checks.add("model", what, float(np.abs(y - ref32).max()),
                           1.5 * e_plain + 1e-3, "bf16")
            vs_kernel = (float(np.abs(y - refs[dt]["kernel"]).max())
                         if world == 2 else None)
            spatial[f"{world} ranks {dt}"] = {
                "ms_per_rank": [row["ms"] for row in rows],
                "exchange_ms_per_rank": [row["exchange_ms"] for row in rows],
                "exchange_share": [row["exchange_ms"] / row["ms"]
                                   for row in rows],
                "exchange_calls": rows[0]["exchange_calls"],
                "exchange_mib": [row["exchange_mib"] for row in rows],
                "max_diff_vs_unsharded_kernels": vs_kernel,
                "launches": rows[0]["counts"]}
            sp = spatial[f"{world} ranks {dt}"]
            print(f"  spatial {world} ranks {label} {dt}: "
                  f"{[round(v, 2) for v in sp['ms_per_rank']]} ms a forward "
                  f"per rank (groups side by side), exchanges "
                  f"{[round(v, 2) for v in sp['exchange_ms_per_rank']]} ms "
                  f"({[round(100 * v, 1) for v in sp['exchange_share']]}%; "
                  f"{sp['exchange_calls']:.0f} calls, "
                  f"{sp['exchange_mib'][0]:.1f} MiB sent by rank 0, through "
                  f"host memory); launches a rank "
                  f"{rows[0]['counts']['attention_block']} kernel 5, "
                  f"{rows[0]['counts']['leff']} kernel 2, no plain call; "
                  f"unsharded kernel path within {vs_kernel}  [{card}]",
                  flush=True)
    summary["spatial"] = spatial
    summary["kernel5"] = kernel5_spatial(checks, model, device, Hp,
                                         GOPRO_HW[1], 2, card)
    summary["kernel5_4ranks"] = kernel5_spatial(
        checks, model, device, PAR_SPATIAL4[1], PAR_SPATIAL4[1], 4, card)
    del model, refs
    torch.cuda.empty_cache()
    summary["spatial_windows"] = spatial_window_checks(
        checks, two, x_win, device, card)
    summary["spatial_e48"] = spatial_e48_check(checks, two, x_e48, device,
                                               card)

    # the eval CLI's sharded tiles against the one-process tiled output
    rs = eval_restorers(pth, device)
    ref = {dt: gopro_run(model_numpy(rs[dt], True, []), frame, "tiled")[0]
           for dt in (torch.float32, torch.bfloat16)}
    one_tiled = {dt: gopro_run(rs[dt].numpy, frame, "tiled")[0]
                 for dt in (torch.float32, torch.bfloat16)}
    del rs
    evals = [res["eval"] for res in two]
    got = {}
    for name in ("bfloat16", "float32"):
        dt = getattr(torch, name)
        for r, ev in enumerate(evals):
            calls = -(-12 // EVAL_TILE["tile_batch"])  # 24 tiles, 12 a rank
            expect_counts(f"eval CLI --mesh_data 2 {name} rank {r}",
                          ev[name]["counts"], ev[name]["plain"],
                          {k: calls * v for k, v in
                           EXPECTED_LAUNCHES.items()})
        if evals[0][name]["crc"] != evals[1][name]["crc"]:
            raise RuntimeError(f"eval CLI --mesh_data 2 {name}: the ranks' "
                               f"blends differ")
        got[dt] = evals[0][name]["y"]
    eval_compare(checks, "eval CLI --mesh_data 2 --tile 256 frame", got,
                 ref[torch.float32], ref[torch.bfloat16])
    if evals[0]["gopro"] != evals[1]["gopro"]:
        raise RuntimeError(f"GoPro harness on 2 ranks: {evals[0]['gopro']} "
                           f"vs {evals[1]['gopro']}")
    written = sorted(p.name for p in (tmp / "gopro_out").iterdir())
    if written != ["frame.png", "psnr_ssim.txt"]:
        raise RuntimeError(f"GoPro harness on 2 ranks wrote {written}")
    summary["eval_cli"] = {
        name: {"ms_per_rank": [ev[name]["ms"] for ev in evals],
               "max_diff_vs_one_process_kernels": float(np.abs(
                   got[getattr(torch, name)]
                   - one_tiled[getattr(torch, name)]).max())}
        for name in ("bfloat16", "float32")}
    summary["eval_cli"]["gopro"] = evals[0]["gopro"]
    diffs = [summary["eval_cli"][n]["max_diff_vs_one_process_kernels"]
             for n in ("bfloat16", "float32")]
    print(f"  eval CLI --mesh_data 2 --tile 256 on the frame: 12 tiles a "
          f"rank, the blend equal on both ranks; against the one-process "
          f"tiled kernel path within {diffs[0]:.2e} (bf16), {diffs[1]:.2e} "
          f"(fp32); GoPro harness PSNR/SSIM {evals[0]['gopro']} on both, "
          f"rank 0 wrote {written}  [{card}]", flush=True)

    summary["train_cli"] = cli.result()
    pool.shutdown()
    launches = {"spatial": two[0]["spatial"][str(torch.bfloat16)]["counts"],
                "ddp": steps[0]["counts"]}
    return checks, summary, launches


# phase 18, geometries: windows 1-8 and head dim 8 through the forward
# kernels. Models: label -> (get_arch options, weight seed, launches a
# forward by JAX's route, layers.py:773-775 and 979-985)
GEOM_MODELS = {
    "ps64": ({"arch": "Uformer_B", "train_ps": 64}, 1240,
             dict(NO_LAUNCHES, stage=5, attention_image=4,
                  attention_block=2, leff=6)),
    "ps32": ({"arch": "Uformer_B", "train_ps": 32}, 1241,
             dict(NO_LAUNCHES, stage=3, attention_image=4,
                  attention_block=18, leff=22)),
    "e8": ({"arch": "Uformer", "embed_dim": 8, "train_ps": 128}, 1242,
           dict(NO_LAUNCHES, stage=2, attention_image=8,
                attention_block=6, leff=14)),
    "win4": ({"arch": "Uformer", "embed_dim": 32, "win_size": 4,
              "train_ps": 128}, 1243,
             dict(NO_LAUNCHES, attention_block=18, leff=18)),
}
BATCH_WIN4 = 2
FLAGSHIP_LAUNCHES = dict(NO_LAUNCHES, stage=1, attention_image=8,
                         attention_block=8, leff=16)
# kernel 5 at the new shapes, (win, shift, w_off, C, heads, has_ln): head
# dim 8 at C 8 and 16 on every window 1-7 (packed tiles) and at window 8;
# head dim 16 and 32 at C 32-512 on 4- and 16-token windows; head dim 8 at
# C 128 (an embed-8 model's bottleneck below window 8)
GEOM_BLOCK_SHAPES = (
    [(w, s, o, C, nH, ln) for w in (1, 2, 3, 4, 6, 7)
     for s, o, ln in ((0, 0, False), (w // 2, 37, True))
     for C, nH in ((8, 1), (16, 2))]
    + [(w, s, o, C, nH, ln) for w in (2, 4)
       for s, o, ln in ((0, 0, True), (w // 2, 37, False))
       for C, nH in ((128, 8), (256, 8), (512, 16), (128, 16))]
    + [(4, 2, 37, 32, 1, True), (4, 0, 0, 64, 2, False),
       (8, 0, 0, 8, 1, False), (8, 4, 37, 16, 2, True)])
# kernel 4: (win, head dim, heads), each at shift 0 and win // 2
GEOM_CORE_SHAPES = [(w, D, nH) for w in (1, 2, 3, 4, 6, 7, 8)
                    for D, nH in ((8, 2), (16, 1), (32, 2))]
# kernel 4 alone at the cores of phase 18's cells, bs8 256^2: (heads,
# windows, win, head dim, res, shift): ps64's bottleneck, ps32's enc3 and
# bottleneck, e8's enc0 (shifted), win4's enc0 (shifted)
GEOM_CORE_TIMING = [(16, 128, 4, 32, 16, 0), (8, 512, 4, 32, 32, 0),
                    (16, 512, 2, 32, 16, 0), (1, 8192, 8, 8, 256, 4),
                    (1, 32768, 4, 32, 256, 2)]
# the stages of each model whose calls phase 18 times (bs8 256^2 bf16)
GEOM_TIMED = {"ps64": ["conv"],
              "ps32": ["encoderlayer_3", "conv", "decoderlayer_0"],
              "e8": ["encoderlayer_0", "encoderlayer_2", "encoderlayer_3",
                     "conv", "decoderlayer_0"]}


def seeded_for(opt: dict, seed: int):
    """Weights drawn with numpy from `seed` over the parameter names of
    get_arch(opt), by the golden weights' rule."""
    from uformer_tpu_torch import get_arch

    with without_init():
        model = get_arch(opt)
    keys_shapes = [[k, list(v.shape)] for k, v in model.named_parameters()]
    return golden_module().seeded_state_dict(keys_shapes, seed)


def build_arch(opt: dict, sd, device):
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.convert import load_numpy_state_dict

    with without_init():
        model = get_arch(opt)
    return load_numpy_state_dict(model, sd).to(device).eval()


def _prm(inp: dict, device, low: tuple) -> dict:
    """numpy operands -> {dtype: tensors}: the keys in `low` in that
    dtype, the rest float32, as the kernels take them."""
    return {dt: {k: None if v is None else torch.from_numpy(v).to(
        device, dt if k in low else torch.float32) for k, v in inp.items()}
        for dt in (torch.float32, torch.bfloat16)}


class GoldenDraws:
    """Operands drawn in order from one numpy generator by the golden
    weights' rule (`tests/golden/generate.py:_seeded_value`, as every
    seeded model here draws them): matrices N(0, 1 / fan-in), LayerNorm
    scales 1 + N(0, 0.05²), biases N(0, 0.02²); inputs N(0, 1) on the
    card, rounded to bf16-representable fp32 (`xin`). `skip` passes over
    a draw that is not kept: by drawing it, or with `jumps` (the states
    `log` took in a replay of the same draws) by setting the generator's
    state. With `feed`, each draw is taken from that queue, where a replay
    of the same draws on another thread (`feed_draws`) put it ahead;
    with `sink`, each draw is also put there."""

    def __init__(self, seed: int, device, jumps: dict = None,
                 log: dict = None, feed: queue.Queue = None,
                 sink: queue.Queue = None):
        self.rng, self.device = np.random.default_rng(seed), device
        self.jumps, self.log, self.draws = jumps, log, 0
        self.feed, self.sink = feed, sink

    def normal(self, shape):
        self.draws += 1
        if self.feed is None:
            a = self.rng.standard_normal(shape)
            if self.sink is not None:
                self.sink.put(a, timeout=FEED_TIMEOUT_S)
            return a
        a = self.feed.get(timeout=FEED_TIMEOUT_S)
        if isinstance(a, BaseException):
            raise RuntimeError(f"draw {self.draws}: the replay failed") \
                from a
        if a.shape != np.shape(np.broadcast_to(0.0, shape)):
            raise RuntimeError(f"draw {self.draws}: the replay drew "
                               f"{a.shape}, not {shape}")
        return a

    def skip(self, *shape):
        if self.jumps is None:
            self.normal(shape)
        else:
            self.draws += 1
            self.rng.bit_generator.state = self.jumps[self.draws]
        if self.log is not None:
            self.log[self.draws] = self.rng.bit_generator.state

    def mat(self, *shape, fan_in):
        return (self.normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def scale(self, n):
        return (1.0 + 0.05 * self.normal(n)).astype(np.float32)

    def bias(self, n):
        return (0.02 * self.normal(n)).astype(np.float32)

    def xin(self, *shape):
        return torch.from_numpy(self.mat(*shape, fan_in=1)).to(
            self.device).bfloat16().float()

    def attn_prm(self, C, nH, N, with_mod):
        """An attention sub-block's operands as the model holds them: the
        modulator (N, C), the bias table gathered to (nH, N, N), Linear
        weights (out, in) taken as (in, out); `_prm`'s dict."""
        mat, scale, bias = self.mat, self.scale, self.bias
        return _prm(dict(mod=mat(N, C, fan_in=C) if with_mod else None,
                         ln_s=scale(C), ln_b=bias(C),
                         wq=mat(C, C, fan_in=C), bq=bias(C),
                         wkv=mat(C, 2 * C, fan_in=C), bkv=bias(2 * C),
                         wo=mat(C, C, fan_in=C), bo=bias(C),
                         bias=mat(nH, N, N, fan_in=nH)), self.device,
                    ("mod", "wq", "wkv", "wo"))


def geometry_kernel_checks(checks: Checks, device) -> None:
    """Each extended kernel against its plain version at every new shape,
    fp32 (TF32 off) and bf16, by `compare`."""
    from uformer_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(18)

    def mk(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def xin(*shape, scale=0.3):
        return torch.from_numpy(mk(*shape, scale=scale)).to(
            device).bfloat16().float()

    for win, shift, w_off, C, nH, has_ln in GEOM_BLOCK_SHAPES:
        N, H, W = win * win, 4 * win, 4 * win
        Bw = 2 * (H // win) * (W // win) + 3
        prm = _prm(dict(mod=mk(N, C), ln_s=1.0 + mk(C), ln_b=mk(C),
                        wq=mk(C, C), bq=mk(C), wkv=mk(C, 2 * C),
                        bkv=mk(2 * C), wo=mk(C, C), bo=mk(C),
                        bias=mk(nH, N, N)), device,
                   ("mod", "wq", "wkv", "wo"))
        kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
                  num_heads=nH, has_ln=has_ln, w_off=w_off)
        compare(checks, "attention_block",
                f"win {win} shift {shift} off {w_off} C {C} D {C // nH} "
                f"ln {int(has_ln)}",
                lambda x, dt: K.fused_attention_block(
                    x, *prm[dt].values(), **kw),
                lambda x, dt: K.attention_block_reference(
                    x, *prm[dt].values(), **kw), xin(Bw, N, C))
    for win, D, nH in GEOM_CORE_SHAPES:
        N, H, W = win * win, 2 * win, 4 * win
        Bw = 5 * (H // win) * (W // win)
        k, v = xin(nH, Bw, N, D, scale=0.5), xin(nH, Bw, N, D, scale=0.5)
        bias = torch.from_numpy(mk(nH, N, N)).to(device)
        for shift in sorted({0, win // 2}):
            kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)
            compare(checks, "window_attention",
                    f"win {win} shift {shift} D {D} heads {nH}",
                    lambda q, dt: K.fused_window_attention(
                        q.to(dt), k.to(dt), v.to(dt), bias, **kw),
                    lambda q, dt: K.window_attention_reference(
                        q.to(dt), k.to(dt), v.to(dt), bias, **kw),
                    xin(nH, Bw, N, D, scale=0.5))
    for C in (32, 64):
        nH = C // 8
        prm = _prm(dict(mod=mk(64, C), ln_s=1.0 + mk(C), ln_b=mk(C),
                        wq=mk(C, C), bq=mk(C), wkv=mk(C, 2 * C),
                        bkv=mk(2 * C), wo=mk(C, C), bo=mk(C),
                        bias=mk(nH, 64, 64)), device,
                   ("mod", "wq", "wkv", "wo"))
        for shift, residual in itertools.product((0, 4), (True, False)):
            kw = dict(win=8, shift=shift, scale=8 ** -0.5, num_heads=nH,
                      residual=residual)
            compare(checks, "attention_image",
                    f"D 8 C {C} shift {shift} res {int(residual)}",
                    lambda x, dt: K.fused_attention_image(
                        x, *prm[dt].values(), **kw),
                    lambda x, dt: K.attention_image_reference(
                        x, *prm[dt].values(), **kw), xin(2, 32, 32, C))
    n, C, nH = 2, 128, 16
    sp = dict(ln1_s=1.0 + mk(n, C, scale=0.1), ln1_b=mk(n, C, scale=0.1),
              wq=mk(n, C, C, scale=0.1), bq=mk(n, C, scale=0.1),
              wk=mk(n, C, C, scale=0.1), bk=mk(n, C, scale=0.1),
              wv=mk(n, C, C, scale=0.1), bv=mk(n, C, scale=0.1),
              wo=mk(n, C, C, scale=0.1), bo=mk(n, C, scale=0.1),
              bias=mk(n, nH, 64, 64, scale=0.1), mod=mk(n, 64, C, scale=0.1),
              ln2_s=1.0 + mk(n, C, scale=0.1), ln2_b=mk(n, C, scale=0.1),
              w1=mk(n, C, 4 * C, scale=0.1), b1=mk(n, 4 * C, scale=0.1),
              wd=mk(n, 3, 3, 4 * C, scale=0.1), bd=mk(n, 4 * C, scale=0.1),
              w2=mk(n, 4 * C, C, scale=0.1), b2=mk(n, C, scale=0.1))
    sprm = _prm(sp, device, ("wq", "wk", "wv", "wo", "mod", "w1", "wd",
                             "w2"))
    for res in (8, 16):
        kw = dict(scale=8 ** -0.5, num_heads=nH, use_shift=res > 8,
                  has_mod=True)
        compare(checks, "stage", f"D 8 C 128 {res}^2",
                lambda x, dt: K.fused_stage(x, sprm[dt], **kw),
                lambda x, dt: K.stage_reference(x, sprm[dt], **kw),
                xin(2, res, res, C))
    C = 8
    lprm = _prm(dict(w1=mk(C, 4 * C), b1=mk(4 * C), wd=mk(3, 3, 4 * C),
                     bd=mk(4 * C), w2=mk(4 * C, C), b2=mk(C),
                     ln_s=1.0 + mk(C), ln_b=mk(C)), device,
                ("w1", "wd", "w2"))
    for side, has_ln, residual in itertools.product(
            (8, 64), (True, False), (True, False)):
        def run(fn, has_ln=has_ln, residual=residual):
            def call(x, dt):
                p = lprm[dt]
                ln = dict(ln_s=p["ln_s"], ln_b=p["ln_b"]) if has_ln else {}
                return fn(x, *(p[k] for k in ("w1", "b1", "wd", "bd", "w2",
                                              "b2")), **ln,
                          residual=residual)
            return call
        compare(checks, "leff", f"C 8 {side}^2 ln {int(has_ln)} res "
                f"{int(residual)}", run(K.fused_leff), run(K.leff_reference),
                xin(2, side, side, C))


def flagship_phase(device) -> tuple:
    """tests/golden/uformer_flagship.npz (embed 8, 64^2, heads 1-8: head
    dim 8 in the encoder, the bottleneck at window 4) in fp32 through the
    kernels, stage by stage against the recorded torch activations within
    tests/test_golden_parity.py's 1e-4; FLAGSHIP_LAUNCHES and no plain
    call. Returns the checks and the launches."""
    from uformer_tpu_torch.convert import load_numpy_state_dict
    from uformer_tpu_torch.models import Uformer
    from uformer_tpu_torch.ops import kernels as K

    kw = {k: v for k, v in golden_module().FLAGSHIP.items()
          if k != "token_mlp"}
    kw = dict(kw, depths=tuple(kw["depths"]), num_heads=tuple(kw["num_heads"]))
    data = np.load(REPO / "tests" / "golden" / "uformer_flagship.npz")
    sd = {k[len("sd/"):]: data[k] for k in data.files if k.startswith("sd/")}
    model = load_numpy_state_dict(Uformer(**kw), sd).to(device).eval()
    acts = {}
    hooks = [getattr(model, s).register_forward_hook(
        lambda _m, _i, out, s=s: acts.__setitem__(s, out.float().cpu()))
        for s in STAGES]
    x = torch.from_numpy(data["input"].transpose(0, 2, 3, 1).copy())
    K.reset_counts()
    with torch.no_grad():
        y = model(x.to(device)).cpu()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    launched = K.launch_counts()
    print(f"  flagship launches {launched}", flush=True)
    if launched != FLAGSHIP_LAUNCHES or any(K.plain_counts().values()):
        raise RuntimeError(f"flagship: launches {launched}, plain calls "
                           f"{K.plain_counts()}; expected "
                           f"{FLAGSHIP_LAUNCHES} and none")
    checks = Checks()
    for s in STAGES:
        want = to_nhwc(data[f"act/{s}"].astype(np.float32))
        checks.add("model", f"flagship {s}",
                   float(np.abs(acts[s].numpy() - want).max()), 1e-4, "fp32")
    checks.add("model", "flagship output", float(np.abs(
        y.numpy() - data["output"].transpose(0, 2, 3, 1)).max()), 1e-4,
        "fp32")
    return checks, launched


def geometry_eval(tmp: Path, sd, device, checks: Checks) -> dict:
    """The SIDD CLI at --train_ps 64 (Uformer_B's bottleneck at window 4)
    in bf16 from a reference-format .pth of seeded weights at that
    geometry: its launches (ps64's per request, no plain call) and
    Idenoised.mat against the plain path by the serve rule."""
    import scipy.io as sio

    from uformer_tpu_torch.eval import cli
    from uformer_tpu_torch.eval.sidd import load_sidd_val_noisy, restore_sidd
    from uformer_tpu_torch.ops import kernels as K

    n_img, n_blk, side = SIDD_SET
    requests = n_img * -(-n_blk // SIDD_BATCH)
    pth, sidd = write_eval_inputs(tmp, sd, "uformer_b_ps64_seeded")
    K.reset_counts()
    t0 = time.perf_counter()
    score = cli.main(["sidd", "--input_dir", str(sidd), "--result_dir",
                      str(tmp / "out"), "--weights", str(pth), "--dtype",
                      "bfloat16", "--device", "cuda", "--train_ps", "64"])
    secs = time.perf_counter() - t0
    want = {k: requests * v for k, v in GEOM_MODELS["ps64"][2].items()}
    got = K.launch_counts()
    if got != want or any(K.plain_counts().values()):
        raise RuntimeError(f"SIDD CLI --train_ps 64: launches {got}, plain "
                           f"calls {K.plain_counts()}; expected {want}")
    out = sio.loadmat(tmp / "out" / "Idenoised.mat")["Idenoised"]
    noisy = load_sidd_val_noisy(str(sidd))
    rs = eval_restorers(pth, device, train_ps=64)
    ref = {dt: restore_sidd(model_numpy(rs[dt], True, []), noisy,
                            SIDD_BATCH) for dt in rs}
    eval_compare(checks, f"SIDD CLI --train_ps 64 {n_img}x{n_blk} {side}^2",
                 {torch.bfloat16: out}, ref[torch.float32],
                 ref[torch.bfloat16])
    print(f"  SIDD CLI --train_ps 64 bf16: {requests} requests, PSNR "
          f"{score[0]:.4f}, {secs:.2f} s with load and scoring; launches "
          f"{requests} x 5/4/2/6, no plain call", flush=True)
    return {"psnr": score[0], "ssim": score[1], "s": secs,
            "launches": got}


def geometry_phase(tmp: Path, sd_golden, device, card: str) -> tuple:
    """Phase 18: the extended kernels at every new shape, the flagship
    golden through the kernels, bf16 serving of Uformer_B at train_ps 64
    and 32 and of Uformer at embed 8 (then at win_size 4, batch 2), the
    SIDD CLI at --train_ps 64, the new calls timed against their plain
    versions and bounds, serve B's forward at train_ps 64 against 128 in
    turns, and embed 8 at window 2 (forward and train step through the
    kernels; an embed-24 step refused). Returns the checks, the summary
    and the launches per path."""
    from uformer_tpu_torch.ops import kernels as K

    checks, summary, launches = Checks(), {"card": card}, {}
    t0 = time.perf_counter()
    geometry_kernel_checks(checks, device)
    summary["kernel_checks_s"] = time.perf_counter() - t0
    fchecks, launches["flagship"] = flagship_phase(device)
    checks.rows += fchecks.rows
    checks.failed += fchecks.failed
    sds = {}
    for label in ("ps64", "ps32", "e8", "win4"):
        opt, seed, expected = GEOM_MODELS[label]
        sds[label] = sd = seeded_for(opt, seed)
        batch = BATCH_WIN4 if label == "win4" else BATCH_SERVE
        restorer, x, serve, _, schecks = serve_phase(
            lambda opt=opt, sd=sd: build_arch(opt, sd, device), device,
            expected, f"serve {label}", batch=batch)
        if any(K.plain_counts().values()):
            raise RuntimeError(f"serve {label}: plain calls "
                               f"{K.plain_counts()}")
        checks.rows += schecks.rows
        checks.failed += schecks.failed
        launches[label] = serve["launches_per_request"][0]
        summary[f"serve_{label}"] = serve
        if label in GEOM_TIMED:
            rows, totals, _ = timing_phase(restorer, x,
                                           layers=GEOM_TIMED[label],
                                           forward=False)
            summary[f"timing_{label}"] = rows
            summary[f"timing_totals_{label}"] = totals
        if label == "ps64":
            # serve B's forward at train_ps 64 against 128, in turns
            from uformer_tpu_torch.restore import Restorer

            r128 = Restorer(build_model(sd_golden, 128, device),
                            torch.bfloat16, device)
            with torch.no_grad():
                runs = {"128": [], "64": []}
                for which in ("128", "64", "64", "128"):
                    m = r128.model if which == "128" else restorer.model
                    runs[which].append(cuda_ms(lambda m=m: m(x), reps=5))
            summary["forward_ps64_vs_ps128_ms"] = runs
            print(f"  serve B forward bs8 256^2 bf16: train_ps 128 "
                  f"{np.mean(runs['128']):.3f} ms, train_ps 64 "
                  f"{np.mean(runs['64']):.3f} ms (in turns 128, 64, 64, "
                  f"128: {runs})  [{card}]", flush=True)
            del r128
        del restorer, x
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cpu").manual_seed(19)
    cores = []
    with torch.no_grad():
        for nH, Bw, win, D, res, shift in GEOM_CORE_TIMING:
            q, k, v = (torch.randn((nH, Bw, win * win, D), generator=gen)
                       .to(device, torch.bfloat16) for _ in range(3))
            bias = (0.5 * torch.randn((nH, win * win, win * win),
                                      generator=gen)).to(device)
            cores.append(time_core(q, k, v, bias, win=win, shift=shift,
                                   res=res))
    summary["core_timing"] = cores
    summary["eval_ps64"] = geometry_eval(tmp, sds["ps64"], device, checks)
    launches["eval_ps64"] = summary["eval_ps64"]["launches"]
    launches["refusal"], launches["refusal_step"] = refusal_checks(device)
    summary["launches"] = launches
    return checks, summary, launches


# phase 19, train geometries: the backward at windows 1-8 and head dim 8.
# Whole steps: label -> (get_arch options, weight seed, batch, side,
# launches a step by JAX's route, layers.py:773-775: forward and backward
# per kernel); each model's weights drawn from its seed.
TRAIN_GEOM = {
    "ps64": ({"arch": "Uformer_B", "train_ps": 64}, 1244, 32, 64,
             dict(NO_LAUNCHES, attention_image=38, attention_bwd=38,
                  attention_block=2, attention_block_bwd=2, leff=40,
                  leff_bwd=40)),
    "e8": ({"arch": "Uformer", "embed_dim": 8, "train_ps": 128}, 1245, 32,
           128, dict(NO_LAUNCHES, attention_image=12, attention_bwd=12,
                     attention_block=6, attention_block_bwd=6, leff=18,
                     leff_bwd=18)),
    "win4": ({"arch": "Uformer", "embed_dim": 32, "win_size": 4,
              "train_ps": 128}, 1246, 8, 128,
             dict(NO_LAUNCHES, attention_block=18, attention_block_bwd=18,
                  leff=18, leff_bwd=18)),
}
# The cells whose whole step's bf16 rows are held, not gated, with the
# same loss: the Charbonnier gradient at the output (eps 1e-3) changes sign
# wherever |output - target| is under the bf16 output's rounding error
# (0.64-0.68% of ps64's pixels on its seed-1244 weights), on other pixels
# in each bf16 path, so each path's gradients carry a different 16% (rms)
# error from the loss alone. On ps64 that error alone takes enc0's
# gradients past the bound on 3 of 4 batches (PERF.md §6). Their bf16 rows
# are printed and kept in the report; the gate is the step whose bf16
# paths both backpropagate the fp32 step's gradient at the output
# (`whole_step_checks(fp32_cotangent=True)`), and the fp32 rows.
HELD_OWN_LOSS = ("ps64",)
# the train CLI at the flagship golden's geometry (embed 8, 64^2: its
# bottleneck packs 16-token windows at head dim 8, C 128): train pairs,
# val pairs, batch, epochs; launches a step
GEOM_CLI_SET = (64, 4, 8, 2)
GEOM_CLI_LAUNCHES = dict(NO_LAUNCHES, attention_image=10, attention_bwd=10,
                         attention_block=8, attention_block_bwd=8, leff=18,
                         leff_bwd=18)
# kernel 6 in its windowed layout at the new shapes: (win, shift, C,
# heads, has_ln, with_mod, windows) at a training batch's token count
# (GEOM_TOKENS, a bs2 128^2 stage's, each draw; the windows 3 more than a
# whole number of
# them: a partial last tile wherever 64 // N > 1, tiles with pad rows at
# N 9, 25, 36, 49); head dim 8 at C 8 and 16 on every window 1-7 and at
# window 8; head dim 32 on 16-token windows at C 32-512 (win_size 4);
# ps64's bottleneck at bs32 as it runs (32 windows at C 512, its heads
# split over blocks); head dim 8 at C 32-128 on 16-token windows (the
# flagship's bottleneck)
GEOM_TOKENS = 1 << 15
# independent input draws a coverage shape's bf16 gradients are pooled
# over before their max errors are taken: a C = 8 bias or LayerNorm
# gradient has 8 entries, and the ratio of its max error to the plain
# path's is heavy-tailed at head dim 16 and 32 too (PERF.md §6); fp32 is
# checked per draw
GEOM_DRAWS = 4
# the longest a draw waits for its replay on another thread, and the
# replay for room in the queue (`GoldenDraws`' feed and sink)
FEED_TIMEOUT_S = 300
GEOM_BWD_SHAPES = (
    [(w, s, C, nH, ln, mod, None) for w in (1, 2, 3, 4, 5, 6, 7)
     for s in sorted({0, w // 2})
     for (C, nH), ln, mod in (((8, 1), s == 0, True),
                              ((16, 2), s != 0, s == 0))]
    + [(8, s, C, nH, True, True, None) for s in (0, 4)
       for C, nH in ((8, 1), (16, 2))]
    + [(4, s, C, C // 32, False, True, None) for s in (0, 2)
       for C in (32, 64, 128, 256, 512)]
    + [(4, 0, 512, 16, False, True, 32), (4, 2, 512, 16, True, False, 32)]
    + [(4, s, C, C // 8, False, True, None) for s in (0, 2)
       for C in (32, 64, 128)])
# kernel 6 in the image layout and kernel 1 at head dim 8: (C, shift,
# residual) on a 2 x 128 x 128 image
GEOM_IMAGE_BWD_SHAPES = [(C, s, r) for C in (32, 64, 128) for s in (0, 4)
                         for r in (True, False)]
# kernel 7 at C = 8: images (B, H, W), the second no multiple of a tile
GEOM_LEFF_BWD_SHAPES = [(2, 128, 128), (2, 100, 164)]


def attn_bwd_cost(tokens, C, N, s=2):
    """(operations, bytes) of kernel 6 as JAX's CostEstimate states it
    (`attention_block.py:979-983`): 6 tokens C (4C + 2N) operations, x,
    g and dx of tokens x C values."""
    return 6 * tokens * C * (4 * C + 2 * N), 3 * tokens * C * s


def geometry_bwd_checks(checks: Checks, device, seed: int = 19,
                        select=None, draw: GoldenDraws = None) -> None:
    """Each extended backward kernel (and kernel 1's wide body at head dim
    8) against its plain version at every new shape, fp32 (TF32 off) and
    bf16: `grad_bound` per gradient (fp32 per draw, bf16 on each
    gradient of GEOM_DRAWS draws taken as one tensor), `compare` for the
    forward. Operands by the golden weights' rule (`tests/golden/generate.py:_seeded_value`,
    as every seeded model here draws them: matrices N(0, 1 / fan-in),
    LayerNorm scales 1 + N(0, 0.05²), biases N(0, 0.02²)), x and g N(0, 1),
    as `train_kernel_checks` draws them; all drawn from `seed`. With
    `select`, only the cases (kernel, C, has_ln) it keeps are run, every
    case's operands still drawn in order, so a case sees the operands of
    the full run at that seed (`draw`, if given, draws them)."""
    from uformer_tpu_torch.ops import kernels as K

    draw = draw or GoldenDraws(seed, device)
    mat, scale, bias, xin, attn_prm = (draw.mat, draw.scale, draw.bias,
                                       draw.xin, draw.attn_prm)

    def bwd_check(kernel, what, fused, plain, shape, C, has_ln):
        names = LEFF_GRADS if kernel == "leff_bwd" else ATTN_GRADS
        keep = select is None or select(kernel, C, has_ln)
        runs = []
        for _ in range(GEOM_DRAWS):
            if not keep:  # the draws in order, without the card
                draw.skip(*shape), draw.skip(*shape)
                continue
            x, g = xin(*shape), xin(*shape)
            runs.append([dict(zip(names, f(*a))) for f, a in (
                (fused, (x, g, torch.float32)),
                (plain, (x, g, torch.float32)),
                (plain, (x.bfloat16(), g.bfloat16(), torch.bfloat16)),
                (fused, (x.bfloat16(), g.bfloat16(), torch.bfloat16)))])
        if keep:
            pooled_grad_bound(checks, kernel, what, runs)

    for win, shift, C, nH, has_ln, with_mod, Bw in GEOM_BWD_SHAPES:
        N, H, W = win * win, 16 * win, 16 * win
        Bw = Bw or GEOM_TOKENS // N + 3
        prm = attn_prm(C, nH, N, with_mod)
        kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
                  num_heads=nH, has_ln=has_ln)
        bwd_check("attention_block_bwd",
                  f"win {win} shift {shift} C {C} D {C // nH} Bw {Bw} "
                  f"ln {int(has_ln)} mod {int(with_mod)}",
                  lambda x, g, dt, p=prm, kw=kw: K.fused_attention_block_bwd(
                      x, g, *p[dt].values(), **kw),
                  lambda x, g, dt, p=prm, kw=kw:
                  K.attention_block_vjp_reference(x, g, *p[dt].values(),
                                                  **kw), (Bw, N, C), C,
                  has_ln)
    for C, shift, residual in GEOM_IMAGE_BWD_SHAPES:
        nH = C // 8
        prm = attn_prm(C, nH, 64, True)
        kw = dict(win=8, shift=shift, scale=8 ** -0.5, num_heads=nH,
                  residual=residual)
        what = f"D 8 C {C} shift {shift} res {int(residual)}"
        bwd_check("attention_bwd", what,
                  lambda x, g, dt, p=prm, kw=kw: K.fused_attention_image_bwd(
                      x, g, *p[dt].values(), **kw),
                  lambda x, g, dt, p=prm, kw=kw:
                  K.attention_image_vjp_reference(x, g, *p[dt].values(),
                                                  **kw), (2, 128, 128, C), C,
                  True)
        if C == 128:  # kernel 1's wide body at head dim 8
            if select is None:
                x1 = xin(4, 32, 32, C)
                compare(checks, "attention_image", f"wide {what}",
                        lambda x, dt, p=prm, kw=kw: K.fused_attention_image(
                            x, *p[dt].values(), **kw),
                        lambda x, dt, p=prm, kw=kw:
                        K.attention_image_reference(x, *p[dt].values(),
                                                    **kw), x1)
            else:
                draw.skip(4, 32, 32, C)
    C = 8
    lp = _prm(dict(w1=mat(C, 4 * C, fan_in=C), b1=bias(4 * C),
                   wd=mat(3, 3, 4 * C, fan_in=9), bd=bias(4 * C),
                   w2=mat(4 * C, C, fan_in=4 * C), ln_s=scale(C),
                   ln_b=bias(C)), device, ("w1", "wd", "w2"))
    for (B, H, W), has_ln, residual in itertools.product(
            GEOM_LEFF_BWD_SHAPES, (True, False), (True, False)):
        def run(fn, has_ln=has_ln, residual=residual):
            def call(x, g, dt):
                p = lp[dt]
                ln = (p["ln_s"], p["ln_b"]) if has_ln else (None, None)
                return fn(x, g, *(p[k] for k in ("w1", "b1", "wd", "bd",
                                                  "w2")), *ln,
                          has_ln=has_ln, residual=residual)
            return call
        bwd_check("leff_bwd", f"C 8 {B}x{H}x{W} ln {int(has_ln)} res "
                  f"{int(residual)}", run(K.fused_leff_bwd),
                  run(K.leff_vjp_reference), (B, H, W, C), C, has_ln)


def geometry_step_timing(model, batch, expected: dict, label: str) -> dict:
    """bf16 train steps of `model` on `batch`: ms a step (CUDA events) in
    the order plain, kernel x3, plain, `expected` launches on each kernel
    path step, its loss finite; the kernel path steps' peak memory."""
    from uformer_tpu_torch.ops import kernels as K

    out = {"kernel_ms": [], "plain_ms": [], "loss": [], "peak_mib": 0.0}
    wide = wide_bwd_calls(model) if expected.get("attention_block_bwd") \
        else 0
    for plain in (True, False, False, False, True):
        _, state, step = run_step(model, plain, torch.bfloat16, batch, 50,
                                  lambda s: 0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        K.reset_counts()
        start.record()
        loss = step(state, batch, torch.Generator(device="cpu")
                    .manual_seed(51))
        end.record()
        torch.cuda.synchronize()
        out["plain_ms" if plain else "kernel_ms"].append(
            start.elapsed_time(end))
        if not plain:
            out["peak_mib"] = max(out["peak_mib"],
                                  torch.cuda.max_memory_allocated() / 2**20)
            out["loss"].append(float(loss))
            if K.launch_counts() != expected or \
                    not np.isfinite(float(loss)):
                raise RuntimeError(f"{label}: step launched "
                                   f"{K.launch_counts()}, loss "
                                   f"{float(loss)}")
            out["wide_bwd_bodies"] = wide_bwd_bodies(label, wide, 0)
    out["kernel_ms_median"] = float(np.median(out["kernel_ms"]))
    out["plain_ms_median"] = float(np.median(out["plain_ms"]))
    return out


def geometry_kernel_timing(model, batch: int, label: str) -> tuple:
    """Device time of each backward kernel call of one bf16 step of
    `model` (and kernel 1's forward at head dims 8 and 24-56) against its
    plain VJP
    and its bound, one block per (stage, shift) counted once per block of
    the stage with that shift; kernel 6's parts (body, wgrad beside
    torch.matmul, colsum) where its windows are below 8. Kernel 6's bound
    is `attn_bwd_cost`'s, kernel 7's `bwd_cost` of LeFF's."""
    gen = torch.Generator(device="cpu").manual_seed(20)
    rows, totals = [], {}
    with torch.no_grad():
        for name, blk, shift, residual in train_configs(model):
            layer = getattr(model, name)
            n = sum(b.shift_size == shift for b in layer.blocks)
            if n == 0:
                continue
            res, C, N = layer.resolution, layer.dim, blk.win_size ** 2
            shape, tokens = (batch, res, res, C), batch * res * res
            head8 = C // blk.num_heads == 8
            # kernel 1's forward timed where its training path is new:
            # head dim 8 at C >= 128, and head dims 24-56
            new_fwd = (head8 and C >= 128) or \
                C // blk.num_heads in HEADS_NEW
            calls, parts = block_calls(layer, blk, residual,
                                       (torch.bfloat16,))
            costs = {"attention_bwd": attn_bwd_cost(tokens, C, N),
                     "attention_block_bwd": attn_bwd_cost(tokens, C, N),
                     "leff_bwd": bwd_cost(leff_cost(tokens, C, 4 * C),
                                          tokens, C),
                     "attention_image": attn_cost(tokens, C, blk.num_heads)}
            x = torch.randn(shape, generator=gen).to(
                next(model.parameters()).device, torch.bfloat16)
            g = torch.randn(shape, generator=gen).to(x.device, x.dtype)
            for kernel, (fused, plain) in calls.items():
                if kernel == "attention_image" and not new_fwd:
                    continue
                if kernel in ("attention_block", "leff"):
                    continue
                args = (x, g) if kernel.endswith("bwd") else (x,)
                k_fn = (lambda f=fused, a=args: f(*a, torch.bfloat16))
                p_fn = (lambda f=plain, a=args: f(*a, torch.bfloat16))
                reps = dict(reps=1, warmup=1)
                p1, k1, k2, p2 = (cuda_ms(p_fn, **reps), cuda_ms(k_fn, **reps),
                                  cuda_ms(k_fn, **reps), cuda_ms(p_fn, **reps))
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                b_ms = tally(totals, kernel, k_ms, p_ms, costs[kernel], n)
                row = {"model": label, "layer": name, "shift": shift,
                       "blocks": n, "kernel": kernel, "shape": list(shape),
                       "N": N, "heads": blk.num_heads, "ms": k_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms / n}
                if kernel == "attention_block_bwd" and N < 64:
                    row["parts"] = part_times(parts[kernel], x, g, n,
                                              totals, kernel)
                print(f"  {label:5s} {name:16s} s{shift} x{n} {kernel:19s} "
                      f"{str(shape):20s} N {N:2d} kernel {k_ms:8.3f} ms  "
                      f"plain {p_ms:8.3f} ms  bound {b_ms / n:7.4f} ms"
                      + ("  parts: " + ", ".join(
                          f"{k} {v:.3f}" for k, v in row["parts"].items())
                         if "parts" in row else ""), flush=True)
                rows.append(row)
    for kernel, t in totals.items():
        print(f"  {label:5s} {kernel:19s} per step: {t['launches']} "
              f"launches, kernel {t['ms']:8.3f} ms, plain "
              f"{t['plain_ms']:8.3f} ms, bound {t['bound_ms']:7.4f} ms "
              f"({bound_by(t)})", flush=True)
    return rows, totals


def geometry_cli(tmp: Path, device) -> dict:
    """`python -m uformer_tpu_torch.train.cli --arch Uformer --embed_dim 8
    --train_ps 64` in-process on seeded 64^2 PNG pairs (GEOM_CLI_SET), by
    `train_cli_run`."""
    return train_cli_run(tmp, device, "train CLI e8 ps64",
                         ["--arch", "Uformer", "--embed_dim", "8",
                          "--train_ps", "64"], 64, GEOM_CLI_SET,
                         GEOM_CLI_LAUNCHES)


def train_cli_run(tmp: Path, device, label: str, arch_args: list,
                  side: int, cli_set: tuple, expected: dict) -> dict:
    """The train CLI in-process with `arch_args` on seeded side^2 PNG
    pairs (cli_set: train pairs, val pairs, batch, epochs): every step
    launches `expected`, no plain call, a finite loss that falls (the mean
    of the last 4 steps below the first 4's)."""
    from uformer_tpu_torch.ops import kernels as K

    n_train, n_val, bs, epochs = cli_set
    train_dir = write_pairs(tmp / "train", n_train, side, 61)
    val_dir = write_pairs(tmp / "val", n_val, side, 62)
    base = loop_trainer_class()

    class GeomTrainer(base):
        def build(self, steps_per_epoch):
            super().build(steps_per_epoch)
            step, self.losses = self.train_step, []

            def logged(state, batch, gen):
                loss = step(state, batch, gen)
                self.losses.append(float(loss))
                return loss

            self.train_step = logged

    argv = [*arch_args, "--batch_size", str(bs), "--nepoch", str(epochs),
            "--mode", "denoising", "--train_dir", str(train_dir),
            "--val_dir", str(val_dir), "--save_dir", str(tmp / "logs"),
            "--pretrain_weights", "", "--device", str(device)]
    benchmark = torch.backends.cudnn.benchmark
    K.reset_counts()
    t0 = time.perf_counter()
    trainer, state, best = run_train_cli(GeomTrainer, argv)
    secs = time.perf_counter() - t0
    torch.backends.cudnn.benchmark = benchmark
    losses = trainer.losses
    steps = epochs * (n_train // bs)
    for i, s in enumerate(trainer.steps):
        if s["launches"] != expected:
            raise RuntimeError(f"{label}: step {i} launched "
                               f"{s['launches']}, expected {expected}")
    if len(losses) != steps or state.step != steps \
            or any(K.plain_counts().values()) \
            or not np.isfinite(losses).all() \
            or np.mean(losses[-4:]) >= np.mean(losses[:4]):
        raise RuntimeError(f"{label}: {state.step} steps, losses {losses}, "
                           f"plain calls {K.plain_counts()}")
    ms = [s["events"][0].elapsed_time(s["events"][1])
          for s in trainer.steps]
    print(f"  {label} ({' '.join(arch_args)}): {steps} steps of bs{bs}, "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, median "
          f"{float(np.median(ms)):.3f} ms a step, best PSNR {best:.4f}, "
          f"{secs:.2f} s; launches a step {expected}, no plain call",
          flush=True)
    return {"losses": losses, "step_ms": ms, "best_psnr": best, "s": secs,
            "launches": trainer.steps[-1]["launches"]}


def train_cell(checks: Checks, summary: dict, launches: dict, label: str,
               opt: dict, seed: int, bs: int, side: int, expected: dict,
               device, card: str) -> None:
    """One training cell of phases 19 and 22: get_arch(opt) on weights
    seeded from `seed`, its kernels at every training geometry at batch bs
    (`train_kernel_checks`), one whole step of bs at side^2 kernel path
    against plain path, fp32 and bf16 (`expected` launches; HELD_OWN_LOSS:
    bf16 rows held, and the step from the fp32 loss gradient gated), then
    bf16 steps timed and each backward call against its plain VJP and
    bound. Adds to checks, summary (keys named with the label) and
    launches."""
    t1 = time.perf_counter()
    sd = seeded_for(opt, seed)

    def make(opt=opt, sd=sd):
        return build_arch(opt, sd, device)

    torch.backends.cudnn.deterministic = True
    kchecks = train_kernel_checks(make(), device, bs)
    schecks, info = whole_step_checks(
        make, device, bs, f"train {label}", expected, res=side)
    launches[label] = info["launches"]
    summary[f"cotangent_{label}"] = cot = info["cotangent"]
    subs = [kchecks, schecks]
    if label in HELD_OWN_LOSS:
        held = [r for r in schecks.rows if r["dtype"] == "bf16"]
        schecks.rows = [r for r in schecks.rows if r["dtype"] != "bf16"]
        schecks.failed = [f for f in schecks.failed if " bf16 " not in f]
        worst = max(held, key=lambda r: r["err"] / r["bound"])
        over = [r["what"] for r in held if not r["ok"]]
        summary[f"held_{label}"] = {
            "rows": held, "over_bound": over,
            "worst": worst["err"] / worst["bound"],
            "worst_what": worst["what"]}
        print(f"  held, not gated: {label}'s bf16 step with its own "
              f"loss, worst err/bound {worst['err'] / worst['bound']:.3f}"
              f" ({worst['what']}), {len(over)} of {len(held)} "
              f"gradients over their bound; the bf16 "
              f"output gradient's rms error {cot['plain']['rms_rel']:.4f}"
              f" (plain) {cot['kernel']['rms_rel']:.4f} (kernels), "
              f"signs changed at {cot['plain']['sign_changed']:.5f} / "
              f"{cot['kernel']['sign_changed']:.5f} of it, "
              f"{cot['shared_sign_changes']:.3f} of them shared",
              flush=True)
        subs.append(whole_step_checks(
            make, device, bs, f"train {label} fp32 cotangent", expected,
            res=side, fp32_cotangent=True)[0])
    for sub in subs:
        checks.rows += sub.rows
        checks.failed += sub.failed
    torch.backends.cudnn.deterministic = False
    model = make()
    batch = train_batch(bs, 7, device, side)
    steps = geometry_step_timing(model, batch, expected, label)
    rows, totals = geometry_kernel_timing(model, bs, label)
    summary[f"steps_{label}"] = steps
    summary[f"timing_{label}"] = rows
    summary[f"timing_totals_{label}"] = totals
    summary[f"{label}_s"] = time.perf_counter() - t1
    print(f"  {label} bs{bs} {side}^2 bf16 step: kernel path "
          f"{steps['kernel_ms_median']:.3f} ms, plain path "
          f"{steps['plain_ms_median']:.3f} ms, loss "
          f"{steps['loss'][0]:.6f}; {wide_bodies_line(steps)}; "
          f"{time.perf_counter() - t1:.1f} s  [{card}]", flush=True)
    del model, batch
    torch.cuda.empty_cache()


def train_geometry_phase(tmp: Path, device, card: str) -> tuple:
    """Phase 19: the backward kernels at every new shape (windows 1-7 on
    packed tiles, head dim 8 in both layouts, LeFF at C 8; kernel 1's wide
    body at head dim 8); each model's kernels at its every training
    geometry at its training batch (`train_kernel_checks`) and one whole
    step kernel path against plain path, fp32 and bf16, of Uformer_B at
    train_ps 64 (bs32, 64^2), Uformer at embed 8 (bs32, 128^2) and at
    win_size 4 (bs8, 128^2) (HELD_OWN_LOSS: bf16 rows held, and the step
    from the fp32 loss gradient gated), each then timed in bf16 steps and
    per backward call against plain and bound; the train CLI at the
    flagship's geometry. Returns the checks, the summary and the launches
    counted per path (a step each)."""
    checks, summary, launches = Checks(), {"card": card}, {}
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    with concurrent.futures.ThreadPoolExecutor(len(DX_SEEDS)) as pool:
        # the first seed's draws made ahead of their use, and the later
        # seeds' skipped draws replayed, on the host meanwhile
        feed = queue.Queue(maxsize=3)
        pool.submit(feed_draws, DX_SEEDS[0], feed)
        jumps = {seed: pool.submit(skip_states, seed)
                 for seed in DX_SEEDS[1:]}
        geometry_bwd_checks(checks, device, DX_SEEDS[0],
                            draw=GoldenDraws(DX_SEEDS[0], device, feed=feed))
        seeded_bwd_checks(checks, device, DX_SEEDS[1:], c8_ln,
                          {seed: f.result() for seed, f in jumps.items()})
    summary["kernel_checks_s"] = time.perf_counter() - t0
    for label, (opt, seed, bs, side, expected) in TRAIN_GEOM.items():
        train_cell(checks, summary, launches, label, opt, seed, bs, side,
                   expected, device, card)
    summary["cli"] = geometry_cli(tmp, device)
    launches["cli"] = summary["cli"]["launches"]
    return checks, summary, launches


# phase 19 runs these cases (kernels 6 and 7 at C = 8 with LN, whose dx
# flipped about its max gate with the seed until both LN VJPs took the
# fp32 dxm / dLN, as JAX's kernels do: PERF.md §6) at every seed
# here, the other cases at the first
DX_SEEDS = (19, 20, 21, 22)


def c8_ln(kernel: str, C: int, has_ln: bool) -> bool:
    return C == 8 and has_ln and kernel in ("attention_block_bwd",
                                            "leff_bwd")


def feed_draws(seed: int, feed: queue.Queue) -> None:
    """`geometry_bwd_checks`'s draws at `seed`, every one, put on `feed` in
    order by a replay on the host (every case left out, each left-out
    draw still drawn): `GoldenDraws`' feed for the run that keeps them
    all. A failure is put there too."""
    cpu = torch.device("cpu")
    try:
        geometry_bwd_checks(Checks(), cpu, seed, lambda *a: False,
                            GoldenDraws(seed, cpu, sink=feed))
    except BaseException as exc:  # the run that takes the draws raises it
        with contextlib.suppress(queue.Full):
            feed.put_nowait(exc)


def skip_states(seed: int) -> dict:
    """`geometry_bwd_checks`'s draws at `seed` replayed on the host, every
    case left out: the generator's state after each draw a case leaves
    out, by the number of draws up to it (`GoldenDraws`' jumps)."""
    cpu, log = torch.device("cpu"), {}
    geometry_bwd_checks(Checks(), cpu, seed, lambda *a: False,
                        GoldenDraws(seed, cpu, log=log))
    return log


def seeded_bwd_checks(checks: Checks, device, seeds, select=None,
                      jumps: dict = None) -> None:
    """`geometry_bwd_checks` at each seed (its cases in `select` only, if
    given; the draws it leaves out passed over by `jumps[seed]`, from
    `skip_states`, if given), each row named with its seed."""
    for seed in seeds:
        sub = Checks()
        draw = GoldenDraws(seed, device, jumps=jumps[seed]) if jumps \
            else None
        geometry_bwd_checks(sub, device, seed=seed, select=select,
                            draw=draw)
        for r in sub.rows:
            r["what"] = f"seed {seed} {r['what']}"
        checks.rows += sub.rows
        checks.failed += [f"seed {seed} {f}" for f in sub.failed]


# phase 20, windows above 8: kernels 4, 5 and 6 at N = win² 81-256 tokens
WIDE_CHECK_WINDOWS = (9, 12, 16)
# kernels 5 and 6 (C, heads, has_ln, with_mod), each window at shift 0 and
# win // 2: head dim 32 without LN (the win-16 model's blocks), 16 with LN,
# 8 with LN and the modulator; on WIDE_IMAGES images of 4 x 4 windows
WIDE_BLOCK_CASES = ((32, 1, False, True), (32, 2, True, False),
                    (16, 2, True, True))
WIDE_CORE_CASES = ((2, 32), (1, 8))  # kernel 4: (heads, head dim)
# kernel 4 at head dims 24-56 (from its own seed, after the cases above,
# whose draws stay as they were)
WIDE_CORE_HEAD_CASES = ((1, 24), (2, 40), (2, 48), (1, 56))
WIDE_IMAGES = 2
# the path: `--arch Uformer --embed_dim 32 --win_size 16` (depths 2 x 9,
# heads 1-16, head dim 32), seeded weights; served bf16 batch 8 at 256^2
# (built at 256: every block at window 16), trained bf16 batch 8 at
# --train_ps 128 (the 8^2 bottleneck at window 8 on the image route)
WIDE_ARCH = {"arch": "Uformer", "embed_dim": 32, "win_size": 16}
SEED_WIDE = 1247
WIDE_SERVE_LAUNCHES = dict(NO_LAUNCHES, attention_block=18, leff=18)
WIDE_TRAIN_BATCH = 8
WIDE_TRAIN_LAUNCHES = dict(NO_LAUNCHES, attention_block=16,
                           attention_block_bwd=16, attention_image=2,
                           attention_bwd=2, leff=18, leff_bwd=18)
# dropout as JAX routes it in training: drop_rate alone keeps the
# windowed kernels (dropout after their output) and declines the image
# route and the LeFF fold; attn_drop_rate declines the attention kernels
WIDE_DROP_LAUNCHES = {(0.1, 0.0): dict(NO_LAUNCHES, attention_block=18,
                                       attention_block_bwd=18),
                      (0.1, 0.1): dict(NO_LAUNCHES)}
WIDE_CLI_SET = (32, 2, 4, 2)  # train pairs, val pairs, batch, epochs
WIDE_CORE_TIMING = (1, 512, 32)  # kernel 4 alone: (heads, windows, D)
# kernel 4 alone above window 8 on the tensor-core core, bf16, beside SDPA
# and its bound: (heads, windows, win, D, shift, image side, the
# CUDA-core core's eager ms at that shape: PERF.md §6 row 4, NVIDIA H100
# 80GB HBM3 at 700 W; none was timed at N 4096)
WIDE_CORE_ROWS = ((1, 512, 16, 64, 8, 256, 0.693),
                  (1, 128, 32, 32, 16, 256, 1.459),
                  (1, 512, 16, 32, 8, 256, 0.374),
                  (1, 32, 64, 32, 32, 256, None))


def wide_kernel_checks(checks: Checks, device, seed: int = 23) -> dict:
    """Kernels 4, 5 and 6 at windows 9, 12 and 16 (N 81, 144, 256), shift
    0 and win // 2, against their plain versions: fp32 (TF32 off) within
    1e-4 (1 + max|ref|), bf16 under phase 19's gates (`compare`;
    `pooled_grad_bound` over GEOM_DRAWS draws), operands by the golden
    rule from `seed`; each backward run twice on one input, equal bits;
    then kernel 4 at WIDE_CORE_HEAD_CASES from seed + 1. Returns kernels
    4, 5 and 6's core launches by body over the checks (`K.core_counts`),
    kernel 6's held to its calls by dtype (`wide_bwd_bodies`)."""
    from uformer_tpu_torch.ops import kernels as K

    K.reset_counts()
    draw = GoldenDraws(seed, device)
    mat, xin = draw.mat, draw.xin
    bwd_cases = 0

    for win in WIDE_CHECK_WINDOWS:
        N, H = win * win, 4 * win
        Bw = WIDE_IMAGES * 16
        for shift in (0, win // 2):
            for nH, D in WIDE_CORE_CASES:
                k, v = xin(nH, Bw, N, D), xin(nH, Bw, N, D)
                bias = torch.from_numpy(mat(nH, N, N, fan_in=nH)).to(device)
                kw = dict(win=win, shift=shift, H=H, W=H, scale=D ** -0.5)

                def run(fn, kw=kw, k=k, v=v, bias=bias):
                    return lambda x, dt: fn(x, k.to(dt), v.to(dt), bias,
                                            **kw)

                compare(checks, "window_attention",
                        f"win {win} shift {shift} (nH, Bw, N, D)=({nH}, "
                        f"{Bw}, {N}, {D})", run(K.fused_window_attention),
                        run(K.window_attention_reference), xin(nH, Bw, N, D))
            for C, nH, has_ln, with_mod in WIDE_BLOCK_CASES:
                prm = draw.attn_prm(C, nH, N, with_mod)
                kw = dict(win=win, shift=shift, H=H, W=H,
                          scale=(C // nH) ** -0.5, num_heads=nH,
                          has_ln=has_ln)
                what = (f"win {win} shift {shift} C {C} D {C // nH} Bw {Bw} "
                        f"ln {int(has_ln)} mod {int(with_mod)}")
                compare(checks, "attention_block", what,
                        lambda x, dt, p=prm, kw=kw: K.fused_attention_block(
                            x, *p[dt].values(), **kw),
                        lambda x, dt, p=prm, kw=kw:
                        K.attention_block_reference(x, *p[dt].values(),
                                                    **kw), xin(Bw, N, C))
                fused = (lambda x, g, dt, p=prm, kw=kw: dict(zip(
                    ATTN_GRADS, K.fused_attention_block_bwd(
                        x, g, *p[dt].values(), **kw))))
                plain = (lambda x, g, dt, p=prm, kw=kw: dict(zip(
                    ATTN_GRADS, K.attention_block_vjp_reference(
                        x, g, *p[dt].values(), **kw))))
                runs = []
                for _ in range(GEOM_DRAWS):
                    x, g = xin(Bw, N, C), xin(Bw, N, C)
                    runs.append([f(*a) for f, a in (
                        (fused, (x, g, torch.float32)),
                        (plain, (x, g, torch.float32)),
                        (plain, (x.bfloat16(), g.bfloat16(),
                                 torch.bfloat16)),
                        (fused, (x.bfloat16(), g.bfloat16(),
                                 torch.bfloat16)))])
                pooled_grad_bound(checks, "attention_block_bwd", what, runs)
                again = fused(x.bfloat16(), g.bfloat16(), torch.bfloat16)
                differ = sum(a is not None and not torch.equal(a, again[n])
                             for n, a in runs[-1][3].items())
                checks.add("attention_block_bwd", f"{what} repeat",
                           float(differ), 0.0, "bits")
                bwd_cases += 1
    wide_bwd_bodies("phase 20's kernel checks", (GEOM_DRAWS + 1) * bwd_cases,
                    GEOM_DRAWS * bwd_cases)
    draw = GoldenDraws(seed + 1, device)
    for win in WIDE_CHECK_WINDOWS:
        N, H = win * win, 4 * win
        Bw = WIDE_IMAGES * 16
        for shift in (0, win // 2):
            for nH, D in WIDE_CORE_HEAD_CASES:
                k, v = draw.xin(nH, Bw, N, D), draw.xin(nH, Bw, N, D)
                bias = torch.from_numpy(draw.mat(nH, N, N, fan_in=nH)).to(
                    device)
                kw = dict(win=win, shift=shift, H=H, W=H, scale=D ** -0.5)

                def run(fn, kw=kw, k=k, v=v, bias=bias):
                    return lambda x, dt: fn(x, k.to(dt), v.to(dt), bias,
                                            **kw)

                compare(checks, "window_attention",
                        f"win {win} shift {shift} (nH, Bw, N, D)=({nH}, "
                        f"{Bw}, {N}, {D})", run(K.fused_window_attention),
                        run(K.window_attention_reference),
                        draw.xin(nH, Bw, N, D))
    torch.cuda.synchronize()
    return K.core_counts()


def core_bwd_cost(nH, Bw, N, D, s=2):
    """Kernel 6's core alone: JAX's six N x N x D products a (window,
    head) (q k^T, P v, dO v^T, P^T dO, dS k, dS^T q); q, k, v and dO read,
    O, dq, dk and dv written once, the bias table read and dbias written
    (fp32)."""
    return (12 * nH * Bw * N * N * D,
            8 * nH * Bw * N * D * s + 2 * nH * N * N * 4)


SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def time_core_bwd(nH: int, Bw: int, win: int, D: int, shift: int,
                  res: int, device, gen) -> dict:
    """Kernel 6's core alone at (nH, Bw, N = win², D) windows of res x res
    images: the "core" part of `wide_block_bwd_parts` (O, dq | dk | dv and
    dbias from q | k | v and dO, its dS folded by colsum; LN off, no
    modulator), bf16 on the tensor cores and fp32 on the CUDA cores,
    beside torch.autograd's backward of F.scaled_dot_product_attention on
    bf16 q, k, v with the bias and the shift mask as one float mask that
    requires grad (a yardstick the port never calls; the first of
    SDPA_BACKENDS that runs it, named), in the order library, mma, fma,
    fma, mma, library; the bound of `core_bwd_cost`."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from uformer_tpu_torch.ops.kernels.attention_block import \
        attention_block_bwd_parts
    from uformer_tpu_torch.ops.kernels.window_attention import window_mask

    N, C = win * win, nH * D

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen)

    w = {k: rnd(*shape, scale=C ** -0.5) for k, shape in (
        ("wq", (C, C)), ("wkv", (C, 2 * C)), ("wo", (C, C)))}
    bias = rnd(nH, N, N, scale=0.5).to(device)
    x, g = rnd(Bw, N, C), rnd(Bw, N, C)
    kw = dict(win=win, shift=shift, H=res, W=res, scale=D ** -0.5,
              num_heads=nH, has_ln=False)
    core = {}
    for dt in (torch.bfloat16, torch.float32):
        parts, _ = attention_block_bwd_parts(
            x.to(device, dt), g.to(device, dt), None, None, None,
            w["wq"].to(device, dt), torch.zeros(C, device=device),
            w["wkv"].to(device, dt), torch.zeros(2 * C, device=device),
            w["wo"].to(device, dt), torch.zeros(C, device=device), bias,
            **kw)
        parts = dict(parts)
        parts["recompute"]()
        core[dt] = parts["core"]
    q, k, v = (rnd(Bw, nH, N, D).to(device, torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    mask = bias[None].expand(Bw, nH, N, N)
    if shift:
        m = window_mask(res, res, win, shift, Bw, 0, device)
        mask = mask + m.repeat(Bw // m.shape[0], 1, 1)[:, None]
    mask = mask.to(torch.bfloat16).contiguous().requires_grad_(True)
    dout = rnd(Bw, nH, N, D).to(device, torch.bfloat16)
    backend = None
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                y = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   scale=D ** -0.5)
                torch.autograd.grad(y, (q, k, v, mask), dout,
                                    retain_graph=True)
            backend = name
            break
        except RuntimeError:
            continue

    if backend is None:
        raise RuntimeError(f"no SDPA backend ran the backward at "
                           f"{(nH, Bw, N, D)}")

    def library():
        return torch.autograd.grad(y, (q, k, v, mask), dout,
                                   retain_graph=True)

    reps = dict(reps=3, warmup=1)
    l1, m1, f1 = (cuda_ms(library, **reps), cuda_ms(core[torch.bfloat16],
                                                    **reps),
                  cuda_ms(core[torch.float32], **reps))
    f2, m2, l2 = (cuda_ms(core[torch.float32], **reps),
                  cuda_ms(core[torch.bfloat16], **reps),
                  cuda_ms(library, **reps))
    t = {}
    tally(t, "core", (m1 + m2) / 2, (f1 + f2) / 2,
          core_bwd_cost(nH, Bw, N, D))
    out = dict(t["core"], shape=[nH, Bw, N, D], shift=shift,
               fp32_cuda_core_ms=(f1 + f2) / 2, library_ms=(l1 + l2) / 2,
               library_backend=backend, bound_by=bound_by(t["core"]))
    del out["plain_ms"]  # the core alone has no plain version of its own
    del q, k, v, mask, dout, y
    return out


def wide_core_rows(device, card: str) -> list:
    """Kernel 4 at each WIDE_CORE_ROWS shape by `time_core`, printed with
    the CUDA-core core's time at that shape and the ratios to SDPA and to
    the bound; then kernel 6's core alone at the same shape
    (`time_core_bwd`) beside SDPA's backward."""
    from uformer_tpu_torch.ops.kernels.attention_wide import core_windows

    gen = torch.Generator(device="cpu").manual_seed(22)
    rows = []
    for nH, Bw, win, D, shift, res, old_ms in WIDE_CORE_ROWS:
        N = win * win
        q, k, v = (torch.randn((nH, Bw, N, D), generator=gen)
                   .to(device, torch.bfloat16) for _ in range(3))
        bias = (0.5 * torch.randn((nH, N, N), generator=gen)).to(device)
        with torch.no_grad():
            out = time_core(q, k, v, bias, win=win, shift=shift, res=res)
        G = core_windows(Bw, nH, N, D, torch.cuda.get_device_properties(
            device).multi_processor_count)
        tiles = -(-N // 64)
        # bytes the blocks ask of L2, counted from the shapes (not
        # measured): each window's K and V once a query tile, each 64 x
        # 64 fp32 bias block once a block; q and the output once
        l2 = (nH * Bw * tiles * N * D * 2 * 2
              + nH * tiles * -(-Bw // G) * tiles * 64 * 64 * 4
              + 2 * nH * Bw * N * D * 2)
        out.update(windows_a_block=G,
                   vs_library=out["ms"] / out["library_ms"],
                   vs_bound=out["ms"] / out["bound_ms"])
        was = (f"{old_ms:.3f} ms on the CUDA cores in PERF.md"
               if old_ms is not None else "not timed on the CUDA cores")
        print(f"  wide core {tuple(out['shape'])} shift {shift}: "
              f"{out['ms']:.4f} ms ({was}), {out['vs_library']:.2f}x SDPA, "
              f"{out['vs_bound']:.1f}x its bound, G {G}; {l2 / 2**20:.0f} "
              f"MiB asked of L2 by the shapes' count, "
              f"{l2 / out['graph_ms'] / 1e9:.2f} TB/s at the graphed time  "
              f"[{card}]", flush=True)
        bwd = time_core_bwd(nH, Bw, win, D, shift, res, device, gen)
        out["bwd"] = bwd
        print(f"  wide backward core {tuple(bwd['shape'])} shift {shift}: "
              f"tensor cores {bwd['ms']:.4f} ms, CUDA cores (fp32) "
              f"{bwd['fp32_cuda_core_ms']:.4f} ms, SDPA backward "
              f"({bwd['library_backend']}) {bwd['library_ms']:.4f} ms, "
              f"bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}); "
              f"{bwd['ms'] / bwd['library_ms']:.2f}x SDPA, "
              f"{bwd['ms'] / bwd['bound_ms']:.1f}x its bound  [{card}]",
              flush=True)
        rows.append(out)
        del q, k, v
    return rows


def wide_window_phase(tmp: Path, device, card: str) -> tuple:
    """Phase 20: kernels 4, 5 and 6 at windows 9-16 (`wide_kernel_checks`);
    the win-16 Uformer (WIDE_ARCH) served bf16 at batch 8, 256^2 (18
    kernel-5 and 18 LeFF launches a request, no plain attention; against
    the plain path) and timed per kernel; its kernels at every training
    geometry (`train_kernel_checks`, batch 2), one whole step kernel path
    against plain path at --train_ps 128, bf16 steps timed with the
    backward calls, a step with dropout at each WIDE_DROP_LAUNCHES rate
    against the plain path on one generator, then timed as the step
    without dropout (masks drawn on the card), the train CLI at --win_size
    16; kernel 4 alone at N = 256 beside SDPA, then at WIDE_CORE_ROWS
    (`wide_core_rows`). Returns the checks, the summary and the launches
    counted per path."""
    from uformer_tpu_torch.convert import load_numpy_state_dict
    from uformer_tpu_torch.models import Uformer
    from uformer_tpu_torch.models.registry import arch_config

    checks, summary, launches = Checks(), {"card": card}, {}
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    summary["kernel_check_bodies"] = wide_kernel_checks(checks, device)
    summary["kernel_checks_s"] = time.perf_counter() - t0
    # the bias tables follow each stage's window: weights per train_ps
    sds = {ps: seeded_for(dict(WIDE_ARCH, train_ps=ps), SEED_WIDE)
           for ps in (RES_SERVE, RES_TRAIN)}

    def make(ps, **drop):
        model = Uformer(**arch_config(dict(WIDE_ARCH, train_ps=ps)), **drop)
        return load_numpy_state_dict(model, sds[ps]).to(device).eval()

    t1 = time.perf_counter()
    restorer, x, serve, serve_launches, schecks = serve_phase(
        lambda: make(RES_SERVE), device, WIDE_SERVE_LAUNCHES,
        "serve win16")
    launches["serve"] = serve_launches
    rows, totals, fwd = timing_phase(restorer, x)
    summary.update(serve=serve, timing=rows, timing_totals=totals,
                   forward=fwd, serve_s=time.perf_counter() - t1)
    del restorer, x
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    tchecks = train_kernel_checks(make(RES_TRAIN), device, BATCH_CHECK)
    schecks2, info = whole_step_checks(
        lambda: make(RES_TRAIN), device, WIDE_TRAIN_BATCH, "train win16",
        WIDE_TRAIN_LAUNCHES)
    launches["train"] = info["launches"]
    for (drop, attn_drop), expected in WIDE_DROP_LAUNCHES.items():
        dchecks, dinfo = whole_step_checks(
            lambda d=drop, a=attn_drop: make(RES_TRAIN, drop_rate=d,
                                             attn_drop_rate=a),
            device, WIDE_TRAIN_BATCH,
            f"train win16 drop {drop} attn_drop {attn_drop}", expected)
        launches[f"drop_{drop}_{attn_drop}"] = dinfo["launches"]
        schecks2.rows += dchecks.rows
        schecks2.failed += dchecks.failed
    for sub in (schecks, tchecks, schecks2):
        checks.rows += sub.rows
        checks.failed += sub.failed
    torch.backends.cudnn.deterministic = False
    model = make(RES_TRAIN)
    batch = train_batch(WIDE_TRAIN_BATCH, 7, device, RES_TRAIN)
    steps = geometry_step_timing(model, batch, WIDE_TRAIN_LAUNCHES,
                                 "win16")
    trows, ttotals = geometry_kernel_timing(model, WIDE_TRAIN_BATCH, "win16")
    summary.update(steps=steps, train_timing=trows, train_totals=ttotals,
                   train_s=time.perf_counter() - t1)
    print(f"  win16 bs{WIDE_TRAIN_BATCH} {RES_TRAIN}^2 bf16 step: kernel "
          f"path {steps['kernel_ms_median']:.3f} ms, plain path "
          f"{steps['plain_ms_median']:.3f} ms, loss {steps['loss'][0]:.6f}"
          f"; {wide_bodies_line(steps)}  [{card}]", flush=True)
    for (drop, attn_drop), expected in WIDE_DROP_LAUNCHES.items():
        name = f"drop {drop} attn_drop {attn_drop}"
        dsteps = geometry_step_timing(
            make(RES_TRAIN, drop_rate=drop, attn_drop_rate=attn_drop),
            batch, expected, f"win16 {name}")
        summary[f"steps_drop_{drop}_{attn_drop}"] = dsteps
        print(f"  win16 bs{WIDE_TRAIN_BATCH} {RES_TRAIN}^2 bf16 step, {name}"
              f": kernel path {dsteps['kernel_ms_median']:.3f} ms, plain "
              f"path {dsteps['plain_ms_median']:.3f} ms  [{card}]",
              flush=True)
    del model, batch
    torch.cuda.empty_cache()

    summary["cli"] = train_cli_run(
        tmp, device, "train CLI win16",
        ["--arch", "Uformer", "--embed_dim", "32", "--win_size", "16",
         "--train_ps", str(RES_TRAIN)], RES_TRAIN, WIDE_CLI_SET,
        dict(WIDE_TRAIN_LAUNCHES))
    launches["cli"] = summary["cli"]["launches"]

    gen = torch.Generator(device="cpu").manual_seed(9)
    nH, Bw, D = WIDE_CORE_TIMING
    q, k, v = (torch.randn((nH, Bw, 256, D), generator=gen)
               .to(device, torch.bfloat16) for _ in range(3))
    bias = (0.5 * torch.randn((nH, 256, 256), generator=gen)).to(device)
    with torch.no_grad():
        summary["core"] = time_core(q, k, v, bias, win=16, shift=8,
                                    res=16 * int(round((Bw / 2) ** 0.5)))
    del q, k, v
    summary["core_rows"] = wide_core_rows(device, card)
    return checks, summary, launches


# phase 21, head dim 64: `--arch Uformer --embed_dim 64` (every block at
# head dim 64: heads 1-2-4-8-16-16-8-4-2 over C 64-1024, hidden up to
# 4096) through the forward kernels. Cells: label -> (get_arch options,
# weight seed, launches a request by JAX's route, layers.py:757-775 and
# 979-985): the stage kernel at every stage but enc0 (C 64: kernel 1, two
# blocks), and at --train_ps 64 the 4 x 4 bottleneck per block on kernels
# 5 (window 4, C 1024, 16 heads) and 2 (C 1024, hidden 4096)
E64_MODELS = {
    "e64": ({"arch": "Uformer", "embed_dim": 64, "train_ps": 128}, 1248,
            dict(NO_LAUNCHES, stage=8, attention_image=2, leff=2)),
    "e64ps64": ({"arch": "Uformer", "embed_dim": 64, "train_ps": 64}, 1249,
                dict(NO_LAUNCHES, stage=7, attention_image=2,
                     attention_block=2, leff=4)),
}
# kernel 1: (C, heads, image side), batch 2: the narrow body at C 64 (one
# head; enc0's shape), the wide body at C 128-512 and one window a block
# at C 1024 (training's image route reaches these; eval takes the stage)
E64_IMAGE_SHAPES = ((64, 1, 256), (128, 2, 32), (256, 4, 32),
                    (512, 8, 16), (1024, 16, 16))
# kernel 3: (C, heads, side, modulator) of every stage of e64, batch 2
E64_STAGE_SHAPES = ((128, 2, 128, False), (256, 4, 64, False),
                    (512, 8, 32, False), (1024, 16, 16, False),
                    (1024, 16, 32, True), (512, 8, 64, True),
                    (256, 4, 128, True), (128, 2, 256, True))
# kernel 2: (C, side, has_ln, residual), batch 2: enc0's C 64 (the narrow
# tile) and the ps64 bottleneck's C 1024, hidden 4096, each way
E64_LEFF_SHAPES = ([(64, 256, True, True)]
                   + [(1024, 16, ln, res) for ln in (True, False)
                      for res in (True, False)] + [(1024, 12, True, True)])
# kernel 5: (win, shift, w_off, C, heads, has_ln, images of 4 x 4
# windows): e64ps64's bottleneck (window 4, C 1024, batch 2), then head dim
# 64 at C 64 (narrow body) to 1024 on windows 1-8
E64_BLOCK_SHAPES = ((4, 0, 0, 1024, 16, True, 2),
                    (4, 2, 0, 1024, 16, True, 2),
                    (4, 2, 37, 1024, 16, False, 2),
                    (8, 4, 37, 1024, 16, True, 1),
                    (3, 1, 0, 1024, 16, False, 1),
                    (8, 0, 0, 64, 1, True, 2), (8, 4, 37, 64, 1, False, 2),
                    (4, 2, 37, 64, 1, True, 2), (2, 1, 5, 64, 1, True, 2),
                    (1, 0, 0, 128, 2, True, 2), (4, 2, 37, 128, 2, False, 2),
                    (8, 4, 0, 256, 4, True, 2), (6, 3, 37, 512, 8, True, 2),
                    (7, 0, 0, 512, 8, False, 2))
# kernel 4 at head dim 64: (win, heads) at every window 1-8, shift 0 and
# win // 2; timed alone beside SDPA at (heads, windows, win, res, shift):
# e64's enc0 core (one head, 8192 windows of 256^2 bs8, shifted) and
# e64ps64's bottleneck core (16 heads, 128 windows of 4 x 4)
E64_CORE_SHAPES = [(w, nH) for w in range(1, 9) for nH in (1, 2)]
E64_CORE_TIMING = [(1, 8192, 8, 256, 4), (16, 128, 4, 16, 0)]
SIDD_ONE = (1, 1, 256)  # the fp32 eval CLI's one frame


def timed_compare(checks: Checks, kernel: str, what: str, fused, plain,
                  x32, cost, card: str) -> dict:
    """`compare`, then the bf16 kernel and its plain version timed in
    turns on the same input (CUDA events) beside the bound of `cost`;
    prints the errors against their gates and the times."""
    n = len(checks.rows)
    compare(checks, kernel, what, fused, plain, x32)
    x16 = x32.bfloat16()
    # one call a time: both are warm at this shape from `compare`
    p1, k1 = cuda_ms(lambda: plain(x16, torch.bfloat16), reps=1, warmup=0), \
        cuda_ms(lambda: fused(x16, torch.bfloat16), reps=1, warmup=0)
    k2, p2 = cuda_ms(lambda: fused(x16, torch.bfloat16), reps=1, warmup=0), \
        cuda_ms(lambda: plain(x16, torch.bfloat16), reps=1, warmup=0)
    t = {}
    tally(t, kernel, (k1 + k2) / 2, (p1 + p2) / 2, cost)
    row = dict(t[kernel], what=what, bound_by=bound_by(t[kernel]),
               checks=checks.rows[n:])
    f32, b16 = checks.rows[n], checks.rows[n + 1]
    print(f"  {kernel:16s} {what:40s} fp32 {f32['err']:.2e}/"
          f"{f32['bound']:.2e} bf16 {b16['err']:.2e}/{b16['bound']:.2e}; "
          f"bf16 kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})  [{card}]",
          flush=True)
    return row


def head64_kernel_checks(checks: Checks, device, card: str) -> list:
    """Kernels 1-5 at head dim 64 and C up to 1024 against their plain
    versions at every E64_* shape, fp32 (TF32 off) and bf16 by `compare`,
    each timed in bf16 (`timed_compare`). Returns the timed rows."""
    from uformer_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(21)

    def mk(*shape, fan_in=None, scale=0.3):
        a = rng.standard_normal(shape)
        return (a / np.sqrt(fan_in) if fan_in else a * scale).astype(
            np.float32)

    def xin(*shape, scale=1.0):
        return torch.from_numpy(mk(*shape, scale=scale)).to(
            device).bfloat16().float()

    def attn_prm(C, nH, N):
        return _prm(dict(mod=mk(N, C, scale=0.1), ln_s=1.0 + mk(C, scale=0.1),
                         ln_b=mk(C, scale=0.1), wq=mk(C, C, fan_in=C),
                         bq=mk(C, scale=0.02), wkv=mk(C, 2 * C, fan_in=C),
                         bkv=mk(2 * C, scale=0.02), wo=mk(C, C, fan_in=C),
                         bo=mk(C, scale=0.02), bias=mk(nH, N, N, scale=0.5)),
                    device, ("mod", "wq", "wkv", "wo"))

    rows = []
    for C, nH, side in E64_IMAGE_SHAPES:
        prm = attn_prm(C, nH, 64)
        for shift, residual in ((0, True), (4, True), (4, False)):
            kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5,
                      num_heads=nH, residual=residual)
            rows.append(timed_compare(
                checks, "attention_image",
                f"D 64 C {C} 2x{side}^2 shift {shift} res {int(residual)}",
                lambda x, dt, p=prm, kw=kw: K.fused_attention_image(
                    x, *p[dt].values(), **kw),
                lambda x, dt, p=prm, kw=kw: K.attention_image_reference(
                    x, *p[dt].values(), **kw), xin(2, side, side, C),
                attn_cost(2 * side * side, C, nH), card))
    for C, nH, side, has_mod in E64_STAGE_SHAPES:
        n, Ch = 2, 4 * C
        sp = dict(ln1_s=1.0 + mk(n, C, scale=0.1), ln1_b=mk(n, C, scale=0.1),
                  wq=mk(n, C, C, fan_in=C), bq=mk(n, C, scale=0.02),
                  wk=mk(n, C, C, fan_in=C), bk=mk(n, C, scale=0.02),
                  wv=mk(n, C, C, fan_in=C), bv=mk(n, C, scale=0.02),
                  wo=mk(n, C, C, fan_in=C), bo=mk(n, C, scale=0.02),
                  bias=mk(n, nH, 64, 64, scale=0.5),
                  mod=mk(n, 64, C, scale=0.1),
                  ln2_s=1.0 + mk(n, C, scale=0.1),
                  ln2_b=mk(n, C, scale=0.1), w1=mk(n, C, Ch, fan_in=C),
                  b1=mk(n, Ch, scale=0.02), wd=mk(n, 3, 3, Ch, fan_in=9),
                  bd=mk(n, Ch, scale=0.02), w2=mk(n, Ch, C, fan_in=Ch),
                  b2=mk(n, C, scale=0.02))
        sprm = _prm(sp, device, ("wq", "wk", "wv", "wo", "mod", "w1", "wd",
                                 "w2"))
        kw = dict(scale=64 ** -0.5, num_heads=nH, use_shift=True,
                  has_mod=has_mod)
        rows.append(timed_compare(
            checks, "stage", f"D 64 C {C} 2x{side}^2 mod {int(has_mod)}",
            lambda x, dt, p=sprm, kw=kw: K.fused_stage(x, p[dt], **kw),
            lambda x, dt, p=sprm, kw=kw: K.stage_reference(x, p[dt], **kw),
            xin(2, side, side, C),
            stage_cost(2 * side * side, C, nH, Ch, n, mod=has_mod), card))
    for C, side, has_ln, residual in E64_LEFF_SHAPES:
        Ch = 4 * C
        lprm = _prm(dict(w1=mk(C, Ch, fan_in=C), b1=mk(Ch, scale=0.02),
                         wd=mk(3, 3, Ch, fan_in=9), bd=mk(Ch, scale=0.02),
                         w2=mk(Ch, C, fan_in=Ch), b2=mk(C, scale=0.02),
                         ln_s=1.0 + mk(C, scale=0.1), ln_b=mk(C, scale=0.1)),
                    device, ("w1", "wd", "w2"))

        def run(fn, p=lprm, has_ln=has_ln, residual=residual):
            def call(x, dt):
                q = p[dt]
                ln = dict(ln_s=q["ln_s"], ln_b=q["ln_b"]) if has_ln else {}
                return fn(x, *(q[k] for k in ("w1", "b1", "wd", "bd", "w2",
                                              "b2")), **ln,
                          residual=residual)
            return call
        rows.append(timed_compare(
            checks, "leff", f"C {C} Ch {Ch} 2x{side}^2 ln {int(has_ln)} "
            f"res {int(residual)}", run(K.fused_leff), run(K.leff_reference),
            xin(2, side, side, C), leff_cost(2 * side * side, C, Ch), card))
    for win, shift, w_off, C, nH, has_ln, images in E64_BLOCK_SHAPES:
        N, H = win * win, 4 * win
        Bw = images * 16
        prm = attn_prm(C, nH, N)
        kw = dict(win=win, shift=shift, H=H, W=H, scale=(C // nH) ** -0.5,
                  num_heads=nH, has_ln=has_ln, w_off=w_off)
        rows.append(timed_compare(
            checks, "attention_block",
            f"win {win} shift {shift} off {w_off} C {C} Bw {Bw} ln "
            f"{int(has_ln)}",
            lambda x, dt, p=prm, kw=kw: K.fused_attention_block(
                x, *p[dt].values(), **kw),
            lambda x, dt, p=prm, kw=kw: K.attention_block_reference(
                x, *p[dt].values(), **kw), xin(Bw, N, C),
            attn_cost(Bw * N, C, nH, ln=has_ln, N=N), card))
    for win, nH in E64_CORE_SHAPES:
        N, H, W = win * win, 2 * win, 4 * win
        Bw = 5 * (H // win) * (W // win)
        k, v = xin(nH, Bw, N, 64), xin(nH, Bw, N, 64)
        bias = torch.from_numpy(mk(nH, N, N, scale=0.5)).to(device)
        for shift in sorted({0, win // 2}):
            kw = dict(win=win, shift=shift, H=H, W=W, scale=64 ** -0.5)
            compare(checks, "window_attention",
                    f"win {win} shift {shift} D 64 heads {nH}",
                    lambda q, dt, k=k, v=v, bias=bias, kw=kw:
                    K.fused_window_attention(q.to(dt), k.to(dt), v.to(dt),
                                             bias, **kw),
                    lambda q, dt, k=k, v=v, bias=bias, kw=kw:
                    K.window_attention_reference(q.to(dt), k.to(dt),
                                                 v.to(dt), bias, **kw),
                    xin(nH, Bw, N, 64))
    torch.cuda.synchronize()
    return rows


def head64_eval(tmp: Path, sd, device, checks: Checks) -> dict:
    """The SIDD CLI at `--arch Uformer --embed_dim 64` in its default fp32
    (TF32 off) on one 256^2 frame (SIDD_ONE) from a reference-format .pth
    of e64's seeded weights: e64's launches, no plain call, Idenoised.mat
    against the plain path within 1e-4 (1 + max|ref|)."""
    import scipy.io as sio

    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.convert import load_checkpoint
    from uformer_tpu_torch.eval import cli
    from uformer_tpu_torch.eval.sidd import load_sidd_val_noisy, restore_sidd
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.restore import Restorer

    opt, _, expected = E64_MODELS["e64"]
    pth, sidd = write_eval_inputs(tmp, sd, "uformer_e64_seeded", SIDD_ONE)
    K.reset_counts()
    t0 = time.perf_counter()
    score = cli.main(["sidd", "--input_dir", str(sidd), "--result_dir",
                      str(tmp / "out"), "--weights", str(pth), "--device",
                      "cuda", "--arch", "Uformer", "--embed_dim", "64"])
    secs = time.perf_counter() - t0
    got = K.launch_counts()
    if got != expected or any(K.plain_counts().values()):
        raise RuntimeError(f"SIDD CLI --embed_dim 64 fp32: launches {got}, "
                           f"plain calls {K.plain_counts()}; expected "
                           f"{expected}")
    out = sio.loadmat(tmp / "out" / "Idenoised.mat")["Idenoised"]
    restorer = Restorer(load_checkpoint(get_arch(opt), str(pth)),
                        torch.float32, device)
    ref = restore_sidd(model_numpy(restorer, True, []),
                       load_sidd_val_noisy(str(sidd)), 1)
    eval_compare(checks, "SIDD CLI --embed_dim 64 fp32 1x1 256^2",
                 {torch.float32: out}, ref, None)
    print(f"  SIDD CLI --arch Uformer --embed_dim 64, fp32: one 256^2 "
          f"frame, PSNR {score[0]:.4f}, {secs:.2f} s with load and "
          f"scoring; launches {got}, no plain call", flush=True)
    return {"psnr": score[0], "ssim": score[1], "s": secs, "launches": got}


def head64_phase(tmp: Path, device, card: str) -> tuple:
    """Phase 21: kernels 1-5 at head dim 64 and C up to 1024 against their
    plain versions at every new shape, each timed (`head64_kernel_checks`);
    kernel 4 alone beside SDPA (E64_CORE_TIMING); the two serve cells
    (E64_MODELS: 4 bf16 requests of batch 8 at 256^2, their launches, no
    plain call, against the plain path, each kernel's time per stage
    and the forward on both paths); the fp32 eval CLI on one frame.
    Returns the checks, the summary and the launches per path."""
    from uformer_tpu_torch.ops import kernels as K

    checks, summary, launches = Checks(), {"card": card}, {}
    t0 = time.perf_counter()
    summary["kernel_rows"] = head64_kernel_checks(checks, device, card)
    gen = torch.Generator(device="cpu").manual_seed(21)
    cores = []
    with torch.no_grad():
        for nH, Bw, win, res, shift in E64_CORE_TIMING:
            q, k, v = (torch.randn((nH, Bw, win * win, 64), generator=gen)
                       .to(device, torch.bfloat16) for _ in range(3))
            bias = (0.5 * torch.randn((nH, win * win, win * win),
                                      generator=gen)).to(device)
            cores.append(time_core(q, k, v, bias, win=win, shift=shift,
                                   res=res))
    summary["core_timing"] = cores
    summary["kernel_checks_s"] = time.perf_counter() - t0
    sds = {}
    for label, (opt, seed, expected) in E64_MODELS.items():
        sds[label] = sd = seeded_for(opt, seed)
        restorer, x, serve, _, schecks = serve_phase(
            lambda opt=opt, sd=sd: build_arch(opt, sd, device), device,
            expected, f"serve {label}")
        if any(K.plain_counts().values()):
            raise RuntimeError(f"serve {label}: plain calls "
                               f"{K.plain_counts()}")
        checks.rows += schecks.rows
        checks.failed += schecks.failed
        launches[label] = serve["launches_per_request"][0]
        rows, totals, fwd = timing_phase(restorer, x)
        summary.update({f"serve_{label}": serve, f"timing_{label}": rows,
                        f"timing_totals_{label}": totals,
                        f"forward_{label}": fwd})
        print(f"  serve {label} bs{BATCH_SERVE} {RES_SERVE}^2 bf16: "
              f"{serve['median_ms']:.3f} ms a request, "
              f"{serve['mp_per_s']:.2f} MP/s, kernel path "
              f"{fwd['kernel_ms']:.3f} ms against plain path "
              f"{fwd['plain_ms']:.3f} ms a forward, peak "
              f"{serve['max_memory_allocated_bytes'] / 2**20:.1f} MiB  "
              f"[{card}]", flush=True)
        del restorer, x
        torch.cuda.empty_cache()
    summary["eval"] = head64_eval(tmp, sds["e64"], device, checks)
    launches["eval"] = summary["eval"]["launches"]
    return checks, summary, launches


# phase 22, head dim 64's backward: kernel 6 in its three layouts (image,
# 8x8 windows, packed 4x4 windows) at head dim 64 and C 64-1024, kernel 7
# at C 1024 (hidden 4096), and kernels 4, 5 and 6 at windows 9-16 at head
# dim 64. Kernel 6's cases: (layout, C, shift, has_ln, with_mod, residual,
# count): count is (images, side) for the image layout, else windows.
# Windows or tiles no more than half the SMs split their heads over blocks
# at C >= 256 (`heads_per_block`); at C 512 and 1024 head dim 64 ends
# every window through part_dxm (its kBig tile); each case runs both
# (2 x 64^2: 128 windows, and the packed 403: 101 tiles, unsplit)
H64_BWD_CASES = (
    [("image", 64, 0, True, True, True, (2, 32)),
     ("image", 64, 4, False, False, False, (2, 32)),
     ("image", 128, 4, True, False, True, (2, 32)),
     ("image", 128, 0, False, True, False, (2, 32)),
     ("image", 512, 0, True, True, True, (2, 64)),
     ("image", 512, 4, False, True, False, (2, 16)),
     ("image", 1024, 4, True, True, True, (2, 16)),
     ("image", 1024, 0, True, False, False, (2, 8)),
     ("image", 1024, 4, False, True, True, (2, 64))]
    + [("window", C, s, ln, mod, True, n) for C, s, ln, mod, n in (
        (64, 0, True, True, 40), (64, 4, False, False, 40),
        (128, 4, True, False, 40), (512, 0, True, True, 100),
        (512, 4, False, True, 8), (1024, 4, True, True, 8),
        (1024, 0, False, False, 100))]
    + [("packed", C, s, ln, mod, True, n) for C, s, ln, mod, n in (
        (64, 0, True, True, 67), (64, 2, False, False, 67),
        (128, 2, True, True, 67), (512, 0, True, False, 35),
        (512, 2, False, True, 403), (1024, 2, True, True, 35),
        (1024, 0, False, True, 403))])
# kernel 7 at C 1024: (B, H, W) with LN and residual each way; 12 x 12 is
# no multiple of a tile's 8 columns
H64_LEFF_SHAPES = ((2, 16, 16), (2, 12, 12))
# kernels 4, 5 and 6 at windows 9, 12 and 16 at head dim 64: kernel 5 and
# 6's (C, heads, has_ln, with_mod) (C 1024: the win-16 model's dec0 and
# bottleneck) and kernel 4's (heads, head dim), each window at shift 0 and
# win // 2, on WIDE_IMAGES images of 4 x 4 windows
H64_WIDE_BLOCK_CASES = ((64, 1, True, True), (128, 2, False, True),
                        (1024, 16, True, False))
H64_WIDE_CORE_CASES = ((1, 64), (2, 64))
H64_CORE_TIMING = (1, 512, 64)  # kernel 4 alone at N 256: (heads, windows, D)
# the training cells (as TRAIN_GEOM): Uformer at embed 64 at --train_ps
# 128 (bs8) and 64 (bs32: the 4 x 4 bottleneck on packed tiles), and at
# --win_size 16 (bs8 128^2: every block at window 16 but the 8^2
# bottleneck, on the image route), each a step's launches by JAX's routes
E64_TRAIN = {
    "e64": ({"arch": "Uformer", "embed_dim": 64, "train_ps": 128}, 1248, 8,
            128, dict(NO_LAUNCHES, attention_image=18, attention_bwd=18,
                      leff=18, leff_bwd=18)),
    "e64ps64": ({"arch": "Uformer", "embed_dim": 64, "train_ps": 64}, 1249,
                32, 64, dict(NO_LAUNCHES, attention_image=16,
                             attention_bwd=16, attention_block=2,
                             attention_block_bwd=2, leff=18, leff_bwd=18)),
    "e64win16": ({"arch": "Uformer", "embed_dim": 64, "win_size": 16,
                  "train_ps": 128}, 1270, 8, 128, WIDE_TRAIN_LAUNCHES),
}
# the win-16 model served: built at 256 (every block at window 16)
E64_WIN16_SERVE = {"arch": "Uformer", "embed_dim": 64, "win_size": 16,
                   "train_ps": RES_SERVE}
# the train CLI at --embed_dim 64: train pairs, val pairs, batch, epochs
E64_CLI_SET = (64, 2, 8, 2)


def bwd_case(checks: Checks, kernel: str, what: str, fused, plain, shape,
             xin, cost, card: str) -> dict:
    """A backward kernel against its plain VJP on GEOM_DRAWS draws of x
    and g (`pooled_grad_bound`), run twice on the last draw (equal bits),
    then its bf16 call timed in turns with the plain VJP beside the bound
    of `cost`. fused and plain map (x, g, dtype) to the gradients' dict."""
    runs, before = [], wide_bodies_now()
    for _ in range(GEOM_DRAWS):
        x, g = xin(*shape), xin(*shape)
        runs.append([f(*a) for f, a in (
            (fused, (x, g, torch.float32)), (plain, (x, g, torch.float32)),
            (plain, (x.bfloat16(), g.bfloat16(), torch.bfloat16)),
            (fused, (x.bfloat16(), g.bfloat16(), torch.bfloat16)))])
    n = len(checks.rows)
    pooled_grad_bound(checks, kernel, what, runs)
    x16, g16 = x.bfloat16(), g.bfloat16()
    again = fused(x16, g16, torch.bfloat16)
    differ = sum(a is not None and not torch.equal(a, again[k])
                 for k, a in runs[-1][3].items())
    checks.add(kernel, f"{what} repeat", float(differ), 0.0, "bits")
    if kernel == "attention_block_bwd":
        wide = int(shape[1] > 64)
        wide_bwd_bodies(what, (GEOM_DRAWS + 1) * wide, GEOM_DRAWS * wide,
                        before)

    def k_fn():
        return fused(x16, g16, torch.bfloat16)

    def p_fn():
        return plain(x16, g16, torch.bfloat16)

    # one call a time: both are warm at this shape from the checks
    p1, k1, k2, p2 = (cuda_ms(p_fn, reps=1, warmup=0),
                      cuda_ms(k_fn, reps=1, warmup=0),
                      cuda_ms(k_fn, reps=1, warmup=0),
                      cuda_ms(p_fn, reps=1, warmup=0))
    t = {}
    tally(t, kernel, (k1 + k2) / 2, (p1 + p2) / 2, cost)
    rows = checks.rows[n:]
    worst = max(rows, key=lambda r: r["err"] / max(r["bound"], 1e-30))
    row = dict(t[kernel], what=what, bound_by=bound_by(t[kernel]),
               worst=worst["err"] / max(worst["bound"], 1e-30),
               worst_what=f"{worst['dtype']} {worst['what']}")
    # kernel 6's pooled bf16 dbias, its check nearest the gate above
    # window 16 (PERF.md §6)
    dbias = [r["err"] / r["bound"] for r in rows
             if r["what"] == f"{what} x{GEOM_DRAWS} dbias"]
    if dbias:
        row["dbias"] = dbias[0]
    print(f"  {kernel:19s} {what:44s} worst err/bound {row['worst']:.3f}"
          + (f", bf16 dbias {row['dbias']:.3f}" if dbias else "")
          + f"; bf16 kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})  "
          f"[{card}]", flush=True)
    return row


def head64_bwd_kernel_checks(checks: Checks, device, card: str,
                             seed: int = 24) -> list:
    """Kernel 6 at every H64_BWD_CASES case, kernel 7 at C 1024 on
    H64_LEFF_SHAPES (LN and residual each way) and kernels 4, 5 and 6 at
    windows 9, 12 and 16 at head dim 64, each against its plain version:
    fp32 (TF32 off) within 1e-4 (1 + max|ref|), bf16 under phase 19's
    gates, each backward run twice (equal bits), every call timed beside
    its plain version and its bound (`attn_bwd_cost`, `bwd_cost` of
    `leff_cost`, `attn_cost`, `core_cost`). Operands by the golden rule
    from `seed`. Returns the timed rows."""
    from uformer_tpu_torch.ops import kernels as K

    draw = GoldenDraws(seed, device)
    mat, scale, bias, xin, attn_prm = (draw.mat, draw.scale, draw.bias,
                                       draw.xin, draw.attn_prm)

    def grads(fn, names, p, kw):
        return lambda x, g, dt: dict(zip(names, fn(x, g, *p[dt].values(),
                                                   **kw)))

    rows = []
    for layout, C, shift, has_ln, with_mod, residual, n in H64_BWD_CASES:
        nH = C // 64
        win = 4 if layout == "packed" else 8
        N = win * win
        prm = attn_prm(C, nH, N, with_mod)
        if layout == "image":
            B, side = n
            shape, tokens = (B, side, side, C), B * side * side
            kw = dict(win=8, shift=shift, scale=0.125, num_heads=nH,
                      has_ln=has_ln, residual=residual)
            kernel = "attention_bwd"
            fused, plain = (grads(K.fused_attention_image_bwd, ATTN_GRADS,
                                  prm, kw),
                            grads(K.attention_image_vjp_reference,
                                  ATTN_GRADS, prm, kw))
        else:
            shape, tokens = (n, N, C), n * N
            kw = dict(win=win, shift=shift, H=16 * win, W=16 * win,
                      scale=0.125, num_heads=nH, has_ln=has_ln)
            kernel = "attention_block_bwd"
            fused, plain = (grads(K.fused_attention_block_bwd, ATTN_GRADS,
                                  prm, kw),
                            grads(K.attention_block_vjp_reference,
                                  ATTN_GRADS, prm, kw))
        what = (f"{layout} C {C} D 64 {tuple(shape)} shift {shift} ln "
                f"{int(has_ln)} mod {int(with_mod)} res {int(residual)}")
        rows.append(bwd_case(checks, kernel, what, fused, plain, shape, xin,
                             attn_bwd_cost(tokens, C, N), card))
    C, Ch = 1024, 4096
    lp = _prm(dict(w1=mat(C, Ch, fan_in=C), b1=bias(Ch),
                   wd=mat(3, 3, Ch, fan_in=9), bd=bias(Ch),
                   w2=mat(Ch, C, fan_in=Ch), ln_s=scale(C), ln_b=bias(C)),
              device, ("w1", "wd", "w2"))
    for (B, H, W), has_ln, residual in itertools.product(
            H64_LEFF_SHAPES, (True, False), (True, False)):
        def run(fn, has_ln=has_ln, residual=residual):
            def call(x, g, dt):
                p = lp[dt]
                ln = (p["ln_s"], p["ln_b"]) if has_ln else (None, None)
                return dict(zip(LEFF_GRADS, fn(
                    x, g, *(p[k] for k in ("w1", "b1", "wd", "bd", "w2")),
                    *ln, has_ln=has_ln, residual=residual)))
            return call
        tokens = B * H * W
        rows.append(bwd_case(
            checks, "leff_bwd", f"C 1024 {B}x{H}x{W} ln {int(has_ln)} res "
            f"{int(residual)}", run(K.fused_leff_bwd),
            run(K.leff_vjp_reference), (B, H, W, C), xin,
            bwd_cost(leff_cost(tokens, C, Ch), tokens, C), card))
    for win in WIDE_CHECK_WINDOWS:
        N, H = win * win, 4 * win
        Bw = WIDE_IMAGES * 16
        for shift in (0, win // 2):
            for nH, D in H64_WIDE_CORE_CASES:
                k, v = xin(nH, Bw, N, D), xin(nH, Bw, N, D)
                bias_t = torch.from_numpy(mat(nH, N, N, fan_in=nH)).to(device)
                kw = dict(win=win, shift=shift, H=H, W=H, scale=D ** -0.5)

                def run4(fn, kw=kw, k=k, v=v, bias_t=bias_t):
                    return lambda x, dt: fn(x, k.to(dt), v.to(dt), bias_t,
                                            **kw)

                rows.append(timed_compare(
                    checks, "window_attention",
                    f"win {win} shift {shift} (nH, Bw, N, D)=({nH}, {Bw}, "
                    f"{N}, {D})", run4(K.fused_window_attention),
                    run4(K.window_attention_reference), xin(nH, Bw, N, D),
                    core_cost(nH, Bw, D, N=N), card))
            for C, nH, has_ln, with_mod in H64_WIDE_BLOCK_CASES:
                prm = attn_prm(C, nH, N, with_mod)
                kw = dict(win=win, shift=shift, H=H, W=H, scale=0.125,
                          num_heads=nH, has_ln=has_ln)
                what = (f"win {win} shift {shift} C {C} D 64 Bw {Bw} ln "
                        f"{int(has_ln)} mod {int(with_mod)}")
                rows.append(timed_compare(
                    checks, "attention_block", what,
                    lambda x, dt, p=prm, kw=kw: K.fused_attention_block(
                        x, *p[dt].values(), **kw),
                    lambda x, dt, p=prm, kw=kw: K.attention_block_reference(
                        x, *p[dt].values(), **kw), xin(Bw, N, C),
                    attn_cost(Bw * N, C, nH, mod=with_mod, ln=has_ln, N=N),
                    card))
                rows.append(bwd_case(
                    checks, "attention_block_bwd", what,
                    grads(K.fused_attention_block_bwd, ATTN_GRADS, prm, kw),
                    grads(K.attention_block_vjp_reference, ATTN_GRADS, prm,
                          kw), (Bw, N, C), xin,
                    attn_bwd_cost(Bw * N, C, N), card))
    torch.cuda.synchronize()
    return rows


def head64_train_phase(tmp: Path, device, card: str) -> tuple:
    """Phase 22: head dim 64's backward (`head64_bwd_kernel_checks`);
    kernel 4 alone at N 256, head dim 64, beside SDPA (H64_CORE_TIMING); the
    training cells of E64_TRAIN by `train_cell` (each model's kernels at
    its training geometries, one whole step kernel path against plain
    path, bf16 steps and each backward call timed); the win-16 embed-64
    model served (4 bf16 requests of batch 8 at 256^2, every block on
    kernels 5 and 2 at window 16, no plain call, against the plain path,
    timed per kernel); the train CLI at --embed_dim 64. Returns the
    checks, the summary and the launches per path."""
    from uformer_tpu_torch.ops import kernels as K

    checks, summary, launches = Checks(), {"card": card}, {}
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    summary["kernel_rows"] = head64_bwd_kernel_checks(checks, device, card)
    torch.backends.cudnn.deterministic = False
    gen = torch.Generator(device="cpu").manual_seed(22)
    nH, Bw, D = H64_CORE_TIMING
    q, k, v = (torch.randn((nH, Bw, 256, D), generator=gen)
               .to(device, torch.bfloat16) for _ in range(3))
    bias = (0.5 * torch.randn((nH, 256, 256), generator=gen)).to(device)
    with torch.no_grad():
        summary["core"] = time_core(q, k, v, bias, win=16, shift=8,
                                    res=16 * int(round((Bw / 2) ** 0.5)))
    summary["kernel_checks_s"] = time.perf_counter() - t0
    for label, (opt, seed, bs, side, expected) in E64_TRAIN.items():
        train_cell(checks, summary, launches, label, opt, seed, bs, side,
                   expected, device, card)
    t1 = time.perf_counter()
    sd = seeded_for(E64_WIN16_SERVE, E64_TRAIN["e64win16"][1])
    restorer, x, serve, _, schecks = serve_phase(
        lambda: build_arch(E64_WIN16_SERVE, sd, device), device,
        WIDE_SERVE_LAUNCHES, "serve e64 win16")
    if any(K.plain_counts().values()):
        raise RuntimeError(f"serve e64 win16: plain calls "
                           f"{K.plain_counts()}")
    checks.rows += schecks.rows
    checks.failed += schecks.failed
    launches["serve_win16"] = serve["launches_per_request"][0]
    rows, totals, fwd = timing_phase(restorer, x)
    summary.update(serve_win16=serve, timing_serve_win16=rows,
                   timing_totals_serve_win16=totals, forward_win16=fwd,
                   serve_win16_s=time.perf_counter() - t1)
    print(f"  serve e64 win16 bs{BATCH_SERVE} {RES_SERVE}^2 bf16: "
          f"{serve['median_ms']:.3f} ms a request, kernel path "
          f"{fwd['kernel_ms']:.3f} ms against plain path "
          f"{fwd['plain_ms']:.3f} ms a forward  [{card}]", flush=True)
    del restorer, x
    torch.cuda.empty_cache()
    summary["cli"] = train_cli_run(
        tmp, device, "train CLI e64", ["--arch", "Uformer", "--embed_dim",
                                       "64"], RES_TRAIN, E64_CLI_SET,
        dict(E64_TRAIN["e64"][4]))
    launches["cli"] = summary["cli"]["launches"]
    return checks, summary, launches


# phase 23, windows above 16: kernels 4, 5 and 6 at N = win² of 289, 576
# and 1024 tokens (and 4096 at window 64), each window at shift 0 and
# win // 2 on ABOVE16_IMAGES images of 2 x 2 windows. Kernels 5 and 6:
# (C, heads, has_ln, with_mod), head dims 32 (no LN: the win-32 model's
# blocks take LN1 outside), 8 and 64; C 1024 on 16 heads at window 32;
# kernel 4: (heads, head dim)
ABOVE16_WINDOWS = (17, 24, 32)
ABOVE16_BLOCK_CASES = ((32, 1, False, True), (16, 2, True, False),
                       (64, 1, True, True))
ABOVE16_C1024 = (1024, 16, True, False)
ABOVE16_CORE_CASES = ((1, 32), (2, 8), (1, 64))
ABOVE16_IMAGES = 2
ABOVE16_W64 = (32, 1, True, True)  # window 64: kernels 5 and 6, one image
# the path: `--arch Uformer --embed_dim 32 --win_size 32` (depths 2 x 9,
# heads 1-16, head dim 32), seeded weights; served bf16 batch 8 at 256^2
# (built at 256: every stage at window 32 but the 16^2 bottleneck, which
# JAX's clip puts at window 16), trained bf16 batch 8 at --train_ps 128
# (windows 32, 16 at enc3 and dec0, and the 8^2 bottleneck at window 8 on
# the image route)
WIN32_ARCH = {"arch": "Uformer", "embed_dim": 32, "win_size": 32}
SEED_WIN32 = 1271
WIN32_CORE_TIMING = (1, 128, 32)  # kernel 4 alone at N 1024: (heads, Bw, D)


def grouped_bits(checks: Checks, what: str, fused, x, g, nH: int) -> dict:
    """Kernel 6 (fused(x, g, dtype) -> gradients' dict, nH heads) in bf16
    with attention_wide.DS_BUDGET lowered to one head of one window, so
    that its dS runs in at least three groups: two runs in equal bits,
    and every gradient but dbias (whose fold order alone moves) in the
    bits of the run at the module's budget (one group, two at C 1024);
    dbias within 1e-4 (1 + max|ref|) of it."""
    from uformer_tpu_torch.ops.kernels import attention_wide as AW

    Bw, N, _ = x.shape
    x16, g16 = x.bfloat16(), g.bfloat16()
    before = wide_bodies_now()
    one = fused(x16, g16, torch.bfloat16)
    budget = AW.DS_BUDGET
    AW.DS_BUDGET = N * N * 4
    try:
        groups = len(AW.ds_groups(Bw, nH, N))
        a, b = (fused(x16, g16, torch.bfloat16) for _ in range(2))
    finally:
        AW.DS_BUDGET = budget
    wide_bwd_bodies(f"{what} grouped", 3, 0, before)
    at_budget = len(AW.ds_groups(Bw, nH, N))
    if groups < 3 or groups <= at_budget:
        raise RuntimeError(f"{what}: {groups} dS groups at the lowered "
                           f"budget, {at_budget} at the module's; expected "
                           f"at least 3 and more than there")
    differ = sum(v is not None and not torch.equal(v, b[k])
                 for k, v in a.items())
    moved = sum(v is not None and k != "dbias" and not torch.equal(v, one[k])
                for k, v in a.items())
    checks.add("attention_block_bwd", f"{what} grouped repeat",
               float(differ), 0.0, "bits")
    checks.add("attention_block_bwd", f"{what} grouped against one group",
               float(moved), 0.0, "bits")
    checks.add("attention_block_bwd", f"{what} grouped dbias",
               max_err(a["dbias"], one["dbias"]),
               1e-4 * (1.0 + float(one["dbias"].abs().max())), "fp32")
    return {"what": what, "groups": groups, "groups_at_budget": at_budget,
            "differ": differ, "moved": moved}


def above16_kernel_checks(checks: Checks, device, card: str,
                          seed: int = 25) -> list:
    """Kernels 4, 5 and 6 at windows 17, 24 and 32 (N 289, 576, 1024),
    shift 0 and win // 2, and kernels 5 and 6 at window 64 (N 4096), each
    against its plain version: fp32 (TF32 off) within 1e-4 (1 +
    max|ref|), bf16 under phase 19's gates (`compare`; `pooled_grad_bound`
    over GEOM_DRAWS draws), each backward run twice (equal bits), each
    call timed beside its plain version and bound; at window 32 every
    backward again at three dS groups or more (`grouped_bits`). Operands
    by the golden rule from `seed`. Returns the timed rows."""
    from uformer_tpu_torch.ops import kernels as K

    draw = GoldenDraws(seed, device)
    mat, xin, attn_prm = draw.mat, draw.xin, draw.attn_prm

    def grads(fn, p, kw):
        return lambda x, g, dt: dict(zip(ATTN_GRADS, fn(x, g, *p[dt].values(),
                                                        **kw)))

    rows, grouped = [], []
    cases = [(win, shift, c) for win in ABOVE16_WINDOWS
             for shift in (0, win // 2)
             for c in ABOVE16_BLOCK_CASES
             + ((ABOVE16_C1024,) if win == 32 and shift else ())]
    cases.append((64, 32, ABOVE16_W64))
    for win in ABOVE16_WINDOWS:
        N, H = win * win, 2 * win
        Bw = ABOVE16_IMAGES * 4
        for shift in (0, win // 2):
            for nH, D in ABOVE16_CORE_CASES:
                k, v = xin(nH, Bw, N, D), xin(nH, Bw, N, D)
                bias = torch.from_numpy(mat(nH, N, N, fan_in=nH)).to(device)
                kw = dict(win=win, shift=shift, H=H, W=H, scale=D ** -0.5)

                def run4(fn, kw=kw, k=k, v=v, bias=bias):
                    return lambda x, dt: fn(x, k.to(dt), v.to(dt), bias,
                                            **kw)

                rows.append(timed_compare(
                    checks, "window_attention",
                    f"win {win} shift {shift} (nH, Bw, N, D)=({nH}, {Bw}, "
                    f"{N}, {D})", run4(K.fused_window_attention),
                    run4(K.window_attention_reference), xin(nH, Bw, N, D),
                    core_cost(nH, Bw, D, N=N), card))
    for win, shift, (C, nH, has_ln, with_mod) in cases:
        N, H = win * win, 2 * win
        Bw = 4 if win == 64 else ABOVE16_IMAGES * 4
        prm = attn_prm(C, nH, N, with_mod)
        kw = dict(win=win, shift=shift, H=H, W=H, scale=(C // nH) ** -0.5,
                  num_heads=nH, has_ln=has_ln)
        what = (f"win {win} shift {shift} C {C} D {C // nH} Bw {Bw} ln "
                f"{int(has_ln)} mod {int(with_mod)}")
        rows.append(timed_compare(
            checks, "attention_block", what,
            lambda x, dt, p=prm, kw=kw: K.fused_attention_block(
                x, *p[dt].values(), **kw),
            lambda x, dt, p=prm, kw=kw: K.attention_block_reference(
                x, *p[dt].values(), **kw), xin(Bw, N, C),
            attn_cost(Bw * N, C, nH, mod=with_mod, ln=has_ln, N=N), card))
        fused = grads(K.fused_attention_block_bwd, prm, kw)
        rows.append(bwd_case(
            checks, "attention_block_bwd", what, fused,
            grads(K.attention_block_vjp_reference, prm, kw), (Bw, N, C),
            xin, attn_bwd_cost(Bw * N, C, N), card))
        if win == 32 and shift:
            grouped.append(grouped_bits(checks, what, fused, xin(Bw, N, C),
                                        xin(Bw, N, C), nH))
    torch.cuda.synchronize()
    print(f"  kernel 6 at window 32 with dS in groups of one head of one "
          f"window: {len(grouped)} cases, equal bits on two runs and to "
          f"one group but dbias: "
          f"{all(not g['differ'] and not g['moved'] for g in grouped)}",
          flush=True)
    return rows


def wide_ds_bytes(model, batch: int, side: int) -> dict:
    """The fp32 dS of every windowed block above window 8 in one bf16
    train step of `model` at batch x side^2: the grouped scratch the
    backward allocates (`attention_wide.ds_groups` at the tensor-core
    core's `bwd_core_windows`, each block's windows summed) against the
    (Bw, nH, N, N) buffer of a single group, and the groups, at the
    largest."""
    from uformer_tpu_torch.models.layers import LeWinBlock
    from uformer_tpu_torch.ops.kernels import attention_wide as AW
    from uformer_tpu_torch.ops.kernels.wgrad import sm_count

    out = {"scratch_bytes": 0, "single_group_bytes": 0, "groups": 0,
           "budget_bytes": AW.DS_BUDGET}
    res = {name: getattr(model, name).resolution for name in LAYERS}
    for name, blk in model.named_modules():
        if not isinstance(blk, LeWinBlock) or blk.image_route \
                or blk.win_size ** 2 <= 64:
            continue
        r = side * res[name.split(".")[0]] // res["encoderlayer_0"]
        N, nH = blk.win_size ** 2, blk.num_heads
        Bw = batch * (r // blk.win_size) ** 2
        G = AW.bwd_core_windows(Bw, nH, N, sm_count(
            next(model.parameters()).device))
        groups = AW.ds_groups(Bw, nH, N, G)
        _, n, _, nh = groups[0]
        out["scratch_bytes"] = max(out["scratch_bytes"],
                                   -(-n // min(G, n)) * nh * N * N * 4)
        out["single_group_bytes"] = max(out["single_group_bytes"],
                                        Bw * nH * N * N * 4)
        out["groups"] = max(out["groups"], len(groups))
    return out


def above16_phase(tmp: Path, device, card: str) -> tuple:
    """Phase 23: kernels 4, 5 and 6 above window 16
    (`above16_kernel_checks`); kernel 4 alone at N 1024 beside SDPA
    (WIN32_CORE_TIMING); the win-32 Uformer (WIN32_ARCH) served bf16 at
    batch 8, 256^2 (18 kernel-5 and 18 LeFF launches a request, no plain
    call; against the plain path) and timed per kernel; trained at
    --train_ps 128 by `train_cell` (its kernels at every training
    geometry, one whole step kernel path against plain path, bf16 steps
    and each backward call timed), with the step's peak memory, its dS
    scratch against the budget and against a single group's buffer; the
    train CLI at --win_size 32. Returns the checks, the summary and the
    launches per path."""
    from uformer_tpu_torch.ops import kernels as K

    checks, summary, launches = Checks(), {"card": card}, {}
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    summary["kernel_rows"] = above16_kernel_checks(checks, device, card)
    torch.backends.cudnn.deterministic = False
    gen = torch.Generator(device="cpu").manual_seed(23)
    nH, Bw, D = WIN32_CORE_TIMING
    q, k, v = (torch.randn((nH, Bw, 1024, D), generator=gen)
               .to(device, torch.bfloat16) for _ in range(3))
    bias = (0.5 * torch.randn((nH, 1024, 1024), generator=gen)).to(device)
    with torch.no_grad():
        summary["core"] = time_core(q, k, v, bias, win=32, shift=16,
                                    res=32 * int(round(Bw ** 0.5)))
    del q, k, v, bias
    summary["kernel_checks_s"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    serve_opt = dict(WIN32_ARCH, train_ps=RES_SERVE)
    sd = seeded_for(serve_opt, SEED_WIN32)
    restorer, x, serve, _, schecks = serve_phase(
        lambda: build_arch(serve_opt, sd, device), device,
        WIDE_SERVE_LAUNCHES, "serve win32")
    if any(K.plain_counts().values()):
        raise RuntimeError(f"serve win32: plain calls {K.plain_counts()}")
    checks.rows += schecks.rows
    checks.failed += schecks.failed
    launches["serve"] = serve["launches_per_request"][0]
    rows, totals, fwd = timing_phase(restorer, x)
    summary.update(serve=serve, timing=rows, timing_totals=totals,
                   forward=fwd, serve_s=time.perf_counter() - t1)
    print(f"  serve win32 bs{BATCH_SERVE} {RES_SERVE}^2 bf16: "
          f"{serve['median_ms']:.3f} ms a request, kernel path "
          f"{fwd['kernel_ms']:.3f} ms against plain path "
          f"{fwd['plain_ms']:.3f} ms a forward  [{card}]", flush=True)
    del restorer, x
    torch.cuda.empty_cache()

    train_opt = dict(WIN32_ARCH, train_ps=RES_TRAIN)
    train_cell(checks, summary, launches, "win32", train_opt, SEED_WIN32,
               WIDE_TRAIN_BATCH, RES_TRAIN, WIDE_TRAIN_LAUNCHES, device,
               card)
    launches["train"] = launches.pop("win32")
    model = build_arch(train_opt, seeded_for(train_opt, SEED_WIN32), device)
    batch = train_batch(WIDE_TRAIN_BATCH, 7, device, RES_TRAIN)
    _, state, step = run_step(model, False, torch.bfloat16, batch, 50,
                              lambda s: 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    step(state, batch, torch.Generator(device="cpu").manual_seed(51))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    ds = wide_ds_bytes(model, WIDE_TRAIN_BATCH, RES_TRAIN)
    memory = dict(ds, peak_bytes=peak, before_step_bytes=base,
                  single_group_peak_bytes=(peak - ds["scratch_bytes"]
                                           + ds["single_group_bytes"]))
    summary["memory_win32"] = memory
    if ds["scratch_bytes"] > ds["budget_bytes"] or ds["groups"] < 2:
        raise RuntimeError(f"train win32: dS scratch {ds}: expected within "
                           f"the budget and more than one group")
    print(f"  train win32 bs{WIDE_TRAIN_BATCH} {RES_TRAIN}^2 bf16 step: "
          f"peak {peak / 2**20:.1f} MiB with dS in up to {ds['groups']} "
          f"groups of at most {ds['scratch_bytes'] / 2**20:.1f} MiB "
          f"(budget {ds['budget_bytes'] / 2**20:.0f} MiB); one group's "
          f"buffer {ds['single_group_bytes'] / 2**20:.1f} MiB, peak so "
          f"{memory['single_group_peak_bytes'] / 2**20:.1f} MiB  [{card}]",
          flush=True)
    del model, batch, state, step
    torch.cuda.empty_cache()
    summary["cli"] = train_cli_run(
        tmp, device, "train CLI win32",
        ["--arch", "Uformer", "--embed_dim", "32", "--win_size", "32",
         "--train_ps", str(RES_TRAIN)], RES_TRAIN, WIDE_CLI_SET,
        dict(WIDE_TRAIN_LAUNCHES))
    launches["cli"] = summary["cli"]["launches"]
    return checks, summary, launches


# phase 24, head dims 24-56: `--arch Uformer --embed_dim 48` and `24`
# (heads 1-2-4-8-16-16-8-4-2, every block at head dim 48 or 24, C 24-768,
# none a power of two) served through kernels 5, 3 and 2. Cells: label ->
# (get_arch options, weight seed, launches a request by JAX's route,
# layers.py:757-775 and 979-985): the stage kernel where C % 128 == 0,
# kernels 5 and 2 a block elsewhere (window 8), never kernel 1
HEADS_MODELS = {
    "e48": ({"arch": "Uformer", "embed_dim": 48, "train_ps": 128}, 1283,
            dict(NO_LAUNCHES, stage=4, attention_block=10, leff=10)),
    "e24": ({"arch": "Uformer", "embed_dim": 24, "train_ps": 128}, 1284,
            dict(NO_LAUNCHES, stage=2, attention_block=14, leff=14)),
}
HEADS_NEW = (24, 40, 48, 56)  # the head dims this phase adds
HEADS_NH = (1, 2, 4, 8, 16)  # the family's heads a stage
# kernel 5 beyond window 8: (win, head dim, heads), packed window 4 and
# wide window 16 at two (D, heads) each
HEADS_BLOCK_OTHER = ((4, 24, 4), (4, 56, 1), (16, 48, 2), (16, 40, 1))
# kernel 3: (C, heads) at every width the family runs it with these head
# dims (C = 16 D), on 16^2 and 8^2, batch 2, shift on
HEADS_STAGE = ((384, 16), (384, 8), (640, 16), (768, 16), (896, 16))
# kernel 2: every C = D nH of the new head dims (hidden 4C; 96, 160 and
# 224 padded to 128, 192 and 256 by the wrapper)
HEADS_LEFF_C = sorted({D * nH for D in HEADS_NEW for nH in HEADS_NH})
HEADS_IMAGES = 2  # batch of the kernel checks (images of 4 x 4 windows)


def heads_kernel_checks(checks: Checks, device, card: str) -> list:
    """Kernels 5, 3 and 2 at head dims 24-56 against their plain versions,
    fp32 (TF32 off) and bf16 by `compare`: kernel 5 at window 8 at every
    (D, heads) the family builds, with LN and modulator at w_off 0 (timed)
    and without either at w_off 37, shift 4, and at HEADS_BLOCK_OTHER;
    kernel 3 at HEADS_STAGE on 16^2 and 8^2; kernel 2 at every
    HEADS_LEFF_C with LN and residual and without; every timed row beside
    its plain version and bound (`timed_compare`). Returns the timed
    rows."""
    from uformer_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(24)

    def mk(*shape, fan_in=None, scale=0.3):
        a = rng.standard_normal(shape)
        return (a / np.sqrt(fan_in) if fan_in else a * scale).astype(
            np.float32)

    def xin(*shape):
        return torch.from_numpy(mk(*shape, scale=1.0)).to(
            device).bfloat16().float()

    def attn_prm(C, nH, N, with_mod):
        return _prm(dict(mod=mk(N, C, scale=0.1) if with_mod else None,
                         ln_s=1.0 + mk(C, scale=0.1),
                         ln_b=mk(C, scale=0.1), wq=mk(C, C, fan_in=C),
                         bq=mk(C, scale=0.02), wkv=mk(C, 2 * C, fan_in=C),
                         bkv=mk(2 * C, scale=0.02), wo=mk(C, C, fan_in=C),
                         bo=mk(C, scale=0.02), bias=mk(nH, N, N, scale=0.5)),
                    device, ("mod", "wq", "wkv", "wo"))

    def block_case(win, D, nH, shift, w_off, on, timed):
        C, N, H = D * nH, win * win, 4 * win
        Bw = HEADS_IMAGES * 16
        prm = attn_prm(C, nH, N, on)
        kw = dict(win=win, shift=shift, H=H, W=H, scale=D ** -0.5,
                  num_heads=nH, has_ln=on, w_off=w_off)
        what = (f"D {D} C {C} win {win} shift {shift} off {w_off} ln/mod "
                f"{int(on)}")
        fused = (lambda x, dt, p=prm, kw=kw: K.fused_attention_block(
            x, *p[dt].values(), **kw))
        plain = (lambda x, dt, p=prm, kw=kw: K.attention_block_reference(
            x, *p[dt].values(), **kw))
        if timed:
            return timed_compare(checks, "attention_block", what, fused,
                                 plain, xin(Bw, N, C),
                                 attn_cost(Bw * N, C, nH, mod=on, ln=on,
                                           N=N), card)
        compare(checks, "attention_block", what, fused, plain,
                xin(Bw, N, C))
        return None

    rows = []
    for D in HEADS_NEW:
        for nH in HEADS_NH:
            rows.append(block_case(8, D, nH, 4, 0, True, True))
            block_case(8, D, nH, 4, 37, False, False)
    for win, D, nH in HEADS_BLOCK_OTHER:
        rows.append(block_case(win, D, nH, win // 2, 37, True, True))
    for C, nH in HEADS_STAGE:
        n, Ch = 2, 4 * C
        sprm = _prm(dict(
            ln1_s=1.0 + mk(n, C, scale=0.1), ln1_b=mk(n, C, scale=0.1),
            wq=mk(n, C, C, fan_in=C), bq=mk(n, C, scale=0.02),
            wk=mk(n, C, C, fan_in=C), bk=mk(n, C, scale=0.02),
            wv=mk(n, C, C, fan_in=C), bv=mk(n, C, scale=0.02),
            wo=mk(n, C, C, fan_in=C), bo=mk(n, C, scale=0.02),
            bias=mk(n, nH, 64, 64, scale=0.5), mod=mk(n, 64, C, scale=0.1),
            ln2_s=1.0 + mk(n, C, scale=0.1), ln2_b=mk(n, C, scale=0.1),
            w1=mk(n, C, Ch, fan_in=C), b1=mk(n, Ch, scale=0.02),
            wd=mk(n, 3, 3, Ch, fan_in=9), bd=mk(n, Ch, scale=0.02),
            w2=mk(n, Ch, C, fan_in=Ch), b2=mk(n, C, scale=0.02)),
            device, ("wq", "wk", "wv", "wo", "mod", "w1", "wd", "w2"))
        kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=True,
                  has_mod=True)
        for side in (16, 8):
            rows.append(timed_compare(
                checks, "stage", f"D {C // nH} C {C} 2x{side}^2",
                lambda x, dt, p=sprm, kw=kw: K.fused_stage(x, p[dt], **kw),
                lambda x, dt, p=sprm, kw=kw: K.stage_reference(x, p[dt],
                                                               **kw),
                xin(2, side, side, C),
                stage_cost(2 * side * side, C, nH, Ch, n), card))
    for C in HEADS_LEFF_C:
        Ch = 4 * C
        lprm = _prm(dict(w1=mk(C, Ch, fan_in=C), b1=mk(Ch, scale=0.02),
                         wd=mk(3, 3, Ch, fan_in=9), bd=mk(Ch, scale=0.02),
                         w2=mk(Ch, C, fan_in=Ch), b2=mk(C, scale=0.02),
                         ln_s=1.0 + mk(C, scale=0.1), ln_b=mk(C, scale=0.1)),
                    device, ("w1", "wd", "w2"))
        for on in (True, False):
            def run(fn, p=lprm, on=on):
                def call(x, dt):
                    q = p[dt]
                    ln = dict(ln_s=q["ln_s"], ln_b=q["ln_b"]) if on else {}
                    return fn(x, *(q[k] for k in ("w1", "b1", "wd", "bd",
                                                  "w2", "b2")), **ln,
                              residual=on)
                return call
            rows.append(timed_compare(
                checks, "leff", f"C {C} Ch {Ch} 2x16x24 ln/res {int(on)}",
                run(K.fused_leff), run(K.leff_reference), xin(2, 16, 24, C),
                leff_cost(2 * 16 * 24, C, Ch), card))
    torch.cuda.synchronize()
    return [r for r in rows if r is not None]


def heads_fp32_request(sd, device, checks: Checks, card: str) -> dict:
    """One fp32 bs8 256^2 request of e48 through a Restorer (TF32 off):
    e48's launches, no plain call, the clamped output and the output
    before the clamp against the plain path within 1e-4 (1 + max|ref|)."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.restore import Restorer

    opt, _, expected = HEADS_MODELS["e48"]
    restorer = Restorer(build_arch(opt, sd, device), torch.float32, device)
    x = torch.rand((BATCH_SERVE, RES_SERVE, RES_SERVE, 3),
                   generator=torch.Generator(device="cpu").manual_seed(2))
    restorer(x)  # warm-up
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.perf_counter()
    y = restorer(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = K.launch_counts()
    if got != expected or any(K.plain_counts().values()):
        raise RuntimeError(f"e48 fp32 request: launches {got}, plain calls "
                           f"{K.plain_counts()}; expected {expected}")
    xd = x.to(device)
    with torch.no_grad():
        raw = restorer.model(xd).float()
        ref = restorer.model(xd, plain=True).float()
    for what, a, b in (("clamped", y, ref.clamp(0.0, 1.0)),
                       ("before the clamp", raw, ref)):
        checks.add("model", f"serve e48 fp32 bs8 256^2 request {what}",
                   max_err(a, b), 1e-4 * (1.0 + float(b.abs().max())),
                   "fp32")
    print(f"  serve e48 fp32 bs{BATCH_SERVE} {RES_SERVE}^2: one request "
          f"{ms:.3f} ms, launches {got}, no plain call; against the plain "
          f"path {checks.rows[-2]['err']:.2e} (clamped), "
          f"{checks.rows[-1]['err']:.2e} (before)  [{card}]", flush=True)
    return {"ms": ms, "launches": got}


def heads_phase(tmp: Path, device, card: str) -> tuple:
    """Phase 24: kernels 5, 3 and 2 at head dims 24-56 against their plain
    versions at every new (D, heads) the family builds, each timed
    (`heads_kernel_checks`); the serve cells e48 and e24 (HEADS_MODELS: 4
    bf16 requests of batch 8 at 256^2, their launches, no plain call,
    against the plain path, each kernel's time per stage and the forward on
    both paths, peak memory); one fp32 request of e48 against the plain
    path. Returns the checks, the summary and the launches per path."""
    from uformer_tpu_torch.ops import kernels as K

    checks, summary, launches = Checks(), {"card": card}, {}
    t0 = time.perf_counter()
    summary["kernel_rows"] = heads_kernel_checks(checks, device, card)
    summary["kernel_checks_s"] = time.perf_counter() - t0
    sds = {}
    for label, (opt, seed, expected) in HEADS_MODELS.items():
        sds[label] = sd = seeded_for(opt, seed)
        restorer, x, serve, _, schecks = serve_phase(
            lambda opt=opt, sd=sd: build_arch(opt, sd, device), device,
            expected, f"serve {label}")
        if any(K.plain_counts().values()):
            raise RuntimeError(f"serve {label}: plain calls "
                               f"{K.plain_counts()}")
        checks.rows += schecks.rows
        checks.failed += schecks.failed
        launches[label] = serve["launches_per_request"][0]
        rows, totals, fwd = timing_phase(restorer, x)
        summary.update({f"serve_{label}": serve, f"timing_{label}": rows,
                        f"timing_totals_{label}": totals,
                        f"forward_{label}": fwd})
        print(f"  serve {label} bs{BATCH_SERVE} {RES_SERVE}^2 bf16: "
              f"{serve['median_ms']:.3f} ms a request, "
              f"{serve['mp_per_s']:.2f} MP/s, kernel path "
              f"{fwd['kernel_ms']:.3f} ms against plain path "
              f"{fwd['plain_ms']:.3f} ms a forward, peak "
              f"{serve['max_memory_allocated_bytes'] / 2**20:.1f} MiB  "
              f"[{card}]", flush=True)
        del restorer, x
        torch.cuda.empty_cache()
    summary["fp32_e48"] = heads_fp32_request(sds["e48"], device, checks,
                                             card)
    launches["e48_fp32"] = summary["fp32_e48"]["launches"]
    return checks, summary, launches


# phase 25, the backward at head dims 24-56: `--arch Uformer --embed_dim
# 48` and `24` trained at --train_ps 128 (bs8 128^2). Cells: label ->
# (get_arch options, weight seed, batch, side, launches a step by JAX's
# routes, layers.py:771-775: the image route where C % 128 == 0, the
# windowed branch elsewhere, the same count each way)
HEADS_TRAIN = {
    "e48": (HEADS_MODELS["e48"][0], 1286, 8, RES_TRAIN,
            dict(NO_LAUNCHES, attention_image=8, attention_bwd=8,
                 attention_block=10, attention_block_bwd=10, leff=18,
                 leff_bwd=18)),
    "e24": (HEADS_MODELS["e24"][0], 1287, 8, RES_TRAIN,
            dict(NO_LAUNCHES, attention_image=4, attention_bwd=4,
                 attention_block=14, attention_block_bwd=14, leff=18,
                 leff_bwd=18)),
}
# kernel 1 and its VJP at the image route's widths of these models: (C,
# heads) on HEADS_IMAGES x 16^2, shift 4, residual on
HEADS_IMAGE_C = ((384, 16), (640, 16), (768, 16), (896, 16))
# kernel 6 windowed: (win, head dim, heads, has_ln, with_mod); window 8 at
# every (D, heads) of C 24-192, packed window 4 and wide window 16 at two
# (D, heads) each
HEADS_BWD_BLOCK = (
    [(8, D, nH, True, True) for D in HEADS_NEW for nH in HEADS_NH
     if D * nH <= 192]
    + [(4, 24, 4, True, False), (4, 56, 1, False, True),
       (16, 48, 2, True, True), (16, 40, 1, False, True)])
# the train CLI at --embed_dim 48: train pairs, val pairs, batch, epochs
HEADS_CLI_SET = (64, 2, 8, 2)


def heads_bwd_kernel_checks(checks: Checks, device, card: str,
                            seed: int = 25) -> list:
    """Kernel 1 and its VJP at HEADS_IMAGE_C, kernel 6 at HEADS_BWD_BLOCK
    and kernel 7 at every HEADS_LEFF_C (LN and residual each way), each
    against its plain version: fp32 (TF32 off) within 1e-4 (1 + max|ref|),
    bf16 under phase 19's gates (`bwd_case`: pooled over GEOM_DRAWS draws,
    run twice for equal bits), every call timed beside its plain version
    and its bound. Operands by the golden rule from `seed`. Returns the
    timed rows."""
    from uformer_tpu_torch.ops import kernels as K

    draw = GoldenDraws(seed, device)
    mat, scale, bias, xin, attn_prm = (draw.mat, draw.scale, draw.bias,
                                       draw.xin, draw.attn_prm)

    def grads(fn, names, p, kw):
        return lambda x, g, dt: dict(zip(names, fn(x, g, *p[dt].values(),
                                                   **kw)))

    rows = []
    for C, nH in HEADS_IMAGE_C:
        D = C // nH
        prm = attn_prm(C, nH, 64, True)
        kw = dict(win=8, shift=4, scale=D ** -0.5, num_heads=nH,
                  has_ln=True, residual=True)
        shape = (HEADS_IMAGES, 16, 16, C)
        tokens = HEADS_IMAGES * 256
        what = f"image C {C} D {D} {shape} shift 4"
        rows.append(timed_compare(
            checks, "attention_image", what,
            lambda x, dt, p=prm, kw=kw: K.fused_attention_image(
                x, *p[dt].values(), **kw),
            lambda x, dt, p=prm, kw=kw: K.attention_image_reference(
                x, *p[dt].values(), **kw), xin(*shape),
            attn_cost(tokens, C, nH), card))
        rows.append(bwd_case(
            checks, "attention_bwd", what,
            grads(K.fused_attention_image_bwd, ATTN_GRADS, prm, kw),
            grads(K.attention_image_vjp_reference, ATTN_GRADS, prm, kw),
            shape, xin, attn_bwd_cost(tokens, C, 64), card))
    for win, D, nH, has_ln, with_mod in HEADS_BWD_BLOCK:
        C, N = D * nH, win * win
        Bw = HEADS_IMAGES * 16
        prm = attn_prm(C, nH, N, with_mod)
        kw = dict(win=win, shift=win // 2, H=4 * win, W=4 * win,
                  scale=D ** -0.5, num_heads=nH, has_ln=has_ln)
        what = (f"win {win} C {C} D {D} Bw {Bw} ln {int(has_ln)} mod "
                f"{int(with_mod)}")
        rows.append(bwd_case(
            checks, "attention_block_bwd", what,
            grads(K.fused_attention_block_bwd, ATTN_GRADS, prm, kw),
            grads(K.attention_block_vjp_reference, ATTN_GRADS, prm, kw),
            (Bw, N, C), xin, attn_bwd_cost(Bw * N, C, N), card))
    for C in HEADS_LEFF_C:
        Ch = 4 * C
        lp = _prm(dict(w1=mat(C, Ch, fan_in=C), b1=bias(Ch),
                       wd=mat(3, 3, Ch, fan_in=9), bd=bias(Ch),
                       w2=mat(Ch, C, fan_in=Ch), ln_s=scale(C),
                       ln_b=bias(C)), device, ("w1", "wd", "w2"))
        for on in (True, False):
            def run(fn, on=on, lp=lp):
                def call(x, g, dt):
                    p = lp[dt]
                    ln = (p["ln_s"], p["ln_b"]) if on else (None, None)
                    return dict(zip(LEFF_GRADS, fn(
                        x, g, *(p[k] for k in ("w1", "b1", "wd", "bd",
                                               "w2")),
                        *ln, has_ln=on, residual=on)))
                return call
            tokens = 2 * 16 * 24
            rows.append(bwd_case(
                checks, "leff_bwd", f"C {C} Ch {Ch} 2x16x24 ln/res {int(on)}",
                run(K.fused_leff_bwd), run(K.leff_vjp_reference),
                (2, 16, 24, C), xin,
                bwd_cost(leff_cost(tokens, C, Ch), tokens, C), card))
    torch.cuda.synchronize()
    return rows


def heads_train_phase(tmp: Path, device, card: str) -> tuple:
    """Phase 25: the backward at head dims 24-56 (`heads_bwd_kernel_checks`);
    the training cells of HEADS_TRAIN by `train_cell` (each model's kernels
    at its training geometries, one whole step kernel path against plain
    path in fp32 and bf16, bf16 steps timed with their peak memory and each
    backward call timed); the train CLI at --embed_dim 48. Returns the
    checks, the summary and the launches per path."""
    checks, summary, launches = Checks(), {"card": card}, {}
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    summary["kernel_rows"] = heads_bwd_kernel_checks(checks, device, card)
    torch.backends.cudnn.deterministic = False
    summary["kernel_checks_s"] = time.perf_counter() - t0
    for label, (opt, seed, bs, side, expected) in HEADS_TRAIN.items():
        train_cell(checks, summary, launches, label, opt, seed, bs, side,
                   expected, device, card)
        print(f"  train {label}: peak "
              f"{summary[f'steps_{label}']['peak_mib']:.1f} MiB a bf16 "
              f"kernel path step  [{card}]", flush=True)
    opt = HEADS_TRAIN["e48"][0]
    summary["cli"] = train_cli_run(
        tmp, device, "train CLI e48", ["--arch", "Uformer", "--embed_dim",
                                       str(opt["embed_dim"])], RES_TRAIN,
        HEADS_CLI_SET, dict(HEADS_TRAIN["e48"][4]))
    launches["cli"] = summary["cli"]["launches"]
    return checks, summary, launches


# the phases that take (tmp, device, card) alone: number -> (name, function,
# key of its report, key of its launches on the kernels line), in order;
# `--only` picks among them
SELF_CONTAINED = {
    "19": ("train geometries", "train_geometry_phase", "train_geometries",
           "train"),
    "20": ("wide windows", "wide_window_phase", "wide_windows", "win16"),
    "21": ("head dim 64", "head64_phase", "head64", "head64"),
    "22": ("head dim 64 training", "head64_train_phase", "head64_train",
           "e64train"),
    "23": ("windows above 16", "above16_phase", "above16", "win32"),
    "24": ("head dims 24-56", "heads_phase", "heads", "heads"),
    "25": ("train head dims 24-56", "heads_train_phase", "heads_train",
           "train_heads"),
}


def run_self_contained(num: str, device, card: str) -> tuple:
    """Phase `num` of SELF_CONTAINED in a temporary directory, timed;
    returns its checks (not yet raised), summary (with "s") and
    launches."""
    name, fn, _, _ = SELF_CONTAINED[num]
    phase(name)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        checks, summary, launches = globals()[fn](Path(tmp), device, card)
    summary["s"] = time.perf_counter() - t0
    print(f"  phase {num} took {summary['s']:.1f} s", flush=True)
    return checks, summary, launches


def core_entry(phases: dict, name: str, parallel: dict = None) -> dict:
    """The kernels line's core keys of kernel `name`: its core's launches
    above window 8 by body at each site of `phases` ({num: (checks,
    summary, launches)}) that counted them (`core_bodies`: phase 20's
    kernel checks, a served request of kernel 5, a bf16 train step's
    kernel 6, and with `parallel` phase 17's kernel 5 on the spatial path
    at windows 2-32), and each body's sum."""
    sites = {}
    if parallel is not None and name == "attention_block":
        sites.update((f"17 {key}", val) for key, val
                     in parallel["spatial_windows"].items()
                     if key.endswith("ranks"))
    for num, (_, summ, _) in phases.items():
        if "kernel_check_bodies" in summ:
            sites[f"{num} kernel checks"] = summ["kernel_check_bodies"][name]
        for key, val in summ.items():
            if name == "attention_block" and isinstance(val, dict) \
                    and "core_bodies_per_request" in val:
                sites[f"{num} {key} request"] = \
                    val["core_bodies_per_request"][0]
            if name == "attention_block_bwd" and isinstance(val, dict) \
                    and "wide_bwd_bodies" in val:
                sites[f"{num} {key} step"] = val["wide_bwd_bodies"]
    return {**{body: sum(c[body] for c in sites.values())
               for body in ("core_mma_launches", "core_fma_launches")},
            "core_bodies": sites}


def only_kernels(results: dict) -> list:
    """The kernels line of an `--only` run: every kernel with a check in
    the phases that ran, its launches summed over their paths, its worst
    fp32 error, and the first per-step timing of it in those phases (None
    where they time it per call only)."""
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rows, launched, timed = [], 0, None
        for checks, summary, launches in results.values():
            rows += [r for r in checks.rows if r["kernel"] == name]
            launched += sum(kernel_count(c, name) for c in launches.values())
            for key, val in summary.items():
                if timed is None and key.startswith("timing_totals") \
                        and name in val:
                    timed = val[name]
        if not rows:
            continue
        errs = [r["err"] for r in rows if r["dtype"] == "fp32"]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launched,
                 "max_abs_err": max(errs) if errs else None,
                 "ms": None, "plain_ms": None, "bound_ms": None,
                 "bound_by": None, "library_ms": None}
        if timed is not None:
            entry.update(ms=timed["ms"], plain_ms=timed["plain_ms"],
                         bound_ms=timed["bound_ms"],
                         bound_by=bound_by(timed),
                         library_ms=timed.get("library_ms"))
        if name in ("window_attention", "attention_block",
                    "attention_block_bwd"):
            entry.update(core_entry(results, name))
        kernels.append(entry)
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, help="write the full report here")
    ap.add_argument("--only", help="run the build, then only these of "
                    "phases 19-25 (numbers or function names, comma "
                    "separated)")
    args = ap.parse_args()
    only = None
    if args.only:
        names = {fn: num for num, (_, fn, _, _) in SELF_CONTAINED.items()}
        only = [names.get(a.strip(), a.strip())
                for a in args.only.split(",")]
        unknown = [a for a in only if a not in SELF_CONTAINED]
        if unknown:
            ap.error(f"--only takes {', '.join(SELF_CONTAINED)} or their "
                     f"functions' names: not {', '.join(unknown)}")
    t0 = time.perf_counter()
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    card = card_line()
    device = torch.device("cuda", 0)
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if only is not None:
        kernels = run_only(only, device, card, args.json)
        if kernels is None:
            return 1
    else:
        kernels = run(device, card, args.json)
    print(f"  chip_smoke.py took {time.perf_counter() - t0:.1f} s", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def build_phase() -> tuple:
    """Phase 2: the kernels built (or loaded); prints each function's
    registers and spills. Returns (seconds, the ptxas report)."""
    from uformer_tpu_torch.ops.kernels import _build

    phase("build")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = (_build.BUILD_DIR / "build.log")
    ptxas = ptxas_report(log.read_text() if log.exists() else "")
    for name, regs, stores, loads in ptxas:
        print(f"  {regs if regs is not None else '-':>3} registers, "
              f"{stores:4d} B spill stores, {loads:4d} B spill loads  "
              f"{name[:90]}")
    print(f"  built {_build.library_path().name} in {build_s:.1f} s",
          flush=True)
    return build_s, ptxas


def run_only(only: list, device, card: str, json_path):
    """The build, then the phases `only` (numbers of SELF_CONTAINED), each
    printing its result; writes their report to json_path (if given).
    Returns the kernels line's entries, or None if a phase failed (every
    chosen phase still runs)."""
    build_s, ptxas = build_phase()
    results, failed = {}, []
    for num in only:
        try:
            results[num] = run_self_contained(num, device, card)
        except Exception as exc:  # reported, and the run fails at its end
            failed.append(f"phase {num}: {type(exc).__name__}: {exc}")
            print(f"  phase {num} FAILED: {type(exc).__name__}: {exc}",
                  flush=True)
            continue
        checks = results[num][0]
        worst = max(checks.rows, key=lambda r: r["err"] / max(r["bound"],
                                                              1e-30),
                    default=None)
        print(f"  phase {num}: {len(checks.rows)} checks, "
              f"{len(checks.failed)} failed"
              + (f", worst err/bound {worst['err'] / max(worst['bound'], 1e-30):.3f}"
                 f" ({worst['kernel']} {worst['dtype']} {worst['what']})"
                 if worst else ""), flush=True)
        for f in checks.failed:
            print(f"  FAILED {f}", flush=True)
        if checks.failed:
            failed.append(f"phase {num}: {len(checks.failed)} checks")
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(
            {"card": card, "build_s": build_s, "ptxas": ptxas,
             **{f"phase_{num}": {"checks": c.rows, "summary": summ}
                for num, (c, summ, _) in results.items()}},
            indent=1, default=str))
    if failed:
        print("chip_smoke: " + "; ".join(failed), file=sys.stderr)
        return None
    return only_kernels(results)


def run(device, card: str, json_path) -> list:
    """Every phase after `device`, on `device`; writes the full report to
    json_path (if given) and returns the kernels line's entries."""
    build_s, ptxas = build_phase()

    phase("kernels vs plain")
    data, sd = seeded_weights()
    sd_t = t_weights()
    model256 = build_model(sd, RES_SERVE, device)
    kchecks = kernel_phase(model256, device)
    kchecks.raise_if_failed("kernels")
    model_t = build_model(sd_t, RES_SERVE, device, "Uformer_T")
    t_kchecks = kernel_phase_t(model_t, model256, device)
    t_kchecks.raise_if_failed("kernels Uformer_T")
    del model256, model_t
    ai_checks = attention_image_phase(device)
    ai_checks.raise_if_failed("kernels attention_image")
    torch.cuda.empty_cache()
    sd_bc = bconv_weights()
    model_bc = build_bconv(sd_bc, device)
    dw_checks = dwconv_phase(model_bc, device)
    dw_checks.raise_if_failed("kernels dwconv3x3")
    del model_bc
    tile_checks = tile_phase(device)
    f32_tiles = f32_tile_timing(tile_checks, device, card)
    tile_checks.raise_if_failed("kernels tensor-core tiles")

    phase("golden")
    gchecks = golden_phase(data, sd, device)
    gchecks.raise_if_failed("golden")

    phase("golden conv")
    gcchecks = golden_conv_phase(device)
    gcchecks.raise_if_failed("golden conv")

    phase("serve")
    restorer, x, serve, launches, schecks = serve_phase(
        lambda: build_model(sd, RES_SERVE, device), device,
        EXPECTED_LAUNCHES, "serve")
    schecks.raise_if_failed("serve")

    phase("timing")
    rows, totals, fwd = timing_phase(restorer, x)
    del restorer, x

    phase("serve Uformer_T")
    restorer, x, serve_t, t_launches, t_schecks = serve_phase(
        lambda: build_model(sd_t, RES_SERVE, device, "Uformer_T"), device,
        T_LAUNCHES, "serve Uformer_T")
    t_schecks.raise_if_failed("serve Uformer_T")

    phase("timing Uformer_T")
    t_rows, t_totals, t_fwd = timing_phase(restorer, x)
    core = core_timing(restorer.model, device)
    del restorer, x
    torch.cuda.empty_cache()

    phase("serve B-conv")
    restorer, x, serve_bc, bc_launches, bc_schecks = serve_phase(
        lambda: build_bconv(sd_bc, device), device, BCONV_LAUNCHES,
        "serve B-conv")
    bc_schecks.raise_if_failed("serve B-conv")

    phase("timing B-conv")
    bc_rows, bc_totals, bc_fwd = bconv_timing(restorer, x)
    del restorer, x
    torch.cuda.empty_cache()

    phase("train")
    tkchecks, tschecks, train, trows, ttotals = train_phase(
        lambda: build_model(sd, RES_TRAIN, device), device, TRAIN_LAUNCHES,
        "train")

    phase("train Uformer_T")
    ttkchecks, ttschecks, train_t, ttrows, tttotals = train_phase(
        lambda: build_model(sd_t, RES_TRAIN, device, "Uformer_T"), device,
        T_TRAIN_LAUNCHES, "train Uformer_T")

    phase("train Mlp + cross-modulator")
    torch.backends.cudnn.deterministic = True
    mcchecks, _ = whole_step_checks(lambda: mlp_cross_model(device),
                                    device, BATCH_CHECK, "train Mlp + cross",
                                    MLP_CROSS_LAUNCHES)
    torch.backends.cudnn.deterministic = False
    mcchecks.raise_if_failed("train Mlp + cross")

    phase("eval")
    with tempfile.TemporaryDirectory() as tmp:
        echecks, evals, eval_launches = eval_phase(Path(tmp), sd, device,
                                                   card)
    echecks.raise_if_failed("eval")

    phase("train loop")
    with tempfile.TemporaryDirectory() as tmp:
        lchecks, loop, loop_launches = train_loop_phase(
            Path(tmp), device, card, train["kernel_ms_median"])
    lchecks.raise_if_failed("train loop")

    phase("models")
    with tempfile.TemporaryDirectory() as tmp:
        mchecks, models, model_launches = models_phase(
            Path(tmp), sd, sd_t, device, totals, fwd, serve, card)
    mchecks.raise_if_failed("models")

    phase("parallel")
    with tempfile.TemporaryDirectory() as tmp:
        pchecks, parallel, par_launches = parallel_phase(Path(tmp), sd,
                                                         device, card)
    pchecks.raise_if_failed("parallel")

    phase("geometries")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gchecks18, geometries, geom_launches = geometry_phase(
            Path(tmp), sd, device, card)
    geometries["s"] = time.perf_counter() - t0
    print(f"  phase 18 took {geometries['s']:.1f} s", flush=True)
    gchecks18.raise_if_failed("geometries")

    # phases 19-25: each raises on a failed check before the next starts
    later = {}
    for num in SELF_CONTAINED:
        later[num] = run_self_contained(num, device, card)
        later[num][0].raise_if_failed(SELF_CONTAINED[num][0])
    (gchecks19, train_geoms, tgeom_launches), \
        (gchecks20, wide, wide_launches), \
        (gchecks21, head64, head64_launches), \
        (gchecks22, head64t, head64t_launches), \
        (gchecks23, above16, above16_launches), \
        (gchecks24, heads, heads_launches), \
        (gchecks25, heads_t, heads_t_launches) = later.values()

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas,
              "kernel_checks": (kchecks.rows + t_kchecks.rows
                                + ai_checks.rows + dw_checks.rows
                                + tile_checks.rows),
              "f32_tiles": f32_tiles,
              "golden_checks": gchecks.rows + gcchecks.rows,
              "serve_checks": schecks.rows + t_schecks.rows + bc_schecks.rows,
              "serve": serve,
              "timing": rows, "forward": fwd, "timing_totals": totals,
              "serve_t": serve_t, "timing_t": t_rows, "forward_t": t_fwd,
              "timing_totals_t": t_totals, "core_timing": core,
              "serve_bconv": serve_bc, "timing_bconv": bc_rows,
              "forward_bconv": bc_fwd, "timing_totals_bconv": bc_totals,
              "train_kernel_checks": tkchecks.rows,
              "train_step_checks": tschecks.rows, "train": train,
              "train_timing": trows, "train_totals": ttotals,
              "train_t_kernel_checks": ttkchecks.rows,
              "train_t_step_checks": ttschecks.rows, "train_t": train_t,
              "train_t_timing": ttrows, "train_t_totals": tttotals,
              "train_mlp_cross_checks": mcchecks.rows,
              "eval_checks": echecks.rows, "eval": evals,
              "train_loop_checks": lchecks.rows, "train_loop": loop,
              "models_checks": mchecks.rows, "models": models,
              "parallel_checks": pchecks.rows, "parallel": parallel,
              "geometry_checks": gchecks18.rows, "geometries": geometries,
              "train_geometry_checks": gchecks19.rows,
              "train_geometries": train_geoms,
              "wide_window_checks": gchecks20.rows, "wide_windows": wide,
              "head64_checks": gchecks21.rows, "head64": head64,
              "head64_train_checks": gchecks22.rows,
              "head64_train": head64t,
              "above16_checks": gchecks23.rows, "above16": above16,
              "heads_checks": gchecks24.rows, "heads": heads,
              "heads_train_checks": gchecks25.rows,
              "heads_train": heads_t}
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(report, indent=1))

    kernels = []
    train_launches = {k: sum(kernel_count(c, k) for c in train["launches"])
                      for k in KERNELS}
    train_t_launches = {k: sum(kernel_count(c, k)
                               for c in train_t["launches"])
                        for k in KERNELS}
    timed = [("serve Uformer_B bs8 256^2 forward", totals),
             ("serve Uformer_T bs8 256^2 forward", t_totals),
             ("train Uformer_B bs32 128^2 step", ttotals),
             ("train Uformer_T bs32 128^2 step", tttotals),
             ("serve B-conv bs8 256^2 forward", bc_totals),
             ("alone at Uformer_T enc0 bs8 256^2",
              {"window_attention": core})]
    for name, (source, replaces) in KERNELS.items():
        rows_of = [r for r in kchecks.rows + t_kchecks.rows + ai_checks.rows
                   + tkchecks.rows + ttkchecks.rows + dw_checks.rows
                   + tile_checks.rows + mchecks.rows + pchecks.rows
                   + gchecks18.rows + gchecks19.rows + gchecks20.rows
                   + gchecks21.rows + gchecks22.rows + gchecks23.rows
                   + gchecks24.rows + gchecks25.rows
                   if r["kernel"] == name]
        errs = [r["err"] for r in rows_of if r["dtype"] == "fp32"]
        errs16 = [r["err"] for r in rows_of if r["dtype"] == "bf16"]
        # the first timing that has the kernel gives ms and its bound
        where, t = next((w, tt[name]) for w, tt in timed if name in tt)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": (kernel_count(launches, name)
                              + kernel_count(t_launches, name)
                              + train_launches[name]
                              + kernel_count(bc_launches, name)
                              + train_t_launches[name]
                              + kernel_count(eval_launches, name)
                              + kernel_count(loop_launches, name)
                              + sum(kernel_count(c, name)
                                    for c in model_launches.values())
                              + kernel_count(par_launches["spatial"], name)
                              + kernel_count(par_launches["ddp"], name)
                              + sum(kernel_count(c, name)
                                    for c in geom_launches.values())
                              + sum(kernel_count(c, name)
                                    for c in tgeom_launches.values())
                              + sum(kernel_count(c, name)
                                    for c in wide_launches.values())
                              + sum(kernel_count(c, name)
                                    for c in head64_launches.values())
                              + sum(kernel_count(c, name)
                                    for c in head64t_launches.values())
                              + sum(kernel_count(c, name)
                                    for c in above16_launches.values())
                              + sum(kernel_count(c, name)
                                    for c in heads_launches.values())
                              + sum(kernel_count(c, name)
                                    for c in heads_t_launches.values())),
                 "launches_serve": kernel_count(launches, name),
                 "launches_serve_t": kernel_count(t_launches, name),
                 "launches_train": train_launches[name],
                 "launches_train_t": train_t_launches[name],
                 "launches_serve_bconv": kernel_count(
                     serve_bc["launches_per_request"][0], name),
                 "launches_eval": kernel_count(eval_launches, name),
                 "launches_train_loop": kernel_count(loop_launches, name),
                 **{f"launches_{path}": kernel_count(c, name)
                    for path, c in model_launches.items()},
                 "launches_spatial": kernel_count(par_launches["spatial"],
                                                  name),
                 "launches_ddp": kernel_count(par_launches["ddp"], name),
                 "launches_ps64": kernel_count(geom_launches["ps64"], name),
                 "launches_ps32": kernel_count(geom_launches["ps32"], name),
                 "launches_e8": kernel_count(geom_launches["e8"], name),
                 "launches_win4": kernel_count(geom_launches["win4"], name),
                 "launches_flagship": kernel_count(
                     geom_launches["flagship"], name),
                 **{f"launches_train_{path}": kernel_count(c, name)
                    for path, c in tgeom_launches.items()},
                 "launches_e8_win2_step": kernel_count(
                     geom_launches["refusal_step"], name),
                 **{f"launches_win16_{path}": kernel_count(c, name)
                    for path, c in wide_launches.items()},
                 **{f"launches_head64_{path}": kernel_count(c, name)
                    for path, c in head64_launches.items()},
                 **{f"launches_e64train_{path}": kernel_count(c, name)
                    for path, c in head64t_launches.items()},
                 **{f"launches_win32_{path}": kernel_count(c, name)
                    for path, c in above16_launches.items()},
                 **{f"launches_heads_{path}": kernel_count(c, name)
                    for path, c in heads_launches.items()},
                 **{f"launches_train_heads_{path}": kernel_count(c, name)
                    for path, c in heads_t_launches.items()},
                 "max_abs_err": max(errs),
                 "bf16_max_abs_err_vs_fp32": max(errs16),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": bound_by(t),
                 "library_ms": t.get("library_ms"), "timed": where}
        if "device_ms" in t:
            entry.update(device_ms=t["device_ms"],
                         library_device_ms=t["library_device_ms"])
        if name == "dwconv3x3":
            # the main path runs the fused q/k/v form (a launch a block);
            # the per-call form (three a block) beside it
            one = bc_totals["dwconv3x3 per call"]
            entry.update(form="fused q/k/v (dwconv3x3_qkv)",
                         library="one grouped cuDNN F.conv2d, 3C outputs, "
                                 "no ReLU",
                         per_call={k: one[k] for k in (
                             "ms", "plain_ms", "bound_ms", "launches",
                             "library_ms", "device_ms",
                             "library_device_ms")})
        if name in ("window_attention", "attention_block",
                    "attention_block_bwd"):
            # windows above 8 (phases 20 and 23)
            entry["wide_source"] = "uformer_tpu_torch/csrc/attention_wide.cu"
        if name in ("window_attention", "attention_block",
                    "attention_block_bwd"):
            entry.update(core_entry(later, name, parallel))
        if name == "attention_block":
            entry["spatial"] = parallel["kernel5"]["rows"]
        if name == "attention_block_bwd":
            # its bf16 core above window 8 alone, beside SDPA's backward
            entry["wide_bwd_source"] = \
                "uformer_tpu_torch/csrc/wide_core_bwd_mma.cuh"
            entry["wide_core_rows"] = [c["bwd"] for c in wide["core_rows"]]
        if name == "window_attention":
            entry["on_path"] = ("no model path calls it (nor in the JAX "
                                "package); its bf16 register core "
                                "(window_core_mma.cuh) runs inside "
                                "attention_image's and attention_block's "
                                "narrow bodies")
            entry["more_shapes"] = [
                {k: c[k] for k in ("shape", "ms", "graph_ms", "plain_ms",
                                   "bound_ms", "library_ms")}
                for c in core["more"] + [wide["core"]]
                + head64["core_timing"] + [head64t["core"], above16["core"]]]
            entry["wide_core_rows"] = [
                {k: c[k] for k in ("shape", "shift", "ms", "graph_ms",
                                   "plain_ms", "bound_ms", "library_ms",
                                   "windows_a_block")}
                for c in wide["core_rows"]]
        for label, key, tt in (("serve Uformer_T", "serve_t", t_totals),
                               ("train Uformer_B", "train", ttotals),
                               ("train Uformer_T", "train_t", tttotals),
                               ("serve B-conv", "serve_bconv", bc_totals),
                               ("eval fp32", "eval_fp32",
                                evals["fp32_totals"]),
                               ("serve ps64", "ps64",
                                geometries["timing_totals_ps64"]),
                               ("serve ps32", "ps32",
                                geometries["timing_totals_ps32"]),
                               ("serve e8", "e8",
                                geometries["timing_totals_e8"]),
                               ("train ps64", "train_ps64",
                                train_geoms["timing_totals_ps64"]),
                               ("train e8", "train_e8",
                                train_geoms["timing_totals_e8"]),
                               ("train win4", "train_win4",
                                train_geoms["timing_totals_win4"]),
                               ("serve win16", "serve_win16",
                                wide["timing_totals"]),
                               ("train win16", "train_win16",
                                wide["train_totals"]),
                               ("serve e64", "e64",
                                head64["timing_totals_e64"]),
                               ("serve e64 train_ps 64", "e64ps64",
                                head64["timing_totals_e64ps64"]),
                               ("train e64", "train_e64",
                                head64t["timing_totals_e64"]),
                               ("train e64 train_ps 64", "train_e64ps64",
                                head64t["timing_totals_e64ps64"]),
                               ("train e64 win16", "train_e64win16",
                                head64t["timing_totals_e64win16"]),
                               ("serve e64 win16", "serve_e64win16",
                                head64t["timing_totals_serve_win16"]),
                               ("serve win32", "serve_win32",
                                above16["timing_totals"]),
                               ("train win32", "train_win32",
                                above16["timing_totals_win32"]),
                               ("serve e48", "e48",
                                heads["timing_totals_e48"]),
                               ("serve e24", "e24",
                                heads["timing_totals_e24"]),
                               ("train e48", "train_e48",
                                heads_t["timing_totals_e48"]),
                               ("train e24", "train_e24",
                                heads_t["timing_totals_e24"])):
            if name in tt and label not in where:
                entry.update({f"ms_{key}": tt[name]["ms"],
                              f"plain_ms_{key}": tt[name]["plain_ms"],
                              f"bound_ms_{key}": tt[name]["bound_ms"]})
                if "bound_fp32_ms" in tt[name]:
                    entry[f"bound_fp32_ms_{key}"] = \
                        tt[name]["bound_fp32_ms"]
        if name in ("stage", "leff"):
            # fp32 at C 64-512 (stage) and 16-512 (leff): the three-pass
            # TF32 bodies, counted by body on the eval's bs32 request
            entry["f32_source"] = ("uformer_tpu_torch/csrc/stage_f32.cu"
                                   if name == "stage" else
                                   "uformer_tpu_torch/csrc/leff_f32.cu")
            entry["f32_bodies_eval"] = evals["f32_bodies_request"][name]
        kernels.append(entry)
    return kernels


if __name__ == "__main__":
    sys.exit(main())
