"""Smoke run of the PyTorch port (`passl_tpu_torch`) on one NVIDIA GPU.

Run from the repo root:  python3 chip_smoke.py

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from passl_tpu_torch/csrc/ with nvcc (sm_90a),
   one nvcc per source, side by side, in a thread; meanwhile it takes every
   SSL and classification phase's first step on the card and on the CPU in
   f32 and f64 (phases 14-39 below hold them; no kernel runs there, and the
   nvcc processes leave most cores idle after their first seconds). The
   transformers' first steps (MoCo v3, MAE, CLIP's ViT towers, DINO, DINOv2,
   BEiT, CAE, ConvMAE's stage 3 and decoder, XCiT, the distilled DeiT,
   T2T-ViT's and LV-ViT's ViT, Mixer) run at 4 of their blocks (CvT-13's
   stage 2 at 4 of 10), and five ResNet-50 SSL methods' (MoCo v2, SimSiam,
   MoCo-BYOL, DenseCL, PixPro) at one bottleneck a stage, every width kept:
   the CPU's f64 steps set the script's floor beside the build.
3. Holds the talking-heads forward against its plain PyTorch version on the
   card at the shapes CaiT uses, through whichever of its two kernels the C
   entry point picks (warp-row for bf16 / f16 with h <= 8 and k <= 256,
   block-row otherwise), checks that two launches are bitwise equal, logs
   the warp-row kernel's registers, shared memory, blocks an SM and spills,
   times kernel and plain version at CaiT-S24's shapes and, for the record
   of its next step, the kernel alone at cait_s24_384's [16, 8, 576, 576].
   Every other timed kernel
   is timed in turns with its plain version and, where one PyTorch call
   computes the same function, that call (`library_ms`), and set against its
   bound: the larger of its bytes (each input read once, each output
   written once) over 3.35 TB/s and its products' flops over the card's
   peak for the inputs' type (989 TFLOP/s bf16/f16, 67 TFLOP/s f32).
4. Holds the talking-heads backward against its plain version at the same
   shapes (ds, dproj_l, dproj_w), through whichever of its two kernels the C
   entry point picks (the warp-row kernel for bf16 / f16 with h <= 8 and
   k <= 256, the block-row kernel otherwise; both run here), checks that two
   launches give bitwise equal weight gradients, times both at CaiT-S24's
   shapes, and logs the warp-row kernel's registers, shared memory, blocks an
   SM and spills there.
5. Holds the window-attention forward kernel against its plain version at
   Swin-T's four stage shapes (serving batch 32, training batch 128), with no
   mask, one mask for every group, d = 59 and 64, and Swin-B's head counts,
   in bf16 and f32, and times both at each of Swin-T's four stage shapes with
   128 images in bf16 (stage 1 in f32 too), and the stages weighted by their
   blocks as one training step's time in the kernel.
6. The same for the window-attention backward kernel (dq, dk, dv, and dbias
   within 1e-4 of its largest entry), checking that two launches are bitwise
   equal. Both window phases time F.scaled_dot_product_attention beside the
   kernels, with q as [B/nWm, nWm, h, L, d] and bias + mask as a float
   attn_mask [nWm, h, L, L] (bias alone at stage 4, which has no mask).
6b. Holds the flash-attention forward kernel (out, m, l) and its dK/dV and
   dQ backward kernels against their plain versions at the ViT family's
   shapes (ViT-B/16 at 32 and 128 images in bf16 and f32, ViT-B/32, ViT-B/16
   at 384, ViT-L/16, ViT-H/14, ViT-g/14, MoCo v3 ViT-S, 65 tokens, 4,096
   tokens, one f16 case, and the shapes of the ViT family's other paths in
   bf16: the MAE-B/16 decoder (256, 197, 16, 32), ViT-L/16 at 384 (32, 577,
   16, 64) and DeiT-B distilled (32, 198, 12, 64), each also timed against
   its plain versions and SDPA), with q, k, v read as views of one qkv tensor as
   the model hands them, logs the tensor-core kernels' registers, shared
   memory and blocks an SM, checks that all three kernels are bitwise the
   same on a second launch, and times them at ViT-B/16's 128 images against
   their plain versions and F.scaled_dot_product_attention (forward;
   backward; forward + backward through autograd).
7. Serves CaiT-S24 at 224 through the user's entry points: the export CLI's
   `main` on configs/classification/cait_s24_224_in1k.yaml (random weights
   from Global.seed), then `Predictor(device="cuda")` answering 4 requests of
   32 images. Checks that every self-attention block went through the kernel,
   that the logits are finite, and that they agree with the same weights
   served through the plain version (th_impl=einsum), in bf16 and in f32.
   Prints each path's request latency, its split into preprocess / predict /
   postprocess, and a torch.profiler view of one more request (device busy
   time, idle share, the kernels that take the most device time).
8. Serves Swin-T at 224 the same way from
   configs/classification/swin_tiny_patch4_window7_224_in1k.yaml with
   Model.attn_impl=fused: 12 window-attention launches per forward, finite
   logits, top-5; and against the same weights through the einsum path in
   the config's bf16, at softmax_dtype=float32, and in f32.
9. Trains CaiT-S24 at 224, full width and depth, bf16, through
   `Engine(config, mode="train", device="cuda").train()` as tools/train does,
   on the same config with synthetic images in place of ImageNet (the
   config's own transforms, RepeatedAugSampler and Mixup/Cutmix), batch 64,
   8 steps. Checks: the first step's per-parameter gradients of the kernel
   path against the plain path (th_impl=einsum) from the same seed and batch;
   every loss finite; 24 forward and 24 backward kernel launches per step;
   the checkpoint resumes with its step, through the engine's loader with 2
   workers and no prefetch thread left after it; the eval loop gives top-1
   and top-5 over 256 images. Prints both paths' step time, images/s, reader-cost
   share and peak memory, and a torch.profiler view of one step of each.
10. Trains Swin-T at 224 the same way, full width and depth, bf16, batch 128
   (the recipe's per-card batch), 8 steps, with Model.attn_impl=fused: 12
   forward and 12 backward launches per step, first-step gradients against
   the einsum path at softmax_dtype=float32 (overall and for each of the 12
   relative_position_bias_tables), resume, eval; and the device busy time of
   one profiled step on the fused path and on the einsum path.
11. Serves ViT-B/16 at 224 from configs/classification/vit_base_patch16_224_in1k.yaml
   with Model.attn_impl=flash as Swin-T is served: 12 flash forward
   launches per forward, and the same weights through the einsum path in
   bf16 (cosine >= 0.999), at softmax_dtype=float32 (>= 0.9999) and in f32.
12. Trains ViT-B/16 at 224 the same way, full width and depth, bf16, batch
   128 (4,096 over the 32 cards of the recipe), drop path 0.1 and EMA, 8
   steps, with Model.attn_impl=flash: 12 forward, 12 dK/dV and 12 dQ
   launches per step, first-step gradients against the einsum path at
   softmax_dtype=float32 (overall and for each of the 12 attn.qkv.weight),
   resume, eval.
13. Holds the fused augmentation kernels (`fused_augment`, BYOL's device
   recipe in one pass; the fast kernel for its compiled radii and channel
   counts, the generic kernel for the rest) against their plain version on
   the same draws, at BYOL's views [128, 224, 224, 3] with view 1's settings
   (blur 1.0, solarize 0.0) and view 2's (blur 0.1, solarize 0.2),
   [256, 32, 32, 3], a non-square [8, 160, 224, 3], [4, 16, 16, 3] at 23
   taps (every position an edge), one channel, taps 1, 3, 4 and 25, an image
   lower than the radius with an odd row width, a misaligned contiguous view,
   one channel at a compiled radius, two channels (generic) and the widest
   row the generic kernel takes, with deterministic and random settings:
   every entry within one bf16 ulp, the share of bitwise equal entries and
   the kernel printed, two launches bitwise equal, identical images with
   other draws different, and at 4,096 images the blur and solarize rates
   within 4 sigma of their probabilities. Logs the fast kernel's registers,
   shared memory, blocks an SM and spills at BYOL's shape. Its path is its
   own op (the JAX package calls it from no model): the op's entry point on
   BYOL's two views is the path whose launches are counted. Times it at
   both views from a replayed CUDA graph (the loop's reading beside it)
   against its plain version, and, as context only, the port's plain
   `byol_device_augment` on two such views.
14. Trains BYOL ResNet-50 at 224, full width and depth, through
   `Engine(config, mode="train", device="cuda").train()` on
   configs/byol/byol_r50_in1k.yaml with synthetic images in place of
   ImageNet (the config's own two-view transforms), batch 128 per view, bf16,
   use_device_augment, MomentumLARS and the cosine EMA, 8 steps. Checks:
   every loss finite and in [0, 8]; after every step each target parameter
   is m(t) target + (1 - m(t)) online in f32; the target has no optimizer
   state; the BatchNorm statistics of both towers moved; the checkpoint
   resumes at its step; and the first step's loss and gradients on the card
   against the same step on the CPU from the same init and batch, in f32 and
   in f64 (4 pairs, no device augmentation), beside f32 against f64 on the
   CPU as the yardstick of f32's rounding. Prints step time, pairs/s and
   views/s, reader share, peak memory, and device busy, idle share and top
   kernels of one profiled step.
15. Trains SimCLR ResNet-50 the same way on configs/simclr/simclr_r50_in1k.yaml:
   128 pairs, bf16, use_device_augment at jitter strength 1.0, MomentumLARS
   and simclrCosineWarmup, 8 steps. Checks: every loss finite and every acc1
   in [0, 1]; the BatchNorm statistics of the backbone and the neck moved;
   resume; the first step card vs CPU (4 pairs, no device augmentation) in
   f32 and f64 with BYOL's limits; and the plain `simclr_device_augment_core`
   on the card against the CPU on the same draws at [128, 224, 224, 3]
   within 1e-5 of the views' largest magnitude.
16. Trains MoCo v2 ResNet-50 the same way on configs/moco/mocov2_r50_in1k.yaml:
   the config's batch of 256 in 8 BatchNorm splits, K = 65,536, Momentum
   SGD, bf16, 8 steps. Checks: after every step each encoder_k parameter is
   0.999 k + 0.001 q in f32, queue_ptr is 256 t mod 65,536, the 256 keys
   written are unit-norm and every column not yet written holds its init
   bitwise; encoder_k has no optimizer state; both encoders' BatchNorm
   statistics moved; every loss finite and every acc1 in [0, 1]; the resumed
   engine starts from the checkpoint's queue and pointer bitwise; the first
   step card vs CPU at 16 images (2 a split) with one permutation handed to
   both devices, in f32 and f64.
17. Trains SimSiam ResNet-50 the same way on configs/simsiam/simsiam_r50_in1k.yaml:
   128 pairs (512 over the 4 cards of the recipe), bf16, Momentum SGD, 8
   steps. Checks: every loss finite and in [-1, 1]; the BatchNorm statistics
   of the encoder and the predictor moved; resume; the first step card vs
   CPU (4 pairs) in f32 and f64 with BYOL's limits (the loss's difference
   on the scale of its cosines, 1, where their mean cancels), the card's
   f32 at least as close to f64 as the CPU's f32 (in 14-16 the card's
   and the CPU's f32 agree at least as well as the CPU's f32 and f64).
18. Trains MoCo-BYOL ResNet-50 the same way on
   configs/moco_byol/moco_byol_r50_in1k.yaml: 128 pairs, K = 65,536, dim
   256, MomentumLARS, the cosine EMA from 0.99, bf16, 8 steps. Checks: after
   every step each target parameter is m(t) target + (1 - m(t)) online in
   f32; queue_ptr is 128 t mod K, the keys written are unit-norm and every
   column not yet written holds its init bitwise; the target has no
   optimizer state; the statistics of both towers and the predictor moved;
   loss = byol_loss + contrast_loss at the config's weights; the resumed
   queue and pointer bitwise; the first step card vs CPU in f32 and f64 at
   16 pairs, as SimSiam's. Logs the decode and resize backends the host
   transforms ran.
19. Trains SwAV ResNet-50 the same way on configs/swav/swav_r50_in1k.yaml:
   64 images of 2 x 224 + 6 x 96 crops, 3,000 prototypes, MomentumLARS,
   bf16, 8 steps, the prototypes frozen for 4 (the config's 313 never ends
   in 8 steps). Checks: the prototypes do not move over steps 1-4 (beyond
   the renormalization's rounding, 1e-6) and move over steps 5-8; every
   prototype's norm within 1e-5 of 1 after every step; the stem BatchNorm
   takes two batches a step (one per resolution); the sinkhorn target on the
   card against the CPU on the same f32 scores (1e-5 relative) with each
   sample's row summing to 1 within 1e-5; resume; the first step card vs CPU
   (8 images, 64 crops) in f32 and f64, as SimSiam's. Prints images/s and
   crops/s.
20. Trains DenseCL ResNet-50 the same way on configs/densecl/densecl_r50_in1k.yaml:
   the config's batch of 256 in 8 BatchNorm splits, two queues of 128 x
   65,536 on one pointer, Momentum SGD, bf16, 8 steps. Checks: the EMA rule
   (0.999) after every step; queue_ptr is 256 t mod K, and in both queues the
   256 columns written at step t (the same ones) are unit-norm and every
   column not yet written holds its init bitwise; encoder_k has no optimizer
   state; both encoders' statistics moved; loss = 0.5 loss_single + 0.5
   loss_dense; the resumed queues and pointer bitwise; the first step card vs
   CPU at 16 images with one permutation handed to both devices, in f32 and
   f64, the card's f32 error from f64 within twice the CPU's.
21. Trains PixPro ResNet-50 the same way on configs/pixpro/pixpro_r50_in1k.yaml:
   128 pairs (1,024 over the 8 cards of the recipe) from PixPro's two-crop
   host transform with its boxes, MLP2d 2048 -> 4096 -> 256, MomentumLARS,
   the cosine EMA from 0.99, bf16, 8 steps. Checks: the model took the
   views and both views' boxes on the card in f32, some boxes flipped; the
   EMA rule; the key tower has no optimizer state; the statistics of both
   towers moved; every loss finite and in [-4, 4]; resume; the first step
   card vs CPU at 4 pairs, as DenseCL's.
22. Trains FastMoCo ResNet-18 the same way on
   configs/moco/fastmoco_r18_synthetic.yaml as it stands (the CIFAR stem,
   32 x 32, 128 pairs, 2 x 2 patches, 6 combinations, Momentum SGD, bf16),
   on 1,024 synthetic images, 8 steps. Checks: the predictor takes 6 x 128
   combined queries twice a step; the EMA rule (cosine from 0.99); the target
   has no optimizer state; the statistics of both towers and the predictor
   moved; resume; the first step card vs CPU at 8 pairs, as DenseCL's.
23. Serves DeiT-B distilled at 224 (198 tokens) from
   configs/classification/deit_base_patch16_224_in1k.yaml with the model
   named DeiT_base_distilled_patch16_224, as ViT-B/16 is served: 12 flash
   launches per forward, and the einsum path on the same weights in bf16
   (cosine >= 0.999), at softmax_dtype=float32 (>= 0.9999) and in f32.
24. Trains ViT-L/16 at 384 (577 tokens) from
   configs/classification/vit_large_patch16_384_ft_in1k.yaml with
   Model.attn_impl=flash, bf16, 32 images, 12 of its 24 blocks (a cut for
   the script's time): the first step's gradients under
   remat_policy nothing, dots_no_batch and dots against no remat from one
   init, batch and generator state (drop path 0.1), cosine >= 0.99999 and
   whether they are bitwise, each run's peak memory (nothing and
   dots_no_batch below no remat) and flash launches (the forward's doubled
   under remat); then 4 steps of the config (dots_no_batch): 24 forward, 12
   dK/dV and 12 dQ launches a step, step time, images/s, a profiled step.
25. Trains MoCo v3 ViT-B/16 the same way as the SSL phases on
   configs/mocov3/mocov3_vit_base_in1k.yaml with Model.encoder.attn_impl=flash:
   128 pairs, AdamW, bf16, 8 steps. Checks: the EMA rule after every step on
   every momentum parameter, the inert predictor's included; the momentum
   tower has no optimizer state; with stop_grad_conv1 the patch embedding
   moves by AdamW's decay alone and its bias not at all; loss finite, acc1 in
   [0, 1]; 48 forward, 24 dK/dV and 24 dQ launches a step; the flash path's
   first-step gradients against the einsum path's at 4 of the 12 blocks
   (cosine >= 0.999; 16 / 8 / 8 launches); resume;
   the first step card vs CPU at 4 pairs and 4 of the 12 blocks in f32 and
   f64 (einsum path), the card's f32 error from f64 at most 20 times the
   CPU's.
26. Trains MAE ViT-B/16 on configs/mae/mae_vit_base_in1k.yaml with
   Model.attn_impl=flash: 256 images, AdamW, bf16, 8 steps. Checks: every
   mask holds 147 of 196 patches and every ids_restore is a permutation; the
   encoder's 50 tokens take einsum (the JAX package's warning), the decoder's
   197 the flash kernels, 8 launches of each a step; loss finite; resume; the
   first step card vs CPU at 4 images in f32 and f64 with one noise handed to
   both devices, the card's f32 error from f64 at most twice the CPU's.
27. Trains CLIP ViT-B/32 on configs/clip/clip_vit_b32_in1k.yaml with
   SyntheticTextImageDataset in place of its captioned images (the config's
   bicubic crops and CLIP's normalization; 77 tokens of a 49,408 vocabulary):
   256 pairs, AdamW, bf16, 8 steps, no flash kernel (the JAX model attends
   with einsum). Checks: the tokens reach the card as int32; the config's
   no-decay names select logit_scale and both embeddings; the first step's
   loss within 1 of ln 256 and its logit scale 1 / 0.07; acc1 in [0, 1];
   the text tower causal in f32 (tokens after each EOT move no feature, one
   before it moves every feature); resume; the first step card vs CPU at 4
   pairs in f32 and f64, and the same for the ModifiedResNet tower
   (CLIP_r50's own vision settings with the config's text tower), the
   card's f32 error from f64 (the gradients' relative distance) at most
   twice the CPU's.
28. Trains DINO ViT-S/16 on configs/dino/dino_vit_s16_pretrain_in1k.yaml:
   64 images of 2 x 224 + 8 x 96 crops, 65,536 prototypes, AdamW with
   global-norm clip 3, bf16, 8 steps. Checks: the EMA rule (cosine from
   0.996) on every teacher parameter after every step; the teacher has no
   optimizer state; after every step `center` is 0.9 of itself plus 0.1 of
   the mean of the teacher's outputs; 2 student forwards (one per
   resolution) and 1 teacher forward a step; resume with `center` bitwise as
   saved; the first step card vs CPU at 4 images of 10 crops and 4 of the 12
   blocks, as CLIP's.
29. Trains DINOv2 ViT-S/14 on configs/dinov2/dinov2_vit_s14_pretrain_in1k.yaml:
   32 images of 2 x 224 + 8 x 98 crops, LayerScale 1e-5, bf16, 8 steps.
   Checks: the masked shares of the 256 patches of every global crop (each
   within 6 binomial sd of 0.3, their mean within 0.01, their spread within
   a quarter of the binomial's); the teacher's mask token takes no gradient
   and moves by the EMA rule alone; loss = dino + ibot + 0.1 koleo; both
   centers follow their rule; 9 student forwards (the globals, then each
   local) and 1 teacher forward a step; `layerwise_decay: 0.9` warns and
   decays nothing, as in JAX; resume with both centers bitwise; the first
   step card vs CPU at 4 images and 4 of the 12 blocks with one mask noise
   handed to both devices (at LayerScale 1.0: at 1e-5 KoLeo's f32 distance
   goes negative at init in both packages' formula).
30. Trains BEiT-B/16 on configs/beit/beit_base_patch16_224_in1k.yaml with a
   random tokenizer (Global.pretrained_model empty: the config's dVAE weights
   are a JAX file the port does not read): 64 images of two views and a
   block mask of up to 75 of 196 patches, the frozen dVAE tokenizer's 8,192
   tokens on its 28 x 28 grid, AdamW with clip 3, bf16, 8 steps, no kernel
   (the JAX model attends with its own einsums). Checks: the recipe's model
   (12 blocks of 768 with LayerScale 0.1 and drop path 0.1, the relative
   position bias, a tokenizer without decoder); every mask holds 1 to 75
   patches; the loss is the cross-entropy of the masked patches alone; the
   tokenizer bitwise unchanged after 8 steps and without optimizer state;
   resume; the first step card vs CPU at 4 images in f32 and f64 (no drop
   path: the two devices' generators draw other masks), the target ids of
   the f32 runs compared position by position with their top-2 margins.
   Before it, the standalone dVAE's first step (configs/beit/
   dvae_tokenizer_in1k.yaml: 4 images, one gumbel draw handed to both
   devices) card vs CPU in f32 and f64.
31. Trains CAE-B/16 the same way on configs/cae/cae_base_patch16_224_in1k.yaml:
   64 images, 98 of 196 patches masked, 4 regressor blocks, bf16, 8 steps.
   Checks: ids_vis and ids_mask a permutation in every image; the encoder's
   blocks over 98 tokens, then the teacher's over 196, each step; the share
   of masks short of 98 (their last visible patches fill ids_mask, as in
   JAX); loss = token + 2 align; the tokenizer frozen; resume; the first step
   card vs CPU with the target ids compared.
32. Trains ConvMAE-B on configs/convmae/convmae_base_in1k.yaml: 128 images,
   147 of 196 masked, bf16, 8 steps. Checks: every mask keeps 49 patches and
   at each of the 4 CBlocks' depthwise inputs the masked positions of its
   56 x 56 or 28 x 28 grid are zero; resume; the first step card vs CPU with
   one noise handed to both devices.
33. Trains XCiT-S12/16 on configs/xcit/xcit_small_12_p16_224_in1k.yaml with
   synthetic images (the config's DeiT transforms and Mixup / Cutmix, CE with
   smoothing 0.1, AdamW with the global-norm clip): 128 images, bf16, 8 steps,
   no kernel (XCA is two einsums, as in JAX). Checks: the recipe's model; no
   kernel launched; the 12 LPI BatchNorms' statistics moved; resume; the first
   step card vs CPU at 4 images without stochastic depth in f32 and f64, the
   card's f32 distance from f64 at most twice the CPU's; then the trained
   weights through export and Predictor in bf16 and in f32 on 4 requests of
   32 images, the bf16 logits at cosine >= 0.999 of the f32 ones.
34. Trains ConvNeXt-B on configs/classification/convnext_base_in1k.yaml the
   same way: 128 images, drop path 0.5, the full-model EMA, bf16, 8 steps;
   no kernel launched; resume; the first step card vs CPU at 6 of its 36
   blocks (every width kept).
35. Trains DeiT-B distilled from a RegNetY-4GF teacher on
   configs/distill/deit_base_distilled_in1k.yaml (DistillationWrapper, hard
   distillation, alpha 0.5) on the label-free loop: 64 images, bf16, 8 steps,
   the student on einsum attention at 198 tokens (as in JAX), no kernel
   launched. Checks: after every step the logged loss equals 0.5 CE(student,
   labels) + 0.5 CE(student, argmax teacher) recomputed in f32 from the step's
   logits to 1e-6; after 8 steps the teacher's parameters and BatchNorm
   buffers are bitwise unchanged, it holds no optimizer state and stays in
   eval mode; one pass of the eval loop returns the student's logits bitwise;
   resume; the first step card vs CPU (the student without stochastic depth),
   as XCiT's. Prints the student's top-1 agreement with the teacher a step.
   Every SSL and classification phase from 14 on logs `[time]` lines: where
   its time goes (the first steps, the main path, the profiled step, the
   resume).
36. Trains CvT-13 on configs/cvt/cvt_13_224_in1k.yaml as XCiT (the DeiT
   transforms, Mixup / Cutmix, CE with smoothing 0.1, AdamW with the clip):
   128 images, bf16, 8 steps, no kernel (its attention is an einsum, as in
   JAX). Checks: depths 1, 2, 10 of 64, 192, 384 in 1, 3, 6 heads; (queries,
   keys) of each stage (3,136, 784), (784, 196), (197, 50); resume; the first
   step card vs CPU at stage 2's 4 of 10 blocks.
37. Trains T2T-ViT-14 on configs/t2t_vit/t2t_vit_14_in1k.yaml the same way
   (drop path 0.1): the performer stages over 3,136 and 784 tokens, the ViT
   over 197; both performers' `w` take a finite, nonzero gradient and move;
   resume; the first step card vs CPU, and t2t_vit_t_14's (the only run of
   TokenAttention over 3,136 tokens on the card), the T2T stages whole and
   the ViT at 4 blocks.
38. Trains LV-ViT-S with token labeling on
   configs/lvvit/lvvit_s_token_label_in1k.yaml on the label-free loop, the
   dataset swapped for SyntheticTokenLabelDataset (1,024 images at 224, a 14
   x 14 grid, top-5 labels, ImageNet's normalization): 128 images, bf16, 8
   steps, no kernel. Checks: the {image, label, token_value, token_idx}
   batch on the card; MixToken boxed at least one step and left at least
   one unboxed (logged); the logged loss is loss_cls + 0.5 loss_aux to
   1e-6; the stem BatchNorms' statistics moved; resume; the trained weights
   served as `lvvit_s` through export and Predictor in bf16 and f32 (cosine
   >= 0.999), and loaded strictly into `lvvit_s`, whose f32 eval logits
   equal the token-label model's bitwise; the first step card vs CPU with
   one MixToken box handed to both devices.
39. Trains Mixer-B/16 on configs/mlp_mixer/mlp_mixer_b16_224_in1k.yaml the
   same way as CvT: 128 images, bf16, 8 steps, no kernel; resume; the first
   step card vs CPU at 4 of its 12 blocks, the head (zeros at init, as in
   JAX) drawn at std 0.02 there so that the backward reaches every block.
40. Prints the card line, a JSON line of the eight kernels' results, and
   last the contract line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero; it prints no result line
then. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import tempfile
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from passl_tpu_torch.data import build_dataloader, to_device
from passl_tpu_torch.data.datasets import SyntheticTextImageDataset
from passl_tpu_torch.data.loader import PREFETCH_THREAD
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.engine.inference import Predictor
from passl_tpu_torch.ops import _build
from passl_tpu_torch.engine import engine as engine_mod
from passl_tpu_torch.models import beit, build_model, dino, discrete_vae, mae, moco, t2t_vit
from passl_tpu_torch.nn.layers import Attention
from passl_tpu_torch.nn.norm import SplitBatchNorm
from passl_tpu_torch.ops.augment import (byol_device_augment, simclr_device_augment_core,
                                         simclr_draws)
from passl_tpu_torch.ops.augment_kernel import (fused_augment, fused_augment_draws,
                                                fused_augment_kernel_for, fused_augment_ref,
                                                fused_augment_resources,
                                                fused_augment_with_draws)
from passl_tpu_torch.ops.attention import (flash_attention, flash_attention_di,
                                           flash_attention_dkv, flash_attention_dkv_ref,
                                           flash_attention_dq, flash_attention_dq_ref,
                                           flash_attention_fwd, flash_attention_fwd_ref,
                                           flash_kernel_resources, resolve_attn_impl)
from passl_tpu_torch.ops.talking_heads import (talking_heads_bwd_kernel_for,
                                               talking_heads_bwd_resources,
                                               talking_heads_fwd_kernel_for,
                                               talking_heads_fwd_resources,
                                               talking_heads_softmax, talking_heads_softmax_bwd,
                                               talking_heads_softmax_bwd_ref,
                                               talking_heads_softmax_ref)
from passl_tpu_torch.ops.window_attention import (fused_window_attention,
                                                  fused_window_attention_bwd,
                                                  window_attention_bwd_ref, window_attention_ref)
from passl_tpu_torch.tools import export
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.cuda_timing import graph_ms, loop_ms

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "classification", "cait_s24_224_in1k.yaml")
MODEL_NAME = "cait_s24_224"
DEPTH = 24  # talking-heads blocks of CaiT-S24: one kernel launch each per forward
SWIN_CONFIG = os.path.join(REPO, "configs", "classification",
                           "swin_tiny_patch4_window7_224_in1k.yaml")
SWIN_NAME = "swin_tiny_patch4_window7_224"
SWIN_BLOCKS = 12  # Swin-T's window-attention blocks: one kernel launch each per forward
BATCH, REQUESTS = 32, 4
IMG, NUM_CLASSES = 224, 1000
NORMALIZE = [{"NormalizeImage": {"scale": 1.0 / 255, "mean": [0.485, 0.456, 0.406],
                                 "std": [0.229, 0.224, 0.225]}}]
# kernel vs plain version. f32: both sum the same f32 terms in another
# order. bf16/f16: both round the same f32 value once, so they differ by at
# most one unit in the last place of the stored type (bf16 2^-8 relative, as
# in tests/test_talking_heads_kernel.py; f16 2^-11, doubled).
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
# the talking-heads forward (atol, rtol): its outputs are probabilities mixed
# over heads, about 1/k each, below TOL's atol. One ulp of the stored type is
# at most 2^-7 of the value in bf16 and 2^-10 in f16; the two f32 values
# before that rounding (__expf against expf, sums in another order) differ by
# under 1e-5, for which atol leaves ten times room. f32 as TOL.
FWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 2**-7),
           torch.float16: (1e-4, 2**-10)}
# (shape, dtype): CaiT-S24 at 224 (h=8, q=k=196) at batch 64 and at the
# serving batch of 32; the small (2, 4, 49, 49); cait_xs24_384's 6 heads over
# 576 tokens in f16; cait_m36/m48's 16 heads over the longest rows (784).
CASES = [
    ((64, 8, 196, 196), torch.bfloat16),
    ((64, 8, 196, 196), torch.float32),
    ((BATCH, 8, 196, 196), torch.bfloat16),
    ((2, 4, 49, 49), torch.float32),
    ((2, 4, 49, 49), torch.bfloat16),
    ((4, 6, 576, 576), torch.float16),
    ((2, 16, 784, 784), torch.bfloat16),
]
LONG_ROW_CASE = (16, 8, 576, 576)  # cait_s24_384's scores at 16 images: timed alone, bf16
SERVE_CASE = ((BATCH, 8, 196, 196), torch.bfloat16)  # what the serving path hands the kernel
TRAIN_BATCH, TRAIN_STEPS = 64, 8
TRAIN_CASE = ((TRAIN_BATCH, 8, 196, 196), torch.bfloat16)  # what the train step hands both kernels
SWIN_TRAIN_BATCH = 128  # the recipe's per-card batch: 1,024 over 8 cards
# window attention (B, h, L, d, nWm): Swin-T's stages 1-4 at 128 and at 32
# images (stage i packs 2 windows into L = 98 and cycles nWm = 32, 8, 2 masks;
# stage 4's window covers its map: L = 49, no mask); one mask for every
# group; swin_huge's d = 59 and swin_giant's d = 64 (2 images, stage 1);
# Swin-B's 4 and 32 heads (stages 1 and 4, 32 images)
WATTN_SHAPES = [
    (4096, 3, 98, 32, 32), (1024, 6, 98, 32, 8), (256, 12, 98, 32, 2), (128, 24, 49, 32, None),
    (1024, 3, 98, 32, 32), (256, 6, 98, 32, 8), (64, 12, 98, 32, 2), (32, 24, 49, 32, None),
    (64, 4, 98, 32, 1), (64, 6, 98, 59, 32), (64, 8, 98, 64, 32),
    (1024, 4, 98, 32, 32), (32, 32, 49, 32, None),
]
WATTN_TIMED = (4096, 3, 98, 32, 32)  # Swin-T stage 1, 128 images: timed in bf16 and f32
# Swin-T's four stages at 128 images (window-attention blocks per stage): each
# timed in bf16, and weighted by its blocks into the kernels' time per step
WATTN_STAGES = {(4096, 3, 98, 32, 32): 2, (1024, 6, 98, 32, 8): 2, (256, 12, 98, 32, 2): 6,
                (128, 24, 49, 32, None): 2}
DBIAS_TOL = 1e-4  # dbias: f32 sums over B groups in another order, of the largest entry
VIT_CONFIG = os.path.join(REPO, "configs", "classification", "vit_base_patch16_224_in1k.yaml")
VIT_NAME = "ViT_base_patch16_224"
VIT_BLOCKS = 12  # ViT-B/16's attention blocks: one launch of each flash kernel per forward
VIT_TRAIN_BATCH = 128  # the recipe's per-card batch: 4,096 over 32 cards
# flash attention (n, l, h, d) and type: ViT-B/16 at 224 with 32 and 128
# images; ViT-B/32 (50 tokens, below the resolver's 65); ViT-B/16 at 384;
# ViT-L/16; ViT-H/14 (d = 80); ViT-g/14 (d = 104); MoCo v3 ViT-S (d = 32);
# the resolver's shortest flash sequence; 4,096 tokens, where `auto` turns
# to flash; ViT-L/16 in f16
FLASH_TIMED = (128, 197, 12, 64)  # ViT-B/16 training: timed in bf16 and f32
# the shapes the ViT family's other paths hand the kernels, each timed in bf16:
# the MAE-B/16 decoder (256 images, 197 tokens, 16 heads of 32), ViT-L/16 at
# 384 (32 images, 577 tokens) and DeiT-B distilled (198 tokens)
MAE_DECODER_SHAPE = (256, 197, 16, 32)
VITL384_SHAPE = (32, 577, 16, 64)
DEIT_SHAPE = (32, 198, 12, 64)
FLASH_PATH_TIMED = (MAE_DECODER_SHAPE, VITL384_SHAPE, DEIT_SHAPE)
FLASH_CASES = [
    ((32, 197, 12, 64), torch.bfloat16), ((32, 197, 12, 64), torch.float32),
    (FLASH_TIMED, torch.bfloat16), (FLASH_TIMED, torch.float32),
    ((32, 50, 12, 64), torch.bfloat16), ((8, 577, 12, 64), torch.bfloat16),
    ((16, 197, 16, 64), torch.bfloat16), ((4, 257, 16, 80), torch.bfloat16),
    ((2, 257, 16, 104), torch.bfloat16), ((16, 197, 12, 32), torch.bfloat16),
    ((2, 65, 2, 32), torch.float32), ((2, 4096, 8, 64), torch.bfloat16),
    ((16, 197, 16, 64), torch.float16),
    *((shape, torch.bfloat16) for shape in FLASH_PATH_TIMED),
]
# m and l: f32 sums and maxima of the same products taken in another order
STAT_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM dense peaks: tensor cores for bf16/f16, the CUDA cores for f32
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def _span(tag: str, what: str):
    """Logs the seconds the block took: where a phase's time goes."""
    t0 = time.perf_counter()
    yield
    log(f"[time] {tag} {what}: {time.perf_counter() - t0:.1f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    card = card_line()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # every f32 comparison below is in full f32: cuDNN convolutions default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build() -> None:
    _build.load()
    info = _build.build_info
    for cmd in info["commands"]:
        log("[build] " + " ".join(cmd))
    if info["log"]:
        log(info["log"].strip())
    log(f"[build] {info['seconds']:.2f} s -> {info['path']} (built={info['built']})")


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    h = shape[1]
    s = torch.tensor(rng.randn(*shape) * 3.0, dtype=dtype, device="cuda")
    wl = torch.tensor(rng.randn(h, h) * 0.2 + np.eye(h), dtype=torch.float32, device="cuda")
    ww = torch.tensor(rng.randn(h, h) * 0.2 + np.eye(h), dtype=torch.float32, device="cuda")
    return s, wl, ww


def _bound(nbytes: int, flops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or the
    products' flops over the peak for the inputs' type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _time_pair(kernel, plain, nbytes: int, flops: float, dtype: torch.dtype,
               library: Optional[Callable] = None, kernel_timer: Callable = loop_ms) -> dict:
    """Kernel, plain version and (where there is one) the PyTorch call that
    computes the same function, timed in turns (plain, kernel, library,
    library, kernel, plain), with the kernel's rate and its bound. The
    library's two turns are kept beside their mean (`library_ms_turns`): its
    time can move between turns, and a ranking against it names the reading.
    `kernel_timer` times the kernel's turns (`graph_ms` for a kernel shorter
    than its wrapper's host time)."""
    fns = (plain, kernel, library, library, kernel, plain)
    timers = (loop_ms, kernel_timer, loop_ms, loop_ms, kernel_timer, loop_ms)
    plain_a, kern_a, lib_a, lib_b, kern_b, plain_b = (
        t(f) if f is not None else None for t, f in zip(timers, fns))
    rec = {"ms": (kern_a + kern_b) / 2, "plain_ms": (plain_a + plain_b) / 2,
           "library_ms": None if library is None else (lib_a + lib_b) / 2,
           **_bound(nbytes, flops, dtype)}
    if library is not None:
        rec["library_ms_turns"] = [lib_a, lib_b]
    rec["kernel_GBps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def _fmt(rec: dict) -> str:
    return ", ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in rec.items())


def phase_kernel() -> dict:
    results = {}
    with torch.inference_mode():
        for i, (shape, dtype) in enumerate(CASES):
            s, wl, ww = _inputs(shape, dtype, seed=i)
            out = talking_heads_softmax(s, wl, ww)
            ref = talking_heads_softmax_ref(s, wl, ww)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == s.shape, f"kernel output {out.dtype} {tuple(out.shape)}")
            err = (out.float() - ref.float()).abs().max().item()
            atol, rtol = FWD_TOL[dtype]
            torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
            check(torch.equal(out, talking_heads_softmax(s, wl, ww)),
                  f"forward at {shape} {dtype}: two launches differ")
            rec = {"kernel": talking_heads_fwd_kernel_for(shape[1], shape[3], dtype),
                   "max_abs_err": err, "atol": atol, "rtol": rtol}
            if rec["kernel"] == "warp-row":
                rec["resources"] = talking_heads_fwd_resources(dtype, shape[1], shape[3])
            if shape[1:] == (8, 196, 196):  # CaiT-S24: time kernel and plain in turns
                # read s, write p; the two head mixes' products, 2 h flops per
                # score each (no PyTorch call computes this function). The
                # kernel's turns replay a CUDA graph: the wrapper's host time
                # would pace the card at 32 images; `host_paced_ms` is the
                # plain loop's reading, as a caller without a graph sees it
                rec.update(_time_pair(lambda: talking_heads_softmax(s, wl, ww),
                                      lambda: talking_heads_softmax_ref(s, wl, ww),
                                      2 * s.numel() * s.element_size(),
                                      4 * shape[1] * s.numel(), dtype, kernel_timer=graph_ms))
                rec["host_paced_ms"] = loop_ms(lambda: talking_heads_softmax(s, wl, ww))
            results[(shape, dtype)] = rec
            log(f"[kernel] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}"
                ", repeatable bitwise")
        # cait_s24_384's rows (k = 576), the block-row kernel's: for the record of its next step
        s, wl, ww = _inputs(LONG_ROW_CASE, torch.bfloat16, seed=len(CASES))
        h, k = LONG_ROW_CASE[1], LONG_ROW_CASE[3]
        rec = {"kernel": talking_heads_fwd_kernel_for(h, k, s.dtype),
               "ms": graph_ms(lambda: talking_heads_softmax(s, wl, ww)),
               **_bound(2 * s.numel() * s.element_size(), 4 * h * s.numel(), s.dtype)}
        log(f"[kernel] {LONG_ROW_CASE} bfloat16, timed alone: {_fmt(rec)}")
    return results


# backward vs plain backward: ds at TOL (one rounding of the same
# f32 value to the stored type); dproj_l / dproj_w are f32 sums over n*q*k
# products taken in another order (a fixed two-stage tree here, cuBLAS in
# the plain version): 1e-4 of the largest entry
WGRAD_TOL = 1e-4


def _wgrad_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_kernel_bwd() -> dict:
    results = {}
    for i, (shape, dtype) in enumerate(CASES):
        s, wl, ww = _inputs(shape, dtype, seed=100 + i)
        dp = torch.tensor(np.random.RandomState(200 + i).randn(*shape), dtype=dtype, device="cuda")
        ds, dwl, dww = talking_heads_softmax_bwd(s, dp, wl, ww)
        ref = talking_heads_softmax_bwd_ref(s, dp, wl, ww)
        torch.cuda.synchronize()
        check(ds.dtype == dtype and ds.shape == s.shape, f"backward ds {ds.dtype} {tuple(ds.shape)}")
        tol = TOL[dtype]
        torch.testing.assert_close(ds.float(), ref[0].float(), atol=tol, rtol=tol)
        rec = {"kernel": talking_heads_bwd_kernel_for(shape[1], shape[3], dtype),
               "max_abs_err": (ds.float() - ref[0].float()).abs().max().item(), "tol": tol,
               "dproj_l_rel_err": _wgrad_err(dwl, ref[1]), "dproj_w_rel_err": _wgrad_err(dww, ref[2]),
               "wgrad_tol": WGRAD_TOL}
        check(rec["dproj_l_rel_err"] <= WGRAD_TOL and rec["dproj_w_rel_err"] <= WGRAD_TOL,
              f"backward weight gradients at {shape} {dtype}: {rec}")
        again = talking_heads_softmax_bwd(s, dp, wl, ww)
        check(all(torch.equal(a, b) for a, b in zip((ds, dwl, dww), again)),
              f"backward at {shape} {dtype}: two launches differ")
        if shape[1:] == (8, 196, 196):  # CaiT-S24: time kernel and plain in turns
            # read s and dp, write ds; the products of the recomputed first
            # mix, the two mixes' backward and the two weight gradients, 2 h
            # flops per score each
            rec.update(_time_pair(lambda: talking_heads_softmax_bwd(s, dp, wl, ww),
                                  lambda: talking_heads_softmax_bwd_ref(s, dp, wl, ww),
                                  3 * s.numel() * s.element_size(),
                                  10 * shape[1] * s.numel(), dtype))
            # the same 5 h^2 multiply-adds a column on the CUDA cores alone (f32 peak)
            rec["cuda_core_floor_ms"] = 10 * shape[1] * s.numel() / PEAK_FLOPS[torch.float32] * 1e3
            if rec["kernel"] == "warp-row":
                rec["resources"] = talking_heads_bwd_resources(dtype, shape[1], shape[3])
        results[(shape, dtype)] = rec
        log(f"[kernel-bwd] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}"
            ", repeatable bitwise")
    return results


def _wattn_inputs(shape, dtype, seed):
    """q, k, v and do [B, h, L, d] at dtype; bias [h, L, L] f32; mask
    [nWm, L, L] of 0 and -100 as Swin's shift and pack masks, or None. Drawn
    on the card from a seeded generator (numpy takes seconds at stage 1)."""
    b, h, l, d, n_mask = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*size):
        return torch.randn(*size, generator=gen, device="cuda")

    q, k, v, do = (randn(b, h, l, d).to(dtype) for _ in range(4))
    bias = randn(h, l, l) * 0.5
    mask = None
    if n_mask:
        mask = torch.where(torch.rand(n_mask, l, l, generator=gen, device="cuda") > 0.7, -100.0, 0.0)
    return q, k, v, do, bias, mask


def _wattn_sdpa(q, k, v, bias, mask, do=None):
    """The window function as one F.scaled_dot_product_attention call: q, k, v
    as [B/nWm, nWm, h, L, d] and bias + mask as a float attn_mask [nWm, h, L,
    L] at q's type (nWm = 1 and bias alone without a mask). Returns the call,
    or with `do` the call's backward (dq, dk, dv and the mask's gradient) on a
    graph kept for repeated timing."""
    b, h, l, d = q.shape
    n_mask = 1 if mask is None else mask.shape[0]
    view = (b // n_mask, n_mask, h, l, d)
    q5, k5, v5 = (t.detach().reshape(view).clone() for t in (q, k, v))
    attn_mask = (bias[None] if mask is None else bias[None] + mask[:, None]).to(q.dtype)
    if do is None:
        return lambda: F.scaled_dot_product_attention(q5, k5, v5, attn_mask=attn_mask)
    leaves = [t.requires_grad_() for t in (q5, k5, v5, attn_mask)]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
    return lambda: torch.autograd.grad(out, leaves, do.view(view), retain_graph=True)


def _wattn_bytes_flops(q, bias, mask, tensors: int, products: int) -> tuple[int, int]:
    """`tensors` [B, h, L, d] tensors moved once plus the f32 bias and mask
    read once; `products` L x L x d products (2 flops each) per (group, head)."""
    b, h, l, d = q.shape
    extra = (bias.numel() + (0 if mask is None else mask.numel())) * 4
    return tensors * q.numel() * q.element_size() + extra, products * 2 * b * h * l * l * d


def _wattn_cases():
    return [(shape, dtype) for shape in WATTN_SHAPES for dtype in (torch.bfloat16, torch.float32)]


def _wattn_timed(shape, dtype) -> bool:
    """Every Swin-T stage in bf16; stage 1 in f32 too."""
    return shape == WATTN_TIMED or (shape in WATTN_STAGES and dtype == torch.bfloat16)


def _wattn_step_ms(results: dict, tag: str) -> dict:
    """A Swin-T training step's time in one window kernel: each stage's
    measured time (kernel, plain, SDPA, bound) times its blocks."""
    step = {key: sum(n * results[(shape, torch.bfloat16)][key] for shape, n in WATTN_STAGES.items())
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"[{tag}] Swin-T step at 128 images, bf16, {sum(WATTN_STAGES.values())} launches "
        f"weighted by stage: {_fmt(step)}")
    return step


def phase_wattn() -> dict:
    results = {}
    with torch.inference_mode():
        for i, (shape, dtype) in enumerate(_wattn_cases()):
            q, k, v, _, bias, mask = _wattn_inputs(shape, dtype, seed=300 + i)
            out = fused_window_attention(q, k, v, bias, mask)
            ref = window_attention_ref(q, k, v, bias, mask)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == q.shape, f"wattn output {out.dtype} {tuple(out.shape)}")
            tol = TOL[dtype]
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
            rec = {"max_abs_err": (out.float() - ref.float()).abs().max().item(), "tol": tol}
            if _wattn_timed(shape, dtype):  # read q, k, v and write out once; q k^T and p v
                rec.update(_time_pair(lambda: fused_window_attention(q, k, v, bias, mask),
                                      lambda: window_attention_ref(q, k, v, bias, mask),
                                      *_wattn_bytes_flops(q, bias, mask, 4, 2), dtype,
                                      library=_wattn_sdpa(q, k, v, bias, mask)))
            results[(shape, dtype)] = rec
            log(f"[wattn] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}")
            del q, k, v, bias, mask, out, ref
    torch.cuda.empty_cache()
    _wattn_step_ms(results, "wattn")
    return results


def phase_wattn_bwd() -> dict:
    results = {}
    for i, (shape, dtype) in enumerate(_wattn_cases()):
        q, k, v, do, bias, mask = _wattn_inputs(shape, dtype, seed=400 + i)
        got = fused_window_attention_bwd(q, k, v, bias, mask, do)
        want = window_attention_bwd_ref(q, k, v, bias, mask, do)
        torch.cuda.synchronize()
        tol = TOL[dtype]
        rec = {"tol": tol}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == dtype and g.shape == q.shape, f"wattn-bwd {name} {g.dtype} {tuple(g.shape)}")
            torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol, msg=name)
            rec[f"{name}_max_abs_err"] = (g.float() - w.float()).abs().max().item()
        rec["max_abs_err"] = max(rec["dq_max_abs_err"], rec["dk_max_abs_err"], rec["dv_max_abs_err"])
        rec["dbias_rel_err"] = _wgrad_err(got[3], want[3])
        rec["dbias_tol"] = DBIAS_TOL
        check(rec["dbias_rel_err"] <= DBIAS_TOL, f"wattn-bwd dbias at {shape} {dtype}: {rec}")
        again = fused_window_attention_bwd(q, k, v, bias, mask, do)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"wattn-bwd at {shape} {dtype}: two launches differ")
        if _wattn_timed(shape, dtype):
            # read q, k, v, do and write dq, dk, dv once (and dbias, h L^2 f32,
            # counted with the bias); recompute q k^T, then p^T do, do v^T,
            # ds k and ds^T q
            rec.update(_time_pair(lambda: fused_window_attention_bwd(q, k, v, bias, mask, do),
                                  lambda: window_attention_bwd_ref(q, k, v, bias, mask, do),
                                  *_wattn_bytes_flops(q, bias, mask, 7, 5), dtype,
                                  library=_wattn_sdpa(q, k, v, bias, mask, do)))
        results[(shape, dtype)] = rec
        log(f"[wattn-bwd] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}"
            ", repeatable bitwise")
        del q, k, v, bias, mask, do, got, want, again
    torch.cuda.empty_cache()
    _wattn_step_ms(results, "wattn-bwd")
    return results


def _flash_inputs(shape, dtype, seed):
    """q, k, v [n, l, h, d] as views of one qkv tensor [n, l, 3, h, d] (the
    layout ViT's Attention hands the kernels) and do [n, l, h, d], drawn on the
    card from a seeded generator."""
    n, l, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(n, l, 3, h, d, generator=gen, device="cuda").to(dtype)
    do = torch.randn(n, l, h, d, generator=gen, device="cuda").to(dtype)
    return (*qkv.unbind(2), do)


def _flash_bytes_flops(shape, dtype, tensors: int, stats: int, products: int) -> tuple[int, int]:
    """`tensors` [n, l, h, d] tensors and `stats` f32 [n, h, l] row vectors
    moved once; `products` l x l x d products (2 flops each) per (image, head)."""
    n, l, h, d = shape
    esize = torch.empty((), dtype=dtype).element_size()
    return (tensors * n * l * h * d * esize + stats * n * h * l * 4,
            products * 2 * n * h * l * l * d)


def _sdpa(q, k, v, scale):
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          scale=scale)


def _flash_resources() -> None:
    """Registers, shared memory and blocks an SM of the three tensor-core
    flash kernels at each (type, head dim) of FLASH_CASES."""
    for dtype, d in sorted({(dt, shape[-1]) for shape, dt in FLASH_CASES if dt != torch.float32},
                           key=str):
        for kernel in ("fwd", "dkv", "dq"):
            r = flash_kernel_resources(kernel, dtype, d)
            log(f"[flash] resources {kernel} {str(dtype).removeprefix('torch.')} d={d}: "
                f"{r['registers']} registers, {r['shared_bytes']} B shared, "
                f"{r['blocks_per_sm']} blocks of {r['warps']} warps an SM, "
                f"{r['spill_bytes']} B spilled")


def phase_flash() -> dict:
    _flash_resources()
    results = {}
    with torch.inference_mode():
        for i, (shape, dtype) in enumerate(FLASH_CASES):
            q, k, v, _ = _flash_inputs(shape, dtype, seed=500 + i)
            scale = shape[-1] ** -0.5
            o, m, lsum = flash_attention_fwd(q, k, v, scale)
            o_ref, m_ref, l_ref = flash_attention_fwd_ref(q, k, v, scale)
            torch.cuda.synchronize()
            check(o.dtype == dtype and o.shape == shape, f"flash output {o.dtype} {tuple(o.shape)}")
            tol = TOL[dtype]
            torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(m, m_ref, atol=STAT_TOL, rtol=STAT_TOL, msg="m")
            torch.testing.assert_close(lsum, l_ref, atol=STAT_TOL, rtol=STAT_TOL, msg="l")
            rec = {"max_abs_err": (o.float() - o_ref.float()).abs().max().item(), "tol": tol}
            again = flash_attention_fwd(q, k, v, scale)
            check(all(torch.equal(a, b) for a, b in zip((o, m, lsum), again)),
                  f"flash at {shape} {dtype}: two launches differ")
            if shape == FLASH_TIMED or shape in FLASH_PATH_TIMED:
                # read q, k, v, write o, m, l; q k^T and p v
                rec.update(_time_pair(lambda: flash_attention_fwd(q, k, v, scale),
                                      lambda: flash_attention_fwd_ref(q, k, v, scale),
                                      *_flash_bytes_flops(shape, dtype, 4, 2, 2), dtype,
                                      library=lambda: _sdpa(q, k, v, scale)))
            results[(shape, dtype)] = rec
            log(f"[flash] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}"
                ", repeatable bitwise")
            del q, k, v, o, m, lsum, o_ref, m_ref, l_ref, again
    torch.cuda.empty_cache()
    return results


def _autograd_ms(shape, dtype, seed) -> dict:
    """Forward + backward through autograd, from qkv to its gradient: the
    port's flash_attention (one forward and two backward launches) against
    F.scaled_dot_product_attention on the same views."""
    n, l, h, d = shape
    scale = d ** -0.5
    q, k, v, do = _flash_inputs(shape, dtype, seed)
    qkv = torch.stack((q, k, v), dim=2).detach().requires_grad_()
    do_flat = do.reshape(n, l, h * d)

    def port():
        qkv.grad = None
        flash_attention(*qkv.unbind(2), scale).backward(do_flat)

    def library():
        qkv.grad = None
        _sdpa(*qkv.unbind(2), scale).backward(do.transpose(1, 2))

    lib_a, port_a, port_b, lib_b = (loop_ms(f, iters=20) for f in (library, port, port, library))
    return {"autograd_ms": (port_a + port_b) / 2, "library_autograd_ms": (lib_a + lib_b) / 2}


def phase_flash_bwd() -> dict:
    results = {}
    for i, (shape, dtype) in enumerate(FLASH_CASES):
        q, k, v, do = _flash_inputs(shape, dtype, seed=600 + i)
        scale = shape[-1] ** -0.5
        with torch.no_grad():
            o, m, lsum = flash_attention_fwd_ref(q, k, v, scale)
            di = flash_attention_di(o, do)
            got = (*flash_attention_dkv(q, k, v, do, m, lsum, di, scale),
                   flash_attention_dq(q, k, v, do, m, lsum, di, scale))
            want = (*flash_attention_dkv_ref(q, k, v, do, m, lsum, di, scale),
                    flash_attention_dq_ref(q, k, v, do, m, lsum, di, scale))
            torch.cuda.synchronize()
            tol = TOL[dtype]
            rec = {"tol": tol}
            for name, g, w in zip(("dk", "dv", "dq"), got, want):
                check(g.dtype == dtype and g.shape == shape, f"flash-bwd {name} {g.dtype} {tuple(g.shape)}")
                torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol, msg=name)
                rec[f"{name}_max_abs_err"] = (g.float() - w.float()).abs().max().item()
            again = (*flash_attention_dkv(q, k, v, do, m, lsum, di, scale),
                     flash_attention_dq(q, k, v, do, m, lsum, di, scale))
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash-bwd at {shape} {dtype}: two launches differ")
            if shape == FLASH_TIMED or shape in FLASH_PATH_TIMED:
                # dK/dV reads q, k, v, do and m, l, di and writes dk, dv; it
                # recomputes q k^T, then p^T do, do v^T and ds^T q. dQ reads
                # the same and writes dq: q k^T, do v^T and ds k. The library
                # yardstick is SDPA's whole backward (dq, dk and dv in one call)
                lib = _sdpa_backward(q, k, v, do, scale)
                rec["dkv"] = _time_pair(
                    lambda: flash_attention_dkv(q, k, v, do, m, lsum, di, scale),
                    lambda: flash_attention_dkv_ref(q, k, v, do, m, lsum, di, scale),
                    *_flash_bytes_flops(shape, dtype, 6, 3, 4), dtype, library=lib)
                rec["dq"] = _time_pair(
                    lambda: flash_attention_dq(q, k, v, do, m, lsum, di, scale),
                    lambda: flash_attention_dq_ref(q, k, v, do, m, lsum, di, scale),
                    *_flash_bytes_flops(shape, dtype, 5, 3, 3), dtype, library=lib)
                del lib
        if shape == FLASH_TIMED:
            rec.update(_autograd_ms(shape, dtype, seed=700 + i))
        results[(shape, dtype)] = rec
        log(f"[flash-bwd] {shape} {str(dtype).removeprefix('torch.')}: "
            + _fmt({k: v for k, v in rec.items() if k not in ("dkv", "dq")}) + ", repeatable bitwise")
        for name in ("dkv", "dq"):
            if name in rec:
                log(f"[flash-bwd] {shape} {str(dtype).removeprefix('torch.')} {name} timed: "
                    f"{_fmt(rec[name])}")
        del q, k, v, do, o, m, lsum, di, got, want, again
    torch.cuda.empty_cache()
    return results


def _sdpa_backward(q, k, v, do, scale):
    """SDPA's backward alone (dq, dk, dv), on a graph kept for repeated timing."""
    with torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = _sdpa(*leaves, scale)
    grad = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


def _export(config: str, out_dir: str, *overrides: str) -> None:
    argv = ["-c", config, "-o", f"Global.output_dir={out_dir}"]
    for o in overrides:
        argv += ["-o", o]
    export.main(argv)


def _profile(fn, rec: Optional[dict] = None) -> str:
    """`fn()` once under torch.profiler: device busy time against its wall time
    (also into `rec` as busy_ms and wall_ms when given)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    count = 0
    for ev in prof.events():  # kernels and copies; not the ranges annotated on the device
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            count += 1
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    if rec is not None:
        rec.update(busy_ms=busy / 1e3, wall_ms=wall_us / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (f"device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
            f"({100 * (1 - busy / wall_us):.1f}% idle), {count} kernels and copies; top: "
            + "; ".join(f"{100 * t / busy:.1f}% {name[:60]}" for name, t in top))


def _serve(model_dir: str, name: str, requests, kernel) -> tuple[np.ndarray, list, int, str]:
    """Warm-up plus the requests, then one profiled request. Returns the
    requests' logits, per-request (preprocess, predict, postprocess) seconds,
    the launches of `kernel` over warm-up plus requests, and the profile line."""
    pred = Predictor(model_dir, name=name, transform=NORMALIZE, device="cuda")
    kernel.launches = 0
    pred(requests[0])  # warm-up
    logits, stages = [], []
    for imgs in requests:
        t0 = time.perf_counter()
        batch = pred.preprocess(imgs)
        t1 = time.perf_counter()
        out = pred.predict(batch)  # ends in a device-to-host copy: waits for the card
        t2 = time.perf_counter()
        res = pred.postprocess(out)
        stages.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        check(out.shape == (BATCH, NUM_CLASSES) and out.dtype == np.float32, f"logits {out.shape} {out.dtype}")
        check(bool(np.isfinite(out).all()), "non-finite logits")
        check(len(res) == BATCH and len(res[0]["class_ids"]) == 5, "top-5 results")
        logits.append(out)
    launches = kernel.launches
    prof = _profile(lambda: pred(requests[0]))
    del pred
    torch.cuda.empty_cache()
    return np.concatenate(logits), stages, launches, prof


def _report(tag: str, stages: list, prof: str) -> None:
    lat = [sum(st) for st in stages]
    mean = sum(lat) / len(lat)
    med = np.median(np.asarray(stages), axis=0) * 1e3
    log(f"[serve] {tag}: per-request latency ms " + ", ".join(f"{t * 1e3:.3f}" for t in lat)
        + f"; mean {mean * 1e3:.3f} ms, {BATCH / mean:.1f} images/s; median stages ms: "
        f"preprocess {med[0]:.3f}, predict {med[1]:.3f}, postprocess {med[2]:.3f}")
    log(f"[profile] {tag}: {prof}")


def _requests() -> list:
    rng = np.random.RandomState(0)
    return [list(rng.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)) for _ in range(REQUESTS)]


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_serve() -> int:
    requests = _requests()
    forwards = 1 + REQUESTS
    with tempfile.TemporaryDirectory() as tmp:
        # bf16 (the config's FP16 block, softmax_dtype bfloat16): kernel vs plain
        _export(CONFIG, os.path.join(tmp, "bf16"))
        _export(CONFIG, os.path.join(tmp, "bf16_einsum"), "Model.th_impl=einsum")
        fused, st_f, launches, prof_f = _serve(os.path.join(tmp, "bf16"), MODEL_NAME, requests,
                                               talking_heads_softmax)
        check(launches == DEPTH * forwards, f"kernel launched {launches}x, want {DEPTH * forwards}")
        plain, st_p, plain_launches, prof_p = _serve(os.path.join(tmp, "bf16_einsum"), MODEL_NAME,
                                                     requests, talking_heads_softmax)
        check(plain_launches == 0, f"plain path launched the kernel {plain_launches}x")
        _report("bf16 kernel path", st_f, prof_f)
        _report("bf16 plain path ", st_p, prof_p)
        cos = _cosines(fused, plain)
        log(f"[serve] bf16 kernel vs plain: min cosine {cos.min():.6f}, "
            f"max abs diff {np.abs(fused - plain).max():.4g}, launches {launches} "
            f"= {DEPTH} x {forwards} forwards")
        # both paths do the talking-heads step in f32 and round once to bf16, so
        # they may differ only where that rounding flips (an H100 gave cosine
        # 1.000000, max diff 0): 1e-4 of cosine is far above that, tighter than 1e-3
        check(cos.min() >= 0.9999, f"bf16 logits disagree: min cosine {cos.min()}")

        # f32 (FP16.enable=False; TF32 off above): the same f32 math with the
        # head mixes summed in another order (an H100 gave 6e-8): atol 1e-5
        _export(CONFIG, os.path.join(tmp, "f32"), "FP16.enable=False")
        _export(CONFIG, os.path.join(tmp, "f32_einsum"), "FP16.enable=False", "Model.th_impl=einsum")
        fused32, st_f32, launches32, prof_f32 = _serve(os.path.join(tmp, "f32"), MODEL_NAME,
                                                       requests, talking_heads_softmax)
        plain32, st_p32, _, prof_p32 = _serve(os.path.join(tmp, "f32_einsum"), MODEL_NAME,
                                              requests, talking_heads_softmax)
        check(launches32 == DEPTH * forwards, f"f32: kernel launched {launches32}x")
        _report("f32 kernel path ", st_f32, prof_f32)
        _report("f32 plain path  ", st_p32, prof_p32)
        log(f"[serve] f32 kernel vs plain: max abs diff {np.abs(fused32 - plain32).max():.4g}")
        np.testing.assert_allclose(fused32, plain32, atol=1e-5, rtol=0)
    return launches


def _serve_kernel_vs_einsum(tag: str, config: str, name: str, blocks: int, kernel,
                            kernel_cfg: str, common: tuple = ()) -> dict:
    """A model through export and Predictor on its kernel path (`kernel_cfg`)
    against its einsum path on the same weights (Global.seed), in the config's
    bf16 with its softmax_dtype, at softmax_dtype=float32, and in f32
    throughout (FP16.enable=False, softmax_dtype=float32). Returns
    {precision: (min cosine, max abs diff, launches)}."""
    requests = _requests()
    forwards = 1 + REQUESTS
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (the in1k configs set softmax_dtype: bfloat16, so f32 throughout
        # sets it to float32 as well)
        for prec, overrides in (("bf16", ()), ("bf16, softmax f32", ("Model.softmax_dtype=float32",)),
                                ("f32", ("FP16.enable=False", "Model.softmax_dtype=float32"))):
            d_k, d_p = os.path.join(tmp, "kernel"), os.path.join(tmp, "plain")
            _export(config, d_k, kernel_cfg, *common, *overrides)
            _export(config, d_p, *common, *overrides)
            fused, st_f, launches, prof_f = _serve(d_k, name, requests, kernel)
            check(launches == blocks * forwards,
                  f"{tag} {prec}: kernel launched {launches}x, want {blocks * forwards}")
            plain, st_p, plain_launches, prof_p = _serve(d_p, name, requests, kernel)
            check(plain_launches == 0, f"{tag} {prec}: the einsum path launched the kernel")
            _report(f"{tag} {prec} kernel path", st_f, prof_f)
            _report(f"{tag} {prec} einsum path", st_p, prof_p)
            cos = _cosines(fused, plain)
            log(f"[serve] {tag} {prec} kernel vs einsum: min cosine {cos.min():.7f}, max abs diff "
                f"{np.abs(fused - plain).max():.4g} (largest logit {np.abs(plain).max():.4g}), "
                f"launches {launches} = {blocks} x {forwards} forwards")
            out[prec] = (cos.min(), np.abs(fused - plain).max(), launches)
    return out


def phase_serve_swin() -> int:
    """Swin-T at 224 through export and Predictor: the kernel path
    (attn_impl=fused) against the einsum path on the same weights (Global.seed)."""
    out = _serve_kernel_vs_einsum("Swin-T", SWIN_CONFIG, SWIN_NAME, SWIN_BLOCKS,
                                  fused_window_attention, "Model.attn_impl=fused")
    # bf16: the einsum path rounds the scores, the bias and mask sums and the
    # softmax to bf16 (2^-8 relative each) where the kernel keeps them in f32,
    # over 12 blocks; the tiny CPU model gave cosine >= 0.99998
    # (tests/test_torch_swin.py): 1e-3 of cosine leaves room for 12 blocks,
    # and a wrong mask or bias drops far below it
    check(out["bf16"][0] >= 0.999, f"Swin-T bf16 logits disagree: {out['bf16']}")
    # softmax f32: both paths compute f32 scores and softmax and round p to bf16
    # once; they differ only by where the scale and that rounding fall
    check(out["bf16, softmax f32"][0] >= 0.9999,
          f"Swin-T bf16 (softmax f32) logits disagree: {out['bf16, softmax f32']}")
    # f32 throughout: sums in another order (as tests/test_window_attention_kernel.py:129)
    check(out["f32"][1] <= 1e-4, f"Swin-T f32 logits disagree: {out['f32']}")
    return out["bf16"][2]


def phase_serve_vit() -> int:
    """ViT-B/16 at 224 through export and Predictor: the flash kernel path
    (attn_impl=flash) against the einsum path on the same weights."""
    out = _serve_kernel_vs_einsum("ViT-B/16", VIT_CONFIG, VIT_NAME, VIT_BLOCKS, flash_attention,
                                  "Model.attn_impl=flash")
    # bf16: the einsum path rounds the scores and the softmax to bf16 (the
    # config's softmax_dtype) where the kernel keeps them in f32, over 12
    # blocks; a wrong mask of the ragged last tile or a wrong scale drops far
    # below 1e-3 of cosine
    check(out["bf16"][0] >= 0.999, f"ViT-B/16 bf16 logits disagree: {out['bf16']}")
    # softmax f32: both compute f32 scores and softmax; they differ by where
    # the scale, p's rounding to bf16 and the normalisation fall
    check(out["bf16, softmax f32"][0] >= 0.9999,
          f"ViT-B/16 bf16 (softmax f32) logits disagree: {out['bf16, softmax f32']}")
    # f32 throughout: the same function with sums in another order
    check(out["f32"][1] <= 1e-4, f"ViT-B/16 f32 logits disagree: {out['f32']}")
    return out["bf16"][2]


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """One model's train phase: the kernel path timed against a plain path."""

    tag: str
    config: str
    batch: int
    blocks: int  # launches of each kernel per step
    n_fed: int  # parameters whose gradients the backward kernels give
    fwd: Callable  # the forward kernel's wrapper (its `.launches`)
    bwd: tuple  # the backward kernels' wrappers, each launched `blocks` times a step
    kernel: tuple  # overrides of the kernel path
    plain: tuple  # overrides of the plain path timed beside it
    grad_plain: tuple  # overrides of the path the first-step gradients are held against
    kernel_fed: Callable[[str], bool]  # the parameters whose gradients the backward kernels give
    resume_workers: int = 0  # loader workers of the one-step resume


CAIT_TRAIN = TrainSpec("CaiT-S24", CONFIG, TRAIN_BATCH, DEPTH, 2 * DEPTH, talking_heads_softmax,
                       (talking_heads_softmax_bwd,), (), ("Model.th_impl=einsum",),
                       ("Model.th_impl=einsum",),
                       lambda n: n.endswith("proj_l") or n.endswith("proj_w"), resume_workers=2)
# the fused path's softmax is f32 whatever softmax_dtype says; its gradients
# are held against the einsum path at softmax_dtype float32
SWIN_TRAIN = TrainSpec("Swin-T", SWIN_CONFIG, SWIN_TRAIN_BATCH, SWIN_BLOCKS, SWIN_BLOCKS,
                       fused_window_attention, (fused_window_attention_bwd,),
                       ("Model.attn_impl=fused",), (), ("Model.softmax_dtype=float32",),
                       lambda n: n.endswith("relative_position_bias_table"))
# the flash path's softmax is f32 whatever softmax_dtype says; its gradients
# are held against the einsum path at softmax_dtype float32. The dK/dV and dQ
# kernels feed every attn.qkv.weight
VIT_TRAIN = TrainSpec("ViT-B/16", VIT_CONFIG, VIT_TRAIN_BATCH, VIT_BLOCKS, VIT_BLOCKS,
                      flash_attention, (flash_attention_dkv, flash_attention_dq),
                      ("Model.attn_impl=flash",), (), ("Model.softmax_dtype=float32",),
                      lambda n: n.endswith("attn.qkv.weight"))


# loader worker processes of the timed runs. The Engine forks its pools before
# it moves the model to the card, and each loop joins its prefetch thread when
# it ends; CaiT-S24's one-step resume goes through the engine's loader with 2
# workers, as tools/train runs it (`TrainSpec.resume_workers`). The other
# resumes and the evals load in the main thread (no workers, no prefetch thread)
WORKERS = 6  # leaves cores to the training process on an 8-core host


def _loader_threads(loader: dict, workers: int) -> None:
    loader["num_workers"] = workers
    if not workers:
        loader["prefetch"] = 0


def _train_config(spec: TrainSpec, out_dir: str, *overrides: str, workers: int = WORKERS):
    """The in1k config with synthetic images (ImageNet is not on the card's
    machine; the config's own transforms stay), the spec's batch, TRAIN_STEPS steps."""
    config = cfg_util.get_config(spec.config, overrides=[
        f"Global.output_dir={out_dir}", f"Global.max_train_step={TRAIN_STEPS}",
        "Global.print_batch_step=1", "Global.eval_during_train=False", *overrides])
    for mode, size, bs in (("Train", 1024, spec.batch), ("Eval", 256, 128)):
        dl = config["DataLoader"][mode]
        dl["dataset"] = {"name": "SyntheticDataset", "size": size, "image_size": IMG,
                         "num_classes": NUM_CLASSES, "transform": dl["dataset"]["transform"]}
        dl["sampler"]["batch_size"] = bs
        _loader_threads(dl["loader"], workers)
    return config


def _first_batch(config) -> tuple:
    """Epoch 1's first training batch, built as the engine's loader builds it."""
    dl = dict(config["DataLoader"]["Train"], loader={"num_workers": 0, "prefetch": 0})
    loader = build_dataloader(dl, "Train", seed=int(config["Global"]["seed"]))
    loader.set_epoch(1)
    return to_device(next(iter(loader)), torch.device("cuda"))


def _grads(engine: Engine, batch) -> tuple[float, dict]:
    """Loss and per-parameter gradients of one forward and backward, leaving
    the state (generator, parameters, step) as it was."""
    rng = engine.state.generator.get_state()
    loss = float(engine.train_step.forward_backward(engine.state, batch)["loss"])
    grads = {n: p.grad.float().clone() for n, p in engine.model.named_parameters()}
    engine.state.generator.set_state(rng)
    for p in engine.model.parameters():
        p.grad = None
    return loss, grads


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.dot(a, b) / (a.norm() * b.norm())).item()


def _step_report(tag: str, engine: Engine, batch_size: int, steps: int = TRAIN_STEPS) -> dict:
    hist = engine.train_loop.history
    check(len(hist) == steps, f"{tag}: {len(hist)} logged steps, want {steps}")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"{tag}: non-finite loss in {losses}")
    steady = hist[1:]  # the first step pays for cuBLAS and allocator warm-up
    batch = float(np.median([h["batch_cost"] for h in steady]))
    reader = float(np.median([h["reader_cost"] for h in steady]))
    rep = {"first_step_s": hist[0]["batch_cost"], "step_s_median": batch,
           "images_per_s": batch_size / batch, "reader_s_median": reader,
           "reader_share": reader / batch,
           "max_mem_GB": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[train] {tag}: losses " + ", ".join(f"{v:.5f}" for v in losses) + "; " + _fmt(rep))
    return rep


def _same_start(a: Engine, b: Engine) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                 b.model.state_dict().values()))


def _launches(spec: TrainSpec) -> dict:
    return {w.__name__: w.launches for w in (spec.fwd, *spec.bwd)}


def _reset_launches(spec: TrainSpec) -> None:
    for w in (spec.fwd, *spec.bwd):
        w.launches = 0


def phase_train(spec: TrainSpec) -> dict:
    out = {}
    n = spec.blocks
    with tempfile.TemporaryDirectory() as tmp:
        cfg_k = _train_config(spec, os.path.join(tmp, "kernel"), *spec.kernel)
        e_k = Engine(cfg_k, mode="train", device="cuda")
        e_p = Engine(_train_config(spec, os.path.join(tmp, "plain"), *spec.plain),
                     mode="train", device="cuda")
        check(_same_start(e_k, e_p), f"{spec.tag}: the two paths start from different weights")
        e_g = e_p
        if spec.grad_plain != spec.plain:
            e_g = Engine(_train_config(spec, os.path.join(tmp, "grad"), *spec.grad_plain),
                         mode="train", device="cuda")
            check(_same_start(e_k, e_g), f"{spec.tag}: the gradient reference starts elsewhere")

        # the first step's gradients, kernel path against plain path
        batch = _first_batch(cfg_k)
        _reset_launches(spec)
        loss_k, g_k = _grads(e_k, batch)
        one_step = _launches(spec)
        check(set(one_step.values()) == {n},
              f"{spec.tag}: one step launched {one_step}, want {n} of each kernel")
        loss_p, g_p = _grads(e_g, batch)
        check(_launches(spec) == one_step, f"{spec.tag}: the plain path launched a kernel")
        if e_g is not e_p:
            e_g.close()
            del e_g
        cos_all = _cos(torch.cat([g.flatten() for g in g_k.values()]),
                       torch.cat([g.flatten() for g in g_p.values()]))
        cos_kf = {name: _cos(g_k[name].flatten(), g_p[name].flatten()) for name in g_k
                  if spec.kernel_fed(name)}
        worst = min(cos_kf, key=cos_kf.get)
        log(f"[train] {spec.tag} first-step gradients, kernel vs plain path: loss {loss_k:.6f} vs "
            f"{loss_p:.6f}, cosine overall {cos_all:.7f}, lowest kernel-fed cosine "
            f"{cos_kf[worst]:.7f} ({worst}), {len(cos_kf)} checked")
        check(len(cos_kf) == spec.n_fed,
              f"{spec.tag}: {len(cos_kf)} kernel-fed parameters, want {spec.n_fed}")
        # both paths compute the softmax in f32 and round p (and ds) to bf16
        # once, so they differ only where such a rounding flips (and in
        # summation order): 1e-3 of cosine leaves room for that, and a wrong
        # gradient term (a transposed mix, a missing softmax term, a dbias
        # summed over the wrong groups) falls far below
        check(cos_all >= 0.999 and cos_kf[worst] >= 0.999,
              f"{spec.tag}: gradients disagree: overall {cos_all}, {worst} {cos_kf[worst]}")
        check(abs(loss_k - loss_p) <= 1e-3 * abs(loss_p),
              f"{spec.tag}: losses disagree: {loss_k} vs {loss_p}")
        out["grad_cos"] = cos_all
        out["grad_cos_min_kernel_fed"] = cos_kf[worst]
        del g_k, g_p

        # the main path: TRAIN_STEPS steps through the kernels, as tools/train runs them
        _reset_launches(spec)
        torch.cuda.reset_peak_memory_stats()
        e_k.train()
        out["launches"] = _launches(spec)
        check(set(out["launches"].values()) == {n * TRAIN_STEPS},
              f"{spec.tag}: {TRAIN_STEPS} steps launched {out['launches']}, "
              f"want {n * TRAIN_STEPS} of each kernel")
        log(f"[train] {spec.tag}: launches over {TRAIN_STEPS} steps {out['launches']}")
        out["kernel"] = _step_report(f"{spec.tag} bf16 kernel path", e_k, spec.batch)
        ckpt = os.path.join(tmp, "kernel", "latest.pt")
        check(os.path.exists(ckpt) and e_k.state.step == TRAIN_STEPS, "no checkpoint after training")

        torch.cuda.reset_peak_memory_stats()
        e_p.train()
        check(_launches(spec) == out["launches"], f"{spec.tag}: the plain path launched a kernel")
        out["plain"] = _step_report(f"{spec.tag} bf16 plain path ", e_p, spec.batch)

        busy_k, busy_p = {}, {}
        log(f"[profile] {spec.tag} train step, bf16 kernel path: "
            f"{_profile(lambda: float(e_k.train_step(e_k.state, batch)['loss']), busy_k)}")
        log(f"[profile] {spec.tag} train step, bf16 plain path:  "
            f"{_profile(lambda: float(e_p.train_step(e_p.state, batch)['loss']), busy_p)}")
        out["busy_ms"] = {"kernel": busy_k["busy_ms"], "plain": busy_p["busy_ms"]}
        log(f"[train] {spec.tag} device busy per step: kernel path {busy_k['busy_ms']:.3f} ms, "
            f"plain path {busy_p['busy_ms']:.3f} ms")
        del e_k, e_p
        torch.cuda.empty_cache()

        # resume: one more step from the checkpoint, then evaluate it
        e_r = Engine(_train_config(spec, os.path.join(tmp, "resume"), *spec.kernel,
                                   f"Global.checkpoint={ckpt}",
                                   f"Global.max_train_step={TRAIN_STEPS + 1}",
                                   workers=spec.resume_workers),
                     mode="train", device="cuda")
        check(e_r.train_dataloader.num_workers == spec.resume_workers,
              f"{spec.tag}: resume loader has {e_r.train_dataloader.num_workers} workers")
        e_r.train()
        check(not [t for t in threading.enumerate() if t.name == PREFETCH_THREAD],
              f"{spec.tag}: a loader prefetch thread outlived the resume")
        hist = e_r.train_loop.history
        check(len(hist) == 1 and hist[0]["step"] == TRAIN_STEPS + 1 and np.isfinite(hist[0]["loss"]),
              f"{spec.tag}: resume from step {TRAIN_STEPS}: history {hist}")
        log(f"[train] {spec.tag} resumed from {ckpt} at step {TRAIN_STEPS} with "
            f"{spec.resume_workers} loader workers, trained step {hist[0]['step']}: "
            f"loss {hist[0]['loss']:.5f}")
        del e_r
        e_v = Engine(_train_config(spec, os.path.join(tmp, "eval"), *spec.kernel,
                                   f"Global.checkpoint={ckpt}", workers=0),
                     mode="eval", device="cuda")
        top1 = e_v.eval()
        m = e_v.eval_loop.last_metrics
        # a config with an EMA block is also evaluated on the EMA weights
        keys = {"top1", "top5"} | ({"top1_ema", "top5_ema"} if e_v.eval_metrics_step_ema else set())
        check(set(m) == keys and all(0.0 <= v <= 1.0 for v in m.values())
              and top1 == m["top1"], f"{spec.tag}: eval metrics {m}")
        log(f"[eval] {spec.tag}: {len(e_v.eval_dataloader.dataset)} synthetic images: "
            + ", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items())))
        del e_v
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ fused augment

# BYOL's two views (reference BYOL.py:239): view 1 always blurred, never
# solarized; view 2 blurred with p 0.1, solarized with p 0.2
AUG_VIEW1 = dict(blur_prob=1.0, solarize_prob=0.0)
AUG_VIEW2 = dict(blur_prob=0.1, solarize_prob=0.2)
AUG_BYOL = (128, IMG, IMG, 3)  # one view of BYOL's per-card batch
# (shape, settings): deterministic (coins at 0/1, one sigma) and random ones
AUG_CASES = [
    (AUG_BYOL, AUG_VIEW1),
    (AUG_BYOL, AUG_VIEW2),
    ((256, 32, 32, 3), dict(blur_prob=0.5, solarize_prob=0.5)),
    ((8, 160, 224, 3), dict(blur_prob=1.0, solarize_prob=1.0, sigma_range=(1.5, 1.5))),
    ((4, 16, 16, 3), dict(blur_prob=1.0, solarize_prob=0.0, taps=23, sigma_range=(2.0, 2.0))),
    ((16, 64, 48, 1), dict(blur_prob=1.0, solarize_prob=1.0, sigma_range=(0.1, 2.0),
                           mean=(0.45,), std=(0.226,))),
    ((64, 224, 224, 3), dict(blur_prob=0.0, solarize_prob=0.0)),
    # the fast kernel's other radii: taps 1, 3 (W C = 36: 4-byte staging), 4 and 25
    ((16, 40, 36, 3), dict(blur_prob=1.0, solarize_prob=0.5, taps=1)),
    ((16, 37, 12, 3), dict(blur_prob=1.0, solarize_prob=0.5, taps=3)),
    ((16, 48, 40, 3), dict(blur_prob=1.0, solarize_prob=0.0, taps=4)),
    ((16, 50, 44, 3), dict(blur_prob=1.0, solarize_prob=1.0, taps=25)),
    # an image lower than the radius, W C = 39 odd (byte staging, 2-byte stores)
    ((16, 5, 13, 3), dict(blur_prob=1.0, solarize_prob=0.5, taps=23)),
    # a misaligned contiguous view (`offset` bytes into a buffer): byte staging and streaming
    ((32, 33, 40, 3), dict(blur_prob=0.5, solarize_prob=0.5, offset=1)),
    # one channel at a compiled radius; two channels, which the generic kernel takes
    ((16, 40, 36, 1), dict(blur_prob=1.0, solarize_prob=0.5, taps=23, mean=(0.45,),
                           std=(0.226,))),
    ((16, 24, 20, 2), dict(blur_prob=0.5, solarize_prob=0.5, mean=(0.5, 0.4), std=(0.2, 0.25))),
    # the widest row the generic kernel takes at 23 taps (W C = 7,224, one row a block)
    ((4, 8, 2408, 3), dict(blur_prob=1.0, solarize_prob=0.0, taps=23)),
]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 (8 significant bits) at |x|, with a
    floor of 1e-5 near zero (x close to the mean), where the bf16 grid is
    finer than the f32 values' own error: x carries a few f32 ulps of 1 from
    the blur's sums, scaled by 1 / std (the plain version was 2.8e-6 from
    float64 on an H100)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.clamp(torch.exp2(e - 7), min=1e-5)


def _aug_images(shape, seed, offset: int = 0) -> torch.Tensor:
    """uint8 images from `seed`; with `offset`, a contiguous view that starts
    `offset` bytes into a buffer."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    imgs = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
    if offset:
        buf = torch.zeros(imgs.numel() + offset, dtype=torch.uint8, device="cuda")
        imgs = buf[offset:offset + imgs.numel()].view(shape).copy_(imgs)
        check(imgs.is_contiguous() and imgs.data_ptr() % 16 == offset % 16,
              f"augment: the view at offset {offset} is not misaligned")
    return imgs


def _aug_rates(seed: int) -> dict:
    """4,096 copies of one 4 x 4 image through the kernel: which of the four
    (blur, solarize) outcomes each got, against their probabilities."""
    n = 4096
    one = _aug_images((1, 4, 4, 1), seed)
    kw = dict(taps=3, sigma_range=(1.0, 1.0), mean=(0.0,), std=(1.0,))
    outcomes = {(b, so): fused_augment_ref(one, torch.zeros(1, 3, device="cuda"),
                                           blur_prob=float(b), solarize_prob=float(so), **kw)[0]
                for b in (0, 1) for so in (0, 1)}
    check(len({tuple(v.flatten().tolist()) for v in outcomes.values()}) == 4,
          "augment rates: the four outcomes are not distinct")
    out = {}
    for blur_prob, sol_prob in ((AUG_VIEW2["blur_prob"], AUG_VIEW2["solarize_prob"]), (0.5, 0.8)):
        got = fused_augment(one.expand(n, -1, -1, -1).contiguous(), seed, blur_prob=blur_prob,
                            solarize_prob=sol_prob, **kw)
        which = {k: (got == v).flatten(1).all(1) for k, v in outcomes.items()}
        check(int(sum(w.sum() for w in which.values())) == n, "augment rates: unknown outcome")
        for name, share, p in (
                ("blur", (which[(1, 0)] | which[(1, 1)]).float().mean().item(), blur_prob),
                ("solarize", (which[(0, 1)] | which[(1, 1)]).float().mean().item(), sol_prob)):
            sigma = float(np.sqrt(p * (1 - p) / n))
            check(abs(share - p) <= 4 * sigma, f"augment {name} rate {share} at p {p}")
            out[f"{name}_rate@{p}"] = share
            out[f"{name}_z@{p}"] = (share - p) / sigma
    return out


def phase_augment() -> dict:
    results = {}
    with torch.inference_mode():
        for i, (shape, kw) in enumerate(AUG_CASES):
            kw = dict(kw)
            offset = kw.pop("offset", 0)
            imgs = _aug_images(shape, seed=800 + i, offset=offset)
            u = fused_augment_draws(shape[0], 900 + i, imgs.device)
            got = fused_augment_with_draws(imgs, u, **kw)
            want = fused_augment_ref(imgs, u, **kw)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16 and got.shape == imgs.shape,
                  f"augment output {got.dtype} {tuple(got.shape)}")
            g, w = got.float(), want.float()
            diff = (g - w).abs()
            over = diff > _bf16_ulp(torch.maximum(g.abs(), w.abs()))
            beyond = int(over.sum())
            rec = {"kernel": fused_augment_kernel_for(*shape[1:], kw.get("taps", 23)),
                   "max_abs_err": diff.max().item(), "bitwise_equal_share":
                   (got.view(torch.int16) == want.view(torch.int16)).float().mean().item(),
                   "blurred": int((u[:, 1] < kw["blur_prob"]).sum()),
                   "solarized": int((u[:, 2] < kw["solarize_prob"]).sum())}
            check(beyond == 0, f"augment at {shape} {kw}: {beyond} entries beyond one bf16 ulp, "
                               f"{rec}, (kernel, plain): "
                               f"{list(zip(g[over][:5].tolist(), w[over][:5].tolist()))}")
            check(torch.equal(got, fused_augment_with_draws(imgs, u, **kw)),
                  f"augment at {shape}: two launches differ")
            if shape == AUG_BYOL:
                check(rec["kernel"] == "fast", f"augment at {shape}: the {rec['kernel']} kernel")
                # read u8 once, write bf16 once; each blurred image's taps are
                # 2 passes x 2 flops x taps per element (view 1: every image;
                # view 2: its blurred images only). The kernel's turns replay a
                # CUDA graph: the wrapper's host time would pace a launch this
                # short; `host_paced_ms` is the plain loop's reading
                elems = imgs.numel()
                flops = 4 * 23 * (elems // shape[0]) * rec["blurred"]
                rec.update(_time_pair(lambda: fused_augment_with_draws(imgs, u, **kw),
                                      lambda: fused_augment_ref(imgs, u, **kw),
                                      3 * elems, flops, torch.float32, kernel_timer=graph_ms))
                rec["host_paced_ms"] = loop_ms(lambda: fused_augment_with_draws(imgs, u, **kw))
                if kw == AUG_VIEW1:
                    rec["resources"] = fused_augment_resources(*shape[1:], 23)
                    v2 = _aug_images(shape, seed=850)
                    gen = torch.Generator(device="cuda")
                    rec["byol_device_augment_plain_ms"] = loop_ms(
                        lambda: byol_device_augment(imgs, v2, gen.manual_seed(0)), iters=10)
            results[(shape, tuple(sorted(kw.items())))] = rec
            log(f"[augment] {shape} {kw}{f' at offset {offset}' if offset else ''}: "
                f"{_fmt(rec)}, repeatable bitwise")
            del imgs, u, got, want, g, w, diff
        # per-image draws: identical images with other draws come out different
        same = _aug_images((1, 64, 64, 3), seed=860).expand(8, -1, -1, -1).contiguous()
        out = fused_augment(same, 7, blur_prob=1.0, solarize_prob=0.0,
                            sigma_range=(0.1, 3.0)).float()
        differ = all(not torch.equal(out[0], out[j]) for j in range(1, 8))
        check(differ, "augment: identical images with other draws came out equal")
        rates = _aug_rates(seed=11)
        log(f"[augment] identical images, other draws: all differ; rates at 4096 images: "
            f"{_fmt(rates)}")
        # the op's own path: BYOL's two views through its entry point
        v1, v2 = _aug_images(AUG_BYOL, 870), _aug_images(AUG_BYOL, 871)
        fused_augment.launches = 0
        a1 = fused_augment(v1, 1, **AUG_VIEW1)
        a2 = fused_augment(v2, 2, **AUG_VIEW2)
        torch.cuda.synchronize()
        launches = fused_augment.launches
        check(launches == 2 and all(bool(torch.isfinite(a.float()).all()) for a in (a1, a2)),
              f"augment path: {launches} launches")
        log(f"[augment] BYOL's two views through fused_augment: launches {launches}")
    torch.cuda.empty_cache()
    return {"cases": results, "launches": launches}


# ------------------------------------------------- SSL ResNet-50: BYOL, SimCLR, MoCo v2


# the blocks of a transformer's first step card vs CPU (every width kept): the
# CPU's f64 steps set the script's floor beside the kernels' build (MoCo v3's
# took 43.3 s and DINOv2's 29.8 s at 12 blocks on an H100 80GB HBM3's host at
# 700 W; PERF.md §6)
FIRST_STEP_BLOCKS = 4
# five ResNet-50 SSL methods' first steps card vs CPU at one bottleneck a stage
# (4 of 16), every width kept (the stem, layer4's 3 convs and projection: 5
# watched): MoCo v2's, SimSiam's, MoCo-BYOL's, DenseCL's and PixPro's, 67 s of
# the script's floor at 16. BYOL, SimCLR and SwAV stay whole: cut so, their
# f32 yardsticks (the card against the CPU's own f32-vs-f64) no longer held.
# No limit or ratio changed (PERF.md §6)
R50_FIRST_STEP = ("Model.backbone.name=ResNet", "Model.backbone.layers=[1, 1, 1, 1]")
R50_WATCHED = 5


@dataclasses.dataclass(frozen=True)
class SSLSpec:
    """An SSL recipe's training phase: its config, per-card batch (pairs),
    the first step's size and overrides for the card-vs-CPU gradients, the
    momentum tower that takes no gradient (if any), and the backbone whose
    stem and layer4 convolutions the gradient check names."""
    tag: str
    config: str
    batch: int
    grad_batch: int
    grad_overrides: tuple
    backbone: str
    no_grad: Optional[str] = None
    overrides: tuple = ()  # of every run of the phase
    # the scale of the loss's terms where their mean cancels (SimSiam's cosines,
    # in [-1, 1], average to 0.005 at the init): the first step's loss
    # difference is taken relative to the larger of it and the loss
    loss_scale: float = 0.0
    # the yardstick of f32: where set, the card's f32 error from f64 (1 - gradient
    # cosine) at most this many times the CPU's; 1 (SimSiam, MoCo-BYOL, SwAV):
    # the card's f32 at least as close to f64 as the CPU's; 2 (DenseCL, PixPro,
    # FastMoCo, MAE), as the two errors lie within 10% of each other there and
    # which is the smaller flips with the rounding (on an H100 80GB HBM3 at 700 W:
    # DenseCL's card-vs-CPU 0.999726 against the CPU's f32-vs-f64 0.999760;
    # PixPro's card f32-vs-f64 0.999766 against the CPU's 0.999783; MAE's card
    # error 0.997 times the CPU's); 20 (MoCo v3, whose card error runs a few
    # times the CPU's: at its spec). Unset: the card's and the CPU's f32 must
    # agree at least as well as the CPU's f32 and f64 (two f32 errors against one)
    f32_error_ratio: float = 0.0
    views: int = 2  # crops of each image; `batch` counts pairs where there are 2, else images
    img: int = IMG  # the synthetic images' size (FastMoCo's config is CIFAR-sized)
    # the weights whose lowest gradient cosine the first-step check names, and
    # their count: by default the stem's and layer4's convolutions (ResNet-50:
    # 1 + 10; ResNet-18: 1 + 5); where `watch` is set, the names it picks (a
    # ViT's attn.qkv weights)
    watched: int = 11
    watch: Optional[Callable[[str], bool]] = None
    # where set, f32's error is the gradients' relative L2 distance from f64, not
    # 1 - cosine: through LayerNorm towers f32 lands so close to f64 (2e-7 of the
    # norm) that 1 - cosine, about half that distance squared, sinks under the
    # cosine's own f64 rounding (1e-13 over 1e7 entries) and reads noise
    error_by_distance: bool = False
    # the fixed draws the first step hands both devices (a context), where the
    # model draws (MoCo's and DenseCL's permutation, MAE's noise, DINOv2's masks,
    # LV-ViT's MixToken box)
    draws: Optional[Callable[[], contextlib.AbstractContextManager]] = None
    # run on the first step's freshly built model before its init is kept (Mixer's
    # head, zeros at init, drawn so that the backward reaches every block)
    first_step_init: Optional[Callable[[torch.nn.Module], None]] = None
    # where set, the card's f32 first step runs its convolutions on PyTorch's
    # native kernels (cuDNN off), and the same step through cuDNN is logged
    # beside it, not held: LV-ViT's 3 x 3 stem convs at 112 x 112 come out of
    # cuDNN's f32 algorithms with their gradients 9e-4 from f64, 7.3e-7 through
    # the native convolutions (tests/perf/lvvit_first_step_convs.py; PERF.md §6)
    native_convs: bool = False


BYOL_SPEC = SSLSpec("BYOL-R50", os.path.join(REPO, "configs", "byol", "byol_r50_in1k.yaml"),
                    128,  # per view: the recipe's 4,096 over 32 cards
                    4, ("Model.use_device_augment=False",), "online.backbone.", "target.")
SIMCLR_SPEC = SSLSpec("SimCLR-R50", os.path.join(REPO, "configs", "simclr",
                                                 "simclr_r50_in1k.yaml"),
                      128,  # pairs: the recipe's 4,096 over 32 cards
                      4, ("Model.use_device_augment=False",), "backbone.")
MOCO_SPEC = SSLSpec("MoCoV2-R50", os.path.join(REPO, "configs", "moco", "mocov2_r50_in1k.yaml"),
                    256,  # the config's own batch, in 8 BatchNorm splits
                    16, R50_FIRST_STEP, "encoder_q.backbone.", "encoder_k.",  # 2 images a split
                    draws=lambda: _one_permutation(16), watched=R50_WATCHED)
SIMSIAM_SPEC = SSLSpec("SimSiam-R50", os.path.join(REPO, "configs", "simsiam",
                                                   "simsiam_r50_in1k.yaml"),
                       128,  # pairs: the recipe's 512 over 4 cards
                       4, R50_FIRST_STEP, "encoder.backbone.", loss_scale=1.0, f32_error_ratio=1.0,
                       watched=R50_WATCHED)
MOCOBYOL_SPEC = SSLSpec("MoCoBYOL-R50", os.path.join(REPO, "configs", "moco_byol",
                                                     "moco_byol_r50_in1k.yaml"),
                        128,  # pairs: the recipe's 1,024 over 8 cards
                        # 16 pairs: at 4, the gradient through the necks' BatchNorms
                        # (the last without scale or bias) over 4 samples is a remainder
                        # that the card's and the CPU's f32 resolve only to a cosine of
                        # 0.99903 between them (0.99973 at 16), 1 - 1e-14 in f64
                        16, R50_FIRST_STEP, "online.backbone.", "target.", f32_error_ratio=1.0,
                        watched=R50_WATCHED)
# the config freezes the prototypes for 313 steps, which 8 steps never leave:
# 4 puts the boundary inside the run
SWAV_FREEZE = 4
SWAV_SPEC = SSLSpec("SwAV-R50", os.path.join(REPO, "configs", "swav", "swav_r50_in1k.yaml"),
                    64,  # images of 2 x 224 + 6 x 96 crops: the recipe's 4,096 over 64 cards
                    8, (), "backbone.", overrides=(f"Model.freeze_prototypes_iter={SWAV_FREEZE}",),
                    views=8, f32_error_ratio=1.0)


def _ssl_config(spec: SSLSpec, out_dir: str, batch: int, *overrides: str,
                workers: int = WORKERS):
    """The in1k config with synthetic images in place of ImageNet (the
    config's own host transforms stay; the multi-crop wrapper of SwAV and
    DINO keeps its crop stacks around the synthetic images; CLIP's captions
    are `SyntheticTextImageDataset`'s token ids at the config's context
    length and the model's vocabulary; LV-ViT's token labels are
    `SyntheticTokenLabelDataset`'s top-5 maps on the config's grid, the images
    normalized as ImageNet's), `batch` images or pairs,
    TRAIN_STEPS steps; a classifier's Eval block on 256 synthetic images,
    evaluated only where the phase asks."""
    config = cfg_util.get_config(spec.config, overrides=[
        f"Global.output_dir={out_dir}", f"Global.max_train_step={TRAIN_STEPS}",
        "Global.print_batch_step=1", *spec.overrides, *overrides])
    dl = config["DataLoader"]["Train"]
    synthetic = {"name": "SyntheticDataset", "size": 1024, "image_size": spec.img,
                 "num_classes": NUM_CLASSES}
    if dl["dataset"]["name"] == "SwAVMultiCropDataset":
        dl["dataset"]["dataset"] = dict(synthetic, transform=None)
    elif dl["dataset"]["name"] == "LVViTImageNetDataset":  # LV-ViT: synthetic token labels
        dl["dataset"] = {"name": "SyntheticTokenLabelDataset", "size": 1024, "image_size": spec.img,
                         "grid_size": dl["dataset"]["grid_size"], "num_classes": NUM_CLASSES,
                         "topk": LVVIT_TOPK, "transform": NORMALIZE}
    elif dl["dataset"]["name"] == "TextImageDataset":  # CLIP: synthetic captions too
        dl["dataset"] = {"name": "SyntheticTextImageDataset", "size": 1024, "image_size": spec.img,
                         "context_length": dl["dataset"]["context_length"],
                         "vocab_size": config["Model"].get("vocab_size", 49408),
                         "transform": dl["dataset"]["transform"]}
    else:  # PixPro's dataset yields no label: with_label stays as the config has it
        dl["dataset"] = dict(synthetic, transform=dl["dataset"]["transform"],
                             **{k: v for k, v in dl["dataset"].items() if k == "with_label"})
    dl["sampler"]["batch_size"] = batch
    _loader_threads(dl["loader"], workers)
    if "Eval" in config["DataLoader"]:  # a classifier's: 256 synthetic images, its transforms
        ev = config["DataLoader"]["Eval"]
        ev["dataset"] = dict(synthetic, size=256, transform=ev["dataset"]["transform"])
        ev["sampler"]["batch_size"] = 128
        _loader_threads(ev["loader"], 0)
        config["Global"]["eval_during_train"] = False
    return config


def _check_images(engine: Engine, batch) -> None:
    """The images of a batch (views, crops, PixPro's dict of views and boxes,
    CLIP's of images and tokens) reach the device uint8 where the model
    augments on the device or takes raw crops (BYOL, SimCLR), f32 where the
    host normalizes (the rest)."""
    dtypes = {v.dtype for k, v in (batch.items() if isinstance(batch, dict) else enumerate(batch))
              if v.dim() == 4 and not str(k).startswith("token_")}
    # the images: not MAE's labels, boxes or tokens, nor LV-ViT's token labels
    host_normalized = "NormalizeImage" in json.dumps(engine.config["DataLoader"]["Train"]["dataset"])
    check(dtypes == {torch.float32 if host_normalized else torch.uint8},
          f"views reach the device as {dtypes}")


def _ssl_first_batch(engine: Engine, device: str):
    """Epoch 1's first batch, built as the engine's loader builds it, on `device`."""
    dl = dict(engine.config["DataLoader"]["Train"], loader={"num_workers": 0, "prefetch": 0})
    loader = build_dataloader(dl, "Train", seed=engine.seed)
    loader.set_epoch(1)
    batch = to_device(engine.prepare_batch(next(iter(loader))), torch.device(device))
    _check_images(engine, batch)
    return batch


def _to_f64(model: torch.nn.Module) -> None:
    """Every parameter, buffer and compute dtype of `model` in float64 (a
    numerics yardstick only: the port computes in f32 or bf16), the einsum
    attention's scores and output included."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
        if isinstance(m, Attention):
            m.dtype = m.softmax_dtype = torch.float64


@contextlib.contextmanager
def _cudnn_off(off: bool):
    """cuDNN off inside (PyTorch's native convolutions and BatchNorm) where
    `off`; every other cuDNN flag, TF32 off included, kept."""
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = prev and not off
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def _ssl_first_steps(spec: SSLSpec, tmp: str) -> dict:
    """{(device, f64): (loss, grads, shapes)} of the first step on the card and
    on the CPU, in f32 and in f64, from one engine: each run starts from the
    engine's init (parameters and buffers: a step moves BatchNorm statistics,
    queues, centers) and a fresh generator seeded as the engine seeds it, on its
    device. `grads` is every gradient in f64 on the CPU, flattened into one
    vector in the order of `shapes`, [(name, shape)]."""
    e = Engine(_ssl_config(spec, os.path.join(tmp, "grads"), spec.grad_batch,
                           "FP16.enable=False", *spec.grad_overrides, workers=0),
               mode="train", device="cpu")
    if spec.first_step_init is not None:
        spec.first_step_init(e.model)
    init = {k: v.clone() for k, v in e.model.state_dict().items()}
    batches = {d: _ssl_first_batch(e, d) for d in ("cuda", "cpu")}
    runs = {}
    for f64 in (False, True):
        if f64:
            _to_f64(e.model)
        keys = [("cuda", "cuda"), ("cpu", "cpu")]
        if spec.native_convs and not f64:
            keys.append(("cudnn", "cuda"))  # logged beside the native one, not held
        for key, device in keys:
            e.model.to(device).load_state_dict(init)  # f64 parameters take the f32 init exactly
            e.state.generator = torch.Generator(device=device).manual_seed(e.seed + 1)
            with _cudnn_off(spec.native_convs and key == "cuda" and not f64):
                loss = float(e.train_step.forward_backward(e.state, batches[device])["loss"])
            named = [(n, p) for n, p in e.model.named_parameters()  # the EMA tower takes none
                     if not (spec.no_grad and n.startswith(spec.no_grad))]
            grads = torch.cat([p.grad.detach().flatten().double() for _, p in named]).cpu()
            runs[key, f64] = loss, grads, [(n, p.shape) for n, p in named]
    e.close()
    del e, batches
    torch.cuda.empty_cache()
    return runs


def _grad_agreement(spec: SSLSpec, tag: str, a: tuple, b: tuple) -> dict:
    """Loss and gradient cosines of two first steps (loss, grads, shapes):
    overall and the lowest of the stem's and layer4's conv weights."""
    (l_a, flat_a, shapes), (l_b, flat_b, _) = a, b
    sizes = [s.numel() for _, s in shapes]
    g_a = {n: v for (n, _), v in zip(shapes, torch.split(flat_a, sizes))}  # views
    g_b = {n: v for (n, _), v in zip(shapes, torch.split(flat_b, sizes))}
    cos_all = _cos(flat_a, flat_b)
    watched = [n for n, _ in shapes if spec.watch(n)] if spec.watch else [
        n for n, shape in shapes if len(shape) == 4 and (
            n == f"{spec.backbone}conv1.weight" or n.startswith(f"{spec.backbone}layer4."))]
    what = "watched weights" if spec.watch else "stem/layer4 convs"
    check(len(watched) == spec.watched, f"{spec.tag}: {len(watched)} {what}, want {spec.watched}")
    cos_conv = {n: _cos(g_a[n], g_b[n]) for n in watched}
    worst = min(cos_conv, key=cos_conv.get)
    rel = abs(l_a - l_b) / max(abs(l_b), spec.loss_scale)
    dist = (torch.dist(flat_a, flat_b) / flat_b.norm()).item()
    unit = "pairs" if spec.views == 2 else "images"
    log(f"[train] {spec.tag} first step, {tag} ({spec.grad_batch} {unit}): loss {l_a:.9f} vs "
        f"{l_b:.9f} (rel {rel:.3g}), gradient cosine overall {cos_all:.9f}, lowest of "
        f"{len(watched)} {what} {cos_conv[worst]:.9f} ({worst}), relative distance {dist:.3g}")
    return {"loss_rel": rel, "grad_cos": cos_all, "grad_cos_min_conv": cos_conv[worst],
            "grad_rel_dist": dist}


_FIRST_STEPS: dict = {}  # spec tag -> its first steps' record, taken while the kernels build


def _grads_card_vs_cpu(spec: SSLSpec, tmp: str) -> dict:
    """The first step's loss and gradients on the card against the same step
    on the CPU, from the same init and batch, in f32 (TF32 off) and in f64;
    and, as the yardstick of f32 rounding, f32 against f64 on the CPU. A record
    `phase_first_steps` took already is handed over instead."""
    if spec.tag in _FIRST_STEPS:
        return _FIRST_STEPS.pop(spec.tag)
    with _span(spec.tag, "first steps, card vs CPU, f32 and f64"), (
            spec.draws() if spec.draws else contextlib.nullcontext()):
        runs = _ssl_first_steps(spec, tmp)
    f32 = _grad_agreement(spec, "f32, card vs CPU", runs["cuda", False], runs["cpu", False])
    f64 = _grad_agreement(spec, "f64, card vs CPU", runs["cuda", True], runs["cpu", True])
    ref = _grad_agreement(spec, "CPU, f32 vs f64", runs["cpu", False], runs["cpu", True])
    card = _grad_agreement(spec, "card, f32 vs f64", runs["cuda", False], runs["cuda", True])
    cudnn = {}
    if ("cudnn", False) in runs:  # the convolutions through cuDNN: logged, not held
        cudnn = _grad_agreement(spec, "card through cuDNN, f32 vs f64", runs["cudnn", False],
                                runs["cuda", True])
        log(f"[train] {spec.tag} first step: through cuDNN the card's f32 distance from f64 is "
            f"{cudnn['grad_rel_dist'] / max(ref['grad_rel_dist'], 1e-30):.4g} times the CPU's "
            "(not held: the held step runs the native convolutions)")
    # at ResNet-50's random init the gradient of a weight that feeds a
    # BatchNorm is a small remainder of large sums, which f32 resolves only to
    # the yardstick's cosine: in f32 the card and the CPU must agree to 1e-3,
    # and f64 resolves it, and there they must agree to 1e-6
    for rec, tol in ((f32, 1e-3), (f64, 1e-6)):
        check(rec["loss_rel"] <= 1e-4 and min(rec["grad_cos"], rec["grad_cos_min_conv"]) >= 1 - tol,
              f"{spec.tag} card vs CPU first step: {rec}")
    if spec.f32_error_ratio:
        err_card, err_cpu = ((r["grad_rel_dist"] if spec.error_by_distance else 1 - r["grad_cos"])
                             for r in (card, ref))
        log(f"[train] {spec.tag} first step: the card's f32 error from f64 "
            f"({'relative distance' if spec.error_by_distance else '1 - cosine'}) is "
            f"{err_card / max(err_cpu, 1e-30):.4g} times the CPU's (limit {spec.f32_error_ratio})")
        check(err_card <= spec.f32_error_ratio * err_cpu,
              f"{spec.tag} the card's f32 {card} further from f64 than {spec.f32_error_ratio} "
              f"times the CPU's f32 {ref}")
    else:  # the card and the CPU in f32 agree at least as well as the CPU's f32 and f64
        check(f32["grad_cos"] >= ref["grad_cos"],
              f"{spec.tag} f32 card vs CPU {f32} further apart than f32 from f64 {ref}")
    return {f"{prec}_{k}": v for prec, rec in (("f32", f32), ("f64", f64), ("f32_vs_f64", ref),
                                              ("card_f32_vs_f64", card),
                                              ("cudnn_f32_vs_f64", cudnn))
            for k, v in rec.items()}


class _EmaCheck:
    """Wraps the engine's train step: after every step each target parameter
    must be m(t) target_prev + (1 - m(t)) online_new in f32, m(t) the momentum
    schedule at the step before the increment."""

    def __init__(self, tag: str, engine: Engine):
        self.tag, self.engine, self.step_fn = tag, engine, engine.train_step
        (self.src, self.dst, self.m_fn), = self.step_fn.ema_pairs
        self.worst = 0.0

    def __call__(self, state, batch):
        prev = [t.detach().clone() for t in self.dst]
        m = self.m_fn(state.step)
        metrics = self.step_fn(state, batch)
        with torch.no_grad():
            for s, d, p in zip(self.src, self.dst, prev):
                want = p * m + s * (1.0 - m)
                err = ((d - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
                self.worst = max(self.worst, err)
        # the same two f32 roundings in another kernel (foreach against per tensor)
        check(self.worst <= 1e-6, f"{self.tag} EMA rule broken at step {state.step}: {self.worst}")
        return metrics

    def __getattr__(self, name):
        return getattr(self.step_fn, name)


def _main_path(tag: str, engine: Engine):
    """The phase's main path, `Engine.train()` for TRAIN_STEPS steps, as
    tools/train runs it; returns the first batch its loader handed the train
    step (epoch 1's first, on the card: the profiled step's batch)."""
    step_fn, first = engine.train_step, []

    def step(state, batch):
        if not first:
            first.append(batch)
        return step_fn(state, batch)

    engine.train_step = step
    with _span(tag, f"main path, {TRAIN_STEPS} steps"):
        engine.train()
    engine.train_step = step_fn
    _check_images(engine, first[0])
    return first[0]


def _ssl_report(spec: SSLSpec, engine: Engine, batch, loss_range=(0.0, float("inf"))) -> dict:
    """The main path's losses (and acc1, where the method reports it) over
    TRAIN_STEPS steps, step time, pairs/s and views/s, reader share, peak
    memory, and device busy and idle share of one more profiled step."""
    hist = engine.train_loop.history
    losses = [h["loss"] for h in hist]
    lo, hi = loss_range
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(losses))
          and all(lo <= v <= hi for v in losses), f"{spec.tag} losses {losses}")
    accs = [h["acc1"] for h in hist if "acc1" in h]
    check(all(0.0 <= a <= 1.0 for a in accs), f"{spec.tag} acc1 {accs}")
    steady = hist[1:]  # the first step pays for cuDNN's and the allocator's warm-up
    step_s = float(np.median([h["batch_cost"] for h in steady]))
    reader = float(np.median([h["reader_cost"] for h in steady]))
    rep = {"first_step_s": hist[0]["batch_cost"], "step_s_median": step_s,
           f"{'pairs' if spec.views == 2 else 'images'}_per_s": spec.batch / step_s,
           "views_per_s": spec.views * spec.batch / step_s,
           "reader_s_median": reader, "reader_share": reader / step_s,
           "max_mem_GB": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[train] {spec.tag} bf16: losses " + ", ".join(f"{v:.5f}" for v in losses)
        + (("; acc1 " + ", ".join(f"{a:.4f}" for a in accs)) if accs else "") + "; " + _fmt(rep))
    prof: dict = {}
    with _span(spec.tag, "profiled step"):
        log(f"[profile] {spec.tag} train step, bf16: "
            f"{_profile(lambda: float(engine.train_step(engine.state, batch)['loss']), prof)}")
    rep.update(busy_ms=prof["busy_ms"], idle_share=1 - prof["busy_ms"] / prof["wall_ms"])
    return rep


def _ssl_resume(spec: SSLSpec, tmp: str, ckpt: str, on_first_step=None,
                overrides: tuple = ()) -> None:
    """One more step from the checkpoint (`on_first_step(engine)` runs on the
    restored state before it), as tools/train resumes."""
    t0 = time.perf_counter()
    e_r = Engine(_ssl_config(spec, os.path.join(tmp, "resume"), spec.batch,
                             f"Global.checkpoint={ckpt}",
                             f"Global.max_train_step={TRAIN_STEPS + 1}", *overrides, workers=0),
                 mode="train", device="cuda")
    if on_first_step is not None:
        step_fn = e_r.train_step

        def first(state, batch):
            on_first_step(e_r)
            e_r.train_step = step_fn
            return step_fn(state, batch)

        e_r.train_step = first
    e_r.train()
    hist = e_r.train_loop.history
    check(len(hist) == 1 and hist[0]["step"] == TRAIN_STEPS + 1
          and np.isfinite(hist[0]["loss"]), f"{spec.tag} resume: history {hist}")
    log(f"[train] {spec.tag} resumed from {ckpt} at step {TRAIN_STEPS}, trained step "
        f"{hist[0]['step']}: loss {hist[0]['loss']:.5f}")
    log(f"[time] {spec.tag} resume: {time.perf_counter() - t0:.1f} s")
    del e_r
    torch.cuda.empty_cache()


def _stats_moved(spec: SSLSpec, engine: Engine, stats0: dict, prefixes) -> None:
    moved = {p: all(not torch.equal(v, stats0[k]) for k, v in engine.model.state_dict().items()
                    if k.startswith(p) and "running" in k) for p in prefixes}
    check(all(moved.values()), f"{spec.tag}: BatchNorm statistics moved {moved}")


def _no_optimizer_state_on(spec: SSLSpec, engine: Engine) -> None:
    stateful = {id(p) for p in engine.optimizer.torch_optimizer.state}
    named = list(engine.model.named_parameters())
    check(all((id(p) in stateful) != n.startswith(spec.no_grad) for n, p in named),
          f"{spec.tag}: {spec.no_grad} has optimizer state, or the online tower lacks it")


def phase_train_byol() -> dict:
    spec = BYOL_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        check(e.policy.compute_dtype == torch.bfloat16 and e.model.use_device_augment
              and type(e.optimizer.torch_optimizer).__name__ == "MomentumLARS",
              "BYOL-R50: not the recipe's bf16 / device augment / LARS")
        stats0 = {k: v.clone() for k, v in e.model.state_dict().items() if "running" in k}
        ema = _EmaCheck(spec.tag, e)
        e.train_step = ema
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        e.train_step = ema.step_fn
        _no_optimizer_state_on(spec, e)
        _stats_moved(spec, e, stats0, ("online.", "target."))
        log("[train] BYOL-R50: the EMA rule held at every step, the target has no optimizer "
            "state, BatchNorm statistics of both towers moved")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no BYOL-R50 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 8.0)),
                   ema_max_rel_err=ema.worst)
        del e, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


# f32 on both sides, summed in another order, with exp, cos and sin of another
# library: 1e-5 of the views' largest magnitude (2.64 after normalize). At strength
# 1.0 the jitter's values reach 1.8^3 before the clip, where an f32 ulp is 4.8e-7,
# and normalize multiplies by 1 / 0.225: on an H100 the largest difference was
# 1.73e-5, at a value of 0.23 (3.9e-6 in [0, 1])
SIMCLR_AUG_TOL = 1e-5


def _simclr_augment_card_vs_cpu() -> dict:
    """The plain `simclr_device_augment_core` on the card against the CPU, on
    the same draws and SimCLR's per-card views [128, 224, 224, 3] uint8, at
    the recipe's jitter strength 1.0."""
    rng = np.random.RandomState(14)
    views = [torch.from_numpy(rng.randint(0, 256, (SIMCLR_SPEC.batch, IMG, IMG, 3),
                                          dtype=np.uint8)) for _ in range(2)]
    draws = simclr_draws(SIMCLR_SPEC.batch, torch.Generator().manual_seed(14),
                         torch.device("cpu"), jitter_strength=1.0)
    want = simclr_device_augment_core(*views, draws)
    on_card = [{k: ({j: t.cuda() for j, t in v.items()} if isinstance(v, dict) else v.cuda())
                for k, v in d.items()} for d in draws]
    got = [g.cpu() for g in simclr_device_augment_core(*(v.cuda() for v in views), on_card)]
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    check(err <= SIMCLR_AUG_TOL * scale,
          f"SimCLR device augmentation, card vs CPU: max abs err {err} of values up to {scale}")
    log(f"[augment] SimCLR's plain device augmentation on [{SIMCLR_SPEC.batch}, {IMG}, {IMG}, 3] "
        f"x 2 views, card vs CPU on the same draws: max abs err {err:.3g}, values up to "
        f"{scale:.4g} (limit {SIMCLR_AUG_TOL} of that)")
    return {"aug_max_abs_err": err, "aug_max_abs_value": scale}


def phase_train_simclr() -> dict:
    spec = SIMCLR_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        out.update(_simclr_augment_card_vs_cpu())
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        check(e.policy.compute_dtype == torch.bfloat16 and e.model.use_device_augment
              and e.model.jitter_strength == 1.0
              and type(e.optimizer.torch_optimizer).__name__ == "MomentumLARS"
              and e.config["LRScheduler"]["name"] == "simclrCosineWarmup",
              "SimCLR-R50: not the recipe's bf16 / device augment / LARS / simclrCosineWarmup")
        stats0 = {k: v.clone() for k, v in e.model.state_dict().items() if "running" in k}
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        _stats_moved(spec, e, stats0, ("backbone.", "neck."))
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no SimCLR-R50 checkpoint")
        out.update(_ssl_report(spec, e, batch))
        log("[train] SimCLR-R50: every loss finite, every acc1 in [0, 1], BatchNorm statistics "
            "of the backbone and the neck moved")
        del e, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


class _QueueCheck:
    """Wraps a queue's train step (MoCo, MoCo-BYOL; DenseCL's two queues on
    one pointer): after step t the pointer is N t mod K, in each queue the N
    columns written at step t are unit-norm, and every column not yet
    written holds its init bitwise."""

    def __init__(self, tag: str, engine: Engine, names=("queue",)):
        self.tag, self.engine, self.step_fn = tag, engine, engine.train_step
        self.queues0 = {q: getattr(engine.model, q).clone() for q in names}
        self.worst_norm_err = 0.0

    def __call__(self, state, batch):
        model = self.engine.model
        n, k = self.engine.global_batch_size, model.K
        start = int(model.queue_ptr)
        metrics = self.step_fn(state, batch)
        t = state.step
        check(int(model.queue_ptr) == n * t % k,
              f"{self.tag}: queue_ptr {int(model.queue_ptr)} after {t} steps, want {n * t % k}")
        for name, queue0 in self.queues0.items():
            queue = getattr(model, name)
            norms = queue[:, start:start + n].norm(dim=0)
            self.worst_norm_err = max(self.worst_norm_err, (norms - 1).abs().max().item())
            check(self.worst_norm_err <= 1e-5, f"{self.tag}: written keys' norms off 1 by "
                                               f"{self.worst_norm_err} at step {t} ({name})")
            check(torch.equal(queue[:, n * t:], queue0[:, n * t:]),
                  f"{self.tag}: a column of {name} past {n * t} changed by step {t}")
        return metrics

    def __getattr__(self, name):
        return getattr(self.step_fn, name)


@contextlib.contextmanager
def _one_permutation(n: int):
    """MoCo's shuffle-BN draws one fixed permutation of n, on every device."""
    perm = np.random.RandomState(15).permutation(n)
    orig = moco.shuffle_permutation
    moco.shuffle_permutation = lambda n_, generator, device: torch.from_numpy(perm).to(device)
    try:
        yield
    finally:
        moco.shuffle_permutation = orig


def phase_train_moco() -> dict:
    spec = MOCO_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        splits = {m.num_splits for m in e.model.modules() if isinstance(m, SplitBatchNorm)}
        check(e.policy.compute_dtype == torch.bfloat16 and splits == {8}
              and e.model.K == 65536 and e.model.queue.dtype == torch.float32
              and e.config["Optimizer"]["name"] == "Momentum",
              f"MoCoV2-R50: not the recipe's bf16 / bn_splits 8 ({splits}) / K 65,536 / Momentum")
        stats0 = {k: v.clone() for k, v in e.model.state_dict().items() if "running" in k}
        ema = _EmaCheck(spec.tag, e)
        queue = _QueueCheck(spec.tag, e)
        queue.step_fn, e.train_step = ema, queue
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        e.train_step = ema.step_fn
        check(ema.m_fn(0) == ema.m_fn(TRAIN_STEPS) == float(np.float32(0.999)),
              "MoCoV2-R50: the key encoder's momentum is not the constant 0.999")
        _no_optimizer_state_on(spec, e)
        _stats_moved(spec, e, stats0, ("encoder_q.", "encoder_k."))
        log(f"[train] MoCoV2-R50: the EMA rule (m 0.999) held at every step "
            f"(max rel err {ema.worst:.3g}), encoder_k has no optimizer state, queue_ptr "
            f"{int(e.model.queue_ptr)} = {spec.batch} x {TRAIN_STEPS}, written keys unit-norm to "
            f"{queue.worst_norm_err:.3g}, unwritten columns bitwise at their init")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no MoCoV2-R50 checkpoint")
        saved = {k: e.model.state_dict()[k].clone() for k in ("queue", "queue_ptr")}
        out.update(_ssl_report(spec, e, batch), ema_max_rel_err=ema.worst,
                   key_norm_max_err=queue.worst_norm_err)
        del e, batch, queue
        torch.cuda.empty_cache()

        def restored(engine):
            state = engine.model.state_dict()
            check(all(torch.equal(state[k], v) for k, v in saved.items()),
                  "MoCoV2-R50: the resumed queue or pointer differs from the checkpoint's")
            log("[train] MoCoV2-R50 resume: queue and queue_ptr bitwise as saved")

        _ssl_resume(spec, tmp, ckpt, restored)
    return out


def phase_train_simsiam() -> dict:
    spec = SIMSIAM_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        check(e.policy.compute_dtype == torch.bfloat16
              and e.config["Optimizer"]["name"] == "Momentum",
              "SimSiam-R50: not the recipe's bf16 / Momentum")
        stats0 = {k: v.clone() for k, v in e.model.state_dict().items() if "running" in k}
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        _stats_moved(spec, e, stats0, ("encoder.", "predictor."))
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no SimSiam-R50 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(-1.0, 1.0)))
        log("[train] SimSiam-R50: every loss finite and in [-1, 1], BatchNorm statistics of the "
            "encoder and the predictor moved")
        del e, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


def _host_backends(dataset) -> list:
    """(transform, backend) of every host transform that has a backend
    (decode, resize), found by walking the dataset's transforms."""
    found, seen = set(), set()

    def walk(obj, depth: int) -> None:
        if depth > 8 or id(obj) in seen or isinstance(obj, (str, bytes, int, float, np.ndarray)):
            return
        seen.add(id(obj))
        if isinstance(getattr(obj, "backend", None), str):
            found.add((type(obj).__name__, obj.backend))
        items = obj if isinstance(obj, (list, tuple)) else (
            obj.values() if isinstance(obj, dict) else getattr(obj, "__dict__", {}).values())
        for v in items:
            walk(v, depth + 1)

    walk(dataset, 0)
    return sorted(found)


def _loss_mix(tag: str, hist: list, parts: dict) -> float:
    """The largest relative difference of the logged loss from the weighted sum
    of its logged parts ({name: weight}) over the run: an f32 sum of f32
    scalars against its double."""
    mix = max(abs(h["loss"] - sum(w * h[k] for k, w in parts.items())) / abs(h["loss"])
              for h in hist)
    check(mix <= 1e-6, f"{tag}: loss is not {parts} of its parts ({mix})")
    return mix


def phase_train_mocobyol() -> dict:
    from passl_tpu_torch.data import transforms as host_transforms

    spec = MOCOBYOL_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and m.K == 65536
              and tuple(m.queue.shape) == (256, 65536) and m.queue.dtype == torch.float32
              and type(e.optimizer.torch_optimizer).__name__ == "MomentumLARS"
              and e.config["Optimizer"]["name"] == "MomentumLARS",
              "MoCoBYOL-R50: not the recipe's bf16 / K 65,536 / dim 256 / LARS")
        backends = _host_backends(e.train_dataloader.dataset)
        log(f"[train] MoCoBYOL-R50 host transforms: the config asks for cv2; cv2 importable: "
            f"{host_transforms._HAS_CV2}; the transforms run {backends}")
        stats0 = {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
        ema = _EmaCheck(spec.tag, e)
        queue = _QueueCheck(spec.tag, e)
        queue.step_fn, e.train_step = ema, queue
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        e.train_step = ema.step_fn
        m0, m_end = ema.m_fn(0), ema.m_fn(TRAIN_STEPS)
        check(abs(m0 - 0.99) <= 1e-6 and 0.99 < m_end < 1.0,
              f"MoCoBYOL-R50: the target's momentum is not the cosine from 0.99: {m0}, {m_end}")
        _no_optimizer_state_on(spec, e)
        _stats_moved(spec, e, stats0, ("online.", "target.", "predictor."))
        hist = e.train_loop.history
        mix = _loss_mix(spec.tag, hist, {"byol_loss": m.byol_weight,
                                         "contrast_loss": m.contrast_weight})
        log(f"[train] MoCoBYOL-R50: byol_loss " + ", ".join(f"{h['byol_loss']:.5f}" for h in hist)
            + "; contrast_loss " + ", ".join(f"{h['contrast_loss']:.5f}" for h in hist)
            + f"; loss = {m.byol_weight} byol + {m.contrast_weight} contrast to {mix:.3g}; the EMA "
            f"rule (cosine from 0.99, m {m0:.6f} -> {ema.m_fn(TRAIN_STEPS - 1):.6f}) held at every "
            f"step (max rel err {ema.worst:.3g}), the target has no optimizer state, queue_ptr "
            f"{int(m.queue_ptr)} = {spec.batch} x {TRAIN_STEPS}, written keys unit-norm to "
            f"{queue.worst_norm_err:.3g}, unwritten columns bitwise at their init")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no MoCoBYOL-R50 checkpoint")
        saved = {k: m.state_dict()[k].clone() for k in ("queue", "queue_ptr")}
        out.update(_ssl_report(spec, e, batch), ema_max_rel_err=ema.worst,
                   key_norm_max_err=queue.worst_norm_err, loss_mix_rel_err=mix,
                   host_backends=backends)
        del e, m, batch, queue
        torch.cuda.empty_cache()

        def restored(engine):
            state = engine.model.state_dict()
            check(all(torch.equal(state[k], v) for k, v in saved.items()),
                  "MoCoBYOL-R50: the resumed queue or pointer differs from the checkpoint's")
            log("[train] MoCoBYOL-R50 resume: queue and queue_ptr bitwise as saved")

        _ssl_resume(spec, tmp, ckpt, restored)
    return out


class _PrototypeCheck:
    """Wraps SwAV's train step: after every step each prototype (a row of the
    weight) is unit-norm within 1e-5; records how far the prototypes moved
    (the largest entry's change) in each step."""

    def __init__(self, engine: Engine):
        self.engine, self.step_fn = engine, engine.train_step
        self.moved, self.worst_norm_err = [], 0.0

    def __call__(self, state, batch):
        w = self.engine.model.prototypes.weight
        before = w.detach().clone()
        metrics = self.step_fn(state, batch)
        self.worst_norm_err = max(self.worst_norm_err,
                                  (w.detach().norm(dim=1) - 1).abs().max().item())
        check(self.worst_norm_err <= 1e-5, f"SwAV-R50: a prototype's norm is off 1 by "
                                           f"{self.worst_norm_err} after step {state.step}")
        self.moved.append((w.detach() - before).abs().max().item())
        return metrics

    def __getattr__(self, name):
        return getattr(self.step_fn, name)


def _sinkhorn_card_vs_cpu(model, crops) -> dict:
    """The sinkhorn target of crop 0's f32 scores (the trained model in eval)
    on the card against the CPU on the same scores."""
    from passl_tpu_torch.models.swav import sinkhorn_knopp

    model.eval()
    with torch.no_grad():
        scores = model.prototypes(model.neck(model.backbone(crops[0])).float())
    model.train()
    q = sinkhorn_knopp(scores, model.epsilon, model.sinkhorn_iterations)
    want = sinkhorn_knopp(scores.cpu(), model.epsilon, model.sinkhorn_iterations)
    rel = ((q.cpu() - want).abs() / want.abs()).max().item()
    row_err = (q.sum(dim=1) - 1).abs().max().item()
    check(rel <= 1e-5 and row_err <= 1e-5,
          f"SwAV-R50 sinkhorn card vs CPU: rel err {rel}, row sums off 1 by {row_err}")
    log(f"[train] SwAV-R50 sinkhorn on {list(scores.shape)} f32 scores, card vs CPU: max rel err "
        f"{rel:.3g}, each sample's row of q sums to 1 within {row_err:.3g}")
    return {"sinkhorn_rel_err": rel, "sinkhorn_row_err": row_err}


def phase_train_swav() -> dict:
    spec = SWAV_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and m.num_crops == (2, 6)
              and tuple(m.prototypes.weight.shape) == (3000, 128)
              and m.prototypes.weight.dtype == torch.float32
              and type(e.optimizer.torch_optimizer).__name__ == "MomentumLARS"
              and e.optimizer.group_of("prototypes.weight").freeze_steps == SWAV_FREEZE,
              "SwAV-R50: not the recipe's bf16 / 2 + 6 crops / 3,000 f32 prototypes / LARS / "
              f"a freeze of {SWAV_FREEZE}")
        stem_calls = []
        hook = m.backbone.bn1.register_forward_hook(lambda *_: stem_calls.append(1))
        proto = _PrototypeCheck(e)
        e.train_step = proto
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        check([tuple(c.shape[1:3]) for c in batch] == [(IMG, IMG)] * 2 + [(96, 96)] * 6,
              f"SwAV-R50 crops {[tuple(c.shape) for c in batch]}")
        e.train_step = proto.step_fn
        hook.remove()
        check(len(stem_calls) == 2 * TRAIN_STEPS,
              f"SwAV-R50: the stem BatchNorm took {len(stem_calls)} batches in {TRAIN_STEPS} "
              "steps, want 2 a step (one per crop resolution)")
        frozen, free = proto.moved[:SWAV_FREEZE], proto.moved[SWAV_FREEZE:]
        # frozen: lr 0, then the renormalization of unit rows rounds (1e-6)
        check(max(frozen) <= 1e-6 < min(free),
              f"SwAV-R50: prototypes moved {proto.moved} by step, frozen for {SWAV_FREEZE}")
        log(f"[train] SwAV-R50: prototypes' largest move by step "
            + ", ".join(f"{v:.3g}" for v in proto.moved)
            + f" (frozen for {SWAV_FREEZE}), unit-norm to {proto.worst_norm_err:.3g} after every "
            f"step; the stem BatchNorm took {len(stem_calls)} batches in {TRAIN_STEPS} steps")
        out.update(_sinkhorn_card_vs_cpu(m, batch))
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no SwAV-R50 checkpoint")
        out.update(_ssl_report(spec, e, batch), prototype_moves=proto.moved,
                   prototype_norm_max_err=proto.worst_norm_err)
        del e, m, batch, proto
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out

# ----------------------------------------- SSL: DenseCL, PixPro (ResNet-50), FastMoCo (ResNet-18)

DENSECL_SPEC = SSLSpec("DenseCL-R50", os.path.join(REPO, "configs", "densecl",
                                                   "densecl_r50_in1k.yaml"),
                       256,  # the config's own batch, in 8 BatchNorm splits
                       16, R50_FIRST_STEP, "encoder_q.backbone.", "encoder_k.",  # 2 images a split
                       f32_error_ratio=2.0, draws=lambda: _one_permutation(16),
                       watched=R50_WATCHED)
PIXPRO_SPEC = SSLSpec("PixPro-R50", os.path.join(REPO, "configs", "pixpro", "pixpro_r50_in1k.yaml"),
                      128,  # pairs: the recipe's 1,024 over 8 cards
                      4, R50_FIRST_STEP, "encoder.backbone.", "encoder_k.", f32_error_ratio=2.0,
                      watched=R50_WATCHED)
FASTMOCO_SPEC = SSLSpec("FastMoCo-R18", os.path.join(REPO, "configs", "moco",
                                                     "fastmoco_r18_synthetic.yaml"),
                        128,  # pairs: the config's own batch, at its own 32 x 32
                        8, (), "online.backbone.", "target.", img=32, watched=6,
                        f32_error_ratio=2.0)


def phase_train_densecl() -> dict:
    spec = DENSECL_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        splits = {x.num_splits for x in m.modules() if isinstance(x, SplitBatchNorm)}
        check(e.policy.compute_dtype == torch.bfloat16 and splits == {8} and m.K == 65536
              and tuple(m.queue.shape) == tuple(m.queue2.shape) == (128, 65536)
              and m.queue.dtype == m.queue2.dtype == torch.float32
              and e.config["Optimizer"]["name"] == "Momentum",
              f"DenseCL-R50: not the recipe's bf16 / bn_splits 8 ({splits}) / two queues of "
              "128 x 65,536 / Momentum")
        stats0 = {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
        ema = _EmaCheck(spec.tag, e)
        queue = _QueueCheck(spec.tag, e, ("queue", "queue2"))
        queue.step_fn, e.train_step = ema, queue
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        e.train_step = ema.step_fn
        check(ema.m_fn(0) == ema.m_fn(TRAIN_STEPS) == float(np.float32(0.999)),
              "DenseCL-R50: the key encoder's momentum is not the constant 0.999")
        _no_optimizer_state_on(spec, e)
        _stats_moved(spec, e, stats0, ("encoder_q.", "encoder_k."))
        hist = e.train_loop.history
        lam = m.loss_lambda
        mix = _loss_mix(spec.tag, hist, {"loss_single": 1 - lam, "loss_dense": lam})
        log(f"[train] DenseCL-R50: loss_single " + ", ".join(f"{h['loss_single']:.5f}" for h in hist)
            + "; loss_dense " + ", ".join(f"{h['loss_dense']:.5f}" for h in hist)
            + f"; loss = {1 - lam} single + {lam} dense to {mix:.3g}; the EMA rule (m 0.999) held "
            f"at every step (max rel err {ema.worst:.3g}), encoder_k has no optimizer state, one "
            f"queue_ptr {int(m.queue_ptr)} = {spec.batch} x {TRAIN_STEPS} for both queues, the "
            f"keys written into queue and queue2 at the same columns and unit-norm to "
            f"{queue.worst_norm_err:.3g}, unwritten columns of both bitwise at their init")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no DenseCL-R50 checkpoint")
        saved = {k: m.state_dict()[k].clone() for k in ("queue", "queue2", "queue_ptr")}
        out.update(_ssl_report(spec, e, batch), ema_max_rel_err=ema.worst,
                   key_norm_max_err=queue.worst_norm_err, loss_mix_rel_err=mix)
        del e, m, batch, queue
        torch.cuda.empty_cache()

        def restored(engine):
            state = engine.model.state_dict()
            check(all(torch.equal(state[k], v) for k, v in saved.items()),
                  "DenseCL-R50: the resumed queues or pointer differ from the checkpoint's")
            log("[train] DenseCL-R50 resume: queue, queue2 and queue_ptr bitwise as saved")

        _ssl_resume(spec, tmp, ckpt, restored)
    return out


def phase_train_pixpro() -> dict:
    spec = PIXPRO_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16
              and tuple(m.encoder.neck.conv1.weight.shape) == (4096, 2048, 1, 1)
              and tuple(m.encoder.neck.conv2.weight.shape) == (256, 4096, 1, 1)
              and len(m.propagation.transform) == 1 and m.propagation.p == 2.0
              and type(e.optimizer.torch_optimizer).__name__ == "MomentumLARS",
              "PixPro-R50: not the recipe's bf16 / MLP2d 2048 -> 4096 -> 256 / one transform, "
              "p 2 / MomentumLARS")
        seen: list = []

        def record(module, args):  # what the main path hands the model, once
            if not seen:
                b = args[0]
                seen.append({k: (tuple(v.shape), v.dtype, v.device.type) for k, v in b.items()}
                            if isinstance(b, dict) else type(b).__name__)
                seen.append(float((b["coord1"][:, 0] > b["coord1"][:, 2]).float().mean()))

        hook = m.register_forward_pre_hook(record)
        stats0 = {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
        ema = _EmaCheck(spec.tag, e)
        e.train_step = ema
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        e.train_step = ema.step_fn
        hook.remove()
        views, boxes = ((spec.batch, IMG, IMG, 3), torch.float32, "cuda"), \
            ((spec.batch, 4), torch.float32, "cuda")
        check(seen[0] == {"view1": views, "view2": views, "coord1": boxes, "coord2": boxes}
              and 0.0 < seen[1] < 1.0,
              f"PixPro-R50: the model took {seen}, want the views and the boxes on the card in "
              "f32, some of them flipped")
        m0, m_last = ema.m_fn(0), ema.m_fn(TRAIN_STEPS - 1)
        check(abs(m0 - 0.99) <= 1e-6 and 0.99 < m_last < 1.0,
              f"PixPro-R50: the key tower's momentum is not the cosine from 0.99: {m0}, {m_last}")
        _no_optimizer_state_on(spec, e)
        _stats_moved(spec, e, stats0, ("encoder.", "encoder_k."))
        log(f"[train] PixPro-R50: the model took {seen[0]} from the loader, {seen[1]:.3f} of the "
            f"first view's boxes flipped (x1 > x2); the EMA rule (cosine from 0.99, m {m0:.6f} -> "
            f"{m_last:.6f}) held at every step (max rel err {ema.worst:.3g}), "
            "encoder_k has no optimizer state, BatchNorm statistics of both towers moved")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no PixPro-R50 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(-4.0, 4.0)),
                   ema_max_rel_err=ema.worst, flipped_share=seen[1])
        del e, m, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


def phase_train_fastmoco() -> dict:
    spec = FASTMOCO_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and m.divide == 2 and m.combine_r == 2
              and m.online.backbone.cifar_stem and m.online.backbone.out_channels == 512
              and e.config["Optimizer"]["name"] == "Momentum",
              "FastMoCo-R18: not the config's bf16 / 2 x 2 patches, pairs / ResNet-18 with the "
              "CIFAR stem / Momentum")
        rows: list = []
        hook = m.predictor.register_forward_pre_hook(lambda mod, args: rows.append(
            tuple(args[0].shape)))
        stats0 = {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
        ema = _EmaCheck(spec.tag, e)
        e.train_step = ema
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        e.train_step = ema.step_fn
        hook.remove()
        # C(4, 2) = 6 combinations of each image's patches, once a view
        want = [(6 * spec.batch, m.online.neck.out_channels)] * 2 * TRAIN_STEPS
        check(rows == want, f"FastMoCo-R18: the predictor took {rows[:2]}..., want {want[0]} "
                            "twice a step")
        # the config's one epoch of 1,024 images is the run's 8 steps: the cosine
        # reaches 1 at step 8, after the last update
        m0, m_last = ema.m_fn(0), ema.m_fn(TRAIN_STEPS - 1)
        check(abs(m0 - 0.99) <= 1e-6 and 0.99 < m_last < 1.0 and e.total_steps == TRAIN_STEPS,
              f"FastMoCo-R18: the target's momentum is not the cosine from 0.99 over the run: "
              f"{m0}, {m_last}")
        _no_optimizer_state_on(spec, e)
        _stats_moved(spec, e, stats0, ("online.", "target.", "predictor."))
        log(f"[train] FastMoCo-R18: the predictor took {rows[0]} (6 combinations of 2 x 2 "
            f"patches of {spec.batch} images) twice a step; the EMA rule (cosine from 0.99, m "
            f"{m0:.6f} -> {m_last:.6f}) held at every step (max rel err "
            f"{ema.worst:.3g}), the target has no optimizer state, BatchNorm statistics of both "
            "towers and the predictor moved")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no FastMoCo-R18 checkpoint")
        out.update(_ssl_report(spec, e, batch), ema_max_rel_err=ema.worst)
        del e, m, batch
        torch.cuda.empty_cache()
        # the config's one epoch ended at step 8: the resumed step opens a second
        _ssl_resume(spec, tmp, ckpt, overrides=("Global.epochs=2",))
    return out


# ------------------------------------ the rest of the ViT family: DeiT, ViT-L remat, MoCo v3, MAE

DEIT_CONFIG = os.path.join(REPO, "configs", "classification", "deit_base_patch16_224_in1k.yaml")
DEIT_NAME = "DeiT_base_distilled_patch16_224"  # 198 tokens: the class and distillation tokens


def phase_serve_deit() -> int:
    """DeiT-B distilled at 224 through export and Predictor (the in1k DeiT
    config with its model named the distilled one): the flash path against the
    einsum path on the same weights, 12 flash launches per forward."""
    out = _serve_kernel_vs_einsum("DeiT-B distilled", DEIT_CONFIG, DEIT_NAME, VIT_BLOCKS,
                                  flash_attention, "Model.attn_impl=flash",
                                  common=(f"Model.name={DEIT_NAME}",))
    # as ViT-B/16's serving check: the einsum path rounds its scores and softmax
    # to bf16 (the config's softmax_dtype) where the kernel keeps them in f32
    check(out["bf16"][0] >= 0.999, f"DeiT-B distilled bf16 logits disagree: {out['bf16']}")
    check(out["bf16, softmax f32"][0] >= 0.9999,
          f"DeiT-B distilled bf16 (softmax f32) logits disagree: {out['bf16, softmax f32']}")
    check(out["f32"][1] <= 1e-4, f"DeiT-B distilled f32 logits disagree: {out['f32']}")
    return out["bf16"][2]


def _flash_launches() -> tuple:
    """The three flash kernels' launches (forward, dK/dV, dQ) since the last reset."""
    return tuple(_launches(VIT_TRAIN).values())


VITL_CONFIG = os.path.join(REPO, "configs", "classification", "vit_large_patch16_384_ft_in1k.yaml")
# 12 of the config's 24 blocks at full width (1024, 16 heads, 577 tokens): a cut
# that keeps chip_smoke.py inside its time; the policies' gradients, peaks and
# launches are held the same way at any depth
VITL_BLOCKS = 12
VITL_BATCH = 32  # the JAX package's bench row (bench.py:819)
VITL_STEPS = 4
VITL_TRAIN = TrainSpec("ViT-L/16-384", VITL_CONFIG, VITL_BATCH, VITL_BLOCKS, VITL_BLOCKS,
                       flash_attention, (flash_attention_dkv, flash_attention_dq),
                       # random weights: the finetune config's pretrained file is not here
                       ("Model.attn_impl=flash", f"Global.max_train_step={VITL_STEPS}",
                        "Global.pretrained_model=None", f"Model.depth={VITL_BLOCKS}"), (), (),
                       lambda n: n.endswith("attn.qkv.weight"))
REMAT_POLICIES = ("nothing", "dots_no_batch", "dots")


def phase_train_vitl_remat() -> dict:
    """ViT-L/16 at 384 (577 tokens), the config's remat (dots_no_batch) and
    drop path 0.1, on the flash path: the first step's gradients under each
    policy and without remat, from one init, batch and generator state, with
    each run's peak memory and launches; then VITL_STEPS steps of the config."""
    spec = VITL_TRAIN
    out: dict = {}
    pol: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        batch, flat, qkv0 = None, {}, {}
        for policy in (None, *REMAT_POLICIES):
            tag = policy or "no remat"
            remat = (("Model.remat=False",) if policy is None
                     else ("Model.remat=True", f"Model.remat_policy={policy}"))
            cfg = _train_config(spec, os.path.join(tmp, tag), *spec.kernel, *remat, workers=0)
            e = Engine(cfg, mode="train", device="cuda")
            check(e.model.remat_policy == policy and len(e.model.blocks) == VITL_BLOCKS
                  and e.model.blocks[-1].drop_path1.rate > 0.09, f"ViT-L/16-384 {tag}: the model")
            if batch is None:
                batch = _first_batch(cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(VIT_TRAIN)
            loss, g = _grads(e, batch)
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = _flash_launches()
            prof: dict = {}
            line = _profile(lambda: _grads(e, batch), prof)  # the host's cost of each policy
            log(f"[profile] ViT-L/16-384 forward and backward, {tag}: {line}")
            flat[policy] = torch.cat([g[n].flatten() for n in sorted(g)]).cpu()
            qkv = {n: g[n].cpu() for n in g if spec.kernel_fed(n)}
            del e, g
            gc.collect()  # the profiler's events hold the engine: free it before the next peak
            torch.cuda.empty_cache()
            want = (VITL_BLOCKS * (1 if policy is None else 2), VITL_BLOCKS, VITL_BLOCKS)
            check(launches == want, f"ViT-L/16-384 {tag}: launches {launches}, want {want} "
                                    "(fwd, dkv, dq): the recompute runs the flash forward again")
            rec = {"loss": loss, "peak_GiB": peak, "launches": launches,
                   "fwd_bwd_busy_ms": prof["busy_ms"], "fwd_bwd_wall_ms": prof["wall_ms"]}
            if policy is not None:
                base = flat[None]
                rec["grad_cos"] = _cos(flat[policy].double(), base.double())
                rec["bitwise"] = bool(torch.equal(flat[policy], base))
                rec["qkv_cos_min"] = min(_cos(qkv[n].flatten().double(),
                                              qkv0[n].flatten().double()) for n in qkv)
                # the same kernels on the same inputs, the saved products
                # recomputed by the same kernels: only a reordering could move them
                check(rec["grad_cos"] >= 0.99999 and rec["qkv_cos_min"] >= 0.99999
                      and abs(loss - pol[None]["loss"]) <= 1e-6 * abs(loss),
                      f"ViT-L/16-384 {tag}: gradients differ from no remat's: {rec}")
            else:
                qkv0 = qkv
            pol[policy] = rec
            log(f"[train] ViT-L/16-384 first step, {tag}: loss {loss:.6f}, peak {peak:.2f} GiB, "
                f"launches (fwd, dkv, dq) {launches}"
                + ("" if policy is None else f", gradient cosine to no remat {rec['grad_cos']:.9f}"
                   f" (lowest qkv {rec['qkv_cos_min']:.9f}), bitwise {rec['bitwise']}"))
        out["policies"] = {str(k): v for k, v in pol.items()}
        for policy in ("nothing", "dots_no_batch"):
            check(pol[policy]["peak_GiB"] < pol[None]["peak_GiB"],
                  f"ViT-L/16-384: {policy} peaks at {pol[policy]['peak_GiB']:.2f} GiB, not below "
                  f"no remat's {pol[None]['peak_GiB']:.2f}")
        del flat, qkv0

        # the main path: the config as it stands (dots_no_batch), VITL_STEPS steps
        e = Engine(_train_config(spec, os.path.join(tmp, "main"), *spec.kernel), mode="train",
                   device="cuda")
        check(e.model.remat_policy == "dots_no_batch", "ViT-L/16-384: not the config's remat")
        _reset_launches(VIT_TRAIN)
        torch.cuda.reset_peak_memory_stats()
        e.train()
        launches = _flash_launches()
        want = (2 * VITL_BLOCKS * VITL_STEPS, VITL_BLOCKS * VITL_STEPS, VITL_BLOCKS * VITL_STEPS)
        check(launches == want, f"ViT-L/16-384: {VITL_STEPS} steps launched {launches}, want {want}")
        out["launches"] = launches
        out.update(_step_report("ViT-L/16-384 bf16 remat dots_no_batch", e, VITL_BATCH,
                                steps=VITL_STEPS))
        prof: dict = {}
        log(f"[profile] ViT-L/16-384 train step, bf16, remat dots_no_batch: "
            f"{_profile(lambda: float(e.train_step(e.state, batch)['loss']), prof)}")
        out.update(busy_ms=prof["busy_ms"], idle_share=1 - prof["busy_ms"] / prof["wall_ms"])
        log(f"[train] ViT-L/16-384: flash launches a step (fwd, dkv, dq) "
            f"{tuple(n // VITL_STEPS for n in launches)}; device busy per step "
            f"{prof['busy_ms']:.3f} ms")
        del e, batch
        torch.cuda.empty_cache()
    return out


def _flash_step_launches(tag: str, steps: int, per_step: tuple) -> None:
    got = _flash_launches()
    want = tuple(steps * n for n in per_step)
    check(got == want, f"{tag}: {steps} steps launched (fwd, dkv, dq) {got}, want {want}")
    log(f"[train] {tag}: flash launches a step (fwd, dkv, dq) {per_step}")


class _StopGradCheck:
    """Wraps MoCo v3's train step: with stop_grad_conv1 the patch embedding
    takes no gradient, so AdamW moves its kernel by the decay alone, p (1 - lr
    wd) each step, and its bias (no decay: 1-D) not at all."""

    def __init__(self, tag: str, engine: Engine, prefix: str = "base.encoder.patch_embed.proj"):
        self.tag, self.step_fn = tag, engine.train_step
        named = dict(engine.model.named_parameters())
        self.w, self.b = named[f"{prefix}.weight"], named[f"{prefix}.bias"]
        groups = engine.optimizer.torch_optimizer.param_groups
        self.group = next(g for g in groups if any(p is self.w for p in g["params"]))
        self.worst, self.decays = 0.0, []

    def __call__(self, state, batch):
        w0, b0 = self.w.detach().clone(), self.b.detach().clone()
        metrics = self.step_fn(state, batch)
        decay = 1.0 - self.group["lr"] * self.group["weight_decay"]
        want = w0 * decay
        # a few f32 roundings of the kernel; one AdamW step of a gradient would
        # move each entry by about the lr (1e-5 here), a thousand times more
        err = ((self.w.detach() - want).abs().max() / w0.abs().max()).item()
        self.worst = max(self.worst, err)
        self.decays.append(decay)
        # the warmup's lr is 0 at step 0, so the kernel moves from step 1 on
        moved = not torch.equal(self.w.detach(), w0)
        check(err <= 4 * float(np.finfo(np.float32).eps) and moved == (decay < 1.0),
              f"{self.tag}: the patch embedding moved by other than the decay at step "
              f"{state.step}: {err}, decay {decay}, moved {moved}")
        check(torch.equal(self.b.detach(), b0), f"{self.tag}: the patch embedding's bias moved")
        return metrics

    def __getattr__(self, name):
        return getattr(self.step_fn, name)


MOCOV3_SPEC = SSLSpec(
    "MoCoV3-ViT-B/16", os.path.join(REPO, "configs", "mocov3", "mocov3_vit_base_in1k.yaml"),
    128,  # pairs: the JAX package's bench row (bench.py:449)
    # 4 pairs, on the einsum path (the flash kernels take no f64; the flash
    # path's gradients are held against the einsum path's below). The card's
    # f32 error from f64 read 1.36-5.27 times the CPU's at the config's seed
    # and four others (4.91 at 42), in the blocks, head and predictor alike;
    # TF32 products read 2.4e6 times: 20 tells the two apart
    # (tests/perf/mocov3_f32_spread.py, H100 80GB HBM3 at 700 W; at 12 blocks)
    4, ("Model.encoder.attn_impl=einsum", f"Model.encoder.depth={FIRST_STEP_BLOCKS}"),
    "base.encoder.", "momentum.", overrides=("Model.encoder.attn_impl=flash",),
    f32_error_ratio=20.0, watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.startswith("base.encoder.blocks.") and n.endswith("attn.qkv.weight"))
MOCOV3_BLOCKS = 12


MOCOV3_GRAD_PAIRS = 32


def _mocov3_flash_vs_einsum(spec: SSLSpec, tmp: str) -> dict:
    """The flash path's first-step gradients against the einsum path's from one
    init and batch, in f32 (TF32 off) at MOCOV3_GRAD_PAIRS pairs, and one
    step's launches. In bf16 the two paths round the scores and p at other
    places, and the contrastive loss at T = 0.2 over BatchNorm heads turns that
    rounding into gradient directions that part by more than the check's 1e-3
    even where both paths are plain PyTorch: f32 holds the kernels, whose bf16
    versions the flash phases hold against their plain versions. At 4 of the
    12 blocks (a cut for the script's time), every width kept."""
    blocks = FIRST_STEP_BLOCKS
    engines = [Engine(_ssl_config(spec, os.path.join(tmp, f"grads_{impl}"), MOCOV3_GRAD_PAIRS,
                                  "FP16.enable=False", f"Model.encoder.attn_impl={impl}",
                                  f"Model.encoder.depth={blocks}"),
                      mode="train", device="cuda") for impl in ("flash", "einsum")]
    e_k, e_p = engines
    check(_same_start(e_k, e_p), "MoCoV3-ViT-B/16: the two paths start from different weights")
    batch = _ssl_first_batch(e_k, "cuda")
    _reset_launches(VIT_TRAIN)
    loss_k, g_k = _grads(e_k, batch)
    one = _flash_launches()
    want = (4 * blocks, 2 * blocks, 2 * blocks)
    check(one == want, f"MoCoV3-ViT-B/16: one f32 step launched {one}, want {want}")
    loss_p, g_p = _grads(e_p, batch)
    check(_flash_launches() == one, "MoCoV3-ViT-B/16: the einsum path launched a kernel")
    for e in engines:
        e.close()
    del engines, e_k, e_p, batch
    names = [n for n in g_k if not n.startswith("momentum.")]
    # in f64: an f32 dot product over 100M entries rounds past 1e-3
    cos_all = _cos(torch.cat([g_k[n].flatten() for n in names]).double(),
                   torch.cat([g_p[n].flatten() for n in names]).double())
    cos_qkv = {n: _cos(g_k[n].flatten().double(), g_p[n].flatten().double())
               for n in names if spec.watch(n)}
    worst = min(cos_qkv, key=cos_qkv.get)
    log(f"[train] MoCoV3-ViT-B/16 first-step gradients, flash vs einsum path, f32, "
        f"{MOCOV3_GRAD_PAIRS} pairs: loss {loss_k:.7f} vs {loss_p:.7f}, cosine overall "
        f"{cos_all:.9f}, lowest of {len(cos_qkv)} qkv weights {cos_qkv[worst]:.9f} ({worst}); "
        f"launches (fwd, dkv, dq) {one}")
    # the same f32 function with the scale after the product and sums in
    # another order: 1e-3 of cosine is far above that, and a wrong term far below
    check(cos_all >= 0.999 and cos_qkv[worst] >= 0.999 and len(cos_qkv) == blocks,
          f"MoCoV3-ViT-B/16: flash and einsum gradients disagree: {cos_all}, {worst}")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
          f"MoCoV3-ViT-B/16: losses disagree: {loss_k} vs {loss_p}")
    del g_k, g_p
    torch.cuda.empty_cache()
    return {"flash_vs_einsum_f32_grad_cos": cos_all, "flash_vs_einsum_f32_qkv_cos_min":
            cos_qkv[worst]}


def phase_train_mocov3() -> dict:
    spec = MOCOV3_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        out.update(_mocov3_flash_vs_einsum(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and m.base.encoder.stop_grad_conv1
              and len(m.base.encoder.blocks) == MOCOV3_BLOCKS
              and m.base.encoder.blocks[0].attn.attn_impl == "flash"
              and tuple(m.base.head.fc0.weight.shape) == (4096, 768)
              and tuple(m.base.predictor.fc1.weight.shape) == (256, 4096)
              and type(e.optimizer.torch_optimizer).__name__ == "AdamW",
              "MoCoV3-ViT-B/16: not the recipe's bf16 / stop_grad_conv1 / 12 flash blocks / "
              "heads 4096 -> 256 / AdamW")
        ema = _EmaCheck(spec.tag, e)
        stop = _StopGradCheck(spec.tag, e)
        stop.step_fn, e.train_step = ema, stop
        want = (4 * MOCOV3_BLOCKS, 2 * MOCOV3_BLOCKS, 2 * MOCOV3_BLOCKS)
        _reset_launches(VIT_TRAIN)
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        e.train_step = ema.step_fn
        _flash_step_launches(spec.tag, TRAIN_STEPS, want)
        check(len(ema.dst) == len(list(m.momentum.parameters()))
              and any(d is p for d in ema.dst for p in m.momentum.predictor.parameters()),
              "MoCoV3-ViT-B/16: the EMA does not move every momentum parameter, the inert "
              "predictor included")
        m0, m_last = ema.m_fn(0), ema.m_fn(TRAIN_STEPS - 1)
        check(abs(m0 - 0.99) <= 1e-6 and 0.99 < m_last < 1.0,
              f"MoCoV3-ViT-B/16: the momentum is not the cosine from 0.99: {m0}, {m_last}")
        _no_optimizer_state_on(spec, e)
        check(stop.decays[-1] < 1.0, f"MoCoV3-ViT-B/16: no decay reached the patch embedding: "
                                     f"{stop.decays}")
        log(f"[train] MoCoV3-ViT-B/16: the EMA rule (cosine from 0.99, m {m0:.6f} -> "
            f"{m_last:.6f}) held at every step on all {len(ema.dst)} momentum parameters, the "
            f"inert predictor's included (max rel err {ema.worst:.3g}); the momentum tower has "
            f"no optimizer state; the patch embedding moved by AdamW's decay alone (worst "
            f"{stop.worst:.3g} of its largest entry; factors {stop.decays[0]:.9f} .. "
            f"{stop.decays[-1]:.9f}), its bias bitwise still")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no MoCoV3-ViT-B/16 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 100.0)),
                   ema_max_rel_err=ema.worst, stop_grad_max_err=stop.worst,
                   launches_per_step=want)
        del e, m, batch, stop, ema
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


@contextlib.contextmanager
def _one_noise(n: int, length: int):
    """MAE's masking draws one fixed noise [n, length] on every device."""
    noise = torch.from_numpy(np.random.RandomState(16).rand(n, length).astype(np.float32))
    orig = mae.masking_noise
    mae.masking_noise = lambda n_, l_, generator, device: noise.to(device)
    try:
        yield
    finally:
        mae.masking_noise = orig


class _MaskCheck:
    """Spies on MAE's masking on the main path: every mask holds `masked` of
    the patches and every ids_restore is a permutation."""

    def __init__(self, masked: int):
        self.masked, self.calls, self.orig = masked, 0, mae.random_masking

    def __enter__(self):
        def spy(x, ratio, noise):
            x_masked, mask, ids_restore = self.orig(x, ratio, noise)
            n, length = mask.shape
            perm = torch.equal(torch.sort(ids_restore, dim=1).values,
                               torch.arange(length, device=mask.device).expand(n, -1))
            check(bool((mask.float().sum(1) == self.masked).all()) and perm,
                  f"MAE: a mask does not hold {self.masked} of {length} patches, or ids_restore "
                  "is no permutation")
            self.calls += 1
            return x_masked, mask, ids_restore

        mae.random_masking = spy
        return self

    def __exit__(self, *exc):
        mae.random_masking = self.orig


MAE_ENCODER_BLOCKS, MAE_DECODER_BLOCKS = 12, 8
MAE_SPEC = SSLSpec(
    "MAE-ViT-B/16", os.path.join(REPO, "configs", "mae", "mae_vit_base_in1k.yaml"),
    256,  # images: the JAX package's bench row (bench.py:279)
    4, ("Model.attn_impl=einsum", f"Model.depth={FIRST_STEP_BLOCKS}",
        f"Model.decoder_depth={FIRST_STEP_BLOCKS}"), "", overrides=("Model.attn_impl=flash",),
    views=1, f32_error_ratio=2.0, watched=2 * FIRST_STEP_BLOCKS,
    watch=lambda n: n.endswith("attn.qkv.weight"), draws=lambda: _one_noise(4, MAE_PATCHES))
MAE_PATCHES, MAE_MASKED = 196, 147  # 14 x 14 patches, 75% masked: 49 stay, 50 tokens with cls


def phase_train_mae() -> dict:
    spec = MAE_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and len(m.blocks) == MAE_ENCODER_BLOCKS
              and len(m.decoder_blocks) == MAE_DECODER_BLOCKS and m.norm_pix_loss
              and m.decoder_blocks[0].attn.num_heads == 16
              and m.decoder_embed.out_features == 512
              and m.blocks[0].attn.attn_impl == "flash",
              "MAE-ViT-B/16: not the recipe's bf16 / 12 + 8 flash blocks / decoder 512 wide, "
              "16 heads of 32 / norm-pix loss")
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(VIT_TRAIN)
        with _MaskCheck(MAE_MASKED) as masks, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            batch = _main_path(spec.tag, e)
        # the encoder's 50 tokens fall back to einsum with the JAX package's
        # warning; the decoder's 197 take the flash kernels
        per_step = (MAE_DECODER_BLOCKS,) * 3
        _flash_step_launches(spec.tag, TRAIN_STEPS, per_step)
        short = [w for w in caught if "sequence too short (50)" in str(w.message)]
        check(masks.calls == TRAIN_STEPS and len(short) == MAE_ENCODER_BLOCKS * TRAIN_STEPS,
              f"MAE-ViT-B/16: {masks.calls} maskings, {len(short)} einsum fallbacks at 50 tokens")
        log(f"[train] MAE-ViT-B/16: every mask held {MAE_MASKED} of {MAE_PATCHES} patches and "
            f"every ids_restore was a permutation ({masks.calls} steps); the encoder's 50 tokens "
            f"took einsum ({len(short)} fallbacks), the decoder's 197 the flash kernels")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no MAE-ViT-B/16 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 10.0)),
                   launches_per_step=per_step)
        del e, m, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


CLIP_CONFIG = os.path.join(REPO, "configs", "clip", "clip_vit_b32_in1k.yaml")
CLIP_BLOCKS = 12  # of each tower
CLIP_SPEC = SSLSpec(
    "CLIP-ViT-B/32", CLIP_CONFIG,
    256,  # pairs: the config's 4,096 over 16 cards
    4, (f"Model.vision_layers={FIRST_STEP_BLOCKS}",
        f"Model.transformer_layers={FIRST_STEP_BLOCKS}"),
    "visual.", f32_error_ratio=2.0, error_by_distance=True, watched=2 * FIRST_STEP_BLOCKS,
    watch=lambda n: n.endswith("attn_qkv.weight"))
# the ModifiedResNet tower: the variant's own vision settings (embed 1024, (3, 4, 6, 3),
# width 64) with the in1k config's text tower; its first step alone
CLIP_R50_MODEL = {"name": "CLIP_r50", "context_length": 77, "vocab_size": 49408,
                  "transformer_width": 512, "transformer_heads": 8, "transformer_layers": 12}
CLIP_R50_SPEC = SSLSpec(
    "CLIP-R50", CLIP_CONFIG, 0, 4, (f"Model={CLIP_R50_MODEL}",), "visual.", f32_error_ratio=2.0,
    error_by_distance=True,
    watched=11,  # the stem's first convolution and layer4's ten
    watch=lambda n: n.endswith(".weight") and "conv" in n and (
        n == "visual.conv1.weight" or n.startswith("visual.layer4_")))


def _causal_check(model: torch.nn.Module) -> dict:
    """The trained model's text tower, set to compute in f32, where it lies:
    every token after each sequence's EOT changed leaves `encode_text` as it
    was (1e-6 of its largest entry); the token after the start token changed
    moves every sequence's feature."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32  # the parameters are f32 already
    model.eval()
    device = next(model.parameters()).device
    captions = SyntheticTextImageDataset(size=64, image_size=8, context_length=77)
    text = torch.from_numpy(np.stack([captions[i]["text"] for i in range(64)])).to(device)
    eot = text.argmax(dim=1)
    g = torch.Generator(device=device).manual_seed(1)
    cols = torch.arange(text.shape[1], device=device)
    noise = torch.randint(1, 49406, text.shape, generator=g, device=device, dtype=text.dtype)
    after = torch.where(cols[None] > eot[:, None], noise, text)
    before = text.clone()
    before[:, 1] = torch.where(text[:, 1] == 7, 8, 7).to(text.dtype)
    check(bool((eot >= 2).all()) and not torch.equal(after, text), "CLIP: no tokens after an EOT")
    with torch.no_grad():
        base, moved_after, moved_before = (model.encode_text(t) for t in (text, after, before))
    scale = base.abs().max().item()
    after_err = (moved_after - base).abs().max().item() / scale
    before_min = (moved_before - base).abs().amax(dim=1).min().item() / scale
    log(f"[train] CLIP-ViT-B/32 causal mask, f32, 64 captions: tokens after the EOT move the "
        f"feature by {after_err:.3g} of its largest entry, the token before it by at least "
        f"{before_min:.3g}")
    check(after_err <= 1e-6 and before_min > 1e-4,
          f"CLIP: the text tower is not causal ({after_err}, {before_min})")
    return {"causal_after_eot_rel": after_err, "causal_before_eot_min_rel": before_min}


def phase_train_clip() -> dict:
    spec = CLIP_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        out.update({f"r50_{k}": v for k, v in _grads_card_vs_cpu(CLIP_R50_SPEC, tmp).items()})
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and len(m.visual.resblocks) == CLIP_BLOCKS
              and len(m.transformer_resblocks) == CLIP_BLOCKS
              and tuple(m.visual.conv1.weight.shape) == (768, 3, 32, 32)
              and tuple(m.token_embedding.embedding.shape) == (49408, 512)
              and tuple(m.positional_embedding.shape) == (77, 512)
              and type(e.optimizer.torch_optimizer).__name__ == "AdamW",
              "CLIP-ViT-B/32: not the recipe's bf16 / 12 + 12 blocks / patch 32 / 49,408 x 512 "
              "token table / 77 positions / AdamW")
        no_wd = [n for n in ("logit_scale", "positional_embedding", "visual.class_embedding")
                 if e.optimizer.group_of(n).weight_decay == 0.0]
        check(len(no_wd) == 3 and e.optimizer.group_of("text_projection").weight_decay == 0.2,
              f"CLIP-ViT-B/32: the no-decay groups are {no_wd}")
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        check(batch["text"].dtype == torch.int32 and tuple(batch["text"].shape) == (spec.batch, 77),
              f"CLIP-ViT-B/32: the captions reach the card as {batch['text'].dtype}")
        hist = e.train_loop.history
        first = hist[0]
        check(abs(first["loss"] - np.log(spec.batch)) <= 1.0 and
              abs(first["logit_scale"] - 1 / 0.07) <= 1e-4,
              f"CLIP-ViT-B/32: the first step's loss {first['loss']} is not within 1 of "
              f"ln {spec.batch}, or its logit scale {first['logit_scale']} is not 1 / 0.07")
        log(f"[train] CLIP-ViT-B/32: first step loss {first['loss']:.5f} (ln {spec.batch} = "
            f"{np.log(spec.batch):.5f}), logit scale {first['logit_scale']:.6f} -> "
            f"{hist[-1]['logit_scale']:.6f}; the captions reach the card as int32")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no CLIP-ViT-B/32 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)))
        out.update(_causal_check(m))  # the last use of the trained model
        del e, m, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


class _CenterCheck:
    """Wraps DINO's and DINOv2's train step: after every step each center is
    m center_prev + (1 - m) mean of the teacher's raw outputs (DINO: over its
    rows; DINOv2: `cls_center` over the class tokens', `patch_center` over
    the patch tokens'), within f32 rounding; counts the towers' forwards."""

    def __init__(self, tag: str, engine: Engine, centers: dict):
        self.tag, self.engine, self.step_fn = tag, engine, engine.train_step
        self.centers = centers  # buffer name -> the rows of the teacher's output it averages
        self.means: dict = {}
        self.forwards = {"student": 0, "teacher": 0}
        self.worst = 0.0
        model = engine.model
        self.handles = [getattr(model, tower).register_forward_hook(self._hook(tower))
                        for tower in self.forwards]

    def _hook(self, tower: str):
        def hook(module, args, output):
            self.forwards[tower] += 1
            if tower == "teacher":  # keep the means only: DINOv2's outputs are GBs
                with torch.no_grad():
                    self.means = {name: rows(output).reshape(-1, output.shape[-1]).mean(
                        0, keepdim=True) for name, rows in self.centers.items()}
        return hook

    def remove(self) -> None:
        """Takes the hooks off (before the profiled step)."""
        for h in self.handles:
            h.remove()

    def __call__(self, state, batch):
        model = self.engine.model
        prev = {name: getattr(model, name).clone() for name in self.centers}
        metrics = self.step_fn(state, batch)
        mom = model.center_momentum
        for name, old in prev.items():
            want = mom * old + (1 - mom) * self.means[name]
            got = getattr(model, name)
            err = ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
            self.worst = max(self.worst, err)
        check(self.worst <= 1e-6, f"{self.tag}: a center left its rule at step {state.step}: "
                                  f"{self.worst}")
        return metrics

    def __getattr__(self, name):
        return getattr(self.step_fn, name)


DINO_SPEC = SSLSpec(
    "DINO-ViT-S/16", os.path.join(REPO, "configs", "dino", "dino_vit_s16_pretrain_in1k.yaml"),
    64,  # images of 2 x 224 + 8 x 96 crops: the config's 1,024 over 16 cards
    4, (f"Model.backbone.depth={FIRST_STEP_BLOCKS}",), "student.backbone.", "teacher.", views=10,
    f32_error_ratio=2.0, error_by_distance=True, watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.startswith("student.backbone.blocks.") and n.endswith("attn.qkv.weight"))


def _dino_resume_check(spec: SSLSpec, e: Engine, names) -> Callable:
    saved = {k: e.model.state_dict()[k].clone() for k in names}

    def restored(engine):
        state = engine.model.state_dict()
        check(all(torch.equal(state[k], v) for k, v in saved.items()),
              f"{spec.tag}: a resumed center differs from the checkpoint's")
        log(f"[train] {spec.tag} resume: {', '.join(names)} bitwise as saved")

    return restored


def _dino_checks(spec: SSLSpec, e: Engine, ema: "_EmaCheck", centers: _CenterCheck,
                 momentum: float) -> None:
    m0, m_last = ema.m_fn(0), ema.m_fn(TRAIN_STEPS - 1)
    cosine = 1 - (1 - momentum) * (np.cos(np.pi * (TRAIN_STEPS - 1) / e.total_steps) + 1) / 2
    check(abs(m0 - momentum) <= 1e-6 and abs(m_last - cosine) <= 1e-7
          and len(ema.dst) == len(list(e.model.teacher.parameters())),
          f"{spec.tag}: the EMA is not the cosine from {momentum} over every teacher "
          f"parameter: {m0}, {m_last}, {len(ema.dst)}")
    _no_optimizer_state_on(spec, e)
    log(f"[train] {spec.tag}: the EMA rule (cosine from {momentum}, m {m0:.6f} -> {m_last:.6f}) "
        f"held at every step on all {len(ema.dst)} teacher parameters (max rel err "
        f"{ema.worst:.3g}); the teacher has no optimizer state; the centers followed their rule "
        f"(max rel err {centers.worst:.3g}); forwards a step: student "
        f"{centers.forwards['student'] / TRAIN_STEPS:g}, teacher "
        f"{centers.forwards['teacher'] / TRAIN_STEPS:g}")


def phase_train_dino() -> dict:
    spec = DINO_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and len(m.student.backbone.blocks) == 12
              and m.student.backbone.embed_dim == 384 and m.student.backbone.patch_size == 16
              and tuple(m.student.head.prototypes.shape) == (256, 65536)
              and type(e.optimizer.torch_optimizer).__name__ == "AdamW"
              and e.grad_clip is not None and e.grad_clip.clip_norm == 3.0,
              "DINO-ViT-S/16: not the recipe's bf16 / 12 blocks of 384 in 16 px patches / "
              "65,536 prototypes of 256 / AdamW / global-norm clip 3")
        ema = _EmaCheck(spec.tag, e)
        centers = _CenterCheck(spec.tag, e, {"center": lambda t: t})
        centers.step_fn, e.train_step = ema, centers
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        check([tuple(c.shape[1:3]) for c in batch] == [(224, 224)] * 2 + [(96, 96)] * 8,
              f"DINO-ViT-S/16: crops {[tuple(c.shape) for c in batch]}")
        e.train_step = ema.step_fn
        centers.remove()
        check(centers.forwards == {"student": 2 * TRAIN_STEPS, "teacher": TRAIN_STEPS},
              f"DINO-ViT-S/16: forwards {centers.forwards} in {TRAIN_STEPS} steps, want 2 student "
              "(one per resolution) and 1 teacher a step")
        _dino_checks(spec, e, ema, centers, 0.996)
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no DINO-ViT-S/16 checkpoint")
        restored = _dino_resume_check(spec, e, ("center",))
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)),
                   ema_max_rel_err=ema.worst, center_max_rel_err=centers.worst)
        del e, m, batch, ema, centers
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt, restored)
    return out


DINOV2_SPEC = SSLSpec(
    "DINOv2-ViT-S/14", os.path.join(REPO, "configs", "dinov2",
                                    "dinov2_vit_s14_pretrain_in1k.yaml"),
    32,  # images of 2 x 224 + 8 x 98 crops: 1,024 over 32 cards
    # LayerScale 1.0 for the first step: at the config's 1e-5 every crop's class
    # features coincide to 6e-9 at init, under f32's rounding of KoLeo's 2 - 2 f.f'
    # (2.4e-7), which then goes negative and its sqrt NaN on both devices, as the
    # JAX formula does (the bf16 main path spreads them to 8e-6)
    4, ("Model.backbone.init_values=1.0", f"Model.backbone.depth={FIRST_STEP_BLOCKS}"),
    "student.backbone.", "teacher.", views=10, f32_error_ratio=2.0, error_by_distance=True,
    watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.startswith("student.backbone.blocks.") and n.endswith("attn.qkv.weight"),
    draws=lambda: _one_mask_noise(8, DINOV2_PATCHES))  # the 2 x 4 global crops
DINOV2_PATCHES = 256  # 16 x 16 patches of 14 px at 224


@contextlib.contextmanager
def _one_mask_noise(n: int, length: int):
    """DINOv2's masks draw one fixed noise [n, length] on every device."""
    noise = torch.from_numpy(np.random.RandomState(17).rand(n, length).astype(np.float32))
    orig = dino.masking_noise
    dino.masking_noise = lambda n_, l_, generator, device: noise.to(device)
    try:
        yield
    finally:
        dino.masking_noise = orig


def phase_train_dinov2() -> dict:
    spec = DINOV2_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        warned = []
        with _warnings_of(engine_mod.logger, warned):
            e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                       device="cuda")
        m = e.model
        blocks = m.student.backbone.blocks
        check(e.policy.compute_dtype == torch.bfloat16 and len(blocks) == 12
              and blocks[0].init_values == 1e-5 and m.student.backbone.patch_size == 14
              and tuple(m.teacher.backbone.mask_token.shape) == (1, 1, 384)
              and tuple(m.student.head.prototypes.shape) == (256, 65536)
              and type(e.optimizer.torch_optimizer).__name__ == "AdamW"
              and e.grad_clip is not None and e.grad_clip.clip_norm == 3.0,
              "DINOv2-ViT-S/14: not the recipe's bf16 / 12 LayerScale (1e-5) blocks of 384 in "
              "14 px patches / a teacher mask token / 65,536 prototypes / AdamW / clip 3")
        scales = {e.optimizer.group_of(n).lr_scale for n, _ in m.named_parameters()}
        check(e.config["Optimizer"]["layerwise_decay"] == 0.9 and scales == {1.0}
              and any("layerwise_decay" in w for w in warned),
              f"DINOv2-ViT-S/14: layerwise_decay 0.9 should warn and decay nothing, as the JAX "
              f"engine does (lr scales {scales}, warnings {warned})")
        ema = _EmaCheck(spec.tag, e)
        centers = _CenterCheck(spec.tag, e, {"cls_center": lambda t: t[:, 0],
                                             "patch_center": lambda t: t[:, 1:]})
        centers.step_fn, e.train_step = ema, centers
        masks = []
        spy = m.student.backbone.register_forward_hook(
            lambda mod, args, output: masks.append(args[1].float().mean(1).cpu())
            if len(args) > 1 and args[1] is not None else None)
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        check([tuple(c.shape[1:3]) for c in batch] == [(224, 224)] * 2 + [(98, 98)] * 8,
              f"DINOv2-ViT-S/14: crops {[tuple(c.shape) for c in batch]}")
        e.train_step = ema.step_fn
        centers.remove()
        spy.remove()
        # the globals through the student once a step, masked; each local crop alone
        check(centers.forwards == {"student": 9 * TRAIN_STEPS, "teacher": TRAIN_STEPS}
              and len(masks) == TRAIN_STEPS,
              f"DINOv2-ViT-S/14: forwards {centers.forwards}, {len(masks)} masked")
        # each patch masked where its uniform is below 0.3: an image's share is a
        # binomial mean, sd sqrt(0.3 0.7 / 256) = 0.0286, so over 512 images a band
        # of 0.1 (3.5 sd) is left about one run in five (one image read 0.402 on
        # an H100 80GB HBM3 at 700 W); held instead: every share within 6 sd,
        # their mean within 0.01 of 0.3 (8 sd of a mean of 512) and their spread
        # within a quarter of the sd (8 sd of a spread of 512)
        share = torch.cat(masks)
        sd = (0.3 * 0.7 / DINOV2_PATCHES) ** 0.5
        check(share.numel() == 2 * spec.batch * TRAIN_STEPS
              and (share - 0.3).abs().max() <= 6 * sd and abs(share.mean().item() - 0.3) <= 0.01
              and abs(share.std().item() / sd - 1) <= 0.25,
              f"DINOv2-ViT-S/14: masked shares {share.min().item()} .. {share.max().item()}, "
              f"mean {share.mean().item()}, spread {share.std().item()} (binomial {sd})")
        mt = m.teacher.backbone.mask_token
        check(any(d is mt for d in ema.dst) and not bool(mt.grad.any()),
              "DINOv2-ViT-S/14: the teacher's mask token takes a gradient or is not in the EMA")
        mix = _loss_mix(spec.tag, e.train_loop.history,
                        {"dino_loss": 1.0, "ibot_loss": 1.0, "koleo_loss": 0.1})
        _dino_checks(spec, e, ema, centers, 0.994)
        log(f"[train] {spec.tag}: masked shares of each image's {DINOV2_PATCHES} patches "
            f"{share.min().item():.4f} .. {share.max().item():.4f} (mean {share.mean().item():.4f}, "
            f"spread {share.std().item():.4f}, binomial {sd:.4f}) over {share.numel()} global crops; the teacher's mask token moved by the EMA alone "
            f"(no gradient); loss = dino + ibot + 0.1 koleo to {mix:.3g}; layerwise_decay 0.9 "
            "warned and decayed nothing, as in JAX")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no DINOv2-ViT-S/14 checkpoint")
        restored = _dino_resume_check(spec, e, ("cls_center", "patch_center"))
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 40.0)),
                   ema_max_rel_err=ema.worst, center_max_rel_err=centers.worst,
                   mask_share_min=share.min().item(), mask_share_max=share.max().item())
        del e, m, batch, ema, centers, mt
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt, restored)
    return out


# ------------------------------------------------------ masked image modeling

MIM_BLOCKS, MIM_PATCHES = 12, 196  # ViT-B/16 at 224: 14 x 14 patches
VOCAB, TOKEN_GRID = 8192, 28  # the dVAE's vocabulary and its /8 grid at 224
_TARGETS: dict = {}  # spec tag -> the first steps' target-id agreement


class _TargetIds:
    """Records the frozen tokenizer's target ids in each first step (in order:
    the card's f32, the CPU's f32, the card's f64, the CPU's f64), with each
    position's margin between its two largest logits; on exit it counts the
    f32 runs' disagreements, card against CPU, and their margins (a flip at a
    near tie is reported, not hidden)."""

    def __init__(self, tag: str):
        self.tag, self.runs, self.orig = tag, [], discrete_vae.DiscreteVAE.tokenize

    def __enter__(self):
        def tokenize(mod, imgs):
            logits = mod.encode_logits(imgs)
            top = logits.topk(2, dim=-1).values
            ids = logits.argmax(dim=-1).reshape(imgs.shape[0], -1)
            self.runs.append((ids.cpu(), (top[..., 0] - top[..., 1]).reshape(ids.shape).cpu()))
            return ids

        discrete_vae.DiscreteVAE.tokenize = tokenize
        return self

    def __exit__(self, exc_type, *exc):
        discrete_vae.DiscreteVAE.tokenize = self.orig
        if exc_type is not None:
            return
        check(len(self.runs) == 4, f"{self.tag}: {len(self.runs)} tokenizer calls in 4 first steps")
        (ids_card, gap_card), (ids_cpu, gap_cpu) = self.runs[0], self.runs[1]
        flips = ids_card != ids_cpu
        f64_flips = int((self.runs[2][0] != self.runs[3][0]).sum())
        rec = {"target_ids": ids_card.numel(), "target_flips_f32": int(flips.sum()),
               "target_flips_f64": f64_flips,
               "target_min_margin": float(gap_cpu.double().min()),
               "target_flip_max_margin": float(gap_cpu[flips].max()) if flips.any() else 0.0,
               "target_ids_used": int(ids_cpu.unique().numel())}
        _TARGETS[self.tag] = rec
        log(f"[train] {self.tag} first step's target ids, f32 card vs CPU: "
            f"{rec['target_flips_f32']} of {rec['target_ids']} differ (largest top-2 logit margin among them "
            f"{rec['target_flip_max_margin']:.3g}; the smallest margin of all "
            f"{rec['target_min_margin']:.3g}); f64: {f64_flips} differ; "
            f"{rec['target_ids_used']} distinct ids")


@contextlib.contextmanager
def _one_gumbel(shape):
    """The dVAE's gumbel noise takes one fixed draw of `shape` on every device."""
    u = torch.from_numpy(np.random.RandomState(18).rand(*shape).astype(np.float32))
    orig = discrete_vae.gumbel_uniforms
    discrete_vae.gumbel_uniforms = lambda shape_, generator, device: u.to(device)
    try:
        yield
    finally:
        discrete_vae.gumbel_uniforms = orig


DVAE_SPEC = SSLSpec(
    "dVAE-8192", os.path.join(REPO, "configs", "beit", "dvae_tokenizer_in1k.yaml"),
    4, 4, (), "", views=1, f32_error_ratio=2.0, error_by_distance=True, watched=6,
    watch=lambda n: n.startswith(("enc_down", "dec_up")) and n.endswith(".weight"),
    draws=lambda: _one_gumbel((4, TOKEN_GRID, TOKEN_GRID, VOCAB)))
_QKV = "attn.qkv.weight"
BEIT_MASKED = 75  # the config's num_masking_patches
BEIT_SPEC = SSLSpec(
    "BEiT-B/16", os.path.join(REPO, "configs", "beit", "beit_base_patch16_224_in1k.yaml"),
    64,  # images: the recipe's 2,048 over 32 cards
    # no stochastic depth in the first step: the card's and the CPU's generators
    # draw other masks
    4, ("Model.encoder.drop_path_rate=0.0", f"Model.encoder.depth={FIRST_STEP_BLOCKS}"), "",
    "tokenizer.", overrides=("Global.pretrained_model=",), views=1, f32_error_ratio=2.0,
    error_by_distance=True, watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.startswith("encoder.blocks.") and n.endswith(_QKV),
    draws=lambda: _TargetIds("BEiT-B/16"))
CAE_MASKED = 98  # the config's num_masked and num_masking_patches
CAE_SPEC = SSLSpec(
    "CAE-B/16", os.path.join(REPO, "configs", "cae", "cae_base_patch16_224_in1k.yaml"),
    64,  # images: the JAX package's bench row (bench.py:389-410)
    # the card's f32 distance from f64 read 1.943 times the CPU's, both under
    # 3.4e-7 of the gradient's norm (H100 80GB HBM3 at 700 W): 3 leaves room for
    # two such roundings and still tells f32 from TF32 (thousands of times; at
    # 12 blocks)
    4, (f"Model.depth={FIRST_STEP_BLOCKS}",), "", "tokenizer.",
    overrides=("Global.pretrained_model=",), views=1, f32_error_ratio=3.0,
    error_by_distance=True, watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.startswith("blocks.") and n.endswith(_QKV),
    draws=lambda: _TargetIds("CAE-B/16"))
CONVMAE_KEPT = 49  # of 196: 147 masked at the config's ratio 0.75
CONVMAE_SPEC = SSLSpec(
    "ConvMAE-B", os.path.join(REPO, "configs", "convmae", "convmae_base_in1k.yaml"),
    128,  # images: the recipe's 4,096 over 32 cards
    4, (f"Model.depths=[2, 2, {FIRST_STEP_BLOCKS}]", f"Model.decoder_depth={FIRST_STEP_BLOCKS}"),
    "", views=1, f32_error_ratio=2.0, error_by_distance=True, watched=2 * FIRST_STEP_BLOCKS,
    watch=lambda n: n.endswith(_QKV), draws=lambda: _one_noise(4, MIM_PATCHES))


def _tokenizer_frozen(spec: SSLSpec, e: Engine, before: dict) -> None:
    """The tokenizer bitwise as it started and without optimizer state."""
    after = {k: v for k, v in e.model.state_dict().items() if k.startswith(spec.no_grad)}
    check(set(after) == set(before) and all(torch.equal(after[k], v) for k, v in before.items()),
          f"{spec.tag}: the frozen tokenizer moved")
    _no_optimizer_state_on(spec, e)
    log(f"[train] {spec.tag}: the tokenizer's {len(before)} tensors bitwise unchanged after "
        f"{TRAIN_STEPS} steps, no optimizer state on them")


def _tokenizer_of_the_recipe(spec: SSLSpec, tok) -> None:
    check(tok.to_logits.weight.shape[:2] == (VOCAB, 256) and not hasattr(tok, "codebook"),
          f"{spec.tag}: the tokenizer is not the recipe's dVAE encoder (vocabulary 8,192 over "
          "256 features, no decoder)")


class _MaskSpy:
    """Counts each image's masked patches at the model's entry on the main path."""

    def __init__(self, model: torch.nn.Module):
        self.counts = []
        self.hook = model.register_forward_pre_hook(
            lambda mod, args: self.counts.append(args[0][2].sum(1).cpu()))

    def remove(self) -> torch.Tensor:
        self.hook.remove()
        return torch.cat(self.counts)


def _masked_loss_only(spec: SSLSpec, e: Engine, batch) -> float:
    """BEiT's loss on `batch` (eval: no stochastic depth) against the
    cross-entropy over its masked patches alone, recomputed from the parts."""
    m = e.model.eval()
    view, tok_view, mask = batch
    with torch.no_grad():
        out = m(batch)
        logits = m.head(m.encoder(view, bool_mask=mask)[:, 1:]).float()
        target = beit._pool_targets(m.tokenizer.tokenize(tok_view), logits.shape[1])
    m.train()
    nll = -torch.log_softmax(logits, -1).gather(-1, target[:, :, None])[:, :, 0]
    want = nll[mask.bool()].mean()
    rel = abs(out["loss"].item() - want.item()) / want.item()
    check(rel <= 1e-5, f"{spec.tag}: the loss {out['loss'].item()} is not the masked patches' "
          f"cross-entropy {want.item()}")
    return rel


def phase_train_beit() -> dict:
    spec = BEIT_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp), **_TARGETS.get(spec.tag, {}))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        blocks = m.encoder.blocks
        check(e.policy.compute_dtype == torch.bfloat16 and len(blocks) == MIM_BLOCKS
              and m.encoder.embed_dim == 768 and blocks[0].attn.num_heads == 12
              and blocks[0].init_values == 0.1 and blocks[-1].drop_path1.rate == 0.1
              and m.head.out_features == VOCAB and m.encoder.mask_token is not None
              and tuple(blocks[0].attn.relative_position_bias_table.shape) == (27 * 27 + 3, 12)
              and e.grad_clip is not None and e.grad_clip.clip_norm == 3.0,
              "BEiT-B/16: not the recipe's bf16 / 12 blocks of 768, 12 heads, LayerScale 0.1, "
              "drop path 0.1, relative position bias / 8,192 tokens / clip 3")
        _tokenizer_of_the_recipe(spec, m.tokenizer)
        tok0 = {k: v.clone() for k, v in m.state_dict().items() if k.startswith(spec.no_grad)}
        spy = _MaskSpy(m)
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        counts = spy.remove()
        check(counts.numel() == spec.batch * TRAIN_STEPS and 1 <= counts.min()
              and counts.max() <= BEIT_MASKED,
              f"BEiT-B/16: masked patches {counts.min()} .. {counts.max()}, want 1 .. 75")
        _tokenizer_frozen(spec, e, tok0)
        rel = _masked_loss_only(spec, e, batch)
        log(f"[train] {spec.tag}: masked patches an image {int(counts.min())} .. "
            f"{int(counts.max())} of {MIM_PATCHES} (mean {counts.float().mean():.2f}) over "
            f"{counts.numel()} images; the loss is the masked patches' cross-entropy "
            f"(rel {rel:.3g})")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no BEiT-B/16 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)),
                   masked_min=int(counts.min()), masked_max=int(counts.max()))
        del e, m, batch, blocks
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


class _SplitSpy:
    """Holds CAE's split on the main path: ids_vis and ids_mask a permutation
    of the patches, the encoder's blocks over exactly `visible` tokens (and the
    teacher's over all); counts the masks short of `masked`."""

    def __init__(self, model: torch.nn.Module, masked: int):
        self.model, self.masked, self.short, self.images = model, masked, 0, 0
        self.widths: list = []
        orig = self.orig = model.split

        def split(bool_mask):
            ids_vis, ids_mask = orig(bool_mask)
            n, l = bool_mask.shape
            perm = torch.equal(torch.sort(torch.cat([ids_vis, ids_mask], 1), 1).values,
                               torch.arange(l, device=bool_mask.device).expand(n, -1))
            check(perm and ids_mask.shape[1] == masked,
                  "CAE-B/16: ids_vis and ids_mask are no permutation of the patches")
            self.short += int((bool_mask.sum(1) < masked).sum())
            self.images += n
            return ids_vis, ids_mask

        model.split = split
        self.hook = model.blocks[0].register_forward_pre_hook(
            lambda mod, args: self.widths.append(args[0].shape[1]))

    def remove(self) -> None:
        del self.model.split
        self.hook.remove()


def phase_train_cae() -> dict:
    spec = CAE_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp), **_TARGETS.get(spec.tag, {}))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and len(m.blocks) == MIM_BLOCKS
              and m.embed_dim == 768 and m.blocks[0].attn.num_heads == 12
              and len(m.regressor) == 4 and m.num_masked == CAE_MASKED
              and m.head.out_features == VOCAB and (m.align_weight, m.token_weight) == (2.0, 1.0),
              "CAE-B/16: not the recipe's bf16 / 12 blocks of 768, 12 heads / 4 regressor "
              "blocks / 98 masked / 8,192 tokens / weights 2 and 1")
        _tokenizer_of_the_recipe(spec, m.tokenizer)
        tok0 = {k: v.clone() for k, v in m.state_dict().items() if k.startswith(spec.no_grad)}
        spy = _SplitSpy(m, CAE_MASKED)
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        spy.remove()
        visible = MIM_PATCHES - CAE_MASKED
        check(spy.images == spec.batch * TRAIN_STEPS
              and spy.widths == [visible, MIM_PATCHES] * TRAIN_STEPS,
              f"CAE-B/16: the encoder's widths {spy.widths}, want {visible} then the teacher's "
              f"{MIM_PATCHES} each step")
        _tokenizer_frozen(spec, e, tok0)
        mix = _loss_mix(spec.tag, e.train_loop.history, {"token_loss": 1.0, "align_loss": 2.0})
        log(f"[train] {spec.tag}: ids_vis and ids_mask a permutation of the {MIM_PATCHES} "
            f"patches in every image; the encoder saw {visible} tokens, the teacher "
            f"{MIM_PATCHES}, each step; {spy.short} of {spy.images} masks short of "
            f"{CAE_MASKED} ({spy.short / spy.images:.1%}: the last visible patches fill "
            f"ids_mask, as in JAX); loss = token + 2 align to {mix:.3g}")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no CAE-B/16 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 40.0)),
                   short_mask_share=spy.short / spy.images)
        del e, m, batch, spy
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


class _VisibilityCheck:
    """On ConvMAE's main path: each step's mask keeps `kept` of the stage-3
    patches (from the noise it drew), and at every CBlock's depthwise input the
    masked positions of that stage's grid are zero."""

    def __init__(self, model: torch.nn.Module, kept: int):
        self.kept, self.noise, self.calls, self.orig = kept, [], 0, mae.masking_noise
        p1, p2, p3 = model.patch_sizes
        reps = [p2 * p3] * len(model.blocks1) + [p3] * len(model.blocks2)
        self.hooks = [blk.attn.register_forward_pre_hook(functools.partial(self._hook, rep))
                      for blk, rep in zip([*model.blocks1, *model.blocks2], reps)]

    def _hook(self, rep: int, mod, args) -> None:
        y = args[0]  # NCHW
        n, g = y.shape[0], y.shape[2] // rep
        masked = torch.ones(n, g * g, dtype=torch.bool, device=y.device)
        masked.scatter_(1, torch.argsort(self.noise[-1], dim=1, stable=True)[:, :self.kept],
                        False)
        grid = masked.reshape(n, 1, g, g).repeat_interleave(rep, 2).repeat_interleave(rep, 3)
        check(not bool((y * grid).any()) and bool(y[:, :, ~grid[0, 0]].any()),
              "ConvMAE-B: a masked position is not zero at a CBlock's depthwise input")
        self.calls += 1

    def __enter__(self):
        def noise(n, length, generator, device):
            self.noise.append(self.orig(n, length, generator, device))
            return self.noise[-1]

        mae.masking_noise = noise
        return self

    def __exit__(self, *exc):
        mae.masking_noise = self.orig
        for h in self.hooks:
            h.remove()


def phase_train_convmae() -> dict:
    spec = CONVMAE_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and m.embed_dims == (256, 384, 768)
              and (len(m.blocks1), len(m.blocks2), len(m.blocks3)) == (2, 2, 11)
              and m.patch_sizes == (4, 2, 2) and len(m.decoder_blocks) == 8
              and m.decoder_blocks[0].attn.num_heads == 16 and m.norm_pix_loss
              and int(MIM_PATCHES * (1 - m.mask_ratio)) == CONVMAE_KEPT,
              "ConvMAE-B: not the recipe's bf16 / stages 256, 384, 768 of 2, 2, 11 blocks in "
              "4, 2, 2 px / decoder 8 blocks of 16 heads / 147 of 196 masked / norm-pix loss")
        torch.cuda.reset_peak_memory_stats()
        with _VisibilityCheck(m, CONVMAE_KEPT) as vis:
            batch = _main_path(spec.tag, e)
        check(len(vis.noise) == TRAIN_STEPS and vis.calls == 4 * TRAIN_STEPS,
              f"ConvMAE-B: {len(vis.noise)} masks and {vis.calls} CBlock checks")
        log(f"[train] {spec.tag}: every mask kept {CONVMAE_KEPT} of {MIM_PATCHES} patches "
            f"({MIM_PATCHES - CONVMAE_KEPT} masked); at each of the 4 CBlocks' depthwise inputs "
            f"the masked positions of the 56 x 56 and 28 x 28 grids were zero ({vis.calls} "
            "checks)")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no ConvMAE-B checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 10.0)))
        del e, m, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


# ------------------------------------------------ XCiT, ConvNeXt, distillation

# the eight kernels' wrappers: none is on the paths below (XCA is two einsums,
# ConvNeXt convolutions, the distilled DeiT attends with einsum, as in JAX)
KERNELS = (talking_heads_softmax, talking_heads_softmax_bwd, fused_window_attention,
           fused_window_attention_bwd, flash_attention, flash_attention_dkv, flash_attention_dq,
           fused_augment)


def _kernel_launches() -> dict:
    return {w.__name__: w.launches for w in KERNELS}


def _reset_kernel_launches() -> None:
    for w in KERNELS:
        w.launches = 0


def _no_kernel_on_the_path(tag: str) -> None:
    launches = _kernel_launches()
    check(not any(launches.values()), f"{tag}: the main path launched a kernel: {launches}")
    log(f"[train] {tag}: kernel launches over {TRAIN_STEPS} steps {launches} (none is on "
        "this path, as in JAX)")


XCIT_NAME = "xcit_small_12_p16"
XCIT_SPEC = SSLSpec(
    "XCiT-S12/16", os.path.join(REPO, "configs", "xcit", "xcit_small_12_p16_224_in1k.yaml"),
    128,  # images: the recipe's 1,024 over 8 cards
    # 4 images without stochastic depth (the two devices' generators draw other
    # masks); the config's Mixup / Cutmix stay: the loader draws them on the host
    4, ("Model.drop_path_rate=0.0", f"Model.depth={FIRST_STEP_BLOCKS}"), "", views=1,
    f32_error_ratio=2.0, error_by_distance=True, watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.endswith("attn.qkv.weight"))
CONVNEXT_SPEC = SSLSpec(
    "ConvNeXt-B", os.path.join(REPO, "configs", "classification", "convnext_base_in1k.yaml"),
    128,  # images: the recipe's 4,096 over 32 cards
    # the first step at 6 of its 36 blocks, every width kept (f64 depthwise
    # convolutions on the CPU took 12 s a step at 36)
    4, ("Model.drop_path_rate=0.0", "Model.depths=[1, 1, 3, 1]"), "", views=1,
    f32_error_ratio=2.0, error_by_distance=True, watched=6,
    watch=lambda n: n.endswith("dwconv.weight"))
DISTILL_SPEC = SSLSpec(
    "DeiT-B-distilled<-RegNetY-4GF",
    os.path.join(REPO, "configs", "distill", "deit_base_distilled_in1k.yaml"),
    64,  # images: the recipe's 2,048 over 32 cards
    # the student's blocks cut, the teacher whole
    4, ("Model.student.drop_path_rate=0.0", f"Model.student.depth={FIRST_STEP_BLOCKS}"), "",
    no_grad="teacher.", views=1, f32_error_ratio=2.0, error_by_distance=True,
    watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.endswith("attn.qkv.weight"))


def _serve_xcit(ckpt: str, tmp: str) -> dict:
    """The trained XCiT-S12/16 through export and Predictor, in the config's
    bf16 and in f32, on the same requests: no kernel launched, the bf16 logits
    at cosine >= 0.999 of the f32 ones."""
    requests = _requests()
    logits = {}
    for prec, overrides in (("bf16", ()), ("f32", ("FP16.enable=False",))):
        d = os.path.join(tmp, f"serve_{prec}")
        _export(XCIT_SPEC.config, d, f"Global.checkpoint={ckpt}", *overrides)
        logits[prec], stages, launches, prof = _serve(d, XCIT_NAME, requests, flash_attention)
        check(launches == 0, f"XCiT-S12/16 {prec}: serving launched the flash kernel")
        _report(f"XCiT-S12/16 {prec}", stages, prof)
    cos = _cosines(logits["bf16"], logits["f32"])
    log(f"[serve] XCiT-S12/16 bf16 vs f32 on the trained weights: min cosine {cos.min():.7f} "
        f"over {len(cos)} images, max abs diff {np.abs(logits['bf16'] - logits['f32']).max():.4g}"
        f" (largest logit {np.abs(logits['f32']).max():.4g})")
    # bf16 products over 12 blocks against f32: 1e-3 of cosine; a wrong
    # normalization axis or temperature drops far below it
    check(cos.min() >= 0.999, f"XCiT-S12/16 bf16 logits disagree with f32: {cos.min()}")
    return {"serve_bf16_vs_f32_cos_min": float(cos.min())}


def phase_train_xcit() -> dict:
    spec = XCIT_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and len(m.blocks) == 12
              and m.embed_dim == 384 and m.blocks[0].attn.num_heads == 8 and m.steps == 4
              and len(m.cls_attn) == 2 and m.blocks[0].init_values == 1.0
              and m.blocks[0].attn.temperature.shape == (8, 1, 1)
              and e.criterion is not None and e.grad_clip is not None
              and type(e.optimizer.torch_optimizer).__name__ == "AdamW"
              and "TransformOpSampler" in json.dumps(e.config["DataLoader"]["Train"]),
              "XCiT-S12/16: not the recipe's bf16 / 12 blocks of 384, 8 heads / 4 stem convs / "
              "2 class-attention layers / CE, global-norm clip, AdamW, Mixup/Cutmix")
        stats0 = {k: v.clone() for k, v in m.state_dict().items() if ".running_" in k}
        check(len(stats0) == 24, f"XCiT-S12/16: {len(stats0)} LPI statistics, want 24")
        _reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        _no_kernel_on_the_path(spec.tag)
        _stats_moved(spec, e, stats0, ["blocks."])
        log(f"[train] {spec.tag}: the 12 LPI BatchNorms' statistics moved")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no XCiT-S12/16 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)))
        del e, m, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
        with _span(spec.tag, "serving, bf16 and f32"):
            out.update(_serve_xcit(ckpt, tmp))
    return out


def phase_train_convnext() -> dict:
    spec = CONVNEXT_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        check(e.policy.compute_dtype == torch.bfloat16 and m.depths == (3, 3, 27, 3)
              and m.dims == (128, 256, 512, 1024) and m.stage2_block0.dwconv.groups == 512
              and m.stage3_block2.drop_path.rate == 0.5 and e.full_ema_decay is not None
              and type(e.optimizer.torch_optimizer).__name__ == "AdamW",
              "ConvNeXt-B: not the recipe's bf16 / depths 3, 3, 27, 3 of 128-1024 / 7 x 7 "
              "depthwise / drop path 0.5 / EMA / AdamW")
        _reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        _no_kernel_on_the_path(spec.tag)
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no ConvNeXt-B checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)))
        del e, m, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


class _DistillCheck:
    """Wraps the engine's train step: the step's logged loss against
    0.5 CE(student, labels) + 0.5 CE(student, argmax teacher), recomputed in
    f32 from the logits the step's forward produced."""

    def __init__(self, engine: Engine):
        self.step_fn, self.model = engine.train_step, engine.model
        self.worst = 0.0
        self.agree: list = []

    def __call__(self, state, batch):
        seen: dict = {}

        def keep(name):
            def hook(_mod, _args, out):
                seen[name] = out.detach()  # returns None: the output stays as it is
            return hook

        hooks = [getattr(self.model, n).register_forward_hook(keep(n))
                 for n in ("student", "teacher")]
        metrics = self.step_fn(state, batch)
        for h in hooks:
            h.remove()
        s, t = seen["student"].float(), seen["teacher"].float()
        labels = batch[1].long()
        want = 0.5 * F.cross_entropy(s, labels) + 0.5 * F.cross_entropy(s, t.argmax(-1))
        err = abs(float(metrics["loss"]) - want.item()) / want.item()
        self.worst = max(self.worst, err)
        self.agree.append((s.argmax(-1) == t.argmax(-1)).float().mean().item())
        check(err <= 1e-6, f"DeiT-B distilled: logged loss {float(metrics['loss'])} against "
                           f"{want.item()} recomputed from the step's logits")
        return metrics

    def __getattr__(self, name):
        return getattr(self.step_fn, name)


def _distill_eval_is_the_student(tag: str, e: Engine) -> float:
    """One pass of the eval loop: every forward the eval step makes returns
    the student's logits on the images, bitwise."""
    outs: dict = {"wrapper": [], "student": []}
    hooks = [mod.register_forward_hook(lambda _m, _a, out, k=k: outs[k].append(out))
             for k, mod in (("wrapper", e.model), ("student", e.model.student))]
    top1 = e.eval_loop.run()
    for h in hooks:
        h.remove()
    n = len(outs["wrapper"])
    check(n == len(outs["student"]) == 2 and 0.0 <= top1 <= 1.0
          and all(torch.equal(a, b) for a, b in zip(outs["wrapper"], outs["student"])),
          f"{tag}: the eval loop's {n} forwards did not return the student's logits")
    log(f"[eval] {tag}: the eval loop's {n} forwards returned the student's logits bitwise "
        f"({len(e.eval_dataloader.dataset)} synthetic images, top1 {top1:.5f})")
    return top1


def phase_train_distill() -> dict:
    spec = DISTILL_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        blocks = m.student.blocks
        check(e.policy.compute_dtype == torch.bfloat16 and e.criterion is None
              and type(m).__name__ == "DistillationWrapper" and m.hard_distill and m.alpha == 0.5
              and type(m.teacher).__name__ == "RegNet" and m.teacher.widths == [128, 192, 512, 1088]
              and m.teacher.group_widths == [64] * 4
              and all(getattr(m.teacher, b).se is not None for b in m.teacher.block_names),
              "DeiT-B distilled: not the recipe's bf16 wrapper, hard distillation, alpha 0.5, "
              "RegNetY-4GF teacher")
        check(len(blocks) == 12 and blocks[0].attn.num_heads == 12
              and all(resolve_attn_impl(b.attn.attn_impl, 198) == "einsum" for b in blocks)
              and type(e.optimizer.torch_optimizer).__name__ == "AdamW",
              "DeiT-B distilled: the student is not 12 blocks of 12 heads on einsum at 198 tokens")
        teacher0 = {k: v.clone() for k, v in m.state_dict().items() if k.startswith("teacher.")}
        check(any(".running_" in k for k in teacher0), "DeiT-B distilled: no teacher statistics")
        dc = _DistillCheck(e)
        e.train_step = dc
        _reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        e.train_step = dc.step_fn
        _no_kernel_on_the_path(spec.tag)
        check(len(dc.agree) == TRAIN_STEPS, f"DeiT-B distilled: {len(dc.agree)} checked steps")
        after = m.state_dict()
        check(all(torch.equal(after[k], v) for k, v in teacher0.items()) and not m.teacher.training,
              "DeiT-B distilled: the teacher moved or left eval mode")
        _no_optimizer_state_on(spec, e)
        log(f"[train] {spec.tag}: after {TRAIN_STEPS} steps the teacher's {len(teacher0)} "
            "parameters and BatchNorm buffers are bitwise unchanged and hold no optimizer "
            f"state; logged loss = 0.5 ce + 0.5 CE(argmax teacher) to {dc.worst:.3g} at every "
            f"step; student-teacher top-1 agreement " + ", ".join(f"{a:.3f}" for a in dc.agree))
        out.update(eval_top1=_distill_eval_is_the_student(spec.tag, e))
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS,
              "no DeiT-B distilled checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)), loss_max_rel_err=dc.worst)
        del e, m, batch, dc
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


# ------------------------------------- CvT, T2T-ViT, LV-ViT token labeling, Mixer


CVT_SPEC = SSLSpec(
    "CvT-13", os.path.join(REPO, "configs", "cvt", "cvt_13_224_in1k.yaml"),
    128,  # images: the recipe's 1,024 over 8 cards
    # 4 images, stage 2 at 4 of its 10 blocks (every width kept); the config sets
    # no stochastic depth
    4, ("Model.depths=[1, 2, 4]",), "", views=1, f32_error_ratio=2.0, error_by_distance=True,
    watched=7, watch=lambda n: n.endswith("attn.proj_q.weight"))
T2T_SPEC = SSLSpec(
    "T2T-ViT-14", os.path.join(REPO, "configs", "t2t_vit", "t2t_vit_14_in1k.yaml"),
    128,  # images: the recipe's 1,024 over 8 cards
    # the T2T stages whole, the ViT at 4 of its 14 blocks, no stochastic depth
    4, ("Model.drop_path_rate=0.0", f"Model.depth={FIRST_STEP_BLOCKS}"), "", views=1,
    f32_error_ratio=2.0, error_by_distance=True, watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.endswith("attn.qkv.weight"))
# t2t_vit_t_14's first step only: the one run of TokenAttention over 3,136 tokens
T2T_T_SPEC = dataclasses.replace(
    T2T_SPEC, tag="T2T-ViT_t-14",
    config=os.path.join(REPO, "configs", "t2t_vit", "t2t_vit_t_14_in1k.yaml"))
LVVIT_TOPK = 5  # the public token-label release's K
LVVIT_SPEC = SSLSpec(
    "LV-ViT-S token labeling",
    os.path.join(REPO, "configs", "lvvit", "lvvit_s_token_label_in1k.yaml"),
    128,  # images: the recipe's 1,024 over 8 cards
    4, ("Model.drop_path_rate=0.0", f"Model.depth={FIRST_STEP_BLOCKS}"), "", views=1,
    f32_error_ratio=2.0, error_by_distance=True, watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.endswith("attn.qkv.weight"), draws=lambda: _one_mixtoken(),
    native_convs=True)


def _random_head(model: torch.nn.Module) -> None:
    """Mixer's head from the seed at std 0.02: at its zero init (flax's, as in
    JAX) a first step's gradient is 0 everywhere but in the head."""
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(0))


MIXER_SPEC = SSLSpec(
    "Mixer-B/16", os.path.join(REPO, "configs", "mlp_mixer", "mlp_mixer_b16_224_in1k.yaml"),
    128,  # images: the recipe's 1,024 over 8 cards
    4, (f"Model.depth={FIRST_STEP_BLOCKS}",), "", views=1, f32_error_ratio=2.0,
    error_by_distance=True, watched=FIRST_STEP_BLOCKS,
    watch=lambda n: n.endswith("token_mlp.fc1.weight"), first_step_init=_random_head)


@contextlib.contextmanager
def _one_mixtoken():
    """LV-ViT's MixToken takes one fixed box on every device: lam 0.3 (sides
    int(sqrt(0.7) 14) = 11) centred at (7, 5), the coin on."""
    orig = t2t_vit.mixtoken_draws

    def draws(gh, gw, generator, device):
        return (torch.tensor(0.3, device=device), torch.tensor(7, device=device),
                torch.tensor(5, device=device), torch.tensor(0.1, device=device))

    t2t_vit.mixtoken_draws = draws
    try:
        yield
    finally:
        t2t_vit.mixtoken_draws = orig


class _ShapeSpy:
    """Records the shape of the first input of named submodules while it is
    open: the token counts the main path's first step hands them."""

    def __init__(self, model: torch.nn.Module, inputs=()):
        self.shapes: dict = {}
        self.hooks = [model.get_submodule(n).register_forward_hook(self._keep(n)) for n in inputs]

    def _keep(self, name: str):
        def hook(_mod, args, _out):
            self.shapes.setdefault(name, tuple(args[0].shape))  # returns None: the output stays
        return hook

    def close(self) -> dict:
        for h in self.hooks:
            h.remove()
        return self.shapes


def _classifier_recipe(tag: str, e: Engine) -> None:
    """The DeiT recipe the four configs share: bf16, CE with smoothing 0.1,
    AdamW with the global-norm clip (but LV-ViT's, which has neither the Loss
    block nor the clip), the DeiT host transforms and Mixup / Cutmix."""
    dl = json.dumps(e.config["DataLoader"]["Train"])
    check(e.policy.compute_dtype == torch.bfloat16
          and type(e.optimizer.torch_optimizer).__name__ == "AdamW"
          and e.config["Loss"]["Train"] == [{"CELoss": {"label_smoothing": 0.1}}]
          and e.grad_clip is not None and "TimmAutoAugment" in dl and "TransformOpSampler" in dl,
          f"{tag}: not the recipe's bf16 / CE with smoothing 0.1 / AdamW with the global-norm "
          "clip / DeiT transforms with Mixup and Cutmix")


def phase_train_cvt() -> dict:
    spec = CVT_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        _classifier_recipe(spec.tag, e)
        check(m.depths == (1, 2, 10) and m.embed_dims == (64, 192, 384)
              and m.num_heads == (1, 3, 6) and m.stage0_block0.attn.k_dw.groups == 64,
              "CvT-13: not depths 1, 2, 10 of 64, 192, 384 in 1, 3, 6 heads, depthwise q/k/v")
        spy = _ShapeSpy(m, inputs=[f"stage{s}_block0.attn.proj_{p}" for s in range(3)
                                   for p in ("q", "k")])
        _reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        shapes = spy.close()
        _no_kernel_on_the_path(spec.tag)
        tokens = [(shapes[f"stage{s}_block0.attn.proj_q"][1],
                   shapes[f"stage{s}_block0.attn.proj_k"][1]) for s in range(3)]
        check(tokens == [(3136, 784), (784, 196), (197, 50)],
              f"CvT-13: (queries, keys) of each stage {tokens}")
        log(f"[train] {spec.tag}: (queries, keys) of each stage's attention, stage 2's with the "
            f"cls token: {tokens}")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no CvT-13 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)))
        del e, m, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


def phase_train_t2t() -> dict:
    spec = T2T_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        out.update({f"t_{k}": v for k, v in _grads_card_vs_cpu(T2T_T_SPEC, tmp).items()})
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        _classifier_recipe(spec.tag, e)
        check(m.tokens_type == "performer" and len(m.blocks) == 14 and m.embed_dim == 384
              and m.blocks[0].attn.num_heads == 6 and m.blocks[-1].drop_path1.rate == 0.1
              and m.t2t_attn1.w.shape == (32, 64) and m.t2t_attn2.w.shape == (32, 64),
              "T2T-ViT-14: not performer stages with w (32, 64) / 14 blocks of 384 in 6 heads / "
              "drop path 0.1")
        w0 = {n: getattr(m, n).w.detach().clone() for n in ("t2t_attn1", "t2t_attn2")}
        spy = _ShapeSpy(m, inputs=["t2t_attn1", "t2t_attn2", "blocks.0"])
        _reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        shapes = spy.close()
        _no_kernel_on_the_path(spec.tag)
        tokens = [shapes[n][1] for n in ("t2t_attn1", "t2t_attn2", "blocks.0")]
        check(tokens == [3136, 784, 197], f"T2T-ViT-14: tokens of the stages and the ViT {tokens}")
        grads = {n: getattr(m, n).w.grad for n in w0}
        check(all(g is not None and bool(torch.isfinite(g).all()) and bool(g.any())
                  for g in grads.values())
              and all(not torch.equal(getattr(m, n).w, w) for n, w in w0.items()),
              "T2T-ViT-14: a performer's w took no finite, nonzero gradient or did not move")
        log(f"[train] {spec.tag}: tokens {tokens} (the performer stages, the ViT with cls); the "
            "performers' w: last gradient max |g| " + ", ".join(
                f"{n} {g.abs().max().item():.3g}" for n, g in grads.items())
            + "; moved over 8 steps by " + ", ".join(
                f"{n} {(getattr(m, n).w - w).abs().max().item():.3g}" for n, w in w0.items()))
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no T2T-ViT-14 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)))
        del e, m, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


class _BoxSpy:
    """Keeps every MixToken box the model builds while it is open (on the card,
    no sync)."""

    def __init__(self):
        self.boxes: list = []
        self.orig = t2t_vit.mixtoken_box

        def box(*args, **kwargs):
            b = self.orig(*args, **kwargs)
            self.boxes.append(b.detach())
            return b

        t2t_vit.mixtoken_box = box

    def close(self) -> list:
        t2t_vit.mixtoken_box = self.orig
        return [int(b.sum()) for b in self.boxes]


LVVIT_SERVE = ("Model={'name': 'lvvit_s', 'num_classes': 1000}",
               "Loss={'Train': [{'CELoss': {'label_smoothing': 0.1}}]}")


def _serve_lvvit(ckpt: str, tmp: str) -> dict:
    """The trained weights served as `lvvit_s` (the token-label config with
    `Model` and a `Loss` block swapped: the export refuses a label-free
    config, as JAX's does) through export and Predictor, in bf16 and in f32:
    no kernel launched, the bf16 logits at cosine >= 0.999 of the f32 ones.
    Then the checkpoint's state dict loads strictly into `lvvit_s` in f32,
    whose eval logits equal the token-label model's bitwise."""
    requests = _requests()
    logits = {}
    for prec, overrides in (("bf16", ()), ("f32", ("FP16.enable=False",))):
        d = os.path.join(tmp, f"serve_{prec}")
        _export(LVVIT_SPEC.config, d, f"Global.checkpoint={ckpt}", *LVVIT_SERVE, *overrides)
        logits[prec], stages, launches, prof = _serve(d, "lvvit_s", requests, flash_attention)
        check(launches == 0, f"LV-ViT-S {prec}: serving launched the flash kernel")
        _report(f"LV-ViT-S {prec}", stages, prof)
    cos = _cosines(logits["bf16"], logits["f32"])
    log(f"[serve] LV-ViT-S bf16 vs f32 on the trained weights: min cosine {cos.min():.7f} "
        f"over {len(cos)} images, max abs diff {np.abs(logits['bf16'] - logits['f32']).max():.4g}"
        f" (largest logit {np.abs(logits['f32']).max():.4g})")
    check(cos.min() >= 0.999, f"LV-ViT-S bf16 logits disagree with f32: {cos.min()}")
    state = torch.load(ckpt, map_location="cuda", weights_only=True)["model"]
    plain, trainer = (build_model({"name": name, "num_classes": NUM_CLASSES}).cuda().eval()
                      for name in ("lvvit_s", "LVViTTokenLabel"))
    plain.load_state_dict(state, strict=True)
    trainer.load_state_dict(state, strict=True)
    x = torch.from_numpy(np.random.RandomState(1).randn(32, IMG, IMG, 3).astype(np.float32)).cuda()
    with torch.no_grad():
        a, b = plain(x), trainer(x)
    diff = (a - b).abs().max().item()
    check(torch.equal(a, b), f"LV-ViT-S: lvvit_s's f32 eval logits differ from the token-label "
                             f"model's by {diff}")
    log(f"[serve] LV-ViT-S: the token-label checkpoint loads strictly into lvvit_s; its f32 eval "
        f"logits equal the token-label model's bitwise on 32 images (max |diff| {diff})")
    del plain, trainer, state
    torch.cuda.empty_cache()
    return {"serve_bf16_vs_f32_cos_min": float(cos.min()), "lvvit_s_logits_max_abs_diff": diff}


def phase_train_lvvit() -> dict:
    spec = LVVIT_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        ds = e.train_dataloader.dataset
        check(e.policy.compute_dtype == torch.bfloat16 and e.criterion is None
              and type(m).__name__ == "LVViTTokenLabel" and len(m.blocks) == 16
              and m.embed_dim == 384 and m.blocks[0].attn.num_heads == 6 and m.grid == 14
              and m.blocks[-1].drop_path1.rate == 0.1 and m.mix_prob == 0.5
              and m.dense_weight == 0.5 and type(e.optimizer.torch_optimizer).__name__ == "AdamW"
              and type(ds).__name__ == "SyntheticTokenLabelDataset" and ds.grid == 14
              and ds.topk == LVVIT_TOPK,
              "LV-ViT-S: not the recipe's bf16 token-label trainer / 16 blocks of 384 in 6 heads "
              "on a 14 x 14 grid / MixToken 0.5 / dense weight 0.5 / AdamW / top-5 labels")
        stats0 = {k: v.clone() for k, v in m.state_dict().items() if ".running_" in k}
        check(len(stats0) == 6, f"LV-ViT-S: {len(stats0)} stem statistics, want 6")
        spy = _BoxSpy()
        _reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        try:
            batch = _main_path(spec.tag, e)
        finally:
            cells = spy.close()
        _no_kernel_on_the_path(spec.tag)
        check(set(batch) == {"image", "label", "token_value", "token_idx"}
              and tuple(batch["token_idx"].shape) == (spec.batch, 14, 14, LVVIT_TOPK),
              f"LV-ViT-S: the batch reached the card as {sorted(batch)}")
        check(len(cells) == TRAIN_STEPS and any(cells) and not all(cells),
              f"LV-ViT-S: MixToken's boxes over the {TRAIN_STEPS} steps cover {cells} cells")
        hist = e.train_loop.history
        parts = max(abs(h["loss"] - (h["loss_cls"] + 0.5 * h["loss_aux"])) / abs(h["loss"])
                    for h in hist)
        check(parts <= 1e-6, f"LV-ViT-S: the logged loss is not loss_cls + 0.5 loss_aux ({parts})")
        _stats_moved(spec, e, stats0, ["stem_bn"])
        log(f"[train] {spec.tag}: MixToken boxed steps {[i + 1 for i, c in enumerate(cells) if c]} "
            f"of {TRAIN_STEPS} (cells of 196: {cells}); loss = loss_cls + 0.5 loss_aux to "
            f"{parts:.3g}; loss_cls " + ", ".join(f"{h['loss_cls']:.4f}" for h in hist)
            + "; loss_aux " + ", ".join(f"{h['loss_aux']:.4f}" for h in hist)
            + "; the 3 stem BatchNorms' statistics moved")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no LV-ViT-S checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)), loss_parts_rel_err=parts,
                   boxed_cells=cells)
        del e, m, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
        with _span(spec.tag, "serving as lvvit_s, bf16 and f32"):
            out.update(_serve_lvvit(ckpt, tmp))
    return out


def phase_train_mixer() -> dict:
    spec = MIXER_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        m = e.model
        _classifier_recipe(spec.tag, e)
        blk = m.blocks[0]
        check(len(m.blocks) == 12 and m.embed_dim == 768 and m.num_patches == 196
              and tuple(blk.token_mlp.fc1.weight.shape) == (384, 196)
              and tuple(blk.channel_mlp.fc1.weight.shape) == (3072, 768)
              and not m.head.weight.any(),
              "Mixer-B/16: not 12 blocks of 768 / token MLP 196 -> 384 / channel MLP 768 -> 3072 "
              "/ the head at zero")
        _reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        batch = _main_path(spec.tag, e)
        _no_kernel_on_the_path(spec.tag)
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no Mixer-B/16 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 20.0)))
        del e, m, batch, blk
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


@contextlib.contextmanager
def _warnings_of(logger_module, sink: list):
    """Collects the messages `logger_module.warning` is given (and logs them)."""
    orig = logger_module.warning

    def warning(msg):
        sink.append(msg)
        orig(msg)

    logger_module.warning = warning
    try:
        yield
    finally:
        logger_module.warning = orig


def phase_first_steps() -> None:
    """Every SSL and classification phase's first steps (14-39), card vs
    CPU (correctness only, their time is not a measurement): run while the
    kernels build, whose nvcc processes leave most cores idle after the first
    seconds."""
    specs = (MOCOV3_SPEC, MAE_SPEC, BYOL_SPEC, SIMCLR_SPEC, MOCO_SPEC, SIMSIAM_SPEC, MOCOBYOL_SPEC,
             SWAV_SPEC, DENSECL_SPEC, PIXPRO_SPEC, FASTMOCO_SPEC, CLIP_SPEC, CLIP_R50_SPEC,
             DINO_SPEC, DINOV2_SPEC, DVAE_SPEC, BEIT_SPEC, CAE_SPEC, CONVMAE_SPEC, XCIT_SPEC,
             CONVNEXT_SPEC, DISTILL_SPEC, CVT_SPEC, T2T_SPEC, T2T_T_SPEC, LVVIT_SPEC, MIXER_SPEC)
    with tempfile.TemporaryDirectory() as tmp:
        for spec in specs:
            _FIRST_STEPS[spec.tag] = _grads_card_vs_cpu(spec, tmp)


def _in_thread(name: str, fn) -> Callable[[], None]:
    """Starts `_timed(name, fn)` in a thread; the returned call joins it and
    raises what it raised."""
    error: list = []

    def run():
        try:
            _timed(name, fn)
        except BaseException as exc:  # noqa: BLE001  (raised again on join)
            error.append(exc)

    thread = threading.Thread(target=run, name=name)
    thread.start()

    def join() -> None:
        thread.join()
        if error:
            raise error[0]

    return join


def _timed(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


_LIB = "jax/experimental/pallas/ops/tpu/flash_attention.py"  # the JAX library (jax 0.9.0)


def _kernel_row(name: str, source: str, replaces: str, launches: int, err: float,
                rec: dict) -> dict:
    return {"name": name, "route": "cuda", "source": f"passl_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            **{k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


def main() -> None:
    t0 = time.perf_counter()
    card = phase_device()
    join_build = _in_thread("build", phase_build)
    _timed("first steps, card vs CPU, while the kernels build", phase_first_steps)
    join_build()
    fwd = _timed("kernel", phase_kernel)
    bwd = _timed("kernel-bwd", phase_kernel_bwd)
    wfwd = _timed("wattn", phase_wattn)
    wbwd = _timed("wattn-bwd", phase_wattn_bwd)
    ffwd = _timed("flash", phase_flash)
    fbwd = _timed("flash-bwd", phase_flash_bwd)
    serve_launches = _timed("serve CaiT-S24", phase_serve)
    log(f"[serve] forward kernel launches on the serving path: {serve_launches}")
    swin_serve_launches = _timed("serve Swin-T", phase_serve_swin)
    log(f"[serve] window-attention launches on Swin-T's serving path: {swin_serve_launches}")
    vit_serve_launches = _timed("serve ViT-B/16", phase_serve_vit)
    log(f"[serve] flash forward launches on ViT-B/16's serving path: {vit_serve_launches}")
    train = _timed("train CaiT-S24", phase_train, CAIT_TRAIN)["launches"]
    swin = _timed("train Swin-T", phase_train, SWIN_TRAIN)["launches"]
    vit = _timed("train ViT-B/16", phase_train, VIT_TRAIN)["launches"]
    deit_serve_launches = _timed("serve DeiT-B distilled", phase_serve_deit)
    log(f"[serve] flash forward launches on DeiT-B distilled's serving path: "
        f"{deit_serve_launches}")
    _timed("train ViT-L/16-384 remat", phase_train_vitl_remat)
    _timed("train MoCoV3-ViT-B/16", phase_train_mocov3)
    _timed("train MAE-ViT-B/16", phase_train_mae)
    aug = _timed("augment", phase_augment)
    _timed("train BYOL-R50", phase_train_byol)
    _timed("train SimCLR-R50", phase_train_simclr)
    _timed("train MoCoV2-R50", phase_train_moco)
    _timed("train SimSiam-R50", phase_train_simsiam)
    _timed("train MoCoBYOL-R50", phase_train_mocobyol)
    _timed("train SwAV-R50", phase_train_swav)
    _timed("train DenseCL-R50", phase_train_densecl)
    _timed("train PixPro-R50", phase_train_pixpro)
    _timed("train FastMoCo-R18", phase_train_fastmoco)
    _timed("train CLIP-ViT-B/32", phase_train_clip)
    _timed("train DINO-ViT-S/16", phase_train_dino)
    _timed("train DINOv2-ViT-S/14", phase_train_dinov2)
    _timed("train BEiT-B/16", phase_train_beit)
    _timed("train CAE-B/16", phase_train_cae)
    _timed("train ConvMAE-B", phase_train_convmae)
    _timed("train XCiT-S12/16", phase_train_xcit)
    _timed("train ConvNeXt-B", phase_train_convnext)
    _timed("train DeiT-B distilled <- RegNetY-4GF", phase_train_distill)
    _timed("train CvT-13", phase_train_cvt)
    _timed("train T2T-ViT-14", phase_train_t2t)
    _timed("train LV-ViT-S token labeling", phase_train_lvvit)
    _timed("train Mixer-B/16", phase_train_mixer)
    a_rec = aug["cases"][(AUG_BYOL, tuple(sorted(AUG_VIEW1.items())))]
    f_rec, b_rec = fwd[TRAIN_CASE], bwd[TRAIN_CASE]
    wf_rec, wb_rec = wfwd[(WATTN_TIMED, torch.bfloat16)], wbwd[(WATTN_TIMED, torch.bfloat16)]
    ff_rec, fb_rec = ffwd[(FLASH_TIMED, torch.bfloat16)], fbwd[(FLASH_TIMED, torch.bfloat16)]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": [
        _kernel_row("talking_heads_softmax", "talking_heads.cu",
                    "passl_tpu/ops/pallas/talking_heads.py:79", train["talking_heads_softmax"],
                    f_rec["max_abs_err"], f_rec),
        _kernel_row("talking_heads_softmax_bwd", "talking_heads_bwd.cu",
                    "passl_tpu/ops/pallas/talking_heads.py:87",
                    train["talking_heads_softmax_bwd"], b_rec["max_abs_err"], b_rec),
        _kernel_row("fused_window_attention", "window_attention.cu",
                    "passl_tpu/ops/pallas/window_attention.py:92", swin["fused_window_attention"],
                    wf_rec["max_abs_err"], wf_rec),
        _kernel_row("fused_window_attention_bwd", "window_attention_bwd.cu",
                    "passl_tpu/ops/pallas/window_attention.py:104",
                    swin["fused_window_attention_bwd"], wb_rec["max_abs_err"], wb_rec),
        _kernel_row("flash_attention", "flash_attention.cu",
                    f"{_LIB}:331 (via passl_tpu/ops/attention.py:111)", vit["flash_attention"],
                    ff_rec["max_abs_err"], ff_rec),
        _kernel_row("flash_attention_dkv", "flash_attention_bwd.cu",
                    f"{_LIB}:796 (via passl_tpu/ops/attention.py:111)", vit["flash_attention_dkv"],
                    max(fb_rec["dk_max_abs_err"], fb_rec["dv_max_abs_err"]), fb_rec["dkv"]),
        _kernel_row("flash_attention_dq", "flash_attention_bwd.cu",
                    f"{_LIB}:1146 (via passl_tpu/ops/attention.py:111)", vit["flash_attention_dq"],
                    fb_rec["dq_max_abs_err"], fb_rec["dq"]),
        _kernel_row("fused_augment", "augment.cu", "passl_tpu/ops/pallas/augment_kernel.py:36",
                    aug["launches"], a_rec["max_abs_err"], a_rec),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
