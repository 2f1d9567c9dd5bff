"""Build and run the PyTorch/CUDA port (``simseg_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --attention-trees DIR [DIR ...]   (compare_attention_trees)
    python3 chip_smoke.py --crf-trees DIR [DIR ...]         (compare_crf_trees)
    python3 chip_smoke.py --bilateral-trees DIR [DIR ...]   (compare_bilateral_trees)
    python3 chip_smoke.py --grad-trees DIR [DIR ...]        (compare_grad_trees)
    python3 chip_smoke.py --entry-point                     (phases 1-2 and 8)
    python3 chip_smoke.py --train-entry                     (phases 1-2 and 9)
    python3 chip_smoke.py --big-batch                       (phases 1-2 and 10)
    python3 chip_smoke.py --distributed                     (phases 1-2 and 11)
    python3 chip_smoke.py --linear-probe                    (phases 1-2 and 12)
    python3 chip_smoke.py --serving                         (phases 1-2 and 13)
    python3 chip_smoke.py --model-parallel                  (phases 1-2, 14 and 15)
    python3 chip_smoke.py --model-parallel-nccl             (14e over 4 cards)
    python3 chip_smoke.py --bf16-native                     (phases 1-2, 16a-c)
    python3 chip_smoke.py --seg-parity                      (phases 1-2 and 17)
    python3 chip_smoke.py --write-fixtures DIR              (9-17's fixtures; no card)

Phases (any failure raises, so the exit code is non-zero):
1. the card's name and power limit (nvidia-smi); refuses to run without
   CUDA; float32 matmuls must be full float32 (no TF32);
2. starts the process that writes the fixtures of phases 9-12 and 17 (the
   train entry point's cc3m layout, the probe's class folders, then the
   aligned parity fixture and its reference side's result) on the host
   while the phases before 9 run on the card; builds the five kernel
   sources of ``simseg_tpu_torch/csrc`` with nvcc,
   one process per source, all started together; the full run checks the
   attention and bilateral kernels (3b-3f) and runs the training slice
   (6, 6b) and the pretraining entry point (9) while the two CRF sources
   (float32 and bf16), the slowest to build, still compile, and waits for
   them before 3;
3. holds the CRF kernel against its plain PyTorch version on the card at
   the main path's shape (16 images, 5 candidate maps, 288 x 288, stride 8,
   unaries in the decode's form: a patch-grid ``du`` upsampled x16):
   mask agreement >= 99.9%, closing composed outside equal to closing
   inside, zero iterations equal to the unary threshold, two calls bit-equal;
   three planted faults must fall below the 99.9% bar (the last iteration
   dropped; the image run as two bands of 144 rows that exchange neither
   halo rows nor cells; the bilateral message dropped); times both with
   CUDA events, prints the kernel's device time and CUDA kernels per call
   (profile), beside the least time the card could take and the share of
   it (also at 64 images, the bench batch);
3b. the attention kernel against its plain version on (16, T, 12, 64) bf16
   at T = 1297 (the 576-px ViT-B pass), 1024 and 1536 (the band's edges)
   and 325 (the 288-px pass, timed for the record), with the forward bars
   (relative to the plain output, whose entries shrink as T^-1/2): max abs
   error <= 2e-2 x its largest entry, mean <= 7e-3 x its mean abs entry,
   scale error |1 - <out, plain> / <plain, plain>| <= 3e-5; a second call
   bit-equal to the first; two planted faults must fail the bars (the
   kernel run without its last 128-key tile, and on keys zero-padded to the
   tile, as an unmasked tail would read them); kernel, plain,
   ``scaled_dot_product_attention`` and bound times, the kernel's ratio to
   SDPA and share of its bound; at T = 1297 its device time over 5 calls;
3c. the bilateral kernel against its plain version run in float64 at 16
   images x 5184 cells (576 px, stride 8), C = 1 (the degree) and 5 (q
   the transposed view the CRF's stream lane passes): max abs error over
   the plain result's largest entry <= 1e-5 (the float32 plain version's
   error printed beside it), two calls bit-equal, q as a view equal to q
   contiguous, the unbatched call on one image equal to the batched call's
   image 0; three planted faults must exceed the bar (the plan's last
   column chunk dropped, one feature dropped, the float32 expanded
   distance); kernel (events and device, CUDA kernels per call), float32
   plain and bound times and the share of the bound, also for one image;
3d. the attention backward kernel against its plain version on
   (16, T, 12, 64) bf16 at T = 1297, 1024 and 1536, and at (32, 1297, 12,
   64), the shape the training slice gives it; q, k, v and o from the
   forward kernel with its log-sum-exp, random g: per gradient, max abs
   error <= 2e-2 x the plain result's largest entry, mean abs error <=
   1e-2 x its mean abs entry, scale error |1 - <x, plain> / <plain, plain>|
   <= ``BWD_SCALE``; a second call bit-equal to the first; a planted fault
   must fail the bars (the dk/dv pass without its last q tile: the kernel
   on q, o, g and lse cut to whole 64-row tiles but one, dk and dv against
   the full plain result); backward, forward with and without lse, plain
   backward and ``scaled_dot_product_attention`` backward times, their
   ratio, and bound, and the forward with lse's ratio to SDPA's forward and
   share of its bound; at (32, 1297) the device time of the delta, dq and
   dk/dv passes over five calls;
3e. the long-sequence lanes' forward on (16, T, 12, 64) bf16 at T = 1681,
   2026, 4096 (row-block) and 4097, 5185 (streaming), the lane
   ``attention_lane`` gives each, against that lane's plain version run
   in slices of 2 images (its f32 scores at (16, 5185) would take 20.6 GB):
   the forward bars, determinism check and planted faults of 3b; kernel,
   plain, SDPA and bound times, ratio and share as in 3b; at T = 5185 the
   kernel's device time over 5 calls;
3f. their backward at (16, 1601) (the 640-px training crop, row-block),
   (2, 4097) and (2, 5185) (streaming): the forward kernel's output and
   log-sum-exp into the backward kernel, against the lane's plain forward
   and ``flash_mha_long_bwd_plain``, with the bars, determinism check and
   planted fault of 3d; kernel, plain, SDPA backward and bound times;
3g. the decode-tail kernel at the main path's shape (16 images, 5
   candidates with an invalid one, a negative score and a tie, 288 x 288,
   stride 8, patch-grid unaries in the decode's form): pred and best_w
   each equal to the mean-field kernel + ``decode_tail``'s on >= 99.99% of
   pixels and to its plain version's on >= 99.9% (the counts of differing
   entries printed), two calls bit-equal; kernel (events and device, CUDA
   kernels per call), default-lane, plain and bound times, share of bound;
4. drives the main path: zero-shot segmentation with the ViT-B/16 (288 px)
   and BERT-base towers in bf16, seeded random weights, the 21 PASCAL VOC
   classes, through ``evaluate_benchmark`` on 3 synthetic batches of 16;
   checks that the kernel ran there, that the results are finite and of
   the right shape, and that one batch's predictions agree with the plain
   decode on the card; the CRF kernel's share of a batch's device time
   (also printed for 4b-4e);
4b. the multi-scale slice: the same model through ``evaluate_benchmark``
   with ``scales=(1.0, 2.0)`` on 3 batches of 16; exactly 12 whole-T
   attention launches per batch, no other attention lane, one CRF launch
   per batch; on one batch the 2.0-scale tower's dense
   features with kernel attention against plain attention (per-token
   cosine >= 0.999) and the decode's predictions against the plain decode
   on the same features (>= 99.9%); images/s and a device profile;
4c. the sliding-window slice: 576-px images (GT 500 x 500 in VOC's 512
   canvas) through ``evaluate_benchmark`` with 288-px windows at stride
   192: 4 bilateral launches per batch, none of the fused CRF; predictions
   against the plain decode (>= 99.9%); images/s, a device profile and
   the bilateral kernels' share of a batch (each slice prints the CRF and
   bilateral kernels' shares);
4d. the long multi-scale slice: ``scales=(1.0, 2.5, 4.0)`` at 288 px on 3
   batches of 16: the 720-px view (T = 2026) takes the row-block lane, the
   1152-px view (T = 5185) the streaming lane, 12 calls of each per batch
   and none of the whole-T lanes; on 4 images each long view's dense
   features with kernel against plain attention (per-token cosine >=
   0.999); predictions against the plain decode (>= 99.9%); images/s, idle
   share and a device profile;
4e. the fused-tail slice: ``crf_backend="fused_tail"`` single-scale at
   288 px on 3 batches of 16: one tail launch per batch and no mean-field
   launch; on the same batches predictions against the default lane
   (>= 99.99%) and the plain decode (>= 99.9%); images/s, idle share;
5. checkpoint loading: the seeded model's state dict at a 224-px grid,
   ``module.``-prefixed, loaded into the 288-px model: every entry
   matched, ``pos_embed`` equal to its bicubic resampling;
6. the training slice: ``tasks/clip/train.train`` with the flagship
   config (``TRAIN_OVERRIDES``, the optim, lr, model, pool, loss and bf16
   sections of ``configs/clip/simseg.vit-b.yaml``) at a 576-px crop
   (T = 1297), batch 32, 12 steps on a loader that repeats one batch of
   synthetic scenes with captions: every loss finite and the last below the
   first; 12 forward and 12 backward attention-kernel launches per step and
   no CRF launch; the checkpoint resumed by a second ``train`` at step 12
   with equal parameters and optimizer state; one step at batch 8 against
   ``flash_train_supported`` patched to False (the forward kernel with the
   plain backward): loss within 1e-2 relative, gradient cosine >= 0.99
   for every image-tower parameter, peak memory of both; ms per step
   (steps 3-12, the host work between steps included), images/s, idle
   share and a device profile; then 12 steps at the YAML's own 224-px crop
   (T = 197), where no attention kernel runs, at batch 32 and at 128
   (finite, falling losses);
6b. training in the row-block band: 12 steps at a 640-px crop (T = 1601,
   where inference would take the plain path), batch 16: 12 row-block
   forward and 12 backward launches per step and no whole-T launch; finite
   losses, the last below the first; one step at batch 4 against the
   same forward kernel with ``flash_mha_long_bwd_plain`` as the backward,
   and against a witness with the image tower's attention in float32:
   loss within 1e-2, image-tower gradient cosine >= 0.99 (the plain bf16
   lane's distance from the witness printed beside); ms per step,
   images/s, idle share;
7. bench.py's lanes: the flagship model with float32 parameters and bf16
   compute through ``evaluate_benchmark`` on 3 synthetic batches of 64
   (``BENCH_BATCH``), in six lanes: float, ToMe
   r = 16, ``tome_schedule`` (48, 0, 0) x 4, int8 and int8_static on both
   towers, and bench.py's default, ToMe r = 16 with an int8_static image
   tower (calibrated on the first 32 images). Per lane: one CRF launch per
   batch, the tokens after each block against the merge plan (325 -> 133),
   images/s (CUDA events), device ms, idle share and launches per batch,
   pred agreement with the float lane (printed, not gated: the weights are
   random). Also ``_int_mm`` against the bf16 ``torch.matmul`` at the
   tower's GEMM shapes with their bounds, and one quantised linear of each
   mode against the bf16 linear. Checks, each with a planted fault that
   must fail it: 7a the int8 product bit-equal to the exact integer product
   at (64·325 and 64·133, 768) × (768, 2304 / 3072) and (…, 3072) × (3072,
   768) and under 16 rows (fault: the product in bf16); 7b the int8 and
   int8_static image towers on the card against the CPU in float32 at batch
   2 with the CPU's calibration: each quantised layer on the CPU's input,
   codes equal on >= 99.99%, accumulators equal, tokens at cosine >= 0.999
   (fault: one layer's codes from bf16-rounded weights); 7c the ToMe tower
   on the card against the CPU in float32: gather maps >= 99.9%, tokens at
   cosine >= 0.9999, two calls bit-equal (fault: tokens as the merge
   metric); 7d ToMe r = 16 with ``scales=(1.0, 2.0)``, 3 batches of 16:
   exactly 3 whole-T attention launches, the first block of each 576-px
   pass (fault: the size bias given to the first block too).
8. the segmentation-eval entry point: a VOC2012-layout directory of 20
   palette scenes (two batches of 16, the second part full) at VOC's image sizes (375 x 500, 500 x 333, ...), PNG
   content under ``.jpg`` names (written by ``png_bytes``), one real 4:2:0
   JPEG (``simseg_tpu_torch/data/_testdata/scene.jpg``), palette-PNG
   labels of 320-511 px, a seeded ViT-B/16 + BERT-base ``.pth`` and a
   WordPiece vocab; ``tools/seg_evaluation.main`` run in this process with
   ``configs/clip/simseg.vit-b.yaml`` at ``data.batch_size_val=16`` on
   the crf_backend lanes auto, fused_tail, fused, pallas and xla, with
   ``seg_eval.scales=[1.0,2.0]`` and (phase 16) with fused_tail and
   ``seg_eval.crf_dtype=bfloat16``, each with its exact launch counts
   (``ENTRY_WANT``) and one nvJPEG decode. Checks: the CLI's per-class IoU
   bit-equal to ``evaluate_benchmark`` over the same decoded batches in
   memory (planted fault: two images of a batch swapped after decode); the
   committed JPEG through nvJPEG against PIL's pixels (>= 99% of channel
   values within 2 levels, mean absolute difference <= 0.5 after the
   resize to 288); the card's resize bit-equal to the CPU's on every
   image; the fused, pallas, fused_tail and matmul-closing lanes' pred
   against the xla lane's on >= 99.9% of pixels. Prints the CLI's and the
   in-memory images/s, the host decode and card resize ms per batch and
   the loader's share of the wall time.
9. the pretraining entry point: a cc3m-layout set (``synth``: 3100 train
   rows, 64 valid images with 2 captions each; ``synth2``: 384 train rows;
   unfiltered PNG at 240-500 px from ``png_bytes`` and the committed JPEG;
   captions from a seeded word list with commas and quotes) and its
   WordPiece vocab; ``tasks.clip.train.main(argv)`` in this process with
   ``configs/clip/simseg.vit-b.yaml`` and dotted overrides only (batch 128,
   batch_size_val 64, one decode thread, validation every 4 steps), from
   ``random.seed`` / ``np.random.seed`` 12: run A, 8 steps at the YAML's
   224-px crop with AutoAugment, no attention-kernel launch; run B, the
   same at the 576-px crop (T = 1297), batch 32, 6 steps, exactly one
   forward and one backward kernel launch a block and step and none from
   its 288-px validation (every run's towers cut to ``CUT_DEPTH`` blocks at
   full width; the fixture is written once and read again by 10d and
   11a); run C, ``data.train_type=debias`` over two sets, 4
   steps; timed passes of runs A and B without validation, with 8 decode
   threads, 24 steps, the last 8 timed, beside the same batches in
   memory (16 steps, the last 8 timed). Checks: run A's
   first two batches bit-equal to the port's CPU loader from the same
   seeds (planted fault: two images swapped after decode); step 1's loss
   within 1e-2 of the float32 CPU step on the same batch and seeded
   weights; the lr sequence the schedule's; finite losses; the card's
   retrieval table on run A's last validation equal to float64 numpy
   ranks, and R@1 = 1 both ways on a planted gallery (text = image + 1e-3
   noise); the retrieval CLI on a ``valid.parquet`` of the valid set
   (where pyarrow is installed; else ``evaluate_benchmark`` over the CSV
   loader) with run A's checkpoint equal to run A's last validation
   within 1e-6. Prints images/s through the entry point and in memory on
   the same batches, the loader's share, the idle share, seconds per
   validation pass, the host's decode and transform ms per batch and the
   launches.
10. the YAML's batch of 1024 (``runner.name=clip_bsgs``, remat, gradient
   accumulation, the towers' dropout), the flagship at full width with
   ``TRAIN_OVERRIDES`` and float32 master weights: (a) one BSGS gradient of
   a seeded batch against the plain step's on the same batch, 224 px batch
   256 in micro-batches of 64 and 576 px batch 64 in micro-batches of 32:
   loss within 1e-2, each tower's least gradient cosine >= 0.99 (the key
   projections' biases left out: zero in exact arithmetic), 12 x micro-
   batches forward launches without lse (pass 1), as many with lse and as
   many backward (pass 2) at 576 px; planted fault: pass 2 on the left
   matrices in reversed micro-batch order must fail the bars; (b) at 576 px,
   batch 8, remat 'none' and 'dots' against no remat: loss bit-equal, each
   gradient within 1e-6 of its largest entry, the train lane's forward
   launches doubled under 'none'; (c) dropout 0.1 at every tower site: two
   BSGS gradients with one key bit-equal, another key's different; (e)
   ``train`` in memory, 4 steps, steps 3-4 timed (``StepTimer``), peak
   ``max_memory_allocated``: BSGS 1024 / 128 at 224 px with and without
   remat, BSGS 256 / 32 at 576 px (exact launches: 12 x 8 a pass a step),
   the plain step at 128 (224 px), 32 (576 px) and 256 (224 px, with and
   without remat); (f) ``optim.grad_accum_steps=2`` at 224 px, batch 128,
   4 steps: finite losses, AdamW's step half the runner's; (d)
   ``tasks.clip.train.main`` with ``runner.name=clip_bsgs``, batch 1024 in
   micro-batches of 128, on phase 9's cc3m-layout fixture with 8 decode
   threads (the deterministic resize to 224 px), ``CUT_DEPTH`` blocks a
   tower at full width, 3 steps, under ``ckpt.backend=orbax`` (the
   step directories of ``torch.distributed.checkpoint``, written in the
   background, four threads a rank): finite losses, no kernel launch;
   the run's directory with its step-3 directory removed (what a run cut
   at step 2 leaves: step 2's write drained while step 3 updated the
   weights in place) and resumed equals the uninterrupted run (step 3's
   loss and every parameter, bit for bit); the resumed run's step 3
   written as a reference-layout ``.pth`` by
   ``tools/export_torch_checkpoint.main`` from the step directories and
   read back by ``load_clip_checkpoint``, every tensor bit-equal to the
   uninterrupted run's model. Prints images/s, ms a step and peak GiB of
   each, the launches per BSGS step, its own wall time, the last save's
   blocking snapshot ms and background write s, the restore's s and what
   the export costs.
11. data parallelism over ranks (``simseg_tpu_torch/parallel``, the launcher):
   (a) the pretraining entry point at world 1 through ``python -m
   simseg_tpu_torch.launch --nproc_per_node 1`` (NCCL) and alone, each a
   process of its own, both at once and while (b)-(d)'s ranks run, on phase
   9's cc3m-layout fixture: the vit-b YAML at
   224 px (the deterministic resize, the model at 224 px, ``CUT_DEPTH``
   blocks a tower at full width), batch 128, 8
   steps, 8 decode threads; the two checkpoints (parameters and AdamW's state) bit-equal
   and the logged losses equal (a sum over one rank is exact), ms a step
   of both from the log lines' stamps, and the gradient reduction alone in
   a world of one NCCL rank over the flagship's float32 gradients (CUDA
   events); then two ranks on ``cuda:0`` joined
   by gloo (NCCL refuses two ranks on a card), ``--rank-worker``, rank 0
   also running the one-process references, both towers cut to
   ``CUT_DEPTH`` blocks at their full width: (b) the plain step at 576 px,
   16 images a rank, against one process's step at 32 on the same images
   and weights: loss within 1e-2, each tower's least gradient cosine >=
   0.99, each tower's gradient norm and the temperature's gradient within
   1e-2 relative; planted faults that must fail: a mean where the sum is
   due, a gather without rank 1's rows; 3 steps with exactly one forward
   and one backward attention launch a block and step on each rank, the ranks'
   parameters bit-equal after them; (c) ``evaluate_benchmark`` over 3
   batches of 16 a rank at 288 px, float and int8_static image tower,
   against one process on both ranks' batches: mIoU within 1e-3,
   predictions equal on >= 99.9% of pixels, rank 1's int8 state bit-equal
   to rank 0's, 3 CRF launches a rank; (d) BSGS 512 / 64 a rank at 224 px
   against one process's BSGS 1024 / 128 with (b)'s bars, then 2 steps.
   Prints images/s of (a), (b) and (d), the gradient reduction's ms a step
   and the bytes staged through the host (gloo on CUDA tensors), beside the
   card's name and power limit.
12. the linear-probe entry point and the CNN towers: (a)
   ``tasks.linear_prob.train.main`` with ``configs/linear_prob/imagenet.yaml``,
   overriding only the data path (10 class folders of 48 train and 16 val
   JPEGs at four sizes), ``num_classes``, the batch (128), ``epoch`` (2)
   and the checkpoint (``ckpt.dir``; a seeded ViT-B/16 ``.pth`` in the
   reference's layout through ``ckpt.external_resume`` with
   ``only_load_image_encoder``): the tower bit-unchanged, the classifier
   moved, finite losses, top-1 / top-5 logged, no kernel launch (T = 197),
   the float32 logits of 16 val images on the card against the CPU at
   cosine >= 0.9999; images/s through the entry point (epoch 2) and over
   the same batches in memory, the loader's share; (b) the YAML's batch of
   16,384 in memory as 8 x 2048 through ``optim.grad_accum_steps`` and
   whole, else the largest of 8192 and 4096 that fits: ms a step, images/s,
   peak GiB; (c) ResNet-50, ConvNeXt-T and EfficientNet-B0 at 224 px, batch
   8, float32 (cuDNN's TF32 off), card against the CPU: least cosine >=
   0.9999, max abs error <= 1e-3 x the largest entry; a frozen ResNet-50
   probe, batch 128, bf16, 3 steps: its running statistics bit-unchanged;
   (d) CLIP with a ResNet-50 tower (BN calibrated on synthetic scenes) and
   BERT-base through ``evaluate_benchmark`` at 288 px, 3 batches of 16, in
   the auto, fused_tail and xla lanes: exact launches of rows 1-2 (the
   unaries 9 x 9, upsampled x32), auto's and fused_tail's predictions
   against the unfused chain (xla) on one batch >= 99.9%; planted fault:
   the decode at stride 16 on the CNN's 81 tokens must raise; rows 1-2's
   event ms at x32 beside the main path's x16; (e) live BN: one float32
   step at batch 4, 64 px (the last stage's 2 x 2 map, n = 16): every
   running statistic within 1e-4 (x its buffer's largest entry) of a
   float64 witness of flax's biased update, PyTorch's unbiased update
   (planted fault) outside ten times that, loss within 1e-4 and each
   tower's gradient (all its tensors, concatenated) at cosine >= 0.9999
   against the CPU, the least cosine of one tensor printed; then 3 steps
   at batch 32, 224 px, bf16 through ``CLIPRunner``: finite losses, every
   running statistic moved.
13. serving export (``simseg_tpu_torch/serving.py``, the kernels as
   ``simseg::`` custom ops): ``tools/export_serving.main(argv)`` with
   ``configs/clip/simseg.vit-b.yaml``, a seeded ViT-B/16 + BERT-base
   ``.pth`` cut to ``CUT_DEPTH`` blocks a tower at full width (the towers'
   ``arch`` on every export's command line) and a WordPiece vocab it
   writes, seven artifacts, (b)-(g) exported in a process each while this
   one exports (a): (a) seg, batch
   64, baked; (b) batch 16, ``scales=(1.0, 2.0)`` with ``fused_tail``, and
   288-px windows at stride 192 over 576 px; (c) bench.py's default lane,
   ToMe r = 16 with an int8_static image tower, calibrated by the tool;
   (d) (a) in the separate-weights layout; (e) retrieval, batch 64; (g,
   phase 16) seg, batch 16, ``seg_eval.crf_dtype=bfloat16``. Each
   is loaded in a fresh process (``--serve-worker``) that imports
   ``simseg_tpu_torch.serving`` alone, run on seeded batches (3 for (a), 2
   for the rest) with the counts taken around the calls: outputs bit-equal
   to the live staged module's, exact launches counted inside the ops
   (``SERVE_ARTIFACTS``: rows 1, 5 and 2, 4; (g) row 1's bf16 mode); (d)
   bit-equal to (a), and a
   planted fault (one patch-embedding weight of the sidecar moved by 1.0)
   must break it; (f) (a) loaded with ``devices=["cuda:0", "cuda:0"]``,
   half a batch each, equal to one device; (a) and (b)'s first artifact
   called in turns on one stream (the CRF kernels' shared grid barrier)
   equal to their own calls. Prints each export's seconds and MB, the
   separate graph's and sidecar's MB, (a)'s file beside its image side's
   parameter bytes, and (a)'s images/s live and loaded in turns in one
   process (CUDA events);
14. the sharded-state legs (``parallel/tp.py``, ``parallel/sharding.py``):
   the attention kernels against their plain versions at (8, 1297, 6, 64)
   (tp = 2's heads a rank) with the bars of 3b and 3d; then ViT-B/16 +
   BERT-base at full width and depth, the 224-px legs (c)-(f) at
   ``MP_DEPTH`` = 6 blocks a tower since phase 15 came (``TRAIN_OVERRIDES``,
   float32 master
   weights, bf16 compute, a constant lr), gloo ranks sharing the card
   (``--mp-worker``, a process a rank; the worlds of ``MP_WORLDS``, phase
   15's too, run at once), each leg from the same seeded
   weights: (a) tp = 2 at 576 px, batch 8; (b) (a) with ``dist.sp``; (c)
   ZeRO-1 over 2 data ranks at 224 px, batch 32; (d) FSDP, the same; (e)
   tp = 2 + FSDP over 4 ranks; (f) BSGS 64 / 32 with tp = 2 + ZeRO-1 over
   4 ranks. Each leg's first step (loss, gradients gathered whole) against
   one process's plain or BSGS step on the same batch (``mp_bars``: loss
   1e-2, each tower's whole gradient at cosine 0.99 and its norm within
   1e-2, every tensor's gradient within twice that step's own distance
   from a float32 step); planted faults that must fail (a: one
   row-parallel sum dropped; b: the LayerNorms' gradients left unsummed;
   d: one FSDP leaf left whole, against the bytes check); ``MP_STEPS`` = 2
   steps (step 2 timed) with exact launches (a, b: 12 forward and 12
   backward a rank a step; none at 224 px); each rank's parameter and AdamW
   bytes equal to the rules' (printed beside one process's), the peak, MiB
   staged a step; the replicated leaves bit-equal across ranks; (c)'s
   parameters bit-equal to a data-parallel twin's after those steps.
   ``--model-parallel-nccl`` runs (e) over four cards, one NCCL rank each.
15. the MoE towers, expert and pipeline parallelism (``ops/moe.py``,
   ``parallel/pp.py``): (a) ViT-B/16 + BERT-base at full depth with an
   8-expert top-1 MoE in every second block of each tower (capacity 1.25),
   576 px, bf16 compute: at 8 rows the kernel lane's step against the
   plain-attention lane's with phase 14's bars (a float32 step as the noise
   scale) and the aux within ``MOE_AUX_BAR``, the share of tokens each
   MoE layer routes to the same expert >= ``MOE_ROUTE_BAR``, which a
   planted fault (the routers' experts read in reverse) must fail; then 4
   steps at batch 32 with exact launches (12 forward and 12 backward a
   step), images/s, peak GiB, parameter and AdamW bytes equal to the
   prediction from the shapes; (b) ``evaluate_benchmark`` with the MoE
   image tower at 288 px on 3 batches of 16: one CRF launch a batch and no
   other, predictions against the plain decode >= 99.9%, images/s; (c)
   ``dist.moe_ep`` over 2 gloo ranks on the card (MoE towers at 4 blocks,
   full width, 576 px, batch 8): each rank 4 of the 8 experts, its bytes
   the rules', the step against one process's with phase 14's bars and
   the aux bar, planted faults (a rank-local aux; the experts' gradients
   summed over the data ranks); (d) ``dist.pp_size`` 2 with 4 microbatches,
   dense towers at 4 blocks, 576 px, batch 16, over 2 ranks and over 4 (2
   data ranks a stage, ZeRO-1): the same checks, exact launches a rank (a
   stage's 2 blocks x 4 microbatches, forward and backward, a step),
   replicated leaves bit-equal across ranks, planted faults (two
   microbatches swapped in the image tower's buffer; the leaves every stage
   computes summed over the stages). (c) and (d) run as phase 14's legs, in
   its ``--mp-worker`` processes, their worlds beside phase 14's.
16. the CRF kernels' bf16 mode (the TPU kernels' default compute dtype)
   and the native decode library: (a) ``mean_field_fused`` and
   ``seg_decode_tail_fused`` with ``compute_dtype="bfloat16"`` at phase 3's
   inputs (16 images, 5 maps, 288 x 288, stride 8, closing 7) and at 64
   images: masks bf16, equal to the plain bf16 version on >= 99.995%, two
   calls bit-equal, the tail's pred equal to the unfused bf16 chain (the
   bf16 mean-field kernel + ``decode_tail``) and to its plain version on >=
   99.99% (bars between the sound kernels' readings and the float32
   kernels'), each nearer its plain version than the float32 kernel is;
   two calls of each entry point bit-equal; exactly one launch of the bf16
   counter a call, one CUDA kernel (a cooperative launch); the bilateral term
   dropped and the float32 kernel's output (rounded only at the end) must
   fall below the bar (both entry points); bf16 and float32 times with CUDA
   events in turns, device ms (null where the profile missed the
   ``BF16_KERNELS_A_CALL`` kernel of a call), plain ms, the bound (bytes against
   float32 operations on the CUDA cores and bf16 products at the
   tensor-core rate); (b)
   ``evaluate_benchmark`` at batch 64 (one batch) with ``compute_dtype=
   "bfloat16"`` on the auto, fused, fused_tail and pallas lanes and in
   float32 on auto: exact launches (``BF16_LANE_WANT``), each lane's pred
   against the float32 lane's >= 99% (printed beside the bf16 auto lane's);
   (c) ``decode_rgb(..., "cuda")`` on one seeded image as GIF, lossless
   WebP, BMP, TIFF, a 16-bit grey PNG, an Adam7 PNG and a 4:1:1 JPEG (the
   committed ``sampling_411.jpg``): each taken by PIL on the host, by its
   header, and equal to PIL's pixels on the card, with no nvJPEG decode;
   a PNG through the port's reader, equal; a 4:2:0 JPEG through nvJPEG
   (one decode counted) within phase 8's bar; its time printed; then
   whether the native decode library (``data/native.py``) built, and
   the compiler's first error line if not; on 64 generated JPEG/PNG files
   its PNG decodes bit-equal to ``data/image_io.py``'s reader, and the
   train loader's images/s (the vit-b YAML's train transforms, batch 64)
   with ``data.native_decode`` on and off at 1 and 8 threads (neither
   without the library); (d) phase 9's
   run B with ``cfg.profile`` (steps 3-4, the ProfileHook): its trace
   holds each attention kernel (forward; delta, dq, dk/dv) once per block
   and step of the window, as the counters count them.
17. the production-settings parity harness (``tools/seg_parity.py``; the
   full run runs it in this process while phase 13's loading process runs,
   where this one would only wait): the fixture process writes the aligned fixture (seed 0,
   8 scenes, 16 classes, screened at a margin of 0.0015: ViT-S/16 at 288
   px, a 6-layer BERT) and runs the reference side once on the host (float32
   torch towers, the exact mean-field CRF, the numpy closing and nearest
   resize); ``run_parity`` then runs the port on the card against that one
   result in six lanes, bf16 towers in all: (a) ``crf_dtype=bfloat16`` (JAX
   harness's defaults; row 1 bf16), (b) float32 (row 1), (c) ``crf_backend=
   fused_tail`` with ``crf_dtype=auto`` (float32 on the card; row 2), (d)
   ToMe r = 16, (e) int8_static image tower, (f) (d) + (e), bench.py's
   lane, each with exactly one launch of its CRF kernel a batch of 2 and
   none of the others. Bars: per lane JAX's aligned-fixture gates of pixel
   disagreement < 4% and flips <= 2 of 8 (its |mIoU delta| < 2 pt printed,
   not gated: see ``PARITY_PIXEL_BAR``), and for (b)-(f) a noflip pooled
   mIoU delta no more than 1.5 pt below (a)'s; planted fault that must
   fail one: lane (a) with the GT size handed to the nearest resize
   as (width, height), OpenCV's order. Then ``ops/crf.dense_crf_binary``
   on one fixture image at stride 8: one launch of row 1, masks >= 99.9% of
   the plain lane's. Prints each lane's pixel and noflip pixel
   disagreement, mIoU and noflip mIoU delta, largest class delta, flips,
   launches and seconds.
It then prints one JSON line of kernel numbers (``cli_launches``: the
kernel's launches in phase 8's lane that takes it; ``train_entry_launches``:
in phase 9's run B; ``bsgs_launches``: per BSGS step of phase 10 at 576 px,
batch 256 in micro-batches of 32; ``dist_launches``: each rank's in phase
11, (b) for the attention kernels and (c)'s float lane for the CRF;
``cnn_launches``: rows 1-2's in phase 12d's auto and fused_tail lanes;
``serving_launches``: in phase 13's loading process, (a) for row 1, (b)'s
for rows 2, 4 and 5; ``mp_launches``: each rank's in phase 14 (a), then
(b); ``moe_launches``: phase 15a's 4 steps; ``pp_launches``: each rank's
in 15c, 15d and 15d4; ``moe_seg_launches``: phase 15b's;
``parity_launches``: phase 17's lane (b) for row 1, (c) for row 2 and (a),
(d)-(f) for row 1 in bf16), the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
"""

import atexit
import contextlib
import csv
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
import unittest.mock
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the checkout: the script reads its files from there, run from any directory
REPO = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(REPO, "simseg_tpu_torch", "data", "_testdata")

BATCH = 16
SIZE = 288
PATCH = 16
CLASSES_PER_IMAGE = 5
STRIDE = 8
CLOSING = 7
ITERS = 3
BENCH_BATCH = 64
HEADS = 12
HEAD_DIM = 64
LONG_T = (2 * SIZE // PATCH) ** 2 + 1   # 1297: the 2.0-scale ViT-B pass
ATTN_TS = (LONG_T, 1024, 1536, (SIZE // PATCH) ** 2 + 1)
WIN_INPUT = 576                          # sliding-window slice
WIN = 288
WIN_STRIDE = 192
GT = 500
KERNELS = ("crf_mean_field", "crf_mean_field_bf16", "flash_attention",
           "flash_attention_bwd", "bilateral_matvec")   # the sources, one library each
CRF_SOURCES = ("crf_mean_field", "crf_mean_field_bf16")  # the slowest builds
BWD_TS = (LONG_T, 1024, 1536)
ROWBLOCK_T = 2026                         # the 720-px view, 2.5 x 288 px
STREAM_T = 5185                           # the 1152-px view, 4.0 x 288 px
LONG_FWD_TS = (1681, ROWBLOCK_T, 4096, 4097, STREAM_T)
ROW_TRAIN_SIZE = 640                      # T = 1601: row-block in training
ROW_TRAIN_BATCH = 16
ROW_COMPARE_BATCH = 4
LONG_BWD = ((ROW_TRAIN_BATCH, (ROW_TRAIN_SIZE // PATCH) ** 2 + 1), (2, 4097),
            (2, STREAM_T))
PLAIN_SLICE = 2                           # images per plain long-attention call
LONG_SCALES = (1.0, 2.5, 4.0)
# attention forward bars, relative to the plain output's largest and mean
# absolute entry (|o| shrinks as T^-1/2, so an absolute bar would not), and
# on the scale error (see attention_errors)
FWD_MAX_REL = 2e-2
FWD_MEAN_REL = 7e-3
FWD_SCALE = 3e-5
FWD_TILE = 128                            # the kernel's k/v tile at hd 64
# attention backward bars, per gradient, relative to the plain result's
# largest and mean absolute entry and on the scale error (see
# attention_errors): the sound kernel's worst scale error over the shapes
# of 3d and 3f is 7.3e-6 (dq at (2, 5185)), the kernel without its last q
# tile reads 2.3e-4 or more; BWD_TILE is the backward's streamed q tile
BWD_MAX_REL = 2e-2
BWD_MEAN_REL = 1e-2
BWD_SCALE = 2e-5
BWD_TILE = 64
# the sections of configs/clip/simseg.vit-b.yaml that the training slice
# reproduces (no YAML is read on the card; tests/test_torch_port_config.py
# holds this list against the file)
TRAIN_OVERRIDES = (
    "optim.name=torch.optim.AdamW",
    "optim.param={'betas': [0.9, 0.98], 'eps': 1e-6, 'weight_decay': 0.001}",
    "optim.lr.name=cosine_schedule_with_warmup_min_lr_scale",
    "optim.lr.init=1e-4",
    "optim.lr.warmup_proportion=0.025",
    "optim.lr.param={'num_cycles': 0.5, 'min_lr_scale': 0.1}",
    "model.name=clip",
    "model.max_length=25",
    "model.image_encoder.name=vit_modelzoo",
    "model.image_encoder.tag=vit_base_patch16_224_in21k",
    "model.image_encoder.embedding_dim=768",
    "model.image_encoder.pretrained=True",
    "model.image_encoder.trainable=True",
    "model.text_encoder.name=huggingface_modelzoo",
    "model.text_encoder.tag=bert-base-uncased",
    "model.text_encoder.embedding_dim=768",
    "model.text_encoder.pretrained=True",
    "model.text_encoder.trainable=True",
    "model.text_encoder.target_token_idx=0",
    "model.projection.name=simple",
    "model.projection.dim=512",
    "model.pool.name=loda",
    "model.pool.loda.image_k=5",
    "model.pool.loda.text_k=1",
    "loss.name=NCE",
    "loss.global_reduce=True",
    "loss.nce_loss.gather_backward=True",
    "loss.temperature.name=parameter",
    "loss.temperature.value=0.02",
    "dist.bf16=True",
)
TRAIN_SIZE = 576                          # the crop of the training slice
TRAIN_BATCH = 32
TRAIN_STEPS = 12
COMPARE_BATCH = 8
BATCHES_224 = (TRAIN_BATCH, 128)
TRAIN_SLICE = (f"transforms.random_resize_crop.size={TRAIN_SIZE}",
               f"transforms.input_size={TRAIN_SIZE}",
               f"data.batch_size={TRAIN_BATCH}",
               f"data.train_steps={TRAIN_STEPS}", "epoch=1")
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor
# FLOP/s, bf16 dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_rows(fn):
    """(device ms, kernel launches, [(us, count, name)] by kernel, largest
    first) of one call of fn, after a warm-up call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  reverse=True)
    return sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows), rows


def device_rows_checked(fn, want, tries=3):
    """(device ms, kernels) of one call of fn that launches ``want`` CUDA
    kernels: ``device_rows`` up to ``tries`` times until the profile holds
    all of them; the device ms is None where no profile did (the profiler
    can miss a call's kernels late in a long process)."""
    for _ in range(tries):
        ms, kernels, _ = device_rows(fn)
        if kernels == want:
            return ms, kernels
    return None, kernels


def launch_times(fn):
    """Device microseconds of each CUDA kernel one call of fn launches, in
    launch order, after a warm-up call (torch.profiler's trace events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return [round(e.time_range.elapsed_us(), 1) for e in
            sorted(kernels, key=lambda e: e.time_range.start)]


def busy_clock(fn, calls=3000) -> str:
    """nvidia-smi's SM clock and power draw read while the card works
    through ``calls`` queued calls of fn."""
    for _ in range(calls):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    torch.cuda.synchronize()
    return out.stdout.strip().splitlines()[0]


def device_profile(fn, label: str, top: int = 8) -> float:
    """Prints the device time of one call of fn, by kernel (torch.profiler);
    returns the total in ms."""
    total, launches, rows = device_rows(fn)
    print(f"profile {label}: {total:.4f} ms device time in {launches} kernel "
          "launches", flush=True)
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3:9.4f} ms {100 * us / 1e3 / total:5.1f}% x{count:<3d} "
              f"{key[:90]}", flush=True)
    return total


def kernel_share(fn, label, names=("crf_kernel", "bilateral_matvec_kernel",
                                   "bilateral_sum_kernel")):
    """Prints the device ms and share of one call of fn of each kernel whose
    name holds one of ``names``."""
    total, _, rows = device_rows(fn)
    parts = []
    for name in names:
        ms = sum(us for us, _, key in rows if name in key) / 1e3
        parts.append(f"{name} {ms:.4f} ms ({100 * ms / total:.1f}%)")
    print(f"{label}: of {total:.4f} ms device time per batch: "
          f"{', '.join(parts)}", flush=True)


def crf_bound_ms(b, k, h, w, s, radius, iters, nbytes):
    """Least time for the CRF's work: ``nbytes``, its inputs read once and
    its outputs written once, over HBM bandwidth; its float32 operations
    over the CUDA cores' peak. Operations: the kernel matrix once (5-d dot,
    distance, exp, row sum), and per class and iteration the box splat, the
    K.q product, the two Gaussian passes and the update."""
    n = (h // s) * (w // s)
    ops = b * (n * n * (2 * 5 + 5)
               + k * iters * (2 * n * n + h * w * (4 * (2 * radius + 1) + 8)))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def synthetic_scenes(rng, b, size, num_classes):
    """Images of a few flat-coloured discs on a background, with noise, and
    their label maps."""
    yy, xx = np.mgrid[0:size, 0:size]
    images = np.empty((b, size, size, 3), np.float32)
    labels = np.zeros((b, size, size), np.uint8)
    for i in range(b):
        images[i] = rng.uniform(0, 255, 3)
        for _ in range(3):
            cy, cx = rng.uniform(0, size, 2)
            r = rng.uniform(size / 8, size / 3)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            images[i][disc] = rng.uniform(0, 255, 3)
            labels[i][disc] = rng.integers(1, num_classes)
    images += rng.normal(0, 6, images.shape)
    return np.clip(images, 0, 255).astype(np.uint8), labels


def decode_form_unary(rng, b, k, grid, factor):
    """(b, k, grid*factor, grid*factor) du: ``coarse_form_unary`` nearest-
    upsampled, as the decode builds it."""
    from simseg_tpu_torch.ops.morphology import nearest_upsample

    return nearest_upsample(coarse_form_unary(rng, b, k, grid),
                            factor).contiguous()


def coarse_form_unary(rng, b, k, grid):
    """(b, k, grid, grid) patch-grid du on the card from smooth random
    similarity maps, min-max normalised, as the decode builds it."""
    coarse = rng.normal(size=(b, k, grid + 2, grid + 2))
    coarse = (coarse[..., :-2, :-2] + coarse[..., 1:-1, 1:-1]
              + coarse[..., 2:, 2:])[..., :grid, :grid]
    lo = coarse.min(axis=(-2, -1), keepdims=True)
    hi = coarse.max(axis=(-2, -1), keepdims=True)
    p = np.clip((coarse - lo) / np.maximum(hi - lo, 1e-12), 0, 1)
    du = np.log(p + 1e-8) - np.log(1 - p + 1e-8)
    return torch.tensor(du, dtype=torch.float32).cuda()


def crf_inputs(b):
    """Phase 3's inputs at batch b: decode-form unaries and scenes."""
    rng = np.random.default_rng(b)
    du = decode_form_unary(rng, b, CLASSES_PER_IMAGE, SIZE // PATCH, PATCH)
    rgb = torch.from_numpy(synthetic_scenes(rng, b, SIZE, 21)[0]).cuda()
    return du, rgb


def crf_faults(mean_field, du, rgb):
    """Planted faults, as the masks a faulty kernel would give: the last
    iteration dropped; the image cut into two bands of 144 rows that each
    run alone (the Gaussian's halo rows and the other band's cells never
    exchanged); the bilateral message dropped."""
    kw = dict(stride=STRIDE, closing_ksize=CLOSING)
    half = SIZE // 2
    return {
        "last iteration dropped": mean_field(du, rgb, num_iters=ITERS - 1, **kw),
        "bands unexchanged": torch.cat(
            [mean_field(du[:, :, rows].contiguous(), rgb[:, rows].contiguous(),
                        num_iters=ITERS, **kw)
             for rows in (slice(0, half), slice(half, SIZE))], dim=2),
        "bilateral dropped": mean_field(du, rgb, num_iters=ITERS,
                                        bilateral_compat=0.0, **kw)}


def check_faults(label, faults, want, bar):
    """Each planted fault's agreement with want must fall below bar."""
    for name, got in faults.items():
        agree = (got == want).float().mean().item()
        print(f"{label}: planted fault '{name}': agreement {agree:.6f}",
              flush=True)
        if agree >= bar:
            raise AssertionError(f"{label}: the bars pass the planted fault "
                                 f"'{name}' ({agree:.6f} >= {bar})")


def check_crf_kernel(b):
    """Phase 3 at batch b: returns the kernel's JSON fields (no launches)."""
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.morphology import closing

    du, rgb = crf_inputs(b)
    kw = dict(stride=STRIDE, num_iters=ITERS)

    masks = crf_fused.mean_field_fused(du, rgb, closing_ksize=CLOSING, **kw)
    again = crf_fused.mean_field_fused(du, rgb, closing_ksize=CLOSING, **kw)
    plain = crf_fused.mean_field_fused_plain(du, rgb, closing_ksize=CLOSING, **kw)
    torch.cuda.synchronize()
    agree = (masks == plain).float().mean().item()
    max_err = (masks - plain).abs().max().item()
    print(f"crf b={b}: kernel vs plain mask agreement {agree:.6f}, "
          f"max abs err {max_err}; two calls bit-equal "
          f"{torch.equal(masks, again)}", flush=True)
    if agree < 0.999:
        raise AssertionError(f"kernel agrees with plain on {agree:.6f} < 0.999")
    if not torch.equal(masks, again):
        raise AssertionError("two kernel calls gave different masks")
    raw = crf_fused.mean_field_fused(du, rgb, closing_ksize=0, **kw)
    if not torch.equal(closing(raw, CLOSING), masks):
        raise AssertionError("closing inside the kernel != closing of its masks")
    zero = crf_fused.mean_field_fused(du, rgb, closing_ksize=0, stride=STRIDE,
                                      num_iters=0)
    if not torch.equal(zero, (du > 0).float()):
        raise AssertionError("zero iterations != unary threshold")
    check_faults(f"crf b={b}", crf_faults(crf_fused.mean_field_fused, du, rgb),
                 plain, 0.999)

    def kernel():
        return crf_fused.mean_field_fused(du, rgb, closing_ksize=CLOSING, **kw)

    reps = 20
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(lambda: crf_fused.mean_field_fused_plain(
        du, rgb, closing_ksize=CLOSING, **kw), reps // 4)
    # the plain version is a chain of small launches: its event time follows
    # the host, its device time does not
    plain_device = device_profile(lambda: crf_fused.mean_field_fused_plain(
        du, rgb, closing_ksize=CLOSING, **kw), f"crf plain b={b}", top=0)
    radius = crf_fused.gaussian_constants(SIZE, SIZE, 3.0)[0].shape[0] // 2
    nbytes = 2 * du.numel() * 4 + rgb.numel() * rgb.element_size()
    bound, bound_by = crf_bound_ms(b, CLASSES_PER_IMAGE, SIZE, SIZE, STRIDE,
                                   radius, ITERS, nbytes)
    device, kernels, _ = device_rows(kernel)
    device_profile(kernel, f"crf kernel b={b}")
    print(f"crf b={b}: kernel {ms:.4f} ms (device {device:.4f} ms, {kernels} "
          f"CUDA kernels per call), plain {plain_ms:.4f} ms (device "
          f"{plain_device:.4f} ms), bound {bound:.4f} ms ({bound_by}), share "
          f"of bound {bound / ms:.3f}", flush=True)
    return dict(max_abs_err=max_err, agreement=agree, ms=ms, device_ms=device,
                kernels_per_call=kernels, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by)


# the flagship CLIP model: ViT-B/16, BERT-base, 512-d simple projection,
# LoDA k = 5 / 1
FLAGSHIP = dict(image_tag="vit_base_patch16_224_in21k", text_tag="bert-base-uncased",
                projection_name="simple", projection_dim=512, pool_name="loda",
                image_k=5, text_k=1)


def seeded_clip(seed: int, img_size: int = SIZE, depth=None, image_arch=()):
    """The flagship CLIP model on the CPU in float32, with weights drawn from
    a seeded generator (``depth``: the blocks of each tower, at full
    width; ``image_arch``: more of the image tower's knobs)."""
    from simseg_tpu_torch.models.clip import CLIPModel

    arch = (("depth", depth),) if depth else ()
    model = CLIPModel(img_size=img_size, image_arch=(arch + image_arch) or None,
                      text_arch=arch or None, **FLAGSHIP)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 0.02, generator=gen)
    return model


def seeded_model(seed: int):
    """``seeded_clip`` at 288 px, in bf16 on the card."""
    return seeded_clip(seed).to(device="cuda", dtype=torch.bfloat16).eval()


class SyntheticLoader:
    """Batches in the JAX loader's contract: uint8 images, labels, GT size.
    Labels are made at the image size and resized (nearest) to ``gt``."""

    def __init__(self, batches, batch_size, num_classes, seed, size=SIZE,
                 gt=None):
        self.batches, self.batch_size = batches, batch_size
        self.num_classes, self.seed = num_classes, seed
        self.size, self.gt = size, gt or size

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        idx = np.arange(self.gt) * self.size // self.gt
        for _ in range(self.batches):
            images, labels = synthetic_scenes(rng, self.batch_size, self.size,
                                              self.num_classes)
            yield {"image": images, "mask_label": labels[:, idx][:, :, idx],
                   "mask_h": [self.gt] * self.batch_size,
                   "mask_w": [self.gt] * self.batch_size}


def counters():
    """Kernel name -> (module, attribute) of its wrapper's launch count."""
    from simseg_tpu_torch.ops import crf_fused, crf_pallas, flash_attention

    return {"crf_mean_field": (crf_fused, "LAUNCHES"),
            "seg_decode_tail": (crf_fused, "TAIL_LAUNCHES"),
            "crf_mean_field_bf16": (crf_fused, "BF16_LAUNCHES"),
            "seg_decode_tail_bf16": (crf_fused, "BF16_TAIL_LAUNCHES"),
            "flash_attention": (flash_attention, "LAUNCHES"),
            "flash_attention_bwd": (flash_attention, "BWD_LAUNCHES"),
            "bilateral_matvec": (crf_pallas, "LAUNCHES")}


def reset_counts() -> None:
    from simseg_tpu_torch.ops import flash_attention

    for module, attr in counters().values():
        setattr(module, attr, 0)
    for lane in flash_attention.LANE_CALLS:
        flash_attention.LANE_CALLS[lane] = 0


def read_counts() -> dict:
    """The launch counts, and the attention forward's by lane as
    ``lane_<name>``."""
    from simseg_tpu_torch.ops import flash_attention

    counts = {name: getattr(module, attr)
              for name, (module, attr) in counters().items()}
    counts.update({f"lane_{k}": v for k, v in flash_attention.LANE_CALLS.items()})
    return counts


def check_counts(label, counts, want):
    """Exactly the launches ``want`` ({count: n}), every other count 0."""
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"{label}: launches {counts}, want {want}")


def seg_vocab():
    """(tokenizer, classes) of the segmentation slices."""
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
    from simseg_tpu_torch.tasks.seg_eval import load_label_bank
    from simseg_tpu_torch.utils.prompts import IMAGENET_TEMPLATES

    classes = load_label_bank("pascal_voc")
    words = [w for t in IMAGENET_TEMPLATES for w in t.replace("{}", " ")
             .replace(".", " ").split()] + classes
    return WordPieceTokenizer(make_test_vocab(words)), classes


def slice_setup():
    """(model, tokenizer, classes) of the segmentation slices."""
    return (seeded_model(0), *seg_vocab())


def run_slice(model, tokenizer, classes):
    """Phase 4: returns the kernel's launches on the main path."""
    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.pooling import l2_normalize
    from simseg_tpu_torch.ops.morphology import nearest_upsample
    from simseg_tpu_torch.ops.seg_decode import coarse_unary, decode_tail, shortlist
    from simseg_tpu_torch.tasks.seg_eval import (
        evaluate_benchmark, make_seg_predict, zero_shot_classifier)

    loader = SyntheticLoader(3, BATCH, len(classes), seed=1)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iou, miou = evaluate_benchmark(
        loader, model, tokenizer, classes, top_cls_num=10,
        dataset_name="pascal_voc", input_size=SIZE, max_length=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["crf_mean_field"]
    print(f"slice: evaluate_benchmark on {3 * BATCH} images in {wall:.3f} s "
          f"(text bank included), mIoU {miou:.6f}, crf launches {launches}",
          flush=True)
    if launches < 1:
        raise AssertionError("the main path never launched the CRF kernel")
    if iou.shape != (len(classes),) or not 0.0 <= miou <= 1.0 or not np.all(
            np.isnan(iou) | ((iou >= 0) & (iou <= 1))):
        raise AssertionError(f"bad mIoU result {iou} {miou}")

    # one batch: the kernel decode against the plain decode, on the card
    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    images_u8 = torch.from_numpy(next(iter(loader))["image"]).cuda()
    predict = make_seg_predict(model, len(classes), 10, input_size=SIZE,
                               bilateral_stride=STRIDE)
    pred, best_w = predict(images_u8, text_bank)
    with torch.no_grad():
        patches = model.forward_image_tokens(normalize_images(images_u8))[:, 1:]
        pooled = model.forward_image_project(patches).float()
        dense = l2_normalize(model.project_image_tokens(patches).float())
        cand_idx, cand_scores, valid = shortlist(pooled, text_bank, 10, 5)
        du = nearest_upsample(coarse_unary(dense, text_bank, cand_idx,
                                           SIZE // PATCH), PATCH).contiguous()
        masks = crf_fused.mean_field_fused_plain(
            du, images_u8, stride=STRIDE, closing_ksize=CLOSING)
        pred_plain, _ = decode_tail(masks, cand_idx, cand_scores, valid)
    torch.cuda.synchronize()
    if pred.shape != (BATCH, SIZE, SIZE) or not torch.isfinite(best_w).all():
        raise AssertionError(f"bad decode output {tuple(pred.shape)}")
    if int(pred.min()) < 0 or int(pred.max()) >= len(classes):
        raise AssertionError("class ids out of range")
    agree = (pred == pred_plain).float().mean().item()
    print(f"slice: pred agreement kernel vs plain decode {agree:.6f}; "
          f"valid candidates {int(valid.sum())}/{valid.numel()}", flush=True)
    if agree < 0.999:
        raise AssertionError(f"pred agreement {agree:.6f} < 0.999")

    # steady-state time of the per-batch prediction (towers + decode)
    step_ms = cuda_ms(lambda: predict(images_u8, text_bank), 5)
    device_profile(lambda: predict(images_u8, text_bank),
                   f"towers + decode, batch {BATCH}", top=12)
    kernel_share(lambda: predict(images_u8, text_bank), "slice")
    print(f"slice: towers + decode {step_ms:.3f} ms per batch of {BATCH} "
          f"= {BATCH / (step_ms / 1e3):.1f} images/s", flush=True)
    return launches


def seeded_qkv(seed, b, t, n=3, heads=HEADS):
    """n (b, t, heads, 64) bf16 tensors on the card, the first (q)
    pre-scaled."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn(b, t, heads, HEAD_DIM, device="cuda", generator=gen)
          for _ in range(n)]
    xs[0] = xs[0] * HEAD_DIM ** -0.5
    return [x.to(torch.bfloat16) for x in xs]


def attention_bound_ms(b, t, ops_per_elem, nbytes, heads=HEADS):
    """Least time for attention work at (b, t, heads, 64): ops_per_elem x B
    H T^2 hd bf16 tensor-core operations over 989 TFLOP/s, or nbytes over
    HBM bandwidth."""
    t_ops = ops_per_elem * b * heads * t * t * HEAD_DIM / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def lane_functions(lane):
    """(kernel wrapper, its plain forward) of an attention lane."""
    from simseg_tpu_torch.ops import flash_attention as fa

    name = "flash_mha" if lane == "flash" else f"flash_mha_{lane}"
    return getattr(fa, name), getattr(fa, f"{name}_plain")


def long_lane(t, training):
    """The lane ``attention_lane`` gives the ViT-B heads at T = t; it must
    be a long-sequence lane."""
    from simseg_tpu_torch.ops.attention import attention_lane

    lane = attention_lane(BATCH, HEADS, t, t, HEAD_DIM, torch.bfloat16, None,
                          training)
    if lane not in ("rowblock", "stream"):
        raise AssertionError(f"T={t} routes to {lane!r}, not a long lane")
    return lane


def attention_errors(out, want):
    """(max abs error, (max abs error / max |want|, mean abs error /
    mean |want|, |1 - <out, want> / <want, want>|)) of an attention output
    or gradient against its plain version; the last, a scale error, is what
    a systematic fault (a softmax sum off by a few keys, a gradient missing
    a few query rows) leaves when rounding noise hides it from the first
    two."""
    err = (out.float() - want.float()).abs()
    ref = want.float().abs()
    max_err = err.max().item()
    rel = (max_err / ref.max().item(), err.mean().item() / ref.mean().item())
    del err, ref
    o, w = out.double(), want.double()
    scale = abs(1 - (o * w).sum().item() / (w * w).sum().item())
    return max_err, (*rel, scale)


def within_fwd_bars(rel):
    return (rel[0] <= FWD_MAX_REL and rel[1] <= FWD_MEAN_REL
            and rel[2] <= FWD_SCALE)


def within_bwd_bars(rel):
    return (rel[0] <= BWD_MAX_REL and rel[1] <= BWD_MEAN_REL
            and rel[2] <= BWD_SCALE)


def check_flash_kernel(t, lane="flash", profile=False, b=BATCH, heads=HEADS):
    """Phases 3b / 3e at (16, t, 12, 64) (14: (8, 1297, 6, 64)): returns the
    JSON fields (no launches). The plain version of a long lane runs in slices of 2
    images: its f32 scores at (16, 5185) would take 20.6 GB. With
    ``profile``, the kernel's device time over five calls."""
    import torch.nn.functional as F

    kernel, plain = lane_functions(lane)
    label = "attention" if lane == "flash" else f"attention {lane}"
    if heads != HEADS:
        label += f" H={heads}"
    q, k, v = seeded_qkv(t, b, t, heads=heads)
    step = b if lane == "flash" else PLAIN_SLICE

    def plain_all():
        return [plain(q[i:i + step], k[i:i + step], v[i:i + step])
                for i in range(0, b, step)]

    want = torch.cat(plain_all())
    got = kernel(q, k, v)
    max_err, rel = attention_errors(got, want)
    print(f"{label} T={t}: kernel vs plain max abs err {max_err:.3e}; "
          f"relative max {rel[0]:.3e}, mean {rel[1]:.3e}, scale {rel[2]:.3e} "
          f"(bars {FWD_MAX_REL:g}, {FWD_MEAN_REL:g}, {FWD_SCALE:g})",
          flush=True)
    if not within_fwd_bars(rel):
        raise AssertionError(f"{label} T={t}: relative error {rel}")
    if not torch.equal(got, kernel(q, k, v)):
        raise AssertionError(f"{label} T={t}: two calls differ")
    print(f"{label} T={t}: a second call gives a bit-equal output", flush=True)
    del got
    # planted faults the bars must reject: a kernel that skips the last k/v
    # tile, and one that leaves the zero-filled keys of a partial tile
    # unmasked (scores 0, values 0)
    cut = (t - 1) // FWD_TILE * FWD_TILE
    faults = {"last k/v tile dropped": (k[:, :cut], v[:, :cut])}
    if t % FWD_TILE:
        pad = (0, 0, 0, 0, 0, FWD_TILE - t % FWD_TILE)
        faults["partial tile unmasked"] = (F.pad(k, pad), F.pad(v, pad))
    for fault, (fk, fv) in faults.items():
        _, f_rel = attention_errors(kernel(q, fk, fv), want)
        print(f"{label} T={t}: planted fault ({fault}): relative max "
              f"{f_rel[0]:.3e}, mean {f_rel[1]:.3e}, scale {f_rel[2]:.3e}",
              flush=True)
        if within_fwd_bars(f_rel):
            raise AssertionError(f"{label} T={t}: the bars pass a kernel "
                                 f"with the fault '{fault}': {f_rel}")
    del want, faults
    if profile:  # five calls: the profiler may miss a window's first kernel
        device_profile(lambda: [kernel(q, k, v) for _ in range(5)],
                       f"{label} B={b} T={t}, over 5 calls", top=3)
    ms = cuda_ms(lambda: kernel(q, k, v), 20)
    plain_ms = cuda_ms(plain_all, 5 if lane == "flash" else 2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=1.0), 20)
    # the work: 4 B H T^2 hd tensor-core operations; q, k, v, o once each
    bound, bound_by = attention_bound_ms(
        b, t, 4, 4 * b * t * heads * HEAD_DIM * 2, heads)
    print(f"{label} T={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          f"{'' if step == b else f' ({b // step} calls of {step} images)'}"
          f", sdpa {sdpa_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
          f"kernel / sdpa {ms / sdpa_ms:.3f}, share of bound {bound / ms:.3f}",
          flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=sdpa_ms)


def check_flash_bwd_kernel(t, b=BATCH, lane="train", profile=False,
                           heads=HEADS):
    """Phases 3d / 3f at (b, t, 12, 64) (14: (8, 1297, 6, 64)): returns the
    backward kernel's JSON
    fields (no launches). q, k, v and the output and log-sum-exp of the
    forward kernel, random g; the whole-T lane's plain backward recomputes
    everything from q, k, v, g, a long lane's runs on its plain forward's
    output and log-sum-exp. Per gradient the backward bars; a second call
    must give bit-equal gradients (no atomics); a planted fault must fail
    the bars: the kernel run without the last (partial) q tile of the
    dk/dv pass, on q, o, g and lse cut to whole tiles but one, its dk and
    dv held against the full plain result. With ``profile``, the device
    time of each pass over five calls."""
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import flash_attention as fa

    q, k, v, g = seeded_qkv(t + b, b, t, n=4, heads=heads)
    out, lse = fa._launch(q, k, v, with_lse=True, lane=lane)
    got = fa.flash_mha_train_bwd(q, k, v, out, g, lse)
    if lane == "train":
        def plain():
            return fa.flash_mha_train_bwd_plain(q, k, v, g)
    else:
        p_out, p_lse = lane_functions(lane)[1](q, k, v, with_lse=True)

        def plain():
            return fa.flash_mha_long_bwd_plain(q, k, v, p_out, g, p_lse)
    label = "attention bwd" if lane == "train" else f"attention {lane} bwd"
    if heads != HEADS:
        label += f" H={heads}"
    bars = f"(bars {BWD_MAX_REL:g}, {BWD_MEAN_REL:g}, {BWD_SCALE:g})"
    want = plain()
    max_err = 0.0
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        e_max, rel = attention_errors(x, y)
        print(f"{label} B={b} T={t} {name}: max abs err {e_max:.3e}; "
              f"relative max {rel[0]:.3e}, mean {rel[1]:.3e}, scale "
              f"{rel[2]:.3e} {bars}", flush=True)
        if not within_bwd_bars(rel):
            raise AssertionError(f"{label} B={b} T={t} {name}: relative "
                                 f"error {rel}")
        max_err = max(max_err, e_max)
    again = fa.flash_mha_train_bwd(q, k, v, out, g, lse)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{label} B={b} T={t}: two calls differ")
    print(f"{label} B={b} T={t}: a second call gives bit-equal dq, dk, dv",
          flush=True)
    cut = (t - 1) // BWD_TILE * BWD_TILE
    _, f_dk, f_dv = fa.flash_mha_train_bwd(q[:, :cut], k, v, out[:, :cut],
                                           g[:, :cut], lse[..., :cut])
    for name, x, y in (("dk", f_dk, want[1]), ("dv", f_dv, want[2])):
        _, f_rel = attention_errors(x, y)
        print(f"{label} B={b} T={t}: planted fault (last q tile dropped, "
              f"{t - cut} of {t} rows) {name}: relative max {f_rel[0]:.3e}, "
              f"mean {f_rel[1]:.3e}, scale {f_rel[2]:.3e}", flush=True)
        if within_bwd_bars(f_rel):
            raise AssertionError(f"{label} B={b} T={t}: the bars pass a "
                                 f"kernel without its last q tile: {f_rel}")
    del want, again, f_dk, f_dv

    def kernel():
        return fa.flash_mha_train_bwd(q, k, v, out, g, lse)

    if profile:  # five calls: the profiler may miss a window's first kernel
        device_profile(lambda: [kernel() for _ in range(5)],
                       f"{label} B={b} T={t}, by pass over 5 calls", top=3)
    ms = cuda_ms(kernel, 20)
    fwd_lse_ms = cuda_ms(lambda: fa._launch(q, k, v, with_lse=True), 20)
    fwd_ms = cuda_ms(lambda: fa._launch(q, k, v), 20)
    plain_ms = cuda_ms(plain, 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)

    sdpa_f = cuda_ms(sdpa_fwd, 20)
    sdpa_fb = cuda_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt), 20)
    # the work: 10 B H T^2 hd tensor-core operations (dv, dp, dq, dk and the
    # recomputed s); q, k, v, o, g and lse read once, dq, dk, dv written once
    bound, bound_by = attention_bound_ms(
        b, t, 10, 8 * b * t * heads * HEAD_DIM * 2 + b * heads * t * 4, heads)
    print(f"{label} B={b} T={t}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, "
          f"sdpa bwd {sdpa_fb - sdpa_f:.4f} ms (fwd+bwd {sdpa_fb:.4f}, fwd "
          f"{sdpa_f:.4f}), kernel / sdpa bwd {ms / (sdpa_fb - sdpa_f):.3f}, "
          f"bound {bound:.4f} ms ({bound_by}); forward kernel "
          f"with lse {fwd_lse_ms:.4f} ms, without {fwd_ms:.4f} ms, with lse / "
          f"sdpa fwd {fwd_lse_ms / sdpa_f:.3f}, share of the forward's bound "
          f"{attention_bound_ms(b, t, 4, 0, heads)[0] / fwd_lse_ms:.3f}",
          flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=sdpa_fb - sdpa_f)


def bilateral_bound_ms(b, n, used, c):
    """Least time for out = K q over b images of n cells: per pair the
    used-feature dot (2F), |f_i|^2 + |f_j|^2 - 2 dot (3), clamp, scale and
    exp (3), C multiply-adds (2C) on the CUDA cores; features and q read
    once, out written once."""
    t_ops = b * n * n * (2 * used + 6 + 2 * c) / F32_FLOP_PER_S * 1e3
    t_bytes = b * n * (used + 2 * c) * 4 / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bilateral_inputs():
    """Phase 3c's inputs: the (16, 5184, 5) features of 576-px synthetic
    scenes at stride 8 (colours over srgb = 13, positions over sxy = 40),
    the ones column (the degree), q at C = 5 uniform in [-1, 1] and the same
    values as the transposed view the CRF's stream lane passes
    (``ops/crf.py``: a (B, C, N) tensor viewed as (B, N, C))."""
    from simseg_tpu_torch.ops.crf import bilateral_features, cell_colours

    rng = np.random.default_rng(7)
    rgb = torch.from_numpy(synthetic_scenes(rng, BATCH, WIN_INPUT, 21)[0]).cuda()
    feat = bilateral_features(cell_colours(rgb, STRIDE), 40.0, 13.0, STRIDE)
    n = feat.shape[1]
    ones = torch.ones((BATCH, n, 1), dtype=torch.float32, device="cuda")
    q5 = torch.from_numpy(rng.uniform(-1.0, 1.0, (BATCH, n, 5)).astype(
        np.float32)).cuda()
    return feat, ones, q5, q5.transpose(1, 2).contiguous().transpose(1, 2)


def bilateral_rel(got, want):
    """max |got - want| / max |want| (want the float64 plain result)."""
    return ((got.double() - want).abs().max() / want.abs().max()).item()


BILATERAL_BAR = 1e-5


def check_bilateral_kernel():
    """Phase 3c: returns the JSON fields at C = 5 (the per-iteration call,
    q the stream lane's transposed view), with C = 1 (the degree) and one
    image through the unbatched wrapper beside it."""
    from simseg_tpu_torch.ops import crf_pallas

    feat, ones, q5, q5t = bilateral_inputs()
    n, used = feat.shape[1], feat.shape[2]
    fields = {}
    for c, q in ((1, ones), (5, q5t)):
        got = crf_pallas.bilateral_matvec_batched(feat, q)
        again = crf_pallas.bilateral_matvec_batched(feat, q)
        want = crf_pallas.bilateral_matvec_plain(feat.double(), q.double())
        max_err = (got.double() - want).abs().max().item()
        rel = bilateral_rel(got, want)
        rel32 = bilateral_rel(crf_pallas.bilateral_matvec_plain(feat, q), want)
        same = torch.equal(got, again)
        print(f"bilateral C={c} N={n}: kernel vs float64 plain max abs err "
              f"{max_err:.3e}, relative {rel:.3e} (float32 plain {rel32:.3e}); "
              f"two calls bit-equal {same}", flush=True)
        if rel > BILATERAL_BAR:
            raise AssertionError(f"bilateral C={c}: relative error {rel}")
        if not same:
            raise AssertionError(f"bilateral C={c}: two calls differ")
        if c == 5:
            if not torch.equal(got, crf_pallas.bilateral_matvec_batched(feat, q5)):
                raise AssertionError("bilateral: q as a view != q contiguous")
            # planted faults, each must exceed the bar: the plan's last
            # column chunk dropped (q zero there), one feature dropped, the
            # float32 expanded distance (the plain version's)
            plan = crf_pallas.launch_plan(BATCH, n, used, c)
            q_cut = q.clone()
            q_cut[:, (plan.chunks - 1) * plan.chunk_cells:] = 0.0
            faults = {
                "last column chunk dropped": crf_pallas.bilateral_matvec_batched(
                    feat, q_cut),
                "one feature dropped": crf_pallas.bilateral_matvec_batched(
                    feat[..., :used - 1], q),
                "float32 expanded distance": crf_pallas.bilateral_matvec_plain(
                    feat, q)}
            for name, bad in faults.items():
                rel_bad = bilateral_rel(bad, want)
                print(f"bilateral C={c}: planted fault '{name}': relative "
                      f"{rel_bad:.3e}", flush=True)
                if rel_bad <= BILATERAL_BAR:
                    raise AssertionError(f"bilateral: the bar passes the planted "
                                         f"fault '{name}' ({rel_bad:.3e})")
            got5 = got

        def kernel():
            return crf_pallas.bilateral_matvec_batched(feat, q)

        ms = cuda_ms(kernel, 20)
        device, kernels, _ = device_rows(kernel)
        plain_ms = cuda_ms(lambda: crf_pallas.bilateral_matvec_plain(feat, q), 3)
        bound, bound_by = bilateral_bound_ms(BATCH, n, used, c)
        print(f"bilateral C={c}: kernel {ms:.4f} ms (device {device:.4f} ms, "
              f"{kernels} CUDA kernels per call), plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by}), share of bound {bound / ms:.3f}",
              flush=True)
        fields[c] = dict(max_abs_err=max_err, ms=ms, device_ms=device,
                         kernels_per_call=kernels, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by,
                         share_of_bound=bound / ms)

    # the unbatched entry point (TPU row 3) on one image: the same kernel,
    # the same sums as the batched call's image 0
    one = crf_pallas.bilateral_matvec(feat[0], q5t[0])
    if not torch.equal(one, got5[0]):
        raise AssertionError("bilateral_matvec != bilateral_matvec_batched[0]")

    def kernel_one():
        return crf_pallas.bilateral_matvec(feat[0], q5t[0])

    ms = cuda_ms(kernel_one, 20)
    device, kernels, _ = device_rows(kernel_one)
    plain_ms = cuda_ms(lambda: crf_pallas.bilateral_matvec_plain(
        feat[:1], q5t[:1]), 3)
    bound, bound_by = bilateral_bound_ms(1, n, used, 5)
    print(f"bilateral one image C=5: kernel {ms:.4f} ms (device {device:.4f} ms, "
          f"{kernels} CUDA kernels per call), plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({bound_by}), share of bound {bound / ms:.3f}",
          flush=True)
    return dict(library_ms=None, **fields[5], c1_ms=fields[1]["ms"],
                c1_device_ms=fields[1]["device_ms"],
                c1_bound_ms=fields[1]["bound_ms"], one_image_ms=ms,
                one_image_device_ms=device, one_image_kernels_per_call=kernels,
                one_image_plain_ms=plain_ms, one_image_bound_ms=bound)


def plain_decode(dense, pooled, text_bank, images_u8, size):
    """The decode with every kernel replaced by its plain version: the
    materialised-K mean field and the closing in plain PyTorch."""
    from simseg_tpu_torch.ops.crf import dense_crf_batched_du
    from simseg_tpu_torch.ops.morphology import closing, nearest_upsample
    from simseg_tpu_torch.ops.seg_decode import coarse_unary, decode_tail, shortlist

    with torch.no_grad():
        cand_idx, cand_scores, valid = shortlist(pooled, text_bank, 10, 5)
        du = nearest_upsample(coarse_unary(dense, text_bank, cand_idx,
                                           size // PATCH), PATCH).contiguous()
        masks = closing(dense_crf_batched_du(
            du, images_u8, bilateral_stride=STRIDE,
            bilateral_impl="dense").float(), CLOSING)
        return decode_tail(masks, cand_idx, cand_scores, valid)[0]


def drive_eval(label, loader, model, tokenizer, classes, **kw):
    """``evaluate_benchmark`` with the counts set to 0 just before it and
    read just after; returns the counts."""
    from simseg_tpu_torch.tasks.seg_eval import evaluate_benchmark

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iou, miou = evaluate_benchmark(
        loader, model, tokenizer, classes, top_cls_num=10,
        dataset_name="pascal_voc", max_length=25, bilateral_stride=STRIDE, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"{label}: evaluate_benchmark on {loader.batches * loader.batch_size} "
          f"images in {wall:.3f} s (text bank included), mIoU {miou:.6f}, launches "
          f"{counts}", flush=True)
    if iou.shape != (len(classes),) or not 0.0 <= miou <= 1.0 or not np.all(
            np.isnan(iou) | ((iou >= 0) & (iou <= 1))):
        raise AssertionError(f"{label}: bad mIoU result {iou} {miou}")
    return counts


def check_decode(label, loader, model, text_bank, classes, size,
                 crf_backend="auto", **kw):
    """One batch: the decode's predictions against the plain decode on the
    same features; then images/s, a device profile of the prediction and
    the idle share."""
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
    from simseg_tpu_torch.tasks.seg_eval import make_seg_features, make_seg_predict

    images_u8 = torch.from_numpy(next(iter(loader))["image"]).cuda()
    dense, pooled = make_seg_features(model, input_size=size, **kw)(images_u8)
    decode = make_seg_decode_fn(num_classes=len(classes), image_size=size,
                                patch_size=PATCH, top_cls_num=10,
                                bilateral_stride=STRIDE, crf_backend=crf_backend)
    with torch.no_grad():
        pred, best_w = decode(dense, pooled, text_bank, images_u8)
    pred_plain = plain_decode(dense, pooled, text_bank, images_u8, size)
    torch.cuda.synchronize()
    if pred.shape != (BATCH, size, size) or not torch.isfinite(best_w).all():
        raise AssertionError(f"{label}: bad decode output {tuple(pred.shape)}")
    if int(pred.min()) < 0 or int(pred.max()) >= len(classes):
        raise AssertionError(f"{label}: class ids out of range")
    agree = (pred == pred_plain).float().mean().item()
    print(f"{label}: pred agreement kernel vs plain decode {agree:.6f}",
          flush=True)
    if agree < 0.999:
        raise AssertionError(f"{label}: pred agreement {agree:.6f} < 0.999")

    predict = make_seg_predict(model, len(classes), 10, input_size=size,
                               bilateral_stride=STRIDE, crf_backend=crf_backend,
                               **kw)
    step_ms = cuda_ms(lambda: predict(images_u8, text_bank), 3)
    device = device_profile(lambda: predict(images_u8, text_bank),
                            f"{label} towers + decode, batch {BATCH}", top=12)
    kernel_share(lambda: predict(images_u8, text_bank), label)
    print(f"{label}: towers + decode {step_ms:.3f} ms per batch of {BATCH} "
          f"= {BATCH / (step_ms / 1e3):.1f} images/s; device {device:.3f} ms, "
          f"idle share {1 - device / step_ms:.3f}", flush=True)


def run_multiscale_slice(label, model, tokenizer, classes, scales, seed,
                         want_lanes, n_images):
    """Phases 4b / 4d: ``evaluate_benchmark`` with ``scales``; the CRF
    kernel must run once per batch and the attention forward exactly
    ``want_lanes`` ({lane: launches}, every other lane 0). Then, on
    n_images of one batch, each extra view's tower with kernel attention
    (one launch per layer) against plain attention (per-token cosine >=
    0.999), and the decode against the plain decode. Returns the launch
    counts of the evaluate_benchmark run."""
    import torch.nn.functional as F

    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.ops import flash_attention
    from simseg_tpu_torch.ops.interpolate_pe import resize_bilinear
    from simseg_tpu_torch.tasks.seg_eval import zero_shot_classifier

    loader = SyntheticLoader(3, BATCH, len(classes), seed=seed)
    counts = drive_eval(label, loader, model, tokenizer, classes,
                        input_size=SIZE, scales=scales)
    lanes = {k[5:]: v for k, v in counts.items() if k.startswith("lane_")}
    if (lanes != {lane: want_lanes.get(lane, 0) for lane in lanes}
            or counts["crf_mean_field"] != loader.batches):
        raise AssertionError(f"{label}: attention lanes {lanes}, want "
                             f"{want_lanes}, and one CRF launch per batch: "
                             f"{counts}")

    def dense_tokens(view):
        with torch.no_grad():
            patches = model.forward_image_tokens(view)[:, 1:]
            return model.project_image_tokens(patches).float()

    images = normalize_images(torch.from_numpy(
        next(iter(loader))["image"][:n_images]).cuda())
    plain_gates = [unittest.mock.patch.object(flash_attention, gate,
                                              lambda *a: False)
                   for gate in ("flash_supported", "flash_rowblock_supported",
                                "flash_stream_supported")]
    for scale in scales:
        if scale == 1.0:
            continue
        size = int(round(SIZE * scale / PATCH)) * PATCH
        view = resize_bilinear(images, size, size)
        before = flash_attention.LAUNCHES
        dense_k = dense_tokens(view)
        if flash_attention.LAUNCHES - before != 12:
            raise AssertionError(f"the {size}-px tower did not take a kernel "
                                 "in each of its 12 layers")
        with contextlib.ExitStack() as stack:
            for gate in plain_gates:
                stack.enter_context(gate)
            dense_p = dense_tokens(view)
        cos = F.cosine_similarity(dense_k, dense_p, dim=-1).min().item()
        print(f"{label}: {size}-px tower (T = {dense_k.shape[1] + 1}) kernel "
              f"vs plain attention, min per-token cosine {cos:.6f} over "
              f"{n_images} images", flush=True)
        if cos < 0.999:
            raise AssertionError(f"{size}-px per-token cosine {cos:.6f} < 0.999")
        del dense_k, dense_p, view
    torch.cuda.empty_cache()

    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    check_decode(label, loader, model, text_bank, classes, SIZE, scales=scales)
    return counts


def run_window_slice(model, tokenizer, classes):
    """Phase 4c: returns the launch counts of its evaluate_benchmark run."""
    from simseg_tpu_torch.tasks.seg_eval import zero_shot_classifier

    batches = 3
    win = dict(window_size=WIN, window_stride=WIN_STRIDE)
    loader = SyntheticLoader(batches, BATCH, len(classes), seed=3,
                             size=WIN_INPUT, gt=GT)
    counts = drive_eval("window", loader, model, tokenizer, classes,
                        input_size=WIN_INPUT, **win)
    if counts["bilateral_matvec"] != 4 * batches or counts["crf_mean_field"]:
        raise AssertionError("the window slice must launch the bilateral "
                             f"kernel 4 times per batch and no fused CRF: "
                             f"{counts}")
    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    check_decode("window", loader, model, text_bank, classes, WIN_INPUT, **win)
    return counts


def check_checkpoint():
    """Phase 5: a 224-px file loaded into the 288-px model."""
    from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint
    from simseg_tpu_torch.ops.interpolate_pe import interpolate_pos_embed

    src = seeded_clip(4, img_size=224)
    state = {f"module.{k}": v for k, v in src.state_dict().items()}
    dst = seeded_clip(5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vit_b16_224.pth")
        torch.save({"state_dict": state, "meta": {}}, path)
        report = load_clip_checkpoint(path, dst, strict=True)
    buckets = {k: len(v) for k, v in report.items()}
    print(f"checkpoint: 224-px file into the 288-px model: {buckets}",
          flush=True)
    if buckets != {"matched": len(state), "mismatched": 0, "missing": 0,
                   "unexpected": 0}:
        raise AssertionError(f"checkpoint buckets {report}")
    name = "image_encoder.model.model.pos_embed"
    saved = src.state_dict()[name]
    if saved.shape[1] != 197 or not torch.equal(
            dst.state_dict()[name], interpolate_pos_embed(saved, 18 * 18)):
        raise AssertionError("pos_embed is not the resampled one")


def train_cfg(ckpt_dir, *extra):
    """The training slice's config: the default bank, ``TRAIN_OVERRIDES``,
    then ``extra``; no YAML is read."""
    from simseg_tpu_torch.config import new_base_cfg, update_cfg
    from simseg_tpu_torch.tasks.clip.config import (task_cfg_init_fn,
                                                    update_clip_config)

    return update_cfg(task_cfg_init_fn, None,
                      list(TRAIN_OVERRIDES) + [f"ckpt.dir={ckpt_dir}",
                                               "log.interval_train=4", *extra],
                      preprocess_fn=update_clip_config, target=new_base_cfg())


def caption_batch(seed, b, size):
    """(batch, tokenizer): b synthetic scenes of ``size`` px as uint8 with
    one caption each, naming the classes of their discs."""
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
    from simseg_tpu_torch.tasks.seg_eval import load_label_bank

    classes = load_label_bank("pascal_voc")
    images, labels = synthetic_scenes(np.random.default_rng(seed), b, size,
                                      len(classes))
    captions = []
    for lab in labels:
        names = [classes[c] for c in np.unique(lab) if c > 0]
        captions.append("a photo of " + " and ".join(names or ["nothing"]))
    tok = WordPieceTokenizer(make_test_vocab(
        ["a", "photo", "of", "and", "nothing"] + classes))
    return {"image": images, "caption": captions}, tok


class StepTimer:
    """Wraps ``CLIPRunner.batch_processor``: keeps each step's loss (on the
    device) and CUDA events at the start and end of each step."""

    def __init__(self):
        self.losses, self.events = [], []

    def patch(self):
        from simseg_tpu_torch.core.runner import CLIPRunner

        inner = CLIPRunner.batch_processor

        def wrapped(runner, batch, device_batch=None):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(runner, batch, device_batch)
            end.record()
            self.events.append((start, end))
            self.losses.append(out["loss"])
            return out

        return unittest.mock.patch.object(CLIPRunner, "batch_processor", wrapped)

    def ms_per_step(self, warmup=2):
        """(whole, inside): mean ms per step from the start of step
        ``warmup + 1`` to the end of the last, the hooks, the loader and
        every host stall between steps included; and the mean of the same
        steps' own times, inside ``batch_processor`` only."""
        torch.cuda.synchronize()
        timed = self.events[warmup:]
        whole = timed[0][0].elapsed_time(timed[-1][1]) / len(timed)
        inside = sum(a.elapsed_time(b) for a, b in timed) / len(timed)
        return whole, inside


def step_grads(model, batch):
    """(loss, {name: grad}) of one forward/backward of the train loss."""
    from simseg_tpu_torch.engine.train_step import clip_loss_fn

    model.zero_grad(set_to_none=True)
    loss, _ = clip_loss_fn(model, batch)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def compare_train_step(runner, batch, n=COMPARE_BATCH, patch=None,
                       label="flash_train_supported=False"):
    """One step's loss and image-tower gradients at batch n with the
    backward kernel against ``patch`` (default: ``flash_train_supported``
    patched to False, the forward kernel with the plain backward); peak
    memory."""
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import flash_attention

    if patch is None:
        patch = unittest.mock.patch.object(
            flash_attention, "flash_train_supported", lambda *a: False)
    small = {k: v[:n] for k, v in runner._prepare_batch(batch).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = step_grads(runner.model, small)
    peak_k = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with patch:
        loss_p, grads_p = step_grads(runner.model, small)
    peak_p = torch.cuda.max_memory_allocated()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    image = [n for n in grads_k if n.startswith("image_encoder.")]
    cos = {n: F.cosine_similarity(grads_k[n].flatten(), grads_p[n].flatten(),
                                  dim=0).item() for n in image}
    worst = min(cos, key=cos.get)
    print(f"train: batch {n} step, backward kernel vs {label}: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} "
          f"(relative {rel:.3e}); min gradient cosine {cos[worst]:.6f} "
          f"({worst}) over {len(image)} image-tower tensors; peak memory "
          f"{peak_k / 2**30:.3f} GiB vs {peak_p / 2**30:.3f} GiB", flush=True)
    if rel > 1e-2 or cos[worst] < 0.99:
        raise AssertionError(f"train step kernel vs plain: loss {rel}, "
                             f"cosine {cos[worst]} ({worst})")


def witness_train_step(runner, batch, n):
    """Phase 6b's witness: one step at batch n with the image tower's
    attention in float32 (plain; q, k, v cast up, the output cast back),
    against which the row-block kernel lane and the plain bf16 lane
    (``flash_rowblock_supported`` patched to False) each give their loss,
    ``pos_embed`` gradient cosine and least image-tower gradient cosine.
    The kernel lane's loss must be within 1e-2, and each image-tower
    gradient's cosine >= 0.99 or no more than 0.01 below the plain bf16
    lane's (``pos_embed``'s gradient, a sum over every token of every
    image, is far from the witness under either bf16 lane)."""
    import torch.nn.functional as F

    from simseg_tpu_torch.models import vit
    from simseg_tpu_torch.ops import attention
    from simseg_tpu_torch.ops import flash_attention as fa

    def f32_attention(q, k, v, num_heads, attention_bias=None):
        return attention.multi_head_attention(
            q.float(), k.float(), v.float(), num_heads,
            attention_bias).to(q.dtype)

    small = {k: v[:n] for k, v in runner._prepare_batch(batch).items()}
    with unittest.mock.patch.object(vit, "multi_head_attention", f32_attention):
        loss_w, grads_w = step_grads(runner.model, small)
    image = [k for k in grads_w if k.startswith("image_encoder.")]
    pos = next(k for k in image if k.endswith("pos_embed"))
    lanes = {"plain bf16": unittest.mock.patch.object(
                 fa, "flash_rowblock_supported", lambda *a: False),
             "row-block kernel": contextlib.nullcontext()}
    cos, rel = {}, {}
    for name, ctx in lanes.items():
        with ctx:
            loss, grads = step_grads(runner.model, small)
        rel[name] = abs(loss - loss_w) / abs(loss_w)
        cos[name] = {k: F.cosine_similarity(
            grads[k].flatten(), grads_w[k].flatten(), dim=0).item()
            for k in image}
        worst = min((k for k in image if k != pos), key=cos[name].get)
        print(f"train: batch {n} step, {name} lane vs float32 attention: "
              f"loss {loss:.6f} vs {loss_w:.6f} (relative {rel[name]:.3e}); "
              f"pos_embed gradient cosine {cos[name][pos]:.6f}, norm ratio "
              f"{grads[pos].norm() / grads_w[pos].norm():.4f}; min cosine "
              f"of the others {cos[name][worst]:.6f} ({worst})", flush=True)
    below = {k: c for k, c in cos["row-block kernel"].items()
             if c < min(0.99, cos["plain bf16"][k] - 0.01)}
    if rel["row-block kernel"] > 1e-2 or below:
        raise AssertionError(f"train step kernel vs float32 attention: loss "
                             f"{rel}, cosines below the bar {below}")


def run_train_slice(tmp):
    """Phases 6 and 6b: returns the launch counts of the 576-px and the
    640-px training runs."""
    from simseg_tpu_torch.checkpoint.native import has_checkpoint
    from simseg_tpu_torch.tasks.clip.train import train

    cfg = train_cfg(os.path.join(tmp, "ckpt"), *TRAIN_SLICE)
    batch, tok = caption_batch(6, TRAIN_BATCH, TRAIN_SIZE)
    loader = [batch] * TRAIN_STEPS
    timer = StepTimer()
    with timer.patch():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner = train(cfg, {"train": [loader]}, tokenizer=tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    losses = [x.item() for x in timer.losses]
    print(f"train: {len(losses)} steps of {TRAIN_BATCH} at {TRAIN_SIZE} px in "
          f"{wall:.3f} s (model build included); losses "
          f"{[round(x, 5) for x in losses]}; launches {counts}", flush=True)
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: {losses}")
    per_step = 12 * TRAIN_STEPS   # the ViT's 12 layers; BERT's T = 25 is plain
    if (counts["flash_attention"] != per_step
            or counts["flash_attention_bwd"] != per_step
            or counts["crf_mean_field"] or counts["bilateral_matvec"]):
        raise AssertionError(f"training launches {counts}, want {per_step} "
                             "forward and backward attention and no CRF")
    if not has_checkpoint(cfg.ckpt.dir):
        raise AssertionError("the training run wrote no checkpoint")

    ms, inside = timer.ms_per_step()
    print(f"train: {ms:.3f} ms per step of {TRAIN_BATCH} at {TRAIN_SIZE} px "
          f"(CUDA events from step 3 to the end of step {TRAIN_STEPS}; "
          f"{inside:.3f} ms inside batch_processor) = "
          f"{TRAIN_BATCH / (ms / 1e3):.1f} images/s", flush=True)

    # a second train() resumes from the checkpoint: step 12, same state
    resumed = train(cfg, {"train": [loader]}, tokenizer=tok)
    same_params = all(torch.equal(a, b) for a, b in zip(
        runner.model.state_dict().values(), resumed.model.state_dict().values()))
    opt_a = runner.optimizer.base.state_dict()["state"]
    opt_b = resumed.optimizer.base.state_dict()["state"]
    same_opt = opt_a.keys() == opt_b.keys() and all(
        torch.equal(opt_a[i][k].cpu(), opt_b[i][k].cpu())
        for i in opt_a for k in opt_a[i])
    print(f"train: resumed at epoch {resumed.epoch}, step {resumed.step}; "
          f"parameters equal {same_params}, optimizer state equal {same_opt}",
          flush=True)
    if resumed.step != TRAIN_STEPS or not (same_params and same_opt):
        raise AssertionError("resume did not restore the trained state")
    del resumed

    compare_train_step(runner, batch)
    device_ms = device_profile(lambda: runner.batch_processor(batch),
                               f"train step, batch {TRAIN_BATCH} at "
                               f"{TRAIN_SIZE} px", top=14)
    print(f"train: device {device_ms:.3f} ms of {ms:.3f} ms per step, idle "
          f"share {1 - device_ms / ms:.3f}", flush=True)
    del runner
    torch.cuda.empty_cache()

    for b in BATCHES_224:   # the YAML's own crop: no attention kernel
        run_train_crop(tmp, tok, 7, 224, b, {}, input_size=288)
    per_step = 12 * TRAIN_STEPS
    row_counts = run_train_crop(
        tmp, tok, 10, ROW_TRAIN_SIZE, ROW_TRAIN_BATCH,
        {"flash_attention": per_step, "flash_attention_bwd": per_step,
         "lane_rowblock": per_step}, compare=True)
    return counts, row_counts


def run_train_crop(tmp, tok, seed, size, b, want, input_size=None,
                   compare=False):
    """Phases 6 (224 px) / 6b: 12 steps at a ``size``-px crop (the model at
    ``input_size``, by default the crop), batch b, on one repeated batch:
    finite losses, the last below the first, exactly the launches ``want``
    ({count: n}, every other count 0); with ``compare``, one step at batch
    4 against the same forward kernel with ``flash_mha_long_bwd_plain`` as
    the backward; images/s, idle share and a device profile. Returns the
    launch counts."""
    from simseg_tpu_torch.ops import flash_attention as fa
    from simseg_tpu_torch.tasks.clip.train import train

    steps = TRAIN_STEPS
    label = f"train {size} px batch {b}"
    cfg = train_cfg(os.path.join(tmp, f"ckpt{size}_{b}"),
                    f"transforms.random_resize_crop.size={size}",
                    f"transforms.input_size={input_size or size}",
                    f"data.batch_size={b}", f"data.train_steps={steps}",
                    "epoch=1")
    batch, _ = caption_batch(seed, b, size)
    timer = StepTimer()
    with timer.patch():
        reset_counts()
        runner = train(cfg, {"train": [[batch] * steps]}, tokenizer=tok)
        counts = read_counts()
    losses = [x.item() for x in timer.losses]
    ms, inside = timer.ms_per_step()
    print(f"{label}: losses {[round(x, 5) for x in losses]}; "
          f"{ms:.3f} ms per step (steps 3-{steps}; {inside:.3f} ms inside "
          f"batch_processor) = {b / (ms / 1e3):.1f} images/s; launches "
          f"{counts}", flush=True)
    check_counts(label, counts, want)
    if (len(losses) != steps or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses}")
    if compare:
        # the same forward kernel; the backward kernel against its plain
        # version
        compare_train_step(runner, batch, ROW_COMPARE_BATCH,
                           unittest.mock.patch.object(
                               fa, "flash_mha_train_bwd",
                               fa.flash_mha_long_bwd_plain),
                           "flash_mha_long_bwd_plain")
        witness_train_step(runner, batch, ROW_COMPARE_BATCH)
    device = device_profile(lambda: runner.batch_processor(batch),
                            f"train step, batch {b} at {size} px", top=10)
    print(f"{label}: device {device:.3f} ms of {ms:.3f} ms per step, idle "
          f"share {1 - device / ms:.3f}", flush=True)
    del runner
    torch.cuda.empty_cache()
    return counts


def tail_inputs():
    """Phase 3g's inputs: patch-grid unaries, scenes, scores with an invalid
    candidate, a negative score and a tie, and class ids."""
    b, k = BATCH, CLASSES_PER_IMAGE
    rng = np.random.default_rng(11)
    du_c = coarse_form_unary(rng, b, k, SIZE // PATCH)
    rgb = torch.from_numpy(synthetic_scenes(rng, b, SIZE, 21)[0]).cuda()
    scores = rng.uniform(0.1, 0.5, (b, k)).astype(np.float32)
    scores[:, 4] = 0.0                   # an invalid candidate
    scores[:, 3] = -0.05                 # a negative score
    scores[:, 2] = scores[:, 1]          # a tie
    idx = np.stack([rng.permutation(np.arange(1, 21))[:k] for _ in range(b)])
    return (du_c, rgb, torch.from_numpy(scores).cuda(),
            torch.from_numpy(idx.astype(np.int32)).cuda())


def check_tail_kernel():
    """Phase 3g: returns the tail kernel's JSON fields (no launches)."""
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.morphology import nearest_upsample
    from simseg_tpu_torch.ops.seg_decode import decode_tail

    b, k = BATCH, CLASSES_PER_IMAGE
    du_c, rgb, scores, idx = tail_inputs()
    kw = dict(stride=STRIDE, num_iters=ITERS, closing_ksize=CLOSING)
    ones = torch.ones_like(scores, dtype=torch.bool)

    def tail():
        return crf_fused.seg_decode_tail_fused(du_c, rgb, scores, idx, PATCH, **kw)

    def lane():
        masks = crf_fused.mean_field_fused(
            nearest_upsample(du_c, PATCH).contiguous(), rgb, **kw)
        return decode_tail(masks, idx, scores, ones)

    def plain():
        return crf_fused.seg_decode_tail_fused_plain(du_c, rgb, scores, idx,
                                                     PATCH, **kw)

    (pred, bw), (p2, w2), (lp, lw), (pp, pw) = tail(), tail(), lane(), plain()
    torch.cuda.synchronize()
    n = pred.numel()
    differ = {"pred": (int((pred != lp).sum()), int((pred != pp).sum())),
              "best_w": (int((bw != lw).sum()), int((bw != pw).sum()))}
    agree_lane = 1 - max(d[0] for d in differ.values()) / n
    agree_plain = 1 - max(d[1] for d in differ.values()) / n
    same = torch.equal(pred, p2) and torch.equal(bw, w2)
    max_err = (bw - pw).abs().max().item()
    print(f"decode tail: of {n} entries, differing from the mean-field "
          f"kernel + decode_tail / from plain: "
          + ", ".join(f"{k} {a} / {p}" for k, (a, p) in differ.items())
          + f"; best_w max abs err vs plain {max_err}; two calls bit-equal "
          f"{same}", flush=True)
    if agree_lane < 0.9999 or agree_plain < 0.999:
        raise AssertionError(f"decode tail: pred and best_w agreement "
                             f"{agree_lane} (kernel lane) / {agree_plain} "
                             f"(plain): {differ}")
    if not same:
        raise AssertionError("decode tail: two calls differ")
    ms = cuda_ms(tail, 20)
    lane_ms = cuda_ms(lane, 20)
    plain_ms = cuda_ms(plain, 5)
    plain_device = device_profile(plain, "decode tail plain", top=0)
    radius = crf_fused.gaussian_constants(SIZE, SIZE, 3.0)[0].shape[0] // 2
    nbytes = (du_c.numel() * 4 + rgb.numel() * rgb.element_size()
              + pred.numel() * 8 + 8 * b * k)
    bound, bound_by = crf_bound_ms(b, k, SIZE, SIZE, STRIDE, radius, ITERS, nbytes)
    device, kernels, _ = device_rows(tail)
    device_profile(tail, "decode tail kernel")
    print(f"decode tail: kernel {ms:.4f} ms (device {device:.4f} ms, {kernels} "
          f"CUDA kernels per call), crf_mean_field + decode_tail {lane_ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms (device {plain_device:.4f} ms), bound "
          f"{bound:.4f} ms ({bound_by}), share of bound {bound / ms:.3f}",
          flush=True)
    return dict(max_abs_err=max_err, agreement_kernel_lane=agree_lane,
                agreement_plain=agree_plain, ms=ms, device_ms=device,
                kernels_per_call=kernels, default_lane_ms=lane_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None)


def run_fused_tail_slice(model, tokenizer, classes):
    """Phase 4e: returns the launch counts of its evaluate_benchmark run."""
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
    from simseg_tpu_torch.tasks.seg_eval import make_seg_features, zero_shot_classifier

    loader = SyntheticLoader(3, BATCH, len(classes), seed=9)
    counts = drive_eval("fused tail", loader, model, tokenizer, classes,
                        input_size=SIZE, crf_backend="fused_tail")
    if counts["seg_decode_tail"] != loader.batches or counts["crf_mean_field"]:
        raise AssertionError("the fused-tail slice must launch the tail kernel "
                             f"once per batch and no mean field: {counts}")

    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    features = make_seg_features(model, input_size=SIZE)
    decode = {backend: make_seg_decode_fn(
        num_classes=len(classes), image_size=SIZE, patch_size=PATCH,
        top_cls_num=10, bilateral_stride=STRIDE, crf_backend=backend)
        for backend in ("fused_tail", "auto")}
    differ = plain_differ = total = 0
    for batch in loader:
        images_u8 = torch.from_numpy(batch["image"]).cuda()
        dense, pooled = features(images_u8)
        with torch.no_grad():
            pred, best_w = decode["fused_tail"](dense, pooled, text_bank, images_u8)
            pred_a, best_a = decode["auto"](dense, pooled, text_bank, images_u8)
        pred_p = plain_decode(dense, pooled, text_bank, images_u8, SIZE)
        if not torch.isfinite(best_w).all() or int(pred.max()) >= len(classes):
            raise AssertionError("fused tail: bad decode output")
        differ += int((pred != pred_a).sum())
        plain_differ += int((pred != pred_p).sum())
        total += pred.numel()
    print(f"fused tail: pred vs the default lane {1 - differ / total:.6f} "
          f"({differ} of {total} pixels differ), vs plain decode "
          f"{1 - plain_differ / total:.6f}", flush=True)
    if differ > 1e-4 * total or plain_differ > 1e-3 * total:
        raise AssertionError(f"fused tail: {differ} / {plain_differ} of {total} "
                             "pixels differ from the default lane / plain")
    check_decode("fused tail", loader, model, text_bank, classes, SIZE,
                 crf_backend="fused_tail")
    return counts


# -- phase 7: bench.py's lanes, token merging and int8 ------------------------

INT8_OPS_PER_S = 1979e12
LANE_BATCHES = 3
# (label, image_arch, text_arch); bench.py's default is the last
LANES = (
    ("float", (), ()),
    ("tome r=16", (("tome_r", 16),), ()),
    ("tome schedule", (("tome_schedule", (48, 0, 0) * 4),), ()),
    ("int8", (("quant", "int8"),), (("quant", "int8"),)),
    ("int8_static", (("quant", "int8_static"),), (("quant", "int8_static"),)),
    ("tome r=16 + int8_static image (bench.py)",
     (("tome_r", 16), ("quant", "int8_static")), ()),
)
QUANT_CODE_BAR = 0.9999
QUANT_TOWER_COS_BAR = 0.999
TOKEN_COS_BAR = 0.9999
GATHER_MAP_BAR = 0.999


class FrozenLoader(SyntheticLoader):
    """A ``SyntheticLoader`` whose batches are made once: every lane and
    every pass (calibration, evaluation) reads the same arrays."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.frozen = list(super().__iter__())

    def __iter__(self):
        return iter(self.frozen)


def lane_model(state, image_arch=(), text_arch=()):
    """The flagship model on the card with float32 parameters ``state`` and
    bf16 compute, ToMe and int8 as the arch tuples say."""
    from simseg_tpu_torch.models.clip import CLIPModel

    with torch.device("cuda"):
        model = CLIPModel(img_size=SIZE, image_arch=image_arch or None,
                          text_arch=text_arch or None,
                          compute_dtype=torch.bfloat16, **FLAGSHIP)
    model.load_state_dict(state, strict=True)
    return model.eval()


def expected_tokens(model):
    """Tokens after each block, from the tower's merge plan: r clamped to
    the A side less the CLS (``ops/tome.py:merge_counts``)."""
    t, out = (SIZE // PATCH) ** 2 + 1, []
    for r in model.vit.tome_plan:
        t -= max(0, min(r, (t + 1) // 2 - 1))
        out.append(t)
    return out


def tokens_per_block(model, fn):
    """Tokens leaving each ViT block during one call of fn."""
    seen = []

    def hook(module, args, out):
        seen.append((out[0] if isinstance(out, tuple) else out).shape[1])

    hooks = [blk.register_forward_hook(hook) for blk in model.vit.blocks]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return seen


def run_lane(label, model, loader, tokenizer, classes, float_pred):
    """One lane: ``evaluate_benchmark`` on the loader's batches with the
    counts set to 0 just before and read just after (one CRF launch per
    batch); tokens per block against the plan; one batch's prediction timed
    with CUDA events and profiled (each after its own warm-up call); its
    predictions against the float lane's. Returns (pred, row)."""
    from simseg_tpu_torch.tasks.seg_eval import make_seg_predict, zero_shot_classifier

    counts = drive_eval(f"lane {label}", loader, model, tokenizer, classes,
                        input_size=SIZE)
    if counts["crf_mean_field"] != loader.batches:
        raise AssertionError(f"lane {label}: {counts['crf_mean_field']} CRF "
                             f"launches for {loader.batches} batches")
    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    images_u8 = torch.from_numpy(loader.frozen[0]["image"]).cuda()
    predict = make_seg_predict(model, len(classes), 10, input_size=SIZE,
                               bilateral_stride=STRIDE)
    out = {}
    tokens = tokens_per_block(
        model, lambda: out.update(pred=predict(images_u8, text_bank)[0]))
    if tokens != expected_tokens(model):
        raise AssertionError(f"lane {label}: tokens per block {tokens}, plan "
                             f"{expected_tokens(model)}")
    pred = out["pred"]
    ms = cuda_ms(lambda: predict(images_u8, text_bank), 3)
    device, launches, rows = device_rows(lambda: predict(images_u8, text_bank))
    agree = 1.0 if float_pred is None else (pred == float_pred).float().mean().item()
    row = dict(images_per_s=BENCH_BATCH / (ms / 1e3), event_ms=ms,
               device_ms=device, idle=1 - device / ms, launches=launches,
               crf_launches=counts["crf_mean_field"], tokens=tokens,
               agree_float=agree)
    print(f"lane {label}: {row['images_per_s']:.1f} images/s ({ms:.3f} ms "
          f"per batch of {BENCH_BATCH}, CUDA events), device {device:.3f} ms "
          f"per batch, idle share "
          f"{row['idle']:.3f}, {launches} kernel launches per batch, CRF "
          f"launches {counts['crf_mean_field']} in {loader.batches} batches, "
          f"tokens after each block {tokens}, pred agreement with the float "
          f"lane {agree:.6f}", flush=True)
    for us, count, key in rows[:6]:
        print(f"  {us / 1e3:9.4f} ms {100 * us / 1e3 / device:5.1f}% "
              f"x{count:<4d} {key[:80]}", flush=True)
    return pred, row


def int8_gemm_times():
    """``_int_mm`` against the bf16 ``torch.matmul`` at the image tower's
    GEMM shapes (tokens of a batch of 64 at T = 325 and 133), each beside
    its bound; the int8 weight passed as (N, K) contiguous transposed (the
    port's layout) and as (K, N) contiguous; and one quantised linear
    (quantise, product, dequantise) of each mode against the bf16 linear."""
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(12)
    for t in (325, 133):
        rows = BENCH_BATCH * t
        for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
            x8 = torch.randint(-127, 128, (rows, k), dtype=torch.int8,
                               device="cuda", generator=gen)
            w8 = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                               device="cuda", generator=gen)
            w8_kn = w8.t().contiguous()
            xb, wb = x8.bfloat16(), w8.bfloat16()
            t_nk = cuda_ms(lambda: torch._int_mm(x8, w8.t()), 20)
            t_kn = cuda_ms(lambda: torch._int_mm(x8, w8_kn), 20)
            t_bf = cuda_ms(lambda: torch.matmul(xb, wb.t()), 20)
            ops = 2.0 * rows * k * n
            b8 = 1e3 * max(ops / INT8_OPS_PER_S,
                           (rows * k + n * k + 4 * rows * n) / HBM_BYTES_PER_S)
            bb = 1e3 * max(ops / BF16_FLOP_PER_S,
                           2 * (rows * k + n * k + rows * n) / HBM_BYTES_PER_S)
            print(f"int8 GEMM ({rows}, {k}) x ({k}, {n}): _int_mm {t_nk:.4f} ms "
                  f"(weight (N, K).t(); (K, N) contiguous {t_kn:.4f}), bound "
                  f"{b8:.4f} ({100 * b8 / t_nk:.1f}%); bf16 matmul {t_bf:.4f} ms, "
                  f"bound {bb:.4f} ({100 * bb / t_bf:.1f}%); int8 / bf16 "
                  f"{t_nk / t_bf:.3f}", flush=True)
    rows, k, n = BENCH_BATCH * 325, 768, 2304
    x = torch.randn(rows, k, device="cuda", generator=gen).bfloat16()
    w = torch.randn(n, k, device="cuda", generator=gen) * 0.02
    bias = torch.zeros(n, device="cuda")
    wq, sw = quant.quantize_colwise(w)
    rcp = torch.full((k,), 127.0 / 4.0, device="cuda")
    t_dyn = cuda_ms(lambda: quant.int8_matmul(x, wq, sw, bias), 20)
    t_sta = cuda_ms(lambda: quant.int8_matmul_static(x, rcp, wq, sw, bias), 20)
    wb, bb16 = w.bfloat16(), bias.bfloat16()
    t_lin = cuda_ms(lambda: F.linear(x, wb, bb16), 20)
    print(f"quantised linear ({rows}, {k}) -> {n}, bf16 in and out: int8 "
          f"dynamic {t_dyn:.4f} ms, int8_static {t_sta:.4f} ms, bf16 "
          f"F.linear {t_lin:.4f} ms", flush=True)


def int_mm_exact(xq, wq):
    """True where ``ops/quant.int8_mm`` equals the exact integer product
    (float64 on the card: |sums| < 2^53)."""
    from simseg_tpu_torch.ops import quant

    got = quant.int8_mm(xq, wq)
    want = torch.matmul(xq.double(), wq.double().t())
    return bool(torch.equal(got.double(), want))


def check_int_mm():
    """7a: the int8 product on the card bit-equal to the exact integer
    product at the image tower's shapes and under 16 rows; a planted fault,
    the product taken in bf16 (the float fallback the port forbids), must
    not be."""
    from simseg_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = [(BENCH_BATCH * t, k, n) for t in (325, 133)
              for k, n in ((768, 2304), (768, 3072), (3072, 768))]
    shapes += [(5, 768, 768), (16, 768, 2304)]
    for rows, k, n in shapes:
        xq = torch.randint(-127, 128, (rows, k), dtype=torch.int8,
                           device="cuda", generator=gen)
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                           device="cuda", generator=gen)
        if not int_mm_exact(xq, wq):
            raise AssertionError(f"7a: the int8 product at ({rows}, {k}) x "
                                 f"({k}, {n}) is not exact")
    print(f"7a: the int8 product is exact at {len(shapes)} shapes "
          f"{shapes}", flush=True)
    rows, k, n = shapes[0]
    xq = torch.randint(-127, 128, (rows, k), dtype=torch.int8, device="cuda",
                       generator=gen)
    wq = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda",
                       generator=gen)
    with unittest.mock.patch.object(
            quant, "int8_mm",
            lambda x, w: torch.matmul(x.bfloat16(), w.bfloat16().t()).int()):
        passed = int_mm_exact(xq, wq)
    print(f"7a: planted fault (the product in bf16) at ({rows}, {k}) x "
          f"({k}, {n}): exact {passed}", flush=True)
    if passed:
        raise AssertionError("7a: the planted bf16 product passed")


def tower_images(n, seed):
    from simseg_tpu_torch.data.transforms import normalize_images

    rng = np.random.default_rng(seed)
    images, _ = synthetic_scenes(rng, n, SIZE, 21)
    return normalize_images(torch.from_numpy(images))


def min_token_cosine(a, b):
    return torch.nn.functional.cosine_similarity(
        a.double().cpu(), b.double().cpu(), dim=-1).min().item()


def quant_layer_inputs(vit, images):
    """(tokens, {name: input}) of ``vit`` on ``images``, the inputs of its
    quantised layers recorded."""
    from simseg_tpu_torch.ops import quant

    inputs = {}
    hooks = [layer.register_forward_pre_hook(
        lambda m, args, name=name: inputs.__setitem__(name, args[0]))
        for name, layer in quant.quant_layers(vit).items()]
    try:
        with torch.no_grad():
            tokens = vit(images)
    finally:
        for h in hooks:
            h.remove()
    return tokens, inputs


def product_io(layer, x):
    """(int8 input codes, int32 accumulator) of ``layer``'s product on x."""
    from simseg_tpu_torch.ops import quant

    seen, real = [], quant.int8_mm

    def record(xq, wq):
        seen.append((xq, real(xq, wq)))
        return seen[-1][1]

    with unittest.mock.patch.object(quant, "int8_mm", record), torch.no_grad():
        layer(x)
    return seen[0]


def compare_quant(cpu, card, images):
    """The card's image tower against the CPU's: every quantised layer run on
    the CPU tower's input to it (min share of equal int8 input codes; the
    card's accumulators on the CPU's codes equal to the CPU's), and the
    towers' tokens (min per-token cosine)."""
    from simseg_tpu_torch.ops import quant

    t_cpu, inputs = quant_layer_inputs(cpu.vit, images)
    t_card, _ = quant_layer_inputs(card.vit, images.cuda())
    card_layers = quant.quant_layers(card.vit)
    equal, exact = 1.0, True
    for name, layer in quant.quant_layers(cpu.vit).items():
        q_cpu, acc_cpu = product_io(layer, inputs[name])
        q_card, _ = product_io(card_layers[name], inputs[name].cuda())
        equal = min(equal, (q_card.cpu() == q_cpu).float().mean().item())
        exact &= torch.equal(quant.int8_mm(
            q_cpu.cuda(), card_layers[name].weight_q).cpu(), acc_cpu)
    return equal, exact, min_token_cosine(t_card, t_cpu), len(inputs)


def check_quant_towers(state_cpu):
    """7b: the int8 and int8_static image towers on the card against the same
    code on the CPU, float32, batch 2, the calibration made on the CPU and
    carried to the card with the model. Each quantised layer on the CPU
    tower's input to it: int8 input codes equal on >= 99.99% of entries and
    the int32 accumulators on the CPU's codes equal; the towers' tokens at
    per-token cosine >= 0.999, not the layers' 0.9999: the two towers'
    float32 products sum in other orders, an activation at a half step takes
    the neighbouring code on one side, and its token's next products then
    move by a step, a divergence that compounds over 48 products (0.99973 at
    dynamic int8 on an NVIDIA H100 80GB HBM3, 700 W). A planted fault, one layer's
    weight codes quantised from bf16-rounded master weights (what quantising
    a model cast to bf16 gives), must fail the bars."""
    import copy

    from simseg_tpu_torch.models.clip import CLIPModel
    from simseg_tpu_torch.ops import quant

    calib, images = tower_images(2, 14), tower_images(2, 15)
    for mode in ("int8", "int8_static"):
        cpu = CLIPModel(img_size=SIZE, image_arch=(("quant", mode),),
                        **FLAGSHIP).eval()
        cpu.load_state_dict(state_cpu, strict=True)
        quant.cache_quant_state(cpu, [lambda: cpu.forward_image_tokens(calib)])
        card = copy.deepcopy(cpu).cuda()
        equal, exact, cos, n = compare_quant(cpu, card, images)
        print(f"7b {mode}: card vs CPU in float32, {n} quantised layers on "
              f"the CPU's inputs: int8 input codes equal on >= {equal:.6f} of "
              f"entries, accumulators equal {exact}; towers' min per-token "
              f"cosine {cos:.7f}", flush=True)
        if equal < QUANT_CODE_BAR or not exact or cos < QUANT_TOWER_COS_BAR:
            raise AssertionError(f"7b {mode}: the quantised tower on the card "
                                 "disagrees with the CPU")
        layer = card.vit.blocks[1].attn.qkv
        fold = (torch.clamp(layer.x_absmax, min=1e-6) / 127.0
                if layer.static_acts else 1.0)
        layer.weight_q, _ = quant.quantize_colwise(
            layer.weight.detach().bfloat16().float() * fold)
        equal_f, exact_f, cos_f, _ = compare_quant(cpu, card, images)
        print(f"7b {mode}: planted fault (blocks.1 qkv codes from bf16-rounded "
              f"weights): codes {equal_f:.6f}, accumulators equal {exact_f}, "
              f"cosine {cos_f:.7f}", flush=True)
        if (equal_f >= QUANT_CODE_BAR and exact_f
                and cos_f >= QUANT_TOWER_COS_BAR):
            raise AssertionError(f"7b {mode}: the planted fault passed")
        del cpu, card
    torch.cuda.empty_cache()


def tome_run(model, images):
    """(tokens, final gather map) of the ToMe image tower on ``images``."""
    maps = []
    hook = model.vit.blocks[-1].register_forward_hook(
        lambda m, a, out: maps.append(out[2]))
    try:
        with torch.no_grad():
            tokens = model.forward_image_tokens(images)
    finally:
        hook.remove()
    return tokens, maps[0]


def check_tome_tower(state_cpu):
    """7c: the ToMe r = 16 image tower on the card against the CPU, float32,
    batch 2: gather maps equal on >= 99.9% of entries, tokens at per-token
    cosine >= 0.9999, two card calls bit-equal. A planted fault, the merge
    metric taken from the tokens instead of the attention keys, must fail
    the bars."""
    import copy

    from simseg_tpu_torch.models import vit as vit_module
    from simseg_tpu_torch.models.clip import CLIPModel

    images = tower_images(2, 16)
    cpu = CLIPModel(img_size=SIZE, image_arch=(("tome_r", 16),), **FLAGSHIP).eval()
    cpu.load_state_dict(state_cpu, strict=True)
    card = copy.deepcopy(cpu).cuda()
    t_cpu, m_cpu = tome_run(cpu, images)
    t_card, m_card = tome_run(card, images.cuda())
    t_again, m_again = tome_run(card, images.cuda())
    maps = (m_card.cpu() == m_cpu).float().mean().item()
    cos = min_token_cosine(t_card, t_cpu)
    same = torch.equal(t_card, t_again) and torch.equal(m_card, m_again)
    print(f"7c: ToMe tower card vs CPU in float32: gather maps equal on "
          f"{maps:.6f} of entries, min per-token cosine {cos:.7f}; two card "
          f"calls bit-equal {same}", flush=True)
    if maps < GATHER_MAP_BAR or cos < TOKEN_COS_BAR or not same:
        raise AssertionError("7c: the ToMe tower on the card disagrees")
    real = vit_module.bipartite_merge
    with unittest.mock.patch.object(
            vit_module, "bipartite_merge",
            lambda x, sizes, metric, r: real(x, sizes, x, r)):
        t_f, m_f = tome_run(card, images.cuda())
    maps_f = (m_f.cpu() == m_cpu).float().mean().item()
    cos_f = min_token_cosine(t_f, t_cpu)
    print(f"7c: planted fault (tokens as the merge metric): gather maps "
          f"{maps_f:.6f}, cosine {cos_f:.7f}", flush=True)
    if maps_f >= GATHER_MAP_BAR and cos_f >= TOKEN_COS_BAR:
        raise AssertionError("7c: the planted fault passed")
    del cpu, card


def check_tome_routing(state, tokenizer, classes):
    """7d: ToMe r = 16 with ``scales=(1.0, 2.0)``, 3 batches of 16: the first
    block of each 576-px tower pass (T = 1297, no bias yet) takes the
    attention kernel, every later block (biased) the plain path: exactly 3
    whole-T launches, as JAX routes. A planted fault, the size bias given
    to the first block too, must change the count."""
    model = lane_model(state, (("tome_r", 16),))
    loader = FrozenLoader(3, BATCH, len(classes), seed=17)
    want = {"flash": loader.batches, "train": 0, "rowblock": 0, "stream": 0}

    def lanes(label):
        counts = drive_eval(label, loader, model, tokenizer, classes,
                            input_size=SIZE, scales=(1.0, 2.0))
        return {k[5:]: v for k, v in counts.items() if k.startswith("lane_")}, counts

    got, counts = lanes("7d tome multi-scale")
    if got != want or counts["crf_mean_field"] != loader.batches:
        raise AssertionError(f"7d: attention lanes {got}, want {want}; "
                             f"CRF {counts['crf_mean_field']}")
    model.vit.blocks[0].tome_first = False
    planted, _ = lanes("7d planted fault (bias in the first block)")
    model.vit.blocks[0].tome_first = True
    print(f"7d: attention lanes {got}; planted fault {planted}", flush=True)
    if planted == want:
        raise AssertionError("7d: the planted fault passed")
    del model


def run_lanes(tokenizer, classes):
    """Phase 7: returns {lane label: row}."""
    state_cpu = seeded_clip(0).state_dict()
    state = {k: v.cuda() for k, v in state_cpu.items()}
    check_int_mm()
    int8_gemm_times()
    loader = FrozenLoader(LANE_BATCHES, BENCH_BATCH, len(classes), seed=11)
    float_pred, rows = None, {}
    for label, image_arch, text_arch in LANES:
        model = lane_model(state, image_arch, text_arch)
        pred, rows[label] = run_lane(label, model, loader, tokenizer, classes,
                                     float_pred)
        if float_pred is None:
            float_pred = pred
        del model
        torch.cuda.empty_cache()
    check_quant_towers(state_cpu)
    check_tome_tower(state_cpu)
    check_tome_routing(state, tokenizer, classes)
    return rows


# -- phase 8: the segmentation-eval entry point ---------------------------------

ENTRY_SCENES = 20                          # two batches, the second part full
ENTRY_BATCH = 16
ENTRY_BATCHES = -(-ENTRY_SCENES // ENTRY_BATCH)
# VOC2012's common image sizes (h, w); the GT label maps get their own sizes
ENTRY_SIZES = ((375, 500), (500, 333), (333, 500), (500, 375), (281, 500),
               (366, 500), (500, 400), (335, 500))
ENTRY_JPEG_AT = 5                          # the committed JPEG's scene index
ENTRY_LANES = (("auto", ()), ("fused_tail", ("seg_eval.crf_backend=fused_tail",)),
               ("fused", ("seg_eval.crf_backend=fused",)),
               ("pallas", ("seg_eval.crf_backend=pallas",)),
               ("xla", ("seg_eval.crf_backend=xla",)),
               ("scales (1.0, 2.0)", ("seg_eval.scales=[1.0,2.0]",)),
               ("fused_tail bf16", ("seg_eval.crf_backend=fused_tail",
                                    "seg_eval.crf_dtype=bfloat16")))
# launches per lane over the split: {count: launches}, every other count 0
ENTRY_WANT = {
    "auto": {"crf_mean_field": ENTRY_BATCHES},
    "fused_tail": {"seg_decode_tail": ENTRY_BATCHES},
    "fused": {"crf_mean_field": ENTRY_BATCHES},
    # the degree, then one product per mean-field iteration
    "pallas": {"bilateral_matvec": (1 + ITERS) * ENTRY_BATCHES},
    "xla": {},
    # the 576-px pass: one whole-T launch per block
    "scales (1.0, 2.0)": {"crf_mean_field": ENTRY_BATCHES,
                          "flash_attention": 12 * ENTRY_BATCHES,
                          "lane_flash": 12 * ENTRY_BATCHES},
    # phase 16: the TPU kernels' bf16 mode from the command line
    "fused_tail bf16": {"seg_decode_tail_bf16": ENTRY_BATCHES},
}
ENTRY_LANE_BAR = 0.999
NVJPEG_NEAR_BAR = 0.99       # share of channel values within 2 levels of PIL's
NVJPEG_RESIZED_BAR = 0.5     # mean absolute difference after the resize


def png_bytes(pixels, palette=None, paeth=True, level=6) -> bytes:
    """The script's own PNG writer: (H, W, 3) RGB with every row Paeth-
    filtered (PIL's encoder picks Paeth for nearly every row of such
    scenes) or, with ``paeth`` False, unfiltered, or (H, W) palette indices
    with ``palette`` (n, 3), unfiltered (as PIL writes palette images);
    zlib at ``level``."""
    import struct
    import zlib

    h, w = pixels.shape[:2]
    if palette is None and not paeth:
        rows, colour, ftype = pixels.reshape(h, w * 3).astype(np.uint8), 2, 0
    elif palette is None:
        x = pixels.reshape(h, w * 3).astype(np.int16)
        a = np.pad(x, ((0, 0), (3, 0)))[:, :-3]
        b = np.pad(x, ((1, 0), (0, 0)))[:-1]
        c = np.pad(b, ((0, 0), (3, 0)))[:, :-3]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        rows, colour, ftype = ((x - pred) & 255).astype(np.uint8), 2, 4
    else:
        rows, colour, ftype = pixels.astype(np.uint8), 3, 0
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8), rows], 1).tobytes()

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b"")


def voc_palette() -> np.ndarray:
    """PASCAL VOC's 256-entry label colour map."""
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


def entry_scene(rng, size, gt, num_classes):
    """A scene of three class discs on a background, with noise, at image
    size ``size`` (h, w) and its label map at ``gt`` (h, w): the same
    discs in relative coordinates, and a 255 (ignored) ring around each."""
    discs = [(*rng.uniform(0.1, 0.9, 2), rng.uniform(0.12, 0.3),
              int(rng.integers(1, num_classes)), rng.uniform(0, 255, 3))
             for _ in range(3)]
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    image = np.empty((h, w, 3), np.float32)
    image[:] = rng.uniform(0, 255, 3)
    gh, gw = gt
    gy, gx = np.mgrid[0:gh, 0:gw]
    label = np.zeros((gh, gw), np.uint8)
    for cy, cx, r, cls, colour in discs:
        image[(yy / h - cy) ** 2 + (xx / w - cx) ** 2 < r * r] = colour
        d2 = (gy / gh - cy) ** 2 + (gx / gw - cx) ** 2
        label[d2 < (r + 0.01) ** 2] = 255
        label[d2 < r * r] = cls
    image += rng.normal(0, 6, image.shape)
    return np.clip(image, 0, 255).astype(np.uint8), label


def write_entry_fixture(root, tokenizer, num_classes):
    """The VOC2012 layout under ``root`` (PNG scenes under ``.jpg`` names,
    one real JPEG, palette-PNG labels of 320-511 px), a seeded ViT-B/16 +
    BERT-base ``.pth`` in the reference's layout and the WordPiece vocab;
    returns (checkpoint, vocab file)."""
    rng = np.random.default_rng(2012)
    voc = os.path.join(root, "VOCdevkit", "VOC2012")
    for sub in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        os.makedirs(os.path.join(voc, sub))
    pal = voc_palette()
    names = [f"2012_{i:06d}" for i in range(ENTRY_SCENES)]
    for i, name in enumerate(names):
        gt = tuple(int(v) for v in rng.integers(320, 512, 2))
        image, label = entry_scene(rng, ENTRY_SIZES[i % len(ENTRY_SIZES)], gt,
                                   num_classes)
        if i == ENTRY_JPEG_AT:
            with open(os.path.join(TESTDATA, "scene.jpg"), "rb") as f:
                data = f.read()
        else:
            data = png_bytes(image)
        with open(os.path.join(voc, "JPEGImages", f"{name}.jpg"), "wb") as f:
            f.write(data)
        with open(os.path.join(voc, "SegmentationClass", f"{name}.png"), "wb") as f:
            f.write(png_bytes(label, pal))
    with open(os.path.join(voc, "ImageSets", "Segmentation", "val.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    ckpt = os.path.join(root, "simseg.vit-b.pth")
    torch.save({"state_dict": seeded_clip(0).state_dict()}, ckpt)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(sorted(tokenizer.vocab, key=tokenizer.vocab.get)) + "\n")
    return ckpt, vocab


class MemoryLoader:
    """Decoded batches replayed in order, with the loader's ``batch_size``
    and ``dataset`` (for the label canvas's pre-scan)."""

    def __init__(self, batches, batch_size, dataset):
        self.batches, self.batch_size, self.dataset = batches, batch_size, dataset

    def __iter__(self):
        return iter(self.batches)


def run_cli(label, argv):
    """``seg_evaluation.main(argv)`` with the counts set to 0 just before it
    and read just after; its ``evaluate_benchmark`` call is timed and its
    arguments kept. Returns (iou, miou, counts, nvJPEG decodes, the call's
    arguments and seconds, wall seconds)."""
    from simseg_tpu_torch.data import image_io
    from simseg_tpu_torch.tools import seg_evaluation as cli

    real, call = cli.evaluate_benchmark, {}

    def timed(loader, model, tokenizer, categories, top_cls_num, name, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(loader, model, tokenizer, categories, top_cls_num, name, **kw)
        torch.cuda.synchronize()
        call.update(loader=loader, model=model, tokenizer=tokenizer,
                    categories=categories, kw=kw,
                    seconds=time.perf_counter() - t0)
        return out

    reset_counts()
    image_io.NVJPEG_DECODES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with unittest.mock.patch.object(cli, "evaluate_benchmark", timed):
        results = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, decodes = read_counts(), image_io.NVJPEG_DECODES
    iou, miou = results["pascal_voc"]
    print(f"8 {label}: the CLI on {ENTRY_SCENES} images in {wall:.3f} s "
          f"(model build and checkpoint load included), evaluate_benchmark "
          f"{call['seconds']:.3f} s = {ENTRY_SCENES / call['seconds']:.1f} "
          f"images/s (decode, resize and text bank included), mIoU "
          f"{miou:.6f}; launches {counts}; nvJPEG decodes {decodes}",
          flush=True)
    if iou.shape != (21,) or not 0.0 <= miou <= 1.0:
        raise AssertionError(f"8 {label}: bad mIoU result {iou} {miou}")
    return iou, miou, counts, decodes, call, wall


def check_entry_launches(label, counts, decodes):
    check_counts(f"8 {label}", counts, ENTRY_WANT[label])
    if decodes != 1:
        raise AssertionError(f"8 {label}: nvJPEG decodes {decodes} (want 1)")


def check_nvjpeg_and_resize(dataset):
    """8: the committed JPEG through nvJPEG against PIL's pixels, and the
    card's resize bit-equal to the CPU's on every fixture image."""
    from simseg_tpu_torch.data.image_io import decode_rgb
    from simseg_tpu_torch.data.transforms import pil_resize

    with open(os.path.join(TESTDATA, "scene.jpg"), "rb") as f:
        data = f.read()
    want = np.load(os.path.join(TESTDATA, "scene_pil.npy")).astype(np.int32)
    got = decode_rgb(data, "cuda")
    diff = np.abs(got.cpu().numpy().astype(np.int32) - want)
    near = float((diff <= 2).mean())
    resized = (pil_resize(got, (SIZE, SIZE)).cpu().numpy().astype(np.int32)
               - pil_resize(torch.from_numpy(want.astype(np.uint8)),
                            (SIZE, SIZE)).numpy())
    resized_mean = float(np.abs(resized).mean())
    print(f"8 nvJPEG vs PIL on the committed {want.shape[1]}x{want.shape[0]} "
          f"4:2:0 JPEG: {near:.6f} of channel values within 2 levels (bar "
          f">= {NVJPEG_NEAR_BAR}), max {int(diff.max())}, mean "
          f"{diff.mean():.4f}; after the resize to {SIZE}: mean absolute "
          f"difference {resized_mean:.4f} (bar <= {NVJPEG_RESIZED_BAR})",
          flush=True)
    if near < NVJPEG_NEAR_BAR or resized_mean > NVJPEG_RESIZED_BAR:
        raise AssertionError(f"8: nvJPEG {near} within 2 levels, resized mean "
                             f"{resized_mean}")
    unequal = []
    for name in dataset.names:
        with open(os.path.join(dataset.image_path, name + ".jpg"), "rb") as f:
            image = decode_rgb(f.read(), "cuda")
        card = dataset.transforms(image).cpu()
        if not torch.equal(card, dataset.transforms(image.cpu())):
            unequal.append(name)
    print(f"8 resize: card bit-equal to the CPU on "
          f"{len(dataset.names) - len(unequal)}/{len(dataset.names)} images",
          flush=True)
    if unequal:
        raise AssertionError(f"8: the card's resize differs on {unequal}")


def host_times(dataset):
    """8: ms per image of the host's decode (file read + decode_rgb to the
    card) and of the resize on the card, each to its end, in turn over the
    split; and, where PIL is installed, of PIL's decode of the same files
    (``Image.open(...).convert("RGB")``, JAX's), as a yardstick (None
    without PIL)."""
    from simseg_tpu_torch.data.image_io import decode_rgb

    try:
        from PIL import Image
    except ImportError:
        Image = None
    pil = 0.0
    if Image is not None:
        for name in dataset.names:
            t0 = time.perf_counter()
            with Image.open(os.path.join(dataset.image_path, name + ".jpg")) as im:
                np.asarray(im.convert("RGB"))
            pil += time.perf_counter() - t0
    decode = resize = 0.0
    for name in dataset.names:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with open(os.path.join(dataset.image_path, name + ".jpg"), "rb") as f:
            image = decode_rgb(f.read(), "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dataset.transforms(image)
        torch.cuda.synchronize()
        decode += t1 - t0
        resize += time.perf_counter() - t1
    n = len(dataset.names)
    return (1e3 * decode / n, 1e3 * resize / n,
            None if Image is None else 1e3 * pil / n)


def lane_predictions(call, batches):
    """8: on the decoded batches, each lane's predictions (``make_seg_predict``
    per ``crf_backend``, and the decode with ``morphology_impl="matmul"``)
    against the ``xla`` lane's: the share of equal pixels."""
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
    from simseg_tpu_torch.tasks.seg_eval import (make_seg_features,
                                                 make_seg_predict,
                                                 zero_shot_classifier)

    model, kw, classes = call["model"], call["kw"], call["categories"]
    common = dict(input_size=kw["input_size"], mean=kw["mean"], std=kw["std"],
                  bilateral_stride=kw["bilateral_stride"])
    bank = zero_shot_classifier(model, classes, call["tokenizer"],
                                max_length=kw["max_length"])
    features = make_seg_features(model, input_size=kw["input_size"],
                                 mean=kw["mean"], std=kw["std"])
    matmul = make_seg_decode_fn(num_classes=len(classes),
                                image_size=kw["input_size"], patch_size=PATCH,
                                top_cls_num=10,
                                bilateral_stride=kw["bilateral_stride"],
                                morphology_impl="matmul")
    preds = {lane: [] for lane in ("xla", "fused", "pallas", "fused_tail",
                                   "matmul")}
    for lane in preds:
        if lane == "matmul":
            continue
        predict = make_seg_predict(model, len(classes), 10, crf_backend=lane,
                                   **common)
        preds[lane] = [predict(b["image"], bank)[0] for b in batches]
    with torch.no_grad():
        preds["matmul"] = [matmul(*features(b["image"]), bank, b["image"])[0]
                           for b in batches]
    agree = {}
    for lane in ("fused", "pallas", "fused_tail", "matmul"):
        same = sum(int((p == x).sum()) for p, x in zip(preds[lane], preds["xla"]))
        agree[lane] = same / sum(x.numel() for x in preds["xla"])
    print(f"8 lanes: pred agreement with the xla lane on {ENTRY_SCENES} "
          f"images: {agree} (bar >= {ENTRY_LANE_BAR})", flush=True)
    if min(agree.values()) < ENTRY_LANE_BAR:
        raise AssertionError(f"8: lane agreement {agree}")


def run_entry_point():
    """Phase 8: returns {lane: launch counts}."""
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer, make_test_vocab
    from simseg_tpu_torch.tasks.seg_eval import evaluate_benchmark, load_label_bank
    from simseg_tpu_torch.utils.prompts import IMAGENET_TEMPLATES

    classes = load_label_bank("pascal_voc")
    words = [w for t in IMAGENET_TEMPLATES for w in t.replace("{}", " ")
             .replace(".", " ").split()] + classes
    tokenizer = WordPieceTokenizer(make_test_vocab(words))
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ckpt, vocab = write_entry_fixture(root, tokenizer, len(classes))
        print(f"8 fixture: {ENTRY_SCENES} scenes and the checkpoint written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        base = ["--cfg", ENTRY_YAML,
                "--ckpt_path", ckpt, "--vocab_file", vocab,
                f"data.data_path={root}/", f"data.batch_size_val={ENTRY_BATCH}"]
        launches, first = {}, None
        for label, extra in ENTRY_LANES:
            iou, miou, counts, decodes, call, _ = run_cli(label, base + list(extra))
            check_entry_launches(label, counts, decodes)
            launches[label] = counts
            if first is None:
                first = (iou, miou, call)
            del call
            torch.cuda.empty_cache()
        iou, miou, call = first
        loader = call["loader"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = list(loader)
        torch.cuda.synchronize()
        loader_s = time.perf_counter() - t0
        memory = MemoryLoader(batches, loader.batch_size, loader.dataset)
        args = (call["model"], call["tokenizer"], call["categories"], 10,
                "pascal_voc")
        evaluate_benchmark(memory, *args, **call["kw"])     # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_iou, m_miou = evaluate_benchmark(memory, *args, **call["kw"])
        torch.cuda.synchronize()
        memory_s = time.perf_counter() - t0
        same = np.array_equal(m_iou, iou, equal_nan=True) and m_miou == miou
        swapped = [dict(b) for b in batches]
        image = swapped[0]["image"].clone()
        image[[0, 1]] = image[[1, 0]]
        swapped[0]["image"] = image
        p_iou, p_miou = evaluate_benchmark(
            MemoryLoader(swapped, loader.batch_size, loader.dataset), *args,
            **call["kw"])
        planted = np.array_equal(p_iou, iou, equal_nan=True) and p_miou == miou
        print(f"8 drift: in-memory evaluate_benchmark mIoU {m_miou:.6f} vs the "
              f"CLI's {miou:.6f}, per-class IoU bit-equal {same}; planted fault "
              f"(two images of batch 0 swapped after decode) mIoU "
              f"{p_miou:.6f}, bit-equal {planted}", flush=True)
        if not same:
            raise AssertionError(f"8: the loader drifts: {m_iou} vs {iou}")
        if planted:
            raise AssertionError("8: the planted fault passed the drift check")
        decode_ms, resize_ms, pil_ms = host_times(loader.dataset)
        cli_s = call["seconds"]
        print(f"8 entry point ({card_line()}): the CLI's evaluate_benchmark "
              f"{ENTRY_SCENES / cli_s:.1f} images/s ({cli_s:.3f} s, decode and "
              f"resize included), in memory {ENTRY_SCENES / memory_s:.1f} "
              f"images/s ({memory_s:.3f} s); the loader alone {loader_s:.3f} s "
              f"for the split; per batch of {ENTRY_BATCH}: host decode "
              f"{decode_ms * ENTRY_BATCH:.1f} ms, resize on the card "
              f"{resize_ms * ENTRY_BATCH:.1f} ms (PIL's decode of the same "
              f"files on the host: "
              f"{'not installed' if pil_ms is None else f'{pil_ms * ENTRY_BATCH:.1f} ms'}"
              f"); the loader's share of the wall time "
              f"{1 - memory_s / cli_s:.3f}", flush=True)
        check_nvjpeg_and_resize(loader.dataset)
        lane_predictions(call, batches)
        del first, call, batches, memory, swapped
    torch.cuda.empty_cache()
    return launches


# -- phase 9: the pretraining entry point ----------------------------------------

ENTRY_YAML = os.path.join(REPO, "configs", "clip", "simseg.vit-b.yaml")
TRAIN_ENTRY_ROWS = {"synth": 3100, "synth2": 384}   # cc3m-layout train rows
TRAIN_ENTRY_IMAGES = 64                    # valid images, 2 captions each
TRAIN_ENTRY_SIDES = (240, 500)
TRAIN_ENTRY_JPEG_EVERY = 97                # train rows that read the JPEG
TRAIN_ENTRY_SEED = 12                      # random / np.random before a run
TRAIN_ENTRY_WORDS = (
    "a", "photo", "of", "the", "red", "blue", "green", "white", "dog", "cat",
    "car", "tree", "man", "woman", "child", "on", "in", "with", "near",
    "street", "beach", "field", "water", "sky", "house", "bird", "playing",
    "running", "sitting", "small", "big", "two", "people", "under", "and",
    ",", '"')
TRAIN_ENTRY_COMMON = ("data.train_name=[synth]", "data.valid_name=[synth]",
                      "data.batch_size=128", "data.batch_size_val=64",
                      "epoch=1", "log.interval_train=4",
                      "runner.val_interval_steps=4", "data.num_workers=1")
# run -> (overrides after the common ones, train steps)
TRAIN_ENTRY_RUNS = {
    "A": ((), 8),
    # the JAX config's own 576-px override: T = 1297, the attention kernels
    "B": (("transforms.random_resize_crop.size=576",
           "transforms.input_size=576", "data.batch_size=32"), 6),
    "C": (("data.train_type=debias", "data.train_name=[synth,synth2]",
           "data.enable_valid=False"), 4),
}
# the timed passes: runs A and B again without validation (a pass inside
# the window would let the loader fill its queue), with 8 decode threads,
# 24 steps, the last 8 timed: the batches the loader makes ahead while the
# first steps warm up (its queue of 4 and 2 staged) are used up by then (16
# steps timed from step 9 still held some of them); one thread's cost is
# ``host_batch_times``'
TRAIN_ENTRY_TIMED = {f"{run}8": (run, 8) for run in ("A", "B")}
TRAIN_ENTRY_TIMED_STEPS = 24
TRAIN_ENTRY_TIMED_LAST = 8
TRAIN_ENTRY_LOSS_BAR = 1e-2                # phase 6's step bar


def synth_photo(rng, h, w):
    """A coarse colour field, two discs and a little noise: cheap to make,
    with edges and texture for AutoAugment's ops."""
    grid = rng.integers(0, 256, (6, 6, 3))
    img = grid[np.arange(h) * 6 // h][:, np.arange(w) * 6 // w].astype(np.int16)
    yy, xx = np.arange(h)[:, None] / h, np.arange(w)[None] / w
    for _ in range(2):
        cy, cx, r = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), rng.uniform(0.1, 0.3)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    img += rng.integers(-6, 7, (h, w, 1), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def synth_caption(rng):
    """4-10 seeded words; some with a comma, some with a quoted word."""
    words = [w for w in TRAIN_ENTRY_WORDS if w not in (",", '"')]
    cap = list(rng.choice(words, int(rng.integers(4, 11))))
    if rng.random() < 0.3:
        cap[int(rng.integers(0, len(cap)))] += ","
    if rng.random() < 0.2:
        i = int(rng.integers(0, len(cap)))
        cap[i] = f'"{cap[i]}"'
    return " ".join(cap)


def write_train_entry_fixture(root):
    """The cc3m layout under ``root``: ``<set>/{train,valid}_anno.csv``
    (image, caption, image_id, caption_id) and the images under
    ``<set>/{train,valid}/``, unfiltered PNG from ``png_bytes`` at 240-500
    px a side, plus the committed JPEG; the WordPiece vocab. Returns the
    vocab file."""
    rng = np.random.default_rng(2012)
    jobs = []                               # (path, seed, h, w)

    def rows_for(base, split, n, per_image):
        os.makedirs(os.path.join(base, split))
        shutil.copy(os.path.join(TESTDATA, "scene.jpg"),
                    os.path.join(base, split, "scene.jpg"))
        rows = []
        for i in range(n):
            image = i // per_image
            if split == "train" and i % TRAIN_ENTRY_JPEG_EVERY == 5:
                name = "scene.jpg"
            elif split == "valid" and image == 5:
                name = "scene.jpg"
            else:
                name = f"{split}_{image:05d}.png"
                if i % per_image == 0:
                    h, w = (int(v) for v in rng.integers(*TRAIN_ENTRY_SIDES, 2))
                    jobs.append((os.path.join(base, split, name),
                                 int(rng.integers(2**31)), h, w))
            rows.append([name, synth_caption(rng), image, i])
        with open(os.path.join(base, f"{split}_anno.csv"), "w", newline="",
                  encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["image", "caption", "image_id", "caption_id"])
            writer.writerows(rows)

    for name, n in TRAIN_ENTRY_ROWS.items():
        rows_for(os.path.join(root, name), "train", n, 1)
    rows_for(os.path.join(root, "synth"), "valid", 2 * TRAIN_ENTRY_IMAGES, 2)

    def write(job):
        path, seed, h, w = job
        with open(path, "wb") as f:
            f.write(png_bytes(synth_photo(np.random.default_rng(seed), h, w),
                              paeth=False, level=1))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    from simseg_tpu_torch.data.tokenizer import make_test_vocab

    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(make_test_vocab(TRAIN_ENTRY_WORDS)) + "\n")
    return vocab


_FIXTURES = {}
FIXTURE_LIMIT = 600                        # seconds the writing process may take
FIXTURES_READY = "entry_and_probe.ready"   # written once 9's and 12a's are


def write_fixtures(root):
    """``--write-fixtures``: phase 9's train-entry fixture (``root/entry``,
    also read by 10d and 11a), phase 12a's class folders (``root/probe``),
    then phase 17's aligned parity fixture and its reference side's result
    (``root/parity``, ``write_parity_fixture``)."""
    t0 = time.perf_counter()
    write_train_entry_fixture(os.path.join(root, "entry"))
    print(f"9 fixture: {sum(TRAIN_ENTRY_ROWS.values())} train rows and "
          f"{TRAIN_ENTRY_IMAGES} valid images written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    write_probe_fixture(os.path.join(root, "probe"))
    print(f"12a fixture: {PROBE_CLASSES} classes x {PROBE_TRAIN} + "
          f"{PROBE_VAL} JPEGs in {time.perf_counter() - t0:.1f} s", flush=True)
    open(os.path.join(root, FIXTURES_READY), "w").close()
    write_parity_fixture(os.path.join(root, "parity"))


def start_fixtures():
    """Starts the process that writes the fixtures (``write_fixtures``)
    into a directory removed at exit. The full run starts it first, so
    that its host time overlaps the card-bound phases before 9; the
    process is stopped at exit if it still runs."""
    if _FIXTURES:
        return
    root = tempfile.mkdtemp(prefix="chip_smoke_fixtures_")
    atexit.register(shutil.rmtree, root, True)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--write-fixtures", root])
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    _FIXTURES.update(root=root, proc=proc, t0=time.perf_counter())


def fixtures():
    """(train-entry directory, its vocab file, probe directory), once the
    writing process has written them (started here if nothing started it);
    it goes on to phase 17's fixture (``parity_fixture``)."""
    start_fixtures()
    if "waited" not in _FIXTURES:
        t0 = time.perf_counter()
        ready = os.path.join(_FIXTURES["root"], FIXTURES_READY)
        while not os.path.exists(ready):
            rc = _FIXTURES["proc"].poll()
            if rc is not None and not os.path.exists(ready):
                raise AssertionError(f"the fixture process exited with {rc}")
            if time.perf_counter() - _FIXTURES["t0"] > FIXTURE_LIMIT:
                raise AssertionError("the fixture process took too long")
            time.sleep(0.1)
        _FIXTURES["waited"] = time.perf_counter() - t0
        print(f"fixtures: written {time.perf_counter() - _FIXTURES['t0']:.1f} s "
              f"after the process started, waited for {_FIXTURES['waited']:.1f} s",
              flush=True)
    entry = os.path.join(_FIXTURES["root"], "entry")
    return entry, os.path.join(entry, "vocab.txt"), os.path.join(
        _FIXTURES["root"], "probe")


def parity_fixture():
    """Phase 17's fixture directory, once the writing process has ended."""
    start_fixtures()
    t0 = time.perf_counter()
    rc = _FIXTURES["proc"].wait(timeout=FIXTURE_LIMIT)
    if rc:
        raise AssertionError(f"the fixture process exited with {rc}")
    print(f"17 fixture: ready {time.perf_counter() - _FIXTURES['t0']:.1f} s "
          f"after the process started, waited for "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return os.path.join(_FIXTURES["root"], "parity")


def train_entry_fixture():
    """(directory, vocab file) of ``write_train_entry_fixture`` (phases 9,
    10d and 11a read it)."""
    entry, vocab, _ = fixtures()
    return entry, vocab


def train_entry_argv(label, data, root, vocab):
    """Run ``label``'s argv: a run of ``TRAIN_ENTRY_RUNS`` or a timed pass
    of ``TRAIN_ENTRY_TIMED``, on the fixture under ``data``; checkpoints
    under ``root``."""
    run, threads = TRAIN_ENTRY_TIMED.get(label, (label, None))
    extra, steps = TRAIN_ENTRY_RUNS[run]
    if threads is not None:
        extra = extra + (f"data.num_workers={threads}", "data.enable_valid=False")
        steps = TRAIN_ENTRY_TIMED_STEPS
    return (["--cfg", ENTRY_YAML, "--vocab_file", vocab,
             f"data.data_path={data}/", f"ckpt.dir={root}/{label}",
             f"data.train_steps={steps}", *TRAIN_ENTRY_COMMON, *CUT_ARCH,
             *extra])


def parse_entry(argv):
    from simseg_tpu_torch.config import new_base_cfg
    from simseg_tpu_torch.tasks.clip.train import parse_args

    cfg = new_base_cfg()
    parse_args(argv, target=cfg)
    return cfg


def run_train_main(label, argv, keep=2, profile=None):
    """``tasks.clip.train.main(argv)`` from ``TRAIN_ENTRY_SEED``, the counts
    set to 0 just before it and read just after, with ``cfg.profile`` set
    on the tree (as JAX's users set it) when ``profile`` is given. Records
    the first ``keep`` host batches, each step's loss, lr and CUDA events,
    each validation pass's seconds (host clock, synchronised) and step, and
    the last pass's embeddings, ids and table. Returns (runner, record,
    counts, wall s)."""
    from simseg_tpu_torch.core import runner as runner_mod
    from simseg_tpu_torch.core.train_hooks import RetrievalEvalHook
    from simseg_tpu_torch.tasks.clip import train as entry

    rec = {"batches": [], "losses": [], "lrs": [], "events": [], "val": [],
           "last_val": None}
    step_fn = runner_mod.CLIPRunner.batch_processor
    val_fn = runner_mod.EpochRunner.val
    after_val = RetrievalEvalHook.after_val_epoch

    def step(runner, batch, device_batch=None):
        if len(rec["batches"]) < keep:
            rec["batches"].append(batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(runner, batch, device_batch)
        end.record()
        rec["events"].append((start, end))
        rec["losses"].append(out["loss"])
        rec["lrs"].append(out["lr"])
        return out

    def val(runner, loader, loader_idx=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val_fn(runner, loader, loader_idx)
        torch.cuda.synchronize()
        rec["val"].append((runner.step, time.perf_counter() - t0))

    def keep_val(hook, runner):
        emb = (torch.cat(hook._img), torch.cat(hook._txt),
               np.concatenate(hook._iid), np.concatenate(hook._cid))
        after_val(hook, runner)
        rec["last_val"] = emb + (dict(runner.state.retrieval_summary),)

    init = entry.task_cfg_init_fn

    def init_with_profile(cfg):
        init(cfg)
        if profile is not None:
            cfg.profile = profile

    random.seed(TRAIN_ENTRY_SEED)
    np.random.seed(TRAIN_ENTRY_SEED)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with unittest.mock.patch.object(runner_mod.CLIPRunner, "batch_processor", step), \
            unittest.mock.patch.object(runner_mod.EpochRunner, "val", val), \
            unittest.mock.patch.object(RetrievalEvalHook, "after_val_epoch",
                                       keep_val), \
            unittest.mock.patch.object(entry, "task_cfg_init_fn",
                                       init_with_profile):
        runner = entry.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    losses = [x.item() for x in rec["losses"]]
    rec["losses"] = losses
    print(f"9 run {label}: main() in {wall:.3f} s (model build, loader, "
          f"validation and checkpoint included), {len(losses)} steps, losses "
          f"{[round(x, 5) for x in losses]}; validation passes "
          f"{[(k, round(t, 3)) for k, t in rec['val']]} (after step, s); "
          f"launches {counts}", flush=True)
    if len(losses) != runner.train_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"9 run {label}: losses {losses}")
    return runner, rec, counts, wall


# 16d: run B's profiled window (ProfileHook, cfg.profile); each step runs
# one forward and one backward attention launch a block
PROFILE_WINDOW = {"start_step": 2, "num_steps": 2}
PROFILE_KERNELS = ("flash_fwd_kernel", "delta_kernel", "dq_kernel", "dkdv_kernel")


def check_profile_trace(path):
    """16d: run B's trace (the ProfileHook's Chrome trace of steps 3-4) holds
    each attention kernel once per block and step of the window, as the
    launch counters count them."""
    if not path or not os.path.exists(path):
        raise AssertionError(f"16d: no profile trace ({path})")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in n for n in kernels) for k in PROFILE_KERNELS}
    want = CUT_DEPTH * PROFILE_WINDOW["num_steps"]
    print(f"16d: run B's profile trace {os.path.basename(path)} "
          f"({os.path.getsize(path) / 1e6:.1f} MB): {len(kernels)} CUDA kernels, "
          f"attention {found} (want {want} each)", flush=True)
    if any(v != want for v in found.values()):
        raise AssertionError(f"16d: attention kernels in the trace {found}, "
                             f"want {want} each")


def entry_ms_per_step(rec, warmup=2):
    """The mean ms per train step from the start of step ``warmup + 1`` to
    the end of the last (CUDA events: loader stalls between steps count);
    a run without validation."""
    torch.cuda.synchronize()
    if rec["val"]:
        raise AssertionError("9: a timed pass ran validation")
    timed = rec["events"][warmup:]
    return timed[0][0].elapsed_time(timed[-1][1]) / len(timed)


def ranks64(left, lgid, right, rgid):
    """The first-match rank rule of ``utils/retrieval.py`` in float64 numpy."""
    sim = left @ right.T
    match = lgid[:, None] == rgid[None, :]
    best = np.where(match, sim, -np.inf).max(1)
    return np.where(match.any(1), (sim > best[:, None]).sum(1), -1)


def retrieval64(img, txt, iid):
    """(table, text-to-image ranks) of ``retrieval_summary`` in float64."""
    order = np.argsort(iid, kind="stable")
    uni, counts = np.unique(iid[order], return_counts=True)
    gallery = img[order[np.cumsum(counts) - 1]]
    i2t = ranks64(gallery, uni, txt, iid)
    t2i = ranks64(txt, iid, gallery, uni)
    out = {}
    for name, r in (("i2t", i2t), ("t2i", t2i)):
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float(((r >= 0) & (r < k)).sum() / (r >= 0).sum())
    out["rsum"] = 100.0 * sum(out.values())
    return out, t2i


def check_retrieval_ranking(last_val):
    """9: the card's table on run A's last validation embeddings against
    float64 numpy ranks; a planted gallery (text = its image + 1e-3 noise)
    at R@1 = 1 both ways on the card and in float64."""
    from simseg_tpu_torch.utils.retrieval import (IndexedEmb, first_match_ranks,
                                                  retrieval_summary)

    img, txt, iid, _, table = last_val
    want, t2i = retrieval64(img.double().cpu().numpy(),
                            txt.double().cpu().numpy(), iid)
    gallery = IndexedEmb("image", iid, img).unique()
    card_t2i = first_match_ranks(IndexedEmb("text", iid, txt), gallery)
    moved = int((card_t2i != t2i).sum())
    rng = np.random.default_rng(9)
    base = rng.normal(size=(TRAIN_ENTRY_IMAGES, img.shape[1]))
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    pid = np.repeat(np.arange(TRAIN_ENTRY_IMAGES), 2)
    ptxt = base[pid] + 1e-3 * rng.normal(size=(len(pid), img.shape[1]))
    planted = retrieval_summary(torch.from_numpy(base[pid]).float().cuda(),
                                torch.from_numpy(ptxt).float().cuda(), pid,
                                np.arange(len(pid)))
    planted64, _ = retrieval64(base[pid], ptxt, pid)
    print(f"9 retrieval ({card_line()}): run A's last validation on the card "
          f"{table}; float64 ranks give {want}; text-to-image ranks that "
          f"differ {moved}/{len(t2i)}; planted gallery (text = image + 1e-3 "
          f"noise) R@1 card i2t {planted['i2t_R@1']} t2i {planted['t2i_R@1']}, "
          f"float64 {planted64['i2t_R@1']} {planted64['t2i_R@1']}", flush=True)
    if any(abs(table[k] - want[k]) > 1e-9 for k in want):
        raise AssertionError(f"9: retrieval table {table} vs float64 {want}")
    if min(planted["i2t_R@1"], planted["t2i_R@1"], planted64["i2t_R@1"],
           planted64["t2i_R@1"]) != 1.0:
        raise AssertionError(f"9: planted gallery R@1 {planted} / {planted64}")


def check_loader_drift(argv, rec, vocab):
    """9: run A's first two batches as the entry point got them against the
    port's loader on the CPU from the same seeds, bit for bit; a planted
    fault (two images of batch 1 swapped after decode) must fail."""
    from simseg_tpu_torch.data.datasets import build_clip_dataloaders
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer

    cfg = parse_entry(argv)
    random.seed(TRAIN_ENTRY_SEED)
    np.random.seed(TRAIN_ENTRY_SEED)
    loader = build_clip_dataloaders(
        cfg, WordPieceTokenizer.from_vocab_file(vocab))["train"][0]
    loader.set_epoch(0)
    it = iter(loader)
    cpu = [next(it) for _ in rec["batches"]]
    it.close()

    def same(a, b):
        return (torch.equal(a["image"], b["image"])
                and all(np.array_equal(a[k], b[k])
                        for k in ("input_ids", "attention_mask")))

    equal = [same(a, b) for a, b in zip(rec["batches"], cpu)]
    swapped = dict(rec["batches"][0])
    swapped["image"] = swapped["image"][[1, 0] + list(range(2, len(swapped["image"])))]
    planted = same(swapped, cpu[0])
    print(f"9 drift: run A's steps 1-2 (images {tuple(cpu[0]['image'].shape)} "
          f"uint8, token ids) bit-equal to the CPU loader's {equal}; planted "
          f"fault (two images swapped after decode) equal {planted}", flush=True)
    if not all(equal):
        raise AssertionError("9: the entry point's batches drift from the loader's")
    if planted:
        raise AssertionError("9: the planted fault passed the drift check")


def check_first_step_loss(argv, rec):
    """9: step 1's loss on the card against the port's float32 CPU step on
    the recorded batch, from the same seeded initial weights."""
    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.engine.train_step import clip_loss_fn
    from simseg_tpu_torch.models.clip import build_clip_model

    cfg = parse_entry(list(argv) + ["dist.bf16=False"])
    torch.manual_seed(int(cfg.seed or 0))
    model = build_clip_model(cfg)
    batch = rec["batches"][0]
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = clip_loss_fn(model, {
            "image": normalize_images(batch["image"],
                                      tuple(cfg.transforms.normalize.mean),
                                      tuple(cfg.transforms.normalize.std)),
            "input_ids": torch.as_tensor(batch["input_ids"]).long(),
            "attention_mask": torch.as_tensor(batch["attention_mask"]).long()})
    torch.set_num_threads(threads)
    cpu, card = loss.item(), rec["losses"][0]
    rel = abs(card - cpu) / abs(cpu)
    print(f"9 step 1: loss on the card {card:.6f} (bf16 compute) vs the float32 "
          f"CPU step {cpu:.6f} ({time.perf_counter() - t0:.1f} s), relative "
          f"{rel:.3e} (bar {TRAIN_ENTRY_LOSS_BAR})", flush=True)
    if rel > TRAIN_ENTRY_LOSS_BAR:
        raise AssertionError(f"9: step 1 loss {card} vs {cpu}")


def check_lr_sequence(runner, rec):
    from simseg_tpu_torch.core.lr_schedule import build_schedule

    schedule = build_schedule(runner.cfg, runner.total_steps)
    want = [schedule(i) for i in range(len(rec["lrs"]))]
    if rec["lrs"] != want:
        raise AssertionError(f"9: lr sequence {rec['lrs']} vs {want}")


def in_memory_train(argv, batches, ckpt, steps=16):
    """The entry run's config on its own recorded batches, repeated, through
    ``train`` with no loader and no validation: (ms per step over the last
    ``TRAIN_ENTRY_TIMED_LAST`` steps, device ms of one step, images a
    step)."""
    from simseg_tpu_torch.tasks.clip.train import train

    cfg = parse_entry(list(argv) + ["data.enable_valid=False",
                                    "runner.val_interval_steps=-1",
                                    f"data.train_steps={steps}",
                                    f"ckpt.dir={ckpt}"])
    loader = [batches[i % len(batches)] for i in range(steps)]
    timer = StepTimer()
    with timer.patch():
        runner = train(cfg, {"train": [loader]})
    ms, _ = timer.ms_per_step(steps - TRAIN_ENTRY_TIMED_LAST)
    device = device_profile(lambda: runner.batch_processor(batches[0]),
                            "9 in-memory train step", top=6)
    b = len(batches[0]["image"])
    del runner
    torch.cuda.empty_cache()
    return ms, device, b


def host_batch_times(argv, vocab, n):
    """ms for n train samples on one thread: file read + decode, the train
    transforms, and the caption corruption + tokenisation."""
    from simseg_tpu_torch.data.corruption import process_caption
    from simseg_tpu_torch.data.datasets import build_clip_dataloaders
    from simseg_tpu_torch.data.image_io import decode_rgb
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer.from_vocab_file(vocab)
    cfg = parse_entry(argv)
    ds = build_clip_dataloaders(cfg, tok)["train"][0].dataset.datasets[0]
    decode = augment = text = 0.0
    for i in range(n):
        t0 = time.perf_counter()
        with open(os.path.join(ds.image_base, ds.images[i]), "rb") as f:
            image = decode_rgb(f.read(), "cpu")
        t1 = time.perf_counter()
        ds.transforms(image)
        t2 = time.perf_counter()
        tok([process_caption(tok, ds.captions[i], rng=random.Random(i))],
            max_length=cfg.model.max_length)
        decode += t1 - t0
        augment += t2 - t1
        text += time.perf_counter() - t2
    return 1e3 * decode, 1e3 * augment, 1e3 * text


def run_retrieval_cli(data, root, vocab, ckpt, want):
    """9: the retrieval CLI on a ``valid.parquet`` (written under ``root``)
    of the fixture's valid set (under ``data``) where
    pyarrow is installed, else ``evaluate_benchmark`` over the CSV valid
    loader; both on run A's checkpoint, against run A's last validation
    table (the same weights, images and captions) within 1e-6."""
    from simseg_tpu_torch.tools import retrieval_evaluation as cli

    argv = ["--cfg", ENTRY_YAML, "--ckpt_path", ckpt, "--vocab_file", vocab,
            f"data.data_path={root}/", "data.batch_size_val=64",
            "data.num_workers=1", *CUT_ARCH]
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        pa = None
    t0 = time.perf_counter()
    if pa is not None:
        cols = {"imbytes": [], "caption": [], "image_id": [], "id": []}
        with open(os.path.join(data, "synth", "valid_anno.csv"), newline="",
                  encoding="utf-8") as f:
            for row in csv.DictReader(f):
                with open(os.path.join(data, "synth", "valid", row["image"]),
                          "rb") as g:
                    cols["imbytes"].append(g.read())
                cols["caption"].append(row["caption"])
                cols["image_id"].append(int(row["image_id"]))
                cols["id"].append(int(row["caption_id"]))
        os.makedirs(os.path.join(root, "synthpq"))
        pq.write_table(pa.table(cols), os.path.join(root, "synthpq", "valid.parquet"))
        table = cli.main(argv + ["data.valid_name=[synthpq]"])["synthpq"]
        how = "the CLI's main() on valid.parquet (pyarrow)"
    else:
        from simseg_tpu_torch.checkpoint import load_pretrained_params
        from simseg_tpu_torch.data.datasets import build_clip_dataloaders
        from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer
        from simseg_tpu_torch.models.clip import build_clip_model

        _, cfg = cli.parse_args(argv + [f"data.data_path={data}/",
                                        "data.valid_name=[synth]",
                                        "data.train_name=[synth]"])
        model = load_pretrained_params(ckpt, build_clip_model(cfg))
        loader = build_clip_dataloaders(
            cfg, WordPieceTokenizer.from_vocab_file(vocab))["val"][0]
        table = cli.evaluate_benchmark(loader, model, cfg)
        how = ("evaluate_benchmark over the CSV valid loader (pyarrow is not "
               "installed, so no parquet)")
    seconds = time.perf_counter() - t0
    print(f"9 retrieval CLI ({card_line()}): {how} in {seconds:.3f} s: {table}; "
          f"run A's last validation {want}", flush=True)
    if any(abs(table[k] - want[k]) > 1e-6 for k in want):
        raise AssertionError(f"9: the retrieval CLI {table} vs run A {want}")


def module_check(name) -> str:
    out = subprocess.run([sys.executable, "-c", f"import {name}; print("
                          f"getattr({name}, '__version__', 'present'))"],
                         capture_output=True, text=True)
    return out.stdout.strip() if out.returncode == 0 else "missing"


def run_train_entry():
    """Phase 9: returns {run: launch counts}."""
    print(f"9 host: pyarrow {module_check('pyarrow')}, PIL "
          f"{module_check('PIL')}, pandas {module_check('pandas')}", flush=True)
    card = card_line()
    launches, batches, vals, timed = {}, {}, {}, {}
    data, vocab = train_entry_fixture()
    with tempfile.TemporaryDirectory() as root:
        argv = {k: train_entry_argv(k, data, root, vocab)
                for k in list(TRAIN_ENTRY_RUNS) + list(TRAIN_ENTRY_TIMED)}

        runner, rec, counts, _ = run_train_main("A", argv["A"])
        launches["A"] = counts
        if any(counts.values()):
            raise AssertionError(f"9 run A: launches {counts}, want none at 224 px")
        check_lr_sequence(runner, rec)
        ckpt, last_val = runner.cfg.ckpt.dir, rec["last_val"]
        batches["A"], vals["A"] = rec["batches"], [s for _, s in rec["val"]]
        del runner
        torch.cuda.empty_cache()
        check_loader_drift(argv["A"], rec, vocab)
        check_first_step_loss(argv["A"], rec)
        check_retrieval_ranking(last_val)
        run_retrieval_cli(data, root, vocab, ckpt, last_val[-1])
        del rec, last_val

        runner, rec, counts, _ = run_train_main(
            "B", argv["B"], profile=dict(PROFILE_WINDOW,
                                         dir=os.path.join(root, "B_trace")))
        launches["B"] = counts
        steps = TRAIN_ENTRY_RUNS["B"][1]
        want = {"flash_attention": CUT_DEPTH * steps,
                "flash_attention_bwd": CUT_DEPTH * steps,
                "lane_train": CUT_DEPTH * steps}
        # the 288-px validation takes no kernel
        check_counts("9 run B", counts, want)
        check_profile_trace(runner.state.get("profile_trace"))
        check_lr_sequence(runner, rec)
        batches["B"], vals["B"] = rec["batches"], [s for _, s in rec["val"]]
        del runner, rec
        torch.cuda.empty_cache()

        runner, rec, counts, _ = run_train_main("C", argv["C"], keep=0)
        launches["C"] = counts
        if any(counts.values()) or runner.step != TRAIN_ENTRY_RUNS["C"][1]:
            raise AssertionError(f"9 run C: launches {counts}, step {runner.step}")
        del runner, rec
        torch.cuda.empty_cache()

        for label in TRAIN_ENTRY_TIMED:
            runner, rec, _, _ = run_train_main(label, argv[label], keep=0)
            timed[label] = entry_ms_per_step(
                rec, TRAIN_ENTRY_TIMED_STEPS - TRAIN_ENTRY_TIMED_LAST)
            del runner, rec
            torch.cuda.empty_cache()
        memory = {run: in_memory_train(argv[run], batches[run],
                                       os.path.join(root, f"{run}_memory"))
                  for run in ("A", "B")}
        host = {run: host_batch_times(argv[run], vocab, len(batches[run][0]["image"]))
                for run in ("A", "B")}
    for label, (run, threads) in TRAIN_ENTRY_TIMED.items():
        ms, (mem, dev, b) = timed[label], memory[run]
        print(f"9 run {run} timed, {threads} decode thread(s), batch {b} at "
              f"{224 if run == 'A' else 576} px ({card}): the entry point "
              f"{b / ms * 1e3:.1f} images/s ({ms:.3f} ms a step, the last "
              f"{TRAIN_ENTRY_TIMED_LAST} of {TRAIN_ENTRY_TIMED_STEPS}), "
              f"in memory {b / mem * 1e3:.1f} "
              f"images/s ({mem:.3f} ms); the loader's share of the wall time "
              f"{1 - mem / ms:.3f}; device {dev:.3f} ms a step, idle share "
              f"{1 - dev / ms:.3f} through the entry point ({1 - dev / mem:.3f} "
              f"in memory)", flush=True)
    for run in ("A", "B"):
        decode, augment, text = host[run]
        print(f"9 run {run} ({card}): validation {[round(v, 3) for v in vals[run]]} "
              f"s a pass (128 rows, 64 images); host, one thread, per batch of "
              f"{len(batches[run][0]['image'])}: decode {decode:.1f} ms, train "
              f"transforms {augment:.1f} ms, captions {text:.1f} ms", flush=True)
    print(f"9 launches ({card}): {launches}", flush=True)
    return launches


# -- phase 10: the YAML's batch of 1024 (BSGS, remat, accumulation) -------------

BIG_BATCH = 1024                           # configs/clip/simseg.vit-b.yaml
BIG_MICRO = 128                            # data.batch_size_train's default
BIG_LONG = (256, 32)                       # BSGS at 576 px: batch, micro
BIG_STEPS = 4                              # timed steps 3-4 (StepTimer)
BSGS_CHECKS = ((224, 256, 64), (TRAIN_SIZE, 64, 32))   # (a): px, batch, micro
BSGS_LOSS_BAR = 1e-2                       # phase 6's step bars
BSGS_COS_BAR = 0.99
REMAT_BATCH = 8
REMAT_GRAD_BAR = 1e-6                      # of each gradient's largest entry
BIG_ENTRY_STEPS = 3
ACCUM_STEPS = 6                            # (f): timed steps 3-6, two updates
BIG_ENTRY_CUT = 2                          # the mid-epoch checkpoint's step
# 10d, 11a, 11b, 11d, 13: the blocks of each tower, at full width (what
# these checks hold, a resume, a world against one process, an artifact
# against the live module, does not depend on depth; their time does)
CUT_DEPTH = 2
CUT_ARCH = (f"model.image_encoder.arch={{'depth': {CUT_DEPTH}}}",
            f"model.text_encoder.arch={{'depth': {CUT_DEPTH}}}")


def bsgs_counts(per, steps=1):
    """A BSGS run's launches at 576 px with ``per`` = 12 x micro-batches: a
    forward without lse each (pass 1, the inference lane), a forward with
    it and a backward each (pass 2, the train lane)."""
    return {"flash_attention": 2 * per * steps, "flash_attention_bwd": per * steps,
            "lane_flash": per * steps, "lane_train": per * steps}


def big_runner(size, b, micro, *extra, tok=None, seed=0):
    """A ``CLIPRunner`` on the card over no loader (for its model, optimizer
    and ``_prepare_batch``): the training slice's config at a ``size``-px
    crop, ``runner.name=clip_bsgs``, batch b in micro-batches of ``micro``."""
    from simseg_tpu_torch.core.runner import CLIPRunner
    from simseg_tpu_torch.models.clip import build_clip_model

    cfg = train_cfg(tempfile.gettempdir(), f"transforms.random_resize_crop.size={size}",
                    f"transforms.input_size={size}", f"data.batch_size={b}",
                    f"data.batch_size_train={micro}", "runner.name=clip_bsgs",
                    *extra)
    torch.manual_seed(seed)
    return CLIPRunner(cfg, build_clip_model(cfg), {"train": []}, device="cuda",
                      tokenizer=tok)


def tiled_batch(batch, n):
    """``batch`` repeated to n rows."""
    reps = -(-n // len(batch["image"]))
    return {"image": np.concatenate([batch["image"]] * reps)[:n],
            "caption": (list(batch["caption"]) * reps)[:n]}


def bsgs_grads(model, batch, num_micro, key=None):
    """(loss, {name: float32 grad}) of one BSGS gradient."""
    from simseg_tpu_torch.engine import bsgs

    metrics = bsgs.make_bsgs_grad_fn(model, num_micro)(batch, key)
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return metrics["loss"].item(), grads


def tower_cosines(grads, want):
    """{tower: (least cosine, tensor)} of each tower's gradients against
    ``want``; the key projections' biases left out (their gradient is zero
    in exact arithmetic: a softmax does not move when a query's scores all
    shift, so both sides hold rounding noise there)."""
    import torch.nn.functional as F

    out = {}
    for tower in ("image_encoder.", "text_encoder."):
        cos = {n: F.cosine_similarity(grads[n].flatten(), want[n].flatten(),
                                      dim=0).item()
               for n in want if n.startswith(tower)
               and not n.endswith("attention.self.key.bias")}
        worst = min(cos, key=cos.get)
        out[tower[:-1]] = (cos[worst], worst)
    return out


def within_bsgs_bars(loss, want_loss, cos):
    rel = abs(loss - want_loss) / abs(want_loss)
    return rel, rel <= BSGS_LOSS_BAR and all(c >= BSGS_COS_BAR for c, _ in cos.values())


def check_bsgs_against_plain(size, b, micro, tok, batch, fault=False):
    """10a: one BSGS gradient of a seeded batch against the plain step's
    (``clip_loss_fn`` over the whole batch, one backward): loss within 1e-2,
    each tower's least gradient cosine >= 0.99; with ``fault``, pass 2 on the
    micro-batches' left matrices in reversed order must fail the bars.
    Returns the launch counts of the BSGS gradient."""
    from simseg_tpu_torch.engine import bsgs

    runner = big_runner(size, b, micro, tok=tok)
    dev = runner._prepare_batch(batch)
    loss_p, want = step_grads(runner.model, dev)
    reset_counts()
    loss_b, grads = bsgs_grads(runner.model, dev, b // micro)
    counts = read_counts()
    cos = tower_cosines(grads, want)
    rel, ok = within_bsgs_bars(loss_b, loss_p, cos)
    print(f"10a BSGS {b} / {micro} at {size} px vs the plain step: loss "
          f"{loss_b:.6f} vs {loss_p:.6f} (relative {rel:.3e}); least gradient "
          f"cosine {cos}; launches {counts}", flush=True)
    if not ok:
        raise AssertionError(f"10a: BSGS vs plain at {size} px: loss {rel}, {cos}")
    if fault:
        inner = bsgs.reforward

        def reversed_lefts(model, micro_batches, keys, lam, left_i, left_t, n):
            m = len(micro_batches)
            flip = lambda x: torch.cat(list(x.chunk(m))[::-1])  # noqa: E731
            return inner(model, micro_batches, keys, lam, flip(left_i),
                         flip(left_t), n)

        with unittest.mock.patch.object(bsgs, "reforward", reversed_lefts):
            loss_f, bad = bsgs_grads(runner.model, dev, b // micro)
        cos_f = tower_cosines(bad, want)
        rel_f, ok_f = within_bsgs_bars(loss_f, loss_p, cos_f)
        print(f"10a planted fault (pass 2 on the left matrices in reversed "
              f"micro-batch order): loss relative {rel_f:.3e}, least cosine "
              f"{cos_f}; within the bars {ok_f}", flush=True)
        if ok_f:
            raise AssertionError("10a: the planted fault passed the BSGS bars")
    return runner, dev, counts


def check_remat(runner, dev):
    """10b: one step's loss and gradients at batch ``REMAT_BATCH`` with the
    towers under remat 'none' and 'dots' against no remat (576 px, the
    attention kernels on the path): loss bit-equal, each gradient within
    1e-6 of its largest entry, the train lane's forward launches doubled
    under 'none' (the recompute runs the kernels again). Each run's peak is
    read before its gradients are copied, and the copies are kept on the
    host, so no run's peak holds another run's gradients."""
    from simseg_tpu_torch.engine.train_step import clip_loss_fn

    model = runner.model
    small = {k: v[:REMAT_BATCH] for k, v in dev.items()}
    towers = (model.vit, model.bert)

    def run(remat, policy):
        for tower in towers:
            tower.remat, tower.remat_policy = remat, policy
        model.zero_grad(set_to_none=True)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = clip_loss_fn(model, small)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts()
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads, counts, peak

    loss, want, counts, peak = run(False, "none")
    print(f"10b no remat: loss {loss:.6f}, launches {counts}, peak "
          f"{peak / 2**30:.3f} GiB", flush=True)
    check_counts("10b no remat", counts, {"flash_attention": 12, "lane_train": 12,
                                          "flash_attention_bwd": 12})
    for policy in ("none", "dots"):
        loss_r, got, counts_r, peak_r = run(True, policy)
        worst = max(((got[n] - w).abs().max().item()
                     / max(w.abs().max().item(), 1e-30), n)
                    for n, w in want.items())
        print(f"10b remat {policy}: loss {loss_r:.6f} (bit-equal "
              f"{loss_r == loss}); largest gradient error {worst[0]:.3e} of "
              f"its largest entry ({worst[1]}); launches {counts_r}; peak "
              f"{peak_r / 2**30:.3f} GiB", flush=True)
        if loss_r != loss or worst[0] > REMAT_GRAD_BAR:
            raise AssertionError(f"10b remat {policy}: loss {loss_r} vs {loss}, "
                                 f"gradient {worst}")
        if policy == "none":
            check_counts("10b remat none", counts_r,
                         {"flash_attention": 24, "lane_train": 24,
                          "flash_attention_bwd": 12})
    for tower in towers:
        tower.remat, tower.remat_policy = False, "none"


def check_dropout_replay(runner, dev):
    """10c: dropout 0.1 at every tower site: two BSGS gradients with one key
    bit-equal, another key's different."""
    from simseg_tpu_torch.engine.train_step import step_key
    from simseg_tpu_torch.models.layers import Dropout

    sites = [m for m in runner.model.modules() if isinstance(m, Dropout)]
    for m in sites:
        m.rate = 0.1
    b = len(dev["image"])
    try:
        runs = [bsgs_grads(runner.model, dev, 2, step_key(0, s))
                for s in (7, 7, 8)]
    finally:
        for m in sites:
            m.rate = 0.0
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])
    moved = sum(not torch.equal(runs[0][1][n], runs[2][1][n]) for n in runs[0][1])
    print(f"10c dropout 0.1 at {len(sites)} sites, BSGS {b} / {b // 2}: the same "
          f"key twice bit-equal {same} (loss {runs[0][0]:.6f}); another key "
          f"moves {moved} of {len(runs[0][1])} gradients (loss "
          f"{runs[2][0]:.6f})", flush=True)
    if not same or moved < len(runs[0][1]) // 2:
        raise AssertionError("10c: dropout masks do not replay by key")


def time_train(label, size, b, steps, tok, batch, *extra):
    """10e: ``train`` on ``batch`` repeated ``steps`` times at a ``size``-px
    crop, writing no checkpoint: (ms per step over steps 3 to the end, peak
    GiB, launch counts, runner). Losses finite."""
    from simseg_tpu_torch.core.train_hooks import CheckpointHook
    from simseg_tpu_torch.tasks.clip.train import train

    cfg = train_cfg(tempfile.mkdtemp(), f"transforms.random_resize_crop.size={size}",
                    f"transforms.input_size={size}", f"data.batch_size={b}",
                    f"data.train_steps={steps}", "epoch=1", "ckpt.step_interval=-1",
                    *extra)
    timer = StepTimer()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timer.patch(), unittest.mock.patch.object(CheckpointHook, "_save",
                                                   lambda *a: None):
        reset_counts()
        runner = train(cfg, {"train": [[batch] * steps]}, tokenizer=tok)
        torch.cuda.synchronize()
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [x.item() for x in timer.losses]
    ms, inside = timer.ms_per_step()
    each = [round(a.elapsed_time(z), 1) for a, z in timer.events]
    print(f"10e {label}: {ms:.3f} ms a step (steps 3-{steps}; {inside:.3f} ms "
          f"inside batch_processor; each step {each} ms) = {b / ms * 1e3:.1f} "
          f"images/s; peak {peak:.3f} GiB; losses "
          f"{[round(x, 5) for x in losses]}", flush=True)
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"10e {label}: losses {losses}")
    shutil.rmtree(cfg.ckpt.dir, ignore_errors=True)
    return ms, peak, counts, runner


def big_entry_argv(data, root, vocab):
    """10d: the vit-b YAML through the entry point with BSGS at its batch of
    1024 in micro-batches of 128, 8 decode threads, the deterministic
    resize to 224 px (random ops drawn by 8 threads would not replay, and
    the resume check replays step 3), no validation, the orbax backend."""
    return ["--cfg", ENTRY_YAML, "--vocab_file", vocab,
            f"data.data_path={data}/", f"ckpt.dir={root}/run",
            "data.train_name=[synth]", "data.valid_name=[synth]",
            "data.enable_valid=False", "runner.name=clip_bsgs",
            f"data.batch_size={BIG_BATCH}", f"data.batch_size_train={BIG_MICRO}",
            "data.num_workers=8", f"data.train_steps={BIG_ENTRY_STEPS}",
            "epoch=1", f"ckpt.step_interval={BIG_ENTRY_CUT}",
            "log.interval_train=1", "transforms.train_transforms=[resize]",
            "transforms.resize.size=224", "ckpt.backend=orbax", *CUT_ARCH]


def big_entry_run(label, argv):
    """``tasks.clip.train.main(argv)`` with the counts set to 0 just before
    and read just after. Returns (runner, losses, counts, wall s, times:
    the run's last save's snapshot ms and write s, and its restore's s
    if it restored)."""
    from simseg_tpu_torch.core import train_hooks
    from simseg_tpu_torch.tasks.clip import train as entry

    restore = train_hooks.load_checkpoint_orbax
    times = {}

    def timed_restore(*a, **k):
        t0 = time.perf_counter()
        out = restore(*a, **k)
        torch.cuda.synchronize()
        times["restore_s"] = time.perf_counter() - t0
        return out

    timer = StepTimer()
    random.seed(TRAIN_ENTRY_SEED)
    np.random.seed(TRAIN_ENTRY_SEED)
    runner = None
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.patch(), unittest.mock.patch.object(
            train_hooks, "load_checkpoint_orbax", timed_restore):
        runner = entry.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    mgr = next(h for h in runner._hooks
               if isinstance(h, train_hooks.CheckpointHook))._mgr
    times.update(snapshot_ms=mgr.last_snapshot_s * 1e3, write_s=mgr.last_write_s)
    losses = [x.item() for x in timer.losses]
    steps = [round(a.elapsed_time(b), 1) for a, b in timer.events]
    print(f"10d {label}: main() in {wall:.3f} s, {len(losses)} steps of "
          f"{BIG_BATCH} ({steps} ms each), losses "
          f"{[round(x, 5) for x in losses]}; launches {counts}", flush=True)
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"10d {label}: losses {losses}")
    return runner, losses, counts, wall, times


def check_big_entry(data, root, vocab):
    """10d: the entry point with ``runner.name=clip_bsgs`` at 1024 / 128
    under the orbax backend: finite losses; the run's directory with its
    last step taken away is what a run cut at step 2 leaves (step 2's
    write drained while step 3 updated the weights in place), and resumed
    gives the uninterrupted run's parameters; the resumed run's ``.pth``
    export reads back bit-equal."""
    from simseg_tpu_torch.checkpoint.native import complete_steps

    argv = big_entry_argv(data, root, vocab)
    whole, losses, counts, _, saved = big_entry_run("uninterrupted", argv)
    check_counts("10d (224 px takes no kernel)", counts, {})
    if len(losses) != BIG_ENTRY_STEPS:
        raise AssertionError(f"10d: {len(losses)} steps")
    shutil.rmtree(os.path.join(whole.cfg.ckpt.dir, str(BIG_ENTRY_STEPS)))
    if complete_steps(whole.cfg.ckpt.dir) != [BIG_ENTRY_CUT]:
        raise AssertionError(f"10d: steps {complete_steps(whole.cfg.ckpt.dir)} "
                             f"left, not [{BIG_ENTRY_CUT}]")
    resumed, rest, _, _, loaded = big_entry_run("resumed", argv)
    same = all(torch.equal(a, b) for a, b in zip(
        whole.model.state_dict().values(), resumed.model.state_dict().values()))
    print(f"10d resumed at step {BIG_ENTRY_CUT}, ran {len(rest)} step(s) to step "
          f"{resumed.step}; step 3's loss {rest[-1]:.6f} vs {losses[-1]:.6f}; "
          f"parameters equal to the uninterrupted run's {same}", flush=True)
    print(f"10d orbax backend ({card_line()}): the uninterrupted run's last "
          f"save (step {BIG_ENTRY_STEPS}): blocking snapshot "
          f"{saved['snapshot_ms']:.1f} ms, background write "
          f"{saved['write_s']:.3f} s; the resumed run's restore "
          f"{loaded['restore_s']:.3f} s", flush=True)
    if len(rest) != BIG_ENTRY_STEPS - BIG_ENTRY_CUT:
        raise AssertionError(f"10d: the resumed run ran {len(rest)} step(s), not "
                             f"from step {BIG_ENTRY_CUT}'s checkpoint")
    if resumed.step != BIG_ENTRY_STEPS or not same or rest[-1] != losses[-1]:
        raise AssertionError("10d: the resumed run differs from the "
                             "uninterrupted one")
    del resumed
    check_torch_export(whole, argv, root)
    del whole
    torch.cuda.empty_cache()


def check_torch_export(whole, argv, root):
    """10d: ``tools/export_torch_checkpoint.main`` on the run's step
    directories (the latest: the resumed run's end, equal to the
    uninterrupted run's) writes the reference-layout ``.pth``;
    ``load_clip_checkpoint`` (strict) into a fresh model reads every
    tensor back bit-equal to the uninterrupted run's model."""
    from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint
    from simseg_tpu_torch.models.clip import build_clip_model
    from simseg_tpu_torch.tools import export_torch_checkpoint

    t0 = time.perf_counter()
    out = os.path.join(root, "whole.pth")
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]
    report = export_torch_checkpoint.main(
        ["--cfg", ENTRY_YAML, "--ckpt_path", whole.cfg.ckpt.dir, "--out", out,
         "--device", "cuda", *overrides])
    model = build_clip_model(whole.cfg).cuda()
    load_clip_checkpoint(out, model, strict=True)
    want = whole.model.state_dict()
    unequal = [k for k, v in model.state_dict().items()
               if not torch.equal(v, want[k])]
    print(f"10d export ({card_line()}): {len(report['exported'])} tensors "
          f"written to a reference-layout .pth from the step directories and "
          f"read back, {len(want) - len(unequal)}/{len(want)} bit-equal, in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if unequal or model.state_dict().keys() != want.keys():
        raise AssertionError(f"10d: the exported .pth differs on {unequal[:5]}")
    del model


def run_big_batch():
    """Phase 10: returns the launches of rows 5 and 6 counted in one BSGS
    step at 576 px, {"flash_attention": pass 1 + pass 2 forward,
    "flash_attention_bwd"}."""
    card = card_line()
    t_start = time.perf_counter()
    batch224, tok = caption_batch(13, BIG_BATCH // 4, 224)
    batch576, _ = caption_batch(14, BSGS_CHECKS[1][1], TRAIN_SIZE)

    # (a) BSGS against the plain step, a planted fault at 224 px; (b) remat
    # and (c) dropout on the 576-px model
    for (size, b, micro), batch, fault in zip(BSGS_CHECKS, (batch224, batch576),
                                              (True, False)):
        runner, dev, counts = check_bsgs_against_plain(size, b, micro, tok,
                                                       batch, fault)
        if size == TRAIN_SIZE:
            check_counts("10a BSGS", counts, bsgs_counts(12 * (b // micro)))
            check_remat(runner, dev)
        else:
            check_dropout_replay(runner, {k: v[:64] for k, v in dev.items()})
        del runner, dev
        torch.cuda.empty_cache()

    # (e) images/s in memory and peak memory; (f) accumulation
    big = tiled_batch(batch224, BIG_BATCH)
    rows = {}
    for label, size, b, batch, extra in (
            ("BSGS 1024 / 128, 224 px", 224, BIG_BATCH, big,
             ("runner.name=clip_bsgs", f"data.batch_size_train={BIG_MICRO}")),
            ("BSGS 1024 / 128, 224 px, remat none", 224, BIG_BATCH, big,
             ("runner.name=clip_bsgs", f"data.batch_size_train={BIG_MICRO}",
              "model.remat=True")),
            ("BSGS 256 / 32, 576 px", TRAIN_SIZE, BIG_LONG[0],
             tiled_batch(batch576, BIG_LONG[0]),
             ("runner.name=clip_bsgs", f"data.batch_size_train={BIG_LONG[1]}")),
            ("plain 128, 224 px", 224, 128, tiled_batch(batch224, 128), ()),
            ("plain 32, 576 px", TRAIN_SIZE, 32, tiled_batch(batch576, 32), ()),
            ("plain 256, 224 px", 224, 256, batch224, ()),
            ("plain 256, 224 px, remat none", 224, 256, batch224,
             ("model.remat=True",))):
        ms, peak, counts, runner = time_train(label, size, b, BIG_STEPS, tok,
                                              batch, *extra)
        rows[label] = (b / ms * 1e3, ms, peak, counts)
        if label.startswith("BSGS 256"):
            # rows 5-6's launches in one more BSGS step, counted alone
            reset_counts()
            runner.batch_processor(batch)
            torch.cuda.synchronize()
            one_step = read_counts()
        del runner
    per = 12 * (BIG_LONG[0] // BIG_LONG[1])
    check_counts("10e one BSGS 256 / 32 step", one_step, bsgs_counts(per))
    for label, row in rows.items():
        check_counts(f"10e {label}", row[3],
                     bsgs_counts(per, BIG_STEPS) if label.startswith("BSGS 256")
                     else {"flash_attention": 12 * BIG_STEPS,
                           "flash_attention_bwd": 12 * BIG_STEPS,
                           "lane_train": 12 * BIG_STEPS} if "576" in label
                     else {})
    ms, _, _, runner = time_train("plain 128, 224 px, grad_accum_steps=2", 224,
                                  128, ACCUM_STEPS, tok, tiled_batch(batch224, 128),
                                  "optim.grad_accum_steps=2")
    counts = {int(s["step"]) for s in runner.optimizer.base.state.values()}
    print(f"10f accumulation: runner step {runner.step}, AdamW step {counts}, "
          f"mini-step {runner.optimizer.mini_step}", flush=True)
    if counts != {runner.step // 2} or runner.optimizer.mini_step:
        raise AssertionError(f"10f: AdamW steps {counts} after {runner.step}")
    # one warm-up call accumulates, the profiled call updates
    device_profile(lambda: runner.batch_processor(tiled_batch(batch224, 128)),
                   "10f step with the update, grad_accum_steps=2", top=6)
    del runner
    torch.cuda.empty_cache()

    # (d) the entry point at the YAML's batch
    data, vocab = train_entry_fixture()
    with tempfile.TemporaryDirectory() as root:
        check_big_entry(data, root, vocab)

    for label, (rate, ms, peak, _) in rows.items():
        print(f"10 {label} ({card}): {rate:.1f} images/s in memory ({ms:.3f} "
              f"ms a step), peak {peak:.3f} GiB", flush=True)
    launches = {k: one_step[k] for k in ("flash_attention", "flash_attention_bwd")}
    print(f"10 launches in one BSGS step at 576 px, 256 / 32, counted ({card}): "
          f"rows 5-6 {launches} (pass 1: {one_step['lane_flash']} forwards in "
          f"the inference lane, pass 2: {one_step['lane_train']} in the train "
          f"lane, then {one_step['flash_attention_bwd']} backward); phase 10 in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return launches


# -- phase 11: data parallelism over ranks --------------------------------------

DIST_WORLD = 2
DIST_RANK_BATCH = 16                       # (b): 576 px, images a rank
DIST_STEPS = 3
DIST_LOSS_BAR = 1e-2                       # phase 6's step bar
DIST_COS_BAR = 0.99
DIST_NORM_BAR = 1e-2                       # relative: tower norms, temperature
DIST_EVAL_BATCHES = 3                      # (c): batches of 16 a rank, 288 px
DIST_BSGS = (BIG_BATCH, BIG_MICRO, 64)     # (d): batch, one process's micro, a rank's
DIST_BSGS_STEPS = 2
DIST_ENTRY_STEPS = 8                       # (a)
DIST_LIMIT = 900                           # seconds the ranks may take
DIST_NOTE = ("two ranks sharing one card through gloo measure no multi-card "
             "speed: they take turns on the card and stage every collective "
             "through the host")


def tower_norms(grads, want):
    """{tower: |1 - norm / wanted norm|} of each tower's gradients, and the
    temperature's gradient the same way."""
    out = {}
    for tower in ("image_encoder.", "text_encoder."):
        names = [n for n in want if n.startswith(tower)]
        got = torch.sqrt(sum(grads[n].double().pow(2).sum() for n in names))
        ref = torch.sqrt(sum(want[n].double().pow(2).sum() for n in names))
        out[tower[:-1]] = abs(1.0 - (got / ref).item())
    t = "loss.temperature"
    out["temperature"] = abs(1.0 - (grads[t] / want[t]).item())
    return out


def dist_bars(label, loss, grads, want_loss, want):
    """(ok, text): loss within 1e-2 relative, each tower's least gradient
    cosine >= 0.99, each tower's gradient norm and the temperature's
    gradient within 1e-2 relative of one process's."""
    rel = abs(loss - want_loss) / abs(want_loss)
    cos = tower_cosines(grads, want)
    norms = tower_norms(grads, want)
    ok = (rel <= DIST_LOSS_BAR and all(c >= DIST_COS_BAR for c, _ in cos.values())
          and all(v <= DIST_NORM_BAR for v in norms.values()))
    return ok, (f"{label}: loss {loss:.6f} vs {want_loss:.6f} (relative "
                f"{rel:.3e}); least gradient cosine {cos}; norm errors {norms}")


def captured_step(runner, batch):
    """(loss, {name: float32 grad}) of one call of the runner's step on
    ``batch`` (device tensors), the optimizer's update replaced by a copy of
    the gradients it would take."""
    grads = {}

    def capture():
        for n, p in runner.model.named_parameters():
            if p.grad is not None:
                grads[n] = p.grad.detach().float().clone()
        runner.optimizer.zero_grad()
        return torch.zeros(())

    with unittest.mock.patch.object(runner.optimizer, "step", capture):
        metrics = runner._step_fn(batch, 0.0, 0, True)
    return metrics["loss"].item(), grads


def params_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def timed_reductions():
    """(patch, events): the steps' gradient reduction
    (``reduce_model_gradients``) wrapped in CUDA events."""
    from simseg_tpu_torch.engine import bsgs, train_step

    events, inner = [], train_step.reduce_model_gradients

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        inner(*a, **kw)
        end.record()
        events.append((start, end))

    stack = contextlib.ExitStack()
    stack.enter_context(unittest.mock.patch.object(
        train_step, "reduce_model_gradients", timed))
    stack.enter_context(unittest.mock.patch.object(
        bsgs, "reduce_model_gradients", timed))
    return stack, events


def dist_train_steps(label, runner, host, steps, rank):
    """``steps`` calls of ``runner.batch_processor`` on this rank's host
    batch, the counts set to 0 just before and read just after: (ms a step
    over the steps after the first, reduction ms a step, staged bytes a
    step, counts)."""
    from simseg_tpu_torch.parallel import collectives

    timer = StepTimer()
    patch, events = timed_reductions()
    staged = collectives.STAGED_BYTES[0]
    reset_counts()
    torch.cuda.synchronize()
    with timer.patch(), patch:
        for _ in range(steps):
            runner.batch_processor(host)
            runner.step += 1
        torch.cuda.synchronize()
    counts = read_counts()
    staged = (collectives.STAGED_BYTES[0] - staged) / steps
    ms, _ = timer.ms_per_step(warmup=1)
    red = sum(a.elapsed_time(b) for a, b in events[1:]) / max(len(events) - 1, 1)
    losses = [x.item() for x in timer.losses]
    print(f"{label} rank {rank}: {steps} steps, losses "
          f"{[round(x, 5) for x in losses]}, {ms:.3f} ms a step (steps 2-"
          f"{steps}), gradient reduction {red:.3f} ms a step, {staged / 2**20:.1f} "
          f"MiB staged through the host a step; launches {counts}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label} rank {rank}: losses {losses}")
    return ms, red, staged, counts


def planted_gathers():
    """The planted faults of (b): a mean where the sum is due (the
    gradients halved), and a gather that leaves out rank 1's rows (rank 0's
    in their place)."""
    from simseg_tpu_torch.engine import train_step
    from simseg_tpu_torch.parallel import collectives, sharding

    def mean_reduce(model, mesh):
        sharding.reduce_model_gradients(model, mesh)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(DIST_WORLD)

    def gather_without_rank1(x, group=None):
        g = collectives.all_gather(x, group)
        n = x.shape[0]
        return torch.cat([g[:n], g[:n]] + [g[2 * n:]])

    return {"a mean where the sum is due": unittest.mock.patch.object(
                train_step, "reduce_model_gradients", mean_reduce),
            "a gather without rank 1's rows": unittest.mock.patch.object(
                train_step, "all_gather", gather_without_rank1)}


def dist_plain_step(tmp, rank, mesh, result):
    """11b: the plain step at 576 px, 16 images a rank, against one
    process's step at 32 on the same images and weights; the planted
    faults; 3 steps; the ranks' parameters bit-equal after them."""
    from simseg_tpu_torch.core.runner import CLIPRunner
    from simseg_tpu_torch.models.clip import build_clip_model
    from simseg_tpu_torch.parallel import process_allgather

    b, n = DIST_WORLD * DIST_RANK_BATCH, DIST_RANK_BATCH
    batch, tok = caption_batch(31, b, TRAIN_SIZE)
    cfg = train_cfg(tmp, f"transforms.random_resize_crop.size={TRAIN_SIZE}",
                    f"transforms.input_size={TRAIN_SIZE}", f"data.batch_size={b}",
                    *CUT_ARCH)
    torch.manual_seed(0)
    runner = CLIPRunner(cfg, build_clip_model(cfg), {"train": []},
                        device="cuda:0", tokenizer=tok)
    dev = runner._prepare_batch(batch)
    local = {k: v[rank * n:(rank + 1) * n] for k, v in dev.items()}
    want = None
    if rank == 0:
        want_loss, want = step_grads(runner.model, dev)
    loss, grads = captured_step(runner, local)
    faults = {}
    for name, patch in planted_gathers().items():
        with patch:
            faults[name] = captured_step(runner, local)
    if rank == 0:
        ok, text = dist_bars(f"11b {DIST_WORLD} ranks x {n} vs one process at "
                             f"{b}, {TRAIN_SIZE} px", loss, grads, want_loss, want)
        print(text, flush=True)
        if not ok:
            raise AssertionError("11b: the ranks' gradient is not one process's")
        for name, (f_loss, f_grads) in faults.items():
            f_ok, f_text = dist_bars(f"11b planted fault, {name}", f_loss,
                                     f_grads, want_loss, want)
            print(f_text + f"; within the bars {f_ok}", flush=True)
            if f_ok:
                raise AssertionError(f"11b: the planted fault ({name}) passed")
    del want, grads, faults
    torch.cuda.empty_cache()
    host = {"image": batch["image"][rank * n:(rank + 1) * n],
            "caption": batch["caption"][rank * n:(rank + 1) * n]}
    ms, red, staged, counts = dist_train_steps("11b", runner, host, DIST_STEPS, rank)
    check_counts(f"11b rank {rank}", counts,
                 {"flash_attention": CUT_DEPTH * DIST_STEPS,
                  "lane_train": CUT_DEPTH * DIST_STEPS,
                  "flash_attention_bwd": CUT_DEPTH * DIST_STEPS})
    digests = process_allgather(np.frombuffer(
        bytes.fromhex(params_digest(runner.model)), np.uint8))
    same = bool((digests == digests[0]).all())
    print(f"11b rank {rank}: parameters after {DIST_STEPS} steps bit-equal "
          f"across the ranks {same}", flush=True)
    if not same:
        raise AssertionError("11b: the ranks' parameters differ")
    result["b"] = dict(ms=ms, reduce_ms=red, staged=staged, counts=counts,
                       images_per_s=b / ms * 1e3)
    del runner, dev, local
    torch.cuda.empty_cache()


class ChainedLoader:
    """The batches of several loaders, one after the other."""

    def __init__(self, loaders):
        self.loaders = loaders
        self.batches = sum(l.batches for l in loaders)
        self.batch_size = loaders[0].batch_size

    def __iter__(self):
        for loader in self.loaders:
            yield from loader


def recorded_eval(label, loader, model, tokenizer, classes):
    """``evaluate_benchmark`` at 288 px with each batch's predictions kept,
    the counts set to 0 just before it and read just after: (mIoU, preds,
    counts)."""
    from simseg_tpu_torch.tasks import seg_eval

    preds, inner = [], seg_eval.make_seg_forward

    def make(*a, **kw):
        forward = inner(*a, return_pred=True, **kw)

        def keep(*args):
            total_i, total_u, pred = forward(*args)
            preds.append(pred.cpu())
            return total_i, total_u

        return keep

    with unittest.mock.patch.object(seg_eval, "make_seg_forward", make):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, miou = seg_eval.evaluate_benchmark(
            loader, model, tokenizer, classes, top_cls_num=10,
            dataset_name="pascal_voc", input_size=SIZE, max_length=25,
            bilateral_stride=STRIDE)
        torch.cuda.synchronize()
        counts = read_counts()
    print(f"{label}: evaluate_benchmark on {loader.batches * loader.batch_size} "
          f"images in {time.perf_counter() - t0:.3f} s, mIoU {miou:.6f}, "
          f"launches {counts}", flush=True)
    return miou, torch.cat(preds), counts


@contextlib.contextmanager
def one_process():
    """A rank's evaluation as one process's: the eval's collectives off
    (``evaluate_benchmark`` and the int8 broadcast ask ``is_distributed``)."""
    from simseg_tpu_torch.parallel import mesh
    from simseg_tpu_torch.tasks import seg_eval

    with contextlib.ExitStack() as stack:
        for module in (mesh, seg_eval):
            stack.enter_context(unittest.mock.patch.object(
                module, "is_distributed", lambda: False))
            stack.enter_context(unittest.mock.patch.object(module, "rank",
                                                           lambda: 0))
        yield


def quant_digest(model) -> str:
    import hashlib

    from simseg_tpu_torch.ops.quant import quant_layers

    h = hashlib.sha256()
    for name, m in sorted(quant_layers(model).items()):
        for k in ("weight_q", "w_scale", "x_absmax"):
            v = getattr(m, k)
            if v is not None:
                h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dist_eval(rank, result):
    """11c: ``evaluate_benchmark`` over the two ranks (3 batches of 16 a
    rank, 288 px, single-scale with the CRF kernel), float and int8_static
    image tower, against one process on both ranks' batches: mIoU within
    1e-3, predictions >= 99.9% equal; rank 1's int8 state bit-equal to
    rank 0's."""
    from simseg_tpu_torch.parallel import process_allgather

    model, tok, classes = slice_setup()
    lanes = {"float": model,
             "int8_static": lane_model(seeded_clip(0).state_dict(),
                                       image_arch=(("quant", "int8_static"),))}
    loaders = [SyntheticLoader(DIST_EVAL_BATCHES, BATCH, len(classes), seed=40 + r)
               for r in range(DIST_WORLD)]
    result["c"] = {}
    for lane, m in lanes.items():
        if rank == 0:
            with one_process():
                miou_1, pred_1, _ = recorded_eval(f"11c {lane}, one process",
                                                  ChainedLoader(loaders), m,
                                                  tok, classes)
        miou, pred, counts = recorded_eval(f"11c {lane}, rank {rank}",
                                           loaders[rank], m, tok, classes)
        check_counts(f"11c {lane} rank {rank}", counts,
                     {"crf_mean_field": DIST_EVAL_BATCHES})
        preds = process_allgather(pred.numpy())
        digests = process_allgather(np.frombuffer(bytes.fromhex(quant_digest(m)),
                                                  np.uint8))
        if rank == 0:
            agree = float((torch.from_numpy(preds.reshape(pred_1.shape))
                           == pred_1).float().mean())
            same_q = bool((digests == digests[0]).all())
            print(f"11c {lane}: mIoU over the ranks {miou:.6f} vs one process "
                  f"{miou_1:.6f} (difference {abs(miou - miou_1):.3e}); "
                  f"predictions equal on {agree:.6f} of pixels; int8 state "
                  f"bit-equal across the ranks {same_q}", flush=True)
            if abs(miou - miou_1) > 1e-3 or agree < 0.999 or not same_q:
                raise AssertionError(f"11c {lane}: the ranks' eval is not one "
                                     "process's")
        result["c"][lane] = dict(counts=counts, miou=miou)
    del lanes, model
    torch.cuda.empty_cache()


def dist_bsgs(tmp, rank, mesh, result):
    """11d: BSGS 512 / 64 a rank at 224 px against one process's BSGS
    1024 / 128: loss within 1e-2, the least tower cosine and norm bars of
    (b); 2 steps."""
    from simseg_tpu_torch.core.runner import CLIPRunner
    from simseg_tpu_torch.engine import bsgs
    from simseg_tpu_torch.models.clip import build_clip_model

    b, micro_1, micro = DIST_BSGS
    n = b // DIST_WORLD
    batch224, tok = caption_batch(13, b // 4, 224)
    batch = tiled_batch(batch224, b)
    cfg = train_cfg(tmp, "transforms.random_resize_crop.size=224",
                    "transforms.input_size=224", f"data.batch_size={b}",
                    f"data.batch_size_train={micro}", "runner.name=clip_bsgs",
                    *CUT_ARCH)
    torch.manual_seed(0)
    runner = CLIPRunner(cfg, build_clip_model(cfg), {"train": []},
                        device="cuda:0", tokenizer=tok)
    dev = runner._prepare_batch(batch)
    local = {k: v[rank * n:(rank + 1) * n] for k, v in dev.items()}
    if rank == 0:
        want_loss, want = bsgs_grads(runner.model, dev, b // micro_1)
    del dev
    metrics = bsgs.make_bsgs_grad_fn(runner.model, n // micro, mesh=mesh)(local)
    grads = {k: p.grad.detach().float().clone()
             for k, p in runner.model.named_parameters() if p.grad is not None}
    runner.model.zero_grad(set_to_none=True)
    if rank == 0:
        ok, text = dist_bars(f"11d BSGS {DIST_WORLD} ranks x {n} / {micro} vs one "
                             f"process {b} / {micro_1}, 224 px",
                             metrics["loss"].item(), grads, want_loss, want)
        print(text, flush=True)
        if not ok:
            raise AssertionError("11d: the ranks' BSGS gradient is not one "
                                 "process's")
        del want
    del grads, local
    torch.cuda.empty_cache()
    host = {"image": batch["image"][rank * n:(rank + 1) * n],
            "caption": batch["caption"][rank * n:(rank + 1) * n]}
    ms, red, staged, counts = dist_train_steps("11d", runner, host,
                                               DIST_BSGS_STEPS, rank)
    check_counts(f"11d rank {rank} (224 px takes no kernel)", counts, {})
    result["d"] = dict(ms=ms, reduce_ms=red, staged=staged,
                       images_per_s=b / ms * 1e3)
    del runner
    torch.cuda.empty_cache()


def run_rank_worker(out_dir):
    """One rank of phase 11 (b)-(d): gloo, on ``cuda:0`` beside the other
    rank; rank 0 also runs the one-process references. Writes its numbers
    to ``out_dir/rank<r>.json``."""
    from simseg_tpu_torch.parallel import init_distributed, make_mesh, rank

    init_distributed(backend="gloo", device="cuda:0", timeout=DIST_LIMIT)
    r, mesh = rank(), make_mesh()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist_plain_step(tmp, r, mesh, result)
        dist_eval(r, result)
        dist_bsgs(tmp, r, mesh, result)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(result, f)


def entry_log(path):
    """(losses, ms a step over steps 3-8) from a pretraining log: the
    log lines' timestamps (each step's line follows a device sync)."""
    import datetime
    import re

    stamps, losses = [], []
    with open(path, errors="replace") as f:
        for line in f:
            m = re.match(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) Epoch \[\d+/\d+\]"
                         r"\[(\d+)/\d+\].* loss: ([-\d.]+)", line)
            if m:
                stamps.append(datetime.datetime.strptime(
                    m.group(1), "%Y-%m-%d %H:%M:%S,%f"))
                losses.append(float(m.group(3)))
    if len(losses) != DIST_ENTRY_STEPS:
        raise AssertionError(f"11a: {len(losses)} step lines in {path}")
    ms = (stamps[-1] - stamps[1]).total_seconds() * 1e3 / (len(stamps) - 2)
    return losses, ms


ENTRY_HEADS = {"launcher": ["-m", "simseg_tpu_torch.launch", "--task", "clip",
                             "--nproc_per_node", "1"],
               "plain": ["-m", "simseg_tpu_torch.tasks.clip.train"]}


def entry_run(data, root, vocab, label, head):
    """One process (``head``: the launcher or the entry point) of 11a on
    phase 9's fixture: (losses, ms a step, checkpoint state, wall s)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cwd = os.path.join(root, label)
    os.makedirs(cwd)
    argv = ["--cfg", os.path.join(repo, ENTRY_YAML), "--vocab_file", vocab,
            f"data.data_path={data}/", f"ckpt.dir={cwd}/ckpt",
            "data.train_name=[synth]", "data.enable_valid=False",
            "data.batch_size=128", "data.num_workers=8",
            f"data.train_steps={DIST_ENTRY_STEPS}", "epoch=1",
            "ckpt.step_interval=-1", "log.interval_train=1",
            "transforms.train_transforms=[resize]", "transforms.resize.size=224",
            # the model at the crop's grid: a 288-px model interpolates its
            # position embeddings, and the bicubic backward's atomics make
            # two runs of one process differ in the last bits
            "transforms.input_size=224", *CUT_ARCH]
    log = os.path.join(cwd, "run.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, *head, *argv], cwd=cwd, env=env,
                            stdout=f, stderr=subprocess.STDOUT,
                            timeout=DIST_LIMIT).returncode
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log) as f:
            raise AssertionError(f"11a {label}: rc {rc}\n{f.read()[-3000:]}")
    losses, ms = entry_log(log)
    ckpt = os.path.join(cwd, "ckpt", "simseg_eval")
    with open(os.path.join(ckpt, "latest_ckpt")) as f:
        state = torch.load(os.path.join(ckpt, f.read().strip(), "train_state.pt"),
                           map_location="cpu", weights_only=True)
    print(f"11a {label}: {DIST_ENTRY_STEPS} steps of 128 in {wall:.1f} s, "
          f"losses {losses}, {ms:.1f} ms a step (steps 3-8, log stamps)",
          flush=True)
    return losses, ms, state, wall


def state_diff(a, b):
    """[(name, largest absolute difference)] of the tensors that differ
    between two checkpoints' parameters and AdamW states."""
    pairs = [(k, a["model"][k], v) for k, v in b["model"].items()]
    pairs += [(f"adam {i} {k}", a["optimizer"]["base"]["state"][i][k], t)
              for i, s in b["optimizer"]["base"]["state"].items()
              for k, t in s.items()]
    diff = [(k, (x.double() - y.double()).abs().max().item())
            for k, x, y in pairs if not torch.equal(x, y)]
    return diff


def dist_entry(data, root, vocab):
    """11a: the pretraining entry point at world 1 through the launcher
    (NCCL) and without it, as two processes run at once: the vit-b YAML at 224 px (the
    deterministic resize, the model at 224 px, 8 decode threads), batch
    128, 8 steps; the
    checkpoints (parameters and AdamW's state) bit-equal, the logged losses
    equal; ms a step of both."""
    with ThreadPoolExecutor(len(ENTRY_HEADS)) as pool:
        jobs = {label: pool.submit(entry_run, data, root, vocab, label, head)
                for label, head in ENTRY_HEADS.items()}
        runs = {label: job.result() for label, job in jobs.items()}
    if not os.path.exists(os.path.join(root, "launcher", "output",
                                       "simseg.vit-b_log.txt")):
        raise AssertionError("11a: the launcher wrote no log file")
    (la, ms_l, sl, _), (lp, ms_p, sp, _) = runs["launcher"], runs["plain"]
    diff = state_diff(sl, sp)
    same = la == lp and sl["step"] == sp["step"] and not diff
    print(f"11a world 1 (NCCL) through the launcher vs the entry point alone: "
          f"parameters and AdamW's state bit-equal after {DIST_ENTRY_STEPS} "
          f"steps {same} (differing tensors: {diff[:6]}); "
          f"{ms_l:.1f} vs {ms_p:.1f} ms a step (the world's gather and "
          f"gradient reduction included)", flush=True)
    if not same:
        raise AssertionError("11a: the world of one differs from one process")
    return {"ms": ms_l, "plain_ms": ms_p, "images_per_s": 128 / ms_l * 1e3,
            "plain_images_per_s": 128 / ms_p * 1e3}


def world1_reduction_ms(reps=5):
    """ms of ``reduce_gradients`` over the flagship's float32 gradients
    (ViT-B/16 + BERT-base, 0.8 GB) in a world of one NCCL rank, this
    process (CUDA events, the mean of ``reps`` after a warm-up)."""
    import torch.distributed as dist

    from simseg_tpu_torch.launch import free_port
    from simseg_tpu_torch.parallel import collectives

    params = list(seeded_clip(0).cuda().parameters())
    for p in params:
        p.grad = torch.randn_like(p)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        want = [p.grad.clone() for p in params]
        ms = cuda_ms(lambda: collectives.reduce_gradients(params), reps)
        if not all(torch.equal(p.grad, w) for p, w in zip(params, want)):
            raise AssertionError("11a: a sum over one rank changed a gradient")
    finally:
        dist.destroy_process_group()
    del params, want
    torch.cuda.empty_cache()
    return ms


def run_distributed():
    """Phase 11: returns each kernel's launches per rank in (b) and (c)."""
    from simseg_tpu_torch.launch import free_port

    card = card_line()
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    data, vocab = train_entry_fixture()
    with tempfile.TemporaryDirectory() as root:
        # (b)-(d)'s ranks run while 11a's two processes do: the card has
        # room for all four, and each is held back by its host
        out = os.path.join(root, "ranks")
        os.makedirs(out)
        port = free_port()
        procs = []
        for r in range(DIST_WORLD):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK="0",
                       WORLD_SIZE=str(DIST_WORLD), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker", out],
                env=env))
        try:
            entry = dist_entry(data, root, vocab)
            entry["reduce_ms"] = world1_reduction_ms()
            rcs = [p.wait(timeout=DIST_LIMIT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rcs != [0] * DIST_WORLD:
            raise AssertionError(f"11: the ranks exited {rcs}")
        ranks = []
        for r in range(DIST_WORLD):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    print(f"11a ({card}): the entry point at world 1 through the launcher "
          f"{entry['images_per_s']:.1f} images/s ({entry['ms']:.1f} ms a step), "
          f"alone {entry['plain_images_per_s']:.1f} ({entry['plain_ms']:.1f} ms), "
          f"launcher - alone {entry['ms'] - entry['plain_ms']:+.1f} ms a step "
          f"(host-bound steps); the gradient reduction alone at world 1 (NCCL) "
          f"{entry['reduce_ms']:.3f} ms a step", flush=True)
    for part, what in (("b", f"plain step, {DIST_WORLD} x {DIST_RANK_BATCH} at "
                             f"{TRAIN_SIZE} px, {CUT_DEPTH} blocks a tower"),
                       ("d", f"BSGS {DIST_WORLD} x {DIST_BSGS[0] // DIST_WORLD} / "
                             f"{DIST_BSGS[2]} at 224 px, {CUT_DEPTH} blocks "
                             "a tower")):
        for r, res in enumerate(ranks):
            x = res[part]
            print(f"11{part} rank {r} ({card}): {what}: {x['images_per_s']:.1f} "
                  f"images/s ({x['ms']:.1f} ms a step), gradient reduction "
                  f"{x['reduce_ms']:.1f} ms a step, {x['staged'] / 2**20:.1f} MiB "
                  f"staged through the host a step; {DIST_NOTE}", flush=True)
    print(f"11 phase in {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"flash_attention": [r["b"]["counts"]["flash_attention"] for r in ranks],
            "flash_attention_bwd": [r["b"]["counts"]["flash_attention_bwd"]
                                    for r in ranks],
            "crf_mean_field": [r["c"]["float"]["counts"]["crf_mean_field"]
                               for r in ranks]}


# -- phase 12: the linear probe and the CNN towers --------------------------------

PROBE_YAML = "configs/linear_prob/imagenet.yaml"
PROBE_CLASSES = 10
PROBE_TRAIN, PROBE_VAL = 48, 16            # JPEGs a class
PROBE_BATCH = 128
PROBE_LOGITS = 16                          # (a): card against the CPU
PROBE_COS_BAR = 0.9999
PROBE_MICRO, PROBE_ACCUM = 2048, 8         # (b): 8 x 2048 = the YAML's 16,384
PROBE_WHOLE = (16384, 8192, 4096)          # (b): one batch, largest first
CNN_TAGS = ("resnet50", "convnext_tiny", "efficientnet_b0")
CNN_BATCH = 8
CNN_COS_BAR = 0.9999
CNN_ERR_BAR = 1e-3                         # x the CPU map's largest entry
CNN_PROBE_STEPS = 3
CNN_SEG_BATCHES = 3
CNN_STRIDE = 32
BN_CHECK = (4, 64)   # (e): batch, px; the last stage's 2 x 2 map: n = 16
BN_STATS_BAR = 1e-4  # x each buffer's largest entry; n / (n - 1) moves a var 0.7%
BN_TRAIN = (32, 224, 3)                    # (e): batch, px, steps


def repo_path(rel):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def write_probe_fixture(root):
    """``root/{train,val}/<class>/<n>.JPEG``: PROBE_TRAIN and PROBE_VAL
    photos a class at four sizes, JPEG quality 90."""
    from PIL import Image

    rng = np.random.default_rng(15)
    sizes = ((240, 320), (300, 300), (375, 500), (333, 500))
    for split, n in (("train", PROBE_TRAIN), ("val", PROBE_VAL)):
        for c in range(PROBE_CLASSES):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            for i in range(n):
                h, w = sizes[(c + i) % len(sizes)]
                Image.fromarray(synth_photo(rng, h, w)).save(
                    os.path.join(d, f"{i:04d}.JPEG"), quality=90)


def probe_cfg(*overrides):
    """The linear-probe YAML with dotted overrides."""
    from simseg_tpu_torch.config import new_base_cfg, update_cfg
    from simseg_tpu_torch.tasks.linear_prob.config import (task_cfg_init_fn,
                                                           update_linear_config)

    return update_cfg(task_cfg_init_fn, repo_path(PROBE_YAML), list(overrides),
                      preprocess_fn=update_linear_config, target=new_base_cfg())


def probe_model(cfg, pth, seed=0):
    """The probe of ``cfg`` on the card, its tower from the ``.pth``."""
    from simseg_tpu_torch.checkpoint.torch_bridge import load_clip_checkpoint
    from simseg_tpu_torch.models.linear_prob import build_linear_prob_model

    torch.manual_seed(seed)
    model = build_linear_prob_model(cfg)
    if pth:
        load_clip_checkpoint(pth, model, only_image_encoder=True)
    return model.cuda()


class ProbeSteps:
    """Wraps ``LinearProbRunner.batch_processor``: each step's loss, its CUDA
    events and its batch on the card."""

    def __init__(self):
        self.losses, self.events, self.batches = [], [], []

    def patch(self):
        from simseg_tpu_torch.core.runner import LinearProbRunner

        inner = LinearProbRunner.batch_processor

        def wrapped(runner, batch, device_batch=None):
            if device_batch is None:
                device_batch = runner._prepare_batch(batch)
            self.batches.append(dict(device_batch))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(runner, batch, device_batch)
            end.record()
            self.events.append((start, end))
            self.losses.append(out["loss"])
            return out

        return unittest.mock.patch.object(LinearProbRunner, "batch_processor",
                                          wrapped)

    def ms(self, first):
        """Mean ms a step from the start of step ``first + 1`` to the end of
        the last, host stalls between steps included."""
        torch.cuda.synchronize()
        timed = self.events[first:]
        return timed[0][0].elapsed_time(timed[-1][1]) / len(timed)


def probe_entry(root, pth, card):
    """12a: ``tasks.linear_prob.train.main`` on the YAML and the class folders."""
    import copy

    from simseg_tpu_torch.data.datasets import build_imagenet_dataloaders
    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.models.linear_prob import build_linear_prob_model
    from simseg_tpu_torch.tasks.linear_prob import train as entry

    out = tempfile.mkdtemp()
    overrides = [f"data.data_path={root}/", f"model.classifier.num_classes={PROBE_CLASSES}",
                 f"data.batch_size={PROBE_BATCH}", "epoch=2", f"ckpt.dir={out}",
                 f"ckpt.external_resume={pth}", "ckpt.only_load_image_encoder=True"]
    steps = ProbeSteps()
    seeded = {k: v for k, v in torch.load(pth)["state_dict"].items()
              if k.startswith("image_encoder.")}
    reset_counts()
    t0 = time.perf_counter()
    with steps.patch():
        runner = entry.main(["--cfg", repo_path(PROBE_YAML)] + overrides)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts("12a probe entry point (T = 197: no attention kernel)", counts, {})
    per_epoch = PROBE_CLASSES * PROBE_TRAIN // PROBE_BATCH
    losses = [x.item() for x in steps.losses]
    if len(losses) != 2 * per_epoch or not all(np.isfinite(losses)):
        raise AssertionError(f"12a: losses {losses}")
    state = runner.model.state_dict()
    changed = [k for k, v in seeded.items() if not torch.equal(state[k].cpu(), v)]
    if changed:
        raise AssertionError(f"12a: frozen tower moved: {changed[:4]}")
    cfg = runner.cfg
    torch.manual_seed(int(cfg.seed or 0))
    init = build_linear_prob_model(cfg).classifier.weight
    if torch.equal(runner.model.classifier.weight.detach().cpu(), init.detach()):
        raise AssertionError("12a: the classifier did not move")
    acc = runner.state.get("linear_eval")
    if not acc or set(acc) != {"acc1", "acc5"}:
        raise AssertionError(f"12a: no top-1 / top-5 logged: {acc}")
    # the card's float32 logits against the CPU's on PROBE_LOGITS val images
    val = next(iter(build_imagenet_dataloaders(cfg)["val"][0]))
    images = normalize_images(torch.as_tensor(val["image"][:PROBE_LOGITS]))
    f32 = copy.deepcopy(runner.model)
    f32.image_tower.compute_dtype = None
    f32.eval()
    with torch.no_grad():
        card_logits = f32({"image": images.cuda()}).cpu()
        cpu_logits = f32.cpu()({"image": images})
    cos = min_token_cosine(card_logits, cpu_logits)
    print(f"12a probe logits, float32, card vs CPU on {PROBE_LOGITS} val "
          f"images: least row cosine {cos:.8f}", flush=True)
    if cos < PROBE_COS_BAR:
        raise AssertionError(f"12a: logits cosine {cos} < {PROBE_COS_BAR}")
    del f32
    entry_ms = steps.ms(per_epoch)          # epoch 2's steps
    # the same batches in memory, through the same runner
    memory = ProbeSteps()
    with memory.patch():
        for b in steps.batches[per_epoch:]:
            runner.batch_processor(None, b)
    mem_ms = memory.ms(1)
    print(f"12a probe entry point ({card}): {wall:.1f} s for 2 epochs of "
          f"{per_epoch} steps + 2 validations; losses {[round(x, 4) for x in losses]}; "
          f"top-1 {acc['acc1']:.4f} top-5 {acc['acc5']:.4f}; epoch 2 "
          f"{entry_ms:.3f} ms a step = {PROBE_BATCH / entry_ms * 1e3:.1f} "
          f"images/s through the entry point, {mem_ms:.3f} ms = "
          f"{PROBE_BATCH / mem_ms * 1e3:.1f} images/s in memory; the loader's "
          f"share {1 - mem_ms / entry_ms:.3f}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    del runner
    torch.cuda.empty_cache()


def probe_in_memory(label, pth, b, steps, timed_from, *extra):
    """12b: a LinearProbRunner over one batch of b random images (224 px,
    1000 classes) on the card, ``steps`` steps: (ms a step over the steps
    after ``timed_from``, peak GiB, runner)."""
    from simseg_tpu_torch.core.runner import LinearProbRunner

    cfg = probe_cfg(f"data.batch_size={b}", f"ckpt.dir={tempfile.gettempdir()}",
                    *extra)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runner = LinearProbRunner(cfg, probe_model(cfg, pth), {"train": []},
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(b)
    batch = {"image": torch.randint(0, 256, (b, 224, 224, 3), dtype=torch.uint8,
                                    device="cuda", generator=gen),
             "label": torch.randint(0, 1000, (b,), device="cuda", generator=gen)}
    rec = ProbeSteps()
    with rec.patch():
        for _ in range(steps):
            runner.batch_processor(batch)
            runner.step += 1
    ms = rec.ms(timed_from)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [x.item() for x in rec.losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"12b {label}: losses {losses}")
    return ms, peak, runner


def probe_big_batch(pth, card):
    """12b: the YAML's batch of 16,384 as 8 x 2048 through
    ``optim.grad_accum_steps``, and whole where it fits."""
    steps = 2 * PROBE_ACCUM
    ms, peak, runner = probe_in_memory(
        "8 x 2048", pth, PROBE_MICRO, steps, PROBE_ACCUM,
        f"optim.grad_accum_steps={PROBE_ACCUM}")
    if runner.optimizer.mini_step != 0 or runner.step != steps:
        raise AssertionError(f"12b: mini-step {runner.optimizer.mini_step}")
    print(f"12b probe, the YAML's batch as {PROBE_ACCUM} x {PROBE_MICRO} "
          f"(grad_accum_steps, {card}): {ms:.3f} ms a step of {PROBE_MICRO} "
          f"(the last {PROBE_ACCUM} of {steps}: one update) = "
          f"{PROBE_MICRO / ms * 1e3:.1f} images/s, "
          f"{PROBE_ACCUM * ms:.1f} ms an update of {PROBE_ACCUM * PROBE_MICRO}; "
          f"peak {peak:.3f} GiB", flush=True)
    del runner
    for b in PROBE_WHOLE:
        try:
            ms, peak, runner = probe_in_memory(f"whole {b}", pth, b, 2, 1)
        except torch.cuda.OutOfMemoryError:
            print(f"12b probe, one batch of {b}: out of memory on the card",
                  flush=True)
            torch.cuda.empty_cache()
            continue
        del runner
        torch.cuda.empty_cache()
        print(f"12b probe, one batch of {b} ({card}): {ms:.3f} ms a step = "
              f"{b / ms * 1e3:.1f} images/s; peak {peak:.3f} GiB"
              + ("" if b == PROBE_WHOLE[0] else
                 f" (the largest batch that fits; {PROBE_WHOLE[0]} does not)"),
              flush=True)
        return
    raise AssertionError("12b: no whole batch fits")


def calibrate_bn(model, images):
    """Every BatchNorm's running statistics set to one batch's (momentum 0
    for a live-BN forward), so that a seeded CNN's maps stay on scale."""
    from simseg_tpu_torch.models.layers import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.momentum = 0.0
    with torch.no_grad():
        model(images, train_bn=True)
    for m in bns:
        m.momentum = 0.9


def seeded_cnn(tag, seed):
    """A CNN tower on the CPU in float32: torch's default initialisation
    under ``seed``, BN statistics calibrated on synthetic scenes."""
    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.models.cnn import build_cnn

    torch.manual_seed(seed)
    model = build_cnn(tag)
    images, _ = synthetic_scenes(np.random.default_rng(seed), 8, 224, 21)
    calibrate_bn(model, normalize_images(torch.from_numpy(images)))
    return model.eval()


@contextlib.contextmanager
def no_tf32():
    """cuDNN's convolutions in full float32 (its TF32 default off)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def check_cnn_towers(card):
    """12c: each CNN family at 224 px, float32, card against the CPU."""
    import copy

    from simseg_tpu_torch.data.transforms import normalize_images

    images, _ = synthetic_scenes(np.random.default_rng(3), CNN_BATCH, 224, 21)
    x = normalize_images(torch.from_numpy(images))
    xc = x.cuda()
    for tag in CNN_TAGS:
        cpu = seeded_cnn(tag, 1)
        with torch.no_grad():
            want = cpu(x)
            gpu = copy.deepcopy(cpu).cuda()
            with no_tf32():
                got = gpu(xc).cpu()
            ms = cuda_ms(lambda: gpu(xc), 5)
            gpu.compute_dtype = torch.bfloat16
            bf16_ms = cuda_ms(lambda: gpu(xc), 5)
        cos = min_token_cosine(got.flatten(1), want.flatten(1))
        err = (got - want).abs().max().item() / want.abs().max().item()
        print(f"12c {tag} ({card}): map {tuple(got.shape)}, float32 card vs CPU "
              f"least cosine {cos:.8f}, max abs error {err:.3e} x the largest "
              f"entry; forward at batch {CNN_BATCH} {ms:.3f} ms float32 (TF32 "
              f"allowed), {bf16_ms:.3f} ms bf16", flush=True)
        if cos < CNN_COS_BAR or err > CNN_ERR_BAR:
            raise AssertionError(f"12c {tag}: cosine {cos}, error {err}")
        del gpu, cpu


def check_cnn_probe(card):
    """12c: a frozen ResNet-50 probe, batch 128, bf16, the YAML's LARS: the
    running statistics bit-unchanged, the classifier moved."""
    from simseg_tpu_torch.core.runner import LinearProbRunner

    cfg = probe_cfg("model.image_encoder.tag=resnet50",
                    f"data.batch_size={PROBE_BATCH}",
                    f"ckpt.dir={tempfile.gettempdir()}")
    model = probe_model(cfg, None)
    model.image_tower.load_state_dict(seeded_cnn("resnet50", 1).state_dict())
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    w0 = model.classifier.weight.detach().clone()
    runner = LinearProbRunner(cfg, model, {"train": []}, device="cuda")
    images, _ = synthetic_scenes(np.random.default_rng(4), PROBE_BATCH, 224, 21)
    batch = {"image": torch.from_numpy(images).cuda(),
             "label": torch.arange(PROBE_BATCH, device="cuda") % 1000}
    rec = ProbeSteps()
    reset_counts()
    with rec.patch():
        for _ in range(CNN_PROBE_STEPS):
            runner.batch_processor(batch)
            runner.step += 1
    check_counts("12c ResNet-50 probe", read_counts(), {})
    losses = [x.item() for x in rec.losses]
    moved = [k for k, v in stats.items() if not torch.equal(model.state_dict()[k], v)]
    if moved or not all(np.isfinite(losses)) or torch.equal(
            model.classifier.weight.detach(), w0):
        raise AssertionError(f"12c probe: losses {losses}, statistics moved {moved[:4]}")
    print(f"12c ResNet-50 probe, batch {PROBE_BATCH}, bf16 ({card}): "
          f"{rec.ms(1):.3f} ms a step (steps 2-{CNN_PROBE_STEPS}), losses "
          f"{[round(x, 4) for x in losses]}; {len(stats)} running statistics "
          "bit-unchanged", flush=True)


def seeded_cnn_clip(seed, img_size, tag="resnet50", compute_dtype=None):
    """CLIP with a CNN image tower and BERT-base on the card, float32
    parameters computing in ``compute_dtype``: the CNN as ``seeded_cnn``,
    the rest as ``seeded_clip``."""
    from simseg_tpu_torch.models.clip import CLIPModel

    model = CLIPModel(img_size=img_size, compute_dtype=compute_dtype,
                      **{**FLAGSHIP, "image_tag": tag})
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2 and not name.startswith("image_encoder."):
                p.normal_(0.0, 0.02, generator=gen)
    model.image_tower.load_state_dict(seeded_cnn(tag, seed).state_dict())
    return model.cuda()


def crf_x32_times(model, loader, text_bank, classes):
    """12d: rows 1-2 at the x32 shape on one batch's features, and at the
    main path's x16 shape (phase 3's inputs): event ms of each."""
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.morphology import nearest_upsample
    from simseg_tpu_torch.ops.seg_decode import coarse_unary, shortlist
    from simseg_tpu_torch.tasks.seg_eval import make_seg_features

    images = torch.from_numpy(next(iter(loader))["image"]).cuda()
    dense, pooled = make_seg_features(model, input_size=SIZE)(images)
    with torch.no_grad():
        idx, scores, valid = shortlist(pooled, text_bank, 10, CLASSES_PER_IMAGE)
        du_c = coarse_unary(dense, text_bank, idx, SIZE // CNN_STRIDE)
    du = nearest_upsample(du_c, CNN_STRIDE).contiguous()
    eff = torch.where(valid, scores, torch.zeros_like(scores))
    kw = dict(stride=STRIDE, num_iters=ITERS, closing_ksize=CLOSING)
    du16, rgb16 = crf_inputs(BATCH)
    tail16 = tail_inputs()
    ms = {"x32": (cuda_ms(lambda: crf_fused.mean_field_fused(du, images, **kw), 10),
                  cuda_ms(lambda: crf_fused.seg_decode_tail_fused(
                      du_c, images, eff, idx, CNN_STRIDE, **kw), 10)),
          "x16": (cuda_ms(lambda: crf_fused.mean_field_fused(du16, rgb16, **kw), 10),
                  cuda_ms(lambda: crf_fused.seg_decode_tail_fused(
                      *tail16, PATCH, **kw), 10))}
    for shape, (mf, tail) in ms.items():
        grid = SIZE // (CNN_STRIDE if shape == "x32" else PATCH)
        print(f"12d rows 1-2 at {BATCH} x {CLASSES_PER_IMAGE} x {SIZE}^2, "
              f"unaries {grid}x{grid} {shape}: crf_mean_field {mf:.4f} ms, "
              f"seg_decode_tail {tail:.4f} ms (events)", flush=True)
    return ms


def check_cnn_seg(card, tokenizer, classes):
    """12d: CLIP with a ResNet-50 tower through ``evaluate_benchmark`` at
    288 px in the auto, fused_tail and xla lanes: returns rows 1-2's
    launches."""
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
    from simseg_tpu_torch.tasks.seg_eval import (image_patch_stride,
                                                 make_seg_features,
                                                 zero_shot_classifier)

    model = seeded_cnn_clip(5, SIZE).to(torch.bfloat16).eval()
    if image_patch_stride(model) != CNN_STRIDE:
        raise AssertionError(f"12d: grid step {image_patch_stride(model)}")
    loader = SyntheticLoader(CNN_SEG_BATCHES, BATCH, len(classes), 21)
    want = {"auto": {"crf_mean_field": CNN_SEG_BATCHES},
            "fused_tail": {"seg_decode_tail": CNN_SEG_BATCHES}, "xla": {}}
    counts = {}
    for lane, lane_want in want.items():
        counts[lane] = drive_eval(f"12d ResNet-50 seg eval, crf_backend={lane}",
                                  loader, model, tokenizer, classes,
                                  input_size=SIZE, crf_backend=lane)
        check_counts(f"12d {lane}", counts[lane], lane_want)
    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    images = torch.from_numpy(next(iter(loader))["image"]).cuda()
    dense, pooled = make_seg_features(model, input_size=SIZE)(images)
    if dense.shape[1] != (SIZE // CNN_STRIDE) ** 2:
        raise AssertionError(f"12d: {dense.shape[1]} tokens")
    preds = {}
    for lane in want:
        decode = make_seg_decode_fn(num_classes=len(classes), image_size=SIZE,
                                    patch_size=CNN_STRIDE, top_cls_num=10,
                                    bilateral_stride=STRIDE, crf_backend=lane)
        with torch.no_grad():
            preds[lane] = decode(dense, pooled, text_bank, images)[0]
    for lane in ("auto", "fused_tail"):
        agree = (preds[lane] == preds["xla"]).float().mean().item()
        print(f"12d {lane} vs the unfused chain (xla) at x32: pred agreement "
              f"{agree:.6f}", flush=True)
        if agree < 0.999:
            raise AssertionError(f"12d {lane}: agreement {agree} < 0.999")
    bad = make_seg_decode_fn(num_classes=len(classes), image_size=SIZE,
                             patch_size=PATCH, top_cls_num=10,
                             bilateral_stride=STRIDE)
    try:
        bad(dense, pooled, text_bank, images)
    except ValueError as e:
        print(f"12d planted fault (the decode at stride {PATCH} on "
              f"{dense.shape[1]} tokens) raised: {e}", flush=True)
    else:
        raise AssertionError("12d: the stride-16 decode took the CNN's tokens")
    crf_x32_times(model, loader, text_bank, classes)
    del model
    torch.cuda.empty_cache()
    return {"crf_mean_field": counts["auto"]["crf_mean_field"],
            "seg_decode_tail": counts["fused_tail"]["seg_decode_tail"]}


def bn_witness(model, batch):
    """{buffer name: the running statistic flax's update gives} of one
    live-BN forward of ``model`` (float32, on its device) on ``batch``: each
    BatchNorm's input captured, its biased statistics in float64."""
    from simseg_tpu_torch.engine.train_step import clip_loss_fn
    from simseg_tpu_torch.models.layers import BatchNorm

    want, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            def hook(mod, args, name=name):
                x = args[0].detach().double()
                mean = x.mean((0, 2, 3))
                var = (x * x).mean((0, 2, 3)) - mean * mean
                want[f"{name}.running_mean"] = (
                    0.9 * mod.running_mean.double() + 0.1 * mean)
                want[f"{name}.running_var"] = (
                    0.9 * mod.running_var.double() + 0.1 * var)
            hooks.append(m.register_forward_pre_hook(hook))
    try:
        with torch.no_grad():
            clip_loss_fn(model, batch, bn_training=True)
    finally:
        for h in hooks:
            h.remove()
    return want


def bn_error(model, want):
    """The largest |running statistic - witness| over each buffer's largest
    witness entry."""
    state = model.state_dict()
    return max(((state[k].double().cpu() - w.cpu()).abs().max()
                / w.abs().max().clamp_min(1e-30)).item() for k, w in want.items())


def unbiased_bn_forward(self, x, train_bn=False):
    """The planted fault: PyTorch's training-mode update (the unbiased
    variance, momentum 0.1 for flax's 0.9)."""
    import torch.nn.functional as F

    return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                        self.bias, train_bn, 1.0 - self.momentum, self.eps)


def whole_tower_cosines(grads, want):
    """{tower: cosine of all its gradients, concatenated, against ``want``}.
    One tensor's cosine can dip where a ReLU's input lies within rounding of
    0 and its gate differs between the two devices (at n = 16 values a
    channel, one flip moves a BN scale's gradient by a sixteenth)."""
    import torch.nn.functional as F

    out = {}
    for tower in ("image_encoder.", "text_encoder."):
        names = [n for n in want if n.startswith(tower)]
        a = torch.cat([grads[n].flatten() for n in names]).double()
        b = torch.cat([want[n].flatten() for n in names]).double()
        out[tower[:-1]] = F.cosine_similarity(a, b, dim=0).item()
    return out


def bn_step(model, batch):
    """(loss, {name: grad}) of one live-BN forward/backward."""
    from simseg_tpu_torch.engine.train_step import clip_loss_fn

    model.zero_grad(set_to_none=True)
    loss, _ = clip_loss_fn(model, batch, bn_training=True)
    loss.backward()
    grads = {n: p.grad.detach().float().cpu().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def check_live_bn(card):
    """12e: CLIP with ResNet-50 + BERT-base training its BN live."""
    import copy

    from simseg_tpu_torch.core.runner import CLIPRunner
    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.models.layers import BatchNorm

    b, size = BN_CHECK
    raw, tok = caption_batch(17, b, size)
    enc = tok(list(raw["caption"]), max_length=25)
    host = {"image": normalize_images(torch.from_numpy(raw["image"])),
            "input_ids": torch.as_tensor(np.asarray(enc["input_ids"])).long(),
            "attention_mask": torch.as_tensor(np.asarray(enc["attention_mask"])).long()}
    card_batch = {k: v.cuda() for k, v in host.items()}
    base = seeded_cnn_clip(6, size).cpu()
    cpu, gpu, fault = base, copy.deepcopy(base).cuda(), copy.deepcopy(base).cuda()
    with no_tf32():
        want = bn_witness(copy.deepcopy(gpu), card_batch)
        cpu_loss, cpu_grads = bn_step(cpu, host)
        loss, grads = bn_step(gpu, card_batch)
        with unittest.mock.patch.object(BatchNorm, "forward", unbiased_bn_forward):
            bn_step(fault, card_batch)
    err, fault_err = bn_error(gpu, want), bn_error(fault, want)
    cos = whole_tower_cosines(grads, cpu_grads)
    rel = abs(loss - cpu_loss) / abs(cpu_loss)
    print(f"12e live BN, float32, batch {b} at {size} px: running statistics "
          f"vs flax's biased witness {err:.3e} (bar {BN_STATS_BAR}); planted "
          f"fault, PyTorch's unbiased update, {fault_err:.3e}; loss card "
          f"{loss:.6f} vs CPU {cpu_loss:.6f} (rel {rel:.2e}); gradient cosine "
          f"by tower {cos}, least of one tensor "
          f"{tower_cosines(grads, cpu_grads)}", flush=True)
    if err > BN_STATS_BAR or fault_err < 10 * BN_STATS_BAR:
        raise AssertionError(f"12e: statistics error {err}, fault {fault_err}")
    if rel > 1e-4 or any(c < CNN_COS_BAR for c in cos.values()):
        raise AssertionError(f"12e: loss rel {rel}, cosines {cos}")
    del cpu, gpu, fault, base
    # 3 steps at 224 px, bf16, through the CLIP runner
    b, size, steps = BN_TRAIN
    cfg = train_cfg(tempfile.gettempdir(), "model.image_encoder.tag=resnet50",
                    f"transforms.input_size={size}", f"data.batch_size={b}")
    model = seeded_cnn_clip(7, size, compute_dtype=torch.bfloat16)
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    runner = CLIPRunner(cfg, model, {"train": []}, device="cuda", tokenizer=tok)
    batch = tiled_batch(caption_batch(18, b, size)[0], b)
    timer = StepTimer()
    reset_counts()
    with timer.patch():
        for _ in range(steps):
            runner.batch_processor(batch)
            runner.step += 1
    check_counts("12e live-BN CLIP steps", read_counts(), {})
    losses = [x.item() for x in timer.losses]
    moved = sum(not torch.equal(model.state_dict()[k], v) for k, v in stats.items())
    if not all(np.isfinite(losses)) or moved != len(stats):
        raise AssertionError(f"12e: losses {losses}, {moved} of {len(stats)} moved")
    ms, inside = timer.ms_per_step(warmup=1)
    print(f"12e ResNet-50 + BERT-base, live BN, {steps} steps at batch {b}, "
          f"{size} px, bf16 ({card}): {ms:.3f} ms a step (steps 2-{steps}) = "
          f"{b / ms * 1e3:.1f} images/s; losses {[round(x, 4) for x in losses]}; "
          f"all {len(stats)} running statistics moved", flush=True)
    del runner, model
    torch.cuda.empty_cache()


def run_linear_probe(tokenizer=None, classes=None):
    """Phase 12: returns rows 1-2's launches in 12d's auto and fused_tail
    lanes."""
    card = card_line()
    t_start = time.perf_counter()
    if tokenizer is None:
        _, tokenizer, classes = slice_setup()
    with tempfile.TemporaryDirectory() as root:
        pth = os.path.join(root, "vit_b16_224.pth")
        torch.save({"state_dict": seeded_clip(8, 224).state_dict()}, pth)
        probe_entry(fixtures()[2], pth, card)
        probe_big_batch(pth, card)
    check_cnn_towers(card)
    check_cnn_probe(card)
    launches = check_cnn_seg(card, tokenizer, classes)
    check_live_bn(card)
    print(f"12 launches of rows 1-2 in the ResNet-50 seg eval ({card}): "
          f"{launches}; phase 12 in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return launches


# -- phase 13: serving export ----------------------------------------------------
SERVE_YAML = ENTRY_YAML
SERVE_LIMIT = 600                         # seconds the loading process may take
SERVE_DEVICES = ["cuda:0", "cuda:0"]      # (f): the split logic on one card
# the artifacts: name -> (kind, batch, weights, overrides, batches run,
# exact launches over them); (c) is bench.py's default lane
SERVE_ARTIFACTS = {
    "a": ("seg", BENCH_BATCH, "baked", (), 3, {"crf_mean_field": 3}),
    "b_scales_tail": ("seg", BATCH, "baked", (
        "seg_eval.scales=[1.0,2.0]", "seg_eval.crf_backend=fused_tail"), 2,
        {"flash_attention": 2 * CUT_DEPTH, "lane_flash": 2 * CUT_DEPTH,
         "seg_decode_tail": 2}),
    "b_window": ("seg", BATCH, "baked", (
        f"transforms.input_size={WIN_INPUT}", f"seg_eval.window.size={WIN}",
        f"seg_eval.window.stride={WIN_STRIDE}"), 2, {"bilateral_matvec": 8}),
    "c": ("seg", BENCH_BATCH, "baked", (
        "model.image_encoder.arch={'tome_r': 16, 'quant': 'int8_static', "
        f"'depth': {CUT_DEPTH}}}",),
        2, {"crf_mean_field": 2}),
    "d": ("seg", BENCH_BATCH, "separate", (), 2, {"crf_mean_field": 2}),
    "e": ("retrieval", BENCH_BATCH, "baked", (), 2, {}),
    # phase 16: the default lane in the TPU kernels' bf16 mode
    "g_bf16": ("seg", BATCH, "baked", ("seg_eval.crf_dtype=bfloat16",), 2,
               {"crf_mean_field_bf16": 2}),
}
COUNT_MODULES = {"crf_mean_field": ("crf_fused", "LAUNCHES"),
                 "seg_decode_tail": ("crf_fused", "TAIL_LAUNCHES"),
                 "crf_mean_field_bf16": ("crf_fused", "BF16_LAUNCHES"),
                 "seg_decode_tail_bf16": ("crf_fused", "BF16_TAIL_LAUNCHES"),
                 "flash_attention": ("flash_attention", "LAUNCHES"),
                 "flash_attention_bwd": ("flash_attention", "BWD_LAUNCHES"),
                 "bilateral_matvec": ("crf_pallas", "LAUNCHES")}


def serve_inputs(name, kind, batch, size, batches):
    """The seeded inputs of an artifact: ``batches`` tuples of host tensors
    (uint8 images; for retrieval also token ids and masks)."""
    # (d) is held against (a) on the same images
    seed = sorted(SERVE_ARTIFACTS).index({"d": "a"}.get(name, name))
    rng = np.random.default_rng([1300, seed])
    out = []
    for _ in range(batches):
        images = torch.from_numpy(synthetic_scenes(rng, batch, size, 21)[0])
        if kind == "seg":
            out.append((images,))
        else:
            ids = torch.from_numpy(rng.integers(5, 500, (batch, 25)))
            out.append((images, ids, torch.ones_like(ids)))
    return out


def worker_counts():
    """The launch counts, read from the op modules that loading an artifact
    imported (the worker imports nothing of the port but ``serving``)."""
    mods = {m: sys.modules[f"simseg_tpu_torch.ops.{m}"]
            for m in ("crf_fused", "crf_pallas", "flash_attention")}
    counts = {k: getattr(mods[m], a) for k, (m, a) in COUNT_MODULES.items()}
    counts.update({f"lane_{k}": v for k, v in
                   mods["flash_attention"].LANE_CALLS.items()})
    return counts


def run_serve_worker(root):
    """The loading side of phase 13, in a process of its own that imports
    ``simseg_tpu_torch.serving`` and nothing else of the port: each job's
    artifact loaded (its seconds), run on its inputs with the counts taken
    around the calls, the outputs written to ``root``; then two artifacts
    called in turns on one stream against their own calls. Writes
    ``root/results.json``."""
    from simseg_tpu_torch import serving

    with open(os.path.join(root, "jobs.json")) as f:
        jobs = json.load(f)
    results, loaded, outputs = {}, {}, {}
    for job in jobs:
        t0 = time.perf_counter()
        load = (serving.load_artifact_separate if job["weights"] == "separate"
                else serving.load_artifact)
        fn = load(job["path"], devices=job.get("devices"))
        load_s = time.perf_counter() - t0
        inputs = torch.load(job["inputs"])
        before = worker_counts()
        t0 = time.perf_counter()
        outs = [fn(*(x.cuda() for x in args)) for args in inputs]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        after = worker_counts()
        torch.save([[o.cpu() for o in out] for out in outs], job["out"])
        results[job["name"]] = {
            "load_s": load_s, "run_s": run_s,
            "counts": {k: after[k] - before[k] for k in after}}
        loaded[job["name"]], outputs[job["name"]] = fn, (inputs, outs)
        print(f"13 worker: {job['name']} loaded in {load_s:.2f} s, "
              f"{len(inputs)} calls in {run_s:.3f} s", flush=True)
    # the CRF kernels' grid barrier is cached per (device, stream): two
    # loaded artifacts' calls queued in turns on one stream share it
    pair = ("a", "b_scales_tail")
    turns = [loaded[n](*(x.cuda() for x in outputs[n][0][i]))
             for i in range(2) for n in pair]
    torch.cuda.synchronize()
    want = [outputs[n][1][i] for i in range(2) for n in pair]
    results["turns_equal"] = all(
        torch.equal(a, b) for got, ref in zip(turns, want)
        for a, b in zip(got, ref))
    with open(os.path.join(root, "results.json"), "w") as f:
        json.dump(results, f)


def serve_export(root, ckpt, vocab, name):
    """Artifact ``name`` through ``tools/export_serving.main(argv)``, with
    its seeded inputs and the live staged module's outputs on them written
    to ``root``. Returns (job, the live module, its export seconds)."""
    from simseg_tpu_torch.tools import export_serving

    kind, batch, weights, extra, batches, _ = SERVE_ARTIFACTS[name]
    path = os.path.join(root, f"{name}.pt2")
    argv = ["--cfg", SERVE_YAML, "--ckpt_path", ckpt, "--vocab_file", vocab,
            "--kind", kind, "--dataset", "pascal_voc", "--batch", str(batch),
            "--weights", weights, "--out", path, *CUT_ARCH, *extra]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn = export_serving.main(argv)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    size = int(next((e.split("=")[1] for e in extra
                     if e.startswith("transforms.input_size=")), SIZE))
    inputs = serve_inputs(name, kind, batch, size, batches)
    live_fn = fn.staged if weights == "separate" else fn
    live = [[o.cpu() for o in live_fn(*(x.cuda() for x in args))]
            for args in inputs]
    torch.save(inputs, os.path.join(root, f"{name}.inputs.pt"))
    job = {"name": name, "path": path, "weights": weights,
           "inputs": os.path.join(root, f"{name}.inputs.pt"),
           "out": os.path.join(root, f"{name}.out.pt"), "live": live}
    print(f"13 export {name}: {kind}, batch {batch}, {weights}, "
          f"{' '.join(extra) or 'the YAML as it is'}: {export_s:.1f} s "
          f"(model, checkpoint, bank and trace), "
          f"{os.path.getsize(path) / 1e6:.1f} MB", flush=True)
    return job, live_fn, export_s


def run_serve_export(root, ckpt, vocab, name):
    """``--serve-export``: ``serve_export`` of artifact ``name`` in a process
    of its own; (its job, its export seconds) to ``root/<name>.job.pt``."""
    job, _, export_s = serve_export(root, ckpt, vocab, name)
    torch.save((job, export_s), os.path.join(root, f"{name}.job.pt"))


def planted_sidecar(root, job):
    """A copy of the separate artifact whose sidecar has one weight of the
    patch embedding moved by 1.0: the bit-equality check must fail on it."""
    path = os.path.join(root, "d_fault.pt2")
    shutil.copy(job["path"], path)
    weights = torch.load(job["path"] + ".weights", weights_only=True)
    key = next(k for k in weights if "patch_embed" in k and k.endswith("weight"))
    weights[key] = weights[key].clone()
    weights[key].view(-1)[0] += 1.0
    torch.save(weights, path + ".weights")
    return dict(job, name="d_fault", path=path,
                out=os.path.join(root, "d_fault.out.pt"))


def same_outputs(got, want) -> bool:
    return all(torch.equal(a, b) for g, w in zip(got, want)
               for a, b in zip(g, w))


def run_serving(beside=None):
    """Phase 13: returns ({artifact: its launch counts in the loading
    process}, ``beside()``'s result). ``beside`` runs in this process while
    the loading process runs (the full run's phase 17), where this one
    would only wait."""
    from simseg_tpu_torch import serving
    from simseg_tpu_torch.data.tokenizer import make_test_vocab
    from simseg_tpu_torch.tasks.seg_eval import load_label_bank
    from simseg_tpu_torch.utils.prompts import IMAGENET_TEMPLATES

    t_start = time.perf_counter()
    card = card_line()
    classes = load_label_bank("pascal_voc")
    words = [w for t in IMAGENET_TEMPLATES for w in t.replace("{}", " ")
             .replace(".", " ").split()] + classes
    vocab_ids = make_test_vocab(words)
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "simseg.vit-b.pth")
        torch.save({"state_dict": seeded_clip(0, depth=CUT_DEPTH).state_dict()},
                   ckpt)
        vocab = os.path.join(root, "vocab.txt")
        with open(vocab, "w") as f:
            f.write("\n".join(sorted(vocab_ids, key=vocab_ids.get)) + "\n")
        # (a) here (its live module is timed below), the others in a process
        # each, all at once: an export is host-bound tracing
        procs = {name: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-export", root,
             ckpt, vocab, name]) for name in SERVE_ARTIFACTS if name != "a"}
        try:
            job_a, live_a, export_a = serve_export(root, ckpt, vocab, "a")
            rcs = {name: p.wait(timeout=SERVE_LIMIT) for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs.values()):
            raise AssertionError(f"13: the export processes exited {rcs}")
        jobs, export_s = {}, {}
        for name in SERVE_ARTIFACTS:
            jobs[name], export_s[name] = (
                (job_a, export_a) if name == "a" else
                torch.load(os.path.join(root, f"{name}.job.pt")))
        torch.cuda.empty_cache()
        fault = planted_sidecar(root, jobs["d"])
        spread = dict(jobs["a"], name="f", devices=SERVE_DEVICES,
                      out=os.path.join(root, "f.out.pt"))
        worker_jobs = [{k: v for k, v in j.items() if k != "live"}
                       for j in (*jobs.values(), fault, spread)]
        with open(os.path.join(root, "jobs.json"), "w") as f:
            json.dump(worker_jobs, f)
        t0 = time.perf_counter()
        # files, not pipes: nothing reads the process's output while
        # ``beside`` runs
        with tempfile.TemporaryFile("w+") as out, \
                tempfile.TemporaryFile("w+") as err:
            worker = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       "--serve-worker", root], stdout=out,
                                      stderr=err, text=True)
            try:
                beside_result = beside() if beside else None
                rc = worker.wait(timeout=SERVE_LIMIT)
            finally:
                if worker.poll() is None:
                    worker.kill()
                    worker.wait()
            worker_s = time.perf_counter() - t0
            out.seek(0)
            err.seek(0)
            stdout, stderr = out.read(), err.read()
        print(stdout[-4000:], end="", flush=True)
        if rc != 0:
            raise AssertionError(f"13: the loading process failed "
                                 f"({rc}):\n{stderr[-6000:]}")
        with open(os.path.join(root, "results.json")) as f:
            results = json.load(f)
        got = {j["name"]: torch.load(j["out"]) for j in worker_jobs}

        counts = {}
        for name, (_, batch, _, _, batches, want) in SERVE_ARTIFACTS.items():
            equal = same_outputs(got[name], jobs[name]["live"])
            counts[name] = results[name]["counts"]
            print(f"13 ({name}) loaded in a fresh process: outputs bit-equal to "
                  f"the live call on {batches} batches of {batch}: {equal}; "
                  f"launches {counts[name]}; load {results[name]['load_s']:.2f}"
                  f" s", flush=True)
            if not equal:
                raise AssertionError(f"13 ({name}): the loaded artifact's "
                                     "outputs differ from the live call's")
            check_counts(f"13 ({name})", counts[name], want)
        shape = tuple(got["a"][0][0].shape)
        if shape != (BENCH_BATCH, SIZE, SIZE) or not all(
                torch.isfinite(o[1]).all() for o in got["a"]):
            raise AssertionError(f"13 (a): bad outputs {shape}")
        d_equal = same_outputs(got["d"], got["a"][:2])
        fault_equal = same_outputs(got["d_fault"], got["a"][:2])
        d_graph = os.path.getsize(jobs["d"]["path"]) / 1e6
        d_side = os.path.getsize(jobs["d"]["path"] + ".weights") / 1e6
        print(f"13 (d) separate against baked: bit-equal {d_equal}; graph "
              f"{d_graph:.1f} MB, sidecar {d_side:.1f} MB; planted fault (one "
              f"patch-embedding weight of the sidecar moved by 1.0) bit-equal "
              f"{fault_equal}", flush=True)
        if not d_equal:
            raise AssertionError("13 (d): the separate layout differs from baked")
        if fault_equal:
            raise AssertionError("13 (d): the planted sidecar fault passed")
        f_equal = same_outputs(got["f"], got["a"])
        print(f"13 (f) devices=['cuda:0', 'cuda:0'] (two halves of each batch "
              f"of {BENCH_BATCH}) against one device: bit-equal {f_equal}; "
              f"launches {results['f']['counts']}", flush=True)
        if not f_equal:
            raise AssertionError("13 (f): the split serve differs")
        check_counts("13 (f)", results["f"]["counts"], {"crf_mean_field": 6})
        print(f"13 two loaded artifacts (a, b) called in turns on one stream "
              f"(the CRF kernels' shared grid barrier): bit-equal to their own "
              f"calls {results['turns_equal']}", flush=True)
        if not results["turns_equal"]:
            raise AssertionError("13: artifacts in turns on one stream differ")

        # in one process, in turns: the live module and the loaded artifact
        loaded = serving.load_artifact(jobs["a"]["path"])
        x = serve_inputs("a", "seg", BENCH_BATCH, SIZE, 1)[0][0].cuda()
        if not same_outputs([loaded(x)], [live_a(x)]):
            raise AssertionError("13 (a): loaded != live in one process")
        ms = {"live": [], "loaded": []}
        for side in ("live", "loaded", "loaded", "live"):
            ms[side].append(cuda_ms(lambda: (live_a if side == "live"
                                             else loaded)(x), 5))
        rates = {k: ", ".join(f"{BENCH_BATCH / (m / 1e3):.1f} ({m:.3f} ms)"
                              for m in v) for k, v in ms.items()}
        image_bytes = sum(t.numel() * t.element_size() for t in
                          (*live_a.parameters(), *live_a.buffers()))
        a_mb = os.path.getsize(jobs["a"]["path"]) / 1e6
        print(f"13 (a) in turns, batch {BENCH_BATCH} ({card}): images/s live "
              f"{rates['live']}, loaded {rates['loaded']}; artifact "
              f"{a_mb:.1f} MB beside the image side's parameters and bank "
              f"{image_bytes / 1e6:.1f} MB", flush=True)
        print(f"13 serving ({card}): exports "
              f"{', '.join(f'{k} {v:.1f} s' for k, v in export_s.items())}; "
              f"the loading process {worker_s:.1f} s; phase 13 in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        del live_a, loaded
    torch.cuda.empty_cache()
    return counts, beside_result


# -- phase 14: the sharded-state legs (TP, SP, ZeRO-1, FSDP, BSGS) -------------------

MP_STEPS = 2                               # step 2 timed
MP_LIMIT = 600                             # seconds a world's ranks may take
MP_T = (TRAIN_SIZE // PATCH) ** 2 + 1      # 1297: the train lane at 576 px
# leg -> (world, px, global batch, dist settings, BSGS micro-batch or None)
MP_LEGS = {
    "a": (2, TRAIN_SIZE, 8, ("dist.tp_size=2",), None),
    "b": (2, TRAIN_SIZE, 8, ("dist.tp_size=2", "dist.sp=True"), None),
    "c": (2, 224, 32, ("dist.zero1=True",), None),
    "d": (2, 224, 32, ("dist.fsdp=True",), None),
    "e": (4, 224, 32, ("dist.tp_size=2", "dist.fsdp=True"), None),
    "f": (4, 224, 64, ("dist.tp_size=2", "dist.zero1=True"), 32),
}
MP_NOTE = ("ranks sharing one card through gloo: every collective is staged "
           "through the host, so the times measure no card-to-card link")
# each tensor's gradient within this many times one process's own bf16
# error (against the float32 step of the same weights and batch): a
# sharded bf16 step sums its partial products in another order, and some
# tensors (the position embeddings: a sum over the batch that nearly
# cancels) sit 26-29% from float32 in either order
MP_NOISE_BAR = 2.0


# -- phase 15's legs: expert and pipeline parallelism, 4 blocks a tower ------------

MOE_ARCH = "'moe_experts': 8, 'moe_every': 2, 'moe_capacity': 1.25"
P15_DEPTH = 4
P15_LEGS = {
    "15c": (2, TRAIN_SIZE, 8, ("dist.moe_ep=True",), None),
    "15d": (2, TRAIN_SIZE, 16, ("dist.pp_size=2", "dist.pp_micro=4"), None),
    "15d4": (4, TRAIN_SIZE, 16, ("dist.pp_size=2", "dist.pp_micro=4",
                                 "dist.zero1=True"), None),
}
# the legs' towers: (c) MoE, (d) dense, each cut to P15_DEPTH blocks
LEG_ARCH = {
    "15c": tuple(f"model.{t}_encoder.arch={{'depth': {P15_DEPTH}, {MOE_ARCH}}}"
                 for t in ("image", "text")),
    "15d": tuple(f"model.{t}_encoder.arch={{'depth': {P15_DEPTH}}}"
                 for t in ("image", "text")),
}
LEG_ARCH["15d4"] = LEG_ARCH["15d"]
# phase 14's 224-px legs at MP_DEPTH blocks a tower, full width (the
# script's time); (a) and (b) stay at full depth: at 6 blocks (b)'s seeded
# weights put both towers' gradient norms 3.8-4.1% from one process's on
# the H100 (loss 2.85e-3 off, at temperature 0.02), past the 1e-2 bar it
# meets at 12 blocks
MP_DEPTH = 6
for _leg, _spec in MP_LEGS.items():
    if _spec[1] != TRAIN_SIZE:
        LEG_ARCH[_leg] = tuple(
            f"model.{t}_encoder.arch={{'depth': {MP_DEPTH}}}"
            for t in ("image", "text"))
# attention launches a rank a step, forward and backward: (c) every block of
# the image tower, (d) a stage's 2 blocks x 4 microbatches
LEG_ATTN = {"15c": P15_DEPTH, "15d": 8, "15d4": 8}
LEG_ATTN.update({leg: 12 for leg, spec in MP_LEGS.items()
                 if spec[1] == TRAIN_SIZE})
# the aux against one process's (relative): each rank's counts of a bf16
# forward may route a near-tie otherwise than one process's
MOE_AUX_BAR = 2e-3


def leg_spec(leg):
    return {**MP_LEGS, **P15_LEGS}[leg]


def leg_label(leg):
    return leg if leg.startswith("15") else f"14{leg}"


def mp_cfg(tmp, leg, sharded=True, bf16=True):
    """A leg's config: the flagship's (``TRAIN_OVERRIDES``) at the leg's
    size and batch, a constant lr (the schedule's warmup would start at 0),
    its towers (``LEG_ARCH``), its ``dist`` settings unless ``sharded`` is
    False (one process's); float32 compute with ``bf16`` False (the witness
    of ``mp_bars``)."""
    _, px, b, legs, micro = leg_spec(leg)
    extra = [f"transforms.random_resize_crop.size={px}",
             f"transforms.input_size={px}", f"data.batch_size={b}",
             "optim.lr.name=constant_schedule", *LEG_ARCH.get(leg, ())]
    if micro:
        extra += [f"data.batch_size_train={micro}", "runner.name=clip_bsgs"]
    if not bf16:
        extra.append("dist.bf16=False")
    return train_cfg(tmp, *extra, *(legs if sharded else ()))


def mp_model(cfg, dev, mesh=None):
    """The seeded flagship model of ``cfg``, initialised on ``dev`` (the same
    draws on every rank and in the one-process references)."""
    from simseg_tpu_torch.models.clip import build_clip_model

    torch.manual_seed(0)
    with torch.device(dev):
        return build_clip_model(cfg, mesh)


def mp_runner(cfg, tok, dev):
    """The seeded flagship model under the config's legs and its runner."""
    from simseg_tpu_torch.core.runner import CLIPRunner
    from simseg_tpu_torch.parallel import make_mesh

    mesh = make_mesh(-1, int(cfg.dist.tp_size), int(cfg.dist.pp_size))
    return CLIPRunner(cfg, mp_model(cfg, dev, mesh), {"train": []},
                      device=dev, tokenizer=tok)


def mp_bars(label, loss, grads, want_loss, want, want32, aux=None,
            want_aux=None):
    """(ok, text): the loss within 1e-2 relative, each tower's whole gradient
    at cosine >= 0.99 and its norm within 1e-2 (the temperature's too) of
    one process's bf16 step, and every tensor's gradient within
    ``MP_NOISE_BAR`` times that step's own distance from the float32 step
    (``want32``; + 1e-3 of its norm), the key projections' biases left out
    as in ``tower_cosines``. With MoE towers (``want_aux`` given) the aux
    within ``MOE_AUX_BAR``, and each tensor's own distance from the float32
    step within ``MP_NOISE_BAR`` times one process's: two bf16 runs route
    a few near-tie tokens to other experts (15a on the H100: 0.38%), which
    moves the routers' gradients between the two more than rounding does,
    so the bar holds each to the float32 step (the distance between the
    two printed beside it)."""
    aux_rel = 0.0 if want_aux is None else abs(aux - want_aux) / abs(want_aux)
    rel = abs(loss - want_loss) / abs(want_loss)
    cos = whole_tower_cosines(grads, want)
    norms = tower_norms(grads, want)
    ratios, to32 = {}, {}
    for n, w in want.items():
        if n.endswith("attention.self.key.bias"):
            continue  # zero in exact arithmetic: both sides hold noise
        w, w32, g = w.double(), want32[n].double(), grads[n].double()
        noise = (w - w32).norm() + 1e-3 * w.norm()
        ratios[n] = ((g - w).norm() / noise).item()
        to32[n] = ((g - w32).norm() / noise).item()
    held = to32 if want_aux is not None else ratios
    worst = max(ratios, key=ratios.get)
    worst32 = max(to32, key=to32.get)
    ok = (rel <= DIST_LOSS_BAR and all(c >= DIST_COS_BAR for c in cos.values())
          and all(v <= DIST_NORM_BAR for v in norms.values())
          and max(held.values()) <= MP_NOISE_BAR and aux_rel <= MOE_AUX_BAR)
    return ok, (f"{label}: loss {loss:.6f} vs {want_loss:.6f} (relative "
                f"{rel:.3e}); whole-tower gradient cosine {cos}; norm errors "
                f"{norms}; largest error over one process's bf16 error "
                f"{ratios[worst]:.3f} ({worst})"
                + ("" if want_aux is None else
                   f"; largest distance from float32 over one process's "
                   f"{to32[worst32]:.3f} ({worst32}); aux {aux:.6f} vs "
                   f"{want_aux:.6f} (relative {aux_rel:.3e})"))


def mp_captured(runner, batch):
    """(loss, {name: whole float32 grad}, aux or None) of one call of the
    sharded step: the optimizer's update replaced by a gather of the
    gradients it would take (a collective: every rank calls it)."""
    plan = getattr(runner.model, "shard_plan", None)
    grads = {}

    def capture():
        for n, p in runner.model.named_parameters():
            if p.grad is None:
                continue
            g = p.grad.detach()
            spec = None if plan is None else plan.specs[n]
            if spec is not None and (spec.tp_dim is not None
                                     or spec.data_dim is not None):
                g = plan.full(g, spec)
            grads[n] = g.float().clone()
        runner.optimizer.zero_grad()
        return torch.zeros(())

    with unittest.mock.patch.object(runner.optimizer, "step", capture):
        metrics = runner._step_fn(batch, 0.0, 0, True)
    aux = metrics.get("moe_aux")
    return metrics["loss"].item(), grads, None if aux is None else aux.item()


def mp_rule_bytes(model):
    """(parameter bytes, AdamW moment bytes) a rank holds by the specs, and
    the same for one process: each sharded dim divided by its ranks (a
    ZeRO-1 slice by the data ranks); two float32 moments a parameter.
    Without a shard plan (a pipeline alone) every rank holds the whole."""
    plan = getattr(model, "shard_plan", None)
    if plan is None:
        whole = sum(p.numel() for p in model.parameters())
        return (4 * whole, 8 * whole), (4 * whole, 8 * whole)
    m = plan.mesh
    params = moments = whole = 0
    for spec in plan.specs.values():
        n = int(np.prod(spec.shape)) if spec.shape else 1
        whole += n
        local = n // (m.tp if spec.tp_dim is not None else 1)
        local //= m.group_ranks if spec.data_dim is not None else 1
        params += 4 * local
        moments += 8 * (n // m.data_size if spec.zero_dim is not None else local)
    return (params, moments), (4 * whole, 8 * whole)


def mp_faults(leg, runner, local):
    """The leg's planted faults, each of which must fail its check: (a) one
    row-parallel sum dropped (the image tower's last fc2), against
    ``mp_bars``; (b) the sequence-parallel LayerNorms' gradients left
    unsummed over the model group, against ``mp_bars``; (d) one FSDP leaf
    (the word embeddings) left whole, against the bytes check; 15c and 15d:
    ``p15_ep_faults``, ``p15_pp_faults``."""
    from simseg_tpu_torch.parallel.sharding import state_bytes

    plan = getattr(runner.model, "shard_plan", None)
    out = {}
    if leg == "15c":
        p15_ep_faults(runner, local, out)
    if leg == "15d":
        p15_pp_faults(runner, local, out)
    if leg == "a":
        fc2 = runner.model.image_tower.blocks[-1].mlp.fc2

        def unsummed(x):
            y = fc2.product(x, None)
            return y + fc2.bias.to(y.dtype)

        with unittest.mock.patch.object(fc2, "forward", unsummed):
            out["one row-parallel sum dropped"] = mp_captured(runner, local)
    if leg == "b":
        norms = [n for n, s in plan.specs.items()
                 if s.sp_partial and ".norm" in n]
        for n in norms:
            plan.specs[n].sp_partial = False
        try:
            out["the LayerNorms' gradients unsummed"] = mp_captured(runner, local)
        finally:
            for n in norms:
                plan.specs[n].sp_partial = True
    if leg == "d":
        emb = runner.model.bert.embeddings.word_embeddings
        name = "text_encoder.model.model.embeddings.word_embeddings.weight"
        shard = emb._parameters["weight"]
        emb._parameters["weight"] = torch.nn.Parameter(
            plan.full(shard, plan.specs[name]))
        try:
            got = state_bytes(runner.model)[0]
        finally:
            emb._parameters["weight"] = shard
        want_b = mp_rule_bytes(runner.model)[0][0]
        print(f"14d planted fault (the word embeddings left whole): parameter "
              f"bytes {got} vs the rules' {want_b}; equal {got == want_b}",
              flush=True)
        if got == want_b:
            raise AssertionError("14d: the bytes check passes a whole FSDP leaf")
    return out


def mp_leg(tmp, leg, r, dev, result, refs):
    """One leg (``MP_LEGS``): a step's loss and gathered gradients against
    one process's on the same batch and weights (rank 0; ``refs`` keeps a
    reference for the next leg of the same size), the planted faults,
    ``MP_STEPS`` timed steps with their launches, the bytes each rank holds
    against the rules, the replicated leaves bit-equal across ranks."""
    from simseg_tpu_torch.parallel import process_allgather
    from simseg_tpu_torch.parallel.sharding import state_bytes

    world, px, b, legs, micro = leg_spec(leg)
    name = leg_label(leg)
    t_leg = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batch224, tok = caption_batch(41, min(b, 32), px)
    batch = tiled_batch(batch224, b)
    runner = mp_runner(mp_cfg(tmp, leg), tok, dev)
    mesh = runner.mesh
    plan = getattr(runner.model, "shard_plan", None)
    full = runner._prepare_batch(batch)
    n, d = b // mesh.data_size, mesh.data_rank
    local = {k: v[d * n:(d + 1) * n] for k, v in full.items()}
    key = (px, b, micro)
    if r == 0 and key not in refs:
        refs.clear()
        out = []
        for bf16 in (True, False):
            ref = mp_model(mp_cfg(tmp, leg, sharded=False, bf16=bf16), dev)
            out.append((*bsgs_grads(ref, full, b // micro), None) if micro
                       else step_grads_aux(ref, full))
            del ref
            torch.cuda.empty_cache()
        refs[key] = (*out[0][:2], out[1][1], out[0][2])
    del full
    loss, grads, aux = mp_captured(runner, local)
    faults = mp_faults(leg, runner, local)
    label = f"{name} {'+'.join(legs)}, {px} px, batch {b}" + (
        f" (BSGS / {micro})" if micro else "") + f", {world} ranks"
    if r == 0:
        want_loss, want, want32, want_aux = refs[key]
        ok, text = mp_bars(label + " vs one process", loss, grads,
                           want_loss, want, want32, aux, want_aux)
        print(text, flush=True)
        if not ok:
            raise AssertionError(f"{name}: the sharded step is not one "
                                 "process's")
        for fault, (f_loss, f_grads, f_aux) in faults.items():
            f_ok, f_text = mp_bars(f"{name} planted fault, {fault}", f_loss,
                                   f_grads, want_loss, want, want32, f_aux,
                                   want_aux)
            print(f_text + f"; within the bars {f_ok}", flush=True)
            if f_ok:
                raise AssertionError(f"{name}: the planted fault ({fault}) "
                                     "passed")
    del grads, faults, local
    host = {"image": batch["image"][d * n:(d + 1) * n],
            "caption": batch["caption"][d * n:(d + 1) * n]}
    ms, red, staged, counts = dist_train_steps(name, runner, host,
                                               MP_STEPS, r)
    per = LEG_ATTN.get(leg, 0)
    kernels = {"flash_attention": per * MP_STEPS, "lane_train": per * MP_STEPS,
               "flash_attention_bwd": per * MP_STEPS} if per else {}
    check_counts(f"{name} rank {r}", counts, kernels)
    got = state_bytes(runner.model, runner.optimizer)
    (want_b, dp_b) = mp_rule_bytes(runner.model)
    print(f"{name} rank {r}: parameter / moment bytes {got[0]} / {got[1]}, the "
          f"rules' {want_b[0]} / {want_b[1]}, one process's {dp_b[0]} / "
          f"{dp_b[1]}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if tuple(got) != tuple(want_b):
        raise AssertionError(f"{name} rank {r}: the rank holds {got} bytes, "
                             f"the rules give {want_b}")
    import hashlib

    h = hashlib.sha256()
    for k, v in runner.model.state_dict().items():
        spec = None if plan is None else plan.specs.get(k)
        if spec is None or (spec.tp_dim is None and spec.data_dim is None):
            h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
    digests = process_allgather(np.frombuffer(h.digest(), np.uint8))
    same = bool((digests == digests[0]).all())
    print(f"{name} rank {r}: replicated leaves bit-equal across the ranks "
          f"after {MP_STEPS} steps {same}", flush=True)
    if not same:
        raise AssertionError(f"{name}: the ranks' replicated leaves differ")
    result[leg] = dict(ms=ms, reduce_ms=red, staged=staged, counts=counts,
                       bytes=list(got), rule_bytes=list(want_b),
                       dp_bytes=list(dp_b), images_per_s=b / ms * 1e3,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       seconds=time.perf_counter() - t_leg)
    if leg == "c":
        result["c"]["digest"] = params_digest(runner.model)
    del runner
    torch.cuda.empty_cache()


def mp_zero1_vs_dp(tmp, r, dev, result):
    """(c)'s data-parallel twin: the same ranks, batches and weights without
    ZeRO-1; the parameters after ``MP_STEPS`` steps must be bit-equal to
    ZeRO-1's (AdamW is elementwise, the slices see the whole summed
    gradient)."""
    _, px, b, _, _ = MP_LEGS["c"]
    batch224, tok = caption_batch(41, b, px)
    runner = mp_runner(mp_cfg(tmp, "c", sharded=False), tok, dev)
    n, d = b // runner.mesh.data_size, runner.mesh.data_rank
    host = {"image": batch224["image"][d * n:(d + 1) * n],
            "caption": batch224["caption"][d * n:(d + 1) * n]}
    ms, _, staged, _ = dist_train_steps("14c data-parallel twin", runner, host,
                                        MP_STEPS, r)
    same = params_digest(runner.model) == result["c"]["digest"]
    print(f"14c rank {r}: ZeRO-1's parameters after {MP_STEPS} AdamW steps "
          f"bit-equal to data parallelism's {same}; {ms:.1f} ms a step "
          f"data-parallel vs {result['c']['ms']:.1f} ZeRO-1", flush=True)
    if not same:
        raise AssertionError("14c: ZeRO-1 is not bit-equal to data parallelism")
    result["c"]["dp_ms"] = ms
    del runner
    torch.cuda.empty_cache()


def step_grads_aux(model, batch):
    """(loss, {name: grad}, aux or None) of one forward/backward of the train
    loss (the MoE towers' aux in it)."""
    from simseg_tpu_torch.engine.train_step import clip_loss_fn

    model.zero_grad(set_to_none=True)
    loss, metrics = clip_loss_fn(model, batch)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    aux = metrics.get("moe_aux")
    return loss.item(), grads, None if aux is None else aux.item()


def p15_ep_faults(runner, local, out):
    """15c's planted faults, each against ``mp_bars``: the aux of each rank's
    own rows (its statistics not summed over the data ranks), and the
    experts' gradients summed over the data ranks as a replicated leaf's
    (each rank's shard holds other experts)."""
    from simseg_tpu_torch.engine import train_step
    from simseg_tpu_torch.parallel.collectives import reduce_gradients

    real_aux = train_step.moe_aux
    with unittest.mock.patch.object(
            train_step, "moe_aux",
            lambda model, group, world: real_aux(model, None, 1)):
        out["a rank-local aux"] = mp_captured(runner, local)
    plan, inner = runner.model.shard_plan, train_step.reduce_model_gradients

    def experts_summed(model, mesh):
        inner(model, mesh)
        reduce_gradients([p for n, p in model.named_parameters()
                          if plan.specs[n].ep_dim is not None], mesh.data_group)

    with unittest.mock.patch.object(train_step, "reduce_model_gradients",
                                    experts_summed):
        out["expert gradients summed over the data ranks"] = mp_captured(
            runner, local)


def p15_pp_faults(runner, local, out):
    """15d's planted faults, each against ``mp_bars``: the image tower's
    first two microbatches swapped in the collected buffer, and the leaves
    every stage computes alike (final norm, projections, temperature)
    summed over the stages."""
    from simseg_tpu_torch.parallel import pp

    inner_tokens = pp.pp_image_tokens

    def swapped(model, images, mesh, n_micro):
        t = inner_tokens(model, images, mesh, n_micro)
        m = t.shape[0] // n_micro
        return torch.cat([t[m:2 * m], t[:m], t[2 * m:]])

    with unittest.mock.patch.object(pp, "pp_image_tokens", swapped):
        out["two microbatches swapped in the image buffer"] = mp_captured(
            runner, local)
    inner_stages, stage = pp.param_stages, runner.mesh.stage

    def every_stage(model, n):
        return {k: (stage if v == n - 1 and not (pp._IMG.match(k)
                                                 or pp._TXT.match(k)) else v)
                for k, v in inner_stages(model, n).items()}

    with unittest.mock.patch.object(pp, "param_stages", every_stage):
        out["the replicated leaves summed over the stages"] = mp_captured(
            runner, local)


# the worlds of phases 14 and 15, started at once, each running its legs in
# turn: twelve host-bound processes sharing the card (the host's cores bound
# the phases' time: five worlds, (c, d) apart, took as long)
MP_WORLDS = (("a", "b", "c", "d"), ("e", "f"), ("15c", "15d"), ("15d4",))


def run_mp_worker(out_dir, world, backend="gloo", legs="e"):
    """One rank of a phase 14 or 15 world: gloo ranks on ``cuda:0`` (NCCL: a
    card a rank), the legs named (comma-separated) in turn; its numbers to
    ``out_dir/rank<r>.json``."""
    from simseg_tpu_torch.parallel import init_distributed, local_rank, rank

    dev = "cuda:0" if backend == "gloo" else f"cuda:{local_rank()}"
    init_distributed(backend=backend, device=dev, timeout=MP_LIMIT)
    r, result, refs = rank(), {}, {}
    legs = legs.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        for leg in legs:
            mp_leg(tmp, leg, r, dev, result, refs)
            if leg == "c":
                mp_zero1_vs_dp(tmp, r, dev, result)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(result, f)


def mp_world(legs, backend="gloo"):
    """The ranks of one phase 14 or 15 world running ``legs``, started
    together; their results."""
    world = leg_spec(legs[0])[0]
    from simseg_tpu_torch.launch import free_port

    with tempfile.TemporaryDirectory() as out:
        port, procs = free_port(), []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r if backend == "nccl" else 0),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-worker", out,
                 str(world), backend, ",".join(legs)], env=env))
        try:
            rcs = [p.wait(timeout=MP_LIMIT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rcs != [0] * world:
            raise AssertionError(f"{legs}: the {world} ranks exited {rcs}")
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def run_model_parallel():
    """Phases 14 and 15 (c, d): the attention kernels at the TP shape, then
    the legs in worlds of 2 and 4 gloo ranks on the card, phase 14's and
    phase 15's at once; returns the attention kernels' launches per rank in
    14 (a) and (b), and in 15c, 15d and 15d4."""
    card = card_line()
    t_start = time.perf_counter()
    b = MP_LEGS["a"][2]
    fwd = check_flash_kernel(MP_T, b=b, heads=HEADS // 2)
    bwd = check_flash_bwd_kernel(MP_T, b, heads=HEADS // 2)
    torch.cuda.empty_cache()
    with ThreadPoolExecutor(len(MP_WORLDS)) as pool:
        jobs = [pool.submit(mp_world, legs) for legs in MP_WORLDS]
        ranks = {leg: res for legs, job in zip(MP_WORLDS, jobs)
                 for res in [job.result()] for leg in legs}
    for leg, (world, px, b, legs, micro) in {**MP_LEGS, **P15_LEGS}.items():
        for r, res in enumerate(ranks[leg]):
            x = res[leg]
            print(f"{leg_label(leg)} rank {r} ({card}): {'+'.join(legs)} at {px} px, "
                  f"batch {b}{f' (BSGS / {micro})' if micro else ''}: "
                  f"{x['images_per_s']:.1f} images/s ({x['ms']:.1f} ms a step"
                  + (f"; data-parallel {x['dp_ms']:.1f}" if "dp_ms" in x else "")
                  + f"), reduction {x['reduce_ms']:.1f} ms a step, "
                  f"{x['staged'] / 2**20:.1f} MiB staged a step, parameters "
                  f"{x['bytes'][0] / 2**20:.1f} MiB and moments "
                  f"{x['bytes'][1] / 2**20:.1f} MiB (one process "
                  f"{x['dp_bytes'][0] / 2**20:.1f} / {x['dp_bytes'][1] / 2**20:.1f}), "
                  f"peak {x['peak_gib']:.2f} GiB; the leg in "
                  f"{x['seconds']:.1f} s; {MP_NOTE}", flush=True)
    print(f"14 attention at ({MP_LEGS['a'][2]}, {MP_T}, {HEADS // 2}, "
          f"{HEAD_DIM}): forward "
          f"{fwd['ms']:.4f} ms (plain {fwd['plain_ms']:.4f}, sdpa "
          f"{fwd['library_ms']:.4f}, bound {fwd['bound_ms']:.4f}); backward "
          f"{bwd['ms']:.4f} ms (plain {bwd['plain_ms']:.4f}, sdpa "
          f"{bwd['library_ms']:.4f}, bound {bwd['bound_ms']:.4f})", flush=True)
    print(f"14-15 worlds in {time.perf_counter() - t_start:.1f} s", flush=True)
    mp = {k: [res[leg]["counts"][k] for leg in ("a", "b") for res in ranks[leg]]
          for k in ("flash_attention", "flash_attention_bwd")}
    pp = {k: [res[leg]["counts"][k] for leg in ("15c", "15d", "15d4")
              for res in ranks[leg]]
          for k in ("flash_attention", "flash_attention_bwd")}
    return mp, pp


def run_model_parallel_nccl():
    """(e) over four cards, one NCCL rank each: the record of the leg across
    NVLink (needs four cards)."""
    if torch.cuda.device_count() < 4:
        raise SystemExit("chip_smoke --model-parallel-nccl needs four cards")
    t_start = time.perf_counter()
    for r, res in enumerate(mp_world(("e",), "nccl")):
        x = res["e"]
        print(f"14e NCCL rank {r} ({card_line()}): {x['images_per_s']:.1f} "
              f"images/s ({x['ms']:.1f} ms a step), reduction "
              f"{x['reduce_ms']:.1f} ms a step, peak {x['peak_gib']:.2f} GiB",
              flush=True)
    print(f"14e NCCL in {time.perf_counter() - t_start:.1f} s", flush=True)


# -- phase 15 (a, b): the MoE towers in one process ------------------------------

MOE_STEPS = 4                              # (a): timed steps 2-4
MOE_COMPARE = 8                            # (a): rows of the witness step
# (a): share of routed tokens on the witness's expert (bf16 near-ties flip)
MOE_ROUTE_BAR = 0.99
MOE_SEG_BATCHES = 3


def moe_overrides(depth=None):
    d = "" if depth is None else f"'depth': {depth}, "
    return tuple(f"model.{t}_encoder.arch={{{d}{MOE_ARCH}}}"
                 for t in ("image", "text"))


def routed(model, fn):
    """(fn(), [each MoE layer's expert of every token]) from the routers'
    logits (their argmax, the layer's own choice)."""
    from simseg_tpu_torch.ops.moe import moe_layers

    routes = []
    hooks = [m.router.register_forward_hook(
        lambda mod, args, out: routes.append(out.argmax(-1).flatten().cpu()))
        for m in moe_layers(model)]
    try:
        return fn(), routes
    finally:
        for h in hooks:
            h.remove()


def route_share(routes, want):
    same = sum(int((a == b).sum()) for a, b in zip(routes, want))
    return same / sum(a.numel() for a in want)


def moe_predicted_bytes(cfg):
    """(parameters, AdamW moments) in bytes from the shapes of the model of
    ``cfg`` on the ``meta`` device, and the experts' parameters."""
    from simseg_tpu_torch.models.clip import build_clip_model

    with torch.device("meta"):
        model = build_clip_model(cfg)
    n = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for name, p in model.named_parameters()
                  if ".moe.w" in name or ".moe.b" in name)
    return 4 * n, 8 * n, experts, n


def run_moe_train(tmp):
    """15a: ViT-B/16 + BERT-base with 8-expert MoE blocks (every second
    block of each tower, capacity 1.25), full depth, 576 px, batch 32, bf16
    compute. At ``MOE_COMPARE`` rows: the kernel lane's step (loss, aux,
    gradients) against the plain-attention lane's with ``mp_bars`` (a
    float32 step of the same weights as the noise scale) and the routing
    shares against it, a planted routing fault (the router's experts read
    in reverse) below ``MOE_ROUTE_BAR``; then ``MOE_STEPS`` timed steps at
    32 with exact launches (12 forward and 12 backward a step), images/s,
    peak GiB, parameter and moment bytes against the prediction. Returns
    the launch counts."""
    from simseg_tpu_torch.core.runner import CLIPRunner
    from simseg_tpu_torch.models.clip import build_clip_model
    from simseg_tpu_torch.ops import attention
    from simseg_tpu_torch.ops.moe import moe_layers
    from simseg_tpu_torch.parallel.sharding import state_bytes

    card, t0 = card_line(), time.perf_counter()
    extra = (*moe_overrides(), f"transforms.random_resize_crop.size={TRAIN_SIZE}",
             f"transforms.input_size={TRAIN_SIZE}",
             f"data.batch_size={TRAIN_BATCH}", "optim.lr.name=constant_schedule")
    cfg = train_cfg(tmp, *extra)
    batch, tok = caption_batch(43, TRAIN_BATCH, TRAIN_SIZE)
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = build_clip_model(cfg)
    runner = CLIPRunner(cfg, model, {"train": []}, device="cuda", tokenizer=tok)
    dev = runner._prepare_batch(batch)
    small = {k: v[:MOE_COMPARE] for k, v in dev.items()}
    (loss, grads, aux), routes = routed(
        runner.model, lambda: step_grads_aux(runner.model, small))
    with unittest.mock.patch.object(attention, "attention_lane",
                                    lambda *a, **k: "plain"):
        (w_loss, w_grads, w_aux), w_routes = routed(
            runner.model, lambda: step_grads_aux(runner.model, small))
    with torch.device("cuda"):
        f32 = build_clip_model(train_cfg(tmp, *extra, "dist.bf16=False"))
    f32.load_state_dict(runner.model.state_dict())
    grads32 = step_grads_aux(f32, small)[1]
    del f32
    torch.cuda.empty_cache()
    label = (f"15a MoE 8 experts, {TRAIN_SIZE} px, batch {MOE_COMPARE}: kernel "
             f"lane vs the plain-attention lane")
    ok, text = mp_bars(label, loss, grads, w_loss, w_grads, grads32, aux, w_aux)
    share = route_share(routes, w_routes)
    print(f"{text}; tokens routed to the witness's expert {share:.6f} of "
          f"{sum(r.numel() for r in w_routes)}", flush=True)
    if not ok or share < MOE_ROUTE_BAR:
        raise AssertionError(f"15a: the kernel lane's MoE step is not the "
                             f"witness's (share {share})")
    routers = [m.router for m in moe_layers(runner.model)]
    with contextlib.ExitStack() as stack:
        for router in routers:
            stack.enter_context(unittest.mock.patch.object(
                router, "forward",
                lambda x, r=router: type(r).forward(r, x).flip(-1)))
        (_, _, f_aux), f_routes = routed(
            runner.model, lambda: step_grads_aux(runner.model, small))
    f_share = route_share(f_routes, w_routes)
    print(f"15a planted fault (the routers' experts read in reverse): tokens "
          f"routed to the witness's expert {f_share:.6f}, aux {f_aux:.6f}",
          flush=True)
    if f_share >= MOE_ROUTE_BAR:
        raise AssertionError("15a: the planted routing fault passed")
    del grads, w_grads, grads32
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    events, losses, auxes = [], [], []
    for step in range(MOE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = runner._step_fn(dev, 1e-4, step, True)
        end.record()
        events.append((start, end))
        losses.append(m["loss"])
        auxes.append(m["moe_aux"])
    torch.cuda.synchronize()
    counts = read_counts()
    per = 12 * MOE_STEPS
    check_counts("15a", counts, {"flash_attention": per, "lane_train": per,
                                 "flash_attention_bwd": per})
    ms = events[1][0].elapsed_time(events[-1][1]) / (MOE_STEPS - 1)
    losses = [x.item() for x in losses]
    auxes = [x.item() for x in auxes]
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(auxes))):
        raise AssertionError(f"15a: losses {losses}, aux {auxes}")
    got = state_bytes(runner.model, runner.optimizer)
    want_p, want_m, experts, n = moe_predicted_bytes(cfg)
    print(f"15a ({card}): {MOE_STEPS} steps at batch {TRAIN_BATCH}, losses "
          f"{[round(x, 5) for x in losses]}, aux {[round(x, 5) for x in auxes]}; "
          f"{ms:.1f} ms a step (steps 2-{MOE_STEPS}) = "
          f"{TRAIN_BATCH / ms * 1e3:.1f} images/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; parameters "
          f"{got[0]} bytes, moments {got[1]} (predicted {want_p} / {want_m}: "
          f"{n} parameters, {experts} of them the experts'); launches {counts}",
          flush=True)
    if tuple(got) != (want_p, want_m):
        raise AssertionError(f"15a: bytes {got}, predicted {(want_p, want_m)}")
    print(f"15a in {time.perf_counter() - t0:.1f} s", flush=True)
    del runner, model, dev, small
    torch.cuda.empty_cache()
    return counts


def run_moe_seg(tokenizer, classes):
    """15b: ``evaluate_benchmark`` with the 8-expert MoE image tower at 288 px
    on ``MOE_SEG_BATCHES`` batches of 16 (seeded weights, bf16): one CRF
    launch a batch and nothing else (the 325-token pass takes the plain
    attention lane); one batch's predictions against the plain decode
    (>= 99.9%); images/s of towers + decode (CUDA events). Returns the
    counts."""
    from simseg_tpu_torch.ops.seg_decode import make_seg_decode_fn
    from simseg_tpu_torch.tasks.seg_eval import (make_seg_features,
                                                 make_seg_predict,
                                                 zero_shot_classifier)

    t0 = time.perf_counter()
    model = seeded_clip(5, image_arch=(("moe_experts", 8), ("moe_every", 2),
                                       ("moe_capacity", 1.25))).to(
        device="cuda", dtype=torch.bfloat16).eval()
    loader = SyntheticLoader(MOE_SEG_BATCHES, BATCH, len(classes), seed=6)
    counts = drive_eval("15b MoE seg eval", loader, model, tokenizer, classes,
                        input_size=SIZE)
    check_counts("15b", counts, {"crf_mean_field": MOE_SEG_BATCHES})
    text_bank = zero_shot_classifier(model, classes, tokenizer, max_length=25)
    images_u8 = torch.from_numpy(next(iter(loader))["image"]).cuda()
    dense, pooled = make_seg_features(model, input_size=SIZE)(images_u8)
    decode = make_seg_decode_fn(num_classes=len(classes), image_size=SIZE,
                                patch_size=PATCH, top_cls_num=10,
                                bilateral_stride=STRIDE)
    with torch.no_grad():
        pred, _ = decode(dense, pooled, text_bank, images_u8)
    agree = (pred == plain_decode(dense, pooled, text_bank, images_u8,
                                  SIZE)).float().mean().item()
    predict = make_seg_predict(model, len(classes), 10, input_size=SIZE,
                               bilateral_stride=STRIDE)
    ms = cuda_ms(lambda: predict(images_u8, text_bank), 3)
    print(f"15b ({card_line()}): pred agreement kernel vs plain decode "
          f"{agree:.6f}; towers + decode {ms:.3f} ms a batch of {BATCH} = "
          f"{BATCH / ms * 1e3:.1f} images/s; 15b in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if agree < 0.999:
        raise AssertionError(f"15b: pred agreement {agree:.6f} < 0.999")
    del model
    torch.cuda.empty_cache()
    return counts


# -- phase 16: the CRF kernels' bf16 mode, the native decode library --------------

# the bf16 kernels vs their plain versions: between the sound kernels'
# agreement at 16 x 5 x 288^2 (masks 0.999990, the tail's pred 0.999980)
# and the float32 kernels' with the same plain outputs (0.999724,
# 0.999497), so a kernel that rounds to bf16 only at the end fails
BF16_MASK_BAR = 0.99995
BF16_TAIL_BAR = 0.9999
BF16_LANE_BAR = 0.99           # a bf16 lane's pred vs the float32 lane's
# CUDA kernels of one bf16 call (csrc/crf_mean_field_bf16.cu): one
# cooperative launch runs every phase
BF16_KERNELS_A_CALL = 1
BF16_LANES = ("auto", "fused", "fused_tail", "pallas")
# launches per batch of each bf16 lane: {count: n}
BF16_LANE_WANT = {"auto": {"crf_mean_field_bf16": 1},
                  "fused": {"crf_mean_field_bf16": 1},
                  "fused_tail": {"seg_decode_tail_bf16": 1},
                  "pallas": {"bilateral_matvec": 1 + ITERS}}
BF16_EVAL_BATCHES = 1
NATIVE_FILES = 64
NATIVE_THREADS = (1, 8)


# the phases of a bf16 call (csrc/crf_common.cuh, phase_at) at STRIDE 8
BF16_PHASES = (("features and d0", "degree")
               + tuple(f"{kind} {i}" for i in range(ITERS) for kind in ("message", "update"))
               + ("closing",))


def busy_stream_ms(fn, reps=5):
    """Median device ms of one call of fn between two CUDA events, the
    stream held busy (``torch.cuda._sleep``) while the host enqueues the
    call, so that no host time falls between the events (the profiler can
    miss a cooperative launch late in a long process)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1 << 21)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def crf_bf16_phase_ms(fn):
    """{phase: device ms} of a bf16 call's phases, each run alone
    (``crf_mean_field_bf16_phases``) on the workspace the previous call
    left, and "whole": where the time of the one cooperative launch goes."""
    from simseg_tpu_torch.ops import crf_fused

    lib = crf_fused._library()
    out = {}
    try:
        for k, name in enumerate(BF16_PHASES):
            lib.crf_mean_field_bf16_phases(k, k + 1)
            out[name] = busy_stream_ms(fn)
    finally:
        lib.crf_mean_field_bf16_phases(0, 1 << 30)
    out["whole"] = busy_stream_ms(fn)
    return out


def crf_bf16_bound_ms(b, k, h, w, s, radius, iters, nbytes):
    """Least time for the bf16 mode's work: ``nbytes`` over HBM bandwidth,
    against its operations at their types' peaks: the kernel matrix's
    distances and exponentials in float32 (CUDA cores), the products of
    bf16 operands (K.q, the two Gaussian passes) at the bf16 tensor-core
    rate, the update's elementwise work in float32."""
    n = (h // s) * (w // s)
    f32 = b * (n * n * (2 * 5 + 5) + k * iters * h * w * 8)
    bf16 = b * k * iters * (2 * n * n + h * w * 4 * (2 * radius + 1))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32 / F32_FLOP_PER_S + bf16 / BF16_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_crf_bf16(b):
    """16a at batch b: the bf16 mean field (closing inside) against its
    plain version and the float32 kernel; the bf16 tail against the unfused
    bf16 chain (the bf16 mean-field kernel + ``decode_tail``), its plain
    version and the float32 tail; each nearer its plain version than the
    float32 kernel is; exact launches; two calls of each bit-equal; the
    bilateral term dropped and the float32 kernel's output (a kernel that
    rounds only at the end) must fail the bar; bf16 and float32 kernel times
    in turns; the device ms of a call only from a profile that holds its
    one kernel. Returns the JSON fields of both entries (no launches)."""
    from simseg_tpu_torch.ops import crf_fused
    from simseg_tpu_torch.ops.morphology import nearest_upsample
    from simseg_tpu_torch.ops.seg_decode import decode_tail

    label = f"16a b={b}"
    du, rgb = crf_inputs(b)
    kw = dict(stride=STRIDE, num_iters=ITERS, closing_ksize=CLOSING)
    bf = dict(kw, compute_dtype="bfloat16")
    reset_counts()
    masks = crf_fused.mean_field_fused(du, rgb, **bf)
    again = crf_fused.mean_field_fused(du, rgb, **bf)
    check_counts(label, read_counts(), {"crf_mean_field_bf16": 2})
    plain = crf_fused.mean_field_fused_plain(du, rgb, **bf)
    f32 = crf_fused.mean_field_fused(du, rgb, **kw)
    torch.cuda.synchronize()
    agree = (masks == plain).float().mean().item()
    agree32 = (masks.float() == f32).float().mean().item()
    f32_plain = (f32 == plain.float()).float().mean().item()
    max_err = (masks.float() - plain.float()).abs().max().item()
    print(f"{label}: bf16 mean field, masks {masks.dtype}, vs its plain "
          f"version {agree:.6f}, vs the float32 kernel {agree32:.6f} (the "
          f"float32 kernel vs the plain bf16 version {f32_plain:.6f}); two calls "
          f"bit-equal {torch.equal(masks, again)}", flush=True)
    if masks.dtype != torch.bfloat16 or agree < BF16_MASK_BAR:
        raise AssertionError(f"{label}: bf16 kernel vs plain {agree} < "
                             f"{BF16_MASK_BAR} ({masks.dtype})")
    if not agree > f32_plain:
        raise AssertionError(f"{label}: the float32 kernel is as near the plain "
                             f"bf16 version as the bf16 kernel ({agree})")
    if not torch.equal(masks, again):
        raise AssertionError(f"{label}: two bf16 calls differ")
    check_faults(label, {
        "bilateral dropped": crf_fused.mean_field_fused(
            du, rgb, bilateral_compat=0.0, **bf),
        "float32, rounded at the end": f32.to(torch.bfloat16)}, plain, BF16_MASK_BAR)

    k = CLASSES_PER_IMAGE
    du_c = du[:, :, ::PATCH, ::PATCH].contiguous()       # the patch grid
    rng = np.random.default_rng(b + 16)
    scores = torch.from_numpy(rng.uniform(0.1, 0.5, (b, k)).astype(np.float32)).cuda()
    scores[:, -1] = 0.0                                    # an invalid candidate
    idx = torch.from_numpy(np.stack([rng.permutation(np.arange(1, 21))[:k]
                                     for _ in range(b)]).astype(np.int32)).cuda()
    ones = torch.ones_like(scores, dtype=torch.bool)

    def tail(**extra):
        return crf_fused.seg_decode_tail_fused(du_c, rgb, scores, idx, PATCH,
                                               **{**bf, **extra})

    reset_counts()
    pred, best_w = tail()
    check_counts(f"{label} tail", read_counts(), {"seg_decode_tail_bf16": 1})
    again_p, again_w = tail()
    if not (torch.equal(pred, again_p) and torch.equal(best_w, again_w)):
        raise AssertionError(f"{label}: two bf16 tail calls differ")
    chain = crf_fused.mean_field_fused(nearest_upsample(du_c, PATCH).contiguous(),
                                       rgb, **bf)
    chain_p, _ = decode_tail(chain.float(), idx, scores, ones)
    plain_p, plain_w = crf_fused.seg_decode_tail_fused_plain(du_c, rgb, scores,
                                                            idx, PATCH, **bf)
    f32_p, _ = crf_fused.seg_decode_tail_fused(du_c, rgb, scores, idx, PATCH, **kw)
    torch.cuda.synchronize()
    t_chain = (pred == chain_p).float().mean().item()
    t_plain = (pred == plain_p).float().mean().item()
    t_f32 = (pred == f32_p).float().mean().item()
    t_f32_plain = (f32_p == plain_p).float().mean().item()
    tail_err = (best_w - plain_w).abs().max().item()
    print(f"{label}: bf16 tail pred vs the unfused bf16 chain {t_chain:.6f}, vs "
          f"its plain version {t_plain:.6f}, vs the float32 tail {t_f32:.6f} "
          f"(the float32 tail vs the plain bf16 version {t_f32_plain:.6f}); two "
          "calls bit-equal True", flush=True)
    if t_chain < BF16_TAIL_BAR or t_plain < BF16_TAIL_BAR:
        raise AssertionError(f"{label}: bf16 tail agreement {t_chain} / "
                             f"{t_plain} < {BF16_TAIL_BAR}")
    if not t_plain > t_f32_plain:
        raise AssertionError(f"{label}: the float32 tail is as near the plain "
                             f"bf16 version as the bf16 tail ({t_plain})")
    check_faults(f"{label} tail", {"bilateral dropped": tail(
        bilateral_compat=0.0)[0], "float32, rounded at the end": f32_p},
        plain_p, BF16_TAIL_BAR)

    fns = {"bf16": lambda: crf_fused.mean_field_fused(du, rgb, **bf),
           "float32": lambda: crf_fused.mean_field_fused(du, rgb, **kw),
           "tail bf16": lambda: tail(),
           "tail float32": lambda: crf_fused.seg_decode_tail_fused(
               du_c, rgb, scores, idx, PATCH, **kw)}
    names = list(fns)
    times = {name: float(np.mean(t)) for name, t in zip(
        names, in_turns(names, lambda n: fns[names[n]]()))}
    plain_ms = cuda_ms(lambda: crf_fused.mean_field_fused_plain(du, rgb, **bf), 3)
    tail_plain_ms = cuda_ms(lambda: crf_fused.seg_decode_tail_fused_plain(
        du_c, rgb, scores, idx, PATCH, **bf), 3)
    device = {name: device_rows_checked(fn, BF16_KERNELS_A_CALL) for name, fn in (
        ("bf16", lambda: crf_fused.mean_field_fused(du, rgb, **bf)),
        ("tail bf16", lambda: tail()))}
    if b == BATCH:
        device_profile(lambda: crf_fused.mean_field_fused(du, rgb, **bf),
                       f"{label} bf16 kernel", top=10)
        phases = crf_bf16_phase_ms(lambda: crf_fused.mean_field_fused(du, rgb, **bf))
        whole = phases.pop("whole")
        print(f"{label} ({card_line()}): device ms of each phase of the bf16 mean "
              "field run alone (events, the stream kept busy): " + ", ".join(
                  f"{n} {v:.4f}" for n, v in phases.items())
              + f"; their sum {sum(phases.values()):.4f}, the whole call {whole:.4f}",
              flush=True)
    radius = crf_fused.gaussian_constants(SIZE, SIZE, 3.0)[0].shape[0] // 2
    bound, bound_by = crf_bf16_bound_ms(
        b, k, SIZE, SIZE, STRIDE, radius, ITERS,
        du.numel() * 4 + rgb.numel() + masks.numel() * 2)
    tail_bound, tail_by = crf_bf16_bound_ms(
        b, k, SIZE, SIZE, STRIDE, radius, ITERS,
        du_c.numel() * 4 + rgb.numel() + pred.numel() * 8 + 8 * b * k)
    print(f"{label} ({card_line()}): CUDA events in turns, ms a call: "
          + ", ".join(f"{n} {v:.4f}" for n, v in times.items())
          + f"; device ms (CUDA kernels a call, of {BF16_KERNELS_A_CALL}): "
          + ", ".join(f"{n} {'not measured' if d is None else f'{d:.4f}'} ({c})"
                      for n, (d, c) in device.items())
          + f"; plain bf16 {plain_ms:.4f}, tail plain bf16 {tail_plain_ms:.4f}; "
          f"bound {bound:.4f} ({bound_by}), tail {tail_bound:.4f} ({tail_by}); "
          f"share of bound {bound / times['bf16']:.3f}, tail "
          f"{tail_bound / times['tail bf16']:.3f}", flush=True)
    return {"crf_mean_field": dict(
                max_abs_err=max_err, agreement=agree, agreement_f32=agree32,
                f32_agreement_plain=f32_plain,
                ms=times["bf16"], f32_ms=times["float32"],
                device_ms=device["bf16"][0], kernels_per_call=device["bf16"][1],
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None),
            "seg_decode_tail": dict(
                max_abs_err=tail_err, agreement_chain=t_chain,
                agreement_plain=t_plain, agreement_f32=t_f32,
                f32_agreement_plain=t_f32_plain,
                ms=times["tail bf16"], f32_ms=times["tail float32"],
                device_ms=device["tail bf16"][0],
                kernels_per_call=device["tail bf16"][1], plain_ms=tail_plain_ms,
                bound_ms=tail_bound, bound_by=tail_by, library_ms=None)}


def run_bf16_lanes(model, tokenizer, classes):
    """16b: ``evaluate_benchmark`` at batch 64 with ``compute_dtype=
    "bfloat16"`` on the auto, fused, fused_tail and pallas lanes and in
    float32 on the auto lane, the counts set to 0 just before each run and
    read just after (exact launches), each lane's predictions against the
    float32 lane's. Returns {lane: counts}."""
    from simseg_tpu_torch.tasks import seg_eval

    loader = FrozenLoader(BF16_EVAL_BATCHES, BENCH_BATCH, len(classes), seed=16)
    real = seg_eval.make_seg_predict
    preds, out = {}, {}

    def run(lane, dtype):
        got = preds.setdefault((lane, dtype), [])

        def recording(*a, **k):
            predict = real(*a, **k)

            def call(*args, **kws):
                result = predict(*args, **kws)
                got.append(result[0])
                return result
            return call

        with unittest.mock.patch.object(seg_eval, "make_seg_predict", recording):
            counts = drive_eval(f"16b {lane} {dtype}", loader, model, tokenizer,
                                classes, input_size=SIZE, crf_backend=lane,
                                compute_dtype=dtype)
        return torch.cat(got), counts

    ref, counts = run("auto", "float32")
    check_counts("16b auto float32", counts, {"crf_mean_field": BF16_EVAL_BATCHES})
    for lane in BF16_LANES:
        pred, counts = run(lane, "bfloat16")
        check_counts(f"16b {lane} bfloat16", counts,
                     {k: v * BF16_EVAL_BATCHES for k, v in BF16_LANE_WANT[lane].items()})
        agree = (pred == ref).float().mean().item()
        out[lane] = counts
        print(f"16b {lane} bfloat16: pred vs the float32 lane {agree:.6f} "
              f"({pred.numel()} pixels)", flush=True)
        if agree < BF16_LANE_BAR:
            raise AssertionError(f"16b {lane}: {agree} < {BF16_LANE_BAR}")
        if lane != "auto":
            same = (pred == torch.cat(preds[("auto", "bfloat16")])).float().mean().item()
            print(f"16b {lane} bfloat16: pred vs the bf16 auto lane {same:.6f}",
                  flush=True)
    return out


def native_decode_files(root):
    """``NATIVE_FILES`` generated photos under ``root``, half JPEG (PIL) and
    half unfiltered PNG (``png_bytes``), 240-500 px, in a cc3m-layout set
    ``nat`` with captions, and its vocab file."""
    from PIL import Image

    from simseg_tpu_torch.data.tokenizer import make_test_vocab

    rng = np.random.default_rng(1616)
    base = os.path.join(root, "nat", "train")
    os.makedirs(base)
    rows = []
    for i in range(NATIVE_FILES):
        h, w = (int(v) for v in rng.integers(*TRAIN_ENTRY_SIDES, 2))
        photo = synth_photo(rng, h, w)
        name = f"{i:03d}.{'jpg' if i % 2 else 'png'}"
        if i % 2:
            Image.fromarray(photo).save(os.path.join(base, name), quality=90)
        else:
            with open(os.path.join(base, name), "wb") as f:
                f.write(png_bytes(photo, paeth=False, level=1))
        rows.append([name, synth_caption(rng), i, i])
    with open(os.path.join(root, "nat", "train_anno.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["image", "caption", "image_id", "caption_id"])
        writer.writerows(rows)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(make_test_vocab(TRAIN_ENTRY_WORDS)) + "\n")
    return base, vocab


# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = [(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)]


def format_files():
    """16c: one seeded 24 x 40 image in each format the port's readers do
    not take, and a PNG and a 4:2:0 JPEG, as (name, bytes, the decoder
    ``image_io.decoder_of`` must choose for the card)."""
    import io
    import struct
    import zlib

    from PIL import Image

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    img = np.random.default_rng(21).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    out = []
    for name, fmt, kw in (("gif", "GIF", {}), ("webp", "WEBP", {"lossless": True}),
                          ("bmp", "BMP", {}), ("tiff", "TIFF", {}),
                          ("png", "PNG", {}),
                          ("jpeg420", "JPEG", {"subsampling": 2, "quality": 90})):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt, **kw)
        route = {"png": "png", "jpeg420": "nvjpeg"}.get(name, "pil")
        out.append((name, buf.getvalue(), route))
    buf = io.BytesIO()
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(buf, format="PNG")
    out.append(("png16", buf.getvalue(), "pil"))
    grey = img[..., 1]
    raw = b"".join(b"\x00" + row.tobytes() for r0, c0, dr, dc in ADAM7
                   for row in grey[r0::dr, c0::dc] if row.size)
    ihdr = struct.pack(">IIBBBBB", 40, 24, 8, 0, 0, 0, 1)
    out.append(("interlaced", b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""), "pil"))
    with open(os.path.join(TESTDATA, "sampling_411.jpg"), "rb") as f:
        out.append(("jpeg411", f.read(), "pil"))
    return out


def check_decode_formats():
    """16c: every file of ``format_files`` through ``decode_rgb(...,
    "cuda")``: the route its header gives, PIL's pixels on the card for
    the PIL route and the PNG, the 4:2:0 JPEG within phase 8's nvJPEG bar;
    exactly one nvJPEG decode over them all."""
    import io

    from PIL import Image

    from simseg_tpu_torch.data import image_io

    t0 = time.perf_counter()
    files = format_files()
    before = image_io.NVJPEG_DECODES
    for name, data, route in files:
        if image_io.decoder_of(data, "cuda") != route:
            raise AssertionError(f"16c: {name} routed to "
                                 f"{image_io.decoder_of(data, 'cuda')}, not {route}")
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB"))
        got = image_io.decode_rgb(data, "cuda")
        if got.device.type != "cuda":
            raise AssertionError(f"16c: {name} decoded to {got.device}")
        got = got.cpu().numpy()
        if route == "nvjpeg":
            near = float((np.abs(got.astype(np.int32) - want) <= 2).mean())
            if near < NVJPEG_NEAR_BAR:
                raise AssertionError(f"16c: nvJPEG {name} {near} within 2 levels")
        elif not np.array_equal(got, want):
            raise AssertionError(f"16c: {name} on the card differs from PIL's")
    decodes = image_io.NVJPEG_DECODES - before
    print(f"16c formats ({card_line()}): "
          + ", ".join(f"{n} -> {r}" for n, _, r in files)
          + f"; the PIL and PNG routes equal to PIL's pixels on the card, the "
          f"4:2:0 JPEG within {NVJPEG_NEAR_BAR} (2 levels); nvJPEG decodes "
          f"{decodes}; in {time.perf_counter() - t0:.3f} s", flush=True)
    if decodes != 1:
        raise AssertionError(f"16c: {decodes} nvJPEG decodes (want 1)")


def run_native_decode():
    """16c: whether the native decode library built here (and if not, the
    compiler's first error line); on ``NATIVE_FILES`` generated files its PNG
    decodes against ``data/image_io.py``'s reader (bit for bit), and the
    train loader's images/s (the vit-b YAML's train transforms, batch 64)
    with ``data.native_decode`` on and off at 1 and 8 threads. Without the
    library both settings take the same reader, so neither runs."""
    from simseg_tpu_torch.data import native
    from simseg_tpu_torch.data.datasets import CsvPairDataset, DataLoader
    from simseg_tpu_torch.data.image_io import decode_rgb
    from simseg_tpu_torch.data.tokenizer import WordPieceTokenizer
    from simseg_tpu_torch.data.transforms import build_transforms

    check_decode_formats()
    t0 = time.perf_counter()
    built = native.available()
    print(f"16c native decode library: built {built} in "
          f"{time.perf_counter() - t0:.2f} s"
          + ("" if built else f"; why not: {native.build_error()}"), flush=True)
    if not built:
        print("16c: PNG check and loader times not run (no library: both "
              "settings of data.native_decode take the port's reader)", flush=True)
        return built
    with tempfile.TemporaryDirectory() as root:
        base, vocab = native_decode_files(root)
        pngs = sorted(n for n in os.listdir(base) if n.endswith(".png"))
        for name in pngs:
            with open(os.path.join(base, name), "rb") as f:
                data = f.read()
            if not np.array_equal(native.decode(data, fast_scale=False),
                                  decode_rgb(data, "cpu").numpy()):
                raise AssertionError(f"16c: native PNG decode of {name} != "
                                     "the port's reader")
        print(f"16c: {len(pngs)} PNGs decoded by the library bit-equal to "
              "data/image_io.py's reader", flush=True)
        tok = WordPieceTokenizer.from_vocab_file(vocab)
        rates = {}
        for flag in (True, False):
            cfg = parse_entry(["--cfg", ENTRY_YAML, f"data.data_path={root}/",
                               f"data.native_decode={flag}"])
            ds = CsvPairDataset(cfg, "nat", tok, build_transforms(cfg, "train"))
            # a warm-up pass (the first thread count's), then the timed ones
            for threads in NATIVE_THREADS[:1] + NATIVE_THREADS:
                loader = DataLoader(ds, BENCH_BATCH, num_workers=threads)
                random.seed(16)
                t0 = time.perf_counter()
                for batch in loader:
                    if batch["image"].shape[1:] != (224, 224, 3):
                        raise AssertionError(f"16c: batch {batch['image'].shape}")
                rates[(flag, threads)] = NATIVE_FILES / (time.perf_counter() - t0)
    print(f"16c ({card_line()}): train loader images/s over {NATIVE_FILES} "
          "files (host clock), " + ", ".join(
              f"native {'on' if f else 'off'} {t} thread(s) {r:.1f}"
              for (f, t), r in rates.items()), flush=True)
    return built


# -- phase 17: the production-settings parity harness ------------------------

PARITY_SCENES = 8                           # BASELINE.md round 5, 8 scenes
PARITY_CLASSES = 16
PARITY_MARGIN = 0.0015
PARITY_BATCH = 2                            # the harness's data.batch_size_val
# (label, run_parity keywords, the launch count of the lane's CRF kernel)
PARITY_LANES = (
    ("a", dict(crf_dtype="bfloat16"), "crf_mean_field_bf16"),
    ("b", dict(crf_dtype="float32"), "crf_mean_field"),
    ("c", dict(crf_dtype="auto", crf_backend="fused_tail"), "seg_decode_tail"),
    ("d", dict(crf_dtype="bfloat16", tome_r=16), "crf_mean_field_bf16"),
    ("e", dict(crf_dtype="bfloat16", quant="int8_static",
               quant_towers="image"), "crf_mean_field_bf16"),
    ("f", dict(crf_dtype="bfloat16", tome_r=16, quant="int8_static",
               quant_towers="image"), "crf_mean_field_bf16"),
)
# JAX's aligned-fixture gates (tests/test_seg_parity_production.py:182-184).
# Its |mIoU delta| < 2 pt is printed, not gated: on this fixture JAX's own
# harness reads -1.09 pt only through one bf16 candidate flip that adds a
# GT class (about -2.5 pt without it), the port on the CPU matches JAX image
# for image (-2.33 pt) and every lane on an H100 reads -2.38 to -3.40 pt;
# BASELINE.md's int8 lanes read -2.14 to -2.23 pt over 33 scenes
PARITY_PIXEL_BAR = 0.04
PARITY_MIOU_BAR = 0.02
PARITY_FLIPS_BAR = PARITY_SCENES // 4
# BASELINE.md round 5: a lane adds <= 1.5 pt of noflip pooled mIoU over (a)
PARITY_LANE_BUDGET = 0.015
CRF_BINARY_BAR = 0.999


def write_parity_fixture(root):
    """Phase 17's fixture: ``build_fixture`` (aligned, 8 scenes, 16 classes,
    seed 0, screened at a margin of 0.0015) and the reference side's result
    (``reference.npz``), on the host, two torch threads."""
    from simseg_tpu_torch.tools import seg_parity

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    os.makedirs(root)
    classes, tmodel, _, tried = seg_parity.build_fixture(
        root, PARITY_SCENES, PARITY_CLASSES, 0, SIZE,
        screen_margin=PARITY_MARGIN, fixture="aligned")
    t1 = time.perf_counter()
    ref = seg_parity.reference_side(root, classes, tmodel, tried)
    seg_parity.save_reference(os.path.join(root, "reference.npz"), ref)
    print(f"17 fixture: {PARITY_SCENES} scenes of {tried} drawn in "
          f"{t1 - t0:.1f} s, the reference side in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)


def noflip_miou_delta(out) -> float:
    from simseg_tpu_torch.tools.seg_parity import pooled_deltas

    return pooled_deltas([out], "noflip_totals_ours", "noflip_totals_ref")[0]


def parity_failures(out, base=None) -> list:
    """The bars ``out`` fails: JAX's pixel and flip gates, and, where
    ``base`` (lane (a)'s result) is given, the noflip mIoU budget against
    it."""
    failed = []
    if not out["pixel_disagreement"] < PARITY_PIXEL_BAR:
        failed.append("pixel")
    if not out["candidate_set_flips"] <= PARITY_FLIPS_BAR:
        failed.append("flips")
    if base is not None and not (noflip_miou_delta(out)
                                 >= noflip_miou_delta(base) - PARITY_LANE_BUDGET):
        failed.append("noflip budget")
    return failed


def parity_lane(label, root, reference, kw, row):
    """One lane of ``seg_parity.run_parity`` on the card against the shared
    reference, with the counts set to 0 just before and read just after:
    exactly one launch of the lane's CRF kernel a batch and no other."""
    from simseg_tpu_torch.tools import seg_parity

    reset_counts()
    t0 = time.perf_counter()
    out = seg_parity.run_parity(PARITY_SCENES, PARITY_CLASSES, 0, SIZE,
                                root=root, screen_margin=PARITY_MARGIN,
                                fixture="aligned", reference=reference, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    check_counts(f"17{label}", counts, {row: PARITY_SCENES // PARITY_BATCH})
    print(f"17{label} {kw}: pixel {out['pixel_disagreement']:.5f}, noflip "
          f"pixel {out['noflip_pixel_disagreement']:.5f}, mIoU delta "
          f"{100 * out['miou_delta']:+.3f} pt (ours {out['miou_ours']:.4f}, "
          f"reference {out['miou_ref']:.4f}), noflip pooled mIoU delta "
          f"{100 * noflip_miou_delta(out):+.3f} pt, largest class delta "
          f"{100 * out['max_class_iou_delta']:.3f} pt, flips "
          f"{out['candidate_set_flips']}/{PARITY_SCENES}, launches "
          f"crf_mean_field {counts['crf_mean_field']} crf_mean_field_bf16 "
          f"{counts['crf_mean_field_bf16']} seg_decode_tail "
          f"{counts['seg_decode_tail']}, {secs:.2f} s", flush=True)
    return out, counts


def check_crf_binary(root):
    """``ops/crf.dense_crf_binary`` on the card takes the kernel lane by
    default: one launch of row 1 for one image's 3 maps at stride 8, masks
    against the plain lane on the host >= ``CRF_BINARY_BAR``."""
    from PIL import Image

    from simseg_tpu_torch.ops.crf import dense_crf_binary

    path = os.path.join(root, "VOCdevkit", "VOC2012", "JPEGImages",
                        "2007_000000.jpg")
    rgb = torch.from_numpy(np.asarray(Image.open(path).convert("RGB")).copy())
    # a patch-grid probability map upsampled x16, the decode's form
    g = torch.Generator().manual_seed(17)
    probs = torch.rand((3, SIZE // PATCH, SIZE // PATCH), generator=g)
    probs = probs.repeat_interleave(PATCH, 1).repeat_interleave(PATCH, 2)
    reset_counts()
    got = dense_crf_binary(probs.cuda(), rgb.cuda(), bilateral_stride=STRIDE)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("17 dense_crf_binary", counts, {"crf_mean_field": 1})
    want = dense_crf_binary(probs, rgb, bilateral_stride=STRIDE)
    agree = (got.cpu() == want).float().mean().item()
    print(f"17 dense_crf_binary: 1 launch of crf_mean_field, masks "
          f"{agree:.6f} of the plain lane's", flush=True)
    if agree < CRF_BINARY_BAR:
        raise AssertionError(f"dense_crf_binary: {agree} < {CRF_BINARY_BAR}")


def run_parity_lanes():
    """Phase 17: the six lanes against one reference run, their bars, the
    planted fault and ``dense_crf_binary``. Returns the lanes' counts."""
    from simseg_tpu_torch.tasks import seg_eval
    from simseg_tpu_torch.tools import seg_parity

    root = parity_fixture()
    t0 = time.perf_counter()
    reference = seg_parity.load_reference(os.path.join(root, "reference.npz"))
    outs, counts = {}, {}
    for label, kw, row in PARITY_LANES:
        outs[label], counts[label] = parity_lane(label, root, reference, kw,
                                                 row)
    failed = {label: parity_failures(out, None if label == "a" else outs["a"])
              for label, out in outs.items()}
    # planted fault: lane (a) with the GT size handed to the nearest resize
    # in OpenCV's (width, height) order, as a cv2-minded port would
    resize = seg_eval.resize_nearest_to_padded
    with unittest.mock.patch.object(
            seg_eval, "resize_nearest_to_padded",
            lambda pred, h, w, *a, **k: resize(pred, w, h, *a, **k)):
        fault, _ = parity_lane("a, planted fault (GT size as (w, h))", root,
                               reference, PARITY_LANES[0][1],
                               PARITY_LANES[0][2])
    fault_failed = parity_failures(fault)
    print(f"17 bars: {failed}; the planted fault fails {fault_failed}; "
          f"|mIoU delta| < {100 * PARITY_MIOU_BAR:.0f} pt (not gated) in "
          f"{[k for k, o in outs.items() if abs(o['miou_delta']) < PARITY_MIOU_BAR]}"
          f" and the fault: {abs(fault['miou_delta']) < PARITY_MIOU_BAR}",
          flush=True)
    if any(failed.values()):
        raise AssertionError(f"17: lanes fail their bars: {failed}")
    if not fault_failed:
        raise AssertionError("17: the planted fault passes every bar")
    check_crf_binary(root)
    print(f"17 parity lanes in {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def build_all(later=()):
    """Builds the five kernels and the nvJPEG binding with one nvcc process
    each, all started together; waits for every source but those named in
    ``later`` and returns a function that waits for those (nothing may call
    their kernels before it has returned)."""
    from simseg_tpu_torch.ops import cuda_build

    sources = [(name, ()) for name in KERNELS] + [("nvjpeg_decode", ("-lnvjpeg",))]
    t0 = time.perf_counter()

    def build(job):
        cuda_build.build_library(*job)
        return time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(sources))
    jobs = {job[0]: pool.submit(build, job) for job in sources}
    pool.shutdown(wait=False)

    def wait(names):
        for name in names:
            t_wait = time.perf_counter()
            built = jobs[name].result()
            print(f"build: {name}.cu in {built:.2f} s (waited "
                  f"{time.perf_counter() - t_wait:.2f} s for it)", flush=True)

    wait([name for name in jobs if name not in later])
    return lambda: wait(later)


FWD_TREE_SHAPES = ((BATCH, LONG_T, False), (BATCH, ROWBLOCK_T, False),
                   (BATCH, STREAM_T, False), (TRAIN_BATCH, LONG_T, True))


def compare_attention_trees(trees) -> None:
    """``python3 chip_smoke.py --attention-trees DIR ...``: the attention
    kernels of each tree (a checkout of this repository, e.g. an earlier
    commit unpacked with ``git archive``), built with nvcc from its own
    ``simseg_tpu_torch/csrc`` and launched through this tree's wrappers
    (the C interfaces are the same), on the same inputs. The forward:
    checked against the plain version at (2, 1297, 12, 64), then timed with
    CUDA events in turns (the trees in order, then in reverse) at
    ``FWD_TREE_SHAPES`` (the last with the log-sum-exp), beside SDPA and
    the bound. The backward at (32, 1297, 12, 64), fed this tree's forward
    output and log-sum-exp: timed the same way, its dq, dk, dv compared bit
    for bit with the first tree's."""
    import ctypes
    import torch.nn.functional as F

    from simseg_tpu_torch.ops import cuda_build
    from simseg_tpu_torch.ops import flash_attention as fa

    out_dir = tempfile.mkdtemp(prefix="attention_trees_")
    getters = {"flash_attention": fa._library, "flash_attention_bwd": fa._bwd_library}

    def build(job):
        """The tree's library, its functions declared by the wrapper's own
        loader (``fa._library`` or ``fa._bwd_library``, uncached)."""
        i, name = job
        csrc = os.path.join(trees[i], "simseg_tpu_torch", "csrc")
        path = os.path.join(out_dir, f"lib{name}{i}.so")
        proc = subprocess.run(
            [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", csrc,
             "-o", path, os.path.join(csrc, f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc}/{name}.cu:\n{proc.stderr}")
        return path

    jobs = [(i, name) for name in getters for i in range(len(trees))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(build, jobs))
    libs = {name: [] for name in getters}
    for (_, name), path in zip(jobs, paths):
        lib = ctypes.CDLL(path)
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        with unittest.mock.patch.object(cuda_build, "load_library", lambda _: lib):
            libs[name].append(getters[name].__wrapped__())

    def using(n, fn):
        """fn() with tree n's libraries behind the wrappers."""
        with unittest.mock.patch.object(fa, "_library", lambda: libs["flash_attention"][n]), \
                unittest.mock.patch.object(fa, "_bwd_library",
                                           lambda: libs["flash_attention_bwd"][n]):
            return fn()

    def in_turns(fn):
        times = [[] for _ in trees]
        for n in list(range(len(trees))) + list(reversed(range(len(trees)))):
            times[n].append(using(n, lambda: cuda_ms(fn, 20)))
        return times

    q, k, v = seeded_qkv(LONG_T, 2, LONG_T)
    want = fa.flash_mha_plain(q, k, v)
    for n, tree in enumerate(trees):
        _, rel = attention_errors(using(n, lambda: fa._launch(q, k, v)), want)
        print(f"tree {tree}: forward (2, {LONG_T}) vs plain: relative max "
              f"{rel[0]:.3e}, mean {rel[1]:.3e}, scale {rel[2]:.3e}", flush=True)
        if not within_fwd_bars(rel):
            raise AssertionError(f"tree {tree}: relative error {rel}")
    for b, t, with_lse in FWD_TREE_SHAPES:
        q, k, v = seeded_qkv(t, b, t)
        times = in_turns(lambda: fa._launch(q, k, v, with_lse=with_lse))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=1.0), 20)
        bound = attention_bound_ms(b, t, 4, 4 * b * t * HEADS * HEAD_DIM * 2)[0]
        for tree, ts in zip(trees, times):
            ms = min(ts)
            print(f"tree {tree}: forward ({b}, {t})"
                  f"{' with lse' if with_lse else ''}: {ts[0]:.4f} / {ts[1]:.4f} "
                  f"ms, sdpa {sdpa_ms:.4f}, kernel / sdpa {ms / sdpa_ms:.3f}, "
                  f"share of bound {bound / ms:.3f}", flush=True)
        del q, k, v, qt, kt, vt
    q, k, v, g = seeded_qkv(LONG_T + TRAIN_BATCH, TRAIN_BATCH, LONG_T, n=4)
    out, lse = fa._launch(q, k, v, with_lse=True)

    def backward():
        return fa.flash_mha_train_bwd(q, k, v, out, g, lse)

    first = using(0, backward)
    times = in_turns(backward)
    for n, (tree, ts) in enumerate(zip(trees, times)):
        same = all(torch.equal(x, y) for x, y in zip(using(n, backward), first))
        print(f"tree {tree}: backward ({TRAIN_BATCH}, {LONG_T}): {ts[0]:.4f} / "
              f"{ts[1]:.4f} ms; dq, dk, dv bit-equal to the first tree's: {same}",
              flush=True)
    shutil.rmtree(out_dir)


def tree_modules(trees, source, module, ptxas=False):
    """For each tree (a checkout of this repository, e.g. an earlier commit
    unpacked with ``git archive``): its ``simseg_tpu_torch/csrc/<source>.cu``
    (and, for the CRF, ``crf_mean_field_bf16.cu`` where the tree has it)
    built with nvcc (one process per source and tree, all started together)
    and its own ``simseg_tpu_torch/ops/<module>.py`` imported with its
    ``_library`` serving those builds, since the C interface may differ
    between trees. Returns the modules and the directory of the builds (the
    caller removes it); with ptxas, prints each kernel's registers and
    spills."""
    import ctypes
    import importlib.util
    import re

    from simseg_tpu_torch.ops import cuda_build

    out_dir = tempfile.mkdtemp(prefix=f"{source}_trees_")

    def sources(i):
        csrc = os.path.join(trees[i], "simseg_tpu_torch", "csrc")
        extra = [f"{source}_bf16"] if source == "crf_mean_field" and os.path.exists(
            os.path.join(csrc, f"{source}_bf16.cu")) else []
        return [source] + extra

    def build(job):
        i, name = job
        csrc = os.path.join(trees[i], "simseg_tpu_torch", "csrc")
        path = os.path.join(out_dir, f"lib{name}{i}.so")
        proc = subprocess.run(
            [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", csrc,
             *(["-Xptxas", "-v"] if ptxas else []), "-o", path,
             os.path.join(csrc, f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc}/{name}.cu:\n"
                               f"{proc.stderr}")
        return path, proc.stderr

    jobs = [(i, name) for i in range(len(trees)) for name in sources(i)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(build, jobs)))
    mods = []
    for i in range(len(trees)):
        libs = {}
        for name in sources(i):
            path, log = built[i, name]
            if ptxas:
                # "Compiling entry function '<mangled>'" ... "Used R
                # registers"; the template arguments of each instance, as
                # ILi5ELi5E
                kernels = re.findall(r"Compiling entry function '(\w+)'.*?"
                                     r"(\d+) bytes spill stores, (\d+) bytes spill "
                                     r"loads.*?Used (\d+) registers", log, re.S)
                print(f"tree {trees[i]}: {name} ptxas (instance: registers, spill "
                      "stores/loads): " + "; ".join(
                          f"{'/'.join(re.findall(r'Li(\d+)E', k)) or k[-24:]}: "
                          f"{regs}, {st}/{ld}" for k, st, ld, regs in kernels),
                      flush=True)
            lib = ctypes.CDLL(path)
            err = getattr(lib, f"{name}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            libs[name] = lib
        spec = importlib.util.spec_from_file_location(
            f"{module}_tree{i}",
            os.path.join(trees[i], "simseg_tpu_torch", "ops", f"{module}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with unittest.mock.patch.object(cuda_build, "load_library",
                                        lambda name, *_: libs[name]):
            lib = mod._library.__wrapped__()
        mod._library = lambda lib=lib: lib
        mods.append(mod)
    return mods, out_dir


def in_turns(trees, fn):
    """CUDA-event ms of fn(n) for each tree n, the trees in order and then
    in reverse: [[a, b] per tree]."""
    times = [[] for _ in trees]
    for n in list(range(len(trees))) + list(reversed(range(len(trees)))):
        times[n].append(cuda_ms(lambda: fn(n), 20))
    return times


def compare_crf_trees(trees) -> None:
    """``python3 chip_smoke.py --crf-trees DIR ...``: the CRF kernel of each
    tree (``tree_modules``: its ``csrc/crf_mean_field.cu`` launched through
    its own ``ops/crf_fused.py``), on phase 3's and 3g's inputs at (16, 5,
    288 x 288, stride 8), the mean field also at 64 images: both entry
    points checked against the first tree's plain versions (>= 99.9% of
    masks, of pred and of best_w), then timed with CUDA events in turns
    (the trees in order, then in reverse), with each tree's device time and
    CUDA kernels per call."""
    mods, out_dir = tree_modules(trees, "crf_mean_field", "crf_fused")
    du, rgb = crf_inputs(BATCH)
    du64, rgb64 = crf_inputs(BENCH_BATCH)
    du_c, rgb_t, scores, idx = tail_inputs()
    kw = dict(stride=STRIDE, num_iters=ITERS, closing_ksize=CLOSING)
    calls = {("mean field", BATCH): lambda mod: mod.mean_field_fused(du, rgb, **kw),
             ("mean field", BENCH_BATCH): lambda mod: mod.mean_field_fused(
                 du64, rgb64, **kw),
             ("decode tail", BATCH): lambda mod: mod.seg_decode_tail_fused(
                 du_c, rgb_t, scores, idx, PATCH, **kw)}
    want = dict(zip(calls, (
        (mods[0].mean_field_fused_plain(du, rgb, **kw),),
        (mods[0].mean_field_fused_plain(du64, rgb64, **kw),),
        mods[0].seg_decode_tail_fused_plain(du_c, rgb_t, scores, idx, PATCH,
                                            **kw))))
    for (name, b), call in calls.items():
        shape = f"{name} ({b}, {CLASSES_PER_IMAGE}, {SIZE}, stride {STRIDE})"
        for tree, mod in zip(trees, mods):
            got = call(mod)
            got = got if isinstance(got, tuple) else (got,)
            agree = min((g == w).float().mean().item()
                        for g, w in zip(got, want[name, b]))
            print(f"tree {tree}: {shape} vs plain agreement {agree:.6f}",
                  flush=True)
            if agree < 0.999:
                raise AssertionError(f"tree {tree}: {shape} agreement {agree}")
        times = in_turns(trees, lambda n: call(mods[n]))
        for tree, mod, ts in zip(trees, mods, times):
            device, kernels, _ = device_rows(lambda: call(mod))
            print(f"tree {tree}: {shape}: {ts[0]:.4f} / {ts[1]:.4f} ms, device "
                  f"{device:.4f} ms in {kernels} CUDA kernels per call; us by "
                  f"launch {launch_times(lambda: call(mod))}", flush=True)
    shutil.rmtree(out_dir)


def compare_bilateral_trees(trees) -> None:
    """``python3 chip_smoke.py --bilateral-trees DIR ...``: the bilateral
    kernel of each tree (``tree_modules``: its ``csrc/bilateral_matvec.cu``,
    registers and spills printed, launched through its own
    ``ops/crf_pallas.py``) on phase 3c's inputs at 16 images x 5184 cells:
    C = 1 (the degree), C = 5 with q the stream lane's transposed view and
    contiguous, and C = 5 on one image through the unbatched wrapper. Each
    tree is checked against the float64 plain version (relative error <=
    1e-5) and for two bit-equal calls, then timed with CUDA events in
    turns (the trees in order, then in reverse), with its device time, CUDA
    kernels per call and share of the bound; the SM clock under load is
    read once, on the last tree."""
    from simseg_tpu_torch.ops import crf_pallas

    mods, out_dir = tree_modules(trees, "bilateral_matvec", "crf_pallas",
                                 ptxas=True)
    feat, ones, q5, q5t = bilateral_inputs()
    n, used = feat.shape[1], feat.shape[2]
    print("SM clock, power under load (the last tree, C = 5): "
          f"{busy_clock(lambda: mods[-1].bilateral_matvec_batched(feat, q5t))}",
          flush=True)
    calls = {
        f"C=1 ({BATCH}, {n})": (
            lambda mod: mod.bilateral_matvec_batched(feat, ones),
            (feat, ones), bilateral_bound_ms(BATCH, n, used, 1)[0]),
        f"C=5 ({BATCH}, {n}) q a view": (
            lambda mod: mod.bilateral_matvec_batched(feat, q5t),
            (feat, q5t), bilateral_bound_ms(BATCH, n, used, 5)[0]),
        f"C=5 ({BATCH}, {n}) q contiguous": (
            lambda mod: mod.bilateral_matvec_batched(feat, q5),
            (feat, q5), bilateral_bound_ms(BATCH, n, used, 5)[0]),
        f"C=5 one image (1, {n})": (
            lambda mod: mod.bilateral_matvec(feat[0], q5[0]),
            (feat[:1], q5[:1]), bilateral_bound_ms(1, n, used, 5)[0])}
    for name, (call, (f, q), bound) in calls.items():
        want = crf_pallas.bilateral_matvec_plain(f.double(), q.double())
        for tree, mod in zip(trees, mods):
            got = call(mod).reshape(want.shape)
            rel = bilateral_rel(got, want)
            same = torch.equal(got, call(mod).reshape(want.shape))
            print(f"tree {tree}: {name} vs float64 plain relative {rel:.3e}, "
                  f"two calls bit-equal {same}", flush=True)
            if rel > BILATERAL_BAR or not same:
                raise AssertionError(f"tree {tree}: {name}: relative {rel}, "
                                     f"bit-equal {same}")
        del want
        times = in_turns(trees, lambda i: call(mods[i]))
        for tree, mod, ts in zip(trees, mods, times):
            device, kernels, _ = device_rows(lambda: call(mod))
            print(f"tree {tree}: {name}: {ts[0]:.4f} / {ts[1]:.4f} ms, device "
                  f"{device:.4f} ms in {kernels} CUDA kernels per call, bound "
                  f"{bound:.4f} ms, share of bound {bound / min(ts):.3f}",
                  flush=True)
    shutil.rmtree(out_dir)


# the attention lanes of --grad-trees: (lane, wrapper, batch, T)
GRAD_TREE_LANES = (("flash", "flash_mha", 4, LONG_T),
                   ("train", "flash_mha_train", 8, LONG_T),
                   ("rowblock", "flash_mha_rowblock", 4, 1601),
                   ("stream", "flash_mha_stream", 2, 4097))


def grad_tree_worker(tree, out) -> None:
    """One tree of ``--grad-trees``, in a process of its own with ``tree``
    first on the path: each attention lane's output and q, k, v gradients
    on seeded bf16 inputs and a seeded g, and the launch counts, saved to
    ``out``."""
    sys.path.insert(0, os.path.abspath(tree))
    from simseg_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(os.path.abspath(tree)):
        raise AssertionError(f"{fa.__file__} is not under {tree}")
    res = {}
    for lane, name, b, t in GRAD_TREE_LANES:
        gen = torch.Generator().manual_seed(7)
        q, k, v, g = (torch.randn(b, t, HEADS, HEAD_DIM, generator=gen)
                      for _ in range(4))
        leaves = [x.to("cuda", torch.bfloat16).requires_grad_()
                  for x in (q * HEAD_DIM ** -0.5, k, v)]
        o = getattr(fa, name)(*leaves)
        o.backward(g.to("cuda", torch.bfloat16))
        res[lane] = [o.detach().cpu()] + [x.grad.cpu() for x in leaves]
    torch.cuda.synchronize()
    res["counts"] = [fa.LAUNCHES, fa.BWD_LAUNCHES, dict(fa.LANE_CALLS)]
    torch.save(res, out)


def compare_grad_trees(trees) -> None:
    """``python3 chip_smoke.py --grad-trees DIR ...``: the attention lanes'
    outputs and gradients (``GRAD_TREE_LANES``) of each tree (a checkout,
    e.g. an earlier commit unpacked with git archive), each in its own
    process, held bit for bit against the first tree's, with the launch
    counts."""
    with tempfile.TemporaryDirectory() as tmp:
        results = []
        for i, tree in enumerate(trees):
            out = os.path.join(tmp, f"tree{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--grad-tree-worker", tree, out], check=True,
                           timeout=DIST_LIMIT)
            results.append(torch.load(out))
        for tree, res in zip(trees[1:], results[1:]):
            for key, want in results[0].items():
                same = (res[key] == want if key == "counts" else
                        all(torch.equal(a, b) for a, b in zip(res[key], want)))
                print(f"grad-trees {tree} against {trees[0]}, {key}: "
                      f"bit-equal {same}", flush=True)
                if not same:
                    raise AssertionError(f"{tree}: {key} differs from {trees[0]}")


def main() -> None:
    if sys.argv[1:2] == ["--write-fixtures"]:   # host work alone: no card
        return write_fixtures(sys.argv[2])
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke needs one")
    if sys.argv[1:2] == ["--rank-worker"]:
        return run_rank_worker(sys.argv[2])
    if sys.argv[1:2] == ["--mp-worker"]:
        return run_mp_worker(*sys.argv[2:6])
    if sys.argv[1:2] == ["--serve-worker"]:
        return run_serve_worker(sys.argv[2])
    if sys.argv[1:2] == ["--serve-export"]:
        return run_serve_export(*sys.argv[2:6])
    if sys.argv[1:2] == ["--attention-trees"]:
        print(f"card: {card_line()}", flush=True)
        return compare_attention_trees(sys.argv[2:])
    if sys.argv[1:2] == ["--crf-trees"]:
        print(f"card: {card_line()}", flush=True)
        return compare_crf_trees(sys.argv[2:])
    if sys.argv[1:2] == ["--grad-tree-worker"]:
        return grad_tree_worker(*sys.argv[2:4])
    if sys.argv[1:2] == ["--grad-trees"]:
        print(f"card: {card_line()}", flush=True)
        return compare_grad_trees(sys.argv[2:])
    if sys.argv[1:2] == ["--bilateral-trees"]:
        print(f"card: {card_line()}", flush=True)
        return compare_bilateral_trees(sys.argv[2:])
    import simseg_tpu_torch  # noqa: F401  (fails outside a checkout)

    if sys.argv[1:2] == ["--entry-point"]:
        print(f"card: {card_line()}", flush=True)
        build_all()
        run_entry_point()
        return None
    if sys.argv[1:2] == ["--train-entry"]:
        print(f"card: {card_line()}", flush=True)
        build_all()
        run_train_entry()
        return None
    if sys.argv[1:2] == ["--big-batch"]:
        print(f"card: {card_line()}", flush=True)
        build_all()
        run_big_batch()
        return None
    if sys.argv[1:2] == ["--distributed"]:
        print(f"card: {card_line()}", flush=True)
        build_all()
        run_distributed()
        return None
    if sys.argv[1:2] == ["--linear-probe"]:
        print(f"card: {card_line()}", flush=True)
        build_all()
        run_linear_probe()
        return None
    if sys.argv[1:2] == ["--serving"]:
        print(f"card: {card_line()}", flush=True)
        build_all()
        run_serving()
        return None
    if sys.argv[1:2] == ["--model-parallel"]:
        print(f"card: {card_line()}", flush=True)
        build_all()
        with tempfile.TemporaryDirectory() as tmp:
            run_moe_train(tmp)
        run_moe_seg(*seg_vocab())
        run_model_parallel()
        return None
    if sys.argv[1:2] == ["--bf16-native"]:
        print(f"card: {card_line()}", flush=True)
        build_all()
        check_crf_bf16(BATCH)
        check_crf_bf16(BENCH_BATCH)
        run_bf16_lanes(*slice_setup())
        run_native_decode()
        return None
    if sys.argv[1:2] == ["--seg-parity"]:
        print(f"card: {card_line()}", flush=True)
        start_fixtures()
        build_all()
        run_parity_lanes()
        return None
    if sys.argv[1:2] == ["--model-parallel-nccl"]:
        print(f"card: {card_line()}", flush=True)
        run_model_parallel_nccl()
        return None

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must be full float32 (TF32 on)")
    t_run = time.perf_counter()
    start_fixtures()
    crf_built = build_all(later=CRF_SOURCES)

    def phase_done(label, t_from):
        print(f"{label} in {time.perf_counter() - t_from:.1f} s (the run at "
              f"{time.perf_counter() - t_run:.1f} s)", flush=True)
        return time.perf_counter()

    t_phase = time.perf_counter()
    attn = {t: check_flash_kernel(t, profile=t == LONG_T) for t in ATTN_TS}
    bilateral = check_bilateral_kernel()
    for t in BWD_TS:
        check_flash_bwd_kernel(t)
    # the training slice's shape: the JSON line's numbers
    attn_bwd = check_flash_bwd_kernel(LONG_T, TRAIN_BATCH, profile=True)
    fwd = {t: check_flash_kernel(t, long_lane(t, False), profile=t == STREAM_T)
           for t in LONG_FWD_TS}
    bwd = {(b, t): check_flash_bwd_kernel(t, b, long_lane(t, True))
           for b, t in LONG_BWD}
    # the JSON line's numbers: each lane at its slice's shape
    long_fwd = {"rowblock": fwd[ROWBLOCK_T], "stream": fwd[STREAM_T]}
    long_bwd = {lane: {"bwd_shape": [b, t, HEADS, HEAD_DIM],
                       **{f"bwd_{k}": v for k, v in bwd[b, t].items()
                          if k != "bound_by"}}
                for lane, (b, t) in (("rowblock", LONG_BWD[0]),
                                     ("stream", LONG_BWD[-1]))}
    torch.cuda.empty_cache()
    t_phase = phase_done("3 kernel checks, attention and bilateral", t_phase)
    # the training slice and the pretraining entry point take no CRF: they
    # run while the CRF sources build
    with tempfile.TemporaryDirectory() as tmp:
        train_counts, row_train_counts = run_train_slice(tmp)
    t_phase = phase_done("6 training slice", t_phase)
    torch.cuda.empty_cache()
    train_entry = run_train_entry()
    t_phase = phase_done("9 train entry point (16d its trace)", t_phase)
    torch.cuda.empty_cache()
    native_built = run_native_decode()
    t_phase = phase_done("16c native decode", t_phase)
    crf_built()
    crf = check_crf_kernel(BATCH)
    check_crf_kernel(BENCH_BATCH)
    tail = check_tail_kernel()
    t_phase = phase_done("3 kernel checks, CRF and decode tail", t_phase)
    bf16 = check_crf_bf16(BATCH)
    check_crf_bf16(BENCH_BATCH)
    t_phase = phase_done("16a bf16 CRF kernels", t_phase)

    model, tokenizer, classes = slice_setup()
    crf_launches = run_slice(model, tokenizer, classes)
    ms_counts = run_multiscale_slice("multi-scale", model, tokenizer, classes,
                                     (1.0, 2.0), 2, {"flash": 36}, BATCH)
    win_counts = run_window_slice(model, tokenizer, classes)
    # 4 images: the plain 1152-px tower holds (4, 12, 5185, 5185) bf16
    # scores, 2.6 GB, several times over
    long_counts = run_multiscale_slice(
        "long multi-scale", model, tokenizer, classes, LONG_SCALES, 8,
        {"rowblock": 36, "stream": 36}, 4)
    tail_counts = run_fused_tail_slice(model, tokenizer, classes)
    check_checkpoint()
    t_phase = phase_done("4-5 segmentation slices and checkpoint", t_phase)
    bf16_lanes = run_bf16_lanes(model, tokenizer, classes)
    t_phase = phase_done("16b bf16 lanes", t_phase)
    del model
    torch.cuda.empty_cache()
    run_lanes(tokenizer, classes)
    t_phase = phase_done("7 lanes", t_phase)
    entry = run_entry_point()
    t_phase = phase_done("8 seg entry point", t_phase)
    torch.cuda.empty_cache()
    big = run_big_batch()
    t_phase = phase_done("10 big batch", t_phase)
    torch.cuda.empty_cache()
    dist = run_distributed()
    t_phase = phase_done("11 data parallelism", t_phase)
    torch.cuda.empty_cache()
    cnn = run_linear_probe(tokenizer, classes)
    t_phase = phase_done("12 linear probe", t_phase)
    torch.cuda.empty_cache()
    serve, parity = run_serving(beside=run_parity_lanes)
    t_phase = phase_done("13 serving, 17 beside its loading process", t_phase)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        moe = run_moe_train(tmp)
    moe_seg = run_moe_seg(tokenizer, classes)
    t_phase = phase_done("15 (a, b) MoE towers", t_phase)
    mp, pp = run_model_parallel()
    phase_done("14 sharded state and 15 (c, d) EP and PP", t_phase)

    print(json.dumps({"kernels": [
        {"name": "crf_mean_field", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/crf_mean_field.cu",
         "replaces": "simseg_tpu/ops/crf_fused.py:304",
         "launches": crf_launches,
         "cli_launches": entry["auto"]["crf_mean_field"],
         "dist_launches": dist["crf_mean_field"],
         "cnn_launches": cnn["crf_mean_field"],
         "serving_launches": serve["a"]["crf_mean_field"],
         "moe_seg_launches": moe_seg["crf_mean_field"],
         "parity_launches": parity["b"]["crf_mean_field"], "library_ms": None,
         **crf},
        {"name": "flash_attention", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/flash_attention.cu",
         "replaces": "simseg_tpu/ops/flash_attention.py:180",
         "launches": ms_counts["flash_attention"],
         "cli_launches": entry["scales (1.0, 2.0)"]["flash_attention"],
         "train_entry_launches": train_entry["B"]["flash_attention"],
         "bsgs_launches": big["flash_attention"],
         "dist_launches": dist["flash_attention"],
         "serving_launches": serve["b_scales_tail"]["flash_attention"],
         "mp_launches": mp["flash_attention"],
         "moe_launches": moe["flash_attention"],
         "pp_launches": pp["flash_attention"],
         **attn[LONG_T]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "simseg_tpu/ops/flash_attention.py:202",
         "launches": train_counts["flash_attention_bwd"],
         "train_entry_launches": train_entry["B"]["flash_attention_bwd"],
         "bsgs_launches": big["flash_attention_bwd"],
         "dist_launches": dist["flash_attention_bwd"],
         "mp_launches": mp["flash_attention_bwd"],
         "moe_launches": moe["flash_attention_bwd"],
         "pp_launches": pp["flash_attention_bwd"],
         **attn_bwd},
        {"name": "bilateral_matvec", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/bilateral_matvec.cu",
         "replaces": "simseg_tpu/ops/crf_pallas.py:125",
         "launches": win_counts["bilateral_matvec"],
         "cli_launches": entry["pallas"]["bilateral_matvec"],
         "dist_launches": [0] * DIST_WORLD,
         "serving_launches": serve["b_window"]["bilateral_matvec"],
         **bilateral},
        {"name": "seg_decode_tail", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/crf_mean_field.cu",
         "replaces": "simseg_tpu/ops/crf_fused.py:425",
         "launches": tail_counts["seg_decode_tail"],
         "cli_launches": entry["fused_tail"]["seg_decode_tail"],
         "dist_launches": [0] * DIST_WORLD,
         "cnn_launches": cnn["seg_decode_tail"],
         "serving_launches": serve["b_scales_tail"]["seg_decode_tail"],
         "parity_launches": parity["c"]["seg_decode_tail"],
         **tail},
        {"name": "crf_mean_field (bf16)", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/crf_mean_field_bf16.cu",
         "replaces": "simseg_tpu/ops/crf_fused.py:304",
         "launches": bf16_lanes["auto"]["crf_mean_field_bf16"],
         "fused_launches": bf16_lanes["fused"]["crf_mean_field_bf16"],
         "serving_launches": serve["g_bf16"]["crf_mean_field_bf16"],
         "parity_launches": {label: parity[label]["crf_mean_field_bf16"]
                             for label in "adef"},
         **bf16["crf_mean_field"]},
        {"name": "seg_decode_tail (bf16)", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/crf_mean_field_bf16.cu",
         "replaces": "simseg_tpu/ops/crf_fused.py:425",
         "launches": bf16_lanes["fused_tail"]["seg_decode_tail_bf16"],
         "cli_launches": entry["fused_tail bf16"]["seg_decode_tail_bf16"],
         **bf16["seg_decode_tail"]},
        {"name": "flash_attention (rowblock)", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/flash_attention.cu",
         "replaces": "simseg_tpu/ops/flash_attention.py:789",
         "launches": long_counts["lane_rowblock"],
         "dist_launches": [0] * DIST_WORLD,
         "train_launches": row_train_counts["lane_rowblock"],
         "bwd_launches": row_train_counts["flash_attention_bwd"],
         "shape": [BATCH, ROWBLOCK_T, HEADS, HEAD_DIM],
         **long_fwd["rowblock"], **long_bwd["rowblock"]},
        {"name": "flash_attention (stream)", "route": "cuda",
         "source": "simseg_tpu_torch/csrc/flash_attention.cu",
         "replaces": "simseg_tpu/ops/flash_attention.py:536",
         "launches": long_counts["lane_stream"],
         "dist_launches": [0] * DIST_WORLD,
         "shape": [BATCH, STREAM_T, HEADS, HEAD_DIM],
         **long_fwd["stream"], **long_bwd["stream"]},
    ]}))
    print(f"native decode library built: {native_built}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
