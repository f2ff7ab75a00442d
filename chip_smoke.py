"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — tiny-yolo-voc-416 detection at batch 1,
batch-128 serving in bf16 and int8, bf16 training at batch 128 with
the fused pair, the two-pair chain and the fused stem, yolov2-608
serving (route, reorg), yolov2-608 training at batch 128,
yolo9000-416 serving (the WordTree head, the aligned and pre-split
heads), yolo9000-416 training from disk (the WordTree loss, device
augmentation, the packed loader), `detector valid` with exact NMS, the
robot frame loop and the streaming demo, darknet19-224 classification
(the classifier family's layer kinds, the int8 float tail, the
classifier apps), darknet19-224 training (the cost head, every
classifier kind's training forward, `classifier train`, `cifar`), the
recurrent kinds and char_rnn-1024 (`rnn train/generate/valid/vec`),
YOLOv1 at 448 (`yolo train/test/valid/recall`, `coco`, `swag`),
`nightmare` and `super`, the go-19 policy net (`go train/valid/engine/
self`), the small apps (`captcha`, `tag`, `writing`, `compare`, `dice`,
`super train`, `voxel`, `vid`, `art`, `3d`, `imtest`) and `gemm` —
through the entry points a user calls, builds
the hand-written CUDA kernels from ``sr_object_detection_tpu_torch/csrc``
and holds each against its plain PyTorch version. Phases, in order; any failure ends the run with a
non-zero status and no result line:

  0. device: a CUDA device, its name and power limit, the kernel build;
  1. the NMS kernel (32-rank chunks) against its plain version (C=20,
     k=128 and k=845, random boxes plus ties): torch.equal; its device
     time from a CUDA graph beside the launch floor, an empty kernel with
     its grid, block and shared memory from a graph;
  2. the batch-1 stem kernel (the tensor-core conv tile's stem mode of
     csrc/phase_train.cu, its taps fold at pair 1; by b1_stem.paths, no
     pair on stem_pair_kernel) against its plain version at the four
     tiny-yolo-416 pair shapes with random biases, then link by link
     along the chained stem: every element within one bf16 ulp (see
     bf16_err);
  3. the batch-1 slice at full width: Detector.detect on CUDA (random
     weights with randomized BN and biases, written as a .weights file)
     against the same Detector on the CPU, det for det; the C-oracle
     golden detect_tiny_yolo.npz on CUDA; LatencyEngine(fused_stem=True)
     on u8 frames against fused_stem=False. Kernel launch counts are
     reset just before this phase and read just after it;
  4. the pipe server (infer/serve.py) on CUDA answers 3 requests, equal
     to the in-process Detector;
  5. times from CUDA events: each batch-1 kernel beside its plain
     version and LatencyEngine per frame fused beside plain, each pair
     timed in turns (plain, kernel, kernel, plain), NMS on a frame's
     candidates, the stem chain and each of its pairs also replayed from
     a CUDA graph (device time without the host's launch cost) — NMS
     beside its launch floor; Detector.predict_batch and detect;
  6. the int8 stem kernel (csrc/phase_stem.cu, phase_pair_tc_kernel on
     the int8 tensor cores) against its plain version at the four
     tiny-yolo-416 pair shapes at batch 128 with random int8 data (pair 1
     also from u8 and float32 frames), each launch counted under its K
     fold (taps, tap pairs, chunks, chunks), then link by link along the
     engine's own chain from u8 frames, the whole chain, and two launches
     on one input: every one torch.equal (the chain is exact);
  7. the batch-128 slice at full width: ThroughputEngine (bf16) with and
     without its phase stem (kernel 4's mode fwd, one launch a pair on
     the conv tile: pairs 2-4 on the tile, pair 1 on its taps fold, none
     on the FP32-core path, no fwdstats, colsum or apply, counted; each
     link torch.equal to fwdstats + apply with identity BN, within one
     bf16 ulp of the plain engine's layers and of fwd_pair_plain, the
     bias add's and the leaky's roundings allowed for) and
     QuantizedThroughputEngine (int8,
     u8 frames)
     with and without the phase stem (its four pairs counted under their
     K folds); the two int8 engines' int8 trunks
     equal and their
     outputs equal (or within one bf16 step of the head's logits, should
     cuDNN pick another algorithm). Launch counts are reset just before
     this phase and read just after it;
  8. the int8 Detector on CUDA against the same Detector on the CPU, det
     for det within a prob band (the two calibrations differ in the last
     bits); the int8 LatencyEngine's candidates are finite;
  9. the pipe server with --int8 answers 3 requests, equal to the
     in-process int8 Detector calibrated on the same first frame;
 10. times from CUDA events, in turns: the int8 stem chain against its
     plain chain, and each pair on the chain's inputs beside its bound;
     the same for the bf16 serving stem (kernel 4's mode fwd), each pair
     and the chain also from a CUDA graph;
     images/s of ThroughputEngine bf16 without and with its
     phase stem and of the int8 engine on u8 frames without and with the
     phase stem (host clock
     around queued batches, one sync); the int8 LatencyEngine per frame
     and best_latency_engine's selection;
 11. torch.profiler over each engine: wall and device busy time per
     frame or batch, the device's idle share, the top kernels; the bf16
     phase stem's batch ran fwd_tc_kernel 3 times, fwd_fold_kernel once
     and no fwdstats, colsum or apply kernel, the int8 phase
     stem's batch
     phase_pair_tc_kernel and no dp4a phase_pair_kernel;
 12. the three training kernels (csrc/phase_train.cu) against their
     plain versions at the training pair's shape (416, B=128, 3 -> 16):
     fwdstats (on the tensor-core tile's taps fold, fwdstats_fold_kernel,
     by conv_kernels) Z within one bf16 ulp, its argmax equal wherever the
     two extreme taps differ by more than an ulp, its sums at 1e-4, two
     launches bit-equal, its time in turns with fwdstats_plain beside its
     bound and cuDNN's bf16 F.conv2d alone (the conv without the pool,
     argmax and sums: context, not the same function); apply
     bit-equal; every bwdg reduction at 1e-3 of its largest magnitude
     (bwdg on the tensor cores, bwdg_tc_kernel), two bwdg launches
     bit-equal; then phase_train_block's gradient (on a case with no
     zero-variance channel, the cotangent zeroed where the two tie rules
     route apart)
     at 1e-3 of a float64 evaluation of the unfused chain's formulas,
     and its scale and bias gradients at 1e-3 of the chain's (the bf16
     chain's own weight gradient is several per cent off that
     evaluation at this size: printed, not gated);
 13. the training slice at full width: Trainer on tiny-yolo-voc 416,
     batch 128, bf16 with phase_train, three steps on one batch (losses
     finite, the third below the first, each training kernel launched 3
     times, fwdstats (3 -> 16) on the taps fold, counts reset just before
     and read just after), the first
     loss within 0.03*|loss| + 0.05 of a trainer without the pair; the
     float32 Trainer on CUDA reproduces the four train_region_* goldens;
 14. `cli detector train -bf16` on 256 synthetic PPM images: two
     iterations, a _final.weights that loads and moved;
 15. times, in turns: apply and bwdg beside their plain versions and
     bounds; Trainer.step images/s, TFLOP/s and MFU (3 x analytic_flops
     per image against the bf16 dense peak) for bf16 + phase_train,
     bf16 and float32;
 16. torch.profiler over one bf16 step with the pair and one without;
     the step with the pair ran bwdg_tc_kernel, not bwdg_kernel; over
     three steps of the pair path in one profiler window, fwdstats'
     launches by the counter and by CUDA events around each launch equal
     three (the profiler's count of fwdstats_fold_kernel under three
     settings is printed and held between 1 and 3), and the same steps
     through fwdstats_plain
     from the same state give the same losses and layer 0's BN
     statistics (settle_fwdstats_count);
 17. the opt-in training paths' kernels against their plain versions at
     the main path's shapes: kernel 4's modes red and dy (+ its weight
     gradient) and the dgrad kernel (an implicit GEMM on the bf16 tensor
     cores, mma.sync) at the chain's second pair (208x208,
     16 -> 32, B=128; inputs on a coarse grid where the conv's sums are
     exact, so both recompute the same conv): red's sums at 1e-4, dy
     bit-equal, dw at 1e-3, dgrad within one bf16 ulp; fwdstats there
     at phase 12's tolerances; red, dy and fwdstats on the tensor-core
     conv tile; on general inputs at that shape, fwdstats' Z and argmax
     equal to the pooled extreme of dy's recomputed y (dy with unit
     constants) and its first tap, bit for bit; F2, B1 and B2
     (csrc/fused_stem.cu) at the five fusable pairs' conv outputs
     (416x16 ... 26x256, B=128, channels-last): F2 and B2 bit-equal, B1's
     sums at 1e-4 and bit-equal across two launches, F2, B1 and B2 on the
     row kernels (f2_row_kernel, b1_row_kernel, b2_row_kernel) by
     fused_stem.paths;
 18. the chain's second pair's gradient (dw, dscales, dbiases, dx) at
     416 B=128 against a float64 evaluation of the unfused chain's
     formulas (dy rounded to bf16 where the pair rounds it): 3e-3 (the
     two round dy from float32 and float64, an ulp apart at a boundary),
     dx at 1e-2; the fused stem op against the unfused chain on the same conv
     output at pair 2's shape: forward and statistics equal, scale and
     bias gradients at 1e-3, dy within one bf16 ulp;
 19. Trainer bf16 at 416 B=128 with phase_train="chain", with
     phase_train=True + fused_stem=True and with fused_stem=True, three
     steps each, counts reset just before and read just after each: per
     step fwdstats 2 (pair 1's on the tensor-core tile, pair 0's on its
     taps fold), apply 2, red 1,
     dy 1 (both on the tile), dgrad 1, bwdg 1 / the pair's
     three + F2, B1, B2 4 each / F2, B1, B2 5 each, F2, B1 and B2 on the
     row kernels; losses finite and falling, the first within
     0.03*|loss| + 0.05 of the step without kernels;
 20. times, in turns: red, dy, dgrad, F2, B1 and B2 (F2 in turns at
     pair 2; the three at the five fusable pairs replayed from a CUDA
     graph, B1 and B2 also in turns) beside their plain
     versions and bounds, F.conv_transpose2d (dgrad's function in one
     library call, cuDNN, timed in the same run), fwdstats on the
     tensor-core tile at 16->32 @208, 32->64 @104 and 64->128 @52 beside
     its bounds (cuDNN's bf16 F.conv2d at those shapes for reference: the
     conv alone);
     Trainer.step images/s of the three paths against bf16 + phase_train;
 21. torch.profiler over one step of each of the three paths; the two
     with the pair ran bwdg_tc_kernel, not bwdg_kernel; the two with the
     fused stem ran f2_row_kernel, b1_row_kernel and b2_row_kernel, not
     f2_kernel, b1_kernel or b2_kernel; the chain's step
     ran fwdstats_tc_kernel, red_tc_kernel and dy_tc_kernel once each,
     fwdstats_fold_kernel once (pair 0), no fwdstats_kernel and no
     chain_bwd_kernel; the pair + fused stem step fwdstats_fold_kernel;
 22. yolov2-608 (cfg/yolo.cfg, 80 classes; random weights from seed 0
     with randomized BN and biases, written as a .weights file): its four
     serving kernels at its shapes against their plain versions — kernel
     4's mode fwd at B=128 (3 -> 32 @608 on fwd_fold_kernel, 32 -> 64
     @304 on fwd_tc_kernel, by conv_kernels; each torch.equal to fwdstats
     + apply with identity BN, within assert_fwd_close of fwd_pair_plain),
     the int8 stem from u8 frames (taps and chunks folds; torch.equal),
     the batch-1 stem on the conv tile (within one bf16 ulp) and NMS at
     C=80, k=128 (a frame's candidates, all and gated, and random ones
     with every rank live; bit-equal);
 23. the yolov2-608 main path, counted (every count reset just before and
     read just after): Detector.detect float32 and int8, the three
     LatencyEngines on u8 frames and the four batch-128 engines; the
     float32 Detector det for det against the CPU, the int8 Detector
     within the prob band that the two calibrations leave, the C-oracle
     golden yolo_coco_416.npz on CUDA (2e-4), the pipe server on the
     yolov2 cfg (3 requests equal to the in-process Detector);
 24. yolov2-608 at B=128: the bf16 phase stem link by link within
     assert_stem_link_close of the plain engine's layers, the int8 trunks
     with and without the phase stem equal; at batch 1 the fused stem's
     candidates against the plain engine's within the band their probs
     leave, the int8 engine's finite;
 25. yolov2-608 times: each of the four kernels and its chain from a CUDA
     graph in turns with its plain version, beside its bound (NMS beside
     its launch floor); images/s of the four batch-128 engines in turns;
     the three LatencyEngines' device time a frame; torch.profiler over a
     bf16 and an int8 phase-stem batch (fwd_fold_kernel and fwd_tc_kernel
     once each, no colsum or apply kernel; phase_pair_tc_kernel, no
     phase_pair_kernel);
 26. yolov2-608 training's kernels at its shapes, B=128, against their
     plain versions (the plain versions 16 or 32 images at a time, every
     image compared): the pair 3 -> 32 at 608 and at 152 (W2 = 76,
     partial 8x8 pooled tiles) at phase 12's tolerances, fwdstats on the
     taps fold and bwdg on the tensor cores, two launches of each
     bit-equal, the pair's gradient against the float64 evaluation
     (check_pair_gradient; at 608 on 16 images); F2, B1 and B2 at the
     four fused-stem pairs (layers 0, 2, 6, 10: 608x32 ... 76x256) on the
     row kernels, layer 0's y 3.03 GB, its images past 2^31 bytes
     included, with the batch's own statistics; each kernel's time from
     a CUDA graph in turns with its plain version on the whole batch,
     beside its bound (fwdstats beside cuDNN's F.conv2d alone);
 27. Trainer on yolov2-608 (cfg/yolo.cfg, 80 classes, full depth, random
     weights from seed 0) at B=128, bf16, 3 steps a path, counts reset
     just before and read just after each: (d) no kernels with
     remat="selective:2" (the JAX package's bench configuration), (a)
     phase_train + "selective:2", (b) phase_train + fused_stem, (c)
     fused_stem; launches a step (a) the pair once, (b) the pair and F2,
     B1, B2 three times, (c) F2, B1, B2 four times (layer 16 is live), on
     the row kernels; each first loss within 0.03*|loss| + 0.05 of (d)'s;
     each path's peak device memory, images/s and a torch.profiler step;
     (a) at 416 through Trainer._step_for; (a) and (d) with remat
     against without: the first loss (equal for (a)) and the parameters
     after one step within the spread of two runs without remat, and
     the peak memory without remat; phase_train="chain" runs the pair
     alone (no red, dy or dgrad: layer 2's Cin is 32);
 28. `cli detector train -bf16` on yolo.cfg at 608 with its published
     batch=64, subdivisions=8 on 128 synthetic PPMs: two iterations
     (random=1 resizes at the first), a _final.weights that loads, seen
     128, layer 0's rolling statistics moved;
 29. yolo9000-416 (cfg/yolo9000.cfg from models/zoo.py, 28,269-channel
     head; the real 9k.tree and coco9k.map are not in the repository, so
     a tree of 9,418 nodes in 2,429 sibling groups and an 80-entry map are
     written from a seed; random weights from seed 0 with randomized BN
     and biases): its four serving kernels at its shapes against their
     plain versions, as in phase 22 (check_serving_kernels), and NMS at
     C=9,418 (the hierarchy walk's candidates, and random ones with every
     class and rank live) and at C=80 (the map's), k=128, torch.equal,
     empty classes exact zeros;
 30. the yolo9000-416 main path, counted: Detector.detect without the
     map (the walk, gated on objectness), with the map, with presplit and
     as the int8 full stack (int8 trunk and head, bf16 region decode,
     with the map), the two LatencyEngines on u8 frames and the four
     batch-128 engines with the flat pre-split head; the float32
     Detectors det for det against the CPU, the int8 one against a CPU
     Detector calibrated to its amax within the band its bf16 decode
     leaves; the pipe server on the tree cfg (3 requests, 9,418 classes);
 31. yolo9000-416 at B=128 with the flat pre-split head against
     presplit=False: the int8 trunks equal with and without the stem and
     the head, the int8 fields equal, the bf16 fields within 2^-7 (of
     their value, or absolute), the
     class lanes within 2^-4 and, on two images, the bf16 fields and
     class lanes within a bf16 ulp of the CPU's region layer on the
     card's own head logits; the four
     kernels' times (as phase 25; NMS at its three cases beside the
     launch floor); images/s of the bf16 and int8 engines in turns;
     torch.profiler over a batch of each, with the grouped softmax's
     device time;
 32. yolo9000-416's WordTree region loss (region_delta with the seeded
     tree and map) on the card against the same loss on the CPU at full
     width, B=8, on a seeded head output, classfix 0 and 2: truths with
     padding, two on one cell, mapped ids and classification-only items
     (whose cell, a first maximum of objectness x path prob, is checked
     to be no near tie on the CPU); delta within 1e-5 of its largest
     magnitude, the stats within 1e-5, each classification-only item's
     deltas its class delta at one cell; the float32 Trainer on CUDA
     reproduces the train_tree_region and train_tree_region_classfix2
     goldens (weights 2e-4, costs 1e-3);
 33. Trainer on yolo9000-416 (the tree loss and the map) at B=128 as one
     micro-batch, bf16, 3 steps a path, counts reset just before and read
     just after each: (d) no kernels (the yardstick), (a) phase_train
     (the CLI's -bf16), (b) phase_train + fused_stem; launches a step
     (a) the pair once, (b) the pair and F2, B1, B2 four times (layers 2,
     6, 10, 16) on the row kernels; each first loss within 0.03*|loss| +
     0.05 of (d)'s; each path's peak device memory, images/s and a
     torch.profiler step with the region_loss and grouped_softmax
     ranges;
 34. the pair's kernels at 3 -> 32 @416, B=128, and F2, B1, B2 at the
     layers Network.fusable picks (0, 2, 6, 10, 16: 416x32 ... 26x512)
     against their plain versions (train_kernels_at, as phase 26), each
     time from a CUDA graph in turns with its plain version beside its
     bound;
 35. the data path: DeviceAugmenter on the card against the host
     pipeline (data/augment.py, ops/image.py) with the same parameters at
     2e-6; its images/s at B=128 @416 from 500x375 u8 frames written from
     a seed, on the device and with the canvas's upload; a packed set of
     256 seeded PPMs at 448, PackedDetectionLoader's batches/s host side
     alone (_host_batch_cpu) and to the card (bf16); the thread and the
     process decoders' batches equal; `cli detector train -packed
     -device-aug -bf16` on the yolo9000 cfg at batch=64, subdivisions=8:
     two iterations, a _final.weights that loads, seen 128;
 36. the NMS kernel at exact NMS's widths (k = N, detector valid):
     (C, k) = (20, 845), (80, 1805) and (9418, 507) on the candidates of
     a valid frame at thresh .005 from tiny-yolo-voc-416's, yolov2-608's
     and yolo9000-416's seeded weights, and with every rank live:
     torch.equal to the plain version (live classes in chunks), two launches
     bit-equal; each frame case's time from a CUDA graph in turns with
     the plain version, beside its bound and the launch floor;
 37. `detector valid` through cli.main: the map_ab model over its seeded
     PPMs on the card and with -cpu, the comp4 lines matched det for det
     (match_dets' margins), the port's reval_voc mAP from the card's
     files within 1e-3 of that from the -cpu run's files (two device
     paths) and of voc_map in the same run (reval_voc reads its files
     back; both run the same mean_ap); the three nets over
     8, 2 and 2 seeded PPMs, counted: one NMS launch an image;
 38. the robot loop: `cli robot run` at tiny-yolo-voc-416 (seeded
     weights) on 30 synthetic 512x424 RGB-D frames, -detect-every 2,
     -ipc, -faces, with the native library built (its build time):
     15 NMS launches, every frame's sentence, faces and class ids equal
     to the -cpu run's, detections matched; the loop's per-frame wall
     time (median, p99) and one torch.profiler window (idle share);
 39. `detector demo -frames` over 10 seeded 640x480 PPMs with -outdir on
     the card and with -cpu: detections matched, 10 NMS launches, the
     CLI's FPS lines;
 40. the remaining layer kinds on the card, TF32 off: the seven C-oracle
     goldens mini_{connected,lrn,crop,local,deconv,xnor,tree_cls}.npz
     (connected with dropout and softmax, lrn, crop, local, deconv, an
     XNOR conv, avgpool, the tree softmax), output and dumped layers at
     2e-5; darknet19-224 (cfg/darknet19.cfg from models/zoo.py, 1000
     classes; random weights from seed 0 with randomized BN and biases,
     the head scaled by 32, written as a .weights file): the float32
     Classifier on CUDA against the same on the CPU over three frames,
     probs within rtol 1e-4 (D19_RTOL), the top-5 ranks equal wherever a
     prob's neighbours lie more than twice that apart;
 41. darknet19-224's three stems against their plain versions along the
     engines' chains (check_serving_kernels: kernel 4's fwd at B=128 on
     the fold and the tile, torch.equal to fwdstats + apply; the int8
     stem from u8 frames, taps and chunks folds, torch.equal; the batch-1
     stem on the conv tile within a bf16 ulp); the main path, counted
     (every count reset just before and read just after): the float32
     Classifier, the two LatencyEngines on u8 frames (a region-free net
     returns its output) and the four batch-128 engines, launches
     stem_pair 6, phase_stem_pair 2, phase_train_fwd 2; the bf16 phase
     stem link by link within assert_stem_link_close of the plain
     engine's layers, the int8 trunks with and without the stem
     torch.equal and the float tail's outputs equal; batch 1 fused
     against plain within 2^-5;
 42. darknet19-224 times: the three kernels and their chains from a CUDA
     graph in turns with their plain versions beside their bounds;
     images/s of the four batch-128 engines in turns; torch.profiler over
     a batch of each (the bf16 stem on fwd_fold_kernel and fwd_tc_kernel,
     the int8 stem on phase_pair_tc_kernel); the two LatencyEngines' frames
     in turns on the host clock (median, p99), their device time and a
     profile each;
 43. the CLI on the card and with -cpu over 4 seeded PPMs named after
     the class `classifier predict -cpu` ranks first: `classifier
     predict` on each (top-5 matched within 2e-4), `classifier valid`
     (the CPU's line top1 1.0000, and the card's the same), `classify
     -int8` (matched within 2^-6 of the top prob, D19_INT8_RTOL: the two
     devices calibrate bits apart); `speed -batch 128 -int8 -phase-stem` on the card (its
     images/s; with -cpu at this size it would take minutes and prints
     only times);
 44. the classifier family's training on the card, TF32 off: the float32
     Trainer reproduces train_classifier.npz (torch_parity.
     check_train_golden, weights 1e-4, the cost doubled); a seeded net of
     every trainable classifier kind (conv + BN, XNOR conv, batchnorm,
     lrn, activation, crop 10x10 with flips, maxpool, local, deconv,
     avgpool, dropout .3, connected + BN, connected, flat route, softmax,
     cost) trains 3 steps at subdivisions 2 on the CPU and on CUDA, the
     card given the CPU run's dropout masks and crops: parameters within
     1e-4; one more card step draws its own masks on the card;
 45. Trainer on darknet19-224 (the cost head, 1000-class one-hot truths)
     at B=128 as one micro-batch, 3 steps a path, counts reset just
     before and read just after each: bf16 (d) no kernels, (a)
     phase_train, (b) phase_train + fused_stem, and float32 (what
     `classifier train` runs); launches a step (a) the pair once, (b) the
     pair and F2, B1, B2 four times (layers 2, 6, 10, 16) on the row
     kernels; each first loss within 0.03*|loss| + 0.05 of (d)'s; each
     path's peak device memory, images/s, MFU and a torch.profiler step;
 46. the pair's kernels at 3 -> 32 @224, B=128, and F2, B1, B2 at the
     layers Network.fusable picks (0, 2, 6, 10, 16: 224x32 ... 14x512)
     against their plain versions (train_kernels_at, as phase 34), each
     time from a CUDA graph in turns with its plain version beside its
     bound, fwdstats beside cuDNN's conv alone;
 47. the CLI on the card and with -cpu: `classifier train` over 16 seeded
     PPMs and `cifar train` over seeded CIFAR-format binaries, 3
     iterations each from one seeded .weights, the .weights within 1e-4
     of the -cpu run's; `cifar test` the same line on both;
 48. the recurrent kinds on the card, TF32 off: the C-oracle goldens
     mini_rnn, mini_gru (one step from zero state) and mini_crnn at 2e-5;
     char_rnn-1024 (models/zoo.py: vocab 256, three BN rnn layers of 1024,
     connected 256, softmax, sse cost; seeded weights, BN statistics and
     biases randomized) forward over 32 steps of 32 streams, and a 2-crnn
     net (8 steps x 4 streams, 32x32, 16 filters), card against CPU
     within 1e-4 of the largest |value|;
 49. `rnn train` through the CLI, 3 iterations of 32 x 32 characters of
     a seeded text at learning rate 1e-4 (RNN_LR), on the card and with
     -cpu from one .weights: parameters within 1e-4 of each tensor's
     largest value; Trainer.step's characters/s on the card; the CPU
     sampler generates 200 characters, `rnn generate` through the CLI on
     the card, the card sampler fed the CPU's characters within 1e-4 of
     the CPU's probs at every step, its time a character and a
     torch.profiler window (idle share); `rnn valid` and `rnn vec` (lines
     on standard input) card against -cpu;
 50. YOLOv1: train_yolov1.npz on CUDA (weights 1e-4, costs 1e-3);
     tinyyolo-v1-448 (v1_cfg_text: six conv + BN + leaky / maxpool pairs
     16 ... 512, conv 1024, conv 256, connected 1,470, [detection] side 7,
     num 2, sqrt, rescore, softmax 0) `yolo train` through the CLI, 2
     iterations of B=2 on 4 seeded PPMs at learning rate 1e-5 (V1_LR),
     card against -cpu: parameters within 1e-4 of each tensor's largest
     value, each tensor's update (after - before) within 1e-2 of its
     norm in norm (V1_UPDATE_TOL; a second -cpu run on 1 thread must
     itself stay under it), every tensor moved, the first loss 1e-5
     relative;
     Trainer.step float32 at B=64 (images/s, peak memory, a profile);
     `yolo valid` (comp4 lines matched, 8 NMS launches counted), `yolo
     recall` (counts equal), `yolo test` (detections matched) over 8
     seeded PPMs and `swag test` on the card and with -cpu; `coco valid` on
     an 80-class v1 net (2 images: records matched, 2 launches); the NMS
     kernel at the v1 head (k = N = 98) on a valid frame's candidates at
     C = 20 and 80: torch.equal to the plain version, two launches
     bit-equal, its time from a CUDA graph in turns with the plain
     version beside its bound and the launch floor;
 51. `nightmare` (1 octave, 2 iterations) and `super` on a seeded
     super-resolution net (conv, conv, deconv x2) at 320x240 through the
     CLI, card against -cpu within 1e-4; tinyyolo-v1-448's first dream
     step at layer 10 (six max-pools down), the input gradient card
     against CPU within 1e-2 of its norm in norm (V1_DREAM_TOL), and
     `nightmare` through those pools on the card;
 52. go-19 (tests/torch_parity.go19_cfg_text: 19x19x1, thirteen 3x3
     convs of 256 with BN and relu, a 1x1 conv to one plane, softmax,
     sse cost; seeded weights, BN statistics and biases randomized):
     the forward on 16 boards and the -multi ensemble (one batch of 8),
     card against CPU within 1e-4 of the largest |value| (GO_TOL);
     genmove's and the forward's latency at batch 1 and 8, median and
     p99 over 50 calls; `go train` through the CLI at B=128 (3
     iterations, no hand-written kernel launched, counted), then its
     Trainer.step's boards/s (host clock around 5 queued steps), peak
     device memory, MFU against 67 TFLOP/s (utils/profiler.mfu) and a
     profiled step (idle share); `go train` at B=16 and a constant rate,
     1 and 2 iterations on the card and with -cpu from one .weights:
     each tensor's update within 1e-2 of its norm in norm after 1 step
     (GO_UPDATE_TOL; a -cpu run on 1 thread must itself stay under it)
     and 0.16 after 2 (GO_UPDATE_TOL_2), and against the same steps in
     float64 on the CPU (torch_parity.train_float64) within twice the
     CPU's own float32 distance, the first loss 1e-5 relative; `go valid`
     accuracy equal; a scripted `go engine` GTP session (GO_GTP) single
     and -multi, the card's transcript equal to the CPU's; one `go self`
     game (Tromp-Taylor scoring) whose records decode;
 53. the small apps through their CLI commands on seeded toy nets and
     files (tests/torch_parity.APP_*): `captcha`, `tag`, `writing`,
     `compare`, `dice`, `super`, `voxel` and `vid` train, 3 iterations
     each on the card and with -cpu, losses within 1e-3 relative
     (APP_TOL); `compare battle` elos within 1e-6; `dice valid` equal;
     `vid generate` images within 1e-3; `art`, `3d`, `imtest` and `test`
     write their outputs;
 54. `gemm`: torch.matmul (cuBLAS) GFLOP/s at darknet's six GEMM shapes
     in bf16 and in float32 with TF32 off, each beside its share of 989 /
     67 TFLOP/s.

The last lines are one JSON object with the four kernels at yolov2-608's
shapes (the keys of the kernels line; their launches counted in phase
23), one with the four at yolo9000-416's (launches from phase 30), the
card (nvidia-smi), one JSON object describing the
14 kernels and, under names that end in "(yolov2-608 training: ...)",
the pair's and the fused stem's kernels at yolov2-608's training shapes
(phase 26's times; the fused stem's summed over its four pairs; their
launches counted in phase 27's paths (a) and (c)), and under names that
end in "(yolo9000-416 training: ...)" the same kernels at yolo9000-416's
training shapes (phase 34's times, the fused stem's summed over its five
pairs; launches from phase 33's paths (a) and (b)), under names that
begin "nms_per_class (detector valid, exact NMS: ...)" the NMS kernel at
the three exact widths (phase 36's times; launches from phase 37's
counted valid runs), and under names that end in "(darknet19-224
serving: ...)" the three stems at darknet19-224's shapes (phase 42's
times; launches from phase 41's counted main path), and under names
that end in "(darknet19-224 training: ...)" the pair's and the fused
stem's kernels at darknet19-224's training shapes (phase 46's times;
launches from phase 45's paths (a) and (b)), and under names that begin
"nms_per_class (YOLOv1 head, exact NMS: ...)" the NMS kernel at the v1
head (phase 50's times and counted launches) (time, plain time,
bound, launches and library call of each;
``stem_pair`` is the batch-1 stem on the tensor-core conv tile of
csrc/phase_train.cu (``stem_fold_kernel`` at pair 1, ``stem_tc_kernel``
at pairs 2-4; ``stem_pair_kernel`` in csrc/b1_stem.cu takes the other
shapes), its time the four-pair chain's from a CUDA graph replay,
``nms_per_class`` its time on a frame's candidates from a CUDA graph,
``phase_train_fwd`` kernel 4's mode fwd (``fwd_fold_kernel`` at pair 1,
``fwd_tc_kernel`` at pairs 2-4), its time the bf16 serving stem's
four-pair chain at B=128 in turns with the plain chain,
``fused_stem_f2`` the row kernel ``f2_row_kernel``,
``phase_train_dgrad`` is the tensor-core implicit GEMM in
csrc/phase_train.cu, ``phase_train_bwdg`` its tensor-core
``bwdg_tc_kernel``, ``phase_train_fwdstats`` the tensor-core tile's taps
fold (``fwdstats_fold_kernel``) at the leading pair and
``phase_train_fwdstats_tc`` the tensor-core conv tile at
the chain's pair 1, which ``phase_train_red`` and ``phase_train_dy`` run
too), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
import re
import shutil
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
WORK = ROOT / "build" / "chip_smoke"
sys.path.insert(0, str(ROOT / "tests"))
from torch_parity import (  # noqa: E402  (JAX-free helpers)
    CLASSIFIER_TRAIN_GOLDENS, RECURRENT_GOLDENS, TRAIN_GOLDENS,
    TREE_TRAIN_GOLDENS, check_detection_golden, check_recurrent_golden,
    random_bn_nested,
    all_kinds_text, assert_bf16_close, assert_fwd_close, classifier_params,
    one_hot_groups,
    assert_stem_link_close, chain_case,
    check_chain_kernels, check_fused_op, check_fused_stem_kernels,
    check_fwdstats, check_pair_gradient, check_train_golden,
    check_train_kernels, check_y_consistency, images_past_2g, pair_spec,
    random_bn, phase_pair_case, stem_case, train_case, train_cfg_text,
    write_ppm_dataset, zoo_cfg_text)

NET = 416          # tiny-yolo-voc's published width and height
BATCH = 128        # the batch serving engines' batch
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bounds below
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
IOU_FLOPS = 20     # float ops of one IoU test (nms.cu)


def bound(n_bytes, n_ops, kind):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_bound(top_boxes, top_p):
    """:func:`bound` of per-class NMS on these candidates: the probs read
    and the kept probs written once, but only the live candidates' boxes
    read (a rank past a class's last live prob needs no box), and one
    IoU test for each pair of a class's live candidates."""
    live = (top_p > 0).sum(dim=1).tolist()
    return bound(4 * 4 * sum(live) + 2 * top_p.numel() * 4,
                 IOU_FLOPS * sum(n * (n - 1) // 2 for n in live), "f32")


T0 = time.perf_counter()


def log(msg):
    """Print a line; a phase's line ends with the run's elapsed seconds."""
    if msg.startswith("phase "):
        msg += f" ({time.perf_counter() - T0:.1f} s)"
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
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


def graph_ms(fn, iters=20) -> float:
    """Device time of fn() a call: ``iters`` calls captured in one CUDA
    graph and replayed, so no host launch cost sits between them."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def step_rate(trainer, x, t, iters):
    """images/s of Trainer.step on (x, t): host clock around ``iters``
    queued steps and one .item() at the end, after one warm-up step."""
    float(trainer.step(x, t)["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        m = trainer.step(x, t)
    float(m["loss"])
    return iters * x.shape[0] / (time.perf_counter() - t0)


def profile(name, fn, iters, gpu, top=6, ranges=()):
    """torch.profiler over ``iters`` calls of fn after one warm-up: wall
    time per call (host clock, ending in a synchronize, profiler
    overhead included), device busy time per call (the CUDA kernels'
    self time; the port runs one stream, so kernels do not overlap),
    the idle share, the kernels that take the most device time, and the
    device span of each of the port's ``record_function`` ``ranges``.
    Returns {name: calls over the ``iters`` calls} of the CUDA kernels
    the profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    # a record_function range shows up as a CUDA event too (its span on
    # the device), so the busy time and the kernels leave ranges out
    span = {r: 0.0 for r in ranges}
    rows = []
    for e in prof.key_averages():
        if e.key in span:
            span[e.key] = e.self_device_time_total / iters / 1e3
        elif (e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0):
            rows.append((e.self_device_time_total / iters / 1e3, e.key,
                         e.count))
    busy = sum(t for t, _, _ in rows)
    if busy == 0:
        log(f"profile {name}: wall {wall} ms; device time not measured "
            f"(the profiler saw no kernel) [{gpu}]")
        return {}
    log(f"profile {name}: wall {wall} ms, device busy {busy} ms, idle "
        f"share {1 - busy / wall} [{gpu}]")
    # the top kernels, and every tensor-core kernel of the port below them
    ranked = sorted(rows, reverse=True)
    for i, (t, key, _) in enumerate(ranked):
        if i < top or "_tc_kernel" in key or "_fold_kernel" in key:
            log(f"  {t} ms ({t / busy:.1%}) {key[:90]}")
    for r, t in span.items():
        log(f"  range {r}: {t} ms of the device a call ({t / busy:.1%} of "
            f"busy)")
    return {key: calls for _, key, calls in rows}


def named(kernel, key) -> bool:
    """Whether a profiler key names ``kernel``: demangled ("...::kernel("
    or "kernel<") or mangled ("...13kernelE..." / "kernelI"), and not a
    longer name ending in it (bwdg_kernel is not bwdg_tc_kernel)."""
    return re.search(rf"(?<![A-Za-z_]){kernel}(?![a-z_])", key) is not None


def assert_bwdg_tensor_core(name, kernels):
    """A profiled step with the fused pair ran bwdg on the tensor cores:
    bwdg_tc_kernel among its kernels, the FP32-core bwdg_kernel not."""
    assert any("bwdg_tc_kernel" in k for k in kernels), (name, kernels)
    assert not any(named("bwdg_kernel", k) for k in kernels), (
        name, kernels)
    log(f"  {name}: bwdg ran as bwdg_tc_kernel (tensor cores)")


def assert_fused_stem_rows(name, kernels):
    """A profiled step with the fused stem ran it on the row kernels:
    f2_row_kernel, b1_row_kernel and b2_row_kernel among its kernels, the
    strided f2_kernel, b1_kernel and b2_kernel not."""
    for k in ("f2_row_kernel", "b1_row_kernel", "b2_row_kernel"):
        assert any(k in key for key in kernels), (name, k, kernels)
    assert not any(named(s, k) for s in ("f2_kernel", "b1_kernel",
                                         "b2_kernel") for k in kernels), (
        name, kernels)
    log(f"  {name}: F2, B1 and B2 ran as f2_row_kernel, b1_row_kernel and "
        f"b2_row_kernel")


def assert_conv_tensor_core(name, kernels, iters, per_call):
    """A profiled run (``iters`` calls) ran the conv of fwdstats, red and
    dy on the tensor cores: the tile for every Cin >= 16 instance, the
    tile's taps fold for the leading pair's 3 -> 16. ``per_call`` gives
    the calls a call makes of fwdstats_tc_kernel, red_tc_kernel,
    dy_tc_kernel, fwdstats_fold_kernel and the FP32-core fwdstats_kernel
    (0 on every path); chain_bwd_kernel (the FP32-core red/dy) never ran.
    A count is held between 1 and ``iters`` times its value (0 where it
    is 0): the profiler has been seen to miss one launch of a window
    (fwdstats_kernel's in PRs 9-11, and fwdstats_fold_kernel's in a
    two-step window of tools/fwdstats_fold_ab.py), and an instance on
    the FP32-core loop would add ``iters`` launches of fwdstats_kernel or
    chain_bwd_kernel."""
    got = {k: sum(c for key, c in kernels.items()
                  if named(k, key)) for k in per_call}
    assert all(got[k] == 0 if v == 0 else 1 <= got[k] <= iters * v
               for k, v in per_call.items()), (name, got, iters)
    assert not any("chain_bwd_kernel" in k for k in kernels), (name, kernels)
    log(f"  {name}: conv kernels over {iters} calls {got}, no "
        f"chain_bwd_kernel")


def settle_fwdstats_count(PT, make_trainer, x, t, steps, gpu):
    """The pair path's fwdstats launches over ``steps`` training steps
    from one state in one profiler window: the launch counter and a pair
    of CUDA events around each launch (each timing a positive span) equal
    ``steps``; the same steps with fwdstats' plain version from the same
    state give each step's loss within 1e-2 of its magnitude and layer
    0's rolling BN statistics (which the batch statistics from fwdstats
    move) within 1e-3 of their largest magnitude: a launch that did not
    run would leave Z and the statistics unwritten. The profiler's count
    of fwdstats_fold_kernel, under three settings (CPU and CUDA
    activities,
    CUDA only, and a schedule with one warm-up step before the ``steps``
    it records), is printed and held between 1 and ``steps``, as
    assert_conv_tensor_core holds it: in this script it has read one
    launch fewer than ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    kernel_fn, marks = PT.fwdstats, []
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def evented(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = kernel_fn(*args)
        end.record()
        marks.append((start, end))
        return out

    def run(fn, activities, warmup):
        """(losses, layer 0's rolling statistics, counter, profiler count)
        over ``steps`` recorded steps of a new trainer."""
        trainer = make_trainer()
        before = PT.launches["fwdstats"]
        losses, stats = [], []
        sched = (torch.profiler.schedule(wait=0, warmup=1, active=steps,
                                         repeat=1) if warmup else None)
        PT.fwdstats = fn
        try:
            with torch.profiler.profile(activities=activities,
                                        schedule=sched) as prof:
                for _ in range(steps + warmup):
                    losses.append(float(trainer.step(x, t)["loss"]))
                    p0 = trainer.state.params[0]
                    stats.append(torch.stack([p0["rolling_mean"],
                                              p0["rolling_variance"]]))
                    if warmup:
                        prof.step()
                torch.cuda.synchronize()
        finally:
            PT.fwdstats = kernel_fn
        seen = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and named("fwdstats_fold_kernel", e.key))
        return losses, stats, PT.launches["fwdstats"] - before - warmup, seen
    lk, sk, ck, pk = run(evented, both, 0)
    spans = [a.elapsed_time(b) for a, b in marks]
    lp, sp, cp, pp = run(PT.fwdstats_plain, both, 0)
    assert ck == len(spans) == steps and min(spans) > 0, (ck, spans)
    assert cp == pp == 0, (cp, pp)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    stat_rel = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(sk, sp))
    assert loss_rel <= 1e-2 and stat_rel <= 1e-3, (lk, lp, stat_rel)
    counts = {"CPU + CUDA": pk,
              "CUDA only": run(kernel_fn, [ProfilerActivity.CUDA], 0)[3],
              "a warm-up step": run(kernel_fn, both, 1)[3]}
    assert all(1 <= n <= steps for n in counts.values()), counts
    log(f"  fwdstats over {steps} steps of the pair path: counter {ck}, "
        f"CUDA-event spans {spans} ms; losses {lk} against "
        f"fwdstats_plain's {lp} (max rel {loss_rel}), layer 0 rolling BN "
        f"statistics max rel {stat_rel}; the profiler's "
        f"fwdstats_fold_kernel "
        f"count by setting {counts} [{gpu}]")


def bf16_err(got, ref) -> float:
    """Assert every element within one bf16 ulp (tests/torch_parity.py);
    return the max absolute difference."""
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    assert_bf16_close(got, ref)
    return float(np.abs(got - ref).max())


def match_dets(a, b, thr, margin, require=True):
    """Det for det within a prob band: every detection (class, prob, box)
    of either list with prob > thr + margin has one in the other list of
    the same class, a prob within margin and the same box (within bf16
    resolution). Returns how many were matched (with ``require``, at
    least one)."""
    n = 0
    for x, y in ((a, b), (b, a)):
        for c, p, box in x:
            if p <= thr + margin:
                continue
            n += 1
            assert any(c2 == c and abs(p2 - p) <= margin
                       and np.allclose(b2, box, rtol=2 ** -6, atol=1e-3)
                       for c2, p2, b2 in y), (c, p, box)
    assert n > 0 or not require
    return n


def voc_map(det, paths, gt, thresh, nms):
    """VOC mAP of a Detector on the synthetic A/B set (the port's
    tests/test_torch_int8.py::test_int8_map_delta protocol)."""
    from sr_object_detection_tpu_torch.eval.voc import mean_ap, voc_det_lines
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    from tools.synth_dataset import N_CLASSES, gt_corner_boxes
    names = [str(c) for c in range(N_CLASSES)]
    per_class = {c: [] for c in range(N_CLASSES)}
    for path in paths:
        img = load_image_rgb(path)
        boxes, probs = det.predict_batch(det.preprocess(img)[None],
                                         thresh=thresh)
        probs = NMS.nms_sort_topk(boxes[0], probs[0], nms, k=boxes.shape[1])
        lines = voc_det_lines(pathlib.Path(path).stem, boxes[0].cpu().numpy(),
                              probs.cpu().numpy(), names, img.shape[1],
                              img.shape[0])
        for c in range(N_CLASSES):
            for line in lines[names[c]]:
                f = line.split()
                per_class[c].append((f[0], *map(float, f[1:6])))
    return mean_ap(per_class, gt_corner_boxes(gt))[0]


def candidates(boxes, probs):
    """LatencyEngine output -> [(class, prob, box)]."""
    boxes, probs = boxes.cpu().numpy(), probs.cpu().numpy()
    return [(int(p.argmax()), float(p.max()), bx)
            for bx, p in zip(boxes, probs)]


Y_NET = 608        # yolov2's published width and height (cfg/yolo.cfg)
Y_PAIRS = [(0, 1), (2, 3)]    # its stem pairs: 3 -> 32 @608, 32 -> 64 @304


def abba_graph(name, kernel_fn, plain_fn, gpu, iters=10, plain_iters=3):
    """A kernel from a CUDA graph (graph_ms) in turns with its plain
    version from CUDA events (cuda_ms): plain, kernel, kernel, plain.
    Returns (kernel ms, plain ms), each the mean of its two readings."""
    p1 = cuda_ms(plain_fn, plain_iters, 1)
    k1, k2 = graph_ms(kernel_fn, iters), graph_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, plain_iters, 1)
    log(f"time {name}: kernel from a CUDA graph {(k1 + k2) / 2} ms ({k1}, "
        f"{k2}), plain {(p1 + p2) / 2} ms ({p1}, {p2}) [{gpu}]")
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_serving_kernels(spec, pairs, bf_stem, q_stem, lat_f, frames_u8,
                          x1, int8_folds):
    """Kernels 4 (mode fwd), 3 and 2 along the engines' own stems, link by
    link, against their plain versions on the same inputs: ``pairs`` the
    stem's (conv, pool) layers, a fold at pair 1 and the tile after it,
    nothing on the FP32-core paths, the int8 launches under
    ``int8_folds``. ``frames_u8`` the batch's u8 frames,
    ``x1`` a batch-1 bf16 input. Returns the links (inputs of each pair)
    and the errors, for the timings of :func:`time_serving_kernels`."""
    from sr_object_detection_tpu_torch.kernels import b1_stem as BS
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    bf16, dev = torch.bfloat16, frames_u8.device
    batch = frames_u8.shape[0]
    x_b = frames_u8.float() / 255.0
    tiles = {"tensor_core": len(pairs) - 1, "tensor_core_fold": 1,
             "fp32_core": 0}
    # kernel 4's mode fwd along the bf16 engine's chain: each pair
    # torch.equal to fwdstats + apply with identity BN, within
    # assert_fwd_close of fwd_pair_plain
    fwd_err, fwd_links = 0.0, []
    before = dict(PT.conv_kernels["fwd"])
    v = x_b.to(bf16)
    for ci, _ in pairs:
        p = bf_stem.params[ci]
        l = spec.layers[ci]
        cout = p["weights"].shape[0]
        zero = torch.zeros(cout, device=dev)
        one = torch.ones(cout, device=dev)
        w_hwio = p["weights"].permute(2, 3, 1, 0).contiguous()
        bias = p["biases"].float()
        got = PT.fwd_pair(v, w_hwio, bias)
        z, _, _ = PT.fwdstats(v, w_hwio, zero, one)
        comp = PT.apply(z, zero, one, one, bias)
        assert torch.equal(got, comp), (ci, (got != comp).sum().item())
        del comp
        z_np = z.float().cpu().numpy()
        del z
        ref = PT.fwd_pair_plain(v, w_hwio, bias).float().cpu().numpy()
        fwd_err = max(fwd_err, assert_fwd_close(got.float().cpu().numpy(),
                                                ref, z_np))
        del ref, z_np
        torch.cuda.empty_cache()
        fwd_links.append((l, v, w_hwio, bias))
        log(f"  bf16 serving stem pair {l.c}->{l.filters} @{l.h} "
            f"B={batch}: fwd == fwdstats + apply "
            f"({PT.conv_path('fwd', l.c, l.filters)}) "
            f"({time.perf_counter() - T0:.1f} s)")
        v = got
    assert {k: PT.conv_kernels["fwd"][k] - before[k]
            for k in before} == tiles, PT.conv_kernels
    assert torch.equal(bf_stem._stem(x_b), v)

    # kernel 3 from u8 frames along the int8 engine's chain: torch.equal
    # to the plain int8 chain, each launch under its K fold
    qn = q_stem.qnet
    links = [(qn.qparams[ci]["weights"], qn.qparams[ci]["dequant"],
              qn.qparams[ci]["biases"],
              float(np.float32(1.0 / qn.act_scales[ci])))
             for ci, _ in pairs]
    inv_u8 = float(np.float32(1.0 / (255.0 * qn.in_scale)))
    folds = dict(PS.folds)
    v, ps_inputs = frames_u8, []
    for (w, dq, b, inv_out), (ci, _) in zip(links, pairs):
        l = qn.spec.layers[ci]
        args = (v, w, dq, b, inv_out,
                inv_u8 if v.dtype == torch.uint8 else None)
        ps_inputs.append((l, args))
        out = PS.stem_pair_i8(*args)
        ref = PS.stem_pair_i8_plain(*args)
        assert torch.equal(out, ref), (ci, (out != ref).sum().item())
        del ref
        torch.cuda.empty_cache()
        log(f"  int8 stem pair {l.c}->{l.filters} @{l.h} B={batch}: kernel "
            f"== plain ({time.perf_counter() - T0:.1f} s)")
        v = out
    assert {k: PS.folds[k] - folds[k] for k in folds} == int8_folds, (
        PS.folds)
    assert torch.equal(qn.forward(frames_u8, stop=2 * len(pairs)), v)
    assert v.abs().max().item() > 60

    # kernel 2 (the batch-1 stem), link by link, within one bf16 ulp of
    # its plain version, on the conv tile
    paths = dict(BS.paths)
    b1_err, b1_links, v = 0.0, [], x1
    for ci, _ in pairs:
        p = lat_f.params[ci]
        w = p["weights"].permute(2, 3, 1, 0).to(bf16).contiguous()
        b = p["biases"].float()
        got = BS.stem_pair(v, w, b)
        b1_err = max(b1_err, bf16_err(got, BS.stem_pair_plain(v, w, b)))
        b1_links.append((spec.layers[ci], v, w, b))
        v = got
    assert {k: BS.paths[k] - paths[k] for k in paths} == tiles, BS.paths
    assert torch.equal(lat_f._stem(x1), v)
    return {"fwd_err": fwd_err, "fwd_links": fwd_links, "links": links,
            "inv_u8": inv_u8, "ps_inputs": ps_inputs, "b1_err": b1_err,
            "b1_links": b1_links}


def time_serving_kernels(tag, sk, bf_stem_fn, b1_stem_fn, frames_u8, x1,
                         nms_cases, nms_err, gpu):
    """Each of the four serving kernels and its chain from a CUDA graph in
    turns with its plain version, beside its bound (each input read once,
    each output written once; or the operations over their type's peak):
    ``sk`` :func:`check_serving_kernels`' links, ``bf_stem_fn`` /
    ``b1_stem_fn`` the engines' stems, ``nms_cases`` [(label, top boxes,
    top probs)] of NMS candidates, the first one the kernels line's, each
    beside its launch floor (none on a path without NMS: a classifier's).
    Returns (times, bounds, errs) under the kernels line's names."""
    from sr_object_detection_tpu_torch.kernels import b1_stem as BS
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    batch, n_pairs = frames_u8.shape[0], len(sk["fwd_links"])
    x_bf = (frames_u8.float() / 255.0).to(torch.bfloat16)
    times, bounds, errs = {}, {}, {}
    n_bytes = n_ops = 0
    for l, xi, w_hwio, bias in sk["fwd_links"]:
        name = f"{tag} bf16 serving stem pair (fwd) {l.c}->{l.filters} @{l.h}"
        k_ms, _ = abba_graph(name, lambda: PT.fwd_pair(xi, w_hwio, bias),
                             lambda: PT.fwd_pair_plain(xi, w_hwio, bias),
                             gpu, plain_iters=2)
        p_bytes = (2 * xi.numel() + 2 * w_hwio.numel() + 4 * bias.numel()
                   + 2 * batch * (l.h // 2) * (l.w // 2) * l.filters)
        p_ops = 2 * batch * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "bf16")
        log(f"bound {name}: {b_ms} ms by {b_by}; kernel {k_ms / b_ms:.2f}x "
            f"[{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops

    def plain_fwd_chain(v):
        for _, _, w_hwio, bias in sk["fwd_links"]:
            v = PT.fwd_pair_plain(v, w_hwio, bias)
        return v
    times["phase_train_fwd"] = abba_graph(
        f"{tag} bf16 serving stem, {n_pairs} chained pairs B={batch}",
        lambda: bf_stem_fn(x_bf), lambda: plain_fwd_chain(x_bf), gpu,
        plain_iters=2)
    bounds["phase_train_fwd"] = bound(n_bytes, n_ops, "bf16")
    errs["phase_train_fwd"] = sk["fwd_err"]
    n_bytes = n_ops = 0
    for l, args in sk["ps_inputs"]:
        name = f"{tag} int8 stem pair {l.c}->{l.filters} @{l.h}"
        k_ms, _ = abba_graph(name, lambda: PS.stem_pair_i8(*args),
                             lambda: PS.stem_pair_i8_plain(*args), gpu,
                             plain_iters=2)
        p_bytes = (args[0].numel() * args[0].element_size()
                   + 9 * l.c * l.filters + 8 * l.filters
                   + batch * (l.h // 2) * (l.w // 2) * l.filters)
        p_ops = 2 * batch * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "int8")
        log(f"bound {name}: {b_ms} ms by {b_by}; kernel {k_ms / b_ms:.2f}x "
            f"[{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops

    def int8_chain(v, pair_fn):
        for w, dq, b, inv_out in sk["links"]:
            v = pair_fn(v, w, dq, b, inv_out,
                        sk["inv_u8"] if v.dtype == torch.uint8 else None)
        return v
    times["phase_stem_pair"] = abba_graph(
        f"{tag} int8 stem, {n_pairs} chained pairs B={batch} from u8 frames",
        lambda: int8_chain(frames_u8, PS.stem_pair_i8),
        lambda: int8_chain(frames_u8, PS.stem_pair_i8_plain), gpu,
        plain_iters=2)
    bounds["phase_stem_pair"] = bound(n_bytes, n_ops, "int8")
    errs["phase_stem_pair"] = 0
    n_bytes = n_ops = 0
    for l, xi, w, b in sk["b1_links"]:
        name = f"{tag} batch-1 stem pair {l.c}->{l.filters} @{l.h}"
        k_ms, _ = abba_graph(name, lambda: BS.stem_pair(xi, w, b),
                             lambda: BS.stem_pair_plain(xi, w, b), gpu,
                             iters=50, plain_iters=20)
        p_bytes = (2 * (l.h * l.w * l.c + l.out_h // 2 * l.out_w // 2
                        * l.filters) + 2 * w.numel() + 4 * b.numel())
        p_ops = 2 * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "bf16")
        log(f"bound {name}: {b_ms} ms by {b_by}; kernel {k_ms / b_ms:.2f}x "
            f"[{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops

    def plain_b1_chain(v):
        for _, _, w, b in sk["b1_links"]:
            v = BS.stem_pair_plain(v, w, b)
        return v
    times["stem_pair"] = abba_graph(
        f"{tag} batch-1 stem, {n_pairs} chained pairs",
        lambda: b1_stem_fn(x1), lambda: plain_b1_chain(x1), gpu, iters=50,
        plain_iters=20)
    bounds["stem_pair"] = bound(n_bytes, n_ops, "bf16")
    errs["stem_pair"] = sk["b1_err"]
    for i, (label, tb, tp) in enumerate(nms_cases):
        c, k = tp.shape
        t = abba_graph(
            f"{tag} nms_per_class C={c} k={k} ({label})",
            lambda: NMS.nms_per_class(tb, tp, 0.4),
            lambda: NMS.nms_per_class_plain(tb, tp, 0.4), gpu, iters=50,
            plain_iters=5)
        floor = graph_ms(lambda: NMS.empty_launch(c, k, tp.device), 50)
        b = nms_bound(tb, tp)
        log(f"time {tag} NMS C={c} launch floor (an empty kernel, same "
            f"launch shape, graph): {floor} ms; kernel {t[0] / floor:.1f}x "
            f"the floor; bound {b[0]} ms by {b[1]} [{gpu}]")
        if i == 0:
            times["nms_per_class"], bounds["nms_per_class"] = t, b
            errs["nms_per_class"] = nms_err
    for name in times:
        log(f"bound {tag} {name}: {bounds[name][0]} ms by {bounds[name][1]};"
            f" kernel {times[name][0] / bounds[name][0]:.2f}x [{gpu}]")
    return times, bounds, errs


def serving_entries(times, bounds, errs, launches):
    """The kernels line's entries of the serving kernels on a model's
    serving path (the four, or the three stems where it has no NMS):
    times, bounds and errors from that path's run, ``launches`` its
    counted main path."""
    replaces = {
        "nms_per_class": "sr_object_detection_tpu/kernels/nms_pallas.py:29",
        "stem_pair": "sr_object_detection_tpu/kernels/b1_stem.py:82",
        "phase_stem_pair":
            "sr_object_detection_tpu/kernels/phase_stem.py:235",
        "phase_train_fwd":
            "sr_object_detection_tpu/kernels/phase_train.py:209"}
    sources = {"nms_per_class": "nms.cu", "stem_pair": "phase_train.cu",
               "phase_stem_pair": "phase_stem.cu",
               "phase_train_fwd": "phase_train.cu"}
    return [{"name": name, "route": "cuda",
             "source": f"sr_object_detection_tpu_torch/csrc/{sources[name]}",
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None}
            for name in replaces if name in times]


def yolov2_608(gpu, dev, reset_counts, counts):
    """Phases 22-25 (the module docstring): yolov2-608 serving. Returns
    the kernels line's entries for the four kernels on this path, at
    yolov2-608's shapes."""
    from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
    from sr_object_detection_tpu_torch.infer.detector import Detector
    from sr_object_detection_tpu_torch.infer.engine import (
        LatencyEngine, ThroughputEngine)
    from sr_object_detection_tpu_torch.infer.quant import (
        QuantizedThroughputEngine)
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, save_weights)
    from sr_object_detection_tpu_torch.kernels import b1_stem as BS
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.models.zoo import yolov2
    from sr_object_detection_tpu_torch.ops import boxes as B

    # ---------------------------------------------------------- phase 22
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(22)
    bf16 = torch.bfloat16
    spec = yolov2(width=Y_NET, height=Y_NET)
    # random weights from seed 0, BN statistics and biases randomized; the
    # head scaled so that the 80-class probs spread
    params_np = random_bn(init_params(spec, seed=0), 1, head_gain=16.0)
    g416 = np.load(GOLDEN / "yolo_coco_416.npz")
    cfg_text = bytes(g416["cfg"]).decode()       # cfg/yolo.cfg at 416
    WORK.mkdir(parents=True, exist_ok=True)
    cfg = WORK / "yolo-608.cfg"
    cfg.write_text(cfg_text.replace("width=416", f"width={Y_NET}")
                   .replace("height=416", f"height={Y_NET}"))
    assert parse_network_cfg(str(cfg)).layers == spec.layers
    weights = WORK / "yolo-608.weights"
    save_weights(spec, params_np, str(weights))
    tag = f"yolov2-{Y_NET}"
    y16 = Y_NET // 32        # the region grid: 19 at 608
    n_boxes = y16 * y16 * 5
    n_out = n_boxes * 85
    k_nms = min(128, n_boxes)                # the Detector's NMS top-k
    k_lat = min(LatencyEngine.TOPK, n_boxes)

    bf = ThroughputEngine(spec, params_np, batch=BATCH, device=dev)
    bf_stem = ThroughputEngine(spec, params_np, batch=BATCH, device=dev,
                               phase_stem=True)
    calib = rng.uniform(0, 1, (4, Y_NET, Y_NET, 3)).astype(np.float32)
    q_stem = QuantizedThroughputEngine(spec, params_np, batch=BATCH,
                                       device=dev, calib_x=calib,
                                       phase_stem=True)
    q_plain = QuantizedThroughputEngine(spec, params_np, batch=BATCH,
                                        device=dev, calib_x=calib)
    assert bf_stem.phase_stem
    assert PS.plan_pairs(q_stem.qnet.spec) == Y_PAIRS
    assert BS.plan_pairs(bf_stem.spec) == Y_PAIRS
    frames_u8 = torch.from_numpy(rng.integers(
        0, 256, (BATCH, Y_NET, Y_NET, 3), dtype=np.uint8)).to(dev)
    x_b = frames_u8.float() / 255.0
    x_bf = x_b.to(bf16)

    lat_f = LatencyEngine(spec, params_np, device=dev, fused_stem=True)
    lat_p = LatencyEngine(spec, params_np, device=dev)
    assert lat_f.fused_stem and not lat_p.fused_stem
    x1 = torch.from_numpy(rng.uniform(0, 1, (1, Y_NET, Y_NET, 3)).astype(
        np.float32)).to(dev, bf16)
    sk = check_serving_kernels(spec, Y_PAIRS, bf_stem, q_stem, lat_f,
                               frames_u8, x1, {"taps": 1, "tap_pairs": 0,
                                               "chunks": 1})
    fwd_err, b1_err = sk["fwd_err"], sk["b1_err"]
    fwd_links = sk["fwd_links"]

    # kernel 1 at C=80, k=128: a frame's candidates as the Detector makes
    # them (every prob kept, and gated at the detection threshold), and
    # random candidates with every rank live
    det = Detector(str(cfg), str(weights), device=dev)
    frames = [rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
              for _ in range(3)]
    fb, fp = det.predict_batch(det.preprocess(frames[0])[None])
    assert fp.shape == (1, n_boxes, 80)
    thresh = float(np.sort(fp[0].max(-1).values.cpu().numpy())[::-1][
        min(10, n_boxes - 1)])
    nms_cases = []
    for name, probs in (("every prob", fp[0]),
                        ("gated", torch.where(fp[0] > thresh, fp[0], 0.0))):
        nms_cases.append((name, *B.topk_candidates(fb[0], probs,
                                                   k_nms)[:2]))
    n = n_boxes
    rb = torch.from_numpy(np.stack(
        [rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(.02, .4, n),
         rng.uniform(.02, .4, n)], axis=1).astype(np.float32)).to(dev)
    rp = torch.from_numpy(rng.uniform(.05, 1, (n, 80)).astype(
        np.float32)).to(dev)
    nms_cases.append(("random, every rank live",
                      *B.topk_candidates(rb, rp, k_nms)[:2]))
    nms_err = 0.0
    for name, tb, tp in nms_cases:
        assert tp.shape == (80, k_nms)
        got = NMS.nms_per_class(tb, tp, 0.4)
        ref = NMS.nms_per_class_plain(tb, tp, 0.4)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), name
        nms_err = max(nms_err, (got - ref).abs().max().item())
    torch.cuda.synchronize()
    log(f"phase 22 ok: {tag}'s four serving kernels at its shapes == their "
        f"plain versions: kernel 4's fwd at B={BATCH} (3->32 @{Y_NET} on "
        f"the fold, 32->64 @{Y_NET // 2} on the tile; torch.equal to "
        f"fwdstats + apply, max |err| against fwd_pair_plain {fwd_err}), "
        f"kernel 3 from u8 frames (taps and chunks folds, torch.equal), "
        f"the batch-1 stem on the conv tile (max |err| {b1_err}), NMS at "
        f"C=80 k={k_nms} (torch.equal, {len(nms_cases)} cases) [{gpu}]")

    # ---------------------------------------------------------- phase 23
    # the main path, counted: detection, the batch-1 engines and the four
    # batch-128 engines through the entry points a user calls
    calib8 = det.preprocess(frames[0])[None]
    det8 = Detector(str(cfg), str(weights), device=dev, int8_calib=calib8)
    lat8 = LatencyEngine(spec, params_np, device=dev, int8_calib=calib8)
    u8 = [rng.integers(0, 256, (Y_NET, Y_NET, 3), dtype=np.uint8)
          for _ in range(3)]
    reset_counts()
    dets = [det.detect(f, thresh=thresh - 1e-4) for f in frames]
    dets8 = [det8.detect(frames[0], thresh=0.0)]
    lat_out = [(lat_f(f), lat_p(f), lat8(f)) for f in u8]
    out_bf = bf(x_b)
    out_bfs = bf_stem(x_b)
    out_s = q_stem(frames_u8)
    out_p = q_plain(frames_u8)
    torch.cuda.synchronize()
    launches_y, want = counts(nms_per_class=4, stem_pair=6,
                              phase_stem_pair=2, phase_train_fwd=2)
    log(f"  {tag} main path: launches {launches_y} "
        f"({time.perf_counter() - T0:.1f} s)")
    assert launches_y == want, launches_y
    for o, dt in ((out_bf, bf16), (out_bfs, bf16), (out_s, torch.float32),
                  (out_p, torch.float32)):
        assert o.shape == (BATCH, n_out) and o.dtype == dt, o.shape
        assert torch.isfinite(o.float()).all()

    # the float32 Detector on CUDA against the CPU, det for det
    det_cpu = Detector(str(cfg), str(weights), device="cpu")
    n_dets = 0
    for f, got in zip(frames, dets):
        want = det_cpu.detect(f, thresh=thresh - 1e-4)
        n_dets += match_dets(
            [(d.class_id, d.prob, np.asarray(d.box)) for d in got],
            [(d.class_id, d.prob, np.asarray(d.box)) for d in want],
            thresh, 1e-4)
    # the int8 Detector: CUDA and CPU calibrate with float32 sums in other
    # orders, so scales and codes may differ in the last bits, and the
    # bf16 head's logits by a bf16 step. Random weights give probs closer
    # together than that shift (phase 8), so at 608 the two are held to a
    # band before NMS, and det for det runs on the trained yolov2-style
    # A/B model of tests/golden/map_ab_v2.npz (route -3, reorg 2, route
    # -1,-3), with its mAP gates on CUDA
    det8_cpu = Detector(str(cfg), str(weights), device="cpu",
                        int8_calib=calib8)
    x0 = det8.preprocess(frames[0])[None]
    p8 = det8.predict_batch(x0)[1][0].cpu()
    p8_diff = (p8 - det8_cpu.predict_batch(x0)[1][0]).abs().max().item()
    assert torch.isfinite(p8).all() and p8_diff <= 0.1, p8_diff
    assert all(np.isfinite(d.prob) for d in dets8[0])
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    from tools.synth_dataset import make_dataset
    g = np.load(GOLDEN / "map_ab_v2.npz")
    list_path, gt = make_dataset(str(WORK / "map_ab_v2"),
                                 int(g["n_images"]), int(g["seed"]))
    (WORK / "map_ab_v2.cfg").write_text(bytes(g["cfg"]).decode())
    (WORK / "map_ab_v2.weights").write_bytes(bytes(g["weights"]))
    ab = (str(WORK / "map_ab_v2.cfg"), str(WORK / "map_ab_v2.weights"))
    ab_paths = [l.strip() for l in open(list_path) if l.strip()]
    d32 = Detector(*ab, device=dev)
    calib_ab = np.stack([d32.preprocess(load_image_rgb(p))
                         for p in ab_paths[:8]])
    d8 = Detector(*ab, device=dev, int8_calib=calib_ab)
    d8_cpu = Detector(*ab, device="cpu", int8_calib=calib_ab)
    s8 = d8.net.qnet.act_scales
    assert s8[9] == max(s8[8], s8[6]) and s8[8] == s8[4] and s8[6] != s8[8]
    thr_ab, margin_ab = 0.15, 0.02
    n_ab, p_ab = 0, 0.0
    for path in ab_paths:
        img = load_image_rgb(path)
        xf = d8.preprocess(img)[None]
        p_ab = max(p_ab, (d8.predict_batch(xf)[1].cpu()
                          - d8_cpu.predict_batch(xf)[1]).abs().max().item())
        got, want = (
            [(d.class_id, d.prob, np.asarray(d.box)) for d in
             d_.detect(img, thresh=thr_ab - margin_ab)] for d_ in (d8, d8_cpu))
        n_ab += match_dets(got, want, thr_ab, margin_ab, require=False)
    assert n_ab > 0 and p_ab <= margin_ab, (n_ab, p_ab)
    oracle = float(g["oracle_map"])
    map32 = voc_map(d32, ab_paths, gt, float(g["thresh"]), float(g["nms"]))
    map8 = voc_map(d8, ab_paths, gt, float(g["thresh"]), float(g["nms"]))
    assert abs(map32 - oracle) <= 0.1 and abs(map8 - map32) <= 0.05, (
        oracle, map32, map8)
    # the C-oracle golden at 416 (cfg/yolo.cfg at full width) on CUDA
    gcfg = WORK / "yolo-416.cfg"
    gcfg.write_text(cfg_text)
    gspec = parse_network_cfg(str(gcfg))
    save_weights(gspec, init_params(gspec, seed=int(g416["seed"])),
                 str(WORK / "yolo-416.weights"))
    gdet = Detector(str(gcfg), str(WORK / "yolo-416.weights"), device=dev)
    with torch.no_grad():
        gout, _ = gdet.net(torch.from_numpy(
            np.transpose(g416["input_chw"], (1, 2, 0))[None].copy()).to(dev))
    gout = gout[0].cpu().numpy()
    assert np.allclose(gout, g416["output"], rtol=2e-4, atol=2e-4)
    golden_err = float(np.abs(gout - g416["output"]).max())
    del gdet
    # the pipe server on the yolov2 cfg: 3 requests, equal to the
    # in-process Detector
    req = b"".join(struct.pack("<3if", f.shape[1], f.shape[0], f.shape[2],
                               thresh) + f.astype("<f4").tobytes()
                   for f in frames) + struct.pack("<3if", 0, 0, 0, 0.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.infer.serve",
         str(cfg), str(weights)], cwd=ROOT, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(req, timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err.decode()[-2000:]
    assert struct.unpack("<5i", out[:20]) == (0x53524456, Y_NET, Y_NET,
                                              n_boxes, 80)
    per = 4 * n_boxes * (4 + 80)
    assert len(out) == 20 + 3 * per
    for i, f in enumerate(frames):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        wb, wp = det.predict_batch(det.preprocess(f)[None], thresh=thresh)
        assert np.allclose(blob[:n_boxes * 4].reshape(-1, 4),
                           wb[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
        assert np.allclose(blob[n_boxes * 4:].reshape(-1, 80),
                           wp[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
    log(f"phase 23 ok: {tag} detection: {n_dets} float32 detections "
        f"matched on CUDA and CPU; int8 probs on CUDA and CPU max |diff| "
        f"{p8_diff} before NMS (band 0.1); map_ab_v2 int8: {n_ab} "
        f"detections matched on CUDA and CPU within {margin_ab} (max |prob "
        f"diff| before NMS {p_ab}), mAP on CUDA f32 {map32}, int8 {map8}, "
        f"oracle {oracle}; golden yolo_coco_416 on CUDA (max |err| "
        f"{golden_err}); the server answered 3 requests, equal to the "
        f"in-process Detector [{gpu}]")

    # ---------------------------------------------------------- phase 24
    # batch 128: the bf16 phase stem link by link against the plain
    # engine's conv + pool layers on the same input; the int8 trunks
    stem_link_err = 0.0
    for l, xi, w_hwio, bias in fwd_links:
        got = PT.fwd_pair(xi, w_hwio, bias)
        with torch.no_grad():
            ref = bf._net.layers[l.index + 1](bf._net.layers[l.index](
                xi.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        zero = torch.zeros(bias.shape[0], device=dev)
        z, _, _ = PT.fwdstats(xi, w_hwio, zero, torch.ones_like(zero))
        stem_link_err = max(stem_link_err, assert_stem_link_close(
            got.float().cpu().numpy(), ref.float().cpu().numpy(),
            z.float().cpu().numpy()))
        del got, ref, z
        torch.cuda.empty_cache()
    bfs_diff = (out_bfs.float() - out_bf.float()).abs().max().item()
    head = len(spec.layers) - 2
    assert torch.equal(q_stem.qnet.forward(frames_u8, stop=head),
                       q_plain.qnet.forward(frames_u8, stop=head))
    out_diff = (out_s - out_p).abs().max().item()
    assert out_diff <= 2 ** -7, out_diff
    # batch 1: the fused stem rounds once, the plain chain twice, so the
    # two engines' candidates match within the band their probs leave
    # (measured on every box and class of the frame); the int8 engine's
    # candidates are finite
    def frame_probs(eng, f):
        """Every box's class probs of a u8 frame, as LatencyEngine's call
        computes them before its top-k."""
        x = torch.as_tensor(f).to(dev).float() / 255.0
        out, _ = eng.forward(x[None].to(eng.dtype))
        acts = out.float().reshape(-1, 85)
        return acts[:, 4:5] * acts[:, 5:]
    n_cands, lat_margin = 0, 0.0
    for f, (of, op, o8) in zip(u8, lat_out):
        for bx, pr in (of, op, o8):
            assert bx.shape == (k_lat, 4) and pr.shape == (k_lat, 80)
            assert torch.isfinite(bx).all() and torch.isfinite(pr).all()
        pf, pp = (frame_probs(e, f) for e in (lat_f, lat_p))
        margin = max(1.5 * (pf - pp).abs().max().item(), 1e-3)
        cf, cp = candidates(*of), candidates(*op)
        thr = sorted((p for _, p, _ in cp), reverse=True)[4] - margin
        # every box above thr - margin is a candidate of both engines
        assert k_lat == n_boxes or max(
            min(p for _, p, _ in c) for c in (cf, cp)) < thr - margin
        n_cands += match_dets(cf, cp, thr, margin)
        lat_margin = max(lat_margin, margin)
    del out_bf, out_bfs, out_s, out_p
    torch.cuda.empty_cache()
    log(f"phase 24 ok: {tag} B={BATCH}: bf16 ThroughputEngine with its "
        f"phase stem within the link bounds of the plain engine's layers "
        f"(max |err| {stem_link_err}; whole outputs max |diff| {bfs_diff}); "
        f"int8 trunks equal with and without the phase stem, outputs "
        f"{'equal' if out_diff == 0 else f'max |diff| {out_diff}'}; "
        f"batch 1: {n_cands} candidates matched between the fused and "
        f"plain engines within {lat_margin}, int8 candidates finite "
        f"[{gpu}]")

    # ---------------------------------------------------------- phase 25
    times, bounds, errs = time_serving_kernels(
        tag, sk, bf_stem._stem, lat_f._stem, frames_u8, x1,
        [("a frame's candidates", *nms_cases[1][1:])], nms_err, gpu)

    # the batch-128 engines' images/s (host clock around queued batches,
    # one sync), in turns; the batch-1 engines' device time a frame
    for kind, pair in (("bf16", (bf, bf_stem)), ("int8 u8", (q_plain,
                                                             q_stem))):
        kw = {"input_dtype": torch.uint8} if kind == "int8 u8" else {}
        for name, eng in zip(("plain", "phase stem", "phase stem", "plain"),
                             (*pair, *reversed(pair))):
            r = eng.benchmark(iters=10, warmup=2, **kw)
            log(f"time {tag} {kind} engine B={BATCH}, {name}: "
                f"{r['images_per_sec']} images/s ({r['sec_per_batch']} "
                f"s/batch) [{gpu}]")
    for name, eng in (("bf16 fused stem", lat_f), ("bf16 plain", lat_p),
                      ("int8", lat8)):
        ms = eng.device_benchmark(reps=30)["device_ms_per_frame"]
        log(f"time {tag} LatencyEngine {name} per frame (CUDA events, 30 "
            f"queued frames): {ms} ms [{gpu}]")
    # torch.profiler over a bf16 and an int8 batch with their stems
    name = f"{tag} ThroughputEngine bf16 + phase stem B={BATCH}, per batch"
    seen = profile(name, lambda: bf_stem(x_b), 3, gpu)
    assert_conv_tensor_core(name, seen, 3, {
        "fwd_tc_kernel": 1, "fwd_fold_kernel": 1, "fwdstats_tc_kernel": 0,
        "fwdstats_fold_kernel": 0, "fwdstats_kernel": 0})
    assert not any(named(k, key) for k in ("colsum_kernel", "apply_kernel")
                   for key in seen), (name, seen)
    name = f"{tag} int8 engine B={BATCH} u8, phase stem, per batch"
    seen = profile(name, lambda: q_stem(frames_u8), 3, gpu)
    assert any("phase_pair_tc_kernel" in k for k in seen), (name, seen)
    assert not any(named("phase_pair_kernel", k) for k in seen), (name, seen)
    log(f"  {name}: the stem ran as phase_pair_tc_kernel (int8 tensor "
        f"cores), no phase_pair_kernel")
    log(f"phase 25 ok: {tag} times, bounds and profiles; peak device "
        f"memory since phase 22 "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{gpu}]")

    return serving_entries(times, bounds, errs, launches_y)


def gap_thresh(values, lo, hi, margin):
    """A detection threshold in the widest gap between the ``values``
    that lie in (lo, hi), so that differences below ``margin`` cannot
    move a value across it; the gap must be wider than twice that."""
    v = np.sort(values[(values > lo) & (values < hi)])
    i = int(np.argmax(v[1:] - v[:-1]))
    assert v[i + 1] - v[i] > 2 * margin, (v, margin)
    return float((v[i] + v[i + 1]) / 2)


N9 = 416           # yolo9000's published width and height (cfg/yolo9000.cfg)
N9_PAIRS = [(0, 1), (2, 3)]   # its stem pairs: 3 -> 32 @416, 32 -> 64 @208
N9_CLASSES, N9_GROUPS = 9418, 2429   # its tree's nodes and sibling groups
N9_HEAD_GAIN = 4.0  # the head's scale: random probs spread, logits < 80


def yolo9000_files():
    """yolo9000-416's cfg (models/zoo.py's) under WORK/yolo9000, with the
    tree and map it names. The real 9k.tree and coco9k.map are not in the
    repository: a tree of the same size (nodes, sibling groups) and an
    80-entry map are written from a seed. Returns (directory, cfg path,
    map path, spec)."""
    from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
    from sr_object_detection_tpu_torch.models.zoo import yolo9000
    from torch_parity import (seeded_class_map, seeded_tree_lines,
                              zoo_cfg_text)
    d = WORK / "yolo9000"
    d.mkdir(parents=True, exist_ok=True)
    tree, cmap = d / "9k.tree", d / "coco9k.map"
    tree.write_text("\n".join(seeded_tree_lines(N9_CLASSES, N9_GROUPS, 0))
                    + "\n")
    cmap.write_text("\n".join(map(str, seeded_class_map(N9_CLASSES, 80, 0)))
                    + "\n")
    cfg = d / "yolo9000.cfg"
    zoo_kw = dict(width=N9, height=N9, tree_file=str(tree),
                  map_file=str(cmap))
    cfg.write_text(zoo_cfg_text(yolo9000, **zoo_kw))
    spec = parse_network_cfg(str(cfg))
    assert spec.layers == yolo9000(**zoo_kw).layers
    return d, cfg, cmap, spec


def yolo9000_416(gpu, dev, reset_counts, counts):
    """Phases 29-31 (the module docstring): yolo9000-416 serving. Returns
    the kernels line's entries for the four kernels on this path, at
    yolo9000-416's shapes."""
    from sr_object_detection_tpu_torch.graph.compiler import RegionLayer
    from sr_object_detection_tpu_torch.infer import quant as Q
    from sr_object_detection_tpu_torch.infer.detector import Detector
    from sr_object_detection_tpu_torch.infer.engine import (
        LatencyEngine, ThroughputEngine)
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, save_weights)
    from sr_object_detection_tpu_torch.kernels import b1_stem as BS
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.ops import boxes as B

    # ---------------------------------------------------------- phase 29
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(29)
    bf16 = torch.bfloat16
    tag = f"yolo9000-{N9}"
    d, cfg, cmap, spec = yolo9000_files()
    # random weights from seed 0, BN statistics and biases randomized, the
    # head scaled so that objectness and the tree's path probs spread
    params_np = random_bn(init_params(spec, seed=0), 1,
                          head_gain=N9_HEAD_GAIN)
    weights = d / "yolo9000.weights"
    save_weights(spec, params_np, str(weights))
    region = spec.layers[-1]
    n_boxes = region.h * region.w * region.n             # 507 at 416
    k_nms = min(128, n_boxes)
    log(f"  {tag}: {len(spec.layers)} layers, head {spec.layers[-2].c} -> "
        f"{spec.layers[-2].filters}, {N9_CLASSES} classes in {N9_GROUPS} "
        f"sibling groups (seeded tree), {n_boxes} boxes "
        f"({time.perf_counter() - T0:.1f} s)")

    # the batch-128 engines of bench.py's yolo9000 configuration: bf16 and
    # the int8 full stack (int8 trunk and head, bf16 region decode), both
    # with the flat pre-split head, with and without their stems, and
    # with presplit=False for the comparison
    bf = ThroughputEngine(spec, params_np, batch=BATCH, device=dev,
                          presplit="flat")
    bf_stem = ThroughputEngine(spec, params_np, batch=BATCH, device=dev,
                               presplit="flat", phase_stem=True)
    bf_ref = ThroughputEngine(spec, params_np, batch=BATCH, device=dev,
                              phase_stem=True)
    calib = rng.uniform(0, 1, (4, N9, N9, 3)).astype(np.float32)
    full = dict(quantize_head=True, region_dtype=bf16)
    q_stem = Q.QuantizedThroughputEngine(
        spec, params_np, batch=BATCH, device=dev, calib_x=calib,
        presplit="flat", phase_stem=True, **full)
    q_plain = Q.QuantizedThroughputEngine(
        spec, params_np, batch=BATCH, device=dev, calib_x=calib,
        presplit="flat", **full)
    q_ref = Q.QuantizedThroughputEngine(
        spec, params_np, batch=BATCH, device=dev, calib_x=calib,
        phase_stem=True, **full)
    assert bf_stem.phase_stem and bf.presplit and bf_stem.presplit
    assert q_stem.presplit and not q_ref.presplit
    assert PS.plan_pairs(q_stem.qnet.spec) == N9_PAIRS
    assert BS.plan_pairs(bf_stem.spec) == N9_PAIRS
    lat_f = LatencyEngine(spec, params_np, device=dev, fused_stem=True)
    lat_p = LatencyEngine(spec, params_np, device=dev)
    assert lat_f.fused_stem and not lat_p.fused_stem
    frames_u8 = torch.from_numpy(rng.integers(
        0, 256, (BATCH, N9, N9, 3), dtype=np.uint8)).to(dev)
    x_b = frames_u8.float() / 255.0
    x1 = torch.from_numpy(rng.uniform(0, 1, (1, N9, N9, 3)).astype(
        np.float32)).to(dev, bf16)
    sk = check_serving_kernels(spec, N9_PAIRS, bf_stem, q_stem, lat_f,
                               frames_u8, x1, {"taps": 1, "tap_pairs": 0,
                                               "chunks": 1})

    # kernel 1 at C=9,418 and C=80: a frame's candidates after the walk
    # (no map: at most one live class a box), random candidates with
    # every class live, and the map's candidates gated at the detection
    # threshold
    det = Detector(str(cfg), str(weights), device=dev)
    det_map = Detector(str(cfg), str(weights), device=dev, map_path=str(cmap))
    frames = [rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
              for _ in range(2)]
    x0 = det.preprocess(frames[0])[None]
    with torch.no_grad():
        acts = det.net(torch.from_numpy(x0).to(dev))[0].float().reshape(
            n_boxes, -1)
    # the no-map gate on objectness, below the walk's 0.5 so that every
    # gated box's walk passes the detection threshold too; the map's on
    # obj * the mapped class's path prob, among the best 16 boxes
    obj_thresh = gap_thresh(acts[:, 4].cpu().numpy(), 0.25, 0.5, 1e-4)
    fb, fp = det.predict_batch(x0, thresh=obj_thresh)
    assert fp.shape == (1, n_boxes, N9_CLASSES)
    assert ((fp[0] > 0).sum(-1) <= 1).all() and (fp[0] > 0).any()
    mb, mp = det_map.predict_batch(x0)
    best = np.sort(mp[0].max(-1).values.cpu().numpy())[::-1][:16]
    map_thresh = gap_thresh(best, 0.0, 1.0, 1e-4)
    n = n_boxes
    rb = torch.from_numpy(np.stack(
        [rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(.02, .4, n),
         rng.uniform(.02, .4, n)], axis=1).astype(np.float32)).to(dev)
    rp = torch.from_numpy(rng.uniform(.05, 1, (n, N9_CLASSES)).astype(
        np.float32)).to(dev)
    nms_cases = [
        ("the walk's candidates", *B.topk_candidates(fb[0], fp[0], k_nms)[:2]),
        ("random, every class and rank live",
         *B.topk_candidates(rb, rp, k_nms)[:2]),
        ("the map's candidates, gated",
         *B.topk_candidates(mb[0], torch.where(mp[0] > map_thresh, mp[0], 0.0),
                            k_nms)[:2])]
    del rp
    nms_err = 0.0
    for name, tb, tp in nms_cases:
        got = NMS.nms_per_class(tb, tp, 0.4)
        ref = NMS.nms_per_class_plain(tb, tp, 0.4)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), name
        # mostly-empty classes come back as exact zeros
        assert torch.equal(got[tp == 0].view(torch.int32),
                           torch.zeros_like(got[tp == 0]).view(torch.int32))
        nms_err = max(nms_err, (got - ref).abs().max().item())
        log(f"  NMS C={tp.shape[0]} k={tp.shape[1]} ({name}): kernel == "
            f"plain, {(tp > 0).any(1).sum().item()} live classes "
            f"({time.perf_counter() - T0:.1f} s)")
        del ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 29 ok: {tag}'s four serving kernels at its shapes == their "
        f"plain versions: kernel 4's fwd at B={BATCH} (torch.equal to "
        f"fwdstats + apply, max |err| against fwd_pair_plain "
        f"{sk['fwd_err']}), kernel 3 from u8 frames (torch.equal), the "
        f"batch-1 stem on the conv tile (max |err| {sk['b1_err']}), NMS at "
        f"C={N9_CLASSES} and C=80, k={k_nms} (torch.equal, "
        f"{len(nms_cases)} cases) [{gpu}]")

    # ---------------------------------------------------------- phase 30
    # the main path, counted: Detector (no map, map, presplit, int8 full
    # stack), the batch-1 engines and the batch-128 engines with the flat
    # pre-split head, through the entry points a user calls
    det_pre = Detector(str(cfg), str(weights), device=dev, presplit=True)
    calib8 = det.preprocess(frames[0])[None]
    det8 = Detector(str(cfg), str(weights), device=dev, map_path=str(cmap))
    amax = {}
    calibrate = Q.calibrate_amax

    def keep_amax(*a, **k):
        amax["v"] = calibrate(*a, **k)
        return amax["v"]
    Q.calibrate_amax = keep_amax
    try:
        det8.quantize(calib8, **full)
    finally:
        Q.calibrate_amax = calibrate
    u8 = [rng.integers(0, 256, (N9, N9, 3), dtype=np.uint8)
          for _ in range(3)]
    reset_counts()
    dets = [det.detect(f, thresh=obj_thresh) for f in frames]
    dets_map = [det_map.detect(frames[0], thresh=map_thresh)]
    dets_pre = [det_pre.detect(frames[0], thresh=obj_thresh)]
    p8 = det8.predict_batch(calib8)[1][0].cpu()
    dets8 = [det8.detect(frames[0], thresh=0.0)]
    lat_out = [(lat_f(f), lat_p(f)) for f in u8]
    out_bf = bf(x_b)
    out_bfs = bf_stem(x_b)
    out_s = q_stem(frames_u8)
    out_p = q_plain(frames_u8)
    torch.cuda.synchronize()
    launches_9, want = counts(nms_per_class=5, stem_pair=6,
                              phase_stem_pair=2, phase_train_fwd=2)
    log(f"  {tag} main path: launches {launches_9} "
        f"({time.perf_counter() - T0:.1f} s)")
    assert launches_9 == want, launches_9
    blk = bf_stem.spec.layers[-1].head_block
    for (f, c), dt in ((out_bf, bf16), (out_bfs, bf16), (out_s, bf16),
                       (out_p, bf16)):
        assert f.shape == (BATCH, region.h, region.w, 3, 5), f.shape
        assert c.shape == (BATCH, region.h, region.w, 3 * blk), c.shape
        assert c.dtype == dt and torch.isfinite(c).all()
        assert torch.isfinite(f.float()).all()
    for (bo, pr), _ in lat_out:
        assert pr.shape == (min(LatencyEngine.TOPK, n_boxes), N9_CLASSES)
        assert torch.isfinite(bo).all() and torch.isfinite(pr).all()

    # CUDA against the CPU, det for det: no map (a path prob within 1e-4
    # of the walk's 0.5 cut is reported), the map, presplit
    n_dets, near = {}, 1.0
    for name, d_gpu, got_all, kw, thr in (
            ("no map", det, dets, {}, obj_thresh),
            ("map", det_map, dets_map, {"map_path": str(cmap)}, map_thresh),
            ("presplit", det_pre, dets_pre, {"presplit": True}, obj_thresh)):
        d_cpu = Detector(str(cfg), str(weights), device="cpu", **kw)
        n_dets[name] = 0
        for f, got in zip(frames, got_all):
            want = d_cpu.detect(f, thresh=thr)
            n_dets[name] += match_dets(
                [(g.class_id, g.prob, np.asarray(g.box)) for g in got],
                [(w.class_id, w.prob, np.asarray(w.box)) for w in want],
                thr, 1e-4)
        if name == "no map":
            x = d_cpu.preprocess(frames[0])[None]
            with torch.no_grad():
                a = d_cpu.net(torch.from_numpy(x))[0].reshape(n_boxes, -1)
                path = B.hierarchy_multiply(a[:, 5:], d_cpu._chain)
            live = a[:, 4] > obj_thresh
            near = float((path[live] - 0.5).abs().min()) if live.any() else 1
        del d_cpu
    # int8 full stack: the CPU Detector calibrated to the CUDA one's amax,
    # so that the int8 trunks and head logits are equal; the bf16 decode
    # may round an ulp apart (exp, sums in another order), so the probs
    # before NMS are held within 2^-7, and the detections above a
    # threshold in a gap of the probs wider than twice their measured
    # band are matched within it
    d8_cpu = Detector(str(cfg), str(weights), device="cpu",
                      map_path=str(cmap))
    Q.calibrate_amax = lambda *a, **k: amax["v"]
    try:
        d8_cpu.quantize(calib8, **full)
    finally:
        Q.calibrate_amax = calibrate
    p8_cpu = d8_cpu.predict_batch(calib8)[1][0]
    p8_diff = (p8 - p8_cpu).abs().max().item()
    assert torch.isfinite(p8).all() and p8_diff <= 2 ** -7, p8_diff
    margin8 = max(1.5 * p8_diff, 1e-6)
    thr8 = gap_thresh(np.sort(p8_cpu.max(-1).values.numpy())[::-1][:16],
                      0.0, 1.0, margin8)
    n_dets["int8 full stack"] = match_dets(
        [(g.class_id, g.prob, np.asarray(g.box)) for g in dets8[0]
         if g.prob > thr8],
        [(w.class_id, w.prob, np.asarray(w.box))
         for w in d8_cpu.detect(frames[0], thresh=thr8)], thr8, margin8)
    del d8_cpu
    # the pipe server on the tree cfg, no map: the handshake names the
    # 9,418 classes; 3 requests equal to the in-process Detector
    reqs = frames + [frames[0]]
    req = b"".join(struct.pack("<3if", f.shape[1], f.shape[0], f.shape[2],
                               obj_thresh) + f.astype("<f4").tobytes()
                   for f in reqs) + struct.pack("<3if", 0, 0, 0, 0.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.infer.serve",
         str(cfg), str(weights)], cwd=ROOT, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(req, timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err.decode()[-2000:]
    assert struct.unpack("<5i", out[:20]) == (0x53524456, N9, N9, n_boxes,
                                              N9_CLASSES)
    per = 4 * n_boxes * (4 + N9_CLASSES)
    assert len(out) == 20 + len(reqs) * per
    for i, f in enumerate(reqs):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        wb, wp = det.predict_batch(det.preprocess(f)[None], thresh=obj_thresh)
        assert np.allclose(blob[:n_boxes * 4].reshape(-1, 4),
                           wb[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
        assert np.allclose(blob[n_boxes * 4:].reshape(-1, N9_CLASSES),
                           wp[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
    log(f"phase 30 ok: {tag} detection on CUDA and the CPU det for det "
        f"{n_dets} (the closest path prob to the walk's 0.5 cut among the "
        f"gated boxes {near} away), int8 full stack probs max |diff| "
        f"{p8_diff} before NMS (band {margin8}); the server answered {len(reqs)} requests "
        f"({N9_CLASSES} classes), equal to the in-process Detector [{gpu}]")

    # ---------------------------------------------------------- phase 31
    # B=128 with the flat pre-split head against presplit=False: the int8
    # trunks equal (with and without the stem, flat and not), the int8
    # fields equal; the bf16 fields within 2^-7 of their value or 2^-7
    # absolute (the two heads' cuDNN convs, of 28,800 and 28,269 outputs,
    # sum in other orders and round an ulp or two apart), the class
    # lanes within 2^-4 (the flat head's offset is the whole row's max,
    # so its bf16 x - max rounds elsewhere); and the bf16 fields and class
    # lanes within a bf16 ulp of the CPU's region layer on the card's
    # own head logits
    head = len(spec.layers) - 2
    trunk = q_stem.qnet.forward(frames_u8, stop=head)
    assert torch.equal(trunk, q_ref.qnet.forward(frames_u8, stop=head))
    assert torch.equal(trunk, q_plain.qnet.forward(frames_u8, stop=head))
    del trunk

    def lanes(c):
        return torch.stack([c[..., a * blk + 128:a * blk + 128 + N9_CLASSES]
                            for a in range(3)], dim=3)
    f_ref, c_ref = q_ref(frames_u8).reshape(
        BATCH, region.h, region.w, 3, -1).split([5, N9_CLASSES], dim=-1)
    assert torch.equal(out_s[0], f_ref)
    q_diff = (lanes(out_s[1]).float() - c_ref.float()).abs().max().item()
    del f_ref, c_ref
    f_ref, c_ref = bf_ref(x_b).reshape(
        BATCH, region.h, region.w, 3, -1).split([5, N9_CLASSES], dim=-1)
    bf_fdiff = (out_bfs[0].float() - f_ref.float()).abs().max().item()
    assert torch.allclose(out_bfs[0].float(), f_ref.float(), rtol=2 ** -7,
                          atol=2 ** -7), bf_fdiff
    bf_diff = (lanes(out_bfs[1]).float() - c_ref.float()).abs().max().item()
    del f_ref, c_ref
    assert q_diff <= 2 ** -4 and bf_diff <= 2 ** -4, (q_diff, bf_diff)
    with torch.no_grad():
        logits = bf_stem._net(bf_stem._stem(x_b), keep_all=True)[1][
            "outputs"][head - 2 * len(N9_PAIRS)][:2]
    cpu_region = RegionLayer(bf_stem.spec.layers[-1],
                             bf_stem._net.trees[len(spec.layers) - 1
                                                - 2 * len(N9_PAIRS)])
    want_f, want_c = cpu_region.activate(logits.cpu())
    assert_bf16_close(out_bfs[0][:2].float().cpu().numpy(),
                      want_f.float().numpy())
    assert_bf16_close(out_bfs[1][:2].float().cpu().numpy(),
                      want_c.float().numpy())
    del logits, want_f, want_c, out_bf, out_bfs, out_s, out_p
    torch.cuda.empty_cache()
    log(f"  {tag} B={BATCH} flat pre-split head: int8 trunks equal, int8 "
        f"fields equal, class lanes max |diff| against presplit=False int8 "
        f"{q_diff}, bf16 {bf_diff} (bf16 fields {bf_fdiff}); bf16 fields "
        f"and class lanes within a bf16 ulp of the CPU's region layer on "
        f"the card's head logits")

    times, bounds, errs = time_serving_kernels(
        tag, sk, bf_stem._stem, lat_f._stem, frames_u8, x1,
        nms_cases, nms_err, gpu)
    # the batch-128 engines' images/s in turns (host clock around queued
    # batches, one sync)
    for kind, engs, kw in (
            ("bf16", (("flat pre-split", bf), ("flat pre-split + phase stem",
                                                bf_stem),
                      ("presplit=False + phase stem", bf_ref)), {}),
            ("int8 full stack u8", (("flat pre-split", q_plain),
                                    ("flat pre-split + phase stem", q_stem),
                                    ("presplit=False + phase stem", q_ref)),
             {"input_dtype": torch.uint8})):
        for name, eng in (*engs, *reversed(engs)):
            r = eng.benchmark(iters=10, warmup=2, **kw)
            log(f"time {tag} {kind} engine B={BATCH}, {name}: "
                f"{r['images_per_sec']} images/s ({r['sec_per_batch']} "
                f"s/batch) [{gpu}]")
    # the batch-1 engines in turns (fused, plain, plain, fused, twice),
    # then ten profiled frames of each: device busy time against the wall
    # says whether a frame waits on the card or on the host's launches
    lats = (("bf16 fused stem", lat_f), ("bf16 plain", lat_p))
    for name, eng in (*lats, *reversed(lats)) * 2:
        ms = eng.device_benchmark(reps=30)["device_ms_per_frame"]
        log(f"time {tag} LatencyEngine {name} per frame (CUDA events, 30 "
            f"queued frames): {ms} ms [{gpu}]")
    for name, eng in lats:
        profile(f"{tag} LatencyEngine {name}, per frame",
                lambda: eng.forward(x1), 10, gpu, top=8,
                ranges=("grouped_softmax",))
    # where a batch goes, the grouped softmax's share included
    for name, fn in ((f"{tag} ThroughputEngine bf16 flat pre-split + phase "
                      f"stem B={BATCH}, per batch", lambda: bf_stem(x_b)),
                     (f"{tag} int8 full stack flat pre-split + phase stem "
                      f"B={BATCH} u8, per batch", lambda: q_stem(frames_u8))):
        seen = profile(name, fn, 3, gpu, top=8, ranges=("grouped_softmax",))
        if "bf16" in name:
            assert_conv_tensor_core(name, seen, 3, {
                "fwd_tc_kernel": 1, "fwd_fold_kernel": 1,
                "fwdstats_tc_kernel": 0, "fwdstats_fold_kernel": 0,
                "fwdstats_kernel": 0})
        else:
            assert any("phase_pair_tc_kernel" in k for k in seen), seen
    log(f"phase 31 ok: {tag} times, bounds and profiles; peak device "
        f"memory since phase 29 "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{gpu}]")
    return serving_entries(times, bounds, errs, launches_9)


Y2_CHUNK = 16      # images a plain version takes at once at 608
Y_ALT = 416        # a multi-scale size for Trainer._step_for


def train_kernels_at(tag, net, stem_layers, chunk, seed, gpu, dev):
    """The pair's kernels (3 -> 32 at ``net``, B=128) and F2, B1 and B2 at
    the fused-stem pairs ``stem_layers`` ((layer, H, C), channels-last as
    the conv writes them, with the batch's own statistics) against their
    plain versions, the plain versions ``chunk`` images at a time (twice
    that after layer 0); fwdstats and bwdg twice more, bit-equal. Each
    kernel's time from a CUDA graph in turns with its plain version on
    the whole batch, beside its bound (fwdstats beside cuDNN's F.conv2d
    alone); F2, B1 and B2 summed over the pairs. Returns (times, bounds,
    errs, library) under the kernels line's names."""
    import torch.nn.functional as F
    from sr_object_detection_tpu_torch.kernels import fused_stem as FS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    times, bounds, errs, library = {}, {}, {}, {}
    conv0, tc0 = dict(PT.conv_kernels["fwdstats"]), dict(PT.bwdg_kernels)
    case = train_case(seed + net, BATCH, net, 3, 32, dev)
    e = check_train_kernels(PT, case, chunk=chunk)
    log(f"  pair 3->32 @{net} B={BATCH}: fwdstats, apply, bwdg == plain "
        f"(max |err| {e}; W2 = {net // 2}: "
        f"{'whole' if (net // 2) % 8 == 0 else 'partial'} 8x8 pooled "
        f"tiles) ({time.perf_counter() - T0:.1f} s)")
    x0, w0, dp0 = case["x"], case["w"], case["dp"]
    sh0, sc0, b0 = case["shift"], case["scales"], case["biases"]
    f1, f2 = (PT.fwdstats(x0, w0, sh0, sc0) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(f1, f2))
    z0, am0, st0 = f1
    del f1, f2
    mean0, _, inv0 = PT._batch_stats(st0, sh0, BATCH * net * net)
    bw = [PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*bw))
    del bw
    # the check's and the two launches: fwdstats on the taps fold, bwdg
    # on the tensor cores (the timing's graph captures count too)
    assert PT.conv_kernels["fwdstats"]["tensor_core_fold"] - conv0[
        "tensor_core_fold"] == 3 and PT.conv_kernels["fwdstats"][
        "fp32_core"] == conv0["fp32_core"], PT.conv_kernels
    assert PT.bwdg_kernels == {"tensor_core": tc0["tensor_core"] + 3,
                               "fp32_core": tc0["fp32_core"]}
    x_bytes = 2 * x0.numel()
    pooled = z0.numel()
    conv_ops = 2 * BATCH * net * net * 32 * 27
    name = "phase_train_fwdstats"
    times[name] = abba_graph(f"{tag} {name} 3->32 B={BATCH}",
                             lambda: PT.fwdstats(x0, w0, sh0, sc0),
                             lambda: PT.fwdstats_plain(x0, w0, sh0, sc0),
                             gpu, plain_iters=2)
    bounds[name] = bound(x_bytes + 2 * 27 * 32 + 8 * 32 + 3 * pooled
                         + 8 * 32, conv_ops, "bf16")
    xc0, wc0 = x0.permute(0, 3, 1, 2), w0.permute(3, 2, 0, 1).contiguous()
    library[name] = (cuda_ms(lambda: F.conv2d(xc0, wc0, padding=1), 5)
                     + cuda_ms(lambda: F.conv2d(xc0, wc0, padding=1), 5)) / 2
    del xc0
    name = "phase_train_apply"
    times[name] = abba_graph(
        f"{tag} {name} 32 ch B={BATCH}",
        lambda: PT.apply(z0, mean0, inv0, sc0, b0),
        lambda: PT.apply_plain(z0, mean0, inv0, sc0, b0), gpu,
        plain_iters=2)
    bounds[name] = bound(4 * pooled + 16 * 32, 6 * pooled, "bf16")
    name = "phase_train_bwdg"
    times[name] = abba_graph(
        f"{tag} {name} 3->32 B={BATCH}",
        lambda: PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0),
        lambda: PT.bwdg_plain(x0, dp0, z0, am0, mean0, inv0, sc0, b0), gpu,
        plain_iters=2)
    bounds[name] = bound(
        x_bytes + 5 * pooled + 16 * 32
        + 4 * (2 * 32 + 27 * 32 + 27 + 27 * 27),
        2 * BATCH * net * net * 27 * 27 + 2 * pooled * 27, "bf16")
    for name in ("phase_train_fwdstats", "phase_train_apply",
                 "phase_train_bwdg"):
        errs[name] = e[name[len("phase_train_"):]]
        log(f"bound {tag} {name}: {bounds[name][0]} ms by {bounds[name][1]}"
            f"; kernel {times[name][0] / bounds[name][0]:.2f}x [{gpu}]")
    log(f"time {tag} library F.conv2d bf16 (cuDNN, the conv alone) 3->32 "
        f"B={BATCH}: {library['phase_train_fwdstats']} ms [{gpu}]")
    del case, x0, w0, dp0, z0, am0
    torch.cuda.empty_cache()
    stem_errs = {"f2": 0.0, "b1": 0.0, "b2": 0.0}
    # per kernel: kernel ms, plain ms, bound ms summed over the pairs, and
    # the largest pair's (bound, bound_by)
    fs = {n: [0.0, 0.0, 0.0, (0.0, "bytes")] for n in ("f2", "b1", "b2")}
    for li, h, c in stem_layers:
        scase = stem_case(seed * 100 + li, BATCH, h, c, dev)
        paths0 = dict(FS.paths)
        y2 = scase["y"]
        past = images_past_2g(y2)
        e = check_fused_stem_kernels(FS, scase, chunk=chunk if h == net
                                     else 2 * chunk)
        stem_errs = {n: max(stem_errs[n], e[n]) for n in e}
        # the check's launches: F2 once, B1 twice, B2 once, row kernels
        assert {k: FS.paths[k] - paths0[k] for k in FS.paths} == {
            **dict.fromkeys(FS.paths, 0), "f2_row": 1, "b1_row": 2,
            "b2_row": 1}, FS.paths
        log(f"  fused stem layer {li} {h}x{h}x{c} B={BATCH}: F2, B1, B2 == "
            f"plain (max |err| {e}); y {y2.numel() * 2 / 1e9:.2f} GB, "
            f"images {past}-{BATCH - 1} wholly past 2^31 bytes"
            f"{' (none)' if past == BATCH else ''} "
            f"({time.perf_counter() - T0:.1f} s)")
        dp2 = scase["dp"]
        k4 = [scase[n] for n in ("mean", "inv", "scales", "biases")]
        s123 = [scase[n] for n in ("c1", "c2", "c3")]
        yb, win = y2.numel() * 2, y2.numel() // 4
        pb = {"f2": bound(yb + yb // 4 + 16 * c, 36 * win, "f32"),
              "b1": bound(yb + yb // 4 + 16 * c + 8 * c, 52 * win, "f32"),
              "b2": bound(2 * yb + yb // 4 + 28 * c, 64 * win, "f32")}
        fns = {"f2": (lambda: FS.f2(y2, *k4), lambda: FS.f2_plain(y2, *k4)),
               "b1": (lambda: FS.b1(y2, dp2, *k4),
                      lambda: FS.b1_plain(y2, dp2, *k4)),
               "b2": (lambda: FS.b2(y2, dp2, *k4, *s123),
                      lambda: FS.b2_plain(y2, dp2, *k4, *s123))}
        for n, (kf, pf) in fns.items():
            k_ms, p_ms = abba_graph(f"{tag} fused_stem {n.upper()} layer "
                                    f"{li} {h}x{h}x{c} B={BATCH}", kf, pf,
                                    gpu, plain_iters=2)
            log(f"bound {tag} fused_stem {n.upper()} layer {li}: "
                f"{pb[n][0]} ms by {pb[n][1]}; kernel "
                f"{k_ms / pb[n][0]:.2f}x [{gpu}]")
            acc = fs[n]
            acc[0] += k_ms
            acc[1] += p_ms
            acc[2] += pb[n][0]
            acc[3] = max(acc[3], pb[n])
        del scase, y2, dp2, k4, s123, fns
        torch.cuda.empty_cache()
    for n, (k_ms, p_ms, b_ms, (_, b_by)) in fs.items():
        name = f"fused_stem_{n}"
        times[name] = (k_ms, p_ms)
        bounds[name] = (b_ms, b_by)
        errs[name] = stem_errs[n]
    return times, bounds, errs, library


TRAIN_REPLACES = {
    "phase_train_fwdstats":
        "sr_object_detection_tpu/kernels/phase_train.py:209",
    "phase_train_apply": "sr_object_detection_tpu/kernels/phase_train.py:722",
    "phase_train_bwdg": "sr_object_detection_tpu/kernels/phase_train.py:209",
    "fused_stem_f2": "sr_object_detection_tpu/kernels/fused_stem.py:135",
    "fused_stem_b1": "sr_object_detection_tpu/kernels/fused_stem.py:170",
    "fused_stem_b2": "sr_object_detection_tpu/kernels/fused_stem.py:187"}


def train_entries(tag, times, bounds, errs, library, launches, shapes):
    """The kernels line's entries for the pair's and the fused stem's
    kernels at one net's training shapes (train_kernels_at's times,
    bounds, errors and library calls; the launches counted on its
    Trainer's paths), named "<kernel> (<tag> training: <shapes>)" with
    ``shapes`` {"phase_train": ..., "fused_stem": ...}."""
    return [{"name": f"{name} ({tag} training: "
                     f"{shapes[name.rsplit('_', 1)[0]]})", "route": "cuda",
             "source": "sr_object_detection_tpu_torch/csrc/"
                       + ("phase_train.cu" if name.startswith("phase")
                          else "fused_stem.cu"),
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1],
             "library_ms": library.get(name)}
            for name, replaces in TRAIN_REPLACES.items()]


def yolov2_608_train(gpu, dev, reset_counts, counts):
    """Phases 26-28 (the module docstring): yolov2-608 training. Returns
    the kernels line's entries for the pair's and the fused stem's
    kernels at yolov2-608's training shapes."""
    from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
    from sr_object_detection_tpu_torch.infer.engine import analytic_flops
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, load_weights)
    from sr_object_detection_tpu_torch.kernels import fused_stem as FS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.models.zoo import yolov2
    from sr_object_detection_tpu_torch.ops import conv as C
    from sr_object_detection_tpu_torch.ops import pooling as P
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    tag = f"yolov2-{Y_NET}"
    bf16 = torch.bfloat16
    GiB = 2 ** 30

    # ---------------------------------------------------------- phase 26
    # the pair (3 -> 32) at 608 and at 152 (W2 = 76, partial 8x8 pooled
    # tiles), B=128, and F2/B1/B2 at the four fused-stem pairs, against
    # their plain versions; each time from a CUDA graph in turns with
    # its plain version, beside its bound
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conv0, tc0 = dict(PT.conv_kernels["fwdstats"]), dict(PT.bwdg_kernels)
    h = Y_NET // 4
    e = check_train_kernels(PT, train_case(26 + h, BATCH, h, 3, 32, dev))
    assert PT.conv_kernels["fwdstats"]["tensor_core_fold"] - conv0[
        "tensor_core_fold"] == 1 and PT.conv_kernels["fwdstats"][
        "fp32_core"] == conv0["fp32_core"], PT.conv_kernels
    assert PT.bwdg_kernels == {"tensor_core": tc0["tensor_core"] + 1,
                               "fp32_core": tc0["fp32_core"]}
    log(f"  pair 3->32 @{h} B={BATCH}: fwdstats, apply, bwdg == plain "
        f"(max |err| {e}; W2 = {h // 2}: partial 8x8 pooled tiles) "
        f"({time.perf_counter() - T0:.1f} s)")
    # the fused-stem pairs (layer, H, C): layers 0, 2, 6 and 10
    times, bounds, errs, library = train_kernels_at(
        tag, Y_NET, ((0, Y_NET, 32), (2, Y_NET // 2, 64),
                     (6, Y_NET // 4, 128), (10, Y_NET // 8, 256)),
        Y2_CHUNK, 26, gpu, dev)
    # the pair's gradient against a float64 evaluation of the unfused
    # chain's formulas: at 608 on 16 images (the float64 evaluation holds
    # several 1.5 GB copies of the conv output), at 152 on all 128
    grads = {}
    for h, b in ((Y_NET, 16), (Y_NET // 4, BATCH)):
        grads[h] = check_pair_gradient(
            PT, C, P, pair_spec(h, 3, 32),
            train_case(260 + h, b, h, 3, 32, dev, flat=False))
        torch.cuda.empty_cache()
    stem_errs = {n: errs[f"fused_stem_{n}"] for n in ("f2", "b1", "b2")}
    torch.cuda.synchronize()
    log(f"phase 26 ok: {tag} training kernels == plain: the pair 3->32 at "
        f"{Y_NET} and {Y_NET // 4} (W2 = {Y_NET // 8}) B={BATCH}, fwdstats "
        f"on the taps fold and bwdg on the tensor cores, two launches of "
        f"each bit-equal; its gradient within {grads[Y_NET]['fused']} "
        f"({Y_NET}, B=16) and {grads[Y_NET // 4]['fused']} ({Y_NET // 4}, "
        f"B={BATCH}) of a "
        f"float64 evaluation (gate 1e-3); F2, B1, B2 at layers 0, 2, 6, 10 "
        f"on the row kernels (max |err| {stem_errs}), layer 0's images "
        f"past 2^31 bytes included; peak device memory "
        f"{torch.cuda.max_memory_allocated() / GiB:.2f} GiB [{gpu}]")

    # ---------------------------------------------------------- phase 27
    # Trainer on yolov2-608 at B=128 (one micro-batch, as the JAX
    # package's bench), 3 steps on one batch a path, each path's peak
    # device memory; input as bench.py's training bench
    base = yolov2(Y_NET, Y_NET)
    yspec = dataclasses.replace(base, net=dataclasses.replace(
        base.net, batch=BATCH, subdivisions=1))
    yparams = init_params(yspec, seed=0)
    gx = torch.Generator(device=dev).manual_seed(27)
    xy = torch.rand((BATCH, Y_NET, Y_NET, 3), generator=gx, device=dev)
    ty_np = np.zeros((BATCH, 30, 5), np.float32)
    ty_np[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    ty_np[::2, 1] = [0.3, 0.6, 0.2, 0.25, 17]
    ty = torch.from_numpy(ty_np).to(dev)
    step_flops = 3 * analytic_flops(yspec)
    paths = {
        "(d) bf16 + remat selective:2": dict(remat="selective:2"),
        "(a) bf16 + phase_train + remat selective:2": dict(
            phase_train=True, remat="selective:2"),
        "(b) bf16 + phase_train + fused_stem": dict(phase_train=True,
                                                    fused_stem=True),
        "(c) bf16 + fused_stem": dict(fused_stem=True)}
    pair1 = dict(phase_train_fwdstats=1, phase_train_apply=1,
                 phase_train_bwdg=1)
    per_step = {
        "(d) bf16 + remat selective:2": {},
        "(a) bf16 + phase_train + remat selective:2": pair1,
        "(b) bf16 + phase_train + fused_stem": dict(
            pair1, fused_stem_f2=3, fused_stem_b1=3, fused_stem_b2=3),
        "(c) bf16 + fused_stem": dict(fused_stem_f2=4, fused_stem_b1=4,
                                      fused_stem_b2=4)}

    def trainer(**kw):
        return Trainer(yspec, yparams, device=dev, compute_dtype=bf16,
                       **kw)

    first, peaks, launches_p = {}, {}, {}
    for name, kw in paths.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = trainer(**kw)
        reset_counts()
        losses = [float(tr.step(xy, ty)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / GiB
        got, want = counts(**{k: 3 * v for k, v in per_step[name].items()})
        assert got == want, (name, got)
        assert FS.paths == {"f2_row": got["fused_stem_f2"],
                            "b1_row": got["fused_stem_b1"],
                            "b2_row": got["fused_stem_b2"], "f2": 0,
                            "b1": 0, "b2": 0}, (name, FS.paths)
        assert not any(c["fp32_core"] for c in PT.conv_kernels.values())
        assert PT.bwdg_kernels["fp32_core"] == 0
        assert all(np.isfinite(losses)), (name, losses)
        first[name] = losses[0]
        ref = first["(d) bf16 + remat selective:2"]
        assert abs(losses[0] - ref) <= 0.03 * abs(ref) + 0.05, (
            name, losses[0], ref)
        launches_p[name] = got
        log(f"  Trainer {tag} {name} B={BATCH}, 3 steps: losses {losses}; "
            f"launches {dict((k, v) for k, v in got.items() if v)}; peak "
            f"device memory {peaks[name]:.2f} GiB "
            f"({time.perf_counter() - T0:.1f} s)")
        ips = step_rate(tr, xy, ty, 3)
        log(f"time Trainer.step {tag} {name} B={BATCH}: {ips} images/s, "
            f"{ips * step_flops / 1e12} TFLOP/s, MFU "
            f"{ips * step_flops / PEAK_OPS_S['bf16']} of the bf16 dense "
            f"peak [{gpu}]")
        seen = profile(f"Trainer.step {tag} {name} B={BATCH}, per step",
                       lambda: tr.step(xy, ty), 1, gpu, top=8)
        if "fused_stem" in name:
            assert_fused_stem_rows(name, seen)
        if "phase_train" in name:
            assert_bwdg_tensor_core(name, seen)
        if name.startswith("(a)"):
            # one step at another size through Trainer._step_for
            x_alt = torch.rand((BATCH, Y_ALT, Y_ALT, 3), generator=gx,
                               device=dev)
            reset_counts()
            l_alt = float(tr.step(x_alt, ty)["loss"])
            got_alt, want_alt = counts(**pair1)
            assert (Y_ALT, Y_ALT) in tr._steps and got_alt == want_alt, (
                got_alt)
            assert np.isfinite(l_alt), l_alt
            log(f"  {name} at {Y_ALT} through Trainer._step_for: loss "
                f"{l_alt}, launches "
                f"{dict((k, v) for k, v in got_alt.items() if v)}")
            del x_alt
        del tr
    # remat against no remat, for (a) (the pair's output is layer 1's,
    # which selective:2 saves: nothing is checkpointed) and (d) (layer 0
    # is checkpointed): the first loss and the parameters after one step
    # against the spread of two runs without remat; the peak memory
    # without remat
    for name, kw in (("(a)", dict(phase_train=True)), ("(d)", {})):
        runs = []
        for remat in (False, False, "selective:2"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = trainer(remat=remat, **kw)
            loss = float(tr.step(xy, ty)["loss"])
            flat = torch.cat([v.float().flatten() for p in tr.state.params
                              for _, v in sorted(p.items())])
            runs.append((loss, flat, torch.cuda.max_memory_allocated() / GiB))
            del tr
        (l1, p1, m1), (l2, p2, m2), (l3, p3, m3) = runs
        spread = (p1 - p2).abs().max().item()
        apart = (p3 - p1).abs().max().item()
        assert apart <= 2 * spread, (name, apart, spread)
        if name == "(a)":
            assert l3 == l1, (l3, l1)
        else:
            assert abs(l3 - l1) <= 2 * abs(l2 - l1), (l3, l1, l2)
        peaks[f"{name} without remat"] = max(m1, m2)
        log(f"  {name} remat selective:2 against none: first losses {l3} / "
            f"{l1}, {l2}; parameters after one step max |diff| {apart} "
            f"(two runs without remat: {spread}); peak device memory "
            f"{m3:.2f} GiB with remat, {max(m1, m2):.2f} GiB without")
        del runs, p1, p2, p3
    # phase_train="chain": the chain refuses layer 2 at Cin 32 and runs
    # the single pair
    torch.cuda.empty_cache()
    tr = trainer(phase_train="chain")
    reset_counts()
    float(tr.step(xy, ty)["loss"])
    got, want = counts(**pair1)
    assert got == want, got
    del tr
    torch.cuda.empty_cache()
    log(f"phase 27 ok: {tag} Trainer B={BATCH}, paths (a)-(d) 3 steps each "
        f"with the launch counts a step {per_step}; first losses within "
        f"0.03*|loss| + 0.05 of (d)'s {first['(d) bf16 + remat selective:2']}"
        f"; phase_train=\"chain\" ran the pair alone (no red, dy or dgrad); "
        f"peak device memory by path "
        f"{ {k: round(v, 2) for k, v in peaks.items()} } GiB [{gpu}]")

    # ---------------------------------------------------------- phase 28
    # `cli detector train -bf16` on the yolov2 cfg at its published
    # training batch (batch=64, subdivisions=8), 2 iterations on
    # synthetic PPMs; random=1 resizes to one of 320..608 at iteration 1
    g416 = np.load(GOLDEN / "yolo_coco_416.npz")
    cfg_text = bytes(g416["cfg"]).decode()
    WORK.mkdir(parents=True, exist_ok=True)
    ycfg = WORK / f"yolo-{Y_NET}-train.cfg"
    ycfg.write_text(train_cfg_text(cfg_text, size=Y_NET, batch=64,
                                   subdivisions=8, max_batches=2))
    lst = write_ppm_dataset(WORK / "coco-synth", 128, classes=80, seed=28)
    backup = WORK / "backup-yolo"
    data_cfg = WORK / "coco-synth.data"
    data_cfg.write_text(f"classes=80\ntrain={lst}\nbackup={backup}\n")
    final = backup / f"{ycfg.stem}_final.weights"
    final.unlink(missing_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.apps.cli",
         "detector", "train", str(data_cfg), str(ycfg), "-bf16"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    iters = [l for l in lines if l.split(":")[0] in ("1", "2")]
    resized = [l for l in lines if l.startswith("Resizing")]
    assert len(iters) == 2 and len(resized) == 1, res.stdout[-2000:]
    assert all(np.isfinite(float(l.split()[1].rstrip(","))) for l in iters)
    cspec = parse_network_cfg(str(ycfg))
    got_w, seen_w = load_weights(cspec, str(final))
    init_w = init_params(cspec, seed=0)
    assert seen_w == 2 * 64
    assert not np.allclose(got_w[0]["rolling_mean"],
                           init_w[0]["rolling_mean"])
    log(f"phase 28 ok: cli detector train -bf16 on {ycfg.name} (batch=64, "
        f"subdivisions=8) ran 2 iterations in "
        f"{time.perf_counter() - t0:.1f} s ({resized[0]}; "
        f"{' | '.join(iters)}); {final.name} loads, seen {seen_w}, layer "
        f"0's rolling statistics moved [{gpu}]")

    launches_k = {
        **{k: launches_p["(a) bf16 + phase_train + remat selective:2"][k]
           for k in ("phase_train_fwdstats", "phase_train_apply",
                     "phase_train_bwdg")},
        **{k: launches_p["(c) bf16 + fused_stem"][k]
           for k in ("fused_stem_f2", "fused_stem_b1", "fused_stem_b2")}}
    return train_entries(tag, times, bounds, errs, library, launches_k,
                         {"phase_train": f"3->32 @{Y_NET} B={BATCH}",
                          "fused_stem": f"layers 0, 2, 6, 10 B={BATCH}"})

N9_LOSS_BATCH = 8  # the tree loss's card-against-CPU batch (phase 32)
N9_AUG = dict(jitter=0.2, hue=0.1, saturation=1.5, exposure=1.5)  # the cfg's


def tree_truth(rng, b, n_map, n_nodes):
    """(b, 30, 5) truths for the WordTree loss: 1-4 boxes an item with
    mapped class ids (< n_map), two on one cell in item 0, a zero row
    before a truth the loss never reads in item 6, and classification-
    only truths (x, y > 100000, a raw node id past the map) in items 2
    and 5."""
    t = np.zeros((b, 30, 5), np.float32)
    for i in range(b):
        for k in range(1 + i % 4):
            t[i, k] = [rng.uniform(.05, .95), rng.uniform(.05, .95),
                       rng.uniform(.05, .5), rng.uniform(.05, .5),
                       rng.integers(0, n_map)]
    t[0, 1, :2] = t[0, 0, :2] + 0.001
    t[6, 4] = [0.5, 0.5, 0.2, 0.2, 7]
    t[2, 1] = [999999] * 4 + [rng.integers(n_map, n_nodes)]
    t[5, 0] = [999999] * 4 + [rng.integers(n_map, n_nodes)]
    return t


def yolo9000_416_train(gpu, dev, reset_counts, counts):
    """Phases 32-35 (the module docstring): yolo9000-416 training from
    disk. Returns the kernels line's entries for the pair's and the
    fused stem's kernels at yolo9000-416's training shapes."""
    from sr_object_detection_tpu_torch.config import read_map
    from sr_object_detection_tpu_torch.data import augment as A
    from sr_object_detection_tpu_torch.data import device_aug as DA
    from sr_object_detection_tpu_torch.data.loader import DetectionLoader
    from sr_object_detection_tpu_torch.data.packed import (
        PackedDetectionLoader, pack_detection_dataset)
    from sr_object_detection_tpu_torch.graph.compiler import resolve_trees
    from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
    from sr_object_detection_tpu_torch.infer.engine import analytic_flops
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, load_weights)
    from sr_object_detection_tpu_torch.kernels import fused_stem as FS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.ops.image import resize_image_np
    from sr_object_detection_tpu_torch.train import region_loss as RL
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    tag = f"yolo9000-{N9}"
    bf16 = torch.bfloat16
    GiB = 2 ** 30
    d, cfg, cmap, spec = yolo9000_files()
    region = spec.layers[-1]
    tree = RL.TreeInfo(resolve_trees(spec)[len(spec.layers) - 1])
    class_map = read_map(str(cmap))

    # ---------------------------------------------------------- phase 32
    # the tree region loss on the card against the same loss on the CPU
    # at full width, B=8, on a seeded head output
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(32)
    f = region.coords + 1 + region.classes
    g = torch.Generator().manual_seed(32)
    raw = 2.0 * torch.randn((N9_LOSS_BATCH, region.h * region.w * region.n
                             * f), generator=g)
    truth = torch.from_numpy(tree_truth(rng, N9_LOSS_BATCH, len(class_map),
                                        region.classes))
    sent = [(i, int(truth[i, k, 4])) for i in range(N9_LOSS_BATCH)
            for k in range(30) if truth[i, k, 0] > 100000]
    loss_errs = {}
    for classfix, thresh, seen in ((0, 0.6, 0), (2, 0.05, 20000)):
        rspec = dataclasses.replace(region, classfix=classfix, thresh=thresh)
        ca, cd, cs = RL.region_delta(raw, truth, seen, rspec, tree=tree,
                                     class_map=class_map)
        # the classification-only cell is a first maximum of objectness x
        # path prob: the card may take it only if it is no near tie
        acts = ca.reshape(N9_LOSS_BATCH, -1, f)
        gaps = []
        for i, c in sent:
            path = torch.from_numpy(tree.chain[c][tree.chain_valid[c]])
            score = acts[i, :, 4] * acts[i, :, 5:][:, path].prod(-1)
            top = score.topk(2).values
            gaps.append(float((top[0] - top[1]) / top[0]))
        assert min(gaps) > 1e-5, gaps
        torch.cuda.reset_peak_memory_stats()
        ga, gd, gs = RL.region_delta(raw.to(dev), truth.to(dev), seen, rspec,
                                     tree=tree, class_map=class_map)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / GiB
        scale = cd.abs().max().item()
        err = (gd.cpu() - cd).abs().max().item()
        assert err <= 1e-5 * scale, (classfix, err, scale)
        for k in cs:
            a, b = float(gs[k]), float(cs[k])
            assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (k, a, b)
        d1 = gd.cpu().reshape(N9_LOSS_BATCH, -1, f)
        for i, _ in sent:
            assert not d1[i, :, :5].any()
            assert int((d1[i, :, 5:].abs().sum(1) > 0).sum()) == 1
        loss_errs[classfix] = err / scale
        log(f"  {tag} tree region_delta classfix={classfix} B="
            f"{N9_LOSS_BATCH}: card against CPU max |err| {err} "
            f"({err / scale} of max |delta| {scale}); stats "
            f"{ {k: round(float(v), 6) for k, v in gs.items()} }; "
            f"classification-only items {sent}, top-2 score gaps "
            f"{[f'{v:.3g}' for v in gaps]}; peak device memory "
            f"{peak:.2f} GiB ({time.perf_counter() - T0:.1f} s)")
        del ca, cd, ga, gd, acts, d1
    golden_err = {name: check_train_golden(name, dev)
                  for name in sorted(TREE_TRAIN_GOLDENS)}
    log(f"phase 32 ok: {tag} tree region loss on the card within "
        f"{loss_errs} of max |delta| of the CPU's (gate 1e-5), stats within "
        f"1e-5; the float32 Trainer on CUDA reproduces "
        f"{sorted(TREE_TRAIN_GOLDENS)} (weights 2e-4, max relative cost "
        f"error {golden_err}) [{gpu}]")

    # ---------------------------------------------------------- phase 33
    # Trainer on yolo9000-416 at B=128 as one micro-batch (phase 27's
    # rule), 3 steps a path, each path's launches, peak device memory,
    # images/s and a profiled step with the loss's ranges
    yspec = dataclasses.replace(spec, net=dataclasses.replace(
        spec.net, batch=BATCH, subdivisions=1))
    yparams = init_params(yspec, seed=0)
    gx = torch.Generator(device=dev).manual_seed(33)
    xy = torch.rand((BATCH, N9, N9, 3), generator=gx, device=dev)
    ty = torch.from_numpy(tree_truth(rng, BATCH, len(class_map),
                                     region.classes)).to(dev)
    step_flops = 3 * analytic_flops(yspec)
    pair1 = dict(phase_train_fwdstats=1, phase_train_apply=1,
                 phase_train_bwdg=1)
    paths = {"(d) bf16": ({}, {}),
             "(a) bf16 + phase_train": (dict(phase_train=True), pair1),
             "(b) bf16 + phase_train + fused_stem": (
                 dict(phase_train=True, fused_stem=True),
                 dict(pair1, fused_stem_f2=4, fused_stem_b1=4,
                      fused_stem_b2=4))}
    first, peaks, launches_p = {}, {}, {}
    for name, (kw, per_step) in paths.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(yspec, yparams, device=dev, compute_dtype=bf16, **kw)
        reset_counts()
        losses = [float(tr.step(xy, ty)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / GiB
        got, want = counts(**{k: 3 * v for k, v in per_step.items()})
        assert got == want, (name, got)
        assert FS.paths == {"f2_row": got["fused_stem_f2"],
                            "b1_row": got["fused_stem_b1"],
                            "b2_row": got["fused_stem_b2"], "f2": 0,
                            "b1": 0, "b2": 0}, (name, FS.paths)
        assert not any(c["fp32_core"] for c in PT.conv_kernels.values())
        assert PT.bwdg_kernels["fp32_core"] == 0
        assert all(np.isfinite(losses)), (name, losses)
        first[name] = losses[0]
        ref = first["(d) bf16"]
        assert abs(losses[0] - ref) <= 0.03 * abs(ref) + 0.05, (
            name, losses[0], ref)
        launches_p[name] = got
        log(f"  Trainer {tag} {name} B={BATCH}, 3 steps: losses {losses}; "
            f"launches {dict((k, v) for k, v in got.items() if v)}; peak "
            f"device memory {peaks[name]:.2f} GiB "
            f"({time.perf_counter() - T0:.1f} s)")
        ips = step_rate(tr, xy, ty, 3)
        log(f"time Trainer.step {tag} {name} B={BATCH}: {ips} images/s, "
            f"{ips * step_flops / 1e12} TFLOP/s, MFU "
            f"{ips * step_flops / PEAK_OPS_S['bf16']} of the bf16 dense "
            f"peak [{gpu}]")
        seen = profile(f"Trainer.step {tag} {name} B={BATCH}, per step",
                       lambda: tr.step(xy, ty), 1, gpu, top=8,
                       ranges=("region_loss", "grouped_softmax"))
        if "fused_stem" in name:
            assert_fused_stem_rows(name, seen)
        if "phase_train" in name:
            assert_bwdg_tensor_core(name, seen)
        del tr
    del xy, ty
    torch.cuda.empty_cache()
    log(f"phase 33 ok: {tag} Trainer B={BATCH} (the tree loss, the map, "
        f"classification-only truths), paths (d), (a), (b) 3 steps each "
        f"with their launch counts a step; first losses within "
        f"0.03*|loss| + 0.05 of (d)'s {first['(d) bf16']}; peak device "
        f"memory by path { {k: round(v, 2) for k, v in peaks.items()} } "
        f"GiB [{gpu}]")

    # ---------------------------------------------------------- phase 34
    # the pair and F2/B1/B2 at yolo9000-416's training shapes: the pair
    # 3 -> 32 @416, the fused stem at the layers Network.fusable picks
    stem_layers = ((0, N9, 32), (2, N9 // 2, 64), (6, N9 // 4, 128),
                   (10, N9 // 8, 256), (16, N9 // 16, 512))
    times, bounds, errs, library = train_kernels_at(
        tag, N9, stem_layers, 32, 34, gpu, dev)
    log(f"phase 34 ok: {tag} training kernels == plain: the pair 3->32 at "
        f"{N9} B={BATCH} (fwdstats on the taps fold, bwdg on the tensor "
        f"cores, two launches of each bit-equal), F2, B1, B2 at layers "
        f"{[l for l, _, _ in stem_layers]} on the row kernels (max |err| "
        f"{ {k: v for k, v in errs.items()} }) [{gpu}]")

    # ---------------------------------------------------------- phase 35
    # the data path: device augmentation against the host pipeline, its
    # rate at B=128 @416 from 500x375 u8 frames; the packed loader's
    # rates; the CLI from a packed set; the thread and process decoders
    torch.cuda.empty_cache()
    rng = np.random.default_rng(35)
    frames = [rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
              for _ in range(BATCH)]
    params = [DA.draw_params(rng, 375, 500, **N9_AUG)[0] for _ in frames]
    aug = DA.DeviceAugmenter(N9, N9, device=dev)
    canvas, cols = DA.stack_batch(aug, frames, params)
    out = aug(canvas, cols).cpu().numpy()
    aug_err = 0.0
    for b in range(8):
        p = params[b]
        want = resize_image_np(A.crop_image(
            frames[b].astype(np.float32) / 255.0, p["pleft"], p["ptop"],
            p["swidth"], p["sheight"]), N9, N9)
        if p["flip"]:
            want = A.flip_horizontal(want)
        if p["do_distort"]:
            want = A.distort_image(want, p["dhue"], p["dsat"], p["dexp"])
        aug_err = max(aug_err, float(np.abs(out[b] - want).max()))
    assert aug_err <= 2e-6, aug_err
    canvas_d, cols_d = aug.upload(canvas, cols)
    dev_ms = cuda_ms(lambda: DA.augment_batch(canvas_d, cols_d), 10, 2)
    bf_ms = cuda_ms(lambda: DA.augment_batch(canvas_d, cols_d,
                                             out_dtype=bf16), 10, 2)
    up_ms = cuda_ms(lambda: aug(canvas, cols), 5, 1)
    log(f"time DeviceAugmenter B={BATCH} {N9}x{N9} from 500x375 u8: "
        f"{dev_ms} ms on the device ({BATCH / dev_ms * 1e3} images/s; bf16 "
        f"out {bf_ms} ms, {BATCH / bf_ms * 1e3} images/s); with the "
        f"canvas's upload from the host {up_ms} ms "
        f"({BATCH / up_ms * 1e3} images/s) [{gpu}]")
    del canvas_d, cols_d, out, frames
    # the packed loader over a packed set written from a seed
    lst = write_ppm_dataset(WORK / "y9k-synth", 2 * BATCH, classes=80,
                            seed=35)
    prefix = str(WORK / "y9k-packed")
    t0 = time.perf_counter()
    pack_detection_dataset(lst, prefix, store_w=448, store_h=448, quiet=True)
    pack_s = time.perf_counter() - t0
    kw = dict(w=N9, h=N9, batch=BATCH, device=dev, out_dtype=bf16, **N9_AUG)
    host = PackedDetectionLoader(prefix, **kw)
    x, t = host.next_batch()
    torch.cuda.synchronize()
    assert x.shape == (BATCH, N9, N9, 3) and x.dtype == bf16 and x.is_cuda
    assert 0 <= float(x.min()) and float(x.max()) <= 1 and (
        t[:, 0, 2] > 0).any()
    host._pending.result()          # the prefetch thread idle from here
    t0 = time.perf_counter()
    for _ in range(5):
        host._host_batch_cpu()
    host_bps = 5 / (time.perf_counter() - t0)
    host.close()
    loader = PackedDetectionLoader(prefix, **kw)
    loader.next_batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        x, _ = loader.next_batch()
    torch.cuda.synchronize()
    card_bps = 5 / (time.perf_counter() - t0)
    loader.close()
    del x
    log(f"time PackedDetectionLoader B={BATCH} {N9}x{N9} from 448x448 "
        f"records (packed {2 * BATCH} 500x375 PPMs in {pack_s:.2f} s): host "
        f"side alone (_host_batch_cpu) {host_bps} batches/s "
        f"({host_bps * BATCH} images/s); to the card, bf16 "
        f"{card_bps} batches/s ({card_bps * BATCH} images/s) [{gpu}]")
    # the thread and the process decoders, one batch each on the same
    # frames and seed: equal batches
    batches, dec_s = {}, {}
    for decoder in ("thread", "process"):
        t0 = time.perf_counter()
        ld = DetectionLoader(lst, w=N9, h=N9, batch=32, classes=80, seed=35,
                             workers=4, device_augment=True, decoder=decoder,
                             device=dev, **N9_AUG)
        batches[decoder] = ld.next_batch()
        torch.cuda.synchronize()
        dec_s[decoder] = time.perf_counter() - t0
        ld.close()
    assert torch.equal(batches["thread"][0], batches["process"][0])
    np.testing.assert_array_equal(batches["thread"][1],
                                  batches["process"][1])
    log(f"  DetectionLoader device_augment, 32 frames: the thread and the "
        f"process decoders give equal batches; first batch "
        f"{ {k: round(v, 2) for k, v in dec_s.items()} } s (the process "
        f"pool's start included) [{gpu}]")
    del batches
    # `cli detector train -packed -device-aug -bf16` on the yolo9000 cfg
    # at batch=64, subdivisions=8: 2 iterations from the packed set
    ycfg = d / "yolo9000-train.cfg"
    ycfg.write_text(train_cfg_text(cfg.read_text(), batch=64,
                                   subdivisions=8, max_batches=2))
    backup = WORK / "backup-yolo9000"
    data_cfg = WORK / "y9k-synth.data"
    data_cfg.write_text(f"classes=80\ntrain={lst}\nbackup={backup}\n")
    final = backup / f"{ycfg.stem}_final.weights"
    final.unlink(missing_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.apps.cli",
         "detector", "train", str(data_cfg), str(ycfg), "-packed", prefix,
         "-device-aug", "-bf16"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    iters = [l for l in res.stdout.splitlines()
             if l.split(":")[0] in ("1", "2")]
    assert len(iters) == 2, res.stdout[-2000:]
    assert all(np.isfinite(float(l.split()[1].rstrip(","))) for l in iters)
    got_w, seen_w = load_weights(parse_network_cfg(str(ycfg)), str(final))
    assert seen_w == 2 * 64
    assert not np.allclose(got_w[0]["rolling_mean"],
                           yparams[0]["rolling_mean"])
    log(f"phase 35 ok: DeviceAugmenter on the card within {aug_err} of the "
        f"host pipeline (gate 2e-6); packed loader, decoders; cli detector "
        f"train -packed -device-aug -bf16 on {ycfg.name} (batch=64, "
        f"subdivisions=8) ran 2 iterations in "
        f"{time.perf_counter() - t0:.1f} s ({' | '.join(iters)}); "
        f"{final.name} loads, seen {seen_w}, layer 0's rolling statistics "
        f"moved [{gpu}]")

    launches_k = {
        **{k: launches_p["(a) bf16 + phase_train"][k]
           for k in ("phase_train_fwdstats", "phase_train_apply",
                     "phase_train_bwdg")},
        **{k: launches_p["(b) bf16 + phase_train + fused_stem"][k]
           for k in ("fused_stem_f2", "fused_stem_b1", "fused_stem_b2")}}
    return train_entries(tag, times, bounds, errs, library, launches_k,
                         {"phase_train": f"3->32 @{N9} B={BATCH}",
                          "fused_stem": f"layers 0, 2, 6, 10, 16 B={BATCH}"})


APPS_NMS = 0.45     # detector valid's NMS threshold (detector.c:246)
APPS_THRESH = 0.005  # detector valid's prob threshold (detector.c:245)


def seeded_net(name):
    """(cfg, weights, spec) of one of the three nets with the seeded
    weights the serving phases use (phases 3, 22 and 29: random weights
    from seed 0, BN statistics and biases randomized, the head scaled),
    written under WORK where a phase has not written them already."""
    from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, save_weights)
    WORK.mkdir(parents=True, exist_ok=True)
    if name == "yolo9000":
        d, cfg, _, spec = yolo9000_files()
        weights, gain = d / "yolo9000.weights", N9_HEAD_GAIN
    else:
        text = {"tiny": GOLDEN / "detect_tiny_yolo.npz",
                "yolov2": GOLDEN / "yolo_coco_416.npz"}[name]
        text = bytes(np.load(text)["cfg"]).decode()
        size = NET if name == "tiny" else Y_NET
        cfg = WORK / ("tiny-yolo-voc.cfg" if name == "tiny"
                      else f"yolo-{size}.cfg")
        cfg.write_text(text.replace("width=416", f"width={size}")
                       .replace("height=416", f"height={size}"))
        spec = parse_network_cfg(str(cfg))
        weights = WORK / ("random.weights" if name == "tiny"
                          else f"yolo-{size}.weights")
        gain = 8.0 if name == "tiny" else 16.0
    if not weights.exists():
        save_weights(spec, random_bn(init_params(spec, seed=0), 1,
                                     head_gain=gain), str(weights))
    return str(cfg), str(weights), spec


def quiet(fn, *args):
    """fn(*args) with its standard output kept: (result, the text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, buf.getvalue()


def comp4_dets(outdir):
    """comp4 files -> [((image id, class file), prob, corners)]."""
    out = []
    for f in sorted(pathlib.Path(outdir).glob("comp4_det_test_*.txt")):
        for line in f.read_text().splitlines():
            p = line.split()
            out.append(((p[0], f.name), float(p[1]),
                        np.asarray(p[2:6], np.float64)))
    return out


def detector_apps(gpu, dev, reset_counts, counts):
    """Phases 36-39 (the module docstring): exact NMS at k = N, `detector
    valid`, the robot loop and `detector demo`. Returns the kernels line's
    entries of the NMS kernel at the exact widths."""
    import resource
    from sr_object_detection_tpu_torch.apps import cli
    from sr_object_detection_tpu_torch.eval import reval_voc
    from sr_object_detection_tpu_torch.infer.detector import Detector
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.ops import boxes as B
    from sr_object_detection_tpu_torch.robot import native
    from sr_object_detection_tpu_torch.robot.frame_source import (
        SyntheticRGBDSource)
    from sr_object_detection_tpu_torch.robot.pipeline import RobotPerception
    from tools.synth_dataset import N_CLASSES, make_dataset

    # ---------------------------------------------------------- phase 36
    torch.cuda.empty_cache()
    rng = np.random.default_rng(36)
    nets = {"tiny": f"tiny-yolo-voc-{NET}", "yolov2": f"yolov2-{Y_NET}",
            "yolo9000": f"yolo9000-{N9}"}
    files = {name: seeded_net(name) for name in nets}
    valid_dir = WORK / "valid-frames"
    valid_list = write_ppm_dataset(valid_dir, 8, seed=36)
    valid_paths = open(valid_list).read().split()
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    frame = load_image_rgb(valid_paths[0])
    times, bounds, errs, shapes = {}, {}, {}, {}
    for name, tag in nets.items():
        cfg, weights, spec = files[name]
        det = Detector(cfg, weights, device=dev)
        fb, fp = det.predict_batch(det.preprocess(frame)[None],
                                   thresh=APPS_THRESH)
        n, c = fp.shape[1:]
        tb, tp, _ = B.topk_candidates(fb[0], fp[0], n)
        gen = torch.Generator(device=dev).manual_seed(36)
        live = torch.sort(torch.rand((c, n), generator=gen, device=dev)
                          + 0.01, dim=1, descending=True).values
        for case, p in (("a valid frame's candidates", tp),
                        ("every rank live", live)):
            got = NMS.nms_per_class(tb, p, APPS_NMS)
            again = NMS.nms_per_class(tb, p, APPS_NMS)
            ref = B.nms_per_class_plain(tb, p, APPS_NMS)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), (
                tag, case)
            assert torch.equal(got.view(torch.int32),
                               again.view(torch.int32)), (tag, case)
            if p is tp:
                errs[name] = (got - ref).abs().max().item()
            log(f"  {tag} C={c} k={n}, {case}: {int((p > 0).sum())} live "
                f"candidates in {int((p[:, 0] > 0).sum())} classes, "
                f"{int((got > 0).sum())} kept; kernel torch.equal to the "
                f"plain version, two launches bit-equal")
        live_ms = graph_ms(lambda: NMS.nms_per_class(tb, live, APPS_NMS), 5)
        log(f"time nms_per_class exact {tag} C={c} k={n}, every rank live, "
            f"from a CUDA graph: {live_ms} ms; bound "
            f"{nms_bound(tb, live)[0]} ms by {nms_bound(tb, live)[1]} "
            f"[{gpu}]")
        shapes[name] = (c, n)
        # times: the kernel from a CUDA graph, in turns with the plain
        # version (CUDA events; it reads the live classes back, so no
        # graph), beside the bound and the launch floor
        p1 = cuda_ms(lambda: B.nms_per_class_plain(tb, tp, APPS_NMS), 3, 1)
        k1 = graph_ms(lambda: NMS.nms_per_class(tb, tp, APPS_NMS), 20)
        k2 = graph_ms(lambda: NMS.nms_per_class(tb, tp, APPS_NMS), 20)
        p2 = cuda_ms(lambda: B.nms_per_class_plain(tb, tp, APPS_NMS), 3, 1)
        floor = graph_ms(lambda: NMS.empty_launch(c, n, dev), 20)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        bounds[name] = nms_bound(tb, tp)
        log(f"time nms_per_class exact {tag} C={c} k={n} (a valid frame's "
            f"candidates): kernel from a CUDA graph {times[name][0]} ms "
            f"({k1}, {k2}), plain {times[name][1]} ms ({p1}, {p2}); bound "
            f"{bounds[name][0]} ms by {bounds[name][1]}; launch floor "
            f"{floor} ms [{gpu}]")
        del det, fb, fp, tb, tp, live
        torch.cuda.empty_cache()
    log(f"phase 36 ok: the NMS kernel at k = N torch.equal to the plain "
        f"version at (C, k) = {list(shapes.values())} on valid "
        f"frames' candidates and with every rank live [{gpu}]")

    # ---------------------------------------------------------- phase 37
    # the map_ab model over its seeded frames: comp4 files from the card
    # and from the CPU, re-scored by the port's reval_voc against voc_map
    g = np.load(GOLDEN / "map_ab.npz")
    ab_list, gt = make_dataset(str(WORK / "map_ab"), int(g["n_images"]),
                               int(g["seed"]))
    ab_dir = pathlib.Path(ab_list).parent
    (WORK / "map_ab.cfg").write_text(bytes(g["cfg"]).decode())
    (WORK / "map_ab.weights").write_bytes(bytes(g["weights"]))
    names = WORK / "map_ab.names"
    names.write_text("".join(f"{c}\n" for c in range(N_CLASSES)))
    ab_data = WORK / "map_ab.data"
    ab_data.write_text(f"classes = {N_CLASSES}\nvalid = {ab_list}\n"
                       f"names = {names}\n")
    ab_thresh, ab_nms = float(g["thresh"]), float(g["nms"])
    out = {}
    for where, extra in (("card", []), ("cpu", ["-cpu"])):
        out[where] = WORK / f"valid-map_ab-{where}"
        t0 = time.perf_counter()
        assert quiet(cli.main, ["detector", "valid", str(ab_data),
                                str(WORK / "map_ab.cfg"),
                                str(WORK / "map_ab.weights"), "-outdir",
                                str(out[where]), "-thresh", str(ab_thresh),
                                "-nms", str(ab_nms)] + extra)[0] == 0
        log(f"  detector valid on map_ab ({where}): "
            f"{time.perf_counter() - t0:.2f} s for "
            f"{int(g['n_images'])} images")
    got, want = comp4_dets(out["card"]), comp4_dets(out["cpu"])
    n_lines = match_dets(got, want, ab_thresh, 1e-4)
    m_reval = {}
    for where in out:
        m_reval[where], text = quiet(reval_voc.main, [
            str(out[where]), "--classes", str(names), "--labels",
            str(ab_dir), "--image-list", ab_list])
        assert "Mean AP" in text
    m_card, m_cpu = m_reval["card"], m_reval["cpu"]
    m_ref = voc_map(Detector(str(WORK / "map_ab.cfg"),
                             str(WORK / "map_ab.weights"), device=dev),
                    open(ab_list).read().split(), gt, ab_thresh, ab_nms)
    # card against CPU compares two device paths; card against voc_map
    # runs the same mean_ap and NMS kernel, so it only shows that
    # reval_voc reads its files back
    assert m_card > 0.2 and abs(m_card - m_cpu) <= 1e-3, (m_card, m_cpu)
    assert abs(m_card - m_ref) <= 1e-3, (m_card, m_ref)
    log(f"  map_ab: {len(got)} comp4 lines from the card, {len(want)} from "
        f"the CPU, {n_lines} matched det for det; reval_voc mAP from the "
        f"card's files {m_card}, from the CPU's {m_cpu} (the device "
        f"check); voc_map on the card {m_ref} (reval_voc reads its files)")
    # the three nets over 8 (tiny) and 2 frames, counted: one NMS launch
    # an image (yolo9000's 9,418 comp4 files need as many descriptors)
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < N9_CLASSES + 256:
        resource.setrlimit(resource.RLIMIT_NOFILE,
                           (min(hard, 4 * N9_CLASSES), hard))
    launches_valid = {}
    for name, tag in nets.items():
        cfg, weights, _ = files[name]
        n_img = 8 if name == "tiny" else 2
        lst = WORK / f"valid-{name}.list"
        lst.write_text("\n".join(valid_paths[:n_img]) + "\n")
        data = WORK / f"valid-{name}.data"
        data.write_text(f"valid = {lst}\n")
        reset_counts()
        t0 = time.perf_counter()
        assert quiet(cli.main, ["detector", "valid", str(data), cfg, weights,
                                "-outdir", str(WORK / f"valid-{name}")])[
            0] == 0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, want_l = counts(nms_per_class=n_img)
        assert launches == want_l, (tag, launches)
        launches_valid[name] = launches["nms_per_class"]
        lines = sum(len(f.read_text().splitlines()) for f in
                    (WORK / f"valid-{name}").glob("comp4_det_test_*.txt"))
        log(f"  detector valid {tag}: {n_img} images, {lines} comp4 lines, "
            f"NMS launches {launches['nms_per_class']}, "
            f"{wall:.2f} s wall (Detector load included) [{gpu}]")
    log(f"phase 37 ok: detector valid through cli.main; map_ab's card and "
        f"CPU comp4 lines matched, the card's reval_voc mAP within 1e-3 of "
        f"the CPU run's and of voc_map; "
        f"one exact-NMS launch an image at the three nets [{gpu}]")

    # ---------------------------------------------------------- phase 38
    cfg, weights, _ = files["tiny"]
    built = native._LIB_PATH.exists()
    t0 = time.perf_counter()
    native.lib()
    log(f"  native library {native._LIB_PATH.relative_to(ROOT)}: "
        f"{'found' if built else 'built'} and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    runs = {}
    for where, extra in (("card", []), ("cpu", ["-cpu"])):
        ipc = WORK / f"robot-{where}.jsonl"
        ipc.unlink(missing_ok=True)
        reset_counts()
        runs[where], text = quiet(cli.COMMANDS["robot"], [
            "run", cfg, weights, "-frames", "30", "-detect-every", "2",
            "-ipc", str(ipc), "-faces",
            "-nl", str(WORK / f"robot-{where}.txt")] + extra)
        torch.cuda.synchronize()
        assert text.count("frame ") == 30, text[-2000:]
        if where == "card":
            launches, want_l = counts(nms_per_class=15)
            assert launches == want_l, launches
    n_dets = 0
    for a, b in zip(runs["card"], runs["cpu"]):
        assert a["sentence"] == b["sentence"], (a["sentence"], b["sentence"])
        assert a["faces"] == b["faces"]
        assert [d["class_id"] for d in a["detections"]] == [
            d["class_id"] for d in b["detections"]]
        n_dets += match_dets(*([(d["class_id"], d["prob"],
                                 np.asarray(d["box"])) for d in r[
                                     "detections"]] for r in (a, b)),
                             0.24, 1e-4, require=False)
    assert len(runs["card"]) == len(runs["cpu"]) == 30
    # per-frame wall time of the loop on the card, then one profile
    pipe = RobotPerception(Detector(cfg, weights, device=dev),
                           detect_every=2, nl_path=str(WORK / "robot.txt"))
    frames = list(SyntheticRGBDSource(n_frames=40))
    walls = []
    for f in frames[:30]:
        t0 = time.perf_counter()
        pipe.process(f)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    detect_walls = walls[::2]
    it = iter(frames[30:] * 2)
    profile("robot loop per frame (tiny-yolo-voc-416, detect every 2nd "
            "frame)", lambda: pipe.process(next(it)), 10, gpu)
    log(f"time robot loop tiny-yolo-voc-{NET} per frame (512x424 RGB-D, "
        f"detect every 2nd frame, 30 frames): median "
        f"{np.median(walls)} ms, p99 {np.percentile(walls, 99)} ms; detect "
        f"frames median {np.median(detect_walls)} ms [{gpu}]")
    log(f"phase 38 ok: cli robot run, 30 frames, NMS launches 15, sentences "
        f"{runs['card'][-1]['sentence']!r} ...; every frame's sentence and "
        f"faces equal to the CPU run's, {n_dets} detections matched [{gpu}]")

    # ---------------------------------------------------------- phase 39
    demo_dir = WORK / "demo-frames"
    demo_dir.mkdir(parents=True, exist_ok=True)
    drng = np.random.default_rng(39)
    for i in range(10):
        img = drng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        (demo_dir / f"{i:03d}.ppm").write_bytes(
            b"P6\n640 480\n255\n" + img.tobytes())
    det_cpu = Detector(cfg, weights, device="cpu")
    _, p0 = det_cpu.predict_batch(det_cpu.preprocess(load_image_rgb(
        str(demo_dir / "000.ppm")))[None])
    thresh = float(np.sort(p0[0].max(-1).values.numpy())[::-1][10])
    demos = {}
    for where, extra in (("card", []), ("cpu", ["-cpu"])):
        outdir = WORK / f"demo-{where}"
        outdir.mkdir(exist_ok=True)
        reset_counts()
        demos[where], text = quiet(cli.COMMANDS["detector"], [
            "demo", "unused.data", cfg, weights, "-frames",
            str(demo_dir / "*.ppm"), "-thresh", str(thresh), "-outdir",
            str(outdir)] + extra)
        torch.cuda.synchronize()
        fps_lines = [l for l in text.splitlines() if l.startswith("FPS:")]
        assert len(fps_lines) == 10, text[-2000:]
        log(f"  detector demo ({where}), the CLI's last line: "
            f"{fps_lines[-1][:120]}")
        if where == "card":
            launches, want_l = counts(nms_per_class=10)
            assert launches == want_l, launches
        assert len(list(outdir.glob("demo_*.ppm"))) == 10
    n_demo = 0
    for a, b in zip(demos["card"], demos["cpu"]):
        n_demo += match_dets(*([(d.class_id, d.prob, np.asarray(d.box))
                                for d in r["detections"]] for r in (a, b)),
                             thresh, 1e-4, require=False)
    assert n_demo > 0 and len(demos["card"]) == 10
    log(f"phase 39 ok: detector demo -frames over 10 seeded 640x480 PPMs "
        f"with -outdir: {n_demo} detections matched the CPU demo's, NMS "
        f"launches 10; FPS {demos['card'][-1]['fps']} (card), "
        f"{demos['cpu'][-1]['fps']} (CPU) [{gpu}]")

    return [{"name": f"nms_per_class (detector valid, exact NMS: "
                     f"{nets[name]} C={shapes[name][0]} "
                     f"k={shapes[name][1]})",
             "route": "cuda", "source": "sr_object_detection_tpu_torch/csrc/"
                                        "nms.cu",
             "replaces": "sr_object_detection_tpu/kernels/nms_pallas.py:29",
             "launches": launches_valid[name], "max_abs_err": errs[name],
             "ms": times[name][0], "plain_ms": times[name][1],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
             "library_ms": None}
            for name in nets]


D19 = 224          # darknet19's published width and height (cfg/darknet19.cfg)
D19_PAIRS = [(0, 1), (2, 3)]  # its stem pairs: 3 -> 32 @224, 32 -> 64 @112
D19_HEAD_GAIN = 32.0  # the 1x1 head's scale: the 1000 probs spread
D19_MINI = ["mini_connected", "mini_lrn", "mini_crop", "mini_local",
            "mini_deconv", "mini_xnor", "mini_tree_cls"]
D19_RTOL = 1e-4    # float32 probs, card against CPU (sums in other orders)
D19_INT8_RTOL = 2.0 ** -6  # int8 probs, card against CPU, of the top prob


def top_lines(text):
    """`name: prob` lines of the classifier CLI -> [(name, prob)]."""
    out = []
    for line in text.splitlines():
        name, _, p = line.rpartition(": ")
        if name:
            out.append((name, float(p)))
    return out


def match_top(a, b, band):
    """Two top-k lists [(name, prob)] alike: every entry of either list
    whose prob lies more than ``band`` above the list's lowest has one of
    the same name in the other list within ``band`` (entries within the
    band of the cut may fall either side of it). Returns how many were
    matched (at least one) and the largest |diff| among them."""
    n, diff = 0, 0.0
    for x, y in ((a, b), (b, a)):
        low = min(p for _, p in x)
        for name, p in x:
            if p > low + band:
                n += 1
                d = min((abs(p2 - p) for n2, p2 in y if n2 == name),
                        default=np.inf)
                assert d <= band, (name, p, y)
                diff = max(diff, d)
    assert n > 0
    return n, diff


def darknet19_224(gpu, dev, reset_counts, counts):
    """Phases 40-43 (the module docstring): darknet19-224 serving, the
    classifier family. Returns the kernels line's entries for the three
    stems on this path, at darknet19-224's shapes."""
    from sr_object_detection_tpu_torch.apps import cli
    from sr_object_detection_tpu_torch.config import parse_cfg_text
    from sr_object_detection_tpu_torch.graph import spec as S
    from sr_object_detection_tpu_torch.graph.compiler import Network
    from sr_object_detection_tpu_torch.infer.classifier import Classifier
    from sr_object_detection_tpu_torch.infer.engine import (
        LatencyEngine, ThroughputEngine)
    from sr_object_detection_tpu_torch.infer.quant import (
        QuantizedThroughputEngine, _supported_prefix)
    from sr_object_detection_tpu_torch.io.convert import params_to_torch
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, save_weights)
    from sr_object_detection_tpu_torch.kernels import b1_stem as BS
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.models.zoo import darknet19
    from sr_object_detection_tpu_torch.ops.layout import nhwc_to_flat
    from tools.synth_dataset import write_ppm

    # ---------------------------------------------------------- phase 40
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(40)
    bf16 = torch.bfloat16
    tag = f"darknet19-{D19}"
    WORK.mkdir(parents=True, exist_ok=True)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    # the remaining layer kinds: the C-oracle goldens on the card
    golden_err = {}
    for name in D19_MINI:
        g = np.load(GOLDEN / f"{name}.npz")
        text = bytes(g["cfg"]).decode()
        if "tree" in g.files:
            tree = WORK / "mini.tree"
            tree.write_text(bytes(g["tree"]).decode())
            text = text.replace("{TREE}", str(tree))
        gspec = S.build_network_spec(parse_cfg_text(text))
        params = init_params(gspec, seed=int(g["seed"]))
        if "bias_seed" in g.files and int(g["bias_seed"]) >= 0:
            brng = np.random.default_rng(int(g["bias_seed"]))
            for p in params:
                if p and "biases" in p:
                    p["biases"] = brng.normal(
                        0, 0.5, np.shape(p["biases"])).astype(np.float32)
        net = Network(gspec, params_to_torch(gspec, params, dev))
        x = torch.from_numpy(np.transpose(g["input_chw"], (1, 2, 0))[None]
                             .copy()).to(dev)
        with torch.no_grad():
            out, aux = net(x, keep_all=True)
        got = [("output", out)] + [
            (f"layer_{i}", aux["outputs"][i])
            for i in range(len(gspec.layers)) if f"layer_{i}" in g.files]
        err = 0.0
        for key, t in got:
            t = t.float().cpu()
            t = (nhwc_to_flat(t) if t.ndim == 4 else t)[0].numpy()
            assert np.allclose(t, g[key], rtol=2e-5, atol=2e-5), (name, key)
            err = max(err, float(np.abs(t - g[key]).max()))
        golden_err[name] = err
    # darknet19-224 (cfg/darknet19.cfg from models/zoo.py, 1000 classes;
    # random weights from seed 0 with randomized BN and biases, the head
    # scaled so that the probs spread, written as a .weights file): the
    # float32 Classifier on the card against the same on the CPU
    cfg = WORK / "darknet19.cfg"
    cfg.write_text(zoo_cfg_text(darknet19, width=D19, height=D19))
    spec = S.parse_network_cfg(str(cfg))
    assert spec.layers == darknet19(width=D19, height=D19).layers
    params_np = random_bn(init_params(spec, seed=0), 1,
                          head_gain=D19_HEAD_GAIN)
    weights = WORK / "darknet19.weights"
    save_weights(spec, params_np, str(weights))
    clf = Classifier(str(cfg), str(weights), device=dev)
    clf_cpu = Classifier(str(cfg), str(weights), device="cpu")
    frames = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
              for h, w in ((224, 224), (375, 500), (480, 360))]
    cls_err, n_top, p_max = 0.0, 0, 0.0
    for f in frames:
        p, q = clf.predict(f), clf_cpu.predict(f)
        assert p.shape == (1000,) and np.isfinite(p).all()
        assert abs(float(p.sum()) - 1.0) < 1e-4
        assert np.allclose(p, q, rtol=D19_RTOL, atol=1e-7)
        cls_err = max(cls_err, float(np.abs(p - q).max()))
        p_max = max(p_max, float(q.max()))
        # top-5 in the same order wherever a prob's neighbours lie more
        # than the tolerance away
        sq = np.sort(q)[::-1][:6]
        tol = 2 * D19_RTOL * sq[0] + 2e-7
        for k, (i, j) in enumerate(zip(np.argsort(-p)[:5],
                                       np.argsort(-q)[:5])):
            if (k == 0 or sq[k - 1] - sq[k] > tol) and sq[k] - sq[k + 1] > tol:
                assert i == j, (k, i, j)
                n_top += 1
    assert n_top > 0
    log(f"phase 40 ok: the remaining layer kinds on CUDA (TF32 off): the "
        f"seven mini goldens at 2e-5 (max |err| {golden_err}); {tag} "
        f"Classifier float32 on CUDA against the CPU over {len(frames)} "
        f"frames: probs within rtol {D19_RTOL} (max |diff| {cls_err}, top "
        f"prob {p_max}), {n_top} top-5 ranks equal where not tied [{gpu}]")

    # ---------------------------------------------------------- phase 41
    bf = ThroughputEngine(spec, params_np, batch=BATCH, device=dev)
    bf_stem = ThroughputEngine(spec, params_np, batch=BATCH, device=dev,
                               phase_stem=True)
    calib = rng.uniform(0, 1, (4, D19, D19, 3)).astype(np.float32)
    q_stem = QuantizedThroughputEngine(spec, params_np, batch=BATCH,
                                       device=dev, calib_x=calib,
                                       phase_stem=True)
    q_plain = QuantizedThroughputEngine(spec, params_np, batch=BATCH,
                                        device=dev, calib_x=calib)
    assert bf_stem.phase_stem
    assert PS.plan_pairs(q_stem.qnet.spec) == D19_PAIRS
    assert BS.plan_pairs(bf_stem.spec) == D19_PAIRS
    split = _supported_prefix(q_stem.qnet.spec.layers)
    assert [l.kind for l in spec.layers[split:]] == ["avgpool", "softmax",
                                                     "cost"]
    lat_f = LatencyEngine(spec, params_np, device=dev, fused_stem=True)
    lat_p = LatencyEngine(spec, params_np, device=dev)
    assert lat_f.fused_stem and not lat_p.fused_stem
    assert lat_f.region is None and lat_p.region is None
    frames_u8 = torch.from_numpy(rng.integers(
        0, 256, (BATCH, D19, D19, 3), dtype=np.uint8)).to(dev)
    x_b = frames_u8.float() / 255.0
    x1 = torch.from_numpy(rng.uniform(0, 1, (1, D19, D19, 3)).astype(
        np.float32)).to(dev, bf16)
    sk = check_serving_kernels(spec, D19_PAIRS, bf_stem, q_stem, lat_f,
                               frames_u8, x1, {"taps": 1, "tap_pairs": 0,
                                               "chunks": 1})
    # the main path, counted: the Classifier, the two LatencyEngines on
    # u8 frames and the four batch-128 engines
    u8 = [rng.integers(0, 256, (D19, D19, 3), dtype=np.uint8)
          for _ in range(3)]
    reset_counts()
    probs = [clf.predict(f) for f in frames]
    lat_out = [(lat_f(f), lat_p(f)) for f in u8]
    out_bf = bf(x_b)
    out_bfs = bf_stem(x_b)
    out_s = q_stem(frames_u8)
    out_p = q_plain(frames_u8)
    torch.cuda.synchronize()
    launches_d, want = counts(stem_pair=6, phase_stem_pair=2,
                              phase_train_fwd=2)
    log(f"  {tag} main path: launches {launches_d} "
        f"({time.perf_counter() - T0:.1f} s)")
    assert launches_d == want, launches_d
    assert all(np.isfinite(p).all() for p in probs)
    for o, dt in ((out_bf, bf16), (out_bfs, bf16), (out_s, torch.float32),
                  (out_p, torch.float32)):
        assert o.shape == (BATCH, 1000) and o.dtype == dt, (o.shape, o.dtype)
        assert torch.isfinite(o.float()).all()
        assert (o.float().sum(dim=1) - 1).abs().max().item() < 2e-2
    # the bf16 batch: the phase stem link by link within
    # assert_stem_link_close of the plain engine's conv + pool layers
    stem_link_err = 0.0
    for l, xi, w_hwio, bias in sk["fwd_links"]:
        got = PT.fwd_pair(xi, w_hwio, bias)
        with torch.no_grad():
            ref = bf._net.layers[l.index + 1](bf._net.layers[l.index](
                xi.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        zero = torch.zeros(bias.shape[0], device=dev)
        z, _, _ = PT.fwdstats(xi, w_hwio, zero, torch.ones_like(zero))
        stem_link_err = max(stem_link_err, assert_stem_link_close(
            got.float().cpu().numpy(), ref.float().cpu().numpy(),
            z.float().cpu().numpy()))
        del got, ref, z
        torch.cuda.empty_cache()
    bfs_diff = (out_bfs.float() - out_bf.float()).abs().max().item()
    # the int8 trunk with and without the phase stem, and the float tail
    # (the bf16 1x1 head conv, avgpool, softmax) on it
    assert torch.equal(q_stem.qnet.forward(frames_u8, stop=split - 1),
                       q_plain.qnet.forward(frames_u8, stop=split - 1))
    assert torch.equal(out_s, out_p)
    q_diff = (out_s - out_bf.float()).abs().max().item()
    # batch 1: the fused stem's probs against the plain engine's; each
    # engine's output a distribution
    lat_diff = 0.0
    for of, op in lat_out:
        assert of[1] is None and op[1] is None
        assert of[0].shape == op[0].shape == (1, 1000)
        lat_diff = max(lat_diff, (of[0].float() - op[0].float()).abs()
                       .max().item())
    assert lat_diff <= 2 ** -5, lat_diff
    del out_bf, out_bfs, out_s, out_p
    torch.cuda.empty_cache()
    log(f"phase 41 ok: {tag} B={BATCH}: the three stems == their plain "
        f"versions (fwd on the fold and the tile, max |err| against "
        f"fwd_pair_plain {sk['fwd_err']}; the int8 stem from u8 frames "
        f"torch.equal; the batch-1 stem max |err| {sk['b1_err']}); the "
        f"bf16 phase stem within the link bounds of the plain engine's "
        f"layers (max |err| {stem_link_err}; whole outputs max |diff| "
        f"{bfs_diff}); int8 trunks equal with and without the phase stem, "
        f"the float tail's outputs equal (int8 against bf16 max |diff| "
        f"{q_diff}); batch 1 fused against plain max |diff| {lat_diff} "
        f"[{gpu}]")

    # ---------------------------------------------------------- phase 42
    times, bounds, errs = time_serving_kernels(
        tag, sk, bf_stem._stem, lat_f._stem, frames_u8, x1, [], 0.0, gpu)
    for kind, pair in (("bf16", (bf, bf_stem)), ("int8 u8", (q_plain,
                                                             q_stem))):
        kw = {"input_dtype": torch.uint8} if kind == "int8 u8" else {}
        for name, eng in zip(("plain", "phase stem", "phase stem", "plain"),
                             (*pair, *reversed(pair))):
            r = eng.benchmark(iters=10, warmup=2, **kw)
            log(f"time {tag} {kind} engine B={BATCH}, {name}: "
                f"{r['images_per_sec']} images/s ({r['sec_per_batch']} "
                f"s/batch) [{gpu}]")
    for label, fn in (("bf16 plain", lambda: bf(x_b)),
                      ("bf16 + phase stem", lambda: bf_stem(x_b)),
                      ("int8 u8 plain", lambda: q_plain(frames_u8)),
                      ("int8 u8 + phase stem", lambda: q_stem(frames_u8))):
        name = f"{tag} {label} B={BATCH}, per batch"
        seen = profile(name, fn, 3, gpu)
        if label == "bf16 + phase stem":
            assert_conv_tensor_core(name, seen, 3, {
                "fwd_tc_kernel": 1, "fwd_fold_kernel": 1,
                "fwdstats_tc_kernel": 0, "fwdstats_fold_kernel": 0,
                "fwdstats_kernel": 0})
        if label == "int8 u8 + phase stem":
            assert any("phase_pair_tc_kernel" in k for k in seen), seen
    # batch 1: frames through each LatencyEngine (u8 upload, forward, the
    # output read back), in turns, host clock; and the device time a frame
    walls = {"fused stem": [], "plain": []}
    for name, eng in (("fused stem", lat_f), ("plain", lat_p),
                      ("plain", lat_p), ("fused stem", lat_f)):
        for k in range(50):
            t0 = time.perf_counter()
            eng(u8[k % 3])[0].float().cpu()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    for name, eng in (("fused stem", lat_f), ("plain", lat_p)):
        w = np.asarray(walls[name])
        dev_ms = eng.device_benchmark(reps=30)["device_ms_per_frame"]
        log(f"time {tag} LatencyEngine {name} per frame (100 frames, host "
            f"clock): median {np.median(w)} ms, p99 {np.percentile(w, 99)} "
            f"ms; device time {dev_ms} ms (CUDA events, 30 queued frames) "
            f"[{gpu}]")
        seen = profile(f"{tag} LatencyEngine {name}, per frame",
                       lambda: eng(u8[0]), 10, gpu)
    log(f"phase 42 ok: {tag} times, bounds and profiles; peak device "
        f"memory since phase 40 "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{gpu}]")

    # ---------------------------------------------------------- phase 43
    # the CLI on the card and with -cpu over seeded PPMs, each named after
    # the class that `classifier predict -cpu` ranks first for it (names
    # n00000 ... n00999), so that the CPU's `classifier valid` reads top1
    # 1.0000 and the card's must too; `classifier predict` on the card
    # matches the CPU's top-5 on every image
    names = [f"n{c:05d}" for c in range(1000)]
    labels = WORK / "darknet19.names"
    labels.write_text("\n".join(names) + "\n")
    data = WORK / "darknet19.data"
    data.write_text(f"valid={WORK / 'darknet19-valid.list'}\n"
                    f"names={labels}\nlabels={labels}\ntop=5\n")
    vdir = WORK / "darknet19-valid"
    shutil.rmtree(vdir, ignore_errors=True)
    vdir.mkdir()

    def predict(path, flag):
        return top_lines(quiet(cli.main, [
            "classifier", "predict", str(data), str(cfg), str(weights),
            str(path)] + flag)[1])
    paths, cpu_top, margins, draws = [], [], [], 0
    while len(paths) < 4:
        k, draws = len(paths), draws + 1
        assert draws <= 12, "ties at the top of most draws"
        p = vdir / f"image_{k}.ppm"
        write_ppm(str(p), rng.integers(0, 256, (300 + 40 * k, 400, 3),
                                       dtype=np.uint8))
        top = predict(p, ["-cpu"])
        (c1, p1), (_, p2) = top[0], top[1]
        if p1 - p2 <= 2 * D19_RTOL * p1 + 2e-6:
            continue  # a tie at the top: either device may rank it first
        paths.append(str(p.rename(vdir / f"{c1}_{k}.ppm")))
        cpu_top.append(top)
        margins.append(p1 - p2)
    (WORK / "darknet19-valid.list").write_text("\n".join(paths) + "\n")
    pred_n = sum(match_top(predict(p, []), top, D19_RTOL * 2)[0]
                 for p, top in zip(paths, cpu_top))
    outs = {}
    for where in ("card", "cpu"):
        flag = [] if where == "card" else ["-cpu"]
        outs[where] = [quiet(cli.main, argv + flag)[1] for argv in (
            ["classifier", "valid", str(data), str(cfg), str(weights)],
            ["classify", str(cfg), str(weights), paths[1], "-int8",
             "-names", str(labels)])]
    assert outs["cpu"][0] == "top1: 1.0000, top5: 1.0000\n", outs["cpu"][0]
    assert outs["card"][0] == outs["cpu"][0], (outs["card"][0],
                                               outs["cpu"][0])
    int8_cpu = top_lines(outs["cpu"][1])
    int8_top = max(p for _, p in int8_cpu)
    int8_n, int8_diff = match_top(top_lines(outs["card"][1]), int8_cpu,
                                  D19_INT8_RTOL * int8_top)
    _, speed = quiet(cli.main, ["speed", str(cfg), "3", "-batch", "128",
                                "-int8", "-phase-stem"])
    rate = float(re.search(r"Speed: ([\d.]+) images/sec \(batch 128\)",
                           speed).group(1))
    assert rate > 0
    log(f"phase 43 ok: the CLI on CUDA and with -cpu: classifier predict "
        f"on {len(paths)} PPMs ({pred_n} top-5 entries matched within "
        f"{2 * D19_RTOL}), classifier valid over them, each named after "
        f"the CPU's top-1 ({[pathlib.Path(p).stem for p in paths]}, top-1 "
        f"margins {margins}; the same line: "
        f"{outs['card'][0].strip()!r}), classify -int8 ({int8_n} matched "
        f"within {D19_INT8_RTOL} of the top prob {int8_top}, max |diff| "
        f"{int8_diff}); speed -batch 128 -int8 -phase-stem on CUDA: "
        f"{rate} images/s [{gpu}]")

    shapes = f"3->32 @{D19}, 32->64 @{D19 // 2}"
    return [dict(e, name=f"{e['name']} ({tag} serving: {shapes})")
            for e in serving_entries(times, bounds, errs, launches_d)]


D19_CLI_ITERS = 3  # iterations of phase 47's classifier and cifar training


def darknet19_224_train(gpu, dev, reset_counts, counts):
    """Phases 44-47 (the module docstring): darknet19-224 training, the
    classifier family. Returns the kernels line's entries for the pair's
    and the fused stem's kernels at darknet19-224's training shapes."""
    from sr_object_detection_tpu_torch.apps import cli
    from sr_object_detection_tpu_torch.config import parse_cfg_text
    from sr_object_detection_tpu_torch.graph import spec as S
    from sr_object_detection_tpu_torch.infer.engine import analytic_flops
    from sr_object_detection_tpu_torch.io.convert import params_to_numpy
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, load_weights, save_weights)
    from sr_object_detection_tpu_torch.kernels import fused_stem as FS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.models.zoo import darknet19
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    from tools.synth_dataset import write_ppm
    tag = f"darknet19-{D19}"
    bf16 = torch.bfloat16
    GiB = 2 ** 30
    WORK.mkdir(parents=True, exist_ok=True)

    # ---------------------------------------------------------- phase 44
    # the cost head's C-oracle golden and every trainable classifier kind
    # on the card, TF32 off: the all-kinds net with dropout .3 and a 10x10
    # crop with flips, 3 steps at subdivisions 2 on the CPU and on CUDA,
    # the card given the CPU run's draws (its own dropout stream differs)
    torch.cuda.empty_cache()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    golden_err = {name: check_train_golden(name, dev)
                  for name in sorted(CLASSIFIER_TRAIN_GOLDENS)}
    kspec = S.build_network_spec(parse_cfg_text(all_kinds_text(
        8, 2, crop=10, flip=1, probability=0.3)))
    kparams = classifier_params(kspec, 44)
    rng = np.random.default_rng(44)
    batches = [(rng.uniform(0, 1, (8, 12, 12, 3)).astype(np.float32),
                one_hot_groups(rng, 8, 112, 4)) for _ in range(3)]
    runs, drawn = {}, [[] for _ in batches]
    for where in ("cpu", dev):
        tr = Trainer(kspec, params=kparams, device=where, seed=44)
        losses = []
        for (x, t), d in zip(batches, drawn):
            if where != "cpu":
                d = [{i: v.to(dev) if torch.is_tensor(v) else v
                      for i, v in m.items()} for m in d]
            losses.append(float(tr.step(x, t, draws=d)["loss"]))
        runs[str(where)] = (losses, params_to_numpy(kspec, tr.state.params))
    assert all(len(d) == 2 and all(len(m) == 2 for m in d) for d in drawn)
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    own = []
    own_loss = float(tr.step(*batches[0], draws=own)["loss"])
    keeps = [v for m in own for v in m.values() if torch.is_tensor(v)]
    assert np.isfinite(own_loss) and len(keeps) == 2 and all(
        k.device.type == torch.device(dev).type and k.dtype == torch.bool
        for k in keeps), own
    kinds_err = 0.0
    for i, l in enumerate(kspec.layers):
        for k, want in pc[i].items():
            assert np.allclose(pg[i][k], want, rtol=1e-4, atol=1e-4), (
                i, l.kind, k)
            kinds_err = max(kinds_err, float(np.abs(pg[i][k] - want).max()))
    assert np.allclose(lg, lc, rtol=1e-4), (lg, lc)
    moved = max(float(np.abs(pc[i][k] - kparams[i][k]).max())
                for i in range(len(kparams)) for k in kparams[i])
    log(f"phase 44 ok: the float32 Trainer on CUDA reproduces "
        f"{sorted(CLASSIFIER_TRAIN_GOLDENS)} (weights 1e-4, max relative "
        f"cost error {golden_err}); the all-kinds net ({len(kspec.layers)} "
        f"layers: {', '.join(l.kind for l in kspec.layers)}; dropout .3, "
        f"crop 10x10 with flips) 3 steps at subdivisions 2, card against "
        f"CPU with the CPU's draws: losses {lg} vs {lc}, parameters "
        f"within {kinds_err} (gate 1e-4; they moved up to {moved}); a "
        f"step on the card's own draws: loss {own_loss}, keep fraction "
        f"{[float(k.float().mean()) for k in keeps]} (p = .3) [{gpu}]")

    # ---------------------------------------------------------- phase 45
    # Trainer on darknet19-224 (cfg/darknet19.cfg, 1000 classes) at B=128
    # as one micro-batch, seeded weights and one-hot truths: bf16 paths
    # (d), (a), (b) and float32, 3 steps a path, each path's launches,
    # peak device memory, images/s, MFU and a profiled step
    dspec = darknet19()
    dspec = dataclasses.replace(dspec, net=dataclasses.replace(
        dspec.net, batch=BATCH, subdivisions=1))
    dparams = init_params(dspec, seed=0)
    gx = torch.Generator(device=dev).manual_seed(45)
    xd = torch.rand((BATCH, D19, D19, 3), generator=gx, device=dev)
    td = torch.from_numpy(one_hot_groups(rng, BATCH, 1000, 1)).to(dev)
    step_flops = 3 * analytic_flops(dspec)
    pair1 = dict(phase_train_fwdstats=1, phase_train_apply=1,
                 phase_train_bwdg=1)
    paths = {"(d) bf16": (dict(compute_dtype=bf16), {}),
             "(a) bf16 + phase_train": (
                 dict(compute_dtype=bf16, phase_train=True), pair1),
             "(b) bf16 + phase_train + fused_stem": (
                 dict(compute_dtype=bf16, phase_train=True,
                      fused_stem=True),
                 dict(pair1, fused_stem_f2=4, fused_stem_b1=4,
                      fused_stem_b2=4)),
             "float32": ({}, {})}
    first, peaks, rates, launches_p = {}, {}, {}, {}
    for name, (kw, per_step) in paths.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(dspec, dparams, device=dev, **kw)
        reset_counts()
        losses = [float(tr.step(xd, td)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / GiB
        got, want = counts(**{k: 3 * v for k, v in per_step.items()})
        assert got == want, (name, got)
        assert FS.paths == {"f2_row": got["fused_stem_f2"],
                            "b1_row": got["fused_stem_b1"],
                            "b2_row": got["fused_stem_b2"], "f2": 0,
                            "b1": 0, "b2": 0}, (name, FS.paths)
        assert not any(c["fp32_core"] for c in PT.conv_kernels.values())
        assert PT.bwdg_kernels["fp32_core"] == 0
        assert all(np.isfinite(losses)), (name, losses)
        first[name] = losses[0]
        ref = first["(d) bf16"]
        assert abs(losses[0] - ref) <= 0.03 * abs(ref) + 0.05, (
            name, losses[0], ref)
        launches_p[name] = got
        log(f"  Trainer {tag} {name} B={BATCH}, 3 steps: losses {losses}; "
            f"launches {dict((k, v) for k, v in got.items() if v)}; peak "
            f"device memory {peaks[name]:.2f} GiB "
            f"({time.perf_counter() - T0:.1f} s)")
        ips = step_rate(tr, xd, td, 3)
        peak_ops = PEAK_OPS_S["f32" if name == "float32" else "bf16"]
        rates[name] = ips
        log(f"time Trainer.step {tag} {name} B={BATCH}: {ips} images/s, "
            f"{ips * step_flops / 1e12} TFLOP/s, MFU "
            f"{ips * step_flops / peak_ops} of the "
            f"{'float32 (TF32 off)' if name == 'float32' else 'bf16'} "
            f"dense peak [{gpu}]")
        seen = profile(f"Trainer.step {tag} {name} B={BATCH}, per step",
                       lambda: tr.step(xd, td), 1, gpu, top=8)
        if "fused_stem" in name:
            assert_fused_stem_rows(name, seen)
        if "phase_train" in name:
            assert_bwdg_tensor_core(name, seen)
        del tr
    del xd, td
    torch.cuda.empty_cache()
    log(f"phase 45 ok: {tag} Trainer B={BATCH} (the cost head, 1000-class "
        f"one-hot truths), paths (d), (a), (b) and float32 3 steps each "
        f"with their launch counts a step; first losses within "
        f"0.03*|loss| + 0.05 of (d)'s {first['(d) bf16']}; images/s "
        f"{ {k: round(v, 1) for k, v in rates.items()} }; peak device "
        f"memory by path { {k: round(v, 2) for k, v in peaks.items()} } "
        f"GiB [{gpu}]")

    # ---------------------------------------------------------- phase 46
    # the pair and F2/B1/B2 at darknet19-224's training shapes: the pair
    # 3 -> 32 @224, the fused stem at the layers Network.fusable picks
    stem_layers = ((0, D19, 32), (2, D19 // 2, 64), (6, D19 // 4, 128),
                   (10, D19 // 8, 256), (16, D19 // 16, 512))
    times, bounds, errs, library = train_kernels_at(
        tag, D19, stem_layers, 64, 46, gpu, dev)
    log(f"phase 46 ok: {tag} training kernels == plain: the pair 3->32 at "
        f"{D19} B={BATCH} (fwdstats on the taps fold, bwdg on the tensor "
        f"cores, two launches of each bit-equal), F2, B1, B2 at layers "
        f"{[l for l, _, _ in stem_layers]} on the row kernels (max |err| "
        f"{ {k: v for k, v in errs.items()} }) [{gpu}]")

    # ---------------------------------------------------------- phase 47
    # the CLI on the card and with -cpu: `classifier train` over 16 seeded
    # PPMs (two classes by brightness) with a small cfg, and `cifar train`
    # and `cifar test` over seeded CIFAR-format binaries, each from one
    # seeded .weights; the .weights each writes on the card within 1e-4 of
    # the -cpu run's
    t0 = time.perf_counter()
    cdir = WORK / "classifier-train"
    shutil.rmtree(cdir, ignore_errors=True)
    cdir.mkdir()
    paths_ppm = []
    for i in range(16):
        h, w = (int(v) for v in rng.integers(40, 81, 2))
        img = np.clip((i % 2 + 1) / 3 + rng.normal(0, .1, (h, w, 3)), 0, 1)
        p = cdir / f"{('dark', 'lite')[i % 2]}_{i}.ppm"
        write_ppm(str(p), (img * 255).astype(np.uint8))
        paths_ppm.append(str(p))
    (cdir / "train.list").write_text("\n".join(paths_ppm) + "\n")
    (cdir / "labels.list").write_text("dark\nlite\n")
    ccfg = cdir / "small.cfg"
    ccfg.write_text(D19_TRAIN_CFG.format(size=32, batch=16, classes=2,
                                         iters=D19_CLI_ITERS))
    cspec = S.build_network_spec(parse_cfg_text(ccfg.read_text()))
    w0 = cdir / "init.weights"
    save_weights(cspec, init_params(cspec, seed=47), str(w0))
    wdiff = {}
    for where in ("card", "cpu"):
        data = cdir / f"{where}.data"
        data.write_text(f"train={cdir / 'train.list'}\nlabels="
                        f"{cdir / 'labels.list'}\nbackup={cdir / where}\n")
        _, out = quiet(cli.main, ["classifier", "train", str(data),
                                  str(ccfg), str(w0)]
                       + ([] if where == "card" else ["-cpu"]))
        assert len(out.splitlines()) == D19_CLI_ITERS, out
    trained = {w: load_weights(cspec, str(cdir / w / "small.weights"))
               for w in ("card", "cpu")}
    assert trained["card"][1] == trained["cpu"][1] == 16 * D19_CLI_ITERS
    wdiff["classifier train"] = weights_diff(trained["card"][0],
                                             trained["cpu"][0], w0, cspec)
    # cifar: 64 training and 32 test records of a label byte and 3072 CHW
    # bytes
    fdir = WORK / "cifar"
    shutil.rmtree(fdir, ignore_errors=True)
    (fdir / "data").mkdir(parents=True)
    for name, n in (("data_batch_1.bin", 64), ("test_batch.bin", 32)):
        rec = np.concatenate([rng.integers(0, 10, (n, 1)),
                              rng.integers(0, 256, (n, 3072))], 1)
        rec.astype(np.uint8).tofile(fdir / "data" / name)
    fcfg = fdir / "cifar_small.cfg"
    fcfg.write_text(D19_TRAIN_CFG.format(size=32, batch=16, classes=10,
                                         iters=D19_CLI_ITERS))
    fspec = S.build_network_spec(parse_cfg_text(fcfg.read_text()))
    f0 = fdir / "init.weights"
    save_weights(fspec, init_params(fspec, seed=47), str(f0))
    tests = {}
    for where in ("card", "cpu"):
        flag = [] if where == "card" else ["-cpu"]
        quiet(cli.main, ["cifar", "train", str(fcfg), str(f0), "-data",
                         str(fdir / "data"), "-backup", str(fdir / where)]
              + flag)
        tests[where] = quiet(cli.main, [
            "cifar", "test", str(fcfg), str(fdir / "card" /
                                            "cifar_small.weights"),
            "-data", str(fdir / "data")] + flag)[1]
    ftrained = {w: load_weights(fspec, str(fdir / w / "cifar_small.weights"))
                for w in ("card", "cpu")}
    wdiff["cifar train"] = weights_diff(ftrained["card"][0],
                                        ftrained["cpu"][0], f0, fspec)
    assert tests["card"] == tests["cpu"], tests
    assert tests["card"].startswith("top-1 accuracy: "), tests
    log(f"phase 47 ok: the CLI on CUDA and with -cpu: classifier train "
        f"({D19_CLI_ITERS} iterations of 16 images) and cifar train "
        f"({D19_CLI_ITERS} iterations of 16 from 64 records) write "
        f".weights within {wdiff} (max |card - cpu|, max |moved|; gate "
        f"1e-4); cifar test over 32 records, the same line on both: "
        f"{tests['card'].strip()!r} ({time.perf_counter() - t0:.1f} s) "
        f"[{gpu}]")

    launches_k = {
        **{k: launches_p["(a) bf16 + phase_train"][k]
           for k in ("phase_train_fwdstats", "phase_train_apply",
                     "phase_train_bwdg")},
        **{k: launches_p["(b) bf16 + phase_train + fused_stem"][k]
           for k in ("fused_stem_f2", "fused_stem_b1", "fused_stem_b2")}}
    return train_entries(tag, times, bounds, errs, library, launches_k,
                         {"phase_train": f"3->32 @{D19} B={BATCH}",
                          "fused_stem": f"layers 0, 2, 6, 10, 16 "
                                        f"B={BATCH}"})


# phase 47's small classifier: a 3x3 conv + BN, maxpool, the 1x1 logits
# conv, avgpool, softmax, sse cost, as darknet19's tail
D19_TRAIN_CFG = """\
[net]
batch={batch}
subdivisions=2
height={size}
width={size}
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.1
max_batches={iters}
policy=constant
min_crop={size}
max_crop=64
hue=.1
saturation=1.5
exposure=1.5

[convolutional]
filters=16
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters={classes}
size=1
stride=1
pad=1
activation=linear

[avgpool]

[softmax]
groups=1

[cost]
type=sse
"""


def weights_diff(a, b, w0, spec):
    """(max |a - b|, max |a - w0|) over two loaded .weights' params and
    the initial .weights they trained from; asserts the first within
    1e-4 (relative above 1) and that training moved them."""
    from sr_object_detection_tpu_torch.io.weights import load_weights
    init = load_weights(spec, str(w0))[0]
    diff = moved = 0.0
    for i, (p, q) in enumerate(zip(a, b)):
        for k in p:
            assert np.allclose(p[k], q[k], rtol=1e-4, atol=1e-4), (i, k)
            diff = max(diff, float(np.abs(p[k] - q[k]).max()))
            moved = max(moved, float(np.abs(p[k] - init[i][k]).max()))
    assert moved > 0
    return diff, moved


RNN_HIDDEN = 1024  # char_rnn's published width (cfg/rnn.cfg, models/zoo.py)
RNN_STEPS = 32     # time steps and streams of phases 48-49's batches
RNN_STREAMS = 32
RNN_GEN = 200      # characters `rnn generate` writes in phase 49
RNN_TOL = 1e-4     # card against CPU, of the largest |value| (TF32 off)
# `rnn train`'s learning rate in phase 49, not the zoo's 0.1: after three
# steps at 0.1, float32 rounding alone (the CPU on 8 threads against 1)
# puts two runs 0.72 of a tensor's largest value apart, at 0.001 4.6e-4,
# at 0.0001 2.2e-5 (tools/rnn_train_noise.py)
RNN_LR = 0.0001
V1 = 448           # tiny-yolo v1's input (darknet cfg/yolov1/tiny-yolo.cfg)
V1_SIDE, V1_NUM = 7, 2
V1_BATCH = 64      # images a step of phase 50's throughput run
V1_HEAD_GAIN = 4.0  # the connected head's scale: objectness and classes spread
# `yolo train`'s learning rate in phase 50, on weights with the head
# unscaled, and its gate: each tensor's update on the card against the
# CPU's, the norm of the difference over the update's norm. At 1e-5 the
# card measured 1.1e-3 (3.3e-3 on tools/v1_train_noise.py's data) and the
# CPU on 1 thread against 8 5.5e-4-6.1e-4; at 1e-4 the card reached
# 9.4e-3 (tools/v1_train_noise.py)
V1_LR = 1e-5
V1_UPDATE_TOL = 1e-2
# tinyyolo-v1's first dream step at layer 10 in phase 51, card against
# CPU, the norm of the gradients' difference over the CPU gradient's
# norm: the CPU alone moves it 4.6e-3 with its input scaled by 1 + 1e-7
# and 8.5e-3 by 1 + 1e-6 (max-pool routes flip at near-ties), the card
# measured 1.5e-3-2.1e-3 (tools/nightmare_sensitivity.py)
V1_DREAM_TOL = 1e-2


def v1_cfg_text(classes, batch, max_batches=2, learning_rate=0.001):
    """tinyyolo-v1-448 after darknet's public cfg/yolov1/tiny-yolo.cfg,
    written from its published shape (the file is not in the repository):
    six conv3x3 + BN + leaky / maxpool 2/2 pairs at 16 ... 512 filters,
    conv 1024, conv 256, connected side^2 * (classes + 5 * num) linear and
    [detection] side 7, num 2, sqrt, rescore, softmax 0, coord / noobject /
    object / class scales 5 / .5 / 1 / 1."""
    from sr_object_detection_tpu_torch.models.zoo import CfgBuilder
    b = CfgBuilder()
    b.net(batch=batch, subdivisions=1, width=V1, height=V1, channels=3,
          momentum=0.9, decay=0.0005, learning_rate=learning_rate,
          policy="constant",
          max_batches=max_batches, hue=.1, saturation=1.5, exposure=1.5)
    for f in (16, 32, 64, 128, 256, 512):
        b.conv(f, size=3, stride=1)
        b.maxpool()
    b.conv(1024, size=3, stride=1)
    b.conv(256, size=3, stride=1)
    b.section("connected", output=V1_SIDE ** 2 * (classes + 5 * V1_NUM),
              activation="linear")
    b.section("detection", classes=classes, coords=4, side=V1_SIDE,
              num=V1_NUM, softmax=0, sqrt=1, rescore=1, jitter=.2,
              coord_scale=5, noobject_scale=.5, object_scale=1,
              class_scale=1)
    return b.text()


SUPER_CFG = """\
[net]
batch=1
height=240
width=320
channels=3

[convolutional]
filters=32
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=32
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[deconvolutional]
filters=3
size=2
stride=2
activation=logistic
"""


def param_diff(a, b, tol):
    """max over two params lists (the port's dicts of tensors) of |a - b|
    over each tensor's largest |b|; asserts each within ``tol``."""
    worst = 0.0
    for i, (p, q) in enumerate(zip(a, b)):
        for k, want in q.items():
            d = float((p[k].cpu() - want.cpu()).abs().max()
                      / want.abs().max().clamp_min(1e-30))
            assert d <= tol, (i, k, d)
            worst = max(worst, d)
    return worst


@contextlib.contextmanager
def stdin_bytes(data: bytes):
    """Standard input reading ``data`` (the `rnn vec` command's lines)."""
    old = sys.stdin
    sys.stdin = io.TextIOWrapper(io.BytesIO(data))
    try:
        yield
    finally:
        sys.stdin = old


def nms_at(tag, tb, tp, thr, gpu, dev):
    """The NMS kernel on one frame's candidates: torch.equal to the plain
    version (int32 views: -0.0 too), two launches bit-equal; its time from
    a CUDA graph in turns with the plain version, beside its bound and the
    launch floor. Returns (max abs error, (ms, plain ms), bound)."""
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.ops import boxes as B
    got = NMS.nms_per_class(tb, tp, thr)
    again = NMS.nms_per_class(tb, tp, thr)
    ref = B.nms_per_class_plain(tb, tp, thr)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), tag
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), tag
    c, k = tp.shape
    p1 = cuda_ms(lambda: B.nms_per_class_plain(tb, tp, thr), 5, 1)
    k1 = graph_ms(lambda: NMS.nms_per_class(tb, tp, thr), 20)
    k2 = graph_ms(lambda: NMS.nms_per_class(tb, tp, thr), 20)
    p2 = cuda_ms(lambda: B.nms_per_class_plain(tb, tp, thr), 5, 1)
    floor = graph_ms(lambda: NMS.empty_launch(c, k, dev), 20)
    bnd = nms_bound(tb, tp)
    log(f"time nms_per_class {tag} C={c} k={k} ({int((tp > 0).sum())} live "
        f"candidates, {int((got > 0).sum())} kept): kernel from a CUDA graph "
        f"{(k1 + k2) / 2} ms ({k1}, {k2}), plain {(p1 + p2) / 2} ms ({p1}, "
        f"{p2}); bound {bnd[0]} ms by {bnd[1]}; launch floor {floor} ms "
        f"[{gpu}]")
    return (got - ref).abs().max().item(), ((k1 + k2) / 2, (p1 + p2) / 2), bnd


def last_kinds(gpu, dev, reset_counts, counts):
    """Phases 48-51 (the module docstring): the recurrent kinds and
    char_rnn-1024, YOLOv1 at 448, nightmare and super. Returns the kernels
    line's entries of the NMS kernel at the v1 head."""
    from sr_object_detection_tpu_torch.apps import cli
    from sr_object_detection_tpu_torch.apps import rnn_app as RA
    from sr_object_detection_tpu_torch.apps.misc_apps import (
        fill_truth_region_np)
    from sr_object_detection_tpu_torch.apps.nightmare_app import (
        make_dream_step)
    from sr_object_detection_tpu_torch.apps.yolo_v1_app import V1Detector
    from sr_object_detection_tpu_torch.config import parse_cfg_text
    from sr_object_detection_tpu_torch.graph import spec as S
    from sr_object_detection_tpu_torch.graph.compiler import Network
    from sr_object_detection_tpu_torch.io.convert import params_to_torch
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, load_weights, save_weights)
    from sr_object_detection_tpu_torch.models.zoo import char_rnn
    from sr_object_detection_tpu_torch.ops import boxes as B
    from sr_object_detection_tpu_torch.ops.image import (load_image_rgb,
                                                         resize_image)
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    from tools.synth_dataset import write_ppm
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    WORK.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()

    # ---------------------------------------------------------- phase 48
    golden_err = {name: check_recurrent_golden(name, dev)
                  for name in sorted(RECURRENT_GOLDENS)}
    rdir = WORK / "char_rnn"
    shutil.rmtree(rdir, ignore_errors=True)
    rdir.mkdir()
    rcfg = rdir / "rnn.cfg"
    # phase 49 trains 3 iterations at RNN_LR (see there)
    rcfg.write_text(zoo_cfg_text(char_rnn, hidden=RNN_HIDDEN,
                                 batch=RNN_STREAMS, time_steps=RNN_STEPS)
                    .replace("max_batches=2000", "max_batches=3")
                    .replace("learning_rate=0.1", f"learning_rate={RNN_LR}"))
    rspec = S.parse_network_cfg(str(rcfg))
    assert rspec.net.batch == RNN_STEPS * RNN_STREAMS
    assert [l.kind for l in rspec.layers] == ["rnn"] * 3 + [
        "connected", "softmax", "cost"]
    rparams = random_bn_nested(init_params(rspec, seed=48), 48)
    rweights = rdir / "rnn.weights"
    save_weights(rspec, rparams, str(rweights))
    rng = np.random.default_rng(48)
    words = [bytes(rng.integers(97, 123, int(n))) for n in
             rng.integers(2, 9, 4000)]
    text = b" ".join(words)
    rtext = rdir / "text.txt"
    rtext.write_bytes(text)
    stream = RA.CharStream(text, RNN_STREAMS, RNN_STEPS, seed=48)
    xr, yr = stream.next_batch()
    outs = {}
    for where in ("cpu", dev):
        net = Network(rspec, params_to_torch(rspec, rparams, where))
        with torch.no_grad():
            outs[str(where)] = net(torch.from_numpy(xr).to(where))[0].cpu()
    rnn_err = (outs[str(dev)] - outs["cpu"]).abs().max().item() / \
        outs["cpu"].abs().max().item()
    assert rnn_err <= RNN_TOL, rnn_err
    # a CRNN net: 8 steps of 4 streams at 32x32, 3 -> 16 hidden -> 16
    ctext = ("[net]\nbatch=4\ntime_steps=8\nsubdivisions=1\nheight=32\n"
             "width=32\nchannels=3\n\n[crnn]\nbatch_normalize=1\n"
             "output_filters=16\nhidden_filters=16\nactivation=leaky\n\n"
             "[crnn]\nbatch_normalize=1\noutput_filters=16\n"
             "hidden_filters=16\nactivation=leaky\n")
    cspec = S.build_network_spec(parse_cfg_text(ctext))
    cparams = random_bn_nested(init_params(cspec, seed=49), 49)
    xc = rng.uniform(0, 1, (32, 32, 32, 3)).astype(np.float32)
    for where in ("cpu", dev):
        net = Network(cspec, params_to_torch(cspec, cparams, where))
        with torch.no_grad():
            outs[f"crnn {where}"] = net(torch.from_numpy(xc).to(where))[0]\
                .cpu()
    crnn_err = (outs[f"crnn {dev}"] - outs["crnn cpu"]).abs().max().item() \
        / outs["crnn cpu"].abs().max().item()
    assert crnn_err <= RNN_TOL, crnn_err
    log(f"phase 48 ok: the recurrent goldens on CUDA, max abs error "
        f"{golden_err} (gate 2e-5); char_rnn-{RNN_HIDDEN} (3 BN rnn layers, "
        f"connected 256, softmax) over {RNN_STEPS} steps of {RNN_STREAMS} "
        f"streams, card against CPU {rnn_err} of the largest |value|; a "
        f"2-crnn net (8 steps x 4 streams, 32x32x16) {crnn_err} (gate "
        f"{RNN_TOL}) [{gpu}]")

    # ---------------------------------------------------------- phase 49
    trained = {}
    for where, flag in (("card", []), ("cpu", ["-cpu"])):
        t0 = time.perf_counter()
        tr, _ = quiet(cli.COMMANDS["rnn"], ["train", str(rcfg), str(rtext),
                                            str(rweights), "-backup",
                                            str(rdir / where)] + flag)
        assert int(tr.state.seen) == 3 * rspec.net.batch
        trained[where] = tr.state.params
        log(f"  rnn train ({where}): 3 iterations of {rspec.net.batch} "
            f"characters in {time.perf_counter() - t0:.2f} s")
    train_err = param_diff(trained["card"], trained["cpu"], RNN_TOL)
    moved = param_diff(trained["card"],
                       params_to_torch(rspec, rparams, "cpu"), 1e9)
    assert moved > 0
    card_tr = Trainer(rspec, params=rparams, device=dev)
    xd, yd = torch.from_numpy(xr).to(dev), torch.from_numpy(yr).to(dev)
    chars_s = step_rate(card_tr, xd, yd, 5)
    profile(f"char_rnn-{RNN_HIDDEN} Trainer.step float32 ({rspec.net.batch} "
            f"characters)", lambda: float(card_tr.step(xd, yd)["loss"]), 1,
            gpu, top=4)
    del card_tr
    log(f"  rnn train and its steps/s: {time.perf_counter() - t_phase:.1f} s "
        f"into phases 48-51")
    # rnn generate: the CPU sampler's text and probs at every step, the
    # card's `rnn generate` through the CLI, then the card sampler fed the
    # CPU's characters
    cpu_s = RA.CharRNNSampler(rspec, rparams, device="cpu")
    cpu_probs, step = [], cpu_s._step

    def recording(*a):
        p, s_ = step(*a)
        cpu_probs.append(p)
        return p, s_
    cpu_s._step = recording
    gen_cpu = cpu_s.generate(b"the ", RNN_GEN)
    t0 = time.perf_counter()
    gen_cli, _ = quiet(cli.COMMANDS["rnn"], [
        "generate", str(rcfg), str(rweights), "-len", str(RNN_GEN),
        "-seed", "the "])
    cli_s = time.perf_counter() - t0
    card_s = RA.CharRNNSampler(rspec, rparams, device=dev)
    st = card_s.init_state()
    gen_err = 0.0
    # generate feeds the seed, its last character again, then each
    # character it drew but the last
    fed = b"the " + b" " + gen_cpu[4:-1]
    assert len(fed) == len(cpu_probs) == RNN_GEN + 4
    for ch, p_cpu in zip(fed, cpu_probs):
        p, st = card_s._step(card_s.params, card_s.one_hot(ch), st)
        gen_err = max(gen_err, (p.cpu() - p_cpu).abs().max().item()
                      / p_cpu.abs().max().item())
    assert gen_err <= RNN_TOL, gen_err
    assert gen_cli == gen_cpu, (gen_cli, gen_cpu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_card = card_s.generate(b"the ", RNN_GEN)
    per_char = (time.perf_counter() - t0) / RNN_GEN * 1e3
    st = {"s": card_s.init_state()}

    def one_char():
        p, st["s"] = card_s._step(card_s.params, card_s.one_hot(101),
                                  st["s"])
        p[0].cpu()
    profile(f"rnn generate, one character (char_rnn-{RNN_HIDDEN})",
            one_char, 50, gpu, top=4)
    log(f"  rnn generate and the samplers: {time.perf_counter() - t_phase:.1f}"
        f" s into phases 48-51")
    # valid and vec, card against CPU, through the CLI
    vals = {}
    for where, flag in (("card", []), ("cpu", ["-cpu"])):
        vals[where], _ = quiet(cli.COMMANDS["rnn"], [
            "valid", str(rcfg), str(rweights), str(rtext), "-len", "100"]
            + flag)
        with stdin_bytes(b"abc de\nfgh\nabc de\n"):
            vals[f"vec {where}"], _ = quiet(cli.COMMANDS["rnn"], [
                "vec", str(rcfg), str(rweights), "-seed", "x"] + flag)
    assert abs(vals["card"] - vals["cpu"]) <= RNN_TOL * abs(vals["cpu"])
    vec_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(vals["vec card"], vals["vec cpu"]))
    assert vec_err <= RNN_TOL and len(vals["vec card"]) == 3
    log(f"time char_rnn-{RNN_HIDDEN} Trainer.step (float32, "
        f"{rspec.net.batch} characters a step): {chars_s} characters/s, "
        f"{chars_s / rspec.net.batch} steps/s; rnn generate {per_char} ms a "
        f"character on the card [{gpu}]")
    log(f"phase 49 ok: `rnn train` 3 iterations on the card and with -cpu "
        f"from one .weights, parameters within {train_err} of each tensor's "
        f"largest value (gate {RNN_TOL}; moved {moved}); the card sampler "
        f"fed the CPU's {RNN_GEN} generated characters, probs within "
        f"{gen_err}; the card's text {gen_card[:24]!r}... (the CLI's on the "
        f"card equal to the CPU's; {cli_s:.2f} s with the "
        f"weights' load); `rnn valid` log-loss "
        f"{vals['card']} (card) {vals['cpu']} (CPU); `rnn vec` rows within "
        f"{vec_err} [{gpu}]")

    # ---------------------------------------------------------- phase 50
    torch.cuda.empty_cache()
    det_err = check_detection_golden("train_yolov1", dev)
    vdir = WORK / "yolov1"
    shutil.rmtree(vdir, ignore_errors=True)
    vdir.mkdir()
    vcfg = vdir / "tiny-yolo-v1.cfg"
    vcfg.write_text(v1_cfg_text(20, 2))
    vspec = S.parse_network_cfg(str(vcfg))
    assert (vspec.layers[-2].inputs, vspec.layers[-2].outputs) == (
        7 * 7 * 256, 1470)
    vweights = vdir / "tiny-yolo-v1.weights"
    save_weights(vspec, random_bn(init_params(vspec, seed=50), 50,
                                  head_gain=V1_HEAD_GAIN), str(vweights))
    train_list = write_ppm_dataset(vdir / "train", 4, seed=50)
    vdata = vdir / "v1.data"
    vdata.write_text(f"train={train_list}\nbackup={vdir / 'backup'}\n")
    tcfg = vdir / "tiny-yolo-v1-train.cfg"
    tcfg.write_text(v1_cfg_text(20, 2, learning_rate=V1_LR))
    tweights = vdir / "tiny-yolo-v1-train.weights"
    save_weights(vspec, random_bn(init_params(vspec, seed=50), 50),
                 str(tweights))
    vtrained, first_loss = {}, {}
    threads = torch.get_num_threads()
    for where, flag, n in (("card", [], threads), ("cpu", ["-cpu"], threads),
                           ("cpu 1 thread", ["-cpu"], 1)):
        torch.set_num_threads(n)
        tr, out = quiet(cli.COMMANDS["yolo"], ["train", str(vdata),
                                               str(tcfg), str(tweights)]
                        + flag)
        torch.set_num_threads(threads)
        assert int(tr.state.seen) == 4 and len(out.splitlines()) == 2, out
        first_loss[where] = float(out.split()[1])
        vtrained[where] = [{k: v.cpu() for k, v in p.items()}
                           for p in tr.state.params]
    del tr
    assert abs(first_loss["card"] - first_loss["cpu"]) <= \
        1e-5 * abs(first_loss["cpu"]), first_loss
    v1_train_err = param_diff(vtrained["card"], vtrained["cpu"], RNN_TOL)
    # each tensor's update (after - before) on the card against the
    # CPU's, the norm of their difference over the update's norm, so a
    # wrong or missing update fails however small the step is beside the
    # weights; the CPU on 1 thread against its default threads must itself
    # stay under the gate, or the gate would sit in float32's noise
    v1_init = params_to_torch(vspec, load_weights(vspec, str(tweights))[0],
                              "cpu")
    norm = torch.linalg.vector_norm
    v1_upd_err, v1_floor, v1_moved = 0.0, 0.0, {}
    for i, p in enumerate(vtrained["cpu"]):
        for k, want in p.items():
            step = float(norm(want - v1_init[i][k]))
            assert step > 0, (i, k)
            v1_moved[i, k] = float((want - v1_init[i][k]).abs().max()
                                   / want.abs().max())
            floor = float(norm(vtrained["cpu 1 thread"][i][k] - want)) / step
            d = float(norm(vtrained["card"][i][k] - want)) / step
            assert floor <= V1_UPDATE_TOL, ("CPU floor", i, k, floor)
            assert d <= V1_UPDATE_TOL, (i, k, d)
            v1_upd_err, v1_floor = max(v1_upd_err, d), max(v1_floor, floor)
    v1_least = min(v1_moved, key=v1_moved.get)
    # throughput at B=64, card only
    spec64 = S.build_network_spec(parse_cfg_text(v1_cfg_text(20, V1_BATCH)))
    tr64 = Trainer(spec64, params=load_weights(vspec, str(vweights))[0],
                   device=dev)
    # the batch on the card, as a device loader hands it over
    x64 = torch.from_numpy(rng.uniform(0, 1, (V1_BATCH, V1, V1, 3)).astype(
        np.float32)).to(dev)
    t64 = torch.from_numpy(np.stack([fill_truth_region_np(np.asarray(
        [[c, *rng.uniform(.2, .8, 2), *rng.uniform(.1, .4, 2)]
         for c in rng.integers(0, 20, 3)]), V1_SIDE, 20)
        for _ in range(V1_BATCH)])).to(dev)
    torch.cuda.reset_peak_memory_stats()
    v1_rate = step_rate(tr64, x64, t64, 5)
    v1_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profile(f"tinyyolo-v1-{V1} Trainer.step B={V1_BATCH} float32",
            lambda: float(tr64.step(x64, t64)["loss"]), 2, gpu, top=4)
    del tr64
    torch.cuda.empty_cache()
    log(f"time tinyyolo-v1-{V1} Trainer.step float32 B={V1_BATCH}: "
        f"{v1_rate} images/s, peak device memory {v1_peak} GiB [{gpu}]")
    # test / valid / recall on 8 seeded images, card against CPU
    valid_list = write_ppm_dataset(vdir / "valid", 8, seed=51)
    valid_paths = open(valid_list).read().split()
    res = {}
    for where, flag in (("card", []), ("cpu", ["-cpu"])):
        out_dir = vdir / f"valid-{where}"
        reset_counts()
        quiet(cli.main, ["yolo", "valid", str(vcfg), str(vweights), "-list",
                         valid_list, "-out", str(out_dir)] + flag)
        torch.cuda.synchronize()
        if where == "card":
            launches_v1, want_l = counts(nms_per_class=8)
            assert launches_v1 == want_l, launches_v1
        res[f"valid {where}"] = comp4_dets(out_dir)
        res[f"recall {where}"], _ = quiet(cli.COMMANDS["yolo"], [
            "recall", str(vcfg), str(vweights), "-list", valid_list] + flag)
        res[f"test {where}"], _ = quiet(cli.COMMANDS["yolo"], [
            "test", str(vcfg), str(vweights), valid_paths[0], "-out",
            str(vdir / f"test-{where}.ppm")] + flag)
    n_valid = match_dets(res["valid card"], res["valid cpu"], 0.001, 1e-4)
    rc, rp = res["recall card"], res["recall cpu"]
    assert (rc["proposals"], rc["correct"], rc["total"]) == \
        (rp["proposals"], rp["correct"], rp["total"]), (rc, rp)
    assert abs(rc["avg_iou"] - rp["avg_iou"]) <= 1e-4
    n_test = match_dets(*([(d.class_id, d.prob, np.asarray(d.box))
                           for d in res[f"test {w}"]] for w in ("card", "cpu")),
                        0.2, 1e-4, require=False)
    swag = {}
    for where, flag in (("card", []), ("cpu", ["-cpu"])):
        swag[where], _ = quiet(cli.COMMANDS["swag"], [
            "test", str(vcfg), str(vweights), valid_paths[1], "-out",
            str(vdir / f"swag-{where}.ppm")] + flag)
    n_swag = match_dets(*([(d.class_id, d.prob, np.asarray(d.box))
                           for d in swag[w]] for w in ("card", "cpu")),
                        0.2, 1e-4, require=False)
    # the NMS kernel at the v1 head: a valid frame's candidates at C = 20
    # and, from the 80-class net, at C = 80; k = N = 98
    det = V1Detector(str(vcfg), str(vweights), device=dev)
    frame = load_image_rgb(valid_paths[0])
    v_err, v_times, v_bounds, v_shapes = {}, {}, {}, {}
    fb, fp = det.predict_batch(det.preprocess(frame)[None])
    fp = np.where(fp[0] > 0.001, fp[0], 0.0).astype(np.float32)
    tb, tp, _ = B.topk_candidates(torch.from_numpy(fb[0]).float().to(dev),
                                  torch.from_numpy(fp).to(dev), fp.shape[0])
    v_err[20], v_times[20], v_bounds[20] = nms_at(
        f"tinyyolo-v1-{V1} (yolo valid)", tb, tp, 0.5, gpu, dev)
    v_shapes[20] = tuple(tp.shape)
    del det
    ccfg = vdir / "tiny-coco-v1.cfg"
    ccfg.write_text(v1_cfg_text(80, 1))
    cspec80 = S.parse_network_cfg(str(ccfg))
    cweights = vdir / "tiny-coco-v1.weights"
    save_weights(cspec80, random_bn(init_params(cspec80, seed=52), 52,
                                    head_gain=V1_HEAD_GAIN), str(cweights))
    clist = vdir / "coco.list"
    clist.write_text("\n".join(valid_paths[:2]) + "\n")
    coco = {}
    for where, flag in (("card", []), ("cpu", ["-cpu"])):
        reset_counts()
        quiet(cli.main, ["coco", "valid", str(ccfg), str(cweights), "-list",
                         str(clist), "-out", str(vdir / f"coco-{where}")]
              + flag)
        torch.cuda.synchronize()
        if where == "card":
            launches_coco, want_l = counts(nms_per_class=2)
            assert launches_coco == want_l, launches_coco
        coco[where] = [((r["image_id"], r["category_id"]), r["score"],
                        np.asarray(r["bbox"])) for r in json.loads(
            (vdir / f"coco-{where}" / "coco_results.json").read_text())]
    n_coco = match_dets(coco["card"], coco["cpu"], 0.001, 1e-4)
    det = V1Detector(str(ccfg), str(cweights), device=dev)
    fb, fp = det.predict_batch(det.preprocess(frame)[None])
    fp = np.where(fp[0] > 0.001, fp[0], 0.0).astype(np.float32)
    tb, tp, _ = B.topk_candidates(torch.from_numpy(fb[0]).float().to(dev),
                                  torch.from_numpy(fp).to(dev), fp.shape[0])
    v_err[80], v_times[80], v_bounds[80] = nms_at(
        f"tiny-coco-v1-{V1} (coco valid)", tb, tp, 0.5, gpu, dev)
    v_shapes[80] = tuple(tp.shape)
    del det
    log(f"phase 50 ok: train_yolov1.npz on CUDA (cost error {det_err}, gate "
        f"1e-3); `yolo train` at {V1} B=2, 2 iterations at learning rate "
        f"{V1_LR}, card against -cpu: parameters within {v1_train_err} of "
        f"each tensor's largest value (gate {RNN_TOL}), each tensor's update "
        f"within {v1_upd_err} of its norm (gate {V1_UPDATE_TOL}; "
        f"the CPU on 1 thread against {threads} {v1_floor}); training moved "
        f"each tensor {v1_moved[v1_least]} ({v1_least}) to "
        f"{max(v1_moved.values())} of its largest value; the first loss "
        f"{first_loss['card']} "
        f"(card) {first_loss['cpu']} (CPU); `yolo valid` over 8 seeded PPMs {n_valid} comp4 lines "
        f"matched, NMS launches 8; `yolo recall` {rc}; `yolo test` {n_test} "
        f"detections matched; `swag test` {n_swag} detections matched; `coco "
        f"valid` (80 classes, 2 images) {n_coco} records matched, NMS "
        f"launches 2; the NMS kernel at (C, k) = {list(v_shapes.values())} "
        f"torch.equal to the plain version [{gpu}]")

    # ---------------------------------------------------------- phase 51
    # nightmare on the super-resolution net (convs and a deconv): through
    # tinyyolo-v1's six max-pools a float32 rounding of the input flips
    # argmaxes at near-ties and two steps move a fifth of the values beyond
    # 1e-4 on the CPU alone (tools/nightmare_sensitivity.py), so only a
    # net without pools makes a value-by-value comparison
    ndir = WORK / "nightmare"
    shutil.rmtree(ndir, ignore_errors=True)
    ndir.mkdir()
    scfg = ndir / "super.cfg"
    scfg.write_text(SUPER_CFG)
    sspec = S.parse_network_cfg(str(scfg))
    sweights = ndir / "super.weights"
    save_weights(sspec, random_bn(init_params(sspec, seed=51), 51),
                 str(sweights))
    simg = ndir / "frame.ppm"
    write_ppm(str(simg), rng.integers(0, 256, (240, 320, 3), dtype=np.uint8))
    dreams, ups = {}, {}
    for where, flag in (("card", []), ("cpu", ["-cpu"])):
        (ndir / where).mkdir()
        dreams[where], _ = quiet(cli.COMMANDS["nightmare"], [
            str(scfg), str(sweights), str(simg), "1", "-iters", "2",
            "-octaves", "1", "-out", str(ndir / where)] + flag)
        ups[where], _ = quiet(cli.COMMANDS["super"], [
            "test", str(scfg), str(sweights), str(simg), "-out",
            str(ndir / f"super-{where}.ppm")] + flag)
    dream_err = float(np.abs(dreams["card"] - dreams["cpu"]).max())
    assert dream_err <= RNN_TOL, dream_err
    assert float(np.abs(dreams["cpu"] - load_image_rgb(str(simg))).max()) \
        > 0.01
    super_err = float(np.abs(ups["card"] - ups["cpu"]).max())
    assert ups["card"].shape == (480, 640, 3) and super_err <= RNN_TOL
    # nightmare through max-pools, its real use: tinyyolo-v1's first dream
    # step (the input gradient of layer 10, six pools down) card against
    # CPU, where near-ties flip the pools' routes, at a limit set from the
    # CPU's own step-1 reading (tools/nightmare_sensitivity.py); then the
    # command through the pools on the card
    x_v1 = resize_image(torch.from_numpy(load_image_rgb(str(simg))), V1,
                        V1)[None]
    v1_np = load_weights(vspec, str(vweights))[0]
    dream_g = {where: make_dream_step(vspec, 10)(
        params_to_torch(vspec, v1_np, where), x_v1.to(where)).cpu()
        for where in ("cpu", str(dev))}
    g_cpu = dream_g["cpu"]
    v1_dream_err = float(torch.linalg.vector_norm(dream_g[str(dev)] - g_cpu)
                         / torch.linalg.vector_norm(g_cpu))
    assert g_cpu.abs().max() > 0 and v1_dream_err <= V1_DREAM_TOL, \
        v1_dream_err
    (ndir / "v1").mkdir()
    v1_dream, _ = quiet(cli.COMMANDS["nightmare"], [
        str(vcfg), str(vweights), str(simg), "10", "-iters", "2",
        "-octaves", "1", "-out", str(ndir / "v1")])
    assert v1_dream.shape == (240, 320, 3) and np.isfinite(v1_dream).all()
    assert float(np.abs(v1_dream - load_image_rgb(str(simg))).max()) > 0.01
    log(f"phase 51 ok: `nightmare` on the super-resolution net (320x240, "
        f"layer 1), 1 octave, 2 iterations, card against -cpu {dream_err}; "
        f"`super` 320x240 -> 640x480 {super_err} (gate {RNN_TOL}); "
        f"tinyyolo-v1-{V1}'s first dream step at layer 10, card against CPU "
        f"{v1_dream_err} of the gradient's norm (gate {V1_DREAM_TOL}), and "
        f"`nightmare` through its pools on the card; phases "
        f"48-51 took {time.perf_counter() - t_phase:.1f} s [{gpu}]")

    launches_k = {20: launches_v1["nms_per_class"],
                  80: launches_coco["nms_per_class"]}
    return [{"name": f"nms_per_class (YOLOv1 head, exact NMS: "
                     f"{'tinyyolo-v1' if c == 20 else 'tiny-coco-v1'}-{V1} "
                     f"C={v_shapes[c][0]} k={v_shapes[c][1]})",
             "route": "cuda", "source": "sr_object_detection_tpu_torch/csrc/"
                                        "nms.cu",
             "replaces": "sr_object_detection_tpu/kernels/nms_pallas.py:29",
             "launches": launches_k[c], "max_abs_err": v_err[c],
             "ms": v_times[c][0], "plain_ms": v_times[c][1],
             "bound_ms": v_bounds[c][0], "bound_by": v_bounds[c][1],
             "library_ms": None}
            for c in (20, 80)]


GO_BOARDS = 128     # boards a step of phase 52's `go train` and its rate
GO_CHECK = 16       # boards a step of the card-against-CPU training run
GO_TOL = 1e-4       # go-19's forward, card against CPU, of the largest |value|
# each tensor's update after 1 step of `go train` at a constant rate,
# card against CPU: the norm of the difference over the update's norm
# (phase 50's gate); the CPU on 1 thread against its default threads
# must stay under it too. The BN biases sit near it: their float32
# gradients cancel, and the CPU in float32 lands 7.6e-3 of their update
# from a float64 run after one step, as does the card from the CPU
# (tools/go_train_noise.py)
GO_UPDATE_TOL = 1e-2
# the same after 2 steps: the second step's BN statistics amplify that
# noise, and the card lands 8.0e-2 from the CPU, the CPU 8.1e-2 and the
# card 2.0e-2 from float64 (tools/go_train_noise.py at lr 0.1); the gate
# is twice the card's distance from the CPU there
GO_UPDATE_TOL_2 = 0.16
GO_LATENCY_CALLS = 50
APP_ITERS = 3       # iterations of each small app's training run
APP_TOL = 1e-3      # the small apps' losses, card against CPU, relative
# the scripted GTP session of phase 52: three stones break the board's
# symmetry first (on an empty board the dihedral copies of a point tie
# exactly, and which of a tie the top-5 threshold keeps turns on the
# last bit of each device's sums)
GO_GTP = "\n".join([
    "1 boardsize 19", "2 clear_board", "3 komi 6.5", "4 play black Q16",
    "5 play white D4", "6 play black C16", "7 genmove white",
    "8 genmove black", "9 genmove white", "10 genmove black",
    "11 play white pass", "12 genmove black", "13 quit"]) + "\n"


def go_and_apps(gpu, dev, reset_counts, counts):
    """Phases 52-54 (the module docstring): go-19 at full width, the small
    apps through their CLI commands, and `gemm`."""
    import os
    import statistics
    from sr_object_detection_tpu_torch.apps import cli
    from sr_object_detection_tpu_torch.apps import go_app as G
    from sr_object_detection_tpu_torch.graph import spec as S
    from sr_object_detection_tpu_torch.io.convert import params_to_torch
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, load_weights, save_weights)
    from sr_object_detection_tpu_torch.utils import profiler as P
    from torch_parity import (APP_CLS_CFG, APP_EXT_CFG, APP_RNN_CFG,
                              APP_SUPER_CFG, APP_WRITING_CFG, app_image_set,
                              go19_cfg_text, train_float64, write_go_moves)
    from tools.synth_dataset import write_ppm
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    t_phase = time.perf_counter()
    gdir = WORK / "go19"
    shutil.rmtree(gdir, ignore_errors=True)
    gdir.mkdir(parents=True)

    # ---------------------------------------------------------- phase 52
    cfg = gdir / "go19.cfg"
    cfg.write_text(go19_cfg_text())
    spec = S.parse_network_cfg(str(cfg))
    assert [l.filters for l in spec.layers[:14]] == [256] * 13 + [1]
    assert [l.kind for l in spec.layers[14:]] == ["softmax", "cost"]
    weights = gdir / "go19.weights"
    save_weights(spec, random_bn(init_params(spec, seed=52), 52),
                 str(weights))
    moves = write_go_moves(gdir / "go.train", 1024, 52)
    test_moves = write_go_moves(gdir / "go.test", 32, 53)
    rng = np.random.default_rng(52)
    eng = {"card": G.GoEngine(str(cfg), str(weights), device=dev),
           "cpu": G.GoEngine(str(cfg), str(weights), device="cpu")}
    boards = G.string_to_board(G.load_go_moves(moves)[:GO_CHECK, 2:])
    x16 = boards.reshape(GO_CHECK, 19, 19, 1)
    fwd = {w: e.forward(x16) for w, e in eng.items()}
    fwd_err = float(np.abs(fwd["card"] - fwd["cpu"]).max()
                    / np.abs(fwd["cpu"]).max())
    assert fwd["card"].shape == (GO_CHECK, 361) and fwd_err <= GO_TOL, \
        fwd_err
    multi = {w: e.predict_move(boards[0], multi=True)
             for w, e in eng.items()}
    multi_err = float(np.abs(multi["card"] - multi["cpu"]).max()
                      / np.abs(multi["cpu"]).max())
    assert multi_err <= GO_TOL, multi_err
    # genmove's latency (the forward plus the host's legality scan over
    # the 361 points and the draw) and the forward's alone, at batch 1
    # and at batch 8 (-multi), on a position after three moves
    board = np.zeros((19, 19), np.float32)
    for player, (r, c) in ((1, (3, 15)), (-1, (15, 3)), (1, (3, 2))):
        G.move_go(board, player, r, c)
    lat = {}
    for m in (False, True):
        for what, fn in (
                ("genmove", lambda: eng["card"].generate_move(
                    -1, board, multi=m)),
                ("forward", lambda: eng["card"].predict_move(
                    -board, multi=m, temperature=0.7))):
            fn()
            ts = []
            for _ in range(GO_LATENCY_CALLS):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            ts.sort()
            lat[what, m] = (statistics.median(ts),
                            ts[int(np.ceil(0.99 * len(ts))) - 1])
            log(f"time go-19 {what} batch {8 if m else 1}: median "
                f"{lat[what, m][0]} ms, p99 {lat[what, m][1]} ms over "
                f"{GO_LATENCY_CALLS} calls [{gpu}]")
        profile(f"go-19 predict_move batch {8 if m else 1}",
                lambda: eng["card"].predict_move(-board, multi=m,
                                                 temperature=0.7),
                5, gpu, top=4)
    # `go train` at B=GO_BOARDS through the CLI (3 iterations), then the
    # step's rate, peak memory, MFU and a profiled step on its trainer;
    # the path runs no hand-written kernel (float32, no max-pool)
    cfg_b = gdir / "go19-train.cfg"
    cfg_b.write_text(go19_cfg_text(batch=GO_BOARDS, max_batches=3))
    reset_counts()
    (tr, losses), out = quiet(cli.COMMANDS["go"], [
        "train", str(cfg_b), str(weights), "-moves", moves, "-backup",
        str(gdir / "backup")])
    torch.cuda.synchronize()
    launched, none = counts()
    assert launched == none, launched
    assert len(losses) == 3 and np.all(np.isfinite(losses)), out
    assert int(tr.state.seen) == 3 * GO_BOARDS
    assert (gdir / "backup" / "go19-train.weights").exists()
    xb, yb = G.random_go_moves(G.load_go_moves(moves), rng, GO_BOARDS)
    xb = torch.from_numpy(xb.reshape(GO_BOARDS, 19, 19, 1)).to(dev)
    yb = torch.from_numpy(yb.reshape(GO_BOARDS, 361)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    go_rate = step_rate(tr, xb, yb, 5)
    go_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_flops = P.train_flops(spec) * GO_BOARDS
    go_mfu = P.mfu(step_flops, GO_BOARDS / go_rate, "float32")
    profile(f"go-19 Trainer.step B={GO_BOARDS} float32",
            lambda: float(tr.step(xb, yb)["loss"]), 1, gpu, top=4)
    del tr, xb, yb
    torch.cuda.empty_cache()
    log(f"time go-19 Trainer.step float32 B={GO_BOARDS}: {go_rate} boards/s, "
        f"{go_rate * step_flops / GO_BOARDS / 1e12} TFLOP/s, MFU {go_mfu} "
        f"of {P.H100_PEAK_FLOPS['float32'] / 1e12:g} TFLOP/s, peak device "
        f"memory {go_peak} GiB; `go train` losses {losses} [{gpu}]")
    # card against CPU: 1 and 2 steps of GO_CHECK boards through the CLI
    # from one .weights at a constant rate; after 1 step the CPU on 1
    # thread as the floor
    trained, first = {}, {}
    threads = torch.get_num_threads()
    for steps in (1, 2):
        cfg_c = gdir / f"go19-check{steps}.cfg"
        cfg_c.write_text(go19_cfg_text(batch=GO_CHECK, max_batches=steps,
                                       policy="constant"))
        spec_c = S.parse_network_cfg(str(cfg_c))
        assert spec_c.net.policy == "constant"
        runs = [("card", [], threads), ("cpu", ["-cpu"], threads)]
        if steps == 1:
            runs.append(("cpu 1 thread", ["-cpu"], 1))
        for where, flag, n in runs:
            torch.set_num_threads(n)
            (tr, losses), _ = quiet(cli.COMMANDS["go"], [
                "train", str(cfg_c), str(weights), "-moves", moves,
                "-backup", str(gdir / f"{where} {steps}")] + flag)
            torch.set_num_threads(threads)
            assert int(tr.state.seen) == steps * GO_CHECK
            first[where] = losses[0]
            trained[where, steps] = [{k: v.cpu() for k, v in p.items()}
                                     for p in tr.state.params]
        del tr
    assert abs(first["card"] - first["cpu"]) <= 1e-5 * abs(first["cpu"]), \
        first
    # the same steps on the CPU in float64 (the loss's delta excepted):
    # the BN biases' gradients sum 5,776 positions a channel with heavy
    # cancellation, so float32 on the CPU lands ~8e-3 of their update
    # from float64 after 1 step and ~8e-2 after 2, whatever its thread
    # count (tools/go_train_noise.py); the card must come as near
    # float64 as the CPU's float32 does
    brng, all_moves = np.random.default_rng(0), G.load_go_moves(moves)
    batches = []
    for _ in range(2):
        b, l = G.random_go_moves(all_moves, brng, GO_CHECK)
        batches.append((b.reshape(GO_CHECK, 19, 19, 1),
                        l.reshape(GO_CHECK, 361)))
    wide = train_float64(spec_c, load_weights(spec_c, str(weights))[0],
                         batches)
    init = params_to_torch(spec, load_weights(spec, str(weights))[0], "cpu")
    norm = torch.linalg.vector_norm
    upd_err = {1: 0.0, 2: 0.0}
    upd_floor = 0.0
    still = {}
    of_f64 = {(where, steps): 0.0 for where in ("card", "cpu")
              for steps in (1, 2)}
    for steps, tol in ((1, GO_UPDATE_TOL), (2, GO_UPDATE_TOL_2)):
        for i, p in enumerate(trained["cpu", steps]):
            for k, want in p.items():
                step = float(norm(want - init[i][k]))
                if (i, k) == (13, "biases"):
                    # the head's bias: a constant over the 361 points,
                    # which the softmax's identity backward gives the
                    # gradient sum(truth - out) = 1 - 1 over each board,
                    # zero up to rounding
                    got = trained["card", steps][i][k]
                    assert float((got - want).abs().max()) <= \
                        1e-6 * float(want.abs().max()), (i, k)
                    still[steps] = step / float(norm(init[i][k]))
                    continue
                assert step > 0, (steps, i, k)
                if steps == 1:
                    floor = float(norm(trained["cpu 1 thread", 1][i][k]
                                       - want)) / step
                    assert floor <= tol, ("CPU floor", i, k, floor)
                    upd_floor = max(upd_floor, floor)
                d = float(norm(trained["card", steps][i][k] - want)) / step
                assert d <= tol, (steps, i, k, d)
                upd_err[steps] = max(upd_err[steps], d)
                w64 = wide[steps - 1][i][k]
                step64 = float(norm(w64 - init[i][k].double()))
                for where in ("card", "cpu"):
                    of_f64[where, steps] = max(of_f64[where, steps], float(
                        norm(trained[where, steps][i][k].double() - w64))
                        / step64)
        assert of_f64["card", steps] <= 2 * of_f64["cpu", steps], of_f64
    # go valid, a GTP session (single and -multi) and one self-play game
    acc = {}
    for where, flag in (("card", []), ("cpu", ["-cpu"])):
        acc[where], _ = quiet(cli.COMMANDS["go"], [
            "valid", str(cfg), str(weights), "-moves", test_moves] + flag)
    assert acc["card"] == acc["cpu"], acc
    gtp = {}
    for mode in ([], ["-multi"]):
        for where, flag in (("card", []), ("cpu", ["-cpu"])):
            stdin, stderr = sys.stdin, sys.stderr
            sys.stdin, sys.stderr = io.StringIO(GO_GTP), io.StringIO()
            try:
                _, gtp[where, bool(mode)] = quiet(cli.COMMANDS["go"], [
                    "engine", str(cfg), str(weights)] + mode + flag)
            finally:
                sys.stdin, sys.stderr = stdin, stderr
        assert gtp["card", bool(mode)] == gtp["cpu", bool(mode)], (
            mode, gtp["card", bool(mode)], gtp["cpu", bool(mode)])
    gtp_moves = [line.split()[1] for line in gtp["card", False].splitlines()
                 if re.match(r"=(7|8|9|10|12) ", line)]
    assert len(gtp_moves) == 5, gtp["card", False]
    # `go self` writes its records to standard output's binary layer
    raw = io.BytesIO()
    wrapper, self_log = io.TextIOWrapper(raw), io.StringIO()
    stdout, stderr = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = wrapper, self_log
    t0 = time.perf_counter()
    try:
        scores = cli.COMMANDS["go"](["self", str(cfg), str(weights),
                                     "-games", "1"])
        wrapper.flush()
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    self_s = time.perf_counter() - t0
    recs = np.frombuffer(raw.getvalue(), np.uint8).reshape(-1, G.RECORD)
    self_log = self_log.getvalue()
    assert len(scores) == 1 and np.isfinite(scores[0]) and len(recs) > 0
    assert (recs[:, :2] < 19).all() and (recs[:, -1] == 10).all()
    assert "Total: 1" in self_log
    log(f"phase 52 ok: go-19 (13 x 256, 3x3, BN relu; 1x1 to one plane, "
        f"softmax, sse cost) forward on {GO_CHECK} boards card against CPU "
        f"{fwd_err} of the largest |value|, the -multi ensemble (one batch "
        f"of 8) {multi_err} (gate {GO_TOL}); genmove median / p99 batch 1 "
        f"{lat['genmove', False]} ms, batch 8 {lat['genmove', True]} ms "
        f"(forward alone {lat['forward', False]} / {lat['forward', True]} "
        f"ms); `go train` B={GO_BOARDS} {go_rate} boards/s, MFU {go_mfu}, "
        f"peak {go_peak} GiB, no hand-written kernel launched; `go train` "
        f"B={GO_CHECK} at a constant rate card against -cpu: each "
        f"tensor's update within {upd_err[1]} of its norm after 1 step "
        f"(gate {GO_UPDATE_TOL}; the CPU on 1 thread against {threads} "
        f"{upd_floor}), {upd_err[2]} after 2 (gate {GO_UPDATE_TOL_2}); "
        f"the head's bias, whose gradient is zero up to rounding, moved "
        f"{still[1]} / {still[2]} of its norm on the CPU, the card within "
        f"1e-6 of it; against "
        f"the float64 run after 1 / 2 steps the card {of_f64['card', 1]} / "
        f"{of_f64['card', 2]}, the CPU {of_f64['cpu', 1]} / "
        f"{of_f64['cpu', 2]} (gate: the card within twice the CPU's); "
        f"first loss "
        f"{first['card']} / {first['cpu']}; `go valid` accuracy "
        f"{acc['card']} on both; the GTP session's moves {gtp_moves} equal "
        f"on both (and with -multi); `go self` one game of "
        f"{len(recs)} winner's records, Tromp-Taylor score {scores[0]} in "
        f"{self_s:.1f} s; {time.perf_counter() - t_phase:.1f} s into phases "
        f"52-54 [{gpu}]")

    # ---------------------------------------------------------- phase 53
    adir = WORK / "apps"
    shutil.rmtree(adir, ignore_errors=True)
    adir.mkdir()

    def app_cfg(name, text, **kw):
        p = adir / f"{name}.cfg"
        p.write_text(text.format(iters=APP_ITERS, **kw))
        return str(p)

    def both(command, args, name):
        """`<command> train` on the card and with -cpu: (card losses, CPU
        losses), within APP_TOL relative of each other."""
        got = {}
        for where, flag in (("card", []), ("cpu", ["-cpu"])):
            got[where], _ = quiet(cli.COMMANDS[command], [
                "train"] + args + ["-backup", str(adir / f"{name}-{where}")]
                + flag)
        assert len(got["card"]) == APP_ITERS, got
        assert np.allclose(got["card"], got["cpu"], rtol=APP_TOL, atol=0), \
            (command, got)
        return got

    losses = {}
    names = ["ax", "ay", "bx", "by"]
    lst, paths = app_image_set(adir, names, 4, 530)
    (adir / "labels.list").write_text("\n".join(names) + "\n")
    cap = app_cfg("captcha", APP_CLS_CFG, batch=4, ch=3, out=4)
    losses["captcha"] = both("captcha", [cap, "-list", lst, "-labels",
                                         str(adir / "labels.list")],
                             "captcha")
    # tags: load_tags reads imgs/<name>_<k>.jpg.ppm's file under labels/
    for i, p in enumerate(paths):
        pathlib.Path(p.replace("imgs", "labels")).write_text(f"{i % 8}\n")
    losses["tag"] = both("tag", [app_cfg("tag", APP_CLS_CFG, batch=4, ch=3,
                                         out=8), "-list", lst], "tag")
    wdir = adir / "figs"
    wdir.mkdir()
    wpaths = []
    for k in range(6):
        img = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
        p = wdir / f"fig{k}.png.ppm"
        write_ppm(str(p), (img * 255).astype(np.uint8))
        write_ppm(str(p).replace(".png", "-label.png"), np.repeat(
            (img.mean(-1) > 0.5)[..., None] * 255, 3, -1).astype(np.uint8))
        wpaths.append(str(p))
    (adir / "figures.list").write_text("\n".join(wpaths) + "\n")
    losses["writing"] = both("writing", [
        app_cfg("writing", APP_WRITING_CFG, batch=4, ch=3), "-list",
        str(adir / "figures.list")], "writing")
    cmp_lst, cmp_paths = app_image_set(adir / "cmp", [f"q{i}" for i in
                                                      range(8)], 2, 531,
                                       ious=True)
    # pairs of a dark and a bright image: class 0's labels win / lose,
    # never masked
    n = len(cmp_paths)
    pathlib.Path(cmp_lst).write_text("\n".join(
        p for i in range(n // 2) for p in (cmp_paths[i],
                                           cmp_paths[n - 1 - i])) + "\n")
    cmp_cfg = app_cfg("compare", APP_CLS_CFG, batch=4, ch=6, out=4)
    losses["compare"] = both("compare", [cmp_cfg, "-list", cmp_lst,
                                         "-classes", "2"], "compare")
    cmp_w = str(adir / "compare-card" / "compare.weights")
    elos = {}
    for where, flag in (("card", []), ("cpu", ["-cpu"])):
        cwd = os.getcwd()
        os.chdir(adir)
        try:
            elos[where], _ = quiet(cli.COMMANDS["compare"], [
                "battle", cmp_cfg, cmp_w, "-list", cmp_lst, "-classes", "2"]
                + flag)
        finally:
            os.chdir(cwd)
    assert np.allclose(elos["card"], elos["cpu"], rtol=0, atol=1e-6), elos
    assert np.any(elos["card"] != 1500.0)
    dice_lst, _ = app_image_set(adir / "dice", [f"face{i}" for i in
                                                range(1, 7)], 2, 532)
    dice_cfg = app_cfg("dice", APP_CLS_CFG, batch=4, ch=3, out=6)
    losses["dice"] = both("dice", [dice_cfg, "-list", dice_lst], "dice")
    dice_w = str(adir / "dice-card" / "dice.weights")
    dice_acc = {w: quiet(cli.COMMANDS["dice"], ["valid", dice_cfg, dice_w,
                                                "-list", dice_lst] + f)[0]
                for w, f in (("card", []), ("cpu", ["-cpu"]))}
    assert dice_acc["card"] == dice_acc["cpu"], dice_acc
    dice_top, _ = quiet(cli.COMMANDS["dice"], [dice_cfg, dice_w,
                                               open(dice_lst).readline()
                                               .strip()])
    sdir = adir / "super"
    sdir.mkdir()
    for k in range(4):
        write_ppm(str(sdir / f"im{k}.ppm"),
                  rng.integers(0, 256, (24, 24, 3), dtype=np.uint8))
    (adir / "super.list").write_text("\n".join(
        str(sdir / f"im{k}.ppm") for k in range(4)) + "\n")
    sup_cfg = app_cfg("super", APP_SUPER_CFG)
    for command in ("super", "voxel"):
        losses[command] = both(command, [sup_cfg, "-list",
                                         str(adir / "super.list"), "-scale",
                                         "2"], command)
    vids = []
    for v in range(2):
        d = adir / f"vid{v}"
        d.mkdir()
        base = rng.uniform(0, 1, (16, 16, 3))
        for t in range(8):
            write_ppm(str(d / f"f{t:03d}.ppm"), (np.clip(
                base + 0.03 * t, 0, 1) * 255).astype(np.uint8))
        vids.append(str(d))
    (adir / "vids.list").write_text("\n".join(vids) + "\n")
    ext = app_cfg("ext", APP_EXT_CFG)
    losses["vid"] = both("vid", [app_cfg("vrnn", APP_RNN_CFG), "-list",
                                 str(adir / "vids.list"), "-extractor", ext],
                         "vid")
    gen = {}
    for where, flag in (("card", []), ("cpu", ["-cpu"])):
        gen[where], _ = quiet(cli.COMMANDS["vid"], [
            "generate", str(adir / "vrnn.cfg"),
            str(adir / "vid-card" / "vrnn.weights"), "-extractor", ext,
            "-frames", str(adir / "vid0" / "*.ppm"), "-n", "2", "-gen", "2",
            "-recon-iters", "3", "-out", str(adir / f"gen-{where}")] + flag)
    gen_err = max(float(np.abs(a - b).max())
                  for a, b in zip(gen["card"], gen["cpu"]))
    assert len(gen["card"]) == 2 and gen_err <= APP_TOL, gen_err
    img = str(sdir / "im0.ppm")
    art, _ = quiet(cli.COMMANDS["art"], [cap, str(adir / "captcha-card" /
                                                  "captcha.weights"), img])
    quiet(cli.COMMANDS["3d"], [img, str(sdir / "im1.ppm"),
                               str(adir / "3d.ppm")])
    (adir / "imtest").mkdir()
    quiet(cli.COMMANDS["imtest"], [img, "-out", str(adir / "imtest")])
    (adir / "test").mkdir()
    quiet(cli.COMMANDS["test"], [img, "-out", str(adir / "test")])
    assert 0.0 <= art <= 1.0 and (adir / "3d.ppm").exists()
    assert len(os.listdir(adir / "imtest")) == 7
    assert sorted(os.listdir(adir / "test")) == \
        sorted(os.listdir(adir / "imtest"))
    for name, l in losses.items():
        assert min(np.abs(l["cpu"])) > 0, (name, l)
    worst = max(float(np.max(np.abs(np.asarray(l["card"]) - l["cpu"])
                             / np.abs(l["cpu"]))) for l in losses.values())
    log(f"phase 53 ok: `captcha`, `tag`, `writing`, `compare`, `dice`, "
        f"`super`, `voxel` and `vid` train through the CLI, {APP_ITERS} "
        f"iterations each on the card and with -cpu, losses within {worst} "
        f"relative (gate {APP_TOL}); `compare battle` elos equal within "
        f"1e-6; `dice valid` accuracy {dice_acc['card']} on both, `dice` "
        f"{dice_top[2]}; `vid generate` images within {gen_err}; `art` "
        f"{art}, `3d`, `imtest` and `test` wrote their files; "
        f"{time.perf_counter() - t_phase:.1f} s into phases 52-54 [{gpu}]")

    # ---------------------------------------------------------- phase 54
    gemm = {}
    for flag, dtype in (([], "bfloat16"), (["-f32"], "float32")):
        rows, _ = quiet(cli.COMMANDS["gemm"], list(flag))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert len(rows) == 6 and all(r["gflops"] > 0 for r in rows)
        peak = P.H100_PEAK_FLOPS[dtype]
        for r in rows:
            share = r["gflops"] * 1e9 / peak
            log(f"time gemm {dtype} {r['m']}x{r['k']} * {r['k']}x{r['n']}"
                f"{' (TA,TB)' if r['ta'] else ''}: {r['gflops']} GFLOP/s, "
                f"{r['sec'] * 1e6} us a matmul, {share} of "
                f"{peak / 1e12:g} TFLOP/s [{gpu}]")
        gemm[dtype] = rows
    log(f"phase 54 ok: `gemm` (cuBLAS through torch.matmul, 200 queued "
        f"matmuls from a CUDA graph a shape) at darknet's six shapes, bf16 "
        f"{[round(r['gflops']) for r in gemm['bfloat16']]} and float32 (TF32 "
        f"off) {[round(r['gflops']) for r in gemm['float32']]} GFLOP/s; "
        f"phases 52-54 took {time.perf_counter() - t_phase:.1f} s [{gpu}]")


def main() -> int:
    # ---------------------------------------------------------- phase 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    gpu = card()
    log(gpu)
    from sr_object_detection_tpu_torch.infer.detector import (
        Detector, disable_tf32)
    from sr_object_detection_tpu_torch.infer.engine import (
        LatencyEngine, fold_params_for_inference)
    from sr_object_detection_tpu_torch.io.convert import params_to_torch
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, save_weights)
    from sr_object_detection_tpu_torch.kernels import _build
    from sr_object_detection_tpu_torch.kernels import b1_stem as BS
    from sr_object_detection_tpu_torch.kernels import fused_stem as FS
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc
    from sr_object_detection_tpu_torch.ops import boxes as B

    disable_tf32()
    dev = torch.device("cuda")

    def reset_counts():
        """Every kernel's launch count to 0."""
        NMS.launches = 0
        BS.reset_launches()
        PS.reset_launches()
        PT.reset_launches()
        FS.reset_launches()

    def counts(**expected):
        """(every kernel's launch count, the counts ``expected`` names with
        0 for the rest), under the names of the kernels JSON line."""
        got = {"nms_per_class": NMS.launches, "stem_pair": BS.launches,
               "phase_stem_pair": PS.launches,
               **{f"phase_train_{k}": v for k, v in PT.launches.items()},
               **{f"fused_stem_{k}": v for k, v in FS.launches.items()}}
        return got, {k: expected.get(k, 0) for k in got}
    t0 = time.perf_counter()
    _build.load()
    log(f"phase 0 ok: kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s) "
        f"from {_build.library_path().relative_to(ROOT)} [{gpu}]")

    # ---------------------------------------------------------- phase 1
    rng = np.random.default_rng(0)
    nms_err, nms_cases = 0.0, []
    before = NMS.launches
    for k in (128, 845):
        n, c = 845, 20
        boxes = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                          rng.uniform(.02, .4, n), rng.uniform(.02, .4, n)],
                         axis=1).astype(np.float32)
        boxes[100:110] = boxes[99]                      # duplicate boxes
        probs = rng.uniform(0, 1, (n, c)).astype(np.float32) ** 4
        probs[probs < 0.05] = 0
        probs[::7, 3] = probs[0, 3]                     # equal probs
        probs[100:110, 5] = 0.5                         # equal on equal
        tb, tp, _ = B.topk_candidates(torch.from_numpy(boxes).to(dev),
                                      torch.from_numpy(probs).to(dev), k)
        got = NMS.nms_per_class(tb, tp, 0.4)
        ref = NMS.nms_per_class_plain(tb, tp, 0.4)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"NMS differs from plain, k={k}"
        nms_err = max(nms_err, (got - ref).abs().max().item())
        nms_cases.append((k, tb, tp))
    assert NMS.launches == before + 2
    # device time from a CUDA graph, beside the launch floor: an empty
    # kernel with the same grid, block and shared memory
    for k, tb, tp in nms_cases:
        g_ms = graph_ms(lambda: NMS.nms_per_class(tb, tp, 0.4), 50)
        f_ms = graph_ms(lambda: NMS.empty_launch(20, k, dev), 50)
        log(f"time nms_per_class C=20 k={k} from a CUDA graph: {g_ms} ms; "
            f"launch floor (empty kernel, same launch shape, graph) "
            f"{f_ms} ms; {g_ms / f_ms:.1f}x the floor [{gpu}]")
    log(f"phase 1 ok: NMS kernel torch.equal to plain at C=20 k=128,845 "
        f"(max |err| {nms_err}) [{gpu}]")

    # ---------------------------------------------------------- phase 2
    spec = tiny_yolo_voc()
    params_np = random_bn(init_params(spec, seed=0), 1, head_gain=8.0)
    folded, fspec = fold_params_for_inference(
        spec, params_to_torch(spec, params_np, dev), torch.bfloat16)
    pairs = BS.plan_pairs(fspec)
    assert pairs == [(0, 1), (2, 3), (4, 5), (6, 7)], pairs
    stem_err = 0.0
    pair_inputs = []
    x = torch.from_numpy(rng.uniform(0, 1, (1, 416, 416, 3)).astype(
        np.float32)).to(dev, torch.bfloat16)
    # pair 1 (Cin 3) on the tile's taps fold, pairs 2-4 on the tile
    stem_paths = {"tensor_core": 3, "tensor_core_fold": 1, "fp32_core": 0}
    BS.reset_launches()
    for ci, _ in pairs:
        l = fspec.layers[ci]
        w = torch.from_numpy(rng.normal(0, 0.3, (3, 3, l.c, l.filters))
                             .astype(np.float32)).to(dev, torch.bfloat16)
        b = torch.from_numpy(rng.normal(0, 0.3, l.filters).astype(
            np.float32)).to(dev)
        xi = torch.from_numpy(rng.uniform(0, 1, (1, l.h, l.w, l.c)).astype(
            np.float32)).to(dev, torch.bfloat16)
        pair_inputs.append((xi, w, b))
        e = bf16_err(BS.stem_pair(xi, w, b), BS.stem_pair_plain(xi, w, b))
        stem_err = max(stem_err, e)
        log(f"  stem pair {l.c}->{l.filters} @{l.h}: max |err| {e} "
            f"({PT.conv_path('stem', l.c, l.filters)})")
    assert BS.paths == stem_paths, BS.paths
    stem_fn, n_stem = BS.build_stem(fspec, folded)
    assert n_stem == 8
    packed = [(folded[ci]["weights"].permute(2, 3, 1, 0).to(torch.bfloat16)
               .contiguous(), folded[ci]["biases"].float())
              for ci, _ in pairs]

    def plain_stem(v):
        for w, b in packed:
            v = BS.stem_pair_plain(v, w, b)
        return v
    # the chain link by link: each kernel output against the plain
    # version on the same input (the kernel's previous output); a 1-ulp
    # difference fed on to the next pair may grow, so the two whole
    # chains are compared for information only
    v = x
    for w, b in packed:
        out = BS.stem_pair(v, w, b)
        stem_err = max(stem_err, bf16_err(out, BS.stem_pair_plain(v, w, b)))
        v = out
    assert torch.equal(stem_fn(x), v)
    chain_diff = (stem_fn(x).float() - plain_stem(x).float()).abs().max()
    torch.cuda.synchronize()
    assert BS.paths == {k: 4 * n for k, n in stem_paths.items()}, BS.paths
    log(f"phase 2 ok: stem kernel (tensor-core conv tile, launches by path "
        f"{BS.paths}) == plain at the 4 pair shapes and along "
        f"the chain (max |err| {stem_err}); whole chain against the plain "
        f"chain: max |diff| {chain_diff.item()} [{gpu}]")

    # ---------------------------------------------------------- phase 3
    WORK.mkdir(parents=True, exist_ok=True)
    g = np.load(GOLDEN / "detect_tiny_yolo.npz")
    cfg = WORK / "tiny-yolo-voc.cfg"
    cfg.write_text(bytes(g["cfg"]).decode())
    weights = WORK / "random.weights"
    save_weights(spec, params_np, str(weights))
    det = Detector(str(cfg), str(weights), device=dev)
    det_cpu = Detector(str(cfg), str(weights), device="cpu")
    frames = [rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
              for _ in range(3)]
    _, p_cpu = det_cpu.predict_batch(det_cpu.preprocess(frames[0])[None])
    thresh = float(np.sort(p_cpu[0].max(-1).values.numpy())[::-1][10])
    u8 = [rng.integers(0, 256, (416, 416, 3), dtype=np.uint8)
          for _ in range(3)]
    fused = LatencyEngine(spec, params_np, device=dev, fused_stem=True)
    plain = LatencyEngine(spec, params_np, device=dev)
    assert fused.fused_stem and not plain.fused_stem

    reset_counts()
    n_dets = 0
    for f in frames:
        got, want = (
            [(d.class_id, d.prob, np.asarray(d.box)) for d in
             d_.detect(f, thresh=thresh - 1e-4)] for d_ in (det, det_cpu))
        n_dets += match_dets(got, want, thresh, 1e-4)
    # the C-oracle golden, float32 on CUDA (gates of test_parity.py)
    gspec_params = init_params(spec, seed=int(g["seed"]))
    save_weights(spec, gspec_params, str(WORK / "golden.weights"))
    gdet = Detector(str(cfg), str(WORK / "golden.weights"), device=dev)
    gb, gp = gdet.predict_batch(np.transpose(g["input_chw"], (1, 2, 0))[None])
    gp = torch.where(gp[0] > float(g["thresh"]), gp[0], 0.0)
    gp = NMS.nms_sort_topk(gb[0], gp, float(g["nms"]), k=gb.shape[1])
    gb, gp = gb[0].cpu().numpy(), gp.cpu().numpy()
    assert np.allclose(gb, g["boxes"], rtol=2e-4, atol=2e-4)
    assert np.array_equal(gp > 0, g["probs"] > 0)
    assert np.allclose(gp, g["probs"], rtol=3e-4, atol=3e-4)
    golden_err = float(np.abs(gp - g["probs"]).max())
    # the batch-1 bf16 engine, fused stem against the plain chain: the
    # stem rounds once (fused) or twice (plain), so probs may differ by
    # a few bf16 ulps; the band keeps every compared candidate inside
    # both top-64 lists
    n_cands = 0
    for f in u8:
        out_f, out_p = fused(f), plain(f)
        for bx, pr in (out_f, out_p):
            assert bx.shape == (64, 4) and pr.shape == (64, 20)
            assert torch.isfinite(bx).all() and torch.isfinite(pr).all()
        cf, cp = candidates(*out_f), candidates(*out_p)
        best = sorted((p for _, p, _ in cp), reverse=True)
        thr, margin = best[8] - 0.02, 0.02
        assert max(min(p for _, p, _ in c) for c in (cf, cp)) < thr - margin
        n_cands += match_dets(cf, cp, thr, margin)
    torch.cuda.synchronize()
    launches, want = counts(nms_per_class=4, stem_pair=12)
    log(f"phase 3 ok: {n_dets} detections matched on CUDA and CPU; golden "
        f"gates met on CUDA (max |prob err| {golden_err}); {n_cands} "
        f"candidates matched between the fused and plain engines; "
        f"launches {launches}, the stem's by path {BS.paths} [{gpu}]")
    assert launches == want, launches
    assert BS.paths == {k: 3 * n for k, n in stem_paths.items()}, BS.paths

    # ---------------------------------------------------------- phase 4
    req = b"".join(struct.pack("<3if", f.shape[1], f.shape[0], f.shape[2],
                               thresh) + f.astype("<f4").tobytes()
                   for f in frames) + struct.pack("<3if", 0, 0, 0, 0.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.infer.serve",
         str(cfg), str(weights)], cwd=ROOT, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(req, timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err.decode()[-2000:]
    magic, nw, nh, n_boxes, classes = struct.unpack("<5i", out[:20])
    assert (magic, nw, nh, n_boxes, classes) == (0x53524456, 416, 416, 845,
                                                 20)
    per = 4 * n_boxes * (4 + classes)
    assert len(out) == 20 + 3 * per
    for i, f in enumerate(frames):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        wb, wp = det.predict_batch(det.preprocess(f)[None], thresh=thresh)
        assert np.allclose(blob[:n_boxes * 4].reshape(-1, 4),
                           wb[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
        assert np.allclose(blob[n_boxes * 4:].reshape(-1, classes),
                           wp[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
    log(f"phase 4 ok: the server answered 3 requests, equal to the "
        f"in-process Detector [{gpu}]")

    # ---------------------------------------------------------- phase 5
    # every comparison in turns (plain, kernel, kernel, plain): readings
    # drift within a run and differ between machines
    def abba(name, kernel_fn, plain_fn, iters=50, plain_iters=50):
        warm = min(5, plain_iters)      # slow plain versions: few warm-ups
        p1 = cuda_ms(plain_fn, plain_iters, warm)
        k1, k2 = cuda_ms(kernel_fn, iters), cuda_ms(kernel_fn, iters)
        p2 = cuda_ms(plain_fn, plain_iters, warm)
        log(f"time {name}: kernel {(k1 + k2) / 2} ms ({k1}, {k2}), plain "
            f"{(p1 + p2) / 2} ms ({p1}, {p2}) [{gpu}]")
        return (k1 + k2) / 2, (p1 + p2) / 2

    # the NMS kernel at the main path's shapes: one frame's candidates
    fb, fp = det.predict_batch(det.preprocess(frames[0])[None],
                               thresh=thresh)
    tb, tp, _ = B.topk_candidates(fb[0], fp[0], 128)
    times = {
        "nms_per_class": abba(
            "nms_per_class C=20 k=128",
            lambda: NMS.nms_per_class(tb, tp, 0.4),
            lambda: NMS.nms_per_class_plain(tb, tp, 0.4), plain_iters=10),
        "stem_pair": abba("stem, 4 chained pairs @416",
                          lambda: stem_fn(x), lambda: plain_stem(x)),
    }
    # the chain and each pair replayed from a CUDA graph: the device time
    # without the host's launch cost, which sets the kernel's figures
    # above (the plain chain's are device time); the kernels line carries
    # the chain's graph time
    nms_graph = graph_ms(lambda: NMS.nms_per_class(tb, tp, 0.4), 50)
    nms_floor = graph_ms(lambda: NMS.empty_launch(*tp.shape, dev), 50)
    times["nms_per_class"] = (nms_graph, times["nms_per_class"][1])
    log(f"time nms_per_class C=20 k=128 (a frame's candidates) from a CUDA "
        f"graph: {nms_graph} ms; launch floor {nms_floor} ms [{gpu}]")
    stem_graph = {"chain": graph_ms(lambda: stem_fn(x))}
    times["stem_pair"] = (stem_graph["chain"], times["stem_pair"][1])
    log(f"time stem, 4 chained pairs @416 from a CUDA graph: "
        f"{stem_graph['chain']} ms [{gpu}]")
    for (xi, w, b), (ci, _) in zip(pair_inputs, pairs):
        l = fspec.layers[ci]
        abba(f"stem pair {l.c}->{l.filters} @{l.h}",
             lambda: BS.stem_pair(xi, w, b),
             lambda: BS.stem_pair_plain(xi, w, b))
        stem_graph[ci] = graph_ms(lambda: BS.stem_pair(xi, w, b))
        log(f"time stem pair {l.c}->{l.filters} @{l.h} from a CUDA graph: "
            f"{stem_graph[ci]} ms [{gpu}]")
    abba("LatencyEngine 416 bf16 per u8 frame (kernel = fused stem)",
         lambda: fused(u8[0]), lambda: plain(u8[0]))
    xin = torch.from_numpy(det.preprocess(frames[0])[None]).to(dev)
    log(f"time Detector.predict_batch 416 f32 batch 1: "
        f"{cuda_ms(lambda: det.predict_batch(xin), iters=20)} ms [{gpu}]")
    log(f"time Detector.detect 416 f32 (host resize + NMS kernel): "
        f"{cuda_ms(lambda: det.detect(frames[0], thresh=thresh), iters=10)}"
        f" ms [{gpu}]")

    # bounds of the batch-1 kernels at the timed shapes: NMS reads the
    # probs and its live candidates' boxes, writes the kept probs once and
    # tests each pair of live boxes of a class once; the stem chain reads
    # each pair's input, weights and bias and writes its output once
    bounds = {"nms_per_class": nms_bound(tb, tp)}
    log(f"bound nms_per_class C=20 k=128: {bounds['nms_per_class'][0]} ms "
        f"by {bounds['nms_per_class'][1]}; the launch floor {nms_floor} ms "
        f"sets what a launch can take; kernel {nms_graph / nms_floor:.1f}x "
        f"the floor [{gpu}]")
    n_bytes = n_ops = 0
    for (w, b), (ci, _) in zip(packed, pairs):
        l = fspec.layers[ci]
        p_bytes = (2 * (l.h * l.w * l.c + l.out_h // 2 * l.out_w // 2
                        * l.filters) + 2 * w.numel() + 4 * b.numel())
        p_ops = 2 * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "bf16")
        log(f"bound stem pair {l.c}->{l.filters} @{l.h}: {b_ms} ms by "
            f"{b_by} [{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops
    bounds["stem_pair"] = bound(n_bytes, n_ops, "bf16")

    # ---------------------------------------------------------- phase 6
    from sr_object_detection_tpu_torch.infer.engine import (
        ThroughputEngine, best_latency_engine)
    from sr_object_detection_tpu_torch.infer.quant import (
        QuantizedThroughputEngine)
    qspec = tiny_yolo_voc(width=NET, height=NET)
    qparams_np = random_bn(init_params(qspec, seed=0), 1, head_gain=8.0)
    calib_q = rng.uniform(0, 1, (8, NET, NET, 3)).astype(np.float32)
    q_stem = QuantizedThroughputEngine(qspec, qparams_np, batch=BATCH,
                                       device=dev, calib_x=calib_q,
                                       phase_stem=True)
    q_plain = QuantizedThroughputEngine(qspec, qparams_np, batch=BATCH,
                                        device=dev, calib_x=calib_q)
    qn = q_stem.qnet
    qpairs = PS.plan_pairs(qn.spec)
    assert qpairs == [(0, 1), (2, 3), (4, 5), (6, 7)], qpairs
    ps_err = 0
    # the K fold of each pair's tensor-core GEMM (kernels/phase_stem.py)
    pair_folds = ("taps", "tap_pairs", "chunks", "chunks")
    for k, (ci, _) in enumerate(qpairs):
        l = qn.spec.layers[ci]
        for x_dtype in ([np.uint8, np.float32, np.int8] if k == 0
                        else [np.int8]):
            PS.reset_launches()
            case = phase_pair_case(100 + k, BATCH, l.h, l.c, l.filters,
                                   x_dtype)
            args = (*(torch.from_numpy(a).to(dev) for a in case[:4]),
                    float(case[4]),
                    None if case[5] is None else float(case[5]))
            got = PS.stem_pair_i8(*args)
            assert PS.folds[pair_folds[k]] == PS.launches == 1, PS.folds
            ref = PS.stem_pair_i8_plain(*args)
            torch.cuda.synchronize()
            err = (got.int() - ref.int()).abs().max().item()
            assert torch.equal(got, ref), (l.c, l.filters, x_dtype, err)
            ps_err = max(ps_err, err)
            del args, got, ref
        torch.cuda.empty_cache()
        log(f"  int8 stem pair {l.c}->{l.filters} @{l.h} B={BATCH}: "
            f"kernel == plain (tensor cores, {pair_folds[k]} fold)")
    # the engine's own chain from u8 frames, link by link (same input to
    # kernel and plain), then whole
    frames_u8 = torch.from_numpy(rng.integers(
        0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)).to(dev)
    links = [(qn.qparams[ci]["weights"], qn.qparams[ci]["dequant"],
              qn.qparams[ci]["biases"],
              float(np.float32(1.0 / qn.act_scales[ci])))
             for ci, _ in qpairs]
    inv_u8 = float(np.float32(1.0 / (255.0 * qn.in_scale)))

    def int8_chain(v, pair_fn):
        for w, dq, b, inv_out in links:
            v = pair_fn(v, w, dq, b, inv_out,
                        inv_u8 if v.dtype == torch.uint8 else None)
        return v
    v = frames_u8
    ps_inputs = []       # each pair's input on the engine's chain
    for (w, dq, b, inv_out), (ci, _) in zip(links, qpairs):
        ii = inv_u8 if v.dtype == torch.uint8 else None
        ps_inputs.append((qn.spec.layers[ci], (v, w, dq, b, inv_out, ii)))
        out = PS.stem_pair_i8(v, w, dq, b, inv_out, ii)
        assert torch.equal(out, PS.stem_pair_i8_plain(v, w, dq, b, inv_out,
                                                      ii))
        v = out
    # two launches on the same input: bit-equal
    assert torch.equal(PS.stem_pair_i8(*ps_inputs[0][1]),
                       PS.stem_pair_i8(*ps_inputs[0][1]))
    n_stem = qpairs[-1][1] + 1
    assert torch.equal(qn.forward(frames_u8, stop=n_stem), v)
    assert torch.equal(int8_chain(frames_u8, PS.stem_pair_i8_plain), v)
    assert v.abs().max().item() > 60
    log(f"phase 6 ok: int8 stem kernel (phase_pair_tc_kernel, int8 tensor "
        f"cores) == plain at the 4 pair shapes at B={BATCH} (pair 1 from "
        f"u8 and float32 frames and from int8), link by link along the "
        f"engine's chain and whole, two launches bit-equal [{gpu}]")

    # ---------------------------------------------------------- phase 7
    bf = ThroughputEngine(qspec, qparams_np, batch=BATCH, device=dev)
    bf_stem = ThroughputEngine(qspec, qparams_np, batch=BATCH, device=dev,
                               phase_stem=True)
    assert bf_stem.phase_stem
    head = len(qspec.layers) - 2
    r = qspec.layers[-1]
    n_out = r.h * r.w * r.n * (r.coords + r.classes + 1)
    x_b128 = frames_u8.float() / 255.0
    reset_counts()
    out_bf = bf(x_b128)
    out_bfs = bf_stem(x_b128)
    out_s = q_stem(frames_u8)
    out_p = q_plain(frames_u8)
    torch.cuda.synchronize()
    # the bf16 stem: one fwd kernel a pair, no fwdstats, colsum or apply
    launches_b128, want = counts(phase_stem_pair=4, phase_train_fwd=4)
    assert launches_b128 == want, launches_b128
    # the int8 batch's four pairs on the tensor-core kernel, by K fold
    assert PS.folds == {"taps": 1, "tap_pairs": 1, "chunks": 2}, PS.folds
    # the stem's pairs 2-4 (Cin 16, 32, 64) on the tensor-core conv tile,
    # pair 1 (3 -> 16) on the tile's taps fold, none on the FP32-core path
    fwd_paths = dict(PT.conv_kernels["fwd"])
    assert fwd_paths == {"tensor_core": 3, "tensor_core_fold": 1,
                         "fp32_core": 0}, PT.conv_kernels
    # the bf16 phase stem link by link (the same input to each): the fwd
    # kernel torch.equal to fwdstats + apply with identity BN, within one
    # bf16 ulp of the plain engine's conv + pool layers (ROADMAP queue 3,
    # item 10: where two conv sums round apart, one ulp of the pooled
    # conv value more) and of fwd_pair_plain (assert_fwd_close: there the
    # bias add and the bf16 leaky round once more each)
    v = x_b128.to(torch.bfloat16)
    stem_link_err, fwd_err, fwd_links = 0.0, 0.0, []
    for ci in (0, 2, 4, 6):
        p = bf_stem.params[ci]
        l = qspec.layers[ci]
        cout = p["weights"].shape[0]
        zero = torch.zeros(cout, device=dev)
        one = torch.ones(cout, device=dev)
        w_hwio = p["weights"].permute(2, 3, 1, 0).contiguous()
        bias = p["biases"].float()
        got = PT.fwd_pair(v, w_hwio, bias)
        z, _, _ = PT.fwdstats(v, w_hwio, zero, one)
        comp = PT.apply(z, zero, one, one, bias)
        assert torch.equal(got, comp), (ci, (got != comp).sum().item())
        z_np = z.float().cpu().numpy()
        fwd_err = max(fwd_err, assert_fwd_close(
            got.float().cpu().numpy(),
            PT.fwd_pair_plain(v, w_hwio, bias).float().cpu().numpy(), z_np))
        with torch.no_grad():
            ref = bf._net.layers[ci + 1](bf._net.layers[ci](
                v.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        stem_link_err = max(stem_link_err, assert_stem_link_close(
            got.float().cpu().numpy(), ref.float().cpu().numpy(), z_np))
        fwd_links.append((l, v, w_hwio, bias))
        del z, comp, ref
        v = got
    assert torch.equal(bf_stem._stem(x_b128), v)
    torch.cuda.empty_cache()
    bfs_diff = (out_bfs.float() - out_bf.float()).abs().max().item()
    for o, dt in ((out_bf, torch.bfloat16), (out_bfs, torch.bfloat16),
                  (out_s, torch.float32), (out_p, torch.float32)):
        assert o.shape == (BATCH, n_out) and o.dtype == dt, o.shape
        assert torch.isfinite(o.float()).all()
    assert torch.equal(q_stem.qnet.forward(frames_u8, stop=head),
                       q_plain.qnet.forward(frames_u8, stop=head))
    out_diff = (out_s - out_p).abs().max().item()
    # equal unless cuDNN picked another algorithm for the bf16 head of
    # one engine: then within one bf16 step of the logits
    assert out_diff <= 2 ** -7, out_diff
    log(f"phase 7 ok: bf16 ThroughputEngine with and without the phase "
        f"stem (kernel 4's mode fwd, by path {fwd_paths}; "
        f"link by link torch.equal to fwdstats + apply, within one bf16 ulp "
        f"of fwd_pair_plain, max |err| {fwd_err}, and of the plain layers, "
        f"max |err| {stem_link_err}; whole outputs max |diff| {bfs_diff}) "
        f"and int8 engines at B={BATCH} "
        f"@{NET} on u8 frames: outputs finite, (B, {n_out}); int8 trunk "
        f"equal with and without the phase stem, outputs "
        f"{'equal' if out_diff == 0 else f'max |diff| {out_diff}'}; "
        f"launches {launches_b128} [{gpu}]")

    # ---------------------------------------------------------- phase 8
    # the trained A/B model of tests/golden/map_ab.npz on its synthetic
    # set: random weights give flat probs, closer together than the
    # shift that a one-ulp change of a calibrated scale causes (CUDA and
    # CPU calibrate with sums in other orders), so det-for-det matching
    # needs a model that separates its detections
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    from tools.synth_dataset import make_dataset
    g = np.load(GOLDEN / "map_ab.npz")
    list_path, gt = make_dataset(str(WORK / "map_ab"), int(g["n_images"]),
                                 int(g["seed"]))
    (WORK / "map_ab.cfg").write_text(bytes(g["cfg"]).decode())
    (WORK / "map_ab.weights").write_bytes(bytes(g["weights"]))
    ab = (str(WORK / "map_ab.cfg"), str(WORK / "map_ab.weights"))
    paths = [l.strip() for l in open(list_path) if l.strip()]
    d32 = Detector(*ab, device=dev)
    calib_ab = np.stack([d32.preprocess(load_image_rgb(p))
                         for p in paths[:8]])
    d8 = Detector(*ab, device=dev, int8_calib=calib_ab)
    d8_cpu = Detector(*ab, device="cpu", int8_calib=calib_ab)
    thr8, margin8 = 0.15, 0.02
    n_dets8, p_diff = 0, 0.0
    for path in paths:
        img = load_image_rgb(path)
        xf = d8.preprocess(img)[None]
        p_diff = max(p_diff, (d8.predict_batch(xf)[1].cpu()
                              - d8_cpu.predict_batch(xf)[1]).abs().max()
                     .item())
        got, want = (
            [(d.class_id, d.prob, np.asarray(d.box)) for d in
             d_.detect(img, thresh=thr8 - margin8)] for d_ in (d8, d8_cpu))
        n_dets8 += match_dets(got, want, thr8, margin8, require=False)
    assert n_dets8 > 0 and p_diff <= margin8, (n_dets8, p_diff)
    map32 = voc_map(d32, paths, gt, float(g["thresh"]), float(g["nms"]))
    map8 = voc_map(d8, paths, gt, float(g["thresh"]), float(g["nms"]))
    assert map32 > 0.2 and abs(map8 - map32) <= 0.05, (map32, map8)
    # the 416 int8 Detector (served in phase 9) and LatencyEngine
    calib8 = det.preprocess(frames[0])[None]
    det8 = Detector(str(cfg), str(weights), device=dev, int8_calib=calib8)
    lat8 = LatencyEngine(spec, params_np, device=dev, int8_calib=calib8)
    bx8, pr8 = lat8(u8[0])
    assert bx8.shape == (64, 4) and pr8.shape == (64, 20)
    assert torch.isfinite(bx8).all() and torch.isfinite(pr8).all()
    log(f"phase 8 ok: int8 Detector (map_ab model), {n_dets8} detections "
        f"matched on CUDA and CPU within {margin8} (max |prob diff| before "
        f"NMS {p_diff}); mAP on CUDA f32 {map32}, int8 {map8}; 416 int8 "
        f"LatencyEngine candidates finite [{gpu}]")

    # ---------------------------------------------------------- phase 9
    proc = subprocess.Popen(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.infer.serve",
         str(cfg), str(weights), "--int8"], cwd=ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(req, timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err.decode()[-2000:]
    assert struct.unpack("<5i", out[:20]) == (0x53524456, 416, 416, 845, 20)
    assert len(out) == 20 + 3 * per
    for i, f in enumerate(frames):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        wb, wp = det8.predict_batch(det8.preprocess(f)[None], thresh=thresh)
        assert np.allclose(blob[:n_boxes * 4].reshape(-1, 4),
                           wb[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
        assert np.allclose(blob[n_boxes * 4:].reshape(-1, classes),
                           wp[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
    log(f"phase 9 ok: the server with --int8 answered 3 requests, equal to "
        f"the in-process int8 Detector [{gpu}]")

    # --------------------------------------------------------- phase 10
    times["phase_stem_pair"] = abba(
        f"int8 stem, 4 chained pairs @{NET} B={BATCH} from u8 frames",
        lambda: int8_chain(frames_u8, PS.stem_pair_i8),
        lambda: int8_chain(frames_u8, PS.stem_pair_i8_plain), iters=20,
        plain_iters=5)
    # each pair on its input along the engine's chain (pair 1 from u8
    # frames) beside its bound: its input read once, weights, dq and bias
    # read once, its output written once
    n_bytes = n_ops = 0
    for l, args in ps_inputs:
        p_ms, _ = abba(f"int8 stem pair {l.c}->{l.filters} @{l.h} "
                       f"B={BATCH}", lambda: PS.stem_pair_i8(*args),
                       lambda: PS.stem_pair_i8_plain(*args), iters=20,
                       plain_iters=5)
        p_bytes = (args[0].numel() * args[0].element_size()
                   + 9 * l.c * l.filters + 8 * l.filters
                   + BATCH * (l.h // 2) * (l.w // 2) * l.filters)
        p_ops = 2 * BATCH * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "int8")
        log(f"bound int8 stem pair {l.c}->{l.filters} @{l.h}: {b_ms} ms by "
            f"{b_by} ({p_bytes} bytes, {p_ops} int8 ops); kernel "
            f"{p_ms / b_ms:.2f}x its bound [{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops
    # the chain moves each intermediate twice (written, then read), as the
    # pairs' sum counts it
    bounds["phase_stem_pair"] = bound(n_bytes, n_ops, "int8")
    log(f"bound int8 stem chain: {bounds['phase_stem_pair'][0]} ms by "
        f"{bounds['phase_stem_pair'][1]} ({n_bytes} bytes, {n_ops} int8 "
        f"ops) [{gpu}]")
    # the bf16 serving stem (kernel 4's mode fwd): each pair on its input
    # along the engine's chain, in turns with fwd_pair_plain and from a
    # CUDA graph, beside its bound (input read once, weights and bias read
    # once, output written once; or its bf16 products); then the chain
    n_bytes = n_ops = 0
    for l, xi, w_hwio, bias in fwd_links:
        tag = f"{l.c}->{l.filters} @{l.h} B={BATCH}"
        p_ms, _ = abba(f"bf16 serving stem pair (fwd kernel) {tag}",
                       lambda: PT.fwd_pair(xi, w_hwio, bias),
                       lambda: PT.fwd_pair_plain(xi, w_hwio, bias), iters=20,
                       plain_iters=3)
        g_ms = graph_ms(lambda: PT.fwd_pair(xi, w_hwio, bias), 10)
        p_bytes = (2 * xi.numel() + 2 * w_hwio.numel() + 4 * bias.numel()
                   + 2 * BATCH * (l.h // 2) * (l.w // 2) * l.filters)
        p_ops = 2 * BATCH * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "bf16")
        log(f"bound bf16 serving stem pair {tag}: {b_ms} ms by {b_by}; "
            f"kernel {p_ms / b_ms:.2f}x in turns, from a CUDA graph {g_ms} "
            f"ms ({g_ms / b_ms:.2f}x) [{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops
    x_bf = x_b128.to(torch.bfloat16)

    def plain_fwd_chain(v):
        for _, _, w_hwio, bias in fwd_links:
            v = PT.fwd_pair_plain(v, w_hwio, bias)
        return v
    times["phase_train_fwd"] = abba(
        f"bf16 serving stem, 4 chained pairs @{NET} B={BATCH} (fwd kernel)",
        lambda: bf_stem._stem(x_bf), lambda: plain_fwd_chain(x_bf), iters=20,
        plain_iters=3)
    bounds["phase_train_fwd"] = bound(n_bytes, n_ops, "bf16")
    log(f"time bf16 serving stem chain from a CUDA graph: "
        f"{graph_ms(lambda: bf_stem._stem(x_bf), 5)} ms; bound "
        f"{bounds['phase_train_fwd'][0]} ms by "
        f"{bounds['phase_train_fwd'][1]} [{gpu}]")
    del x_bf
    torch.cuda.empty_cache()

    bf.warmup()
    bf_stem.warmup()
    for name, eng in (("plain", bf), ("phase stem", bf_stem),
                      ("phase stem", bf_stem), ("plain", bf)):
        r_bf = eng.benchmark(iters=20, warmup=3)
        log(f"time ThroughputEngine bf16 B={BATCH} @{NET}, {name}: "
            f"{r_bf['images_per_sec']} images/s ({r_bf['sec_per_batch']} "
            f"s/batch) [{gpu}]")
    q_plain.warmup()
    q_stem.warmup()
    turns = [(name, eng.benchmark(iters=20, warmup=3,
                                  input_dtype=torch.uint8))
             for name, eng in (("plain", q_plain), ("phase stem", q_stem),
                               ("phase stem", q_stem), ("plain", q_plain))]
    for name, rr in turns:
        log(f"time int8 engine B={BATCH} @{NET} u8 frames, {name}: "
            f"{rr['images_per_sec']} images/s ({rr['sec_per_batch']} "
            f"s/batch) [{gpu}]")
    i8_ms = lat8.device_benchmark(reps=50)["device_ms_per_frame"]
    log(f"time int8 LatencyEngine @416 per frame (CUDA events, 50 queued "
        f"frames): {i8_ms} ms [{gpu}]")
    best = best_latency_engine(spec, params_np, device=dev,
                               int8_calib=calib8, reps=50)
    log(f"best_latency_engine selection @416: {best.selection} [{gpu}]")

    # --------------------------------------------------------- phase 11
    profile("LatencyEngine 416 bf16 fused stem, per frame",
            lambda: fused(u8[0]), 20, gpu)
    profile("LatencyEngine 416 bf16 plain, per frame",
            lambda: plain(u8[0]), 20, gpu)
    profile("Detector.predict_batch 416 f32, per frame",
            lambda: det.predict_batch(xin), 20, gpu)
    profile(f"ThroughputEngine bf16 B={BATCH} @{NET}, per batch",
            lambda: bf(frames_u8.float() / 255.0), 5, gpu)
    name = f"ThroughputEngine bf16 + phase stem B={BATCH} @{NET}, per batch"
    seen = profile(name, lambda: bf_stem(frames_u8.float() / 255.0), 5, gpu)
    assert_conv_tensor_core(name, seen, 5, {
        "fwd_tc_kernel": 3, "fwd_fold_kernel": 1, "fwdstats_tc_kernel": 0,
        "fwdstats_fold_kernel": 0, "fwdstats_kernel": 0})
    assert not any(named(k, key) for k in ("colsum_kernel", "apply_kernel")
                   for key in seen), (name, seen)
    log(f"  {name}: no colsum_kernel or apply_kernel")
    name = f"int8 engine B={BATCH} @{NET} u8, phase stem, per batch"
    seen = profile(name, lambda: q_stem(frames_u8), 5, gpu)
    assert any("phase_pair_tc_kernel" in k for k in seen), (name, seen)
    assert not any(named("phase_pair_kernel", k) for k in seen), (
        name, seen)
    log(f"  {name}: the stem ran as phase_pair_tc_kernel (int8 tensor "
        f"cores), no phase_pair_kernel")
    profile(f"int8 engine B={BATCH} @{NET} u8, plain, per batch",
            lambda: q_plain(frames_u8), 3, gpu)


    # --------------------------------------------------------- phase 12
    # the training kernels against their plain versions at the training
    # pair's shape (416, B=128, 3 -> 16), TF32 off (disable_tf32 above)
    from sr_object_detection_tpu_torch.ops import conv as C
    from sr_object_detection_tpu_torch.ops import pooling as P
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    import torch.nn.functional as F
    tcase = train_case(12, BATCH, NET, 3, 16, dev)
    fold_before = dict(PT.conv_kernels["fwdstats"])
    train_errs = check_train_kernels(PT, tcase)
    x0, w0 = tcase["x"], tcase["w"]
    sh0, sc0, b0, dp0 = (tcase[k] for k in ("shift", "scales", "biases",
                                            "dp"))
    # fwdstats on the tile's taps fold (fwdstats_fold_kernel): one owner
    # and one order per sum, so two launches are bit-equal
    f1, f2 = (PT.fwdstats(x0, w0, sh0, sc0) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(f1, f2))
    del f1, f2
    assert PT.conv_kernels["fwdstats"] == {
        **fold_before, "tensor_core_fold":
            fold_before["tensor_core_fold"] + 3}, PT.conv_kernels
    # its time in turns with its plain version beside its bound: x read,
    # Z and the argmax written (the weights and constants are a few KB);
    # cuDNN's bf16 F.conv2d at the same shape for context only: it
    # computes the conv alone, without the pool, argmax and sums
    times["phase_train_fwdstats"] = abba(
        f"phase_train fwdstats (taps fold) {NET} B={BATCH} 3->16",
        lambda: PT.fwdstats(x0, w0, sh0, sc0),
        lambda: PT.fwdstats_plain(x0, w0, sh0, sc0), iters=20,
        plain_iters=5)
    h2 = NET // 2
    pooled_n = BATCH * h2 * h2 * 16
    x_bytes = 2 * BATCH * NET * NET * 3
    conv_ops = 2 * BATCH * NET * NET * 16 * 27
    bounds["phase_train_fwdstats"] = bound(
        x_bytes + 2 * 27 * 16 + 8 * 16 + 3 * pooled_n + 8 * 16, conv_ops,
        "bf16")
    xc0, wc0 = x0.permute(0, 3, 1, 2), w0.permute(3, 2, 0, 1).contiguous()
    conv0_ms = (cuda_ms(lambda: F.conv2d(xc0, wc0, padding=1), 10)
                + cuda_ms(lambda: F.conv2d(xc0, wc0, padding=1), 10)) / 2
    b_ms, b_by = bounds["phase_train_fwdstats"]
    log(f"bound phase_train fwdstats 3->16 @{NET}: {b_ms} ms by {b_by}; "
        f"kernel {times['phase_train_fwdstats'][0] / b_ms}x its bound; "
        f"reference F.conv2d bf16 (cuDNN, the conv alone) {conv0_ms} ms "
        f"[{gpu}]")
    del xc0
    # bwdg on the tensor cores: one owner and one order per sum, so two
    # launches on the same inputs are bit-equal
    z0, am0, st0 = PT.fwdstats_plain(x0, w0, sh0, sc0)
    n0 = BATCH * NET * NET
    mean0, _, inv0 = PT._batch_stats(st0, sh0, n0)
    tc_before = PT.bwdg_kernels["tensor_core"]
    bw1 = PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0)
    bw2 = PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0)
    assert all(torch.equal(a, b) for a, b in zip(bw1, bw2))
    assert PT.bwdg_kernels["tensor_core"] == tc_before + 2
    del bw1, bw2
    grad = check_pair_gradient(
        PT, C, P, pair_spec(NET, 3, 16), train_case(12, BATCH, NET, 3, 16,
                                                    dev, flat=False))
    torch.cuda.synchronize()
    log(f"phase 12 ok: training kernels == plain at {NET} B={BATCH} 3->16 "
        f"(max |err| {train_errs}); fwdstats on the taps fold and bwdg on "
        f"the tensor cores, two launches of each bit-equal; "
        f"phase_train_block gradient within "
        f"{grad['fused']} of a float64 evaluation of the unfused chain's "
        f"formulas (gate 1e-3), the bf16 unfused chain's weight gradient "
        f"{grad['chain']} from it; cotangent zeroed on {grad['masked']} of "
        f"the windows, where the two tie rules route apart [{gpu}]")
    torch.cuda.empty_cache()

    # --------------------------------------------------------- phase 13
    # the training slice at full width: tiny-yolo-voc 416, batch 128,
    # subdivisions 1, bf16 with the fused pair; input as bench.py's
    # training bench (uniform [0,1) from a seed, one box per image)
    tbase = tiny_yolo_voc()
    tspec = dataclasses.replace(tbase, net=dataclasses.replace(
        tbase.net, batch=BATCH, subdivisions=1))
    tparams = init_params(tspec, seed=0)
    xt = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 1, (BATCH, NET, NET, 3)).astype(np.float32)).to(dev)
    tt_np = np.zeros((BATCH, 30, 5), np.float32)
    tt_np[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    tt = torch.from_numpy(tt_np).to(dev)
    trainers = {
        "bf16 + phase_train": Trainer(tspec, tparams, device=dev,
                                      compute_dtype=torch.bfloat16,
                                      phase_train=True),
        "bf16": Trainer(tspec, tparams, device=dev,
                        compute_dtype=torch.bfloat16),
        "f32": Trainer(tspec, tparams, device=dev)}
    reset_counts()
    tr = trainers["bf16 + phase_train"]
    losses = [float(tr.step(xt, tt)["loss"]) for _ in range(3)]
    torch.cuda.synchronize()
    launches_train, want = counts(phase_train_fwdstats=3,
                                  phase_train_apply=3, phase_train_bwdg=3)
    assert launches_train == want, launches_train
    assert PT.conv_kernels["fwdstats"] == {
        "tensor_core": 0, "tensor_core_fold": 3,
        "fp32_core": 0}, PT.conv_kernels
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
    loss_plain = float(trainers["bf16"].step(xt, tt)["loss"])
    assert abs(losses[0] - loss_plain) <= 0.03 * abs(loss_plain) + 0.05, (
        losses[0], loss_plain)
    golden_cost_err = {name: check_train_golden(name, dev)
                       for name in sorted(TRAIN_GOLDENS)}
    log(f"phase 13 ok: Trainer tiny-yolo-voc {NET} B={BATCH} bf16 + "
        f"phase_train, 3 steps: losses {losses}; first step without the "
        f"pair {loss_plain}; launches {launches_train}; float32 Trainer on "
        f"CUDA reproduces the C-oracle goldens (max relative cost error "
        f"{golden_cost_err}) [{gpu}]")

    # --------------------------------------------------------- phase 14
    # `cli detector train -bf16` on the card, on 256 synthetic 500x375
    # PPM images with labels
    tcfg = WORK / "tiny-yolo-voc-train.cfg"
    tcfg.write_text(train_cfg_text(cfg.read_text(), batch=BATCH,
                                   subdivisions=1, max_batches=2))
    lst = write_ppm_dataset(WORK / "voc", 256, seed=14)
    backup = WORK / "backup"
    data_cfg = WORK / "voc.data"
    data_cfg.write_text(f"classes=20\ntrain={lst}\nbackup={backup}\n")
    final = backup / "tiny-yolo-voc-train_final.weights"
    final.unlink(missing_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.apps.cli",
         "detector", "train", str(data_cfg), str(tcfg), "-bf16"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    iters = [l for l in res.stdout.splitlines()
             if l.split(":")[0] in ("1", "2")]
    assert len(iters) == 2, res.stdout[-2000:]
    from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
    from sr_object_detection_tpu_torch.io.weights import load_weights
    cspec = parse_network_cfg(str(tcfg))
    got_w, seen_w = load_weights(cspec, str(final))
    init_w = init_params(cspec, seed=0)
    assert seen_w == 2 * BATCH
    assert not np.allclose(got_w[0]["weights"], init_w[0]["weights"])
    log(f"phase 14 ok: cli detector train -bf16 ran 2 iterations in "
        f"{time.perf_counter() - t0:.1f} s ({' | '.join(iters)}); "
        f"{final.name} loads, seen {seen_w}, weights moved [{gpu}]")

    # --------------------------------------------------------- phase 15
    # times, in turns (plain, kernel, kernel, plain): apply and bwdg at
    # the pair's shape beside their bounds (fwdstats: phase 12);
    # Trainer.step images/s (x0 ... inv0: phase 12's inputs)
    times["phase_train_apply"] = abba(
        f"phase_train apply {NET} B={BATCH} 16 ch",
        lambda: PT.apply(z0, mean0, inv0, sc0, b0),
        lambda: PT.apply_plain(z0, mean0, inv0, sc0, b0), iters=20,
        plain_iters=10)
    times["phase_train_bwdg"] = abba(
        f"phase_train bwdg {NET} B={BATCH} 3->16",
        lambda: PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0),
        lambda: PT.bwdg_plain(x0, dp0, z0, am0, mean0, inv0, sc0, b0),
        iters=10, plain_iters=3)
    bounds["phase_train_apply"] = bound(4 * pooled_n + 16 * 16,
                                        6 * pooled_n, "bf16")
    bounds["phase_train_bwdg"] = bound(
        x_bytes + 5 * pooled_n + 16 * 16
        + 4 * (2 * 16 + 27 * 16 + 27 + 27 * 27),
        2 * BATCH * NET * NET * 27 * 27 + 2 * pooled_n * 27, "bf16")
    for name in ("phase_train_apply", "phase_train_bwdg"):
        log(f"bound {name}: {bounds[name][0]} ms by {bounds[name][1]} "
            f"[{gpu}]")
    del z0, am0
    torch.cuda.empty_cache()

    from sr_object_detection_tpu_torch.infer.engine import analytic_flops
    step_flops = 3 * analytic_flops(tspec)           # per image
    PEAK_BF16 = PEAK_OPS_S["bf16"]

    order = ["bf16 + phase_train", "bf16", "f32", "f32", "bf16",
             "bf16 + phase_train"]
    rates = {}
    for name in order:
        ips = step_rate(trainers[name], xt, tt, 5)
        rates.setdefault(name, []).append(ips)
        log(f"time Trainer.step {name} {NET} B={BATCH}: {ips} images/s, "
            f"{ips * step_flops / 1e12} TFLOP/s, MFU "
            f"{ips * step_flops / PEAK_BF16} of the bf16 dense peak "
            f"[{gpu}]")

    # --------------------------------------------------------- phase 16
    name = f"Trainer.step bf16 + phase_train {NET} B={BATCH}, per step"
    assert_bwdg_tensor_core(name, profile(
        name, lambda: trainers["bf16 + phase_train"].step(xt, tt), 2, gpu,
        top=8))
    profile(f"Trainer.step bf16 (no pair) {NET} B={BATCH}, per step",
            lambda: trainers["bf16"].step(xt, tt), 2, gpu, top=8)
    settle_fwdstats_count(PT, lambda: Trainer(
        tspec, tparams, device=dev, compute_dtype=torch.bfloat16,
        phase_train=True), xt, tt, 3, gpu)

    # --------------------------------------------------------- phase 17
    # the opt-in training paths' kernels against their plain versions at
    # the main path's shapes: red, dy (+ dw) and dgrad at the chain's
    # second pair (416 -> 208x208, 16 -> 32, B=128), F2/B1/B2 at the five
    # fusable pairs' conv outputs (channels-last, as the conv writes them)
    h1 = NET // 2
    ccase = chain_case(17, BATCH, h1, 16, 32, dev)
    tc_before = {m: c["tensor_core"] for m, c in PT.conv_kernels.items()}
    chain_errs = check_chain_kernels(PT, ccase)
    # fwdstats on the tensor-core tile at the chain's pair 1, and on
    # general inputs the forward's Z and argmax against dy's recomputed y
    fcase = train_case(17, BATCH, h1, 16, 32, dev)
    fwd_tc_err = check_fwdstats(PT, fcase["x"], fcase["w"], fcase["shift"],
                                fcase["scales"])[0]
    del fcase
    g17 = torch.Generator(device=dev).manual_seed(17)
    x17 = torch.randn((BATCH, h1, h1, 16), generator=g17, device=dev).to(
        torch.bfloat16)
    w17 = (0.3 * torch.randn((3, 3, 16, 32), generator=g17,
                             device=dev)).to(torch.bfloat16)
    n_windows = check_y_consistency(PT, x17, w17,
                                    torch.linspace(-1, 1, 32, device=dev))
    del x17, w17
    assert {m: c["tensor_core"] - tc_before[m]
            for m, c in PT.conv_kernels.items()} == {
        "fwdstats": 2, "red": 1, "dy": 2, "fwd": 0}, PT.conv_kernels
    torch.cuda.empty_cache()
    stem_shapes = [(NET >> k, 16 << k) for k in range(5)]      # (H, C)
    stem_errs = {"f2": 0.0, "b1": 0.0, "b2": 0.0}
    paths_before = dict(FS.paths)
    for k, (h, c) in enumerate(stem_shapes):
        e = check_fused_stem_kernels(FS, stem_case(170 + k, BATCH, h, c,
                                                   dev))
        stem_errs = {n: max(stem_errs[n], e[n]) for n in e}
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    # channels-last pairs: F2, B1 (twice a shape) and B2 on the row kernels
    assert {k: FS.paths[k] - paths_before[k] for k in FS.paths} == {
        "f2_row": 5, "b1_row": 10, "b2_row": 5, "f2": 0, "b1": 0,
        "b2": 0}, FS.paths
    log(f"phase 17 ok: red, dy and dgrad == plain at {NET} B={BATCH} "
        f"{h1}x{h1} 16->32 (max |err| {chain_errs}), fwdstats there "
        f"(max |err| {fwd_tc_err}), the three on the tensor-core conv "
        f"tile; fwdstats' Z and argmax equal dy's recomputed y's pooled "
        f"extreme bit for bit on {n_windows} windows of general inputs; "
        f"F2, B1, B2 == plain "
        f"at (H, C) {stem_shapes} (max |err| {stem_errs}; F2, B1 and B2 "
        f"on the row kernels, B1 bit-equal across two launches) [{gpu}]")

    # --------------------------------------------------------- phase 18
    # the chain's second pair's gradient (dw, dscales, dbiases, dx) against
    # a float64 evaluation of the unfused chain's formulas; the fused op
    # against the unfused chain on the same conv output, at pair 2's shape
    # dw at 3e-3: the pair rounds its float32 dy to bf16, the evaluation
    # its float64 one; where the two sit on either side of a rounding
    # boundary they part by an ulp, which over 5.5 M positions moves dw
    # by about 1e-3 of its largest magnitude (1.25e-3 in the first run)
    l2 = tspec.layers[2]
    grad2 = check_pair_gradient(
        PT, C, P, l2, train_case(18, BATCH, h1, 16, 32, dev, flat=False),
        tol=3e-3, dx=1e-2)
    torch.cuda.empty_cache()
    y_fmt = F.conv2d(torch.zeros((1, h1, h1, 16), device=dev,
                                 dtype=torch.bfloat16).permute(0, 3, 1, 2),
                     torch.zeros((32, 16, 3, 3), device=dev,
                                 dtype=torch.bfloat16), padding=1)
    y_cl = y_fmt.is_contiguous(memory_format=torch.channels_last)
    fused_rel, fused_dy = check_fused_op(FS, C, P, stem_case(
        18, BATCH, h1, 32, dev, channels_last=y_cl))
    torch.cuda.synchronize()
    log(f"phase 18 ok: the chain's second pair at {NET} B={BATCH}: dw, "
        f"dscales, dbiases within {grad2['fused']} of a float64 evaluation "
        f"of the unfused chain's formulas (dy rounded to bf16 as the pair "
        f"rounds it; gate 3e-3), dx within {grad2['dx']} (gate 1e-2), the "
        f"unfused bf16 chain's weight gradient {grad2['chain']} from it, "
        f"cotangent zeroed on {grad2['masked']} of the windows; the fused "
        f"stem op at {h1}x{h1}x32 equals the unfused chain forward, scale "
        f"and bias gradients within {fused_rel}, dy max |diff| {fused_dy} "
        f"(one bf16 ulp); the conv writes "
        f"{'channels-last' if y_cl else 'NCHW'} [{gpu}]")
    torch.cuda.empty_cache()

    # --------------------------------------------------------- phase 19
    # the opt-in paths at full width: Trainer bf16 at 416 B=128, three
    # steps each, every kernel's launches counted from 0
    cfgs = {"bf16 + chain": dict(phase_train="chain"),
            "bf16 + phase_train + fused_stem": dict(phase_train=True,
                                                    fused_stem=True),
            "bf16 + fused_stem": dict(fused_stem=True)}
    per_step = {
        "bf16 + chain": dict(phase_train_fwdstats=2, phase_train_apply=2,
                             phase_train_red=1, phase_train_dy=1,
                             phase_train_dgrad=1, phase_train_bwdg=1),
        "bf16 + phase_train + fused_stem": dict(
            phase_train_fwdstats=1, phase_train_apply=1, phase_train_bwdg=1,
            fused_stem_f2=4, fused_stem_b1=4, fused_stem_b2=4),
        "bf16 + fused_stem": dict(fused_stem_f2=5, fused_stem_b1=5,
                                  fused_stem_b2=5)}
    # the conv kernels a step runs, by their profiler names: pair 1 of the
    # chain (16 -> 32) on the tensor-core tile, pair 0 (3 -> 16) on its
    # taps fold, none on the FP32-core loop
    conv_per_step = {
        "bf16 + chain": {"fwdstats_tc_kernel": 1, "red_tc_kernel": 1,
                         "dy_tc_kernel": 1, "fwdstats_fold_kernel": 1,
                         "fwdstats_kernel": 0},
        "bf16 + phase_train + fused_stem": {"fwdstats_fold_kernel": 1,
                                            "fwdstats_tc_kernel": 0,
                                            "fwdstats_kernel": 0},
        "bf16 + fused_stem": {"fwdstats_fold_kernel": 0,
                              "fwdstats_tc_kernel": 0,
                              "fwdstats_kernel": 0}}
    launches_opt, conv_opt = {}, {}
    for name, kw in cfgs.items():
        trainers[name] = Trainer(tspec, tparams, device=dev,
                                 compute_dtype=torch.bfloat16, **kw)
        reset_counts()
        ls = [float(trainers[name].step(xt, tt)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        got, want = counts(**{k: 3 * v for k, v in per_step[name].items()})
        assert got == want, (name, got)
        tc = {m: c["tensor_core"] for m, c in PT.conv_kernels.items()}
        assert tc == {m: 3 * conv_per_step[name].get(f"{m}_tc_kernel", 0)
                      for m in tc}, (name, PT.conv_kernels)
        assert PT.conv_kernels["fwdstats"]["tensor_core_fold"] == 3 * (
            conv_per_step[name]["fwdstats_fold_kernel"]), PT.conv_kernels
        assert not any(c["fp32_core"] for c in PT.conv_kernels.values()), (
            name, PT.conv_kernels)
        # the fused stem on the row kernels (channels-last y)
        assert FS.paths == {"f2_row": got["fused_stem_f2"],
                            "b1_row": got["fused_stem_b1"],
                            "b2_row": got["fused_stem_b2"], "f2": 0,
                            "b1": 0, "b2": 0}, (name, FS.paths)
        conv_opt[name] = tc
        assert all(np.isfinite(ls)) and ls[2] < ls[0], (name, ls)
        assert abs(ls[0] - loss_plain) <= 0.03 * abs(loss_plain) + 0.05, (
            name, ls[0], loss_plain)
        launches_opt[name] = got
        log(f"  Trainer {name} {NET} B={BATCH}, 3 steps: losses {ls}; "
            f"launches {dict((k, v) for k, v in got.items() if v)}")
    log(f"phase 19 ok: the chain, the pair + fused stem and the fused stem "
        f"train at {NET} B={BATCH} with the launch counts per step "
        f"{per_step}; first losses within 0.03*|loss| + 0.05 of the step "
        f"without kernels ({loss_plain}) [{gpu}]")

    # --------------------------------------------------------- phase 20
    # times, in turns: the six kernels beside their bounds, dgrad's
    # library call; Trainer.step images/s of the opt-in paths against
    # bf16 + phase_train
    cargs = [ccase[k] for k in ("x", "w", "dp", "mean", "inv", "scales",
                                "biases")]
    c123 = [ccase[k] for k in ("c1", "c2", "c3")]
    times["phase_train_red"] = abba(
        f"phase_train red {h1}x{h1} B={BATCH} 16->32",
        lambda: PT.red(*cargs), lambda: PT.red_plain(*cargs), iters=10,
        plain_iters=3)
    times["phase_train_dy"] = abba(
        f"phase_train dy (+dw) {h1}x{h1} B={BATCH} 16->32",
        lambda: PT.dy(*cargs, *c123), lambda: PT.dy_plain(*cargs, *c123),
        iters=10, plain_iters=2)
    times["phase_train_dgrad"] = abba(
        f"phase_train dgrad {h1}x{h1} B={BATCH} 32->16",
        lambda: PT.dgrad(ccase["d"], ccase["w"]),
        lambda: PT.dgrad_plain(ccase["d"], ccase["w"]), iters=10,
        plain_iters=5)
    d_nchw = ccase["d"].permute(0, 3, 1, 2)
    w_oihw = ccase["w"].permute(3, 2, 0, 1).contiguous()
    library = {"phase_train_dgrad": (
        cuda_ms(lambda: F.conv_transpose2d(d_nchw, w_oihw, padding=1), 10)
        + cuda_ms(lambda: F.conv_transpose2d(d_nchw, w_oihw, padding=1),
                  10)) / 2}
    log(f"time library F.conv_transpose2d bf16 (cuDNN) {h1}x{h1} B={BATCH} "
        f"32->16: {library['phase_train_dgrad']} ms [{gpu}]")
    n1 = BATCH * h1 * h1
    conv1 = 2 * n1 * 32 * 9 * 16
    bytes_w = 2 * 9 * 16 * 32 + 4 * 7 * 32
    bounds["phase_train_red"] = bound(
        2 * n1 * 16 + bytes_w + 2 * n1 // 4 * 32 + 4 * 2 * 32, conv1, "bf16")
    bounds["phase_train_dy"] = bound(
        2 * n1 * 16 + bytes_w + 2 * n1 // 4 * 32 + 2 * n1 * 32
        + 4 * 9 * 16 * 32, 2 * conv1, "bf16")
    bounds["phase_train_dgrad"] = bound(2 * n1 * 32 + 2 * 9 * 16 * 32
                                        + 2 * n1 * 16, conv1, "bf16")
    del ccase, cargs, d_nchw
    torch.cuda.empty_cache()
    # F2, B1 and B2 at the five fusable pairs' conv outputs (in the layout
    # the conv writes) from a CUDA graph, B1 and B2 also in turns, F2 in
    # turns at pair 2 (208x208, 32 channels), beside their bounds; per
    # window about 52, 64 and 36 float32 operations. The kernels line
    # carries pair 2's times.
    for k, (h, c) in enumerate(stem_shapes):
        scase = stem_case(20 + k, BATCH, h, c, dev, channels_last=y_cl)
        y2, dp2 = scase["y"], scase["dp"]
        k4 = [scase[n] for n in ("mean", "inv", "scales", "biases")]
        s123 = [scase[n] for n in ("c1", "c2", "c3")]
        tag = f"{h}x{h}x{c} B={BATCH}"
        before = dict(FS.paths)
        tb = {"fused_stem_b1": abba(
            f"fused_stem B1 {tag}", lambda: FS.b1(y2, dp2, *k4),
            lambda: FS.b1_plain(y2, dp2, *k4), iters=20, plain_iters=3),
            "fused_stem_b2": abba(
            f"fused_stem B2 {tag}", lambda: FS.b2(y2, dp2, *k4, *s123),
            lambda: FS.b2_plain(y2, dp2, *k4, *s123), iters=20,
            plain_iters=3)}
        # the same calls replayed from a CUDA graph: device time without
        # the host's launch cost, which bounds the figures above at the
        # small pairs
        if h == h1:
            tb["fused_stem_f2"] = abba(
                f"fused_stem F2 {tag}", lambda: FS.f2(y2, *k4),
                lambda: FS.f2_plain(y2, *k4), iters=20, plain_iters=5)
        tg = {"fused_stem_f2": graph_ms(lambda: FS.f2(y2, *k4)),
              "fused_stem_b1": graph_ms(lambda: FS.b1(y2, dp2, *k4)),
              "fused_stem_b2": graph_ms(lambda: FS.b2(y2, dp2, *k4,
                                                      *s123))}
        yb, win = y2.numel() * 2, y2.numel() // 4
        bb = {"fused_stem_f2": bound(yb + yb // 4 + 16 * c, 36 * win,
                                     "f32"),
              "fused_stem_b1": bound(yb + yb // 4 + 16 * c + 8 * c,
                                     52 * win, "f32"),
              "fused_stem_b2": bound(2 * yb + yb // 4 + 28 * c, 64 * win,
                                     "f32")}
        for n in tg:
            turns = (f"kernel {tb[n][0]} ms ({tb[n][0] / bb[n][0]} x), "
                     if n in tb else "")
            log(f"bound {n} {tag}: {bb[n][0]} ms by {bb[n][1]}; {turns}"
                f"from a CUDA graph {tg[n]} ms ({tg[n] / bb[n][0]} x); "
                f"launches by kernel "
                f"{ {m: FS.paths[m] - before[m] for m in FS.paths} } "
                f"[{gpu}]")
        if h == h1:
            times.update(tb)
            bounds.update(bb)
        del scase, y2, dp2
        torch.cuda.empty_cache()
    # fwdstats alone on the tensor-core conv tile at its three Cin >= 16
    # instances (the chain's pair 1, the serving stem's pairs 2-4) beside
    # its bound; cuDNN's bf16 F.conv2d at the same shapes for reference
    # only: it computes the conv alone, without the pool, argmax and sums
    g20 = torch.Generator(device=dev).manual_seed(20)
    conv_lib = {}
    for h, cin, cout in ((h1, 16, 32), (NET // 4, 32, 64),
                         (NET // 8, 64, 128)):
        xs = torch.rand((BATCH, h, h, cin), generator=g20,
                        device=dev).to(torch.bfloat16)
        ws = (0.3 * torch.randn((3, 3, cin, cout), generator=g20,
                                device=dev)).to(torch.bfloat16)
        sh = 0.1 * torch.randn(cout, generator=g20, device=dev)
        sc = torch.linspace(-1, 1, cout, device=dev)
        tag = f"{cin}->{cout} @{h}"
        k_ms, p_ms = abba(
            f"phase_train fwdstats (tensor-core tile) {tag} B={BATCH}",
            lambda: PT.fwdstats(xs, ws, sh, sc),
            lambda: PT.fwdstats_plain(xs, ws, sh, sc), iters=20,
            plain_iters=3)
        xc, wc = xs.permute(0, 3, 1, 2), ws.permute(3, 2, 0, 1).contiguous()
        conv_lib[tag] = (cuda_ms(lambda: F.conv2d(xc, wc, padding=1), 10)
                         + cuda_ms(lambda: F.conv2d(xc, wc, padding=1),
                                   10)) / 2
        pooled = BATCH * (h // 2) * (h // 2) * cout
        b_tc = bound(2 * BATCH * h * h * cin + 2 * 9 * cin * cout + 8 * cout
                     + 3 * pooled + 8 * cout,
                     2 * BATCH * h * h * cout * 9 * cin, "bf16")
        log(f"bound phase_train fwdstats {tag}: {b_tc[0]} ms by {b_tc[1]}; "
            f"reference F.conv2d bf16 (cuDNN, the conv alone) "
            f"{conv_lib[tag]} ms [{gpu}]")
        if cin == 16:
            times["phase_train_fwdstats_tc"] = (k_ms, p_ms)
            bounds["phase_train_fwdstats_tc"] = b_tc
        del xs, xc
    torch.cuda.empty_cache()
    for name in ("phase_train_red", "phase_train_dy", "phase_train_dgrad",
                 "fused_stem_f2", "fused_stem_b1", "fused_stem_b2"):
        log(f"bound {name}: {bounds[name][0]} ms by {bounds[name][1]} "
            f"[{gpu}]")
    order = ["bf16 + phase_train", *cfgs, *reversed(cfgs),
             "bf16 + phase_train"]
    for name in order:
        ips = step_rate(trainers[name], xt, tt, 5)
        log(f"time Trainer.step {name} {NET} B={BATCH}: {ips} images/s, "
            f"{ips * step_flops / 1e12} TFLOP/s, MFU "
            f"{ips * step_flops / PEAK_BF16} of the bf16 dense peak "
            f"[{gpu}]")

    # --------------------------------------------------------- phase 21
    for name in cfgs:
        before = PT.launches["fwdstats"]
        seen = profile(f"Trainer.step {name} {NET} B={BATCH}, per step",
                       lambda: trainers[name].step(xt, tt), 2, gpu, top=8)
        log(f"  {name}: fwdstats launches by the counter over the warm-up "
            f"step and the 2 profiled steps: "
            f"{PT.launches['fwdstats'] - before}")
        if per_step[name].get("phase_train_bwdg"):
            assert_bwdg_tensor_core(name, seen)
        if per_step[name].get("fused_stem_b1"):
            assert_fused_stem_rows(name, seen)
        assert_conv_tensor_core(name, seen, 2, conv_per_step[name])

    # --------------------------------------------------- phases 22-25
    log(f"  device memory before yolov2-608: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    yolo_kernels = yolov2_608(gpu, dev, reset_counts, counts)

    # --------------------------------------------------- phases 26-28
    trainers.clear()
    torch.cuda.empty_cache()
    log(f"  device memory before yolov2-608 training: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    yolo_train_kernels = yolov2_608_train(gpu, dev, reset_counts, counts)

    # --------------------------------------------------- phases 29-31
    torch.cuda.empty_cache()
    log(f"  device memory before yolo9000-416: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    yolo9000_kernels = yolo9000_416(gpu, dev, reset_counts, counts)

    # --------------------------------------------------- phases 32-35
    torch.cuda.empty_cache()
    log(f"  device memory before yolo9000-416 training: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    yolo9000_train_kernels = yolo9000_416_train(gpu, dev, reset_counts,
                                                counts)

    # --------------------------------------------------- phases 36-39
    torch.cuda.empty_cache()
    apps_kernels = detector_apps(gpu, dev, reset_counts, counts)

    # --------------------------------------------------- phases 40-43
    torch.cuda.empty_cache()
    d19_kernels = darknet19_224(gpu, dev, reset_counts, counts)

    # --------------------------------------------------- phases 44-47
    torch.cuda.empty_cache()
    d19_train_kernels = darknet19_224_train(gpu, dev, reset_counts, counts)

    # --------------------------------------------------- phases 48-51
    torch.cuda.empty_cache()
    v1_kernels = last_kinds(gpu, dev, reset_counts, counts)

    # --------------------------------------------------- phases 52-54
    torch.cuda.empty_cache()
    go_and_apps(gpu, dev, reset_counts, counts)

    replaces = {
        "nms_per_class": "sr_object_detection_tpu/kernels/nms_pallas.py:29",
        "stem_pair": "sr_object_detection_tpu/kernels/b1_stem.py:82",
        "phase_stem_pair":
            "sr_object_detection_tpu/kernels/phase_stem.py:235",
        "phase_train_fwdstats":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_fwdstats_tc":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_fwd":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_apply":
            "sr_object_detection_tpu/kernels/phase_train.py:722",
        "phase_train_bwdg":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_red":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_dy":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_dgrad":
            "sr_object_detection_tpu/kernels/phase_train.py:1256",
        "fused_stem_f2": "sr_object_detection_tpu/kernels/fused_stem.py:135",
        "fused_stem_b1": "sr_object_detection_tpu/kernels/fused_stem.py:170",
        "fused_stem_b2": "sr_object_detection_tpu/kernels/fused_stem.py:187"}
    sources = {name: "phase_train.cu" for name in replaces
               if name.startswith("phase_train")}
    sources.update(nms_per_class="nms.cu", stem_pair="phase_train.cu",
                   phase_stem_pair="phase_stem.cu", fused_stem_f2=
                   "fused_stem.cu", fused_stem_b1="fused_stem.cu",
                   fused_stem_b2="fused_stem.cu")
    # launches: each kernel's count on the main path that runs it
    main_counts = {**launches,
                   "phase_stem_pair": launches_b128["phase_stem_pair"],
                   **{k: v for k, v in launches_train.items()
                      if k.startswith("phase_train")},
                   **{k: launches_opt["bf16 + chain"][k] for k in
                      ("phase_train_red", "phase_train_dy",
                       "phase_train_dgrad")},
                   **{k: v for k, v in launches_opt["bf16 + fused_stem"]
                      .items() if k.startswith("fused_stem")},
                   "phase_train_fwdstats_tc":
                       conv_opt["bf16 + chain"]["fwdstats"],
                   "phase_train_fwd": launches_b128["phase_train_fwd"]}
    errs = {"nms_per_class": nms_err, "stem_pair": stem_err,
            "phase_stem_pair": ps_err,
            **{f"phase_train_{k}": v for k, v in train_errs.items()},
            **{f"phase_train_{k}": v for k, v in chain_errs.items()},
            "phase_train_fwdstats_tc": fwd_tc_err,
            "phase_train_fwd": fwd_err,
            **{f"fused_stem_{k}": v for k, v in stem_errs.items()}}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"sr_object_detection_tpu_torch/csrc/{sources[name]}",
         "replaces": replaces[name], "launches": main_counts[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1],
         # one PyTorch call computes dgrad's function (the conv's input
         # gradient); none computes per-class greedy NMS, conv + bias +
         # leaky + maxpool (+ requant), conv + BN statistics + pool, the
         # pooled BN apply with eps outside the sqrt, the gram-factored
         # backward, the recomputing BN-backward passes or the fused
         # BN/leaky/pool passes
         "library_ms": library.get(name)}
        for name in replaces] + yolo_train_kernels + yolo9000_train_kernels \
        + apps_kernels + d19_kernels + d19_train_kernels + v1_kernels
    log(json.dumps({"yolov2_608_kernels": yolo_kernels}))
    log(json.dumps({"yolo9000_416_kernels": yolo9000_kernels}))
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
