#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles the port's CUDA sources from this checkout, one
   nvcc per source, all started together; every kernel (select, shear,
   orbit, exact warp, kNN) must report 0 bytes of stack frame and no
   spills (ptxas);
3. kernels against their plain PyTorch versions:
   - K1 (steered rotate-select) and K2 (fused rotate-select-roll) with
     `torch.equal` (fp32 and bf16; C4, C8, D8; C in {3, 16}; random
     indices, shifts and reflections; and the full main-path shapes);
   - K1 and K2 bit for bit as integers against the plain version run on
     the same bit patterns: N in {1, 17, 31, 32, 33, 97, 224}, C4, D4, C8,
     D8, every k, negative shifts, a NaN payload and a -0.0 in every
     plane, on aligned sources (the word path where a row is whole 16-byte
     words) and on misaligned views (the element path); both paths
     required;
   - K3 (the channels-last select) bit for bit as integers against its
     plain version and against K1 on the same data in NCHW memory: N in
     {1, 31, 32, 33, 97, 224}, C in {1, 2, 3, 4, 5, 16}, 1-4 sources,
     every k, fp32 and bf16, a NaN payload and a -0.0 in every source, on
     aligned sources (word and tile paths) and on misaligned views (tile);
   - K5 (centered quarter turn) with `torch.equal`, K6 (three-shear
     residual) and K7 (exact bilinear warp) within 2e-6 * max|x| (fp32)
     and one bf16 ulp (bf16), on ragged small cases and the main-path
     shapes, fp32 and bf16, both padding modes, with a NaN rotation in
     every batch (its sample must be all NaN, the others finite);
   - K6 within that bar, its max |diff| logged (0 expected), on 144 wider
     cases: 17, 33, 97, 224, 24 x 40 and 256 x 256 (over the
     shared-memory limit), C in {1, 3, 4, 5, 8, 16}, both paddings and
     dtypes, each also on a misaligned view; the resident path with and
     without 16-byte words and the passes path required;
   - K5 bit for bit as integers (a NaN payload and a -0.0 in every input)
     and K7 within its bar on 120 wider cases: sizes 17, 33, 40, 97, 224,
     C in {1, 3, 4, 5, 8, 16}, both paddings and dtypes, so both launch
     paths of each (word, and tile or element); each also on a
     16-byte-misaligned view of the same values, which must take the tile
     (K5) or element (K7) path;
   - the gradient guard: K4, K5, K6, K7 and the fast warp, each with a
     CUDA input that requires grad, must raise under grad mode without
     launching and run under torch.no_grad();
4. discrete main path at full width: batch 256, 224 px, C8 GCNN energy
   (3 -> 8 channels, 3x3, 2 layers), ResNet-50 (10 classes) and the
   invert of a (256, 224, 224, 16) regular-rep map, in the two presets of
   bench.py, each on the loader's NHWC-contiguous batch put in the memory
   its ResNet-50 runs fastest on (`to_network_layout`, as the pipeline
   does): exact / fp32 (crop 0.9, resize 64, unpooled GCNN; NCHW memory,
   so the select is K1) and serving / bf16 (fast warp, fused-pool GCNN,
   crop 1.0, resize 56, bf16 output; NHWC memory: K3, then a channels-last
   ResNet-50); serving also on the same values in NCHW memory (K1), to
   compare the layouts. Launch counts
   are zeroed just before each preset and read just after; every kernel of
   the path must have launched. Outputs must be finite; the first samples
   must agree with the port's CPU run (plain kernels); and canonicalizing
   torch.rot90(x) must select the element shifted by two for at least 99%
   of the batch (serving: of the samples with a clear top-2 margin), with
   canonical images within 1e-4 (serving: equal at quarter turns). ResNet-50
   in bf16 is timed with its fp32 parameters and on a bf16 copy, in each
   layout;
5. continuous main path at full width: batch 256, 224 px,
   `SteerableNetwork(3, 4 fields per order, 5x5, 1 layer)`, crop 0.9,
   resize 64, rotation group, ResNet-50 and the scalar invert of a
   (256, 224, 224, 16) map, in two presets: exact / fp32 (K7 for
   canonicalize and invert) and serving / bf16 (fast warp K5 + K6, bf16
   network input, warp and output, bf16 ResNet-50). Launch counts as in
   phase 4. Outputs must be finite; the first 8 samples must agree with the
   port's CPU run; and in the exact preset, canonicalizing torch.rot90(x)
   must give the quarter-turned matrix rep within 1e-4 for at least 99% of
   the batch;
6. K8 (fused kNN) against its plain version: fp32 and bf16, N in
   {1, 6, 31, 100, 1000, 1024, 4096} (both block widths), D in {3, 4, 64,
   128}, k in {1, 4, 20, 128} (k <= N; k = 128 takes the rounds
   route), plus clouds with duplicated points, quantized-grid clouds,
   zero-padded clouds with -0.0 coordinates and a cloud with one NaN point
   (its indices must stay in [0, N), the other clouds must not change). At
   D <= 4 the indices must be `torch.equal`; at D > 4 a differing pick is
   admitted only where the two float64 squared distances lie within
   2 sqrt(D) fp32 roundings of |q|^2 + |p|^2, an fp32-level tie
   (`knn_agree`);
7. point-cloud main path at full width (the repo's ModelNet40
   configuration): batch 64, 1024 points, `VNSmall(n_knn=20, mean
   pooling, fused kNN)` canonicalize, DGCNN (k 20, emb 1024, 40 classes),
   and the point-valued invert; K8 must have launched 5 times (once at
   D = 3 for VNSmall, at D = 3, 64, 64, 128 for DGCNN). Outputs must be
   finite; the first 8 clouds must agree with the port's CPU run;
   canonicalizing x @ Q for random rotations Q must give the same
   canonical cloud (within 1e-3) and class for 95% of the clouds; the
   invert must give x back within 1e-4;
8. K4 (exact D4 orbit) against its plain version, bit for bit (compared as
   integers): fp32 and bf16, H in {1, 7, 33, 96, 224}, C in {1, 2, 3, 4,
   5, 8, 16}, B in {1, 5}, 1, 2 or 4 rotations, with and without
   reflections, sign +-1, a NaN and a -0.0 in every input, each on the
   aligned input and on a 16-byte-misaligned view; every launch path
   ("word", "tile", "chunk") must run;
9. group inference at full width: configs/default.yaml's canonicalizer
   (C4 GCNN, 3 -> 16 channels, 3x3, 2 layers, crop 0.9, resize 64, exact
   warp) built by the port's registry, ResNet-50 (10 classes), 224 px;
   `group_inference` on 64 images (the loader's NHWC batch) sweeps their
   C4 orbit (256 images), which the pipeline hands on in NCHW memory for
   the fp32 ResNet-50. K4 must launch once and K1 with one source (K1a) at
   least once. The
   metrics must be finite; each orbit element's canonical image must match
   element 0's within 1e-4 and its class be equal for 99% of the batch;
   acc_element_g must agree with the port's CPU run on the first 8 images;
   `vanilla_inference`'s test/acc must equal acc_element_0 and
   `make_eval_step`'s metrics be finite;
10. the optimized (orbit-scoring) canonicalizer at full width:
   configs/canonicalization/opt_group_equivariant.yaml (ConvNetwork 5x5,
   32 channels, 2 layers, 128-vector; D8; crop 0.9, resize 96; exact warp)
   built by the port's registry, and its D4 variant, on 128 images of
   96 px (the loader's NHWC batch, handed over in NCHW memory for the
   fp32 ResNet-50 by the pipeline's `canonicalize`). D8 orbits by static
   warps (no K4) and selects with two-source K1; D4 orbits by one K4
   launch (reflections) and selects with K1a. The canonicalizer is also
   timed on the NHWC batch itself (K3). Outputs must be finite; the first 8 images must
   agree with the port's CPU run; at D4, canonicalizing torch.rot90(x)
   must select the next rotation of the same coset for 99% of the batch
   (at a crop of 0.875, whose margins are equal);
11. the discrete trainer of bench.py:566-657 at full width (C8 GCNN,
   crop 0.9, resize 64, ResNet-50, batch 128 at 224 px, AdamW 1e-3,
   prior weight 100), bf16-fast and fp32-exact: the loss over 20 steps on
   one fixed batch (finite, falling), ms per step over 8 steps (CUDA
   events), img/s, peak memory and device time by kernel name of one step;
   a validation step on the loader's NHWC batch, which launches K3 (bf16)
   or, put in NCHW memory by the pipeline for the fp32 ResNet-50, K1;
12. one fp32-exact train step (SGD, dropout 0, batch 8) on the card
   against the same step on the CPU: loss, gradient norms, updates and
   BatchNorm statistics;
13. `invert_regular_fast_diff` forward and backward at (256, 224, 224, 16),
   C4, D4, C8, D8, fp32 and bf16: two K2 launches each, the cotangents
   against the CPU run of 8 samples, and the time;
14. the select kernels' gradients (K3, K1, K2 through `rotate_select` and
   `rotate_roll_select`) against the CPU's plain versions;
15. times (CUDA events, after warm-up), per preset: canonicalize +
   invert images/s, the canonicalizer's overhead over the bare ResNet-50,
   device time by kernel name for one canonicalize + invert and one
   ResNet-50 call (torch.profiler); for the point-cloud path,
   canonicalize clouds/s, DGCNN ms, canonicalize + DGCNN ms, the
   overhead and device time by kernel name; for group inference, images/s
   over the orbit and the orbit, canonicalize and ResNet-50 ms; for the
   optimized canonicalizer, canonicalize ms, canonicalize + ResNet-50 ms,
   the overhead over the bare ResNet-50 at 96 px and the canonicalizer's
   parts; and per kernel its time, its bound, its plain version's time,
   one PyTorch call's time where one computes the same function, its
   launches, the launch path each main-path launch took (`paths`: K1 and
   K2 must all have taken "word", K6 "resident") and, for K1 / K3 / K2,
   the time of its backward; for K6 also the time with clusters of one
   block (`one_block_ms`, the design that lost). Kernel and library
   times are medians of 5 windows of CUDA events, with their min and max,
   the kernel's and the library call's windows taking turns. The main
   paths' K4 launches must all have taken the "tile" path (C = 3);
16. continuous training at full width, bench.py's steer_train: the
   continuous presets' canonicalizer (batch 256, 224 px), canonicalize
   with training=True and the backward of sum(x_c) + 1e-3
   sum(matrix_rep^2) to the network's parameters, fast / bf16 (K5 and K6
   forward, once each; the closed-form backward of
   `warp_center_rotation_fast_diff`) and exact / fp32 (autograd through
   the sample coordinates, no kernel): launch counts asserted, gradients
   finite and non-zero (but the unused second frame vector's), a step on
   8 samples against the CPU (gradient
   norm relative 1e-3 fp32, 5e-2 bf16), ms per forward + backward and
   peak memory; then the scalar invert with training=True of a
   (256, 224, 224, 16) bf16 map, whose backward runs K5 and K6 on the
   map's cotangent (three launches of each in all, asserted);
17. the continuous trainer: configs/canonicalization/steerable.yaml
   (e2cnn, kernel 9, 16 fields per order, 2 layers, crop 0.9, resize 64)
   built by the port's registry, ResNet-50, batch 128 at 224 px, AdamW
   1e-3, prior weight 100, bf16-fast (K5 and K6 once a step, asserted)
   and fp32-exact (no kernel): the loss over 20 steps on one fixed batch
   (finite, falling), ms per step over 8 steps, img/s, peak memory and
   device time by kernel name of one step; one
   fp32-exact SGD step at batch 8 against the CPU with phase 12's bars
   (NormBatchNorm statistics counted with the BatchNorm ones), each
   gradient-norm and update bar raised to three times the CPU's own
   difference under a 1e-7 relative perturbation of the batch where that
   is larger (the step's conditioning, `train_vs_cpu`); then
   opt_steerable.yaml's canonicalizer (ConvNetwork 5x5, 32 channels, 2
   layers, a 4-vector; crop 0.9, resize 96) on 128 images: canonicalize
   with training=True and the backward of `steerable_optimization_loss`
   plus the prior, finite, timed;
18. the n-body family (no kernel of the port on its path; no select,
   shear, warp, kNN or orbit launch, asserted): bench.py's canonicalize
   (VNDeepSets hidden 16, 4 layers, "pv", 512 graphs of 5 bodies, fp32):
   SE(3) invariance within 1e-3, the invert within 1e-4, the first 8
   graphs within 1e-4 of the CPU run (each bar widened per graph by its
   frame's conditioning), ms (median of 5 windows), graphs/s,
   launches and device time of one call; examples/nbody/configs/
   default.yaml's trainer (VNDeepSets 16 x 4 with dropout 0.5, GNN 32 x 4,
   batch 100, AdamW(1e-3, wd 1e-12)) on data simulated on the card at the
   CLI's sizes (512 + 128 graphs, 5000 leaps; the simulation timed): the
   loss over 20 steps (finite, falling), ms per step, steps/s, the steps'
   peak memory, launches and device time of a step, one step at dropout 0
   against the CPU (bars as phase 17's: at least three times the CPU's own
   spread), one step each of the Transformer and VN-DeepSets predictors; the
   CLI (`equiadapt_tpu_torch.cli.nbody_train`): one epoch with a checkpoint
   in a temporary directory, then test mode from it, its test/mse equal
   (1e-6) to the trained state's on the same split;
19. the classification CLIs (`equiadapt_tpu_torch.cli.classification_train`
   and `classification_serve`), each run with the launch counts set to 0
   just before it and read just after, on data files the phase writes (random
   uint8 images from a seed), and the first K1 / K3 / K4 launch of each
   kind (kernel, dtype, sources, shape, alignment) in each run made again
   after it through its wrapper, on a copy of its inputs, against the plain
   version: bit-equal, by the same launch path (the `kernels` line lists
   these shapes under "cli_checks"): BASELINE config 1 (configs/default.yaml: C4
   GCNN 16 x 2, crop 0.9, resize 64, ResNet-50, batch 128) for one epoch on
   CIFAR-10 pickles (5 x 512 images: 20 steps), the loss finite, then test
   mode from its checkpoint, test/acc equal to the trained state's on the
   same batch, with `vanilla` inference (K1 on the eval path, its launch
   path recorded) and `group` inference (one K4 launch, "tile", and K1a);
   BASELINE config 2 (canonicalization=opt_group_equivariant: D8,
   ConvNetwork 5x5, 32 channels, 128-vector, resize 96; group-contrast
   weight 1) for one epoch on STL-10 binaries (1280 + 256 images of 96 px:
   10 steps; static-warp orbit, two-source K1 on the eval path), then test
   mode as for config 1; each config's step timed on the CLI's own state
   and batch (ms, img/s, peak memory); its D4 variant with a learned
   reference vector and artifact dummies (0.1) through `make_train_step`:
   one K4 launch a step ("tile"), the loss finite and its task and prior
   terms falling over 8 steps, one step against the CPU (dropout and
   dummies off) with phase 12's bars, raised to three times the CPU's own
   spread where larger (as phase 17's); the
   serving CLI at serving_bf16.yaml (C8, fused pool, fast warp, bf16,
   batch 256, 224 px) with fresh weights (K3) and on config 1's checkpoint
   at its own config (K3; every tensor of the served pipeline equal to
   the trained state's); then MFU: `count_flops` (meta copies, no device work)
   of one train step (forward and backward) of the discrete trainers of
   phase 11 and of the two CLI configs, and of the bare bf16 ResNet-50
   forward at batch 256, each over its measured time and the card's dense
   peak for its dtype (PEAK_FLOPS, by nvidia-smi name; null for another
   card);
20. point-cloud training and ShapeNet-Part segmentation (BASELINE config
   4): K8 against its plain version and timed beside its bound and the
   yardstick at (32, 2048, 3) and (32, 2048, 64), on clean Gaussian
   clouds and after `random_point_dropout` (heavy exact ties; at D > 4 a
   differing pick must be an fp32-level tie, `knn_agree`, and picks of
   equal features are counted), and at (64, 1024, 3) after dropout; part
   segmentation's eval at part_segmentation/configs/default.yaml's widths
   (batch 32 x 2048, VNSmall k 20, DGCNNPartSeg 50 / 16 / k 20 / emb
   1024): K8 launched 3 times at D <= 4 and twice at D > 4, finite
   logits, the first 2 clouds against the port's CPU run, the per-point
   part unchanged under random rotations for 95% of the points, ms and
   clouds/s; its training through the part-seg CLI's step (AdamW 1e-3) and
   config 4a's trainer (`make_pointcloud_train_step` on
   classification/configs/default.yaml with group_equivariant_fused.yaml,
   batch 64 x 1024, DGCNN 40 classes): the loss over 20 steps on one
   batch (finite, falling), K8's launches a step (asserted), ms per step,
   clouds/s, peak memory, launches and device time by kernel name, MFU
   (`train_step_flops` over the fp32 peak), and one step at dropout 0
   against the CPU at batch 4 with the same augmentation draws (phase 12's
   bars, raised to three times the CPU's own spread where larger); the
   CLIs `pointcloud_train` (config 4a, one epoch of 20 synthetic steps)
   and `partseg_train` (one epoch), each then in test mode from its
   checkpoint, with test metrics equal to the trained state's; each run
   counted on its own, its first K8 launch of each kind checked again
   against the plain version (`KnnLog`);
21. BASELINE config 5, prior-regularized SAM segmentation, at the ViT-B
   encoder's width (examples/images/segmentation/configs/default.yaml's
   canonicalizer: C4 GCNN 64 x 12, kernel 5, crop 0.8, resize 128;
   the registry's "sam_vit" SAMLite: SAM's encoder 12 x 768, window 14,
   global blocks 2, 5, 8, 11, 8 heads shared with the 256-wide decoder,
   4 mask tokens; random weights): K1a on (8, 4, 1024, 1024) fp32 mask
   planes (word path, and a misaligned view: element path) and K3 on
   (8, 1024, 1024, 3) fp32 images (tile path), bit-equal to their plain
   versions and timed beside their bounds, plain versions and
   `torch.gather`; the eval (batch 8 at 1024 px, 4 box prompts:
   canonicalize images and targets -> SAMLite -> `invert_masks`), launch
   counts zeroed before it and read after (K3 once on the images, K1a on
   the masks and on the inverted masks; asserted with their paths),
   outputs finite, the first sample against the port's CPU run, the C4
   shift of the selection and equal canonical images and masks under
   rot90; times of canonicalize with targets, the encoder, the decoder,
   the invert and the whole eval, peak memory; the mAP sweep over the 4
   rotations; the prior-regularized train step at batch 4 (AdamW 8e-4,
   prior 100; no kernel launch: the one-hot blend), every module moved,
   ms, peak memory; one step at encoder depth 2, 256 px, batch 2 against
   the CPU with phase 12's bars (raised to three times the CPU's own
   spread where larger); the segmentation CLI as the JAX one cuts it,
   train one epoch then test from the checkpoint, each run counted and
   its first K3 launches checked again;
22. item 15 (the rest of the harness): (a) BASELINE config 1's training
   CLI with `prediction.pretrained=true` on a random torchvision-layout
   ResNet-50 `.pth` (one epoch, then test mode from its checkpoint, each
   run counted and its first launches checked again): every tensor the
   converter fills equal to the file's before the first step, K1a in the
   test run; (b) `utils.export`: the serving pipeline (serving_bf16.yaml,
   batch 256, 224 px) exported at a fixed and at a symbolic batch, phase
   7's point-cloud canonicalizer and K8 alone, each graph holding its
   kernel's `eqt` operator; each artifact loaded here and in a fresh
   process importing only torch and equiadapt_tpu_torch launches K3 or K8
   once a call and answers as the live call (logits within the larger of
   two live calls' spread and one bf16 ulp of the largest logit; frames
   within 1e-6; kNN indices equal), the symbolic one at batch 256 and 64;
   the exported serving call timed in turns with the live one (ms, img/s);
   (c) the native loader (`native/`, built with the host compiler): two
   epochs of 1024 random 224 px uint8 images in batches of 256, each batch
   equal to the rows its order names, then streamed into the serving
   pipeline on the card (loader batches/s, end-to-end img/s, K3 once a
   batch); (d) MaskRCNNLite at config 5's scale (1024 px, 91 classes, 8
   instances, 128 channels, the ResNet-50 trunk converted from a random
   torchvision-layout state dict): the eval at batch 8 (no kernel launch),
   its first sample against the CPU, the AdamW step at batch 4, ms and
   peak memory of each, one step at 256 px, batch 2 against the CPU (bars
   three times the CPU's own spread where larger), and the experiment
   (`cli.maskrcnn_lite_experiment`) for 5 steps.

Weights are random, from fixed seeds. fp32 work runs with TF32 off. The
last line is {"ok": true, "device": {...}}; the lines before it hold the
n-body, classification-CLI, MFU, point-cloud-training, segmentation and
item-15 JSON lines, the
nvidia-smi line and the `kernels` JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

B, IMAGE, NUM_ROT, FEATURE_CH = 256, 224, 8, 16
DEVICE = "cuda"
SOURCE = "equiadapt_tpu_torch/csrc/select_warp.cu"
TPU_KERNEL = {
    "select_planes": "equiadapt_tpu/ops/pallas/select_warp.py:233",
    "select_planes_rolled": "equiadapt_tpu/ops/pallas/select_warp.py:630",
    "select_planes_nhwc": "equiadapt_tpu/ops/pallas/select_warp.py:503",
}
# the discrete presets: (canonicalizer, input layout) and the kernels each
# must launch; "serving" takes the loader's NHWC-contiguous batch (K3),
# "serving_nchw" the same values as a view of NCHW memory (K1)
PRESET_KERNELS = {
    "exact": ("select_planes/float32", "select_planes_rolled/float32"),
    "serving": ("select_planes_nhwc/bfloat16", "select_planes_rolled/bfloat16"),
    "serving_nchw": ("select_planes/bfloat16", "select_planes_rolled/bfloat16"),
}
# the trainer of bench.py:566-657: batch 128 at 224 px, AdamW(1e-3), prior
# weight 100; steps on one fixed batch, then timed steps
TRAIN_B, TRAIN_FALL_STEPS, TRAIN_TIMED_STEPS = 128, 20, 8
# the train step held against the CPU: fp32-exact, SGD, dropout 0
TRAIN_CPU_B = 8
# continuous training (bench.py's steer_train): the step on this many
# samples held against the CPU
CONT_TRAIN_CPU_B = 8
# continuous kernels: (source, TPU kernel's pallas_call)
CONT_KERNEL = {
    "rot90_centered_select": ("equiadapt_tpu_torch/csrc/shear_rotate.cu",
                              "equiadapt_tpu/ops/pallas/shear_rotate.py:358"),
    "shear_rotate_residual": ("equiadapt_tpu_torch/csrc/shear_rotate.cu",
                              "equiadapt_tpu/ops/pallas/shear_rotate.py:182"),
    "warp_rotate_center_exact": ("equiadapt_tpu_torch/csrc/bilinear_warp.cu",
                                 "equiadapt_tpu/ops/pallas/bilinear_warp.py:323"),
}
# kernels each continuous preset must launch
CONT_PRESET_KERNELS = {
    "continuous_exact": ("warp_rotate_center_exact/float32",),
    "continuous_serving": ("rot90_centered_select/bfloat16",
                           "shear_rotate_residual/bfloat16"),
}
# memory bandwidth of the card, bytes/s (NVIDIA data sheets)
BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12))
# fp32 rate outside the tensor cores, FLOP/s (NVIDIA data sheets)
FP32_RATE = (("H200", 67e12), ("H100 NVL", 60e12), ("H100 PCIe", 51e12),
             ("H100", 67e12))
# point-cloud path: examples/pointcloud/classification/configs/default.yaml
# with canonicalization/group_equivariant_fused.yaml
PC_B, PC_N, PC_K, PC_CLASSES, PC_EMB = 64, 1024, 20, 40, 1024
KNN_SOURCE = "equiadapt_tpu_torch/csrc/knn.cu"
KNN_TPU = "equiadapt_tpu/ops/pallas/knn.py:139"
# K8 launches of one point-cloud path run, by wrapper key
PC_KNN_LAUNCHES = {"knn_indices/float32/d<=4": 2, "knn_indices/float32/d>4": 3}
ORBIT_SOURCE = "equiadapt_tpu_torch/csrc/orbit.cu"
ORBIT_TPU = "equiadapt_tpu/ops/pallas/orbit.py:111"
# group inference: examples/images/classification/configs/default.yaml at
# bench.py's 224 px; the C4 orbit of 64 images is a batch of 256
GI_B, GI_CLASSES = 64, 10
# optimized canonicalizer: configs/canonicalization/opt_group_equivariant.yaml
# at STL-10 scale (bench.py:309)
OPT_B, OPT_IMAGE = 128, 96
# crop of the D4 shift-law check: ceil(96 * 0.875) = 84 leaves 6 px on each
# side, so crop and resize commute with rot90 (the yaml's 0.9 leaves 4 and 5)
OPT_SYMMETRIC_CROP = 0.875
# K4 at the paths' shapes: path -> (batch, side, channels, rotations,
# reflections, sign)
ORBIT_SHAPES = {"group_inference": (GI_B, IMAGE, 3, 4, False, 1.0),
                "optimized_d4": (OPT_B, OPT_IMAGE, 3, 4, True, -1.0)}
# timed windows behind each kernel time of the `kernels` line (the median,
# with the min and max beside it)
WINDOWS = 5
# n-body: bench.py:380-410's canonicalize preset (VNDeepSets hidden 16, 4
# layers, "pv"; 512 graphs of 5 bodies) and the trainer and CLI of
# examples/nbody/configs/default.yaml (batch 100, AdamW(1e-3, wd 1e-12))
NBODY_B, NBODY_N = 512, 5
NBODY_CONFIG = os.path.join("examples", "nbody", "configs", "default.yaml")
# phase 19, the classification CLIs: config 1 on CIFAR-10 pickles of
# CIFAR_PER_FILE images a file (20 steps of 128), config 2 on STL-10
# binaries (10 steps of 128); steps timed a CLI; optimized D4 steps
CLS_CONFIGS = os.path.join("examples", "images", "classification", "configs")
CIFAR_PER_FILE, STL_TRAIN, STL_TEST = 512, 1280, 256
CLI_TIMED_STEPS, OPT_D4_STEPS = 5, 8
# phase 20: BASELINE config 4b (part_segmentation/configs/default.yaml:
# batch 32 x 2048, VNSmall k 20; DGCNNPartSeg 50 parts, 16 categories, k 20,
# emb 1024), its step held against the CPU at PS_CPU_B clouds, and config
# 4a's trainer (classification/configs/default.yaml with
# group_equivariant_fused.yaml: PC_B x PC_N, DGCNN, 40 classes)
PS_B, PS_N, PS_K, PS_PARTS, PS_CATS, PS_EMB, PS_CPU_B = 32, 2048, 20, 50, 16, 1024, 4
PS_CONFIG = os.path.join("examples", "pointcloud", "part_segmentation", "configs",
                         "default.yaml")
PC_CONFIG = os.path.join("examples", "pointcloud", "classification", "configs",
                         "default.yaml")
# K8 launches of one part-segmentation forward: VNSmall's graph,
# TransformNet's and stage 0's at D = 3; stages 1 and 2 at D = 64
PS_KNN_LAUNCHES = {"knn_indices/float32/d<=4": 3, "knn_indices/float32/d>4": 2}
# K8 at phase 20's shapes: name -> (B, N, D, after random_point_dropout)
KNN_TRAIN_CASES = {"B32_N2048_D3": (PS_B, PS_N, 3, False),
                   "B32_N2048_D3_dropout": (PS_B, PS_N, 3, True),
                   "B32_N2048_D64": (PS_B, PS_N, 64, False),
                   "B32_N2048_D64_dropout": (PS_B, PS_N, 64, True),
                   "B64_N1024_D3_dropout": (PC_B, PC_N, 3, True)}
# dense peak rates by the card's nvidia-smi name, FLOP/s: NVIDIA H100 Tensor
# Core GPU datasheet, H100 SXM column: BF16 Tensor Core 989.4 TFLOP/s
# without sparsity, FP32 66.9 TFLOP/s (TF32 is off here)
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12}}
# phase 21: BASELINE config 5 (examples/images/segmentation/configs/
# default.yaml) at 1024 px: eval batch 8 of 4 box prompts, SAMLite with SAM's
# ViT-B-wide encoder (12 x 768) and 8 heads (the registry shares the count
# with the 256-wide decoder, and 12 does not divide 256); the train step at
# batch 4; the step against the CPU at encoder depth 2, 256 px, batch 2
SEG_B, SEG_IMAGE, SEG_PROMPTS, SEG_HEADS, SEG_TRAIN_B = 8, 1024, 4, 8, 4
SEG_CPU_B, SEG_CPU_IMAGE = 2, 256
SEG_CONFIG = os.path.join("examples", "images", "segmentation", "configs", "default.yaml")
# phase 22, item 15: the pretrained CLI run (config 1, a random torchvision
# ResNet-50 from PRE_SEED); the serving export at EXPORT_B (and a symbolic
# batch served at EXPORT_SMALL_B); MaskRCNNLite at config 5's scale (1024 px,
# 91 classes, 8 instances, 128 channels; eval batch DET_B, step batch
# DET_TRAIN_B; the step against the CPU at DET_CPU_IMAGE px, batch DET_CPU_B;
# the first sample against the CPU within DET_CPU_BAR of each output's
# largest value: fp32, TF32 off, summation order; DET_MASK_BAR for the masks
# of the predicted prompts); the native loader
PRE_SEED, EXPORT_SEED, DET_SEED, LOADER_SEED = 81, 83, 85, 91
EXPORT_B, EXPORT_SMALL_B, EXPORT_IMAGE = 256, 64, 224
DET_IMAGE, DET_CLASSES, DET_K, DET_CH, DET_B, DET_TRAIN_B = 1024, 91, 8, 128, 8, 4
DET_CPU_IMAGE, DET_CPU_B, DET_CPU_BAR, DET_MASK_BAR, DET_EXPERIMENT_STEPS = 256, 2, 1e-4, 1e-3, 5
LOADER_RECORDS, LOADER_B, LOADER_THREADS, LOADER_IMAGE = 1024, 256, 4, 224


def log(*a):
    print(*a, flush=True)


def rate_for(table, name: str, what: str) -> float:
    for key, value in table:
        if key in name:
            return value
    raise RuntimeError(f"no {what} figure for {name!r}")


def bandwidth_for(name: str) -> float:
    return rate_for(BANDWIDTH, name, "bandwidth")


def sync():
    torch.cuda.synchronize()


def ptxas_report(text: str):
    """Registers, stack frame, spill bytes and static shared memory of each
    kernel from nvcc's `-Xptxas -v` output: [{"kernel", "registers",
    "stack_frame", "spill_stores", "spill_loads", "smem"}] (dynamic shared
    memory is not in this report)."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "stack_frame": 0,
                   "spill_stores": 0, "spill_loads": 0, "smem": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            cur["stack_frame"] = max(cur["stack_frame"], int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"] = max(cur["spill_stores"], int(m.group(1)))
            cur["spill_loads"] = max(cur["spill_loads"], int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return rows


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10, windows: int = WINDOWS):
    """Device time in ms of one fn() from a CUDA graph of `reps` calls,
    replayed once a window (CUDA events): the launches run back to back,
    with no host time between them. (median, [min, max]) over `windows`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = sorted(cuda_ms(graph.replay, reps=1, warmup=1) / reps
                   for _ in range(windows))
    del graph
    return times[len(times) // 2], [times[0], times[-1]]


def windowed_ms(fns, reps: int, windows: int = WINDOWS, warmup: int = 2):
    """Device time in ms of each fn() of `fns` (name -> fn), by CUDA events
    over `windows` windows of `reps` calls, the fns taking turns window by
    window: {name: median over the windows, name + "_range": [min, max]}."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    for _ in range(windows):
        for name, fn in fns.items():
            times[name].append(cuda_ms(fn, reps=reps, warmup=0))
    out = {}
    for name, ts in times.items():
        ts = sorted(ts)
        out[name] = ts[len(ts) // 2]
        out[f"{name}_range"] = [ts[0], ts[-1]]
    return out


def check_kernels(sw, gen):
    """K1 and K2 against their plain versions; launches here are not counted
    as the main path's (the counts are zeroed before it)."""
    dev = DEVICE
    n_checked = 0
    cases = [(8, 72), (3, 40)]  # (batch, size): ragged 32x32 tiles
    for dtype in (torch.float32, torch.bfloat16):
        for group, (n, reflect) in {"C4": (4, False), "C8": (8, False),
                                    "D8": (8, True)}.items():
            G = 2 * n if reflect else n
            residues, src_of, k_of = sw._c_n_decomposition(n, 1.0)
            for b, size in cases:
                idx = torch.randint(0, n, (b,), generator=gen).to(dev)
                src = torch.tensor(src_of, device=dev)[idx].int()
                k = torch.tensor(k_of, device=dev)[idx].int()
                for C in (3, 16):
                    srcs = [torch.randn(b, C, size, size, generator=gen)
                            .to(dev, dtype) for _ in residues]
                    got = sw.select_planes(srcs, src, k)
                    ref = sw.select_planes_plain(srcs, src, k)
                    sync()
                    assert torch.equal(got, ref), ("K1", dtype, group, C, b, size)
                    n_checked += 1
                    if C % G:
                        continue
                    shift = torch.randint(-2 * n, 2 * n, (b,), generator=gen)
                    shift = shift.to(dev).int()
                    refl = (torch.randint(0, 2, (b,), generator=gen).to(dev).int()
                            if reflect else None)
                    got = sw.select_planes_rolled(srcs, src, k, shift, G, n, refl)
                    ref = sw.select_planes_plain(srcs, src, k, shift, refl, G, n)
                    sync()
                    assert torch.equal(got, ref), ("K2", dtype, group, C, b, size)
                    n_checked += 1
    log(f"kernel checks: {n_checked} small cases torch.equal to the plain versions")


def misaligned(x):
    """The values of x in a contiguous view that starts one element into its
    buffer: never 16-byte aligned."""
    v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view_as(x)
    return v.copy_(x)


def check_select_wide(sw, gen):
    """K1 and K2 bit for bit (as integers) against their plain versions run
    on the same bit patterns: N in {1, 17, 31, 32, 33, 97, 224}, C4, D4, C8
    and D8 (C = |G|), two sources, every k (some negative), negative and
    positive shifts, reflections, fp32 and bf16, a NaN payload and a -0.0 in
    every plane. Each case runs on aligned sources (the word path where a
    row is whole 16-byte words: N = 32, 224) and on 16-byte-misaligned views
    of them, which must take the element path. Launches here are not
    counted as the main paths'."""
    cases, paths = 0, set()
    for dtype in (torch.float32, torch.bfloat16):
        for group, (n, reflect) in {"C4": (4, False), "D4": (4, True),
                                    "C8": (8, False), "D8": (8, True)}.items():
            G = 2 * n if reflect else n
            for N in (1, 17, 31, 32, 33, 97, 224):
                b = 4 if N == 224 else 8
                srcs = []
                for _ in range(2):
                    x = torch.randn(b, G, N, N, generator=gen).to(dtype)
                    orbit_bits(x).flatten(2)[..., 0] = (
                        0x7FC00123 if x.element_size() == 4 else 0x7FC3)
                    x.flatten(2)[..., -1] = -0.0
                    srcs.append(x.to(DEVICE))
                src = torch.randint(0, 2, (b,), generator=gen).int().to(DEVICE)
                k = (torch.arange(b) % 4 - 4 * (torch.arange(b) % 3)).int().to(DEVICE)
                shift = torch.randint(-2 * n, 2 * n, (b,), generator=gen).int().to(DEVICE)
                refl = (torch.arange(b) // 2 % 2).int().to(DEVICE) if reflect else None
                words = [orbit_bits(s_) for s_ in srcs]
                ref1 = sw.select_planes_plain(words, src, k)
                ref2 = sw.select_planes_plain(words, src, k, shift, refl, G, n)
                for inp in (srcs, [misaligned(s_) for s_ in srcs]):
                    got1 = sw.select_planes(inp, src, k)
                    got2 = sw.select_planes_rolled(inp, src, k, shift, G, n, refl)
                    sync()
                    path = sw._rolled_path(inp, got1)
                    assert inp is srcs or path == "element", (N, path)
                    paths.add(path)
                    assert torch.equal(orbit_bits(got1), ref1), ("K1", dtype, N, path)
                    assert torch.equal(orbit_bits(got2), ref2), ("K2", dtype, group, N, path)
                cases += 1
    assert paths == {"word", "element"}, paths
    log(f"K1 / K2 wide checks: {cases} cases, each on aligned and misaligned "
        f"sources, bit-equal to the plain versions; paths {sorted(paths)}")
    return {"cases": cases, "paths": sorted(paths)}


def rotations(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def continuous_inputs(b, H, W, C, dtype, gen):
    """Images in [0, 1], quarter-turn indices (int32, as the fast warp
    hands them to K5), residual angles in [-pi/4, pi/4] and rotations over
    the circle; sample 0 of r and R is NaN (a zero steerable vector
    normalizes to a NaN rotation). Drawn on the generator's device."""
    dev = dict(generator=gen, device=gen.device)
    x = torch.rand(b, H, W, C, **dev).to(DEVICE, dtype)
    k = torch.randint(-8, 8, (b,), **dev).to(DEVICE, torch.int32)
    r = (torch.rand(b, **dev) * 2 - 1) * (math.pi / 4)
    R = rotations((torch.rand(b, **dev) * 2 - 1) * math.pi)
    r[0] = float("nan")
    R[0] = float("nan")
    return x, k, r.to(DEVICE), R.to(DEVICE)


def within_bar(got, ref, x):
    """max |got - ref| over non-NaN values, after checking that both are NaN
    at the same places; raises past 2e-6 * max|x| (fp32) or one bf16 ulp."""
    nan = torch.isnan(got.float())
    assert torch.equal(nan, torch.isnan(ref.float())), "NaN pattern differs"
    g = torch.where(nan, 0.0, got.float())
    r = torch.where(nan, 0.0, ref.float())
    err = (g - r).abs()
    if got.dtype == torch.bfloat16:  # one ulp of v is at most |v| * 2^-7
        assert bool((err <= torch.maximum(g.abs(), r.abs()) * 2.0**-7).all()), err.max()
    else:
        assert err.max().item() <= 2e-6 * x.float().abs().max().item(), err.max()
    return err.max().item()


def continuous_calls(sr, bw, name, x, k, r, R, padding):
    """(kernel call, plain call) of one continuous kernel."""
    H, W = x.shape[1], x.shape[2]
    if name == "rot90_centered_select":
        return (lambda: sr.rot90_centered_select(x, k, W // 2, H // 2, padding),
                lambda: sr.rot90_centered_select_plain(x, k, W // 2, H // 2, padding))
    if name == "shear_rotate_residual":
        c = (float(W // 2), float(H // 2))
        return (lambda: sr.shear_rotate_residual(x, r, *c, padding),
                lambda: sr.shear_rotate_residual_plain(x, r, *c, padding))
    return (lambda: bw.warp_rotate_center_exact(x, R, padding),
            lambda: bw._warp_center_affine(x, R, padding))


def check_continuous_kernels(sr, bw, gen):
    """K5, K6 and K7 against their plain versions on ragged small cases,
    with a NaN row; launches here are not counted as the main path's."""
    n_checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b, H, W, C in ((5, 17, 17, 3), (3, 40, 40, 16), (4, 33, 33, 1),
                           (3, 24, 40, 3)):
            x, k, r, R = continuous_inputs(b, H, W, C, dtype, gen)
            for padding in ("border", "zeros"):
                for name in CONT_KERNEL:
                    if H != W and name == "rot90_centered_select":
                        continue  # quarter turns take square images
                    run, plain = continuous_calls(sr, bw, name, x, k, r, R, padding)
                    got, ref = run(), plain()
                    sync()
                    if name == "rot90_centered_select":
                        assert torch.equal(got, ref), ("K5", dtype, b, H, C, padding)
                    else:
                        within_bar(got, ref, x)
                        assert bool(torch.isnan(got[0].float()).all()), name
                        assert bool(torch.isfinite(got[1:].float()).all()), name
                    n_checked += 1
    log(f"continuous kernel checks: {n_checked} small cases within their bars")


def check_k5_k7_wide(sr, bw, gen):
    """K5 bit for bit (compared as integers, a NaN payload and a -0.0 in
    every input) and K7 within its bar against their plain versions: sizes
    17, 33, 40, 97 and 224 (ragged 32 x 32 tiles), C in {1, 3, 4, 5, 8, 16}
    (both launch paths of each, in each dtype), both paddings, fp32 and
    bf16, every k in every batch and a NaN rotation in sample 0 (K7: its
    sample all NaN, the others finite). Each is also run on a
    16-byte-misaligned view of the same values, which takes the element
    (K7) or tile (K5) path. Launches here are not counted as the main
    paths'."""
    cases, paths = 0, set()
    for dtype in (torch.float32, torch.bfloat16):
        for N in (17, 33, 40, 97, 224):
            b = 3 if N == 224 else 5
            for C in (1, 3, 4, 5, 8, 16):
                x, _, _, R = continuous_inputs(b, N, N, C, dtype, gen)
                k = torch.arange(b, device=DEVICE) - 4 * (torch.arange(b, device=DEVICE) % 3)
                xp = with_payloads(x.clone())
                view = torch.empty(x.numel() + 1, dtype=dtype, device=DEVICE)[1:].view_as(x)
                view.copy_(x)
                view_p = torch.empty(x.numel() + 1, dtype=dtype, device=DEVICE)[1:].view_as(x)
                view_p.copy_(xp)
                assert bw._path(view, x) == "element" and sr._select_path(view_p, x) == "tile"
                for padding in ("border", "zeros"):
                    c = N // 2
                    ref = sr.rot90_centered_select_plain(xp, k, c, c, padding)
                    for inp in (xp, view_p):
                        got = sr.rot90_centered_select(inp, k, c, c, padding)
                        sync()
                        assert torch.equal(orbit_bits(got), orbit_bits(ref)), (
                            "K5", dtype, N, C, padding, inp is view_p)
                        paths.add(("K5", sr._select_path(inp, got)))
                    ref = bw._warp_center_affine(x, R, padding)
                    for inp in (x, view):
                        got = bw.warp_rotate_center_exact(inp, R, padding)
                        sync()
                        within_bar(got, ref, x)
                        assert bool(torch.isnan(got[0].float()).all()), ("K7", N, C)
                        assert bool(torch.isfinite(got[1:].float()).all()), ("K7", N, C)
                        paths.add(("K7", bw._path(inp, got)))
                    cases += 1
    assert paths == {("K5", "word"), ("K5", "tile"), ("K7", "word"), ("K7", "element")}, paths
    log(f"K5 / K7 wide checks: {cases} cases, each on an aligned and a "
        f"misaligned input; paths {sorted(paths)}")
    return {"cases": cases, "paths": sorted("/".join(p) for p in paths)}


def check_k6_wide(sr, gen):
    """K6 within `within_bar` of its plain version, the max |diff| logged
    (0 expected: the same fp32 operations in the same order): sizes 17, 33,
    97, 224, a non-square 24 x 40 and 256 x 256 (over the shared-memory
    limit: the "passes" path), C in {1, 3, 4, 5, 8, 16}, fp32 and bf16,
    both paddings, a NaN rotation in sample 0 (its sample all NaN, the
    others finite). Each case also runs on a 16-byte-misaligned view of the
    same values (no 16-byte words). Every path must be taken: resident with
    and without words, and passes. Launches here are not counted as the
    main paths'."""
    cases, paths, worst = 0, set(), 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for H, W in ((17, 17), (33, 33), (97, 97), (224, 224), (24, 40), (256, 256)):
            b = 2 if H >= 224 else 4
            for C in (1, 3, 4, 5, 8, 16):
                x, _, r, _ = continuous_inputs(b, H, W, C, dtype, gen)
                view = misaligned(x)
                cx, cy = float(W // 2), float(H // 2)
                for padding in ("border", "zeros"):
                    ref = sr.shear_rotate_residual_plain(x, r, cx, cy, padding)
                    for inp in (x, view):
                        got = sr.shear_rotate_residual(inp, r, cx, cy, padding)
                        sync()
                        worst = max(worst, within_bar(got, ref, x))
                        assert bool(torch.isnan(got[0].float()).all()), ("K6", H, W, C)
                        assert bool(torch.isfinite(got[1:].float()).all()), ("K6", H, W, C)
                        path = sr._shear_path(inp)
                        if path == "resident":
                            cluster = sr._shear_cluster(C, inp.element_size())
                            words = sr._shear_words(inp, got, cluster)
                            path += "/words" if words else "/runs"
                        paths.add(path)
                    cases += 1
    assert paths == {"resident/words", "resident/runs", "passes"}, paths
    log(f"K6 wide checks: {cases} cases, each on an aligned and a misaligned "
        f"input, within the bar, max |diff| {worst}; paths {sorted(paths)}")
    return {"cases": cases, "paths": sorted(paths), "max_abs_diff": worst}


def grad_guard_phase(orb, sr, bw, gen):
    """K4-K7 (and the fast warp K5 + K6) with CUDA inputs that require grad:
    each wrapper must raise under grad mode before it launches, and under
    torch.no_grad() give what it gives for inputs that do not require grad.
    Launches here are not counted as the main paths'."""
    size = 40
    x = torch.rand(2, size, size, 3, generator=gen).to(DEVICE)
    R = rotations(torch.tensor([0.3, -2.0])).to(DEVICE)
    r = torch.tensor([0.3, -0.5], device=DEVICE)
    k = torch.tensor([1, 3], device=DEVICE)
    c = size // 2
    calls = {  # name -> (call, inputs that may require grad)
        "K4": (lambda x, R, r: orb.rot90_flip_orbit(x, 4, True), ("x",)),
        "K5": (lambda x, R, r: sr.rot90_centered_select(x, k, c, c, "border"), ("x",)),
        "K6": (lambda x, R, r: sr.shear_rotate_residual(x, r, float(c), float(c)),
               ("x", "r")),
        "K7": (lambda x, R, r: bw.warp_rotate_center_exact(x, R, "zeros"), ("x", "R")),
        "K5+K6": (lambda x, R, r: sr.warp_rotate_center_fast(x, R), ("x", "R")),
    }
    refused = 0
    for name, (call, inputs) in calls.items():
        with torch.no_grad():
            want = call(x, R, r)
        for which in inputs:
            args = {"x": x, "R": R, "r": r}
            args[which] = args[which].clone().requires_grad_(True)
            before = {**orb.launches, **sr.launches, **bw.launches}
            raised = None
            with torch.enable_grad():
                try:
                    call(**args)
                except RuntimeError as e:
                    raised = str(e)
            assert raised is not None and "no backward on the card" in raised, (
                name, which, raised)
            assert {**orb.launches, **sr.launches, **bw.launches} == before, (name, which)
            with torch.no_grad():
                got = call(**args)
            sync()
            assert got.grad_fn is None and torch.equal(got, want), (name, which)
            refused += 1
    log(f"gradient guard: {refused} calls with an input that requires grad "
        f"raised under grad mode and ran under torch.no_grad()")
    return {"refused": refused}


def main_shape_inputs(sw, gen, C, dtype, rolled, nhwc=False):
    """Sources and indices at a main-path shape: the batch and its 45-degree
    residual warp (C8, two sources), NCHW or NHWC."""
    residues, src_of, k_of = sw._c_n_decomposition(NUM_ROT, 1.0 if rolled else -1.0)
    idx = torch.randint(0, NUM_ROT, (B,), generator=gen).to(DEVICE)
    src = torch.tensor(src_of, device=DEVICE)[idx].int()
    k = torch.tensor(k_of, device=DEVICE)[idx].int()
    shape = (B, IMAGE, IMAGE, C) if nhwc else (B, C, IMAGE, IMAGE)
    srcs = [torch.randn(*shape, device=DEVICE).to(dtype) for _ in residues]
    shift = idx.int() if rolled else None
    return srcs, src, k, shift


def plain_call(sw, name, srcs, src, k, shift):
    if name == "select_planes_rolled":
        return sw.select_planes_plain(srcs, src, k, shift, None, NUM_ROT, NUM_ROT)
    if name == "select_planes_nhwc":
        return sw.select_planes_nhwc_plain(srcs, src, k)
    return sw.select_planes_plain(srcs, src, k)


def kernel_call(sw, name, srcs, src, k, shift):
    if name == "select_planes_rolled":
        return sw.select_planes_rolled(srcs, src, k, shift, NUM_ROT, NUM_ROT)
    return getattr(sw, name)(srcs, src, k)


def gather_call(sw, name, srcs, src, k, shift, got):
    """Yardstick: one torch.gather over the stacked sources with the flat
    index of the same permutation, built outside the timed window (by the
    plain version run on source-index values); checked equal to the
    kernel's output."""
    n = srcs[0].numel()
    iota = [torch.arange(s * n, (s + 1) * n, device=DEVICE).view(srcs[0].shape)
            for s in range(len(srcs))]
    idx = plain_call(sw, name, iota, src, k, shift).reshape(-1)
    del iota
    flat = torch.stack(srcs).reshape(-1)
    run = lambda: torch.gather(flat, 0, idx)
    assert torch.equal(run().view_as(got), got), "gather yardstick differs"
    return run


def backward_ms(sw, name, srcs, src, k, shift):
    """Time of the kernel's backward (one launch on the cotangent, then a
    mask per source), through autograd, at the main-path shape."""
    leaves = [s.detach().requires_grad_(True) for s in srcs]
    with torch.enable_grad():
        out = kernel_call(sw, name, leaves, src, k, shift)
        g = torch.randn_like(out)
        ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                     reps=10)
    del out, g, leaves
    return ms


def kernel_entry(sw, name, dtype, gen, bw, launches, one_source=False,
                 paths=None):
    """Check and time one kernel at its main-path shape; `paths` are the
    main paths' launches of it by launch path."""
    rolled = name == "select_planes_rolled"
    nhwc = name == "select_planes_nhwc"
    C = FEATURE_CH if rolled else 3
    srcs, src, k, shift = main_shape_inputs(sw, gen, C, dtype, rolled, nhwc)
    if one_source:  # K1a: the single-source launch of K1
        srcs, src = srcs[:1], torch.zeros_like(src)
    run = lambda: kernel_call(sw, name, srcs, src, k, shift)
    plain = lambda: plain_call(sw, name, srcs, src, k, shift)
    got, ref = run(), plain()
    sync()
    assert torch.equal(orbit_bits(got), orbit_bits(ref)), (name, dtype, "main-path shape")
    err = (got.float() - ref.float()).abs().max().item()
    lib = gather_call(sw, name, srcs, src, k, shift, got)
    timed = windowed_ms({"ms": run, "library_ms": lib}, reps=10)
    del lib
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    bwd_ms = backward_ms(sw, name, srcs, src, k, shift)
    nbytes = 2 * got.numel() * got.element_size() + sum(
        t.numel() * t.element_size() for t in (src, k, shift) if t is not None)
    bound_ms = nbytes / bw * 1e3
    tag = str(dtype).removeprefix("torch.")
    shape = list(got.shape)
    del srcs, got, ref
    replaces = TPU_KERNEL[name]
    if one_source:
        tag += ",1 source"
        replaces = "equiadapt_tpu/ops/pallas/select_warp.py:159"
    prefix = f"{name}/{tag.split(',')[0]}/"
    return {
        "name": f"{name}[{tag}]", "route": "cuda", "source": SOURCE,
        "replaces": replaces,
        "launches": launches.get(f"{name}/{tag}", 0),
        "paths": {k.removeprefix(prefix): v for k, v in (paths or {}).items()
                  if k.startswith(prefix)},
        "max_abs_err": err, **timed, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes",
        "library": "torch.gather, precomputed int64 index",
        "backward_ms": bwd_ms, "shape": shape, "bytes": nbytes,
    }


def grid_sample_call(x, R, padding):
    """Yardstick for K7: F.grid_sample (bilinear, align_corners=True) on an
    NCHW copy with the same sample points; the copy and the grid are made
    here, outside the timed call. grid_sample takes its grid in the input's
    dtype, so for bf16 the normalized sample points are rounded to bf16
    (up to about 0.4 px at 224 px): that call samples a coarser function
    than K7 computes, and its `library_max_abs_err` shows by how much."""
    from equiadapt_tpu_torch.ops.kernels.bilinear_warp import _inverse_coefficients
    from equiadapt_tpu_torch.ops.warp import _dst_grid

    Bx, H, W, _ = x.shape
    inv = _inverse_coefficients(R, torch.float32)
    gx, gy = _dst_grid(Bx, H, W, torch.float32, x.device)
    dx, dy = gx - H // 2, gy - W // 2
    i00, i01, i10, i11 = (inv[:, q, None, None] for q in range(4))
    sx = i00 * dx + i01 * dy + H // 2
    sy = i10 * dx + i11 * dy + W // 2
    grid = torch.stack([2 * sx / (W - 1) - 1, 2 * sy / (H - 1) - 1], -1).to(x.dtype)
    xn = x.permute(0, 3, 1, 2).contiguous()
    return lambda: F.grid_sample(xn, grid, mode="bilinear", padding_mode=padding,
                                 align_corners=True)


def rot90_gather_call(sr, x, k, padding, got):
    """Yardstick for K5: one torch.gather over the source with one zero
    element prepended, at the flat index of the same permutation. The index
    is built outside the timed window, by the plain version run on the
    values 1..n (a zero-filled pixel keeps 0 and reads the prepended
    zero); the gather is checked equal to the kernel's output."""
    H, W = x.shape[1], x.shape[2]
    iota = torch.arange(1, x.numel() + 1, device=x.device).view_as(x)
    idx = sr.rot90_centered_select_plain(iota, k, W // 2, H // 2, padding).reshape(-1)
    del iota
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)])
    run = lambda: torch.gather(flat, 0, idx)
    assert torch.equal(run().view_as(got), got), "K5 gather yardstick differs"
    return run


def continuous_measure(sr, bw, name, dtype, C, padding, gen, bwidth):
    """Check and time one continuous kernel at a main-path shape."""
    x, k, r, R = continuous_inputs(B, IMAGE, IMAGE, C, dtype, gen)
    run, plain = continuous_calls(sr, bw, name, x, k, r, R, padding)
    got, ref = run(), plain()
    sync()
    if name == "rot90_centered_select":
        assert torch.equal(got, ref), (name, dtype, C)
        err = 0.0
    else:
        err = within_bar(got, ref, x)
    out = {"plain_ms": cuda_ms(plain, reps=3, warmup=1), "max_abs_err": err,
           "bound_ms": 2 * x.numel() * x.element_size() / bwidth * 1e3,
           "shape": [B, IMAGE, IMAGE, C], "padding": padding}
    fns = {"ms": run}
    if name == "rot90_centered_select":
        fns["library_ms"] = rot90_gather_call(sr, x, k, padding, got)
        out["library"] = "torch.gather, precomputed int64 index, one zero prepended"
        out["path"] = sr._select_path(x, got)
    if name == "shear_rotate_residual":
        cluster = sr._shear_cluster(C, x.element_size())
        out.update(path=sr._shear_path(x), cluster=cluster,
                   words=sr._shear_words(x, got, cluster))
        if cluster > 1:  # the other design: one block a channel, L2 over-read
            fns["one_block_ms"] = one_block_clusters(sr, run)
            assert torch.equal(orbit_bits(fns["one_block_ms"]()), orbit_bits(got)), (
                name, dtype, C)
    if name == "warp_rotate_center_exact":
        fns["library_ms"] = grid_sample_call(x, R, padding)
        diff = (fns["library_ms"]().permute(0, 2, 3, 1).float() - got.float()).abs()
        out["library"] = "F.grid_sample, NCHW, bilinear, align_corners=True"
        out["library_max_abs_err"] = torch.nan_to_num(diff[1:]).max().item()
        out["path"] = bw._path(x, got)
    out.update(windowed_ms(fns, reps=10))
    out.setdefault("library_ms", None)
    del x, got, ref, fns
    return out


def one_block_clusters(sr, run):
    """run() with K6's clusters cut to one block: each block loads and
    stores its own channel and L2 serves the pixel's other channels."""
    def call():
        keep = sr._shear_cluster
        sr._shear_cluster = lambda C, element_size: 1
        try:
            return run()
        finally:
            sr._shear_cluster = keep
    return call


def continuous_entry(sr, bw, name, dtype, gen, bwidth, launches, paths=None):
    """One `kernels` entry: the invert shape (C = 16, zeros) in the main
    fields, the canonicalize shape (C = 3, border) under "canon"; `paths`
    are the main paths' launches by launch path."""
    tag = str(dtype).removeprefix("torch.")
    inv = continuous_measure(sr, bw, name, dtype, FEATURE_CH, "zeros", gen, bwidth)
    canon = continuous_measure(sr, bw, name, dtype, 3, "border", gen, bwidth)
    source, replaces = CONT_KERNEL[name]
    prefix = f"{name}/{tag}/"
    return {"name": f"{name}[{tag}]", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(f"{name}/{tag}", 0),
            "paths": {k.removeprefix(prefix): v for k, v in (paths or {}).items()
                      if k.startswith(prefix)},
            "bound_by": "bytes", **inv, "canon": canon}


def build_presets(tp):
    torch.manual_seed(0)
    net = tp.EquivariantNetwork(3, 8, 3, group_type="rotation",
                                num_rotations=NUM_ROT, num_layers=2,
                                device=DEVICE)
    net_pooled = tp.EquivariantNetwork(3, 8, 3, group_type="rotation",
                                       num_rotations=NUM_ROT, num_layers=2,
                                       fused_pool_lift=True, device=DEVICE)
    net_pooled.load_state_dict(net.state_dict())
    common = dict(in_shape=(IMAGE, IMAGE, 3), num_rotations=NUM_ROT,
                  group_type="rotation")
    exact = tp.GroupEquivariantImageCanonicalization(
        net, input_crop_ratio=0.9, resize_shape=64, warp_mode="exact", **common)
    serving = tp.GroupEquivariantImageCanonicalization(
        net_pooled, input_crop_ratio=1.0, resize_shape=56, warp_mode="fast",
        compute_dtype=torch.bfloat16, output_dtype="compute", **common)
    torch.manual_seed(1)
    resnet = tp.ResNet50(num_classes=10, device=DEVICE)
    resnet_bf16 = tp.ResNet50(num_classes=10, dtype=torch.bfloat16,
                              device=DEVICE)
    resnet_bf16.load_state_dict(resnet.state_dict())
    with torch.no_grad():  # BN statistics away from the init's 0 / 1
        for m in list(resnet.modules()) + list(net.modules()):
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
        net_pooled.load_state_dict(net.state_dict())
        resnet_bf16.load_state_dict(resnet.state_dict())
    for m in (exact, serving, resnet, resnet_bf16):
        m.eval()
    return {"exact": (exact, resnet), "serving": (serving, resnet_bf16)}


def steerable_net(tp):
    """bench.py's continuous canonicalization network: SteerableNetwork(3,
    4 fields per order, 5x5, 1 layer), weights from seed 2, NormBatchNorm
    statistics and norm-ReLU biases drawn away from the init's 1 / 0."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    net = tp.SteerableNetwork(3, 4, 5, num_layers=1, device=DEVICE, generator=gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if ".bias_" in name:
                p.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("scale"):
                p.uniform_(0.5, 1.5, generator=gen)
        net.NormBatchNorm_0.norm_sq.uniform_(0.5, 1.5, generator=gen)
    return net


def build_continuous_presets(tp, resnet, resnet_bf16):
    """bench.py's continuous configuration: `steerable_net`, crop 0.9,
    resize 64."""
    net = steerable_net(tp)
    common = dict(in_shape=(IMAGE, IMAGE, 3), input_crop_ratio=0.9,
                  resize_shape=64, group_type="rotation")
    exact = tp.SteerableImageCanonicalization(net, warp_mode="exact", **common)
    serving = tp.SteerableImageCanonicalization(
        net, warp_mode="fast", compute_dtype=torch.bfloat16,
        output_dtype="compute", **common)
    return {"continuous_exact": (exact.eval(), resnet),
            "continuous_serving": (serving.eval(), resnet_bf16)}


def smooth_images(gen, b=None, size=None):
    """Low-frequency images plus noise: oriented content, so the random
    energy network separates its top two elements clearly (white noise
    leaves margins near 1e-5). b x size x size, B x IMAGE x IMAGE unless
    given."""
    b, size = b or B, size or IMAGE
    lo = torch.randn(b, 3, 6, 6, generator=gen)
    up = torch.nn.functional.interpolate(lo, size=(size, size), mode="bicubic",
                                         align_corners=False)
    return 4.0 * up.permute(0, 2, 3, 1) + 0.5 * torch.randn(
        b, size, size, 3, generator=gen)


def lowfreq_images(gen, C=3, b=None, size=None):
    """Smooth images in [0, 1] (no white noise): a frame that moves by a
    small angle moves pixel values by a small amount."""
    b, size = b or B, size or IMAGE
    lo = torch.rand(b, C, 6, 6, generator=gen)
    up = torch.nn.functional.interpolate(lo, size=(size, size), mode="bicubic",
                                         align_corners=False)
    return up.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def run_path(canon, resnet, x, y, **invert_kw):
    x_c, info = canon.canonicalize(x)
    logits = resnet(x_c)
    y_inv = canon.invert_canonicalization(info, y, **invert_kw)
    return x_c, info, logits, y_inv


def check_against_cpu(canon, resnet, x, y, x_c, info, logits, y_inv, m=8):
    """The first m samples against the port's CPU run (plain kernels)."""
    canon_cpu = copy.deepcopy(canon).to("cpu")
    resnet_cpu = copy.deepcopy(resnet).to("cpu")
    xc_r, info_r, logits_r, yi_r = run_path(canon_cpu, resnet_cpu,
                                            x[:m].cpu(), y[:m].cpu())
    acts = info_r.group_activations
    top2 = acts.sort(dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    sel = info.onehot[:m].argmax(-1).cpu()
    same = sel == info_r.onehot.argmax(-1)
    assert clear.sum() >= m // 2 and bool(same[clear].all()), (sel, acts)
    d_act = (info.group_activations[:m].cpu() - acts).abs().max().item()
    d_img = (x_c[:m].cpu()[same] - xc_r[same]).abs().max().item()
    d_inv = (y_inv[:m].cpu()[same] - yi_r[same]).abs().max().item()
    d_log = ((logits[:m].cpu() - logits_r).abs().max()
             / logits_r.abs().max()).item()
    assert d_act < 1e-4 and d_img < 1e-4 and d_inv < 1e-4 and d_log < 1e-3, (
        d_act, d_img, d_inv, d_log)
    return {"samples": m, "same_element": int(same.sum()), "max_abs_act": d_act,
            "max_abs_image": d_img, "max_abs_invert": d_inv,
            "max_rel_logit": d_log}


def check_continuous_against_cpu(canon, resnet, x, y, x_c, info, logits, y_inv,
                                 m=8):
    """The first m samples against the port's CPU run (plain kernels).

    fp32 bars: matrix rep 1e-5; canonical images and inverted maps 1e-4
    (images in [0, 1]: a 1e-6 change of the frame moves a sample point by
    at most 2e-4 px at the corner); logits 1e-3 of the largest (cuDNN
    against the CPU's convolutions). bf16 bars (the steerable network's
    first convolution runs in bf16, so the frames move by up to a few
    1e-3 rad): matrix rep 1e-2; canonical images and inverted maps within
    2e-2 at 99% of their values and all within 0.1; logits 5e-2 of the
    largest."""
    canon_cpu = copy.deepcopy(canon).to("cpu")
    resnet_cpu = copy.deepcopy(resnet).to("cpu")
    xc_r, info_r, logits_r, yi_r = run_path(canon_cpu, resnet_cpu, x[:m].cpu(),
                                            y[:m].cpu(), induced_rep_type="scalar")
    d_rep = (info.matrix_rep[:m].cpu() - info_r.matrix_rep).abs().max().item()
    e_img = (x_c[:m].cpu().float() - xc_r.float()).abs()
    e_inv = (y_inv[:m].cpu().float() - yi_r.float()).abs()
    d_log = ((logits[:m].cpu().float() - logits_r.float()).abs().max()
             / logits_r.float().abs().max()).item()
    out = {"samples": m, "max_abs_rep": d_rep,
           "max_abs_image": e_img.max().item(),
           "q99_abs_image": torch.quantile(e_img.flatten()[::7], 0.99).item(),
           "max_abs_invert": e_inv.max().item(),
           "q99_abs_invert": torch.quantile(e_inv.flatten()[::7], 0.99).item(),
           "max_rel_logit": d_log}
    if x_c.dtype == torch.bfloat16:
        ok = (d_rep < 1e-2 and out["q99_abs_image"] < 2e-2
              and out["q99_abs_invert"] < 2e-2 and out["max_abs_image"] < 0.1
              and out["max_abs_invert"] < 0.1 and d_log < 5e-2)
    else:
        ok = (d_rep < 1e-5 and out["max_abs_image"] < 1e-4
              and out["max_abs_invert"] < 1e-4 and d_log < 1e-3)
    assert ok, out
    return out


def check_equivariance(canon, x, x_c, info):
    """canonicalize(rot90(x)) selects element + 2 (mod 8) and gives the same
    canonical image."""
    x_rot = torch.rot90(x, 1, dims=(1, 2)).contiguous()
    x_c_rot, info_rot = canon.canonicalize(x_rot)
    sel = info.onehot.argmax(-1)
    sel_rot = info_rot.onehot.argmax(-1)
    ok = sel_rot == (sel + 2) % NUM_ROT
    share = ok.float().mean().item()
    err = (x_c_rot[ok] - x_c[ok]).abs().max().item()
    assert share >= 0.99 and err < 1e-4, (share, err)
    return {"share_shifted": share, "max_abs_image": err}


def check_continuous_equivariance(canon, x, info):
    """A quarter turn of the input quarter-turns the frame:
    matrix_rep(rot90(x)) == matrix_rep(x) @ Q^T, Q the +90-degree rotation
    (rot90 turns the image counter-clockwise as displayed; the network's
    angles are y-up), within 1e-4 for at least 99% of the batch."""
    x_rot = torch.rot90(x, 1, dims=(1, 2)).contiguous()
    _, info_rot = canon.canonicalize(x_rot)
    q_t = torch.tensor([[0.0, 1.0], [-1.0, 0.0]], device=x.device)
    want = info.matrix_rep @ q_t
    err = (info_rot.matrix_rep - want).abs().amax(dim=(1, 2))
    share = (err < 1e-4).float().mean().item()
    assert share >= 0.99, (share, err.max().item())
    return {"share_within_1e-4": share, "max_abs_rep": err.max().item()}


def knn_agree(points, got, ref):
    """K8's picks against the plain version's: `torch.equal` at D <= 4; at
    D > 4 each differing pick must tie the plain one at fp32 level: the
    float64 squared distances of the two picked points lie within
    2 sqrt(D) fp32 roundings (2^-24) of the terms that cancel in d, |q|^2 +
    |p|^2. Each fp32 computation of d (the kernel's fmaf chain, the plain
    version's matrix product) rounds a sum of D products and the two norms,
    about sqrt(D) roundings of that size; the two may differ by twice that.
    Every index must lie in [0, N). Returns (differing picks, max |float64
    distance difference|, the same relative to the larger distance, the
    largest difference in units of 2^-24 (|q|^2 + |p|^2))."""
    N, D = points.shape[1], points.shape[2]
    assert int(got.min()) >= 0 and int(got.max()) < N, "index out of range"
    if D <= 4:
        assert torch.equal(got, ref), "K8 differs from its plain version"
        return 0, 0.0, 0.0, 0.0
    bad = got != ref
    n_bad = int(bad.sum())
    if n_bad == 0:
        return 0, 0.0, 0.0, 0.0
    b, q, s = bad.nonzero(as_tuple=True)
    p = points.double()
    sq = (p * p).sum(-1)
    i_ref, i_got = ref[b, q, s].long(), got[b, q, s].long()
    d_ref = ((p[b, q] - p[b, i_ref]) ** 2).sum(-1)
    d_got = ((p[b, q] - p[b, i_got]) ** 2).sum(-1)
    gap = (d_ref - d_got).abs()
    rel = gap / torch.clamp(torch.maximum(d_ref, d_got), min=1e-30)
    ulps = gap / (2.0 ** -24 * (sq[b, q] + torch.maximum(sq[b, i_ref], sq[b, i_got])))
    assert bool((ulps <= 2 * math.sqrt(D)).all()), (
        "K8 pick beyond an fp32 tie", ulps.max().item(), 2 * math.sqrt(D))
    return n_bad, gap.max().item(), rel.max().item(), ulps.max().item()


def signed_zero_cloud(x):
    """x with zero-padding rows: +0.0 points and points of -0.0 coordinates
    interleaved, whose distances to a zero query are +0.0 and -0.0 and must
    tie by index."""
    x = x.clone()
    x[:, 0:24:2] = 0.0
    x[:, 1:24:2] = -0.0
    return x


def check_knn_kernel(kn, gen):
    """K8 against its plain version on ragged cases, both block widths (N up
    to 1024, and above), both selection routes (k <= 32 and k = 128), ties,
    signed zeros and a NaN point; launches here are not counted as the main
    path's."""
    cases, ties, worst = 0, 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for N in (1, 6, 31, 100, 1000, 1024, 4096):
            for D in (3, 4, 64, 128):
                x = torch.randn(3, N, D, generator=gen).to(DEVICE, dtype)
                for k in (1, 4, 20, 128):
                    if k > N:
                        continue
                    got, ref = kn.knn_indices(x, k), kn.knn_indices_plain(x, k)
                    sync()
                    n_bad, _, _, ulps = knn_agree(x, got, ref)
                    ties, worst = ties + n_bad, max(worst, ulps)
                    cases += 1
        for D in (3, 64):
            x = torch.randn(3, 1000, D, generator=gen)
            dup = x.clone()
            dup[:, 500:] = x[:, :500]  # every point twice: exact ties
            grid = torch.round(x * 2.0) / 4.0  # a 0.25 grid: many ties
            for cloud in (dup, grid, signed_zero_cloud(x)):
                cloud = cloud.to(DEVICE, dtype)
                for k in (20, 128):
                    got = kn.knn_indices(cloud, k)
                    n_bad, _, _, ulps = knn_agree(cloud, got,
                                                  kn.knn_indices_plain(cloud, k))
                    ties, worst = ties + n_bad, max(worst, ulps)
                    cases += 1
            nan = x.to(DEVICE, dtype)
            clean = kn.knn_indices(nan, 20)
            nan[1, 17] = float("nan")
            got = kn.knn_indices(nan, 20)
            sync()
            assert int(got.min()) >= 0 and int(got.max()) < 1000, "NaN cloud"
            assert torch.equal(got[[0, 2]], clean[[0, 2]]), "NaN leaked"
            if D <= 4:
                assert torch.equal(got, kn.knn_indices_plain(nan, 20)), "NaN cloud"
            cases += 1
    log(f"K8 checks: {cases} cases against the plain version; "
        f"{ties} picks at D > 4 differ, each an fp32-level tie (largest "
        f"gap {worst:.3g} roundings of |q|^2 + |p|^2)")
    return {"cases": cases, "tie_picks": ties, "max_gap_roundings": worst}


def knn_yardstick(x, k):
    """The XLA-style formulation in two PyTorch calls: the (B, N, N)
    distances by one baddbmm, then torch.topk (its tie order is not
    specified)."""
    sq = (x * x).sum(-1)
    d = torch.baddbmm(-(sq[:, :, None] + sq[:, None, :]), x, x.transpose(1, 2),
                      alpha=2.0)
    return torch.topk(d, k, dim=-1).indices


def knn_measure(kn, x, bwidth, rate, k=PC_K):
    """Check and time K8 on the card's points x (B, N, D): against the
    plain version (`knn_agree`; at D > 4 the differing picks whose
    gathered features are equal, exact duplicates, are counted apart), the
    time beside the bound and the yardstick's, in turns."""
    B, N, D = x.shape
    run = lambda: kn.knn_indices(x, k)
    plain = lambda: kn.knn_indices_plain(x, k)
    got, ref = run(), plain()
    sync()
    n_bad, err, rel, ulps = knn_agree(x, got, ref)
    bad = got != ref
    rows = torch.arange(B, device=x.device)[:, None, None].expand_as(got)[bad]
    same_features = int((x[rows, got[bad].long()] == x[rows, ref[bad].long()])
                        .all(-1).sum())
    yard = lambda: knn_yardstick(x, k)
    yard_same = (yard() == got).float().mean().item()
    flops = 2 * B * N * N * D
    nbytes = x.numel() * x.element_size() + got.numel() * got.element_size()
    out = {**windowed_ms({"ms": run, "yardstick_ms": yard}, reps=10),
           "plain_ms": cuda_ms(plain, reps=3, warmup=1),
           "max_abs_err": err, "tie_picks": n_bad,
           "tie_picks_same_features": same_features, "max_rel_gap": rel,
           "max_gap_roundings": ulps,
           "bound_ms": max(flops / rate, nbytes / bwidth) * 1e3,
           "bound_by": "operations" if flops / rate >= nbytes / bwidth else "bytes",
           "flops": flops, "bytes": nbytes, "shape": [B, N, D], "k": k,
           "yardstick": "torch.baddbmm + torch.topk",
           "yardstick_same_index_share": yard_same}
    del got, ref
    return out


def knn_entries(kn, gen, bwidth, rate, launches, train_cases):
    """Two `kernels` entries, one per distance branch: D = 3 (d<=4) and
    D = 128 (d>4, with D = 64 under "D64"), at the point-cloud path's
    (PC_B, PC_N); each with phase 20's cases of its branch (`train_cases`,
    `knn_train_cases`) and their launches on phase 20's paths. No single
    PyTorch call computes kNN indices, so library_ms is null; the
    yardstick's time stands beside it."""
    entries = []
    for branch, dims in (("d<=4", (3,)), ("d>4", (128, 64))):
        x = torch.randn(PC_B, PC_N, dims[0], generator=gen).to(DEVICE)
        main = knn_measure(kn, x, bwidth, rate)
        entry = {"name": f"knn_indices[float32,{branch}]", "route": "cuda",
                 "source": KNN_SOURCE, "replaces": KNN_TPU,
                 "launches": launches.get(f"knn_indices/float32/{branch}", 0),
                 "library_ms": None, **main}
        for D in dims[1:]:
            x = torch.randn(PC_B, PC_N, D, generator=gen).to(DEVICE)
            entry[f"D{D}"] = knn_measure(kn, x, bwidth, rate)
        entry.update({name: case for name, case in train_cases["cases"].items()
                      if (case["shape"][2] <= 4) == (branch == "d<=4")})
        entry["launches_by_path"] = {
            path: counts.get(f"knn_indices/float32/{branch}", 0)
            for path, counts in train_cases["launches"].items()}
        entries.append(entry)
        log(f"K8 {branch}: {json.dumps(entry)}")
    return entries


def random_bn_statistics(module, kinds=(torch.nn.modules.batchnorm._BatchNorm,)):
    """BatchNorm running statistics drawn away from 0 / 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, kinds):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)


def build_pointcloud(tp):
    """The repo's ModelNet40 configuration with random weights: VNSmall
    (k 20, mean pooling, fused kNN) canonicalizer and DGCNN (k 20, emb
    1024, 40 classes). Built on the CPU from seed 3 and moved to the card,
    so the weights do not depend on the device's generator.

    Random VN weights often give three frame vectors that are nearly
    collinear, and classical Gram-Schmidt then loses orthogonality in
    proportion (fp32 eps over the smallest singular value ratio). Seed 3
    gives a smallest over largest singular value of at least 0.011 on
    all 64 clouds of `anisotropic_clouds` (CPU run), which keeps R R^T
    within about 3e-6 of I."""
    torch.manual_seed(3)
    canon = tp.EquivariantPointcloudCanonicalization(
        tp.VNSmall(n_knn=PC_K, pooling="mean", knn_mode="fused", device="cpu"))
    random_bn_statistics(canon)
    dgcnn = tp.DGCNN(num_classes=PC_CLASSES, k=PC_K, emb_dims=PC_EMB,
                     knn_mode="fused", device="cpu")
    random_bn_statistics(dgcnn)
    return tp.PointcloudClassificationPipeline(canon, dgcnn).to(DEVICE).eval()


def random_rotations(b, gen):
    """b random proper rotations (QR of Gaussian matrices)."""
    q, r = torch.linalg.qr(torch.randn(b, 3, 3, generator=gen, dtype=torch.float64))
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    q[torch.linalg.det(q) < 0, :, 0] *= -1
    return q.float()


def anisotropic_clouds(gen, b=PC_B, n=PC_N):
    """Gaussian clouds with axis scales 1, 0.6 and 0.3, each turned by a
    random rotation (an isotropic cloud has no preferred axes)."""
    x = torch.randn(b, n, 3, generator=gen) * torch.tensor([1.0, 0.6, 0.3])
    return x @ random_rotations(b, gen)


def run_pointcloud(pipe, x):
    """The path: canonicalize, DGCNN, and the point-valued invert of the
    canonical cloud."""
    canon = pipe.canonicalizer
    x_c, info = canon.canonicalize(x)
    logits = pipe.prediction_network(x_c)
    return x_c, info, logits, canon.invert_canonicalization(info, x_c)


def check_pointcloud(pipe, x, x_c, info, logits, x_back, gen, m=8):
    """Agreement with the port's CPU run, SO(3) invariance and the invert.

    Bars (fp32, TF32 off):
    - canonical clouds within 1e-4 of the CPU run: the frame comes from fp32
      products summed in another order (about 1e-6 of a coordinate), and
      the D = 3 kNN indices are bit-equal by construction;
    - logits within 1e-3 of the largest logit, the CPU DGCNN run on the
      card's canonical clouds: fp32 products in another order, plus any
      D > 4 neighbour pick that flips at an fp32 tie; classes equal;
    - x @ Q: canonical clouds within 1e-3 and classes equal for 95% of the
      clouds (a neighbour tie at the rounding level can flip a few);
    - the invert gives x back within 1e-4 (R R^T = I to fp32 rounding)."""
    pipe_cpu = copy.deepcopy(pipe).to("cpu")
    xc_cpu, info_cpu = pipe_cpu.canonicalizer.canonicalize(x[:m].cpu())
    logits_cpu = pipe_cpu.prediction_network(x_c[:m].cpu())
    d_canon = (x_c[:m].cpu() - xc_cpu).abs().max().item()
    d_rot = (info.element.rotation[:m].cpu() - info_cpu.element.rotation).abs().max().item()
    d_log = ((logits[:m].cpu() - logits_cpu).abs().max()
             / logits_cpu.abs().max()).item()
    top2 = logits_cpu.sort(dim=-1).values[:, -2:]
    same_cpu = bool((logits[:m].argmax(-1).cpu() == logits_cpu.argmax(-1)).all())
    assert d_canon < 1e-4 and d_log < 1e-3 and same_cpu, (d_canon, d_log, same_cpu)

    Q = random_rotations(x.shape[0], gen).to(DEVICE)
    x_c_rot, _ = pipe.canonicalizer.canonicalize(x @ Q)
    logits_rot = pipe.prediction_network(x_c_rot)
    err = (x_c_rot - x_c).abs().amax(dim=(1, 2))
    share = (err < 1e-3).float().mean().item()
    same_class = (logits_rot.argmax(-1) == logits.argmax(-1)).float().mean().item()
    d_back = (x_back - x).abs().max().item()
    assert share >= 0.95 and same_class >= 0.95 and d_back < 1e-4, (
        share, same_class, d_back)
    sv = torch.linalg.svdvals(pipe.canonicalizer.canonicalization_network(x))
    return {"cpu": {"clouds": m, "max_abs_canon": d_canon, "max_abs_rotation": d_rot,
                    "max_rel_logit": d_log, "same_class": same_cpu,
                    "min_top2_margin_rel": ((top2[:, 1] - top2[:, 0]).min()
                                            / logits_cpu.abs().max()).item()},
            "so3": {"share_canon_within_1e-3": share, "median_abs_canon":
                    err.median().item(), "max_abs_canon": err.max().item(),
                    "share_same_class": same_class},
            "invert_max_abs": d_back,
            "frame_min_singular_ratio": (sv[:, -1] / sv[:, 0]).min().item()}


def time_pointcloud(pipe, x):
    """End-to-end times of the point-cloud path and its device profile."""
    canon, dgcnn = pipe.canonicalizer, pipe.prediction_network
    x_c = canon.canonicalize(x)[0]
    t_bare = cuda_ms(lambda: dgcnn(x_c), reps=5)
    t_wrapped = cuda_ms(lambda: dgcnn(canon.canonicalize(x)[0]), reps=5)
    t_canon = cuda_ms(lambda: canon.canonicalize(x), reps=5)
    times = {"dgcnn_ms": t_bare, "canon_dgcnn_ms": t_wrapped,
             "canonicalize_ms": t_canon,
             "canonicalize_clouds_per_s": x.shape[0] / t_canon * 1e3,
             "overhead_pct": (t_wrapped - t_bare) / t_bare * 100.0}
    log(f"pointcloud: {json.dumps(times)}")
    prof = {"canon_dgcnn": device_profile(lambda: dgcnn(canon.canonicalize(x)[0])),
            "canonicalize": device_profile(lambda: canon.canonicalize(x))}
    times["profile"] = prof
    for part, rows in prof.items():
        log(f"pointcloud profile {part}: {json.dumps(rows[:12] + rows[-1:])}")
    return times


def clone_at(t):
    """A copy of contiguous `t` at the same offset from a 16-byte boundary
    (a launch path depends on it; the allocator's blocks start on 512)."""
    off = (t.data_ptr() % 16) // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    return buf[off:].view(t.shape).copy_(t)


def orbit_args(ks, flips):
    """`rot90_flip_orbit`'s (num_rotations, reflections, sign) for the
    element table K4's launcher takes."""
    n = flips.count(False)  # the sign changes the table at C4 only
    return n, any(flips), -1.0 if n == 4 and ks[1] == 3 else 1.0


class SourceLog:
    """The number of sources of each K1 / K2 launch made while a main path
    runs (K1a is K1 with one source), by path: wraps the select wrappers'
    launcher, which counts the launch itself, and K4's.

    With `capture`, the inputs of the first launch of each kind (kernel,
    dtype, sources, shape, alignment, table) are copied before it runs, and
    the launch path it took is noted; `check` runs each again through its
    wrapper on the copy, and the plain version beside it."""

    def __init__(self, sw, orb):
        self.sw, self.orb = sw, orb
        self.path, self.rows, self.capture, self.inputs = None, [], False, {}
        launch, orbit_launch = sw._launch, orb._launch

        def keep(key, mod, inputs, run):
            if not self.capture or key in self.inputs:
                return run()
            copies = inputs()
            seen = dict(mod.path_launches)
            out = run()
            (path,) = [k for k, v in mod.path_launches.items() if v != seen.get(k, 0)]
            self.inputs[key] = (copies, path.split("/")[-1])
            return out

        def recording(name, sources, *args):
            if self.path is None:
                return launch(name, sources, *args)
            tag = str(sources[0].dtype).removeprefix("torch.")
            self.rows.append((self.path, name, tag, len(sources)))
            key = (name, tag, len(sources), tuple(sources[0].shape),
                   tuple(s.data_ptr() % 16 for s in sources),
                   tuple(a is None for a in args[2:4]), args[4:])
            return keep(key, sw, lambda: ([clone_at(s) for s in sources], [
                a.clone() if torch.is_tensor(a) else a for a in args]),
                lambda: launch(name, sources, *args))

        def orbit_recording(x, ks, flips):
            if self.path is None:
                return orbit_launch(x, ks, flips)
            key = ("rot90_flip_orbit", str(x.dtype).removeprefix("torch."),
                   tuple(x.shape), x.data_ptr() % 16, ks, flips)
            return keep(key, orb, lambda: clone_at(x),
                        lambda: orbit_launch(x, ks, flips))

        sw._launch = recording
        orb._launch = orbit_recording

    def start(self, path, capture=False):
        self.path, self.capture = path, capture

    def stop(self):
        self.path, self.capture = None, False

    def select_launches(self, path=None):
        """{"select_planes/<dtype>": launches with 2+ sources,
        "select_planes/<dtype>,1 source": with one}, over one path or all."""
        out = {}
        for p, name, tag, n in self.rows:
            if name == "select_planes" and path in (None, p):
                key = f"{name}/{tag}" + (",1 source" if n == 1 else "")
                out[key] = out.get(key, 0) + 1
        return out

    def check(self, path):
        """Each captured launch of `path` again through its wrapper, on the
        copy of its inputs, against its plain version: bit-equal (NaN
        payloads and -0.0 count), by the same launch path. Rows named as
        the `kernels` line names the kernel; the copies are let go."""
        sw, orb, rows = self.sw, self.orb, []
        for key, (copies, launch_path) in self.inputs.items():
            name, tag = key[0], key[1]
            if name == "rot90_flip_orbit":
                x, (ks, flips) = copies, key[4:]
                args = orbit_args(ks, flips)
                assert orb._elements(*args) == (ks, flips), (key, args)
                mod, shape, sources = orb, list(x.shape), 1
                run = lambda: orb.rot90_flip_orbit(x, *args)
                plain = lambda: orb.rot90_flip_orbit_plain(x, *args)
                entry = f"{name}[{tag}]"
            else:
                srcs, args = copies
                mod, shape, sources = sw, list(srcs[0].shape), len(srcs)
                run = lambda: sw._select(name, srcs, *args)
                plain = lambda: (sw.select_planes_nhwc_plain(srcs, *args[:2])
                                 if name == "select_planes_nhwc"
                                 else sw.select_planes_plain(srcs, *args))
                entry = f"{name}[{tag}" + (
                    ",1 source]" if name == "select_planes" and sources == 1 else "]")
            mod.reset_launches()
            got, ref = run(), plain()
            sync()
            (replayed,) = mod.path_launches
            row = {"path": path, "kernel": entry, "shape": shape, "sources": sources,
                   "launch_path": launch_path,
                   "max_abs_err": (got.float() - ref.float()).abs().max().item()}
            assert replayed.split("/")[-1] == launch_path, (row, replayed)
            assert torch.equal(orbit_bits(got), orbit_bits(ref)), row
            rows.append(row)
            del got, ref
        self.inputs = {}
        sw.reset_launches()
        orb.reset_launches()
        return rows


def default_canonicalization(cfgmod):
    """The canonicalization group of
    examples/images/classification/configs/default.yaml."""
    return cfgmod.CanonicalizationConfig(
        canonicalization_type="group_equivariant",  # default.yaml:5
        network_type="e2cnn",  # default.yaml:6
        network_hyperparams=cfgmod.NetworkHyperparams(
            kernel_size=3,  # default.yaml:8
            out_channels=16,  # default.yaml:9
            num_layers=2,  # default.yaml:10
            group_type="rotation",  # default.yaml:11
            num_rotations=4),  # default.yaml:12
        beta=1.0,  # default.yaml:13
        input_crop_ratio=0.9,  # default.yaml:14
        resize_shape=64)  # default.yaml:15


def opt_canonicalization(cfgmod, num_rotations):
    """examples/images/classification/configs/canonicalization/
    opt_group_equivariant.yaml (num_rotations 8), or its D4 variant."""
    return cfgmod.CanonicalizationConfig(
        canonicalization_type="opt_group_equivariant",  # opt_group_equivariant.yaml:2
        network_type="cnn",  # opt_group_equivariant.yaml:3
        network_hyperparams=cfgmod.NetworkHyperparams(  # opt_group_equivariant.yaml:4
            kernel_size=5, out_channels=32, num_layers=2,
            group_type="roto-reflection", num_rotations=num_rotations,
            out_vector_size=128),
        beta=1.0,  # opt_group_equivariant.yaml:5
        input_crop_ratio=0.9,  # opt_group_equivariant.yaml:6
        resize_shape=96,  # opt_group_equivariant.yaml:7
        learn_ref_vec=False,  # opt_group_equivariant.yaml:8
        artifact_err_wt=0.0)  # opt_group_equivariant.yaml:9


def orbit_bits(t):
    """The words of a float32 / bfloat16 tensor as integers, so that NaN
    payloads and -0.0 count in a comparison."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def check_orbit_kernel(orb, gen):
    """K4 against its plain version, bit for bit, on ragged cases with a NaN
    and a -0.0 in every input, each on the aligned input and on a
    16-byte-misaligned view of the same values (which takes a tile path);
    every launch path of `_orbit_path` ("word", "tile", "chunk") must run.
    Launches here are not counted as the main paths'."""
    cases, paths = 0, set()
    for dtype in (torch.float32, torch.bfloat16):
        for H in (1, 7, 33, 96, 224):
            for C in (1, 2, 3, 4, 5, 8, 16):
                for b in (1, 5):
                    x = torch.randn(b, H, H, C, generator=gen)
                    x.view(-1)[0] = float("nan")
                    x.view(-1)[-1] = -0.0
                    x = x.to(DEVICE, dtype)
                    for inp in (x, misaligned(x)):
                        for n in (1, 2, 4):
                            for refl in (False, True):
                                for sign in (-1.0, 1.0):
                                    orb.reset_launches()
                                    got = orb.rot90_flip_orbit(inp, n, refl, sign)
                                    ref = orb.rot90_flip_orbit_plain(inp, n, refl, sign)
                                    sync()
                                    (key,) = orb.path_launches
                                    path = key.split("/")[-1]
                                    assert inp is x or path != "word", (H, C, path)
                                    paths.add(path)
                                    assert torch.equal(orbit_bits(got), orbit_bits(ref)), (
                                        "K4", dtype, H, C, b, n, refl, sign, path)
                                    cases += 1
                    del x
    assert paths == {"word", "tile", "chunk"}, paths
    orb.reset_launches()
    log(f"K4 checks: {cases} cases (aligned and misaligned) bit-equal to the "
        f"plain version; paths {sorted(paths)}")
    return {"cases": cases, "paths": sorted(paths)}


def orbit_measure(orb, b, size, c, n, refl, sign, dtype, gen, bwidth):
    """Check and time K4 at one path shape; the yardstick is one
    torch.gather with the flat index of the same permutation (the plain
    version run on index values), built outside the timed window."""
    x = torch.rand(b, size, size, c, generator=gen).to(DEVICE, dtype)
    run = lambda: orb.rot90_flip_orbit(x, n, refl, sign)
    plain = lambda: orb.rot90_flip_orbit_plain(x, n, refl, sign)
    got, ref = run(), plain()
    sync()
    assert torch.equal(orbit_bits(got), orbit_bits(ref)), ("K4", dtype, size)
    iota = torch.arange(x.numel(), device=DEVICE).view_as(x)
    idx = orb.rot90_flip_orbit_plain(iota, n, refl, sign).reshape(-1)
    del iota
    flat = x.reshape(-1)
    lib = lambda: torch.gather(flat, 0, idx)
    assert torch.equal(orbit_bits(lib().view_as(got)), orbit_bits(got)), (
        "K4 gather yardstick differs")
    nbytes = (1 + got.shape[0]) * x.numel() * x.element_size()
    # the kernel outruns its wrapper's host time in bf16: the graph replay
    # times the launches back to back
    g_ms, g_range = graph_ms(run)
    lib_g_ms, lib_g_range = graph_ms(lib)
    out = {**windowed_ms({"ms": run, "library_ms": lib}, reps=10),
           "graph_ms": g_ms, "graph_ms_range": g_range,
           "library_graph_ms": lib_g_ms, "library_graph_ms_range": lib_g_range,
           "plain_ms": cuda_ms(plain, reps=5, warmup=1),
           "library": "torch.gather, precomputed int64 index",
           "max_abs_err": (got.float() - ref.float()).abs().max().item(),
           "bound_ms": nbytes / bwidth * 1e3, "bytes": nbytes,
           "shape": [b, size, size, c], "elements": got.shape[0], "sign": sign}
    del x, got, ref, idx, flat
    return out


def orbit_entries(orb, gen, bwidth, path_launches, main_paths):
    """K4's `kernels` entries, fp32 and bf16: the group-inference launch in
    the main fields, the D4 canonicalizer's under "optimized_d4"."""
    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).removeprefix("torch.")
        shapes = {p: orbit_measure(orb, *shape, dtype, gen, bwidth)
                  for p, shape in ORBIT_SHAPES.items()}
        by_path = {p: counts.get(f"rot90_flip_orbit/{tag}", 0)
                   for p, counts in path_launches.items()}
        paths = {k.split("/")[-1]: v for k, v in main_paths.items()
                 if k.startswith(f"rot90_flip_orbit/{tag}/")}
        entry = {"name": f"rot90_flip_orbit[{tag}]", "route": "cuda",
                 "source": ORBIT_SOURCE, "replaces": ORBIT_TPU,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "paths": paths,
                 "bound_by": "bytes", **shapes["group_inference"],
                 "optimized_d4": shapes["optimized_d4"]}
        entries.append(entry)
        log(f"K4 {tag}: {json.dumps(entry)}")
    return entries


def build_group_inference(tp, resnet):
    """The group-inference model: configs/default.yaml's C4 canonicalizer
    at 224 px through the port's registry (weights from seed 4, BatchNorm
    statistics drawn away from 0 / 1) and the exact preset's ResNet-50."""
    from equiadapt_tpu_torch.utils import config as cfgmod

    torch.manual_seed(4)
    c = default_canonicalization(cfgmod)
    in_shape = (IMAGE, IMAGE, 3)
    canon = tp.get_image_canonicalizer(
        c, tp.get_image_canonicalization_network(c, in_shape, device=DEVICE),
        in_shape, device=DEVICE)
    random_bn_statistics(canon, (torch.nn.BatchNorm2d,))
    return tp.ImageClassifierPipeline(canon, resnet).eval()


def check_group_inference(tp, pipe, batch, metrics, m=8):
    """The orbit's agreement, the CPU run and the other evaluators.

    - Each orbit element's canonical image within 1e-4 of element 0's and
      its predicted class equal, for 99% of the batch (the C4 GCNN is
      exactly rot90-equivariant and the 0.9 crop leaves 11 px on each
      side at 224 px, so crop and resize commute with rot90).
    - group_inference on the first m images: acc_element_g as in the port's
      CPU run, up to the images whose top-2 logit margin is under 2e-3 of
      the largest logit (logits agree within 1e-3 of it, phase 4).
    - vanilla_inference's test/acc equals acc_element_0; make_eval_step's
      metrics are finite."""
    x, labels = batch["image"], batch["label"]
    orbit = tp.materialize_orbit(x, 4, sign=1.0)
    x_c, info = pipe.canonicalize(orbit)  # in the network's layout, as the sweep
    logits = pipe.prediction_network(x_c)
    xc = x_c.reshape(4, GI_B, *x_c.shape[1:])
    pred = logits.argmax(-1).reshape(4, GI_B)
    sel = info.group_activations.argmax(-1).reshape(4, GI_B)
    img_err = (xc - xc[:1]).abs().amax(dim=(0, 2, 3, 4))
    agree = (img_err < 1e-4) & (pred == pred[:1]).all(0)
    shift = torch.arange(4, device=sel.device)[:, None]
    shifted = (sel == (sel[:1] + shift) % 4).all(0)
    share = agree.float().mean().item()
    assert share >= 0.99, (share, img_err.max().item())

    small = {"image": x[:m], "label": labels[:m]}
    gpu = tp.group_inference(pipe, small, num_rotations=4, group_type="rotation")
    pipe_cpu = copy.deepcopy(pipe).to("cpu")
    cpu = tp.group_inference(pipe_cpu, {k: v.cpu() for k, v in small.items()},
                             num_rotations=4, group_type="rotation")
    lg = logits.reshape(4, GI_B, -1)[:, :m]
    top2 = lg.topk(2, dim=-1).values
    unclear = ((top2[..., 0] - top2[..., 1]) < 2e-3 * lg.abs().max()).sum(1)
    for g in range(4):
        key = f"test/acc_element_{g}"
        gap = abs(gpu[key].item() - cpu[key].item()) * m
        assert gap <= unclear[g].item() + 1e-6, (key, gpu[key], cpu[key], unclear)

    van = tp.vanilla_inference(pipe, batch, GI_CLASSES)
    assert van["test/acc"].item() == metrics["test/acc_element_0"].item(), (
        van["test/acc"], metrics["test/acc_element_0"])
    loss_kwargs = {  # configs/default.yaml:23-26 and :5
        "task_weight": 1.0, "prior_weight": 100.0, "group_contrast_weight": 0.0,
        "canonicalization_type": "group_equivariant"}
    ev = tp.make_eval_step(loss_kwargs)(pipe, batch)
    assert all(bool(torch.isfinite(v).all()) for v in ev.values()), ev
    return {"share_orbit_agrees": share,
            "max_abs_image": img_err.max().item(),
            "share_selection_shifted": shifted.float().mean().item(),
            "cpu": {"images": m, "gpu": {k: v.item() for k, v in gpu.items()},
                    "cpu": {k: v.item() for k, v in cpu.items()},
                    "unclear_margins": unclear.tolist()},
            "vanilla_acc": van["test/acc"].item(),
            "eval_step": {k: v.item() for k, v in ev.items()}}


def time_group_inference(tp, pipe, batch):
    """Times of the sweep and of its parts, and its device profile."""
    x = batch["image"]
    sweep = lambda: tp.group_inference(pipe, batch, num_rotations=4,
                                       group_type="rotation")
    orbit = tp.materialize_orbit(x, 4, sign=1.0)
    x_c = pipe.canonicalize(orbit)[0]  # in the network's layout, as the sweep
    t_gi = cuda_ms(sweep, reps=5)
    times = {"group_inference_ms": t_gi,
             "orbit_img_per_s": orbit.shape[0] / t_gi * 1e3,
             "orbit_ms": cuda_ms(lambda: tp.materialize_orbit(x, 4, sign=1.0), reps=10),
             "canonicalize_ms": cuda_ms(lambda: pipe.canonicalize(orbit), reps=5),
             "resnet50_ms": cuda_ms(lambda: pipe.prediction_network(x_c), reps=5)}
    log(f"group_inference: {json.dumps(times)}")
    rows = device_profile(sweep)
    times["profile"] = {"group_inference": rows}
    log(f"group_inference profile: {json.dumps(rows[:12] + rows[-1:])}")
    return times


def build_optimized(tp, resnet):
    """opt_group_equivariant.yaml (D8) and its D4 variant through the port's
    registry, with the same ConvNetwork weights (seed 5, BatchNorm
    statistics drawn away from 0 / 1) and reference vector (seed 6), each
    before the exact preset's ResNet-50 (10 classes, small_images=False as
    examples/images/classification/train.py:66 sets for 96 px)."""
    from equiadapt_tpu_torch.utils import config as cfgmod

    in_shape = (OPT_IMAGE, OPT_IMAGE, 3)
    pipes = {}
    for path, n in (("optimized_d8", 8), ("optimized_d4", 4)):
        torch.manual_seed(5)
        c = opt_canonicalization(cfgmod, n)
        net = tp.get_image_canonicalization_network(c, in_shape, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(6)
        canon = tp.get_image_canonicalizer(c, net, in_shape, device=DEVICE,
                                           generator=gen)
        random_bn_statistics(canon, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))
        pipes[path] = tp.ImageClassifierPipeline(canon, resnet).eval()
    return pipes


def check_optimized_against_cpu(canon, x, x_c, info, m=8):
    """The first m images against the port's CPU run (plain kernels).
    Bars (fp32, TF32 off): group activations (cosines) within 1e-4, the
    vectors ending in a 14,112-term fp32 dot product summed in another
    order; selections equal where the CPU's top-2 margin exceeds 1e-4 (at
    least half of the images); canonical images within 1e-5 (the same
    permutation, or the same static taps, of the same input)."""
    canon_cpu = copy.deepcopy(canon).to("cpu")
    xc_r, info_r = canon_cpu.canonicalize(x[:m].cpu())
    acts = info_r.group_activations
    top2 = acts.sort(dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    sel = info.group_activations[:m].argmax(-1).cpu()
    same = sel == acts.argmax(-1)
    assert clear.sum() >= m // 2 and bool(same[clear].all()), (sel, acts)
    d_act = (info.group_activations[:m].cpu() - acts).abs().max().item()
    d_img = (x_c[:m].cpu()[same] - xc_r[same]).abs().max().item()
    assert d_act < 1e-4 and d_img < 1e-5, (d_act, d_img)
    return {"images": m, "same_element": int(same.sum()), "max_abs_act": d_act,
            "max_abs_image": d_img}


def check_optimized_shift(canon, x):
    """D4: canonicalizing rot90(x) selects the next rotation of the same
    coset, for 99% of the batch, at the symmetric crop OPT_SYMMETRIC_CROP."""
    n = canon.num_rotations
    crop = canon.input_crop_ratio
    canon.input_crop_ratio = OPT_SYMMETRIC_CROP
    try:
        _, info = canon.canonicalize(x)
        _, info_rot = canon.canonicalize(torch.rot90(x, 1, dims=(1, 2)).contiguous())
    finally:
        canon.input_crop_ratio = crop
    sel = info.group_activations.argmax(-1)
    sel_rot = info_rot.group_activations.argmax(-1)
    ok = (sel_rot % n == (sel % n + 1) % n) & (sel_rot // n == sel // n)
    share = ok.float().mean().item()
    assert share >= 0.99, share
    return {"crop": OPT_SYMMETRIC_CROP, "share_shifted": share}


def time_optimized(path, sw, tp, pipe, x_loader):
    """End-to-end times of one optimized preset on the batch the pipeline
    hands over (NCHW memory for the fp32 ResNet-50), the canonicalizer's
    time on the loader's NHWC batch too (K3), its parts and its device
    profile."""
    canon, resnet = pipe.canonicalizer, pipe.prediction_network
    x = tp.to_network_layout(x_loader, resnet)
    t_bare = cuda_ms(lambda: resnet(x), reps=5)
    t_wrapped = cuda_ms(lambda: resnet(canon.canonicalize(x)[0]), reps=5)
    t_canon = cuda_ms(lambda: canon.canonicalize(x), reps=5)
    t_canon_nhwc = cuda_ms(lambda: canon.canonicalize(x_loader), reps=5)
    x_r = canon.transformations_before_canonicalization_network_forward(x)
    orbit = canon.group_augment(x_r)
    n = canon.num_rotations
    idx = canon.canonicalize(x)[1].onehot.reshape(x.shape[0], -1, n).sum(1).argmax(-1)
    times = {
        "resnet50_ms": t_bare, "canon_resnet50_ms": t_wrapped,
        "canonicalize_ms": t_canon, "canonicalize_nhwc_ms": t_canon_nhwc,
        "canonicalize_img_per_s": x.shape[0] / t_canon * 1e3,
        "overhead_pct": (t_wrapped - t_bare) / t_bare * 100.0,
        "to_network_layout_ms": cuda_ms(lambda: tp.to_network_layout(x_loader, resnet)),
        "parts_ms": {
            "crop_resize": cuda_ms(
                lambda: canon.transformations_before_canonicalization_network_forward(x)),
            "orbit": cuda_ms(lambda: canon.group_augment(x_r)),
            "network": cuda_ms(lambda: canon.canonicalization_network(orbit)),
            "select": cuda_ms(lambda: sw.rotate_select(
                x, idx, n, -1.0, canon.padding_mode, canon.warp_mode)),
        },
    }
    log(f"{path}: {json.dumps(times)}")
    rows = device_profile(lambda: canon.canonicalize(x))
    times["profile"] = {"canonicalize": rows}
    log(f"{path} profile canonicalize: {json.dumps(rows[:12] + rows[-1:])}")
    return times


def device_profile(fn, top: int = 25):
    """Device time by kernel name over one call of fn (after a warm-up
    call): [name, ms, calls] rows, largest first, then the total (kernels
    only: user annotations are left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        sync()
    rows = []
    for e in p.key_averages():  # kernel rows only: operator rows repeat them
        # a user annotation's span on the device timeline (the optimizer's
        # "Optimizer.step#AdamW.step") covers kernels counted in their own rows
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append([e.key[:90], us / 1e3, e.count])
    rows.sort(key=lambda r: -r[1])
    return rows[:top] + [["all kernels", sum(r[1] for r in rows),
                          sum(r[2] for r in rows)]]


def time_preset(preset, canon, resnet, x, yy, **invert_kw):
    """End-to-end times of one preset and its device profile."""
    t_bare = cuda_ms(lambda: resnet(x), reps=5)
    t_wrapped = cuda_ms(lambda: resnet(canon.canonicalize(x)[0]), reps=5)
    t_canon = cuda_ms(lambda: canon.canonicalize(x), reps=5)

    def canon_invert():
        _, inf = canon.canonicalize(x)
        canon.invert_canonicalization(inf, yy, **invert_kw)

    t_ci = cuda_ms(canon_invert, reps=5)
    times = {
        "resnet50_ms": t_bare, "canon_resnet50_ms": t_wrapped,
        "canonicalize_ms": t_canon, "canon_invert_ms": t_ci,
        "canon_invert_img_per_s": B / t_ci * 1e3,
        "overhead_pct": (t_wrapped - t_bare) / t_bare * 100.0,
    }
    log(f"{preset}: {json.dumps(times)}")
    prof = {"canon_invert": device_profile(canon_invert),
            "resnet50": device_profile(lambda: resnet(x))}
    times["profile"] = prof
    for part, rows in prof.items():
        log(f"{preset} profile {part}: {json.dumps(rows[:12] + rows[-1:])}")
    return times


def nchw_view(x):
    """The same values as a (B, H, W, C) view of NCHW memory."""
    return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def with_payloads(x):
    """x with a NaN carrying a payload first and a -0.0 last, so that a
    comparison of the words sees whether they were moved bit for bit."""
    words = orbit_bits(x).view(-1)
    words[0] = 0x7FC00123 if x.element_size() == 4 else 0x7FC3
    x.view(-1)[-1] = -0.0
    return x


def check_k3_kernel(sw, gen):
    """K3 against its plain version and against K1 on the same data in NCHW
    memory, as integers: N in {1, 31, 32, 33, 97, 224}, C in {1, 2, 3, 4,
    5, 16}, 1 to 4 sources, every k (some negative), fp32 and bf16, a NaN
    payload and a -0.0 in every source; each case also on 16-byte-misaligned
    views of the same sources, which must take the tile path. Launches here
    are not counted as the main paths'."""
    cases, paths = 0, set()
    for dtype in (torch.float32, torch.bfloat16):
        for N in (1, 31, 32, 33, 97, 224):
            b = 4 if N == 224 else 8
            for C in (1, 2, 3, 4, 5, 16):
                for S in (1, 2, 3, 4):
                    srcs = [with_payloads(torch.randn(b, N, N, C, generator=gen)
                                          .to(dtype)).to(DEVICE) for _ in range(S)]
                    src = torch.randint(0, S, (b,), generator=gen).int().to(DEVICE)
                    k = (torch.arange(b) % 4 + 4 * torch.randint(-2, 2, (b,),
                         generator=gen)).int().to(DEVICE)  # every k, some negative
                    ref = sw.select_planes_nhwc_plain(srcs, src, k)
                    k1 = sw.select_planes([s.permute(0, 3, 1, 2).contiguous()
                                           for s in srcs], src, k)
                    k1 = k1.permute(0, 2, 3, 1).contiguous()
                    views = []
                    for s_ in srcs:
                        v = torch.empty(s_.numel() + 1, dtype=dtype,
                                        device=DEVICE)[1:].view_as(s_)
                        views.append(v.copy_(s_))
                    for inp in (srcs, views):
                        got = sw.select_planes_nhwc(inp, src, k)
                        sync()
                        path = sw._nhwc_path(inp, got)
                        assert inp is srcs or path == "tile", (N, C, path)
                        paths.add(path)
                        assert got.is_contiguous()
                        assert torch.equal(orbit_bits(got), orbit_bits(ref)), (
                            "K3", dtype, N, C, S, path)
                        assert torch.equal(orbit_bits(got), orbit_bits(k1)), (
                            "K3 vs K1", dtype, N, C, S, path)
                    cases += 1
    assert paths == {"word", "tile"}, paths
    log(f"K3 checks: {cases} cases, each on aligned and misaligned sources, "
        f"bit-equal to the plain version and to K1; paths {sorted(paths)}")
    return {"cases": cases, "paths": sorted(paths)}


def check_serving_against_cpu(canon, resnet, x, y, x_c, info, logits, y_inv, m=8):
    """The serving preset's first m samples against the port's CPU run
    (plain kernels, the CPU's bf16 convolutions). Bars: group activations
    within 5e-2 of the largest (a bf16 energy network, 8 bits of mantissa,
    summed in another order); the same element where the CPU's top-2
    margin exceeds 5e-2 of the largest activation; on the samples with the
    same element the canonical images and the inverted maps equal at
    quarter-turn elements and within 2 bf16 ulps of the largest value at
    45-degree ones (two bf16 products summed in another order); logits
    within 5e-2 of the largest."""
    canon_cpu = copy.deepcopy(canon).to("cpu")
    resnet_cpu = copy.deepcopy(resnet).to("cpu")
    xc_r, info_r, logits_r, yi_r = run_path(canon_cpu, resnet_cpu,
                                            x[:m].cpu(), y[:m].cpu())
    acts = info_r.group_activations
    scale = acts.abs().max().item()
    top2 = acts.sort(dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 5e-2 * scale
    sel = info.onehot[:m].argmax(-1).cpu()
    same = sel == info_r.onehot.argmax(-1)
    assert bool(same[clear].all()), (sel, acts)
    quarter = same & (sel % 2 == 0)
    odd = same & (sel % 2 == 1)

    def worst(a, b, mask):
        return (a[mask].float() - b[mask].float()).abs().max().item() if mask.any() else 0.0

    xg, yg = x_c[:m].cpu(), y_inv[:m].cpu()
    out = {"samples": m, "same_element": int(same.sum()), "clear": int(clear.sum()),
           "max_abs_act": (info.group_activations[:m].cpu() - acts).abs().max().item(),
           "quarter_equal": bool(torch.equal(xg[quarter], xc_r[quarter])
                                 and torch.equal(yg[quarter], yi_r[quarter])),
           "max_abs_image_45": worst(xg, xc_r, odd),
           "max_abs_invert_45": worst(yg, yi_r, odd),
           "max_rel_logit": ((logits[:m].cpu().float() - logits_r.float()).abs().max()
                             / logits_r.float().abs().max()).item()}
    bar_x = 2 * 2.0**-8 * x.float().abs().max().item()
    bar_y = 2 * 2.0**-8 * y.float().abs().max().item()
    assert (out["max_abs_act"] < 5e-2 * scale and out["quarter_equal"]
            and out["max_abs_image_45"] <= bar_x and out["max_abs_invert_45"] <= bar_y
            and out["max_rel_logit"] < 5e-2), out
    return out


def check_serving_equivariance(canon, x, x_c, info):
    """canonicalize(rot90(x)) selects the element shifted by two for 99% of
    the samples whose top-2 margin exceeds 1e-2 of the largest activation
    (the bf16 energy network is rot90-equivariant up to its rounding); where
    the element is a quarter turn the canonical images are equal (the same
    permutation of the same bf16 values). The 45-degree ones differ by the
    two-pass residual and are reported."""
    x_rot = torch.rot90(x, 1, dims=(1, 2))
    x_rot = x_rot.contiguous() if x.is_contiguous() else nchw_view(x_rot)
    x_c_rot, info_rot = canon.canonicalize(x_rot)
    acts = info.group_activations
    top2 = acts.sort(dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-2 * acts.abs().max()
    sel = info.onehot.argmax(-1)
    ok = info_rot.onehot.argmax(-1) == (sel + 2) % NUM_ROT
    share = ok[clear].float().mean().item()
    quarter = ok & (sel % 2 == 0)
    err_q = (x_c_rot[quarter].float() - x_c[quarter].float()).abs().max().item()
    odd = ok & (sel % 2 == 1)
    err_o = ((x_c_rot[odd].float() - x_c[odd].float()).abs().max().item()
             if odd.any() else 0.0)
    assert share >= 0.99 and err_q == 0.0, (share, err_q)
    return {"share_shifted_clear": share, "clear": int(clear.sum()),
            "max_abs_image_quarter": err_q, "max_abs_image_45": err_o}


def time_param_dtype(resnet_bf16, xs):
    """ResNet-50 in bf16 with its fp32 parameters (cast per call, as Flax
    keeps them) against a bf16 copy of it (every parameter and BatchNorm
    statistic bf16), per input layout."""
    r16 = copy.deepcopy(resnet_bf16).to(torch.bfloat16)
    out = {}
    for layout, x in xs.items():
        out[layout] = {"fp32_params_ms": cuda_ms(lambda: resnet_bf16(x), reps=5),
                       "bf16_params_ms": cuda_ms(lambda: r16(x), reps=5)}
    log(f"resnet50 bf16 by parameter dtype: {json.dumps(out)}")
    del r16
    return out


def build_trainer(tp, mode, dropout_rate=0.5):
    """bench.py's trainer: C8 EquivariantNetwork(3 -> 8, 3x3, 2 layers),
    crop 0.9, resize 64, ResNet-50 (10 classes); "bf16_fast": fast warp,
    bf16 energy network and ResNet-50 over fp32 parameters; "fp32_exact":
    static-tap warps, fp32. Weights from seeds 7 and 8."""
    fast = mode == "bf16_fast"
    torch.manual_seed(7)
    net = tp.EquivariantNetwork(3, 8, 3, group_type="rotation", num_rotations=NUM_ROT,
                                num_layers=2, dropout_rate=dropout_rate, device=DEVICE)
    canon = tp.GroupEquivariantImageCanonicalization(
        net, in_shape=(IMAGE, IMAGE, 3), input_crop_ratio=0.9, resize_shape=64,
        num_rotations=NUM_ROT, group_type="rotation",
        warp_mode="fast" if fast else "exact",
        compute_dtype=torch.bfloat16 if fast else None)
    torch.manual_seed(8)
    resnet = tp.ResNet50(num_classes=10, device=DEVICE,
                         dtype=torch.bfloat16 if fast else torch.float32)
    return tp.ImageClassifierPipeline(canon, resnet)


def train_phase(tp, sw, mode, gen):
    """The trainer at full width: the loss over TRAIN_FALL_STEPS steps on one
    fixed batch (finite, falling), then ms per step by CUDA events over
    TRAIN_TIMED_STEPS steps after two warm-up steps, img/s and the peak
    memory of those steps; then a validation `make_eval_step` on the
    loader's NHWC-contiguous batch, whose select launches are counted: K3
    in bf16-fast, K1 in fp32-exact (the pipeline hands the fp32 ResNet-50
    NCHW memory)."""
    loss_kw = {"prior_weight": 100.0}
    pipe = build_trainer(tp, mode)
    opt = torch.optim.AdamW(pipe.parameters(), lr=1e-3, weight_decay=1e-4)
    state = tp.create_train_state(pipe, ([opt], []))
    step = tp.make_train_step(loss_kw, watch_gradients=True)
    x = smooth_images(gen, TRAIN_B).contiguous().to(DEVICE)
    labels = torch.randint(0, 10, (TRAIN_B,), generator=gen).to(DEVICE)
    batch = {"image": x, "label": labels}
    dgen = torch.Generator(device=DEVICE).manual_seed(9)
    losses = []
    for _ in range(TRAIN_FALL_STEPS):
        state, m = step(state, batch, dgen)
        losses.append(m["loss/total"].item())
    assert all(math.isfinite(v) for v in losses), losses
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    assert last < first, losses
    for _ in range(2):
        step(state, batch, dgen)
    sync()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_TIMED_STEPS):
        state, m = step(state, batch, dgen)
    end.record()
    sync()
    ms = start.elapsed_time(end) / TRAIN_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    assert math.isfinite(m["loss/total"].item()), m
    out = {"step_ms": ms, "img_per_s": TRAIN_B / ms * 1e3, "peak_mem_gib": peak / 2**30,
           "losses": losses, "grad_norms": {k: v.item() for k, v in m.items()
                                            if k.startswith("grad/")}}
    out["profile"] = device_profile(lambda: step(state, batch, dgen))
    log(f"train {mode} profile: {json.dumps(out['profile'][:12] + out['profile'][-1:])}")
    want = ("select_planes_nhwc/bfloat16" if mode == "bf16_fast"
            else "select_planes/float32")
    sw.reset_launches()
    metrics = tp.make_eval_step(loss_kw)(state.model, {"image": x, "label": labels})
    sync()
    out["validation_launches"] = dict(sw.launches)
    out["validation_paths"] = dict(sw.path_launches)
    assert sw.launches.get(want, 0) >= 1, (mode, sw.launches)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values()), metrics
    out["validation"] = {k: v.item() for k, v in metrics.items()}
    log(f"train {mode}: {json.dumps({k: v for k, v in out.items() if k not in ('losses', 'profile')})}; "
        f"losses {[round(v, 4) for v in losses]}")
    del state, opt, pipe, x, batch
    torch.cuda.empty_cache()
    return out


def step_differences(a, b, before):
    """How far train step `a` ((metrics, state dict)) is from step `b`: the
    loss and each gradient norm relative to b's, the updates by their
    norms relative to b's update, and the largest BatchNorm (and
    NormBatchNorm) statistic difference relative to b's largest value."""
    (ma, sa), (mb, sb) = a, b
    out = {"loss_rel": abs(ma["loss/total"] - mb["loss/total"]) / abs(mb["loss/total"])}
    out["grad_norm_rel"] = {k: abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30)
                            for k in mb if k.startswith("grad/")}
    upd, stats = {}, 0.0
    for top in ("canonicalizer", "prediction_network", "prediction_network.Dense_0"):
        d2 = r2 = 0.0
        for k in sb:
            if not k.startswith(top) or k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var", "norm_sq")):
                stats = max(stats, ((sa[k] - sb[k]).abs().max()
                                    / sb[k].abs().max().clamp(min=1e-30)).item())
                continue
            du_a, du_b = sa[k] - before[k], sb[k] - before[k]
            d2 += ((du_a - du_b) ** 2).sum().item()
            r2 += (du_b ** 2).sum().item()
        upd[top] = math.sqrt(d2 / max(r2, 1e-30))
    out["update_rel"], out["bn_stats_rel"] = upd, stats
    return out


def step_vs_cpu(tp, gen, build=None, spread=False, size=None, loss_kw=None):
    """One fp32-exact train step (SGD, dropout 0, batch TRAIN_CPU_B at 224 px,
    or `size`) from the same weights on the card and on the CPU. Bars: the loss within
    1e-4 relative; the gradient norm of each top-level module within 1e-3
    relative; the BatchNorm running statistics within 1e-4 of each one's
    largest value; the updates, by their norms: the canonicalizer's and
    ResNet-50's head's within 1e-3, the whole ResNet-50's within 5e-2. A
    ReLU input within rounding of 0 takes the other branch on one device,
    and the gradients of the layers below it differ at a few positions;
    50 layers of train-mode BatchNorm at batch 8 spread that: the CPU
    alone, on the same step in channels-last and in NCHW memory, differs
    by 2.0e-2 over ResNet-50's gradients and 3.9e-5 at its head.

    `build()` makes another pipeline (the continuous trainer, whose
    NormBatchNorm statistics count with the BatchNorm ones; the optimized
    D4 trainer), `loss_kw` gives its loss weights. `spread` is for the
    continuous trainer (and the optimized D4 one, `opt_d4_step_vs_cpu`),
    whose step is worse conditioned: the
    canonicalizer's gradient is a sum over every pixel of ResNet-50's input
    gradient times the image's slope at the sample points, mostly
    cancelling. So the CPU also takes the step on the batch times
    (1 + 1e-7 noise), and each gradient-norm and update bar is the larger
    of the one above and three times the CPU's own difference there (the
    CPU, measured: 1.3e-2 on the canonicalizer's gradient norm, 3.7e-2 and
    4.9e-2 on the canonicalizer's and ResNet-50's updates)."""
    loss_kw = loss_kw or {"prior_weight": 100.0}
    pipe = build() if build else build_trainer(tp, "fp32_exact", dropout_rate=0.0)
    pipe_cpu = copy.deepcopy(pipe).to("cpu")
    x = smooth_images(gen, TRAIN_CPU_B, size).contiguous()
    labels = torch.randint(0, 10, (TRAIN_CPU_B,), generator=gen)
    before = {k: v.detach().cpu().clone() for k, v in pipe.state_dict().items()}
    runs = [(DEVICE, pipe, x), ("cpu", pipe_cpu, x)]
    if spread:
        noise = torch.randn(x.shape, generator=gen)
        runs.append(("cpu", copy.deepcopy(pipe_cpu), x * (1.0 + 1e-7 * noise)))
    res = []
    for dev, model, xx in runs:
        opt = torch.optim.SGD(model.parameters(), lr=0.01)
        state = tp.create_train_state(model, ([opt], []))
        batch = {"image": xx.to(dev), "label": labels.to(dev)}
        _, m = tp.make_train_step(loss_kw, watch_gradients=True)(state, batch)
        res.append(({k: v.item() for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in model.state_dict().items()}))
    out = step_differences(res[0], res[1], before)
    grad_bar = {k: 1e-3 for k in out["grad_norm_rel"]}
    upd_bar = {"canonicalizer": 1e-3, "prediction_network": 5e-2,
               "prediction_network.Dense_0": 1e-3}
    if spread:
        own = step_differences(res[2], res[1], before)
        out["cpu_spread"] = own
        grad_bar = {k: max(v, 3 * own["grad_norm_rel"][k]) for k, v in grad_bar.items()}
        upd_bar = {k: max(v, 3 * own["update_rel"][k]) for k, v in upd_bar.items()}
    out["bars"] = {"grad_norm_rel": grad_bar, "update_rel": upd_bar}
    del pipe, pipe_cpu
    torch.cuda.empty_cache()
    return out


def train_vs_cpu(tp, gen, **kw):
    """`step_vs_cpu`, logged and held to its bars."""
    return held_to_bars(step_vs_cpu(tp, gen, **kw))


def held_to_bars(out):
    """The bars of `step_vs_cpu`: the loss and the BatchNorm statistics
    within 1e-4 unless `out["bars"]` names others."""
    log(f"train step vs CPU: {json.dumps(out)}")
    bars = out["bars"]
    assert out["loss_rel"] < bars.get("loss_rel", 1e-4), out
    assert all(v < bars["grad_norm_rel"][k] for k, v in out["grad_norm_rel"].items()), out
    assert all(v < bars["update_rel"][k] for k, v in out["update_rel"].items()), out
    assert out["bn_stats_rel"] < bars.get("bn_stats_rel", 1e-4), out
    return out


def invert_diff_phase(tp, sw, gen):
    """`invert_regular_fast_diff` forward and backward on a (B, 224, 224, 16)
    map, C4, D4, C8 and D8, fp32 and bf16, with a random cotangent. K2 must
    launch twice (forward, and the map's cotangent). Against the CPU run of
    the first 8 samples: the map's cotangent `torch.equal` at C4 / D4 (a
    permutation) and, at C8 / D8, within 1e-4 of its largest value (fp32)
    or two bf16 ulps: the 45-degree source is a two-pass product whose tap
    weights are fractions of sample positions up to 224, known to one fp32
    ulp there (1.5e-5; the card divides by a host scalar as a product with
    its reciprocal), two taps in each of two passes. The fp32 bar was set
    from the readings on an H100: 8.9e-5 of a largest value of 5.06 (1.8e-5
    of it) failed the first bar, 2e-6 of it. The run also reads a wrong
    element (every sample one step on) against the CPU and asserts that
    the bar lies below that reading. The one-hot's and the
    reflection's cotangents (fp32 sums over the map) within 1e-4 of their
    largest value at C4 / D4 and 1e-3 at C8 / D8 (central differences of
    those 45-degree values) in fp32, 1e-2 in bf16."""
    out = {}
    for n, reflect in ((4, False), (4, True), (8, False), (8, True)):
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).removeprefix("torch.")
            fm = torch.randn(B, IMAGE, IMAGE, FEATURE_CH, generator=gen).to(DEVICE, dtype)
            idx = torch.randint(0, n, (B,), generator=gen)
            oh = F.one_hot(idx, n).to(DEVICE, dtype)
            refl = (torch.randint(0, 2, (B,), generator=gen).to(DEVICE, dtype)
                    if reflect else None)
            g = torch.randn(B, IMAGE, IMAGE, FEATURE_CH, generator=gen).to(DEVICE, dtype)

            def run(fm=fm, oh=oh, refl=refl, g=g, m=None):
                sl = slice(None) if m is None else slice(0, m)
                leaves = [t[sl].detach().requires_grad_(True)
                          for t in (fm, oh, refl) if t is not None]
                with torch.enable_grad():
                    y = tp.invert_regular_fast_diff(
                        leaves[0], leaves[1], leaves[2] if reflect else None, n)
                    grads = torch.autograd.grad(y, leaves, g[sl])
                return y.detach(), grads

            sw.reset_launches()
            y, grads = run()
            sync()
            k2_launches = sw.launches.get(f"select_planes_rolled/{tag}", 0)
            k2_paths = dict(sw.path_launches)
            assert sw.launches == {f"select_planes_rolled/{tag}": 2}, sw.launches
            ms = cuda_ms(run, reps=3, warmup=1)
            cpu = [t[:8].cpu() if t is not None else None for t in (fm, oh, refl, g)]
            y_c, grads_c = run(*cpu)
            d_x = (grads[0][:8].cpu().float() - grads_c[0].float()).abs().max().item()
            d_wrong = None
            if n == 4:
                assert torch.equal(grads[0][:8].cpu(), grads_c[0]), (n, reflect, tag)
                assert torch.equal(y[:8].cpu(), y_c), (n, reflect, tag)
            else:
                bar = ((1e-4 if dtype == torch.float32 else 2 * 2.0**-8)
                       * grads_c[0].float().abs().max().item())
                oh_wrong = F.one_hot((idx[:8] + 1) % n, n).to(dtype)
                _, grads_w = run(cpu[0], oh_wrong, cpu[2], cpu[3])
                d_wrong = (grads_w[0].float() - grads_c[0].float()).abs().max().item()
                assert d_x <= bar < d_wrong, (n, reflect, tag, d_x, bar, d_wrong)
            rel = []
            for a, b_ in zip(grads[1:], grads_c[1:]):
                scale = b_.float().abs().max().clamp(min=1e-30)
                rel.append(((a[:8].cpu().float() - b_.float()).abs().max() / scale).item())
            bar = 1e-2 if dtype == torch.bfloat16 else (1e-4 if n == 4 else 1e-3)
            assert max(rel) <= bar, (n, reflect, tag, rel)
            key = f"{'D' if reflect else 'C'}{n}/{tag}"
            out[key] = {"fwd_bwd_ms": ms, "max_abs_map_grad": d_x,
                        "max_abs_map_grad_wrong_element": d_wrong,
                        "rel_onehot_grad": rel[0],
                        "rel_reflection_grad": rel[1] if reflect else None,
                        "launches": k2_launches, "paths": k2_paths}
            log(f"invert_regular_fast_diff {key}: {json.dumps(out[key])}")
            del fm, oh, refl, g, y, grads
    torch.cuda.empty_cache()
    return out


def steerable_canonicalization(cfgmod, warp_mode, compute_dtype):
    """examples/images/classification/configs/canonicalization/steerable.yaml,
    warped in `warp_mode` with `compute_dtype`."""
    return cfgmod.CanonicalizationConfig(
        canonicalization_type="steerable",  # steerable.yaml:2
        network_type="e2cnn",  # steerable.yaml:3
        network_hyperparams=cfgmod.NetworkHyperparams(  # steerable.yaml:4
            kernel_size=9, out_channels=16, num_layers=2, group_type="rotation"),
        input_crop_ratio=0.9,  # steerable.yaml:5
        resize_shape=64,  # steerable.yaml:6
        warp_mode=warp_mode, compute_dtype=compute_dtype)


def opt_steerable_canonicalization(cfgmod):
    """examples/images/classification/configs/canonicalization/
    opt_steerable.yaml."""
    return cfgmod.CanonicalizationConfig(
        canonicalization_type="opt_steerable",  # opt_steerable.yaml:2
        network_type="cnn",  # opt_steerable.yaml:3
        network_hyperparams=cfgmod.NetworkHyperparams(  # opt_steerable.yaml:4
            kernel_size=5, out_channels=32, num_layers=2, group_type="rotation",
            out_vector_size=4),
        input_crop_ratio=0.9,  # opt_steerable.yaml:5
        resize_shape=96)  # opt_steerable.yaml:6


def flat_grads(module):
    return torch.cat([p.grad.detach().float().reshape(-1).cpu()
                      for p in module.parameters()])


def continuous_train_phase(tp, sr, bw, gen):
    """bench.py's steer_train (bench.py:412-433, 458-460) at full width: the
    continuous presets' canonicalizer (`steerable_net`), batch 256 at
    224 px, canonicalize with training=True, loss sum(x_c) + 1e-3
    sum(matrix_rep^2), backward to the network's parameters; fast / bf16
    (K5 then K6 forward, once each; the image needs no cotangent) and
    exact / fp32 (autograd through the sample coordinates, no kernel).
    Checks: every parameter's gradient finite and non-zero; the gradients
    of a step on the first CONT_TRAIN_CPU_B samples against the same step
    on the CPU (plain kernel versions), relative to their norm within 1e-3
    (fp32) or 5e-2 (bf16: the first convolution and the warp in bf16).
    Then the scalar invert with training=True of a (256, 224, 224, 16) bf16
    map (fast): K5 and K6 run for canonicalize, for the invert and, in the
    backward, on the map's cotangent, three launches each. Times: ms per
    forward + backward (medians of windows, CUDA events) and peak memory."""
    out = {}
    net = steerable_net(tp)
    common = dict(in_shape=(IMAGE, IMAGE, 3), input_crop_ratio=0.9,
                  resize_shape=64, group_type="rotation")
    modes = {"fast_bf16": dict(warp_mode="fast", compute_dtype=torch.bfloat16),
             "exact_fp32": dict(warp_mode="exact")}
    want = {"fast_bf16": {"rot90_centered_select/bfloat16": 1,
                          "shear_rotate_residual/bfloat16": 1},
            "exact_fp32": {}}
    x = lowfreq_images(gen).to(DEVICE)

    def step(canon, model, xx):
        model.zero_grad(set_to_none=True)
        x_c, info = canon.canonicalize(xx, training=True)
        loss = x_c.float().sum() + 1e-3 * (info.matrix_rep.float() ** 2).sum()
        loss.backward()
        return loss

    for mode, kw in modes.items():
        canon = tp.SteerableImageCanonicalization(net, **kw, **common)
        net_cpu = copy.deepcopy(net).to("cpu")
        canon_cpu = tp.SteerableImageCanonicalization(net_cpu, **kw, **common)
        for mod in (sr, bw):
            mod.reset_launches()
        loss = step(canon, net, x)
        sync()
        counts = {**sr.launches, **bw.launches}
        paths = dict(sr.path_launches)
        assert counts == want[mode], (mode, counts)
        assert math.isfinite(loss.item()), (mode, loss)
        for name, p in net.named_parameters():
            # the rotation group reads the first frame vector only: the
            # output layer's coefficients of the second (w_1_*) take none
            unused = name.startswith(f"SteerableConv_{net.num_layers}.w_1_")
            assert bool(torch.isfinite(p.grad).all()), (mode, name)
            assert (p.grad.abs().max().item() > 0) != unused, (mode, name)
        torch.cuda.reset_peak_memory_stats()
        t = windowed_ms({"ms": lambda: step(canon, net, x)}, reps=3)
        peak = torch.cuda.max_memory_allocated()
        step(canon, net, x[:CONT_TRAIN_CPU_B])
        g_dev = flat_grads(net)
        step(canon_cpu, net_cpu, x[:CONT_TRAIN_CPU_B].cpu())
        g_cpu = flat_grads(net_cpu)
        rel = ((g_dev - g_cpu).norm() / g_cpu.norm()).item()
        bar = 5e-2 if mode == "fast_bf16" else 1e-3
        assert rel <= bar, (mode, rel)
        out[mode] = {"fwd_bwd_ms": t["ms"], "fwd_bwd_ms_range": t["ms_range"],
                     "peak_mem_gib": peak / 2**30, "launches": counts, "paths": paths,
                     "grad_rel_vs_cpu": rel, "grad_bar": bar}
        log(f"continuous train {mode}: {json.dumps(out[mode])}")
        del canon_cpu, net_cpu

    canon = tp.SteerableImageCanonicalization(net, **modes["fast_bf16"], **common)
    fm = lowfreq_images(gen, FEATURE_CH).to(DEVICE, torch.bfloat16)

    def invert_step():
        net.zero_grad(set_to_none=True)
        leaf = fm.detach().requires_grad_(True)
        _, info = canon.canonicalize(x, training=True)
        y = canon.invert_canonicalization(info, leaf, "scalar", training=True)
        y.float().sum().backward()
        return y.detach(), leaf.grad

    for mod in (sr, bw):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    y, g_map = invert_step()
    sync()
    peak = torch.cuda.max_memory_allocated()
    counts = {**sr.launches, **bw.launches}
    paths = dict(sr.path_launches)
    assert counts == {"rot90_centered_select/bfloat16": 3,
                      "shear_rotate_residual/bfloat16": 3}, counts
    assert y.shape == fm.shape and g_map.shape == fm.shape
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(g_map.float()).all())
    assert g_map.float().abs().max().item() > 0
    for name, p in net.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
    del y, g_map
    t = windowed_ms({"ms": invert_step}, reps=2)
    out["invert_fast_bf16"] = {"fwd_bwd_ms": t["ms"], "fwd_bwd_ms_range": t["ms_range"],
                               "peak_mem_gib": peak / 2**30, "launches": counts,
                               "paths": paths, "shape": list(fm.shape)}
    log(f"continuous train invert: {json.dumps(out['invert_fast_bf16'])}")
    del fm, x, canon, net
    torch.cuda.empty_cache()
    return out


def build_continuous_trainer(tp, mode):
    """configs/canonicalization/steerable.yaml through the port's registry
    (weights from seed 21), ResNet-50 (10 classes, seed 8); "bf16_fast":
    fast warp, bf16 network input and warp, bf16 ResNet-50 over its own
    parameters; "fp32_exact": exact warp, fp32."""
    from equiadapt_tpu_torch.utils import config as cfgmod

    fast = mode == "bf16_fast"
    c = steerable_canonicalization(cfgmod, "fast" if fast else "exact",
                                   "bfloat16" if fast else None)
    in_shape = (IMAGE, IMAGE, 3)
    torch.manual_seed(21)
    canon = tp.get_image_canonicalizer(
        c, tp.get_image_canonicalization_network(c, in_shape, device=DEVICE),
        in_shape, device=DEVICE)
    torch.manual_seed(8)
    resnet = tp.ResNet50(num_classes=10, device=DEVICE,
                         dtype=torch.bfloat16 if fast else torch.float32)
    return tp.ImageClassifierPipeline(canon, resnet)


def continuous_trainer_phase(tp, sr, bw, mode, gen):
    """The continuous trainer at full width (phase 17): steerable.yaml's
    canonicalizer before ResNet-50, batch 128 at 224 px, AdamW(1e-3), prior
    weight 100; the loss over TRAIN_FALL_STEPS steps on one fixed batch
    (finite, falling), ms per step by CUDA events over TRAIN_TIMED_STEPS
    steps after two warm-up steps, img/s and peak memory. One step's
    launches: in bf16-fast K5 and K6 once each (the canonicalizing warp;
    the image needs no cotangent), in fp32-exact none."""
    loss_kw = {"prior_weight": 100.0}
    pipe = build_continuous_trainer(tp, mode)
    opt = torch.optim.AdamW(pipe.parameters(), lr=1e-3, weight_decay=1e-4)
    state = tp.create_train_state(pipe, ([opt], []))
    step = tp.make_train_step(loss_kw, watch_gradients=True)
    x = lowfreq_images(gen, b=TRAIN_B).to(DEVICE)
    labels = torch.randint(0, 10, (TRAIN_B,), generator=gen).to(DEVICE)
    batch = {"image": x, "label": labels}
    for mod in (sr, bw):
        mod.reset_launches()
    state, m = step(state, batch)
    sync()
    counts = {**sr.launches, **bw.launches}
    paths = dict(sr.path_launches)
    want = ({"rot90_centered_select/bfloat16": 1, "shear_rotate_residual/bfloat16": 1}
            if mode == "bf16_fast" else {})
    assert counts == want, (mode, counts)
    losses = [m["loss/total"].item()]
    for _ in range(TRAIN_FALL_STEPS - 1):
        state, m = step(state, batch)
        losses.append(m["loss/total"].item())
    assert all(math.isfinite(v) for v in losses), losses
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    assert last < first, losses
    for _ in range(2):
        step(state, batch)
    sync()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_TIMED_STEPS):
        state, m = step(state, batch)
    end.record()
    sync()
    ms = start.elapsed_time(end) / TRAIN_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    assert math.isfinite(m["loss/total"].item()), m
    out = {"step_ms": ms, "img_per_s": TRAIN_B / ms * 1e3, "peak_mem_gib": peak / 2**30,
           "losses": losses, "launches_per_step": counts, "paths": paths,
           "grad_norms": {k: v.item() for k, v in m.items() if k.startswith("grad/")}}
    out["profile"] = device_profile(lambda: step(state, batch))
    log(f"continuous trainer {mode} profile: "
        f"{json.dumps(out['profile'][:12] + out['profile'][-1:])}")
    log(f"continuous trainer {mode}: "
        f"{json.dumps({k: v for k, v in out.items() if k not in ('losses', 'profile')})}; "
        f"losses {[round(v, 4) for v in losses]}")
    del state, opt, pipe, x, batch
    torch.cuda.empty_cache()
    return out


def opt_steerable_phase(tp, gen):
    """opt_steerable.yaml through the port's registry (ConvNetwork 5x5, 32
    channels, 2 layers, a 4-vector; crop 0.9, resize 96; exact warp) on
    TRAIN_B images of 224 px: one canonicalize with training=True (dropout
    and the augmentation drawn from a generator on the card), then the
    backward of `steerable_optimization_loss` plus the prior loss; the
    loss and every parameter's gradient finite, the network's gradient
    non-zero; ms per forward + backward (medians of windows) and peak
    memory."""
    from equiadapt_tpu_torch.utils import config as cfgmod

    c = opt_steerable_canonicalization(cfgmod)
    in_shape = (IMAGE, IMAGE, 3)
    torch.manual_seed(22)
    net = tp.get_image_canonicalization_network(c, in_shape, device=DEVICE)
    canon = tp.get_image_canonicalizer(c, net, in_shape, device=DEVICE)
    x = lowfreq_images(gen, b=TRAIN_B).to(DEVICE)
    dgen = torch.Generator(device=DEVICE).manual_seed(23)

    def run():
        net.zero_grad(set_to_none=True)
        _, info = canon.canonicalize(x, training=True, generator=dgen)
        loss = (tp.steerable_optimization_loss(info)
                + tp.prior_regularization_loss(info))
        loss.backward()
        return loss

    loss = run()
    sync()
    assert math.isfinite(loss.item()), loss
    for name, p in net.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
    assert flat_grads(net).abs().max().item() > 0
    torch.cuda.reset_peak_memory_stats()
    t = windowed_ms({"ms": run}, reps=3)
    out = {"fwd_bwd_ms": t["ms"], "fwd_bwd_ms_range": t["ms_range"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "loss": loss.item(), "batch": TRAIN_B}
    log(f"opt_steerable canonicalize fwd + bwd: {json.dumps(out)}")
    del canon, net, x
    torch.cuda.empty_cache()
    return out


def select_gradient_phase(sw, gen):
    """The select kernels carry gradients: `torch.autograd.grad` through
    `rotate_select` on the card (K3 for an NHWC batch, K1 for a view of
    NCHW memory) and through `rotate_roll_select` (K2) against the CPU
    (plain versions), C8, exact and fast, fp32 and bf16, 32 images at
    224 px. Bars: `torch.equal` on the samples whose element is a quarter
    turn (one source: the gradient is one permutation of the cotangent);
    on the 45-degree samples, whose gradient also runs back through the
    residual warp, in fp32 within 1e-5 of the largest value (exact: the
    host's static taps, scattered in another order on the card) or 1e-4
    (fast: the two-pass tap weights, known to an fp32 ulp of positions up
    to 224, `invert_diff_phase`); in bf16 within 8 bf16 ulps of the largest
    value, as the residual's backward scatters and sums its taps in bf16
    (the sources' dtype), in another order on the card. The bf16 bar was
    set from the readings on an H100: 0.25 against a largest value of 9.1
    (7 ulps of it) failed the first bar, 4 ulps. The run also reads a
    wrong element (every sample one step on: the quarter turn next to each
    45-degree one) against the CPU and asserts that each bar lies below
    that reading."""
    b = 32
    out = {}
    for mode in ("exact", "fast"):
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).removeprefix("torch.")
            for route in ("nhwc", "nchw", "rolled"):
                C = FEATURE_CH if route == "rolled" else 3
                x = torch.randn(b, IMAGE, IMAGE, C, generator=gen).to(dtype)
                g = torch.randn(b, IMAGE, IMAGE, C, generator=gen).to(dtype)
                idx = torch.randint(0, NUM_ROT, (b,), generator=gen)

                def grad_on(dev, x=x, g=g, idx=idx, route=route, mode=mode):
                    xx = x.to(dev)
                    xx = nchw_view(xx) if route == "nchw" else xx
                    xx = xx.detach().requires_grad_(True)
                    with torch.enable_grad():
                        if route == "rolled":
                            y = sw.rotate_roll_select(xx, idx.to(dev), idx.to(dev),
                                                      NUM_ROT, 1.0, "zeros", mode=mode)
                        else:
                            y = sw.rotate_select(xx, idx.to(dev), NUM_ROT, -1.0,
                                                 "border", mode)
                        assert y.grad_fn is not None, route
                        (gx,) = torch.autograd.grad(y, xx, g.to(dev))
                    return gx.cpu()

                sw.reset_launches()
                got = grad_on(DEVICE)
                sync()
                assert sum(sw.launches.values()) == 2, (route, sw.launches)
                ref = grad_on("cpu")
                wrong = grad_on("cpu", idx=(idx + 1) % NUM_ROT)
                quarter = idx % 2 == 0
                assert torch.equal(got[quarter], ref[quarter]), (mode, tag, route)
                err = (got[~quarter].float() - ref[~quarter].float()).abs().max().item()
                err_wrong = (wrong[~quarter].float() - ref[~quarter].float()).abs().max().item()
                scale = ref.float().abs().max().item()
                if dtype == torch.bfloat16:
                    bar = 8 * 2.0**-8 * scale
                else:
                    bar = (1e-5 if mode == "exact" else 1e-4) * scale
                assert err <= bar < err_wrong, (mode, tag, route, err, bar, err_wrong)
                out[f"{mode}/{tag}/{route}"] = {"max_abs_45": err, "bar": bar,
                                                "max_abs_45_wrong_element": err_wrong}
    log(f"select gradients vs CPU: {json.dumps(out)}")
    return out


def nbody_states(gen, b):
    """(loc, vel, charges) of b graphs of NBODY_N bodies, as bench.py draws
    them: normal positions and velocities, charges +-1."""
    loc = torch.randn(b, NBODY_N, 3, generator=gen)
    vel = torch.randn(b, NBODY_N, 3, generator=gen)
    charges = torch.randint(0, 2, (b, NBODY_N, 1), generator=gen).float() * 2 - 1
    return loc, vel, charges


def nbody_canonicalize_phase(tp, gen):
    """bench.py's n-body canonicalize (phase 18): EuclideanGroupNBody around
    VNDeepSets(hidden 16, 4 layers, "pv"), 512 graphs of 5 bodies, fp32,
    eval (weights from seed 31). Checks: finite outputs of the expected
    shapes; SE(3) invariance: canonicalizing loc Q + s, vel Q for random
    rotations Q and shifts s gives the canonical loc and vel within 1e-3
    (tests/test_nbody.py's bar); the invert gives loc back within 1e-4; the
    first 8 graphs within 1e-4 of the CPU run of the same module. Each bar
    is per graph and widens with the graph's frame: Gram-Schmidt amplifies
    rounding by the condition number kappa of the network's three vectors
    (random weights make a few graphs' vectors nearly dependent: kappa
    has median 10.7 and reaches 8,441 on the CPU, 13.0 and 6,615 on the
    card, whose weights are drawn there), so invariance and the
    CPU comparison take max(bar, 3e-6 kappa max(1, max|loc - t|)), and the
    invert, whose error is (loc - t)(R^T R - I), takes 1e-4 + 2 max|R R^T -
    I| max(1, max|loc - t|) (the one graph at kappa 8,441: 5.4e-4 with an
    orthogonality defect of 4.0e-4). The graphs over the plain bars are
    reported with their kappa. Times: ms
    by CUDA events (median of 5 windows of 10 calls), graphs/s, and the
    kernel launches and device time of one call (profile), so the device's
    busy share."""
    torch.manual_seed(31)
    canon = tp.EuclideanGroupNBody(tp.VNDeepSets(hidden_dim=16, num_layers=4,
                                                 canon_feature="pv", device=DEVICE))
    loc, vel, charges = (t.to(DEVICE) for t in nbody_states(gen, NBODY_B))

    def call(lo=loc, ve=vel):
        return canon.canonicalize(None, loc=lo, vel=ve, charges=charges)

    (cl, cv), info = call()
    sync()
    assert cl.shape == cv.shape == (NBODY_B, NBODY_N, 3)
    assert info.element.rotation.shape == (NBODY_B, 3, 3)
    for t in (cl, cv, info.element.rotation, info.element.translation):
        assert bool(torch.isfinite(t).all())
    Q = random_rotations(NBODY_B, gen).to(DEVICE)
    shift = torch.randn(NBODY_B, 1, 3, generator=gen).to(DEVICE)
    (cl2, cv2), _ = call(loc @ Q + shift, vel @ Q)
    vectors, t = canon.canonicalization_network(loc, vel, charges)
    kappa = torch.linalg.cond(vectors.double().cpu())
    R = info.element.rotation.double().cpu()
    defect = (R @ R.transpose(1, 2) - torch.eye(3, dtype=torch.float64)).abs().amax((1, 2))
    scale = (loc - t[:, None]).abs().amax((1, 2)).double().cpu().clamp(min=1.0)
    inv_err = torch.maximum((cl2 - cl).abs().amax((1, 2)), (cv2 - cv).abs().amax((1, 2))).cpu()
    back_err = (canon.invert_canonicalization(info, cl) - loc).abs().amax((1, 2)).cpu()
    canon_cpu = copy.deepcopy(canon).to("cpu")
    (cl_cpu, cv_cpu), info_cpu = canon_cpu.canonicalize(
        None, loc=loc[:8].cpu(), vel=vel[:8].cpu(), charges=charges[:8].cpu())
    cpu_err = torch.stack([(cl[:8].cpu() - cl_cpu).abs().amax((1, 2)),
                           (cv[:8].cpu() - cv_cpu).abs().amax((1, 2)),
                           (info.element.rotation[:8].cpu()
                            - info_cpu.element.rotation).abs().amax((1, 2))]).amax(0)
    bars = {"invariance": torch.clamp(3e-6 * kappa * scale, min=1e-3),
            "invert": 1e-4 + 2 * defect * scale,
            "cpu": torch.clamp(3e-6 * kappa[:8] * scale[:8], min=1e-4)}
    errs = {"invariance": inv_err, "invert": back_err, "cpu": cpu_err}
    plain = {"invariance": 1e-3, "invert": 1e-4, "cpu": 1e-4}
    out = {"kappa_median": kappa.median().item(), "kappa_max": kappa.max().item(),
           "kappa_first_8_max": kappa[:8].max().item()}
    for k, e in errs.items():
        over = e > plain[k]
        out[k] = {"max": e.max().item(), "over_plain_bar": int(over.sum()),
                  "kappa_over_plain_bar": kappa[:len(e)][over].tolist(),
                  "max_over_bar": (e / bars[k]).max().item()}
    log(f"nbody canonicalize checks: {json.dumps(out)}")
    for k, e in errs.items():
        assert bool((e <= bars[k]).all()), (k, out)
    t = windowed_ms({"ms": call}, reps=10)
    rows = device_profile(call)
    out.update(ms=t["ms"], ms_range=t["ms_range"], graphs_per_s=NBODY_B / t["ms"] * 1e3,
               launches_per_call=rows[-1][2], device_ms=rows[-1][1],
               busy_share=rows[-1][1] / t["ms"], profile=rows[:8] + rows[-1:])
    log(f"nbody canonicalize: {json.dumps(out)}")
    return out


def grads_by_name(module):
    return {n: p.grad.detach().cpu().clone() for n, p in module.named_parameters()}


def nbody_step_vs_cpu(tp, cli, cfg, batch, gen):
    """One train step at dropout 0 from the same weights on the card and on
    the CPU, with the bars of tests/test_torch_port_nbody.py's step against
    JAX: the loss within 1e-5 relative, every gradient element within 1e-4
    of the largest, the AdamW update within 1e-6 where |g| > 1e-3 max|g|.
    The step's gradients pass through Gram-Schmidt of nearly dependent
    frame vectors in a few graphs, which amplifies rounding: the CPU alone,
    on the batch times (1 + 1e-7 noise), moves them by 2.6e-5 to 5.5e-5 of
    the largest (3.9e-5 from a float64 step). So the CPU also takes that step,
    and each bar is the larger of the one above and three times the CPU's
    own difference there (as `train_vs_cpu` does for the continuous
    trainer)."""
    cfg0 = cfg.override("canonicalization.network_hyperparams.dropout=0.0")
    state = cli.build_state(cfg0, DEVICE)
    before = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}
    model_cpu = copy.deepcopy(state.model).to("cpu")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    noisy = {k: v if k == "charges" else v * (1.0 + 1e-7 * torch.randn(v.shape, generator=gen))
             for k, v in cpu_batch.items()}
    step = tp.make_nbody_train_step()
    res = []
    for model, b in ((state.model, batch), (model_cpu, cpu_batch),
                     (copy.deepcopy(model_cpu), noisy)):
        st = tp.create_nbody_state(model, cfg.experiment.learning_rate,
                                   cfg.experiment.weight_decay)
        _, m = step(st, b)
        res.append((m["loss/task"].item(), grads_by_name(model),
                    {n: p.detach().cpu() - before[n] for n, p in model.named_parameters()}))
    gmax = max(v.abs().max().item() for v in res[1][1].values())
    big = {n: v.abs() > 1e-3 * gmax for n, v in res[1][1].items()}

    def differences(a, b):
        (la, ga, ua), (lb, gb, ub) = a, b
        return {"loss_rel": abs(la - lb) / abs(lb),
                "grad_rel_max": max((ga[n] - gb[n]).abs().max().item() for n in gb) / gmax,
                "update_max": max((ua[n] - ub[n]).abs()[big[n]].max().item()
                                  for n in gb if big[n].any())}

    out = differences(res[0], res[1])
    out["cpu_spread"] = spread = differences(res[2], res[1])
    out["bars"] = bars = {"loss_rel": 1e-5,
                          "grad_rel_max": max(1e-4, 3 * spread["grad_rel_max"]),
                          "update_max": max(1e-6, 3 * spread["update_max"])}
    log(f"nbody train step vs CPU: {json.dumps(out)}")
    assert all(out[k] <= bar for k, bar in bars.items()), out
    return out


def nbody_trainer_phase(tp, gen):
    """examples/nbody/configs/default.yaml's trainer at full width (phase
    18): VNDeepSets 16 x 4 ("pv", dropout 0.5) before a GNN 32 x 4, batch
    100, AdamW(1e-3, wd 1e-12), built by the CLI's `build_state`; the data
    simulated on the card by `generate_nbody_dataset` at the CLI's sizes
    (512 train and 128 validation graphs, 5000 leaps, a frame every 100,
    frame 30 -> 40), its time reported. The loss over TRAIN_FALL_STEPS steps
    on one fixed batch (finite, falling); ms per step by CUDA events over
    TRAIN_TIMED_STEPS steps after two warm-up steps, steps/s, the steps'
    peak memory above what was allocated when they began, the kernel launches and device time of one step (profile), so the
    device's busy share; the validation MSE; one step at dropout 0 against
    the CPU (`nbody_step_vs_cpu`, with the CPU's own spread under a 1e-7
    perturbation); one finite train step each of the
    Transformer and VN-DeepSets predictors at the config's widths."""
    from equiadapt_tpu_torch.cli import nbody_train as cli

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = cli.compose([f"config={os.path.join(here, NBODY_CONFIG)}"])
    h, pr, ex = cfg.canonicalization.network_hyperparams, cfg.prediction, cfg.experiment
    assert (h.hidden_dim, h.num_layers, h.canon_feature, h.dropout) == (16, 4, "pv", 0.5), h
    assert (pr.architecture, pr.hidden_dim, pr.num_layers) == ("GNN", 32, 4), pr
    assert (ex.batch_size, ex.learning_rate, ex.weight_decay) == (100, 1e-3, 1e-12), ex
    out = {}
    data = {}
    for split in ("train", "valid"):
        sync()
        t0 = time.perf_counter()
        data[split] = cli.dataset_split(cfg, split, DEVICE)
        sync()
        out[f"simulate_{split}_ms"] = (time.perf_counter() - t0) * 1e3
        n = cli.SPLITS[split][0]
        assert data[split]["loc"].shape == data[split]["loc_end"].shape == (n, NBODY_N, 3)
        assert all(bool(torch.isfinite(v).all()) for v in data[split].values()), split
    state = cli.build_state(cfg, DEVICE)
    step = tp.make_nbody_train_step()
    dgen = torch.Generator(device=DEVICE).manual_seed(32)
    batch = {k: v[:ex.batch_size] for k, v in data["train"].items()}
    losses = []
    for _ in range(TRAIN_FALL_STEPS):
        state, m = step(state, batch, dgen)
        losses.append(m["loss/task"].item())
    assert all(math.isfinite(v) for v in losses), losses
    assert sum(losses[-3:]) / 3 < sum(losses[:3]) / 3, losses
    for _ in range(2):
        step(state, batch, dgen)
    sync()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # earlier phases' tensors too
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_TIMED_STEPS):
        state, m = step(state, batch, dgen)
    end.record()
    sync()
    ms = start.elapsed_time(end) / TRAIN_TIMED_STEPS
    step_mem = torch.cuda.max_memory_allocated() - resident
    assert math.isfinite(m["loss/task"].item()), m
    rows = device_profile(lambda: step(state, batch, dgen))
    val = tp.nbody_eval_mse(state.model, data["valid"]).item()
    assert math.isfinite(val), val
    out.update(step_ms=ms, steps_per_s=1e3 / ms, graphs_per_s=ex.batch_size / ms * 1e3,
               step_peak_mem_gib=step_mem / 2**30,
               launches_per_step=rows[-1][2], device_ms_per_step=rows[-1][1],
               busy_share=rows[-1][1] / ms, val_mse=val, losses=losses,
               profile=rows[:8] + rows[-1:])
    out["vs_cpu"] = nbody_step_vs_cpu(tp, cli, cfg, batch, gen)
    for arch in ("Transformer", "vndeepsets"):
        st = cli.build_state(cfg.override(f"prediction.architecture={arch}"), DEVICE)
        st, m = step(st, batch, dgen)
        assert math.isfinite(m["loss/task"].item()), (arch, m)
        assert all(bool(torch.isfinite(p.grad).all()) for p in st.model.parameters()
                   if p.grad is not None), arch
        out[f"{arch}_loss"] = m["loss/task"].item()
    log(f"nbody trainer: {json.dumps({k: v for k, v in out.items() if k != 'losses'})}; "
        f"losses {[round(v, 4) for v in losses]}")
    del state, data, batch
    torch.cuda.empty_cache()
    return out


def nbody_cli_phase(tp):
    """The n-body CLI on the card (phase 18): one epoch of default.yaml with
    its checkpoint in a temporary directory, then test mode from that
    checkpoint, whose printed test/mse must equal (1e-6) the MSE of the
    trained state on the same test split."""
    import tempfile

    from equiadapt_tpu_torch.cli import nbody_train as cli

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        state = cli.main([f"config={os.path.join(here, NBODY_CONFIG)}",
                          "experiment.num_epochs=1", f"checkpoint.checkpoint_path={ck}"],
                         device=DEVICE)
        sync()
        out["train_s"] = time.perf_counter() - t0
        assert os.path.isfile(os.path.join(ck, "state.pt")), os.listdir(tmp)
        test_args = ["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"]
        t0 = time.perf_counter()
        metrics = cli.main(test_args, device=DEVICE)
        out["test_s"] = time.perf_counter() - t0
        cfg = cli.compose(test_args)
        mse = tp.nbody_eval_mse(state.model, cli.dataset_split(cfg, "test", DEVICE)).item()
    out.update(test_mse=metrics["test/mse"], in_memory_mse=mse)
    log(f"nbody CLI: {json.dumps(out)}")
    assert math.isfinite(mse) and abs(metrics["test/mse"] - mse) <= 1e-6 * max(1.0, mse), out
    return out


def write_cifar10(root, gen):
    """CIFAR-10 python pickles (data_batch_1..5, test_batch) of random uint8
    images, CIFAR_PER_FILE each."""
    import pickle

    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = torch.randint(0, 256, (CIFAR_PER_FILE, 3 * 32 * 32), generator=gen,
                             dtype=torch.uint8).numpy()
        labels = torch.randint(0, 10, (CIFAR_PER_FILE,), generator=gen).tolist()
        with open(os.path.join(d, fname), "wb") as f:
            pickle.dump({b"data": data, b"labels": labels}, f)


def write_stl10(root, gen):
    """STL-10 binaries (train_X.bin etc.: 96 x 96 x 3 uint8 images,
    column-major, labels 1-10) of random images."""
    d = os.path.join(root, "stl10_binary")
    os.makedirs(d)
    for split, n in (("train", STL_TRAIN), ("test", STL_TEST)):
        torch.randint(0, 256, (n * 3 * 96 * 96,), generator=gen,
                      dtype=torch.uint8).numpy().tofile(os.path.join(d, f"{split}_X.bin"))
        torch.randint(1, 11, (n,), generator=gen,
                      dtype=torch.uint8).numpy().tofile(os.path.join(d, f"{split}_y.bin"))


def counted(mods, src_log, path, fn):
    """fn() with the launch counts of `mods` set to 0 just before it and
    read just after: (result, {launches, paths, K1 launches by sources,
    checked}). "checked": the first K1 / K3 / K4 launch of each kind in
    the run, again on a copy of its inputs after the counts are read,
    against the plain version (`SourceLog.check`)."""
    for mod in mods:
        mod.reset_launches()
    src_log.start(path, capture=True)
    try:
        result = fn()
        sync()
    finally:
        src_log.stop()
    counts = {
        "launches": {k: v for mod in mods for k, v in mod.launches.items()},
        "paths": {k: v for mod in mods for k, v in mod.path_launches.items()},
        "select_sources": src_log.select_launches(path)}
    counts["checked"] = src_log.check(path)
    return result, counts


def train_step_flops(tp, model, batch, loss_kw):
    """Matmul + conv FLOPs of one train step's forward and backward
    (`train_step_flops` on meta copies: no device work)."""
    def loss(m, b, g):
        logits, info = m(b["image"], training=True, generator=g)
        return tp.classification_loss(logits, b["label"], info, **loss_kw)[0]

    return tp.train_step_flops(loss, model, batch, torch.Generator())


def cli_step_times(tp, cli, cfg):
    """The CLI's own train state and batch: two warm-up steps, then
    CLI_TIMED_STEPS steps by CUDA events; ms per step, img/s, the steps'
    peak memory and the step's FLOPs."""
    state = cli.build_state(cfg, DEVICE)
    kw = cli.loss_kwargs(cfg)
    step = tp.make_train_step(kw)
    batch = next(cli.get_batches(cfg, cli.generator(cfg.experiment.seed, 0, DEVICE), 1,
                                 device=DEVICE))
    draws = torch.Generator(device=DEVICE).manual_seed(21)
    for _ in range(2):
        step(state, batch, draws)
    sync()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CLI_TIMED_STEPS):
        state, m = step(state, batch, draws)
    end.record()
    sync()
    ms = start.elapsed_time(end) / CLI_TIMED_STEPS
    bs = cfg.experiment.batch_size
    out = {"step_ms": ms, "img_per_s": bs / ms * 1e3,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "loss": m["loss/total"].item(),
           "flops": train_step_flops(tp, state.model, batch, kw)}
    del state, batch
    torch.cuda.empty_cache()
    return out


def cli_train_and_test(tp, cli, sw, orb, src_log, name, args, ck):
    """One epoch of the training CLI with a checkpoint in `ck`, then test
    mode from it: test/acc equal to the trained state's on the same batch."""
    t0 = time.perf_counter()
    state, train_counts = counted((sw, orb), src_log, name, lambda: cli.main(
        args + [f"checkpoint.checkpoint_path={ck}"], device=DEVICE))
    out = {"train_s": time.perf_counter() - t0, "train": train_counts,
           "steps": state.step}
    with open(os.path.join(ck, "train_log.jsonl")) as f:
        logged = json.loads(f.read().splitlines()[-1])
    out["train_loss"] = logged["train/loss/total"]
    assert math.isfinite(out["train_loss"]), logged
    test_args = ["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"]
    metrics, test_counts = counted((sw, orb), src_log, f"{name}_test",
                                   lambda: cli.main(test_args, device=DEVICE))
    in_process = cli.run_test(cli.compose(test_args), state, DEVICE)
    out.update(test=metrics, in_process=in_process, test_counts=test_counts)
    assert abs(metrics["test/acc"] - in_process["test/acc"]) <= 1e-6, out
    # the validation batch and the test batch run the fp32 eval: K1 on
    # NCHW memory
    for counts in (train_counts, test_counts):
        assert counts["launches"].get("select_planes/float32", 0) >= 1, out
        assert any(k.startswith("select_planes/float32/") for k in counts["paths"]), out
    return state, out


def config2_args(cfg_dir):
    """BASELINE config 2's overrides: opt_group_equivariant.yaml on STL-10,
    the group-contrast loss on."""
    return [f"config={cfg_dir}/default.yaml", "canonicalization=opt_group_equivariant",
            "dataset.dataset_name=stl10", "dataset.image_size=96",
            "experiment.loss.group_contrast_weight=1.0"]


def opt_d4_config(cli, args):
    """Config 2's D4 variant: learned reference vector, artifact dummies 0.1."""
    return cli.compose(args + ["canonicalization.network_hyperparams.num_rotations=4",
                               "canonicalization.learn_ref_vec=true",
                               "canonicalization.artifact_err_wt=0.1"])


def opt_d4_step_vs_cpu(tp, cli, cfg, gen):
    """`step_vs_cpu` of the D4 variant's step (dropout and artifact dummies
    off: their draws differ by device), with the CPU's own spread: the
    canonicalizer's update is as far from the CPU's as the CPU's own
    under a 1e-7 perturbation of the batch (on seeds 23-30, card against
    CPU 9.5e-4 to 3.4e-3, over phase 12's 1e-3 on seven; the CPU's own
    1.5e-3 to 3.2e-3: tools/opt_d4_cpu_gap.py on an H100), so each bar is
    also three times the CPU's own difference, as phase 17's is."""
    def build():
        pipe = cli.build_pipeline(cfg, DEVICE)
        pipe.canonicalizer.canonicalization_network.Dropout_0.rate = 0.0
        pipe.canonicalizer.artifact_err_wt = 0.0
        return pipe

    return step_vs_cpu(tp, gen, build=build, spread=True, size=cfg.dataset.image_size,
                       loss_kw=dict(cli.loss_kwargs(cfg), artifact_err_wt=0.0))


def opt_d4_phase(tp, cli, orb, src_log, args):
    """Optimized D4 training at config 2's widths (learn_ref_vec, artifact
    dummies 0.1) through `make_train_step`: K4 in every step ("tile"), the
    loss finite and its task and prior terms falling over OPT_D4_STEPS steps
    on one batch; one step against the CPU (`opt_d4_step_vs_cpu`) held to
    its bars."""
    cfg = opt_d4_config(cli, args)
    state = cli.build_state(cfg, DEVICE)
    assert state.model.canonicalizer.reference_vector.requires_grad
    kw = cli.loss_kwargs(cfg)
    step = tp.make_train_step(kw)
    batch = next(cli.get_batches(cfg, cli.generator(cfg.experiment.seed, 0, DEVICE), 1,
                                 device=DEVICE))
    draws = torch.Generator(device=DEVICE).manual_seed(22)
    (state, m), counts = counted((orb,), src_log, "cli_opt_d4",
                                 lambda: step(state, batch, draws))
    out = {"launches_per_step": counts["launches"], "paths": counts["paths"],
           "checked": counts["checked"]}
    assert counts["launches"] == {"rot90_flip_orbit/float32": 1}, out
    assert counts["paths"] == {"rot90_flip_orbit/float32/tile": 1}, out
    rows = [m]
    for _ in range(OPT_D4_STEPS - 1):
        state, m = step(state, batch, draws)
        rows.append(m)
    out["losses"] = losses = [r["loss/total"].item() for r in rows]
    assert all(math.isfinite(v) for v in losses), losses
    # the task and prior terms fall; the group-contrast term (|V V^T| of
    # unnormalised vectors) jumps after the first step as the vectors grow
    fit = [r["loss/total"].item() - r["loss/group_contrast"].item() for r in rows]
    out["task_prior_losses"] = fit
    assert sum(fit[-3:]) < sum(fit[:3]), fit
    del state, batch
    out["vs_cpu"] = held_to_bars(
        opt_d4_step_vs_cpu(tp, cli, cfg, torch.Generator().manual_seed(23)))
    log(f"optimized D4 training: {json.dumps({k: v for k, v in out.items() if k != 'vs_cpu'})}")
    torch.cuda.empty_cache()
    return out


def classification_cli_phase(tp, sw, orb, src_log):
    """BASELINE configs 1 and 2 through the classification CLIs (phase 19)."""
    import shutil
    import tempfile

    from equiadapt_tpu_torch.cli import classification_serve as serve
    from equiadapt_tpu_torch.cli import classification_train as cli

    cfg_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLS_CONFIGS)
    gen = torch.Generator().manual_seed(20)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_cifar10(tmp, gen)
        write_stl10(tmp, gen)
        # config 1: default.yaml (C4 GCNN 16 x 2, crop 0.9, resize 64,
        # ResNet-50, batch 128, CIFAR-10 at 32 px)
        args1 = [f"config={cfg_dir}/default.yaml", f"dataset.data_path={tmp}",
                 "experiment.num_epochs=1"]
        ck1 = os.path.join(tmp, "ck1")
        state1, out["config1"] = cli_train_and_test(tp, cli, sw, orb, src_log,
                                                    "cli_config1", args1, ck1)
        ck1g = os.path.join(tmp, "ck1_group")
        shutil.copytree(ck1, ck1g)
        with open(os.path.join(ck1g, "config.json")) as f:
            saved = json.load(f)
        saved["experiment"]["inference_method"] = "group"
        with open(os.path.join(ck1g, "config.json"), "w") as f:
            json.dump(saved, f)
        group, counts = counted((sw, orb), src_log, "cli_group", lambda: cli.main(
            ["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck1g}"],
            device=DEVICE))
        out["config1"]["group"] = {"metrics": group, **counts}
        assert counts["launches"].get("rot90_flip_orbit/float32") == 1, counts
        assert counts["paths"].get("rot90_flip_orbit/float32/tile") == 1, counts
        assert counts["select_sources"].get("select_planes/float32,1 source", 0) >= 1, counts
        assert all(math.isfinite(v) for v in group.values()), group
        out["config1"]["step"] = cli_step_times(tp, cli, cli.compose(args1))
        # config 2: opt_group_equivariant.yaml (D8, ConvNetwork 5x5, 32
        # channels, 128-vector, resize 96), ResNet-50, batch 128, STL-10
        args2 = config2_args(cfg_dir) + [f"dataset.data_path={tmp}",
                                         "experiment.num_epochs=1"]
        state2, out["config2"] = cli_train_and_test(
            tp, cli, sw, orb, src_log, "cli_config2", args2, os.path.join(tmp, "ck2"))
        assert state2.model.canonicalizer.num_group == 16
        # D8's orbit is static warps (no K4); its selects take two sources
        assert "rot90_flip_orbit/float32" not in out["config2"]["train"]["launches"]
        assert out["config2"]["train"]["select_sources"].get(
            "select_planes/float32", 0) >= 1, out["config2"]
        del state2
        out["config2"]["step"] = cli_step_times(tp, cli, cli.compose(args2))
        out["opt_d4"] = opt_d4_phase(tp, cli, orb, src_log, args2)
        # the serving CLI: serving_bf16.yaml at 224 px, fresh weights (K3),
        # then config 1's checkpoint at its own config
        served, counts = counted((sw, orb), src_log, "cli_serve", lambda: serve.main(
            [f"config={cfg_dir}/serving_bf16.yaml", "dataset.image_size=224"],
            device=DEVICE))
        del served["pipeline"]
        out["serve"] = {**served, **counts}
        assert counts["launches"].get("select_planes_nhwc/bfloat16", 0) >= 1, counts
        assert any(k.startswith("select_planes_nhwc/bfloat16/") for k in counts["paths"])
        served1, counts = counted((sw, orb), src_log, "cli_serve_config1", lambda: serve.main(
            [f"checkpoint.checkpoint_path={ck1}"], device=DEVICE))
        # the non-strict restore loaded every tensor of the served pipeline
        # (its parameters stay fp32 under bf16 compute)
        got, ref = served1.pop("pipeline").state_dict(), state1.model.state_dict()
        assert got.keys() == ref.keys(), sorted(got.keys() ^ ref.keys())
        assert all(torch.equal(got[k], ref[k]) for k in ref), [
            k for k in ref if not torch.equal(got[k], ref[k])]
        del got, ref, state1
        out["serve_config1"] = {**served1, **counts, "restored_tensors": True}
        assert counts["launches"].get("select_planes_nhwc/bfloat16", 0) >= 1, counts
    log(f"classification CLIs: {json.dumps(out)}")
    return out


def mfu_row(flops, ms, peak, dtype):
    return {"flops_per_step": flops, "ms": ms, "peak_dtype": dtype,
            "mfu_pct": None if peak is None else 100.0 * flops / (ms * 1e-3) / peak[dtype]}


def mfu_phase(tp, smi, times, cli_out, resnet_bf16):
    """MFU (bench.py's train_mfu_pct and eval_mfu_pct): counted FLOPs of a
    step over (its measured time x the card's dense peak for its dtype,
    PEAK_FLOPS; null for a card missing from the table)."""
    card = smi.split(",")[0].strip()
    peak = PEAK_FLOPS.get(card)
    rows = {}
    for mode in ("bf16_fast", "fp32_exact"):
        pipe = build_trainer(tp, mode)
        batch = {"image": torch.zeros(TRAIN_B, IMAGE, IMAGE, 3, device=DEVICE),
                 "label": torch.zeros(TRAIN_B, dtype=torch.long, device=DEVICE)}
        flops = train_step_flops(tp, pipe, batch, {"prior_weight": 100.0})
        rows[f"train_{mode}"] = mfu_row(
            flops, times[f"train_{mode}"]["step_ms"], peak,
            "bfloat16" if mode == "bf16_fast" else "float32")
        del pipe, batch
    for key in ("config1", "config2"):
        step = cli_out[key]["step"]
        rows[f"cli_{key}"] = mfu_row(step["flops"], step["step_ms"], peak, "float32")
    x = torch.zeros(B, IMAGE, IMAGE, 3, device=DEVICE)
    flops = tp.count_flops(lambda m, v: m(v), resnet_bf16, x)
    rows["eval_resnet50_bf16"] = mfu_row(flops, times["serving"]["resnet50_ms"], peak,
                                         "bfloat16")
    rows["eval_resnet50_bf16"]["vs_anchor"] = flops / tp.resnet50_eval_flops(B, IMAGE)
    out = {"device": smi, "peak_flops": peak,
           "train_mfu_pct": {k.removeprefix("train_"): v["mfu_pct"] for k, v in rows.items()
                             if not k.startswith("eval")},
           "eval_mfu_pct": rows["eval_resnet50_bf16"]["mfu_pct"], "rows": rows}
    if peak is None:
        log(f"MFU: no peak rate for {card!r}: MFU null")
    torch.cuda.empty_cache()
    return out


class KnnLog:
    """K8 launches of one run, with `capture`: the inputs of the first
    launch of each kind (dtype, distance branch, shape, k) are copied
    before it runs; `check` runs each again through the wrapper on the
    copy against the plain version (`knn_agree`), rows named as the
    `kernels` line names the kernel."""

    def __init__(self, kn):
        self.kn, self.inputs, self.capture = kn, {}, False
        launch = kn._launch

        def recording(points, k):
            key = (str(points.dtype).removeprefix("torch."),
                   "d<=4" if points.shape[2] <= 4 else "d>4", tuple(points.shape), k)
            if self.capture and not any(
                    key[:2] == seen[:2] for seen in self.inputs):
                self.inputs[key] = points.clone()
            return launch(points, k)

        kn._launch = recording

    def counted(self, path, fn):
        """fn() with K8's launch counts set to 0 just before it and read
        just after, then the captured launches checked: (result, {launches,
        checked})."""
        self.kn.reset_launches()
        self.inputs, self.capture = {}, True
        try:
            result = fn()
            sync()
        finally:
            self.capture = False
        counts = {"launches": dict(self.kn.launches), "checked": []}
        for (tag, branch, shape, k), x in self.inputs.items():
            got, ref = self.kn.knn_indices(x, k), self.kn.knn_indices_plain(x, k)
            sync()
            n_bad, err, _, ulps = knn_agree(x, got, ref)
            counts["checked"].append({
                "path": path, "kernel": f"knn_indices[{tag},{branch}]",
                "shape": list(shape), "k": k, "tie_picks": n_bad,
                "max_abs_err": err, "max_gap_roundings": ulps})
            del got, ref
        self.inputs = {}
        self.kn.reset_launches()
        return result, counts


def knn_train_cases(tp, kn, gen, bwidth, rate):
    """K8 at part segmentation's shapes (PS_B, PS_N, D = 3 and 64) on clean
    Gaussian clouds and on the same clouds after `random_point_dropout`
    (up to 87.5% of a cloud's points copies of its first: heavy exact
    ties), and at the config-4a trainer's (PC_B, PC_N, 3) after dropout,
    each held against the plain version and timed beside its bound and the
    yardstick (`knn_measure`). The kernel does not report which selection
    route a row took, so each dropout case's time stands beside its clean
    twin's (`over_clean`)."""
    cases = {}
    for name, (b, n, d, dropout) in KNN_TRAIN_CASES.items():
        x = torch.randn(b, n, d, generator=gen)
        if dropout:
            x = tp.random_point_dropout(x, generator=gen)
        x = x.to(DEVICE)
        cases[name] = m = knn_measure(kn, x, bwidth, rate)
        if dropout:
            m["duplicate_share"] = (x == x[:, :1]).all(-1).float().mean().item()
            clean = cases.get(name.removesuffix("_dropout"))
            if clean is not None:
                m["over_clean"] = m["ms"] / clean["ms"]
        log(f"K8 {name}: {json.dumps(m)}")
        del x
    return cases


def partseg_config(ps):
    """part_segmentation/configs/default.yaml through the CLI's compose."""
    here = os.path.dirname(os.path.abspath(__file__))
    return ps.compose([f"config={os.path.join(here, PS_CONFIG)}"])


def build_partseg(tp, ps, seed=3):
    """BASELINE config 4b at full width with random weights: the yaml's
    canonicalizer (VNSmall, k 20, mean pooling) by the port's registry and
    DGCNNPartSeg (50 parts, 16 categories, k 20, emb 1024). Built on the
    CPU from `seed` (3: the canonicalizer of phase 7; on phase 20's eval
    clouds its frames' smallest over largest singular value is at least
    0.0065 on an H100) with random BatchNorm statistics, then moved to the
    card."""
    cfg = partseg_config(ps)
    h = cfg.canonicalization.network_hyperparams
    assert (h.n_knn, h.pooling, cfg.experiment.batch_size, cfg.dataset.num_points) == (
        PS_K, "mean", PS_B, PS_N), cfg
    torch.manual_seed(seed)
    canon = tp.get_pointcloud_canonicalizer(cfg.canonicalization, device="cpu")
    random_bn_statistics(canon)
    net = tp.DGCNNPartSeg(PS_PARTS, PS_CATS, PS_K, PS_EMB, device="cpu")
    random_bn_statistics(net)
    return tp.PointcloudPartSegPipeline(canon, net).to(DEVICE)


def partseg_batch(ps, gen):
    """The CLI's synthetic task at full size (octant parts of Gaussian
    clouds, 16 categories), on the CPU."""
    return ps.synthetic_partseg_batch(gen, PS_B, num_points=PS_N,
                                      num_categories=PS_CATS)


def onehot(category):
    return F.one_hot(category.long(), PS_CATS).float()


def partseg_eval_phase(tp, ps, kn, gen, m=2):
    """Part segmentation's eval forward at full width (phase 20): K8's
    launches (3 at D <= 4: VNSmall, TransformNet's graph, stage 0; 2 at
    D > 4), finite logits of shape (PS_B, PS_N, 50); against the port's CPU
    run of the first `m` clouds: canonical clouds within 1e-4, logits within
    1e-3 of the largest and the per-point argmax equal for 99.9% of the
    points (a D > 4 neighbour tie at the rounding level moves a few);
    canonicalizing x @ Q for random rotations Q leaves the per-point argmax
    unchanged for 95% of the points (phase 7's bar for clouds); ms (median
    of 5 windows) and clouds/s; device time by kernel name."""
    pipe = build_partseg(tp, ps)
    x = anisotropic_clouds(gen, PS_B, PS_N)
    cat = torch.randint(0, PS_CATS, (PS_B,), generator=gen)
    xd, oh = x.to(DEVICE), onehot(cat).to(DEVICE)
    kn.reset_launches()
    logits, info = pipe(xd, oh)
    sync()
    launches = dict(kn.launches)
    assert launches == PS_KNN_LAUNCHES, launches
    assert logits.shape == (PS_B, PS_N, PS_PARTS), logits.shape
    assert bool(torch.isfinite(logits).all()), "partseg logits"
    pipe_cpu = copy.deepcopy(pipe).to("cpu")
    xc, _ = pipe.canonicalizer.canonicalize(xd[:m])
    xc_cpu, _ = pipe_cpu.canonicalizer.canonicalize(x[:m])
    logits_cpu, _ = pipe_cpu(x[:m], oh[:m].cpu())
    d_canon = (xc.cpu() - xc_cpu).abs().max().item()
    d_logit = ((logits[:m].cpu() - logits_cpu).abs().max()
               / logits_cpu.abs().max()).item()
    same_cpu = (logits[:m].argmax(-1).cpu() == logits_cpu.argmax(-1)).float().mean().item()
    Q = random_rotations(PS_B, gen).to(DEVICE)
    logits_rot, _ = pipe(xd @ Q, oh)
    same_rot = (logits_rot.argmax(-1) == logits.argmax(-1)).float().mean().item()
    out = {"launches": launches, "cpu": {"clouds": m, "max_abs_canon": d_canon,
                                         "max_rel_logit": d_logit,
                                         "same_part_share": same_cpu},
           "so3_same_part_share": same_rot,
           "frame_min_singular_ratio": (lambda sv: (sv[:, -1] / sv[:, 0]).min().item())(
               torch.linalg.svdvals(pipe.canonicalizer.canonicalization_network(xd)))}
    assert d_canon < 1e-4 and d_logit < 1e-3 and same_cpu >= 0.999, out
    assert same_rot >= 0.95, out
    out.update(windowed_ms({"ms": lambda: pipe(xd, oh)}, reps=5))
    out["clouds_per_s"] = PS_B / out["ms"] * 1e3
    out["profile"] = device_profile(lambda: pipe(xd, oh))
    log(f"partseg eval: {json.dumps({k: v for k, v in out.items() if k != 'profile'})}")
    log(f"partseg eval profile: {json.dumps(out['profile'][:12] + out['profile'][-1:])}")
    del pipe, pipe_cpu, xd, oh, logits, logits_rot
    torch.cuda.empty_cache()
    return out


def partseg_loss_fn(ps):
    def loss(m, points, oh, labels, g):
        logits, info = m(points, oh, training=True, generator=g)
        return ps.partseg_loss(logits, labels, info, PS_PARTS)[0]
    return loss


def config4a_loss_fn(tp):
    def loss(m, points, labels, g):
        logits, info = m(points, training=True, generator=g)
        return tp.pointcloud_loss(logits, labels, info, num_classes=PC_CLASSES)[0]
    return loss


def trainer_readings(kn, step, state, batch, draws, b, flops, peak):
    """A trainer's readings on one fixed batch: the loss over
    TRAIN_FALL_STEPS steps (finite, falling); K8's launches in one step;
    ms per step by CUDA events over TRAIN_TIMED_STEPS steps after two
    warm-up steps, clouds/s and the steps' peak memory above what was
    allocated when they began; launches and device time by kernel name of
    one step (profile); MFU against the card's fp32 peak (`mfu_row`)."""
    losses = []
    for i in range(TRAIN_FALL_STEPS):
        if i == 0:
            kn.reset_launches()
        state, m = step(state, batch, draws)
        if i == 0:
            sync()
            launches = dict(kn.launches)
        losses.append(m["loss/total"].item())
    assert all(math.isfinite(v) for v in losses), losses
    assert sum(losses[-3:]) / 3 < sum(losses[:3]) / 3, losses
    for _ in range(2):
        step(state, batch, draws)
    sync()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_TIMED_STEPS):
        state, m = step(state, batch, draws)
    end.record()
    sync()
    ms = start.elapsed_time(end) / TRAIN_TIMED_STEPS
    assert math.isfinite(m["loss/total"].item()), m
    rows = device_profile(lambda: step(state, batch, draws))
    return {"step_ms": ms, "clouds_per_s": b / ms * 1e3,
            "step_peak_mem_gib": (torch.cuda.max_memory_allocated() - resident) / 2**30,
            "knn_launches_per_step": launches, "launches_per_step": rows[-1][2],
            "device_ms_per_step": rows[-1][1], "busy_share": rows[-1][1] / ms,
            "flops_per_step": flops,
            "mfu_pct": mfu_row(flops, ms, peak, "float32")["mfu_pct"],
            "losses": losses, "profile": rows}


def grad_metrics(model, metrics):
    """The step's metrics with the gradient norms `make_train_step`'s
    watch_gradients reports (by top-level module, and global)."""
    out = {k: v.item() for k, v in metrics.items()}
    total = 0.0
    for name, child in model.named_children():
        sq = sum(float(torch.sum(p.grad.double() ** 2)) for p in child.parameters()
                 if p.grad is not None)
        out[f"grad/{name}/norm"] = math.sqrt(sq)
        total += sq
    out["grad/global_norm"] = math.sqrt(total)
    return out


@contextlib.contextmanager
def fixed_draws(mod, draws):
    """Within the block, `mod`'s augmentations take the given CPU draws
    (moved to the points' device) in place of their generator's: one step
    on two devices then sees the same rotations, dropout and scales."""
    saved = {name: getattr(mod, name) for name in draws}
    wrap = {
        "random_rotate": lambda f, d: lambda p, mode, generator=None: f(
            p, mode, draws=d.to(p.device)),
        "random_point_dropout": lambda f, d: lambda p, generator=None: f(
            p, draws=tuple(t.to(p.device) for t in d)),
        "random_scale_shift": lambda f, d: lambda p, generator=None: f(
            p, draws=tuple(t.to(p.device) for t in d)),
    }
    for name, d in draws.items():
        setattr(mod, name, wrap[name](saved[name], d))
    try:
        yield
    finally:
        for name, f in saved.items():
            setattr(mod, name, f)


def elementwise_max(rows):
    """The largest value at each key over dicts of equal (nested) keys."""
    first = rows[0]
    if isinstance(first, dict):
        return {k: elementwise_max([r[k] for r in rows]) for k in first}
    return max(rows)


def pointcloud_step_vs_cpu(tp, kn, build, step, batch, draws_mod, draws):
    """One train step at dropout 0 (SGD 0.01, the same augmentation draws)
    from the same weights on the card in fp32, on the CPU in float64 (the
    reference) and on the CPU in fp32 with 1, 3 and the default number of
    threads (three summation orders): phase 12's bars (`step_differences`,
    `held_to_bars`) on the card against the float64 step, each raised to
    three times the farthest CPU fp32 step's distance from it where
    larger. The step is ill-conditioned on random weights (the VN frame's
    Gram-Schmidt, BatchNorm over the B clouds of the global layers): on
    the CPU at batch 4 x 2048 the summation order alone (1, 3 or 8
    threads) moved part segmentation's loss by up to 6.7e-4 and its
    prediction network's gradient norm by up to 12%, while a 1e-7
    perturbation of the input moved them less than the card's rounding
    did (an NVIDIA H100 80GB HBM3 against an 8-core CPU).

    Every CPU step takes the card step's K8 indices, in launch order: this
    holds the dense arithmetic. The neighbour graphs themselves may
    differ by device: at D > 4 K8 and its plain version part at fp32
    ties (phase 6), and the canonical cloud's rounding differs by device,
    which flips D = 3 near-ties; at 2048 points a few flipped picks moved
    the loss by 1.5e-4 on an H100. K8 is held against its
    plain version at these shapes in `knn_train_cases` and by the CLI
    replays."""
    from equiadapt_tpu_torch.common.layers import Dropout

    pipe = build()
    for mod in pipe.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    before = {k: v.detach().cpu().clone() for k, v in pipe.state_dict().items()}
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    exact = dict(cpu_batch, points=cpu_batch["points"].double())
    pipe_cpu = copy.deepcopy(pipe).to("cpu")
    knn, graphs, threads = kn.knn_indices, [], torch.get_num_threads()

    def record(points, k):
        graphs.append(knn(points, k))
        return graphs[-1]

    runs = [(pipe, batch, threads), (pipe_cpu.double(), exact, threads)]
    runs += [(copy.deepcopy(pipe_cpu).float(), cpu_batch, t) for t in (threads, 1, 3)]
    res = []
    try:
        for model, b, t in runs:
            if model is pipe:
                kn.knn_indices = record
            else:
                replay = iter(graphs)
                kn.knn_indices = lambda points, k: next(replay).to(points.device)
            torch.set_num_threads(t)
            state = tp.TrainState(model=model, optimizers=[
                torch.optim.SGD(model.parameters(), lr=0.01)])
            with fixed_draws(draws_mod, draws):
                _, m = step(state, b)
            res.append((grad_metrics(model, m),
                        {k: v.detach().cpu() for k, v in model.state_dict().items()}))
            assert model is pipe or next(replay, None) is None, "graphs left over"
    finally:
        kn.knn_indices = knn
        torch.set_num_threads(threads)
    out = step_differences(res[0], res[1], before)
    own = elementwise_max([step_differences(r, res[1], before) for r in res[2:]])
    out["cpu_fp32_vs_float64_max"] = own
    out["knn_graphs_replayed"] = len(graphs)
    out["bars"] = {
        "loss_rel": max(1e-4, 3 * own["loss_rel"]),
        "bn_stats_rel": max(1e-4, 3 * own["bn_stats_rel"]),
        "grad_norm_rel": {k: max(1e-3, 3 * own["grad_norm_rel"][k])
                          for k in out["grad_norm_rel"]},
        "update_rel": {k: max(v, 3 * own["update_rel"][k]) for k, v in {
            "canonicalizer": 1e-3, "prediction_network": 5e-2,
            "prediction_network.Dense_0": 1e-3}.items()}}
    del pipe, pipe_cpu, graphs, runs
    torch.cuda.empty_cache()
    return held_to_bars(out)


def partseg_train_phase(tp, ps, kn, gen, peak):
    """Part segmentation's training at full width (phase 20) through the
    CLI's step (`make_partseg_train_step`), AdamW 1e-3, dropout 0.5 from a
    generator on the card: `trainer_readings` (K8 5 times a step,
    asserted); then one step at dropout 0 against the CPU at batch
    PS_CPU_B (`pointcloud_step_vs_cpu`)."""
    pipe = build_partseg(tp, ps, seed=41)
    state = tp.create_pointcloud_state(pipe, 1e-3)
    step = ps.make_partseg_train_step(PS_CATS, PS_PARTS)
    cpu = partseg_batch(ps, gen)
    batch = {k: v.to(DEVICE) for k, v in cpu.items()}
    draws = torch.Generator(device=DEVICE).manual_seed(42)
    flops = tp.train_step_flops(partseg_loss_fn(ps), pipe, batch["points"],
                                onehot(batch["category"]), batch["part_label"],
                                torch.Generator())
    out = trainer_readings(kn, step, state, batch, draws, PS_B, flops, peak)
    assert out["knn_launches_per_step"] == PS_KNN_LAUNCHES, out["knn_launches_per_step"]
    del state, pipe, batch
    small = {k: v[:PS_CPU_B].to(DEVICE) for k, v in cpu.items()}
    theta = torch.rand(PS_CPU_B, generator=gen)
    out["vs_cpu"] = pointcloud_step_vs_cpu(
        tp, kn, lambda: build_partseg(tp, ps, seed=43), step, small, ps,
        {"random_rotate": theta})
    log(f"partseg train: {json.dumps({k: v for k, v in out.items() if k not in ('losses', 'profile')})}; "
        f"losses {[round(v, 4) for v in out['losses']]}")
    return out


def config4a_train_phase(tp, pc, kn, gen, peak):
    """BASELINE config 4a's trainer at full width (phase 20):
    classification/configs/default.yaml with group_equivariant_fused.yaml
    by the CLI's `build_state` (VNSmall k 20 with fused kNN, DGCNN k 20,
    emb 1024, 40 classes, AdamW 1e-3), `make_pointcloud_train_step` (z
    rotation, point dropout, scale and shift, prior weight 1) at batch
    PC_B x PC_N: `trainer_readings` (K8 5 times a step, asserted), then
    one step at dropout 0 against the CPU at batch PS_CPU_B with the same
    augmentation draws (`pointcloud_step_vs_cpu`)."""
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = pc.compose([f"config={os.path.join(here, PC_CONFIG)}",
                      "canonicalization=group_equivariant_fused"])
    assert (cfg.experiment.batch_size, cfg.dataset.num_points, cfg.dataset.num_classes,
            cfg.prediction.architecture) == (PC_B, PC_N, PC_CLASSES, "DGCNN"), cfg
    state = pc.build_state(cfg, PC_CLASSES, DEVICE)
    step = tp.make_pointcloud_train_step(num_classes=PC_CLASSES, train_rotation="z")
    x = anisotropic_clouds(gen, PC_B, PC_N)
    labels = torch.randint(0, PC_CLASSES, (PC_B,), generator=gen)
    batch = {"points": x.to(DEVICE), "label": labels.to(DEVICE)}
    draws = torch.Generator(device=DEVICE).manual_seed(44)
    flops = tp.train_step_flops(config4a_loss_fn(tp), state.model, batch["points"],
                                batch["label"], torch.Generator())
    out = trainer_readings(kn, step, state, batch, draws, PC_B, flops, peak)
    assert out["knn_launches_per_step"] == PC_KNN_LAUNCHES, out["knn_launches_per_step"]
    del state, batch
    # the point dropout's ratio drawn as 0, so no point is dropped: with up
    # to 87.5% of a cloud's points copies of one, the step is discontinuous
    # in its input (on the CPU a 1e-7 perturbation moves its loss by 1%
    # with the kNN graphs held fixed, by 5% without)
    b, n = PS_CPU_B, PC_N
    draw = {"random_rotate": torch.rand(b, generator=gen),
            "random_point_dropout": (torch.zeros(b, 1),
                                     torch.rand(b, n, generator=gen)),
            "random_scale_shift": (torch.rand(b, 1, 3, generator=gen),
                                   torch.rand(b, 1, 3, generator=gen))}
    small = {"points": x[:b].to(DEVICE), "label": labels[:b].to(DEVICE)}
    from equiadapt_tpu_torch.pipelines import pointcloud as augmentations

    out["vs_cpu"] = pointcloud_step_vs_cpu(
        tp, kn, lambda: pc.build_state(cfg, PC_CLASSES, DEVICE).model, step, small,
        augmentations, draw)
    log(f"config 4a train: {json.dumps({k: v for k, v in out.items() if k not in ('losses', 'profile')})}; "
        f"losses {[round(v, 4) for v in out['losses']]}")
    return out


def pointcloud_cli_phase(pc, ps, knn_log):
    """The point-cloud CLIs on the card (phase 20), each run counted
    (`KnnLog.counted`: K8's launches zeroed before and read after, its
    first launch of each kind checked again against the plain version):
    `pointcloud_train` at config 4a (default.yaml, group_equivariant_fused,
    one epoch: 20 synthetic steps of 64 x 1024) with its checkpoint in a
    temporary directory, then test mode from it, whose robustness
    accuracies must equal the trained state's on the same batch;
    `partseg_train` (default.yaml; the JAX CLI's DGCNNPartSeg k 8, emb 128,
    8 clouds of 256 points, 10 steps) for one epoch, then test mode, whose
    test/miou must equal the trained state's."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "pc")
        args = [f"config={os.path.join(here, PC_CONFIG)}",
                "canonicalization=group_equivariant_fused", "experiment.num_epochs=1",
                f"checkpoint.checkpoint_path={ck}"]
        t0 = time.perf_counter()
        state, counts = knn_log.counted("cli_pointcloud_train", lambda: pc.main(
            args, device=DEVICE))
        out["pointcloud_train"] = {"train_s": time.perf_counter() - t0, "steps": state.step,
                                   **counts}
        test_args = ["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"]
        metrics, counts = knn_log.counted("cli_pointcloud_test", lambda: pc.main(
            test_args, device=DEVICE))
        cfg = pc.compose(test_args)
        ref = pc.robustness_eval(state.model, pc.val_batch(cfg, None, PC_CLASSES, DEVICE),
                                 PC_CLASSES, cfg.experiment.seed, DEVICE)
        out["pointcloud_test"] = {"metrics": metrics, "in_process": ref, **counts}
        assert metrics == ref, out["pointcloud_test"]
        assert state.step == 20, state.step
        del state
        ck = os.path.join(tmp, "ps")
        args = [f"config={os.path.join(here, PS_CONFIG)}", "experiment.num_epochs=1",
                f"checkpoint.checkpoint_path={ck}"]
        t0 = time.perf_counter()
        state, counts = knn_log.counted("cli_partseg_train", lambda: ps.main(
            args, device=DEVICE))
        out["partseg_train"] = {"train_s": time.perf_counter() - t0, "steps": state.step,
                                **counts}
        test_args = ["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"]
        metrics, counts = knn_log.counted("cli_partseg_test", lambda: ps.main(
            test_args, device=DEVICE))
        cfg = ps.compose(test_args)
        ref = ps.eval_step(state.model, ps.get_batch(cfg, ps.TEST_FOLD, None,
                                                     ps.SYNTHETIC_CATEGORIES, DEVICE),
                           ps.SYNTHETIC_CATEGORIES, ps.SYNTHETIC_PARTS)
        out["partseg_test"] = {"metrics": metrics, "in_process": ref, **counts}
        assert metrics["test/miou"] == ref["test/miou"], out["partseg_test"]
        del state
    for run, expect in (("pointcloud_train", 21 * 5), ("pointcloud_test", 3 * 5),
                        ("partseg_train", 11 * 5), ("partseg_test", 5)):
        got = sum(out[run]["launches"].values())
        assert got == expect, (run, got, expect, out[run]["launches"])
    log(f"pointcloud CLIs: {json.dumps(out)}")
    torch.cuda.empty_cache()
    return out


def pointcloud_train_phase(tp, kn, knn_log, bwidth, rate, peak):
    """Phase 20: K8 at the new shapes, part segmentation's eval and
    training, the config-4a trainer and the two CLIs; `peak` the card's
    dense rates (PEAK_FLOPS; None for a card missing from the table)."""
    from equiadapt_tpu_torch.cli import partseg_train as ps
    from equiadapt_tpu_torch.cli import pointcloud_train as pc

    gen = torch.Generator().manual_seed(40)
    out = {"knn": knn_train_cases(tp, kn, gen, bwidth, rate)}
    with torch.no_grad():
        out["partseg_eval"] = partseg_eval_phase(tp, ps, kn, gen)
    with torch.enable_grad():
        out["partseg_train"] = partseg_train_phase(tp, ps, kn, gen, peak)
        out["config4a_train"] = config4a_train_phase(tp, pc, kn, gen, peak)
        out["cli"] = pointcloud_cli_phase(pc, ps, knn_log)
    return out



def seg_batch(tp, seed, b, size=None, device=None):
    """The rectangles task (4 box prompts an image, SEG_IMAGE px unless
    `size`), drawn on `device` (the card unless given)."""
    gen = torch.Generator(device=device or DEVICE).manual_seed(seed)
    return tp.synthetic_coco_batch(gen, b, image_size=size or SEG_IMAGE,
                                   num_prompts=SEG_PROMPTS)


def seg_to(batch, device, m=None):
    """The first m samples of a batch on `device`."""
    cut = slice(None) if m is None else slice(0, m)
    return {"image": batch["image"][cut].to(device),
            "targets": {k: v[cut].to(device) for k, v in batch["targets"].items()}}


def build_segmentation(tp, image=None, depth=12, seed=70, dropout=None):
    """BASELINE config 5: examples/images/segmentation/configs/default.yaml's
    canonicalizer (C4 GCNN 64 x 12, kernel 5, crop 0.8, resize 128) built by
    the port's registry, and the registry's "sam_vit" SAMLite (SAM's ViT
    encoder at 64 * depth wide, 8 heads shared with the 256-wide decoder,
    4 mask tokens), random weights from `seed`. `dropout` overrides the
    canonicalization network's dropout rate."""
    from equiadapt_tpu_torch.common.layers import Dropout

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = tp.compose_config([f"config={os.path.join(here, SEG_CONFIG)}"])
    torch.manual_seed(seed)
    image = image or SEG_IMAGE
    in_shape = (image, image, 3)
    net = tp.get_image_canonicalization_network(cfg.canonicalization, in_shape,
                                                device=DEVICE)
    if dropout is not None:
        for m in net.modules():
            if isinstance(m, Dropout):
                m.rate = dropout
    canon = tp.get_image_canonicalizer(cfg.canonicalization, net, in_shape, device=DEVICE)
    sam = tp.get_segmentation_prediction_network(
        "sam_vit", image, embed_dim=256, encoder_depth=depth, decoder_depth=2,
        num_heads=SEG_HEADS, patch_size=16, device=DEVICE)
    return tp.ImageSegmentationPipeline(canon, sam)


def seg_eval(pipe, batch):
    """canonicalize images and targets -> SAMLite -> invert the masks."""
    (x_c, t_c, masks, ious), info = pipe(batch["image"], batch["targets"])
    return x_c, t_c, masks, ious, info, pipe.invert_masks(info, masks)


def seg_kernel_rows(sw, bwidth):
    """K1a on the path's mask planes ((B, N, 1024, 1024) fp32, one source:
    the word path, and a misaligned view: the element path) and K3 on its
    images ((B, 1024, 1024, 3) fp32, NHWC: the tile path), each bit-equal
    to its plain version (NaN payload and -0.0 included), timed beside its
    bound, its plain version and one torch.gather of the same permutation
    (medians of WINDOWS windows; timed on finite values, which the yardstick
    compares with torch.equal)."""
    gen = torch.Generator(device=DEVICE).manual_seed(71)
    k = torch.randint(0, 4, (SEG_B,), generator=gen, device=DEVICE).int()
    src = torch.zeros_like(k)
    rows = {}
    cases = {
        "select_planes": (SEG_B, SEG_PROMPTS, SEG_IMAGE, SEG_IMAGE),
        "select_planes_nhwc": (SEG_B, SEG_IMAGE, SEG_IMAGE, 3)}
    for name, shape in cases.items():
        x = with_payloads(torch.randn(*shape, generator=gen, device=DEVICE))
        views = {"aligned": x}
        if name == "select_planes":
            views["misaligned"] = misaligned(x)
        paths = {}
        for view, xv in views.items():
            sw.reset_launches()
            got = kernel_call(sw, name, [xv], src, k, None)
            ref = plain_call(sw, name, [xv], src, k, None)
            sync()
            assert torch.equal(orbit_bits(got), orbit_bits(ref)), (name, view)
            (path,) = sw.path_launches
            paths[view] = path.split("/")[-1]
        expect = ({"aligned": "word", "misaligned": "element"} if name == "select_planes"
                  else {"aligned": "tile"})
        assert paths == expect, (name, paths)
        x = torch.randn(*shape, generator=gen, device=DEVICE)  # no NaN: the yardstick
        run = lambda: kernel_call(sw, name, [x], src, k, None)
        plain = lambda: plain_call(sw, name, [x], src, k, None)
        got = run()
        lib = gather_call(sw, name, [x], src, k, None, got)
        timed = windowed_ms({"ms": run, "library_ms": lib}, reps=10)
        del lib
        nbytes = 2 * got.numel() * got.element_size() + 2 * k.numel() * k.element_size()
        rows[name] = {"shape": list(shape), "paths": paths, "max_abs_err": 0.0, **timed,
                      "plain_ms": cuda_ms(plain, reps=3, warmup=1),
                      "bound_ms": nbytes / bwidth * 1e3, "bytes": nbytes}
        del x, views, got, ref
    sw.reset_launches()
    torch.cuda.empty_cache()
    return rows


def clear_margins(acts, rel=1e-3):
    """Samples whose top-2 group activations differ by more than `rel` of
    their largest magnitude (config 5's 12-layer GCNN with random weights
    gives activations near 1e-5, whose top-2 gaps are about 1e-7)."""
    top2 = acts.sort(dim=-1).values[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > rel * acts.abs().amax(dim=-1)


def seg_vs_cpu(pipe, batch, out, m=1):
    """The first m samples against the port's CPU run (plain kernels): the
    same element where the CPU's top-2 margin is clear (`clear_margins`); then the
    canonical images and masks equal (exact selects), boxes within 1e-3 px,
    and the mask logits, IoU predictions and inverted masks within 1e-3 of
    their largest magnitude (a 12-block fp32 ViT: cuBLAS against the CPU's
    summation orders)."""
    x_c, t_c, masks, ious, info, back = out
    cpu = copy.deepcopy(pipe).to("cpu")
    r = seg_eval(cpu, seg_to(batch, "cpu", m))
    acts = r[4].group_activations
    clear = bool(clear_margins(acts).all())
    same = bool((info.onehot[:m].argmax(-1).cpu() == r[4].onehot.argmax(-1)).all())
    assert same or not clear, (info.group_activations[:m], acts)

    def rel(a, b):
        return ((a[:m].cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    res = {"samples": m, "same_element": same, "clear_margin": clear,
           "max_abs_act": (info.group_activations[:m].cpu() - acts).abs().max().item(),
           "max_rel_masks": rel(masks, r[2]), "max_rel_ious": rel(ious, r[3]),
           "max_rel_inverted": rel(back, r[5])}
    if same:
        res["image_equal"] = torch.equal(x_c[:m].cpu(), r[0])
        res["target_masks_equal"] = torch.equal(t_c["masks"][:m].cpu(), r[1]["masks"])
        res["max_abs_boxes"] = (t_c["boxes"][:m].cpu() - r[1]["boxes"]).abs().max().item()
        assert res["image_equal"] and res["target_masks_equal"], res
        assert res["max_abs_boxes"] < 1e-3, res
        assert max(res["max_rel_masks"], res["max_rel_ious"],
                   res["max_rel_inverted"]) < 1e-3, res
    del cpu
    return res


def seg_equivariance(tp, pipe, batch, info):
    """Canonicalizing torch.rot90 of the images, with the targets turned
    alike (`rotate_masks` by +90, `rotate_boxes` by -90 degrees), selects
    the next element for >= 99% of the samples whose top-2 margins are
    clear (`clear_margins`) in both runs, with the same canonical images (exact), the
    same canonical masks within 1e-4 (the bilinear mask rotation at a
    quarter turn) and boxes within 1e-3 px."""
    from equiadapt_tpu_torch.ops.boxes import rotate_boxes, rotate_masks

    x, t = batch["image"], batch["targets"]
    B, W = x.shape[0], x.shape[2]
    t_rot = {**t, "masks": rotate_masks(t["masks"], torch.full((B,), 90.0, device=DEVICE)),
             "boxes": rotate_boxes(t["boxes"], torch.full((B,), -90.0, device=DEVICE), W)}
    canon = pipe.canonicalizer
    x_c, t_c, _ = canon(x, t)
    x_r, t_r, info_r = canon(torch.rot90(x, 1, dims=(1, 2)).contiguous(), t_rot)

    ok = clear_margins(info.group_activations) & clear_margins(info_r.group_activations)
    sel, sel_r = info.onehot.argmax(-1), info_r.onehot.argmax(-1)
    shifted = ok & (sel_r == (sel + 1) % 4)
    share = (shifted.sum() / ok.sum().clamp(min=1)).item()

    def gap(a, b):
        return (a[shifted] - b[shifted]).abs().amax().item() if shifted.any() else 0.0

    res = {"clear": int(ok.sum()), "share_shifted": share,
           "selected": sel.tolist(), "selected_rot90": sel_r.tolist(),
           "image_equal": torch.equal(x_r[shifted], x_c[shifted]),
           "max_abs_masks": gap(t_r["masks"], t_c["masks"]),
           "max_abs_boxes": gap(t_r["boxes"], t_c["boxes"])}
    assert ok.sum() >= B // 2 and share >= 0.99 and res["image_equal"], res
    assert res["max_abs_masks"] < 1e-4 and res["max_abs_boxes"] < 1e-3, res
    return res


def seg_times(pipe, batch):
    """CUDA-event times (ms, 3 calls after a warm-up) of the eval path's
    parts and of the whole call, and the eval's peak memory."""
    canon, sam = pipe.canonicalizer, pipe.prediction_network
    x, t = batch["image"], batch["targets"]
    x_c, t_c, info = canon(x, t)
    emb = sam.image_encoder()(x_c)
    H = x.shape[1]

    def decoder():
        sparse = sam.PromptEncoderLite_0(t_c["boxes"], (H, H))
        low, _ = sam.MaskDecoderLite_0(emb, sparse)
        return low

    masks, _ = sam(x_c, t_c["boxes"])
    out = {"canonicalize_targets_ms": cuda_ms(lambda: canon(x, t), reps=3, warmup=1),
           "encoder_ms": cuda_ms(lambda: sam.image_encoder()(x_c), reps=3, warmup=1),
           "decoder_ms": cuda_ms(decoder, reps=3, warmup=1),
           "invert_ms": cuda_ms(lambda: pipe.invert_masks(info, masks), reps=3, warmup=1)}
    del emb, masks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["eval_ms"] = cuda_ms(lambda: seg_eval(pipe, batch), reps=3, warmup=1)
    out["eval_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["eval_images_per_s"] = SEG_B / out["eval_ms"] * 1e3
    return out


def seg_grad_norms(model):
    """grad/<top-level module>/norm after a step (its `.grad`s stay)."""
    out = {}
    for name, child in model.named_children():
        sq = sum(float(torch.sum(p.grad.double() ** 2)) for p in child.parameters()
                 if p.grad is not None)
        out[f"grad/{name}/norm"] = math.sqrt(sq)
    return out


def seg_step_vs_cpu(tp):
    """One train step at a cut depth (encoder depth 2: 128 wide, 256 px,
    batch SEG_CPU_B, dropout 0, SGD 0.01 so that no Adam normalization
    hides a gradient's size) from the same weights on the card and on the
    CPU, held to phase 12's bars (`step_differences`), each gradient-norm
    and update bar raised to three times the CPU's own difference under a
    1e-7 relative perturbation of the images where that is larger (the
    straight-through selection's gradient sums the SAM input gradient
    against the image's slope, as in phase 17)."""
    pipe = build_segmentation(tp, image=SEG_CPU_IMAGE, depth=2, seed=72, dropout=0.0)
    batch = seg_to(seg_batch(tp, 73, SEG_CPU_B, SEG_CPU_IMAGE, "cpu"), "cpu")
    noise = torch.randn(batch["image"].shape, generator=torch.Generator().manual_seed(74))
    before = {k: v.detach().cpu().clone() for k, v in pipe.state_dict().items()}
    pipe_cpu = copy.deepcopy(pipe).to("cpu")
    runs = [(DEVICE, pipe, batch["image"]), ("cpu", pipe_cpu, batch["image"]),
            ("cpu", copy.deepcopy(pipe_cpu), batch["image"] * (1.0 + 1e-7 * noise))]
    res = []
    step = tp.make_segmentation_train_step(prior_weight=100.0)
    for dev, model, img in runs:
        state = tp.TrainState(model=model,
                              optimizers=[torch.optim.SGD(model.parameters(), lr=0.01)])
        b = seg_to({"image": img, "targets": batch["targets"]}, dev)
        _, m = step(state, b)
        metrics = {k: v.item() for k, v in m.items()}
        metrics.update(seg_grad_norms(model))
        res.append((metrics, {k: v.detach().cpu() for k, v in model.state_dict().items()}))
    out = step_differences(res[0], res[1], before)
    own = step_differences(res[2], res[1], before)
    for d in (out, own):  # a ResNet head's row; SAMLite has none
        d["update_rel"].pop("prediction_network.Dense_0")
    out["cpu_spread"] = own
    out["bars"] = {
        "grad_norm_rel": {k: max(1e-3, 3 * own["grad_norm_rel"][k])
                          for k in out["grad_norm_rel"]},
        "update_rel": {k: max(v, 3 * own["update_rel"][k]) for k, v in
                       {"canonicalizer": 1e-3, "prediction_network": 5e-2}.items()}}
    del pipe, pipe_cpu, runs
    torch.cuda.empty_cache()
    return held_to_bars(out)


def seg_train_phase(tp, sw):
    """The prior-regularized step at full width (batch SEG_TRAIN_B, AdamW
    8e-4, prior weight 100, dropout from a generator on the card): no
    kernel launches (the targets and images take the one-hot blend); the
    loss finite, every parameter group moved; ms per step over 3 steps
    after a warm-up, peak memory."""
    pipe = build_segmentation(tp, seed=75)
    state = tp.create_segmentation_state(pipe, 8e-4)
    step = tp.make_segmentation_train_step(prior_weight=100.0)
    batch = seg_batch(tp, 76, SEG_TRAIN_B)
    draws = torch.Generator(device=DEVICE).manual_seed(77)
    before = {k: v.detach().clone() for k, v in pipe.state_dict().items()}
    sw.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    _, m = step(state, batch, draws)
    sync()
    assert not sw.launches, sw.launches
    first = {k: v.item() for k, v in m.items()}
    assert first["loss/finite"] == 1.0 and math.isfinite(first["loss/total"]), first
    moved = {top: any(not torch.equal(v, before[k]) for k, v in pipe.state_dict().items()
                      if k.startswith(top) and v.is_floating_point()
                      and not k.endswith(("running_mean", "running_var")))
             for top in ("canonicalizer", "prediction_network.SamVitEncoder_0",
                         "prediction_network.MaskDecoderLite_0")}
    assert all(moved.values()), moved
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        _, m = step(state, batch, draws)
    end.record()
    sync()
    ms = start.elapsed_time(end) / 3
    out = {"first_step": first, "last_loss": m["loss/total"].item(), "moved": moved,
           "step_ms": ms, "images_per_s": SEG_TRAIN_B / ms * 1e3,
           "step_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state, pipe, batch
    torch.cuda.empty_cache()
    return out


def seg_cli_phase(sw, src_log):
    """The CLI as the JAX one cuts it (128 px, SAMLite(128, 2, 2, 4), the
    default canonicalizer): one epoch with a checkpoint, then test mode
    from it, its sweep equal to the trained state's on the test batch;
    each run counted and its first launch of each kind checked again
    against the plain version. The CLI's evaluation is the sweep, whose
    bilinear mask rotation leaves the masks in NHWC memory: K3 takes the
    images (tile path, 12-byte pixels) and the masks (word path)."""
    import tempfile

    from equiadapt_tpu_torch.cli import segmentation_train as cli

    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        state, train = counted((sw,), src_log, "cli_segmentation",
                               lambda: cli.main(["experiment.num_epochs=1",
                                                 f"checkpoint.checkpoint_path={ck}"],
                                                device=DEVICE))
        train_s = time.perf_counter() - t0
        test_args = ["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"]
        metrics, test = counted((sw,), src_log, "cli_segmentation_test",
                                lambda: cli.main(test_args, device=DEVICE))
        cfg = cli.compose(test_args)
        with torch.no_grad():
            in_process = cli.group_sweep(cfg, state.model, cli.TEST_STREAM, DEVICE)
    for k, v in in_process.items():
        assert abs(metrics[k] - v.item()) <= 1e-6, (k, metrics, in_process)
    for counts in (train, test):
        assert set(counts["paths"]) == {"select_planes_nhwc/float32/tile",
                                        "select_planes_nhwc/float32/word"}, counts
    return {"train_s": train_s, "steps": state.step, "train": train, "test": test,
            "test_metrics": metrics}


def segmentation_phase(tp, sw, src_log, bwidth):
    """Phase 21: BASELINE config 5 at full width (see the module docstring)."""
    out = {"kernels": seg_kernel_rows(sw, bwidth)}
    pipe = build_segmentation(tp)
    batch = seg_batch(tp, 78, SEG_B)
    with torch.no_grad():
        sw.reset_launches()
        src_log.start("segmentation")
        res = seg_eval(pipe, batch)
        sync()
        src_log.stop()
        counts, paths = dict(sw.launches), dict(sw.path_launches)
        sources = src_log.select_launches("segmentation")
        log(f"segmentation: launches {counts}, paths {paths}, select sources {sources}")
        assert counts == {"select_planes_nhwc/float32": 1, "select_planes/float32": 2}, counts
        assert sources == {"select_planes/float32,1 source": 2}, sources
        assert paths == {"select_planes_nhwc/float32/tile": 1,
                         "select_planes/float32/word": 2}, paths
        x_c, t_c, masks, ious, info, back = res
        assert masks.shape == back.shape == (SEG_B, SEG_PROMPTS, SEG_IMAGE, SEG_IMAGE)
        for t in (x_c, t_c["boxes"], t_c["masks"], masks, ious, back,
                  info.group_activations):
            assert bool(torch.isfinite(t).all())
        out.update(launches=counts, paths=paths, select_sources=sources)
        out["cpu"] = seg_vs_cpu(pipe, batch, res)
        log(f"segmentation vs CPU: {json.dumps(out['cpu'])}")
        del res, x_c, t_c, masks, ious, back
        out["rot90"] = seg_equivariance(tp, pipe, batch, info)
        log(f"segmentation rot90: {json.dumps(out['rot90'])}")
        out["times"] = seg_times(pipe, batch)
        sw.reset_launches()
        sweep = tp.segmentation_group_inference(pipe, batch, num_rotations=4)
        sync()
        out["sweep"] = {k: v.item() for k, v in sweep.items()}
        out["sweep_launches"] = dict(sw.launches)
        assert set(out["sweep"]) == {f"test/map_element_{g}" for g in range(4)} | {
            "test/group_map", "test/map"}, out["sweep"]
        assert all(0.0 <= v <= 1.0 for v in out["sweep"].values()), out["sweep"]
        # each element: K3 on the images; the masks, rotated by the bilinear
        # warp into NHWC memory, take K3 too
        assert sum(out["sweep_launches"].values()) == 8, out["sweep_launches"]
        log(f"segmentation sweep: {json.dumps(out['sweep'])}")
    del pipe, batch, info
    torch.cuda.empty_cache()
    with torch.enable_grad():
        out["train"] = seg_train_phase(tp, sw)
        log(f"segmentation train: {json.dumps(out['train'])}")
        out["train_vs_cpu"] = seg_step_vs_cpu(tp)
        out["cli"] = seg_cli_phase(sw, src_log)
    log(f"segmentation times: {json.dumps(out['times'])}")
    return out


def eqt_nodes(blob):
    """The registered kernel operators (`torch.ops.eqt.*`) in an exported
    program's graph."""
    import io

    program = torch.export.load(io.BytesIO(blob))
    return sorted(str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("eqt."))


def pretrained_phase(tp, sw, orb, src_log):
    """Phase 22a: BASELINE config 1's training CLI with
    `prediction.pretrained=true` on a random torchvision-layout ResNet-50
    `.pth` (one epoch of 20 steps on CIFAR-10 pickles), then test mode from
    its checkpoint. Every tensor the converter fills equals the file's
    before the first step; the test run launches K1a."""
    import tempfile

    from equiadapt_tpu_torch.cli import classification_train as cli
    from equiadapt_tpu_torch.cli.maskrcnn_lite_experiment import random_resnet50_state_dict
    from equiadapt_tpu_torch.models.convert import convert_resnet_checkpoint

    cfg_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLS_CONFIGS)
    sd = random_resnet50_state_dict(seed=PRE_SEED)
    loaded, build = [], cli.build_state

    def spy(*args, **kw):
        state = build(*args, **kw)
        loaded.append({k: v.detach().cpu().clone() for k, v in
                       state.model.prediction_network.state_dict().items()})
        return state

    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "resnet50.pth")
        torch.save(sd, pth)
        write_cifar10(tmp, torch.Generator().manual_seed(PRE_SEED))
        args = [f"config={cfg_dir}/default.yaml", f"dataset.data_path={tmp}",
                "experiment.num_epochs=1", "prediction.pretrained=true",
                f"prediction.pretrained_path={pth}"]
        cli.build_state = spy
        try:
            state, out = cli_train_and_test(tp, cli, sw, orb, src_log, "cli_pretrained",
                                            args, os.path.join(tmp, "ck"))
        finally:
            cli.build_state = build
    # the tensors the converter fills: those it changes on a NaN template
    nan = {k: torch.full_like(v, float("nan")) if v.is_floating_point() else v
           for k, v in loaded[0].items()}
    want = {k: v for k, v in convert_resnet_checkpoint(sd, nan).items()
            if v.is_floating_point() and not torch.isnan(v).all()}
    equal = [k for k, v in want.items() if torch.equal(loaded[0][k], v)]
    out.update(converted_tensors=len(want), equal_before_first_step=len(equal),
               kept_fresh=sorted(set(nan) - set(want) - {
                   k for k in nan if k.endswith("num_batches_tracked")}))
    assert len(equal) == len(want) >= 260, out
    assert out["test_counts"]["select_sources"].get(
        "select_planes/float32,1 source", 0) >= 1, out["test_counts"]
    del state
    torch.cuda.empty_cache()
    log(f"pretrained: {json.dumps(out)}")
    return out


_FRESH_PROCESS = r"""
import json, sys, torch
import equiadapt_tpu_torch
from equiadapt_tpu_torch.ops.kernels import knn, select_warp
from equiadapt_tpu_torch.utils.export import load_exported
d = sys.argv[1]
x, pts = torch.load(f"{d}/x.pt"), torch.load(f"{d}/pts.pt")
out, counts = {}, {}
for name, batch in (("fixed", x), ("symbolic", x), ("symbolic_small", x[:%d]),
                    ("pointcloud", pts), ("knn", pts)):
    fn = load_exported(open(f"{d}/{name.split('_')[0]}.pt2", "rb").read())
    fn(batch)  # warm-up
    torch.cuda.synchronize()
    select_warp.reset_launches(); knn.reset_launches()
    out[name] = fn(batch)
    torch.cuda.synchronize()
    counts[name] = {**select_warp.launches, **knn.launches}
torch.save(out, f"{d}/out.pt")
assert "jax" not in sys.modules and "equiadapt_tpu" not in sys.modules
print(json.dumps(counts))
"""


def export_phase(tp, sw, kn):
    """Phase 22b: `utils.export` on the card. The serving pipeline
    (serving_bf16.yaml, EXPORT_B x 224 px, the loader's NHWC batch: K3)
    exported at a fixed and at a symbolic batch, the point-cloud
    canonicalizer (phase 7's: VNSmall, fused kNN, PC_B x PC_N) and K8
    alone; each graph holds its kernel's operator; each artifact loaded in
    this process and in a fresh one (torch and equiadapt_tpu_torch only)
    launches K3 / K8 once a call and answers as the live call: the logits
    within the larger of two live calls' spread and one bf16 ulp of the
    largest logit, the frames within 1e-6, the kNN indices equal. The
    exported serving call timed in turns with the live one."""
    import tempfile

    from equiadapt_tpu_torch.cli import classification_serve as serve
    from equiadapt_tpu_torch.utils.config import compose_config
    from equiadapt_tpu_torch.utils.export import export_apply, load_exported

    cfg_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLS_CONFIGS)
    cfg = compose_config([f"config={cfg_dir}/serving_bf16.yaml",
                          f"dataset.image_size={EXPORT_IMAGE}",
                          f"experiment.batch_size={EXPORT_B}"], config_dir=serve.CONFIG_DIR)
    torch.manual_seed(EXPORT_SEED)
    pipe = serve.build_serving_pipeline(cfg, DEVICE).eval()
    x = tp.synthetic_image_batch(torch.Generator(device=DEVICE).manual_seed(EXPORT_SEED),
                                 EXPORT_B, size=EXPORT_IMAGE)["image"]
    fwd = lambda p, b: p(b, training=False)[0]
    pc = build_pointcloud(tp).canonicalizer
    pts = anisotropic_clouds(torch.Generator().manual_seed(EXPORT_SEED)).to(DEVICE)

    def frames(c, b):
        x_c, info = c.canonicalize(b)
        return x_c, info.element.rotation

    knn_fn = lambda _, b: kn.knn_indices(b, PC_K)
    out, blobs = {}, {}
    with torch.no_grad():
        live = {"fixed": fwd(pipe, x), "symbolic_small": fwd(pipe, x[:EXPORT_SMALL_B]),
                "pointcloud": frames(pc, pts), "knn": knn_fn(None, pts)}
        live["symbolic"] = live["fixed"]
        again = fwd(pipe, x)
        sync()
        spread = (again.float() - live["fixed"].float()).abs().max().item()
        top = live["fixed"].float().abs().max().item()
        bar = max(spread, 2.0 ** (math.floor(math.log2(top)) - 7))
        out["logit_bar"] = {"live_spread": spread, "bf16_ulp_of_max": bar, "max": top}
        for name, args in (("fixed", (fwd, pipe, x)), ("symbolic", (fwd, pipe, x)),
                           ("pointcloud", (frames, pc, pts)), ("knn", (knn_fn, None, pts))):
            t0 = time.perf_counter()
            blobs[name] = export_apply(*args, symbolic_batch=name == "symbolic")
            out[f"{name}_export_s"] = time.perf_counter() - t0
            out[f"{name}_bytes"] = len(blobs[name])
            out[f"{name}_nodes"] = eqt_nodes(blobs[name])
        assert out["fixed_nodes"] == out["symbolic_nodes"] == ["eqt.select_warp.default"], out
        assert out["pointcloud_nodes"] == out["knn_nodes"] == ["eqt.knn_indices.default"], out

    def agree(name, got):
        ref = live[name]
        if name == "knn":
            return {"equal": bool(torch.equal(got, ref))}
        if name == "pointcloud":
            return {"max_abs_diff": max((a - b).abs().max().item()
                                        for a, b in zip(got, ref))}
        return {"max_abs_diff": (got.float() - ref.float()).abs().max().item()}

    def held(rows):
        for name, row in rows.items():
            if name == "knn":
                assert row["equal"], rows
            elif name == "pointcloud":
                assert row["max_abs_diff"] <= 1e-6, rows
            else:
                assert row["max_abs_diff"] <= bar, (rows, bar)

    # in this process: one launch a call, the live call's answers
    fns = {name: load_exported(blob) for name, blob in blobs.items()}
    inputs = {"fixed": x, "symbolic": x, "symbolic_small": x[:EXPORT_SMALL_B],
              "pointcloud": pts, "knn": pts}
    in_process, counts = {}, {}
    with torch.no_grad():
        for name, batch in inputs.items():
            fn = fns[name.split("_")[0]]
            fn(batch)
            sync()
            sw.reset_launches()
            kn.reset_launches()
            got = fn(batch)
            sync()
            counts[name] = {**sw.launches, **kn.launches}
            in_process[name] = agree(name, got)
    held(in_process)
    for name in ("fixed", "symbolic", "symbolic_small"):
        assert counts[name] == {"select_planes_nhwc/bfloat16": 1}, counts
    for name in ("pointcloud", "knn"):
        assert counts[name] == {"knn_indices/float32/d<=4": 1}, counts
    out.update(in_process=in_process, launches=counts)
    # a fresh process that imports torch and equiadapt_tpu_torch only
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("fixed", "symbolic", "pointcloud", "knn"):
            with open(os.path.join(tmp, f"{name}.pt2"), "wb") as f:
                f.write(blobs[name])
        torch.save(x, os.path.join(tmp, "x.pt"))
        torch.save(pts, os.path.join(tmp, "pts.pt"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _FRESH_PROCESS % EXPORT_SMALL_B, tmp],
            capture_output=True, text=True, cwd=root, timeout=600,
            env=dict(os.environ, PYTHONPATH=root))
        assert proc.returncode == 0, proc.stderr[-4000:]
        fresh_counts = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.load(os.path.join(tmp, "out.pt"))
    fresh = {name: agree(name, got[name]) for name in got}
    held(fresh)
    assert fresh_counts == counts, (fresh_counts, counts)
    out.update(fresh_process=fresh, fresh_process_s=time.perf_counter() - t0,
               fresh_process_launches=fresh_counts)
    # the exported serving call against the live one, in turns
    with torch.no_grad():
        timed = windowed_ms({"live_ms": lambda: fwd(pipe, x),
                             "exported_ms": lambda: fns["fixed"](x),
                             "exported_symbolic_ms": lambda: fns["symbolic"](x)}, reps=5)
    out["times"] = timed
    for key in ("live", "exported", "exported_symbolic"):
        out["times"][f"{key}_img_per_s"] = EXPORT_B / timed[f"{key}_ms"] * 1e3
    del fns, blobs, live, x, pts, pc
    torch.cuda.empty_cache()
    log(f"export: {json.dumps(out)}")
    return out, pipe


def build_detector(tp, seed, image=None):
    """MaskRCNNLite at config 5's scale (DET_CLASSES classes, DET_K
    instances, DET_CH channels) with the ResNet-50 trunk converted from a
    random torchvision-layout state dict; built on the CPU from `seed`."""
    from equiadapt_tpu_torch.cli.maskrcnn_lite_experiment import random_resnet50_state_dict
    from equiadapt_tpu_torch.models import MaskRCNNLite, convert_resnet_checkpoint

    torch.manual_seed(seed)
    model = MaskRCNNLite(num_classes=DET_CLASSES, max_instances=DET_K, channels=DET_CH,
                         backbone="resnet50", device="cpu")
    model.backbone.load_state_dict(convert_resnet_checkpoint(
        random_resnet50_state_dict(seed), model.backbone.state_dict()))
    return model


def det_batch(tp, seed, b, size, device):
    from equiadapt_tpu_torch.data.coco import synthetic_coco_batch

    return synthetic_coco_batch(torch.Generator(device=device).manual_seed(seed), b,
                                size, DET_K)


def det_vs_cpu(model, images, out, m=1):
    """The first `m` samples of the eval on the CPU: the dense outputs and
    the detections' scores within DET_CPU_BAR of each one's largest value;
    where the CPU's top-(K + 1) objectness gaps exceed that bar (so both
    devices pick the same locations), the labels and validity equal, the
    boxes within DET_CPU_BAR and the masks and IoUs of the predicted
    prompts within DET_MASK_BAR (the boxes' rounding enters the prompts'
    Fourier features, amplified: 5e-5 between two CPU runs at 128 px)."""
    cpu = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        ref = cpu(images[:m].cpu())
    rows, K = {}, DET_K
    for k, v in ref.items():
        if k == "stride":
            continue
        got = out[k][:m].cpu()
        rows[k] = ((got.double() - v.double()).abs().max()
                   / v.double().abs().max().clamp(min=1e-30)).item()
    top = ref["obj_logits"].reshape(m, -1).sort(dim=-1, descending=True).values[:, :K + 1]
    gap = (top[:, :-1] - top[:, 1:]).min().item()
    scale = ref["obj_logits"].abs().max().item()
    clear = gap > DET_CPU_BAR * scale
    for k, v in rows.items():
        if k in ("obj_logits", "cls_logits", "dense_boxes", "det_scores"):
            assert v <= DET_CPU_BAR, (k, rows)
        elif clear:
            assert v <= {"det_labels": 0.0, "det_valid": 0.0, "det_boxes": DET_CPU_BAR}.get(
                k, DET_MASK_BAR), (k, rows)
    del cpu
    return {"rel": rows, "min_top_gap": gap, "clear": clear}


def det_grad_metrics(model):
    sq = {}
    for name, child in model.named_children():
        sq[f"grad/{name}/norm"] = math.sqrt(sum(
            float(torch.sum(p.grad.double() ** 2)) for p in child.parameters()
            if p.grad is not None))
    return sq


def det_step_vs_cpu(tp):
    """One train step at DET_CPU_IMAGE px, batch DET_CPU_B (SGD 0.01, ground-
    truth prompts) from the same weights on the card and on the CPU: the
    loss, each top-level module's gradient norm and update norm against the
    CPU's, each bar the larger of phase 12's (1e-4 loss, 1e-3 gradients,
    5e-2 updates) and three times the CPU's own difference under a 1e-7
    relative perturbation of the images; BatchNorm statistics of the trunk
    within 1e-4 (phases 20-21's rule)."""
    model = build_detector(tp, DET_SEED + 1).to(DEVICE)
    batch = det_batch(tp, DET_SEED + 2, DET_CPU_B, DET_CPU_IMAGE, "cpu")
    noise = torch.randn(batch["image"].shape, generator=torch.Generator().manual_seed(3))
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    cpu = copy.deepcopy(model).to("cpu")
    runs = [(DEVICE, model, batch["image"]), ("cpu", cpu, batch["image"]),
            ("cpu", copy.deepcopy(cpu), batch["image"] * (1.0 + 1e-7 * noise))]
    res = []
    for dev, net, img in runs:
        opt = torch.optim.SGD(net.parameters(), lr=0.01)
        tg = {k: v.to(dev) for k, v in batch["targets"].items()}
        o = net(img.to(dev), tg["boxes"], training=True)
        loss, _ = tp.models.maskrcnn_lite_loss(o, tg)
        opt.zero_grad()
        loss.backward()
        metrics = {"loss/total": loss.item(), **det_grad_metrics(net)}
        opt.step()
        res.append((metrics, {k: v.detach().cpu() for k, v in net.state_dict().items()}))

    def diff(a, b):
        (ma, sa), (mb, sb) = a, b
        d = {"loss_rel": abs(ma["loss/total"] - mb["loss/total"]) / abs(mb["loss/total"]),
             "grad_norm_rel": {k: abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30)
                               for k in mb if k.startswith("grad/")}}
        upd, stats = {}, 0.0
        for top in dict(model.named_children()):
            d2 = r2 = 0.0
            for k in sb:
                if not k.startswith(top + ".") or k.endswith("num_batches_tracked"):
                    continue
                if k.endswith(("running_mean", "running_var")):
                    stats = max(stats, ((sa[k] - sb[k]).abs().max()
                                        / sb[k].abs().max().clamp(min=1e-30)).item())
                    continue
                d2 += ((sa[k] - sb[k]) ** 2).sum().item()
                r2 += ((sb[k] - before[k]) ** 2).sum().item()
            upd[top] = math.sqrt(d2 / max(r2, 1e-30))
        d["update_rel"], d["bn_stats_rel"] = upd, stats
        return d

    out, own = diff(res[0], res[1]), diff(res[2], res[1])
    out["cpu_spread"] = own
    out["bars"] = {
        "loss_rel": max(1e-4, 3 * own["loss_rel"]),
        "grad_norm_rel": {k: max(1e-3, 3 * v) for k, v in own["grad_norm_rel"].items()},
        "update_rel": {k: max(5e-2, 3 * v) for k, v in own["update_rel"].items()},
        "bn_stats_rel": max(1e-4, 3 * own["bn_stats_rel"])}
    del model, cpu, runs
    torch.cuda.empty_cache()
    return held_to_bars(out)


def detection_phase(tp, mods):
    """Phase 22c: MaskRCNNLite at config 5's scale (DET_IMAGE px, the
    converted ResNet-50 trunk): the eval at batch DET_B (predicted-box
    prompts; no kernel launch, asserted), its first sample against the CPU,
    ms and peak memory; the AdamW train step at batch DET_TRAIN_B
    (ground-truth prompts), ms and peak memory, every module moved; one
    step against the CPU (`det_step_vs_cpu`); the experiment
    (`cli.maskrcnn_lite_experiment`) for DET_EXPERIMENT_STEPS steps end to
    end."""
    import tempfile

    from equiadapt_tpu_torch.cli import maskrcnn_lite_experiment as experiment

    model = build_detector(tp, DET_SEED).to(DEVICE)
    batch = det_batch(tp, DET_SEED, DET_B, DET_IMAGE, DEVICE)
    images = batch["image"]
    out = {}
    with torch.no_grad():
        for mod in mods:
            mod.reset_launches()
        res = model(images)
        sync()
        assert not any(mod.launches for mod in mods), [mod.launches for mod in mods]
        assert res["pred_masks"].shape == (DET_B, DET_K, DET_IMAGE, DET_IMAGE)
        assert res["stride"] == 8, res["stride"]
        for k, v in res.items():
            if k != "stride":
                assert bool(torch.isfinite(v.float()).all()), k
        out["cpu"] = det_vs_cpu(model, images, res)
        log(f"detection vs CPU: {json.dumps(out['cpu'])}")
        del res
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["eval_ms"] = cuda_ms(lambda: model(images), reps=3, warmup=1)
        out["eval_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["eval_images_per_s"] = DET_B / out["eval_ms"] * 1e3
    del batch, images
    torch.cuda.empty_cache()
    tb = det_batch(tp, DET_SEED + 3, DET_TRAIN_B, DET_IMAGE, DEVICE)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def step():
        o = model(tb["image"], tb["targets"]["boxes"], training=True)
        loss, parts = tp.models.maskrcnn_lite_loss(o, tb["targets"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return parts

    with torch.enable_grad():
        torch.cuda.reset_peak_memory_stats()
        first = {k: v.item() for k, v in step().items()}
        assert all(math.isfinite(v) for v in first.values()), first
        moved = {top: any(not torch.equal(v, before[k]) for k, v in model.state_dict().items()
                          if k.startswith(top + ".") and v.is_floating_point())
                 for top in dict(model.named_children())}
        assert all(moved.values()), moved
        out["train_step_ms"] = cuda_ms(step, reps=3, warmup=0)
        out["train_step_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["train_images_per_s"] = DET_TRAIN_B / out["train_step_ms"] * 1e3
        out["train_first_losses"] = first
        del model, opt, tb, before
        torch.cuda.empty_cache()
        out["train_vs_cpu"] = det_step_vs_cpu(tp)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            record = experiment.main(["--steps", str(DET_EXPERIMENT_STEPS), "--out",
                                      os.path.join(tmp, "maskrcnn_lite.json")],
                                     device=DEVICE)
    out["experiment"] = {"wall_s": time.perf_counter() - t0,
                     "final_train_losses": record["final_train_losses"],
                     "segm_map": record["eval_segm_map_coco101"],
                     "det_iou": record["eval_det_mean_best_iou"], "device": record["device"]}
    assert all(math.isfinite(v) for v in record["final_train_losses"].values()), record
    log(f"detection: {json.dumps(out)}")
    return out


def loader_phase(sw, pipe):
    """Phase 22d: the native batch loader. LOADER_RECORDS random 224 px
    uint8 images (with their row index) in a record file; two epochs of
    batches of LOADER_B: each batch equals the source rows its order names
    (`batch_records`, the C++ order replayed in Python); the loader alone
    (batches/s), then loader -> card -> the serving pipeline (img/s; K3
    once a batch)."""
    import tempfile

    import numpy as np

    from equiadapt_tpu_torch.native import loader as nl

    rng = np.random.default_rng(LOADER_SEED)
    images = rng.integers(0, 256, (LOADER_RECORDS, LOADER_IMAGE, LOADER_IMAGE, 3),
                          dtype=np.uint8)
    n = 2 * (LOADER_RECORDS // LOADER_B)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "images.bin")
        spec = nl.write_record_file(path, {"image": images,
                                           "index": np.arange(LOADER_RECORDS)})

        def loader():
            return nl.NativeBatchLoader(path, spec, LOADER_B, num_threads=LOADER_THREADS,
                                        seed=LOADER_SEED)

        with loader() as ld:
            for i in range(n):
                b = ld.next()
                rows = nl.batch_records(spec, LOADER_B, i, LOADER_SEED)
                assert np.array_equal(b["index"], rows), i
                assert np.array_equal(b["image"], images[rows]), i
        with loader() as ld:
            t0 = time.perf_counter()
            for _ in range(n):
                ld.next()
            out["loader_batches_per_s"] = n / (time.perf_counter() - t0)
        sw.reset_launches()
        with torch.no_grad(), loader() as ld:
            t0 = time.perf_counter()
            for _ in range(n):
                x = torch.from_numpy(ld.next()["image"]).to(DEVICE).float().div_(255.0)
                logits, _ = pipe(x, training=False)
            float(logits.float().sum())  # waits for the device
            dt = time.perf_counter() - t0
    out.update(end_to_end_img_per_s=n * LOADER_B / dt, batches=n,
               launches=dict(sw.launches))
    out["loader_img_per_s"] = out["loader_batches_per_s"] * LOADER_B
    assert out["launches"] == {"select_planes_nhwc/bfloat16": n}, out
    assert bool(torch.isfinite(logits.float()).all())
    log(f"native loader: {json.dumps(out)}")
    return out


def item15_phase(tp, sw, orb, kn, src_log, mods):
    """Phase 22: item 15 on the card (see the module docstring)."""
    with torch.enable_grad():  # the CLI trains
        out = {"pretrained": pretrained_phase(tp, sw, orb, src_log)}
    out["export"], pipe = export_phase(tp, sw, kn)
    out["native_loader"] = loader_phase(sw, pipe)
    del pipe
    torch.cuda.empty_cache()
    out["detection"] = detection_phase(tp, mods)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the full results as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import equiadapt_tpu_torch as tp
    from equiadapt_tpu_torch.ops.kernels import _build
    from equiadapt_tpu_torch.ops.kernels import bilinear_warp as bw
    from equiadapt_tpu_torch.ops.kernels import knn as kn
    from equiadapt_tpu_torch.ops.kernels import orbit as orb
    from equiadapt_tpu_torch.ops.kernels import select_warp as sw
    from equiadapt_tpu_torch.ops.kernels import shear_rotate as sr

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bwidth = bandwidth_for(name)
    rate = rate_for(FP32_RATE, name, "fp32 rate")
    log(f"device: {name}; nvidia-smi: {smi}; bandwidth used for bounds "
        f"{bwidth / 1e12:.2f} TB/s; torch {torch.__version__}, CUDA {torch.version.cuda}")
    results = {"device": name, "nvidia_smi": smi, "bandwidth": bwidth}

    t0 = time.perf_counter()
    _build.build_all()
    results["build_s"] = time.perf_counter() - t0
    log(f"build: {results['build_s']:.1f} s")
    results["ptxas"] = {}
    for src, text in _build.build_logs.items():
        report = ptxas_report(text)
        results["ptxas"][src] = report
        for row in report:
            log(f"ptxas {src}.cu {row['kernel']}: {row['registers']} registers, "
                f"{row['stack_frame']} bytes stack frame, "
                f"spills {row['spill_stores']} / {row['spill_loads']} bytes, "
                f"{row['smem']} bytes static smem")
    for src in ("select_warp", "shear_rotate", "orbit", "bilinear_warp", "knn"):
        # no local memory in any kernel
        rows = results["ptxas"][src]
        assert rows and all(r["stack_frame"] == r["spill_stores"] == r["spill_loads"] == 0
                            for r in rows), (src, rows)

    gen = torch.Generator().manual_seed(0)
    check_kernels(sw, gen)
    check_continuous_kernels(sr, bw, gen)
    gen_wide = torch.Generator().manual_seed(14)
    k5_k7_checks = check_k5_k7_wide(sr, bw, gen_wide)
    select_checks = check_select_wide(sw, torch.Generator().manual_seed(16))
    k6_checks = check_k6_wide(sr, torch.Generator().manual_seed(17))
    guard_checks = grad_guard_phase(orb, sr, bw, torch.Generator().manual_seed(15))
    gen_knn = torch.Generator().manual_seed(1)  # leaves `gen`'s images as they were
    knn_checks = check_knn_kernel(kn, gen_knn)
    gen_orbit = torch.Generator().manual_seed(4)
    orbit_checks = check_orbit_kernel(orb, gen_orbit)
    gen_k3 = torch.Generator().manual_seed(10)
    k3_checks = check_k3_kernel(sw, gen_k3)
    src_log = SourceLog(sw, orb)

    presets = build_presets(tp)
    presets["serving_nchw"] = presets["serving"]
    x0 = smooth_images(gen).contiguous().to(DEVICE)  # the loader's NHWC batch
    y = torch.randn(B, IMAGE, IMAGE, FEATURE_CH, generator=gen).to(DEVICE)
    # each preset's batch as the pipeline hands it to the canonicalizer
    # (NCHW memory for the fp32 ResNet-50, NHWC for the bf16 one), and the
    # serving preset once more in NCHW memory, to compare the layouts
    xs_in = {"exact": tp.to_network_layout(x0, presets["exact"][1]),
             "serving": tp.to_network_layout(x0, presets["serving"][1]),
             "serving_nchw": nchw_view(x0)}
    ys = {"exact": y, "serving": y.to(torch.bfloat16),
          "serving_nchw": y.to(torch.bfloat16)}
    launches, checks, times = {}, {}, {}
    paths = {}  # K1 / K2 / K6 launches of the main paths by launch path

    def add_paths(counts):
        for key, v in counts.items():
            paths[key] = paths.get(key, 0) + v

    with torch.no_grad():
        for preset, (canon, resnet) in presets.items():
            x = xs_in[preset]
            sw.reset_launches()
            src_log.start(preset)
            out = run_path(canon, resnet, x, ys[preset])
            sync()
            src_log.stop()
            counts = dict(sw.launches)
            add_paths(sw.path_launches)
            launches.update({f"{preset}:{k}": v for k, v in counts.items()})
            log(f"{preset}: launches {counts}, paths {sw.path_launches}")
            for key in PRESET_KERNELS[preset]:
                assert counts.get(key, 0) > 0, (preset, key, counts)
            x_c, info, logits, y_inv = out
            assert x_c.shape == x.shape and logits.shape == (B, 10)
            assert y_inv.shape == ys[preset].shape
            for t in (x_c, logits, y_inv, info.group_activations):
                assert bool(torch.isfinite(t.float()).all()), preset
            if preset == "exact":
                checks["cpu"] = check_against_cpu(canon, resnet, x, y, *out)
                checks["rot90"] = check_equivariance(canon, x, x_c, info)
                log(f"exact: vs CPU {checks['cpu']}; rot90 {checks['rot90']}")
            else:
                assert x_c.is_contiguous() == (preset == "serving"), preset
                checks[f"{preset}:cpu"] = check_serving_against_cpu(
                    canon, resnet, x, ys[preset], *out)
                checks[f"{preset}:rot90"] = check_serving_equivariance(
                    canon, x, x_c, info)
                log(f"{preset}: vs CPU {checks[f'{preset}:cpu']}; "
                    f"rot90 {checks[f'{preset}:rot90']}")
            del out, x_c, info, logits, y_inv
            times[preset] = time_preset(preset, canon, resnet, x, ys[preset])
            times[preset]["to_network_layout_ms"] = cuda_ms(
                lambda: tp.to_network_layout(x0, resnet), reps=10)
        times["resnet50_bf16_param_dtype"] = time_param_dtype(
            presets["serving"][1], {"nhwc": xs_in["serving"],
                                        "nchw": xs_in["serving_nchw"]})
        del x0, xs_in

        cont = build_continuous_presets(tp, presets["exact"][1],
                                        presets["serving"][1])
        xs = lowfreq_images(gen).to(DEVICE)
        y_cont = lowfreq_images(gen, FEATURE_CH).to(DEVICE)
        ys_cont = {"continuous_exact": y_cont,
                   "continuous_serving": y_cont.to(torch.bfloat16)}
        for preset, (canon, resnet) in cont.items():
            yy = ys_cont[preset]
            for mod in (sw, sr, bw):
                mod.reset_launches()
            out = run_path(canon, resnet, xs, yy, induced_rep_type="scalar")
            sync()
            counts = {**sw.launches, **sr.launches, **bw.launches}
            add_paths(sw.path_launches)
            add_paths(sr.path_launches)
            launches.update({f"{preset}:{k}": v for k, v in counts.items()})
            log(f"{preset}: launches {counts}, paths "
                f"{ {**sw.path_launches, **sr.path_launches} }")
            for key in CONT_PRESET_KERNELS[preset]:
                assert counts.get(key, 0) > 0, (preset, key, counts)
            x_c, info, logits, y_inv = out
            assert x_c.shape == xs.shape and logits.shape == (B, 10)
            assert y_inv.shape == yy.shape
            assert x_c.dtype == (torch.float32 if preset == "continuous_exact"
                                 else torch.bfloat16)
            for t in (x_c, logits, y_inv, info.matrix_rep):
                assert bool(torch.isfinite(t.float()).all()), preset
            checks[f"{preset}:cpu"] = check_continuous_against_cpu(
                canon, resnet, xs, yy, *out)
            log(f"{preset}: vs CPU {checks[f'{preset}:cpu']}")
            if preset == "continuous_exact":
                checks[f"{preset}:rot90"] = check_continuous_equivariance(
                    canon, xs, info)
                log(f"{preset}: rot90 {checks[f'{preset}:rot90']}")
            del out, x_c, info, logits, y_inv
            times[preset] = time_preset(preset, canon, resnet, xs, yy,
                                        induced_rep_type="scalar")
        del xs, y_cont, ys_cont

        pipe = build_pointcloud(tp)
        gen_pc = torch.Generator().manual_seed(0)  # the clouds build_pointcloud names
        pcs = anisotropic_clouds(gen_pc).to(DEVICE)
        kn.reset_launches()
        out = run_pointcloud(pipe, pcs)
        sync()
        pc_counts = dict(kn.launches)
        launches.update({f"pointcloud:{k}": v for k, v in pc_counts.items()})
        log(f"pointcloud: launches {pc_counts}")
        assert pc_counts == PC_KNN_LAUNCHES, pc_counts
        x_c, info, logits, x_back = out
        assert x_c.shape == pcs.shape and logits.shape == (PC_B, PC_CLASSES)
        assert x_back.shape == pcs.shape
        for t in (x_c, logits, x_back, info.element.rotation):
            assert bool(torch.isfinite(t).all()), "pointcloud"
        checks["pointcloud"] = check_pointcloud(pipe, pcs, *out, gen_pc)
        checks["knn"] = knn_checks
        log(f"pointcloud: {json.dumps(checks['pointcloud'])}")
        del out, x_c, info, logits, x_back
        times["pointcloud"] = time_pointcloud(pipe, pcs)
        del pipe, pcs

        resnet = presets["exact"][1]
        orbit_launches = {}
        gi = build_group_inference(tp, resnet)
        gen_gi = torch.Generator().manual_seed(5)
        batch = {"image": smooth_images(gen_gi, GI_B).contiguous().to(DEVICE),
                 "label": torch.randint(0, GI_CLASSES, (GI_B,), generator=gen_gi)
                 .to(DEVICE)}
        for mod in (sw, orb):
            mod.reset_launches()
        src_log.start("group_inference")
        metrics = tp.group_inference(gi, batch, num_rotations=4,
                                     group_type="rotation")
        sync()
        src_log.stop()
        counts = {**sw.launches, **orb.launches}
        add_paths(sw.path_launches)
        add_paths(orb.path_launches)
        orbit_launches["group_inference"] = counts
        launches.update({f"group_inference:{k}": v for k, v in counts.items()})
        log(f"group_inference: launches {counts}, select sources "
            f"{src_log.select_launches('group_inference')}")
        assert counts.get("rot90_flip_orbit/float32") == 1, counts
        assert src_log.select_launches("group_inference").get(
            "select_planes/float32,1 source", 0) >= 1, src_log.rows
        assert set(metrics) == {"test/acc_element_0", "test/acc_element_1",
                                "test/acc_element_2", "test/acc_element_3",
                                "test/group_acc", "test/acc"}, metrics
        assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
        checks["group_inference"] = check_group_inference(tp, gi, batch, metrics)
        checks["group_inference"]["metrics"] = {k: v.item() for k, v in metrics.items()}
        log(f"group_inference: {json.dumps(checks['group_inference'])}")
        times["group_inference"] = time_group_inference(tp, gi, batch)
        del gi, batch, metrics

        opt = build_optimized(tp, resnet)
        gen_opt = torch.Generator().manual_seed(6)
        x_opt = lowfreq_images(gen_opt, b=OPT_B, size=OPT_IMAGE).to(DEVICE)
        for path, pipe in opt.items():
            canon = pipe.canonicalizer
            for mod in (sw, orb):
                mod.reset_launches()
            src_log.start(path)
            x_c, info = pipe.canonicalize(x_opt)  # NCHW memory for the fp32 network
            logits = pipe.prediction_network(x_c)
            sync()
            src_log.stop()
            counts = {**sw.launches, **orb.launches}
            add_paths(sw.path_launches)
            add_paths(orb.path_launches)
            orbit_launches[path] = counts
            sources = src_log.select_launches(path)
            launches.update({f"{path}:{k}": v for k, v in counts.items()})
            log(f"{path}: launches {counts}, select sources {sources}")
            if canon.num_rotations == 8:  # static-warp orbit, 2-source select
                assert "rot90_flip_orbit/float32" not in counts, counts
                assert sources.get("select_planes/float32", 0) >= 1, sources
            else:  # K4 orbit, 1-source select
                assert counts.get("rot90_flip_orbit/float32") == 1, counts
                assert sources.get("select_planes/float32,1 source", 0) >= 1, sources
            G = 2 * canon.num_rotations
            assert x_c.shape == x_opt.shape and logits.shape == (OPT_B, GI_CLASSES)
            assert info.group_activations.shape == (OPT_B, G)
            assert info.extras["vector_out"].shape == (G * OPT_B, 128)
            for t in (x_c, logits, info.group_activations, info.extras["vector_out"]):
                assert bool(torch.isfinite(t).all()), path
            top2 = info.group_activations.sort(dim=-1).values[:, -2:]
            checks[path] = {
                "cpu": check_optimized_against_cpu(canon, x_opt, x_c, info),
                "min_top2_margin": (top2[:, 1] - top2[:, 0]).min().item()}
            if canon.num_rotations == 4:
                checks[path]["rot90"] = check_optimized_shift(canon, x_opt)
            log(f"{path}: {json.dumps(checks[path])}")
            del x_c, info, logits
            times[path] = time_optimized(path, sw, tp, pipe, x_opt)
        del opt, x_opt, resnet

        gen_train = torch.Generator().manual_seed(11)
        with torch.enable_grad():
            for mode in ("bf16_fast", "fp32_exact"):
                src_log.start(f"train_{mode}")
                times[f"train_{mode}"] = train_phase(tp, sw, mode, gen_train)
                src_log.stop()
                launches.update({f"train_{mode}:{k}": v for k, v in
                                 times[f"train_{mode}"]["validation_launches"].items()})
                add_paths(times[f"train_{mode}"]["validation_paths"])
            checks["train_vs_cpu"] = train_vs_cpu(tp, gen_train)
        gen_inv = torch.Generator().manual_seed(12)
        times["invert_diff"] = invert_diff_phase(tp, sw, gen_inv)
        for key, row in times["invert_diff"].items():
            launches[f"invert_diff_{key}:select_planes_rolled/{key.split('/')[1]}"] = (
                row["launches"])
            add_paths(row["paths"])
        gen_ct = torch.Generator().manual_seed(18)
        with torch.enable_grad():
            times["continuous_train"] = continuous_train_phase(tp, sr, bw, gen_ct)
            for mode in ("bf16_fast", "fp32_exact"):
                times[f"continuous_trainer_{mode}"] = continuous_trainer_phase(
                    tp, sr, bw, mode, gen_ct)
            checks["continuous_train_vs_cpu"] = train_vs_cpu(
                tp, gen_ct, build=lambda: build_continuous_trainer(tp, "fp32_exact"),
                spread=True)
            times["opt_steerable"] = opt_steerable_phase(tp, gen_ct)
        # n-body (phase 18): no kernel of the port lies on its path
        for mod in (sw, sr, bw, kn, orb):
            mod.reset_launches()
        gen_nb = torch.Generator().manual_seed(19)
        times["nbody_canonicalize"] = nbody_canonicalize_phase(tp, gen_nb)
        with torch.enable_grad():
            times["nbody_trainer"] = nbody_trainer_phase(tp, gen_nb)
            checks["nbody_cli"] = nbody_cli_phase(tp)
        nbody_launches = {k: v for mod in (sw, sr, bw, kn, orb)
                          for k, v in mod.launches.items()}
        assert not nbody_launches, nbody_launches
        # the classification CLIs (phase 19): each run counted on its own
        with torch.enable_grad():
            cli_out = classification_cli_phase(tp, sw, orb, src_log)
        checks["classification_cli"] = cli_out
        cli_runs = {"cli_config1": cli_out["config1"]["train"],
                    "cli_config1_test": cli_out["config1"]["test_counts"],
                    "cli_group": cli_out["config1"]["group"],
                    "cli_config2": cli_out["config2"]["train"],
                    "cli_config2_test": cli_out["config2"]["test_counts"],
                    "cli_opt_d4": {"launches": cli_out["opt_d4"]["launches_per_step"],
                                   "paths": cli_out["opt_d4"]["paths"],
                                   "checked": cli_out["opt_d4"]["checked"]},
                    "cli_serve": cli_out["serve"],
                    "cli_serve_config1": cli_out["serve_config1"]}
        for path, run in cli_runs.items():
            launches.update({f"{path}:{k}": v for k, v in run["launches"].items()})
            add_paths(run["paths"])
            orbit_launches[path] = {k: v for k, v in run["launches"].items()
                                    if k.startswith("rot90_flip_orbit/")}
        times["mfu"] = mfu_phase(tp, smi, times, cli_out, presets["serving"][1])
        # point-cloud training and part segmentation (phase 20)
        knn_log = KnnLog(kn)
        times["pointcloud_train"] = pc_train = pointcloud_train_phase(
            tp, kn, knn_log, bwidth, rate, PEAK_FLOPS.get(smi.split(",")[0].strip()))
        pc_train_launches = {
            "partseg_eval": pc_train["partseg_eval"]["launches"],
            "partseg_train_step": pc_train["partseg_train"]["knn_launches_per_step"],
            "config4a_train_step": pc_train["config4a_train"]["knn_launches_per_step"],
            **{f"cli_{run}": row["launches"] for run, row in pc_train["cli"].items()}}
        for path, counts in pc_train_launches.items():
            launches.update({f"{path}:{k}": v for k, v in counts.items()})
        # BASELINE config 5 at full width (phase 21)
        times["segmentation"] = seg = segmentation_phase(tp, sw, src_log, bwidth)
        launches.update({f"segmentation:{k}": v for k, v in seg["launches"].items()})
        launches.update({f"segmentation_sweep:{k}": v
                         for k, v in seg["sweep_launches"].items()})
        for run in ("train", "test"):
            row = seg["cli"][run]
            launches.update({f"cli_segmentation_{run}:{k}": v
                             for k, v in row["launches"].items()})
            add_paths(row["paths"])
        add_paths(seg["paths"])
        # item 15 (phase 22): pretrained weights, export, the native loader,
        # MaskRCNNLite
        times["item15"] = it15 = item15_phase(tp, sw, orb, kn, src_log, (sw, sr, bw, kn, orb))
        pre = it15["pretrained"]
        for run, counts in (("cli_pretrained", pre["train"]),
                            ("cli_pretrained_test", pre["test_counts"])):
            launches.update({f"{run}:{k}": v for k, v in counts["launches"].items()})
            add_paths(counts["paths"])
        for run, counts in it15["export"]["launches"].items():
            if run.startswith(("fixed", "symbolic")):
                launches.update({f"export_{run}:{k}": v for k, v in counts.items()})
        launches.update({f"native_loader:{k}": v
                         for k, v in it15["native_loader"]["launches"].items()})
        pc_train_launches.update({f"export_{run}": it15["export"]["launches"][run]
                                  for run in ("pointcloud", "knn")})
        for key, row in times["continuous_train"].items():
            launches.update({f"continuous_train_{key}:{k}": v
                             for k, v in row["launches"].items()})
            add_paths(row["paths"])
        for mode in ("bf16_fast", "fp32_exact"):
            row = times[f"continuous_trainer_{mode}"]
            launches.update({f"continuous_trainer_{mode}:{k}": v
                             for k, v in row["launches_per_step"].items()})
            add_paths(row["paths"])
        # the main paths' K1 and K2 launches took the word path, K6 the
        # resident one (the wide checks take the others)
        log(f"main-path launches by path: {paths}")
        for key in paths:
            kname = key.split("/")[0]
            assert kname not in ("select_planes", "select_planes_rolled") or (
                key.endswith("/word")), (key, paths)
            assert kname != "shear_rotate_residual" or key.endswith("/resident"), (key, paths)
            # K4 at C = 3: the tile path (C a template parameter)
            assert kname != "rot90_flip_orbit" or key.endswith("/tile"), (key, paths)
        assert any(k.startswith("shear_rotate_residual/") for k in paths), paths
        assert any(k.startswith("rot90_flip_orbit/") for k in paths), paths
        checks["select_wide"] = select_checks
        checks["k6_wide"] = k6_checks
        checks["select_gradients"] = select_gradient_phase(
            sw, torch.Generator().manual_seed(13))
        checks["k3"] = k3_checks
        checks["k5_k7_wide"] = k5_k7_checks
        checks["grad_guard"] = guard_checks

        kernels = []
        gen_dev = torch.Generator(device=DEVICE).manual_seed(3)
        # launches over every main path: K1 by source count (K1a: one
        # source), K2 and K3 by dtype
        k1_launches = {
            f"{n}/{t}": sum(v for k, v in launches.items()
                            if k.split(":")[-1] == f"{n}/{t}")
            for n in ("select_planes_rolled", "select_planes_nhwc")
            for t in ("float32", "bfloat16")}
        k1_launches.update(src_log.select_launches())
        for dtype in (torch.float32, torch.bfloat16):
            for kname in TPU_KERNEL:
                kernels.append(kernel_entry(sw, kname, dtype, gen, bwidth,
                                            k1_launches, paths=paths))
            kernels.append(kernel_entry(sw, "select_planes", dtype, gen, bwidth,
                                        k1_launches, one_source=True, paths=paths))
        for dtype in (torch.float32, torch.bfloat16):
            for kname in CONT_KERNEL:
                tag = str(dtype).removeprefix("torch.")
                main_launches = {
                    f"{kname}/{tag}": sum(v for k, v in launches.items()
                                          if k.endswith(f":{kname}/{tag}"))}
                kernels.append(continuous_entry(sr, bw, kname, dtype, gen_dev,
                                                bwidth, main_launches, paths))
        kernels += knn_entries(kn, gen_knn, bwidth, rate, pc_counts,
                               {"cases": pc_train["knn"], "launches": pc_train_launches})
        kernels += orbit_entries(orb, gen_orbit, bwidth, orbit_launches, paths)
        checks["orbit"] = orbit_checks
        # phase 19's launches, each checked at its own shape (`counted`)
        cli_checked = [row for run in cli_runs.values() for row in run["checked"]]
        cli_checked += [row for run in pc_train["cli"].values() for row in run["checked"]]
        cli_checked += [row for run in ("train", "test") for row in seg["cli"][run]["checked"]]
        cli_checked += pre["train"]["checked"] + pre["test_counts"]["checked"]
        # K1a and K3 at config 5's shapes (phase 21): the rows of
        # `seg_kernel_rows` and the launches of its eval path
        seg_rows = {"select_planes[float32,1 source]": "select_planes",
                    "select_planes_nhwc[float32]": "select_planes_nhwc"}
        for entry in kernels:
            if entry["name"] in seg_rows:
                key = seg_rows[entry["name"]]
                entry["segmentation"] = dict(
                    seg["kernels"][key],
                    launches=seg["select_sources"].get("select_planes/float32,1 source", 0)
                    if key == "select_planes"
                    else seg["launches"].get("select_planes_nhwc/float32", 0))
        assert all("segmentation" in e for e in kernels if e["name"] in seg_rows), kernels
        for entry in kernels:
            entry["cli_checks"] = [{k: v for k, v in row.items() if k != "kernel"}
                                   for row in cli_checked if row["kernel"] == entry["name"]]
        names = {entry["name"] for entry in kernels}
        assert {row["kernel"] for row in cli_checked} <= names, cli_checked
        for kname in ("select_planes[float32]", "select_planes[float32,1 source]",
                      "select_planes_nhwc[bfloat16]", "rot90_flip_orbit[float32]",
                      "knn_indices[float32,d<=4]", "knn_indices[float32,d>4]"):
            assert any(row["kernel"] == kname for row in cli_checked), (kname, cli_checked)
    results.update(launches=launches, checks=checks, times=times,
                   kernels=kernels)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    nc, nt = times["nbody_canonicalize"], times["nbody_trainer"]
    log(json.dumps({"nbody": {
        "canonicalize_ms": nc["ms"], "canonicalize_graphs_per_s": nc["graphs_per_s"],
        "canonicalize_launches": nc["launches_per_call"],
        "canonicalize_busy_share": nc["busy_share"],
        "train_step_ms": nt["step_ms"], "train_steps_per_s": nt["steps_per_s"],
        "train_launches_per_step": nt["launches_per_step"],
        "train_busy_share": nt["busy_share"],
        "train_step_peak_mem_gib": nt["step_peak_mem_gib"],
        "simulate_train_ms": nt["simulate_train_ms"],
        "simulate_valid_ms": nt["simulate_valid_ms"],
        "cli_test_mse": checks["nbody_cli"]["test_mse"]}}))
    cli = checks["classification_cli"]
    log(json.dumps({"classification_cli": {
        key: {"train_step_ms": cli[key]["step"]["step_ms"],
              "train_img_per_s": cli[key]["step"]["img_per_s"],
              "train_step_peak_mem_gib": cli[key]["step"]["peak_mem_gib"],
              "epoch_s": cli[key]["train_s"], "test_acc": cli[key]["test"]["test/acc"]}
        for key in ("config1", "config2")} | {
        "serving_img_per_s": cli["serve"]["images_per_s"],
        "serving_warmup_s": cli["serve"]["warmup_s"],
        "opt_d4_losses": cli["opt_d4"]["losses"]}}))
    mfu = times["mfu"]
    log(json.dumps({"mfu": {"device": mfu["device"], "train_mfu_pct": mfu["train_mfu_pct"],
                            "eval_mfu_pct": mfu["eval_mfu_pct"]}}))
    pt = times["pointcloud_train"]
    trainer_keys = ("step_ms", "clouds_per_s", "step_peak_mem_gib", "mfu_pct",
                    "flops_per_step", "launches_per_step", "device_ms_per_step",
                    "busy_share")
    log(json.dumps({"pointcloud_train": {
        "knn": {name: {k: case[k] for k in ("ms", "bound_ms", "yardstick_ms", "plain_ms")}
                for name, case in pt["knn"].items()},
        "partseg_eval_ms": pt["partseg_eval"]["ms"],
        "partseg_eval_clouds_per_s": pt["partseg_eval"]["clouds_per_s"],
        **{run: {k: pt[run][k] for k in trainer_keys}
           for run in ("partseg_train", "config4a_train")},
        "cli_pointcloud_test": pt["cli"]["pointcloud_test"]["metrics"],
        "cli_partseg_test": pt["cli"]["partseg_test"]["metrics"],
        "cli_pointcloud_epoch_s": pt["cli"]["pointcloud_train"]["train_s"]}}))
    sg = times["segmentation"]
    log(json.dumps({"segmentation": {
        "device": smi, **sg["times"],
        "train_step_ms": sg["train"]["step_ms"],
        "train_images_per_s": sg["train"]["images_per_s"],
        "train_step_peak_mem_gib": sg["train"]["step_peak_mem_gib"],
        "train_losses": [sg["train"]["first_step"]["loss/total"], sg["train"]["last_loss"]],
        "sweep": sg["sweep"], "cli_test": sg["cli"]["test_metrics"],
        "kernels": {k: {f: row[f] for f in ("shape", "ms", "bound_ms", "library_ms",
                                              "plain_ms")}
                    for k, row in sg["kernels"].items()}}}))
    ex, dt, nl = it15["export"], it15["detection"], it15["native_loader"]
    log(json.dumps({"item15": {
        "device": smi,
        "pretrained": {k: pre[k] for k in ("converted_tensors", "equal_before_first_step",
                                           "train_loss")},
        "export": {"times": ex["times"], "logit_bar": ex["logit_bar"],
                   "in_process": ex["in_process"], "fresh_process": ex["fresh_process"],
                   "launches": ex["launches"],
                   "bytes": {k: ex[f"{k}_bytes"] for k in ("fixed", "symbolic")},
                   "export_s": {k: ex[f"{k}_export_s"] for k in ("fixed", "symbolic",
                                                                  "pointcloud", "knn")}},
        "detection": {k: dt[k] for k in ("eval_ms", "eval_images_per_s", "eval_peak_mem_gib",
                                         "train_step_ms", "train_images_per_s",
                                         "train_step_peak_mem_gib", "experiment")},
        "native_loader": {k: nl[k] for k in ("loader_batches_per_s", "loader_img_per_s",
                                             "end_to_end_img_per_s")}}}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
