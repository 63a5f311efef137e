#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``morefusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu  # rehearsal on the CPU, reduced size

Builds the CUDA kernels from ``morefusion_tpu_torch/csrc`` (``min_dist.cu``,
``knn.cu``, ``resize.cu``, ``roi_align.cu``, ``nms.cu`` and ``instance_boxes.cu``) with ``nvcc`` and makes phase 11's, phase
13's and phase 16's data (the kernels compile beside it, one ``nvcc`` a source), then runs
eighteen phases, each printing one JSON line (phases 13 and 15 one a step,
then their total) with ``elapsed_s``, the seconds since the start; the
CPU's sides of phases 12 and 14 run in spawned processes beside the later
phases and print their lines (``evaluation_exact_replay``,
``replay_card_vs_cpu``) at the end:

1. kernel vs plain: the min-distance kernel against its plain PyTorch
   version at the ICC shapes, at edge cases (masked, NaN and overflowing
   points, an empty lane, all lanes empty, ragged P, a prime P, a grid its
   voxel tile does not divide, exact ties across its point splits), at
   the train step's shape (16 lanes x 3000 solid CAD points under a pose,
   32^3 voxels) and at the evaluation's (ICC's exact cross mode: 8 and 16
   lanes of all objects' 2048 points, P = 16,384 and 32,768, each lane's
   own object masked; 8 lanes of 2048 points at 64^3 and 96^3): d2 bits,
   winners and payloads identical in every case;
2. serving: ``PoseEstimationNode.estimate`` with the committed occupancy
   checkpoint at full width on one synthetic 480x640 RGB-D frame with four
   instances, against the same node on the CPU (the card's PSPNet on
   ``resize.cu``, the CPU's on ``F.interpolate``), with its bilinear resize
   launches counted (seven a forward) and its selection kernel's
   (``instance_boxes.cu``, one a frame), then timed; then the node
   with ICP (``with_icp=True``, procedural CAD points) on the same frame,
   its knn launches counted (one per ICP iteration) and its frames timed
   (the frame's ellipsoids are no CAD shapes: this checks the wiring, not
   accuracy); then bf16 serving: the node in bf16 on the same frame, timed
   in turns with fp32 (its poses must differ from fp32's); the CPU test's
   tiny model and inputs in bf16, the
   card against the CPU within ``BF16_GAP``; the occ model at ``bench.py``'s
   ``pose_inference_fps`` shape (B = 1, 256^2, 1000 points, 32^3) in both
   dtypes, the card's bf16-fp32 gap over the CPU's within
   ``BF16_GAP_RATIO``, each forward timed by CUDA events and by the host clock
   ending in a read, and profiled (kernels a forward, the card's busy time
   and idle share); a seeded ``pretrained_resnet18`` model in fp32, card
   against CPU within ``PRETRAINED_ATOL``, unchanged under ``model.train()``
   (frozen BatchNorm);
3. ICC: ``IterativeCollisionCheck.refine`` (30 iterations, all on the
   device) on eight synthetic objects of 2048 points, against the same
   refine with the plain version in deterministic mode (losses and poses
   identical), then timed; its kernel launches are counted (one an
   iteration);
4. min-distance kernel timing at the ICC, the train step's and phase
   1's evaluation shapes, beside the plain version, one PyTorch yardstick
   (where its matrix fits in ``LIBRARY_MAX_BYTES``), the card's bound and
   the wrapper's host time a call;
5. knn kernel vs plain: the nearest-neighbour kernel against its plain
   version at the training shape (16 lanes x 500,000 queries x 500 CAD
   points) and at edge cases (one reference, exact ties, ties across the
   kernel's reference tiles, a query count that fills no whole block,
   R = 20,000, one lane, NaN and overflowing distances with none finite),
   indices and the winner's d2 bits identical, with and without the d2
   output;
6. training: the full-width SingleView3D train step (occupancy branch and
   loss, ADD-S, B = 16 crops of 256^2, 1000 points, 32^3 grids) from the
   committed occupancy checkpoint: one step's loss and gradients with the
   kernels against the plain versions in deterministic mode, one step on
   the card against the CPU at B = 2, five timed steps with dropout on and
   their kernel launches counted (the resize kernels' 14 a step: seven
   resizes a forward, each with its backward), and one eval step; the
   batch holds lanes of a symmetric class, where ADD-S runs; the plain
   side of the kernel comparison also resizes with ``F.interpolate``.
   Then the bilinear resize kernels (``resize.cu``) against
   ``F.interpolate`` at PSPNet's seven B = 16 shapes (the pyramid's 512
   channels from 1, 2, 3 and 6 up to 32^2; the x2 stages 1024 x 32^2,
   256 x 64^2, 64 x 128^2), fp32: the forward's bits identical, the
   backward within ``RESIZE_GRAD_RTOL`` of each input element's terms'
   magnitudes (float64 reference) and identical on two runs; each
   direction timed beside the plain versions, ``F.interpolate`` with its
   backward, and the card's byte bound. Then Mask R-CNN's kernels at the ``maskrcnn_r50_fpn.serve.seg1``
   cell's shapes (P2-P5 of an 800 x 1088 input, 256 channels): RoIAlign
   (``roi_align.cu``: the box call, 1000 RoIs at 7 x 7, and the mask call,
   8 RoIs at 14 x 14) within ``ROI_ALIGN_RTOL`` of ``roi_align_plain``, and
   NMS (``nms.cu``: the proposals' five levels at 0.7, the detections'
   1000 boxes of 21 labels at 0.5) with the keep flags of ``nms_plain``;
   each identical on two runs, timed beside its plain version and its
   bound (``mfbench/counts_maskrcnn.py``). Then Mask R-CNN on its main
   path: the cell's model (weights and frozen BatchNorm statistics from a
   seed) in ``MaskRCNNSegmentationNode``, four 480 x 640 frames of 5-8
   objects after one to warm up, each launching RoIAlign twice, NMS twice
   and the resize once and keeping as many instances as it has objects,
   timed by the host clock. Then the pose node's selection kernel
   (``instance_boxes.cu``) on a 480 x 640 frame of 8 instances and ten
   ids, two of them absent: the boxes and finite counts of
   ``instance_boxes_plain``, bit for bit, on two runs; its device time a
   call from a profiler trace (its two memsets and its kernel) and its
   host time a call, beside its plain version's device time and wall on
   the card, its byte bound and the host rule the node used before it.
7. knn kernel timing at the training shape, beside the plain version,
   ``torch.cdist`` + ``argmin`` and the card's bound, and at the ICP shape
   (phase 8's first object, with the d2 output) with the wrapper's host
   time;
8. ICP: four procedural objects (4000 CAD points each) seen as the
   camera-facing half of their points under a known pose plus 1 mm of
   noise, each started 6 degrees and 8 mm off: ``ICPRegistration.register``
   (100 iterations at most, voxel 0.01 m) on the card against the same on
   the CPU (poses within ``ICP_POSE_ATOL``, equal iterations), its knn
   launches counted (one per iteration), timed per register by the host
   clock, ADD and ADD-S before and after; then ICC followed by ICP on the
   same objects, and the ADD(-S) AUC of the raw, +icp and +icc+icp poses;
   and the same chain from the occ model's poses, in fp32 and in bf16, on
   every view of phase 9's scene and of ``EXTRA_SCENE_SEEDS``' scenes, as
   the scene pipeline's pose stage gives them (ground-truth labels fused,
   occupancy grids from the fused map): the AUCs over all their objects,
   bf16 within ``BF16_AUC_ATOL`` of fp32;
9. the scene pipeline at ``bench.py``'s configuration: ``ScenePipeline``
   (fusion on the C++ mapping built with g++ into ``_build/libmfm.so``,
   tracking, the pose node with the occupancy checkpoint, object mapping,
   async ICC) on 4 procedural objects in 240x320 frames from
   ``PlaneTypeSceneGeneration(RandomState(1))``: warm-up, two replays, a
   timed ``process_stream`` of 12 frames with ``scene_pipeline_fps`` and
   the host time per frame of each stage, its min_dist launches (30 a
   refine); ``refine_async`` under CUDA's sync debug mode (no
   synchronising call); one synchronous pass on the card against the CPU
   in deterministic mode with the same pixel draws (labels, instance
   classes, uint8 grids and spawns identical, poses within
   ``PIPE_POSE_ATOL``, the ICC problems equal and replayed for
   ``ICC_REPLAY_ITERATIONS`` on both, and for the pipeline's 30 within the
   CPU's own spread under a start jitter); one pass with ICP, its knn launches
   counted; whether cv2, scipy, sklearn and imageio import; and the timed
   pass again with the model in bf16 (``bench.py``'s default), its min_dist
   launches counted;
10. the segmenter at ``bench.py --segmenter``'s arguments (22 classes,
   widths 32-256, the boundary head, no depth) with seeded weights at
   240x320: UNet logits card against CPU within ``SEG_LOGIT_ATOL`` and the
   share of pixels whose argmax agrees; ``connected_components`` on the
   generator's class map with its instance boundaries (also cut at
   ``SEG_CUT_ITERS`` steps) and on the seeded UNet's own map, where both
   propagations reach the 256-step cap, card against CPU, keys and
   propagation steps identical; the ms of the forward, the
   components, the relabel, the merge and a whole ``SegmentationNode``
   call, with the steps and host reads of the components, beside the cv2
   path's (``device_instancing=False``); and a short
   ``process_stream`` of ``ScenePipeline(segmenter=...)`` (the bf16 pose
   model) on frames without labels, with its split, spawns and min_dist
   launches;
11. the training loop through the train CLI (``cli/train.py``'s
   ``main``): packed train and val sets of the port's generator
   (``reindex`` in forked workers before anything runs on the card, then
   ``pack_reindexed``; 240x320 frames of 3-6 objects, at least 3 train
   batches of 16 after the 0.8 visibility filter and one val batch of 48,
   else the phase fails); run A, the committed occ recipe at full width in
   fp32 (``--with-occupancy --loss add/add_s``, B = 16, two epochs with an
   evaluation after each: the ``add -> add/add_s`` switch at the second
   epoch's first step, snapshots latest and best with their npz archives,
   the archive equal to the snapshot rounded to bf16), then a resume by two
   steps (the step count and ``log.json``'s rows carry on); run B in bf16
   with the ``+occupancy`` loss for three steps, an evaluation after each;
   one step of a resumed run A with the kernels against the same with the
   plain versions in deterministic mode (losses within ``STEP_LOSS_RTOL``,
   each parameter's update within phase 6's gradient tolerances); the
   rate (``sps``, ``sps_window`` beside phase 6's bare step), the host's
   batch preparation, copy and wait, the ms of an evaluation batch and of
   the checkpoint saves, the final AUC and the kernel launches of runs A
   and B;
12. the offline evaluation on phase 11's val set, with run directories of
   the committed occ and noocc checkpoints and their ``args.json``:
   ``cli.eval_sweep`` over the occupancy ablation's four entries and
   ``cli.ablation_report``'s table (with the paired bootstrap), then
   ``cli.evaluate`` (raw, +icp, +icc, +icc+icp, joint ICC) by default, in
   the exact cross mode and at ``--icc-grid-scale 2`` coarse to fine with
   the rate decay (these two on ``EVAL_FULL["mode_examples"]`` crops), and
   at ``--icc-grid-scale 3`` (96^3) on ``EVAL_FULL["scale3_examples"]``
   crops: each method's AUCs, the refine
   loop's frames a second, the kernels' launches by shape and the peak
   memory; one frame's joint ICC problem in exact mode and at scale 2 with
   the kernels against the plain versions in deterministic mode (losses
   and poses identical); the card against the CPU: the raw records of a
   few crops with the same pixel draw (ADDs within ``POSE_ATOL``) and the
   exact-mode problem of that frame's first two crops replayed for
   ``ICC_REPLAY_ITERATIONS`` (within phase
   9's replay bounds or twice the CPU's own spread under a start jitter,
   see ``exact_replay``; the CPU's refines in a background process);
13. the rest of training, on phase 11's packed sets and frames made with
   them: (a) ``cli.generate_data`` of one seed with and without
   ``--textured`` (8 val frames each, forked workers): the same scene, only
   ``rgb`` differs; the textured set packed and the committed r5tex
   checkpoint (trained on textured data) and the occ one evaluated on it
   (``cli.evaluate``, raw and +icp; no gate on the AUCs); (b) PoseNet at
   full width: one step with the kernels against the plain versions in
   deterministic mode and one on the card against the CPU at B = 2 (phase
   6's batch and tolerances), then ``cli.train --model posenet`` (fp32,
   B = 16, ``add/add_s``: an epoch, one evaluation, two steps with ADD-S)
   with its step ms and knn launches; (c) ``cli.train_segmentation`` at
   ``bench.py --segmenter``'s widths with the boundary head (B = 8,
   240x320, ``--fg-weight 5``, 64 generator frames cached by forked
   workers in ``MFTPU_SEG_CACHE``) for ``seg_steps`` steps, its step rate
   (bare on the card, and the host's batch), its loss card against CPU,
   the held-out mIoU and detection rate beside the seeded start's on the
   same 16 val frames (training must raise the mIoU), then phase 10's
   components measurements on the trained segmenter's own maps and a
   ``ScenePipeline(segmenter=...)`` stream with its ``segment`` share and
   min_dist launches; (d)
   ``cli.pretrain_backbone`` on phase 11's two sets (width 64, bf16, 60
   steps) with its rotation accuracy, then one ``cli.train
   --pretrained-backbone`` step whose backbone is the export in bf16;
14. replay, occupancy registration and the offline tools: (a)
   ``occupancy_grid_3d`` at 32^3 x 4000 and 24^3 x 800 CAD points, kernel
   against plain in deterministic mode (grids and point gradients
   identical), its kernel call timed as in phase 4;
   ``cli.align_occupancy_grids`` at its defaults, counted (one min_dist
   launch an iteration), its ms an iteration, and its first
   ``OCC_CPU_ITERATIONS`` steps against the CPU's within the CPU's own
   spread under a start jitter; (b) ``cli.replay_eval`` at its defaults with
   ``--with-icp`` (24 frames, 5 objects, 240x320, the committed occ
   checkpoint, fp32) on a sequence it records, counted: the mean ADD of raw,
   voted, refined and refined+ICP poses, frames per second; then its first
   ``REPLAY_SYNC_FRAMES`` frames replayed on the card and the CPU in
   deterministic mode (n_votes 1, ICC at ``ICC_REPLAY_ITERATIONS``; the
   CPU's pass in a background process): labels,
   grids, spawns and ICC problems identical, poses within
   ``PIPE_POSE_ATOL``; the CPU's ICC problems refined on the card from the
   CPU's starts, as phase 9 replays them (poses within ``PIPE_POSE_ATOL``,
   losses within ``ICC_LOSS_ATOL``); one replayed ICC problem refined with
   the kernel and the plain version, identical, and the first replayed
   frame's ICP rows with the knn kernel and its plain version, identical;
   (c)
   ``IterativeCollisionCheck(pad_objects=False)`` on 5 objects, kernel
   against plain identical, counted, and timed in turns with the padded
   refine (8 slots); (d) ``max_voxelization_3d``,
   ``interpolate_voxel_grid_sorted`` (its backward run twice: repeatable)
   and ``truncated_distance_function_scatter`` on the card against the CPU
   at the train step's shapes; (e) ``cli.stratify_results`` on phase 12's
   dump and phase 11's val set, ``cli.rescore_results`` on the val set's
   true poses and a perturbed copy, and ``cli.align_pointclouds`` at its
   defaults, counted, and run again with the knn kernel and its plain
   version: ADDs identical;
15. the robot side: (a) the ROS node through ``runtime.ros_adapter.main``
   on stub ROS modules (``RosStubs``), with the committed occ checkpoint
   and phase 13's trained segmenter, fed ``ROS_FRAMES`` frames of phase
   9's scene as the camera sends them (uint16 mm depth, TF camera
   poses), its pipeline with ``NODE_PIPELINE`` (as ``bench.py``; 1 vote
   where no track spawns at 3, as phase 9): its
   frames a second from callback to publish, its min_dist launches (30 a
   refine), and every published pose equal bit for bit to a direct
   ``process_frame`` of a second pipeline ``main`` builds the same way
   (deterministic mode); (b) a pick episode: ``PickAndPlaceStateMachine``
   (``ROBOT_MAX_PICKS`` picks at most) over ``CollisionAwareRobot`` with
   ``ROBOT_TOOL`` and two scripted failed seals, each scan the node's
   pipeline over the 7 views of ``scan_poses`` of a six-object generator
   scene, rendered: outcomes, scans and their ms, ``plan_picks`` and
   ``plan_motion`` calls and ms, the scanned poses' mean ADD, min_dist
   launches; run again with min_dist's plain version, poses, plans,
   waypoints and outcomes identical (deterministic mode); (c) ``cli.demo
   --refine --log-dir``
   with the occ checkpoint: the 240 x 960 PNG, ms, launches; (d) the
   first node callback of (a)'s frames that refines, replayed on a fresh
   node inside ``utils.profiling.trace``: the Chrome trace holds the
   min_dist kernel by name;
16. the data side: (a) a YCB-Video tree written before anything runs on
   the card (``ycb_data``): ``YCB_Video_Models`` with each class's
   procedural solid grid as a box mesh (``voxel_grid_to_mesh``) and its
   ``points.xyz``, and ``YCB_Video_Dataset`` frames of the port's generator
   at 480x640 (cv2 PNGs: class-id labels, uint16 depth at
   ``factor_depth`` 10000; ``scipy.io.savemat`` meta), of which only the
   frames the loader reads are written (every ``YCB_SAMPLING``-th train
   id), with the keyframes and ``data_syn``; the factory's examples
   (train + syn through ``ConcatDataset``, and val) reindexed in forked
   workers and packed; (b) ``YCBVideoModels`` on the tree: the host
   seconds of its first build of all 21 classes (meshio's voxelization and
   EDT, npz caches written) and of the cached second, each class's solid
   grid against the procedural model's own (IoU at least
   ``YCB_IOU_MIN``), ``compute_voxel_size --ycb-video`` beside the
   procedural table; (c) ``training.loop.fit`` with
   ``models_bank=YCBVideoModels`` from the occ checkpoint at full width in
   fp32 (``add/add_s+occupancy``, B = 16, three steps, one evaluation),
   counted (both kernels launched), the bank's bare step timed as phase 6
   times its own, one step with the kernels against the plain versions in
   deterministic mode (phase 11's tolerances); (d) ``cli.profile_train``
   and ``cli.profile_backward`` at their defaults but ``PROFILE_STEPS``
   (B = 16): each stage's and variant's ms, the FLOP counter's TFLOP/s and
   the launches of each variant (C and D none of knn); (e) ``geometry.nn``
   on the card against its plain version (indices identical),
   ``cli.visualize_data``, ``cli.ambiguity_floor`` at ``--n-rotations
   500`` and ``cli.export_checkpoint`` on phase 11's run A (the archive
   equal to ``save_best``'s), each timed once;
17. data parallelism, at phase 6's batch from the occ checkpoint (B = 16,
   ``+occupancy``, fp32): (a) ``make_dp_train_step`` at world size 1 under
   an ``nccl`` group of this process against the bare ``make_train_step``
   from the same weights, two steps in deterministic mode (metrics, the
   first step's gradients and the weights after: identical expected, held
   within phase 6's kernel-vs-plain tolerances), counted, then both timed
   in turns; (b) two ranks in processes of their own
   (``--dp-rank-child``), a ``gloo`` group on the one card (NCCL refuses
   two ranks on a device), 8 rows each, two steps in deterministic mode
   with the kernels and again with the plain versions: the ranks' weights
   bit-equal, held to this process's emulation (each half through the
   single-device loss with that rank's generators, the gradients averaged,
   Adam) and kernel against plain within phase 11's tolerances; (c)
   ``cli.train`` under ``torch.distributed.run --nproc_per_node 1``
   (``--train-child``) for three steps on phase 11's packed sets in the
   transfer form, counted, with the bytes of a packed batch against the
   classic one, the card's unpack against the CPU's (identical), and
   ``reconstruct_pcd`` against the packed clouds in mm; (d)
   ``profile_train``'s DP step beside its bare step (from phase 16's
   call); (e) ``cli.train_segmentation`` for four steps under the group of
   this process (its step under DDP). Each child is killed at
   ``DP_CHILD_TIMEOUT``, so a hung rendezvous fails the phase;
18. the headless checks and a campaign: (a) the eight
   ``morefusion_tpu_torch.checks`` modules on the card, each counted
   (min_dist launched by ``check_occupancy_voxelization``, knn by
   ``check_icp_convergence``), against the same at ``--device cpu`` in a
   background process: ICP's ADD per iteration within ``CHECK_ADD_ATOL``
   and its gated count equal, the occupancy grids within
   ``CHECK_GRID_ATOL`` and their voxel and vertex counts equal, the device
   augmentation at the card's draws within ``CHECK_AUG_ATOL`` of the CPU's
   at the same parameters, every other printed number and every image
   identical; (b) beside (a), ``campaigns/r5tex.sh`` for
   ``CAMPAIGN_EPOCHS`` epoch under ``timeout`` on phase 11's packed sets
   linked under the names it waits for, ``RETRIES=30`` (a failure ends it
   at once): exit 0 and ``training complete``, its steps a second and its
   ``torchrun`` worker's launches (``LAUNCH_LOG_SITE``), on one card
   (``NPROC=1``).

Then the script's seconds, a ``{"kernels": [...]}`` line, the card's name
and power limit, and, last, ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero; it also does so, printing no result, when there is
no CUDA device. fp32 except the bf16 passes, with TF32 off for
convolutions and matrix products; bf16 runs on PyTorch's defaults, as a
caller of the port gets them.
"""

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import types
import warnings
from unittest import mock

import numpy as np
import torch

from mfbench.counts import (PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, knn_work,
                            least_seconds, min_dist_work)

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "docs", "results", "occ_best_bf16.npz")

# instruction issue of the CUDA cores: 132 SMs x 128 lanes x 1.98 GHz boost
ISSUE_SLOTS_PER_S = 132 * 128 * 1.98e9

ROOT_DIMS = (32, 32, 32)  # the ICC grid
TRAIN_B, TRAIN_POSES, TRAIN_CAD = 16, 1000, 500  # the JAX train shape

# tolerances (see each phase)
POSE_ATOL, CONF_ATOL = 1e-3, 1e-4
# training: kernel vs plain in deterministic mode (only the plain side's
# bilinear upsampling backward, F.interpolate's, stays atomic); card vs CPU
# (other summation orders)
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL, STEP_GRAD_TOTAL = 1e-4, 1e-6
CPU_LOSS_RTOL = 1e-4
CPU_GRAD_RTOL, CPU_GRAD_TOTAL = 1e-3, 1e-5
# the resize kernels' backward (phase 6): each input element's gradient
# within this of the sum of its terms' magnitudes, against float64 (the
# rounding of a sum taken in another order than F.interpolate's)
RESIZE_GRAD_RTOL = 1e-6
# PSPNet's resizes at 256^2 crops, (C, H, W, h, w): the pyramid, then the
# three x2 stages
RESIZE_SHAPES = ((512, 1, 1, 32, 32), (512, 2, 2, 32, 32),
                 (512, 3, 3, 32, 32), (512, 6, 6, 32, 32),
                 (1024, 32, 32, 64, 64), (256, 64, 64, 128, 128),
                 (64, 128, 128, 256, 256))
# Mask R-CNN's RoIAlign against its plain version (the same operations,
# so within float32 rounding of the features' magnitude), and the pyramid
# P2-P5 of the maskrcnn_r50_fpn.serve.seg1 cell (an 800 x 1088 input)
ROI_ALIGN_RTOL = 1e-6
MASKRCNN_LEVELS = ((200, 272), (100, 136), (50, 68), (25, 34))
# Mask R-CNN's frames through its segmenter node: the cell's configuration
# (narrow widths on a smaller input in the CPU rehearsal), the frames' object
# counts (each frame keeps that many detections)
MASKRCNN_CONFIG = "mfbench/configs/maskrcnn_r50_fpn.json"
MASKRCNN_REHEARSAL_KWARGS = dict(
    width=8, fpn_channels=16, representation=32, mask_channels=16,
    min_size=160, max_size=266, rpn_pre_nms_top_n=50, rpn_post_nms_top_n=40,
    box_candidates=60)
MASKRCNN_FRAME_OBJECTS = (5, 6, 7, 8)
# ICP, card against CPU: the same correspondences (the knn kernel equals its
# plain version bit for bit), Kabsch's sums in other orders; the CPU tests
# hold the port to the JAX package within 1e-5
ICP_POSE_ATOL = 1e-4
# sugar box, mustard bottle, mug, foam brick (symmetric: scored by ADD-S)
ICP_CLASSES = (3, 5, 14, 21)
# phase 8's AUC chain from the model's poses: phase 9's scene and the scenes
# of these seeds, every view; bf16's AUCs within this of fp32's
EXTRA_SCENE_SEEDS = (2, 3)
BF16_AUC_ATOL = 0.01
# scene pipeline, card against CPU (phase 9): poses as the JAX parity tests
# hold them; the ICC problems replayed for 5 iterations and held as
# tests/test_torch_icc.py holds the refiner to JAX. Over the pipeline's 30
# iterations the refine amplifies any rounding difference (see
# tests/test_torch_pipeline.py::test_icc_30_iterations_within_jax_spread):
# the card, from the CPU's starts, must end no farther from the CPU than
# the CPU ends from itself when its start translations move by
# ICC_START_JITTER, in ICC_JITTER_RUNS runs
PIPE_POSE_ATOL = 1e-4
ICC_LOSS_ATOL = 1e-5
ICC_REPLAY_ITERATIONS = 5
ICC_PIPELINE_ITERATIONS = 30
ICC_START_JITTER, ICC_JITTER_RUNS = 1e-7, 3
# bf16 serving (phase 2): the gap between JAX's bf16 and JAX's fp32 per
# output (quaternion, translation in m, confidence), measured on the CPU by
# tests/test_torch_bf16.py::test_bf16_within_jax_bf16_gap[occ] on its inputs
# (a tiny SingleView3D, rebuilt here from the same seeds). On those inputs
# the card's bf16 must be no farther from the CPU's bf16 than that
BF16_GAP = (3.3248066902160645e-3, 6.854534149169922e-06,
            1.2865662574768066e-4)
# at bench.py's shape, the card's bf16-fp32 gap over the CPU's, per output:
# two bf16 implementations, each its own rounding of one fp32 result. Read
# 1.07 / 0.99 / 1.01 on an H100 (PERF.md, PR 9); held within 1.3x either
# way. The lower bound fails a card run that never computed in bf16
BF16_GAP_RATIO = (1 / 1.3, 1.3)
# the pretrained-ResNet18 model, card against CPU in fp32, per output
PRETRAINED_ATOL = 1e-4
# the segmenter (phase 10): bench.py's arguments; UNet logits card vs CPU
SEG_N_CLASS, SEG_WIDTHS = 22, (32, 64, 128, 256)
SEG_LOGIT_ATOL = 1e-4
# the components cut by max_iters (phase 10): inside a chunk of host reads,
# before the generator's map converges (4 + 3 steps at 240x320)
SEG_CUT_ITERS = 2
# the training loop (phase 11): packed sets of the port's generator, the
# frame counts chosen for >= 3 train batches of 16 after the visibility
# filter (~2.2 of ~4.4 crops a frame pass it) and one val batch of 48
FIT_OBJECTS = (3, 6)
FIT_MIN_VISIBILITY = 0.8
FIT_MIN_TRAIN_BATCHES = 3
FIT_FULL = dict(shape=(240, 320), train_frames=32, val_frames=16, batch=16,
                val_batch=48)
FIT_SMALL = dict(shape=(120, 160), train_frames=8, val_frames=2, batch=4,
                 val_batch=4)
# the yardstick of the loop's rate: run A's own train step on its last
# batch, already on the card, timed this many times a use_symmetric
FIT_BARE_STEPS = 6


class CheckFailed(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also says when it ended (seconds since
    the script started)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps, warmup=2):
    """Mean time of ``fn`` on the card, by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps, warmup=2):
    """Mean host time of one call of ``fn``: its wrapper's work and its
    launches, not the card's work (``reps`` calls stay well inside the
    launch queue, so the host never waits for the card). Where this reaches
    ``cuda_ms``, the host bounds the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


# --------------------------------------------------------------- phase 1


def min_dist_inputs(seed, B, P, case, device):
    g = np.random.RandomState(seed)
    ip = g.uniform(-2, 34, (B, P, 3)).astype(np.float32)
    valid = g.rand(B, P) > (0.5 if case == "masked" else 0.1)
    if case == "nan":
        ip[:, g.choice(P, P // 5, replace=False), g.randint(3)] = np.nan
    if case == "empty_lane":
        valid[1] = False
    if case == "all_masked":
        valid[:] = False
    if case == "split_ties":
        # integer points, the first half repeated as the second: exact ties
        # between points P // 2 apart, in different splits of the kernel
        ip = np.round(ip)
        ip[:, P // 2:] = ip[:, : P - P // 2]
        valid[:, P // 2:] = valid[:, : P - P // 2]
    if case == "overflow":
        # valid points whose d2 overflows to inf: lane 0 holds only such
        # points (no winner anywhere), lane 1 one among finite ones
        ip[0] = g.choice([-3e38, 3e38], (P, 3))
        ip[1, 0] = 3e38
        valid[:2] = True
    payload = g.randint(0, 1 << 14, (B, P)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (ip, valid, payload))


def bound(ops, bytes_moved):
    """Least time (ms) on an H100 for work of ``ops`` fp32 operations and
    ``bytes_moved`` bytes (``mfbench/counts.py``), and what bounds it."""
    by_ops = ops / PEAK_FP32_FLOPS >= bytes_moved / PEAK_BYTES_PER_S
    return (least_seconds(ops, bytes_moved) * 1e3,
            "operations" if by_ops else "bytes")


def eval_min_dist_inputs(seed, case, N, M, V, device):
    """The kernel's inputs as the evaluation's ICC forms them: ``N``
    objects of ``M`` points side by side, each lane in its own object's
    ``V^3`` frame (pitch and origin centred on it). ``case`` "exact": every
    lane holds all ``N * M`` points with its own object's masked (the exact
    cross mode); "resample": each lane its own object's points (the own
    grids, and the resample mode's only voxelization). 10% of the points
    are padding."""
    g = np.random.RandomState(seed)
    centres = np.stack([[0.09 * (j % 4), 0.09 * (j // 4), 0.8]
                        for j in range(N)])
    pts = centres[:, None] + g.uniform(-0.04, 0.04, (N, M, 3))
    pad = g.rand(N, M) < 0.1
    pitch = 2.4 * 0.04 * np.sqrt(3) / V
    origin = centres - pitch * (V / 2.0 - 0.5)
    if case == "exact":
        lanes = (pts.reshape(1, N * M, 3) - origin[:, None]) / pitch
        owner = np.repeat(np.arange(N), M)
        valid = (~pad.reshape(1, N * M)) & (owner[None] != np.arange(N)[:, None])
    else:
        lanes = (pts - origin[:, None]) / pitch
        valid = ~pad
    payload = g.randint(0, 1 << 14, valid.shape).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (lanes.astype(np.float32), valid, payload))


def eval_min_dist_cases(small):
    """The evaluation's new kernel shapes: ``(case, N objects, M points,
    V)``. Exact mode at 8 and 16 objects of 2048 points (P = 16,384 and
    32,768, beyond the TPU kernel's 16,384), and the own grids at 64^3 and
    96^3 (``--icc-grid-scale`` 2 and 3)."""
    if small:
        return (("exact_p16384", "exact", 4, 128, 16),
                ("exact_p32768", "exact", 8, 128, 16),
                ("resample_v64", "resample", 4, 128, 24),
                ("resample_v96", "resample", 4, 128, 32))
    return (("exact_p16384", "exact", 8, 2048, 32),
            ("exact_p32768", "exact", 16, 2048, 32),
            ("resample_v64", "resample", 8, 2048, 64),
            ("resample_v96", "resample", 8, 2048, 96))


def compare_min_dist(out, ref, what):
    """Kernel output ``out`` against the plain version's ``ref``: the same
    d2 bits, winners and payloads in every voxel. Returns the largest d2
    difference (0.0) and the number of voxels that differ (0)."""
    d2, arg, pay = out
    rd2, rarg, rpay = ref
    diff = ((d2.view(torch.int32) != rd2.view(torch.int32))
            | (arg != rarg) | (pay != rpay))
    n_diff = int(diff.sum())
    fin = torch.isfinite(rd2) & torch.isfinite(d2)
    err = (d2[fin] - rd2[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    check(n_diff == 0, f"min_dist {what}: {n_diff} voxels differ "
                       f"(d2 up to {max_err} apart)")
    check(torch.equal(torch.isinf(rd2), rarg == -1)
          and bool((rpay[rarg == -1] == 0).all()),
          f"min_dist {what}: the plain version broke its contract")
    return max_err, n_diff


def train_min_dist_inputs(bank, batch, device):
    """The min-distance kernel's inputs as the train step's occupancy loss
    forms them (``functions/tdf.py``): each lane's solid CAD points from
    the bank under the lane's true pose, in voxel units of its grid, their
    mask, and their SDF quantized to 14 bits as the payload."""
    from morefusion_tpu_torch import functions as F

    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    cid = b["class_id"].long()
    T = F.transformation_matrix(b["quaternion_true"], b["translation_true"])
    moved = F.transform_points(bank.solid_points[cid], T)
    ip = (moved - b["origin"][:, None]) / b["pitch"][:, None, None]
    valid = bank.solid_mask[cid] & ~torch.isnan(ip).any(-1)
    sdf = bank.solid_sdf[cid]
    scale = sdf.amax(-1, keepdim=True).clamp_min(
        torch.finfo(torch.float32).tiny)
    payload = torch.round(sdf / scale * 16383.0).clamp(0, 16383)
    return (torch.nan_to_num(ip).contiguous(), valid.contiguous(),
            payload.to(torch.int32).contiguous())


def phase_kernel_vs_plain(device, small, train_inputs):
    from morefusion_tpu_torch.ops import min_dist as md

    B, P = (8, 2048) if not small else (2, 300)
    big = 16384 if not small else 600
    odd = (30, 17, 33) if not small else (9, 5, 11)  # no voxel tile divides it
    cases = [("icc", B, P, ROOT_DIMS), ("masked", B, P, ROOT_DIMS),
             ("nan", B, P, ROOT_DIMS), ("empty_lane", B, P, ROOT_DIMS),
             ("ragged", B, P - 48 if not small else 250, ROOT_DIMS),
             ("p16384", 2, big, ROOT_DIMS), ("ragged_grid", B, P, odd),
             ("prime_p", 3, 1999 if not small else 131, ROOT_DIMS),
             ("split_ties", 4, 4096 if not small else 400, ROOT_DIMS),
             ("overflow", 3, 700 if not small else 70, ROOT_DIMS),
             ("all_masked", 2, P, ROOT_DIMS), ("one_point", 2, 1, odd),
             ("train", None, None, ROOT_DIMS)]
    cases += [(case, None, None, None)
              for case, *_ in eval_min_dist_cases(small)]
    eval_cases = {c[0]: c[1:] for c in eval_min_dist_cases(small)}
    results = []
    max_err = 0.0
    for seed, (case, b, p, dims) in enumerate(cases):
        if case == "train":
            ip, valid, payload = train_inputs
            b, p = ip.shape[:2]
        elif case in eval_cases:
            mode, N, M, V = eval_cases[case]
            ip, valid, payload = eval_min_dist_inputs(seed, mode, N, M, V,
                                                      device)
            b, p = ip.shape[:2]
            dims = (V, V, V)
        else:
            ip, valid, payload = min_dist_inputs(seed, b, p, case, device)
        out = md.min_dist_voxels(ip, valid, payload, dims)
        sync(device)
        ref = md.min_dist_voxels_plain(ip, valid, payload, dims)
        err, n_diff = compare_min_dist(out, ref, case)
        if case == "split_ties":
            check(bool((ref[1] < p - p // 2).all()),
                  "min_dist split_ties: a tie did not go to the lowest index")
        if case == "overflow":
            check(bool((ref[1][0] == -1).all()),
                  "min_dist overflow: an overflowing point won")
        if case.startswith("exact"):
            check(bool((ref[1] >= 0).any()),
                  f"min_dist {case}: no voxel found a point")
        max_err = max(max_err, err)
        results.append(dict(case=case, B=b, P=p, dims=list(dims),
                            max_abs_err=err, voxels_differing=n_diff))
        del out, ref, ip, valid, payload
    emit(dict(phase="kernel_vs_plain", ok=True, cases=results,
              tolerance="identical d2 bits, winners and payloads"))
    return max_err


# --------------------------------------------------------------- phase 2


def make_frame(seed, H=480, W=640, n_obj=4):
    """A synthetic organized RGB-D frame: a tilted table and ``n_obj``
    ellipsoidal bumps, each its own instance, seen by a 525 px camera."""
    g = np.random.RandomState(seed)
    fx = fy = 525.0
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (1.0 + 0.0003 * (v - cy)).astype(np.float32)
    rgb = np.clip(100 + g.normal(0, 12, (H, W, 3)), 0, 255)
    label = np.zeros((H, W), np.int32)
    for k in range(n_obj):
        uc = (k + 0.5) * W / n_obj + g.uniform(-30, 30) * W / 640
        vc = H / 2.0 + g.uniform(-80, 80) * H / 480
        a, b = g.uniform(35, 70, 2) * W / 640
        rr = ((u - uc) / a) ** 2 + ((v - vc) / b) ** 2
        inside = rr < 1.0
        z0 = g.uniform(0.7, 0.9)
        depth[inside] = z0 - 0.05 * np.sqrt(1.0 - rr[inside])
        label[inside] = k + 1
        color = g.uniform(30, 225, 3)
        rgb[inside] = np.clip(color + g.normal(0, 20, (inside.sum(), 3)),
                              0, 255)
    depth[g.rand(H, W) < 0.02] = np.nan
    pcd = np.stack([(u - cx) * depth / fx, (v - cy) * depth / fy, depth],
                   -1).astype(np.float32)
    return rgb.astype(np.uint8), pcd, label


@functools.lru_cache(maxsize=1)
def checkpoint_state():
    from morefusion_tpu_torch import models

    return models.params_from_jax(models.load_jax_npz(CHECKPOINT))


def serving_model(small, seed, compute_dtype=torch.float32):
    """The occ checkpoint at full width (a seeded tiny model in the
    rehearsal), computing in ``compute_dtype``."""
    from morefusion_tpu_torch import models

    if small:
        torch.manual_seed(seed)
        state = models.tiny_singleview3d(
            21, n_point=64, with_occupancy=True).state_dict()
        model = models.tiny_singleview3d(21, n_point=64, with_occupancy=True,
                                         compute_dtype=compute_dtype)
    else:
        state = checkpoint_state()
        model = models.SingleView3D(n_fg_class=21, n_point=1000,
                                    with_occupancy=True,
                                    compute_dtype=compute_dtype)
    model.load_state_dict(state, strict=True)
    return model


def max_gaps(a, b):
    """Largest difference of each output (quaternion, translation,
    confidence)."""
    return [float((x.double().cpu() - y.double().cpu()).abs().max())
            for x, y in zip(a, b)]


def bf16_test_inputs():
    """The inputs of tests/test_torch_bf16.py::test_bf16_within_jax_bf16_gap
    [occ] (``_inputs`` of tests/test_torch_model.py under RandomState(0),
    B = 2, 80^2, 32 points), copied: this script imports no test."""
    rng = np.random.RandomState(0)
    B, S, P, V = 2, 80, 32, 32
    rgb = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    pcd = rng.uniform(-0.1, 0.1, (B, S, S, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    pcd[:, : S // 8] = np.nan
    mask = ~np.isnan(pcd).any(-1)
    idx = np.stack([rng.choice(np.flatnonzero(mask[b].ravel()), P,
                               replace=False) for b in range(B)])
    return dict(
        class_id=(np.arange(B) % 5 + 1).astype(np.int32), rgb=rgb, pcd=pcd,
        pitch=rng.uniform(0.006, 0.012, B).astype(np.float32),
        grid_nontarget_empty=rng.rand(B, V, V, V).astype(np.float32),
        sample_indices=idx.astype(np.int32))


def bench_fps_inputs(small):
    """``bench.py``'s ``pose_inference_fps`` inputs (``bench.py:288-301``)
    at B = 1: 256^2 (64^2 in the rehearsal), the top fifth of the cloud
    NaN, 32^3 grid."""
    B, H, W = 1, (256 if not small else 64), (256 if not small else 64)
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 255, (B, H, W, 3)).astype(np.float32)
    pcd = rng.uniform(0.3, 0.8, (B, H, W, 3)).astype(np.float32)
    pcd[:, : H // 5] = np.nan
    return dict(
        rgb=rgb, pcd=pcd,
        class_id=rng.randint(1, 22, (B,)).astype(np.int32),
        pitch=np.full((B,), 0.0075, np.float32),
        grid_nontarget_empty=rng.uniform(0, 1, (B, 32, 32, 32)).astype(
            np.float32))


def on(kw, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in kw.items()}


def forward_timing(model, kw, device, reps):
    """The forward on device-resident inputs as ``bench.py`` times it: by
    the host clock over ``reps`` calls ending in one read of the result,
    and on the card by CUDA events. Pixels drawn by a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(1234)

    def fwd():
        return model(**kw, generator=gen)

    with torch.inference_mode():
        ms = cuda_ms(fwd, reps) if device.type == "cuda" else None
        fwd()[2].cpu()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fwd()
        out[2].cpu()
        wall = time.perf_counter() - t0
    B = kw["rgb"].shape[0]
    return dict(cuda_ms=ms, host_ms=wall * 1e3 / reps,
                pose_inference_fps=reps * B / wall)


def busy_ms(intervals):
    """Total length (ms) of the union of ``(start, end)`` intervals in us."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-3


def profile_calls(fn, device, reps=10):
    """``reps`` calls of ``fn`` under ``torch.profiler`` on the card, after
    one unprofiled call: the kernels each launches, the card's busy time
    (the union of its kernels) and the host-clock wall per call, and the
    share of the wall the card idles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync(device)
            wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_ms((e.time_range.start, e.time_range.end)
                   for e in kernels) / reps
    return dict(kernels_per_call=len(kernels) / reps, card_busy_ms=busy,
                wall_ms=wall, idle_share=1.0 - busy / wall)


def randomize_batch_stats(model, seed):
    """BatchNorm statistics and affine parameters that are not the
    identity (``randomize_batch_stats`` of tests/test_torch_bf16.py)."""
    from morefusion_tpu_torch.models.layers import FrozenBatchNorm2d

    g = np.random.RandomState(seed)
    for mod in model.modules():
        if isinstance(mod, FrozenBatchNorm2d):
            c = mod.running_mean.shape[0]
            for t, lo, hi in ((mod.weight, 0.5, 1.5), (mod.bias, -0.1, 0.1),
                              (mod.running_mean, -0.1, 0.1),
                              (mod.running_var, 0.5, 1.5)):
                t.data.copy_(torch.from_numpy(
                    g.uniform(lo, hi, c).astype(np.float32)))
    return model


def bf16_serving(device, small):
    """bf16 against fp32 and the card against the CPU: the tiny model on
    the CPU test's inputs (within ``BF16_GAP``), the occ model at
    ``bench.py``'s shape (the card's bf16-fp32 gap within
    ``BF16_GAP_RATIO`` of the CPU's; both forwards timed),
    and a seeded
    ``pretrained_resnet18`` model in fp32, its BatchNorm frozen under
    ``model.train()``."""
    from morefusion_tpu_torch import models
    from morefusion_tpu_torch.models.sampling import sample_mask_indices

    out = {}
    # (a) the CPU test's tiny model and inputs
    torch.manual_seed(0)
    state = models.tiny_singleview3d(5, n_point=32,
                                     with_occupancy=True).state_dict()
    tiny = models.tiny_singleview3d(5, n_point=32, with_occupancy=True,
                                    compute_dtype=torch.bfloat16)
    tiny.load_state_dict(state, strict=True)
    kw = bf16_test_inputs()
    with torch.inference_mode():
        want = tiny.eval()(**on(kw, "cpu"))
        got = tiny.to(device)(**on(kw, device))
    err = max_gaps(got, want)
    check(all(g.dtype == torch.float32 for g in got),
          "bf16: the model's outputs are not fp32")
    check(all(e <= b for e, b in zip(err, BF16_GAP)),
          f"bf16: card vs CPU {err} beyond the JAX bf16-fp32 gap {BF16_GAP}")
    out["test_inputs"] = dict(card_vs_cpu=err, tolerance=list(BF16_GAP))

    # (b) the occ model at bench.py's pose_inference_fps shape
    kw = bench_fps_inputs(small)
    mask = ~torch.from_numpy(np.isnan(kw["pcd"]).any(-1))
    fp32, bf16 = (serving_model(small, 3, dt).to(device).eval()
                  for dt in (torch.float32, torch.bfloat16))
    idx = sample_mask_indices(mask, fp32.n_point,
                              torch.Generator().manual_seed(0))
    fixed = dict(kw, sample_indices=idx.numpy())
    with torch.inference_mode():
        o32 = fp32(**on(fixed, device))
        o16 = bf16(**on(fixed, device))
        cpu32, cpu16 = (serving_model(small, 3, dt).eval()(
            **on(fixed, "cpu")) for dt in (torch.float32, torch.bfloat16))
    gap, cpu_gap = max_gaps(o16, o32), max_gaps(cpu16, cpu32)
    err = max_gaps(o16, cpu16)
    check(all(np.isfinite(o.cpu().numpy()).all() for o in o16),
          "bf16: non-finite outputs")
    lo, hi = BF16_GAP_RATIO
    ratio = [g / c for g, c in zip(gap, cpu_gap)]
    check(all(lo <= r <= hi for r in ratio),
          f"bf16 at bench.py's shape: the card's bf16-fp32 gap {gap}, the "
          f"CPU's {cpu_gap}, ratio {ratio} outside {BF16_GAP_RATIO}")
    reps = 30 if not small else 2
    dev_kw = on(kw, device)
    timing = {name: forward_timing(m, dev_kw, device, reps)
              for name, m in (("fp32", fp32), ("bf16", bf16), ("fp32_again",
                                                                fp32),
                              ("bf16_again", bf16))}
    gen = torch.Generator(device=device).manual_seed(1234)
    profiled = ({name: profile_calls(
        lambda m=m: m(**dev_kw, generator=gen), device)
        for name, m in (("fp32", fp32), ("bf16", bf16))}
        if device.type == "cuda" else None)
    out["bench_shape"] = dict(
        B=1, crop=list(kw["rgb"].shape[1:3]), n_point=fp32.n_point,
        bf16_vs_fp32=gap, cpu_bf16_vs_fp32=cpu_gap, gap_ratio=ratio,
        card_vs_cpu_bf16=err, card_vs_cpu_fp32=max_gaps(o32, cpu32),
        tolerance=dict(gap_ratio=list(BF16_GAP_RATIO)), timing=timing,
        reps=reps, profile=profiled)
    del fp32, o32, o16, cpu32, cpu16

    # (c) the pretrained backbone, fp32, card against CPU
    torch.manual_seed(11)
    if small:
        pre = models.tiny_singleview3d(21, n_point=64, with_occupancy=True,
                                       pretrained_resnet18=True)
    else:
        pre = models.SingleView3D(n_fg_class=21, with_occupancy=True,
                                  pretrained_resnet18=True)
    randomize_batch_stats(pre, 12)
    with torch.inference_mode():
        want = pre.eval()(**on(fixed, "cpu"))
        pre.to(device)
        got = pre(**on(fixed, device))
        trained = pre.train()(**on(fixed, device))
    err = max_gaps(got, want)
    check(max(err) <= PRETRAINED_ATOL,
          f"pretrained_resnet18: card vs CPU {err}")
    check(all(torch.equal(a, b) for a, b in zip(got, trained)),
          "pretrained_resnet18: model.train() changed the frozen BatchNorm")
    out["pretrained_resnet18"] = dict(card_vs_cpu_fp32=err,
                                      tolerance=PRETRAINED_ATOL,
                                      train_mode_equal=True)
    return out


def phase_serving(device, small, counts):
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.ops import resize
    from morefusion_tpu_torch.ops.instance_boxes import instance_boxes
    from morefusion_tpu_torch.geometry import masks_to_bboxes
    from morefusion_tpu_torch.runtime import PoseEstimationNode
    from morefusion_tpu_torch.runtime.pose_estimation import (
        _crop_instance_device,
    )

    H, W, S = (480, 640, 256) if not small else (120, 160, 64)
    rgb, pcd, label = make_frame(1, H, W)
    instance_to_class = {1: 2, 2: 6, 3: 13, 4: 20}
    pitch_table = {c: 0.006 + 0.0004 * c for c in range(1, 22)}

    def voxel_pitch(voxel_dim, class_id):
        return pitch_table[class_id]

    g = np.random.RandomState(2)
    grids = {i: ((g.rand(32, 32, 32) > 0.8) * 255).astype(np.uint8)
             for i in instance_to_class}
    model = serving_model(small, seed=3)
    n_point = model.n_point
    # the same pixels on both devices: drawn here from each crop's mask
    ids = list(instance_to_class)
    bboxes = np.stack([masks_to_bboxes(label == i).round().astype(int)
                       for i in ids])
    _, pcd_c = _crop_instance_device(
        torch.from_numpy(rgb), torch.from_numpy(pcd),
        torch.from_numpy(label), torch.tensor(ids), torch.from_numpy(bboxes),
        S)
    valid = ~torch.isnan(pcd_c).any(-1).reshape(len(ids), -1).numpy()
    sample_indices = {
        i: g.choice(np.flatnonzero(valid[k]), n_point, replace=False)
        for k, i in enumerate(ids)
    }

    node = PoseEstimationNode(model, voxel_pitch, image_size=S,
                              device=device)
    args = (rgb, pcd, label, instance_to_class, grids)
    for c in (*counts, resize.resize_bilinear, instance_boxes):
        c.launches = 0
    got = node.estimate(*args, sample_indices=sample_indices)
    launches = {c.__name__: c.launches
                for c in (*counts, resize.resize_bilinear, instance_boxes)}
    if device.type == "cuda":
        n = launches["resize_bilinear"]
        check(n > 0 and n % 7 == 0,
              f"serving: {n} resize launches, not seven a forward")
        n = launches["instance_boxes"]
        check(n == 1, f"serving: {n} instance_boxes launches in one frame")

    cpu_model = serving_model(small, seed=3)
    cpu_node = PoseEstimationNode(cpu_model, voxel_pitch, image_size=S,
                                  device="cpu")
    want = cpu_node.estimate(*args, sample_indices=sample_indices)
    check(sorted(got) == sorted(want) == sorted(ids),
          f"serving: instances {sorted(got)} vs {sorted(want)}")
    pose_err = conf_err = 0.0
    for i in ids:
        T, Tc = got[i]["T_cad2cam"], want[i]["T_cad2cam"]
        check(T.shape == (4, 4) and np.isfinite(T).all(),
              f"serving: bad pose for instance {i}")
        pose_err = max(pose_err, float(np.abs(T - Tc).max()))
        conf_err = max(conf_err, abs(got[i]["confidence"]
                                     - want[i]["confidence"]))
    check(pose_err <= POSE_ATOL, f"serving: poses off by {pose_err}")
    check(conf_err <= CONF_ATOL, f"serving: confidences off by {conf_err}")

    reps = 20 if not small else 2
    for _ in range(3):
        node.estimate(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        node.estimate(*args)
    sync(device)
    ms = (time.perf_counter() - t0) / reps * 1e3

    # the node with ICP: one frame counted, then frames timed
    icp_node = PoseEstimationNode(model, voxel_pitch, image_size=S,
                                  device=device, with_icp=True,
                                  cad_points=ProceduralModels().get_pcd)
    for c in counts:
        c.launches = 0
    refined = icp_node.estimate(*args, sample_indices=sample_indices)
    icp_launches = {c.__name__: c.launches for c in counts}
    icp_iterations = dict(icp_node.last_icp_iterations)
    check(sorted(refined) == sorted(ids)
          and all(np.isfinite(refined[i]["T_cad2cam"]).all() for i in ids),
          "serving with ICP: bad poses")
    check(sorted(icp_iterations) == sorted(ids),
          f"serving with ICP: refined {sorted(icp_iterations)}")
    if device.type == "cuda":
        check(icp_launches["nn_indices"] == sum(icp_iterations.values()),
              f"serving with ICP: {icp_launches['nn_indices']} knn launches "
              f"for {sum(icp_iterations.values())} ICP iterations")
    icp_reps = 5 if not small else 1
    sync(device)
    t0 = time.perf_counter()
    for _ in range(icp_reps):
        icp_node.estimate(*args)
    sync(device)
    icp_ms = (time.perf_counter() - t0) / icp_reps * 1e3

    # the node in bf16 on the same frame and pixels, then timed
    node16 = PoseEstimationNode(serving_model(small, 3, torch.bfloat16),
                                voxel_pitch, image_size=S, device=device)
    got16 = node16.estimate(*args, sample_indices=sample_indices)
    check(sorted(got16) == sorted(ids)
          and all(np.isfinite(got16[i]["T_cad2cam"]).all() for i in ids),
          "serving in bf16: bad poses")
    bf16_pose_gap = max(float(np.abs(got16[i]["T_cad2cam"]
                                     - got[i]["T_cad2cam"]).max())
                        for i in ids)
    check(bf16_pose_gap > 0,
          "serving in bf16: the poses equal fp32's bit for bit")
    node_ms = {}
    for name, n in (("fp32", node), ("bf16", node16), ("fp32_again", node),
                    ("bf16_again", node16)):
        n.estimate(*args)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            n.estimate(*args)
        sync(device)
        node_ms[name] = (time.perf_counter() - t0) / reps * 1e3
    del node16
    emit(dict(phase="serving", ok=True, device=str(device),
              frame=[H, W], instances=len(ids), crop=S, n_point=n_point,
              max_pose_err=pose_err, max_conf_err=conf_err,
              tolerance=dict(pose=POSE_ATOL, conf=CONF_ATOL),
              launches=launches, estimate_ms=ms, frames=reps,
              with_icp=dict(icp_iterations=icp_iterations,
                            launches=icp_launches, estimate_ms=icp_ms,
                            frames=icp_reps),
              bf16=dict(node_pose_vs_fp32=bf16_pose_gap,
                        estimate_ms_in_turns=node_ms,
                        **bf16_serving(device, small))))
    return (icp_launches["nn_indices"], launches["resize_bilinear"],
            launches["instance_boxes"])


# --------------------------------------------------------------- phase 3


def random_rotation(g):
    q = g.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def occupancy_grid(points, origin, pitch, V):
    """``(V, V, V)`` uint8 grid, 255 where a point falls."""
    idx = np.round((points - origin) / pitch).astype(int)
    idx = idx[((idx >= 0) & (idx < V)).all(1)]
    grid = np.zeros((V, V, V), np.uint8)
    grid[idx[:, 0], idx[:, 1], idx[:, 2]] = 255
    return grid


def make_icc_scene(seed, N, M, V):
    """``N`` spheres and boxes of ``M`` solid points with analytic SDF,
    laid out side by side; their target and no-entry grids at the true
    poses; and the true poses perturbed by about 1 cm and 3 degrees."""
    g = np.random.RandomState(seed)
    points, sdf, poses, init = [], [], [], []
    for i in range(N):
        if i % 2 == 0:
            r = g.uniform(0.03, 0.05)
            p = g.uniform(-r, r, (4 * M, 3))
            p = p[np.linalg.norm(p, axis=1) < r][:M]
            s = r - np.linalg.norm(p, axis=1)
        else:
            h = g.uniform(0.02, 0.05, 3)
            p = g.uniform(-h, h, (M, 3))
            s = np.min(h - np.abs(p), axis=1)
        T = np.eye(4)
        T[:3, :3] = random_rotation(g)
        T[:3, 3] = [0.09 * (i % 4), 0.09 * (i // 4), 0.8]
        points.append(p.astype(np.float32))
        sdf.append(s.astype(np.float32))
        poses.append(T)
        d = np.eye(4)
        d[:3, :3] = np.linalg.qr(np.eye(3) + g.normal(0, 0.05, (3, 3)))[0]
        d[:3, :3] *= np.sign(np.diag(d[:3, :3]))[None]
        d[:3, 3] = g.normal(0, 0.01, 3)
        init.append(d @ T)
    extents = [np.linalg.norm(p, axis=1).max() for p in points]
    pitch = np.array([2.4 * e / V for e in extents], np.float32)
    origin = np.stack([T[:3, 3] - pc * (V / 2.0 - 0.5)
                       for T, pc in zip(poses, pitch)]).astype(np.float32)
    world = [p @ T[:3, :3].T + T[:3, 3] for p, T in zip(points, poses)]
    target = np.stack([occupancy_grid(world[i], origin[i], pitch[i], V)
                       for i in range(N)])
    nontarget = np.stack([
        occupancy_grid(
            np.concatenate([w for j, w in enumerate(world) if j != i]),
            origin[i], pitch[i], V) for i in range(N)])
    return (init, points, sdf, pitch, origin, target, nontarget)


def phase_icc(device, small, counts):
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck
    from morefusion_tpu_torch.ops import min_dist as md

    N, M, V = (8, 2048, 32) if not small else (4, 256, 16)
    iterations = 30
    scene = make_icc_scene(4, N, M, V)

    def refine():
        icc = IterativeCollisionCheck(*scene, voxel_dim=V, max_points=M,
                                      device=device)
        return icc.refine(iterations=iterations)

    # kernel against the plain version, in deterministic mode so that the
    # backward's scatter-adds sum in one order in both runs
    torch.use_deterministic_algorithms(True)
    try:
        T_k, loss_k, n_k = refine()
        with mock.patch.object(md, "min_dist_voxels",
                               md.min_dist_voxels_plain):
            T_p, loss_p, n_p = refine()
    finally:
        torch.use_deterministic_algorithms(False)
    # the kernel's outputs equal the plain version's bit for bit, so the
    # two refines are the same computation
    loss_err = float(np.abs(loss_k - loss_p).max())
    pose_err = float(np.abs(T_k - T_p).max())
    check(n_k == n_p, f"icc: n_iter {n_k} (kernel) vs {n_p} (plain)")
    check(loss_err == 0.0 and pose_err == 0.0,
          f"icc: loss curves {loss_err} and poses {pose_err} apart")

    # the main path, counted
    for c in counts:
        c.launches = 0
    Ts, losses, n_iter = refine()
    launches = {c.__name__: c.launches for c in counts}
    check(Ts.shape == (N, 4, 4) and np.isfinite(Ts).all(), "icc: bad poses")
    check(losses.shape == (iterations,) and np.isfinite(losses).all(),
          "icc: bad losses")
    check(min(losses) <= losses[0], "icc: best loss above the first")
    if device.type == "cuda":
        # the loop runs all its iterations on the device, frozen after the
        # plateau stop: one loss evaluation each
        check(launches["min_dist_voxels"] == iterations,
              f"icc: {launches['min_dist_voxels']} min_dist launches for "
              f"{iterations} iterations")

    # time refine() alone: the objects (host padding and the upload of
    # their arrays) are built before the clock starts, one per call, so
    # that every call starts from the same poses
    reps = 10 if not small else 1
    refine()
    sync(device)
    t0 = time.perf_counter()
    iccs = [IterativeCollisionCheck(*scene, voxel_dim=V, max_points=M,
                                    device=device) for _ in range(reps)]
    sync(device)
    t1 = time.perf_counter()
    for icc in iccs:
        icc.refine(iterations=iterations)
    sync(device)
    sec = (time.perf_counter() - t1) / reps
    construct_ms = (t1 - t0) / reps * 1e3
    emit(dict(phase="icc", ok=True, device=str(device), objects=N,
              points=M, voxel_dim=V, iterations=iterations, n_iter=n_iter,
              first_loss=float(losses[0]), best_loss=float(min(losses)),
              kernel_vs_plain_loss_err=loss_err,
              kernel_vs_plain_pose_err=pose_err, tolerance="identical",
              launches=launches, construct_ms=construct_ms,
              refine_ms=sec * 1e3, refines_per_s=1.0 / sec))
    return launches["min_dist_voxels"]


# --------------------------------------------------------------- phase 4


# torch.cdist's (B, V, P) float32 matrix, the yardstick's, above this is
# not timed
LIBRARY_MAX_BYTES = 20e9


def min_dist_timing(device, ip, valid, payload, reps, dims=ROOT_DIMS,
                    plain_reps=5):
    """One shape's row: the bound and, on the card, the kernel's, the plain
    version's and the yardstick's times, and the wrapper's host time."""
    from morefusion_tpu_torch.ops import min_dist as md

    B, P, _ = ip.shape
    n_valid = int((valid & ~torch.isnan(ip).any(-1)).sum())
    bound_ms, bound_by = bound(*min_dist_work(B, P, dims, n_valid))
    # voxel-point pairs: every voxel against every valid, non-NaN point
    pairs = int(np.prod(dims)) * n_valid
    row = dict(shape=dict(B=B, P=P, dims=list(dims)), pairs=pairs,
               bound_ms=bound_ms, bound_by=bound_by)
    if device.type != "cuda":
        row.update(kernel_ms=None, plain_ms=None, library_ms=None,
                   slots_per_pair=None, host_ms=None)
        return row
    centers = md.voxel_centers(dims, device)[None].expand(B, -1, -1)

    def kernel():
        return md.min_dist_voxels(ip, valid, payload, dims)

    kernel_ms = cuda_ms(kernel, reps)
    fits = B * centers.shape[1] * P * 4 <= LIBRARY_MAX_BYTES
    row.update(
        kernel_ms=kernel_ms,
        host_ms=host_ms(kernel, reps),
        slots_per_pair=kernel_ms * 1e-3 * ISSUE_SLOTS_PER_S / pairs,
        plain_ms=cuda_ms(
            lambda: md.min_dist_voxels_plain(ip, valid, payload, dims),
            plain_reps, warmup=1),
        # yardstick only, never called by the port: two PyTorch calls,
        # with no mask and no payload
        library_ms=(cuda_ms(lambda: torch.cdist(centers, ip).min(dim=2),
                            plain_reps, warmup=1) if fits else None),
    )
    if not fits:
        row["library_note"] = (f"cdist's {B}x{centers.shape[1]}x{P} matrix "
                               f"exceeds {LIBRARY_MAX_BYTES:.0e} bytes")
    torch.cuda.empty_cache()
    return row


def phase_kernel_timing(device, small, train_inputs):
    """The min-distance kernel at the ICC shape, at the train step's and
    at the evaluation's new shapes."""
    B, P = (8, 2048) if not small else (2, 300)
    icc = min_dist_timing(
        device, *min_dist_inputs(0, B, P, "icc", device), 100)
    train = min_dist_timing(device, *train_inputs, 50)
    evaluation = {}
    for seed, (case, mode, N, M, V) in enumerate(eval_min_dist_cases(small)):
        inputs = eval_min_dist_inputs(seed, mode, N, M, V, device)
        evaluation[case] = min_dist_timing(device, *inputs, 20, (V, V, V),
                                           plain_reps=2)
        del inputs
    row = dict(phase="kernel_timing", **icc, train=train,
               evaluation=evaluation,
               library_call="torch.cdist(centers, points).min(dim=2) "
                            "(two calls)")
    if device.type != "cuda":
        row["note"] = "times are taken on the card only"
    emit(row)
    return row


# --------------------------------------------------------------- phase 5


def knn_inputs(seed, B, R, Q, case, device):
    """``ref (B, R, 3)`` and ``query (B, Q, 3)`` on ``device``. ``train``:
    each lane's R CAD-like points at 0.8 m from the camera, the queries the
    same points under Q / R predicted poses about 2 cm and 10 degrees off,
    as ADD-S sees them in training."""
    g = np.random.RandomState(seed)
    ref = g.uniform(-0.1, 0.1, (B, R, 3)) + [0.0, 0.0, 0.8]
    if case.startswith("ties"):
        # integer points, each twice (R // 2 apart): exact ties that the
        # lowest index wins
        ref = g.randint(-4, 5, (B, R, 3)).astype(np.float64)
        ref[:, R // 2:] = ref[:, : R - R // 2]
    ref_t = torch.from_numpy(ref.astype(np.float32)).to(device)
    if case == "nan_overflow":
        # lane 0: reference 0 gives NaN, every other one overflows, so no
        # distance is finite (index 0, d2 +inf)
        ref_t[0, 0, 0] = float("nan")
        ref_t[0, 1:, 2] = 3e38
    if case == "train":
        M = Q // R
        rot = np.stack([[random_rotation_near(g, 0.1) for _ in range(M)]
                        for _ in range(B)])  # (B, M, 3, 3)
        shift = g.normal(0, 0.02, (B, M, 3))
        rot_t = torch.from_numpy(rot.astype(np.float32)).to(device)
        center = ref_t.mean(1, keepdim=True)[:, None]  # (B, 1, 1, 3)
        query_t = (torch.einsum("bmij,bmnj->bmni", rot_t,
                                ref_t[:, None] - center) + center
                   + torch.from_numpy(shift.astype(np.float32)).to(
                       device)[:, :, None]).reshape(B, Q, 3).contiguous()
    else:
        ties = case.startswith("ties")
        lo, hi = (-5, 6) if ties else (-0.12, 0.12)
        query = g.uniform(lo, hi, (B, Q, 3)) + (0.0 if ties else [0.0, 0.0, 0.8])
        if ties:
            query = np.round(query)
        query_t = torch.from_numpy(query.astype(np.float32)).to(device)
    return ref_t, query_t


def random_rotation_near(g, scale):
    a = np.linalg.qr(np.eye(3) + g.normal(0, scale, (3, 3)))[0]
    return a * np.sign(np.diag(a))[None]


def chosen_d2(ref, query, idx):
    """Squared distance of each query to the reference point ``idx`` picks."""
    p = torch.gather(ref, 1, idx.long()[..., None].expand(-1, -1, 3))
    return ((query - p) ** 2).sum(-1)


def finite_max_abs(a, b):
    diff = (a - b).abs()
    diff = diff[torch.isfinite(diff)]
    return float(diff.max()) if diff.numel() else 0.0


def phase_knn_vs_plain(device, small):
    from morefusion_tpu_torch.ops import knn

    B, M, N = ((TRAIN_B, TRAIN_POSES, TRAIN_CAD) if not small
               else (2, 20, 50))
    # the kernel takes kThreads x kQ = 1024 queries a block and kTile = 2048
    # references a shared-memory tile, in sub-tiles of kSub (csrc/knn.cu)
    cases = [("train", B, N, M * N), ("one_ref", 2, 1, 4096),
             ("ties", 2, 64, 4096), ("ragged", 3, N, 50 * N + 17),
             ("above_tpu_cap", 1, 20000 if not small else 700, 3000),
             ("one_lane", 1, N, 10 * N), ("ragged_block", 2, 37, 3 * 1024 + 1),
             ("ties_across_tiles", 2, 5000 if not small else 300, 2000),
             ("nan_overflow", 2, 40, 1000)]
    results = []
    max_err = 0.0
    for seed, (case, b, r, q) in enumerate(cases):
        ref, query = knn_inputs(100 + seed, b, r, q, case, device)
        got = knn.nn_indices(ref, query)  # ADD-S's call: no d2 written
        got_d2, d2 = knn.nn_indices(ref, query, return_d2=True)  # ICP's
        sync(device)
        want, want_d2 = knn.nn_indices_plain(ref, query, return_d2=True)
        n_diff = int((got != want).sum()) + int((got_d2 != want).sum())
        d2_diff = int((d2.view(torch.int32) != want_d2.view(torch.int32))
                      .sum())
        err = finite_max_abs(chosen_d2(ref, query, got),
                             chosen_d2(ref, query, want))
        check(n_diff == 0, f"knn {case}: {n_diff} indices differ "
                           f"(chosen d2 up to {err} apart)")
        check(d2_diff == 0, f"knn {case}: {d2_diff} winners' d2 differ "
                            f"(up to {finite_max_abs(d2, want_d2)} apart)")
        if case.startswith("ties"):
            check(bool((got < r - r // 2).all()),
                  "knn ties: a tie did not go to the lowest index")
        if case == "nan_overflow":
            check(bool((got[0] == 0).all() and torch.isposinf(d2[0]).all()),
                  "knn nan_overflow: no finite distance, yet not index 0 "
                  "and d2 +inf")
        max_err = max(max_err, err)
        results.append(dict(case=case, B=b, R=r, Q=q, index_mismatches=n_diff,
                            d2_mismatches=d2_diff, max_abs_err=err))
    emit(dict(phase="knn_vs_plain", ok=True, cases=results,
              tolerance="identical indices and d2 bits"))
    return max_err


# --------------------------------------------------------------- phase 6


def make_train_batch(B, S=256, V=32, seed=0):
    """The JAX package's synthetic train batch (``make_batch`` of
    ``examples/profile_train.py``, copied: this script imports nothing of
    that package)."""
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 255, (B, S, S, 3)).astype(np.float32)
    pcd = rng.uniform(-0.2, 0.2, (B, S, S, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    hole = rng.rand(B, S, S) < 0.35
    pcd[hole] = np.nan
    q = rng.randn(B, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        class_id=rng.randint(1, 22, B).astype(np.int32),
        rgb=rgb,
        pcd=pcd,
        quaternion_true=q,
        translation_true=np.float32(
            rng.uniform(-0.1, 0.1, (B, 3)) + [0, 0, 0.8]
        ),
        origin=np.float32(rng.uniform(-0.2, 0.0, (B, 3)) + [0, 0, 0.7]),
        pitch=np.full(B, 0.01, np.float32),
        grid_target=(rng.rand(B, V, V, V) < 0.05).astype(np.float32),
        grid_nontarget_empty=(rng.rand(B, V, V, V) < 0.3).astype(
            np.float32
        ),
    )


def loss_and_grads(model, loss_fn, batch, train, seed=0):
    """One step's metrics and gradients, without the optimizer, and the
    pose each lane's occupancy loss took (its highest confidence)."""
    from morefusion_tpu_torch.training import trainer

    device = next(model.parameters()).device
    model.zero_grad(set_to_none=True)
    sample_gen, dropout_gen = trainer.step_generators(seed, 0, device)[:2]
    seen = []
    hook = model.register_forward_hook(
        lambda mod, args, out: seen.append(out[2].detach()))
    try:
        loss, metrics = loss_fn(batch, True, train=train,
                                sample_generator=sample_gen,
                                dropout_generator=dropout_gen)
    finally:
        hook.remove()
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    best = seen[0].argmax(dim=1).tolist()
    return {k: float(v.detach()) for k, v in metrics.items()}, grads, best


def compare_steps(got, want, loss_rtol, grad_rtol, grad_total, what):
    """Metrics within ``loss_rtol``; each parameter's gradient within
    ``grad_rtol`` of its own norm plus ``grad_total`` of the whole
    gradient's norm. Returns the worst errors."""
    (m1, g1, best1), (m2, g2, best2) = got, want
    # the occupancy loss takes each lane's best-confidence pose: a near-tie
    # that the two runs break differently compares two other poses
    check(best1 == best2, f"{what}: best poses {best1} vs {best2}")
    loss_err = max(abs(m1[k] - m2[k]) / max(abs(m2[k]), 1e-12) for k in m2)
    check(loss_err <= loss_rtol, f"{what}: losses {m1} vs {m2}")
    total = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in g2.values())))
    worst_rel = worst_ratio = 0.0
    for name, g in g2.items():
        err = float((g1[name].to(g.device) - g).norm())
        norm = float(g.norm())
        bound = grad_rtol * norm + grad_total * total
        worst_rel = max(worst_rel, err / max(norm, 1e-30))
        worst_ratio = max(worst_ratio, err / bound)
        check(err <= bound, f"{what}: gradient of {name} off by {err} "
                            f"(norm {norm}, whole gradient {total})")
    return dict(loss_rel_err=loss_err, grad_max_rel_err=worst_rel,
                grad_max_err_over_tolerance=worst_ratio, best_poses=best1)


def train_setup(device, small):
    """The procedural CAD models, their bank on ``device`` (500 points and
    up to 3000 solid points per class), the seconds the bank took to
    build, and the train batch. ADD-S, and so the knn kernel, enters the
    loss only in lanes of a symmetric class; the batch must hold one."""
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.training import trainer

    B, S = (TRAIN_B, 256) if not small else (2, 64)
    t0 = time.perf_counter()
    models = ProceduralModels()
    bank = trainer.CadPointBank.build(models, 21, device=device)
    bank_s = time.perf_counter() - t0
    batch = make_train_batch(B, S)
    symmetric = bank.symmetric.cpu().numpy()
    if not symmetric[batch["class_id"]].any():
        # the rehearsal's two lanes draw none: give the last lane one
        batch["class_id"][-1] = np.flatnonzero(symmetric)[0]
    return models, bank, bank_s, batch


def resize_bound_ms(x, g):
    """Bytes a direction of the resize must move (the input read once and
    the output written once, or the reverse) at the card's HBM rate."""
    return (x.numel() + g.numel()) * x.element_size() / PEAK_BYTES_PER_S * 1e3


def resize_vs_plain(device, small):
    """The resize kernels against ``F.interpolate`` at PSPNet's seven
    B = 16 shapes, fp32, each direction checked and timed; on the CPU
    (where ``resize_bilinear`` is ``F.interpolate``) at B = 2 and a 64th of
    the channels, untimed."""
    from morefusion_tpu_torch.ops import resize as R

    B, reps = (TRAIN_B, 20) if not small else (2, 0)
    gen = torch.Generator(device).manual_seed(11)
    rows, launches = [], 0
    for C, H, W, h, w in RESIZE_SHAPES:
        C = C if not small else max(1, C // 64)
        x = torch.randn((B, C, H, W), generator=gen, device=device)
        g = torch.randn((B, C, h, w), generator=gen, device=device)
        before = R.resize_bilinear.launches
        gx = []
        for _ in range(2):
            xr = x.detach().clone().requires_grad_(True)
            y = R.resize_bilinear(xr, h, w)
            y.backward(g)
            gx.append(xr.grad)
        launches += R.resize_bilinear.launches - before
        y_lib = R.resize_bilinear_plain(x, h, w)
        what = f"resize {C}x{H}x{W} -> {h}x{w}"
        check(torch.equal(y.detach().view(torch.int32),
                          y_lib.view(torch.int32)),
              f"{what}: the forward's bits differ from F.interpolate's")
        check(torch.equal(gx[0], gx[1]), f"{what}: two backwards differ")
        x64 = x.double().requires_grad_(True)
        R.resize_bilinear_plain(x64, h, w).backward(g.double())
        terms = R.resize_bilinear_backward_plain(g.abs().double(), H, W)
        err = (gx[0].double() - x64.grad).abs()
        worst = float((err / (terms + 1e-30)).max())
        check(worst <= RESIZE_GRAD_RTOL,
              f"{what}: backward off by {worst} of its terms' magnitudes")
        x_lib = x.detach().clone().requires_grad_(True)
        R.resize_bilinear_plain(x_lib, h, w).backward(g)
        lib_gap = float(torch.linalg.vector_norm(gx[0] - x_lib.grad)
                        / torch.linalg.vector_norm(x_lib.grad))
        row = dict(shape=[B, C, H, W, h, w], grad_err_of_terms=worst,
                   grad_vs_interpolate_norm=lib_gap,
                   bound_ms=resize_bound_ms(x, g))
        del x64, terms, err, x_lib
        if device.type == "cuda":
            y_out, gx_out = torch.empty_like(y_lib), torch.empty_like(x)
            row.update(
                kernel_fwd_ms=cuda_ms(lambda: R._launch(
                    "mfk_resize_forward", x, y_out, (H, W), (h, w)), reps),
                kernel_bwd_ms=cuda_ms(lambda: R._launch(
                    "mfk_resize_backward", g, gx_out, (H, W), (h, w)), reps),
                plain_bwd_ms=cuda_ms(
                    lambda: R.resize_bilinear_backward_plain(g, H, W), reps),
                library_fwd_ms=cuda_ms(
                    lambda: R.resize_bilinear_plain(x, h, w), reps),
                library_bwd_ms=cuda_ms(
                    lambda: torch.ops.aten.upsample_bilinear2d_backward(
                        g, [h, w], [B, C, H, W], False, None, None), reps))
        rows.append(row)
        del x, g, y, y_lib, gx
    check(device.type != "cuda" or launches == 4 * len(RESIZE_SHAPES),
          f"resize: {launches} launches for {len(RESIZE_SHAPES)} shapes, "
          f"not two forwards and two backwards each")
    total = {}
    if device.type == "cuda":
        fwd = sum(r["kernel_fwd_ms"] for r in rows)
        bwd = sum(r["kernel_bwd_ms"] for r in rows)
        lib_fwd = sum(r["library_fwd_ms"] for r in rows)
        bound = sum(r["bound_ms"] for r in rows)
        total = dict(
            kernel_ms=fwd + bwd, kernel_fwd_ms=fwd, kernel_bwd_ms=bwd,
            # the plain forward is F.interpolate's, the plain backward the
            # gather (resize_bilinear_backward_plain)
            plain_ms=lib_fwd + sum(r["plain_bwd_ms"] for r in rows),
            library_ms=lib_fwd + sum(r["library_bwd_ms"] for r in rows),
            library_fwd_ms=lib_fwd,
            library_bwd_ms=sum(r["library_bwd_ms"] for r in rows),
            bound_ms=2 * bound, bound_by="bytes")
    return dict(shapes=rows, launches=launches,
                max_grad_err_of_terms=max(r["grad_err_of_terms"]
                                          for r in rows),
                tolerance=dict(forward="bits", grad_of_terms=RESIZE_GRAD_RTOL,
                               runs="identical"), **total)


def maskrcnn_boxes(r, n, hw=(800, 1066)):
    """``n`` boxes of 2-700 px a side over the input, some past its edge."""
    side = np.exp(r.uniform(np.log(2), np.log(700), (n, 2)))
    cx, cy = r.uniform(-20, hw[1] + 20, n), r.uniform(-20, hw[0] + 20, n)
    return torch.from_numpy(np.stack(
        [cx - side[:, 0] / 2, cy - side[:, 1] / 2, cx + side[:, 0] / 2,
         cy + side[:, 1] / 2], 1).astype(np.float32))


def maskrcnn_kernels_vs_plain(device, small):
    """Mask R-CNN's RoIAlign and NMS kernels against their plain versions
    at the seg1 cell's shapes, each call checked and timed; on the CPU
    (where both wrappers run the plain versions) at a 16th of the channels,
    untimed."""
    from mfbench import counts_maskrcnn as CM
    from morefusion_tpu_torch.ops import nms as N
    from morefusion_tpu_torch.ops import roi_align as RA

    C, reps = (256, 20) if not small else (16, 0)
    r = np.random.RandomState(13)
    gen = torch.Generator(device).manual_seed(13)
    feats = [torch.randn((1, C, h, w), generator=gen, device=device)
             for h, w in MASKRCNN_LEVELS]
    scale = max(float(f.abs().max()) for f in feats)
    roi_rows, roi_launches = [], RA.roi_align.launches
    for call, n, P in (("box", 1000, 7), ("mask", 8, 14)):
        rois = maskrcnn_boxes(r, n).to(device)
        got = [RA.roi_align(feats, rois, P) for _ in range(2)]
        sync(device)
        err = float((got[0] - RA.roi_align_plain(feats, rois, P)).abs()
                    .max()) / scale
        check(err <= ROI_ALIGN_RTOL,
              f"roi_align {call}: {err} of the features' magnitude off "
              f"its plain version")
        check(torch.equal(got[0], got[1]), f"roi_align {call}: two runs "
              f"differ")
        ops, nbytes = CM.roi_align_work(rois.cpu().numpy(), MASKRCNN_LEVELS,
                                        C, P)
        bound_ms, bound_by = bound(ops, nbytes)
        row = dict(call=call, shape=[n, C, P, P], err_of_scale=err,
                   bound_ms=bound_ms, bound_by=bound_by)
        if device.type == "cuda":
            row.update(kernel_ms=cuda_ms(
                lambda: RA.roi_align(feats, rois, P), reps),
                plain_ms=cuda_ms(
                    lambda: RA.roi_align_plain(feats, rois, P), 3))
        roi_rows.append(row)
    roi_launches = RA.roi_align.launches - roi_launches
    nms_rows, nms_launches = [], N.nms.launches
    sizes = [1000, 1000, 1000, 1000, 663]
    starts = np.cumsum([0] + sizes[:-1]).tolist()
    props = torch.cat([maskrcnn_boxes(r, n) for n in sizes])
    props = torch.stack([props[:, 0].clamp(0, 1066),
                         props[:, 1].clamp(0, 800),
                         props[:, 2].clamp(0, 1066),
                         props[:, 3].clamp(0, 800)], 1)
    labels = torch.from_numpy(r.randint(1, 22, 1000).astype(np.int32))
    for call, boxes, thr, kw, groups in (
            ("proposals", props, 0.7, dict(groups=list(zip(starts, sizes))),
             sizes),
            ("detections", maskrcnn_boxes(r, 1000), 0.5,
             dict(labels=labels), [1000])):
        valid = torch.from_numpy(r.rand(len(boxes)) > 0.02)
        want = N.nms_plain(boxes, thr, valid=valid, **kw)
        dev_kw = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                  for k, v in kw.items()}
        args = (boxes.to(device), thr)
        dev_kw["valid"] = valid.to(device)
        got = [N.nms(*args, **dev_kw).cpu() for _ in range(2)]
        check(torch.equal(got[0], want) and torch.equal(got[1], want),
              f"nms {call}: keep flags differ from the greedy walk's")
        ops, nbytes = CM.nms_work(groups, labels="labels" in kw)
        bound_ms, bound_by = bound(ops, nbytes)
        row = dict(call=call, boxes=len(boxes), kept=int(want.sum()),
                   bound_ms=bound_ms, bound_by=bound_by)
        if device.type == "cuda":
            row.update(kernel_ms=cuda_ms(lambda: N.nms(*args, **dev_kw),
                                         reps),
                       plain_ms=cuda_ms(
                           lambda: N.nms_plain(*args, **dev_kw), 1))
        nms_rows.append(row)
    nms_launches = N.nms.launches - nms_launches
    out = dict(roi_align=dict(calls=roi_rows, launches=roi_launches,
                              max_err_of_scale=max(x["err_of_scale"]
                                                   for x in roi_rows),
                              tolerance=ROI_ALIGN_RTOL),
               nms=dict(calls=nms_rows, launches=nms_launches,
                        tolerance="identical keep flags"))
    for k in ("roi_align", "nms"):
        rows = out[k]["calls"]
        out[k]["bound_ms"] = sum(x["bound_ms"] for x in rows)
        if device.type == "cuda":
            out[k]["ms"] = sum(x["kernel_ms"] for x in rows)
            out[k]["plain_ms"] = sum(x["plain_ms"] for x in rows)
    frames = maskrcnn_frames(device, small)
    for k in ("roi_align", "nms"):
        out[k]["frame_launches"] = frames[k]
    out["resize_frame_launches"] = frames["resize"]
    out["frame_ms"] = frames["frame_ms"]
    emit(dict(phase="maskrcnn_kernels", **out))
    return out


def instance_boxes_vs_plain(device, small):
    """The pose node's selection kernel (``csrc/instance_boxes.cu``)
    against its plain version on a frame of the serving cell's shape (480 x
    640, 8 instances, 2% holes) and its ids with two that have no pixel:
    the same bits, twice; each call's device time from a profiler trace
    (the launch's host work bounds calls queued back to back, so CUDA
    events between them would time the host), beside the host rule the
    node used before the kernel (a full-frame mask, a finite test and
    ``masks_to_bboxes`` an instance). On the CPU at a quarter of the side,
    untimed."""
    from morefusion_tpu_torch.geometry import masks_to_bboxes
    from morefusion_tpu_torch.ops import instance_boxes as IB

    H, W = (480, 640) if not small else (120, 160)
    _, pcd, label = make_frame(23, H, W, n_obj=8)
    ids = np.array([1, 2, 3, 4, 5, 6, 7, 8, 40, 41], np.int32)
    host = [torch.from_numpy(a) for a in (label, pcd, ids)]
    want = IB.instance_boxes_plain(*host)
    args = [t.to(device) for t in host]
    launches = IB.instance_boxes.launches
    got = [IB.instance_boxes(*args).cpu() for _ in range(2)]
    check(all(torch.equal(g, want) for g in got),
          "instance_boxes: the kernel's boxes differ from its plain version's")

    def host_rule():
        finite = ~np.isnan(pcd).any(axis=2)
        for ins_id in ids:
            mask = label == ins_id
            (mask & finite).any()
            masks_to_bboxes(mask)

    t0 = time.perf_counter()
    for _ in range(5):
        host_rule()
    nbytes = label.nbytes + pcd.nbytes + ids.nbytes + 4 * want.numel()
    row = dict(phase="instance_boxes", shape=[H, W], ids=len(ids),
               kept=int((want[:, 4] > 0).sum()), identical=True,
               host_rule_ms=(time.perf_counter() - t0) * 1e3 / 5,
               bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
    if device.type == "cuda":
        kernel = profile_calls(lambda: IB.instance_boxes(*args), device, 50)
        plain = profile_calls(lambda: IB.instance_boxes_plain(*args), device,
                              10)
        row.update(
            kernel_ms=kernel["card_busy_ms"],
            kernel_ops_per_call=kernel["kernels_per_call"],
            kernel_host_ms=host_ms(lambda: IB.instance_boxes(*args), 50),
            plain_ms=plain["card_busy_ms"], plain_wall_ms=plain["wall_ms"],
            plain_ops_per_call=plain["kernels_per_call"])
    row["launches"] = IB.instance_boxes.launches - launches
    emit(row)
    return row


def maskrcnn_frames(device, small):
    """Mask R-CNN on its main path: the cell's model (weights and frozen
    BatchNorm statistics from a seed, as the cell makes them) in its
    segmenter node, one 480 x 640 frame a count of ``MASKRCNN_FRAME_OBJECTS``
    after one to warm up. Each frame must launch RoIAlign twice (box and
    mask calls), NMS twice (proposals, detections) and the resize once, and
    keep as many instances as asked for; the kernels' launches of the
    counted frames, and their host-clock milliseconds (hand-over to the
    label on the host)."""
    from mfbench import generators
    from mfbench.drivers import segment_frame
    from morefusion_tpu_torch.models.maskrcnn import (
        MaskRCNN,
        MaskRCNNSegmentationNode,
    )
    from morefusion_tpu_torch.ops import nms as N
    from morefusion_tpu_torch.ops import resize as RS
    from morefusion_tpu_torch.ops import roi_align as RA

    seed = 2**31 + 22
    kw = read_json(MASKRCNN_CONFIG)["kwargs"]
    if small:
        kw = {**kw, **MASKRCNN_REHEARSAL_KWARGS}
    with torch.device(device):
        model = MaskRCNN(**kw)
    segment_frame.frozen_bn(generators.load_weights(model, seed), seed)
    node = MaskRCNNSegmentationNode(model, device=device)
    counters = {"roi_align": RA.roi_align, "nms": N.nms,
                "resize": RS.resize_bilinear}
    per_frame = {"roi_align": 2, "nms": 2, "resize": 1}
    launches = dict.fromkeys(counters, 0)
    ms = []
    for i, n_obj in enumerate((MASKRCNN_FRAME_OBJECTS[0],)
                              + MASKRCNN_FRAME_OBJECTS):
        rgb = make_frame(100 + i, n_obj=n_obj)[0]
        before = {k: f.launches for k, f in counters.items()}
        sync(device)
        t0 = time.perf_counter()
        label, classes = node(rgb, max_instances=n_obj)
        ms.append((time.perf_counter() - t0) * 1e3)
        check(label.shape == rgb.shape[:2] and len(classes) == n_obj,
              f"maskrcnn frame {i}: a {label.shape} label with "
              f"{len(classes)} instances, not {n_obj}")
        if i == 0:
            continue
        for k, f in counters.items():
            got = f.launches - before[k]
            want = per_frame[k] if device.type == "cuda" else 0
            check(got == want, f"maskrcnn frame {i}: {got} {k} launches, "
                  f"not {want}")
            launches[k] += got
    del node, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(launches, frame_ms=sorted(ms[1:]))


def phase_train(device, small, counts, setup):
    from morefusion_tpu_torch.models import pspnet
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md
    from morefusion_tpu_torch.ops import resize
    from morefusion_tpu_torch.training import trainer

    models, bank, bank_s, batch = setup
    B, S = batch["rgb"].shape[:2]
    symmetric_lanes = int(
        bank.symmetric.cpu().numpy()[batch["class_id"]].sum())
    check(symmetric_lanes >= 1, "train: no lane of a symmetric class")
    model = serving_model(small, seed=5).to(device)

    # (a) kernels against plain versions: same device, same generators, so
    # the same samples and dropout masks; deterministic mode makes the
    # scatter-adds sum in one order (the plain side's bilinear upsampling
    # backward, F.interpolate's, has no deterministic CUDA version and stays
    # atomic: warn_only)
    loss_fn = trainer.make_loss_fn(model, bank)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            kernel = loss_and_grads(model, loss_fn, batch, train=True)
            with mock.patch.object(md, "min_dist_voxels",
                                   md.min_dist_voxels_plain), \
                    mock.patch.object(knn, "nn_indices",
                                      knn.nn_indices_plain), \
                    mock.patch.object(pspnet, "resize_bilinear",
                                      resize.resize_bilinear_plain):
                plain = loss_and_grads(model, loss_fn, batch, train=True)
    finally:
        torch.use_deterministic_algorithms(False)
    vs_plain = compare_steps(kernel, plain, STEP_LOSS_RTOL, STEP_GRAD_RTOL,
                             STEP_GRAD_TOTAL, "train kernel vs plain")
    del kernel, plain

    # (b) the card against the CPU at B = 2, dropout off, same samples
    b2 = make_train_batch(2, S, seed=1)
    mask = ~np.isnan(b2["pcd"]).any(-1).reshape(2, -1)
    g = np.random.RandomState(6)
    b2["sample_indices"] = np.stack([
        g.choice(np.flatnonzero(m), model.n_point, replace=False)
        for m in mask]).astype(np.int64)
    on_card = loss_and_grads(model, loss_fn, b2, train=False)
    cpu_model = serving_model(small, seed=5)
    cpu_bank = trainer.CadPointBank.build(models, 21, device="cpu")
    on_cpu = loss_and_grads(cpu_model,
                            trainer.make_loss_fn(cpu_model, cpu_bank),
                            b2, train=False)
    vs_cpu = compare_steps(on_card, on_cpu, CPU_LOSS_RTOL, CPU_GRAD_RTOL,
                           CPU_GRAD_TOTAL, "train card vs cpu")
    del on_card, on_cpu, cpu_model, cpu_bank

    # (c) the main path: five steps with dropout on, counted and timed
    state = trainer.create_train_state(model)
    step = trainer.make_train_step(model, bank)
    n_steps = 5
    for c in (*counts, resize.resize_bilinear):
        c.launches = 0
    step_ms, losses = [], []
    for _ in range(n_steps):
        sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, True, seed=0)
        loss = float(metrics["loss"])  # reads back: the step has ended
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
        check(np.isfinite(loss), f"train: loss {loss} at step {state.step}")
    launches = {c.__name__: c.launches
                for c in (*counts, resize.resize_bilinear)}
    if device.type == "cuda":
        for name in ("min_dist_voxels", "nn_indices"):
            check(launches[name] >= n_steps,
                  f"train: {launches[name]} {name} launches in {n_steps} "
                  f"steps")
        check(launches["resize_bilinear"] == 14 * n_steps,
              f"train: {launches['resize_bilinear']} resize launches in "
              f"{n_steps} steps, not 14 a step")

    # (d) one eval step
    out = trainer.make_eval_step(model, bank)(batch)
    for k in ("add", "add_s", "add_or_add_s"):
        check(out[k].shape == (B,) and bool(torch.isfinite(out[k]).all()),
              f"eval: bad {k}")
    check(bool((out["add_s"] <= out["add"] + 1e-6).all()),
          "eval: ADD-S above ADD")
    eval_add = [float(x) for x in out["add_or_add_s"]]
    del state, step, out
    resize_row = resize_vs_plain(device, small)
    emit(dict(phase="train", ok=True, device=str(device), batch=B, crop=S,
              n_point=model.n_point, voxel_dim=model.voxel_dim,
              symmetric_lanes=symmetric_lanes, bank_build_s=bank_s, kernel_vs_plain=vs_plain,
              card_vs_cpu=vs_cpu,
              tolerance=dict(kernel_vs_plain=dict(
                  loss_rtol=STEP_LOSS_RTOL, grad_rtol=STEP_GRAD_RTOL,
                  grad_of_whole=STEP_GRAD_TOTAL),
                  card_vs_cpu=dict(loss_rtol=CPU_LOSS_RTOL,
                                   grad_rtol=CPU_GRAD_RTOL,
                                   grad_of_whole=CPU_GRAD_TOTAL,
                                   best_poses="equal")),
              steps=n_steps, losses=losses,
              step_ms=step_ms, median_step_ms=float(np.median(step_ms)),
              launches=launches,
              launches_per_step={k: v / n_steps for k, v in launches.items()},
              eval_add=eval_add, resize=resize_row))
    return launches, float(np.median(step_ms)), resize_row


# --------------------------------------------------------------- phase 7


def knn_icp_timing(device, ref, query):
    """The knn kernel at ICP's shape, with the d2 output ICP reads: the
    bound, and on the card the kernel's, the plain version's and the
    yardstick's times and the wrapper's host time a call."""
    from morefusion_tpu_torch.ops import knn

    B, R, _ = ref.shape
    Q = query.shape[1]
    bound_ms, bound_by = bound(*knn_work(B, R, Q, with_d2=True))
    row = dict(shape=dict(B=B, Q=Q, R=R), pairs=B * Q * R,
               bound_ms=bound_ms, bound_by=bound_by)
    if device.type != "cuda":
        row.update(kernel_ms=None, host_ms=None, plain_ms=None,
                   library_ms=None)
        return row

    def kernel():
        return knn.nn_indices(ref, query, return_d2=True)

    row.update(
        kernel_ms=cuda_ms(kernel, 200),
        host_ms=host_ms(kernel, 200),
        plain_ms=cuda_ms(
            lambda: knn.nn_indices_plain(ref, query, return_d2=True), 50),
        # yardstick only, never called by the port: distances, not squared
        library_ms=cuda_ms(lambda: torch.cdist(query, ref).min(dim=2), 50),
        library_call="torch.cdist(query, ref).min(dim=2) (two calls)",
    )
    return row


def phase_knn_timing(device, small, icp_clouds):
    from morefusion_tpu_torch.ops import knn

    B, M, N = ((TRAIN_B, TRAIN_POSES, TRAIN_CAD) if not small
               else (2, 20, 50))
    ref, query = knn_inputs(100, B, N, M * N, "train", device)
    bound_ms, bound_by = bound(*knn_work(B, N, M * N))
    pairs = B * M * N * N
    row = dict(phase="knn_timing", shape=dict(B=B, Q=M * N, R=N),
               pairs=pairs, bound_ms=bound_ms, bound_by=bound_by,
               icp_shape=knn_icp_timing(device, *icp_clouds))
    if device.type != "cuda":
        row.update(kernel_ms=None, plain_ms=None, library_ms=None,
                   slots_per_pair=None,
                   note="times are taken on the card only")
        emit(row)
        return row
    chunk = 62500  # (16, 62500, 500) distances: 2 GB a call

    def library():
        for base in range(0, M * N, chunk):
            torch.cdist(query[:, base:base + chunk], ref).argmin(dim=2)

    kernel_ms = cuda_ms(lambda: knn.nn_indices(ref, query), 20)
    row.update(
        kernel_ms=kernel_ms,
        slots_per_pair=kernel_ms * 1e-3 * ISSUE_SLOTS_PER_S / pairs,
        plain_ms=cuda_ms(lambda: knn.nn_indices_plain(ref, query), 2, 1),
        # yardstick only, never called by the port
        library_ms=cuda_ms(library, 3, 1),
        library_call=f"torch.cdist(query, ref).argmin(dim=2), "
                     f"{-(-M * N // chunk)} chunks of {chunk} queries",
    )
    emit(row)
    return row


# --------------------------------------------------------------- phase 8


def rotation_about(axis, degrees):
    """Rotation matrix by ``degrees`` about the unit vector ``axis``."""
    K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    a = np.radians(degrees)
    return np.eye(3) + np.sin(a) * K + (1.0 - np.cos(a)) * K @ K


def make_icp_scene(seed, small):
    """Four procedural objects side by side 0.8 m from the camera: each
    class's CAD points (4000; 1000 in the rehearsal), the camera-facing half
    of them under the true pose (the nearer half in depth) plus 1 mm of
    Gaussian noise as the observed depth points, the true pose, and the
    true pose turned 6 degrees about a random axis and moved 8 mm in a
    random direction as the start."""
    from morefusion_tpu_torch.datasets import ProceduralModels

    g = np.random.RandomState(seed)
    models = ProceduralModels()
    scene = []
    for k, class_id in enumerate(ICP_CLASSES):
        cad = models.get_pcd(class_id)[: 1000 if small else None]
        T = np.eye(4)
        T[:3, :3] = random_rotation(g)
        T[:3, 3] = [0.2 * k - 0.3, g.uniform(-0.03, 0.03), 0.8]
        world = cad @ T[:3, :3].T + T[:3, 3]
        near = world[:, 2] < np.median(world[:, 2])
        depth = world[near] + g.normal(0, 0.001, (int(near.sum()), 3))
        axis = g.normal(size=3)
        axis /= np.linalg.norm(axis)
        shift = g.normal(size=3)
        P = np.eye(4)
        P[:3, :3] = rotation_about(axis, 6.0)
        P[:3, 3] = 0.008 * shift / np.linalg.norm(shift)
        scene.append(dict(class_id=class_id, cad=cad, depth=depth, T_true=T,
                          T_init=T @ P))
    return scene


def icp_clouds(scene, device, voxel_size=0.01):
    """The knn call of the first ICP iteration on the scene's first object:
    ``ref`` its down-sampled CAD points, ``query`` its down-sampled depth
    points moved by the inverted start pose, each ``(1, n, 3)``."""
    from morefusion_tpu_torch.geometry import voxel_down_sample

    obj = scene[0]
    cad = voxel_down_sample(obj["cad"], voxel_size).astype(np.float32)
    depth = voxel_down_sample(obj["depth"], voxel_size)
    T = np.linalg.inv(obj["T_init"])
    moved = (depth @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return tuple(torch.from_numpy(a[None]).to(device) for a in (cad, moved))


def add_errors(scene, poses):
    """Each object's ADD and ADD-S (metres) of ``poses`` against the true
    poses, over all its CAD points, and the score the YCB-Video protocol
    takes: ADD-S for a symmetric class, ADD otherwise."""
    from morefusion_tpu_torch import metrics
    from morefusion_tpu_torch.datasets.ycb_video.class_names import (
        class_ids_symmetric,
    )

    add, add_s = metrics.average_distance(
        [obj["cad"].astype(np.float64) for obj in scene],
        [obj["T_true"] for obj in scene], list(poses))
    score = np.where(
        np.isin([obj["class_id"] for obj in scene], class_ids_symmetric),
        add_s, add)
    return dict(add=add.tolist(), add_s=add_s.tolist(),
                add_or_add_s=score.tolist())


def icc_for_scene(scene, device, V=32, max_points=2048):
    """``IterativeCollisionCheck`` on the scene from the start poses: each
    object's solid points and SDF from the procedural bank, its grid
    centred on its start pose, its own observed points as the target grid
    and the other objects' as the no-entry grid."""
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck
    from morefusion_tpu_torch.datasets import ProceduralModels

    models = ProceduralModels()
    solids = [models.get_solid_voxel_grid(obj["class_id"]) for obj in scene]
    pitch = np.array([2.4 * np.linalg.norm(obj["cad"], axis=1).max() / V
                      for obj in scene], np.float32)
    origin = np.stack([obj["T_init"][:3, 3] - p * (V / 2.0 - 0.5)
                       for obj, p in zip(scene, pitch)]).astype(np.float32)
    target = np.stack([occupancy_grid(obj["depth"], origin[i], pitch[i], V)
                       for i, obj in enumerate(scene)])
    nontarget = np.stack([
        occupancy_grid(np.concatenate(
            [o["depth"] for j, o in enumerate(scene) if j != i]),
            origin[i], pitch[i], V) for i in range(len(scene))])
    return IterativeCollisionCheck(
        [obj["T_init"] for obj in scene],
        [s.points.astype(np.float32) for s in solids],
        [s.inside_distance.astype(np.float32) for s in solids],
        pitch, origin, target, nontarget, voxel_dim=V, max_points=max_points,
        device=device)


def register_all(scene, T_start, dev):
    """``ICPRegistration.register`` on each object from ``T_start``: the
    pose, the iterations and the host ms of each."""
    from morefusion_tpu_torch.contrib import ICPRegistration

    out = []
    for obj, T in zip(scene, T_start):
        reg = ICPRegistration(obj["depth"], obj["cad"], T, device=dev)
        t0 = time.perf_counter()
        T_icp = reg.register()
        out.append((T_icp, reg.last_n_iterations,
                    (time.perf_counter() - t0) * 1e3))
    return out


def refinement_chain(scene, device, small, got):
    """ADD(-S) errors and AUC of the start poses (raw), of ICP from them
    (``got``), of ICC from them and of ICP after ICC (the rehearsal's ICC at
    a 16^3 grid of 256 points an object)."""
    from morefusion_tpu_torch import metrics

    icc = (icc_for_scene(scene, device) if not small else
           icc_for_scene(scene, device, V=16, max_points=256))
    T_icc, icc_losses, icc_n = icc.refine(iterations=30)
    got_icc = register_all(scene, T_icc, device)
    errors = dict(
        raw=add_errors(scene, [obj["T_init"] for obj in scene]),
        icp=add_errors(scene, [T for T, _, _ in got]),
        icc=add_errors(scene, T_icc),
        icc_icp=add_errors(scene, [T for T, _, _ in got_icc]))
    auc = {k: float(metrics.ycb_video_add_auc(np.asarray(v["add_or_add_s"])))
           for k, v in errors.items()}
    mean_add = {k: float(np.mean(v["add"])) for k, v in errors.items()}
    return dict(icc=dict(n_iter=icc_n, first_loss=float(icc_losses[0]),
                         best_loss=float(min(icc_losses))),
                icc_icp_n_iterations=[n for _, n, _ in got_icc],
                errors=errors, mean_add=mean_add, add_auc=auc)


def model_scenes(scenes, models, model, device, V):
    """Every view's objects as the scene pipeline's pose stage sees them:
    a fresh ``ScenePipeline`` a scene, each view's ground-truth labels
    fused and the pose node fed the fused map's occupancy grids (no ICC).
    Each object: its class, its observed points in the camera frame, its CAD
    points, the generator's pose of the instance it overlaps most, and the
    node's pose as the start."""
    from morefusion_tpu_torch.runtime import ScenePipeline

    views = []
    for frames in scenes:
        pipe = ScenePipeline(model, models, voxel_dim=V, native_mapping=True,
                             size_filter=False, device=device)
        for f in frames:
            ctx = pipe._prepare(f["rgb"], f["depth"], f["K"],
                                f["T_cam2world"], f["instance_label"],
                                f["instance_to_class"])
            poses = pipe._finish(ctx, pipe._dispatch_pose(ctx), refine=False)
            pcd, label = ctx["pcd_cam"], ctx["label"]
            finite = ~np.isnan(pcd).any(axis=2)
            view = []
            for ins, res in sorted(poses.items()):
                mask = label == ins
                gt, n = np.unique(f["instance_label"][mask],
                                  return_counts=True)
                n, gt = n[gt >= 0], gt[gt >= 0]
                check(len(gt) > 0, f"icp: fused instance {ins} covers no "
                                   f"instance of the generator")
                true_ins = int(gt[np.argmax(n)])
                check(f["instance_to_class"][true_ins] == res["class_id"],
                      f"icp: fused instance {ins} of class {res['class_id']} "
                      f"overlaps instance {true_ins} of another class")
                view.append(dict(class_id=res["class_id"],
                                 cad=models.get_pcd(res["class_id"]),
                                 depth=pcd[mask & finite].astype(np.float64),
                                 T_true=f["poses_cad2cam"][true_ins],
                                 T_init=res["T_cad2cam"]))
            views.append(view)
    return views


def model_chain(views, device, small):
    """``refinement_chain`` on each view; the ADD(-S) AUCs and mean ADDs
    over all the views' objects."""
    from morefusion_tpu_torch import metrics

    pooled = {}
    for view in filter(None, views):
        got = register_all(view, [o["T_init"] for o in view], device)
        chain = refinement_chain(view, device, small, got)
        for k, e in chain["errors"].items():
            for m, v in e.items():
                pooled.setdefault(k, {}).setdefault(m, []).extend(v)
    return dict(objects=sum(len(v) for v in views),
                objects_per_view=[len(v) for v in views],
                classes=[o["class_id"] for v in views for o in v],
                add_auc={k: float(metrics.ycb_video_add_auc(
                    np.asarray(v["add_or_add_s"])))
                    for k, v in pooled.items()},
                mean_add={k: float(np.mean(v["add"]))
                          for k, v in pooled.items()})


def phase_icp(device, small, counts, scene, models, model_scenes_frames):
    from morefusion_tpu_torch.contrib import icp

    T_init = [obj["T_init"] for obj in scene]
    register_all(scene, T_init, device)  # warm-up
    # the main path, counted
    for c in counts:
        c.launches = 0
    got = register_all(scene, T_init, device)
    launches = {c.__name__: c.launches for c in counts}
    n_iter = [n for _, n, _ in got]
    if device.type == "cuda":
        check(launches["nn_indices"] == sum(n_iter),
              f"icp: {launches['nn_indices']} knn launches for "
              f"{sum(n_iter)} iterations")
    check(all(np.isfinite(T).all() for T, _, _ in got), "icp: bad poses")

    # the card against the CPU, from the same start poses
    want = register_all(scene, T_init, "cpu")
    pose_err = max(float(np.abs(a[0] - b[0]).max())
                   for a, b in zip(got, want))
    check([n for _, n, _ in want] == n_iter,
          f"icp: iterations {n_iter} (card) vs "
          f"{[n for _, n, _ in want]} (cpu)")
    check(pose_err <= ICP_POSE_ATOL, f"icp: card and cpu poses "
                                     f"{pose_err} apart")

    # what the gated loop's host read of the RMSE costs: the same
    # iterations without it (a fixed count queued back to back)
    cad, depth = (a[0] for a in icp_clouds(scene, device))
    T0 = torch.eye(4, device=device)
    _, n0 = icp.icp_point_to_point_gated(depth, cad, T0)
    timing = {}
    for name, fn in (
            ("gated", lambda: icp.icp_point_to_point_gated(depth, cad, T0)),
            ("fixed", lambda: icp.icp_point_to_point(
                depth, cad, T0, iterations=n0))):
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        sync(device)
        timing[name] = (time.perf_counter() - t0) / 3 * 1e3 / n0

    # ICC, then ICP from its poses
    chain = refinement_chain(scene, device, small, got)
    mean_add = chain["mean_add"]
    check(mean_add["icp"] < mean_add["raw"],
          f"icp: mean ADD {mean_add['icp']} after, {mean_add['raw']} before")

    # the same chain from the occ model's poses on rendered views, in fp32
    # and in bf16: bf16's accuracy beside fp32's
    t0 = time.perf_counter()
    V = 32 if not small else 16
    model_chains = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        views = model_scenes(model_scenes_frames, models,
                             pipeline_model(small, V, dt), device, V)
        mc = model_chain(views, device, small)
        check(mc["objects"] > 0, f"icp: no pose on the views in {name}")
        check(all(np.isfinite(list(mc["add_auc"].values()))),
              f"icp: AUC of the model's {name} poses not finite")
        model_chains[name] = mc
    check(model_chains["fp32"]["classes"] == model_chains["bf16"]["classes"],
          "icp: the fp32 and bf16 passes scored other objects")
    auc_gap = {k: abs(model_chains["bf16"]["add_auc"][k] - v)
               for k, v in model_chains["fp32"]["add_auc"].items()}
    # held on the occ checkpoint; the rehearsal's seeded tiny model is no
    # trained model, its bf16 poses scatter
    check(small or all(g <= BF16_AUC_ATOL for g in auc_gap.values()),
          f"icp: bf16's AUCs {auc_gap} from fp32's, beyond {BF16_AUC_ATOL}")
    model_chains.update(scenes=len(model_scenes_frames),
                        views=sum(len(f) for f in model_scenes_frames),
                        bf16_auc_gap=auc_gap, tolerance=BF16_AUC_ATOL,
                        seconds=time.perf_counter() - t0)
    register_ms = [ms for _, _, ms in got]
    emit(dict(phase="icp", ok=True, device=str(device),
              classes=list(ICP_CLASSES),
              points=dict(cad=[len(o["cad"]) for o in scene],
                          depth=[len(o["depth"]) for o in scene]),
              n_iterations=n_iter, launches=launches,
              card_vs_cpu_pose_err=pose_err,
              tolerance=dict(pose=ICP_POSE_ATOL, n_iterations="equal"),
              register_ms=register_ms,
              ms_per_iteration=sum(register_ms) / sum(n_iter),
              first_object_ms_per_iteration=timing, **chain,
              model_poses=model_chains))
    return launches["nn_indices"]


# --------------------------------------------------------------- phase 9


def importable(name):
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def pipeline_frames(small, seed=1):
    """``bench.py``'s pipeline scene: 4 procedural objects on a plane from
    ``RandomState(seed)`` (1 in ``bench.py``), 3 views of a 5-keypoint camera path, rendered at
    240x320 with 20,000 points an object (2 objects at 120x160 and 6000
    points in the rehearsal), as stream frames with ground-truth labels and
    each instance's true pose in the camera frame."""
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.simulation import PlaneTypeSceneGeneration

    shape, n_points = ((240, 320), 20000) if not small else ((120, 160), 6000)
    models = ProceduralModels()
    gen = PlaneTypeSceneGeneration(models, n_object=4 if not small else 2,
                                   random_state=np.random.RandomState(seed))
    gen.generate()
    traj = gen.random_camera_trajectory(5, 3)
    frames = []
    for T in traj:
        f = gen.render_frame(T, shape=shape, n_points_per_object=n_points)
        frames.append(dict(
            rgb=f["rgb"].astype(np.float32), depth=f["depth"],
            K=f["intrinsic_matrix"], T_cam2world=f["T_cam2world"],
            instance_label=f["instance_label"],
            instance_to_class={int(i): int(f["class_ids"][k])
                               for k, i in enumerate(f["instance_ids"])},
            poses_cad2cam={int(i): f["Ts_cad2cam"][k]
                           for k, i in enumerate(f["instance_ids"])}))
    return models, frames


def pipeline_model(small, voxel_dim, compute_dtype=torch.float32):
    from morefusion_tpu_torch import models

    if small:
        torch.manual_seed(7)
        return models.tiny_singleview3d(21, n_point=64, with_occupancy=True,
                                        voxel_dim=voxel_dim,
                                        compute_dtype=compute_dtype)
    return serving_model(small, seed=7, compute_dtype=compute_dtype)


def fixed_draw(node, seed=1234):
    """Wrap ``node.dispatch`` so that each instance's pixels are drawn on
    the CPU, from a generator seeded with ``seed`` on each call, out of its
    crop's mask: the same pixels on every device."""
    from morefusion_tpu_torch.geometry import masks_to_bboxes
    from morefusion_tpu_torch.models.sampling import sample_mask_indices
    from morefusion_tpu_torch.runtime.pose_estimation import (
        _crop_instance_device,
    )

    dispatch = node.dispatch
    n_point = node._model.n_point

    def fed(rgb, pcd, label, inst_to_class, noentry_grids=None):
        finite = ~np.isnan(pcd).any(axis=2)
        ids, bboxes = [], []
        for ins_id in inst_to_class:
            mask = label == ins_id
            if not (mask & finite).any():
                continue
            bbox = masks_to_bboxes(mask).round().astype(int)
            if (bbox[2] - bbox[0]) * (bbox[3] - bbox[1]) == 0:
                continue
            ids.append(ins_id)
            bboxes.append(bbox)
        if not ids:
            return dispatch(rgb, pcd, label, inst_to_class, noentry_grids)
        _, pcd_c = _crop_instance_device(
            torch.from_numpy(np.clip(rgb, 0, 255).astype(np.uint8)),
            torch.from_numpy(pcd.astype(np.float32)),
            torch.from_numpy(label.astype(np.int32)), torch.tensor(ids),
            torch.from_numpy(np.stack(bboxes)), node._image_size)
        idx = sample_mask_indices(~torch.isnan(pcd_c).any(-1), n_point,
                                  torch.Generator().manual_seed(seed))
        return dispatch(rgb, pcd, label, inst_to_class, noentry_grids,
                        sample_indices=dict(zip(ids, idx.numpy())))

    node.dispatch = fed


class HostClock:
    """Host time and calls of wrapped callables, by name."""

    def __init__(self):
        self.ms, self.calls = {}, {}

    def wrap(self, name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.ms[name] = (self.ms.get(name, 0.0)
                                 + (time.perf_counter() - t0) * 1e3)
                self.calls[name] = self.calls.get(name, 0) + 1
        return timed


def record_icc(pipeline_module, problems):
    """Patch the pipeline module's ``IterativeCollisionCheck`` so that each
    ICC problem it builds is recorded, and what its refine returned."""
    base = pipeline_module.IterativeCollisionCheck

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            problems.append(dict(args=args, kw=kw))

        def resolve(self):
            out = super().resolve()
            problems[-1]["refined"] = out
            return out

    return mock.patch.object(pipeline_module, "IterativeCollisionCheck",
                             Recorded)


def run_sync_pass(models, frames, model, device, voxel_dim, n_votes):
    """One synchronous pass (``async_refine=False``) with fixed pixel
    draws: per frame the tracked labels, instance-to-class map, uint8 grids,
    spawned ids and poses; and the ICC problems it built."""
    from morefusion_tpu_torch.runtime import ScenePipeline
    from morefusion_tpu_torch.runtime import pipeline as pipeline_module

    pipe = ScenePipeline(model, models, voxel_dim=voxel_dim,
                         n_votes=n_votes, native_mapping=True,
                         size_filter=False, async_refine=False,
                         device=device)
    fixed_draw(pipe.pose_node)
    prepared = []
    prepare = pipe._prepare

    def keep(*a, **k):
        ctx = prepare(*a, **k)
        prepared.append(ctx)
        return ctx

    pipe._prepare = keep
    problems, out = [], []
    with record_icc(pipeline_module, problems):
        for f in frames:
            poses = pipe.process_frame(
                f["rgb"], f["depth"], f["K"], f["T_cam2world"],
                instance_label=f["instance_label"],
                instance_to_class=f["instance_to_class"])
            ctx = prepared[-1]
            out.append(dict(label=ctx["label"],
                            inst_to_class=ctx["inst_to_class"],
                            grids=ctx["grid_cache"],
                            spawned=sorted(pipe.object_mapping.spawned),
                            poses=poses))
    return out, problems


def compare_frames(got, want, bad):
    """Frame by frame: tracked labels, instance classes, uint8 grids and
    spawns equal, the same instances. Appends what differs to ``bad``;
    returns the largest pose difference and the largest refined-pose
    difference."""
    pose_err = 0.0
    refined_err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g["label"], w["label"]):
            bad.append(f"frame {k}: tracked labels differ")
        if g["inst_to_class"] != w["inst_to_class"]:
            bad.append(f"frame {k}: instance-to-class maps differ")
        if sorted(g["grids"]) != sorted(w["grids"]) or any(
                not np.array_equal(a, b) for i in g["grids"]
                for a, b in zip(g["grids"][i], w["grids"].get(i, ()))):
            bad.append(f"frame {k}: uint8 grids differ")
        if g["spawned"] != w["spawned"]:
            bad.append(f"frame {k}: spawned {g['spawned']} vs {w['spawned']}")
        if sorted(g["poses"]) != sorted(w["poses"]):
            bad.append(f"frame {k}: instances differ")
            continue
        for i, r in g["poses"].items():
            for key in ("T_cad2cam", "T_cad2world"):
                pose_err = max(pose_err, float(np.abs(
                    r[key] - w["poses"][i][key]).max()))
            if ("T_cad2world_refined" in r) != (
                    "T_cad2world_refined" in w["poses"][i]):
                bad.append(f"frame {k}: instance {i} refined on one side")
            elif "T_cad2world_refined" in r:
                refined_err = max(refined_err, float(np.abs(
                    r["T_cad2world_refined"]
                    - w["poses"][i]["T_cad2world_refined"]).max()))
    return pose_err, refined_err


def compare_problems(gp, wp, bad):
    """Two recorded ICC problems: start poses within the pose bound, the
    rest equal."""
    start = float(np.abs(np.stack(gp["args"][0])
                         - np.stack(wp["args"][0])).max())
    if start > PIPE_POSE_ATOL:
        bad.append(f"ICC start poses {start} apart")
    if any(not np.array_equal(x, y) for a, b in zip(
            gp["args"][1:], wp["args"][1:]) for x, y in zip(a, b)):
        bad.append("ICC problems differ")


def compare_sync_passes(got, want, got_problems, want_problems, device):
    """Card pass ``got`` against CPU pass ``want``. Returns the numbers,
    and the list of what disagreed beyond its bound."""
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck

    bad = []
    pose_err, refined_err = compare_frames(got, want, bad)
    if pose_err > PIPE_POSE_ATOL:
        bad.append(f"poses {pose_err} apart")
    # the ICC problems: start poses within the pose bound, the rest equal;
    # then each replayed for a few iterations on both devices
    replay_pose_err = replay_loss_err = 0.0
    full_err = cpu_spread = 0.0
    if len(got_problems) != len(want_problems):
        bad.append(f"{len(got_problems)} vs {len(want_problems)} refines")
    for k, (gp, wp) in enumerate(zip(got_problems, want_problems)):
        compare_problems(gp, wp, bad)
        kw = {k: v for k, v in wp["kw"].items() if k != "device"}
        T_g, l_g, n_g = IterativeCollisionCheck(
            *wp["args"], **kw, device=device).refine(
                iterations=ICC_REPLAY_ITERATIONS)
        T_w, l_w, n_w = IterativeCollisionCheck(
            *wp["args"], **kw, device="cpu").refine(
                iterations=ICC_REPLAY_ITERATIONS)
        replay_pose_err = max(replay_pose_err,
                              float(np.abs(T_g - T_w).max()))
        replay_loss_err = max(replay_loss_err,
                              float(np.abs(l_g - l_w).max()))
        if n_g != n_w:
            bad.append(f"ICC replay n_iter {n_g} vs {n_w}")
        # the pipeline's 30 iterations, against the CPU's own spread
        T_c, _, n_c = wp["refined"]
        T_g, _, n_g = IterativeCollisionCheck(
            *wp["args"], **kw, device=device).refine(
                iterations=ICC_PIPELINE_ITERATIONS)
        full_err = max(full_err, float(np.abs(T_g - T_c).max()))
        if n_g != n_c:
            bad.append(f"ICC n_iter {n_g} vs {n_c}")
        rng = np.random.RandomState(k)
        for _ in range(ICC_JITTER_RUNS):
            starts = [np.array(T) for T in wp["args"][0]]
            for T in starts:
                T[:3, 3] += rng.normal(0, ICC_START_JITTER, 3)
            T_j, _, _ = IterativeCollisionCheck(
                starts, *wp["args"][1:], **kw, device="cpu").refine(
                    iterations=ICC_PIPELINE_ITERATIONS)
            cpu_spread = max(cpu_spread, float(np.abs(T_j - T_c).max()))
    if replay_pose_err > PIPE_POSE_ATOL or replay_loss_err > ICC_LOSS_ATOL:
        bad.append(f"ICC replay poses {replay_pose_err}, losses "
                   f"{replay_loss_err} apart")
    if full_err > cpu_spread:
        bad.append(f"ICC over {ICC_PIPELINE_ITERATIONS} iterations: card "
                   f"{full_err} from the CPU, beyond the CPU's own spread "
                   f"{cpu_spread}")
    numbers = dict(max_pose_err=pose_err,
                   icc_replay=dict(iterations=ICC_REPLAY_ITERATIONS,
                                   max_pose_err=replay_pose_err,
                                   max_loss_err=replay_loss_err),
                   icc_full=dict(iterations=ICC_PIPELINE_ITERATIONS,
                                 max_pose_err=full_err,
                                 cpu_jitter_spread=cpu_spread,
                                 jitter=ICC_START_JITTER,
                                 jitter_runs=ICC_JITTER_RUNS),
                   refined_30_iterations_max_diff=refined_err,
                   refines=len(got_problems))
    return numbers, bad


def timed_stream(pipe, frames, counts, device, n_timed, segment=False):
    """``process_stream`` over ``n_timed`` frames (the frames in turn),
    ending in ``flush_refine``: fps, the host ms per frame of each stage
    (with ``segment``, the segmenter's share taken out of ``prepare``), the
    kernels' launches, refines and spawns."""
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck
    from morefusion_tpu_torch.runtime import pipeline as pipeline_module

    clock = HostClock()
    saved = {k: getattr(pipe, k) for k in ("_prepare", "_dispatch_pose",
                                           "_segmenter")}
    pipe._prepare = clock.wrap("prepare", pipe._prepare)
    pipe._dispatch_pose = clock.wrap("pose_dispatch", pipe._dispatch_pose)
    if segment:
        pipe._segmenter = clock.wrap("segment", pipe._segmenter)
    resolve = pipe.pose_node.resolve
    pipe.pose_node.resolve = clock.wrap("pose_resolve", resolve)
    timed_cls = type("Timed", (IterativeCollisionCheck,), dict(
        refine_async=clock.wrap("icc_dispatch",
                                IterativeCollisionCheck.refine_async),
        resolve=clock.wrap("icc_resolve", IterativeCollisionCheck.resolve)))
    stream = (frames[k % len(frames)] for k in range(n_timed))
    sync(device)
    try:
        with mock.patch.object(pipeline_module, "IterativeCollisionCheck",
                               timed_cls):
            for c in counts:
                c.launches = 0
            t0 = time.perf_counter()
            n_results = 0
            for out in pipe.process_stream(stream):
                n_results += len(out)
            pipe.flush_refine()
            wall = time.perf_counter() - t0
            launches = {c.__name__: c.launches for c in counts}
    finally:
        for k, v in saved.items():
            setattr(pipe, k, v)
        pipe.pose_node.resolve = resolve
    split = {k: v / n_timed for k, v in clock.ms.items()}
    if segment:
        split["prepare"] -= split["segment"]
    split["rest"] = wall * 1e3 / n_timed - sum(split.values())
    return dict(scene_pipeline_fps=n_timed / wall, wall_s=wall,
                timed_frames=n_timed, split_ms_per_frame=split,
                results=n_results, spawned=len(pipe.object_mapping.spawned),
                refines=clock.calls.get("icc_dispatch", 0),
                launches=launches,
                min_dist_per_frame=launches["min_dist_voxels"] / n_timed)


def warm_pipeline(make, frames, replays, warmup_buckets=None):
    """bench.py's n_votes=3 pipeline, warmed up and replayed; where no
    track spawns at n_votes=3 over these frames (and so ICC never runs),
    the same at n_votes=1. Returns the pipeline and its n_votes."""
    for n_votes in (3, 1):
        pipe = make(n_votes)
        if warmup_buckets:
            pipe.warmup(warmup_buckets)
        for _ in range(replays):
            for _out in pipe.process_stream(iter(frames)):
                pass
            spawned = len(pipe.object_mapping.spawned)
            pipe.reset()
        if spawned:
            break
    return pipe, n_votes


def check_timed_pass(run, what, device):
    check(run["refines"] > 0, f"{what}: no ICC refine ran")
    if device.type == "cuda":
        n = run["launches"]["min_dist_voxels"]
        check(n > 0, f"{what}: the min_dist kernel was never launched")
        check(n == 30 * run["refines"],
              f"{what}: {n} min_dist launches for {run['refines']} refines "
              f"of 30 iterations")


def phase_pipeline(device, small, counts, models, frames, frames_s,
                   native_build):
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck
    from morefusion_tpu_torch.runtime import ScenePipeline

    imports = {name: importable(name)
               for name in ("cv2", "scipy", "sklearn", "imageio")}
    V = 32 if not small else 16
    model = pipeline_model(small, V)
    n_timed = 12 if not small else 2
    replays = 2 if not small else 1

    def make(n_votes, pose_model=model, **kw):
        return ScenePipeline(pose_model, models, voxel_dim=V,
                             n_votes=n_votes, native_mapping=True,
                             size_filter=False, device=device, **kw)

    pipe, n_votes = warm_pipeline(
        lambda n: make(n, async_refine=True), frames, replays,
        (1, 2, 4, 8) if not small else (2,))
    # the timed pass: the main path, counted and split by stage
    run = timed_stream(pipe, frames, counts, device, n_timed)
    # bench.py's default: the same pass with the model in bf16
    model16 = pipeline_model(small, V, torch.bfloat16)
    pipe16, n_votes16 = warm_pipeline(
        lambda n: make(n, pose_model=model16, async_refine=True), frames,
        replays)
    run16 = timed_stream(pipe16, frames, counts, device, n_timed)
    del pipe16

    # the card against the CPU: one synchronous pass each, deterministic
    # (warn_only: the pose network's forward may reach an op with no
    # deterministic CUDA version; ICC's index_add_ has one)
    sync_frames = frames[:3] if not small else frames[:2]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got, got_problems = run_sync_pass(models, sync_frames, model, device,
                                          V, n_votes)
        cpu_model = pipeline_model(small, V)
        want, want_problems = run_sync_pass(models, sync_frames, cpu_model,
                                            "cpu", V, n_votes)
        cpu_vs_card, bad = compare_sync_passes(
            got, want, got_problems, want_problems, device)
    finally:
        torch.use_deterministic_algorithms(False)

    # refine_async queues the loop without a synchronising call
    sync_calls = None
    if device.type == "cuda" and got_problems:
        p = got_problems[-1]
        icc = IterativeCollisionCheck(*p["args"], **p["kw"])
        sync(device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                icc.refine_async()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        icc.resolve()
        # enabling the mode itself warns that it is a prototype
        sync_calls = [str(w.message) for w in caught
                      if "called a synchronizing" in str(w.message)]

    # with ICP: one pass over the compared frames, its knn launches counted
    icp_pipe = make(n_votes, async_refine=True, with_icp=True)
    for c in counts:
        c.launches = 0
    for _out in icp_pipe.process_stream(iter(sync_frames)):
        pass
    icp_pipe.flush_refine()
    icp_launches = {c.__name__: c.launches for c in counts}

    emit(dict(phase="pipeline", ok=not bad, device=str(device),
              frame=list(frames[0]["depth"].shape),
              objects=len(frames[0]["instance_to_class"]),
              n_votes=n_votes,
              n_votes_note=None if n_votes == 3 else
              "no track spawned at n_votes=3 over these frames",
              native_mapping=native_build,
              imports=imports, frames_s=frames_s, **run,
              bf16=dict(n_votes=n_votes16, **run16),
              refine_async_sync_warnings=sync_calls,
              card_vs_cpu=cpu_vs_card,
              tolerance=dict(pose=PIPE_POSE_ATOL, icc_loss=ICC_LOSS_ATOL,
                             labels_grids_spawns="identical"),
              with_icp=dict(launches=icp_launches)))
    check(not bad, "pipeline card vs cpu: " + "; ".join(bad))
    check_timed_pass(run, "pipeline", device)
    check_timed_pass(run16, "pipeline in bf16", device)
    if device.type == "cuda":
        check(icp_launches["nn_indices"] > 0,
              "pipeline with ICP: the knn kernel was never launched")
        check(not sync_calls,
              f"refine_async synchronised: {sync_calls}")
    return (run["launches"]["min_dist_voxels"],
            run16["launches"]["min_dist_voxels"],
            icp_launches["nn_indices"], model16)


# -------------------------------------------------------------- phase 10


def host_timed(fn, reps, device):
    """Mean host ms of ``fn`` over ``reps`` calls, the card synchronised
    around them, and the last result."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps, out


def generator_class_map(frame):
    """The generator's class map of a frame (0 = background) and its
    instance boundaries (``boundary_from_instance_label``)."""
    from morefusion_tpu_torch.models.segmentation import (
        boundary_from_instance_label,
    )

    label = frame["instance_label"]
    class_map = np.zeros(label.shape, np.int32)
    for ins, cid in frame["instance_to_class"].items():
        class_map[label == ins] = cid
    return class_map, boundary_from_instance_label(label)


def phase_segmenter(device, small, counts, models, frames, pose_model):
    from morefusion_tpu_torch.models.segmentation import (
        SegmentationNode,
        UNetSegmentation,
        instances_from_predictions,
        merge_occlusion_splits,
    )
    from morefusion_tpu_torch.ops import connected_components
    from morefusion_tpu_torch.ops import relabel_components
    from morefusion_tpu_torch.runtime import ScenePipeline

    torch.manual_seed(21)
    unet = UNetSegmentation(n_class=SEG_N_CLASS, widths=SEG_WIDTHS,
                            with_boundary=True, use_depth=False).eval()
    cpu_unet = UNetSegmentation(n_class=SEG_N_CLASS, widths=SEG_WIDTHS,
                                with_boundary=True, use_depth=False).eval()
    cpu_unet.load_state_dict(unet.state_dict())
    node = SegmentationNode(unet, device=device)
    rgb = frames[0]["rgb"]
    H, W = rgb.shape[:2]

    # (a) the UNet, card against CPU
    x = torch.from_numpy(rgb[None])
    with torch.inference_mode():
        logits, blog = unet(x.to(device))
        want_logits, want_blog = cpu_unet(x)
    logit_err = max(float((logits.cpu() - want_logits).abs().max()),
                    float((blog.cpu() - want_blog).abs().max()))
    argmax_agree = float((logits.argmax(1).cpu() == want_logits.argmax(1))
                         .double().mean())
    check(logit_err <= SEG_LOGIT_ATOL,
          f"segmenter: UNet logits card vs CPU {logit_err} apart")

    # (b) connected components, card against CPU, on the generator's class
    # map with its instance boundaries
    cm, bnd = generator_class_map(frames[0])
    args = (torch.from_numpy(cm), torch.from_numpy(bnd))
    comp, stats = connected_components(*(a.to(device) for a in args),
                                       return_stats=True)
    want_comp, want_stats = connected_components(*args, return_stats=True)
    n_diff = int((comp.cpu() != want_comp).sum())
    check(n_diff == 0, f"segmenter: {n_diff} component keys differ")
    check(stats == want_stats,
          f"segmenter: propagation {stats} (card) vs {want_stats} (cpu)")
    n_components = len(np.unique(want_comp.numpy())) - 1
    # the same cut by max_iters inside a chunk of host reads: the keys of
    # a propagation stopped short, so the step count must be exact
    check(stats["iterations"][0] > SEG_CUT_ITERS,
          f"segmenter: the generator's map converges in {stats} steps, "
          f"no cut at {SEG_CUT_ITERS}")
    cut, cut_stats = connected_components(
        *(a.to(device) for a in args), max_iters=SEG_CUT_ITERS,
        return_stats=True)
    want_cut, want_cut_stats = connected_components(
        *args, max_iters=SEG_CUT_ITERS, return_stats=True)
    cut_diff = int((cut.cpu() != want_cut).sum())
    check(cut_diff == 0 and cut_stats == want_cut_stats,
          f"segmenter: cut at {SEG_CUT_ITERS} steps, {cut_diff} keys "
          f"differ, propagation {cut_stats} (card) vs {want_cut_stats} (cpu)")

    # (c) timing: each stage, then one whole node call
    reps = 20 if not small else 2
    with torch.inference_mode():
        x_dev = x.to(device)
        forward_ms = (cuda_ms(lambda: unet(x_dev), reps)
                      if device.type == "cuda" else None)
        forward_host_ms, _ = host_timed(lambda: unet(x_dev), reps, device)
        gen_cc_ms, _ = host_timed(
            lambda: connected_components(*(a.to(device) for a in args)),
            reps, device)
    # the components on the UNet's own map, card against CPU on the same
    # input: on the card both propagations stop at the 256-step cap
    # (connected_components' max_iters), so the keys hold the cut there
    unet_map, (class_map, boundary, unet_comp) = components_on_map(
        unet, rgb, device, reps, "segmenter: UNet map")
    cc_ms, unet_diff = unet_map["ms"], unet_map["keys_differing"]
    unet_stats = unet_map["propagation"]
    if not small:
        check(unet_stats["iterations"] == [256, 256],
              f"segmenter: the UNet map's propagation {unet_stats} does not "
              f"reach the cap, which this check is for")
    cc_profile = None
    if device.type == "cuda":
        cc_profile = profile_calls(
            lambda: connected_components(class_map, boundary), device, 2)
        cc_profile["kernels_per_step"] = (cc_profile["kernels_per_call"]
                                          / sum(unet_stats["iterations"]))
    cm_host, comp_host = class_map.cpu().numpy(), unet_comp.cpu().numpy()
    relabel_ms, (label, classes) = host_timed(
        lambda: relabel_components(comp_host, cm_host), reps, device)
    merge_ms, _ = host_timed(
        lambda: merge_occlusion_splits(label, classes, cm_host), reps,
        device)
    node(rgb)
    node_ms, (label, classes) = host_timed(lambda: node(rgb), reps, device)
    # the cv2 oracle on the same class map and boundary, and a whole node
    # call in that mode (the class map and boundary read to the host)
    bnd_host = boundary.cpu().numpy()
    cv2_ms, _ = host_timed(
        lambda: instances_from_predictions(cm_host, bnd_host), reps, device)
    cv2_node = SegmentationNode(unet, device_instancing=False, device=device)
    cv2_node(rgb)
    cv2_node_ms, _ = host_timed(lambda: cv2_node(rgb), reps, device)

    # (d) the scene pipeline on the segmenter's instances (no labels given),
    # the pose model in bf16 as bench.py --segmenter serves it
    V = 32 if not small else 16
    seg_frames = [{k: f[k] for k in ("rgb", "depth", "K", "T_cam2world")}
                  for f in frames]

    def make(n_votes):
        return ScenePipeline(pose_model, models, segmenter=node,
                             voxel_dim=V, n_votes=n_votes,
                             native_mapping=True, size_filter=False,
                             async_refine=True, device=device)

    pipe, n_votes = warm_pipeline(make, seg_frames, 1)
    run = timed_stream(pipe, seg_frames, counts, device,
                       6 if not small else 2, segment=True)
    emit(dict(phase="segmenter", ok=True, device=str(device), frame=[H, W],
              n_class=SEG_N_CLASS, widths=list(SEG_WIDTHS),
              with_boundary=True, use_depth=False, weights="seeded",
              unet_card_vs_cpu=dict(max_abs_err=logit_err,
                                    argmax_agreement=argmax_agree,
                                    tolerance=SEG_LOGIT_ATOL),
              components_card_vs_cpu=dict(
                  keys_differing=n_diff, components=n_components,
                  propagation=stats, identical=True,
                  cut=dict(max_iters=SEG_CUT_ITERS, keys_differing=cut_diff,
                           propagation=cut_stats),
                  unet_map=dict(keys_differing=unet_diff,
                                propagation=unet_stats)),
              ms=dict(forward_cuda=forward_ms, forward_host=forward_host_ms,
                      components=cc_ms, components_generator_map=gen_cc_ms,
                      relabel=relabel_ms, merge=merge_ms, node_call=node_ms,
                      cv2_instancing=cv2_ms, node_call_cv2=cv2_node_ms),
              unet_components=dict(propagation=unet_stats,
                                   instances=len(classes),
                                   profile=cc_profile),
              pipeline=dict(n_votes=n_votes,
                            n_votes_note=None if n_votes == 3 else
                            "no track spawned at n_votes=3 over these frames",
                            pose_model="bf16", **run)))
    check_timed_pass(run, "pipeline with the segmenter", device)
    return run["launches"]["min_dist_voxels"]


# -------------------------------------------------------------- phase 11


def fit_data(root, small):
    """Packed train and val sets of the port's generator (``reindex`` in
    forked workers, then ``pack_reindexed``), made before anything runs on
    the card or in OpenMP: the workers run NumPy and the C++ mapping only.
    Fails when the train set gives fewer than ``FIT_MIN_TRAIN_BATCHES``
    batches after the visibility filter, or the val set no whole batch."""
    from morefusion_tpu_torch import datasets

    cfg = FIT_SMALL if small else FIT_FULL
    t0 = time.perf_counter()
    n_workers = min(os.cpu_count() or 1, 4 if small else 16)
    out = dict(shape=cfg["shape"], n_objects=FIT_OBJECTS,
               n_workers=n_workers)
    for split in ("train", "val"):
        src = datasets.SyntheticRGBDPoseEstimationDataset(
            split=split, n_frames=cfg[f"{split}_frames"],
            n_objects=FIT_OBJECTS, image_shape=cfg["shape"])
        reindexed = os.path.join(root, f"{split}_reindexed")
        datasets.reindex(reindexed, [src], n_workers=n_workers,
                         progress=False)
        datasets.pack_reindexed(reindexed, os.path.join(root, split),
                                progress=False)
        out[f"{split}_frames"] = cfg[f"{split}_frames"]
    train = datasets.PackedPoseDataset(os.path.join(root, "train"),
                                       min_visibility=FIT_MIN_VISIBILITY)
    val = datasets.PackedPoseDataset(os.path.join(root, "val"))
    out.update(train_crops=len(train), val_crops=len(val),
               train_crops_all=len(datasets.PackedPoseDataset(
                   os.path.join(root, "train"))),
               data_s=time.perf_counter() - t0)
    check(len(train) >= FIT_MIN_TRAIN_BATCHES * cfg["batch"],
          f"fit data: {len(train)} train crops at visibility >= "
          f"{FIT_MIN_VISIBILITY}, fewer than {FIT_MIN_TRAIN_BATCHES} "
          f"batches of {cfg['batch']}")
    check(len(val) >= cfg["val_batch"],
          f"fit data: {len(val)} val crops, no batch of {cfg['val_batch']}")
    return out


def run_cli(argv, spy=None, keep=None):
    """``cli.train.main(argv)`` -> (state, summary); with ``spy`` a list,
    each train step's (step, use_symmetric) is appended to it; with
    ``keep`` a dict, it holds the loop's train step and its last batch."""
    from morefusion_tpu_torch.cli import train as cli
    from morefusion_tpu_torch.training import loop

    if spy is None:
        return cli.main(argv)
    real = loop.make_dp_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def spied(state, batch, use_symmetric, seed=0):
            spy.append((state.step, bool(use_symmetric)))
            if keep is not None:
                keep.update(step=step, batch=batch, seed=seed)
            return step(state, batch, use_symmetric, seed=seed)

        return spied

    with mock.patch.object(loop, "make_dp_train_step", make):
        return cli.main(argv)


def loop_step_yardstick(keep, state):
    """Host ms of ``FIT_BARE_STEPS`` calls of the loop's own train step
    (the device augmentation on) on its last batch, already on the card,
    after one warm-up call, for each ``use_symmetric``; each call reads its
    metrics back as the loop does at ``--log-interval 1``. So it does the
    loop's work without the loop: no loader, no copy, no log."""
    out = {}
    for sym in (False, True):
        ms = []
        for i in range(FIT_BARE_STEPS + 1):
            t0 = time.perf_counter()
            _, metrics = keep["step"](state, keep["batch"], sym,
                                      seed=keep["seed"])
            _ = {k: float(v) for k, v in metrics.items()}
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        out["symmetric" if sym else "add"] = ms
    return out


def read_json(path):
    with open(path) as f:
        return json.load(f)


def median(xs):
    return float(np.median(xs)) if len(xs) else None


def latest_weights(run_dir):
    ckpt = torch.load(os.path.join(run_dir, "snapshot_trainer_latest"),
                      map_location="cpu", weights_only=True)
    return ckpt["step"], ckpt["model"]


def compare_updates(got, want, before, what):
    """Two runs' weights after one step from the same ``before``: each
    parameter's update within phase 6's ``STEP_GRAD_RTOL`` of its own norm
    plus ``STEP_GRAD_TOTAL`` of the whole update's norm."""
    du = {k: want[k].double() - before[k].double() for k in want}
    total = float(torch.sqrt(sum((d ** 2).sum() for d in du.values())))
    worst = 0.0
    for k, d in du.items():
        err = float((got[k].double() - want[k].double()).norm())
        bound = STEP_GRAD_RTOL * float(d.norm()) + STEP_GRAD_TOTAL * total
        worst = max(worst, err / bound if bound > 0 else float(err > 0))
        check(err <= bound, f"{what}: weights of {k} off by {err} "
                            f"(update {float(d.norm())}, whole {total})")
    check(total > 0, f"{what}: the step changed no weight")
    return dict(update_norm=total, max_err_over_tolerance=worst)


def phase_fit(device, small, counts, data, root, bare_step_ms):
    """The train CLI on the packed sets: run A (fp32, the committed occ
    recipe: two epochs with an evaluation after each, then a resume), run B
    (bf16, the ``+occupancy`` loss, three steps), and one step of a resumed
    run with the kernels against the plain versions."""
    import shutil

    from morefusion_tpu_torch.models import convert_jax
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md

    cfg = FIT_SMALL if small else FIT_FULL
    common = ["--data", os.path.join(root, "train"), "--val-data",
              os.path.join(root, "val"), "--with-occupancy",
              "--batch-size", str(cfg["batch"]), "--val-batch-size",
              str(cfg["val_batch"]), "--device", device.type,
              "--min-visibility", str(FIT_MIN_VISIBILITY)]
    if small:
        common += ["--tiny", "--n-point", "64"]

    def counted(argv, spy=None, keep=None):
        for c in counts:
            c.launches = 0
        out = run_cli(common + argv, spy, keep)
        return out, {c.__name__: c.launches for c in counts}

    # run A: the committed occ recipe, then a resume by two steps
    run_a = os.path.join(root, "run_a")
    calls, keep = [], {}
    t0 = time.perf_counter()
    (state, summary), launches_a = counted(
        ["--out", run_a, "--loss", "add/add_s", "--epochs", "2",
         "--eval-interval", "1.0", "--log-interval", "1"], calls, keep)
    run_a_s = time.perf_counter() - t0
    spe = read_json(os.path.join(run_a, "timing.json"))["steps_per_epoch"]
    check(spe >= FIT_MIN_TRAIN_BATCHES, f"fit: {spe} steps an epoch")
    check(state.step == 2 * spe, f"fit: run A ended at step {state.step}")
    check(calls == [(s, s >= spe) for s in range(2 * spe)],
          f"fit: the add -> add/add_s switch is not at step {spe}: {calls}")
    auc = summary.get("main/add_or_add_s/auc")
    check(auc is not None and np.isfinite(auc), f"fit: summary {summary}")
    log_a = read_json(os.path.join(run_a, "log.json"))
    evals = [r["iteration"] for r in log_a if "main/add_or_add_s/auc" in r]
    check(evals == [spe, 2 * spe], f"fit: evaluations at {evals}")
    timing = read_json(os.path.join(run_a, "timing.json"))
    check(len(timing.get("pack_ms", [])) >= 2 * spe,
          "fit: run A did not ship its batches in the transfer form")
    names = ["snapshot_trainer_latest"] + [
        f"snapshot_model_best_validation_main_{m}{ext}"
        for m in ("add_or_add_s", "auc") for ext in ("", ".npz")]
    for name in names:
        check(os.path.isfile(os.path.join(run_a, name)), f"fit: no {name}")
    best = os.path.join(run_a, "snapshot_model_best_validation_main_auc")
    exported = convert_jax.params_from_jax(
        convert_jax.load_jax_npz(best + ".npz"))
    snapshot = torch.load(best, map_location="cpu", weights_only=True)
    check(sorted(exported) == sorted(snapshot), "fit: npz keys")
    for k, v in snapshot.items():
        check(torch.equal(exported[k], v.to(torch.bfloat16).float()),
              f"fit: the archive's {k} is not the snapshot rounded to bf16")
    # run A's files are written: its state may take the yardstick's steps
    steps_a = state.step
    yardstick_ms = loop_step_yardstick(keep, state)
    del keep, state

    (state_r, _), launches_r = counted(
        ["--out", run_a, "--loss", "add/add_s", "--epochs", "2",
         "--eval-interval", "1.0", "--log-interval", "1", "--resume",
         "--max-steps", str(2 * spe + 2)])
    check(state_r.step == 2 * spe + 2,
          f"fit: the resume ended at step {state_r.step}")
    log_r = read_json(os.path.join(run_a, "log.json"))
    check(log_r[:len(log_a)] == log_a and len(log_r) == len(log_a) + 2,
          "fit: the resume did not keep log.json's rows")
    fit_launches = {k: launches_a[k] + launches_r[k] for k in launches_a}

    # run B: bf16 with the occupancy term (min_dist in the step), an
    # evaluation after each step (knn)
    run_b = os.path.join(root, "run_b")
    (state_b, summary_b), launches_b = counted(
        ["--out", run_b, "--bf16", "--loss", "add/add_s+occupancy",
         "--max-steps", "3", "--eval-interval", "0.01",
         "--log-interval", "1"])
    check(state_b.step == 3, f"fit bf16: ended at step {state_b.step}")
    log_b = read_json(os.path.join(run_b, "log.json"))
    losses_b = [r["main/loss"] for r in log_b if "main/loss" in r]
    check(len(losses_b) == 3 and np.isfinite(losses_b).all()
          and all(r["main/loss_occupancy"] != 0 for r in log_b
                  if "main/loss" in r), f"fit bf16: losses {log_b}")
    if device.type == "cuda":
        for name, launches in (("fit", fit_launches),
                               ("fit_bf16", launches_b)):
            for k in (("nn_indices",) if name == "fit" else
                      ("nn_indices", "min_dist_voxels")):
                check(launches[k] > 0, f"{name}: no {k} launch")

    # kernel against plain: one step of run A resumed, +occupancy and
    # add/add_s on, in deterministic mode
    step0, before = latest_weights(run_a)
    one = ["--loss", "add/add_s+occupancy", "--epochs", "2",
           "--eval-interval", "1000", "--log-interval", "1", "--resume",
           "--max-steps", str(step0 + 1)]
    results = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for which in ("kernel", "plain"):
                out = os.path.join(root, f"step_{which}")
                shutil.copytree(run_a, out)
                if which == "kernel":
                    run_cli(common + ["--out", out] + one)
                else:
                    with mock.patch.object(md, "min_dist_voxels",
                                           md.min_dist_voxels_plain), \
                            mock.patch.object(knn, "nn_indices",
                                              knn.nn_indices_plain):
                        run_cli(common + ["--out", out] + one)
                row = read_json(os.path.join(out, "log.json"))[-1]
                results[which] = (row, latest_weights(out))
    finally:
        torch.use_deterministic_algorithms(False)
    (row_k, (step_k, w_k)), (row_p, (step_p, w_p)) = (results["kernel"],
                                                      results["plain"])
    check(step_k == step_p == step0 + 1 and step0 >= spe,
          f"fit kernel vs plain: steps {step0} -> {step_k}, {step_p}")
    loss_err = max(abs(row_k[k] - row_p[k]) / max(abs(row_p[k]), 1e-12)
                   for k in ("main/loss", "main/loss_add",
                             "main/loss_occupancy"))
    check(loss_err <= STEP_LOSS_RTOL,
          f"fit kernel vs plain: losses {row_k} vs {row_p}")
    vs_plain = dict(loss_rel_err=loss_err, loss=row_k["main/loss"],
                    **compare_updates(w_k, w_p, before,
                                      "fit kernel vs plain"))

    sps_window = [r["main/sps_window"] for r in log_a if "main/sps" in r]
    # a window right after an evaluation (or the start) restarts the
    # loader: the steady windows are the others. Row i holds step i - 1,
    # which uses add/add_s from step spe on.
    steady = {"add": [], "symmetric": []}
    for r in log_a:
        if "main/sps" in r and r["iteration"] % spe != 1:
            sym = r["iteration"] - 1 >= spe
            steady["symmetric" if sym else "add"].append(
                1e3 / r["main/sps_window"])
    loop_vs_bare = {
        k: dict(loop_step_ms=steady[k], bare_step_ms=yardstick_ms[k],
                loop_median_ms=median(steady[k]),
                bare_median_ms=median(yardstick_ms[k]),
                bare_spread_ms=(max(yardstick_ms[k]) - min(yardstick_ms[k])),
                loop_minus_bare_ms=(median(steady[k])
                                    - median(yardstick_ms[k])
                                    if steady[k] else None))
        for k in steady}
    emit(dict(
        phase="fit", ok=True, device=str(device), data=data,
        model="tiny" if small else "SingleView3D occ, full width, fp32",
        batch=cfg["batch"], val_batch=cfg["val_batch"],
        steps_per_epoch=spe,
        run_a=dict(
            steps=steps_a, run_s=run_a_s, resumed_to=state_r.step,
            use_symmetric_from_step=spe,
            sps=[r["main/sps"] for r in log_a if "main/sps" in r],
            sps_window=sps_window,
            sps_window_median_steady=median(
                [r["main/sps_window"] for r in log_a if "main/sps" in r
                 and r["iteration"] % spe != 1]),
            loop_vs_bare_step=loop_vs_bare,
            bare_step_ms_phase6=bare_step_ms,
            bare_step_rate_phase6=(1e3 / bare_step_ms
                                   if bare_step_ms else None),
            host_prep_ms=median(timing["host_prep_ms"]),
            copy_ms=median(timing["copy_ms"]),
            pack_ms=median(timing["pack_ms"]),
            batch_bytes=timing["batch_bytes"],
            wait_ms=median(timing["wait_ms"]),
            wait_ms_each=timing["wait_ms"],
            eval_ms_per_batch=median(timing["eval_ms_per_batch"]),
            save_latest_ms=median(timing["save_latest_ms"]),
            save_best_ms=median(timing["save_best_ms"]),
            losses=[r["main/loss"] for r in log_a if "main/loss" in r],
            auc=auc,
            summary={k: v for k, v in summary.items()
                     if k.count("/") <= 2}),
        run_b=dict(steps=state_b.step, losses=losses_b,
                   auc=summary_b.get("main/add_or_add_s/auc")),
        kernel_vs_plain=vs_plain,
        tolerance=dict(loss_rtol=STEP_LOSS_RTOL,
                       update_rtol=STEP_GRAD_RTOL,
                       update_of_whole=STEP_GRAD_TOTAL),
        launches=dict(fit=fit_launches, fit_bf16=launches_b)))
    return fit_launches, launches_b


# -------------------------------------------------------------- phase 12

# the evaluation (phase 12): phase 11's packed val set; the committed occ
# and noocc checkpoints with their args as run directories
EVAL_RUNS = ("occ", "noocc")
EVAL_SWEEP = ("occ:observed", "occ:nontarget_full", "occ:full_bg",
              "noocc:observed")
EVAL_METHODS = ("morefusion", "morefusion+icp", "morefusion+icc",
                "morefusion+icc+icp")
# the exact mode's and scale 2's runs check those modes' paths and
# launches on the first mode_examples crops; the default run scores all
EVAL_FULL = dict(n_examples=None, mode_examples=24, scale3_examples=12,
                 iterations=30,
                 cpu_examples=8, n_boot=200)
EVAL_SMALL = dict(n_examples=4, mode_examples=None, scale3_examples=None,
                  iterations=2,
                  cpu_examples=2, n_boot=20, icc_points=128)


def eval_runs(root, small, names=EVAL_RUNS):
    """Run directories of ``args.json`` and the best archive: the committed
    checkpoints ``names`` (seeded tiny models in the rehearsal)."""
    from morefusion_tpu_torch import models
    from morefusion_tpu_torch.training import export_params_npz

    best = "snapshot_model_best_validation_main_auc.npz"
    for name in names:
        run = os.path.join(root, name)
        os.makedirs(run)
        if small:
            occupancy = name != "noocc"
            torch.manual_seed(len(name))
            export_params_npz(models.tiny_singleview3d(
                21, n_point=64, with_occupancy=occupancy),
                os.path.join(run, best))
            args = dict(tiny=True, n_point=64, with_occupancy=occupancy,
                        loss="add/add_s")
        else:
            src = os.path.join(ROOT, "docs", "results", name)
            os.symlink(src + "_best_bf16.npz", os.path.join(run, best))
            args = read_json(src + "_args.json")
        with open(os.path.join(run, "args.json"), "w") as f:
            json.dump(args, f)
    return root


class ShapeRecorder:
    """Counts each kernel wrapper's calls by shape while it is active (ICP's
    knn calls, whose shapes are each object's clouds, as one entry). The
    wrappers count their launches in an attribute of their module's name,
    which points at the recorder meanwhile: on exit the recorder hands its
    count to the wrapper."""

    def __init__(self):
        from morefusion_tpu_torch.ops import knn
        from morefusion_tpu_torch.ops import min_dist as md

        self.shapes = {"min_dist_voxels": {}, "nn_indices": {}}
        self._targets = ((md, "min_dist_voxels", lambda ip, v, p, dims, *a:
                          f"B={ip.shape[0]} P={ip.shape[1]} "
                          f"V={'x'.join(map(str, dims))}"),
                         (knn, "nn_indices", lambda ref, query, *a, **k:
                          f"B={ref.shape[0]} R={ref.shape[1]} "
                          f"Q={query.shape[1]}" if ref.shape[0] > 1
                          else "B=1 (ICP, one object's clouds)"))
        self._patches = []

    def __enter__(self):
        for module, name, key in self._targets:
            real = getattr(module, name)
            shapes = self.shapes[name]

            def recorder(*a, _real=real, _key=key, _shapes=shapes, **k):
                s = _key(*a, **k)
                _shapes[s] = _shapes.get(s, 0) + 1
                return _real(*a, **k)

            recorder.launches = 0
            patch = mock.patch.object(module, name, recorder)
            patch.start()
            self._patches.append((patch, real, recorder))
        return self

    def __exit__(self, *exc):
        for patch, real, recorder in self._patches:
            patch.stop()
            real.launches += recorder.launches
        self._patches = []


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept: ``(result, lines)``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def fixed_sampling(mask, n_point, generator=None):
    """The model's point draw with its scores drawn on the CPU from a
    seeded generator, so that the card and the CPU sample the same
    pixels."""
    B, H, W = mask.shape
    flat = mask.reshape(B, H * W)
    scores = torch.rand((B, H * W), generator=torch.Generator().manual_seed(
        1234)).to(mask.device)
    scores = torch.where(flat, scores, float("-inf"))
    idx = torch.topk(scores, n_point, dim=1).indices
    n_valid = flat.sum(dim=1, keepdim=True).clamp_min(1)
    slot = torch.arange(n_point, device=mask.device)[None, :]
    return torch.gather(idx, 1, torch.where(slot < n_valid, slot,
                                            slot % n_valid))


def evaluate_run(device, counts, argv):
    """``cli.evaluate.main(argv)`` on the card, counted: its summary, info,
    launches and shapes, peak memory and stdout."""
    from morefusion_tpu_torch.cli import evaluate

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for c in counts:
        c.launches = 0
    with ShapeRecorder() as rec:
        t0 = time.perf_counter()
        (summary, records, info), lines = quiet(
            evaluate.main, argv + ["--device", device.type])
        wall_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counts}
    n_frames = info.get("n_frames")
    row = dict(
        argv=argv, wall_s=wall_s, n_examples=info["n_examples"],
        n_frames=n_frames,
        refine_frames_per_s=(n_frames / info["refine_s"]
                             if n_frames else None),
        icc_ms_per_frame=(info["icc_s"] / n_frames * 1e3
                          if n_frames else None),
        icp_ms_per_frame=(info["icp_s"] / n_frames * 1e3
                          if n_frames else None),
        launches=launches, shapes=rec.shapes,
        max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        auc={m: dict(add_or_add_s=s["main/add_or_add_s/auc"],
                     add_s=s["main/add_s/auc"],
                     lt_2cm=s["main/add_or_add_s/<2cm"])
             for m, s in summary.items()},
        stdout_tail=lines[-len(summary):])
    for m, s in summary.items():
        check(all(np.isfinite([r["add"], r["add_s"]]).all()
                  for r in records[m]) and len(records[m]) ==
              info["n_examples"], f"evaluation {argv}: bad records of {m}")
    return row


def evaluation_dump(fit_root):
    """Where phase 12 writes its resample run's records (``cli.evaluate
    --out``), outside the directory it removes."""
    return os.path.join(fit_root, "evaluation_resample.json")


def first_frame(ds, lo, hi):
    """The crop indices of the first frame of ``lo`` to ``hi`` crops, else
    of the largest frame."""
    from morefusion_tpu_torch.cli import _eval

    frames = list(_eval.frames_of(ds, len(ds)).values())
    for idxs in frames:
        if lo <= len(idxs) <= hi:
            return idxs
    return max(frames, key=len)


def icc_frame_problem(device, run, data, idxs):
    """One frame's joint ICC problem as ``cli.evaluate`` forms it: the occ
    model's start poses (the card's) and the problem's arrays."""
    from morefusion_tpu_torch import training
    from morefusion_tpu_torch.cli import _eval, evaluate
    from morefusion_tpu_torch.datasets import ProceduralModels, Transform

    args = evaluate.parse_args(["--log-dir", run, "--data", data])
    train_args = training.load_args(run)
    model = _eval.restore(_eval.build_model(train_args, device), run)
    ds = _eval.open_val(data)
    transform = Transform(train=False, with_occupancy=True,
                          eval_case=_eval.EVAL_CASES["observed"])
    T_pred = evaluate.predict_all(args, ds, transform, model, max(idxs) + 1)
    exs = [transform(ds[i]) for i in idxs]
    return ([T_pred[i] for i in idxs],
            evaluate.icc_problem(exs, ProceduralModels()))


def icc_args(run, data, mode, iterations):
    from morefusion_tpu_torch.cli import evaluate

    return evaluate.parse_args([
        "--log-dir", run, "--data", data, "--icc-cross-mode", mode,
        "--icc-iterations", str(iterations)])


#: host work that runs in a spawned process beside the card's later phases
_BACKGROUND = {}
BACKGROUND_THREADS = 4  # of the host's 8 cores


def start_background(name, fn, *args, inline=False):
    """Run ``fn(*args)`` in a spawned process (no fork: this process has
    run threads and the card), or here with ``inline`` (the rehearsal,
    whose patches a spawned process would not see);
    :func:`finish_background` collects it."""
    import concurrent.futures
    import multiprocessing

    t0 = time.perf_counter()
    if inline:
        future = concurrent.futures.Future()
        future.set_result(fn(*args))
        _BACKGROUND[name] = (None, future, t0)
        return
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    _BACKGROUND[name] = (pool, pool.submit(fn, *args), t0)


def stop_background():
    """Stop every background process still running (a phase failed before
    its job was collected)."""
    for name in list(_BACKGROUND):
        pool, _, _ = _BACKGROUND.pop(name)
        if pool is not None:
            for proc in list(getattr(pool, "_processes", {}).values()):
                proc.terminate()
            pool.shutdown(wait=False, cancel_futures=True)


def finish_background(name):
    """``(the result of the job, its seconds from start to collection)``;
    its process is stopped."""
    pool, future, t0 = _BACKGROUND.pop(name)
    try:
        return future.result(), time.perf_counter() - t0
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)


def cpu_icc_refines(args, T0, problem, threads):
    """The CPU's side of ``exact_replay``, in a background process (on
    ``threads`` threads; None leaves them): the refine from the starts,
    then ``ICC_JITTER_RUNS`` refines from starts moved by
    ``ICC_START_JITTER``."""
    from morefusion_tpu_torch.cli import evaluate

    if threads:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    runs = []
    for k in range(ICC_JITTER_RUNS + 1):
        starts = [np.array(T, dtype=np.float64) for T in T0]
        if k:
            for T in starts:
                T[:3, 3] += rng.normal(0, ICC_START_JITTER, 3)
        runs.append(evaluate.run_icc(args, starts, problem, 1, "cpu"))
    return runs, time.perf_counter() - t0


def exact_replay(device, run, data, T0, problem):
    """One exact-mode ICC problem replayed for ``ICC_REPLAY_ITERATIONS``
    on the card and on the CPU from the same starts. On the model's poses
    this objective is as sensitive as phase 9's full refine: a 1e-7 m move
    of the starts moves the CPU's own first loss, and its poses and losses
    after 5 iterations, by about phase 9's replay bounds (the phase prints
    that spread). So each of the first loss, the poses and the losses is
    held within phase 9's replay bound, or where the CPU's own spread is
    wider, within twice that spread: the largest move of the CPU's result
    when its start translations move by ``ICC_START_JITTER`` (phase 9's
    ``ICC_JITTER_RUNS`` draws; the card's rounding is no rigid move of the
    starts).

    The card's refine runs here; the CPU's refines run in a background
    process beside the later phases (``cpu_icc_refines``). Returns a
    function that collects them and makes the check."""
    args = icc_args(run, data, "exact", ICC_REPLAY_ITERATIONS)
    card = evaluate_run_icc(args, T0, problem, device)
    inline = device.type == "cpu"  # the rehearsal
    start_background("exact_replay", cpu_icc_refines, args, T0, problem,
                     None if inline else BACKGROUND_THREADS, inline=inline)

    def apart(a, b):
        (T_a, l_a, _), (T_b, l_b, _) = a, b
        return dict(first_loss=abs(float(l_a[0] - l_b[0])),
                    pose=float(np.abs(T_a - T_b).max()),
                    loss=float(np.abs(l_a - l_b).max()))

    def finish():
        (runs, cpu_s), wall_s = finish_background("exact_replay")
        cpu = runs[0]
        err = apart(card, cpu)
        jitter = [apart(r, cpu) for r in runs[1:]]
        spread = {k: max(r[k] for r in jitter) for k in err}
        n_g, n_c = card[2], cpu[2]
        fixed = dict(first_loss=ICC_LOSS_ATOL, pose=PIPE_POSE_ATOL,
                     loss=ICC_LOSS_ATOL)
        bound = {k: max(fixed[k], 2 * spread[k]) for k in fixed}
        check(n_g == n_c and all(err[k] <= bound[k] for k in err),
              f"evaluation: exact ICC replay card vs CPU {err}, n_iter "
              f"{n_g} / {n_c}; bounds {bound} (the CPU's spread {spread})")
        return dict(iterations=ICC_REPLAY_ITERATIONS, err=err,
                    cpu_jitter_spread=spread, jitter=ICC_START_JITTER,
                    jitter_runs=ICC_JITTER_RUNS, bound=bound,
                    cpu_s=cpu_s, background_wall_s=wall_s,
                    cpu_threads=BACKGROUND_THREADS)

    return finish


def evaluate_run_icc(args, T0, problem, device):
    from morefusion_tpu_torch.cli import evaluate

    return evaluate.run_icc(
        args, [np.array(T, dtype=np.float64) for T in T0], problem, 1,
        device)


def phase_evaluation(device, small, counts, fit_root):
    """The offline evaluation CLIs on phase 11's val set: the sweep and the
    ablation table, ``evaluate`` three ways and at 96^3, ICC kernel against
    plain, the card against the CPU. The rehearsal keeps
    ``EVAL_SMALL["icc_points"]`` points an object in ICC (the CLI asks for
    2048)."""
    if not small:
        return run_evaluation(device, small, counts, fit_root)
    from morefusion_tpu_torch import contrib

    class FewerPoints(contrib.IterativeCollisionCheck):
        def __init__(self, *args, **kw):
            kw["max_points"] = EVAL_SMALL["icc_points"]
            super().__init__(*args, **kw)

    with mock.patch.object(contrib, "IterativeCollisionCheck", FewerPoints):
        return run_evaluation(device, small, counts, fit_root)


def run_evaluation(device, small, counts, fit_root):
    import shutil

    from morefusion_tpu_torch.cli import _eval, ablation_report, eval_sweep
    from morefusion_tpu_torch.cli import evaluate
    from morefusion_tpu_torch.models import singleview_3d as sv3d
    from morefusion_tpu_torch.ops import min_dist as md

    cfg = EVAL_SMALL if small else EVAL_FULL
    root = os.path.join(fit_root, "eval")
    runs = eval_runs(os.path.join(root, "runs"), small)
    data = os.path.join(root, "val_packed")
    os.symlink(os.path.join(fit_root, "val"), data)
    out_dir = os.path.join(root, "sweep")
    os.makedirs(out_dir)
    occ = os.path.join(runs, "occ")
    n_ex = ([] if cfg["n_examples"] is None
            else ["--n-examples", str(cfg["n_examples"])])
    n_mode = (n_ex if cfg["mode_examples"] is None
              else ["--n-examples", str(cfg["mode_examples"])])
    iters = ["--icc-iterations", str(cfg["iterations"])]
    common = ["--log-dir", occ, "--data", data, "--methods",
              *EVAL_METHODS] + iters

    # the main path, counted: the sweep, the table, evaluate three ways
    # and at 96^3
    seconds = {}
    t_phase = time.perf_counter()
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    (_, sweep_lines) = quiet(eval_sweep.main, [
        "--runs-root", runs, "--out-dir", out_dir, "--device", device.type,
        "--sweep", *[f"{e}:{data}" for e in EVAL_SWEEP]])
    sweep_s = time.perf_counter() - t0
    sweep_launches = {c.__name__: c.launches for c in counts}
    found, table = quiet(ablation_report.main, [
        "--runs", out_dir, "--n-boot", str(cfg["n_boot"])])
    check(len(found) == 4 and all(np.isfinite(
        s["main/add_or_add_s/auc"]) for s in found.values()),
        f"evaluation: ablation rows {list(found)}")
    runs_out = {
        # its dump feeds phase 14's stratify_results
        "resample": evaluate_run(device, counts, common + n_ex + [
            "--out", evaluation_dump(fit_root)]),
        "exact": evaluate_run(device, counts, common + n_mode + [
            "--icc-cross-mode", "exact"]),
        "scale2_coarse_to_fine_decay": evaluate_run(
            device, counts, common + n_mode + [
                "--icc-grid-scale", "2", "--icc-coarse-to-fine",
                "--icc-alpha-decay"]),
    }
    if cfg["scale3_examples"]:
        runs_out["scale3"] = evaluate_run(device, counts, common + [
            "--n-examples", str(cfg["scale3_examples"]),
            "--icc-grid-scale", "3"])
    launches = {k: sweep_launches[k] + sum(r["launches"][k]
                                           for r in runs_out.values())
                for k in sweep_launches}
    seconds["main_path"] = time.perf_counter() - t_phase
    if device.type == "cuda":
        for name in ("resample", "exact"):
            r = runs_out[name]
            check(r["launches"]["min_dist_voxels"] > 0
                  and r["launches"]["nn_indices"] > 0,
                  f"evaluation {name}: launches {r['launches']}")
        exact = runs_out["exact"]["shapes"]["min_dist_voxels"]
        check(any(int(k.split()[1][2:]) > 2048 for k in exact),
              f"evaluation exact: no lane of all objects' points: {exact}")

    # kernel against plain: one frame's joint problem, in exact mode and
    # at scale 2, deterministic
    # (3-4 objects: 4 lanes)
    t0 = time.perf_counter()
    ds = _eval.open_val(data)
    idxs = first_frame(ds, 3, 4)
    T0, problem = icc_frame_problem(device, occ, data, idxs)
    vs_plain = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, mode, scale in (("exact", "exact", 1),
                                  ("scale2", "resample", 2)):
            args = icc_args(occ, data, mode, cfg["iterations"])
            T_k, l_k, n_k = evaluate.run_icc(args, T0, problem, scale,
                                             device)
            with mock.patch.object(md, "min_dist_voxels",
                                   md.min_dist_voxels_plain):
                T_p, l_p, n_p = evaluate.run_icc(args, T0, problem, scale,
                                                 device)
            loss_err = float(np.abs(l_k - l_p).max())
            pose_err = float(np.abs(T_k - T_p).max())
            check(n_k == n_p and loss_err == 0.0 and pose_err == 0.0,
                  f"evaluation ICC {name}: kernel vs plain n_iter {n_k} / "
                  f"{n_p}, losses {loss_err}, poses {pose_err} apart")
            vs_plain[name] = dict(objects=len(idxs), n_iter=n_k,
                                  loss_err=loss_err, pose_err=pose_err)
    finally:
        torch.use_deterministic_algorithms(False)
    seconds["kernel_vs_plain"] = time.perf_counter() - t0

    # the card against the CPU: raw records of a few crops (the same pixel
    # draw on both), and one exact-mode problem replayed
    t0 = time.perf_counter()
    raw = {}
    with mock.patch.object(sv3d, "sample_mask_indices", fixed_sampling):
        for dev in (device.type, "cpu"):
            (summary, records, _), _ = quiet(evaluate.main, [
                "--log-dir", occ, "--data", data, "--methods", "morefusion",
                "--n-examples", str(cfg["cpu_examples"]), "--batch-size",
                str(cfg["cpu_examples"]), "--device", dev])
            raw[dev] = records["morefusion"]
    raw_err = max(abs(g[k] - w[k]) for g, w in zip(raw[device.type],
                                                  raw["cpu"])
                  for k in ("add", "add_s"))
    check(raw_err <= POSE_ATOL, f"evaluation: card and CPU ADDs {raw_err} "
                                "apart")
    seconds["card_vs_cpu_raw"] = time.perf_counter() - t0
    # the exact-mode replay on the frame's first two crops: its CPU side
    # grows as the square of the objects (~265 s at 3 objects on the card's
    # host), so two leave room for phase 14
    t0 = time.perf_counter()
    replay_idxs = idxs[:2]
    finish_replay = exact_replay(
        device, occ, data, *icc_frame_problem(device, occ, data,
                                              replay_idxs))
    seconds["card_vs_cpu_exact_replay_card"] = time.perf_counter() - t0
    shutil.rmtree(root)

    emit(dict(
        phase="evaluation", ok=True, device=str(device),
        data=dict(val_crops=len(ds), path="phase 11's val set"),
        runs="committed occ / noocc checkpoints" if not small
        else "seeded tiny models",
        sweep=dict(entries=list(EVAL_SWEEP), s=sweep_s,
                   launches=sweep_launches, lines=sweep_lines),
        ablation_table=table,
        evaluate=runs_out, launches=launches, seconds=seconds,
        kernel_vs_plain=dict(tolerance="identical", **vs_plain),
        card_vs_cpu=dict(raw_crops=cfg["cpu_examples"],
                         raw_max_add_err=raw_err, raw_tolerance=POSE_ATOL,
                         exact_replay=dict(
                             objects=len(replay_idxs),
                             cpu="in a background process, checked in "
                                 "the line evaluation_exact_replay"))))

    def finish():
        emit(dict(phase="evaluation_exact_replay", ok=True,
                  objects=len(replay_idxs), **finish_replay()))

    return launches, finish


# -------------------------------------------------------------- phase 13

# the rest of training (phase 13): textured data and the r5tex checkpoint,
# PoseNet through the train CLI, the segmenter's training and backbone
# pretraining. The textured and untextured sets are val frames of one seed;
# the segmenter's frames are train_segmentation.py's (4-10 objects, its
# default seeds) at 240x320; pretraining reads phase 11's packed sets
REST_TEX_SEED = 13
SEG_OBJECTS = (4, 10)
SEG_SEED = 0
REST_FULL = dict(tex_frames=8, seg_frames=64, seg_val_frames=16,
                 seg_shape=(240, 320), seg_batch=8, seg_widths=SEG_WIDTHS,
                 seg_steps=600, pretrain_steps=60,
                 pretrain_width=64, pretrain_batch=32, pretrain_n_val=32)
REST_SMALL = dict(tex_frames=2, seg_frames=4, seg_val_frames=2,
                  seg_shape=(120, 160), seg_batch=2, seg_widths=(8, 16),
                  seg_steps=3, pretrain_steps=4,
                  pretrain_width=8, pretrain_batch=8, pretrain_n_val=8)
# the segmenter's steps are fixed: fitted to 50 s, the count followed the
# host's batch time (328 to 478 steps on one H100), and at 328 the segmenter
# found no instance on phase 9's frame, so its pipeline refined nothing
# train_segmentation.py's foreground weight (its recall lever): at the
# plain mean (1.0) a run of a few hundred steps predicts background alone
SEG_FG_WEIGHT = 5.0
# the segmenter's loss, card against CPU at B = 2
SEG_CPU_LOSS_RTOL = 1e-5
# the trained segmenter's maps measured in phase 13 (val frames)
SEG_MAP_FRAMES = 3

_SEG_SETS = {}


def _seg_frame(task):
    """One segmentation frame into ``MFTPU_SEG_CACHE`` (a forked worker)."""
    split, index = task
    _SEG_SETS[split].get_example(index)
    return index


def rest_root(fit_root):
    return os.path.join(fit_root, "rest")


def rest_data(fit_root, small):
    """Phase 13's host data, made in forked workers before anything runs on
    the card (as phase 11's): ``cli.generate_data`` of one seed with and
    without ``--textured``, and the segmenter's train and val frames in
    ``MFTPU_SEG_CACHE`` (``SyntheticInstanceSegmentationDataset``'s disk
    cache, which ``cli.train_segmentation`` then reads)."""
    import multiprocessing

    from morefusion_tpu_torch.cli import generate_data
    from morefusion_tpu_torch.datasets.instance_segmentation import (
        SyntheticInstanceSegmentationDataset,
    )

    cfg = REST_SMALL if small else REST_FULL
    fit = FIT_SMALL if small else FIT_FULL
    root = rest_root(fit_root)
    n_workers = min(os.cpu_count() or 1, 4 if small else 8)
    t0 = time.perf_counter()
    flags = ["--split", "val", "--n-frames", str(cfg["tex_frames"]),
             "--n-objects", *map(str, FIT_OBJECTS), "--image-shape",
             *map(str, fit["shape"]), "--seed", str(REST_TEX_SEED),
             "--n-workers", str(n_workers)]
    for name, extra in (("textured", ["--textured"]), ("untextured", [])):
        quiet(generate_data.main,
              ["--out", os.path.join(root, name)] + flags + extra)
    tex_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {
            "MFTPU_SEG_CACHE": os.path.join(root, "segcache")}):
        for split, n, seed in (("train", cfg["seg_frames"], SEG_SEED),
                               ("val", cfg["seg_val_frames"], SEG_SEED + 1)):
            _SEG_SETS[split] = SyntheticInstanceSegmentationDataset(
                split=split, n_frames=n, image_shape=cfg["seg_shape"],
                n_objects=SEG_OBJECTS, seed=seed,
                background_composite=False, cache=False)
        tasks = [(s, i) for s, ds in _SEG_SETS.items()
                 for i in range(len(ds))]
        with multiprocessing.get_context("fork").Pool(n_workers) as pool:
            pool.map(_seg_frame, tasks, chunksize=1)
    _SEG_SETS.clear()
    return dict(tex_frames=cfg["tex_frames"], tex_s=tex_s,
                seg_frames=cfg["seg_frames"],
                seg_val_frames=cfg["seg_val_frames"],
                seg_s=time.perf_counter() - t0, n_workers=n_workers)


def same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"))


def phase_textured(device, small, counts, fit_root, data):
    """(a) The textured set against the untextured one of the same seed
    (only ``rgb`` differs), then the committed r5tex checkpoint, trained on
    textured data, and the occ checkpoint evaluated on the textured crops
    (``cli.evaluate --methods morefusion morefusion+icp``; seeded tiny
    models in the rehearsal). No gate on the AUCs."""
    from morefusion_tpu_torch import datasets

    root = rest_root(fit_root)
    tex, flat = (os.path.join(root, n) for n in ("textured", "untextured"))
    check(read_json(os.path.join(tex, "meta.json"))
          == read_json(os.path.join(flat, "meta.json")),
          "textured: meta.json differs from the untextured set's")
    files = sorted(os.path.relpath(os.path.join(d, f), tex)
                   for d, _, fs in os.walk(tex) for f in fs
                   if f.endswith(".npz"))
    check(len(files) > 0, "textured: no examples")
    rgb_differs = 0
    for rel in files:
        with np.load(os.path.join(tex, rel)) as a, \
                np.load(os.path.join(flat, rel)) as b:
            check(sorted(a.files) == sorted(b.files), f"textured: {rel} keys")
            for k in a.files:
                if k == "rgb":
                    rgb_differs += not same_array(a[k], b[k])
                else:
                    check(same_array(a[k], b[k]),
                          f"textured: {rel}:{k} differs without texture")
    check(rgb_differs > 0, "textured: the texture changed no crop's rgb")

    packed = tex + "_packed"
    datasets.pack_reindexed(tex, packed, progress=False)
    n_crops = len(datasets.PackedPoseDataset(packed, split="val"))
    runs = eval_runs(os.path.join(root, "runs"), small, ("r5tex", "occ"))
    n_ex = ["--n-examples", "4"] if small else []
    rows = {name: evaluate_run(device, counts, [
        "--log-dir", os.path.join(runs, name), "--data", packed,
        "--methods", "morefusion", "morefusion+icp"] + n_ex)
        for name in ("r5tex", "occ")}
    launches = {k: sum(r["launches"][k] for r in rows.values())
                for k in rows["occ"]["launches"]}
    if device.type == "cuda":
        check(launches["nn_indices"] > 0, "textured: no knn launch")
    emit(dict(phase="rest_textured", ok=True, device=str(device), data=data,
              examples=len(files), rgb_differs=rgb_differs,
              textured_crops=n_crops,
              checkpoints="committed r5tex / occ" if not small
              else "seeded tiny models",
              auc={name: r["auc"] for name, r in rows.items()},
              refine_frames_per_s={name: r["refine_frames_per_s"]
                                   for name, r in rows.items()},
              wall_s={name: r["wall_s"] for name, r in rows.items()},
              launches=launches))
    return launches


def phase_posenet(device, small, counts, fit_root, setup):
    """(b) PoseNet at full width: one step with the kernels against the
    plain versions (``F.interpolate`` for the resize) in deterministic mode
    and one on the card against the CPU at B = 2 (phase 6's batch and
    tolerances), then ``cli.train
    --model posenet`` on phase 11's packed sets (fp32, ``add/add_s``: the
    ``add -> add/add_s`` switch after an epoch, then two steps with ADD-S,
    one evaluation), its step ms and knn launches."""
    from morefusion_tpu_torch import datasets
    from morefusion_tpu_torch import models
    from morefusion_tpu_torch.models import pspnet
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md
    from morefusion_tpu_torch.ops import resize
    from morefusion_tpu_torch.training import trainer

    models_bank, bank, _, batch = setup
    S = batch["rgb"].shape[1]
    torch.manual_seed(31)
    model = models.PoseNet(n_fg_class=21).to(device)
    loss_fn = trainer.make_loss_fn(model, bank)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            kernel = loss_and_grads(model, loss_fn, batch, train=True)
            with mock.patch.object(md, "min_dist_voxels",
                                   md.min_dist_voxels_plain), \
                    mock.patch.object(knn, "nn_indices",
                                      knn.nn_indices_plain), \
                    mock.patch.object(pspnet, "resize_bilinear",
                                      resize.resize_bilinear_plain):
                plain = loss_and_grads(model, loss_fn, batch, train=True)
    finally:
        torch.use_deterministic_algorithms(False)
    vs_plain = compare_steps(kernel, plain, STEP_LOSS_RTOL, STEP_GRAD_RTOL,
                             STEP_GRAD_TOTAL, "posenet kernel vs plain")
    vs_plain["loss_identical"] = kernel[0] == plain[0]
    del kernel, plain

    b2 = make_train_batch(2, S, seed=1)
    mask = ~np.isnan(b2["pcd"]).any(-1).reshape(2, -1)
    g = np.random.RandomState(6)
    b2["sample_indices"] = np.stack([
        g.choice(np.flatnonzero(m), model.n_point, replace=False)
        for m in mask]).astype(np.int64)
    on_card = loss_and_grads(model, loss_fn, b2, train=False)
    cpu_model = models.PoseNet(n_fg_class=21)
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    cpu_bank = trainer.CadPointBank.build(models_bank, 21, device="cpu")
    on_cpu = loss_and_grads(cpu_model,
                            trainer.make_loss_fn(cpu_model, cpu_bank),
                            b2, train=False)
    vs_cpu = compare_steps(on_card, on_cpu, CPU_LOSS_RTOL, CPU_GRAD_RTOL,
                           CPU_GRAD_TOTAL, "posenet card vs cpu")
    del model, on_card, on_cpu, cpu_model, cpu_bank

    # the main path: the train CLI
    cfg = FIT_SMALL if small else FIT_FULL
    train, val = (os.path.join(fit_root, s) for s in ("train", "val"))
    spe = len(datasets.PackedPoseDataset(
        train, min_visibility=FIT_MIN_VISIBILITY)) // cfg["batch"]
    n_steps, eval_at = (spe + 2, spe) if not small else (2, 2)
    run = os.path.join(rest_root(fit_root), "posenet")
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    (state, summary), _ = quiet(run_cli, [
        "--out", run, "--model", "posenet", "--data", train, "--val-data",
        val, "--loss", "add/add_s", "--batch-size", str(cfg["batch"]),
        "--val-batch-size", str(cfg["val_batch"]), "--max-steps",
        str(n_steps), "--eval-interval", str((eval_at + 0.5) / spe),
        "--log-interval", "1", "--min-visibility", str(FIT_MIN_VISIBILITY),
        "--device", device.type])
    wall_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counts}
    check(isinstance(state.model, models.PoseNet) and state.step == n_steps,
          f"posenet: {type(state.model).__name__} at step {state.step}")
    log = read_json(os.path.join(run, "log.json"))
    evals = [r["iteration"] for r in log if "main/add_or_add_s/auc" in r]
    check(evals == [eval_at], f"posenet: evaluations at {evals}")
    auc = summary.get("main/add_or_add_s/auc")
    check(auc is not None and np.isfinite(auc), f"posenet: {summary}")
    rows = [r for r in log if "main/sps" in r]
    check(all(np.isfinite(r["main/loss"]) for r in rows),
          f"posenet: losses {[r['main/loss'] for r in rows]}")
    step_ms = {
        phase: [1e3 / r["main/sps_window"] for r in rows
                if r["iteration"] > 1 and (r["iteration"] > spe) == sym]
        for phase, sym in (("add", False), ("add_s", True))}
    timing = read_json(os.path.join(run, "timing.json"))
    if device.type == "cuda":
        check(launches["nn_indices"] > 0,
              "posenet: the knn kernel was never launched")
    emit(dict(phase="rest_posenet", ok=True, device=str(device),
              model="PoseNet, full width, fp32", batch=cfg["batch"],
              n_point=state.model.n_point, kernel_vs_plain=vs_plain,
              card_vs_cpu=vs_cpu,
              tolerance=dict(kernel_vs_plain=dict(
                  loss_rtol=STEP_LOSS_RTOL, grad_rtol=STEP_GRAD_RTOL,
                  grad_of_whole=STEP_GRAD_TOTAL),
                  card_vs_cpu=dict(loss_rtol=CPU_LOSS_RTOL,
                                   grad_rtol=CPU_GRAD_RTOL,
                                   grad_of_whole=CPU_GRAD_TOTAL)),
              fit=dict(steps=state.step, steps_per_epoch=spe,
                       evaluation_at=eval_at, wall_s=wall_s,
                       step_ms=step_ms,
                       median_step_ms={k: median(v)
                                       for k, v in step_ms.items()},
                       eval_ms_per_batch=median(timing["eval_ms_per_batch"]),
                       save_best_ms=median(timing["save_best_ms"]),
                       sps_window=[r["main/sps_window"] for r in rows],
                       copy_ms=median(timing["copy_ms"]),
                       pack_ms=median(timing.get("pack_ms", [])),
                       batch_bytes=timing["batch_bytes"],
                       losses=[r["main/loss"] for r in rows], auc=auc),
              launches=launches))
    return launches


def components_on_map(unet, rgb, device, reps, what):
    """The UNet's class map and boundary on ``rgb``, the components on the
    card against the CPU (keys and propagation identical), and their host
    ms on the card: ``(info, (class_map, boundary, comp))``."""
    from morefusion_tpu_torch.ops import connected_components

    with torch.inference_mode():
        logits, blog = unet(torch.from_numpy(rgb[None]).to(device))
        class_map = logits[0].argmax(0).to(torch.int32)
        boundary = blog[0] > 0.0
        ms, (comp, stats) = host_timed(
            lambda: connected_components(class_map, boundary,
                                         return_stats=True), reps, device)
    want, want_stats = connected_components(class_map.cpu(), boundary.cpu(),
                                            return_stats=True)
    diff = int((comp.cpu() != want).sum())
    check(diff == 0 and stats == want_stats,
          f"{what}: {diff} component keys differ, propagation "
          f"{stats} (card) vs {want_stats} (cpu)")
    return dict(ms=ms, propagation=stats, keys_differing=diff,
                components=len(np.unique(want.numpy())) - 1,
                foreground_share=float((class_map > 0).double().mean())), \
        (class_map, boundary, comp)


def phase_seg_train(device, small, counts, fit_root, data, models_bank,
                    frames, pose_model):
    """(c) ``cli.train_segmentation`` at ``bench.py --segmenter``'s widths
    with the boundary head on the frames ``rest_data`` cached, for
    ``seg_steps`` steps, with its rate measured first (the bare step on a
    batch on the card, and the host's time to make a batch); the
    segmenter's loss card against CPU at B = 2; the held-out mIoU and
    detection rate of the trained segmenter beside the seeded start's on
    the same val frames (training must raise the mIoU); then phase 10's
    measurements on the trained segmenter's own maps (components card
    against CPU, ms, propagation steps and host reads) and a short
    ``ScenePipeline(segmenter=...)`` stream (the bf16 pose model)."""
    from morefusion_tpu_torch import training
    from morefusion_tpu_torch.cli import train_segmentation as seg_cli
    from morefusion_tpu_torch.datasets.instance_segmentation import (
        SyntheticInstanceSegmentationDataset,
    )
    from morefusion_tpu_torch.datasets.rgbd_pose_estimation.augmentation \
        import augment_rgb
    from morefusion_tpu_torch.models.segmentation import (
        SegmentationNode,
        UNetSegmentation,
    )
    from morefusion_tpu_torch.ops import connected_components
    from morefusion_tpu_torch.runtime import ScenePipeline

    cfg = REST_SMALL if small else REST_FULL
    root = rest_root(fit_root)
    B = cfg["seg_batch"]
    base = ["--out", os.path.join(root, "segmenter"), "--n-frames",
            str(cfg["seg_frames"]), "--n-val-frames",
            str(cfg["seg_val_frames"]), "--image-shape",
            *map(str, cfg["seg_shape"]), "--n-objects",
            *map(str, SEG_OBJECTS), "--batch-size", str(B), "--widths",
            *map(str, cfg["seg_widths"]), "--seed", str(SEG_SEED),
            "--fg-weight", str(SEG_FG_WEIGHT), "--device", device.type]
    args = seg_cli.parse_args(base)

    def unet():
        torch.manual_seed(SEG_SEED)  # the CLI's start
        return UNetSegmentation(n_class=SEG_N_CLASS,
                                widths=cfg["seg_widths"], with_boundary=True)

    with mock.patch.dict(os.environ, {
            "MFTPU_SEG_CACHE": os.path.join(root, "segcache")}):
        # (a) the rate: the host's batch (its second making: the frames
        # then come from the dataset's memory, as after the first epoch),
        # then the bare step on the card
        ds = SyntheticInstanceSegmentationDataset(
            split="train", n_frames=cfg["seg_frames"],
            image_shape=cfg["seg_shape"], n_objects=SEG_OBJECTS,
            format="instance", seed=SEG_SEED)
        aug = np.random.RandomState(0)
        host_batch_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            exs = [dict(ex, rgb=augment_rgb(ex["rgb"].astype(np.uint8), aug)
                        .astype(np.float32))
                   for ex in (ds.get_example(i) for i in range(B))]
            batch = training.stack_examples(exs)
            host_batch_ms.append((time.perf_counter() - t0) * 1e3)
        small_batch = seg_cli.quantize_batch(batch, use_depth=False)
        state = training.create_train_state(unet().to(device), args.lr)
        step = seg_cli.make_train_step(state, fg_weight=SEG_FG_WEIGHT)
        float(step(small_batch))
        bare_ms = []
        for _ in range(5):
            sync(device)
            t0 = time.perf_counter()
            float(step(small_batch))
            bare_ms.append((time.perf_counter() - t0) * 1e3)
        del state, step

        # (b) the loss on the card against the CPU at B = 2
        two = {k: v[:2] for k, v in small_batch.items()}
        losses, grads = [], []
        for dev in (device, torch.device("cpu")):
            m = unet().to(dev)
            loss, _ = seg_cli.make_loss_fn(m, SEG_FG_WEIGHT)(two)
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append(torch.cat([p.grad.reshape(-1).cpu()
                                    for p in m.parameters()]))
        loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
        grad_err = float((grads[0] - grads[1]).norm() / grads[1].norm())
        check(loss_err <= SEG_CPU_LOSS_RTOL,
              f"segmenter training: loss card {losses[0]} vs cpu "
              f"{losses[1]}")

        # (c) the main path: the CLI
        n_steps = cfg["seg_steps"]
        t0 = time.perf_counter()
        (state, summary), lines = quiet(seg_cli.main,
                                        base + ["--steps", str(n_steps)])
        cli_s = time.perf_counter() - t0
        check(state.step == n_steps, f"segmenter: {state.step} steps")
        log = read_json(os.path.join(args.out, "log.json"))
        train_losses = [r["main/loss"] for r in log if "main/loss" in r]
        check(np.isfinite(train_losses).all(),
              f"segmenter: losses {train_losses}")
        # (d) the seeded start on the same val frames
        t0 = time.perf_counter()
        seeded, _ = seg_cli.evaluate(unet(), args)
        seeded_eval_s = time.perf_counter() - t0
        val = SyntheticInstanceSegmentationDataset(
            split="val", n_frames=cfg["seg_val_frames"],
            image_shape=cfg["seg_shape"], n_objects=SEG_OBJECTS,
            format="instance", seed=SEG_SEED + 1)
        val_rgb = [val.get_example(i)["rgb"]
                   for i in range(min(SEG_MAP_FRAMES, len(val)))]
    if not small:
        check(summary["validation/miou"] > seeded["validation/miou"],
              f"segmenter: trained mIoU {summary['validation/miou']} not "
              f"above the seeded start's {seeded['validation/miou']}")

    # (e) the trained segmenter's own maps: the val frames and phase 9's
    trained = state.model.eval()
    reps = 10 if not small else 2
    maps = {}
    what = "trained segmenter"
    for i, rgb in enumerate(val_rgb):
        maps[f"val_{i}"], _ = components_on_map(trained, rgb, device, reps,
                                                what)
    maps["pipeline_frame"], (class_map, boundary, _) = components_on_map(
        trained, frames[0]["rgb"], device, reps, what)
    cc_profile = None
    if device.type == "cuda":
        steps = sum(maps["pipeline_frame"]["propagation"]["iterations"])
        cc_profile = profile_calls(
            lambda: connected_components(class_map, boundary), device, 5)
        cc_profile["kernels_per_step"] = cc_profile["kernels_per_call"] / steps
    node = SegmentationNode(trained, device=device)
    node(frames[0]["rgb"])
    node_ms, (_, classes) = host_timed(lambda: node(frames[0]["rgb"]), reps,
                                       device)

    # (f) the scene pipeline on the trained segmenter's instances
    V = 32 if not small else 16
    seg_frames = [{k: f[k] for k in ("rgb", "depth", "K", "T_cam2world")}
                  for f in frames]

    def make(n_votes):
        return ScenePipeline(pose_model, models_bank, segmenter=node,
                             voxel_dim=V, n_votes=n_votes,
                             native_mapping=True, size_filter=False,
                             async_refine=True, device=device)

    pipe, n_votes = warm_pipeline(make, seg_frames, 1)
    run = timed_stream(pipe, seg_frames, counts, device,
                       6 if not small else 2, segment=True)
    frame_ms = 1e3 / run["scene_pipeline_fps"]
    emit(dict(phase="rest_segmenter", ok=True, device=str(device),
              data=data, frame=list(cfg["seg_shape"]),
              widths=list(cfg["seg_widths"]), batch=B, steps=n_steps,
              fg_weight=SEG_FG_WEIGHT,
              rate=dict(bare_step_ms=bare_ms,
                        median_bare_step_ms=median(bare_ms),
                        host_batch_ms=host_batch_ms,
                        cli_s=cli_s, cli_step_ms=cli_s * 1e3 / n_steps),
              card_vs_cpu=dict(loss=losses, loss_rel_err=loss_err,
                               grad_rel_err=grad_err,
                               loss_rtol=SEG_CPU_LOSS_RTOL),
              losses=train_losses,
              held_out=dict(val_frames=cfg["seg_val_frames"],
                            trained=summary, seeded=seeded,
                            seeded_eval_s=seeded_eval_s),
              trained_maps=maps, components_profile=cc_profile,
              node_call_ms=node_ms, instances=len(classes),
              pipeline=dict(n_votes=n_votes, pose_model="bf16",
                            segment_share=(run["split_ms_per_frame"]
                                           ["segment"] / frame_ms),
                            **run)))
    check_timed_pass(run, "pipeline with the trained segmenter", device)
    return run["launches"]["min_dist_voxels"]


def phase_pretrain(device, small, fit_root):
    """(d) ``cli.pretrain_backbone`` on phase 11's train and val packed sets
    together, then a one-step ``cli.train --pretrained-backbone`` run whose
    grafted backbone is the export rounded to bf16."""
    from morefusion_tpu_torch.cli import pretrain_backbone
    from morefusion_tpu_torch.training import loop
    from morefusion_tpu_torch.training.checkpoints import import_backbone_npz

    cfg = REST_SMALL if small else REST_FULL
    fit = FIT_SMALL if small else FIT_FULL
    train, val = (os.path.join(fit_root, s) for s in ("train", "val"))
    out = os.path.join(rest_root(fit_root), "pretrain")
    steps = cfg["pretrain_steps"]
    t0 = time.perf_counter()
    (model, row), _ = quiet(pretrain_backbone.main, [
        "--out", out, "--data", train, val, "--steps", str(steps),
        "--batch-size", str(cfg["pretrain_batch"]), "--n-val",
        str(cfg["pretrain_n_val"]), "--width", str(cfg["pretrain_width"]),
        "--eval-interval", str(max(steps // 2, 1)), "--device",
        device.type])
    pretrain_s = time.perf_counter() - t0
    with open(os.path.join(out, "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check(len(rows) == 2 and rows[-1]["step"] == steps
          and 0.0 <= row["val_acc"] <= 1.0, f"pretrain: log {rows}")
    npz = os.path.join(out, "backbone_bf16.npz")

    # a one-step run of the graft; its backbone is read right after the
    # graft, before the step
    grafted = {}

    def graft(model, path):
        out = import_backbone_npz(model, path)
        grafted.update({k: v.detach().cpu().clone() for k, v in
                        model.resnet_extractor.state_dict().items()})
        return out

    argv = ["--out", os.path.join(rest_root(fit_root), "grafted"),
            "--data", train, "--val-data", val, "--pretrained-backbone", npz,
            "--batch-size", str(fit["batch"]), "--max-steps", "1",
            "--eval-interval", "1000", "--min-visibility",
            str(FIT_MIN_VISIBILITY), "--device", device.type]
    if small:
        argv += ["--tiny", "--n-point", "64"]
    with mock.patch.object(loop, "import_backbone_npz", graft):
        (state, _), _ = quiet(run_cli, argv)
    want = model.resnet_extractor.state_dict()
    check(sorted(grafted) == sorted(want) and state.step == 1,
          "pretrain: the grafted run's backbone keys or step")
    for k, v in want.items():
        check(torch.equal(grafted[k], v.detach().cpu().to(torch.bfloat16)
                          .to(torch.float32)),
              f"pretrain: grafted {k} is not the export rounded to bf16")
    emit(dict(phase="rest_pretrain", ok=True, device=str(device),
              crops=dict(sets=["train", "val"], n_val=cfg["pretrain_n_val"]),
              width=cfg["pretrain_width"], batch=cfg["pretrain_batch"],
              steps=steps, pretrain_s=pretrain_s,
              ms_per_step=pretrain_s * 1e3 / steps, log=rows,
              val_acc=row["val_acc"], grafted=dict(
                  model="SingleView3D" + (" (tiny)" if small else ""),
                  leaves=len(want), steps=1,
                  equal_to_export_in_bf16=True)))


def phase_rest(device, small, counts, fit_root, data, setup, models_bank,
               frames, pose_model):
    """Phase 13: the rest of training, (a) to (d)."""
    t0 = time.perf_counter()
    textured = phase_textured(device, small, counts, fit_root, data)
    posenet = phase_posenet(device, small, counts, fit_root, setup)
    segmenter = phase_seg_train(device, small, counts, fit_root, data,
                                models_bank, frames, pose_model)
    phase_pretrain(device, small, fit_root)
    emit(dict(phase="rest_of_training", ok=True,
              seconds=time.perf_counter() - t0))
    return textured, posenet, segmenter


# -------------------------------------------------------------- phase 14

# replay, occupancy registration and the offline tools (phase 14)
# occupancy_grid_3d's shapes: (grid side, CAD points of class 21, threshold)
OCC_SHAPES = ((32, 4000, 2.0), (24, 800, 1.0))
OCC_SHAPES_SMALL = ((16, 800, 2.0), (12, 300, 1.0))
# align_occupancy_grids, card against CPU: the first OCC_CPU_ITERATIONS
# steps of the card's run against the same steps on the CPU; Adam's
# quaternion rate of 0.1 makes the run chaotic (tests/
# test_torch_occupancy_registration.py), so the ADDs are held within the
# CPU's own spread under ICC_START_JITTER (ICC_JITTER_RUNS runs) plus
# OCC_ADD_ATOL
OCC_CPU_ITERATIONS = 10
OCC_ADD_ATOL = 1e-5
# replay_eval's frames replayed on the card and the CPU
REPLAY_SYNC_FRAMES = 3
# the rest of functions/ at the train step's shapes: B lanes of P points,
# V^3 grids, C channels
FUNC_FULL = dict(B=16, P=1000, V=32, C=32)
FUNC_SMALL = dict(B=2, P=200, V=12, C=4)
FUNC_ATOL = 1e-5  # card against CPU, relative to the largest entry


def occupancy_inputs(bank, V, n, device, seed=0):
    """``n`` CAD points of class 21 under a random rotation, in a ``V^3``
    grid of the class's pitch centred on them."""
    g = np.random.RandomState(seed)
    pcd = bank.get_pcd(21)[:n] @ random_rotation(g).T
    pitch = float(bank.get_voxel_pitch(V, 21))
    origin = np.full(3, -pitch * (V / 2.0 - 0.5), np.float32)
    return (torch.from_numpy(pcd.astype(np.float32)).to(device), pitch,
            origin)


def phase_occupancy(device, small, counts, bank):
    """(a) ``occupancy_grid_3d`` with the kernel against the plain version;
    its kernel call timed; ``cli.align_occupancy_grids`` at its defaults,
    counted, and against the CPU."""
    from morefusion_tpu_torch import functions as F
    from morefusion_tpu_torch.cli import align_occupancy_grids as aog
    from morefusion_tpu_torch.contrib import OccupancyRegistration
    from morefusion_tpu_torch.metrics import average_distance
    from morefusion_tpu_torch.ops import min_dist as md

    grids = {}
    for V, n, thr in OCC_SHAPES_SMALL if small else OCC_SHAPES:
        points, pitch, origin = occupancy_inputs(bank, V, n, device)
        w = torch.from_numpy(np.random.RandomState(V).rand(V, V, V).astype(
            np.float32)).to(device)

        def grid_and_grad():
            p = points.clone().requires_grad_(True)
            grid = F.occupancy_grid_3d(p, pitch=pitch, origin=origin,
                                       dims=(V,) * 3, threshold=thr)
            (grid * w).sum().backward()
            return grid.detach(), p.grad

        torch.use_deterministic_algorithms(True)
        try:
            grid_k, g_k = grid_and_grad()
            with mock.patch.object(md, "min_dist_voxels",
                                   md.min_dist_voxels_plain):
                grid_p, g_p = grid_and_grad()
        finally:
            torch.use_deterministic_algorithms(False)
        check(torch.equal(grid_k, grid_p) and torch.equal(g_k, g_p),
              f"occupancy {V}^3 x {n}: kernel and plain grids or gradients "
              "differ")
        check(bool(grid_k.max() > 0.9) and bool(torch.isfinite(g_k).all()),
              f"occupancy {V}^3 x {n}: empty grid or bad gradient")
        ip = ((points - torch.from_numpy(origin).to(device)) / pitch)[None]
        timing = min_dist_timing(
            device, ip.contiguous(),
            torch.ones((1, n), dtype=torch.bool, device=device),
            torch.zeros((1, n), dtype=torch.int32, device=device),
            100, (V, V, V))
        grids[f"{V}^3x{n}"] = dict(threshold=thr, occupied=int(
            (grid_k > 0).sum()), kernel_vs_plain="identical", **timing)

    # align_occupancy_grids at its defaults: the main path, counted
    argv = ["--voxel-dim", "16", "--iterations", "10"] if small else []
    args = aog.parse_args(argv)
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    adds, lines = quiet(aog.main, argv + ["--device", device.type])
    wall_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counts}
    check(len(adds) == args.iterations + 1 and np.isfinite(adds).all(),
          f"align_occupancy_grids: {len(adds)} ADDs")
    if device.type == "cuda":
        check(launches["min_dist_voxels"] == args.iterations,
              f"align_occupancy_grids: {launches['min_dist_voxels']} "
              f"min_dist launches for {args.iterations} iterations")

    # the registration alone, and its first steps on the CPU
    _, _, T_true, pitch, origin, target, cad = aog.target_problem(args)
    T_init = aog._perturbed(T_true, np.random.RandomState(args.seed))

    def registration(dev, T0):
        return OccupancyRegistration(cad, target, pitch=pitch, origin=origin,
                                     threshold=2.0, transform_init=T0,
                                     device=dev)

    reg = registration(device, T_init)
    sync(device)
    t0 = time.perf_counter()
    reg.register(args.iterations)  # ends in a read
    ms_per_iteration = (time.perf_counter() - t0) * 1e3 / args.iterations

    def cpu_adds(T0):
        return np.array([average_distance([cad], [T_true], [T])[0][0]
                         for T in registration("cpu", T0).register_iterative(
                             OCC_CPU_ITERATIONS)])

    n = OCC_CPU_ITERATIONS + 1
    cpu = cpu_adds(T_init)
    err = float(np.abs(np.asarray(adds[:n]) - cpu).max())
    rng = np.random.RandomState(0)
    spread = 0.0
    for _ in range(ICC_JITTER_RUNS):
        T0 = T_init.copy()
        T0[:3, 3] += rng.normal(0, ICC_START_JITTER, 3)
        spread = max(spread, float(np.abs(cpu_adds(T0) - cpu).max()))
    check(err <= spread + OCC_ADD_ATOL,
          f"align_occupancy_grids: card ADDs {err} from the CPU's over "
          f"{OCC_CPU_ITERATIONS} steps, beyond the CPU's spread {spread}")
    row = dict(grids=grids, align_occupancy_grids=dict(
        argv=argv, voxel_dim=args.voxel_dim, iterations=args.iterations,
        cad_points=len(cad), wall_s=wall_s,
        registration_ms_per_iteration=ms_per_iteration, launches=launches,
        add_first=adds[0], add_last=adds[-1], add_min=float(min(adds)),
        lines=lines, card_vs_cpu=dict(
            iterations=OCC_CPU_ITERATIONS, max_add_err=err,
            cpu_jitter_spread=spread, jitter=ICC_START_JITTER,
            jitter_runs=ICC_JITTER_RUNS, atol=OCC_ADD_ATOL)))
    return row, launches


def sequence_stream_frame(f):
    return dict(rgb=f["rgb"].astype(np.float32), depth=f["depth"],
                K=f["intrinsic_matrix"], T_cam2world=f["T_cam2world"],
                instance_label=f["instance_label"],
                instance_to_class={int(i): int(c) for i, c in zip(
                    f["instance_ids"], f["class_ids"])})


def shorter_icc(pipeline_module, n_iterations, max_points=None):
    """Patch the pipeline's ICC to refine ``n_iterations`` iterations (and
    keep at most ``max_points`` points an object)."""
    base = pipeline_module.IterativeCollisionCheck

    class Shorter(base):
        def __init__(self, *args, **kw):
            if max_points:
                kw["max_points"] = max_points
            super().__init__(*args, **kw)

        def refine_async(self, iterations=30, **kw):
            super().refine_async(iterations=n_iterations, **kw)

        def refine(self, iterations=30, **kw):
            return super().refine(iterations=n_iterations, **kw)

    return mock.patch.object(pipeline_module, "IterativeCollisionCheck",
                             Shorter)


def phase_replay(device, small, counts, bank, root):
    """(b) ``cli.replay_eval`` at its defaults with ``--with-icp`` on a
    sequence it records, counted; then its first frames replayed on the
    card and the CPU, one replayed ICC problem kernel against plain, and
    the first replayed frame's ICP rows kernel against plain."""
    from morefusion_tpu_torch import runtime, training
    from morefusion_tpu_torch.cli import _eval, replay_eval
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md
    from morefusion_tpu_torch.runtime import pipeline as pipeline_module

    runs = eval_runs(os.path.join(root, "runs"), small, names=("occ",))
    occ = os.path.join(runs, "occ")
    seq = os.path.join(root, "sequence")
    argv = ["--log-dir", occ, "--sequence", seq, "--with-icp", "--out",
            os.path.join(root, "replay_eval.json"), "--device", device.type]
    if small:  # fewer frames and points, no warm-up refines; a seeded
        # tiny model's poses never agree over 3 votes
        argv += ["--n-frames", "3", "--n-objects", "2", "--image-shape",
                 "120", "160", "--n-votes", "1"]
    args = replay_eval.parse_args(argv)
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if small:
            stack.enter_context(shorter_icc(pipeline_module, 30, 128))
            stack.enter_context(mock.patch.object(
                runtime.ScenePipeline, "warmup", lambda self, *a: None))
        (summary, rows, loop_s), lines = quiet(replay_eval.main, argv)
    wall_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counts}
    n_frames = summary["n_frames"]
    check(n_frames == args.n_frames and rows,
          f"replay_eval: {n_frames} frames, {len(rows)} rows")
    for key in replay_eval.KEYS:
        check(key in summary and np.isfinite(summary[key]["mean"]),
              f"replay_eval: no {key} mean in {sorted(summary)}")
    if device.type == "cuda":
        check(launches["min_dist_voxels"] > 0 and launches["nn_indices"] > 0,
              f"replay_eval: launches {launches}")
        check(launches["min_dist_voxels"] % 30 == 0,
              f"replay_eval: {launches['min_dist_voxels']} min_dist launches"
              " are no whole number of 30-iteration refines")

    # the first frames on the card and on the CPU, deterministic, every
    # frame refined (n_votes 1) for ICC_REPLAY_ITERATIONS iterations; the
    # CPU's pass runs in a background process beside the later phases
    raw = list(runtime.load_sequence(seq))[:REPLAY_SYNC_FRAMES]
    frames = [sequence_stream_frame(f) for f in raw]
    train_args = training.load_args(occ)
    cpu_state = _eval.restore(_eval.build_model(train_args, "cpu"),
                              occ).state_dict()
    t0 = time.perf_counter()
    start_background("replay_cpu_pass", cpu_sync_pass, frames, train_args,
                     cpu_state, small, None if small else BACKGROUND_THREADS,
                     inline=small)
    del cpu_state

    def problem_kw(p, dev):
        kw = dict(p["kw"], device=dev)
        if small:
            kw["max_points"] = 128
        return kw

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with shorter_icc(pipeline_module, ICC_REPLAY_ITERATIONS,
                         128 if small else None):
            got, got_problems = run_sync_pass(
                bank, frames, _eval.restore(_eval.build_model(
                    train_args, device), occ), device, 32, 1)

        # one replayed frame's problem, kernel against plain
        p = got_problems[-1]
        iterations = ICC_PIPELINE_ITERATIONS if not small else 2
        torch.use_deterministic_algorithms(True)
        T_k, l_k, n_k = IterativeCollisionCheck(
            *p["args"], **problem_kw(p, device)).refine(
                iterations=iterations)
        with mock.patch.object(md, "min_dist_voxels",
                               md.min_dist_voxels_plain):
            T_p, l_p, n_p = IterativeCollisionCheck(
                *p["args"], **problem_kw(p, device)).refine(
                    iterations=iterations)

        # the first replayed frame's ICP rows (replay_eval's own), kernel
        # against plain, from its true poses moved 1 cm
        f0, icp_same = raw[0], []
        for k, gid in enumerate(f0["instance_ids"]):
            T_ref = f0["T_cam2world"] @ f0["Ts_cad2cam"][k]
            T_ref[:3, 3] += 0.01
            row_args = (f0, int(gid), T_ref, int(f0["class_ids"][k]), bank,
                        device)
            T_icp = replay_eval._icp_row(*row_args)
            with mock.patch.object(knn, "nn_indices", knn.nn_indices_plain):
                T_icp_plain = replay_eval._icp_row(*row_args)
            if T_icp is not None:
                icp_same.append(np.array_equal(T_icp, T_icp_plain))
    finally:
        torch.use_deterministic_algorithms(False)
    check(n_k == n_p and np.array_equal(T_k, T_p)
          and np.array_equal(l_k, l_p),
          "replay: the ICC problem's refine differs kernel against plain")
    check(icp_same and all(icp_same),
          f"replay: ICP rows kernel against plain identical {icp_same}")
    card_s = time.perf_counter() - t0

    def finish():
        """The CPU's pass against the card's, and the CPU's ICC problems
        refined on the card from the CPU's starts."""
        ((want, want_problems), cpu_s), wall_s = finish_background(
            "replay_cpu_pass")
        bad = []
        pose_err, refined_err = compare_frames(got, want, bad)
        if pose_err > PIPE_POSE_ATOL:
            bad.append(f"poses {pose_err} apart")
        if len(got_problems) != len(want_problems) or not got_problems:
            bad.append(f"{len(got_problems)} vs {len(want_problems)} "
                       "refines")
        replay = dict(pose=0.0, loss=0.0)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for gp, wp in zip(got_problems, want_problems):
                compare_problems(gp, wp, bad)
                T_g, l_g, n_g = IterativeCollisionCheck(
                    *wp["args"], **problem_kw(wp, device)).refine(
                        iterations=ICC_REPLAY_ITERATIONS)
                T_w, l_w, n_w = wp["refined"]
                replay["pose"] = max(replay["pose"], float(np.abs(
                    T_g - T_w).max()))
                replay["loss"] = max(replay["loss"], float(np.abs(
                    l_g - l_w).max()))
                if n_g != n_w:
                    bad.append(f"ICC replay n_iter {n_g} vs {n_w}")
        finally:
            torch.use_deterministic_algorithms(False)
        bound = dict(pose=PIPE_POSE_ATOL, loss=ICC_LOSS_ATOL)
        if any(replay[k] > bound[k] for k in bound):
            bad.append(f"ICC replays card vs CPU {replay}, bounds {bound}")
        check(not bad, "replay card vs cpu: " + "; ".join(bad))
        emit(dict(phase="replay_card_vs_cpu", ok=True,
                  frames=len(frames), n_votes=1,
                  icc_iterations=ICC_REPLAY_ITERATIONS,
                  max_pose_err=pose_err, refines=len(got_problems),
                  refined_from_own_starts_max_pose_err=refined_err,
                  icc_replay=dict(err=replay, bound=bound),
                  tolerance=dict(pose=PIPE_POSE_ATOL,
                                 labels_grids_spawns_problems="identical"),
                  card_s=card_s, cpu_s=cpu_s, background_wall_s=wall_s,
                  cpu_threads=None if small else BACKGROUND_THREADS))

    row = dict(argv=argv, n_frames=n_frames, n_objects=args.n_objects,
               image_shape=list(args.image_shape), wall_s=wall_s,
               loop_s=loop_s, frames_per_s=n_frames / loop_s,
               launches=launches, n_rows=len(rows),
               add_mean={k: summary[k]["mean"] for k in replay_eval.KEYS},
               summary=summary,
               card_vs_cpu="the CPU's pass runs in a background process, "
                           "checked in the line replay_card_vs_cpu",
               icc_kernel_vs_plain=dict(objects=len(p["args"][0]),
                                        iterations=iterations, n_iter=n_k,
                                        tolerance="identical"),
               icp_kernel_vs_plain=dict(rows=len(icp_same),
                                        tolerance="identical"))
    return row, launches, finish


def cpu_sync_pass(frames, train_args, state, small, threads):
    """Phase 14's CPU pass of the replayed frames (``run_sync_pass`` in
    deterministic mode, ICC at ``ICC_REPLAY_ITERATIONS``), in a background
    process on ``threads`` threads (None leaves them); returns its result
    and seconds."""
    from morefusion_tpu_torch.cli import _eval
    from morefusion_tpu_torch.contrib import mapping_native
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.runtime import pipeline as pipeline_module

    if threads:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    mapping_native.load_library()
    model = _eval.build_model(train_args, "cpu")
    model.load_state_dict(state, strict=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with shorter_icc(pipeline_module, ICC_REPLAY_ITERATIONS,
                         128 if small else None):
            out = run_sync_pass(ProceduralModels(), frames, model, "cpu", 32,
                                1)
    finally:
        torch.use_deterministic_algorithms(False)
    return out, time.perf_counter() - t0


def phase_unpadded_icc(device, small, counts):
    """(c) ``IterativeCollisionCheck(pad_objects=False)`` on 5 objects,
    kernel against plain, counted and timed beside the padded refine (8
    slots)."""
    from morefusion_tpu_torch.contrib import IterativeCollisionCheck
    from morefusion_tpu_torch.ops import min_dist as md

    N, M, V = (5, 2048, 32) if not small else (5, 256, 16)
    scene = make_icc_scene(5, N, M, V)

    def icc(pad):
        return IterativeCollisionCheck(*scene, voxel_dim=V, max_points=M,
                                       pad_objects=pad, device=device)

    check(icc(False)._arrays["points"].shape[0] == N
          and icc(True)._arrays["points"].shape[0] == 8,
          "unpadded icc: object slots")
    torch.use_deterministic_algorithms(True)
    try:
        T_k, l_k, n_k = icc(False).refine()
        with mock.patch.object(md, "min_dist_voxels",
                               md.min_dist_voxels_plain):
            T_p, l_p, n_p = icc(False).refine()
    finally:
        torch.use_deterministic_algorithms(False)
    check(n_k == n_p and np.array_equal(T_k, T_p)
          and np.array_equal(l_k, l_p),
          "unpadded icc: kernel and plain refines differ")
    for c in counts:
        c.launches = 0
    icc(False).refine()
    launches = {c.__name__: c.launches for c in counts}
    if device.type == "cuda":
        check(launches["min_dist_voxels"] == 30,
              f"unpadded icc: {launches['min_dist_voxels']} launches")
    reps = 4 if not small else 1
    refine_ms = {}
    for name, pad in (("unpadded", False), ("padded", True),
                      ("unpadded_again", False), ("padded_again", True)):
        iccs = [icc(pad) for _ in range(reps)]
        sync(device)
        t0 = time.perf_counter()
        for x in iccs:
            x.refine()
        sync(device)
        refine_ms[name] = (time.perf_counter() - t0) * 1e3 / reps
    return dict(objects=N, points=M, voxel_dim=V, n_iter=n_k,
                kernel_vs_plain="identical", launches=launches,
                refine_ms_in_turns=refine_ms), launches


def function_inputs(cfg, device, seed=0):
    g = np.random.RandomState(seed)
    B, P, V, C = cfg["B"], cfg["P"], cfg["V"], cfg["C"]
    n = B * P
    return {k: torch.from_numpy(v).to(device) for k, v in dict(
        values=g.normal(size=(n, C)).astype(np.float32),
        points=g.uniform(-0.02, 0.34, (n, 3)).astype(np.float32),
        batch=np.repeat(np.arange(B), P).astype(np.int32),
        intensities=g.rand(n).astype(np.float32),
        grid=g.normal(size=(B, V, V, V, C)).astype(np.float32),
        vox=g.uniform(-1.0, V + 0.5, (n, 3)).astype(np.float32),
        cot=g.normal(size=(n, C)).astype(np.float32)).items()}


def phase_functions(device, small):
    """(d) ``max_voxelization_3d``, ``interpolate_voxel_grid_sorted``
    (forward and backward) and ``truncated_distance_function_scatter`` on
    the card against the CPU at the train step's shapes, each timed; the
    interpolation's backward run twice on the card."""
    from morefusion_tpu_torch import functions as F
    from morefusion_tpu_torch.functions import tdf as tdf_module

    cfg = FUNC_SMALL if small else FUNC_FULL
    B, P, V = cfg["B"], cfg["P"], cfg["V"]
    x = {dev: function_inputs(cfg, dev) for dev in (device, "cpu")}
    vox_kw = dict(batch_size=B, origin=(0.0, 0.0, 0.0), pitch=0.01,
                  dimensions=V)

    def max_vox(a):
        v = a["values"].clone().requires_grad_(True)
        grid, idx = F.max_voxelization_3d(v, a["points"], a["batch"],
                                          a["intensities"], **vox_kw,
                                          return_indices=True)
        grid.sum().backward()
        return grid.detach(), idx, v.grad

    def interp(fn, a):
        g = a["grid"].clone().requires_grad_(True)
        p = a["vox"].clone().requires_grad_(True)
        out = fn(g, p, a["batch"])
        (out * a["cot"]).sum().backward()
        return out.detach(), g.grad, p.grad

    def tdf(a):
        return [tdf_module.truncated_distance_function_scatter(
            a["points"][b * P:(b + 1) * P], pitch=0.01, origin=(0.0,) * 3,
            dims=(V,) * 3, truncation=0.02, return_indices=True)
            for b in range(B)]

    def rel(got, want):
        got = got.cpu()
        return float((got - want).abs().max() / want.abs().max().clamp_min(
            1e-30))

    out = {}
    g, w = max_vox(x[device]), max_vox(x["cpu"])
    check(all(torch.equal(a.cpu(), b) for a, b in zip(g, w)),
          "max_voxelization_3d: card and CPU differ")
    out["max_voxelization_3d"] = dict(identical=True, winners=int(
        (w[1] >= 0).sum()))
    g = interp(F.interpolate_voxel_grid_sorted, x[device])
    w = interp(F.interpolate_voxel_grid_sorted, x["cpu"])
    errs = [rel(a, b) for a, b in zip(g, w)]
    check(max(errs) <= FUNC_ATOL,
          f"interpolate_voxel_grid_sorted: card vs CPU {errs}")
    again = interp(F.interpolate_voxel_grid_sorted, x[device])
    check(all(torch.equal(a, b) for a, b in zip(g, again)),
          "interpolate_voxel_grid_sorted: two backward passes on the card "
          "differ")
    out["interpolate_voxel_grid_sorted"] = dict(
        rel_err=dict(zip(("values", "grid_grad", "points_grad"), errs)),
        backward_repeatable=True)
    g, w = tdf(x[device]), tdf(x["cpu"])
    t_err = max(rel(a[0], b[0]) for a, b in zip(g, w))
    check(t_err <= FUNC_ATOL and all(torch.equal(a[1].cpu(), b[1])
                                     for a, b in zip(g, w)),
          f"truncated_distance_function_scatter: card vs CPU {t_err}")
    out["truncated_distance_function_scatter"] = dict(
        lanes=B, rel_err=t_err, winners_identical=True)
    if device.type == "cuda":
        a = x[device]
        out["ms"] = dict(
            max_voxelization_3d=cuda_ms(lambda: max_vox(a), 10),
            interpolate_voxel_grid_sorted=cuda_ms(
                lambda: interp(F.interpolate_voxel_grid_sorted, a), 10),
            truncated_distance_function_scatter_16_lanes=cuda_ms(
                lambda: tdf(a), 5))
    return dict(shape=cfg, **out)


def phase_host_tools(device, small, counts, fit_root, root):
    """(e) ``cli.stratify_results`` on phase 12's dump and phase 11's val
    set, ``cli.rescore_results`` on the val set's true poses and a
    perturbed copy, ``cli.align_pointclouds`` at its defaults, counted."""
    from morefusion_tpu_torch.cli import (
        align_pointclouds,
        rescore_results,
        stratify_results,
    )
    from morefusion_tpu_torch.geometry import quaternion_matrix_np
    from morefusion_tpu_torch.ops import knn

    out = {}
    val = os.path.join(fit_root, "val")
    scalars = dict(np.load(os.path.join(val, "scalars.npz")))
    dump = read_json(evaluation_dump(fit_root))
    n = len(dump["records"]["morefusion"]["class_id"])
    if n < len(scalars["class_id"]):  # the rehearsal evaluates a few crops
        val = os.path.join(root, "val_cut")
        os.makedirs(val)
        np.savez(os.path.join(val, "scalars.npz"),
                 **{k: v[:n] for k, v in scalars.items()})
    report, lines = quiet(stratify_results.main, [
        "--artifact", evaluation_dump(fit_root), "--val-packed", val,
        "--out", os.path.join(root, "strata.json")])
    check(sorted(report["methods"]) == ["morefusion", "morefusion+icp"]
          and all(np.isfinite(m["macro_auc"])
                  for m in report["methods"].values()),
          f"stratify_results: {report}")
    out["stratify_results"] = dict(crops=n, report=report)

    g = np.random.RandomState(0)
    gts, results = [], []
    for i, (cid, q, t) in enumerate(zip(scalars["class_id"],
                                        scalars["quaternion_true"],
                                        scalars["translation_true"])):
        T = quaternion_matrix_np(q)
        T[:3, 3] = t
        gts.append(dict(image_id=f"{i:06d}", class_id=int(cid),
                        T_cad2cam=T.ravel().tolist()))
        dT = np.eye(4)
        dT[:3, :3] = random_rotation_near(g, 0.05)
        dT[:3, 3] = g.normal(0, 0.01, 3)
        results.append(dict(gts[-1], T_cad2cam=(T @ dT).ravel().tolist()))
    paths = {}
    for name, rows in (("gt", gts), ("results", results)):
        paths[name] = os.path.join(root, name + ".json")
        with open(paths[name], "w") as f:
            json.dump(rows, f)
    summary, lines = quiet(rescore_results.main, [
        "--results", paths["results"], "--ground-truth", paths["gt"]])
    auc = summary["main/add_or_add_s/auc"]
    check(0.0 < auc < 1.0, f"rescore_results: ADD(-S) AUC {auc}")
    out["rescore_results"] = dict(records=len(gts), perturbation=dict(
        rotation="random_rotation_near 0.05", translation_m=0.01),
        add_or_add_s_auc=auc, add_s_auc=summary["main/add_s/auc"],
        line=lines[-1])

    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    (adds_init, adds_icp), lines = quiet(
        align_pointclouds.main, ["--device", device.type])
    wall_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counts}
    check(adds_icp and np.isfinite(adds_icp).all(),
          f"align_pointclouds: {lines}")
    if device.type == "cuda":
        check(0 < launches["nn_indices"] <= 50 * len(adds_icp),
              f"align_pointclouds: {launches['nn_indices']} knn launches")
    # kernel against plain, deterministic
    torch.use_deterministic_algorithms(True)
    try:
        adds_k = quiet(align_pointclouds.main, ["--device", device.type])[0]
        with mock.patch.object(knn, "nn_indices", knn.nn_indices_plain):
            adds_p = quiet(align_pointclouds.main,
                           ["--device", device.type])[0]
    finally:
        torch.use_deterministic_algorithms(False)
    check(adds_k == adds_p, f"align_pointclouds: ADDs kernel {adds_k} "
                            f"against plain {adds_p}")
    out["align_pointclouds"] = dict(
        instances=len(adds_icp), mean_add_init=float(np.mean(adds_init)),
        mean_add_icp=float(np.mean(adds_icp)), wall_s=wall_s,
        launches=launches, kernel_vs_plain="identical")
    return out, launches


def phase_replay_and_tools(device, small, counts, fit_root):
    """Phase 14: replay, occupancy registration and the offline tools, (a)
    to (e); returns each path's launches."""
    import shutil

    from morefusion_tpu_torch.datasets import ProceduralModels

    t0 = time.perf_counter()
    root = os.path.join(fit_root, "replay")
    os.makedirs(root)
    bank = ProceduralModels()
    seconds = {}
    t = time.perf_counter()
    occupancy, occ_launches = phase_occupancy(device, small, counts, bank)
    seconds["occupancy"] = time.perf_counter() - t
    t = time.perf_counter()
    replay, replay_launches, finish_replay = phase_replay(
        device, small, counts, bank, root)
    seconds["replay"] = time.perf_counter() - t
    t = time.perf_counter()
    unpadded, unpadded_launches = phase_unpadded_icc(device, small, counts)
    seconds["unpadded_icc"] = time.perf_counter() - t
    t = time.perf_counter()
    functions = phase_functions(device, small)
    seconds["functions"] = time.perf_counter() - t
    t = time.perf_counter()
    tools, align_launches = phase_host_tools(device, small, counts, fit_root,
                                             root)
    seconds["host_tools"] = time.perf_counter() - t
    shutil.rmtree(root)
    seconds["total"] = time.perf_counter() - t0
    emit(dict(phase="replay_and_tools", ok=True, device=str(device),
              occupancy=occupancy, replay=replay, unpadded_icc=unpadded,
              functions=functions, host_tools=tools, seconds=seconds))
    return dict(occupancy_registration=occ_launches, replay=replay_launches,
                unpadded_icc=unpadded_launches,
                align_pointclouds=align_launches), occupancy, finish_replay


# -------------------------------------------------------------- phase 15

# the robot side (phase 15): the ROS node's frames (phase 9's three views
# in turn, one more for the profiler), the pick episode's scene, scan and
# robot
ROS_FRAMES = 12
ROBOT_SCENE_SEED = 4
ROBOT_OBJECTS = 6
ROBOT_SCAN_VIEWS = 7
# JAX's planning-scene tests' tool: at the defaults (a 4 cm sphere, 1 cm
# clearance) no grasp in a pile of six is reachable, in either package
ROBOT_TOOL = dict(ee_radius=0.01, min_clearance=0.005)
ROBOT_GRASP_RESULTS = (False, False)  # two failed seals: one re-scan
# after a failed seal the robot stands inside the object it released and no
# motion plans out of it (JAX's planner does the same): later picks would
# only repeat re-scans
ROBOT_MAX_PICKS = 2
ROBOT_MATCH_M = 0.30  # a track is the same-class true object this near
# the node's pipeline as bench.py and phases 9 and 10 run it: at main's
# defaults the reference's size filter (a bbox of 40 x 40 px at least at
# 240x320) drops every object of these scenes (~30 x 30 px), in JAX too
NODE_PIPELINE = dict(size_filter=False)


def tf_quaternion_matrix(rot):
    """``tf.transformations.quaternion_matrix``: x, y, z, w."""
    from morefusion_tpu_torch.geometry import quaternion_matrix_np

    x, y, z, w = rot
    return quaternion_matrix_np([w, x, y, z])


def tf_of(T):
    """(translation, x-y-z-w rotation) of a pose, as TF gives them."""
    from morefusion_tpu_torch.geometry import quaternion_from_matrix

    w, x, y, z = quaternion_from_matrix(T)
    return tuple(T[:3, 3]), (x, y, z, w)


@contextlib.contextmanager
def modules_patched(mods):
    """``mods`` in ``sys.modules`` for the block, these names only:
    ``mock.patch.dict`` would also drop what the block imported, and cv2
    does not import twice in a process."""
    saved = {name: sys.modules.get(name) for name in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


class RosStubs:
    """Stub ``rospy``, ``cv_bridge``, ``message_filters``, ``tf`` and
    message modules, as ``tests/runtime_tests/test_ros_adapter.py``:
    messages carry their arrays, TF gives each stamp's camera pose,
    ``rospy.get_param`` reads ``params``, and ``rospy.spin`` calls
    ``self.spin`` with the callback the node registered."""

    def __init__(self, params, camera_poses):
        self.params, self.camera_poses = params, camera_poses
        self.published, self.callbacks = [], []
        self.spin = None

    def installed(self):
        stubs = self
        mods = {name: types.ModuleType(name) for name in (
            "rospy", "cv_bridge", "message_filters", "tf",
            "tf.transformations", "geometry_msgs", "geometry_msgs.msg",
            "sensor_msgs", "sensor_msgs.msg")}
        rospy = mods["rospy"]
        rospy.Duration = lambda s: s
        rospy.init_node = lambda name: None
        rospy.get_param = lambda name, *default: stubs.params.get(
            name, *default)
        rospy.spin = lambda: stubs.spin(stubs.callbacks[-1])

        class Publisher:
            def __init__(self, topic, msg_type, queue_size=1):
                pass

            def publish(self, msg):
                stubs.published.append(msg)

        rospy.Publisher = Publisher

        class CvBridge:
            def imgmsg_to_cv2(self, msg, desired_encoding=None):
                return msg.data

        mods["cv_bridge"].CvBridge = CvBridge

        class Synchronizer:
            def __init__(self, subs, queue_size=5, slop=0.1):
                pass

            def registerCallback(self, cb):
                stubs.callbacks.append(cb)

        mods["message_filters"].Subscriber = lambda topic, msg_type: topic
        mods["message_filters"].ApproximateTimeSynchronizer = Synchronizer

        class TransformListener:
            def __init__(self, cache_time=None):
                pass

            def lookupTransform(self, target, source, stamp):
                return tf_of(stubs.camera_poses[stamp])

        mods["tf"].TransformListener = TransformListener
        mods["tf.transformations"].quaternion_matrix = tf_quaternion_matrix
        mods["tf"].transformations = mods["tf.transformations"]

        class Vec:
            x = y = z = w = 0.0

        class Pose:
            def __init__(self):
                self.position, self.orientation = Vec(), Vec()

        class PoseArray:
            def __init__(self):
                self.header = types.SimpleNamespace(stamp=None, frame_id=None)
                self.poses = []

        mods["geometry_msgs.msg"].Pose = Pose
        mods["geometry_msgs.msg"].PoseArray = PoseArray
        mods["geometry_msgs"].msg = mods["geometry_msgs.msg"]
        mods["sensor_msgs.msg"].CameraInfo = object
        mods["sensor_msgs.msg"].Image = object
        mods["sensor_msgs"].msg = mods["sensor_msgs.msg"]
        return modules_patched(mods)


def ros_messages(frame, stamp):
    """A stream frame as the camera sends it: rgb8, depth in uint16
    mm (0 where there is none), ``CameraInfo.K``."""
    header = types.SimpleNamespace(frame_id="camera", stamp=stamp)
    depth_mm = np.round(np.nan_to_num(frame["depth"], nan=0.0) * 1000.0)
    return (types.SimpleNamespace(data=frame["rgb"].astype(np.uint8),
                                  header=header),
            types.SimpleNamespace(data=depth_mm.astype(np.uint16),
                                  header=header),
            types.SimpleNamespace(K=list(frame["K"].ravel()), header=header))


def node_inputs(frame, stamp):
    """What the node hands ``process_frame`` for these messages: mm to m
    with 0 as NaN, K from ``CameraInfo``, the camera pose through TF."""
    rgb_msg, depth_msg, info = ros_messages(frame, stamp)
    depth = depth_msg.data.astype(np.float32) / 1000.0
    depth[depth == 0] = np.nan
    trans, rot = tf_of(frame["T_cam2world"])
    T = tf_quaternion_matrix(rot)
    T[:3, 3] = trans
    return (rgb_msg.data.astype(np.float32), depth,
            np.asarray(info.K, np.float64).reshape(3, 3), T)


def published_rows(results):
    """(n, 7) positions and w-x-y-z quaternions the node publishes for a
    pipeline's results: the refined pose where there is one."""
    from morefusion_tpu_torch.geometry import quaternion_from_matrix

    rows = []
    for res in results.values():
        T = res.get("T_cad2world_refined", res.get("T_cad2world"))
        rows.append(np.concatenate([T[:3, 3], quaternion_from_matrix(T)]))
    return np.array(rows).reshape(-1, 7)


def message_rows(msg):
    return np.array([[p.position.x, p.position.y, p.position.z,
                      p.orientation.w, p.orientation.x, p.orientation.y,
                      p.orientation.z] for p in msg.poses]).reshape(-1, 7)


@contextlib.contextmanager
def tiny_pose_models(small):
    """In the rehearsal, ``SingleView3D`` built by the ROS node's ``main``
    is the tiny one (full width is for the card)."""
    if not small:
        yield
        return
    from morefusion_tpu_torch import models

    full = models.SingleView3D

    def tiny(n_fg_class, **kw):
        with mock.patch.object(models, "SingleView3D", full):
            return models.tiny_singleview3d(n_fg_class, **kw)

    with mock.patch.object(models, "SingleView3D", tiny):
        yield


def profile_callback(callback, messages, root):
    """(d) One node callback inside ``utils.profiling.trace``: the Chrome
    trace's events, its kernels and the min_dist kernel's among them."""
    import glob

    from morefusion_tpu_torch.utils import profiling

    logdir = os.path.join(root, "trace")
    with profiling.trace(logdir):
        with profiling.annotate("ros_callback"):
            callback(*messages)
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    min_dist = [k for k in kernels if "min_dist" in k]
    return dict(events=len(events), kernel_events=len(kernels),
                min_dist_kernel_events=len(min_dist),
                min_dist_kernels=sorted(set(min_dist)),
                annotated=sum(e.get("name") == "ros_callback"
                              for e in events))


def phase_ros_node(device, small, counts, frames, occ_run, seg_run, root):
    """(a) The ROS node through ``runtime.ros_adapter.main`` on stub ROS
    modules, fed ``ROS_FRAMES`` frames at ``main``'s 3 votes (again at 1
    where no track spawns, as phase 9), in deterministic mode; a second
    ``main`` builds the same pipeline, fed the same frames directly. (d)
    the first callback that refines, on a third node fed the frames before
    it, under the profiler (the node's last frames may refine nothing once
    every object has spawned). Prints both lines; returns the min_dist
    launches and the first node's pipeline."""
    from morefusion_tpu_torch import runtime
    from morefusion_tpu_torch.runtime import pipeline as pipeline_module
    from morefusion_tpu_torch.runtime import ros_adapter

    stream = [frames[k % len(frames)] for k in range(ROS_FRAMES + 1)]
    stubs = RosStubs(
        {"~log_dir": occ_run, "~segmentation_log_dir": seg_run,
         "~device": device.type},
        {float(k): f["T_cam2world"] for k, f in enumerate(stream)})
    callback_ms, launches, direct, problems = [], {}, [], []
    refined_by = []  # the refines after each callback
    trace = {}

    def feed(callback):
        for c in counts:
            c.launches = 0
        for k, f in enumerate(stream[:ROS_FRAMES]):
            messages = ros_messages(f, float(k))
            sync(device)
            t0 = time.perf_counter()
            callback(*messages)
            callback_ms.append((time.perf_counter() - t0) * 1e3)
            refined_by.append(len(problems))
        launches.update({c.__name__: c.launches for c in counts})

    def profiled(callback):
        """The frames up to the first that refined, the last under the
        profiler."""
        first = next((k for k, n in enumerate(refined_by) if n), 0)
        for k in range(first):
            callback(*ros_messages(stream[k], float(k)))
        before = len(problems)
        with record_icc(pipeline_module, problems):
            trace.update(profile_callback(
                callback, ros_messages(stream[first], float(first)), root))
        trace.update(frame=first, refines=len(problems) - before)

    def process(callback):
        pipe = callback.__self__._pipeline
        for k, f in enumerate(stream[:ROS_FRAMES]):
            direct.append(published_rows(
                pipe.process_frame(*node_inputs(f, float(k)))))

    def built_with(kw):
        return mock.patch.object(runtime, "ScenePipeline", functools.partial(
            runtime.ScenePipeline, **kw))

    with stubs.installed(), tiny_pose_models(small):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            # main's 3 votes, or 1 where no track spawns (as phase 9)
            for n_votes in (3, 1):
                kw = dict(NODE_PIPELINE, n_votes=n_votes)
                del callback_ms[:], problems[:], stubs.published[:]
                del refined_by[:]
                with built_with(kw), record_icc(pipeline_module, problems):
                    stubs.spin = feed
                    t0 = time.perf_counter()
                    ros_adapter.main()
                    main_s = time.perf_counter() - t0
                if problems or small:
                    break
            refines = len(problems)
            node_callback = stubs.callbacks[-1]
            published = list(stubs.published)
            with built_with(kw):
                stubs.spin = process
                ros_adapter.main()
            with built_with(kw):
                stubs.spin = profiled
                ros_adapter.main()
        finally:
            torch.use_deterministic_algorithms(False)
    same = [np.array_equal(message_rows(m), w)
            for m, w in zip(published, direct)]
    n_md = launches["min_dist_voxels"]
    out = dict(frames=ROS_FRAMES, frame=list(frames[0]["depth"].shape),
               objects=len(frames[0]["instance_to_class"]),
               pipeline=kw, n_votes_note=None if kw["n_votes"] == 3 else
               "no track spawned at main's n_votes=3 over these frames",
               node_fps=ROS_FRAMES / (sum(callback_ms) / 1e3),
               node_fps_after_first=(ROS_FRAMES - 1) / (
                   sum(callback_ms[1:]) / 1e3),
               callback_ms=callback_ms,
               build_s=main_s - sum(callback_ms) / 1e3,
               poses_published=[len(m.poses) for m in published],
               refines=refines, launches=launches,
               node_equals_direct_pipeline=all(same))
    bad = []
    if not len(published) == len(direct) == ROS_FRAMES:
        bad.append(f"{len(published)} messages, {len(direct)} direct")
    if not all(same):
        bad.append("published poses differ from the direct pipeline's at "
                   f"frames {[k for k, s in enumerate(same) if not s]}")
    if device.type == "cuda":  # the rehearsal's segmenter finds little
        if not sum(out["poses_published"]):
            bad.append("no pose published")
        if not refines:
            bad.append("no ICC refine ran")
        if n_md != 30 * refines:
            bad.append(f"{n_md} min_dist launches for {refines} refines of "
                       "30 iterations")
    emit(dict(phase="robot_ros_node", ok=not bad, device=str(device), **out))
    check(not bad, "ros node: " + "; ".join(bad))
    bad = [] if trace["annotated"] else ["the annotated span is missing"]
    if device.type == "cuda" and not any(
            "min_dist_split_kernel" in k for k in trace["min_dist_kernels"]):
        bad.append("no min_dist kernel in the trace")
    emit(dict(phase="robot_profiler", ok=not bad, device=str(device),
              **trace))
    check(not bad, "profiler: " + "; ".join(bad))
    return n_md, node_callback.__self__._pipeline


def robot_scene(small):
    """``ROBOT_OBJECTS`` objects of ``PlaneTypeSceneGeneration(RandomState(
    ROBOT_SCENE_SEED))`` and their renders from ``scan_poses``' views; the
    planning camera is the first view; the target, the object with the most
    occluders under the true poses from it (the lowest id on a tie)."""
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.runtime import (
        PickAndPlacePlanner,
        build_occlusion_graph,
    )
    from morefusion_tpu_torch.simulation import PlaneTypeSceneGeneration

    shape, n_points = ((240, 320), 20000) if not small else ((120, 160), 6000)
    bank = ProceduralModels()
    gen = PlaneTypeSceneGeneration(
        bank, n_object=ROBOT_OBJECTS,
        random_state=np.random.RandomState(ROBOT_SCENE_SEED))
    gen.generate()
    scan = PickAndPlacePlanner(bank).scan_poses(n=ROBOT_SCAN_VIEWS)
    views = []
    for T in scan:
        f = gen.render_frame(T, shape=shape, n_points_per_object=n_points)
        views.append(dict(
            rgb=f["rgb"].astype(np.float32), depth=f["depth"],
            K=f["intrinsic_matrix"], T_cam2world=f["T_cam2world"],
            instance_label=f["instance_label"],
            instance_to_class={int(i): int(f["class_ids"][k])
                               for k, i in enumerate(f["instance_ids"])}))
    truth = {int(i): dict(class_id=int(o["class_id"]),
                          T_cad2world=o["T_cad2world"])
             for i, o in gen.objects.items()}
    ids = sorted(truth)
    T_w2c = np.linalg.inv(scan[0])
    occluded_by = build_occlusion_graph(
        bank, [truth[i]["class_id"] for i in ids],
        [T_w2c @ truth[i]["T_cad2world"] for i in ids], views[0]["K"], shape)
    target = ids[max(range(len(ids)),
                     key=lambda k: (len(occluded_by[k]), -k))]
    down = np.diag([1.0, -1.0, -1.0, 1.0])  # the tool's z-axis down
    places = {}
    for k, i in enumerate(ids):
        places[i] = down.copy()
        places[i][:3, 3] = [0.45, -0.3 + 0.15 * k, 0.2]
    home = down.copy()
    home[:3, 3] = [0.0, 0.0, 0.5]
    return dict(bank=bank, views=views, truth=truth, target=target,
                occluders=sorted(ids[j] for j in
                                 occluded_by[ids.index(target)]),
                shape=shape, places=places, home=home)


def scan_poses_of(pipe, scene, placed):
    """A fresh perception pass: the pipeline (reset) over the scan's views
    with their labels, refining as it goes; each track's last refined world
    pose, keyed by the true instance it matches (the nearest same-class
    object within ``ROBOT_MATCH_M``), without those already placed."""
    pipe.reset()
    refined = {}
    for f in scene["views"]:
        res = pipe.process_frame(
            f["rgb"], f["depth"], f["K"], f["T_cam2world"],
            instance_label=f["instance_label"],
            instance_to_class=f["instance_to_class"], refine=True)
        for i, r in res.items():
            if "T_cad2world_refined" in r:
                refined[i] = (r["class_id"], r["T_cad2world_refined"])
    poses, dist = {}, {}
    for class_id, T in refined.values():
        near = [(float(np.linalg.norm(T[:3, 3] - o["T_cad2world"][:3, 3])),
                 i) for i, o in scene["truth"].items()
                if o["class_id"] == class_id]
        d, gid = min(near, default=(np.inf, None))
        if d < ROBOT_MATCH_M and gid not in placed and d < dist.get(
                gid, np.inf):
            poses[gid], dist[gid] = dict(class_id=class_id, T_cad2world=T), d
    return poses


def mean_add(poses, scene):
    """Mean ADD (ADD-S for symmetric classes) of scanned poses against the
    truth, over 500 CAD points an object."""
    from morefusion_tpu_torch.datasets.ycb_video.class_names import (
        class_ids_symmetric,
    )
    from morefusion_tpu_torch.metrics import average_distance

    adds = []
    for gid, p in sorted(poses.items()):
        cad = scene["bank"].get_pcd(p["class_id"])[:500]
        add, add_s = average_distance(
            [cad], [scene["truth"][gid]["T_cad2world"]], [p["T_cad2world"]])
        adds.append(float(add_s[0] if p["class_id"] in class_ids_symmetric
                          else add[0]))
    return float(np.mean(adds)) if adds else None


def pick_episode(pipe, scene, device):
    """(b) ``PickAndPlaceStateMachine`` over ``CollisionAwareRobot(
    SimulatedRobotInterface(grasp_results=ROBOT_GRASP_RESULTS),
    PlanningScene(bank, **ROBOT_TOOL))``, each scan a perception pass of
    ``pipe`` on the card. Returns what it decided and what it took."""
    from morefusion_tpu_torch.runtime import (
        CollisionAwareRobot,
        PickAndPlacePlanner,
        PickAndPlaceStateMachine,
        PlanningScene,
        SimulatedRobotInterface,
    )

    bank = scene["bank"]
    clock = HostClock()
    planner = PickAndPlacePlanner(bank)
    world = PlanningScene(bank, **ROBOT_TOOL)
    world.plan_motion = clock.wrap("plan_motion", world.plan_motion)
    inner = SimulatedRobotInterface(grasp_results=list(ROBOT_GRASP_RESULTS))
    robot = CollisionAwareRobot(inner, world, T_home=scene["home"])
    rec = dict(scans=[], scan_ms=[], add=[], plans=[])
    machine = None

    def provider():
        placed = {o.instance_id for o in machine.outcomes
                  if o.status != "skipped"}
        sync(device)
        t0 = time.perf_counter()
        poses = scan_poses_of(pipe, scene, placed)
        sync(device)
        rec["scan_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["scans"].append(poses)
        rec["add"].append(mean_add(poses, scene))
        world.update_from_poses(poses)
        return dict(poses=dict(poses), K=scene["views"][0]["K"],
                    T_cam2world=scene["views"][0]["T_cam2world"],
                    image_shape=scene["shape"], place_poses=scene["places"])

    plan_picks = clock.wrap("plan_picks", planner.plan_picks)

    def planned(*args, **kw):
        rec["plans"].append(plan_picks(*args, **kw))
        return rec["plans"][-1]

    planner.plan_picks = planned
    machine = PickAndPlaceStateMachine(
        planner, robot, provider, target_instance=scene["target"],
        max_picks=ROBOT_MAX_PICKS)
    t0 = time.perf_counter()
    rec["outcomes"] = [(o.instance_id, o.status, o.grasp_attempts,
                        o.rescans) for o in machine.run()]
    rec["s"] = time.perf_counter() - t0
    rec["log"] = inner.log
    rec["clock"] = clock
    return rec


def same_episode(got, want):
    """Where two episodes differ: outcomes, scanned poses, plans, the
    robot's commands (poses bit for bit)."""
    bad = []
    if got["outcomes"] != want["outcomes"]:
        bad.append("outcomes")
    if [sorted(s) for s in got["scans"]] != [sorted(s) for s in
                                              want["scans"]] or any(
            not np.array_equal(g[i]["T_cad2world"], w[i]["T_cad2world"])
            for g, w in zip(got["scans"], want["scans"]) for i in g):
        bad.append("scanned poses")
    keys = ("instance_id", "class_id", "grasp_pose", "pre_grasp_pose",
            "lift_pose", "place_pose")
    if len(got["plans"]) != len(want["plans"]) or any(
            len(g) != len(w) or any(
                not np.array_equal(getattr(a, k), getattr(b, k))
                for a, b in zip(g, w) for k in keys)
            for g, w in zip(got["plans"], want["plans"])):
        bad.append("plans")
    if len(got["log"]) != len(want["log"]) or any(
            g[0] != w[0] or (g[0] == "move_to" and not (
                np.array_equal(g[1], w[1]) and g[2:] == w[2:]))
            or (g[0] != "move_to" and g != w)
            for g, w in zip(got["log"], want["log"])):
        bad.append("waypoints")
    return bad


def phase_pick_episode(device, small, counts, pipe):
    """(b) The pick episode with the kernels, counted and timed, then again
    with min_dist's plain version; both in deterministic mode. Prints its
    line; returns the min_dist launches."""
    from morefusion_tpu_torch.ops import min_dist as md

    t0 = time.perf_counter()
    scene = robot_scene(small)
    scene_s = time.perf_counter() - t0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for c in counts:
            c.launches = 0
        got = pick_episode(pipe, scene, device)
        launches = {c.__name__: c.launches for c in counts}
        with mock.patch.object(md, "min_dist_voxels",
                               md.min_dist_voxels_plain):
            want = pick_episode(pipe, scene, device)
    finally:
        torch.use_deterministic_algorithms(False)
    bad = same_episode(got, want)
    outcomes = got["outcomes"]
    target = scene["target"]
    clock = got["clock"]
    out = dict(objects=ROBOT_OBJECTS, seed=ROBOT_SCENE_SEED,
               frame=list(scene["shape"]), scan_views=ROBOT_SCAN_VIEWS,
               tool=ROBOT_TOOL, grasp_results=list(ROBOT_GRASP_RESULTS),
               max_picks=ROBOT_MAX_PICKS, target=target,
               target_occluders=scene["occluders"],
               outcomes=[dict(zip(("instance", "status", "grasp_attempts",
                                   "rescans"), o)) for o in outcomes],
               target_reached=any(o[0] == target and o[1] != "skipped"
                                  for o in outcomes),
               picks_until_target=next(
                   (k + 1 for k, o in enumerate(outcomes)
                    if o[0] == target), None),
               scans=len(got["scans"]), scan_ms=got["scan_ms"],
               scanned_objects=[len(s) for s in got["scans"]],
               mean_add_m=got["add"],
               plan_picks=dict(calls=clock.calls.get("plan_picks", 0),
                               ms=clock.ms.get("plan_picks", 0.0)),
               plan_motion=dict(calls=clock.calls.get("plan_motion", 0),
                                ms=clock.ms.get("plan_motion", 0.0)),
               robot_commands=len(got["log"]), episode_s=got["s"],
               plain_episode_s=want["s"], scene_s=scene_s,
               launches=launches,
               kernel_vs_plain="identical" if not bad else bad)
    bad = [f"with min_dist's plain version the {b} differ" for b in bad]
    if device.type == "cuda":  # the rehearsal's random model maps little
        if len(got["scans"]) < 2:
            bad.append("the re-scan never ran")
        if not launches["min_dist_voxels"]:
            bad.append("the min_dist kernel was never launched")
    emit(dict(phase="robot_pick_episode", ok=not bad, device=str(device),
              **out))
    check(not bad, "pick episode: " + "; ".join(bad))
    return launches["min_dist_voxels"]


def phase_demo(device, small, counts, occ_run, root):
    """(c) ``cli.demo --refine --log-dir <occ run>`` at its defaults (the
    tiny model in the rehearsal): the PNG, its panes, ms, launches. Prints
    its line; returns the min_dist launches."""
    import cv2

    from morefusion_tpu_torch.cli import demo
    from morefusion_tpu_torch.extra import viz

    path = os.path.join(root, "demo.png")
    argv = ["--refine", "--log-dir", occ_run, "--out", path, "--device",
            device.type] + (["--tiny"] if small else [])
    for c in counts:
        c.launches = 0
    sync(device)
    t0 = time.perf_counter()
    results, lines = quiet(demo.main, argv)
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {c.__name__: c.launches for c in counts}
    check(os.path.isfile(path), "demo: no PNG written")
    panel = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
    W = panel.shape[1] // 3
    out = dict(ms=ms, poses=len(results), png_shape=list(panel.shape),
               image_writer=viz.image_writer(),
               overlay_pixels_changed=int(
                   (panel[:, 2 * W:] != panel[:, :W]).any(axis=2).sum()),
               launches=launches, refined=sum(
                   "T_cad2world_refined" in r for r in results.values()),
               printed=lines)
    bad = [] if panel.shape == (240, 960, 3) else [
        f"a PNG of {panel.shape}"]
    if not out["overlay_pixels_changed"]:
        bad.append("the overlay pane equals the input")
    emit(dict(phase="robot_demo", ok=not bad, device=str(device), **out))
    check(not bad, "demo: " + "; ".join(bad))
    return launches["min_dist_voxels"]


def phase_robot(device, small, counts, fit_root, frames):
    """Phase 15: the robot side, (a) to (d); returns each path's min_dist
    launches."""
    import shutil

    t0 = time.perf_counter()
    root = os.path.join(fit_root, "robot")
    os.makedirs(root)
    occ_run = os.path.join(eval_runs(root, small, names=("occ",)), "occ")
    seg_run = os.path.join(rest_root(fit_root), "segmenter")
    seconds = {}
    t = time.perf_counter()
    node_md, pipe = phase_ros_node(device, small, counts, frames, occ_run,
                                   seg_run, root)
    seconds["ros_node"] = time.perf_counter() - t
    t = time.perf_counter()
    episode_md = phase_pick_episode(device, small, counts, pipe)
    seconds["pick_episode"] = time.perf_counter() - t
    del pipe
    t = time.perf_counter()
    demo_md = phase_demo(device, small, counts, occ_run, root)
    seconds["demo"] = time.perf_counter() - t
    shutil.rmtree(root)
    seconds["total"] = time.perf_counter() - t0
    emit(dict(phase="robot", ok=True, device=str(device), seconds=seconds))
    return dict(ros_node=node_md, pick_episode=episode_md, demo=demo_md)


# -------------------------------------------------------------- phase 16

# the data side (phase 16): a YCB-Video tree written from the port's
# generator (3-6 objects a frame; 480x640, the dataset's size), read by
# the YCB loader: every YCB_SAMPLING-th train frame, every keyframe and
# every data_syn frame. The counts give fit >= 3 train batches of 16
# after the visibility filter (train + syn) and one val batch of 48
YCB_SEED = 16
YCB_OBJECTS = (3, 6)
YCB_SAMPLING = 8
YCB_FULL = dict(shape=(480, 640), train_frames=24, syn_frames=8,
                val_frames=16, batch=16, val_batch=48, steps=3)
YCB_SMALL = dict(shape=(120, 160), train_frames=3, syn_frames=2,
                 val_frames=2, batch=4, val_batch=4, steps=2)
YCB_FACTOR_DEPTH = 10000.0
YCB_N_ROTATIONS = 500  # ambiguity_floor's sweep
# the IoU of each class's meshio solid grid against the procedural model's
# own solid voxels, on the procedural grid; a mesh written or voxelized
# wrongly falls far below
YCB_IOU_MIN = 0.5
YCB_BARE_STEPS = 5
# the profile CLIs' timed calls a stage (their defaults: 20 and 15); the
# mean of 6 queued steps of ~200 ms after 3 warm-up calls
PROFILE_STEPS = 6


def ycb_root(fit_root):
    """The data root: ``ycb_video/YCB_Video_{Models,Dataset}`` below it."""
    return os.path.join(fit_root, "ycb")


def _ycb_frame(task):
    """Write one generator frame as YCB-Video's files (cv2, savemat); a
    class's second instance stays background, as YCB-Video labels one
    instance a class. Returns the labelled classes."""
    import cv2
    import scipy.io

    from morefusion_tpu_torch import datasets

    base, split, index, shape = task
    frame = datasets.SyntheticRGBDPoseEstimationDataset(
        split=split, n_frames=index + 1, n_objects=YCB_OBJECTS,
        seed=YCB_SEED, image_shape=shape).get_frame(index)
    label = np.zeros(shape, np.uint8)
    cls, poses = [], []
    for iid, cid, T in zip(frame["instance_ids"], frame["class_ids"],
                           frame["Ts_cad2cam"]):
        if cid in cls:
            continue
        label[frame["instance_label"] == iid] = cid
        cls.append(int(cid))
        poses.append(T[:3, :4])
    depth = np.nan_to_num(frame["depth"] * YCB_FACTOR_DEPTH).round()
    os.makedirs(os.path.dirname(base), exist_ok=True)
    for name, image in (("color", frame["rgb"][..., ::-1]),
                        ("depth", depth.astype(np.uint16)),
                        ("label", label)):
        check(cv2.imwrite(f"{base}-{name}.png", np.ascontiguousarray(image)),
              f"ycb: cv2 could not write {base}-{name}.png")
    scipy.io.savemat(base + "-meta.mat", {
        "cls_indexes": np.asarray(cls, np.int32),
        "factor_depth": YCB_FACTOR_DEPTH,
        "intrinsic_matrix": frame["intrinsic_matrix"],
        "poses": np.stack(poses, axis=2)})
    return cls


def ycb_models_tree(models_dir):
    """``YCB_Video_Models``: each class's procedural solid grid as a box
    mesh (``voxel_grid_to_mesh``, each voxel's box centred on its point)
    in ``textured_simple.obj``, its surface samples in ``points.xyz``."""
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.datasets.ycb_video import class_names
    from morefusion_tpu_torch.extra import viz

    bank = ProceduralModels()
    faces = {}
    for cid in range(1, 22):
        d = os.path.join(models_dir, str(class_names[cid]))
        os.makedirs(d)
        grid = bank.get_solid_voxel_grid(cid)
        idx = np.round((grid.points - grid.origin) / grid.pitch).astype(int)
        occ = np.zeros(idx.max(axis=0) + 1, bool)
        occ[tuple(idx.T)] = True
        v, f = viz.voxel_grid_to_mesh(occ, grid.pitch,
                                      np.asarray(grid.origin) - grid.pitch / 2)
        viz.save_obj(os.path.join(d, "textured_simple.obj"), v, f)
        np.savetxt(os.path.join(d, "points.xyz"), bank.get_pcd(cid))
        faces[cid] = len(f)
    return faces


def ycb_data(fit_root, small):
    """Phase 16's data, made before anything runs on the card: the
    YCB-Video tree (the models, then the frames in forked workers: only
    the train frames the loader reads, each ``YCB_SAMPLING``-th, the
    keyframes and data_syn), then the factory's examples (``reindex`` in
    forked workers, the procedural bank rendering the visibility; see
    ``phase_data_side``) packed. Fails when fit would see fewer than
    ``FIT_MIN_TRAIN_BATCHES`` train batches or no val batch."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    from morefusion_tpu_torch import datasets

    cfg = YCB_SMALL if small else YCB_FULL
    t0 = time.perf_counter()
    top = os.path.join(ycb_root(fit_root), "ycb_video")
    faces = ycb_models_tree(os.path.join(top, "YCB_Video_Models"))
    models_s = time.perf_counter() - t0
    data = os.path.join(top, "YCB_Video_Dataset")
    n_train = cfg["train_frames"] * YCB_SAMPLING
    train_ids = [f"0001/{k + 1:06d}" for k in range(n_train)]
    val_ids = [f"0002/{k + 1:06d}" for k in range(cfg["val_frames"])]
    tasks = [(os.path.join(data, "data", train_ids[k]), "train", k,
              cfg["shape"]) for k in range(0, n_train, YCB_SAMPLING)]
    tasks += [(os.path.join(data, "data", id_), "val", k, cfg["shape"])
              for k, id_ in enumerate(val_ids)]
    tasks += [(os.path.join(data, "data_syn", f"{k:06d}"), "train",
               n_train + k, cfg["shape"]) for k in range(cfg["syn_frames"])]
    os.makedirs(os.path.join(data, "image_sets"))
    for split, ids in (("train", train_ids), ("keyframe", val_ids)):
        with open(os.path.join(data, "image_sets", f"{split}.txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")
    n_workers = min(os.cpu_count() or 1, 4 if small else 16)
    with ProcessPoolExecutor(
            max_workers=n_workers,
            mp_context=multiprocessing.get_context("fork")) as ex:
        labelled = list(ex.map(_ycb_frame, tasks))
    frames_s = time.perf_counter() - t0 - models_s

    def factory(split):
        return datasets.YCBVideoRGBDPoseEstimationDataset(
            split, models=datasets.ProceduralModels(),
            sampling=YCB_SAMPLING, root_dir=data)

    t1 = time.perf_counter()
    sources = dict(train=datasets.ConcatDataset(factory("train"),
                                                factory("syn")),
                   val=factory("val"))
    read = {k: len(v) for k, v in sources.items()}
    for split, src in sources.items():
        reindexed = os.path.join(ycb_root(fit_root), f"{split}_reindexed")
        datasets.reindex(reindexed, [src], n_workers=n_workers,
                         progress=False)
        datasets.pack_reindexed(reindexed,
                                os.path.join(ycb_root(fit_root), split),
                                progress=False)
    train = datasets.PackedPoseDataset(
        os.path.join(ycb_root(fit_root), "train"),
        min_visibility=FIT_MIN_VISIBILITY)
    val = datasets.PackedPoseDataset(os.path.join(ycb_root(fit_root), "val"))
    out = dict(shape=cfg["shape"], n_objects=YCB_OBJECTS,
               sampling=YCB_SAMPLING, n_workers=n_workers,
               image_set_train=n_train, frames_written=len(tasks),
               frames_read=read, mesh_faces=faces,
               labelled_objects=int(sum(map(len, labelled))),
               train_crops=len(train), val_crops=len(val),
               train_crops_all=len(datasets.PackedPoseDataset(
                   os.path.join(ycb_root(fit_root), "train"))),
               models_s=models_s, frames_s=frames_s,
               reindex_s=time.perf_counter() - t1,
               data_s=time.perf_counter() - t0)
    check(len(train) >= FIT_MIN_TRAIN_BATCHES * cfg["batch"],
          f"ycb data: {len(train)} train crops at visibility >= "
          f"{FIT_MIN_VISIBILITY}, fewer than {FIT_MIN_TRAIN_BATCHES} "
          f"batches of {cfg['batch']}")
    check(len(val) >= cfg["val_batch"],
          f"ycb data: {len(val)} val crops, no batch of {cfg['val_batch']}")
    return out


def solid_iou(got, want):
    """IoU of two solid grids' points on ``want``'s voxel grid."""
    def cells(grid):
        idx = np.round((grid.points - want.origin) / want.pitch)
        return set(map(tuple, idx.astype(int)))

    a, b = cells(got), cells(want)
    return len(a & b) / max(len(a | b), 1)


def phase_ycb_bank(root):
    """(b) ``YCBVideoModels`` on the tree: the first build (meshio's
    voxelization and EDT, npz caches written) and the cached second, each
    class's grid against the procedural model's own, and
    ``compute_voxel_size``'s tables."""
    from morefusion_tpu_torch.cli import compute_voxel_size
    from morefusion_tpu_torch.datasets import ProceduralModels, YCBVideoModels

    models_dir = os.path.join(root, "ycb_video", "YCB_Video_Models")
    builds = []
    for _ in range(2):
        bank = YCBVideoModels(models_dir)
        t0 = time.perf_counter()
        grids = [bank.get_solid_voxel_grid(cid) for cid in range(1, 22)]
        builds.append(time.perf_counter() - t0)
    cached = sum(os.path.exists(os.path.join(
        models_dir, str(bank.class_names[cid]), "solid_voxels.npz"))
        for cid in range(1, 22))
    check(cached == 21, f"ycb bank: {cached} npz caches of 21")
    procedural = ProceduralModels()
    iou = {}
    for cid, grid in enumerate(grids, 1):
        iou[int(cid)] = solid_iou(grid, procedural.get_solid_voxel_grid(cid))
    check(min(iou.values()) >= YCB_IOU_MIN,
          f"ycb bank: solid grid IoU below {YCB_IOU_MIN}: {iou}")
    with mock.patch.dict(os.environ, {"MOREFUSION_TPU_DATA": root}):
        ycb_rows = quiet(compute_voxel_size.main, ["--ycb-video"])[0]
    procedural_rows = quiet(compute_voxel_size.main, [])[0]
    table = {r["name"]: dict(ycb_bbox_diagonal=r["bbox_diagonal"],
                             ycb_voxel_size=r["voxel_size"],
                             procedural_bbox_diagonal=p["bbox_diagonal"],
                             procedural_voxel_size=p["voxel_size"])
             for r, p in zip(ycb_rows, procedural_rows)}
    return dict(first_build_s=builds[0], cached_build_s=builds[1],
                solid_points={int(c): len(g.points)
                              for c, g in enumerate(grids, 1)},
                iou=iou, iou_min=min(iou.values()),
                iou_tolerance=YCB_IOU_MIN, voxel_size_table=table)


def phase_ycb_fit(device, small, counts, root):
    """(c) ``fit`` on the packed YCB sets with the YCB bank (the occ
    checkpoint at full width, fp32, ``add/add_s+occupancy``, B = 16, three
    steps, one evaluation), counted; the bank's bare train step timed as
    phase 6 times its own; one step with the kernels against the plain
    versions in deterministic mode."""
    from morefusion_tpu_torch import datasets, models
    from morefusion_tpu_torch.datasets import Transform, YCBVideoModels
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md
    from morefusion_tpu_torch.training import BatchLoader, loop, trainer

    cfg = YCB_SMALL if small else YCB_FULL
    bank_dir = os.path.join(root, "ycb_video", "YCB_Video_Models")
    train = datasets.PackedPoseDataset(
        os.path.join(root, "train"), split="train", augmentation=True,
        min_visibility=FIT_MIN_VISIBILITY)
    val = datasets.PackedPoseDataset(os.path.join(root, "val"), split="val")
    torch.manual_seed(0)
    if small:
        model = models.tiny_singleview3d(21, n_point=64, with_occupancy=True)
    else:
        model = models.SingleView3D(n_fg_class=21, with_occupancy=True)
    spe = len(train) // cfg["batch"]
    out_dir = os.path.join(root, "fit")
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    kw = dict(model=model, models_bank=YCBVideoModels(bank_dir),
              train_dataset=train, val_dataset=val, out_dir=out_dir,
              transform_train=Transform(train=True, with_occupancy=True),
            transform_val=Transform(train=False, with_occupancy=True),
            n_fg_class=21, batch_size=cfg["batch"],
            loss="add/add_s+occupancy", max_steps=cfg["steps"],
            eval_interval=(cfg["steps"] + 0.5) / spe, log_interval=1,
              pretrained_model=None if small else CHECKPOINT,
              device_augment=True, val_batch_size=cfg["val_batch"],
              device=device)
    state, summary = quiet(lambda: loop.fit(**kw))[0]
    fit_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counts}
    fit_steps = state.step
    check(fit_steps == cfg["steps"], f"ycb fit: ended at {fit_steps}")
    log = read_json(os.path.join(out_dir, "log.json"))
    rows = [r for r in log if "main/loss" in r]
    check(len(rows) == cfg["steps"]
          and all(np.isfinite(r["main/loss"]) and r["main/loss_occupancy"]
                  != 0 for r in rows), f"ycb fit: rows {log}")
    auc = summary.get("main/add_or_add_s/auc")
    check(auc is not None and np.isfinite(auc), f"ycb fit: summary {summary}")
    if device.type == "cuda":
        for k in ("nn_indices", "min_dist_voxels"):
            check(launches[k] > 0, f"ycb fit: no {k} launch")

    # the bank's bare step on one host batch, as phase 6 times its own
    bank = trainer.CadPointBank.build(YCBVideoModels(bank_dir), 21,
                                      device=device)
    batches = iter(BatchLoader(train, cfg["batch"],
                               Transform(train=True, with_occupancy=True),
                               shuffle=False))
    batch = next(batches)
    batches.close()
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    step = trainer.make_train_step(state.model, bank,
                                   occupancy_loss_term=True, augment=True)
    step_ms = []
    for i in range(YCB_BARE_STEPS + 1):
        sync(device)
        t = time.perf_counter()
        float(step(state, batch, True, seed=0)[1]["loss"])
        if i:
            step_ms.append((time.perf_counter() - t) * 1e3)

    # kernels against plain versions, deterministic mode
    loss_fn = trainer.make_loss_fn(state.model, bank, occupancy_loss_term=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            kernel = loss_and_grads(state.model, loss_fn, batch, train=True)
            with mock.patch.object(md, "min_dist_voxels",
                                   md.min_dist_voxels_plain), \
                    mock.patch.object(knn, "nn_indices",
                                      knn.nn_indices_plain):
                plain = loss_and_grads(state.model, loss_fn, batch,
                                       train=True)
    finally:
        torch.use_deterministic_algorithms(False)
    vs_plain = compare_steps(kernel, plain, STEP_LOSS_RTOL, STEP_GRAD_RTOL,
                             STEP_GRAD_TOTAL, "ycb step kernel vs plain")
    return dict(
        model="tiny" if small else "SingleView3D occ checkpoint, fp32",
        batch=cfg["batch"], steps=fit_steps, steps_per_epoch=spe,
        fit_s=fit_s, losses=[r["main/loss"] for r in rows],
        loop_step_ms=[1e3 / r["main/sps_window"] for r in rows],
        auc=auc, bare_step_ms=step_ms,
        median_bare_step_ms=median(step_ms),
        solid_points_in_bank=int(bank.solid_mask.sum()),
        kernel_vs_plain=vs_plain,
        tolerance=dict(loss_rtol=STEP_LOSS_RTOL, grad_rtol=STEP_GRAD_RTOL,
                       grad_of_whole=STEP_GRAD_TOTAL),
        launches=launches), launches


def phase_profile_clis(device, small, counts, root):
    """(d) ``profile_train`` and ``profile_backward`` at their defaults
    (B = 16) but ``PROFILE_STEPS`` steps, each counted; C and D run no
    knn."""
    from morefusion_tpu_torch.cli import profile_backward, profile_train

    tiny = (["--tiny", "--batch-size", "2", "--steps", "1",
             "--image-size", "64"] if small else [])
    argv = tiny + ["--device", device.type] + (
        [] if small else ["--steps", str(PROFILE_STEPS)])
    out, launches = {}, {}
    for c in counts:
        c.launches = 0
    trace = os.path.join(root, "trace")
    res, lines = quiet(profile_train.main, argv + ["--trace-dir", trace])
    launches["profile_train"] = {c.__name__: c.launches for c in counts}
    check(res["step_flops"] > 0 and os.listdir(trace),
          f"profile_train: {lines[-3:]}")
    out["profile_train"] = dict(
        ms={k: v["ms"] for k, v in res["results"].items()},
        host_ms={k: v["host_ms"] for k, v in res["results"].items()},
        dp_vs_bare={name: dict(
            dp_ms=res["results"][f"train_step_{name}"]["ms"],
            dp_host_ms=res["results"][f"train_step_{name}"]["host_ms"],
            bare_ms=res["bare_results"][f"train_step_{name}"]["ms"],
            bare_host_ms=res["bare_results"][f"train_step_{name}"][
                "host_ms"]) for name in ("fp32", "bf16")},
        first_call_s=res["first_call_s"], step_flops=res["step_flops"],
        flop_counter_tflops_per_s=res["tflops_per_s"], card=res["card"],
        launches=launches["profile_train"])
    for c in counts:
        c.launches = 0
    rows, lines = quiet(profile_backward.main, argv)
    launches["profile_backward"] = {c.__name__: c.launches for c in counts}
    check(list(rows) == list("ABCDEFGH"), f"profile_backward: {lines}")
    if device.type == "cuda":
        for key, row in rows.items():
            want_knn = 0 if key in "CD" else row["launches"]["steps"]
            check(row["launches"]["nn_indices"] == want_knn
                  and row["launches"]["min_dist_voxels"]
                  == row["launches"]["steps"],
                  f"profile_backward {key}: launches {row['launches']}")
        for k in ("nn_indices", "min_dist_voxels"):  # + first calls, FLOPs
            check(launches["profile_backward"][k]
                  >= sum(r["launches"][k] for r in rows.values()),
                  f"profile_backward: {k} launches {launches}")
    out["profile_backward"] = dict(
        variants={k: dict(name=r["name"], ms=r["ms"], host_ms=r["host_ms"],
                          flops=r["flops"], launches=r["launches"])
                  for k, r in rows.items()},
        attribution=[ln for ln in lines if ":" in ln and "ms/step" not in ln],
        launches=launches["profile_backward"])
    return out, launches


def phase_data_tools(device, small, counts, fit_root, root):
    """(e) ``geometry.nn`` on the card against its plain version,
    ``visualize_data``, ``ambiguity_floor`` and ``export_checkpoint`` on
    phase 11's run A, each timed once."""
    from morefusion_tpu_torch import geometry
    from morefusion_tpu_torch.cli import (
        ambiguity_floor,
        export_checkpoint,
        visualize_data,
    )
    from morefusion_tpu_torch.datasets import YCBVideoModels
    from morefusion_tpu_torch.ops import knn

    out = {}
    bank = YCBVideoModels(os.path.join(root, "ycb_video", "YCB_Video_Models"))
    g = np.random.RandomState(16)
    ref = np.stack([bank.get_pcd(cid)[:500] for cid in range(1, 17)])
    query = np.stack([r[g.randint(0, len(r), 20000)] for r in ref])
    query = (query + g.normal(0, 0.003, query.shape)).astype(np.float32)
    ref_t = torch.from_numpy(ref).to(device)
    query_t = torch.from_numpy(query).to(device)
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    idx = geometry.nn(ref_t, query_t).cpu()
    nn_s = time.perf_counter() - t0
    nn_launches = {c.__name__: c.launches for c in counts}
    want = knn.nn_indices_plain(ref_t, query_t).cpu()
    check(torch.equal(idx, want), "geometry.nn: indices differ from plain")
    out["geometry_nn"] = dict(shape=list(query.shape[:2]) + [ref.shape[1]],
                              s=nn_s, identical=True, launches=nn_launches)

    t0 = time.perf_counter()
    res = quiet(visualize_data.main, ["--out", os.path.join(root, "viz")])[0]
    check(all(os.path.getsize(res[k]) > 0 for k in ("png", "obj")),
          f"visualize_data: {res}")
    out["visualize_data"] = dict(s=time.perf_counter() - t0,
                                 n_vertices=res["n_vertices"])

    t0 = time.perf_counter()
    res = quiet(ambiguity_floor.main, [
        "--artifact", os.path.join(ROOT, "docs", "results",
                                   "r4_refine_table_joint.json"),
        "--n-rotations", str(YCB_N_ROTATIONS),
        "--out", os.path.join(root, "ambiguity.json")])[0]
    check(np.isfinite(res["summary"]["corr_floor_vs_median_add"]),
          f"ambiguity_floor: {res['summary']}")
    out["ambiguity_floor"] = dict(s=time.perf_counter() - t0,
                                  n_rotations=YCB_N_ROTATIONS,
                                  summary=res["summary"])

    run_a = os.path.join(fit_root, "run_a")
    archive = os.path.join(root, "run_a_best_bf16.npz")
    t0 = time.perf_counter()
    quiet(export_checkpoint.main, ["--log-dir", run_a, "--out", archive,
                                   "--device", device.type])
    export_s = time.perf_counter() - t0
    own = os.path.join(run_a, "snapshot_model_best_validation_main_auc.npz")
    with np.load(archive) as a, np.load(own) as b:
        check(sorted(a.files) == sorted(b.files)
              and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                      for k in b.files),
              "export_checkpoint: the archive differs from save_best's")
        entries = len(b.files)
    out["export_checkpoint"] = dict(s=export_s, entries=entries,
                                    equal_to_save_best=True)
    return out, nn_launches


def phase_data_side(device, small, counts, fit_root, data):
    """Phase 16: the data side, (a) to (e); returns each path's launches.

    The factory renders each instance's full model for its visibility,
    which needs a bank with a shape or surface samples and a colour a
    class; ``YCBVideoModels`` has neither, in the JAX package as here, so
    the factory renders with the procedural bank (whose shapes the frames
    show) and ``fit`` trains on the YCB bank: its meshio solid grids feed
    the occupancy loss (min_dist) and its points ADD-S (knn)."""
    import shutil

    t0 = time.perf_counter()
    root = ycb_root(fit_root)
    seconds = {}
    t = time.perf_counter()
    bank = phase_ycb_bank(root)
    seconds["ycb_bank"] = time.perf_counter() - t
    t = time.perf_counter()
    fit, fit_launches = phase_ycb_fit(device, small, counts, root)
    seconds["ycb_fit"] = time.perf_counter() - t
    t = time.perf_counter()
    profiles, profile_launches = phase_profile_clis(device, small, counts,
                                                    root)
    seconds["profile_clis"] = time.perf_counter() - t
    t = time.perf_counter()
    tools, nn_launches = phase_data_tools(device, small, counts, fit_root,
                                          root)
    seconds["data_tools"] = time.perf_counter() - t
    shutil.rmtree(root)
    seconds["total"] = time.perf_counter() - t0
    emit(dict(phase="data_side", ok=True, device=str(device), data=data,
              ycb_bank=bank, ycb_fit=fit, profiles=profiles,
              data_tools=tools, seconds=seconds))
    return dict(ycb_fit=fit_launches, geometry_nn=nn_launches,
                profile_train_steps=profiles["profile_train"]["dp_vs_bare"],
                **profile_launches)


# -------------------------------------------------------------- phase 17

# data parallelism (phase 17) at phase 6's shapes from the occ checkpoint:
# DP_STEPS steps compared, DP_TIMED_STEPS a turn of the timing. Phase (b)'s
# two ranks share the one card: NCCL refuses two ranks on a device, so they
# join a gloo group, which carries the gradients through the host
DP_STEPS = 2
DP_TIMED_STEPS = 5
DP_CHILD_TIMEOUT = 600  # seconds a child process may take
DP_TRAIN_STEPS = 3  # cli.train under torchrun
DP_SEG_STEPS = 4  # cli.train_segmentation at world size 1


def dp_child_env():
    """A child's environment: two threads (three children share the
    host's cores with this process)."""
    return dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)


def dp_rank_child(rank, world, port, out_dir, small):
    """One rank of phase 17 (b), in its own process: phase 6's batch, its
    ``local_batch_slice`` on this rank, ``DP_STEPS`` data-parallel steps
    from the occ checkpoint in deterministic mode with the kernels, then
    again with their plain versions; the metrics, launches and weights go to
    ``out_dir/rank{rank}.pt``."""
    from morefusion_tpu_torch import parallel
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md
    from morefusion_tpu_torch.training import trainer

    device = torch.device("cpu") if small else torch.device("cuda", 0)
    torch.set_num_threads(2)
    parallel.maybe_initialize(init_method=f"tcp://127.0.0.1:{port}",
                              world_size=world, rank=rank, local_rank=0,
                              backend="gloo")
    mesh = parallel.data_mesh(device.type)
    check(str(mesh.device) == str(device) and mesh.world_size == world,
          f"dp rank {rank}: mesh {mesh}")
    _, bank, _, batch = train_setup(device, small)
    shard = parallel.shard_batch(batch, mesh)
    out = dict(rows=[int(i) for i in range(len(batch["rgb"]))[
        parallel.local_batch_slice(len(batch["rgb"]), mesh)]])
    counts = [md.min_dist_voxels, knn.nn_indices]
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for which in ("kernel", "plain"):
            model = serving_model(small, seed=5).to(device)
            state = trainer.create_train_state(model)
            step = trainer.make_dp_train_step(model, bank, mesh)
            check(step.ddp is not None, "dp rank: no DDP wrapper")
            plain = (mock.patch.object(md, "min_dist_voxels",
                                       md.min_dist_voxels_plain),
                     mock.patch.object(knn, "nn_indices",
                                       knn.nn_indices_plain))
            for c in counts:
                c.launches = 0
            metrics = []
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if which == "plain":
                    for patch in plain:
                        stack.enter_context(patch)
                for _ in range(DP_STEPS):
                    state, m = step(state, shard, True, seed=0)
                    metrics.append({k: float(v) for k, v in m.items()})
            out[which] = dict(
                metrics=metrics, s=time.perf_counter() - t0,
                launches={c.__name__: c.launches for c in counts},
                weights={k: v.detach().cpu()
                         for k, v in model.state_dict().items()})
            del model, state, step
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def train_child(out_json, argv):
    """Phase 17 (c), a process of ``torchrun --nproc_per_node 1``:
    ``cli.train.main(argv)`` counted; what the parent reads goes to
    ``out_json``."""
    from morefusion_tpu_torch.cli import train as cli
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md

    counts = [md.min_dist_voxels, knn.nn_indices]
    for c in counts:
        c.launches = 0
    state, summary = cli.main(argv)
    dist = torch.distributed
    with open(out_json, "w") as f:
        json.dump(dict(step=state.step, summary=summary,
                       launches={c.__name__: c.launches for c in counts},
                       world_size=dist.get_world_size(),
                       backend=dist.get_backend(),
                       device=str(next(state.model.parameters()).device)),
                  f)


def child_main(argv):
    """The entry of phase 17's child processes (``--dp-rank-child`` and
    ``--train-child``)."""
    sys.path.insert(0, ROOT)
    small = "--small" in argv
    if not small:
        from morefusion_tpu_torch.ops import _build

        check(torch.cuda.is_available(), "child: no CUDA device")
        _build.load()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if argv[0] == "--dp-rank-child":
        rank, world, port = map(int, argv[1:4])
        dp_rank_child(rank, world, port, argv[4], small)
    else:
        sep = argv.index("--")
        train_child(argv[1], argv[sep + 1:])
    return 0


def start_child(cmd, log_path):
    """A child process in a session of its own (so that ``kill_child``
    stops it with everything it started, torchrun's worker too), its
    output to ``log_path``: ``(process, log file)``."""
    log = open(log_path, "w")
    return subprocess.Popen(cmd, cwd=ROOT, env=dp_child_env(), stdout=log,
                            stderr=subprocess.STDOUT,
                            start_new_session=True), log


def kill_child(proc):
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def wait_child(proc_log, log_path, what):
    """Wait for a child (killed at ``DP_CHILD_TIMEOUT``, so a hung
    rendezvous fails the phase); fails on a non-zero exit."""
    proc, log = proc_log
    try:
        rc = proc.wait(timeout=DP_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        kill_child(proc)
        rc = "timeout"
    finally:
        log.close()
    with open(log_path) as f:
        tail = f.read()[-3000:]
    check(rc == 0, f"{what}: exit {rc}: {tail}")


def dp_single(device, small, counts, setup):
    """(a) the DP step at world size 1 under the group of this process
    against the bare step from the same weights: ``DP_STEPS`` steps in
    deterministic mode (metrics, the first step's gradients and the weights
    after), counted; then both timed in turns."""
    from morefusion_tpu_torch import parallel
    from morefusion_tpu_torch.training import trainer

    _, bank, _, batch = setup
    mesh = parallel.data_mesh(device.type)
    check(mesh.distributed and mesh.world_size == 1,
          f"dp ws1: mesh {mesh}")
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for kind in ("dp", "bare"):
                model = serving_model(small, seed=5).to(device)
                state = trainer.create_train_state(model)
                step = (trainer.make_dp_train_step(model, bank, mesh)
                        if kind == "dp" else
                        trainer.make_train_step(model, bank))
                if kind == "dp":
                    check(step.ddp is not None, "dp ws1: no DDP wrapper")
                for c in counts:
                    c.launches = 0
                metrics, grads = [], None
                for _ in range(DP_STEPS):
                    state, m = step(state, batch, True, seed=0)
                    metrics.append({k: float(v) for k, v in m.items()})
                    if grads is None:
                        grads = {n: p.grad.detach().clone()
                                 for n, p in model.named_parameters()}
                runs[kind] = dict(
                    metrics=metrics, grads=grads, model=model, state=state,
                    step=step,
                    launches={c.__name__: c.launches for c in counts})
    finally:
        torch.use_deterministic_algorithms(False)
    dp, bare = runs["dp"], runs["bare"]
    identical = dict(
        metrics=dp["metrics"] == bare["metrics"],
        grads=all(torch.equal(dp["grads"][n], bare["grads"][n])
                  for n in bare["grads"]),
        weights=all(torch.equal(a, b) for a, b in zip(
            dp["model"].state_dict().values(),
            bare["model"].state_dict().values())))
    # expected equal (DDP's average over one rank divides by 1); held
    # within phase 6's kernel-vs-plain tolerances where not
    worst = compare_steps(
        (dp["metrics"][-1], dp["grads"], None),
        (bare["metrics"][-1], bare["grads"], None), STEP_LOSS_RTOL,
        STEP_GRAD_RTOL, STEP_GRAD_TOTAL, "dp ws1 vs bare")
    before = {k: v.to(device) for k, v in
              serving_model(small, seed=5).state_dict().items()}
    worst["weights"] = compare_updates(
        dp["model"].state_dict(), bare["model"].state_dict(), before,
        "dp ws1 vs bare")
    if device.type == "cuda":
        for k in ("min_dist_voxels", "nn_indices"):
            check(dp["launches"][k] >= DP_STEPS,
                  f"dp ws1: {dp['launches'][k]} {k} launches")
    return dict(identical=identical, vs_bare=worst,
                metrics=dp["metrics"], launches=dp["launches"],
                backend=torch.distributed.get_backend()), runs, batch


def dp_timing(device, runs, batch):
    """Host ms a step (ending in a read of the loss) of the DP and the bare
    step in turns: dp, bare, bare, dp."""
    ms = {"dp": [], "bare": []}
    for kind in ("dp", "bare", "bare", "dp"):
        r = runs[kind]
        for i in range(DP_TIMED_STEPS + 1):
            sync(device)
            t0 = time.perf_counter()
            r["state"], m = r["step"](r["state"], batch, True, seed=0)
            float(m["loss"])
            if i:  # the first of a turn warms up
                ms[kind].append((time.perf_counter() - t0) * 1e3)
    out = {k: dict(step_ms=v, median_ms=median(v)) for k, v in ms.items()}
    out["dp_minus_bare_ms"] = out["dp"]["median_ms"] - out["bare"]["median_ms"]
    return out


def dp_emulation(device, small, setup, ranks):
    """(b)'s reference in this process: each rank's half through the
    single-device loss with that rank's generators, the gradients averaged,
    Adam; ``DP_STEPS`` steps in deterministic mode."""
    from morefusion_tpu_torch.training import trainer

    _, bank, _, batch = setup
    model = serving_model(small, seed=5).to(device)
    state = trainer.create_train_state(model)
    loss_fn = trainer.make_loss_fn(model, bank)
    halves = [{k: v[rows] for k, v in batch.items()}
              for rows in (r["rows"] for r in ranks)]
    metrics = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for s in range(DP_STEPS):
                total, ms = None, []
                for r, half in enumerate(halves):
                    gens = trainer.step_generators(0, s, device, r)
                    model.zero_grad(set_to_none=True)
                    loss, m = loss_fn(half, True, sample_generator=gens[0],
                                      dropout_generator=gens[1],
                                      augment_generator=gens[2])
                    loss.backward()
                    ms.append({k: float(v) for k, v in m.items()})
                    g = [p.grad.detach().clone() for p in model.parameters()]
                    total = g if total is None else [
                        a + b for a, b in zip(total, g)]
                for p, g in zip(model.parameters(), total):
                    p.grad = g / len(halves)
                state.optimizer.step()
                state.scheduler.step()
                state.step += 1
                metrics.append({k: float(np.mean([m[k] for m in ms]))
                                for k in ms[0]})
    finally:
        torch.use_deterministic_algorithms(False)
    return metrics, {k: v.detach().cpu()
                     for k, v in model.state_dict().items()}


def dp_gloo_report(device, small, setup, out_dir):
    """(b): the two ranks' results held to each other, to the emulation
    and, kernel against plain, to phase 11's tolerances."""
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    before = {k: v.detach().cpu() for k, v in
              serving_model(small, seed=5).state_dict().items()}
    for which in ("kernel", "plain"):
        w0, w1 = (r[which]["weights"] for r in ranks)
        check(all(torch.equal(w0[k], w1[k]) for k in w0),
              f"dp gloo2 {which}: the ranks' weights differ")
        check(ranks[0][which]["metrics"] == ranks[1][which]["metrics"],
              f"dp gloo2 {which}: the ranks' metrics differ")
    check(ranks[0]["rows"] != ranks[1]["rows"]
          and len(ranks[0]["rows"]) == len(ranks[1]["rows"]),
          f"dp gloo2: rows {ranks[0]['rows']} / {ranks[1]['rows']}")

    def loss_err(a, b):
        return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12)
                   for x, y in zip(a, b) for k in y)

    em_metrics, em_weights = dp_emulation(device, small, setup, ranks)
    k0, p0 = ranks[0]["kernel"], ranks[0]["plain"]
    err_em = loss_err(k0["metrics"], em_metrics)
    check(err_em <= STEP_LOSS_RTOL,
          f"dp gloo2 vs emulation: losses {k0['metrics']} / {em_metrics}")
    vs_emulation = dict(loss_rel_err=err_em, **compare_updates(
        k0["weights"], em_weights, before, "dp gloo2 vs emulation"))
    err_kp = loss_err(k0["metrics"], p0["metrics"])
    check(err_kp <= STEP_LOSS_RTOL,
          f"dp gloo2 kernel vs plain: {k0['metrics']} / {p0['metrics']}")
    vs_plain = dict(loss_rel_err=err_kp, **compare_updates(
        k0["weights"], p0["weights"], before, "dp gloo2 kernel vs plain"))
    launches = {k: sum(r["kernel"]["launches"][k] for r in ranks)
                for k in k0["launches"]}
    if device.type == "cuda":
        for r in ranks:
            for k, n in r["kernel"]["launches"].items():
                check(n >= DP_STEPS, f"dp gloo2: {n} {k} launches a rank")
    return dict(rows=[r["rows"] for r in ranks], metrics=k0["metrics"],
                rank_s={w: [r[w]["s"] for r in ranks]
                        for w in ("kernel", "plain")},
                weights_equal_across_ranks=True, vs_emulation=vs_emulation,
                kernel_vs_plain=vs_plain, launches=launches,
                plain_launches={k: sum(r["plain"]["launches"][k]
                                       for r in ranks)
                                for k in k0["launches"]})


def transfer_checks(device, small, fit_root):
    """(c)'s checks of the form on the card, on phase 11's train set: a
    batch's bytes packed and unpacked, the card's unpack against the CPU's
    of the same buffer, and ``reconstruct_pcd`` against the packed cloud."""
    from morefusion_tpu_torch import datasets
    from morefusion_tpu_torch.training import transfer

    cfg = FIT_SMALL if small else FIT_FULL
    path = os.path.join(fit_root, "train")
    check(datasets.has_transfer_arrays(path),
          "transfer: phase 11 derived no transfer arrays")
    idx = list(range(cfg["batch"]))
    tf = datasets.Transform(train=False, with_occupancy=True)
    classic = tf.batch(datasets.PackedPoseDataset(path).load_batch(idx))
    packed_batch = tf.batch(datasets.PackedPoseDataset(
        path, transfer=True).load_batch(idx))
    schema = transfer.TransferSchema(packed_batch)
    t0 = time.perf_counter()
    buf = schema.pack(packed_batch)
    pack_ms = (time.perf_counter() - t0) * 1e3
    on_cpu = schema.unpack(torch.from_numpy(buf))
    on_card = schema.unpack(torch.from_numpy(buf).to(device))
    card_vs_cpu = {}
    for k, v in on_cpu.items():
        g = on_card[k].cpu()
        same_nan = torch.equal(torch.isnan(g), torch.isnan(v)) \
            if v.is_floating_point() else True
        a, b = (g.nan_to_num(0), v.nan_to_num(0)) if v.is_floating_point() \
            else (g, v)
        card_vs_cpu[k] = dict(identical=bool(same_nan and torch.equal(a, b)),
                              max_abs=float((a.double() - b.double()).abs()
                                            .max()))
        # bit-equal expected; the yuv420 arithmetic (three products in
        # float32) may round otherwise on the card, within 1e-4 of 255
        bound = 1e-4 * 255 if k == "rgb" else 0.0
        check(same_nan and card_vs_cpu[k]["max_abs"] <= bound,
              f"transfer: unpack of {k} on the card vs the CPU "
              f"{card_vs_cpu[k]}")
    # the rebuilt cloud of every train crop against the packed float32 one
    z = torch.from_numpy(np.load(os.path.join(path, "z16.npy"))).to(device)
    coef = torch.from_numpy(np.load(os.path.join(path, "pcd_coef.npy")))
    pcd = torch.from_numpy(np.load(os.path.join(path, "pcd.npy"))).to(device)
    rebuilt = transfer.reconstruct_pcd(z, coef.to(device))
    valid = torch.isfinite(pcd).all(-1)
    check(torch.equal(valid, torch.isfinite(rebuilt).all(-1)),
          "transfer: the rebuilt cloud's holes differ from the packed one's")
    err_mm = (rebuilt - pcd)[valid].norm(dim=-1) * 1e3
    nbytes = dict(classic=int(sum(np.asarray(v).nbytes
                                  for v in classic.values())),
                  transfer_batch=int(sum(np.asarray(v).nbytes
                                         for v in packed_batch.values())),
                  packed=int(buf.nbytes))
    return dict(batch=cfg["batch"], bytes=nbytes,
                packed_over_classic=nbytes["packed"] / nbytes["classic"],
                pack_ms=pack_ms, unpack_card_vs_cpu=card_vs_cpu,
                reconstruct_err_mm=dict(mean=float(err_mm.mean()),
                                        max=float(err_mm.max()),
                                        points=int(valid.sum())))


def dp_train_report(device, small, run, child_json, log_path):
    info = read_json(child_json)
    check(info["step"] == DP_TRAIN_STEPS and info["world_size"] == 1,
          f"train under torchrun: {info}")
    if device.type == "cuda":
        check(info["backend"] == "nccl", f"train under torchrun: {info}")
        for k, n in info["launches"].items():
            check(n >= DP_TRAIN_STEPS, f"train under torchrun: {n} {k}")
    timing = read_json(os.path.join(run, "timing.json"))
    log = read_json(os.path.join(run, "log.json"))
    losses = [r["main/loss"] for r in log if "main/loss" in r]
    check(len(losses) == DP_TRAIN_STEPS and np.isfinite(losses).all(),
          f"train under torchrun: losses {losses}")
    check(len(timing["pack_ms"]) >= DP_TRAIN_STEPS,
          "train under torchrun: the transfer path packed no batch")
    return dict(child=info, losses=losses,
                batch_bytes=timing["batch_bytes"],
                pack_ms=median(timing["pack_ms"]),
                copy_ms=median(timing["copy_ms"]),
                wait_ms=median(timing["wait_ms"]),
                host_prep_ms=median(timing["host_prep_ms"]))


def dp_segmenter(device, small, fit_root):
    """(e) ``cli.train_segmentation`` at phase 13's arguments for
    ``DP_SEG_STEPS`` steps under the group of this process: its step is the
    DDP step (the spy sees the wrapper)."""
    from morefusion_tpu_torch.cli import train_segmentation as seg_cli

    cfg = REST_SMALL if small else REST_FULL
    root = rest_root(fit_root)
    out = os.path.join(root, "segmenter_dp")
    argv = ["--out", out, "--n-frames", str(cfg["seg_frames"]),
            "--n-val-frames", str(cfg["seg_val_frames"]), "--image-shape",
            *map(str, cfg["seg_shape"]), "--n-objects",
            *map(str, SEG_OBJECTS), "--batch-size", str(cfg["seg_batch"]),
            "--widths", *map(str, cfg["seg_widths"]), "--seed",
            str(SEG_SEED), "--fg-weight", str(SEG_FG_WEIGHT), "--steps",
            str(DP_SEG_STEPS), "--device", device.type]
    wrapped, losses = [], []
    real = seg_cli.make_train_step

    def spy(state, fg_weight=1.0, mesh=None):
        step = real(state, fg_weight=fg_weight, mesh=mesh)
        wrapped.append(step.ddp is not None)

        def timed(small_batch):
            loss = step(small_batch)
            losses.append(float(loss))
            return loss

        return timed

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {
            "MFTPU_SEG_CACHE": os.path.join(root, "segcache")}), \
            mock.patch.object(seg_cli, "make_train_step", spy):
        (state, summary), _ = quiet(seg_cli.main, argv)
    wall_s = time.perf_counter() - t0
    check(wrapped == [True] and state.step == DP_SEG_STEPS
          and np.isfinite(losses).all(),
          f"segmenter dp: wrapped {wrapped}, step {state.step}, {losses}")
    check(np.isfinite(summary["validation/miou"]),
          f"segmenter dp: {summary}")
    return dict(steps=state.step, losses=losses, wall_s=wall_s,
                miou=summary["validation/miou"])


def phase_data_parallel(device, small, counts, fit_root, setup, profiles):
    """Phase 17: data parallelism, (a) to (e)."""
    import shutil

    from morefusion_tpu_torch import parallel

    t_phase = time.perf_counter()
    seconds = {}
    root = os.path.join(fit_root, "dp")
    os.makedirs(root, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    flag = ["--small"] if small else []
    # (b) and (c) start first: their processes take a while to reach the
    # card, while (a)'s comparison runs here
    port = parallel.distributed.free_port()
    ranks = [start_child(
        [sys.executable, os.path.abspath(__file__), "--dp-rank-child",
         str(r), "2", str(port), root] + flag,
        os.path.join(root, f"rank{r}.log")) for r in range(2)]
    cfg = FIT_SMALL if small else FIT_FULL
    run = os.path.join(root, "train_torchrun")
    child_json = os.path.join(root, "train_child.json")
    argv = ["--out", run, "--data", os.path.join(fit_root, "train"),
            "--val-data", os.path.join(fit_root, "val"), "--with-occupancy",
            "--loss", "add/add_s+occupancy", "--batch-size",
            str(cfg["batch"]), "--val-batch-size", str(cfg["val_batch"]),
            "--max-steps", str(DP_TRAIN_STEPS), "--eval-interval", "1000",
            "--log-interval", "1", "--min-visibility",
            str(FIT_MIN_VISIBILITY), "--device", device.type]
    if small:
        argv += ["--tiny", "--n-point", "64"]
    trainer_proc = start_child(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", os.path.abspath(__file__),
         "--train-child", child_json] + flag + ["--"] + argv,
        os.path.join(root, "train.log"))

    made = parallel.distributed.initialize_single(device.type)
    try:
        check(made, "dp: a process group was already initialized")
        t = time.perf_counter()
        single, runs, batch_dev = dp_single(device, small, counts, setup)
        seconds["a_compare"] = time.perf_counter() - t
        t = time.perf_counter()
        for i, proc in enumerate(ranks):
            wait_child(proc, os.path.join(root, f"rank{i}.log"),
                       f"dp rank {i}")
        wait_child(trainer_proc, os.path.join(root, "train.log"),
                   "train under torchrun")
        seconds["b_c_children_wait"] = time.perf_counter() - t
        t = time.perf_counter()
        single["timing"] = dp_timing(device, runs, batch_dev)
        del runs, batch_dev
        seconds["a_timing"] = time.perf_counter() - t
        t = time.perf_counter()
        gloo = dp_gloo_report(device, small, setup, root)
        seconds["b_report"] = time.perf_counter() - t
        t = time.perf_counter()
        train = dp_train_report(device, small, run, child_json,
                                os.path.join(root, "train.log"))
        train["form"] = transfer_checks(device, small, fit_root)
        seconds["c_report"] = time.perf_counter() - t
        t = time.perf_counter()
        seg = dp_segmenter(device, small, fit_root)
        seconds["e_segmenter"] = time.perf_counter() - t
    finally:
        for proc, log in ranks + [trainer_proc]:  # none is left running
            kill_child(proc)
            log.close()
        if made:
            torch.distributed.destroy_process_group()
    shutil.rmtree(root)
    seconds["total"] = time.perf_counter() - t_phase
    emit(dict(phase="data_parallel", ok=True, device=str(device),
              model=("SingleView3D occ, full width, fp32, TF32 off"
                     if not small else "tiny"),
              batch=int(len(setup[3]["rgb"])),
              dp_step_ws1=single, dp_step_gloo2=gloo,
              train_torchrun=train, profile_train=profiles,
              segmenter_dp=seg, seconds=seconds,
              tolerance=dict(
                  ws1_vs_bare="identical expected, else phase 6's "
                              "kernel-vs-plain",
                  gloo2_vs_emulation=dict(loss_rtol=STEP_LOSS_RTOL,
                                          update_rtol=STEP_GRAD_RTOL,
                                          update_of_whole=STEP_GRAD_TOTAL),
                  gloo2_kernel_vs_plain="phase 11's, as above",
                  unpack_card_vs_cpu="identical; rgb within 1e-4 of 255")))
    return dict(dp_step_ws1=single["launches"], dp_step_gloo2=gloo["launches"],
                train_transfer=train["child"]["launches"])


# -------------------------------------------------------------- phase 18

# the headless checks (phase 18 (a)), card against CPU: ICP's ADD per
# iteration (m) and the pseudo-occupancy grids (float32 on both sides);
# everything else printed is held equal. The device augmentation's row is
# held at the card's drawn parameters, as tests/test_torch_augment.py
# holds it to JAX at JAX's (1e-5 on [0, 1] images)
CHECK_ADD_ATOL = 1e-5
CHECK_GRID_ATOL = 1e-6
CHECK_AUG_ATOL = 255 * 1e-5
# the campaign (phase 18 (b)): r5tex for one epoch on phase 11's packed
# sets, linked under the names the script waits for
CAMPAIGN = "r5tex"
CAMPAIGN_EPOCHS = 1
CAMPAIGN_DATA = dict(train_tex_s44000_packed="train", val_tex_packed="val")
CAMPAIGN_TIMEOUT = 600  # seconds, under timeout(1)
# written as sitecustomize.py into a directory first on the campaign's
# PYTHONPATH: each Python process of the campaign that imported the
# kernels' wrappers appends their launches to the file named in
# CHIP_SMOKE_LAUNCH_LOG at exit; a sitecustomize that it shadows still runs
LAUNCH_LOG_SITE = '''\
import atexit, importlib.machinery, importlib.util, json, os, sys


def _dump():
    ops = sys.modules.get("morefusion_tpu_torch.ops")
    if ops is not None:
        with open(os.environ["CHIP_SMOKE_LAUNCH_LOG"], "a") as f:
            f.write(json.dumps(dict(
                pid=os.getpid(), argv=sys.argv,
                min_dist_voxels=ops.min_dist_voxels.launches,
                nn_indices=ops.nn_indices.launches)) + "\\n")


atexit.register(_dump)
_here = os.path.dirname(os.path.abspath(__file__))
for _entry in sys.path:
    if os.path.abspath(_entry or os.curdir) == _here:
        continue
    _spec = importlib.machinery.PathFinder.find_spec("sitecustomize", [_entry])
    if _spec is not None:
        _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
        break
'''


def run_check(name, device, out_dir):
    """``checks.<name>.main`` on ``device`` writing into ``out_dir`` ->
    (its result, its printed lines, seconds)."""
    import importlib

    mod = importlib.import_module(f"morefusion_tpu_torch.checks.{name}")
    t = time.perf_counter()
    res, lines = quiet(mod.main, ["--device", device, "--out-dir", out_dir])
    if device != "cpu":
        torch.cuda.synchronize()
    return res, lines, time.perf_counter() - t


def cpu_checks(out_dir, threads):
    """The CPU's side of phase 18 (a), in a background process (on
    ``threads`` threads; None leaves them): every check at ``--device
    cpu``, the plain versions of the kernels."""
    from morefusion_tpu_torch.checks import CHECKS

    if threads:
        torch.set_num_threads(threads)
    return {name: run_check(name, "cpu", os.path.join(out_dir, name))
            for name in CHECKS}


def equal(a, b):
    """Whether two results of a check are the same, entry for entry."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(equal, a, b))
    return np.array_equal(a, b)


# what each check's card run must repeat exactly
CHECK_EQUAL = dict(
    check_scene_generation=("n_objects", "image"),
    check_camera_trajectory=("eyes", "step", "path", "views"),
    check_mapping_render=("agreement", "label", "image"),
    check_segmentation_instances=("counts", "label", "classes",
                                  "device_counts", "device_label",
                                  "device_classes", "image"),
    check_dataset_browse=("class_ids", "pitches", "image"),
    check_augmentation=("row1",),
    check_occupancy_voxelization=("voxels", "vertices"),
    check_icp_convergence=("n_gated",),
)


def compare_checks(device, card, cpu):
    """Card against CPU, check by check (raises on a difference); returns
    the largest differences of the numbers held within a tolerance."""
    from morefusion_tpu_torch.training import augment_device

    for name, keys in CHECK_EQUAL.items():
        for k in keys:
            check(equal(card[name][0][k], cpu[name][0][k]),
                  f"checks: {name}'s {k} on the card differs from the CPU's")
    err = {}
    got, want = (card["check_occupancy_voxelization"][0]["grids"],
                 cpu["check_occupancy_voxelization"][0]["grids"])
    err["grids"] = max(float(np.abs(got[k] - want[k]).max()) for k in got)
    check(err["grids"] <= CHECK_GRID_ATOL,
          f"checks: occupancy grids card vs CPU {err['grids']}")
    got, want = (card["check_icp_convergence"][0]["add"],
                 cpu["check_icp_convergence"][0]["add"])
    check(len(got) == len(want), f"checks: ICP {len(got)} / {len(want)}")
    err["icp_add_m"] = float(np.abs(np.subtract(got, want)).max())
    check(err["icp_add_m"] <= CHECK_ADD_ATOL,
          f"checks: ICP ADD card vs CPU {err['icp_add_m']} m")
    # the card's device augmentation against the CPU's at the card's draws
    aug = card["check_augmentation"][0]
    rgb = torch.from_numpy(aug["row1"][0][None].astype(np.float32))
    err["augmentation"] = 0.0
    for s, row in enumerate(aug["row2_float"], start=1):
        params = augment_device.draw_rgb_params(
            torch.Generator(device=device).manual_seed(s), 1, device)
        want = augment_device.apply_rgb(
            rgb, {k: v.cpu() for k, v in params.items()})[0].numpy()
        err["augmentation"] = max(err["augmentation"],
                                  float(np.abs(row - want).max()))
    check(err["augmentation"] <= CHECK_AUG_ATOL,
          f"checks: device augmentation card vs CPU {err['augmentation']}")
    return err


def start_campaign(fit_root, root):
    """Phase 18 (b): start the campaign script (a session of its own, so
    that :func:`stop_campaign` reaches ``torchrun`` and its worker) on one
    card; its launches are counted through ``LAUNCH_LOG_SITE``."""
    data = os.path.join(root, "data")
    os.makedirs(data)
    for name, split in CAMPAIGN_DATA.items():
        os.symlink(os.path.join(fit_root, split), os.path.join(data, name))
    script = os.path.join(ROOT, "morefusion_tpu_torch", "campaigns",
                          f"{CAMPAIGN}.sh")
    run = dict(run=os.path.join(root, CAMPAIGN), script=script,
               launch_log=os.path.join(root, "launches.jsonl"),
               site=os.path.join(root, "site"),
               log_path=os.path.join(root, "campaign.log"))
    env = dict(os.environ, MFTPU_DATA=data, RETRIES="30",
               MFT_RUNS=os.path.join(root, "runs"), MFT_CAMPAIGN_LOGS=root,
               CHIP_SMOKE_LAUNCH_LOG=run["launch_log"], NPROC="1",
               PYTHONPATH=os.pathsep.join(filter(None, (
                   run["site"], os.environ.get("PYTHONPATH")))))
    os.makedirs(run["site"])
    with open(os.path.join(run["site"], "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_LOG_SITE)
    run["log"] = open(run["log_path"], "w")
    run["t0"] = time.perf_counter()
    run["proc"] = subprocess.Popen(
        ["timeout", "-k", "10", str(CAMPAIGN_TIMEOUT), "bash", script,
         run["run"], str(CAMPAIGN_EPOCHS)], env=env, stdout=run["log"],
        stderr=subprocess.STDOUT, cwd=ROOT, start_new_session=True)
    return run


def stop_campaign(run):
    """End the campaign's processes where they still run (a failure
    elsewhere): SIGTERM to its session (``torchrun`` then stops its
    worker), SIGKILL after 30 s."""
    import signal

    proc = run["proc"]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    run["log"].close()


def finish_campaign(run):
    """Wait for the campaign (``timeout`` bounds it) and check it: exit 0,
    ``training complete``, steps, evaluations, the best snapshot and no
    leak-budget exit."""
    from morefusion_tpu_torch.cli import train as cli_train

    code = run["proc"].wait()
    wall_s = time.perf_counter() - run["t0"]
    with open(run["log_path"]) as f:
        lines = f.read().splitlines()
    said = [ln for ln in lines if ln.startswith("[campaign]")]
    check(code == 0 and "[campaign] training complete" in said,
          f"campaign {CAMPAIGN}: exit {code}, said {said}; the end of its "
          f"log: {lines[-25:]}")
    with open(run["launch_log"]) as f:
        procs = [json.loads(ln) for ln in f]
    rows = read_json(os.path.join(run["run"], "log.json"))
    evals = [r for r in rows if "main/add_or_add_s/auc" in r]
    steps = max(r["iteration"] for r in rows)
    span = (evals[-1]["elapsed_time"] - evals[0]["elapsed_time"]
            if len(evals) > 1 else None)
    check(steps > 0 and evals and os.path.exists(os.path.join(
        run["run"], "snapshot_model_best_validation_main_auc.npz")),
        f"campaign {CAMPAIGN}: {steps} steps, {len(evals)} evaluations")
    check(not os.path.exists(os.path.join(run["run"],
                                          cli_train.LEAK_EXIT_FILE)),
          f"campaign {CAMPAIGN}: a leak-budget exit")
    launches = {k: sum(p[k] for p in procs)
                for k in ("min_dist_voxels", "nn_indices")}
    return dict(
        script=os.path.relpath(run["script"], ROOT), epochs=CAMPAIGN_EPOCHS,
        data={k: f"phase 11's {v}" for k, v in CAMPAIGN_DATA.items()},
        exit_code=code, said=said, wall_s=wall_s, steps=steps,
        evaluations=len(evals),
        steps_per_s_wall=steps / wall_s,
        steps_per_s_first_to_last_eval=(
            (evals[-1]["iteration"] - evals[0]["iteration"]) / span
            if span else None),
        best_auc=max(r["main/add_or_add_s/auc"] for r in evals),
        processes=[dict(argv=p["argv"][:2], min_dist_voxels=p[
            "min_dist_voxels"], nn_indices=p["nn_indices"]) for p in procs],
        launches=launches), launches


def phase_checks_and_campaign(device, small, counts, fit_root):
    """Phase 18: (a) the eight headless checks on the card, against the
    same on the CPU (a background process), counted; (b) the r5tex
    campaign script on the card."""
    import shutil

    from morefusion_tpu_torch.checks import CHECKS

    t0 = time.perf_counter()
    root = os.path.join(fit_root, "checks")
    os.makedirs(root)
    seconds = {}
    start_background("checks_cpu", cpu_checks, os.path.join(root, "cpu"),
                     None if small else BACKGROUND_THREADS, inline=small)
    # the campaign trains beside the card's checks, which are host work
    # but for a few launches
    run = (None if small
           else start_campaign(fit_root, os.path.join(root, "campaign")))
    try:
        card, launches = {}, {}
        for name in CHECKS:
            for c in counts:
                c.launches = 0
            card[name] = run_check(name, device.type,
                                   os.path.join(root, "card", name))
            launches[name] = {c.__name__: c.launches for c in counts}
        seconds["a_card"] = time.perf_counter() - t0
        if small:
            campaign, campaign_launches = dict(
                skipped="the CPU rehearsal: r5tex trains SingleView3D at "
                        "full width, B = 16"), dict(min_dist_voxels=0,
                                                    nn_indices=0)
        else:
            check(launches["check_occupancy_voxelization"][
                "min_dist_voxels"] > 0 and launches[
                "check_icp_convergence"]["nn_indices"] > 0,
                f"checks: kernels not launched {launches}")
            campaign, campaign_launches = finish_campaign(run)
            seconds["b_campaign"] = time.perf_counter() - run["t0"]
    finally:
        if run is not None:
            stop_campaign(run)
    t = time.perf_counter()
    cpu, wall_s = finish_background("checks_cpu")
    seconds["a_cpu_wait"] = time.perf_counter() - t
    err = compare_checks(device, card, cpu)
    shutil.rmtree(root)
    seconds["total"] = time.perf_counter() - t0
    emit(dict(
        phase="checks_and_campaign", ok=True, device=str(device),
        checks={name: dict(
            printed=[ln for ln in card[name][1] if not ln.startswith(
                "wrote")],
            ms=card[name][2] * 1e3, cpu_ms=cpu[name][2] * 1e3,
            launches=launches[name]) for name in CHECKS},
        card_vs_cpu=err, cpu_background_wall_s=wall_s,
        campaign=campaign, seconds=seconds,
        tolerance=dict(icp_add_m=CHECK_ADD_ATOL, grids=CHECK_GRID_ATOL,
                       augmentation_at_the_card_draws=CHECK_AUG_ATOL,
                       rest="identical")))
    return dict(
        check_occupancy_voxelization=launches[
            "check_occupancy_voxelization"],
        check_icp_convergence=launches["check_icp_convergence"],
        **{f"campaign_{CAMPAIGN}": campaign_launches})


# ------------------------------------------------------------------ main


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cpu: rehearse at a reduced size, no card")
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("--dp-rank-child", "--train-child"):
        return child_main(argv)  # a process of phase 17
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # deterministic cuBLAS, for phase 3's deterministic comparison; must be
    # set before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, ROOT)
    from morefusion_tpu_torch.ops import _build
    from morefusion_tpu_torch.ops import knn
    from morefusion_tpu_torch.ops import min_dist as md

    device = torch.device(args.device)
    small = device.type == "cpu"
    counts = [md.min_dist_voxels, knn.nn_indices]
    if small:
        torch.set_num_threads(min(8, os.cpu_count() or 1))
        print("cpu rehearsal: no card", flush=True)
    else:
        print(card_line(), flush=True)
        build_s, ptxas = _build.build(ptxas_verbose=True)
        _build.load()
        emit(dict(build_s=build_s, nvcc=" ".join(_build.COMPILE_FLAGS),
                  ptxas=[ln.strip() for ln in ptxas.splitlines()
                         if "Used" in ln]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # the C++ mapping of the data and the scene pipeline (phases 8-11),
    # then phase 11's data, made in forked workers before anything else
    # runs on the card
    from morefusion_tpu_torch.contrib import mapping_native
    built = mapping_native.stale()
    native_build = dict(built=built,
                        build_s=mapping_native.build() if built else None)
    mapping_native.load_library()
    fit_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_fit_")
    try:
        return run_phases(device, small, counts, native_build, fit_dir.name)
    finally:
        stop_background()
        fit_dir.cleanup()


def run_phases(device, small, counts, native_build, fit_root):
    fit_data_info = fit_data(fit_root, small)
    rest_data_info = rest_data(fit_root, small)
    ycb_data_info = ycb_data(fit_root, small)
    setup = train_setup(device, small)
    train_inputs = train_min_dist_inputs(setup[1], setup[3], device)
    icp_scene = make_icp_scene(9, small)
    t0 = time.perf_counter()
    scene_models, frames = pipeline_frames(small)
    frames_s = time.perf_counter() - t0
    extra_scenes = [pipeline_frames(small, seed)[1]
                    for seed in EXTRA_SCENE_SEEDS[:1 if small else None]]
    max_err = phase_kernel_vs_plain(device, small, train_inputs)
    (serving_icp_launches, serving_resize_launches,
     serving_boxes_launches) = phase_serving(device, small, counts)
    icc_launches = phase_icc(device, small, counts)
    if not small:
        check(icc_launches > 0, "icc: the min_dist kernel was never launched")
    timing = phase_kernel_timing(device, small, train_inputs)
    del train_inputs
    knn_err = phase_knn_vs_plain(device, small)
    train_launches, bare_step_ms, resize_row = phase_train(
        device, small, counts, setup)
    maskrcnn_rows = maskrcnn_kernels_vs_plain(device, small)
    boxes_row = instance_boxes_vs_plain(device, small)
    knn_timing = phase_knn_timing(device, small,
                                  icp_clouds(icp_scene, device))
    icp_launches = phase_icp(device, small, counts, icp_scene, scene_models,
                             [frames] + extra_scenes)
    if not small:
        check(icp_launches > 0, "icp: the knn kernel was never launched")
    (pipeline_launches, pipeline_bf16_launches, pipeline_icp_launches,
     model16) = phase_pipeline(device, small, counts, scene_models, frames,
                               frames_s, native_build)
    segmenter_launches = phase_segmenter(device, small, counts, scene_models,
                                         frames, model16)
    fit_launches, fit_bf16_launches = phase_fit(
        device, small, counts, fit_data_info, fit_root, bare_step_ms)
    eval_launches, finish_eval = phase_evaluation(device, small, counts,
                                                  fit_root)
    textured_launches, posenet_launches, trained_seg_launches = phase_rest(
        device, small, counts, fit_root, rest_data_info, setup,
        scene_models, frames, model16)
    p14, occupancy, finish_replay = phase_replay_and_tools(
        device, small, counts, fit_root)
    p15 = phase_robot(device, small, counts, fit_root, frames)
    p16 = phase_data_side(device, small, counts, fit_root, ycb_data_info)
    p17 = phase_data_parallel(device, small, counts, fit_root, setup,
                              p16["profile_train_steps"])
    p18 = phase_checks_and_campaign(device, small, counts, fit_root)
    # the CPU's sides of phases 12 and 14, run beside the later phases
    finish_eval()
    finish_replay()
    # the first shape is align_occupancy_grids' (its defaults)
    occ_timing = next(iter(occupancy["grids"].values()))

    kernels = [dict(
        name="min_dist", route="cuda",
        source="morefusion_tpu_torch/csrc/min_dist.cu",
        replaces="morefusion_tpu/ops/min_dist_pallas.py:60",
        launches=(icc_launches + train_launches["min_dist_voxels"]
                  + pipeline_launches + pipeline_bf16_launches
                  + segmenter_launches + fit_launches["min_dist_voxels"]
                  + fit_bf16_launches["min_dist_voxels"]
                  + eval_launches["min_dist_voxels"]
                  + textured_launches["min_dist_voxels"]
                  + posenet_launches["min_dist_voxels"]
                  + trained_seg_launches
                  + sum(p14[k]["min_dist_voxels"] for k in (
                      "occupancy_registration", "replay", "unpadded_icc"))
                  + sum(p15.values())
                  + sum(p16[k]["min_dist_voxels"] for k in (
                      "ycb_fit", "profile_train", "profile_backward",
                      "geometry_nn"))
                  + sum(v["min_dist_voxels"] for v in p17.values())
                  + sum(v["min_dist_voxels"] for v in p18.values())),
        launches_by_path=dict(icc_refine=icc_launches,
                              train_5_steps=train_launches["min_dist_voxels"],
                              scene_pipeline=pipeline_launches,
                              scene_pipeline_bf16=pipeline_bf16_launches,
                              scene_pipeline_segmenter=segmenter_launches,
                              fit=fit_launches["min_dist_voxels"],
                              fit_bf16=fit_bf16_launches["min_dist_voxels"],
                              evaluation=eval_launches["min_dist_voxels"],
                              evaluation_textured=textured_launches[
                                  "min_dist_voxels"],
                              posenet_fit=posenet_launches["min_dist_voxels"],
                              scene_pipeline_trained_segmenter=(
                                  trained_seg_launches),
                              occupancy_registration=p14[
                                  "occupancy_registration"][
                                  "min_dist_voxels"],
                              replay_eval=p14["replay"]["min_dist_voxels"],
                              unpadded_icc=p14["unpadded_icc"][
                                  "min_dist_voxels"],
                              ros_node=p15["ros_node"],
                              pick_episode=p15["pick_episode"],
                              demo=p15["demo"],
                              ycb_fit=p16["ycb_fit"]["min_dist_voxels"],
                              profile_train=p16["profile_train"][
                                  "min_dist_voxels"],
                              profile_backward=p16["profile_backward"][
                                  "min_dist_voxels"],
                              **{k: v["min_dist_voxels"]
                                 for k, v in {**p17, **p18}.items()}),
        max_abs_err=max_err, ms=timing["kernel_ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
        slots_per_pair=timing["slots_per_pair"],
        host_ms=timing["host_ms"],
        train_shape={k: timing["train"][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "slots_per_pair", "host_ms")},
        evaluation_shapes={case: {k: row[k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "slots_per_pair", "host_ms")}
            for case, row in timing["evaluation"].items()},
        occupancy_shape={k: occ_timing[k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "slots_per_pair", "host_ms")},
    ), dict(
        name="knn", route="cuda",
        source="morefusion_tpu_torch/csrc/knn.cu",
        replaces="morefusion_tpu/ops/knn_pallas.py:36",
        launches=(train_launches["nn_indices"] + icp_launches
                  + serving_icp_launches + pipeline_icp_launches
                  + fit_launches["nn_indices"]
                  + fit_bf16_launches["nn_indices"]
                  + eval_launches["nn_indices"]
                  + textured_launches["nn_indices"]
                  + posenet_launches["nn_indices"]
                  + p14["replay"]["nn_indices"]
                  + p14["align_pointclouds"]["nn_indices"]
                  + sum(p16[k]["nn_indices"] for k in (
                      "ycb_fit", "profile_train", "profile_backward",
                      "geometry_nn"))
                  + sum(v["nn_indices"] for v in p17.values())
                  + sum(v["nn_indices"] for v in p18.values())),
        launches_by_path=dict(train_5_steps=train_launches["nn_indices"],
                              icp=icp_launches,
                              serving_icp=serving_icp_launches,
                              scene_pipeline_icp=pipeline_icp_launches,
                              fit=fit_launches["nn_indices"],
                              fit_bf16=fit_bf16_launches["nn_indices"],
                              evaluation=eval_launches["nn_indices"],
                              evaluation_textured=textured_launches[
                                  "nn_indices"],
                              posenet_fit=posenet_launches["nn_indices"],
                              replay_eval=p14["replay"]["nn_indices"],
                              align_pointclouds=p14["align_pointclouds"][
                                  "nn_indices"],
                              ycb_fit=p16["ycb_fit"]["nn_indices"],
                              profile_train=p16["profile_train"][
                                  "nn_indices"],
                              profile_backward=p16["profile_backward"][
                                  "nn_indices"],
                              geometry_nn=p16["geometry_nn"]["nn_indices"],
                              **{k: v["nn_indices"]
                                 for k, v in {**p17, **p18}.items()}),
        max_abs_err=knn_err, ms=knn_timing["kernel_ms"],
        plain_ms=knn_timing["plain_ms"], bound_ms=knn_timing["bound_ms"],
        bound_by=knn_timing["bound_by"], library_ms=knn_timing["library_ms"],
        slots_per_pair=knn_timing["slots_per_pair"],
        icp_shape={k: knn_timing["icp_shape"][k] for k in (
            "shape", "kernel_ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
    ), dict(
        name="resize", route="cuda",
        source="morefusion_tpu_torch/csrc/resize.cu",
        replaces=None,  # the JAX package resizes with jax.image.resize
        launches=(serving_resize_launches
                  + train_launches["resize_bilinear"]
                  + resize_row["launches"]
                  + maskrcnn_rows["resize_frame_launches"]),
        launches_by_path=dict(serving=serving_resize_launches,
                              train_5_steps=train_launches["resize_bilinear"],
                              kernel_vs_plain=resize_row["launches"],
                              maskrcnn_frames=maskrcnn_rows[
                                  "resize_frame_launches"]),
        max_grad_err_of_terms=resize_row["max_grad_err_of_terms"],
        ms=resize_row.get("kernel_ms"),
        **{k: resize_row.get(k) for k in (
            "kernel_ms", "kernel_fwd_ms", "kernel_bwd_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_fwd_ms",
            "library_bwd_ms")},
        shapes=[{k: r.get(k) for k in (
            "shape", "kernel_fwd_ms", "kernel_bwd_ms", "bound_ms",
            "library_fwd_ms", "library_bwd_ms")}
            for r in resize_row["shapes"]],
    )] + [dict(
        name=name, route="cuda",
        source=f"morefusion_tpu_torch/csrc/{name}.cu",
        replaces=None,  # the JAX package has no detector
        launches=row["launches"] + row["frame_launches"],
        launches_by_path=dict(maskrcnn_frames=row["frame_launches"],
                              kernel_vs_plain=row["launches"]),
        ms=row.get("ms"), plain_ms=row.get("plain_ms"),
        bound_ms=row["bound_ms"],
        calls=row["calls"], tolerance=row["tolerance"])
        for name, row in maskrcnn_rows.items()
        if name in ("roi_align", "nms")] + [dict(
        name="instance_boxes", route="cuda",
        source="morefusion_tpu_torch/csrc/instance_boxes.cu",
        replaces=None,  # the JAX package selects the instances on the host
        launches=serving_boxes_launches + boxes_row["launches"],
        launches_by_path=dict(serving=serving_boxes_launches,
                              kernel_vs_plain=boxes_row["launches"]),
        ms=boxes_row.get("kernel_ms"), plain_ms=boxes_row.get("plain_ms"),
        **{k: boxes_row.get(k) for k in (
            "bound_ms", "bound_by", "kernel_host_ms", "plain_wall_ms",
            "host_rule_ms")})]
    emit(dict(script_s=time.perf_counter() - _START))
    if small:
        emit(dict(rehearsal_kernels=kernels))
        emit(dict(ok=True, rehearsal="cpu"))
        return 0
    emit(dict(kernels=kernels))
    print(card_line(), flush=True)
    emit(dict(ok=True, device=dict(platform="gpu",
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
