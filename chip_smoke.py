"""Drive the PyTorch port (mvs_tpu_torch) of CasMVSNet, MVSNet, CVP-MVSNet,
AACVP-MVSNet and Point-MVSNet inference and training on one CUDA card,
holding each hand-written kernel against its plain version.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device check (CUDA required), card name and power limit, kernel build;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes in bf16 and f32 (bf16 timed: kernel, plain, library
     call, bound) and at awkward shapes (batch 2, D = 1 and 2, sizes that
     cross the conv kernel's tiles and z runs, Cin = 12, AACVP's Cin = 4,
     ragged C, off-image and behind-camera samples, the depth step of
     make_step_scene), each on the kernel variant it should take (conv:
     bf16 tensor cores, f32 3xTF32 tensor cores, its Cin = 64 kernel, or
     direct; conv_variant); the f32 convs at
     Cin = 64 at those shapes (64->8, 64->32, 64->64) and at CasMVSNet's
     three, timed (kernel, plain, cuDNN f32 with TF32 off, the 3xTF32 and
     f32 CUDA-core bounds); an unaligned x raises on each tensor-core
     variant and launches nothing;
  3. one seeded CasMVSNet at 128x160, f32 and bf16, card (kernels) against
     CPU (plain): each stage's pre-softmax scores, depth and confidence;
  4. full width: 1152x864, 5 views, 48/32/8 hypotheses, bf16 and f32, through
     cli.infer.make_apply_fn, with the launch counts per kernel variant on
     that run (exact: 3 warp, all vector; 15 conv, all on the tensor-core
     kernel in bf16, in f32 12 on the 3xTF32 one and 3 on its Cin = 64
     kernel, none direct), and the bf16 map's
     device time by layer and, from
     torch.profiler, its top kernels and the device's idle share;
  5. run_batched_inference at batch 2 over 3 samples (a padded tail), PFM
     and cam files written and one read back;
  6. the user's path from a DTU scan on disk to a fused cloud and its score:
     (a) a synthetic DTU eval scan written by utils.make_synthetic_dtu, 11
         views at 1152x864, tilted plane, 192-hypothesis ladder, every ref
         with 10 ranked sources;
     (b) `infer` (cli.infer.main) over it from a seeded bf16 CasMVSNet
         saved as .pt, batch 2: 11 maps, with the launch counts of that run
         (exact: 6 x 3 warp, all vector; 6 x 15 conv, all tensor-core),
         maps/s through the CLI, one map's host load and writes, and the
         PNG write at zlib level 1 (io.png's) against level 6;
     (c) fusion.fuse_scene on the card against the CPU on noisy analytic
         depths at 288x216, 11 views x 10 sources;
     (d) the scan's analytic depths ("oracle" maps) at full width through
         `fuse` and `evaluate` (cli.fuse.main, cli.evaluate.main): the CLI's
         own fuse_scene call in device ms and its compaction + PLY write in
         host ms, evaluation seconds, acc / comp within limits;
     (e) `fuse` over the model's maps of (b) with configs/cas_eval_dtu.yaml's
         thresholds: a valid PLY;
  7. CasMVSNet training at the shapes of the JAX training envelope
     (bench.py --train: 640x512, 5 views, 48/32/8, bf16, batch 4, Adam):
     (a) the warp's backward kernel against autograd through the plain
         version at the three stage shapes, f32 and bf16 (timed in bf16:
         kernel, plain, bound), on make_plane_scene's default rig and on a
         DTU-like rig (focal 1446 px, DTU_FOCAL), each launch with its
         sources' sweep in pixels and its rate of dsrc adds;
     (b) one train step card against CPU in f32 at phase 3's size: loss,
         every parameter's gradient, the new BatchNorm statistics and
         count, the parameters after one Adam step;
     (c) full width: launches per step (exact: 3 warp forward, 3 warp
         backward, 0 conv3d_affine), 8 timed steps (ms per step, samples/s,
         peak memory), forward ms by layer kind, forward / backward /
         optimizer ms, device ms by kernel family (torch.profiler), then 30
         steps on the same batch: finite losses that fall;
     (d) `train` (cli.train.main) on a synthetic DTU training layout
         (images 640x512, depths 160x128) for 2 epochs with a val split and
         a checkpoint per epoch, with the launch counts of that run; then
         `infer --step best` and `--step latest` from its checkpoints;
  8. CVP-MVSNet and AACVP-MVSNet at configs/cvp_eval_dtu.yaml's widths (5
     levels, 48 coarse + 8 residual hypotheses, 16 feature channels,
     regularizer base 16, 5 views), images 1600x1184 (data.align=32):
     (a) the group-correlation kernel against its plain version at each
         AACVP level shape, f32 and bf16, timed (kernel, plain, bound), and
         at batch 2, C = 12 (scalar variant), D = 1, C = 24 in 2 groups,
         C = 16 in 8, C = 160 and 264 in 4 (past the lane kernel's 32
         chunks but bf16 160), off-image and behind-camera samples; AACVP's f32
         convs, (4, 16) and (16, 16), at every level on the 3xTF32 kernel,
         timed (kernel, plain, cuDNN f32 with TF32 off, the f32 operation,
         byte and 3xTF32 bounds) and summed over a map's 10; the 15 f32
         convs at Cin = 64 of an f32 CVP / AACVP map (the two (64, 64)
         blocks and the stride-1 transposed 64->32 at every level) on the
         3xTF32 Cin = 64
         kernel, timed and summed alike; the
         warp-variance and conv3d kernels at CVP's coarsest and finest
         levels (every regularizer conv, the stride-1 transposed block's
         64->32 among them);
     (b) seeded CVP and AACVP at 128x160, 3 levels, f32 and bf16, card
         against CPU: each level's pre-softmax scores and depth, and the
         confidence;
     (c) full width through cli.infer.make_apply_fn, bf16 and f32, for both:
         ms per map, peak memory, launches per kernel variant (exact: CVP 5
         warp / 45 conv3d / 0 group correlation, AACVP 0 / 45 / 5; AACVP's
         bf16 conv3d 35 bf16 tensor-core and 10 3xTF32, every f32 map 30
         3xTF32 and 15 on the 3xTF32 Cin = 64 kernel, 0 direct), bf16
         device ms by layer kind and the profiler's idle share;
     (d) `infer --config configs/cvp_eval_dtu.yaml data.align=32` over a
         synthetic DTU scan of 6 views at 1600x1200 for both (seeded bf16
         weights saved as .pt): maps/s and launches; then `fuse` with the
         config's thresholds writes a valid PLY;
     (e) the same config at its own align 16 (1600x1200, a 75-row coarsest
         level) raises the port's ValueError before any launch;
  9. MVSNet at its widths (32 feature channels, regularizer base 8, the
     192-hypothesis ladder, 5 views) over configs/cas_eval_dtu.yaml with
     model.name=mvsnet data.max_h=1200 data.max_w=1600 (1600x1184 images,
     400x296 maps):
     (a) the warp forward at that sweep (a 1.455 GB bf16 volume), bf16 and
         f32, and its backward at the training shape (batch 4, 2 sources,
         160x128, D = 192) on both rigs of 7a, against their plain
         versions, bf16 timed (kernel, plain, bound); the U-Net's f32
         (64, 64) conv at 24x37x50 on the 3xTF32 Cin = 64 kernel against
         its plain version, timed as 2b's;
     (b) a seeded MVSNet with RefineNet at 128x160, f32 and bf16, card
         against CPU: the pre-softmax scores, depth, refined depth and
         confidence;
     (c) full width through cli.infer.make_apply_fn, bf16 and f32: ms per
         map, peak memory, launches (exact: 1 warp, vector; 5 conv3d, all
         tensor-core in bf16, in f32 4 3xTF32 and 1 on its Cin = 64
         kernel), bf16 device ms by layer kind and the
         profiler's idle share;
     (d) one f32 train step card against CPU (RefineNet, smooth-L1), then
         training at 640x512, 3 views, bf16, batch 4 with
         configs/cas_train_dtu.yaml's model and task: launches per step
         (exact: 1 warp forward, 1 warp backward, 0 conv3d), ms per step,
         samples/s, peak memory, 30 steps whose losses fall;
     (e) `infer` over phase 8d's scan with model.name=mvsnet (batch 6),
         launches exact, then `fuse` writes a valid PLY;
     (f) `train model.name=mvsnet model.refine=true train.loss=ohem` on a
         synthetic training layout (2 steps, a val split, a checkpoint),
         launches exact, then `infer` from its checkpoint;
 10. CVP-MVSNet and AACVP-MVSNet training at configs/cvp_train_dtu.yaml's
     widths (2 levels, 48 coarse + 2 x 4 residual hypotheses at the fixed
     interval, 16 feature channels, regularizer base 16, 3 views):
     (a) the warp backward with and without the hypotheses' gradient and
         the group-correlation backward with and without it, against their
         plain versions at the training shapes (batch 4, 640x512 images:
         level 1 D = 48 at 320x256, level 0 D = 8 at 640x512), f32 and
         bf16, timed (kernel, plain, bound) in bf16 and for the group
         correlation also in f32; the main path's variants again on 7a's
         DTU-like rig; a case built to need the kernels' spill branch (a
         source at 10x the reference's focal, one with depths behind it),
         f32 and bf16, with and without the hypotheses' gradient; and at
         batch 2, C = 12 / 20 (scalar variant), C = 24, D = 1 and 2,
         off-image, behind-camera and integer-coordinate samples;
     (b) one f32 train step card against CPU for each family at 128x160
         (phase 7b's limits; BatchNorm counts 2, one per level);
     (c) training at 640x512, 3 views, bf16, batch 4 (the config: 16):
         launches per step (exact: CVP 2 warp forward, 2 backward of which
         1 with the hypotheses' gradient; AACVP the same of the group
         correlation; 0 conv3d), ms per step, samples/s, peak memory,
         device ms by layer and kernel family, 20 falling losses;
     (d) `train --config configs/cvp_train_dtu.yaml` for each family on a
         synthetic training layout (2 steps, a val split, a checkpoint),
         launches exact, then `infer --config configs/cvp_eval_dtu.yaml
         data.align=32 --step latest` from its checkpoint;
 11. Point-MVSNet at its default widths (image and volume base 8, flow
     channels 64/64/16/1, k = 16, flow scales 1/4 and 1/2), f32, over
     configs/cas_eval_dtu.yaml with model.name=point_mvsnet at 1280x960
     (96 coarse hypotheses over the DTU ladder, 5 views); training with
     configs/cas_train_dtu.yaml at 640x512, 3 views, 48 hypotheses:
     (a) the warp forward at a map's 7 shapes (the coarse volume, C = 64,
         D = 96, 160x120; the flow's C = 16 / 32 / 64 with 5 per-pixel
         hypotheses at 320x240 and 640x480) in f32 and bf16, f32 timed
         (kernel, plain, bound); its backward at a train step's 7 shapes,
         the flow's with and without the hypotheses' gradient, timed as
         the path runs them; VolumeConv's two f32 convs at Cin = 64 on the
         3xTF32 Cin = 64 kernel (64->8 at 96x120x160, 64->64 at 12x15x20),
         timed (kernel, plain, cuDNN f32 with TF32 off, bounds);
     (b) a seeded model at 128x160, 3 views, 16 hypotheses, card against
         CPU, untiled and at flow_sub_stride=2, the card on the CPU's kNN
         graphs (GraphTape: near ties on the regular lattice): the coarse
         pre-softmax score, coarse depth and probability map, both flows
         and their probabilities;
     (c) full width through cli.infer.make_apply_fn at flow_sub_stride 4
         and 1: ms per map, peak memory, launches (exact: 7 warp, all
         vector; 5 conv3d, 3 on the 3xTF32 kernel and 2 on its Cin = 64
         kernel, none direct), device ms
         by layer (image towers, coarse volume, VolumeConv, flow features,
         kNN, EdgeConvs, MLP / head, rest) and the profiler's top kernels
         and idle share;
     (d) `infer` over phase 8d's scan (fitted to 1280x960, stride 4, batch
         1), launches exact, then `fuse` writes a valid PLY;
     (e) one f32 train step card against CPU (phase 7b's limits, or the
         card no farther from the CPU's float64 step than the CPU's f32
         step; the card on the CPU's graphs; the ladder 2 below the GT
         plane, away from the masked MAE's kink), then training at full width, batch 4:
         launches per step (exact: 7 warp forward, 7 backward of which 6
         with the hypotheses' gradient, 0 conv3d), ms per step,
         samples/s, peak memory, 20 falling losses;
     (f) `train model.name=point_mvsnet` on a synthetic training layout (2
         steps, a val split, a checkpoint), launches exact, then `infer`
         from its checkpoint;
 12. mvs_tpu's quality matrix (tests/test_e2e_matrix.py) through the CLIs
     on the multi-object fixture (64x96, 5 views, 2 scans, 16 hypotheses):
     each family trained by `train` in f32 at mvs_tpu's settings (global
     batch 2 on one card; mvs_tpu splits it over train.mesh_data=2),
     inferred by `infer` in f32 and, for the four with a bf16 path, bf16;
     the mean depth error held to mvs_tpu's gates against the constant-z0
     floor; CasMVSNet's maps through `fuse` and `evaluate` (overall < 0.30);
     launches per family; then each bf16-capable checkpoint over one
     objects scan at its family's full width, f32 and bf16: errors against
     GT, bf16 within 1.25x f32's, |bf16 - f32| in finest intervals;
 12b. phase 6d's oracle cloud (~10.4M points) scored whole through the
     native KD-tree (mvs_tpu_torch.native, required), host seconds; its
     GT-window crop through the native and the scipy branch, which agree
     within 1e-5;
 13. data-parallel and view-sharded training (mvs_tpu_torch.parallel):
     (a) the warp kernel's partial-moment variant, forward and backward,
         against its plain version at CasMVSNet's three training stages
         (640x512, batch 4, the 4 sources split 2 + 2, the reference on
         view rank 0), f32 and bf16, bf16 timed (kernel, plain, bound),
         then one and three local views, C = 12 and 16, the reference on
         and off, ddepth on and off, off-image and behind-camera samples;
         then at (b)'s MVSNet view=2 inputs (batch 4, D = 192, 160x128,
         C = 32, one source view a rank, the reference on and off), f32
         and bf16, timed;
     (b) two ranks on the one card over gloo (`--rank-worker`, the backend
         rule for a named card), each configuration against one process on
         the same global batch (4) and weights, 2 SGD steps: CasMVSNet
         data=2 in bf16, MVSNet view=2 (D = 192, one source view a rank)
         in bf16 and in f32: each step's loss, the update-norm ratio, the
         ranks' parameters bit for bit, the launches of a step (the
         partial kernels in the view=2 runs), every run to the same
         limits; one MVSNet process's bf16 / f32 update norm; ms per
         step labelled as two ranks sharing a card; with two or more
         cards, also over NCCL, a card a rank, and with four, CasMVSNet
         data=4 and MVSNet data=2 x view=2 in f32 over NCCL (samples/s of
         the global batch);
     (c) `torchrun --standalone --nproc_per_node=1 -m mvs_tpu_torch.cli
         train` (NCCL, world size 1): 2 steps and a checkpoint, --resume;
     (d) cli.fuse.fuse_scans over the visible cards and as two streams on
         one card: the serial path's clouds;
 14. a user's own scene, the model variants and cli profile:
     (a) a make_objects_scene scan rendered at Tanks and Temples' 1920x1080,
         7 views, PNG images, written as a COLMAP text and binary model
         (surface points under every 24th pixel, each point's track the
         views where it passes the depth test), both converted by `python
         -m mvs_tpu_torch.io.colmap` (identical outputs; cams the scene's
         within 1e-5; each view's ladder holds 95% of its visible GT depths);
         `infer --config configs/cas_eval_tnt.yaml` over it (seeded bf16
         weights, batch 2, 48/32/8, served at 1856x1056: the loader's fit
         of 1920x1080 into 1920x1056 at align 32), launches exact (3 warp,
         15 bf16 conv a batch), maps finite and inside their ladders; ms per
         map of one batch (3 synchronised runs), maps/s from disk, peak
         memory; one batch card against CPU at a 256x480 crop (phase 3's
         limits); `fuse` with the config's thresholds writes a PLY whose
         header parses;
     (b) each variant's seeded model card against CPU at 128x160, f32 and
         bf16 (Point-MVSNet f32): CasMVSNet with unet features, share_cr,
         normalization none and group; MVSNet, CVP-MVSNet, AACVP-MVSNet and
         Point-MVSNet under group and none (scores of every regularizer
         call, depth, confidence; phase 8b's bf16 yardstick; Point-MVSNet
         on the CPU's kNN graphs); a bf16 CasMVSNet map at 1152x864 with
         share_cr + unet + none (ms, launches exact: 3 warp, 15 conv with a
         unit affine); 3 `train` steps of CasMVSNet under group norm with
         MVS_TPU_DEBUG_NANS=1 (finite losses, the val panel PNG written);
     (c) `cli profile` and `cli profile --train` on the card: the trace is
         written and its table names the warp-variance and conv3d kernels
         (the warp's backward in the train step);
 15. the cost volumes split over depth slabs and row tiles
     (mvs_tpu_torch.parallel.sharding, .halo):
     (a) at CasMVSNet's 640x512 batch-4 train stages (bf16), the warp
         forward and backward on one rank's row window and depth slab
         against the whole volume's rows (bit for bit) and the plain
         version on the slab; the fused conv3d on a halo-extended slab,
         cropped, against the whole volume's rows; each timed beside the
         whole volume's launch;
     (b) 13b's configurations over depth=2, space=2 and depth=2 x space=2
         ranks sharing the card over gloo (with as many cards, also NCCL),
         held to 13b's one process by 13b's limits (the bf16 MVSNet runs
         too: their ranks sum the features' cotangent before the feature
         net's backward); every rank's warp launches a step equal to one
         process's;
         per-rank peak memory and ms per step;
     (c) `cli train` (configs/cas_train_dtu.yaml) over depth=2 x space=2
         ranks, 2 steps with validation (the conv3d kernel on halo-extended
         slabs), each rank's launches exact, rank 0 naming each volume's
         layout; (d) `cli profile --train` over 8 ranks (parallel.dryrun's
         step), a trace a rank;
then one JSON line listing the kernels (the 3xTF32 conv,
conv3d_affine.tf32x3, as an entry of its own: times over 8a's 10 AACVP f32
launches, launches per AACVP bf16 map, 8c; elsewhere launches: per map,
phase 4's run,
per train step for the backward kernel, phase 7c, per AACVP map for the
group correlation, 8c; cli_launches: phase 6b's run, 7d's and 8d's;
cvp_launches / cvp_cli_launches: CVP's per map, 8c, and through 8d;
mvsnet_launches / mvsnet_train_launches / mvsnet_cli_launches /
mvsnet_cli_train_launches: MVSNet's per map, 9c, per train step, 9d, and
through 9e and 9f; mvsnet_ms / mvsnet_plain_ms / mvsnet_bound_ms /
mvsnet_max_abs_err: one launch at MVSNet's shape, 9a; on every kernel
{cvp,aacvp}_train_launches and {cvp,aacvp}_cli_train_launches: per CVP /
AACVP train step, 10c, and through 10d's cli train runs; cvp_train_ms /
_plain_ms / _bound_ms / _max_abs_err: the warp backward's two launches of
one CVP train step, 10a; the group correlation's backward as a kernel of
its own, timed over one AACVP train step, 10a; dtu_rig_ms /
dtu_rig_max_abs_err on both backwards, and dtu_rig_mvsnet_* and
dtu_rig_cvp_train_* on the warp's: the same launches on the DTU-like rig;
on every kernel point_launches / point_train_launches /
point_cli_launches / point_cli_train_launches: per Point-MVSNet map, 11c,
per train step, 11e, and through 11d and 11f; point_ms / _plain_ms /
_bound_ms / _max_abs_err on the warp: a Point-MVSNet map's 7 f32
launches, 11a, and point_train_* on its backward: a train step's 7; the
3xTF32 conv at Cin = 64, conv3d_affine.tf32x3_cin64, as an entry of its
own: times over Point-MVSNet's two Cin = 64 convs, 11a, launches per
Point-MVSNet map, 11c, cvp_* times over an f32 CVP / AACVP map's 15, 8a,
cas_* over an f32 CasMVSNet map's 3, 2b, mvsnet_* over an f32 MVSNet
map's 1, 9a, and launches per f32 map of each family; the partial-moment
forward and backward, warp_variance_partials and _grad: times of one
launch at 13b's bf16 MVSNet view=2 inputs on view rank 0, 13a, beside
view rank 1's (view_rank1_*), both in f32 (f32_view_rank*_) and the sums
over one view rank's three launches of a bf16 CasMVSNet train step
(cas_train_*), launches per train step of view rank 0 of 13b's bf16
MVSNet view=2 run; on the warp and conv3d tnt_launches per T&T batch of
2 and tnt_cli_launches through 14a's `infer`, share_cr_unet_none_launches
per map of 14b's 1152x864 run, group_cli_train_launches through its
group-norm `train` run (also on the backward), none_bf16_launches of the
conv per bf16 map of CasMVSNet under none; on the warp and conv3d
{cas,mvsnet,mvsnet_f32}_<mesh>_train_launches per train step of rank 0 of
each 15b mesh, volume_cli_launches a rank of 15c's run, and the sums of
15a's launches: row_window_* on the warp, halo_slab_* on the conv, each
with the whole volume's time and the bound), a line with the script's
seconds, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from mvs_tpu_torch.cli import evaluate as cli_evaluate
from mvs_tpu_torch.cli import fuse as cli_fuse
from mvs_tpu_torch.cli import infer as cli_infer
from mvs_tpu_torch.cli import profile as cli_profile
from mvs_tpu_torch.cli import train as cli_train
from mvs_tpu_torch.cli.infer import (make_apply_fn, run_batched_inference,
                                     stack_model_inputs, write_depth_outputs)
from mvs_tpu_torch import native
from mvs_tpu_torch.dtu_eval import evaluate_scan
from mvs_tpu_torch.fusion import FusionConfig, fuse_scene
from mvs_tpu_torch.geometry.homography import plane_sweep_coords
from mvs_tpu_torch.io import png as png_codec
from mvs_tpu_torch.io import read_pfm, read_ply, write_pfm, write_ply
from mvs_tpu_torch.io.cams import CameraParams, read_cam_file, write_cam_file
from mvs_tpu_torch.io.colmap import write_colmap_model
from mvs_tpu_torch.io.pairs import write_pair_file
from mvs_tpu_torch.io.dtu import (DTUEvalDataset, collate_cascade,
                                  collate_mvsnet, collate_point,
                                  collate_pyramid)
from mvs_tpu_torch.models import mvsnet as mvsnet_module
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.models.mvsnet import MVSNet
from mvs_tpu_torch.models import point_mvsnet as point_module
from mvs_tpu_torch.models.point_mvsnet import PointMVSNet
from mvs_tpu_torch.models.registry import build_model
from mvs_tpu_torch.ops import _build
from mvs_tpu_torch.ops.conv3d import conv3d_affine, conv3d_affine_plain
from mvs_tpu_torch.ops.group_correlation import (
    group_correlation_volume, group_correlation_volume_grad,
    group_correlation_volume_grad_plain, group_correlation_volume_plain)
from mvs_tpu_torch.ops.warp_variance import (
    fused_variance_partials, fused_variance_partials_grad,
    fused_variance_partials_grad_plain, fused_variance_partials_plain,
    fused_variance_volume, fused_variance_volume_grad,
    fused_variance_volume_grad_plain, fused_variance_volume_plain)
from mvs_tpu_torch.parallel import (launch_local, make_mesh,
                                    make_view_variance,
                                    maybe_initialize_distributed, shard_batch,
                                    shutdown, volume_sharded_plan)
from mvs_tpu_torch.parallel.sharding import slab_bounds
from mvs_tpu_torch.train.optim import OptaxChain
from mvs_tpu_torch.train.state import make_train_step
from mvs_tpu_torch.ops.point_ops import lattice_knn, point_sweep_projections
from mvs_tpu_torch.train.tasks import (CascadeTask, MVSNetTask, PointTask,
                                      PyramidTask, batch_to_device)
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.make_synthetic_dtu import generate, write_eval_scan
from mvs_tpu_torch.utils.platform import full_f32, resolve_device
from mvs_tpu_torch.utils.synthetic import (make_objects_scene,
                                           make_plane_scene, make_step_scene)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores, TF32 tensor-core
# FLOP/s (the f32 conv's 3xTF32 kernel does three TF32 products per f32 one).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12

HEIGHT, WIDTH, VIEWS = 864, 1152, 5
NDEPTHS = (48, 32, 8)
BASE = 8
LADDER = 192  # global hypothesis ladder of the DTU eval config
# (stage, scale, channels of the stage's features)
STAGES = ((1, 4, 4 * BASE), (2, 2, 2 * BASE), (3, 1, BASE))

# Tolerances, as a fraction of the plain output's largest magnitude.
# f32 warp: kernel and plain compute the projected coordinates with the same
# roundings in the same order, so they sample the same corners with the same
# weights; only the order of the blend and of the sums over 5 views differs,
# a few f32 ulps.
# f32 conv: 27*Cin products summed in another order; on the 3xTF32 kernel
# each product is three TF32 products (within 2^-21 of it) summed by the
# tensor cores in f32, 1e-6 to 6e-6 of the largest output on an H100.
# bf16: both sum in f32 and round once to bf16; one rounding step near the
# maximum is up to 2^-7 of it, allow two.
# Warp backward (7a), f32: the recomputed samples and means round as the
# forward's; dref sums D terms in another order and dsrc sums its scattered
# contributions in the kernel's shared-memory window, then in the f32
# buffer (the TMA's reductions and the spill branch's atomics, in no fixed
# order), a few f32 ulps of the largest partial sums. bf16: both sum in
# f32 and round once.
# Group correlation (8a), f32: the same corners and weights as the plain
# version; the kernel sums each channel over the views before the product
# with ref (and, where a group spans 16-byte chunks, adds the chunks' parts
# in a tree across lanes), the plain version each view's group mean, a few
# f32 ulps of the largest partial sums. bf16: both sum in f32 and round
# once.
TOL = {("warp", torch.float32): 1e-4, ("conv", torch.float32): 1e-4,
       ("warp_grad", torch.float32): 1e-4, ("group", torch.float32): 1e-4,
       ("warp", torch.bfloat16): 2.0 ** -6,
       ("conv", torch.bfloat16): 2.0 ** -6,
       ("warp_grad", torch.bfloat16): 2.0 ** -6,
       ("group", torch.bfloat16): 2.0 ** -6}
# Whole model, card against CPU: each stage's pre-softmax score volume may
# differ by this fraction of its spread (max - min on the CPU). Images
# perturbed by 1e-7 of their size, about one f32 rounding, move the scores of
# the phase-3 model by 2e-7 to 6e-7 of their spread, while a warp that samples
# one source pixel off moves them by 2e-3 (stage 1) to 4e-2 (stage 3) of it.
# bf16: card and CPU both round every layer's output to bf16, but after sums
# taken in another order, so a value near a rounding boundary can land one
# bf16 step apart, and the step propagates. Phase 3 logs what images
# perturbed by one bf16 rounding (x * (1 +- 2^-8), random signs) do to the
# CPU model's bf16 outputs: at most 5.3e-3 to 8.8e-3 of the scores' spread
# (one bf16 step of the largest scores) and 2.1e-4 to 3.3e-4 of it on
# average, depth at most 7.0e-3 stage-3 intervals. Allow about 4x the
# largest and 6x the mean score change, and 14x the depth change; a conv with
# one tap or channel out of place moves the mean by orders of magnitude more.
SCORE_TOL = {torch.float32: (1e-4, None), torch.bfloat16: (3e-2, 2e-3)}
DEPTH_TOL = {torch.float32: (0.05, 5e-3), torch.bfloat16: (0.1, 1e-2)}


def reset_counts() -> None:
    fused_variance_volume.launches = 0
    fused_variance_volume.vector_launches = 0
    fused_variance_volume_grad.launches = 0
    fused_variance_volume_grad.depth_launches = 0
    conv3d_affine.launches = 0
    conv3d_affine.mma_launches = 0
    conv3d_affine.tf32x3_launches = 0
    conv3d_affine.tf32x3_cin64_launches = 0
    group_correlation_volume.launches = 0
    group_correlation_volume.vector_launches = 0
    group_correlation_volume_grad.launches = 0
    group_correlation_volume_grad.depth_launches = 0
    fused_variance_partials.launches = 0
    fused_variance_partials.vector_launches = 0
    fused_variance_partials_grad.launches = 0
    fused_variance_partials_grad.depth_launches = 0


def read_counts() -> dict:
    return {"warp_variance": fused_variance_volume.launches,
            "warp_variance.vector": fused_variance_volume.vector_launches,
            "warp_variance_grad": fused_variance_volume_grad.launches,
            "warp_variance_grad.depth":
                fused_variance_volume_grad.depth_launches,
            "conv3d_affine": conv3d_affine.launches,
            "conv3d_affine.mma": conv3d_affine.mma_launches,
            "conv3d_affine.tf32x3": conv3d_affine.tf32x3_launches,
            "conv3d_affine.tf32x3_cin64":
                conv3d_affine.tf32x3_cin64_launches,
            "group_correlation": group_correlation_volume.launches,
            "group_correlation.vector":
                group_correlation_volume.vector_launches,
            "group_correlation_grad": group_correlation_volume_grad.launches,
            "group_correlation_grad.depth":
                group_correlation_volume_grad.depth_launches}


NO_GROUP = {"group_correlation": 0, "group_correlation.vector": 0,
            "group_correlation_grad": 0, "group_correlation_grad.depth": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` launches, after warm-up."""
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


def map_ms(apply_fn, args, iters: int = 3) -> float:
    """Host ms per call of a model's apply over `iters` synchronised calls
    (after the caller's warm-up)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        apply_fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def compare(kind: str, got: torch.Tensor, want: torch.Tensor, what: str):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: kernel output not finite")
    err = (g - w).abs()
    scale = max(w.abs().max().item(), 1e-6)
    tol = TOL[(kind, got.dtype)] * scale
    max_err = err.max().item()
    log(f"  {what}: max_abs_err {max_err:.3e} mean_abs_err "
        f"{err.mean().item():.3e} (tol {tol:.3e}, scale {scale:.3e})")
    if max_err > tol:
        fail(f"{what}: max_abs_err {max_err} > {tol}")
    return max_err


def stage_geometry(scene, scale: int, device, batch: int = 1):
    """rel projections (B, V-1, 4, 4) of `scene` at 1/scale resolution."""
    k = scene.intrinsics.astype(np.float64).copy()
    k[:, :2] /= scale
    proj = scene.extrinsics.astype(np.float64).copy()
    proj[:, :3, :4] = k @ scene.extrinsics[:, :3, :4]
    rel = proj[1:] @ np.linalg.inv(proj[0])
    return torch.tensor(rel, dtype=torch.float32,
                        device=device)[None].repeat(batch, 1, 1, 1)


def warp_inputs(scene, stage, scale, c, d, dtype, device, batch=1, seed=0,
                height=HEIGHT, width=WIDTH):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h, w = height // scale, width // scale
    feats = torch.randn((batch, len(scene.extrinsics), h, w, c),
                        generator=g).to(device, dtype)
    depth = torch.tensor(scene.depths[0][::scale, ::scale], device=device)
    if stage == 1:
        hyp = torch.linspace(8.0, 12.0, d, device=device)[:, None, None]
        hyp = hyp.expand(d, h, w)
    else:  # a per-pixel window around a noisy depth, as stages 2-3 sweep
        noise = torch.randn((h, w), generator=g).to(device) * 0.05
        steps = torch.arange(d, device=device)[:, None, None] - d / 2
        hyp = depth + noise + steps * (0.0208 * (4 - stage))
    hyp = hyp[None].expand(batch, d, h, w).contiguous()
    rel = stage_geometry(scene, scale, device, batch)
    return (feats[:, 0].contiguous(), feats[:, 1:].contiguous(), rel, hyp)


def warp_bound(b, v, d, h, w, c, itemsize):
    """Least time: each input read once, the volume written once; the least
    f32 work at the f32 peak. Per (pixel, view) the rotation (3 rows of two
    multiply-adds, 12 flops); per (depth, pixel, view) the depth
    multiply-adds (6), a reciprocal and two products (3), the fractions and
    four corner weights (7); per (channel, view) the blend from the four
    weights (7) and the two sums (3); per channel the variance (4)."""
    nbytes = (b * (1 + v) * h * w * c * itemsize + b * d * h * w * 4
              + b * v * 12 * 4 + b * d * h * w * c * itemsize)
    ops = b * h * w * v * 12 + b * d * h * w * (v * (16 + 10 * c) + 4 * c)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            ops / PEAK_FLOPS[torch.float32] * 1e3)


def conv_bound(b, d, h, w, cin, cout, dtype):
    """(bytes, operations) least times of a conv: x read and y written once
    in `dtype`, the f32 weights and affine read once; 2 * 27 * Cin * Cout
    operations a voxel at `dtype`'s peak (f32: the CUDA cores')."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    vox = b * d * h * w
    nbytes = vox * (cin + cout) * itemsize + 27 * cin * cout * 4 + 8 * cout
    ops = 2 * 27 * cin * cout * vox
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3


def tf32x3_bound(b, d, h, w, cin, cout):
    """Least time of an f32 conv's three TF32 products at the TF32
    tensor-core rate: an f32 kernel on the tensor cores may run below the
    f32 operation bound of conv_bound, not below this."""
    return 3 * 2 * 27 * cin * cout * b * d * h * w / TF32_FLOPS * 1e3


def ragged_volume_inputs(dtype, device, c=12):
    """Cost-volume inputs with off-image and behind-camera samples (large
    translations, depths from -3 to 12), C = 12 (not a multiple of the
    kernels' 8-channel chunk) unless given, ragged sizes, batch 2, 3
    sources, D = 7."""
    g = torch.Generator(device="cpu").manual_seed(2)
    b, v, d, h, w = 2, 3, 7, 37, 53
    feats = torch.randn((b, v + 1, h, w, c), generator=g).to(device, dtype)
    rel = torch.eye(4).repeat(b, v, 1, 1)
    rel[:, :, :3, :3] += torch.randn((b, v, 3, 3), generator=g) * 0.05
    rel[:, :, :3, 3] = torch.randn((b, v, 3), generator=g) * torch.tensor(
        [200.0, 200.0, 2.0])
    hyp = torch.linspace(-3.0, 12.0, d)[None, :, None, None].expand(
        b, d, h, w) + torch.rand((b, d, h, w), generator=g)
    return (feats[:, 0].contiguous(), feats[:, 1:].contiguous(),
            rel.to(device), hyp.contiguous().to(device))


def phase_warp(scene, device):
    log("phase 2a: warp_variance kernel vs plain")
    rows = []
    for stage, scale, c in STAGES:
        d = NDEPTHS[stage - 1]
        for dtype in (torch.bfloat16, torch.float32):
            args = warp_inputs(scene, stage, scale, c, d, dtype, device)
            what = (f"stage{stage} B=1 D={d} {HEIGHT // scale}x"
                    f"{WIDTH // scale} C={c} {str(dtype)[6:]}")
            vec = fused_variance_volume.vector_launches
            err = compare("warp", fused_variance_volume(*args),
                          fused_variance_volume_plain(*args), what)
            if fused_variance_volume.vector_launches != vec + 1:
                fail(f"{what}: not on the 16-byte vector variant")
            if dtype is torch.bfloat16:  # the main path's type: time it
                ms = cuda_ms(lambda: fused_variance_volume(*args))
                plain_ms = cuda_ms(lambda: fused_variance_volume_plain(*args),
                                   iters=3, warmup=1)
                by, ops = warp_bound(1, VIEWS - 1, d, HEIGHT // scale,
                                     WIDTH // scale, c, 2)
                log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {max(by, ops):.4f} ms (bytes {by:.4f}, "
                    f"ops {ops:.4f})")
                rows.append(dict(err=err, ms=ms, plain_ms=plain_ms,
                                 bytes_ms=by, ops_ms=ops))
    args = warp_inputs(scene, 1, 4, 32, 48, torch.float32, device, batch=2,
                       seed=1)
    compare("warp", fused_variance_volume(*args),
            fused_variance_volume_plain(*args), "stage1 shape B=2 f32")
    for dtype in (torch.float32, torch.bfloat16):
        args = ragged_volume_inputs(dtype, device)
        vec = fused_variance_volume.vector_launches
        compare("warp", fused_variance_volume(*args),
                fused_variance_volume_plain(*args),
                f"off-image/behind-camera C=12 {str(dtype)[6:]} (scalar)")
        if fused_variance_volume.vector_launches != vec:
            fail("C=12 must take the scalar variant")
    for dtype in (torch.float32, torch.bfloat16):
        args = step_inputs(dtype, device)
        compare("warp", fused_variance_volume(*args),
                fused_variance_volume_plain(*args),
                f"depth step 128x96 C=8 D=3 {str(dtype)[6:]}")
    return rows


def step_inputs(dtype, device):
    """The depth discontinuity of tests/test_torch_warp_variance.py: two
    planes with a step at x = 0 seen from a source 1.2 units off (occlusion
    and an abrupt disparity jump across the edge), per-pixel hypotheses
    around the ref's true depth, the images and a seeded mix of them as 8
    channels (the vector variant)."""
    scene = make_step_scene(num_views=2, height=96, width=128, baseline=1.2)
    mix = np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32)
    feats = torch.from_numpy(np.concatenate(
        [scene.images, scene.images @ mix], axis=-1))[None].to(device, dtype)
    hyp = torch.from_numpy(np.stack([scene.depths[0] + o
                                     for o in (-0.2, 0.0, 0.2)]))
    return (feats[:, 0].contiguous(), feats[:, 1:].contiguous(),
            stage_geometry(scene, 1, device), hyp[None].to(device))


def conv_shapes():
    """(Cin, Cout, D, H, W, relu) of every stride-1 3x3x3 conv of one
    depth map at full width, in launch order."""
    shapes = []
    for stage, scale, c in STAGES:
        d, h, w = NDEPTHS[stage - 1], HEIGHT // scale, WIDTH // scale
        for level, (cin, cout) in enumerate(
                ((c, BASE), (2 * BASE, 2 * BASE), (4 * BASE, 4 * BASE),
                 (8 * BASE, 8 * BASE))):
            f = 2 ** level
            shapes.append((cin, cout, d // f, h // f, w // f, True))
        shapes.append((BASE, 1, d, h, w, False))  # the biased score conv
    return shapes


# The counts of conv3d_affine's variants, by conv_variant's names ("direct"
# is what the others leave of conv3d_affine.launches).
CONV_COUNTS = ("mma_launches", "tf32x3_launches", "tf32x3_cin64_launches")


def conv_variant(dtype, cin, cout):
    """The kernel a conv should take: bf16 with Cin a multiple of 8 the
    bf16 tensor-core kernel ("mma"), f32 with Cin in {4, 8, 16, 32} and
    Cout a multiple of 8 or 1 the 3xTF32 one ("tf32x3"), f32 with Cin = 64
    and Cout a multiple of 8 its Cin = 64 kernel ("tf32x3_cin64"), the rest
    (Cin = 12; bf16 at Cin = 4) the direct one."""
    if dtype is torch.bfloat16 and cin % 8 == 0:
        return "mma"
    if dtype is torch.float32 and cin in (4, 8, 16, 32) and (
            cout % 8 == 0 or cout == 1):
        return "tf32x3"
    if dtype is torch.float32 and cin == 64 and cout % 8 == 0:
        return "tf32x3_cin64"
    return "direct"


def conv_inputs(g, device, b, d, h, w, cin, cout, dtype):
    """Seeded x, weight, scale and shift of a conv."""
    x = torch.randn((b, d, h, w, cin), generator=g).to(device, dtype)
    wt = (torch.randn((cout, cin, 3, 3, 3), generator=g)
          / (27 * cin) ** 0.5).to(device)
    sc = (torch.rand(cout, generator=g) + 0.5).to(device)
    sh = (torch.randn(cout, generator=g) * 0.1).to(device)
    return x, wt, sc, sh


def check_conv(g, device, b, d, h, w, cin, cout, relu, dtype, what=""):
    """conv3d_affine against its plain version on seeded inputs, on the
    variant conv_variant names. Returns (error, inputs)."""
    x, wt, sc, sh = conv_inputs(g, device, b, d, h, w, cin, cout, dtype)
    before = [conv3d_affine.launches] + [getattr(conv3d_affine, c)
                                         for c in CONV_COUNTS]
    err = compare("conv", conv3d_affine(x, wt, sc, sh, relu),
                  conv3d_affine_plain(x, wt, sc, sh, relu),
                  f"{what}({cin},{cout}) B={b} {d}x{h}x{w} relu={relu} "
                  f"{str(dtype)[6:]}")
    variant = conv_variant(dtype, cin, cout)
    after = [conv3d_affine.launches] + [getattr(conv3d_affine, c)
                                        for c in CONV_COUNTS]
    if [n1 - n0 for n0, n1 in zip(before, after)] != [1] + [
            int(c == f"{variant}_launches") for c in CONV_COUNTS]:
        fail(f"({cin},{cout}) {str(dtype)[6:]}: not on the {variant} "
             f"kernel")
    return err, (x, wt, sc, sh)


def cudnn_conv(x, wt, sc, sh, relu):
    """The library yardstick of conv3d_affine: cuDNN's conv over the same
    channels-last view, the affine folded into its weight and bias, in x's
    dtype (f32: TF32 off, as the plain version). Returns the call."""
    wf = (wt * sc[:, None, None, None, None]).to(x.dtype)
    bias = sh.to(x.dtype)
    xv = x.permute(0, 4, 1, 2, 3)

    def library():
        with full_f32():
            y = F.conv3d(xv, wf, bias, padding=1)
        return torch.relu_(y) if relu else y
    return library


def time_conv(err, x, wt, sc, sh, relu) -> dict:
    """A conv's kernel, plain and library (cudnn_conv) ms and its bounds.
    A conv on a 3xTF32 kernel does its operations on the TF32 tensor
    cores: its ops_ms is tf32x3_bound, and f32_ops_ms keeps the f32
    CUDA-core figure of conv_bound."""
    dtype = x.dtype
    ms = cuda_ms(lambda: conv3d_affine(x, wt, sc, sh, relu))
    plain_ms = cuda_ms(lambda: conv3d_affine_plain(x, wt, sc, sh, relu),
                       iters=3, warmup=1)
    lib_ms = cuda_ms(cudnn_conv(x, wt, sc, sh, relu))
    _, d, h, w, cin = x.shape
    by, ops = conv_bound(1, d, h, w, cin, wt.shape[0], dtype)
    extra = ""
    if conv_variant(dtype, cin, wt.shape[0]).startswith("tf32x3"):
        f32_ops, ops = ops, tf32x3_bound(1, d, h, w, cin, wt.shape[0])
        extra = f" at the TF32 rate; f32 CUDA-core ops {f32_ops:.4f}"
    row = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bytes_ms=by, ops_ms=ops)
    if extra:
        row["f32_ops_ms"] = f32_ops
    log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms, bound {max(by, ops):.4f} ms (bytes {by:.4f}, "
        f"ops {ops:.4f}{extra})")
    return row


def phase_conv(device):
    """2b: every conv variant against the plain version at awkward shapes
    and at the main path's; bf16 timed (the CasMVSNet map's 15 convs), and
    the f32 convs at Cin = 64 (its three (64, 64)). Returns (bf16 rows,
    f32 Cin = 64 rows)."""
    log("phase 2b: conv3d_affine kernel vs plain")
    g = torch.Generator(device="cpu").manual_seed(3)
    # Every (Cin, Cout) pair of the main path, (12, 8) for the direct
    # kernel, AACVP's (4, 16) (f32: the 3xTF32 kernel, a k step across two
    # taps; bf16: the direct kernel) and the other Couts of the f32 Cin =
    # 64 kernel's main paths (Point-MVSNet's 64->8, CVP's transposed
    # 64->32), at sizes that are not multiples of the 8x16 (H x W) tile:
    # batch 2, D = 1 and D = 2, and D = 11 over enough tiles that the z
    # runs stay 8 planes long (8 + 3).
    pairs = sorted({(ci, co) for ci, co, *_ in conv_shapes()}
                   | {(12, 8), (4, 16), (64, 8), (64, 32)})
    for i, (cin, cout) in enumerate(pairs):
        for dtype in (torch.float32, torch.bfloat16):
            for b, d, h, w in ((2, 5, 13, 37), (2, 1, 9, 17), (1, 2, 17, 33),
                               (1, 11, 90, 190)):
                check_conv(g, device, b, d, h, w, cin, cout, bool(i % 2),
                           dtype)
    # A tensor-core variant raises on an x it cannot take (not 16-byte
    # aligned) and launches nothing: no fallback to the direct kernel.
    for cin, dtype in ((64, torch.float32), (32, torch.float32),
                       (64, torch.bfloat16)):
        x, wt, sc, sh = conv_inputs(g, device, 1, 2, 8, 16, cin, 8, dtype)
        x = torch.empty(x.numel() + 1, dtype=dtype,
                        device=device)[1:].view(x.shape)
        n = conv3d_affine.launches
        try:
            conv3d_affine(x, wt, sc, sh, True)
            fail(f"{conv_variant(dtype, cin, 8)}: unaligned x did not raise")
        except ValueError as e:
            log(f"  {conv_variant(dtype, cin, 8)}: unaligned x raised "
                f"ValueError ({e}), launches {conv3d_affine.launches - n}")
        if conv3d_affine.launches != n:
            fail("an unaligned x launched a kernel")
    rows, cin64 = [], []
    for cin, cout, d, h, w, relu in conv_shapes():
        # f32 at the main path's sizes too; the Cin = 64 ones timed.
        err, args = check_conv(g, device, 1, d, h, w, cin, cout, relu,
                               torch.float32)
        if cin == 64:
            cin64.append(time_conv(err, *args, relu))
        err, args = check_conv(g, device, 1, d, h, w, cin, cout, relu,
                               torch.bfloat16)
        rows.append(time_conv(err, *args, relu))
    log_sum(f"CasMVSNet's {len(cin64)} f32 convs at Cin = 64", cin64)
    return rows, cin64


def log_sum(what, rows) -> None:
    """One line: the rows' kernel, plain and cuDNN ms and bounds, summed
    (f32 rows of a 3xTF32 kernel: with the f32 CUDA-core bound)."""
    f32 = ("; f32 CUDA-core ops "
           f"{sum(r['f32_ops_ms'] for r in rows):.4f} ms"
           if all("f32_ops_ms" in r for r in rows) else "")
    log(f"  {what}: kernel {sum(r['ms'] for r in rows):.4f} ms, plain "
        f"{sum(r['plain_ms'] for r in rows):.4f} ms, cuDNN "
        f"{sum(r['library_ms'] for r in rows):.4f} ms; bound "
        f"{sum(max(r['bytes_ms'], r['ops_ms']) for r in rows):.4f} ms (ops "
        f"{sum(r['ops_ms'] for r in rows):.4f} ms, bytes "
        f"{sum(r['bytes_ms'] for r in rows):.4f} ms{f32})")


def model_inputs(scene, batch, device, family="cascade"):
    sample = dict(imgs=scene.images, intrinsics=scene.intrinsics,
                  extrinsics=scene.extrinsics,
                  depth_values=np.linspace(8.0, 12.0, LADDER,
                                           dtype=np.float32))
    return stack_model_inputs([sample] * batch, device, family)


def phase_model_vs_cpu(device):
    scene = make_plane_scene(num_views=VIEWS, height=128, width=160,
                             z0=10.0, tilt=(0.05, 0.02))
    for dtype in (torch.float32, torch.bfloat16):
        model_vs_cpu(scene, dtype, device)


def model_vs_cpu(scene, dtype, device):
    log(f"phase 3: CasMVSNet 128x160 {str(dtype)[6:]}, card (kernels) vs CPU "
        f"(plain)")
    model = CasMVSNet(BASE, NDEPTHS, compute_dtype=dtype,
                      generator=torch.Generator().manual_seed(7))
    # Random weights regress a near-constant depth, so depth alone hardly
    # sees the volumes; the pre-softmax scores, which both kernels drive,
    # are compared too.
    scores = []
    hooks = [getattr(model, f"cost_reg_stage{i + 1}").register_forward_hook(
        lambda m, a, out: scores.append(out.float().cpu()))
        for i in range(len(NDEPTHS))]
    inputs = model_inputs(scene, 1, "cpu")
    cpu = make_apply_fn(model, "cpu")(*inputs)
    if dtype is torch.bfloat16:  # the yardstick of the bf16 limits
        sign = torch.from_numpy(np.random.default_rng(0).choice(
            [-1.0, 1.0], size=tuple(inputs[0].shape)).astype(np.float32))
        nudged = make_apply_fn(model, "cpu")(
            inputs[0] * (1 + sign * 2.0 ** -8), *inputs[1:])
        moved = [(b - a).abs() / (a.max() - a.min())
                 for a, b in zip(scores[:3], scores[3:])]
        log("  CPU, images moved by one bf16 rounding: scores move by max "
            + " / ".join(f"{m.max().item():.3e}" for m in moved) + ", mean "
            + " / ".join(f"{m.mean().item():.3e}" for m in moved)
            + " of their spread; depth by max "
            f"{((nudged[0] - cpu[0]).abs().max() * LADDER / 4.0).item():.3e}"
            " stage-3 intervals")
        del scores[3:]
    mma = conv3d_affine.mma_launches
    card = make_apply_fn(model, device)(*model_inputs(scene, 1, device))
    for h in hooks:
        h.remove()
    if dtype is torch.bfloat16 and conv3d_affine.mma_launches - mma != 15:
        fail("bf16 model did not run its 15 convs on the tensor-core kernel")
    max_tol, mean_tol = SCORE_TOL[dtype]
    n = len(NDEPTHS)
    for stage, (s_cpu, s_card) in enumerate(zip(scores[:n], scores[n:]), 1):
        spread = (s_cpu.max() - s_cpu.min()).item()
        diff = (s_card - s_cpu).abs()
        err, mean = diff.max().item(), diff.mean().item()
        log(f"  stage{stage} score {tuple(s_cpu.shape)}: |card-cpu| max "
            f"{err:.3e} = {err / spread:.3e}, mean {mean / spread:.3e} of its "
            f"spread {spread:.4f} (tol {max_tol:.0e}, {mean_tol})")
        if not err <= max_tol * spread:
            fail(f"stage{stage} card scores differ from CPU scores")
        if mean_tol is not None and not mean <= mean_tol * spread:
            fail(f"stage{stage} card scores differ from CPU scores on average")
    depth_cpu, conf_cpu = (t.float() for t in cpu)
    depth_card, conf_card = (t.float().cpu() for t in card)
    interval3 = (12.0 - 8.0) / LADDER  # stage-3 ratio 1
    d_err = (depth_card - depth_cpu).abs() / interval3
    c_err = (conf_card - conf_cpu).abs()
    log(f"  depth |card-cpu| in stage-3 intervals: max "
        f"{d_err.max().item():.3e} mean {d_err.mean().item():.3e}; "
        f"confidence max {c_err.max().item():.3e} mean "
        f"{c_err.mean().item():.3e}; depth range "
        f"[{depth_cpu.min().item():.4f}, {depth_cpu.max().item():.4f}]")
    # Depth is continuous in the volumes: rounding differences stay far
    # below one hypothesis interval. Confidence is not: it sums 4 taps around
    # the truncated regressed index, which can step at pixels whose index sits
    # on an integer; allow such steps on 0.1% of pixels.
    max_tol, mean_tol = DEPTH_TOL[dtype]
    if not (d_err.max() < max_tol and d_err.mean() < mean_tol):
        fail("card depth differs from CPU depth")
    if (c_err > 1e-3).float().mean() > 1e-3 or c_err.mean() > 1e-3:
        fail("card confidence differs from CPU confidence")


def phase_full_width(scene, device):
    log(f"phase 4: full width {WIDTH}x{HEIGHT}, {VIEWS} views, "
        f"{'/'.join(map(str, NDEPTHS))} hypotheses, batch 1")
    launches = {}
    bf16_ms = None
    for dtype in (torch.bfloat16, torch.float32):
        model = CasMVSNet(BASE, NDEPTHS, compute_dtype=dtype,
                          generator=torch.Generator().manual_seed(0))
        apply_fn = make_apply_fn(model, device)
        args = model_inputs(scene, 1, device)
        apply_fn(*args)  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        depth, conf = apply_fn(*args)
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = map_ms(apply_fn, args)
        log(f"  {str(dtype)[6:]}: {ms:.2f} ms per depth map, peak "
            f"{peak:.3f} GiB allocated, launches {json.dumps(counts)}")
        want = {"warp_variance": 3, "warp_variance.vector": 3,
                "warp_variance_grad": 0, "warp_variance_grad.depth": 0,
                "conv3d_affine": 15,
                "conv3d_affine.mma": 15 if dtype is torch.bfloat16 else 0,
                # f32: all on the tensor cores, the three at Cin = 64 on
                # their own kernel
                "conv3d_affine.tf32x3": 0 if dtype is torch.bfloat16 else 12,
                "conv3d_affine.tf32x3_cin64":
                    0 if dtype is torch.bfloat16 else 3,
                **NO_GROUP}
        if counts != want:
            fail(f"main path launches {counts}, want {want}")
        if depth.shape != (1, HEIGHT, WIDTH) or conf.shape != depth.shape:
            fail(f"output shapes {tuple(depth.shape)} {tuple(conf.shape)}")
        depth = depth.float()
        # The final hypotheses stay within the global ladder widened by the
        # refine stages' half-windows.
        iv = (12.0 - 8.0) / LADDER
        margin = sum(n / 2 * r * iv for n, r in zip(NDEPTHS[1:], (2.0, 1.0)))
        if not torch.isfinite(depth).all() or not torch.isfinite(conf).all():
            fail("full-width outputs not finite")
        if depth.min() < 8.0 - margin or depth.max() > 12.0 + margin:
            fail(f"depth outside [{8.0 - margin}, {12.0 + margin}]")
        launches[dtype] = counts
        if dtype is torch.bfloat16:
            bf16_ms = ms
            log("  bf16 device ms by layer, one run: "
                + json.dumps(layer_breakdown(model, apply_fn, args)))
            profile_run(apply_fn, args)
    return launches, bf16_ms


def device_spans(fn) -> list:
    """(start, end, name) of every device op of one call of fn, from
    torch.profiler, in start order (microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def log_spans(spans, top: int = 12) -> dict:
    """Log the device's busy time and idle share, 1 - (union of device
    activity) / (first device start to last device end), and the `top`
    kernels by device ms; return device ms by name."""
    if not spans:
        log("  profiler: no device time recorded")
        return {}
    by_name, busy, end = {}, 0.0, spans[0][0]
    for t0, t1, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    window = end - spans[0][0]
    log(f"  profiler: {len(spans)} device ops over {window / 1e3:.4f} ms, "
        f"busy {busy / 1e3:.4f} ms, idle share {1 - busy / window:.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"    {ms:9.4f} ms  {name[:110]}")
    return by_name


def profile_run(apply_fn, args, top: int = 12) -> None:
    """One bf16 map under torch.profiler: device ms by kernel (top `top`),
    and the device's idle share."""
    log_spans(device_spans(lambda: apply_fn(*args)), top)


def layer_breakdown(model, apply_fn, args) -> dict:
    """Device ms of the feature net and of each kind of cost-regularization
    block (summed over stages), from CUDA events recorded around their
    forward calls in one run; 'rest' is the remainder of the run: the warp,
    hypotheses, regression and upsampling."""
    spans, hooks = [], []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    for name, module in model.named_modules():
        parts = name.split(".")
        if name == "CascadeFeatureNet_0" or (
                len(parts) == 2 and parts[0].startswith("cost_reg")):
            kind = parts[-1].rsplit("_", 1)[0]
            hooks.append(module.register_forward_pre_hook(
                lambda m, a, kind=kind: spans.append([kind, event(), None])))
            hooks.append(module.register_forward_hook(
                lambda m, a, out: spans[-1].__setitem__(2, event())))
    start = event()
    apply_fn(*args)
    end = event()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    ms = {}
    for kind, a, b in spans:
        ms[kind] = ms.get(kind, 0.0) + a.elapsed_time(b)
    ms["rest"] = start.elapsed_time(end) - sum(ms.values())
    ms["total"] = start.elapsed_time(end)
    return {k: round(v, 4) for k, v in ms.items()}


def phase_batched(scene, device):
    log("phase 5: run_batched_inference, batch 2 over 3 samples, bf16")
    model = CasMVSNet(BASE, NDEPTHS, compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    samples = []
    for i in range(3):
        if i:
            scene = make_plane_scene(num_views=VIEWS, height=HEIGHT,
                                     width=WIDTH, z0=10.0, seed=i)
        samples.append(dict(
            imgs=scene.images, intrinsics=scene.intrinsics,
            extrinsics=scene.extrinsics, scan="scan1", ref_view=i,
            depth_values=np.linspace(8.0, 12.0, LADDER, dtype=np.float32),
            depth_min=8.0, depth_interval=4.0 / LADDER, depth_max=12.0))
    with tempfile.TemporaryDirectory() as out:
        results = list(run_batched_inference(model, samples, batch_size=2,
                                             device=device))
        if [r[0]["ref_view"] for r in results] != [0, 1, 2]:
            fail("batched inference lost or reordered samples")
        for sample, depth, conf in results:
            if depth.shape != (HEIGHT, WIDTH) or not np.isfinite(depth).all():
                fail(f"batched depth {depth.shape} not finite")
            write_depth_outputs(out, sample, depth, conf, num_depth=LADDER)
        back, _ = read_pfm(f"{out}/scan1/depth_est/00000002.pfm")
        if not np.array_equal(back, results[2][1].astype(np.float32)):
            fail("PFM read back differs from the in-memory depth map")
        log(f"  3 depth maps written and read back from {len(results)} "
            f"outputs; tail map depth mean {results[2][1].mean():.4f}")


# Phase 6. The scan: 11 views at full width, a plane tilted so that its
# depth (8.6 to 11.9 at focal 100) stays inside the 7.2-12.8 ladder.
SCAN_VIEWS, SCAN_TILT = 11, (0.02, 0.01)
# configs/cas_eval_dtu.yaml's fusion thresholds.
EVAL_FUSION = ["fusion.conf_thresh=0.9", "fusion.num_consistent=5",
               "fusion.pixel_thresh=1.0", "fusion.depth_thresh=0.01"]
# Card against CPU fusion (6c): both run the same f32 arithmetic in another
# order (matrix products, inverses), so a mask flips only where a tested
# quantity (reprojection distance, relative depth error, consistent-source
# count) lies within ~1e-6 of its threshold; with 0.4% depth noise far
# fewer than 1e-3 of the pixels do. World points agree to ~1e-6 of their
# coordinates (< 15 units) except where one source's test flips without
# flipping the pixel's mask, which moves the averaged depth by up to the
# noise: allow 1e-4 units, and points beyond it on 1e-3 of the common mask.
FUSE_MASK_SHARE, FUSE_POINT_TOL, FUSE_POINT_SHARE = 1e-3, 1e-4, 1e-3
# GT window of utils.make_synthetic_dtu (its grid on the plane): the oracle
# cloud is evaluated inside it. Oracle points lie on the plane, so acc is the
# in-plane distance to the 0.05-unit GT grid (0.019 on average for points
# spread uniformly, 0.035 at most) and comp the distance from a GT point to
# the cloud decimated at 0.2 units (0.07-0.1 on average). A CPU rehearsal of
# this phase at 288x216 (the same point density inside the window) gave acc
# 0.0208 and comp 0.0955; the limits are twice those. Off the plane, 99% of
# the oracle points sat within 2.9e-6 (f32 rounding of coordinates ~10):
# allow 1e-4.
GT_HALF = (5.0, 4.0)
ACC_LIMIT, COMP_LIMIT, OFF_PLANE_P99 = 0.042, 0.19, 1e-4


def check_files(scan_dir: Path, views: int, height: int, width: int):
    for v in range(views):
        for rel in (f"depth_est/{v:08d}.pfm", f"confidence/{v:08d}.pfm",
                    f"cams/{v:08d}_cam.txt", f"images/{v:08d}.png"):
            if not (scan_dir / rel).is_file():
                fail(f"{scan_dir / rel} not written")
        depth, _ = read_pfm(scan_dir / "depth_est" / f"{v:08d}.pfm")
        if depth.shape != (height, width) or not np.isfinite(depth).all():
            fail(f"depth map {v}: {depth.shape}, finite "
                 f"{np.isfinite(depth).all()}")


def phase_scan_from_disk(work: Path, device, apply_ms: float,
                         height=HEIGHT, width=WIDTH):
    log(f"phase 6a: synthetic DTU eval scan, {SCAN_VIEWS} views at "
        f"{width}x{height}, {LADDER}-hypothesis ladder, 10 sources per ref")
    t0 = time.perf_counter()
    root = generate(work / "dtu", num_scans=1, num_views=SCAN_VIEWS,
                    height=height, width=width, num_depth=LADDER,
                    tilt=SCAN_TILT, train_layout=False)
    log(f"  written in {time.perf_counter() - t0:.2f} s")
    log("phase 6b: cli infer from disk, bf16, batch 2")
    ckpt = work / "cas_bf16.pt"
    torch.save(CasMVSNet(BASE, NDEPTHS, compute_dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0)
                         ).state_dict(), ckpt)
    out = work / "out"
    reset_counts()
    result = cli_infer.main([
        "--ckpt", str(ckpt), "--out", str(out), "--device", str(device),
        "model.compute_dtype=bfloat16", f"data.eval_root={root}",
        f"data.eval_list={root / 'lists' / 'test.txt'}",
        f"data.num_views={VIEWS}", f"data.num_depth={LADDER}",
        f"data.max_h={height}", f"data.max_w={width}", "data.batch_size=2"])
    torch.cuda.synchronize()
    counts = read_counts()
    batches = -(-SCAN_VIEWS // 2)
    want = {"warp_variance": 3 * batches,
            "warp_variance.vector": 3 * batches, "warp_variance_grad": 0,
            "warp_variance_grad.depth": 0,
            "conv3d_affine": 15 * batches, "conv3d_affine.mma": 15 * batches,
            "conv3d_affine.tf32x3": 0, "conv3d_affine.tf32x3_cin64": 0,
            **NO_GROUP}
    log(f"  launches {json.dumps(counts)} over {batches} batches")
    if counts != want:
        fail(f"cli infer launches {counts}, want {want}")
    if result["maps"] != SCAN_VIEWS:
        fail(f"cli infer wrote {result['maps']} maps")
    check_files(out / "scan1", SCAN_VIEWS, height, width)
    # Where the CLI's host time goes: one sample's load and one map's writes.
    t0 = time.perf_counter()
    sample = DTUEvalDataset(root, ["scan1"], num_views=VIEWS,
                            num_depth=LADDER, max_h=height, max_w=width)[0]
    load_ms = (time.perf_counter() - t0) * 1e3
    depth, _ = read_pfm(out / "scan1" / "depth_est" / "00000000.pfm")
    t0 = time.perf_counter()
    write_depth_outputs(work / "writes", sample, depth, depth, LADDER)
    pfm_ms = (time.perf_counter() - t0) * 1e3
    log(f"  host, one map: sample load {load_ms:.1f} ms ({VIEWS} PNG "
        f"decodes + resize), 2 PFMs + cam {pfm_ms:.1f} ms, "
        + png_levels(work, sample["imgs"][0]))
    log(f"  {result['maps']} maps in {result['seconds']:.4f} s through the "
        f"CLI (first batch's warm-up, PNG reads, inference, PFM/cam/PNG "
        f"writes): {result['maps'] / result['seconds']:.4f} maps/s; apply "
        f"only (phase 4, batch 1): {apply_ms:.2f} ms per map = "
        f"{1e3 / apply_ms:.2f} maps/s")
    return counts, root, out


def png_levels(work: Path, image) -> str:
    """The reference image's PNG write at io.png's zlib level and at the
    other candidate, host ms and bytes."""
    img8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    chosen, parts = png_codec.ZLIB_LEVEL, []
    try:
        for level in (1, 6):
            png_codec.ZLIB_LEVEL = level
            path = work / "writes" / f"ref_level{level}.png"
            t0 = time.perf_counter()
            png_codec.write_png(path, img8)
            ms = (time.perf_counter() - t0) * 1e3
            parts.append(f"PNG at zlib level {level}"
                         f"{' (io.png)' if level == chosen else ''} "
                         f"{ms:.1f} ms, {path.stat().st_size} bytes")
    finally:
        png_codec.ZLIB_LEVEL = chosen
    return "; ".join(parts)


def scan_pairs(views: int):
    """Every other view as a source, ranked by index distance."""
    return [(r, sorted((v for v in range(views) if v != r),
                       key=lambda v: abs(v - r))) for r in range(views)]


def phase_fusion_card_vs_cpu(device, height=216, width=288):
    log(f"phase 6c: fuse_scene card vs CPU, {width}x{height}, {SCAN_VIEWS} "
        f"views x {SCAN_VIEWS - 1} sources, depth noise 0.4%")
    scene = make_plane_scene(num_views=SCAN_VIEWS, height=height,
                             width=width, z0=10.0, tilt=SCAN_TILT)
    rng = np.random.default_rng(0)
    depths = (scene.depths * (1 + rng.normal(0, 0.004, scene.depths.shape))
              ).astype(np.float32)
    confs = rng.uniform(0, 1, depths.shape).astype(np.float32)
    args = (depths, confs, scene.intrinsics, scene.extrinsics,
            scan_pairs(SCAN_VIEWS),
            FusionConfig(conf_thresh=0.3, num_consistent=3, pixel_thresh=1.0,
                         depth_thresh=0.01))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mask, world = fuse_scene(*args, device=device)
    peak = torch.cuda.max_memory_allocated()
    cpu_mask, cpu_world = fuse_scene(*args, device="cpu")
    stack = (SCAN_VIEWS - 1) * height * width * 4
    log(f"  peak {peak / 2 ** 20:.2f} MiB allocated on the card (one (S, H, "
        f"W) f32 stack: {stack / 2 ** 20:.2f} MiB)")
    if peak < 3 * stack:
        fail("card fusion did not hold its source stacks on the card")
    both = mask & cpu_mask
    diff = np.abs(world[both] - cpu_world[both]).max(axis=-1)
    flips = (mask != cpu_mask).mean()
    far = (diff > FUSE_POINT_TOL).mean()
    log(f"  accepted {mask.mean():.4f} (card) / {cpu_mask.mean():.4f} (CPU) "
        f"of pixels; masks differ on {(mask != cpu_mask).sum()} pixels = "
        f"{flips:.2e} (limit {FUSE_MASK_SHARE}); points on the common mask: "
        f"max |card-cpu| {diff.max():.3e}, beyond {FUSE_POINT_TOL} on "
        f"{far:.2e} (limit {FUSE_POINT_SHARE})")
    if not 0.05 < cpu_mask.mean() < 0.95:
        fail("the thresholds do not bite on the noisy depths")
    if (flips > FUSE_MASK_SHARE or far > FUSE_POINT_SHARE
            or not np.isfinite(world[both]).all()):
        fail("card fusion differs from CPU fusion")


def write_oracle(root: Path, out: Path, height: int, width: int) -> None:
    """The scan's analytic depths in the cli.infer layout, confidence 1,
    with the scan's cams (depth maps at image size) and images."""
    scene = make_plane_scene(num_views=SCAN_VIEWS, height=height,
                             width=width, z0=10.0, seed=0, tilt=SCAN_TILT)
    src, dst = root / "scan1", out / "scan1"
    for v in range(SCAN_VIEWS):
        write_pfm(dst / "depth_est" / f"{v:08d}.pfm", scene.depths[v])
        write_pfm(dst / "confidence" / f"{v:08d}.pfm",
                  np.ones_like(scene.depths[v]))
        for rel in (f"cams/{v:08d}_cam.txt", f"images/{v:08d}.png"):
            (dst / rel).parent.mkdir(parents=True, exist_ok=True)
            (dst / rel).write_bytes((src / rel).read_bytes())


def timed_cli_fuse(args):
    """cli fuse over one scan, with its own fuse_scene call timed by CUDA
    events (upload to readback) and its compaction + PLY write by the host
    clock, through wrappers around the two calls for this run."""
    times, fuse_fn, write_fn = {}, cli_fuse._fuse, cli_fuse.write_scan_cloud

    def fuse(*a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        result = fuse_fn(*a)
        end.record()
        torch.cuda.synchronize()
        times["fuse_ms"] = start.elapsed_time(end)
        return result

    def write(*a):
        t0 = time.perf_counter()
        path = write_fn(*a)
        times["write_ms"] = (time.perf_counter() - t0) * 1e3
        return path

    cli_fuse._fuse, cli_fuse.write_scan_cloud = fuse, write
    try:
        t0 = time.perf_counter()
        plys = cli_fuse.main(args)
        times["cli_s"] = time.perf_counter() - t0
    finally:
        cli_fuse._fuse, cli_fuse.write_scan_cloud = fuse_fn, write_fn
    return plys, times


def phase_oracle(root: Path, work: Path, device, height=HEIGHT,
                 width=WIDTH):
    log(f"phase 6d: oracle maps at {width}x{height} through cli fuse and "
        f"cli evaluate (thresholds of configs/cas_eval_dtu.yaml)")
    out = work / "oracle"
    write_oracle(root, out, height, width)
    plys, times = timed_cli_fuse(["--out", str(out), "--device", str(device),
                                  f"data.eval_root={root}", *EVAL_FUSION])
    ply, pixels = plys[0], SCAN_VIEWS * height * width
    cloud = read_ply(ply)
    xyz = cloud["xyz"]
    plane = 10.0 + SCAN_TILT[0] * xyz[:, 0] + SCAN_TILT[1] * xyz[:, 1]
    off = np.abs(xyz[:, 2] - plane)
    off_p99, off_max = np.quantile(off, [0.99, 1.0]) if len(xyz) else (
        np.inf, np.inf)
    log(f"  cli fuse {times['cli_s']:.3f} s host; in that run, fuse_scene "
        f"{times['fuse_ms']:.4f} ms per scan ({SCAN_VIEWS} refs x "
        f"{SCAN_VIEWS - 1} sources, upload to readback, CUDA events, one "
        f"call) and compaction + PLY write {times['write_ms']:.2f} ms host; "
        f"{len(xyz)} points ({len(xyz) / pixels:.4f} of the pixels), off "
        f"the plane by {off_p99:.3e} (99th percentile) / {off_max:.3e} "
        f"(max)")
    # The fused depth averages round-trip depths, each read bilinearly from
    # a source map (exact where the depth is linear in the pixel, zero-filled
    # past the border) and admitted within depth_thresh (1%) of the ref
    # depth, so a point may sit up to 1% of its depth (< 0.13) off the plane.
    if (len(xyz) < 0.5 * pixels or not off_max < 0.13
            or not off_p99 < OFF_PLANE_P99 or "rgb" not in cloud):
        fail("oracle cloud too small, off the plane or without colour")
    keep = (np.abs(xyz[:, 0]) <= GT_HALF[0]) & (np.abs(xyz[:, 1])
                                                <= GT_HALF[1])
    write_ply(ply.parent / "fused_crop.ply", xyz[keep],
              rgb=cloud["rgb"][keep])
    t0 = time.perf_counter()
    report = cli_evaluate.main(["--out", str(out), "--gt", str(root),
                                "--ply-name", "fused_crop.ply"])
    eval_s = time.perf_counter() - t0
    if report is None:
        fail("cli evaluate scored no scan")
    acc = report["aggregate"]["mean_acc"]
    comp = report["aggregate"]["mean_comp"]
    log(f"  evaluated {int(keep.sum())} points inside the GT window "
        f"|x| <= {GT_HALF[0]}, |y| <= {GT_HALF[1]}: acc {acc:.6f}, comp "
        f"{comp:.6f} (limits {ACC_LIMIT}, {COMP_LIMIT}), cli evaluate "
        f"{eval_s:.3f} s host")
    if not (acc < ACC_LIMIT and comp < COMP_LIMIT):
        fail("oracle acc / comp over their limits")
    stl = read_ply(root / "Points" / "stl" / "stl001_total.ply")["xyz"]
    return xyz, keep, stl


def check_cloud(ply: Path) -> str:
    """Fail unless `ply` is a valid coloured cloud; describe it."""
    cloud = read_ply(ply)
    n = len(cloud["xyz"])
    if (cloud["xyz"].shape != (n, 3) or not np.isfinite(cloud["xyz"]).all()
            or cloud["rgb"].shape != (n, 3)):
        fail(f"{ply}: not a valid coloured cloud")
    return f"{ply.name}, {n} points, finite, coloured"


def phase_model_fusion(root: Path, out: Path, device):
    log("phase 6e: cli fuse over the model's maps of phase 6b "
        "(thresholds of configs/cas_eval_dtu.yaml)")
    ply = cli_fuse.main(["--out", str(out), "--device", str(device),
                         f"data.eval_root={root}", *EVAL_FUSION])[0]
    log(f"  {check_cloud(ply)}")


def phase_user_path(device, apply_ms: float):
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        counts, root, out = phase_scan_from_disk(work, device, apply_ms)
        phase_fusion_card_vs_cpu(device)
        oracle = phase_oracle(root, work, device)
        phase_model_fusion(root, out, device)
    return counts, oracle


# Phase 7. The JAX training envelope (bench.py --train): 640x512, 5 views,
# 48/32/8 hypotheses over the 192-hypothesis ladder, bf16, batch 4, Adam.
TRAIN_H, TRAIN_W, TRAIN_BATCH = 512, 640, 4
TRAIN_STEPS, CURVE_STEPS = 8, 20
TRAIN_LAUNCHES = {"warp_variance": 3, "warp_variance.vector": 3,
                  "warp_variance_grad": 3, "warp_variance_grad.depth": 0,
                  "conv3d_affine": 0, "conv3d_affine.mma": 0,
                  "conv3d_affine.tf32x3": 0, "conv3d_affine.tf32x3_cin64": 0,
                  **NO_GROUP}
# 7b, card against CPU, f32, TF32 off on both. The forward sums in another
# order (cuDNN's convs, the kernels, the reductions of the batch moments):
# loss to 1e-5 relative, the new statistics to 1e-4 of each vector's
# largest magnitude (on an H100 80GB HBM3 one channel's batch mean, near
# 0, differed by 1.1e-3 of its own value). The gradient of a BatchNorm
# network amplifies such differences; a CPU run on images moved by one f32
# rounding (x * (1 +- 2^-24)) measures that amplification for each
# parameter. A gradient passes when it is within 1e-3 of its largest
# magnitude, or within 30x what that one rounding moved it, and points the
# same way (cosine > 0.999; on the H100 a gradient that one rounding moved
# by 0.5% of its largest magnitude had cosine 0.99985). The score convs'
# biases are left out: the softmax over depth is invariant to a constant
# added to every score, so their exact gradient is 0 and both sides hold
# rounding residue.
STEP_LOSS_RTOL, STEP_STATS_RTOL = 1e-5, 1e-4
GRAD_TOL, GRAD_NUDGE_FACTOR, GRAD_COSINE = 1e-3, 30.0, 0.999


# The hypotheses' gradient adds, per (depth, pixel, view), the two
# quotient-rule terms (6 flops), and per (channel, view) the sample's two
# corner differences along x and y (6) and their product with the cotangent
# and the coordinates' derivatives (4); it writes (B, D, H, W) f32.
DEPTH_GRAD_OPS = (6, 10)


def warp_grad_bound(b, v, d, h, w, c, itemsize, depth=False):
    """Least time of the backward: G, ref, src and the hypotheses read once,
    dref and dsrc written once in the features' dtype (and ddepth in f32
    with `depth`); the kernel's f32 buffer for dsrc is its own design, and
    its cost lies in the gap above this bound. The least f32 work: per
    (pixel, view) the rotation (12), per (depth, pixel, view) the
    coordinates and corner weights (16), per (channel, view) the blend (7),
    the mean's sum (1), g (f - m) (2) and four weighted scatter-adds (8),
    per channel the mean, g and the dref term (6); with `depth`,
    DEPTH_GRAD_OPS."""
    per_view, per_channel = (16, 18) if not depth else (
        16 + DEPTH_GRAD_OPS[0], 18 + DEPTH_GRAD_OPS[1])
    nbytes = (b * d * h * w * c * itemsize
              + 2 * b * (1 + v) * h * w * c * itemsize
              + b * d * h * w * 4 * (2 if depth else 1) + b * v * 12 * 4)
    ops = (b * h * w * v * 12
           + b * d * h * w * (v * (per_view + per_channel * c) + 6 * c))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            ops / PEAK_FLOPS[torch.float32] * 1e3)


# The backward kernels are timed on two rigs of make_plane_scene (baseline
# 0.6 at z0 = 10): its default (focal 100 px at 640x512 images, 25 px at
# 1/4 resolution) and a DTU-like one (focal 1446 px at 640x512, 361.5 px at
# 160x128, the focal of DTU's preprocessed training cameras). A stage-1
# sweep over 8..12 moves a sample by under 1.3 px on the first, by 9-18 px
# on the second; the kernels' dsrc window is sized by that sweep.
DTU_FOCAL = 1446.0


def rig_scenes(views, height, width):
    """{rig: scene}: the default rig and the DTU-like rig."""
    return {rig: make_plane_scene(num_views=views, height=height, width=width,
                                  z0=10.0, **kw)
            for rig, kw in (("default", {}), ("dtu", dict(focal=DTU_FOCAL)))}


def sweep_stats(rel, hyp):
    """([per source view: the largest move of a sample across its
    hypotheses, in source pixels, over the hypotheses where it has a corner
    on the image], the number of on-image corners of all samples)."""
    b, d, h, w = hyp.shape
    nv = rel.shape[1]
    xy = plane_sweep_coords(rel, hyp[:, None].expand(b, nv, d, h, w), h, w)
    cell = xy.floor()
    cx, cy = cell[..., 0], cell[..., 1]
    nx = ((cx >= 0) & (cx <= w - 1)).int() + ((cx >= -1) & (cx <= w - 2)).int()
    ny = ((cy >= 0) & (cy <= h - 1)).int() + ((cy >= -1) & (cy <= h - 2)).int()
    corners = int((nx * ny).sum())
    on = ((nx > 0) & (ny > 0))[..., None]
    lo = torch.where(on, xy, float("inf")).amin(2)
    hi = torch.where(on, xy, -float("inf")).amax(2)
    move = torch.where(on.any(2)[..., 0], (hi - lo).norm(dim=-1), 0.0)
    return [move[:, v].max().item() for v in range(nv)], corners


def rig_launch(fn, plain, grad, args, depth, what, groups=(), timed=False):
    """A backward kernel (fused_variance_volume_grad or
    group_correlation_volume_grad) at these inputs: each source's sweep,
    the kernel against its plain version (check_grad_kernel) and, if
    `timed`, its ms and the rate of its dsrc corner-channel adds (on-image
    corners x C). Returns (largest error, ms or None)."""
    sweeps, corners = sweep_stats(args[2], args[3])
    log(f"  {what}: sweep per source "
        + " / ".join(f"{x:.2f}" for x in sweeps) + " px")
    err = check_grad_kernel(fn, plain, grad, args, depth, what, groups)
    if not timed:
        return err, None
    ms = cuda_ms(lambda: fn(grad, *args, *groups, depth_grad=depth))
    adds = corners * args[0].shape[-1]
    log(f"    kernel {ms:.4f} ms: {adds / 1e6:.1f} M corner-channel adds of "
        f"dsrc, {adds / ms / 1e6:.1f} G/s")
    return err, ms


def phase_warp_grad(device):
    log(f"phase 7a: warp_variance backward kernel vs plain autograd, batch "
        f"{TRAIN_BATCH}, {VIEWS - 1} sources, {TRAIN_W}x{TRAIN_H} stages, "
        f"default and DTU-like rigs (focal {DTU_FOCAL} px)")
    scenes = rig_scenes(VIEWS, TRAIN_H, TRAIN_W)
    rows = []
    for stage, scale, c in STAGES:
        d, h, w = NDEPTHS[stage - 1], TRAIN_H // scale, TRAIN_W // scale
        row = {}
        for rig, scene in scenes.items():
            for dtype in (torch.float32, torch.bfloat16):
                args = warp_inputs(scene, stage, scale, c, d, dtype, device,
                                   batch=TRAIN_BATCH, seed=stage,
                                   height=TRAIN_H, width=TRAIN_W)
                g = torch.Generator().manual_seed(10 + stage)
                grad = torch.randn((TRAIN_BATCH, d, h, w, c),
                                   generator=g).to(device, dtype)
                # bf16 is the training path's type: time it
                timed = dtype is torch.bfloat16
                err, ms = rig_launch(
                    fused_variance_volume_grad,
                    fused_variance_volume_grad_plain, grad, args, False,
                    f"stage{stage} {rig} rig B={TRAIN_BATCH} D={d} {h}x{w} "
                    f"C={c} {str(dtype)[6:]}", timed=timed)
                if not timed:
                    continue
                if rig == "dtu":
                    row.update(dtu_err=err, dtu_ms=ms)
                    continue
                plain_ms = cuda_ms(
                    lambda: fused_variance_volume_grad_plain(
                        grad, *args, depth_grad=False), iters=3, warmup=1)
                by, ops = warp_grad_bound(TRAIN_BATCH, VIEWS - 1, d, h, w, c,
                                          2)
                log(f"    plain {plain_ms:.4f} ms, bound {max(by, ops):.4f} "
                    f"ms (bytes {by:.4f}, ops {ops:.4f})")
                row.update(err=err, ms=ms, plain_ms=plain_ms, bytes_ms=by,
                           ops_ms=ops)
        rows.append(row)
    log(f"  one CasMVSNet train step's warp backward (bf16): "
        f"{sum(r['ms'] for r in rows):.4f} ms on the default rig, "
        f"{sum(r['dtu_ms'] for r in rows):.4f} ms on the DTU-like rig")
    return rows


def train_samples(height, width, batch, views=VIEWS, seed=0, depths=LADDER,
                  start=8.0):
    """`batch` plane scenes (tilted, seeds seed..) as the DTU training split
    gives them: intrinsics and GT depth at 1/4 of the images, every pixel
    valid, a ladder of `depths` hypotheses over start..start + 4
    (depth_interval its spacing; the plane lies near 10)."""
    samples = []
    for i in range(batch):
        scene = make_plane_scene(num_views=views, height=height, width=width,
                                 z0=10.0, seed=seed + i, tilt=(0.05, 0.02))
        intr = scene.intrinsics.copy()
        intr[:, :2] /= 4.0
        gt = np.ascontiguousarray(scene.depths[0][::4, ::4], np.float32)
        samples.append(dict(
            imgs=scene.images, intrinsics=intr, extrinsics=scene.extrinsics,
            depth_values=np.linspace(start, start + 4.0, LADDER,
                                     dtype=np.float32),
            depth_min=np.float32(start), depth_max=np.float32(start + 4.0),
            depth_interval=np.float32(4.0 / (depths - 1)),
            depth_gt=gt, mask=np.ones_like(gt)))
    return samples


class RecordingChain(OptaxChain):
    """The optimizer chain, keeping the gradients of its last step."""

    def step(self, grads=None):
        self.grads = [None if g is None else g.detach().clone()
                      for g in grads]
        return super().step(grads)


def train_once(make_task, state, batch, device):
    """One f32 train step of make_task()'s model from `state` on `device`:
    (metrics, gradients, state_dict after), all on the CPU."""
    task = make_task()
    model = task.model
    model.load_state_dict(state)
    model.to(device)
    opt = RecordingChain(model.parameters(), "adam", lambda step: 1e-3)
    metrics = make_train_step(task, opt)(batch_to_device(batch, device))
    names = [k for k, _ in model.named_parameters()]
    return ({k: float(v) for k, v in metrics.items()},
            {k: g.cpu() for k, g in zip(names, opt.grads)},
            {k: v.cpu() for k, v in model.state_dict().items()})


def phase_train_card_vs_cpu(device):
    log("phase 7b: one CasMVSNet train step, card vs CPU, 128x160, batch 2, "
        "f32, Adam 1e-3")
    state = CasMVSNet(BASE, NDEPTHS, generator=torch.Generator().manual_seed(
        7)).state_dict()
    check_train_step(
        lambda: CascadeTask(CasMVSNet(BASE, NDEPTHS)), state,
        collate_cascade(train_samples(128, 160, 2)), device,
        ("loss", "last_stage_loss", "abs_depth_error"),
        tuple(f"cost_reg_stage{i + 1}.FoldedConv_0.bias"
              for i in range(len(NDEPTHS))))


def check_train_step(make_task, state, batch, device, metric_keys,
                     score_biases, updates=1, runs=None, exact=None):
    """One f32 train step card against CPU (limits: STEP_LOSS_RTOL,
    GRAD_TOL and GRAD_NUDGE_FACTOR, GRAD_COSINE, STEP_STATS_RTOL, Adam's
    step). `score_biases`: the score convs' biases, whose exact gradient
    is 0 (see GRAD_TOL's note), left out of the gradient checks;
    `updates`: each BatchNorm's count after the step (a module shared by
    the levels of a pyramid updates once per level), or a tuple of the
    counts there must be; `runs(label)`, when
    given, a context each step runs in ("cpu", then "card" and "nudged":
    Point-MVSNet's GraphTape); `exact()`, when given, the step's float64
    gradients on the CPU (run in runs("exact")): a gradient also passes
    when the card's lies no farther from it than twice the CPU's f32
    gradient does, i.e. when the card is as accurate as the CPU."""
    runs = runs or (lambda label: contextlib.nullcontext())
    with runs("cpu"):
        cpu = train_once(make_task, state, batch, "cpu")
    with runs("card"):
        card = train_once(make_task, state, batch, device)
    sign = np.random.default_rng(0).choice([-1.0, 1.0],
                                           size=batch["imgs"].shape)
    nudged_batch = dict(batch, imgs=(batch["imgs"] * (1 + sign * 2.0 ** -24)
                                     ).astype(np.float32))
    with runs("nudged"):
        nudged = train_once(make_task, state, nudged_batch, "cpu")
    if exact is not None:
        with runs("exact"):
            exact = exact()
    for k in metric_keys:
        rel = abs(card[0][k] - cpu[0][k]) / abs(cpu[0][k])
        log(f"  {k}: card {card[0][k]:.8f} CPU {cpu[0][k]:.8f} (rel "
            f"{rel:.2e}, tol {STEP_LOSS_RTOL})")
        if not rel <= STEP_LOSS_RTOL:
            fail(f"train step {k} differs card vs CPU")
    worst, n_tol, n_nudge, n_exact = [], 0, 0, 0
    for k, g_cpu in cpu[1].items():
        if k in score_biases:
            continue
        g_card = card[1][k]
        scale = g_cpu.abs().max().item()
        err = (g_card - g_cpu).abs().max().item()
        moved = (nudged[1][k] - g_cpu).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(
            g_card.flatten().double(), g_cpu.flatten().double(), dim=0).item()
        ok_tol = err <= GRAD_TOL * scale
        ok_nudge = err <= GRAD_NUDGE_FACTOR * moved
        ok_exact = exact is not None and (
            (g_card.double() - exact[k]).abs().max()
            <= 2 * (g_cpu.double() - exact[k]).abs().max()).item()
        n_tol += ok_tol
        n_nudge += ok_nudge and not ok_tol
        n_exact += ok_exact and not (ok_tol or ok_nudge)
        worst.append((err / scale, k, moved / scale, cos))
        if not (ok_tol or ok_nudge or ok_exact) or not cos > GRAD_COSINE:
            fail(f"gradient of {k}: card vs CPU {err:.3e} of {scale:.3e}, "
                 f"one rounding moved it {moved:.3e}, cosine {cos:.8f}")
    worst.sort(reverse=True)
    log(f"  gradients: {len(worst)} parameters, {n_tol} within "
        f"{GRAD_TOL} of their largest magnitude, {n_nudge} more within "
        f"{GRAD_NUDGE_FACTOR}x what one rounding of the images moved them"
        + (f", {n_exact} more no farther from float64 than twice the CPU's"
           if exact is not None else "") + "; "
        f"worst: " + "; ".join(f"{k} {e:.2e} (rounding {m:.2e}, cosine "
                               f"{c:.8f})" for e, k, m, c in worst[:3]))
    # Each statistic vector against its largest magnitude: a channel's batch
    # mean near 0 carries the rounding of the whole vector's sums.
    stats = [k for k in cpu[2] if k.rsplit(".", 1)[-1] in ("mean", "var",
                                                          "count")]
    err = max(((card[2][k] - cpu[2][k]).abs().max()
               / cpu[2][k].abs().max()).item() for k in stats)
    counts = {float(card[2][k]) for k in stats if k.endswith("count")}
    log(f"  {len(stats)} statistics: card vs CPU within {err:.2e} of each "
        f"vector's largest magnitude (tol {STEP_STATS_RTOL}); counts "
        f"{sorted(counts)}")
    if not err <= STEP_STATS_RTOL or counts != set(
            map(float, updates if isinstance(updates, tuple) else (updates,))):
        fail("BatchNorm statistics differ card vs CPU")
    # Adam's first step is lr * g / (|g| + eps), eps = 1e-8: equal to 1e-6
    # where the gradient's sign is certain (|g| over twice the tensor's
    # largest card vs CPU difference) and |g| > 1e-5 (so that eps moves it
    # by under lr * eps / |g| = 1e-6), at most 2 lr apart elsewhere.
    for k, g_cpu in cpu[1].items():
        certain = ((g_cpu.abs() > 2 * (card[1][k] - g_cpu).abs().max())
                   & (g_cpu.abs() > 1e-5))
        diff = (card[2][k] - cpu[2][k]).abs()
        worst = diff[certain].max() if certain.any() else diff.new_zeros(())
        if worst > 1e-6 or diff.max() > 2e-3 * (1 + 1e-5):
            i = int(torch.argmax(torch.where(certain, diff, 0.0)))
            fail(f"{k} after the Adam step differs card vs CPU: "
                 f"{worst.item():.3e} where |g| = "
                 f"{g_cpu.flatten()[i].item():.3e}, largest {diff.max():.3e}")
    log("  parameters after one Adam step agree (within 1e-6 where the "
        "gradient's sign is certain)")


def step_split(task, opt, batch) -> dict:
    """Device ms of one make_train_step step's forward (loss), backward and
    optimizer update, from CUDA events recorded at its marks."""
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    make_train_step(task, opt, mark)(batch)
    torch.cuda.synchronize()
    names = list(events)
    return {b: round(events[a].elapsed_time(events[b]), 4)
            for a, b in zip(names, names[1:])}


def kernel_family(name: str) -> str:
    low = name.lower()
    if "warp_variance_grad" in low:
        return "warp backward (kernel)"
    if "warp_variance" in low:
        return "warp forward (kernel)"
    if "group_correlation_grad" in low:
        return "group correlation backward (kernel)"
    if "group_correlation" in low:
        return "group correlation forward (kernel)"
    if "wgrad" in low:
        return "conv weight grad (cuDNN)"
    if "dgrad" in low:
        return "conv input grad (cuDNN)"
    if any(t in low for t in ("conv", "xmma", "cudnn", "gemm", "cutlass",
                              "winograd", "implicit")):
        return "conv forward / gemm (cuDNN, cuBLAS)"
    if "reduce" in low:
        return "reductions (BatchNorm moments, losses)"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def phase_train_full_width(device):
    log(f"phase 7c: CasMVSNet training at full width, {TRAIN_W}x{TRAIN_H}, "
        f"{VIEWS} views, {'/'.join(map(str, NDEPTHS))} hypotheses, bf16, "
        f"batch {TRAIN_BATCH}, Adam 1e-3")
    model = CasMVSNet(BASE, NDEPTHS, compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0),
                      trained=False).to(device)
    batch = collate_cascade(train_samples(TRAIN_H, TRAIN_W, TRAIN_BATCH))
    return train_full_width(
        CascadeTask(model), batch, TRAIN_LAUNCHES, device,
        lambda run: layer_breakdown(model, run, ()))


def train_full_width(task, batch, want, device, layers):
    """Train `task`'s bf16 model on one batch with Adam 1e-3: the launches
    of one step (exactly `want`), ms per step over TRAIN_STEPS (host
    clock), samples/s, peak memory, the device ms of the step's parts, of
    its forward by layer kind (layers(run) for run(): one step) and by
    kernel family, then CURVE_STEPS more steps, whose losses must fall.
    Returns (launches, ms per step, peak GiB)."""
    opt = OptaxChain(task.model.parameters(), "adam", lambda step: 1e-3)
    step = make_train_step(task, opt)
    batch = batch_to_device(batch, device)
    size = batch["imgs"].shape[0]
    losses = [step(batch)["loss"]]  # warm-up: cuDNN's choices, allocator
    torch.cuda.synchronize()
    reset_counts()
    losses.append(step(batch)["loss"])
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  launches per step {json.dumps(counts)}")
    if counts != want:
        fail(f"train step launches {counts}, want {want}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step(batch)["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {ms:.2f} ms per step ({TRAIN_STEPS} steps, host clock), "
        f"{size * 1e3 / ms:.3f} samples/s, peak {peak:.3f} GiB allocated")
    log("  device ms of one step: "
        + json.dumps(step_split(task, opt, batch)))
    log("  forward device ms by layer kind, one step ('rest': the warp, "
        "regression and loss, then the backward and the optimizer): "
        + json.dumps(layers(lambda: step(batch))))
    by_name = log_spans(device_spans(lambda: step(batch)))
    families = {}
    for name, t in by_name.items():
        families[kernel_family(name)] = families.get(
            kernel_family(name), 0.0) + t
    log("  device ms by kernel family, one step: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(families.items(),
                                           key=lambda kv: -kv[1])}))
    losses += [step(batch)["loss"] for _ in range(CURVE_STEPS)]
    curve = [float(x) for x in losses[-CURVE_STEPS:]]
    first, last = np.mean(curve[:5]), np.mean(curve[-5:])
    log(f"  {CURVE_STEPS} more steps on the same batch: loss "
        + " ".join(f"{x:.4f}" for x in curve)
        + f"; mean of the first 5 {first:.5f}, of the last 5 {last:.5f}")
    if not np.isfinite([float(x) for x in losses]).all():
        fail("non-finite training loss")
    if not last < first:
        fail("the training loss did not fall")
    return counts, ms, peak


def phase_cli_train(device):
    log(f"phase 7d: cli train on a synthetic DTU training layout (images "
        f"{TRAIN_W}x{TRAIN_H}, depths {TRAIN_W // 4}x{TRAIN_H // 4}), then "
        f"cli infer --step best / latest")
    config = Path(__file__).resolve().parent / "configs" / "cas_train_dtu.yaml"
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        root = generate(work / "dtu", num_scans=2, num_views=VIEWS,
                        height=TRAIN_H, width=TRAIN_W, num_depth=LADDER,
                        num_lights=1, tilt=SCAN_TILT)
        log(f"  written in {time.perf_counter() - t0:.2f} s")
        reset_counts()
        result = cli_train.main([
            "--config", str(config), "--device", str(device),
            f"data.root={root}", f"data.train_list={root}/lists/train.txt",
            f"data.val_list={root}/lists/val.txt", "data.batch_size=2",
            "train.epochs=2", "train.summary_every_steps=1",
            f"train.log_dir={work / 'run'}"])
        torch.cuda.synchronize()
        counts = read_counts()
        # 2 epochs x 2 steps of 3 + 3 warp launches; val 2 epochs x 2
        # batches of 3 warp and 15 conv launches (eval mode, bf16).
        want = {"warp_variance": 24, "warp_variance.vector": 24,
                "warp_variance_grad": 12, "warp_variance_grad.depth": 0,
                "conv3d_affine": 60, "conv3d_affine.mma": 60,
                "conv3d_affine.tf32x3": 0, "conv3d_affine.tf32x3_cin64": 0,
                **NO_GROUP}
        log(f"  {result['step']} steps, losses "
            + " ".join(f"{x:.4f}" for x in result["losses"])
            + f", {result['step'] * 2 / result['seconds']:.3f} samples/s "
            f"through the CLI's steps; val {json.dumps(result['val'])}; "
            f"launches {json.dumps(counts)}")
        if counts != want:
            fail(f"cli train launches {counts}, want {want}")
        if result["step"] != 4 or not np.isfinite(result["losses"]).all():
            fail("cli train did not take 4 finite steps")
        (work / "val.txt").write_text("scan2\n")
        loaded = {}
        for which in ("best", "latest"):
            out = work / f"out_{which}"
            res = cli_infer.main([
                "--ckpt", result["ckpt_dir"], "--step", which,
                "--out", str(out), "--device", str(device),
                "model.compute_dtype=bfloat16", f"data.eval_root={root}",
                f"data.eval_list={work / 'val.txt'}",
                f"data.num_views={VIEWS}", f"data.num_depth={LADDER}",
                f"data.max_h={TRAIN_H}", f"data.max_w={TRAIN_W}",
                "data.batch_size=2"])
            check_files(out / "scan2", VIEWS, TRAIN_H, TRAIN_W)
            loaded[which] = res["step"]
        log(f"  cli infer loaded step {loaded['best']} for --step best and "
            f"{loaded['latest']} for --step latest; 5 maps each written")
        if loaded["latest"] != 4 or loaded["best"] not in (2, 4):
            fail(f"cli infer loaded steps {loaded}")
    return counts


def phase_training(device):
    rows = phase_warp_grad(device)
    phase_train_card_vs_cpu(device)
    counts, _, _ = phase_train_full_width(device)
    cli_counts = phase_cli_train(device)
    return rows, counts, cli_counts


# Phase 8. CVP-MVSNet and AACVP-MVSNet at the widths of
# configs/cvp_eval_dtu.yaml: 5 levels, 48 coarse hypotheses, 8 residual
# ones (num_offsets 4), 16 feature channels, regularizer base 16, 5 views,
# epipolar interval, batch 1. Images 1600x1184 (data.align=32): at DTU's
# 1600x1200 the coarsest level has 75 rows, which PyramidCostRegNet cannot
# halve and double back (mvs_tpu fails there too; 8e checks the port's
# error).
CVP_CONFIG = Path(__file__).resolve().parent / "configs" / "cvp_eval_dtu.yaml"
CVP_H, CVP_W, CVP_LEVELS, CVP_C, CVP_GROUPS = 1184, 1600, 5, 16, 4
CVP_COARSE_D, CVP_FINE_D, CVP_BASE = 48, 8, 16
CVP_RANGE = (8.0, 12.0)  # the depth range given to the plane scenes (z0 10)
CVP_NAMES = ("cvp_mvsnet", "aacvp_mvsnet")
# Launches per depth map, batch 1, by kernel variant (warp, .vector,
# conv3d, .mma, .tf32x3, .tf32x3_cin64, group correlation, .vector). Every
# level runs one cost volume and 9 stride-1 convs (7 blocks, the stride-1
# transposed block, the score conv). AACVP's attention adds f32 position
# embeddings to its keys (as mvs_tpu does), so its features and cost volume
# are f32 in a bf16 model and its first two blocks, (4, 16) and (16, 16),
# run the 3xTF32 conv kernel; the blocks after the stride-2 block (cast to
# bf16) take the bf16 tensor cores. In f32 the 6 convs of a level with Cin
# in {16, 32} (AACVP's first: 4) take the 3xTF32 kernel, the 3 with Cin =
# 64 (the two (64, 64) blocks and the transposed 64->32) its Cin = 64
# kernel: none is direct.
CVP_LAUNCHES = {
    ("cvp_mvsnet", torch.bfloat16): (5, 5, 45, 45, 0, 0, 0, 0),
    ("cvp_mvsnet", torch.float32): (5, 5, 45, 0, 30, 15, 0, 0),
    ("aacvp_mvsnet", torch.bfloat16): (0, 0, 45, 35, 10, 0, 5, 5),
    ("aacvp_mvsnet", torch.float32): (0, 0, 45, 0, 30, 15, 5, 5),
}
CVP_SCAN_VIEWS = 6


def cvp_want(name, dtype, maps=1) -> dict:
    warp, vec, conv, mma, tf32, cin64, group, gvec = CVP_LAUNCHES[
        (name, dtype)]
    return {"warp_variance": maps * warp, "warp_variance.vector": maps * vec,
            "warp_variance_grad": 0, "warp_variance_grad.depth": 0,
            "conv3d_affine": maps * conv,
            "conv3d_affine.mma": maps * mma,
            "conv3d_affine.tf32x3": maps * tf32,
            "conv3d_affine.tf32x3_cin64": maps * cin64,
            "group_correlation": maps * group,
            "group_correlation.vector": maps * gvec,
            "group_correlation_grad": 0, "group_correlation_grad.depth": 0}


def cvp_levels():
    """(level, D, H, W) of the main path's cost volumes, coarsest first."""
    return [(lv, CVP_COARSE_D if lv == CVP_LEVELS - 1 else CVP_FINE_D,
             CVP_H >> lv, CVP_W >> lv) for lv in range(CVP_LEVELS - 1, -1, -1)]


def cvp_volume_inputs(scene, level, d, dtype, device, c=CVP_C, batch=1,
                      seed=0, height=CVP_H, width=CVP_W, levels=CVP_LEVELS):
    """Features, rel projections and hypotheses of one level's cost volume
    of a `levels`-level pyramid over height x width images of `scene`: the
    coarsest level sweeps a global ladder, the finer ones 8 residual
    hypotheses around a noisy plane depth, as the model does."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    h, w = height >> level, width >> level
    feats = torch.randn((batch, len(scene.extrinsics), h, w, c),
                        generator=g).to(device, dtype)
    if level == levels - 1:
        hyp = torch.linspace(*CVP_RANGE, d, device=device)[:, None, None]
        hyp = hyp.expand(d, h, w)
    else:
        depth = torch.tensor(scene.depths[0][::2 ** level, ::2 ** level],
                             device=device)
        noise = torch.randn((h, w), generator=g).to(device) * 0.05
        steps = torch.arange(-d // 2, d // 2, device=device)[:, None, None]
        hyp = depth + noise + steps * 0.02
    hyp = hyp[None].expand(batch, d, h, w).contiguous()
    rel = stage_geometry(scene, 2 ** level, device, batch)
    return (feats[:, 0].contiguous(), feats[:, 1:].contiguous(), rel, hyp)


def group_bound(b, v, d, h, w, c, g, itemsize):
    """Least time of the group correlation: features and hypotheses read
    once, the (B, D, H, W, G) volume written once; the least f32 work: per
    (pixel, view) the rotation (12), per (depth, pixel, view) the
    coordinates and corner weights (16), per (channel, view) the blend (7)
    and the sum over views (1), per channel the product with ref and the
    group sum (2), per group the scale (1)."""
    nbytes = (b * (1 + v) * h * w * c * itemsize + b * d * h * w * 4
              + b * v * 12 * 4 + b * d * h * w * g * itemsize)
    ops = b * h * w * v * 12 + b * d * h * w * (v * (16 + 8 * c) + 2 * c + g)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            ops / PEAK_FLOPS[torch.float32] * 1e3)


def check_group(args, groups, vector, what) -> float:
    vec = group_correlation_volume.vector_launches
    n = group_correlation_volume.launches
    err = compare("group", group_correlation_volume(*args, groups),
                  group_correlation_volume_plain(*args, groups), what)
    if group_correlation_volume.launches != n + 1:
        fail(f"{what}: group-correlation kernel not launched")
    if group_correlation_volume.vector_launches - vec != int(vector):
        fail(f"{what}: wrong variant (vector {vector} expected)")
    return err


def phase_cvp_kernels(scene, device):
    log(f"phase 8a: kernels at CVP's shapes ({CVP_W}x{CVP_H}, "
        f"{CVP_LEVELS} levels, {VIEWS} views, C={CVP_C})")
    group_rows = []
    for level, d, h, w in cvp_levels():
        for dtype in (torch.float32, torch.bfloat16):
            args = cvp_volume_inputs(scene, level, d, dtype, device,
                                     seed=level)
            what = (f"group_correlation level{level} B=1 D={d} {w}x{h} "
                    f"C={CVP_C} G={CVP_GROUPS} {str(dtype)[6:]}")
            err = check_group(args, CVP_GROUPS, True, what)
            ms = cuda_ms(lambda: group_correlation_volume(*args, CVP_GROUPS))
            plain_ms = cuda_ms(
                lambda: group_correlation_volume_plain(*args, CVP_GROUPS),
                iters=3, warmup=1)
            itemsize = torch.tensor([], dtype=dtype).element_size()
            by, ops = group_bound(1, VIEWS - 1, d, h, w, CVP_C, CVP_GROUPS,
                                  itemsize)
            log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{max(by, ops):.4f} ms (bytes {by:.4f}, ops {ops:.4f})")
            # AACVP's features are f32 in its bf16 model: that is the main
            # path's type.
            if dtype is torch.float32:
                group_rows.append(dict(err=err, ms=ms, plain_ms=plain_ms,
                                       bytes_ms=by, ops_ms=ops))
    # Batch 2; C not a multiple of 8 (scalar variant) with off-image and
    # behind-camera samples; D = 1.
    args = cvp_volume_inputs(scene, CVP_LEVELS - 1, CVP_COARSE_D,
                             torch.float32, device, batch=2, seed=9)
    check_group(args, CVP_GROUPS, True, "group_correlation coarsest B=2 f32")
    for dtype in (torch.float32, torch.bfloat16):
        args = ragged_volume_inputs(dtype, device)
        check_group(args, 3, False, f"group_correlation off-image/behind-"
                    f"camera C=12 G=3 {str(dtype)[6:]} (scalar)")
        one = (*args[:3], args[3][:, 3:4].contiguous())
        check_group(one, 3, False, f"group_correlation D=1 C=12 G=3 "
                    f"{str(dtype)[6:]}")
        # The 16-byte variant's other group layouts: groups across chunks
        # (C = 24, G = 2: Cg = 12) and several groups per chunk (C = 16,
        # G = 8: Cg = 2).
        for c, groups in ((24, 2), (16, 8)):
            args = ragged_volume_inputs(dtype, device, c=c)
            check_group(args, groups, True, f"group_correlation off-image/"
                        f"behind-camera C={c} G={groups} {str(dtype)[6:]}")
        # Wide features: the lane kernel takes at most 32 16-byte chunks
        # (bf16 C = 160: 32 lanes a pixel, 12 of them idle); above that
        # (f32 C = 160, C = 264) the scalar variant runs.
        for c in (160, 264):
            args = ragged_volume_inputs(dtype, device, c=c)
            vector = c * args[0].element_size() <= 32 * 16
            check_group(args, 4, vector, f"group_correlation off-image/"
                        f"behind-camera C={c} G=4 {str(dtype)[6:]} "
                        f"({'vector' if vector else 'scalar'})")
    tf32_rows = aacvp_f32_convs(device)
    cin64_rows = cvp_cin64_f32_convs(device)

    # The warp-variance and conv3d kernels at CVP's coarsest and finest
    # levels (bf16, the CVP main path's type, timed; f32 checked).
    for level, d in ((CVP_LEVELS - 1, CVP_COARSE_D), (0, CVP_FINE_D)):
        h, w = CVP_H >> level, CVP_W >> level
        for dtype in (torch.bfloat16, torch.float32):
            args = cvp_volume_inputs(scene, level, d, dtype, device,
                                     seed=level)
            vec = fused_variance_volume.vector_launches
            compare("warp", fused_variance_volume(*args),
                    fused_variance_volume_plain(*args),
                    f"warp_variance level{level} D={d} {w}x{h} C={CVP_C} "
                    f"{str(dtype)[6:]}")
            if fused_variance_volume.vector_launches != vec + 1:
                fail("CVP warp not on the 16-byte vector variant")
            if dtype is torch.bfloat16:
                ms = cuda_ms(lambda: fused_variance_volume(*args))
                by, ops = warp_bound(1, VIEWS - 1, d, h, w, CVP_C, 2)
                log(f"    kernel {ms:.4f} ms, bound {max(by, ops):.4f} ms "
                    f"(bytes {by:.4f}, ops {ops:.4f})")
        cvp_conv_checks(cvp_level_convs(d, h, w), level, device)
    return group_rows, tf32_rows, cin64_rows


def cvp_level_convs(d, h, w):
    """(Cin, Cout, D, H, W, relu) of every stride-1 conv of one level of
    PyramidCostRegNet over a D x H x W volume: the first block (AACVP's
    (4, 16), CVP's (16, 16)), the second, five blocks at half the volume
    (the last two (64, 64)), the stride-1 transposed block's 64->32 there,
    and the score conv."""
    b = CVP_BASE
    full = [(CVP_GROUPS, b), (CVP_C, b), (b, b)]  # (4, b): AACVP's first
    half = [(2 * b, 2 * b), (2 * b, 2 * b), (2 * b, 4 * b),
            (4 * b, 4 * b), (4 * b, 4 * b), (4 * b, 2 * b)]
    return ([(ci, co, d, h, w, True) for ci, co in full]
            + [(ci, co, d // 2, h // 2, w // 2, True) for ci, co in half]
            + [(b, 1, d, h, w, False)])


def cvp_cin64_shapes():
    """(level, Cout, D, H, W) of the f32 convs at Cin = 64 of one CVP /
    AACVP map, coarsest level first: per level the two (64, 64) blocks and
    the stride-1 transposed block's 64->32, at half the level's volume."""
    return [(level, co, dd, hh, ww)
            for level, d, h, w in cvp_levels()
            for ci, co, dd, hh, ww, _ in cvp_level_convs(d, h, w)
            if ci == 64]


def cvp_cin64_f32_convs(device):
    """The 15 f32 convs at Cin = 64 of an f32 CVP or AACVP map, each
    against its plain version on the 3xTF32 Cin = 64 kernel, timed (kernel,
    plain, cuDNN f32 with TF32 off, the bounds), and their sum."""
    g = torch.Generator(device="cpu").manual_seed(23)
    rows = []
    for level, cout, d, h, w in cvp_cin64_shapes():
        err, args = check_conv(g, device, 1, d, h, w, 4 * CVP_BASE, cout,
                               True, torch.float32,
                               f"CVP f32 conv3d level{level} ")
        rows.append(time_conv(err, *args, True))
        del args
    log_sum(f"CVP / AACVP's {len(rows)} f32 convs at Cin = 64 of a map",
            rows)
    return rows


def aacvp_f32_convs(device):
    """AACVP's two f32 blocks, (4, 16) and (16, 16), at every level of a
    bf16 map (its attention features are f32): each against its plain
    version on the 3xTF32 kernel, timed (kernel, plain, cuDNN f32 with TF32
    off, the bounds), and their sum over the map's 10 launches."""
    g = torch.Generator(device="cpu").manual_seed(17)
    rows = []
    for level, d, h, w in cvp_levels():
        for cin in (CVP_GROUPS, CVP_BASE):
            err, args = check_conv(g, device, 1, d, h, w, cin, CVP_BASE,
                                   True, torch.float32,
                                   f"AACVP f32 conv3d level{level} ")
            rows.append(time_conv(err, *args, True))
    log_sum(f"AACVP's {len(rows)} f32 convs of a map", rows)
    return rows


def cvp_conv_checks(shapes, level, device):
    """Every stride-1 conv of one level of PyramidCostRegNet (the last of
    `half` is the stride-1 transposed block's 64->32) against its plain
    version, f32 and bf16; bf16 timed as in phase 2b (AACVP's (4, 16) runs
    in f32 on its main path)."""
    g = torch.Generator(device="cpu").manual_seed(11 + level)
    rows = []
    for cin, cout, d, h, w, relu in shapes:
        check_conv(g, device, 1, d, h, w, cin, cout, relu, torch.float32,
                   f"conv3d level{level} ")
        err, args = check_conv(g, device, 1, d, h, w, cin, cout, relu,
                               torch.bfloat16, f"conv3d level{level} ")
        if cin != CVP_GROUPS:
            rows.append(time_conv(err, *args, relu))
    log(f"  level {level}, CVP's {len(rows)} bf16 convs: kernel "
        f"{sum(r['ms'] for r in rows):.4f} ms, plain "
        f"{sum(r['plain_ms'] for r in rows):.4f} ms, library "
        f"{sum(r['library_ms'] for r in rows):.4f} ms, bound "
        f"{sum(max(r['bytes_ms'], r['ops_ms']) for r in rows):.4f} ms")


def cvp_config(name, dtype, *overrides):
    return load_config(str(CVP_CONFIG), [
        f"model.name={name}", f"model.compute_dtype={str(dtype)[6:]}",
        "data.align=32", *overrides])


def cvp_sample(scene):
    return dict(imgs=scene.images, intrinsics=scene.intrinsics,
                extrinsics=scene.extrinsics, depth_min=CVP_RANGE[0],
                depth_max=CVP_RANGE[1])


def phase_cvp_vs_cpu(device):
    scene = make_plane_scene(num_views=VIEWS, height=128, width=160,
                             z0=10.0, tilt=(0.05, 0.02))
    for name in CVP_NAMES:
        for dtype in (torch.float32, torch.bfloat16):
            cvp_vs_cpu(name, scene, dtype, device)


def cvp_vs_cpu(name, scene, dtype, device):
    """Card (kernels) against CPU (plain versions) on one seeded model,
    3 levels at 128x160. Limits as phase 3's, in units of the coarse
    ladder's interval for depth; in bf16 each limit is also at least the
    multiple of phase 3 of what one bf16 rounding of the images moves the
    CPU's own outputs (logged), since a deeper pyramid carries a rounding
    step further."""
    log(f"phase 8b: {name} 3 levels 128x160 {str(dtype)[6:]}, card vs CPU")
    model = build_model(cvp_config(name, dtype, "model.num_levels=3"),
                        torch.Generator().manual_seed(7))
    scores, levels = [], []
    hooks = [model.PyramidCostRegNet_0.register_forward_hook(
                 lambda m, a, out: scores.append(out.float().cpu())),
             model.register_forward_hook(
                 lambda m, a, out: levels.append(
                     [d.float().cpu() for d in out["depth_levels"]]))]
    inputs = stack_model_inputs([cvp_sample(scene)], "cpu", "pyramid")
    cpu = [t.float() for t in make_apply_fn(model, "cpu")(*inputs)]
    moved = None
    if dtype is torch.bfloat16:  # the yardstick of the bf16 limits
        sign = torch.from_numpy(np.random.default_rng(0).choice(
            [-1.0, 1.0], size=tuple(inputs[0].shape)).astype(np.float32))
        nudged = [t.float() for t in make_apply_fn(model, "cpu")(
            inputs[0] * (1 + sign * 2.0 ** -8), *inputs[1:])]
        moved = dict(
            score=[((b - a).abs() / (a.max() - a.min()))
                   for a, b in zip(scores[:3], scores[3:6])],
            depth=[(b - a).abs() for a, b in zip(levels[0], levels[1])],
            conf=(nudged[1] - cpu[1]).abs())
        del scores[3:], levels[1:]
    card = [t.float().cpu() for t in make_apply_fn(model, device)(
        *stack_model_inputs([cvp_sample(scene)], device, "pyramid"))]
    for h in hooks:
        h.remove()
    for i, (s_cpu, s_card) in enumerate(zip(scores[:3], scores[3:])):
        check_scores(f"{name} level {2 - i}", s_cpu, s_card, dtype,
                     None if moved is None else moved["score"][i])
    unit = (CVP_RANGE[1] - CVP_RANGE[0]) / (CVP_COARSE_D - 1)
    for lv, (d_cpu, d_card) in enumerate(zip(levels[0], levels[1])):
        check_depth(f"{name} level {lv} depth", d_cpu, d_card, unit, dtype,
                    None if moved is None else moved["depth"][lv])
    check_confidence(name, cpu[1], card[1],
                     None if moved is None else moved["conf"])


def check_scores(what, s_cpu, s_card, dtype, moved=None):
    """Pre-softmax scores card against CPU, as fractions of the CPU's
    spread: within SCORE_TOL, or where `moved` (what one rounding of the
    images moves the CPU's own scores, the same fraction) is given, within
    4x its largest and 6x its mean if those are larger (f32 has no mean
    limit)."""
    max_tol, mean_tol = SCORE_TOL[dtype]
    spread = (s_cpu.max() - s_cpu.min()).item()
    diff = (s_card - s_cpu).abs()
    err, mean = diff.max().item() / spread, diff.mean().item() / spread
    note = ""
    if moved is not None:
        max_tol = max(max_tol, 4 * moved.max().item())
        if mean_tol is not None:
            mean_tol = max(mean_tol, 6 * moved.mean().item())
        note = (f"; one rounding of the images moves the CPU's by "
                f"max {moved.max().item():.3e}, mean "
                f"{moved.mean().item():.3e}")
    log(f"  {what} score {tuple(s_cpu.shape)}: |card-cpu| max {err:.3e}, "
        f"mean {mean:.3e} of its spread {spread:.4f} (limits {max_tol:.3e}, "
        f"{mean_tol}){note}")
    if not err <= max_tol or (mean_tol is not None and not mean <= mean_tol):
        fail(f"{what} card scores differ from CPU scores")


def check_depth(what, d_cpu, d_card, unit, dtype, moved=None):
    """Depth card against CPU in hypothesis intervals (`unit`): within
    DEPTH_TOL, or where `moved` (what one bf16 rounding of the images moves
    the CPU's own depth) is given, within 14x its largest and mean if
    those are larger."""
    err = (d_card - d_cpu).abs() / unit
    lim_max, lim_mean = DEPTH_TOL[dtype]
    if moved is not None:
        lim_max = max(lim_max, 14 * (moved / unit).max().item())
        lim_mean = max(lim_mean, 14 * (moved / unit).mean().item())
    log(f"  {what} |card-cpu| in intervals ({unit:.4f}): max "
        f"{err.max().item():.3e} mean {err.mean().item():.3e} (limits "
        f"{lim_max:.3e}, {lim_mean:.3e}); range [{d_cpu.min().item():.4f}, "
        f"{d_cpu.max().item():.4f}]")
    if not (err.max() <= lim_max and err.mean() <= lim_mean):
        fail(f"{what}: card differs from CPU")


def check_confidence(what, c_cpu, c_card, moved=None):
    """Confidence card against CPU: it sums 4 taps around the truncated
    regressed index, which can step where the index sits on an integer, so
    over 1e-3 apart on at most 1e-3 of the pixels (or 4x the share that
    one bf16 rounding of the images moves by that much, `moved`)."""
    c_err = (c_card - c_cpu).abs()
    share_lim = 1e-3
    if moved is not None:
        share_lim = max(share_lim, 4 * (moved > 1e-3).float().mean().item())
    share = (c_err > 1e-3).float().mean().item()
    log(f"  {what} confidence |card-cpu| max {c_err.max().item():.3e} mean "
        f"{c_err.mean().item():.3e}, > 1e-3 on {share:.3e} of the pixels "
        f"(limit {share_lim:.3e})")
    if share > share_lim or c_err.mean() > max(1e-3, share_lim):
        fail(f"{what} card confidence differs from CPU confidence")


def module_spans(kinds: dict, owner, name, run) -> tuple[dict, float]:
    """({kind: device ms}, total device ms) of one run(), from CUDA events
    around each forward of the modules in `kinds` (a module or a tuple of
    them per kind) and around every call of owner.<name> (the cost
    volumes, as "cost volume"); `name` may also be {attribute: kind of a
    call, or a function of the call's arguments giving it}."""
    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    spans, stack, hooks = [], [], []
    for kind, modules in kinds.items():
        for module in modules if isinstance(modules, tuple) else (modules,):
            hooks.append(module.register_forward_pre_hook(
                lambda m, a, kind=kind: stack.append((kind, event()))))
            hooks.append(module.register_forward_hook(
                lambda m, a, out: spans.append((*stack.pop(), event()))))
    names = name if isinstance(name, dict) else {name: "cost volume"}
    saved = {attr: getattr(owner, attr) for attr in names}

    def timer(attr):
        def timed(*a, **kw):
            kind = names[attr]
            kind = kind if isinstance(kind, str) else kind(*a, **kw)
            start = event()
            out = saved[attr](*a, **kw)
            spans.append((kind, start, event()))
            return out
        return timed

    for attr in names:
        setattr(owner, attr, timer(attr))
    try:
        start = event()
        run()
        end = event()
        torch.cuda.synchronize()
    finally:
        for attr, fn in saved.items():
            setattr(owner, attr, fn)
        for h in hooks:
            h.remove()
    ms = {}
    for kind, a, b in spans:
        ms[kind] = ms.get(kind, 0.0) + a.elapsed_time(b)
    return ms, start.elapsed_time(end)


def with_rest(ms: dict, total: float) -> dict:
    """`ms` with 'rest' (the run's remainder) and 'total', rounded."""
    ms = dict(ms, rest=total - sum(ms.values()), total=total)
    return {k: round(v, 4) for k, v in ms.items()}


def cvp_breakdown(model, apply_fn, args) -> dict:
    """Device ms of one map by layer kind: the feature net (minus its
    attention), the attention, the cost volumes and the regularizer;
    'rest': the resizes, projections, epipolar intervals, hypotheses and
    regressions."""
    kinds = {"feature net": model.PyramidFeatureNet_0,
             "regularizer": model.PyramidCostRegNet_0}
    if model.PyramidFeatureNet_0.attention:
        kinds["attention"] = model.PyramidFeatureNet_0.AttentionConv_0
    ms, total = module_spans(kinds, model, "_cost_volume",
                             lambda: apply_fn(*args))
    if "attention" in ms:
        ms["feature net"] -= ms["attention"]
    return with_rest(ms, total)


def phase_cvp_full_width(scene, device):
    log(f"phase 8c: full width {CVP_W}x{CVP_H}, {VIEWS} views, "
        f"{CVP_LEVELS} levels, {CVP_COARSE_D} + 4 x {CVP_FINE_D} "
        f"hypotheses, batch 1")
    result = {}
    args = stack_model_inputs([cvp_sample(scene)], device, "pyramid")
    for name in CVP_NAMES:
        for dtype in (torch.bfloat16, torch.float32):
            model = build_model(cvp_config(name, dtype),
                                torch.Generator().manual_seed(0))
            apply_fn = make_apply_fn(model, device)
            apply_fn(*args)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            depth, conf = apply_fn(*args)
            torch.cuda.synchronize()
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ms = map_ms(apply_fn, args)
            log(f"  {name} {str(dtype)[6:]}: {ms:.2f} ms per depth map, "
                f"peak {peak:.3f} GiB allocated, launches "
                f"{json.dumps(counts)}")
            want = cvp_want(name, dtype)
            if counts != want:
                fail(f"{name} {str(dtype)[6:]} launches {counts}, want "
                     f"{want}")
            if depth.shape != (1, CVP_H, CVP_W) or conf.shape != depth.shape:
                fail(f"output shapes {tuple(depth.shape)} {tuple(conf.shape)}")
            if not (torch.isfinite(depth).all() and torch.isfinite(conf).all()
                    and ((conf >= 0) & (conf <= 1 + 1e-5)).all()):
                fail(f"{name} full-width outputs not finite or confidence "
                     f"outside [0, 1]")
            result[(name, dtype)] = counts
            if dtype is torch.bfloat16:
                result[name] = (counts, ms, peak)
                log("  bf16 device ms by layer kind, one run: "
                    + json.dumps(cvp_breakdown(model, apply_fn, args)))
                profile_run(apply_fn, args)
            del model, apply_fn
    return result


def phase_cvp_from_disk(device, work: Path):
    """8d: cli infer with configs/cvp_eval_dtu.yaml (data.align=32) over a
    synthetic DTU scan at 1600x1200 written under `work`, for CVP and AACVP,
    then cli fuse with the config's thresholds; 8e: the same config at
    align 16 raises before any launch. Returns (launches of each model's
    cli infer run, the scan's root)."""
    log(f"phase 8d: cli infer --config configs/cvp_eval_dtu.yaml "
        f"data.align=32 over a synthetic DTU scan of {CVP_SCAN_VIEWS} views "
        f"at 1600x1200 (cut to {CVP_W}x{CVP_H}), bf16, batch 1")
    cli = {}
    t0 = time.perf_counter()
    # DTU's 1600x1200; align 32 cuts the rows to CVP_H.
    root = generate(work / "dtu", num_scans=1, num_views=CVP_SCAN_VIEWS,
                    height=CVP_H + 16, width=CVP_W, num_depth=LADDER,
                    tilt=SCAN_TILT, train_layout=False)
    log(f"  written in {time.perf_counter() - t0:.2f} s")
    data = [f"data.eval_root={root}",
            f"data.eval_list={root / 'lists' / 'test.txt'}"]
    for name in CVP_NAMES:
        ckpt = work / f"{name}.pt"
        torch.save(build_model(cvp_config(name, torch.bfloat16),
                               torch.Generator().manual_seed(0)
                               ).state_dict(), ckpt)
        out = work / f"out_{name}"
        reset_counts()
        result = cli_infer.main([
            "--config", str(CVP_CONFIG), "--ckpt", str(ckpt), "--out",
            str(out), "--device", str(device), f"model.name={name}",
            "data.align=32", *data])
        torch.cuda.synchronize()
        counts = read_counts()
        want = cvp_want(name, torch.bfloat16, CVP_SCAN_VIEWS)
        log(f"  {name}: {result['maps']} maps in {result['seconds']:.4f} "
            f"s through the CLI: {result['maps'] / result['seconds']:.4f}"
            f" maps/s; launches {json.dumps(counts)}")
        if counts != want or result["maps"] != CVP_SCAN_VIEWS:
            fail(f"cli infer {name} launches {counts}, want {want}")
        check_files(out / "scan1", CVP_SCAN_VIEWS, CVP_H, CVP_W)
        cli[name] = counts
    ply = cli_fuse.main(["--config", str(CVP_CONFIG), "--out",
                         str(work / "out_cvp_mvsnet"), "--device",
                         str(device), f"data.eval_root={root}"])[0]
    log(f"  cli fuse (the config's thresholds) over the CVP maps: "
        + check_cloud(ply))

    log("phase 8e: the same config at data.align=16 (1600x1200: a "
        "75-row coarsest level)")
    reset_counts()
    try:
        cli_infer.main(["--config", str(CVP_CONFIG), "--ckpt",
                        str(work / "cvp_mvsnet.pt"), "--out",
                        str(work / "out_align16"), "--device",
                        str(device), *data])
    except ValueError as err:
        log(f"  raised ValueError: {err}")
        if "divisible by 2^5 = 32" not in str(err):
            fail("align 16 raised another error")
    else:
        fail("align 16 ran: the reference cannot")
    counts = read_counts()
    if any(counts.values()):
        fail(f"align 16 launched kernels before it raised: {counts}")
    log(f"  launches before the error {json.dumps(counts)}")
    return cli, root


def phase_cvp(device, work: Path):
    scene = make_plane_scene(num_views=VIEWS, height=CVP_H, width=CVP_W,
                             z0=10.0)
    group_rows, tf32_rows, cin64_rows = phase_cvp_kernels(scene, device)
    phase_cvp_vs_cpu(device)
    full = phase_cvp_full_width(scene, device)
    cli, root = phase_cvp_from_disk(device, work)
    return group_rows, tf32_rows, cin64_rows, full, cli, root


# Phase 9. MVSNet at its own widths (32 feature channels, regularizer base
# 8, the 192-hypothesis ladder, 5 views, batch 1), driven as
# tests/test_e2e_matrix.py drives it: configs/cas_eval_dtu.yaml with
# model.name=mvsnet data.max_h=1200 data.max_w=1600, DTU's 1600x1200 cut
# to 1600x1184 (align 32), 400x296 maps. Training:
# configs/cas_train_dtu.yaml with model.name=mvsnet data.num_views=3,
# 640x512, 3 views, bf16, batch 4 (the config trains at 8), Adam.
MVS_CONFIG = CVP_CONFIG.parent / "cas_eval_dtu.yaml"
MVS_TRAIN_CONFIG = CVP_CONFIG.parent / "cas_train_dtu.yaml"
MVS_H, MVS_W, MVS_C, MVS_TRAIN_VIEWS = 1184, 1600, 4 * BASE, 3
MVS_SIZE = ["data.max_h=1200", "data.max_w=1600"]
# (Cout, D, H, W) of MVSNet's one conv at Cin = 64: the U-Net's deepest
# block, at 1/8 of the D x H/4 x W/4 volume.
MVS_CIN64 = (64, LADDER // 8, MVS_H // 32, MVS_W // 32)
# Launches by kernel variant (warp, .vector, warp backward, conv3d, .mma,
# .tf32x3, .tf32x3_cin64) per map: one cost volume and the U-Net's 5
# stride-1 convs (4 blocks and the score conv; in f32 the Cin = 64 block on
# the 3xTF32 Cin = 64 kernel, the rest on the 3xTF32 one); per train step:
# the cost volume's forward and backward kernels, no conv3d (train-mode
# convs are cuDNN's).
MVS_LAUNCHES = {torch.bfloat16: (1, 1, 0, 5, 5, 0, 0),
                torch.float32: (1, 1, 0, 5, 0, 4, 1),
                "train": (1, 1, 1, 0, 0, 0, 0)}
MVS_SCORE_BIAS = ("UNetCostRegNet_0.FoldedConv_0.bias",)


def mvs_want(key, times=1) -> dict:
    warp, vec, grad, conv, mma, tf32, cin64 = MVS_LAUNCHES[key]
    return {"warp_variance": times * warp,
            "warp_variance.vector": times * vec,
            "warp_variance_grad": times * grad, "warp_variance_grad.depth": 0,
            "conv3d_affine": times * conv,
            "conv3d_affine.mma": times * mma,
            "conv3d_affine.tf32x3": times * tf32,
            "conv3d_affine.tf32x3_cin64": times * cin64, **NO_GROUP}


def mvs_config(dtype, *overrides, config=MVS_CONFIG):
    return load_config(str(config), [
        "model.name=mvsnet", f"model.compute_dtype={str(dtype)[6:]}",
        *overrides])


def phase_mvsnet_kernels(device):
    """9a: the warp forward at MVSNet's sweep and its backward at MVSNet's
    training shape (the latter on the default and DTU-like rigs), against
    their plain versions, bf16 timed; the U-Net's f32 conv at Cin = 64
    against its plain version on the 3xTF32 Cin = 64 kernel, timed."""
    h, w = MVS_H // 4, MVS_W // 4
    log(f"phase 9a: warp_variance at MVSNet's sweep (D={LADDER}, {w}x{h}, "
        f"C={MVS_C}, {VIEWS} views) and its backward at the training shape "
        f"(batch {TRAIN_BATCH}, {MVS_TRAIN_VIEWS - 1} sources, "
        f"{TRAIN_W // 4}x{TRAIN_H // 4}) on the default and DTU-like rigs")
    scene = make_plane_scene(num_views=VIEWS, height=MVS_H, width=MVS_W,
                             z0=10.0)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = warp_inputs(scene, 1, 4, MVS_C, LADDER, dtype, device,
                           height=MVS_H, width=MVS_W)
        vec = fused_variance_volume.vector_launches
        err = compare("warp", fused_variance_volume(*args),
                      fused_variance_volume_plain(*args),
                      f"warp_variance B=1 D={LADDER} {w}x{h} C={MVS_C} "
                      f"{str(dtype)[6:]}")
        if fused_variance_volume.vector_launches != vec + 1:
            fail("MVSNet's warp not on the 16-byte vector variant")
        if dtype is torch.bfloat16:
            ms = cuda_ms(lambda: fused_variance_volume(*args))
            plain_ms = cuda_ms(lambda: fused_variance_volume_plain(*args),
                               iters=3, warmup=1)
            by, ops = warp_bound(1, VIEWS - 1, LADDER, h, w, MVS_C, 2)
            log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{max(by, ops):.4f} ms (bytes {by:.4f}, ops {ops:.4f})")
            rows["warp"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                bytes_ms=by, ops_ms=ops)
        del args
    h, w = TRAIN_H // 4, TRAIN_W // 4
    row = {}
    for rig, scene in rig_scenes(MVS_TRAIN_VIEWS, TRAIN_H, TRAIN_W).items():
        for dtype in (torch.float32, torch.bfloat16):
            args = warp_inputs(scene, 1, 4, MVS_C, LADDER, dtype, device,
                               batch=TRAIN_BATCH, seed=4, height=TRAIN_H,
                               width=TRAIN_W)
            grad = torch.randn((TRAIN_BATCH, LADDER, h, w, MVS_C),
                               generator=torch.Generator().manual_seed(14)).to(
                                   device, dtype)
            timed = dtype is torch.bfloat16
            err, ms = rig_launch(
                fused_variance_volume_grad, fused_variance_volume_grad_plain,
                grad, args, False,
                f"warp backward {rig} rig B={TRAIN_BATCH} D={LADDER} {w}x{h} "
                f"C={MVS_C} {MVS_TRAIN_VIEWS - 1} sources {str(dtype)[6:]}",
                timed=timed)
            if timed and rig == "dtu":
                row.update(dtu_err=err, dtu_ms=ms)
            elif timed:
                plain_ms = cuda_ms(
                    lambda: fused_variance_volume_grad_plain(
                        grad, *args, depth_grad=False), iters=3, warmup=1)
                by, ops = warp_grad_bound(TRAIN_BATCH, MVS_TRAIN_VIEWS - 1,
                                          LADDER, h, w, MVS_C, 2)
                log(f"    plain {plain_ms:.4f} ms, bound {max(by, ops):.4f} "
                    f"ms (bytes {by:.4f}, ops {ops:.4f})")
                row.update(err=err, ms=ms, plain_ms=plain_ms, bytes_ms=by,
                           ops_ms=ops)
            del args, grad
    rows["warp_grad"] = row
    cout, d, h, w = MVS_CIN64
    err, args = check_conv(torch.Generator().manual_seed(31), device, 1, d, h,
                           w, 64, cout, True, torch.float32,
                           "MVSNet f32 conv3d ")
    rows["cin64"] = [time_conv(err, *args, True)]
    return rows


def phase_mvsnet_vs_cpu(device):
    """9b: a seeded MVSNet with RefineNet at 128x160 (D = 192), card
    (kernels) against CPU (plain versions): the pre-softmax scores, depth,
    refined depth and confidence, with phase 8b's limits (in bf16 at least
    the multiples of what one bf16 rounding of the images moves the CPU's
    own outputs)."""
    scene = make_plane_scene(num_views=VIEWS, height=128, width=160,
                             z0=10.0, tilt=(0.05, 0.02))
    unit = 4.0 / (LADDER - 1)
    for dtype in (torch.float32, torch.bfloat16):
        log(f"phase 9b: MVSNet with RefineNet 128x160, D={LADDER}, "
            f"{str(dtype)[6:]}, card vs CPU")
        model = MVSNet(BASE, refine=True, compute_dtype=dtype,
                       generator=torch.Generator().manual_seed(7))
        scores, refined = [], []
        hooks = [model.UNetCostRegNet_0.register_forward_hook(
                     lambda m, a, out: scores.append(out.float().cpu())),
                 model.register_forward_hook(
                     lambda m, a, out: refined.append(
                         out["refined_depth"].float().cpu()))]
        inputs = model_inputs(scene, 1, "cpu", "single")
        cpu = [t.float() for t in make_apply_fn(model, "cpu")(*inputs)]
        moved = None
        if dtype is torch.bfloat16:  # the yardstick of the bf16 limits
            sign = torch.from_numpy(np.random.default_rng(0).choice(
                [-1.0, 1.0], size=tuple(inputs[0].shape)).astype(np.float32))
            nudged = [t.float() for t in make_apply_fn(model, "cpu")(
                inputs[0] * (1 + sign * 2.0 ** -8), *inputs[1:])]
            moved = dict(score=(scores[1] - scores[0]).abs()
                         / (scores[0].max() - scores[0].min()),
                         depth=(nudged[0] - cpu[0]).abs(),
                         refined=(refined[1] - refined[0]).abs(),
                         conf=(nudged[1] - cpu[1]).abs())
            del scores[1:], refined[1:]
        card = [t.float().cpu() for t in make_apply_fn(model, device)(
            *model_inputs(scene, 1, device, "single"))]
        for h in hooks:
            h.remove()
        moved = moved or {}
        check_scores("MVSNet", scores[0], scores[1], dtype,
                     moved.get("score"))
        check_depth("MVSNet depth", cpu[0], card[0], unit, dtype,
                    moved.get("depth"))
        check_depth("MVSNet refined depth", refined[0], refined[1], unit,
                    dtype, moved.get("refined"))
        check_confidence("MVSNet", cpu[1], card[1], moved.get("conf"))


def phase_mvsnet_full_width(device) -> dict:
    """9c: full width through cli.infer.make_apply_fn, bf16 and f32: ms per
    map, peak memory, launches per kernel variant (exact), and in bf16 the
    device ms by layer kind and the profiler's idle share. Returns
    {dtype: (launches, ms, peak GiB)}."""
    log(f"phase 9c: MVSNet at full width {MVS_W}x{MVS_H}, {VIEWS} views, "
        f"{LADDER} hypotheses, maps {MVS_W // 4}x{MVS_H // 4}, batch 1")
    scene = make_plane_scene(num_views=VIEWS, height=MVS_H, width=MVS_W,
                             z0=10.0)
    args = model_inputs(scene, 1, device, "single")
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build_model(mvs_config(dtype, *MVS_SIZE),
                            torch.Generator().manual_seed(0))
        apply_fn = make_apply_fn(model, device)
        apply_fn(*args)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        depth, conf = apply_fn(*args)
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = map_ms(apply_fn, args)
        log(f"  {str(dtype)[6:]}: {ms:.2f} ms per depth map, peak "
            f"{peak:.3f} GiB allocated, launches {json.dumps(counts)}")
        if counts != mvs_want(dtype):
            fail(f"MVSNet launches {counts}, want {mvs_want(dtype)}")
        if depth.shape != (1, MVS_H // 4, MVS_W // 4) or \
                conf.shape != depth.shape:
            fail(f"output shapes {tuple(depth.shape)} {tuple(conf.shape)}")
        # Soft-argmin over the ladder: a convex combination of 8..12.
        if not (torch.isfinite(depth).all() and torch.isfinite(conf).all()
                and depth.min() >= 8.0 - 1e-3 and depth.max() <= 12.0 + 1e-3
                and ((conf >= 0) & (conf <= 1 + 1e-5)).all()):
            fail("MVSNet full-width outputs not finite or out of range")
        result[dtype] = (counts, ms, peak)
        if dtype is torch.bfloat16:
            log("  bf16 device ms by layer kind, one run: " + json.dumps(
                with_rest(*module_spans(
                    {"feature net": model.MVSNetFeatureNet_0,
                     "regularizer": model.UNetCostRegNet_0},
                    mvsnet_module, "fused_variance_volume",
                    lambda: apply_fn(*args)))))
            profile_run(apply_fn, args)
        del model, apply_fn
    return result


def phase_mvsnet_training(device):
    """9d: one f32 train step card against CPU (RefineNet, smooth-L1, 3
    views at 128x160, batch 2, D = 192; phase 7b's limits), then training
    at full width with the train config's model and task (launches per
    step exact)."""
    log(f"phase 9d: one MVSNet train step (RefineNet, smooth-L1), card vs "
        f"CPU, 128x160, {MVS_TRAIN_VIEWS} views, batch 2, D={LADDER}, f32, "
        f"Adam 1e-3")
    state = MVSNet(BASE, refine=True, generator=torch.Generator().manual_seed(
        7)).state_dict()
    check_train_step(
        lambda: MVSNetTask(MVSNet(BASE, refine=True)), state,
        collate_mvsnet(train_samples(128, 160, 2, views=MVS_TRAIN_VIEWS)),
        device, ("loss", "abs_depth_error"), MVS_SCORE_BIAS)
    log(f"phase 9d: MVSNet training at full width, {TRAIN_W}x{TRAIN_H}, "
        f"{MVS_TRAIN_VIEWS} views, {LADDER} hypotheses, bf16, batch "
        f"{TRAIN_BATCH}, Adam 1e-3 (configs/cas_train_dtu.yaml: smooth-L1, "
        f"no RefineNet)")
    cfg = mvs_config(torch.bfloat16, f"data.num_views={MVS_TRAIN_VIEWS}",
                     config=MVS_TRAIN_CONFIG)
    model = build_model(cfg, torch.Generator().manual_seed(0),
                        trained=False).to(device)
    task, collate = cli_train.build_task(cfg, model)
    batch = collate(train_samples(TRAIN_H, TRAIN_W, TRAIN_BATCH,
                                  views=MVS_TRAIN_VIEWS))
    return train_full_width(
        task, batch, mvs_want("train"), device,
        lambda run: with_rest(*module_spans(
            {"feature net": model.MVSNetFeatureNet_0,
             "regularizer": model.UNetCostRegNet_0},
            mvsnet_module, "fused_variance_volume", run)))


def phase_mvsnet_from_disk(device, root: Path, work: Path) -> dict:
    """9e: cli infer with configs/cas_eval_dtu.yaml model.name=mvsnet
    data.max_h=1200 data.max_w=1600 over phase 8d's scan (its batch of 6:
    one launch of each kernel), then cli fuse with the config's
    thresholds: a valid PLY. Returns the launches of the infer run."""
    log(f"phase 9e: cli infer --config configs/cas_eval_dtu.yaml "
        f"model.name=mvsnet data.max_h=1200 data.max_w=1600 over phase 8d's "
        f"scan ({CVP_SCAN_VIEWS} views at 1600x1200, cut to {MVS_W}x{MVS_H}),"
        f" bf16, batch 6; then cli fuse")
    ckpt = work / "mvsnet.pt"
    torch.save(build_model(mvs_config(torch.bfloat16),
                           torch.Generator().manual_seed(0)).state_dict(),
               ckpt)
    out = work / "out_mvsnet"
    reset_counts()
    result = cli_infer.main([
        "--config", str(MVS_CONFIG), "--ckpt", str(ckpt), "--out", str(out),
        "--device", str(device), "model.name=mvsnet", *MVS_SIZE,
        f"data.eval_root={root}",
        f"data.eval_list={root / 'lists' / 'test.txt'}"])
    torch.cuda.synchronize()
    counts = read_counts()
    batches = -(-CVP_SCAN_VIEWS // 6)
    log(f"  {result['maps']} maps in {result['seconds']:.4f} s through the "
        f"CLI: {result['maps'] / result['seconds']:.4f} maps/s; launches "
        f"{json.dumps(counts)} over {batches} batch")
    if counts != mvs_want(torch.bfloat16, batches) or \
            result["maps"] != CVP_SCAN_VIEWS:
        fail(f"cli infer mvsnet launches {counts}, want "
             f"{mvs_want(torch.bfloat16, batches)}")
    check_files(out / "scan1", CVP_SCAN_VIEWS, MVS_H // 4, MVS_W // 4)
    ply = cli_fuse.main(["--config", str(MVS_CONFIG), "--out", str(out),
                         "--device", str(device),
                         f"data.eval_root={root}"])[0]
    log(f"  cli fuse (the config's thresholds) over the MVSNet maps: "
        + check_cloud(ply))
    return counts


def phase_mvsnet_cli_train(device, work: Path) -> dict:
    """9f: cli train --config configs/cas_train_dtu.yaml model.name=mvsnet
    with RefineNet and the OHEM loss, one epoch on a synthetic training
    layout (images 640x512, depths 160x128, 2 steps at batch 2) with a val
    split and a checkpoint, launches exact; then cli infer from it."""
    log(f"phase 9f: cli train model.name=mvsnet model.refine=true "
        f"train.loss=ohem on a synthetic DTU training layout ({TRAIN_W}x"
        f"{TRAIN_H}), then cli infer from its checkpoint")
    root = generate(work / "dtu_train", num_scans=2, num_views=4,
                    height=TRAIN_H, width=TRAIN_W, num_depth=LADDER,
                    num_lights=1, tilt=SCAN_TILT)
    overrides = ["model.name=mvsnet", "model.refine=true",
                 f"data.num_views={MVS_TRAIN_VIEWS}", "data.batch_size=2"]
    reset_counts()
    result = cli_train.main([
        "--config", str(MVS_TRAIN_CONFIG), "--device", str(device),
        *overrides, "train.loss=ohem", f"data.root={root}",
        f"data.train_list={root}/lists/train.txt",
        f"data.val_list={root}/lists/val.txt", "train.epochs=1",
        "train.summary_every_steps=1", f"train.log_dir={work / 'run'}"])
    torch.cuda.synchronize()
    counts = read_counts()
    # 2 train steps, then 2 val batches in eval mode (bf16).
    train, val = mvs_want("train", 2), mvs_want(torch.bfloat16, 2)
    want = {k: train[k] + val[k] for k in train}
    log(f"  {result['step']} steps, losses "
        + " ".join(f"{x:.4f}" for x in result["losses"])
        + f", {result['step'] * 2 / result['seconds']:.3f} samples/s "
        f"through the CLI's steps; val {json.dumps(result['val'])}; "
        f"launches {json.dumps(counts)}")
    if counts != want:
        fail(f"cli train mvsnet launches {counts}, want {want}")
    if result["step"] != 2 or not np.isfinite(result["losses"]).all():
        fail("cli train mvsnet did not take 2 finite steps")
    (work / "val.txt").write_text("scan2\n")
    out = work / "out_mvsnet_train"
    res = cli_infer.main([
        "--ckpt", result["ckpt_dir"], "--out", str(out), "--device",
        str(device), *overrides, f"data.eval_root={root}",
        f"data.eval_list={work / 'val.txt'}", f"data.max_h={TRAIN_H}",
        f"data.max_w={TRAIN_W}"])
    check_files(out / "scan2", 4, TRAIN_H // 4, TRAIN_W // 4)
    log(f"  cli infer loaded step {res['step']}; {res['maps']} maps written")
    if res["step"] != 2:
        fail(f"cli infer loaded step {res['step']}")
    return counts


def phase_mvsnet(device, root: Path, work: Path) -> dict:
    rows = phase_mvsnet_kernels(device)
    phase_mvsnet_vs_cpu(device)
    full = phase_mvsnet_full_width(device)
    train_counts, train_ms, train_peak = phase_mvsnet_training(device)
    cli = phase_mvsnet_from_disk(device, root, work)
    cli_train_counts = phase_mvsnet_cli_train(device, work)
    (_, bf16_ms, bf16_peak), (_, f32_ms, f32_peak) = (
        full[torch.bfloat16], full[torch.float32])
    log(f"  MVSNet at {MVS_W}x{MVS_H}, D={LADDER}, {VIEWS} views: bf16 "
        f"{bf16_ms:.2f} ms per map (peak {bf16_peak:.3f} GiB), f32 "
        f"{f32_ms:.2f} ms (peak {f32_peak:.3f} GiB); training at "
        f"{TRAIN_W}x{TRAIN_H}, {MVS_TRAIN_VIEWS} views, batch {TRAIN_BATCH}, "
        f"bf16: {train_ms:.2f} ms per step (peak {train_peak:.3f} GiB)")
    return dict(rows=rows, full=full, train=train_counts, cli=cli,
                cli_train=cli_train_counts)


# Phase 10. CVP-MVSNet and AACVP-MVSNet training at the widths of
# configs/cvp_train_dtu.yaml: 2 levels, 48 coarse and 2 x 4 residual
# hypotheses at the fixed training interval, 16 feature channels,
# regularizer base 16, 3 views. Images 640x512 (the DTU training split's),
# bf16, batch 4 (the config trains at 16, in f32), Adam.
CVP_TRAIN_CONFIG = CVP_CONFIG.parent / "cvp_train_dtu.yaml"
CVP_TRAIN_VIEWS, CVP_TRAIN_LEVELS = 3, 2
CVP_TRAIN_SCORE_BIAS = ("PyramidCostRegNet_0.FoldedConv_0.bias",)
# The regularizer's stride-1 convs per level in eval mode (7 blocks, the
# stride-1 transposed block, the score conv); in f32, those with Cin in
# {4, 16, 32} on the 3xTF32 kernel, the 3 with Cin = 64 on its Cin = 64
# kernel.
CVP_CONVS_PER_LEVEL, CVP_TF32_CONVS_PER_LEVEL = 9, 6
CVP_CIN64_CONVS_PER_LEVEL = 3


def pyramid_want(name, steps=0, val_batches=0, levels=CVP_TRAIN_LEVELS):
    """Exact launches of `steps` train steps and `val_batches` f32
    eval-mode batches of a `levels`-level pyramid: per level and batch one
    cost volume (16-byte variant) and, in eval mode, the regularizer's
    convs on the conv3d kernel; per level and step one backward, with the
    hypotheses' gradient at every level but the coarsest (whose ladder has
    none); no conv3d in train mode (cuDNN's)."""
    cost, grad = ("warp_variance", "warp_variance_grad") if \
        name == "cvp_mvsnet" else ("group_correlation",
                                   "group_correlation_grad")
    want = dict.fromkeys(read_counts(), 0)
    want[cost] = want[cost + ".vector"] = levels * (steps + val_batches)
    want[grad] = levels * steps
    want[grad + ".depth"] = (levels - 1) * steps
    want["conv3d_affine"] = CVP_CONVS_PER_LEVEL * levels * val_batches
    want["conv3d_affine.tf32x3"] = (CVP_TF32_CONVS_PER_LEVEL * levels
                                    * val_batches)
    want["conv3d_affine.tf32x3_cin64"] = (CVP_CIN64_CONVS_PER_LEVEL * levels
                                          * val_batches)
    return want


def cvp_train_config(name, dtype, *overrides):
    return load_config(str(CVP_TRAIN_CONFIG), [
        f"model.name={name}", f"model.compute_dtype={str(dtype)[6:]}",
        *overrides])


def group_grad_bound(b, v, d, h, w, c, g, itemsize, depth=False):
    """Least time of the group correlation's backward: grad, ref, src and
    the hypotheses read once, dref and dsrc written once in the features'
    dtype (and ddepth in f32 with `depth`), as warp_grad_bound counts them;
    the least f32 work: per (pixel, view) the rotation (12), per (depth,
    pixel, view) the coordinates and corner weights (16), per (channel,
    view) the blend (7), the sum over views (1) and four weighted
    scatter-adds (8), per channel the cotangent q = grad * scale, q * ref
    and the dref term (4); with `depth`, DEPTH_GRAD_OPS."""
    per_view, per_channel = (16, 16) if not depth else (
        16 + DEPTH_GRAD_OPS[0], 16 + DEPTH_GRAD_OPS[1])
    nbytes = (b * d * h * w * g * itemsize
              + 2 * b * (1 + v) * h * w * c * itemsize
              + b * d * h * w * 4 * (2 if depth else 1) + b * v * 12 * 4)
    ops = (b * h * w * v * 12
           + b * d * h * w * (v * (per_view + per_channel * c) + 4 * c))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            ops / PEAK_FLOPS[torch.float32] * 1e3)


def integer_volume_inputs(dtype, device, c):
    """Cost-volume inputs whose every sample lands on integer coordinates:
    identity rotations, shifts of -4, 0 or 4 pixels, per-pixel depths 1, 2
    or 4 (so x + shift / depth is exact), among them x = W - 1, y = H - 1
    and x = -1; batch 2, 2 sources, D = 3, 24x40."""
    g = torch.Generator(device="cpu").manual_seed(3)
    b, v, d, h, w = 2, 2, 3, 24, 40
    feats = torch.randn((b, v + 1, h, w, c), generator=g).to(device, dtype)
    rel = torch.eye(4).repeat(b, v, 1, 1)
    rel[:, :, :2, 3] = 4.0 * torch.randint(-1, 2, (b, v, 2), generator=g)
    rel[0, 0, :2, 3] = torch.tensor([-4.0, 4.0])
    hyp = 2.0 ** torch.randint(0, 3, (b, d, h, w), generator=g).float()
    return (feats[:, 0].contiguous(), feats[:, 1:].contiguous(),
            rel.to(device), hyp.to(device))


# The most 8-channel f32 slots a backward block's dsrc window could hold:
# all of a block's 227 KB of shared memory, 32 bytes a slot.
MAX_WINDOW_SLOTS = 227 * 1024 // 32


def spill_volume_inputs(dtype, device, c=16):
    """Cost-volume inputs that need the backward kernels' spill branch:
    batch 2, 2 sources, D = 4 over 8..12, 160x128. Source 1 sees the
    reference at 10x its focal, the centre of the tile at columns 80-95
    and rows 56-63 on its own image centre, shifted along x by 40 /
    depth, so that this tile covers some 150x70 source pixels at one
    depth; source 2 has the reference camera 9.5 in front of it, so that
    the nearer depths lie behind it and the next ones near its pole."""
    g = torch.Generator(device="cpu").manual_seed(5)
    b, v, d, h, w = 2, 2, 4, 128, 160
    feats = torch.randn((b, v + 1, h, w, c), generator=g).to(device, dtype)
    rel = torch.eye(4).repeat(b, v, 1, 1)
    (cx, cy), (sx, sy) = (87.5, 59.5), ((w - 1) / 2, (h - 1) / 2)
    rel[:, 0, 0] = torch.tensor([10.0, 0.0, sx - 10.0 * cx, 40.0])
    rel[:, 0, 1] = torch.tensor([0.0, 10.0, sy - 10.0 * cy, 0.0])
    rel[:, 1, :3, 3] = torch.tensor([30.0, 0.0, -9.5])
    hyp = torch.linspace(8.0, 12.0, d)[None, :, None, None] + 0.1 * torch.rand(
        (b, d, h, w), generator=g)
    return (feats[:, 0].contiguous(), feats[:, 1:].contiguous(),
            rel.to(device), hyp.contiguous().to(device))


def largest_tile_box(rel, hyp, view):
    """The largest box of source cells (x0 and y0 extents + 2, multiplied)
    that one 16x8 tile's on-image samples at the first depth span in
    `view`; H and W multiples of 8 and 16."""
    b, _, h, w = hyp.shape
    xy = plane_sweep_coords(rel[:, view], hyp[:, :1], h, w)[:, 0].floor()
    on = ((xy[..., 0] >= -1) & (xy[..., 0] <= w - 1) & (xy[..., 1] >= -1)
          & (xy[..., 1] <= h - 1))[..., None]
    tiles = lambda t: t.reshape(b, h // 8, 8, w // 16, 16, 2)
    lo = tiles(torch.where(on, xy, float("inf"))).amin((2, 4))
    hi = tiles(torch.where(on, xy, -float("inf"))).amax((2, 4))
    ext = (hi - lo + 2).clamp(min=0).nan_to_num(0.0, 0.0, 0.0)
    return int((ext[..., 0] * ext[..., 1]).max())


def check_grad_kernel(fn, plain, grad, args, depth, what, groups=()):
    """The backward kernel `fn` (fused_variance_volume_grad or
    group_correlation_volume_grad; `groups` = (G,) for the latter) against
    autograd through its plain version: dref and dsrc (in the inputs'
    dtype) and, with `depth`, ddepth (f32), each within phase 2's limit for
    its own dtype. Checks that the kernel launched once, with the depth
    variant exactly when asked. Returns the largest error."""
    n, nd = fn.launches, fn.depth_launches
    got = fn(grad, *args, *groups, depth_grad=depth)
    if fn.launches != n + 1 or fn.depth_launches != nd + int(depth):
        fail(f"{what}: backward kernel not launched as asked")
    if (got[2] is not None) != depth:
        fail(f"{what}: ddepth returned {got[2] is not None}, asked {depth}")
    want = plain(grad, *args, *groups, depth_grad=depth)
    names = ("dref", "dsrc", "ddepth") if depth else ("dref", "dsrc")
    return max(compare("warp_grad", a, b, f"{what} {name}")
               for a, b, name in zip(got, want, names))


def phase_cvp_train_kernels(device, warp_grad_rows):
    """10a: the warp backward with and without the hypotheses' gradient
    and the group-correlation backward with and without it, against their
    plain versions at the training shapes (batch 4, 640x512 images, 2
    sources: level 1 D = 48 at 320x256, level 0 D = 8 at 640x512, C = 16,
    G = 4) in f32 and bf16, timed in bf16 (the group correlation also in
    f32, as AACVP feeds it); the main path's variants again on the
    DTU-like rig; a case that needs the kernels' spill branch; and awkward
    shapes. Returns the rows of one train step's launches: CVP's warp
    backward in bf16 (level 1 without, level 0 with the hypotheses'
    gradient) and AACVP's group correlation backward in f32, each with its
    DTU-like rig's time."""
    log(f"phase 10a: backward kernels at the CVP training shapes, batch "
        f"{TRAIN_BATCH}, {CVP_TRAIN_VIEWS - 1} sources, {TRAIN_W}x{TRAIN_H} "
        f"images, C={CVP_C}, G={CVP_GROUPS}, default and DTU-like rigs")
    scene = make_plane_scene(num_views=CVP_TRAIN_VIEWS, height=TRAIN_H,
                             width=TRAIN_W, z0=10.0)
    rows = {"warp": [], "group": []}
    kernels = (("warp", fused_variance_volume_grad,
                fused_variance_volume_grad_plain, (), warp_grad_bound),
               ("group", group_correlation_volume_grad,
                group_correlation_volume_grad_plain, (CVP_GROUPS,),
                group_grad_bound))
    for level, d in ((1, CVP_COARSE_D), (0, CVP_FINE_D)):
        h, w = TRAIN_H >> level, TRAIN_W >> level
        main_depth = level < CVP_TRAIN_LEVELS - 1  # as the model asks
        for dtype in (torch.float32, torch.bfloat16):
            args = cvp_volume_inputs(scene, level, d, dtype, device,
                                     batch=TRAIN_BATCH, seed=20 + level,
                                     height=TRAIN_H, width=TRAIN_W,
                                     levels=CVP_TRAIN_LEVELS)
            itemsize = torch.tensor([], dtype=dtype).element_size()
            sweeps, corners = sweep_stats(args[2], args[3])
            log(f"  level{level} default rig {str(dtype)[6:]}: sweep per "
                f"source " + " / ".join(f"{x:.2f}" for x in sweeps) + " px")
            for kind, fn, plain, groups, bound in kernels:
                last = CVP_C if kind == "warp" else CVP_GROUPS
                grad = torch.randn(
                    (TRAIN_BATCH, d, h, w, last),
                    generator=torch.Generator().manual_seed(30 + level)).to(
                        device, dtype)
                errs = {}
                for depth in (False, True):
                    what = (f"{fn.__name__} level{level} B={TRAIN_BATCH} "
                            f"D={d} {w}x{h} C={CVP_C} {str(dtype)[6:]} "
                            f"depth={depth}")
                    errs[depth] = check_grad_kernel(fn, plain, grad, args,
                                                    depth, what, groups)
                timed = dtype is torch.bfloat16 or kind == "group"
                if not timed:
                    continue
                ms = {depth: cuda_ms(lambda: fn(grad, *args, *groups,
                                                depth_grad=depth))
                      for depth in (False, True)}
                plain_ms = cuda_ms(lambda: plain(grad, *args, *groups,
                                                 depth_grad=main_depth),
                                   iters=3, warmup=1)
                by, ops = bound(TRAIN_BATCH, CVP_TRAIN_VIEWS - 1, d, h, w,
                                CVP_C, *groups, itemsize, depth=main_depth)
                log(f"    {kind} backward {str(dtype)[6:]}: kernel "
                    f"{ms[False]:.4f} ms, with ddepth {ms[True]:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, bound of the main path's "
                    f"variant (ddepth {main_depth}) {max(by, ops):.4f} ms "
                    f"(bytes {by:.4f}, ops {ops:.4f}); "
                    f"{corners * CVP_C / ms[main_depth] / 1e6:.1f} G "
                    f"corner-channel adds of dsrc per s")
                main_type = torch.bfloat16 if kind == "warp" else \
                    torch.float32
                if dtype is main_type:
                    rows[kind].append(dict(
                        err=errs[main_depth], ms=ms[main_depth],
                        plain_ms=plain_ms, bytes_ms=by, ops_ms=ops))
            del args
    # The same launches on the DTU-like rig, the main path's variants.
    scene = rig_scenes(CVP_TRAIN_VIEWS, TRAIN_H, TRAIN_W)["dtu"]
    for i, (level, d) in enumerate(((1, CVP_COARSE_D), (0, CVP_FINE_D))):
        h, w = TRAIN_H >> level, TRAIN_W >> level
        main_depth = level < CVP_TRAIN_LEVELS - 1
        for dtype in (torch.float32, torch.bfloat16):
            args = cvp_volume_inputs(scene, level, d, dtype, device,
                                     batch=TRAIN_BATCH, seed=20 + level,
                                     height=TRAIN_H, width=TRAIN_W,
                                     levels=CVP_TRAIN_LEVELS)
            for kind, fn, plain, groups, _ in kernels:
                last = CVP_C if kind == "warp" else CVP_GROUPS
                grad = torch.randn(
                    (TRAIN_BATCH, d, h, w, last),
                    generator=torch.Generator().manual_seed(30 + level)).to(
                        device, dtype)
                timed = dtype is (torch.bfloat16 if kind == "warp" else
                                  torch.float32)
                err, ms = rig_launch(
                    fn, plain, grad, args, main_depth,
                    f"{fn.__name__} dtu rig level{level} B={TRAIN_BATCH} "
                    f"D={d} {w}x{h} C={CVP_C} {str(dtype)[6:]} "
                    f"depth={main_depth}", groups, timed=timed)
                if timed:
                    rows[kind][i].update(dtu_err=err, dtu_ms=ms)
            del args
    # The spill branch: a source at 10x the reference's focal (one depth's
    # tile spans more source pixels than any window holds) and one that
    # puts the nearer depths behind it; both kernels, with and without
    # ddepth.
    for dtype in (torch.float32, torch.bfloat16):
        args = spill_volume_inputs(dtype, device)
        box = largest_tile_box(args[2], args[3], 0)
        log(f"  spill case {str(dtype)[6:]}: one depth's 16x8 tile spans up "
            f"to {box} source cells of the zoomed source (a window holds at "
            f"most {MAX_WINDOW_SLOTS})")
        if box <= MAX_WINDOW_SLOTS:
            fail(f"spill case: a tile spans {box} cells, which a window "
                 f"could hold")
        b, dd, h, w = args[3].shape
        for kind, fn, plain, groups, _ in kernels:
            last = CVP_C if kind == "warp" else CVP_GROUPS
            g = torch.randn((b, dd, h, w, last),
                            generator=torch.Generator().manual_seed(50)).to(
                                device, dtype)
            for depth in (False, True):
                check_grad_kernel(fn, plain, g, args, depth,
                                  f"{kind} backward spill case "
                                  f"{str(dtype)[6:]} depth={depth}", groups)
    # Awkward: batch 2, 3 sources, C = 12 and 20 (scalar variant), C = 24
    # (16-byte variant), off-image and behind-camera samples, D = 1 and 2,
    # and samples on integer coordinates.
    for dtype in (torch.float32, torch.bfloat16):
        t = str(dtype)[6:]
        for c, groups in ((12, 3), (20, 4), (24, 4)):
            args = ragged_volume_inputs(dtype, device, c=c)
            one = (*args[:3], args[3][:, 3:4].contiguous())
            two = (*args[:3], args[3][:, 3:5].contiguous())
            for case, a in (("off-image/behind-camera", args), ("D=1", one),
                            ("D=2", two)):
                b, dd, h, w = a[3].shape
                for kind, fn, plain, _, _ in kernels:
                    last = c if kind == "warp" else groups
                    g = torch.randn((b, dd, h, w, last),
                                    generator=torch.Generator().manual_seed(
                                        c)).to(device, dtype)
                    check_grad_kernel(
                        fn, plain, g, a, True,
                        f"{kind} backward {case} C={c} {t}",
                        (groups,) if kind == "group" else ())
        for c in (16, 12):
            args = integer_volume_inputs(dtype, device, c)
            b, dd, h, w = args[3].shape
            for kind, fn, plain, _, _ in kernels:
                last = c if kind == "warp" else 4
                g = torch.randn((b, dd, h, w, last),
                                generator=torch.Generator().manual_seed(
                                    40 + c)).to(device, dtype)
                check_grad_kernel(
                    fn, plain, g, args, True,
                    f"{kind} backward integer coordinates C={c} {t}",
                    (4,) if kind == "group" else ())
    warp, group = rows["warp"], rows["group"]
    log(f"  one CVP train step's warp backward (bf16, 1 of 2 launches with "
        f"ddepth): {sum(r['ms'] for r in warp):.4f} ms (DTU-like rig "
        f"{sum(r['dtu_ms'] for r in warp):.4f}), bound "
        f"{sum(max(r['bytes_ms'], r['ops_ms']) for r in warp):.4f}; one "
        f"AACVP step's group-correlation backward (f32): "
        f"{sum(r['ms'] for r in group):.4f} ms (DTU-like rig "
        f"{sum(r['dtu_ms'] for r in group):.4f}), bound "
        f"{sum(max(r['bytes_ms'], r['ops_ms']) for r in group):.4f}; the "
        f"warp backward without ddepth at phase 7a's shapes (this run): "
        f"{sum(r['ms'] for r in warp_grad_rows):.4f} ms per CasMVSNet step "
        f"(DTU-like rig {sum(r['dtu_ms'] for r in warp_grad_rows):.4f})")
    return rows


def phase_cvp_train_vs_cpu(device):
    """10b: one f32 train step card against CPU for each family, 2 levels
    at 128x160, 3 views, batch 2, phase 7b's limits; each BatchNorm counts
    one update per level."""
    batch = collate_pyramid(train_samples(128, 160, 2,
                                          views=CVP_TRAIN_VIEWS))
    for name in CVP_NAMES:
        log(f"phase 10b: one {name} train step, card vs CPU, 128x160, "
            f"{CVP_TRAIN_LEVELS} levels, {CVP_TRAIN_VIEWS} views, batch 2, "
            f"f32, Adam 1e-3")
        cfg = cvp_train_config(name, torch.float32)
        state = build_model(cfg, torch.Generator().manual_seed(7)
                            ).state_dict()
        check_train_step(lambda: PyramidTask(build_model(cfg)), state, batch,
                         device, ("loss", "abs_depth_error"),
                         CVP_TRAIN_SCORE_BIAS, updates=CVP_TRAIN_LEVELS)


def phase_cvp_train_full_width(device) -> dict:
    """10c: each family trained at 640x512, 3 views, bf16, batch 4 through
    cli.train.build_task (train_full_width: exact launches per step, ms
    per step, samples/s, peak memory, device ms by layer and kernel
    family, 20 falling losses). Returns {name: (launches, ms, peak)}."""
    out = {}
    for name in CVP_NAMES:
        # Each family starts from an empty allocator cache, as in a process
        # of its own: AACVP's step peaks near the card's 80 GB.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 10c: {name} training at {TRAIN_W}x{TRAIN_H}, "
            f"{CVP_TRAIN_VIEWS} views, {CVP_TRAIN_LEVELS} levels, "
            f"{CVP_COARSE_D} + 2 x 4 hypotheses, bf16, batch {TRAIN_BATCH}, "
            f"Adam 1e-3 (configs/cvp_train_dtu.yaml: batch 16, f32)")
        cfg = cvp_train_config(name, torch.bfloat16)
        model = build_model(cfg, torch.Generator().manual_seed(0),
                            trained=False).to(device)
        task, collate = cli_train.build_task(cfg, model)
        batch = collate(train_samples(TRAIN_H, TRAIN_W, TRAIN_BATCH,
                                      views=CVP_TRAIN_VIEWS))
        out[name] = train_full_width(
            task, batch, pyramid_want(name, steps=1), device,
            lambda run: cvp_breakdown(model, run, ()))
        del model, task
    return out


def phase_cvp_cli_train(device, work: Path) -> dict:
    """10d: cli train --config configs/cvp_train_dtu.yaml for each family
    on a synthetic DTU training layout (images 640x512, depths 160x128; 2
    steps at batch 2, a val split, a checkpoint), launches exact; then cli
    infer --config configs/cvp_eval_dtu.yaml data.align=32 --step latest
    from its checkpoint; both without --device, so on the first card.
    Returns {name: launches of the train run}."""
    log(f"phase 10d: cli train --config configs/cvp_train_dtu.yaml on a "
        f"synthetic DTU training layout ({TRAIN_W}x{TRAIN_H}), then cli "
        f"infer --config configs/cvp_eval_dtu.yaml --step latest")
    root = generate(work / "dtu_cvp_train", num_scans=2, num_views=4,
                    height=TRAIN_H, width=TRAIN_W, num_depth=LADDER,
                    num_lights=1, tilt=SCAN_TILT)
    (work / "val_cvp.txt").write_text("scan2\n")
    out = {}
    for name in CVP_NAMES:
        reset_counts()
        # No --device: the CLIs run on the card by default.
        result = cli_train.main([
            "--config", str(CVP_TRAIN_CONFIG),
            f"model.name={name}", "data.batch_size=2", f"data.root={root}",
            f"data.train_list={root}/lists/train.txt",
            f"data.val_list={root}/lists/val.txt", "train.epochs=1",
            "train.summary_every_steps=1",
            f"train.log_dir={work / ('run_' + name)}"])
        torch.cuda.synchronize()
        counts = read_counts()
        # 2 train steps, then 2 val batches in eval mode (the config's f32).
        want = pyramid_want(name, steps=2, val_batches=2)
        log(f"  {name}: {result['step']} steps, losses "
            + " ".join(f"{x:.4f}" for x in result["losses"])
            + f", {result['step'] * 2 / result['seconds']:.3f} samples/s "
            f"through the CLI's steps; val {json.dumps(result['val'])}; "
            f"launches {json.dumps(counts)}")
        if counts != want:
            fail(f"cli train {name} launches {counts}, want {want}")
        if result["step"] != 2 or not np.isfinite(result["losses"]).all():
            fail(f"cli train {name} did not take 2 finite steps")
        dest = work / f"out_{name}_train"
        reset_counts()
        res = cli_infer.main([
            "--config", str(CVP_CONFIG), "--ckpt", result["ckpt_dir"],
            "--step", "latest", "--out", str(dest), f"model.name={name}",
            "data.align=32", f"data.eval_root={root}",
            f"data.eval_list={work / 'val_cvp.txt'}", "data.num_views=3",
            f"data.max_h={TRAIN_H}", f"data.max_w={TRAIN_W}"])
        torch.cuda.synchronize()
        infer_counts = read_counts()
        check_files(dest / "scan2", 4, TRAIN_H, TRAIN_W)
        log(f"  cli infer loaded step {res['step']}; {res['maps']} maps "
            f"written; launches {json.dumps(infer_counts)}")
        if res["step"] != 2 or infer_counts != cvp_want(name, torch.bfloat16,
                                                        res["maps"]):
            fail(f"cli infer {name} from the checkpoint: step {res['step']},"
                 f" launches {infer_counts}")
        out[name] = counts
    return out


def phase_cvp_training(device, work: Path, warp_grad_rows) -> dict:
    rows = phase_cvp_train_kernels(device, warp_grad_rows)
    phase_cvp_train_vs_cpu(device)
    full = phase_cvp_train_full_width(device)
    cli = phase_cvp_cli_train(device, work)
    for name, (_, ms, peak) in full.items():
        log(f"  {name} training at {TRAIN_W}x{TRAIN_H}, {CVP_TRAIN_VIEWS} "
            f"views, batch {TRAIN_BATCH}, bf16: {ms:.2f} ms per step "
            f"({TRAIN_BATCH * 1e3 / ms:.3f} samples/s), peak {peak:.3f} GiB")
    return dict(rows=rows, train={k: v[0] for k, v in full.items()}, cli=cli)


# ---- Measurements for chip_ab.py ----
# Each takes the device and returns {label: ms}. chip_ab.py also runs them
# on another checkout's mvs_tpu_torch (this file, that package), so they
# call only entry points that package has, and no counters.


# Phase 11. Point-MVSNet at its default widths (image base 8, volume base
# 8, flow channels 64/64/16/1, k = 16, flow scales 1/4 and 1/2, interval
# factors 0.75 and 0.375), f32 (mvs_tpu's Point-MVSNet has no other
# dtype), driven as dtu_wde3.yaml evaluates it: configs/cas_eval_dtu.yaml
# with model.name=point_mvsnet, 1280x960 images (data.max_h=960
# data.max_w=1280, align 32), 96 coarse hypotheses over the DTU ladder
# (data.num_depth=96 data.interval_scale=2.12), 5 views, batch 1, the flow
# tiled at stride 4 (the reference's test-time sub-grids) and untiled.
# Training: configs/cas_train_dtu.yaml with model.name=point_mvsnet, 640x512,
# 3 views, 48 coarse hypotheses (the config default), f32, Adam.
POINT_H, POINT_W, POINT_D, POINT_VIEWS = 960, 1280, 96, 5
# (Cout, D, H, W) of VolumeConv's two convs at Cin = 64 (64->8 at 1/8 of
# the coarse volume's H and W, 64->64 at 1/8 of that).
POINT_CIN64 = ((8, POINT_D, POINT_H // 8, POINT_W // 8),
               (64, POINT_D // 8, POINT_H // 64, POINT_W // 64))
POINT_INTERVAL = 4.0 / (POINT_D - 1)  # the plane scenes' ladder, 8..12
POINT_EVAL = ["model.name=point_mvsnet", "model.compute_dtype=float32",
              f"model.num_depth_coarse={POINT_D}", f"data.num_depth={POINT_D}",
              "data.interval_scale=2.12", "data.max_h=960", "data.max_w=1280"]
POINT_TRAIN = ["model.name=point_mvsnet", "model.compute_dtype=float32",
               "data.num_views=3"]
POINT_TRAIN_D, POINT_TRAIN_VIEWS = 48, 3
# The other families' training batch: a step at 640x512 takes 63.5 GiB of
# the card's 80 GB (PERF.md; the EdgeConvs' (5 * 320 * 256 points, 16
# neighbours, 32-64 features) differences at the 1/2-resolution flow, saved
# twice each for the backward, most of it).
POINT_TRAIN_BATCH = 4
# The flow's levels (ImageConv's conv1-conv3 channels) and scales.
POINT_FLOW = ((0.25, 0.75), (0.5, 0.375))
POINT_LEVELS = (16, 32, 64)
# Launches per map: 1 coarse volume and 3 per flow iteration (vector, C =
# 16 / 32 / 64); VolumeConv's 5 stride-1 convs, f32: 3 on the 3xTF32
# kernel (16->16, 32->32, 8->1), 2 on its Cin = 64 kernel (64->8, 64->64),
# none direct. Per train step: the 7 volumes forward and backward, the 6 of
# the flow with the hypotheses' gradient (the flow's depth keeps its
# gradient in train mode), no conv3d (train-mode convs are cuDNN's).
POINT_LAUNCHES = {"map": (7, 7, 0, 0, 5, 0, 3, 2),
                  "train": (7, 7, 7, 6, 0, 0, 0, 0)}


def point_want(key, times=1) -> dict:
    warp, vec, grad, depth, conv, mma, tf32, cin64 = POINT_LAUNCHES[key]
    return {"warp_variance": times * warp,
            "warp_variance.vector": times * vec,
            "warp_variance_grad": times * grad,
            "warp_variance_grad.depth": times * depth,
            "conv3d_affine": times * conv, "conv3d_affine.mma": times * mma,
            "conv3d_affine.tf32x3": times * tf32,
            "conv3d_affine.tf32x3_cin64": times * cin64, **NO_GROUP}


def point_rigs() -> list:
    """The plane scenes of phase 11 (make_plane_scene's arguments) and the
    depths a flow iteration can reach on each: the ladder widened by 2.25
    intervals (the flows' 2 x 0.75 + 2 x 0.375). tests/test_torch_point_ops.py
    checks that all lie in front of every source camera, clear of the
    kernel route's behind-camera delta."""
    def widened(lo, hi, interval):
        return (lo - 2.25 * interval, hi + 2.25 * interval)

    scan_iv = 5.6 / (LADDER - 1) * 2.12  # generate's ladder, 11d's scale
    train_iv = 5.6 / (LADDER - 1) * 4.24  # 11f: 48 hypotheses over it
    return [
        dict(scene=dict(num_views=POINT_VIEWS, height=POINT_H, width=POINT_W,
                        z0=10.0), depths=widened(8.0, 12.0, POINT_INTERVAL)),
        dict(scene=dict(num_views=3, height=128, width=160, z0=10.0,
                        tilt=(0.05, 0.02)), depths=widened(8.0, 12.0, 4 / 15)),
        dict(scene=dict(num_views=POINT_TRAIN_VIEWS, height=128, width=160,
                        z0=10.0, seed=1, tilt=(0.05, 0.02)),
             depths=widened(6.0, 10.0, 4 / 15)),
        dict(scene=dict(num_views=CVP_SCAN_VIEWS, height=CVP_H + 16,
                        width=CVP_W, z0=10.0, seed=0, tilt=SCAN_TILT),
             depths=widened(7.2, 7.2 + (POINT_D - 1) * scan_iv, scan_iv))] + [
        dict(scene=dict(num_views=POINT_TRAIN_VIEWS, height=TRAIN_H,
                        width=TRAIN_W, z0=10.0, seed=i, tilt=(0.05, 0.02)),
             depths=widened(8.0, 12.0, 4 / (POINT_TRAIN_D - 1)))
        for i in range(POINT_TRAIN_BATCH)] + [
        dict(scene=dict(num_views=4, height=TRAIN_H, width=TRAIN_W, z0=10.0,
                        seed=i, tilt=SCAN_TILT),
             depths=widened(7.2, 7.2 + (POINT_TRAIN_D - 1) * train_iv,
                            train_iv))
        for i in range(2)]


def point_inputs(scene, device, batch=1, interval=POINT_INTERVAL):
    sample = dict(imgs=scene.images, intrinsics=scene.intrinsics,
                  extrinsics=scene.extrinsics, depth_min=np.float32(8.0),
                  depth_interval=np.float32(interval))
    return stack_model_inputs([sample] * batch, device, "point")


def point_volume_inputs(scene, scale, c, dtype, device, batch=1, seed=0,
                        depths=None, inter=None):
    """The warp's inputs as Point-MVSNet gives them at `scale` of the
    scene's images: C-channel features, the 0.5-centred projections, and
    either the coarse ladder of `depths` hypotheses over 8..12 or (inter:
    a flow iteration's interval factor) 5 per-pixel hypotheses at
    {-2..2} x inter x the ladder's interval around the scene's depth with
    noise."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    views, height, width = scene.images.shape[:3]
    h, w = int(height * scale), int(width * scale)
    feats = torch.randn((batch, views, h, w, c), generator=g).to(device, dtype)
    intr = torch.tensor(scene.intrinsics)[None].repeat(batch, 1, 1, 1)
    extr = torch.tensor(scene.extrinsics)[None].repeat(batch, 1, 1, 1)
    rel = point_sweep_projections(intr, extr, scale).to(device)
    if inter is None:
        hyp = torch.linspace(8.0, 12.0, depths)[:, None, None].expand(
            depths, h, w)
    else:
        step = round(1 / scale)
        depth = torch.tensor(scene.depths[0][step // 2::step, step // 2::step])
        noise = torch.randn((h, w), generator=g) * 0.05
        hyp = depth + noise + torch.arange(-2.0, 3.0)[:, None, None] * (
            inter * 4.0 / (depths - 1))
    hyp = hyp[None].expand(batch, -1, h, w).contiguous().to(device)
    return (feats[:, 0].contiguous(), feats[:, 1:].contiguous(), rel, hyp)


def point_warp_rows(scene, device, depths, what):
    """The 7 forward launches of one map (coarse, then the flow's 6) at
    `scene`'s size against the plain version in f32 and bf16, each on the
    16-byte variant, f32 timed (kernel, plain, bound)."""
    shapes = [(1 / 8, 64, None)] + [(scale, c, inter)
                                     for scale, inter in POINT_FLOW
                                     for c in POINT_LEVELS]
    rows = []
    for scale, c, inter in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = point_volume_inputs(scene, scale, c, dtype, device,
                                       depths=depths, inter=inter)
            b, d, h, w = args[3].shape
            vec = fused_variance_volume.vector_launches
            err = compare("warp", fused_variance_volume(*args),
                          fused_variance_volume_plain(*args),
                          f"{what} warp_variance D={d} {w}x{h} C={c} "
                          f"{str(dtype)[6:]}")
            if fused_variance_volume.vector_launches != vec + 1:
                fail(f"{what} warp not on the 16-byte vector variant")
            if dtype is torch.float32:
                ms = cuda_ms(lambda: fused_variance_volume(*args))
                plain_ms = cuda_ms(
                    lambda: fused_variance_volume_plain(*args), iters=3,
                    warmup=1)
                by, ops = warp_bound(b, args[1].shape[1], d, h, w, c, 4)
                log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{max(by, ops):.4f} ms (bytes {by:.4f}, ops {ops:.4f})")
                rows.append(dict(err=err, ms=ms, plain_ms=plain_ms,
                                 bytes_ms=by, ops_ms=ops))
            del args
    return rows


def phase_point_kernels(device):
    """11a: the warp forward at a map's 7 shapes, its backward at a train
    step's 7 (the flow's with and without the hypotheses' gradient), the
    two f32 convs at Cin = 64; each against its plain version, timed (the
    backward over the step's launches as the path makes them). Returns
    {"warp", "warp_grad", "cin64"} rows."""
    log(f"phase 11a: Point-MVSNet's kernels: the warp forward at a "
        f"{POINT_W}x{POINT_H} map's 7 volumes ({POINT_VIEWS} views, D = "
        f"{POINT_D} coarse, 5 per pixel in the flow)")
    scene = make_plane_scene(num_views=POINT_VIEWS, height=POINT_H,
                             width=POINT_W, z0=10.0)
    rows = {"warp": point_warp_rows(scene, device, POINT_D, "map")}
    del scene
    log(f"  the warp backward at a train step's 7 volumes, batch "
        f"{POINT_TRAIN_BATCH}, {POINT_TRAIN_VIEWS - 1} sources, "
        f"{TRAIN_W}x{TRAIN_H} images, D = {POINT_TRAIN_D} coarse")
    scene = make_plane_scene(num_views=POINT_TRAIN_VIEWS, height=TRAIN_H,
                             width=TRAIN_W, z0=10.0, tilt=(0.05, 0.02))
    shapes = [(1 / 8, 64, None)] + [(scale, c, inter)
                                     for scale, inter in POINT_FLOW
                                     for c in POINT_LEVELS]
    grad_rows = []
    for i, (scale, c, inter) in enumerate(shapes):
        args = point_volume_inputs(scene, scale, c, torch.float32, device,
                                   batch=POINT_TRAIN_BATCH, seed=i,
                                   depths=POINT_TRAIN_D, inter=inter)
        b, d, h, w = args[3].shape
        grad = torch.randn((b, d, h, w, c), generator=torch.Generator(
            ).manual_seed(20 + i)).to(device)
        path_depth = inter is not None  # the flow's hypotheses need one
        for depth in (False, True) if path_depth else (False,):
            err = check_grad_kernel(
                fused_variance_volume_grad, fused_variance_volume_grad_plain,
                grad, args, depth,
                f"warp backward B={b} D={d} {w}x{h} C={c} ddepth={depth}")
        ms = cuda_ms(lambda: fused_variance_volume_grad(
            grad, *args, depth_grad=path_depth))
        plain_ms = cuda_ms(lambda: fused_variance_volume_grad_plain(
            grad, *args, depth_grad=path_depth), iters=3, warmup=1)
        by, ops = warp_grad_bound(b, args[1].shape[1], d, h, w, c, 4,
                                  depth=path_depth)
        log(f"    as the path runs it (ddepth={path_depth}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {max(by, ops):.4f}"
            f" ms (bytes {by:.4f}, ops {ops:.4f})")
        grad_rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, bytes_ms=by,
                              ops_ms=ops))
        del args, grad
    rows["warp_grad"] = grad_rows
    log(f"  one train step's 7 backward launches: kernel "
        f"{sum(r['ms'] for r in grad_rows):.4f} ms, plain "
        f"{sum(r['plain_ms'] for r in grad_rows):.4f} ms, bound "
        f"{sum(max(r['bytes_ms'], r['ops_ms']) for r in grad_rows):.4f} ms")
    log("  VolumeConv's two f32 convs at Cin = 64 (3xTF32 Cin = 64 kernel) "
        "at the map's shapes")
    g = torch.Generator(device="cpu").manual_seed(11)
    cin64 = []
    for cout, d, h, w in POINT_CIN64:
        err, args = check_conv(g, device, 1, d, h, w, 64, cout, True,
                               torch.float32, "Point-MVSNet ")
        cin64.append(time_conv(err, *args, True))
        del args
    log_sum("VolumeConv's two f32 convs at Cin = 64", cin64)
    rows["cin64"] = cin64
    return rows


class GraphTape:
    """The kNN graphs of one Point-MVSNet run, replayed in another.

    On the regular hypothesis lattice some points have neighbours at
    nearly equal distances, so an f32 rounding of the lattice (the card's
    sums against the CPU's) can swap the 16th and 17th nearest, and three
    EdgeConvs carry such a swap three hops along the graph. A card run
    therefore takes the CPU run's graphs, after checking that its own
    lattice lies within 1e-4 of the CPU's and that the card's lattice_knn
    gives on it exactly what the CPU's gives on the same values; the share
    of points whose neighbour sets the two graphs agree on is logged."""

    def __init__(self):
        self.graphs, self.shares = [], []

    @contextlib.contextmanager
    def record(self):
        def recording(xyz, kernel_size, k):
            idx = lattice_knn(xyz, kernel_size=kernel_size, k=k)
            self.graphs.append((xyz.detach().cpu(), idx.cpu()))
            return idx

        with self._patched(recording):
            yield self

    @contextlib.contextmanager
    def replay(self):
        calls = iter(self.graphs)

        def replaying(xyz, kernel_size, k):
            want_xyz, want = next(calls)
            own = lattice_knn(xyz, kernel_size=kernel_size, k=k)
            got_xyz = xyz.detach().cpu()
            err = (got_xyz - want_xyz).abs().max().item()
            if err > 1e-4:
                fail(f"kNN lattice differs from the recorded one by {err}")
            if not torch.equal(own.cpu(), lattice_knn(got_xyz, kernel_size,
                                                      k)):
                fail("lattice_knn differs on the card from the CPU's on the "
                     "same lattice")
            self.shares.append((own.cpu().sort(-1).values
                                == want.sort(-1).values).all(-1)
                               .float().mean().item())
            return want.to(own.device)

        self.shares = []
        with self._patched(replaying):
            yield self

    @staticmethod
    @contextlib.contextmanager
    def _patched(fn):
        saved = point_module.lattice_knn
        point_module.lattice_knn = fn
        try:
            yield
        finally:
            point_module.lattice_knn = saved


def phase_point_vs_cpu(device):
    """11b: a seeded Point-MVSNet at 128x160, 3 views, 16 coarse
    hypotheses, f32, card (kernels) against CPU (plain versions), untiled
    and at flow_sub_stride=2, the card on the CPU's kNN graphs
    (GraphTape): the coarse pre-softmax score, coarse depth and
    probability map, flow1, flow2 (= depth) and both flows'
    probabilities."""
    scene = make_plane_scene(num_views=3, height=128, width=160, z0=10.0,
                             tilt=(0.05, 0.02))
    unit = 4.0 / 15
    model = PointMVSNet(num_depth=16,
                        generator=torch.Generator().manual_seed(7))
    scores = []
    hook = model.coarse_vol_conv.register_forward_hook(
        lambda m, a, out: scores.append(out.float().cpu()))
    for stride in (1, 2):
        log(f"phase 11b: Point-MVSNet 128x160, 3 views, D=16, f32, "
            f"flow_sub_stride={stride}, card vs CPU")
        model.flow_sub_stride = stride
        tape = GraphTape()
        with tape.record():
            cpu = point_outputs(model, point_inputs(scene, "cpu",
                                                    interval=unit), "cpu")
        with tape.replay():
            card = point_outputs(model, point_inputs(scene, device,
                                                     interval=unit), device)
        log(f"  kNN graphs: {len(tape.graphs)}; card's own graph agrees "
            f"with the CPU's at " + ", ".join(f"{x:.4f}" for x in
                                               tape.shares)
            + " of the points (near ties; the card runs on the CPU's)")
        check_scores("Point-MVSNet coarse", scores[-2], scores[-1],
                     torch.float32)
        check_depth("coarse depth", cpu["coarse_depth"], card["coarse_depth"],
                    unit, torch.float32)
        check_probs("coarse probability map", cpu["coarse_prob_map"],
                    card["coarse_prob_map"])
        for it, (_, inter) in enumerate(POINT_FLOW):
            key = f"flow{it + 1}"
            check_depth(key, cpu[key], card[key], inter * unit,
                        torch.float32)
            check_probs(f"{key} probabilities", cpu[f"{key}_prob"],
                        card[f"{key}_prob"])
        if not torch.equal(card["depth"], card["flow2"]):
            fail("depth is not the last flow")
    hook.remove()


def point_outputs(model, inputs, device) -> dict:
    apply_fn = make_apply_fn(model, device)
    out = {}
    hook = model.register_forward_hook(
        lambda m, a, o: out.update({k: v.float().cpu() for k, v in o.items()
                                    if k != "world_points"}))
    apply_fn(*inputs)
    hook.remove()
    return out


def check_probs(what, p_cpu, p_card, tol=1e-4):
    err = (p_card - p_cpu).abs().max().item()
    log(f"  {what} |card-cpu| max {err:.3e} (limit {tol})")
    if not err <= tol:
        fail(f"{what}: card differs from CPU")


def point_breakdown(model, run) -> dict:
    """Device ms of one run by layer: the image towers, the coarse volume,
    VolumeConv, the flow's variance features, the kNN, the EdgeConvs, the
    MLP and head; 'rest': the resizes, projections, xyz, softmaxes and
    regressions (in a train step also the loss, backward and optimizer)."""
    return with_rest(*module_spans(
        {"image towers": (model.coarse_img_conv, model.flow_img_conv),
         "VolumeConv": model.coarse_vol_conv,
         "EdgeConvs": (model.edge_conv0, model.edge_conv1, model.edge_conv2),
         "MLP / head": (model.flow_mlp, model.flow_head)},
        point_module,
        {"fused_variance_volume": lambda ref, src, rel, hyp: (
            "flow features" if hyp.shape[1] == 5 else "coarse volume"),
         "lattice_knn": "kNN"}, run))


def phase_point_full_width(device) -> dict:
    """11c: full width through cli.infer.make_apply_fn at flow_sub_stride
    4 and 1: ms per map, peak memory, launches (exact), device ms by layer
    and the profiler's top kernels and idle share. Returns {stride:
    (launches, ms, peak GiB, layers)}."""
    log(f"phase 11c: Point-MVSNet at full width {POINT_W}x{POINT_H}, "
        f"{POINT_VIEWS} views, {POINT_D} hypotheses, f32, maps "
        f"{POINT_W // 2}x{POINT_H // 2}, batch 1")
    scene = make_plane_scene(num_views=POINT_VIEWS, height=POINT_H,
                             width=POINT_W, z0=10.0)
    args = point_inputs(scene, device)
    lo, hi = 8.0 - 2.25 * POINT_INTERVAL, 12.0 + 2.25 * POINT_INTERVAL
    result = {}
    for stride in (4, 1):
        cfg = load_config(str(MVS_CONFIG),
                          [*POINT_EVAL, f"model.flow_sub_stride={stride}"])
        model = build_model(cfg, torch.Generator().manual_seed(0))
        apply_fn = make_apply_fn(model, device,
                                 **cli_infer.model_static_kwargs(cfg))
        apply_fn(*args)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        depth, conf = apply_fn(*args)
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = map_ms(apply_fn, args)
        log(f"  flow_sub_stride={stride}: {ms:.2f} ms per depth map, peak "
            f"{peak:.3f} GiB allocated, launches {json.dumps(counts)}")
        if counts != point_want("map"):
            fail(f"Point-MVSNet launches {counts}, want {point_want('map')}")
        if depth.shape != (1, POINT_H // 2, POINT_W // 2) or \
                conf.shape != (1, POINT_H // 8, POINT_W // 8):
            fail(f"output shapes {tuple(depth.shape)} {tuple(conf.shape)}")
        # The coarse soft-argmin lies in the ladder; each flow moves it by
        # at most 2 of its intervals. The 2-tap map is at most 2.
        if not (torch.isfinite(depth).all() and torch.isfinite(conf).all()
                and depth.min() >= lo - 1e-3 and depth.max() <= hi + 1e-3
                and ((conf >= 0) & (conf <= 2 + 1e-5)).all()):
            fail("Point-MVSNet full-width outputs not finite or out of range")
        layers = point_breakdown(model, lambda: apply_fn(*args))
        log("  device ms by layer, one map: " + json.dumps(layers))
        profile_run(apply_fn, args)
        result[stride] = (counts, ms, peak, layers)
        del model, apply_fn, depth, conf
        gc.collect()
        torch.cuda.empty_cache()
    return result


def phase_point_from_disk(device, root: Path, work: Path) -> dict:
    """11d: cli infer --config configs/cas_eval_dtu.yaml
    model.name=point_mvsnet over phase 8d's scan (1600x1200 cut to
    1280x960), flow_sub_stride 4, batch 1, launches exact; then cli fuse
    with the config's thresholds: a valid PLY. Returns the launches."""
    log(f"phase 11d: cli infer model.name=point_mvsnet over phase 8d's scan "
        f"({CVP_SCAN_VIEWS} views at 1600x1200, fitted to "
        f"{POINT_W}x{POINT_H}), f32, flow_sub_stride 4, batch 1; then cli "
        f"fuse")
    overrides = [*POINT_EVAL, "model.flow_sub_stride=4", "data.batch_size=1"]
    ckpt = work / "point_mvsnet.pt"
    torch.save(build_model(load_config(str(MVS_CONFIG), overrides),
                           torch.Generator().manual_seed(0)).state_dict(),
               ckpt)
    out = work / "out_point"
    reset_counts()
    result = cli_infer.main([
        "--config", str(MVS_CONFIG), "--ckpt", str(ckpt), "--out", str(out),
        "--device", str(device), *overrides, f"data.eval_root={root}",
        f"data.eval_list={root / 'lists' / 'test.txt'}"])
    torch.cuda.synchronize()
    counts = read_counts()
    want = point_want("map", CVP_SCAN_VIEWS)
    log(f"  {result['maps']} maps in {result['seconds']:.4f} s through the "
        f"CLI: {result['maps'] / result['seconds']:.4f} maps/s; launches "
        f"{json.dumps(counts)}")
    if counts != want or result["maps"] != CVP_SCAN_VIEWS:
        fail(f"cli infer point_mvsnet launches {counts}, want {want}")
    check_files(out / "scan1", CVP_SCAN_VIEWS, POINT_H // 2, POINT_W // 2)
    ply = cli_fuse.main(["--config", str(MVS_CONFIG), "--out", str(out),
                         "--device", str(device), f"data.eval_root={root}"])[0]
    log(f"  cli fuse (the config's thresholds) over the Point-MVSNet maps: "
        + check_cloud(ply))
    return counts


def float64_grads(make_task, state, batch) -> dict:
    """One train-mode forward and backward of make_task() in float64 on the
    CPU from `state`: {name: gradient}. The model casts its inputs with
    .float(), which is kept float64 for the call."""
    task = make_task()
    model = task.model.double()
    model.load_state_dict({k: v.double() for k, v in state.items()})
    model.train()
    tb = {k: v.double() for k, v in batch_to_device(batch, "cpu").items()}
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda t: t if t.dtype == torch.float64 \
        else to_float(t)
    try:
        loss, _ = task.loss_and_metrics(tb)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    finally:
        torch.Tensor.float = to_float
    return dict(zip(names, grads))


def point_train_samples(height, width, batch):
    return train_samples(height, width, batch, views=POINT_TRAIN_VIEWS,
                         depths=POINT_TRAIN_D)


def phase_point_training(device):
    """11e: one f32 train step card against CPU (128x160, 3 views, batch
    2, 16 coarse hypotheses; phase 7b's limits, the card on the CPU's kNN
    graphs; BatchNorm counts 1, and 2 in the flow's networks, which run
    once per flow iteration), the ladder over 6..10: the masked MAE's
    gradient is sign(est - gt), which flips between card and CPU at a pixel
    whose depth sits within their rounding of its GT, and a seeded model
    regresses the ladder's middle, so the plane (near 10) is kept 2 away
    from it. The step's f32 gradients of the coarse stage are ill-posed in
    f32: on the CPU they lie up to 2.2e-2 of their largest magnitude from
    the float64 step's (one rounding of the images moves them 2e-5 to
    1e-2), and the card's lie 1.1e-3 to 1.3e-3 from the CPU's (cosine >=
    0.9999992, on an NVIDIA H100 80GB HBM3). mvs_tpu's own f32 step is as
    far from float64: over one f32 rounding of the images both packages'
    coarse gradients toggle between ~1e-4 and 9.1e-3 of their largest
    magnitude, carried by the step's BatchNorms, not by the MAE's sign or
    bilinear's slope jumps (tests/test_torch_point_train.py::
    test_f32_gradient_gap_is_mvs_tpus_too). So a gradient also passes
    when the card's is no farther from the float64 step's than twice the
    CPU's is (float64_grads). Then training at full width with the train
    config's model and task (launches per step exact). Returns (launches,
    ms, peak GiB)."""
    log("phase 11e: one Point-MVSNet train step, card vs CPU, 128x160, 3 "
        "views, batch 2, D=16, f32, Adam 1e-3")
    state = PointMVSNet(num_depth=16, generator=torch.Generator().manual_seed(
        7)).state_dict()
    tape = GraphTape()

    def runs(label):
        return tape.record() if label == "cpu" else tape.replay()

    def make_task():
        return PointTask(PointMVSNet(num_depth=16), num_depth=16)

    batch = collate_point(train_samples(128, 160, 2, views=POINT_TRAIN_VIEWS,
                                        depths=16, start=6.0))
    check_train_step(
        make_task, state, batch, device,
        ("loss", "coarse_loss", "flow1_loss", "flow2_loss",
         "abs_depth_error"), (), updates=(1, 2), runs=runs,
        exact=lambda: float64_grads(make_task, state, batch))
    log(f"  kNN graphs {len(tape.graphs)}; the float64 run's own graph "
        f"agrees with the CPU's at " + ", ".join(f"{x:.4f}" for x in
                                                 tape.shares)
        + " of the points")
    log(f"phase 11e: Point-MVSNet training at full width, {TRAIN_W}x"
        f"{TRAIN_H}, {POINT_TRAIN_VIEWS} views, {POINT_TRAIN_D} hypotheses, "
        f"f32, batch {POINT_TRAIN_BATCH}, Adam 1e-3 "
        f"(configs/cas_train_dtu.yaml's task)")
    cfg = load_config(str(MVS_TRAIN_CONFIG), POINT_TRAIN)
    model = build_model(cfg, torch.Generator().manual_seed(0),
                        trained=False).to(device)
    task, collate = cli_train.build_task(cfg, model)
    batch = collate(point_train_samples(TRAIN_H, TRAIN_W, POINT_TRAIN_BATCH))
    return train_full_width(task, batch, point_want("train"), device,
                            lambda run: point_breakdown(model, run))


def phase_point_cli_train(device, work: Path) -> dict:
    """11f: cli train --config configs/cas_train_dtu.yaml
    model.name=point_mvsnet, one epoch on a synthetic training layout
    (images 640x512, 2 steps at batch 2, 48 hypotheses over the
    generator's range: data.interval_scale=4.24) with a val split and a
    checkpoint, launches exact; then cli infer from it."""
    log(f"phase 11f: cli train model.name=point_mvsnet on a synthetic DTU "
        f"training layout ({TRAIN_W}x{TRAIN_H}), then cli infer from its "
        f"checkpoint")
    root = generate(work / "dtu_point_train", num_scans=2, num_views=4,
                    height=TRAIN_H, width=TRAIN_W, num_depth=LADDER,
                    num_lights=1, tilt=SCAN_TILT)
    overrides = [*POINT_TRAIN, "data.batch_size=2",
                 "data.interval_scale=4.24"]
    reset_counts()
    result = cli_train.main([
        "--config", str(MVS_TRAIN_CONFIG), "--device", str(device),
        *overrides, f"data.root={root}",
        f"data.train_list={root}/lists/train.txt",
        f"data.val_list={root}/lists/val.txt", "train.epochs=1",
        "train.summary_every_steps=1", f"train.log_dir={work / 'run_point'}"])
    torch.cuda.synchronize()
    counts = read_counts()
    # 2 train steps, then 2 val batches in eval mode.
    train, val = point_want("train", 2), point_want("map", 2)
    want = {k: train[k] + val[k] for k in train}
    log(f"  {result['step']} steps, losses "
        + " ".join(f"{x:.4f}" for x in result["losses"])
        + f", {result['step'] * 2 / result['seconds']:.3f} samples/s "
        f"through the CLI's steps; val {json.dumps(result['val'])}; "
        f"launches {json.dumps(counts)}")
    if counts != want:
        fail(f"cli train point_mvsnet launches {counts}, want {want}")
    if result["step"] != 2 or not np.isfinite(result["losses"]).all():
        fail("cli train point_mvsnet did not take 2 finite steps")
    (work / "val_point.txt").write_text("scan2\n")
    out = work / "out_point_train"
    res = cli_infer.main([
        "--ckpt", result["ckpt_dir"], "--out", str(out), "--device",
        str(device), *overrides, f"data.eval_root={root}",
        f"data.eval_list={work / 'val_point.txt'}", f"data.max_h={TRAIN_H}",
        f"data.max_w={TRAIN_W}"])
    check_files(out / "scan2", 4, TRAIN_H // 2, TRAIN_W // 2)
    log(f"  cli infer loaded step {res['step']}; {res['maps']} maps written")
    if res["step"] != 2:
        fail(f"cli infer loaded step {res['step']}")
    return counts


def phase_point(device, root: Path, work: Path) -> dict:
    rows = phase_point_kernels(device)
    phase_point_vs_cpu(device)
    full = phase_point_full_width(device)
    cli = phase_point_from_disk(device, root, work)
    train_counts, train_ms, train_peak = phase_point_training(device)
    cli_train_counts = phase_point_cli_train(device, work)
    (_, ms4, peak4, _), (_, ms1, peak1, _) = full[4], full[1]
    log(f"  Point-MVSNet at {POINT_W}x{POINT_H}, D={POINT_D}, {POINT_VIEWS} "
        f"views, f32: {ms4:.2f} ms per map at flow_sub_stride 4 (peak "
        f"{peak4:.3f} GiB), {ms1:.2f} ms untiled (peak {peak1:.3f} GiB); "
        f"training at {TRAIN_W}x{TRAIN_H}, {POINT_TRAIN_VIEWS} views, batch "
        f"{POINT_TRAIN_BATCH}: {train_ms:.2f} ms per step (peak "
        f"{train_peak:.3f} GiB)")
    return dict(rows=rows, full=full, cli=cli, train=train_counts,
                cli_train=cli_train_counts)


# Phase 12. mvs_tpu's quality matrix (tests/test_e2e_matrix.py) on the card:
# each family trained by cli train on the multi-object fixture (a tilted
# backdrop with three spheres in front of it: occlusion boundaries, curved
# depth, view-dependent visibility), inferred by cli infer, and its depth
# error gated as mvs_tpu gates it, against the constant-z0 floor (the
# soft-argmin prior) and in absolute units. mvs_tpu trains with
# train.mesh_data=2, the global batch of 2 split over two devices; the port
# trains the same global batch of 2 on one card.
MATRIX_H, MATRIX_W, MATRIX_VIEWS, MATRIX_Z0 = 64, 96, 5, 10.0
MATRIX_TILT = (0.08, 0.05)
MATRIX_DATA = ["data.num_views=3", "data.num_depth=16",
               "data.interval_scale=1.0"]
MATRIX_TRAIN = [*MATRIX_DATA, "data.batch_size=2", "train.lr=0.002",
                "train.lr_schedule=99:2", "train.warmup_steps=4",
                "train.summary_every_steps=10", "train.bn_recal_batches=8"]
MATRIX_INFER = [*MATRIX_DATA, "data.max_h=64", "data.max_w=96",
                "data.align=32"]
# name: (model arguments, epochs, gate as a share of the constant floor,
# absolute gate), as tests/test_e2e_matrix.py has them.
MATRIX = {
    "cas_mvsnet": (["model.ndepths=8,8,8"], 6, 0.68, 0.33),
    "mvsnet": ([], 6, 0.68, 0.33),
    "cvp_mvsnet": (["model.num_levels=2", "model.coarse_depths=16",
                    "model.train_interval=0.4"], 6, 0.5, 0.45),
    "point_mvsnet": (["model.num_depth_coarse=16"], 6, 0.7, 0.6),
    "aacvp_mvsnet": (["model.num_levels=2", "model.coarse_depths=16",
                      "model.num_groups=4", "model.train_interval=0.4"],
                     16, 0.85, 0.41),
}
MATRIX_FLOOR, MATRIX_OVERALL = 0.4, 0.30
MATRIX_FUSION = ["fusion.conf_thresh=0.3", "fusion.num_consistent=2",
                 "fusion.pixel_thresh=2.0", "fusion.depth_thresh=0.05"]
# Full width: one objects scan at the family's eval size, rendered with
# focal 100 W / 96 so that the rig's angles are the fixture's; CVP / AACVP
# at 5 levels from their 2-level checkpoints. The unit of |bf16 - f32| is the
# finest hypothesis interval: the ladder's (CasMVSNet's last ratio is 1),
# the fixed residual interval for CVP / AACVP.
MATRIX_FULL = {"cas_mvsnet": (864, 1152), "mvsnet": (1184, 1600),
               "cvp_mvsnet": (1184, 1600), "aacvp_mvsnet": (1184, 1600)}
MATRIX_LADDER_INTERVAL = MATRIX_Z0 * (1.28 - 0.72) / 15
MATRIX_UNIT = {"cas_mvsnet": MATRIX_LADDER_INTERVAL,
               "mvsnet": MATRIX_LADDER_INTERVAL,
               "cvp_mvsnet": 0.4, "aacvp_mvsnet": 0.4}
BF16_GATE = 1.25


def matrix_kernels(name) -> tuple[str, str]:
    """The family's cost-volume kernel and its backward."""
    if name == "aacvp_mvsnet":
        return "group_correlation", "group_correlation_grad"
    return "warp_variance", "warp_variance_grad"


def upsampled(depth: np.ndarray, shape) -> np.ndarray:
    """`depth` bilinearly resized to `shape` with half-pixel centres (as
    cv2.resize, which mvs_tpu's matrix uses)."""
    if depth.shape == tuple(shape):
        return depth
    return F.interpolate(torch.from_numpy(np.ascontiguousarray(depth))[
        None, None], size=tuple(shape), mode="bilinear",
        align_corners=False)[0, 0].numpy()


def matrix_maps(out: Path, scenes: dict) -> list:
    """(estimate at the GT's size, GT) of every map written under `out`."""
    maps = []
    for scan, scene in scenes.items():
        for v, gt in enumerate(scene.depths):
            pfm = out / scan / "depth_est" / f"{v:08d}.pfm"
            if pfm.exists():
                maps.append((upsampled(read_pfm(pfm)[0], gt.shape), gt))
    if not maps:
        fail(f"no depth maps under {out}")
    return maps


def depth_errors(maps) -> tuple[float, float]:
    """Mean over the maps of mean |est - gt| where gt > 0, and the same of
    the constant z0 (tests/test_e2e_matrix.py's _depth_errors)."""
    errs = [np.abs(est - gt)[gt > 0].mean() for est, gt in maps]
    consts = [np.abs(MATRIX_Z0 - gt)[gt > 0].mean() for _, gt in maps]
    return float(np.mean(errs)), float(np.mean(consts))


def matrix_cli_infer(ckpt, out: Path, root: Path, device, model, dtype,
                     *data) -> dict:
    """cli infer of the test list with the launch counts of that run."""
    reset_counts()
    cli_infer.main(["--ckpt", str(ckpt), "--out", str(out), "--device",
                    str(device), *model, f"model.compute_dtype={dtype}",
                    f"data.eval_root={root}",
                    f"data.eval_list={root / 'lists' / 'test.txt'}", *data])
    torch.cuda.synchronize()
    return read_counts()


def check_launched(what, counts, keys) -> None:
    """Fail unless every kernel in `keys` launched in the run."""
    missing = [k for k in keys if counts[k] == 0]
    if missing:
        fail(f"{what}: no launch of {missing} ({json.dumps(counts)})")


def matrix_family(name, root: Path, work: Path, device, scenes) -> dict:
    args, epochs, share, gate = MATRIX[name]
    model = [f"model.name={name}", *args]
    run = work / f"run_{name}"
    fwd, grad = matrix_kernels(name)
    t0 = time.perf_counter()
    reset_counts()
    result = cli_train.main([
        "--device", str(device), *model, f"data.root={root}",
        f"data.train_list={root / 'lists' / 'train.txt'}",
        f"data.val_list={root / 'lists' / 'val.txt'}", *MATRIX_TRAIN,
        f"train.epochs={epochs}", f"train.log_dir={run}"])
    torch.cuda.synchronize()
    train_counts = read_counts()
    log(f"  {name}: cli train {epochs} epochs, {result['step']} steps at "
        f"global batch 2 on one card in {time.perf_counter() - t0:.2f} s, "
        f"loss {result['losses'][0]:.4f} -> {result['losses'][-1]:.4f}, "
        f"val abs_depth_error {result['val']['abs_depth_error']:.4f}; "
        f"launches {json.dumps(train_counts)}")
    check_launched(f"{name} cli train", train_counts, (fwd, grad))
    if not np.isfinite(result["losses"]).all():
        fail(f"{name}: losses not finite")
    dtypes = (torch.float32,) if name == "point_mvsnet" else (
        torch.float32, torch.bfloat16)
    row = {}
    for dtype in dtypes:
        short = str(dtype)[6:]
        out = work / f"out_{name}_{short}"
        t1 = time.perf_counter()
        counts = matrix_cli_infer(f"{run}/ckpt", out, root, device, model,
                                  short, *MATRIX_INFER)
        err, const = depth_errors(matrix_maps(out, scenes))
        log(f"  {name} {short}: mean |depth - gt| {err:.4f} over "
            f"{2 * MATRIX_VIEWS} maps, constant-z0 floor {const:.4f}; gates "
            f"< {share} x floor = {share * const:.4f} and < {gate}; cli infer "
            f"{time.perf_counter() - t1:.2f} s, launches "
            f"{json.dumps(counts)}")
        check_launched(f"{name} cli infer {short}", counts,
                       (fwd, "conv3d_affine"))
        if not const > MATRIX_FLOOR:
            fail(f"fixture degenerate: constant floor {const}")
        if not (err < share * const and err < gate):
            fail(f"{name} {short}: depth error {err:.4f} misses the gates "
                 f"({share} x {const:.4f}, {gate})")
        row[short] = dict(err=err, const=const)
        if name == "cas_mvsnet":
            matrix_cloud(out, root, device)
    return row


def matrix_cloud(out: Path, root: Path, device) -> None:
    """cli fuse and cli evaluate over the two scans' maps; fail unless both
    are scored and the overall distance is under its gate."""
    cli_fuse.main(["--out", str(out), "--device", str(device),
                   f"data.eval_root={root}", *MATRIX_FUSION])
    report = cli_evaluate.main(["--out", str(out), "--gt", str(root)])
    agg = report["aggregate"] if report else {}
    log(f"    cli fuse + cli evaluate: {json.dumps(agg)} (gate overall < "
        f"{MATRIX_OVERALL})")
    if agg.get("num_scans") != 2 or not agg["overall"] < MATRIX_OVERALL:
        fail(f"cli evaluate: {agg}")


def matrix_full_width(name, work: Path, device, scans: dict) -> dict:
    """The family's checkpoint over one objects scan at its eval size, f32
    and bf16: error against GT for both, and how far bf16 lies from f32."""
    h, w = MATRIX_FULL[name]
    if (h, w) not in scans:
        t0 = time.perf_counter()
        scene = make_objects_scene(
            num_views=MATRIX_VIEWS, height=h, width=w, z0=MATRIX_Z0, seed=0,
            tilt=MATRIX_TILT, focal=100.0 * w / MATRIX_W)
        root = work / f"objects_{w}x{h}"
        write_eval_scan(root, "scan1", scene, 16, MATRIX_Z0)
        (root / "lists").mkdir(parents=True, exist_ok=True)
        (root / "lists" / "test.txt").write_text("scan1\n")
        scans[(h, w)] = (root, {"scan1": scene})
        log(f"  objects scan at {w}x{h} (focal {100.0 * w / MATRIX_W:.1f}) "
            f"rendered and written in {time.perf_counter() - t0:.2f} s")
    root, scenes = scans[(h, w)]
    args = [a for a in MATRIX[name][0] if a != "model.num_levels=2"]
    if name in CVP_NAMES:
        args.append("model.num_levels=5")
    model = [f"model.name={name}", *args]
    fwd, _ = matrix_kernels(name)
    maps, row = {}, {}
    for dtype in ("float32", "bfloat16"):
        out = work / f"full_{name}_{dtype}"
        t0 = time.perf_counter()
        counts = matrix_cli_infer(work / f"run_{name}" / "ckpt", out, root,
                                  device, model, dtype, *MATRIX_DATA,
                                  f"data.max_h={h}", f"data.max_w={w}",
                                  "data.align=32")
        check_launched(f"{name} full width {dtype}", counts,
                       (fwd, "conv3d_affine"))
        maps[dtype] = matrix_maps(out, scenes)
        row[dtype], const = depth_errors(maps[dtype])
        row[f"{dtype}_s"] = time.perf_counter() - t0
    unit = MATRIX_UNIT[name]
    apart = np.concatenate([np.abs(a - b)[gt > 0] / unit for (a, gt), (b, _)
                            in zip(maps["bfloat16"], maps["float32"])])
    row.update(apart_mean=float(apart.mean()),
               apart_share=float((apart > 1.0).mean()))
    log(f"  {name} at {w}x{h}, {len(maps['float32'])} maps: mean |depth - "
        f"gt| f32 {row['float32']:.4f}, bf16 {row['bfloat16']:.4f} (gate "
        f"{BF16_GATE} x f32 = {BF16_GATE * row['float32']:.4f}; floor "
        f"{const:.4f}); |bf16 - f32| mean {row['apart_mean']:.4f} finest "
        f"intervals ({unit:.4f}), {row['apart_share']:.4f} of the pixels "
        f"beyond one; cli infer f32 {row['float32_s']:.2f} s, bf16 "
        f"{row['bfloat16_s']:.2f} s (PNG reads and PFM writes included)")
    if not row["bfloat16"] <= BF16_GATE * row["float32"]:
        fail(f"{name} full width: bf16 error {row['bfloat16']:.4f} over "
             f"{BF16_GATE} x f32's {row['float32']:.4f}")
    return row


def phase_matrix(device, work: Path) -> dict:
    log(f"phase 12: mvs_tpu's quality matrix through the CLIs: objects "
        f"fixture {MATRIX_W}x{MATRIX_H}, {MATRIX_VIEWS} views, 2 scans; "
        f"cli train (f32, global batch 2 on one card; mvs_tpu splits it over "
        f"train.mesh_data=2) -> cli infer f32 / bf16 -> depth error gates")
    t0 = time.perf_counter()
    root = generate(work / "objects", num_scans=2, num_views=MATRIX_VIEWS,
                    height=MATRIX_H, width=MATRIX_W, num_depth=16,
                    scene_type="objects", tilt=MATRIX_TILT)
    scenes = {f"scan{s + 1}": make_objects_scene(
        num_views=MATRIX_VIEWS, height=MATRIX_H, width=MATRIX_W,
        z0=MATRIX_Z0, seed=s, tilt=MATRIX_TILT) for s in range(2)}
    rows = {name: matrix_family(name, root, work, device, scenes)
            for name in MATRIX}
    scans = {}
    for name in MATRIX_FULL:
        rows[name]["full"] = matrix_full_width(name, work, device, scans)
    seconds = time.perf_counter() - t0
    log("  matrix: " + json.dumps({
        name: {k: (round(v["err"], 4), round(v["const"], 4))
               for k, v in row.items() if k in ("float32", "bfloat16")}
        for name, row in rows.items()}) + f"; phase 12 {seconds:.1f} s")
    return rows


def phase_eval_scale(oracle) -> None:
    """Phase 6d's oracle cloud scored whole through the native KD-tree, and
    its GT-window crop through both branches."""
    xyz, keep, stl = oracle
    log(f"phase 12b: DTU evaluation at a scan's size: {len(xyz)} points "
        f"through the native KD-tree (mvs_tpu_torch.native), host clock")
    if not native.available():
        fail("the native KD-tree did not build")
    t0 = time.perf_counter()
    whole = evaluate_scan(xyz, stl)
    whole_s = time.perf_counter() - t0
    log(f"  whole cloud: {whole_s:.3f} s (decimation at 0.2 and both "
        f"nearest-neighbour passes), {whole.n_data} points after "
        f"decimation and the 20-unit cutoff, acc {whole.acc_mean:.6f} comp "
        f"{whole.comp_mean:.6f}")
    if not (np.isfinite(whole.acc_mean) and np.isfinite(whole.comp_mean)):
        fail("whole-cloud evaluation not finite")
    crop = xyz[keep]
    times, results = {}, {}
    for branch, use_native in (("native", True), ("scipy", False)):
        t0 = time.perf_counter()
        results[branch] = evaluate_scan(crop, stl, use_native=use_native)
        times[branch] = time.perf_counter() - t0
    fast, slow = results["native"], results["scipy"]
    rel = max(abs(getattr(fast, f) / getattr(slow, f) - 1)
              for f in ("acc_mean", "comp_mean"))
    log(f"  crop of {len(crop)} points: native {times['native']:.3f} s, "
        f"scipy {times['scipy']:.3f} s; acc {fast.acc_mean:.8f} / "
        f"{slow.acc_mean:.8f}, comp {fast.comp_mean:.8f} / "
        f"{slow.comp_mean:.8f}, largest relative difference {rel:.3e} "
        f"(limit 1e-5)")
    if (fast.n_data, fast.n_stl) != (slow.n_data, slow.n_stl) or \
            not rel <= 1e-5:
        fail("native and scipy evaluations disagree")


# Phase 13. Data-parallel and view-sharded training (mvs_tpu_torch.parallel).
# The view shards' cost volume runs on the warp kernel's partial-moment
# variant: each rank sums its own source views' warped features and their
# squares in f32 (the reference view on view rank 0 only), one all-reduce
# over the 'view' group, then the variance. mvs_tpu's view-sharded path
# warps each local view with its gather warp (collectives.py:63) and has
# no Pallas kernel for it.
PARTIAL_REPLACES = "mvs_tpu/parallel/collectives.py:63"
PARALLEL_LR = 1e-2  # SGD: the update is -lr x the gradient
# 13b, two ranks against one process on the same global batch and weights:
# CasMVSNet data=2 in bf16, as its training path runs; MVSNet view=2 in
# bf16 (configs/cas_train_dtu.yaml's dtype) and in f32. The ranks'
# BatchNorm moments are two halves' f32 means averaged and their convs run
# at half the batch, so their sums round in another order; a network
# carries such a change on through its roundings, and the SGD step through
# the gradient. The one process is also run on images moved by one f32
# rounding (x * (1 +- 2^-24), random signs), which measures that for each
# step's loss. Limits: each step's loss (the second is the updated
# network's output on the batch) within 1e-3 relative or within 3x what
# that rounding moved it; the global update-norm ratio of the first step
# within 2% of 1 (averaged gradients give 0.5, a loss share without
# 1 / |view| gives 2); the ranks' parameters equal bit for bit after both
# steps.
# The ranks of a view group and of a split volume (15b) sum the features'
# cotangent over their group before the feature net's backward
# (parallel.collectives.shared, inside make_view_variance for 'view'), as
# mvs_tpu's shard_map transpose does, so the bf16 runs are held to one bf16
# process like the f32 ones (without that sum the bf16 MVSNet view=2 ratio
# was 0.97823 on an H100 80GB HBM3 at 700 W).
# Where a mesh has such a group (view, depth or space above 1), the
# feature net's first update alone, the part whose backward that sum
# changes, is held to the same 2% of one process's (bf16 MVSNet view=2:
# 1.00071, and 0.96354 without the sum, where the global ratio read
# 0.97823; H100 80GB HBM3, 700 W). Every run prints it, and the largest
# deviation of one parameter's first update from one process's, with no
# limit: in bf16 at 13b's inputs the step's own sensitivity swamps that
# (one f32 rounding of the images moves one process's by 0.104 of a
# parameter's largest update; the view ranks lie 0.035 away with the sum,
# 0.096 without it), where tests/test_torch_parallel.py's one small step
# holds it to 2^-8.
PARALLEL_LOSS_RTOL, PARALLEL_NORM_RTOL = 1e-3, 0.02
FEATURE_NETS = ("MVSNetFeatureNet_0", "CascadeFeatureNet_0")
PARALLEL_STEPS = 2
# The score convs' biases: the softmax over depth is invariant to them, so
# their exact gradient is 0 and each run's update is rounding residue.
PARALLEL_SCORE_BIASES = ("UNetCostRegNet_0.FoldedConv_0.bias",) + tuple(
    f"cost_reg_stage{i}.FoldedConv_0.bias" for i in (1, 2, 3))


def read_partial_counts() -> dict:
    return {"warp_variance_partials": fused_variance_partials.launches,
            "warp_variance_partials.vector":
                fused_variance_partials.vector_launches,
            "warp_variance_partials_grad":
                fused_variance_partials_grad.launches,
            "warp_variance_partials_grad.depth":
                fused_variance_partials_grad.depth_launches}


def partial_bound(b, v, d, h, w, c, itemsize, with_ref):
    """Least time of the partial forward: the local views' features (and
    the reference's with `with_ref`) and the hypotheses read once, the two
    f32 sums written once; the least f32 work as warp_bound's without the
    variance: per (pixel, view) 12, per (depth, pixel, view) 16, per
    (channel, view) 10."""
    nbytes = (b * (v + int(with_ref)) * h * w * c * itemsize
              + b * d * h * w * 4 + b * v * 12 * 4 + 2 * b * d * h * w * c * 4)
    ops = b * h * w * v * 12 + b * d * h * w * v * (16 + 10 * c)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            ops / PEAK_FLOPS[torch.float32] * 1e3)


def partial_grad_bound(b, v, d, h, w, c, itemsize, with_ref, depth=False):
    """Least time of the partial backward: g1 and g2 (f32), the features
    and the hypotheses read once, dsrc and (with `with_ref`) dref written
    once in the features' dtype, ddepth in f32 with `depth`. Least f32
    work: per (pixel, view) 12, per (depth, pixel, view) 16, per (channel,
    view) the blend (7), the cotangent g1 + 2 f g2 (3) and four weighted
    scatter-adds (8), per channel of the reference 3; with `depth`,
    DEPTH_GRAD_OPS."""
    per_view, per_channel = (16, 18) if not depth else (
        16 + DEPTH_GRAD_OPS[0], 18 + DEPTH_GRAD_OPS[1])
    nbytes = (2 * b * d * h * w * c * 4
              + 2 * b * (v + int(with_ref)) * h * w * c * itemsize
              + b * d * h * w * 4 * (2 if depth else 1) + b * v * 12 * 4)
    ops = (b * h * w * v * 12 + b * d * h * w * (
        v * (per_view + per_channel * c) + 3 * c * int(with_ref)))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            ops / PEAK_FLOPS[torch.float32] * 1e3)


def check_partials(args, with_ref, what, depth=False, timed=False):
    """The partial-moment forward and backward kernels against their plain
    versions (phase 2's limits: the sums are f32 whatever the inputs, so
    the f32 limit; the features' gradients in their dtype's), each launched
    once. With `timed`: kernel and plain ms of both. Returns a row."""
    ref, src, rel, hyp = args
    n = read_partial_counts()
    got = fused_variance_partials(*args, with_ref=with_ref)
    want = fused_variance_partials_plain(*args, with_ref=with_ref)
    err = max(compare("warp", a, b, f"{what} {name}")
              for a, b, name in zip(got, want, ("sum_f", "sum_sq")))
    g = torch.Generator(ref.device).manual_seed(zlib.crc32(what.encode()))
    g1, g2 = (torch.randn(got[0].shape, generator=g, device=ref.device)
              for _ in range(2))
    dgot = fused_variance_partials_grad(g1, g2, *args, with_ref=with_ref,
                                        depth_grad=depth)
    dwant = fused_variance_partials_grad_plain(g1, g2, *args,
                                               with_ref=with_ref,
                                               depth_grad=depth)
    for a, b, name in zip(dgot, dwant, ("dref", "dsrc", "ddepth")):
        if (a is None) != (b is None):
            fail(f"{what} {name}: kernel gives {a is not None}, plain "
                 f"{b is not None}")
        if a is not None:
            err = max(err, compare("warp_grad", a, b, f"{what} {name}"))
    m = read_partial_counts()
    if [m[k] - n[k] for k in m] != [1, int(ref.shape[-1] % 8 == 0), 1,
                                    int(depth)]:
        fail(f"{what}: launches {m} after {n}")
    row = dict(err=err)
    if timed:
        row["ms"] = cuda_ms(lambda: fused_variance_partials(
            *args, with_ref=with_ref))
        row["plain_ms"] = cuda_ms(lambda: fused_variance_partials_plain(
            *args, with_ref=with_ref), iters=3, warmup=1)
        row["grad_ms"] = cuda_ms(lambda: fused_variance_partials_grad(
            g1, g2, *args, with_ref=with_ref, depth_grad=depth))
        row["grad_plain_ms"] = cuda_ms(
            lambda: fused_variance_partials_grad_plain(
                g1, g2, *args, with_ref=with_ref, depth_grad=depth),
            iters=3, warmup=1)
    return row


def phase_partials(device):
    """13a: the partial-moment kernels at CasMVSNet's three training stages
    (TRAIN_W x TRAIN_H, batch TRAIN_BATCH, the 4 sources split 2 + 2: view
    rank 0 with the reference, view rank 1 without), f32 and bf16, bf16
    timed for view rank 0; then awkward inputs; then at 13b's MVSNet view=2
    inputs (mvsnet_partials). Returns {"cas": one row per stage (view rank
    0's launches) with ms, plain ms and bounds of both kernels, "mvsnet":
    mvsnet_partials' rows}."""
    log(f"phase 13a: warp partial-moment kernels (forward and backward) vs "
        f"plain, {TRAIN_W}x{TRAIN_H} stages, batch {TRAIN_BATCH}, "
        f"{VIEWS - 1} sources split 2 + 2 over two view ranks")
    scene = make_plane_scene(num_views=VIEWS, height=TRAIN_H, width=TRAIN_W,
                             z0=10.0)
    rows = []
    for stage, scale, c in STAGES:
        d, h, w = NDEPTHS[stage - 1], TRAIN_H // scale, TRAIN_W // scale
        for dtype in (torch.float32, torch.bfloat16):
            ref, src, rel, hyp = warp_inputs(
                scene, stage, scale, c, d, dtype, device, batch=TRAIN_BATCH,
                seed=stage, height=TRAIN_H, width=TRAIN_W)
            for shard in (0, 1):
                local = slice(2 * shard, 2 * shard + 2)
                timed = dtype is torch.bfloat16 and shard == 0
                row = check_partials(
                    (ref, src[:, local].contiguous(),
                     rel[:, local].contiguous(), hyp), shard == 0,
                    f"stage{stage} view rank {shard} B={TRAIN_BATCH} D={d} "
                    f"{h}x{w} C={c} {str(dtype)[6:]}", timed=timed)
                if not timed:
                    continue
                by, ops = partial_bound(TRAIN_BATCH, 2, d, h, w, c, 2, True)
                gby, gops = partial_grad_bound(TRAIN_BATCH, 2, d, h, w, c, 2,
                                               True)
                row.update(bytes_ms=by, ops_ms=ops, grad_bytes_ms=gby,
                           grad_ops_ms=gops)
                log(f"    forward kernel {row['ms']:.4f} ms, plain "
                    f"{row['plain_ms']:.4f}, bound {max(by, ops):.4f} (bytes "
                    f"{by:.4f}, ops {ops:.4f}); backward kernel "
                    f"{row['grad_ms']:.4f} ms, plain "
                    f"{row['grad_plain_ms']:.4f}, bound {max(gby, gops):.4f} "
                    f"(bytes {gby:.4f}, ops {gops:.4f})")
                rows.append(row)
            del ref, src, rel, hyp
    for dtype in (torch.float32, torch.bfloat16):
        for c in (12, 16):
            ref, src, rel, hyp = ragged_volume_inputs(dtype, device, c=c)
            for views, with_ref, depth in ((1, True, True), (3, False, True),
                                           (2, True, False),
                                           (3, True, False)):
                check_partials((ref, src[:, :views].contiguous(),
                                rel[:, :views].contiguous(), hyp), with_ref,
                               f"ragged B=2 D=7 37x53 C={c} {views} local "
                               f"view(s) ref {with_ref} ddepth {depth} "
                               f"{str(dtype)[6:]}", depth=depth)
    log("  one view rank's CasMVSNet train step (bf16, 3 launches each): "
        f"forward {sum(r['ms'] for r in rows):.4f} ms, backward "
        f"{sum(r['grad_ms'] for r in rows):.4f} ms")
    return dict(cas=rows, mvsnet=mvsnet_partials(device))


def mvsnet_partials(device) -> dict:
    """13a at 13b's MVSNet view=2 inputs: batch TRAIN_BATCH, D = LADDER,
    TRAIN_W / 4 x TRAIN_H / 4, C = MVS_C, one local source view a rank
    (view rank 0 with the reference, view rank 1 without), f32 and bf16,
    each timed. Returns {(dtype, view rank): row}."""
    h, w = TRAIN_H // 4, TRAIN_W // 4
    log(f"  MVSNet view=2's shape: B={TRAIN_BATCH} D={LADDER} {w}x{h} "
        f"C={MVS_C}, one of the {MVS_TRAIN_VIEWS - 1} sources a view rank")
    scene = make_plane_scene(num_views=MVS_TRAIN_VIEWS, height=TRAIN_H,
                             width=TRAIN_W, z0=10.0)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        ref, src, rel, hyp = warp_inputs(
            scene, 1, 4, MVS_C, LADDER, dtype, device, batch=TRAIN_BATCH,
            seed=4, height=TRAIN_H, width=TRAIN_W)
        for shard in (0, 1):
            local = slice(shard, shard + 1)
            row = check_partials(
                (ref, src[:, local].contiguous(), rel[:, local].contiguous(),
                 hyp), shard == 0,
                f"MVSNet view rank {shard} B={TRAIN_BATCH} D={LADDER} {h}x{w} "
                f"C={MVS_C} {str(dtype)[6:]}", timed=True)
            itemsize = torch.tensor([], dtype=dtype).element_size()
            by, ops = partial_bound(TRAIN_BATCH, 1, LADDER, h, w, MVS_C,
                                    itemsize, shard == 0)
            gby, gops = partial_grad_bound(TRAIN_BATCH, 1, LADDER, h, w,
                                           MVS_C, itemsize, shard == 0)
            row.update(bytes_ms=by, ops_ms=ops, grad_bytes_ms=gby,
                       grad_ops_ms=gops)
            log(f"    forward kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f}, bound {max(by, ops):.4f} (bytes "
                f"{by:.4f}, ops {ops:.4f}); backward kernel "
                f"{row['grad_ms']:.4f} ms, plain {row['grad_plain_ms']:.4f}, "
                f"bound {max(gby, gops):.4f} (bytes {gby:.4f}, ops "
                f"{gops:.4f})")
            rows[dtype, shard] = row
        del ref, src, rel, hyp
        torch.cuda.empty_cache()
    return rows


def parallel_spec(name):
    """The 13b configuration `name` (cas_mvsnet, mvsnet, mvsnet_f32): its
    model, task and collated global batch (numpy), its mesh, and the
    weights (seeded, the Flax initial state; the two MVSNet configurations
    share them)."""
    if name == "cas_mvsnet":
        cfg = load_config(str(MVS_TRAIN_CONFIG),
                          ["model.compute_dtype=bfloat16"])
        mesh, views = dict(data=2), VIEWS
    else:
        dtype = torch.float32 if name == "mvsnet_f32" else torch.bfloat16
        cfg = mvs_config(dtype, f"data.num_views={MVS_TRAIN_VIEWS}",
                         config=MVS_TRAIN_CONFIG)
        mesh, views = dict(view=2), MVS_TRAIN_VIEWS
    model = build_model(cfg, torch.Generator().manual_seed(5), trained=False)
    _, collate = cli_train.build_task(cfg, model)
    batch = collate(train_samples(TRAIN_H, TRAIN_W, TRAIN_BATCH, views=views,
                                  seed=11))
    # Unequal mask counts over the data ranks: the top quarter of the
    # second half's GT masked out.
    masks = batch["mask"] if isinstance(batch["mask"], dict) else {
        None: batch["mask"]}
    for m in masks.values():
        m[TRAIN_BATCH // 2:, :m.shape[1] // 4] = 0.0
    return dict(name=name, cfg=cfg, mesh=mesh, batch=batch,
                state=model.state_dict())


def parallel_run(spec, device, mesh) -> dict:
    """PARALLEL_STEPS SGD train steps of spec's model on this rank's rows
    of its global batch under `mesh` (a one-process mesh: the whole batch):
    each step's loss, the first step's global update norm and parameters
    after it, the second
    step's ms (host clock) and launches (counts zeroed just before it),
    peak memory, and the parameters and the BatchNorm statistics after the
    last step."""
    model = build_model(spec["cfg"], torch.Generator().manual_seed(5),
                        trained=False)
    model.load_state_dict(spec["state"])
    model = model.to(device)
    if mesh.size("view") > 1:
        model.view_variance = make_view_variance(mesh)
    if mesh.size("depth") * mesh.size("space") > 1:
        model.volume_constraint = volume_sharded_plan(mesh).constrain_volume
    task, _ = cli_train.build_task(spec["cfg"], model)
    opt = OptaxChain(model.parameters(), "sgd", lambda count: PARALLEL_LR)
    step = make_train_step(task, opt, mesh=mesh)
    batch = batch_to_device(shard_batch(spec["batch"], mesh), device)
    start = [p.detach().clone() for p in opt.params]
    card = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if card else (
        lambda: None)
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    losses, ms, counts = [], None, None
    for i in range(PARALLEL_STEPS):
        sync()
        if i == 1:
            reset_counts()
        t0 = time.perf_counter()
        losses.append(float(step(batch)["loss"]))
        sync()
        if i == 0:
            norm = float(torch.sqrt(sum(((p.detach() - q).double() ** 2).sum()
                                        for p, q in zip(opt.params, start))))
            first = {k: p.detach().cpu().clone()
                     for k, p in model.named_parameters()}
        if i == 1:
            ms = (time.perf_counter() - t0) * 1e3
            counts = {**read_counts(), **read_partial_counts()}
    params = {k for k, _ in model.named_parameters()}
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    return dict(losses=losses, norm=norm, first=first, ms=ms, counts=counts,
                peak=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                      if card else 0.0),
                params={k: v for k, v in state.items() if k in params},
                stats={k: v for k, v in state.items() if k not in params})


def rank_worker(spec_path) -> int:
    """One rank of 13b (chip_smoke.py --rank-worker <spec>): every
    configuration of the spec file under its mesh; results to
    <spec>.rank<r>.pt."""
    specs = torch.load(spec_path, weights_only=False)
    proc = maybe_initialize_distributed(specs["device"])
    out = {}
    for spec in specs["runs"]:
        mesh = make_mesh(**spec["mesh"])
        out[spec["name"]] = parallel_run(spec, proc.device, mesh)
        out[spec["name"]]["coords"] = mesh.coords
    torch.save(out, f"{spec_path}.rank{proc.rank}.pt")
    shutdown()
    return 0


def phase_parallel_steps(device, work: Path,
                         names=("cas_mvsnet", "mvsnet", "mvsnet_f32"),
                         world=2, meshes=None, shared=True, reference=None,
                         label="13b") -> dict:
    """13b: each configuration's steps as `world` ranks against one process
    on the same global batch and weights: sharing the card over gloo (the
    backend rule for a named card) unless not `shared`, and where the host
    has `world` cards, a card a rank over NCCL. `meshes` ({name: mesh})
    replaces a configuration's mesh; `reference`, an earlier call's result,
    gives the one-process runs."""
    specs = [parallel_spec(n) for n in names]
    for spec in specs:
        spec["mesh"] = (meshes or {}).get(spec["name"], spec["mesh"])
    log(f"phase {label}: {world} ranks vs one process, {TRAIN_W}x{TRAIN_H}, "
        f"global batch {TRAIN_BATCH}, SGD {PARALLEL_LR}: "
        + ", ".join(f"{s['name']} {s['mesh']}" for s in specs)
        + f" (CasMVSNet {VIEWS} views, bf16; MVSNet {MVS_TRAIN_VIEWS} views, "
        f"D={LADDER}, bf16 and f32)")
    single, nudged = {}, {}
    if reference is not None:
        single, nudged = reference["single"], reference["nudged"]
    for spec in (specs if reference is None else ()):
        single[spec["name"]] = parallel_run(spec, device, make_mesh())
        imgs = spec["batch"]["imgs"]
        sign = np.random.default_rng(1).choice([-1.0, 1.0], size=imgs.shape)
        moved = dict(spec, batch=dict(spec["batch"], imgs=(
            imgs * (1 + sign * 2.0 ** -24)).astype(np.float32)))
        nudged[spec["name"]] = parallel_run(moved, device, make_mesh())
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if reference is None and {"mvsnet", "mvsnet_f32"} <= set(single):
        log("  mvsnet one process, update norm bf16 / f32: "
            f"{single['mvsnet']['norm'] / single['mvsnet_f32']['norm']:.5f}"
            " (on the nudged images "
            f"{nudged['mvsnet']['norm'] / nudged['mvsnet_f32']['norm']:.5f})")
    phase = label
    layouts = [(str(device), f"gloo, {world} ranks sharing one card")] \
        if shared else []
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        layouts.append((None, "nccl, a card a rank"))
    results = {}
    for named, label in layouts:
        path = work / f"parallel_{world}_{named or 'nccl'}_" \
            f"{'_'.join(f'{k}{v}' for k, v in specs[0]['mesh'].items())}.pt"
        torch.save(dict(device=named, runs=specs), path)
        t0 = time.perf_counter()
        env = dict(os.environ, OMP_NUM_THREADS=str(
            max(1, (os.cpu_count() or world) // world)))
        ranks = launch_local([sys.executable, str(Path(__file__).resolve()),
                              "--rank-worker", str(path)], world, 300.0,
                             cwd=Path(__file__).resolve().parent, env=env)
        seconds = time.perf_counter() - t0
        for r, (rc, out) in enumerate(ranks):
            if rc != 0:
                fail(f"{phase} rank {r} ({label}) exited {rc}:\n"
                     f"{out[-3000:]}")
            backend = "gloo" if named else "nccl"
            if not out.startswith(f"rank {r}/{world}: torch.distributed "
                                  f"backend {backend}"):
                fail(f"{phase} rank {r}: first line "
                     f"{out.splitlines()[0]!r}")
        got = [torch.load(f"{path}.rank{r}.pt", weights_only=False)
               for r in range(world)]
        log(f"  {label}: all {world} ranks done in {seconds:.1f} s (start-up "
            f"included)")
        for spec in specs:
            name = spec["name"]
            check_ranks(spec, [g[name] for g in got], single[name],
                        nudged[name], label)
        results[label] = got
    return dict(single=single, nudged=nudged, ranks=results[layouts[0][1]],
                layouts=results, seconds=seconds)


def update_norm(params, start, keys) -> float:
    """The norm of the update from `start` of the parameters `keys`."""
    return float(torch.sqrt(sum(((params[k].double() - start[k].double())
                                 ** 2).sum() for k in keys)))


def update_deviation(got, want, start) -> tuple:
    """(deviation, name): the parameter whose update from `start` in `got`
    lies farthest from `want`'s, over the latter's largest magnitude (the
    score biases aside)."""
    worst = (0.0, "")
    for k, w in want.items():
        if k in PARALLEL_SCORE_BIASES:
            continue
        w = w.double() - start[k].double()
        g = got[k].double() - start[k].double()
        worst = max(worst, (float((g - w).abs().max())
                            / max(float(w.abs().max()), 1e-30), k))
    return worst


def check_ranks(spec, ranks, want, nudged, label) -> None:
    """13b's limits for one configuration's ranks against one process (and
    the one process on nudged images)."""
    name, a = spec["name"], ranks[0]
    ratio = a["norm"] / want["norm"]
    nudged_ratio = nudged["norm"] / want["norm"]
    start = spec["state"]
    feature = [k for k in want["first"] if k.startswith(FEATURE_NETS)]
    feature_ratio, nudged_feature = (
        update_norm(r["first"], start, feature)
        / update_norm(want["first"], start, feature) for r in (a, nudged))
    dev, dev_name = update_deviation(a["first"], want["first"], start)
    nudged_dev, _ = update_deviation(nudged["first"], want["first"], start)
    grouped = any(spec["mesh"].get(axis, 1) > 1
                  for axis in ("view", "depth", "space"))
    rel = [abs(x / y - 1) for x, y in zip(a["losses"], want["losses"])]
    moved = [abs(x / y - 1) for x, y in zip(nudged["losses"],
                                            want["losses"])]
    limits = [max(PARALLEL_LOSS_RTOL, 3 * m) for m in moved]
    same = all(torch.equal(a["params"][k], b["params"][k])
               for b in ranks[1:] for k in a["params"])
    # The ranks of a view group take their BatchNorm moments from the same
    # rows, each in its own process, whose forwards need not round alike:
    # their statistics may part in the last bits (the data ranks' moments
    # are all-reduced, so theirs agree).
    stats = max(float(((a["stats"][k] - b["stats"][k]).abs()
                       / b["stats"][k].abs().clamp(min=1e-6)).max())
                for b in ranks[1:] for k in a["stats"]
                if k.endswith(("mean", "var")))
    multi = label.startswith("nccl")
    log(f"  {name} mesh {spec['mesh']} ({label}): losses "
        + " ".join(f"{x:.6f}" for x in a["losses"]) + " vs one process "
        + " ".join(f"{x:.6f}" for x in want["losses"])
        + " (relative differences " + " ".join(f"{x:.2e}" for x in rel)
        + "; one f32 rounding of the images moves them "
        + " ".join(f"{x:.2e}" for x in moved) + "; limits "
        + " ".join(f"{x:.2e}" for x in limits)
        + f"); global update-norm ratio {ratio:.5f} (limit 1 +- "
        f"{PARALLEL_NORM_RTOL}; one f32 rounding of the images: "
        f"{nudged_ratio:.5f}), the feature net's {feature_ratio:.5f} ("
        + ("the same limit" if grouped else "no limit")
        + f"; {nudged_feature:.5f}); largest deviation of a "
        f"parameter's update {dev:.3e} ({dev_name}; no limit; "
        f"{nudged_dev:.3e}); ranks' "
        f"parameters {'identical' if same else 'DIFFER'}, their BatchNorm "
        f"statistics apart by {stats:.1e} relative at most; ms per step "
        f"(host clock, one step): ranks "
        + " / ".join(f"{r['ms']:.1f}" for r in ranks)
        + (f" ({label})" if multi else
           f" ({label}: not a multi-card rate)")
        + f", one process {want['ms']:.1f}"
        + (f", {TRAIN_BATCH * 1e3 / max(r['ms'] for r in ranks):.3f} "
           f"samples/s of the global batch against "
           f"{TRAIN_BATCH * 1e3 / want['ms']:.3f}" if multi else "")
        + "; peak GiB ranks " + " / ".join(f"{r['peak']:.2f}" for r in ranks)
        + f", one process {want['peak']:.2f}; launches per step, rank 0 "
        f"{json.dumps(a['counts'])}")
    if any(x > lim for x, lim in zip(rel, limits)):
        fail(f"13b {name}: losses differ by {rel}, limits {limits}")
    if abs(ratio - 1) > PARALLEL_NORM_RTOL:
        fail(f"13b {name}: update-norm ratio {ratio}")
    if grouped and abs(feature_ratio - 1) > PARALLEL_NORM_RTOL:
        fail(f"13b {name}: the feature net's update-norm ratio "
             f"{feature_ratio}")
    if not same or (spec["mesh"].get("view", 1) == 1 and stats):
        fail(f"13b {name}: the ranks' parameters or all-reduced statistics "
             f"differ")
    keys = ("warp_variance", "warp_variance_grad") if \
        spec["mesh"].get("view", 1) == 1 else (
            "warp_variance_partials", "warp_variance_partials_grad")
    for r in ranks:
        check_launched(f"13b {name}", r["counts"], keys)


def phase_torchrun(work: Path, device) -> None:
    """13c: `torchrun --standalone --nproc_per_node=1 -m mvs_tpu_torch.cli
    train` on a synthetic DTU training layout: NCCL at world size 1 on the
    card, 2 steps and a checkpoint, then --resume for 2 more (on the CPU,
    with --device cpu: gloo)."""
    log("phase 13c: torchrun --nproc_per_node=1 -m mvs_tpu_torch.cli train "
        "(NCCL, world size 1), checkpoint, --resume")
    root = generate(work / "tdtu", num_scans=2, num_views=VIEWS,
                    height=TRAIN_H // 2, width=TRAIN_W // 2, num_depth=LADDER,
                    num_lights=1, tilt=SCAN_TILT)
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node=1", "-m", "mvs_tpu_torch.cli", "train",
            "--config", str(MVS_TRAIN_CONFIG),
            f"data.root={root}", f"data.train_list={root}/lists/train.txt",
            f"data.val_list={root}/lists/val.txt", "data.batch_size=2",
            "train.summary_every_steps=1", "train.mesh_data=1",
            f"train.log_dir={work / 'trun'}"]
    if device.type != "cuda":
        base.insert(base.index("--config"), "--device=cpu")
    backend = ("torch.distributed backend nccl on cuda:0"
               if device.type == "cuda" else "backend gloo on cpu")
    for extra, want in ((["train.epochs=1"], "epoch 0 step 2/2"),
                        (["train.epochs=2", "--resume"],
                         "resumed at step 2 (epoch 1)")):
        t0 = time.perf_counter()
        proc = subprocess.run(base + extra, capture_output=True, text=True,
                              timeout=300, cwd=Path(__file__).resolve().parent)
        out = proc.stdout + proc.stderr
        if proc.returncode != 0 or want not in out or backend not in out:
            fail(f"13c torchrun {extra}: exit {proc.returncode}\n"
                 f"{out[-3000:]}")
        log(f"  {' '.join(extra)}: {time.perf_counter() - t0:.1f} s; "
            + "; ".join(ln for ln in proc.stdout.splitlines()
                        if "backend" in ln or "step" in ln))
    ckpt = sorted(p.name for p in (work / "trun" / "ckpt").glob("*.pt"))
    log(f"  checkpoints {ckpt}")
    if ckpt != ["step_00000002.pt", "step_00000004.pt"]:
        fail(f"13c checkpoints {ckpt}")


def phase_fuse_scans(work: Path, cards) -> None:
    """13d: fuse_scans over `cards` (the visible ones), and as two streams
    on the first, against one stream: the same clouds."""
    log(f"phase 13d: fuse_scans over {len(cards)} visible card(s) and as "
        f"two streams on {cards[0]}, against one stream")
    jobs = []
    for s in range(3):
        scene = make_plane_scene(num_views=SCAN_VIEWS, height=216, width=288,
                                 z0=10.0, seed=s, tilt=SCAN_TILT)
        rng = np.random.default_rng(s)
        scan = work / "fuse" / f"scan{s + 1}"
        for v in range(SCAN_VIEWS):
            write_pfm(scan / "depth_est" / f"{v:08d}.pfm", (scene.depths[v] * (
                1 + rng.normal(0, 0.002, scene.depths[v].shape))).astype(
                    np.float32))
            write_pfm(scan / "confidence" / f"{v:08d}.pfm",
                      rng.uniform(0.5, 1, scene.depths[v].shape).astype(
                          np.float32))
            write_cam_file(scan / "cams" / f"{v:08d}_cam.txt", CameraParams(
                scene.intrinsics[v], scene.extrinsics[v], 7.2, 0.03))
        write_pair_file(scan / "pair.txt", [
            (r, [(u, 1.0) for u in srcs])
            for r, srcs in scan_pairs(SCAN_VIEWS)])
        jobs.append((scan, scan / "pair.txt"))
    fcfg = FusionConfig(0.6, 3, 1.0, 0.01)
    clouds = {}
    for label, devices in (("serial", cards[0]), ("visible", cards),
                           ("two streams", [cards[0]] * 2)):
        t0 = time.perf_counter()
        paths = cli_fuse.fuse_scans(jobs, fcfg, devices)
        clouds[label] = [read_ply(p)["xyz"] for p in paths]
        log(f"  {label}: {time.perf_counter() - t0:.2f} s, points "
            + " / ".join(str(len(x)) for x in clouds[label]))
    for label in ("visible", "two streams"):
        if not all(np.array_equal(a, b) for a, b in zip(clouds[label],
                                                       clouds["serial"])):
            fail(f"13d {label}: clouds differ from the serial path's")
    if min(len(x) for x in clouds["serial"]) < 1000:
        fail("13d: too few fused points")


def phase_parallel(device, work: Path) -> dict:
    t0 = time.perf_counter()
    rows = phase_partials(device)
    steps = phase_parallel_steps(device, work)
    if device.type == "cuda" and torch.cuda.device_count() >= 4:
        # A host of four cards: the global batch over four, and the data x
        # view mesh, a card a rank over NCCL.
        phase_parallel_steps(
            device, work, names=("cas_mvsnet", "mvsnet_f32"), world=4,
            shared=False, meshes={"cas_mvsnet": dict(data=4),
                                  "mvsnet_f32": dict(data=2, view=2)})
    phase_torchrun(work, device)
    phase_fuse_scans(work, cli_fuse.visible_cards() if device.type == "cuda"
                     else [device])
    log(f"  phase 13 {time.perf_counter() - t0:.1f} s")
    return dict(rows=rows, **steps)


def ab_group_levels(device) -> dict:
    """The group-correlation forward at each AACVP level (8a's inputs), f32
    and bf16: device ms per launch."""
    scene = make_plane_scene(num_views=VIEWS, height=CVP_H, width=CVP_W,
                             z0=10.0)
    rows = {}
    for level, d, h, w in cvp_levels():
        for dtype in (torch.float32, torch.bfloat16):
            args = cvp_volume_inputs(scene, level, d, dtype, device,
                                     seed=level)
            rows[f"8a group correlation level {level} {str(dtype)[6:]}"] = \
                cuda_ms(lambda: group_correlation_volume(*args, CVP_GROUPS))
    return rows


def ab_aacvp_f32_convs(device) -> dict:
    """AACVP's 10 f32 convs of a map, (4, 16) and (16, 16) at every level:
    device ms summed over the launches."""
    g = torch.Generator().manual_seed(17)
    total = 0.0
    for level, d, h, w in cvp_levels():
        for cin in (CVP_GROUPS, CVP_BASE):
            x, wt, sc, sh = conv_inputs(g, device, 1, d, h, w, cin, CVP_BASE,
                                        torch.float32)
            total += cuda_ms(lambda: conv3d_affine(x, wt, sc, sh, True))
    return {"8a AACVP's 10 f32 convs (kernel ms, summed)": total}


def ab_pyramid_maps(device) -> dict:
    """Host ms per depth map of CVP-MVSNet and AACVP-MVSNet in bf16 and f32
    (8c's inputs: 1600x1184, 5 levels), after a warm-up."""
    scene = make_plane_scene(num_views=VIEWS, height=CVP_H, width=CVP_W,
                             z0=10.0)
    args = stack_model_inputs([cvp_sample(scene)], device, "pyramid")
    rows = {}
    for name in CVP_NAMES:
        for dtype in (torch.bfloat16, torch.float32):
            model = build_model(cvp_config(name, dtype),
                                torch.Generator().manual_seed(0))
            apply_fn = make_apply_fn(model, device)
            apply_fn(*args)
            rows[f"8c {name} {str(dtype)[6:]} ms per map"] = map_ms(
                apply_fn, args)
            del model, apply_fn
    return rows


def ab_cas_f32_map(device) -> dict:
    """Host ms per f32 CasMVSNet depth map (phase 4's inputs), after a
    warm-up."""
    scene = make_plane_scene(num_views=VIEWS, height=HEIGHT, width=WIDTH,
                             z0=10.0)
    model = CasMVSNet(BASE, NDEPTHS, compute_dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
    apply_fn = make_apply_fn(model, device)
    args = model_inputs(scene, 1, device)
    apply_fn(*args)
    return {"4 cas_mvsnet float32 ms per map": map_ms(apply_fn, args)}


def cin64_f32_maps():
    """{map: [(Cout, D, H, W), ...]}: every f32 conv at Cin = 64 of one f32
    depth map of each family, in launch order (11a, 8a, 2b, 9a)."""
    return {"11a Point-MVSNet": list(POINT_CIN64),
            "8a CVP / AACVP": [s[1:] for s in cvp_cin64_shapes()],
            "2b CasMVSNet": [(co, d, h, w) for ci, co, d, h, w, _
                             in conv_shapes() if ci == 64],
            "9a MVSNet": [MVS_CIN64]}


def ab_cin64_f32_convs(device) -> dict:
    """Every f32 conv at Cin = 64 of an f32 map of each family
    (cin64_f32_maps): device ms per launch of each shape, on the checkout's
    kernel and on cuDNN's f32 conv (TF32 off) over the same inputs, and
    their sums over the map's launches."""
    g = torch.Generator().manual_seed(19)
    rows = {}
    for label, shapes in cin64_f32_maps().items():
        kernel = library = 0.0
        for shape in dict.fromkeys(shapes):  # each shape once, in order
            cout, d, h, w = shape
            x, wt, sc, sh = conv_inputs(g, device, 1, d, h, w, 64, cout,
                                        torch.float32)
            ms = cuda_ms(lambda: conv3d_affine(x, wt, sc, sh, True))
            lib = cuda_ms(cudnn_conv(x, wt, sc, sh, True))
            del x, wt, sc, sh
            rows[f"{label} 64->{cout} {d}x{h}x{w} kernel"] = ms
            rows[f"{label} 64->{cout} {d}x{h}x{w} cuDNN f32"] = lib
            kernel += shapes.count(shape) * ms
            library += shapes.count(shape) * lib
        rows[f"{label}'s {len(shapes)} summed, kernel"] = kernel
        rows[f"{label}'s {len(shapes)} summed, cuDNN f32"] = library
    return rows


def ab_bf16_convs(device) -> dict:
    """The bf16 convs timed in 2b (a CasMVSNet map's 15) and in 8a (CVP
    level 0's 9, AACVP's f32 (4, 16) aside): device ms summed per set."""
    g = torch.Generator().manual_seed(29)
    sets = {"2b CasMVSNet's 15 bf16 convs": conv_shapes(),
            "8a CVP level 0's 9 bf16 convs": [
                s for s in cvp_level_convs(CVP_FINE_D, CVP_H, CVP_W)
                if s[0] != CVP_GROUPS]}
    rows = {}
    for label, shapes in sets.items():
        total = 0.0
        for cin, cout, d, h, w, relu in shapes:
            x, wt, sc, sh = conv_inputs(g, device, 1, d, h, w, cin, cout,
                                        torch.bfloat16)
            total += cuda_ms(lambda: conv3d_affine(x, wt, sc, sh, relu))
            del x, wt, sc, sh
        rows[f"{label} (kernel ms, summed)"] = total
    return rows


def ab_point_f32_map(device) -> dict:
    """Host ms per untiled f32 Point-MVSNet depth map (11c's inputs),
    after a warm-up."""
    scene = make_plane_scene(num_views=POINT_VIEWS, height=POINT_H,
                             width=POINT_W, z0=10.0)
    args = point_inputs(scene, device)
    cfg = load_config(str(MVS_CONFIG),
                      [*POINT_EVAL, "model.flow_sub_stride=1"])
    model = build_model(cfg, torch.Generator().manual_seed(0))
    apply_fn = make_apply_fn(model, device,
                             **cli_infer.model_static_kwargs(cfg))
    apply_fn(*args)
    return {"11c point_mvsnet float32 untiled ms per map": map_ms(apply_fn,
                                                                  args)}


# Phase 14. A user's own COLMAP scene through the Tanks-and-Temples config,
# the model variants of normalization / arch_mode / share_cr, cli profile.
TNT_CONFIG = CVP_CONFIG.parent / "cas_eval_tnt.yaml"
TNT_H, TNT_W, TNT_VIEWS = 1080, 1920, 7  # a T&T frame; 7 views of a scan
# The loader's fit of 1920x1080 into max 1056x1920 at align 32 (mvs_tpu's and
# the reference's rule, one scale for both sides, then each side floored to
# a multiple of 32): 1080 * 1056/1080 = 1056, 1920 * 1056/1080 = 1877 -> 1856.
TNT_SERVED = (1056, 1856)
TNT_FOCAL = 100.0 * TNT_W / 96  # phase 12's focal rule at this width
TNT_STRIDE = 24  # surface points: every 24th pixel of each view's depth
TNT_CROP = (256, 480)
TNT_BATCH = 2
# The variants of 14b: (label, model.name, overrides); card against CPU at
# 128x160 in f32 and bf16 (Point-MVSNet: f32, as mvs_tpu has no other).
VARIANTS = (
    ("CasMVSNet unet", "cas_mvsnet", ["model.arch_mode=unet"]),
    ("CasMVSNet share_cr", "cas_mvsnet", ["model.share_cr=true"]),
    ("CasMVSNet none", "cas_mvsnet", ["model.normalization=none"]),
    ("CasMVSNet group", "cas_mvsnet", ["model.normalization=group"]),
    *((f"{label} {norm}", name, [f"model.normalization={norm}"])
      for label, name in (("MVSNet", "mvsnet"), ("CVP-MVSNet", "cvp_mvsnet"),
                          ("AACVP-MVSNet", "aacvp_mvsnet"),
                          ("Point-MVSNet", "point_mvsnet"))
      for norm in ("group", "none")),
)


def tnt_colmap_scene(work: Path):
    """A make_objects_scene scan at T&T's 1920x1080, 7 views, as a COLMAP
    workspace: PNG images and a text and a binary sparse model whose points
    are the surface under every 24th pixel of each view, each point's track
    the views where it passes the depth test (projected inside the frame
    with a depth within 0.5% of that view's). Returns (scene, {form: dense
    folder})."""
    t0 = time.perf_counter()
    scene = make_objects_scene(num_views=TNT_VIEWS, height=TNT_H, width=TNT_W,
                               focal=TNT_FOCAL, seed=3)
    points = []
    for v in range(TNT_VIEWS):
        ys, xs = np.mgrid[0:TNT_H:TNT_STRIDE, 0:TNT_W:TNT_STRIDE]
        d = scene.depths[v][ys, xs].astype(np.float64)
        ok = d > 0
        pix = np.stack([xs[ok], ys[ok], np.ones(ok.sum())]).astype(np.float64)
        cam = np.linalg.inv(scene.intrinsics[v].astype(np.float64)) @ pix \
            * d[ok]
        e = scene.extrinsics[v].astype(np.float64)
        points.append((e[:3, :3].T @ (cam - e[:3, 3:4])).T)
    points = np.concatenate(points)
    seen = []
    for v in range(TNT_VIEWS):
        e = scene.extrinsics[v].astype(np.float64)
        cam = e[:3, :3] @ points.T + e[:3, 3:4]
        uv = scene.intrinsics[v].astype(np.float64) @ cam
        x, y = np.rint(uv[0] / uv[2]).astype(int), \
            np.rint(uv[1] / uv[2]).astype(int)
        inside = (cam[2] > 0) & (x >= 0) & (x < TNT_W) & (y >= 0) & \
            (y < TNT_H)
        depth = np.zeros(len(points))
        depth[inside] = scene.depths[v][y[inside], x[inside]]
        seen.append(inside & (np.abs(depth - cam[2]) < 5e-3 * cam[2]))
    seen = np.stack(seen, axis=1)
    keep = seen.sum(1) >= 2
    points, tracks = points[keep], [np.nonzero(s)[0].tolist()
                                    for s in seen[keep]]
    names = [f"frame_{v:04d}.png" for v in range(TNT_VIEWS)]
    dense = {}
    for form in ("text", "binary"):
        dense[form] = work / f"colmap_{form}"
        write_colmap_model(dense[form] / "sparse", scene.intrinsics,
                           scene.extrinsics, (TNT_H, TNT_W), points, tracks,
                           names, binary=form == "binary")
    (dense["text"] / "images").mkdir(parents=True)
    for v, name in enumerate(names):
        png_codec.write_png(dense["text"] / "images" / name,
                            (scene.images[v] * 255).astype(np.uint8))
    (dense["binary"] / "images").symlink_to(dense["text"] / "images")
    log(f"  {TNT_VIEWS} views at {TNT_W}x{TNT_H} (focal {TNT_FOCAL:.1f}), "
        f"{len(points)} surface points, tracks of "
        f"{np.mean([len(t) for t in tracks]):.2f} views on average, written "
        f"as COLMAP text and binary models in "
        f"{time.perf_counter() - t0:.2f} s")
    return scene, dense


def tnt_convert(scene, dense: dict, work: Path) -> Path:
    """`python -m mvs_tpu_torch.io.colmap` on both models; the outputs are
    identical, the cams are the scene's, each view's range covers its
    visible GT depths. Returns the eval root (scan 'tnt')."""
    roots = {}
    for form, folder in dense.items():
        roots[form] = work / f"eval_{form}"
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "mvs_tpu_torch.io.colmap",
             "--dense_folder", str(folder), "--save_folder",
             str(roots[form] / "tnt")], cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            fail(f"io.colmap on the {form} model: {out.stderr[-2000:]}")
        log(f"  io.colmap ({form} model): {time.perf_counter() - t0:.2f} s "
            f"in its own process")
    files = {form: {p.relative_to(root): p.read_bytes()
                    for p in root.rglob("*") if p.is_file()}
             for form, root in roots.items()}
    if files["text"] != files["binary"]:
        fail("the text and binary models convert to different files")
    root = roots["text"] / "tnt"
    worst, covered = 0.0, []
    d_served = TNT_SERVED
    for v in range(TNT_VIEWS):
        cam = read_cam_file(root / "cams" / f"{v:08d}_cam.txt")
        for got, want in ((cam.intrinsics, scene.intrinsics[v]),
                          (cam.extrinsics, scene.extrinsics[v])):
            worst = max(worst, float(np.abs(got - want).max()
                                     / np.abs(want).max()))
        gt = scene.depths[v][scene.depths[v] > 0]
        top = cam.depth_min + (LADDER - 1) * cam.depth_interval * 1.06
        covered.append(float(((gt >= cam.depth_min) & (gt <= top)).mean()))
    log(f"  cams against the scene's: largest relative difference "
        f"{worst:.3e} (limit 1e-5); visible GT depths inside each view's "
        f"{LADDER}-hypothesis ladder (interval x 1.06, the config's scale): "
        + ", ".join(f"{c:.4f}" for c in covered)
        + f"; images {sorted(p.name for p in (root / 'images').iterdir())[:2]}"
        f"...; text and binary outputs identical ({len(files['text'])} "
        f"files); served at {d_served[1]}x{d_served[0]}")
    if worst > 1e-5:
        fail("converted cams differ from the scene's")
    # The range is the mean of the nearest 1% and of the farthest 10% of
    # the view's track depths (mvs_tpu's rule), so the farthest few percent
    # of the surface lie beyond it.
    if min(covered) < 0.95:
        fail("a view's depth range misses over 5% of its visible GT depths")
    return roots["text"]


def tnt_infer(root: Path, work: Path, device) -> dict:
    """`cli infer --config configs/cas_eval_tnt.yaml` over the converted
    scan (seeded bf16 weights, batch 2), then ms per map of one batch
    through make_apply_fn (3 synchronised runs) and its peak memory."""
    ckpt = work / "tnt_bf16.pt"
    cfg = load_config(str(TNT_CONFIG), [])
    model = build_model(cfg, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), ckpt)
    (work / "tnt.txt").write_text("tnt\n")
    overrides = [f"data.eval_root={root}",
                 f"data.eval_list={work / 'tnt.txt'}"]
    out = work / "tnt_out"
    reset_counts()
    result = cli_infer.main(["--config", str(TNT_CONFIG), "--ckpt", str(ckpt),
                             "--out", str(out), "--device", str(device),
                             *overrides])
    torch.cuda.synchronize()
    counts = read_counts()
    batches = -(-TNT_VIEWS // TNT_BATCH)
    want = {"warp_variance": 3 * batches, "warp_variance.vector": 3 * batches,
            "warp_variance_grad": 0, "warp_variance_grad.depth": 0,
            "conv3d_affine": 15 * batches, "conv3d_affine.mma": 15 * batches,
            "conv3d_affine.tf32x3": 0, "conv3d_affine.tf32x3_cin64": 0,
            **NO_GROUP}
    log(f"  cli infer: {result['maps']} maps in {result['seconds']:.4f} s "
        f"from disk ({result['maps'] / result['seconds']:.4f} maps/s; the "
        f"first batch's warm-up included), launches {json.dumps(counts)} "
        f"over {batches} batches of {TNT_BATCH}")
    if counts != want:
        fail(f"T&T cli infer launches {counts}, want {want}")
    if result["maps"] != TNT_VIEWS:
        fail(f"T&T cli infer wrote {result['maps']} maps")
    check_files(out / "tnt", TNT_VIEWS, *TNT_SERVED)
    lo = hi = None
    for v in range(TNT_VIEWS):
        depth, _ = read_pfm(out / "tnt" / "depth_est" / f"{v:08d}.pfm")
        cam = read_cam_file(out / "tnt" / "cams" / f"{v:08d}_cam.txt")
        top = cam.depth_min + (LADDER - 1) * cam.depth_interval
        if not (np.isfinite(depth).all() and depth.min() >= cam.depth_min
                - 1e-3 and depth.max() <= top + 1e-3):
            fail(f"T&T map {v} not finite or outside its ladder "
                 f"[{cam.depth_min}, {top}]")
        lo = depth.min() if lo is None else min(lo, depth.min())
        hi = depth.max() if hi is None else max(hi, depth.max())
    ds = DTUEvalDataset(root, ["tnt"], num_views=cfg.data.num_views,
                        num_depth=cfg.data.num_depth,
                        interval_scale=cfg.data.interval_scale,
                        max_h=cfg.data.max_h, max_w=cfg.data.max_w,
                        align=cfg.data.align)
    samples = [ds[0], ds[1]]
    if samples[0]["imgs"].shape[1:3] != TNT_SERVED:
        fail(f"served at {samples[0]['imgs'].shape[1:3]}, want {TNT_SERVED}")
    apply_fn = make_apply_fn(model, device)
    args = stack_model_inputs(samples, device)
    torch.cuda.reset_peak_memory_stats()
    apply_fn(*args)
    reset_counts()
    ms = map_ms(apply_fn, args) / TNT_BATCH
    per_batch = {k: v // 3 for k, v in read_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  bf16 batch {TNT_BATCH} at {TNT_SERVED[1]}x{TNT_SERVED[0]}, "
        f"{cfg.data.num_views} views, {'/'.join(map(str, cfg.model.ndepths))}"
        f" hypotheses: {ms:.2f} ms per map (3 synchronised runs), peak "
        f"{peak:.3f} GiB, launches per batch {json.dumps(per_batch)}; maps "
        f"in [{lo:.4f}, {hi:.4f}], finite, inside their ladders")
    return dict(cli_counts=counts, per_batch=per_batch, ms=ms, peak=peak,
                maps_per_s=result["maps"] / result["seconds"], out=out,
                samples=samples, model=model, overrides=overrides)


def tnt_crop_vs_cpu(tnt: dict, device) -> None:
    """One batch of the T&T model, bf16, at a 256x480 crop of the served
    scene (principal points moved with it): card (kernels) against CPU
    (plain versions), phase 3's limits on each stage's scores, the depth
    (in stage-3 intervals) and the confidence."""
    h, w = TNT_CROP
    y0, x0 = (TNT_SERVED[0] - h) // 2, (TNT_SERVED[1] - w) // 2
    crops = []
    for s in tnt["samples"]:
        c = dict(s)
        c["imgs"] = np.ascontiguousarray(s["imgs"][:, y0:y0 + h, x0:x0 + w])
        c["intrinsics"] = s["intrinsics"].copy()
        c["intrinsics"][:, 0, 2] -= x0
        c["intrinsics"][:, 1, 2] -= y0
        crops.append(c)
    model = tnt["model"]
    scores = []
    hooks = [getattr(model, f"cost_reg_stage{i + 1}").register_forward_hook(
        lambda m, a, out: scores.append(out.float().cpu()))
        for i in range(len(NDEPTHS))]
    t0 = time.perf_counter()
    cpu = [t.float() for t in make_apply_fn(model, "cpu")(
        *stack_model_inputs(crops, "cpu"))]
    cpu_s = time.perf_counter() - t0
    card = [t.float().cpu() for t in make_apply_fn(model, device)(
        *stack_model_inputs(crops, device))]
    model.to(device)
    for hk in hooks:
        hk.remove()
    log(f"  {w}x{h} crop at ({x0}, {y0}), batch {TNT_BATCH}, bf16, card vs "
        f"CPU (CPU {cpu_s:.1f} s)")
    for i in range(3):
        check_scores(f"T&T crop stage{i + 1}", scores[i], scores[3 + i],
                     torch.bfloat16)
    interval = float(crops[0]["depth_values"][1] - crops[0]["depth_values"][0])
    check_depth("T&T crop depth", cpu[0], card[0], interval, torch.bfloat16)
    check_confidence("T&T crop", cpu[1], card[1])


def tnt_fuse(tnt: dict, root: Path, device) -> None:
    t0 = time.perf_counter()
    ply = cli_fuse.main(["--config", str(TNT_CONFIG), "--out",
                         str(tnt["out"]), "--device", str(device),
                         *tnt["overrides"]])[0]
    with open(ply, "rb") as f:
        header = f.read(4096).split(b"end_header")[0].decode("ascii")
    if not header.startswith("ply") or "element vertex" not in header:
        fail(f"{ply}: no PLY header")
    fuse_s = time.perf_counter() - t0
    log(f"  cli fuse (the config's T&T thresholds) {fuse_s:.2f} s: "
        f"{check_cloud(ply)}; header "
        + " | ".join(ln for ln in header.splitlines() if ln.startswith(
            ("format", "element"))))


def phase_tnt(device, work: Path) -> dict:
    log(f"phase 14a: a COLMAP scene through configs/cas_eval_tnt.yaml "
        f"({TNT_W}x{TNT_H}, {TNT_VIEWS} views)")
    scene, dense = tnt_colmap_scene(work)
    root = tnt_convert(scene, dense, work)
    del scene
    tnt = tnt_infer(root, work, device)
    tnt_crop_vs_cpu(tnt, device)
    tnt_fuse(tnt, root, device)
    return tnt


def variant_sample(name):
    """The 128x160, 5-view plane scene of phase 3 (3 views for
    Point-MVSNet, as phase 11b) as the family's stacked inputs."""
    point = name == "point_mvsnet"
    scene = make_plane_scene(num_views=3 if point else VIEWS, height=128,
                             width=160, z0=10.0, tilt=(0.05, 0.02))
    if point:
        return (lambda dev: point_inputs(scene, dev, interval=4.0 / 15),
                4.0 / 15)
    sample = dict(imgs=scene.images, intrinsics=scene.intrinsics,
                  extrinsics=scene.extrinsics,
                  depth_values=np.linspace(8.0, 12.0, 16 if name == "mvsnet"
                                           else LADDER, dtype=np.float32),
                  depth_min=CVP_RANGE[0], depth_max=CVP_RANGE[1])
    family = {"mvsnet": "single", "cas_mvsnet": "cascade"}.get(name,
                                                               "pyramid")
    unit = {"mvsnet": 4.0 / 15, "cas_mvsnet": 4.0 / LADDER}.get(
        name, (CVP_RANGE[1] - CVP_RANGE[0]) / 15)
    return (lambda dev: stack_model_inputs([sample], dev, family), unit)


def variant_config(name, dtype, overrides):
    base = {"cas_mvsnet": ["model.ndepths=48,32,8"],
            "mvsnet": [], "point_mvsnet": ["model.num_depth_coarse=16"]}.get(
        name, ["model.num_levels=3", "model.coarse_depths=16"])
    return load_config(None, [f"model.name={name}",
                              f"model.compute_dtype={str(dtype)[6:]}",
                              *base, *overrides])


def variant_vs_cpu(label, name, overrides, dtype, device) -> dict:
    """One seeded model of a variant, card (kernels) against CPU (plain
    versions): every cost regularizer's scores, the depth and the
    confidence (Point-MVSNet: its coarse and flow depths and
    probabilities, the card on the CPU's kNN graphs). bf16 limits also
    allow the multiples of phase 3 of what one bf16 rounding of the images
    moves the CPU's own outputs (logged), as phase 8b does, and f32 limits
    the same multiples of what one f32 rounding of the images (the larger
    of two sign patterns) moves them: under group norm the finest CVP level
    carries such a rounding to 1e-4-2e-4 of its scores' spread. Without
    normalization the seeded kernels are scaled by sqrt(2) (He's variance
    2 / fan_in), so that the activations keep their scale through the
    ReLUs and the scores have a spread to compare against (at 1 / fan_in
    they shrink to 1e-4 of it). Returns the card run's launches."""
    model = build_model(variant_config(name, dtype, overrides),
                        torch.Generator().manual_seed(7))
    if "model.normalization=none" in overrides:
        with torch.no_grad():
            for key, p in model.named_parameters():
                if key.endswith("kernel"):
                    p.mul_(2.0 ** 0.5)
    make_inputs, unit = variant_sample(name)
    regs = [m for m in model.modules()
            if type(m).__name__ in ("UNetCostRegNet", "PyramidCostRegNet",
                                    "VolumeConv")]
    scores = []
    hooks = [m.register_forward_hook(
        lambda m, a, out: scores.append(out.float().cpu())) for m in regs]
    if name == "point_mvsnet":
        tape = GraphTape()
        with tape.record():
            cpu = point_outputs(model, make_inputs("cpu"), "cpu")
        n = len(scores)
        reset_counts()
        with tape.replay():
            card = point_outputs(model, make_inputs(device), device)
        counts = read_counts()
        for h in hooks:
            h.remove()
        log(f"phase 14b: {label}, f32, card vs CPU (kNN graphs agree at "
            + ", ".join(f"{x:.4f}" for x in tape.shares) + ")")
        for a, b in zip(scores[:n], scores[n:]):
            check_scores(f"{label} coarse", a, b, dtype)
        check_depth(f"{label} coarse depth", cpu["coarse_depth"],
                    card["coarse_depth"], unit, dtype)
        for it, (_, inter) in enumerate(POINT_FLOW):
            key = f"flow{it + 1}"
            check_depth(f"{label} {key}", cpu[key], card[key], inter * unit,
                        dtype)
            check_probs(f"{label} {key} probabilities", cpu[f"{key}_prob"],
                        card[f"{key}_prob"])
        return counts
    inputs = make_inputs("cpu")
    cpu = [t.float() for t in make_apply_fn(model, "cpu")(*inputs)]
    n = len(scores)
    # One rounding of the images in the compute dtype, with one sign
    # pattern in bf16 (phase 8b) and the larger move of two in f32.
    step, patterns = ((2.0 ** -8, 1) if dtype is torch.bfloat16
                      else (2.0 ** -24, 2))
    moved = None
    for seed in range(patterns):
        sign = torch.from_numpy(np.random.default_rng(seed).choice(
            [-1.0, 1.0], size=tuple(inputs[0].shape)).astype(np.float32))
        nudged = [t.float() for t in make_apply_fn(model, "cpu")(
            inputs[0] * (1 + sign * step), *inputs[1:])]
        got = dict(score=[(b - a).abs() / (a.max() - a.min())
                          for a, b in zip(scores[:n], scores[n:])],
                   depth=(nudged[0] - cpu[0]).abs(),
                   conf=(nudged[1] - cpu[1]).abs())
        moved = got if moved is None else {
            k: ([torch.maximum(a, b) for a, b in zip(moved[k], v)]
                if k == "score" else torch.maximum(moved[k], v))
            for k, v in got.items()}
        del scores[n:]
    reset_counts()
    card = [t.float().cpu() for t in make_apply_fn(model, device)(
        *make_inputs(device))]
    torch.cuda.synchronize()
    counts = read_counts()
    for h in hooks:
        h.remove()
    log(f"phase 14b: {label}, {str(dtype)[6:]}, card vs CPU, launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for i, (a, b) in enumerate(zip(scores[:n], scores[n:])):
        check_scores(f"{label} regularizer call {i}", a, b, dtype,
                     moved["score"][i])
    check_depth(f"{label} depth", cpu[0], card[0], unit, dtype,
                moved["depth"])
    check_confidence(label, cpu[1], card[1], moved["conf"])
    return counts


def variant_full_width(device) -> dict:
    """One bf16 CasMVSNet map at configs/cas_eval_dtu.yaml's widths
    (1152x864, 5 views, 48/32/8) with share_cr, unet features and no
    normalization: ms per map, launches (3 warp; the shared U-Net's 15
    convs on the kernel with a unit affine)."""
    cfg = load_config(str(MVS_CONFIG), [
        "model.share_cr=true", "model.arch_mode=unet",
        "model.normalization=none"])
    model = build_model(cfg, torch.Generator().manual_seed(0))
    scene = make_plane_scene(num_views=VIEWS, height=HEIGHT, width=WIDTH,
                             z0=10.0)
    apply_fn = make_apply_fn(model, device)
    args = model_inputs(scene, 1, device)
    apply_fn(*args)
    reset_counts()
    ms = map_ms(apply_fn, args)
    counts = {k: v // 3 for k, v in read_counts().items()}
    want = {"warp_variance": 3, "warp_variance.vector": 3,
            "warp_variance_grad": 0, "warp_variance_grad.depth": 0,
            "conv3d_affine": 15, "conv3d_affine.mma": 15,
            "conv3d_affine.tf32x3": 0, "conv3d_affine.tf32x3_cin64": 0,
            **NO_GROUP}
    depth = apply_fn(*args)[0]
    log(f"phase 14b: CasMVSNet share_cr + unet + none, bf16, {WIDTH}x"
        f"{HEIGHT}: {ms:.2f} ms per map, launches {json.dumps(counts)}; "
        f"depth finite {bool(torch.isfinite(depth).all())}")
    if counts != want:
        fail(f"share_cr + unet + none launches {counts}, want {want}")
    if not torch.isfinite(depth).all():
        fail("share_cr + unet + none map not finite")
    return dict(ms=ms, counts=counts)


def variant_cli_train(device, work: Path) -> dict:
    """3 `cli train` steps of CasMVSNet under group norm with
    MVS_TPU_DEBUG_NANS=1: finite losses, and the val panel PNG written."""
    root = generate(work / "gn_dtu", num_scans=2, num_views=3, height=128,
                    width=160, num_depth=LADDER, num_lights=1,
                    tilt=SCAN_TILT)
    saved = os.environ.get("MVS_TPU_DEBUG_NANS")
    os.environ["MVS_TPU_DEBUG_NANS"] = "1"
    reset_counts()
    try:
        result = cli_train.main([
            "--device", str(device), "model.normalization=group",
            "model.ndepths=48,32,8", "data.num_views=3",
            f"data.num_depth={LADDER}", f"data.root={root}",
            f"data.train_list={root}/lists/train.txt",
            f"data.val_list={root}/lists/val.txt", "data.batch_size=1",
            "train.epochs=1", "train.summary_every_steps=1",
            f"train.log_dir={work / 'gn_run'}"])
    finally:
        if saved is None:
            del os.environ["MVS_TPU_DEBUG_NANS"]
        else:
            os.environ["MVS_TPU_DEBUG_NANS"] = saved
    torch.cuda.synchronize()
    counts = read_counts()
    panels = sorted((work / "gn_run" / "images").glob("val_depth_*.png"))
    log(f"phase 14b: cli train, CasMVSNet group norm, MVS_TPU_DEBUG_NANS=1: "
        f"{result['step']} steps, losses "
        + " ".join(f"{x:.4f}" for x in result["losses"])
        + f", val {json.dumps(result['val'])}, panel "
        f"{[p.name for p in panels]} "
        f"{png_codec.read_png(panels[0]).shape if panels else None}, "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    if result["step"] != 3 or not np.isfinite(result["losses"]).all():
        fail("group-norm cli train did not take 3 finite steps")
    if not panels:
        fail("cli train wrote no val panel")
    if torch.is_anomaly_enabled():
        fail("anomaly detection left on after cli train")
    return counts


def phase_variants(device, work: Path) -> dict:
    counts = {}
    for label, name, overrides in VARIANTS:
        dtypes = (torch.float32,) if name == "point_mvsnet" else (
            torch.float32, torch.bfloat16)
        for dtype in dtypes:
            counts[label, dtype] = variant_vs_cpu(label, name, overrides,
                                                  dtype, device)
    for label in ("CasMVSNet none", "CasMVSNet share_cr"):
        got = counts[label, torch.bfloat16]
        if got["conv3d_affine.mma"] != 15 or got["warp_variance"] != 3:
            fail(f"{label} bf16 launches {got}: want 15 tensor-core convs "
                 f"and 3 warps")
    full = variant_full_width(device)
    cli = variant_cli_train(device, work)
    return dict(counts=counts, full=full, cli=cli)


def phase_profile(device, work: Path) -> dict:
    """`cli profile` forward and --train on the card: the trace is written
    and the table names the warp-variance and conv3d kernels (the forward)
    and the warp's backward (the train step)."""
    out = {}
    for train in (False, True):
        logdir = work / f"profile_{'train' if train else 'forward'}"
        log(f"phase 14c: cli profile{' --train' if train else ''}")
        result = cli_profile.main(["--device", str(device), "--steps", "5",
                                   "--warmup", "3", "--logdir", str(logdir)]
                                  + (["--train"] if train else []))
        table = "\n".join(result["table"])
        want = ("warp_variance_grad",) if train else ("warp_variance",
                                                      "conv3d")
        if not Path(result["trace"]).stat().st_size:
            fail("cli profile wrote an empty trace")
        if not all(k in table for k in want):
            fail(f"cli profile's table names none of {want}")
        out[train] = result["ms_per_step"]
    return out

# ---- phase 15: the cost volumes split over depth slabs and row tiles -------

# The meshes of 15b, each the configurations' only model axes: the ranks
# share the card over gloo (and with as many cards, a card a rank, NCCL).
VOLUME_MESHES = (dict(depth=2), dict(space=2), dict(depth=2, space=2))
VOLUME_NAMES = ("cas_mvsnet", "mvsnet", "mvsnet_f32")


def slab_of(x, dims, index):
    """x sliced to slab `index` of 2 (slab_bounds) along each of `dims`."""
    sl = [slice(None)] * x.ndim
    for d in dims:
        a, b = slab_bounds(x.shape[d], 2, index)
        sl[d] = slice(a, b)
    return x[tuple(sl)]


def halo_slab(x, index):
    """Slab `index` of 2 of a (B, D, H, W, C) volume along D and H, with one
    plane of each neighbour's (zeros past the volume's ends): what a
    depth=2 x space=2 rank's halo exchange gives it."""
    padded = F.pad(x, (0, 0, 0, 0, 1, 1, 1, 1))
    sl = [slice(None)] * 5
    for d in (1, 2):
        a, b = slab_bounds(x.shape[d], 2, index)
        sl[d] = slice(a, b + 2)
    return padded[tuple(sl)].contiguous()


def phase_slab_kernels(device) -> dict:
    """15a: the kernels on one rank's slab at CasMVSNet's 640x512 batch-4
    train stages (bf16): the warp forward and backward on the row window
    (the second half of the rows, the second depth slab where D splits)
    against the whole volume's launch's rows and the plain version on the
    slab; the fused conv3d (stage-1 regularizer's first block, eval) on a
    halo-extended slab, cropped, against the whole volume's rows and the
    plain version on the extended slab. Each with its ms beside the whole
    volume's launch."""
    log("phase 15a: the warp's row window and the conv3d on a halo-extended "
        "slab at 640x512, batch 4, bf16")
    scene = make_plane_scene(num_views=VIEWS, height=TRAIN_H, width=TRAIN_W,
                             z0=10.0, tilt=SCAN_TILT)
    rows = {"warp": [], "warp_grad": [], "conv": []}
    dt = torch.bfloat16
    for (stage, scale, c), d in zip(STAGES, NDEPTHS):
        ref, src, rel, hyp = warp_inputs(scene, stage, scale, c, d, dt,
                                         device, batch=TRAIN_BATCH,
                                         height=TRAIN_H, width=TRAIN_W)
        h = hyp.shape[2]
        r0, r1 = slab_bounds(h, 2, 1)
        d0, d1 = slab_bounds(d, 2, 1) if d >= 16 else (0, d)
        sref = ref[:, r0:r1].contiguous()
        shyp = hyp[:, d0:d1, r0:r1].contiguous()
        whole = fused_variance_volume(ref, src, rel, hyp)
        got = fused_variance_volume(sref, src, rel, shyp, row0=r0)
        same = torch.equal(got, whole[:, d0:d1, r0:r1])
        what = (f"stage {stage} warp on rows {r0}:{r1}, depths {d0}:{d1} of "
                f"({d}, {h}, {hyp.shape[3]}), C={c}")
        err = compare("warp", got, fused_variance_volume_plain(
            sref, src, rel, shyp, r0), what)
        ms = cuda_ms(lambda: fused_variance_volume(sref, src, rel, shyp,
                                                   row0=r0))
        whole_ms = cuda_ms(lambda: fused_variance_volume(ref, src, rel, hyp))
        b, nv = ref.shape[0], src.shape[1]
        bytes_ms, ops_ms = warp_bound(b, nv, d1 - d0, r1 - r0, hyp.shape[3],
                                      c, 2)
        log(f"    the whole volume's rows bit for bit: {same}; {ms:.4f} ms "
            f"against the whole volume's {whole_ms:.4f} ms (bound "
            f"{max(bytes_ms, ops_ms):.4f})")
        if not same:
            fail(f"15a {what}: the row window differs from the whole "
                 f"volume's rows")
        rows["warp"].append(dict(err=err, ms=ms, whole_ms=whole_ms,
                                 bytes_ms=bytes_ms, ops_ms=ops_ms))
        g = torch.randn(got.shape, generator=torch.Generator(
            device="cpu").manual_seed(stage)).to(device, dt)
        kern = fused_variance_volume_grad(g, sref, src, rel, shyp, row0=r0)
        plain = fused_variance_volume_grad_plain(g, sref, src, rel, shyp,
                                                 False, r0)
        errs = [compare("warp_grad", k, p, f"stage {stage} {n} of the row "
                        f"window") for n, k, p in zip(("dref", "dsrc"), kern,
                                                      plain)]
        gms = cuda_ms(lambda: fused_variance_volume_grad(
            g, sref, src, rel, shyp, row0=r0), iters=5)
        rows["warp_grad"].append(dict(err=max(errs), ms=gms))
        log(f"    backward on the row window {gms:.4f} ms")
        del whole, got, kern, plain, g
    gen = torch.Generator(device="cpu").manual_seed(15)
    c, cout = STAGES[0][2], BASE
    x = torch.randn((TRAIN_BATCH, NDEPTHS[0], TRAIN_H // 4, TRAIN_W // 4, c),
                    generator=gen).to(device, dt)
    wt = (torch.randn((cout, c, 3, 3, 3), generator=gen)
          / (27 * c) ** 0.5).to(device)
    sc = torch.rand(cout, generator=gen).to(device) + 0.5
    sh = torch.randn(cout, generator=gen).to(device) * 0.1
    whole = conv3d_affine(x, wt, sc, sh, True)
    ext = halo_slab(x, 1)
    got = conv3d_affine(ext, wt, sc, sh, True)[:, 1:-1, 1:-1]
    want_rows = slab_of(slab_of(whole, (1,), 1), (2,), 1)
    same = torch.equal(got, want_rows)
    err = compare("conv", got, conv3d_affine_plain(ext, wt, sc, sh, True)[
        :, 1:-1, 1:-1], f"conv3d {c}->{cout} on the halo-extended slab "
        f"{tuple(ext.shape[1:4])} of {tuple(x.shape[1:4])}")
    ms = cuda_ms(lambda: conv3d_affine(ext, wt, sc, sh, True))
    whole_ms = cuda_ms(lambda: conv3d_affine(x, wt, sc, sh, True))
    bytes_ms, ops_ms = conv_bound(*ext.shape[:4], c, cout, dt)
    log(f"    the whole volume's rows bit for bit: {same}; {ms:.4f} ms "
        f"against the whole volume's {whole_ms:.4f} ms (bound "
        f"{max(bytes_ms, ops_ms):.4f})")
    if not same:
        fail("15a: the conv3d on the extended slab differs from the whole "
             "volume's rows")
    rows["conv"].append(dict(err=err, ms=ms, whole_ms=whole_ms,
                             bytes_ms=bytes_ms, ops_ms=ops_ms))
    return rows


def phase_volume_steps(device, work: Path, reference: dict) -> dict:
    """15b: 13b's configurations on the VOLUME_MESHES, against 13b's one
    process (`reference`): 13b's limits (check_ranks), and each rank's
    warp launches a step equal to one process's (slabs, not duplicates).
    Returns {mesh: the ranks' results}."""
    out = {}
    for mesh in VOLUME_MESHES:
        world = int(np.prod(list(mesh.values())))
        label = "x".join(f"{k}={v}" for k, v in mesh.items())
        got = phase_parallel_steps(
            device, work, names=VOLUME_NAMES, world=world,
            meshes=dict.fromkeys(VOLUME_NAMES, mesh), reference=reference,
            label=f"15b {label}")
        for layout, ranks in got["layouts"].items():
            for name in VOLUME_NAMES:
                want = reference["single"][name]["counts"]
                for r, rank in enumerate(ranks):
                    c = rank[name]["counts"]
                    keys = ("warp_variance", "warp_variance_grad")
                    if any(c[k] != want[k] for k in keys):
                        fail(f"15b {name} {label} ({layout}) rank {r}: "
                             f"launches {c}, one process {want}")
            log(f"  {label} ({layout}): every rank's warp launches a step "
                f"as one process's: " + ", ".join(
                    f"{n} {reference['single'][n]['counts']['warp_variance']}"
                    f" + {reference['single'][n]['counts']['warp_variance_grad']}"
                    for n in VOLUME_NAMES))
        out[label] = got["ranks"]
    return out


def cli_rank(argv) -> int:
    """One rank of 15c (chip_smoke.py --cli-rank <cli train arguments>):
    cli train, then this rank's kernel launches and peak memory."""
    reset_counts()
    cli_train.main(argv)
    torch.cuda.synchronize()
    print("launches " + json.dumps(read_counts()), flush=True)
    print(f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    return 0


def phase_volume_cli(device, work: Path) -> dict:
    """15c: cli train (configs/cas_train_dtu.yaml, bf16) over depth=2 x
    space=2 ranks sharing the card (gloo), 2 steps and validation (the
    conv3d kernel on halo-extended slabs in eval mode) on 13c's training
    layout, each rank's launches as one process's; 15d: cli profile
    --train over 8 ranks (parallel.dryrun's step: view, space, depth 2
    each), a trace per rank."""
    log("phase 15c: cli train over depth=2 x space=2 ranks sharing the card "
        "(gloo), 2 steps with validation")
    root = generate(work / "vdtu", num_scans=2, num_views=VIEWS,
                    height=TRAIN_H // 2, width=TRAIN_W // 2, num_depth=LADDER,
                    num_lights=1, tilt=SCAN_TILT)
    argv = ["--config", str(MVS_TRAIN_CONFIG), "--device", str(device),
            f"data.root={root}", f"data.train_list={root}/lists/train.txt",
            f"data.val_list={root}/lists/val.txt", "data.batch_size=2",
            "train.epochs=1", "train.summary_every_steps=1",
            "train.mesh_depth=2", "train.mesh_space=2",
            f"train.log_dir={work / 'vrun'}"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    here = Path(__file__).resolve()
    t0 = time.perf_counter()
    ranks = launch_local([sys.executable, str(here), "--cli-rank", *argv], 4,
                         400.0, cwd=here.parent, env=env)
    seconds = time.perf_counter() - t0
    # 2 steps of 3 + 3 warp launches; val 2 batches of 3 warp and 15 conv
    # launches (eval mode, bf16), every rank on its slabs.
    want = {"warp_variance": 12, "warp_variance_grad": 6,
            "conv3d_affine": 30, "conv3d_affine.mma": 30}
    counts = []
    for r, (rc, out) in enumerate(ranks):
        if rc != 0:
            fail(f"15c rank {r} exited {rc}:\n{out[-3000:]}")
        got = json.loads(out.split("launches ", 1)[1].splitlines()[0])
        counts.append(got)
        if any(got[k] != v for k, v in want.items()):
            fail(f"15c rank {r}: launches {got}, want {want}")
    lead = ranks[0][1]
    log("  " + "; ".join(ln for ln in lead.splitlines() if ln.startswith((
        "mesh", "volumes", "epoch", "peak")))
        + f"; {seconds:.1f} s with start-up; launches a rank "
        f"{json.dumps(counts[0])}; peaks "
        + " / ".join(out.rsplit("peak ", 1)[1].split()[0] for _, out in ranks)
        + " GiB")
    if "volumes (B, 48, 64, 80, C): spec (None, 'depth', 'space'" not in lead:
        fail("15c: rank 0 did not say the stage-1 volume's layout")

    log("phase 15d: cli profile --train over 8 ranks sharing the card")
    logdir = work / "vprofile"
    t0 = time.perf_counter()
    ranks = launch_local([sys.executable, "-m", "mvs_tpu_torch.cli",
                          "profile", "--train", "--device", str(device),
                          "--steps", "2", "--warmup", "1", "--logdir",
                          str(logdir)], 8, 400.0, cwd=here.parent,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    for r, (rc, out) in enumerate(ranks):
        if rc != 0:
            fail(f"15d rank {r} exited {rc}:\n{out[-3000:]}")
    lead = ranks[0][1]
    line = next((ln for ln in lead.splitlines()
                 if ln.startswith("dryrun:")), "")
    traces = sorted(p.name for p in logdir.glob("trace_rank*.json"))
    log(f"  {line}; {len(traces)} traces; {time.perf_counter() - t0:.1f} s; "
        + next((ln for ln in lead.splitlines() if "ms/step" in ln), ""))
    if "mesh=(data=1,view=2,depth=2,space=2)" not in line or \
            len(traces) != 8 or "warp_variance" not in lead:
        fail(f"15d: cli profile --train over 8 ranks: {lead[-3000:]}")
    return dict(counts=counts[0])


def phase_volume(device, work: Path, reference: dict) -> dict:
    t0 = time.perf_counter()
    rows = phase_slab_kernels(device)
    steps = phase_volume_steps(device, work, reference)
    cli = phase_volume_cli(device, work)
    log(f"  phase 15 {time.perf_counter() - t0:.1f} s")
    return dict(rows=rows, steps=steps, cli=cli)



def kernel_entry(name, source, replaces, rows, launches, cli_launches,
                 library, **extra):
    """Times and bounds are sums over one bf16 map's launches (phase 2; 7a
    for the backward: one train step's three; 8a for the group correlation:
    an AACVP map's five, f32 as its bf16 model feeds them, and for the
    3xTF32 conv: its ten f32 launches; 10a for the group correlation's
    backward: one AACVP train step's two, f32); launches are per map (phase
    4, 8c) or per train step (7c, 10c), cli_launches over phase 6b's 11
    maps, 7d's cli train run, 8d's 6 maps or 10d's AACVP cli train run."""
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "cli_launches": cli_launches,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in rows),
        "bound_by": ("bytes" if sum(r["bytes_ms"] for r in rows)
                     >= sum(r["ops_ms"] for r in rows) else "operations"),
        "library_ms": (sum(r["library_ms"] for r in rows) if library
                       else None),
        **extra,
    }


def partial_entry(name, mvs_rows, rows, key, launches, **extra):
    """The kernels line's entry of a partial-moment kernel (`key` "" the
    forward, "grad_" the backward): kernel_entry over view rank 0's bf16
    launch at MVSNet view=2's shape, beside view rank 1's, both ranks' in
    f32 and the CasMVSNet stages' sums (13a)."""
    def row(r):
        return dict(err=r["err"], ms=r[f"{key}ms"],
                    plain_ms=r[f"{key}plain_ms"],
                    bytes_ms=r[f"{key}bytes_ms"], ops_ms=r[f"{key}ops_ms"])

    def labelled(prefix, picked):
        got = kernel_entry(name, "", "", picked, 0, None, library=False)
        return {f"{prefix}{k}": got[k] for k in (
            "ms", "plain_ms", "bound_ms", "max_abs_err")}

    return kernel_entry(
        name, "mvs_tpu_torch/csrc/warp_variance.cu", PARTIAL_REPLACES,
        [row(mvs_rows[torch.bfloat16, 0])], launches, None, library=False,
        **labelled("view_rank1_", [row(mvs_rows[torch.bfloat16, 1])]),
        **labelled("f32_view_rank0_", [row(mvs_rows[torch.float32, 0])]),
        **labelled("f32_view_rank1_", [row(mvs_rows[torch.float32, 1])]),
        **labelled("cas_train_", [row(r) for r in rows["cas"]]), **extra)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    device = resolve_device()
    t_script = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    t_start = time.perf_counter()

    def timed(n, result):
        log(f"  phase {n} done, {time.perf_counter() - t_start:.1f} s since "
            f"the build")
        return result

    scene = make_plane_scene(num_views=VIEWS, height=HEIGHT, width=WIDTH,
                             z0=10.0)
    warp_rows = phase_warp(scene, device)
    conv_rows, cas_cin64_rows = timed(2, phase_conv(device))
    timed(3, phase_model_vs_cpu(device))
    cas_counts, apply_ms = timed(4, phase_full_width(scene, device))
    launches = cas_counts[torch.bfloat16]
    timed(5, phase_batched(scene, device))
    cli_launches, oracle = timed(6, phase_user_path(device, apply_ms))
    grad_rows, train_counts, cli_train_counts = timed(
        7, phase_training(device))
    del scene
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        group_rows, tf32_rows, cvp_cin64_rows, cvp_full, cvp_cli, \
            scan_root = timed(8, phase_cvp(device, work))
        mvs = timed(9, phase_mvsnet(device, scan_root, work))
        pyr = timed(10, phase_cvp_training(device, work, grad_rows))
        point = timed(11, phase_point(device, scan_root, work))
        timed(12, phase_matrix(device, work))
    timed("12b", phase_eval_scale(oracle))
    del oracle
    with tempfile.TemporaryDirectory() as tmp:
        par = timed(13, phase_parallel(device, Path(tmp)))
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        tnt = timed("14a", phase_tnt(device, work))
        var = timed("14b", phase_variants(device, work))
        timed("14c", phase_profile(device, work))
    with tempfile.TemporaryDirectory() as tmp:
        vol = timed(15, phase_volume(device, Path(tmp), par))
    del tnt["model"], tnt["samples"]
    view_counts = par["ranks"][0]["mvsnet"]["counts"]
    mvs_partials = par["rows"]["mvsnet"]

    cvp, aacvp = cvp_full["cvp_mvsnet"][0], cvp_full["aacvp_mvsnet"][0]
    mvs_map = mvs["full"][torch.bfloat16][0]

    def at_mvsnet(row):
        """One launch at MVSNet's shape (9a): its times and bound."""
        return dict(mvsnet_ms=row["ms"], mvsnet_plain_ms=row["plain_ms"],
                    mvsnet_bound_ms=max(row["bytes_ms"], row["ops_ms"]),
                    mvsnet_max_abs_err=row["err"])

    def on_dtu_rig(rows, prefix=""):
        """The rows' launches on the DTU-like rig: ms and largest error."""
        return {f"dtu_rig_{prefix}ms": sum(r["dtu_ms"] for r in rows),
                f"dtu_rig_{prefix}max_abs_err": max(r["dtu_err"]
                                                    for r in rows)}

    def pyramid_training(key):
        """The kernel's launches per CVP / AACVP train step (10c) and
        through their cli train runs (10d)."""
        return {f"{short}_{run}_launches": pyr[src][name][key]
                for short, name in (("cvp", "cvp_mvsnet"),
                                    ("aacvp", "aacvp_mvsnet"))
                for run, src in (("train", "train"), ("cli_train", "cli"))}

    step_rows = pyr["rows"]["warp"]

    def at_point(key):
        """The kernel's launches per Point-MVSNet map (11c, flow stride 4),
        per train step (11e) and through 11d's and 11f's CLI runs."""
        return dict(point_launches=point["full"][4][0][key],
                    point_train_launches=point["train"][key],
                    point_cli_launches=point["cli"][key],
                    point_cli_train_launches=point["cli_train"][key])

    def row_sums(rows, prefix):
        """Sums over the rows' launches (11a: Point-MVSNet's; 2b, 8a, 9a:
        an f32 map's convs at Cin = 64), with the library's time and the f32
        CUDA-core bound where the rows have them."""
        sums = {f"{prefix}_ms": sum(r["ms"] for r in rows),
                f"{prefix}_plain_ms": sum(r["plain_ms"] for r in rows),
                f"{prefix}_bound_ms": sum(max(r["bytes_ms"], r["ops_ms"])
                                          for r in rows),
                f"{prefix}_max_abs_err": max(r["err"] for r in rows)}
        if all("library_ms" in r for r in rows):
            sums[f"{prefix}_library_ms"] = sum(r["library_ms"] for r in rows)
        if all("f32_ops_ms" in r for r in rows):
            sums[f"{prefix}_f32_cuda_core_bound_ms"] = sum(
                max(r["bytes_ms"], r["f32_ops_ms"]) for r in rows)
        return sums

    cin64 = "conv3d_affine.tf32x3_cin64"
    cin64_rows = point["rows"]["cin64"]

    def at_tnt(key):
        """The kernel's launches per T&T batch of 2 (14a, make_apply_fn),
        through 14a's cli infer (4 batches), per bf16 map of CasMVSNet
        share_cr + unet + none at 1152x864 and through 14b's group-norm
        cli train run (3 steps, 3 val batches)."""
        return dict(tnt_launches=tnt["per_batch"][key],
                    tnt_cli_launches=tnt["cli_counts"][key],
                    share_cr_unet_none_launches=var["full"]["counts"][key],
                    group_cli_train_launches=var["cli"][key])

    def on_slabs(key, rows=None, prefix="row_window"):
        """15's figures of a kernel: per train step of a rank of each 15b
        mesh (bf16 CasMVSNet and MVSNet, f32 MVSNet), and the sums over
        15a's slab launches (`rows`) beside the whole volume's."""
        out = {f"{short}_{m.replace('=', '')}_train_launches":
               vol["steps"][m][0][name]["counts"][key]
               for m in vol["steps"] for short, name in (
                   ("cas", "cas_mvsnet"), ("mvsnet", "mvsnet"),
                   ("mvsnet_f32", "mvsnet_f32"))}
        if rows:
            out.update({f"{prefix}_ms": sum(r["ms"] for r in rows),
                        f"{prefix}_max_abs_err": max(r["err"] for r in rows)})
            if "whole_ms" in rows[0]:
                out.update({
                    f"{prefix}_whole_ms": sum(r["whole_ms"] for r in rows),
                    f"{prefix}_bound_ms": sum(max(r["bytes_ms"], r["ops_ms"])
                                              for r in rows)})
        return out

    kernels = [
        kernel_entry("warp_variance", "mvs_tpu_torch/csrc/warp_variance.cu",
                     "mvs_tpu/ops/warp_pallas.py:288", warp_rows,
                     launches["warp_variance"],
                     cli_launches["warp_variance"], library=False,
                     cvp_launches=cvp["warp_variance"],
                     cvp_cli_launches=cvp_cli["cvp_mvsnet"]["warp_variance"],
                     mvsnet_launches=mvs_map["warp_variance"],
                     mvsnet_train_launches=mvs["train"]["warp_variance"],
                     mvsnet_cli_launches=mvs["cli"]["warp_variance"],
                     **at_mvsnet(mvs["rows"]["warp"]),
                     **pyramid_training("warp_variance"),
                     **at_point("warp_variance"), **at_tnt("warp_variance"),
                     # One f32 Point-MVSNet map's 7 launches (11a).
                     **row_sums(point["rows"]["warp"], "point"),
                     # A depth=2 x space=2 rank's three row-window launches
                     # of a bf16 CasMVSNet train step (15a), 15b's launches
                     # a step and 15c's cli train's a rank.
                     **on_slabs("warp_variance", vol["rows"]["warp"]),
                     volume_cli_launches=vol["cli"]["counts"][
                         "warp_variance"]),
        kernel_entry("conv3d_affine", "mvs_tpu_torch/csrc/conv3d_affine.cu",
                     "mvs_tpu/ops/conv3d_pallas.py:259", conv_rows,
                     launches["conv3d_affine"],
                     cli_launches["conv3d_affine"], library=True,
                     cvp_launches=cvp["conv3d_affine"],
                     cvp_cli_launches=cvp_cli["cvp_mvsnet"]["conv3d_affine"],
                     aacvp_launches=aacvp["conv3d_affine"],
                     mvsnet_launches=mvs_map["conv3d_affine"],
                     mvsnet_cli_launches=mvs["cli"]["conv3d_affine"],
                     **pyramid_training("conv3d_affine"),
                     **at_point("conv3d_affine"), **at_tnt("conv3d_affine"),
                     none_bf16_launches=var["counts"][
                         "CasMVSNet none", torch.bfloat16]["conv3d_affine"],
                     # The stage-1 block on a depth=2 x space=2 rank's
                     # halo-extended slab (15a); 15c's validation's
                     # launches a rank.
                     **on_slabs("conv3d_affine", vol["rows"]["conv"],
                                "halo_slab"),
                     volume_cli_launches=vol["cli"]["counts"][
                         "conv3d_affine"]),
        # The f32 variant of the same implicit GEMM (3xTF32): times over
        # AACVP's 10 f32 launches of a bf16 map (8a), library cuDNN f32 with
        # TF32 off; bound_ms is the larger of the bytes' time and the three
        # TF32 products' at the tensor-core rate, launch by launch;
        # f32_cuda_core_bound_ms the same with the f32 work at the CUDA
        # cores' rate. launches: per AACVP bf16 map (8c); cli_launches: 8d's
        # AACVP run.
        kernel_entry("conv3d_affine.tf32x3",
                     "mvs_tpu_torch/csrc/conv3d_affine.cu",
                     "mvs_tpu/ops/conv3d_pallas.py:259", tf32_rows,
                     aacvp["conv3d_affine.tf32x3"],
                     cvp_cli["aacvp_mvsnet"]["conv3d_affine.tf32x3"],
                     library=True,
                     f32_cuda_core_bound_ms=sum(
                         max(r["bytes_ms"], r["f32_ops_ms"])
                         for r in tf32_rows),
                     bytes_bound_ms=sum(r["bytes_ms"] for r in tf32_rows),
                     mvsnet_f32_launches=mvs["full"][torch.float32][0][
                         "conv3d_affine.tf32x3"],
                     **pyramid_training("conv3d_affine.tf32x3"),
                     **at_point("conv3d_affine.tf32x3")),
        # The 3xTF32 kernel at Cin = 64: times over Point-MVSNet's two
        # VolumeConv convs (64->8 at 96x120x160, 64->64 at 12x15x20; 11a),
        # library cuDNN f32 with TF32 off, bounds as the 3xTF32 entry's;
        # cvp_*: the same over an f32 CVP / AACVP map's 15 (8a), cas_*: over
        # an f32 CasMVSNet map's 3 (2b), mvsnet_*: over an f32 MVSNet map's
        # 1 (9a). launches: per Point-MVSNet map
        # (11c); cli_launches: 11d's run; {cvp,aacvp,cas,mvsnet}_f32_launches:
        # per f32 map (8c, 4, 9c).
        kernel_entry(cin64, "mvs_tpu_torch/csrc/conv3d_affine.cu",
                     "mvs_tpu/ops/conv3d_pallas.py:259", cin64_rows,
                     point["full"][4][0][cin64], point["cli"][cin64],
                     library=True,
                     f32_cuda_core_bound_ms=sum(
                         max(r["bytes_ms"], r["f32_ops_ms"])
                         for r in cin64_rows),
                     bytes_bound_ms=sum(r["bytes_ms"] for r in cin64_rows),
                     **row_sums(cvp_cin64_rows, "cvp"),
                     **row_sums(cas_cin64_rows, "cas"),
                     **row_sums(mvs["rows"]["cin64"], "mvsnet"),
                     cvp_f32_launches=cvp_full[("cvp_mvsnet",
                                                torch.float32)][cin64],
                     aacvp_f32_launches=cvp_full[("aacvp_mvsnet",
                                                  torch.float32)][cin64],
                     cas_f32_launches=cas_counts[torch.float32][cin64],
                     mvsnet_f32_launches=mvs["full"][torch.float32][0][cin64],
                     **pyramid_training(cin64), **at_point(cin64)),
        # The backward has no Pallas counterpart (JAX trains through XLA's
        # gather path); it is the gradient of the kernel above. launches:
        # per train step (7c); cli_launches: 7d's cli train run.
        kernel_entry("warp_variance_grad",
                     "mvs_tpu_torch/csrc/warp_variance.cu",
                     "mvs_tpu/ops/warp_pallas.py:288", grad_rows,
                     train_counts["warp_variance_grad"],
                     cli_train_counts["warp_variance_grad"], library=False,
                     mvsnet_train_launches=mvs["train"]["warp_variance_grad"],
                     mvsnet_cli_train_launches=mvs["cli_train"][
                         "warp_variance_grad"],
                     **at_mvsnet(mvs["rows"]["warp_grad"]),
                     **on_dtu_rig(grad_rows),
                     **on_dtu_rig([mvs["rows"]["warp_grad"]], "mvsnet_"),
                     **on_dtu_rig(step_rows, "cvp_train_"),
                     **pyramid_training("warp_variance_grad"),
                     cvp_train_depth_launches=pyr["train"]["cvp_mvsnet"][
                         "warp_variance_grad.depth"],
                     # One CVP train step's two bf16 launches (10a), the
                     # finer level's with the hypotheses' gradient.
                     cvp_train_ms=sum(r["ms"] for r in step_rows),
                     cvp_train_plain_ms=sum(r["plain_ms"] for r in step_rows),
                     cvp_train_bound_ms=sum(max(r["bytes_ms"], r["ops_ms"])
                                            for r in step_rows),
                     cvp_train_max_abs_err=max(r["err"] for r in step_rows),
                     **at_point("warp_variance_grad"),
                     group_cli_train_launches=var["cli"]["warp_variance_grad"],
                     point_train_depth_launches=point["train"][
                         "warp_variance_grad.depth"],
                     # One f32 Point-MVSNet train step's 7 launches, the
                     # flow's 6 with the hypotheses' gradient (11a).
                     **row_sums(point["rows"]["warp_grad"],
                                "point_train"),
                     **on_slabs("warp_variance_grad",
                                vol["rows"]["warp_grad"]),
                     volume_cli_launches=vol["cli"]["counts"][
                         "warp_variance_grad"]),
        # No pallas_call of its own: the counterpart of the fused
        # group-correlation mode of the banded warp (hat_warp.py:413-417,
        # 477). launches: per AACVP map (8c); cli_launches: 8d's AACVP run.
        kernel_entry("group_correlation",
                     "mvs_tpu_torch/csrc/group_correlation.cu",
                     "mvs_tpu/ops/hat_warp.py:413", group_rows,
                     aacvp["group_correlation"],
                     cvp_cli["aacvp_mvsnet"]["group_correlation"],
                     library=False, **pyramid_training("group_correlation"),
                     **at_point("group_correlation")),
        # The group correlation's backward (none in JAX, which autodiffs
        # the gather path): times over one AACVP train step's two f32
        # launches (10a), the finer level's with the hypotheses' gradient;
        # launches per AACVP train step (10c), cli_launches: 10d's run.
        kernel_entry("group_correlation_grad",
                     "mvs_tpu_torch/csrc/group_correlation.cu",
                     "mvs_tpu/ops/cost_volume.py:94", pyr["rows"]["group"],
                     pyr["train"]["aacvp_mvsnet"]["group_correlation_grad"],
                     pyr["cli"]["aacvp_mvsnet"]["group_correlation_grad"],
                     library=False, **on_dtu_rig(pyr["rows"]["group"]),
                     **pyramid_training("group_correlation_grad"),
                     aacvp_train_depth_launches=pyr["train"]["aacvp_mvsnet"][
                         "group_correlation_grad.depth"],
                     **at_point("group_correlation_grad")),
        # The warp's partial-moment variant (13a): times, bound and error
        # of one launch at 13b's MVSNet view=2 inputs on view rank 0 (bf16,
        # batch 4, D = 192, 160x128, C = 32, one source view and the
        # reference), view_rank1_* the same without the reference, f32_*
        # both ranks in f32, cas_* over one view rank's three launches of a
        # bf16 CasMVSNet train step (640x512, batch 4, 2 of the 4 sources
        # and the reference); launches: per train step of view rank 0 of
        # 13b's bf16 MVSNet view=2 run (counts zeroed just before its
        # second step).
        partial_entry("warp_variance_partials", mvs_partials, par["rows"],
                      "", view_counts["warp_variance_partials"],
                      vector_launches=view_counts[
                          "warp_variance_partials.vector"]),
        partial_entry("warp_variance_partials_grad", mvs_partials,
                      par["rows"], "grad_",
                      view_counts["warp_variance_partials_grad"],
                      depth_launches=view_counts[
                          "warp_variance_partials_grad.depth"]),
    ]
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s from the card "
        f"check to the kernels line")
    log(smi.stdout.strip())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank(sys.argv[2:]))
    sys.exit(main())
