#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port: its serving path (eager and
as a CUDA graph), its training step, mesh extraction, the reprojection
filter, the training CLI up to the e2e gate, and data and tensor
parallelism.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's Hopper kernels from ``neuralrecon_w_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the serving
shapes (K2 in both rounds of the served budget and in the four of NeuS's
64 + 64, its time taken in a CUDA graph, ``graph_ms``), then serves novel views through ``make_render_fn`` and
``render_image`` at the full width of ``config/train_brandenburg_gate_tpu.yaml``
(random geometric-init weights from a seeded ``torch.Generator``) in both
serving phases: warm-up (SFM-grid near/far only) and steady (a flat
level-10 fine grid with boundary samples). The scene is made in-process
with numpy: SFM points on a sphere of radius 1, the SFM grid from
``grid_from_points``, the fine grid a shell around that sphere, cameras
on a ring. It checks the outputs, counts the kernel launches of the
serving run, and prints timings with the card's name and power limit.
The kernels are held to their plain versions on a copy of the SDF net
with seeded noise on every weight and bias (``live_sdf_net``): the
geometric init zeroes the sin / cos columns, the skip's PE half and the
hidden biases, which would leave those parts of K1 unchecked.

    python3 chip_smoke.py --profile

adds, for one chunk of each serving phase, the wall time of the plain and
the kernel path in turns and a torch.profiler breakdown by renderer span,
and for one training step per phase and grad mode a breakdown by the
step's spans (``train.render_loss``, ``train.optimizer``) and the
renderer's.

Then it holds the SDF-VJP kernels (K3 forward, K4 backward, K5 the dW
reduction; ``csrc/sdf_vjp.cu``) against their plain version on the live
net, the backward also against float64, and times them at the steady
phase's 245,760 points beside the plain version and the torch double
backward. Then it trains: ``init_state`` and ``make_train_step`` over the
port's ``RayPool`` at batch 8192, on ring-camera rays of the analytic
sphere (numpy shading, sky and person labels, SFM depth on a quarter of
the hits, near / far from the bounding sphere), warm-up and then steady
on the level-10 fine grid, with ``SDF_GRAD_MODE`` 'pallas' (the kernels)
and 'vjp' (the double backward) in turns; it counts the kernel launches
of each phase, checks the losses are finite and the parameters move, and
holds one step of 'pallas' against 'vjp' from one state and one batch.

Then it extracts a mesh: K6 (``csrc/field_fwd.cu``, the fused field
forward) against its plain version on the live field, f32 and bf16, and
K1 in f32 at the SDF sweep's chunk; a phototourism-style workspace under
``build/`` whose 500,000 SFM points sit on the served field's own zero
set (a sign change found along seeded directions and bisected, with K1 in
f32), that field saved with ``save_checkpoint``, and ``tools/extract_mesh_cli.main`` with
the flags of ``scripts/sdf_extract.sh`` but ``--eval_level 9``. It checks
the ply (non-empty, finite, normals unit, vertices on the field's zero
set), counts the K1 and K6 launches of the extraction, prints each
stage's seconds, and holds the path's SDF sweep (every grid point) and
vertex colours against the plain versions.

The training and serving paths also run with ``SDF_GRAD_MODE``
'pallas_field' and ``FUSED_BG`` on, the fused field and background
kernels: ``field_train_kernel_phase`` holds kernel 5's port (K6 forward,
K7 ``csrc/field_bwd.cu`` + K5 backward) against its plain version, which
takes the colour ReLU masks K7 applied (f32 against float64, and bf16 at
8192 and at 245,760 points), and times it at 245,760 points beside the
torch double backward; ``bg_kernel_phase`` holds kernel 6's port (K8
forward, K9 ``csrc/nerf_bg.cu`` + K5 backward) against its plain version
and times it at the path's 8192 x 11 background points beside the 'xla'
path's autograd; training takes turns over 'pallas', 'vjp',
'pallas_field' (with FUSED_BG) and 'fwd' (the SDF gradient by forward
mode, reverse over forward in the backward) in both phases, the launches
and the peak device memory counted per mode; ``step_parity`` holds one
step of each other mode to 'vjp', and one frame per serving phase is
served in the fused mode and held to the default mode's chunk in f32.

Then it trains through the entry point a user calls,
``tools/train_cli.main`` (``trainer_phase``): the port's synthetic
workspace (``testing.make_synthetic_scene``: 12 + 1 ring views of
160x120 around a sphere of radius 1, ~37,000 SFM points, SFM grid level 8)
and its ray cache from ``prepare_data.prepare_data_cache`` (the voxel
near / far on the card), then 60 steps at batch 8192 at the full width in
the default 'vjp' mode with the surface refresh at steps 20 and 40 (K1 in
f32 over ~18 M level-10 candidates), saves at 20, 40 and 60 and a
validation at 50 (with the inline mesh F-score against the workspace's
gt.ply); it checks the step, the refreshed grid (non-empty, kept share
below 0.9), finite logged losses that fall, moved parameters, the metrics
and the checkpoint's optimiser state and grid, and that exactly K1 bf16,
K2 and K1 f32 launched; then it resumes 2 steps from that checkpoint in
'pallas_field' with FUSED_BG on the host pool (a refresh first) and
checks that exactly that mode's kernels launched, and 3 steps each in
'pallas_field' with FUSED_BG and in 'fwd' on the device pool, each one
captured window with its mode's kernels. Every refresh, the resume's too,
is held to the plain float32 SDF of the state it swept on 2^20 seeded
candidates, and the median SDF at the SFM points (the zero set's level
shift) is printed beside it.
Last, ``e2e_gate_phase`` runs tests/test_e2e.py:79-191 through the port's
CLIs (6 views of 40x30, 300 steps at batch 512, extract_mesh_cli at 48^3
with vertex colours, eval_mesh against the analytic sphere, render_cli,
a resume to step 302) and fails on any of that test's gates and bands.

The grid queries: ``ray_kernel_phase`` holds K10
(``csrc/ray_voxel.cu``, the exact DDA) and K11 (the sampled first hit) to
their plain versions with ``torch.equal`` on every output and on each
ray's trips: K10 at the SFM level over one served chunk's, the serving
frames' and the training cache's rays, K10 at level 10 with first_only
over 2^20 rays (axis-parallel ones, origins in occupied cells, misses
among them), K11 at the steady chunk's 1024 samples; each timed against
its plain version in turns, its bound from the loop trips the kernel
counted; K10's pre-pass (its coarse mask, level 10) against its plain
version and timed alone, and per K10 case the share of global reads the
mask skipped. Serving, the ray cache, validation and the band cache run
through them. After the training phases ``graph_parity``
holds make_scan_train_fn's CUDA graph to the same window of eager steps on
a ``DeviceRayPool`` of the training rays (f32 at PERTURB 0, and the
operating point's mean loss), and ``trainer_phase`` (now on the host pool,
TPU.DEVICE_POOL false) is followed by ``device_pool_trainer_phase``: the
same train_cli run with DEVICE_POOL 'auto' (the device pool, its band
cache held to the plain DDA on every row after every attach, SCAN_INNER 10
steps a graph replay, every replayed launch accounted), its rays/s windows
beside the host pool's, and a resume. The e2e gate runs under the same
default (the device pool and the graph at batch 512).

The served frame as one graph (``serving_graph_phase``, after the
serving phases): per phase, the frames rendered in turns as eager chunks,
as replays of one chunk captured by ``make_scan_render_fn`` (the frame
copied to the card once, fetched once), again as the graph and again
eager; every graph frame equal to the eager frame bit for bit, the rays/s
of each, the launches and replays a chunk, the host syncs of an eager
chunk (``torch.cuda.set_sync_debug_mode``), and under ``--profile`` the
busy share of a replayed frame. ``trainer_phase`` then renders its
checkpoint through ``render_cli --dispatch scan`` and ``--dispatch chunk``
and holds the PNGs equal. After extraction, ``reproj_filter_phase`` runs
the geometry-evaluation path on the extracted mesh: 100 ring views of
160x120 written into the extraction workspace, the mesh's vertices as a
point cloud voxelised at level 12 into a two-level grid (its bytes beside
a flat grid's 8 GiB), K12 (``csrc/ray_voxel.cu``, the two-level DDA) held
to its plain version with ``torch.equal`` and to K10 on a level-10 grid,
``reproj_filter_cli`` in point-cloud mode over every view (its stages'
seconds, the DDA's rays/s, the kept count; its keep mask on 4 views held
to the plain DDA's), mesh mode over 8 views, and the native depth
rasteriser held to the numpy one.

The kernel modes in CUDA graphs: after the 'vjp' windows, ``graph_parity``
holds each kernel mode's captured window ('pallas', 'pallas_field' with
FUSED_BG, 'fwd'; steady, full width, batch 8192) to its eager windows (K5's
atomics make two eager windows differ: the bound follows the eager
windows' spread, and the graph windows are held to each other within it),
and ``graph_rates`` times 'vjp', 'pallas', 'pallas_hybrid', 'pallas_field'
and 'fwd' eager against graph in turns, with each capture call's peak
memory and a captured step's launches by kernel; serving replays the
'pallas' (K3) and the 'pallas_field' + FUSED_BG (K6, K8) frames in turns
with their eager frames, bit for bit; ``trainer_phase``'s device-pool
'pallas_field' and 'fwd' resumes each run one captured window, and the
host-pool 'pallas_field' checkpoint goes through ``render_cli --dispatch
scan`` and ``--dispatch chunk``, the same PNGs. The run ends with each
phase's wall (``PhaseClock``).

The modules with no kernel of their own, driven on the card: after
serving, ``trace_render_check`` runs ``rendering/debug.trace_render`` on
1,024 rays of the steady frame and reads its three PLY dumps (under
``build/trace_render``) back with ``utils/ply.read_ply``; training takes
'fwd' in turns with the other modes (on a copy of the state, see
``training_phase``) and ``trainer_phase`` resumes 3 steps in 'fwd' on the
device pool with no refresh, one captured window (K1, K2, K10 must
launch), each printing its peak memory;
``prep_phase`` runs the data-preparation tools a user starts from a COLMAP
reconstruction with (100 views of 160x120, every tenth turned away:
``pre_process``, ``prepare_semantic_maps --backend constant``,
``prepare_data_split --num_test 10``, ``prepare_data_cache``,
``load_scene_meta``; each stage's seconds and the undistort branch), and
``image_metrics_phase`` holds SSIM and LPIPS (VGG and Alex at full
width, ``init_lpips`` weights) on the card to float64 on the CPU, on the
trained field's held-out view and 4 seeded images of 640x480.

Data parallelism (``multi_rank_phase``, in trainer_phase's workspace from
its last checkpoint): 3 'vjp' steps at batch 8192 with an NCCL group of
one rank (``parallel.mesh.init_data_group(1)``) held bit for bit to the
same steps without a group, and a refresh sweep through that group to the
one without; then two ranks on the one card over gloo (an explicit choice:
NCCL refuses two ranks on one device), spawned by ``parallel.mesh.spawn``
(the kernels built before, so the ranks only load them), each running
train_cli's Trainer at the global batch 8192 (4096 a rank, the device pool
sharded) for 6 steps with refreshes at its first step and 3 steps later,
saves every 3 and a split validation at the end, then a 2-step resume:
both ranks' parameters and fine grids bit for bit equal after each, rank
0 alone logging and writing, K1, K2, K10 and K11 launched on each rank;
then one float32 step at PERTURB 0 of the two ranks on a fixed batch whose
halves hold different numbers of ray-masked rays, the reduced gradient
within rel-L2 1e-5 per parameter of one rank's step on the whole batch; it
prints the per-step wall of two ranks and of one on that batch, the flat
all-reduce's size and time for NCCL (one rank) and gloo (two), and each
rank's refresh walls.

Tensor parallelism (``tensor_parallel_phase``, after the data-parallel
phase, from the same checkpoint): two ranks on the one card over gloo, one
data shard and a model axis of 2, the field split by
``parallel.mesh.field_param_specs`` (65 column, 5 row, 1 vocab, 9 whole
parameters at full width) through ``parallel.tensor.shard_field``; two
float32 Adam steps at PERTURB 0 on one fixed batch of 8192 rays in 'vjp'
(the field split through ``models.layers.tp_linear``; the sampler's K1
and K2 on the gathered SDF weights) and in 'pallas' (K3-K5 on the
gathered weights), each against one rank with no group from the same
state: every step's loss within rtol 1e-5, every parameter gathered
within 1e-4, the first step's gathered gradients within 1e-3 of one
rank's leaf by leaf, the whole parameters bit for bit on both ranks; one
bf16 step at the operating point on those rays finite; K1 and K2 (and K3-K5 in 'pallas')
launched on each rank. It prints the spec counts, each rank's step wall
against one rank's, the model axis's all-reduce and all-gather calls and
bytes in a step, and gloo's rate between the ranks, timed at 256 MB.

The optimisers (``optimizer_phase``, after the tensor-parallel phase, from
the same checkpoint's parameters and fine grid, each optimiser's state
fresh): for SGD and RAdam, 'vjp' at batch 8192 on the device pool in the
steady phase, ``graph_parity`` over a window of 8 steps (RAdam's sixth
update its first rectified one) within its 'vjp' bounds, the graph's
change of the parameters over the window within 1e-3 of the plain loop's,
and no host sync in an update; then train_cli with
TRAINER.OPTIMIZER set, ``DEVICE_POOL: auto`` and SCAN_INNER 5: one
captured window, a save at update 5, a resumed window, each replayed with
K1 and K2 in its captured step, the resumed optimiser state bit for bit
the saved one. It prints the ms a step of replayed windows for Adam, SGD
and RAdam, timed in turns.

The last lines are the card line, a JSON object with one entry per
kernel (K1 and K2 with their serving launches, K3 to K5 and K7 to K9 with
their training launches, K6 with its launches on every path, each plus
its launches in the CLI runs, listed by run under "cli", the device-pool
run's graph replays as "train_cli device_pool_graph"; K10 and K11 with
their serving and training launches, the served graph's replays under
"serving_graph"; K12 with the filter CLI's; each with
its time, its plain version's, one PyTorch call's for the same function
where there is one (K5: one ``addmm`` per factor pair on the same rows,
``library_ms``), and the least time the card could take for the same
work, ``bound_ms``), and ``{"ok": true, "device": {...}}``.
It exits non-zero, with no result line, when there is no CUDA device or
any check fails.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "config", "train_brandenburg_gate_tpu.yaml")
SEED = 0
CHUNK = 8192
IMG_WH = (160, 120)
FRAMES = 3  # per phase; the first is untimed
SFM_VOXEL = 0.0117  # -> SFM grid level 8 over the +-1.5 bbx
FINE_LEVEL = 10
SHELL_HALF_CELLS = 2.0  # fine-grid shell half thickness, in fine cells
LIVE_EPS = 0.02  # noise of live_sdf_net, in units of the init's scale

# kernel-versus-plain bounds
K1_F32_ATOL, K1_F32_RTOL = 1e-4, 1e-4  # summation order only
K1_BF16_ATOL = 2e-2  # bf16 rounds a flipped ulp differently along 8 layers
# K2 alone on identical inputs: a draw can flip at a CDF tie
SAMPLER_Z_ATOL, SAMPLER_RAY_FRAC = 1e-4, 0.999
# the whole stage: K1's f32 rounding (~4e-7) enters K2's cosine through
# near-duplicate samples ((s1 - s0) / (z1 - z0 + 1e-5)), and the min with
# the next section's cosine carries it on; a few rays in a thousand draw
# elsewhere in the same bin
STAGE_RAY_FRAC = 0.995
# kernel path vs plain path, one f32 chunk: a sample flipped at a CDF tie
# moves a ray's color / depth a little; almost every ray must agree
PATH_ATOL, PATH_RAY_FRAC = 1e-3, 0.999
# in bf16 an activation that K1 and its plain version sum in another order
# can round to the neighbouring bf16 value, and the sampler turns that ulp
# of sdf into a moved sample on some rays: bound the mean difference per ray
PATH_BF16_MEAN = 5e-3

# training (PERF.md holds the bounds and why)
TRAIN_BATCH = 8192
TRAIN_CAMS = 12
TRAIN_TIMED = 6  # timed steps per grad mode and phase
LABEL_SKY, LABEL_BUILDING, LABEL_PERSON = 2, 1, 12
VJP_CHECK_PTS = 8192  # K3 / K4 + K5 against the plain version (and f64)
VJP_TIME_PTS = 8192 * 30  # the steady phase's samples per step
K3_F32_TOL = 1e-4
VJP_BF16_REL = 5e-2  # kernels vs the plain version in bf16, rel-L2 per output
# pallas vs vjp, one step from one state. In f32: (loss rtol, rel-L2 per
# parameter gradient) between the two modes. In bf16 the two modes round
# the SDF forward at other places (the 'vjp' matmuls round their outputs
# and add the bias in bf16, K3 keeps both in f32), which moves every loss by
# ~1 %; and a gradient is a sum over ~200k points whose rounding errors do
# not cancel as its signal does, so each mode's bf16 gradient lies a few
# percent to O(1) off the f32 one, independently. So in bf16 both are held
# to the f32 'vjp' gradient of the same step: 'pallas' may be off it by at
# most PARITY_BF16_RATIO times what 'vjp' is, or by PARITY_BF16_FLOOR (the
# bf16 weights shift the SDF's mean a little differently in each mode, which
# moves a sum over the surface such as the last layer's sdf bias by percents).
PARITY_F32 = (1e-4, 1e-2)
PARITY_BF16_LOSS, PARITY_BF16_RATIO, PARITY_BF16_FLOOR = 3e-2, 2.0, 1e-1

# kernel 5 (K6 forward, K7 + K5 backward) and kernel 6 (K8, K9 + K5); PERF.md
# holds the bounds and why. K7 + K5 f32 against the plain version in float64
# within max(2 x the plain f32's rel-L2, 1e-5), as K4 + K5; bf16 per output
# within VJP_BF16_REL of the plain bf16. A colour pre-activation within
# rounding of 0 takes another sign in another summation order, and one such
# flipped ReLU mask moves a colour dW by ~1e-3 at 8192 points; so the plain
# versions take the masks K7 applied (field_train.color_masks), and those
# masks may differ from the reference's own signs only where its
# pre-activation lies within FLIP_Z[act] x its layer's rms of 0.
# K9 + K5 f32 within BG_GRAD_REL of the plain f32.
FIELD_CHECK_PTS = 8192
FLIP_Z = {"float32": 1e-3, "bfloat16": 5e-2}
BG_GRAD_REL = 1e-5
# the kernels each training mode launches ('pallas_field' with FUSED_BG);
# every other kernel stays at 0 launches in that mode
MODE_KERNELS = {"pallas": ("sdf_mlp", "up_sample", "sdf_vjp_fwd", "sdf_vjp_bwd", "dw_reduce"),
                "vjp": ("sdf_mlp", "up_sample"),
                "pallas_field": ("sdf_mlp", "up_sample", "dw_reduce", "field_fwd", "field_bwd",
                                 "nerf_bg_fwd", "nerf_bg_bwd"),
                "fwd": ("sdf_mlp", "up_sample")}
# 'pallas_field' with FUSED_BG; 'fwd' (forward-mode SDF gradient) evaluates
# its SDF net in float32 whatever the field's dtype, as the JAX package's
TRAIN_MODES = ("pallas", "vjp", "pallas_field", "fwd")
# modes training_phase steps on a copy of the state (see there): 'fwd' came
# after the others, and the bf16 step_parity of 'pallas' is held to a
# bound that some states of the tiny CPU rehearsal miss (PERF.md, section 7)
SIDE_MODES = ("fwd",)

# extraction (PERF.md holds the bounds and why)
EXTRACT_POINTS = 500_000  # SFM points on the field's zero set
# scripts/sdf_extract.sh extracts at level 10; the script runs level 9 since
# the reprojection filter's phase joined it, to stay within its earlier time
# (PERF.md section 4): a mesh of ~1/4 the vertices, still over 10^6
EXTRACT_LEVEL = 9
EXTRACT_CHUNK = 102144  # scripts/sdf_extract.sh
COLOR_CHUNK = 65536  # extraction/mesh.py's chunk_rgb
MIN_TRACK = 2  # the workspace's min_track_length; every point has a longer track
# Where the field's zero set lies is the field's own business: the seed-0
# geometric init crosses at |x| 0.24-0.38 in unit coordinates, and training
# moves it. So each seeded direction is scanned for a sign change and the
# crossing bisected; the workspace's scene radius then puts the farthest
# crossing EXTRACT_REACH SFM units from the origin, inside the +-1.5 eval
# bbx (at the init, the surface ~1.1 SFM units out: ~110k level-8 cells).
EXTRACT_REACH = 1.4
ZERO_SCAN = (0.02, 0.98, 16)  # radii scanned per direction, unit coordinates
ZERO_DIRS = 1.25  # directions drawn per SFM point wanted; some may not cross
BISECT_TOL = 1e-6
SDF_PROBE_CELLS = 0.05  # median |sdf| at the mesh's vertices, in cells of its level
NORMAL_SHORT_FRAC = 1e-4  # normals short of unit (sliver faces only), share of vertices
COLOR_LEVELS, COLOR_FRAC = 2, 0.999  # vertex colours, kernel path vs plain
K6_CHECK_PTS = COLOR_CHUNK

# the training CLI (PERF.md holds why): the port's synthetic workspace of
# TRAINER_CAMS + 1 ring views at IMG_WH whose SFM points cover the unit
# sphere, cameras TRAINER_CAM_DIST out; the scene radius is 1.2 x that, which
# puts the sphere at |x| 0.278 unit, where the seed-66 geometric init of
# CONFIG's width is <= 0 on ~26 % of directions (a refresh keeps a shell),
# config.yaml's voxel_size SFM_VOXEL (SFM grid level 8); TRAIN_VOXEL_SIZE
# TRAINER_VOXEL makes the training level 10. Refreshes at TRAINER_UPDATE
# and twice that, a save at every refresh step (each refresh's swept state
# on disk), a validation at TRAINER_VAL, the scalars logged every
# TRAINER_LOG steps. Every refresh, the resume's too, is held to the plain
# version on REFRESH_CHECK_PTS seeded candidates: a cell within
# REFRESH_AMBIGUOUS (K1_F32_ATOL) of the threshold may go either way.
# The run's two refreshes fail at DEGENERATE_KEEP of their candidates or
# more; the resume's is not held to it: from this init the zero set
# crosses the SFM shell (+-0.005 unit) near step 50 and overshoots it by
# 0.03-0.1 unit through step 300, in float32 and bfloat16 alike
# (scripts/torch_trainer_refresh.py), as the JAX Trainer's does at a
# narrow width (scripts/torch_trainer_vs_jax.py, the same cells kept)
TRAINER_CAMS = 12
TRAINER_POINTS = 40_000
TRAINER_CAM_DIST = 3.0
TRAINER_VOXEL = 0.004  # ceil(log2(3 / 0.004)) = 10
# the host-pool resume takes TRAINER_RESUME steps; each device-pool resume
# one SCAN_INNER window of GRAPH_RESUME: GRAPH_WARMUP eager steps, the
# capture, one replay
TRAINER_STEPS, TRAINER_RESUME, GRAPH_RESUME = 60, 2, 3
TRAINER_UPDATE, TRAINER_VAL, TRAINER_LOG = 20, 50, 10
DEGENERATE_KEEP = 0.9
REFRESH_CHECK_PTS = 1 << 20
REFRESH_AMBIGUOUS = K1_F32_ATOL
# the e2e gate: tests/test_e2e.py's cfg and bands (docs/e2e_gate_calibration.json)
E2E_CFG = {
    "NEUCONW": {
        "N_SAMPLES": 8, "N_IMPORTANCE": 8, "UP_SAMPLE_STEP": 2, "N_OUTSIDE": 2,
        "BOUNDARY_SAMPLES": 2, "S_VAL_BASE": 1, "SAMPLE_RANGE": 4, "N_VOCAB": 16,
        "ANNEAL_END": 100, "UPDATE_FREQ": 100, "TRAIN_VOXEL_SIZE": 0.12, "SDF_THRESHOLD": 0.1,
        "NEAR_FAR_OVERRIDE": True,
        "SDF_CONFIG": {"d_hidden": 64, "d_out": 65, "n_layers": 4, "skip_in": [2]},
        "COLOR_CONFIG": {"d_feature": 64, "d_hidden": 32, "n_layers": 2, "head_channels": 16},
        "MESH_MASK_LIST": ["sky"], "DEPTH_LOSS": True, "LOSS": {"depth_weight": 1.0},
    },
    "TRAINER": {"SAVE_FREQ": 1000, "VAL_FREQ": 100.0, "CANONICAL_LR": 1e-3, "CANONICAL_BS": 512},
}
E2E_VOXELS = (8000, 40000)
E2E_GATES = {"fscore": 0.14, "chamfer_pred_to_gt": 0.62, "chamfer_gt_to_pred": 0.84}
E2E_RENDER_STD = 5.0

# the H100 SXM's published peaks (NVIDIA's datasheet): dense bf16 tensor
# cores; float32 products at the fastest f32-accurate route, three TF32
# tensor-core products per f32 product (495 TFLOP/s / 3); float32 outside
# the tensor cores (the FMA pipes: the grid queries' arithmetic); HBM3
PEAK_BF16, PEAK_F32, PEAK_F32_SIMT, PEAK_BYTES = 989e12, 495e12 / 3, 67e12, 3.35e12


def bound(flops: float, n_bytes: float, act: str) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak of their type and the bytes over the memory rate. An f32
    product is reckoned at 165 TFLOP/s, the split-TF32 route (3 TF32
    products at 495 TFLOP/s) that keeps f32 accuracy, so no f32 kernel can
    beat its bound by taking it; ``act`` 'simt' is float32 outside the
    tensor cores, at 67 TFLOP/s."""
    t_ops = flops / (PEAK_BF16 if act == "bfloat16" else PEAK_F32_SIMT if act == "simt"
                     else PEAK_F32)
    t_mem = n_bytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def gemm_flops(dims) -> int:
    """2 k n per point over the (k, n) of each product."""
    return 2 * sum(k * n for k, n in dims)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sync() -> None:
    """Waits for the card, where there is one (the CPU rehearsal has none)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the card, after one warm-up call."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean milliseconds of fn() on the card with the host's launch cost
    out of the way: reps calls captured in one CUDA graph, replayed. For
    kernels of a few microseconds, which cuda_ms times at the rate the
    host issues them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


# ------------------------------- the scene -------------------------------


def shell_coords(level: int, scale: float, radius: float, half_cells: float):
    """Cells of a level-``level`` grid over [-scale, scale]^3 whose
    centres lie within half_cells cells of the sphere |x| = radius, built
    column by column (no dense 2^{3L} pass)."""
    import numpy as np

    n = 1 << level
    cw = 2.0 * scale / n
    c = (np.arange(n) + 0.5) * cw - scale
    rho2 = c[:, None] ** 2 + c[None, :] ** 2
    r_in2, r_out2 = (radius - half_cells * cw) ** 2, (radius + half_cells * cw) ** 2
    zmax = np.sqrt(np.clip(r_out2 - rho2, 0.0, None))
    zmin = np.sqrt(np.clip(r_in2 - rho2, 0.0, None))
    ok = rho2 <= r_out2

    def k_range(lo, hi):  # cell indices with centre in [lo, hi]
        return (np.ceil((lo + scale) / cw - 0.5).astype(np.int64),
                np.floor((hi + scale) / cw - 0.5).astype(np.int64))

    one = ok & (zmin == 0.0)  # the column crosses the shell once
    ranges = [k_range(-zmax, zmax) + (one,),
              k_range(zmin, zmax) + (ok & ~one,), k_range(-zmax, -zmin) + (ok & ~one,)]
    coords = []
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    for lo, hi, mask in ranges:
        lo, hi = np.clip(lo, 0, n - 1)[mask], np.clip(hi, 0, n - 1)[mask]
        cnt = np.maximum(hi - lo + 1, 0)
        start = np.repeat(lo, cnt)
        off = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        coords.append(np.stack([np.repeat(ii[mask], cnt), np.repeat(jj[mask], cnt),
                                start + off], axis=1))
    return np.concatenate(coords).astype(np.int32)


def sphere_points(n: int, radius: float = 1.0):
    """n points on the sphere |x| = radius: the scene's SFM keypoints."""
    import numpy as np

    v = np.random.default_rng(SEED).standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True) * radius


def camera_rays(wh, focal: float, eye):
    """(H*W, 3) origins and unit directions of a pinhole camera at eye
    looking at the origin, z up (OpenGL camera: x right, y up, looking
    down -z; no half-pixel offset, as ``datasets/rays.py`` has it)."""
    import numpy as np

    w, h = wh
    j, i = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                       indexing="ij")
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)
    back = eye / np.linalg.norm(eye)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    d = dirs.reshape(-1, 3) @ np.stack([right, up, back], axis=1).T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(eye, d.shape), d


def make_scene(device, fine_level: int = FINE_LEVEL, sfm_voxel: float = SFM_VOXEL,
               wh=IMG_WH, n_points: int = 50000):
    """SceneInfo, SFM VoxelGrid and fine VoxelGrid of a unit sphere, and
    a camera ring's rays. SFM units; the training sphere has radius 2."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid, grid_from_points
    from neuralrecon_w_tpu_torch.utils.scene import scene_info

    rng = np.random.default_rng(SEED)
    pts = sphere_points(n_points)
    bbx = np.full(3, 1.5)
    sfm_grid = grid_from_points(pts, -bbx, bbx, sfm_voxel, expand=1, radius=1.0)
    fine = VoxelGrid(fine_level, sfm_grid.origin, sfm_grid.scale,
                     shell_coords(fine_level, sfm_grid.scale, 1.0, SHELL_HALF_CELLS))
    scene = scene_info({"origin": [0.0, 0.0, 0.0], "radius": 2.0}, device)

    frames = []
    for f in range(FRAMES):
        ang = 2 * np.pi * f / FRAMES + rng.uniform(0, 0.1)
        eye = np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 0.6])
        o, d = camera_rays(wh, 1.2 * wh[0], eye)
        n = len(o)
        rays = np.concatenate([o, d, np.full((n, 1), 0.5), np.full((n, 1), 6.0),
                               np.zeros((n, 2))], axis=1).astype(np.float32)
        frames.append(rays)
    return scene, sfm_grid, fine, frames


# ------------------------------- phases -------------------------------


def live_sdf_net(net, seed: int = SEED, eps: float = LIVE_EPS):
    """A copy of the SDF net in which every input reaches the output.
    The geometric init zeroes layer 0's sin / cos columns, the PE half of
    the skip input and every hidden bias, and makes the last layer nearly
    constant; seeded noise on every weight (eps times the init's scale)
    and bias (eps) makes a kernel that drops or permutes any of them
    disagree with its plain version."""
    import torch

    live = copy.deepcopy(net)
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for l in range(live.n_layers):
            layer = live.layer(l)
            d_out, d_in = layer.weight_v.shape
            sd = eps / math.sqrt(d_in) if l == live.n_layers - 1 else eps * math.sqrt(2.0 / d_out)
            layer.weight_v.add_(sd * torch.randn(d_out, d_in, generator=g).to(layer.weight_v))
            layer.bias.add_(eps * torch.randn(d_out, generator=g).to(layer.bias))
    return live


def live_field(model, seed: int = SEED):
    """A copy of the field with ``live_sdf_net``'s SDF net. Its colour net
    keeps the seeded torch-default init, U(+-1/sqrt(d_in)) on every weight
    and bias, which already reaches every input."""
    live = copy.deepcopy(model)
    live.neuconw.sdf_net = live_sdf_net(model.neuconw.sdf_net, seed)
    return live


def kernel_phase(model, fc, rays_o, rays_d, z_base, n_pts_cmp: int):
    """Each kernel against its plain version at the serving shapes, on the
    live copy of the served SDF net."""
    import torch

    from neuralrecon_w_tpu_torch.ops import importance_sampler as smp
    from neuralrecon_w_tpu_torch.ops import sdf_mlp

    dev = rays_o.device
    net = live_sdf_net(model.neuconw.sdf_net)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    pts = ((torch.rand(n_pts_cmp, 3, generator=g) * 2 - 1) * 0.9).to(dev)
    res, fails = {}, []

    for act in ("float32", "bfloat16"):
        packed = sdf_mlp.pack_sdf_weights(net, fc.sdf, act)
        got = sdf_mlp.fused_sdf_head(packed, pts)
        want = sdf_mlp.sdf_mlp_plain(packed, pts)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and (
            bool((err <= K1_F32_ATOL + K1_F32_RTOL * want.abs()).all()) if act == "float32"
            else float(err.max()) <= K1_BF16_ATOL)
        print(f"K1 sdf_mlp {act} on {n_pts_cmp} pts: max|err| {float(err.max()):.3e} "
              f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"K1 {act}")

    # timings at the serving shape: the act dtype of the config, 8 samples a ray
    packed = sdf_mlp.pack_sdf_weights(net, fc.sdf, fc.act_dtype)
    pts_srv = (rays_o[:, None, :] + rays_d[:, None, :] * z_base[..., None]).reshape(-1, 3)
    k1_err = float((sdf_mlp.fused_sdf_head(packed, pts_srv)
                    - sdf_mlp.sdf_mlp_plain(packed, pts_srv)).abs().max())
    k1_ms = cuda_ms(lambda: sdf_mlp.fused_sdf_head(packed, pts_srv))
    k1_plain = cuda_ms(lambda: sdf_mlp.sdf_mlp_plain(packed, pts_srv))
    k1_ms2 = cuda_ms(lambda: sdf_mlp.fused_sdf_head(packed, pts_srv))
    print(f"K1 sdf_mlp {fc.act_dtype} at {pts_srv.shape[0]} pts: kernel {k1_ms:.3f} / "
          f"{k1_ms2:.3f} ms, plain {k1_plain:.3f} ms, max|err| {k1_err:.3e}")
    n_srv = pts_srv.shape[0]
    res["sdf_mlp"] = {"max_abs_err": k1_err, "ms": min(k1_ms, k1_ms2), "plain_ms": k1_plain,
                      "library_ms": None,
                      **bound(n_srv * gemm_flops(zip(packed.k, packed.n)),
                              nbytes(pts_srv, packed.w, packed.b) + 4 * n_srv, fc.act_dtype)}

    # K2 alone in both rounds at the serving shapes (round 0: 8 samples, 8
    # draws; the last: 8 + 8 merged, 24 written), then in every round of
    # NeuS's own budget, 64 + 64 in 4 rounds (rows up to 128 wide)
    def sdf_of(z):
        pts = (rays_o[:, None] + rays_d[:, None] * z[..., None]).reshape(-1, 3)
        return sdf_mlp.sdf_mlp_plain(packed, pts).view(z.shape)

    def k2_rounds(z0, n_draw, up_steps, s_base, label):
        out, za, sa, zb, sb = {}, z0, sdf_of(z0), None, None
        for i in range(up_steps):
            last = i + 1 == up_steps
            args = (rays_o, rays_d, za, sa, zb, sb, n_draw, 64.0 * 2 ** (s_base + i), last)
            got, want = smp.up_sample_round(*args), smp.up_sample_round_plain(*args)
            got, want = ((got,), (want,)) if last else (got, want)
            rows = min(((g - w).abs() <= SAMPLER_Z_ATOL).all(dim=1).float().mean().item()
                       for g, w in zip(got, want))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            t_k = graph_ms(lambda: smp.up_sample_round(*args))
            t_p = cuda_ms(lambda: smp.up_sample_round_plain(*args))
            t_k2 = graph_ms(lambda: smp.up_sample_round(*args))
            t_w = cuda_ms(lambda: smp.up_sample_round(*args))
            ok = rows >= SAMPLER_RAY_FRAC and bool((torch.diff(got[0], dim=1) >= 0).all())
            name = "last" if last else f"round {i}"
            width = za.shape[1] + (0 if zb is None else zb.shape[1])
            print(f"K2 up_sample {label} {name} ({width} + {n_draw} wide) on "
                  f"{rays_o.shape[0]} rays: rays within {SAMPLER_Z_ATOL} {rows:.5f}, max|err| "
                  f"{err:.3e}; kernel {t_k:.4f} / {t_k2:.4f} ms (in a CUDA graph; through "
                  f"the wrapper {t_w:.4f}), plain {t_p:.3f} ms -> {'ok' if ok else 'FAIL'}")
            if not ok:
                fails.append(f"K2 {label} {name}")
            if i in (0, up_steps - 1):
                tensors = [a for a in args if hasattr(a, "numel")] + list(got)
                out["last" if last else "first"] = {
                    "width": width + n_draw, "max_abs_err": err, "ms": min(t_k, t_k2),
                    "wrapper_ms": t_w, "plain_ms": t_p, **bound(0, nbytes(*tensors), "float32")}
            if not last:
                za, sa, zb = want
                sb = sdf_of(zb)
        return out

    k2 = k2_rounds(z_base, 8, 2, 3, "served")
    z64 = z_base[:, :1] + (z_base[:, -1:] - z_base[:, :1]) * torch.linspace(0, 1, 64, device=dev)
    k2_wide = k2_rounds(z64.contiguous(), 16, 4, 0, "64 + 64")
    res["up_sample"] = {**k2["last"], "library_ms": None, "rounds": k2, "wide": k2_wide}

    # the whole importance stage, f32 and the serving dtype, and NeuS's
    # 64 + 64 in 4 rounds in f32
    stages = [(act, z_base, 16, 2, 3) for act in dict.fromkeys(("float32", fc.act_dtype))]
    for act, z0, n_imp, up_steps, s_base in stages + [("float32", z64, 64, 4, 0)]:
        run = lambda f: f(net, fc.sdf, rays_o, rays_d, z0, n_imp, up_steps, s_base,  # noqa: E731
                          act)
        got, want = run(smp.fused_importance_sampler), run(smp.importance_sampler_plain)
        rows = ((got - want).abs() <= SAMPLER_Z_ATOL).all(dim=1).float().mean().item()
        sorted_ok = bool((torch.diff(got, dim=1) >= 0).all())
        t_k = cuda_ms(lambda: run(smp.fused_importance_sampler), reps=3)
        t_p = cuda_ms(lambda: run(smp.importance_sampler_plain), reps=3)
        ok = sorted_ok and (rows >= STAGE_RAY_FRAC or act != "float32")
        print(f"sampler {act} {z0.shape[1]} + {n_imp} in {up_steps} rounds on "
              f"{rays_o.shape[0]} rays: rays within {SAMPLER_Z_ATOL} "
              f"{rows:.5f} (max|err| {float((got - want).abs().max()):.3e}), sorted {sorted_ok}; "
              f"kernels {t_k:.3f} ms, plain {t_p:.3f} ms -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"sampler {act} {z0.shape[1]} + {n_imp}")
    return res, fails


def serving_phase(model, fc, rcfg, scene, frames, fine_grid, sfm_grid, label):
    """Render FRAMES frames through make_render_fn + render_image; the
    first is untimed. Returns (rays/s, outputs of the last frame)."""
    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.training.step import make_render_fn
    from neuralrecon_w_tpu_torch.training.validation import render_image

    render_chunk = make_render_fn(fc, rcfg)
    w, h = IMG_WH
    seconds, outs = 0.0, []
    for f, rays in enumerate(frames):
        ts = np.full((len(rays),), f, np.int64)
        labels = np.zeros((len(rays),), np.int64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_image(render_chunk, model, scene, rays, ts, labels, (w, h), CHUNK,
                           fine_grid, sfm_grid)
        torch.cuda.synchronize()
        if f > 0:
            seconds += time.perf_counter() - t0
        outs.append(out)
    rps = (len(frames) - 1) * w * h / seconds
    print(f"serving {label}: {len(frames) - 1} timed frames of {w}x{h} at chunk {CHUNK}: "
          f"{rps:.1f} rays/s")
    return rps, outs


def check_frames(outs, frames, label, wh=IMG_WH):
    import numpy as np

    fails = []
    for out, rays in zip(outs, frames):
        for k, v in out.items():
            if v.shape[:2] != (wh[1], wh[0]) or not np.all(np.isfinite(v)):
                fails.append(f"{label} {k} not finite or misshapen")
    c = np.concatenate([o["color"].reshape(-1, 3) for o in outs])
    print(f"{label}: {len(outs)} frames finite, color range [{c.min():.3f}, {c.max():.3f}]")
    return fails


def path_check(model, fc, rcfg, scene, rays, fine_grid, sfm_grid, label, ref_fc=None):
    """One chunk through the kernel path and the plain path (the plain
    sampler, ``importance_sampler_plain``), in f32 and in the served
    activation dtype. The foreground color (``color_sphere``) must lie in
    [0, 1]; the composite color need not with random weights, because the
    background NeRF's rgb head is linear, as in the JAX package
    (models/nerf_bg.py:102). With ``ref_fc`` (another field mode) the f32
    kernel-path chunk is also held to ref_fc's, as to the plain path."""
    import torch

    from neuralrecon_w_tpu_torch.training.step import make_render_fn

    dev = scene.origin.device
    r = torch.as_tensor(rays[:CHUNK], device=dev)
    ts = torch.zeros(r.shape[0], dtype=torch.long, device=dev)
    fails = []
    for act in dict.fromkeys(("float32", fc.act_dtype)):
        fc_act = fc._replace(act_dtype=act)
        outs = [make_render_fn(fc_act, rcfg._replace(fused_sampler_sdf=fused))(
            model, scene, r, ts, ts, None, fine_grid, sfm_grid) for fused in (True, False)]
        cs = outs[0]["color_sphere"]
        if not bool(torch.isfinite(cs).all()) or cs.min() < 0.0 or cs.max() > 1.0:
            fails.append(f"{label} {act} foreground color outside [0, 1]")
        pairs = [("plain path", outs[1])]
        if ref_fc is not None and act == "float32":
            pairs.append((f"{ref_fc.grad_mode} / {ref_fc.bg_mode} mode", make_render_fn(
                ref_fc._replace(act_dtype=act), rcfg._replace(fused_sampler_sdf=True))(
                model, scene, r, ts, ts, None, fine_grid, sfm_grid)))
        for other, out in pairs:
            for k in ("color", "depth"):
                diff = (outs[0][k] - out[k]).abs().reshape(r.shape[0], -1).amax(dim=1)
                frac = (diff <= PATH_ATOL).float().mean().item()
                print(f"{label} {act} chunk, kernel path vs {other}: {k} max|diff| "
                      f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}, rays within "
                      f"{PATH_ATOL} {frac:.5f}")
                if act == "float32" and frac < PATH_RAY_FRAC:
                    fails.append(f"{label} kernel path vs {other} {k}")
                if act != "float32" and float(diff.mean()) > PATH_BF16_MEAN:
                    fails.append(f"{label} {act} kernel path vs {other} {k}")
    return fails


def profile_chunk(model, fc, rcfg, scene, rays, fine_grid, sfm_grid, label) -> None:
    """torch.profiler over one warm chunk: device time by op and by the
    renderer's spans, and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuralrecon_w_tpu_torch.tracing import span_ms
    from neuralrecon_w_tpu_torch.training.step import make_render_fn

    dev = scene.origin.device
    r = torch.as_tensor(rays[:CHUNK], device=dev)
    ts = torch.zeros(r.shape[0], dtype=torch.long, device=dev)
    render_chunk = make_render_fn(fc, rcfg)
    render_chunk(model, scene, r, ts, ts, None, fine_grid, sfm_grid)
    torch.cuda.synchronize()
    # the chunk through the kernels and through the plain sampler, in turns
    walls = {"plain": [], "kernels": []}
    for path in ("plain", "kernels", "kernels", "plain"):
        fn = make_render_fn(fc, rcfg._replace(fused_sampler_sdf=path == "kernels"))
        t0 = time.perf_counter()
        fn(model, scene, r, ts, ts, None, fine_grid, sfm_grid)
        torch.cuda.synchronize()
        walls[path].append((time.perf_counter() - t0) * 1e3)
    print(f"{label} chunk wall ms, in turns plain / kernels / kernels / plain: "
          f"{walls['plain'][0]:.1f} / {walls['kernels'][0]:.1f} / {walls['kernels'][1]:.1f} / "
          f"{walls['plain'][1]:.1f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_chunk(model, scene, r, ts, ts, None, fine_grid, sfm_grid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the renderer's spans, each timed between its two marker kernels
    spans = {k: v for k, v in span_ms().items() if k.startswith("render.")}
    # only device events count: CPU-side ops carry their kernels' time too
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("render.")]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    kernels = sum(e.count for e in device)
    print(f"profile {label} chunk of {r.shape[0]} rays: wall {wall_ms:.1f} ms, {kernels} kernels "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %); device-timeline ms by span: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(spans.items())))
    print(events.table(sort_by="self_device_time_total", row_limit=15))


# ------------------------------- training -------------------------------


def training_rays(n_cams: int = TRAIN_CAMS, wh=IMG_WH, seed: int = SEED):
    """Ray-cache rows (N, 12) [o, d, near, far, ts, label, depth, weight]
    and rgbs (N, 3) from ring cameras around the unit sphere, SFM units.
    near / far are each ray's chord of the bounding sphere |x| = 2 (the
    training sphere), as the ray cache stores them; the colour is a numpy
    Lambertian shading of the sphere, the sky behind it. Labels: 'sky'
    where a ray misses, 'person' on the sphere's lower cap, 'building'
    elsewhere; every fourth ray that hits carries its SFM depth with
    weight 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    light = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    rows, rgbs = [], []
    for cam in range(n_cams):
        ang = 2 * np.pi * cam / n_cams + rng.uniform(0, 0.1)
        eye = np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 0.6 + rng.uniform(-0.2, 0.2)])
        o, d = camera_rays(wh, 1.2 * wh[0], eye)
        b = np.sum(o * d, axis=-1)
        c2 = np.sum(o * o, axis=-1)
        near = -b - np.sqrt(np.maximum(b * b - c2 + 4.0, 0.0))
        far = -b + np.sqrt(np.maximum(b * b - c2 + 4.0, 0.0))
        disc = b * b - c2 + 1.0
        hit = disc > 0
        t_hit = np.where(hit, -b - np.sqrt(np.maximum(disc, 0.0)), 0.0)
        p = o + d * t_hit[:, None]
        shade = 0.15 + 0.85 * np.clip(p @ light, 0.0, None)
        rgb = np.where(hit[:, None], np.array([0.8, 0.6, 0.4]) * shade[:, None],
                       np.array([0.55, 0.7, 0.95]))
        label = np.where(hit, np.where(p[:, 2] < -0.6, LABEL_PERSON, LABEL_BUILDING), LABEL_SKY)
        weight = (hit & (np.arange(len(o)) % 4 == 0)).astype(np.float64)
        n = len(o)
        rows.append(np.concatenate([o, d, near[:, None], far[:, None], np.full((n, 1), cam),
                                    label[:, None], t_hit[:, None], weight[:, None]], axis=1))
        rgbs.append(rgb)
    return (np.concatenate(rows).astype(np.float32), np.concatenate(rgbs).astype(np.float32))


class GradCapture:
    """Stands in for the optimiser of a TrainState: keeps one step's gradients."""

    def __init__(self, model):
        self.model, self.grads = model, None

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def step(self):
        import torch

        self.grads = {k: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                      for k, p in self.model.named_parameters()}


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


def check_forward(label, names, got, want, act: str) -> tuple:
    """A forward kernel's outputs against its plain version on one printed
    line: in f32 within atol / rtol K3_F32_TOL, in bf16 within rel-L2
    VJP_BF16_REL per output; all finite. Returns (ok, the largest
    |error|)."""
    import torch

    errs = [float((k - p).abs().max()) for k, p in zip(got, want)]
    rels = [rel_l2(k, p) for k, p in zip(got, want)]
    if act == "float32":
        ok = all(bool(((k - p).abs() <= K3_F32_TOL + K3_F32_TOL * p.abs()).all())
                 for k, p in zip(got, want))
    else:
        ok = max(rels) <= VJP_BF16_REL
    ok = ok and all(bool(torch.isfinite(k).all()) for k in got)
    print(f"{label}, {' / '.join(names)}: max|err| " + " / ".join(f"{e:.3e}" for e in errs)
          + ", rel-L2 " + " / ".join(f"{r:.3e}" for r in rels) + f" -> {'ok' if ok else 'FAIL'}")
    return ok, max(errs)


def check_outputs(label, names, got, ref, bound, plain=None) -> list:
    """A kernel's outputs against a reference, rel-L2 per output, on one
    printed line: each within `bound`, or, given `plain` (the plain f32
    version; ref is it in float64), within max(2 x plain's rel-L2 to ref,
    bound), the f32 rule of K4 + K5. Returns the names past their bound."""
    errs = [rel_l2(k, r) for k, r in zip(got, ref)]
    lims = ([bound] * len(errs) if plain is None else
            [max(2 * rel_l2(p, r), bound) for p, r in zip(plain, ref)])
    bad = [nm for nm, e, b in zip(names, errs, lims) if e > b]
    print(f"{label}, rel-L2 / bound: " + ", ".join(
        f"{nm} {e:.2e}/{b:.1e}" for nm, e, b in zip(names, errs, lims))
          + f" -> {'ok' if not bad else 'FAIL ' + str(bad)}")
    return bad


def check_flips(label, masks, zs, tol: float) -> list:
    """The colour ReLU masks K7 applied against a reference's
    pre-activations zs (one per ReLU layer): a mask may differ from the
    reference's sign only where its pre-activation lies within tol x that
    layer's rms of 0, a flip under rounding. Prints the count; returns the
    layers (1-based colour indices) with a flip past it."""
    bad, n_flip, worst = [], 0, 0.0
    for i, (m, z) in enumerate(zip(masks, zs), start=1):
        flip = m != (z > 0)
        n_flip += int(flip.sum())
        if bool(flip.any()):
            r = float(z[flip].abs().max()) / float(z.double().square().mean().sqrt())
            worst = max(worst, r)
            if r > tol:
                bad.append(i)
    print(f"{label}: {n_flip} of {sum(m.numel() for m in masks)} colour ReLU masks differ from "
          f"the reference's signs, the largest |z| there {worst:.2e} x its layer's rms (bound "
          f"{tol}) -> {'ok' if not bad else 'FAIL ' + str(bad)}")
    return bad


def time_in_turns(fwd, bwd, fwd_plain, bwd_plain, other, reduce_only, reduce_library,
                  reps: int = 2) -> dict:
    """Milliseconds on the card, in turns: the kernels' forward and backward
    (the backward with its K5 reduction), the plain versions, `other` (a
    torch autograd forward + backward of the same function), the kernels
    again (the lesser of the two kept), then K5 alone over the backward's
    chunks on a workspace of the same shape and the same products as one
    PyTorch call per factor pair (``library_reduce``), in turns (K5,
    library, library, K5; the lesser of each kept)."""
    t = {}
    for k, fn in (("fwd", fwd), ("bwd", bwd), ("fwd_plain", fwd_plain), ("bwd_plain", bwd_plain),
                  ("other", other), ("bwd2", bwd), ("fwd2", fwd), ("reduce", reduce_only),
                  ("library", reduce_library), ("library2", reduce_library),
                  ("reduce2", reduce_only)):
        t[k] = cuda_ms(fn, reps)
    for k in ("fwd", "bwd", "reduce", "library"):
        t[k] = min(t[k], t.pop(f"{k}2"))
    return t


def timed_entries(res, t, bounds, fwd: str, bwd: str, other: str) -> None:
    """A forward / backward kernel pair's times into their kernels-line
    entries. The backward kernel's `ms` is derived, (backward + K5) less K5
    alone, both timed in this run (`ms_from` says so); K5's share carries
    the time of one PyTorch call per factor pair on the same rows."""
    res[fwd].update(ms=t["fwd"], plain_ms=t["fwd_plain"], library_ms=None, **bounds[fwd])
    res[bwd].update(ms=t["bwd"] - t["reduce"], ms_from="(backward + K5) - K5 alone",
                    plain_ms=t["bwd_plain"], library_ms=None, fwd_bwd_ms=t["fwd"] + t["bwd"],
                    plain_fwd_bwd_ms=t["fwd_plain"] + t["bwd_plain"], **{other: t["other"]},
                    dw_reduce_ms=t["reduce"], dw_reduce_library_ms=t["library"],
                    dw_reduce_bound_ms=bounds["dw_reduce"]["bound_ms"], **bounds[bwd])


def sdf_vjp_bound(ws, bs, act: str, n: int) -> dict:
    """Least times of the SDF-VJP kernels at n points: K3 (F of every layer,
    G the reverse sweep, no product for the last layer's seed), K4 (the
    adjoint of G and the backward of F) and K5 (two products per layer from
    four factor rows per layer)."""
    dims = [(w.shape[1], w.shape[0]) for w in ws]
    f_all, f_hidden = gemm_flops(dims), gemm_flops(dims[:-1])
    n_out = dims[-1][1]
    wb = nbytes(*ws, *bs) // 2 if act == "bfloat16" else nbytes(*ws, *bs)
    return {"sdf_vjp_fwd": bound(n * (f_all + f_hidden), wb + n * (12 + 4 * n_out + 12), act),
            "sdf_vjp_bwd": bound(n * (f_hidden + 2 * f_hidden + f_all),
                                 wb + n * (12 + 4 * n_out + 12 + 12), act),
            "dw_reduce": bound(n * 2 * f_all, n * 4 * sum(2 * (k + m) for k, m in dims), act)}


def vjp_kernel_phase(model, fc):
    """K3 and K4 + K5 against their plain version (``ops/field_vjp_math.py``)
    on the live copy of the SDF net at the full width; the backward also
    against the plain version in float64. Then the times at the steady
    phase's shape (8192 rays x 30 samples): kernels forward + backward,
    the plain version, and the torch double backward ('vjp')."""
    import torch

    from neuralrecon_w_tpu_torch.models.layers import layer_weight
    from neuralrecon_w_tpu_torch.models.sdf import sdf_value_feat_grad
    from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    net = live_sdf_net(model.neuconw.sdf_net)
    dev = net.lin0.bias.device
    cfg = dict(fc.sdf)
    args = (tuple(cfg["skip_in"]), cfg["multires"], float(cfg["scale"]))
    ws = [layer_weight(net.layer(l)).detach().contiguous() for l in range(net.n_layers)]
    bs = [net.layer(l).bias.detach() for l in range(net.n_layers)]
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)

    def inputs(n):
        x = ((torch.rand(n, 3, generator=g) * 2 - 1) * 0.9).to(dev)
        return x, torch.randn(n, ws[-1].shape[0], generator=g).to(dev), \
            torch.randn(n, 3, generator=g).to(dev)

    res, fails = {}, []
    x, c_out, c_grad = inputs(VJP_CHECK_PTS)
    flat = lambda r: [*r[0], *r[1], r[2]]  # noqa: E731
    names = [f"dW{l}" for l in range(len(ws))] + [f"db{l}" for l in range(len(ws))] + ["dx"]
    for act in ("float32", "bfloat16"):
        act_t = getattr(torch, act)
        out, grad = vjp.sdf_vjp_fwd(ws, bs, cfg, x, act)
        w_out, w_grad = fvm.value_and_grad(ws, bs, *args, x, act_t)
        torch.cuda.synchronize()
        if act == "float32":
            ok = all(bool(((a - b).abs() <= K3_F32_TOL + K3_F32_TOL * b.abs()).all())
                     for a, b in ((out, w_out), (grad, w_grad)))
        else:
            ok = (float((out[:, 0] - w_out[:, 0]).abs().max()) <= K1_BF16_ATOL
                  and max(rel_l2(out, w_out), rel_l2(grad, w_grad)) <= VJP_BF16_REL)
        err = max(float((out - w_out).abs().max()), float((grad - w_grad).abs().max()))
        print(f"K3 sdf_vjp_fwd {act} on {VJP_CHECK_PTS} pts: max|err| {err:.3e}, rel-L2 out "
              f"{rel_l2(out, w_out):.3e} grad {rel_l2(grad, w_grad):.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"K3 {act}")
        if act == fc.act_dtype:
            res["sdf_vjp_fwd"] = {"max_abs_err": err}

        got = flat(vjp.sdf_vjp_bwd(ws, bs, cfg, x, c_out, c_grad, act))
        plain = flat(fvm.vjp(ws, bs, *args, x, c_out, c_grad, act_t))
        if act == "float32":
            truth = flat(fvm.vjp([w.double() for w in ws], [b.double() for b in bs], *args,
                                 x.double(), c_out.double(), c_grad.double(), torch.float64))
            bad = check_outputs(f"K4+K5 sdf_vjp_bwd f32 on {VJP_CHECK_PTS} pts to the plain "
                                "f64, max(2 x the plain f32's, 1e-5)", names, got, truth, 1e-5,
                                plain)
        else:
            bad = check_outputs(f"K4+K5 sdf_vjp_bwd bf16 on {VJP_CHECK_PTS} pts to the plain "
                                "bf16", names, got, plain, VJP_BF16_REL)
        if bad:
            fails.append(f"K4+K5 {act}")
        if act == fc.act_dtype:
            err = max(float((k - p).abs().max()) for k, p in zip(got, plain))
            res["sdf_vjp_bwd"], res["dw_reduce"] = {"max_abs_err": err}, {"max_abs_err": err}

    # times at the steady phase's shape, in the served dtype
    x, c_out, c_grad = inputs(VJP_TIME_PTS)
    act = fc.act_dtype
    act_t = getattr(torch, act)
    dnet = copy.deepcopy(net).requires_grad_(True)

    def double_backward():
        xx = x.clone().requires_grad_(True)
        s, f, gr = sdf_value_feat_grad(dnet, cfg, xx, act_t, create_graph=True)
        (torch.sum(s * c_out[:, 0]) + torch.sum(f.float() * c_out[:, 1:])
         + torch.sum(gr * c_grad)).backward()

    k5, k5_plain, k5_lib, _ = reduce_calls(ws, bs, cfg, act, VJP_TIME_PTS)
    t = time_in_turns(lambda: vjp.sdf_vjp_fwd(ws, bs, cfg, x, act),
                      lambda: vjp.sdf_vjp_bwd(ws, bs, cfg, x, c_out, c_grad, act),
                      lambda: fvm.value_and_grad(ws, bs, *args, x, act_t),
                      lambda: fvm.vjp(ws, bs, *args, x, c_out, c_grad, act_t),
                      double_backward, k5, k5_lib)
    t_k5_p = cuda_ms(k5_plain, reps=2)
    print(f"SDF-VJP {act} at {VJP_TIME_PTS} pts, ms in turns: forward K3 {t['fwd']:.2f} / plain "
          f"{t['fwd_plain']:.2f}; backward K4 + K5 {t['bwd']:.2f} / plain {t['bwd_plain']:.2f}, "
          f"of which the dW reduction K5 {t['reduce']:.2f} / plain products {t_k5_p:.2f} / one "
          f"addmm per factor pair {t['library']:.2f} (K5 {t['reduce'] / t['library']:.2f}x it); "
          f"forward + backward {t['fwd'] + t['bwd']:.2f}, torch double backward {t['other']:.2f}")
    b = sdf_vjp_bound(ws, bs, act, VJP_TIME_PTS)
    timed_entries(res, t, b, "sdf_vjp_fwd", "sdf_vjp_bwd", "double_backward_ms")
    res["dw_reduce"].update(ms=t["reduce"], plain_ms=t_k5_p, library_ms=t["library"],
                            **b["dw_reduce"])
    return res, fails


def library_rows(work, x_off: int, y_off: int, n: int, k: int, n_pts: int, act, dW,
                 db=None) -> None:
    """K5's yardstick for one factor pair (``sdf_field_vjp.dw_reduce_rows``'s
    arguments): dW += X^T Y as one ``addmm`` on the same float32 workspace
    rows K5 reads, and db += X.sum(0). A bf16 run multiplies in TF32, which
    rounds the operands and sums in f32 over the same bytes as K5; an f32
    run in full f32. The port never calls it."""
    import torch

    from neuralrecon_w_tpu_torch.ops.sdf_field_vjp import WMAX

    x = work.as_strided((n_pts, n), (WMAX, 1), work.storage_offset() + x_off)
    y = work.as_strided((n_pts, k), (WMAX, 1), work.storage_offset() + y_off)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = str(act).removeprefix("torch.") == "bfloat16"
    try:
        dW.addmm_(x.t(), y)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if db is not None:
        db += x.sum(0)


def library_layer(pk, work, rows: int, layer: int, n_pts: int, dW, db) -> None:
    """K5's yardstick for one SDF layer (``sdf_field_vjp.dw_reduce``'s
    arguments): one ``addmm`` per factor pair, (d, r_hat) then (g_tot, u),
    and db from g_tot (kinds u, z, d, a, r_hat, g_tot; csrc/sdf_vjp.cu)."""
    from neuralrecon_w_tpu_torch.ops.sdf_field_vjp import WMAX

    at = lambda kind: (kind * len(pk.k) + layer) * rows * WMAX  # noqa: E731
    n, k = pk.n[layer], pk.k[layer]
    library_rows(work, at(2), at(4), n, k, n_pts, pk.act, dW)
    library_rows(work, at(5), at(0), n, k, n_pts, pk.act, dW, db)


def library_reduce(fn):
    """fn() with K5's wrappers, as the modules that reduce through them
    (``ops/sdf_field_vjp``, ``ops/field_train``, ``ops/nerf_bg_fused``) call
    them, replaced by ``library_layer`` / ``library_rows``: the same factor
    pairs, each as one PyTorch call."""
    from neuralrecon_w_tpu_torch.ops import field_train as ft
    from neuralrecon_w_tpu_torch.ops import nerf_bg_fused as bgf
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    def run():
        with mock.patch.object(vjp, "dw_reduce", library_layer), \
                mock.patch.object(ft, "dw_reduce", library_layer), \
                mock.patch.object(ft, "dw_reduce_rows", library_rows), \
                mock.patch.object(bgf, "dw_reduce_rows", library_rows):
            fn()
    return run


def reduce_calls(ws, bs, cfg, act, n_pts):
    """K5 alone over the chunks of one SDF-VJP backward of n_pts points, the
    same dW products in torch (the plain version's), and as one PyTorch
    call per factor pair (``library_layer``), all on one workspace of
    random factor rows: three callables, and the (dWs, dbs) they add into."""
    import torch

    from neuralrecon_w_tpu_torch.ops import field_vjp_math as fvm
    from neuralrecon_w_tpu_torch.ops import sdf_field_vjp as vjp

    pk = vjp.pack_vjp_weights(ws, bs, cfg, act)
    n_layers = len(pk.k)
    work, rows = vjp.workspace(n_pts, 6, n_layers, ws[0].device)
    work.normal_()
    view = work.view(6, n_layers, rows, vjp.WMAX)
    chunks = [min(vjp.CHUNK, n_pts - c0) for c0 in range(0, n_pts, vjp.CHUNK)]
    dWs = [torch.zeros(n, k, device=work.device) for n, k in zip(pk.n, pk.k)]
    dbs = [torch.zeros(n, device=work.device) for n in pk.n]
    act_t = getattr(torch, act)

    def kernel():
        for m in chunks:
            for l in range(n_layers):
                vjp.dw_reduce(pk, work, rows, l, m, dWs[l], dbs[l])

    def plain():  # kinds u, z, d, a, r_hat, g_tot (csrc/sdf_vjp.cu)
        for m in chunks:
            for l, (n, k) in enumerate(zip(pk.n, pk.k)):
                dWs[l] += (fvm._mm(view[2, l, :m, :n].t(), view[4, l, :m, :k], act_t)
                           + fvm._mm(view[5, l, :m, :n].t(), view[0, l, :m, :k], act_t))
                dbs[l] += view[5, l, :m, :n].sum(dim=0)

    return kernel, plain, library_reduce(kernel), (dWs, dbs)


def train_config(cfg, grad_mode: str, act: str = None):
    """The FieldConfig of a training mode: 'pallas_field' with FUSED_BG on
    (the fused field and background kernels), the others with it off."""
    from neuralrecon_w_tpu_torch.config import field_config_from_cfg

    fc = field_config_from_cfg(cfg)._replace(
        grad_mode=grad_mode, bg_mode="pallas" if grad_mode == "pallas_field" else "xla")
    return fc._replace(act_dtype=act) if act else fc


def make_steps(cfg, fc, fine_level: int):
    from neuralrecon_w_tpu_torch.config import render_config_from_cfg
    from neuralrecon_w_tpu_torch.datasets.mask_utils import get_label_id_mapping
    from neuralrecon_w_tpu_torch.training.losses import loss_config_from_cfg
    from neuralrecon_w_tpu_torch.training.step import make_train_step

    rcfg = render_config_from_cfg(cfg, sfm_level=-1, fine_level=fine_level,
                                  nerf_far_override=False)
    lid = get_label_id_mapping()
    return make_train_step(fc, rcfg, loss_config_from_cfg(cfg), int(cfg.NEUCONW.ANNEAL_END),
                           tuple(lid[x] for x in cfg.NEUCONW.RAY_MASK_LIST),
                           seed=int(cfg.TRAINER.SEED) + 1)


def launch_counters() -> dict:
    """Each kernel's wrapper by its name in the kernels line; the wrapper's
    ``launches`` counts the launches of its kernel."""
    from neuralrecon_w_tpu_torch.ops import kernel_counters

    return kernel_counters()


def training_phase(cfg, state, scene, pool, fine_grid, fine_level, label, n_timed=TRAIN_TIMED):
    """Steps of the training path at batch TRAIN_BATCH: one untimed step per
    mode of TRAIN_MODES, then timed steps in turns, the modes in order and
    back ('pallas' / 'vjp' / 'pallas_field' / 'fwd' / 'fwd' / 'pallas_field'
    / 'vjp' / 'pallas'), each block n_timed // 2 steps. The launch counts are set to 0
    just before each step and read just after it, into that step's mode; on
    the card a mode fails if it leaves a kernel of MODE_KERNELS at 0 or
    launches one that is not its own, and each mode's peak device memory
    over its steps is printed. A mode of SIDE_MODES steps a copy of the
    state on batches of a copy of the pool, its update then dropped: the
    other modes' trajectory, and so the state step_parity starts from, stay
    those of the runs before it. Returns (rays/s per mode, the last aux per
    mode, launches per mode and kernel, fails)."""
    import torch

    steps = {m: make_steps(cfg, train_config(cfg, m), fine_level) for m in TRAIN_MODES}
    counters = launch_counters()
    launches = {m: dict.fromkeys(counters, 0) for m in steps}
    seconds = {m: 0.0 for m in steps}
    counts = {m: 0 for m in steps}
    peak = {m: 0 for m in steps}
    on_card = next(state.model.parameters()).device.type == "cuda"
    aux, fails = {}, []
    side_pool = copy.deepcopy(pool)

    def batch_for(mode):
        return (side_pool if mode in SIDE_MODES else pool).next_batch(TRAIN_BATCH)

    def step(mode, batch, st):
        for c in counters.values():
            c.launches = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _, aux[mode] = steps[mode](st, scene, batch, fine_grid)
        sync()
        if on_card:
            peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated())
        for n, c in counters.items():
            launches[mode][n] += c.launches

    def state_for(mode):
        return copy.deepcopy(state) if mode in SIDE_MODES else state

    for mode in TRAIN_MODES:
        step(mode, batch_for(mode), state_for(mode))
    for mode in TRAIN_MODES + TRAIN_MODES[::-1]:
        for _ in range(n_timed // 2):
            batch, st = batch_for(mode), state_for(mode)
            sync()
            t0 = time.perf_counter()
            step(mode, batch, st)
            seconds[mode] += time.perf_counter() - t0
            counts[mode] += 1
            bad = [k for k, v in aux[mode].items() if not bool(torch.isfinite(v))]
            if bad:
                fails.append(f"{label} {mode} step {state.step}: {bad} not finite")
    rps = {m: counts[m] * TRAIN_BATCH / seconds[m] for m in steps}
    print(f"training {label}: {counts['pallas']} timed steps per mode of {TRAIN_BATCH} rays: "
          "rays/s " + ", ".join(f"{m} {rps[m]:.1f}" for m in TRAIN_MODES) + "; " + "; ".join(
              f"{m} loss {float(aux[m]['loss']):.4f}, psnr {float(aux[m]['psnr']):.2f}"
              for m in TRAIN_MODES)
          + "; terms (pallas) " + ", ".join(f"{k} {float(v):.4g}" for k, v in aux["pallas"].items()))
    if on_card:
        print(f"peak device memory of a training {label} step: " + ", ".join(
            f"{m} {peak[m] / 2**30:.2f} GiB" for m in TRAIN_MODES))
    for m in TRAIN_MODES:
        print(f"launches in training {label} {m} ({counts[m] + 1} steps): " + ", ".join(
            f"{n} {v}" for n, v in launches[m].items() if v))
        # with a fine grid every step queries it: K11 (SURFACE_QUERY 'sampled')
        want = MODE_KERNELS[m] + (("sampled_hit",) if fine_grid is not None else ())
        if on_card:
            fails += [f"{n} not launched in training {label} {m}"
                      for n in want if launches[m][n] <= 0]
            fails += [f"{n} launched in training {label} {m}, not its kernel"
                      for n, v in launches[m].items() if v and n not in want]
    return rps, aux, launches, fails


def profile_step(cfg, state, scene, pool, fine_grid, fine_level, label) -> None:
    """torch.profiler over one warm training step per grad mode: the
    device time by the step's spans (``tracing.span_ms``: train.render_loss
    with the renderer's render.importance, render.background and
    render.foreground inside it, train.backward, train.optimizer, each
    timed between its two marker kernels on the card), the busy share of
    the wall, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuralrecon_w_tpu_torch.tracing import DEVICE, SPANS, span_ms

    device_spans = {s.name for s in SPANS if s.kind == DEVICE}
    for mode in TRAIN_MODES:
        step = make_steps(cfg, train_config(cfg, mode), fine_level)
        step(state, scene, pool.next_batch(TRAIN_BATCH), fine_grid)
        batch = pool.next_batch(TRAIN_BATCH)
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, scene, batch, fine_grid)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        spans = {k: v for k, v in span_ms().items() if k in device_spans}
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key not in device_spans]
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
        print(f"profile training {label} {mode} step of {TRAIN_BATCH} rays: wall {wall_ms:.1f} ms, "
              f"{sum(e.count for e in device)} kernels busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f} %); device-timeline ms by span: "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(spans.items())))
        print("  top kernels, self device ms: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} (x{e.count})" for e in top))


def step_parity(cfg, model, scene, batch, fine_grid, fine_level, label, step: int = 3):
    """From one copy of the model and one batch, one step in each mode of
    TRAIN_MODES, in f32 and in the served dtype: the losses and every
    parameter gradient. In f32 each other mode ('pallas', 'pallas_field'
    with FUSED_BG, 'fwd') is held to 'vjp'; in bf16 each is held to the f32
    'vjp' gradient (PARITY_BF16_*), as 'vjp' in bf16 is ('fwd' runs its SDF
    net in f32 there too, its colour head in bf16)."""
    from neuralrecon_w_tpu_torch.training.step import TrainState

    fails, ref = [], None
    for act in dict.fromkeys(("float32", train_config(cfg, "vjp").act_dtype)):
        out = {}
        for mode in TRAIN_MODES:
            m = copy.deepcopy(model)
            st = TrainState(m, GradCapture(m), step)
            _, aux = make_steps(cfg, train_config(cfg, mode, act), fine_level)(
                st, scene, batch, fine_grid)
            out[mode] = (aux, st.optimizer.grads)
        a_v, g_v = out["vjp"]
        if act == "float32":
            ref = g_v
        for mode in (m for m in TRAIN_MODES if m != "vjp"):
            a_k, g_k = out[mode]
            errs = {k: rel_l2(g_k[k], g_v[k]) for k in g_v}
            if act == "float32":
                loss_tol, bound = PARITY_F32
                bounds = dict.fromkeys(g_v, bound)
                rule = f"bound {bound}"
            else:
                loss_tol = PARITY_BF16_LOSS
                e_k = {k: rel_l2(g_k[k], ref[k]) for k in g_v}
                e_v = {k: rel_l2(g_v[k], ref[k]) for k in g_v}
                bounds = {k: max(PARITY_BF16_RATIO * e_v[k], PARITY_BF16_FLOOR) for k in g_v}
                errs = e_k
                rule = (f"to f32 'vjp', bound max({PARITY_BF16_RATIO} x vjp's, "
                        f"{PARITY_BF16_FLOOR}); {mode} / vjp / between the modes")
            loss_bad = [k for k in a_v if abs(float(a_k[k]) - float(a_v[k]))
                        > loss_tol * abs(float(a_v[k])) and k not in ("psnr", "s_val")]
            bad = sorted(k for k, e in errs.items() if e > bounds[k])
            worst = sorted(errs, key=lambda k: -errs[k] / bounds[k])[:4]
            show = ((lambda k: f"{errs[k]:.2e}") if act == "float32" else
                    (lambda k: f"{e_k[k]:.2e}/{e_v[k]:.2e}/{rel_l2(g_k[k], g_v[k]):.2e}"))
            print(f"parity {label} {act}, {mode} vs vjp: losses "
                  + ", ".join(f"{k} {float(a_k[k]):.6g}/{float(a_v[k]):.6g}" for k in a_v)
                  + f"; grad rel-L2 ({rule}), nearest their bound: "
                  + ", ".join(f"{k} {show(k)}" for k in worst))
            print("  grad rel-L2 of the SDF net: " + ", ".join(
                f"{k.split('sdf_net.')[1]} {show(k)}" for k in errs if "sdf_net" in k))
            if loss_bad or bad:
                fails.append(f"parity {label} {act} {mode}: losses {loss_bad}, grads {bad}")
    return fails


# ------------------------- K10 / K11 and the device pool -------------------------

# K10 (the DDA) and K11 (the sampled first hit, csrc/ray_voxel.cu) against
# their plain versions: torch.equal on every output, since the kernels run
# the plain versions' float32 arithmetic operation for operation (no FMA
# contraction). K10 at level 10 with first_only over K10_RAYS rays or more.
K10_RAYS = 1 << 20
# float32 operations of the grid queries, counted off csrc/ray_voxel.cu
# (integer index arithmetic left out): K10 ~70 a ray to set up (slab
# entry / exit, first cell, tmax, tdelta) and 5 a loop trip (the argmin's 2
# compares, the tmax add, the exit and first-hit compares); K11 1 a ray and
# 26 a walked sample (t: 2; per axis p: 2, the inside test, the cell: 5)
K10_RAY_OPS, K10_TRIP_OPS, K11_RAY_OPS, K11_SAMPLE_OPS = 70, 5, 1, 26


def level10_rays(fine_host, n: int, seed: int = SEED):
    """(o, d) float32 (n, 3) in the fine grid's normalised coordinates,
    four kinds a quarter each: from outside the cube toward the shell; axis
    parallel (one or two direction components exactly 0); from the centres
    of occupied cells in seeded directions; from outside pointing away
    (misses)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = n // 4

    def unit(m):
        v = rng.standard_normal((m, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    o1 = unit(q) * 1.8
    d1 = rng.standard_normal((q, 3)) * 0.25 - o1
    o2 = rng.uniform(-1.4, 1.4, (q, 3))
    d2 = np.zeros((q, 3))
    axis = rng.integers(0, 3, q)
    d2[np.arange(q), axis] = rng.choice([-1.0, 1.0], q)
    two = np.arange(q) % 2 == 1  # every other one: a zero in one component only
    d2[two] = unit(int(two.sum()))
    d2[two, axis[two]] = 0.0
    res = 1 << fine_host.level
    cells = fine_host.coords[rng.integers(0, len(fine_host.coords), q)]
    o3 = (cells + 0.5) / res * 2.0 - 1.0
    d3 = unit(q)
    m = n - 3 * q
    o4 = unit(m) * rng.uniform(1.8, 3.0, (m, 1))
    d4 = o4 / np.linalg.norm(o4, axis=-1, keepdims=True) + rng.standard_normal((m, 3)) * 0.1
    o = np.concatenate([o1, o2, o3, o4])
    d = np.concatenate([d1, d2, d3, d4])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def in_turns(kernel, plain, reps_k: int = 5, reps_p: int = 1):
    """CUDA-event ms of a kernel and its plain version in turns (plain,
    kernel, kernel, plain): the kernel's best, the plain version's mean."""
    p1, k1, k2, p2 = (cuda_ms(plain, reps_p), cuda_ms(kernel, reps_k), cuda_ms(kernel, reps_k),
                      cuda_ms(plain, reps_p))
    return min(k1, k2), (p1 + p2) / 2


def ray_kernel_cases(scene, sfm_grid, sfm_level, fine_grid, fine_host, frames, rcfg_steady):
    """ray_kernel_phase's inputs: K10's cases [(label, grid, level, o, d,
    first_only)] (one served chunk, the serving frames and the training
    cache at the SFM level; level10_rays at the fine level, first_only)
    and K11's (grid, level, o, d, t_lo, t_hi, n_samples) on the steady
    chunk, made as near_far_from_fine_grid makes them."""
    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.rendering.renderer import near_far_from_sfm_grid

    dev = scene.origin.device
    rows, _ = training_rays()
    srv = torch.as_tensor(np.concatenate(frames), device=dev)
    cache = torch.as_tensor(rows, device=dev)
    o10, d10 = level10_rays(fine_host, K10_RAYS)
    sfm = lambda rays: ((rays[:, :3] - sfm_grid.origin) / sfm_grid.scale,  # noqa: E731
                        rays[:, 3:6].contiguous())
    k10 = [(f"level {sfm_level} chunk", sfm_grid, sfm_level, *sfm(srv[:CHUNK]), False),
           (f"level {sfm_level} serving", sfm_grid, sfm_level, *sfm(srv), False),
           (f"level {sfm_level} cache", sfm_grid, sfm_level, *sfm(cache), False),
           (f"level {fine_host.level} first_only", fine_grid, fine_host.level,
            torch.as_tensor(o10, device=dev), torch.as_tensor(d10, device=dev), True)]
    k10 = [(label, grid, level, o.contiguous(), d, first)
           for label, grid, level, o, d, first in k10]
    rays = torch.as_tensor(frames[1][:CHUNK], device=dev)
    rays_o = (rays[:, :3] - scene.origin) / scene.radius
    near, far, _ = near_far_from_sfm_grid(rcfg_steady, scene, sfm_grid, rays_o, rays[:, 3:6],
                                          rays[:, 6:7] / scene.radius, rays[:, 7:8] / scene.radius)
    o = ((rays_o * scene.radius + scene.origin) - fine_grid.origin) / fine_grid.scale
    t_lo = (near[:, 0] * scene.radius / fine_grid.scale).contiguous()
    t_hi = (far[:, 0] * scene.radius / fine_grid.scale).contiguous()
    k11 = (fine_grid, fine_host.level, o.contiguous(), rays[:, 3:6].contiguous(), t_lo, t_hi,
           rcfg_steady.surface_query_samples)
    return k10, k11


def ray_kernel_phase(scene, sfm_grid, sfm_level, fine_grid, fine_host, frames, rcfg_steady):
    """K10 at the SFM level over one served chunk's rays, the serving
    frames' and the training cache's (the SFM near / far of serving and of
    the ray cache), K10 at level 10 with first_only over level10_rays (the
    band cache's query), K11 at the steady serving chunk's n_samples: each
    held to its plain version with torch.equal, each ray's trips to the
    plain walk's, timed against it in turns. K10's pre-pass (its coarse
    mask, ``ray_voxel.coarse_mask``) is held to its plain version and timed
    alone at each grid K10 runs it on (from ``MASK_FROM`` up); each K10
    case prints the share of its trips whose global read the mask skipped
    (the plain version's ``global_reads``: none below ``MASK_FROM``).
    ``bound_ms``: the larger of the bytes (each ray's inputs read and
    outputs written once, and each distinct occupancy word the walk reads
    once, counted by the plain version's ``touched`` on this run's rays)
    over the memory rate, and the float32 operations (K10_* / K11_*, over
    the trips the kernel counted in this run) over the FMA pipes' peak."""
    import torch

    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    dev = scene.origin.device
    fails, cases, prepass = [], {}, {}
    for level, grid in ((sfm_level, sfm_grid), (fine_host.level, fine_grid)):
        if level < rv.MASK_FROM:  # K10 runs no pre-pass there
            continue
        got = rv.coarse_mask(grid.occ, level)
        equal = torch.equal(got, rv.coarse_words_plain(grid.occ, level, rv.mask_shift(level)))
        ms = cuda_ms(lambda: rv.coarse_mask(grid.occ, level), 20)
        prepass[level] = ms
        print(f"K10 pre-pass at level {level}: {grid.occ.numel()} words to a coarse mask of "
              f"{got.numel()} (blocks of {1 << rv.mask_shift(level)}^3 cells), "
              f"{int(rv._popcount32(got.long() & 0xFFFFFFFF).sum())} blocks "
              f"occupied; equal to the plain mask {equal}; {ms:.4f} ms -> "
              f"{'ok' if equal else 'FAIL'}")
        if not equal:
            fails.append(f"K10 pre-pass at level {level}")
    k10, k11 = ray_kernel_cases(scene, sfm_grid, sfm_level, fine_grid, fine_host, frames,
                                rcfg_steady)
    for label, grid, level, o, d, first in k10:
        r = o.shape[0]
        trips = torch.empty(r, dtype=torch.int32, device=dev)
        touched = torch.zeros_like(grid.occ)
        plain_trips, reads = torch.empty_like(trips), torch.empty_like(trips)
        got = rv.dda_traverse(grid.occ, level, o, d, first, steps_out=trips)
        want = rv.dda_traverse_plain(grid.occ, level, o, d, first, touched=touched,
                                     steps_out=plain_trips, global_reads=reads)
        sync()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        n_trips, words = float(trips.double().sum()), int((touched > 0).sum())
        if float(touched.double().sum()) != n_trips or not torch.equal(trips, plain_trips):
            fails.append(f"K10 {label}: the plain version read {float(touched.sum())} words "
                         f"in {float(plain_trips.double().sum())} trips, the kernel made "
                         f"{n_trips} trips")
        skipped = 1.0 - float(reads.double().sum()) / max(n_trips, 1.0)
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        ms, plain_ms = in_turns(lambda: rv.dda_traverse(grid.occ, level, o, d, first),
                                lambda: rv.dda_traverse_plain(grid.occ, level, o, d, first))
        mean_trips = float(trips.float().mean())
        b = bound(r * K10_RAY_OPS + n_trips * K10_TRIP_OPS, r * (24 + 4 + 4 + 1) + 4 * words,
                  "simt")
        print(f"K10 dda {label} on {r} rays: {int(got[2].sum())} hit, mean {mean_trips:.1f} "
              f"steps (max {int(trips.max())}), {words} distinct words of {grid.occ.numel()}, "
              f"the mask skipped the global read of {skipped:.4f} of the steps; torch.equal "
              f"{equal}; kernel {ms:.4f} ms ("
              + (f"its pre-pass {prepass[level]:.4f}" if level in prepass else "no pre-pass")
              + f"), plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) -> "
              f"{'ok' if equal else 'FAIL'}")
        if not equal:
            fails.append(f"K10 {label}")
        cases[label] = {"rays": r, "mean_steps": mean_trips, "words": words, "max_abs_err": err,
                        "skipped_share": skipped, "prepass_ms": prepass.get(level), "ms": ms,
                        "plain_ms": plain_ms, **b}
    head = cases[f"level {fine_host.level} first_only"]
    res = {"dda": {**head, "library_ms": None, "cases": cases}}

    # K11 on the steady chunk, its inputs as near_far_from_fine_grid makes them
    _, level, o, d, t_lo, t_hi, k = k11
    trips = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
    plain_trips = torch.empty_like(trips)
    touched = torch.zeros_like(fine_grid.occ)
    got = rv.sampled_first_hit(fine_grid, level, o, d, t_lo, t_hi, k, steps_out=trips)
    want = rv.sampled_first_hit_plain(fine_grid, level, o, d, t_lo, t_hi, k, touched=touched,
                                      steps_out=plain_trips)
    sync()
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    if not torch.equal(trips, plain_trips):
        fails.append(f"K11: the kernel walked {float(trips.double().sum())} samples, the plain "
                     f"walk {float(plain_trips.double().sum())}")
    err = float((got[0] - want[0]).abs().max())
    ms, plain_ms = in_turns(lambda: rv.sampled_first_hit(fine_grid, level, o, d, t_lo, t_hi, k),
                            lambda: rv.sampled_first_hit_plain(fine_grid, level, o, d, t_lo,
                                                               t_hi, k), reps_p=3)
    r = o.shape[0]
    mean_trips = float(trips.float().mean())
    words = int((touched > 0).sum())
    b = bound(r * K11_RAY_OPS + float(trips.double().sum()) * K11_SAMPLE_OPS,
              r * (24 + 8 + 4 + 1) + 4 * words, "simt")
    print(f"K11 sampled_hit at {k} samples on the steady chunk's {r} rays: "
          f"{int(got[1].sum())} hit, mean {mean_trips:.1f} samples walked, {words} distinct "
          f"words; torch.equal {equal}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}) -> {'ok' if equal else 'FAIL'}")
    if not equal:
        fails.append("K11")
    res["sampled_hit"] = {"rays": r, "samples": k, "mean_steps": mean_trips, "words": words,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          **b}
    return res, fails


# A captured window against the same window of eager steps, one state,
# f32 at PERTURB 0: the same kernels in the same order, every sum in a fixed
# order (the appearance rows are gathered by indexing, whose backward is a
# sorted index_put; an index_add's atomics made graph and eager differ by up
# to 3e-4 on the depth term, PERF.md section 6), so in 'vjp' and 'fwd' the
# two agree to the bit in practice; GRAPH_LOSS_RTOL on every loss term and
# GRAPH_PARAM_REL (rel-L2) on all parameters leave room for a library kernel
# that sums in another order on the capture stream. K5 sums its dW with
# float atomics, so in the modes that run it (ATOMIC_MODES) a window differs
# from itself, eager or replayed, and the steps amplify that: there three
# eager and two graph windows run in turns (eager, graph, eager, graph,
# eager). The noise is read from the eager windows alone, the largest
# difference of any two of them: each graph window is held to the first
# eager one within max(GRAPH_LOSS_RTOL, 2 x that) on each term and
# max(GRAPH_PARAM_REL, 2 x that) on the parameters, and the two graph
# windows to each other within the same bounds, so that a graph that does
# not repeat fails and cannot widen its own bound. Every window is
# GRAPH_INNER steps, few enough to keep the modes' windows within the
# script's wall. At the
# operating point (bf16, perturb on) the graph's jitter comes from its own
# generator, not the eager steps' per-step ones, so only the mean of the
# per-step losses over the window is held, within GRAPH_MEAN_REL.
GRAPH_INNER = 5
GRAPH_LOSS_RTOL, GRAPH_PARAM_REL, GRAPH_MEAN_REL = 1e-5, 1e-5, 2e-2
ATOMIC_MODES = ("pallas", "pallas_hybrid", "pallas_field")
# the kernel modes held graph against eager at full width (steady phase),
# and the modes timed eager against graph in turns (RATE_INNER steps a
# window, 3 to keep the script's wall: a mode runs 2 + 5 x RATE_INNER
# steps), 'vjp' beside them
GRAPH_MODES = ("pallas", "pallas_field", "fwd")
RATE_MODES = ("vjp", "pallas", "pallas_hybrid", "pallas_field", "fwd")
# 'pallas_hybrid' runs the plain SDF forward and the kernels' backward
RATE_KERNELS = {**MODE_KERNELS,
                "pallas_hybrid": ("sdf_mlp", "up_sample", "sdf_vjp_bwd", "dw_reduce")}
RATE_INNER = 3


def flat_params(model):
    import torch

    return torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])


def scan_run(cfg, fc, rcfg, batch: int, n_inner: int, graph: bool):
    from neuralrecon_w_tpu_torch.datasets.mask_utils import get_label_id_mapping
    from neuralrecon_w_tpu_torch.training.losses import loss_config_from_cfg
    from neuralrecon_w_tpu_torch.training.step import make_scan_train_fn

    lid = get_label_id_mapping()
    # a graph run captures on the card and runs the plain loop on the CPU
    return make_scan_train_fn(fc, rcfg, loss_config_from_cfg(cfg), int(cfg.NEUCONW.ANNEAL_END),
                              tuple(lid[x] for x in cfg.NEUCONW.RAY_MASK_LIST), batch, n_inner,
                              seed=int(cfg.TRAINER.SEED) + 1, graph=None if graph else False)


def capturable_copy(state):
    """A copy of a training state, its optimiser (any TRAINER.OPTIMIZER)
    made capturable on the card (the same update eager and replayed); on
    the CPU a plain copy."""
    st = copy.deepcopy(state)
    if next(st.model.parameters()).device.type == "cuda":
        st.optimizer.make_capturable()
    return st


def free_cached() -> None:
    """Every cached block back to the card (a no-op on the CPU)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def graph_parity(cfg, state0, scene, pool, fine_grid, fine_level, label, batch=TRAIN_BATCH,
                 n_inner=GRAPH_INNER, profile=False, mode="vjp"):
    """make_scan_train_fn with graph=True against graph=False in SDF_GRAD_MODE
    ``mode`` (train_config's) from copies of state0 (``capturable_copy``:
    its optimiser, whichever it is, made capturable) over one window of
    ``pool`` (a DeviceRayPool, its band cache attached where fine_grid is
    given): in f32 at PERTURB 0 one call of n_inner steps each (in
    ATOMIC_MODES three eager and two graph ones in turns, the bounds from
    the eager ones: see GRAPH_INNER); at the operating point n_inner
    one-step calls each, the per-step losses. Each window's run is released before the
    next, so that a graph and an eager window never hold their memory at
    once. Beside the bounds, ``out["f32"]`` reports how far the graph's
    change of the parameters over the window is from the eager one's
    (``change_rel``: ||p_graph - p_eager|| / ||p_eager - p0||), how far the
    eager window moved them (``moved``: rel-L2 from p0), the graph run's
    (captures, replays) and each side's update count; ``out["runs"]``
    holds every window's run, released.
    With ``profile``, a torch.profiler window over one more call of n_inner
    replays: the device's busy share."""
    import torch

    from neuralrecon_w_tpu_torch.config import render_config_from_cfg

    fails, out = [], {"runs": []}
    p0 = flat_params(state0.model)
    served = train_config(cfg, mode).act_dtype
    atomic = mode in ATOMIC_MODES
    for act, perturb in (("float32", 0.0), (served, float(cfg.NEUCONW.PERTURB))):
        fc = train_config(cfg, mode, act)
        rcfg = render_config_from_cfg(cfg, sfm_level=-1, fine_level=fine_level,
                                      nerf_far_override=False, perturb=perturb)
        perm, start = pool.take_scan_window(batch, n_inner)
        perm = perm.clone()
        one = act != "float32"
        order = (("eager", "graph") * 2 + ("eager",) if atomic and not one
                 else ("graph", "eager"))
        trace, walls = {"graph": [], "eager": []}, []
        for run_mode in order:
            st = capturable_copy(state0)
            run = scan_run(cfg, fc, rcfg, batch, 1 if one else n_inner, run_mode == "graph")
            losses, aux = [], None
            sync()
            t0 = time.perf_counter()
            for i in range(n_inner if one else 1):
                st, aux = run(st, scene, pool.data, fine_grid, None, perm,
                              start + (i * batch if one else 0))
                if one:
                    losses.append(float(aux["loss"]))
            sync()
            walls.append(time.perf_counter() - t0)
            trace[run_mode].append({"aux": {k: float(v) for k, v in aux.items()},
                                    "params": flat_params(st.model), "losses": losses,
                                    "runs": (run.captures, run.replays),
                                    "count": st.optimizer.count})
            run.release()
            out["runs"].append(run)
            del run, st, aux
            free_cached()
        g, e = trace["graph"][0], trace["eager"][0]
        if act == "float32":
            def term_rel(a, b):
                return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b}

            def param_rel(a, b):
                return float((a - b).norm() / b.norm())

            def spread(ts):
                """The largest difference of any two windows: per term, parameters."""
                pairs = list(itertools.combinations(ts, 2))
                rels = [term_rel(x["aux"], y["aux"]) for x, y in pairs]
                return ({k: max(r[k] for r in rels) for k in rels[0]},
                        max(param_rel(x["params"], y["params"]) for x, y in pairs))

            # every graph window against the first eager one
            rels = [term_rel(t["aux"], e["aux"]) for t in trace["graph"]]
            rel = {k: max(r[k] for r in rels) for k in rels[0]}
            p_rel = max(param_rel(t["params"], e["params"]) for t in trace["graph"])
            t_bound = dict.fromkeys(rel, GRAPH_LOSS_RTOL)
            p_bound, note, ok = GRAPH_PARAM_REL, "", True
            if atomic:
                e_rel, e_p = spread(trace["eager"])
                g_rel, g_p = spread(trace["graph"])
                t_bound = {k: max(GRAPH_LOSS_RTOL, 2 * e_rel[k]) for k in rel}
                p_bound = max(GRAPH_PARAM_REL, 2 * e_p)
                g_worst = max(g_rel, key=lambda k: g_rel[k] / t_bound[k])
                ok = all(g_rel[k] <= t_bound[k] for k in g_rel) and g_p <= p_bound
                note = (f"; the {len(trace['eager'])} eager windows' spread: worst term rel "
                        f"{max(e_rel.values()):.2e}, parameters rel-L2 {e_p:.2e}; graph against "
                        f"graph (held to the same bounds): {g_worst} rel {g_rel[g_worst]:.2e}, "
                        f"parameters rel-L2 {g_p:.2e}")
            worst = max(rel, key=lambda k: rel[k] / t_bound[k])
            ok = ok and all(rel[k] <= t_bound[k] for k in rel) and p_rel <= p_bound
            step_e = float((e["params"] - p0).norm())
            change = max(float((t["params"] - e["params"]).norm()) / max(step_e, 1e-30)
                         for t in trace["graph"])
            moved = step_e / float(p0.norm())
            print(f"graph vs eager {label} {mode} f32 PERTURB 0, {n_inner} steps from one state "
                  f"({g['runs'][0]} capture, {g['runs'][1]} replays): loss "
                  f"{g['aux']['loss']:.7f} / {e['aux']['loss']:.7f}; worst term {worst} rel "
                  f"{rel[worst]:.2e} (bound {t_bound[worst]:.2e}); parameters rel-L2 "
                  f"{p_rel:.2e} (bound {p_bound:.2e}){note}; their change over the window "
                  f"against eager's rel-L2 {change:.2e}, eager moved them rel-L2 {moved:.3e}; "
                  "wall (" + ", ".join(order) + ") "
                  + " / ".join(f"{w:.3f}" for w in walls) + f" s -> {'ok' if ok else 'FAIL'}")
            out["f32"] = {"worst_term": worst, "term_rel": rel[worst], "param_rel_l2": p_rel,
                          "param_bound": p_bound, "change_rel": change, "moved": moved,
                          "runs": g["runs"], "counts": (g["count"], e["count"])}
        else:
            m_g, m_e = (sum(t["losses"]) / len(t["losses"]) for t in (g, e))
            rel = abs(m_g - m_e) / abs(m_e)
            ok = rel <= GRAPH_MEAN_REL and all(map(math.isfinite, g["losses"]))
            print(f"graph vs eager {label} {mode} {act} perturb {perturb}, {n_inner} one-step "
                  f"calls: mean loss {m_g:.5f} / {m_e:.5f} (rel {rel:.2e}); per step graph "
                  + ", ".join(f"{v:.4f}" for v in g["losses"]) + "; eager "
                  + ", ".join(f"{v:.4f}" for v in e["losses"]) + f" -> {'ok' if ok else 'FAIL'}")
            out[act] = {"mean_loss_rel": rel}
        if not ok:
            fails.append(f"graph vs eager {label} {mode} {act}")
    if profile:
        rcfg = render_config_from_cfg(cfg, sfm_level=-1, fine_level=fine_level,
                                      nerf_far_override=False)
        run = scan_run(cfg, train_config(cfg, mode), rcfg, batch, n_inner, True)
        profile_replays(run, copy.deepcopy(state0), scene, pool, fine_grid, batch, n_inner,
                        f"{label} {mode}")
        run.release()
        free_cached()
    return out, fails


def graph_rates(cfg, state0, scene, pool, fine_grid, fine_level, label, modes=RATE_MODES,
                batch=TRAIN_BATCH, n_inner=RATE_INNER):
    """Per mode at the operating point, from copies of state0, windows of
    n_inner steps timed in turns: eager, graph, graph, eager, each eager
    one after an untimed eager step. The graph's
    first call (its warm-up steps and the capture) comes before its first
    timed window and is timed on its own, its peak device memory read over
    it, and the memory the allocator holds once it is done (the graph's
    private pool and the live state: ``memory_reserved``); the graph is
    released before the last eager window, so that the two never hold
    their memory at once. Returns ({mode: {"eager", "graph" rays/s,
    "capture_s", "peak_gib", "held_gib", "per_step"}}, launches by kernel of
    the windows, eager and replayed, fails). Every mode must
    replay a graph and launch its RATE_KERNELS in a captured step."""
    import torch

    from neuralrecon_w_tpu_torch.config import render_config_from_cfg
    from neuralrecon_w_tpu_torch.training.step import GRAPH_WARMUP

    rcfg = render_config_from_cfg(cfg, sfm_level=-1, fine_level=fine_level,
                                  nerf_far_override=False)
    warm = min(GRAPH_WARMUP, n_inner)
    counters = launch_counters()
    launches = dict.fromkeys(read_counts(), 0)
    on_card = scene.origin.device.type == "cuda"
    res, fails = {}, []
    for mode in modes:
        fc = train_config(cfg, mode)
        runs = {m: scan_run(cfg, fc, rcfg, batch, n_inner, m == "graph")
                for m in ("eager", "graph")}
        states = {m: capturable_copy(state0) for m in runs}
        walls = {"eager": [], "graph": []}
        r = res[mode] = {}

        def window(m):
            perm, start = pool.take_scan_window(batch, n_inner)
            sync()
            t0 = time.perf_counter()
            states[m], aux = runs[m](states[m], scene, pool.data, fine_grid, None, perm, start)
            sync()
            bad = [k for k, v in aux.items() if not bool(torch.isfinite(v))]
            if bad:
                fails.append(f"graph rates {label} {mode} {m}: {bad} not finite")
            return time.perf_counter() - t0

        def eager_step():
            # one untimed eager step before each eager window, so that no
            # timed window pays for the mode's first use or for the
            # allocator's blocks after free_cached
            perm, start = pool.take_scan_window(batch, 1)
            states["eager"], _ = one_step(states["eager"], scene, pool.data, fine_grid, None,
                                          perm, start)

        one_step = scan_run(cfg, fc, rcfg, batch, 1, False)
        reset_counts(counters)
        eager_step()
        walls["eager"].append(window("eager"))
        free_cached()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        r["capture_s"] = window("graph")
        if on_card:
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            r["held_gib"] = torch.cuda.memory_reserved() / 2**30
        walls["graph"] += [window("graph"), window("graph")]
        g = runs["graph"]
        r["per_step"] = dict(g.per_step_launches)
        # a capture counts its launches but runs no step
        got = {k: v + (g.replays - g.captures) * g.per_step_launches.get(k, 0)
               for k, v in read_counts().items()}
        g.release()
        free_cached()
        reset_counts(counters)
        eager_step()
        walls["eager"].append(window("eager"))
        got = {k: v + read_counts()[k] for k, v in got.items()}
        for k, v in got.items():
            launches[k] += v
        r.update({m: n_inner * batch / (sum(w) / len(w)) for m, w in walls.items()})
        mem = (f"; peak {r['peak_gib']:.2f} GiB over the capture call, "
               f"{r['held_gib']:.2f} GiB held after it" if on_card else "")
        print(f"graph rates {label} {mode}, {n_inner}-step windows of {batch} rays in turns "
              f"eager / graph / graph / eager: " + " / ".join(
                  f"{n_inner * batch / w:.1f}" for w in (walls["eager"][0], *walls["graph"],
                                                         walls["eager"][1]))
              + f" rays/s; capture call ({warm} warm-up steps, the capture, {n_inner - warm} "
              f"replays) "
              f"{r['capture_s']:.3f} s{mem}; {g.captures} capture, {g.replays} replays; "
              "launches a captured step: " + ", ".join(
                  f"{k} {v}" for k, v in sorted(r["per_step"].items())))
        want = RATE_KERNELS[mode]
        if on_card:
            if not graph_ran(g):
                fails.append(f"graph rates {label} {mode}: no graph replayed")
            fails += [f"graph rates {label} {mode}: {n} not in a captured step" for n in want
                      if r["per_step"].get(n, 0) <= 0]
            fails += [f"graph rates {label} {mode}: {n} in a captured step, not its kernel"
                      for n in r["per_step"] if n not in want + ("sdf_mlp_bf16", "sdf_mlp_f32")]
        del runs, states, g
        free_cached()
    return res, launches, fails


def profile_replays(run, state, scene, pool, fine_grid, batch, n_inner, label) -> None:
    """At the operating point: one call of n_inner steps to capture, then
    one of n_inner replays under torch.profiler: wall, the device's busy
    share, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    perm, start = pool.take_scan_window(batch, n_inner)
    run(state, scene, pool.data, fine_grid, None, perm, start)
    perm, start = pool.take_scan_window(batch, n_inner)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state, scene, pool.data, fine_grid, None, perm, start)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(("render.", "train."))]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    print(f"profile {label} graph window at the operating point, {n_inner} replays of {batch} "
          f"rays: wall {wall_ms:.1f} "
          f"ms ({wall_ms / n_inner:.2f} a step), {sum(e.count for e in device)} kernels busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    print(events.table(sort_by="self_device_time_total", row_limit=10))


# the training CLI on the device pool: TRAINER_STEPS steps in windows of
# POOL_SCAN_INNER, the host-pool run's refreshes, saves and validation,
# then POOL_RESUME steps resumed from its last save. The workspace's 78,208
# cached rays hold 9 batches of 8192, so a SCAN_INNER of 10 is capped to 9,
# which the log interval (TRAINER_LOG) does not divide; windows of 5 keep
# the logged rays/s windows aligned with the host pool's. The resume keeps
# the grid it restored (UPDATE_FREQ past its end): its band cache is
# attached at its start from the checkpoint's grid, and a level-10 refresh
# of ~17.5 M cells (~28 s on the host) would add nothing to what it checks
POOL_SCAN_INNER, POOL_RESUME = 5, 2


def plain_band(grid, level: int, rays):
    """The band cache's rows by the plain DDA: ``grid_near_far(grid, level,
    o, d, first_only=True)``'s (near, valid) with ``dda_traverse_plain`` in
    K10's place."""
    import torch

    from neuralrecon_w_tpu_torch.ops.ray_voxel import dda_traverse_plain

    o = (rays[:, 0:3] - grid.origin) / grid.scale
    t_first, _, hit = dda_traverse_plain(grid.occ, level, o, rays[:, 3:6], True)
    valid = hit & (t_first > 1e-4)
    return torch.where(valid, t_first * grid.scale, torch.zeros_like(t_first)), valid


def graph_launches(runs, counted: dict) -> dict:
    """What the CUDA graphs of ``runs`` (multi-step runs: a Trainer's
    ``scan_runs()``) add to the launches counted while they ran, keyed as
    ``counted``: the wrappers count each captured launch once, at capture,
    and a capture runs no step, so each run adds (replays - captures) x the
    launches one captured step records (as ``scan_launches`` does for a
    served frame)."""
    out = dict.fromkeys(counted, 0)
    for run in runs:
        for n, v in run.per_step_launches.items():
            out[n] = out.get(n, 0) + v * (run.replays - run.captures)
    return out


def graph_ran(run) -> bool:
    """A multi-step run that captured one graph and replayed it."""
    return run.captures == 1 and run.replays > 0


def resume_graph_fails(tr, mode: str) -> list:
    """A resumed Trainer must have run its window as one replayed graph
    whose captured step launched the kernels of ``mode`` (MODE_KERNELS)."""
    runs = tr.scan_runs()
    if len(runs) != 1 or not graph_ran(runs[0]):
        return [f"the {mode} train_cli resume ran no captured window: "
                + ", ".join(f"{r.captures} capture(s), {r.replays} replays" for r in runs)]
    per = runs[0].per_step_launches
    print(f"the {mode} train_cli resume's captured step: " + ", ".join(
        f"{k} {v}" for k, v in sorted(per.items())) + f"; {runs[0].replays} replays")
    return [f"the {mode} train_cli resume: {n} not in its captured step"
            for n in MODE_KERNELS[mode] if per.get(n, 0) <= 0]


def device_pool_trainer_phase(root: str, overrides: dict, device: str, extra: list,
                              host_rates: dict, card: str = "the CPU"):
    """``train_cli.main`` with TPU.DEVICE_POOL 'auto' (on the card: the
    device pool, its band cache, POOL_SCAN_INNER steps a CUDA graph replay)
    on trainer_phase's workspace and cache, its refreshes, saves and
    validation, then a resume of POOL_RESUME steps from the last save.
    Checks the step, that the device pool and (on the card) the graph ran,
    every graph launch accounted ((replays - captures) x the launches one
    captured step records, and no kernel beyond K1 and K2 in a step), the band cache after
    every attach against the plain DDA on every pool row (torch.equal), the
    epoch windows disjoint, the logged losses finite and falling. Returns
    ({run: launches}, fails)."""
    import torch

    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool
    from neuralrecon_w_tpu_torch.training import loop
    from neuralrecon_w_tpu_torch.training.checkpoint import latest_checkpoint

    fails, attaches, drawn = [], [], {}
    # 'auto' is the device pool on the card; the CPU rehearsal forces it
    pool_cfg = merged(overrides, {"TPU": {"DEVICE_POOL": "auto" if device == "cuda" else True,
                                          "SCAN_INNER": POOL_SCAN_INNER}})
    cfg_path = write_cfg(os.path.join(root, "train_pool.yaml"), root, pool_cfg)
    resume_path = write_cfg(os.path.join(root, "train_pool_resume.yaml"), root, merged(
        pool_cfg, {"NEUCONW": {"UPDATE_FREQ": 10 * TRAINER_STEPS}}))
    save_dir = os.path.join(root, "results")
    real_attach, real_take, real_gather = (loop.Trainer._attach_pool_surface,
                                           DeviceRayPool.take_scan_window, DeviceRayPool.gather)

    def attach(self):
        real_attach(self)
        if self.device_pool is None or self.fine_dgrid is None:
            return
        data = self.device_pool.data
        surf, hit = plain_band(self.fine_dgrid, self.train_level, data["rays"])
        attaches.append({"step": int(self.state.step), "rows": len(surf),
                         "hit": int(hit.sum()), "seconds": self.attach_seconds[-1],
                         "equal": torch.equal(data["surf_t"], surf)
                         and torch.equal(data["surf_hit"], hit)})

    def take(self, batch_size, n_inner):
        perm, start = real_take(self, batch_size, n_inner)
        drawn.setdefault((id(self), self._epoch_i), []).append(
            perm[start:start + batch_size * n_inner].clone())
        return perm, start

    def gather(self, idx):
        drawn.setdefault((id(self), self._epoch_i), []).append(idx.clone())
        return real_gather(self, idx)

    counters = launch_counters()
    runs = {}
    with mock.patch.object(loop.Trainer, "_attach_pool_surface", attach), \
            mock.patch.object(DeviceRayPool, "take_scan_window", take), \
            mock.patch.object(DeviceRayPool, "gather", gather):
        reset_counts(counters)
        t0 = time.perf_counter()
        tr = train_cli(cfg_path, save_dir, "device_pool", TRAIN_BATCH, TRAINER_STEPS, device,
                       extra)
        sync()
        wall = time.perf_counter() - t0
        runs["device_pool"] = read_counts()
        n_attach = len(attaches)
        reset_counts(counters)
        ck = latest_checkpoint(tr.ckpt_dir)
        tr2 = train_cli(resume_path, save_dir, "device_pool_resume", TRAIN_BATCH, POOL_RESUME,
                        device, extra + ["--ckpt_path", ck or ""])
        sync()
        runs["device_pool_resume"] = read_counts()

    if tr.state.step != TRAINER_STEPS or tr2.state.step != TRAINER_STEPS + POOL_RESUME:
        fails.append(f"device-pool train_cli ended at steps {tr.state.step} / {tr2.state.step}")
    if not isinstance(tr.device_pool, DeviceRayPool) or not isinstance(tr2.device_pool,
                                                                       DeviceRayPool):
        fails.append("train_cli with DEVICE_POOL 'auto' did not build the device pool")
    refresh_steps = [r["step"] for r in tr.refreshes]
    if refresh_steps != [TRAINER_UPDATE, 2 * TRAINER_UPDATE]:
        fails.append(f"device-pool refreshes at steps {refresh_steps}")
    # after every refresh that kept cells, and at the resume's start
    want = ([r["step"] for r in tr.refreshes if r.get("n_kept", 0) > 0], [TRAINER_STEPS])
    got_at = ([a["step"] for a in attaches[:n_attach]], [a["step"] for a in attaches[n_attach:]])
    if got_at != want:
        fails.append(f"band cache attached at steps {got_at}, not {want}")
    for a in attaches:
        print(f"band cache at step {a['step']}: {a['rows']} pool rows, {a['hit']} hit, "
              f"{a['seconds']:.3f} s (K10), equal to the plain DDA on every row {a['equal']}")
        if not a["equal"]:
            fails.append(f"band cache at step {a['step']} differs from the plain DDA")
    overlap = {e: sum(len(t) for t in ts) - len(torch.unique(torch.cat(ts)))
               for e, ts in drawn.items()}
    print("device-pool epochs drawn (run and resume): " + ", ".join(
        f"epoch {e[1]}: {sum(len(t) for t in ts)} rows in {len(ts)} windows / batches, "
        f"{overlap[e]} repeated" for e, ts in drawn.items()))
    if any(overlap.values()):
        fails.append(f"device-pool epoch windows overlap: {overlap}")
    recs = log_records(tr.logger.path)
    losses = [(r["step"], r["loss"]) for r in recs if "loss" in r]
    bad = [(r["step"], k) for r in recs for k, v in r.items() if not math.isfinite(v)]
    if bad or len(losses) < 2 or not losses[-1][1] < losses[0][1]:
        fails.append(f"device-pool train_cli losses {losses}, non-finite {bad[:5]}")
    val = [r for r in recs if "val/psnr" in r]
    if len(val) != 1:
        fails.append(f"device-pool train_cli: {len(val)} validations")
    rate = {r["step"]: r["rays_per_sec"] for r in recs if "rays_per_sec" in r}

    scan = tr.scan_runs()
    graph = graph_launches(tr.scan_runs(), runs["device_pool"])
    print("device-pool runs: " + "; ".join(
        f"{'graph' if r.captures else 'eager'} {r.n_inner}-step run: {r.captures} capture(s), "
        f"{r.replays} replays, per captured step " + ", ".join(
            f"{n} {v}" for n, v in r.per_step_launches.items()) for r in scan))
    got = runs["device_pool"]
    print(f"launches in train_cli on the device pool ({TRAINER_STEPS} steps): counted (eager "
          "steps, warm-ups, captures, refreshes, validation) " + ", ".join(
              f"{n} {v}" for n, v in got.items() if v) + "; added by the graphs ((replays - "
          "captures) x per step) " + ", ".join(f"{n} {v}" for n, v in graph.items() if v))
    print(f"launches in the device-pool resume ({POOL_RESUME} steps): " + ", ".join(
        f"{n} {v}" for n, v in runs["device_pool_resume"].items() if v))
    if device == "cuda":
        step_kernels = {"sdf_mlp", "sdf_mlp_bf16", "up_sample"}
        if len(scan) != 2 or not all(graph_ran(r) for r in scan):
            fails.append("the device-pool run did not replay a graph in both phases")
        for r in scan:
            if not {"sdf_mlp", "up_sample"} <= set(r.per_step_launches) \
                    or set(r.per_step_launches) - step_kernels:
                fails.append(f"a captured step's launches {r.per_step_launches}")
        runs["device_pool_graph"] = graph
    warm, steady = rate.get(2 * TRAINER_LOG), rate.get(TRAINER_STEPS)
    print(f"train_cli ({card}) rays/s, host pool against device pool + graph: warm-up "
          f"{host_rates.get(2 * TRAINER_LOG, float('nan')):.1f} / {warm:.1f} (steps "
          f"{TRAINER_LOG + 1}-{2 * TRAINER_LOG}), steady "
          f"{host_rates.get(TRAINER_STEPS, float('nan')):.1f} / {steady:.1f} (steps "
          f"{TRAINER_STEPS - TRAINER_LOG + 1}-{TRAINER_STEPS}); device-pool windows "
          + ", ".join(f"{s} {v:.1f}" for s, v in sorted(rate.items()))
          + f"; refreshes " + ", ".join(f"{r['seconds']:.3f} s" for r in tr.refreshes)
          + f"; band cache " + ", ".join(f"{s:.3f} s" for s in tr.attach_seconds)
          + f"; logged loss " + ", ".join(f"{s} {v:.4f}" for s, v in losses)
          + f"; wall {wall:.2f} s")
    return runs, fails


# ------------------------------- extraction -------------------------------


def unit_directions(n: int, seed: int = SEED):
    import numpy as np

    v = np.random.default_rng(seed + 11).standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def zero_set_points(model, fc, n: int, seed: int = SEED):
    """Up to n points on the field's zero set, unit coordinates. Along
    ZERO_DIRS * n seeded unit directions the SDF (K1 in f32) is scanned at
    ZERO_SCAN's radii; the first sign change brackets a crossing, bisected
    to BISECT_TOL. Returns (the first n crossings (n', 3) float64, the
    number of directions scanned without one, a line on the radial
    profile)."""
    import torch

    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head, pack_sdf_weights

    packed = pack_sdf_weights(model.neuconw.sdf_net, fc.sdf, "float32")
    dev = packed.w.device
    d = torch.from_numpy(unit_directions(int(math.ceil(ZERO_DIRS * n)), seed)).float().to(dev)

    def sdf(r):
        return fused_sdf_head(packed, (d * r[:, None]).contiguous())

    radii = torch.linspace(*ZERO_SCAN, device=dev)
    scan = torch.stack([sdf(torch.full((len(d),), float(r), device=dev)) for r in radii], 1)
    change = (scan[:, 1:] < 0) != (scan[:, :-1] < 0)
    crosses = change.any(1)
    first = change.float().argmax(1)
    profile = "; ".join(
        f"r {float(radii[k]):.2f}: " + "/".join(f"{float(q):.3g}" for q in torch.quantile(
            scan[:, k], torch.tensor([0.0, 0.5, 1.0], device=dev)))
        for k in (0, len(radii) // 4, len(radii) // 2, 3 * len(radii) // 4, len(radii) - 1))
    keep = torch.nonzero(crosses)[:n, 0]
    d, first = d[keep], first[keep]
    lo, hi = radii[first], radii[first + 1]
    lo_neg = sdf(lo) < 0
    while len(d) and float((hi - lo).max()) > BISECT_TOL:
        mid = (lo + hi) / 2
        same = (sdf(mid) < 0) == lo_neg
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    r = (lo + hi) / 2
    return (d * r[:, None]).double().cpu().numpy(), int((~crosses).sum()), profile


def write_workspace(root: str, sfm_points, radius: float = 2.0, sfm_voxel: float = SFM_VOXEL,
                    min_track: int = MIN_TRACK) -> dict:
    """A phototourism-style workspace: ``config.yaml`` (origin 0, the scene
    radius, identity sfm2gt, eval_bbx +-1.5, the SFM voxel size,
    min_track_length) and ``dense/sparse/points3D.bin``, every point with a
    track of min_track + 1 observations. Returns the scene config."""
    import numpy as np
    import yaml

    from neuralrecon_w_tpu_torch.datasets.colmap import Point3D, write_points3d_binary

    os.makedirs(os.path.join(root, "dense", "sparse"), exist_ok=True)
    scene = {"name": "zero_set", "origin": [0.0, 0.0, 0.0], "radius": float(radius),
             "sfm2gt": np.eye(4).tolist(), "eval_bbx": [[-1.5] * 3, [1.5] * 3],
             "voxel_size": float(sfm_voxel), "min_track_length": int(min_track)}
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(scene, f)
    track = np.arange(min_track + 1, dtype=np.int32)
    rgb = np.full(3, 128, np.uint8)
    points = {i + 1: Point3D(i + 1, p, rgb, 0.5, track, track) for i, p in enumerate(sfm_points)}
    write_points3d_binary(points, os.path.join(root, "dense", "sparse", "points3D.bin"))
    return scene


def write_cfg(path: str, root: str, extra: dict | None = None) -> str:
    """A cfg yaml over the operating point with DATASET.ROOT_DIR = root."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump({"_BASE_": CONFIG, "DATASET": {"ROOT_DIR": root}, **(extra or {})}, f)
    return path


def extraction_workspace(model, fc, root: str, n_points: int = EXTRACT_POINTS,
                         extra_cfg: dict | None = None, step: int = 0,
                         sfm_voxel: float = SFM_VOXEL):
    """SFM points on ``model``'s zero set, the workspace (its scene radius
    puts the farthest point EXTRACT_REACH from the origin), ``model`` saved
    with save_checkpoint, and the cfg: (cfg path, checkpoint path, scene
    config, fails)."""
    import numpy as np

    from neuralrecon_w_tpu_torch.training.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    pts, none, profile = zero_set_points(model, fc, n_points)
    sync()
    t1 = time.perf_counter()
    print(f"field's SDF along {int(math.ceil(ZERO_DIRS * n_points))} seeded directions "
          f"(min/median/max): {profile}")
    if len(pts) < n_points:
        return None, None, None, [f"only {len(pts)} of {n_points} directions cross the zero set"]
    r = np.linalg.norm(pts, axis=1)
    radius = EXTRACT_REACH / float(r.max())
    scene = write_workspace(root, pts * radius, radius, sfm_voxel)
    ckpt = save_checkpoint(os.path.join(root, "results", "checkpoints", "last.ckpt"), model, step)
    cfg_path = write_cfg(os.path.join(root, "extract.yaml"), root, extra_cfg)
    print(f"extraction workspace: {n_points} SFM points on the field's zero set at |x| "
          f"{r.min():.4f}-{r.max():.4f} unit ({none} directions without a crossing; scan and "
          f"bisection {t1 - t0:.2f} s), scene radius {radius:.4f}, written with the checkpoint "
          f"in {time.perf_counter() - t1:.2f} s")
    return cfg_path, ckpt, scene, []


def run_extraction(cfg_path: str, ckpt: str, level: int = EXTRACT_LEVEL, device: str = "cuda"):
    """``tools/extract_mesh_cli.main`` with the flags of scripts/sdf_extract.sh."""
    from neuralrecon_w_tpu_torch.tools import extract_mesh_cli

    return extract_mesh_cli.main(["--cfg_path", cfg_path, "--ckpt_path", ckpt, "--eval_level",
                                  str(level), "--mesh_size", "1024", "--chunk",
                                  str(EXTRACT_CHUNK), "--vertex_color", "--device", device])


def check_mesh(model, fc, res, ckpt: str, radius: float, level: int = EXTRACT_LEVEL):
    """The written ply: where the CLI names it, non-empty, finite, inside the
    eval bbx, unit normals, faces in range; its vertices on the field's zero
    set: median |sdf| (K1 in f32) within SDF_PROBE_CELLS level-``level``
    cells. ``radius`` is the workspace's scene radius. Returns (fails,
    median |sdf| in cells)."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head, pack_sdf_weights
    from neuralrecon_w_tpu_torch.parallel.sweep import sweep
    from neuralrecon_w_tpu_torch.utils.ply import read_ply

    if res is None:
        return ["extraction found an empty surface"], float("nan")
    want = os.path.join(os.path.dirname(os.path.dirname(ckpt)),
                        f"extracted_mesh_level_{level}_colored.ply")
    ply = read_ply(res.path)
    v, nrm, col, faces = ply["verts"], ply["normals"], ply["colors"], ply["faces"]
    fails = [] if res.path == want else [f"ply at {res.path}, expected {want}"]
    if len(v) == 0 or len(faces) == 0:
        return fails + ["empty mesh"], float("nan")
    if not (np.isfinite(v).all() and np.isfinite(nrm).all()):
        fails.append("mesh vertices or normals not finite")
    if np.abs(v).max() > 1.5:
        fails.append("mesh vertices outside the eval bbx")
    # vertex_normals leaves a normal short of unit where the area of the
    # vertex's faces sums below its 1e-12 floor: slivers, where the surface
    # passes within ~1e-7 of a cell corner
    norm = np.linalg.norm(nrm, axis=-1)
    short = int((np.abs(norm - 1.0) > 1e-3).sum())
    if norm.max() > 1.0 + 1e-3 or short > NORMAL_SHORT_FRAC * len(v):
        fails.append(f"mesh normals not unit: {short} short, longest {norm.max():.6f}")
    if col.shape != v.shape or faces.min() < 0 or faces.max() >= len(v):
        fails.append("mesh colours or faces malformed")
    packed = pack_sdf_weights(model.neuconw.sdf_net, fc.sdf, "float32")
    dev = packed.w.device
    sdf = sweep(lambda b: fused_sdf_head(packed, b), EXTRACT_CHUNK,
                (v / radius).astype(np.float32), device=dev)
    cell = res.grid.voxel_size / radius  # level-``level`` cell, unit coordinates
    med = float(np.median(np.abs(sdf))) / cell
    print(f"mesh: {len(v)} verts, {len(faces)} faces, colours in [{col.min()}, {col.max()}], "
          f"{short} normals short of unit; "
          f"|sdf| at the vertices (K1 f32): median {med:.3e} cells, max "
          f"{float(np.abs(sdf).max()) / cell:.3e} cells (cell {cell:.3e} unit)")
    if not med <= SDF_PROBE_CELLS:
        fails.append(f"mesh vertices off the zero set: median |sdf| {med:.3e} cells")
    return fails, med


def extraction_sweep_checks(model, fc, res, radius: float):
    """The path's device sweeps against the plain versions: the SDF at every
    grid point (K1 f32 against its plain f32 version), and the vertex
    colours the path wrote (K6) against the plain version's, in uint8."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops import field_forward as ff
    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head, pack_sdf_weights, sdf_mlp_plain
    from neuralrecon_w_tpu_torch.parallel.sweep import sweep

    fails = []
    packed = pack_sdf_weights(model.neuconw.sdf_net, fc.sdf, "float32")
    dev = packed.w.device
    pts = (res.grid.points_sfm / radius).astype(np.float32)
    got = sweep(lambda b: fused_sdf_head(packed, b), EXTRACT_CHUNK, pts, device=dev)
    want = sweep(lambda b: sdf_mlp_plain(packed, b), EXTRACT_CHUNK, pts, device=dev)
    err = np.abs(got - want)
    ok = bool((err <= K1_F32_ATOL + K1_F32_RTOL * np.abs(want)).all())
    print(f"SDF sweep at {len(pts)} grid points, K1 f32 vs plain: max|err| {err.max():.3e} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append("extraction SDF sweep, K1 vs plain")

    verts = (res.mesh.verts / radius).astype(np.float32)
    n = len(verts)
    a = model.embedding_a.weight[min(1123, model.embedding_a.weight.shape[0] - 1)]
    a = a.detach().float().cpu().numpy()
    pack = ff.pack_field(model, fc)
    plain = sweep(lambda p, d, e: ff.field_forward_plain(pack, p, d, e)[0], COLOR_CHUNK, verts,
                  np.broadcast_to(np.float32([0, 0, 1]), (n, 3)).copy(),
                  np.broadcast_to(a, (n, a.shape[0])).copy(), device=dev)
    plain = np.clip(plain * 255.0, 0, 255).astype(np.uint8)
    diff = np.abs(plain.astype(np.int16) - res.mesh.colors.astype(np.int16)).max(axis=1)
    frac = float((diff <= COLOR_LEVELS).mean())
    print(f"vertex colours at {n} vertices, K6 path vs plain {fc.act_dtype}: within "
          f"{COLOR_LEVELS} levels {frac:.6f}, max {int(diff.max())} -> "
          f"{'ok' if frac >= COLOR_FRAC else 'FAIL'}")
    if frac < COLOR_FRAC:
        fails.append("extraction vertex colours, K6 vs plain")
    return fails


def field_kernel_phase(model, fc):
    """K6 against its plain version on the live field at K6_CHECK_PTS
    points, f32 and bf16, and its times at the colour sweep's chunk in the
    served dtype; K1 in f32 at the SDF sweep's chunk against its plain
    version, and its times."""
    import torch

    from neuralrecon_w_tpu_torch.ops import field_forward as ff
    from neuralrecon_w_tpu_torch.ops import sdf_mlp

    live = live_field(model)
    dev = next(live.parameters()).device
    g = torch.Generator(device="cpu").manual_seed(SEED + 13)
    n = K6_CHECK_PTS
    pts = ((torch.rand(n, 3, generator=g) * 2 - 1) * 0.9).to(dev)
    dirs = torch.randn(n, 3, generator=g)
    dirs = (dirs / dirs.norm(dim=-1, keepdim=True)).to(dev)
    a = torch.randn(n, fc.n_a, generator=g).to(dev)
    res, fails = {}, []
    for act in ("float32", "bfloat16"):
        fca = fc._replace(act_dtype=act)
        pack = ff.pack_field(live, fca)
        ok, err = check_forward(f"K6 field_fwd {act} on {n} pts", ("rgb", "sdf", "grad"),
                                ff.field_forward_kernel(pack, pts, dirs, a),
                                ff.field_forward_plain(pack, pts, dirs, a), act)
        if not ok:
            fails.append(f"K6 {act}")
        if act == fc.act_dtype:
            res["field_fwd"] = {"max_abs_err": err}
            t_k = cuda_ms(lambda: ff.field_forward_kernel(pack, pts, dirs, a))
            t_p = cuda_ms(lambda: ff.field_forward_plain(pack, pts, dirs, a))
            t_k2 = cuda_ms(lambda: ff.field_forward_kernel(pack, pts, dirs, a))
            sp, cp = pack.sdf, pack.color
            sdf_dims = list(zip(sp.k, sp.n))
            flops = n * (gemm_flops(sdf_dims) + gemm_flops(sdf_dims[:-1])
                         + gemm_flops(zip(cp.k, cp.n)))
            b = bound(flops, nbytes(pts, dirs, a, sp.w, sp.b, cp.w, cp.b) + n * 28, act)
            res["field_fwd"].update(ms=min(t_k, t_k2), plain_ms=t_p, library_ms=None, **b)
            print(f"K6 field_fwd {act} at {n} pts: kernel {t_k:.3f} / {t_k2:.3f} ms, plain "
                  f"{t_p:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})")

    # K1 in f32 at the SDF sweep's chunk
    packed = sdf_mlp.pack_sdf_weights(live.neuconw.sdf_net, fc.sdf, "float32")
    x = ((torch.rand(EXTRACT_CHUNK, 3, generator=g) * 2 - 1) * 0.9).to(dev)
    err = float((sdf_mlp.fused_sdf_head(packed, x) - sdf_mlp.sdf_mlp_plain(packed, x)).abs().max())
    t_k = cuda_ms(lambda: sdf_mlp.fused_sdf_head(packed, x))
    t_p = cuda_ms(lambda: sdf_mlp.sdf_mlp_plain(packed, x))
    t_k2 = cuda_ms(lambda: sdf_mlp.fused_sdf_head(packed, x))
    b = bound(EXTRACT_CHUNK * gemm_flops(zip(packed.k, packed.n)),
              nbytes(x, packed.w, packed.b) + 4 * EXTRACT_CHUNK, "float32")
    res["sdf_mlp_f32"] = {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": t_p, **b}
    print(f"K1 sdf_mlp float32 at {EXTRACT_CHUNK} pts: kernel {t_k:.3f} / {t_k2:.3f} ms, plain "
          f"{t_p:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']}), max|err| {err:.3e}")
    return res, fails


def field_train_bound(pack, n: int) -> dict:
    """Least times of kernel 5's port at n points in the pack's dtype:
    'field_fwd' (K6: F, G and the colour head), 'field_bwd' (K7: F and G
    recomputed, the adjoint of G, the backward of F, the colour head's
    forward and dX) and 'dw_reduce' (K5's dW products for every layer).
    Inputs and outputs read or written once; K5 reads K7's factor rows."""
    act = str(pack.sdf.act).removeprefix("torch.")
    sdf, col = list(zip(pack.sdf.k, pack.sdf.n)), list(zip(pack.color.k, pack.color.n))
    f_all, f_hidden, f_col = gemm_flops(sdf), gemm_flops(sdf[:-1]), gemm_flops(col)
    w = nbytes(pack.sdf.w, pack.color.w) // 2 + nbytes(pack.sdf.b, pack.color.b)
    n_a = pack.color.k[1] - pack.color.n[0] - 3 * (1 + 2 * pack.color.multires_view)
    io = 12 + 12 + 4 * n_a  # pts, dirs, a
    rows = sum(2 * (k + m) for k, m in sdf) + sum(k + m for k, m in col)
    return {"field_fwd": bound(n * (f_all + f_hidden + f_col), w + n * (io + 28), act),
            "field_bwd": bound(n * (2 * f_all + 2 * f_hidden + 2 * f_col), w + n * (2 * io + 28),
                               act),
            "dw_reduce": bound(n * (2 * f_all + f_col), n * 4 * rows, act)}


def bg_bound(pk, n: int, n_a: int) -> dict:
    """Least times of kernel 6's port at n points in the pack's dtype:
    'nerf_bg_fwd' (K8: every layer), 'nerf_bg_bwd' (K9: the forward
    recomputed and dX) and 'dw_reduce' (K5: every layer's dW). K9's entry
    also carries `rows_floor_ms`: the f32 (cotangent, input) rows it leaves
    for K5 (feature and alpha share one input row) over the memory rate."""
    from neuralrecon_w_tpu_torch.ops.nerf_bg_fused import FEATURE

    act = str(pk.act).removeprefix("torch.")
    flops = gemm_flops(zip(pk.k, pk.n))
    w = nbytes(pk.w) // 2 + nbytes(pk.b)
    io = 16 + 12 + 4 * n_a  # pts4, dirs, a
    row_floats = sum(k + m for k, m in zip(pk.k, pk.n))
    rows_ms = n * 4 * (row_floats - pk.k[FEATURE]) / PEAK_BYTES * 1e3
    return {"nerf_bg_fwd": bound(n * flops, w + n * (io + 16), act),
            "nerf_bg_bwd": bound(n * 2 * flops, w + n * (2 * io + 16), act)
            | {"rows_floor_ms": rows_ms},
            "dw_reduce": bound(n * flops, n * 4 * row_floats, act)}


def field_train_kernel_phase(model, fc, n_time: int):
    """Kernel 5's port on the live field: K6 forward and K7 + K5 backward
    against their plain versions, the plain versions taking the colour ReLU
    masks K7 applied (``check_flips`` holds those to the reference's own
    signs): at FIELD_CHECK_PTS points in f32 (the backward against the
    plain version in float64) and bf16, and at n_time points (the steady
    phase's samples per step, several K7 chunks) in the served dtype. Then,
    at n_time, the times of K6, K7 + K5 and K5 alone beside the plain
    versions and the torch double backward ('vjp' mode, per-sample dirs and
    a)."""
    import torch

    from neuralrecon_w_tpu_torch.models.neuconw import field_forward
    from neuralrecon_w_tpu_torch.ops import field_forward as ff
    from neuralrecon_w_tpu_torch.ops import field_train as ft

    live = live_field(model)
    dev = next(live.parameters()).device
    with torch.no_grad():
        wb = [t.detach().contiguous() for t in ft.field_weights(live)]
    g = torch.Generator(device="cpu").manual_seed(SEED + 17)

    def inputs(n):
        dirs = torch.randn(n, 3, generator=g)
        x = [(torch.rand(n, 3, generator=g) * 2 - 1) * 0.9, dirs / dirs.norm(dim=-1, keepdim=True),
             torch.randn(n, fc.n_a, generator=g), torch.randn(n, 3, generator=g),
             torch.randn(n, generator=g), torch.randn(n, 3, generator=g)]
        return [t.to(dev) for t in x]

    col_names = ["xyz_final"] + [f"static{i}" for i in range(
        live.neuconw.color_net.static_encoding.n_layers)] + [
        f"lin{i}" for i in range(live.neuconw.color_net.n_layers)]
    n_sdf = live.neuconw.sdf_net.n_layers
    names = ([f"W{l}" for l in range(n_sdf)] + [f"b{l}" for l in range(n_sdf)]
             + [f"{c}.W" for c in col_names] + [f"{c}.b" for c in col_names]
             + ["dx", "d_dirs", "d_a"])
    flat = lambda r: [*r[0], *r[1], *r[2], *r[3], *r[4:]]  # noqa: E731
    res, fails = {}, []

    def check(act, x, f64: bool):
        """K6 and K7 + K5 at x's size in act against the plain versions;
        returns the failures and the kernels' largest |error| to them."""
        spec = ft.field_spec(live, fc._replace(act_dtype=act))
        pack = ft.pack_field_tensors(spec, wb)
        n, out = x[0].shape[0], []
        ok_f, err_f = check_forward(f"K6 as kernel 5's forward {act} on {n} pts",
                                    ("rgb", "sdf", "grad"), ff.field_forward_kernel(pack, *x[:3]),
                                    ff.field_forward_plain(pack, *x[:3]), act)
        if not ok_f:
            out.append(f"K6 as kernel 5's forward {act} at {n} pts")
        masks = []
        got = flat(ft.field_train_bwd(pack, *x, masks=masks))
        plain = flat(ft.field_train_bwd_plain(spec, wb, *x, masks=masks))
        if f64:
            wb64, x64 = [w.double() for w in wb], [t.double() for t in x]
            truth = flat(ft.field_train_bwd_plain(spec, wb64, *x64, masks=masks))
            zs = ft.color_preacts(spec, wb64, *x64[:3])
            bad = check_outputs(f"K7+K5 field_bwd {act} on {n} pts to the plain f64, max(2 x "
                                "the plain f32's, 1e-5)", names, got, truth, 1e-5, plain)
            del truth
        else:
            zs = ft.color_preacts(spec, wb, *x[:3])
            bad = check_outputs(f"K7+K5 field_bwd {act} on {n} pts to the plain {act}", names,
                                got, plain, VJP_BF16_REL)
        bad += check_flips(f"K7 {act} on {n} pts", masks, zs, FLIP_Z[act])
        if bad:
            out.append(f"K7+K5 {act} at {n} pts")
        return out, err_f, max(float((k - p).abs().max()) for k, p in zip(got, plain))

    for act in ("float32", "bfloat16"):
        bad, err_f, err_b = check(act, inputs(FIELD_CHECK_PTS), act == "float32")
        fails += bad
        if act == fc.act_dtype:
            res["field_fwd"], res["field_bwd"] = {"max_abs_err": err_f}, {"max_abs_err": err_b}
    x = inputs(n_time)
    bad, _, _ = check(fc.act_dtype, x, False)
    fails += bad

    # times at the steady phase's shape, in the served dtype
    spec = ft.field_spec(live, fc)
    pack = ft.pack_field_tensors(spec, wb)
    dmodel = copy.deepcopy(live).requires_grad_(True)
    fc_vjp = fc._replace(grad_mode="vjp")

    def double_backward():
        xx = x[0].clone().requires_grad_(True)
        rgb, _, sdf, gr = field_forward(dmodel, fc_vjp, xx, x[1], x[2], create_graph=True)
        (torch.sum(rgb * x[3]) + torch.sum(sdf * x[4]) + torch.sum(gr * x[5])).backward()

    work, rows = ft.workspace(n_time, pack, dev)
    work.normal_()
    grads = [[torch.zeros(n, k, device=dev) for n, k in zip(p.n, p.k)] for p in (pack.sdf, pack.color)]
    biases = [[torch.zeros(n, device=dev) for n in p.n] for p in (pack.sdf, pack.color)]
    chunks = [min(ft.CHUNK, n_time - c0) for c0 in range(0, n_time, ft.CHUNK)]

    def reduce_only():
        for m in chunks:
            ft.reduce_chunk(pack, work, rows, m, grads[0], biases[0], grads[1], biases[1])

    t = time_in_turns(lambda: ff.field_forward_kernel(pack, *x[:3]),
                      lambda: ft.field_train_bwd(pack, *x),
                      lambda: ff.field_forward_plain(pack, *x[:3]),
                      lambda: ft.field_train_bwd_plain(spec, wb, *x), double_backward, reduce_only,
                      library_reduce(reduce_only))
    del work
    b = field_train_bound(pack, n_time)
    print(f"kernel 5 {fc.act_dtype} at {n_time} pts, ms in turns: forward K6 {t['fwd']:.2f}, "
          f"plain {t['fwd_plain']:.2f}, bound {b['field_fwd']['bound_ms']:.3f}; backward K7 + K5 "
          f"{t['bwd']:.2f}, plain {t['bwd_plain']:.2f}, of which K5 alone {t['reduce']:.2f} (one "
          f"addmm per factor pair {t['library']:.2f}), K7 "
          f"bound {b['field_bwd']['bound_ms']:.3f}; forward + backward {t['fwd'] + t['bwd']:.2f}, "
          f"plain {t['fwd_plain'] + t['bwd_plain']:.2f}, torch double backward ('vjp') "
          f"{t['other']:.2f}")
    timed_entries(res, t, b, "field_fwd", "field_bwd", "double_backward_ms")
    return res, fails


def bg_kernel_phase(model, fc, n_rays: int, k: int):
    """Kernel 6's port: K8 and K9 + K5 against their plain versions at the
    training path's n_rays x k background points (per-ray dirs and a
    repeated per sample), f32 (K8 atol / rtol K3_F32_TOL, K9 + K5 rel-L2
    BG_GRAD_REL) and bf16 (rel-L2 VJP_BF16_REL); then, in the served dtype,
    the times of K8, K9 + K5 and K5 alone beside the plain versions and
    the 'xla' path's autograd forward and backward (per-ray, as training
    runs it)."""
    import torch

    from neuralrecon_w_tpu_torch.models.neuconw import field_background
    from neuralrecon_w_tpu_torch.ops import nerf_bg_fused as bgf

    dev = next(model.parameters()).device
    layers = bgf.bg_layers(model.nerf, fc.encode_a_bg)
    ws = [m.weight.detach() for m in layers]
    bs = [m.bias.detach() for m in layers]
    g = torch.Generator(device="cpu").manual_seed(SEED + 19)
    n = n_rays * k
    xyz = torch.randn(n, 3, generator=g)
    pts4 = torch.cat([xyz / xyz.norm(dim=-1, keepdim=True),
                      torch.rand(n, 1, generator=g) * 0.95 + 0.05], dim=-1).to(dev)
    dirs_ray = torch.randn(n_rays, 3, generator=g)
    dirs_ray = (dirs_ray / dirs_ray.norm(dim=-1, keepdim=True)).to(dev)
    a_ray = torch.randn(n_rays, fc.n_a, generator=g).to(dev)
    c_den, c_rgb = torch.randn(n, 1, generator=g).to(dev), torch.randn(n, 3, generator=g).to(dev)
    dirs = dirs_ray.repeat_interleave(k, dim=0)
    a = a_ray.repeat_interleave(k, dim=0) if fc.encode_a_bg else None
    names = [f"{nm}.W" for nm in bgf.bg_layer_names(fc.encode_a_bg)] + [
        f"{nm}.b" for nm in bgf.bg_layer_names(fc.encode_a_bg)] + ["d_pts4", "d_dirs", "d_a"]
    flat = lambda r: [*r[0], *r[1], *[t for t in r[2:] if t is not None]]  # noqa: E731
    res, fails = {}, []
    for act in ("float32", "bfloat16"):
        pk = bgf.pack_bg_weights(ws, bs, act)
        ok_f, err_f = check_forward(f"K8 nerf_bg_fwd {act} on {n} pts", ("density", "rgb"),
                                    bgf.nerf_bg_fwd(pk, pts4, dirs, a),
                                    bgf.bg_fwd_plain(ws, bs, pts4, dirs, a, act), act)
        if not ok_f:
            fails.append(f"K8 {act}")
        got_b = flat(bgf.nerf_bg_bwd(pk, pts4, dirs, a, c_den, c_rgb))
        want_b = flat(bgf.bg_bwd_plain(ws, bs, pts4, dirs, a, c_den, c_rgb, act))
        if check_outputs(f"K9+K5 nerf_bg_bwd {act} on {n} pts to the plain {act}", names, got_b,
                         want_b, BG_GRAD_REL if act == "float32" else VJP_BF16_REL):
            fails.append(f"K9+K5 {act}")
        if act == fc.act_dtype:
            res["nerf_bg_fwd"] = {"max_abs_err": err_f}
            res["nerf_bg_bwd"] = {"max_abs_err": max(float((kk - w).abs().max())
                                                     for kk, w in zip(got_b, want_b))}

    # times in the served dtype
    pk = bgf.pack_bg_weights(ws, bs, fc.act_dtype)
    dmodel = copy.deepcopy(model).requires_grad_(True)
    fc_xla = fc._replace(bg_mode="xla")

    def xla():
        den, rgb = field_background(dmodel, fc_xla, pts4, dirs_ray, a_ray, k)
        (torch.sum(den * c_den) + torch.sum(rgb * c_rgb)).backward()

    work, rows = bgf.workspace(n, bgf.bwd_slots(pk.n_head), dev)
    work.normal_()
    dWs = [torch.zeros(nn, kk, device=dev) for nn, kk in zip(pk.n, pk.k)]
    dbs = [torch.zeros(nn, device=dev) for nn in pk.n]
    chunks = [min(bgf.CHUNK, n - c0) for c0 in range(0, n, bgf.CHUNK)]

    def reduce_only():
        for m in chunks:
            bgf.reduce_chunk(pk, work, rows, m, dWs, dbs)

    t = time_in_turns(lambda: bgf.nerf_bg_fwd(pk, pts4, dirs, a),
                      lambda: bgf.nerf_bg_bwd(pk, pts4, dirs, a, c_den, c_rgb),
                      lambda: bgf.bg_fwd_plain(ws, bs, pts4, dirs, a, fc.act_dtype),
                      lambda: bgf.bg_bwd_plain(ws, bs, pts4, dirs, a, c_den, c_rgb, fc.act_dtype),
                      xla, reduce_only, library_reduce(reduce_only), reps=5)
    del work
    b = bg_bound(pk, n, fc.n_a if fc.encode_a_bg else 0)
    print(f"kernel 6 {fc.act_dtype} at {n_rays} x {k} = {n} pts, ms in turns: K8 {t['fwd']:.3f}, "
          f"plain {t['fwd_plain']:.3f}, bound {b['nerf_bg_fwd']['bound_ms']:.4f}; K9 + K5 "
          f"{t['bwd']:.3f}, plain {t['bwd_plain']:.3f}, of which K5 alone {t['reduce']:.3f} (one "
          f"addmm per factor pair {t['library']:.3f}), K9 "
          f"bound {b['nerf_bg_bwd']['bound_ms']:.4f} (its rows for K5 "
          f"{b['nerf_bg_bwd']['rows_floor_ms']:.4f}); forward + backward "
          f"{t['fwd'] + t['bwd']:.3f}, the 'xla' path's autograd forward + backward "
          f"{t['other']:.3f}")
    timed_entries(res, t, b, "nerf_bg_fwd", "nerf_bg_bwd", "xla_fwd_bwd_ms")
    return res, fails


def extraction_phase(model, fc, root: str, n_points: int = EXTRACT_POINTS,
                     level: int = EXTRACT_LEVEL, extra_cfg: dict | None = None, step: int = 0,
                     sfm_voxel: float = SFM_VOXEL):
    """The workspace, then the CLI with the launch counts set to 0 just
    before and read just after, then the checks. Returns (launches, fails)."""
    from neuralrecon_w_tpu_torch.ops.field_forward import fused_field_forward
    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head

    cfg_path, ckpt, scene, fails = extraction_workspace(model, fc, root, n_points, extra_cfg,
                                                        step, sfm_voxel)
    if fails:
        return {"sdf_mlp": 0, "field_fwd": 0}, fails
    dev = next(model.parameters()).device.type
    fused_sdf_head.launches = fused_field_forward.launches = 0
    sync()
    t0 = time.perf_counter()
    res = run_extraction(cfg_path, ckpt, level, dev)
    sync()
    wall = time.perf_counter() - t0
    launches = {"sdf_mlp": fused_sdf_head.launches, "field_fwd": fused_field_forward.launches}
    print(f"launches in extraction: K1 sdf_mlp {launches['sdf_mlp']}, K6 field_fwd "
          f"{launches['field_fwd']}; CLI wall {wall:.2f} s")
    if dev == "cuda":
        fails += [f"{k} not launched in extraction" for k, v in launches.items() if v <= 0]
    radius = float(scene["radius"])
    mesh_fails, _ = check_mesh(model, fc, res, ckpt, radius, level)
    fails += mesh_fails
    if res is not None:
        sec = res.seconds
        n_grid, n_verts = len(res.grid.points_sfm), len(res.mesh.verts)
        print(f"extraction stages, s: " + ", ".join(f"{k} {v:.3f}" for k, v in sec.items())
              + f"; SDF sweep {n_grid / sec['sdf sweep']:.4g} points/s over {n_grid} grid "
              f"points, colour sweep {n_verts / sec['colour sweep']:.4g} points/s over "
              f"{n_verts} vertices")
        if not mesh_fails:
            fails += extraction_sweep_checks(model, fc, res, radius)
    return launches, fails


# ---------------------------- the training CLI ----------------------------


def reset_counts(counters: dict) -> None:
    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head

    for c in counters.values():
        c.launches = 0
    fused_sdf_head.launches_f32 = 0


def read_counts() -> dict:
    """Launches per kernel since reset_counts, K1 split into its bf16 and
    float32 launches (``sdf_mlp_bf16`` / ``sdf_mlp_f32``)."""
    from neuralrecon_w_tpu_torch.ops import read_launches

    return read_launches()


def cli_workspace(root: str, device: str, n_images: int, wh, n_points: int, cam_dist: float,
                  n_splits: int, sfm_voxel: float | None = None) -> dict:
    """The port's synthetic workspace (``testing.make_synthetic_scene``, seed
    SEED, the last image held out), its config.yaml's voxel_size set to
    ``sfm_voxel`` where given, an analytic gt.ply of the sphere, and the ray
    cache from ``prepare_data.prepare_data_cache`` (npz where h5py is not
    installed; the voxel near / far on ``device``). Returns the scene info
    and what was timed."""
    import importlib.util

    import numpy as np
    import yaml

    from neuralrecon_w_tpu_torch.testing import make_synthetic_scene
    from neuralrecon_w_tpu_torch.tools.prepare_data import prepare_data_cache
    from neuralrecon_w_tpu_torch.utils.ply import write_ply

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    info = make_synthetic_scene(root, n_images=n_images, n_test=1, img_wh=wh,
                                n_points=n_points, cam_dist=cam_dist, seed=SEED)
    if sfm_voxel is not None:
        path = os.path.join(root, "config.yaml")
        with open(path) as f:
            sc = yaml.safe_load(f)
        sc["voxel_size"] = float(sfm_voxel)
        with open(path, "w") as f:
            yaml.safe_dump(sc, f)
        info["scene_config"] = sc
    rs = np.random.RandomState(SEED)
    v = rs.randn(4000, 3)
    write_ply(os.path.join(root, "gt.ply"), v / np.linalg.norm(v, axis=-1, keepdims=True)
              * info["sphere_radius"])
    t1 = time.perf_counter()
    cache_type = "h5" if importlib.util.find_spec("h5py") else "npz"
    prepare_data_cache.main(["--root_dir", root, "--split_to_chunks", str(n_splits),
                             "--cache_type", cache_type, "--device", device])
    sync()
    info.update(scene_seconds=t1 - t0, cache_seconds=time.perf_counter() - t1,
                cache_type=cache_type)
    return info


def log_records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_cli(cfg_path: str, save_dir: str, name: str, batch: int, steps: int, device: str,
              extra=()):
    from neuralrecon_w_tpu_torch.tools import train_cli as cli

    return cli.main(["--cfg_path", cfg_path, "--batch_size", str(batch), "--num_epochs", "1000",
                     "--max_steps", str(steps), "--exp_name", name, "--save_dir", save_dir,
                     "--device", device, *extra])


def merged(base: dict, extra: dict | None) -> dict:
    """``base`` with ``extra`` merged in, section by section."""
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def refresh_check(ckpt: str, grid, sfm_grid, level: int, sc: dict, sfm_unit, fc,
                  threshold: float, device: str) -> dict:
    """One surface refresh held to the plain version: the field saved in
    ``ckpt`` (the state the refresh swept), REFRESH_CHECK_PTS of its
    level-``level`` candidates drawn with a seed (children of the SFM grid's
    cells), their SDF by ``sdf_mlp_plain`` in float32, kept where <=
    ``threshold``, against membership of ``grid`` (what the refresh built).
    Returns the share kept, the cells kept or dropped against the plain
    SDF (all, and those farther than REFRESH_AMBIGUOUS from the threshold),
    and the median SDF at the SFM points ``sfm_unit``: the zero set's level
    shift, negative where the field reads the true surface as inside."""
    import numpy as np

    from neuralrecon_w_tpu_torch.ops.sdf_mlp import pack_sdf_weights, sdf_mlp_plain
    from neuralrecon_w_tpu_torch.ops.voxel_grid import _linear
    from neuralrecon_w_tpu_torch.parallel.sweep import sweep
    from neuralrecon_w_tpu_torch.training.checkpoint import load_field

    packed = pack_sdf_weights(load_field(ckpt, fc, device).neuconw.sdf_net, fc.sdf, "float32")

    def plain(pts):
        return sweep(lambda b: sdf_mlp_plain(packed, b), 65536, pts, device=device)

    rng = np.random.default_rng(SEED)
    n, t, res = REFRESH_CHECK_PTS, 1 << (level - sfm_grid.level), 1 << level
    cells = (sfm_grid.coords[rng.integers(0, len(sfm_grid.coords), n)].astype(np.int64) * t
             + rng.integers(0, t, (n, 3)))
    centers = ((cells + 0.5) / res * 2.0 - 1.0) * sfm_grid.scale + sfm_grid.origin
    sdf = plain(((centers - np.asarray(sc["origin"])) / float(sc["radius"])).astype(np.float32))
    kept = np.isin(_linear(cells, level), _linear(grid.coords, level))
    wrong = kept != (sdf <= threshold)
    return {"kept_frac": float(kept.mean()), "wrong": int(wrong.sum()),
            "wrong_clear": int((wrong & (np.abs(sdf - threshold) >= REFRESH_AMBIGUOUS)).sum()),
            "sfm_sdf_median": float(np.median(plain(sfm_unit)))}


def trainer_phase(root: str, device: str = "cuda", extra_cfg: dict | None = None,
                  sfm_voxel: float = SFM_VOXEL, train_voxel: float = TRAINER_VOXEL,
                  fine_level: int = FINE_LEVEL, card: str = "the CPU"):
    """``tools/train_cli.main`` at the full width of CONFIG on a synthetic
    workspace of TRAINER_CAMS + 1 views at IMG_WH (SFM grid level 8), batch
    TRAIN_BATCH, TRAINER_STEPS steps in the default 'vjp' mode (refreshes at
    steps TRAINER_UPDATE and 2 x TRAINER_UPDATE, a save at each, one validation),
    then TRAINER_RESUME steps resumed from its checkpoint in 'pallas_field'
    with FUSED_BG on the host pool (eager steps, a refresh first; its
    checkpoint through ``render_cli_dispatch_check``), and GRAPH_RESUME steps
    each in 'pallas_field' with FUSED_BG and in 'fwd' on the device pool (on
    the card one captured window, ``resume_graph_fails``). The launch counts
    are set to 0 just before each CLI call and read just after. Every
    refresh is held to the plain version (``refresh_check``), the logged
    loss must fall. Returns ({run: launches}, fails)."""
    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg
    from neuralrecon_w_tpu_torch.datasets.colmap import read_points3d_binary
    from neuralrecon_w_tpu_torch.tools.convert import init_field
    from neuralrecon_w_tpu_torch.training.checkpoint import latest_checkpoint, restore_checkpoint

    fails = []
    info = cli_workspace(root, device, TRAINER_CAMS + 1, IMG_WH, TRAINER_POINTS,
                         TRAINER_CAM_DIST, 64, sfm_voxel)
    overrides = merged({
        "NEUCONW": {"UPDATE_FREQ": TRAINER_UPDATE, "TRAIN_VOXEL_SIZE": train_voxel},
        "TRAINER": {"VAL_FREQ": float(TRAINER_VAL), "SAVE_FREQ": TRAINER_UPDATE}}, extra_cfg)
    # the host pool here; device_pool_trainer_phase runs DEVICE_POOL 'auto'
    host = merged(overrides, {"TPU": {"DEVICE_POOL": False}})
    cfg_path = write_cfg(os.path.join(root, "train.yaml"), root, host)
    counters = launch_counters()
    save_dir = os.path.join(root, "results")
    extra = ["--log_every", str(TRAINER_LOG), "--test_batch_size", str(TRAIN_BATCH)]
    reset_counts(counters)
    t0 = time.perf_counter()
    tr = train_cli(cfg_path, save_dir, "trainer", TRAIN_BATCH, TRAINER_STEPS, device, extra)
    sync()
    wall = time.perf_counter() - t0
    launches = {"trainer": read_counts()}
    n_rays = len(tr.load_rays())
    print(f"trainer workspace: {TRAINER_CAMS} + 1 views of {IMG_WH[0]}x{IMG_WH[1]}, "
          f"{info['n_points']} SFM points, SFM grid level {tr.sfm_grid.level} "
          f"({len(tr.sfm_grid.coords)} cells), training level {tr.train_level}; {n_rays} cached "
          f"rays ({info['cache_type']}); scene {info['scene_seconds']:.2f} s, cache "
          f"{info['cache_seconds']:.2f} s (the voxel near / far included)")

    if tr.state.step != TRAINER_STEPS:
        fails.append(f"train_cli ended at step {tr.state.step}, not {TRAINER_STEPS}")
    steps = [r["step"] for r in tr.refreshes]
    if steps != [TRAINER_UPDATE, 2 * TRAINER_UPDATE]:
        fails.append(f"refreshes at steps {steps}")
    for r in tr.refreshes:
        print(f"trainer refresh at step {r['step']}: {r['seconds']:.3f} s (the K1 f32 sweep "
              f"{r.get('sweep_seconds', float('nan')):.3f} s), "
              f"{r.get('n_candidates')} candidates, {r.get('n_kept')} kept "
              f"({r.get('kept_frac', 0):.3f})")
        if not 0 < r.get("n_kept", 0) or r.get("kept_frac", 1.0) >= DEGENERATE_KEEP:
            fails.append(f"refresh at step {r['step']} kept {r.get('n_kept')} of "
                         f"{r.get('n_candidates')}")
    if tr.fine_grid_host is None or tr.fine_grid_host.level != fine_level:
        fails.append(f"no level-{fine_level} fine grid after the refreshes")
    recs = log_records(tr.logger.path)
    bad = [(r["step"], k) for r in recs for k, v in r.items() if not math.isfinite(v)]
    if bad:
        fails.append(f"non-finite logged scalars {bad[:5]}")
    losses = [(r["step"], r["loss"]) for r in recs if "loss" in r]
    print("train_cli logged loss: " + ", ".join(f"{s} {v:.4f}" for s, v in losses))
    if len(losses) < 2 or not losses[-1][1] < losses[0][1]:
        fails.append(f"train_cli's logged loss did not fall: {losses}")
    rate = {r["step"]: r["rays_per_sec"] for r in recs if "rays_per_sec" in r}
    val = [r for r in recs if "val/psnr" in r]
    if not rate or len(val) != 1 or "val/fscore" not in val[0]:
        fails.append(f"metrics.jsonl: rays_per_sec at {sorted(rate)}, {len(val)} validations")
    fc = field_config_from_cfg(load_cfg(cfg_path))
    init = init_field(fc, torch.Generator().manual_seed(int(tr.cfg.TRAINER.SEED)), device)
    before = init.state_dict()
    moved = [k for k, v in tr.state.model.state_dict().items() if not torch.equal(v, before[k])]
    if len(moved) < len(before) // 2:
        fails.append(f"train_cli moved only {len(moved)} of {len(before)} parameter tensors")
    ck = latest_checkpoint(tr.ckpt_dir)
    saved = restore_checkpoint(ck) if ck else {}
    if (not ck or not ck.endswith(f"step_{TRAINER_STEPS}.ckpt") or "optimizer" not in saved
            or "fine_grid" not in saved
            or not all(os.path.exists(os.path.join(tr.ckpt_dir, f"step_{r['step']}.ckpt"))
                       for r in tr.refreshes)):
        fails.append(f"checkpoints: {sorted(os.listdir(tr.ckpt_dir))}")
    # the trained checkpoint through render_cli, the served frame as a graph
    # against the host chunk loop
    if ck:
        rendered, rfails = render_cli_dispatch_check(cfg_path, ck, root, device)
        launches.update(rendered)
        fails += rfails
    got = launches["trainer"]
    # K10: the validation's SFM near / far; K11: every step's fine-grid
    # query once a fine grid exists, and the validation's
    want = ("sdf_mlp_bf16", "sdf_mlp_f32", "up_sample", "dda", "sampled_hit")
    print(f"launches in train_cli ({TRAINER_STEPS} steps, 'vjp'): " + ", ".join(
        f"{n} {v}" for n, v in got.items() if v))
    if device == "cuda":
        fails += [f"{n} not launched by train_cli" for n in want if got[n] <= 0]
        fails += [f"{n} launched by train_cli in 'vjp'" for n, v in got.items()
                  if v and n not in want + ("sdf_mlp",)]
    warm = rate.get(2 * TRAINER_LOG)
    steady = rate.get(TRAINER_STEPS)
    print(f"train_cli ({card}): warm-up {warm:.1f} rays/s (steps {TRAINER_LOG + 1}-"
          f"{2 * TRAINER_LOG}), steady {steady:.1f} rays/s (steps {TRAINER_STEPS - TRAINER_LOG + 1}"
          f"-{TRAINER_STEPS}); windows " + ", ".join(f"{s} {v:.1f}" for s, v in sorted(rate.items()))
          + f"; validation {sum(tr.val_seconds):.3f} s (psnr {val[0]['val/psnr']:.3f}, F@0.1 "
          f"{val[0].get('val/fscore', float('nan')):.4f}); wall {wall:.2f} s")

    # resume in the fused mode on the host pool: the CLI path through K6,
    # K7, K5, K8, K9 as eager steps fed by host batches, a refresh first
    cfg2 = write_cfg(os.path.join(root, "train_fused.yaml"), root, merged(
        host, {"TPU": {"SDF_GRAD_MODE": "pallas_field", "FUSED_BG": True}}))
    reset_counts(counters)
    t0 = time.perf_counter()
    tr2 = train_cli(cfg2, save_dir, "trainer_resume", TRAIN_BATCH, TRAINER_RESUME, device,
                    extra + ["--ckpt_path", ck or ""])
    sync()
    got = launches["resume"] = read_counts()
    print(f"launches in train_cli resumed {TRAINER_RESUME} steps in 'pallas_field' + FUSED_BG "
          f"(a refresh first): " + ", ".join(f"{n} {v}" for n, v in got.items() if v)
          + f"; wall {time.perf_counter() - t0:.2f} s; its refresh " + ", ".join(
              f"{r['seconds']:.3f} s, kept {r.get('n_kept')} ({r.get('kept_frac', 0):.3f})"
              for r in tr2.refreshes))
    if tr2.state.step != TRAINER_STEPS + TRAINER_RESUME:
        fails.append(f"resumed train_cli ended at step {tr2.state.step}")
    if [r["step"] for r in tr2.refreshes] != [TRAINER_STEPS] or tr2.refreshes[0]["n_kept"] <= 0:
        fails.append(f"the resume's refreshes: {tr2.refreshes}")

    # every refresh against the plain SDF of the state it swept: the
    # grid it built is in the next save, the resume's in the resumed trainer
    sc = tr.meta.scene_config
    sfm = tr.sfm_grid
    pts = read_points3d_binary(os.path.join(root, "dense", "sparse", "points3D.bin"))
    sfm_unit = ((np.stack([p.xyz for p in pts.values()]) - np.asarray(sc["origin"]))
                / float(sc["radius"])).astype(np.float32)
    built = [restore_checkpoint(os.path.join(tr.ckpt_dir, f"step_{r['step'] + TRAINER_UPDATE}"
                                             ".ckpt"))["fine_grid"] for r in tr.refreshes]
    for r, grid in zip(tr.refreshes + tr2.refreshes, built + [tr2.fine_grid_host]):
        if grid is None:  # nothing kept: failed above
            continue
        c = refresh_check(os.path.join(tr.ckpt_dir, f"step_{r['step']}.ckpt"), grid, sfm,
                          tr.train_level, sc, sfm_unit, fc, tr.sdf_threshold, device)
        print(f"refresh at step {r['step']} against the plain float32 SDF on "
              f"{REFRESH_CHECK_PTS} seeded candidates: kept share {c['kept_frac']:.4f} (the "
              f"refresh's {r['kept_frac']:.4f}), {c['wrong']} kept or dropped against it, "
              f"{c['wrong_clear']} of them farther than {REFRESH_AMBIGUOUS} from the threshold; "
              f"median SDF at the {len(sfm_unit)} SFM points {c['sfm_sdf_median']:.5f}")
        if c["wrong_clear"]:
            fails.append(f"refresh at step {r['step']}: {c['wrong_clear']} cells against the "
                         f"plain SDF")
    if device == "cuda":
        want = MODE_KERNELS["pallas_field"] + ("sampled_hit",)
        fails += [f"{n} not launched by the resumed train_cli" for n in want if got[n] <= 0]
        fails += [f"{n} launched by the resumed train_cli, not its mode's" for n in counters
                  if got[n] and n not in want]
    # the resumed checkpoint through render_cli in its kernel mode (K6, K8
    # in the captured chunk)
    ck2 = latest_checkpoint(tr2.ckpt_dir)
    if ck2:
        rendered, rfails = render_cli_dispatch_check(cfg2, ck2, root, device,
                                                     tag="pallas_field_")
        launches.update(rendered)
        fails += rfails
    else:
        fails.append("the pallas_field resume saved no checkpoint")
    # the same resume on the device pool (DEVICE_POOL 'auto'), and one in
    # 'fwd': the saved grid's band cache by K10, then GRAPH_RESUME steps as
    # one window, on the card a captured graph replayed; no refresh
    # (UPDATE_FREQ 0): the host-pool resume's took ~20 s of the run
    for run, mode, bg in (("resume_pool", "pallas_field", True), ("resume_fwd", "fwd", False)):
        cfg3 = write_cfg(os.path.join(root, f"train_{run}.yaml"), root, merged(
            overrides, {"TPU": {"SDF_GRAD_MODE": mode, "FUSED_BG": bg,
                                "SCAN_INNER": GRAPH_RESUME}, "NEUCONW": {"UPDATE_FREQ": 0}}))
        reset_counts(counters)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr3 = train_cli(cfg3, save_dir, f"trainer_{run}", TRAIN_BATCH, GRAPH_RESUME, device,
                        extra + ["--ckpt_path", ck or ""])
        sync()
        got = launches[run] = read_counts()
        launches[f"{run}_graph"] = graph_launches(tr3.scan_runs(), got)
        print(f"launches in train_cli resumed {GRAPH_RESUME} steps in '{mode}'"
              + (" + FUSED_BG" if bg else "")
              + f" on the {'device' if tr3.use_device_pool else 'host'} pool: "
              + ", ".join(f"{n} {v}" for n, v in got.items() if v) + "; added by the graph "
              "((replays - captures) x a captured step) "
              + (", ".join(f"{n} {v}" for n, v in launches[f"{run}_graph"].items() if v)
                 or "none")
              + f"; wall {time.perf_counter() - t0:.2f} s"
              + (f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
                 if device == "cuda" else ""))
        if tr3.state.step != TRAINER_STEPS + GRAPH_RESUME or tr3.fine_grid_host is None:
            fails.append(f"the '{mode}' {run} ended at step {tr3.state.step}, fine grid "
                         f"{tr3.fine_grid_host is not None}")
        if device == "cuda":
            # K1 bf16 (the sampler), K2, K10 (the band cache), the mode's kernels
            want = MODE_KERNELS[mode] + ("sdf_mlp_bf16", "dda")
            fails += [f"{n} not launched by the '{mode}' {run}" for n in want if got[n] <= 0]
            fails += [f"{n} launched by the '{mode}' {run}, not its mode's"
                      for n, v in got.items() if v and n not in want + ("sampled_hit",)]
            fails += resume_graph_fails(tr3, mode)
    pool_runs, pool_fails = device_pool_trainer_phase(root, overrides, device, extra, rate, card)
    launches.update(pool_runs)
    return launches, fails + pool_fails


# the data-parallel phase (parallel/mesh.py) in trainer_phase's workspace,
# from its last checkpoint: MULTI_NCCL_STEPS steps with a world-1 group
# (NCCL on the card) against the same steps without one, and the refresh's
# sweep through it; two ranks on the one card over gloo through
# train_cli's Trainer, MULTI_STEPS steps at the global batch MULTI_BATCH
# (a refresh at each multiple of MULTI_UPDATE: one, from step 60; saves
# every MULTI_SAVE, a split validation at the end), then a
# MULTI_RESUME-step resume; one step of the two ranks on a fixed batch
# whose halves hold MULTI_MASKED of their rays ray-masked, its reduced
# gradient against one rank's on the whole batch within MULTI_GRAD_REL per
# parameter (float32, PERTURB 0), and MULTI_TIMED more steps of each timed.
# A refresh costs ~13 s on the host (PERF.md section 5): one keeps the
# phase near two minutes
MULTI_BATCH = 8192
MULTI_STEPS, MULTI_UPDATE, MULTI_SAVE, MULTI_RESUME = 6, 7, 3, 2
MULTI_NCCL_STEPS, MULTI_TIMED, MULTI_REDUCE_REPS = 3, 3, 10
MULTI_MASKED = (0.05, 0.25)
MULTI_GRAD_REL = 1e-5
# kernels every rank's run must launch: K1 (the sampler, the refresh and
# the mesh sweeps), K2, K10 (the band cache, the validation's SFM near /
# far), K11 (the validation's fine-grid query)
MULTI_KERNELS = ("sdf_mlp", "up_sample", "dda", "sampled_hit")


def fixed_global_batch(pool, n: int, mask_id: int, seed: int = SEED) -> dict:
    """n rows of ``pool`` drawn with a seed; in each half a share
    MULTI_MASKED[half] of the rays relabelled ``mask_id`` (ray-masked)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = pool.gather(rng.choice(len(pool), n, replace=False))
    labels = batch["labels"].copy()
    h = n // 2
    for half, share in enumerate(MULTI_MASKED):
        labels[rng.choice(np.arange(half * h, (half + 1) * h), int(share * h),
                          replace=False)] = mask_id
    return {**batch, "labels": labels}


def grads_rel_l2(got: dict, want: dict) -> dict:
    import numpy as np

    return {k: float(np.linalg.norm((got[k] - want[k]).double().numpy())
                     / max(float(np.linalg.norm(want[k].double().numpy())), 1e-30))
            for k in want}


def fixed_step_spec(cfg_path: str, ck: str, pool, sc: dict, step0: int, dev, n: int) -> dict:
    """``testing/ranks.one_step``'s spec from the checkpoint ``ck`` under
    the config at ``cfg_path`` in float32 at PERTURB 0 (no fine grid): the
    fixed batch of ``n`` rows of ``pool`` (``fixed_global_batch``), the
    scene ``sc``, the optimiser at batch ``n``."""
    import numpy as np

    from neuralrecon_w_tpu_torch.config import (
        field_config_from_cfg, load_cfg, render_config_from_cfg)
    from neuralrecon_w_tpu_torch.datasets.mask_utils import get_label_id_mapping
    from neuralrecon_w_tpu_torch.training.checkpoint import load_field
    from neuralrecon_w_tpu_torch.training.losses import loss_config_from_cfg
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer

    cfg32 = load_cfg(cfg_path)
    cfg32.TPU.FIELD_DTYPE = "float32"
    cfg32.NEUCONW.PERTURB = 0.0
    fc32 = field_config_from_cfg(cfg32)
    lid = get_label_id_mapping()
    mask_ids = tuple(lid[x] for x in cfg32.NEUCONW.RAY_MASK_LIST)
    return {"fc": fc32, "rcfg": render_config_from_cfg(cfg32, sfm_level=-1, fine_level=-1,
                                                      nerf_far_override=False),
            "lcfg": loss_config_from_cfg(cfg32), "anneal_end": int(cfg32.NEUCONW.ANNEAL_END),
            "mask_ids": mask_ids, "seed": int(cfg32.TRAINER.SEED) + 1,
            "optimizer": make_optimizer(cfg32, n)[0],
            "state_dict": {k: v.cpu() for k, v in load_field(ck, fc32, dev).state_dict().items()},
            "batch": fixed_global_batch(pool, n, mask_ids[0]), "step": step0,
            "scene": (np.asarray(sc["origin"], np.float32), np.float32(sc["radius"]),
                      np.asarray(sc["sfm2gt"], np.float32)),
            "device": str(dev)}


def multi_rank_phase(root: str, ck: str, device: str = "cuda", card: str = "the CPU",
                     extra_cfg: dict | None = None, train_voxel: float = TRAINER_VOXEL):
    """Data parallelism from the checkpoint ``ck`` of the workspace at
    ``root`` (see MULTI_BATCH). Returns ({run: launches}, fails)."""
    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.config import load_cfg, render_config_from_cfg
    from neuralrecon_w_tpu_torch.parallel import mesh
    from neuralrecon_w_tpu_torch.parallel.sweep import sharded_sdf_sweep
    from neuralrecon_w_tpu_torch.testing import ranks
    from neuralrecon_w_tpu_torch.training.checkpoint import restore_checkpoint
    from neuralrecon_w_tpu_torch.training.loop import Trainer, TrainerConfig
    from neuralrecon_w_tpu_torch.training.schedule import scaled_lr
    from neuralrecon_w_tpu_torch.training.step import make_train_step

    t_phase = time.perf_counter()
    fails, launches = [], {}
    counters = launch_counters()
    dev = torch.device("cpu" if device == "cpu" else "cuda:0")
    cfg_path = write_cfg(os.path.join(root, "multi.yaml"), root, merged({
        "NEUCONW": {"UPDATE_FREQ": MULTI_UPDATE, "TRAIN_VOXEL_SIZE": train_voxel},
        "TRAINER": {"VAL_FREQ": float(MULTI_STEPS), "SAVE_FREQ": MULTI_SAVE}}, extra_cfg))
    save = os.path.join(root, "results_multi")
    step0 = restore_checkpoint(ck)["step"]

    # 1. a world-1 group (NCCL on the card) against no group, from one state
    cfg = load_cfg(cfg_path)
    cfg.TRAINER.LR = scaled_lr(cfg, MULTI_BATCH)  # as train_cli sets it
    tr = Trainer(cfg, TrainerConfig(batch_size=MULTI_BATCH, ckpt_path=ck, exp_name="multi_w1",
                                    save_dir=save), device=dev)
    rcfg = render_config_from_cfg(cfg, sfm_level=-1, fine_level=tr.train_level,
                                  nerf_far_override=False)
    pool = tr.load_rays()
    batches = [pool.next_batch(MULTI_BATCH) for _ in range(MULTI_NCCL_STEPS)]
    group = mesh.init_data_group(1, device=dev)
    try:
        states = []
        for g in (None, group):
            st = copy.deepcopy(tr.state)
            step = make_train_step(tr.fc, rcfg, tr.lcfg, tr.anneal_end, tr.ray_mask_ids,
                                   seed=int(cfg.TRAINER.SEED) + 1, group=g)
            if g is not None:
                reset_counts(counters)
            for b in batches:
                st, aux = step(st, tr.scene, b, tr.fine_dgrid, None)
            sync()
            if g is not None:
                launches["multi_rank world1"] = read_counts()
            states.append(st)
        differ = [k for (k, a), b in zip(states[0].model.named_parameters(),
                                         states[1].model.parameters()) if not torch.equal(a, b)]
        print(f"multi-rank: {MULTI_NCCL_STEPS} 'vjp' steps at batch {MULTI_BATCH} from step "
              f"{step0} with a {group.backend} group of 1 rank and without a group: parameters "
              f"{'equal bit for bit' if not differ else f'DIFFER in {differ[:4]}'} (loss "
              f"{float(aux['loss']):.6f})")
        if differ:
            fails.append(f"{group.backend} world 1 moved {len(differ)} parameter tensors off "
                         f"the run without a group")
        # the refresh's K1 f32 sweep over its candidates, with and without
        sc = tr.meta.scene_config
        pts = ((tr.sfm_grid.upsample(tr.train_level).centers_sfm() - np.asarray(sc["origin"]))
               / float(sc["radius"])).astype(np.float32)
        sdfs, walls = [], []
        for g in (None, group):
            t0 = time.perf_counter()
            sdfs.append(sharded_sdf_sweep(states[0].model, tr.fc, pts, device=dev, group=g))
            sync()
            walls.append(time.perf_counter() - t0)
        same = np.array_equal(sdfs[0], sdfs[1])
        print(f"multi-rank: the refresh's sweep over {len(pts)} level-{tr.train_level} "
              f"candidates through the {group.backend} group of 1 rank: "
              f"{'equal' if same else 'NOT equal'} to the sweep without a group; "
              f"{walls[1]:.3f} s ({walls[0]:.3f} s without) ({card})")
        if not same:
            fails.append(f"the {group.backend} world-1 sweep differs")
        del pts, sdfs
        n_flat = sum(p.numel() for p in tr.state.model.parameters()) + len(aux) + 1
        buf = torch.ones(n_flat, device=dev)
        mesh.all_reduce_sum_(group, buf)
        sync()
        t0 = time.perf_counter()
        for _ in range(MULTI_REDUCE_REPS):
            mesh.all_reduce_sum_(group, buf)
        sync()
        w1_reduce_ms = (time.perf_counter() - t0) * 1e3 / MULTI_REDUCE_REPS
        backend1 = group.backend
    finally:
        mesh.destroy(group)
    del tr, states, batches
    if device != "cpu":
        torch.cuda.empty_cache()

    # 2. two ranks on the one card over gloo: train_cli's Trainer, a resume
    print(f"multi-rank: two ranks on {'one card' if device != 'cpu' else 'the CPU'} over gloo, "
          f"by an explicit backend choice (NCCL refuses two ranks on one device; no path falls "
          f"back to gloo by itself)")
    base = ["--cfg_path", cfg_path, "--batch_size", str(MULTI_BATCH), "--test_batch_size",
            str(MULTI_BATCH), "--num_epochs", "1000", "--save_dir", save, "--device", device,
            "--log_every", "1"]
    end = step0 + MULTI_STEPS
    run = base + ["--max_steps", str(MULTI_STEPS), "--exp_name", "multi", "--ckpt_path", ck]
    resume = base + ["--max_steps", str(MULTI_RESUME), "--exp_name", "multi_resume",
                     "--ckpt_path", os.path.join(save, "multi", "checkpoints", f"step_{end}.ckpt")]
    out = os.path.join(root, "multi_rank{rank}.json")
    t0 = time.perf_counter()
    mesh.spawn(ranks.cli_rank, 2, (run, resume, 2, mesh.free_coordinator(), out, "gloo",
                                   str(dev)))
    spawn_wall = time.perf_counter() - t0
    rec = []
    for r in (0, 1):
        with open(out.format(rank=r)) as f:
            rec.append(json.load(f))
    for r in rec:
        if r["backend"] != "gloo" or r["world_size"] != 2 or r["foreign_modules"]:
            fails.append(f"rank {r['rank']}: {r['backend']}, world {r['world_size']}, "
                         f"{r['foreign_modules']}")
    want_refresh = {name: [s for s in range(a, b) if s > 0 and s % MULTI_UPDATE == 0]
                    for name, a, b in (("run", step0, end), ("resume", end, end + MULTI_RESUME))}
    for name in ("run", "resume"):
        a, b = rec[0][name], rec[1][name]
        same = a["params"] == b["params"]
        grid = a["fine_grid"] is not None and a["fine_grid"] == b["fine_grid"]
        steps = [[x["step"] for x in r[name]["refreshes"]] for r in rec]
        print(f"multi-rank {name}: step {a['step']} / {b['step']}; parameters "
              f"{'bit for bit equal' if same else 'DIFFER'} on the two ranks; fine grid "
              f"{'equal' if grid else 'NOT equal'} ({a['fine_grid']}); refreshes at {steps[0]} / "
              f"{steps[1]}, walls " + "; ".join(
                  f"rank {r['rank']} " + ", ".join(
                      f"{x['seconds']:.3f} s (sweep {x.get('sweep_seconds', float('nan')):.3f} s, "
                      f"kept {x.get('n_kept')})" for x in r[name]["refreshes"]) for r in rec)
              + f"; run walls {a['seconds']:.2f} / {b['seconds']:.2f} s ({card})")
        if not same or not grid or steps[0] != steps[1] or steps[0] != want_refresh[name]:
            fails.append(f"two gloo ranks' {name}: parameters equal {same}, grids equal {grid}, "
                         f"refreshes {steps}")
        if not all(x.get("n_kept", 0) > 0 for r in rec for x in r[name]["refreshes"]):
            fails.append(f"a refresh of the two gloo ranks' {name} kept no cell")
        want_step = end if name == "run" else end + MULTI_RESUME
        if a["step"] != want_step:
            fails.append(f"two gloo ranks' {name} ended at step {a['step']}, not {want_step}")
    if not rec[0]["run"]["is_main"] or rec[1]["run"]["is_main"] or rec[1]["run"]["logger_path"]:
        fails.append("rank 1 is main or logs")
    recs = log_records(os.path.join(save, "multi", "logs", "metrics.jsonl"))
    logged = [r["step"] for r in recs if "loss" in r]
    ckpts = sorted(f for f in os.listdir(os.path.join(save, "multi", "checkpoints"))
                   if f.endswith(".ckpt"))
    val = [r for r in recs if "val/psnr" in r]
    print(f"multi-rank: rank 0's log steps {logged}, {len(val)} validation(s) (psnr "
          f"{val[0]['val/psnr'] if val else float('nan'):.3f}), checkpoints {ckpts}; the two "
          f"ranks' spawn to exit {spawn_wall:.2f} s")
    want_ckpts = sorted({f"step_{s}.ckpt" for s in range(step0 + 1, end + 1)
                         if s % MULTI_SAVE == 0 or s == end})
    if logged != list(range(step0 + 1, end + 1)) or len(val) != 1 or ckpts != want_ckpts:
        fails.append(f"two gloo ranks wrote log steps {logged}, {len(val)} validations, "
                     f"checkpoints {ckpts}")
    for r in rec:
        got = {k: r["run"]["launches"][k] + r["resume"]["launches"][k]
               for k in r["run"]["launches"]}
        launches[f"multi_rank rank{r['rank']}"] = got
        print(f"launches in rank {r['rank']}'s run and resume: "
              + ", ".join(f"{n} {v}" for n, v in got.items() if v))
        if device != "cpu":
            fails += [f"{n} not launched by rank {r['rank']}" for n in MULTI_KERNELS
                      if got[n] <= 0]

    # 3. the reduced gradient against one rank's, and the steps' walls
    spec = {**fixed_step_spec(cfg_path, ck, pool, sc, step0, dev, MULTI_BATCH),
            "backend": "gloo", "time_steps": MULTI_TIMED, "reduce_reps": MULTI_REDUCE_REPS}
    mask_ids = spec["mask_ids"]
    h = MULTI_BATCH // 2
    masked = [int(np.isin(spec["batch"]["labels"][i * h:(i + 1) * h], mask_ids).sum())
              for i in (0, 1)]
    outs = os.path.join(root, "multi_step{rank}.pt")
    mesh.spawn(ranks.step_rank, 2, (2, mesh.free_coordinator(), spec, outs))
    two = [torch.load(outs.format(rank=r), weights_only=False) for r in (0, 1)]
    one = ranks.one_step(spec)
    equal = all(torch.equal(two[0]["grads"][k], two[1]["grads"][k]) for k in two[0]["grads"])
    rel = grads_rel_l2(two[0]["grads"], one["grads"])
    worst = max(rel, key=rel.get)
    ok = equal and set(two[0]["grads"]) == set(one["grads"]) and rel[worst] <= MULTI_GRAD_REL
    print(f"multi-rank: one f32 step at PERTURB 0 on a fixed batch of {MULTI_BATCH} (halves "
          f"with {masked[0]} / {masked[1]} ray-masked rays): the two gloo ranks' reduced "
          f"gradients {'equal' if equal else 'DIFFER'}; against one rank on the whole batch "
          f"worst rel-L2 {rel[worst]:.2e} ({worst}), bound {MULTI_GRAD_REL}; loss "
          f"{two[0]['aux']['loss']:.7f} / {one['aux']['loss']:.7f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append(f"the reduced gradient: ranks equal {equal}, worst rel-L2 {rel[worst]:.2e} "
                     f"({worst})")
    med = lambda w: sorted(w)[len(w) // 2] * 1e3  # noqa: E731
    print(f"multi-rank per-step wall at global batch {MULTI_BATCH} ({card}): two ranks, two "
          f"processes sharing one card over gloo (not a two-card rate), median "
          f"{med(two[0]['walls']):.1f} / {med(two[1]['walls']):.1f} ms (rank 0 / 1); one rank "
          f"{med(one['walls']):.1f} ms; {MULTI_TIMED} steps each")
    mb = two[0]["reduce_numel"] * 4 / 1e6
    print(f"multi-rank flat all-reduce ({card}): {two[0]['reduce_numel']} floats = {mb:.2f} MB; "
          f"{backend1} world 1 {w1_reduce_ms:.3f} ms, gloo 2 ranks on one card "
          f"{two[0]['reduce_ms']:.3f} / {two[1]['reduce_ms']:.3f} ms (rank 0 / 1); "
          f"{MULTI_REDUCE_REPS} reps")
    print(f"multi-rank phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, fails


# the tensor-parallel phase (parallel/tensor.py) in the same workspace and
# from the same checkpoint: two ranks on the one card over gloo, one data
# shard split over a model axis of 2 by field_param_specs, and one rank with
# no group, TP_STEPS Adam steps each from the checkpoint on one fixed batch
# of TP_BATCH rays in float32 at PERTURB 0, in 'vjp' and in 'pallas' (K3-K5
# on the gathered SDF weights): each step's loss within TP_LOSS_RTOL of one
# rank's, every parameter gathered within TP_PARAM_ATOL (JAX's own TP
# bounds, tests/test_training.py:207-214), the whole leaves bit for bit on
# both ranks, and the first step's gradients, gathered, within TP_GRAD_RTOL
# of one rank's, leaf by leaf relative to the leaf's largest: Adam's first
# update does not see a gradient's scale, so a gradient n_model times too
# large (the library all-reduce in a reduce's place) or a leaf counted
# twice reads 1.0 here and passes the loss and parameter bounds. One bf16
# step at the operating point (PERTURB 1) on the same batch finite; each
# rank's runs launching TP_KERNELS[mode]. The model axis moves ~19 GB a
# 'vjp' step at 8192 rays, and gloo between two ranks on one H100 runs at
# ~1 GB/s: ~20 s a step (PERF.md section 6)
TP_BATCH = 8192
TP_STEPS = 2
TP_LOSS_RTOL, TP_PARAM_ATOL = 1e-5, 1e-4
TP_GRAD_RTOL = 1e-3
TP_KERNELS = {"vjp": ("sdf_mlp", "up_sample"), "bf16": ("sdf_mlp", "up_sample"),
              "pallas": MODE_KERNELS["pallas"]}
# the model axis's all-reduce and all-gather timed at TP_WIRE_MB over
# TP_WIRE_REPS calls: the rate that predicts the collectives' time in a step
TP_WIRE_MB, TP_WIRE_REPS = 256, 3


def tensor_parallel_phase(root: str, ck: str, device: str = "cuda", card: str = "the CPU",
                          extra_cfg: dict | None = None, train_voxel: float = TRAINER_VOXEL):
    """Tensor parallelism from the checkpoint ``ck`` of the workspace at
    ``root`` (see TP_BATCH). Returns ({run: launches}, fails)."""
    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.config import (
        field_config_from_cfg, load_cfg, render_config_from_cfg)
    from neuralrecon_w_tpu_torch.models.neuconw import NeuconWField
    from neuralrecon_w_tpu_torch.parallel import mesh
    from neuralrecon_w_tpu_torch.testing import ranks
    from neuralrecon_w_tpu_torch.training.loop import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    fails = []
    dev = torch.device("cpu" if device == "cpu" else "cuda:0")
    cfg_path = write_cfg(os.path.join(root, "tp.yaml"), root, merged(
        {"NEUCONW": {"TRAIN_VOXEL_SIZE": train_voxel}}, extra_cfg))
    tr = Trainer(load_cfg(cfg_path), TrainerConfig(batch_size=TP_BATCH, ckpt_path=ck,
                                                   exp_name="tp", save_dir=root), device=dev)
    pool, sc, step0 = tr.load_rays(), tr.meta.scene_config, tr.state.step
    del tr
    spec = fixed_step_spec(cfg_path, ck, pool, sc, step0, dev, TP_BATCH)
    del pool
    cfg, cfg32 = load_cfg(cfg_path), load_cfg(cfg_path)
    cfg32.TPU.FIELD_DTYPE, cfg32.TPU.SDF_GRAD_MODE = "float32", "pallas"
    runs = [{"label": "vjp", "fc": spec["fc"], "n_steps": TP_STEPS},
            {"label": "pallas", "fc": field_config_from_cfg(cfg32), "n_steps": TP_STEPS},
            {"label": "bf16", "fc": field_config_from_cfg(cfg), "n_steps": 1,
             "rcfg": render_config_from_cfg(cfg, sfm_level=-1, fine_level=-1,
                                            nerf_far_override=False)}]
    spec.update(runs=runs, backend="gloo", wire_mb=TP_WIRE_MB, wire_reps=TP_WIRE_REPS)
    specs = mesh.field_param_specs(2, NeuconWField(spec["fc"], "cpu"))
    kinds = {k: sum(1 for s in specs.values() if s == k) for k in ("col", "row", "vocab", None)}
    print(f"tensor-parallel: field_param_specs over 2 model ranks: {kinds['col']} column, "
          f"{kinds['row']} row ({', '.join(k for k, s in specs.items() if s == 'row')}), "
          f"{kinds['vocab']} vocab, {kinds[None]} whole of {len(specs)} parameters; two ranks "
          f"on {'one card' if device != 'cpu' else 'the CPU'} over gloo (n_data 1, n_model 2)")
    if device != "cpu":
        torch.cuda.empty_cache()
    out = os.path.join(root, "tp_rank{rank}.pt")
    t0 = time.perf_counter()
    mesh.spawn(ranks.tp_step_rank, 2, (2, 2, mesh.free_coordinator(), spec, out))
    spawn_wall = time.perf_counter() - t0
    two = [torch.load(out.format(rank=r), weights_only=False) for r in (0, 1)]
    one = ranks.tp_step({**spec, "runs": runs[:2]})
    for r in two:
        if r["foreign_modules"]:
            fails.append(f"tensor-parallel rank {r['rank']} loaded {r['foreign_modules']}")
    ms = lambda w: w[-1] * 1e3  # noqa: E731  the last step's wall (the first warms up)
    wire = two[0]["wire"]
    rate = {k: wire["mb"] / wire[k] for k in ("all_reduce", "all_gather")}  # MB / ms
    print(f"tensor-parallel gloo between the two ranks ({card}): all-reduce of "
          f"{wire['mb']:.0f} MB {wire['all_reduce']:.1f} ms ({rate['all_reduce']:.3f} GB/s), "
          f"all-gather of {wire['mb']:.0f} MB {wire['all_gather']:.1f} ms "
          f"({rate['all_gather']:.3f} GB/s), {TP_WIRE_REPS} calls each")
    for label in ("vjp", "pallas"):
        a, b = (r[label] for r in two)
        o = one[label]
        loss_err = max(abs(x - y) / abs(y) for r in (a, b) for x, y in zip(r["losses"],
                                                                           o["losses"]))
        param_err = {k: float((a["params"][k] - v).abs().max()) for k, v in o["params"].items()}
        worst = max(param_err, key=param_err.get)
        whole_equal = a["whole_digests"] == b["whole_digests"]
        pre_equal = a["pre_sync_digests"] == b["pre_sync_digests"]
        gathered_equal = all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
        grad_err = {k: max(float((r["grads"][k] - g).abs().max() / g.abs().max().clamp_min(
            1e-30)) for r in (a, b)) for k, g in o["grads"].items()}
        worst_g = max(grad_err, key=grad_err.get)
        ok = (loss_err <= TP_LOSS_RTOL and param_err[worst] <= TP_PARAM_ATOL and whole_equal
              and gathered_equal and set(a["params"]) == set(o["params"])
              and grad_err[worst_g] <= TP_GRAD_RTOL and set(a["grads"]) == set(o["grads"]))
        print(f"tensor-parallel {label}: {TP_STEPS} f32 steps at PERTURB 0 on a fixed batch of "
              f"{TP_BATCH} from step {step0}: losses {[f'{x:.7f}' for x in a['losses']]} / "
              f"{[f'{x:.7f}' for x in b['losses']]} (rank 0 / 1) against one rank's "
              f"{[f'{x:.7f}' for x in o['losses']]}: worst rel {loss_err:.2e} (bound "
              f"{TP_LOSS_RTOL}); gathered parameters worst |diff| {param_err[worst]:.2e} "
              f"({worst}; bound {TP_PARAM_ATOL}); the first step's gathered gradients worst "
              f"{grad_err[worst_g]:.2e} of the leaf's largest ({worst_g}; bound "
              f"{TP_GRAD_RTOL}); the {len(a['whole_digests'])} whole "
              f"parameters {'bit for bit equal' if whole_equal else 'DIFFER'} on the two ranks "
              f"(their gradients before the sync {'equal' if pre_equal else 'differ'}) -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"tensor-parallel {label}: loss rel {loss_err:.2e}, params "
                         f"{param_err[worst]:.2e} ({worst}), gradients {grad_err[worst_g]:.2e} "
                         f"({worst_g}), whole equal {whole_equal}, "
                         f"gathered equal {gathered_equal}")
        t = a["traffic"]
        predicted = sum(t[k]["bytes"] / 1e6 / rate[k] for k in rate)
        print(f"tensor-parallel {label} step wall ({card}): two ranks sharing "
              f"{'one card' if device != 'cpu' else 'the CPU'} over gloo {ms(a['walls']):.1f} / "
              f"{ms(b['walls']):.1f} ms (rank 0 / 1), one rank {ms(o['walls']):.1f} ms (the "
              f"last of {TP_STEPS} steps); the model group's collectives in that step on rank "
              f"0: all-reduce {t['all_reduce']['calls']} calls "
              f"{t['all_reduce']['bytes'] / 1e6:.1f} MB, all-gather "
              f"{t['all_gather']['calls']} calls {t['all_gather']['bytes'] / 1e6:.1f} MB, "
              f"{predicted:.1f} ms at the timed gloo rates")
    bf = [r["bf16"] for r in two]
    finite = all(np.isfinite(r["losses"]).all() and all(bool(torch.isfinite(v).all())
                                                         for v in r["params"].values())
                 for r in bf)
    print(f"tensor-parallel bf16: one step at the operating point (PERTURB "
          f"{cfg.NEUCONW.PERTURB}) on the {TP_BATCH} rays: loss {bf[0]['losses'][0]:.6f} / {bf[1]['losses'][0]:.6f}, "
          f"{'finite' if finite else 'NOT finite'}; wall {ms(bf[0]['walls']):.1f} ms ({card})")
    if not finite or bf[0]["losses"] != bf[1]["losses"]:
        fails.append(f"tensor-parallel bf16 step: finite {finite}, losses "
                     f"{[r['losses'] for r in bf]}")
    launches = {}
    for r in two:
        got = {k: sum(r[label]["launches"][k] for label in TP_KERNELS) for k in
               r["vjp"]["launches"]}
        launches[f"tensor_parallel rank{r['rank']}"] = got
        print(f"launches in tensor-parallel rank {r['rank']}: " + "; ".join(
            f"{label} " + ", ".join(f"{n} {v}" for n, v in r[label]["launches"].items() if v)
            for label in TP_KERNELS))
        if device != "cpu":
            fails += [f"{n} not launched by tensor-parallel rank {r['rank']} in {label}"
                      for label, names in TP_KERNELS.items() for n in names
                      if r[label]["launches"][n] <= 0]
    print(f"tensor-parallel phase: {time.perf_counter() - t_phase:.1f} s (the two ranks' spawn "
          f"to exit {spawn_wall:.1f} s)")
    return launches, fails


# every TRAINER.OPTIMIZER on the captured window (optimizer_phase), in
# trainer_phase's workspace from its last checkpoint's parameters and fine
# grid with no optimiser state (each optimiser starts fresh; a state of
# another would raise), the steady phase on the device pool and its band
# cache, 'vjp' at batch TRAIN_BATCH. For each of OPT_NAMES: (a) graph_parity
# from a fresh state over a window of OPT_WINDOW steps (GRAPH_WARMUP eager,
# the capture, the replays: RAdam's updates 1-5 unrectified, 6-8 rectified)
# against the plain loop over the same rays, its 'vjp' bounds (in float32 at
# PERTURB 0 the loss terms within GRAPH_LOSS_RTOL, the parameters within
# GRAPH_PARAM_REL; the operating point's mean loss); besides, the graph's
# change of the parameters over the window within OPT_CHANGE_REL of the
# eager one's (the window moves them by ~1e-5 of their norm, so
# GRAPH_PARAM_REL alone would pass a graph whose replays updated nothing),
# and no host sync in an eager or a graph_step update
# (torch.cuda.set_sync_debug_mode "warn"); (b) train_cli with
# TRAINER.OPTIMIZER set, DEVICE_POOL 'auto' and SCAN_INNER OPT_SCAN: one
# window from the parameters-only file, saved at update OPT_SCAN, then one
# resumed window, each a captured graph replayed whose step launched K1 and
# K2 and nothing outside MODE_KERNELS['vjp'] and K10 / K11, the restored
# optimiser state bit for bit the saved one, the logged scalars finite.
# (c) A record, in turns for adam and OPT_NAMES: the ms a step of
# OPT_RATE_INNER-step replayed windows at the operating point
OPT_NAMES = ("sgd", "radam")
OPT_WINDOW, OPT_SCAN, OPT_RATE_INNER = 8, 5, 5
OPT_CHANGE_REL = 1e-3
OPT_STEP_KERNELS = MODE_KERNELS["vjp"] + ("sdf_mlp_bf16", "sdf_mlp_f32", "dda", "sampled_hit")


def update_syncs(state) -> list:
    """The host syncs (``host_syncs``) of an eager update and a
    ``graph_step`` of a capturable copy of ``state``'s optimiser, after one
    untimed update."""
    import torch

    st = capturable_copy(state)
    for p in st.model.parameters():
        p.grad = torch.full_like(p, 1e-4)
    count_t = torch.zeros((), dtype=torch.float64, device=next(st.model.parameters()).device)
    st.optimizer.step()
    sync()
    return host_syncs(lambda: (st.optimizer.step(), st.optimizer.graph_step(count_t)))


def same_state(a: dict, b: dict) -> bool:
    """Two ``Optimizer.state_dict()``s equal bit for bit: name, count and
    every state tensor (wherever each lies)."""
    import torch

    sa, sb = a["state"]["state"], b["state"]["state"]
    return (a["name"] == b["name"] and a["count"] == b["count"] and sa.keys() == sb.keys()
            and all(sa[i].keys() == sb[i].keys()
                    and all(torch.equal(sa[i][k].cpu(), sb[i][k].cpu()) for k in sa[i])
                    for i in sa))


def optimizer_phase(root: str, ck: str, device: str = "cuda", card: str = "the CPU",
                    extra_cfg: dict | None = None, train_voxel: float = TRAINER_VOXEL):
    """Every TRAINER.OPTIMIZER from the checkpoint ``ck`` of the workspace
    at ``root`` (see OPT_NAMES). Returns ({run: launches}, fails)."""
    import torch

    from neuralrecon_w_tpu_torch.config import load_cfg, render_config_from_cfg
    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool
    from neuralrecon_w_tpu_torch.training import loop
    from neuralrecon_w_tpu_torch.training.checkpoint import latest_checkpoint, restore_checkpoint
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer, scaled_lr
    from neuralrecon_w_tpu_torch.training.step import GRAPH_WARMUP, TrainState

    t_phase = time.perf_counter()
    fails, launches = [], {}
    counters = launch_counters()
    dev = torch.device("cpu" if device == "cpu" else "cuda:0")
    start_ck = torch.load(ck, map_location="cpu", weights_only=False)
    del start_ck["optimizer"]
    ck0 = os.path.join(root, "optimizer_start.ckpt")
    torch.save(start_ck, ck0)
    step0 = int(start_ck["global_step"])
    if step0 % OPT_SCAN:
        fails.append(f"optimizer phase: step {step0} is no multiple of SCAN_INNER {OPT_SCAN}, so "
                     "the SAVE_FREQ edge splits its windows")
    base = merged({"NEUCONW": {"UPDATE_FREQ": 0, "TRAIN_VOXEL_SIZE": train_voxel},
                   "TRAINER": {"VAL_FREQ": 1000.0, "SAVE_FREQ": OPT_SCAN},
                   "TPU": {"DEVICE_POOL": "auto" if device == "cuda" else True,
                           "SCAN_INNER": OPT_SCAN}}, extra_cfg)
    save = os.path.join(root, "results_optimizer")
    cfg = load_cfg(write_cfg(os.path.join(root, "optimizer.yaml"), root, base))
    cfg.TRAINER.LR = scaled_lr(cfg, TRAIN_BATCH)  # as train_cli sets it
    tr = loop.Trainer(cfg, loop.TrainerConfig(batch_size=TRAIN_BATCH, ckpt_path=ck0,
                                              exp_name="optimizer", save_dir=save), device=dev)
    pool = DeviceRayPool(tr.load_rays(), dev, seed=SEED)
    pool.attach_surface(tr.fine_dgrid, tr.train_level)
    level = tr.train_level

    def fresh(name):
        c = copy.deepcopy(cfg)
        c.TRAINER.OPTIMIZER = name
        model = copy.deepcopy(tr.state.model)
        return TrainState(model, make_optimizer(c, TRAIN_BATCH)[0].init(model.parameters()),
                          tr.state.step)

    # (a) a captured window against the plain loop, per optimiser
    reset_counts(counters)
    runs = []
    for name in OPT_NAMES:
        state0 = fresh(name)
        out, pfails = graph_parity(cfg, state0, tr.scene, pool, tr.fine_dgrid, level,
                                   f"optimizer {name}", batch=TRAIN_BATCH, n_inner=OPT_WINDOW)
        runs += out["runs"]
        f32 = out["f32"]
        syncs = update_syncs(state0) if device == "cuda" else []
        want_runs = (1, OPT_WINDOW - GRAPH_WARMUP) if device == "cuda" else (0, 0)
        ok = (not pfails and f32["change_rel"] <= OPT_CHANGE_REL and f32["moved"] > 0
              and not syncs and f32["runs"] == want_runs
              and f32["counts"] == (OPT_WINDOW, OPT_WINDOW))
        print(f"optimizer {name}: graph vs eager, steady vjp, {OPT_WINDOW} steps from a fresh "
              f"state ({f32['runs'][0]} capture, {f32['runs'][1]} replays, update counts "
              f"{f32['counts']}): graph_parity's bounds "
              + ("held" if not pfails else "FAILED") + f"; the parameters' change rel-L2 "
              f"{f32['change_rel']:.2e} of eager's (bound {OPT_CHANGE_REL:.0e}), moved rel-L2 "
              f"{f32['moved']:.3e}; host syncs in an update: " + (", ".join(syncs) or "none")
              + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"optimizer {name}: graph vs eager")
        del state0, out
    launches["optimizer parity"] = read_counts()
    launches["optimizer parity_graph"] = graph_launches(runs, launches["optimizer parity"])

    # (c) replayed windows at the operating point, in turns
    fc = train_config(cfg, "vjp")
    rcfg = render_config_from_cfg(cfg, sfm_level=-1, fine_level=level, nerf_far_override=False)
    names = ("adam",) + OPT_NAMES
    reset_counts(counters)
    states = {n: fresh(n) for n in names}
    rate_runs = {n: scan_run(cfg, fc, rcfg, TRAIN_BATCH, OPT_RATE_INNER, True) for n in names}
    walls = {n: [] for n in names}
    for n in names + names + names[::-1]:  # the first call of each captures, untimed
        perm, start = pool.take_scan_window(TRAIN_BATCH, OPT_RATE_INNER)
        sync()
        t0 = time.perf_counter()
        states[n], aux = rate_runs[n](states[n], tr.scene, pool.data, tr.fine_dgrid, None, perm,
                                      start)
        sync()
        walls[n].append(time.perf_counter() - t0)
        bad = [k for k, v in aux.items() if not bool(torch.isfinite(v))]
        if bad:
            fails.append(f"optimizer {n} replayed window: {bad} not finite")
    ms = {n: 1e3 * sum(w[1:]) / ((len(w) - 1) * OPT_RATE_INNER) for n, w in walls.items()}
    print(f"optimizer windows, steady vjp {fc.act_dtype} at batch {TRAIN_BATCH} ({card}): ms a "
          f"step over {OPT_RATE_INNER}-step {'replayed' if device == 'cuda' else 'eager'} "
          f"windows in turns (" + ", ".join(names + names[::-1]) + "): " + ", ".join(
              f"{n} {ms[n]:.3f}" for n in names) + "; each first call (warm-up and capture) "
          + ", ".join(f"{n} {walls[n][0]:.3f} s" for n in names))
    launches["optimizer rates"] = read_counts()
    launches["optimizer rates_graph"] = graph_launches(rate_runs.values(),
                                                       launches["optimizer rates"])
    for r in rate_runs.values():
        r.release()
    del states, rate_runs, tr, pool
    free_cached()

    # (b) train_cli, a save inside RAdam's first five updates, a resume
    extra = ["--log_every", str(OPT_SCAN), "--test_batch_size", str(TRAIN_BATCH)]
    restored = []
    real_restore = loop.Trainer._restore

    def restore(self, path):
        real_restore(self, path)
        restored.append(copy.deepcopy(self.state.optimizer.state_dict()))

    for name in OPT_NAMES:
        cfg_path = write_cfg(os.path.join(root, f"optimizer_{name}.yaml"), root,
                             merged(base, {"TRAINER": {"OPTIMIZER": name}}))
        trs, saved = [], None
        with mock.patch.object(loop.Trainer, "_restore", restore):
            for run, ckpt in ((f"optimizer {name}", ck0), (f"optimizer {name}_resume", None)):
                if ckpt is None:
                    ckpt = latest_checkpoint(trs[0].ckpt_dir) or ""
                reset_counts(counters)
                t0 = time.perf_counter()
                t = train_cli(cfg_path, save, run.replace(" ", "_"), TRAIN_BATCH, OPT_SCAN,
                              device, extra + ["--ckpt_path", ckpt])
                sync()
                wall = time.perf_counter() - t0
                got = launches[run] = read_counts()
                launches[f"{run}_graph"] = graph_launches(t.scan_runs(), got)
                trs.append(t)
                if saved is None:
                    saved = copy.deepcopy(t.state.optimizer.state_dict())
                recs = log_records(t.logger.path)
                bad = [(r["step"], k) for r in recs for k, v in r.items() if not math.isfinite(v)]
                losses = [(r["step"], r["loss"]) for r in recs if "loss" in r]
                scan = t.scan_runs()
                print(f"{run}: train_cli {OPT_SCAN} steps from step {t.state.step - OPT_SCAN} "
                      f"to {t.state.step}, update count {t.state.optimizer.count}; "
                      + ("; ".join(f"a {r.n_inner}-step run: {r.captures} capture(s), "
                                   f"{r.replays} replays, per captured step " + ", ".join(
                                       f"{k} {v}" for k, v in sorted(r.per_step_launches.items()))
                                   for r in scan) or "no multi-step run")
                      + "; counted " + (", ".join(f"{k} {v}" for k, v in got.items() if v)
                                        or "none")
                      + "; logged loss " + ", ".join(f"{s} {v:.5f}" for s, v in losses)
                      + f"; wall {wall:.2f} s")
                if bad or not losses:
                    fails.append(f"{run}: logged losses {losses}, non-finite {bad[:5]}")
                if device == "cuda":
                    fails += resume_graph_fails(t, "vjp")
                    fails += [f"{run}: {k} launched, outside the vjp step's kernels"
                              for r in scan for k in r.per_step_launches
                              if k not in OPT_STEP_KERNELS]
                    fails += [f"{run}: {k} launched {v} times, outside the vjp step's kernels"
                              for k, v in got.items() if v and k not in OPT_STEP_KERNELS]
                for r in scan:
                    r.release()
        at = [(t.state.step, t.state.optimizer.count) for t in trs]
        want = [(step0 + OPT_SCAN, OPT_SCAN), (step0 + 2 * OPT_SCAN, 2 * OPT_SCAN)]
        file = restore_checkpoint(latest_checkpoint(trs[0].ckpt_dir))["optimizer"]
        equal = same_state(restored[-1], saved) and same_state(file, saved)
        print(f"optimizer {name}: saved at step {want[0][0]}, update {file['count']} "
              f"({file['name']}); the resumed Trainer's state "
              f"{'equals' if equal else 'DIFFERS from'} the saved one bit for bit ({len(saved['state']['state'])} parameters' "
              + ", ".join(sorted(next(iter(saved["state"]["state"].values()), {})))
              + f"); steps and counts {at}")
        if at != want or not equal or file["name"] != name:
            fails.append(f"optimizer {name}: train_cli and resume at {at}, restored state equal "
                         f"{equal}")
        del trs
        free_cached()
    print(f"optimizer phase ({card}): {time.perf_counter() - t_phase:.1f} s")
    return launches, fails


def e2e_gate_phase(root: str, device: str = "cuda", card: str = "the CPU"):
    """tests/test_e2e.py:79-191 through the port's CLIs: its workspace (6
    views of 40x30) and cache, train_cli 300 steps at batch 512 (the
    refreshed grid's voxels within E2E_VOXELS; on the card under the
    default TPU.DEVICE_POOL 'auto', so the device pool and the CUDA graph,
    which the phase checks ran and whose replays it counts into the
    train run's launches), extract_mesh_cli at
    --mesh_size 48 --vertex_color, eval_mesh against the analytic sphere
    (E2E_GATES, docs/e2e_gate_calibration.json), render_cli from the trained
    checkpoint (image std above E2E_RENDER_STD), and a resume to step 302.
    Returns (launches, fails)."""
    import numpy as np
    import yaml
    from PIL import Image

    from neuralrecon_w_tpu_torch.evaluation import eval_mesh
    from neuralrecon_w_tpu_torch.tools import extract_mesh_cli, render_cli
    from neuralrecon_w_tpu_torch.training.checkpoint import latest_checkpoint
    from neuralrecon_w_tpu_torch.utils.ply import read_ply

    fails = []
    scene = os.path.join(root, "sphere_scene")
    info = cli_workspace(scene, device, 6, (40, 30), 300, 3.0, 8)
    cfg_path = os.path.join(root, "train_sphere.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({**E2E_CFG, "DATASET": {"ROOT_DIR": scene, "DATASET_NAME": "phototourism",
                                               "PHOTOTOURISM": {"IMG_DOWNSCALE": 1}}}, f)
    counters = launch_counters()
    save_dir = os.path.join(root, "run")
    reset_counts(counters)
    t0 = time.perf_counter()
    tr = train_cli(cfg_path, save_dir, "sphere", 512, 300, device, ["--test_batch_size", "128"])
    sync()
    t_train = time.perf_counter() - t0
    counted = read_counts()
    graph = graph_launches(tr.scan_runs(), counted)
    launches = {"train": {n: v + graph[n] for n, v in counted.items()}}
    scan = tr.scan_runs()
    print(f"e2e gate's train_cli: {type(tr.device_pool).__name__ if tr.device_pool else 'host'}"
          " pool; " + "; ".join(
              f"{'graph' if r.captures else 'eager'} {r.n_inner}-step run: {r.captures} "
              f"capture(s), {r.replays} replays" for r in scan)
          + "; launches added by the graphs ((replays - captures) x per step) "
          + ", ".join(f"{n} {v}" for n, v in graph.items() if v))
    if device == "cuda":
        from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool

        if not isinstance(tr.device_pool, DeviceRayPool) or not any(graph_ran(r) for r in scan):
            fails.append("the e2e gate's train_cli did not run the device pool and a CUDA graph")
    n_vox = len(tr.fine_grid_host.coords) if tr.fine_grid_host is not None else 0
    ck = latest_checkpoint(tr.ckpt_dir)
    if tr.state.step != 300 or not E2E_VOXELS[0] <= n_vox <= E2E_VOXELS[1] or not ck \
            or not ck.endswith("step_300.ckpt") or os.path.getsize(tr.logger.path) == 0:
        fails.append(f"e2e train: step {tr.state.step}, {n_vox} voxels, checkpoint {ck}")

    reset_counts(counters)
    out = os.path.join(root, "mesh.ply")
    t0 = time.perf_counter()
    res = extract_mesh_cli.main(["--cfg_path", cfg_path, "--ckpt_path", ck or "", "--mesh_size",
                                 "48", "--chunk", "8192", "--vertex_color", "--a_index", "1",
                                 "--out", out, "--device", device])
    sync()
    t_mesh = time.perf_counter() - t0
    launches["extract"] = read_counts()
    metrics = {}
    if res is None or res.path != out or len(read_ply(out)["verts"]) <= 50 \
            or "colors" not in read_ply(out):
        fails.append("e2e extract_mesh_cli: no coloured mesh")
    else:
        # the workspace's gt.ply: tests/test_e2e.py's analytic sphere cloud
        metrics = eval_mesh(out, os.path.join(scene, "gt.ply"), info["scene_config"],
                            is_mesh=True, threshold=[0.5],
                            save_name="e2e", write_visualizations=False)
        f05 = metrics["fscores"][0]
        p2g, g2p = metrics["chamfer_pred_to_gt"], metrics["chamfer_gt_to_pred"]
        if not (f05 > E2E_GATES["fscore"] and p2g < E2E_GATES["chamfer_pred_to_gt"]
                and g2p < E2E_GATES["chamfer_gt_to_pred"]):
            fails.append(f"e2e gate: F@0.5 {f05:.4f}, chamfer pred->gt {p2g:.4f}, "
                         f"gt->pred {g2p:.4f} (gates {E2E_GATES})")

    render_dir = os.path.join(root, "render")
    render_cli.main(["--cfg_path", cfg_path, "--ckpt_path", ck or "", "--out_dir", render_dir,
                     "--img_downscale", "2", "--chunk", "120", "--device", device])
    pngs = [p for p in os.listdir(render_dir)
            if p.startswith("view_") and not p.endswith(("_depth.png", "_normal.png"))]
    std = (float(np.asarray(Image.open(os.path.join(render_dir, pngs[0])), np.float32).std())
           if len(pngs) == 1 else 0.0)
    if len(pngs) != 1 or std <= E2E_RENDER_STD:
        fails.append(f"e2e render_cli: {pngs}, std {std:.3f}")

    reset_counts(counters)
    tr2 = train_cli(cfg_path, save_dir, "sphere_resume", 512, 2, device,
                    ["--test_batch_size", "128", "--ckpt_path", ck or "", "--divide_lr"])
    sync()
    launches["resume"] = read_counts()
    if tr2.state.step != 302:
        fails.append(f"e2e resume ended at step {tr2.state.step}, not 302")
    print(f"e2e gate ({card}): train_cli 300 steps at batch 512 in {t_train:.2f} s, "
          f"{n_vox} fine voxels; mesh at 48^3 in {t_mesh:.2f} s; F@0.5 "
          f"{metrics.get('fscores', [float('nan')])[0]:.4f}, chamfer pred->gt "
          f"{metrics.get('chamfer_pred_to_gt', float('nan')):.4f}, gt->pred "
          f"{metrics.get('chamfer_gt_to_pred', float('nan')):.4f}; render std {std:.3f}; "
          f"resumed to step {tr2.state.step}")
    for run, got in launches.items():
        print(f"launches in the e2e gate's {run}: " + ", ".join(
            f"{n} {v}" for n, v in got.items() if v))
    if device == "cuda":
        fails += [f"{n} not launched in the e2e gate's {run}"
                  for run, names in (("train", ("sdf_mlp_f32", "up_sample")),
                                     ("extract", ("sdf_mlp_f32", "field_fwd")))
                  for n in names if launches[run][n] <= 0]
    return launches, fails


# the kernels redesigned in the latest slice: (label, entry function)
# ------------------------- the served frame as a graph -------------------------


def render_frames(model, fc, rcfg, scene, frames, fine_grid, sfm_grid, scan=None, wh=IMG_WH):
    """Every frame of wh through render_image at CHUNK, the first untimed;
    with ``scan`` (make_scan_render_fn's run) as one call a frame. Returns
    (seconds of the timed frames, outputs)."""
    import numpy as np

    from neuralrecon_w_tpu_torch.training.step import make_render_fn
    from neuralrecon_w_tpu_torch.training.validation import render_image

    render_chunk = make_render_fn(fc, rcfg)
    w, h = wh
    seconds, outs = 0.0, []
    for f, rays in enumerate(frames):
        ts = np.full((len(rays),), f, np.int64)
        labels = np.zeros((len(rays),), np.int64)
        sync()
        t0 = time.perf_counter()
        outs.append(render_image(render_chunk, model, scene, rays, ts, labels, (w, h), CHUNK,
                                 fine_grid, sfm_grid, scan_render=scan))
        sync()
        if f > 0:
            seconds += time.perf_counter() - t0
    return seconds, outs


def scan_launches(counted: dict, run) -> dict:
    """The launches a scan render ran, keyed as ``counted`` (the counts read
    after it): the wrappers count each captured launch once, so a graph's
    replays add replays - captures times the launches of a captured chunk."""
    return {k: v + (run.replays - run.captures) * run.per_chunk_launches.get(k, 0)
            for k, v in counted.items()}


def host_syncs(fn) -> list:
    """The host syncs of ``fn()``: torch's sync debug mode's warnings
    (distinct messages), on the card."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch warns "called a synchronizing CUDA operation" at each sync, and
    # once that the mode is a prototype, which is not a sync
    return sorted({str(w.message).splitlines()[0] for w in caught
                   if "synchroniz" in str(w.message) and "prototype" not in str(w.message)})


def sync_warnings(model, fc, rcfg, scene, rays, fine_grid, sfm_grid) -> list:
    """The host syncs of one eager served chunk (``host_syncs``)."""
    import torch

    from neuralrecon_w_tpu_torch.training.step import make_render_fn

    dev = scene.origin.device
    r = torch.as_tensor(rays[:CHUNK], device=dev)
    ts = torch.zeros(r.shape[0], dtype=torch.long, device=dev)
    fn = make_render_fn(fc, rcfg)
    fn(model, scene, r, ts, ts, None, fine_grid, sfm_grid)
    sync()
    return host_syncs(lambda: fn(model, scene, r, ts, ts, None, fine_grid, sfm_grid))


def serving_kernels(fc) -> tuple:
    """The forward kernels a served chunk runs besides the sampler's and
    the grid queries: K3 in 'pallas', K6 in 'pallas_field', K8 with
    FUSED_BG."""
    return ({"pallas": ("sdf_vjp_fwd",), "pallas_field": ("field_fwd",)}.get(fc.grad_mode, ())
            + (("nerf_bg_fwd",) if fc.bg_mode == "pallas" else ()))


def serving_graph_phase(model, fc, rcfg, scene, frames, fine_grid, sfm_grid, label,
                        profile=False, wh=IMG_WH):
    """The served frames rendered in turns as eager chunks (render_image's
    host loop of make_render_fn), as the captured graph of
    make_scan_render_fn (one call a frame: the frame copied in once, every
    chunk a replay, one fetch), the graph again, and eager again. Every
    graph frame must equal the eager frame bit for bit (both at perturb 0,
    the same kernels in the same order). Returns (rays/s by mode, the
    graph's launches by kernel, fails): a captured chunk's launches times
    the replays and the one eager chunk run before the capture."""
    import numpy as np

    from neuralrecon_w_tpu_torch.training.step import make_scan_render_fn

    w, h = wh
    scan = make_scan_render_fn(fc, rcfg, CHUNK)
    walls, outs = {"eager": [], "graph": []}, {}
    for mode in ("eager", "graph", "graph", "eager"):
        seconds, o = render_frames(model, fc, rcfg, scene, frames, fine_grid, sfm_grid,
                                   scan if mode == "graph" else None, wh)
        walls[mode].append(seconds)
        outs.setdefault(mode, []).append(o)
    fails = []
    worst = {}
    for turn in outs["graph"]:
        for g, e in zip(turn, outs["eager"][0]):
            for k in e:
                d = float(np.abs(g[k].astype(np.float64) - e[k]).max())
                worst[k] = max(worst.get(k, 0.0), d)
    equal = all(v == 0.0 for v in worst.values())
    n_timed = (len(frames) - 1) * w * h
    rps = {m: n_timed / (sum(v) / len(v)) for m, v in walls.items()}
    per_chunk = sum(scan.per_chunk_launches.values())
    n_chunks = -(-w * h // CHUNK)
    print(f"serving graph {label}: {len(frames) - 1} timed frames of {w}x{h} in turns eager / "
          f"graph / graph / eager: " + " / ".join(
              f"{n_timed / t:.1f}" for t in (walls['eager'][0], walls['graph'][0],
                                              walls['graph'][1], walls['eager'][1]))
          + f" rays/s; graph {scan.captures} capture, {scan.replays} replays ({n_chunks} a "
          f"frame), {per_chunk} kernel launches a captured chunk ("
          + ", ".join(f"{k} {v}" for k, v in sorted(scan.per_chunk_launches.items()))
          + f"); graph frames vs eager max|diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" -> {'bit for bit' if equal else 'FAIL'}")
    if not equal:
        fails.append(f"serving graph {label}: frames differ from the eager frames "
                     f"({worst})")
    on_card = scene.origin.device.type == "cuda"
    want = (1, 2 * len(frames) * n_chunks) if on_card else (0, 0)  # the CPU: the plain loop
    if (scan.captures, scan.replays) != want:
        fails.append(f"serving graph {label}: {scan.captures} captures, {scan.replays} replays")
    launches = {k: v * (scan.replays + scan.captures) for k, v in scan.per_chunk_launches.items()}
    wanted = ("sdf_mlp", "up_sample", "dda") + (("sampled_hit",) if fine_grid is not None
                                                  else ()) + serving_kernels(fc)
    if on_card:
        fails += [f"serving graph {label}: {n} not in the captured chunk" for n in wanted
                  if scan.per_chunk_launches.get(n, 0) <= 0]
        syncs = sync_warnings(model, fc, rcfg, scene, frames[1], fine_grid, sfm_grid)
        print(f"host syncs in one eager {label} chunk (torch.cuda.set_sync_debug_mode 'warn'): "
              f"{len(syncs)}" + ("" if not syncs else ": " + "; ".join(syncs)))
    if profile:
        profile_scan_frame(scan, model, scene, frames[1], fine_grid, sfm_grid, label, wh)
    scan.release()
    return rps, launches, fails


def profile_scan_frame(scan, model, scene, rays, fine_grid, sfm_grid, label, wh=IMG_WH) -> None:
    """torch.profiler over one frame of replays: wall, the device's busy
    share (every device event but the renderer's ranges), the top kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuralrecon_w_tpu_torch.training.validation import render_image

    n = len(rays)
    ts, labels = np.zeros(n, np.int64), np.zeros(n, np.int64)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_image(None, model, scene, rays, ts, labels, wh, CHUNK, fine_grid, sfm_grid,
                     scan_render=scan)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("render.")]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    n_chunks = -(-n // CHUNK)
    print(f"profile {label} graph frame of {n} rays ({n_chunks} replays of {CHUNK}): wall "
          f"{wall_ms:.1f} ms ({wall_ms / n_chunks:.2f} a chunk), {sum(e.count for e in device)} "
          f"device events busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    print(events.table(sort_by="self_device_time_total", row_limit=10))


def render_cli_dispatch_check(cfg_path: str, ck: str, root: str, device: str,
                              downscale: int = 1, tag: str = ""):
    """``render_cli.main`` on a checkpoint with ``--dispatch scan`` and
    ``--dispatch chunk`` (the first training view at ``downscale``, chunks
    of CHUNK), in the cfg's SDF_GRAD_MODE and background: the same PNG
    arrays, and on the card the mode's forward kernels (``serving_kernels``)
    in the captured chunk. Returns ({"render_<tag>scan", "render_<tag>chunk":
    launches}, fails); the scan run's launches count its graph's replays
    (``scan_launches``)."""
    import numpy as np
    from PIL import Image

    from neuralrecon_w_tpu_torch.tools import render_cli
    from neuralrecon_w_tpu_torch.training import step

    made, real = [], step.make_scan_render_fn

    def recording(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    from neuralrecon_w_tpu_torch.config import field_config_from_cfg, load_cfg

    counters = launch_counters()
    pngs, launches = {}, {}
    for d in ("scan", "chunk"):
        out = os.path.join(root, f"render_{tag}{d}")
        reset_counts(counters)
        t0 = time.perf_counter()
        with mock.patch.object(step, "make_scan_render_fn", recording):
            render_cli.main(["--cfg_path", cfg_path, "--ckpt_path", ck, "--out_dir", out,
                             "--img_downscale", str(downscale), "--chunk", str(CHUNK),
                             "--dispatch", d, "--device", device])
        sync()
        wall = time.perf_counter() - t0
        got = read_counts()
        launches[f"render_{tag}{d}"] = scan_launches(got, made[-1]) if d == "scan" else got
        pngs[d] = {n: np.asarray(Image.open(os.path.join(out, n))) for n in sorted(os.listdir(out))}
        print(f"render_cli {tag}--dispatch {d}: {sorted(pngs[d])} in {wall:.2f} s"
              + (f" ({made[-1].captures} capture, {made[-1].replays} replays, a captured chunk "
                 + ", ".join(f"{k} {v}" for k, v in sorted(made[-1].per_chunk_launches.items()))
                 + ")" if d == "scan" else ""))
    same = (sorted(pngs["scan"]) == sorted(pngs["chunk"]) and len(pngs["scan"]) == 3
            and all(np.array_equal(pngs["scan"][n], pngs["chunk"][n]) for n in pngs["chunk"]))
    worst = max((int(np.abs(pngs["scan"][n].astype(int) - pngs["chunk"][n]).max())
                 for n in pngs["chunk"] if n in pngs["scan"]), default=-1)
    print(f"render_cli {tag}scan vs chunk PNGs: max|diff| {worst} levels -> "
          f"{'equal' if same else 'FAIL'}")
    fails = [] if same else [f"render_cli {tag}--dispatch scan differs from chunk "
                             f"({worst} levels)"]
    if device == "cuda":
        if not (made and made[-1].captures == 1 and made[-1].replays > 0):
            fails.append(f"render_cli {tag}--dispatch scan did not replay a captured chunk")
        fails += [f"render_cli {tag}--dispatch scan: {n} not in the captured chunk"
                  for n in serving_kernels(field_config_from_cfg(load_cfg(cfg_path)))
                  if made and made[-1].per_chunk_launches.get(n, 0) <= 0]
    return launches, fails


# ------------------ data preparation, image metrics, debug trace ------------------

# the prep phase: a raw COLMAP layout of PREP_VIEWS views at IMG_WH (the
# view count PR 11's filter cell stands a scene's training images with),
# every PREP_TURN_EVERY-th view turned away from the scene for
# view_selection to drop, PREP_TEST of the kept views held out
PREP_VIEWS, PREP_TURN_EVERY, PREP_TEST, PREP_POINTS = 100, 10, 10, 3000
# image metrics: SSIM and LPIPS (VGG and Alex at full width, init_lpips
# weights) on the card in float32 (TF32 off) against float64 on the CPU,
# on the trainer's rendered test view and METRIC_BATCH seeded images of
# METRIC_WH; relative bounds. SSIM's variances are E[x^2] - E[x]^2, which
# cancels in float32: the CPU's own float32 SSIM lies ~5e-5 off float64 at
# 640x480, so the card's is held within max(SSIM_REL, 2 x that error)
METRIC_BATCH, METRIC_WH = 4, (640, 480)
SSIM_REL, LPIPS_REL = 1e-5, 1e-4
TRACE_RAYS = 1024  # trace_render on the steady frame's first rays


def write_raw_layout(root: str, raw: str, turn_every: int = 0) -> list:
    """A raw COLMAP layout (``raw/sparse/0/*.bin``, ``raw/images/*``) from a
    workspace's ``dense/`` one, as tools/pre_process.py takes it; the views
    whose id is a multiple of ``turn_every`` (0: none) turned to look away
    from the scene (the same centre, the camera's x and z axes flipped).
    Returns the turned views' names, sorted."""
    import numpy as np

    from neuralrecon_w_tpu_torch.datasets import colmap

    sparse = os.path.join(raw, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    for f in os.listdir(os.path.join(root, "dense/sparse")):
        shutil.copy(os.path.join(root, "dense/sparse", f), os.path.join(sparse, f))
    shutil.copytree(os.path.join(root, "dense/images"), os.path.join(raw, "images"),
                    dirs_exist_ok=True)
    images = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    flip = np.diag([-1.0, 1.0, -1.0])
    turned = []
    for im in images.values():
        if turn_every and im.id % turn_every == 0:
            im.qvec = colmap.rotmat2qvec(flip @ im.qvec2rotmat())
            im.tvec = flip @ im.tvec
            turned.append(im.name)
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))
    return sorted(turned)


def prep_phase(root: str, device: str = "cuda", n_views: int = PREP_VIEWS, wh=IMG_WH,
               n_points: int = PREP_POINTS, card: str = "the CPU"):
    """The data-preparation path a user runs from a COLMAP reconstruction:
    a raw layout of ``n_views`` views (``testing.make_synthetic_scene``,
    every PREP_TURN_EVERY-th turned away), then ``pre_process.main``,
    ``prepare_semantic_maps.main --backend constant``,
    ``prepare_data_split.main --num_test PREP_TEST``,
    ``prepare_data_cache.main --no_voxel_filter`` (every pixel a ray, so the
    count is exact; the trainer phase's cache runs the voxel filter) and
    ``phototourism.load_scene_meta``, each timed. Fails unless the tsv lists
    exactly the views ``view_selection`` keeps (PREP_TEST of them 'test', no
    turned one) and the cache holds every pixel of every kept train view
    and no other. Returns (seconds per stage, fails)."""
    import contextlib
    import io

    import numpy as np
    import yaml

    from neuralrecon_w_tpu_torch.datasets.cache import read_ray_cache
    from neuralrecon_w_tpu_torch.datasets.phototourism import load_scene_meta, read_tsv
    from neuralrecon_w_tpu_torch.testing import make_synthetic_scene
    from neuralrecon_w_tpu_torch.tools import pre_process
    from neuralrecon_w_tpu_torch.tools.prepare_data import (
        prepare_data_cache, prepare_data_split, prepare_semantic_maps)
    from neuralrecon_w_tpu_torch.tools.prepare_data.filters import view_selection

    fails, secs = [], {}
    t0 = time.perf_counter()
    made = os.path.join(root, "made")
    make_synthetic_scene(made, n_images=n_views, n_test=1, img_wh=wh, n_points=n_points,
                         seed=SEED)
    raw = os.path.join(root, "scene")
    turned = write_raw_layout(made, raw, PREP_TURN_EVERY)
    secs["raw layout"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        out = pre_process.main(["--src", raw, "--dest", os.path.join(root, "workspaces")])
    secs["pre_process"] = time.perf_counter() - t0
    print(said.getvalue(), end="")
    branch = ("colmap image_undistorter" if pre_process.UNDISTORTED in said.getvalue() else
              "copy (no colmap binary)" if pre_process.COPIED in said.getvalue() else None)
    if branch is None or len(out) != 1:
        fails.append(f"pre_process: undistort branch {branch}, workspaces {out}")
        return secs, fails
    ws = out[0]
    stages = (
        ("prepare_semantic_maps", lambda: prepare_semantic_maps.main(
            ["--root_dir", ws, "--backend", "constant", "--device", device])),
        ("prepare_data_split", lambda: prepare_data_split.main(
            ["--root_dir", ws, "--num_test", str(PREP_TEST)])),
        ("prepare_data_cache", lambda: prepare_data_cache.main(
            ["--root_dir", ws, "--split_to_chunks", "8", "--cache_type", "npz", "--device",
             device, "--no_voxel_filter"])),
        ("load_scene_meta", lambda: load_scene_meta(ws)))
    res = {}
    for name, fn in stages:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # one line per image
            res[name] = fn()
        sync()
        secs[name] = time.perf_counter() - t0
    print(f"prep ({card}): {n_views} views of {wh[0]}x{wh[1]}, undistort branch: {branch}; "
          "seconds " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))

    with open(os.path.join(ws, "config.yaml")) as f:
        sc = yaml.safe_load(f)
    kept = view_selection(ws, sc["origin"], sc["radius"])
    rows = read_tsv(ws)
    n_test = sum(split == "test" for _, split in rows)
    meta = res["load_scene_meta"]
    rays, _ = read_ray_cache(res["prepare_data_cache"])
    want_rays = len(meta.img_ids_train) * wh[0] * wh[1]
    ids = sorted(set(np.unique(rays[:, 8]).astype(int).tolist()))
    print(f"prep: view_selection kept {len(kept)} of {n_views} (turned away: {len(turned)}), "
          f"the tsv {len(rows)} rows ({n_test} test), the cache {len(rays)} rays of "
          f"{len(ids)} views (want {want_rays}), load_scene_meta {len(meta.img_ids_train)} "
          f"train + {len(meta.img_ids_test)} test")
    if sorted(n for n, _ in rows) != kept or set(kept) & set(turned) or n_test != PREP_TEST:
        fails.append(f"prep: the tsv's {len(rows)} views ({n_test} test) are not the "
                     f"{len(kept)} view_selection keeps")
    if len(rays) != want_rays or ids != sorted(meta.img_ids_train):
        fails.append(f"prep: the cache holds {len(rays)} rays of views {ids[:5]}..., not "
                     f"{want_rays} of the {len(meta.img_ids_train)} train views")
    return secs, fails


def metric_images(n: int = METRIC_BATCH, wh=METRIC_WH, seed: int = SEED):
    """(pred, gt), each (n, H, W, 3) float32 in [0, 1]: smooth seeded
    images and a noisy copy of each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w, h = wh
    y, x = np.mgrid[0:h, 0:w] / max(w, h)
    f = rng.uniform(2, 12, (n, 1, 1, 3))
    p = rng.uniform(0, 2 * np.pi, (n, 1, 1, 3))
    gt = 0.5 + 0.4 * np.sin(f * x[None, :, :, None] + p) * np.cos(f * y[None, :, :, None] - p)
    pred = np.clip(gt + 0.05 * rng.standard_normal(gt.shape), 0, 1)
    return pred.astype(np.float32), gt.astype(np.float32)


def conv_flops(model, fn) -> int:
    """The operations of the convolutions ``fn()`` runs in ``model``, 2 a
    multiply-add, counted by forward hooks."""
    import torch

    total = [0]

    def count(m, _, out):
        kh, kw = m.kernel_size
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * kh * kw

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def image_metrics_phase(pairs: dict, device: str = "cuda", card: str = "the CPU",
                        width_mult: float = 1.0):
    """SSIM and LPIPS (VGG and Alex, ``init_lpips`` weights from a seeded
    generator at ``width_mult``) of each named (pred, gt) pair of (N, H, W,
    3) images: on ``device`` in float32 and on the CPU in float64, the
    first held to the second (LPIPS_REL; SSIM within max(SSIM_REL, 2 x
    the CPU's float32 SSIM's own error)); the ms of one call on ``device``
    (SSIM per image, LPIPS per batch) and LPIPS's bound (its convolutions'
    operations at the f32 product peak, ``bound``). Returns fails."""
    import torch

    from neuralrecon_w_tpu_torch.training.lpips import init_lpips, lpips
    from neuralrecon_w_tpu_torch.training.metrics import ssim

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    fails = []
    nets = {net: init_lpips(torch.Generator().manual_seed(SEED), net, width_mult, device="cpu")
            for net in ("vgg", "alex")}
    nets = {net: (copy.deepcopy(m).to(device), m.double()) for net, m in nets.items()}
    for name, (pred, gt) in pairs.items():
        p, g = torch.as_tensor(pred, device=device), torch.as_tensor(gt, device=device)
        p64, g64 = torch.as_tensor(pred).double(), torch.as_tensor(gt).double()
        got, want, ms = {}, {}, {}
        ssim(p[0], g[0])  # warm-up
        vals, ms["ssim"] = timed(lambda: [ssim(p[i], g[i]) for i in range(len(p))])
        got["ssim"] = torch.stack(vals).cpu().double()
        want["ssim"] = torch.stack([ssim(p64[i], g64[i]) for i in range(len(p))])
        cpu32 = torch.stack([ssim(p64[i].float(), g64[i].float()) for i in range(len(p))])
        bounds = {"ssim": max(SSIM_REL, 2 * float((cpu32.double() - want["ssim"]).abs().max()
                                                  / want["ssim"].abs().max()))}
        ms["ssim"] /= len(p)
        lp_bound = {}
        for net, (m, m64) in nets.items():
            flops = conv_flops(m, lambda: lpips(m, p, g))  # and the warm-up
            lp_bound[net] = bound(flops, nbytes(p, g), "float32")["bound_ms"]
            v, ms[f"lpips_{net}"] = timed(lambda: lpips(m, p, g))
            got[f"lpips_{net}"] = v.cpu().double()
            want[f"lpips_{net}"] = lpips(m64, p64, g64)
        errs = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in got}
        print(f"image metrics {name} ({len(p)} x {p.shape[2]}x{p.shape[1]}, {card}): "
              + ", ".join(f"{k} {want[k].mean().item():.6f} rel err {errs[k]:.2e} (bound "
                          f"{bounds.get(k, LPIPS_REL):.1e}) {ms[k]:.2f} ms" for k in got)
              + "; LPIPS bound_ms " + ", ".join(f"{n} {b:.3f}" for n, b in lp_bound.items()))
        bad = [k for k, e in errs.items() if not e <= bounds.get(k, LPIPS_REL)]
        if bad:
            fails.append(f"image metrics {name}: {bad} off float64")
    return fails


def trace_render_check(model, fc, rcfg, scene, rays, fine_grid, sfm_grid, fine_host,
                       out_dir: str, n: int = TRACE_RAYS):
    """``rendering/debug.trace_render`` on the first ``n`` rays of a frame,
    its three PLY dumps written to ``out_dir`` and read back with
    ``utils/ply.read_ply``: every array finite, as many points as
    expected. Returns fails."""
    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.rendering.debug import (
        dump_depth_points_ply, dump_grid_ply, dump_weighted_points_ply, trace_render)
    from neuralrecon_w_tpu_torch.utils.ply import read_ply

    rays = torch.as_tensor(rays[:n], device=scene.origin.device)
    t0 = time.perf_counter()
    tr = trace_render(model, fc, rcfg, scene, rays, torch.zeros(n, dtype=torch.int32),
                      torch.zeros(n, dtype=torch.int32), None, 1.0, fine_grid=fine_grid,
                      sfm_grid=sfm_grid)
    secs = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    depth = tr["render"]["depth"].cpu().numpy()
    paths = {k: os.path.join(out_dir, f"trace_{k}.ply") for k in ("weights", "grid", "depth")}
    # each ray's point at its depth, coloured by its foreground weight sum
    dump_weighted_points_ply(paths["weights"], tr["surface_points_sfm"],
                             tr["render"]["weights_sum"].cpu().numpy())
    dump_grid_ply(paths["grid"], fine_host)
    dump_depth_points_ply(paths["depth"], rays.cpu().numpy(), depth * float(scene.radius))
    want = {"weights": n, "grid": len(fine_host.coords),
            "depth": int((depth > 0).sum())}
    got = {k: read_ply(p) for k, p in paths.items()}
    ok = {k: len(v["verts"]) == want[k] and bool(np.isfinite(v["verts"]).all())
          for k, v in got.items()}
    finite = all(np.isfinite(tr[k]).all() for k in ("weights", "cdf", "surface_points_sfm"))
    print(f"trace_render on {n} steady rays: {secs:.3f} s, weights {tr['weights'].shape}, "
          f"{tr['n_fg_samples']} fg samples, finite {finite}; PLYs read back "
          + ", ".join(f"{k} {len(got[k]['verts'])} points ({'ok' if ok[k] else 'FAIL'})"
                      for k in paths))
    return [] if finite and all(ok.values()) else [f"trace_render: finite {finite}, PLYs {ok}"]


def held_out_view_pair(root: str, device: str = "cuda"):
    """The trainer phase's held-out view through ``render_cli`` (its latest
    checkpoint, full resolution) and its ground-truth image: (pred, gt),
    each (1, H, W, 3) float32 in [0, 1]."""
    import glob

    import numpy as np
    from PIL import Image

    from neuralrecon_w_tpu_torch.datasets.phototourism import load_image, load_scene_meta
    from neuralrecon_w_tpu_torch.tools import render_cli
    from neuralrecon_w_tpu_torch.training.checkpoint import latest_checkpoint

    meta = load_scene_meta(root)
    tid = meta.img_ids_test[0]
    out = os.path.join(root, "render_test")
    render_cli.main(["--cfg_path", os.path.join(root, "train.yaml"), "--ckpt_path",
                     latest_checkpoint(os.path.join(root, "results", "trainer", "checkpoints")),
                     "--out_dir", out, "--img_ids", str(tid), "--img_downscale", "1",
                     "--chunk", str(CHUNK), "--device", device])
    (png,) = [p for p in glob.glob(os.path.join(out, "*.png"))
              if not p.endswith(("_depth.png", "_normal.png"))]
    pred = np.asarray(Image.open(png).convert("RGB"), np.float32) / 255.0
    return pred[None], load_image(meta, tid)[None]


# ----------------------- the reprojection filter (K12) -----------------------

# point-cloud mode at level 12 (the filter's deepest grid) over REPROJ_CAMS
# ring views at IMG_WH; K12 against its plain version on REPROJ_KERNEL_VIEWS
# views' rays (76,800 at 160x120) and at the filter's call shape, the
# filter's keep mask against the plain
# DDA's on REPROJ_PLAIN_VIEWS views; mesh mode over REPROJ_MESH_VIEWS views
# on REPROJ_WORKERS threads; the native rasteriser against the numpy one on
# 2 views of REPROJ_RASTER_FACES seeded faces (the numpy one loops per face)
REPROJ_CAMS, REPROJ_LEVEL, REPROJ_SHELL_POINTS = 100, 12, 1 << 20
REPROJ_KERNEL_VIEWS, REPROJ_PLAIN_VIEWS, REPROJ_MESH_VIEWS = 4, 4, 8
# K12 also at the filter's call shape: its first FILTER_CALL_RAYS pixel rays
# (render_hit_codes_multi's chunk) of FILTER_CALL_VIEWS views
FILTER_CALL_RAYS, FILTER_CALL_VIEWS = 262144, 14
REPROJ_WORKERS, REPROJ_RASTER_FACES = 8, 10000
REPROJ_CAM_DIST = 2.5  # camera distance, in the cloud's bounding radii
# tests/test_ops.py:141-143's tolerance on near / far, SFM units; the
# rasterisers' disagreement bound, tests/test_extraction_eval.py:285
HIER_RTOL, HIER_ATOL, RASTER_DIFF = 1e-3, 1e-4, 1e-4
MAX_DIFFER = 2000  # rays held to the exact first hit, one brute-force pass each
# float32 operations of K12: a ray's set-up, a step's probe, lookup and exit
K12_RAY_OPS, K12_TRIP_OPS = 30, 40


def filter_cameras(root: str, center, dist: float, n: int, wh=IMG_WH) -> list:
    """n ring cameras at ``dist`` from ``center`` (heights varying, each
    looking at the centre), written into the workspace as COLMAP
    cameras.bin / images.bin (PINHOLE, focal 1.2 w) and a split table of
    training views. Returns [(K, c2w, (w, h))] as load_scene_meta reads them."""
    import numpy as np

    from neuralrecon_w_tpu_torch.datasets.colmap import (Camera, Image, rotmat2qvec,
                                                         write_cameras_binary,
                                                         write_images_binary)

    w, h = wh
    f = 1.2 * w
    sparse = os.path.join(root, "dense", "sparse")
    os.makedirs(sparse, exist_ok=True)
    write_cameras_binary({1: Camera(1, "PINHOLE", w, h, np.array([f, f, w / 2, h / 2]))},
                         os.path.join(sparse, "cameras.bin"))
    center = np.asarray(center, np.float64)
    images, cams = {}, []
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = center + dist * np.array([np.cos(ang), np.sin(ang), 0.4 * np.sin(3 * ang)])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])  # COLMAP world -> camera: x right, y down, z forward
        t = -R @ eye
        images[i + 1] = Image(i + 1, rotmat2qvec(R), t, 1, f"view_{i:04d}.png",
                              np.zeros((0, 2)), np.zeros(0, np.int64))
        c2w = np.concatenate([R.T, eye[:, None]], axis=1)
        c2w[:, 1:3] *= -1  # right-up-back
        cams.append((K, c2w, (w, h)))
    write_images_binary(images, os.path.join(sparse, "images.bin"))
    with open(os.path.join(root, "views.tsv"), "w") as fh:
        fh.write("filename\tid\tsplit\tdataset\n")
        for i in range(n):
            fh.write(f"view_{i:04d}.png\t{i}\ttrain\tsynthetic\n")
    return cams


def cloud_rays(cams, grid, dev):
    """The views' pixel rays in ``grid``'s normalised coordinates, float32 on dev."""
    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.datasets.rays import get_ray_directions, get_rays

    o, d = [], []
    for K, c2w, (w, h) in cams:
        ro, rd = get_rays(get_ray_directions(h, w, K), c2w)
        o.append((ro - grid.origin) / grid.scale)
        d.append(rd)
    return (torch.as_tensor(np.concatenate(o), dtype=torch.float32, device=dev),
            torch.as_tensor(np.concatenate(d), dtype=torch.float32, device=dev))


def level_voxel(verts, level: int) -> float:
    """A voxel size that voxelize_points quantises at exactly ``level``."""
    import numpy as np

    scale = float(np.max(verts.max(0) - verts.min(0)) / 2 * 1.01 + 1e-6)
    return 2.0 * scale / (1 << level) / 1.25


def k12_split(hg, touched, steps) -> dict:
    """A K12 run's steps split as the plain version's touched counts read it
    (fine steps: those inside an occupied block, one fine word each; block
    steps: the rest), the distinct occupied blocks entered and the distinct
    meta rows and fine words read."""
    fine = int(touched[1].sum())
    return {"block_steps": int(steps) - fine, "fine_steps": fine,
            "blocks_entered": int((touched[1].view(-1, 16) > 0).any(1).sum()),
            "meta_rows": int((touched[0] > 0).sum()), "fine_words": int((touched[1] > 0).sum())}


def k12_kernel_check(hg, level: int, cases: dict, card: str):
    """K12 against dda_traverse_hier_plain on each case's rays (label ->
    (o, d)), both first_only modes, torch.equal on every output and each
    ray's steps; each case's step split (``k12_split``) and reads
    (``global_reads``) printed; the filter's query (first_only) timed in
    turns with the plain version, its bound from this run's steps and
    distinct words. Returns (entry, fails): the first case's numbers, every
    case's under "cases"."""
    import torch

    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    fails, entry = [], {"cases": {}}
    for label, (o, d) in cases.items():
        dev = o.device
        r = o.shape[0]
        for first in (False, True):
            trips = torch.empty(r, dtype=torch.int32, device=dev)
            touched = (torch.zeros(hg.meta.shape[0], dtype=torch.int32, device=dev),
                       torch.zeros_like(hg.fine))
            steps, reads = (torch.zeros(r, dtype=torch.int32, device=dev) for _ in range(2))
            got = rv.dda_traverse_hier(hg, level, o, d, first, steps_out=trips)
            sync()
            t0 = time.perf_counter()
            want = rv.dda_traverse_hier_plain(hg, level, o, d, first, touched=touched,
                                              steps_out=steps, global_reads=reads)
            sync()
            plain_s = time.perf_counter() - t0
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            n_trips = float(touched[0].double().sum())
            if not torch.equal(trips, steps):
                fails.append(f"K12 {label} first_only={first}: the kernel's steps differ from "
                             f"the plain version's on {int((trips != steps).sum())} rays")
            split = k12_split(hg, touched, n_trips)
            n_reads = float(reads.double().sum())
            print(f"K12 dda_hier level {level} {label} first_only={first} on {r} rays: "
                  f"{int(got[2].sum())} hit, mean {n_trips / r:.1f} steps ({split['block_steps']} "
                  f"block, {split['fine_steps']} fine), {split['blocks_entered']} distinct "
                  f"occupied blocks entered, {n_reads / r:.2f} reads a ray; "
                  f"{split['meta_rows']} distinct meta rows of {hg.meta.shape[0]}, "
                  f"{split['fine_words']} fine words of {hg.fine.numel()}; torch.equal "
                  f"{equal} -> {'ok' if equal else 'FAIL'}")
            if not equal:
                fails.append(f"K12 {label} first_only={first}")
            if first:
                b = bound(r * K12_RAY_OPS + n_trips * K12_TRIP_OPS,
                          r * (24 + 4 + 4 + 1) + 8 * split["meta_rows"] + 4 * split["fine_words"],
                          "simt")
                case = {"rays": r, "level": level, "mean_steps": n_trips / r,
                        "reads_per_ray": n_reads / r, **split, "max_abs_err": err, **b}
                if dev.type == "cuda":
                    # the plain version's one timed run (a second of launches) is
                    # its time; the kernel's, CUDA events over 5 launches
                    ms, plain_ms = cuda_ms(lambda: rv.dda_traverse_hier(hg, level, o, d, True)), \
                        plain_s * 1e3
                    case.update(ms=ms, plain_ms=plain_ms, library_ms=None)
                    print(f"K12 (redesigned) dda_hier level {level} {label} first_only "
                          f"({card}): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
                entry["cases"][label] = case
                if len(entry) == 1:  # the first case's numbers are the entry's own
                    entry.update(case)
    return entry, fails


def filter_call_rays(cams, grid, dev, n: int = FILTER_CALL_RAYS, views: int = FILTER_CALL_VIEWS):
    """One reprojection-filter DDA call's rays: the first n pixel rays of
    ``views`` views, as render_hit_codes_multi packs them."""
    o, d = cloud_rays(cams[:views], grid, dev)
    if o.shape[0] < n:
        raise ValueError(f"{views} views hold {o.shape[0]} rays, fewer than {n}")
    return o[:n].contiguous(), d[:n].contiguous()


def exact_first(lo, hi, o, d):
    """The exact first hit of the ray o + s d (float64, normalised
    coordinates) over cell boxes [lo, hi] (M, 3): (hit, the entry s of the
    first cell, that cell's chord, |d| along the axis it leaves the cell
    by), by every box's slabs (``ray_voxel.brute_force_near_far``'s
    oracle, one ray)."""
    import numpy as np

    d = np.where(np.abs(d) < 1e-12, 1e-12, d)
    t0, t1 = (lo - o) / d, (hi - o) / d
    far = np.maximum(t0, t1)
    tn, tf = np.minimum(t0, t1).max(1), far.min(1)
    ok = (tf >= tn) & (tf > 0)
    if not ok.any():
        return False, 0.0, 0.0, 1.0
    k = np.flatnonzero(ok)[np.argmin(np.maximum(tn[ok], 0.0))]
    return (True, max(float(tn[k]), 0.0), float(tf[k] - max(tn[k], 0.0)),
            float(abs(d[np.argmin(far[k])])))


def near_answers(lo, hi, o, d, delta: float):
    """``exact_first`` of the ray and of the rays shifted by delta along
    each axis and each diagonal: what a march that resolves positions only
    to delta can rightly answer. The boxes the ray passes within 2 delta of
    are found in one pass over all of them."""
    import numpy as np

    dd = np.where(np.abs(d) < 1e-12, 1e-12, d)
    t0, t1 = (lo - 2 * delta - o) / dd, (hi + 2 * delta - o) / dd
    near = (np.maximum(t0, t1).min(1) >= np.minimum(t0, t1).max(1))
    lo, hi = lo[near], hi[near]
    shifts = [np.zeros(3)] + [delta * v for v in np.concatenate(
        [np.eye(3), -np.eye(3), np.stack(np.meshgrid(*[[-1.0, 1.0]] * 3), -1).reshape(-1, 3)])]
    return [exact_first(lo, hi, o + sh, d) if len(lo) else (False, 0.0, 0.0, 1.0)
            for sh in shifts]


def k12_vs_k10(grid, cams, dev):
    """K12 and K10 on the same host grid (a two-level and a flat copy)
    over the views' rays: hit and first hit (near, within
    tests/test_ops.py's tolerance in SFM units); far's outliers reported.
    The two marches differ at cell corners and edges: the flat one sums
    float32 cell crossings along the ray (its t drifts by a few ulps a
    step, so near a corner it can take the wrong axis), the two-level one
    recomputes each exit from the cell but probes a nudge eps = 2^{1-L}
    1e-3 / max|d| past each entry, in float32: it steps over a cell the ray
    crosses for less than eps (plus the probe's rounding, 2^-22 (max|o| +
    s) over |d| along the cell's exit axis), and resolves the ray's position
    only to delta = 2^{1-L} 1e-3 + 2^-22 (max|o| + s). So every ray on which
    they differ is held to the exact float64 first hit (``exact_first``):
    K12's answer must be the exact one, or the exact first cell such a
    graze, or the exact answer of the ray shifted by delta along an axis or
    a diagonal (``near_answers``); else the check fails. Returns fails."""
    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv

    flat, hg = rv.device_grid_from_host(grid, dev), rv.hier_grid_from_host(grid, dev)
    o, d = cloud_rays(cams, grid, dev)
    w = 2.0 / grid.res
    lo = grid.coords.astype(np.float64) * w - 1.0
    hi = lo + w
    answers = {}  # ray -> near_answers, shared by the two modes
    fails = []
    for first in (True, False):
        # t in normalised units; the tolerance is on near / far in SFM units
        a = rv.dda_traverse(flat.occ, grid.level, o, d, first)
        b = rv.dda_traverse_hier(hg, grid.level, o, d, first)
        v = a[2] & b[2]
        tol = lambda x: (HIER_ATOL + HIER_RTOL * x.abs() * grid.scale) / grid.scale  # noqa: E731
        near_off = v & ((a[0] - b[0]).abs() > tol(a[0]))
        far_out = int(((a[1] - b[1]).abs() > tol(a[1]))[v].sum())
        differ = torch.nonzero((a[2] != b[2]) | near_off)[:, 0].cpu().numpy()
        on, dn = o.double().cpu().numpy(), d.double().cpu().numpy()
        ta, tb = a[0].double().cpu().numpy(), b[0].double().cpu().numpy()
        ha, hb = a[2].cpu().numpy(), b[2].cpu().numpy()

        def agrees(hit, t, got_hit, got_t):
            tol_i = (HIER_ATOL + HIER_RTOL * abs(t) * grid.scale) / grid.scale
            return got_hit == hit and (not hit or abs(got_t - t) <= tol_i)

        k12_exact = k10_exact = grazes = within = bad = 0
        for i in differ[:MAX_DIFFER]:
            rounding = 2.0 ** -22 * (np.abs(on[i]).max() + max(ta[i], tb[i]))
            if i not in answers:
                answers[i] = near_answers(lo, hi, on[i], dn[i], w * 1e-3 + rounding)
            (hit, t, chord, d_exit), shifted = answers[i][0], answers[i][1:]
            k10_exact += int(agrees(hit, t, ha[i], ta[i]))
            if agrees(hit, t, hb[i], tb[i]):
                k12_exact += 1
            elif hit and chord < w * 1e-3 / np.abs(dn[i]).max() + rounding / d_exit:
                grazes += 1
            elif any(agrees(h, s_, hb[i], tb[i]) for h, s_, _, _ in shifted):
                within += 1
            else:
                bad += 1
                print(f"  ray {i}: exact hit {hit} at {t:.7f}; K12 {bool(hb[i])} at "
                      f"{tb[i]:.7f}; K10 {bool(ha[i])} at {ta[i]:.7f}; shifted "
                      f"{[(bool(h), round(s_, 7)) for h, s_, _, _ in shifted]}; o {on[i].tolist()}, "
                      f"d {dn[i].tolist()}")
        bad += max(len(differ) - MAX_DIFFER, 0)
        print(f"K12 vs K10 at level {grid.level}, first_only={first}, {o.shape[0]} rays: "
              f"{int(a[2].sum())} / {int(b[2].sum())} hit; {len(differ)} differ in hit or near "
              f"(beyond {HIER_RTOL} rel + {HIER_ATOL} SFM units); against the exact float64 "
              f"first hit K12 matches {k12_exact}, K10 {k10_exact}; {grazes} first cells "
              f"crossed for under K12's nudge, K12 matches a ray shifted by its nudge and "
              f"rounding on {within}, {bad} else; far outside {far_out} "
              f"(reported) -> " + ("ok" if not bad else "FAIL"))
        if bad:
            fails.append(f"K12 vs K10 level {grid.level} first_only={first}: {bad} rays")
    return fails


def filter_setup(root: str, ply_path: str, dev, level: int = REPROJ_LEVEL,
                 n_cams: int = REPROJ_CAMS, wh=IMG_WH, shell_points: int = REPROJ_SHELL_POINTS):
    """The reprojection filter's inputs from a mesh: its vertices as the point
    cloud (or, where fewer, a seeded shell of shell_points points around
    them), written as ``cloud.ply`` into root; n_cams ring views written into
    root (``filter_cameras``); the cloud voxelised at ``level`` and its
    two-level grid on dev. Returns (verts, faces, the mesh's reach from its
    centre, cloud, cloud_ply, cams, voxel, grid, hg, (t0, t1, t2): the clock
    before voxelising, after it and after the grid's upload)."""
    import numpy as np

    from neuralrecon_w_tpu_torch.evaluation import reproj_filter as rf
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv
    from neuralrecon_w_tpu_torch.utils.ply import read_ply, write_ply

    mesh = read_ply(ply_path)
    verts, faces = mesh["verts"], mesh["faces"]
    center = (verts.max(0) + verts.min(0)) / 2
    reach = float(np.linalg.norm(verts - center, axis=1).max())
    cloud = verts
    if len(verts) < shell_points:  # a shell around the mesh: tests/test_ops.py:168
        v = np.random.default_rng(SEED).standard_normal((shell_points, 3))
        cloud = center + v / np.linalg.norm(v, axis=1, keepdims=True) * (0.9 * reach)
    cloud_ply = os.path.join(root, "cloud.ply")
    write_ply(cloud_ply, cloud)
    cams = filter_cameras(root, center, REPROJ_CAM_DIST * reach, n_cams, wh)
    voxel = level_voxel(cloud, level)
    t0 = time.perf_counter()
    grid = rf.voxelize_points(cloud, voxel)
    t1 = time.perf_counter()
    hg = rv.hier_grid_from_host(grid, dev)
    sync()
    return (verts, faces, reach, cloud, cloud_ply, cams, voxel, grid, hg,
            (t0, t1, time.perf_counter()))


def reproj_filter_phase(root: str, ply_path: str, card: str = "the CPU",
                        level: int = REPROJ_LEVEL, n_cams: int = REPROJ_CAMS, wh=IMG_WH,
                        shell_points: int = REPROJ_SHELL_POINTS):
    """The geometry-evaluation path on the extraction phase's mesh and
    workspace: n_cams ring views written into the workspace; the mesh's
    vertices (or, where fewer, a shell of shell_points points around them)
    as a point cloud, voxelised at ``level`` into a two-level grid (its
    bytes against a flat grid's); K12 against its plain version and against
    K10 at level 10; ``reproj_filter_cli`` in point-cloud mode over every
    view with the launch counts set to 0 just before and read just after;
    its keep mask on REPROJ_PLAIN_VIEWS views against the plain DDA's; mesh
    mode over REPROJ_MESH_VIEWS views; the native rasteriser against the
    numpy one. Returns (K12's entry, launches, fails)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from neuralrecon_w_tpu_torch.evaluation import reproj_filter as rf
    from neuralrecon_w_tpu_torch.ops import ray_voxel as rv
    from neuralrecon_w_tpu_torch.ops.native import rasterize_depth_native
    from neuralrecon_w_tpu_torch.ops.voxel_grid import VoxelGrid, _sort_coords
    from neuralrecon_w_tpu_torch.tools import reproj_filter_cli
    from neuralrecon_w_tpu_torch.utils.ply import read_ply

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    fails = []
    verts, faces, reach, cloud, cloud_ply, cams, voxel, grid, hg, (t0, t1, t2) = filter_setup(
        root, ply_path, dev, level, n_cams, wh, shell_points)
    hier_bytes = (hg.meta.numel() + hg.fine.numel()) * 4
    flat_bytes = (1 << (3 * grid.level)) // 8
    print(f"reprojection filter: {len(cloud)} points ({'the mesh vertices' if cloud is verts else 'a shell'}"
          f", mesh {len(verts)} vertices / {len(faces)} faces), level {grid.level} "
          f"({len(grid.coords)} cells, voxelised in {t1 - t0:.2f} s); two-level grid meta "
          f"{hg.meta.numel() * 4} + fine {hg.fine.numel() * 4} = {hier_bytes} bytes against "
          f"{flat_bytes} flat ({flat_bytes / 2**30:.1f} GiB), built in {t2 - t1:.2f} s; "
          f"{n_cams} views of {wh[0]}x{wh[1]}")
    if grid.level != level:
        fails.append(f"the filter's grid is level {grid.level}, not {level}")

    o, d = cloud_rays(cams[:REPROJ_KERNEL_VIEWS], grid, dev)
    cases = {f"{REPROJ_KERNEL_VIEWS} views": (o, d)}
    if len(cams) >= FILTER_CALL_VIEWS:
        cases["filter call"] = filter_call_rays(cams, grid, dev)
    entry, kfails = k12_kernel_check(hg, grid.level, cases, card)
    fails += kfails
    del cases
    entry.update(hier_bytes=hier_bytes, flat_bytes=flat_bytes)
    # the same cells at level 10 (a level-12 index >> 2 is the level-10 one):
    # a grid both K10 and K12 can hold
    coarse = min(10, grid.level)
    grid10 = VoxelGrid(coarse, grid.origin, grid.scale,
                       _sort_coords(grid.coords >> (grid.level - coarse), coarse))
    fails += k12_vs_k10(grid10, cams[:REPROJ_KERNEL_VIEWS], dev)
    del o, d, grid10

    # point-cloud mode through the CLI, every view
    counters = launch_counters()
    reset_counts(counters)
    buf = io.StringIO()
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = reproj_filter_cli.main(["--src_file", cloud_ply, "--root_dir", root,
                                      "--img_downscale", "1", "--voxel_size", repr(voxel),
                                      "--out_dir", os.path.join(root, "filtered"),
                                      "--device", dev.type])
    sync()
    wall = time.perf_counter() - t0
    launches = read_counts()
    text = buf.getvalue()
    print(text.strip())
    stats = json.loads(next(ln for ln in text.splitlines() if ln.startswith("stages "))[7:])
    kept = read_ply(out)["verts"]
    rate = stats["dda_rays"] / stats["dda_s"]
    print(f"reproj_filter_cli point-cloud mode ({card}): {wall:.2f} s for {n_cams} views, kept "
          f"{len(kept)} of {len(cloud)}; DDA {stats['dda_calls']} calls, {stats['dda_rays']} rays "
          f"in {stats['dda_s']:.3f} s ({rate:.4g} rays/s), host rays {stats['rays_s']:.3f} s, "
          f"quantisation {stats['quantise_s']:.3f} s, np.isin {stats['isin_s']:.3f} s, voxelise "
          f"{stats['voxelize_s']:.3f} s, grid {stats['grid_s']:.3f} s; launches dda_hier "
          f"{launches['dda_hier']}")
    entry["filter"] = {"seconds": wall, "views": n_cams, "kept": len(kept), "points": len(cloud),
                       "dda_rays_per_s": rate, **stats}
    if not 0 < len(kept) < len(cloud) or not np.isfinite(kept).all():
        fails.append(f"the filter kept {len(kept)} of {len(cloud)}")
    if dev.type == "cuda" and launches["dda_hier"] != stats["dda_calls"]:
        fails.append(f"K12 launched {launches['dda_hier']} times for {stats['dda_calls']} calls")

    # the keep mask on a few views against the plain DDA's, on the phase's
    # grid (the filter's own for the same cloud and voxel size)
    sub = cams[:REPROJ_PLAIN_VIEWS]

    def plain_traverse(g, lv, oo, dd, first_only=False, max_steps=None):
        if isinstance(g, rv.HierGrid):
            return rv.dda_traverse_hier_plain(g, lv, oo, dd, first_only, max_steps)
        return rv.dda_traverse_plain(g.occ, lv, oo, dd, first_only, max_steps)

    vcodes = rf.vertex_voxel_codes(grid, cloud)
    n_sub = sum(w_ * h_ for _, _, (w_, h_) in sub)  # one call, no padded rays
    m_kernel = np.isin(vcodes, rf.render_hit_codes_multi(hg, grid, sub, n_sub))
    with mock.patch.object(rf, "traverse", plain_traverse):
        m_plain = np.isin(vcodes, rf.render_hit_codes_multi(hg, grid, sub, n_sub))
    same = np.array_equal(m_kernel, m_plain)
    print(f"filter keep mask on {len(sub)} views, K12 vs the plain DDA: {int(m_kernel.sum())} / "
          f"{int(m_plain.sum())} kept -> {'equal' if same else 'FAIL'}")
    if not same:
        fails.append("the filter's keep mask differs from the plain DDA's")

    # mesh mode on the extracted mesh; the rasterisers on 2 views
    stats = {}
    t0 = time.perf_counter()
    mv = cams[:REPROJ_MESH_VIEWS]
    kv, kf, km = rf.reprojection_filter(verts, faces, mv, 2.0 * reach / 1024, workers=REPROJ_WORKERS,
                                        stats=stats)
    wall = time.perf_counter() - t0
    print(f"mesh mode on the extracted mesh, {len(mv)} views on {REPROJ_WORKERS} threads: "
          f"{wall:.2f} s, kept {int(km.sum())} of {len(verts)} vertices, {len(kf)} faces; raster "
          f"{stats.get('raster_s', 0.0) / len(mv):.3f} s a view (summed over threads), KD match "
          f"{stats.get('match_s', 0.0) / len(mv):.3f} s a view, tree {stats.get('tree_s', 0.0):.2f} s")
    entry["mesh_mode"] = {"seconds": wall, "views": len(mv), "kept": int(km.sum()),
                          "raster_s_per_view": stats.get("raster_s", 0.0) / len(mv)}
    if not 0 < km.sum() or (len(kf) and kf.max() >= len(kv)):
        fails.append("mesh mode kept nothing or remapped faces out of range")
    centroids = verts[faces].mean(axis=1)
    for K, c2w, (w, h) in cams[:2]:
        # the faces nearest the camera: a patch of the surface it faces
        near = np.linalg.norm(centroids - c2w[:, 3], axis=1)
        pick = np.argsort(near)[:REPROJ_RASTER_FACES]
        t0 = time.perf_counter()
        a = rasterize_depth_native(verts, faces[pick], c2w, K, w, h)
        t1 = time.perf_counter()
        b = rf._rasterize_depth_numpy(verts, faces[pick], c2w, K, w, h)
        t2 = time.perf_counter()
        bad = int((np.abs(a - b) > RASTER_DIFF).sum())
        ok = bad <= max(3, int(0.002 * a.size)) and int(((a > 0) & (b > 0)).sum()) > 20
        print(f"native vs numpy rasteriser, {len(pick)} faces at {w}x{h}: {int((a > 0).sum())} "
              f"pixels hit, {bad} differ beyond {RASTER_DIFF}; native {t1 - t0:.3f} s, numpy "
              f"{t2 - t1:.3f} s -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"native rasteriser against numpy: {bad} pixels")
    return entry, launches, fails


REDESIGNED = (("K2", "up_sample_kernel"), ("K3", "sdf_vjp_fwd_kernel"),
              ("K4", "sdf_vjp_bwd_kernel"), ("K6", "field_fwd_kernel"), ("K7", "field_bwd_kernel"),
              ("K8", "bg_fwd_kernel"), ("K9", "bg_bwd_kernel"), ("K10", "dda_kernel"),
              ("K10's pre-pass", "coarse_kernel"), ("K11", "sampled_hit_kernel"),
              ("K12", "dda_hier_kernel"))


def ptxas_report(log: str) -> list:
    """One line per kernel instantiation of the build's ``-Xptxas -v``
    output: registers, stack frame and spills, the redesigned kernels
    (REDESIGNED) marked."""
    import re

    out, name = [], None
    props = {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            props[name] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stack, st, ld = props.get(name, ("?", "?", "?"))
            kern = re.search(r"([a-z][a-z_]*_kernel)I?(13__nv_bfloat16|f)?", name)
            base = kern.group(1) if kern else name
            dtype = {"13__nv_bfloat16": "bf16", "f": "float"}.get(kern.group(2) if kern else "", "")
            if base == "dda_hier_kernel":
                dtype = "masked" if "ILb1E" in name else "unmasked"
            per_lane = re.search(r"up_sample_kernelILi(\d+)E", name)  # K2's samples a lane
            if per_lane:
                dtype = f"V={per_lane.group(1)}"
            lab = next((lab for lab, k in REDESIGNED if k == base), None)
            if lab and "coarse_kernelILi2E" in name:  # the pre-pass over meta's rows
                lab = "K12's pre-pass"
            mark = f"{lab} (redesigned) " if lab else ""
            out.append(f"{mark}{base}<{dtype}>: {m.group(1)} registers, {stack} bytes stack frame, "
                       f"{st} bytes spill stores, {ld} bytes spill loads")
            name = None
    return out


class PhaseClock:
    """The wall seconds of the run's phases, in order: ``lap(name)`` closes
    the phase that ran since the last lap (or the clock's start); ``line()``
    prints them with their sum."""

    def __init__(self):
        self.t, self.walls = time.perf_counter(), {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.walls[name] = self.walls.get(name, 0.0) + now - self.t
        self.t = now

    def line(self) -> str:
        return ("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in self.walls.items())
                + f"; total {sum(self.walls.values()):.1f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="time one chunk per serving phase plain / kernels and profile "
                        "it, and profile one training step per phase and grad mode")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from neuralrecon_w_tpu_torch.config import (
        field_config_from_cfg, load_cfg, render_config_from_cfg)
    from neuralrecon_w_tpu_torch.ops import build, native
    from neuralrecon_w_tpu_torch.ops.importance_sampler import up_sample_round
    from neuralrecon_w_tpu_torch.ops.ray_voxel import (
        dda_traverse, device_grid_from_host, sampled_first_hit)
    from neuralrecon_w_tpu_torch.ops.sdf_mlp import fused_sdf_head
    from neuralrecon_w_tpu_torch.datasets.cache import DeviceRayPool, RayPool
    from neuralrecon_w_tpu_torch.ops.field_forward import fused_field_forward
    from neuralrecon_w_tpu_torch.ops.nerf_bg_fused import nerf_bg_fwd
    from neuralrecon_w_tpu_torch.rendering.renderer import bg_eval_idx
    from neuralrecon_w_tpu_torch.tools.convert import init_field
    from neuralrecon_w_tpu_torch.training.schedule import make_optimizer
    from neuralrecon_w_tpu_torch.training.step import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    clock = PhaseClock()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    path, secs, log = build.build()
    import re

    print(f"built {os.path.relpath(path, ROOT)} in {secs:.1f} s (by source: " + ", ".join(
        f"{src} {t} s" for src, t in re.findall(r"^nvcc (\S+): ([\d.]+) s$", log, re.M)) + ")")
    for line in ptxas_report(log):
        print("  ptxas:", line)
    build.kernels()
    t0 = time.perf_counter()
    print(f"built {os.path.relpath(native.build(), ROOT)} (the host mesher) in "
          f"{time.perf_counter() - t0:.1f} s")
    clock.lap("build")

    cfg = load_cfg(CONFIG)
    fc = field_config_from_cfg(cfg)
    model = init_field(fc, torch.Generator().manual_seed(SEED), dev).eval().requires_grad_(False)

    t0 = time.perf_counter()
    scene, sfm_host, fine_host, frames = make_scene(dev)
    sfm_grid = device_grid_from_host(sfm_host, dev)
    fine_grid = device_grid_from_host(fine_host, dev)
    print(f"scene: SFM grid level {sfm_host.level} ({len(sfm_host.coords)} cells), fine grid "
          f"level {fine_host.level} ({len(fine_host.coords)} cells), {len(frames)} frames of "
          f"{IMG_WH[0]}x{IMG_WH[1]}; made in {time.perf_counter() - t0:.1f} s")
    rcfg_warm = render_config_from_cfg(cfg, sfm_level=sfm_host.level, fine_level=-1,
                                       nerf_far_override=True)
    rcfg_steady = rcfg_warm._replace(fine_level=fine_host.level)
    print(f"model: act {fc.act_dtype}, SDF {dict(fc.sdf)['n_layers']}x{dict(fc.sdf)['d_hidden']}; "
          f"sampler fused={rcfg_warm.fused_sampler_sdf}, n_samples {rcfg_warm.n_samples} + "
          f"{rcfg_warm.n_importance} in {rcfg_warm.up_sample_steps} rounds, boundary "
          f"{rcfg_warm.boundary_samples}, bg {rcfg_warm.n_outside} / bg_samples {rcfg_warm.bg_samples}")

    # kernel phase on the first chunk's rays, at the sampler's base z
    from neuralrecon_w_tpu_torch.rendering.renderer import near_far_from_sfm_grid

    rays = torch.as_tensor(frames[0][:CHUNK], device=dev)
    rays_o = (rays[:, :3] - scene.origin) / scene.radius
    near, far, _ = near_far_from_sfm_grid(rcfg_warm, scene, sfm_grid, rays_o, rays[:, 3:6],
                                          rays[:, 6:7] / scene.radius, rays[:, 7:8] / scene.radius)
    z_base = near + (far - near) * torch.linspace(0, 1, 8, device=dev)[None, :]
    kres, fails = kernel_phase(model, fc, rays_o, rays[:, 3:6].contiguous(), z_base.contiguous(),
                               CHUNK * 30)
    rres, rfails = ray_kernel_phase(scene, sfm_grid, sfm_host.level, fine_grid, fine_host, frames,
                                    rcfg_steady)
    kres.update(rres)
    fails += rfails
    clock.lap("kernel checks")

    # serving: launches are counted from here on
    serve_k = {"sdf_mlp": fused_sdf_head, "up_sample": up_sample_round, "dda": dda_traverse,
               "sampled_hit": sampled_first_hit}
    for k in serve_k.values():
        k.launches = 0
    rps_warm, outs_warm = serving_phase(model, fc, rcfg_warm, scene, frames, None, sfm_grid,
                                        "warm-up")
    launches_warm = {n: k.launches for n, k in serve_k.items()}
    rps_steady, outs_steady = serving_phase(model, fc, rcfg_steady, scene, frames, fine_grid,
                                            sfm_grid, "steady")
    launches = {n: k.launches for n, k in serve_k.items()}
    print("launches in serving: " + ", ".join(
        f"{n} {launches[n]} (warm-up {launches_warm[n]})" for n in serve_k))
    # K10 serves the SFM near / far in both phases; K11 the steady fine-grid query
    for name in ("sdf_mlp", "up_sample", "dda"):
        if launches_warm[name] <= 0 or launches[name] <= launches_warm[name]:
            fails.append(f"{name} not launched in every serving phase")
    if launches_warm["sampled_hit"] or launches["sampled_hit"] <= 0:
        fails.append(f"sampled_hit launched {launches_warm['sampled_hit']} / "
                     f"{launches['sampled_hit']} times in the warm-up / steady serving")
    fails += check_frames(outs_warm, frames, "warm-up")
    fails += check_frames(outs_steady, frames, "steady")
    fails += path_check(model, fc, rcfg_warm, scene, frames[1], None, sfm_grid, "warm-up")
    fails += path_check(model, fc, rcfg_steady, scene, frames[1], fine_grid, sfm_grid, "steady")
    # one frame per serving phase with SDF_GRAD_MODE 'pallas_field' and
    # FUSED_BG: K6 and K8 serve the field and the background
    fc_fused = train_config(cfg, "pallas_field")
    serve_fused = {"field_fwd": 0, "nerf_bg_fwd": 0}
    for label, rc, fg in (("warm-up", rcfg_warm, None), ("steady", rcfg_steady, fine_grid)):
        fused_field_forward.launches = nerf_bg_fwd.launches = 0
        _, outs = serving_phase(model, fc_fused, rc, scene, frames[:2], fg, sfm_grid,
                                f"{label} pallas_field + FUSED_BG")
        got = {"field_fwd": fused_field_forward.launches, "nerf_bg_fwd": nerf_bg_fwd.launches}
        print(f"launches serving one {label} frame with pallas_field + FUSED_BG: " + ", ".join(
            f"{n} {v}" for n, v in got.items()))
        for n, v in got.items():
            serve_fused[n] += v
            if v <= 0:
                fails.append(f"{n} not launched serving {label} with pallas_field + FUSED_BG")
        fails += check_frames(outs, frames[:2], f"{label} pallas_field + FUSED_BG")
        fails += path_check(model, fc_fused, rc, scene, frames[1], fg, sfm_grid,
                            f"{label} pallas_field + FUSED_BG", ref_fc=fc)
    # the served frame as one graph (make_scan_render_fn), in turns with the
    # eager chunks, both phases; its launches are a captured chunk's times
    # the replays (the wrappers count at capture only)
    serve_graph, rps_graph = {}, {}
    for label, rc, fg in (("warm-up", rcfg_warm, None), ("steady", rcfg_steady, fine_grid)):
        rps_graph[label], got, gfails = serving_graph_phase(model, fc, rc, scene, frames, fg,
                                                            sfm_grid, label, args.profile)
        fails += gfails
        for n, v in got.items():
            serve_graph[n] = serve_graph.get(n, 0) + v
    clock.lap("serving")
    # the kernel modes' served frames as one graph: 'pallas' (K3) and
    # 'pallas_field' with FUSED_BG (K6, K8), both phases, each frame held to
    # the eager one bit for bit
    serve_graph_k, rps_graph_k = {}, {}
    for mode in ("pallas", "pallas_field"):
        for label, rc, fg in (("warm-up", rcfg_warm, None), ("steady", rcfg_steady, fine_grid)):
            rps_graph_k[f"{label} {mode}"], got, gfails = serving_graph_phase(
                model, train_config(cfg, mode), rc, scene, frames, fg, sfm_grid,
                f"{label} {mode}" + (" + FUSED_BG" if mode == "pallas_field" else ""),
                args.profile)
            fails += gfails
            for n, v in got.items():
                serve_graph_k[n] = serve_graph_k.get(n, 0) + v
    clock.lap("serving graphs, kernel modes")
    # the render debug trace on the steady frame's first rays, its PLYs in build/
    fails += trace_render_check(model, fc, rcfg_steady, scene, frames[1], fine_grid, sfm_grid,
                                fine_host, os.path.join(ROOT, "build", "trace_render"))
    print(f"peak device memory after serving {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if args.profile:
        profile_chunk(model, fc, rcfg_warm, scene, frames[1], None, sfm_grid, "warm-up")
        profile_chunk(model, fc, rcfg_steady, scene, frames[1], fine_grid, sfm_grid, "steady")
    print(f"serving rays/s ({card}): warm-up {rps_warm:.1f}, steady {rps_steady:.1f}; in turns "
          f"eager / graph: " + "; ".join(f"{label} {r['eager']:.1f} / {r['graph']:.1f}"
                                         for label, r in {**rps_graph, **rps_graph_k}.items()))

    # the SDF-VJP kernels against their plain version, and their times; then
    # kernel 5's port (K6, K7 + K5) and kernel 6's (K8, K9 + K5) at the
    # training path's shapes: 8192 x 30 foreground and 8192 x 11 background
    # points in the steady phase
    clock.lap("serving")
    vres, vfails = vjp_kernel_phase(model, fc)
    fails += vfails
    kres.update(vres)
    n_bg = len(bg_eval_idx(rcfg_warm, rcfg_warm.n_samples + rcfg_warm.n_importance
                           + rcfg_warm.n_outside))
    fres, ffails = field_train_kernel_phase(model, fc, VJP_TIME_PTS)
    fails += ffails
    bres, bfails = bg_kernel_phase(model, fc, TRAIN_BATCH, n_bg)
    fails += bfails

    clock.lap("K3-K9 checks")
    # training: Adam steps of make_train_step over RayPool batches
    torch.cuda.reset_peak_memory_stats()
    rows, rgbs = training_rays()
    pool = RayPool(rows, rgbs, with_semantics=True, seed=int(cfg.TRAINER.SEED))
    spec, _ = make_optimizer(cfg, TRAIN_BATCH)
    state = init_state(train_config(cfg, "pallas"), spec, torch.Generator().manual_seed(SEED),
                       dev)
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    print(f"training: {len(pool)} rays from {TRAIN_CAMS} ring cameras "
          f"({int((rows[:, 9] == LABEL_SKY).sum())} sky, "
          f"{int((rows[:, 9] == LABEL_PERSON).sum())} person, "
          f"{int((rows[:, 11] > 0).sum())} with depth), batch {TRAIN_BATCH}, lr {spec.schedule}, "
          f"SDF_GRAD_MODE {', '.join(TRAIN_MODES)} in turns ('pallas_field' with FUSED_BG), "
          f"act {fc.act_dtype}")
    # launches per training mode, both phases
    train_launches, rps_train = {m: {} for m in TRAIN_MODES}, {}
    for label, fg, level in (("warm-up", None, -1), ("steady", fine_grid, fine_host.level)):
        torch.cuda.reset_peak_memory_stats()
        rps_train[label], _, got, tfails = training_phase(cfg, state, scene, pool, fg, level,
                                                          label)
        fails += tfails
        print(f"peak device memory in training {label} "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for m in TRAIN_MODES:
            for n, v in got[m].items():
                train_launches[m][n] = train_launches[m].get(n, 0) + v
    moved = [k for k, v in state.model.state_dict().items() if not torch.equal(v, before[k])]
    if len(moved) < len(before) // 2:
        fails.append(f"training moved only {len(moved)} of {len(before)} parameter tensors")
    print(f"training moved {len(moved)} of {len(before)} parameter tensors in {state.step} steps")
    if args.profile:
        profile_step(cfg, state, scene, pool, None, -1, "warm-up")
        profile_step(cfg, state, scene, pool, fine_grid, fine_host.level, "steady")
    batch = pool.next_batch(TRAIN_BATCH)
    fails += step_parity(cfg, state.model, scene, batch, None, -1, "warm-up")
    fails += step_parity(cfg, state.model, scene, batch, fine_grid, fine_host.level, "steady")
    clock.lap("training")
    # a captured window against eager steps from one state, on the device
    # pool of the same rays (the steady phase with its band cache)
    dpool = DeviceRayPool(pool, dev, seed=SEED)
    _, gfails = graph_parity(cfg, state, scene, dpool, None, -1, "warm-up")
    fails += gfails
    t0 = time.perf_counter()
    dpool.attach_surface(fine_grid, fine_host.level)
    sync()
    print(f"band cache of the {len(dpool)} training rays at level {fine_host.level}: "
          f"{time.perf_counter() - t0:.3f} s")
    _, gfails = graph_parity(cfg, state, scene, dpool, fine_grid, fine_host.level, "steady",
                             profile=args.profile)
    fails += gfails
    clock.lap("graph parity, vjp")
    # each kernel mode's captured window against its eager windows, then
    # every mode's windows timed eager against graph in turns
    for mode in GRAPH_MODES:
        _, gfails = graph_parity(cfg, state, scene, dpool, fine_grid, fine_host.level, "steady",
                                 profile=args.profile, mode=mode)
        fails += gfails
    clock.lap("graph parity, kernel modes")
    rates, rate_launches, gfails = graph_rates(cfg, state, scene, dpool, fine_grid,
                                               fine_host.level, "steady")
    fails += gfails
    print(f"training rays/s in {RATE_INNER}-step windows, steady, eager / graph ({card}): "
          + ", ".join(f"{m} {r['eager']:.1f} / {r['graph']:.1f}" for m, r in rates.items())
          + "; peak device memory of the capture call / held after it " + ", ".join(
              f"{m} {r['peak_gib']:.2f} / {r['held_gib']:.2f} GiB" for m, r in rates.items()))
    print(f"training rays/s ({card}): " + "; ".join(
        f"{label} " + ", ".join(f"{m} {r[m]:.1f}" for m in TRAIN_MODES)
        for label, r in rps_train.items()))

    clock.lap("graph rates")
    # extraction: K6 and K1 f32 against their plain versions, then the
    # served field through extract_mesh_cli at EXTRACT_LEVEL. Not the trained
    # one: 28 steps on the synthetic sphere leave it no closed surface
    # (PERF.md, section 6)
    del pool, dpool, rows, rgbs, batch, state
    xres, xfails = field_kernel_phase(model, fc)
    fails += xfails
    kres.update(xres)
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="extract_", dir=os.path.join(ROOT, "build"))
    try:
        x_launches, xfails = extraction_phase(model, fc, root)
        print(f"peak device memory in extraction "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        # the geometry-evaluation path on the extracted mesh: the
        # reprojection filter at level 12 (K12), its CLI, mesh mode
        import glob

        plys = glob.glob(os.path.join(root, "results", "*.ply"))
        torch.cuda.reset_peak_memory_stats()
        if len(plys) != 1:
            fails.append(f"no extracted mesh for the reprojection filter: {plys}")
            k12, r_launches = {}, {"dda_hier": 0}
        else:
            k12, r_launches, rfails = reproj_filter_phase(root, plys[0], card)
            fails += rfails
        print(f"peak device memory in the reprojection filter "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fails += xfails

    clock.lap("extraction, reprojection filter")
    # the training CLI at full width, then tests/test_e2e.py's gate, through
    # the port's entry points (train_cli, extract_mesh_cli, eval_mesh,
    # render_cli); each CLI call's launches counted on their own
    del model
    # the data-preparation tools, from a raw COLMAP layout to a ray cache
    root = tempfile.mkdtemp(prefix="prep_", dir=os.path.join(ROOT, "build"))
    try:
        _, pfails = prep_phase(root, "cuda", card=card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fails += pfails
    clock.lap("prep")
    cli_runs = {}
    for label, phase in (("train_cli", trainer_phase), ("e2e", e2e_gate_phase)):
        torch.cuda.reset_peak_memory_stats()
        root = tempfile.mkdtemp(prefix=label + "_", dir=os.path.join(ROOT, "build"))
        try:
            got, pfails = phase(root, "cuda", card=card)
            clock.lap(label)
            if label == "train_cli":
                # SSIM and LPIPS on the trained field's held-out view and a
                # seeded batch, on the card against float64 on the CPU
                pfails += image_metrics_phase({"held-out view": held_out_view_pair(root),
                                               "seeded batch": metric_images()}, "cuda", card)
                clock.lap("image metrics")
                # data parallelism from the trained checkpoint: its ranks'
                # launches count under "train_cli multi_rank ..."
                from neuralrecon_w_tpu_torch.training.checkpoint import latest_checkpoint

                ck = latest_checkpoint(os.path.join(root, "results", "trainer", "checkpoints"))
                ranked, mfails = multi_rank_phase(root, ck, "cuda", card)
                got.update(ranked)
                pfails += mfails
                clock.lap("multi-rank")
                # tensor parallelism from the same checkpoint: its ranks'
                # launches count under "train_cli tensor_parallel ..."
                ranked, tfails = tensor_parallel_phase(root, ck, "cuda", card)
                got.update(ranked)
                pfails += tfails
                clock.lap("tensor-parallel")
                # every TRAINER.OPTIMIZER in the captured window from the same
                # checkpoint's parameters: launches under "train_cli optimizer ..."
                ranked, ofails = optimizer_phase(root, ck, "cuda", card)
                got.update(ranked)
                pfails += ofails
                clock.lap("optimizers")
        finally:
            shutil.rmtree(root, ignore_errors=True)
        fails += pfails
        cli_runs.update({f"{label} {run}": v for run, v in got.items()})
        print(f"peak device memory in {label} {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print(clock.line())
    if fails:
        print("FAILED: " + "; ".join(fails), file=sys.stderr)
        return 1
    vjp_src = "neuralrecon_w_tpu_torch/csrc/sdf_vjp.cu"
    sources = {"sdf_mlp": ("neuralrecon_w_tpu_torch/csrc/sdf_mlp.cu",
                           "neuralrecon_w_tpu/ops/pallas_mlp.py:130"),
               "up_sample": ("neuralrecon_w_tpu_torch/csrc/up_sample.cu",
                             "neuralrecon_w_tpu/ops/pallas_sampler.py:445"),
               "sdf_vjp_fwd": (vjp_src, "neuralrecon_w_tpu/ops/pallas_field_vjp.py:411"),
               "sdf_vjp_bwd": (vjp_src, "neuralrecon_w_tpu/ops/pallas_field_vjp.py:482"),
               "dw_reduce": (vjp_src, "neuralrecon_w_tpu/ops/pallas_field_vjp.py:482"),
               "field_fwd": ("neuralrecon_w_tpu_torch/csrc/field_fwd.cu",
                             "neuralrecon_w_tpu/ops/pallas_field.py:274"),
               "field_bwd": ("neuralrecon_w_tpu_torch/csrc/field_bwd.cu",
                             "neuralrecon_w_tpu/ops/pallas_field_train.py:490"),
               "nerf_bg_fwd": ("neuralrecon_w_tpu_torch/csrc/nerf_bg.cu",
                               "neuralrecon_w_tpu/ops/pallas_nerf_bg.py:370"),
               "nerf_bg_bwd": ("neuralrecon_w_tpu_torch/csrc/nerf_bg.cu",
                               "neuralrecon_w_tpu/ops/pallas_nerf_bg.py:403"),
               # no Pallas kernel: JAX's DDA is a lax.while_loop, its sampled
               # query an XLA gather (PERF.md's second table)
               "dda": ("neuralrecon_w_tpu_torch/csrc/ray_voxel.cu",
                       "neuralrecon_w_tpu/ops/ray_voxel.py:59"),
               "sampled_hit": ("neuralrecon_w_tpu_torch/csrc/ray_voxel.cu",
                               "neuralrecon_w_tpu/ops/ray_voxel.py:326"),
               "dda_hier": ("neuralrecon_w_tpu_torch/csrc/ray_voxel.cu",
                            "neuralrecon_w_tpu/ops/ray_voxel.py:198")}
    # K1 and K2 count the serving path's launches; K3, K4 the training
    # path's in 'pallas', K7 to K9 in 'pallas_field', K5 in both (by_mode);
    # K6 its launches on every path (kernel 5's forward in training, the
    # fused serving frames, the extraction's colour sweep), K8 in training
    # and serving. K1's extraction launches and its f32 numbers at the SDF
    # sweep's chunk ride along in its entry, and K6's extraction numbers (the
    # colour sweep's chunk) in its own
    pallas, fused = train_launches["pallas"], train_launches["pallas_field"]
    launches.update(sdf_vjp_fwd=pallas["sdf_vjp_fwd"], sdf_vjp_bwd=pallas["sdf_vjp_bwd"],
                    dw_reduce=pallas["dw_reduce"] + fused["dw_reduce"],
                    field_bwd=fused["field_bwd"], nerf_bg_bwd=fused["nerf_bg_bwd"],
                    field_fwd=fused["field_fwd"] + serve_fused["field_fwd"]
                    + x_launches["field_fwd"],
                    nerf_bg_fwd=fused["nerf_bg_fwd"] + serve_fused["nerf_bg_fwd"],
                    sampled_hit=launches["sampled_hit"] + sum(
                        train_launches[m]["sampled_hit"] for m in TRAIN_MODES))
    # the served graph's replays: K1, K2, K10 in both phases, K11 in steady
    for name, v in serve_graph.items():
        if name in launches:  # K1's total, not its bf16 / f32 split
            launches[name] += v
            kres[name]["serving_graph"] = v
    launches["dda_hier"] = r_launches["dda_hier"]
    kres["dda_hier"] = k12
    kres["sdf_mlp"]["extraction"] = {"launches": x_launches["sdf_mlp"], **kres.pop("sdf_mlp_f32")}
    kres["field_fwd_extraction"] = kres.pop("field_fwd")
    kres.update(fres)
    kres.update(bres)
    kres["dw_reduce"]["by_mode"] = {"pallas": pallas["dw_reduce"],
                                    "pallas_field": fused["dw_reduce"]}
    kres["field_fwd"]["by_path"] = {"training": fused["field_fwd"],
                                    "serving": serve_fused["field_fwd"],
                                    "extraction": x_launches["field_fwd"]}
    kres["field_fwd"]["extraction"] = kres.pop("field_fwd_extraction")
    kres["nerf_bg_fwd"]["by_path"] = {"training": fused["nerf_bg_fwd"],
                                      "serving": serve_fused["nerf_bg_fwd"]}
    # the captured windows (graph_rates: their eager steps, warm-ups and
    # replays) and the kernel modes' served graphs (replays)
    for name in sources:
        launches[name] += rate_launches[name] + serve_graph_k.get(name, 0)
        kres[name]["training_graph"] = rate_launches[name]
        if serve_graph_k.get(name):
            kres[name]["serving_graph"] = kres[name].get("serving_graph", 0) + serve_graph_k[name]
    # the CLI runs' launches: added to each kernel's count, and by run
    for name in sources:
        launches[name] += sum(got[name] for got in cli_runs.values())
        kres[name]["cli"] = {
            run: ({"bf16": got["sdf_mlp_bf16"], "f32": got["sdf_mlp_f32"]}
                  if name == "sdf_mlp" else got[name])
            for run, got in cli_runs.items() if got[name]}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **kres[name]}
               for name, (src, rep) in sources.items()]
    ratio = lambda r: r["ms"] / r["bound_ms"]  # noqa: E731
    fw = kres["field_fwd"]
    k2 = kres["up_sample"]["rounds"]
    print(f"redesigned kernels, ms / bound_ms ({card}): K2 up_sample "
          f"{ratio(k2['first']):.1f} round 0, {ratio(k2['last']):.1f} last round; K6 field_fwd "
          f"{ratio(fw['extraction']):.1f} at {K6_CHECK_PTS} pts, {ratio(fw):.1f} at {VJP_TIME_PTS}; "
          f"K7 field_bwd {ratio(kres['field_bwd']):.1f}; K3 sdf_vjp_fwd "
          f"{ratio(kres['sdf_vjp_fwd']):.1f}; K4 sdf_vjp_bwd {ratio(kres['sdf_vjp_bwd']):.1f}; "
          f"K8 nerf_bg_fwd {ratio(kres['nerf_bg_fwd']):.1f}; K9 nerf_bg_bwd "
          f"{ratio(kres['nerf_bg_bwd']):.1f} (against its rows for K5 "
          f"{kres['nerf_bg_bwd']['ms'] / kres['nerf_bg_bwd']['rows_floor_ms']:.1f}); K10 dda "
          + ", ".join(f"{ratio(c):.1f} {label}" for label, c in kres["dda"]["cases"].items())
          + f"; K11 sampled_hit {ratio(kres['sampled_hit']):.1f}"
          + ("; K12 dda_hier " + ", ".join(
              f"{ratio(c):.1f} {label}" for label, c in k12.get("cases", {}).items()
              if "ms" in c) if k12 else ""))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
