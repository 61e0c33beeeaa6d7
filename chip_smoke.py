"""Smoke test of the PyTorch/CUDA port (sugar_tpu_torch) on one GPU.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``sugar_tpu_torch/csrc``
(into ``sugar_tpu_torch/_build``, one nvcc process each, all started
together), then:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. prints each kernel library's build time and, per CUDA kernel in it,
   ptxas's registers, shared memory and spills; then (``[2b]``) holds the
   binning kernels (``csrc/binning.cu`` through ``bin_fused`` on CUDA
   tensors, the torch route made to raise, under
   ``torch.cuda.set_sync_debug_mode("error")``) to their plain version
   ``bin_fused_plain`` bit for bit (gid, tile ranges, culled counts, the
   card route's counters) and to a second call, with one launch a call: on the five cases
   of tests/test_torch_binning.py, on planted splats whose rects exceed 300
   tiles (the warp path), on a tile of 100,000 slots (the large sort's
   merge rounds) with and without a capacity that cuts it, on a 4096x3840
   frame (61,440 tiles: the count and emit passes' histograms in global
   memory) and on the first view of each benchmark configuration at its
   cells' caps (vanilla_7k's first training view; refined_highpoly's first
   orbit_far and orbit_near views); on the large frame and the benchmark
   views it also times them beside the torch route at the same caps, the
   plain version, ``torch.sort`` of the kept keys and the bytes bound, with
   the device ops of one call; then (``[2c]``) holds the preprocess kernels
   (``csrc/preprocess.cu`` through ``preprocess_fields`` on CUDA tensors,
   the torch route made to raise, no sync) to their plain versions: the
   forward to ``preprocess_fields_plain`` and the backward, through
   ``PreprocessFields`` at random cotangents, to its autograd VJP
   (``preprocess_fields_bwd_plain``), each twice bit-identical with one
   launch a call, on small scenes of every option and on the benchmark
   views, with raw and with built scales and unit quaternions, timed
   beside the plain versions and the bytes bounds;
3. holds each kernel against its plain PyTorch version on the card:
   K1 (compositing forward) and K2 (compositing backward) on a small
   synthetic case (unaligned ranges, empty tiles, a range spanning several
   chunks, early exit, NaN conic/opacity on dropped slots, k_max
   clipping) and on a deep case (max_chunks 48: a tile walking 49 chunks,
   a T_EPS crossing deep in a range, an early exit with NaN and large
   colors behind it), K3 (gradient segment-sum) on the cases of
   tests/test_segsum.py and on edge cases of its id-range blocks (no live
   id, live ids only near n - 1, negative ids, n = 1, a 5,000-slot
   segment, 16 slots per id over many ranges, an unaligned base), each
   also launched into a NaN-filled output (every element must be
   written, bit-identical to the first launch); then all three at full
   width on the inputs of
   the first view of a 1M-Gaussian SH-degree-3 model with trained-
   checkpoint statistics (the trained scene of bench.py, with random
   degree-3 SH), written with the port's ``save_ply`` and loaded with
   ``load_ply(device="cuda")``; there K1, K2 and K3 also run twice
   (outputs bit-identical) and once under
   ``torch.cuda.set_sync_debug_mode("error")`` (no wrapper reads the
   card), and one K3 call is profiled (one kernel);
4. serving: renders that model at 512x512 from 8 views on a ring through
   ``render_adaptive`` + ``render_model`` and checks the overflow
   counters, K1's launch count, the images and the PSNR of the kernel
   render against the plain render of the first view;
5. card against CPU: ``render_params`` and a loss backward on a small
   scene on the card (the kernels) and on the CPU (the plain versions),
   parameter and ndc_offset gradients compared;
6. fwd+bwd at full width: bench.py's 1M-Gaussian trained scene at
   512x512, loss = sum(image^2), gradients of all five inputs;
7. training: ``train_vanilla_3dgs`` for 30 iterations on bench.py's
   train-step scene (2^18 Gaussians, SH 0, 512x512) padded to 327,680
   slots, with perturbed colors against renders of the unperturbed scene
   from the 8 ring cameras; densify (after iteration 25) and opacity
   reset (after 30) each run; then the train step timed with CUDA events
   and traced under torch.profiler;
8. times each kernel beside its plain version and bound, K1 and K2 also
   with every tile_count zeroed but the deepest tile's (the serial walk's
   share), each per sub-kernel under torch.profiler, K3 also beside two
   ``index_add_`` calls (dim 1 and dim 0); view 0's segment statistics and
   the device time of each step of ``GatherDup.backward``;
9. coarse SuGaR: KNN (k 16) over the 2^18 training scene and the 1M
   scene, timed, checked against a float64 ``cdist`` on 4,096 queries each,
   and on exact duplicate points (lower index first); the field query at
   full width (1M samples x 16 neighbors of the 1M scene) timed, a
   65,536-sample slice held against the CPU; ``train_coarse`` in 'sdf'
   mode from the 2^18 scene (an eighth at low opacity, through
   ``save_ply``/``load_ply``) over iterations 8991-9010 at the
   ``CoarseConfig`` widths (entropy, the 9000 KNN refresh, the prune and
   its KNN, ten SDF steps; K1, K2, K3 once per iteration through 9000 and
   twice after), its 9000 milestone restored bit-exactly and resumed; five
   'density' steps (one launch of each kernel per step); the 'sdf' step
   timed, profiled, its peak memory and the device time of its parts;
10. coarse mesh extraction: the level set of one camera of a small scene
   on the card against the CPU; ``extract_mesh_from_coarse_model`` with
   ``ExtractConfig``'s defaults on the pruned model that 9 ends with, over
   every other ring camera (4) at 512x512: per camera the device ms of the
   depth render (one K1 launch), KNN, field query, gradient and the rest,
   the valid pixels and the depth render's overflow counters (the
   reference's fixed caps drop splats; the worst camera is run again at a
   k_max that covers its deepest tile), K1 against its plain version on
   the arguments the worst camera's depth render gave it at the fixed
   caps, the host ms of each meshing step, the mesh PLY loaded back, and
   QEM decimation of the mesh to a fifth;
11. refinement: one refine step's vertex gradient on a small mesh, card
   against CPU; ``refined_training`` with ``RefineConfig``'s defaults on
   the mesh of 10 against the ring images of 7 for 20 iterations (K1, K2,
   K3 once per iteration, the loss over the views falls), its milestone
   restored bit-exactly and resumed; 10 refine steps at SH degree 3 timed
   and one profiled; K1, K2 and K3 against their plain versions on the
   arguments one such step (trained state, grown caps) gave them; the
   refined PLY rendered back through ``load_ply``;
12. the texture bake: ``extract_textured_mesh`` on the refined model of
   11 over the 8 ring cameras with the default ``TextureConfig`` (one K1
   launch per camera); then its parts per camera (the device ms of
   ``render_bound`` and ``rasterize_mesh``, the host ms of the
   accumulation, the overflow counters at the bake's fixed caps and the
   deepest tile against ``rasterize_mesh``'s k_max); K1 against its
   plain version on the arguments the bake's render of the worst camera
   gave it; the OBJ, MTL and PNG loaded back through ``load_obj`` and
   ``io/png.py`` and rendered through ``render_textured_mesh``;
   ``rasterize_mesh`` on the card against the CPU on a small mesh with
   occlusion and tiles deeper than k_max;
13. the pipeline end to end: ``run_vanilla`` -> ``run_coarse`` ->
   ``run_extract_mesh`` -> ``run_refine`` -> ``run_texture`` on
   tests/test_parity.py's scene and configuration (wall seconds and
   launches per stage, K1, K2 and K3 against their plain versions on
   each stage's last launches, each stage's held-out PSNR held to that test's
   floors, the textured OBJ's PSNR, every artifact loaded back, a resumed
   run skipping every stage); LPIPS with seeded synthetic weights on the
   card against the CPU;
14. the oracle modes, the two-pass path, the compositor and the entry
   points: the 1M model of 4 through ``render_adaptive(mode=
   "pallas_twopass")`` on the 8 ring views with the plain versions of K1,
   K2, K3 and the fused path refused (images held to the fused path's,
   overflow 0, one K1 launch per render), one fwd+bwd at view 0
   (gradients held to the fused path's; K1, K2, K3 held to their plain
   versions on its arguments), ms per view beside the fused path's; the
   ``"tiled"`` mode at view 0 with a k_max covering its deepest tile, held
   to the fused image; ``"reference"``, ``"tiled"`` and
   ``"pallas_twopass"`` on a 2^14-Gaussian scene at 128x128, against each
   other and the card against the CPU; ``demo_hybrid.run_demo`` on 11's
   refined model (per-frame ms and tile overflow) and one composite frame
   card against CPU; ``scripts.render``, ``compose_animation`` and
   ``train_vanilla_gs`` on 13's scene and artifacts, every output loaded
   back;
15. the multi-device paths (``sugar_tpu_torch/parallel``): in one run of
   4 ranks sharing the card (``gloo``, collectives staged through pinned
   host buffers), (a) the 1M model of 4 tile-sharded over the 8 ring views
   (each image held to the fused render, overflow 0), (b) its fwd+bwd at
   view 0 (the five inputs' gradients held to the fused path's; K1, K2, K3
   held to their plain versions on each rank's band), (d) the (2, 2)
   sharded and the world-4 tile-sharded vanilla steps on 7's scene held to
   the single-device step and timed, (e) the ring KNN on 9's pruned model
   held to the single-device KNN and a (2, 2) coarse 'sdf' step, (f) a
   (2, 2) refine step on 10's mesh, with the plain kernels (and, on the
   tile-sharded paths, the fused path) made to raise; (c) view 0 on NCCL
   (world 1, and one rank per card with several cards); (g) the level set
   of 4 of 10's cameras over 4 ranks against one; (h) the pipeline with
   devices=4 on 13's scene; in (g) and (h) every rank refuses the plain
   K1-K3 and reports its launches, each sharded stage's held non-zero.
   Ranks sharing one card measure correctness and host staging, not
   multi-card scaling;
16. the measurement entry points (``sugar_tpu_torch/scripts``, the port
   of the JAX package's ``bench.py`` and ``scripts/profile_*`` and
   ``microbench_*``) at their full widths, with the plain K1-K3 made to
   raise: ``bench.main()`` (its three JSON lines parsed, their metric
   names, the card's line and overflow 0 checked, its launches counted
   exactly, K1, K2 and K3 held to their plain versions on its last
   fwd+bwd's arguments), ``profile_raster`` and ``profile_trained`` on
   both scenes (K1-K3 launched, each stage-by-stage image against the
   one-call render of the same path within 1e-6), and
   ``microbench_{gather,prims,sort}`` (``sort`` also in its ``extra``
   mode), each time beside its cost per key, lookup or added element;
17. colour widths above the kernels' instantiations: (a) view 0 of the 1M
   model through ``rasterize_gaussians(mode="pallas")`` with C = 3, 8 and
   13 colour channels (its SH-3 colours, then seeded extra channels and a
   C-wide background), forward and backward under a seeded image
   cotangent, with the plain K1-K3 made to raise: one K1 and K2 launch per
   group of at most 4 channels and one K3 launch per block of at most 16
   rows, K1, K2 and K3 held to their plain versions on the recorded
   arguments, the groups' final_T, n_contrib, entry_p and nch bit-equal,
   the C = 8 render's first three channels, final_T and n_contrib against
   the C = 3 render's, and each kernel's ms, bound and plain version's ms
   at each C, and ``index_add_`` of K3's rows; (b) the bench-scale section
   of ``scripts.scaling_report`` (the tile-sharded and coarse 'sdf' steps
   at capacity 2^20) at 2 ranks sharing the card, its table rows and the
   peak GB per rank;
18. the pipeline as a user runs it, at width: 7's 2^18 scene written as a
   COLMAP text scene (9 ring views at 512x512 through io/colmap's writers
   and io/png), then ``run_full_pipeline`` with the config
   ``train_full_pipeline`` builds (high_poly, sdf, long, eval split) and
   only iteration counts added (vanilla 200, coarse 8500-9010 across the
   entropy phase's last 500 steps, the prune and 9's SDF steps, refine 20),
   with the plain K1-K3 made to raise: per stage the wall, launches, peak
   GB and the time of its file hand-offs, K1-K3 held to their plain
   versions on its last launches, the level set's and the bake's overflow
   counters at their fixed caps; every artifact loaded back and the
   refined state rendered at a held-out view; ``train_refined``,
   ``extract_refined_mesh_with_texture`` and ``metrics`` on the artifacts
   (launches, kernels checked, the texture equal to the pipeline's); a
   second run that skips every stage;
19. the parity protocol at its full configuration's widths: the entry
   point ``run_parity.main`` (60k GT Gaussians, a 15k-Gaussian degraded
   init, 80 cameras at 256x256, capacity 2^17, 2M level-set points,
   Poisson 160, QEM to 50k vertices, 3 Gaussians per triangle) with only
   its iteration counts cut to 1,000 / 400 / 500, the plain K1-K3 made to
   raise: per stage the wall, launches, peak GB and K1-K3 held to their
   plain versions on its last launches; the results JSON, each stage's
   held-out PSNR and SSIM against the degraded init's, PARITY_r05.json's
   and tests/test_parity.py's ordering, the mesh's size through QEM, the
   cap growth, the live counts; ``main`` again on the same workdir (every
   training stage skips); then on its artifacts the scene written as a
   NeRF-synthetic scene (RGBA PNGs) and read by ``load_scene`` over black
   and white at resolution factors 1 and 2, the vanilla PLY through
   ``load_reference_checkpoint``, ``extract_mesh.main`` (the pipeline's
   mesh), the two ablation extractions (and card against CPU at a small
   size), ``edited_quaternions_and_scales`` on the refined state (and card
   against CPU), ``run_viewer.main`` on the refined PLY and 18's textured
   OBJ;
   then prints the kernels line (launches summed over 7, 10, 11, 12, 13,
   14, 15, 16, 17, 18 and 19; the binning row's times from 2b's vanilla_7k
   view), the card line, and last ``{"ok": true, "device": {...}}`` — only
   when every check passed.

Each path runs with the launch counts set to 0 just before it and read
just after: (K1, K2, K3, binning, preprocess, preprocess backward), the
binning one launch of ``bin_fused_cuda`` a fused render, the preprocess
one launch a ``preprocess_fields`` render and one a backward through it,
checked against the path's renders. It exits non-zero, printing no result, without a CUDA card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from sugar_tpu_torch import native
from sugar_tpu_torch import pipeline as pipeline_mod
from sugar_tpu_torch.core.cameras import make_camera
from sugar_tpu_torch.core.quaternions import normalize as quat_normalize
from sugar_tpu_torch.core.sh import C0, eval_sh, sh0_to_rgb, sh_to_rgb
from sugar_tpu_torch.fields import density as df
from sugar_tpu_torch.fields.knn import _sq_dists as knn_sq_dists
from sugar_tpu_torch.fields.knn import knn
from sugar_tpu_torch.eval.metrics import _VGG_CFG, evaluate_renders, make_lpips
from sugar_tpu_torch.eval.parity import eval_gaussian_ply, make_parity_scene
from sugar_tpu_torch.interop import model_from_numpy, params_from_numpy
from sugar_tpu_torch.io import colmap as colmap_io
from sugar_tpu_torch.io import ply as ply_io
from sugar_tpu_torch.io.datasets import load_blender_scene, nerfpp_extent
from sugar_tpu_torch.io.obj import load_obj
from sugar_tpu_torch.io.ply import load_mesh_ply
from sugar_tpu_torch.io.png import read_png, write_png
from sugar_tpu_torch.meshing import levelset, meshops, poisson
from sugar_tpu_torch.meshing.ablations import (
    extract_mesh_from_gaussian_centers,
    extract_mesh_with_marching_cubes,
)
from sugar_tpu_torch.meshing.extract import ExtractConfig, extract_mesh_from_coarse_model
from sugar_tpu_torch.models.compositor import GaussianSet, composite_render
from sugar_tpu_torch.models.densifier import DensifyStats, prune_low_opacity, update_stats
from sugar_tpu_torch.models import gaussians as gm_mod
from sugar_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianParams, load_ply, save_ply
from sugar_tpu_torch.models import render as render_mod
from sugar_tpu_torch.models.render import render_model, render_params
from sugar_tpu_torch.pipeline import (
    PipelineConfig,
    load_scene,
    run_coarse,
    run_extract_mesh,
    run_refine,
    run_texture,
    run_vanilla,
    save_refined_state,
)
from sugar_tpu_torch.parallel import comm
from sugar_tpu_torch.parallel.coarse import make_sharded_coarse_step
from sugar_tpu_torch.parallel.knn import knn_sharded
from sugar_tpu_torch.parallel.launch import run_ranks, to_device
from sugar_tpu_torch.parallel.mesh import gather_params, make_mesh, shard_params, world_axis
from sugar_tpu_torch.parallel.meshing import collect_surface_points_sharded
from sugar_tpu_torch.parallel.refine import (
    gather_bound,
    make_sharded_refine_step,
    shard_bound_state,
)
from sugar_tpu_torch.parallel.render import gather_band, render_sharded, shard_of
from sugar_tpu_torch.parallel.train import make_sharded_train_step, make_tile_sharded_train_step
from sugar_tpu_torch.raster import adaptive
from sugar_tpu_torch.raster import api as raster_api
from sugar_tpu_torch.raster import common as rc
from sugar_tpu_torch.raster import fused as fused_mod
from sugar_tpu_torch.raster import preprocess as preprocess_mod
from sugar_tpu_torch.raster import segsum as segsum_mod
from sugar_tpu_torch.raster import tile_composite as tc_mod
from sugar_tpu_torch.raster.api import rasterize_gaussians
from sugar_tpu_torch.raster.dup_gather import gather_dup, round8
from sugar_tpu_torch.raster.fused import assemble_tiles, bin_and_gather
from sugar_tpu_torch.raster.preprocess import preprocess
from sugar_tpu_torch.raster.segsum import _launch as segment_sum_into
from sugar_tpu_torch.raster.segsum import segment_sum_cuda, segment_sum_plain
from sugar_tpu_torch.raster.tile_composite import (
    C_CHUNK,
    R_COL,
    CompositeOut,
    _tile_ranges,
    tile_composite,
    tile_composite_bwd_cuda,
    tile_composite_bwd_plain,
    tile_composite_cuda,
    tile_composite_plain,
)
from sugar_tpu_torch.refine import bound as refine_bound
from sugar_tpu_torch.refine.bound import BOUND_FIELDS, init_bound_params, normal_consistency_pairs
from sugar_tpu_torch.refine import extract_textured as extract_textured_mod
from sugar_tpu_torch.refine import texture as texture_mod
from sugar_tpu_torch.refine.extract_textured import TextureConfig, extract_textured_mesh
from sugar_tpu_torch.refine.mesh_raster import rasterize_mesh
from sugar_tpu_torch.refine.texture import bake_texture, build_uv_atlas, render_textured_mesh
from sugar_tpu_torch.refine.trainer import (
    RefineConfig,
    bound_adam_step,
    bound_lrs,
    export_refined_ply,
    init_bound_adam,
    load_refined_state,
    make_refine_step,
    refine_loss,
    refined_training,
    render_bound,
)
from sugar_tpu_torch.scripts import (
    bench,
    compose_animation,
    demo_hybrid,
    extract_refined_mesh_with_texture,
    microbench_gather,
    microbench_prims,
    microbench_sort,
    profile_raster,
    profile_trained,
    run_parity,
    run_viewer,
    scaling_report,
    train_full_pipeline,
    train_refined,
    train_vanilla_gs,
)
from sugar_tpu_torch.scripts import extract_mesh as extract_mesh_script
from sugar_tpu_torch.scripts import metrics as metrics_script
from sugar_tpu_torch.scripts import render as render_script
from sugar_tpu_torch.trainers import coarse as coarse_mod
from sugar_tpu_torch.trainers import optimizer as opt
from sugar_tpu_torch.trainers.coarse import CoarseConfig, make_coarse_step, train_coarse
from sugar_tpu_torch.trainers.schedule import iteration_generator
from sugar_tpu_torch.trainers.vanilla import TrainConfig, make_train_step, train_vanilla_3dgs
from sugar_tpu_torch.utils import checkpoint as ckpt
from sugar_tpu_torch.utils import profiling
from sugar_tpu_torch.utils.losses import psnr, rgb_loss_l1_dssim
from sugar_tpu_torch.utils.profiling import card_line, cuda_ms

# The counted wrappers: K1, K2, K3, the binning kernels (one launch of
# ``bin_fused_cuda``, six kernels, a ``bin_fused`` call on the card: one a
# fused render, none on the two-pass, tiled and tile-sharded paths) and the
# preprocess kernels (``preprocess_fields_cuda``: one a ``render_model``,
# ``render_params`` or ``render_bound`` call on the card, whatever the mode,
# none through ``rasterize_gaussians``; ``preprocess_fields_bwd_cuda``: one
# a backward through such a render that needs its gradient).
KERNELS = (tile_composite_cuda, tile_composite_bwd_cuda, segment_sum_cuda,
           fused_mod.bin_fused_cuda, preprocess_mod.preprocess_fields_cuda,
           preprocess_mod.preprocess_fields_bwd_cuda)

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "sugar_tpu_torch", "_build", "smoke")

# The slice at full width: bench.py's trained-statistics scene and caps.
N_GAUSS = 1_000_000
H = W = 512
FOV = 1.2
SH_DEGREE = 3
VIEWS = 8
SCENE_SEED = 1
CAPS = adaptive.RasterCaps(tile_cap=16, dup_capacity=1_900_000, k_max=24832)
# Culled dup count and deepest tile of this scene's first view, binned
# from bench.py's raw arrays. JAX_CPU_COUNTS: the JAX package on a CPU,
# where its dup order (gid) is bit-equal to the port's on the CPU and on
# the GPU (tools/torch_count_witness.py); the port must match them
# exactly. JAX_TPU_RECORD: the same JAX code on a TPU v5e (round 5,
# PERF.md), printed for reference only.
JAX_CPU_COUNTS = (1_576_845, 24_745)
JAX_TPU_RECORD = (1_576_888, 24_773)

# Kernel against its plain version (sequential vs scan products, FMA
# contraction, expf vs torch.exp). A tie pixel is one where the two make
# one include decision differently: a product lands within rounding of
# T_EPS, or an alpha within rounding of the 1/255 cutoff. Its n_contrib
# then differs by 1, or its final_T by more than rounding (TIE_T_RTOL).
# The other pixels' image, final_T and entry_p: max abs difference. Tie
# pixels: at most TIE_SHARE of the pixels, and what one moved slot can
# change. At a T_EPS tie the slot's weight alpha T is at most
# T_EPS * 0.99 / 0.01 ~ 0.0099; at a cutoff tie alpha ~ 1/255 adds
# alpha T c and scales the rest by 1 - alpha, < 2/255 of max|c|. So a tie
# pixel's image may move by TIE_SLOT_WEIGHT * max|c| over the owned
# slots, and its final_T by TIE_SLOT_WEIGHT. A tile's chunk count may
# differ only where it holds a tie pixel (its last pixel above T_EPS).
ATOL_IMAGE = 1e-4
ATOL_ENTRY_P = 1e-4
TIE_T_RTOL = 1e-3
TIE_SHARE = 1e-4
TIE_SLOT_WEIGHT = 0.02
MIN_PSNR_DB = 60.0
# K2 against its plain version: per gradient block (mean2d, conic,
# opacity, color), max abs difference <= BWD_RTOL * max|d| of the block.
# The two take the 256-pixel sums, the suffix sums and the running
# products in other orders (warp trees and sequential products against
# torch sums and scans); a pixel whose product lands within rounding of
# T_EPS can include one slot more or less, at a transmittance of ~1e-4.
BWD_RTOL = 1e-4
# K3 against its plain version (index_add_ on the card, atomics in any
# order): |kernel - plain| <= atol + rtol |plain| elementwise, rtol and
# atol 1e-5, as tests/test_segsum.py; at full width the atol scales with
# max|ct|.
SEGSUM_TOL = 1e-5
# Card (kernels) against CPU (plain versions), gradients of a small scene:
# max abs difference <= CARD_CPU_RTOL * max|g| per parameter (float32
# elementwise functions and sum orders differ between the two devices).
CARD_CPU_RTOL = 1e-4

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# fp32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# The training path: bench.py's _bench_train_step scene and caps.
TRAIN_N = 2**18
TRAIN_CAPACITY = 327_680
TRAIN_SEED = 2
TRAIN_ITERS = 30
TRAIN_CAPS = adaptive.RasterCaps(tile_cap=16, dup_capacity=1_200_000, k_max=12288)
TIMED_STEPS = 10


def _ops_per_eval(ch: int) -> int:
    """fp32 operations of one alpha evaluation in the kernel: offsets (2),
    the conic quadratic (9), the power gate (2), exp (1), opacity scale and
    clamp (2), cutoff gate (2), the running product (2), the include test
    (1), and the weighted color sum (2 + 2 per channel)."""
    return 23 + 2 * ch


def _ops_per_eval_bwd(ch: int) -> int:
    """fp32 operations the compositing backward needs per (pixel, slot),
    counted once (the kernel evaluates alpha twice): the alpha evaluation
    (18: offsets 2, quadratic 9, power gate 2, exp 1, opacity and clamp 2,
    cutoff gate 2), the running product and include test (3), w (1), c . g
    (2 per channel), the suffix (w (c . g), running sum, total minus it,
    plus the carry: 4), dL/dalpha (max, divide, multiply, subtract,
    select: 5), dpower (2), the mean2d terms (8), the conic terms (8), the
    opacity term (1), the color terms (1 per channel), and one add per
    gradient row to sum the 256 pixels (6 + 1 per channel)."""
    return 56 + 4 * ch


# --- the scene (numpy, from a seed; bench.py's, from scripts/bench.py) --


def scene_params(n: int, seed: int, sh_degree: int) -> dict[str, np.ndarray]:
    """Raw GaussianParams fields of the scene at ``sh_degree``: sh_dc from
    the blob colors, sh_rest small random values from its own seed."""
    means, scales, quats, opac, colors = bench._scene_trained(n, np.random.default_rng(seed))
    k = (sh_degree + 1) ** 2
    rest = np.random.default_rng(seed + 1000).normal(0.0, 0.05, (n, 3, k - 1))
    return dict(
        xyz=means,
        sh_dc=((colors - 0.5) / C0).astype(np.float32),
        sh_rest=rest.astype(np.float32),
        opacity_logit=np.log(opac / (1.0 - opac)).astype(np.float32),
        log_scales=np.log(scales).astype(np.float32),
        quaternions=quats,
    )


def ring_poses(views: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(R, T) of cameras on a ring around the blob's center (0, 0, 3.2),
    radius 3.2, looking at it: R the cam-to-world rotation, T the
    world-to-cam translation (make_camera's convention); view 0 is bench.py's
    camera at the origin."""
    center = np.array([0.0, 0.0, 3.2])
    poses = []
    for i in range(views):
        th = 2.0 * math.pi * i / views
        R = np.array(  # cam-to-world rotation about the world y axis
            [[math.cos(th), 0.0, math.sin(th)], [0.0, 1.0, 0.0], [-math.sin(th), 0.0, math.cos(th)]]
        )
        cam_pos = center - R @ np.array([0.0, 0.0, 3.2])
        poses.append((R, -R.T @ cam_pos))
    return poses


def ring_cameras(views: int, device, size: int = H) -> list:
    """The ring's cameras at size x size pixels and FOV."""
    return [make_camera(R, T, FOV, FOV, size, size, device=device) for R, T in ring_poses(views)]


# --- a small synthetic compositing case ---------------------------------


def synthetic_case(seed: int = 0):
    """Inputs of the compositing kernel that cover its edge cases. Returns
    (tile_start, tile_count, dup_data, tiles_x, ch, max_chunks) as numpy.

    12 tiles (4 x 3), max_chunks 3 (768 slots). Ranges: empty tiles, an
    unaligned start inside chunk 0, a range of 700 slots spanning 4
    aligned chunks, an opaque range whose pixels all stop early, a range
    of 1000 slots clipped to 768 (those two faint, so they walk every
    chunk), unowned slots between ranges; NaN conics
    on an unowned slot and on an owned one, a NaN opacity on an owned one.
    """
    g = np.random.default_rng(seed)
    tiles_x, tiles_y, ch, max_chunks = 4, 3, 3, 3
    ranges = [
        (0, 0), (5, 100), (105, 700), (805, 600), (1405, 1000), (2405, 0),
        (2405, 300), (2712, 50), (2762, 120), (2882, 33), (2915, 140), (3055, 17),
    ]
    d_pad = 13 * C_CHUNK
    data = np.zeros((round8(6 + ch), d_pad), np.float32)
    sx = g.uniform(1.0, 6.0, d_pad)
    sy = g.uniform(1.0, 6.0, d_pad)
    rho = g.uniform(-0.8, 0.8, d_pad)
    opac = g.uniform(0.05, 0.95, d_pad)
    owner = np.full(d_pad, -1)
    for t, (s, c) in enumerate(ranges):
        owner[s : s + c] = t
    # Means scattered around the owning tile (or a random tile).
    tile_of = np.where(owner >= 0, owner, g.integers(0, tiles_x * tiles_y, d_pad))
    ox = (tile_of % tiles_x) * rc.TILE_X
    oy = (tile_of // tiles_x) * rc.TILE_Y
    data[0] = ox + g.uniform(-8.0, 24.0, d_pad)
    data[1] = oy + g.uniform(-8.0, 24.0, d_pad)
    faint = (owner == 2) | (owner == 4)  # walk every chunk: no early exit
    opac[faint] = g.uniform(0.02, 0.1, faint.sum())
    opaque = owner == 3
    sx[opaque] = g.uniform(10.0, 20.0, opaque.sum())
    sy[opaque] = g.uniform(10.0, 20.0, opaque.sum())
    opac[opaque] = 0.99
    det = sx**2 * sy**2 * (1.0 - rho**2)
    data[2] = sy**2 / det
    data[3] = -rho * sx * sy / det
    data[4] = sx**2 / det
    data[5] = opac
    data[6 : 6 + ch] = g.uniform(0.0, 1.0, (ch, d_pad))
    data[2:5, 2710] = np.nan  # unowned slot between two ranges
    data[3, 2500] = np.nan  # owned by tile 6: dropped by the power gate
    data[5, 2600] = np.nan  # owned by tile 6: dropped by the cutoff gate
    start = np.array([s for s, _ in ranges], np.int32)
    count = np.array([c for _, c in ranges], np.int32)
    return start, count, data, tiles_x, ch, max_chunks


DEEP_MAX_CHUNKS = 48


def deep_case(seed: int = 0):
    """Compositing inputs whose tiles walk many chunks (max_chunks 48).
    Returns (tile_start, tile_count, dup_data, tiles_x, ch, max_chunks) as
    numpy.

    4 tiles (2 x 2), back to back from slot 100:
    - tile 0, translucent: 48 x 256 + 300 faint slots (clipped to 48 x
      256; from an unaligned start they cover 49 chunks), never reaching
      T_EPS: it walks every chunk;
    - tile 1: 40 chunks' worth of slots, faint up to local slot 7,808 + 77
      and opaque (opacity 0.99, wide) after: its pixels cross T_EPS a few
      slots into a chunk near the 31st of its range, and it exits soon
      after;
    - tile 2: a 48 x 256 range opaque from its first slot, so it exits
      after a chunk or two; its later slots have colors of 1,000 and NaN
      conics and opacities, which must leak into no output;
    - tile 3: empty.
    """
    g = np.random.default_rng(seed)
    tiles_x, ch, max_chunks = 2, 3, DEEP_MAX_CHUNKS
    counts = [max_chunks * C_CHUNK + 300, 40 * C_CHUNK, max_chunks * C_CHUNK, 0]
    starts = 100 + np.concatenate([[0], np.cumsum(counts)[:-1]])
    clipped_end = int(starts[2]) + max_chunks * C_CHUNK
    d_pad = (clipped_end // C_CHUNK + 2) * C_CHUNK
    owner = np.full(d_pad, -1)
    local = np.zeros(d_pad, np.int64)
    for t, (s, c) in enumerate(zip(starts, counts)):
        owner[s : s + c] = t
        local[s : s + c] = np.arange(c)
    tile_of = np.where(owner >= 0, owner, g.integers(0, 4, d_pad))
    data = np.zeros((round8(6 + ch), d_pad), np.float32)
    sx = g.uniform(1.5, 4.0, d_pad)
    sy = g.uniform(1.5, 4.0, d_pad)
    rho = g.uniform(-0.6, 0.6, d_pad)
    opac = np.where(owner == 0, g.uniform(0.004, 0.007, d_pad), g.uniform(0.006, 0.012, d_pad))
    opaque = ((owner == 1) & (local >= 7_808 + 77)) | (owner == 2)
    sx[opaque] = g.uniform(12.0, 20.0, opaque.sum())
    sy[opaque] = g.uniform(12.0, 20.0, opaque.sum())
    opac[opaque] = 0.99
    det = sx**2 * sy**2 * (1.0 - rho**2)
    data[0] = (tile_of % tiles_x) * rc.TILE_X + 8 + g.uniform(-8.0, 8.0, d_pad)
    data[1] = (tile_of // tiles_x) * rc.TILE_Y + 8 + g.uniform(-8.0, 8.0, d_pad)
    data[2] = sy**2 / det
    data[3] = -rho * sx * sy / det
    data[4] = sx**2 / det
    data[5] = opac
    data[6 : 6 + ch] = g.uniform(0.0, 1.0, (ch, d_pad))
    late = (owner == 2) & (local >= 2 * C_CHUNK)
    data[6 : 6 + ch, late] = 1000.0
    data[3, late & (local % 7 == 0)] = np.nan
    data[5, late & (local % 11 == 0)] = np.nan
    return (starts.astype(np.int32), np.array(counts, np.int32), data, tiles_x, ch, max_chunks)


def composite_cotangents(num_tiles: int, ch: int, seed: int):
    """Cotangents of the tile images (T, 256, CH) and of final_T (T, 256)."""
    g = np.random.default_rng(seed)
    p = rc.TILE_X * rc.TILE_Y
    return (g.uniform(-1, 1, (num_tiles, p, ch)).astype(np.float32),
            g.uniform(-1, 1, (num_tiles, p)).astype(np.float32))


def segsum_case(rng: np.random.Generator, n: int, d: int, seg: int):
    """tests/test_segsum.py's case: (16, d) cotangents, ascending ids with
    up to ``seg`` slots each, sentinel n on the rest (nonzero data)."""
    counts = rng.integers(0, seg + 1, n)
    gid = np.repeat(np.arange(n), counts)[:d]
    if len(gid) < d:
        gid = np.concatenate([gid, np.full(d - len(gid), n)])
    gid = np.sort(gid).astype(np.int32)
    ct = rng.normal(size=(16, d)).astype(np.float32)
    ct[:, gid >= n] = rng.normal(size=(16, int((gid >= n).sum())))
    return ct, gid


def segsum_cases():
    """The four cases of tests/test_segsum.py: {name: (ct, gid, n)}."""
    out = {}
    rng = np.random.default_rng(0)
    for n, d, seg in [(64, 100, 5), (1000, 3000, 16), (300, 257, 3)]:
        out[f"n{n}_d{d}_seg{seg}"] = (*segsum_case(rng, n, d, seg), n)
    ct, gid = segsum_case(np.random.default_rng(2), 128, 512, 4)
    out["odd_rows"] = (ct[:9], gid, 128)
    rng = np.random.default_rng(3)
    gid = np.sort(rng.choice(50_000, size=2048, replace=False)).astype(np.int32)
    out["sparse_ids"] = (rng.normal(size=(16, 2048)).astype(np.float32), gid, 50_000)
    return out


def segsum_edge_cases():
    """Edge cases of K3's id-range blocks (128 ids a block, ids staged 256
    at a time): {name: (ct, gid, n)}, 9 rows each. The values are
    multiples of 1/64, so every partial sum is exact in float32 and the
    kernel's slot order and the atomics' order of ``index_add_`` on the
    card give the same sums, however long the segment."""
    rng = np.random.default_rng(4)

    def case(gid, n):
        gid = np.asarray(gid).astype(np.int32)
        return (np.round(rng.normal(size=(9, len(gid))) * 64) / 64).astype(np.float32), gid, n

    n = 1_000_000
    neg = np.sort(np.r_[-rng.integers(1, 1 << 20, 5_000), rng.integers(0, 50_000, 100_000)])
    return {
        "no live id": case(np.full(300_000, n), n),
        "live ids only near n - 1": case(np.r_[np.full(3, n - 3), np.full(2, n - 1),
                                               np.full(1_000, n)], n),
        "negative ids at the head": case(np.r_[neg, np.full(77, 50_000)], 50_000),
        "n = 1": case(np.r_[np.zeros(600), np.ones(401)], 1),
        "a 5,000-slot segment": case(np.sort(np.r_[np.arange(20_000), np.full(5_000, 12_345),
                                                   np.full(9, 20_000)]), 20_000),
        "16 slots per id over 512 block ranges": case(
            np.r_[np.repeat(np.arange(65_536), 16), np.full(3, 65_536)], 65_536),
    }


def small_scene(n: int = 200, seed: int = 3, spread: float = 1.2):
    """tests/test_raster.py's make_scene: (means, scales, quats, opacities,
    colors) in front of a camera at the origin."""
    g = np.random.default_rng(seed)
    means = np.stack(
        [g.uniform(-spread, spread, n), g.uniform(-spread, spread, n), g.uniform(1.0, 6.0, n)],
        axis=-1,
    ).astype(np.float32)
    scales = np.exp(g.uniform(np.log(0.02), np.log(0.25), (n, 3))).astype(np.float32)
    quats = g.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = g.uniform(0.05, 0.95, n).astype(np.float32)
    colors = g.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


def pad_fields(d: dict[str, np.ndarray], capacity: int) -> tuple[dict, np.ndarray]:
    """Pad raw fields to ``capacity`` with load_ply's fill values; returns
    (fields, alive)."""
    n = d["xyz"].shape[0]
    fill = dict(opacity_logit=-10.0, log_scales=-10.0)
    out = {}
    for k, v in d.items():
        pad = np.full((capacity - n,) + v.shape[1:], fill.get(k, 0.0), np.float32)
        out[k] = np.concatenate([v.astype(np.float32), pad])
    out["quaternions"][n:, 0] = 1.0
    return out, np.arange(capacity) < n


def train_scene_fields(n: int, seed: int) -> dict[str, np.ndarray]:
    """bench.py's _bench_train_step parameters: the trained scene at SH
    degree 0 (sh_rest has no coefficients)."""
    means, scales, quats, opac, colors = bench._scene_trained(n, np.random.default_rng(seed))
    return dict(
        xyz=means,
        sh_dc=((colors - 0.5) / C0).astype(np.float32),
        sh_rest=np.zeros((n, 3, 0), np.float32),
        opacity_logit=np.log(opac / (1 - opac)).astype(np.float32),
        log_scales=np.log(scales).astype(np.float32),
        quaternions=quats,
    )


# --- measurement helpers ------------------------------------------------


def tie_mask(n_a, n_b, t_a, t_b) -> torch.Tensor:
    """The tie pixels of two composites of the same pixels (see
    TIE_T_RTOL): their n_contrib differ, or their final_T beyond rounding."""
    return (n_a != n_b) | ((t_a - t_b).abs() > TIE_T_RTOL * torch.maximum(t_a, t_b))


def tie_stats(img_a, img_b, n_a, n_b, t_a, t_b) -> tuple[torch.Tensor, dict]:
    """(tie mask, differences) of two composites of the same pixels: image
    (channels last) and final_T on the tie pixels apart from the others."""
    tie = tie_mask(n_a, n_b, t_a, t_b)
    dn = (n_a.to(torch.int64) - n_b.to(torch.int64)).abs()
    dt = (t_a - t_b).abs()
    di = (img_a - img_b).abs().amax(dim=-1)
    return tie, dict(
        img=float(torch.where(tie, 0.0, di).max()),
        final_t=float(torch.where(tie, 0.0, dt).max()),
        tie_pixels=int(tie.sum()),
        tie_img=float(torch.where(tie, di, 0.0).max()),
        tie_final_t=float(torch.where(tie, dt, 0.0).max()),
        n_contrib_mismatch=int((dn > 0).sum()),
        n_contrib_max_diff=int(dn.max()),
        pixels=int(dn.numel()),
    )


def ties_ok(d: dict, atol: float, tie_img_bound: float) -> bool:
    """The tie rule: ``atol`` off the tie pixels; few tie pixels, each one
    include decision apart, its image within one slot's reach."""
    return (
        d["img"] <= atol
        and d["final_t"] <= atol
        and d["tie_pixels"] <= TIE_SHARE * d["pixels"]
        and d["tie_img"] <= tie_img_bound + atol
        and d["tie_final_t"] <= TIE_SLOT_WEIGHT
        and d["n_contrib_max_diff"] <= 1
    )


def abs_err(d: dict) -> float:
    """The largest image or final_T difference of a compare() or
    compare_renders(), tie pixels included."""
    return max(d["img"], d["final_t"], d["tie_img"], d["tie_final_t"])


def compare(kern: CompositeOut, plain: CompositeOut, args: tuple) -> dict:
    """Differences between the kernel's and the plain version's outputs on
    K1's arguments ``args``: on the tie pixels apart from the others;
    entry_p on the other pixels and the rows both processed."""
    tile_start, tile_count, dup_data, _, ch, max_chunks = args
    tie, d = tie_stats(kern.img, plain.img, kern.n_contrib, plain.n_contrib, kern.final_t,
                       plain.final_t)
    rows = torch.arange(kern.entry_p.shape[1], device=kern.nch.device)
    valid = (rows[None, :, None] < torch.minimum(kern.nch, plain.nch)[:, None, None]) & ~tie[:, None, :]
    nch_differs = kern.nch != plain.nch
    owned = owned_mask(tile_start, tile_count, dup_data.shape[1], max_chunks)
    colours = dup_data[R_COL:R_COL + ch][:, owned]
    colours = colours[torch.isfinite(colours)]  # gated NaN slots add nothing
    return dict(
        d,
        entry_p=float(torch.where(valid, (kern.entry_p - plain.entry_p).abs(), 0.0).max()),
        tie_img_bound=TIE_SLOT_WEIGHT * float(colours.abs().max()) if colours.numel() else 0.0,
        nch_mismatch=int(nch_differs.sum()),
        nch_mismatch_without_tie=int((nch_differs & ~tie.any(dim=1)).sum()),
    )


def compare_ok(d: dict) -> bool:
    return (
        ties_ok(d, ATOL_IMAGE, d["tie_img_bound"])
        and d["entry_p"] <= ATOL_ENTRY_P
        and d["nch_mismatch_without_tie"] == 0
    )


def composite_bound(tile_start, tile_count, nch, ch: int, max_chunks: int) -> dict:
    """Least time on the card for the kernel's work on these inputs: the
    bytes it must move (live rows of the distinct processed chunks, read
    once; its outputs, written once, entry_p only for processed chunks) at
    the HBM rate, against the fp32 operations of the alpha evaluations of
    the slots it must walk (the in-range slots of processed chunks, x 256
    pixels) at the fp32 rate."""
    start = tile_start.to(torch.int64)
    count = torch.clamp(tile_count.to(torch.int64), max=max_chunks * C_CHUNK)
    end = start + count
    c0 = start // C_CHUNK
    n = nch.to(torch.int64)
    walked_end = torch.minimum(end, (c0 + n) * C_CHUNK)
    slots = torch.where(n > 0, walked_end - start, 0).sum()
    # Distinct chunks touched: mark each processed [c0, c0 + n) interval.
    n_chunk_total = int((end.max() + C_CHUNK - 1) // C_CHUNK) + 1
    marks = torch.zeros(n_chunk_total + 1, dtype=torch.int64, device=nch.device)
    marks.index_add_(0, c0, torch.ones_like(c0) * (n > 0))
    marks.index_add_(0, c0 + n, -torch.ones_like(c0) * (n > 0))
    distinct = int((torch.cumsum(marks, 0) > 0).sum())
    num_tiles = tile_start.shape[0]
    p = rc.TILE_X * rc.TILE_Y
    bytes_in = distinct * C_CHUNK * (6 + ch) * 4 + num_tiles * 8
    bytes_out = num_tiles * p * (ch + 2) * 4 + int(n.sum()) * p * 4 + num_tiles * 4
    ops = int(slots) * p * _ops_per_eval(ch)
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_in + bytes_out,
        bytes_in=bytes_in,
        ops=ops,
        slot_evals=int(slots) * p,
    )


GRAD_BLOCKS = {"mean2d": (0, 2), "conic": (2, 5), "opacity": (5, 6)}


def compare_bwd(kern: torch.Tensor, plain: torch.Tensor, ch: int) -> dict:
    """Per gradient block of d_packed: max abs difference, max|plain| and
    whether the difference is within BWD_RTOL of it."""
    blocks = dict(GRAD_BLOCKS, color=(6, 6 + ch))
    out = {}
    for name, (lo, hi) in blocks.items():
        diff = float((kern[lo:hi] - plain[lo:hi]).abs().max())
        scale = float(plain[lo:hi].abs().max())
        out[name] = dict(max_abs_err=diff, max_abs=scale, ok=diff <= BWD_RTOL * scale + 1e-9)
    return out


def owned_mask(tile_start, tile_count, d_pad: int, max_chunks: int) -> torch.Tensor:
    """(d_pad,) bool: the slots some tile's (clipped) range covers."""
    count = torch.clamp(tile_count.to(torch.int64), max=max_chunks * C_CHUNK)
    marks = torch.zeros(d_pad + 1, dtype=torch.int64, device=tile_start.device)
    start = tile_start.to(torch.int64)
    marks.index_add_(0, start, (count > 0).to(torch.int64))
    marks.index_add_(0, start + count, -(count > 0).to(torch.int64))
    return torch.cumsum(marks, 0)[:d_pad] > 0


def composite_bwd_bound(tile_start, tile_count, nch, ch: int, max_chunks: int, d_pad: int) -> dict:
    """Least time on the card for the compositing backward on these
    inputs: bytes (the live rows of the distinct processed chunks, the
    processed entry_p rows, the image and final_T cotangents, final_T,
    the ranges, read once; the 6+CH live rows of d_packed written once) at
    the HBM rate, against _ops_per_eval_bwd operations per (pixel, walked
    slot) at the fp32 rate."""
    fwd = composite_bound(tile_start, tile_count, nch, ch, max_chunks)
    num_tiles = tile_start.shape[0]
    p = rc.TILE_X * rc.TILE_Y
    # K1's reads, plus entry_p's processed rows, g_img, gt_total, final_T
    # and nch.
    bytes_in = (fwd["bytes_in"] + int(nch.sum()) * p * 4 + num_tiles * p * (ch + 2) * 4
                + num_tiles * 4)
    bytes_out = (6 + ch) * d_pad * 4
    ops = fwd["slot_evals"] * _ops_per_eval_bwd(ch)
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_in + bytes_out, ops=ops, slot_evals=fwd["slot_evals"])


def segsum_bound(rows: int, live: int, n: int) -> dict:
    """Least time on the card for the segment sum: the (rows, live)
    cotangent columns and the live ids read once and the (rows, n) output
    written once, at the HBM rate, against one add per live value at the
    fp32 rate. ``live`` counts the columns whose id is < n: the sentinel
    columns sorted past them are dropped, so the function needs none of
    their bytes."""
    nbytes = rows * live * 4 + live * 4 + rows * n * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = rows * live / PEAK_FP32_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> tuple[int, int, int, int, int, int]:
    """(K1, K2, K3, binning, preprocess, preprocess backward) launches
    since the last reset."""
    return tuple(k.launches for k in KERNELS)


def stage_times(model, cam, kw: dict, reps: int = 5) -> dict[str, float]:
    """Milliseconds of each stage of one render_model call, through the
    functions render_fused calls (host clock around each stage,
    synchronized before and after; median of reps)."""
    settings = dataclasses.replace(rc.from_camera(cam), sh_degree=model.sh_degree)
    max_chunks = max(1, (kw["k_max"] + C_CHUNK - 1) // C_CHUNK)
    st = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        st.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return r

    with torch.no_grad():
        for _ in range(reps):
            prep = run("preprocess", lambda: preprocess(
                model.params.xyz, model.opacities, settings, scales=model.scales,
                quaternions=model.quaternions, shs=model.sh, alive_mask=model.alive))
            b, dup = run("bin_and_gather", lambda: bin_and_gather(
                prep, settings, kw["tile_cap"], kw["dup_capacity"], kw["cap_a"], kw["big_cap"]))
            run("tile_composite", lambda: tile_composite(
                b["tile_start"], b["tile_count"], dup, settings.bg, settings.tiles_x, 3,
                max_chunks))
    return {k: statistics.median(v) for k, v in st.items()}


def kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, namespaces of
    anonymous scope and argument list."""
    return name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]


def profile_device(fn, top: int | None = 12):
    """(wall ms, device-busy ms, [(kernel name, ms, calls)], the ``top``
    most expensive or all when None) of one fn() call under torch.profiler
    (CUPTI); busy = the sum of the device activities' durations (one
    stream: they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    busy = sum(v[0] for v in by_name.values())
    ranked = sorted(((k, v[0], v[1]) for k, v in by_name.items()), key=lambda r: -r[1])
    return wall_ms, busy, ranked if top is None else ranked[:top]


@contextlib.contextmanager
def recorded_kernel_args(keep_last: int | None = None):
    """Inside the block, every K1, K2 and K3 launch of the main path also
    records its arguments: yields {"K1": [args, ...], "K2": ..., "K3": ...},
    each holding only the last ``keep_last`` launches' when it is given.
    The recorders stand in for the wrappers in the modules that call them:
    the wrappers count the block's launches on the recorders, and those
    counts are added to the kernels' own when the block ends."""
    recs = {k: collections.deque(maxlen=keep_last) for k in ("K1", "K2", "K3")}
    slots = ((tc_mod, "tile_composite_cuda", "K1"), (tc_mod, "tile_composite_bwd_cuda", "K2"),
             (segsum_mod, "segment_sum_cuda", "K3"))
    originals = [getattr(mod, name) for mod, name, _ in slots]
    recorders = []
    for (mod, name, key), orig in zip(slots, originals):
        def recorder(*args, _orig=orig, _out=recs[key]):
            _out.append(args)
            return _orig(*args)
        recorder.launches = 0
        recorders.append(recorder)
        setattr(mod, name, recorder)
    try:
        yield recs
    finally:
        for (mod, name, _), orig, rec in zip(slots, originals, recorders):
            setattr(mod, name, orig)
            orig.launches += rec.launches


def check_recorded(check, recs: dict, tag: str, label: str) -> dict:
    """Each kernel against its plain version on the arguments one main-path
    call gave it (recorded_kernel_args): K1 on its inputs, K2 on the
    recorded cotangents (each K2 record pairs with the K1 record of the
    same dup_data, whose nch and final_T it must hold bit for bit), K3 on
    its recorded cotangent columns and ids. Returns the max abs error per
    kernel."""
    errs = {}
    paired = 0
    with torch.no_grad():  # the step's inputs require grad; build no graph
        for fw in recs["K1"]:
            kern = tile_composite_cuda(*fw)
            torch.cuda.synchronize()
            plain = tile_composite_plain(*fw)
            d = compare(kern, plain, fw)
            tie = tie_mask(kern.n_contrib, plain.n_contrib, kern.final_t, plain.final_t)
            del plain
            print(f"{tag} K1 vs plain, {label}: {json.dumps(d)}; tiles {fw[0].shape[0]}, dup slots "
                  f"{fw[2].shape[1]}, channels {fw[4]}, max_chunks {fw[5]}, deepest tile "
                  f"{int(fw[1].max())} slots, nch max {int(kern.nch.max())}")
            check(compare_ok(d), f"K1 {label} agrees with the plain version")
            errs["K1"] = max(errs.get("K1", 0.0), abs_err(d))
            for bw in recs["K2"]:
                if bw[3].shape != fw[2].shape or not torch.equal(bw[3], fw[2]):
                    continue
                paired += 1
                same = torch.equal(bw[2], kern.nch) and torch.equal(bw[6], kern.final_t)
                check(same, f"K2 {label}: its recorded nch and final_T are K1's")
                _, _, e = check_k2(check, kern, fw, bw[4], bw[5], label, tag, tie=tie)
                errs["K2"] = max(errs.get("K2", 0.0), e)
            del kern
        if recs["K2"]:
            check(paired == len(recs["K2"]), f"{label}: every recorded K2 launch pairs with a "
                  f"recorded K1 launch ({paired} of {len(recs['K2'])})")
        for ct, gid, n in recs["K3"]:
            e = check_k3(check, ct, gid, n, f"{label} ({int((gid < n).sum())} live slots)",
                         tol_scale=float(ct.abs().max()), tag=tag)
            errs["K3"] = max(errs.get("K3", 0.0), e)
    return errs


@contextlib.contextmanager
def swapped(mod, name: str, new):
    """``mod.name`` is ``new`` inside the block."""
    orig = getattr(mod, name)
    setattr(mod, name, new)
    try:
        yield orig
    finally:
        setattr(mod, name, orig)


def timed_run(check, tag: str, label: str, fn, keep: int = 1, guard=contextlib.nullcontext):
    """fn() inside ``guard()``, timed, with its launches counted, its peak
    GB (torch.cuda.max_memory_allocated, reset at its start) and the last
    ``keep`` launches of each kernel held to their plain versions. Returns
    (fn's result, dict of wall_s, launches, peak_gb, start_gb (allocated at
    its start), recorded (launches recorded per kernel) and errs (max abs
    error per kernel), the recorded launches' arguments)."""
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    with recorded_kernel_args(keep_last=keep) as recs, guard():
        r = fn()
        torch.cuda.synchronize()
    st = dict(wall_s=time.perf_counter() - t0, launches=launches(),
              peak_gb=torch.cuda.max_memory_allocated() / 1e9, start_gb=start_gb,
              recorded=tuple(len(recs[k]) for k in ("K1", "K2", "K3")))
    st["errs"] = check_recorded(check, recs, tag, f"{label}, last launches")
    return r, st, recs


def timed_entry(check, tag: str, name: str, fn, want, guard=contextlib.nullcontext):
    """timed_run of an entry point: ``want`` is the expected (K1, K2, K3,
    binning, preprocess, preprocess backward) launches; None for fused
    renders that need no gradient (K1 launched, no K2 or K3, one binning
    and one preprocess a K1, no preprocess backward); or a (predicate of
    the launches, its description)
    pair. Returns (fn's result, wall s, launches, max abs error per
    kernel)."""
    r, st, _ = timed_run(check, tag, name, fn, guard=guard)
    got = st["launches"]
    if want is None:
        want = (lambda g: g[0] > 0 and g[1:3] == (0, 0) and g[3] == g[4] == g[0] and g[5] == 0,
                "(> 0, 0, 0, = K1, = K1, 0)")
    ok, text = (want[0](got), want[1]) if callable(want[0]) else (got == want, str(want))
    check(ok, f"{name}: launches (K1, K2, K3, binning, preprocess, preprocess bwd) {text} (got {got})")
    return r, st["wall_s"], got, st["errs"]


PIPE_STAGES = ("vanilla", "coarse", "extract_mesh", "refine", "texture")


def timed_stage(check, tag: str, name: str, fn) -> tuple:
    """timed_run of one pipeline stage: the last training step of vanilla,
    coarse and refine is checked (for coarse, an SDF-phase step's two
    renders: the image and the depth map of one camera, the same tiles,
    other colours), the last camera of the extraction's level set and of
    the bake. Returns (fn's result, timed_run's dict)."""
    trains = name in ("vanilla", "coarse", "refine")
    keep = 2 if name == "coarse" else 1
    r, st, recs = timed_run(check, tag, f"{name} stage", fn, keep=keep)
    want = (keep,) * 3 if trains else (1, 0, 0)
    check(st["recorded"] == want, f"{tag} {name}: {want} launches of K1, K2, K3 recorded for the "
          f"kernel check (got {st['recorded']})")
    if name == "coarse" and st["recorded"][0] == 2:
        (s0, c0, d0, *_), (s1, c1, d1, *_) = recs["K1"]
        check(torch.equal(s0, s1) and torch.equal(c0, c1) and not torch.equal(d0, d1),
              f"{tag} coarse: the last step renders twice over the same tiles (image and depth)")
    return r, st


def load_artifacts(art: dict, dev) -> dict:
    """Every artifact of a pipeline run loaded back: the vanilla, coarse and
    refined PLYs (load_ply), the mesh (load_mesh_ply), the refined state
    (load_refined_state), the textured OBJ (load_obj) and its PNG."""
    return dict(
        vanilla=load_ply(art["vanilla"], device=dev), coarse=load_ply(art["coarse"], device=dev),
        mesh=load_mesh_ply(art["mesh"]), refined=load_ply(art["refined"], device=dev),
        state=load_refined_state(art["refined"].replace(".ply", "_state.pkl"), device=dev),
        obj=load_obj(art["textured"]),
        png=read_png(os.path.splitext(art["textured"])[0] + ".png"))


def resumed_run(run) -> tuple[list, tuple, float]:
    """``run(log_fn)`` again over a finished run's output: the stages it
    logged as skipped, its launches and its wall s."""
    logs: list = []
    reset_launches()
    t0 = time.perf_counter()
    run(logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [json.loads(r)["stage"] for r in logs if '"stage_skip"' in r], launches(), wall


# --- the phases ---------------------------------------------------------


class Checks:
    """Collects failed checks; every check prints its outcome."""

    def __init__(self):
        self.failures: list[str] = []

    def __call__(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)


def ptxas_report(log: str, args: tuple[str, ...] = ("3",)) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, static shared-memory bytes, spill-store bytes)
    per entry function of an ``nvcc -Xptxas -v`` log, names demangled
    with c++filt where it exists; of templated kernels only the instances
    whose template argument is in ``args`` (the main paths': CH 3, and CH
    4 and 1 for [17]'s channel groups, for the compositing kernels; 9 and
    16 rows, and [17]'s 14 and 3, for K3)."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append([name, int(m.group(1)), int(smem.group(1)) if smem else 0, spill])
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = kernel_name(n)
    except (OSError, subprocess.CalledProcessError):
        pass
    return [tuple(r) for r in rows
            if "<" not in r[0] or any(f"<{a}>" in r[0] or f"ILi{a}E" in r[0] for a in args)]


def phase_builds() -> None:
    t0 = time.perf_counter()
    built = native.build_all()
    print(f"[2] kernel builds (nvcc x{len(built)}, started together): "
          f"{time.perf_counter() - t0:.2f} s wall")
    for name, (secs, log) in built.items():
        print(f"    {name}: {secs:.2f} s")
        wanted = {"segsum": ("3", "9", "14", "16"), "binning": ("false", "true"),
                  "preprocess": ("false", "true")}.get(name, ("1", "3", "4"))
        for fn, regs, smem, spill in ptxas_report(log, wanted):
            print(f"      ptxas: {fn}: {regs} registers, {smem} bytes smem, "
                  f"{spill} bytes spill stores")


# [2b] the binning kernels (csrc/binning.cu) against their plain version.
# tests/test_torch_binning.py's cases: (scene seed, h, w, tile_cap, cap_a,
# big_cap, capacity).
BIN_CASES = {
    "buckets": (21, 64, 80, 16, 4, 300, 8192),
    "big_overflow": (22, 64, 80, 16, 4, 6, 8192),
    "rect_overflow": (23, 64, 80, 6, 4, 300, 8192),
    "capacity": (24, 64, 80, 16, 4, 300, 400),
    "bucket_a_only": (25, 48, 96, 16, 16, 300, 8192),
}
BIN_KEYS = ("gid", "tile_start", "tile_count", "counts_culled", "num_rendered", "overflow",
            "inexact", "big_overflow", "cap_overflow")
BIN_PLANT_HW = 512
BIN_PLANT_MIN_RECT = 300  # the planted splats' rects, in tiles: the warp path
BIN_DEEP_N = 100_000  # Gaussians stacked over one pixel: a tile past 32,768 slots
BIN_DEEP_CUT = 50_000  # a capacity that cuts that tile
BIN_REPS = 20
BIN_KERNELS = ("visit_kernel", "column_prefix_kernel", "tile_scan_kernel", "sort_small_kernel",
               "sort_large_kernel")  # visit_kernel<count or emit, shared histogram>
# A frame past the visit kernels' shared-memory histogram (24,576 tiles):
# 256 x 240 = 61,440 tiles, its histograms in global memory.
BIN_LARGE_FRAME = (3840, 4096)
BIN_LARGE_N = 50_000
BIN_SHARED_TILES = 24_576
BIN_SEED = 2**31 + 12_345


def binning_scene(n: int, seed: int, spread: float = 1.2):
    """tests/test_raster.py's ``make_scene``: (means, scales, quats,
    opacities, colours) as float32 numpy."""
    g = np.random.default_rng(seed)
    means = np.stack([g.uniform(-spread, spread, n), g.uniform(-spread, spread, n),
                      g.uniform(1.0, 6.0, n)], axis=-1).astype(np.float32)
    scales = np.exp(g.uniform(np.log(0.02), np.log(0.25), (n, 3))).astype(np.float32)
    quats = g.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = g.uniform(0.05, 0.95, n).astype(np.float32)
    colors = g.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


def binning_prep(dev, scene, h: int, w: int, fov_y: float = 1.0):
    """The port's preprocess of ``scene`` from an identity camera (as
    tests/test_raster.py's ``make_settings``): (prep, num_tiles, tiles_x)."""
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fov_x=1.2, fov_y=fov_y, height=h, width=w,
                      device=dev)
    st = rc.from_camera(cam, device=dev)
    means, scales, quats, opac, colors = (torch.as_tensor(x, device=dev) for x in scene)
    with torch.no_grad():
        prep = preprocess(means, opac, st, scales=scales, quaternions=quats, colors=colors)
    return prep, st.tiles_x * st.tiles_y, st.tiles_x


def binning_inputs(dev) -> dict:
    """label -> (prep, bin_fused's arguments after prep) of the small
    inputs: the five cases, the planted large splats, the deep tile."""
    out = {}
    for name, (seed, h, w, tile_cap, cap_a, big_cap, capacity) in BIN_CASES.items():
        prep, num_tiles, tiles_x = binning_prep(dev, binning_scene(300, seed), h, w)
        out[name] = (prep, (num_tiles, tiles_x, tile_cap, cap_a, big_cap, capacity))
    means, scales, quats, opac, colors = binning_scene(4000, 31)
    planted = np.array([[0.0, 0.0, 2.0], [0.4, -0.3, 2.5], [-0.5, 0.2, 3.0]], np.float32)
    scene = (np.concatenate([means, planted]),
             np.concatenate([scales, np.full((3, 3), 0.6, np.float32)]),
             np.concatenate([quats, np.tile(np.array([[1, 0, 0, 0]], np.float32), (3, 1))]),
             np.concatenate([opac, np.full(3, 0.9, np.float32)]),
             np.concatenate([colors, np.full((3, 3), 0.5, np.float32)]))
    prep, num_tiles, tiles_x = binning_prep(dev, scene, BIN_PLANT_HW, BIN_PLANT_HW, fov_y=1.2)
    out["planted_large_splats"] = (prep, (num_tiles, tiles_x, 16, 4, 4096, 2**20))
    g = np.random.default_rng(32)
    n = BIN_DEEP_N
    scene = (np.stack([g.uniform(-1e-3, 1e-3, n), g.uniform(-1e-3, 1e-3, n),
                       g.uniform(2.0, 4.0, n)], -1).astype(np.float32),
             np.full((n, 3), 0.002, np.float32),
             np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
             g.uniform(0.05, 0.95, n).astype(np.float32),
             g.uniform(0, 1, (n, 3)).astype(np.float32))
    prep, num_tiles, tiles_x = binning_prep(dev, scene, BIN_PLANT_HW, BIN_PLANT_HW, fov_y=1.2)
    out["deep_tile"] = (prep, (num_tiles, tiles_x, 16, 4, 4096, 8 * n))
    out["deep_tile_cut"] = (prep, (num_tiles, tiles_x, 16, 4, 4096, BIN_DEEP_CUT))
    means, scales, quats, opac, colors = binning_scene(BIN_LARGE_N, 33)
    # Splats a tenth the size: the plain version's covering expansion is n x
    # the largest rect.
    scene = (means, scales * np.float32(0.1), quats, opac, colors)
    prep, num_tiles, tiles_x = binning_prep(dev, scene, *BIN_LARGE_FRAME)
    out["large_frame"] = (prep, (num_tiles, tiles_x, 16, 4, 4096, 2**24))
    return out


def benchmark_binning_inputs(dev):
    """label -> (prep, bin_fused's arguments after prep) of the first view
    of each benchmark configuration at its cells' caps (the view as the
    cell renders it, recorded at its bin_fused call): vanilla_7k's first
    training view, refined_highpoly's first orbit_far and orbit_near
    views, served. Also label -> (args, kwargs) of the same renders'
    ``preprocess_fields`` calls, for [2c]."""
    from benchmark import scenes as bscenes
    from benchmark.models import free_gaussians as fg
    from benchmark.models import refined_mesh as rm

    def cfg(kind: str, name: str) -> dict:
        with open(os.path.join(ROOT, "benchmark", kind, f"{name}.json")) as f:
            return json.load(f)

    rec, pre_rec = [], []

    def recording(orig):
        def run(prep, *args):
            rec.append((prep, args))
            return orig(prep, *args)
        return run

    def recording_fields(orig):
        def run(*args, **kwargs):
            pre_rec.append((args, kwargs))
            return orig(*args, **kwargs)
        return run

    out, pre = {}, {}
    with torch.no_grad(), swapped(fused_mod, "bin_fused", recording(fused_mod.bin_fused)), \
            swapped(render_mod, "preprocess_fields",
                    recording_fields(render_mod.preprocess_fields)):
        vcfg = cfg("configs", "vanilla_7k")
        inp = fg.build(vcfg, BIN_SEED, dev, role="serve")
        cap = inp["params"]["xyz"].shape[0]
        params = GaussianParams(**{f: inp["params"][f] for f in fg.FIELDS})
        tc = TrainConfig(capacity=cap, sh_degree=inp["sh_degree"])
        render_params(params, inp["alive"], fg.program_camera(inp["views"][0]), inp["sh_degree"],
                      torch.zeros(3, device=dev), dup_capacity=tc.dup_capacity_mult * cap,
                      k_max=tc.k_max, tile_cap=cfg("traffic", "train_from_7k")["tile_cap"])
        out["vanilla_7k view 0"] = rec.pop()
        pre["vanilla_7k view 0"] = pre_rec.pop()
        del inp, params
        rcfg = cfg("configs", "refined_highpoly")
        server = rm.Server(rm.build(rcfg, BIN_SEED, dev, role="serve"))
        for traffic in ("orbit_far", "orbit_near"):
            view = bscenes.orbit_views(rcfg, cfg("traffic", traffic))[0].to(dev)
            server.render(view)
            out[f"refined_highpoly {traffic} view 0"] = rec.pop()
            pre[f"refined_highpoly {traffic} view 0"] = pre_rec.pop()
        del server
    return out, pre


def binning_differs(a: dict, b: dict) -> list[str]:
    return [k for k in BIN_KEYS if not torch.equal(a[k], b[k])]


def check_binning(check, label: str, prep, args) -> dict:
    """``bin_fused`` on the card (the torch route refused, under
    ``set_sync_debug_mode("error")``) against ``bin_fused_plain``, bit for
    bit, and against a second call; with its launches."""
    num_tiles, tiles_x, *_, capacity = args

    def refuse(*a, **k):
        raise AssertionError("bin_fused took the torch route on CUDA tensors")

    l0 = fused_mod.bin_fused_cuda.launches
    with swapped(fused_mod, "bin_fused_torch", refuse):
        torch.cuda.set_sync_debug_mode("error")
        try:
            kern = fused_mod.bin_fused(prep, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        again = fused_mod.bin_fused(prep, *args)
    torch.cuda.synchronize()
    launches = fused_mod.bin_fused_cuda.launches - l0
    plain = fused_mod.bin_fused_plain(prep, num_tiles, tiles_x, capacity)
    torch.cuda.synchronize()
    bad, rep = binning_differs(kern, plain), binning_differs(kern, again)
    err = max(int((kern[k].to(torch.int64) - plain[k].to(torch.int64)).abs().max())
              if kern[k].shape == plain[k].shape else -1 for k in BIN_KEYS)
    tt = prep.tiles_touched
    d = dict(n=tt.shape[0], tiles=num_tiles, max_rect=int(tt.max()),
             warp_rects=int((tt > 32).sum()), num_rendered=int(kern["num_rendered"]),
             d_pad=int(kern["gid"].shape[0]), deepest=int(kern["tile_count"].max()),
             overflow=int(kern["overflow"]), cap_overflow=int(kern["cap_overflow"]),
             differ=bad, differ_again=rep, max_abs_err=err, launches=launches)
    print(f"[2b] binning, {label}: {json.dumps(d)}")
    check(not bad, f"[2b] binning kernels equal their plain version bit for bit, {label}")
    check(not rep, f"[2b] binning kernels give bit-identical outputs twice, {label}")
    check(launches == 2, f"[2b] bin_fused on the card launched the kernels once a call, {label}")
    return dict(kern=kern, plain=plain, **d)


def binning_bytes(prep, out: dict) -> int:
    """Bytes the binning needs to move once: each per-Gaussian input (mean2d,
    conic, qmax, rects, tiles_touched, rank, gsort: 60 bytes) read, gid,
    counts_culled, tile_start and tile_count written."""
    n = prep.tiles_touched.shape[0]
    return 60 * n + 4 * (out["gid"].shape[0] + n + 2 * out["tile_start"].shape[0])


def time_binning(label: str, prep, args, kern: dict) -> dict:
    """Device ms of ``bin_fused`` on the card, of the torch route at the
    same caps (bin_fused_torch), of the plain version, and of
    ``torch.sort`` of the kept slots' [tile | rank] keys; the bytes bound."""
    num_tiles, tiles_x, *_, capacity = args
    n = prep.tiles_touched.shape[0]
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_mod.bin_fused(prep, *args), BIN_REPS)
        torch_ms = cuda_ms(lambda: fused_mod.bin_fused_torch(prep, *args), 5)
        plain_ms = cuda_ms(lambda: fused_mod.bin_fused_plain(prep, num_tiles, tiles_x, capacity), 3)
        _, rank = fused_mod.depth_rank(prep)
        live = kern["gid"] < n
        tile = torch.repeat_interleave(torch.arange(num_tiles, device=prep.depth.device),
                                       kern["tile_count"].to(torch.int64))
        bits = max(1, (n - 1).bit_length())
        keys = (tile << bits) | rank[kern["gid"][live].to(torch.int64)]
        keys = keys[torch.randperm(keys.shape[0], device=keys.device)]
        sort_ms = cuda_ms(lambda: torch.sort(keys), BIN_REPS)
    bound_ms = binning_bytes(prep, kern) / PEAK_BYTES_PER_S * 1e3
    _, busy, kernels = profile_device(lambda: fused_mod.bin_fused(prep, *args), top=None)
    _, busy_torch, kernels_torch = profile_device(
        lambda: fused_mod.bin_fused_torch(prep, *args), top=None)
    d = dict(label=label, ms=round(ms, 4), bound_ms=round(bound_ms, 4),
             share_of_bound=round(bound_ms / ms, 4), torch_route_ms=round(torch_ms, 4),
             plain_ms=round(plain_ms, 4), sort_kept_keys_ms=round(sort_ms, 4),
             kept=int(keys.shape[0]), device_ops=sum(c for _, _, c in kernels),
             device_ops_torch_route=sum(c for _, _, c in kernels_torch),
             busy_ms=round(busy, 4), busy_ms_torch_route=round(busy_torch, 4),
             ours={kernel_name(k): round(t, 4) for k, t, _ in kernels
                   if kernel_name(k).split("<")[0] in BIN_KERNELS})
    print(f"[2b] binning time, {label}: {json.dumps(d)}")
    return d


def phase_binning(check, dev) -> dict:
    """[2b]: the binning kernels against their plain version on the small
    inputs, a large frame and the benchmark's first views, then their time
    on the last two. Returns dict(rows (time_binning's), max_abs_err (the
    largest gap to the plain version over every output, -1 where a shape
    differs), fields (the benchmark views' preprocess_fields arguments, for
    [2c]))."""
    t0 = time.perf_counter()
    rows, errs = [], []
    for label, (prep, args) in binning_inputs(dev).items():
        r = check_binning(check, label, prep, args)
        errs.append(r["max_abs_err"])
        if label == "planted_large_splats":
            check(r["max_rect"] > BIN_PLANT_MIN_RECT and r["warp_rects"] >= 3,
                  f"[2b] the planted splats cover more than {BIN_PLANT_MIN_RECT} tiles each")
        if label == "deep_tile":
            check(r["deepest"] > 32_768, "[2b] the deep tile holds more than 32,768 slots "
                  "(the large sort's merge rounds)")
        if label == "deep_tile_cut":
            check(r["overflow"] > 0 and r["num_rendered"] > r["d_pad"],
                  "[2b] the cut capacity truncates inside the deep tile")
        if label == "large_frame":
            check(r["tiles"] > BIN_SHARED_TILES and r["num_rendered"] > 0,
                  f"[2b] the large frame has more than {BIN_SHARED_TILES} tiles (histograms in "
                  f"global memory) and slots to bin")
            rows.append(time_binning(label, prep, args, r["kern"]))
        del r
    bench_bins, bench_fields = benchmark_binning_inputs(dev)
    for label, (prep, args) in bench_bins.items():
        r = check_binning(check, label, prep, args)
        errs.append(r["max_abs_err"])
        rows.append(time_binning(label, prep, args, r["kern"]))
        del r
        torch.cuda.empty_cache()
    del bench_bins
    print(f"[2b] binning phase: {time.perf_counter() - t0:.1f} s")
    return dict(rows=rows, max_abs_err=max(errs, key=lambda e: (e < 0, e)),
                fields=bench_fields)


# [2c] the preprocess kernel (csrc/preprocess.cu) against its plain version
# on the benchmark's first views. Floats: within PRE_TOL absolute or
# PRE_TOL relative (the kernel sums the view and projection products left
# to right where torch's GEMM may round otherwise; the rest is the same
# float32 operations in the same order). Integers (radius, rect_min,
# rect_max): equal, but for Gaussians whose plain value before rounding
# (3 sqrt(max(lambda_max, 0)) for the radius's ceil, the four rect
# quotients for their truncations) lies within PRE_NEAR, relative, of an
# integer; there each may differ by one (a radius that rounds the other
# way moves the rect with it; a rect that collapses zeroes tiles_touched
# and so the radius). tiles_touched is equal where the rect is, and is
# the product of the kernel's own rect where it differs.
PRE_TOL = 1e-5
PRE_NEAR = 1e-5
PRE_FLOATS = ("mean2d", "depth", "conic", "opacity", "color")
PRE_REPS = 20


PRE_SMALL_N = 1001  # not a multiple of the kernel's 128-Gaussian blocks
# name -> (model SH degree, active degree, colour width or None, dead
# slots and an ndc_offset, fields 4 bytes past 16-byte alignment)
PRE_SMALL = {
    "sh0": (0, 0, None, True, False), "sh1": (1, 1, None, True, False),
    "sh2": (2, 2, None, False, False), "sh3": (3, 3, None, True, False),
    "sh4": (4, 4, None, True, False), "sh1_of_3": (3, 1, None, True, False),
    "colors1": (3, 3, 1, True, False), "colors8": (3, 3, 8, False, False),
    "sh3_unaligned": (3, 3, None, True, True),
}


def preprocess_small_inputs(dev) -> dict:
    """label -> (preprocess_fields' arguments, keyword arguments) of small
    scenes on the card covering the kernel's options: every SH degree,
    a lower active degree, colour overrides, dead slots and an
    ndc_offset, fields that start off 16-byte alignment; an eighth of the
    Gaussians behind the camera, an eighth far outside the frustum."""
    out = {}
    for name, (deg, active, ch, dead, unaligned) in PRE_SMALL.items():
        g = np.random.default_rng(41)
        n = PRE_SMALL_N
        xyz = np.stack([g.uniform(-1.2, 1.2, n), g.uniform(-1.2, 1.2, n),
                        g.uniform(1.0, 6.0, n)], -1)
        xyz[: n // 8, 2] = g.uniform(-2.0, -0.3, n // 8)
        xyz[n // 8: n // 4, 0] = g.choice([-1, 1], n // 8) * g.uniform(20.0, 60.0, n // 8)
        k = (deg + 1) ** 2
        d = dict(xyz=xyz, opacity_logit=g.normal(0, 2.0, n),
                 log_scales=g.uniform(np.log(0.02), np.log(0.3), (n, 3)),
                 quaternions=g.normal(size=(n, 4)) * g.uniform(0.3, 3.0, (n, 1)),
                 sh_dc=g.normal(0, 0.8, (n, 3)), sh_rest=g.normal(0, 0.3, (n, 3, k - 1)))

        def put(x):
            x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
            if not unaligned:
                return x
            buf = torch.empty(x.numel() + 1, dtype=torch.float32, device=dev)
            buf[1:] = x.reshape(-1)
            return buf[1:].view(x.shape)

        t = {f: put(v) for f, v in d.items()}
        cam = make_camera(R=np.array([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0],
                                      [-0.0998, 0.0, 0.995]]),
                          T=np.array([0.05, -0.1, 0.2]), fov_x=1.2, fov_y=1.0, height=96,
                          width=128, device=dev)
        st = dataclasses.replace(rc.from_camera(cam, device=dev), sh_degree=active)
        kw = dict(alive_mask=torch.as_tensor(g.uniform(size=n) > 0.15, device=dev) if dead
                  else None,
                  colors=put(g.uniform(0, 1, (n, ch))) if ch else None,
                  ndc_offset=put(g.normal(0, 0.01, (n, 2))) if dead else None)
        out[f"small {name}"] = ((t["xyz"], t["opacity_logit"], t["log_scales"],
                                 t["quaternions"], t["sh_dc"], t["sh_rest"], st), kw)
    return out


def built_variant(args, kw):
    """(args, kw) of the same render with the scales and unit quaternions
    given built (the refined model's route): the kernels' other
    instantiation."""
    xyz, logit, log_scales, quats, dc, rest, st = args
    return ((xyz, logit, None, None, dc, rest, st),
            dict(kw, scales=torch.exp(log_scales), unit_quaternions=quat_normalize(quats)))


def shape_fields(args, kw):
    """(scales, unit quaternions) of a render, as the plain version takes
    them."""
    if kw.get("scales") is not None:
        return kw["scales"], kw["unit_quaternions"]
    return torch.exp(args[2]), quat_normalize(args[3])


def plain_rounding_values(args, kw, plain):
    """(v_radius (N,), v_rect (N, 4)): the plain route's values before its
    ceil and its truncations, with ``preprocess``'s torch ops."""
    xyz, st = args[0], args[6]
    cov = preprocess_mod._cov3d_channels(*shape_fields(args, kw), st.scale_modifier)
    cxx, cxy, cyy = preprocess_mod.compute_cov2d(
        xyz, cov, st.viewmatrix, st.focal_x, st.focal_y, st.tanfovx, st.tanfovy).unbind(-1)
    det = cxx * cyy - cxy * cxy
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    v_r = rc.RADIUS_SIGMA * torch.sqrt(torch.clamp(lam, min=0.0))
    r = torch.ceil(v_r)
    mx, my = plain.mean2d.unbind(-1)
    v_rect = torch.stack([(mx - r) / rc.TILE_X, (my - r) / rc.TILE_Y,
                          (mx + r + rc.TILE_X - 1) / rc.TILE_X,
                          (my + r + rc.TILE_Y - 1) / rc.TILE_Y], -1)
    return v_r, v_rect


def compare_preprocess(kern, plain, v_r, v_rect) -> dict:
    """The floats' largest gaps and how many lie beyond PRE_TOL; the
    Gaussians whose integers differ, admitted (near an integer, by one)
    or not."""
    d = {}
    for f in PRE_FLOATS:
        a, b = getattr(kern, f), getattr(plain, f)
        gap = (a - b).abs()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        ok = same | (gap <= PRE_TOL) | (gap <= PRE_TOL * b.abs())
        fin = torch.where(same, 0.0, gap)
        d[f] = dict(max_abs=float(fin.max()),
                    max_rel=float((fin / b.abs().clamp(min=1e-30)).max()),
                    beyond=int((~ok).sum()))
    ki = torch.cat([kern.radius[:, None], kern.rect_min, kern.rect_max], 1).to(torch.int64)
    pi = torch.cat([plain.radius[:, None], plain.rect_min, plain.rect_max], 1).to(torch.int64)
    diff = (ki - pi).abs()
    differs = (diff > 0).any(1) | (kern.tiles_touched != plain.tiles_touched)

    def near(v):
        return (v - torch.round(v)).abs() <= PRE_NEAR * v.abs().clamp(min=1.0)

    by_one = (diff[:, 1:] <= 1).all(1) & ((diff[:, 0] <= 1) | (kern.radius == 0)
                                          | (plain.radius == 0))
    own = (kern.rect_max - kern.rect_min).to(torch.int64).prod(1)
    consistent = (kern.tiles_touched == 0) | (kern.tiles_touched.to(torch.int64) == own)
    admitted = differs & (near(v_r) | near(v_rect).any(1)) & by_one & consistent
    d["int_differs"] = int(differs.sum())
    d["int_admitted"] = int(admitted.sum())
    d["int_bad"] = int((differs & ~admitted).sum())
    return d


def preprocess_bytes(args, kw, prep) -> int:
    """Bytes the kernel needs to move once: each field it reads (at the
    active SH degree), each output written."""
    xyz, logit, log_scales, quats, dc, rest, st = args
    n = xyz.shape[0]
    colors = kw.get("colors")
    seg = (st.sh_degree + 1) ** 2 - 1
    read = n * (12 + 4 + 12 + 16) + (colors.numel() * 4 if colors is not None
                                     else n * (12 + 12 * seg))
    read += n if kw.get("alive_mask") is not None else 0
    read += 8 * n if kw.get("ndc_offset") is not None else 0
    wrote = sum(getattr(prep, f.name).numel() * 4 for f in dataclasses.fields(prep))
    return read + wrote


# The preprocess backward kernel against the autograd VJP of the plain
# version, through ``PreprocessFields`` (the torch route refused, under
# ``set_sync_debug_mode("error")``), at random cotangents, on the same
# renders in both instantiations. Each gradient within PRE_BWD_TOL x
# max|g| of its field (float32 sums in another order). The tie rule: a
# Gaussian whose plain forward lies within PRE_NEAR of a clamp's edge (a
# colour before its clamp at 0, |t / z| at the 1.3 tan limit, view z at
# the near cull) may fall on the other side in the kernel, which then
# passes another share of its gradient (all, half or none); such Gaussians
# are left out of the comparison and counted, and must be fewer than one in
# ten thousand.
PRE_BWD_TOL = 2e-5


def preprocess_cotangents(n: int, ch: int, dev, seed: int = 43) -> tuple:
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev)
                 for shape in ((n, 2), (n, 3), (n,), (n, ch)))


def preprocess_tie_rows(args, kw) -> torch.Tensor:
    """(N,) bool: the Gaussians near a clamp's edge, by the plain forward's
    values (``preprocess``'s torch ops)."""
    xyz, st = args[0], args[6]
    W = st.viewmatrix[:3, :3]
    t = xyz @ W.T + st.viewmatrix[:3, 3]
    tz = torch.where(t[:, 2] > rc.Z_CULL, t[:, 2], 1.0)
    lims = torch.tensor([rc.FOV_CLAMP * st.tanfovx, rc.FOV_CLAMP * st.tanfovy], device=xyz.device)
    u = t[:, :2] / tz[:, None]
    near = ((u.abs() - lims).abs() <= PRE_NEAR * lims).any(1)
    near |= (t[:, 2] - rc.Z_CULL).abs() <= PRE_NEAR
    depth = xyz @ st.viewmatrix[2, :3] + st.viewmatrix[2, 3]
    near |= (depth - rc.Z_CULL).abs() <= PRE_NEAR
    if kw.get("colors") is None:
        k = (st.sh_degree + 1) ** 2
        shs = torch.cat([args[4][:, :, None], args[5]], -1)[:, :, :k]
        dirs = xyz - st.campos
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp(min=1e-12)
        near |= ((eval_sh(st.sh_degree, shs, dirs) + 0.5).abs() <= PRE_NEAR).any(1)
    return near


def preprocess_bwd_bytes(args, kw) -> int:
    """Bytes the backward kernel needs to move once: the fields it reads
    (at the active SH degree), the cotangents, each gradient written
    (sh_rest's whole rows)."""
    xyz, st, rest = args[0], args[6], args[5]
    n = xyz.shape[0]
    sh = kw.get("colors") is None
    seg = (st.sh_degree + 1) ** 2 - 1
    read = n * (12 + 4 + 12 + 16) + (n * (12 + 12 * seg) if sh else 0)
    read += n * (8 + 12 + 4 + (12 if sh else 0))
    wrote = n * (12 + 4 + 12 + 16) + (n * 12 + rest.numel() * 4 if sh else 0)
    wrote += 8 * n if kw.get("ndc_offset") is not None else 0
    return read + wrote


def check_preprocess_bwd(check, dev, label: str, args, kw) -> dict:
    """The backward kernel on one render: through ``PreprocessFields``
    against ``preprocess_fields_bwd_plain``, a second launch bit-identical,
    one launch each of the forward and the backward; its time beside the
    plain VJP's and the bytes bound."""
    xyz, st = args[0], args[6]
    n = xyz.shape[0]
    colors = kw.get("colors")
    cot = preprocess_cotangents(n, 3 if colors is None else colors.shape[1], dev)
    # The fields in the backward's gradient order (GRAD_FIELDS), as leaves.
    given = dict(zip(preprocess_mod.GRAD_FIELDS[:6], args[:6]),
                 **{k: v for k, v in kw.items() if k != "alive_mask"})
    if colors is not None:
        given["sh_dc"] = given["sh_rest"] = None  # unread under a colors override
    leaves = [None if given.get(f) is None else given[f].detach().requires_grad_(True)
              for f in preprocess_mod.GRAD_FIELDS]
    lf = dict(zip(preprocess_mod.GRAD_FIELDS, leaves))

    def refuse(*a, **k):
        raise AssertionError("preprocess_fields took the torch route on CUDA tensors")

    f0 = preprocess_mod.preprocess_fields_cuda.launches
    b0 = preprocess_mod.preprocess_fields_bwd_cuda.launches
    with swapped(preprocess_mod, "preprocess_fields_plain", refuse), \
            swapped(preprocess_mod, "preprocess_fields_bwd_plain", refuse):
        torch.cuda.set_sync_debug_mode("error")
        try:
            prep = preprocess_mod.preprocess_fields(
                *leaves[:6], st, kw.get("alive_mask"), lf["colors"], lf["ndc_offset"],
                lf["scales"], lf["unit_quaternions"])
            outs = (prep.mean2d, prep.conic, prep.opacity, prep.color)
            got = iter(torch.autograd.grad(outs, [x for x in leaves if x is not None], cot,
                                           allow_unused=True))
            kern = [None if x is None else next(got) for x in leaves]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fl = preprocess_mod.preprocess_fields_cuda.launches - f0
    bl = preprocess_mod.preprocess_fields_bwd_cuda.launches - b0
    with torch.no_grad():
        again = preprocess_mod.preprocess_fields_bwd_cuda(*cot, *args, **kw)
        plain = preprocess_mod.preprocess_fields_bwd_plain(*cot, *args, **kw)
        ties = preprocess_tie_rows(args, kw)
    del prep, outs, leaves, lf, given
    keep = ~ties
    errs, bad, rep = {}, [], []
    for name, a, b, c in zip(preprocess_mod.GRAD_FIELDS, kern, plain, again):
        if (a is None) != (b is None) or (a is None) != (c is None):
            bad.append(f"{name}: None differs")
            continue
        if a is None:
            continue
        if not torch.equal(a, c):
            rep.append(name)
        a, b = a[keep], b[keep]
        if not b.numel():
            continue
        both_nan = torch.isnan(a) & torch.isnan(b)
        gap = torch.where(both_nan, 0.0, (a - b).abs())
        scale = float(torch.where(torch.isfinite(b), b.abs(), 0.0).max())
        err = float(gap.max()) / max(scale, 1e-30)
        errs[name] = err
        if not err <= PRE_BWD_TOL:
            bad.append(f"{name}: {err:.3e} of max|g| {scale:.3e}")
    ms = cuda_ms(lambda: preprocess_mod.preprocess_fields_bwd_cuda(*cot, *args, **kw), PRE_REPS)
    plain_ms = cuda_ms(lambda: preprocess_mod.preprocess_fields_bwd_plain(*cot, *args, **kw), 3)
    bound_ms = preprocess_bwd_bytes(args, kw) / PEAK_BYTES_PER_S * 1e3
    row = dict(label=label, n=n, sh_degree=st.sh_degree, launches=[fl, bl],
               ties=int(ties.sum()), grad_err={k: float(f"{v:.3e}") for k, v in errs.items()},
               differ_again=rep, ms=round(ms, 4), bound_ms=round(bound_ms, 4),
               share_of_bound=round(bound_ms / ms, 4), plain_ms=round(plain_ms, 4))
    print(f"[2c] preprocess backward, {label}: {json.dumps(row)}")
    check(not bad, f"[2c] preprocess backward kernel within {PRE_BWD_TOL} x max|g| of the plain "
                   f"VJP, {label} ({'; '.join(bad)})")
    check(not rep, f"[2c] preprocess backward kernel gives bit-identical gradients twice, {label}")
    check(fl == 1 and bl == 1, f"[2c] a render under grad on the card launched the forward and "
                               f"the backward kernel once each, no sync, {label}")
    check(row["ties"] * 10000 <= max(n, 10000),
          f"[2c] fewer than one in ten thousand Gaussians near a clamp's edge, {label}")
    del kern, again, plain
    torch.cuda.empty_cache()
    return dict(row, max_err=max(errs.values(), default=0.0))


def phase_preprocess(check, dev, inputs: dict) -> dict:
    """[2c]: ``preprocess_fields`` on the card (the torch route refused,
    under ``set_sync_debug_mode("error")``) against
    ``preprocess_fields_plain`` on small scenes of every option and on the
    benchmark's first views, each also with built scales and unit
    quaternions, twice bit-identical, one launch a call; its time beside
    the plain version's and the bytes bound; then the backward kernel on
    the same renders (``check_preprocess_bwd``). Returns dict(rows,
    max_abs_err (the largest float gap), bwd_rows, bwd_max_err)."""
    t0 = time.perf_counter()
    rows, errs, bwd_rows = [], [], []

    def refuse(*a, **k):
        raise AssertionError("preprocess_fields took the torch route on CUDA tensors")

    cases = preprocess_small_inputs(dev) | inputs
    cases |= {f"built: {label}": built_variant(*c) for label, c in cases.items()}
    for label, (args, kw) in cases.items():
        l0 = preprocess_mod.preprocess_fields_cuda.launches
        with torch.no_grad():
            with swapped(preprocess_mod, "preprocess_fields_plain", refuse):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    kern = preprocess_mod.preprocess_fields(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                again = preprocess_mod.preprocess_fields(*args, **kw)
            torch.cuda.synchronize()
            launches_ = preprocess_mod.preprocess_fields_cuda.launches - l0
            plain = preprocess_mod.preprocess_fields_plain(*args, **kw)
            v_r, v_rect = plain_rounding_values(args, kw, plain)
            d = compare_preprocess(kern, plain, v_r, v_rect)
            fields = [f.name for f in dataclasses.fields(kern)]
            rep = [f for f in fields if not torch.equal(getattr(kern, f), getattr(again, f))]
            shapes = [f for f in fields if getattr(kern, f).shape != getattr(plain, f).shape
                      or getattr(kern, f).dtype != getattr(plain, f).dtype]
            ms = cuda_ms(lambda: preprocess_mod.preprocess_fields_cuda(*args, **kw), PRE_REPS)
            plain_ms = cuda_ms(lambda: preprocess_mod.preprocess_fields_plain(*args, **kw), 3)
        bound_ms = preprocess_bytes(args, kw, kern) / PEAK_BYTES_PER_S * 1e3
        n = args[0].shape[0]
        row = dict(label=label, n=n, sh_degree=args[6].sh_degree,
                   visible=int((plain.tiles_touched > 0).sum()), launches=launches_,
                   differ_again=rep, shape_or_dtype_differs=shapes, ms=round(ms, 4),
                   bound_ms=round(bound_ms, 4), share_of_bound=round(bound_ms / ms, 4),
                   plain_ms=round(plain_ms, 4), **d)
        print(f"[2c] preprocess, {label}: {json.dumps(row)}")
        floats_ok = all(d[f]["beyond"] == 0 for f in PRE_FLOATS)
        check(floats_ok, f"[2c] preprocess kernel floats within {PRE_TOL} absolute or relative "
                         f"of the plain version, {label}")
        check(d["int_bad"] == 0 and not shapes, f"[2c] preprocess kernel radius, rects and "
              f"tiles_touched equal the plain version's but for {d['int_admitted']} admitted "
              f"differences of one near an integer, {label}")
        check(not rep, f"[2c] preprocess kernel gives bit-identical outputs twice, {label}")
        check(launches_ == 2, f"[2c] preprocess_fields on the card launched the kernel once a "
                              f"call, no sync, {label}")
        check(d["int_differs"] * 1000 < max(1, row["visible"]),
              f"[2c] fewer than one in a thousand visible Gaussians differ in an integer, {label}")
        rows.append(row)
        errs.append(max(d[f]["max_abs"] for f in PRE_FLOATS))
        del kern, again, plain, v_r, v_rect
        torch.cuda.empty_cache()
        bwd_rows.append(check_preprocess_bwd(check, dev, label, args, kw))
    print(f"[2c] preprocess phase: {time.perf_counter() - t0:.1f} s")
    return dict(rows=rows, max_abs_err=max(errs), bwd_rows=bwd_rows,
                bwd_max_err=max(r["max_err"] for r in bwd_rows))


def check_k2(check, fwd: CompositeOut, args, g_img, gt_total, label: str, tag: str = "[3]",
             tie: torch.Tensor | None = None):
    """K2 against its plain version on one case; returns (kernel d_packed,
    its arguments, max abs error over the blocks).

    ``tie`` (T, P) marks the forward's tie pixels (``tie_mask`` of K1
    against its plain version): there the two made one include decision
    differently at T_EPS or the cutoff, and K2 and the plain backward,
    which redo each decision as their forwards do, differ there by what
    one slot carries. Where there are any, K2 and its plain version are
    held to BWD_RTOL on the cotangents with the tie pixels' set to 0 (the
    other pixels' gradients), and the difference on the whole cotangents
    is printed beside it. The returned d_packed is the kernel's on the
    whole cotangents."""
    start, count, dup, tiles_x, ch, max_chunks = args
    bwd_args = (start, count, fwd.nch, dup, g_img, gt_total, fwd.final_t, fwd.entry_p,
                tiles_x, ch, max_chunks)
    kern = tile_composite_bwd_cuda(*bwd_args)
    torch.cuda.synchronize()
    plain = tile_composite_bwd_plain(*bwd_args)
    d = compare_bwd(kern, plain, ch)
    ties = 0 if tie is None else int(tie.sum())
    if ties:
        print(f"{tag} K2 vs plain, {label}, whole cotangents ({ties} tie pixels): {json.dumps(d)}")
        held = bwd_args[:4] + (torch.where(tie[..., None], 0.0, g_img).contiguous(),
                               torch.where(tie, 0.0, gt_total).contiguous()) + bwd_args[6:]
        kern_held = tile_composite_bwd_cuda(*held)
        torch.cuda.synchronize()
        d = compare_bwd(kern_held, tile_composite_bwd_plain(*held), ch)
        label = f"{label}, the {ties} tie pixels' cotangents 0"
    print(f"{tag} K2 vs plain, {label}: {json.dumps(d)}")
    check(all(v["ok"] for v in d.values()),
          f"K2 {label} agrees with the plain version within {BWD_RTOL} x max|d| per block")
    owned = owned_mask(start, count, dup.shape[1], max_chunks)
    check(float(kern[:, ~owned].abs().max()) == 0.0 and float(kern[6 + ch:].abs().max()) == 0.0,
          f"K2 {label}: slots no tile owns and padding rows are exactly 0")
    check(bool(torch.isfinite(kern).all()), f"K2 {label}: d_packed finite (NaN slots gated)")
    return kern, bwd_args, max(v["max_abs_err"] for v in d.values())


def phase_deep(check, dev) -> None:
    """K1 and K2 against their plain versions on deep_case: a tile that
    walks 49 chunks, one whose pixels cross T_EPS deep in its range, and a
    long range that exits early (nothing past its exit may reach an
    output)."""
    start, count, data, tiles_x, ch, mc = deep_case(0)
    args = (torch.as_tensor(start, device=dev), torch.as_tensor(count, device=dev),
            torch.as_tensor(data, device=dev), tiles_x, ch, mc)
    kern = tile_composite_cuda(*args)
    torch.cuda.synchronize()
    d = compare(kern, tile_composite_plain(*args), args)
    print(f"[3] K1 vs plain, deep case: {json.dumps(d)}")
    print(f"    nch {kern.nch.tolist()}")
    check(compare_ok(d), "deep case agrees with the plain version")
    check(kern.nch.tolist() == [49, 32, 1, 0],
          "deep case: 49 chunks walked, a crossing exit after 32, an opaque exit after 1")
    check(bool(torch.isfinite(kern.img).all()) and float(kern.img.max()) < 1.0,
          "deep case: no slot past the early exit reaches the image")
    g_img, g_t = composite_cotangents(len(start), ch, seed=12)
    d_packed, _, _ = check_k2(check, kern, args, torch.as_tensor(g_img, device=dev),
                              torch.as_tensor(g_t, device=dev), "deep case")
    walked_end = (int(start[2]) // C_CHUNK + int(kern.nch[2])) * C_CHUNK
    check(float(d_packed[:, walked_end:].abs().max()) == 0.0,
          "deep case: K2 writes no slot past the early exit")


def check_repeatable(check, fw_args, bwd_args, k3_args) -> None:
    """Two launches of K1, of K2 and of K3 give bit-identical outputs
    (entry_p on the rows written), and one K1 + K2 + K3 call under sync
    debug mode "error" raises nothing: no wrapper reads the card."""
    a, b = tile_composite_cuda(*fw_args), tile_composite_cuda(*fw_args)
    rows = torch.arange(a.entry_p.shape[1], device=a.nch.device)
    valid = (rows[None, :] < a.nch[:, None])[:, :, None]
    same = (all(torch.equal(x, y) for x, y in zip(a[:3] + (a.nch,), b[:3] + (b.nch,)))
            and torch.equal(torch.where(valid, a.entry_p, 0.0), torch.where(valid, b.entry_p, 0.0)))
    check(same, "K1: two launches give bit-identical outputs")
    same = torch.equal(tile_composite_bwd_cuda(*bwd_args), tile_composite_bwd_cuda(*bwd_args))
    check(same, "K2: two launches give bit-identical outputs")
    check(torch.equal(segment_sum_cuda(*k3_args), segment_sum_cuda(*k3_args)),
          "K3: two launches give bit-identical outputs")
    torch.cuda.synchronize()
    err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        tile_composite_cuda(*fw_args)
        tile_composite_bwd_cuda(*bwd_args)
        segment_sum_cuda(*k3_args)
    except RuntimeError as e:
        err = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[3] K1 + K2 + K3 under torch.cuda.set_sync_debug_mode('error'): {err or 'no sync'}")
    check(err is None, "no wrapper reads the card (sync debug mode 'error')")


def deepest_alone(fw_args, nch, bwd_args) -> dict:
    """K1 and K2 (CUDA events) on the same inputs with every tile_count
    zeroed except the tile of most processed chunks: the serial walk's
    share of the whole kernel."""
    start, count, dup, tiles_x, ch, mc = fw_args
    t = int(torch.argmax(nch))
    solo = torch.zeros_like(count)
    solo[t] = count[t]
    args = (start, solo, dup, tiles_x, ch, mc)
    out = tile_composite_cuda(*args)
    g_img, gt_total = bwd_args[4:6]
    bargs = (start, solo, out.nch, dup, g_img, gt_total, out.final_t, out.entry_p, tiles_x, ch, mc)
    return dict(tile=t, nch=int(nch[t]),
                k1_ms=cuda_ms(lambda: tile_composite_cuda(*args), reps=20, warmup=2),
                k2_ms=cuda_ms(lambda: tile_composite_bwd_cuda(*bargs), reps=10, warmup=2))


def check_k3(check, ct, gid, n, label: str, tol_scale: float = 1.0, tag: str = "[3]") -> float:
    """K3 against its plain version on one case, and a second launch into a
    NaN-filled output through the wrapper's launch helper: an element the
    kernel fails to write stays NaN. Returns the max abs error."""
    kern = segment_sum_cuda(ct, gid, n)
    poisoned = segment_sum_into(ct, gid, n, torch.full((ct.shape[0], n), float("nan"),
                                                       device=ct.device))
    torch.cuda.synchronize()
    plain = segment_sum_plain(ct, gid, n)
    diff = (kern - plain).abs()
    err = float(diff.max())
    atol = SEGSUM_TOL * tol_scale
    print(f"{tag} K3 vs plain, {label}: rows {ct.shape[0]}, slots {ct.shape[1]}, n {n}, "
          f"max abs err {err:.3e} (atol {atol:.3e}, rtol {SEGSUM_TOL})")
    check(bool((diff <= atol + SEGSUM_TOL * plain.abs()).all()) and tuple(kern.shape)
          == (ct.shape[0], n), f"K3 {label} agrees with the plain version")
    check(torch.equal(kern, poisoned),
          f"K3 {label}: a launch into a NaN-filled output writes every element, bit-identical "
          f"to the first launch")
    return err


def segment_stats(gid_sorted: torch.Tensor, n: int) -> dict:
    """Distinct live ids and the mean, p99 and max slots per live id."""
    live = gid_sorted[(gid_sorted >= 0) & (gid_sorted < n)]
    seg = torch.sort(torch.bincount(live.long(), minlength=n)).values
    seg = seg[seg > 0].to(torch.float64)
    return dict(live_slots=int(live.numel()), distinct_ids=int(seg.numel()),
                mean=float(seg.mean()), p99=float(seg[int(0.99 * (seg.numel() - 1))]),
                max=float(seg[-1]))


def backward_parts(ct16: torch.Tensor, gid: torch.Tensor, n: int, live: int) -> dict:
    """Device ms (torch.profiler, busy time) of each step of
    GatherDup.backward on these inputs, each step profiled alone as the
    backward runs it, and of the whole backward through autograd."""
    exact = torch.tensor(True, device=ct16.device)
    gid_sorted, perm = torch.sort(gid.to(torch.int32), stable=True)
    y = ct16[:live].index_select(1, perm).contiguous()
    d = segment_sum_cuda(y, gid_sorted, n)
    rows = ct16.shape[0]
    steps = {
        "sort": lambda: torch.sort(gid.to(torch.int32), stable=True),
        "index_select": lambda: ct16[:live].index_select(1, perm).contiguous(),
        "K3": lambda: segment_sum_cuda(y, gid_sorted, n),
        "cat + where": lambda: torch.where(
            exact, torch.cat([d, d.new_zeros((rows - live, n))], dim=0), 0.0),
    }
    out = {}
    for name, fn in steps.items():
        _, busy, ranked = profile_device(fn, top=None)
        out[name] = (busy, ranked)
    packed = torch.zeros((rows, n), device=ct16.device, requires_grad=True)
    dup = gather_dup(packed, gid, n, exact, live)
    _, busy, ranked = profile_device(
        lambda: torch.autograd.grad(dup, packed, ct16, retain_graph=True), top=None)
    out["whole backward"] = (busy, ranked)
    return out


def phase_card_vs_cpu(check, dev) -> None:
    """render_params + loss backward on a small scene: card against CPU."""
    means, scales, quats, opac, colors = small_scene()
    n = means.shape[0]
    rest = np.random.default_rng(7).normal(0, 0.2, (n, 3, 15)).astype(np.float32)
    d, alive = pad_fields(dict(
        xyz=means, sh_dc=(colors - 0.5) / C0, sh_rest=rest,
        opacity_logit=np.log(opac / (1 - opac)), log_scales=np.log(scales), quaternions=quats,
    ), 224)
    target = np.random.default_rng(0).uniform(0, 1, (48, 64, 3)).astype(np.float32)

    def grads(device):
        p = params_from_numpy(d, device=device)
        leaves = [getattr(p, f).requires_grad_(True) for f in PARAM_FIELDS]
        off = torch.zeros((d["xyz"].shape[0], 2), device=device, requires_grad=True)
        cam = make_camera(np.eye(3), np.zeros(3), 1.2, 1.0, 48, 64, device=device)
        out = render_params(GaussianParams(**dict(zip(PARAM_FIELDS, leaves))),
                            torch.as_tensor(alive, device=device), cam, 3,
                            torch.tensor([0.1, 0.2, 0.3], device=device), ndc_offset=off,
                            dup_capacity=8192, k_max=512)
        loss = (torch.mean((out["image"] - torch.as_tensor(target, device=device)) ** 2)
                + 0.1 * torch.mean(out["final_T"]))
        g = torch.autograd.grad(loss, leaves + [off])
        return float(loss), {k: x.cpu() for k, x in zip(list(PARAM_FIELDS) + ["ndc_offset"], g)}

    reset_launches()
    loss_card, g_card = grads(dev)
    torch.cuda.synchronize()
    counts = launches()
    loss_cpu, g_cpu = grads("cpu")
    rows = {}
    for k in g_cpu:
        scale = float(g_cpu[k].abs().max())
        rows[k] = (float((g_card[k] - g_cpu[k]).abs().max()), scale)
    print(f"[5] card vs CPU, 200-Gaussian SH-3 scene at 48x64: loss {loss_card:.7f} / "
          f"{loss_cpu:.7f}; launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts}")
    for k, (err, scale) in rows.items():
        print(f"    d {k}: max abs diff {err:.3e}, max|g| {scale:.3e}")
    check(counts == (1,) * 6, "card run launched K1, K2, K3, the binning, the preprocess kernel "
          "and its backward once each")
    check(abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu), "card loss equals the CPU loss")
    check(all(err <= CARD_CPU_RTOL * scale + 1e-9 and scale > 0 for err, scale in rows.values()),
          f"card gradients within {CARD_CPU_RTOL} x max|g| of the CPU's")


def phase_fwd_bwd(check, dev, settings) -> dict:
    """bench.py's fwd+bwd at full width: the trained 1M scene's raw arrays,
    loss = sum(image^2), gradients of the five inputs."""
    arrays = bench._scene_trained(N_GAUSS, np.random.default_rng(SCENE_SEED))
    raw = [torch.as_tensor(x, device=dev).requires_grad_(True) for x in arrays]

    def fwd_bwd():
        out = rasterize_gaussians(
            raw[0], raw[3], settings, scales=raw[1], quaternions=raw[2], colors=raw[4],
            dup_capacity=CAPS.dup_capacity, tile_cap=CAPS.tile_cap, k_max=CAPS.k_max,
        )
        loss = torch.sum(out["image"] ** 2)
        return out, torch.autograd.grad(loss, raw)

    reset_launches()
    out, g = fwd_bwd()
    torch.cuda.synchronize()
    counts = launches()
    ovf = adaptive.read_overflow(out)
    print(f"[6] fwd+bwd, 1M trained scene, 512x512: overflow {json.dumps(ovf)}; "
          f"launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts}")
    check(counts == (1, 1, 1, 1, 0, 0), "fwd+bwd launched K1, K2, K3 and the binning once each "
          "(rasterize_gaussians: the torch preprocess)")
    check(all(ovf[k] == 0 for k in ("bin_overflow", "big_overflow", "cap_overflow",
                                    "tile_overflow")), "fwd+bwd overflow counters all 0")
    check(all(bool(torch.isfinite(x).all()) for x in g) and float(g[0].abs().max()) > 0,
          "fwd+bwd gradients finite and nonzero")
    ms = cuda_ms(fwd_bwd, reps=5)
    return dict(ms=ms, rays_per_s=H * W / (ms / 1e3))


def phase_train(check, dev, cams) -> dict:
    """train_vanilla_3dgs at full width, then the step timed and traced."""
    fields, alive = pad_fields(train_scene_fields(TRAIN_N, TRAIN_SEED), TRAIN_CAPACITY)
    target_model = model_from_numpy(fields, alive, 0, device=dev)
    targets = []
    for cam in cams:
        out, _ = adaptive.render_adaptive(render_model, TRAIN_CAPS, target_model, cam)
        targets.append(torch.clamp(out["image"], 0.0, 1.0))
    perturbed = dict(fields)
    noise = np.random.default_rng(TRAIN_SEED + 1).normal(0, 0.5, fields["sh_dc"].shape)
    perturbed["sh_dc"] = (fields["sh_dc"] + np.where(alive[:, None], noise, 0)).astype(np.float32)
    model = model_from_numpy(perturbed, alive, 0, device=dev)
    cfg = TrainConfig(
        iterations=TRAIN_ITERS, sh_degree=0, capacity=TRAIN_CAPACITY,
        dup_capacity_mult=4, k_max=TRAIN_CAPS.k_max,
        # Densify after iteration 25 and reset after 30 (the last): the
        # loss is read over the 25 iterations before either.
        densify_from=20, densify_every=25, opacity_reset_every=TRAIN_ITERS, log_every=1,
        optim=opt.OptimConfig(feature_lr=0.02),
    )
    logs: list[dict] = []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train_vanilla_3dgs(cams, targets, None, None, 1.0, cfg, seed=0,
                               log_fn=logs.append, model=model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = counts = launches()
    steps = [r for r in logs if "loss" in r]
    dens_events = [r for r in logs if "n_split" in r]
    resets = [r for r in logs if r.get("event") == "opacity_reset"]
    grows = [r for r in logs if r.get("event") == "cap_grow"]
    losses = [r["loss"] for r in steps]
    print(f"[7] training: {TRAIN_ITERS} iterations, {TRAIN_N} Gaussians in {TRAIN_CAPACITY} "
          f"slots, {wall:.2f} s wall; launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts}")
    print(f"    losses: {', '.join(f'{x:.5f}' for x in losses)}")
    for r in dens_events + resets + grows:
        print(f"    {json.dumps(r)}")
    ovf_steps = [r["iter"] for r in steps
                 if any(r.get(k, 0) for k in ("bin_overflow", "big_overflow", "cap_overflow",
                                              "tile_overflow"))]
    print(f"    iterations with an overflow counter > 0: {ovf_steps}; n_alive at the end "
          f"{int(state.model.alive.sum())}")
    check(counts == (TRAIN_ITERS,) * 6,
          "training: one K1, one binning and one preprocess launch per render, one K2, K3 and "
          "preprocess backward launch per backward")
    check(len(losses) == TRAIN_ITERS and all(math.isfinite(x) for x in losses),
          "training: every loss finite")
    first, late = statistics.mean(losses[:5]), statistics.mean(losses[20:25])
    check(late < first, f"training: loss falls (iterations 1-5 mean {first:.5f}, "
                        f"21-25 mean {late:.5f})")
    check(len(dens_events) >= 1 and len(resets) >= 1, "training: densify and reset each ran")
    check(all(bool(torch.isfinite(getattr(state.model.params, f)).all()) for f in PARAM_FIELDS)
          and all(bool(torch.isfinite(getattr(state.adam.nu, f)).all()) for f in PARAM_FIELDS),
          "training: params and Adam state finite")

    # The train step alone, from the trained state: CUDA events per step.
    lrs = opt.group_lrs(cfg.optim, spatial_lr_scale=1.0)
    caps = TRAIN_CAPS
    params, adam, stats = state.model.params, state.adam, state.stats
    alive_t = state.model.alive
    for _ in range(4):  # the trainer's growth rule, until a step drops nothing
        step = make_train_step(cfg, lrs, 0, caps)
        _, _, _, aux = step(params, alive_t, adam, stats, cams[0], targets[0], TRAIN_ITERS)
        ovf = adaptive.read_overflow(aux)
        if not adaptive.overflowed(ovf):
            break
        caps = caps.grown(ovf)
    ms, auxes = [], []
    reset_launches()
    for i in range(TIMED_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, adam, stats, aux = step(params, alive_t, adam, stats, cams[i % len(cams)],
                                        targets[i % len(cams)], TRAIN_ITERS + i)
        e1.record()
        ms.append((e0, e1))
        auxes.append(aux)
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in ms]
    timed_counts = launches()
    ovf_any = [adaptive.read_overflow(a) for a in auxes]
    zero = all(not adaptive.overflowed(o) and o.get("big_overflow", 0) == 0 for o in ovf_any)
    check(zero, "timed train steps: overflow counters all 0")
    check(timed_counts == (TIMED_STEPS,) * 6,
          "timed train steps: one launch of each kernel per step")
    wall_ms, busy_ms, ranked = profile_device(
        lambda: step(params, alive_t, adam, stats, cams[0], targets[0], TRAIN_ITERS), top=None)
    # index_add_ (and so autograd's index_select backward) runs an
    # indexFunc kernel with ReduceAdd; scatter_add_ the scatter-gather
    # kernel with ReduceAdd (a gather runs it with TensorAssign).
    def is_fallback(name: str) -> bool:
        return "ReduceAdd" in name and ("indexFunc" in name or "scatter_gather" in name)

    fallbacks = [k for k, _, _ in ranked if is_fallback(k)]
    print(f"    train step kernels: {len(ranked)} distinct, {sum(c for _, _, c in ranked)} launches; "
          f"index_add_/scatter-add kernels: {fallbacks}")
    check(not fallbacks, "train step ran no index_add_ or scatter-add kernel")
    # Control: the test sees both kernels when they do run. One profile of
    # these few tiny launches once came back with no device record at all
    # (an empty list, while the step's profile just before held 1,886
    # launches), so the control takes up to three profiles and prints every
    # kernel each one saw.
    idx = torch.tensor([0, 2, 2], device=dev)
    src = torch.ones((4, 3), device=dev)
    for attempt in range(3):
        _, _, seen = profile_device(
            lambda: (torch.zeros((4, 5), device=dev).index_add_(1, idx, src),
                     torch.zeros(5, device=dev).scatter_add_(0, idx, src[0])), top=None)
        ctl = [k for k, _, _ in seen if is_fallback(k)]
        print(f"    control, profile {attempt + 1}: index_add_ + scatter_add_ {ctl}; every kernel "
              f"{[kernel_name(k)[:60] for k, _, _ in seen]}")
        if len(ctl) >= 2:
            break
    check(len(ctl) >= 2, "the fallback test finds index_add_ and scatter_add_ when they run")
    top = ranked[:12]
    k3_in_step = [(ms, calls) for k, ms, calls in ranked if "segment_sum" in k]
    return dict(step_ms=statistics.median(step_ms), step_ms_all=step_ms, caps=caps,
                wall_ms=wall_ms, busy_ms=busy_ms, top=top, launches=train_counts,
                k3_in_step=k3_in_step, targets=targets)


# --- [9] coarse SuGaR ---------------------------------------------------

# The coarse window: CoarseConfig's defaults (1M samples, K 16, KNN reset
# every 500, prune at 9000, SDF from 9001) over iterations 8991-9010.
COARSE_START, COARSE_END = 8_990, 9_010
COARSE_MILESTONE = 9_000
DENSITY_STEPS = 5
KNN_CHECK_QUERIES = 4096
FIELD_SLICE = 65_536
# Field query, card against CPU on a 65,536-sample slice: values rtol
# FIELD_RTOL (atol FIELD_RTOL x max|value|: sdf's sqrt(-2 ln d) turns the
# last bit of exp into more near the density ceiling), gradients within
# FIELD_GRAD_RTOL x max|g| per parameter.
FIELD_RTOL = 1e-5
FIELD_GRAD_RTOL = 1e-4


def knn_tol(q_sq: torch.Tensor) -> torch.Tensor:
    """Bound on the float32 formula's error, ||q||^2 - 2 q.r + ||r||^2
    with ~5 roundings on terms up to ~4 ||q||^2 for a near neighbor:
    2^-19 (1 + ||q||^2)."""
    return 2.0**-19 * (1.0 + q_sq)


def check_knn(check, label: str, xyz: torch.Tensor, alive: torch.Tensor, d: torch.Tensor,
              idx: torch.Tensor, k: int, seed: int) -> dict:
    """KNN on the card against a float64 cdist and a sorted top-(k+1) on the
    card, for KNN_CHECK_QUERIES random queries at alive Gaussians: each
    returned distance is its pair's (within knn_tol), each j-th returned
    neighbor is at the exact j-th distance (within 2 knn_tol), and the
    index sets are equal on every row whose exact k-th and (k+1)-th
    distances differ by more than twice the float32 formula's error on
    that row's k + 1 reference neighbors (the formula, evaluated on the
    card, cannot reorder them)."""
    g = torch.Generator(device=xyz.device).manual_seed(seed)
    cand = alive.nonzero()[:, 0]  # queries at alive Gaussians, as the coarse stage reads them
    rows = cand[torch.randint(0, cand.numel(), (KNN_CHECK_QUERIES,), generator=g,
                              device=xyz.device)]
    refs64 = xyz.double()
    errs = dict(pair=0.0, rank=0.0)
    same_sets = checked = 0
    dead_returned = 0
    for c0 in range(0, KNN_CHECK_QUERIES, 256):
        r = rows[c0:c0 + 256]
        q64 = refs64[r]
        ex = torch.cdist(q64, refs64, compute_mode="donot_use_mm_for_euclid_dist") ** 2
        ex = ex.masked_fill(~alive[None, :], float("inf"))
        top_d, top_i = torch.topk(ex, k + 1, dim=1, largest=False, sorted=True)
        tol = knn_tol((q64 * q64).sum(-1))
        got_d, got_i = d[r].double(), idx[r]
        pair = ex.gather(1, got_i)
        errs["pair"] = max(errs["pair"], float(((got_d - pair).abs() / tol[:, None]).max()))
        errs["rank"] = max(errs["rank"], float(((pair - top_d[:, :k]).abs() / tol[:, None]).max()))
        dead_returned += int((~alive[got_i]).sum())
        # The float32 formula on each row's k + 1 reference neighbors.
        q32, r32 = xyz[r][:, None, :], xyz[top_i]
        dot = q32[..., 0] * r32[..., 0]
        dot.addcmul_(q32[..., 1], r32[..., 1])
        dot.addcmul_(q32[..., 2], r32[..., 2])
        f32 = torch.sub((q32 * q32).sum(-1), dot, alpha=2.0).add_((r32 * r32).sum(-1))
        row_err = (f32.double() - top_d).abs().max(dim=1).values
        clear = (top_d[:, k] - top_d[:, k - 1]) > 2 * row_err
        a = torch.sort(got_i[clear], dim=1).values
        b = torch.sort(top_i[clear, :k], dim=1).values
        same_sets += int((a == b).all(dim=1).sum())
        checked += int(clear.sum())
        del ex
    out = dict(queries=KNN_CHECK_QUERIES, pair_err_over_tol=errs["pair"],
               rank_err_over_tol=errs["rank"], gap_rows=checked, gap_rows_equal=same_sets,
               dead_returned=dead_returned)
    print(f"[9] KNN vs float64 cdist + sorted top-(k+1), {label}: {json.dumps(out)}")
    check(errs["pair"] <= 1.0 and errs["rank"] <= 2.0 and dead_returned == 0,
          f"KNN {label}: distances within the float32 bound of the float64 reference")
    check(same_sets == checked and checked > 0,
          f"KNN {label}: index sets equal wherever the k-th/(k+1)-th gap exceeds twice the "
          f"float32 error")
    return out


def check_knn_ties(check, dev) -> None:
    """Exact duplicates on the card: small chunks (many blocks, duplicate
    groups across block boundaries) give the stable-sorted lexicographic
    top-k of the full distance matrix, lower index first among equals."""
    g = np.random.default_rng(21)
    base = g.uniform(-1, 1, (3000, 3)).astype(np.float32)
    pts = torch.as_tensor(np.concatenate([base, base[:900], base[500:1400],
                                          np.repeat(base[7:8], 40, 0)]), device=dev)
    mask = torch.as_tensor(g.uniform(size=len(pts)) > 0.1, device=dev)
    k = 16
    d, i = knn(pts, pts, k, mask, q_chunk=128, r_chunk=300)
    full = knn_sq_dists(pts, (pts * pts).sum(-1, keepdim=True), torch.where(mask[:, None], pts, 0.0),
                        torch.where(mask, (pts * pts).sum(-1), float("inf")))
    ref_d, ref_i = torch.sort(full, dim=1, stable=True)
    ok_i = torch.equal(i, ref_i[:, :k])
    ok_d = torch.equal(d, torch.clamp_min(ref_d[:, :k], 0.0))
    ties = int((d[:, 1:] == d[:, :-1]).sum())
    print(f"[9] KNN exact duplicates ({len(pts)} points, q_chunk 128, r_chunk 300): "
          f"{ties} equal-distance neighbor pairs; indices equal to the stable sort {ok_i}, "
          f"distances {ok_d}")
    check(ok_i and ok_d and ties > 1000, "KNN on the card lists the lower index first among "
          "equal distances, independent of the chunks")


def cuda_once_ms(fn):
    """(result, ms) of one fn() call by CUDA events."""
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    r = fn()
    e1.record()
    torch.cuda.synchronize()
    return r, e0.elapsed_time(e1)


def field_leaves(model):
    """The activated field params of a model as fresh leaves."""
    return df.GaussianFieldParams(
        model.params.xyz.detach().clone().requires_grad_(True),
        model.scales.detach().clone().requires_grad_(True),
        model.quaternions.detach().clone().requires_grad_(True),
        model.opacities.detach().clone().requires_grad_(True),
    )


def field_loss(gp, draw, nidx_table, alive, n):
    """sum(sdf) + sum(density) of the coarse SDF query at n samples."""
    samples, src = df.sample_points_in_gaussians(draw, n, gp, alive, sampling_scale_factor=1.5,
                                                 prob_proportional_to_volume=False)
    out = df.field_values(samples, nidx_table[src], gp, density_factor=1.0 / 16.0)
    return out, (out["sdf"].sum() + out["density"].sum())


def phase_field(check, dev, model, knn_idx) -> dict:
    """The coarse field query at full width (1M samples x 16 neighbors on
    the 1M SH-3 scene) timed on the card, and a 65,536-sample slice of it
    held against the CPU."""
    n = CoarseConfig().n_samples_for_sdf_regularization
    gp = field_leaves(model)
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        idx = torch.multinomial(model.alive.float(), n, replacement=True, generator=gen)
        noise = torch.randn((n, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, loss = field_loss(gp, (idx, noise), knn_idx, model.alive, n)
    g_card = torch.autograd.grad(loss, list(gp))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del loss
    fwd_ms = cuda_ms(lambda: field_loss(gp, (idx, noise), knn_idx, model.alive, n), reps=5)
    bwd = []
    for _ in range(5):
        _, l5 = field_loss(gp, (idx, noise), knn_idx, model.alive, n)
        _, ms = cuda_once_ms(lambda: torch.autograd.grad(l5, list(gp)))
        bwd.append(ms)
    # The slice: the same draw on the card and on the CPU.
    sl = slice(0, FIELD_SLICE)
    out_s, loss_s = field_loss(gp, (idx[sl], noise[sl]), knn_idx, model.alive, FIELD_SLICE)
    g_s = [x.cpu() for x in torch.autograd.grad(loss_s, list(gp))]
    gp_cpu = df.GaussianFieldParams(*(x.detach().cpu().requires_grad_(True) for x in gp))
    out_c, loss_c = field_loss(gp_cpu, (idx[sl].cpu(), noise[sl].cpu()), knn_idx.cpu(),
                               model.alive.cpu(), FIELD_SLICE)
    g_c = torch.autograd.grad(loss_c, list(gp_cpu))
    val_ok, rows = True, {}
    for key in ("density", "sdf"):
        a, b = out_s[key].detach().cpu(), out_c[key].detach()
        err = float((a - b).abs().max())
        rows[key] = err
        val_ok &= bool(((a - b).abs() <= FIELD_RTOL * (b.abs() + b.abs().max())).all())
    grad_ok = True
    for name, a, b in zip(df.GaussianFieldParams._fields, g_s, g_c):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        rows[f"d_{name}"] = (err, scale)
        grad_ok &= err <= FIELD_GRAD_RTOL * scale and scale > 0
    print(f"[9] field query card vs CPU, {FIELD_SLICE} samples x 16 neighbors of the 1M SH-3 "
          f"scene: {json.dumps(rows)}")
    check(val_ok, f"field query density and sdf on the card within rtol {FIELD_RTOL} of the CPU's")
    check(grad_ok, f"field query gradients on the card within {FIELD_GRAD_RTOL} x max|g| of the CPU's")
    finite = all(bool(torch.isfinite(x).all()) for x in (*out.values(), *g_card))
    check(finite and tuple(out["sdf"].shape) == (n,), "field query at full width finite, (1M,)")
    res = dict(fwd_ms=fwd_ms, bwd_ms=statistics.median(bwd), peak_gb=peak / 1e9)
    print(f"[9] field query at full width ({n} samples x 16 neighbors, 1M SH-3 scene): forward "
          f"{res['fwd_ms']:.3f} ms (mean of 5, sampling included), backward "
          f"{res['bwd_ms']:.3f} ms (median of 5), peak memory of one forward + backward above "
          f"the model {res['peak_gb']:.3f} GB")
    return res


def coarse_model(dev):
    """The coarse stage's start: the 2^18 training scene at SH degree 3
    (zero higher coefficients: the renders equal the SH-0 targets' colors),
    a seeded eighth of its Gaussians at opacity U(0.05, 0.45) so the prune
    removes them, through save_ply and load_ply(device="cuda") into
    327,680 slots, as the pipeline starts from the vanilla model's PLY."""
    fields = train_scene_fields(TRAIN_N, TRAIN_SEED)
    g = np.random.default_rng(TRAIN_SEED + 5)
    low = g.choice(TRAIN_N, TRAIN_N // 8, replace=False)
    op = g.uniform(0.05, 0.45, low.size)
    fields["opacity_logit"][low] = np.log(op / (1 - op)).astype(np.float32)
    fields["sh_rest"] = np.zeros((TRAIN_N, 3, 15), np.float32)
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "coarse_start.ply")
    save_ply(model_from_numpy(fields, np.ones(TRAIN_N, bool), 3, device="cpu"), path)
    model = load_ply(path, capacity=TRAIN_CAPACITY, device=dev)
    os.remove(path)
    return model, low


def phase_coarse(check, dev, cams, targets) -> dict:
    """train_coarse in 'sdf' mode over the window around the prune, its
    milestone and resume, five 'density' steps, then the step timed and
    profiled."""
    model, low = coarse_model(dev)
    extent = nerfpp_extent(np.stack([c.cam_center.cpu().numpy() for c in cams]))
    cfg = CoarseConfig(start_iteration=COARSE_START, num_iterations=COARSE_END,
                       checkpoint_iterations=(COARSE_MILESTONE,), log_every=1)
    ckpt_dir = os.path.join(WORK, "coarse_milestones")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    saved = {}
    save_milestone = coarse_mod.ckpt.save_milestone

    def recording_save(base, it, state):  # keep the saved state to hold the restore to
        saved.update(it=it, state={k: v for k, v in state.items()})
        return save_milestone(base, it, state)

    logs, per_iter = [], []

    def log(r):
        logs.append(r)
        if "loss" in r:
            per_iter.append((r["iter"], launches()))

    coarse_mod.ckpt.save_milestone = recording_save
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_coarse(model, cams, targets, extent, cfg, seed=0, log_fn=log,
                           checkpoint_dir=ckpt_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        coarse_mod.ckpt.save_milestone = save_milestone
    steps = [r for r in logs if "loss" in r]
    knn_builds = [r["iter"] for r in logs if r.get("event") == "knn"]
    grows = [r for r in logs if r.get("event") == "cap_grow"]
    deltas, prev = {}, (0,) * 6
    for it, c in per_iter:
        deltas[it] = tuple(a - b for a, b in zip(c, prev))
        prev = c
    print(f"[9] train_coarse 'sdf', {TRAIN_N} Gaussians ({low.size} at low opacity) in "
          f"{TRAIN_CAPACITY} slots, iterations {COARSE_START + 1}-{COARSE_END}, extent "
          f"{extent:.4f}: {wall:.2f} s wall; KNN builds at {knn_builds}; cap growths to "
          f"(k_max, tile_cap, dup_capacity) "
          f"{[(r['new']['k_max'], r['new']['tile_cap'], r['new']['dup_capacity']) for r in grows]}")
    for r in steps:
        print(f"    iter {r['iter']}: loss {r['loss']:.6f}, psnr {r['psnr']:.3f}, n_alive "
              f"{r['n_alive']}, launches (K1, K2, K3, binning, preprocess, preprocess bwd) {deltas[r['iter']]}, overflow "
              f"{[r.get(k, 0) for k in ('bin_overflow', 'big_overflow', 'cap_overflow', 'tile_overflow')]}")
    n_alive = {r["iter"]: r["n_alive"] for r in steps}
    check(len(steps) == COARSE_END - COARSE_START and all(math.isfinite(r["loss"]) for r in steps),
          "coarse: every loss finite")
    check(n_alive[COARSE_MILESTONE] < n_alive[COARSE_MILESTONE - 1] == TRAIN_N,
          "coarse: n_alive drops at the prune (iteration 9000)")
    check(knn_builds == [COARSE_START + 1, COARSE_MILESTONE, COARSE_MILESTONE],
          "coarse: three KNN builds (first step, the 9000 refresh, after the prune)")
    want = {it: (1,) * 6 if it <= COARSE_MILESTONE else (2,) * 4 + (1, 1) for it in deltas}
    check(deltas == want, "coarse: one launch of K1, K2, K3 and the binning per iteration through "
          "9000, two after (the depth render takes the torch preprocess); one of the preprocess "
          "kernel and its backward per iteration")
    # Each new view may overflow once (a lagged growth follows); after the
    # first pass over the 8 views and the lag, the caps cover every view.
    ovf_iters = [r["iter"] for r in steps if any(r.get(k, 0) for k in (
        "bin_overflow", "big_overflow", "cap_overflow", "tile_overflow"))]
    check(len(grows) >= 1 and all(it <= COARSE_MILESTONE for it in ovf_iters),
          f"coarse: caps grew, and overflow is 0 from iteration {COARSE_MILESTONE + 1} on "
          f"(overflows at {ovf_iters})")
    check(all(bool(torch.isfinite(getattr(out.params, f)).all()) for f in PARAM_FIELDS),
          "coarse: params finite")

    # Resume from the milestone: the restored state is the saved one, bit
    # for bit, and the run finishes.
    like = dict(params=out.params, alive=out.alive, adam=opt.init_adam(out.params),
                knn_idx=torch.zeros((TRAIN_CAPACITY, 16), dtype=torch.int64, device=dev),
                iteration=0)
    st = ckpt.restore_structured(ckpt.milestone_path(ckpt_dir, COARSE_MILESTONE), like)
    ref = ckpt._flatten(saved["state"])
    got = ckpt._flatten(st)
    exact = saved["it"] == COARSE_MILESTONE and ref.keys() == got.keys() and all(
        np.array_equal(ref[k], got[k]) for k in ref)
    rlogs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = train_coarse(model, cams, targets, extent, cfg, seed=0, log_fn=rlogs.append,
                           checkpoint_dir=ckpt_dir)
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rsteps = [r for r in rlogs if "loss" in r]
    diff = max(float((getattr(resumed.params, f) - getattr(out.params, f)).abs().max())
               for f in PARAM_FIELDS if getattr(out.params, f).numel())
    print(f"[9] resume from milestone {COARSE_MILESTONE}: {len(ref)} arrays restored "
          f"bit-exact {exact}; {len(rsteps)} iterations in {resume_wall:.2f} s, KNN builds "
          f"{[r['iter'] for r in rlogs if r.get('event') == 'knn']}; final params max |resumed - "
          f"uninterrupted| {diff:.3e} (the resumed run regrows its raster caps from the defaults, "
          f"as the JAX trainer does, and the card's scatter-adds sum in any order)")
    check(exact, "coarse: the milestone restores the saved state bit-exactly on the card")
    check({"event": "resume", "iteration": COARSE_MILESTONE} in rlogs
          and len(rsteps) == COARSE_END - COARSE_MILESTONE
          and all(math.isfinite(r["loss"]) for r in rsteps)
          and torch.equal(resumed.alive, out.alive),
          "coarse: the resumed run starts at 9000, finishes finite, same alive mask")

    # 'density' mode: one launch of each kernel per SDF-phase step.
    dlogs, dper = [], []

    def dlog(r):
        dlogs.append(r)
        if "loss" in r:
            dper.append(launches())

    dcfg = CoarseConfig(mode="density", start_iteration=COARSE_MILESTONE,
                        num_iterations=COARSE_MILESTONE + DENSITY_STEPS, log_every=1)
    reset_launches()
    dense = train_coarse(out, cams, targets, extent, dcfg, seed=0, log_fn=dlog)
    torch.cuda.synchronize()
    dd = [tuple(a - b for a, b in zip(c, p)) for c, p in zip(dper, [(0,) * 6] + dper[:-1])]
    dsteps = [r for r in dlogs if "loss" in r]
    print(f"[9] train_coarse 'density', {DENSITY_STEPS} SDF-phase steps: losses "
          f"{[round(r['loss'], 6) for r in dsteps]}; launches per step {dd}")
    check(dd == [(1,) * 6] * DENSITY_STEPS and all(math.isfinite(r["loss"]) for r in dsteps)
          and all(bool(torch.isfinite(getattr(dense.params, f)).all()) for f in PARAM_FIELDS),
          "coarse 'density': one launch of each kernel per step (no depth render), finite")
    return dict(model=out, extent=extent, cfg=cfg, wall_s=wall, resume_s=resume_wall)


def time_coarse_step(check, dev, cams, targets, state) -> dict:
    """The 'sdf' step at full width: 10 steps by CUDA events, one under the
    profiler, its peak memory, and the device time of its parts."""
    cfg, model = state["cfg"], state["model"]
    lrs = opt.group_lrs(cfg.optim, spatial_lr_scale=state["extent"])
    params, alive = model.params, model.alive
    (_, knn_idx), knn_ms = cuda_once_ms(lambda: knn(params.xyz, params.xyz, 16, alive))
    adam = opt.init_adam(params)
    caps = adaptive.RasterCaps(tile_cap=16, dup_capacity=cfg.dup_capacity_mult * TRAIN_CAPACITY,
                               k_max=cfg.k_max)
    it = COARSE_END
    for _ in range(4):  # the trainer's growth rule, until no view's step drops anything
        grew = False
        for cam, target in zip(cams, targets):
            step = make_coarse_step(cfg, lrs, state["extent"], TRAIN_CAPACITY, False, True, caps)
            _, _, aux = step(params, alive, adam, knn_idx, cam, target, it,
                             iteration_generator(0, it, dev))
            ovf = adaptive.read_overflow(aux)
            if adaptive.overflowed(ovf):
                caps, grew = caps.grown(ovf), True
        if not grew:
            break
    ms, auxes = [], []
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for i in range(TIMED_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, adam, aux = step(params, alive, adam, knn_idx, cams[i % len(cams)],
                                 targets[i % len(cams)], it + i, iteration_generator(0, it + i, dev))
        e1.record()
        ms.append((e0, e1))
        auxes.append(aux)
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in ms]
    peak = torch.cuda.max_memory_allocated() - base
    counts = launches()
    check(counts == (2 * TIMED_STEPS,) * 4 + (TIMED_STEPS,) * 2,
          "timed 'sdf' steps: two launches of K1, K2, K3 and the binning per step, one of the "
          "preprocess kernel and its backward")
    check(all(not adaptive.overflowed(adaptive.read_overflow(a)) for a in auxes)
          and all(math.isfinite(float(a["loss"])) for a in auxes),
          "timed 'sdf' steps: overflow 0, losses finite")
    wall_ms, busy_ms, ranked = profile_device(
        lambda: step(params, alive, adam, knn_idx, cams[0], targets[0], it,
                     iteration_generator(0, it, dev)), top=None)

    # The parts, each profiled alone on the step's inputs.
    leaves = [getattr(params, f).detach().requires_grad_(True) for f in PARAM_FIELDS]
    p = GaussianParams(**dict(zip(PARAM_FIELDS, leaves)))
    bg = torch.zeros(3, device=dev)
    kw = dict(dup_capacity=caps.dup_capacity, k_max=caps.k_max, tile_cap=caps.tile_cap,
              cap_a=caps.cap_a, big_cap=caps.big_cap)

    def rgb():
        img = render_params(p, alive, cams[0], cfg.sh_degree, bg, **kw)["image"]
        return torch.autograd.grad(img.sum(), leaves, allow_unused=True)

    def depth():
        zs = p.xyz @ cams[0].world_view[2, :3] + cams[0].world_view[2, 3]
        img = coarse_mod._render_depth(p, alive, cams[0], zs, torch.where(alive, zs, 0.0).amax(),
                                       **kw)
        return torch.autograd.grad(img.sum(), leaves, allow_unused=True)

    gp = df.GaussianFieldParams(p.xyz, torch.exp(p.log_scales), quat_normalize(p.quaternions),
                                torch.sigmoid(p.opacity_logit))
    gen = torch.Generator(device=dev).manual_seed(9)
    n = cfg.n_samples_for_sdf_regularization
    samples, src = df.sample_points_in_gaussians(gen, n, gp, alive, sampling_scale_factor=1.5,
                                                 prob_proportional_to_volume=False)
    nidx = knn_idx[src]
    holder = {}

    def field_fwd():
        holder["out"] = df.field_values(samples, nidx, gp, density_factor=cfg.density_factor)

    field_fwd()
    parts = {}
    parts["RGB render fwd+bwd"] = profile_device(rgb, top=None)[1]
    parts["depth render fwd+bwd"] = profile_device(depth, top=None)[1]
    parts["field query fwd"] = profile_device(field_fwd, top=None)[1]
    parts["field query bwd"] = profile_device(
        lambda: torch.autograd.grad(holder["out"]["sdf"].sum(), leaves, retain_graph=True,
                                    allow_unused=True), top=None)[1]
    normals = df.smallest_axes(gp.scales, gp.quaternions)

    def better_normal():
        bn = coarse_mod._better_normal_loss(samples, src, nidx, gp, normals, cfg.density_factor)
        return torch.autograd.grad(bn, leaves, retain_graph=True, allow_unused=True)

    parts["better-normal fwd+bwd"] = profile_device(better_normal, top=None)[1]
    print(f"[9] coarse 'sdf' step at full width ({TRAIN_CAPACITY} slots, "
          f"{int(alive.sum())} alive, {n} samples x 16 neighbors): median "
          f"{statistics.median(step_ms):.3f} ms of {TIMED_STEPS} "
          f"({', '.join(f'{v:.3f}' for v in step_ms)}); launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts} over "
          f"{TIMED_STEPS} steps; peak memory above the state {peak / 1e9:.3f} GB; caps {caps}")
    print(f"    under torch.profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
          f"share {1.0 - busy_ms / wall_ms:.3f}; {len(ranked)} distinct kernels, "
          f"{sum(c for _, _, c in ranked)} launches")
    for name, t_ms, calls in ranked[:12]:
        print(f"      {t_ms:8.3f} ms  {calls:4d}x  {name[:100]}")
    print("    device busy ms of the parts, each profiled alone: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    print(f"    KNN of the post-prune state ({TRAIN_CAPACITY} queries and refs): {knn_ms:.1f} ms")
    return dict(step_ms=statistics.median(step_ms), busy_ms=busy_ms, wall_ms=wall_ms,
                peak_gb=peak / 1e9, parts=parts, knn_post_ms=knn_ms)


def phase_knn(check, dev, serve_model) -> dict:
    """KNN (k 16) on the card over the 2^18 training scene (327,680 slots)
    and the 1M serving scene, timed by CUDA events, checked against float64
    references; and the duplicate-point case."""
    fields, alive = pad_fields(train_scene_fields(TRAIN_N, TRAIN_SEED), TRAIN_CAPACITY)
    xyz = torch.as_tensor(fields["xyz"], device=dev)
    alive_t = torch.as_tensor(alive, device=dev)
    (d_t, i_t), ms_t = cuda_once_ms(lambda: knn(xyz, xyz, 16, alive_t))
    (d_s, i_s), ms_s = cuda_once_ms(lambda: knn(serve_model.params.xyz, serve_model.params.xyz, 16,
                                                serve_model.alive))
    print(f"[9] KNN (k 16, q_chunk 4096, r_chunk 16384) on {card_line()}: 2^18 scene "
          f"({TRAIN_CAPACITY} queries and refs, {TRAIN_N} alive) {ms_t:.1f} ms; 1M scene "
          f"{ms_s:.1f} ms")
    check_knn(check, "2^18 scene", xyz, alive_t, d_t, i_t, 16, seed=1)
    check_knn(check, "1M scene", serve_model.params.xyz, serve_model.alive, d_s, i_s, 16, seed=2)
    check_knn_ties(check, dev)
    return dict(ms_train=ms_t, ms_serve=ms_s, serve_idx=i_s)


# --- [10] coarse mesh extraction ----------------------------------------

# Card against CPU, the level set of one camera of a small scene: the
# valid masks may differ on at most LEVELSET_SHARE of the pixels (a depth
# within K1's 1e-4 of the plain render's moves a density sample across
# the level); on the pixels valid in both, points within
# LEVELSET_POINT_ATOL (scene units; the sphere's radius is 0.7) and
# normals within LEVELSET_NORMAL_ATOL, except on at most LEVELSET_SHARE of
# the pixels (there the first crossing moved to the next ray segment).
LEVELSET_HW = 96
LEVELSET_SHARE = 1e-3
LEVELSET_POINT_ATOL = 1e-4
LEVELSET_NORMAL_ATOL = 1e-3


class CallTimes:
    """Replaces module functions with timed wrappers for one phase: each
    call is timed by CUDA events (``device``) or the host clock, under a
    label and the current ``tag``; ``restore`` puts the originals back."""

    def __init__(self):
        self.saved: list[tuple] = []
        self.calls: list[tuple] = []  # (label, tag, (e0, e1) or host ms)
        self.tag = None

    def wrap(self, mod, name: str, label: str, device: bool) -> None:
        orig = getattr(mod, name)
        self.saved.append((mod, name, orig))

        def timed(*args, **kwargs):
            if device:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                r = orig(*args, **kwargs)
                e1.record()
                self.calls.append((label, self.tag, (e0, e1)))
            else:
                t0 = time.perf_counter()
                r = orig(*args, **kwargs)
                self.calls.append((label, self.tag, (time.perf_counter() - t0) * 1e3))
            return r

        setattr(mod, name, timed)

    def restore(self) -> None:
        for mod, name, orig in reversed(self.saved):
            setattr(mod, name, orig)
        self.saved.clear()

    def totals(self) -> dict[tuple, list[float]]:
        """(label, tag) -> the calls' ms (synchronizes the card)."""
        torch.cuda.synchronize()
        out: dict[tuple, list[float]] = {}
        for label, tag, t in self.calls:
            out.setdefault((label, tag), []).append(t[0].elapsed_time(t[1]) if isinstance(t, tuple)
                                                    else t)
        return out


def levelset_scene(dev, n: int = 200, capacity: int = 256, seed: int = 0):
    """200 flattened Gaussians tangent to a sphere of radius 0.7 at the
    origin, in 256 slots, SH 0 (tests/test_torch_meshing.py's scene)."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.array([0.0, 0.0, 1.0])
    quats = np.concatenate([1.0 + d @ z[:, None], np.cross(z, d)], -1)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = g.uniform(0.55, 0.95, n)
    s = g.uniform(0.1, 0.16, n)
    fields, alive = pad_fields(dict(
        xyz=0.7 * d, sh_dc=(0.4 + 0.6 * np.abs(d) - 0.5) / C0, sh_rest=np.zeros((n, 3, 0)),
        opacity_logit=np.log(opac / (1 - opac)),
        log_scales=np.log(np.stack([s, s * g.uniform(0.7, 1.0, n), s * 0.2], -1)),
        quaternions=quats), capacity)
    return model_from_numpy(fields, alive, 0, device=dev)


def phase_levelset_card_vs_cpu(check, dev) -> None:
    """level_surface_points_one_camera on the card (K1) and on the CPU
    (the plain versions), one camera of the small scene."""
    th = 0.7
    R = np.array([[math.cos(th), 0.0, math.sin(th)], [0.0, 1.0, 0.0],
                  [-math.sin(th), 0.0, math.cos(th)]])
    T = -R.T @ (-R @ np.array([0.0, 0.0, 2.5]))

    def run(device):
        m = levelset_scene(device)
        cam = make_camera(R, T, 0.8, 0.8, LEVELSET_HW, LEVELSET_HW, device=device)
        out = levelset.level_surface_points_one_camera(m.params, m.alive, cam, dup_capacity=8192,
                                                       k_max=256)
        return {k: v.cpu() for k, v in out.items()}

    reset_launches()
    card = run(dev)
    counts = launches()
    cpu = run("cpu")
    pixels = LEVELSET_HW * LEVELSET_HW
    mask_diff = int((card["valid"] != cpu["valid"]).sum())
    both = card["valid"] & cpu["valid"]
    same_g = both & (card["gaussian_idx"] == cpu["gaussian_idx"])
    dp = (card["points"] - cpu["points"]).abs().amax(-1)
    dn = (card["normals"] - cpu["normals"]).abs().amax(-1)
    off = int((both & ((dp > LEVELSET_POINT_ATOL) | (dn > LEVELSET_NORMAL_ATOL))).sum())
    dd = float((card["depth"] - cpu["depth"]).abs().max())
    row = dict(pixels=pixels, valid_card=int(card["valid"].sum()), valid_cpu=int(cpu["valid"].sum()),
               mask_differs=mask_diff, gaussian_idx_differs=int((both & ~same_g).sum()),
               beyond_tol=off, depth_max_abs=dd,
               points_max_abs=float(torch.where(both, dp, 0.0).max()),
               normals_max_abs=float(torch.where(both, dn, 0.0).max()))
    print(f"[10] level set card vs CPU, 200-Gaussian sphere at {LEVELSET_HW}x{LEVELSET_HW}: "
          f"{json.dumps(row)}; launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts}")
    check(counts == (1, 0, 0, 1, 0, 0), "level set on the card: one K1 and one binning launch, no "
          "backward")
    check(mask_diff <= LEVELSET_SHARE * pixels and off <= LEVELSET_SHARE * pixels
          and row["valid_card"] > 500,
          f"level set: valid masks, points (atol {LEVELSET_POINT_ATOL}) and normals (atol "
          f"{LEVELSET_NORMAL_ATOL}) agree with the CPU's but on <= {LEVELSET_SHARE} of the pixels")


def phase_extract(check, dev, coarse_model, cams) -> dict:
    """extract_mesh_from_coarse_model at full width with ExtractConfig's
    defaults, each part timed through wrappers of the functions it calls."""
    ct = CallTimes()
    ls_calls: list[dict] = []
    orig_one = levelset.level_surface_points_one_camera

    def one_camera(*args, **kwargs):
        ct.tag = len(ls_calls)
        before = launches()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_one(*args, **kwargs)
        e1.record()
        ls_calls.append(dict(events=(e0, e1), valid=int(out["valid"].sum()),
                             launches=tuple(a - b for a, b in zip(launches(), before)),
                             overflow=adaptive.read_overflow(out)))
        ct.tag = None
        return out

    for mod, name, label, on_dev in (
        (levelset, "render_params_with_colors", "depth render", True),
        (levelset, "knn", "KNN", True),
        (df, "field_values", "field query", True),
        (levelset, "_density_grad", "gradient", True),
        (meshops, "remove_statistical_outliers", "outlier removal", False),
        (poisson, "poisson_reconstruct", "poisson", False),
        (poisson, "_splat_trilinear", "splat", False),
        (poisson, "surface_nets", "surface nets", False),
        (poisson, "remove_low_density_vertices", "trim", False),
        (native, "qem_decimate", "QEM", False),
        (meshops, "clean_mesh", "clean", False),
    ):
        ct.wrap(mod, name, label, on_dev)
    levelset.level_surface_points_one_camera = one_camera
    cfg = ExtractConfig()
    path = os.path.join(WORK, "coarse_mesh.ply")
    os.makedirs(WORK, exist_ok=True)
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verts, faces = extract_mesh_from_coarse_model(coarse_model, cams, cfg, output_path=path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
    finally:
        levelset.level_surface_points_one_camera = orig_one
        ct.restore()
    tot = ct.totals()
    n_alive = int((coarse_model.alive & (torch.sigmoid(coarse_model.params.opacity_logit)
                                         >= cfg.prune_opacity_threshold)).sum())
    print(f"[10] extract_mesh_from_coarse_model, ExtractConfig defaults (surface_level "
          f"{cfg.surface_level}, total_points {cfg.total_points}, poisson_resolution "
          f"{cfg.poisson_resolution}, decimation_target {cfg.decimation_target}, dup_capacity "
          f"{cfg.dup_capacity}, k_max {cfg.k_max}), {n_alive} Gaussians after the prune in "
          f"{coarse_model.capacity} slots, {len(cams)} cameras at {H}x{W}: {wall:.2f} s wall; "
          f"launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts}")
    cam_ms, overflowing = [], []
    for i, c in enumerate(ls_calls):
        whole = c["events"][0].elapsed_time(c["events"][1])
        parts = {k: sum(tot.get((k, i), [0.0]))
                 for k in ("depth render", "KNN", "field query", "gradient")}
        rest = whole - sum(parts.values())
        cam_ms.append(dict(whole=whole, rest=rest, **parts))
        o = c["overflow"]
        if adaptive.overflowed(o):
            overflowing.append(i)
        print(f"    camera {i}: {whole:.1f} ms device (depth render {parts['depth render']:.2f}, "
              f"KNN {parts['KNN']:.1f}, field query {parts['field query']:.2f} in "
              f"{len(tot.get(('field query', i), []))} chunks, gradient {parts['gradient']:.2f}, "
              f"backprojection + ray sigma + crossing {rest:.2f}); valid {c['valid']} of "
              f"{H * W}; launches {c['launches']}; depth-render counters {json.dumps(o)}")
    host = {k: sum(tot.get((k, None), [0.0])) for k in (
        "outlier removal", "splat", "surface nets", "poisson", "trim", "QEM", "clean")}
    host["FFT solve + iso"] = host.pop("poisson") - host["splat"] - host["surface nets"]
    print("    host ms: " + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
          + f" (QEM calls {len(tot.get(('QEM', None), []))}: the mesh is under the "
          f"{cfg.decimation_target} budget when 0); mesh {len(verts)} vertices, {len(faces)} faces")
    if overflowing:
        print(f"    NOTE: the depth render at the level set's fixed caps (dup_capacity "
              f"{cfg.dup_capacity}, k_max {cfg.k_max}) dropped splats on cameras {overflowing}: "
              f"a fault of the reference's level set (no capacity loop), kept for parity")
    # What the fixed caps drop: the camera with the most tile overflow
    # again at a k_max that covers its deepest tile.
    worst = max(range(len(ls_calls)), key=lambda i: ls_calls[i]["overflow"]["tile_overflow"])
    o = ls_calls[worst]["overflow"]
    m = prune_low_opacity(coarse_model, cfg.prune_opacity_threshold)
    with recorded_kernel_args() as recs:
        fixed = levelset.level_surface_points_one_camera(m.params, m.alive, cams[worst],
                                                         dup_capacity=cfg.dup_capacity,
                                                         k_max=cfg.k_max)
    check(len(recs["K1"]) == 1 and not recs["K2"] and not recs["K3"],
          "level set: one K1 launch recorded for the kernel check")
    k1_err = check_recorded(check, recs, "[10]", f"level-set depth render, camera {worst} at the "
                            f"fixed caps")["K1"]
    del recs
    k_full = -(-o["max_tile_count"] // C_CHUNK) * C_CHUNK
    full = levelset.level_surface_points_one_camera(m.params, m.alive, cams[worst],
                                                    dup_capacity=cfg.dup_capacity, k_max=k_full)
    covered = (fixed["depth"] < fixed["depth"].max()) & (full["depth"] < full["depth"].max())
    both_depth = torch.where(covered, (fixed["depth"] - full["depth"]).abs(), 0.0)
    grown = dict(camera=worst, k_max=k_full, overflow=adaptive.read_overflow(full),
                 valid_fixed=int(fixed["valid"].sum()), valid_grown=int(full["valid"].sum()),
                 valid_differs=int((fixed["valid"] != full["valid"]).sum()),
                 covered=int(covered.sum()), depth_differs_1e4=int((both_depth > 1e-4).sum()),
                 depth_max_abs=float(both_depth.max()))
    print(f"    camera {worst} at k_max {k_full} (covers its deepest tile): {json.dumps(grown)}")
    del fixed, full
    check(len(ls_calls) == len(cams) and all(c["launches"] == (1, 0, 0, 1, 0, 0) for c in ls_calls)
          and counts == (len(cams), 0, 0, len(cams), 0, 0), "mesh extraction: one K1 and one binning "
          "launch per level-set camera, no K2 or K3")
    check(all(c["valid"] >= 1000 for c in ls_calls), "level set: every camera finds >= 1000 points")
    radius = np.linalg.norm(verts - np.array([0.0, 0.0, 3.2], np.float32), axis=1)
    finite = bool(np.isfinite(verts).all())
    check(finite and len(verts) > 20_000 and len(faces) > 40_000 and faces.min() >= 0
          and faces.max() < len(verts) and abs(float(np.median(radius)) - 0.72) < 0.1,
          f"mesh finite, > 20k vertices, faces in range, median radius {np.median(radius):.4f} "
          f"about the blob's 0.72")
    lv, lf, lc = load_mesh_ply(path)
    check(np.array_equal(lv, verts) and np.array_equal(lf, faces) and lc is not None
          and len(lc) == len(verts), "the mesh PLY loads back equal, with vertex colors")
    # QEM on the card's host: the mesh to a fifth (200k of 1M, the
    # low_poly preset's share of the high_poly budget).
    target = len(verts) // 5
    t0 = time.perf_counter()
    dv, dfc = meshops.decimate(verts, faces, target)
    qem_s = time.perf_counter() - t0
    print(f"    QEM decimate (+ clean) {len(verts)} -> target {target}: {len(dv)} vertices, "
          f"{len(dfc)} faces in {qem_s * 1e3:.1f} ms host")
    check(abs(len(dv) - target) <= 0.05 * target and len(dfc) > 0 and dfc.max() < len(dv),
          "QEM decimation builds and lands within 5% of its target")
    return dict(path=path, verts=verts, faces=faces, colors=lc, wall_s=wall, cam_ms=cam_ms,
                host=host, launches=counts, overflowing=overflowing, qem_ms=qem_s * 1e3,
                grown=grown, k1_err=k1_err)


# --- [11] refinement ----------------------------------------------------

REFINE_ITERS = 20
REFINE_MILESTONE = 10
REFINE_HW = 64
MIN_EXPORT_PSNR_DB = 50.0


def refine_view_losses(cfg, params, bm, pairs, cams, targets, deg, caps) -> list[float]:
    with torch.no_grad():
        return [float(refine_loss(cfg, params, bm, pairs, cam, gt, deg, caps.dup_capacity,
                                  k_max=caps.k_max, tile_cap=caps.tile_cap, cap_a=caps.cap_a,
                                  big_cap=caps.big_cap)[0]) for cam, gt in zip(cams, targets)]


def grown_refine_caps(cfg, params, bm, cams, deg, caps):
    """The trainer's growth rule over every view until no render drops
    anything."""
    for _ in range(6):
        grew = False
        for cam in cams:
            with torch.no_grad():
                out = render_bound(params, bm, cam, deg, torch.zeros(3, device=cam.world_view.device),
                                   caps.dup_capacity, caps.k_max, tile_cap=caps.tile_cap,
                                   cap_a=caps.cap_a, big_cap=caps.big_cap)
            ovf = adaptive.read_overflow(out)
            if adaptive.overflowed(ovf):
                caps, grew = caps.grown(ovf), True
        if not grew:
            return caps
    raise RuntimeError(f"refine caps did not converge: {caps}")


def phase_refine_card_vs_cpu(check, dev) -> None:
    """The vertex gradient of one refine step on a small mesh (surface nets
    of a sphere, ~700 faces, 3 Gaussians per triangle, SH 3): card (the
    kernels) against CPU (the plain versions)."""
    xs = np.linspace(-1.5, 1.5, 14)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    field = (np.sqrt(X**2 + Y**2 + Z**2) - 1.0).astype(np.float32)
    vg, faces = poisson.surface_nets(field, 0.0)
    verts = (vg * (xs[1] - xs[0]) + xs[0]) * 0.6 + np.array([0.0, 0.0, 3.0], np.float32)
    g = np.random.default_rng(12)
    vc = g.uniform(0, 1, (len(verts), 3)).astype(np.float32)
    gt = g.uniform(0, 1, (REFINE_HW, REFINE_HW, 3)).astype(np.float32)
    rest = g.normal(0, 0.1, (3 * len(faces), 3, 15)).astype(np.float32)
    cfg = RefineConfig(n_gaussians_per_triangle=3)
    pairs_np = normal_consistency_pairs(faces).astype(np.int64)

    def step(device):
        p, bm = init_bound_params(verts, faces, vc, 3, extent=2.0, sh_degree=3, device=device)
        p = dataclasses.replace(p, sh_rest=torch.as_tensor(rest, device=device))
        cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.9, REFINE_HW, REFINE_HW, device=device)
        caps = adaptive.RasterCaps(tile_cap=16, dup_capacity=8 * 3 * len(faces), k_max=1024)
        fn = make_refine_step(cfg, bm, torch.as_tensor(pairs_np, device=device),
                              bound_lrs(cfg, 0.1), 3, caps)
        _, adam, aux = fn(p, init_bound_adam(p), cam, torch.as_tensor(gt, device=device), 5)
        return float(aux["loss"]), (adam.mu.vertices / (1 - cfg.beta1)).cpu(), aux

    reset_launches()
    loss_card, g_card, aux = step(dev)
    torch.cuda.synchronize()
    counts = launches()
    loss_cpu, g_cpu, _ = step("cpu")
    err, scale = float((g_card - g_cpu).abs().max()), float(g_cpu.abs().max())
    print(f"[11] refine step card vs CPU, {len(faces)}-face sphere, 3 Gaussians per triangle, SH 3, "
          f"{REFINE_HW}x{REFINE_HW}: loss {loss_card:.7f} / {loss_cpu:.7f}; vertex gradient max abs "
          f"diff {err:.3e}, max|g| {scale:.3e}; launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts}; overflow "
          f"{json.dumps(adaptive.read_overflow(aux))}")
    check(counts == (1,) * 6, "refine step on the card: K1, K2, K3, the binning, the preprocess "
          "kernel and its backward once each")
    check(abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu) and scale > 0
          and err <= CARD_CPU_RTOL * scale,
          f"refine step: loss and vertex gradient on the card within {CARD_CPU_RTOL} x max|g| of "
          f"the CPU's")


def phase_refine(check, dev, mesh, cams, targets, extent) -> dict:
    """refined_training at full width on the extracted mesh: the window,
    its milestone and resume, then the step timed and profiled, and the
    refined PLY rendered back."""
    from sugar_tpu_torch.refine import trainer as refine_mod

    verts, faces = mesh["verts"], mesh["faces"]
    vc = mesh["colors"].astype(np.float32) / 255.0
    t0 = time.perf_counter()
    pairs_np = normal_consistency_pairs(faces)
    pairs_s = time.perf_counter() - t0
    cfg = RefineConfig(num_iterations=REFINE_ITERS, checkpoint_iterations=(REFINE_MILESTONE,),
                       log_every=1)
    ckpt_dir = os.path.join(WORK, "refine_milestones")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    saved = {}
    save_milestone = refine_mod.ckpt.save_milestone

    def recording_save(base, it, state):  # keep the saved state to hold the restore to
        saved.update(it=it, state=dict(state))
        return save_milestone(base, it, state)

    logs, per_iter = [], []

    def log(r):
        logs.append(r)
        if "loss" in r:
            per_iter.append(launches())

    refine_mod.ckpt.save_milestone = recording_save
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, bm = refined_training(verts, faces, vc, cams, targets, extent, cfg, log_fn=log,
                                      checkpoint_dir=ckpt_dir, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
    finally:
        refine_mod.ckpt.save_milestone = save_milestone
    n_g = int(params.opacity_logit.shape[0])
    steps = [r for r in logs if "loss" in r]
    grows = [r for r in logs if r.get("event") == "cap_grow"]
    deltas = [tuple(a - b for a, b in zip(c, p)) for c, p in zip(per_iter, [(0,) * 6] + per_iter[:-1])]
    print(f"[11] refined_training on the [10] mesh: {len(verts)} vertices, {len(faces)} faces, "
          f"{n_g} Gaussians (1 per triangle), SH degree {cfg.sh_degree}, iterations 1-"
          f"{REFINE_ITERS}: {wall:.2f} s wall; normal_consistency_pairs {pairs_s * 1e3:.1f} ms host "
          f"({len(pairs_np)} pairs); launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts}; cap growths to (k_max, "
          f"tile_cap, dup_capacity) "
          f"{[(r['new']['k_max'], r['new']['tile_cap'], r['new']['dup_capacity']) for r in grows]}")
    for r, dl in zip(steps, deltas):
        print(f"    iter {r['iter']}: loss {r['loss']:.6f}, psnr {r['psnr']:.3f}, launches {dl}, "
              f"overflow {[r.get(k, 0) for k in ('bin_overflow', 'cap_overflow', 'tile_overflow')]}")
    check(len(steps) == REFINE_ITERS and all(math.isfinite(r["loss"]) for r in steps)
          and all(bool(torch.isfinite(getattr(params, f)).all()) for f in BOUND_FIELDS),
          "refine: every loss and every parameter finite")
    check(deltas == [(1,) * 6] * REFINE_ITERS and counts == (REFINE_ITERS,) * 6,
          "refine: one launch of K1, K2, K3, the binning, the preprocess kernel and its "
          "backward per iteration")

    # The loss over the 8 views before and after, at caps that drop nothing.
    p0, _ = init_bound_params(verts, faces, vc, 1, extent=extent, sh_degree=cfg.sh_degree,
                              device=dev)
    pairs = torch.as_tensor(pairs_np.astype(np.int64), device=dev)
    caps = adaptive.RasterCaps(tile_cap=16, dup_capacity=cfg.dup_capacity_mult * n_g, k_max=cfg.k_max)
    caps = grown_refine_caps(cfg, params, bm, cams, cfg.sh_degree, caps)
    before = refine_view_losses(cfg, p0, bm, pairs, cams, targets, 0, caps)
    after = refine_view_losses(cfg, params, bm, pairs, cams, targets, 0, caps)
    print(f"    mean loss over the {len(cams)} views: {statistics.mean(before):.6f} at the binding, "
          f"{statistics.mean(after):.6f} after {REFINE_ITERS} iterations")
    check(statistics.mean(after) < statistics.mean(before), "refine: the loss over the views falls")

    # Resume from the milestone.
    like = dict(params=params, adam=init_bound_adam(params), iteration=0)
    st = ckpt.restore_structured(ckpt.milestone_path(ckpt_dir, REFINE_MILESTONE), like)
    ref, got = ckpt._flatten(saved["state"]), ckpt._flatten(st)
    exact = saved["it"] == REFINE_MILESTONE and ref.keys() == got.keys() and all(
        np.array_equal(ref[k], got[k]) for k in ref)
    rlogs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed, _ = refined_training(verts, faces, vc, cams, targets, extent, cfg, log_fn=rlogs.append,
                                  checkpoint_dir=ckpt_dir, device=dev)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rsteps = [r for r in rlogs if "loss" in r]
    diffs = {f: float((getattr(resumed, f) - getattr(params, f)).abs().max()) for f in BOUND_FIELDS}
    after_r = refine_view_losses(cfg, resumed, bm, pairs, cams, targets, 0, caps)
    rel = abs(statistics.mean(after_r) - statistics.mean(after)) / statistics.mean(after)
    r_ovf = [r["iter"] for r in rsteps if r.get("tile_overflow", 0) or r.get("bin_overflow", 0)
             or r.get("cap_overflow", 0)]
    print(f"[11] resume from milestone {REFINE_MILESTONE}: {len(ref)} arrays restored bit-exact "
          f"{exact}; {len(rsteps)} iterations in {resume_s:.2f} s; max |resumed - uninterrupted| "
          f"per field {json.dumps(diffs)}; mean view loss {statistics.mean(after_r):.6f} against "
          f"{statistics.mean(after):.6f} (relative {rel:.2e}; iterations that dropped splats after "
          f"the resume, with the default caps again: {r_ovf})")
    check(exact, "refine: the milestone restores the saved state bit-exactly on the card")
    check({"event": "resume", "iteration": REFINE_MILESTONE} in rlogs
          and len(rsteps) == REFINE_ITERS - REFINE_MILESTONE
          and all(math.isfinite(r["loss"]) for r in rsteps),
          f"refine: the resumed run starts at {REFINE_MILESTONE} and finishes finite")
    check(rel <= (1e-2 if r_ovf else 1e-3),
          "refine: the resumed run ends at the uninterrupted run's view loss (rel 1e-3; 1e-2 when "
          "the resumed run's default caps dropped splats)")

    # 10 steps at SH degree 3 by CUDA events, one profiled. Each starts
    # from the trained state (the step leaves its inputs unchanged), so
    # the caps grown on it cover every step.
    lrs = bound_lrs(cfg, 10.0 * 0.5 * float(np.linalg.norm(verts.max(0) - verts.min(0)))
                    / np.sqrt(len(verts)))
    step = make_refine_step(cfg, bm, pairs, lrs, cfg.sh_degree, caps)
    adam = init_bound_adam(params)
    p = params
    step(p, adam, cams[0], targets[0], REFINE_ITERS)  # warm-up
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev, auxes = [], []
    for i in range(TIMED_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        _, _, aux = step(p, adam, cams[i % len(cams)], targets[i % len(cams)], REFINE_ITERS + i)
        e1.record()
        ev.append((e0, e1))
        auxes.append(aux)
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in ev]
    peak = torch.cuda.max_memory_allocated() - base
    timed_counts = launches()
    ovf = [adaptive.read_overflow(a) for a in auxes]
    check(timed_counts == (TIMED_STEPS,) * 6,
          f"timed refine steps: one launch of each kernel per step {timed_counts}")
    check(all(not adaptive.overflowed(o) for o in ovf)
          and all(math.isfinite(float(a["loss"])) for a in auxes),
          f"timed refine steps: overflow 0 and losses finite "
          f"{[(o['tile_overflow'], o['cap_overflow'], o['bin_overflow']) for o in ovf]}")
    wall_ms, busy_ms, ranked = profile_device(
        lambda: step(p, adam, cams[0], targets[0], REFINE_ITERS), top=None)
    print(f"[11] refine step at SH degree 3, {n_g} Gaussians, caps {caps}: median "
          f"{statistics.median(step_ms):.3f} ms of {TIMED_STEPS} (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}: {', '.join(f'{v:.3f}' for v in step_ms)}); peak memory above the "
          f"state {peak / 1e9:.3f} GB")
    print(f"    under torch.profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
          f"share {1.0 - busy_ms / wall_ms:.3f}; {len(ranked)} distinct kernels, "
          f"{sum(c for _, _, c in ranked)} launches")
    for name, t_ms, calls in ranked[:12]:
        print(f"      {t_ms:8.3f} ms  {calls:4d}x  {name[:100]}")

    # The kernels against their plain versions on what one such step gives
    # them.
    with recorded_kernel_args() as recs:
        step(p, adam, cams[0], targets[0], REFINE_ITERS)
        torch.cuda.synchronize()
    check(all(len(v) == 1 for v in recs.values()),
          "refine step: one K1, K2 and K3 launch recorded for the kernel check")
    errs = check_recorded(check, recs, "[11]", f"refine step, view 0, {n_g} Gaussians, k_max "
                          f"{caps.k_max}")
    del recs

    # The refined PLY rendered back through the serving path.
    ply_path = os.path.join(WORK, "refined.ply")
    export_refined_ply(p, bm, ply_path)
    served = load_ply(ply_path, device=dev)
    os.remove(ply_path)
    bg = torch.zeros(3, device=dev)
    ref_img, _ = adaptive.render_adaptive(render_bound, caps, p, bm, cams[0], cfg.sh_degree, bg)
    ply_img, _ = adaptive.render_adaptive(render_model, caps, served, cams[0], bg=bg)
    db = float(psnr(torch.clamp(ply_img["image"], 0, 1), torch.clamp(ref_img["image"], 0, 1)))
    print(f"[11] export_refined_ply -> load_ply(device='cuda') ({int(served.alive.sum())} Gaussians, "
          f"SH {served.sh_degree}) -> render_model, view 0: PSNR {db:.2f} dB against render_bound")
    check(db >= MIN_EXPORT_PSNR_DB and served.sh_degree == cfg.sh_degree,
          f"refined PLY renders within {MIN_EXPORT_PSNR_DB} dB of the bound model")
    return dict(wall_s=wall, resume_s=resume_s, step_ms=statistics.median(step_ms),
                step_ms_all=step_ms, busy_ms=busy_ms, wall_ms=wall_ms, peak_gb=peak / 1e9,
                launches=counts, pairs_ms=pairs_s * 1e3, n_gaussians=n_g, psnr_db=db,
                errs=errs, params=p, bm=bm)


# --- [12] texture bake ----------------------------------------------------

# rasterize_mesh on the card against the CPU: face ids equal, depth and
# barycentrics within MESH_RASTER_ATOL.
MESH_RASTER_ATOL = 1e-5
# The textured OBJ rendered back through render_textured_mesh against the
# texels the bake's own rasterization maps each pixel to: the OBJ holds
# vertices and UVs at 8 decimals, which may move a pixel whose UV lies
# within rounding of a texel edge to the next texel.
TEXTURED_SAME_SHARE = 0.99
BAKE_RASTER_K_MAX = 256  # rasterize_mesh's default, which bake_texture uses
# extract_textured_mesh's fixed render caps (the JAX package's).
BAKE_DUP_CAPACITY = 2**21
BAKE_K_MAX = 1024


def raster_test_mesh():
    """A small mesh with occlusion and tiles deeper than k_max: a facing
    quad at z 2 (faces 0-1, first in every tile's list) in front of 500
    random triangles (view z 2.5-4.5) and another quad at z 4."""
    g = np.random.default_rng(1)
    rand_v = g.uniform(-1, 1, (300, 3)).astype(np.float32)
    rand_v[:, 2] += 3.5
    rand_f = g.integers(0, 300, (500, 3))

    def quad(z, half):
        return np.array([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
                        np.float32)

    qf = np.array([[0, 1, 2], [0, 2, 3]])
    verts = np.concatenate([quad(2.0, 0.5), quad(4.0, 0.5), rand_v])
    faces = np.concatenate([qf, qf + 4, rand_f + 8]).astype(np.int64)
    return verts, faces


def phase_mesh_raster_card_vs_cpu(check, dev) -> None:
    """rasterize_mesh on the card against the CPU (k_max 32, the deepest
    tile several times deeper; tiles in chunks of 5)."""
    verts, faces = raster_test_mesh()

    def run(device):
        cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, 48, 56, device=device)
        out = rasterize_mesh(torch.as_tensor(verts, device=device),
                             torch.as_tensor(faces, device=device), cam, dup_capacity=4096,
                             k_max=32, tile_chunk=5)
        return {k: v.cpu() for k, v in out.items()}

    card, cpu = run(dev), run("cpu")
    row = dict(pixels=48 * 56, hit=int((cpu["face_idx"] >= 0).sum()),
               face_idx_differs=int((card["face_idx"] != cpu["face_idx"]).sum()),
               zbuf_max_abs=float((card["zbuf"] - cpu["zbuf"]).abs().max()),
               bary_max_abs=float((card["bary"] - cpu["bary"]).abs().max()),
               overflow=[int(card["overflow"]), int(cpu["overflow"])],
               tile_count_max=[int(card["tile_count_max"]), int(cpu["tile_count_max"])],
               center=[int(card["face_idx"][24, 28]), float(card["zbuf"][24, 28])])
    print(f"[12] rasterize_mesh card vs CPU, {len(faces)} faces (occluding quads, k_max 32): "
          f"{json.dumps(row)}")
    check(row["face_idx_differs"] == 0 and row["zbuf_max_abs"] <= MESH_RASTER_ATOL
          and row["bary_max_abs"] <= MESH_RASTER_ATOL,
          f"rasterize_mesh on the card: face ids equal the CPU's, depth and barycentrics within "
          f"{MESH_RASTER_ATOL}")
    check(row["overflow"] == [0, 0] and row["tile_count_max"][0] == row["tile_count_max"][1] > 32
          and row["center"][0] in (0, 1) and abs(row["center"][1] - 2.0) < 1e-3,
          "rasterize_mesh: a tile deeper than k_max, and the near quad occludes at the centre")


def texel_lookup(verts_uv, fidx, bary, tex_size: int):
    """bake_texture's map from pixels to texels (refine/texture.py): the
    hit mask and each hit pixel's linear texel index."""
    hit = fidx >= 0
    uv = np.einsum("nkc,nk->nc", verts_uv[fidx[hit]], bary[hit])
    ti = np.clip((uv[:, 0] * tex_size).astype(np.int64), 0, tex_size - 1)
    tj = np.clip((uv[:, 1] * tex_size).astype(np.int64), 0, tex_size - 1)
    return hit, ti * tex_size + tj


def phase_texture(check, dev, params, bm, cams) -> dict:
    """extract_textured_mesh on [11]'s refined model over the ring cameras
    with the default TextureConfig: the whole bake timed, its launches
    counted and K1's arguments recorded. Then the bake's parts, called one
    by one per camera and timed; K1 against its plain version on the
    arguments the bake's render of the worst camera gave it; the OBJ and
    PNG loaded back, held against the texture bake_texture makes from the
    parts' images, and rendered."""
    cfg = TextureConfig()
    sh = int(round(math.sqrt(params.sh_rest.shape[-1] + 1))) - 1
    obj = os.path.join(WORK, "textured", "textured.obj")
    os.makedirs(os.path.dirname(obj), exist_ok=True)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_kernel_args() as recs:
        extract_textured_mesh(params, bm, cams, obj, cfg, sh_degree=sh)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    n_faces = int(bm.faces.shape[0])
    verts_uv, tex_size = build_uv_atlas(n_faces, cfg.square_size)
    expect_size = 10 * int(math.sqrt(n_faces // 2 + 1) + 1)

    # The parts per camera: render_bound at the bake's caps and
    # rasterize_mesh (device ms), bake_texture's accumulation (host ms).
    bg = torch.zeros(3, device=dev)
    acc = np.zeros((tex_size * tex_size, 3), np.float64)
    cnt = np.zeros((tex_size * tex_size,), np.float64)
    rows, parts = [], []
    for cam in cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        with torch.no_grad():
            out = render_bound(params, bm, cam, sh, bg, BAKE_DUP_CAPACITY, BAKE_K_MAX)
        ev[1].record()
        ras = rasterize_mesh(params.vertices, bm.faces, cam)
        ev[2].record()
        img = np.clip(out["image"].cpu().numpy(), 0.0, 1.0).reshape(-1, 3)
        fidx = ras["face_idx"].cpu().numpy().reshape(-1)
        bary = ras["bary"].cpu().numpy().reshape(-1, 3)
        t1 = time.perf_counter()
        hit, lin = texel_lookup(verts_uv, fidx, bary, tex_size)
        np.add.at(acc, lin, img[hit])
        np.add.at(cnt, lin, 1.0)
        acc_ms = (time.perf_counter() - t1) * 1e3
        o = adaptive.read_overflow(out)
        rows.append(dict(render_ms=ev[0].elapsed_time(ev[1]), raster_ms=ev[1].elapsed_time(ev[2]),
                         acc_ms=acc_ms, hit=int(hit.sum()), raster_overflow=int(ras["overflow"]),
                         tile_count_max=int(ras["tile_count_max"]),
                         render_overflow={k: o[k] for k in ("bin_overflow", "cap_overflow",
                                                            "tile_overflow", "max_tile_count")}))
        parts.append(dict(img=img, fidx=fidx, bary=bary))
    del acc, cnt
    print(f"[12] extract_textured_mesh on the [11] refined model: {n_faces} faces, "
          f"{int(params.opacity_logit.shape[0])} Gaussians ({bm.n_per_triangle} per triangle), SH "
          f"{sh}, {len(cams)} cameras at {H}x{W}, TextureConfig defaults (square_size "
          f"{cfg.square_size}), render caps dup {BAKE_DUP_CAPACITY} k_max {BAKE_K_MAX}, "
          f"rasterize_mesh dup 2^20 k_max {BAKE_RASTER_K_MAX}: {wall:.2f} s wall (OBJ, MTL and PNG "
          f"written); atlas {tex_size}x{tex_size} texels; launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts}")
    for i, row in enumerate(rows):
        print(f"    camera {i}: render_bound {row['render_ms']:.2f} ms device, rasterize_mesh "
              f"{row['raster_ms']:.2f} ms device, accumulation {row['acc_ms']:.1f} ms host; "
              f"{row['hit']} pixels on the mesh; render_bound counters "
              f"{json.dumps(row['render_overflow'])}; rasterize_mesh overflow "
              f"{row['raster_overflow']}, deepest tile {row['tile_count_max']} faces against k_max "
              f"{BAKE_RASTER_K_MAX}")
    dropping = [i for i, r in enumerate(rows) if r["render_overflow"]["tile_overflow"]
                or r["render_overflow"]["cap_overflow"] or r["render_overflow"]["bin_overflow"]]
    truncated = [i for i, r in enumerate(rows) if r["tile_count_max"] > BAKE_RASTER_K_MAX]
    if dropping or truncated:
        print(f"    NOTE: at the bake's fixed caps render_bound dropped splats on cameras {dropping} "
              f"and rasterize_mesh truncated tiles at k_max {BAKE_RASTER_K_MAX} on cameras "
              f"{truncated}: faults of the reference's bake (no capacity loop), kept for parity")
    check(counts == (len(cams), 0, 0, len(cams), len(cams), 0) and len(recs["K1"]) == len(cams)
          and not recs["K2"] and not recs["K3"], "texture bake: one K1, one binning and one "
          "preprocess launch per camera, no K2, K3 or preprocess backward")
    check(tex_size == expect_size and all(r["raster_overflow"] == 0 for r in rows),
          f"texture bake: atlas {expect_size}^2 at {n_faces} faces, no rasterize_mesh duplication "
          f"overflow")

    # K1 against its plain version on what the bake's render of the camera
    # with the most tile overflow gave it.
    worst = max(range(len(rows)), key=lambda i: rows[i]["render_overflow"]["tile_overflow"])
    k1_err = check_recorded(check, {"K1": [recs["K1"][worst]], "K2": [], "K3": []}, "[12]",
                            f"bake render, camera {worst} at the fixed caps")["K1"]
    del recs

    # The OBJ, MTL and PNG loaded back, against the texture bake_texture
    # makes from the parts' images.
    images = iter(p["img"].reshape(H, W, 3) for p in parts)
    tex, _, _ = bake_texture(params, bm, cams, lambda cam: next(images),
                             square_size=cfg.square_size)
    t0 = time.perf_counter()
    lv, lf, luv, lfuv = load_obj(obj)
    png = read_png(os.path.splitext(obj)[0] + ".png")
    load_ms = (time.perf_counter() - t0) * 1e3
    want_png = (np.clip(tex, 0, 1) * 255).astype(np.uint8)
    png_differs = int((png != want_png).any(-1).sum()) if png.shape == want_png.shape else -1
    verts, faces = params.vertices.cpu().numpy(), bm.faces.cpu().numpy()
    v_err = float(np.abs(lv - verts).max())
    print(f"[12] load_obj + read_png: {len(lv)} vertices (max abs {v_err:.2e} from the written "
          f"float32), {len(lf)} faces, {0 if luv is None else len(luv)} UVs, texture {png.shape}, "
          f"{png_differs} texels differing from the parts' bake; {load_ms:.1f} ms host; files "
          + ", ".join(f"{os.path.basename(p)} {os.path.getsize(p) / 1e6:.1f} MB" for p in
                      (obj, obj[:-4] + ".mtl", obj[:-4] + ".png")))
    check(len(lv) == len(verts) and v_err <= 1e-6 and np.array_equal(lf, faces.astype(np.int64))
          and luv is not None and len(luv) == 3 * n_faces and lfuv is not None
          and lfuv.shape == (n_faces, 3) and png_differs == 0 and bool(np.isfinite(tex).all()),
          "textured OBJ loads back: vertex, face and UV counts equal, texture decode-equal")

    # render_textured_mesh of the written OBJ against the bake's texels.
    vt = luv[lfuv]
    obj_uv = np.stack([1.0 - vt[..., 1], vt[..., 0]], axis=-1)
    tex_f = png.astype(np.float32) / 255.0
    same, dbs = [], []
    for cam, p in zip(cams, parts):
        img = render_textured_mesh(lv, lf, obj_uv, tex_f, cam)
        hit, lin = texel_lookup(verts_uv, p["fidx"], p["bary"], tex_size)
        expect = np.zeros((H * W, 3), np.float32)
        expect[hit] = tex_f.reshape(-1, 3)[lin]
        same.append(float((np.abs(img.reshape(-1, 3) - expect).max(-1) == 0).mean()))
        dbs.append(float(psnr(torch.as_tensor(img), torch.as_tensor(p["img"].reshape(H, W, 3)))))
    print(f"[12] render_textured_mesh of the loaded OBJ, per camera: share of pixels equal to the "
          f"bake's texel lookup {', '.join(f'{s:.5f}' for s in same)}; PSNR against the bake's "
          f"render_bound images {', '.join(f'{d:.2f}' for d in dbs)} dB")
    check(min(same) >= TEXTURED_SAME_SHARE and all(math.isfinite(d) for d in dbs),
          f"textured OBJ renders the bake's texels (>= {TEXTURED_SAME_SHARE} of the pixels)")
    return dict(wall_s=wall, launches=counts, rows=rows, tex_size=tex_size, load_ms=load_ms,
                same=same, psnr_db=dbs, dropping=dropping, truncated=truncated, k1_err=k1_err)


# --- [13] the pipeline end to end -----------------------------------------

# tests/test_parity.py's configuration and floors.
PIPE_ITERS = (200, 150, 400)
PARITY_FLOORS = {"vanilla": 15.5, "coarse": 17.6, "refined": 15.4}
LPIPS_RTOL = 1e-4


def parity_config(out_dir: str, resume: bool = False) -> PipelineConfig:
    """tests/test_parity.py:36-70."""
    v_it, c_it, r_it = PIPE_ITERS
    return PipelineConfig(
        scene_path="<procedural>", output_dir=out_dir, regularization="sdf", poly="low_poly",
        eval_split=True, capacity=2**12, vanilla_iterations=v_it, resume=resume,
        vanilla_overrides=dict(
            sh_degree=1, sh_warmup_every=max(1, v_it // 2), densify_from=50,
            densify_until=int(v_it * 0.8), densify_every=50, opacity_reset_every=10 * v_it,
            k_max=512, log_every=10**6, checkpoint_iterations=()),
        coarse_overrides=dict(
            start_iteration=v_it, num_iterations=v_it + c_it, entropy_start=v_it,
            entropy_end=v_it + c_it // 3, prune_at=(v_it + c_it // 3,), regularize_from=v_it,
            start_sdf_estimation_from=v_it + c_it // 3, n_samples_for_sdf_regularization=20_000,
            reset_neighbors_every=50, sh_degree=1, k_max=512, log_every=10**6,
            checkpoint_iterations=()),
        extract_overrides=dict(
            surface_level=0.3, prune_opacity_threshold=0.5, total_points=150_000,
            poisson_resolution=96, decimation_target=6_000, dup_capacity=2**16, k_max=512),
        refine_overrides=dict(
            num_iterations=r_it, n_gaussians_per_triangle=3, sh_degree=1,
            sh_warmup_every=max(1, r_it // 4), k_max=512, log_every=10**6,
            checkpoint_iterations=()),
    )


def phase_pipeline(check, dev) -> dict:
    """run_vanilla -> run_coarse -> run_extract_mesh -> run_refine ->
    run_texture on tests/test_parity.py's scene and configuration; each
    stage's PSNR on the held-out split, every artifact loaded back, and a
    resumed run that skips every stage. Each stage records the arguments
    of its last kernel launches (for coarse, the last step's two renders:
    image and depth), and K1, K2 and K3 are held to their plain versions
    on them."""
    t0 = time.perf_counter()
    scene, _ = make_parity_scene(n_gt=2_000, n_init=800, n_cams=16, resolution=96, k_max=512,
                                 device=dev)
    scene_s = time.perf_counter() - t0
    train_idx, test_idx = scene.split(True)
    out_dir = os.path.join(WORK, "pipeline")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = parity_config(out_dir)
    walls, counts, errs, logs = {}, {}, {}, []

    def stage(name, fn, *args):
        r, st = timed_stage(check, "[13]", name,
                            lambda: fn(cfg, scene, *args, log_fn=logs.append))
        walls[name], counts[name] = st["wall_s"], st["launches"]
        for k, e in st["errs"].items():
            errs[k] = max(errs.get(k, 0.0), e)
        return r

    gs = stage("vanilla", run_vanilla)
    coarse = stage("coarse", run_coarse, gs)
    mesh = stage("extract_mesh", run_extract_mesh, coarse)
    refined = stage("refine", run_refine, mesh)
    textured = stage("texture", run_texture, refined)
    total = tuple(sum(c[k] for c in counts.values()) for k in range(6))
    art = dict(vanilla=gs, coarse=coarse, mesh=mesh, refined=refined, textured=textured)

    scores = {}
    for name, ply in (("vanilla", gs), ("coarse", coarse), ("refined", refined)):
        r = eval_gaussian_ply(ply, scene, test_idx, k_max=512)
        scores[name] = (r["psnr"], r["ssim"])
    back = load_artifacts(art, dev)
    lv, lf, luv, lfuv = back["obj"]
    png = back["png"]
    vt = luv[lfuv]
    verts_uv = np.stack([1.0 - vt[..., 1], vt[..., 0]], axis=-1)
    tex = png.astype(np.float32)[..., :3] / 255.0
    tr = evaluate_renders(lambda i: render_textured_mesh(lv, lf, verts_uv, tex, scene.cameras[i]),
                          scene.images, test_idx)
    scores["textured"] = (tr["psnr"], tr["ssim"])
    print(f"[13] pipeline on tests/test_parity.py's scene (2,000-Gaussian blob, 16 cameras at "
          f"96x96, {len(train_idx)} train / {len(test_idx)} held out; built in {scene_s:.2f} s), "
          f"iterations {PIPE_ITERS}: stage walls "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; launches (K1, K2, K3, binning, preprocess, preprocess bwd) " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    print("    held-out PSNR / SSIM: " + ", ".join(f"{k} {p:.3f} dB / {s:.4f}"
                                                  for k, (p, s) in scores.items())
          + f" (floors {PARITY_FLOORS}; JAX on a CPU, tests/test_parity.py:87-92: 17.00 / 19.10 / "
          f"16.94 dB)")

    # Every artifact loaded back.
    v_model, c_model, r_model = back["vanilla"], back["coarse"], back["refined"]
    mv, mf, mc = back["mesh"]
    sp, sbm = back["state"]
    radius = float(np.median(np.linalg.norm(mv, axis=1)))
    print(f"    artifacts: vanilla {int(v_model.alive.sum())} Gaussians, coarse "
          f"{int(c_model.alive.sum())}, mesh {len(mv)} vertices / {len(mf)} faces (median radius "
          f"{radius:.4f}), refined {int(r_model.alive.sum())} Gaussians, state "
          f"{int(sp.opacity_logit.shape[0])} ({sbm.n_per_triangle} per triangle), textured OBJ "
          f"{len(lv)} vertices / {len(lf)} faces, texture {png.shape}")
    # A resumed run skips every stage.
    rcfg = dataclasses.replace(cfg, resume=True)

    def again(log_fn):
        a = run_vanilla(rcfg, scene, log_fn=log_fn)
        for fn in (run_coarse, run_extract_mesh, run_refine, run_texture):
            a = fn(rcfg, scene, a, log_fn=log_fn)

    skipped, rcounts, _ = resumed_run(again)
    print(f"    resumed run: stage_skip events {skipped}, launches (K1, K2, K3, binning, preprocess, preprocess bwd) {rcounts}")

    p = {k: v[0] for k, v in scores.items()}
    check(all(math.isfinite(v) for v in p.values()), "pipeline: every stage's PSNR finite")
    for k, floor in PARITY_FLOORS.items():
        check(p[k] > floor, f"pipeline: {k} PSNR {p[k]:.3f} dB > {floor} dB")
    check(p["coarse"] > p["vanilla"] - 1.0 and p["refined"] > p["coarse"] - 3.0,
          "pipeline: coarse > vanilla - 1 dB and refined > coarse - 3 dB")
    check(len(mv) > 500 and len(mf) > 500 and 0.3 < radius < 1.6,
          "pipeline: mesh > 500 vertices and faces, median radius in (0.3, 1.6)")
    n_train = len(train_idx)
    v_it, c_it, r_it = PIPE_ITERS
    kc = counts["coarse"]
    check(counts["vanilla"] == (v_it,) * 6 and counts["refine"] == (r_it,) * 6
          and counts["extract_mesh"] == (n_train, 0, 0, n_train, 0, 0)
          and counts["texture"] == (n_train, 0, 0, n_train, n_train, 0)
          and kc[0] == kc[1] == kc[2] == kc[3] and kc[4] == kc[5] == c_it
          and c_it <= kc[0] <= 2 * c_it,
          "pipeline launches: K1/K2/K3, the binning and the preprocess pair once per vanilla and "
          "refine iteration; K1/K2/K3 and the binning once or twice per coarse iteration, the "
          "preprocess pair once; K1 and the binning once per camera in extraction and the bake, "
          "the preprocess kernel once per camera in the bake")
    check(int(r_model.alive.sum()) == 3 * len(mf) and int(sp.opacity_logit.shape[0]) == 3 * len(mf)
          and len(lf) == len(mf) and int(v_model.alive.sum()) > 0
          and int(c_model.alive.sum()) > 0 and mc is not None,
          "pipeline: every artifact loads back (3 Gaussians per mesh triangle)")
    check(skipped == list(PIPE_STAGES) and rcounts == (0,) * 6,
          "pipeline: a resumed run skips every stage and launches no kernel")
    return dict(walls=walls, counts=counts, launches=total, scores=scores, scene_s=scene_s,
                errs=errs, scene=scene, artifacts=dict(vanilla=gs, coarse=coarse, refined=refined))


def lpips_weights(path: str, seed: int = 0) -> None:
    """Synthetic LPIPS weights from a seed (tests/test_aux.py:193-218):
    VGG16 convolutions N(0, 0.05), zero biases, heads 1/C."""
    rng = np.random.default_rng(seed)
    w, idx, cin, heads = {}, 0, 3, []
    for c in _VGG_CFG:
        if c == "M":
            idx += 1
            continue
        w[f"features.{idx}.weight"] = rng.normal(scale=0.05, size=(c, cin, 3, 3)).astype(np.float32)
        w[f"features.{idx}.bias"] = np.zeros((c,), np.float32)
        cin = c
        idx += 2
        if idx - 1 in (3, 8, 15, 22, 29):
            heads.append(c)
    for k, c in enumerate(heads):
        w[f"lin{k}"] = np.full((c,), 1.0 / c, np.float32)
    np.savez(path, **w)


def phase_lpips(check, dev) -> None:
    """LPIPS with seeded synthetic weights, the card against the CPU."""
    path = os.path.join(WORK, "lpips_synthetic.npz")
    os.makedirs(WORK, exist_ok=True)
    lpips_weights(path)
    lp = make_lpips(path)
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(0, 1, (96, 96, 3)).astype(np.float32) for _ in range(2))
    card = float(lp(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)))
    cpu = float(lp(torch.as_tensor(a), torch.as_tensor(b)))
    self_d = float(lp(torch.as_tensor(a, device=dev), torch.as_tensor(a, device=dev)))
    rel = abs(card - cpu) / abs(cpu)
    print(f"[13] LPIPS (synthetic VGG weights, seed 0) on a random 96x96 pair: card {card:.8f}, "
          f"CPU {cpu:.8f}, relative {rel:.2e}; self-distance on the card {self_d:.2e}")
    check(rel <= LPIPS_RTOL and self_d < 1e-6 and card > 0,
          f"LPIPS on the card within {LPIPS_RTOL} (relative) of the CPU's")


# --- [14] the oracle modes, the two-pass path, the compositor, entry points

TWOPASS_GRAD_RTOL = 1e-4  # two-pass vs fused gradients, x max|g| per field
ORACLE_N = 2**14
ORACLE_HW = 128
ORACLE_SEED = 4
ORACLE_ATOL = 1e-5  # tests/test_raster.py:99-100
ORACLE_CAPS = adaptive.RasterCaps(tile_cap=16, dup_capacity=16 * ORACLE_N, k_max=1024)
DEMO_SUBSET = 20_000
ENTRY_HW = 96
ENTRY_VANILLA_ITERS = 10


def compare_renders(a: dict, b: dict) -> dict:
    """Differences of two renders of one view, tie pixels apart as
    ``compare`` holds them."""
    _, d = tie_stats(a["image"], b["image"], a["n_contrib"], b["n_contrib"], a["final_T"],
                     b["final_T"])
    return dict(d, colour_max=float(torch.maximum(a["image"].abs().max(),
                                                  b["image"].abs().max())))


def renders_ok(d: dict, atol: float) -> bool:
    return ties_ok(d, atol, TIE_SLOT_WEIGHT * d["colour_max"])


@contextlib.contextmanager
def no_fallback(refuse_fused: bool = True):
    """Inside the block the plain versions of K1, K2 and K3 and (unless
    ``refuse_fused`` is False) the fused path raise, so a CUDA render that
    reaches any of them fails."""
    slots = [(tc_mod, "tile_composite_plain"), (tc_mod, "tile_composite_bwd_plain"),
             (segsum_mod, "segment_sum_plain")]
    if refuse_fused:
        slots.append((raster_api, "render_fused"))
    originals = [getattr(mod, name) for mod, name in slots]

    def refuse(name):
        def run(*args, **kwargs):
            raise AssertionError(f"{name} ran inside no_fallback()")
        return run

    for mod, name in slots:
        setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for (mod, name), orig in zip(slots, originals):
            setattr(mod, name, orig)


# [15] (g) and (h) drive the package's single-controller entry points,
# whose ranks re-import this script as __mp_main__. While this variable is
# set, each such rank refuses the plain K1-K3 for its whole life.
REFUSE_PLAIN_IN_RANKS = "SUGAR_SMOKE_REFUSE_PLAIN"
if __name__ == "__mp_main__" and os.environ.get(REFUSE_PLAIN_IN_RANKS) == "1":
    _RANK_REFUSAL = no_fallback(refuse_fused=False)  # held: leaving it restores the plain ones
    _RANK_REFUSAL.__enter__()


@contextlib.contextmanager
def plain_refused_in_ranks():
    """The ranks started inside the block refuse the plain K1-K3."""
    os.environ[REFUSE_PLAIN_IN_RANKS] = "1"
    try:
        yield
    finally:
        del os.environ[REFUSE_PLAIN_IN_RANKS]


def caps_kw(caps: adaptive.RasterCaps) -> dict:
    return dict(tile_cap=caps.tile_cap, dup_capacity=caps.dup_capacity, k_max=caps.k_max,
                cap_a=caps.cap_a, big_cap=caps.big_cap)


def param_grads(model, cam, mode: str, kw: dict) -> tuple[dict, dict]:
    """Gradients of bench.py's loss, sum(image^2), with respect to every
    raw field of ``model`` at one view."""
    p = GaussianParams(**{f: getattr(model.params, f).detach().clone().requires_grad_(True)
                          for f in PARAM_FIELDS})
    bg = torch.zeros(3, device=p.xyz.device)
    out = render_params(p, model.alive, cam, model.sh_degree, bg, mode=mode, **kw)
    (out["image"] ** 2).sum().backward()
    return {f: getattr(p, f).grad for f in PARAM_FIELDS}, out


def phase_twopass(check, dev, model, cams, fused_caps, card) -> dict:
    """The two-pass path (dense binning, the dup gather, K1; K2 and K3 in
    its backward) at full width: the 8 ring views through render_adaptive
    with every plain kernel version and the fused path refused, each
    image held to the fused path's; one fwd+bwd at view 0 whose gradients
    are held to the fused path's and whose K1, K2, K3 arguments are held
    to the plain versions; then the tiled mode at view 0, forward."""
    renders = 0

    def counted(*args, **kwargs):
        nonlocal renders
        renders += 1
        return render_model(*args, **kwargs)

    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    caps, outs, tp_caps = CAPS, [], []
    t0 = time.perf_counter()
    with no_fallback(), torch.no_grad():
        for cam in cams:
            out, caps = adaptive.render_adaptive(counted, caps, model, cam, mode="pallas_twopass")
            outs.append(out)
            tp_caps.append(caps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serve = launches()
    ovfs = [adaptive.read_overflow(o) for o in outs]
    print(f"[14] two-pass serving: {len(cams)} views, {renders} renders (incl. cap growth), "
          f"launches (K1, K2, K3, binning, preprocess, preprocess bwd) {serve}, {wall_s:.2f} s wall; caps after view 0 "
          f"{caps_kw(tp_caps[0])}, after view {len(cams) - 1} {caps_kw(caps)}")
    print(f"    max_tiles_touched per view {[o['max_tiles_touched'] for o in ovfs]}; dense "
          f"expansion {model.capacity} x tile_cap {caps.tile_cap} = "
          f"{model.capacity * caps.tile_cap} slots; num_rendered per view "
          f"{[o['num_rendered'] for o in ovfs]}; deepest tile per view "
          f"{[o['max_tile_count'] for o in ovfs]}; peak memory {peak_gb:.3f} GB "
          f"({base_gb:.3f} GB held before)")
    check(serve == (renders, 0, 0, 0, renders, 0) and renders >= len(cams),
          "two-pass serving: one K1 and one preprocess launch per render, no backward, no plain "
          "version, no fused path (so no binning kernel)")
    errs = {}
    with torch.no_grad():
        for i, (cam, out, ovf) in enumerate(zip(cams, outs, ovfs)):
            zero = all(ovf[k] == 0 for k in ("bin_overflow", "cap_overflow", "tile_overflow"))
            check(zero, f"two-pass view {i}: overflow counters 0")
            fused = render_model(model, cam, **caps_kw(fused_caps[i]))
            if i == 0:
                fused0 = fused
            d = compare_renders(out, fused)
            print(f"[14] two-pass vs fused, view {i}: {json.dumps(d)}")
            check(renders_ok(d, ATOL_IMAGE), f"two-pass view {i} image equals the fused path's "
                  f"(tie rule, {ATOL_IMAGE} elsewhere)")
            errs["twopass_vs_fused"] = max(errs.get("twopass_vs_fused", 0.0), abs_err(d))
    del outs

    # One fwd+bwd at view 0: launches, the kernels on its arguments, the
    # gradients against the fused path's.
    kw0 = caps_kw(tp_caps[0])
    reset_launches()
    with recorded_kernel_args(keep_last=1) as recs, no_fallback():
        g_tp, _ = param_grads(model, cams[0], "pallas_twopass", kw0)
        torch.cuda.synchronize()
    fb_counts = launches()
    check(fb_counts == (1, 1, 1, 0, 1, 1), f"two-pass fwd+bwd at view 0: one launch each of K1, "
          f"K2, K3 and the preprocess pair, none of the binning (got {fb_counts})")
    for k, e in check_recorded(check, recs, "[14]", "two-pass fwd+bwd, view 0").items():
        errs[k] = max(errs.get(k, 0.0), e)
    recs.clear()
    g_fu, _ = param_grads(model, cams[0], "pallas", caps_kw(fused_caps[0]))
    for f in PARAM_FIELDS:
        diff = float((g_tp[f] - g_fu[f]).abs().max())
        scale = float(g_fu[f].abs().max())
        print(f"    gradient {f}: max|two-pass - fused| {diff:.3e}, max|fused| {scale:.3e}")
        check(diff <= TWOPASS_GRAD_RTOL * scale and scale > 0.0,
              f"two-pass gradient of {f} within {TWOPASS_GRAD_RTOL} x max|g| of the fused path's")
    del g_tp, g_fu

    view_ms = {"pallas_twopass": [], "pallas": []}
    with torch.no_grad():
        for cam, c_tp, c_fu in zip(cams, tp_caps, fused_caps):
            for mode, c in (("pallas_twopass", c_tp), ("pallas", c_fu)):
                view_ms[mode].append(cuda_ms(
                    lambda: render_model(model, cam, mode=mode, **caps_kw(c)), reps=3))
    fb_ms = {mode: cuda_ms(lambda: param_grads(model, cams[0], mode, kw), reps=3)
             for mode, kw in (("pallas_twopass", kw0), ("pallas", caps_kw(fused_caps[0])))}

    # The tiled mode at view 0, forward: k_max from the deepest tile (the
    # dense binning's count, the same slots), the capacity the two-pass
    # view grew to, tile_chunk 64.
    k_max_t = -(-ovfs[0]["max_tile_count"] // 128) * 128
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        tiled = render_model(model, cams[0], mode="tiled", dup_capacity=kw0["dup_capacity"],
                             k_max=k_max_t)
        torch.cuda.synchronize()
    tiled_ms = (time.perf_counter() - t0) * 1e3
    tiled_gb = torch.cuda.max_memory_allocated() / 1e9
    t_ovf = adaptive.read_overflow(tiled)
    d = compare_renders(tiled, fused0)
    print(f"[14] tiled, view 0 (k_max {k_max_t}, tile_chunk 64): {tiled_ms:.1f} ms host clock, "
          f"peak {tiled_gb:.3f} GB, counters {json.dumps(t_ovf)}; vs fused {json.dumps(d)}")
    check(t_ovf["bin_overflow"] == 0 and t_ovf["tile_overflow"] == 0,
          "tiled view 0: no slot dropped")
    check(renders_ok(d, ATOL_IMAGE), f"tiled view 0 equals the fused path's image (tie rule, "
          f"{ATOL_IMAGE} elsewhere)")
    errs["tiled_vs_fused"] = abs_err(d)
    del tiled, fused0
    tp_med = statistics.median(view_ms["pallas_twopass"])
    fu_med = statistics.median(view_ms["pallas"])
    print(f"[14] timing on {card}: ms per view, median of {len(cams)} (CUDA events, 3 reps "
          f"each): two-pass {tp_med:.3f} ms ({', '.join(f'{v:.3f}' for v in view_ms['pallas_twopass'])}), "
          f"fused {fu_med:.3f} ms ({', '.join(f'{v:.3f}' for v in view_ms['pallas'])}); fwd+bwd at "
          f"view 0: two-pass {fb_ms['pallas_twopass']:.3f} ms, fused {fb_ms['pallas']:.3f} ms; "
          f"tiled forward {tiled_ms:.1f} ms")
    return dict(launches=tuple(a + b for a, b in zip(serve, fb_counts)), errs=errs,
                view_ms=view_ms, fb_ms=fb_ms, tiled_ms=tiled_ms, peak_gb=peak_gb)


def oracle_scene(device):
    """bench.py's blob at 2^14 Gaussians and a 128x128 camera at the
    origin: (render_fn args, kwargs) for rasterize_gaussians."""
    means, scales, quats, opac, colors = bench._scene_trained(ORACLE_N,
                                                              np.random.default_rng(ORACLE_SEED))
    cam = make_camera(np.eye(3), np.zeros(3), FOV, FOV, ORACLE_HW, ORACLE_HW, device=device)
    settings = rc.from_camera(cam, bg=torch.tensor([0.1, 0.2, 0.3], device=device))
    t = [torch.as_tensor(x, device=device) for x in (means, scales, quats, opac, colors)]
    return (t[0], t[3], settings), dict(scales=t[1], quaternions=t[2], colors=t[4])


def phase_oracle_triangle(check, dev) -> dict:
    """reference, tiled and pallas_twopass on a 2^14-Gaussian scene at
    128x128: tiled and two-pass against reference, and each mode on the
    card against the CPU, at tests/test_raster.py's 1e-5. On the card every
    mode runs inside no_fallback(): reference and tiled launch no kernel,
    two-pass one K1 per render, held to its plain version on the last
    render's arguments."""
    outs, errs, card_launches = {}, {}, (0,) * 6
    for d in (dev, torch.device("cpu")):
        args, kw = oracle_scene(d)
        on_card = d.type == "cuda"
        for mode in ("reference", "tiled", "pallas_twopass"):
            renders = 0

            def counted(*a, **k):
                nonlocal renders
                renders += 1
                return rasterize_gaussians(*a, **k)

            reset_launches()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack, torch.no_grad():
                if on_card:
                    recs = stack.enter_context(recorded_kernel_args(keep_last=1))
                    stack.enter_context(no_fallback())
                out, caps = adaptive.render_adaptive(counted, ORACLE_CAPS, *args, mode=mode, **kw)
                if on_card:
                    torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            outs[(d.type, mode)] = {k: out[k].cpu() for k in ("image", "final_T", "n_contrib")}
            counts = launches()
            print(f"[14] oracle scene, {mode} on {d.type}: {ms:.1f} ms host (adaptive caps "
                  f"{caps_kw(caps)}, {renders} renders, launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts}), "
                  f"final_T "
                  f"min {float(out['final_T'].min()):.3e}, n_contrib max "
                  f"{int(out['n_contrib'].max())}")
            if not on_card:
                continue
            want = (renders, 0, 0, 0, 0, 0) if mode == "pallas_twopass" else (0,) * 6
            check(counts == want, f"oracle scene, {mode} on the card: launches {want} "
                  f"(got {counts})")
            card_launches = tuple(a + b for a, b in zip(card_launches, counts))
            if mode == "pallas_twopass":
                for k, e in check_recorded(check, recs, "[14]", "oracle scene two-pass, last "
                                           "render").items():
                    errs[k] = max(errs.get(k, 0.0), e)
    pairs = [((dev.type, "tiled"), (dev.type, "reference")),
             ((dev.type, "pallas_twopass"), (dev.type, "reference"))]
    pairs += [((dev.type, m), ("cpu", m)) for m in ("reference", "tiled", "pallas_twopass")]
    for a, b in pairs:
        d = compare_renders(outs[a], outs[b])
        print(f"[14] oracle scene, {a[1]} on {a[0]} vs {b[1]} on {b[0]}: {json.dumps(d)}")
        check(renders_ok(d, ORACLE_ATOL), f"oracle scene: {a} vs {b} within {ORACLE_ATOL} "
              f"(tie rule)")
        errs[f"{a} vs {b}"] = abs_err(d)
    return dict(errs=errs, launches=card_launches)


def phase_compositor(check, dev, params, bm, card) -> dict:
    """demo_hybrid.run_demo on a refined model with the demo's defaults
    (8 orbit frames at 256x256, then 8 composite frames of the model and a
    spinning copy), each composite_render call timed and its counters
    kept; the frames loaded back; one composite frame of a subset on the
    card against the CPU."""
    root = os.path.join(WORK, "compositor")
    os.makedirs(root, exist_ok=True)
    ply = os.path.join(root, "refined.ply")
    save_refined_state(params, bm, ply.replace(".ply", "_state.pkl"))
    calls = []
    orig = demo_hybrid.composite_render

    def timed(sets, cam, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(sets, cam, **kw)
        torch.cuda.synchronize()
        calls.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          n=sum(s.centers.shape[0] for s in sets), **adaptive.read_overflow(out)))
        return out

    demo_hybrid.composite_render = timed
    reset_launches()
    try:
        t0 = time.perf_counter()
        with no_fallback():
            written = demo_hybrid.run_demo(ply, os.path.join(root, "frames"), device=dev)
        wall_s = time.perf_counter() - t0
    finally:
        demo_hybrid.composite_render = orig
    check(launches() == (0,) * 6, f"run_demo: the compositor's tiled mode launches no kernel "
          f"(got {launches()})")
    n = int(params.opacity_logit.shape[0])
    print(f"[14] demo_hybrid.run_demo on [11]'s refined model ({n} Gaussians; k_max 1024, "
          f"dup_capacity {max(16 * n, 2**15)}, twice both in the composite frames), {wall_s:.2f} s "
          f"wall on {card}:")
    for kind, lo in (("hybrid", 0), ("composite", len(written["hybrid"]))):
        rows = calls[lo:lo + len(written[kind])]
        print(f"    {kind}: ms per frame {[round(r['ms'], 2) for r in rows]}; tile_overflow "
              f"{[r['tile_overflow'] for r in rows]}; deepest tile "
              f"{[r['max_tile_count'] for r in rows]}; bin_overflow "
              f"{[r['bin_overflow'] for r in rows]}")
    frames = [read_png(p) for v in written.values() for p in v]
    check(len(frames) == 16 and all(f.shape == (256, 256, 3) and f.max() > 50 for f in frames),
          "run_demo: 16 frames at 256x256 written and loaded back, none blank")
    check(all(r["bin_overflow"] == 0 for r in calls), "run_demo: no dup slot dropped by binning")
    overflowed = sum(r["tile_overflow"] > 0 for r in calls)

    # One composite frame of a subset, card against CPU.
    ga = refine_bound.to_gaussian_arrays(params, bm)
    sub = {k: v[:DEMO_SUBSET].detach() for k, v in ga.items()}
    c = sub["centers"].mean(dim=0).cpu().numpy()
    r = 2.8 * float(torch.linalg.norm(sub["centers"] - torch.as_tensor(c, device=dev), dim=-1).max())
    th = 2 * np.pi / 8
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                 np.float32)
    offset = np.array([1.2 * r / 2.8, 0.0, 0.0], np.float32)
    outs = {}
    with torch.no_grad():
        for d in (dev, torch.device("cpu")):
            s = {k: v.to(d) for k, v in sub.items()}
            colors = torch.clamp(sh0_to_rgb(s["sh"][:, :, 0]), 0.0, 1.0)
            base = dict(centers=s["centers"], scales=s["scales"], quaternions=s["quaternions"],
                        opacities=s["opacities"], colors=colors)
            sets = [GaussianSet(**base), GaussianSet(
                **base, transform_R=torch.as_tensor(R, device=d),
                transform_t=torch.as_tensor(c + offset - R @ c, device=d))]
            cam = demo_hybrid.orbit_cameras(c, r, 8, res=256, device=d)[1]
            out = composite_render(sets, cam, dup_capacity=2 * max(16 * DEMO_SUBSET, 2**15))
            outs[d.type] = {k: out[k].cpu() for k in ("image", "final_T", "n_contrib")}
    dd = compare_renders(outs[dev.type], outs["cpu"])
    print(f"[14] composite frame of {DEMO_SUBSET} Gaussians + their moved copy, card vs CPU: "
          f"{json.dumps(dd)}")
    check(renders_ok(dd, ORACLE_ATOL), f"composite frame: card within {ORACLE_ATOL} of the CPU "
          f"(tie rule)")
    return dict(calls=calls, wall_s=wall_s, overflowed=overflowed, err=abs_err(dd))


def phase_entry_points(check, dev, scene, artifacts) -> dict:
    """scripts.render, compose_animation and train_vanilla_gs on [13]'s
    parity scene (written to disk) and its artifacts; every output loaded
    back. Each entry point's launches are counted and checked (K1 and the
    binning once per view for render, none for the compositor, K1-K3 and
    the binning once per iteration for training), and its last launches'
    arguments held to the plain versions."""
    root = os.path.join(WORK, "entry")
    scene_dir = os.path.join(root, "scene")
    write_nerf_synthetic(scene, [np.ones(img.shape[:2], np.float32) for img in scene.images],
                         scene_dir)
    walls, counts, errs = {}, {}, {}

    def entry(name, fn, want, refuse=False):
        """timed_entry, inside no_fallback() when ``refuse``."""
        r, walls[name], counts[name], e = timed_entry(
            check, "[14]", name, fn, want, no_fallback if refuse else contextlib.nullcontext)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        return r

    out = os.path.join(root, "renders")
    entry("render", lambda: render_script.main(
        ["-s", scene_dir, "-c", artifacts["vanilla"], "-o", out], device=dev),
        (len(scene.cameras), 0, 0, len(scene.cameras), len(scene.cameras), 0))
    loaded = load_scene(PipelineConfig(scene_path=scene_dir), device=dev)
    _, test_idx = loaded.split(True)
    model = load_ply(artifacts["vanilla"], device=dev)
    worst = 0
    for k, i in enumerate(test_idx):
        got = read_png(os.path.join(out, "test", "renders", f"{k:05d}.png")).astype(np.int16)
        with torch.no_grad():
            want = render_model(model, loaded.cameras[i])["image"].cpu().numpy()
        worst = max(worst, int(np.abs(got - (np.clip(want, 0, 1) * 255).astype(np.uint8)).max()))
    n_train = len(os.listdir(os.path.join(out, "train", "renders")))
    print(f"[14] scripts.render on [13]'s vanilla PLY over its scene ({len(scene.cameras)} views "
          f"at {ENTRY_HW}x{ENTRY_HW} on disk): {walls['render']:.2f} s, launches (K1, K2, K3, "
          f"binning) "
          f"{counts['render']}; {n_train} train and {len(test_idx)} test renders; held-out PNGs "
          f"vs render_model, max {worst} levels")
    check(n_train == len(scene.cameras) - len(test_idx) and worst <= 1,
          "scripts.render: every render and GT written; the PNGs load back and equal "
          "render_model's images (1 level)")

    # compose_animation: the vanilla and coarse PLYs, a 4-frame orbit and
    # per-frame transforms, as io/blender_interop reads them.
    traj, anim = os.path.join(root, "traj.json"), os.path.join(root, "anim.json")
    lens = 18.0 / math.tan(0.45)  # 36 mm sensor, the parity cameras' 0.9 rad field of view
    frames = []
    for cam in scene.cameras[:4]:
        c2w = np.linalg.inv(cam.world_view.cpu().numpy().astype(np.float64))
        c2w[:3, 1:3] *= -1
        frames.append(dict(matrix_world=c2w.reshape(-1).tolist(), lens=lens))
    with open(traj, "w") as f:
        json.dump(frames, f)
    with open(anim, "w") as f:
        json.dump([[dict(R=np.eye(3).tolist(), t=[0, 0, 0]),
                    dict(R=np.eye(3).tolist(), t=[0.3 * k, 0, 0])] for k in range(4)], f)
    paths = entry("compose_animation", lambda: compose_animation.main(
        ["--ply", artifacts["vanilla"], "--ply", artifacts["coarse"], "--trajectory", traj,
         "--animation", anim, "--height", str(ENTRY_HW), "--width", str(ENTRY_HW),
         "-o", os.path.join(root, "frames")], device=dev), (0,) * 6, refuse=True)
    imgs = [read_png(p) for p in paths]
    print(f"[14] compose_animation, 2 PLYs x 4 frames at {ENTRY_HW}x{ENTRY_HW} (the compositor's "
          f"tiled mode): {walls['compose_animation']:.2f} s; frame means "
          f"{[round(float(i.mean()), 2) for i in imgs]}")
    check(len(imgs) == 4 and all(i.shape == (ENTRY_HW, ENTRY_HW, 3) and i.max() > 50 for i in imgs),
          "compose_animation: 4 frames written and loaded back, none blank")

    ckpt = entry("train_vanilla_gs", lambda: train_vanilla_gs.main(
        ["-s", scene_dir, "-o", os.path.join(root, "vanilla"), "--iterations",
         str(ENTRY_VANILLA_ITERS)], device=dev), (ENTRY_VANILLA_ITERS,) * 6)
    trained = load_ply(ckpt, device=dev)
    finite = all(bool(torch.isfinite(getattr(trained.params, f)).all()) for f in PARAM_FIELDS)
    print(f"[14] train_vanilla_gs, {ENTRY_VANILLA_ITERS} iterations on that scene (the loader's "
          f"100,000-point random init, capacity {trained.capacity}): "
          f"{walls['train_vanilla_gs']:.2f} s, launches (K1, K2, K3, binning, preprocess, preprocess bwd) "
          f"{counts['train_vanilla_gs']}; checkpoint {int(trained.alive.sum())} Gaussians")
    check(finite and int(trained.alive.sum()) > 0, "train_vanilla_gs: the checkpoint loads back, "
          "finite, with live Gaussians")
    return dict(walls=walls, errs=errs,
                launches=tuple(sum(c[k] for c in counts.values()) for k in range(6)))


# --- [15] the multi-device paths ----------------------------------------

PAR_WORLD = 4
PAR_GRAD_RTOL = 1e-4  # sharded vs single-device gradients, x max|g| per input
PAR_LOSS_RTOL = 1e-4  # sharded vs single-device loss, x max(1, |loss|)
PAR_RTOL, PAR_ATOL = 2e-3, 2e-5  # tests/test_parallel.py's 1-vs-8 device tolerance
PAR_TIMED_STEPS = 10
PAR_STEP_IT = 0
LEVELSET_CAMS = 4
PAR_LAYOUT = "4 ranks sharing one card (gloo, host-staged collectives)"


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms inside the block (warning, not
    raising, where an op has none)."""
    was, warn = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def rank_checks() -> tuple[Checks, str]:
    return Checks(), f"[15] rank {dist.get_rank()}"


def sharded_views(check, dev, axis, model, cams, kws: list[dict], tag: str, label: str) -> dict:
    """The tile-sharded render of each view on every rank of ``axis``, with
    the plain kernels and the fused path refused; rank 0 then holds each
    whole image to ``render_model``'s fused render at the same caps (the
    tie rule) and the three overflow counters to 0."""
    comm.reset_counters()
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    outs, ms = [], []
    with no_fallback(), torch.no_grad():
        for cam, kw in zip(cams, kws):
            st = dataclasses.replace(rc.from_camera(cam, device=dev), sh_degree=model.sh_degree)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            o = render_sharded(axis, model.params.xyz, model.opacities, st, scales=model.scales,
                               quaternions=model.quaternions, shs=model.sh,
                               alive_mask=model.alive, tile_cap=kw["tile_cap"],
                               k_max=kw["k_max"])
            full = {k: gather_band(o[k], axis, st) for k in ("image", "final_T", "n_contrib")}
            e1.record()
            torch.cuda.synchronize(dev)
            ms.append(e0.elapsed_time(e1))
            full.update({k: int(o[k]) for k in ("route_overflow", "tile_overflow",
                                                 "kmax_overflow")})
            outs.append(full)
    res = dict(counts=launches(), bytes=comm.counters(), ms=ms,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9, errs={})
    check(res["counts"] == (len(cams), 0, 0, 0, 0, 0),
          f"{label}: one K1 launch per view on this rank, no backward, no plain version, no "
          f"fused path and so no binning kernel (got {res['counts']})")
    if axis.index == 0:
        with torch.no_grad():
            for i, (cam, kw, out) in enumerate(zip(cams, kws, outs)):
                ovf = {k: out[k] for k in ("route_overflow", "tile_overflow", "kmax_overflow")}
                d = compare_renders(out, render_model(model, cam, **kw))
                print(f"{tag} {label}, view {i}: {json.dumps(ovf)}; vs fused {json.dumps(d)}",
                      flush=True)
                check(all(v == 0 for v in ovf.values()), f"{label} view {i}: the three "
                      "overflow counters are 0")
                check(renders_ok(d, ATOL_IMAGE), f"{label} view {i} equals the fused render "
                      f"(tie rule, {ATOL_IMAGE} elsewhere; n_contrib equal off the ties)")
                res["errs"]["image"] = max(res["errs"].get("image", 0.0), abs_err(d))
    return res


def sharded_fwd_bwd(check, dev, axis, model, cam, kw: dict, tag: str) -> dict:
    """One tile-sharded forward and backward at ``cam`` (loss sum(image^2),
    bench.py's) with the plain kernels and the fused path refused and the
    kernels' arguments recorded; K1, K2, K3 held to their plain versions on
    them; rank 0 holds the gradients of the five inputs to the fused
    path's."""
    st = dataclasses.replace(rc.from_camera(cam, device=dev), sh_degree=model.sh_degree)
    whole = [model.params.xyz, model.opacities, model.scales, model.quaternions, model.sh]
    leaves = [x.detach().clone().requires_grad_(True) for x in whole]
    reset_launches()
    with recorded_kernel_args(keep_last=1) as recs, no_fallback():
        o = render_sharded(axis, leaves[0], leaves[1], st, scales=leaves[2],
                           quaternions=leaves[3], shs=leaves[4], alive_mask=model.alive,
                           tile_cap=kw["tile_cap"], k_max=kw["k_max"])
        loss = (gather_band(o["image"], axis, st) ** 2).sum()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize(dev)
    counts = launches()
    check(counts == (1, 1, 1, 0, 0, 0), f"tile-sharded fwd+bwd: one launch each of K1, K2, K3 on "
          f"this rank, none of the binning (got {counts})")
    errs = check_recorded(check, recs, tag, "tile-sharded fwd+bwd, view 0 (this rank's band)")
    recs.clear()
    grads = [comm.all_gather(shard_of(g, axis).contiguous(), axis) for g in grads]
    if axis.index == 0:
        ref = [x.detach().clone().requires_grad_(True) for x in whole]
        out = rasterize_gaussians(ref[0], ref[1], st, scales=ref[2], quaternions=ref[3],
                                  shs=ref[4], alive_mask=model.alive, mode="pallas", **kw)
        (out["image"] ** 2).sum().backward()
        for name, g, r in zip(("means", "opacities", "scales", "quaternions", "shs"), grads, ref):
            diff, scale = float((g - r.grad).abs().max()), float(r.grad.abs().max())
            print(f"{tag} fwd+bwd gradient of {name}: max|sharded - fused| {diff:.3e}, "
                  f"max|fused| {scale:.3e}", flush=True)
            check(diff <= PAR_GRAD_RTOL * scale and scale > 0.0,
                  f"tile-sharded gradient of {name} within {PAR_GRAD_RTOL} x max|g| of the "
                  "fused path's")
    return dict(counts=counts, errs=errs)


def step_close(check, label: str, new, ref, lrs: dict, fields, tag: str) -> None:
    """A sharded step's new state against the single-device step's from
    the same state (Adam's first step, so mu = 0.1 g): the loss within
    PAR_LOSS_RTOL, each field's gradient (mu / 0.1) within PAR_GRAD_RTOL x
    max|g|, and its parameters within tests/test_parallel.py's rtol
    2e-3 / atol 2e-5 wherever |g| exceeds that gradient tolerance; where
    |g| is within it of 0 (float noise, e.g. the rotation about a
    Gaussian's symmetry axis), Adam's eps 1e-15 turns its sign into a
    +-lr move, and the parameter is held to 2 lr."""
    (p, mu, loss), (rp, rmu, rloss) = new, ref
    check(abs(loss - rloss) <= PAR_LOSS_RTOL * max(1.0, abs(rloss)),
          f"{label}: loss {loss:.6f} within {PAR_LOSS_RTOL} of the single-device {rloss:.6f}")
    for f in fields:
        g, rg = getattr(mu, f) / 0.1, getattr(rmu, f) / 0.1
        gscale = float(rg.abs().max()) if rg.numel() else 0.0
        gdiff = float((g - rg).abs().max()) if rg.numel() else 0.0
        tol = PAR_GRAD_RTOL * gscale
        noise = rg.abs() <= tol
        a, b = getattr(p, f), getattr(rp, f)
        lr = float(lrs[f](PAR_STEP_IT))
        far = ((a - b).abs() > PAR_ATOL + PAR_RTOL * b.abs()) & ~noise
        near = ((a - b).abs() > 2 * lr * (1 + 1e-5)) & noise
        print(f"{tag} {label} {f}: max|dg| {gdiff:.3e} of max|g| {gscale:.3e}; params off "
              f"tolerance {int(far.sum())}, noise-level gradients {int(noise.sum())} of "
              f"{rg.numel()} (off 2 lr: {int(near.sum())})", flush=True)
        check(gdiff <= tol and not bool(far.any()) and not bool(near.any()),
              f"{label}: {f} gradient and parameters match the single-device step")


def vanilla_step_reference(params, alive, cams, gts, lrs, optim, deg, kw, dev):
    """The single-device step of the mean loss over ``cams`` (the JAX
    sharded step's semantics): (params, mu, loss, stats)."""
    leaves = [getattr(params, f).detach().clone().requires_grad_(True) for f in PARAM_FIELDS]
    probe = torch.zeros((params.xyz.shape[0], 2), device=dev, requires_grad=True)
    bg = torch.zeros(3, device=dev)
    loss, grads, radii = 0.0, None, []
    for cam, gt in zip(cams, gts):  # one view's graph at a time
        out = render_params(GaussianParams(**dict(zip(PARAM_FIELDS, leaves))), alive, cam, deg,
                            bg, ndc_offset=probe, **kw)
        lv = rgb_loss_l1_dssim(rc.clip(out["image"], 0.0, 1.0), gt, 0.2) / len(cams)
        g = torch.autograd.grad(lv, leaves + [probe], allow_unused=True)
        g = [torch.zeros_like(x) if gi is None else gi for x, gi in zip(leaves + [probe], g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss += float(lv)
        radii.append(out["radii"])
    p, a = opt.adam_step(params, GaussianParams(**dict(zip(PARAM_FIELDS, grads[:-1]))),
                         opt.init_adam(params), PAR_STEP_IT, lrs, optim)
    stats = update_stats(DensifyStats.zeros(params.xyz.shape[0], device=dev), grads[-1],
                         torch.stack(radii).amax(0))
    return (p, a.mu, loss), stats


def timed_steps(step, state: list, args: tuple) -> list[float]:
    """ms of PAR_TIMED_STEPS vanilla steps (CUDA events on this rank), each
    from the last one's (params, adam, stats); ``state`` is (params, alive,
    adam, stats)."""
    p, alive, a, st = state
    ms = []
    for _ in range(PAR_TIMED_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p, a, st, _ = step(p, alive, a, st, *args)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return ms


def parallel_training(check, dev, axis, data: dict, tag: str) -> dict:
    """The (2, 2) sharded step and the world-4 tile-sharded step on [7]'s
    scene from its perturbed start, each held to the single-device step
    after one step and timed over PAR_TIMED_STEPS; the kernels held to
    their plain versions on the tile-sharded step's arguments."""
    fields, alive_np = pad_fields(train_scene_fields(TRAIN_N, TRAIN_SEED), TRAIN_CAPACITY)
    targets = [torch.as_tensor(t, device=dev) for t in data["targets"][:2]]
    perturbed = dict(fields)
    noise = np.random.default_rng(TRAIN_SEED + 1).normal(0, 0.5, fields["sh_dc"].shape)
    perturbed["sh_dc"] = (fields["sh_dc"] + np.where(alive_np[:, None], noise, 0)).astype(np.float32)
    model = model_from_numpy(perturbed, alive_np, 0, device=dev)
    cams = ring_cameras(VIEWS, dev)[:2]
    optim = opt.OptimConfig(feature_lr=0.02)
    lrs = opt.group_lrs(optim, spatial_lr_scale=1.0)
    kw = dict(dup_capacity=TRAIN_CAPS.dup_capacity, k_max=TRAIN_CAPS.k_max)
    cap = TRAIN_CAPACITY
    res = {}

    mesh = make_mesh(2, 2, device=dev)
    step = make_sharded_train_step(mesh, lrs, optim, 0, **kw)
    state = [shard_params(x, mesh.gauss) for x in (model.params, model.alive,
                                                   opt.init_adam(model.params),
                                                   DensifyStats.zeros(cap, device=dev))]
    reset_launches()
    with no_fallback(refuse_fused=False):
        p, a, stats, aux = step(*state, cams, targets, PAR_STEP_IT)
        torch.cuda.synchronize()
    res["counts_2x2"] = launches()
    check(res["counts_2x2"] == (1,) * 6, f"(2, 2) step: one launch each of K1, K2, K3, the "
          f"binning and the preprocess pair on this rank (got {res['counts_2x2']})")
    whole = (gather_params(p, mesh.gauss), gather_params(a.mu, mesh.gauss), float(aux["loss"]))
    whole_stats = gather_params(stats, mesh.gauss)
    if axis.index == 0:
        ref, rstats = vanilla_step_reference(model.params, model.alive, cams, targets, lrs,
                                             optim, 0, kw, dev)
        step_close(check, "(2, 2) vanilla step", whole, ref, lrs, PARAM_FIELDS, tag)
        check(torch.equal(whole_stats.denom, rstats.denom)
              and torch.equal(whole_stats.max_radii, rstats.max_radii)
              and float((whole_stats.grad_accum - rstats.grad_accum).abs().max())
              <= PAR_GRAD_RTOL * float(rstats.grad_accum.abs().max()),
              "(2, 2) vanilla step: densify statistics (the norm of the summed ndc gradient, "
              "the max radii over the views) match the single-device step's")
    res["ms_2x2"] = timed_steps(step, state, (cams, targets, PAR_STEP_IT))

    tstep = make_tile_sharded_train_step(axis, lrs, optim, 0, tile_cap=16, k_max=kw["k_max"])
    state = [shard_params(x, axis) for x in (model.params, model.alive,
                                             opt.init_adam(model.params),
                                             DensifyStats.zeros(cap, device=dev))]
    reset_launches()
    with recorded_kernel_args(keep_last=1) as recs, no_fallback():
        p, a, stats, aux = tstep(*state, cams[0], targets[0], PAR_STEP_IT)
        torch.cuda.synchronize()
    res["counts_tile"] = launches()
    check(res["counts_tile"] == (1, 1, 1, 0, 0, 0), f"tile-sharded step: one launch each of K1, K2, "
          f"K3 on this rank, none of the binning (got {res['counts_tile']})")
    res["errs"] = check_recorded(check, recs, tag, "tile-sharded train step (this rank's band)")
    recs.clear()
    ovf = {k: int(aux[k]) for k in ("route_overflow", "tile_overflow", "kmax_overflow")}
    check(all(v == 0 for v in ovf.values()), f"tile-sharded step: overflow counters 0 {ovf}")
    whole = (gather_params(p, axis), gather_params(a.mu, axis), float(aux["loss"]))
    if axis.index == 0:
        cfg = TrainConfig(sh_degree=0, capacity=cap, optim=optim)
        caps = adaptive.RasterCaps(tile_cap=16, **kw)
        rp, ra, _, raux = make_train_step(cfg, lrs, 0, caps)(
            model.params, model.alive, opt.init_adam(model.params),
            DensifyStats.zeros(cap, device=dev), cams[0], targets[0], PAR_STEP_IT)
        step_close(check, "tile-sharded vanilla step", whole, (rp, ra.mu, float(raux["loss"])),
                   lrs, PARAM_FIELDS, tag)
    res["ms_tile"] = timed_steps(tstep, state, (cams[0], targets[0], PAR_STEP_IT))
    return res


def parallel_coarse(check, dev, axis, data: dict, tag: str) -> dict:
    """The ring KNN (k 16) over [9]'s pruned model against the single-device
    KNN, then one (2, 2) coarse 'sdf' step from it held to the single-device
    step of the same two views and draws."""
    model = to_device(data["coarse_model"], dev)
    extent = data["extent"]
    res = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_ring, i_ring = knn_sharded(axis, model.params.xyz, model.params.xyz, 16,
                                 ref_mask=model.alive)
    torch.cuda.synchronize()
    res["knn_s"] = time.perf_counter() - t0
    if axis.index == 0:
        d1, i1 = knn(model.params.xyz, model.params.xyz, 16, ref_mask=model.alive)
        off = i_ring != i1
        tie = off & (d_ring == d1)
        print(f"{tag} ring KNN over {model.capacity} slots ({int(model.alive.sum())} alive), "
              f"k 16: {res['knn_s']:.2f} s; indices differing from the single-device KNN "
              f"{int(off.sum())}, of which at exactly equal distances {int(tie.sum())}",
              flush=True)
        check(not bool((off & ~tie).any()), "ring KNN indices equal the single-device KNN's "
              "off exact distance ties")
        res["knn_diff"] = int(off.sum())
    mesh = make_mesh(2, 2, device=dev)
    cfg = CoarseConfig()
    lrs = opt.group_lrs(cfg.optim, spatial_lr_scale=extent)
    dup = cfg.dup_capacity_mult * model.capacity
    it = COARSE_MILESTONE + 1
    cams = ring_cameras(VIEWS, dev)[:2]
    gts = [torch.as_tensor(t, device=dev) for t in data["targets"][:2]]
    knn_idx = i_ring
    step = make_sharded_coarse_step(mesh, cfg, lrs, extent, dup, False, True)
    reset_launches()
    # The field query's gathers add their cotangents with atomics; the
    # deterministic algorithms make a rerun (and the sharded step against
    # the single-device one) comparable below float noise.
    with no_fallback(refuse_fused=False), deterministic():
        p, a, aux = step(shard_params(model.params, mesh.gauss),
                         shard_params(model.alive, mesh.gauss),
                         shard_params(opt.init_adam(model.params), mesh.gauss),
                         shard_params(knn_idx, mesh.gauss), cams, gts, it,
                         [iteration_generator(0, it + j, dev) for j in range(2)])
        torch.cuda.synchronize()
    res["counts"] = launches()
    check(res["counts"] == (2, 2, 2, 2, 1, 1), f"(2, 2) coarse 'sdf' step: two launches each of "
          f"K1, K2, K3 and the binning on this rank, image and depth, one of the preprocess pair "
          f"(the image) (got {res['counts']})")
    whole = (gather_params(p, mesh.gauss), gather_params(a.mu, mesh.gauss), float(aux["loss"]))
    if axis.index == 0:
        def reference():
            leaves = [getattr(model.params, f).detach().clone().requires_grad_(True)
                      for f in PARAM_FIELDS]
            loss, grads = 0.0, None
            for j, (cam, gt) in enumerate(zip(cams, gts)):  # one view's graph at a time
                lv = coarse_mod.coarse_loss(
                    cfg, GaussianParams(**dict(zip(PARAM_FIELDS, leaves))), model.alive, knn_idx,
                    cam, gt, iteration_generator(0, it + j, dev), extent, dup, False, True)[0] / 2
                g = torch.autograd.grad(lv, leaves, allow_unused=True)
                g = [torch.zeros_like(x) if gi is None else gi for x, gi in zip(leaves, g)]
                grads = g if grads is None else [u + v for u, v in zip(grads, g)]
                loss += float(lv)
            rp, ra = opt.adam_step(model.params, GaussianParams(**dict(zip(PARAM_FIELDS, grads))),
                                   opt.init_adam(model.params), it, lrs, cfg.optim)
            return rp, ra.mu, loss

        with deterministic():
            ref, again = reference(), reference()
        spread = {f: float((getattr(ref[1], f) - getattr(again[1], f)).abs().max())
                  for f in PARAM_FIELDS if getattr(ref[1], f).numel()}
        print(f"{tag} coarse reference run twice, max|d mu| per field {json.dumps(spread)}",
              flush=True)
        step_close(check, "(2, 2) coarse 'sdf' step", whole, ref,
                   {f: (lambda s, f=f: lrs[f](it)) for f in PARAM_FIELDS},
                   [f for f in PARAM_FIELDS if getattr(ref[0], f).numel()], tag)
    return res


def parallel_refine(check, dev, axis, data: dict, tag: str) -> dict:
    """One (2, 2) refine step on [11]'s mesh (RefineConfig's defaults, SH
    3) held to the single-device step of the same two views."""
    verts, faces, vc = data["mesh"]
    cfg = RefineConfig()
    params, bm = init_bound_params(verts, faces, vc, n_gaussians_per_triangle=1,
                                   extent=data["extent"], sh_degree=cfg.sh_degree, device=dev)
    pairs = torch.as_tensor(normal_consistency_pairs(faces).astype(np.int64), device=dev)
    bbox_radius = 0.5 * float(np.linalg.norm(verts.max(0) - verts.min(0)))
    lrs = bound_lrs(cfg, 10.0 * bbox_radius / np.sqrt(len(verts)))
    dup = cfg.dup_capacity_mult * params.opacity_logit.shape[0]
    cams = ring_cameras(VIEWS, dev)[:2]
    gts = [torch.as_tensor(t, device=dev) for t in data["targets"][:2]]
    mesh = make_mesh(2, 2, device=dev)
    p, a, sharded = shard_bound_state(mesh.gauss, params, init_bound_adam(params))
    step = make_sharded_refine_step(mesh, cfg, bm, pairs, lrs, cfg.sh_degree, dup, sharded)
    reset_launches()
    with no_fallback(refuse_fused=False):
        p, a, aux = step(p, a, cams, gts, PAR_STEP_IT)
        torch.cuda.synchronize()
    counts = launches()
    check(counts == (1,) * 6, f"(2, 2) refine step: one launch each of K1, K2, K3, the preprocess pair and the "
          f"binning on this rank (got {counts})")
    whole = (gather_bound(p, mesh.gauss, sharded), gather_bound(a.mu, mesh.gauss, sharded),
             float(aux["loss"]))
    if axis.index == 0:
        leaves = [getattr(params, f).detach().clone().requires_grad_(True) for f in BOUND_FIELDS]
        loss, grads = 0.0, None
        for cam, gt in zip(cams, gts):  # one view's graph at a time
            lv = refine_loss(cfg, refine_bound.BoundParams(**dict(zip(BOUND_FIELDS, leaves))),
                             bm, pairs, cam, gt, cfg.sh_degree, dup)[0] / 2
            g = torch.autograd.grad(lv, leaves)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            loss += float(lv)
        rp, ra = bound_adam_step(params, refine_bound.BoundParams(**dict(zip(BOUND_FIELDS,
                                                                              grads))),
                                 init_bound_adam(params), PAR_STEP_IT, lrs, cfg)
        print(f"{tag} refine: {len(verts)} vertices, {params.opacity_logit.shape[0]} Gaussians; "
              f"sharded fields {[f for f, v in sharded.items() if v]}", flush=True)
        step_close(check, "(2, 2) refine step", whole, (rp, ra.mu, loss), lrs,
                   BOUND_FIELDS, tag)
    return dict(counts=counts)


def parallel_rank(dev, data: dict) -> dict:
    """[15]'s world-4 phases on this rank (run_ranks entry): (a) the 1M
    model's ring views tile-sharded, (b) its fwd+bwd at view 0, (d) the
    sharded vanilla steps, (e) the ring KNN and the coarse step, (f) the
    refine step. Rank 0 gathers every rank's failed checks, launch counts
    and kernel errors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check, tag = rank_checks()
    axis = world_axis()
    arrays = scene_params(N_GAUSS, SCENE_SEED, SH_DEGREE)
    model = model_from_numpy(arrays, np.ones(N_GAUSS, bool), SH_DEGREE, device=dev)
    cams = ring_cameras(VIEWS, dev)
    t0 = time.perf_counter()
    res = dict(serve=sharded_views(check, dev, axis, model, cams, data["view_kw"], tag,
                                   "tile-sharded serving"))
    res["serve_s"] = time.perf_counter() - t0
    res["fb"] = sharded_fwd_bwd(check, dev, axis, model, cams[0], data["view_kw"][0], tag)
    del model
    torch.cuda.empty_cache()  # four ranks share the card: hand back each phase's peak
    t0 = time.perf_counter()
    res["train"] = parallel_training(check, dev, axis, data, tag)
    res["train_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["coarse"] = parallel_coarse(check, dev, axis, data, tag)
    res["coarse_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["refine"] = parallel_refine(check, dev, axis, data, tag)
    res["refine_s"] = time.perf_counter() - t0
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    mine = dict(failures=check.failures, peak_gb=res["peak_gb"],
                counts=[res["serve"]["counts"], res["fb"]["counts"], res["train"]["counts_2x2"],
                        res["train"]["counts_tile"], res["coarse"]["counts"],
                        res["refine"]["counts"]],
                errs=[res["fb"]["errs"], res["train"]["errs"]])
    every = [None] * axis.size
    dist.all_gather_object(every, mine, group=axis.group)
    res["ranks"] = every
    return res


def nccl_rank(dev, data: dict) -> dict:
    """[15c]: view 0 of the 1M model tile-sharded over an NCCL group (one
    rank per card), held to the fused render."""
    check, tag = rank_checks()
    axis = world_axis()
    model = model_from_numpy(scene_params(N_GAUSS, SCENE_SEED, SH_DEGREE),
                             np.ones(N_GAUSS, bool), SH_DEGREE, device=dev)
    # View 0 twice: the first render of a fresh process loads its kernels.
    res = sharded_views(check, dev, axis, model, ring_cameras(VIEWS, dev)[:1] * 2,
                        data["view_kw"][:1] * 2, tag, f"NCCL world {axis.size}")
    every = [None] * axis.size
    dist.all_gather_object(every, (check.failures, res["counts"]), group=axis.group)
    return dict(res, backend=axis.backend, failures=[f for fs, _ in every for f in fs],
                counts_by_rank=[c for _, c in every])


def phase_parallel(check, dev, card, view_caps, targets, coarse, mesh) -> dict:
    """[15]: the multi-device paths on the card. (a), (b), (d), (e), (f) run
    in one world-4 gloo run of ranks sharing the card (parallel_rank); (c)
    on NCCL; (g) the sharded level set and (h) the pipeline with devices=4
    through their single-controller entry points, every rank refusing the
    plain K1-K3 and reporting its launches. 4 ranks sharing one card
    measure correctness and host staging, not multi-card scaling."""
    t15 = time.perf_counter()
    view_kw = [caps_kw(c) for c in view_caps]
    host_coarse = to_device(coarse["model"], "cpu")
    data = dict(view_kw=view_kw, targets=[t.cpu() for t in targets[:2]], extent=coarse["extent"],
                coarse_model=host_coarse,
                mesh=(mesh["verts"], mesh["faces"], mesh["colors"].astype(np.float32) / 255.0))
    t0 = time.perf_counter()
    r = run_ranks(parallel_rank, PAR_WORLD, device="cuda", args=(data,))
    ranks_s = time.perf_counter() - t0
    for i, rk in enumerate(r["ranks"]):
        for f in rk["failures"]:
            check(False, f"rank {i}: {f}")
    per_rank = [tuple(sum(c) for c in zip(*rk["counts"])) for rk in r["ranks"]]
    k_counts = tuple(sum(c) for c in zip(*per_rank))
    errs = {}
    for rk in r["ranks"]:
        for e in rk["errs"]:
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
    serve, train = r["serve"], r["train"]
    by_op = {k: v for k, v in serve["bytes"].items() if v}
    print(f"[15] (a) tile-sharded serving on {card}, {PAR_LAYOUT}: ms per view on rank 0, "
          f"median of {VIEWS} (CUDA events, render + image gather) "
          f"{statistics.median(serve['ms']):.3f} ({', '.join(f'{v:.1f}' for v in serve['ms'])}); "
          f"collective bytes over the {VIEWS} views on rank 0 by op {json.dumps(by_op)}; peak "
          f"memory per rank {[round(rk['peak_gb'], 3) for rk in r['ranks']]} GB")
    check(all(c[0][0] > 0 and c[1] == (1, 1, 1, 0, 0, 0) and c[3] == (1, 1, 1, 0, 0, 0)
              for c in (rk["counts"] for rk in r["ranks"])),
          "no fallback: every rank launched K1 on (a), and K1, K2, K3 on (b) and (d)")
    print(f"[15] (d) training on {card}, {PAR_LAYOUT}: (2, 2) step median "
          f"{statistics.median(train['ms_2x2']):.3f} ms, tile-sharded step median "
          f"{statistics.median(train['ms_tile']):.3f} ms, of {PAR_TIMED_STEPS} (CUDA events on "
          f"rank 0)")
    print(f"[15] (e) ring KNN {r['coarse']['knn_s']:.2f} s on {card}, {PAR_LAYOUT}; wall of the "
          f"ranks' run {ranks_s:.1f} s (serving {r['serve_s']:.1f}, training {r['train_s']:.1f}, "
          f"coarse {r['coarse_s']:.1f}, refine {r['refine_s']:.1f})")

    # (c) NCCL: world 1, and one rank per card where there are several.
    nc_counts = (0,) * 6
    for world in sorted({1, torch.cuda.device_count()}):
        nc = run_ranks(nccl_rank, world, device="cuda", args=(data,))
        for f in nc["failures"]:
            check(False, f"NCCL world {world}: {f}")
        check(nc["backend"] == "nccl", f"(c) world {world} ran on NCCL ({nc['backend']})")
        nc_counts = tuple(a + sum(b) for a, b in zip(nc_counts, zip(*nc["counts_by_rank"])))
        print(f"[15] (c) NCCL world {world} on {card}: view 0 {nc['ms'][1]:.3f} ms (CUDA "
              f"events, rank 0, its second render; the first {nc['ms'][0]:.1f} ms), bytes by op over "
              f"both {json.dumps({k: v for k, v in nc['bytes'].items() if v})}")
    if torch.cuda.device_count() == 1:
        print("[15] (c) one card: NCCL runs with world 1 only (NCCL refuses two ranks on one "
              "device)")

    # (g) the level set over 4 ranks against the single device.
    cams = ring_cameras(VIEWS, dev)[:LEVELSET_CAMS]
    t0 = time.perf_counter()
    with plain_refused_in_ranks():
        sh = collect_surface_points_sharded(PAR_WORLD, coarse["model"], cams,
                                            rng=np.random.default_rng(0), device="cuda")
    sh_s = time.perf_counter() - t0
    g_counts = [tuple(c) for c in sh["launches"]]
    check(len(g_counts) == PAR_WORLD and all(c[0] > 0 and c[3] == c[0] and c[4] == c[5] == 0 for c in g_counts),
          f"(g) every rank launched K1 and one binning a K1, the plain K1-K3 refused (per rank "
          f"{g_counts})")
    t0 = time.perf_counter()
    one = levelset.collect_surface_points(coarse["model"], cams, rng=np.random.default_rng(0))
    one_s = time.perf_counter() - t0
    same_n = len(sh["points"]) == len(one["points"])
    pe = float(np.abs(sh["points"] - one["points"]).max()) if same_n else float("inf")
    ne = float(np.abs(sh["normals"] - one["normals"]).max()) if same_n else float("inf")
    print(f"[15] (g) level set, {LEVELSET_CAMS} cameras of [10] over {PAR_WORLD} ranks on "
          f"{card}: {sh_s:.1f} s wall ({one_s:.1f} s on one rank); {len(sh['points'])} points; "
          f"max|points diff| {pe:.3e}, max|normals diff| {ne:.3e}; launches (K1, K2, K3, binning, preprocess, preprocess bwd) per "
          f"rank {g_counts}")
    check(same_n and pe <= 1e-5 and ne <= 1e-4
          and np.array_equal(sh["gaussian_idx"], one["gaussian_idx"]),
          "(g) the sharded level-set cloud equals the single-device cloud (points 1e-5, "
          "normals 1e-4, Gaussian ids equal)")

    # (h) the pipeline with devices=4 on [13]'s scene.
    t0 = time.perf_counter()
    scene, _ = make_parity_scene(n_gt=2_000, n_init=800, n_cams=16, resolution=96, k_max=512,
                                 device=dev)
    out_dir = os.path.join(WORK, "pipeline15")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = PipelineConfig(
        scene_path="<procedural>", output_dir=out_dir, poly="low_poly", refinement_time="short",
        eval_split=False, capacity=2**12, devices=PAR_WORLD, vanilla_iterations=64,
        vanilla_overrides=dict(sh_degree=0, sh_warmup_every=1, densify_from=10_000,
                               densify_until=10_000, opacity_reset_every=10_000,
                               dup_capacity_mult=32, k_max=256, log_every=32),
        coarse_overrides=dict(start_iteration=0, num_iterations=40, entropy_start=5,
                              entropy_end=20, start_sdf_estimation_from=20, regularize_from=10,
                              prune_at=(), sh_degree=0, reset_neighbors_every=12,
                              n_samples_for_sdf_regularization=20_000, k_max=256,
                              dup_capacity_mult=32, log_every=12),
        extract_overrides=dict(total_points=60_000, poisson_resolution=64,
                               decimation_target=2_000, dup_capacity=2**14, k_max=256,
                               prune_opacity_threshold=0.1),
        refine_overrides=dict(num_iterations=24, sh_degree=0, sh_warmup_every=1, k_max=256,
                              dup_capacity_mult=16, log_every=12),
    )
    logs, walls, h_counts = [], {}, {}
    art = {}
    for name, fn, arg in (("vanilla", run_vanilla, None), ("coarse", run_coarse, "vanilla"),
                          ("extract_mesh", run_extract_mesh, "coarse"),
                          ("refine", run_refine, "extract_mesh")):
        s0 = time.perf_counter()
        n_logs = len(logs)
        with plain_refused_in_ranks():
            art[name] = fn(cfg, scene, *(() if arg is None else (art[arg],)), log_fn=logs.append)
        walls[name] = time.perf_counter() - s0
        recs = [json.loads(x) for x in logs[n_logs:]]
        inner = [r["elapsed_s"] for r in recs if "elapsed_s" in r]
        if name != "extract_mesh":  # its ranks are (g)'s level set, counted there
            stage = [tuple(c) for r in recs if r.get("event") == "kernel_launches"
                     for c in r["per_rank"]]
            h_counts[name] = stage
            check(len(stage) == PAR_WORLD and all(min(c[:4]) > 0 and c[3] == c[0] and c[4] == c[5] and 0 < c[4] <= c[0]
                                                  for c in stage),
                  f"(h) {name}: every rank launched K1, K2, K3, one binning a K1 and the "
                  f"preprocess pair once a step, the plain versions refused (per rank {stage})")
        if inner:
            print(f"[15] (h) {name}: {walls[name]:.2f} s wall, of which the ranks' loop "
                  f"{inner[-1]:.2f} s by rank 0's last log")
    v, f, vc = load_mesh_ply(art["extract_mesh"])
    from sugar_tpu_torch.io.ply import load_gaussian_ply
    n_refined = load_gaussian_ply(art["refine"])["xyz"].shape[0]
    print(f"[15] (h) pipeline with devices={PAR_WORLD} (2 x 2) on [13]'s scene, {PAR_LAYOUT}: "
          f"stages {json.dumps({k: round(x, 2) for k, x in walls.items()})} s; mesh {len(v)} "
          f"vertices, {len(f)} faces; refined {n_refined} Gaussians; launches (K1, K2, K3, binning, preprocess, preprocess bwd) per "
          f"rank {json.dumps(h_counts)}")
    check(all(os.path.exists(a) for a in art.values()) and len(v) > 100 and len(f) > 100
          and vc is not None and n_refined == 6 * len(f)
          and any("mesh" in str(x) for x in logs),
          "(h) the sharded pipeline writes every artifact; the mesh has > 100 vertices and faces "
          "with vertex colors; 6 refined Gaussians per face; the sharded loops logged their mesh")
    shutil.rmtree(out_dir, ignore_errors=True)
    wall = time.perf_counter() - t15
    gh_counts = tuple(sum(c) for c in zip(*g_counts, *(c for cs in h_counts.values()
                                                         for c in cs)))
    print(f"[15] summary on {card}: {wall:.1f} s; launches (K1, K2, K3, binning, preprocess, preprocess bwd) over the world-4 "
          f"ranks "
          f"{k_counts} (per rank {per_rank}), NCCL {nc_counts}, level set and pipeline "
          f"{gh_counts}; kernels vs plain in the ranks {json.dumps(errs)}")
    return dict(launches=tuple(a + b + c for a, b, c in zip(k_counts, nc_counts, gh_counts)),
                errs=errs, wall_s=wall)


# --- [16] the measurement entry points ------------------------------------

BENCH_METRICS = ("train_step_rays_per_s_256k_gaussians", "rays_per_s_fwd_bwd_1M_gaussians",
                 "rays_per_s_fwd_bwd_1M_gaussians_trained_stats")
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "device", "ms_median", "ms_min", "ms_max",
              "bin_overflow", "tile_overflow")
STAGE_IMAGE_ATOL = 1e-6


def phase_tools(check, card) -> dict:
    """The port of the JAX package's measurement tools at their full widths:
    ``scripts.bench.main()`` (its three JSON lines parsed and checked, its
    launches counted, K1-K3 held to their plain versions on its last
    fwd+bwd's arguments), ``profile_raster`` and ``profile_trained`` on
    both scenes (launches, the stage-by-stage image against the one-call
    render), and the three microbenches (``microbench_sort`` with and
    without ``extra``). The plain K1-K3 raise throughout, outside the
    comparisons."""
    t0 = time.perf_counter()
    counts = {}
    buf = io.StringIO()
    with no_fallback(refuse_fused=False):
        reset_launches()
        with recorded_kernel_args(keep_last=1) as recs, contextlib.redirect_stdout(buf):
            bench_recs = bench.main()
        counts["bench"] = launches()
    print(buf.getvalue(), end="")
    lines = []
    for line in buf.getvalue().splitlines():
        try:
            lines.append(json.loads(line))
        except json.JSONDecodeError:
            check(False, f"[16] bench line parses as JSON: {line[:120]}")
    check(tuple(r.get("metric") for r in lines) == BENCH_METRICS,
          "[16] bench prints its three metrics, in bench.py's order")
    for r in lines:
        check(all(k in r for k in BENCH_KEYS) and r["unit"] == "rays/s" and r["device"] == card
              and math.isfinite(r["value"]) and r["value"] > 0,
              f"[16] {r.get('metric')}: every key, rays/s, the card's line, a finite rate")
        check(r.get("bin_overflow") == 0 and r.get("tile_overflow") == 0,
              f"[16] {r.get('metric')}: overflow 0")
    warm = bench_recs[0]["warmup_steps"]
    timed = warm + bench.ITERS
    # Each scene: one check forward (K1), one warm-up and ITERS timed fwd+bwd;
    # one binning a render.
    renders = timed + 2 * (bench.ITERS + 2)
    want = (renders, timed + 2 * (bench.ITERS + 1), timed + 2 * (bench.ITERS + 1), renders, timed,
            timed)
    print(f"[16] bench launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts['bench']} (train step {warm} warm-up + "
          f"{bench.ITERS} timed, caps {bench_recs[0]['caps']}; expected {want})")
    check(counts["bench"] == want, "[16] bench: one K1 and one binning per render, one K2 and K3 "
          "per backward, the preprocess pair once per train step")
    errs = check_recorded(check, recs, "[16]",
                          "bench fwd+bwd, 1M trained scene (its last iteration)")
    check(set(errs) == {"K1", "K2", "K3"}, "[16] bench's last K1, K2 and K3 launches recorded")
    del recs

    results = {}
    for name, fn in (("profile_raster", profile_raster.main),
                     ("profile_trained trained", lambda: profile_trained.main([])),
                     ("profile_trained random",
                      lambda: profile_trained.main(["--scene", "random"]))):
        with no_fallback(refuse_fused=False):
            reset_launches()
            res = fn()
            counts[name] = launches()
        d = float((res["image_stages"] - res["image_one_call"]).abs().max())
        print(f"[16] {name}: launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts[name]}; counts "
              f"{json.dumps(res['counts'])}; stage-by-stage image vs one-call render {d}")
        check(all(c > 0 for c in counts[name][:4]) and counts[name][4] == counts[name][5] == 0,
              f"[16] {name} launched K1, K2, K3 and the binning, and no preprocess kernel")
        check(d <= STAGE_IMAGE_ATOL, f"[16] {name}: the stage-by-stage image equals the one-call "
                                     f"render within {STAGE_IMAGE_ATOL}")
        results[name] = res["ms"]
        del res

    prims = []
    for name, fn in (("microbench_gather", microbench_gather.main),
                     ("microbench_prims", microbench_prims.main),
                     ("microbench_sort", lambda: microbench_sort.main([])),
                     ("microbench_sort extra", lambda: microbench_sort.main(["extra"]))):
        with no_fallback(refuse_fused=False):
            reset_launches()
            recs_ = fn()
            counts[name] = launches()
        check(counts[name] == (0,) * 6, f"[16] {name} runs no compositing, binning or preprocess "
                                          f"kernel")
        check(all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in recs_),
              f"[16] {name}: every time finite and positive")
        prims += [dict(r, tool=name) for r in recs_]
    print(f"[16] primitive costs on {card} (CUDA events):")
    for r in prims:
        print(f"    {r['tool']:22s} {r['label']:44s} {r['ms']:10.4f} ms "
              f"{r['ns_per']:9.4f} ns/{r['unit']}")
    wall = time.perf_counter() - t0
    total = tuple(sum(c) for c in zip(*counts.values()))
    print(f"[16] summary on {card}: {wall:.1f} s; bench "
          + ", ".join(f"{r['metric']} {r['value']:.0f} rays/s (median {r['ms_median']:.3f} ms, "
                      f"{r['ms_min']:.3f}-{r['ms_max']:.3f})" for r in lines)
          + f"; launches (K1, K2, K3, binning, preprocess, preprocess bwd) all {total}; kernels vs plain {json.dumps(errs)}")
    return dict(launches=total, errs=errs, wall_s=wall)


# [17] colour widths above the kernels' instantiations.
WIDE_CH = (8, 13)
WIDE_SEED = 17
WIDE_SAME_ATOL = 1e-6  # the C = 8 render's first channels against the C = 3 render's
BENCH_USES = {"tile-sharded": {"all_gather", "all_to_all", "reduce_scatter", "all_reduce"},
              "coarse-sdf": {"all_gather", "all_reduce"}}


def wide_fwd_bwd(model, settings, colours, kw: dict, g_img):
    """rasterize_gaussians(mode="pallas") of ``model`` with explicit
    ``colours`` (N, C) and the image cotangent ``g_img`` (H, W, C): the
    render and the gradients of means, opacities and colours."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (model.params.xyz, model.opacities, colours)]
    out = rasterize_gaussians(leaves[0], leaves[1], settings, scales=model.scales,
                              quaternions=model.quaternions, colors=leaves[2],
                              alive_mask=model.alive, mode="pallas", **kw)
    return out, torch.autograd.grad(out["image"], leaves, g_img)


def check_groups_agree(check, fw: tuple, label: str) -> None:
    """K1's channel groups on one recorded wide call, each launched alone:
    final_T, n_contrib, nch and entry_p (on the processed rows) are the
    same bits in every group."""
    start, count, dup, tiles_x, ch, mc = fw
    outs = [tc_mod._launch_fwd(start, count, tc_mod.group_rows(dup, c0, c1), tiles_x, c1 - c0, mc)
            for c0, c1 in tc_mod.channel_groups(ch)]
    a = outs[0]
    rows = torch.arange(a.entry_p.shape[1], device=a.nch.device)
    done = (rows[None, :] < a.nch[:, None])[:, :, None]
    same = all(torch.equal(o.final_t, a.final_t) and torch.equal(o.n_contrib, a.n_contrib)
               and torch.equal(o.nch, a.nch)
               and torch.equal(torch.where(done, o.entry_p, 0.0), torch.where(done, a.entry_p, 0.0))
               for o in outs[1:])
    check(same, f"[17] K1 {label}: the {len(outs)} channel groups' final_T, n_contrib, nch and "
                f"entry_p are bit-equal")


def phase_channels(check, dev, model, cam, caps, card) -> dict:
    """[17] (a) view 0 of the 1M model at C = 3, 8 and 13 colour channels,
    forward and backward through K1-K3 in channel groups and row blocks;
    (b) scaling_report's bench-scale section at 2 ranks on the card."""
    t0 = time.perf_counter()
    settings = rc.from_camera(cam, device=dev)
    kw = caps_kw(caps)
    n = model.capacity
    with torch.no_grad():
        dirs = model.params.xyz - settings.campos
        dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
        sh_cols = sh_to_rgb(model.sh_degree, model.sh, dirs)
    g = np.random.default_rng(WIDE_SEED)
    extra = torch.as_tensor(g.uniform(0, 1, (n, max(WIDE_CH) - 3)).astype(np.float32), device=dev)
    bg = torch.cat([settings.bg, torch.as_tensor(
        g.uniform(0, 1, max(WIDE_CH) - 3).astype(np.float32), device=dev)])
    renders, counts, errs = {}, {}, {}
    for ch in (3,) + WIDE_CH:
        colours = torch.cat([sh_cols, extra[:, :ch - 3]], dim=1)
        st = dataclasses.replace(settings, bg=bg[:ch])
        g_img = torch.as_tensor(g.normal(size=(H, W, ch)).astype(np.float32), device=dev)
        with no_fallback(refuse_fused=False):
            reset_launches()
            with recorded_kernel_args() as recs:
                out, grads = wide_fwd_bwd(model, st, colours, kw, g_img)
            torch.cuda.synchronize()
            counts[ch] = launches()
        groups = len(tc_mod.channel_groups(ch))
        blocks = -(-(6 + ch) // segsum_mod.MAX_ROWS)
        ovf = adaptive.read_overflow(out)
        print(f"[17] C = {ch}: launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts[ch]} ({groups} channel groups, "
              f"{blocks} row blocks of {6 + ch} rows); overflow {json.dumps(ovf)}")
        check(counts[ch] == (groups, groups, blocks, 1, 0, 0),
              f"[17] C = {ch}: one K1 and one K2 launch per channel group, one K3 per row block, "
              f"one binning")
        check(all(ovf[k] == 0 for k in ("bin_overflow", "big_overflow", "cap_overflow",
                                        "tile_overflow")), f"[17] C = {ch}: overflow 0")
        check(tuple(out["image"].shape) == (H, W, ch) and bool(torch.isfinite(out["image"]).all())
              and all(bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0 for x in grads),
              f"[17] C = {ch}: image finite, {H}x{W}x{ch}; gradients finite and nonzero")
        renders[ch] = {k: out[k].detach() for k in ("image", "final_T", "n_contrib")}
        del out, grads
        e = check_recorded(check, recs, "[17]", f"C = {ch}, view 0 of the 1M scene")
        check(set(e) == {"K1", "K2", "K3"}, f"[17] C = {ch}: K1, K2 and K3 recorded and checked")
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        fw, bw, k3 = recs["K1"][-1], recs["K2"][-1], recs["K3"][-1]
        if groups > 1:
            check_groups_agree(check, fw, f"C = {ch}")
        nch = bw[2]
        live = int((k3[1] < k3[2]).sum())
        times = dict(
            K1=(cuda_ms(lambda: tile_composite_cuda(*fw), reps=10, warmup=1),
                composite_bound(fw[0], fw[1], nch, ch, fw[5]),
                cuda_ms(lambda: tile_composite_plain(*fw), reps=2)),
            K2=(cuda_ms(lambda: tile_composite_bwd_cuda(*bw), reps=10, warmup=1),
                composite_bwd_bound(fw[0], fw[1], nch, ch, fw[5], fw[2].shape[1]),
                cuda_ms(lambda: tile_composite_bwd_plain(*bw), reps=2)),
            K3=(cuda_ms(lambda: segment_sum_cuda(*k3), reps=20, warmup=1),
                segsum_bound(6 + ch, live, k3[2]),
                cuda_ms(lambda: segment_sum_plain(*k3), reps=5)))
        # index_add_ on the same cotangent and ids ([8]'s library call), the
        # faster of dim 1 of (rows, n+1) and dim 0 of (n+1, rows).
        ct, ids = k3[0], torch.clamp(k3[1], max=k3[2]).to(torch.int64)
        ct_t = ct.T.contiguous()
        lib_ms = min(
            cuda_ms(lambda: torch.zeros((6 + ch, k3[2] + 1), device=dev).index_add_(1, ids, ct),
                    reps=5),
            cuda_ms(lambda: torch.zeros((k3[2] + 1, 6 + ch), device=dev).index_add_(0, ids, ct_t),
                    reps=5))
        del ct, ids, ct_t
        print(f"[17] C = {ch} on {card}, view 0 (CUDA events, whole wrapper call): "
              + "; ".join(f"{k} {ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
                          f"plain version {pms:.3f} ms" for k, (ms, b, pms) in times.items())
              + f"; index_add_ of the {6 + ch} rows {lib_ms:.4f} ms")
        del recs, fw, bw, k3
    a, b = renders[3], renders[8]
    d = max(float((b["image"][..., :3] - a["image"]).abs().max()),
            float((b["final_T"] - a["final_T"]).abs().max()))
    same_n = torch.equal(b["n_contrib"], a["n_contrib"])
    bit = torch.equal(b["image"][..., :3], a["image"]) and torch.equal(b["final_T"], a["final_T"])
    print(f"[17] C = 8 render against C = 3: first three channels and final_T max abs diff {d} "
          f"(bit-equal {bit}), n_contrib equal {same_n}")
    check(d <= WIDE_SAME_ATOL and same_n,
          f"[17] the C = 8 render's first three channels, final_T and n_contrib equal the C = 3 "
          f"render's within {WIDE_SAME_ATOL}")
    wall_a = time.perf_counter() - t0

    # (b) the bench-scale section at 2 ranks sharing the card.
    t1 = time.perf_counter()
    with plain_refused_in_ranks():
        rows = scaling_report.bench_scale([2], scaling_report.BENCH_CAPACITY,
                                          scaling_report.BENCH_WIDTH, scaling_report.BENCH_RES,
                                          scaling_report.BENCH_SAMPLES)
    for line in scaling_report.bench_scale_lines(rows, scaling_report.BENCH_CAPACITY, card):
        print(f"[17] {line}")
    for r in rows:
        used = {op for op in comm.OPS if r["counts"][op] > 0}
        check(used == BENCH_USES[r["step"]] and r["counts"]["host_staged"] > 0,
              f"[17] bench scale {r['step']}, {r['world']} ranks: bytes for the ops it uses "
              f"({sorted(used)}), host-staged bytes under gloo")
        check(all(p is not None and 0 < p < 80 for p in r["peak_gb_by_rank"]),
              f"[17] bench scale {r['step']}: peak GB per rank {r['peak_gb_by_rank']}")
        # Each rank's launches are its totals over both steps: the preprocess
        # pair runs in the coarse step's image render only.
        check(all(all(c > 0 for c in rank[:4]) and rank[4] == rank[5] > 0
                  for rank in r["launches"]),
              f"[17] bench scale: every rank launched K1, K2, K3, the binning and the "
              f"preprocess pair {r['launches']}")
    wall_b = time.perf_counter() - t1
    total = tuple(sum(c) for c in zip(*counts.values()))
    print(f"[17] summary on {card}: (a) {wall_a:.1f} s, (b) {wall_b:.1f} s; launches (K1, K2, K3, "
          f"binning) "
          + ", ".join(f"C = {ch} {c}" for ch, c in counts.items())
          + f"; kernels vs plain {json.dumps(errs)}; bench scale peak GB per rank "
          + ", ".join(f"{r['step']} {r['peak_gb']:.3f}" for r in rows))
    return dict(launches=total, errs=errs)


# --- [18] the pipeline at width from a COLMAP scene on disk ---------------

PIPE_VIEWS = 9  # every 8th held out: views 0 and 8, so 7 train cameras
# Only iteration counts and cadence on top of the CLI's presets, through
# the config's override fields: a vanilla run with [7]'s densify cadence
# but 200 iterations and no opacity reset, a coarse window from
# PIPE_COARSE_START across the prune at 9000 into [9]'s SDF phase, and
# [11]'s refine iterations. The vanilla model starts at opacity 0.1
# (create_from_pcd), and the coarse prune keeps opacity >= 0.5: after [7]'s
# 30 iterations, which end in the reset to <= 0.01, no Gaussian is left,
# and the coarse stage's PLY export of the empty model raises (in both
# packages). After 200 iterations the opacities sit under 0.5 in layers;
# the entropy phase (7000-9000) drives them to 0 or 1, and the prune keeps
# what reaches 1. tools/torch_prune_window.py measured what the prune
# keeps against the start on the H100: 8990 269, 8900 1,220, 8750 6,748,
# 8500 8,123, 8000 8,294, 7000 (the whole phase) 8,291 of 262,145. From
# 8500 the prune keeps 98% of what the whole phase keeps, in a quarter of
# its steps.
PIPE_VANILLA_ITERS = 200
PIPE_COARSE_START = 8_500
# Half of what the prune kept from 8500 in that measurement: a prune that
# keeps fewer runs the later stages short of the surface.
PIPE_MIN_KEPT = 4_000
PIPE_WIDTH_ITERS = dict(
    vanilla_iterations=PIPE_VANILLA_ITERS,
    vanilla_overrides=dict(densify_from=20, densify_every=25, log_every=1),
    coarse_overrides=dict(start_iteration=PIPE_COARSE_START, num_iterations=COARSE_END,
                          log_every=10),
    refine_overrides=dict(num_iterations=REFINE_ITERS, log_every=1),
)
ENTRY_REFINE_ITERS = 10
# The Gaussian PLYs, the mesh PLY, the refined state and the OBJ: what one
# stage writes and the next reads (pipeline.py and the modules it calls).
HANDOFFS = ((gm_mod, "save_ply"), (gm_mod, "load_ply"), (ply_io, "save_mesh_ply"),
            (ply_io, "load_mesh_ply"), (pipeline_mod, "export_refined_ply"),
            (pipeline_mod, "save_refined_state"), (pipeline_mod, "load_refined_state"),
            (extract_textured_mod, "save_obj"))


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """The unit quaternion (w, x, y, z), w >= 0, of a rotation matrix: the
    inverse of io/colmap.qvec2rotmat (the largest component from the
    diagonal, the others from the off-diagonal sums)."""
    t = R[0, 0] + R[1, 1] + R[2, 2]
    k = int(np.argmax([t, R[0, 0], R[1, 1], R[2, 2]]))
    if k == 0:
        s = 2.0 * math.sqrt(1.0 + t)
        q = [s / 4, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    elif k == 1:
        s = 2.0 * math.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2])
        q = [(R[2, 1] - R[1, 2]) / s, s / 4, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
    elif k == 2:
        s = 2.0 * math.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2])
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, s / 4, (R[1, 2] + R[2, 1]) / s]
    else:
        s = 2.0 * math.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1])
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, s / 4]
    q = np.array(q)
    return q if q[0] >= 0 else -q


def write_colmap_scene(root: str, fields: dict[str, np.ndarray], views: int, size: int,
                       caps: adaptive.RasterCaps, device) -> tuple:
    """A COLMAP text scene on disk, written by io/colmap's writers:
    sparse/0/cameras.txt (one PINHOLE camera, fx = fy = size / 2 / tan(FOV
    / 2)), images.txt (one image per view of the ring), points3D.txt (the
    scene's means, their SH-DC colour as RGB), and images/view_NNN.png,
    each the clamped render of the scene (``fields`` at SH degree 0) at that
    view through render_adaptive from ``caps``. Returns the PNGs' pixels and
    the written cameras, images and (points, colours)."""
    n = fields["xyz"].shape[0]
    model = model_from_numpy(fields, np.ones(n, bool), 0, device=device)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    f = size / 2 / math.tan(FOV / 2)
    cameras = {1: colmap_io.ColmapCamera(1, "PINHOLE", size, size,
                                         np.array([f, f, size / 2, size / 2]))}
    colmap_io.write_cameras_text(os.path.join(sparse, "cameras.txt"), cameras)
    images, pixels = {}, []
    for i, (R, T) in enumerate(ring_poses(views)):
        name = f"view_{i:03d}.png"
        cam = make_camera(R, T, FOV, FOV, size, size, device=device)
        with torch.no_grad():
            out, _ = adaptive.render_adaptive(render_model, caps, model, cam)
        px = (torch.clamp(out["image"], 0.0, 1.0).cpu().numpy() * 255).astype(np.uint8)
        write_png(os.path.join(root, "images", name), px)
        pixels.append(px)
        images[i + 1] = colmap_io.ColmapImage(i + 1, rotmat_to_qvec(R.T), T, 1, name)
    colmap_io.write_images_text(os.path.join(sparse, "images.txt"), images)
    rgb = np.round(np.clip(fields["sh_dc"] * C0 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)
    colmap_io.write_points3d_text(os.path.join(sparse, "points3D.txt"), fields["xyz"], rgb)
    return pixels, cameras, images, (fields["xyz"], rgb)


def cli_config(argv: list[str]) -> PipelineConfig:
    """The PipelineConfig that ``train_full_pipeline.main(argv)`` builds (the
    CLI's presets), taken where it would start the pipeline."""
    seen = {}

    def capture(cfg, device):
        seen["cfg"] = cfg
        return {}

    with swapped(train_full_pipeline, "run_full_pipeline", capture), \
            contextlib.redirect_stdout(io.StringIO()):
        train_full_pipeline.main(argv)
    return seen["cfg"]


def phase_pipeline_width(check, dev, card) -> dict:
    """[18] the pipeline as train_full_pipeline builds it (high_poly, sdf,
    long, eval split) from a COLMAP text scene on disk at the main path's
    width: [7]'s 2^18 scene seen by 9 ring views at 512x512. Each stage
    timed, its launches, peak GB and file hand-offs; K1-K3 held to their
    plain versions on each stage's last launches; every artifact loaded
    back; the stage entry points on the artifacts; a resumed run that
    skips every stage. The plain K1-K3 raise throughout."""
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "colmap")
    scene_dir, out_dir = os.path.join(root, "scene"), os.path.join(root, "out")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    pixels, *_ = write_colmap_scene(scene_dir, train_scene_fields(TRAIN_N, TRAIN_SEED),
                                    PIPE_VIEWS, H, TRAIN_CAPS, dev)
    write_s = time.perf_counter() - t0
    scene_mb = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(scene_dir) for f in fs) / 1e6
    cfg = dataclasses.replace(cli_config(["-s", scene_dir, "-o", out_dir]), **PIPE_WIDTH_ITERS)
    print(f"[18] COLMAP text scene written: {TRAIN_N} points, {PIPE_VIEWS} views at {H}x{W} "
          f"(PINHOLE, FOV {FOV}), {scene_mb:.1f} MB, {write_s:.2f} s; the CLI's config: poly "
          f"{cfg.poly} ({cfg.n_vertices_in_mesh} vertices, {cfg.gaussians_per_triangle} per "
          f"triangle), regularization {cfg.regularization}, refinement {cfg.refinement_time}, "
          f"eval split {cfg.eval_split}, capacity {cfg.capacity}; iterations {PIPE_WIDTH_ITERS}")

    # Each stage: wall, launches, peak GB, the last launches' arguments; the
    # scene load and the hand-offs by the host clock; the level set's and
    # the bake's counters.
    ct = CallTimes()
    stages: dict[str, dict] = {}
    logs: list[tuple] = []
    seen: dict = {"levelset": [], "bake": [], "raster": []}

    def staged(name, run):
        def stage(*args, **kwargs):
            ct.tag = name
            r, stages[name] = timed_stage(check, "[18]", name, lambda: run(*args, **kwargs))
            ct.tag = None
            return r
        return stage

    def load_scene_kept(*args, **kwargs):
        t0 = time.perf_counter()
        seen["scene"] = load_scene_orig(*args, **kwargs)
        seen["load_s"] = time.perf_counter() - t0
        return seen["scene"]

    def collect_kept(*args, **kwargs):
        out = collect_orig(*args, **kwargs)
        seen["levelset"].extend(out["overflow"])
        return out

    def render_bound_kept(*args, **kwargs):
        out = render_bound_orig(*args, **kwargs)
        seen["bake"].append(adaptive.read_overflow(out))
        return out

    def rasterize_mesh_kept(*args, **kwargs):
        out = rasterize_orig(*args, **kwargs)
        seen["raster"].append((int(out["overflow"]), int(out["tile_count_max"])))
        return out

    for mod, name in HANDOFFS:
        ct.wrap(mod, name, name, device=False)
    t0 = time.perf_counter()
    try:
        with contextlib.ExitStack() as stack:
            load_scene_orig = stack.enter_context(swapped(pipeline_mod, "load_scene",
                                                          load_scene_kept))
            collect_orig = stack.enter_context(swapped(levelset, "collect_surface_points",
                                                       collect_kept))
            render_bound_orig = stack.enter_context(swapped(extract_textured_mod, "render_bound",
                                                            render_bound_kept))
            rasterize_orig = stack.enter_context(swapped(texture_mod, "rasterize_mesh",
                                                         rasterize_mesh_kept))
            for s in PIPE_STAGES:
                stack.enter_context(swapped(pipeline_mod, f"run_{s}",
                                            staged(s, getattr(pipeline_mod, f"run_{s}"))))
            stack.enter_context(no_fallback(refuse_fused=False))
            art = pipeline_mod.run_full_pipeline(
                cfg, log_fn=lambda r: logs.append((ct.tag, json.loads(r))), device=dev)
    finally:
        ct.restore()
    pipe_s = time.perf_counter() - t0
    tot = ct.totals()
    scene, load_s = seen["scene"], seen["load_s"]

    train_idx, test_idx = scene.split(cfg.eval_split)
    same_px = all(np.array_equal(np.round(img * 255).astype(np.uint8), px)
                  for img, px in zip(scene.images, pixels))
    print(f"[18] scene loaded by the pipeline (load_colmap_scene, Pillow): {len(scene.cameras)} "
          f"cameras at {scene.cameras[0].height}x{scene.cameras[0].width}, {len(scene.points)} "
          f"points, extent {scene.extent:.4f}, train {train_idx}, held out {test_idx}; "
          f"{load_s:.2f} s; images equal the written PNGs {same_px}")
    check(len(scene.cameras) == PIPE_VIEWS and scene.images[0].shape == (H, W, 3) and same_px
          and len(scene.points) == TRAIN_N and test_idx == [0, PIPE_VIEWS - 1]
          and len(train_idx) == PIPE_VIEWS - 2,
          f"[18] the COLMAP scene loads whole: {PIPE_VIEWS} views at {H}x{W}, {TRAIN_N} points, "
          f"views 0 and 8 held out")
    want = {"vanilla": (PIPE_VANILLA_ITERS,) * 6,
            "coarse": (COARSE_END - PIPE_COARSE_START + COARSE_END - COARSE_MILESTONE,) * 4
            + (COARSE_END - PIPE_COARSE_START,) * 2,
            "extract_mesh": (len(train_idx), 0, 0, len(train_idx), 0, 0),
            "refine": (REFINE_ITERS,) * 6,
            "texture": (len(train_idx), 0, 0, len(train_idx), len(train_idx), 0)}
    errs: dict[str, float] = {}
    for name in PIPE_STAGES:
        st = stages[name]
        hand = {label: sum(v) for (label, tag), v in tot.items() if tag == name}
        st["handoff_s"] = sum(hand.values()) / 1e3
        steps = [r for tag, r in logs if tag == name and "loss" in r]
        events = collections.Counter(r.get("event") for tag, r in logs
                                     if tag == name and r.get("event"))
        print(f"[18] {name}: {st['wall_s']:.2f} s wall, launches (K1, K2, K3, binning, preprocess, preprocess bwd) "
              f"{st['launches']}, "
              f"peak {st['peak_gb']:.3f} GB (allocated at its start {st['start_gb']:.3f}), "
              f"hand-off {st['handoff_s']:.3f} s ("
              + ", ".join(f"{k} {v / 1e3:.3f} s" for k, v in hand.items()) + ")"
              + (f"; loss {steps[0]['loss']:.5f} -> {steps[-1]['loss']:.5f} over {len(steps)} "
                 f"logged iterations" if steps else "")
              + (f", n_alive {steps[0]['n_alive']} -> {steps[-1]['n_alive']}"
                 if steps and "n_alive" in steps[0] else "")
              + (f"; events {dict(events)}" if events else ""))
        for r in (r for tag, r in logs if tag == name and r.get("event") == "cap_grow"):
            print(f"    {json.dumps(r)}")
        check(st["launches"] == want[name], f"[18] {name}: launches (K1, K2, K3, binning, preprocess, preprocess bwd) "
              f"{want[name]}")
        check(all(math.isfinite(r["loss"]) for r in steps), f"[18] {name}: every loss finite")
        for k, v in st["errs"].items():
            errs[k] = max(errs.get(k, 0.0), v)

    # The level set's and the bake's counters at their fixed caps (faults
    # of the reference, kept; ROADMAP queue 3).
    ecfg = ExtractConfig()
    for i, o in enumerate(seen["levelset"]):
        print(f"[18] level set, train camera {i}: depth-render counters {json.dumps(o)} (fixed caps "
              f"dup_capacity {ecfg.dup_capacity}, k_max {ecfg.k_max})")
    for i, (o, (rov, deep)) in enumerate(zip(seen["bake"], seen["raster"])):
        print(f"[18] bake, train camera {i}: render_bound counters {json.dumps(o)}; "
              f"rasterize_mesh overflow {rov}, deepest tile {deep} faces against k_max "
              f"{BAKE_RASTER_K_MAX}")
    check(len(seen["levelset"]) == len(train_idx) and len(seen["bake"]) == len(train_idx),
          "[18] the level set and the bake each render every train camera once")

    # Every artifact loaded back.
    names = {k: os.path.relpath(v, out_dir) for k, v in art.items()}
    back = load_artifacts(art, dev)
    v_model, c_model, r_model = back["vanilla"], back["coarse"], back["refined"]
    mv, mf, mc = back["mesh"]
    sp, sbm = back["state"]
    lv, lf, _, _ = back["obj"]
    png = back["png"]
    state = art["refined"].replace(".ply", "_state.pkl")
    sh = int(round(math.sqrt(sp.sh_rest.shape[-1] + 1))) - 1
    bg = torch.zeros(3, device=dev)
    with no_fallback(refuse_fused=False):
        out0, _ = adaptive.render_adaptive(
            functools.partial(render_bound, active_sh_degree=sh, bg=bg),
            adaptive.RasterCaps(tile_cap=16, dup_capacity=BAKE_DUP_CAPACITY, k_max=BAKE_K_MAX),
            sp, sbm, scene.cameras[0])
    img0 = out0["image"]
    db0 = float(psnr(torch.clamp(img0, 0, 1), torch.as_tensor(scene.images[0], device=dev)))
    print(f"[18] artifacts {json.dumps(names)}: vanilla {int(v_model.alive.sum())} Gaussians "
          f"(capacity {v_model.capacity}), coarse {int(c_model.alive.sum())}, mesh {len(mv)} "
          f"vertices / {len(mf)} faces, refined {int(r_model.alive.sum())} Gaussians, state "
          f"{int(sp.opacity_logit.shape[0])} ({sbm.n_per_triangle} per triangle, SH {sh}), "
          f"textured OBJ {len(lv)} vertices / {len(lf)} faces, texture {png.shape}; held-out view "
          f"0 from the refined state: PSNR {db0:.3f} dB, counters "
          f"{json.dumps(adaptive.read_overflow(out0))}")
    # What the coarse prune (opacity >= 0.5 at 9000) finds in the vanilla
    # model.
    op = torch.sigmoid(v_model.params.opacity_logit[v_model.alive])
    q = torch.quantile(op, torch.tensor([0.5, 0.9, 0.99], device=dev)).tolist()
    print(f"[18] vanilla PLY opacities: median {q[0]:.4f}, p90 {q[1]:.4f}, p99 {q[2]:.4f}, max "
          f"{float(op.max()):.4f}; {int((op >= 0.5).sum())} of {op.numel()} at >= 0.5")
    check(names["mesh"] == os.path.join("coarse_mesh", "mesh_level0.3_decim1000000.ply")
          and names["refined"] == os.path.join("refined", "refined_1gpt_15000.ply"),
          "[18] the artifacts carry the high_poly / long presets' names")
    check(0 < len(mv) <= cfg.n_vertices_in_mesh and len(mf) > 0 and mc is not None,
          f"[18] the mesh loads back with colours, at most {cfg.n_vertices_in_mesh} vertices")
    check(int(v_model.alive.sum()) > 0 and 0 < int(c_model.alive.sum()) <= int(v_model.alive.sum())
          and int(r_model.alive.sum()) == len(mf) == int(sp.opacity_logit.shape[0])
          and sbm.n_per_triangle == 1 and len(lf) == len(mf) and png.ndim == 3,
          "[18] every artifact loads back (1 Gaussian per mesh triangle)")
    check(tuple(img0.shape) == (H, W, 3) and bool(torch.isfinite(img0).all()),
          "[18] the refined state renders held-out view 0, finite")
    check(int(c_model.alive.sum()) >= PIPE_MIN_KEPT,
          f"[18] the coarse prune keeps at least {PIPE_MIN_KEPT} Gaussians")
    del back, v_model, c_model, r_model, out0, img0

    # The stage entry points on the pipeline's artifacts.
    ep_walls, ep_counts = {}, {}
    guard = functools.partial(no_fallback, refuse_fused=False)

    def entry(name, fn, want):
        r, ep_walls[name], ep_counts[name], e = timed_entry(check, "[18]", name, fn, want, guard)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        return r

    out2 = os.path.join(root, "entry")
    refined2 = entry("train_refined", lambda: train_refined.main(
        ["-s", scene_dir, "-m", art["mesh"], "-o", out2, "-f", str(ENTRY_REFINE_ITERS)], device=dev),
        (ENTRY_REFINE_ITERS,) * 6)
    r2 = load_ply(refined2, device=dev)
    obj2 = os.path.join(out2, "textured.obj")  # the script makes no directory, as JAX's
    entry("extract_refined_mesh_with_texture", lambda: extract_refined_mesh_with_texture.main(
        ["-s", scene_dir, "-m", state, "-o", obj2], device=dev),
        (len(train_idx), 0, 0, len(train_idx), len(train_idx), 0))
    same_tex = np.array_equal(read_png(os.path.splitext(obj2)[0] + ".png"), png)
    res = entry("metrics", lambda: metrics_script.main(
        ["--scene_path", scene_dir, "--checkpoint", art["vanilla"], "--refined_state", state,
         "--textured_obj", art["textured"], "--output", os.path.join(out2, "metrics.json")],
        device=dev), None)
    scores = {k: (v["psnr"], v["ssim"]) for k, v in res.items()}
    print(f"[18] entry points on {card}: " + ", ".join(
        f"{k} {ep_walls[k]:.2f} s {ep_counts[k]}" for k in ep_walls)
        + f"; train_refined {int(r2.alive.sum())} Gaussians; the script's texture equals the "
          f"pipeline's {same_tex}; metrics (PSNR dB, SSIM) on the held-out views "
        + json.dumps({k: [round(p, 4), round(s_, 5)] for k, (p, s_) in scores.items()}))
    check(int(r2.alive.sum()) == len(mf) and all(
        bool(torch.isfinite(getattr(r2.params, f)).all()) for f in PARAM_FIELDS),
        "[18] train_refined: the refined PLY loads back, finite, 1 Gaussian per triangle")
    check(same_tex, "[18] extract_refined_mesh_with_texture bakes the pipeline's texture")
    check(set(scores) == {"gaussians", "refined", "textured"}
          and all(math.isfinite(p) and math.isfinite(s_) for p, s_ in scores.values()),
          "[18] metrics: PSNR and SSIM finite for the three objects")
    del r2

    # The same config again on the same output: every stage skipped.
    again = {}

    def rerun(log_fn):
        with no_fallback(refuse_fused=False):
            again["art"] = pipeline_mod.run_full_pipeline(cfg, log_fn=log_fn, device=dev)

    skipped, rcounts, resume_s = resumed_run(rerun)
    print(f"[18] resumed run: {resume_s:.2f} s, stage_skip events {skipped}, launches (K1, K2, K3, "
          f"binning) {rcounts}")
    check(skipped == list(PIPE_STAGES) and rcounts == (0,) * 6 and again["art"] == art,
          "[18] a resumed run skips all five stages and launches no kernel")
    # The textured OBJ (with its MTL and PNG) stays for [19]'s run_viewer.
    kept = os.path.join(WORK, "textured_18")
    shutil.rmtree(kept, ignore_errors=True)
    shutil.copytree(os.path.dirname(art["textured"]), kept)
    shutil.rmtree(root, ignore_errors=True)

    total = tuple(sum(c) for c in zip(*(st["launches"] for st in stages.values()),
                                      *ep_counts.values()))
    wall = time.perf_counter() - t_phase
    print(f"[18] summary on {card}: {wall:.1f} s (scene written {write_s:.2f} s, loaded "
          f"{load_s:.2f} s, pipeline {pipe_s:.2f} s with its kernel checks); stages "
          + ", ".join(f"{k} {v['wall_s']:.2f} s / {v['peak_gb']:.2f} GB / hand-off "
                      f"{v['handoff_s']:.2f} s" for k, v in stages.items())
          + f"; launches (K1, K2, K3, binning, preprocess, preprocess bwd) all {total}; kernels vs plain {json.dumps(errs)}")
    return dict(launches=total, errs=errs, wall_s=wall,
                textured=os.path.join(kept, os.path.basename(art["textured"])))


# --- [19] the parity protocol at the full configuration's widths ---------

# run_parity's full configuration with only its iteration counts cut: 4
# densify events (600-800 of 500-850, every 100), the prune at 1,120, 280
# SDF steps and both SH warm-ups (vanilla at 333 and 666, refine at 250).
PARITY_WIDTH_ITERS = (1_000, 400, 500)
# The mesh: at most the decimation target and more than this (the level
# set then covers the blob; PARITY_r05.json's mesh has 49,982 vertices).
PARITY_MESH_MIN = 10_000
PARITY_STAGES = ("vanilla", "coarse", "extract_mesh", "refine")
# The JAX record's keys, with "backend" (JAX's backend) as the port's
# "device" (the card line).
PARITY_KEYS = {"protocol", "device", "scene", "iterations", "stages", "wall_s"}
# PARITY_r05.json: the JAX package's record of the full configuration on a
# TPU v5e, held-out PSNR (dB). A stage more than PARITY_RECORD_DB under it
# is a finding.
PARITY_R05_PSNR = {"vanilla": 14.604950618743896, "coarse_sdf": 14.457541847229004,
                   "refined": 13.829781913757325}
PARITY_RECORD_DB = 1.0


def parity_cut(iters: tuple[int, int, int]) -> tuple:
    """run_parity's full configuration with only its iteration counts
    replaced."""
    scfg, _, capacity, extract_over = run_parity.CONFIGS["full"]
    return scfg, tuple(iters), capacity, extract_over


@contextlib.contextmanager
def swapped_item(d: dict, key, value):
    """``d[key]`` is ``value`` inside the block."""
    orig = d[key]
    d[key] = value
    try:
        yield orig
    finally:
        d[key] = orig


def parity_protocol(check, dev, card: str, tag: str, iters, out_json: str, workdir: str) -> dict:
    """``run_parity.main(["--out", out_json, "--workdir", workdir])`` on the
    card, the entry point as a user runs it, with ``CONFIGS["full"]``'s
    iteration counts replaced by ``iters`` for the call (None: the full
    depth) and the plain K1-K3 made to raise. Each part runs timed (the GT
    scene's renders, each stage through timed_stage, each evaluation): its
    wall, launches, peak GB and last launches held to the plain versions.
    Every record the stages log is kept, and every QEM call. Checks the
    results JSON, the scores (finite; vanilla above the degraded init;
    tests/test_parity.py's ordering), the mesh's size through QEM, each
    stage's launches and the counts of Gaussians."""
    scfg, full_iters, capacity, extract_over = run_parity.CONFIGS["full"]
    iters = tuple(iters or full_iters)
    v_it, c_it, r_it = iters
    timed: dict[str, dict] = {}
    logs: dict[str, list] = collections.defaultdict(list)
    seen: dict = {"art": {}, "qem": [], "levelset": []}
    errs: dict[str, float] = {}

    def block(label, fn, stage=None):
        if stage:
            r, st = timed_stage(check, tag, stage, fn)
        else:
            r, st, _ = timed_run(check, tag, label, fn)
        timed[label] = st
        for k, v in st["errs"].items():
            errs[k] = max(errs.get(k, 0.0), v)
        return r

    def scene_kept(**kw):
        seen["scene"], seen["target"] = block("scene", lambda: make_scene_orig(**kw))
        return seen["scene"], seen["target"]

    def staged(name, run):
        def stage(cfg, scene, *args, log_fn):
            seen["cfg"] = cfg

            def keep(r):
                logs[name].append(json.loads(r))
                log_fn(r)

            seen["art"][name] = block(name, lambda: run(cfg, scene, *args, log_fn=keep), name)
            return seen["art"][name]
        return stage

    def evaluated(*args, **kwargs):
        return block(f"evaluation {sum(k.startswith('evaluation') for k in timed)}",
                     lambda: eval_orig(*args, **kwargs))

    def qem_kept(v, f, target):
        out = qem_orig(v, f, target)
        seen["qem"].append(dict(vertices_in=len(v), faces_in=len(f), target=target,
                                vertices_out=len(out[0]), faces_out=len(out[1])))
        return out

    def collect_kept(*args, **kwargs):
        out = collect_orig(*args, **kwargs)
        seen["levelset"].extend(out["overflow"])
        return out

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped_item(run_parity.CONFIGS, "full", parity_cut(iters)))
        make_scene_orig = stack.enter_context(swapped(run_parity, "make_parity_scene", scene_kept))
        eval_orig = stack.enter_context(swapped(run_parity, "eval_gaussian_ply", evaluated))
        for s in PARITY_STAGES:
            stack.enter_context(swapped(run_parity, f"run_{s}",
                                        staged(s, getattr(run_parity, f"run_{s}"))))
        qem_orig = stack.enter_context(swapped(native, "qem_decimate", qem_kept))
        collect_orig = stack.enter_context(swapped(levelset, "collect_surface_points",
                                                   collect_kept))
        stack.enter_context(no_fallback(refuse_fused=False))
        res = run_parity.main(["--out", out_json, "--workdir", workdir], device=dev)
    main_s = time.perf_counter() - t0
    check(run_parity.CONFIGS["full"][1] == full_iters, f"{tag} CONFIGS['full'] restored")
    with open(out_json) as f:
        written = json.load(f)
    scene, cfg, art = seen["scene"], seen["cfg"], seen["art"]
    train_idx, test_idx = scene.split(True)

    # The degraded init (create_from_pcd of the scene's points, as the
    # vanilla trainer starts) scored on the held-out views.
    init_ply = os.path.join(workdir, "init.ply")
    init = gm_mod.create_from_pcd(scene.points, scene.colors, capacity,
                                  sh_degree=cfg.vanilla_overrides["sh_degree"], device=dev)
    save_ply(init, init_ply)
    with no_fallback(refuse_fused=False):
        init_r = block("init evaluation", lambda: eval_gaussian_ply(
            init_ply, scene, test_idx, render_mode="pallas", k_max=1024))
    del init

    st = res["stages"]
    p = {k: st[k]["psnr"] for k in ("vanilla", "coarse_sdf", "refined")}
    print(f"{tag} run_parity.main at the full configuration's widths (scene {json.dumps(scfg)}, "
          f"capacity {capacity}, extraction {json.dumps(extract_over)}), iterations {iters}: "
          f"{main_s:.1f} s on {card}; results {json.dumps(written)}")
    print(f"{tag} held-out PSNR / SSIM ({len(test_idx)} views): degraded init "
          f"{init_r['psnr']:.3f} dB / {init_r['ssim']:.4f}, "
          + ", ".join(f"{k} {st[k]['psnr']:.3f} dB / {st[k]['ssim']:.4f}"
                      for k in ("vanilla", "coarse_sdf", "refined"))
          + f"; mesh {st['mesh']['vertices']} vertices / {st['mesh']['faces']} faces")
    for label, t in timed.items():
        print(f"{tag} {label}: {t['wall_s']:.2f} s, launches (K1, K2, K3, binning, preprocess, preprocess bwd) {t['launches']}, "
              f"peak "
              f"{t['peak_gb']:.3f} GB (allocated at its start {t['start_gb']:.3f})")

    # What the stages logged: densify passes, KNN builds, cap growth, the
    # counts of live Gaussians.
    models = {k: load_ply(art[k], device=dev) for k in ("vanilla", "coarse")}
    alive = {k: int(m.alive.sum()) for k, m in models.items()}
    del models
    for name in ("vanilla", "coarse", "refine"):
        recs = logs[name]
        grows = [r for r in recs if r.get("event") == "cap_grow"]
        steps = [r for r in recs if "loss" in r]
        events = collections.Counter(r.get("event") for r in recs if r.get("event"))
        print(f"{tag} {name} log: {len(steps)} logged iterations, loss {steps[0]['loss']:.5f} -> "
              f"{steps[-1]['loss']:.5f}, train PSNR {steps[-1]['psnr']:.3f} dB"
              + (f", n_alive {[r['n_alive'] for r in steps]}" if "n_alive" in steps[0] else "")
              + f"; events {dict(events)}; cap_grow {len(grows)}"
              + (f", final caps {json.dumps(grows[-1]['new'])}" if grows else ""))
        for r in grows:
            print(f"    {json.dumps(r)}")
        check(all(math.isfinite(r["loss"]) for r in steps), f"{tag} {name}: every logged loss "
              f"finite")
    dens = [r for r in logs["vanilla"] if "iter" in r and "loss" not in r and "event" not in r]
    for r in dens:
        print(f"    densify {json.dumps(r)}")
    knn_iters = [r["iter"] for r in logs["coarse"] if r.get("event") == "knn"]
    print(f"{tag} alive: init {len(scene.points)}, vanilla {alive['vanilla']} of capacity "
          f"{capacity} ({len(dens)} densify passes), coarse after the prune {alive['coarse']}; "
          f"KNN builds at {knn_iters}")
    print(f"{tag} QEM calls {json.dumps(seen['qem'])}; level set over {len(seen['levelset'])} "
          f"cameras, counters summed " + json.dumps(
              {k: sum(o[k] for o in seen["levelset"]) for k in seen["levelset"][0]}))

    check(set(written) == PARITY_KEYS and written["stages"] == res["stages"]
          and written["device"] == card and written["iterations"] == dict(
              zip(("vanilla", "coarse", "refine"), iters)) and written["scene"] == scfg,
          f"{tag} the results JSON holds the JAX record's fields, the card line and the iterations")
    check(all(math.isfinite(st[k]["psnr"]) and math.isfinite(st[k]["ssim"])
              and st[k]["n_images"] == len(test_idx) for k in p),
          f"{tag} every stage's PSNR and SSIM finite, on {len(test_idx)} held-out views")
    check(p["vanilla"] > init_r["psnr"], f"{tag} vanilla {p['vanilla']:.3f} dB above the degraded "
          f"init's {init_r['psnr']:.3f} dB")
    # tests/test_parity.py:98-99's ordering. Its second invariant, refined >
    # coarse - 3 dB, holds at that test's toy scale (vanilla ~17 dB) and not
    # at this configuration's, in the port at any depth measured: vanilla
    # fits the GT scene to 42-47 dB, and the mesh-bound refined model stays
    # 12-25 dB under the coarse one (the full depth: 30.03 against 42.44 dB,
    # PARITY_torch_r01.json; ROADMAP.md queue 3). It is printed, and the
    # refined stage is held to the JAX record as every stage is.
    order = dict(coarse_minus_vanilla=p["coarse_sdf"] - p["vanilla"],
                 refined_minus_coarse=p["refined"] - p["coarse_sdf"])
    print(f"{tag} ordering: coarse - vanilla {order['coarse_minus_vanilla']:+.3f} dB (> -1.0: "
          f"{order['coarse_minus_vanilla'] > -1.0}), refined - coarse "
          f"{order['refined_minus_coarse']:+.3f} dB (> -3.0: "
          f"{order['refined_minus_coarse'] > -3.0}); "
          f"against PARITY_r05.json (TPU v5e, the JAX package, full depth) "
          + ", ".join(f"{k} {p[k] - v:+.3f} dB" for k, v in PARITY_R05_PSNR.items()))
    check(order["coarse_minus_vanilla"] > -1.0, f"{tag} coarse > vanilla - 1 dB "
          f"(tests/test_parity.py:98)")
    check(all(p[k] > v - PARITY_RECORD_DB for k, v in PARITY_R05_PSNR.items()),
          f"{tag} no stage more than {PARITY_RECORD_DB} dB under PARITY_r05.json's")
    target = extract_over["decimation_target"]
    check(PARITY_MESH_MIN < st["mesh"]["vertices"] <= target and st["mesh"]["faces"] > 0,
          f"{tag} mesh vertices in ({PARITY_MESH_MIN}, {target}]")
    check(len(seen["qem"]) > 0 and all(q["target"] == target for q in seen["qem"]),
          f"{tag} the mesh went through QEM decimation to {target}")
    check(len(seen["levelset"]) == len(train_idx), f"{tag} the level set renders each of the "
          f"{len(train_idx)} train cameras once")
    sdf_from = v_it + int(c_it * 0.3)
    want = {"vanilla": (v_it,) * 6,
            "coarse": (c_it + v_it + c_it - sdf_from,) * 4 + (c_it,) * 2,
            "extract_mesh": (len(train_idx), 0, 0, len(train_idx), 0, 0),
            "refine": (r_it,) * 6}
    for name, w in want.items():
        check(timed[name]["launches"] == w, f"{tag} {name}: launches (K1, K2, K3, binning, preprocess, preprocess bwd) {w}")
    for label, t in timed.items():
        if label not in want:
            check(t["launches"][0] >= len(scene.cameras if label == "scene" else test_idx)
                  and t["launches"][1:3] == (0, 0)
                  and t["launches"][3] == t["launches"][4] == t["launches"][0]
                  and t["launches"][5] == 0,
                  f"{tag} {label}: K1 at least once per view and one binning and one preprocess "
                  f"a K1, no K2, K3 or preprocess backward")
    check(0 < alive["coarse"] <= alive["vanilla"] <= capacity, f"{tag} 0 < coarse alive <= "
          f"vanilla alive <= capacity")
    launches = tuple(sum(t["launches"][k] for t in timed.values()) for k in range(6))
    return dict(results=res, written=written, timed=timed, logs=logs, alive=alive,
                qem=seen["qem"], init=init_r, scene=scene, target=seen["target"], cfg=cfg, art=art,
                errs=errs,
                launches=launches, wall_s=main_s)


# The NeRF-synthetic copy of the parity scene (PNG quantisation: alpha and
# the straight colour each round to 1/255; with both, a composited pixel
# is within 1/255 of the in-memory scene).
NERF_PX_ATOL = 1.0 / 255 + 1e-6
NERF_CAM_ATOL = 1e-6  # the cameras through the JSON's float64 c2w
ABLATION_N = 3_000  # the ablations' card-vs-CPU size
ABLATION_RES = 48
EDIT_SCALE = 1.5  # a uniform scale of the refined mesh about the origin
EDIT_RTOL = 1e-4
# The scaled mesh's rotations: each corner angle is arccos of a float32
# cosine near +-1, where one rounding (2^-24) moves the angle by up to
# sqrt(2 * 2^-24) = 3.5e-4.
EDIT_QUAT_ATOL = 1e-3


def scene_alphas(target, cameras, caps: adaptive.RasterCaps) -> list[np.ndarray]:
    """1 - final_T of the GT model's render at each camera (its coverage)."""
    alphas = []
    for cam in cameras:
        with torch.no_grad():
            out, caps = adaptive.render_adaptive(render_model, caps, target, cam)
        alphas.append(torch.clamp(1.0 - out["final_T"], 0.0, 1.0).cpu().numpy())
    return alphas


def write_nerf_synthetic(scene, alphas: list[np.ndarray], root: str) -> None:
    """A scene as a NeRF-synthetic scene on disk: every view in
    transforms_train.json (train/r_i.png; the pipeline holds out every
    8th itself), the held-out views also in transforms_test.json
    (test/r_i.png). Each PNG is RGBA (io/png): alpha the view's coverage,
    colour the straight (un-premultiplied) image, so that loading over a
    black background gives back the image and over white the image plus
    the uncovered share."""
    _, test_idx = scene.split(True)
    fov = 2.0 * math.atan(scene.cameras[0].tan_half_fov_x)
    for split, idx in (("train", range(len(scene.cameras))), ("test", test_idx)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in idx:
            a8 = np.round(np.clip(alphas[i], 0.0, 1.0) * 255).astype(np.uint8)
            a = a8.astype(np.float32)[..., None] / 255
            rgb = np.where(a > 0, scene.images[i] / np.maximum(a, 1.0 / 255), 0.0)
            rgb8 = np.round(np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)
            write_png(os.path.join(root, split, f"r_{i}.png"),
                      np.concatenate([rgb8, a8[..., None]], -1))
            c2w = np.linalg.inv(scene.cameras[i].world_view.cpu().numpy().astype(np.float64))
            c2w[:3, 1:3] *= -1  # back to Blender axes
            frames.append(dict(file_path=f"{split}/r_{i}", transform_matrix=c2w.tolist()))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(camera_angle_x=fov, frames=frames), f)


def scene_agreement(loaded, scene, idx, alphas, white: bool) -> dict:
    """The largest differences of a loaded scene's cameras and images from
    the in-memory scene's views ``idx``: world_view and full_proj, and (at
    the same size) the images against the view composited over the
    background."""
    cam_err = max(float((getattr(a, k).cpu() - getattr(scene.cameras[i], k).cpu()).abs().max())
                  for a, i in zip(loaded.cameras, idx) for k in ("world_view", "full_proj"))
    same_size = all((c.height, c.width) == (scene.cameras[i].height, scene.cameras[i].width)
                    for c, i in zip(loaded.cameras, idx))
    px_err = max(float(np.abs(img - (scene.images[i] + (1.0 - alphas[i][..., None]) * white)).max())
                 for img, i in zip(loaded.images, idx)) if same_size else None
    return dict(cam_err=cam_err, px_err=px_err, n=len(loaded.cameras), same_size=same_size)


def mesh_gap(a: tuple, b: tuple) -> dict:
    """Vertex and face counts of two meshes and their symmetric mean
    nearest-vertex distance over the first's bounding-box diagonal."""
    from scipy.spatial import cKDTree

    (va, fa), (vb, fb) = a, b
    diag = float(np.linalg.norm(va.max(0) - va.min(0)))
    gap = (cKDTree(vb).query(va)[0].mean() + cKDTree(va).query(vb)[0].mean()) / 2 / diag
    return dict(vertices=(len(va), len(vb)), faces=(len(fa), len(fb)), gap=float(gap))


def phase_parity_width(check, dev, card, textured_obj: str) -> dict:
    """[19] (a) run_parity.main at the full configuration's widths with only
    the iteration counts cut (parity_protocol), then main again on the same
    workdir (every training stage skips); (b) on its artifacts the loaders
    and entry points no other phase drives: the parity scene written as a
    NeRF-synthetic scene and loaded by pipeline.load_scene (white and black
    background, resolution factors 1 and 2), the vanilla PLY through
    load_reference_checkpoint, extract_mesh.main on the coarse PLY, the two
    ablation extractions, edited_quaternions_and_scales on the refined
    state, run_viewer.main on the refined PLY and [18]'s textured OBJ. The
    plain K1-K3 raise throughout."""
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "parity")
    shutil.rmtree(root, ignore_errors=True)
    workdir, out_json = os.path.join(root, "work"), os.path.join(root, "parity.json")
    pa = parity_protocol(check, dev, card, "[19]", PARITY_WIDTH_ITERS, out_json, workdir)
    scene, cfg, art = pa["scene"], pa["cfg"], pa["art"]
    train_idx, test_idx = scene.split(True)
    errs = dict(pa["errs"])
    counts: dict[str, tuple] = {}
    walls: dict[str, float] = {}
    guard = functools.partial(no_fallback, refuse_fused=False)

    def entry(name, fn, want):
        r, walls[name], counts[name], e = timed_entry(check, "[19]", name, fn, want, guard)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        return r

    # main again on the same workdir: each training stage logs stage_skip,
    # and only the GT renders and the evaluations launch (K1).
    skips: list = []

    def skipped(run):
        def stage(cfg, scene, *args, log_fn):
            def keep(r):
                skips.extend([json.loads(r)["stage"]] if '"stage_skip"' in r else [])
                log_fn(r)
            return run(cfg, scene, *args, log_fn=keep)
        return stage

    with contextlib.ExitStack() as stack:
        stack.enter_context(swapped_item(run_parity.CONFIGS, "full",
                                         parity_cut(PARITY_WIDTH_ITERS)))
        for s in PARITY_STAGES:
            stack.enter_context(swapped(run_parity, f"run_{s}", skipped(getattr(run_parity,
                                                                                 f"run_{s}"))))
        again = entry("run_parity.main again", lambda: run_parity.main(
            ["--out", os.path.join(root, "again.json"), "--workdir", workdir], device=dev), None)
    print(f"[19] run_parity.main again on the same workdir: "
          f"{walls['run_parity.main again']:.2f} s, "
          f"stage_skip {skips}, launches (K1, K2, K3, binning, preprocess, preprocess bwd) {counts['run_parity.main again']}")
    check(skips == list(PARITY_STAGES) and again["stages"] == pa["results"]["stages"],
          "[19] run_parity.main again: every training stage skips, the scores are the first run's")

    # (b) The parity scene as a NeRF-synthetic scene on disk.
    nerf = os.path.join(root, "nerf")
    t0 = time.perf_counter()
    alphas = scene_alphas(pa["target"], scene.cameras,
                          adaptive.RasterCaps(tile_cap=16, dup_capacity=8 * pa["target"].capacity,
                                              k_max=1024))
    write_nerf_synthetic(scene, alphas, nerf)
    write_s = time.perf_counter() - t0
    loaded = {}
    for white in (False, True):
        for factor in (1, 2):
            t0 = time.perf_counter()
            loaded[white, factor] = load_scene(PipelineConfig(
                scene_path=nerf, white_background=white, resolution_factor=factor), device=dev)
            walls[f"load_scene white {white} factor {factor}"] = time.perf_counter() - t0
    test_scene = load_blender_scene(nerf, split="test", white_background=False, device=dev)
    every = range(len(scene.cameras))
    agree = {f"white {w}": scene_agreement(loaded[w, 1], scene, every, alphas, w)
             for w in (False, True)}
    agree["test split"] = scene_agreement(test_scene, scene, test_idx, alphas, False)
    half = loaded[False, 2]
    h2 = scene.cameras[0].height // 2
    half_ok = all((c.height, c.width) == (h2, h2) and abs(c.tan_half_fov_x - s.tan_half_fov_x)
                  <= 1e-6 and torch.equal(c.world_view, l1.world_view)
                  for c, s, l1 in zip(half.cameras, scene.cameras, loaded[False, 1].cameras))
    # The half-size images against a 2x2 box filter of the full-size ones.
    box = max(float(np.abs(h - s.reshape(h2, 2, h2, 2, 3).mean((1, 3))).mean())
              for h, s in zip(half.images, scene.images))
    v_model = load_ply(art["vanilla"], device=dev)
    with no_fallback(refuse_fused=False):
        reset_launches()
        views = {k: render_model(v_model, loaded[False, k].cameras[1])["image"] for k in (1, 2)}
        mem = render_model(v_model, scene.cameras[1])["image"]
        torch.cuda.synchronize()
        view_counts = launches()
    print(f"[19] NeRF-synthetic scene written ({len(scene.cameras)} RGBA PNGs at "
          f"{scene.cameras[0].height}x{scene.cameras[0].width}, transforms_train.json and "
          f"transforms_test.json): {write_s:.2f} s; loaded by load_scene in "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items() if k.startswith("load_scene"))
          + f"; against the in-memory scene {json.dumps(agree)}; factor 2: {h2}x{h2} cameras "
          f"{half_ok}, mean abs gap to a 2x2 box filter {box:.5f}; view 1 of the vanilla model "
          f"at the loaded cameras: max abs {float((views[1] - mem).abs().max()):.3e} from the "
          f"in-memory camera's, {tuple(views[2].shape)} at factor 2, launches {view_counts}")
    check(all(a["cam_err"] <= NERF_CAM_ATOL and a["px_err"] <= NERF_PX_ATOL and a["same_size"]
              for a in agree.values()) and agree["test split"]["n"] == len(test_idx)
          and all(a["n"] == len(scene.cameras) for k, a in agree.items() if k != "test split"),
          f"[19] the NeRF-synthetic scene loads back: cameras within {NERF_CAM_ATOL}, images "
          f"within 1/255 over black and white, the test split its held-out views")
    check(half_ok and box <= 0.02 and all(i.shape == (h2, h2, 3) for i in half.images),
          "[19] resolution factor 2: half-size cameras (same pose and field of view), images "
          "near a 2x2 box filter")
    check(float((views[1] - mem).abs().max()) <= 1e-4 and tuple(views[2].shape) == (h2, h2, 3)
          and bool(torch.isfinite(views[2]).all()) and view_counts == (3, 0, 0, 3, 3, 0),
          "[19] the vanilla model renders the loaded cameras as the in-memory ones")
    del loaded, half, test_scene, views, mem

    # The vanilla PLY in the reference layout, through load_reference_checkpoint.
    ref = os.path.join(root, "reference_gs")
    os.makedirs(os.path.join(ref, "point_cloud", "iteration_7000"))
    shutil.copy(art["vanilla"], os.path.join(ref, "point_cloud", "iteration_7000",
                                             "point_cloud.ply"))
    t0 = time.perf_counter()
    r_model = pipeline_mod.load_reference_checkpoint(ref, device="cuda")
    walls["load_reference_checkpoint"] = time.perf_counter() - t0
    same = (r_model.params.xyz.device.type == "cuda" and r_model.sh_degree == v_model.sh_degree
            and torch.equal(r_model.alive, v_model.alive)
            and all(torch.equal(getattr(r_model.params, f), getattr(v_model.params, f))
                    for f in PARAM_FIELDS))
    print(f"[19] load_reference_checkpoint (point_cloud/iteration_7000/point_cloud.ply): "
          f"{walls['load_reference_checkpoint']:.2f} s, {int(r_model.alive.sum())} Gaussians, SH "
          f"{r_model.sh_degree}, on {r_model.params.xyz.device}; parameters equal load_ply's "
          f"{same}")
    check(same, "[19] load_reference_checkpoint loads the vanilla PLY's parameters on the card")
    del r_model, v_model

    # extract_mesh.main on the coarse PLY over the NeRF-synthetic scene,
    # with the protocol's extraction settings (the parity config with the
    # script's paths): the pipeline's mesh.
    with swapped(extract_mesh_script, "PipelineConfig",
                 lambda **kw: dataclasses.replace(cfg, **kw)):
        mesh2 = entry("extract_mesh", lambda: extract_mesh_script.main(
            ["-s", nerf, "-c", art["coarse"], "-o", os.path.join(root, "extract")], device=dev),
            (len(train_idx), 0, 0, len(train_idx), 0, 0))
    mv, mf, _ = load_mesh_ply(art["extract_mesh"])
    mv2, mf2, _ = load_mesh_ply(mesh2)
    gap = mesh_gap((mv, mf), (mv2, mf2))
    print(f"[19] extract_mesh.main on the coarse PLY over the NeRF-synthetic scene: "
          f"{walls['extract_mesh']:.2f} s, launches {counts['extract_mesh']}; mesh {len(mv2)} "
          f"vertices / {len(mf2)} faces against the pipeline's {len(mv)} / {len(mf)}, equal "
          f"{np.array_equal(mv, mv2) and np.array_equal(mf, mf2)}; gap {gap['gap']:.3e}")
    check(np.array_equal(mv, mv2) and np.array_equal(mf, mf2),
          "[19] extract_mesh.main gives the pipeline's mesh")

    # The ablation extractions on the coarse model, then each at a small
    # size on the card and the CPU.
    c_model = load_ply(art["coarse"], device=dev)
    train_cams = [scene.cameras[i] for i in train_idx]
    abl = {}
    for name, fn in (("centers", lambda m, cams: extract_mesh_from_gaussian_centers(m, cams)),
                     ("marching cubes", lambda m, cams: extract_mesh_with_marching_cubes(m))):
        v, f = entry(f"ablation {name}", lambda: fn(c_model, train_cams), (0,) * 6)
        abl[name] = (len(v), len(f), float(np.median(np.linalg.norm(v, axis=1))))
    small = {}
    for dname in (dev, "cpu"):
        m = model_from_numpy({f: getattr(c_model.params, f)[c_model.alive][:ABLATION_N]
                              .cpu().numpy() for f in PARAM_FIELDS},
                             np.ones(ABLATION_N, bool), c_model.sh_degree, device=dname)
        small[str(dname)] = dict(
            centers=extract_mesh_from_gaussian_centers(m, [], poisson_resolution=ABLATION_RES,
                                                       decimation_target=2_000),
            mc=extract_mesh_with_marching_cubes(m, resolution=ABLATION_RES))
    gaps = {k: mesh_gap(small[str(dev)][k], small["cpu"][k]) for k in ("centers", "mc")}
    print(f"[19] ablations on the coarse model ({int(c_model.alive.sum())} Gaussians): "
          + ", ".join(f"{k} {walls['ablation ' + k]:.2f} s, {v[0]} vertices / {v[1]} faces, median "
                      f"radius {v[2]:.4f}" for k, v in abl.items())
          + f"; at {ABLATION_N} Gaussians, resolution {ABLATION_RES}, card vs CPU "
          f"{json.dumps(gaps)}")
    check(all(v[0] > 1_000 and v[1] > 1_000 and 0.3 < v[2] < 1.6 for v in abl.values()),
          "[19] both ablations give a mesh of the blob (> 1,000 vertices, median radius in "
          "(0.3, 1.6))")
    # The card's PCA normals differ from the CPU's in the last bits, and QEM
    # then breaks ties of equal cost apart: counts within 1%, as
    # tests/test_torch_run_parity.py holds the decimated mesh to JAX's.
    check(all(abs(g["vertices"][0] - g["vertices"][1]) <= 0.01 * g["vertices"][1]
              and abs(g["faces"][0] - g["faces"][1]) <= 0.01 * g["faces"][1]
              and g["gap"] <= 1e-4 for g in gaps.values()),
          "[19] the ablations on the card give the CPU's mesh at a small size (counts within 1%, "
          "gap <= 1e-4 of the diagonal)")
    del c_model

    # edited_quaternions_and_scales on the refined state: the undeformed mesh
    # gives the bound Gaussians' own rotations and scales; a uniform scale
    # by EDIT_SCALE keeps the rotations and the thickness and stretches each
    # in-plane scale by a factor in [1, EDIT_SCALE] (the reference stretches
    # along each corner's centre axis only, sugar_model.py:633-659); at a
    # small size on the card against the CPU.
    sp, sbm = load_refined_state(art["refine"].replace(".ply", "_state.pkl"), device=dev)
    q0, s0 = refine_bound.gaussian_quaternions(sp, sbm), refine_bound.gaussian_scales(sp, sbm)
    reset_launches()
    t0 = time.perf_counter()
    q1, s1 = refine_bound.edited_quaternions_and_scales(sp, sbm, sp.vertices)
    q2, s2 = refine_bound.edited_quaternions_and_scales(
        dataclasses.replace(sp, vertices=sp.vertices * EDIT_SCALE), sbm, sp.vertices)
    torch.cuda.synchronize()
    walls["edited_quaternions_and_scales"] = (time.perf_counter() - t0) / 2
    counts["edited_quaternions_and_scales"] = launches()

    def q_err(a, b):
        return float(torch.minimum((a - b).abs().amax(-1), (a + b).abs().amax(-1)).max())

    e_same = (q_err(q1, q0), float(((s1 - s0).abs() / s0).max()))
    ratio = s2[:, 1:] / s0[:, 1:]
    e_scaled = (q_err(q2, q0), float(torch.clamp(1.0 - ratio, min=0).max()
                                     + torch.clamp(ratio - EDIT_SCALE, min=0).max()),
                float((s2[:, 0] - s0[:, 0]).abs().max()))
    pieces = []
    for dname in (dev, "cpu"):
        xs = np.linspace(-1.5, 1.5, 14)
        X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
        sphere = (np.sqrt(X**2 + Y**2 + Z**2) - 1.0).astype(np.float32)
        vg, faces = poisson.surface_nets(sphere, 0.0)
        verts = (vg * (xs[1] - xs[0]) + xs[0]).astype(np.float32)
        gray = np.full((len(verts), 3), 0.5, np.float32)
        p, bm = init_bound_params(verts, faces, gray, 3, extent=2.0, sh_degree=0, device=dname)
        bent = torch.as_tensor(verts + 0.2 * np.sin(2.0 * verts[:, ::-1]), device=dname)
        pieces.append(refine_bound.edited_quaternions_and_scales(
            dataclasses.replace(p, vertices=bent), bm, p.vertices))
    e_small = (q_err(pieces[0][0].cpu(), pieces[1][0]),
               float((pieces[0][1].cpu() - pieces[1][1]).abs().max()))
    print(f"[19] edited_quaternions_and_scales on the refined state ({q0.shape[0]} Gaussians, "
          f"{sbm.n_per_triangle} per triangle): {walls['edited_quaternions_and_scales'] * 1e3:.1f} "
          f"ms a call, launches {counts['edited_quaternions_and_scales']}; undeformed: quaternion "
          f"{e_same[0]:.3e}, scale rel {e_same[1]:.3e}; scaled x{EDIT_SCALE}: quaternion "
          f"{e_scaled[0]:.3e}, in-plane stretch in [{float(ratio.min()):.4f}, "
          f"{float(ratio.max()):.4f}] (outside [1, {EDIT_SCALE}] by {e_scaled[1]:.3e}), thickness "
          f"{e_scaled[2]:.3e}; "
          f"bent sphere ({pieces[1][0].shape[0]} Gaussians) card vs CPU: quaternion "
          f"{e_small[0]:.3e}, scale {e_small[1]:.3e}")
    check(max(e_same) <= EDIT_RTOL and e_scaled[0] <= EDIT_QUAT_ATOL
          and max(e_scaled[1:]) <= EDIT_RTOL
          and bool(torch.isfinite(q2).all() and torch.isfinite(s2).all()),
          f"[19] edited_quaternions_and_scales: the undeformed mesh gives the bound Gaussians' own "
          f"rotations and scales (within {EDIT_RTOL}), the scaled one the same rotations (within "
          f"{EDIT_QUAT_ATOL}) and stretches in [1, {EDIT_SCALE}]")
    check(max(e_small) <= 1e-5, "[19] edited_quaternions_and_scales on the card within 1e-5 of "
          "the CPU")
    del sp, sbm, q0, s0, q1, s1, q2, s2, ratio

    # run_viewer on the refined PLY and [18]'s textured OBJ.
    viewer = os.path.join(root, "viewer")
    desc = entry("run_viewer", lambda: run_viewer.main(
        ["-p", art["refine"], "-m", textured_obj, "--viewer_dir", viewer]), (0,) * 6)
    with open(desc) as f:
        d = json.load(f)
    print(f"[19] run_viewer: {walls['run_viewer']:.2f} s; descriptor {json.dumps(d)}")
    check(d == dict(ply=os.path.abspath(art["refine"]), obj=os.path.abspath(textured_obj),
                    png=os.path.abspath(os.path.splitext(textured_obj)[0] + ".png"))
          and all(os.path.exists(p) for p in d.values()),
          "[19] run_viewer's descriptor loads back and names the refined PLY, the OBJ and its PNG")
    shutil.rmtree(root, ignore_errors=True)

    total = tuple(pa["launches"][k] + sum(c[k] for c in counts.values()) for k in range(6))
    wall = time.perf_counter() - t_phase
    print(f"[19] summary on {card}: {wall:.1f} s (run_parity.main {pa['wall_s']:.1f} s); stages "
          + ", ".join(f"{k} {pa['timed'][k]['wall_s']:.2f} s / {pa['timed'][k]['peak_gb']:.2f} GB"
                      for k in PARITY_STAGES)
          + "; PSNR " + ", ".join(f"{k} {pa['results']['stages'][k]['psnr']:.3f}"
                                  for k in ("vanilla", "coarse_sdf", "refined"))
          + f" dB; (b) " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; launches (K1, K2, K3, binning, preprocess, preprocess bwd) all {total}; kernels vs plain {json.dumps(errs)}")
    return dict(launches=total, errs=errs, wall_s=wall)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' bmm
    torch.backends.cudnn.allow_tf32 = False
    check = Checks()

    card = card_line()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    phase_builds()
    bn = phase_binning(check, dev)
    pre = phase_preprocess(check, dev, bn.pop("fields"))

    # [3] synthetic cases: K1, K2, K3 against their plain versions.
    start, count, data, tiles_x, ch, max_chunks = synthetic_case(0)
    syn = (torch.as_tensor(start, device=dev), torch.as_tensor(count, device=dev),
           torch.as_tensor(data, device=dev), tiles_x, ch, max_chunks)
    kern = tile_composite_cuda(*syn)
    torch.cuda.synchronize()
    plain = tile_composite_plain(*syn)
    d = compare(kern, plain, syn)
    print(f"[3] K1 vs plain, synthetic case: {json.dumps(d)}")
    print(f"    nch {kern.nch.tolist()}")
    check(compare_ok(d), "synthetic case agrees with the plain version")
    check(bool(torch.isfinite(kern.img).all()), "synthetic case image finite (NaN slots gated)")
    check(int(kern.nch[3]) < 3, "synthetic opaque tile exits early")
    check(int(kern.nch[2]) == 4, "synthetic 700-slot unaligned range walks 4 chunks")
    check(int(kern.nch[4]) == 4, "synthetic 1000-slot range is clipped to 768 slots")
    g_img, g_t = composite_cotangents(len(start), ch, seed=10)
    bg = torch.tensor([0.2, 0.5, 0.7], device=dev)
    g_img = torch.as_tensor(g_img, device=dev)
    gt_total = (torch.as_tensor(g_t, device=dev) + (g_img * bg).sum(-1)).contiguous()
    check_k2(check, kern, syn, g_img, gt_total, "synthetic case")
    phase_deep(check, dev)
    for name, (ct, gid, n) in (segsum_cases() | segsum_edge_cases()).items():
        check_k3(check, torch.as_tensor(ct, device=dev), torch.as_tensor(gid, device=dev), n, name)
    # One row that starts 4 bytes into its allocation: the kernel may not
    # assume 16-byte-aligned rows.
    ct, gid, n = segsum_cases()["n1000_d3000_seg16"]
    wide = torch.as_tensor(np.pad(ct[:1], ((0, 0), (1, 0))), device=dev)
    check_k3(check, wide[:, 1:], torch.as_tensor(gid, device=dev), n,
             "unaligned base (one row at a 4-byte offset)")

    # The slice's model: numpy -> the port's PLY -> load_ply on the card.
    os.makedirs(WORK, exist_ok=True)
    ply_path = os.path.join(WORK, "trained_1m_sh3.ply")
    try:
        t0 = time.perf_counter()
        arrays = scene_params(N_GAUSS, SCENE_SEED, SH_DEGREE)
        host_model = model_from_numpy(arrays, np.ones(N_GAUSS, bool), SH_DEGREE, device="cpu")
        save_ply(host_model, ply_path)
        model = load_ply(ply_path, device="cuda")
        torch.cuda.synchronize()
        print(f"[3] scene: {N_GAUSS} Gaussians, SH degree {model.sh_degree}, "
              f"capacity {model.capacity}, PLY {os.path.getsize(ply_path) / 1e6:.1f} MB, "
              f"built+saved+loaded in {time.perf_counter() - t0:.2f} s")
        same = all(
            np.array_equal(getattr(model.params, f)[:N_GAUSS].cpu().numpy(), arrays[f])
            for f in PARAM_FIELDS
        )
        check(same and model.sh_degree == SH_DEGREE, "PLY round trip is bit-exact")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    cams = ring_cameras(VIEWS, dev)

    # [3] full-width inputs of view 0: K1, then K2 on K1's records, then
    # K3 on view 0's real gids and K2's d_packed as the cotangent. View 0
    # is preprocessed as render_model does it (the preprocess kernel).
    settings = dataclasses.replace(rc.from_camera(cams[0], device=dev), sh_degree=SH_DEGREE)
    with torch.no_grad():
        p = model.params
        prep = preprocess_mod.preprocess_fields(
            p.xyz, p.opacity_logit, p.log_scales, p.quaternions, p.sh_dc, p.sh_rest, settings,
            alive_mask=model.alive,
        )
        b, dup_data = bin_and_gather(
            prep, settings, CAPS.tile_cap, CAPS.dup_capacity, CAPS.cap_a, CAPS.big_cap
        )
    fw_max_chunks = max(1, (CAPS.k_max + C_CHUNK - 1) // C_CHUNK)
    fw_args = (b["tile_start"], b["tile_count"], dup_data, settings.tiles_x, 3, fw_max_chunks)
    kern = tile_composite_cuda(*fw_args)
    torch.cuda.synchronize()
    plain = tile_composite_plain(*fw_args)
    d = compare(kern, plain, fw_args)
    num_rendered = int(b["num_rendered"])
    max_tile_count = int(b["tile_count"].max())
    print(f"[3] K1 vs plain, full width (view 0): {json.dumps(d)}")
    print(f"    view 0: num_rendered {num_rendered}, max_tile_count {max_tile_count}, "
          f"dup_data {tuple(dup_data.shape)}, entry_p depth {kern.entry_p.shape[1]}, "
          f"processed chunk-tiles {int(kern.nch.sum())}, deepest nch {int(kern.nch.max())}")
    check(compare_ok(d), "full-width case agrees with the plain version")
    k1_err = abs_err(d)
    nch_sorted = torch.sort(kern.nch.to(torch.float32)).values
    print(f"    nch per tile: mean {float(nch_sorted.mean()):.2f}, "
          f"p50 {float(nch_sorted[len(nch_sorted) // 2]):.0f}, "
          f"p99 {float(nch_sorted[int(0.99 * len(nch_sorted))]):.0f}, max {float(nch_sorted[-1]):.0f}")
    covering = int(_tile_ranges(b["tile_start"], b["tile_count"], fw_max_chunks)[3].sum())
    print(f"    (tile, chunk) pairs: {covering} "
          f"cover the tiles' ranges, {int(kern.nch.sum())} are processed before the exits")
    num_tiles = b["tile_start"].shape[0]
    g_img, g_t = composite_cotangents(num_tiles, 3, seed=11)
    g_img = torch.as_tensor(g_img, device=dev)
    gt_total = torch.as_tensor(g_t, device=dev).contiguous()
    d_packed, bwd_args, k2_err = check_k2(
        check, kern, fw_args, g_img, gt_total, "full width",
        tie=tie_mask(kern.n_contrib, plain.n_contrib, kern.final_t, plain.final_t))
    gid = b["gid"]
    n = N_GAUSS
    gid_sorted, perm = torch.sort(gid, stable=True)
    ct_sorted = d_packed[:6 + 3].index_select(1, perm).contiguous()
    live = int((gid < n).sum())
    k3_err = check_k3(check, ct_sorted, gid_sorted, n,
                      f"full width (view 0 gids, {live} live slots)",
                      tol_scale=float(ct_sorted.abs().max()))
    check_repeatable(check, fw_args, bwd_args, (ct_sorted, gid_sorted, n))
    # A profile of one short call can come back with no device record at
    # all (as [7]'s control saw); only such an empty profile is taken again,
    # up to three times, and each is printed.
    for attempt in range(3):
        _, _, k3_kernels = profile_device(lambda: segment_sum_cuda(ct_sorted, gid_sorted, n),
                                          top=None)
        print(f"[3] one K3 call under torch.profiler, profile {attempt + 1}: "
              f"{[(kernel_name(k), c) for k, _, c in k3_kernels]}")
        if k3_kernels:
            break
    check(len(k3_kernels) == 1 and k3_kernels[0][2] == 1 and "segment_sum" in k3_kernels[0][0],
          "one K3 wrapper call runs exactly one device kernel, its own")
    seg = segment_stats(gid_sorted, n)
    print(f"[3] view 0 segments: {seg['live_slots']} live slots over {seg['distinct_ids']} "
          f"distinct ids of {n}; slots per live id mean {seg['mean']:.4f}, p99 {seg['p99']:.0f}, "
          f"max {seg['max']:.0f}")
    unsorted = (d_packed[:6 + 3].contiguous(), torch.clamp(gid, max=n).to(torch.int64))

    # The JAX counts are of bench.py's raw arrays (activated opacity and
    # scales, flat colors); bin those the same way.
    means, scales, quats, opac, colors = bench._scene_trained(N_GAUSS,
                                                              np.random.default_rng(SCENE_SEED))
    with torch.no_grad():
        raw = [torch.as_tensor(x, device=dev) for x in (means, scales, quats, opac, colors)]
        prep_raw = preprocess(raw[0], raw[3], settings, scales=raw[1], quaternions=raw[2],
                              colors=raw[4])
        b_raw, _ = bin_and_gather(prep_raw, settings, CAPS.tile_cap, CAPS.dup_capacity)
    rec_rendered = int(b_raw["num_rendered"])
    rec_max_tile = int(b_raw["tile_count"].max())
    print(f"    bench.py's arrays, view 0: num_rendered {rec_rendered}, max_tile_count "
          f"{rec_max_tile}; JAX on a CPU {JAX_CPU_COUNTS}, JAX on a TPU v5e {JAX_TPU_RECORD}")
    check((rec_rendered, rec_max_tile) == JAX_CPU_COUNTS,
          "view 0 culled dup count and deepest tile equal the JAX package's on a CPU")
    del raw, prep_raw, b_raw

    # [4] serving: 8 views through render_adaptive + render_model.
    renders = 0

    def counted_render(*args, **kwargs):
        nonlocal renders
        renders += 1
        return render_model(*args, **kwargs)

    reset_launches()
    t0 = time.perf_counter()
    outs, view_caps = [], []
    for cam in cams:
        out, caps = adaptive.render_adaptive(counted_render, CAPS, model, cam)
        outs.append(out)
        view_caps.append(caps)
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    serve_counts = launches()
    print(f"[4] serving: {VIEWS} views, {renders} renders (incl. cap growth), launches "
          f"(K1, K2, K3, binning, preprocess) {serve_counts}, {slice_s:.2f} s wall")
    check(serve_counts == (renders, 0, 0, renders, renders, 0) and renders >= VIEWS,
          "one K1, one binning and one preprocess launch per render, no backward")
    # Whether a whole served view still waits on the host anywhere: printed,
    # not checked.
    torch.cuda.set_sync_debug_mode("error")
    try:
        render_model(model, cams[0], **caps_kw(view_caps[0]))
        sync = "no sync"
    except RuntimeError as e:
        sync = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[4] one served view (render_model, view 0) under set_sync_debug_mode('error'): {sync}")
    # The preprocess route's counter while a profiler collects: 1 a render.
    profiling.reset()
    with torch.profiler.profile():
        for cam, caps in zip(cams[:2], view_caps[:2]):
            render_model(model, cam, **caps_kw(caps))
    hits = [c["value"] for c in profiling.recorded()["counters"]
            if c["name"] == "raster.preprocess_kernel"]
    print(f"[4] raster.preprocess_kernel over two profiled served views: {hits}")
    check(hits == [1, 1], "served views: raster.preprocess_kernel counts one kernel hit a render")
    for i, (out, caps) in enumerate(zip(outs, view_caps)):
        ovf = adaptive.read_overflow(out)
        img, ft = out["image"], out["final_T"]
        finite = bool(torch.isfinite(img).all() and torch.isfinite(ft).all())
        covered = float((ft < 0.5).float().mean())
        print(f"    view {i}: {json.dumps(ovf)} caps k_max={caps.k_max} "
              f"tile_cap={caps.tile_cap} dup_capacity={caps.dup_capacity} "
              f"big_cap={caps.big_cap}; finite {finite}, covered {covered:.3f}, "
              f"image [{float(img.min()):.3f}, {float(img.max()):.3f}]")
        zero = all(ovf[k] == 0 for k in
                   ("bin_overflow", "big_overflow", "cap_overflow", "tile_overflow"))
        check(zero, f"view {i} overflow counters all 0")
        check(finite and tuple(img.shape) == (H, W, 3), f"view {i} image finite, {H}x{W}x3")
        check(0.03 < covered < 0.5 and float(img.min()) >= 0.0,
              f"view {i} blob covers part of the frame")
    bg = settings.bg
    plain_img = assemble_tiles(plain.img + plain.final_t[..., None] * bg, settings)
    kern_img = assemble_tiles(kern.img + kern.final_t[..., None] * bg, settings)
    db = float(psnr(outs[0]["image"], plain_img))
    print(f"    view 0 PSNR kernel render vs plain render: {db:.2f} dB")
    check(db >= MIN_PSNR_DB, f"kernel render within {MIN_PSNR_DB} dB PSNR of the plain render")
    check(bool(torch.equal(outs[0]["image"], kern_img)),
          "render_model's view 0 equals the kernel run on its inputs")
    del outs

    # [5] card against CPU; [6] fwd+bwd at full width; [7] training.
    phase_card_vs_cpu(check, dev)
    fb = phase_fwd_bwd(check, dev, rc.from_camera(cams[0], device=dev))
    tr = phase_train(check, dev, cams)

    # Timing (CUDA events), card and power limit beside each number.
    view_ms = []
    for cam, caps in zip(cams, view_caps):
        kw = dict(tile_cap=caps.tile_cap, dup_capacity=caps.dup_capacity,
                  k_max=caps.k_max, cap_a=caps.cap_a, big_cap=caps.big_cap)
        view_ms.append(cuda_ms(lambda: render_model(model, cam, **kw), reps=3))
    k1_ms = cuda_ms(lambda: tile_composite_cuda(*fw_args), reps=20, warmup=2)
    k1_plain_ms = cuda_ms(lambda: tile_composite_plain(*fw_args), reps=2)
    k1_bound = composite_bound(b["tile_start"], b["tile_count"], kern.nch, 3, fw_max_chunks)
    k2_ms = cuda_ms(lambda: tile_composite_bwd_cuda(*bwd_args), reps=10, warmup=2)
    k2_plain_ms = cuda_ms(lambda: tile_composite_bwd_plain(*bwd_args), reps=2)
    k2_bound = composite_bwd_bound(b["tile_start"], b["tile_count"], kern.nch, 3, fw_max_chunks,
                                   dup_data.shape[1])
    solo = deepest_alone(fw_args, kern.nch, bwd_args)
    k3_ms = cuda_ms(lambda: segment_sum_cuda(ct_sorted, gid_sorted, n), reps=20, warmup=2)
    k3_plain_ms = cuda_ms(lambda: segment_sum_plain(ct_sorted, gid_sorted, n), reps=5)
    k3_lib_ms = cuda_ms(lambda: torch.zeros((9, n + 1), device=dev).index_add_(
        1, unsorted[1], unsorted[0]), reps=5)
    ct_t = unsorted[0].T.contiguous()  # (D, 9): index_add_ along dim 0 adds whole rows
    k3_lib0_ms = cuda_ms(lambda: torch.zeros((n + 1, 9), device=dev).index_add_(
        0, unsorted[1], ct_t), reps=5)
    del ct_t
    parts = backward_parts(d_packed, gid, n, 6 + 3)
    k3_bound = segsum_bound(9, int((gid_sorted < n).sum()), n)
    print(f"[8] timing on {card}:")
    print(f"    render_model per view, median of {VIEWS} views: "
          f"{statistics.median(view_ms):.3f} ms (views: {', '.join(f'{v:.3f}' for v in view_ms)})")
    for name, ms, pms, bd, extra in (
        ("K1 tile_composite", k1_ms, k1_plain_ms, k1_bound, ""),
        ("K2 tile_composite_bwd", k2_ms, k2_plain_ms, k2_bound, ""),
        ("K3 segment_sum", k3_ms, k3_plain_ms, k3_bound,
         f"; index_add_ on the unsorted cotangent, dim 1 of (9, n+1) {k3_lib_ms:.4f} ms, "
         f"dim 0 of (n+1, 9) {k3_lib0_ms:.4f} ms"),
    ):
        print(f"    {name}, view 0: {ms:.4f} ms; plain version {pms:.3f} ms; bound "
              f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bytes']} bytes"
              + (f", {bd['ops']} fp32 ops, {bd['slot_evals']} alpha evaluations" if "ops" in bd
                 else "") + f"){extra}")
    for name, whole, alone in (("K1", k1_ms, solo["k1_ms"]), ("K2", k2_ms, solo["k2_ms"])):
        print(f"    {name} deepest tile alone (tile {solo['tile']}, nch {solo['nch']}, every other "
              f"tile_count 0): {alone:.4f} ms, {alone / whole:.3f} of the whole {whole:.4f} ms")
    for name, fn in (("K1", lambda: tile_composite_cuda(*fw_args)),
                     ("K2", lambda: tile_composite_bwd_cuda(*bwd_args)),
                     ("K3", lambda: segment_sum_cuda(ct_sorted, gid_sorted, n))):
        _, busy, ranked = profile_device(fn, top=None)
        print(f"    {name} wrapper call under torch.profiler, view 0: device busy {busy:.4f} ms: "
              + ", ".join(f"{kernel_name(k)} {ms:.4f} ms" for k, ms, _ in ranked))
    print("    GatherDup.backward, view 0 (16 x D cotangent, 9 live rows), device ms under "
          "torch.profiler: " + ", ".join(f"{k} {v[0]:.4f}" for k, v in parts.items()))
    for name, (_, ranked) in parts.items():
        print(f"      {name}: " + ", ".join(f"{kernel_name(k)[:60]} {ms:.4f} ms x{c}"
                                          for k, ms, c in ranked))
    print(f"    K3 inside the profiled train step: "
          + ", ".join(f"{ms:.4f} ms x{c}" for ms, c in tr["k3_in_step"]))
    print(f"    fwd+bwd, 1M trained scene, 512x512: {fb['ms']:.3f} ms "
          f"({fb['rays_per_s']:.0f} rays/s), mean of 5")
    print(f"    train step, 2^18 scene, 512x512: median {tr['step_ms']:.3f} ms of {TIMED_STEPS} "
          f"({', '.join(f'{v:.3f}' for v in tr['step_ms_all'])}); caps {tr['caps']}")
    print(f"    train step under torch.profiler: wall {tr['wall_ms']:.3f} ms, device busy "
          f"{tr['busy_ms']:.3f} ms, idle share {1.0 - tr['busy_ms'] / tr['wall_ms']:.3f} "
          f"(against the unprofiled median step, {1.0 - tr['busy_ms'] / tr['step_ms']:.3f})")
    for name, ms, calls in tr["top"]:
        print(f"      {ms:8.3f} ms  {calls:3d}x  {name[:100]}")
    kw0 = dict(tile_cap=view_caps[0].tile_cap, dup_capacity=view_caps[0].dup_capacity,
               k_max=view_caps[0].k_max, cap_a=view_caps[0].cap_a, big_cap=view_caps[0].big_cap)
    stages = stage_times(model, cams[0], kw0)
    print("    view 0 stages (host clock, synchronized, median of 5): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    wall_ms, busy_ms, _ = profile_device(lambda: render_model(model, cams[0], **kw0))
    print(f"    view 0 under torch.profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1.0 - busy_ms / wall_ms:.3f}")

    # [9] coarse SuGaR: KNN, the field query, train_coarse, the step timed.
    kn = phase_knn(check, dev, model)
    fq = phase_field(check, dev, model, kn.pop("serve_idx"))
    co = phase_coarse(check, dev, cams, tr["targets"])
    cs = time_coarse_step(check, dev, cams, tr["targets"], co)
    print(f"[9] coarse summary on {card}: KNN 2^18 {kn['ms_train']:.1f} ms, 1M "
          f"{kn['ms_serve']:.1f} ms; field query 1M x 16 fwd {fq['fwd_ms']:.3f} ms, bwd "
          f"{fq['bwd_ms']:.3f} ms, peak {fq['peak_gb']:.3f} GB; 'sdf' step median "
          f"{cs['step_ms']:.3f} ms, device busy {cs['busy_ms']:.3f} ms of {cs['wall_ms']:.3f} ms "
          f"profiled (idle share {1.0 - cs['busy_ms'] / cs['wall_ms']:.3f}), peak "
          f"{cs['peak_gb']:.3f} GB; train_coarse window {co['wall_s']:.2f} s, resume "
          f"{co['resume_s']:.2f} s")

    # [10] coarse mesh extraction on the model [9] ends with; [11]
    # refinement on its mesh against [7]'s ring images.
    phase_levelset_card_vs_cpu(check, dev)
    ex = phase_extract(check, dev, co["model"], cams)
    phase_refine_card_vs_cpu(check, dev)
    rf = phase_refine(check, dev, ex, cams, tr["targets"], co["extent"])
    ls_ms = [c["whole"] for c in ex["cam_ms"]]
    print(f"[11] mesh + refine summary on {card}: level set per camera median "
          f"{statistics.median(ls_ms):.1f} ms device (KNN median "
          f"{statistics.median(c['KNN'] for c in ex['cam_ms']):.1f} ms); extraction "
          f"{ex['wall_s']:.2f} s wall; mesh {len(ex['verts'])} vertices, {len(ex['faces'])} faces; "
          f"refine step median {rf['step_ms']:.3f} ms, device busy {rf['busy_ms']:.3f} ms of "
          f"{rf['wall_ms']:.3f} ms profiled (idle share {1.0 - rf['busy_ms'] / rf['wall_ms']:.3f}), "
          f"peak {rf['peak_gb']:.3f} GB; refine window {rf['wall_s']:.2f} s, resume "
          f"{rf['resume_s']:.2f} s; launches (K1, K2, K3, binning, preprocess, preprocess bwd) training [7] {tr['launches']}, "
          f"mesh "
          f"[10] {ex['launches']}, refine [11] {rf['launches']}")

    # [12] the texture bake of [11]'s refined model; [13] the pipeline end
    # to end on the parity scene, and LPIPS.
    refined_params, refined_bm = rf.pop("params"), rf.pop("bm")
    tx = phase_texture(check, dev, refined_params, refined_bm, cams)
    phase_mesh_raster_card_vs_cpu(check, dev)
    pl = phase_pipeline(check, dev)
    phase_lpips(check, dev)
    r = tx["rows"]
    print(f"[13] bake + pipeline summary on {card}: bake {tx['wall_s']:.2f} s wall, per camera "
          f"render_bound median {statistics.median(x['render_ms'] for x in r):.2f} ms, "
          f"rasterize_mesh median {statistics.median(x['raster_ms'] for x in r):.2f} ms, "
          f"accumulation median {statistics.median(x['acc_ms'] for x in r):.1f} ms host; pipeline "
          f"stages "
          + ", ".join(f"{k} {v:.2f} s" for k, v in pl["walls"].items())
          + "; PSNR " + ", ".join(f"{k} {v[0]:.3f}" for k, v in pl["scores"].items())
          + f" dB; launches (K1, K2, K3, binning, preprocess, preprocess bwd) bake [12] {tx['launches']}, pipeline [13] "
          f"{pl['launches']}")

    # [14] the two-pass path at full width and the tiled mode; the oracle
    # triangle; the compositor demo on [11]'s refined model; the entry
    # points on [13]'s scene and artifacts.
    t14 = time.perf_counter()
    tp = phase_twopass(check, dev, model, cams, view_caps, card)
    oc = phase_oracle_triangle(check, dev)
    cp = phase_compositor(check, dev, refined_params, refined_bm, card)
    ep = phase_entry_points(check, dev, pl.pop("scene"), pl.pop("artifacts"))
    shutil.rmtree(WORK, ignore_errors=True)
    launches14 = tuple(sum(c) for c in zip(tp["launches"], oc["launches"], ep["launches"]))
    errs14 = {k: max(e.get(k, 0.0) for e in (tp["errs"], oc["errs"], ep["errs"]))
              for k in ("K1", "K2", "K3")}
    print(f"[14] summary on {card}: {time.perf_counter() - t14:.1f} s; two-pass ms per view "
          f"median {statistics.median(tp['view_ms']['pallas_twopass']):.3f} (fused "
          f"{statistics.median(tp['view_ms']['pallas']):.3f}), fwd+bwd "
          f"{tp['fb_ms']['pallas_twopass']:.3f} ms (fused {tp['fb_ms']['pallas']:.3f}), peak "
          f"{tp['peak_gb']:.3f} GB; tiled forward {tp['tiled_ms']:.1f} ms; launches (K1, K2, K3, "
          f"binning) "
          f"two-pass {tp['launches']}, oracle scene {oc['launches']}, entry points "
          f"{ep['launches']}, all {launches14}; kernels vs plain {json.dumps(errs14)}; largest "
          f"differences: " + json.dumps(dict(
              {k: v for k, v in tp["errs"].items() if not k.startswith("K")},
              **{k: v for k, v in oc["errs"].items() if not k.startswith("K")},
              composite=cp["err"]))
          + f"; demo {cp['wall_s']:.2f} s, {cp['overflowed']} of {len(cp['calls'])} frames past "
          f"k_max; entry points " + ", ".join(f"{k} {v:.2f} s" for k, v in ep["walls"].items()))

    # [15] the multi-device paths: ranks sharing the card (gloo), NCCL, the
    # sharded level set and the pipeline with devices=4.
    pr = phase_parallel(check, dev, card, view_caps, tr["targets"], co, ex)
    shutil.rmtree(WORK, ignore_errors=True)

    # [16] the measurement entry points: the bench, the profiles, the
    # microbenches.
    tl = phase_tools(check, card)

    # [17] more colour channels than the kernels' instantiations; the
    # bench-scale section of scaling_report at 2 ranks.
    wc = phase_channels(check, dev, model, cams[0], view_caps[0], card)

    # [18] the pipeline as the CLI builds it, at width, from a COLMAP scene
    # on disk; the stage entry points on its artifacts.
    pw = phase_pipeline_width(check, dev, card)

    # [19] the parity protocol at its full configuration's widths, cut in
    # depth; the loaders and entry points no other phase drives.
    pp = phase_parity_width(check, dev, card, pw["textured"])
    shutil.rmtree(WORK, ignore_errors=True)

    k1n, k2n, k3n, binn, pren, prebn = (sum(c) for c in zip(tr["launches"], ex["launches"], rf["launches"],
                                               tx["launches"], pl["launches"], launches14,
                                               pr["launches"], tl["launches"], wc["launches"],
                                               pw["launches"], pp["launches"]))
    # max_abs_err: the largest over the comparisons at the paths' shapes
    # ([3] view 0 of the 1M scene, [10] the depth render, [11] a refine
    # step, [12] the bake's render, [13] each pipeline stage's last
    # launches, [14] the two-pass fwd+bwd at view 0 of the 1M scene, the
    # oracle scene's last two-pass render, the last launches of
    # scripts.render and train_vanilla_gs, [15] each rank's band of the
    # tile-sharded fwd+bwd and train step, [16] the bench's last fwd+bwd,
    # [17] view 0 at C = 3, 8 and 13, [18] and [19] each stage's and entry
    # point's last launches).
    later = (pr["errs"], tl["errs"], wc["errs"], pw["errs"], pp["errs"])
    (bin_row,) = [r for r in bn["rows"] if r["label"].startswith("vanilla_7k")]
    (pre_row,) = [r for r in pre["rows"] if r["label"].startswith("vanilla_7k")]
    (pre_bwd_row,) = [r for r in pre["bwd_rows"] if r["label"].startswith("vanilla_7k")]
    k1_err = max(k1_err, ex["k1_err"], rf["errs"]["K1"], tx["k1_err"], pl["errs"]["K1"],
                 errs14["K1"], *(e.get("K1", 0.0) for e in later))
    k2_err = max(k2_err, rf["errs"]["K2"], pl["errs"]["K2"], errs14["K2"],
                 *(e.get("K2", 0.0) for e in later))
    k3_err = max(k3_err, rf["errs"]["K3"], pl["errs"]["K3"], errs14["K3"],
                 *(e.get("K3", 0.0) for e in later))
    kernels = [
        dict(name="tile_composite_fwd", route="cuda",
             source="sugar_tpu_torch/csrc/tile_composite.cu",
             replaces="sugar_tpu/raster/pallas_composite.py:185", launches=k1n,
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound["bound_ms"],
             bound_by=k1_bound["bound_by"], library_ms=None),
        dict(name="tile_composite_bwd", route="cuda",
             source="sugar_tpu_torch/csrc/tile_composite_bwd.cu",
             replaces="sugar_tpu/raster/pallas_composite.py:273", launches=k2n,
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound["bound_ms"],
             bound_by=k2_bound["bound_by"], library_ms=None),
        dict(name="segment_sum", route="cuda", source="sugar_tpu_torch/csrc/segsum.cu",
             replaces="sugar_tpu/raster/segsum.py:47", launches=k3n,
             max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound["bound_ms"],
             bound_by=k3_bound["bound_by"], library_ms=min(k3_lib_ms, k3_lib0_ms)),
        # [2b]'s vanilla_7k view: the whole bin_fused call, its plain version,
        # the bytes bound, and torch.sort of the kept [tile | rank] keys as
        # the library yardstick.
        dict(name="binning", route="cuda", source="sugar_tpu_torch/csrc/binning.cu",
             replaces="sugar_tpu/raster/fused.py:228", launches=binn,
             max_abs_err=bn["max_abs_err"], ms=bin_row["ms"], plain_ms=bin_row["plain_ms"],
             bound_ms=bin_row["bound_ms"], bound_by="bytes",
             library_ms=bin_row["sort_kept_keys_ms"]),
        # [2c]'s vanilla_7k view: the kernel alone, its plain version (the
        # activations and preprocess in torch ops), the bytes bound.
        dict(name="preprocess", route="cuda", source="sugar_tpu_torch/csrc/preprocess.cu",
             replaces=None, launches=pren, max_abs_err=pre["max_abs_err"], ms=pre_row["ms"],
             plain_ms=pre_row["plain_ms"], bound_ms=pre_row["bound_ms"], bound_by="bytes",
             library_ms=None),
        # [2c]'s vanilla_7k view: the backward kernel alone, its plain
        # version (the autograd VJP of the torch ops), the bytes bound;
        # max_abs_err the largest gap over max|g| of a field.
        dict(name="preprocess_bwd", route="cuda", source="sugar_tpu_torch/csrc/preprocess.cu",
             replaces=None, launches=prebn, max_abs_err=pre["bwd_max_err"],
             ms=pre_bwd_row["ms"], plain_ms=pre_bwd_row["plain_ms"],
             bound_ms=pre_bwd_row["bound_ms"], bound_by="bytes", library_ms=None),
    ]
    if check.failures:
        print(f"chip_smoke: {len(check.failures)} check(s) failed: {check.failures}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
