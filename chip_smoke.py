#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA Hopper card.

    python3 chip_smoke.py [--profile | --kernels-only | --refine-only |
                           --distributed-only] [--residual-parent <residual.cu>]
                          [--distcg-parent <distcg.cu>] [--system-parent <distcg.cu>]
                          [--gram-parent <gn.cu>] [--fals-parent <preprocess.cu>]
                          [--energy-parent <energy.cu>] [--cull-parent <cull.cu>]
                          [--led-parent <normaleq.cu>]
                          [--distreg-parent <distreg.cu>]

Builds the package's CUDA kernels and its host C++ libraries (PNG unfilter,
marching cubes and PLY writers) from csrc/, holds each kernel against its
plain PyTorch version on the card, drives a whole recipe (track -> culled
fuse -> keyframes -> initial export -> photometric refinement of distance,
albedo, poses and light -> refined export) through ReconstructionPipeline.run
at the reference's operating point (640x480 frames into a 128^3 grid, 40
keyframes, the SH1 weights of configs/sokrates.json) on a synthetic handheld
sequence of a shaded scene made with numpy from a fixed seed, and checks the
result.  Then: the scan again on the staged and the plain row movement; the
scan on a device mesh of four Z-slabs, all on the one card (GT poses against
the one-device volume bit for bit, tracked with contiguous and interleaved
slabs, and the whole sequence on two slabs); the packed, K-batched and
chunk-resident volume state (core/volume.PackedVolume, fuse_frames_culled,
core/resident.py: a tracked loop on the packed state against the SoA one,
K = 8 batched ground-truth fusion against frame-by-frame, 512^3 on all three
layouts, and the resident stream against the packed one, bit for bit, with
their ms a frame and the row kernels at the packed widths); the sequence written as a TUM
RGB-D directory of PNG files (the package's encoder, io/png.write_png),
decoded and scanned from the files; a scan stopped at a checkpoint and
resumed; one refinement iteration on the card against the same iteration on
the CPU, which this script asks for by name, with the light block step by
step; the LED model with the iteration-5 upsample at a smaller depth (64^3
-> 128^3, 8 keyframes at their generating poses); the command line on the PNG directory with checkpoints
and --retries, with one failure injected in refinement iteration 3; the
refinement on a 4x2 device mesh of the one card (the main run's keyframes,
and the LED upsample run) against the one-device refinements, and the
command line's whole recipe from the PNG files on a 2x2 mesh; that recipe
and the LED upsample run again with one process a mesh row
(parallel/distributed.py: two processes of this script over gloo on the one
card, and over NCCL where there are two cards) against those one-process
runs, and that recipe stopped at a scan checkpoint, failed in the
refinement and resumed from its checkpoints in three launches of the
processes; and the host's marching cubes (C++ against numpy) at 128^3 and 256^3, with a periodic
refinement dump synchronous and on its writer thread.

Every phase prints one JSON object on a line of its own.  Any failed check,
build error or exception ends the run with a non-zero exit code; there is no
CPU path.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}.

With --profile more phases trace a short scan, and two warm refinement
iterations, with torch.profiler and print the card's busy share of each and
the kernels that take the most device time, and trace each block of the
main refinement's iteration 0 (its one-time costs) on the host and the
card.  The run is otherwise the same (its refinement seconds then include
the tracing of iteration 0).  Every traced session opens with a warm-up of
throwaway kernels that takes the device records the profiler drops at a
session's start on the card machine, and fails if it lost them all
(_traced, through utils/profiling.py, which the command line's --profile
uses too); the command line's own --profile trace of a short scan must hold
some of that warm-up and every gn_solve launch (profile_cli).

Phase scan_kernels follows the kernels phase: the kernels of the scan's
jit-fused programs (the fusion update, one launch a fused frame; a frame's
whole Gauss-Newton solve, one cooperative launch a frame, its records on
chip or, for a 1280x960 frame, in device memory; the Gram alone of the mesh
trackers) against their plain versions on the real rows and frames of the
sequence, and 48 frames tracked under each named tracker configuration
(the Gram also twice bit for bit and beside an empty launch of its grid and
clusters; with --gram-parent <gn.cu> timed in turns with that earlier
source); the scan phase then checks that every tracked frame and every
update of the main run went through them.  It also holds the culled
fusion's cull and compaction (csrc/cull.cu: ONE cooperative launch of
cull_compact for both, and for a K-frame union) against their plain version
bit for bit (the mask, the indices under both padding contracts, n_active,
live and overflow, two launches bit for bit) on 78 cases (every frame, a
1280x960 frame, 512^3, segments, slabs, the resident margins, a False
gate, no valid and NaN depths, the grid behind the camera and around it,
capacities at and below the active count, the unions of 1 to 8 frames in
one launch, resident_alloc's allow, capacity 0), and times it in the path's
order beside empty launches crossing two grid barriers and one; with
--cull-parent <cull.cu> (PR 21-25's source: a cull launch a frame, then a
compaction) that pair is held bit for bit against it and timed in turns
with it.  Every scan phase then counts one cull_compact launch a culled
fusion (a slab each on a mesh, one a K-frame batch) and no plain cull on
the card.

The refinement's two kernels (the residual pass and the distance block's
Jacobian, csrc/residual.cu) are held the same way: phases refine and
refine_led_upsample check that every residual pass and every distance
block of those runs went through them, and phase refine_kernels (after
refine_led_upsample) holds both against their plain versions bit for bit
on the main run's problem (SH1 and SH2), the LED run's, a keyframe moved
past the surface and one turned off the image, and 34 keyframes of
1709x1139, under every robust loss, with their times, and on the tiles'
edges (one keyframe, an odd count, keyframes past a tile's pairs on few
and on many voxels, one voxel and one past each kernel's tile of voxels); it
records the tile plans and the blocks an SM holds, and times the pass on
small images; with --residual-parent <residual.cu> it also times the main
case on that earlier source of the same C interface, in turns with this
one.  In mesh_refine the 4x2 mesh's first residual pass is held against one
device's, bit for bit, and the albedo block replays the main run's accept
decisions.

The distance block's two kernels (its assembled rows and its whole CG,
csrc/distcg.cu) are held the same way: phases refine and
refine_led_upsample check that every distance block of those runs launched
each once and ran no plain distance solve on the card, and phase
dist_cg_kernels holds the rows bit for bit and the CG against the plain
solve (its steps, delta within DIST_CG_TOL) on the main run's and the LED
run's final problems under both stop rules and on the edges (one row, a row
whose neighbours are all frozen, copies of the main system in each layout
of the CG's host plan, no valid row), times both, and traces one distance
block through them, which must run no index_add_ kernel; with
--distcg-parent <distcg.cu> it also times the CG of the main and LED cases
on that earlier source (the C interface before the host plan), in turns
with this one.  It also holds the rows bit for bit at each edge of
dist_system's lanes rule, at one keyframe, on eight copies of the main
block and on a ragged last tile, each bulk-copied and (an input off a
16-byte boundary) with the lanes' loads; with --system-parent <distcg.cu> it
times the rows of the main and LED cases on that earlier source (the one
before the lanes rule) in turns with this one.

The pose and the SH light normal equations (csrc/normaleq.cu) are held the
same way: phases refine and refine_led_upsample check that every pose block
and every SH light block of those runs called its kernels once and ran no
plain normal equations on the card, and phase normal_eq_kernels holds both
against their plain versions (H within NORMAL_EQ_TOL of each keyframe's
max|H|, g within it of each keyframe's sum of |w r J|, two runs bit for
bit) on the main run's problem (SH1, and SH2 lights), the LED run's pose and
the edges (one and 33 keyframes, one voxel, the tile plus one, a masked
keyframe, no counted pair; 8 keyframes at one voxel and at the tile plus
one, 33 keyframes from an unaligned row slice, 257 keyframes in two
chunks) and three calls back to back, with their times; with --profile
each traced pose or SH light block launches one kernel.

The albedo block's kernel (its system formed per pair from bulk-copied
stages, then its whole CG with the accept rule, in one cooperative launch,
csrc/albedo.cu) is held the same way: phases refine and
refine_led_upsample check that every albedo block of those runs launched
it once and ran no plain albedo solve on the card, and phase albedo_kernels
holds its system (written out for the check) bit for bit and its CG
against the plain solve (its steps, delta within ALBEDO_CG_TOL, the new
albedo equal to update_albedo on the kernel's delta bit for bit, the grid
barriers it crossed) on the main run's final block (both stop rules), with
SH2 lights, on the LED run's block, with the regularizer on (both rules)
and on the edges (one row, a row cut from its neighbours, no valid row,
four copies of the main system, one keyframe, 33 keyframes and a partial
last stage, a partial last stage at 40, the first row count past the
shared-memory tile), times it, and traces one albedo block, which must
launch exactly the one kernel, no index_add_ and no device-to-host copy.

The scan's preprocessing (csrc/preprocess.cu: the FALS normals and the
LAPM sharpness, one launch each a chunk) and the refinement's four energies
(csrc/energy.cu, one launch an evaluation) are held the same way: every
scan and refinement phase counts two preprocessing launches a chunk (and a
normals launch for each frame fused outside a chunk) and one energy_sums
launch an energy evaluation (a block each on a mesh, on each process), and
no plain chain on the card; phase preprocess_kernels (after scan_kernels)
holds the normals bit for bit and LAPM within LAPM_TOL on every chunk of
the sequence, one frame, 1280x960 frames, all-zero and sparse depth and
each window, and phase energy_kernels (after albedo_kernels) holds the
energies within ENERGY_TOL on the main and the LED problems under every
loss, the mesh's two kinds of call, one row and no valid row, each kernel
twice bit for bit, with their times in the path's order; with --profile
the traced scan runs no box filter's reflect pad and the traced
iterations one energy_sums kernel an evaluation.  Both kernels are
persistent grids, and the phases hold their edges too: the
normals on 1, 3 and 9 frames, on 17x45 and 481x641 images (partial edge
tiles) and at every window on the latter; the energies on 33 keyframes of
1001 rows (pairs not a multiple of the vector width), on that problem's
rows 1: as views (r and the mask off their vector boundary: the same bits
as on an aligned copy) with all terms, PS alone and the rows alone, and on
one block's worth of pairs; energy_kernels also times the kernel with the
PS sum alone, the rows alone and its grid cut to 132 blocks and to 1.
With --fals-parent <preprocess.cu> / --energy-parent <energy.cu> (an
earlier source of the same C interface, or a prefix of it) each kernel is
also timed in turns with that build in the path's order, and the earlier
energy kernel is timed with the same cuts; --fals-parent times the
earlier LAPM too (on its own grid), after each build's normals.  LAPM (a
ring of row spans bulk-copied into shared memory, each row's x passes
once) is also held bit for bit on copies whose bases lie 4, 8 and 12 bytes
off a 16-byte boundary against an aligned copy, on the RGB chunk, a grey
chunk, one frame, nine frames and 1280x960 frames, and timed beside an
empty launch of its grid in its place in the path.

The distance block's tail (its regularizer operators and its update) and
the LED light's normal equations (csrc/normaleq.cu light_led_kernel, one
launch a block) are held the same way. On one card a distance block is
three launches: dist_jacobian, dist_system with the regularizer stage
(ops/distcg.dist_system_reg) and dist_cg with the update stage
(dist_cg_update), through refine/solvers.distance_step; the standalone
kernels of csrc/distreg.cu (one launch each) serve the joint block and the
mesh. Every refinement phase counts one fused distance step a one-card
distance block and no standalone launch there, one operators launch and one
update launch a joint block and, on a mesh, a distance or joint block (a
row each, on each process), one LED light launch a block (a block each on a
mesh), and no plain chain on the card; dist_cg_kernels' traced warm
distance block makes exactly three launches. Phase dist_tail_kernels (after
energy_kernels) holds the fused stages bit for bit against the plain chains
(dist_system's A, t and lap_r against reg_operators_plain then
dist_system_plain, bulk-copied and with the lanes' loads: main SH1 with the
Eikonal operator alone, LED with both operators and with the Laplacian's
diagonal alone, one row, no valid row, a row whose every neighbour is
frozen; dist_cg's delta and steps against the unfused dist_cg on the same A
and t and its new_dist and new_grad against dist_update_plain on that
delta, on those cases and in every plan layout; each twice bit for bit),
times both fused kernels in the distance block's order beside their bounds
and the update barrier's empty-launch floor, and with --distreg-parent
<distreg.cu> (an earlier source; its distcg.cu and the headers beside it,
e.g. 517c0dd's csrc/ unpacked into archive_check/) times the whole distance
block in turns: the three launches against the five of that build
(dist_jacobian, reg_operators, dist_system, dist_cg, dist_update). It also
holds the standalone operators and update bit for bit on the main and the
LED problems and their edges (one row, no valid row, frozen neighbours,
every step refused or accepted, steps at the threshold and one ulp either
side, the gradient alone) and the LED light within NORMAL_EQ_TOL before and
after the upsample, on one keyframe, one row and no counted pair, and on
its plan's edges (F = 1, 33 and 40 keyframes, one row of 33, row slices and
copies of w and r off a 16-byte boundary bit for bit against aligned
copies, the mesh_refine (b) block), each kernel twice bit for bit, with
their times in the path's order beside an empty launch (the LED light's: of
its own grid) and the LED light's beside one einsum forming H and g; with
--led-parent <normaleq.cu> (an earlier source whose LightLedArgs is a
prefix of this one's) the LED light is timed in turns with that build; with
--profile profile_refine_led also traces two warm LED iterations.

On one card the scan's chunks run in the static buffers of a rotation
(tracking/graph.py) and a full chunk as one replayed CUDA graph, so every
scan phase on one card drives the graph, its launch counts kept by the
replays' arithmetic.  Phase scan_graph (after refine) holds the graphed scan
against capture=False bit for bit (the volume's tables, tracking_poses.txt,
every frame's converged flag, iterations, energy and pixel count, the
keyframes, their poses and device images) under each named tracker
configuration and with ground-truth poses (no tracker), with a capacity under the active rows (a redo and new
captures) and a ragged last chunk, and a graphed scan resumed from a scan
checkpoint against the whole graphed scan; checks the scan phase's launch
counts on the graphed runs and the captures and replays the rotation made;
holds fuse_rows with the frame id read on the device (the visibility word
picked by the kernel) against its plain version and the host bit on frame
24's rows, bit for bit, and times both forms in turns; times the smoke scan's
frames/s graphed and eager in turns (best of GRAPH_TURNS), and two
steady-state chunks (replays) of a chunk runner untraced in turns and
traced: runtime calls a chunk, device ops a frame, device time and busy
share, graphed and eager.  With --scan-graph-only the run builds the
kernels, runs that phase alone and exits with 3.

With --kernels-only the run stops after the kernels and scan_kernels phases
(and preprocess_kernels; build, checks and times of the kernels): a quick
look at a changed kernel.
It drives no path, so it prints no final "ok" line and exits with 3.
With --refine-only it runs the main run and phases refine,
refine_led_upsample, refine_kernels, dist_cg_kernels, normal_eq_kernels,
albedo_kernels, energy_kernels and dist_tail_kernels only (with --profile
also the refinement's traces), and exits with 3 the
same way:
the quick look at the refinement's kernels.
With --distributed-only it runs those phases, then phase `distributed`
and the one-process runs it is held to, and exits with 3 the same way: on a
machine of several cards the look at NCCL across cards.

Imports numpy, torch and the package; needs g++ and nvcc, no image library
and no network.
"""

import builtins
import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20240611
W, H = 640, 480
GRID = 128
VOXEL = 1.8 / GRID                  # the 128^3 grid spans 1.8 m
FRAMES = 48                         # frame 0 places the volume, 47 are tracked
CHUNK = 8
DEPTH_UNIT = 1.0 / 5000.0           # uint16 depth wire format, as TUM RGB-D
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
KERNEL_REPS = 20
DEVICE = "cuda"                     # a rehearsal of the phases sets "cpu"

# packed: the K of the batched ground-truth fusion; the 512^3 grid and its
# frames; the resident stream's frames (chunks of CHUNK), its admission
# margins (pixels of reprojection, metres of depth: the inter-frame motion of
# the orbit) and the ATE it may differ from the canonical tracked stream by
PACKED_K = 8
PACKED_BIG_GRID = 512
PACKED_BIG_FRAMES = 8
RESIDENT_FRAMES = 2 * CHUNK + 1
RESIDENT_MARGIN = (16.0, 0.05)
RESIDENT_ATE_MM = 0.01

# the refinement of the main run: SH1 with the weights of
# configs/sokrates.json, the iteration budget cut from 100 to fit the run
REFINE_SH1 = {
    "model type": "SH1", "loss function": "cauchy", "reg albedo": 0.0,
    "reg norm": 10.0, "reg laplacian": 0.0, "max iter": 8, "damping": 1.0,
    "converge threshold": 5e-3, "lambda": 0.2, "upsample": False,
    "--light": True, "--albedo": True, "--distance": True, "--pose": True,
}
# the LED run: the weights of configs/basket_led.json; 7 iterations, so the
# iteration-5 upsample and one iteration after it run, and a threshold no
# iteration can meet, so the loop does not stop before them
REFINE_LED = dict(REFINE_SH1, **{
    "model type": "LED", "reg norm": 0.1, "reg laplacian": 5.0, "max iter": 7,
    "damping": 3.0, "converge threshold": 1e-9, "upsample": True})
LED_GRID = 64
LED_FRAMES = 8
LED_STEP = 6                        # every 6th pose of the orbit: parallax
SH1_LIGHT = np.array([0.25, 0.15, -0.10, -0.65])   # on [1, nx, ny, nz]
LED_LIGHT = np.array([1.2, 1.2, 1.2])
PARITY_KEYFRAMES = 8
# mesh_scan: Z-slabs of the 128^3 grid, all on the one card, and the ATE a
# tracked mesh scan may differ from the one-device scan of the same frames by
# (the shards' Gram sums run in another order)
MESH_SLABS = 4
MESH_ATE_MM = 0.05
# mesh_refine: the refinement on a 4x2 mesh of the one card (8 blocks), held
# against the one-device refinement of the same inputs with PARITY_TOL; and
# the command line's whole recipe from files on a 2x2 mesh
MESH_REFINE = {"z": 4, "frames": 2}
MESH_CLI = (2, 2)
# distributed: the same recipes with one process a mesh row, over gloo on one
# card (over NCCL too, one card a process, where there are DIST_WORLD
# cards), held against mesh_refine's one-process runs; the LED upsample run
# on DIST_LED_MESH.  A collective waits at most DIST_TIMEOUT seconds, a
# process at most DIST_RANK_SECONDS
DIST_WORLD = 2
DIST_LED_MESH = {"z": 2, "frames": 1}
DIST_TIMEOUT = 60
DIST_RANK_SECONDS = 600
# card against CPU, relative (see refine_parity): the updated state, and the
# energies.  Seen on an H100: lights 5.8e-4, dist 8.0e-5, PS energy 3.3e-5.
PARITY_TOL = {"state": 2e-3, "energy": 5e-4}
MIN_PS_DROP = 0.5                   # PS energy after / before, see check_refine
# resume_refine: the refinement iteration that fails once (0-based); with a
# checkpoint every 2 iterations the retry resumes at iteration 2
FAIL_ITERATION = 3

KERNELS = {
    # wrapper in ops/rowcopy.py: the TPU kernel it replaces (file:line of the
    # pallas_call)
    "gather_rows_dma": "psgradientsdf_tpu/ops/rowcopy.py:198",
    "scatter_rows_dma": "psgradientsdf_tpu/ops/rowcopy.py:257",
    "gather_rows": "psgradientsdf_tpu/ops/rowcopy.py:104",
    "scatter_rows": "psgradientsdf_tpu/ops/rowcopy.py:142",
}
SOURCE = "psgradientsdf_tpu_torch/csrc/rowcopy.cu"
# the kernels of the scan's two jit-fused programs: wrapper -> (its source,
# the JAX function it replaces, by file:line)
SCAN_KERNELS = {
    "gn_solve": ("psgradientsdf_tpu_torch/csrc/gn.cu",
                 "psgradientsdf_tpu/tracking/tracker.py:76"),
    "gn_gram": ("psgradientsdf_tpu_torch/csrc/gn.cu",
                "psgradientsdf_tpu/tracking/tracker.py:286"),
    "fuse_rows": ("psgradientsdf_tpu_torch/csrc/fuse.cu",
                  "psgradientsdf_tpu/core/volume.py:104"),
    "cull_compact": ("psgradientsdf_tpu_torch/csrc/cull.cu",
                     "psgradientsdf_tpu/core/volume.py:252"),
}
# the culled fusion's cull and compaction in one launch (ops/cull.py): the
# kernel whose launches every culled fusion path counts beside the direct
# row copies'
CULL_KERNELS = ("cull_compact",)
# scan_kernels: the spin that keeps the card busy while the host enqueues a
# path's kernels, so that events between them time the device alone
SPIN_CYCLES = 2_000_000
# scan_kernels: one GN step's S against the plain Gram, relative to max|S|;
# the tracked poses, kernel against plain (metres and radians); a plain step
# norm this close to the threshold (relative) may end the solve one step
# apart
GN_S_TOL = 1e-5
GN_POSE_TOL = 1e-5
GN_EDGE = 0.01
# the kernels of the refinement's two jit-fused programs: wrapper -> (its
# source, the JAX function it replaces, by file:line)
REFINE_KERNELS = {
    "residual_pass": ("psgradientsdf_tpu_torch/csrc/residual.cu",
                      "psgradientsdf_tpu/refine/render.py:127"),
    "dist_jacobian": ("psgradientsdf_tpu_torch/csrc/residual.cu",
                      "psgradientsdf_tpu/refine/jacobians.py:193"),
}
# refine_kernels: the megapixel case (sokrates' image size, its keyframe
# count), and the robust losses by their configuration names
MEGA_W, MEGA_H, MEGA_F = 1709, 1139, 34
LOSS_NAMES = ("l2", "cauchy", "huber", "tukey", "trunc_l2")
# refine_kernels: the tile edges: keyframes past a frame-range tile's P (the
# main run's keyframes repeated), an odd keyframe count, the rows of the
# frame-range cases (from the middle of the surface set): a few, whose tiles
# a block takes one each, and more than the grid's blocks take in one turn
EDGE_RANGE_EXTRA = 37
EDGE_ODD_F = 33
EDGE_RANGE_ROWS = (3, 1000)
# refine_kernels: the keyframe images cut to this size, whose patches stay
# in the L1 cache (the residual pass's time without most of its pixel
# traffic); --residual-parent <path> times an earlier residual.cu of the same
# C interface against this one
SMALL_IMAGES = (64, 48)
# mesh_refine (a): the one-device run's albedo decisions are replayed on the
# mesh; a decision that differs must have its candidate within ALBEDO_EDGE
# of 0 or 1 on both runs, and at most ALBEDO_SHARE of a block's surface
# voxel-channels may differ
ALBEDO_EDGE = 1e-4
ALBEDO_SHARE = 1e-4
# the distance block's solve (csrc/distcg.cu): wrapper -> (its source, the
# JAX function it replaces, by file:line)
DIST_KERNELS = {
    "dist_system": ("psgradientsdf_tpu_torch/csrc/distcg.cu",
                    "psgradientsdf_tpu/refine/solvers.py:207"),
    "dist_cg": ("psgradientsdf_tpu_torch/csrc/distcg.cu",
                "psgradientsdf_tpu/refine/solvers.py:265"),
}
# dist_cg_kernels: the kernel's delta against the plain solve's, relative to
# max|delta| (a float32 CG whose dots the kernel sums in another order than
# torch.sum: the tolerance the CPU tests hold the port's CG to the JAX
# package's by); a plain r.r this close to the threshold (relative) may end
# the solve one step apart
DIST_CG_TOL = 2e-4
DIST_CG_EDGE = 0.01
# the refinement's pose and light normal equations (csrc/normaleq.cu):
# wrapper -> (its source, the JAX function it replaces, by file:line)
NORMAL_EQ_KERNELS = {
    "pose_normal_eqs": ("psgradientsdf_tpu_torch/csrc/normaleq.cu",
                        "psgradientsdf_tpu/refine/optimizer.py:208"),
    "light_normal_eqs_sh": ("psgradientsdf_tpu_torch/csrc/normaleq.cu",
                            "psgradientsdf_tpu/refine/solvers.py:512"),
}
# normal_eq_kernels: the kernels' H within NORMAL_EQ_TOL of each keyframe's
# max|H| of the plain version's, g within NORMAL_EQ_TOL of each keyframe's
# sum of |w r J| (the plain versions sum in float32 in cuBLAS's order, the
# kernels in short float runs, then in double)
NORMAL_EQ_TOL = 1e-5
# the albedo block in one launch (csrc/albedo.cu): wrapper -> (its source,
# the JAX function it replaces, by file:line)
ALBEDO_KERNELS = {
    "albedo_block": ("psgradientsdf_tpu_torch/csrc/albedo.cu",
                     "psgradientsdf_tpu/refine/solvers.py:424"),
}
# albedo_kernels: the kernel's delta against the plain solve's, relative to
# max|delta| (the tolerance the CPU tests hold the port's albedo solve to
# the JAX package's by); a plain r.r this close to the threshold (relative)
# may end the solve one step apart; the regularizer's weight of the cases
# that turn it on (both recipes set reg albedo 0)
ALBEDO_CG_TOL = 2e-4
ALBEDO_CG_EDGE = 0.01
ALBEDO_REG = 0.05
# albedo_kernels: keyframes enough that no stage a warp fits its shared
# memory (the main block's repeated), so the kernel reads the pairs unstaged
ALBEDO_UNSTAGED_F = 160
# normal_eq_kernels: the edge past one keyframe chunk (csrc/normaleq.cu cuts
# F above 256 into chunks), on this many of the main problem's voxels
EDGE_CHUNK_F = 257
EDGE_CHUNK_ROWS = 4096
# everything the run builds: the CUDA kernels (nvcc) and the host libraries
# of the PNG decoder and of the exports (g++), all started together
LIBRARIES = ("rowcopy", "gn", "fuse", "residual", "distcg", "normaleq", "albedo",
             "cull", "preprocess", "energy", "distreg", "smallsolve", "png_unfilter",
             "mc")
# the SH light block's eigen-solve (csrc/smallsolve.cu): wrapper -> (its
# source, the JAX function it replaces, by file:line)
SOLVE_KERNELS = {
    "light_solve": ("psgradientsdf_tpu_torch/csrc/smallsolve.cu",
                    "psgradientsdf_tpu/refine/solvers.py:531"),
}
# light_solve_kernels: the kernel's step within this of max|delta| of the
# plain solve's (torch.linalg.eigh in float64 on the card; the kernel's
# Jacobi rotations reach the same float64 answer to rounding, both rounded
# once to float32); the H100 SXM's float64 rate outside the tensor cores
# (NVIDIA's data sheet), the operations bound of its work
LIGHT_SOLVE_TOL = 1e-6
FP64_FLOPS = 34e12
# the cyclic-order design of the eigen-solve that csrc/smallsolve.cu's
# round-robin design replaced (the same C interface), timed in turns with it
EARLIER_SOLVE = "tools/smallsolve_cyclic.cu"
# refine_graph: the SH2 recipe (its optimizer keys), and the graphed and
# eager refinements run in turns this many times each (seconds: best of)
SH2_CONFIG = "configs/sokrates_sh2.json"
GRAPH_TURNS = 3


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields), default=float), flush=True)


# ---------------------------------------------------------------- the scene


def _g(x, y):
    return 1.2 + 0.08 * np.sin(6 * x) * np.cos(5 * y) + 0.05 * np.sin(3 * (x + y))


def _look_at(pos, target, roll):
    f = target - pos
    f = f / np.linalg.norm(f)
    r = np.cross(np.array([0.0, 1.0, 0.0]), f)
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    cr, sr = np.cos(roll), np.sin(roll)
    T = np.eye(4)
    T[:3, :3] = np.stack([cr * r + sr * d, -sr * r + cr * d, f], axis=1)
    T[:3, 3] = pos
    return T


def handheld_trajectory(n, rng):
    """The first n poses of a slow 120-frame orbit over a desk-sized scene
    with hand tremor and swings of the viewing direction."""
    poses = []
    for f in range(n):
        th = 2 * np.pi * f / 120.0
        pos = np.array([0.25 * np.sin(th), 0.18 * np.sin(th) * np.cos(th),
                        0.10 * np.cos(th) - 0.10])
        target = np.array([0.10 * np.sin(2 * th), 0.10 * np.cos(3 * th), 1.25])
        burst = np.exp(-0.5 * ((np.sin(2 * th) / 0.25) ** 2))
        target = target + burst * np.array(
            [0.10 * np.sin(9 * th), 0.08 * np.cos(7 * th), 0.0])
        roll = 0.06 * np.sin(2 * th) + 0.03 * burst * np.sin(11 * th)
        pos = pos + rng.normal(0.0, 0.0005, 3)
        poses.append(_look_at(pos, target, roll))
    return poses


def _g_grad(x, y):
    return (0.48 * np.cos(6 * x) * np.cos(5 * y) + 0.15 * np.cos(3 * (x + y)),
            -0.40 * np.sin(6 * x) * np.sin(5 * y) + 0.15 * np.cos(3 * (x + y)))


def render(pose, rng, shading="sh"):
    """Ray-march the wavy heightfield z = g(x, y) from `pose` -> (RGB uint8
    [H,W,3], depth uint16 [H,W] in DEPTH_UNIT metres with 1 mm noise).  The
    colour is the texture (the albedo) times a Lambertian irradiance of the
    analytic normal that faces the camera: SH1_LIGHT . [1, n] under one
    fixed distant light ("sh"), or a point light at the camera,
    -(n . d) / |d|^3 with d the ray to the surface point ("led")."""
    fx = fy = 0.9 * W
    cx, cy = W / 2.0 - 0.37, H / 2.0 + 0.21
    u = np.arange(W, dtype=np.float64)[None, :]
    v = np.arange(H, dtype=np.float64)[:, None]
    x0 = np.broadcast_to((u - cx) / fx, (H, W))
    y0 = np.broadcast_to((v - cy) / fy, (H, W))
    R, t = pose[:3, :3], pose[:3, 3]
    dir_w = np.stack([x0, y0, np.ones_like(x0)], axis=-1) @ R.T
    s = np.full((H, W), 1.2)
    for _ in range(30):
        p = t + s[..., None] * dir_w
        s = (_g(p[..., 0], p[..., 1]) - t[2]) / dir_w[..., 2]
    p = t + s[..., None] * dir_w
    x, y = p[..., 0], p[..., 1]
    rgb = np.stack([0.5 + 0.3 * np.sin(40 * x) * np.cos(31 * y),
                    0.5 + 0.3 * np.cos(27 * y),
                    0.5 + 0.25 * np.sin(35 * (x + y))], axis=-1)
    gx, gy = _g_grad(x, y)
    n = np.stack([gx, gy, -np.ones_like(gx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    if shading == "led":
        d = p - t
        irr = -np.sum(n * d, axis=-1) / np.linalg.norm(d, axis=-1) ** 3
        rgb = rgb * LED_LIGHT * irr[..., None]
    else:
        rgb = rgb * (SH1_LIGHT[0] + n @ SH1_LIGHT[1:])[..., None]
    depth = s + rng.normal(0.0, 0.001, s.shape)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
    return (K, np.clip(rgb * 255.0, 0, 255).astype(np.uint8),
            np.clip(depth / DEPTH_UNIT, 0, 65535).astype(np.uint16))


def make_sequence(n, shading="sh", step=1, seed=SEED):
    rng = np.random.default_rng(seed)
    gt = handheld_trajectory((n - 1) * step + 1, rng)[::step]
    K, colors, depths = None, [], []
    for pose in gt:
        K, c, d = render(pose, rng, shading)
        colors.append(c)
        depths.append(d)
    # the pipeline starts at the identity: ground truth relative to frame 0,
    # and frame 0's pose in the scene to get back
    inv0 = np.linalg.inv(gt[0])
    return K, colors, depths, [inv0 @ p for p in gt], gt[0]


def memory_loader(K, colors, depths, poses=None):
    """An ImageLoader that holds its frames in memory in the wire format, so
    the run needs no image files and no decoder.  With `poses` its load_pose
    hands them out as ground truth and the pipeline does not track."""
    from psgradientsdf_tpu_torch.io.loaders import ImageLoader

    class MemoryLoader(ImageLoader):
        unit = DEPTH_UNIT

        def __init__(self):
            super().__init__("")
            self.K = np.asarray(K, np.float32)

        def load_intrinsics(self, filename="intrinsics.txt"):
            return True

        def load_pose(self, filename):
            if poses is None:
                return None                  # no ground truth: tracking runs
            return [np.asarray(p, np.float32) for p in poses]

        def reset(self):
            pass

        def frame_paths(self, idx):
            if idx >= len(colors):
                return None
            return "", "", _stamp(idx), _stamp(idx)

        def read_frame(self, idx, raw=False):
            if idx >= len(colors):
                return None
            color, depth = colors[idx], depths[idx]
            if not raw:
                color = color.astype(np.float32) / 255.0
                depth = depth.astype(np.float32) * np.float32(self.unit)
            return color, depth, _stamp(idx), _stamp(idx)

    return MemoryLoader()


def _stamp(idx):
    """Frame idx's timestamp, 30 frames a second."""
    return f"{1000.0 + idx / 30.0:.4f}"


def write_tum_dataset(root, K, colors, depths):
    """The frames as a TUM RGB-D directory, as the port's TUM loader reads
    it: rgb/NNNN.png (8-bit RGB), depth/NNNN.png (16-bit gray in
    DEPTH_UNIT), associated.txt with memory_loader's timestamps, and
    intrinsics.txt."""
    from psgradientsdf_tpu_torch.io.png import write_png

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    lines = []
    for i, (c, d) in enumerate(zip(colors, depths)):
        ts = _stamp(i)
        write_png(os.path.join(root, f"rgb/{i:04d}.png"), c)
        write_png(os.path.join(root, f"depth/{i:04d}.png"), d, bit_depth=16)
        lines.append(f"{ts} rgb/{i:04d}.png {ts} depth/{i:04d}.png")
    with open(os.path.join(root, "associated.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "intrinsics.txt"), "w") as fh:
        for row in np.asarray(K, np.float32):
            fh.write(" ".join(repr(float(v)) for v in row) + "\n")


# ------------------------------------------------------------- the kernels


def _bits_equal(a, b):
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _abs_err(a, b):
    if a.dtype.is_floating_point:
        return float((a - b).abs().max())
    return float((a.long() - b.long()).abs().max())


def _time_ms(fn, flush):
    """Median device time of one call over KERNEL_REPS repetitions.  Each
    repetition first overwrites a buffer several times the size of the L2
    cache: that leaves the rows cold, as the fusion finds them (hundreds of
    MB pass between two row moves), and it keeps the card busy while the host
    enqueues the start event, the call and the end event, so the interval
    between the two events holds the call's device work and not the host's
    launch latency."""
    import torch

    for _ in range(3):
        fn()
    times = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(KERNEL_REPS):
        torch.cuda.synchronize()
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _case(rowcopy, name, table, idx, rows):
    """Run kernel `name` and its plain version on copies of the same tensors
    -> (kernel result, plain result)."""
    if name in ("gather_rows_dma", "gather_rows"):
        return (getattr(rowcopy, name)(table, idx),
                rowcopy.gather_rows_plain(table, idx))
    plain = (rowcopy.scatter_rows_dma_plain if name == "scatter_rows_dma"
             else rowcopy.scatter_rows_plain)
    return (getattr(rowcopy, name)(table.clone(), idx, rows),
            plain(table.clone(), idx, rows))


def _make(gen, n, r, cap, dtype, idx_dtype, misalign=False):
    """table [n,r], idx [cap] with duplicates, rows [cap,r] on the card.
    `identical` rows (rows[i] = source[idx[i]]) serve the direct scatter,
    whose duplicates must carry identical bytes; `rows` differ per slot."""
    import torch

    def rand(shape):
        if dtype == torch.float32:
            return torch.randn(shape, generator=gen, device="cuda")
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             device="cuda", dtype=torch.int64).to(torch.int32)

    if misalign:     # contiguous, but 4 bytes off the 16-byte alignment
        table = rand((n * r + 1,))[1:].view(n, r)
    else:
        table = rand((n, r))
    idx = torch.randint(0, n, (cap,), generator=gen, device="cuda").to(idx_dtype)
    if cap > 1:
        idx[cap // 2:] = idx[: cap - cap // 2].clone()   # duplicates
    rows = rand((cap, r))
    identical = rand((n, r))[idx.long()].contiguous()
    return table, idx, rows, identical


# one fused frame gathers, and writes back, five row tables with one index
# vector: dist, grad, weight, colour and the frame's visibility word
# (core/volume.py)
FRAME_TABLES = [(128, "float32"), (384, "float32"), (128, "float32"),
                (384, "float32"), (128, "int32")]
GATHERS = {"gather_rows_dma": "gather_tables_dma",
           "gather_rows": "gather_tables"}
SCATTERS = {"scatter_rows_dma": "scatter_tables_dma",
            "scatter_rows": "scatter_tables"}


def _make_tables(gen, n, cap, specs, idx_dtype, misaligned=(), pattern="random"):
    """A list of tables [n, r] of the (r, dtype) in `specs` with one idx
    [cap], per-slot `rows`, `identical` rows (see _make) and the count of
    live slots (None: all).  Tables whose position is in `misaligned` start
    4 bytes off 16-byte alignment.
    pattern "random": random indices, the second half repeats the first.
    pattern "unique": every slot names a row of its own.
    pattern "fusion": what the culled fusion sends, ascending distinct rows,
    then padding slots that all repeat the first, and the count of the
    former as `live`."""
    import torch

    made = [_make(gen, n, r, cap, getattr(torch, dt), idx_dtype,
                  misalign=pos in misaligned)
            for pos, (r, dt) in enumerate(specs)]
    idx, live = made[0][1], None
    if pattern == "unique":
        idx = torch.randperm(n, generator=gen, device="cuda")[:cap].to(idx_dtype)
    if pattern == "fusion":
        n_live = (3 * cap) // 4
        distinct = torch.randperm(n, generator=gen, device="cuda")[:n_live]
        idx = torch.cat([distinct.sort().values,
                         distinct.min().expand(cap - n_live)]).to(idx_dtype)
        live = torch.tensor(n_live, dtype=torch.int64, device="cuda")
    # identical rows follow the shared idx: slot i carries row idx[i] of a pool
    identical = [_make(gen, n, r, 1, getattr(torch, dt), idx_dtype)[0]
                 [idx.long()].contiguous() for r, dt in specs]
    return [m[0] for m in made], idx, [m[2] for m in made], identical, live


def _check_tables_case(rowcopy, what, tables, idx, rows, identical, live):
    """Both multi-table gathers on `tables`, and both multi-table scatters on
    copies of them, against their plain versions, bit for bit -> cases
    checked.  With a count of live slots the scatter kernels must also leave
    out the slots past it: they are then given per-slot rows there, and held
    against the plain version of the live slots alone."""
    import torch

    n = 0
    want = rowcopy.gather_tables_plain(tables, idx)
    for multi in GATHERS.values():
        got = getattr(rowcopy, multi)(tables, idx)
        torch.cuda.synchronize()
        check(len(got) == len(tables), f"{multi}: {len(got)} row blocks")
        for pos, (g, w) in enumerate(zip(got, want)):
            check(g.dtype == w.dtype and g.shape == w.shape
                  and g.is_contiguous() and _bits_equal(g, w),
                  f"{multi} disagrees with its plain version on table "
                  f"{pos} of {what}")
        n += 1
    for name, multi in SCATTERS.items():
        runs = [(identical if name == "scatter_rows_dma" else rows, None, idx)]
        if live is not None:
            k = int(live)
            mixed = [torch.cat([a[:k], b[k:]]) for a, b in zip(identical, rows)]
            runs = [(identical, live, idx), (mixed, live, idx[:k])]
        for src, lv, plain_idx in runs:
            want = getattr(rowcopy, multi + "_plain")(
                [t.clone() for t in tables], plain_idx,
                [r[: plain_idx.shape[0]] for r in src])
            got = getattr(rowcopy, multi)(
                [t.clone() for t in tables], idx, src, live=lv)
            torch.cuda.synchronize()
            for pos, (g, w) in enumerate(zip(got, want)):
                check(_bits_equal(g, w),
                      f"{multi} disagrees with its plain version on table "
                      f"{pos} of {what}")
            n += 1
    return n


def check_kernels(rowcopy):
    """All four kernels against their plain versions on the card, bit for
    bit, at the main path's shapes and at awkward ones; times at the main
    path's shapes."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    n_main, cap_main = GRID * GRID, GRID * GRID // 2
    # the three distinct (width, type) pairs among a frame's five tables
    frame_tables = [(128, torch.float32), (128, torch.int32),
                    (384, torch.float32)]
    cases = [(n_main, r, cap_main, dt, torch.int32, False)
             for r, dt in frame_tables]
    cases += [(40, r, cap, dt, it, False)
              for r in (1, 33, 96) for cap in (1, 7, 513)
              for dt, it in ((torch.float32, torch.int32),
                             (torch.int32, torch.int64))]
    cases += [(40, 8, 513, torch.float32, torch.int32, True)]

    worst = {k: 0.0 for k in KERNELS}
    n_checked = 0
    for n, r, cap, dt, it, mis in cases:
        table, idx, rows, identical = _make(gen, n, r, cap, dt, it, mis)
        for name in KERNELS:
            # the direct scatter's contract: slots sharing an index carry
            # identical rows; the ordered scatter gets different rows and the
            # last slot must win
            src = identical if name == "scatter_rows_dma" else rows
            got, want = _case(rowcopy, name, table, idx, src)
            torch.cuda.synchronize()
            check(_bits_equal(got, want),
                  f"{name} disagrees with its plain version at N={n} R={r} "
                  f"CAP={cap} {dt} idx {it} misaligned={mis}")
            worst[name] = max(worst[name], _abs_err(got, want))
            n_checked += 1

    # the multi-table gathers and scatters
    i32, i64 = torch.int32, torch.int64
    lists = [("the frame's five tables", n_main, cap_main, FRAME_TABLES, i32, ()),
             ("the frame's five tables, fusion's indices", n_main, cap_main,
              FRAME_TABLES, i32, ())]
    for t in (1, 2, 8):
        lists.append((f"T={t}", 300, 513, (FRAME_TABLES * 2)[:t], i64, ()))
    for r in (1, 33, 96):
        for cap in (1, 7, 513):
            spec = [(r, "float32"), (r, "int32"), (r, "float32")]
            lists.append((f"three tables R={r} CAP={cap}", 40, cap, spec,
                          i64 if cap == 7 else i32, ()))
    lists.append(("a misaligned base", 40, 513, [(8, "float32")] * 2, i32, (0, 1)))
    lists.append(("aligned and unaligned tables mixed", 200, 513,
                  [(128, "float32"), (33, "int32"), (96, "float32"),
                   (1, "float32"), (384, "float32")], i32, (2,)))
    lists.append(("rows of 20 KB", 64, 37, [(5120, "float32"), (4, "int32")],
                  i32, ()))
    for k, (what, n, cap, spec, it, mis) in enumerate(lists):
        made = _make_tables(gen, n, cap, spec, it, mis,
                            pattern="fusion" if k == 1 else "random")
        n_checked += _check_tables_case(rowcopy, what, *made)

    # last slot wins, stated outright: every slot names row 3
    specs = [(33, torch.float32), (128, torch.int32), (1, torch.float32),
             (384, torch.float32), (96, torch.int32)]
    idx = torch.full((5,), 3, device="cuda", dtype=torch.int32)
    one = torch.zeros((8, 33), device="cuda")
    rowcopy.scatter_rows(one, idx, torch.arange(
        5, device="cuda", dtype=torch.float32)[:, None].repeat(1, 33))
    tables = [torch.zeros((8, r), device="cuda", dtype=dt) for r, dt in specs]
    rowcopy.scatter_tables(
        tables, idx,
        [torch.arange(5, device="cuda")[:, None].repeat(1, r).to(dt)
         for r, dt in specs])
    torch.cuda.synchronize()
    for t in [one] + tables:
        check(bool((t[3] == 4).all())
              and float(t.abs().sum()) == 4 * t.shape[1],
              "scatter_rows: the last slot did not win")

    # times at the main path's shapes: ONE call on the frame's five tables,
    # per index pattern
    out = {}
    shapes = {k: [] for k in KERNELS}
    row_bytes = 4 * sum(r for r, _ in FRAME_TABLES)
    for pattern in ("random", "unique", "fusion"):
        tables, idx, _, identical, live = _make_tables(
            gen, n_main, cap_main, FRAME_TABLES, torch.int32, pattern=pattern)
        idx64 = idx.long()
        distinct = int(torch.unique(idx64).numel())
        # what this run's data needs, the indices read ONCE.  A gather: each
        # DISTINCT source row read (a second read of a row is served by the
        # L2 cache and need not reach device memory) and every slot's row
        # written.  A scatter: for every distinct destination row one slot's
        # rows read and the row written (the other slots that name it lose,
        # or carry the same bytes).
        bounds = {
            "gather": ((distinct + cap_main) * row_bytes + cap_main * 4)
            / HBM_BYTES_PER_S * 1e3,
            "scatter": (2 * distinct * row_bytes + cap_main * 4)
            / HBM_BYTES_PER_S * 1e3}
        src = torch.cat([r.view(torch.int32).reshape(-1) for r in identical])
        dst = torch.empty_like(src)

        def library_gather():
            for t in tables:
                torch.index_select(t, 0, idx64)

        def library_scatter():
            for t, rows in zip(tables, identical):
                t.index_copy_(0, idx64, rows)

        for name in KERNELS:
            if name in GATHERS:
                multi, kind, library = GATHERS[name], "gather", library_gather
                moved = cap_main
                call = lambda: getattr(rowcopy, multi)(tables, idx)
                plain = lambda: rowcopy.gather_tables_plain(tables, idx)
            else:
                multi, kind, library = SCATTERS[name], "scatter", library_scatter
                moved = (distinct if name == "scatter_rows" or live is not None
                         else cap_main)
                call = lambda: getattr(rowcopy, multi)(
                    tables, idx, identical, live=live)
                plain = lambda: getattr(rowcopy, multi + "_plain")(
                    tables, idx, identical)
            one = dict(
                indices=pattern, distinct_rows=distinct, slots_moved=moved,
                ms=_time_ms(call, flush), plain_ms=_time_ms(plain, flush),
                library_ms=_time_ms(library, flush), bound_ms=bounds[kind],
                # for scale: one contiguous device copy of all slots' bytes
                contiguous_copy_ms=_time_ms(lambda: dst.copy_(src), flush))
            one["share_of_bound"] = one["bound_ms"] / one["ms"]
            shapes[name].append(dict(
                tables=[f"R={r} {dt}" for r, dt in FRAME_TABLES], **one))
            if pattern == "random":    # as in the earlier records
                out[name] = {k: one[k] for k in
                             ("ms", "plain_ms", "library_ms", "bound_ms")}
    n_packed, packed = check_packed_widths(rowcopy, gen, flush)
    return out, shapes, worst, n_checked + n_packed, packed


def check_packed_widths(rowcopy, gen, flush):
    """All four kernels on the packed fusion's two tables at 128^3 (R = 1024
    + 128) and at 512^3 (R = 4096 + 512), N = the grid's rows, CAP = half of
    them, with the fusion's index pattern (ascending distinct rows, then
    padding that repeats the first, and `live`): bit for bit against their
    plain versions, then timed beside their byte bound -> (cases checked,
    times by grid).  A row of the payload holds a grid row's 8 floats a
    voxel (core/volume.PackedVolume), beside the row of its visibility
    word."""
    import torch

    n_checked, widths = 0, {}
    for g in (GRID, PACKED_BIG_GRID):
        n, cap = g * g, g * g // 2
        spec = [(8 * g, "float32"), (g, "int32")]
        made = _make_tables(gen, n, cap, spec, torch.int32, pattern="fusion")
        n_checked += _check_tables_case(rowcopy, f"the packed tables at {g}^3", *made)
        tables, idx, _, identical, live = made
        del made
        idx64 = idx.long()
        distinct = int(live)
        row_bytes = 4 * 9 * g
        bounds = {"gather": ((distinct + cap) * row_bytes + cap * 4) / HBM_BYTES_PER_S * 1e3,
                  "scatter": (2 * distinct * row_bytes + cap * 4) / HBM_BYTES_PER_S * 1e3}
        entry = dict(tables=[f"R={r} {dt}" for r, dt in spec], rows=n, slots=cap,
                     live_rows=distinct)
        for name in KERNELS:
            if name in GATHERS:
                kind, multi = "gather", GATHERS[name]
                call = lambda: getattr(rowcopy, multi)(tables, idx)
                plain = lambda: rowcopy.gather_tables_plain(tables, idx)
                library = lambda: [torch.index_select(t, 0, idx64) for t in tables]
            else:
                kind, multi = "scatter", SCATTERS[name]
                call = lambda: getattr(rowcopy, multi)(tables, idx, identical,
                                                       live=live)
                plain = lambda: getattr(rowcopy, multi + "_plain")(
                    tables, idx, identical)
                library = lambda: [t.index_copy_(0, idx64, r)
                                   for t, r in zip(tables, identical)]
            one = dict(ms=_time_ms(call, flush), plain_ms=_time_ms(plain, flush),
                       library_ms=_time_ms(library, flush), bound_ms=bounds[kind])
            one["share_of_bound"] = one["bound_ms"] / one["ms"]
            entry[name] = one
        widths[f"{g}^3"] = entry
        del tables, idx, identical, idx64
        torch.cuda.empty_cache()
    return n_checked, widths


# -------------------------------------------- the scan programs' two kernels


def _reset_scan_counts():
    """Launch counts of the scan's program kernels, and the frames
    track_frame solved, set to 0."""
    from psgradientsdf_tpu_torch.ops import cull, fuse, gn
    from psgradientsdf_tpu_torch.tracking import tracker

    gn.reset_launch_counts()
    fuse.reset_launch_counts()
    cull.reset_launch_counts()
    tracker.steps_run["track_frame"] = 0


def _scan_counts():
    from psgradientsdf_tpu_torch.ops import cull, fuse, gn
    from psgradientsdf_tpu_torch.tracking import tracker

    return dict(gn.launch_counts, **fuse.launch_counts, **cull.launch_counts,
                frames_solved=tracker.steps_run["track_frame"])


def _reset_row_counts():
    """Launch counts of the culled fusion's kernels (the row copies, the
    cull and the compaction), set to 0."""
    from psgradientsdf_tpu_torch.ops import cull, rowcopy

    rowcopy.reset_launch_counts()
    cull.reset_launch_counts()


def _row_counts():
    from psgradientsdf_tpu_torch.ops import cull, rowcopy

    return dict(rowcopy.launch_counts, **cull.launch_counts)


@contextlib.contextmanager
def _plain_cull_calls():
    """While the body runs, count the calls of ops/cull.py's plain versions
    (the cull's and the compactions' eager chains) on tensors on the card ->
    the dict of counts (0 on every path: the wrappers launch the kernels).
    The module functions are wrapped from outside."""
    from psgradientsdf_tpu_torch.ops import cull

    calls = {"plain_cull_on_card": 0}
    names = ("row_activity_plain", "compact_active_plain", "compact_padded_plain",
             "cull_compact_plain")
    real = {n: getattr(cull, n) for n in names}

    def counted(name, pos):
        def fn(*a, **kw):
            if a[pos].device.type != "cpu":
                calls["plain_cull_on_card"] += 1
            return real[name](*a, **kw)
        return fn

    for n in names:
        setattr(cull, n, counted(n, 0 if n.startswith("compact") else 1))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(cull, n, fn)


# the scan's preprocessing and the refinement's energies (ops/preprocess.py,
# ops/energy.py): wrapper -> (its source, the JAX function it replaces, by
# file:line)
SLICE_KERNELS = {
    "fals_normals": ("psgradientsdf_tpu_torch/csrc/preprocess.cu",
                     "psgradientsdf_tpu/tracking/stream.py:74"),
    "lapm": ("psgradientsdf_tpu_torch/csrc/preprocess.cu",
             "psgradientsdf_tpu/tracking/stream.py:74"),
    "energy_sums": ("psgradientsdf_tpu_torch/csrc/energy.cu",
                    "psgradientsdf_tpu/refine/optimizer.py:60"),
}


# the distance block's eager tail and the LED light's normal equations
# (ops/distreg.py, ops/normaleq.py): wrapper -> (its source, the JAX
# function it replaces, by file:line)
TAIL_KERNELS = {
    "reg_operators": ("psgradientsdf_tpu_torch/csrc/distreg.cu",
                      "psgradientsdf_tpu/refine/solvers.py:135"),
    "dist_update": ("psgradientsdf_tpu_torch/csrc/distreg.cu",
                    "psgradientsdf_tpu/refine/solvers.py:307"),
    "light_normal_eqs_led": ("psgradientsdf_tpu_torch/csrc/normaleq.cu",
                             "psgradientsdf_tpu/refine/solvers.py:538"),
}


@contextlib.contextmanager
def _slice_calls():
    """While the body runs, count the scan's chunk preprocessings
    (tracking/stream._preprocess), its frames fused outside a chunk
    (pipeline.compute_normals), the energy evaluations' calls of
    ops/energy.energy_sums, the calls of ops/distreg.py's two wrappers
    (the distance tail's standalone kernels), of refine/solvers.distance_step
    (the one-card distance block's fused step) and of
    ops/normaleq.light_normal_eqs_led, and the
    plain preprocessing, energy, distance tail and LED light chains on
    tensors on the card; the launch counts of the six kernels are set to 0
    on entry and read on exit -> the dict of counts.  The module functions
    are wrapped from outside."""
    import psgradientsdf_tpu_torch.pipeline as pipeline_mod
    from psgradientsdf_tpu_torch.ops import distreg, energy, normaleq, preprocess
    from psgradientsdf_tpu_torch.refine import graph, solvers
    from psgradientsdf_tpu_torch.tracking import stream

    calls = dict(chunks=0, frame_normals=0, energy_calls=0, reg_operators_calls=0,
                 dist_update_calls=0, distance_step_calls=0, light_led_calls=0,
                 plain_preprocess_on_card=0, plain_energy_on_card=0,
                 plain_dist_tail_on_card=0, plain_led_light_on_card=0)
    wrapped = {(stream, "_preprocess"): "chunks",
               (pipeline_mod, "compute_normals"): "frame_normals",
               (energy, "energy_sums"): "energy_calls",
               (distreg, "reg_operators"): "reg_operators_calls",
               (distreg, "dist_update"): "dist_update_calls",
               (solvers, "distance_step"): "distance_step_calls",
               (normaleq, "light_normal_eqs_led"): "light_led_calls"}
    plain = {(preprocess, "fals_normals_plain"): ("plain_preprocess_on_card", lambda a: a[0]),
             (preprocess, "lapm_plain"): ("plain_preprocess_on_card", lambda a: a[0]),
             (energy, "energy_sums_plain"): ("plain_energy_on_card", lambda a: a[1].r),
             (distreg, "reg_operators_plain"): ("plain_dist_tail_on_card", lambda a: a[1]),
             (distreg, "dist_update_plain"): ("plain_dist_tail_on_card", lambda a: a[1]),
             (normaleq, "light_normal_eqs_led_plain"): ("plain_led_light_on_card",
                                                        lambda a: a[0].w)}
    real = {k: getattr(*k) for k in list(wrapped) + list(plain)}

    def counted(key):
        def fn(*a, **kw):
            calls[wrapped[key]] += 1
            return real[key](*a, **kw)
        return fn

    def on_card(key):
        name, tensor_arg = plain[key]

        def fn(*a, **kw):
            if tensor_arg(a).device.type != "cpu":
                calls[name] += 1
            return real[key](*a, **kw)
        return fn

    preprocess.reset_launch_counts()
    energy.reset_launch_counts()
    distreg.reset_launch_counts()
    normaleq.launch_counts["light_normal_eqs_led"] = 0
    for key in wrapped:
        setattr(*key, counted(key))
    for key in plain:
        setattr(*key, on_card(key))
    try:
        # a graphed iteration's calls are made at its capture: each replay
        # adds what the capture counted (refine/graph.py)
        with graph.registered(calls):
            yield calls
    finally:
        for key, fn in real.items():
            setattr(*key, fn)
        calls.update(preprocess.launch_counts, **energy.launch_counts,
                     **distreg.launch_counts,
                     light_normal_eqs_led=normaleq.launch_counts["light_normal_eqs_led"])


def _energy_evaluations(ref):
    """The energy evaluations of a refinement loop run from its start: one
    before the loop, a fused iteration's leading pass and one after each
    block, and one at the upsample."""
    from psgradientsdf_tpu_torch.refine.optimizer import block_names

    cfg = ref.cfg
    names = block_names(cfg.opt_light, cfg.opt_albedo, cfg.opt_distance,
                        cfg.opt_pose, cfg.joint_dp)
    upsampled = sum(1 for r in ref.energy_trace if r["block"] == "upsample")
    return 1 + ref.iterations_run * (1 + len(names)) + upsampled


def _local_blocks(ref):
    """The refinement blocks this process runs: 1 on one device, its
    entries of the mesh's layout on a mesh."""
    from psgradientsdf_tpu_torch.parallel import mesh as pm

    if ref.mesh is None:
        return 1
    return sum(not pm.is_remote(d) for row in ref.prob.layout.devices for d in row)


def _local_rows(ref):
    """The rows of the surface set's split this process holds: 1 on one
    device, its rows of the mesh's layout on a mesh."""
    from psgradientsdf_tpu_torch.parallel import mesh as pm

    if ref.mesh is None:
        return 1
    return sum(not pm.is_remote(row[0]) for row in ref.prob.layout.devices)


def _tail_blocks(ref):
    """(distance blocks, joint blocks, LED light blocks) of a refinement
    loop run from its start."""
    from psgradientsdf_tpu_torch.refine.optimizer import block_names

    cfg = ref.cfg
    names = block_names(cfg.opt_light, cfg.opt_albedo, cfg.opt_distance,
                        cfg.opt_pose, cfg.joint_dp)
    it = ref.iterations_run
    led = it * names.count("light") * (cfg.model == "LED")
    return it * names.count("distance"), it * names.count("joint_dp"), led


def _check_slice(calls, what, ref=None, card=None):
    """A chunk preprocessed with one launch of each preprocessing kernel
    (fals_normals also once a frame fused outside a chunk), an energy
    evaluation with one energy_sums launch a block (`ref`'s loop run from
    its start), no plain chain on the card -> what was counted.  `card`:
    whether the path ran on the card (by default DEVICE's)."""
    on_card = (lambda n: n if card else 0) if card is not None else _on_card
    normals = calls["chunks"] + calls["frame_normals"]
    check(calls["fals_normals"] == on_card(normals)
          and calls["lapm"] == on_card(calls["chunks"]),
          f"{what}: fals_normals {calls['fals_normals']} and lapm {calls['lapm']} "
          f"launches, {calls['chunks']} chunks and {calls['frame_normals']} frames "
          "fused alone")
    check(calls["plain_preprocess_on_card"] == 0,
          f"{what}: {calls['plain_preprocess_on_card']} plain preprocessing chains on the card")
    check(calls["plain_energy_on_card"] == 0,
          f"{what}: {calls['plain_energy_on_card']} plain energy chains on the card")
    check(calls["plain_dist_tail_on_card"] == 0 and calls["plain_led_light_on_card"] == 0,
          f"{what}: {calls['plain_dist_tail_on_card']} plain distance tails and "
          f"{calls['plain_led_light_on_card']} plain LED light sums on the card")
    out = dict(calls)
    if ref is not None:
        # on one device a distance block is one fused distance step (its
        # tail stages of dist_system and dist_cg) and a joint block one
        # operators call and one update call; on a mesh a distance or joint
        # block one operators call and one update call a row of the surface
        # set's split; an LED light block one call a block
        dist_blocks, joint_blocks, led_blocks = _tail_blocks(ref)
        fused = dist_blocks if ref.mesh is None else 0
        standalone = (dist_blocks + joint_blocks - fused) * _local_rows(ref)
        check(calls["distance_step_calls"] == fused,
              f"{what}: {calls['distance_step_calls']} fused distance steps, "
              f"expected {fused}")
        for name, want in (("reg_operators", standalone), ("dist_update", standalone),
                           ("light_normal_eqs_led", led_blocks * _local_blocks(ref))):
            got = calls["light_led_calls" if name == "light_normal_eqs_led"
                        else name + "_calls"]
            check(got == want and calls[name] == on_card(want),
                  f"{what}: {name} {calls[name]} launches, {got} calls, expected {want}")
        out.update(distance_blocks=dist_blocks, joint_blocks=joint_blocks,
                   fused_distance_steps=fused, led_light_blocks=led_blocks,
                   rows=_local_rows(ref))
        want = _energy_evaluations(ref) * _local_blocks(ref)
        check(calls["energy_calls"] == want and calls["energy_sums"] == on_card(want),
              f"{what}: energy_sums {calls['energy_sums']} launches, "
              f"{calls['energy_calls']} calls, expected {_energy_evaluations(ref)} "
              f"evaluations x {_local_blocks(ref)} blocks")
        out.update(energy_evaluations=_energy_evaluations(ref), blocks=_local_blocks(ref))
    return out


def _one_card_tail(calls, blocks, what):
    """A one-card refinement's distance blocks through the fused step
    (solvers.distance_step, its tail stages of dist_system and dist_cg):
    `blocks` fused steps, no standalone tail call or launch -> the counts."""
    out = {k: calls[k] for k in ("distance_step_calls", "reg_operators", "dist_update",
                                 "reg_operators_calls", "dist_update_calls")}
    check(out["distance_step_calls"] == blocks
          and not any(v for k, v in out.items() if k != "distance_step_calls"),
          f"{what}: the distance tail's calls and launches {out}, expected {blocks} "
          "fused distance steps and no standalone tail")
    return out


def _reset_refine_counts():
    """Launch counts of the refinement's nine kernels, set to 0."""
    from psgradientsdf_tpu_torch.ops import albedo, distcg, normaleq, residual, smallsolve

    residual.reset_launch_counts()
    distcg.reset_launch_counts()
    normaleq.reset_launch_counts()
    albedo.reset_launch_counts()
    smallsolve.reset_launch_counts()


def _refine_counts():
    from psgradientsdf_tpu_torch.ops import albedo, distcg, normaleq, residual, smallsolve

    return dict(residual.launch_counts, **distcg.launch_counts,
                **normaleq.launch_counts, **albedo.launch_counts,
                **smallsolve.launch_counts)


@contextlib.contextmanager
def _refine_calls():
    """While the body runs, count the calls of ops/residual.py's two
    wrappers (a residual pass, a distance Jacobian, kernel or plain), of
    ops/distcg.py's two (the distance block's rows and its CG; the forms
    with the tail's stages, dist_system_reg and dist_cg_update, count as
    theirs), of
    ops/normaleq.py's two (the pose and the SH light normal equations), of
    ops/albedo.py's one (the albedo block) and of ops/smallsolve.py's one
    (the SH light's eigen-solve), and the
    plain residual passes, plain distance solves (rows or CG), plain normal
    equations (the pose chain or the light's product), plain albedo
    solves (its system, its CG, or the eager chain's data terms) and plain
    light solves on tensors on the card -> the dict of counts.  A graphed
    iteration's calls are counted at its capture and again at each replay
    (refine/graph.registered).  The module functions are wrapped
    from outside; the package has no switch for it."""
    from psgradientsdf_tpu_torch.ops import albedo, distcg, normaleq, residual, smallsolve
    from psgradientsdf_tpu_torch.refine import graph, solvers

    calls = dict(residual_pass=0, dist_jacobian=0, dist_system=0, dist_cg=0,
                 pose_normal_eqs=0, light_normal_eqs_sh=0, albedo_block=0,
                 light_solve=0, plain_residual_pass_on_card=0,
                 plain_distance_solve_on_card=0, plain_normal_eqs_on_card=0,
                 plain_albedo_solve_on_card=0, plain_light_solve_on_card=0)
    modules = {"residual_pass": residual, "dist_jacobian": residual,
               "residual_pass_plain": residual, "dist_system": distcg,
               "dist_cg": distcg, "dist_system_reg": distcg, "dist_cg_update": distcg,
               "dist_system_plain": distcg,
               "dist_cg_plain": distcg, "pose_normal_eqs": normaleq,
               "light_normal_eqs_sh": normaleq, "pose_normal_eqs_plain": normaleq,
               "albedo_block": albedo,
               "albedo_system_plain": albedo, "albedo_cg_plain": albedo,
               "albedo_data_terms": solvers, "light_solve": smallsolve,
               "light_solve_plain": smallsolve}
    real = {n: getattr(m, n) for n, m in modules.items()}
    light_plain = solvers.light_normal_eqs_sh

    def counted(name, key=None):
        def fn(*a, **kw):
            calls[key or name] += 1
            return real[name](*a, **kw)
        return fn

    def plain(name, tensor_arg, key):
        def fn(*a, **kw):
            if tensor_arg(a).device.type != "cpu":
                calls[key] += 1
            return real[name](*a, **kw)
        return fn

    def light_on_card(*a, **kw):
        if a[0].w.device.type != "cpu":
            calls["plain_normal_eqs_on_card"] += 1
        return light_plain(*a, **kw)

    for n in ("residual_pass", "dist_jacobian", "dist_system", "dist_cg",
              "pose_normal_eqs", "light_normal_eqs_sh", "albedo_block", "light_solve"):
        setattr(modules[n], n, counted(n))
    # the distance block's launches with its tail stages: their kernels' calls
    distcg.dist_system_reg = counted("dist_system_reg", "dist_system")
    distcg.dist_cg_update = counted("dist_cg_update", "dist_cg")
    residual.residual_pass_plain = plain(
        "residual_pass_plain", lambda a: a[2], "plain_residual_pass_on_card")
    distcg.dist_system_plain = plain(
        "dist_system_plain", lambda a: a[0].w, "plain_distance_solve_on_card")
    distcg.dist_cg_plain = plain(
        "dist_cg_plain", lambda a: a[0], "plain_distance_solve_on_card")
    normaleq.pose_normal_eqs_plain = plain(
        "pose_normal_eqs_plain", lambda a: a[0].w, "plain_normal_eqs_on_card")
    albedo.albedo_system_plain = plain(
        "albedo_system_plain", lambda a: a[1].w, "plain_albedo_solve_on_card")
    albedo.albedo_cg_plain = plain(
        "albedo_cg_plain", lambda a: a[0].b, "plain_albedo_solve_on_card")
    solvers.albedo_data_terms = plain(
        "albedo_data_terms", lambda a: a[0].w, "plain_albedo_solve_on_card")
    smallsolve.light_solve_plain = plain(
        "light_solve_plain", lambda a: a[0], "plain_light_solve_on_card")
    solvers.light_normal_eqs_sh = light_on_card
    try:
        with graph.registered(calls):
            yield calls
    finally:
        for n, fn in real.items():
            setattr(modules[n], n, fn)
        solvers.light_normal_eqs_sh = light_plain


def _fuse_capacity(geom):
    """The pipeline's culled-fusion capacity at "fuse rows" 0.5."""
    zy = geom.dims[2] * geom.dims[1]
    return min(zy, max(256, -(-int(zy * 0.5) // 256) * 256))


def _update_case(st, vol, layout, geom, truncation, f, flush):
    """fuse_rows against its plain version on the rows frame f's cull
    gathers from `vol` at its generating pose: bit for bit on the live
    slots, the padding slots left as gathered -> dict."""
    import torch
    from psgradientsdf_tpu_torch.core import volume as V
    from psgradientsdf_tpu_torch.ops import fuse as F, rowcopy

    X, Y, Z = geom.dims
    depth, K, pose = st["depths"][f], st["K"], st["gt"][f]
    kz = dict(st["zkw"], truncation=truncation)
    cap = _fuse_capacity(geom)
    act = V._row_activity(geom, depth, K, pose, **kz)
    idx, live, overflow = V._compact_padded(act.reshape(-1), cap)
    check(not bool(overflow), f"frame {f} at {X}^3: the cull overflows {cap}")
    word, bit = V._vis_word_bit(f)
    if layout == "soa":
        tables = [vol.dist.view(Z * Y, X), vol.grad.view(Z * Y, 3 * X),
                  vol.weight.view(Z * Y, X), vol.color.view(Z * Y, 3 * X)]
    else:
        tables = [vol.payload.view(Z * Y, 8 * X)]
    tables.append(vol.vis[word].view(Z * Y, X))
    rows = rowcopy.gather_tables_dma(tables, idx)
    pix = V.pack_pixel_payload(st["colors"][f], depth, st["normals"][f],
                               st["n_sq_inv"])

    def fields(r):
        if layout == "soa":
            return r[0], r[1].view(cap, X, 3), r[2], r[3].view(cap, X, 3), r[4]
        r8 = r[0].view(cap, X, 8)
        return r8[..., 0], r8[..., 1:4], r8[..., 4], r8[..., 5:8], r[1]

    kw = dict(geom=geom, S=X, rows=idx, live=live, cos_thresh_sq=0.25 * 0.25, **kz)
    got, want = [r.clone() for r in rows], [r.clone() for r in rows]
    F.fuse_rows(*fields(got), pix, K, pose, tuple(depth.shape), bit, None, **kw)
    F.fuse_rows_plain(*fields(want), pix, K, pose, tuple(depth.shape), bit,
                      None, **kw)
    _sync()
    n = int(live)
    for a, b, r in zip(got, want, rows):
        check(_bits_equal(a[:n], b[:n]),
              f"fuse_rows differs from its plain version: frame {f}, {X}^3, "
              f"{layout}, by up to {_abs_err(a[:n], b[:n])}")
        check(_bits_equal(a[n:], r[n:]), "fuse_rows wrote a padding slot")
    out = dict(grid=X, frame=f, layout=layout, slots=cap, live_rows=n,
               updated_voxels=int(((got[-1][:n] & bit) != 0).sum()),
               bit_identical=True)
    if DEVICE == "cuda":
        H, W = depth.shape
        # each live voxel reads and writes its 36 bytes of state, the pixel
        # table is read at most once, the row ids once
        out["bound_ms"] = (n * X * 72 + min(n * X, H * W) * 32 + cap * 4) \
            / HBM_BYTES_PER_S * 1e3
        out["ms"] = _time_ms(lambda: F.fuse_rows(
            *fields(got), pix, K, pose, (H, W), bit, None, **kw), flush)
        out["plain_ms"] = _time_ms(lambda: F.fuse_rows_plain(
            *fields(want), pix, K, pose, (H, W), bit, None, **kw), flush)
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def _rot_angle(a, b):
    """Angle of the rotation between two poses' rotations (radians)."""
    R = np.asarray(a, np.float64)[:3, :3] @ np.asarray(b, np.float64)[:3, :3].T
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v) / 2)))


def scan_kernels(tmp, seq):
    """The two kernels of the scan's jit-fused programs against their plain
    versions on the card, at the main path's shapes.
    (a) fuse_rows against fuse_voxel_update on row_world_coords, bit for
        bit on the live slots, on the real rows of frames 0 and 24 at 128^3
        (frame 24 on the volume fused at the generating poses of frames
        0-23) and of frame 0 at 512^3, in the SoA and the packed layout;
        ms, plain_ms and bound_ms of each.
        Then the callers' other paths, bit for bit (_update_variants).
    (b) frame 24 (640x480): one fresh step (gn_solve, num_iterations=1),
        a fresh and a frozen step on its on-chip records, and the Gram alone
        (gn_gram), each against the plain Gram of the same pose and records:
        S within GN_S_TOL of max|S|; the REFERENCE solve's ms, plain_ms,
        bound_ms and latency floor; gn_gram's ms, plain_ms and bound_ms.
    (c) the FRAMES frames tracked under each named configuration
        (_track_configs): the kernel twice, bit for bit, and against the
        plain loop within GN_POSE_TOL.
    (d) frame 24 at 1280x960, whose records go to device memory
        (_big_frame).
    (e) the culled fusion's cull and compaction (one cull_compact launch),
        bit for bit on the cases of _cull_kernels, with its times in the
        path's order.
    Launches made here are on no path.  -> facts."""
    import torch
    from psgradientsdf_tpu_torch.core.grid import GridGeometry
    from psgradientsdf_tpu_torch.ops import gn as G
    from psgradientsdf_tpu_torch.tracking import tracker as T

    st = _stream_setup(tmp, seq, FRAMES)
    geom, zkw = st["geom"], st["zkw"]
    flush = (torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
             if DEVICE == "cuda" else None)
    facts = {"update": []}

    # (a) the update
    g0 = st["geom"]
    big = GridGeometry(dims=(PACKED_BIG_GRID,) * 3,
                       voxel_size=g0.voxel_size * g0.dims[0] / PACKED_BIG_GRID,
                       shift=g0.shift)
    t_big = st["truncation"] * g0.dims[0] / PACKED_BIG_GRID
    for layout in ("soa", "packed"):
        vol = _fresh(st, layout)
        facts["update"].append(_update_case(st, vol, layout, geom,
                                            st["truncation"], 0, flush))
        vol = _gt_loop(st, range(24), layout, st["cap"])
        facts["update"].append(_update_case(st, vol, layout, geom,
                                            st["truncation"], 24, flush))
        del vol
        vol = _fresh(st, layout, big, t_big)
        facts["update"].append(_update_case(st, vol, layout, big, t_big, 0, flush))
        del vol
        if DEVICE == "cuda":
            torch.cuda.empty_cache()

    facts["update_variants"] = _update_variants(st)
    facts["cull"] = _cull_kernels(st, flush)

    # (b) one step, one round, the Gram alone, and the solve's time
    vol = _gt_loop(st, range(FRAMES), "soa", st["cap"])
    f = 24
    frame = G.GnFrame(geom, st["depths"][f], st["K"], stride=1,
                      zmin=zkw["zmin"], zmax=zkw["zmax"], vol=vol)
    seed = st["gt"][f - 1]
    # every step active: no threshold to meet
    active = dict(conv_threshold_sq=0.0, damping=st["gn"]["damping"])
    step = dict(frame=f, pixels=frame.n, tolerance=GN_S_TOL,
                **_gn_step_checks(frame, seed, active))
    ref = _solve_kw("REFERENCE")
    if DEVICE == "cuda":
        blocks, on_chip = G.solve_plan(frame.device, frame.n, 1)
        c = G.new_carry(seed)
        G.gn_solve(frame, c, **ref)
        iters = int(c[G.ITERS])
        # the depth map once, each fresh step's distinct voxel records once
        distinct = _distinct_records(frame, seed, {
            k: ref[k] for k in ("num_iterations", "conv_threshold_sq", "damping")})
        carries = iter([G.new_carry(seed) for _ in range(2 * KERNEL_REPS + 6)])
        step.update(
            config="REFERENCE", blocks=blocks, tile_on_chip=on_chip,
            iterations=iters, distinct_records=distinct,
            bound_ms=(frame.n * 4 + sum(distinct) * 32) / HBM_BYTES_PER_S * 1e3,
            ms=_time_ms(lambda: G.gn_solve(frame, next(carries), **ref), flush),
            plain_ms=_time_ms(lambda: G.gn_solve_plain(frame, next(carries), **ref),
                              flush),
            # an empty cooperative kernel on the same grid, crossing as many
            # grid barriers as the solve ran steps
            latency_floor_ms=_time_ms(lambda: G.barrier_floor(frame, 1, iters), flush),
            library_ms=None)
        step["share_of_bound"] = step["bound_ms"] / step["ms"]
        # the Gram alone at 640x480 (gn_gram, the mesh / resident trackers'):
        # two runs bit for bit, its plan, its time beside an empty launch of
        # the same grid and clusters
        recs = G.pack_records(*G.frame_records(frame, seed))
        rows = _gram_rows(frame.points()[0], seed, G.unpack_records(recs))
        check(_bits_same(G.gram(frame, seed, recs), G.gram(frame, seed, recs)),
              "gn_gram: two runs differ")
        plan = G.gram_plan(frame.n, _sm_count())
        facts["gn_gram"] = dict(
            frame=f, pixels=frame.n, max_abs_err=step["gram_max_abs_err"],
            runs_bit_identical=True, plan=plan._asdict(),
            ms=_time_ms(lambda: G.gram(frame, seed, recs), flush),
            latency_floor_ms=_time_ms(lambda: G.gram_floor(frame, recs), flush),
            plain_ms=_time_ms(lambda: G.gram_plain(
                frame.points()[0], seed, G.unpack_records(recs)), flush),
            # the depth map and the records read once, S written
            bound_ms=(frame.n * (4 + 32) + 256) / HBM_BYTES_PER_S * 1e3,
            library_ms=_time_ms(lambda: torch.einsum("ni,nk->ik", rows, rows), flush),
            library_call="torch.einsum('ni,nk->ik', G, G) over the masked [N, 8] rows")
        del rows
        facts["gn_gram"]["share_of_bound"] = (facts["gn_gram"]["bound_ms"]
                                              / facts["gn_gram"]["ms"])
        if "--gram-parent" in sys.argv[1:]:
            facts["gn_gram"]["parent"] = _gram_parent_ab(frame, seed, recs, flush)
            facts["gn_gram"]["earlier_ms"] = statistics.median(
                facts["gn_gram"]["parent"]["parent"])
    facts["gn_solve"] = step

    # (c) the frames tracked under each named configuration, kernel against
    # plain, and the kernel against itself
    facts["tracking"] = {name: _track_configs(st, vol, geom, name)
                         for name in GN_CONFIGS}

    # (d) a 1280x960 frame: the records do not fit on chip
    facts["big_frame"] = _big_frame(st, vol, f)
    return facts


GN_CONFIGS = ("REFERENCE", "STREAMING", "PARITY", "STREAMING_FAST")


def _gram_parent_ab(frame, pose, recs, flush):
    """gn_gram on this gn.cu and on the --gram-parent source (any earlier
    gn.cu whose GnArgs is a prefix of this one's and whose gn_gram sizes
    its own grid, up to 528 blocks; built here into a temporary directory,
    its launches on no path and not counted), the parent held within
    GN_S_TOL of max|S| of this kernel's S, timed in turns: this, the parent,
    the parent, this -> {"this"|"parent": [ms, ms]}."""
    import torch
    from psgradientsdf_tpu_torch.ops import gn as G

    src = sys.argv[sys.argv.index("--gram-parent") + 1]
    scratch = (torch.empty(528 * 36, dtype=torch.float32, device=recs.device),
               torch.zeros(1, dtype=torch.int32, device=recs.device))
    with tempfile.TemporaryDirectory(prefix="gram_parent_") as tmp:
        parent = _parent_build(src, tmp, "gn_parent")
        parent.gn_gram.argtypes = [ctypes.POINTER(G._GnArgs), ctypes.c_void_p]
        runs = dict(this=lambda: G.gram(frame, pose, recs),
                    parent=lambda: _parent_gram(parent, frame, pose, recs, scratch))
        S, Sp = runs["this"](), runs["parent"]()
        _sync()
        check(_rel(Sp, S.cpu()) <= GN_S_TOL, "the parent's gn_gram differs from this one's")
        times = {"this": [], "parent": []}
        for name in ("this", "parent", "parent", "this"):
            times[name].append(_time_ms(runs[name], flush))
    return times


def _parent_gram(parent, frame, pose, recs, scratch):
    """The parent's gn_gram (its own grid; `scratch`: partials for up to 528
    blocks and a zeroed ticket) -> S."""
    import torch
    from psgradientsdf_tpu_torch.ops import gn as G

    partials, ticket = scratch
    out = torch.empty((8, 8), dtype=torch.float32, device=recs.device)
    d = frame.depth
    a = G._GnArgs(depth=d.data_ptr(), h=d.shape[0], w=d.shape[1], depth_rs=d.stride(0),
                  depth_cs=d.stride(1), coord_stride=float(frame.stride), K=frame.K.data_ptr(),
                  zmin=frame.zmin, zmax=frame.zmax, records=recs.data_ptr(),
                  pose=pose.contiguous().data_ptr(), gram_out=out.data_ptr(),
                  partials=partials.data_ptr(), ticket=ticket.data_ptr())
    rc = parent.gn_gram(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"the parent's gn_gram: CUDA error {rc}")
    return out


def _gram_rows(pts_cam, pose, rec):
    """The masked rows G [N, 8] of ops/gn.gram_plain (ghat, p x ghat, psi,
    1, times the mask), whose Gram G^T G one einsum forms: gn_gram's
    one-call yardstick."""
    import torch

    d, ghat, c_v, ok = rec
    p_w = pts_cam @ pose[:3, :3].T + pose[:3, 3]
    psi = d + torch.sum(ghat * (c_v - p_w), dim=-1)
    return torch.cat([ghat, torch.linalg.cross(p_w, ghat), psi[:, None],
                      torch.ones_like(psi)[:, None]], dim=-1) * ok.to(psi.dtype)[:, None]


def _solve_kw(name):
    """A named tracker configuration as gn_solve's keywords."""
    from psgradientsdf_tpu_torch.tracking import configs

    kw = dict(getattr(configs, name))
    del kw["stride"]
    return kw


def _gn_step_checks(frame, seed, active):
    """One fresh step (gn_solve, num_iterations=1), a fresh and a frozen
    step on its records (num_iterations=2, regather_every=2) and the Gram
    alone (gn_gram), each against the plain Gram of the same pose and
    records: S within GN_S_TOL of max|S| -> dict."""
    from psgradientsdf_tpu_torch.ops import gn as G

    pts = frame.points()[0]
    rec = G.frame_records(frame, seed)
    S_fresh = G.gram_plain(pts, seed, rec)
    one = G.new_carry(seed)
    G.gn_solve(frame, one, num_iterations=1, **active)
    pose1 = one[:16].view(4, 4).clone()
    S_frozen = G.gram_plain(pts, pose1, rec)
    two = G.new_carry(seed)
    G.gn_solve(frame, two, num_iterations=2, regather_every=2, early_exit=False,
               **active)
    gram = G.gram(frame, pose1, G.pack_records(*rec))
    err = {"fresh": _rel(one[G.S0:].view(8, 8), S_fresh.cpu()),
           "frozen": _rel(two[G.S0:].view(8, 8), S_frozen.cpu()),
           "gram": _rel(gram, S_frozen.cpu())}
    for k, e in err.items():
        check(e <= GN_S_TOL, f"gn {k} step: S differs by {e:.3g} of max|S|")
    return dict(valid_pixels=int(S_fresh[7, 7]), relative_error=err,
                max_abs_err=float((one[G.S0:].view(8, 8) - S_fresh).abs().max()),
                gram_max_abs_err=float((gram - S_frozen).abs().max()))


def _distinct_records(frame, seed, kw):
    """The distinct voxel records each fresh step of the plain solve reads
    (a regather_every=1 solve: every active step is fresh)."""
    import torch
    from psgradientsdf_tpu_torch.ops import gn as G

    geom, pts = frame.geom, frame.points()[0]
    X, Y = geom.dims[0], geom.dims[1]
    carry, out = G.new_carry(seed), []
    n_iter = kw["num_iterations"]
    while True:
        conv, fail, iters = carry[[G.CONV, G.FAIL, G.ITERS]].tolist()
        if iters >= n_iter or conv or fail:
            return out
        pose = carry[:16].view(4, 4)
        idx, valid = geom.nearest_info(pts @ pose[:3, :3].T + pose[:3, 3])
        lin = ((idx[..., 2] * Y + idx[..., 1]) * X + idx[..., 0])[valid]
        out.append(int(torch.unique(lin).numel()))
        G.gn_step_plain(frame, carry, None, fresh=True, **kw)


def _gn_edges(grams, damping, thr):
    """Does any step of the plain solve have a step norm within GN_EDGE of
    the threshold (solved again in float64 from each Gram, with gn_update's
    jitter)?"""
    for S in grams:
        S = S.astype(np.float64)
        H, g = S[:6, :6], S[:6, 6]
        Hj = H + (1e-6 * np.trace(H) / 6.0 + 1e-12) * np.eye(6)
        xi = damping * np.linalg.solve(Hj, g)
        if abs(np.linalg.norm(xi) - thr) <= GN_EDGE * thr:
            return True
    return False


def _track_pair(st, vol, geom, depth, seed, kw):
    """One frame solved by the kernel twice (bit for bit) and by the plain
    loop -> (kernel result, plain result, near a knife edge)."""
    import torch
    from psgradientsdf_tpu_torch.tracking import tracker as T

    zkw = st["zkw"]
    grams = []
    k = T.track_frame(vol, geom, depth, st["K"], seed, device=DEVICE, **zkw, **kw)
    again = T.track_frame(vol, geom, depth, st["K"], seed, device=DEVICE, **zkw, **kw)
    for a, b in zip(k, again):
        check(bool(torch.equal(a, b)), "gn_solve: two runs of a frame differ")
    p = T.run_gn_rounds_plain(vol, geom, depth, st["K"], seed, device=DEVICE,
                              on_gram=grams.append, **zkw, **kw)
    near = _gn_edges(torch.stack(grams).cpu().numpy(), kw["damping"],
                     kw["conv_threshold_sq"] ** 0.5)
    return k, p, near


def _compare_tracked(f, k, p, near, per_frame, checked):
    pk, pp = k.pose.cpu().numpy(), p.pose.cpu().numpy()
    row = dict(frame=f, iterations=[int(k.iterations), int(p.iterations)],
               converged=[bool(k.converged), bool(p.converged)],
               dt_m=float(np.abs(pk[:3, 3] - pp[:3, 3]).max()),
               dr_rad=_rot_angle(pk, pp), near_edge=near)
    per_frame.append(row)
    if row["iterations"][0] != row["iterations"][1]:
        check(near, f"frame {f}: {row['iterations'][0]} GN iterations on "
                    f"the kernel, {row['iterations'][1]} plain")
        return
    checked.append(f)
    check(row["converged"][0] == row["converged"][1],
          f"frame {f}: converged {row['converged']}")
    check(row["dt_m"] <= GN_POSE_TOL and row["dr_rad"] <= GN_POSE_TOL,
          f"frame {f}: poses differ by {row['dt_m']:.3g} m, "
          f"{row['dr_rad']:.3g} rad")


def _track_configs(st, vol, geom, name):
    """The FRAMES frames tracked on the volume fused at every generating
    pose, each from the previous frame's generating pose, under the named
    configuration: the kernel twice (bit for bit) and the plain loop;
    iterations equal except on frames near a knife edge (_gn_edges,
    listed); the poses of the frames with equal iterations within
    GN_POSE_TOL metres and radians -> dict."""
    kw = dict(_solve_kw(name), stride=1)
    per_frame, checked = [], []
    for f in range(FRAMES):
        k, p, near = _track_pair(st, vol, geom, st["depths"][f],
                                 st["gt"][max(f - 1, 0)], kw)
        _compare_tracked(f, k, p, near, per_frame, checked)
    return dict(
        frames=FRAMES, frames_checked=len(checked), bit_identical_runs=True,
        near_edge_frames=[r["frame"] for r in per_frame if r["near_edge"]],
        iterations_differ=[r["frame"] for r in per_frame
                           if r["iterations"][0] != r["iterations"][1]],
        max_dt_m=max(per_frame[f]["dt_m"] for f in checked),
        max_dr_rad=max(per_frame[f]["dr_rad"] for f in checked),
        mean_iterations=float(np.mean([r["iterations"][0] for r in per_frame])),
        tolerance=GN_POSE_TOL, per_frame=per_frame)


def _big_frame(st, vol, f):
    """Frame f at 1280x960 (each pixel twice in each direction, the
    intrinsics doubled), where a tile's records do not fit in shared memory
    and go to the [N, 8] buffer: one fresh and one frozen step's S within
    GN_S_TOL, and the STREAMING solve (two runs bit for bit) against the
    plain one -> dict."""
    from psgradientsdf_tpu_torch.ops import gn as G

    geom, zkw = st["geom"], st["zkw"]
    depth = st["depths"][f].repeat_interleave(2, 0).repeat_interleave(2, 1)
    K = st["K"].clone()
    K[0, 0], K[1, 1] = 2 * K[0, 0], 2 * K[1, 1]
    K[0, 2], K[1, 2] = 2 * K[0, 2] + 0.5, 2 * K[1, 2] + 0.5
    big = dict(st, K=K)
    frame = G.GnFrame(geom, depth, K, stride=1, zmin=zkw["zmin"], zmax=zkw["zmax"],
                      vol=vol)
    seed = st["gt"][f - 1]
    out = dict(frame=f, height=int(depth.shape[0]), width=int(depth.shape[1]))
    if DEVICE == "cuda":
        blocks, on_chip = G.solve_plan(frame.device, frame.n, 4)
        check(not on_chip, "the 1280x960 frame's records stayed on chip")
        out.update(blocks=blocks, records_on_chip=on_chip)
    out.update(_gn_step_checks(frame, seed, dict(conv_threshold_sq=0.0,
                                                 damping=st["gn"]["damping"])))
    per_frame, checked = [], []
    k, p, near = _track_pair(big, vol, geom, depth, seed,
                             dict(_solve_kw("STREAMING"), stride=1))
    _compare_tracked(f, k, p, near, per_frame, checked)
    out.update(config="STREAMING", tracked=per_frame[0], bit_identical_runs=True)
    return out


def _update_variants(st):
    """fuse_rows against its plain version, bit for bit, on the paths of the
    callers that the row cases of _update_case do not take: the whole grid
    in place (a row a slot, rows None; SoA and packed), a contiguous Z-slab
    (z0), interleaved planes (z_map), S-voxel segments (NS > 1, the
    resident rows), one gate a slot and a scalar gate; frame 24 at its
    generating pose on the 128^3 volume fused over frames 0-23 -> the cases
    checked."""
    import torch
    from psgradientsdf_tpu_torch.core import volume as V
    from psgradientsdf_tpu_torch.ops import fuse as F

    geom, f = st["geom"], 24
    X, Y, Z = geom.dims
    vol = _gt_loop(st, range(f), "soa", st["cap"])
    packed = V.PackedVolume.from_volume(vol)
    depth, K, pose = st["depths"][f], st["K"], st["gt"][f]
    word, bit = V._vis_word_bit(f)
    pix = V.pack_pixel_payload(st["colors"][f], depth, st["normals"][f],
                               st["n_sq_inv"])
    kw = dict(geom=geom, cos_thresh_sq=0.25 * 0.25, **st["zkw"])
    act = V._row_activity(geom, depth, K, pose, **st["zkw"])
    idx, live, _ = V._compact_padded(act.reshape(-1), st["cap"])
    n = int(live)
    NS, S = 4, X // 4

    def soa(sel):
        """The SoA fields of grid rows `sel` (row ids, or every row) as
        [R, X] copies -> (tensors, fuse_rows' fields)."""
        t = [vol.dist.view(Z * Y, X)[sel].clone(),
             vol.grad.view(Z * Y, X, 3)[sel].clone(),
             vol.weight.view(Z * Y, X)[sel].clone(),
             vol.color.view(Z * Y, X, 3)[sel].clone(),
             vol.vis[word].view(Z * Y, X)[sel].clone()]
        return t, t

    def segments():
        r = seg_rows.long()
        t = [vol.dist.view(-1, S)[r].clone(), vol.grad.view(-1, S, 3)[r].clone(),
             vol.weight.view(-1, S)[r].clone(), vol.color.view(-1, S, 3)[r].clone(),
             vol.vis[word].view(-1, S)[r].clone()]
        return t, t

    def packed_grid():
        p8 = packed.payload.clone().view(Z * Y, X, 8)
        v = packed.vis[word].clone().view(Z * Y, X)
        return [p8, v], (p8[..., 0], p8[..., 1:4], p8[..., 4], p8[..., 5:8], v)

    def rows_of(planes):
        return (planes[:, None] * Y + torch.arange(Y, device=DEVICE)).reshape(-1)

    z0 = Z // 4
    planes_z0 = torch.arange(z0, 2 * z0, device=DEVICE)
    planes_map = torch.arange(3, Z, 4, device=DEVICE)
    # the segments of the live rows, then 7 padding slots that repeat slot 0
    seg_rows = (idx[:n, None].long() * NS + torch.arange(NS, device=DEVICE)).reshape(-1)
    seg_rows = torch.cat([seg_rows, seg_rows[:1].expand(7)]).to(torch.int32)
    culled = dict(S=X, rows=idx, live=live)
    cases = {
        "whole grid SoA": (lambda: soa(slice(None)), None, dict(S=X)),
        "whole grid packed": (packed_grid, None, dict(S=X)),
        "z0 slab": (lambda: soa(rows_of(planes_z0)), None, dict(S=X, z0=z0)),
        "z_map planes": (lambda: soa(rows_of(planes_map)), None,
                         dict(S=X, z_map=planes_map.to(torch.int32))),
        "segments NS=4": (segments, None, dict(
            S=S, NS=NS, rows=seg_rows, live=torch.tensor(n * NS, device=DEVICE))),
        "slot gate": (lambda: soa(idx.long()),
                      torch.arange(idx.shape[0], device=DEVICE) % 3 != 0, culled),
        "scalar gate false": (lambda: soa(idx.long()),
                              torch.tensor(False, device=DEVICE), culled),
        "scalar gate true": (lambda: soa(idx.long()),
                             torch.tensor(True, device=DEVICE), culled),
    }
    done = []
    for name, (make, gate, extra) in cases.items():
        (got, fg), (want, fw) = make(), make()
        F.fuse_rows(*fg, pix, K, pose, tuple(depth.shape), bit, gate, **kw, **extra)
        F.fuse_rows_plain(*fw, pix, K, pose, tuple(depth.shape), bit, gate,
                          **kw, **extra)
        _sync()
        for a, b in zip(got, want):
            check(_bits_equal(a, b), f"fuse_rows differs from its plain version: "
                                     f"{name}, by up to {_abs_err(a, b)}")
        done.append(name)
    return dict(frame=f, grid=X, cases=done, bit_identical=True)


def _path_ms(fns):
    """Device ms of each of `fns` run back to back in this order, as the
    path runs them, KERNEL_REPS times: behind a spin kernel that keeps the
    card busy while the host enqueues them, so the events between them time
    the device alone, and with no flush (the L2 holds what the path leaves,
    not a flush's dirty lines) -> [median ms of each]."""
    import torch

    for _ in range(3):
        for fn in fns:
            fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
    times = [[] for _ in fns]
    for _ in range(KERNEL_REPS):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        events[0].record()
        for fn, ev in zip(fns, events[1:]):
            fn()
            ev.record()
        torch.cuda.synchronize()
        for i, t in enumerate(times):
            t.append(events[i].elapsed_time(events[i + 1]))
    return [statistics.median(t) for t in times]


def _compaction_checks(what, flat, cap):
    """compact_active and compact_padded (the kernel without its cull: one
    launch of cull_compact_kernel<false> each) against their plain versions
    at capacity `cap`: indices, n_active, live and overflow equal, and each
    kernel twice bit for bit."""
    import torch
    from psgradientsdf_tpu_torch.ops import cull as C

    n = int(flat.sum())
    got = C.compact_active(flat, cap)
    again = C.compact_active(flat, cap)
    want = C.compact_active_plain(flat, cap)
    for a, b, c in zip(got, again, want):
        check(torch.equal(a, c) and torch.equal(a, b),
              f"compact_active differs from its plain version or between two "
              f"runs: {what}, capacity {cap}")
    if cap == 0 and DEVICE == "cpu":
        return               # the plain version reads slot 0, which is missing
    got = C.compact_padded(flat, cap)
    again = C.compact_padded(flat, cap)
    if cap > 0:
        want = C.compact_padded_plain(flat, cap)
    else:
        # the plain version reads slot 0, which a capacity of 0 lacks
        want = (torch.zeros(0, dtype=torch.int32, device=flat.device),
                torch.tensor(max(n, 1), device=flat.device),
                torch.tensor(n > 0, device=flat.device))
    for a, b, c in zip(got, again, want):
        check(torch.equal(a, c) and torch.equal(a, b),
              f"compact_padded differs from its plain version or between two "
              f"runs: {what}, capacity {cap}")
    check(int(got[1]) == max(n, 1) and bool(got[2]) == (n > cap),
          f"compact_padded's live or overflow: {what}, capacity {cap}")


def _merged_checks(what, geom, depths, K, poses, kw, cap, padded, gates, allow):
    """One cull_compact launch (mask=True) against cull_compact_plain on the
    same inputs: the mask, the indices, n_active, live and overflow bit for
    bit, and two launches bit for bit -> the plain version's result."""
    import torch
    from psgradientsdf_tpu_torch.ops import cull as C

    args = dict(capacity=cap, padded=padded, gates=gates, allow=allow, mask=True, **kw)
    runs = [C.cull_compact(geom, depths, K, poses, **args) for _ in range(2)]
    _sync()
    want = C.cull_compact_plain(geom, depths, K, poses, **args)
    for field in want._fields:
        a, b, c = (getattr(r, field) for r in (runs[0], runs[1], want))
        check(torch.equal(a, b), f"cull_compact: two runs differ in {field}: {what}, "
                                 f"capacity {cap}, padded {padded}")
        check(a.dtype == c.dtype and torch.equal(a, c),
              f"cull_compact's {field} differs from its plain version: {what}, "
              f"capacity {cap}, padded {padded}"
              + (f", {int((a != c).sum())} of {c.numel()} entries"
                 if a.shape == c.shape else ""))
    return want


def _cull_case(what, geom, depth, K, pose, kw, caps=(), gate=None, allow=None):
    """cull_compact (the cull and the compaction in ONE launch; K frames
    where depth is [K, H, W] and pose [K, 4, 4], each ANDed with its gate)
    against cull_compact_plain on the card at each capacity (`caps`;
    callables of the active count), under both padding contracts
    (_merged_checks); then the same mask through row_activity (one frame:
    the kernel writing its mask alone) and through compact_active /
    compact_padded (the kernel without its cull) -> dict."""
    import torch
    from psgradientsdf_tpu_torch.ops import cull as C

    frames = 1 if depth.dim() == 2 else depth.shape[0]
    want = C.cull_compact_plain(geom, depth, K, pose, capacity=0, padded=False,
                                gates=gate, allow=allow, mask=True, **kw)
    n = int(want.n_active)
    done = sorted({max(0, c(n) if callable(c) else c) for c in caps})
    for cap in done:
        for padded in (True, False):
            _merged_checks(what, geom, depth, K, pose, kw, cap, padded, gate, allow)
    flat = want.mask.reshape(-1)
    if depth.dim() == 2 and allow is None:
        got = C.row_activity(geom, depth, K, pose, gate=gate, **kw)
        _sync()
        check(torch.equal(got, want.mask), f"row_activity differs from its plain "
                                           f"version: {what}")
    for cap in done:
        _compaction_checks(what, flat, cap)
    return dict(case=what, frames=frames, entries=flat.numel(), active=n,
                capacities=done, allow=allow is not None)


def _log2_spans():
    """floor(log2(float(span)) + 1e-6) on the card, as the plain cull takes
    its table level, against bit_length(span) - 1 (the kernel's 31 -
    clz(span)) for every span up to 4096 -> the spans checked."""
    import torch

    span = torch.arange(1, 4097, dtype=torch.int32, device=DEVICE)
    k = torch.floor(torch.log2(span.to(torch.float32)) + 1e-6).to(torch.int64).cpu()
    want = torch.tensor([int(s).bit_length() - 1 for s in range(1, 4097)])
    check(torch.equal(k, want), "floor(log2(span) + 1e-6) != bit_length(span) - 1 "
                                "on the card")
    return 4096


def _cull_times(what, geom, depths, K, poses, kw, cap, gates, flush):
    """One culled fusion's cull and compaction (cull_compact, one launch),
    timed in the path's order (_path_ms: behind the spin, no flush) and
    after _time_ms's flush, beside its plain version, its byte bound (the K
    depth images read once, the int32 slots and the scalars written once),
    empty cooperative launches of its grid and shared memory crossing two
    grid barriers (its floor) and one, and torch.nonzero over its mask (the
    compaction's one-call yardstick, which reads the count back to the host)
    -> dict."""
    import torch
    from psgradientsdf_tpu_torch.kernels import sm_count
    from psgradientsdf_tpu_torch.ops import cull as C

    frames = 1 if depths.dim() == 2 else depths.shape[0]
    H, W = depths.shape[-2:]
    dev = depths.device
    args = dict(capacity=cap, padded=True, gates=gates, **kw)

    def merged():
        return C.cull_compact(geom, depths, K, poses, **args)

    mask = C.cull_compact(geom, depths, K, poses, **dict(args, capacity=0),
                          mask=True).mask.reshape(-1)
    n_seg, n = mask.numel(), int(mask.sum())
    blocks = C.cull_compact_blocks(H, frames, n_seg, sm_count(dev))
    smem = C.cull_compact_smem(H, frames, n_seg, blocks)
    floors = _path_ms([lambda: C.barrier_floor(dev, blocks, smem, 2),
                       lambda: C.barrier_floor(dev, blocks, smem, 1)])
    out = dict(case=what, frames=frames, entries=n_seg, active=n, capacity=cap,
               ms=_path_ms([merged])[0], ms_after_flush=_time_ms(merged, flush),
               plain_ms=_time_ms(lambda: C.cull_compact_plain(
                   geom, depths, K, poses, **args), flush),
               bound_ms=(frames * H * W * 4 + cap * 4 + 17) / HBM_BYTES_PER_S * 1e3,
               latency_floor_ms=floors[0], one_barrier_floor_ms=floors[1],
               blocks=blocks, shared_bytes=smem,
               frames_per_pass=C.cull_compact_pass(H, frames, n_seg, blocks),
               library_ms=_time_ms(lambda: torch.nonzero(mask), flush))
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


class _ParentCullArgs(ctypes.Structure):
    """The CullArgs of PR 21-25's csrc/cull.cu (row_activity), for
    --cull-parent."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("depth", "K", "pose", "z_map", "gate", "out", "row_max")]
        + [(n, ctypes.c_int64) for n in
           ("H", "W", "levels", "z_rows", "Y", "S", "NS", "has_z0", "accumulate")]
        + [(n, ctypes.c_double) for n in
           ("z0", "origin_x", "origin_y", "origin_z", "voxel", "truncation",
            "zmin", "zmax", "margin_px", "margin_t")])


class _ParentCompactArgs(ctypes.Structure):
    """The CompactArgs of PR 21-25's csrc/cull.cu (compact_rows)."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("flags", "idx", "scalars", "overflow", "part")]
        + [(n, ctypes.c_int64) for n in ("n", "capacity", "idx64", "padded", "blocks")])


def _parent_pair(lib, geom, depths, K, poses, kw, cap, gates):
    """PR 21-25's launches of a culled fusion through an earlier cull.cu of
    that C interface: a row_activity a frame (ORed into the first one's
    mask) and one compact_rows, each with its wrapper's allocations and its
    own block plan -> a list of the calls, which return (mask, idx,
    scalars, overflow) at the last."""
    import torch
    from psgradientsdf_tpu_torch.kernels import sm_count
    from psgradientsdf_tpu_torch.ops import cull as C

    dev = depths.device
    depths3 = depths if depths.dim() == 3 else depths[None]
    poses3 = poses if poses.dim() == 3 else poses[None]
    gates1 = None if gates is None else gates.reshape(-1)
    H, W = depths3.shape[1:]
    X, Y, Z = geom.dims
    sms = sm_count(dev)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    state = {}

    def cull(k):
        def fn():
            out = state["mask"] if k else torch.empty((Z, Y), dtype=torch.bool, device=dev)
            row_max = torch.empty(H, dtype=torch.float32, device=dev)
            a = _ParentCullArgs()
            a.depth, a.K, a.pose = (depths3[k].data_ptr(), K.data_ptr(),
                                    poses3[k].data_ptr())
            a.z_map = None
            a.gate = None if gates1 is None else gates1[k:k + 1].data_ptr()
            a.out, a.row_max = out.data_ptr(), row_max.data_ptr()
            a.H, a.W, a.levels, a.z_rows, a.Y, a.S, a.NS = (
                H, W, C.table_levels(H), Z, Y, X, 1)
            a.has_z0, a.z0, a.accumulate = 0, 0.0, int(k > 0)
            a.origin_x, a.origin_y, a.origin_z = geom.origin
            a.voxel, a.truncation, a.zmin, a.zmax = (
                geom.voxel_size, kw["truncation"], kw["zmin"], kw["zmax"])
            a.margin_px, a.margin_t = 0.0, 0.0
            blocks = max(1, min(sms, max(-(-H // 16), -(-(Z * Y) // 512))))
            rc = lib.row_activity(ctypes.byref(a), blocks, stream())
            check(rc == 0, f"the parent's row_activity: CUDA error {rc}")
            state["mask"] = out
        return fn

    def compact():
        flat = state["mask"].reshape(-1)
        n = flat.numel()
        blocks = max(1, min(sms, -(-(-(-n // 32)) // 16)))
        idx = torch.empty(cap, dtype=torch.int32, device=dev)
        scalars = torch.empty(2, dtype=torch.int64, device=dev)
        overflow = torch.empty((), dtype=torch.bool, device=dev)
        part = torch.empty(2 * blocks, dtype=torch.int32, device=dev)
        a = _ParentCompactArgs()
        a.flags, a.idx, a.scalars, a.overflow, a.part = (
            flat.data_ptr(), idx.data_ptr(), scalars.data_ptr(),
            overflow.data_ptr(), part.data_ptr())
        a.n, a.capacity, a.idx64, a.padded, a.blocks = n, cap, 0, 1, blocks
        rc = lib.compact_rows(ctypes.byref(a), stream())
        check(rc == 0, f"the parent's compact_rows: CUDA error {rc}")
        return state["mask"], idx, scalars, overflow

    return [cull(k) for k in range(depths3.shape[0])] + [compact]


def _cull_parent_ab(cases, flush):
    """cull_compact on this cull.cu against PR 21-25's pair on the
    --cull-parent source (built here into a temporary directory; its
    launches on no path and not counted): the parent's mask, indices,
    n_active, live and overflow bit for bit with the merged launch's, then
    both timed in turns in the path's order (_path_ms): this, the parent,
    the parent, this -> {case: {"this": [ms, ms], "parent": [ms, ms],
    "parent_launches": [ms of each, first turn]}}."""
    import torch
    from psgradientsdf_tpu_torch.ops import cull as C

    src = sys.argv[sys.argv.index("--cull-parent") + 1]
    out = {}
    with tempfile.TemporaryDirectory(prefix="cull_parent_") as tmp:
        parent = _parent_build(src, tmp, "cull_parent")
        parent.row_activity.argtypes = [ctypes.POINTER(_ParentCullArgs), ctypes.c_int,
                                        ctypes.c_void_p]
        parent.compact_rows.argtypes = [ctypes.POINTER(_ParentCompactArgs), ctypes.c_void_p]
        for what, geom, depths, K, poses, kw, cap, gates in cases:
            calls = _parent_pair(parent, geom, depths, K, poses, kw, cap, gates)
            for fn in calls:
                res = fn()
            mask, idx, scalars, overflow = res
            this = C.cull_compact(geom, depths, K, poses, capacity=cap, padded=True,
                                  gates=gates, mask=True, **kw)
            _sync()
            check(torch.equal(mask, this.mask) and torch.equal(idx, this.idx)
                  and int(scalars[0]) == int(this.n_active)
                  and int(scalars[1]) == int(this.live)
                  and bool(overflow) == bool(this.overflow),
                  f"the parent's cull and compaction differ from cull_compact: {what}")
            times = {"this": [], "parent": []}
            for name in ("this", "parent", "parent", "this"):
                if name == "this":
                    times[name].append(_path_ms([lambda: C.cull_compact(
                        geom, depths, K, poses, capacity=cap, padded=True,
                        gates=gates, **kw)])[0])
                else:
                    parts = _path_ms(calls)
                    times.setdefault("parent_launches", parts)
                    times[name].append(sum(parts))
            out[what] = times
        torch.cuda.synchronize()
    return out


def _cull_kernels(st, flush):
    """The culled fusion's cull and compaction (csrc/cull.cu, ONE launch of
    cull_compact) against cull_compact_plain on the card, bit for bit
    (_cull_case): the FRAMES frames at their generating poses (each at the
    fusion's capacity, at its active count and one less: an overflow),
    frame 24 at 1280x960, 512^3 rows, seg_x = 8, four contiguous slabs (z0)
    and four interleaved ones (z_idx), the resident margins (rows and
    segments), a gate that is False, a frame with no valid depth (0 active)
    and one with NaN depths, a pose that puts the grid behind the camera and
    one inside it (mixed rows), the K-frame unions of frames 1..k for k = 1
    .. PACKED_K in one launch each (gated), resident_alloc's `allow` (the
    rows that hold no slot) and a count at capacity 0; the table level on
    the card for every span up to 4096; times of frame 24 at 128^3 and of
    the 512^3, 1280x960 and K = PACKED_K cases (_cull_times); with
    --cull-parent the main and 512^3 cases in turns with PR 21-25's pair
    (_cull_parent_ab) -> facts.  Launches made here are on no path."""
    import torch
    from psgradientsdf_tpu_torch.core.grid import GridGeometry

    geom, zkw, K = st["geom"], st["zkw"], st["K"]
    X, Y, Z = geom.dims
    cap = st["cap"]
    caps = (cap, lambda n: n, lambda n: n - 1)
    f = 24
    depth, pose = st["depths"][f], st["gt"][f]
    true = torch.tensor(True, device=DEVICE)
    cases = []
    for g in range(FRAMES):
        cases.append(_cull_case(f"frame {g}", geom, st["depths"][g], K, st["gt"][g],
                                zkw, caps, gate=true))
    # the 1280x960 frame: each pixel twice in each direction, K doubled
    big_depth = depth.repeat_interleave(2, 0).repeat_interleave(2, 1)
    big_K = K.clone()
    big_K[0, 0], big_K[1, 1] = 2 * K[0, 0], 2 * K[1, 1]
    big_K[0, 2], big_K[1, 2] = 2 * K[0, 2] + 0.5, 2 * K[1, 2] + 0.5
    cases.append(_cull_case("frame 24 at 1280x960", geom, big_depth, big_K, pose,
                            zkw, caps))
    big = GridGeometry(dims=(PACKED_BIG_GRID,) * 3,
                       voxel_size=geom.voxel_size * X / PACKED_BIG_GRID,
                       shift=geom.shift)
    big_kw = dict(zkw, truncation=st["truncation"] * X / PACKED_BIG_GRID)
    big_cap = cap * PACKED_BIG_GRID ** 2 // (X * Y)
    for g in (0, f):
        cases.append(_cull_case(f"frame {g} at {PACKED_BIG_GRID}^3", big,
                                st["depths"][g], K, st["gt"][g], big_kw,
                                (big_cap, lambda n: n)))
    cases.append(_cull_case("seg_x 8", geom, depth, K, pose, dict(zkw, seg_x=8),
                            (8 * cap, lambda n: n, lambda n: n - 1)))
    cases.append(_cull_case(f"seg_x 64 at {PACKED_BIG_GRID}^3", big, depth, K, pose,
                            dict(big_kw, seg_x=64), (lambda n: n,)))
    Zl = Z // 4
    for k in range(4):
        cases.append(_cull_case(f"slab z0={k * Zl}", geom, depth, K, pose,
                                dict(zkw, z0=k * Zl, z_rows=Zl), (cap // 4, lambda n: n)))
        planes = torch.arange(k, Z, 4, dtype=torch.int32, device=DEVICE)
        cases.append(_cull_case(f"interleaved slab {k}", geom, depth, K, pose,
                                dict(zkw, z_rows=Zl, z_idx=planes),
                                (cap // 4, lambda n: n)))
    margins = dict(margin_px=RESIDENT_MARGIN[0], margin_t=RESIDENT_MARGIN[1])
    cases.append(_cull_case("resident margins", geom, depth, K, pose,
                            dict(zkw, **margins), (cap, lambda n: n)))
    cases.append(_cull_case("resident margins, seg_x 8", geom, depth, K, pose,
                            dict(zkw, seg_x=8, **margins), (lambda n: n,)))
    cases.append(_cull_case("gate False", geom, depth, K, pose, zkw, (cap, 0),
                            gate=torch.tensor(False, device=DEVICE)))
    cases.append(_cull_case("no valid depth", geom, torch.zeros_like(depth), K, pose,
                            zkw, (cap, 0, 1)))
    holes = depth.clone()
    holes[100:140, :] = float("nan")
    holes[:, 300:310] = float("nan")
    cases.append(_cull_case("NaN depths", geom, holes, K, pose, zkw, caps))
    behind = pose.clone()
    behind[:3, 2] = -behind[:3, 2]               # turned to look away
    behind[:3, 1] = -behind[:3, 1]
    cases.append(_cull_case("behind the camera", geom, depth, K, behind, zkw, (cap, 1)))
    inside = pose.clone()
    inside[:3, 3] = torch.tensor(geom.origin, device=DEVICE) + geom.voxel_size * X / 2
    cases.append(_cull_case("camera inside the grid", geom, depth, K, inside, zkw, caps))
    # fuse_frames_culled's union: frames 1..k in one launch, frame 2 gated off
    gates = torch.ones(PACKED_K, dtype=torch.bool, device=DEVICE)
    gates[1] = False
    for k in range(1, 1 + PACKED_K):
        b = list(range(1, 1 + k))
        cases.append(_cull_case(f"the union of frames 1-{k}", geom, st["depths"][b], K,
                                torch.stack([st["gt"][g] for g in b]), zkw, caps,
                                gate=gates[:k]))
    # resident_alloc's allow: the active rows that hold no resident slot
    rng = np.random.default_rng(SEED)
    allow = torch.from_numpy(rng.random(Z * Y) < 0.5).to(DEVICE)
    cases.append(_cull_case("allow (resident_alloc)", geom, depth, K, pose,
                            dict(zkw, **margins), (Z * Y // 4, lambda n: n,
                                                   lambda n: n - 1, 0), allow=allow))
    cases.append(_cull_case("capacity 0", geom, depth, K, pose, zkw, (0,)))
    facts = dict(cases=cases, n_cases=len(cases), spans_checked=_log2_spans(),
                 bit_identical=True)
    check(any(c["active"] == 0 for c in cases)
          and any(c["case"] == "camera inside the grid" and c["active"] > 0 for c in cases)
          and any(c["frames"] == PACKED_K for c in cases),
          "the cull cases miss the empty mask, the mixed rows or the K-frame union")
    if DEVICE == "cuda":
        facts["registers"] = _ptxas(os.path.join("psgradientsdf_tpu_torch", "csrc",
                                                 "cull.cu"))
        union = list(range(1, 1 + PACKED_K))
        union_depths = st["depths"][union]
        union_poses = torch.stack([st["gt"][g] for g in union])
        facts["times"] = [
            _cull_times(f"frame {f} at {X}^3, 640x480", geom, depth, K, pose, zkw,
                        cap, true, flush),
            _cull_times(f"frame {f} at {PACKED_BIG_GRID}^3", big, depth, K, pose,
                        big_kw, big_cap, true, flush),
            _cull_times(f"frame {f} at 1280x960", geom, big_depth, big_K, pose, zkw,
                        cap, true, flush),
            _cull_times(f"frames 1-{PACKED_K} at {X}^3 (one K-frame launch)", geom,
                        union_depths, K, union_poses, zkw, cap, None, flush)]
        if "--cull-parent" in sys.argv[1:]:
            facts["parent"] = _cull_parent_ab([
                (f"frame {f} at {X}^3, 640x480", geom, depth, K, pose, zkw, cap, true),
                (f"frame {f} at {PACKED_BIG_GRID}^3", big, depth, K, pose, big_kw,
                 big_cap, true),
                (f"frames 1-{PACKED_K} at {X}^3", geom, union_depths, K, union_poses,
                 zkw, cap, None)], flush)
    return facts


# ----------------------------------------------------------------- the scan


def write_config(path, out_dir, last, grid=None, refine=None, input_dir="",
                 config=None):
    grid = grid or GRID
    cfg = {
        "input": input_dir, "output": out_dir, "datatype": "tum",
        "pose filename": "",                 # no ground truth: tracking runs
        "first": 0, "last": last, "voxel size": VOXEL * GRID / grid,
        "truncation factor": 5,
        "zmin": 0.5, "zmax": 3.5, "sharpness threshold": 0.0,
        "grid dim": grid, "chunk size": CHUNK, "fuse rows": 0.5,
        "track config": "reference",
    }
    cfg.update(refine or {})
    cfg.update(config or {})
    with open(path, "w") as fh:
        json.dump(cfg, fh)


def _sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def run_scan(tmp, tag, seq, last, rows_impl, refine=None, grid=None,
             gt_poses=False, loader=None, config=None, tracker=None, **pipe_kw):
    """Drive ReconstructionPipeline.run over frames 0..last of `seq`; with
    `refine` (a dict of the recipe's optimizer keys) the refinement runs too.
    The frames come from memory unless a `loader` is given; `config` adds
    recipe keys ("mesh shape"); `tracker` names a configuration of
    tracking/configs.py to track with (the recipe names only three);
    `pipe_kw` (checkpoint_every, resume, mesh_devices, capture) go to the
    pipeline."""
    from psgradientsdf_tpu_torch.config import load_config
    from psgradientsdf_tpu_torch.pipeline import ReconstructionPipeline
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    K, colors, depths, poses = seq[:4]
    out_dir = os.path.join(tmp, tag) + "/"
    cfg_path = os.path.join(tmp, tag + ".json")
    write_config(cfg_path, out_dir, last, grid, refine, config=config)
    cfg = load_config(cfg_path)
    if tracker is not None:
        kw = _solve_kw(tracker)
        cfg.tracking.num_iterations = kw["num_iterations"]
        cfg.tracking.conv_threshold = kw["conv_threshold_sq"] ** 0.5
        cfg.tracking.damping = kw["damping"]
        cfg.tpu.track_regather = kw["regather_every"]
        cfg.tpu.track_static = not kw["early_exit"]
    pipe = ReconstructionPipeline(
        cfg, loader=loader or memory_loader(
            K, colors[: last + 1], depths[: last + 1],
            poses[: last + 1] if gt_poses else None),
        metrics=MetricsLogger(os.path.join(out_dir, "metrics.jsonl"), echo=False),
        device=DEVICE, rows_impl=rows_impl, **pipe_kw)
    _reset_row_counts()                      # just before the path is driven
    _reset_scan_counts()
    _reset_refine_counts()
    t0 = time.perf_counter()
    with _refine_calls() as refine_calls, _plain_cull_calls() as cull_calls, \
            _slice_calls() as slice_calls:
        summary = pipe.run(refine=refine is not None)
        _sync()
    seconds = time.perf_counter() - t0
    counts = _row_counts()                   # and read just after
    slice_facts = _check_slice(slice_calls, tag, pipe.refiner if refine is not None
                               and "resume" not in pipe_kw else None)
    check(cull_calls["plain_cull_on_card"] == 0,
          f"{tag}: {cull_calls['plain_cull_on_card']} plain culls or compactions "
          "ran on the card")
    scan_counts = _scan_counts()
    refine_counts = _refine_counts()
    with open(os.path.join(out_dir, "tracking_poses.txt")) as fh:
        pose_text = fh.read()
    with open(os.path.join(out_dir, "metrics.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    return dict(pipe=pipe, summary=summary, counts=counts,
                scan_counts=scan_counts, refine_counts=refine_counts,
                refine_calls=refine_calls, slice=slice_facts, seconds=seconds,
                out_dir=out_dir, pose_text=pose_text, events=events)


def check_scan(run, seq, n_frames):
    import torch
    from psgradientsdf_tpu_torch.io.trajectory import ate_rmse, read_trajectory

    pipe, summary, counts = run["pipe"], run["summary"], run["counts"]
    gt = seq[3][:n_frames]
    check(summary["frames"] == n_frames, f"frames {summary['frames']} != {n_frames}")
    log = summary["track_log"]
    check(len(log) == n_frames - 1, "one tracker record per tracked frame")
    lost = [r["frame"] for r in log if not r["converged"]]
    check(not lost, f"tracking did not converge on frames {lost}")
    check(all(r["valid"] > 0.5 * W * H for r in log), "too few valid pixels")
    check(not summary["vis_overflow"], "visibility capacity overflowed")
    calls = pipe.fuse_culled_calls
    check(calls >= n_frames - 1, f"{calls} culled fusions for {n_frames - 1} frames")

    vol = pipe.vol
    check(tuple(vol.dist.shape) == (GRID, GRID, GRID), "volume shape")
    for name, t in zip(vol._fields, vol):
        check(t.device.type == DEVICE, f"{name} is not on the card")
        if t.dtype.is_floating_point:
            check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")
    observed = float((vol.weight > 0).float().mean())
    check(observed > 0.05, f"only {observed:.3f} of the voxels were observed")
    # every fused frame left its visibility bit somewhere
    from psgradientsdf_tpu_torch.core.volume import vis_bit
    for f in range(n_frames):
        check(bool(vis_bit(vol.vis, f).any()), f"frame {f} left no visibility bit")

    stamps, est = read_trajectory(os.path.join(run["out_dir"], "tracking_poses.txt"))
    check(len(est) == n_frames, "tracking_poses.txt: one pose per frame")
    ate = ate_rmse(est, gt)
    check(ate < 0.5 * VOXEL, f"ATE-RMSE {ate * 1e3:.3f} mm is over half a voxel")
    final = np.abs(np.asarray(est[-1])[:3, 3] - gt[-1][:3, 3]).max()
    check(final < VOXEL, f"last pose is {final * 1e3:.2f} mm off")

    with open(os.path.join(run["out_dir"], "init_mesh.ply"), "rb") as fh:
        head = fh.read(400).decode("ascii", "replace")
    check(head.startswith("ply"), "init_mesh.ply is not a PLY file")
    n_vert = int(head.split("element vertex")[1].split()[0])
    n_face = int(head.split("element face")[1].split()[0])
    check(n_vert > 1000 and n_face > 1000, f"mesh too small: {n_vert}/{n_face}")
    for f in ("init_pointcloud.ply", "init_sdf.sdf"):
        check(os.path.getsize(os.path.join(run["out_dir"], f)) > 0, f + " is empty")
    return dict(ate_mm=ate * 1e3, culled_fusions=calls, observed_fraction=observed,
                mesh_vertices=n_vert, mesh_faces=n_face,
                mean_gn_iterations=float(np.mean([r["iters"] for r in log])))


# ----------------------------------------------------------- the refinement


def _ply_counts(path):
    with open(path, "rb") as fh:
        head = fh.read(600).decode("ascii", "replace")
    check(head.startswith("ply"), f"{path} is not a PLY file")
    n_vert = int(head.split("element vertex")[1].split()[0])
    n_face = (int(head.split("element face")[1].split()[0])
              if "element face" in head else 0)
    return n_vert, n_face


def _surface_error(refiner, prob, dist, grad_stored, gt0):
    """Mean |z - g(x, y)| in metres over the true surface voxels of the
    problem `prob` (whole, on one device) of the refiner, of the surface
    points x = c_v - d ghat made from `dist` and `grad_stored`, taken to the
    scene's frame by `gt0`."""
    import torch

    n = prob.n_surface
    g = grad_stored[:n]
    ghat = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True),
                           min=1e-12)
    pts = (refiner.geom.voxel2world(prob.idx_xyz[:n])
           - dist[:n, None] * ghat).double().cpu().numpy()
    pts = pts @ gt0[:3, :3].T + gt0[:3, 3]
    return float(np.mean(np.abs(pts[:, 2] - _g(pts[:, 0], pts[:, 1]))))


def _block_times(events):
    """Seconds per block name and per iteration, and CG steps per solve, from
    the refinement's `block` metrics."""
    blocks = [e for e in events if e["event"] == "block"]
    per_block, cg = {}, {}
    for e in blocks:
        per_block.setdefault(e["block"], []).append(e["seconds"])
        if "cg_steps" in e:
            cg.setdefault(e["block"], []).append(e["cg_steps"])
    iters = sorted({e["iter"] for e in blocks})
    per_iter = [sum(e["seconds"] for e in blocks if e["iter"] == i) for i in iters]
    return ({k: statistics.mean(v) for k, v in per_block.items()}, per_iter, cg)


def check_refine(run, seq, min_drop):
    """The refinement of `run`: finite energies, the PS energy down by at
    least `min_drop`, the loop's stop rule kept, refined poses and surface
    close to the scene, the refined artifacts written.  A refiner on a mesh
    is read through its gathered arrays."""
    import torch
    from psgradientsdf_tpu_torch.io.sdf_io import read_sdf
    from psgradientsdf_tpu_torch.io.trajectory import ate_rmse, read_trajectory

    pipe, summary, out = run["pipe"], run["summary"], run["out_dir"]
    ref = pipe.refiner
    check(ref is not None, "run(refine=True) made no refiner")
    trace = ref.energy_trace
    check(all(np.isfinite(list(v for v in r.values() if isinstance(v, float))).all()
              for r in trace), "a refinement energy is not finite")
    prob, dist, albedo, grad_stored, _ = ref.gathered(with_images=False)
    state = dict(dist=dist, albedo=albedo, grad_stored=grad_stored,
                 poses=ref.poses, lights=ref.lights)
    for name, t in state.items():
        check(t.device.type == DEVICE and bool(torch.isfinite(t).all()),
              f"refined {name} is off the card or not finite")
    ps0, ps1 = trace[0]["ps"], trace[-1]["ps"]
    check(ps1 < min_drop * ps0,
          f"PS energy {ps0:.5g} -> {ps1:.5g}: not below {min_drop} of the start")
    # the loop's own rule: an iteration that raises the total ends the run
    last_block = trace[-1]["block"]
    totals = [trace[0]["total"]] + [r["total"] for r in trace
                                    if r["block"] == last_block]
    rises = [i for i in range(1, len(totals)) if totals[i] > totals[i - 1]]
    check(not rises or (rises == [len(totals) - 1]
                        and summary["refine_stop"] == "diverged"),
          f"the total rose at iterations {rises} and the loop went on")
    check(summary["refine_iterations"] == len(totals) - 1, "iteration count")

    gt = seq[3]
    kf = ref.keyframe_indices
    ate = ate_rmse(list(ref.poses.cpu().numpy()), [gt[i] for i in kf])
    check(ate < 0.5 * VOXEL,
          f"refined keyframe poses: ATE {ate * 1e3:.3f} mm is over half a voxel")
    gt0 = seq[4]                  # the pipeline's frame is frame 0's camera
    err0 = _surface_error(ref, prob, prob.dist, prob.grad_stored, gt0)
    err1 = _surface_error(ref, prob, dist, grad_stored, gt0)
    check(err1 <= 1.10 * err0,
          f"surface error {err0 * 1e3:.3f} mm -> {err1 * 1e3:.3f} mm")

    mesh = _ply_counts(os.path.join(out, "final_refined_mesh.ply"))
    check(mesh[0] > 1000 and mesh[1] > 1000, f"refined mesh too small: {mesh}")
    cloud = _ply_counts(os.path.join(out, "final_refined_pointcloud.ply"))
    check(cloud[0] == prob.n_surface, "refined point cloud size")
    stamps, poses = read_trajectory(os.path.join(out, "final_refined_poses.txt"))
    check(len(poses) == len(kf), "final_refined_poses.txt: one pose per keyframe")
    sdf, _, h = read_sdf(os.path.join(out, "final_refined_sdf.sdf"))
    check(sdf.size > 1000 and np.isfinite(sdf).all()
          and abs(h - ref.geom.voxel_size) < 1e-6, "final_refined_sdf.sdf")

    per_block, per_iter, cg = _block_times(run["events"])
    dumps = [e["seconds"] for e in run["events"] if e["event"] == "artifact_dump"]
    by_iter = {}
    for e in run["events"]:
        if e["event"] == "block":
            by_iter.setdefault(e["iter"], {})[e["block"]] = e["seconds"]
    return dict(
        surface_voxels=prob.n_surface, capacity=int(prob.valid.shape[0]),
        keyframes=len(kf), iterations=summary["refine_iterations"],
        stopped=summary["refine_stop"],
        energy_trace=[dict(iter=r["iter"], block=r["block"], total=r["total"],
                           ps=r["ps"]) for r in trace],
        ps_energy_ratio=ps1 / ps0, seconds_per_block=per_block,
        seconds_per_iteration=per_iter,
        seconds_by_iteration_and_block=[by_iter[i] for i in sorted(by_iter)],
        cg_steps=cg, artifact_dump_seconds=dumps,
        # the initial export's writer thread, which overlaps the refinement
        export_thread_seconds=[e["seconds"] for e in run["events"]
                               if e["event"] == "export"],
        refine_seconds=summary["refine_seconds"],
        peak_memory_bytes=summary["refine_peak_memory_bytes"],
        keyframe_ate_mm=ate * 1e3, surface_error_mm=[err0 * 1e3, err1 * 1e3],
        refined_mesh_vertices=mesh[0], refined_mesh_faces=mesh[1])


def check_refine_launches(run):
    """The refinement of `run` went through its nine kernels: a residual
    pass launch for each residual pass the loop made (the LED light's
    initialisation, one before the loop, then a fused iteration's leading
    pass and one after each block, and one at the upsample), a distance
    Jacobian launch for each distance or joint block, a dist_system and a
    dist_cg launch for each distance block, a pose_normal_eqs call for each
    pose block, a light_normal_eqs_sh and a light_solve call for each SH
    light block, an albedo_block launch for each albedo block (a graphed
    loop's replays count as its capture's calls and launches); no plain
    residual pass, distance solve, normal equations, albedo or light solve
    on the card -> the launches."""
    from psgradientsdf_tpu_torch.refine.optimizer import block_names

    ref, summary = run["pipe"].refiner, run["summary"]
    cfg = ref.cfg
    names = block_names(cfg.opt_light, cfg.opt_albedo, cfg.opt_distance,
                        cfg.opt_pose, cfg.joint_dp)
    iters = summary["refine_iterations"]
    upsampled = sum(1 for r in ref.energy_trace if r["block"] == "upsample")
    # the LED light's initialisation makes one more
    passes = 1 + (cfg.model == "LED") + iters * (1 + len(names)) + upsampled
    jacobians = iters * sum(1 for n in names if n in ("distance", "joint_dp"))
    calls, launches = run["refine_calls"], run["refine_counts"]
    check(calls["residual_pass"] == passes
          and launches["residual_pass"] == _on_card(passes),
          f"residual_pass: {launches['residual_pass']} launches, "
          f"{calls['residual_pass']} passes, expected {passes}")
    check(calls["dist_jacobian"] == jacobians
          and launches["dist_jacobian"] == _on_card(jacobians),
          f"dist_jacobian: {launches['dist_jacobian']} launches, "
          f"{calls['dist_jacobian']} calls, expected {jacobians}")
    check(calls["plain_residual_pass_on_card"] == 0,
          f"{calls['plain_residual_pass_on_card']} plain residual passes on the card")
    blocks = iters * names.count("distance")
    for name in DIST_KERNELS:
        check(calls[name] == blocks and launches[name] == _on_card(blocks),
              f"{name}: {launches[name]} launches, {calls[name]} calls, "
              f"expected {blocks} distance blocks")
    check(calls["plain_distance_solve_on_card"] == 0,
          f"{calls['plain_distance_solve_on_card']} plain distance solves on the card")
    pose_blocks = iters * names.count("pose")
    sh_light_blocks = iters * names.count("light") * (cfg.model != "LED")
    for name, want in (("pose_normal_eqs", pose_blocks),
                       ("light_normal_eqs_sh", sh_light_blocks)):
        check(calls[name] == want and launches[name] == _on_card(want),
              f"{name}: {launches[name]} launches, {calls[name]} calls, "
              f"expected {want} blocks")
    check(calls["plain_normal_eqs_on_card"] == 0,
          f"{calls['plain_normal_eqs_on_card']} plain normal equations on the card")
    # an SH light block's eigen-solve: one light_solve launch, no plain
    # (torch.linalg.eigh) solve on the card
    for name in SOLVE_KERNELS:
        check(calls[name] == sh_light_blocks and launches[name] == _on_card(sh_light_blocks),
              f"{name}: {launches[name]} launches, {calls[name]} calls, "
              f"expected {sh_light_blocks} SH light blocks")
    check(calls["plain_light_solve_on_card"] == 0,
          f"{calls['plain_light_solve_on_card']} plain light solves on the card")
    albedo_blocks = iters * names.count("albedo")
    for name in ALBEDO_KERNELS:
        check(calls[name] == albedo_blocks and launches[name] == _on_card(albedo_blocks),
              f"{name}: {launches[name]} launches, {calls[name]} calls, "
              f"expected {albedo_blocks} albedo blocks")
    check(calls["plain_albedo_solve_on_card"] == 0,
          f"{calls['plain_albedo_solve_on_card']} plain albedo solves on the card")
    # run_scan held energy_sums launches = energy evaluations, and the
    # distance tail's and the LED light's launches (_check_slice)
    sl = run["slice"]
    check(sl["energy_evaluations"] == passes - (cfg.model == "LED"),
          f"{sl['energy_evaluations']} energy evaluations, {passes} residual passes")
    led_light_blocks = iters * names.count("light") * (cfg.model == "LED")
    # one card: the standalone tail kernels only in joint blocks, a distance
    # block's tail a stage of its dist_system and dist_cg launches
    joint = jacobians - blocks
    check(sl["distance_step_calls"] == blocks,
          f"{sl['distance_step_calls']} fused distance steps, {blocks} distance blocks")
    # one card: the loop replays one CUDA graph an iteration, captured once
    # and again after the upsample
    loops = [e for e in run["events"] if e["event"] == "refine_loop"]
    captures = sum(1 for e in run["events"] if e["event"] == "refine_graph")
    want_loop = "graph" if DEVICE == "cuda" else "eager"
    check(len(loops) == 1 and loops[0]["loop"] == want_loop
          and captures == _on_card(1 + upsampled),
          f"the refinement's loop {loops}, {captures} graphs captured")
    for name, want in (("reg_operators", joint), ("dist_update", joint),
                       ("light_normal_eqs_led", led_light_blocks)):
        check(sl[name] == _on_card(want),
              f"{name}: {sl[name]} launches, expected {want} blocks")
    return dict(launches, loop=loops[0]["loop"], graphs_captured=captures,
                residual_passes=passes, distance_blocks=blocks,
                distance_or_joint_blocks=jacobians, pose_blocks=pose_blocks,
                sh_light_blocks=sh_light_blocks, albedo_blocks=albedo_blocks,
                led_light_blocks=led_light_blocks,
                fused_distance_steps=sl["distance_step_calls"],
                energy_sums=sl["energy_sums"], energy_evaluations=sl["energy_evaluations"],
                **{name: sl[name] for name in TAIL_KERNELS})


def _one_iteration(ref):
    """One fused iteration (all blocks) from the refiner's state, which is
    left as it was -> (dist, albedo, grad_stored, poses, lights, energies)."""
    from psgradientsdf_tpu_torch.refine.optimizer import _iteration_core

    cfg = ref.cfg
    return _iteration_core(
        *ref._args(), **ref._static_kwargs(), reg_weight_n=cfg.reg_weight_n,
        reg_weight_l=cfg.reg_weight_l, reg_weight_rho=cfg.reg_weight_rho,
        damping=cfg.damping, laplacian_diag_only=False, do_light=True,
        do_albedo=True, do_distance=True, do_pose=True, joint_dp=False,
        stencil=ref.stencil)


def refine_parity(scan, refine_cfg):
    """One refinement iteration on the card against the same iteration on the
    CPU, from the volume and keyframes of the scan `scan`.  The CPU run is
    asked for here, by name: it is the comparison, not a way round the card.
    Indices and masks must be equal; the updated state and the energies must
    agree within PARITY_TOL, relative to each tensor's largest magnitude
    (the sums over voxels and frames run in another order on the card, and
    its scatter-adds are atomic)."""
    import torch
    from psgradientsdf_tpu_torch.core.volume import GradSdfVolume
    from psgradientsdf_tpu_torch.pipeline import keyframe_sample_positions
    from psgradientsdf_tpu_torch.refine.optimizer import PhotometricRefiner
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    pipe = scan["pipe"]
    pos = keyframe_sample_positions(len(pipe.key_indices), PARITY_KEYFRAMES)
    kf = [pipe.key_indices[i] for i in pos]
    poses = np.stack([pipe.key_poses[i] for i in pos])
    images = torch.stack([pipe.key_images_dev[i] for i in pos])

    def refiner(device):
        vol = GradSdfVolume(*(t.to(device) for t in pipe.vol))
        ref = PhotometricRefiner(vol, pipe.geom, refine_cfg, pipe.K,
                                 truncation=pipe.cfg.truncation,
                                 metrics=MetricsLogger(None, echo=False))
        ref.set_keyframes(images.to(device), poses, kf)
        ref.init()
        return ref

    on_card, on_cpu = refiner(DEVICE), refiner("cpu")
    exact = ("valid", "idx_xyz", "vis", "nbr_idx", "lap_idx", "nbr_dir")
    for name, a, b in zip(on_card.prob._fields, on_card.prob, on_cpu.prob):
        if name == "n_surface":
            check(a == b, f"surface count {a} on the card, {b} on the CPU")
        elif name in exact:
            check(bool(torch.equal(a.cpu(), b)), f"problem.{name} differs")
    # both start from the card's state: its initial albedo and lights
    on_card.init_albedo()
    for name in ("dist", "albedo", "grad_stored", "poses", "lights"):
        setattr(on_cpu, name, getattr(on_card, name).cpu())
    t0 = time.perf_counter()
    with _slice_calls() as tail_calls:
        got = _one_iteration(on_card)
        _sync()
    t_card = time.perf_counter() - t0
    tail = _one_card_tail(tail_calls, 1, "refine_parity")
    t0 = time.perf_counter()
    want = _one_iteration(on_cpu)
    t_cpu = time.perf_counter() - t0

    seen = {}
    for name, a, b in zip(("dist", "albedo", "grad_stored", "poses", "lights"),
                          got, want):
        seen[name] = float((a.cpu() - b).abs().max() / b.abs().max())
    e_got = torch.stack(got[5]).cpu()
    e_want = torch.stack(want[5])
    check(bool(torch.isfinite(e_got).all()), "an energy on the card is not finite")
    for k, name in enumerate(("ps", "normal", "laplacian", "albedo_reg")):
        seen["energy_" + name] = float(
            ((e_got[:, k] - e_want[:, k]).abs()
             / e_want[:, k].abs().clamp(min=1e-12)).max())
    bad = {k: v for k, v in seen.items() if not v <= PARITY_TOL[
        "energy" if k.startswith("energy_") else "state"]}
    check(not bad, f"card and CPU disagree beyond {PARITY_TOL}: {bad}")
    return dict(keyframes=len(kf), surface_voxels=on_card.prob.n_surface,
                capacity=int(on_card.prob.valid.shape[0]), tolerance=PARITY_TOL,
                relative_difference=seen, seconds_on_card=t_card,
                seconds_on_cpu=t_cpu, distance_tail=tail,
                light_steps=light_steps(on_card, on_cpu))


def _rel(a, b):
    """max |a - b| / max |b|, a on any device, b on the CPU."""
    return float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))


def light_steps(on_card, on_cpu):
    """Where the card and the CPU part in the SH light block: from identical
    state (the CPU's, after the iteration's albedo block, on both), each step
    of the block on each device, `chained` (each device from its own
    previous step) and `isolated` (the card from the CPU's inputs of the
    step): the residual pass, the light Jacobian, the Gram matrix and its
    gradient (ops/normaleq.light_normal_eqs_sh: the kernel on the card, the
    plain product on the CPU), the batched eigen-solve, the light update."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq
    from psgradientsdf_tpu_torch.refine import jacobians, render, solvers
    from psgradientsdf_tpu_torch.refine.optimizer import _albedo_core

    cfg = on_cpu.cfg
    skw = on_cpu._static_kwargs()
    rd = render.compute_residuals(*on_cpu._args(), **skw)
    albedo = _albedo_core(*on_cpu._args()[:2], rd, *on_cpu._args()[2:6],
                          on_cpu.K, on_cpu.lights, **skw,
                          reg_weight_rho=cfg.reg_weight_rho, damping=cfg.damping,
                          stencil=on_cpu.stencil)
    on_cpu.albedo = albedo
    on_card.albedo = albedo.to(on_card.device)
    for name in ("dist", "grad_stored", "poses", "lights"):
        setattr(on_card, name, getattr(on_cpu, name).to(on_card.device))
    dev = on_card.device

    def steps(ref):
        rd = render.compute_residuals(*ref._args(), **skw)
        J = jacobians.light_jacobian_sh(ref.prob, ref.albedo, ref.grad_stored,
                                        cfg.order)
        H, g = normaleq.light_normal_eqs_sh(rd, J)
        delta = solvers.solve_light_from_normal_eqs(H, g)
        return dict(r=rd.r, w=rd.w, J=J, H=H, g=g, delta=delta,
                    lights=ref.lights - delta), rd

    got, rd_card = steps(on_card)
    want, rd_cpu = steps(on_cpu)
    _sync()
    chained = {k: _rel(got[k], want[k]) for k in want}
    # each step on the card from the CPU's inputs of that step
    rd_in = type(rd_cpu)(*(t.to(dev) for t in rd_cpu))
    H_iso, g_iso = normaleq.light_normal_eqs_sh(rd_in, want["J"].to(dev))
    delta_iso = solvers.solve_light_from_normal_eqs(want["H"].to(dev), want["g"].to(dev))
    isolated = dict(H=_rel(H_iso, want["H"]), g=_rel(g_iso, want["g"]),
                    delta=_rel(delta_iso, want["delta"]))
    vals = torch.linalg.eigvalsh(want["H"].double())
    return dict(chained=chained, isolated=isolated,
                gram_condition=[float(v) for v in (vals[:, -1] / vals[:, 0].abs())])


# ------------------------------------------- the SH light's eigen-solve


def _light_system(ref, order):
    """(H [F,B,B], g [F,B]) of the SH light block at a refiner's state, the
    basis of `order` (order 2: the order-1 lights with _sh2_lights'
    quadratic coefficients) -> (H, g, rd, J)."""
    from psgradientsdf_tpu_torch.ops import normaleq
    from psgradientsdf_tpu_torch.refine import jacobians, render

    args = list(ref._args())
    skw = ref._static_kwargs()
    if order == 2:
        args[8] = _sh2_lights(args[8], SEED)
        skw = dict(skw, order=2)
    rd = render.compute_residuals(*args, **skw)
    J = jacobians.light_jacobian_sh(ref.prob, ref.albedo, ref.grad_stored, order)
    H, g = normaleq.light_normal_eqs_sh(rd, J)
    return H, g, rd, J


def _solve_case(what, H, g):
    """light_solve against light_solve_plain (float64 eigh on the card) on
    H, g: within LIGHT_SOLVE_TOL of max|delta| (0 where the plain step is
    0), finite, twice bit for bit -> facts (with the most rotations and
    rounds that rotated a keyframe)."""
    import torch
    from psgradientsdf_tpu_torch.ops import smallsolve as SS

    want = SS.light_solve_plain(H, g)
    rot, rounds = [], []
    got = SS.light_solve(H, g, rotations_out=rot, rounds_out=rounds)
    again = SS.light_solve(H, g)
    _sync()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"light_solve {what}: a step is not finite")
    check(err <= LIGHT_SOLVE_TOL * scale if scale > 0 else err == 0.0,
          f"light_solve {what}: {err:.3g} from the plain solve, max|delta| {scale:.3g}")
    check(_bits_same(got, again), f"light_solve {what}: two runs differ")
    counted = bool(rot) and H.shape[0] > 0
    return dict(case=what, keyframes=int(H.shape[0]), basis=int(H.shape[1]),
                max_abs_err=err, max_abs_delta=scale,
                rotations_max=int(rot[0].max()) if counted else None,
                rotations=int(rot[0].sum()) if counted else None,
                rounds_max=int(rounds[0].max()) if counted else None)


def _synthetic_grams(B, F, dev, seed):
    """(name, H, g) of the edges, F keyframes of a BxB Gram each: random
    SPD, a flat scene's rank-1 Gram (every voxel the same basis vector),
    H = 0 (no counted pair), a diagonal H (no rotation), eigenvalues
    repeated in threes, eigenvalues geometric from 1 to 1.5e-6 (a spread of
    6.7e5, all kept), and eigenvalues at twice and half the clip (1e-6 of
    the largest) beside well-separated ones (B = 2: half only; B = 1: -1,
    dropped)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    f64 = dict(generator=gen, dtype=torch.float64)
    b = torch.randn(F, B, 1, **f64)
    g = torch.randn(F, B, **f64)
    M = torch.randn(F, B, B, **f64)
    spd = M @ M.mT / B + 0.1 * torch.eye(B, dtype=torch.float64)
    flat = 37.0 * (b @ b.mT)
    diagonal = torch.diag_embed(0.5 + 1.5 * torch.rand(F, B, **f64))
    Q, _ = torch.linalg.qr(torch.randn(F, B, B, **f64))
    repeated = 1.0 + torch.arange(B, dtype=torch.float64) // 3
    spread = torch.logspace(0, np.log10(1.5e-6), B, dtype=torch.float64)
    lam = torch.logspace(0, -3, B, dtype=torch.float64)
    lam[-1] = 0.5e-6 if B > 1 else -1.0
    if B > 2:
        lam[-2] = 2e-6
    f32 = lambda t: t.to(torch.float32).to(dev)
    return [("random SPD", f32(spd), f32(g)), ("flat rank-1", f32(flat), f32(g)),
            ("H = 0", f32(0 * flat), f32(g)), ("diagonal", f32(diagonal), f32(g)),
            ("eigenvalues repeated in threes", f32((Q * repeated) @ Q.mT), f32(g)),
            ("eigenvalues spread 6.7e5", f32((Q * spread) @ Q.mT), f32(g)),
            ("eigenvalues at 2 and 0.5 x the clip", f32((Q * lam) @ Q.mT), f32(g))]


def _solve_ab(systems, src, turns=1):
    """light_solve on this build and on `src` (an earlier smallsolve.cu
    whose SolveArgs is a prefix of this one's, as the cyclic-order design
    tools/smallsolve_cyclic.cu; built here into a temporary directory, its
    launches on no path and not counted): each within LIGHT_SOLVE_TOL of
    max|delta| of light_solve_plain on every (H, g, rd, J) of `systems`,
    then timed in turns (this, earlier, earlier, this; `turns` times) in
    the path's order, after light_normal_eqs_sh -> {"SH<order>": {"this":
    [ms], "earlier": [ms], "max_abs_err": {...}, "rotations": {...}}}."""
    from psgradientsdf_tpu_torch.ops import normaleq
    from psgradientsdf_tpu_torch.ops import smallsolve as SS

    package, counts = SS._library(), dict(SS.launch_counts)
    out = {}
    with tempfile.TemporaryDirectory(prefix="light_solve_ab_") as tmp:
        earlier = _parent_build(src, tmp, "smallsolve_earlier")
        for name in ("light_solve", "light_solve_floor"):
            getattr(earlier, name).argtypes = [ctypes.POINTER(SS._SolveArgs),
                                               ctypes.c_void_p]
            getattr(earlier, name).restype = ctypes.c_int
        builds = {"this": package, "earlier": earlier}

        def solve(which, H, g, **kw):
            SS._bound = builds[which]
            try:
                return SS.light_solve(H, g, **kw)
            finally:
                SS._bound = package

        for order, (H, g, rd, J) in systems.items():
            want = SS.light_solve_plain(H, g)
            scale = float(want.abs().max())
            errs, rotations = {}, {}
            for which in builds:
                rot = []
                got = solve(which, H, g, rotations_out=rot)
                _sync()
                errs[which] = float((got - want).abs().max())
                rotations[which] = int(rot[0].sum())
                check(errs[which] <= LIGHT_SOLVE_TOL * scale,
                      f"light_solve ({which} build), SH{order}: {errs[which]:.3g} from "
                      f"the plain solve, max|delta| {scale:.3g}")
            times = {"this": [], "earlier": []}
            for _ in range(turns):
                for which in ("this", "earlier", "earlier", "this"):
                    times[which].append(_path_ms([
                        lambda: normaleq.light_normal_eqs_sh(rd, J),
                        lambda: solve(which, H, g)])[1])
            out[f"SH{order}"] = dict(times, max_abs_err=errs, rotations=rotations)
    SS.launch_counts.update(counts)
    return out


def light_solve_kernels(main_run):
    """The SH light block's eigen-solve (ops/smallsolve.light_solve, one
    launch) against its plain version on the card, LIGHT_SOLVE_TOL of
    max|delta|, twice bit for bit: the main run's SH1 light block at its
    final state (F = 40, B = 4) and that problem under SH2 lights (B = 9),
    each also on its first keyframe and its first 33; under each basis
    _synthetic_grams' edges at F = 1, 33 and 40, and at every other B from
    1 to 8 at F = 40.  Then the times of the main SH1 and SH2 solves in the
    path's order (after light_normal_eqs_sh), in turns with the cyclic-order
    design it replaced (EARLIER_SOLVE, _solve_ab), beside an empty launch of
    its grid, the plain solve, and torch.linalg.eigh with the clip's
    products in float32 (the port's solve before these kernels) and in
    float64 (library_ms); bound_ms from this run's bytes and its rotations'
    float64 operations."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq
    from psgradientsdf_tpu_torch.ops import smallsolve as SS

    ref = main_run["pipe"].refiner
    dev = ref.device
    cases, systems = [], {}
    for order in (1, 2):
        H, g, rd, J = _light_system(ref, order)
        systems[order] = (H, g, rd, J)
        name = f"main SH{order}"
        for F in (H.shape[0], 1, EDGE_ODD_F):
            cases.append(_solve_case(f"{name}, {F} keyframes", H[:F].contiguous(),
                                     g[:F].contiguous()))
        for F in (1, EDGE_ODD_F, H.shape[0]):
            for what, Hs, gs in _synthetic_grams(H.shape[1], F, dev, SEED + 10 * F + order):
                cases.append(_solve_case(f"SH{order} {what}, {F} keyframes", Hs, gs))
    F_main = systems[1][0].shape[0]
    for B in range(1, SS.MAX_BASIS + 1):
        if B not in (systems[1][0].shape[1], systems[2][0].shape[1]):
            for what, Hs, gs in _synthetic_grams(B, F_main, dev, SEED + 100 * B):
                cases.append(_solve_case(f"B = {B} {what}, {F_main} keyframes", Hs, gs))

    def eigh_chain(H, g, dtype):
        vals, vecs = torch.linalg.eigh(H.to(dtype))
        vmax = torch.amax(vals, dim=-1, keepdim=True)
        inv = torch.where(vals > torch.clamp(vmax, min=0.0) * SS.CLIP, 1.0 / vals, 0.0)
        gv = torch.einsum("fdb,fd->fb", vecs, g.to(dtype))
        return torch.einsum("fbd,fd->fb", vecs, inv * gv).to(torch.float32)

    timed = {}
    turns = (_solve_ab(systems, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                             EARLIER_SOLVE))
             if DEVICE == "cuda" else {})
    for order, (H, g, rd, J) in (systems.items() if DEVICE == "cuda" else ()):
        F, B = H.shape[0], H.shape[1]
        ab = turns[f"SH{order}"]
        floor = _path_ms([lambda: normaleq.light_normal_eqs_sh(rd, J),
                          lambda: SS.light_solve_floor(F, B, dev)])[1]
        plain = _path_ms([lambda: SS.light_solve_plain(H, g)])[0]
        lib32 = _path_ms([lambda: eigh_chain(H, g, torch.float32)])[0]
        lib64 = _path_ms([lambda: eigh_chain(H, g, torch.float64)])[0]
        f32_err = float((eigh_chain(H, g, torch.float32) - SS.light_solve_plain(H, g)).abs().max())
        rot, rounds = [], []
        SS.light_solve(H, g, rotations_out=rot, rounds_out=rounds)
        rotations = int(rot[0].sum())
        # bytes: H and g read, delta written; operations: a rotation's
        # (c, s, t) and its 2 x 6 B row and column updates, then V^T g and
        # V inv V^T g
        nbytes = 4 * (F * B * B + 2 * F * B)
        flops = rotations * (12 * B + 12) + F * (4 * B * B + B)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP64_FLOPS * 1e3
        timed[f"SH{order}"] = dict(
            keyframes=F, basis=B, ms=statistics.median(ab["this"]),
            earlier_ms=statistics.median(ab["earlier"]),
            in_turns=dict(this=ab["this"], earlier=ab["earlier"]),
            empty_launch_ms=floor, plain_ms=plain,
            library_ms=lib64, library_f32_ms=lib32, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes,
            fp64_operations=flops, rotations=rotations,
            rounds_max=int(rounds[0].max()), rounds=int(rounds[0].sum()),
            earlier_rotations=ab["rotations"]["earlier"],
            earlier_max_abs_err=ab["max_abs_err"]["earlier"],
            max_abs_err=next(c["max_abs_err"] for c in cases
                             if c["case"] == f"main SH{order}, {F} keyframes"),
            float32_eigh_max_abs_err=f32_err)
    return dict(cases=cases, tolerance=LIGHT_SOLVE_TOL, timed=timed,
                rounds_max=max(c["rounds_max"] or 0 for c in cases),
                rotations_max=max(c["rotations_max"] or 0 for c in cases))


# ------------------------------------- the refinement as one CUDA graph


class _Records:
    """A metrics logger that keeps its records."""

    def __init__(self):
        self.records = []

    def log(self, event, **fields):
        self.records.append(dict(event=event, **fields))
        return self.records[-1]


def _refiner_on(pipe, capture):
    """A refiner on the scan of `pipe` as the pipeline makes one (its
    sampled keyframes, its recipe), the volume copied, init() run."""
    import torch
    from psgradientsdf_tpu_torch.core.volume import GradSdfVolume
    from psgradientsdf_tpu_torch.pipeline import sample_keyframes
    from psgradientsdf_tpu_torch.refine.optimizer import PhotometricRefiner

    cfg = pipe.cfg
    key_indices, key_stamps, images, key_poses = sample_keyframes(
        pipe.key_indices, pipe.key_stamps, pipe.key_images_dev, pipe.key_poses,
        cfg.tpu.keyframe_cap)
    ref = PhotometricRefiner(GradSdfVolume(*(t.clone() for t in pipe.vol)), pipe.geom,
                             cfg.optimizer, pipe.K, truncation=cfg.truncation,
                             metrics=_Records(), capture=capture)
    ref.set_keyframes(torch.stack(images), np.stack(key_poses), key_indices, key_stamps)
    ref.init()
    return ref


def _refine_once(pipe, capture):
    """One whole refinement on `pipe`'s scan -> (refiner, records, wall
    seconds of its loop)."""
    ref = _refiner_on(pipe, capture)
    opt = pipe.cfg.optimizer
    t0 = time.perf_counter()
    ref.alternating_optimize(opt.opt_light, opt.opt_albedo, opt.opt_distance, opt.opt_pose)
    _sync()
    return ref, ref.metrics.records, time.perf_counter() - t0


def _loop_seconds(records, wall):
    """Iteration 0's seconds, the later iterations' and their mean, each
    graph's seconds of warm-up and capture and of its warm-up alone, the
    loop's wall seconds."""
    its = [r["seconds"] for r in records if r["event"] == "iteration"]
    later = its[1:]
    return dict(iteration0=its[0], later=later,
                later_mean=statistics.mean(later) if later else None,
                capture_seconds=[r["seconds"] for r in records if r["event"] == "refine_graph"],
                warmup_seconds=[r["warmup_seconds"] for r in records
                                if r["event"] == "refine_graph"],
                loop_wall_seconds=wall)


def _cg_steps(records):
    return [(r["iter"], r["block"], r.get("cg_steps")) for r in records
            if r["event"] == "block"]


def _traced_steps(pipe, capture):
    """Two warm fused iterations of a fresh refiner on `pipe`'s scan at the
    recipe's own weights, traced: the graph's replays and their reads
    (capture) or the eager fused iteration and its read -> device ops,
    device-to-host copies, runtime calls, device ms per iteration, the busy
    share, the wall seconds."""
    import torch
    from psgradientsdf_tpu_torch.refine import optimizer as opt_mod

    ref = _refiner_on(pipe, capture)
    ref.init_albedo()
    opt = pipe.cfg.optimizer
    kw = dict(ref._static_kwargs(), reg_weight_n=opt.reg_weight_n,
              reg_weight_l=opt.reg_weight_l, reg_weight_rho=opt.reg_weight_rho,
              damping=opt.damping, laplacian_diag_only=False, do_light=opt.opt_light,
              do_albedo=opt.opt_albedo, do_distance=opt.opt_distance,
              do_pose=opt.opt_pose, joint_dp=False)
    # the loop's weights before an upsample turns the Laplacian on
    kw["reg_weight_l"] = 0.0 if opt.upsample else opt.reg_weight_l
    runner = ref._graph_for(kw) if capture else None
    opt_mod._fused_step(ref, runner, kw)                 # warm
    torch.cuda.synchronize()
    with _traced() as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            opt_mod._fused_step(ref, runner, kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ref._release_graph()
    rows = sorted(_kernel_rows(prof), reverse=True)
    copies = int(sum(r[1] for r in rows if "DtoH" in r[2]))
    busy = sum(r[0] for r in rows) * 1e-6
    return dict(device_ops_per_iteration=int(sum(r[1] for r in rows)) / 2,
                top=[dict(name=k[:80], per_iteration=c / 2, device_ms=us * 1e-3 / 2)
                     for us, c, k in rows[:12]],
                copies=[dict(name=k[:80], per_iteration=c / 2) for _, c, k in rows
                        if "Memcpy" in k],
                device_to_host_copies_per_iteration=copies / 2,
                runtime_calls_per_iteration=int(_runtime_calls(prof)) / 2,
                device_ms_per_iteration=busy * 1e3 / 2, device_busy_share=busy / wall,
                traced_wall_seconds_per_iteration=wall / 2,
                warmup_dropped=prof.warmup_dropped)


def _graph_cell(pipe, what, captures):
    """The graphed loop against capture=False on `pipe`'s scan, GRAPH_TURNS
    turns each (graph, eager, graph, ...): the first graphed run bit for bit
    against the first eager one in state, every energy, every CG step
    count, stop and iteration count, every graphed run equal to the first;
    `captures` graphs a graphed run; the loops named in their records;
    then the traced windows -> facts."""
    import torch

    runs = {True: [], False: []}
    for _ in range(GRAPH_TURNS):
        for capture in (True, False):
            runs[capture].append(_refine_once(pipe, capture))
    g_ref, g_rec, _ = runs[True][0]
    e_ref, e_rec, _ = runs[False][0]
    for capture in (True, False):
        want = "graph" if capture and DEVICE == "cuda" else "eager"
        for ref, rec, _ in runs[capture]:
            loops = [r for r in rec if r["event"] == "refine_loop"]
            check(len(loops) == 1 and loops[0]["loop"] == want,
                  f"refine_graph {what}: loops {loops}, expected {want}")
            check(ref.graph_captures == (_on_card(captures) if capture else 0),
                  f"refine_graph {what}: {ref.graph_captures} captures")
    check(g_ref.stop_reason == e_ref.stop_reason
          and g_ref.iterations_run == e_ref.iterations_run,
          f"refine_graph {what}: graph {g_ref.stop_reason} after {g_ref.iterations_run}, "
          f"eager {e_ref.stop_reason} after {e_ref.iterations_run}")
    check(g_ref.energy_trace == e_ref.energy_trace,
          f"refine_graph {what}: the energy traces differ")
    check(_cg_steps(g_rec) == _cg_steps(e_rec),
          f"refine_graph {what}: CG steps differ")
    for name in STATE_TENSORS:
        check(_bits_same(getattr(g_ref, name), getattr(e_ref, name)),
              f"refine_graph {what}: {name} differs from the eager loop's")
    for ref, rec, _ in runs[True][1:]:
        check(ref.energy_trace == g_ref.energy_trace and _cg_steps(rec) == _cg_steps(g_rec),
              f"refine_graph {what}: two graphed runs differ")
    seconds = {k: [_loop_seconds(rec, wall) for _, rec, wall in v]
               for k, v in (("graph", runs[True]), ("eager", runs[False]))}
    out = dict(
        stopped=g_ref.stop_reason, iterations=g_ref.iterations_run,
        surface_voxels=g_ref.prob.n_surface, keyframes=len(g_ref.keyframe_indices),
        captures=g_ref.graph_captures, bit_identical=True,
        cg_steps=[s for s in _cg_steps(g_rec) if s[2] is not None],
        seconds=seconds,
        best_later_mean={k: min(s["later_mean"] for s in v) for k, v in seconds.items()},
        best_iteration0={k: min(s["iteration0"] for s in v) for k, v in seconds.items()},
        best_loop_wall={k: min(s["loop_wall_seconds"] for s in v)
                        for k, v in seconds.items()},
        traced=None)
    if DEVICE == "cuda":
        out["traced"] = {"graph": _traced_steps(pipe, True), "eager": _traced_steps(pipe, False)}
        copies = out["traced"]["graph"]["device_to_host_copies_per_iteration"]
        check(copies == 1, f"refine_graph {what}: {copies} device-to-host copies a "
                           "replayed iteration, expected 1")
        del runs
        torch.cuda.empty_cache()
    return out


def refine_graph(tmp, seq, led_seq):
    """The one-card refinement as one CUDA graph an iteration
    (refine/graph.py) against the eager loop (capture=False), on three
    recipes: SH1 (the main run's, 40 keyframes at 128^3), a whole SH2
    refinement (configs/sokrates_sh2.json's weights on the main scan) and
    the LED run with its upsample (two captures) -> facts (_graph_cell)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), SH2_CONFIG)) as fh:
        sh2 = json.load(fh)
    recipes = (
        ("SH1", dict(seq=seq, last=FRAMES - 1, recipe=REFINE_SH1, kw={}), 1),
        ("SH2", dict(seq=seq, last=FRAMES - 1,
                     recipe={k: sh2[k] for k in REFINE_SH1}, kw={}), 1),
        ("LED upsample", dict(seq=led_seq, last=LED_FRAMES - 1, recipe=REFINE_LED,
                              kw=dict(grid=LED_GRID, gt_poses=True)), 2))
    out = {}
    for what, c, captures in recipes:
        scan = run_scan(tmp, "graph_" + what.split()[0].lower(), c["seq"], c["last"], "dma",
                        config=c["recipe"], **c["kw"])
        out[what] = _graph_cell(scan["pipe"], what, captures)
    return out


# ------------------------------------------------ the scan as a CUDA graph


SCAN_GRAPH_OVERFLOW_ROWS = 0.25     # "fuse rows" under the active rows
SCAN_GRAPH_STOP = 2 * CHUNK         # the stopped scan's last frame
SCAN_GRAPH_CHUNKS = 6               # full chunks the chunk runner runs


def _scan_facts(run):
    """What a scan run made that the graphed and the eager run must share."""
    pipe = run["pipe"]
    return dict(
        track=[(r["frame"], r["converged"], r["iters"], r["energy"], r["valid"])
               for r in run["summary"]["track_log"]],
        keyframes=list(pipe.key_indices), key_poses=[p.tolist() for p in pipe.key_poses])


def _same_scan(got, want, what):
    """Two scans bit for bit: volume tables, tracking_poses.txt, every
    frame's converged flag, iterations, energy and pixel count, the
    keyframes, their poses and their device images."""
    import torch

    check(_equal_volumes(got["pipe"].vol, want["pipe"].vol),
          f"scan_graph {what}: the volume differs from the eager scan's")
    check(got["pose_text"] == want["pose_text"],
          f"scan_graph {what}: tracking_poses.txt differs from the eager scan's")
    a, b = _scan_facts(got), _scan_facts(want)
    for k in a:
        check(a[k] == b[k], f"scan_graph {what}: {k} differ from the eager scan's")
    imgs = (got["pipe"].key_images_dev, want["pipe"].key_images_dev)
    check(len(imgs[0]) == len(imgs[1])
          and all(bool(torch.equal(x, y)) for x, y in zip(*imgs)),
          f"scan_graph {what}: the keyframe images differ")


def _graph_stats(run, what, captures=None, replays=None):
    """The graphed run's rotation: its captures (exactly `captures` where
    given) and replays (at least one) -> its stats."""
    st = run["summary"]["scan_graph"]
    check(st is not None and st["graph"] == (DEVICE == "cuda"),
          f"scan_graph {what}: the scan ran no rotation, or no graph on the card: {st}")
    if DEVICE == "cuda":
        check(st["replays"] >= 1, f"scan_graph {what}: no chunk was replayed: {st}")
        check(captures is None or st["captures"] == captures,
              f"scan_graph {what}: {st['captures']} captures, expected {captures}")
        check(replays is None or st["replays"] == replays,
              f"scan_graph {what}: {st['replays']} replays, expected {replays}")
    return st


def _chunk_runner(pipe, seq, capture, traced=None):
    """process_chunk driven as the pipeline drives it, on a rotation of its
    own: frame 0 fused at the identity, then SCAN_GRAPH_CHUNKS full chunks
    of the sequence's frames 1.. (the first ones again where the sequence
    runs out), each read once, after the next is launched; with `traced`, a
    callable taking the last two chunks' work (and the last read) -> (each
    chunk's seconds from its launch to the next's, the last chunk's to its
    read excluded; rotation stats; the last volume)."""
    import torch
    from psgradientsdf_tpu_torch.core.volume import fuse_frame, make_volume
    from psgradientsdf_tpu_torch.ops.normals import compute_normals
    from psgradientsdf_tpu_torch.tracking.graph import ScanRotation
    from psgradientsdf_tpu_torch.tracking.stream import process_chunk, read_result

    K, colors, depths = seq[:3]
    cfg, geom, fals = pipe.cfg, pipe.geom, pipe.fals
    tr, tpu = cfg.tracking, cfg.tpu
    K_dev = torch.as_tensor(K, dtype=torch.float32, device=DEVICE)
    eye = torch.eye(4, dtype=torch.float32, device=DEVICE)
    d0 = torch.as_tensor(depths[0].astype(np.float32) * np.float32(DEPTH_UNIT),
                         device=DEVICE)
    c0 = torch.as_tensor(colors[0].astype(np.float32) / 255.0, device=DEVICE)
    zkw = dict(truncation=cfg.truncation, zmin=tr.zmin, zmax=tr.zmax)
    vol = fuse_frame(make_volume(geom, cfg.truncation, pipe._frame_cap, device=DEVICE),
                     geom, c0, d0, compute_normals(d0, fals, window=11), fals.n_sq_inv,
                     K_dev, eye, 0, device=DEVICE, **zkw)
    rot = ScanRotation(vol, CHUNK, capture=capture)
    kw = dict(num_iterations=tr.num_iterations, conv_threshold_sq=tr.conv_threshold ** 2,
              damping=tr.damping, stride=tpu.track_stride, use_gt=False,
              depth_unit=DEPTH_UNIT, regather_every=tpu.track_regather,
              early_exit=not tpu.track_static, fuse_row_capacity=pipe._fuse_cap,
              rows_impl="dma", rotation=rot, capture=capture, device=DEVICE, **zkw)
    gtp = np.broadcast_to(np.eye(4, dtype=np.float32), (CHUNK, 4, 4)).copy()
    valid = np.ones(CHUNK, bool)
    pose, seconds = eye, []

    pending = []

    def chunk(k):
        # as the pipeline: a chunk's results are read after the next chunk
        # is launched, so the host stacks and copies while the card works
        nonlocal vol, pose
        first = 1 + (k * CHUNK) % (FRAMES - 1 - CHUNK)
        sel = list(range(first, first + CHUNK))
        t0 = time.perf_counter()
        vol, res = process_chunk(
            vol, geom, np.stack([colors[i] for i in sel]),
            np.stack([depths[i] for i in sel]), K_dev, pose,
            np.arange(1 + k * CHUNK, 1 + (k + 1) * CHUNK, dtype=np.int32) % pipe._frame_cap,
            valid, gtp, fals, **kw)
        if pending:
            read_result(pending.pop())
        pending.append(res)
        pose = res.poses[CHUNK - 1]
        seconds.append(time.perf_counter() - t0)

    def last_two():
        for k in range(SCAN_GRAPH_CHUNKS - 2, SCAN_GRAPH_CHUNKS):
            chunk(k)
        read_result(pending.pop())

    for k in range(SCAN_GRAPH_CHUNKS - 2):
        chunk(k)
    if traced is None:
        last_two()
    else:
        traced(last_two)
    stats = rot.stats()
    rot.release()
    return seconds, stats, vol


def _traced_chunks(pipe, seq, capture):
    """The chunk runner's last two chunks (replays where `capture`) traced
    -> runtime calls a chunk, device ops a frame, device time, busy share."""
    import torch

    out = {}

    def traced(work):
        torch.cuda.synchronize()
        with _traced() as prof:
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            out["wall"] = time.perf_counter() - t0
        out["prof"] = prof

    _, stats, _ = _chunk_runner(pipe, seq, capture, traced)
    # the warm-up, three captures, and the traced two chunks replays only
    check(stats["captures"] == (3 if capture else 0)
          and stats["replays"] == (SCAN_GRAPH_CHUNKS - 1 if capture else 0),
          f"scan_graph: the chunk runner's rotation {stats}")
    prof = out["prof"]
    rows = sorted(_kernel_rows(prof), reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    check(busy > 0.0, "scan_graph: the profiler saw no device time")
    n = 2
    return dict(
        runtime_calls_per_chunk=int(_runtime_calls(prof)) / n,
        # by name, the trace's warm-up and closing calls included
        runtime_calls=sorted(((e.key, e.count) for e in prof.key_averages()
                              if not str(e.device_type).endswith("CUDA")
                              and e.key.startswith("cu")), key=lambda r: -r[1]),
        device_ops_per_frame=int(sum(r[1] for r in rows)) / (n * CHUNK),
        device_ms_per_chunk=busy * 1e3 / n, device_busy_share=busy / out["wall"],
        traced_wall_seconds_per_chunk=out["wall"] / n,
        device_to_host_copies_per_chunk=int(sum(r[1] for r in rows if "DtoH" in r[2])) / n,
        rotation=stats, warmup_dropped=prof.warmup_dropped,
        top=[dict(name=k[:80], per_chunk=c / n, device_ms=us * 1e-3 / n)
             for us, c, k in rows[:10]])


def _update_device_frame(st, vol, geom, truncation, f):
    """fuse_rows with the frame id on the device (the whole visibility
    table, the word picked by the kernel) against its plain version and
    against the host-bit form on frame f's rows, bit for bit; both forms
    timed in turns in the path's order -> dict."""
    import torch
    from psgradientsdf_tpu_torch.core import volume as V
    from psgradientsdf_tpu_torch.ops import fuse as F, rowcopy

    X, Y, Z = geom.dims
    depth, K, pose = st["depths"][f], st["K"], st["gt"][f]
    kz = dict(st["zkw"], truncation=truncation)
    cap = _fuse_capacity(geom)
    act = V._row_activity(geom, depth, K, pose, **kz)
    idx, live, _ = V._compact_padded(act.reshape(-1), cap)
    word, bit = V._vis_word_bit(f)
    NW = vol.vis.shape[0]
    tables = [vol.dist.view(Z * Y, X), vol.grad.view(Z * Y, 3 * X),
              vol.weight.view(Z * Y, X), vol.color.view(Z * Y, 3 * X),
              vol.vis[word].view(Z * Y, X)]
    rows = rowcopy.gather_tables_dma(tables, idx)
    pix = V.pack_pixel_payload(st["colors"][f], depth, st["normals"][f], st["n_sq_inv"])
    fid = torch.tensor(f, dtype=torch.int32, device=DEVICE)
    kw = dict(geom=geom, S=X, rows=idx, live=live, cos_thresh_sq=0.25 * 0.25, **kz)

    def fields(r):
        return r[0], r[1].view(cap, X, 3), r[2], r[3].view(cap, X, 3)

    host = [r.clone() for r in rows]
    dev = [r.clone() for r in rows[:4]]
    plain = [r.clone() for r in rows[:4]]
    tab_dev, tab_plain = vol.vis.clone(), vol.vis.clone()
    HW = tuple(depth.shape)
    F.fuse_rows(*fields(host), host[4], pix, K, pose, HW, bit, None, **kw)
    F.fuse_rows(*fields(dev), tab_dev.view(NW, Z * Y, X), pix, K, pose, HW, None,
                None, frame=fid, **kw)
    F.fuse_rows_plain(*fields(plain), tab_plain.view(NW, Z * Y, X), pix, K, pose, HW,
                      None, None, frame=fid, **kw)
    _sync()
    n = int(live)
    for a, b, c in zip(dev, plain, host):
        check(_bits_equal(a[:n], b[:n]) and _bits_equal(a[:n], c[:n]),
              f"fuse_rows with the device frame id differs: frame {f}")
    check(_bits_equal(tab_dev, tab_plain), f"the device frame id's words differ: frame {f}")
    got = tab_dev[word].view(Z * Y, X)[idx[:n].long()]
    check(_bits_equal(got, host[4][:n]), f"the device frame id's words differ from "
                                         f"the host bit's: frame {f}")
    rest = torch.ones(NW, dtype=torch.bool, device=DEVICE)
    rest[word] = False
    check(_bits_equal(tab_dev[rest], vol.vis[rest]), "another word was written")
    out = dict(frame=f, live_rows=n, bit_identical=True)
    if DEVICE == "cuda":
        # in turns, back to back in one timed path (_path_ms: no flush)
        turns = [_path_ms([
            lambda: F.fuse_rows(*fields(host), host[4], pix, K, pose, HW, bit, None, **kw),
            lambda: F.fuse_rows(*fields(dev), tab_dev.view(NW, Z * Y, X), pix, K, pose,
                                HW, None, None, frame=fid, **kw)]) for _ in range(3)]
        out.update(turns_ms=turns, ms=dict(host_bit=min(t[0] for t in turns),
                                           device_frame=min(t[1] for t in turns)))
    return out


def scan_graph(tmp, seq):
    """The one-card scan as one CUDA graph a chunk (tracking/graph.py)
    against capture=False: the smoke scan under each of GN_CONFIGS, with a
    forced overflow (a redo and a recapture), its ragged last chunk, and a
    resume from a scan checkpoint, bit for bit; the scan phase's launch
    checks on the graphed runs; the fusion's device frame id against its
    plain version and the host bit; runtime calls a chunk and device ops a
    frame from traced replayed and eager chunks; frames/s in turns -> facts."""
    import torch

    out = dict(configs={})
    last = FRAMES - 1
    for name in GN_CONFIGS:
        g = run_scan(tmp, "sg_" + name.lower(), seq, last, "dma", tracker=name)
        e = run_scan(tmp, "sge_" + name.lower(), seq, last, "dma", tracker=name,
                     capture=False)
        _same_scan(g, e, name)
        # 5 full chunks and a ragged one: the warm-up, three captures (one a
        # slot), one more replay, the ragged chunk eagerly
        st = _graph_stats(g, name, captures=_on_card(3), replays=_on_card(4))
        calls = g["pipe"].fuse_culled_calls
        _check_dma_launches(g["counts"], calls, f"scan_graph {name}")
        sc = g["scan_counts"]
        check(sc["gn_solve"] == _on_card(sc["frames_solved"])
              and sc["fuse_rows"] == _on_card(calls + 1),
              f"scan_graph {name}: gn_solve {sc['gn_solve']}, fuse_rows "
              f"{sc['fuse_rows']}, {sc['frames_solved']} solved, {calls} culled fusions")
        check(e["summary"]["scan_graph"]["captures"] == 0,
              f"scan_graph {name}: capture=False captured")
        out["configs"][name] = dict(
            bit_identical=True, frames_per_s={"graph": g["summary"]["fps"],
                                              "eager": e["summary"]["fps"]},
            rotation=st, eager_rotation=e["summary"]["scan_graph"],
            launches=dict(g["counts"], **sc),
            mean_iterations=float(np.mean([r["iters"] for r in g["summary"]["track_log"]])))
        if name == "REFERENCE":
            ref_g, ref_e = g, e
    # ground-truth poses (use_gt): the same graph with no tracker in it
    g = run_scan(tmp, "sg_gt", seq, last, "dma", gt_poses=True)
    e = run_scan(tmp, "sge_gt", seq, last, "dma", gt_poses=True, capture=False)
    _same_scan(g, e, "GT")
    check(g["scan_counts"]["gn_solve"] == 0, "scan_graph GT: the tracker ran")
    out["configs"]["GT"] = dict(
        bit_identical=True, frames_per_s={"graph": g["summary"]["fps"],
                                          "eager": e["summary"]["fps"]},
        rotation=_graph_stats(g, "GT", captures=_on_card(3), replays=_on_card(4)))
    # a capacity under the active rows: a redo, a grown capacity, new captures
    cfg = {"fuse rows": SCAN_GRAPH_OVERFLOW_ROWS}
    g = run_scan(tmp, "sg_overflow", seq, last, "dma", config=cfg)
    e = run_scan(tmp, "sge_overflow", seq, last, "dma", config=cfg, capture=False)
    _same_scan(g, e, "overflow")
    redos = g["summary"]["overflow_redos"]
    check(redos >= 1 and redos == e["summary"]["overflow_redos"],
          f"scan_graph overflow: {redos} redos graphed, "
          f"{e['summary']['overflow_redos']} eager")
    st = _graph_stats(g, "overflow")
    check(DEVICE != "cuda" or st["captures"] > 3,
          f"scan_graph overflow: {st['captures']} captures, no recapture")
    _check_dma_launches(g["counts"], g["pipe"].fuse_culled_calls, "scan_graph overflow")
    out["overflow"] = dict(bit_identical=True, overflow_redos=redos,
                           capacity=g["summary"]["fuse_capacity"], rotation=st)
    # a scan stopped at a checkpoint and resumed, graphed
    # the stopped run holds the whole run's visibility words (its own frame
    # range would size fewer, and a resume refuses those)
    a = run_scan(tmp, "sg_stop", seq, SCAN_GRAPH_STOP, "dma", checkpoint_every=CHUNK,
                 config={"frame cap": -(-FRAMES // 32) * 32})
    path = os.path.join(a["out_dir"], "scan_checkpoint.npz")
    b = run_scan(tmp, "sg_resume", seq, last, "dma", resume=path)
    check(b["pose_text"] == ref_g["pose_text"] and _equal_volumes(b["pipe"].vol,
                                                                   ref_g["pipe"].vol),
          "scan_graph resume: the resumed graphed scan differs from the whole one")
    out["resume"] = dict(bit_identical=True, stopped_after_frame=SCAN_GRAPH_STOP,
                         rotation=_graph_stats(b, "resume"))
    # the fusion's frame id on the device, on frame 24's rows
    st_ = _stream_setup(tmp, seq, FRAMES)
    out["device_frame_id"] = _update_device_frame(
        st_, ref_e["pipe"].vol, st_["geom"], st_["truncation"], 24)
    del st_
    # frames/s of the smoke scan in turns, best of GRAPH_TURNS
    fps = {"graph": [], "eager": []}
    for t in range(GRAPH_TURNS):
        for cap in (True, False):
            r = run_scan(tmp, f"sg_turn{t}_{cap}", seq, last, "dma", capture=cap)
            fps["graph" if cap else "eager"].append(r["summary"]["fps"])
            del r
    out["frames_per_s_turns"] = fps
    out["best_frames_per_s"] = {k: max(v) for k, v in fps.items()}
    # steady-state chunks: untraced seconds in turns, then traced windows
    secs = {"graph": [], "eager": []}
    for _ in range(GRAPH_TURNS):
        for cap in (True, False):
            s, stats, _ = _chunk_runner(ref_g["pipe"], seq, cap)
            secs["graph" if cap else "eager"].append(s)
    out["chunk_seconds"] = secs
    out["best_steady_chunk_seconds"] = {
        k: min(min(s[-2:]) for s in v) for k, v in secs.items()}
    out["runner_rotation"] = stats
    if DEVICE == "cuda":
        out["traced"] = {"graph": _traced_chunks(ref_g["pipe"], seq, True),
                         "eager": _traced_chunks(ref_g["pipe"], seq, False)}
        torch.cuda.empty_cache()
    return out


def run_led_upsample(tmp):
    """The LED model with the iteration-5 upsample, at a smaller depth: a
    64^3 grid, 8 keyframes lit by a point light at the camera, fused at their
    generating poses (the loader's load_pose), 7 iterations -> (the run, the
    sequence, what was measured)."""
    import torch

    seq = make_sequence(LED_FRAMES, shading="led", step=LED_STEP, seed=SEED + 1)
    run = run_scan(tmp, "led", seq, LED_FRAMES - 1, "dma", refine=REFINE_LED,
                   grid=LED_GRID, gt_poses=True)
    pipe, summary, out = run["pipe"], run["summary"], run["out_dir"]
    ref = pipe.refiner
    trace = ref.energy_trace
    check(all(np.isfinite([r["total"], r["ps"]]).all() for r in trace),
          "an energy of the LED run is not finite")
    check(bool(torch.isfinite(ref.dist).all() and torch.isfinite(ref.lights).all()),
          "the LED run's state is not finite")
    check(tuple(pipe.geom.dims) == (2 * LED_GRID,) * 3
          and tuple(pipe.vol.dist.shape) == (2 * LED_GRID,) * 3,
          f"the grid was not doubled: {pipe.geom.dims}")
    init = [e for e in run["events"] if e["event"] == "refine_init"][0]
    n0 = init["surface_voxels"]
    up = [e for e in run["events"] if e["event"] == "upsample"]
    check(len(up) == 1 and up[0]["surface_voxels"] > n0,
          f"surface count {n0} did not grow at the upsample: {up}")
    check(summary["refine_iterations"] == 7, "the LED run stopped before iteration 6")
    mesh = _ply_counts(os.path.join(out, "upsample_after_5_mesh.ply"))
    cloud = _ply_counts(os.path.join(out, "upsample_after_5_pointcloud.ply"))
    check(mesh[0] > 1000 and cloud[0] == up[0]["surface_voxels"],
          "the upsample_after_5 artifacts")
    _ply_counts(os.path.join(out, "final_refined_mesh.ply"))
    per_block, per_iter, cg = _block_times(run["events"])
    return run, seq, dict(
        grid=[LED_GRID, 2 * LED_GRID], keyframes=len(ref.keyframe_indices),
        surface_voxels=[n0, up[0]["surface_voxels"]],
        capacity=[init["capacity"], up[0]["capacity"]],
        iterations=summary["refine_iterations"], stopped=summary["refine_stop"],
        lights=[float(v) for v in ref.lights.cpu()],
        energy_trace=[dict(iter=r["iter"], block=r["block"], total=r["total"],
                           ps=r["ps"]) for r in trace],
        seconds_per_iteration=per_iter, cg_steps=cg,
        upsample_seconds=[e["seconds"] for e in run["events"]
                          if e["event"] == "upsample_seconds"],
        artifact_dump_seconds=[e["seconds"] for e in run["events"]
                               if e["event"] == "artifact_dump"],
        refine_seconds=summary["refine_seconds"],
        peak_memory_bytes=summary["refine_peak_memory_bytes"],
        scan_seconds=summary["seconds"])


# ------------------------------------------- the refinement's two kernels


def _bits_same(a, b):
    """Bit for bit, bool tensors too."""
    import torch

    if a.dtype == torch.bool:
        return bool(torch.equal(a, b))
    return _bits_equal(a, b)


def _distinct_pixels(uv, H, W):
    """The distinct (frame, row, column) pixels that the residual pass's 3x3
    patches read (eight of nine entries: the first row's first is unused),
    with the patch fetch's clipping -> count."""
    import torch

    dev = uv.device
    F = uv.shape[1]
    r0 = torch.floor(uv[..., 1]).long()
    c0 = torch.clamp(torch.floor(uv[..., 0]).long(), 0, W - 1)
    d = torch.arange(-1, 2, device=dev)
    rows = torch.clamp(r0[..., None] + d, 0, H - 1)                 # [N,F,3]
    cols = torch.clamp(c0[..., None] + d, 0, W - 1)
    f = torch.arange(F, device=dev)[None, :, None, None]
    lin = (f * H + rows[..., :, None]) * W + cols[..., None, :]      # [N,F,3,3]
    used = torch.ones(3, 3, dtype=torch.bool, device=dev)
    used[0, 0] = False
    return int(torch.unique(lin[..., used]).numel())


def _refine_case(what, args, kw, flush, timed=False):
    """Both kernels against their plain versions on the same inputs
    (args: prob, geom, dist, albedo, grad_stored, poses, images, K, lights;
    kw: the residual pass's model, order, loss, lam, voxel_size): every
    output bit for bit, the Jacobian with G.  With `timed`, on the card:
    each kernel's ms, plain_ms and its byte bound -> dict."""
    from psgradientsdf_tpu_torch.ops import residual as RS

    prob, geom, dist, albedo, grad, poses, images, K, lights = args
    got = RS.residual_pass(*args, **kw)
    want = RS.residual_pass_plain(*args, **kw)
    _sync()
    for name, a, b in zip(got._fields, got, want):
        check(_bits_same(a, b), f"residual_pass differs from its plain version: "
                                f"{what}, {name}, by up to {_abs_err(a, b)}")
    jkw = dict(model=kw["model"], order=kw["order"], voxel_size=kw["voxel_size"])
    jargs = (prob, geom, got, dist, albedo, grad, poses, K, lights)
    G1, D1 = RS.dist_jacobian(*jargs, **jkw, with_G=True)
    G2, D2 = RS.dist_jacobian_plain(*jargs, **jkw, with_G=True)
    _sync()
    for name, a, b in (("G", G1, G2), ("J0", D1.J0, D2.J0), ("Ji", D1.Ji, D2.Ji)):
        check(_bits_same(a, b), f"dist_jacobian differs from its plain version: "
                                f"{what}, {name}, by up to {_abs_err(a, b)}")
    N, F, H, W = got.r.shape[0], got.r.shape[1], images.shape[1], images.shape[2]
    z = got.p_cam[..., 2]
    u, v = got.uv[..., 0], got.uv[..., 1]
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    out = dict(case=what, model=kw["model"], loss=kw["loss"], voxels=N,
               keyframes=F, image=[W, H], pairs=N * F,
               counted=int(got.mask.sum()), off_image=int((~inside).sum()),
               behind_camera=int((z <= 0).sum()),
               near_plane=int((z.abs() <= 1e-12).sum()), bit_identical=True,
               max_abs_err=0.0)
    if timed and DEVICE == "cuda":
        B = lights.numel() // F if kw["model"] != "LED" else 0
        pixels = _distinct_pixels(got.uv, H, W)
        # outputs 69 bytes a pair, vis 1; a voxel's inputs (idx, dist,
        # albedo, grad, nbr_idx, nbr_dist_const, nbr_dir, valid) 89 bytes;
        # the frames' poses and lights, K; the distinct pixels read once
        res_bytes = (N * F * 70 + N * 89 + F * (64 + 4 * B) + 36 + pixels * 12)
        # p_cam and g_img read, J0 and Ji written: 84 bytes a pair; a voxel's
        # inputs (dist, albedo, grad, nbr_idx, nbr_dist_const, nbr_dir) 76
        jac_bytes = N * F * 84 + N * 76 + F * (64 + 4 * B) + 36
        rargs = (prob, geom, dist, albedo, grad, poses, images, K, lights)
        out["residual_pass"] = dict(
            distinct_pixels=pixels, bytes=res_bytes,
            bound_ms=res_bytes / HBM_BYTES_PER_S * 1e3,
            ms=_time_ms(lambda: RS.residual_pass(*rargs, **kw), flush),
            plain_ms=_time_ms(lambda: RS.residual_pass_plain(*rargs, **kw), flush),
            library_ms=None)
        out["dist_jacobian"] = dict(
            bytes=jac_bytes, bound_ms=jac_bytes / HBM_BYTES_PER_S * 1e3,
            ms=_time_ms(lambda: RS.dist_jacobian(*jargs, **jkw), flush),
            plain_ms=_time_ms(lambda: RS.dist_jacobian_plain(*jargs, **jkw), flush),
            library_ms=None)
        for k in ("residual_pass", "dist_jacobian"):
            out[k]["share_of_bound"] = out[k]["bound_ms"] / out[k]["ms"]
    return out


def _sh2_lights(lights, seed):
    """[F,9] SH2 lights: the SH1 lights [F,4] and small seeded quadratic
    coefficients."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    quad = 0.05 * torch.randn((lights.shape[0], 5), generator=gen)
    return torch.cat([lights, quad.to(lights.device)], dim=1)


def _megapixel(args):
    """The main run's problem seen at MEGA_W x MEGA_H over its first MEGA_F
    keyframes: K scaled to the image (pixel centres kept), the keyframe
    images resampled bilinearly -> args of _refine_case."""
    import torch

    prob, geom, dist, albedo, grad, poses, images, K, lights = args
    H, W = images.shape[1], images.shape[2]
    sx, sy = MEGA_W / W, MEGA_H / H
    K2 = K.clone()
    K2[0, 0], K2[1, 1] = K[0, 0] * sx, K[1, 1] * sy
    K2[0, 2], K2[1, 2] = (K[0, 2] + 0.5) * sx - 0.5, (K[1, 2] + 0.5) * sy - 0.5
    big = torch.nn.functional.interpolate(
        images[:MEGA_F].permute(0, 3, 1, 2), size=(MEGA_H, MEGA_W),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).contiguous()
    return (prob._replace(vis=prob.vis[:, :MEGA_F]), geom, dist, albedo, grad,
            poses[:MEGA_F].contiguous(), big, K2, lights[:MEGA_F].contiguous())


def _off_image_poses(args, rd):
    """The problem's poses with keyframe 1 moved forward along its optical
    axis by the median depth of its surface points (about half of them then
    lie behind the camera) and keyframe 2 turned by 0.5 rad about its y axis
    (most projections leave the image)."""
    import torch

    poses = args[5].clone()
    z = rd.p_cam[:, 1, 2][args[0].valid]
    poses[1, :3, 3] += poses[1, :3, 2] * torch.median(z)
    c, s_ = float(np.cos(0.5)), float(np.sin(0.5))
    turn = torch.tensor([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], dtype=poses.dtype,
                        device=poses.device)
    poses[2, :3, :3] = poses[2, :3, :3] @ turn
    return args[:5] + (poses,) + args[6:]


def refine_kernels(main_run, led_run):
    """The refinement's two kernels (csrc/residual.cu) against their plain
    versions on the card, bit for bit, at the main path's shapes:
    (a) the main run's problem at its final state (40 keyframes of 640x480,
        SH1) under every loss, and with SH2 lights under every loss;
    (b) the LED run's problem after the upsample under every loss, and
        with the loop's finite-difference step there (twice the grid's
        voxel size: the loop keeps the step it started with);
    (c) the main problem with one keyframe moved past the surface (points
        behind the camera) and one turned (projections off the image);
    (d) the megapixel case: MEGA_F keyframes of MEGA_W x MEGA_H (the plain
        version's per-frame patch path);
    (e) the tiles' edges (_edge_cases).
    Timed (median of KERNEL_REPS, L2 flushed): (a) SH1 and SH2 under the
    main run's loss, (b), (c) and (d); the main case's tile plans and the
    blocks an SM holds (_plans); the pass on small images (_small_images);
    with --residual-parent, the main case on an earlier source in turns
    (_parent_ab).  Launches made here are on no path.  -> facts."""
    import torch
    from psgradientsdf_tpu_torch.refine import patches
    from psgradientsdf_tpu_torch.utils.robust import loss_from_name

    flush = (torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
             if DEVICE == "cuda" else None)
    ref = main_run["pipe"].refiner
    args = ref._args()
    skw = ref._static_kwargs()
    cases = []
    sh2 = args[:8] + (_sh2_lights(args[8], SEED),)
    for lights_args, order, model in ((args, 1, "SH1"), (sh2, 2, "SH2")):
        for name in LOSS_NAMES:
            kw = dict(skw, model=model, order=order, loss=loss_from_name(name))
            cases.append(_refine_case(f"main {model} {name}", lights_args, kw, flush,
                                      timed=kw["loss"] == skw["loss"]))
    led = led_run["pipe"].refiner
    lkw = led._static_kwargs()
    for name in LOSS_NAMES:
        kw = dict(lkw, loss=loss_from_name(name))
        cases.append(_refine_case(f"LED {name}", led._args(), kw, flush,
                                  timed=kw["loss"] == lkw["loss"]))
    # the loop's finite-difference step after the upsample: the step it
    # started with, twice the grid's voxel size (the voxel centres stay on
    # the grid's)
    cases.append(_refine_case("LED, the loop's step after the upsample (2 h)",
                              led._args(), dict(lkw, voxel_size=2.0 * led.geom.voxel_size),
                              flush))
    from psgradientsdf_tpu_torch.ops import residual as RS

    off = _off_image_poses(args, RS.residual_pass_plain(*args, **skw))
    case = _refine_case("off the image and behind the camera", off, skw, flush,
                        timed=True)
    check(case["behind_camera"] > 1000 and case["off_image"] > 0.05 * case["pairs"],
          f"the off-image case: {case['behind_camera']} pairs behind the camera, "
          f"{case['off_image']} off the image")
    cases.append(case)
    mega = _megapixel(args)
    F, Hm, Wm = mega[6].shape[0], mega[6].shape[1], mega[6].shape[2]
    check(F * Hm * Wm * 9 * 4 > patches._SPAN_BYTES_LIMIT,
          "the megapixel case would not take the plain version's per-frame path")
    case = _refine_case(f"megapixel {Wm}x{Hm}", mega, skw, flush, timed=True)
    case["image_bytes"] = int(mega[6].numel() * 4)
    check(case["counted"] > 0.5 * int((mega[0].vis & mega[0].valid[:, None]).sum()),
          f"megapixel: {case['counted']} pairs counted, most should land inside")
    del mega
    cases.append(case)
    cases += _edge_cases(args, skw, flush)
    facts = dict(cases=cases, checked=len(cases))
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        facts["plan"] = _plans(args)
        kw = dict(skw, model="SH1", order=1)
        facts["small_images"] = _small_images(args, kw, flush)
        if "--residual-parent" in sys.argv[1:]:
            facts["parent"] = _parent_ab(args, kw, flush)
        torch.cuda.empty_cache()
    return facts


def _row_subset(args, rows):
    """The problem's rows `rows` alone, every stencil neighbour's distance
    frozen into nbr_dist_const (as a mesh block's view) -> args."""
    import torch

    prob, geom, dist, albedo, grad, poses, images, K, lights = args
    idx = prob.nbr_idx[rows]
    frozen = torch.where(idx >= 0, dist[idx.clamp(min=0)], prob.nbr_dist_const[rows])
    sub = prob._replace(
        valid=prob.valid[rows], idx_xyz=prob.idx_xyz[rows], dist=dist[rows],
        albedo=albedo[rows], grad_stored=grad[rows], vis=prob.vis[rows],
        nbr_dir=prob.nbr_dir[rows], nbr_idx=torch.full_like(idx, -1),
        nbr_dist_const=frozen, nbr_albedo_const=prob.nbr_albedo_const[rows],
        lap_idx=torch.full_like(prob.lap_idx[rows], -1),
        lap_dist_const=prob.lap_dist_const[rows], n_surface=int(rows.numel()))
    return (sub, geom, dist[rows], albedo[rows], grad[rows], poses, images, K, lights)


def _frame_subset(args, frames):
    """The problem seen from keyframes `frames` (indices into the keyframes,
    repeats allowed) -> args."""
    prob, geom, dist, albedo, grad, poses, images, K, lights = args
    return (prob._replace(vis=prob.vis[:, frames].contiguous()), geom, dist, albedo,
            grad, poses[frames].contiguous(), images[frames].contiguous(), K,
            lights[frames].contiguous())


def _edge_cases(args, skw, flush):
    """The tiles' edges, both kernels bit for bit with G: one keyframe, an
    odd keyframe count (spans off 16-byte multiples), one voxel, one voxel
    past a multiple of each kernel's V, and keyframes past P (frame-range
    tiles) on a few rows under SH1 and on more rows than the grid takes in
    one turn under SH1 and SH2 (a block's later tiles reload the frame
    terms) -> cases."""
    import torch
    from psgradientsdf_tpu_torch.ops import residual as RS

    prob = args[0]
    N, F = prob.vis.shape
    dev = prob.vis.device
    mid = N // 2 + int(torch.nonzero(prob.valid[N // 2:])[0])
    P = max(RS.PAIRS_PER_TILE.values())
    long_f = torch.arange(P + EDGE_RANGE_EXTRA, device=dev) % F
    sh2 = args[:8] + (_sh2_lights(args[8], SEED),)

    def rows(n):
        return torch.arange(mid, mid + n, device=dev)

    specs = [
        ("F=1", _frame_subset(args, torch.arange(1, device=dev)), 1),
        (f"F={EDGE_ODD_F}", _frame_subset(args, torch.arange(EDGE_ODD_F, device=dev) % F), 1),
        ("N=1", _row_subset(args, rows(1)), 1),
    ]
    for kernel in ("residual", "jacobian"):
        V = RS._tile_plan(N, F, kernel=kernel).voxels
        specs.append((f"N={V + 1} ({kernel} V={V})", _row_subset(args, rows(V + 1)), 1))
    few, many = EDGE_RANGE_ROWS
    specs += [
        (f"frame-range F={long_f.numel()}, N={few}",
         _frame_subset(_row_subset(args, rows(few)), long_f), 1),
        (f"frame-range F={long_f.numel()}, N={many}",
         _frame_subset(_row_subset(args, rows(many)), long_f), 1),
        (f"frame-range F={long_f.numel()}, N={many}, SH2",
         _frame_subset(_row_subset(sh2, rows(many)), long_f), 2),
    ]
    cases = []
    for what, case_args, order in specs:
        kw = dict(skw, model="SH1" if order == 1 else "SH2", order=order)
        n, f = case_args[0].vis.shape
        case = _refine_case(f"edge {what}", case_args, kw, flush)
        case["tile"] = {k: RS._tile_plan(n, f, kernel=k)._asdict()
                        for k in ("residual", "jacobian")}
        if DEVICE == "cuda":
            case["grid"] = {k: _sm_count() * RS.blocks_per_sm(
                                k, RS._tile_plan(n, f, kernel=k), DEVICE)
                            for k in ("residual", "jacobian")}
            if n == many:
                check(all(case["tile"][k]["tiles"] > case["grid"][k] for k in case["grid"]),
                      f"{what}: fewer tiles than the grid's blocks")
        cases.append(case)
    return cases


def _sm_count():
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def _plans(args):
    """The main case's tile plans, each kernel's shared memory a block and
    the blocks an SM holds."""
    from psgradientsdf_tpu_torch.ops import residual as RS

    N, F = args[0].vis.shape
    out = {}
    for kernel in ("residual", "jacobian"):
        plan = RS._tile_plan(N, F, kernel=kernel)
        out[kernel] = dict(
            pairs_per_tile=RS.PAIRS_PER_TILE[kernel], voxels=plan.voxels,
            frames=plan.frames, tiles=plan.tiles, smem_bytes=plan.smem_bytes,
            blocks_per_sm=RS.blocks_per_sm(kernel, plan, DEVICE),
            threads_per_block=RS.BLOCK_THREADS)
    return out


def _small_images(args, kw, flush):
    """The residual pass of the main case on its keyframe images cut to
    SMALL_IMAGES (its patches in the L1 cache), bit for bit against the
    plain version, and timed: the pass without most of its pixel traffic."""
    import torch
    from psgradientsdf_tpu_torch.ops import residual as RS

    images = args[6]
    small = torch.nn.functional.interpolate(
        images.permute(0, 3, 1, 2), size=SMALL_IMAGES[::-1]).permute(0, 2, 3, 1).contiguous()
    sargs = args[:6] + (small,) + args[7:]
    check(all(_bits_same(a, b) for a, b in zip(RS.residual_pass(*sargs, **kw),
                                                RS.residual_pass_plain(*sargs, **kw))),
          "residual_pass differs on the small images")
    return dict(size=list(SMALL_IMAGES), residual_pass=_time_ms(
        lambda: RS.residual_pass(*sargs, **kw), flush))


def _parent_ab(args, kw, flush):
    """The main case on this residual.cu and on the --residual-parent
    source (an earlier residual.cu of the same C interface, built here into
    a temporary directory), each held bit for bit against the plain
    version, timed in turns: this, the parent, the parent, this
    -> {"this"|"parent": {kernel: [ms, ms]}}."""
    import ctypes
    from psgradientsdf_tpu_torch import kernels
    from psgradientsdf_tpu_torch.ops import residual as RS

    src = sys.argv[sys.argv.index("--residual-parent") + 1]
    prob, geom, dist, albedo, grad, poses, images, K, lights = args
    want = RS.residual_pass_plain(*args, **kw)
    jkw = dict(model=kw["model"], order=kw["order"], voxel_size=kw["voxel_size"])
    jargs = (prob, geom, want, dist, albedo, grad, poses, K, lights)
    _, want_j = RS.dist_jacobian_plain(*jargs, **jkw)
    times = {name: {"residual_pass": [], "dist_jacobian": []} for name in ("this", "parent")}
    with tempfile.TemporaryDirectory(prefix="residual_parent_") as tmp:
        lib = os.path.join(tmp, "libresidual_parent.so")
        proc = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        check(proc.returncode == 0, f"nvcc on {src} failed:\n{proc.stdout}")
        parent = ctypes.CDLL(lib)
        parent.residual_pass.argtypes = [ctypes.POINTER(RS._ResidualArgs), ctypes.c_void_p]
        parent.dist_jacobian.argtypes = [ctypes.POINTER(RS._JacobianArgs), ctypes.c_void_p]
        libs = dict(this=RS._library(), parent=parent)
        saved = RS._bound
        try:
            for name in ("this", "parent", "parent", "this"):
                RS._bound = libs[name]
                got, got_j = RS.residual_pass(*args, **kw), RS.dist_jacobian(*jargs, **jkw)[1]
                _sync()
                for field, a, b in zip(got._fields, got, want):
                    check(_bits_same(a, b), f"{name}: residual_pass {field} differs")
                for field in ("J0", "Ji"):
                    check(_bits_same(getattr(got_j, field), getattr(want_j, field)),
                          f"{name}: dist_jacobian {field} differs")
                times[name]["residual_pass"].append(
                    _time_ms(lambda: RS.residual_pass(*args, **kw), flush))
                times[name]["dist_jacobian"].append(
                    _time_ms(lambda: RS.dist_jacobian(*jargs, **jkw), flush))
        finally:
            RS._bound = saved
    return times


# ------------------------------------------- the distance block's solve


def _loop_weights(ref):
    """The regularizer weights the refiner's loop used last (normalised by
    E / E_reg before the loop): from the last energy record and the
    energies at the final state -> (w_n, w_l)."""
    last = ref.energy_trace[-1]
    _, E_n, E_l, _ = ref.energies()
    w_n = last["normal_reg"] / E_n if E_n > 0 else 0.0
    w_l = last["laplacian_reg"] / E_l if E_l > 0 else 0.0
    return w_n, w_l


def _dist_inputs(ref, w_n, w_l, diag_only=False):
    """The refiner's distance block at its state: the residual pass, the
    distance Jacobian (and a call that forms it again), the regularizer
    operators (the Laplacian's diagonal alone with `diag_only`) and the
    refiner's reverse stencil table -> dict."""
    from psgradientsdf_tpu_torch.ops import residual as RS
    from psgradientsdf_tpu_torch.refine import solvers

    args = ref._args()
    skw = ref._static_kwargs()
    prob, geom, dist, albedo, grad, poses, images, K, lights = args
    rd = RS.residual_pass(*args, **skw)
    _, DJ = RS.dist_jacobian(prob, geom, rd, dist, albedo, grad, poses, K, lights,
                             model=skw["model"], order=skw["order"],
                             voxel_size=skw["voxel_size"])
    eik, lap = solvers.reg_operators(prob, dist, skw["voxel_size"], reg_weight_n=w_n,
                                     reg_weight_l=w_l, laplacian_diag_only=diag_only)
    jacobian = lambda: RS.dist_jacobian(prob, geom, rd, dist, albedo, grad, poses, K, lights,
                                        model=skw["model"], order=skw["order"],
                                        voxel_size=skw["voxel_size"])[1]
    return dict(prob=prob, rd=rd, DJ=DJ, eik=eik, lap=lap, stencil=ref.stencil,
                w_n=w_n, w_l=w_l, damping=float(ref.cfg.damping), jacobian=jacobian)


def _rows_alone(c, rows):
    """The rows `rows` of a distance block alone, every stencil link cut
    (their neighbours frozen) -> dict."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg

    p = c["prob"]
    cut = lambda t: torch.full_like(t[rows], -1)
    prob = p._replace(valid=p.valid[rows], idx_xyz=p.idx_xyz[rows],
                      nbr_idx=cut(p.nbr_idx), lap_idx=cut(p.lap_idx))
    sub = lambda nt: None if nt is None else nt._replace(
        **{k: v[rows].contiguous() for k, v in nt._asdict().items()
           if isinstance(v, torch.Tensor) and k not in ("nbr_idx", "lap_idx")})
    return dict(c, prob=prob, rd=sub(c["rd"]), DJ=sub(c["DJ"]), eik=sub(c["eik"]),
                lap=sub(c["lap"]), stencil=distcg.stencil_reverse(prob))


def _cg_check(what, A, t, valid, st, lap, kw):
    """dist_cg twice (bit for bit) and against the plain solve: the same
    steps unless the plain r.r lies within DIST_CG_EDGE of the threshold at
    the test where they part, delta within DIST_CG_TOL of max|delta| ->
    the facts."""
    from psgradientsdf_tpu_torch.ops import distcg as DC

    s1, s2, sp, trace = [], [], [], []
    d1 = DC.dist_cg(A, t, valid, st, lap, **kw, steps_out=s1)
    d2 = DC.dist_cg(A, t, valid, st, lap, **kw, steps_out=s2)
    dp = DC.dist_cg_plain(A, t, valid, st, lap, **kw, steps_out=sp, trace=trace)
    _sync()
    k1, kp = int(s1[0]), int(sp[0])
    check(_bits_same(d1, d2) and k1 == int(s2[0]),
          f"dist_cg: two kernel runs differ ({what})")
    edge = None
    if k1 != kp:
        rr, thr = trace[min(k1, kp)]
        edge = abs(rr - thr) / thr
        check(edge <= DIST_CG_EDGE, f"dist_cg: {k1} steps, the plain solve {kp}, "
                                    f"r.r {rr:.6g} against {thr:.6g} ({what})")
    scale = float(dp.abs().max())
    err = _abs_err(d1, dp)
    check(err <= DIST_CG_TOL * scale, f"dist_cg: delta off the plain solve's by "
                                      f"{err:.3g} of max {scale:.3g} ({what})")
    return dict(case=what, rows=A.shape[0], valid_rows=int(valid.sum()),
                static=kw["cg_static"], laplacian=lap is not None,
                steps=k1, plain_steps=kp, threshold_edge=edge,
                dist_cg_runs_bit_identical=True, max_abs_err=err,
                max_abs_delta=scale, relative_err=err / scale if scale > 0 else 0.0,
                plan=_cg_plan_facts(_cg_plan_of(A, lap)))


def _cg_plan_of(A, lap, update=False):
    """dist_cg's plan for these rows (with the update stage's barrier): the
    card's (cg_plan); in a CPU rehearsal the plan for an H100's 132 SMs."""
    from psgradientsdf_tpu_torch.ops import distcg as DC

    kw = dict(use_lap=lap is not None, lap_nbr=lap is not None and lap.nbr_coef != 0.0,
              update=update)
    if DEVICE == "cuda":
        return DC.cg_plan(A.device, A.shape[0], **kw)
    return DC._cg_plan(A.shape[0], sms=132, **kw)


def _cg_plan_facts(plan):
    from psgradientsdf_tpu_torch.ops import distcg as DC

    return dict(blocks=plan.blocks, rows_per_block=plan.tile, mode=DC.MODES[plan.mode],
                smem_bytes=plan.smem_bytes, barriers_per_step=plan.barriers,
                barriers_after=plan.tail)


def _off_boundary(t, floats=1):
    """A copy of the float tensor t whose base lies `floats` floats past a
    16-byte boundary (the caching allocator's blocks are 512-byte aligned)."""
    import torch

    buf = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    v = buf[floats:].view(t.shape)
    v.copy_(t)
    check(v.data_ptr() % 16 == 4 * floats, f"a copy {floats} floats off a 16-byte boundary")
    return v


def _misaligned(rd):
    """rd with w one float off a 16-byte boundary (a copy): dist_system's
    lanes then read device memory in place of the bulk-copied ring."""
    return rd._replace(w=_off_boundary(rd.w))


def _system_case(what, c, frames=None, copies=1, rows=None):
    """dist_system on a distance block's inputs cut or grown (its keyframes
    `frames`, repeated past F; `copies` copies of its rows; the first `rows`
    of them), bulk-copied and (w off a 16-byte boundary) with the lanes'
    loads, each bit for bit against dist_system_plain -> facts with the
    plans."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC

    rd, DJ, eik = c["rd"], c["DJ"], c["eik"]
    F = rd.w.shape[1]
    pick = lambda x, dim: x if frames is None else x.index_select(
        dim, torch.tensor(frames, device=x.device) % F)
    grow = lambda x: x.repeat(copies, *([1] * (x.dim() - 1)))[:rows].contiguous()
    rd = rd._replace(w=grow(pick(rd.w, 1)), r=grow(pick(rd.r, 1)))
    DJ = DJ._replace(J0=grow(pick(DJ.J0, 1)), Ji=grow(pick(DJ.Ji, 2)))
    if eik is not None:
        eik = eik._replace(r=grow(eik.r), J0=grow(eik.J0), Ji=grow(eik.Ji))
    want = DC.dist_system_plain(rd, DJ, eik, reg_weight_n=c["w_n"])
    N, Fc = rd.w.shape[:2]
    out = dict(case=what, rows=N, keyframes=Fc, lanes=DC.system_lanes(3 * Fc))
    for staged, r in ((True, rd), (False, _misaligned(rd))):
        got = DC.dist_system(r, DJ, eik, reg_weight_n=c["w_n"])
        _sync()
        for name, a, b in (("A", got[0], want[0]), ("t", got[1], want[1])):
            check(_bits_same(a, b), f"dist_system differs from its plain version: "
                                    f"{what}, {name}, bulk-copied={staged}, by up to "
                                    f"{_abs_err(a, b)}")
        if DEVICE == "cuda":
            plan = DC.system_plan(rd.w.device, N, 3 * Fc, staged=staged)
            out["plan" if staged else "plan_lanes_loads"] = plan._asdict()
    out["bit_identical"] = True
    return out


def _system_cases(main, led):
    """dist_system bit for bit at each edge of its lanes rule (the last F
    of each lane count and the first of the next, from the main block's
    keyframes, repeated past its 40), one keyframe, the main and LED
    widths, eight copies of the main block and a ragged last tile (and a
    run with 1-3 floats past its 16-byte body) -> [facts]."""
    from psgradientsdf_tpu_torch.ops import distcg as DC

    N = main["rd"].w.shape[0]
    edges = []
    for F in range(1, 200):
        if DC.system_lanes(3 * (F + 1)) != DC.system_lanes(3 * F):
            edges += [F, F + 1]
    cases = [_system_case(f"{F} keyframe{'s' if F > 1 else ''}", main, frames=list(range(F)))
             for F in [1] + edges]
    cases += [_system_case("main SH1", main), _system_case("LED after the upsample", led),
              _system_case("eight copies of the main block", main, copies=8),
              _system_case("a ragged last tile", main, rows=N - 3),
              _system_case("5 keyframes, a ragged last tile", main, frames=list(range(5)),
                           rows=N - 3)]
    check({c["lanes"] for c in cases} == {4, 8, 16, 32},
          "a lane count of dist_system was not exercised")
    return cases


def _dist_case(what, c, static, flush, timed=False):
    """dist_system against its plain version bit for bit, then dist_cg
    (_cg_check).  With `timed`, on the card: both kernels' ms, plain_ms,
    library_ms and byte bounds, and dist_cg's barrier floor -> dict."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC

    rd, DJ, eik, lap, st = c["rd"], c["DJ"], c["eik"], c["lap"], c["stencil"]
    valid = c["prob"].valid
    skw = dict(reg_weight_n=c["w_n"])
    A, t = DC.dist_system(rd, DJ, eik, **skw)
    A2, t2 = DC.dist_system_plain(rd, DJ, eik, **skw)
    _sync()
    for name, a, b in (("A", A, A2), ("t", t, t2)):
        check(_bits_same(a, b), f"dist_system differs from its plain version: "
                                f"{what}, {name}, by up to {_abs_err(a, b)}")
    kw = dict(reg_weight_l=c["w_l"], damping=c["damping"], cg_iters=100,
              cg_tol=1e-6, cg_static=static)
    out = _cg_check(what, A, t, valid, st, lap, kw)
    k1 = out["steps"]
    N, F = rd.w.shape[0], rd.w.shape[1]
    out.update(keyframes=F, w_n=c["w_n"], w_l=c["w_l"],
               dist_system_bit_identical=True)
    if timed and DEVICE == "cuda":
        dev = A.device
        J = 3 * F
        # w, r, J0 and Ji read once (24 bytes a pair), the Eikonal row (20
        # bytes), A and t written (56 bytes a row)
        sys_bytes = N * J * 24 + (N * 20 if eik is not None else 0) + N * 56
        a = torch.stack([DJ.J0.reshape(N, J), *DJ.Ji.reshape(N, 3, J).unbind(1)], -1)
        wa = rd.w.reshape(N, J, 1) * a
        rdm = _misaligned(rd)                    # the lanes' loads
        out["dist_system"] = dict(
            bytes=sys_bytes, bound_ms=sys_bytes / HBM_BYTES_PER_S * 1e3,
            ms=_time_ms(lambda: DC.dist_system(rd, DJ, eik, **skw), flush),
            lanes_loads_ms=_time_ms(lambda: DC.dist_system(rdm, DJ, eik, **skw), flush),
            lanes=DC.system_lanes(J),
            plan=DC.system_plan(dev, N, J)._asdict(),
            plain_ms=_time_ms(lambda: DC.dist_system_plain(rd, DJ, eik, **skw), flush),
            library_ms=_time_ms(lambda: torch.einsum("nji,njk->nik", wa, a), flush),
            library_call="torch.einsum('nji,njk->nik', w a, a) over [N, F*3, 4]")
        del wa, a, rdm
        # A, t, nbr and rev (int32) and the mask read once, delta written
        # once; the Laplacian's residual where it is on, and lap_idx only
        # where its neighbour term is read (the kernel's lap_nbr)
        cg_bytes = N * (40 + 16 + 12 + 24 + 1 + 4)
        if lap is not None:
            cg_bytes += N * 4 + (N * 24 if lap.nbr_coef != 0.0 else 0)
        # the prologue's grid.sync and the plan's barriers a step
        plan = _cg_plan_of(A, lap)
        barriers = 1 + plan.barriers * k1
        out["dist_cg"] = dict(
            bytes=cg_bytes, bound_ms=cg_bytes / HBM_BYTES_PER_S * 1e3,
            ms=_time_ms(lambda: DC.dist_cg(A, t, valid, st, lap, **kw), flush),
            plain_ms=_time_ms(lambda: DC.dist_cg_plain(A, t, valid, st, lap, **kw), flush),
            library_ms=None, blocks=plan.blocks, grid_barriers=barriers,
            barrier_floor_ms=_time_ms(lambda: DC.barrier_floor(dev, plan, barriers), flush),
            # the same count of grid.syncs alone (the parent's barrier)
            grid_sync_floor_ms=_time_ms(
                lambda: DC.barrier_floor(dev, plan, barriers, kind=0), flush))
        for k in ("dist_system", "dist_cg"):
            out[k]["share_of_bound"] = out[k]["bound_ms"] / out[k]["ms"]
    return out


@contextlib.contextmanager
def _traced(cpu=False):
    """A torch.profiler session on the card (and the host with `cpu`) that
    opens with utils/profiling.py's warm-up: WARMUP throwaway spin kernels
    and a synchronize.  On the card machine the profiler drops the first
    device records of a session as out of its capture window (kineto's
    "Out-of-range" count: 3 to 6 records, always the session's first, in
    sessions after the first minute of a run; a window padded by 0.25 s lost
    them all the same), so a short body such as one albedo block could lose
    all of its kernels.  The warm-up takes those losses; its kernel is left
    out of every count (_kernel_rows, _runtime_calls), and the session fails
    unless some of its warm-up records arrived, the records that come after
    them being kept.  -> the profile object, with `warmup_dropped`, the
    warm-up records the session lost."""
    from psgradientsdf_tpu_torch.utils import profiling

    with profiling.session(cuda=True, cpu=cpu) as prof:
        yield prof
    seen = profiling.warmup_kept(prof)
    check(seen > 0, "a trace lost every record of its warm-up: its body's device "
                    "activity may be lost too")
    prof.warmup_dropped = profiling.WARMUP - seen


def _runtime_calls(prof):
    """The host's CUDA runtime and driver calls a _traced session recorded,
    less its warm-up's launches and synchronize and its closing
    synchronize."""
    from psgradientsdf_tpu_torch.utils import profiling

    return sum(e.count for e in prof.key_averages()
               if not str(e.device_type).endswith("CUDA") and e.key.startswith("cu")
               ) - (profiling.WARMUP + 2)


def _kernel_rows(prof):
    """(device us, launches, name) of each kernel a trace saw, its warm-up
    left out (_traced)."""
    from psgradientsdf_tpu_torch.utils import profiling

    return [(_device_us(e), e.count, e.key) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and not profiling.is_warmup(e.key)]


def _is_index_add(name):
    return "indexFunc" in name or "index_add" in name


def _distance_block_traces(ref, w_n, w_l):
    """One distance block from the main run's final state through
    ops/distcg.py (optimizer._dist_core on the refiner's table), traced:
    exactly three launches (dist_jacobian, dist_system and dist_cg with the
    tail's stages) -> its device kernels, index_add_ kernels (none may run), device time,
    host seconds (median of 3 untraced) and the warm-up records the trace
    lost (_traced)."""
    import torch
    from psgradientsdf_tpu_torch.ops import residual as RS
    from psgradientsdf_tpu_torch.refine import optimizer

    args = ref._args()
    skw = ref._static_kwargs()
    prob, geom, dist, albedo, grad, poses, images, K, lights = args
    rd = RS.residual_pass(*args, **skw)

    def block():
        return optimizer._dist_core(
            prob, geom, rd, dist, albedo, grad, poses, K, lights, **skw,
            reg_weight_n=w_n, reg_weight_l=w_l, damping=float(ref.cfg.damping),
            laplacian_diag_only=False, stencil=ref.stencil)

    block()
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with _traced() as prof:
        block()
    rows = sorted(_kernel_rows(prof), reverse=True)
    out = dict(
        seconds=statistics.median(secs), warmup_dropped=prof.warmup_dropped,
        device_kernels=int(sum(r[1] for r in rows)),
        index_add_kernels=int(sum(r[1] for r in rows if _is_index_add(r[2]))),
        device_ms=sum(r[0] for r in rows) * 1e-3,
        top=[dict(name=k[:80], launches=n, device_ms=us * 1e-3)
             for us, n, k in rows[:8]])
    check(out["device_kernels"] > 0, "the profiler saw no kernel of a distance block")
    check(out["index_add_kernels"] == 0,
          f"the distance block ran {out['index_add_kernels']} index_add_ kernels")
    # three launches: the Jacobian, dist_system with the regularizer stage,
    # dist_cg with the update stage; no standalone tail kernel
    out["tail_kernels"] = {k: int(sum(r[1] for r in rows if k in r[2]))
                           for k in ("reg_operators_kernel", "dist_update_kernel")}
    out["block_kernels"] = {k: int(sum(r[1] for r in rows if k in r[2]))
                            for k in ("dist_jacobian_kernel", "dist_system_kernel",
                                      "dist_cg_kernel")}
    check(all(v == 0 for v in out["tail_kernels"].values())
          and all(v == 1 for v in out["block_kernels"].values())
          and out["device_kernels"] == 3,
          f"the distance block's launches: {out['device_kernels']} kernels, "
          f"{out['block_kernels']}, standalone tail {out['tail_kernels']}")
    return out


def _tiled_inputs(c, rows):
    """`rows` rows of disjoint copies of a distance block's system (the
    stencil tables offset by the rows before each copy; the links into rows
    past the cut cut too) -> (A, t, valid, stencil)."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC

    A, t = DC.dist_system(c["rd"], c["DJ"], c["eik"], reg_weight_n=c["w_n"])
    N = A.shape[0]
    copies = -(-rows // N)
    st = c["stencil"]
    tile = lambda ix: torch.cat([torch.where(ix >= 0, ix + k * N, ix)
                                 for k in range(copies)])[:rows]
    cut = lambda ix: torch.where(ix < rows, ix, -1).contiguous()
    tiled = DC.StencilReverse(cut(tile(st.nbr)), cut(tile(st.rev)), cut(tile(st.lap)),
                              st.source)
    return (A.repeat(copies, 1)[:rows].contiguous(), t.repeat(copies, 1)[:rows].contiguous(),
            c["prob"].valid.repeat(copies)[:rows].contiguous(), tiled)


def _tiled_cg_case(c, what, rows, mode, flush, timed=False):
    """dist_cg on `rows` rows of copies of a distance block's system
    (_tiled_inputs, scipy's stop rule, _cg_check), whose plan must take
    layout `mode` (None: any); with `timed`, on the card, its ms beside its
    bound."""
    from psgradientsdf_tpu_torch.ops import distcg as DC

    A, t, valid, st = _tiled_inputs(c, rows)
    kw = dict(reg_weight_l=0.0, damping=c["damping"], cg_iters=100, cg_tol=1e-6,
              cg_static=False)
    out = _cg_check(what, A, t, valid, st, None, kw)
    check(mode in (None, out["plan"]["mode"]),
          f"{what}: the {out['plan']['mode']} layout, expected {mode}")
    if timed and DEVICE == "cuda":
        cg_bytes = rows * (40 + 16 + 12 + 24 + 1 + 4)
        out.update(bound_ms=cg_bytes / HBM_BYTES_PER_S * 1e3,
                   ms=_time_ms(lambda: DC.dist_cg(A, t, valid, st, None, **kw), flush))
    return out


def _ptxas(src):
    """nvcc -Xptxas -v on a CUDA source -> {kernel: (registers, spill
    stores)} of its entry functions (the mangled names shortened)."""
    import re
    from psgradientsdf_tpu_torch import kernels

    with tempfile.TemporaryDirectory(prefix="ptxas_") as tmp:
        proc = subprocess.run(
            [kernels._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
             "-o", os.path.join(tmp, "k.cubin"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    check(proc.returncode == 0, f"nvcc -Xptxas -v on {src} failed:\n{proc.stdout}")
    out, name, spills = {}, None, 0
    for line in proc.stdout.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            for short, pat in (("dist_cg_kernel<tile>", "dist_cg_kernelILi0E"),
                               ("dist_cg_kernel<vectors>", "dist_cg_kernelILi1E"),
                               ("dist_cg_kernel<global>", "dist_cg_kernelILi2E"),
                               ("dist_barrier_kernel", "dist_barrier_kernel"),
                               ("dist_system_kernel<4, staged>",
                                "dist_system_kernelILi4ELb1E"),
                               ("dist_system_kernel<4, lanes' loads>",
                                "dist_system_kernelILi4ELb0E"),
                               ("dist_system_kernel<8, staged>",
                                "dist_system_kernelILi8ELb1E"),
                               ("dist_system_kernel<8, lanes' loads>",
                                "dist_system_kernelILi8ELb0E"),
                               ("dist_system_kernel<16, staged>",
                                "dist_system_kernelILi16ELb1E"),
                               ("dist_system_kernel<16, lanes' loads>",
                                "dist_system_kernelILi16ELb0E"),
                               ("dist_system_kernel<32, staged>",
                                "dist_system_kernelILi32ELb1E"),
                               ("dist_system_kernel<32, lanes' loads>",
                                "dist_system_kernelILi32ELb0E"),
                               ("pose_tiles_kernel<sh>", "pose_tiles_kernelILb0E"),
                               ("pose_tiles_kernel<led>", "pose_tiles_kernelILb1E"),
                               ("light_tiles_kernel<4>", "light_tiles_kernelILi4E"),
                               ("light_tiles_kernel<9>", "light_tiles_kernelILi9E"),
                               ("albedo_block_kernel<sh>", "albedo_block_kernelILb0ELb0E"),
                               ("albedo_block_kernel<sh, reg>", "albedo_block_kernelILb0ELb1E"),
                               ("albedo_block_kernel<led>", "albedo_block_kernelILb1ELb0E"),
                               ("albedo_block_kernel<led, reg>",
                                "albedo_block_kernelILb1ELb1E"),
                               ("fals_normals_kernel", "fals_normals_kernel"),
                               ("lapm_kernel", "lapm_kernel"),
                               ("light_led_kernel<F <= 32>", "light_led_kernelILb0E"),
                               ("light_led_kernel<F > 32>", "light_led_kernelILb1E"),
                               ("energy_sums_kernel<cauchy, vector loads>",
                                "energy_sums_kernelILi1ELb1E"),
                               ("energy_sums_kernel<cauchy, scalar loads>",
                                "energy_sums_kernelILi1ELb0E")):
                if pat in name:
                    name = short
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = dict(registers=int(m.group(1)), spill_stores=spills)
    return out


# the parent's dist_cg C interface (csrc/distcg.cu before the host plan):
# CgArgs with the grid and the partials, dist_cg_plan(n, &blocks)
class _ParentCgArgs(ctypes.Structure):
    _p, _i, _d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    _fields_ = [("A", _p), ("t", _p), ("nbr", _p), ("rev", _p), ("lap", _p),
                ("valid", _p), ("lap_r", _p), ("delta", _p), ("steps", _p),
                ("work", _p), ("partials", _p), ("n", _i), ("blocks", _i),
                ("maxiter", _i), ("fixed", _i), ("use_lap", _i), ("lap_nbr", _i),
                ("reg_weight_l", _d), ("diag_coef", _d), ("nbr_coef", _d),
                ("diag_coef_sq", _d), ("nbr_coef_sq", _d), ("damping", _d),
                ("tol_sq", _d), ("atol_sq", _d)]


def _parent_library(parent):
    """The parent's distcg library with its C interface's types set."""
    parent.dist_cg.argtypes = [ctypes.POINTER(_ParentCgArgs), ctypes.c_void_p]
    parent.dist_cg_plan.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    return parent


def _parent_solve(parent, A, t, valid, st, lap, kw):
    """A callable that runs the parent's dist_cg on these inputs (scipy's
    stop rule, kw's tolerance and damping) -> (delta, steps)."""
    import torch

    N = A.shape[0]
    blocks = ctypes.c_int64()
    check(parent.dist_cg_plan(N, ctypes.byref(blocks)) == 0, "the parent's plan")

    def run():
        delta = torch.empty((N,), dtype=torch.float32, device=A.device)
        steps = torch.empty((1,), dtype=torch.int64, device=A.device)
        work = torch.empty((13 * N,), dtype=torch.float32, device=A.device)
        part = torch.empty((4 * blocks.value,), dtype=torch.float32, device=A.device)
        a = _ParentCgArgs(
            A=A.data_ptr(), t=t.data_ptr(), nbr=st.nbr.data_ptr(), rev=st.rev.data_ptr(),
            lap=st.lap.data_ptr(), valid=valid.data_ptr(), delta=delta.data_ptr(),
            steps=steps.data_ptr(), work=work.data_ptr(), partials=part.data_ptr(), n=N,
            blocks=blocks.value, maxiter=kw["cg_iters"], fixed=0, damping=kw["damping"],
            tol_sq=kw["cg_tol"] ** 2, atol_sq=0.0)
        if lap is not None:
            a.lap_r, a.use_lap = lap.r.data_ptr(), 1
            a.lap_nbr = int(lap.nbr_coef != 0.0)
            a.reg_weight_l = float(kw["reg_weight_l"])
            a.diag_coef, a.nbr_coef = float(lap.diag_coef), float(lap.nbr_coef)
            a.diag_coef_sq, a.nbr_coef_sq = lap.diag_coef ** 2, lap.nbr_coef ** 2
        rc = parent.dist_cg(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the parent's dist_cg: CUDA error {rc}")
        return delta, steps
    return run


def _distcg_parent_ab(cases, flush):
    """dist_cg on this distcg.cu and on the --distcg-parent source (the
    parent's C interface, built here into a temporary directory; its
    launches are on no path and not counted), each held against the plain
    solve (its steps, DIST_CG_TOL), timed in turns: this, the parent, the
    parent, this -> {case: {"this"|"parent": [ms, ms]}}."""
    from psgradientsdf_tpu_torch.ops import distcg as DC

    src = sys.argv[sys.argv.index("--distcg-parent") + 1]
    out = {}
    with tempfile.TemporaryDirectory(prefix="distcg_parent_") as tmp:
        parent = _parent_library(_parent_build(src, tmp, "distcg_parent"))
        for what, c in cases:
            A, t = DC.dist_system(c["rd"], c["DJ"], c["eik"], reg_weight_n=c["w_n"])
            valid, st, lap = c["prob"].valid, c["stencil"], c["lap"]
            kw = dict(reg_weight_l=c["w_l"], damping=c["damping"], cg_iters=100,
                      cg_tol=1e-6, cg_static=False)
            run_parent = _parent_solve(parent, A, t, valid, st, lap, kw)
            sp = []
            dp = DC.dist_cg_plain(A, t, valid, st, lap, **kw, steps_out=sp)
            delta, steps = run_parent()
            _sync()
            scale = float(dp.abs().max())
            check(int(steps[0]) == int(sp[0]) and _abs_err(delta, dp) <= DIST_CG_TOL * scale,
                  f"the parent's dist_cg differs from the plain solve ({what})")
            runs = dict(this=lambda: DC.dist_cg(A, t, valid, st, lap, **kw),
                        parent=run_parent)
            times = {"this": [], "parent": []}
            for name in ("this", "parent", "parent", "this"):
                times[name].append(_time_ms(runs[name], flush))
            out[what] = dict(times, steps=int(sp[0]))
    return out


def _parent_build(src, tmp, name):
    """nvcc on an earlier source (csrc/ on the include path) into tmp ->
    the library."""
    from psgradientsdf_tpu_torch import kernels

    lib = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([kernels._find_nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR,
                           "-o", lib, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    check(proc.returncode == 0, f"nvcc on {src} failed:\n{proc.stdout}")
    return ctypes.CDLL(lib)


def _system_parent_ab(cases, flush):
    """dist_system on this distcg.cu and on the --system-parent source (any
    earlier distcg.cu whose SystemArgs is a prefix of this one's, as the one
    before the lanes rule; built here into a temporary directory, its
    launches on no path and not counted), the parent held to this kernel's
    A and t within 1e-5 of max|A| (its lanes sum in another order), timed in
    turns: this, the parent, the parent, this -> {case: {"this"|"parent":
    [ms, ms]}}."""
    from psgradientsdf_tpu_torch.ops import distcg as DC

    src = sys.argv[sys.argv.index("--system-parent") + 1]
    out = {}
    with tempfile.TemporaryDirectory(prefix="system_parent_") as tmp:
        parent = _parent_build(src, tmp, "distcg_parent")
        parent.dist_system.argtypes = [ctypes.POINTER(DC._SystemArgs), ctypes.c_void_p]
        for what, c in cases:
            rd, DJ, eik = c["rd"], c["DJ"], c["eik"]
            runs = dict(this=lambda: DC.dist_system(rd, DJ, eik, reg_weight_n=c["w_n"]),
                        parent=lambda: _parent_system(parent, rd, DJ, eik, c["w_n"]))
            (A, _), (Ap, _) = runs["this"](), runs["parent"]()
            _sync()
            check(_abs_err(Ap, A) <= 1e-5 * float(A.abs().max()),
                  f"the parent's dist_system differs from this one's ({what})")
            times = {"this": [], "parent": []}
            for name in ("this", "parent", "parent", "this"):
                times[name].append(_time_ms(runs[name], flush))
            out[what] = times
    return out


def _parent_system(parent, rd, DJ, eik, w_n):
    """The parent's dist_system on these rows -> (A, t)."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC

    N, F = rd.w.shape[:2]
    A = torch.empty((N, 10), dtype=torch.float32, device=rd.w.device)
    t = torch.empty((N, 4), dtype=torch.float32, device=rd.w.device)
    a = DC._SystemArgs(w=rd.w.data_ptr(), r=rd.r.data_ptr(), J0=DJ.J0.data_ptr(),
                       Ji=DJ.Ji.data_ptr(), A=A.data_ptr(), t=t.data_ptr(), n=N,
                       pairs=3 * F, eik=int(eik is not None), reg_weight_n=w_n)
    if eik is not None:
        a.eik_r, a.eik_J0, a.eik_Ji = eik.r.data_ptr(), eik.J0.data_ptr(), eik.Ji.data_ptr()
    rc = parent.dist_system(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"the parent's dist_system: CUDA error {rc}")
    return A, t


def dist_cg_kernels(main_run, led_run):
    """The distance block's two kernels (csrc/distcg.cu) against their plain
    versions on the card, at the main path's shapes: the main run's problem
    at its final state (SH1, the Eikonal weight its loop used) and the LED
    run's after the upsample (the Laplacian on), each under scipy's stop
    rule and cg_static's, the LED run's also with a Laplacian weight 100
    times its loop's and with the Laplacian's diagonal alone; then the
    edges: one row alone, a row whose three neighbours are all frozen, the
    rows of copies of the main system (_tiled_cg_case) in each of the
    plan's layouts (four copies, several rows a thread; the tile at the
    resident limit and the first row count past it; eight copies; the
    first row count past the vectors' limit), every row invalid (under both
    rules); each case's plan.
    Timed (median of KERNEL_REPS, L2 flushed): the main case and the LED
    case under scipy's rule with both barrier floors, the four-, eight- and
    the past-the-vectors' copies, and the one-row launch (dist_cg's latency
    floor).  Then the kernels' registers (nvcc -Xptxas -v), with
    --distcg-parent <distcg.cu> the main and LED cases on that earlier
    source in turns with this one (_distcg_parent_ab), and one distance
    block traced through the kernels (_distance_block_traces).  Launches
    made here are on no path.
    -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg

    flush = (torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
             if DEVICE == "cuda" else None)
    ref, led = main_run["pipe"].refiner, led_run["pipe"].refiner
    main_w, led_w = _loop_weights(ref), _loop_weights(led)
    check(main_w[0] > 0 and led_w[1] > 0, f"the loops' weights: {main_w}, {led_w}")
    main = _dist_inputs(ref, *main_w)
    cases = []
    for static in (False, True):
        cases.append(_dist_case("main SH1", main, static, flush, timed=not static))
    lc = _dist_inputs(led, *led_w)
    for static in (False, True):
        cases.append(_dist_case("LED after the upsample", lc, static, flush,
                                timed=not static))
    cases.append(_dist_case("LED, the Laplacian's weight x 100",
                            dict(lc, w_l=100.0 * led_w[1]), False, flush))
    cases.append(_dist_case("LED, the Laplacian's diagonal alone",
                            _dist_inputs(led, *led_w, diag_only=True), False, flush))
    del lc
    p = main["prob"]
    row = int(torch.nonzero(p.valid)[len(torch.nonzero(p.valid)) // 2, 0])
    one = _dist_case("one row", _rows_alone(main, torch.tensor([row], device=p.valid.device)),
                     False, flush, timed=True)
    check(one["steps"] == 1, f"one row: {one['steps']} steps")
    cases.append(one)
    nbr = p.nbr_idx.clone()
    nbr[row] = -1
    cut = p._replace(nbr_idx=nbr)
    cases.append(_dist_case("a row with three frozen neighbours",
                            dict(main, prob=cut, stencil=distcg.stencil_reverse(cut)),
                            False, flush))
    N = p.valid.shape[0]
    sms = _sm_count() if DEVICE == "cuda" else 132
    at_limit = sms * distcg.resident_tile_limit(False)
    past_vectors = sms * distcg.vector_tile_limit(False) + 1
    for what, rows, mode, timed in (
            ("four copies of the main system", 4 * N, None, True),
            ("the tile at the resident limit", at_limit, "tile", False),
            ("the first row count past it", at_limit + 1, "vectors", False),
            ("eight copies of the main system", 8 * N, None, True),
            ("the first row count past the vectors' limit", past_vectors, "global", True)):
        case = _tiled_cg_case(main, what, rows, mode, flush, timed=timed)
        if rows == at_limit:
            check(case["plan"]["rows_per_block"] == distcg.resident_tile_limit(False),
                  f"{what}: {case['plan']['rows_per_block']} rows a block")
        cases.append(case)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    none = p._replace(valid=torch.zeros_like(p.valid))
    for static in (False, True):
        case = _dist_case("every row invalid", dict(main, prob=none), static, flush)
        check(case["steps"] == 0 and case["max_abs_delta"] == 0.0,
              "every row invalid: a step or a nonzero delta")
        cases.append(case)
    led_case = next(c for c in cases if c["case"] == "LED after the upsample")
    check(led_case["plan"]["barriers_per_step"] == 3,
          "the LED case runs without the Laplacian's third barrier")
    check({c["plan"]["mode"] for c in cases} == set(distcg.MODES),
          "a layout of dist_cg was not exercised")
    system_cases = _system_cases(main, _dist_inputs(led, *led_w))
    facts = dict(cases=cases, checked=len(cases), system_cases=system_cases,
                 system_checked=len(system_cases))
    if DEVICE == "cuda":
        from psgradientsdf_tpu_torch import kernels

        facts["ptxas"] = _ptxas(kernels.source_path("distcg"))
        if "--system-parent" in sys.argv[1:]:
            facts["system_parent"] = _system_parent_ab(
                [("main SH1", main), ("LED after the upsample", _dist_inputs(led, *led_w))],
                flush)
            for case in cases:
                if case["case"] in facts["system_parent"] and "dist_system" in case:
                    case["dist_system"]["earlier_ms"] = statistics.median(
                        facts["system_parent"][case["case"]]["parent"])
        if "--distcg-parent" in sys.argv[1:]:
            facts["parent"] = _distcg_parent_ab(
                [("main SH1", main), ("LED after the upsample", _dist_inputs(led, *led_w))],
                flush)
        facts["latency_floor_ms"] = one["dist_cg"]["ms"]
        facts["distance_block"] = _distance_block_traces(ref, *main_w)
        torch.cuda.empty_cache()
    return facts


def _rd_rows(rd, rows):
    """The residual pass's pairs of voxels `rows` (a slice or an index)."""
    return type(rd)(*(t[rows].contiguous() for t in rd))


def _rd_frames(rd, frames):
    return type(rd)(*(t[:, frames].contiguous() for t in rd))


def _rd_weighted(rd, keep):
    """rd with w = r = 0 on the pairs where `keep` [N,F] is False (masked
    pairs, as the residual pass leaves them)."""
    import torch

    k = keep[..., None]
    return rd._replace(w=torch.where(k, rd.w, 0.0), r=torch.where(k, rd.r, 0.0))


def _held_normal_eqs(what, got, again, want, g_scale):
    """The kernel's (H, g) against the plain version's: H within
    NORMAL_EQ_TOL of each keyframe's max|H| (exactly 0 where that is 0), g
    within NORMAL_EQ_TOL of each keyframe's g_scale, H symmetric, two runs
    bit for bit -> the errors, relative to those scales."""
    import torch

    (H, g), (H2, g2), (Hp, gp) = got, again, want
    _sync()
    check(_bits_same(H, H2) and _bits_same(g, g2),
          f"{what}: two kernel runs differ")
    check(bool(torch.isfinite(H).all() and torch.isfinite(g).all()),
          f"{what}: H or g not finite")
    # the kernel writes both triangles from one sum (a rehearsal's plain
    # product is not symmetric to the bit)
    check(DEVICE != "cuda" or bool(torch.equal(H, H.transpose(1, 2))),
          f"{what}: H not symmetric")
    h_err = (H - Hp).abs().amax(dim=(1, 2))
    h_scale = Hp.abs().amax(dim=(1, 2))
    g_err = (g - gp).abs().amax(dim=1)
    check(bool((h_err <= NORMAL_EQ_TOL * h_scale).all()),
          f"{what}: H beyond {NORMAL_EQ_TOL} of max|H|: "
          f"{float((h_err / h_scale.clamp(min=1e-30)).max())}")
    check(bool((g_err <= NORMAL_EQ_TOL * g_scale).all()),
          f"{what}: g beyond {NORMAL_EQ_TOL} of sum |w r J|: "
          f"{float((g_err / g_scale.clamp(min=1e-30)).max())}")
    return dict(case=what, keyframes=int(H.shape[0]), bit_identical_runs=True,
                H_rel_err=float((h_err / h_scale.clamp(min=1e-30)).max()),
                g_rel_err=float((g_err / g_scale.clamp(min=1e-30)).max()),
                max_abs_err=max(float(h_err.max()), float(g_err.max())),
                zero_keyframes=int((h_scale == 0).sum()))


def _plan_facts(N, F, dim, led=False):
    """The normal-equation kernel's plan on the card (on a rehearsal, for an
    H100's 15 clusters of 8 blocks)."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq as NE

    plan = (NE.reduce_plan(torch.device("cuda", 0), N, F, dim, led) if DEVICE == "cuda"
            else NE._reduce_plan(N, F, dim, led, 15))
    return dict(plan._asdict(), blocks=plan.tiles * plan.chunks)


def _pose_case(what, rd, pargs, model, flush, timed=False):
    """pose_normal_eqs against pose_normal_eqs_plain on the same inputs
    (pargs: K, poses, albedo, grad_stored, lights).  With `timed`: its ms,
    plain_ms, library_ms (the one einsum nfcb,nfcd->fbd over a weighted
    Jacobian formed beforehand: J's formation excluded) and the bytes
    bound."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq as NE
    from psgradientsdf_tpu_torch.refine import jacobians

    K, poses = pargs[0], pargs[1]
    J = NE.pose_jacobian(jacobians.image_pi_grad(rd, K), rd, poses, *pargs[2:], model)
    g_scale = torch.einsum("nfc,nfcb->f", (rd.w * rd.r).abs(), J.abs())
    out = _held_normal_eqs(
        what, NE.pose_normal_eqs(rd, *pargs, model), NE.pose_normal_eqs(rd, *pargs, model),
        NE.pose_normal_eqs_plain(rd, *pargs, model), g_scale)
    N, F = rd.w.shape[0], rd.w.shape[1]
    out.update(model=model, voxels=N, pairs=N * F, plan=_plan_facts(N, F, 6, model == "LED"))
    if timed and DEVICE == "cuda":
        # g_img, p_cam, w and r read (60 bytes a pair), poses and K, under
        # the LED the voxels' albedo and gradient (24 bytes) and the light;
        # H and g written
        nbytes = (N * F * 60 + F * 64 + 36 + (N * 24 + 12 if model == "LED" else 0)
                  + F * 42 * 4)
        wJ = rd.w[..., None] * J
        out.update(
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ms=_time_ms(lambda: NE.pose_normal_eqs(rd, *pargs, model), flush),
            plain_ms=_time_ms(lambda: NE.pose_normal_eqs_plain(rd, *pargs, model), flush),
            library_ms=_time_ms(lambda: torch.einsum("nfcb,nfcd->fbd", wJ, J), flush))
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
        del wJ
    return out


def _light_case(what, rd, J, flush, timed=False):
    """light_normal_eqs_sh against solvers.light_normal_eqs_sh on the same
    inputs.  With `timed`: its ms, plain_ms, library_ms (the one [F,3N] x
    [3N,B*B] product wf @ JJ, its operands formed beforehand) and the bytes
    bound."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq as NE
    from psgradientsdf_tpu_torch.refine import solvers

    g_scale = torch.einsum("nfc,ncb->f", (rd.w * rd.r).abs(), J.abs())
    out = _held_normal_eqs(what, NE.light_normal_eqs_sh(rd, J),
                           NE.light_normal_eqs_sh(rd, J),
                           solvers.light_normal_eqs_sh(rd, J), g_scale)
    N, F, B = rd.w.shape[0], rd.w.shape[1], J.shape[-1]
    out.update(basis=B, voxels=N, pairs=N * F, plan=_plan_facts(N, F, B))
    if timed and DEVICE == "cuda":
        # w and r read (24 bytes a pair), J_l [N,3,B] once; H and g written
        nbytes = N * F * 24 + N * 12 * B + F * (B * B + B) * 4
        wf = rd.w.permute(1, 0, 2).reshape(F, N * 3)
        JJ = (J[..., :, None] * J[..., None, :]).reshape(N * 3, B * B)
        out.update(
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ms=_time_ms(lambda: NE.light_normal_eqs_sh(rd, J), flush),
            plain_ms=_time_ms(lambda: solvers.light_normal_eqs_sh(rd, J), flush),
            library_ms=_time_ms(lambda: wf @ JJ, flush))
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def _back_to_back(rd, pargs, J):
    """Three calls on one stream with no wait between (pose, light, pose),
    each bit for bit against its own earlier run: a call that left its
    ticket set would elect no last block, or the wrong one, in the next."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq as NE

    pose = NE.pose_normal_eqs(rd, *pargs, "SH1")
    _sync()
    light = NE.light_normal_eqs_sh(rd, J)
    _sync()
    runs = (NE.pose_normal_eqs(rd, *pargs, "SH1"), NE.light_normal_eqs_sh(rd, J),
            NE.pose_normal_eqs(rd, *pargs, "SH1"))
    _sync()
    for got, want, what in zip(runs, (pose, light, pose), ("pose", "light", "pose again")):
        check(all(bool(torch.equal(a, b)) for a, b in zip(got, want)),
              f"back to back: the {what} call differs from its first run")
    return dict(case="back to back: pose, light, pose", calls=3, bit_identical_runs=True)


def normal_eq_kernels(main_run, led_run):
    """The refinement's normal-equation kernels (csrc/normaleq.cu) against
    their plain versions on the card, at the main path's shapes: H within
    NORMAL_EQ_TOL of each keyframe's max|H|, g within NORMAL_EQ_TOL of each
    keyframe's sum of |w r J|, two kernel runs bit for bit, on
    (a) the main run's problem at its final state (SH1, 40 keyframes): the
        pose and the light (B = 4);
    (b) that problem with SH2 lights (_sh2_lights): its residual pass, the
        pose and the light (B = 9);
    (c) the LED run's problem after the upsample: the pose;
    (d) the edges, on the main problem: one keyframe, 33 keyframes, one
        voxel with a counted pair, the main plan's tile of voxels plus one,
        a keyframe with every pair masked, no counted pair (H = g = 0);
        and on the plan's: 8 keyframes at one voxel and at the 8-keyframe
        plan's tile plus one (the LED problem's pose, the main problem's
        first 8 keyframes' light), 33 keyframes from a row slice whose base
        is not 16-byte aligned (the producer's ragged heads), 257
        keyframes (two chunks: one span a voxel row);
    (e) three calls back to back on one stream (pose, light, pose), each
        bit for bit against its first run (a ticket left set shows).
    Timed (median of KERNEL_REPS, L2 flushed): (a) and (c), and (b)'s
    light.  Then each kernel's registers (nvcc -Xptxas -v).  Launches made
    here are on no path.  -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import residual as RS
    from psgradientsdf_tpu_torch.refine import jacobians

    flush = (torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
             if DEVICE == "cuda" else None)
    ref = main_run["pipe"].refiner
    args, skw = ref._args(), ref._static_kwargs()
    prob, _, _, albedo, grad, poses, _, K, lights = args
    rd = RS.residual_pass(*args, **skw)
    pargs = (K, poses, albedo, grad, lights)
    J4 = jacobians.light_jacobian_sh(prob, albedo, grad, 1)
    cases = [_pose_case("main SH1", rd, pargs, "SH1", flush, timed=True),
             _light_case("main SH1", rd, J4, flush, timed=True)]
    sh2 = _sh2_lights(lights, SEED)
    rd2 = RS.residual_pass(*args[:8], sh2, **dict(skw, model="SH2", order=2))
    cases += [_pose_case("main, SH2 lights", rd2, pargs[:4] + (sh2,), "SH2", flush),
              _light_case("main, SH2 lights", rd2,
                          jacobians.light_jacobian_sh(prob, albedo, grad, 2), flush,
                          timed=True)]
    del rd2
    led = led_run["pipe"].refiner
    largs, lkw = led._args(), led._static_kwargs()
    lrd = RS.residual_pass(*largs, **lkw)
    lpargs = (largs[7], largs[5], largs[3], largs[4], largs[8])
    cases.append(_pose_case("LED after the upsample", lrd, lpargs, "LED", flush, timed=True))
    N, F = rd.w.shape[0], rd.w.shape[1]
    rows = torch.nonzero(prob.valid)[:, 0]
    row = int(rows[len(rows) // 2])
    tile = _plan_facts(N, F, 6)["voxels"]
    one_row = torch.zeros((N, F), dtype=torch.bool, device=rd.w.device)
    one_row[row] = rd.mask[row]
    masked = torch.ones((N, F), dtype=torch.bool, device=rd.w.device)
    masked[:, 3] = False
    lo = N // 2
    edges = [
        ("one keyframe", _rd_frames(rd, slice(0, 1)), slice(0, 1), slice(None)),
        (f"{EDGE_ODD_F} keyframes", _rd_frames(rd, slice(0, EDGE_ODD_F)),
         slice(0, EDGE_ODD_F), slice(None)),
        ("one voxel with counted pairs", _rd_weighted(rd, one_row), slice(None),
         slice(None)),
        (f"the main tile of voxels + 1 ({tile + 1})",
         _rd_rows(rd, slice(lo, lo + tile + 1)), slice(None), slice(lo, lo + tile + 1)),
        ("keyframe 3 masked", _rd_weighted(rd, masked), slice(None), slice(None)),
        ("no counted pair", _rd_weighted(rd, torch.zeros_like(masked)), slice(None),
         slice(None))]
    # a row slice of 33 keyframes that starts one voxel in: its w, r and
    # p_cam start 12 bytes past a 16-byte boundary
    odd = type(rd)(*(t[1:] for t in _rd_frames(rd, slice(0, EDGE_ODD_F))))
    check(odd.w.data_ptr() % 16 != 0, "the row slice's base is 16-byte aligned")
    edges.append((f"{EDGE_ODD_F} keyframes from an unaligned row slice", odd,
                  slice(0, EDGE_ODD_F), slice(1, None)))
    # 257 keyframes (the main run's, repeated) on EDGE_CHUNK_ROWS voxels
    many = torch.arange(EDGE_CHUNK_F, device=rd.w.device) % F
    vr = slice(lo, lo + EDGE_CHUNK_ROWS)
    edges.append((f"{EDGE_CHUNK_F} keyframes (two chunks), {EDGE_CHUNK_ROWS} voxels",
                  _rd_frames(_rd_rows(rd, vr), many), many, vr))
    for what, erd, fr, vr in edges:
        eargs = (K, poses[fr].contiguous(), albedo[vr].contiguous(),
                 grad[vr].contiguous(), lights[fr].contiguous())
        cases.append(_pose_case(what, erd, eargs, "SH1", flush))
        cases.append(_light_case(what, erd, J4[vr].contiguous(), flush))
    # 8 keyframes: the LED pose and the main problem's first 8 keyframes'
    # light, at one voxel and at their plans' tile of voxels + 1
    LN, LF = lrd.w.shape[0], lrd.w.shape[1]
    lrows = torch.nonzero(largs[0].valid)[:, 0]
    lrow = int(lrows[len(lrows) // 2])
    ltile = _plan_facts(LN, LF, 6, True)["voxels"]
    llo = max(0, min(LN // 2, LN - ltile - 1))
    for what, vr in ((f"{LF} keyframes, one voxel", slice(lrow, lrow + 1)),
                     (f"{LF} keyframes, the LED tile of voxels + 1 ({ltile + 1})",
                      slice(llo, llo + ltile + 1))):
        cases.append(_pose_case(what, _rd_rows(lrd, vr), (
            lpargs[0], lpargs[1], lpargs[2][vr].contiguous(), lpargs[3][vr].contiguous(),
            lpargs[4]), "LED", flush))
    rd8 = _rd_frames(rd, slice(0, LF))
    tile8 = _plan_facts(N, LF, 4)["voxels"]
    for what, vr in ((f"{LF} keyframes, one voxel", slice(row, row + 1)),
                     (f"{LF} keyframes, the light's tile of voxels + 1 ({tile8 + 1})",
                      slice(lo, lo + tile8 + 1))):
        cases.append(_light_case(what, _rd_rows(rd8, vr), J4[vr].contiguous(), flush))
    del lrd, rd8
    cases.append(_back_to_back(rd, pargs, J4))
    zero = [c for c in cases if c["case"] == "no counted pair"]
    check(all(c["zero_keyframes"] == F for c in zero),
          "no counted pair: a keyframe's H is not 0")
    check(all(c["zero_keyframes"] >= 1 for c in cases
              if c["case"] == "keyframe 3 masked"), "keyframe 3 masked: H is not 0")
    facts = dict(cases=cases, checked=len(cases), tolerance=NORMAL_EQ_TOL)
    if DEVICE == "cuda":
        from psgradientsdf_tpu_torch import kernels

        facts["ptxas"] = _ptxas(kernels.source_path("normaleq"))
        torch.cuda.empty_cache()
    return facts


# the block cores of refine/optimizer.py that _first_iteration_blocks traces


# ------------------------------------------------------- the albedo block


def _albedo_inputs(ref, rho, sh2=False):
    """The refiner's albedo block at its state (SH2 lights in place of its
    own with `sh2`): its residual pass and what ops/albedo.py reads, with
    the regularizer's weight `rho` -> dict."""
    from psgradientsdf_tpu_torch.ops import residual as RS

    args, skw = list(ref._args()), dict(ref._static_kwargs())
    if sh2:
        args[8] = _sh2_lights(args[8], SEED)
        skw.update(model="SH2", order=2)
    prob, _, _, albedo, grad, poses, _, _, lights = args
    rd = RS.residual_pass(*args, **skw)
    return dict(prob=prob, rd=rd, albedo=albedo, grad=grad, lights=lights, poses=poses,
                stencil=ref.stencil, model=skw["model"], order=skw["order"],
                voxel_size=skw["voxel_size"], rho=rho, damping=float(ref.cfg.damping))


def _albedo_rows(c, rows):
    """The rows `rows` (an index) of an albedo block; links to rows outside
    them cut (their neighbours frozen) -> dict."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg

    p = c["prob"]
    inside = torch.full((p.valid.shape[0],), -1, dtype=torch.int64, device=p.valid.device)
    inside[rows] = torch.arange(len(rows), device=p.valid.device)
    relink = lambda idx: torch.where(idx >= 0, inside[idx.clamp(min=0)], -1)[rows]
    prob = p._replace(valid=p.valid[rows], idx_xyz=p.idx_xyz[rows],
                      nbr_idx=relink(p.nbr_idx), lap_idx=relink(p.lap_idx),
                      nbr_dir=p.nbr_dir[rows].contiguous(),
                      nbr_albedo_const=p.nbr_albedo_const[rows].contiguous())
    rd = c["rd"]
    rd = rd._replace(w=rd.w[rows].contiguous(), r=rd.r[rows].contiguous(),
                     p_cam=rd.p_cam[rows].contiguous())
    return dict(c, prob=prob, rd=rd, albedo=c["albedo"][rows].contiguous(),
                grad=c["grad"][rows].contiguous(), stencil=distcg.stencil_reverse(prob))


def _albedo_copies(c, rows):
    """`rows` rows of disjoint copies of an albedo block (the stencils offset
    by the rows before each copy; links into rows past the cut cut) ->
    dict."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg

    p, rd = c["prob"], c["rd"]
    N = p.valid.shape[0]
    k = -(-rows // N)
    cat = lambda t: torch.cat([t] * k)[:rows].contiguous()

    def links(idx):
        off = torch.cat([torch.where(idx >= 0, idx + i * N, -1) for i in range(k)])[:rows]
        return torch.where(off < rows, off, -1)

    prob = p._replace(valid=cat(p.valid), idx_xyz=cat(p.idx_xyz), nbr_idx=links(p.nbr_idx),
                      lap_idx=links(p.lap_idx), nbr_dir=cat(p.nbr_dir),
                      nbr_albedo_const=cat(p.nbr_albedo_const))
    crd = rd._replace(w=cat(rd.w), r=cat(rd.r), p_cam=cat(rd.p_cam))
    return dict(c, prob=prob, rd=crd, albedo=cat(c["albedo"]), grad=cat(c["grad"]),
                stencil=distcg.stencil_reverse(prob))


def _albedo_frames(c, F):
    """The albedo block `c` on its first F keyframes, its keyframes
    repeated in order as far as F needs -> dict."""
    import torch

    rd = c["rd"]
    k = -(-F // rd.w.shape[1])
    cut = lambda t: torch.cat([t] * k, dim=1)[:, :F].contiguous()
    rd = rd._replace(w=cut(rd.w), r=cut(rd.r), p_cam=cut(rd.p_cam))
    frames = lambda t: torch.cat([t] * k)[:F].contiguous()
    lights = c["lights"] if c["model"] == "LED" else frames(c["lights"])
    return dict(c, rd=rd, lights=lights, poses=frames(c["poses"]))


def _albedo_plan_of(N, F, led):
    """albedo_block's plan for N voxels at F keyframes: the card's; in a CPU
    rehearsal the plan for an H100's 132 SMs."""
    from psgradientsdf_tpu_torch.ops import albedo as AL

    return AL._albedo_plan(N, F, led=led, sms=_sm_count() if DEVICE == "cuda" else 132)


def _albedo_case(what, c, static, flush):
    """albedo_block twice (delta, the new albedo, the steps and the system
    it writes out bit for bit), its system against albedo_system_plain bit
    for bit, its CG against albedo_cg_plain on that system: the same steps
    unless the plain r.r lies within ALBEDO_CG_EDGE of the threshold at the
    test where they part, delta within ALBEDO_CG_TOL of max|delta|, the new
    albedo equal to solvers.update_albedo on the kernel's own delta bit for
    bit, the grid barriers it crossed those of its design
    (albedo.grid_barriers).  On the card also its ms, plain_ms, the byte
    bound, the einsum that forms b alone and the barrier floor -> dict."""
    import torch
    from psgradientsdf_tpu_torch.ops import albedo as AL
    from psgradientsdf_tpu_torch.ops import distcg as DC
    from psgradientsdf_tpu_torch.refine import solvers

    prob, rd, st, albedo = c["prob"], c["rd"], c["stencil"], c["albedo"]
    sargs = (prob, rd, albedo, c["grad"], c["lights"], c["poses"], st)
    skw = dict(model=c["model"], order=c["order"], voxel_size=c["voxel_size"],
               reg_weight_rho=c["rho"])
    ckw = dict(damping=c["damping"], cg_iters=100, cg_tol=1e-6, cg_static=static)
    reg = c["rho"] != 0.0
    runs = []
    for _ in range(2):
        steps, system, bars = [], [], []
        d, n = AL.albedo_block(*sargs, **skw, **ckw, steps_out=steps, system_out=system,
                               barriers_out=bars)
        runs.append((d, n, steps[0], system[0], bars[0]))
    plain = AL.albedo_system_plain(*sargs, **skw)
    _sync()
    (d1, n1, k1, sys1, b1), (d2, n2, k2, sys2, b2) = runs
    for name, a, b, p in zip(AL.AlbedoSystem._fields, sys1, sys2, plain):
        if p is None:
            check(a is None, f"albedo_block: {name} formed without the regularizer ({what})")
            continue
        check(_bits_same(a, b), f"albedo_block: two runs differ in the system's {name} ({what})")
        check(_bits_same(a, p), f"albedo_block's system differs from its plain version: "
                                f"{what}, {name}, by up to {_abs_err(a, p)}")
    valid = prob.valid
    kw = dict(reg_weight_rho=c["rho"], **ckw)
    sp, trace = [], []
    dp, npl = AL.albedo_cg_plain(plain, valid, albedo, st, **kw, steps_out=sp, trace=trace)
    _sync()
    k1, kp, barriers = int(k1), int(sp[0]), int(b1)
    check(_bits_same(d1, d2) and _bits_same(n1, n2) and k1 == int(k2) and barriers == int(b2),
          f"albedo_block: two kernel runs differ ({what})")
    check(barriers == AL.grid_barriers(reg, k1),
          f"albedo_block crossed {barriers} grid barriers in {k1} steps ({what})")
    edge = None
    if k1 != kp:
        rr, thr = trace[min(k1, kp)]
        edge = abs(rr - thr) / thr
        check(edge <= ALBEDO_CG_EDGE, f"albedo_block: {k1} steps, the plain solve {kp}, "
                                      f"r.r {rr:.6g} against {thr:.6g} ({what})")
    scale = float(dp.abs().max())
    err = _abs_err(d1, dp)
    check(err <= ALBEDO_CG_TOL * scale, f"albedo_block: delta off the plain solve's by "
                                        f"{err:.3g} of max {scale:.3g} ({what})")
    check(_bits_same(n1, solvers.update_albedo(prob, albedo, d1)),
          f"albedo_block: the new albedo is not update_albedo on its delta ({what})")
    ok_k = n1 != albedo
    ok_p = npl != albedo
    N, F = rd.w.shape[0], rd.w.shape[1]
    led = c["model"] == "LED"
    plan = _albedo_plan_of(N, F, led)
    stages = AL.stage_list(plan, N, F, led=led)
    out = dict(case=what, rows=N, valid_rows=int(valid.sum()), keyframes=F,
               model=c["model"], order=c["order"], rho=c["rho"], static=static,
               steps=k1, plain_steps=kp, grid_barriers=barriers, threshold_edge=edge,
               system_bit_identical=True, runs_bit_identical=True,
               update_albedo_bit_identical=True, max_abs_err=err, max_abs_delta=scale,
               relative_err=err / scale if scale > 0 else 0.0,
               accepted=int(ok_k.sum()), accept_differs_from_plain=int((ok_k != ok_p).sum()),
               plan=dict(plan._asdict(), stages=len(stages["bulk"]),
                         lane_loaded_stages=int((~stages["bulk"]).sum())))
    if DEVICE == "cuda":
        dev = valid.device
        # w and r read once (24 bytes a pair; LED p_cam too, 12), the
        # gradient, the mask and the albedo read and delta and the new
        # albedo written (49 bytes a row), the lights and poses once; under
        # the regularizer nbr, rev, nbr_dir and the frozen albedo read too
        # (84 bytes a row)
        nbytes = (N * F * (36 if led else 24) + N * 49 + c["lights"].numel() * 4
                  + (F * 64 if led else 0) + (N * 84 if reg else 0))
        J = AL.pair_jacobian(rd, c["grad"], c["lights"], c["poses"], model=c["model"],
                             order=c["order"])
        wr = rd.w * rd.r
        einsum_ms = _time_ms(lambda: torch.einsum("nfc,nfc->nc", J, wr), flush)
        del J, wr
        tiles = DC._cg_plan(N, use_lap=False, lap_nbr=False, sms=_sm_count())
        out["albedo_block"] = dict(
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ms=_time_ms(lambda: AL.albedo_block(*sargs, **skw, **ckw), flush),
            plain_ms=_time_ms(lambda: AL.albedo_cg_plain(
                AL.albedo_system_plain(*sargs, **skw), valid, albedo, st, **kw), flush),
            library_ms=None, einsum_b_ms=einsum_ms,
            einsum_b_call="torch.einsum('nfc,nfc->nc', J, w r) over [N, F, 3], J and w r "
                          "formed beforehand: b alone, not the block",
            blocks=plan.blocks, grid_barriers=barriers,
            barrier_floor_ms=_time_ms(lambda: DC.barrier_floor(dev, tiles, barriers), flush))
        out["albedo_block"]["share_of_bound"] = (out["albedo_block"]["bound_ms"]
                                                 / out["albedo_block"]["ms"])
    return out


def _albedo_block_traces(ref):
    """One albedo block from the main run's final state through
    ops/albedo.py (optimizer._albedo_core, the recipe's weights), traced on
    the card -> its device operations (exactly one albedo_block kernel),
    index_add_ kernels and device-to-host copies (none may run), the host's
    CUDA runtime calls (the markers' launches among them) and, among them,
    copies and stream synchronisations (none may run: the block reads
    nothing back), host seconds (median of 3 untraced) and the warm-up
    records the trace lost (_traced)."""
    import torch
    from psgradientsdf_tpu_torch.ops import residual as RS
    from psgradientsdf_tpu_torch.refine import optimizer

    args = ref._args()
    skw = ref._static_kwargs()
    prob, geom, dist, albedo, grad, poses, images, K, lights = args
    rd = RS.residual_pass(*args, **skw)

    def block():
        return optimizer._albedo_core(
            prob, geom, rd, dist, albedo, grad, poses, K, lights, **skw,
            reg_weight_rho=float(ref.cfg.reg_weight_rho), damping=float(ref.cfg.damping),
            stencil=ref.stencil)

    block()
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    # The block runs between two fills, the markers, which are taken out of
    # the counts: the trace must hold both, so a session that lost device
    # activity fails here instead of passing with too few operations.
    mark = torch.empty(1, device=dist.device)
    with _traced() as prof:
        mark.fill_(1.0)
        block()
        mark.fill_(2.0)
    rows = sorted(_kernel_rows(prof), reverse=True)
    marks = int(sum(r[1] for r in rows if "FillFunctor" in r[2]))
    host = [(e.count, e.key) for e in prof.key_averages()
            if not str(e.device_type).endswith("CUDA")]
    check(marks == 2, f"the albedo block's trace holds {marks} marker fills: device "
                      f"{[(n, k[:60]) for _, n, k in rows]}, host {host}")
    reads = sum(n for n, k in host if "Memcpy" in k or k == "cudaStreamSynchronize")
    out = dict(
        seconds=statistics.median(secs), warmup_dropped=prof.warmup_dropped,
        device_ops=int(sum(r[1] for r in rows)) - marks,
        albedo_block_kernels=int(sum(r[1] for r in rows if "albedo_block_kernel" in r[2])),
        index_add_kernels=int(sum(r[1] for r in rows if _is_index_add(r[2]))),
        device_to_host_copies=int(sum(r[1] for r in rows if "DtoH" in r[2]
                                      or "Device -> Pageable" in r[2])),
        host_reads=int(reads),
        runtime_calls=_runtime_calls(prof),
        runtime=[dict(name=k[:60], calls=n) for n, k in host],
        device_ms=sum(r[0] for r in rows if "FillFunctor" not in r[2]) * 1e-3,
        ops=[dict(name=k[:80], launches=n, device_ms=us * 1e-3) for us, n, k in rows
             if "FillFunctor" not in k])
    check(out["albedo_block_kernels"] == 1 and out["device_ops"] == 1,
          f"a traced albedo block ran {out['device_ops']} device operations: {out['ops']}")
    check(out["index_add_kernels"] == 0 and out["device_to_host_copies"] == 0
          and out["host_reads"] == 0,
          f"the albedo block ran {out['index_add_kernels']} index_add_ kernels, "
          f"{out['device_to_host_copies']} device-to-host copies, {out['host_reads']} reads")
    return out


def albedo_kernels(main_run, led_run):
    """The albedo block's kernel (csrc/albedo.cu) against the plain versions
    on the card, at the main path's shapes (_albedo_case): the main run's
    final albedo block at its loop's weights (SH1, the recipe's reg albedo
    0) under scipy's stop rule and cg_static's (the one-step diagonal solve
    must cross 2 grid barriers); that block with SH2 lights; the LED run's
    block after the upsample; the main block with the regularizer
    (reg_weight_rho ALBEDO_REG) under both rules; one row alone; a row cut
    from its neighbours (under the regularizer); no valid row (both rules);
    four copies of the main system (with and without the regularizer); its
    first keyframe alone (F = 1); its first 33 keyframes on a row count of
    1 modulo 4 (the last stage partial, its spans not of 16-byte sizes: the
    lanes load it); 40 keyframes on a row count of 2 modulo 4; its
    keyframes repeated to ALBEDO_UNSTAGED_F (no ring fits: the pairs read
    from device memory); the first row count past the shared-memory tile
    (the vectors in device memory).
    Every case timed (median of KERNEL_REPS, L2 flushed); the one row's
    block is its latency floor.  Then the kernel's registers (nvcc -Xptxas
    -v) and one albedo block traced through it (_albedo_block_traces).
    Launches made here are on no path.  -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import albedo as AL
    from psgradientsdf_tpu_torch.ops import distcg

    flush = (torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
             if DEVICE == "cuda" else None)
    ref, led = main_run["pipe"].refiner, led_run["pipe"].refiner
    rho = float(ref.cfg.reg_weight_rho)
    main = _albedo_inputs(ref, rho)
    cases = [_albedo_case("main SH1", main, False, flush),
             _albedo_case("main SH1", main, True, flush)]
    for case in cases:
        check(case["steps"] != 1 or case["grid_barriers"] == 2,
              f"the one-step diagonal solve crossed {case['grid_barriers']} grid barriers")
    cases.append(_albedo_case("main, SH2 lights", _albedo_inputs(ref, rho, sh2=True),
                              False, flush))
    cases.append(_albedo_case("LED after the upsample",
                              _albedo_inputs(led, float(led.cfg.reg_weight_rho)), False,
                              flush))
    reg = dict(main, rho=ALBEDO_REG)
    for static in (False, True):
        cases.append(_albedo_case(f"main, reg albedo {ALBEDO_REG}", reg, static, flush))
    p = main["prob"]
    dev = p.valid.device
    valid_rows = torch.nonzero(p.valid)[:, 0]
    row = int(valid_rows[len(valid_rows) // 2])
    one = _albedo_case("one row", _albedo_rows(main, torch.tensor([row], device=dev)),
                       False, flush)
    check(one["steps"] == 1, f"one row: {one['steps']} steps")
    cases.append(one)
    nbr = p.nbr_idx.clone()
    nbr[row] = -1
    cut = p._replace(nbr_idx=nbr)
    cases.append(_albedo_case("a row cut from its neighbours",
                              dict(reg, prob=cut, stencil=distcg.stencil_reverse(cut)),
                              False, flush))
    none = p._replace(valid=torch.zeros_like(p.valid))
    for static in (False, True):
        case = _albedo_case("no valid row", dict(main, prob=none), static, flush)
        check(case["steps"] == 0 and case["max_abs_delta"] == 0.0 and case["accepted"] == 0,
              "no valid row: a step, a nonzero delta or a moved albedo")
        cases.append(case)
    N = p.valid.shape[0]
    four = _albedo_copies(main, 4 * N)
    cases.append(_albedo_case("four copies of the main system", four, False, flush))
    cases.append(_albedo_case(f"four copies, reg albedo {ALBEDO_REG}",
                              dict(four, rho=ALBEDO_REG), False, flush))
    del four
    cases.append(_albedo_case("one keyframe", _albedo_frames(main, 1), False, flush))
    odd = N // 4 * 4 - 3
    odd_f = min(33, main["rd"].w.shape[1])
    case = _albedo_case(f"{odd_f} keyframes, a partial last stage",
                        _albedo_frames(_albedo_rows(main, torch.arange(odd, device=dev)), odd_f),
                        False, flush)
    check(case["plan"]["lane_loaded_stages"] >= 1,
          f"{odd_f} keyframes: no stage was left to the lanes' loads")
    cases.append(case)
    case = _albedo_case("a partial last stage",
                        _albedo_rows(main, torch.arange(N // 4 * 4 - 2, device=dev)),
                        False, flush)
    check(case["plan"]["lane_loaded_stages"] >= 1, "no partial stage was left to the lanes")
    cases.append(case)
    case = _albedo_case(f"{ALBEDO_UNSTAGED_F} keyframes, the pairs read unstaged",
                        _albedo_frames(main, ALBEDO_UNSTAGED_F), False, flush)
    check(case["plan"]["depth"] == 0, f"{ALBEDO_UNSTAGED_F} keyframes: a ring was planned")
    cases.append(case)
    F = main["rd"].w.shape[1]
    sms = _sm_count() if DEVICE == "cuda" else 132
    past = sms * AL.shared_tile_limit(F, led=False) + 1
    case = _albedo_case("the first row count past the shared tile",
                        _albedo_copies(main, past), False, flush)
    check(not case["plan"]["shared"], f"{past} rows: the vectors stayed in shared memory")
    cases.append(case)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    check(any(c["plan"]["shared"] for c in cases), "no case kept its vectors in shared memory")
    check(all(c["plan"]["depth"] > 0 for c in cases if "unstaged" not in c["case"]),
          "a case read its pairs unstaged")
    check(all(c["steps"] > 3 for c in cases if c["rho"] and c["valid_rows"] > 1),
          "a regularized solve ended within three steps")
    facts = dict(cases=cases, checked=len(cases), tolerance=ALBEDO_CG_TOL)
    if DEVICE == "cuda":
        from psgradientsdf_tpu_torch import kernels

        facts["ptxas"] = _ptxas(kernels.source_path("albedo"))
        facts["latency_floor_ms"] = one["albedo_block"]["ms"]
        facts["albedo_block"] = _albedo_block_traces(ref)
        torch.cuda.empty_cache()
    return facts


# ------------------------------------- the scan's preprocessing, the energies


PREPROCESS_WINDOWS = (3, 5, 11, 31)
# preprocess_kernels: LAPM's mean against the plain torch.mean, relative;
# energy_kernels: each sum against the plain chain's, relative
LAPM_TOL = 1e-6
ENERGY_TOL = 1e-5


def _prep_frames(seq, frames, scale=1):
    """Frames of `seq` on the device as the scan's chunk holds them (metric
    depth [C,H,W], float colour [C,H,W,3]); `scale` repeats each pixel
    scale x scale times (a frame of scale^2 the pixels)."""
    from psgradientsdf_tpu_torch.tracking.stream import _to_metric, upload_frames

    K, colors, depths = seq[:3]
    d = np.stack([depths[f] for f in frames])
    c = np.stack([colors[f] for f in frames])
    if scale > 1:
        d = d.repeat(scale, 1).repeat(scale, 2)
        c = c.repeat(scale, 1).repeat(scale, 2)
    return _to_metric(upload_frames(d, DEVICE), upload_frames(c, DEVICE), DEPTH_UNIT)


def _prep_case(what, depth, color, cache, window, flush):
    """fals_normals and lapm (csrc/preprocess.cu) against their plain
    versions on one chunk: the normals bit for bit, LAPM within LAPM_TOL,
    each kernel twice bit for bit; with `flush` their times in the path's
    order (_path_ms: the normals, then LAPM), each after the flush, the
    plain versions', and their byte bounds -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import preprocess as P

    n = P.fals_normals(depth, cache, window)
    n2 = P.fals_normals(depth, cache, window)
    n_plain = P.fals_normals_plain(depth, cache, window)
    _sync()
    differing = int((n.view(torch.int32) != n_plain.view(torch.int32)).sum())
    out = dict(case=what, frames=int(depth.shape[0]) if depth.dim() == 3 else 1,
               height=int(depth.shape[-2]), width=int(depth.shape[-1]), window=window,
               zero_depths=int((depth == 0).sum()), normals_differing=differing,
               normals_max_abs_err=_abs_err(n, n_plain))
    check(_bits_equal(n, n2), f"{what}: two fals_normals launches differ")
    check(differing == 0, f"{what}: fals_normals differs from its plain version on "
                          f"{differing} values (max {out['normals_max_abs_err']:.3g})")
    if color is not None:
        s, s2, s_plain = P.lapm(color), P.lapm(color), P.lapm_plain(color)
        rel = float(((s - s_plain).abs() / s_plain.abs().clamp(min=1e-30)).max())
        out.update(lapm=[float(v) for v in s.reshape(-1)], lapm_rel_err=rel,
                   lapm_max_abs_err=_abs_err(s, s_plain))
        check(_bits_equal(s, s2), f"{what}: two lapm launches differ")
        check(rel <= LAPM_TOL, f"{what}: lapm {rel:.3g} from its plain version")
    if flush is not None and color is not None:
        C, Hh, Ww = out["frames"], out["height"], out["width"]
        path = _path_ms([lambda: P.fals_normals(depth, cache, window),
                         lambda: P.lapm(color)])
        out["fals_normals"] = dict(
            ms=path[0], ms_after_flush=_time_ms(lambda: P.fals_normals(depth, cache, window), flush),
            plain_ms=_time_ms(lambda: P.fals_normals_plain(depth, cache, window), flush),
            # the depth and the cache (x0n, y0n, nsi, Q) read once, the
            # normals written once
            bound_ms=(C * Hh * Ww * (4 + 12) + Hh * Ww * 36) / HBM_BYTES_PER_S * 1e3,
            max_abs_err=out["normals_max_abs_err"], library_ms=None)
        out["lapm"] = dict(
            ms=path[1], ms_after_flush=_time_ms(lambda: P.lapm(color), flush),
            # an empty kernel on lapm's grid, block and shared memory, in its
            # place in the path
            empty_launch_ms=_path_ms([lambda: P.fals_normals(depth, cache, window),
                                      lambda: P.lapm_floor(color)])[1],
            plain_ms=_time_ms(lambda: P.lapm_plain(color), flush),
            # the RGB frames read once (the blue channel's lines hold all
            # three), the means written once
            bound_ms=(C * Hh * Ww * 12 + C * 4) / HBM_BYTES_PER_S * 1e3,
            rel_err=out["lapm_rel_err"], max_abs_err=out["lapm_max_abs_err"],
            library_ms=None, values=out.pop("lapm"))
        for k in ("fals_normals", "lapm"):
            out[k]["share_of_bound"] = out[k]["bound_ms"] / out[k]["ms"]
    return out


def _lapm_views(what, color):
    """lapm on copies of `color` whose bases lie 4, 8 and 12 bytes past a
    16-byte boundary (the kernel's producer then loads each row span's
    ragged head and tail itself), each bit for bit against lapm on an
    aligned copy, which holds LAPM_TOL of the plain means -> facts."""
    from psgradientsdf_tpu_torch.ops import preprocess as P

    aligned = color.clone()
    check(aligned.data_ptr() % 16 == 0, f"{what}: the copy is not 16-byte aligned")
    want, plain = P.lapm(aligned), P.lapm_plain(aligned)
    rel = float(((want - plain).abs() / plain.abs().clamp(min=1e-30)).max())
    check(rel <= LAPM_TOL, f"{what}: lapm {rel:.3g} from its plain version")
    offsets = []
    for off in (1, 2, 3):
        check(_bits_equal(P.lapm(_off_boundary(color, off)), want),
              f"{what}: lapm on a copy {4 * off} bytes off a 16-byte boundary differs "
              f"from an aligned one")
        offsets.append(4 * off)
    return dict(case=what, shape=list(color.shape), rel_err=rel, view_offsets=offsets,
                bits_as_aligned=True)


def _prep_shaped(seq, frames, h, w, y0=0, x0=0):
    """Depth and colour of `frames` cut to h x w from (y0, x0), or where h
    or w exceeds the frame, edge-padded past its bottom and right, with K's
    principal point moved with the cut -> (depth, colour, K)."""
    import torch.nn.functional as TF

    d, c = _prep_frames(seq, frames)
    ph, pw = max(0, y0 + h - H), max(0, x0 + w - W)
    if ph or pw:
        d = TF.pad(d[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
        c = TF.pad(c.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    K = np.asarray(seq[0], np.float64).copy()
    K[0, 2] -= x0
    K[1, 2] -= y0
    return (d[:, y0:y0 + h, x0:x0 + w].contiguous(),
            c[:, y0:y0 + h, x0:x0 + w].contiguous(), K)


def _fals_edges(seq, caches):
    """The normals' persistent grid at its edges (_prep_case): frame counts
    that do not fill a block's walk (1, 3, 9 frames of 640x480), images
    whose sides are not multiples of the 32 x 32 tile (17x45: one partial
    tile; 481x641: a partial row and column of tiles) and every odd window
    1 .. MAX_WINDOW on the latter's edge tiles (at window 1 the 3x3 solve is
    singular and every normal NaN: the NaNs' bits are held too) -> [facts]."""
    from psgradientsdf_tpu_torch.ops import preprocess as P
    from psgradientsdf_tpu_torch.ops.normals import build_fals_cache

    out = []
    for C in (1, 3, 9):
        d, c = _prep_frames(seq, range(C))
        out.append(_prep_case(f"{C} frames", d, c, caches[11], 11, None))
    for (h, w), windows, at in (((17, 45), (1, 11, 31), (200, 300)),
                                ((H + 1, W + 1), range(1, P.MAX_WINDOW + 1, 2), (0, 0))):
        d, c, K = _prep_shaped(seq, range(2), h, w, *at)
        for win in windows:
            cache = build_fals_cache(h, w, K, window=win, device=DEVICE)
            out.append(_prep_case(f"{w}x{h} window {win}", d, c if win == 11 else None,
                                  cache, win, None))
    return out


def _fals_launch(lib, depth, cache, window, per_sm):
    """One launch of fals_normals from library `lib` (this build, or an
    earlier one whose FalsArgs is a prefix of this one's) on this call's
    grid -> the normals (not counted)."""
    import torch
    from psgradientsdf_tpu_torch.ops import preprocess as P

    C, Hh, Ww = depth.shape
    out = torch.empty(tuple(depth.shape) + (3,), dtype=torch.float32, device=depth.device)
    a = P._FalsArgs(depth=depth.data_ptr(), x0n=cache.x0_n_sq_inv.data_ptr(),
                    y0n=cache.y0_n_sq_inv.data_ptr(), nsi=cache.n_sq_inv.data_ptr(),
                    Q=cache.Q.data_ptr(), out=out.data_ptr(), C=C, H=Hh, W=Ww, window=window,
                    blocks=P.fals_grid(C, Hh, Ww, _sm_count() * per_sm)[3])
    rc = lib.fals_normals(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"fals_normals ({lib}): CUDA error {rc}")
    return out


def _parent_lapm_plan(C, Hh, sms):
    """(bands, rows a band) of the first LAPM design (a412c9f's
    lapm_plan): about two blocks of 256 threads an SM over the frames."""
    want = max(1, min(Hh, -(-2 * sms // C)))
    rows = -(-Hh // want)
    return -(-Hh // rows), rows


def _lapm_launch(lib, color, parent):
    """One launch of lapm from library `lib` on an RGB or grey chunk: with
    `parent`, an earlier build whose LapmArgs is a prefix of this one's
    (the first design's: bands x frames blocks of 256 threads), on its own
    plan; else this build on lapm_plan -> the means (not counted)."""
    import torch
    from psgradientsdf_tpu_torch.ops import preprocess as P

    C, Hh, Ww, S, chan, lead = P._lapm_shape(color)
    plan = P.lapm_plan(C, Hh, Ww, S, _sm_count())
    if parent:
        plan = plan._replace(**dict(zip(("bands", "rows"), _parent_lapm_plan(C, Hh,
                                                                           _sm_count()))),
                             strips=1)
    x = color.contiguous()
    out = torch.empty(C, dtype=torch.float32, device=x.device)
    part = torch.empty(C * plan.bands * plan.strips, dtype=torch.float64, device=x.device)
    a = P._lapm_args(C, Hh, Ww, S, chan, plan)
    a.img, a.out, a.part, a.ticket = (x.data_ptr(), out.data_ptr(), part.data_ptr(),
                                      P._ticket(x.device).data_ptr())
    rc = lib.lapm(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"lapm ({lib}): CUDA error {rc}")
    return out.reshape(lead)


def _fals_parent_ab(depth, color, cache, flush):
    """fals_normals and lapm on this preprocess.cu and on the --fals-parent
    source (built here into a temporary directory; its launches on no path
    and not counted), the parent's normals bit for bit with this kernel's
    and its LAPM within LAPM_TOL of the plain means, timed in turns in the
    path's order (_path_ms: the normals, then LAPM), each build's pair:
    this, the parent, the parent, this -> {"this"|"parent": [ms, ms]} of the
    normals, {"lapm_this"|"lapm_parent": [ms, ms]} of LAPM."""
    import torch
    from psgradientsdf_tpu_torch.ops import preprocess as P

    src = sys.argv[sys.argv.index("--fals-parent") + 1]
    with tempfile.TemporaryDirectory(prefix="fals_parent_") as tmp:
        parent = _parent_build(src, tmp, "preprocess_parent")
        parent.fals_normals.argtypes = [ctypes.POINTER(P._FalsArgs), ctypes.c_void_p]
        parent.lapm.argtypes = [ctypes.POINTER(P._LapmArgs), ctypes.c_void_p]
        runs = dict(this=lambda: P.fals_normals(depth, cache, 11),
                    parent=lambda: _fals_launch(parent, depth, cache, 11, 1))
        lapms = dict(this=lambda: P.lapm(color),
                     parent=lambda: _lapm_launch(parent, color, True))
        check(_bits_equal(runs["parent"](), runs["this"]()),
              "the parent's fals_normals differs from this one's")
        plain = P.lapm_plain(color)
        rel = float(((lapms["parent"]() - plain).abs() / plain.abs()).max())
        check(rel <= LAPM_TOL, f"the parent's lapm {rel:.3g} from its plain version")
        times = {"this": [], "parent": [], "lapm_this": [], "lapm_parent": []}
        for name in ("this", "parent", "parent", "this"):
            path = _path_ms([runs[name], lapms[name]])
            times[name].append(path[0])
            times["lapm_" + name].append(path[1])
        torch.cuda.synchronize()
    return dict(times, width=int(color.shape[-2]), parent_lapm_rel_err=rel)


def preprocess_kernels(seq):
    """The scan's preprocessing kernels (csrc/preprocess.cu) against their
    plain versions on the card (_prep_case): every chunk of the smoke's
    sequence as the scan holds it (window 11, the pipeline's cache; the
    first one timed), one frame, a chunk of 1280x960 frames, an all-zero
    depth chunk, a sparse depth chunk (nine pixels in ten zero, no NaN),
    each other window the normals take, a grey chunk's LAPM and the normals'
    edges (_fals_edges); with --fals-parent the normals in turns with an
    earlier build.  Launches made here are on no path.  -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import preprocess as P
    from psgradientsdf_tpu_torch.ops.normals import build_fals_cache

    K = seq[0]
    flush = (torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
             if DEVICE == "cuda" else None)
    caches = {w: build_fals_cache(H, W, K, window=w, device=DEVICE)
              for w in PREPROCESS_WINDOWS}
    cases = []
    for c0 in range(0, FRAMES, CHUNK):
        d, c = _prep_frames(seq, range(c0, min(c0 + CHUNK, FRAMES)))
        cases.append(_prep_case(f"chunk {c0 // CHUNK}", d, c, caches[11],
                                11, flush if c0 == 0 else None))
    d, c = _prep_frames(seq, range(CHUNK))
    cases.append(_prep_case("one frame", d[3], c[3], caches[11], 11, None))
    for w in PREPROCESS_WINDOWS:
        if w != 11:
            cases.append(_prep_case(f"window {w}", d, c, caches[w], w, None))
    cases.append(_prep_case("all-zero depth", torch.zeros_like(d), c, caches[11], 11, None))
    keep = torch.from_numpy(np.random.default_rng(SEED).random(tuple(d.shape)) < 0.1)
    sparse = torch.where(keep.to(d.device), d, torch.zeros_like(d))
    cases.append(_prep_case("sparse depth", sparse, c, caches[11], 11, None))
    cases.append(_prep_case("grey", d, c[..., 2].contiguous(), caches[11], 11, None))
    K2 = np.asarray(K, np.float64).copy()
    K2[:2] *= 2.0
    K2[:2, 2] += 0.5                       # a pixel's centre in the doubled grid
    big = build_fals_cache(2 * H, 2 * W, K2, window=11, device=DEVICE)
    d2, c2 = _prep_frames(seq, range(CHUNK), scale=2)
    cases.append(_prep_case(f"{2 * W}x{2 * H}", d2, c2, big, 11, None))
    check(cases[-1]["normals_differing"] == 0 and cases[-1]["width"] == 2 * W,
          "the 1280x960 chunk was not held")
    cases += _fals_edges(seq, caches)
    d9, c9 = _prep_frames(seq, range(9))
    views = [_lapm_views("RGB chunk 0", c), _lapm_views("grey", c[..., 2].contiguous()),
             _lapm_views("one frame", c[3]), _lapm_views("nine frames", c9),
             _lapm_views(f"{2 * W}x{2 * H}", c2)]
    facts = {}
    sms = _sm_count() if DEVICE == "cuda" else 132
    per_sm = P.fals_blocks_per_sm(torch.device(DEVICE), 11) if DEVICE == "cuda" else 1
    if DEVICE == "cuda":
        facts["registers"] = _ptxas(os.path.join("psgradientsdf_tpu_torch", "csrc",
                                                 "preprocess.cu"))
        if "--fals-parent" in sys.argv[1:]:
            d, c = _prep_frames(seq, range(CHUNK))
            facts["parent"] = _fals_parent_ab(d, c, caches[11], flush)
            facts["parent_1280x960"] = _fals_parent_ab(d2, c2, big, None)
        torch.cuda.empty_cache()
    return dict(cases=cases, checked=len(cases) + len(views), lapm_views=views,
                lapm_tolerance=LAPM_TOL,
                grid=dict(tile=P.TILE, blocks_per_sm=per_sm,
                          plan=list(P.fals_grid(CHUNK, H, W, sms * per_sm)),
                          shared_bytes=P.fals_smem(11),
                          shared_bytes_window_31=P.fals_smem(P.MAX_WINDOW)),
                lapm_plan=list(P.lapm_plan(CHUNK, H, W, 3, sms)),
                timed=cases[0], **facts)


def _energy_inputs(ref, what):
    """The refiner's final state: its problem, a residual pass there, dist,
    albedo, the loop's loss keywords and the surface count."""
    return dict(what=what, prob=ref.prob, rd=ref._rd(), dist=ref.dist,
                albedo=ref.albedo, kw=ref._energy_kwargs(), n=ref.prob.n_surface,
                ref=ref)


def _energy_rows(c, rows, what):
    """c on the rows `rows` alone, every stencil neighbour's value frozen
    in as a constant (parallel/refine.py's block view)."""
    import torch
    from psgradientsdf_tpu_torch.parallel.refine import _view

    view = _view(c["prob"], c["dist"], c["albedo"])
    idx = torch.as_tensor(list(rows), dtype=torch.long, device=c["dist"].device)
    prob = view._replace(**{f: getattr(view, f)[idx] for f in view._fields
                            if f != "n_surface"}, n_surface=len(rows))
    rd = type(c["rd"])(*(t[idx] for t in c["rd"]))
    return dict(c, what=what, prob=prob, rd=rd, dist=c["dist"][idx],
                albedo=c["albedo"][idx], n=len(rows))


def _energy_case(c, loss, flush=None, terms=None):
    """energy_sums (csrc/energy.cu) against its plain version on c under
    `loss`: each sum and energy within ENERGY_TOL (exactly 0 where the
    plain one is), two launches bit for bit; with `flush` its time in the
    path's order (_path_ms: the residual pass, then the energies), after
    the flush, the plain version's, and its byte bound -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import energy as E
    from psgradientsdf_tpu_torch.ops import residual
    from psgradientsdf_tpu_torch.utils import robust

    terms = E.ALL_TERMS if terms is None else terms
    kw = dict(c["kw"], loss=robust.loss_from_name(loss), terms=terms)
    args = (c["prob"], c["rd"], c["dist"], c["albedo"])
    sums, en = E.energy_sums(*args, **kw, n_surface=c["n"])
    sums2, en2 = E.energy_sums(*args, **kw, n_surface=c["n"])
    plain = E.energy_sums_plain(*args, **kw)
    plain_en = plain / max(float(c["n"]), 1.0)
    _sync()
    rel = [abs(a - b) / abs(b) if b != 0 else (0.0 if a == 0 else float("inf"))
           for a, b in zip(torch.cat([sums, en]).tolist(),
                           torch.cat([plain, plain_en]).tolist())]
    prob, rd = c["prob"], c["rd"]
    N, F = int(rd.mask.shape[0]), int(rd.mask.shape[1])
    masked, valid = int(rd.mask.sum()), int(prob.valid.sum())
    what = f"{c['what']} {loss}" + ("" if terms == E.ALL_TERMS else f" terms {terms}")
    out = dict(case=what, rows=N, keyframes=F, valid_rows=valid, counted_pairs=masked,
               sums=[float(v) for v in sums.cpu()], energies=[float(v) for v in en.cpu()],
               max_rel_err=max(rel), bits_again=_bits_equal(torch.cat([sums, en]),
                                                            torch.cat([sums2, en2])))
    check(out["bits_again"], f"{what}: two energy_sums launches differ")
    check(max(rel) <= ENERGY_TOL, f"{what}: energy_sums {rel} from its plain version")
    if flush is not None:
        ref = c["ref"]
        run = lambda: E.energy_sums(*args, **kw, n_surface=c["n"])
        path = _path_ms([lambda: residual.residual_pass(*ref._args(), **ref._static_kwargs()),
                         run])
        # the mask read for every pair, r for the counted ones; valid for
        # every row, a valid row's state and stencil once (dist 4, albedo
        # 12, direction 12, indices 24 + 48, constants 12 + 36 + 24 bytes);
        # the sums and energies written
        bound = (N * F + 12 * masked + N + 172 * valid + 32) / HBM_BYTES_PER_S * 1e3
        out["energy_sums"] = dict(
            ms=path[1], residual_pass_ms=path[0], ms_after_flush=_time_ms(run, flush),
            plain_ms=_time_ms(lambda: E.energy_sums_plain(*args, **kw), flush),
            bound_ms=bound, max_abs_err=max(abs(float(a) - float(b)) for a, b in
                                            zip(sums.cpu(), plain.cpu())),
            library_ms=None)
        out["energy_sums"]["share_of_bound"] = bound / path[1]
        out["blocks"] = E.energy_blocks(N, F, _sm_count())
    return out


def _energy_frames(c, frames, rows, what):
    """c on its first `rows` rows (_energy_rows) and keyframes `frames`."""
    out = _energy_rows(c, range(rows), what)
    return dict(out, rd=_rd_frames(out["rd"], frames))


def _energy_sliced(c, what):
    """c's rows 1: as views of its tensors: r and the mask start one row in,
    off the vector loads' boundaries where F is odd."""
    prob = c["prob"]._replace(**{f: getattr(c["prob"], f)[1:] for f in c["prob"]._fields
                                 if f != "n_surface"}, n_surface=c["n"] - 1)
    return dict(c, what=what, prob=prob, rd=type(c["rd"])(*(t[1:] for t in c["rd"])),
                dist=c["dist"][1:], albedo=c["albedo"][1:], n=c["n"] - 1)


def _energy_edges(main, loss):
    """The persistent grid's edges (_energy_case): 33 keyframes of 1001 rows
    (33033 pairs: a partial last group of four, read by scalar loads); its
    rows 1: as views (r and the mask off their 16- and 4-byte boundaries:
    every group read by scalar loads) with every term, the PS sum alone and
    the rows alone, each bit for bit with the same call on an aligned copy
    (the order does not depend on the alignment); 25 rows of 40 keyframes
    (one block's worth of pairs) -> [facts]."""
    import torch
    from psgradientsdf_tpu_torch.ops import energy as E
    from psgradientsdf_tpu_torch.utils import robust

    odd = _energy_frames(main, slice(0, 33), 1001, "33 keyframes of 1001 rows")
    check(odd["rd"].mask.numel() % E.GROUP != 0, "the odd case fills its last group")
    out = [_energy_case(odd, loss)]
    sliced = _energy_sliced(odd, "its rows 1: as views")
    check(sliced["rd"].r.data_ptr() % 16 != 0 and sliced["rd"].mask.data_ptr() % 4 != 0,
          "the sliced case is aligned")
    copy = dict(sliced, prob=sliced["prob"]._replace(**{
        f: getattr(sliced["prob"], f).clone() for f in sliced["prob"]._fields
        if f != "n_surface"}), rd=type(sliced["rd"])(*(t.clone() for t in sliced["rd"])))
    for terms in (E.ALL_TERMS, E.PS, E.REGULARIZERS):
        case = _energy_case(sliced, loss, terms=terms)
        kw = dict(sliced["kw"], loss=robust.loss_from_name(loss), terms=terms)
        got = E.energy_sums(sliced["prob"], sliced["rd"], sliced["dist"], sliced["albedo"], **kw)
        want = E.energy_sums(copy["prob"], copy["rd"], copy["dist"], copy["albedo"], **kw)
        case["bits_as_aligned_copy"] = _bits_equal(got, want)
        check(case["bits_as_aligned_copy"],
              f"{case['case']}: the sums differ from an aligned copy's")
        out.append(case)
    rows = [int(i) for i in torch.nonzero(main["prob"].valid)[:25, 0]]
    one = _energy_rows(main, rows, "25 rows")
    check(E.energy_blocks(25, int(one["rd"].mask.shape[1]), _sm_count()
                          if DEVICE == "cuda" else 132) == 1, "25 rows take more than a block")
    out.append(_energy_case(one, loss))
    return out


def _energy_launch(lib, c, loss, terms, blocks):
    """One launch of energy_sums_kernel from library `lib` (this build, or an
    earlier one with the same EnergyArgs) on c at `blocks` blocks -> the
    sums and energies [8] (not counted)."""
    import torch
    from psgradientsdf_tpu_torch.ops import energy as E
    from psgradientsdf_tpu_torch.utils import robust

    dev = c["rd"].r.device
    N, F, ins = E._inputs(c["prob"], c["rd"], c["dist"], c["albedo"], terms, dev)
    out = torch.empty(8, dtype=torch.float32, device=dev)
    part = torch.empty(4 * blocks, dtype=torch.float64, device=dev)
    a = E._EnergyArgs(**{k: t.data_ptr() for k, t in ins.items()})
    a.part, a.ticket, a.out = part.data_ptr(), E._ticket(dev).data_ptr(), out.data_ptr()
    a.N, a.F, a.terms = N, F, terms
    a.loss = E.LOSS_KINDS.index(robust.loss_from_name(loss))
    a.has_count, a.blocks = 1, blocks
    a.lam, a.voxel = float(c["kw"]["lam"]), float(c["kw"]["voxel_size"])
    a.count = max(float(c["n"]), 1.0)
    rc = lib.energy_sums(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"energy_sums ({lib}): CUDA error {rc}")
    return out


def _parent_energy_blocks(N, F, sms):
    """The grid of the energy kernel's first design (csrc/energy.cu before
    the persistent grid): a thread a pair or a row, at most four blocks of
    256 an SM."""
    return max(1, min(4 * sms, -(-max(N * F, N, 1) // 256)))


def _energy_cuts(lib, c, loss, blocks):
    """energy_sums_kernel from `lib` timed in the path's order (_path_ms:
    the residual pass, then the energies) with every term, the PS sum alone,
    the rows alone, and every term at 132 blocks and at one: which part
    sets a launch's time -> {cut: ms}."""
    from psgradientsdf_tpu_torch.ops import energy as E
    from psgradientsdf_tpu_torch.ops import residual

    ref = c["ref"]
    first = lambda: residual.residual_pass(*ref._args(), **ref._static_kwargs())
    cuts = {"all terms": (E.ALL_TERMS, blocks), "PS alone": (E.PS, blocks),
            "rows alone": (E.REGULARIZERS, blocks), "132 blocks": (E.ALL_TERMS, 132),
            "1 block": (E.ALL_TERMS, 1)}
    return {k: _path_ms([first, lambda t=t, b=b: _energy_launch(lib, c, loss, t, b)])[1]
            for k, (t, b) in cuts.items()}


def _energy_parent_ab(c, loss):
    """energy_sums on this energy.cu and on the --energy-parent source
    (built here into a temporary directory; its launches on no path and not
    counted), the parent held to the plain sums within ENERGY_TOL, timed
    in turns in the path's order (this, the parent, the parent, this) and
    with the cuts of _energy_cuts -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import energy as E
    from psgradientsdf_tpu_torch.ops import residual
    from psgradientsdf_tpu_torch.utils import robust

    src = sys.argv[sys.argv.index("--energy-parent") + 1]
    N, F = (int(s) for s in c["rd"].mask.shape)
    pblocks = _parent_energy_blocks(N, F, _sm_count())
    with tempfile.TemporaryDirectory(prefix="energy_parent_") as tmp:
        parent = _parent_build(src, tmp, "energy_parent")
        parent.energy_sums.argtypes = [ctypes.POINTER(E._EnergyArgs), ctypes.c_void_p]
        got = _energy_launch(parent, c, loss, E.ALL_TERMS, pblocks)[:4]
        plain = E.energy_sums_plain(c["prob"], c["rd"], c["dist"], c["albedo"],
                                    **dict(c["kw"], loss=robust.loss_from_name(loss)))
        rel = float(((got - plain).abs() / plain.abs().clamp(min=1e-30)).max())
        check(rel <= ENERGY_TOL, f"the parent's energy_sums is {rel:.3g} from the plain sums")
        ref = c["ref"]
        first = lambda: residual.residual_pass(*ref._args(), **ref._static_kwargs())
        kw = dict(c["kw"], loss=robust.loss_from_name(loss), n_surface=c["n"])
        runs = dict(this=lambda: E.energy_sums(c["prob"], c["rd"], c["dist"], c["albedo"], **kw),
                    parent=lambda: _energy_launch(parent, c, loss, E.ALL_TERMS, pblocks))
        times = {"this": [], "parent": []}
        for name in ("this", "parent", "parent", "this"):
            times[name].append(_path_ms([first, runs[name]])[1])
        cuts = _energy_cuts(parent, c, loss, pblocks)
        torch.cuda.synchronize()
    return dict(times, blocks=pblocks, max_rel_err=rel, cuts=cuts)


def energy_kernels(main_run, led_run):
    """The energies' kernel (csrc/energy.cu) against its plain version on
    the card (_energy_case): the main run's final problem (SH1, 40
    keyframes) and the LED run's after its upsample, each under every
    robust loss (the main one under its own loss timed, and with the cuts
    of _energy_cuts); the mesh's two kinds of call (the PS sum alone, the
    three regularizers alone); one row; no valid row; the persistent grid's
    edges (_energy_edges); with --energy-parent the main case in turns with
    an earlier build.  Launches made here are on no path.  -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import energy as E

    flush = (torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
             if DEVICE == "cuda" else None)
    main = _energy_inputs(main_run["pipe"].refiner, "main SH1")
    led = _energy_inputs(led_run["pipe"].refiner, "LED after the upsample")
    loss = REFINE_SH1["loss function"]
    cases = [_energy_case(main, loss, flush)]
    for c in (main, led):
        cases += [_energy_case(c, name) for name in LOSS_NAMES
                  if c is led or name != loss]
    cases += [_energy_case(main, loss, terms=E.PS),
              _energy_case(main, loss, terms=E.REGULARIZERS)]
    first = int(torch.nonzero(main["prob"].valid)[0])
    cases.append(_energy_case(_energy_rows(main, [first], "one row"), loss))
    none = dict(main, what="no valid row",
                prob=main["prob"]._replace(valid=torch.zeros_like(main["prob"].valid)),
                rd=main["rd"]._replace(mask=torch.zeros_like(main["rd"].mask)))
    cases.append(_energy_case(none, loss))
    check(all(v == 0 for v in cases[-1]["sums"]), "no valid row: a sum is not 0")
    check(tuple(led["ref"].geom.dims) == (2 * LED_GRID,) * 3,
          "the LED case is not the upsampled problem")
    cases += _energy_edges(main, loss)
    facts = {}
    if DEVICE == "cuda":
        N, F = (int(s) for s in main["rd"].mask.shape)
        facts["cuts"] = _energy_cuts(E._library(), main, loss,
                                     E.energy_blocks(N, F, _sm_count()))
        facts["registers"] = _ptxas(os.path.join("psgradientsdf_tpu_torch", "csrc",
                                                 "energy.cu"))
        if "--energy-parent" in sys.argv[1:]:
            facts["parent"] = _energy_parent_ab(main, loss)
        torch.cuda.empty_cache()
    return dict(cases=cases, checked=len(cases), tolerance=ENERGY_TOL, timed=cases[0],
                **facts)


@contextlib.contextmanager
def _first_led_light():
    """While the body runs, keep the arguments of the first call of
    ops/normaleq.light_normal_eqs_led (an LED run's first light block,
    before its upsample), w and r copied -> the dict, "args" once called.
    The module function is wrapped from outside."""
    from psgradientsdf_tpu_torch.ops import normaleq

    seen = {}
    real = normaleq.light_normal_eqs_led

    def fn(rd, *a):
        if "args" not in seen:
            seen["args"] = (rd._replace(w=rd.w.clone(), r=rd.r.clone()),) + tuple(
                t.clone() if hasattr(t, "clone") else t for t in a)
        return real(rd, *a)

    normaleq.light_normal_eqs_led = fn
    try:
        yield seen
    finally:
        normaleq.light_normal_eqs_led = real


def _tail_inputs(ref, w_n, w_l, what, diag_only=False):
    """A refiner's distance block at its state: its problem, dist, the
    step h, the operators its weights turn on, and the step its solve
    takes there (dist_system and dist_cg on _dist_inputs) -> dict."""
    from psgradientsdf_tpu_torch.ops import distcg as DC

    c = _dist_inputs(ref, w_n, w_l, diag_only)
    A, t = DC.dist_system(c["rd"], c["DJ"], c["eik"], reg_weight_n=w_n)
    cg_kw = dict(reg_weight_l=w_l, damping=c["damping"], cg_iters=100, cg_tol=1e-6,
                 cg_static=False)
    delta = DC.dist_cg(A, t, c["prob"].valid, c["stencil"], c["lap"], **cg_kw)
    return dict(what=what, prob=c["prob"], dist=ref.dist,
                h=float(ref._static_kwargs()["voxel_size"]), eikonal=w_n != 0.0,
                laplacian=w_l != 0.0, diag_only=diag_only, delta=delta,
                system=(A, t, c["prob"].valid, c["stencil"], c["lap"], cg_kw, w_n, c))


def _tail_rows(c, rows, what):
    """c on the rows `rows` alone, every stencil neighbour's value frozen
    in as a constant (parallel/refine.py's distance view)."""
    import torch
    from psgradientsdf_tpu_torch.parallel.refine import _dist_view

    view = _dist_view(c["prob"], c["dist"])
    idx = torch.as_tensor(list(rows), dtype=torch.long, device=c["dist"].device)
    prob = view._replace(**{f: getattr(view, f)[idx] for f in view._fields
                            if f != "n_surface"}, n_surface=len(rows))
    return dict(c, what=what, prob=prob, dist=c["dist"][idx], delta=c["delta"][idx],
                system=None)


def _empty_launch_ms():
    """Device ms of an empty launch (a spin kernel of 0 cycles) timed as
    _path_ms times a path's kernels."""
    import torch

    return _path_ms([lambda: torch.cuda._sleep(0)])[0]


def _ops_case(c, flush=None):
    """reg_operators (csrc/distreg.cu) twice and its plain version on c:
    every output bit for bit, the second launch too; with `flush` its time
    in the distance block's order (_path_ms: the operators, dist_system,
    dist_cg, the update), after the flush, the plain chain's, and its byte
    bound -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC
    from psgradientsdf_tpu_torch.ops import distreg as DR

    args = (c["prob"], c["dist"], c["h"])
    kw = dict(eikonal=c["eikonal"], laplacian=c["laplacian"], diag_only=c["diag_only"])
    got, again, plain = (DR.reg_operators(*args, **kw), DR.reg_operators(*args, **kw),
                         DR.reg_operators_plain(*args, **kw))
    _sync()
    outs = {}
    for op, a, b, p in zip(("eikonal", "laplacian"), got, again, plain):
        check((a is None) == (p is None) == (not kw[op]), f"{c['what']}: {op} asked for or not")
        if a is None:
            continue
        for name in a._fields:
            x, y, z = getattr(a, name), getattr(b, name), getattr(p, name)
            if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                outs[f"{op}.{name}"] = _abs_err(x, z)
                check(_bits_equal(x, z), f"reg_operators differs from its plain version: "
                                         f"{c['what']}, {op} {name}, by up to {_abs_err(x, z)}")
                check(_bits_equal(x, y), f"{c['what']}: two reg_operators launches differ")
            else:
                check(x is z or x == z, f"{c['what']}: {op} {name} differs")
    p = c["prob"]
    N = int(p.valid.shape[0])
    valid = p.valid
    out = dict(case=c["what"], rows=N, valid_rows=int(valid.sum()), **kw,
               frozen_links=int((p.nbr_idx[valid] < 0).sum()), bit_identical=True,
               max_abs_err=0.0)
    if not bool(valid.any()):
        check(all(float(op.r.abs().max()) == 0.0 for op in got if op is not None),
              f"{c['what']}: a residual of no valid row is not 0")
    if flush is not None and DEVICE == "cuda":
        A, t, v, st, lap, cg_kw, w_n, dc = c["system"]
        path = _path_ms([lambda: DR.reg_operators(*args, **kw),
                         lambda: DC.dist_system(dc["rd"], dc["DJ"], dc["eik"], reg_weight_n=w_n),
                         lambda: DC.dist_cg(A, t, v, st, lap, **cg_kw),
                         lambda: DR.dist_update(p, c["dist"], c["delta"], c["h"])])
        # each input read once (valid, dist, the direction, the indices and
        # the constants; lap_idx and its constants with the Laplacian), each
        # output written once (r, J0, Ji; the Laplacian's r)
        read = 53 + (72 if c["laplacian"] else 0)
        written = (20 if c["eikonal"] else 0) + (4 if c["laplacian"] else 0)
        bound = N * (read + written) / HBM_BYTES_PER_S * 1e3
        out["reg_operators"] = dict(
            ms=path[0], ms_after_flush=_time_ms(lambda: DR.reg_operators(*args, **kw), flush),
            plain_ms=_time_ms(lambda: DR.reg_operators_plain(*args, **kw), flush),
            bound_ms=bound, bytes=N * (read + written), max_abs_err=0.0, library_ms=None,
            blocks=DR.row_blocks(N, _sm_count()))
        out["reg_operators"]["share_of_bound"] = bound / path[0]
        out["path_ms"] = dict(reg_operators=path[0], dist_system=path[1], dist_cg=path[2],
                              dist_update=path[3])
    return out


def _dist_update_case(c, delta, what, flush=None, path=None):
    """dist_update (csrc/distreg.cu) twice and its plain version on c's
    problem and dist with the step `delta` (None: the gradient alone):
    both outputs bit for bit, the second launch too; with `flush` its time
    (`path`: the distance block's, _ops_case), after the flush, the plain
    chain's and its byte bound -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import distreg as DR

    args = (c["prob"], c["dist"], delta, c["h"])
    got, again, plain = DR.dist_update(*args), DR.dist_update(*args), DR.dist_update_plain(*args)
    _sync()
    for name, a, b, p in zip(("new_dist", "new_grad"), got, again, plain):
        check(_bits_equal(a, p), f"dist_update differs from its plain version: {what}, "
                                 f"{name}, by up to {_abs_err(a, p)}")
        check(_bits_equal(a, b), f"{what}: two dist_update launches differ")
    N = int(c["dist"].shape[0])
    accepted = int((got[0] != c["dist"]).sum()) if delta is not None else 0
    out = dict(case=what, rows=N, valid_rows=int(c["prob"].valid.sum()),
               step=delta is not None, accepted=accepted, bit_identical=True)
    if flush is not None and DEVICE == "cuda":
        # valid, dist, delta, the direction, the indices and the constants
        # read once, the new distances and gradient written once
        nbytes = N * (57 + 16)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out["dist_update"] = dict(
            ms=path["dist_update"], ms_after_flush=_time_ms(lambda: DR.dist_update(*args), flush),
            plain_ms=_time_ms(lambda: DR.dist_update_plain(*args), flush),
            bound_ms=bound, bytes=nbytes, max_abs_err=0.0, library_ms=None,
            blocks=DR.row_blocks(N, _sm_count()))
        out["dist_update"]["share_of_bound"] = bound / path["dist_update"]
    return out


def _edge_steps(c):
    """Steps of exactly the threshold (the float the plain rule compares
    with) and one ulp either side, of both signs, row by row."""
    import torch
    from psgradientsdf_tpu_torch.ops import distreg as DR

    thr = torch.tensor(DR.accept_threshold(c["h"]), dtype=torch.float32)
    below = torch.nextafter(thr, torch.tensor(0.0))
    above = torch.nextafter(thr, torch.tensor(1.0))
    six = torch.stack([below, thr, above, -below, -thr, -above])
    N = int(c["dist"].shape[0])
    return six.repeat(-(-N // 6))[:N].to(c["dist"].device), six


def _fused_inputs(c, what, prob=None, rows=None, diag_only=None):
    """A distance tail case (_tail_inputs) as the fused stages take it: its
    residual pass and Jacobian (rows `rows` alone), its problem (`prob`:
    another one of the same rows) and that problem's reverse stencil table,
    the weights and the CG's arguments -> dict."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC

    _, _, _, st, _, cg_kw, w_n, dc = c["system"]
    rd, DJ, dist = dc["rd"], dc["DJ"], c["dist"]
    prob = c["prob"] if prob is None else prob
    if rows is not None:
        idx = torch.as_tensor(rows, dtype=torch.long, device=dist.device)
        rd = rd._replace(w=rd.w[idx].contiguous(), r=rd.r[idx].contiguous())
        DJ = DJ._replace(J0=DJ.J0[idx].contiguous(), Ji=DJ.Ji[idx].contiguous())
        dist = dist[idx]
    if st.source is not prob.nbr_idx:
        st = DC.stencil_reverse(prob)
    return dict(what=what, prob=prob, dist=dist, h=c["h"], rd=rd, DJ=DJ, stencil=st,
                w_n=w_n, w_l=cg_kw["reg_weight_l"], cg_kw=cg_kw,
                diag_only=c["diag_only"] if diag_only is None else diag_only,
                jacobian=dc["jacobian"] if rows is None else None)


def _fused_system_case(f):
    """dist_system with its regularizer stage (ops/distcg.dist_system_reg)
    twice, bulk-copied and with the lanes' loads (w one float off a 16-byte
    boundary), against the plain chain (reg_operators_plain, then
    dist_system_plain): A, t and the Laplacian's residual bit for bit ->
    (facts, (A, t, lap))."""
    from psgradientsdf_tpu_torch.ops import distcg as DC
    from psgradientsdf_tpu_torch.ops import distreg as DR

    prob, dist, h, st = f["prob"], f["dist"], f["h"], f["stencil"]
    kw = dict(reg_weight_n=f["w_n"], reg_weight_l=f["w_l"], diag_only=f["diag_only"])
    eik, lap = DR.reg_operators_plain(prob, dist, h, eikonal=f["w_n"] != 0.0,
                                      laplacian=f["w_l"] != 0.0, diag_only=f["diag_only"])
    want = DC.dist_system_plain(f["rd"], f["DJ"], eik, reg_weight_n=f["w_n"])
    out = dict(case=f["what"], rows=int(dist.shape[0]), valid_rows=int(prob.valid.sum()),
               eikonal=eik is not None, laplacian=lap is not None, diag_only=f["diag_only"])
    for form, rd in (("bulk-copied", f["rd"]), ("lanes' loads", _misaligned(f["rd"]))):
        got = DC.dist_system_reg(rd, f["DJ"], prob, dist, st, h, **kw)
        again = DC.dist_system_reg(rd, f["DJ"], prob, dist, st, h, **kw)
        _sync()
        for name, a, b, w in (("A", got[0], again[0], want[0]), ("t", got[1], again[1], want[1])):
            check(_bits_same(a, w), f"dist_system with the regularizer stage differs from "
                                    f"the plain chain: {f['what']}, {form}, {name}, by up to "
                                    f"{_abs_err(a, w)}")
            check(_bits_same(a, b), f"{f['what']}, {form}: two fused dist_system runs differ")
        check((got[2] is None) == (lap is None), f"{f['what']}: the Laplacian asked for or not")
        if lap is not None:
            check(_bits_same(got[2].r, lap.r) and _bits_same(again[2].r, lap.r),
                  f"{f['what']}, {form}: lap_r differs from reg_operators_plain's by up to "
                  f"{_abs_err(got[2].r, lap.r)}")
            check((got[2].diag_coef, got[2].nbr_coef) == (lap.diag_coef, lap.nbr_coef),
                  f"{f['what']}: the Laplacian's coefficients")
        if DEVICE == "cuda":
            N, F = rd.w.shape[:2]
            out["plan" if form == "bulk-copied" else "plan_lanes_loads"] = DC.system_plan(
                rd.w.device, N, 3 * F, staged=form == "bulk-copied")._asdict()
    out["bit_identical"] = True
    return out, got


def _fused_cg_case(what, A, t, prob, dist, st, lap, h, cg_kw):
    """dist_cg with its update stage (ops/distcg.dist_cg_update) twice
    against the unfused dist_cg on the same A, t (delta and the steps bit for
    bit) and dist_update_plain on that delta (new_dist and new_grad bit for
    bit) -> facts with the plan."""
    from psgradientsdf_tpu_torch.ops import distcg as DC
    from psgradientsdf_tpu_torch.ops import distreg as DR

    s0, s1, s2 = [], [], []
    d0 = DC.dist_cg(A, t, prob.valid, st, lap, **cg_kw, steps_out=s0)
    d1, n1, g1 = DC.dist_cg_update(A, t, prob, dist, st, lap, h, **cg_kw, steps_out=s1)
    d2, n2, g2 = DC.dist_cg_update(A, t, prob, dist, st, lap, h, **cg_kw, steps_out=s2)
    nu, gu = DR.dist_update_plain(prob, dist, d0, h)
    _sync()
    k = [int(s[0]) for s in (s0, s1, s2)]
    check(_bits_same(d1, d0) and k[1] == k[0],
          f"dist_cg with the update stage: delta or its {k[1]} steps differ from the unfused "
          f"dist_cg's ({k[0]}), by up to {_abs_err(d1, d0)} ({what})")
    for name, a, b, w in (("new_dist", n1, n2, nu), ("new_grad", g1, g2, gu)):
        check(_bits_same(a, w), f"dist_cg's update stage differs from dist_update_plain: "
                                f"{what}, {name}, by up to {_abs_err(a, w)}")
        check(_bits_same(a, b), f"{what}: two fused dist_cg runs differ ({name})")
    check(_bits_same(d2, d1) and k[2] == k[1], f"{what}: two fused dist_cg runs differ")
    return dict(case=what, rows=int(A.shape[0]), valid_rows=int(prob.valid.sum()),
                laplacian=lap is not None, steps=k[1], accepted=int((n1 != dist).sum()),
                bit_identical=True, plan=_cg_plan_facts(_cg_plan_of(A, lap, update=True)))


def _tiled_update_case(f, what, rows, mode):
    """The fused dist_cg (_fused_cg_case) on `rows` rows of copies of the
    main block's system (_tiled_inputs: the links past the cut cut), the
    problem's per-row update inputs and dist copied alike; its plan must
    take layout `mode` (None: any) -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC

    from psgradientsdf_tpu_torch.ops import distreg as DR

    p = f["prob"]
    eik = DR.reg_operators_plain(p, f["dist"], f["h"], eikonal=True, laplacian=False,
                                 diag_only=False)[0]
    N = p.valid.shape[0]
    A, t, valid, st = _tiled_inputs(dict(f, eik=eik), rows)
    copies = -(-rows // N)
    rep = lambda x: x.repeat(copies, *([1] * (x.dim() - 1)))[:rows].contiguous()
    prob = p._replace(valid=valid, nbr_idx=st.nbr.long(), nbr_dir=rep(p.nbr_dir),
                      nbr_dist_const=rep(p.nbr_dist_const), lap_idx=st.lap.long(),
                      lap_dist_const=rep(p.lap_dist_const), idx_xyz=rep(p.idx_xyz))
    st = DC.StencilReverse(st.nbr, st.rev, st.lap, prob.nbr_idx)
    out = _fused_cg_case(what, A, t, prob, rep(f["dist"]), st, None, f["h"],
                         dict(f["cg_kw"], reg_weight_l=0.0))
    check(mode in (None, out["plan"]["mode"]),
          f"{what}: the {out['plan']['mode']} layout, expected {mode}")
    return out


def _fused_times(f, system, flush):
    """The main block's two fused launches in the distance block's order
    (dist_jacobian, dist_system with the regularizer stage, dist_cg with the
    update stage; _path_ms), each beside its byte bound, its plain chain's
    time and, for dist_cg, empty cooperative launches on its grid crossing
    its barriers with and without the update's; then the whole block timed
    in turns against this build's five launches (the standalone tail
    kernels) -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC
    from psgradientsdf_tpu_torch.ops import distreg as DR

    prob, dist, h, st, rd = f["prob"], f["dist"], f["h"], f["stencil"], f["rd"]
    skw = dict(reg_weight_n=f["w_n"], reg_weight_l=f["w_l"], diag_only=f["diag_only"])
    cg_kw = f["cg_kw"]
    DJ = f["jacobian"]()
    A, t, lap = system
    N, F = rd.w.shape[:2]
    dev = rd.w.device
    path = _path_ms([f["jacobian"],
                     lambda: DC.dist_system_reg(rd, DJ, prob, dist, st, h, **skw),
                     lambda: DC.dist_cg_update(A, t, prob, dist, st, lap, h, **cg_kw)])
    steps = []
    DC.dist_cg_update(A, t, prob, dist, st, lap, h, **cg_kw, steps_out=steps)
    k = int(steps[0])
    laplacian, lap_nbr = lap is not None, lap is not None and lap.nbr_coef != 0.0
    # dist_system: w, r, J0, Ji read once (24 bytes a pair), A and t written
    # (56 bytes a row), the stage's stencil read once (valid, dist, the
    # int32 indices, the constants and the direction: 41 bytes a row; the
    # Laplacian's indices and constants 48 and lap_r written 4)
    sys_bytes = N * (24 * 3 * F + 56 + 41 + (52 if laplacian else 0))
    # dist_cg: A, t, nbr and rev (int32) and the mask read, delta written
    # (97 bytes a row; the Laplacian's residual and lap_idx where read), and
    # the update stage's dist, direction and constants read and new_dist and
    # new_grad written (44)
    cg_bytes = N * (97 + 44 + (4 if laplacian else 0) + (24 if lap_nbr else 0))
    plan = _cg_plan_of(A, lap, update=True)
    barriers = DC.grid_barriers(plan, k)
    floors = _path_ms([lambda: DC.barrier_floor(dev, plan, barriers),
                       lambda: DC.barrier_floor(dev, plan, barriers - 1)])
    eik_plain = lambda: DR.reg_operators_plain(prob, dist, h, eikonal=f["w_n"] != 0.0,
                                               laplacian=laplacian, diag_only=f["diag_only"])
    out = dict(
        path_ms=dict(dist_jacobian=path[0], dist_system=path[1], dist_cg=path[2]),
        dist_system=dict(
            ms=path[1], bound_ms=sys_bytes / HBM_BYTES_PER_S * 1e3, bytes=sys_bytes,
            plain_ms=_time_ms(lambda: DC.dist_system_plain(rd, DJ, eik_plain()[0],
                                                           reg_weight_n=f["w_n"]), flush),
            max_abs_err=0.0),
        dist_cg=dict(
            ms=path[2], bound_ms=cg_bytes / HBM_BYTES_PER_S * 1e3, bytes=cg_bytes,
            steps=k, grid_barriers=barriers, blocks=plan.blocks,
            barrier_floor_ms=floors[0], barrier_floor_without_update_ms=floors[1],
            update_barrier_ms=floors[0] - floors[1],
            plain_ms=_time_ms(lambda: DR.dist_update_plain(
                prob, dist, DC.dist_cg_plain(A, t, prob.valid, st, lap, **cg_kw), h), flush),
            max_abs_err=0.0, library_ms=None))
    for name in ("dist_system", "dist_cg"):
        out[name]["share_of_bound"] = out[name]["bound_ms"] / out[name]["ms"]

    def three():
        DJ3 = f["jacobian"]()
        A3, t3, lap3 = DC.dist_system_reg(rd, DJ3, prob, dist, st, h, **skw)
        return DC.dist_cg_update(A3, t3, prob, dist, st, lap3, h, **cg_kw)[1:]

    def five():
        DJ5 = f["jacobian"]()
        eik5, lap5 = DR.reg_operators(prob, dist, h, eikonal=f["w_n"] != 0.0,
                                      laplacian=laplacian, diag_only=f["diag_only"])
        A5, t5 = DC.dist_system(rd, DJ5, eik5, reg_weight_n=f["w_n"])
        return DR.dist_update(prob, dist, DC.dist_cg(A5, t5, prob.valid, st, lap5, **cg_kw), h)

    out["block"] = _block_turns(dict(three=three, five=five))
    if "--distreg-parent" in sys.argv[1:]:
        out["parent"] = _tail_parent_ab(three, five)
    return out


def _block_turns(runs):
    """Each of `runs` (a name -> a callable making a whole distance block)
    once for its outputs, which must agree bit for bit, then timed in
    turns (the first, the second, the second, the first; _path_ms of the
    block as one unit) -> {name: [ms, ms]}."""
    names = list(runs)
    outs = [runs[n]() for n in names]
    _sync()
    for n, o in zip(names[1:], outs[1:]):
        check(all(_bits_same(a, b) for a, b in zip(o, outs[0])),
              f"the distance block through {n} differs from {names[0]}")
    times = {n: [] for n in names}
    for n in (names[0], names[1], names[1], names[0]):
        times[n].append(_path_ms([runs[n]])[0])
    return times


def _tail_parent_ab(three, five):
    """The whole distance block on the --distreg-parent build (its
    distreg.cu and the distcg.cu beside it, with the headers beside them;
    built here into a temporary directory): five launches, this build's
    wrappers on the parent's libraries (its C argument blocks are prefixes
    of this build's), bit for bit against this build's three, timed in
    turns: the parent, this, this, the parent -> {"parent"|"this": [ms, ms],
    sources}.  Its launches are on no path."""
    from psgradientsdf_tpu_torch.ops import distcg as DC
    from psgradientsdf_tpu_torch.ops import distreg as DR

    src = sys.argv[sys.argv.index("--distreg-parent") + 1]
    cg_src = os.path.join(os.path.dirname(src), "distcg.cu")
    with tempfile.TemporaryDirectory(prefix="tail_parent_") as tmp:
        reg_lib = _parent_build(src, tmp, "distreg_parent")
        reg_lib.reg_operators.argtypes = [ctypes.POINTER(DR._RegArgs), ctypes.c_void_p]
        reg_lib.dist_update.argtypes = [ctypes.POINTER(DR._UpdateArgs), ctypes.c_void_p]
        cg_lib = DC._bind(_parent_build(cg_src, tmp, "distcg_parent"))
        this_reg, this_cg = DR._library(), DC._library()

        def parent():
            DR._bound, DC._bound = reg_lib, cg_lib
            try:
                return five()
            finally:
                DR._bound, DC._bound = this_reg, this_cg

        times = _block_turns(dict(parent=parent, this=three))
    return dict(times, sources=[os.path.relpath(src), os.path.relpath(cg_src)],
                parent_registers=_ptxas(cg_src))


def _led_inputs(what, rd, prob, geom, dist, grad, albedo, poses):
    return dict(what=what, args=(rd, prob, geom, dist, grad, albedo, poses))


def _parent_led_blocks(N, F, sms):
    """The first LED light design's grid (a412c9f's led_blocks): a thread a
    pair, at most four blocks of 256 an SM."""
    return max(1, min(4 * sms, -(-N * F // 256)))


def _led_launch(lib, args, parent):
    """One launch of light_normal_eqs_led from library `lib` on the
    arguments of a call: with `parent`, an earlier build whose LightLedArgs
    is a prefix of this one's (the first design's), on its own grid; else
    this build on led_plan -> (H, g) (not counted)."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq as NE

    rd, prob, geom, dist, grad, albedo, poses = args
    N, F = int(rd.w.shape[0]), int(rd.w.shape[1])
    dev = rd.w.device
    plan = NE.led_plan(N, F, _sm_count())
    if parent:
        plan = plan._replace(blocks=_parent_led_blocks(N, F, _sm_count()))
    keep = [rd.w, rd.r, prob.idx_xyz.contiguous(), dist.contiguous(), grad.contiguous(),
            albedo.contiguous(), poses.contiguous()]
    partial = torch.empty(6 * plan.blocks, dtype=torch.float64, device=dev)
    Hg = torch.empty(6, dtype=torch.float32, device=dev)
    a = NE._LightLedArgs()
    for field, t in zip(("w", "r", "idx_xyz", "dist", "grad", "albedo", "poses"), keep):
        setattr(a, field, t.data_ptr())
    a.partial, a.ticket = partial.data_ptr(), NE._tickets_for(dev, 1).data_ptr()
    a.H, a.g = Hg.data_ptr(), Hg[3:].data_ptr()
    NE._led_plan_args(a, N, F, plan)
    a.origin_x, a.origin_y, a.origin_z = (float(v) for v in geom.origin)
    a.grid_voxel = float(geom.voxel_size)
    rc = lib.light_normal_eqs_led(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"light_normal_eqs_led ({lib}): CUDA error {rc}")
    return Hg[:3], Hg[3:]


def _led_case(c, flush=None, ref=None):
    """light_normal_eqs_led (csrc/normaleq.cu) twice and its plain version
    on c: H within NORMAL_EQ_TOL of the plain version's max|H|, g within it
    of each channel's sum of |w r J| (0 where the plain one is), the second
    launch bit for bit; with `flush` its time in the light block's order
    (_path_ms: the residual pass of `ref`, then the sums) beside an empty
    launch of its grid there, after the flush, the plain chain's, one
    einsum's forming H and g from w J, J and r formed beforehand
    (library_ms) and its byte bound -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq as NE
    from psgradientsdf_tpu_torch.ops import residual as RS
    from psgradientsdf_tpu_torch.refine import jacobians

    args = c["args"]
    rd, prob, geom, dist, grad, albedo, poses = args
    H, g = NE.light_normal_eqs_led(*args)
    H2, g2 = NE.light_normal_eqs_led(*args)
    Hp, gp = NE.light_normal_eqs_led_plain(*args)
    J = jacobians.light_jacobian_led(prob, geom, dist, grad, albedo, poses)
    g_scale = (rd.w * J * rd.r).abs().sum(dim=(0, 1))
    _sync()
    h_err = float((H - Hp).abs().max() / Hp.abs().max().clamp(min=1e-30))
    if float(Hp.abs().max()) == 0.0:
        h_err = float(H.abs().max())
    g_err = float(torch.where(g_scale > 0, (g - gp).abs() / g_scale.clamp(min=1e-30),
                              (g - gp).abs()).max())
    N, F = int(rd.w.shape[0]), int(rd.w.shape[1])
    out = dict(case=c["what"], rows=N, keyframes=F, H=[float(v) for v in H.cpu()],
               g=[float(v) for v in g.cpu()], H_rel_err=h_err, g_rel_err=g_err,
               counted_pairs=int((rd.w != 0).any(-1).sum()),
               bits_again=_bits_equal(torch.cat([H, g]), torch.cat([H2, g2])),
               max_abs_err=max(_abs_err(H, Hp), _abs_err(g, gp)))
    check(out["bits_again"], f"{c['what']}: two light_normal_eqs_led launches differ")
    check(h_err <= NORMAL_EQ_TOL and g_err <= NORMAL_EQ_TOL,
          f"{c['what']}: light_normal_eqs_led H {h_err:.3g}, g {g_err:.3g} from its plain "
          f"version (limit {NORMAL_EQ_TOL})")
    if flush is not None and DEVICE == "cuda":
        skw = ref._static_kwargs()
        path = _path_ms([lambda: RS.residual_pass(*ref._args(), **skw),
                         lambda: NE.light_normal_eqs_led(*args)])
        # w and r of every pair, a row's voxel, dist, gradient and albedo,
        # the poses read once; H and g written
        nbytes = N * F * 24 + N * 40 + F * 64 + 24
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        # one PyTorch call forming H and g: an einsum of w J against J and
        # r stacked, both formed beforehand
        wJ, JR = (rd.w * J).contiguous(), torch.stack([J, rd.r], -1).contiguous()
        out["light_normal_eqs_led"] = dict(
            ms=path[1], residual_pass_ms=path[0],
            # an empty kernel on the light's grid, block and shared memory,
            # in its place in the path
            empty_launch_ms=_path_ms([lambda: RS.residual_pass(*ref._args(), **skw),
                                      lambda: NE.light_led_floor(N, F, rd.w.device)])[1],
            ms_after_flush=_time_ms(lambda: NE.light_normal_eqs_led(*args), flush),
            plain_ms=_time_ms(lambda: NE.light_normal_eqs_led_plain(*args), flush),
            library_ms=_time_ms(lambda: torch.einsum("nfc,nfck->ck", wJ, JR), flush),
            bound_ms=bound, bytes=nbytes, max_abs_err=out["max_abs_err"],
            plan=list(NE.led_plan(N, F, _sm_count())))
        out["light_normal_eqs_led"]["share_of_bound"] = bound / path[1]
    return out


def _led_frames(args, F):
    """The LED light's arguments with F keyframes: the block's keyframes
    repeated in turn (w, r and the poses; contiguous copies)."""
    import torch

    rd, prob, geom, dist, grad, albedo, poses = args
    idx = torch.arange(F, device=rd.w.device) % rd.w.shape[1]
    return (rd._replace(w=rd.w[:, idx].contiguous(), r=rd.r[:, idx].contiguous()), prob,
            geom, dist, grad, albedo, poses[idx].contiguous())


def _led_rows(args, lo, hi):
    """The LED light's arguments on rows [lo, hi): w and r as row-slice views
    (as the mesh passes a block's rows), the voxel state cut alike."""
    rd, prob, geom, dist, grad, albedo, poses = args
    return (rd._replace(w=rd.w[lo:hi], r=rd.r[lo:hi]),
            prob._replace(idx_xyz=prob.idx_xyz[lo:hi]), geom, dist[lo:hi], grad[lo:hi],
            albedo[lo:hi], poses)


def _led_edges(args):
    """light_normal_eqs_led on the plan's edges (_led_case each): F = 1, 33
    and 40 keyframes (a warp's step: 32 / F voxels, or 32 pairs past 32), one
    row of 33, row slices of w and r off a 16-byte boundary (F = 33 from row
    1; copies of F = 8 and F = 33 one float past a boundary) each bit for bit against
    an aligned copy, and the mesh_refine (b) block: the LED run's rows of
    its second Z-slab and the first half of its keyframes, as the 4x2 mesh
    passes them -> [facts]."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq as NE

    def aligned(a):
        rd = a[0]
        return (rd._replace(w=rd.w.clone(), r=rd.r.clone()),) + a[1:]

    def moved(a):
        rd = a[0]
        return (rd._replace(w=_off_boundary(rd.w), r=_off_boundary(rd.r)),) + a[1:]

    def held(what, a):
        got = torch.cat(NE.light_normal_eqs_led(*a))
        want = torch.cat(NE.light_normal_eqs_led(*aligned(a)))
        check(_bits_equal(got, want), f"{what}: light_normal_eqs_led differs from an "
                                      "aligned copy's")
        fact = _led_case(_led_inputs(what, *a))
        fact.update(w_offset=int(a[0].w.data_ptr() % 16), bits_as_aligned=True)
        return fact

    N = int(args[0].w.shape[0])
    f1 = _led_frames(args, 1)
    f33, f40 = _led_frames(args, 33), _led_frames(args, 40)
    out = [_led_case(_led_inputs("F = 1", *f1)), _led_case(_led_inputs("F = 33", *f33)),
           _led_case(_led_inputs("F = 40", *f40)),
           _led_case(_led_inputs("one row of F = 33", *_led_rows(f33, 0, 1)))]
    out.append(held("F = 33 from row 1 (a row slice)", _led_rows(f33, 1, N)))
    out.append(held("F = 8 off a 16-byte boundary", moved(args)))
    out.append(held("F = 33 off a 16-byte boundary", moved(f33)))
    z, nf = MESH_REFINE["z"], MESH_REFINE["frames"]
    rows, F = -(-N // z), int(args[0].w.shape[1])
    mesh = _led_frames(_led_rows(args, rows, 2 * rows), F // nf)
    out.append(held(f"the mesh_refine (b) block: {rows} rows x {F // nf} keyframes",
                    _led_rows(mesh, 0, rows)))
    check(out[0]["keyframes"] == 1 and out[2]["keyframes"] == 40 and out[3]["rows"] == 1,
          "the LED light's edges are not the plan's")
    return out


def _led_parent_ab(args, ref):
    """light_normal_eqs_led on this normaleq.cu and on the --led-parent
    source (built here into a temporary directory; its launches on no path
    and not counted), the parent's H and g within NORMAL_EQ_TOL of the plain
    version's as this kernel's, timed in turns in the light block's order
    (_path_ms: the residual pass of `ref`, then the sums): this, the
    parent, the parent, this -> {"this"|"parent": [ms, ms]}."""
    import torch
    from psgradientsdf_tpu_torch.ops import normaleq as NE
    from psgradientsdf_tpu_torch.ops import residual as RS

    src = sys.argv[sys.argv.index("--led-parent") + 1]
    skw = ref._static_kwargs()
    with tempfile.TemporaryDirectory(prefix="led_parent_") as tmp:
        parent = _parent_build(src, tmp, "normaleq_parent")
        parent.light_normal_eqs_led.argtypes = [ctypes.POINTER(NE._LightLedArgs),
                                                ctypes.c_void_p]
        runs = dict(this=lambda: NE.light_normal_eqs_led(*args),
                    parent=lambda: _led_launch(parent, args, True))
        Hp, gp = NE.light_normal_eqs_led_plain(*args)
        H, g = runs["parent"]()
        h_err = float((H - Hp).abs().max() / Hp.abs().max().clamp(min=1e-30))
        check(h_err <= NORMAL_EQ_TOL, f"the parent's LED light H {h_err:.3g} from its plain "
                                      "version")
        times = {"this": [], "parent": []}
        for name in ("this", "parent", "parent", "this"):
            times[name].append(_path_ms([lambda: RS.residual_pass(*ref._args(), **skw),
                                         runs[name]])[1])
        torch.cuda.synchronize()
    return dict(times, parent_H_rel_err=h_err)


def dist_tail_kernels(main_run, led_run, led_first):
    """The distance tail's kernels and the LED light's (csrc/distreg.cu,
    csrc/normaleq.cu light_led_kernel) against their plain versions on the
    card.  reg_operators, bit for bit: the main run's final problem (SH1,
    the Eikonal operator alone at its loop's weight, timed), the LED run's
    after the upsample (both operators; the Laplacian's diagonal alone),
    one row, no valid row, a row whose every neighbour is frozen.
    dist_update, bit for bit: the main and the LED problems with their
    solves' steps (the main one timed), every step refused, every step
    accepted, steps at the threshold and one ulp either side (the card's
    rule read off: the ulp below accepted, the threshold and above not),
    the gradient alone (delta=None), one row, no valid row.
    light_normal_eqs_led, within NORMAL_EQ_TOL: the LED run's block after
    the upsample (timed) and before it (`led_first`: its first light
    block's arguments), one keyframe, one row, no counted pair.  Each
    kernel twice bit for bit.
    The tail as stages of the one-card block's launches, bit for bit
    against the plain chains (_fused_system_case, _fused_cg_case): the main
    SH1 and LED cases, the Laplacian's diagonal alone, one row, no valid
    row, a frozen row; the update stage also on copies of the main block in
    every layout of dist_cg's plan (_tiled_update_case); on the card both
    fused kernels timed in the block's order and the whole block in turns
    with five launches (_fused_times; with --distreg-parent also the
    parent's).  Launches made here are on no path.
    -> facts."""
    import torch
    from psgradientsdf_tpu_torch.ops import distcg as DC
    from psgradientsdf_tpu_torch.ops import distreg as DR

    flush = (torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
             if DEVICE == "cuda" else None)
    ref, led = main_run["pipe"].refiner, led_run["pipe"].refiner
    main_w, led_w = _loop_weights(ref), _loop_weights(led)
    check(main_w[0] > 0 and main_w[1] == 0 and led_w[0] > 0 and led_w[1] > 0,
          f"the loops' weights: {main_w}, {led_w}")
    main = _tail_inputs(ref, *main_w, "main SH1")
    lc = _tail_inputs(led, *led_w, "LED after the upsample")
    ops = [_ops_case(main, flush)]
    path = ops[0].get("path_ms")
    ops.append(_ops_case(lc))
    ops.append(_ops_case(dict(lc, what="LED, the Laplacian's diagonal alone", diag_only=True)))
    p = lc["prob"]
    valid_rows = torch.nonzero(p.valid)[:, 0]
    row = int(valid_rows[len(valid_rows) // 2])
    ops.append(_ops_case(_tail_rows(lc, [row], "one row")))
    ops.append(_ops_case(dict(lc, what="no valid row",
                              prob=p._replace(valid=torch.zeros_like(p.valid)))))
    nbr, lap = p.nbr_idx.clone(), p.lap_idx.clone()
    nbr[row], lap[row] = -1, -1
    cut = dict(lc, what="a row with every neighbour frozen",
               prob=p._replace(nbr_idx=nbr, lap_idx=lap))
    ops.append(_ops_case(cut))
    check(ops[0]["eikonal"] and not ops[0]["laplacian"] and ops[1]["laplacian"],
          "the main case is not the Eikonal operator alone or the LED case not both")

    upd = [_dist_update_case(main, main["delta"], "main SH1, its solve's step", flush, path),
           _dist_update_case(lc, lc["delta"], "LED after the upsample, its solve's step")]
    thr = DR.accept_threshold(main["h"])
    upd.append(_dist_update_case(main, torch.full_like(main["dist"], 2.0 * thr),
                            "main SH1, every step refused"))
    check(upd[-1]["accepted"] == 0, "every step refused: a row moved")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    sign = torch.where(torch.rand(main["dist"].shape, generator=gen) < 0.5, -1.0, 1.0)
    upd.append(_dist_update_case(main, (0.5 * thr * sign).to(main["dist"].device),
                            "main SH1, every step accepted"))
    check(upd[-1]["accepted"] == upd[-1]["valid_rows"],
          f"every step accepted: {upd[-1]['accepted']} of {upd[-1]['valid_rows']} rows moved")
    steps, six = _edge_steps(main)
    upd.append(_dist_update_case(main, steps, "main SH1, steps at the threshold and one ulp "
                                         "either side"))
    got = DR.dist_update(main["prob"], main["dist"], steps, main["h"])[0]
    moved = (got != main["dist"]) & main["prob"].valid
    taken = [bool(moved[k::6][main["prob"].valid[k::6]].all()) for k in range(6)]
    refused = [not bool(moved[k::6].any()) for k in range(6)]
    check(taken[0] and taken[3] and all(refused[k] for k in (1, 2, 4, 5)),
          f"the threshold on the card: taken {taken}, refused {refused}")
    upd[-1].update(threshold=float(six[1]), steps=[float(v) for v in six],
                   accepted_by_kind=taken)
    upd.append(_dist_update_case(main, None, "main SH1, the gradient alone (delta=None)"))
    upd.append(_dist_update_case(_tail_rows(lc, [row], "one row"), None, "LED one row, gradient"))
    one = _tail_rows(lc, [row], "one row")
    upd.append(_dist_update_case(one, one["delta"], "LED one row, its step"))
    none = lc["prob"]._replace(valid=torch.zeros_like(lc["prob"].valid))
    upd.append(_dist_update_case(dict(lc, prob=none), lc["delta"], "LED, no valid row"))
    check(upd[-1]["accepted"] == 0, "no valid row: a row moved")

    # the one-card block's tail as stages of its dist_system and dist_cg
    # launches, against the plain chains, on the same cases (the frozen row's
    # Laplacian links cut both ways, so that the stencil stays symmetric)
    nbr2, lap2 = p.nbr_idx.clone(), p.lap_idx.clone()
    nbr2[row], lap2[row] = -1, -1
    lap2[lap2 == row] = -1
    fused_cases = [
        _fused_inputs(main, "main SH1"), _fused_inputs(lc, "LED after the upsample"),
        _fused_inputs(lc, "LED, the Laplacian's diagonal alone", diag_only=True),
        _fused_inputs(lc, "one row", prob=_tail_rows(lc, [row], "one row")["prob"], rows=[row]),
        _fused_inputs(lc, "no valid row", prob=p._replace(valid=torch.zeros_like(p.valid))),
        _fused_inputs(lc, "a row with every neighbour frozen",
                      prob=p._replace(nbr_idx=nbr2, lap_idx=lap2))]
    fused_systems, fused_cgs, main_system = [], [], None
    for f in fused_cases:
        facts_f, system = _fused_system_case(f)
        fused_systems.append(facts_f)
        main_system = main_system or system
        fused_cgs.append(_fused_cg_case(f["what"], *system[:2], f["prob"], f["dist"],
                                        f["stencil"], system[2], f["h"], f["cg_kw"]))
    check(fused_systems[0]["eikonal"] and not fused_systems[0]["laplacian"]
          and fused_systems[1]["eikonal"] and fused_systems[1]["laplacian"],
          "the fused main case is not the Eikonal operator alone or the LED case not both")
    N_main = int(main["dist"].shape[0])
    sms = _sm_count() if DEVICE == "cuda" else 132
    for what, rows, mode in (
            ("four copies of the main block", 4 * N_main, None),
            ("the first row count past the resident tile",
             sms * DC.resident_tile_limit(False) + 1, "vectors"),
            ("eight copies of the main block", 8 * N_main, None),
            ("the first row count past the vectors' tile",
             sms * DC.vector_tile_limit(False) + 1, "global")):
        fused_cgs.append(_tiled_update_case(fused_cases[0], what, rows, mode))
    check({c["plan"]["mode"] for c in fused_cgs} == set(DC.MODES),
          "a layout of dist_cg's plan was not run with the update stage")
    fused_timed = (_fused_times(fused_cases[0], main_system, flush) if DEVICE == "cuda"
                   else None)

    rd_led = led._rd()
    after = _led_inputs("LED after the upsample", rd_led, led.prob, led.geom, led.dist,
                        led.grad_stored, led.albedo, led.poses)
    lights = [_led_case(after, flush, led)]
    check(bool(led_first.get("args")), "the LED run's first light block was not recorded")
    first = led_first["args"]
    lights.append(_led_case(_led_inputs("LED before the upsample", *first)))
    check(lights[-1]["rows"] < lights[0]["rows"], "the recorded block is not the smaller "
                                                  "problem before the upsample")
    rd, prob, geom, dist, grad, albedo, poses = after["args"]
    lights.append(_led_case(_led_inputs(
        "one keyframe", rd._replace(w=rd.w[:, :1].contiguous(), r=rd.r[:, :1].contiguous()),
        prob, geom, dist, grad, albedo, poses[:1].contiguous())))
    lights.append(_led_case(_led_inputs(
        "one row", rd._replace(w=rd.w[row:row + 1], r=rd.r[row:row + 1]),
        prob._replace(idx_xyz=prob.idx_xyz[row:row + 1]), geom, dist[row:row + 1],
        grad[row:row + 1], albedo[row:row + 1], poses)))
    lights.append(_led_case(_led_inputs(
        "no counted pair", rd._replace(w=torch.zeros_like(rd.w)), prob, geom, dist, grad,
        albedo, poses)))
    check(all(v == 0.0 for v in lights[-1]["H"] + lights[-1]["g"]),
          "no counted pair: H or g is not 0")
    lights += _led_edges(after["args"])
    facts = dict(reg_operators=ops, dist_update=upd, light_normal_eqs_led=lights,
                 fused=dict(dist_system=fused_systems, dist_cg=fused_cgs),
                 checked=len(ops) + len(upd) + len(lights) + len(fused_systems)
                 + len(fused_cgs), tolerance=NORMAL_EQ_TOL,
                 timed=dict(reg_operators=ops[0].get("reg_operators"),
                            dist_update=upd[0].get("dist_update"),
                            light_normal_eqs_led=lights[0].get("light_normal_eqs_led"),
                            rows=ops[0]["rows"], led_rows=lights[0]["rows"],
                            led_keyframes=lights[0]["keyframes"], path_ms=path,
                            fused=fused_timed))
    if DEVICE == "cuda":
        facts["timed"]["empty_launch_ms"] = _empty_launch_ms()
        if "--led-parent" in sys.argv[1:]:
            facts["parent"] = _led_parent_ab(after["args"], led)
        torch.cuda.empty_cache()
    return facts


FIRST_BLOCKS = {"albedo": "_albedo_core", "light": "_light_core",
                "distance": "_dist_core", "pose": "_pose_core"}


@contextlib.contextmanager
def _first_iteration_blocks(enabled):
    """With `enabled`, trace the first call of each block the body's
    refinement runs (refine/optimizer.py's block cores, wrapped from
    outside), each in its own torch.profiler session on the host and the
    card (_traced), the profiler started once beforehand so that its own
    set-up is in no block -> {block: its seconds, device kernels and device
    time, the operations that took the most host and device time, the
    warm-up records the trace lost}.  On one card the loop's iterations are
    graph replays, which run no Python: the first calls traced are those of
    the graph's warm-up, iteration 0 run eagerly on a copy of its state
    (refine/graph.py)."""
    facts = {}
    if not enabled:
        yield facts
        return
    import torch
    from psgradientsdf_tpu_torch.refine import optimizer

    with _traced(cpu=True):
        torch.zeros(1, device="cuda").add_(1)
    real = {b: getattr(optimizer, f) for b, f in FIRST_BLOCKS.items()}

    def traced(block):
        def fn(*a, **kw):
            if block in facts:
                return real[block](*a, **kw)
            with _traced(cpu=True) as prof:
                t0 = time.perf_counter()
                out = real[block](*a, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kernels = sorted(_kernel_rows(prof), reverse=True)
            host = sorted(((e.self_cpu_time_total, e.count, e.key)
                           for e in prof.key_averages()
                           if not str(e.device_type).endswith("CUDA")), reverse=True)
            facts[block] = dict(
                seconds=wall, warmup_dropped=prof.warmup_dropped,
                device_kernels=int(sum(r[1] for r in kernels)),
                device_ms=sum(r[0] for r in kernels) * 1e-3,
                top_host=[dict(name=k[:80], calls=n, self_host_ms=us * 1e-3)
                          for us, n, k in host[:8]],
                top_device=[dict(name=k[:80], launches=n, device_ms=us * 1e-3)
                            for us, n, k in kernels[:4]])
            return out
        return fn

    for b, f in FIRST_BLOCKS.items():
        setattr(optimizer, f, traced(b))
    try:
        yield facts
    finally:
        for b, f in FIRST_BLOCKS.items():
            setattr(optimizer, f, real[b])


def _checked_blocks(first_blocks):
    """_first_iteration_blocks' facts, once every block's trace is seen to
    hold its device activity."""
    check(set(first_blocks) == set(FIRST_BLOCKS)
          and all(b["device_kernels"] > 0 for b in first_blocks.values()),
          f"a first-iteration block's trace holds no device activity: "
          f"{ {k: b['device_kernels'] for k, b in first_blocks.items()} }")
    return first_blocks


# ------------------------------------------------------ the scan on a mesh


def _dma_launches(run):
    return {k: run["counts"][k]
            for k in ("gather_rows_dma", "scatter_rows_dma") + CULL_KERNELS}


def _check_mesh_launches(run, slabs, what):
    """One direct gather, one direct scatter, one cull and one compaction
    launch per slab per culled fusion of a frame (a rehearsal on the CPU
    counts none)."""
    calls = run["pipe"].fuse_culled_calls
    want = slabs * calls if DEVICE == "cuda" else 0
    for name, n in _dma_launches(run).items():
        check(n == want, f"{what}: {name} {n} launches, {slabs} slabs x "
                         f"{calls} culled fusions")


def mesh_scan(tmp, seq, short, single):
    """The scan on a device mesh through ReconstructionPipeline with a "mesh
    shape" and mesh_devices naming the one card MESH_SLABS times: the
    Z-slab logic, the summed-Gram tracker and the per-slab row-copy launches
    on the card (no peer copies: every slab is on the same card).
    (a) GT poses on a MESH_SLABS x 1 mesh: the volume of the one-device GT
    scan, bit for bit.  (b) Tracked, contiguous and interleaved: the frames
    of `single` (the one-device scan of the same `short` frames) converged
    and fused as there, ATE within MESH_ATE_MM of it; and the whole sequence
    on a 2 x 1 mesh against the main run.  (c) Every culled fusion launched
    each direct kernel once per slab.  (d) Frames/s of every run."""
    devs = [DEVICE] * MESH_SLABS
    mesh41 = {"z": MESH_SLABS, "frames": 1}
    gt_one = run_scan(tmp, "mesh_gt_one", seq, short - 1, "dma", gt_poses=True)
    gt_mesh = run_scan(tmp, "mesh_gt", seq, short - 1, "dma", gt_poses=True,
                       config={"mesh shape": mesh41}, mesh_devices=devs)
    check(gt_mesh["pipe"].mesh.slab_devices == [gt_mesh["pipe"].device] * MESH_SLABS,
          f"the mesh is not {MESH_SLABS} slabs on one card: {gt_mesh['pipe'].mesh}")
    check(_equal_volumes(gt_mesh["pipe"].vol, gt_one["pipe"].vol),
          "GT poses: the mesh volume differs from the one-device volume")
    check(gt_mesh["pose_text"] == gt_one["pose_text"], "GT poses: trajectories differ")
    _check_mesh_launches(gt_mesh, MESH_SLABS, "the GT mesh scan")
    launches = dict(_dma_launches(gt_mesh))

    one_facts = check_scan(single, seq, short)
    one_conv = [r["converged"] for r in single["summary"]["track_log"]]
    tracked = {}
    for tag, ms, n, ref, ref_facts in (
            ("contiguous", mesh41, short, single, one_facts),
            ("interleaved", dict(mesh41, interleave=True), short, single, one_facts),
            ("2x1_full", {"z": 2, "frames": 1}, FRAMES, None, None)):
        slabs = ms["z"]
        run = run_scan(tmp, "mesh_" + tag, seq, n - 1, "dma",
                       config={"mesh shape": ms}, mesh_devices=[DEVICE] * slabs)
        facts = check_scan(run, seq, n)
        _check_mesh_launches(run, slabs, f"the {tag} mesh scan")
        if ref is not None:
            # (a tracked frame is fused when it converged; the culled
            # fusions may differ by an overflow redo: the capacity is split
            # across the slabs, and contiguous slabs are skewed)
            conv = [r["converged"] for r in run["summary"]["track_log"]]
            check(conv == one_conv,
                  f"{tag}: converged {conv}, one device {one_conv}")
            check(abs(facts["ate_mm"] - ref_facts["ate_mm"]) <= MESH_ATE_MM,
                  f"{tag}: ATE {facts['ate_mm']:.4f} mm, one device "
                  f"{ref_facts['ate_mm']:.4f} mm")
        for k, v in _dma_launches(run).items():
            launches[k] += v
        # the summed-Gram tracker: one gn_gram launch a slab a GN step
        launches["gn_gram"] = launches.get("gn_gram", 0) + run["scan_counts"]["gn_gram"]
        tracked[tag] = dict(slabs=slabs, frames=n,
                            frames_per_s=run["summary"]["fps"],
                            overflow_redos=run["summary"]["overflow_redos"],
                            ate_mm=facts["ate_mm"],
                            mean_gn_iterations=facts["mean_gn_iterations"],
                            culled_fusions=run["pipe"].fuse_culled_calls,
                            launches=_dma_launches(run))
    return launches, dict(
        slabs_on_one_card=MESH_SLABS, frames=short,
        gt_bit_identical=True,
        gt_frames_per_s={"one_device": gt_one["summary"]["fps"],
                         "mesh": gt_mesh["summary"]["fps"]},
        one_device=dict(frames_per_s=single["summary"]["fps"],
                        ate_mm=one_facts["ate_mm"],
                        mean_gn_iterations=one_facts["mean_gn_iterations"]),
        tracked=tracked, ate_tolerance_mm=MESH_ATE_MM)


# ------------------------- the packed, K-batched and resident volume state


def _stream_setup(tmp, seq, n):
    """The main run's recipe (its config, its volume placement, its FALS
    cache) and the first n frames on the device as the scan preprocesses
    them -> dict: geom, cfg, truncation, the tracker's keywords, K, metric
    depths and colours, FALS normals, n_sq_inv, the frame cap and the culled
    fusion's row capacity ("fuse rows" of the rows)."""
    import torch
    from psgradientsdf_tpu_torch.config import load_config
    from psgradientsdf_tpu_torch.core.grid import GridGeometry
    from psgradientsdf_tpu_torch.ops.normals import build_fals_cache
    from psgradientsdf_tpu_torch.pipeline import compute_centroid
    from psgradientsdf_tpu_torch.tracking.stream import _preprocess, upload_frames

    K, colors, depths = seq[:3]
    path = os.path.join(tmp, "packed.json")
    write_config(path, os.path.join(tmp, "packed") + "/", n - 1)
    cfg = load_config(path)
    tr, tpu = cfg.tracking, cfg.tpu
    depth0 = depths[0].astype(np.float32) * np.float32(DEPTH_UNIT)
    geom = GridGeometry(dims=tuple(tpu.grid_dim), voxel_size=tr.voxel_size,
                        shift=tuple(float(v) for v in compute_centroid(
                            K, depth0, np.eye(4, dtype=np.float32))))
    fals = build_fals_cache(H, W, K, window=11, device=DEVICE)
    d, c, nrm, _ = _preprocess(
        upload_frames(np.stack(depths[:n]), DEVICE),
        upload_frames(np.stack(colors[:n]), DEVICE), fals, window=11,
        depth_unit=DEPTH_UNIT)
    zy = geom.dims[2] * geom.dims[1]
    return dict(
        geom=geom, truncation=cfg.truncation,
        zkw=dict(truncation=cfg.truncation, zmin=tr.zmin, zmax=tr.zmax),
        gn=dict(num_iterations=tr.num_iterations,
                conv_threshold_sq=tr.conv_threshold ** 2, damping=tr.damping,
                stride=tpu.track_stride, regather_every=tpu.track_regather,
                early_exit=not tpu.track_static),
        K=torch.as_tensor(K, dtype=torch.float32, device=DEVICE),
        depths=d, colors=c, normals=nrm, n_sq_inv=fals.n_sq_inv,
        frame_cap=-(-n // 32) * 32,
        cap=min(zy, max(256, -(-int(zy * tpu.fuse_rows) // 256) * 256)),
        gt=[torch.as_tensor(p, dtype=torch.float32, device=DEVICE)
            for p in seq[3][:n]])


def _frame(st, f):
    return (st["colors"][f], st["depths"][f], st["normals"][f], st["n_sq_inv"],
            st["K"])


def _fresh(st, layout, geom=None, truncation=None):
    from psgradientsdf_tpu_torch.core.volume import PackedVolume, make_volume

    vol = make_volume(geom or st["geom"], truncation or st["truncation"],
                      st["frame_cap"], device=DEVICE)
    return PackedVolume.from_volume(vol) if layout == "packed" else vol


def _fuse_fn(layout):
    from psgradientsdf_tpu_torch.core import volume as V

    return V.fuse_frame_culled_packed if layout == "packed" else V.fuse_frame_culled


def _on_card(n):
    """The launches a path makes: none on the CPU of a rehearsal, where the
    wrappers run their plain versions."""
    return n if DEVICE == "cuda" else 0


def _counted(fn):
    """Run fn with the launch counts set to 0 just before and read just
    after -> (fn's result, counts of the row copies, the cull and the
    compaction, wall seconds to the device's end)."""
    _sync()
    _reset_row_counts()
    t0 = time.perf_counter()
    with _plain_cull_calls() as cull_calls:
        out = fn()
    _sync()
    counts = _row_counts()
    check(cull_calls["plain_cull_on_card"] == 0,
          f"{cull_calls['plain_cull_on_card']} plain culls or compactions ran on the card")
    return out, counts, time.perf_counter() - t0


def _tracked_loop(st, n, layout, rows_impl):
    """Frame 0 at the identity, then track_frame + culled fusion (gated by
    convergence, in place) for frames 1..n-1, on the SoA or the packed
    layout -> (volume, poses [n,4,4] numpy, converged, any overflow)."""
    import torch
    from psgradientsdf_tpu_torch.tracking.tracker import track_frame

    fuse = _fuse_fn(layout)
    kw = dict(row_capacity=st["cap"], rows_impl=rows_impl, inplace=True,
              device=DEVICE, **st["zkw"])
    vol = _fresh(st, layout)
    pose = torch.eye(4, dtype=torch.float32, device=DEVICE)
    vol, ov = fuse(vol, st["geom"], *_frame(st, 0), pose, 0, **kw)
    poses, conv, flags = [pose], [], [ov]
    for f in range(1, n):
        res = track_frame(vol, st["geom"], st["depths"][f], st["K"], pose,
                          device=DEVICE, **st["zkw"], **st["gn"])
        pose = res.pose
        vol, ov = fuse(vol, st["geom"], *_frame(st, f), pose, f, res.converged,
                       **kw)
        poses.append(pose)
        conv.append(res.converged)
        flags.append(ov)
    return (vol, torch.stack(poses).cpu().numpy(),
            bool(torch.stack(conv).all()), bool(torch.stack(flags).any()))


def _gt_loop(st, frames, layout, cap, geom=None, truncation=None):
    """Culled fusion frame after frame at the ground-truth poses."""
    fuse = _fuse_fn(layout)
    vol = _fresh(st, layout, geom, truncation)
    flags = []
    for f in frames:
        vol, ov = fuse(vol, geom or st["geom"], *_frame(st, f), st["gt"][f], f,
                       row_capacity=cap, inplace=True, device=DEVICE,
                       **dict(st["zkw"], truncation=truncation or st["truncation"]))
        flags.append(bool(ov))
    check(not any(flags), f"{layout} GT fusion overflowed its capacity {cap}")
    return vol


def _turns(tags):
    """Each path twice, in turns: A B C C B A."""
    return tags + tags[::-1]


def _batches(first, last, k):
    return [list(range(s, min(s + k, last + 1))) for s in range(first, last + 1, k)]


def _union_rows(st, frames, geom=None, truncation=None, margins=(0.0, 0.0)):
    """The number of rows in the union of the frames' culls at their
    ground-truth poses (one host read): the capacity a batch needs."""
    import torch
    from psgradientsdf_tpu_torch.core.volume import _row_activity

    act = None
    for f in frames:
        a = _row_activity(geom or st["geom"], st["depths"][f], st["K"],
                          st["gt"][f],
                          **dict(st["zkw"], truncation=truncation or st["truncation"]),
                          margin_px=margins[0], margin_t=margins[1])
        act = a if act is None else act | a
    return int(torch.sum(act))


def _batched_gt(st, batches, cap, geom=None, truncation=None):
    """Frame 0 alone, as the pipeline fuses it when it places the volume,
    then fuse_frames_culled on each batch."""
    import torch
    from psgradientsdf_tpu_torch.core.volume import fuse_frames_culled

    geom, truncation = geom or st["geom"], truncation or st["truncation"]
    zkw = dict(st["zkw"], truncation=truncation)
    vol = _gt_loop(st, [0], "soa", cap, geom, truncation) if batches[0][0] else \
        _fresh(st, "soa", geom, truncation)
    for b in batches:
        vol, flag = fuse_frames_culled(
            vol, geom, st["colors"][b], st["depths"][b], st["normals"][b],
            st["n_sq_inv"].expand(len(b), -1, -1), st["K"],
            torch.stack([st["gt"][f] for f in b]), b, row_capacity=cap,
            inplace=True, device=DEVICE, **zkw)
        check(not bool(flag), f"batch {b[0]}..{b[-1]}: overflow or word span")
    return vol


def _packed_equal(pvol, vol):
    return _equal_volumes(pvol.to_volume(), vol)


def _row_kernel_times(st, geom, truncation, cap):
    """The direct and staged kernels on the 512^3 packed tables, with the
    index vector of frame 0's cull (duplicate-first padding, `live`), beside
    their byte bound -> dict.  Launches made here are not counted."""
    import torch
    from psgradientsdf_tpu_torch.core.volume import (
        _compact_padded, _row_activity)
    from psgradientsdf_tpu_torch.ops import rowcopy

    pvol = _fresh(st, "packed", geom, truncation)
    X, Y, Z = geom.dims
    tables = [pvol.payload.view(Z * Y, 8 * X), pvol.vis[0].view(Z * Y, X)]
    act = _row_activity(geom, st["depths"][0], st["K"], st["gt"][0],
                        **dict(st["zkw"], truncation=truncation))
    idx, live, _ = _compact_padded(act.reshape(-1), cap)
    rows = rowcopy.gather_tables_dma(tables, idx)
    distinct = int(live)
    row_bytes = 4 * 9 * X
    bound = {"gather": ((distinct + cap) * row_bytes + cap * 4) / HBM_BYTES_PER_S * 1e3,
             "scatter": (2 * distinct * row_bytes + cap * 4) / HBM_BYTES_PER_S * 1e3}
    flush = torch.empty(512 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    calls = {
        "gather_rows_dma": lambda: rowcopy.gather_tables_dma(tables, idx),
        "gather_rows": lambda: rowcopy.gather_tables(tables, idx),
        "scatter_rows_dma": lambda: rowcopy.scatter_tables_dma(
            tables, idx, rows, live=live),
        "scatter_rows": lambda: rowcopy.scatter_tables(tables, idx, rows, live=live),
    }
    out = {}
    for name, call in calls.items():
        kind = "gather" if name in GATHERS else "scatter"
        ms = _time_ms(call, flush)
        out[name] = dict(ms=ms, bound_ms=bound[kind], share_of_bound=bound[kind] / ms)
    return dict(tables=[f"R={8 * X} float32", f"R={X} int32"], slots=cap,
                live_rows=distinct, **out)


def packed_phase(tmp, seq):
    """The packed, K-batched and resident volume state of core/volume.py and
    core/resident.py, driven through their entry points on the card.
    (a) 128^3, the main sequence: a tracked loop of track_frame on a
    PackedVolume + fuse_frame_culled_packed against the same loop on the SoA
    volume with fuse_frame_culled: trajectory and volume bit for bit, and on
    the staged kernels too; one launch of each kernel a fused frame.
    (b) 128^3 at ground-truth poses: fuse_frames_culled, K = PACKED_K, after
    frame 0 alone, against 48 sequential culled fusions, bit for bit; one
    gather and one scatter launch a batch.  (c) 512^3 at ground-truth poses,
    PACKED_BIG_FRAMES frames: packed, SoA and batched bit for bit, ms a
    frame, peak memory, the row kernels on its tables beside their bound.
    (d) core/resident.py over RESIDENT_FRAMES frames in chunks of CHUNK: the
    fusion-only stream at ground-truth poses against the packed canonical
    stream (visibility exact, floats bit for bit), the tracked stream
    against (a)'s canonical trajectory (ATE within RESIDENT_ATE_MM), flags 0.
    -> (launches by kernel, facts)."""
    import torch
    from psgradientsdf_tpu_torch.core import resident as R
    from psgradientsdf_tpu_torch.core.grid import GridGeometry
    from psgradientsdf_tpu_torch.io.trajectory import ate_rmse

    launches = {k: 0 for k in list(KERNELS) + list(CULL_KERNELS)}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    st = _stream_setup(tmp, seq, FRAMES)
    n = FRAMES
    facts = {"row_capacity": st["cap"]}

    # (a) the tracked loop on both layouts, in turns (A B C C B A): each
    # path's ms a frame twice, the first runs held against each other and
    # every second run against its first
    loops = {}
    plans = {"soa": ("soa", "dma"), "packed": ("packed", "dma"),
             "packed_staged": ("packed", "staged")}
    for tag in _turns(list(plans)):
        layout, impl = plans[tag]
        out, counts, secs = _counted(lambda: _tracked_loop(st, n, layout, impl))
        vol, poses, conv, ov = out
        check(conv, f"{tag}: a frame did not converge")
        check(not ov, f"{tag}: a fusion overflowed its capacity {st['cap']}")
        name = "gather_rows_dma" if impl == "dma" else "gather_rows"
        scat = "scatter_rows_dma" if impl == "dma" else "scatter_rows"
        check(counts[name] == _on_card(n) == counts[scat]
              and sum(counts[k] for k in KERNELS) == _on_card(2 * n),
              f"{tag}: launches {counts}, one gather and one scatter a frame")
        check(counts["cull_compact"] == _on_card(n),
              f"{tag}: launches {counts}, one cull_compact a frame")
        add(counts)
        if tag in loops:
            check(np.array_equal(poses, loops[tag]["poses"])
                  and _equal_volumes(vol, loops[tag]["vol"]),
                  f"{tag}: the second run differs from the first")
            loops[tag]["ms"].append(secs * 1e3 / n)
            continue
        loops[tag] = dict(vol=vol, poses=poses, ms=[secs * 1e3 / n], counts=counts)
    soa = loops["soa"]
    for tag in ("packed", "packed_staged"):
        check(np.array_equal(loops[tag]["poses"], soa["poses"]),
              f"{tag}: the trajectory differs from the SoA loop's")
        check(_packed_equal(loops[tag]["vol"], soa["vol"]),
              f"{tag}: the volume differs from the SoA loop's")
    ate = ate_rmse(list(loops["packed"]["poses"]), seq[3][:n])
    check(ate < 0.5 * VOXEL, f"packed loop: ATE {ate * 1e3:.3f} mm")
    facts["tracked"] = dict(
        frames=n, bit_identical=True, ate_mm=ate * 1e3,
        ms_per_frame={k: v["ms"] for k, v in loops.items()},
        launches_per_run={k: v["counts"] for k, v in loops.items()})
    canonical_poses = loops["packed"]["poses"]
    loops.clear()

    # (b) K-batched fusion at ground-truth poses against sequential fusion,
    # in turns
    batches = _batches(1, n - 1, PACKED_K)
    cap_b = min(GRID * GRID, -(-max(_union_rows(st, b) for b in batches) // 256) * 256)
    runs = {"sequential": lambda: _gt_loop(st, range(n), "soa", st["cap"]),
            "batched": lambda: _batched_gt(st, batches, cap_b)}
    want = {"sequential": n, "batched": len(batches) + 1}
    vols, ms = {}, {k: [] for k in runs}
    for tag in _turns(list(runs)):
        vol, counts, secs = _counted(runs[tag])
        check(counts["gather_rows_dma"] == _on_card(want[tag])
              == counts["scatter_rows_dma"] == counts["cull_compact"],
              f"{tag}: launches {counts}, one gather, one scatter and one "
              f"cull_compact a {'batch' if tag == 'batched' else 'frame'}")
        add(counts)
        ms[tag].append(secs * 1e3 / n)
        check(_equal_volumes(vol, vols.setdefault(tag, vol)),
              f"{tag}: the second run differs from the first")
    check(_equal_volumes(vols["batched"], vols["sequential"]),
          "batched fusion != sequential fusion")
    facts["batched"] = dict(
        frames=n, k=PACKED_K, batches=len(batches), batch_capacity=cap_b,
        bit_identical=True, launches_per_run=want if DEVICE == "cuda" else 0,
        ms_per_frame=ms)
    vols.clear()

    # (c) 512^3 at ground-truth poses, in turns
    g = st["geom"]
    big = GridGeometry(dims=(PACKED_BIG_GRID,) * 3,
                       voxel_size=g.voxel_size * g.dims[0] / PACKED_BIG_GRID,
                       shift=g.shift)
    t_big = st["truncation"] * g.dims[0] / PACKED_BIG_GRID
    frames = list(range(PACKED_BIG_FRAMES))
    zy = PACKED_BIG_GRID ** 2
    cap_f = max(st["cap"] * zy // (GRID * GRID), -(-max(
        _union_rows(st, [f], big, t_big) for f in frames) // 1024) * 1024)
    cap_u = -(-_union_rows(st, frames, big, t_big) // 1024) * 1024
    big_facts = dict(grid=PACKED_BIG_GRID, frames=len(frames),
                     row_capacity=cap_f, batch_capacity=cap_u,
                     ms_per_frame={}, peak_gb={})
    runs = {"soa": lambda: _gt_loop(st, frames, "soa", cap_f, big, t_big),
            "packed": lambda: _gt_loop(st, frames, "packed", cap_f, big, t_big),
            "batched": lambda: _batched_gt(st, [frames], cap_u, big, t_big)}
    for tag in _turns(list(runs)):
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        vol, counts, secs = _counted(runs[tag])
        add(counts)
        want = _on_card(1 if tag == "batched" else len(frames))
        check(counts["gather_rows_dma"] == want == counts["scatter_rows_dma"]
              == counts["cull_compact"],
              f"512^3 {tag}: launches {counts}")
        big_facts["ms_per_frame"].setdefault(tag, []).append(secs * 1e3 / len(frames))
        if tag in vols:
            check(_equal_volumes(vol, vols[tag]),
                  f"512^3 {tag}: the second run differs from the first")
            continue
        vols[tag] = vol
        if DEVICE == "cuda":
            # the path's own peak: its volume and its temporaries, above what
            # the earlier paths' volumes hold
            big_facts["peak_gb"][tag] = (torch.cuda.max_memory_allocated() - held) / 1e9
        del vol
    check(_packed_equal(vols["packed"], vols["soa"]), "512^3: packed != SoA")
    check(_equal_volumes(vols["batched"], vols["soa"]), "512^3: batched != SoA")
    big_facts["bit_identical"] = True
    big_facts["observed_voxels"] = int((vols["soa"].weight > 0).sum())
    vols.clear()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        big_facts["row_kernels"] = _row_kernel_times(st, big, t_big, cap_f)
        torch.cuda.empty_cache()
    facts["big"] = big_facts

    # (d) the resident state, RESIDENT_FRAMES frames in chunks of CHUNK
    m = RESIDENT_FRAMES
    chunks = _batches(1, m - 1, CHUNK)
    nseg = GRID * GRID
    capr = min(nseg, -(-int(1.1 * max(_union_rows(st, c, margins=RESIDENT_MARGIN)
                                      for c in chunks)) // 1024) * 1024)
    delta = nseg // 4
    zkw = st["zkw"]

    def resident_stream(tracked):
        pvol, _ = _fuse_fn("packed")(
            _fresh(st, "packed"), st["geom"], *_frame(st, 0),
            st["gt"][0] if not tracked else torch.eye(4, device=DEVICE), 0,
            row_capacity=st["cap"], inplace=True, device=DEVICE, **zkw)
        pose = torch.eye(4, dtype=torch.float32, device=DEVICE)
        poses, flags, misses = [pose], [], []
        rkw = dict(inplace=True, device=DEVICE, **zkw)

        def body():
            nonlocal pvol, pose
            for c in chunks:
                p0 = pose if tracked else st["gt"][c[0]]
                res = R.resident_refresh(
                    pvol, st["geom"], st["depths"][c[0]], st["K"], p0,
                    capacity=capr, margin_px=RESIDENT_MARGIN[0],
                    margin_t=RESIDENT_MARGIN[1], device=DEVICE, **zkw)
                for f in c:
                    gate = None
                    if tracked:
                        res = R.resident_alloc(
                            res, pvol, st["geom"], st["depths"][f], st["K"], pose,
                            delta_capacity=delta, margin_px=RESIDENT_MARGIN[0],
                            margin_t=RESIDENT_MARGIN[1], **rkw)
                        tr, miss = R.track_frame_resident(
                            res, st["geom"], st["depths"][f], st["K"], pose,
                            device=DEVICE, **zkw, **st["gn"])
                        pose, gate = tr.pose, tr.converged
                        misses.append(miss)
                        poses.append(pose)
                    else:
                        pose = st["gt"][f]
                    res = R.resident_alloc(res, pvol, st["geom"], st["depths"][f],
                                           st["K"], pose, delta_capacity=delta,
                                           **rkw)
                    res = R.fuse_frame_resident(res, st["geom"], *_frame(st, f),
                                                pose, f, gate, **rkw)
                flags.append(res.flags)
                pvol = R.resident_flush(res, pvol, inplace=True)
            return pvol

        _, counts, secs = _counted(body)
        flag = int(torch.stack(flags).max())
        miss = bool(torch.stack(misses).any()) if misses else False
        return (pvol, np.stack([p.cpu().numpy() for p in poses]), flag, miss,
                counts, secs * 1e3 / (m - 1))

    canon = _gt_loop(st, range(m), "packed", st["cap"])
    fused, _, flag, _, counts, ms_fuse = resident_stream(tracked=False)
    check(flag == 0, f"resident GT stream: flags {flag}")
    check(torch.equal(fused.vis, canon.vis), "resident GT stream: vis differs")
    diff = float((fused.payload - canon.payload).abs().max())
    check(torch.equal(fused.payload, canon.payload),
          f"resident GT stream: payload differs by up to {diff}")
    allocs = _on_card(len(chunks) + (m - 1))
    check(counts["gather_rows_dma"] == allocs == counts["scatter_rows_dma"],
          f"resident GT stream: launches {counts}, {allocs} expected")
    # a cull_compact for each refresh and allocation (allow: the rows with
    # no slot), and one a fusion (its mask)
    check(counts["cull_compact"] == _on_card(len(chunks) + 2 * (m - 1)),
          f"resident GT stream: launches {counts}")
    add(counts)
    _, poses, flag, miss, counts_t, ms_track = resident_stream(tracked=True)
    check(flag == 0 and not miss, f"resident tracked stream: flags {flag}, miss {miss}")
    allocs = _on_card(len(chunks) + 2 * (m - 1))
    check(counts_t["gather_rows_dma"] == allocs == counts_t["scatter_rows_dma"],
          f"resident tracked stream: launches {counts_t}, {allocs} expected")
    check(counts_t["cull_compact"] == _on_card(len(chunks) + 3 * (m - 1)),
          f"resident tracked stream: launches {counts_t}")
    ate_res = ate_rmse(list(poses), seq[3][:m])
    ate_can = ate_rmse(list(canonical_poses[:m]), seq[3][:m])
    check(abs(ate_res - ate_can) * 1e3 <= RESIDENT_ATE_MM,
          f"resident tracked ATE {ate_res * 1e3:.4f} mm, canonical "
          f"{ate_can * 1e3:.4f} mm")
    add(counts_t)
    facts["resident"] = dict(
        frames=m, chunk=CHUNK, capacity=capr, delta_capacity=delta,
        margins=RESIDENT_MARGIN, flags=0, vis_exact=True,
        payload_max_abs_diff=diff, launches={"gt": counts, "tracked": counts_t},
        ate_mm={"resident": ate_res * 1e3, "canonical": ate_can * 1e3},
        poses_bit_identical=bool(np.array_equal(poses, canonical_poses[:m])),
        ms_per_frame={"gt_fusion": ms_fuse, "tracked": ms_track,
                      "canonical_tracked": facts["tracked"]["ms_per_frame"]["packed"]})
    return launches, facts


# --------------------------------------------- files, checkpoints, retries


def _equal_volumes(a, b):
    import torch

    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def _check_dma_launches(counts, calls, what):
    """One direct gather, one direct scatter, one cull and one compaction
    launch per culled fusion (on the CPU of a rehearsal the wrappers run
    their plain versions and count nothing)."""
    want = calls if DEVICE == "cuda" else 0
    for name in ("gather_rows_dma", "scatter_rows_dma") + CULL_KERNELS:
        check(counts[name] == want,
              f"{what}: {name} {counts[name]} launches, {calls} culled fusions")


def dataset_files(tmp, seq, n_frames, mem_run):
    """The sequence written as a TUM RGB-D directory of PNG files, read back
    by the package's loader (PNG decode: zlib + the C++ row unfilter) and
    scanned from the files -> the directory, and what was measured.  The
    decoded frames must equal the arrays bit for bit, and the scan of the
    first `n_frames` frames must equal `mem_run`, the scan of the same frames
    from memory: pose text and every volume tensor."""
    from psgradientsdf_tpu_torch.io.loaders import make_loader
    from psgradientsdf_tpu_torch.io.prefetch import PrefetchLoader

    K, colors, depths = seq[:3]
    root = os.path.join(tmp, "tum")
    t0 = time.perf_counter()
    write_tum_dataset(root, K, colors, depths)
    t_write = time.perf_counter() - t0
    png_bytes = sum(os.path.getsize(os.path.join(root, d, f))
                    for d in ("rgb", "depth") for f in os.listdir(os.path.join(root, d)))
    base = make_loader("tum", root)
    check(base.load_intrinsics() and np.array_equal(base.K, np.asarray(K, np.float32)),
          "intrinsics.txt does not read back")
    # one thread, one frame after another: the decode cost of a frame
    t0 = time.perf_counter()
    for i in range(len(colors)):
        c, d, _, ts = base.read_frame(i, raw=True)
        check(np.array_equal(c, colors[i]) and c.dtype == np.uint8
              and np.array_equal(d, depths[i]) and d.dtype == np.uint16
              and ts == _stamp(i), f"frame {i} does not decode to its arrays")
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(colors)
    # the decode-ahead loader the pipeline puts in front of it
    pf = PrefetchLoader(make_loader("tum", root), raw=True)
    t0 = time.perf_counter()
    for i in range(len(colors)):
        c, d = pf.load_next()
        check(np.array_equal(c, colors[i]) and np.array_equal(d, depths[i]),
              f"frame {i} differs through the decode-ahead loader")
    check(pf.load_next() is None, "the decode-ahead loader ran past the end")
    prefetch_ms = (time.perf_counter() - t0) * 1e3 / len(colors)
    pf.close()

    run = run_scan(tmp, "files", seq, n_frames - 1, "dma",
                   loader=make_loader("tum", root))
    check(run["pose_text"] == mem_run["pose_text"],
          "the scan from files: poses differ from the scan from memory")
    check(_equal_volumes(run["pipe"].vol, mem_run["pipe"].vol),
          "the scan from files: the volume differs from the scan from memory")
    calls = run["pipe"].fuse_culled_calls
    _check_dma_launches(run["counts"], calls, "the scan from files")
    return root, dict(
        frames=len(colors), image=[W, H], png_megabytes=png_bytes / 1e6,
        raw_megabytes=sum(c.nbytes + d.nbytes for c, d in zip(colors, depths)) / 1e6,
        write_seconds=t_write, host_decode_ms_per_frame=decode_ms,
        host_prefetch_ms_per_frame=prefetch_ms, scanned_frames=n_frames,
        scan_frames_per_s=run["summary"]["fps"], launches=run["counts"],
        culled_fusions=calls)


def resume_scan(tmp, seq, n_frames, full_run):
    """The scan of `n_frames` frames stopped at frame CHUNK with a checkpoint
    every CHUNK frames, then resumed from its checkpoint to the end: the pose
    text and every volume tensor must equal the uninterrupted `full_run`, and
    the resumed part must go through the dma kernels once per culled fusion
    of its own."""
    a = run_scan(tmp, "resume_a", seq, CHUNK, "dma", checkpoint_every=CHUNK)
    path = os.path.join(a["out_dir"], "scan_checkpoint.npz")
    saved = [e for e in a["events"] if e["event"] == "checkpoint"]
    check(os.path.exists(path) and len(saved) == 1,
          f"the stopped scan wrote {len(saved)} checkpoints")
    b = run_scan(tmp, "resume_b", seq, n_frames - 1, "dma", resume=path)
    resumed = [e for e in b["events"] if e["event"] == "resume"]
    check(len(resumed) == 1 and resumed[0]["next_frame"] == CHUNK + 1,
          f"resume events {resumed}")
    check(b["pose_text"] == full_run["pose_text"],
          "the resumed scan's poses differ from the uninterrupted scan")
    check(_equal_volumes(b["pipe"].vol, full_run["pipe"].vol),
          "the resumed scan's volume differs from the uninterrupted scan")
    calls = b["pipe"].fuse_culled_calls
    check(calls >= n_frames - CHUNK - 1, f"{calls} culled fusions after the resume")
    _check_dma_launches(b["counts"], calls, "the resumed scan")
    return dict(frames=n_frames, stopped_after_frame=CHUNK,
                resumed_from_frame=CHUNK + 1, culled_fusions=calls,
                launches=b["counts"], checkpoint_seconds=saved[0]["seconds"],
                checkpoint_bytes=saved[0]["bytes"],
                resume_wall_seconds=b["seconds"])


def resume_refine(tmp, root, main_run):
    """The command line on the PNG directory of dataset_files with
    --checkpoint-every 2 --retries 1, and one failure injected from outside in
    refinement iteration FAIL_ITERATION (the module function that runs an iteration is
    wrapped; the package has no switch for it).  The retry must resume from
    refine_checkpoint.npz without scanning again and end as the
    uninterrupted main run did: same stop reason, same iteration count,
    energies within PARITY_TOL["energy"] (the card's atomic scatter-adds
    make two runs differ in the fifth digit)."""
    from psgradientsdf_tpu_torch import cli
    from psgradientsdf_tpu_torch.io.sdf_io import read_sdf
    from psgradientsdf_tpu_torch.io.trajectory import read_trajectory
    from psgradientsdf_tpu_torch.refine import optimizer as opt_mod

    out = os.path.join(tmp, "cli") + "/"
    cfg_path = os.path.join(tmp, "cli.json")
    write_config(cfg_path, out, FRAMES - 1, refine=REFINE_SH1, input_dir=root + "/")
    summary_path = os.path.join(tmp, "cli_summary.json")
    # the fused loop's step (a graph replay on the card, the eager
    # iteration elsewhere) runs once an iteration
    real, calls = opt_mod._fused_step, {"n": 0}

    def failing_once(*args, **kw):
        calls["n"] += 1
        if calls["n"] == FAIL_ITERATION + 1:
            raise RuntimeError(
                f"injected failure in refinement iteration {FAIL_ITERATION}")
        return real(*args, **kw)

    backoff = os.environ.get("PSGSDF_RETRY_BACKOFF")
    os.environ["PSGSDF_RETRY_BACKOFF"] = "0"
    opt_mod._fused_step = failing_once
    t0 = time.perf_counter()
    try:
        # the command line's own output (metrics echo, summary) to a file
        with open(os.path.join(tmp, "cli_stdout.txt"), "w") as fh, \
                contextlib.redirect_stdout(fh), _slice_calls() as tail_calls:
            rc = cli.main(["--config_file", cfg_path, "--checkpoint-every", "2",
                           "--retries", "1", "--summary-json", summary_path,
                           "--platform", "cpu" if DEVICE == "cpu" else "gpu"])
    finally:
        opt_mod._fused_step = real
        if backoff is None:
            del os.environ["PSGSDF_RETRY_BACKOFF"]
        else:
            os.environ["PSGSDF_RETRY_BACKOFF"] = backoff
    wall = time.perf_counter() - t0
    check(rc == 0, f"the command line returned {rc}")
    check(calls["n"] > FAIL_ITERATION + 1, "the refinement did not reach the "
          f"iteration of the injected failure ({calls['n']} iterations run)")
    # every iteration but the failed one ran its distance block on the card
    tail = _one_card_tail(tail_calls, calls["n"] - 1, "resume_refine")
    with open(summary_path) as fh:
        summary = json.load(fh)
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    resumes = [e for e in events if e["event"] == "resume"]
    check(len(resumes) == 1 and resumes[0].get("phase") == "refine"
          and resumes[0]["iter"] == 2
          and resumes[0]["path"].endswith("refine_checkpoint.npz"),
          f"resume events {resumes}")
    check([e["event"] for e in events].count("scan_done") == 1,
          "the retry scanned again")
    with open(os.path.join(out, "tracking_poses.txt")) as fh:
        check(fh.read() == main_run["pose_text"],
              "the scan from files differs from the main run's scan from memory")
    want = main_run["summary"]
    check(summary["refine_stop"] == want["refine_stop"]
          and summary["refine_iterations"] == want["refine_iterations"],
          f"stopped {summary['refine_stop']} after {summary['refine_iterations']}"
          f", the main run {want['refine_stop']} after {want['refine_iterations']}")
    got_trace = summary["refine_energy_trace"]
    want_trace = main_run["pipe"].refiner.energy_trace
    check(len(got_trace) == len(want_trace), "energy trace length")
    worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                for g, w in zip(got_trace, want_trace) for k in ("total", "ps"))
    check(worst <= PARITY_TOL["energy"],
          f"energies differ from the main run by {worst:.3g} (relative)")
    mesh = _ply_counts(os.path.join(out, "final_refined_mesh.ply"))
    cloud = _ply_counts(os.path.join(out, "final_refined_pointcloud.ply"))
    check(mesh[0] > 1000 and mesh[1] > 1000 and cloud[0] > 1000,
          f"refined exports {mesh} {cloud}")
    _, poses = read_trajectory(os.path.join(out, "final_refined_poses.txt"))
    sdf, _, _ = read_sdf(os.path.join(out, "final_refined_sdf.sdf"))
    check(len(poses) == len(main_run["pipe"].refiner.keyframe_indices),
          "final_refined_poses.txt: one pose per keyframe")
    check(sdf.size > 1000 and np.isfinite(sdf).all(), "final_refined_sdf.sdf")
    scan_ckpt = [e for e in events if e["event"] == "checkpoint"]
    ref_ckpt = [e for e in events if e["event"] == "refine_checkpoint"]
    return dict(
        wall_seconds=wall, iterations=summary["refine_iterations"],
        stopped=summary["refine_stop"], resumed_at_iteration=resumes[0]["iter"],
        max_relative_energy_difference=worst, tolerance=PARITY_TOL["energy"],
        scan_checkpoints=[dict(frame=e["frame"], seconds=e["seconds"],
                               bytes=e["bytes"]) for e in scan_ckpt],
        refine_checkpoints=[dict(iteration=e["iter"], seconds=e["seconds"],
                                 bytes=e["bytes"]) for e in ref_ckpt],
        refined_mesh=list(mesh), distance_tail=tail)


def dumps(ref, truncation, main_run):
    """The host's export runtime: marching cubes over the main run's refined
    128^3 volume and over its 256^3 upsample, the C++ core against the numpy
    path (same vertex and face counts), the PLY writers C++ against Python
    (same bytes), the SDF writer; with the main run's own dump seconds, and
    a periodic refinement dump synchronous and on its writer thread (the
    seconds the loop's thread spends; the same bytes)."""
    from psgradientsdf_tpu_torch.io import ply, sdf_io
    from psgradientsdf_tpu_torch.ops.marching_cubes import extract_mesh_from_volume
    from psgradientsdf_tpu_torch.refine.upsample import upsample_volume

    up, geom2, _ = upsample_volume(ref.vol, ref.geom, ref.keyframe_indices, truncation)
    _sync()
    out, mesh128 = {}, None
    for size, vol, geom in ((GRID, ref.vol, ref.geom), (2 * GRID, up, geom2)):
        host = [t.cpu().numpy() for t in (vol.dist, vol.weight, vol.color)]
        row = {}
        for path in ("native", "numpy"):
            t0 = time.perf_counter()
            mesh = extract_mesh_from_volume(*host, geom.voxel_size, geom.origin,
                                            use_native=path == "native")
            row[path] = dict(seconds=time.perf_counter() - t0,
                             vertices=len(mesh.vertices), faces=len(mesh.faces))
            if size == GRID and path == "native":
                mesh128 = mesh
        check(row["native"]["vertices"] == row["numpy"]["vertices"]
              and row["native"]["faces"] == row["numpy"]["faces"],
              f"marching cubes at {size}^3: native {row['native']}, numpy {row['numpy']}")
        out[f"marching_cubes_{size}"] = row
    writes = {}
    for path in ("native", "python"):
        name = os.path.join(main_run["out_dir"], f"dump_{path}.ply")
        t0 = time.perf_counter()
        check(ply.write_mesh_ply(name, mesh128.vertices, mesh128.faces,
                                 mesh128.colors, use_native=path == "native"),
              f"the {path} PLY writer failed")
        writes[path] = dict(seconds=time.perf_counter() - t0, path=name)
    with open(writes["native"]["path"], "rb") as a, open(writes["python"]["path"], "rb") as b:
        check(a.read() == b.read(), "the PLY writers differ")
    out["ply_write_mesh_seconds"] = {k: v["seconds"] for k, v in writes.items()}
    # the SDF writer (text, np.savetxt: Python holds the interpreter lock)
    # on the refined volume's surface band, as the exports write it
    dist = ref.vol.dist.cpu().numpy()
    z, y, x = np.nonzero(np.abs(dist) <= np.sqrt(3.0) * ref.geom.voxel_size)
    box = dist[z.min():z.max() + 1, y.min():y.max() + 1, x.min():x.max() + 1]
    t0 = time.perf_counter()
    check(sdf_io.write_sdf(os.path.join(main_run["out_dir"], "dump.sdf"), box,
                           (0.0, 0.0, 0.0), ref.geom.voxel_size), "write_sdf failed")
    out["sdf_write"] = dict(seconds=time.perf_counter() - t0, values=int(box.size))
    out["main_run_artifact_dump_seconds"] = [
        dict(tag=e["tag"], seconds=e["seconds"],
             asynchronous=e.get("asynchronous", False))
        for e in main_run["events"] if e["event"] == "artifact_dump"]
    # a periodic dump as the loop makes it (handed to a writer thread)
    # against the synchronous one: the seconds the loop thread spends
    save_path = ref.save_path
    ref.save_path = main_run["out_dir"]
    try:
        t0 = time.perf_counter()
        ref._save_artifacts("smoke_sync")
        t_sync = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref._save_artifacts("smoke_async", asynchronous=True)
        t_loop = time.perf_counter() - t0
        ref._join_dump()
        t_joined = time.perf_counter() - t0
    finally:
        ref.save_path = save_path
    for kind in ("mesh", "pointcloud"):
        with open(os.path.join(main_run["out_dir"], f"smoke_sync_{kind}.ply"), "rb") as a, \
                open(os.path.join(main_run["out_dir"], f"smoke_async_{kind}.ply"), "rb") as b:
            check(a.read() == b.read(), f"the asynchronous dump's {kind} differs")
    out["periodic_dump_loop_seconds"] = {
        "synchronous": t_sync, "asynchronous": t_loop,
        "asynchronous_until_joined": t_joined}
    return out


def profile_refine(ref):
    """Trace two warm refinement iterations from the state the main run
    ended in -> the card's busy share of them, device operations (kernels,
    copies, fills), device time and the host's CUDA runtime calls per
    iteration, the operations by device time and the GEMM kernels (the
    normal equations run none: their blocks call their kernel once each, one
    launch a call, and no plain normal equations run on the card), and the
    index_add_ kernels (each albedo block launches its one kernel and
    none)."""
    import torch

    _one_iteration(ref)                       # warm
    torch.cuda.synchronize()
    with _refine_calls() as calls, _traced() as prof, _slice_calls() as energies:
        t0 = time.perf_counter()
        for _ in range(2):
            _one_iteration(ref)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    led = ref.cfg.model == "LED"
    for name in list(NORMAL_EQ_KERNELS) + list(ALBEDO_KERNELS):
        want = 0 if led and name == "light_normal_eqs_sh" else 2
        check(calls[name] == want, f"{name}: {calls[name]} calls in two iterations")
    check(calls["plain_normal_eqs_on_card"] == 0 and calls["plain_albedo_solve_on_card"] == 0,
          "plain normal equations or albedo solves ran on the card in the traced iterations")
    rows = sorted(_kernel_rows(prof), reverse=True)
    # a distance block launches no standalone reg_operators_kernel or
    # dist_update_kernel (its tail is a stage of dist_system and dist_cg),
    # an LED light block ONE light_led_kernel
    tail = {}
    check(energies["distance_step_calls"] == 2,
          f"{energies['distance_step_calls']} fused distance steps in two iterations")
    for name, kernel, want in (("reg_operators", "reg_operators_kernel", 0),
                               ("dist_update", "dist_update_kernel", 0),
                               ("light_normal_eqs_led", "light_led_kernel", 2 * led)):
        tail[kernel] = int(sum(r[1] for r in rows if kernel in r[2]))
        check(tail[kernel] == energies[name] == want,
              f"{kernel}: {tail[kernel]} launches, {energies[name]} counted, {want} blocks")
    check(energies["plain_dist_tail_on_card"] == 0 and energies["plain_led_light_on_card"] == 0,
          "a plain distance tail or LED light chain ran in the traced iterations")
    # a pose or SH light block launches ONE normal-equation kernel, an
    # albedo block ONE albedo_block_kernel
    for name, kernel in (("pose_normal_eqs", "pose_tiles_kernel"),
                         ("light_normal_eqs_sh", "light_tiles_kernel"),
                         ("albedo_block", "albedo_block_kernel")):
        launched = sum(r[1] for r in rows if kernel in r[2])
        check(launched == calls[name],
              f"{kernel}: {launched} launches for {calls[name]} {name} calls")
    check(not any("normaleq_reduce_kernel" in r[2] for r in rows),
          "a normaleq_reduce_kernel ran in the traced iterations")
    # an SH light block's eigen-solve is ONE light_solve_kernel, and no
    # cuSOLVER eigen-solver kernel runs
    launched = int(sum(r[1] for r in rows if "light_solve_kernel" in r[2]))
    check(launched == calls["light_solve"] == (0 if led else 2),
          f"light_solve_kernel: {launched} launches, {calls['light_solve']} calls")
    check(not any("syev" in r[2].lower() for r in rows),
          "a cuSOLVER eigen-solver kernel ran in the traced iterations")
    # an energy evaluation is ONE energy_sums_kernel launch
    launched = int(sum(r[1] for r in rows if "energy_sums_kernel" in r[2]))
    check(launched == energies["energy_calls"] == energies["energy_sums"] > 0
          and energies["plain_energy_on_card"] == 0,
          f"energy_sums_kernel: {launched} launches for {energies['energy_calls']} "
          "energy evaluations")
    runtime = _runtime_calls(prof)
    busy = sum(r[0] for r in rows) * 1e-6
    check(busy > 0.0, "the profiler saw no device time")
    check(not any("gemmSN" in r[2] for r in rows),
          "a cuBLAS gemmSN kernel ran in the traced iterations")
    return dict(
        model=ref.cfg.model, surface_voxels=ref.prob.n_surface,
        iterations=2, traced_wall_seconds=wall, device_busy_seconds=busy,
        warmup_dropped=prof.warmup_dropped, tail_kernels=tail,
        # a report, not a limit: a warm SH1 iteration before the distance
        # tail's and the LED light's kernels (commit 87b6a9e on an H100),
        # and with the tail's two standalone launches (517c0dd)
        parent_sh1_per_iteration=dict(device_ops=165, runtime_calls=197),
        tail_launches_sh1_per_iteration=dict(device_ops=127, runtime_calls=159),
        index_add_kernels=int(sum(r[1] for r in rows if _is_index_add(r[2]))),
        energy_evaluations=energies["energy_calls"],
        torch_reduce_kernels=int(sum(r[1] for r in rows if "reduce_kernel" in r[2])),
        device_busy_share=busy / wall,
        device_ops_per_iteration=int(sum(r[1] for r in rows)) // 2,
        device_ms_per_iteration=busy * 1e3 / 2,
        runtime_calls_per_iteration=int(runtime) // 2,
        gemm=[dict(name=k[:80], launches=c, device_ms=us * 1e-3)
              for us, c, k in rows if "gemm" in k.lower()],
        top=[dict(name=k[:80], launches=c, device_ms=us * 1e-3)
             for us, c, k in rows[:10]])


def _is_eager_cull(name):
    """A kernel of the cull's or the compaction's eager chains: cumsum's
    scans or scatter_."""
    low = name.lower()
    return "scan" in low or "cumsum" in low or "scatter_gather" in low


def _device_us(e):
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def profile_scan(tmp, seq, frames, plain_seconds):
    """Trace one more scan of `frames` frames (kernels only, so the host is
    slowed as little as may be) -> the card's busy time in it, its share of
    the untraced run's `plain_seconds`, device operations and the host's
    CUDA runtime calls a frame, the kernels by device time, and the cull's
    and the compaction's kernels (one each a culled fusion, no kernel of
    their eager chains)."""
    with _traced() as prof:
        traced = run_scan(tmp, "traced", seq, frames - 1, "dma")

    rows = sorted(_kernel_rows(prof), reverse=True)
    runtime = _runtime_calls(prof)
    busy = sum(r[0] for r in rows) * 1e-6
    check(busy > 0.0, "the profiler saw no device time")
    # the cull and the compaction run as one launch each: no kernel of
    # their eager chains (cumsum's scans, scatter_) on the card
    eager = [(n, k[:80]) for _, n, k in rows if _is_eager_cull(k)]
    check(not eager, f"the traced scan ran the cull's eager chain: {eager}")
    calls = traced["pipe"].fuse_culled_calls
    cull = {k: int(sum(r[1] for r in rows if f"{k}_kernel" in r[2])) for k in CULL_KERNELS}
    check(all(v == calls for v in cull.values()),
          f"the traced scan's cull kernels {cull}, {calls} culled fusions")
    # a chunk's preprocessing is one launch of each kernel: no box filter's
    # reflect pad (the plain chain's first op) on the card
    sl = traced["slice"]
    pre = {k: int(sum(r[1] for r in rows if f"{k}_kernel" in r[2]))
           for k in ("fals_normals", "lapm")}
    pads = [(n, k[:80]) for _, n, k in rows if "reflection_pad" in k.lower()]
    check(not pads, f"the traced scan ran a box filter's reflect pad: {pads}")
    check(pre == {"fals_normals": sl["chunks"] + sl["frame_normals"], "lapm": sl["chunks"]},
          f"the traced scan's preprocessing kernels {pre}, {sl['chunks']} chunks")
    return dict(
        frames=frames, device_busy_seconds=busy, culled_fusions=calls,
        warmup_dropped=prof.warmup_dropped,
        cull_kernels=cull, eager_cull_kernels=0, preprocess_kernels=pre,
        chunks=sl["chunks"], reflect_pad_kernels=0,
        untraced_scan_seconds=plain_seconds,
        traced_scan_seconds=traced["summary"]["seconds"],
        device_busy_share=busy / plain_seconds,
        device_kernels=int(sum(r[1] for r in rows)),
        device_ops_per_frame=int(sum(r[1] for r in rows)) / frames,
        runtime_calls_per_frame=runtime / frames,
        top=[dict(name=k[:80], launches=c, device_ms=us * 1e-3)
             for us, c, k in rows[:12]])


def profile_cli(tmp, root, frames):
    """The command line with --profile over the first `frames` PNG files of
    `root`, the scan alone: its trace.json must hold some of the warm-up's
    kernels (utils/profiling.py) and one gn_solve launch for each frame the
    scan solved, so that the records the profiler drops at a session's
    start were the warm-up's."""
    from psgradientsdf_tpu_torch import cli
    from psgradientsdf_tpu_torch.utils import profiling

    out = os.path.join(tmp, "cli_profile") + "/"
    cfg_path = os.path.join(tmp, "cli_profile.json")
    trace_dir = os.path.join(tmp, "cli_trace")
    write_config(cfg_path, out, frames - 1, input_dir=root + "/")
    _reset_scan_counts()                     # just before the path is driven
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "cli_profile_stdout.txt"), "w") as fh, \
            contextlib.redirect_stdout(fh):
        rc = cli.main(["--config_file", cfg_path, "--no-refine", "--profile", trace_dir,
                       "--platform", "gpu"])
    wall = time.perf_counter() - t0
    counts = _scan_counts()                  # and read just after
    check(rc == 0, f"the command line with --profile returned {rc}")
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as fh:
        kernels = [e["name"] for e in json.load(fh)["traceEvents"]
                   if e.get("cat") == "kernel"]
    kept = sum(profiling.is_warmup(n) for n in kernels)
    solves = sum("gn_solve_kernel" in n for n in kernels)
    check(kept > 0, "the command line's trace lost every record of its warm-up")
    check(solves == counts["gn_solve"] == counts["frames_solved"] >= frames - 1,
          f"the command line's trace holds {solves} gn_solve launches, the scan "
          f"made {counts['gn_solve']} for {counts['frames_solved']} frames solved")
    return dict(frames=frames, wall_seconds=wall, warmup_kept=kept,
                warmup_dropped=profiling.WARMUP - kept, gn_solve_in_trace=solves,
                frames_solved=counts["frames_solved"], device_kernels=len(kernels),
                trace_bytes=os.path.getsize(path))


# ------------------------------------------------- the refinement on a mesh


def _digest(tensors):
    """sha256 of the tensors' bytes, in order: bit-for-bit equality across
    processes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _refiner_state(ref):
    """A refiner's result on the host: its stop, iterations, surface count,
    gathered state and energy trace."""
    _, dist, albedo, grad, _ = ref.gathered(False, False)
    return dict(stop=ref.stop_reason, iterations=ref.iterations_run,
                n_surface=ref.prob.n_surface, dist=dist.cpu(), albedo=albedo.cpu(),
                grad_stored=grad.cpu(), poses=ref.poses.cpu(), lights=ref.lights.cpu(),
                energy=[(r["total"], r["ps"]) for r in ref.energy_trace])


STATE_TENSORS = ("dist", "albedo", "grad_stored", "poses", "lights")


def _compare_states(got, want, what):
    """A mesh refinement's result (_refiner_state) against a one-device or
    one-process one: the same stop and iteration count, each state tensor
    within PARITY_TOL["state"] of its largest magnitude and every traced
    energy within PARITY_TOL["energy"] (both on the card: the sums run in
    another order on the mesh, and the scatter-adds are atomic)."""
    check(got["stop"] == want["stop"] and got["iterations"] == want["iterations"],
          f"{what}: stopped {got['stop']} after {got['iterations']}, the "
          f"reference {want['stop']} after {want['iterations']}")
    check(got["n_surface"] == want["n_surface"],
          f"{what}: surface count {got['n_surface']}, the reference "
          f"{want['n_surface']}")
    seen = {k: _rel(got[k], want[k]) for k in STATE_TENSORS}
    ge, we = got["energy"], want["energy"]
    check(len(ge) == len(we), f"{what}: energy trace {len(ge)} records, the "
                              f"reference {len(we)}")
    seen["energy"] = max(abs(a - b) / max(abs(b), 1e-12)
                         for ga, wa in zip(ge, we) for a, b in zip(ga, wa))
    bad = {k: v for k, v in seen.items() if not v <= PARITY_TOL[
        "energy" if k == "energy" else "state"]}
    check(not bad, f"{what}: disagrees with its reference beyond {PARITY_TOL}: {bad}")
    return seen


def _compare_refiners(got, want, what):
    return _compare_states(_refiner_state(got), _refiner_state(want), what)


def _check_sharded(ref, z, frames, what):
    """N in z row chunks, the keyframes in `frames` chunks where they divide
    (else whole, as the JAX package replicates them)."""
    lay = ref.prob.layout
    if len(ref.keyframe_indices) % frames:
        frames = 1
    check(len(ref.prob.rows) == len(ref.dist) == z
          and len(lay.frames) - 1 == frames
          and len(lay.block_devices) == z * frames,
          f"{what}: not refined on a {z}x{frames} mesh: rows {lay.rows}, "
          f"frames {lay.frames}")


def cli_mesh_run(tmp, root):
    """The command line with --mesh MESH_CLI over the PNG files in `root`,
    the whole recipe, on the one card MESH_CLI[0] x MESH_CLI[1] times; the
    pipeline keeps the digest of its scan's volume -> (the run, its wall
    seconds)."""
    import psgradientsdf_tpu_torch.pipeline as pipeline_mod
    from psgradientsdf_tpu_torch import cli

    out = os.path.join(tmp, "cli_mesh") + "/"
    cfg_path = os.path.join(tmp, "cli_mesh.json")
    write_config(cfg_path, out, FRAMES - 1, refine=REFINE_SH1, input_dir=root + "/")
    summary_path = os.path.join(tmp, "cli_mesh_summary.json")
    made = []
    real = pipeline_mod.ReconstructionPipeline

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def _run_refine_phase(self, summary):
            self.scan_digest = _digest(self.vol)
            super()._run_refine_phase(summary)

    pipeline_mod.ReconstructionPipeline = Recorded
    _reset_row_counts()                      # just before the path is driven
    t0 = time.perf_counter()
    try:
        with open(os.path.join(tmp, "cli_mesh_stdout.txt"), "w") as fh, \
                contextlib.redirect_stdout(fh), _slice_calls() as slice_calls:
            rc = cli.main([
                "--config_file", cfg_path, "--summary-json", summary_path,
                "--mesh", f"{MESH_CLI[0]}x{MESH_CLI[1]}",
                "--mesh-devices", ",".join([DEVICE] * (MESH_CLI[0] * MESH_CLI[1])),
                "--platform", "cpu" if DEVICE == "cpu" else "gpu"])
        _sync()
    finally:
        pipeline_mod.ReconstructionPipeline = real
    wall = time.perf_counter() - t0
    counts = _row_counts()                   # and read just after
    check(rc == 0 and len(made) == 1, f"the command line returned {rc}")
    slice_facts = _check_slice(slice_calls, "the command line on a mesh", made[0].refiner)
    with open(summary_path) as fh:
        summary = json.load(fh)
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        cli_events = [json.loads(line) for line in fh]
    cli_run = dict(pipe=made[0], summary=summary, counts=counts, out_dir=out,
                   events=cli_events, slice=slice_facts)
    return cli_run, wall


@contextlib.contextmanager
def _albedo_decisions():
    """While the body runs, record each one-device albedo block's (0, 1)
    acceptance, made in ops/albedo.albedo_block (the kernel's epilogue on
    the card, update_albedo's rule): its candidates rho - delta and its
    accept mask, on the device -> the list of (candidates, accepted).  Of a
    graphed loop: not its warm-up's, and each replay's, copied after it
    (refine/graph.after_replay)."""
    import torch
    from psgradientsdf_tpu_torch.ops import albedo as AL
    from psgradientsdf_tpu_torch.refine import graph

    real, seen = AL.albedo_block, []

    def recording(prob, rd, albedo, *a, **kw):
        delta, new = real(prob, rd, albedo, *a, **kw)
        if graph.warming():
            return delta, new
        cand = albedo - delta
        ok = (cand > 0.0) & (cand < 1.0) & prob.valid[:, None]
        if cand.is_cuda and torch.cuda.is_current_stream_capturing():
            graph.after_replay(lambda: seen.append((cand.clone(), ok.clone())))
        else:
            seen.append((cand, ok))
        return delta, new

    AL.albedo_block = recording
    try:
        yield seen
    finally:
        AL.albedo_block = real


@contextlib.contextmanager
def _replayed_albedo(decisions):
    """While the body runs, refine/solvers.update_albedo takes the recorded
    one-device decisions (_albedo_decisions) in place of its own: the mesh
    calls it once a row chunk in mesh order, so call after call walks the
    records' rows.  Each call counts the voxel-channels whose own decision
    differs from the record, and the largest distance of such a candidate
    from 0 or 1 on either run -> facts, filled as the body runs."""
    import torch
    from psgradientsdf_tpu_torch.refine import solvers

    real = solvers.update_albedo
    facts = dict(differing=[0] * len(decisions), worst_edge_distance=0.0)
    at = dict(block=0, offset=0)

    def edge(c):
        return torch.minimum(c.abs(), (c - 1.0).abs())

    def replay(prob, albedo, delta):
        check(at["block"] < len(decisions),
              "(a): the mesh ran more albedo blocks than the one-device run")
        cand1, ok1 = decisions[at["block"]]
        lo, n = at["offset"], prob.valid.shape[0]
        c1, o1 = cand1[lo:lo + n].to(albedo.device), ok1[lo:lo + n].to(albedo.device)
        cand = albedo - delta
        ok = (cand > 0.0) & (cand < 1.0) & prob.valid[:, None]
        diff = ok != o1
        n_diff = int(diff.sum())
        if n_diff:
            far = float(torch.maximum(edge(cand[diff]), edge(c1[diff])).max())
            facts["worst_edge_distance"] = max(facts["worst_edge_distance"], far)
        facts["differing"][at["block"]] += n_diff
        at["offset"] += n
        if at["offset"] >= cand1.shape[0]:
            check(at["offset"] == cand1.shape[0], "(a): the mesh's row chunks "
                  "do not tile the one-device run's rows")
            at["block"], at["offset"] = at["block"] + 1, 0
        return torch.where(o1, cand, albedo)

    solvers.update_albedo = replay
    try:
        yield facts
    finally:
        solvers.update_albedo = real
    facts["blocks_replayed"] = at["block"]
    check(at["block"] == len(decisions) and at["offset"] == 0,
          f"(a): {at['block']} albedo blocks replayed of {len(decisions)}")


def _held_first_pass(residuals, facts):
    """A mesh's residual pass (parallel/refine.compute_residuals) whose
    first call is also held against the one-device residual pass on the
    gathered inputs: every block's r, w, mask, p_cam, uv and g_img equal to
    the one-device pass's rows and frames, bit for bit (facts filled)."""
    from psgradientsdf_tpu_torch.ops import residual as RS
    from psgradientsdf_tpu_torch.parallel import shard

    def wrapped(sp, geom, dist, albedo, grad, poses, images, K, lights, **kw):
        mrd = residuals(sp, geom, dist, albedo, grad, poses, images, K, lights, **kw)
        if facts:
            return mrd
        dev = poses.device
        one = RS.residual_pass(
            shard.gather_problem(sp, dev), geom, shard.gather_rows(dist, dev),
            shard.gather_rows(albedo, dev), shard.gather_rows(grad, dev), poses,
            shard.gather_images(images, dev), K, lights, **kw)
        blocks = 0
        for k, row in enumerate(mrd.blocks):
            for j, b in enumerate(row):
                rows = slice(b.rows[0], b.rows[0] + b.prob.valid.shape[0])
                frames = slice(b.frames[0], b.frames[0] + b.poses.shape[0])
                for name, a, w in zip(one._fields, mrd.rd[k][j], one):
                    check(_bits_same(a, w[rows, frames].contiguous()),
                          f"(a): block [{k}][{j}]'s first residual pass differs "
                          f"from one device's in {name}, by up to "
                          f"{_abs_err(a, w[rows, frames])}")
                blocks += 1
        facts.update(bit_identical=True, blocks=blocks,
                     pairs=int(one.mask.numel()))
        return mrd

    return wrapped


def mesh_refine(tmp, seq, main_run, led_run, led_seq, root):
    """The refinement on a device mesh whose every entry is the one card.
    (a) The main run's scan again (its trajectory, bit for bit) and its
    keyframes, refined on a 4x2 mesh through PhotometricRefiner(mesh=...),
    against the main run's own one-device refinement.  (b) The LED run with
    the upsample (its GT-pose scan on the mesh is the one-device volume bit
    for bit) on a 4x2 mesh, against refine_led_upsample's run: the same
    surface count after the upsample.  (c) The command line with --mesh 2x2
    over the PNG files of dataset_files, the whole recipe: check_scan and
    check_refine, and each direct kernel launched once per slab per culled
    fusion -> (launches of (c), what was measured, (c)'s run).
    In (a) the albedo block takes the main run's own accept decisions
    (_replayed_albedo: a candidate at the reference's (0, 1) edge may be
    kept on one path and refused on the other), and the loop's first
    residual pass is held against one device's on the same rows, bit for
    bit (_held_first_pass)."""
    import torch
    from psgradientsdf_tpu_torch.parallel import mesh as pm
    from psgradientsdf_tpu_torch.pipeline import sample_keyframes
    from psgradientsdf_tpu_torch.refine.optimizer import PhotometricRefiner
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    z, nf = MESH_REFINE["z"], MESH_REFINE["frames"]
    devs = [DEVICE] * (z * nf)
    # (a)
    scan = run_scan(tmp, "mesh_refine_scan", seq, FRAMES - 1, "dma")
    check(scan["pose_text"] == main_run["pose_text"],
          "the scan again: its trajectory differs from the main run's")
    pipe, cfg = scan["pipe"], scan["pipe"].cfg
    opt = main_run["pipe"].cfg.optimizer            # REFINE_SH1
    kf, stamps, images, poses = sample_keyframes(
        pipe.key_indices, pipe.key_stamps, pipe.key_images_dev, pipe.key_poses,
        cfg.tpu.keyframe_cap)
    log = os.path.join(tmp, "mesh_refine.jsonl")
    metrics = MetricsLogger(log, echo=False)
    ref = PhotometricRefiner(pipe.vol, pipe.geom, opt, pipe.K,
                             truncation=cfg.truncation, metrics=metrics,
                             mesh=pm.make_mesh(z, nf, devices=devs))
    ref.set_keyframes(torch.stack(images), np.stack(poses), kf, stamps)
    t0 = time.perf_counter()
    ref.init()
    _sync()
    t_init = time.perf_counter() - t0
    first = {}
    ref.ops = ref.ops._replace(residuals=_held_first_pass(ref.ops.residuals, first))
    pm.reset_reduce_counts()
    t0 = time.perf_counter()
    with _replayed_albedo(main_run["albedo_decisions"]) as albedo, \
            _slice_calls() as slice_calls:
        ref.alternating_optimize(opt.opt_light, opt.opt_albedo, opt.opt_distance,
                                 opt.opt_pose)
        _sync()
    t_loop = time.perf_counter() - t0
    moved = dict(pm.reduce_counts)
    slice_a = _check_slice(slice_calls, "(a) SH1 4x2", ref)
    check(first.get("bit_identical"), "(a): the first residual pass was not held")
    channels = 3 * ref.prob.n_surface
    check(max(albedo["differing"]) <= ALBEDO_SHARE * channels,
          f"(a): {albedo['differing']} albedo decisions differ from one device's, "
          f"more than {ALBEDO_SHARE} of {channels} voxel-channels")
    check(albedo["worst_edge_distance"] <= ALBEDO_EDGE,
          f"(a): a differing albedo decision's candidate lies "
          f"{albedo['worst_edge_distance']:.3g} from 0 or 1 (limit {ALBEDO_EDGE})")
    metrics.close()
    with open(log) as fh:
        events = [json.loads(line) for line in fh]
    _check_sharded(ref, z, nf, "(a)")
    one = main_run["pipe"].refiner
    seen_a = _compare_refiners(ref, one, "(a) SH1 4x2")
    per_block, per_iter, cg = _block_times(events)
    it = max(ref.iterations_run, 1)
    facts_a = dict(
        mesh=[z, nf], devices=len(devs), keyframes=len(kf),
        surface_voxels=ref.prob.n_surface, capacity=ref.prob.capacity,
        iterations=ref.iterations_run, stopped=ref.stop_reason,
        relative_difference=seen_a, tolerance=PARITY_TOL,
        first_residual_pass=first, energy_launches=slice_a,
        albedo_decisions=dict(albedo, voxel_channels=channels,
                              share_limit=ALBEDO_SHARE, edge_limit=ALBEDO_EDGE),
        init_seconds=t_init, refine_seconds=t_loop,
        one_device_refine_seconds=main_run["summary"]["refine_seconds"],
        seconds_per_iteration=per_iter, seconds_per_block=per_block,
        cg_steps=cg, moves=moved,
        moves_per_iteration={k: v / it for k, v in moved.items()
                             if k != "largest"})

    # (b)
    led_one = led_run["pipe"].refiner
    run = run_scan(tmp, "led_mesh", led_seq, LED_FRAMES - 1, "dma",
                   refine=REFINE_LED, grid=LED_GRID, gt_poses=True,
                   config={"mesh shape": MESH_REFINE}, mesh_devices=devs)
    led = run["pipe"].refiner
    _check_sharded(led, z, nf, "(b)")
    check(tuple(led.geom.dims) == (2 * LED_GRID,) * 3, "(b): the grid was not doubled")
    seen_b = _compare_refiners(led, led_one, "(b) LED + upsample 4x2")
    facts_b = dict(
        energy_launches=run["slice"],
        surface_voxels=led.prob.n_surface, capacity=led.prob.capacity,
        iterations=led.iterations_run, stopped=led.stop_reason,
        relative_difference=seen_b,
        refine_seconds=run["summary"]["refine_seconds"],
        one_device_refine_seconds=led_run["summary"]["refine_seconds"],
        seconds_per_iteration=_block_times(run["events"])[1])

    # (c)
    cli_run, wall = cli_mesh_run(tmp, root)
    summary = cli_run["summary"]
    made = [cli_run["pipe"]]
    facts = check_scan(cli_run, seq, FRAMES)
    _check_mesh_launches(cli_run, MESH_CLI[0], "(c) the command line on a mesh")
    _check_sharded(made[0].refiner, *MESH_CLI, "(c)")
    rfacts = check_refine(cli_run, seq, MIN_PS_DROP)
    facts_c = dict(
        mesh=list(MESH_CLI), frames=FRAMES, wall_seconds=wall,
        scan_frames_per_s=summary["fps"], ate_mm=facts["ate_mm"],
        culled_fusions=made[0].fuse_culled_calls, launches=_dma_launches(cli_run),
        preprocess_and_energy_launches=cli_run["slice"],
        iterations=rfacts["iterations"], stopped=rfacts["stopped"],
        ps_energy_ratio=rfacts["ps_energy_ratio"],
        surface_error_mm=rfacts["surface_error_mm"],
        keyframe_ate_mm=rfacts["keyframe_ate_mm"],
        refine_seconds=rfacts["refine_seconds"],
        seconds_per_iteration=rfacts["seconds_per_iteration"])
    return _dma_launches(cli_run), dict(sh1=facts_a, led_upsample=facts_b,
                                        cli=facts_c), cli_run


# ------------------------------------------------ one process a mesh row


def _record_writes(out_dir):
    """Every file this process writes under out_dir (Python's open, the PLY,
    SDF and trajectory writers, the checkpoint's files) and every writer
    thread it starts -> the list they are appended to."""
    import psgradientsdf_tpu_torch.pipeline as pipeline_mod
    import psgradientsdf_tpu_torch.refine.optimizer as optimizer_mod
    from psgradientsdf_tpu_torch.io import checkpoint as ckpt
    from psgradientsdf_tpu_torch.io import ply, sdf_io, trajectory

    seen = []
    real_open = builtins.open

    def spy_open(path, mode="r", *a, **k):
        if any(c in mode for c in "wax") and str(path).startswith(out_dir):
            seen.append(os.path.basename(str(path)))
        return real_open(path, mode, *a, **k)

    builtins.open = spy_open
    for mod, names in ((ply, ("write_mesh_ply", "write_pointcloud_ply")),
                       (sdf_io, ("write_sdf",)), (trajectory, ("write_trajectory",)),
                       (ckpt, ("_atomic_savez", "_atomic_json"))):
        for name in names:
            def spy(path, *a, _fn=getattr(mod, name), **k):
                if str(path).startswith(out_dir):
                    seen.append(os.path.basename(str(path)))
                return _fn(path, *a, **k)

            setattr(mod, name, spy)
    for mod in (pipeline_mod, optimizer_mod):
        class Spied(mod.Writer):
            def __init__(self, *a, **k):
                seen.append("writer thread " + k.get("name", ""))
                super().__init__(*a, **k)

        mod.Writer = Spied
    return seen


@contextlib.contextmanager
def _failing_iteration(iteration):
    """While the body runs, refinement iteration `iteration` (counted from 0
    in this process) raises, by a wrapper of the module function that runs
    a fused iteration, a graph replay or an eager one (None: no failure) ->
    the dict whose "failed" says whether it did."""
    from psgradientsdf_tpu_torch.refine import optimizer as opt_mod

    state = {"calls": 0, "failed": False}
    real = opt_mod._fused_step

    def failing(*args, **kw):
        state["calls"] += 1
        if state["calls"] == iteration + 1:
            state["failed"] = True
            raise RuntimeError(f"injected failure in refinement iteration {iteration}")
        return real(*args, **kw)

    if iteration is not None:
        opt_mod._fused_step = failing
    try:
        yield state
    finally:
        opt_mod._fused_step = real


def dist_rank(rank, job_path):
    """One process of phase `distributed` (the phase starts it with
    --dist-rank RANK JOB): joins the process group, runs the job's runs
    through ReconstructionPipeline on a mesh over the processes (a run may
    checkpoint, resume, stop after the scan, or fail in a refinement
    iteration, as its spec says), and writes what it saw for the phase to
    check."""
    import torch
    from psgradientsdf_tpu_torch.config import load_config
    from psgradientsdf_tpu_torch.parallel import distributed
    from psgradientsdf_tpu_torch.parallel import mesh as pm
    from psgradientsdf_tpu_torch.pipeline import ReconstructionPipeline
    from psgradientsdf_tpu_torch.utils.metrics import MetricsLogger

    with open(job_path) as fh:
        job = json.load(fh)
    distributed.initialize(num_processes=len(job["devices"]), process_id=rank,
                           init_method="file://" + job["rendezvous"],
                           backend=job["backend"], device=job["devices"][rank],
                           timeout=DIST_TIMEOUT)

    class ScanDigest(ReconstructionPipeline):
        def _run_refine_phase(self, summary):
            self.scan_digest = _digest(self.vol)
            super()._run_refine_phase(summary)

        def _scan_layout(self, vol):
            # the first placement of the scan's volume (a resume's: the
            # file's): where it was read, and the slabs this process holds
            svol = super()._scan_layout(vol)
            if not hasattr(self, "placed"):
                self.placed = dict(source=vol.dist.device.type, slabs=[
                    None if pm.is_remote(s) else str(s.dist.device)
                    for s in svol.slabs])
            return svol

    seen = _record_writes(job["out_prefix"])
    res = dict(rank=rank, backend=distributed.backend(), device=str(distributed.home()))
    for run in job["runs"]:
        spec = job[run]
        loader = None
        if "frames" in spec:
            z = np.load(spec["frames"])
            loader = memory_loader(z["K"], z["colors"], z["depths"], z["poses"])
        log = spec["metrics"][rank]
        pipe = ScanDigest(load_config(spec["config"]), loader=loader,
                          device=distributed.home(), metrics=MetricsLogger(log, echo=False),
                          **{k: spec[k] for k in ("checkpoint_every", "resume") if k in spec})
        slabs = sum(not pm.is_remote(d) for d in pipe.mesh.slab_devices)
        _reset_row_counts()                  # just before the path is driven
        pm.reset_reduce_counts()
        failure = None
        t0 = time.perf_counter()
        with _plain_cull_calls() as cull_calls, _refine_calls() as refine_calls, \
                _failing_iteration(spec.get("fail_iteration")) as injected, \
                _slice_calls() as slice_calls:
            try:
                summary = pipe.run(refine=not spec.get("scan_only"))
            except RuntimeError as e:
                if not injected["failed"]:
                    raise
                failure, summary = str(e), None
            if distributed.home().type == "cuda":
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _row_counts()               # and read just after
        moved = dict(pm.reduce_counts)
        # the energy evaluations are counted for a loop run from its start
        whole = (summary is not None and not spec.get("scan_only")
                 and "resume" not in spec)
        slice_facts = _check_slice(slice_calls, f"rank {rank} {run}",
                                   pipe.refiner if whole else None,
                                   card=distributed.home().type == "cuda")
        pipe.close()
        with open(log) as fh:
            events = [json.loads(line) for line in fh]
        got = dict(
            local_slabs=slabs, culled_fusions=pipe.fuse_culled_calls, launches=counts,
            slice=slice_facts, wall_seconds=wall, failure=failure, writes=list(seen),
            placed=getattr(pipe, "placed", None),
            plain_on_card={k: v for k, v in dict(refine_calls, **cull_calls).items()
                           if k.startswith("plain")},
            scan_digest=(_digest(pipe.vol) if spec.get("scan_only")
                         else getattr(pipe, "scan_digest", None)),
            keyframe_digest=(_digest([torch.from_numpy(np.stack(pipe.key_poses))])
                             if pipe.key_poses else None),
            events={k: [e for e in events if e["event"] == k] for k in (
                "checkpoint", "refine_checkpoint", "resume", "scan_done")})
        if summary is not None and pipe.refiner is not None:
            state = _refiner_state(pipe.refiner)
            if rank == 0:
                torch.save(state, spec["state"])
            per_block, per_iter, cg = _block_times(events)
            it = max(state["iterations"], 1)
            got.update(
                state_digest=_digest([state[k] for k in STATE_TENSORS]),
                energy=state["energy"], iterations=state["iterations"],
                stopped=state["stop"], surface_voxels=state["n_surface"],
                frames=summary["frames"], frames_per_s=summary.get("fps"),
                refine_seconds=summary["refine_seconds"],
                seconds_per_iteration=per_iter, seconds_per_block=per_block,
                cg_steps=cg, moves=moved,
                moves_per_iteration={k: v / it for k, v in moved.items()
                                     if k != "largest"})
        res[run] = got
        seen.clear()
    distributed.shutdown()
    with open(job["result"][rank], "w") as fh:
        json.dump(res, fh, default=float)
    return 0


def _dist_out(tmp, backend, run):
    """The output directory of a distributed run (process 0 writes there)."""
    return os.path.join(tmp, f"dist_{backend}_out_{run}") + "/"


def _run_ranks(tmp, backend, devices, specs, launch):
    """Start DIST_WORLD processes of dist_rank on `devices` (one a rank) over
    `backend`, to run `specs` in order, and wait for them -> their results.
    A process that fails or outlives DIST_RANK_SECONDS fails the phase; none
    outlives the call."""
    tag = f"dist_{backend}_{launch}"
    job = dict(backend=backend, devices=devices, runs=list(specs),
               rendezvous=os.path.join(tmp, tag + "_rendezvous"),
               out_prefix=_dist_out(tmp, backend, "").rstrip("/"),
               result=[os.path.join(tmp, f"{tag}_rank{r}.json")
                       for r in range(len(devices))])
    for run, spec in specs.items():
        out = _dist_out(tmp, backend, run)
        write_config(spec["config"], out, spec["last"], grid=spec.get("grid"),
                     refine=spec["refine"], input_dir=spec.get("input", ""),
                     config={"mesh shape": spec["mesh"]})
        job[run] = dict(spec, out=out,
                        state=os.path.join(tmp, f"dist_{backend}_{run}_state.pt"),
                        metrics=[os.path.join(tmp, f"dist_{backend}_{run}_rank{r}.jsonl")
                                 for r in range(len(devices))])
    job_path = os.path.join(tmp, tag + ".json")
    with open(job_path, "w") as fh:
        json.dump(job, fh)
    procs = []
    try:
        for r in range(len(devices)):
            log = open(os.path.join(tmp, f"{tag}_rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
                 job_path], stdout=log, stderr=subprocess.STDOUT), log))
        t0 = time.perf_counter()
        for r, (p, log) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, DIST_RANK_SECONDS - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                log.flush()
                with open(log.name) as fh:
                    tail = fh.read()[-3000:]
                raise SmokeFailure(f"{backend} {launch} rank {r} ended with {rc}:\n{tail}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results = []
    for path in job["result"]:
        with open(path) as fh:
            results.append(json.load(fh))
    return job, results


def _dist_resume(tmp, backend, devices, sh1, cli_run, want, launches):
    """mesh_refine (c)'s recipe with one process a mesh row, in three
    launches of the ranks: the scan stops at frame CHUNK with a checkpoint;
    new ranks resume from scan_checkpoint.npz with a refinement checkpoint
    every 2 iterations, and refinement iteration FAIL_ITERATION fails on
    every rank; new ranks resume from refine_checkpoint.npz to the end.
    Checks: the resumed scan's volume, keyframe poses and trajectory equal
    the one-process 2x2 CLI run (`cli_run`) bit for bit, and the resumed
    refinement its state `want` within PARITY_TOL with the same stop and
    iterations; the ranks' state is the same; process 0 alone writes the
    checkpoints and logs their events; the direct kernels, the cull and the
    compaction launch once per culled fusion of each rank's slabs, the
    stopped and the resumed scan making the one-process run's culled
    fusions between them; no kernel's plain version runs on the card.  Adds the
    launches to `launches` -> what was measured."""
    import torch

    cli_pipe = cli_run["pipe"]
    # the stopped scan runs the whole recipe on an input that ends at frame
    # CHUNK: a checkpoint holds the visibility words of its run's frame
    # range, and a resume needs those of its own
    first = os.path.join(tmp, "tum_first_frames")
    _first_frames(sh1["input"], CHUNK + 1, first)
    stop_ckpt = _dist_out(tmp, backend, "stop") + "scan_checkpoint.npz"
    fail_ckpt = _dist_out(tmp, backend, "fail") + "refine_checkpoint.npz"
    steps = {
        "stop": dict(sh1, config=os.path.join(tmp, "dist_stop.json"), input=first + "/",
                     checkpoint_every=CHUNK, scan_only=True),
        "fail": dict(sh1, config=os.path.join(tmp, "dist_fail.json"), checkpoint_every=2,
                     resume=stop_ckpt, fail_iteration=FAIL_ITERATION),
        "resume": dict(sh1, config=os.path.join(tmp, "dist_resume.json"),
                       checkpoint_every=2, resume=fail_ckpt)}
    runs = {}
    for step, spec in steps.items():
        job, ranks = _run_ranks(tmp, backend, devices, {step: spec}, step)
        runs[step] = [res[step] for res in ranks]
        for r, g in enumerate(runs[step]):
            what = f"{backend} {step} rank {r}"
            # the mesh's albedo block forms its data terms eagerly by design
            # (ROADMAP §2b item 5): no kernel's plain version
            plain = {k: v for k, v in g["plain_on_card"].items()
                     if k != "plain_albedo_solve_on_card"}
            check(not any(plain.values()), f"{what}: a plain path ran on the card: {plain}")
            calls, slabs = g["culled_fusions"], g["local_slabs"]
            for name in launches:
                n = g["launches"][name]
                check(n == (calls * slabs if DEVICE == "cuda" else 0),
                      f"{what}: {name} {n} launches, {slabs} slab x {calls} culled fusions")
                launches[name] += n
            mine = {e["event"] for k in ("checkpoint", "refine_checkpoint")
                    for e in g["events"][k]}
            check(r == 0 or (not g["writes"] and not mine),
                  f"{what} wrote {g['writes']} and logged {sorted(mine)}")
    stop, fail, resume = runs["stop"], runs["fail"], runs["resume"]
    w0 = set(stop[0]["writes"]) | set(fail[0]["writes"])
    files = {f"{name}{suffix}" for name, suffixes in (
        ("scan_checkpoint.npz", ("", ".scan", ".json")),
        ("refine_checkpoint.npz", ("", ".refine", ".images", ".json")))
        for suffix in suffixes}
    check(files <= w0, f"{backend}: process 0 wrote {sorted(w0)}")
    saved = stop[0]["events"]["checkpoint"]
    check(len(saved) == 1 and saved[0]["frame"] == CHUNK,
          f"{backend}: the stopped scan logged checkpoints {saved}")
    with open(_dist_out(tmp, backend, "fail") + "tracking_poses.txt") as fh:
        check(fh.read() == _read_text(os.path.join(cli_run["out_dir"], "tracking_poses.txt")),
              f"{backend}: the resumed scan's trajectory differs from the one-process 2x2 run")
    cli_keyframes = _digest([torch.from_numpy(np.stack(cli_pipe.key_poses))])
    for r, g in enumerate(fail):
        check(g["failure"] and f"iteration {FAIL_ITERATION}" in g["failure"],
              f"{backend} rank {r}: the refinement did not fail where injected: "
              f"{g['failure']}")
        check([e["next_frame"] for e in g["events"]["resume"]] == [CHUNK + 1],
              f"{backend} rank {r}: resume events {g['events']['resume']}")
        # the file read on the host, and only this rank's slab (mesh row r)
        # copied to its card
        check(g["placed"]["source"] == "cpu" and g["placed"]["slabs"] == [
            devices[r] if k == r else None for k in range(MESH_CLI[0])],
              f"{backend} rank {r}: the resume placed {g['placed']}")
        check(g["scan_digest"] == cli_pipe.scan_digest
              and g["keyframe_digest"] == cli_keyframes,
              f"{backend} rank {r}: the resumed scan's volume or keyframe poses "
              "differ from the one-process 2x2 run")
        check(stop[r]["culled_fusions"] + g["culled_fusions"] == cli_pipe.fuse_culled_calls,
              f"{backend} rank {r}: {stop[r]['culled_fusions']} + {g['culled_fusions']} "
              f"culled fusions, one process {cli_pipe.fuse_culled_calls}")
    for r, g in enumerate(resume):
        check([e.get("iter") for e in g["events"]["resume"]] == [2],
              f"{backend} rank {r}: resume events {g['events']['resume']}")
        check(g["state_digest"] == resume[0]["state_digest"]
              and g["energy"] == resume[0]["energy"],
              f"{backend} resume: the processes' poses, state or energies differ")
    got = torch.load(job["resume"]["state"], weights_only=False)   # rank 0's
    seen = _compare_states(got, want, f"{backend} resumed against the one-process 2x2 CLI run")
    return dict(
        stopped_after_frame=CHUNK, failed_in_iteration=FAIL_ITERATION,
        resumed_at_iteration=2, relative_difference=seen,
        iterations=resume[0]["iterations"], stopped=resume[0]["stopped"],
        culled_fusions={k: v[0]["culled_fusions"] for k, v in runs.items()},
        mesh_albedo_data_terms={k: v[0]["plain_on_card"]["plain_albedo_solve_on_card"]
                                for k, v in runs.items()},
        scan_checkpoints=[dict(frame=e["frame"], seconds=e["seconds"], bytes=e["bytes"])
                          for g in (stop[0], fail[0]) for e in g["events"]["checkpoint"]],
        refine_checkpoints=[dict(iteration=e["iter"], seconds=e["seconds"],
                                 bytes=e["bytes"])
                            for g in (fail[0], resume[0])
                            for e in g["events"]["refine_checkpoint"]],
        resumed_scan_seconds=[g["events"]["scan_done"][0]["seconds"] for g in fail],
        wall_seconds={k: [g["wall_seconds"] for g in v] for k, v in runs.items()})


def _first_frames(root, n, dest):
    """A TUM directory at `dest` whose associated.txt lists the first `n`
    frames of the one at `root` (their images named by absolute path)."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(root, "intrinsics.txt"), dest)
    lines = _read_text(os.path.join(root, "associated.txt")).splitlines()[:n]
    with open(os.path.join(dest, "associated.txt"), "w") as fh:
        for line in lines:
            ts_rgb, rgb, ts_depth, depth = line.split()
            fh.write(f"{ts_rgb} {os.path.join(root, rgb)} "
                     f"{ts_depth} {os.path.join(root, depth)}\n")


def _read_text(path):
    with open(path) as fh:
        return fh.read()


def distributed_phase(tmp, root, cli_run, led_run, led_seq):
    """The whole recipe with one process a mesh row: DIST_WORLD processes
    joined by gloo, every one on the one card (and by NCCL, one card a
    process, where there are DIST_WORLD cards), run (1) mesh_refine (c)'s
    command-line recipe from the PNG files on its 2x2 mesh through
    ReconstructionPipeline, and (2) the LED upsample run on DIST_LED_MESH.
    Checks: (1)'s scan volume, keyframe poses and trajectory equal (c)'s
    one-process run bit for bit, its refinement (c)'s within PARITY_TOL with
    the same stop and iterations; (2) refine_led_upsample's within
    PARITY_TOL with the same surface count after the upsample; both
    processes hold the same state and energies; each launches each direct
    kernel once per culled fusion of its slab; process 0 alone writes the
    outputs.  Then (3) (1)'s recipe stopped, failed and resumed in three
    launches of the ranks (_dist_resume).  -> (the direct kernels' and the
    cull's launches, what was measured)."""
    import torch

    K, colors, depths, poses = led_seq[:4]
    frames = os.path.join(tmp, "dist_led_frames.npz")
    np.savez(frames, K=K, colors=np.stack(colors[:LED_FRAMES]),
             depths=np.stack(depths[:LED_FRAMES]), poses=np.stack(poses[:LED_FRAMES]))
    specs = {
        "sh1": dict(config=os.path.join(tmp, "dist_sh1.json"), last=FRAMES - 1,
                    refine=REFINE_SH1, input=root + "/",
                    mesh={"z": MESH_CLI[0], "frames": MESH_CLI[1]}),
        "led": dict(config=os.path.join(tmp, "dist_led.json"), last=LED_FRAMES - 1,
                    refine=REFINE_LED, grid=LED_GRID, frames=frames, mesh=DIST_LED_MESH)}
    routes = [("gloo", ["cuda:0" if DEVICE == "cuda" else DEVICE] * DIST_WORLD)]
    if DEVICE == "cuda" and torch.cuda.device_count() >= DIST_WORLD:
        routes.append(("nccl", [f"cuda:{r}" for r in range(DIST_WORLD)]))
    cli_pipe = cli_run["pipe"]
    with open(os.path.join(cli_run["out_dir"], "tracking_poses.txt")) as fh:
        cli_poses = fh.read()
    want = {"sh1": _refiner_state(cli_pipe.refiner),
            "led": _refiner_state(led_run["pipe"].refiner)}
    cli_keyframes = _digest([torch.from_numpy(np.stack(cli_pipe.key_poses))])
    launches = {k: 0 for k in ("gather_rows_dma", "scatter_rows_dma") + CULL_KERNELS}
    facts = {}
    for backend, devices in routes:
        t0 = time.perf_counter()
        job, ranks = _run_ranks(tmp, backend, devices, specs, "recipes")
        seconds = time.perf_counter() - t0
        seen = {}
        for r, res in enumerate(ranks):
            check(res["backend"] == backend, f"rank {r} ran {res['backend']}")
            for run in ("sh1", "led"):
                g = res[run]
                calls, slabs = g["culled_fusions"], g["local_slabs"]
                for name, n in g["launches"].items():
                    if name in launches:
                        check(n == (calls * slabs if DEVICE == "cuda" else 0),
                              f"{backend} rank {r} {run}: {name} {n} launches, "
                              f"{slabs} slab x {calls} culled fusions")
                        launches[name] += n
                check(g["state_digest"] == ranks[0][run]["state_digest"]
                      and g["energy"] == ranks[0][run]["energy"],
                      f"{backend} {run}: the processes' poses, state or energies differ")
        sh1 = ranks[0]["sh1"]
        for r, res in enumerate(ranks):
            check(res["sh1"]["scan_digest"] == cli_pipe.scan_digest,
                  f"{backend} rank {r}: the scan volume differs from the one-process 2x2 run")
            check(res["sh1"]["keyframe_digest"] == cli_keyframes,
                  f"{backend} rank {r}: the keyframe poses differ from the one-process run")
            check(res["sh1"]["culled_fusions"] == cli_pipe.fuse_culled_calls,
                  f"{backend} rank {r}: {res['sh1']['culled_fusions']} culled fusions, "
                  f"one process {cli_pipe.fuse_culled_calls}")
        with open(os.path.join(job["sh1"]["out"], "tracking_poses.txt")) as fh:
            check(fh.read() == cli_poses,
                  f"{backend}: the trajectory differs from the one-process 2x2 run")
        outputs = {"tracking_poses.txt", "init_mesh.ply", "init_pointcloud.ply",
                   "init_sdf.sdf", "final_refined_mesh.ply", "final_refined_pointcloud.ply",
                   "final_refined_poses.txt", "final_refined_sdf.sdf"}
        written = set(ranks[0]["sh1"]["writes"])
        check(outputs <= written and "writer thread initial-export" in written,
              f"{backend}: process 0 wrote {sorted(written)}")
        check(all(not res["sh1"]["writes"] for res in ranks[1:]),
              f"{backend}: another process wrote {[res['sh1']['writes'] for res in ranks]}")
        for run, what in (("sh1", "the one-process 2x2 CLI run"),
                          ("led", "refine_led_upsample")):
            got = torch.load(job[run]["state"], weights_only=False)
            seen[run] = _compare_states(got, want[run], f"{backend} {run} against {what}")
        facts[backend] = dict(
            seconds=seconds, devices=devices, mesh=[MESH_CLI, [DIST_LED_MESH["z"], DIST_LED_MESH["frames"]]],
            relative_difference=seen, frames=sh1["frames"],
            culled_fusions=sh1["culled_fusions"],
            iterations={run: ranks[0][run]["iterations"] for run in ("sh1", "led")},
            stopped={run: ranks[0][run]["stopped"] for run in ("sh1", "led")},
            surface_voxels={run: ranks[0][run]["surface_voxels"] for run in ("sh1", "led")},
            one_process_seconds_per_iteration=_block_times(cli_run["events"])[1],
            ranks=[dict(rank=res["rank"], backend=res["backend"], device=res["device"],
                        **{run: {k: res[run][k] for k in (
                            "local_slabs", "launches", "slice", "frames_per_s", "refine_seconds",
                            "wall_seconds", "seconds_per_iteration", "seconds_per_block",
                            "cg_steps", "moves_per_iteration")} for run in ("sh1", "led")})
                   for res in ranks])
        facts[backend]["resume"] = _dist_resume(
            tmp, backend, devices, specs["sh1"], cli_run, want["sh1"], launches)
        facts[backend]["seconds_with_resume"] = time.perf_counter() - t0
    if len(routes) == 1:
        facts["nccl"] = (f"unverified: {torch.cuda.device_count()} card(s) here, NCCL "
                         f"takes one card a process and {DIST_WORLD} processes")
    return launches, facts


def main():
    t_all = time.perf_counter()
    # no CUPTI teardown between traced sessions in a process that replays
    # CUDA graphs (utils/profiling.py), set before torch loads the profiler
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    from psgradientsdf_tpu_torch import kernels, native
    from psgradientsdf_tpu_torch.ops import rowcopy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    card = smi

    # ---- build: nvcc for the kernels and g++ for the host libraries, all
    # started together
    t0 = time.perf_counter()
    started = {name: kernels.start_build(name) for name in LIBRARIES}
    for name, job in started.items():
        kernels.finish_build(name, job)
    for name in kernels.CUDA_LIBRARIES:
        kernels.load_library(name)
    native.library(native.PNG_LIB)
    native.library(native.MC_LIB)
    rowcopy.gather_rows_dma(torch.zeros((2, 4), device="cuda"),
                            torch.zeros(1, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    emit("build", sources=[os.path.relpath(kernels.source_path(n)) for n in LIBRARIES],
         seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(kernels.library_path(n)) for n in LIBRARIES])

    # ---- kernels against their plain versions
    seq = make_sequence(FRAMES)
    if "--scan-graph-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            emit("scan_graph", ok=True, card=card, **scan_graph(tmp, seq))
        print(smi, flush=True)
        return 3
    if "--refine-only" not in sys.argv[1:]:
        times, shapes, worst, n_checked, packed_widths = check_kernels(rowcopy)
        emit("kernels", ok=True, cases_checked=n_checked, card=card,
             reps=KERNEL_REPS, times=times, shapes=shapes,
             packed_widths=packed_widths)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            scan_facts = scan_kernels(tmp, seq)
        emit("scan_kernels", ok=True, card=card, reps=KERNEL_REPS, **scan_facts)
        prep_facts = preprocess_kernels(seq)
        emit("preprocess_kernels", ok=True, card=card, reps=KERNEL_REPS, **prep_facts)
    if "--kernels-only" in sys.argv[1:]:
        return 3
    if "--distributed-only" in sys.argv[1:]:
        # the distributed phase and the one-process runs it is held to
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            root = os.path.join(tmp, "tum")
            write_tum_dataset(root, *seq[:3])
            cli_run, _ = cli_mesh_run(tmp, root)
            led_run, led_seq, _ = run_led_upsample(tmp)
            _, facts = distributed_phase(tmp, root, cli_run, led_run, led_seq)
            emit("distributed", ok=True, card=card, **facts)
        print(smi, flush=True)
        return 3

    # ---- the main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        with _albedo_decisions() as decisions, _first_iteration_blocks(
                "--profile" in sys.argv[1:]) as first_blocks:
            main_run = run_scan(tmp, "scan", seq, FRAMES - 1, "dma",
                                refine=REFINE_SH1)
        main_run["albedo_decisions"] = decisions
        if "--refine-only" in sys.argv[1:]:
            # the refinement's kernels on the main run and the LED run
            emit("refine", ok=True, card=card, launches=check_refine_launches(main_run),
                 **check_refine(main_run, seq, MIN_PS_DROP))
            with _first_led_light() as led_first:
                led_run, _, facts = run_led_upsample(tmp)
            emit("refine_led_upsample", ok=True, card=card,
                 launches=check_refine_launches(led_run), **facts)
            emit("refine_kernels", ok=True, card=card, reps=KERNEL_REPS,
                 **refine_kernels(main_run, led_run))
            emit("dist_cg_kernels", ok=True, card=card, reps=KERNEL_REPS,
                 **dist_cg_kernels(main_run, led_run))
            emit("normal_eq_kernels", ok=True, card=card, reps=KERNEL_REPS,
                 **normal_eq_kernels(main_run, led_run))
            emit("albedo_kernels", ok=True, card=card, reps=KERNEL_REPS,
                 **albedo_kernels(main_run, led_run))
            emit("energy_kernels", ok=True, card=card, reps=KERNEL_REPS,
                 **energy_kernels(main_run, led_run))
            emit("dist_tail_kernels", ok=True, card=card, reps=KERNEL_REPS,
                 **dist_tail_kernels(main_run, led_run, led_first))
            emit("light_solve_kernels", ok=True, card=card, reps=KERNEL_REPS,
                 **light_solve_kernels(main_run))
            led_seq = make_sequence(LED_FRAMES, shading="led", step=LED_STEP, seed=SEED + 1)
            emit("refine_graph", ok=True, card=card, **refine_graph(tmp, seq, led_seq))
            if "--profile" in sys.argv[1:]:
                emit("profile_refine", card=card, **profile_refine(
                    main_run["pipe"].refiner))
                emit("profile_refine_led", card=card, **profile_refine(
                    led_run["pipe"].refiner))
                emit("profile_first_iteration", card=card,
                     blocks=_checked_blocks(first_blocks))
            print(smi, flush=True)
            return 3
        facts = check_scan(main_run, seq, FRAMES)
        counts = main_run["counts"]
        calls = main_run["pipe"].fuse_culled_calls
        # a culled fusion culls with one launch, compacts with one, gathers
        # its five tables with one call and writes them back with one
        for name in ("gather_rows_dma", "scatter_rows_dma") + CULL_KERNELS:
            check(counts[name] == calls,
                  f"{name}: {counts[name]} launches, expected 1 x {calls}")
        for name in ("gather_rows", "scatter_rows"):
            check(counts[name] == 0, f"{name} launched on the default path")
        # every tracked frame ONE solve launch, every update a launch: the
        # culled fusions and frame 0's fusion of the whole grid
        scan_counts = main_run["scan_counts"]
        solved = scan_counts["frames_solved"]
        check(solved >= FRAMES - 1 and scan_counts["gn_solve"] == _on_card(solved),
              f"gn_solve: {scan_counts['gn_solve']} launches, {solved} frames "
              f"solved, {FRAMES - 1} tracked")
        check("gn_step" not in scan_counts, "a per-step GN launch still exists")
        check(scan_counts["fuse_rows"] == _on_card(calls + 1),
              f"fuse_rows: {scan_counts['fuse_rows']} launches, expected "
              f"{calls} culled fusions + 1")
        check(scan_counts["gn_gram"] == 0, "gn_gram launched on the default path")
        emit("scan", ok=True, card=card, frames=FRAMES,
             seconds=main_run["summary"]["seconds"],
             frames_per_s=main_run["summary"]["fps"],
             wall_seconds_with_export=main_run["seconds"],
             # the initial export's writer thread, which overlaps the
             # refinement
             export_thread_seconds=[e["seconds"] for e in main_run["events"]
                                    if e["event"] == "export"],
             keyframes=main_run["summary"]["keyframes"],
             overflow_redos=main_run["summary"]["overflow_redos"],
             fuse_capacity=main_run["summary"]["fuse_capacity"],
             launches=dict(counts, **scan_counts),
             preprocess_and_energy=main_run["slice"], **facts)
        refine_launches = check_refine_launches(main_run)
        emit("refine", ok=True, card=card, launches=refine_launches,
             **check_refine(main_run, seq, MIN_PS_DROP))

        # ---- the one-card scan as one CUDA graph a chunk against the eager
        # chunks: four tracker configs, an overflow redo, a resume
        graph_facts = scan_graph(tmp, seq)
        emit("scan_graph", ok=True, card=card, **graph_facts)

        # ---- the second pass: staged kernels, and plain row movement
        short = 2 * CHUNK + 1
        runs = {impl: run_scan(tmp, "short_" + impl, seq, short - 1, impl)
                for impl in ("dma", "staged", "plain")}
        staged = runs["staged"]
        calls_s = staged["pipe"].fuse_culled_calls
        for name in ("gather_rows", "scatter_rows"):
            check(staged["counts"][name] == calls_s,
                  f"{name}: {staged['counts'][name]} launches, expected "
                  f"1 x {calls_s}")
        check(all(runs["plain"]["counts"][k] == 0 for k in KERNELS),
              "plain row movement launched a row-copy kernel")
        # every row movement culls and compacts through the kernels
        for impl, run in runs.items():
            calls_i = run["pipe"].fuse_culled_calls
            for name in CULL_KERNELS:
                check(run["counts"][name] == calls_i,
                      f"the {impl} rows' scan: {name} {run['counts'][name]} "
                      f"launches, {calls_i} culled fusions")
        for impl in ("staged", "plain"):
            check(runs[impl]["pose_text"] == runs["dma"]["pose_text"],
                  f"{impl}: poses differ from the dma run")
            for name, a, b in zip(staged["pipe"].vol._fields,
                                  runs[impl]["pipe"].vol, runs["dma"]["pipe"].vol):
                check(bool(torch.equal(a, b)), f"{impl}: {name} differs from the dma run")
        check_scan(staged, seq, short)
        emit("scan_staged", ok=True, card=card, frames=short,
             culled_fusions=calls_s, launches=staged["counts"],
             frames_per_s={k: r["summary"]["fps"] for k, r in runs.items()})

        # ---- the scan on a device mesh: MESH_SLABS slabs on the one card
        mesh_launches, facts = mesh_scan(tmp, seq, short, runs["dma"])
        emit("mesh_scan", ok=True, card=card, launches=mesh_launches, **facts)

        # ---- the packed, K-batched and resident volume state
        t0 = time.perf_counter()
        packed_launches, facts = packed_phase(tmp, seq)
        emit("packed", ok=True, card=card, launches=packed_launches,
             seconds=time.perf_counter() - t0, **facts)

        # ---- the sequence as PNG files, decoded and scanned from them
        root, facts = dataset_files(tmp, seq, short, runs["dma"])
        emit("dataset_files", ok=True, card=card, **facts)

        # ---- a scan stopped at a checkpoint and resumed
        emit("resume_scan", ok=True, card=card,
             **resume_scan(tmp, seq, short, runs["dma"]))

        # ---- one refinement iteration, card against CPU
        emit("refine_parity", ok=True, card=card, **refine_parity(
            runs["dma"], main_run["pipe"].cfg.optimizer))

        # ---- the LED model and the upsample, at a smaller depth
        with _first_led_light() as led_first:
            led_run, led_seq, facts = run_led_upsample(tmp)
        emit("refine_led_upsample", ok=True, card=card,
             launches=check_refine_launches(led_run), **facts)

        # ---- the refinement's two kernels against their plain versions
        refine_facts = refine_kernels(main_run, led_run)
        emit("refine_kernels", ok=True, card=card, reps=KERNEL_REPS, **refine_facts)

        # ---- the distance block's solve against its plain version
        dist_facts = dist_cg_kernels(main_run, led_run)
        emit("dist_cg_kernels", ok=True, card=card, reps=KERNEL_REPS, **dist_facts)

        # ---- the pose and light normal equations against their plain versions
        normal_facts = normal_eq_kernels(main_run, led_run)
        emit("normal_eq_kernels", ok=True, card=card, reps=KERNEL_REPS, **normal_facts)

        # ---- the albedo block's one launch against the plain versions
        albedo_facts = albedo_kernels(main_run, led_run)
        emit("albedo_kernels", ok=True, card=card, reps=KERNEL_REPS, **albedo_facts)

        # ---- the energies' one launch against the plain chain
        energy_facts = energy_kernels(main_run, led_run)
        emit("energy_kernels", ok=True, card=card, reps=KERNEL_REPS, **energy_facts)

        # ---- the distance tail's and the LED light's launches against the
        # plain chains
        tail_facts = dist_tail_kernels(main_run, led_run, led_first)
        emit("dist_tail_kernels", ok=True, card=card, reps=KERNEL_REPS, **tail_facts)

        # ---- the SH light's eigen-solve against its plain version
        solve_facts = light_solve_kernels(main_run)
        emit("light_solve_kernels", ok=True, card=card, reps=KERNEL_REPS, **solve_facts)

        # ---- the one-card refinement as one CUDA graph an iteration against
        # the eager loop: SH1, a whole SH2 refinement, LED with its upsample
        emit("refine_graph", ok=True, card=card, **refine_graph(tmp, seq, led_seq))

        # ---- the command line on the files, a failure mid-refinement, retry
        emit("resume_refine", ok=True, card=card,
             **resume_refine(tmp, root, main_run))

        # ---- the refinement on a mesh: 4x2 and the command line on 2x2
        mesh_refine_launches, mesh_refine_facts, cli_run = mesh_refine(
            tmp, seq, main_run, led_run, led_seq, root)
        emit("mesh_refine", ok=True, card=card, **mesh_refine_facts)

        # ---- the same recipes with one process a mesh row
        dist_launches, distributed_facts = distributed_phase(
            tmp, root, cli_run, led_run, led_seq)
        emit("distributed", ok=True, card=card, **distributed_facts)

        # ---- the host's marching cubes and PLY writers
        emit("dumps", ok=True, card=card, **dumps(
            main_run["pipe"].refiner, main_run["pipe"].cfg.truncation, main_run))

        if "--profile" in sys.argv[1:]:
            emit("profile", card=card, **profile_scan(
                tmp, seq, short, runs["dma"]["summary"]["seconds"]))
            emit("profile_cli", card=card, **profile_cli(tmp, root, short))
            emit("profile_refine", card=card, **profile_refine(
                main_run["pipe"].refiner))
            emit("profile_refine_led", card=card, **profile_refine(
                led_run["pipe"].refiner))
            emit("profile_first_iteration", card=card,
                 blocks=_checked_blocks(first_blocks))

    # the main run's launches, the mesh phases' of the direct kernels, and
    # phase packed's of all four
    launches = {k: counts[k] + mesh_launches.get(k, 0)
                + mesh_refine_launches.get(k, 0) + dist_launches.get(k, 0)
                + packed_launches[k] for k in counts}
    launches.update({k: staged["counts"][k] + packed_launches[k]
                     for k in ("gather_rows", "scatter_rows")})
    for name in KERNELS:
        check(launches[name] > 0, f"{name} was never launched on its path")
    print(smi, flush=True)
    emit("total", seconds=time.perf_counter() - t_all)
    # the scan programs' kernels: the main run's launches (gn_gram: the
    # tracked mesh scans', its path), the update's times on frame 24's rows
    # at 128^3 (SoA), the solve's on frame 24 under REFERENCE, the Gram's on
    # frame 24's records
    update = next(u for u in scan_facts["update"]
                  if u["grid"] == GRID and u["frame"] == 24 and u["layout"] == "soa")
    scan_counts = dict(scan_counts, gn_gram=mesh_launches["gn_gram"])
    solve = scan_facts["gn_solve"]
    scan_rows = {
        "gn_solve": dict(solve, work=(
            f"frame 24's whole REFERENCE solve ({solve['iterations']} GN steps, "
            f"one launch, {solve['blocks']} blocks): {W}x{H} pixels against "
            "the 128^3 SoA volume; the bound counts the depth map once and "
            "each fresh step's distinct voxel records once; latency_floor_ms "
            "is an empty cooperative kernel on the same grid crossing as many "
            "grid barriers")),
        "gn_gram": dict(scan_facts["gn_gram"], work=(
            f"the masked Gram of frame 24's frozen records at {W}x{H} (the "
            "summed-Gram mesh tracker's and the resident tracker's pass; "
            "launches: the tracked mesh scans'), "
            f"{scan_facts['gn_gram']['plan']['clusters']} clusters of "
            f"{scan_facts['gn_gram']['plan']['cluster']} blocks; the bound counts "
            "the depth map and the [N, 8] records once; latency_floor_ms is an "
            "empty kernel of the same grid and clusters")),
        "fuse_rows": dict(update, max_abs_err=0.0,
                          # the form the scan's graph replays, in turns with
                          # the host bit's (phase scan_graph)
                          device_frame_id_ms=graph_facts["device_frame_id"]["ms"],
                          work=f"frame 24's update at 128^3 on the gathered SoA "
                               f"rows: {update['live_rows']} live rows of "
                               f"{update['slots']} slots, 128 voxels a row; the "
                               "bound counts 72 bytes a live voxel, the pixel "
                               "table and the row ids once")}
    cull_time = scan_facts["cull"]["times"][0]
    scan_rows["cull_compact"] = dict(cull_time, max_abs_err=0.0, work=(
        f"{cull_time['case']}'s gated cull and its compaction with "
        f"duplicate-first padding in ONE cooperative launch ({cull_time['blocks']} "
        "blocks, two grid barriers), timed in the path's order, no flush: the "
        f"row maxima, then the mask of {cull_time['entries']} rows in shared "
        f"memory, then {cull_time['active']} active rows into "
        f"{cull_time['capacity']} int32 slots, n_active, live and overflow on "
        "the card; the bound counts the depth image read and the slots and "
        "scalars written once; latency_floor_ms is an empty cooperative launch "
        "of the same grid and shared memory crossing two barriers; library_ms "
        "is one torch.nonzero over the mask, which reads its count back to the "
        "host (a yardstick only)"), library_call="torch.nonzero(mask)")
    parent = scan_facts["cull"].get("parent")
    if parent:
        # PR 21-25's row_activity + compact_rows on the same inputs, in turns
        scan_rows["cull_compact"]["earlier_ms"] = statistics.median(
            next(iter(parent.values()))["parent"])
    for name in SCAN_KERNELS:
        check(scan_counts[name] > 0, f"{name} was never launched on its path")
    # the refinement's kernels: the main run's launches, the times on its
    # problem (SH1 under its loss)
    main_case = next(c for c in refine_facts["cases"]
                     if c["case"] == f"main SH1 {REFINE_SH1['loss function']}")
    refine_rows = {name: dict(main_case[name], work=(
        f"the main run's residual pass at its final state: "
        f"{main_case['voxels']} surface-voxel slots x {main_case['keyframes']} "
        f"keyframes of {W}x{H}, SH1, {REFINE_SH1['loss function']} loss; the "
        "bound counts 70 bytes a pair written (and vis read), the per-voxel "
        f"inputs once and the {main_case['residual_pass']['distinct_pixels']} "
        "distinct pixels the patches read once"
        if name == "residual_pass" else
        "the main run's distance Jacobian from that pass (no G, as the "
        "distance block asks): p_cam and g_img read, J0 and Ji written (84 "
        "bytes a pair), the per-voxel inputs once"))
        for name in REFINE_KERNELS}
    for name in REFINE_KERNELS:
        check(refine_launches[name] > 0, f"{name} was never launched on its path")
    # the distance block's solve: the main run's launches, the times on its
    # final problem (SH1, scipy's stop rule): the launches the main path
    # makes, dist_system with the regularizer stage and dist_cg with the
    # update stage, in the block's order (dist_tail_kernels), beside the
    # kernels without their stages (dist_cg_kernels, L2 flushed)
    dist_case = next(c for c in dist_facts["cases"]
                     if c["case"] == "main SH1" and not c["static"])
    fused = tail_facts["timed"]["fused"]
    unfused = {k: {"unfused_" + f: dist_case[k][f] for f in ("ms", "bound_ms", "plain_ms")}
               for k in ("dist_system", "dist_cg")}
    dist_rows = {
        "dist_system": dict(fused["dist_system"], **unfused["dist_system"],
                            library_ms=dist_case["dist_system"]["library_ms"], work=(
            f"the main run's distance block at its final state with the regularizer "
            f"stage: {dist_case['rows']} surface-voxel slots x {dist_case['keyframes']} "
            f"keyframes, {dist_case['dist_system']['lanes']} lanes a row, the tiles "
            "bulk-copied into a ring while the producer warp's lanes form each row's "
            "Eikonal row from its stencil, timed in the block's order after "
            "dist_jacobian, no flush; the bound counts w, r, J0 and Ji read once (24 "
            "bytes a pair), A and t written (56 bytes a row) and the stencil read "
            "(41 bytes a row); plain_ms is reg_operators_plain's Eikonal operator "
            "then dist_system_plain; library_ms is the one einsum that forms A from "
            "[N, F*3, 4]; unfused_* the kernel without the stage on the Eikonal "
            "row formed beforehand, L2 flushed")),
        "dist_cg": dict(fused["dist_cg"], **unfused["dist_cg"],
                        max_abs_err=dist_case["max_abs_err"],
                        latency_floor_ms=dist_facts["latency_floor_ms"],
                        grid_sync_floor_ms=dist_case["dist_cg"]["grid_sync_floor_ms"], work=(
            f"that block's whole Jacobi-PCG and its update ({fused['dist_cg']['steps']} "
            f"steps, one cooperative launch, {dist_case['plan']['blocks']} blocks of "
            f"{dist_case['plan']['rows_per_block']} rows, the "
            f"{dist_case['plan']['mode']} layout, "
            f"{dist_case['plan']['barriers_per_step']} grid barriers a step and one "
            "after the last, then the accept rule and the new gradient), timed in "
            "the block's order after dist_system, no flush; the bound counts A, t, "
            "nbr and rev (int32) and the mask read once, delta written once, and "
            "dist, the direction and the constants read and new_dist and new_grad "
            "written once (the Laplacian's residual and lap_idx off here); "
            "max_abs_err is delta's against the plain solve's; plain_ms is "
            "dist_cg_plain then dist_update_plain; latency_floor_ms is the launch "
            "without the stage on one row (one step), barrier_floor_ms an empty "
            "cooperative kernel on the same grid crossing as many barriers "
            "(barrier_floor_without_update_ms one fewer), grid_sync_floor_ms as "
            "many grid.syncs as the launch without the stage; unfused_* the "
            "kernel without the stage, L2 flushed"))}
    for name in DIST_KERNELS:
        check(refine_launches[name] > 0, f"{name} was never launched on its path")
    # the normal equations: the main run's launches, the times on its final
    # problem (SH1)
    normal_cases = {(c["case"], "pose" if "model" in c else "light"): c
                    for c in normal_facts["cases"]}
    normal_rows = {
        "pose_normal_eqs": dict(normal_cases["main SH1", "pose"], work=(
            f"the main run's pose block at its final state: "
            f"{normal_cases['main SH1', 'pose']['voxels']} surface-voxel slots x "
            f"{normal_cases['main SH1', 'pose']['keyframes']} keyframes (one "
            "launch: the tiles staged by bulk copies, their sums added in "
            "clusters, then by the last blocks); the "
            "bound counts g_img, p_cam, w and r read once (60 bytes a pair); "
            "library_ms is the one einsum nfcb,nfcd->fbd over the weighted "
            "pose Jacobian formed beforehand (its formation excluded)")),
        "light_normal_eqs_sh": dict(normal_cases["main SH1", "light"], work=(
            "the main run's SH1 light block at its final state (B = 4; one "
            "launch a call, as the pose's); the bound counts w and r read "
            "once (24 bytes a pair) and J_l once; library_ms is the one "
            "[F, 3N] x [3N, B*B] product wf @ JJ, its operands formed "
            "beforehand"))}
    for name in NORMAL_EQ_KERNELS:
        check(refine_launches[name] > 0, f"{name} was never launched on its path")
    # the albedo block: the main run's launches, the times on its final
    # problem (SH1, the recipe's reg albedo 0, scipy's stop rule)
    albedo_case = next(c for c in albedo_facts["cases"]
                       if c["case"] == "main SH1" and not c["static"])
    albedo_rows = {
        "albedo_block": dict(albedo_case["albedo_block"],
                             max_abs_err=albedo_case["max_abs_err"],
                             latency_floor_ms=albedo_facts["latency_floor_ms"], work=(
            f"the main run's albedo block at its final state in one cooperative launch: "
            f"{albedo_case['rows']} surface-voxel slots x {albedo_case['keyframes']} "
            "keyframes, SH1, the pairs bulk-copied into shared memory and J formed "
            f"per pair, then the whole Jacobi-PCG and accept rule ({albedo_case['steps']} "
            f"step, {albedo_case['grid_barriers']} grid barriers, "
            f"{albedo_case['plan']['blocks']} blocks of {albedo_case['plan']['tile']} "
            "voxels); the bound counts w and r read once (24 bytes a pair), the "
            "gradient, the mask and the albedo read and delta and the new albedo "
            "written (49 bytes a row); max_abs_err is delta's against the plain "
            "solve's; latency_floor_ms is the same launch on one row, "
            "barrier_floor_ms an empty cooperative kernel on the same grid crossing "
            "as many barriers; no single PyTorch call computes the block "
            "(einsum_b_ms: the one einsum that forms b alone)"))}
    for name in ALBEDO_KERNELS:
        check(refine_launches[name] > 0, f"{name} was never launched on its path")
    # the scan's preprocessing and the energies: the main run's launches,
    # the times on its first chunk and on its final problem (SH1, its loss)
    slice_rows = {
        "fals_normals": dict(prep_facts["timed"]["fals_normals"], work=(
            f"the first chunk's FALS normals: {CHUNK} frames of {W}x{H}, window "
            "11, one launch (a persistent grid over (32 x 32 tile, frame) units, a "
            "block walking the frames of its tile: the cache planes loaded once a "
            "tile, each frame's depth halo copied in while the one before "
            "computes), timed in the path's order before LAPM, no flush; the bound counts "
            "the depth, the cache (x0n, y0n, nsi, Q) and the normals once; no "
            "single PyTorch call computes it")),
        "lapm": dict(prep_facts["timed"]["lapm"], work=(
            f"the first chunk's LAPM sharpness: {CHUNK} frames of {W}x{H}, one "
            "launch (bands of rows, each row's span bulk-copied into a ring in "
            "shared memory, its x passes once, the y pass from registers, double "
            "partials, the last block by ticket), timed after the normals (their "
            "dirty lines in the L2); the bound counts the RGB frames read once; "
            "empty_launch_ms is an empty kernel on its grid in its place; no "
            "single PyTorch call computes it")),
        "energy_sums": dict(energy_facts["timed"]["energy_sums"], work=(
            f"the main run's four energies at its final state: "
            f"{energy_facts['timed']['rows']} surface-voxel slots x "
            f"{energy_facts['timed']['keyframes']} keyframes, "
            f"{REFINE_SH1['loss function']} loss, one launch of "
            f"{energy_facts['timed']['blocks']} persistent blocks (pair warps streaming "
            "groups of four pairs, row warps beside them), timed in the "
            "path's order "
            "after the residual pass, no flush; the bound counts the mask of every "
            "pair, r of each counted pair, valid, and a valid row's state and "
            "stencil once; no single PyTorch call computes it"))}
    slice_launches = {"fals_normals": main_run["slice"]["fals_normals"],
                      "lapm": main_run["slice"]["lapm"],
                      "energy_sums": refine_launches["energy_sums"]}
    for name in SLICE_KERNELS:
        check(slice_launches[name] > 0, f"{name} was never launched on its path")
    # the distance tail and the LED light: the main run's launches (the LED
    # light's: the LED run's), the times on their final problems in the
    # path's order
    # the standalone tail kernels run on the mesh paths (and the joint
    # block): their launches are mesh_refine's (a), (b), (c) and the
    # distributed ranks'; the one-card runs launch none (check_refine_launches)
    mesh_slices = [mesh_refine_facts["sh1"]["energy_launches"],
                   mesh_refine_facts["led_upsample"]["energy_launches"],
                   mesh_refine_facts["cli"]["preprocess_and_energy_launches"]] + [
        r[run]["slice"] for b in distributed_facts.values() if isinstance(b, dict)
        for r in b.get("ranks", []) for run in ("sh1", "led")]
    tail_launches = {name: refine_launches[name] + sum(sl[name] for sl in mesh_slices)
                     for name in ("reg_operators", "dist_update")}
    tail_launches["light_normal_eqs_led"] = led_run["slice"]["light_normal_eqs_led"]
    timed = tail_facts["timed"]
    tail_rows = {
        "reg_operators": dict(timed["reg_operators"], work=(
            f"the main run's Eikonal operator at its final state: {timed['rows']} "
            "surface-voxel slots, a thread a row (the standalone launch of the joint "
            "block and the mesh; launches: the mesh paths'), timed in the five-launch "
            "block's order (the operators, dist_system, dist_cg, the update), no flush; the bound "
            "counts valid, dist, the direction, the indices and the constants read "
            "once and r, J0, Ji written once; empty_launch_ms is a launch of an "
            "empty kernel timed the same way; no single PyTorch call computes it")),
        "dist_update": dict(timed["dist_update"], work=(
            f"the main run's accept rule and new gradient on its solve's step: "
            f"{timed['rows']} slots, each neighbour's acceptance recomputed in place "
            "(the standalone launch; launches: the mesh paths'), timed after dist_cg; "
            "the bound counts valid, dist, delta, the direction, "
            "the indices and the constants read once and the new distances and "
            "gradient written once; no single PyTorch call computes it")),
        "light_normal_eqs_led": dict(timed["light_normal_eqs_led"], work=(
            f"the LED run's light block after the upsample: {timed['led_rows']} "
            f"surface-voxel slots x {timed['led_keyframes']} keyframes, a warp's unit "
            "of voxels, each voxel's terms once and shuffled to its pairs' lanes, the "
            "lanes' own loads of w and r, the reflectance formed per pair, the sums "
            "in double, the last block by "
            "ticket, timed after the residual pass; the bound counts w and r read "
            "once (24 bytes a pair), the voxel's state once; empty_launch_ms is an "
            "empty kernel on its grid in its place; library_ms is one einsum "
            "nfc,nfck->ck forming H and g from w J and [J, r] formed beforehand"))}
    for name in TAIL_KERNELS:
        check(tail_launches[name] > 0, f"{name} was never launched on its path")
    # the SH light's eigen-solve: the main run's launches (a graph replay's
    # counted as its capture's), the times of its SH1 solve in the path's order
    solve_timed = solve_facts["timed"]["SH1"]
    sh2 = solve_facts["timed"]["SH2"]
    solve_rows = {"light_solve": dict(solve_timed, sh2={k: sh2[k] for k in (
        "ms", "earlier_ms", "rotations", "rounds_max", "max_abs_err", "bound_ms")},
        work=(
        f"the main run's SH1 light block at its final state: {solve_timed['keyframes']} "
        f"keyframes of a {solve_timed['basis']}x{solve_timed['basis']} Gram, a warp a "
        "keyframe, Jacobi in double in a parallel (round-robin) order: a round's "
        "disjoint rotations at once, one lane a pair, then J^T A J and V J over the "
        f"warp's lanes ({solve_timed['rotations']} rotations in all, at most "
        f"{solve_timed['rounds_max']} rounds that rotated a keyframe), the clip and the "
        "products, timed after light_normal_eqs_sh as the path runs it, in turns with "
        "the cyclic-order design it replaced (earlier_ms, tools/smallsolve_cyclic.cu; "
        "sh2: the same problem under SH2 lights); "
        "the bound counts H and g read and delta written once, and the rotations' and "
        "products' float64 operations at 34 TFLOP/s; empty_launch_ms is an empty kernel "
        "on its grid in its place; plain_ms is light_solve_plain (torch.linalg.eigh in "
        "float64, which waits for the host); library_ms is torch.linalg.eigh with the "
        "clip's products in float64, library_f32_ms in float32 (the port's solve before "
        "these kernels)"))}
    for name in SOLVE_KERNELS:
        check(refine_launches[name] > 0, f"{name} was never launched on its path")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOLVE_KERNELS[name][0],
             replaces=SOLVE_KERNELS[name][1], launches=refine_launches[name],
             max_abs_err=solve_rows[name]["max_abs_err"], ms=solve_rows[name]["ms"],
             plain_ms=solve_rows[name]["plain_ms"], bound_ms=solve_rows[name]["bound_ms"],
             bound_by=solve_rows[name]["bound_by"],
             library_ms=solve_rows[name]["library_ms"],
             library_f32_ms=solve_rows[name]["library_f32_ms"],
             empty_launch_ms=solve_rows[name]["empty_launch_ms"],
             **{k: solve_rows[name][k] for k in ("earlier_ms", "rotations", "rounds_max",
                                                 "sh2")},
             work=solve_rows[name]["work"])
        for name in SOLVE_KERNELS] + [
        dict(name=name, route="cuda", source=TAIL_KERNELS[name][0],
             replaces=TAIL_KERNELS[name][1], launches=tail_launches[name],
             max_abs_err=tail_rows[name]["max_abs_err"], ms=tail_rows[name]["ms"],
             plain_ms=tail_rows[name]["plain_ms"],
             bound_ms=tail_rows[name]["bound_ms"], bound_by="bytes",
             library_ms=tail_rows[name].get("library_ms"),
             **({} if tail_rows[name].get("library_ms") is not None else
                {"library_note": "no single PyTorch call computes it"}),
             ms_after_flush=tail_rows[name]["ms_after_flush"],
             empty_launch_ms=tail_rows[name].get("empty_launch_ms", timed["empty_launch_ms"]),
             work=tail_rows[name]["work"])
        for name in TAIL_KERNELS] + [
        dict(name=name, route="cuda", source=SLICE_KERNELS[name][0],
             replaces=SLICE_KERNELS[name][1], launches=slice_launches[name],
             max_abs_err=slice_rows[name]["max_abs_err"], ms=slice_rows[name]["ms"],
             plain_ms=slice_rows[name]["plain_ms"],
             bound_ms=slice_rows[name]["bound_ms"], bound_by="bytes",
             library_ms=None, library_note="no single PyTorch call computes it",
             ms_after_flush=slice_rows[name]["ms_after_flush"],
             **({"empty_launch_ms": slice_rows[name]["empty_launch_ms"]}
                if "empty_launch_ms" in slice_rows[name] else {}),
             work=slice_rows[name]["work"])
        for name in SLICE_KERNELS] + [
        dict(name=name, route="cuda", source=ALBEDO_KERNELS[name][0],
             replaces=ALBEDO_KERNELS[name][1], launches=refine_launches[name],
             max_abs_err=albedo_rows[name]["max_abs_err"], ms=albedo_rows[name]["ms"],
             plain_ms=albedo_rows[name]["plain_ms"],
             bound_ms=albedo_rows[name]["bound_ms"], bound_by="bytes",
             library_ms=albedo_rows[name]["library_ms"],
             latency_floor_ms=albedo_rows[name]["latency_floor_ms"],
             barrier_floor_ms=albedo_rows[name]["barrier_floor_ms"],
             einsum_b_ms=albedo_rows[name]["einsum_b_ms"], work=albedo_rows[name]["work"])
        for name in ALBEDO_KERNELS] + [
        dict(name=name, route="cuda", source=NORMAL_EQ_KERNELS[name][0],
             replaces=NORMAL_EQ_KERNELS[name][1],
             launches=refine_launches[name],
             max_abs_err=normal_rows[name]["max_abs_err"], ms=normal_rows[name]["ms"],
             plain_ms=normal_rows[name]["plain_ms"],
             bound_ms=normal_rows[name]["bound_ms"], bound_by="bytes",
             library_ms=normal_rows[name]["library_ms"], work=normal_rows[name]["work"])
        for name in NORMAL_EQ_KERNELS] + [
        dict(name=name, route="cuda", source=DIST_KERNELS[name][0],
             replaces=DIST_KERNELS[name][1], launches=refine_launches[name],
             max_abs_err=dist_rows[name]["max_abs_err"], ms=dist_rows[name]["ms"],
             plain_ms=dist_rows[name]["plain_ms"],
             bound_ms=dist_rows[name]["bound_ms"], bound_by="bytes",
             library_ms=dist_rows[name]["library_ms"],
             **({"earlier_ms": dist_rows[name]["earlier_ms"]}
                if "earlier_ms" in dist_rows[name] else {}),
             **{k: v for k, v in dist_rows[name].items() if k.startswith("unfused_")},
             **({"latency_floor_ms": dist_rows[name]["latency_floor_ms"],
                 "barrier_floor_ms": dist_rows[name]["barrier_floor_ms"],
                 "barrier_floor_without_update_ms":
                     dist_rows[name]["barrier_floor_without_update_ms"],
                 "grid_sync_floor_ms": dist_rows[name]["grid_sync_floor_ms"],
                 "library_note": "no single PyTorch call computes it"}
                if name == "dist_cg" else {}),
             work=dist_rows[name]["work"])
        for name in DIST_KERNELS] + [
        dict(name=name, route="cuda", source=REFINE_KERNELS[name][0],
             replaces=REFINE_KERNELS[name][1], launches=refine_launches[name],
             max_abs_err=main_case["max_abs_err"], ms=refine_rows[name]["ms"],
             plain_ms=refine_rows[name]["plain_ms"],
             bound_ms=refine_rows[name]["bound_ms"], bound_by="bytes",
             library_ms=None, library_note="no single PyTorch call computes it",
             work=refine_rows[name]["work"])
        for name in REFINE_KERNELS] + [
        dict(name=name, route="cuda", source=SCAN_KERNELS[name][0],
             replaces=SCAN_KERNELS[name][1], launches=scan_counts[name],
             max_abs_err=scan_rows[name]["max_abs_err"],
             ms=scan_rows[name]["ms"], plain_ms=scan_rows[name]["plain_ms"],
             bound_ms=scan_rows[name]["bound_ms"], bound_by="bytes",
             library_ms=scan_rows[name].get("library_ms"),
             library_note=scan_rows[name].get(
                 "library_call", "no single PyTorch call computes it"),
             **{k: scan_rows[name][k] for k in ("latency_floor_ms", "ms_after_flush", "earlier_ms")
                if k in scan_rows[name]},
             work=scan_rows[name]["work"])
        for name in SCAN_KERNELS] + [
        dict(name=name, route="cuda", source=SOURCE, replaces=KERNELS[name],
             launches=launches[name], max_abs_err=worst[name],
             ms=times[name]["ms"], plain_ms=times[name]["plain_ms"],
             bound_ms=times[name]["bound_ms"], bound_by="bytes",
             library_ms=times[name]["library_ms"],
             work="one fused frame: CAP=8192 rows of each of the five state "
                  "tables (3 x R=128, 2 x R=384, 4-byte elements) out of "
                  "N=16384; one call on the five tables, random indices of "
                  "which the second half repeats the first; the bound counts "
                  + ("the distinct rows only" if name in SCATTERS else
                     "the distinct rows read and every slot written"))
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
