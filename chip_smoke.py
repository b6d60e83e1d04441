#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths on `cuda` through `make_render_fn` (the frame
captured as a CUDA graph once per configuration and replayed, its
default; the kernel checks and the stage profiles run the frame eagerly),
in phases, each printing its result and seconds on a line of its own:

  * the bench `baseline` frame: the 5,120 triangle bunny BVH scene at
    1920x1080, 1 SPP, GI/AO/TAA/SVGF off (kernels K1, the BVH direct
    light, K5 with its shadow walks, the sky kernel on the misses, and the
    tonemap kernel, the present pass without SVGF);
  * the bench `an_baseline` frame: the analytic scene (floor, albedo,
    glass and mirror spheres, point-light marker) at 800x600 with the
    same preset and the gradient sky (kernel K3 and the tonemap kernel);
  * the bench `full` frame: the bunny scene at 1920x1080 with GI, AO,
    TAA and SVGF on at 1 SPP (K1 on primary rays and, sampling them
    itself, on GI's bounce rays; the BVH direct light at both hits; K2's
    AO call, sampling its own rays; the SVGF kernel K4 through its fused
    entry, the whole present pass in one launch), and the analytic
    scene's `full` preset against the CPU (K3 and K4).  The camera is
    still, and the host knows it: TAA runs its still path alone;
  * the bench `an_full` frame: the analytic scene at 1920x1080 with the
    `full` preset under the day-sky cubemap (cubemaps/sky_day.png through
    the port's loader and `env_from_numpy`): K3 seven times a frame,
    sampling the cubemap itself on its mirror and glass lanes, and K4's
    fused present;
  * the bench `heavy` frame: the bunny scene at 1920x1080 with 4 samples
    a pixel, shaded as one batch over a leading sample axis (a frame: the
    primary trace, AO and the present pass once; the bounce call once
    over every sample's rays, the BVH direct light twice: at the primary
    hits, its sun and point walks once a pixel for all samples, and at
    the bounce hits);
  * the bench `moving` frame: `full` with a camera that turns and dollies
    every frame (TAA's reprojection path, SVGF's motion-aware weights);
  * `full` and `moving` again as row bands (parallel/): each band traced,
    shaded and TAA'd on its own rows, K4 filtering it with its halo rows;
  * the bench's BVH-heavy scene (`measure_closefar`, bench.py:67-75,
    202-237): make_bunny(6), 81,920 triangles in a 32,767-node tree from
    the port's g++ builder, `baseline` at 1920x1080 under a close camera
    (the mesh on ~46% of the pixels: K1 and the direct light's six walks
    on live lanes) and a far one (~0.7%).

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every csrc/*.cu from the sources, one process
     per source, all at once; a line before the phase's gives
     bvh_direct_kernel's registers, spill and shared memory from ptxas;
  2b. native: the port's g++ library (native/) built from its sources
     (seconds); each entry against the port's numpy or Python form on this
     machine: the BVH of the 81,920 triangles passes validate_bvh (every
     triangle once, the input's multiset) and splits as the numpy
     builder's tree, with both builders' seconds; OBJ parse and triangle
     gather of every models/*.obj, every cubemap's reader (PNG defilter,
     HDR run-length decode, the JPEG entropy decode of sky_day.jpg) and
     the slicer on the 8-bit crosses give equal arrays, and a 1080p
     frame's JPEG encode equal bytes, with both routes' seconds; each
     entry's call counter (native.CALLS) above 0;
  3. kernels: each kernel on the exact inputs one frame hands it -- the
     closest-hit kernel, the BVH direct light and the tonemap kernel on a
     baseline frame's, the analytic direct-light kernel on every call of
     an an_baseline frame (each call with the mask of live lanes the
     frame hands it) and the tonemap kernel on that frame's accumulation
     too, the same kernel with the cubemap on every call of a 1080p
     an_full frame (a record of its own, `an_direct_env`, with the live
     mirror and glass lanes that sampled the map: not 0; each call's live
     lanes, bound and time alone in `calls_detail`), and on the
     third frame of a 1080p `full` chain
     the SVGF kernel's two entries (the filter alone, the fused present),
     the AO kernel (K2's AO call), the closest-hit kernel's GI
     bounce call and the BVH direct light at the bounce hits
     (unsanitized hits, sky lanes inactive) -- held against its plain
     PyTorch version on the card.  Closest hits: at most 1e-5 of lanes
     may differ in `valid`; on lanes both hit, t and the point within
     1e-5 relative to t, the unit normal within 1e-6; the bounce call's
     direction and cosine bit for bit on live lanes.  AO:
     equal on live lanes but for at most 1e-3 of them, each off by one
     sample step.  Direct light: the in-kernel disk offsets equal
     lighting._disk_offsets bit for bit (K3: on its live lanes);
     radiance within max abs 2e-6 (K3) and 1e-6 (BVH), on live lanes.
     SVGF's filter entry:
     rtol 1e-5 / atol 1e-5 on every pixel against the plain filter; the
     fused present and the tonemap kernel: max abs 2e-6 on every pixel
     against the plain present pass, and one device launch a call of
     `present`.  A NaN fails every check.
     Wrapper and plain times from CUDA events, the kernel alone and the
     launches of one direct-light call from the profiler (each window
     opened by throwaway launches; a kernel's time only from a window
     that counted exactly the launches it timed, as the launch counters
     count them; any other window, an empty one too, is taken again, up
     to PROFILE_ATTEMPTS times; a kernel time not kept is null); each
     kernel's bound
     (`bound_ms`) from the bytes and operations of these inputs;
  4. frames: 32 chained baseline frames; launch counters are zeroed just
     before and each kernel of the path (the tonemap kernel too) must
     have grown by at least 32;
     the image must be finite and in [0,1]; ms/frame, fps, primary
     Mrays/s and a checksum; the last frame goes to
     out/verify_torch_bvh.png;
  5. reference: one baseline frame at 270x480 on the card against the
     same frame from the plain versions on the CPU: max abs <= 2/255,
     99.9th percentile <= 1e-3;
  6. profile: one baseline frame under torch.profiler: device time by
     stage, by PyTorch operator and of each kernel, and the launches; the
     device's idle share of the unprofiled frame time;
  7-9. frames_analytic, reference_analytic (300x400), profile_analytic:
     the same three for the an_baseline frame; its last frame goes to
     out/verify_torch_analytic.png; the reference lists every pixel with
     a value over 1e-3 between card and CPU: its coordinates, the primary
     hit's material and t on both devices, and |n.v|;
  10. frames_full: 32 chained `full` frames at 1080p (they cross TAA's
     weight steps at frames 8 and 32); closest, bounce, ao, bvh_direct
     and svgf_present must each grow by at least 32; the last frame goes to
     out/verify_torch_full.png;
  11. reference_full: a 3-frame `full` chain at 270x480 on the card
     against the CPU, so that TAA's history is compared too; the gate of
     step 5;
  12. reference_analytic_full: the analytic `full` preset without the env
     map, a 3-frame chain at 150x200, card against CPU (analytic GI and
     AO, mirror GI, TAA, K3 and K4 together); the gate of step 5;
  13. profile_full: the third frame of a `full` chain at 1080p by stage
     (primary trace, direct light, GI with its bounce trace, AO, TAA,
     SVGF, present);
  14. taa_skip: the `full` chain again with the host flag unknown (TAA's
     branch-free form): its checksum must equal frames_full's, which ran
     the skip; TAA's stage time, the device time and the launches of one
     profiled frame each way;
  15-17. frames_an_full (K3 exactly 7 times and svgf_present once a
     frame; the last frame goes to out/verify_torch_an_full.png),
     reference_an_full (150x200, 3 frames, with the cubemap on both
     devices), profile_an_full (the sky kernel's cubemap lookups as
     stages sky#n);
  17b. an_gates: the analytic scene's live-lane kernels (csrc/an_trace.cu:
     the trace, AO, GI bounce and sky kernels, the port's form of the JAX
     package's occupancy gates) on every call of a 1080p an_full frame
     (sky_day.png; 1, 1, 2 and 3 calls) and of an 800x600 an_baseline
     frame (1 trace, 1 sky), the third of a chain, each on its recorded
     inputs against its dense plain version on the card, with the frame's
     own mask, none, a partial one and an empty one: every output bit for
     bit on the live lanes (a difference is printed with its size and
     fails the phase), one launch a call; the an_full AO call again at
     every (ao_radius, ao_samples) of 0.05, 0.8, 4.0 by 1, 4, 32 the same
     way (AO_SWEEP); each call's live lanes, bound (bytes at 3.35 TB/s or
     operations at 67 TFLOP/s, from the live lanes' work; a call measured
     below its bound fails the phase, as in 17c and hit_mix), share,
     wrapper, kernel and plain times; each kernel's launches
     a frame in frames_an_full and frames_analytic (an_full: an_trace 1,
     an_ao 1, an_bounce 2, sky 3, exactly; an_baseline: an_trace 1, sky
     1; the mirror's and glass's traces and skies are their rays
     kernels', step 17c);
  17c. an_shade: glass's and the mirror's rays and mix kernels
     (csrc/an_shade.cu: an_glass_rays_kernel, an_glass_mix_kernel,
     an_mirror_ray_kernel, an_mirror_mix_kernel, the rest of the JAX
     package's glass and mirror tile gate) on every call of the same two
     frames (one call each a frame), each on its recorded inputs against
     its dense plain version on the card (lighting.glass_rays_plain,
     glass_mix_plain, mirror_ray_plain, mirror_mix_plain), with the
     frame's own mask, none, a partial one and an empty one: every output
     bit for bit on the live lanes where the kernel writes it (a rays
     kernel's skies where the mix reads them), a mix's `out` untouched on
     its dead lanes, one launch a call; each call's live lanes, bound
     (bytes: the mask, the live rows in and out), wrapper, kernel and
     plain times; each kernel's launches a frame in frames_an_full and
     frames_analytic (one each, exactly);
  18-20. frames_heavy (a frame: closest 1, bvh_direct 2, bounce 1, ao 1,
     svgf_present 1, sky 1, bvh_hit_mix 1, exactly; as a host loop of
     samples it was bvh_direct 8 and bounce 4, and before the hit-mix
     kernel sky 2), reference_heavy (270x480, 3 frames), profile_heavy;
  20b. hit_mix: both scenes' shading tails (csrc/hit_mix.cu:
     bvh_hit_mix_kernel, an_hit_mix_kernel, the rest of the JAX package's
     hit gates) on every call of a 1080p `full` and `heavy` frame, an
     an_full frame (sky_day.png), an 800x600 an_baseline frame and the
     1080p analytic `heavy` frame of phase spp_batch (4 samples), the
     third of a chain, each on its recorded inputs against its dense plain
     version on the card (lighting.bvh_hit_mix_plain, an_hit_mix_plain),
     with the frame's own mask, none, a partial one and an empty one: the
     radiance bit for bit on the live lanes the kernel writes (the
     analytic one: diffuse and marker lanes), every other lane of `out`
     untouched, one launch a call; each call's live lanes, bound (bytes:
     the mask, the rows a live lane reads and writes, the sky's texels),
     wrapper, kernel and plain times; the launches a frame (one hit-mix
     launch a GI or AO frame, `sky` once on the BVH frames);
  21-24. frames_moving, reference_motion_view (the motion debug wheel of
     the second frame of a moving pair, 270x480), reference_moving (3
     frames), profile_moving;
  25. reference_raster: `render_raster` at 270x480, the mesh through the
     closest-hit kernel, against the CPU: flat colours, equal but on tie
     lanes (at most 1e-4 of the pixels);
  25b-25f. the BVH-heavy scene: frames_cf_close and frames_cf_far (32
     chained frames each; closest, bvh_direct, tonemap and sky (the
     misses' environment) exactly once a frame, every other counter 0;
     ms/frame, the checksum, and from one profiled frame the device
     time, launches and idle share; the close frame goes to
     out/verify_torch_cf_close.png), kernels_cf (K1's
     primary call and the BVH direct light on a cf_close frame's inputs
     under step 3's gates: times, bound, share, the live lanes' share,
     node visits and triangle tests per ray or live lane; K1 on the numpy
     builder's tree of the same triangles: t bit for bit where both hit),
     reference_cf (both cameras at 270x480 under step 5's gate),
     profile_cf_close (the stage table);
  25g. graph: the compiled frame (models/graph.py: `render_frame`
     captured once per configuration as a CUDA graph and replayed, the
     main path of every frames phase above), for each of the eight cases
     those phases render at their sizes (baseline, an_baseline, full,
     an_full, heavy, moving, cf_close, cf_far): after one chain that
     captures, 32-frame chains eager and replayed in turns (eager,
     replayed, replayed, eager): every chain's checksum the same bits and
     PR 11's (PR11_CHECKSUMS); the kernels' launches a replayed frame
     those of an eager frame; one capture, every other frame a replay;
     ms/frame both ways and the graph's memory; one warm frame each way,
     its inputs staged inside the profiled window as a caller stages
     them: device ms and operations, at most one host-to-device copy (the
     frame block; the profiler may lose a record), at most one copy call
     eager and three replayed (the frame block's and the parameter
     block's device copies into the graph's),
     no cudaStreamSynchronize, and the host's cudaLaunchKernel and
     cudaGraphLaunch calls; each kernel's launches in replayed frames as
     the profiler sees the card run them, equal to what the counters add
     a replay (the kernels line's `replay_launches_profiled` beside
     `replay_launches`).  Then the app's `--scene bvh --preset
     full --turbo 8` (a moving step, then still ones: the moving key, then
     the still key) with `--jit` and `--no-jit`, 30 frames in 4 steps:
     every step's image and the accumulation bit for bit;
  25g'. spp_batch: the sample batch of `heavy` at 1920x1080 (the samples
     of a frame shaded as one pass over a leading sample axis, each
     kernel of that pass taking the axis inside one launch).  On the
     third frame's inputs of a 1080p `heavy` chain: the BVH direct light
     at the primary hits (spp_dup: the sun and point walks once a pixel,
     shared by the 4 samples), the GI bounce call over the 4 samples'
     rays and the BVH direct light at their hits, each against its plain
     version under step 3's gates; the analytic direct light (K3) on
     every call of a 1080p analytic `heavy` frame (4 samples) at K3's
     gate.  Each batched call's times and bound beside one single-sample
     call's kernel time times 4.  The batched frame
     (`trace_and_shade`) against the 4 single-sample shadings of the same
     kernels, each with its seed frame * 4 + s, with the sky select,
     summed in sample order and divided by 4: bit for bit on the card,
     BVH and analytic, with both forms' launches and eager device ms.
     `heavy`'s launches a frame (bvh_direct 2, bounce 1) and phase
     graph's replayed `heavy` frame (device ms, operations, graph MB)
     beside the frame with the samples as a host loop (4.501 ms, 305
     operations, 604 MB on an H100 80GB HBM3 at 700 W);
  25h. params: the parameter block (models/param_block.py: every data
     field of RenderParams on the device, so that a captured frame is
     keyed on the static fields alone).  The app at 1920x1080, `--scene
     bvh --preset full` and the analytic `full` with
     cubemaps/sky_day.png: 16 steps, each changing another data field
     through the viewer's /set path (PARAM_SWEEP: exposure, sun yaw,
     point-light intensity, SVGF strength, a TAA weight, AO radius, a
     material colour, env intensity, ...), then 32 `--orbit` steps; each
     with `--jit` and `--no-jit`: every step's image and the last
     accumulation bit for bit, one capture per run (one static
     configuration), no eager frame under `--jit`; ms a step both ways
     (the first step of a replayed run, which captures, apart), the
     captures and the graphs' MB before and after;
  25i. raster: the app's raster preview (F2) as a replay of its CUDA graph
     (models/graph.py:render_raster, the JAX package's jitted
     `_raster_fn`): `--scene bvh --preset full --orbit` at 1920x1080, 16
     steps (the orbit moves the point light's marker every step; its
     colour is set through /set before step 8), `--jit` against
     `--no-jit`: every step bit for bit, one capture and 15 replays, K1
     (`trace_closest`) once a step either way, ms a step both ways;
  26. app_headless: the app layer as a user drives it, 1920x1080, through
     `app.headless`'s parser, `make_app` and `Application.step`:
     (a) `--scene bvh --preset full`, 32 still frames: the sum of the
     steps' images equals frames_full's checksum bit for bit, with
     frames_full's launches a frame (closest 1, bvh_direct 2, bounce 1, AO
     1, svgf_present 1, sky 1, bvh_hit_mix 1); (b) `--scene analytic --preset full --env
     cubemaps/sky_day.png`: frames_an_full's checksum, K3 7 times a frame;
     (c) `--model models/bunny_lp.obj --env cubemaps/sky_noon.hdr
     --camera-anim dolly`: 8 frames finite and in [0,1], and the card
     app's third frame at 270x480 against the CPU app's under the gate of
     step 5; (d) `headless.main` with `--snapshot` after 16 frames, then
     `--resume` for 16 more: the last image bit-equal to (a)'s, and every
     resumed step's sum equal to (a)'s; (e) that `main` call's
     frame_last.png decodes to 1080x1920x3; (f) make_bunny(6) written as an
     OBJ file and loaded by `--model`: the load's seconds, the native
     entries it called, the app's tree prepare_bvh's of the file's
     triangles and its 32 frames' sum a render_frame chain's, bit for
     bit.  The app's ms/frame beside
     frames_full's and, in turns (render_frame, app, app, render_frame),
     32-frame chains of each; one step's device launches and
     host-to-device copies beside one `render_frame` call's, from the
     profiler;
  27. app_viewer: the HTTP viewer in process (`ViewerState` and
     `make_handler` on 127.0.0.1, BVH `full` at 1080p, the viewer's 8
     frames a step): /frame.png until 3 distinct frames were served, each
     decoding to 1080x1920x3; /act?name=move_w moves /state's camera,
     /set?exposure=2 sets the exposure, /act?name=quit ends the render
     loop; no failed frame.  Frames served, and the stream's frames/s
     over 5 s with the host's ms a turn in the step and in the encode;
     then the viewer again with `--stream-format jpeg` (the native entropy
     coder): frames/s over 5 s, the host's ms a turn in the step and in the
     JPEG encode, one fetched frame decoding to 1080x1920x3;
  28. sharded: the multi-GPU row-band renderer (opengl_raytracing_tpu_
     torch/parallel/), 1080 rows in 4 bands of 270: (a) K4's two filter
     entries on each band of the third `full` frame's planes, with 3 halo
     rows of its neighbours (zeros past the edge): the filter entry equals
     the plain band filter bit for bit, the fused entry the plain band
     present pass within max abs 2e-6, and the stitched bands equal the
     whole-image kernel's output bit for bit; one band call's times and
     bound; (c) the four bands of each frame in turn on this card
     (`render_bands_in_turn`: `band_shade`, then `band_present` with the
     halos and the gathered history sliced from the other bands), `full`
     and `moving`, 3 frames each, counters zeroed before, every kernel of
     the `full` path launched: every frame's stitched image and the last
     accumulation equal render_frame's bit for bit, mean_lum within 1e-4
     of the host's; (b) a one-rank NCCL group on this card through
     `make_sharded_render_fn`, its compiled step (parallel/graph.py: one
     CUDA graph a rank, the history all-gather on every moving frame, the
     halo ring with no neighbour and the luminance all-reduce captured in
     it), the `full` and `moving` chains of 32 frames after a warm frame
     that captures, counters zeroed before: checksums equal frames_full's
     and frames_moving's, one capture a key, 32 replays, no eager frame
     after the capture, the gathered last image's mean luminance the
     all-reduce's; each chain again in lockstep with the eager step, every
     frame's image, accumulation and mean_lum bit for bit, the two chains'
     launches equal (the eager one's counted where the wrappers launch);
     a warm replayed frame under the profiler: 0 cudaLaunchKernel, 1
     cudaGraphLaunch, no stream synchronization; each kernel's launches in
     replayed band frames as the profiler sees the card run them, equal
     to what the counters add a replay (the kernels line's
     `sharded_replay_launches_profiled` beside `sharded_replay_launches`);
     the graphs' memory; `full` chains in turns:
     render_frame replayed, the band step replayed, the band step eager,
     render_frame replayed; where the machine has two cards or more,
     min(cards, 4) NCCL ranks, one a card, in processes of their own
     (`sharding.spawn_ranks`), each replaying its compiled step: rank 0's
     gathered `full` and `moving` frames equal (c)'s single-card frames
     bit for bit, every rank's mean_lum within 1e-4 of the host's
     reduction of the gathered image.  With one card it says so on a line
     of its own;
  29. bench: `python3 bench_torch.py` at its defaults (the nine cases of
     bench.py, each a warm chain and five timed chains of 32 frames in a
     child process): rc 0, nine case lines with no error; each case's
     checksum equal bit for bit to that of the frames phase of the same
     configuration (frames, frames_full, frames_heavy, frames_moving,
     frames_analytic, frames_an_full, frames_cf_close, frames_cf_far), and
     its kernel launches a frame that chain's; `realistic` (no other phase
     renders it) a finite checksum and closest 1, bvh_direct 2, bounce 1,
     ao 1, tonemap 1, sky 1, bvh_hit_mix 1 a frame.  Each case's median ms/frame and spread.

Any failure raises, so the script exits non-zero.  It needs one CUDA
card and exits non-zero, printing no result, without one.  Before the
last line it prints the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import importlib
import inspect
import json
import os
import re
import subprocess
import sys
import time

HEIGHT, WIDTH = 1080, 1920
AN_HEIGHT, AN_WIDTH = 600, 800
FRAMES = 32
REF_HEIGHT, REF_WIDTH = 270, 480
AN_REF_HEIGHT, AN_REF_WIDTH = 300, 400
AN_FULL_REF_HEIGHT, AN_FULL_REF_WIDTH = 150, 200
REF_FRAMES = 3         # the `full` references chain frames: TAA history
SHARD_BANDS = 4        # phase sharded cuts 1080 rows into 4 bands of 270
SHARD_FRAMES = 3       # frames of its four-band and multi-card chains
STREAM_SECONDS = 5.0   # the viewer's stream rate is read over this window
# the BVH-heavy scene (bench.py:67-75, measure_closefar): make_bunny(6),
# 81,920 triangles, the baseline preset, a close and a far still camera
HEAVY_SUBDIV = 6
CF_CAMERAS = {"cf_close": (-2.0, 1.6, 1.2), "cf_far": (0.0, 2.0, 8.0)}
CF_LOOK_AT = (-2.0, 1.5, 0.0)
CF_LAUNCHES = dict(closest=1, bvh_direct=1, tonemap=1, bounce=0, ao=0,
                   an_direct=0, svgf=0, svgf_present=0, an_trace=0, an_ao=0,
                   an_bounce=0, sky=1, bvh_hit_mix=0, an_hit_mix=0)
# phase bench: bench_torch.py's nine cases, and realistic's launches a
# frame (its present pass without SVGF is the tonemap kernel)
BENCH_CASES = ("baseline", "realistic", "full", "heavy", "an_baseline",
               "an_full", "cf_far", "cf_close", "moving")
REALISTIC_LAUNCHES = dict(closest=1, bvh_direct=2, bounce=1, ao=1, tonemap=1,
                          sky=1, bvh_hit_mix=1)
BENCH_TIMEOUT_S = 600
PROFILE_FRAME = 3      # the `full` profile times frame 3 (TAA resolves)
PROFILE_ATTEMPTS = 6   # profiles of one measurement before "not measured"
PROFILE_LEAD = 8       # throwaway launches that open a profile window
LEAD_KERNEL = "spin_kernel"  # theirs: torch.cuda._sleep's
LEAD_CYCLES = 1000     # each spins this many cycles (~0.5 us)
MISMATCH_FRAC = 1e-5   # lanes allowed to differ in valid
AO_FLIP_FRAC = 1e-3    # live AO lanes that may differ, by one sample step
T_RTOL = 1e-5          # t, and p relative to t, on lanes both kernels hit
N_ATOL = 1e-6          # the unit normal on lanes both kernels hit
RAD_RTOL, RAD_ATOL = 1e-4, 1e-5  # direct-light radiance on valid lanes
K3_MAX_ABS = 2e-6      # K3 vs the plain version: the libraries' powf
# the fused present and the tonemap kernel vs the plain present pass: the
# kernel's powf (built with --fmad=false) and PyTorch's pow may round the
# last bits of the gamma curve apart; everything before it is the same bits
PRESENT_MAX_ABS = 2e-6
BVH_DIRECT_MAX_ABS = 1e-6  # the BVH direct light, on live lanes
SVGF_TOL = 1e-5        # SVGF kernel vs plain filter, rtol and atol
ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = {  # wrapper key -> record of the JSON line
    "closest": dict(name="trace_closest",
                    source="opengl_raytracing_tpu_torch/csrc/bvh_trace.cu",
                    replaces="opengl_raytracing_tpu/ops/bvh_mxu.py:684",
                    kernel="trace_closest_kernel"),
    "bounce": dict(name="trace_bounce",
                   source="opengl_raytracing_tpu_torch/csrc/bvh_trace.cu",
                   replaces="opengl_raytracing_tpu/ops/bvh_mxu.py:684",
                   kernel="trace_bounce_kernel"),
    "ao": dict(name="ambient_occlusion",
               source="opengl_raytracing_tpu_torch/csrc/bvh_trace.cu",
               replaces="opengl_raytracing_tpu/ops/bvh_mxu.py:1021",
               kernel="ambient_occlusion_kernel"),
    "an_direct": dict(name="an_direct_light",
                      source="opengl_raytracing_tpu_torch/csrc/an_direct.cu",
                      replaces="opengl_raytracing_tpu/ops/an_pallas.py:162",
                      kernel="an_direct_light_kernel"),
    "an_direct_env": dict(name="an_direct_light_env",
                          source="opengl_raytracing_tpu_torch/csrc/an_direct.cu",
                          replaces="opengl_raytracing_tpu/ops/an_pallas.py:162",
                          kernel="an_direct_light_kernel",
                          counter="an_direct"),
    "bvh_direct": dict(name="bvh_direct",
                       source="opengl_raytracing_tpu_torch/csrc/an_direct.cu",
                       replaces="opengl_raytracing_tpu/ops/an_pallas.py:307",
                       kernel="bvh_direct_kernel"),
    "svgf": dict(name="svgf_filter",
                 source="opengl_raytracing_tpu_torch/csrc/svgf.cu",
                 replaces="opengl_raytracing_tpu/ops/svgf_pallas.py:68",
                 kernel="svgf_kernel"),
    "svgf_present": dict(name="svgf_present",
                         source="opengl_raytracing_tpu_torch/csrc/svgf.cu",
                         replaces="opengl_raytracing_tpu/ops/svgf_pallas.py:68",
                         kernel="svgf_present_kernel"),
    "tonemap": dict(name="tonemap",
                    source="opengl_raytracing_tpu_torch/csrc/svgf.cu",
                    replaces="opengl_raytracing_tpu/ops/svgf.py:174",
                    kernel="tonemap_kernel"),
    # the analytic scene's live-lane kernels: port-only, they replace no
    # TPU kernel but the JAX package's jnp code behind its occupancy
    # gates (`replaces` names that code)
    "an_trace": dict(name="an_trace",
                     source="opengl_raytracing_tpu_torch/csrc/an_trace.cu",
                     replaces="opengl_raytracing_tpu/ops/scene_analytic.py:40",
                     kernel="an_trace_kernel", wrapper="trace",
                     port_only=True),
    "an_ao": dict(name="an_ao",
                  source="opengl_raytracing_tpu_torch/csrc/an_trace.cu",
                  replaces="opengl_raytracing_tpu/ops/lighting.py:603",
                  kernel="an_ao_kernel", wrapper="ambient_occlusion",
                  port_only=True),
    "an_bounce": dict(name="an_bounce",
                      source="opengl_raytracing_tpu_torch/csrc/an_trace.cu",
                      replaces="opengl_raytracing_tpu/ops/lighting.py:411",
                      kernel="an_bounce_kernel", wrapper="bounce",
                      port_only=True),
    "sky": dict(name="sky",
                source="opengl_raytracing_tpu_torch/csrc/an_trace.cu",
                replaces="opengl_raytracing_tpu/ops/scene.py:220",
                kernel="sky_kernel", wrapper="sky", port_only=True),
    # glass's and the mirror's rays and mix kernels: port-only, the JAX
    # package's shade_glass and shade_mirror behind its glass and mirror
    # tile gate (`replaces` names them)
    "glass_rays": dict(name="an_glass_rays",
                       source="opengl_raytracing_tpu_torch/csrc/an_shade.cu",
                       replaces="opengl_raytracing_tpu/ops/lighting.py:511",
                       kernel="an_glass_rays_kernel", wrapper="glass_rays",
                       port_only=True),
    "glass_mix": dict(name="an_glass_mix",
                      source="opengl_raytracing_tpu_torch/csrc/an_shade.cu",
                      replaces="opengl_raytracing_tpu/ops/lighting.py:511",
                      kernel="an_glass_mix_kernel", wrapper="glass_mix",
                      port_only=True),
    "mirror_ray": dict(name="an_mirror_ray",
                       source="opengl_raytracing_tpu_torch/csrc/an_shade.cu",
                       replaces="opengl_raytracing_tpu/ops/lighting.py:584",
                       kernel="an_mirror_ray_kernel", wrapper="mirror_ray",
                       port_only=True),
    "mirror_mix": dict(name="an_mirror_mix",
                       source="opengl_raytracing_tpu_torch/csrc/an_shade.cu",
                       replaces="opengl_raytracing_tpu/ops/lighting.py:584",
                       kernel="an_mirror_mix_kernel", wrapper="mirror_mix",
                       port_only=True),
    # both scenes' shading tails: port-only, the JAX package's jnp code
    # behind its hit gates (`replaces` names the gated shading calls)
    "bvh_hit_mix": dict(name="bvh_hit_mix",
                        source="opengl_raytracing_tpu_torch/csrc/hit_mix.cu",
                        replaces="opengl_raytracing_tpu/models/pipeline.py:"
                                 "477",
                        kernel="bvh_hit_mix_kernel", wrapper="bvh_hit_mix",
                        port_only=True),
    "an_hit_mix": dict(name="an_hit_mix",
                       source="opengl_raytracing_tpu_torch/csrc/hit_mix.cu",
                       replaces="opengl_raytracing_tpu/models/pipeline.py:"
                                "317",
                       kernel="an_hit_mix_kernel", wrapper="an_hit_mix",
                       port_only=True),
}
GATE_KERNELS = ("an_trace", "an_ao", "an_bounce", "sky")
SHADE_KERNELS = ("glass_rays", "glass_mix", "mirror_ray", "mirror_mix")
HIT_MIX_KERNELS = ("bvh_hit_mix", "an_hit_mix")
# the launch counters each path must move (ops/cuda_lib.py:LAUNCHES, one
# per kernel); no path launches "svgf", the filter entry alone: `full`
# enters the same body through svgf_present
BVH_PATH = ("closest", "bvh_direct", "tonemap", "sky")
AN_PATH = ("an_direct", "tonemap", "an_trace", "sky", "an_hit_mix") \
    + SHADE_KERNELS
FULL_PATH = ("closest", "bounce", "ao", "bvh_direct", "svgf_present", "sky",
             "bvh_hit_mix")
AN_FULL_PATH = ("an_direct", "svgf_present", "an_trace", "an_ao",
                "an_bounce", "sky", "an_hit_mix") + SHADE_KERNELS
# launches a frame.  an_full: K3 at the primary hits, at their GI bounce,
# at the mirror's hit and its GI bounce, at the glass's three secondary
# hits.  heavy: the 4 samples shade as one batch: the direct light once at
# the primary hits (spp_dup) and once at the bounce hits, one bounce call;
# the primary trace, AO (hoisted out of the samples) and the present pass
# run once.  As a host loop of samples each sample was a call of its
# own: bvh_direct 8, bounce 4.
AN_FULL_LAUNCHES = dict(an_direct=7, svgf_present=1, tonemap=0)
# the analytic scene's trace, AO, bounce and sky kernels a frame: the
# primary trace and sky, AO, the bounce and sky of GI at the primary and
# the mirror's hit; the mirror's ray and mix, glass's rays and mix (their
# traces and skies inside: before those kernels, an_trace 5 and sky 7);
# the hit mix (GI's tail, AO's product, the marker); an_baseline has no
# GI or AO
AN_FULL_LAUNCHES.update(an_trace=1, an_ao=1, an_bounce=2, sky=3,
                        an_hit_mix=1, bvh_hit_mix=0,
                        **{k: 1 for k in SHADE_KERNELS})
AN_BASELINE_LAUNCHES = dict(an_direct=5, tonemap=1, an_trace=1, an_ao=0,
                            an_bounce=0, sky=1, an_hit_mix=1, bvh_hit_mix=0,
                            **{k: 1 for k in SHADE_KERNELS})
# heavy's sky: the primary misses; GI's sky is the BVH hit mix's (before
# it, sky 2 and no hit-mix launch)
HEAVY_LAUNCHES = dict(closest=1, bvh_direct=2, bounce=1, ao=1,
                      svgf_present=1, svgf=0, tonemap=0, sky=1,
                      bvh_hit_mix=1, an_hit_mix=0)
HEAVY_SPP = 4          # the heavy preset's samples a pixel
# the kernels that take a leading sample axis inside one launch
SAMPLE_AXIS_KERNELS = ("bvh_direct_kernel", "trace_bounce_kernel",
                       "an_direct_light_kernel", "an_trace_kernel",
                       "an_bounce_kernel", "sky_kernel", "bvh_hit_mix_kernel",
                       "an_hit_mix_kernel")
# a replayed `heavy` frame with the samples as a host loop (H100 80GB
# HBM3, 700 W): its device ms, operations and graph MB
HEAVY_LOOP = dict(device_ms=4.501, device_ops=305, pool_mb=604)

# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# memory rate and its operations over the float32 rate outside the tensor
# cores (H100 SXM, NVIDIA's data sheet, at the 700 W limit).  Operations
# are counted from the kernels' expressions, each add, multiply,
# comparison, select, conversion or library call (sqrtf, powf, cosf)
# as one, for the work these inputs need: the walks' node visits and
# triangle tests as the plain walk counts them, the direct-light terms of
# the lanes that compute them.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS = dict(
    node=25,            # slab test: 6 sub, 6 mul, 11 min/max, 2 compares
    tri=52,             # Moller-Trumbore with its window
    normalize=11,
    cp_rot=46,          # two rand draws, two adds, two remainders
    offset=66,          # a sample's two rand draws, remainders, concentric
    disk_point=14,
    query=23,           # a segment shadow query
    facing=12,          # the BVH query's two ndl gates
    brdf=75,            # a light's geometry term and Lambert-Phong
    sun=6, sky=13, point=30,  # the light's own setup
    env=60,             # a mirror/glass pixel: normalize, reflect, sky
    cubemap=77,         # ... and the cubemap lookup in the gradient's place:
                        # the face select 17, two divisions and s, t 6, the
                        # taps 22, rows and indices 14, three lerps a
                        # channel 18
    svgf_pixel=40,      # the centre pixel's weights
    svgf_tap=41,        # one in-bounds tap
    present_pixel=45,   # per channel: the blend 3, exposure 1, the ACES
                        # quotient 8, the clamp 2, powf 1
    rand=23,            # one sampling.rand draw: adds, max, conversions,
                        # key xors, hash2 (4 LCGs, 2 shifts, 3 xors), / 2^32
    onb=34,             # build_onb: the up select, cross, normalize, cross
    hemisphere=46,      # sample_hemisphere_cosine but its ONB: phi, sqrt,
                        # cos, sin, normalize(n), the sum, normalize
    origin=6,           # p + n * offset
    cos=6,              # max(dot(n0, wi), 0)
    ao_remap=7,         # occ / S, the remap and the clamp
    hit_out=17,         # p = o + d*t and the unit normal
    # K3's diffuse lane (csrc/an_direct.cu), by the work it needs:
    add3=3,             # a term added to the sum, or the sum / 4
    an_segment=26,      # a disk sample's segment: xl - p 3, its dot 5,
                        # max_t 2, ln 1, the direction 3 (also the term's
                        # l), seps 2, the origin 6, the occlusion test 4
    phong=42,           # lambert_phong given l: ndl 6, kd 1, h 14, ndh 6,
                        # powf 1, spec 3, the ndl gate 2, out 9
    an_disk=20,         # the disk term's geometry: ndl 6, the light's
                        # cosine 6, r2 1, geom 2, visibility 2, li 3
    an_sun=19,          # the sun's: l 3, the shadow origin 6, blocked 1,
                        # ndl 6, the select 3
    an_point=41,        # the point light's: to_l 3, dist2 5, dist 2, l 3,
                        # ndl 6, peps 2, the origin 6, blocked 4, the
                        # falloff 2, li 3, the select 5
    an_floor=20,        # a trace's floor test: denom 5, the safe
                        # denominator 3, tf 8, its tests and select 4
    an_sphere=17,       # a sphere's disc test: oc 3, b 5, c 6, disc 2, the
                        # gate 1 (a missed sphere stops there)
    an_root=11,         # ... where disc >= 0: the clamp and sqrtf 2, the
                        # roots 3, t 2, the tests and select 4
)


def unique_bytes(*tensors):
    """Bytes of the distinct tensors among `tensors` (None skipped), each
    counted by its distinct elements: a broadcast view counts its
    storage, not its shape."""
    seen, total = set(), 0
    for x in tensors:
        if x is None:
            continue
        key = (x.data_ptr(), tuple(x.shape), tuple(x.stride()))
        if key in seen:
            continue
        seen.add(key)
        n = 1
        for size, stride in zip(x.shape, x.stride()):
            n *= size if stride else 1
        total += n * x.element_size()
    return total


def bound(n_bytes, n_ops):
    """{bound_ms, bound_by, bytes, ops} of a kernel call."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_bytes=n_bytes, bound_ops=n_ops)


def bvh_bytes(arrays):
    return unique_bytes(arrays.bounds, arrays.meta, arrays.tris)


def walk_ops(counts):
    return counts["nodes"] * OPS["node"] + counts["tris"] * OPS["tri"]


def ptxas_of(log, kernel):
    """`kernel`'s registers, spill and shared memory, from the lines ptxas
    printed for it in the build log `log`."""
    with open(log) as fh:
        lines = fh.read().splitlines()
    at = [i for i, ln in enumerate(lines)
          if "Compiling entry function" in ln and kernel in ln]
    if len(at) != 1:
        raise AssertionError(f"ptxas compiled {kernel} {len(at)} times in "
                             f"{log}")
    text = " ".join(lines[at[0] + 1:at[0] + 4])

    def num(pattern):
        m = re.search(pattern, text)
        return int(m.group(1)) if m else 0
    return dict(kernel=kernel, registers=num(r"Used (\d+) registers"),
                spill_stores=num(r"(\d+) bytes spill stores"),
                spill_loads=num(r"(\d+) bytes spill loads"),
                stack_bytes=num(r"(\d+) bytes stack frame"),
                smem_bytes=num(r"(\d+) bytes smem"))


def phase(label, t0, **result):
    print(f"phase {label}: ok {time.time() - t0:.2f}s "
          + json.dumps(result, sort_keys=True), flush=True)


def scene(device, subdiv=4):
    """(tris, the BVH on `device`) of make_bunny(subdiv) placed as the
    bench places it: 5,120 triangles at 4, 81,920 at HEAVY_SUBDIV."""
    from opengl_raytracing_tpu_torch.constants import (DEFAULT_BVH_SCALE,
                                                       DEFAULT_BVH_TRANSLATE)
    from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
    from opengl_raytracing_tpu_torch.scene import (gather_triangles,
                                                   make_bunny,
                                                   model_transform)
    tris = gather_triangles(make_bunny(subdiv),
                            model_transform(DEFAULT_BVH_TRANSLATE,
                                            DEFAULT_BVH_SCALE))
    return tris, prepare_bvh(tris, device)


def frame_inputs(height, width, frames, device, preset_name="baseline",
                 camera="still", moved="host"):
    """The FrameInputs of `frames` chained frames.  camera="still": the
    bench's static camera with Halton jitter scaled by jitter_still_scale
    (bench.py:_run_frames).  camera="moving": the bench's moving camera
    (bench.py:measure_moving): yaw += 0.4 and a dolly of -0.05 along z a
    frame, jitter scaled by jitter_moving_scale, the previous frame's
    view-projection, camera_moved = 1.  camera="cf_close" / "cf_far":
    bench.py's measure_closefar cameras (CF_CAMERAS, looking at
    CF_LOOK_AT), still.  moved="host" keeps the host flag
    as the camera fills it (False for the still camera: TAA's skip); None
    marks it unknown (TAA's branch-free form)."""
    import numpy as np
    from opengl_raytracing_tpu_torch.camera import Camera
    from opengl_raytracing_tpu_torch.convert import camera_frame_inputs
    from opengl_raytracing_tpu_torch.models import preset
    from opengl_raytracing_tpu_torch.sampling import generate_jitter2d
    params = preset(preset_name)
    cam = Camera()
    cam.aspect = width / height
    if camera in CF_CAMERAS:
        cam.position = np.asarray(CF_CAMERAS[camera], np.float32)
        cam.point_at(CF_LOOK_AT)
    prev_vp = cam.view_projection()
    for frame in range(frames):
        if camera == "moving":
            cam.yaw += 0.4
            cam.position = cam.position + np.asarray([0.0, 0.0, -0.05],
                                                     np.float32)
            fin = camera_frame_inputs(
                cam, device, prev_view_proj=prev_vp, moved=1,
                jitter=generate_jitter2d(frame) * params.jitter_moving_scale,
                frame_index=frame)
            prev_vp = cam.view_projection()
        else:
            fin = camera_frame_inputs(
                cam, device,
                jitter=generate_jitter2d(frame) * params.jitter_still_scale,
                frame_index=frame)
        if moved is None:
            fin = dataclasses.replace(fin, moved=None)
        yield fin


def sky_day(device):
    """The bench's an_full environment (bench.py:253-269): the day-sky cross
    through the port's loader, as the uint8 table the bench builds from it,
    carried to the device by env_from_numpy."""
    import numpy as np
    from opengl_raytracing_tpu_torch.convert import env_from_numpy
    from opengl_raytracing_tpu_torch.utils.image import load_cubemap_cross
    faces = load_cubemap_cross(os.path.join(ROOT, "cubemaps", "sky_day.png"))
    return env_from_numpy(np.clip(np.round(faces * 255.0), 0.0,
                                  255.0).astype(np.uint8), device)


def render(bvh, height, width, frames, device, on_frame=None,
           preset_name="baseline", last=contextlib.nullcontext, env=None,
           camera="still", moved="host", show_motion=False, jit=True):
    """`frames` chained frames of the preset on the BVH scene, or on the
    analytic scene when `bvh` is None, under the cubemap `env` or, without
    one, the gradient sky; returns the last FrameOutputs.  `camera` and
    `moved` as for frame_inputs.  The last frame runs inside the context
    `last()`.  `jit`: the frames replay their CUDA graph (make_render_fn's
    default, the main path); False runs them eagerly."""
    from opengl_raytracing_tpu_torch.models import (RenderState,
                                                    make_render_fn, preset)
    params = preset(preset_name).replace(enable_env_map=int(env is not None))
    fn = make_render_fn(height, width, device, use_bvh=bvh is not None,
                        show_motion=show_motion, jit=jit)
    state = RenderState.create(height, width, device)
    out = None
    for i, fin in enumerate(frame_inputs(height, width, frames, device,
                                         preset_name, camera, moved)):
        with last() if i == frames - 1 else contextlib.nullcontext():
            state, out = fn(params, fin, state, env, bvh)
        if on_frame is not None:
            on_frame(out)
    return out


def cuda_ms(fn, reps):
    import torch
    fn()  # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def is_kernel(key, kernel):
    """Whether the profiler row `key` (a demangled signature) is the
    kernel function `kernel`, by its whole name."""
    return re.search(rf"(?<!\w){re.escape(kernel)}(?!\w)", key) is not None


def throwaway_launches(n):
    """`n` launches of torch.cuda._sleep's kernel (LEAD_KERNEL), each a
    spin of LEAD_CYCLES cycles, for a profile window to open with; no
    call of the port launches that kernel."""
    import torch
    for _ in range(n):
        torch.cuda._sleep(LEAD_CYCLES)


def profile_window(fn, reps):
    """The device rows (kernels and copies) one profiler window saw over
    `reps` calls of `fn` and a synchronize.  On the card a window now and
    then drops its first launches (PERF.md section 6, "The profiler"), so
    it opens with PROFILE_LEAD throwaway launches and a synchronize;
    their rows are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        throwaway_launches(PROFILE_LEAD)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not is_kernel(ev.key, LEAD_KERNEL)]


def device_rows(fn, reps, what, usable=bool, seen=None):
    """The profiler's device rows (kernels and copies) over `reps` calls of
    `fn`, called once before, unprofiled (profile_window).  Some profiles
    come back with no device activity at all, now and then several in a
    row for one call, or with launches missing or extra: a profile whose
    rows are not `usable` is reported on stderr (`seen(rows)`: what it
    saw; by default its device rows) and taken again, up to
    PROFILE_ATTEMPTS times.  A usable profile right after one that was not
    is taken again too (one such, after two empty profiles, gave a sky
    call half the time it takes in every other profile, below its bound:
    the empty profiles' launches may land in it), so the rows kept are
    the first profile's or a usable one's that follows a usable one.
    Returns the rows of every profile taken."""
    import torch
    fn()
    torch.cuda.synchronize()
    taken = []
    for attempt in range(PROFILE_ATTEMPTS):
        taken.append(profile_window(fn, reps))
        if not usable(taken[-1]):
            print(f"profile {attempt + 1} of {what} " + (
                seen(taken[-1]) if seen else
                f"has no row for it; device rows: "
                f"{[ev.key[:60] for ev in taken[-1]]}"),
                file=sys.stderr, flush=True)
        elif attempt == 0 or usable(taken[-2]):
            break
        else:
            print(f"profile {attempt + 1} of {what} follows one without its "
                  f"row: taken again", file=sys.stderr, flush=True)
    return taken


def kernel_launches(fn, kernel):
    """The launches of `kernel` (by name) that one call of `fn` makes: the
    change in the launch counters that count it (cuda_lib.LAUNCHES, by
    KERNELS) across the call, which is made here."""
    import torch
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    counters = {rec.get("counter", key) for key, rec in KERNELS.items()
                if rec["kernel"] == kernel}
    if not counters:
        raise AssertionError(f"no launch counter counts {kernel}")
    before = sum(LAUNCHES[c] for c in counters)
    fn()
    torch.cuda.synchronize()
    return sum(LAUNCHES[c] for c in counters) - before


def kernel_ms(fn, kernel, reps=5):
    """Device time of one launch of `kernel` (by name), from the profiler
    over `reps` calls of `fn` (device_rows), after one unprofiled call
    that counts the kernel's launches a call (kernel_launches).  A
    profile is usable only if its rows of the kernel count exactly the
    launches it timed, `reps` times those of a call: on the card a window
    now and then counts fewer or more (PERF.md section 6, "The
    profiler").  The reading itself is held to nothing but its bound, in
    its phase.  Windows that saw device activity but never the kernel
    raise;
    if no profile is usable, the time is not measured (None): the
    launches and the results of each kernel are checked apart from the
    profiler."""
    per_call = kernel_launches(fn, kernel)
    if per_call <= 0:
        raise AssertionError(f"a call launched {per_call} of {kernel}")
    want = reps * per_call

    def mine(rows):
        return [ev for ev in rows if is_kernel(ev.key, kernel)]

    def counted(rows):
        return sum(ev.count for ev in mine(rows))

    def usable(rows):
        return counted(rows) == want

    def seen(rows):
        return (f"counted {counted(rows)} launches of it where {want} were "
                f"timed ({len(rows)} device rows): taken again")
    taken = device_rows(fn, reps, kernel, usable, seen)
    # device_rows keeps the first profile or one that follows a usable one
    if usable(taken[-1]) and (len(taken) == 1 or usable(taken[-2])):
        return sum(ev.self_device_time_total
                   for ev in mine(taken[-1])) / 1e3 / want
    if any(taken) and not any(map(counted, taken)):
        raise AssertionError(f"the profiler saw no launch of {kernel} in "
                             f"{len(taken)} profiles of {reps} calls")
    print(f"kernel_ms: {kernel} not measured: no profile of {len(taken)} "
          f"counted the {want} launches timed (they counted "
          f"{[counted(rows) for rows in taken]})", file=sys.stderr,
          flush=True)
    return None


def record_kernel_inputs(bvh, height, width, device, keys,
                         preset_name="baseline", frames=1, **how):
    """Render `frames` chained frames (BVH, or analytic if `bvh` is None;
    `how`: render's env, camera and moved) and keep the arguments, by
    name, of every call the last frame makes to the wrappers `keys` (the
    wrappers still launch)."""
    from opengl_raytracing_tpu_torch.ops import (an_cuda, an_shade_cuda,
                                                 an_trace_cuda, bvh_cuda,
                                                 hit_mix_cuda, svgf_cuda)
    where = {"closest": (bvh_cuda, "trace_closest"),
             "bounce": (bvh_cuda, "trace_bounce"),
             "ao": (bvh_cuda, "ambient_occlusion"),
             "an_direct": (an_cuda, "direct_light"),
             "bvh_direct": (an_cuda, "direct_light_bvh"),
             "svgf_present": (svgf_cuda, "svgf_present"),
             "tonemap": (svgf_cuda, "tonemap"),
             **{k: (an_trace_cuda, KERNELS[k]["wrapper"])
                for k in GATE_KERNELS},
             **{k: (an_shade_cuda, KERNELS[k]["wrapper"])
                for k in SHADE_KERNELS},
             **{k: (hit_mix_cuda, KERNELS[k]["wrapper"])
                for k in HIT_MIX_KERNELS}}
    calls = {k: [] for k in keys}
    real = {k: getattr(*where[k]) for k in keys}

    def spy(key):
        sig = inspect.signature(real[key])

        def fn(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            # a hit mix updates `radiance` in place: kept as it came
            calls[key].append({k: v.clone() if k == "radiance" else v
                               for k, v in bound.arguments.items()
                               if k != "offsets_out"})
            return real[key](*args, **kw)
        return fn
    @contextlib.contextmanager
    def spying():
        for k in keys:
            setattr(*where[k], spy(k))
        try:
            yield
        finally:
            for k in keys:
                setattr(*where[k], real[k])
    # eager frames: the spies see the wrappers' calls, and each frame's
    # arguments stay its own
    render(bvh, height, width, frames, device, preset_name=preset_name,
           last=spying, jit=False, **how)
    return calls


def launches_per_call(fn, reps=5):
    """Device launches (kernels and copies) per call of `fn`, from the
    profiler over `reps` calls (device_rows); None if no profile saw
    device activity."""
    n = sum(ev.count for ev in device_rows(fn, reps, "launches")[-1])
    return n / reps if n else None


def _radiance_err(got, want, valid):
    """(max abs error, lanes out of tolerance) on the valid lanes; a NaN
    counts as out of tolerance."""
    g, w = got[valid], want[valid]
    err = (g - w).abs()
    bad = int((~(err <= RAD_ATOL + RAD_RTOL * w.abs())).any(-1).sum())
    return float(err.max()) if err.numel() else 0.0, bad


def _offsets_bitwise(fn, args, live=None):
    """Run direct-light wrapper `fn` on `args` with its offsets output and
    hold the in-kernel disk offsets to lighting._disk_offsets bit for bit,
    on the lanes `live` (bool, the call's shape; None: every lane);
    returns the radiance."""
    import torch
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    shape = args["h"].t.shape
    offs = torch.full((8, args["h"].t.numel()), float("nan"), device="cuda")
    got = fn(**args, offsets_out=offs)
    want = torch.stack([c.expand(shape).reshape(-1) for dxy in
                        lt._disk_offsets(args["rng_frame"],
                                         args["frame_index"], args["px"],
                                         args["py"]) for c in dxy])
    if live is not None:
        offs, want = offs[:, live.reshape(-1)], want[:, live.reshape(-1)]
    if not torch.equal(offs, want):
        raise AssertionError(f"{fn.__name__}: in-kernel disk offsets differ "
                             f"from _disk_offsets on "
                             f"{int((offs != want).sum())} values")
    return got


def check_bvh_direct(args, timer):
    """The BVH direct light against direct_light_bvh_plain on one call's
    arguments: offsets bit for bit, radiance on the live lanes (the others
    are unspecified), the walks' steps for the bound; times.  A call with
    spp_dup (the samples of one hit) walks the sun and point rays of
    sample 0 alone, and reads a pixel's hit rows and computes its shared
    terms once: the bound counts that."""
    import torch
    from opengl_raytracing_tpu_torch.ops import an_cuda
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops.bvh_traverse import trace_bvh_shadow
    from opengl_raytracing_tpu_torch.ops.vecmath import normalize
    h, active = args["h"], args["active"]
    got = _offsets_bitwise(an_cuda.direct_light_bvh, args)
    want = lt.direct_light_bvh_plain(**args)
    live = torch.ones_like(h.t, dtype=torch.bool) if active is None \
        else active
    err = float((got - want)[live].abs().max()) if bool(live.any()) else 0.0
    if not err <= BVH_DIRECT_MAX_ABS:  # a NaN fails too
        raise AssertionError(f"bvh_direct disagrees with "
                             f"direct_light_bvh_plain: max abs {err}")
    # the bound: what the function needs, the mask, the tree, the pixel
    # grids and the live lanes' p, n, v rows read, their radiance written;
    # the terms of the live lanes and the walks of their open windows
    scene = args["scene"]
    params = scene.params
    shape = h.t.shape
    dup = int(args.get("spp_dup") or 0)
    offs = lt._disk_offsets(args["rng_frame"], args["frame_index"],
                            args["px"], args["py"])
    o, d, w = lt._bvh_shadow_queries(scene, h, normalize(h.n), offs, active)
    if dup > 1:  # sun and point: sample 0's rays only
        first = (torch.arange(dup, device=h.t.device) == 0).reshape(
            (dup,) + (1,) * (len(shape) - 1))
        w = w[:4] + [torch.where(first, x, -1.0) for x in w[4:]]
    w = torch.cat([x.expand(shape).reshape(-1) for x in w])
    walked = w > 0.0  # the kernel walks the open windows only
    counts = dict(nodes=0, tris=0)
    trace_bvh_shadow(
        scene.bvh.arrays,
        torch.cat([x.expand(shape + (3,)).reshape(-1, 3) for x in o])[walked],
        torch.cat([x.expand(shape + (3,)).reshape(-1, 3) for x in d])[walked],
        w[walked], counts=counts)
    # a unit's shared part (its hit's rows and terms), then each sample's
    per_unit = (3 * OPS["normalize"] + OPS["cp_rot"]
                + bool(params.sun_enabled) * (OPS["sun"] + OPS["brdf"])
                + bool(params.sky_enabled) * OPS["sky"]
                + bool(params.point_light_enabled) * (OPS["point"]
                                                      + OPS["brdf"]))
    per_sample = 4 * (OPS["offset"] + OPS["disk_point"] + OPS["query"]
                      + OPS["facing"] + OPS["brdf"])
    n_live = int(live.expand(shape).sum())
    n_units = int(live.expand(shape)[0].sum()) if dup > 1 else n_live
    def call():
        an_cuda.direct_light_bvh(**args)
    return dict(pixels=h.t.numel(), live_lanes=n_live, live_units=n_units,
                spp_dup=dup, max_abs_err=err,
                offsets="bitwise", walk_nodes=counts["nodes"],
                walk_tris=counts["tris"],
                **bound(unique_bytes(active, args["px"], args["py"])
                        + bvh_bytes(scene.bvh.arrays) + 36 * n_units
                        + 12 * n_live,
                        n_units * per_unit + n_live * per_sample
                        + walk_ops(counts)),
                ms=timer(call, 20),
                kernel_ms=kernel_ms(call, KERNELS["bvh_direct"]["kernel"]),
                launches_per_call=launches_per_call(call),
                plain_ms=timer(lambda: lt.direct_light_bvh_plain(**args), 3))


def check_present(key, args, ops, timer):
    """One present-pass kernel (`key`: "svgf_present" or "tonemap") on one
    call's arguments against the plain present pass (which takes the
    planes the tonemap kernel does not read as None): max abs
    PRESENT_MAX_ABS on every pixel; `present` itself must be one device
    launch on these inputs; the bound from the planes read, the sRGB
    written and `ops`; times."""
    import torch
    from opengl_raytracing_tpu_torch.ops import svgf_cuda
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    from opengl_raytracing_tpu_torch.ops.svgf import present, present_plain
    fn = getattr(svgf_cuda, key)
    plain_args = {**dict(motion=None, gpos=None, gnrm=None), **args}
    got, want = fn(**args), present_plain(**plain_args)
    # `present` takes the whole image's planes, no band arguments
    present_args = {k: plain_args[k] for k in ("accum", "motion", "gpos",
                                               "gnrm", "params")}
    err = float((got - want).abs().max())
    if got.shape != want.shape or not err <= PRESENT_MAX_ABS \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{key} disagrees with the plain present pass: "
                             f"max abs {err}")
    # one device launch a call: the kernel's counter grows by one a call,
    # and the profiler sees no device operation beside the kernel.  The
    # profiler's count is kept but not held to 1: a profile now and then
    # misses one launch of five, the same in six profiles in a row
    # (probe_profiler.py loss, PERF.md section 7)
    kernel = KERNELS[key]["kernel"]
    before = LAUNCHES[key]
    present(**present_args)
    counted = LAUNCHES[key] - before
    rows = device_rows(lambda: present(**present_args), 5, "present")[-1]
    beside = sorted({ev.key[:80] for ev in rows
                     if not is_kernel(ev.key, kernel)})
    if counted != 1 or not rows or beside:
        raise AssertionError(f"present: {counted} launches of {kernel} a "
                             f"call, device operations beside it {beside} "
                             f"({len(rows)} device rows)")
    per_present = sum(ev.count for ev in rows) / 5
    h, w = got.shape[:2]
    planes = [v for v in args.values() if isinstance(v, torch.Tensor)]
    return dict(pixels=h * w, max_abs_err=err,
                bitwise=bool(torch.equal(got, want)),
                launches_per_present=per_present,
                **bound(unique_bytes(*planes) + 12 * h * w, ops),
                ms=timer(lambda: fn(**args), 20),
                kernel_ms=kernel_ms(lambda: fn(**args),
                                    KERNELS[key]["kernel"]),
                plain_ms=timer(lambda: present_plain(**plain_args), 3))


def _hit_errs(h, hp):
    """(t max abs, t max rel, p max abs over t, n max abs) of a kernel's
    hit against the plain walk's, on the lanes both hit; NaN where a
    value is NaN, so a `not err <= tol` check fails on it."""
    import torch
    both = h.valid & hp.valid
    if not bool(both.any()):
        return 0.0, 0.0, 0.0, 0.0
    t, tp = h.t[both], hp.t[both]
    dp = (h.p[both] - hp.p[both]).abs().amax(-1)
    dn = (h.n[both] - hp.n[both]).abs()
    nan = float("nan")
    def worst(x):  # the largest value, or NaN if there is one
        return nan if bool(torch.isnan(x).any()) else float(x.max())
    return (worst((t - tp).abs()), worst((t - tp).abs() / tp),
            worst(dp / tp), worst(dn))


def check_kernels(bvh, height=HEIGHT, width=WIDTH, device="cuda",
                  timer=None, calls=None):
    """The closest-hit kernel, the BVH direct light and the tonemap kernel
    against their plain versions on the inputs of one baseline frame, or
    on the recorded inputs `calls` (record_kernel_inputs: the kernels of
    those recorded)."""
    from opengl_raytracing_tpu_torch.ops import bvh_cuda
    from opengl_raytracing_tpu_torch.ops import bvh_traverse as plain
    timer = timer or cuda_ms
    if calls is None:
        calls = record_kernel_inputs(bvh, height, width, device, BVH_PATH)
    records = {}

    c = calls["closest"][0]
    arrays, ro, rd, eps = c["bvh"], c["ro"], c["rd"], c["eps"]
    n_rays = ro.numel() // 3
    h = bvh_cuda.trace_closest(arrays, ro, rd, eps)
    counts = dict(nodes=0, tris=0)
    hp = plain.trace_bvh(arrays, ro, rd, eps, counts=counts)
    mismatch = int((h.valid != hp.valid).sum())
    err, rel, p_rel, n_err = _hit_errs(h, hp)
    if mismatch > MISMATCH_FRAC * n_rays or not rel <= T_RTOL \
            or not p_rel <= T_RTOL or not n_err <= N_ATOL:
        raise AssertionError(f"trace_closest disagrees with the plain walk: "
                             f"{mismatch} valid mismatches, t rel {rel}, p "
                             f"rel {p_rel}, n max abs {n_err}")

    def closest():
        bvh_cuda.trace_closest(arrays, ro, rd, eps)
    records["closest"] = dict(
        rays=n_rays, max_abs_err=err, t_max_rel_err=rel,
        p_max_rel_err=p_rel, n_max_abs_err=n_err, mismatch_lanes=mismatch,
        hit_frac=float(hp.valid.float().mean()),
        walk_nodes=counts["nodes"], walk_tris=counts["tris"],
        # rows in (a broadcast origin once), t, p and n out
        **bound(unique_bytes(ro, rd) + bvh_bytes(arrays) + 28 * n_rays,
                walk_ops(counts) + n_rays * OPS["hit_out"]),
        ms=timer(closest, 20),
        kernel_ms=kernel_ms(closest, KERNELS["closest"]["kernel"]),
        plain_ms=timer(lambda: plain.trace_bvh(arrays, ro, rd, eps), 2))

    records["bvh_direct"] = check_bvh_direct(calls["bvh_direct"][0], timer)

    if "tonemap" in calls:
        records["tonemap"] = check_present(
            "tonemap", calls["tonemap"][0],
            height * width * OPS["present_pixel"], timer)
    return records


def check_cf_kernels(bvh, tris, camera="cf_close"):
    """Phase kernels_cf (docstring, 25b-25f): K1's primary call and the BVH
    direct light on the inputs of a 1080p frame of the BVH-heavy scene
    under `camera`, held to their plain versions by check_kernels' gates;
    the share, the live lanes' share and the walks' node visits and
    triangle tests per ray (K1) and per live lane (six walks each,
    bvh_direct); K1 on the numpy builder's tree of the same triangles:
    `valid` on all but MISMATCH_FRAC of the rays, t bit for bit where both
    hit."""
    from opengl_raytracing_tpu_torch.convert import bvh_from_numpy
    from opengl_raytracing_tpu_torch.ops import bvh_cuda
    from opengl_raytracing_tpu_torch.scene import build_bvh, bvh_to_arrays
    calls = record_kernel_inputs(bvh, HEIGHT, WIDTH, "cuda",
                                 ("closest", "bvh_direct"), camera=camera)
    records = check_kernels(bvh, calls=calls)
    k1, bd = records["closest"], records["bvh_direct"]
    for r in (k1, bd):
        r["share"] = (r["bound_ms"] / r["kernel_ms"] if r["kernel_ms"]
                      else None)
    k1.update(live_share=k1["hit_frac"],
              node_visits_per_ray=k1["walk_nodes"] / k1["rays"],
              tri_tests_per_ray=k1["walk_tris"] / k1["rays"])
    live = max(bd["live_lanes"], 1)
    bd.update(live_share=bd["live_lanes"] / bd["pixels"],
              node_visits_per_live_lane=bd["walk_nodes"] / live,
              tri_tests_per_live_lane=bd["walk_tris"] / live)
    c = calls["closest"][0]
    numpy_tree = bvh_from_numpy(bvh_to_arrays(build_bvh(tris)), "cuda").arrays
    if all(bool((a == b).all()) for a, b in zip(c["bvh"], numpy_tree)):
        raise AssertionError("the numpy builder gave the native tree: the "
                             "comparison would hold nothing")
    h = bvh_cuda.trace_closest(c["bvh"], c["ro"], c["rd"], c["eps"])
    hn = bvh_cuda.trace_closest(numpy_tree, c["ro"], c["rd"], c["eps"])
    n = h.t.numel()
    valid_differ = int((h.valid != hn.valid).sum())
    both = h.valid & hn.valid
    t_differ = int((h.t[both] != hn.t[both]).sum())
    if valid_differ > MISMATCH_FRAC * n or t_differ:
        raise AssertionError(f"K1 on the numpy tree: {valid_differ} rays "
                             f"differ in valid, {t_differ} in t")

    def numpy_call():
        bvh_cuda.trace_closest(numpy_tree, c["ro"], c["rd"], c["eps"])
    k1["numpy_tree"] = dict(
        bounds_rows_differ=int((c["bvh"].bounds != numpy_tree.bounds)
                               .any(-1).sum()),
        valid_lanes_differ=valid_differ, t_bitwise=True,
        normal_lanes_differ=int((h.n[both] != hn.n[both]).any(-1).sum()),
        kernel_ms=kernel_ms(numpy_call, KERNELS["closest"]["kernel"]))
    return dict(camera=camera, **records)


def an_call_labels(params):
    """The names of an analytic frame's K3 calls, in the frame's order
    (models/pipeline.py:_shade_analytic): the primary hits, their GI
    bounce, the mirror's hit and its GI bounce, the glass's three
    secondary hits."""
    gi = bool(params.enable_gi)
    return (["primary"] + ["gi"] * gi
            + (["mirror"] + ["mirror_gi"] * gi) * bool(
                params.mat_mirror_enabled)
            + ["glass_reflect", "glass_straight", "glass_bent"] * bool(
                params.mat_glass_enabled))


def an_call_live(args):
    """A K3 call's live lanes (its `active`, None: every lane), broadcast
    to the call's shape."""
    return _live(args["h"], args.get("active"))


def an_plain_args(args):
    """A K3 call's arguments as direct_light_plain takes them: no mask,
    and the hit and view direction set to valid values on the lanes the
    mask marks dead (unread), whose values the frame leaves unspecified;
    the live lanes as they were."""
    live = an_call_live(args)
    plain = {k: v for k, v in args.items() if k != "active"}
    plain["h"] = unread_hit(args["h"], live)
    plain["vdir"] = unread(args["vdir"], live, (0.0, 1.0, 0.0))
    return plain


def an_traces(args, diffuse, shared):
    """The traces K3 runs for a call's live diffuse lanes (`diffuse`, bool
    of the call's shape), counted on the plain version's rays: the rays,
    the sphere tests, and the tests whose discriminant is >= 0 (the only
    ones that go on to the roots).  Four disk segments a lane, against
    the marker too when the point light is on; the sun's ray (the marker
    too) and the point light's (not) once a row, `shared` rows being one
    a pixel for every sample."""
    import torch
    from opengl_raytracing_tpu_torch import constants as k
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
    from opengl_raytracing_tpu_torch.ops.vecmath import dot, normalize
    h, scene = args["h"], args["scene"]
    shape, dev = diffuse.shape, h.t.device
    spheres = [(torch.tensor(c, dtype=torch.float32, device=dev), r)
               for c, r in ((k.SPHERE_LEFT_CENTER, k.SPHERE_LEFT_RADIUS),
                            (k.GLASS_CENTER, k.GLASS_RADIUS),
                            (k.MIRROR_CENTER, k.MIRROR_RADIUS))]
    point_e = bool(scene.params.point_light_enabled)
    marker = [(scene.point_light_pos, k.POINT_LIGHT_MARKER_RADIUS)] * point_e
    counts = dict(trace_rays=0, sphere_tests=0, sphere_roots=0)

    def trace(o, d, tests):
        counts["trace_rays"] += o.shape[0]
        counts["sphere_tests"] += o.shape[0] * len(tests)
        for c, r in tests:
            oc = o - c
            b = dot(oc, d)
            disc = b * b - (dot(oc, oc) - r * r)
            counts["sphere_roots"] += int((disc >= 0.0).sum())

    p = h.p.expand(shape + (3,))[diffuse]
    offs = lt._disk_offsets(args["rng_frame"], args["frame_index"],
                            args["px"], args["py"])
    for xl in lt._disk_points(offs, dev):
        o, d, _ = lt._segment_shadow_query(p, xl.expand(shape + (3,))[diffuse])
        trace(o, d, spheres + marker)
    rows = diffuse[0] if shared else diffuse

    def row(x):
        x = x.expand(shape + (3,))
        return (x[0] if shared else x)[rows]
    p = row(h.p)
    if scene.params.sun_enabled:
        trace(p + normalize(row(h.n)) * 1.0,
              (-scene.sun_dir).expand(p.shape), spheres + marker)
    if point_e:
        o, d, _ = lt._point_shadow_query(scene, Hit(None, p, None, None))
        trace(o, d, spheres)
    return counts


def an_call_bound(args):
    """The least time of one K3 call on this card, from the work of its
    live lanes (bound()): the bytes are the mask's, then each live hit
    row's n, v and material id and a diffuse row's p (one row a pixel
    where the rows are read once for every sample), the pixel grids, a
    live env row's four cubemap texels, and each live lane's radiance
    written; the operations are, for each live diffuse lane, its four
    disk terms and its sums, for each live diffuse row its normals,
    rotation and sun, sky and point terms (once a pixel where the rows
    are), the traces the lanes need (an_traces: a sphere's roots only
    where its disc test passes), and each live env row's reflection.
    Also the call's lanes, live lanes and env lanes, and the traces."""
    from opengl_raytracing_tpu_torch.ops import an_cuda
    from opengl_raytracing_tpu_torch.ops.materials import get_material
    h, scene = args["h"], args["scene"]
    params = scene.params
    shape = h.t.shape
    live = an_call_live(args)
    env = live & (get_material(h.mat, params).mtype.expand(shape) != 0)
    n_live, n_env = int(live.sum()), int(env.sum())
    _, rows, _keep = an_cuda.direct_rows(
        scene, h, args["rng_frame"], args["frame_index"], args["vdir"],
        args["px"], args["py"], args.get("active"), h.t.device)
    shared = bool(rows.shared)
    live_rows = int(live[0].sum()) if shared else n_live
    env_rows = int(env[0].sum()) if shared else n_env
    mask_bytes = (0 if args.get("active") is None
                  else (live[0] if shared else live).numel())
    sun_e, sky_e, point_e = (bool(params.sun_enabled),
                             bool(params.sky_enabled),
                             bool(params.point_light_enabled))
    per_lane = (4 * (OPS["offset"] + OPS["disk_point"] + OPS["an_segment"]
                     + OPS["an_disk"] + OPS["phong"] + OPS["add3"])
                + (1 + sun_e + sky_e + point_e) * OPS["add3"])
    per_row = (3 * OPS["normalize"] + OPS["cp_rot"]
               + sun_e * (OPS["an_sun"] + OPS["phong"]) + sky_e * OPS["sky"]
               + point_e * (OPS["an_point"] + OPS["phong"]))
    traces = an_traces(args, live & ~env, shared)
    per_env = OPS["env"] + (OPS["cubemap"] if scene.env_map is not None
                            else 0)
    return dict(lanes=h.t.numel(), live_lanes=n_live, env_lanes=n_env,
                live_rows=live_rows, shared_rows=shared, **traces,
                **bound(mask_bytes + 40 * live_rows - 12 * env_rows
                        + unique_bytes(args["px"], args["py"])
                        + (48 * env_rows if scene.env_map is not None else 0)
                        + 12 * n_live,
                        (n_live - n_env) * per_lane
                        + (live_rows - env_rows) * per_row
                        + traces["trace_rays"] * OPS["an_floor"]
                        + traces["sphere_tests"] * OPS["an_sphere"]
                        + traces["sphere_roots"] * OPS["an_root"]
                        + env_rows * per_env))


def check_an_kernel(height=AN_HEIGHT, width=AN_WIDTH, device="cuda",
                    timer=None, preset_name="baseline", env=None,
                    record_as=None):
    """The analytic direct-light kernel against its plain version on every
    call one analytic frame makes (primary hits, the mirror's and the
    glass's three secondary hits, with the `full` preset the GI bounces'
    too), each on its live lanes (the mask the frame hands it; the others
    are unspecified): offsets bit for bit, radiance within K3_MAX_ABS;
    each call's live lanes, bound and time alone (`calls_detail`), and the
    wrapper's and the plain version's times and launches on the primary
    call.  Without `env`: an an_baseline frame, and the tonemap kernel on
    the frame's accumulation at this size, as check_kernels holds it at
    the baseline frame's.  With the cubemap table `env`: an an_full frame,
    whose mirror and glass lanes sample the map in the kernel (the plain
    version samples it through scene.sky); some live lane must.  With
    `record_as`, the kernel's record alone under that name (a `heavy`
    frame's calls carry the sample axis: the primary call's seed is
    sampled, its hit rows and mask are read once a pixel, and every
    call's lanes are the 4 samples')."""
    from opengl_raytracing_tpu_torch.ops import an_cuda
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    timer = timer or cuda_ms
    alone = env is not None or record_as is not None
    calls = record_kernel_inputs(None, height, width, device,
                                 ("an_direct",) if alone else AN_PATH,
                                 preset_name, env=env)
    labels = an_call_labels(calls["an_direct"][0]["scene"].params)
    if len(labels) != len(calls["an_direct"]):
        raise AssertionError(f"the frame made {len(calls['an_direct'])} K3 "
                             f"calls, expected {labels}")
    errs, bad, detail = [], 0, {}
    for label, args in zip(labels, calls["an_direct"]):
        if (args["scene"].env_map is None) != (env is None):
            raise AssertionError("the frame's scene does not carry the "
                                 "environment it was given")
        if args["active"] is None:
            raise AssertionError(f"the frame's {label} K3 call has no mask")
        plain = an_plain_args(args)
        live = an_call_live(args)
        e, b = _radiance_err(_offsets_bitwise(an_cuda.direct_light, args,
                                              live),
                             lt.direct_light_plain(**plain), live)
        errs.append(e)
        bad += b
        detail[label] = dict(
            an_call_bound(args), max_abs_err=e, bad_lanes=b,
            kernel_ms=kernel_ms(lambda: an_cuda.direct_light(**args),
                                KERNELS["an_direct"]["kernel"]))
    if bad or not max(errs) <= K3_MAX_ABS:  # a NaN lane counts in `bad`
        raise AssertionError(f"an_direct_light disagrees with the plain "
                             f"direct_light on {bad} live lanes (max abs "
                             f"{max(errs)})")
    env_lanes = sum(d["env_lanes"] for d in detail.values())
    if env is not None and not env_lanes:
        raise AssertionError("no live mirror or glass lane sampled the "
                             "cubemap")
    args = calls["an_direct"][0]
    plain = an_plain_args(args)

    def call():
        an_cuda.direct_light(**args)
    record = dict(
        calls=len(errs), pixels=height * width,
        max_abs_err=max(errs), max_abs_err_per_call=errs,
        bad_lanes=bad, offsets="bitwise on live lanes",
        env_lanes_all_calls=env_lanes, calls_detail=detail,
        **{k: v for k, v in detail["primary"].items()
           if k not in ("max_abs_err", "bad_lanes", "kernel_ms")},
        ms=timer(call, 20), kernel_ms=detail["primary"]["kernel_ms"],
        launches_per_call=launches_per_call(call),
        plain_ms=timer(lambda: lt.direct_light_plain(**plain), 5))
    if record_as is not None:
        return {record_as: record}
    if env is not None:
        return dict(an_direct_env=record)
    tonemap = check_present("tonemap", calls["tonemap"][0],
                            height * width * OPS["present_pixel"], timer)
    return dict(tonemap_an=tonemap, an_direct=record)


def check_full_kernels(bvh, height=HEIGHT, width=WIDTH, device="cuda",
                       timer=None):
    """On the inputs of the third frame of a 1080p `full` chain: the SVGF
    kernel's filter entry against the plain filter and its fused entry
    against the plain present pass, the AO kernel, and the bounce calls
    (incoherent rays, sky lanes inactive) of the closest-hit kernel and of
    the BVH direct light against the plain versions."""
    import torch
    from opengl_raytracing_tpu_torch.ops import svgf_cuda
    from opengl_raytracing_tpu_torch.ops.svgf import svgf_filter
    timer = timer or cuda_ms
    calls = record_kernel_inputs(bvh, height, width, device, FULL_PATH,
                                 "full", PROFILE_FRAME)
    records = {}
    args = calls["svgf_present"][0]
    got = svgf_cuda.svgf_filter(**args)
    want = svgf_filter(**args)
    err = (got - want).abs()
    bad = int((err > SVGF_TOL + SVGF_TOL * want.abs()).any(-1).sum())
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"svgf_filter disagrees with the plain filter on "
                             f"{bad} pixels (max abs {float(err.max())})")
    taps = (7 * width - 12) * (7 * height - 12)  # in-bounds taps, radius 3
    filter_ops = height * width * OPS["svgf_pixel"] + taps * OPS["svgf_tap"]
    records["svgf"] = dict(
        pixels=height * width, max_abs_err=float(err.max()), bad_pixels=bad,
        bitwise=bool(torch.equal(got, want)),
        **bound(unique_bytes(*(args[k] for k in ("accum", "motion", "gpos",
                                                  "gnrm")))
                + 12 * height * width, filter_ops),
        ms=timer(lambda: svgf_cuda.svgf_filter(**args), 20),
        kernel_ms=kernel_ms(lambda: svgf_cuda.svgf_filter(**args),
                            KERNELS["svgf"]["kernel"]),
        plain_ms=timer(lambda: svgf_filter(**args), 3))
    # the same planes in, sRGB out in place of the filtered image
    records["svgf_present"] = check_present(
        "svgf_present", args, filter_ops + height * width * OPS["present_pixel"], timer)

    records["ao"] = check_ao(calls["ao"][0], timer)
    records["bounce"] = check_bounce(calls["bounce"][0], timer)
    records["bvh_direct_bounce"] = check_bvh_direct(calls["bvh_direct"][1],
                                                    timer)
    return records


def _live(h, active):
    import torch
    return torch.ones_like(h.t, dtype=torch.bool) if active is None \
        else active.expand(h.t.shape)


def check_ao(args, timer):
    """The AO kernel against ambient_occlusion_plain on one call's
    arguments: equal on live lanes but for at most AO_FLIP_FRAC of them,
    each off by exactly one sample step; the bound from the live lanes'
    walks; times."""
    import torch
    from opengl_raytracing_tpu_torch.ops import bvh_cuda
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops.bvh_traverse import trace_bvh_shadow
    from opengl_raytracing_tpu_torch.params import bind
    h, params, arrays = args["h"], args["params"], args["bvh"]
    got = bvh_cuda.ambient_occlusion(**args)
    want = lt.ambient_occlusion_plain(**args)
    live = _live(h, args["active"])
    n_live, S = int(live.sum()), int(params.ao_samples)
    g, w = got[live], want[live]
    off = ~(g == w)  # a NaN counts as off
    # the words the kernel reads from the parameter block
    block = bind(params, h.t.device)
    step = float(block["ao_span"]) / S
    steps_ok = bool((((g - w)[off].abs() - step).abs() <= 1e-6).all())
    flips = int(off.sum())
    if flips > AO_FLIP_FRAC * max(n_live, 1) or not steps_ok:
        raise AssertionError(f"ambient_occlusion disagrees with "
                             f"ambient_occlusion_plain on {flips} of {n_live} "
                             f"live lanes")
    # the bound: what the function needs, the mask, the tree, the grids,
    # the live lanes' p and n rows read and their AO written; the live
    # lanes' sampling, remap and walks
    org, dirs = lt._ao_rays(h, args["frame_index"], args["px"], args["py"],
                            params)
    sel = live.reshape(-1)
    shape = h.t.shape
    counts = dict(nodes=0, tris=0)
    trace_bvh_shadow(
        arrays, torch.cat([org.expand(shape + (3,)).reshape(-1, 3)[sel]] * S),
        torch.cat([d.reshape(-1, 3)[sel] for d in dirs]),
        block["ao_radius"].expand(S * n_live), counts=counts)
    per_pixel = OPS["normalize"] + OPS["origin"] + OPS["ao_remap"]
    per_sample = 2 * OPS["rand"] + OPS["onb"] + OPS["hemisphere"]

    def call():
        bvh_cuda.ambient_occlusion(**args)
    return dict(pixels=h.t.numel(), live_lanes=n_live, samples=S,
                max_abs_err=float((g - w).abs().max()) if n_live else 0.0,
                flipped_lanes=flips, walk_nodes=counts["nodes"],
                walk_tris=counts["tris"],
                occluded_frac=float((w < 1.0).float().mean())
                if n_live else 0.0,
                **bound(unique_bytes(args["active"], args["px"], args["py"])
                        + bvh_bytes(arrays) + (24 + 4) * n_live,
                        n_live * (per_pixel + S * per_sample)
                        + walk_ops(counts)),
                ms=timer(call, 20),
                kernel_ms=kernel_ms(call, KERNELS["ao"]["kernel"]),
                launches_per_call=launches_per_call(call),
                plain_ms=timer(lambda: lt.ambient_occlusion_plain(**args),
                               2))


def check_bounce(args, timer):
    """K1's GI bounce call against gi_bounce_plain on one call's
    arguments: the direction and its cosine bit for bit on live lanes,
    `valid` on every lane, t, p and n on the lanes both hit; the bound
    from the live lanes' walks; times."""
    import torch
    from opengl_raytracing_tpu_torch.ops import bvh_cuda, cuda_lib
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops.bvh_traverse import trace_bvh
    from opengl_raytracing_tpu_torch.sampling import samples_of
    h0, arrays = args["h0"], args["bvh"]
    h1, wi, cos = bvh_cuda.trace_bounce(**args)
    hp, wip, cosp = lt.gi_bounce_plain(**args)
    live = _live(h0, args["active"])
    n_rays, n_live = h0.t.numel(), int(live.sum())
    same_ray = (torch.equal(wi[live], wip[live])
                and torch.equal(cos[live], cosp[live]))
    mismatch = int((h1.valid != hp.valid).sum())
    err, rel, p_rel, n_err = _hit_errs(h1, hp)
    if not same_ray or mismatch > MISMATCH_FRAC * n_rays \
            or not rel <= T_RTOL or not p_rel <= T_RTOL \
            or not n_err <= N_ATOL:
        raise AssertionError(f"trace_bounce disagrees with gi_bounce_plain: "
                             f"rays equal {same_ray}, {mismatch} valid "
                             f"mismatches, t rel {rel}, p rel {p_rel}, n max "
                             f"abs {n_err}")
    # the kernel reads a pixel's rows once where the samples share the hit
    shape = h0.t.shape
    samples = max(samples_of(args["rng_frame"]), samples_of(args["seed"]))
    shared = all(cuda_lib.sample_rows(x, shape, samples) is not None
                 for x in (h0.p, h0.n))
    n_rows = int(live.expand(shape)[0].sum()) if shared else n_live
    origin, wi_p, _ = lt._bounce_ray(h0, args["rng_frame"], args["seed"],
                                     args["px"], args["py"])
    sel = live.reshape(-1)
    counts = dict(nodes=0, tris=0)
    trace_bvh(arrays, origin.reshape(-1, 3)[sel], wi_p.reshape(-1, 3)[sel],
              counts=counts)
    per_live = (2 * OPS["rand"] + OPS["normalize"] + OPS["onb"]
                + OPS["hemisphere"] + OPS["cos"] + OPS["origin"]
                + OPS["hit_out"])

    def call():
        bvh_cuda.trace_bounce(**args)
    # bytes: the mask, the tree, the grids, the live lanes' p and n rows
    # read (a pixel's once where the samples share them); t, p, n, wi and
    # cos written for a live lane (44 B), t, wi and cos for a dead one
    # (20 B: a miss, NaN-free for the tail; its p and n are unspecified)
    return dict(rays=n_rays, live_lanes=n_live, samples=samples,
                shared_rows=shared,
                hit_frac=float(hp.valid.float().mean()),
                mismatch_lanes=mismatch, t_max_rel_err=rel,
                max_abs_err=err, p_max_rel_err=p_rel, n_max_abs_err=n_err,
                walk_nodes=counts["nodes"], walk_tris=counts["tris"],
                **bound(unique_bytes(args["active"], args["px"], args["py"])
                        + bvh_bytes(arrays) + 24 * n_rows + 44 * n_live
                        + 20 * (n_rays - n_live),
                        n_live * per_live + walk_ops(counts)),
                ms=timer(call, 20),
                kernel_ms=kernel_ms(call, KERNELS["bounce"]["kernel"]),
                launches_per_call=launches_per_call(call),
                plain_ms=timer(lambda: lt.gi_bounce_plain(**args), 2))


@contextlib.contextmanager
def python_route(*entries):
    """Inside the block the port's native entries `entries` answer None,
    so their callers run the numpy and Python forms."""
    from opengl_raytracing_tpu_torch import native
    saved = {e: getattr(native, e) for e in entries}
    for e in entries:
        setattr(native, e, lambda *args, **kw: None)
    try:
        yield
    finally:
        for e, fn in saved.items():
            setattr(native, e, fn)


def _same(what, a, b):
    """Raise unless the native result `a` equals the numpy/Python form's
    `b` (arrays: dtype, shape and every value; bytes: every byte)."""
    import numpy as np
    same = (a == b) if isinstance(a, bytes) else (
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b))
    if not same:
        raise AssertionError(f"native {what} differs from its numpy/Python "
                             f"form")


def timed(fn):
    """(result, seconds) of one call of `fn` (host clock)."""
    t0 = time.time()
    out = fn()
    return out, time.time() - t0


def check_native(smi):
    """Phase native (docstring, step 2b)."""
    import glob
    from opengl_raytracing_tpu_torch import native
    from opengl_raytracing_tpu_torch.constants import (DEFAULT_BVH_SCALE,
                                                       DEFAULT_BVH_TRANSLATE)
    from opengl_raytracing_tpu_torch.scene import (build_bvh,
                                                   gather_triangles,
                                                   load_obj, make_bunny,
                                                   model_transform,
                                                   validate_bvh)
    from opengl_raytracing_tpu_torch.utils import image
    for k in native.CALLS:
        native.CALLS[k] = 0
    path, build_s = timed(lambda: native.build_library(force=True))
    if path is None:
        raise AssertionError("no g++ on PATH: the native library was not "
                             "built")
    out = dict(card=smi, library=os.path.relpath(path, ROOT),
               build_seconds=build_s)

    # the BVH-heavy scene's tree, both builders
    m = model_transform(DEFAULT_BVH_TRANSLATE, DEFAULT_BVH_SCALE)
    tris = gather_triangles(make_bunny(HEAVY_SUBDIV), m)
    tree, native_s = timed(lambda: native.build_bvh(tris))
    numpy_tree, numpy_s = timed(lambda: build_bvh(tris))
    validate_bvh(tree, tris)  # every triangle once, the input's multiset
    if tree.n_nodes != numpy_tree.n_nodes or \
            not (tree.count == numpy_tree.count).all():
        raise AssertionError("the native and numpy trees split apart")
    out["bvh"] = dict(
        tris=int(tris.shape[0]), nodes=tree.n_nodes,
        native_seconds=native_s, numpy_seconds=numpy_s,
        bounds_rows_differ=int(((tree.bmin != numpy_tree.bmin)
                                | (tree.bmax != numpy_tree.bmax))
                               .any(-1).sum()),
        tri_rows_differ=int((tree.tris != numpy_tree.tris).any(-1).sum()))

    # OBJ parse and triangle gather of every OBJ model
    objs = sorted(glob.glob(os.path.join(ROOT, "models", "*.obj")))
    for p in objs:
        mesh = native.load_obj(p)
        for a, b in zip(mesh, load_obj(p)):
            _same(f"load_obj {os.path.basename(p)}", a, b)
        _same(f"gather_triangles {os.path.basename(p)}",
              native.gather_triangles(mesh, m), gather_triangles(mesh, m))
    out["obj_models"] = len(objs)

    # every cross: the readers (PNG defilter, HDR RLE, JPEG entropy
    # decode) both routes; the slicer on the 8-bit ones
    crosses = {}
    for p in sorted(glob.glob(os.path.join(ROOT, "cubemaps", "*"))):
        name = os.path.basename(p)
        img, nat_s = timed(lambda: image.read_image(p))
        with python_route("png_unfilter", "hdr_unrle", "jpeg_entropy_scan"):
            want, py_s = timed(lambda: image.read_image(p))
        _same(f"read_image {name}", img, want)
        if img.dtype.name == "uint8":
            _same(f"slice_cubemap_cross {name}",
                  native.slice_cubemap_cross(img),
                  image.slice_cubemap_cross(img))
        crosses[name] = dict(native_seconds=nat_s, python_seconds=py_s)
    out["crosses"] = crosses

    # a 1080p baseline frame's JPEG encode (row 0 at the top, as the
    # viewer hands it over), both routes: the same bytes
    frame = render(scene("cuda")[1], HEIGHT, WIDTH, 1,
                   "cuda").image.cpu().numpy()[::-1]
    data, enc_s = timed(lambda: image.encode_jpeg(frame))
    with python_route("jpeg_entropy_encode"):
        want, enc_py_s = timed(lambda: image.encode_jpeg(frame))
    _same("jpeg encode of a 1080p frame", data, want)
    out["jpeg_encode_1080p"] = dict(bytes=len(data), native_seconds=enc_s,
                                    python_seconds=enc_py_s)
    out["calls"] = dict(native.CALLS)
    if min(native.CALLS.values()) <= 0:
        raise AssertionError(f"a native entry was never called: "
                             f"{native.CALLS}")
    return out


def run_frames(bvh, height, width, keys, png, smi, preset_name="baseline",
               expect=None, frames=FRAMES, **how):
    """`frames` chained frames (`how`: render's env, camera and moved) with
    the launch counters zeroed just before, through the main path: the
    first frame captures the frame's CUDA graph, the others replay it
    (checked); checks the image, that each of the path's kernels `keys`
    was launched at least once a frame, and the exact counts `expect`
    ({counter: launches a frame}).  `png` may be None."""
    import torch
    from opengl_raytracing_tpu_torch.models import graph
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    from opengl_raytracing_tpu_torch.utils.image import write_png
    sums = []
    graph.clear()
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    stats0 = graph.stats()
    t_frames = time.time()
    out = render(bvh, height, width, frames, "cuda",
                 on_frame=lambda o: sums.append(o.image.sum()),
                 preset_name=preset_name, **how)
    torch.cuda.synchronize()
    sec = (time.time() - t_frames) / frames
    launches = dict(LAUNCHES)  # every counter; the path's are checked
    img = out.image
    if img.shape != (height, width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("frame is not a finite [H,W,3] image")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("frame leaves [0,1]")
    if min(launches[k] for k in keys) < frames:
        raise AssertionError(f"kernels {keys} not launched once per frame: "
                             f"{launches}")
    for k, per_frame in (expect or {}).items():
        if launches[k] != per_frame * frames:
            raise AssertionError(f"{k} launched {launches[k]} times in "
                                 f"{frames} frames, not {per_frame} a frame")
    checksum = float(torch.stack(sums).sum())
    if png is not None:
        os.makedirs(os.path.join(ROOT, "out"), exist_ok=True)
        write_png(os.path.join(ROOT, "out", png), img.cpu().numpy()[::-1])
    stats = graph.stats()
    if stats["captures"] - stats0["captures"] != 1 \
            or stats["replays"] - stats0["replays"] != frames - 1:
        raise AssertionError(f"the chain did not replay one captured frame: "
                             f"{stats} after {stats0}")
    graph.clear()  # its memory back before the next phase
    return dict(graph=dict(captures=1, replays=frames - 1,
                           pool_mb=stats["pool_bytes"] / 2**20),frames=frames, preset=preset_name, size=[height, width],
                ms_per_frame=sec * 1e3, fps=1.0 / sec,
                primary_mrays_per_s=height * width / sec / 1e6,
                checksum=checksum, launches=launches, card=smi,
                png=png and f"out/{png}")


def _frame_gate(got, ref, what):
    """max abs <= 2/255 and 99.9th percentile <= 1e-3 between two frames;
    returns the record."""
    import torch
    diff = (got - ref).abs()
    q999 = float(torch.quantile(diff.flatten(), 0.999))
    over = int((diff > 2.0 / 255.0).sum())
    if not float(diff.max()) <= 2.0 / 255.0 or not q999 <= 1e-3:
        raise AssertionError(f"{what}: card frame differs from the CPU frame: "
                             f"max {float(diff.max())}, q99.9 {q999}, {over} "
                             f"values over 2/255")
    at = [int(i) for i in torch.nonzero(diff == diff.max())[0]]
    return dict(max_abs=float(diff.max()), q999=q999,
                values_over_1e_3=int((diff > 1e-3).sum()),
                values_over_2_255=over, max_at_yxc=at)


def check_reference(bvh_cuda_scene, bvh_cpu_scene, height, width,
                    preset_name="baseline", frames=1, lanes=False, **how):
    """The last of `frames` chained frames on the card against the same
    frame on the CPU (`how`: render's camera, moved and show_motion, and
    env=True for the day-sky cubemap on both devices): max abs <= 2/255
    and 99.9th percentile <= 1e-3.  `lanes` (analytic scene, one frame)
    lists every value over 1e-3 with its pixel, the material and the
    primary hit's t on both devices."""
    import torch
    with_env = how.pop("env", False)
    outs = {}
    for device, bvh in (("cpu", bvh_cpu_scene), ("cuda", bvh_cuda_scene)):
        outs[device] = render(bvh, height, width, frames, device,
                              preset_name=preset_name,
                              env=sky_day(device) if with_env else None,
                              **how)
    got, ref = outs["cuda"].image.cpu(), outs["cpu"].image
    rec = dict(size=[height, width], preset=preset_name, frames=frames,
               **how,
               **_frame_gate(got, ref, f"{preset_name} {how}"))
    if lanes:
        rec["lanes_over_1e_3"] = divergent_lanes(
            (got - ref).abs(), height, width, preset_name)
    return rec


def divergent_lanes(diff, height, width, preset_name):
    """For every pixel of the analytic frame with a value over 1e-3 between
    the card and the CPU: [y, x], the largest difference, the primary
    hit's material and t on both devices, |n.v| there, and how far the
    two devices' primary ray directions are apart on that lane (on the
    card PyTorch divides the pixel coordinate by the image size as a
    multiplication by the rounded reciprocal, so a direction may differ
    by an ulp; `rd_lanes_differ` counts such lanes in the frame)."""
    import torch
    from opengl_raytracing_tpu_torch.models import preset
    from opengl_raytracing_tpu_torch.models.pipeline import primary_rays
    from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
    from opengl_raytracing_tpu_torch.ops.vecmath import dot, normalize
    params = preset(preset_name).replace(enable_env_map=0)
    hits = {}
    for device in ("cpu", "cuda"):
        fin = next(frame_inputs(height, width, 1, device, preset_name))
        _, _, rd = primary_rays(height, width, fin, params)
        h = SceneCtx.create(params, fin.cam_pos).trace(
            fin.cam_pos.expand(rd.shape), rd)
        hits[device] = (h.mat.cpu(), h.t.cpu(),
                        dot(normalize(h.n), -rd).abs().cpu(), rd.cpu())
    rd_diff = (hits["cpu"][3] - hits["cuda"][3]).abs().amax(-1)
    out = []
    for y, x in torch.nonzero((diff > 1e-3).any(-1)).tolist():
        out.append(dict(yx=[y, x], max_abs=float(diff[y, x].max()),
                        mat=[int(hits[d][0][y, x]) for d in ("cpu", "cuda")],
                        t=[float(hits[d][1][y, x]) for d in ("cpu", "cuda")],
                        abs_n_dot_v=float(hits["cpu"][2][y, x]),
                        rd_max_abs_diff=float(rd_diff[y, x]),
                        rd_lanes_differ=int((rd_diff > 0).sum())))
    return out


def check_raster_reference(bvh_cuda_scene, bvh_cpu_scene, height, width):
    """render_raster on the card (the mesh through the closest-hit kernel)
    against the CPU: flat colours, so equal but on tie lanes, where two
    surfaces are within rounding of each other in t and the pixel flips
    whole: at most 1e-4 of the pixels."""
    import torch
    from opengl_raytracing_tpu_torch.models import preset, render_raster
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    params = preset("baseline")
    before = LAUNCHES["closest"]
    imgs = {}
    for device, bvh in (("cpu", bvh_cpu_scene), ("cuda", bvh_cuda_scene)):
        fin = next(frame_inputs(height, width, 1, device))
        imgs[device] = render_raster(params, fin, bvh, height=height,
                                     width=width).cpu()
    if LAUNCHES["closest"] != before + 1:
        raise AssertionError("render_raster on the card did not launch the "
                             "closest-hit kernel once")
    flips = int((imgs["cuda"] != imgs["cpu"]).any(-1).sum())
    colours = len(torch.unique(imgs["cuda"].reshape(-1, 3), dim=0))
    mesh = int((imgs["cuda"] == 0.9).all(-1).sum())
    if flips > 1e-4 * height * width or colours < 4 or not mesh:
        raise AssertionError(f"render_raster: {flips} pixels differ from the "
                             f"CPU image, {colours} colours, {mesh} mesh "
                             f"pixels")
    return dict(size=[height, width], pixels_differ=flips, colours=colours,
                mesh_pixels=mesh)

# ---- phase an_gates: the analytic scene's live-lane kernels ----

def unread(x, live, value):
    """`x` (a lane's scalar or vector) with the lanes `live` marks dead set
    to `value`: a plain version computes every lane, and those of a
    frame's call hold unspecified values (a dead direction may be NaN,
    which the plain cubemap's gather cannot index)."""
    import torch
    value = torch.tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(live[..., None] if value.dim() else live, x, value)


def unread_hit(h, live):
    from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
    return Hit(unread(h.t, live, 1.0), unread(h.p, live, (0.0, 0.5, 0.0)),
               unread(h.n, live, (0.0, 1.0, 0.0)), unread(h.mat, live, 0))


def gate_unread(key, a):
    """The arguments `a` of a frame's call of gate kernel `key` with the
    per-lane inputs (rays, hits, directions) set to valid values on the
    lanes the frame's mask marks dead (unread); the live lanes as they
    were."""
    live = a.get("active")
    if live is None:
        return a
    up = (0.0, 1.0, 0.0)
    if key == "an_trace":
        return dict(a, ro=unread(a["ro"], live, (0.0, 0.5, 0.0)),
                    rd=unread(a["rd"], live, up))
    if key == "sky":
        return dict(a, d=unread(a["d"], live, up))
    field = "h" if key == "an_ao" else "h0"
    return dict(a, **{field: unread_hit(a[field], live)})


def gate_plain(key, a):
    """The dense plain version of a call of gate kernel `key` on the card,
    as {output: tensor}; `a` as gate_unread gives it."""
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops import scene_analytic as sa
    if key == "an_trace":
        h = sa.trace_analytic_core(a["ro"], a["rd"], a["params"],
                                   a["point_light_pos"], a["include_glass"],
                                   a["include_point_light"], a["eps"])
        return dict(zip(h._fields, h))
    if key == "an_ao":
        return dict(ao=lt.ambient_occlusion_analytic_plain(
            a["scene"], a["h"], a["frame_index"], a["px"], a["py"]))
    if key == "an_bounce":
        h, wi, cos = lt.gi_bounce_analytic_plain(
            a["scene"], a["h0"], a["rng_frame"], a["seed"], a["px"],
            a["py"])
        return dict(zip(h._fields, h), wi=wi, cos=cos)
    return dict(sky=sa.sky(a["d"], a["params"], a["env_map"]))


def gate_call(key, a, active):
    """A call of gate kernel `key`'s wrapper with the mask `active`, as
    {output: tensor}."""
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    out = getattr(an_trace_cuda, KERNELS[key]["wrapper"])(
        **{k: v for k, v in a.items() if k != "active"}, active=active)
    if key == "an_trace":
        return dict(zip(out._fields, out))
    if key == "an_bounce":
        return dict(zip(out[0]._fields, out[0]), wi=out[1], cos=out[2])
    return {"ao" if key == "an_ao" else "sky": out}


def gate_shape(key, a):
    import torch
    if key == "an_trace":
        return torch.broadcast_shapes(a["ro"].shape[:-1], a["rd"].shape[:-1])
    if key == "sky":
        return a["d"].shape[:-1]
    return (a["h"] if key == "an_ao" else a["h0"]).t.shape


def gate_rows(x, shape, width, live):
    """The distinct rows of input `x` that the live lanes read, as the
    kernel reads them (an_trace_cuda.lane_input: a row a lane, a pixel's
    row once for every sample, one row)."""
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    mode = an_trace_cuda.lane_input(x, shape, width, x.dtype, x.device,
                                    "x")[0].mode
    if mode == an_trace_cuda.ONE:
        return 1
    if mode == an_trace_cuda.PIXEL:
        return int(live.reshape(shape[0], -1).any(0).sum())
    return int(live.sum())


def gate_mask_bytes(mask, shape):
    """The bytes of a mask as the kernel reads every one of them: a byte a
    lane, a pixel, or one."""
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    mode = an_trace_cuda.lane_input(mask, shape, 0, mask.dtype, mask.device,
                                    "active")[0].mode
    return {an_trace_cuda.ONE: 1,
            an_trace_cuda.PIXEL: an_trace_cuda.n_px_of(shape),
            an_trace_cuda.LANE: shape.numel()}[mode]


def sphere_roots(scene_params, plp, ro, rd, glass, marker):
    """(sphere tests, tests whose disc >= 0) of the trace of rays ro, rd
    [N, 3]: the kernel stops a missed sphere at its disc test."""
    import torch
    from opengl_raytracing_tpu_torch import constants as k
    from opengl_raytracing_tpu_torch.ops.vecmath import dot
    dev = rd.device
    spheres = [(torch.tensor(c, dtype=torch.float32, device=dev), r)
               for i, (c, r) in enumerate(
                   ((k.SPHERE_LEFT_CENTER, k.SPHERE_LEFT_RADIUS),
                    (k.GLASS_CENTER, k.GLASS_RADIUS),
                    (k.MIRROR_CENTER, k.MIRROR_RADIUS))) if glass or i != 1]
    if marker:
        spheres.append((plp, k.POINT_LIGHT_MARKER_RADIUS))
    roots = 0
    for c, r in spheres:
        oc = ro - c
        b = dot(oc, rd)
        roots += int(((b * b - (dot(oc, oc) - r * r)) >= 0.0).sum())
    return len(spheres) * rd.shape[0], roots


def ao_reach_lanes(scene, h, shape, sel, marker):
    """The live lanes of an analytic AO call whose hemisphere rays can
    meet a primitive within ao_radius: a sphere whose centre lies within
    ao_radius + r of the lane's origin, or the floor within ao_radius of
    it on the side its hemisphere faces (a lane whose normal is the
    floor's, above it, faces away).  Lanes out of every primitive's reach
    have occ = 0 whatever their directions, so they need no ray."""
    import torch
    from opengl_raytracing_tpu_torch import constants as k
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops.vecmath import dot
    host = scene.params.host
    radius = float(host.ao_radius)
    n = lt.normalize(h.n).expand(shape + (3,)).reshape(-1, 3)[sel]
    o = h.p.expand(shape + (3,)).reshape(-1, 3)[sel] + n * float(
        host.ao_bias)
    dev = o.device
    spheres = [(torch.tensor(c, dtype=torch.float32, device=dev), r)
               for c, r in ((k.SPHERE_LEFT_CENTER, k.SPHERE_LEFT_RADIUS),
                            (k.GLASS_CENTER, k.GLASS_RADIUS),
                            (k.MIRROR_CENTER, k.MIRROR_RADIUS))]
    if marker:
        spheres.append((scene.point_light_pos, k.POINT_LIGHT_MARKER_RADIUS))
    near = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    for c, r in spheres:
        oc = o - c
        near |= dot(oc, oc) <= (radius + r) ** 2
    fn = torch.tensor(k.FLOOR_NORMAL, dtype=torch.float32, device=dev)
    height = dot(o, fn) + k.FLOOR_D     # |fn| = 1
    up = (n[:, 0] == 0) & (n[:, 2] == 0) & (n[:, 1] > 0)
    near |= (height.abs() <= radius) & ~(up & (height >= 0))
    return int(near.sum())


def cubemap_texels(env, d, live):
    """The distinct texels of table `env` [6, F, F, 3] that the bilinear
    lookups of the live lanes' directions `d` read, each once at best:
    those with a weight in the plain sampler's sum, from its gradient
    with respect to the table (a texel of weight 0 is not counted, so the
    bound stays a lower one)."""
    from opengl_raytracing_tpu_torch.ops.cubemap import sample_cubemap
    table = env.detach().clone().requires_grad_(True)
    dirs = d.expand(live.shape + (3,))[live]
    sample_cubemap(table, dirs).sum().backward()
    return int((table.grad != 0).any(-1).sum())


def gate_bound(key, a, live):
    """The least time of one call of gate kernel `key` from the work of its
    live lanes (bound()): the bytes are the mask's (as the kernel reads
    it), the live lanes' distinct input rows, the pixel grids where the
    kernel samples, the distinct cubemap texels the live lanes' lookups
    read (cubemap_texels) and the live lanes' outputs; the operations those
    lanes' arithmetic, with each trace's floor test, sphere tests and the
    roots of the spheres whose disc test passes.  AO needs one bit a ray:
    its rays are counted on the lanes within reach of a primitive
    (ao_reach_lanes), each with one primitive test, its basis once a
    lane."""
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    shape = gate_shape(key, a)
    n_live = int(live.sum())
    mask = a.get("active")
    n_bytes = 0 if mask is None else gate_mask_bytes(mask, shape)
    sel = live.reshape(-1)
    trace_op = OPS["an_floor"] + OPS["hit_out"]
    if key == "an_trace":
        params = a["params"]
        marker = an_trace_cuda._marker(params, a["include_point_light"])
        ro = a["ro"].expand(shape + (3,)).reshape(-1, 3)[sel]
        rd = a["rd"].expand(shape + (3,)).reshape(-1, 3)[sel]
        tests, roots = sphere_roots(params, a["point_light_pos"], ro, rd,
                                    a["include_glass"], marker)
        n_bytes += 12 * (gate_rows(a["ro"], shape, 3, live)
                         + gate_rows(a["rd"], shape, 3, live)) + 32 * n_live
        n_ops = (n_live * trace_op + tests * OPS["an_sphere"]
                 + roots * OPS["an_root"])
        return dict(lanes=shape.numel(), live_lanes=n_live,
                    sphere_tests=tests, sphere_roots=roots,
                    **bound(n_bytes, n_ops))
    if key == "sky":
        env = a["env_map"] is not None and a["params"].enable_env_map
        texels = cubemap_texels(a["env_map"], a["d"], live) if env else 0
        n_bytes += 24 * n_live + 12 * texels
        n_ops = n_live * (OPS["cubemap"] + 3 if env else OPS["sky"])
        return dict(lanes=shape.numel(), live_lanes=n_live, cubemap=env,
                    texels=texels, **bound(n_bytes, n_ops))
    scene = a["scene"]
    marker = bool(scene.params.point_light_enabled)
    h = a["h"] if key == "an_ao" else a["h0"]
    n_bytes += 12 * (gate_rows(h.p, shape, 3, live)
                     + gate_rows(h.n, shape, 3, live)) + unique_bytes(
                         a["px"], a["py"])
    if key == "an_ao":
        S = int(scene.params.ao_samples)
        reach = ao_reach_lanes(scene, h, shape, sel, marker)
        n_bytes += 4 * n_live
        # every live lane: its normal, origin and remap; a lane within
        # reach of a primitive: its basis once and S rays, each with its
        # two draws, its direction and at least one primitive test
        n_ops = (n_live * (OPS["normalize"] + OPS["origin"] + OPS["ao_remap"])
                 + reach * (OPS["normalize"] + OPS["onb"]
                            + S * (2 * OPS["rand"] + OPS["hemisphere"]
                                   - OPS["normalize"] + OPS["an_sphere"]
                                   + 2)))
        return dict(lanes=shape.numel(), live_lanes=n_live, samples=S,
                    reach_lanes=reach, **bound(n_bytes, n_ops))
    h1, wi, _ = lt.gi_bounce_analytic_plain(scene, h, a["rng_frame"],
                                            a["seed"], a["px"], a["py"])
    n0 = lt.normalize(h.n).expand(shape + (3,)).reshape(-1, 3)[sel]
    org = h.p.expand(shape + (3,)).reshape(-1, 3)[sel] + n0 * 1e-4
    tests, roots = sphere_roots(scene.params, scene.point_light_pos, org,
                                wi.reshape(-1, 3)[sel], True, marker)
    n_bytes += 48 * n_live
    n_ops = (n_live * (2 * OPS["rand"] + OPS["normalize"] + OPS["onb"]
                       + OPS["hemisphere"] + OPS["cos"] + OPS["origin"]
                       + trace_op)
             + tests * OPS["an_sphere"] + roots * OPS["an_root"])
    return dict(lanes=shape.numel(), live_lanes=n_live, sphere_tests=tests,
                sphere_roots=roots, **bound(n_bytes, n_ops))


def check_gate_call(key, a, timer, partial_seed):
    """One recorded call of gate kernel `key` against its dense plain
    version on the card, with the frame's own mask, none, a partial one
    and an empty one: every output bit for bit on the lanes live in both
    the mask and the frame's (the frame's dead lanes hold unspecified
    inputs, which the kernel computes under no mask without faulting),
    else the largest difference is printed and the phase fails; one
    launch each; the call's live lanes, bound and times alone (the
    frame's mask)."""
    import torch
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    shape = gate_shape(key, a)
    plain = gate_unread(key, a)
    want = gate_plain(key, plain)
    g = torch.Generator(device="cuda").manual_seed(partial_seed)
    masks = {"frame": a.get("active"), "none": None,
             "partial": torch.rand(shape, generator=g, device="cuda") < 0.3,
             "empty": torch.zeros(shape, dtype=torch.bool, device="cuda")}
    errs = {}
    for how, mask in masks.items():
        before = cuda_lib.LAUNCHES[key]
        got = gate_call(key, a, mask)
        torch.cuda.synchronize()
        if cuda_lib.LAUNCHES[key] != before + 1:
            raise AssertionError(f"{key} ({how} mask) did not launch once")
        # compared where the mask is live and the frame's mask too: the
        # other lanes' inputs are the frame's unspecified values
        live = _live_of(shape, mask) & _live_of(shape, a.get("active"))
        err = 0.0
        for field, w in want.items():
            x, w = got[field][live], w.expand(got[field].shape)[live]
            if not torch.equal(x, w):
                diff = (x.double() - w.double()).abs()
                err = max(err, float(diff.nan_to_num(float("inf")).max()))
                print(f"an_gates: {key} ({how} mask) {field} differs from "
                      f"the plain version on {int((x != w).sum())} values, "
                      f"max abs {float(diff.max())}", file=sys.stderr,
                      flush=True)
        errs[how] = err
    if any(errs.values()):
        raise AssertionError(f"{key} is not the plain version's bits on "
                             f"live lanes: {errs}")
    live = _live_of(shape, a.get("active"))

    def call():
        gate_call(key, a, a.get("active"))
    return dict(gate_bound(key, a, live), max_abs_err=0.0,
                bitwise="live lanes, masks frame/none/partial/empty",
                ms=timer(call, 20),
                kernel_ms=kernel_ms(call, KERNELS[key]["kernel"]),
                plain_ms=timer(lambda: gate_plain(key, plain), 3))


def _live_of(shape, active):
    import torch
    return (torch.ones(shape, dtype=torch.bool, device="cuda")
            if active is None else active.expand(shape))


def gate_frame(height, width, preset_name, env, timer):
    """Every call one eager analytic frame of the preset makes to the four
    gate kernels (the third of a chain), checked and timed
    (check_gate_call): ({kernel: [call record]}, {kernel: [call
    arguments]})."""
    calls = record_kernel_inputs(None, height, width, "cuda", GATE_KERNELS,
                                 preset_name, PROFILE_FRAME, env=env)
    out = {}
    for n, key in enumerate(GATE_KERNELS):
        out[key] = [check_gate_call(key, a, timer, 17 * n + i)
                    for i, a in enumerate(calls[key])]
    return out, calls


# (ao_radius, ao_samples) at which phase an_gates holds the AO kernel to
# its plain version besides the frame's own (0.8, 4): the viewer's range
# of the radius (0.05-4.0) and its fewest and most samples (1-32)
AO_SWEEP = tuple((r, n) for r in (0.05, 0.8, 4.0) for n in (1, 4, 32)
                 if (r, n) != (0.8, 4))


def ao_sweep(a, timer):
    """The AO call `a` (an_full's) with the scene's ao_radius and
    ao_samples at each of AO_SWEEP, checked and timed as the frame's own
    (check_gate_call: bit for bit with the frame's, no, a partial and an
    empty mask): [call record with its radius and samples]."""
    from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
    out = []
    for n, (radius, samples) in enumerate(AO_SWEEP):
        scene = a["scene"]
        params = scene.params.host.replace(ao_radius=radius,
                                           ao_samples=samples)
        swept = dict(a, scene=SceneCtx.create(params, scene.cam_pos))
        rec = check_gate_call("an_ao", swept, timer, 71 + n)
        out.append(dict(rec, ao_radius=radius, ao_samples=samples))
    return out


def under_bound(calls, *fields, **tag):
    """The calls of `calls` (records with `kernel_ms` and `bound_ms`) whose
    profiled time is under their bound, each as {**tag, call: its index,
    its `fields`, bound_ms, kernel_ms}; a call not measured (kernel_ms
    None) is not under it."""
    return [dict(tag, call=i, **{f: c[f] for f in fields},
                 bound_ms=c["bound_ms"], kernel_ms=c["kernel_ms"])
            for i, c in enumerate(calls)
            if c["kernel_ms"] is not None and c["kernel_ms"] < c["bound_ms"]]


def below_bound(phase, over):
    """Fails `phase` where a call was measured below its bound (`over`: a
    record a call): a bound is a least time, so such a bound is wrong."""
    if over:
        raise AssertionError(f"{phase}: calls measured below their bound: "
                             f"{over}")


def gate_record(calls, prefix=""):
    """A gate kernel's record of one frame: its calls summed (the kernel's
    time a frame, its bound the sum of its calls'), bound by the bound of
    the larger share."""
    if not calls:
        return {}
    by_bytes = sum(c["bound_ms"] for c in calls if c["bound_by"] == "bytes")
    by_ops = sum(c["bound_ms"] for c in calls
                 if c["bound_by"] == "operations")
    kernel = [c["kernel_ms"] for c in calls]
    rec = dict(calls=len(calls), max_abs_err=max(c["max_abs_err"]
                                                 for c in calls),
               ms=sum(c["ms"] for c in calls),
               kernel_ms=sum(kernel) if None not in kernel else None,
               plain_ms=sum(c["plain_ms"] for c in calls),
               bound_ms=by_bytes + by_ops,
               bound_by="bytes" if by_bytes >= by_ops else "operations",
               live_lanes=sum(c["live_lanes"] for c in calls),
               lanes=sum(c["lanes"] for c in calls))
    rec["share"] = (rec["bound_ms"] / rec["kernel_ms"] if rec["kernel_ms"]
                    else None)
    if not prefix:
        rec["calls_detail"] = calls
    return {f"{prefix}{k}": v for k, v in rec.items()}


def check_an_gates(env, frames_an_full, frames_an, timer=None):
    """Phase an_gates: the trace, AO, bounce and sky kernels on every call
    of a 1080p an_full frame (cubemaps/sky_day.png) and of an 800x600
    an_baseline frame, each with its recorded inputs against its plain
    version (check_gate_call), and their launches a frame in the frames
    phases.  Returns the phase's record with `records`, the kernels'
    records of the kernels line (an_full's frame, an_baseline's beside it
    under `an_baseline_` keys)."""
    timer = timer or cuda_ms
    full, calls = gate_frame(HEIGHT, WIDTH, "full", env, timer)
    base, _ = gate_frame(AN_HEIGHT, AN_WIDTH, "baseline", None, timer)
    sweep = ao_sweep(calls["an_ao"][0], timer)
    del calls
    records = {}
    for key in GATE_KERNELS:
        records[key] = dict(gate_record(full[key]),
                            **gate_record(base[key], "an_baseline_"))
    per_frame = {name: {k: run["launches"][k] / run["frames"]
                        for k in GATE_KERNELS + ("an_direct",)}
                 for name, run in (("an_full", frames_an_full),
                                   ("an_baseline", frames_an))}
    over = [r for name, run in (("an_full", full), ("an_baseline", base))
            for k in GATE_KERNELS
            for r in under_bound(run[k], kernel=k, frame=name)]
    over += under_bound(sweep, "ao_radius", "ao_samples", kernel="an_ao",
                        frame="an_full")
    below_bound("an_gates", over)
    fields = ("lanes", "live_lanes", "bound_ms", "bound_by", "bound_bytes",
              "bound_ops", "kernel_ms", "ms", "plain_ms")

    def brief(c, *more):
        # AO's calls also give the lanes their rays were counted on
        more += ("reach_lanes",) if "reach_lanes" in c else ()
        return dict({f: c[f] for f in fields + more},
                    share=c["bound_ms"] / c["kernel_ms"]
                    if c["kernel_ms"] else None)
    records["an_ao"]["ao_sweep"] = [brief(c, "ao_radius", "ao_samples")
                                    for c in sweep]
    return dict(records=records, launches_per_frame=per_frame,
                an_full={k: [brief(c) for c in full[k]]
                         for k in GATE_KERNELS},
                an_baseline={k: [brief(c) for c in base[k]]
                             for k in GATE_KERNELS},
                ao_sweep=records["an_ao"]["ao_sweep"])


# ---- phase an_shade: glass's and the mirror's rays and mix kernels ----

SHADE_RAYS = ("reflect", "straight", "bent")  # glass's secondaries
SENTINEL = 7.0   # the mix kernels' `out` before a check: dead lanes keep it


def shade_shape(key, a):
    if key in ("glass_rays", "mirror_ray"):
        return a["h"].t.shape
    return (a["rays"].k if key == "glass_mix" else a["ray"].hit.t).shape


def shade_plain(key, a):
    """The dense plain version of a call of shade kernel `key` on the card,
    as {output: tensor}: the rays kernels' hits, views, skies (glass: k
    and cos_theta too), the mix kernels' radiance."""
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    if key == "glass_rays":
        r = lt.glass_rays_plain(a["scene"], a["h"], a["wo"], a["mat"])
        out = dict(k=r.k, cos=r.cos_theta)
        for j, ray in enumerate(SHADE_RAYS):
            out.update({f"{ray}_{f}": x
                        for f, x in zip(r.hits[j]._fields, r.hits[j])})
            out.update({f"{ray}_view": r.views[j], f"{ray}_sky": r.skies[j]})
        return out
    if key == "mirror_ray":
        r = lt.mirror_ray_plain(a["scene"], a["h"], a["wo"])
        return dict(zip(r.hit._fields, r.hit), view=r.view, sky=r.sky)
    if key == "glass_mix":
        return dict(radiance=lt.glass_mix_plain(a["scene"], a["h"], a["mat"],
                                                a["rays"], a["lit"]))
    return dict(radiance=lt.mirror_mix_plain(a["scene"], a["h"], a["mat"],
                                             a["ray"], a["direct"], a["gi"]))


def shade_written(key, want, live):
    """{output: the lanes of `live` the kernel writes it on}: a rays
    kernel's skies where the mix reads them (glass: the reflected on
    every live lane, the straight where its ray missed, the bent where it
    refracts and missed; the mirror's where its ray missed), every other
    output on every live lane; from the dense plain outputs `want`."""
    out = {}
    for field in want:
        lanes = live
        if field == "sky":
            lanes = live & ~(want["t"] < 1e30)
        elif field == "straight_sky":
            lanes = live & ~(want["straight_t"] < 1e30)
        elif field == "bent_sky":
            lanes = live & (want["k"] > 0.0) & ~(want["bent_t"] < 1e30)
        out[field] = lanes
    return out


def shade_call(key, a, active, out=None):
    """A call of shade kernel `key`'s wrapper with the mask `active` (and,
    for a mix, the radiance `out`), as {output: tensor}."""
    from opengl_raytracing_tpu_torch.ops import an_shade_cuda
    fn = getattr(an_shade_cuda, KERNELS[key]["wrapper"])
    args = {k: v for k, v in a.items() if k not in ("active", "out")}
    if key in ("glass_rays", "mirror_ray"):
        r = fn(**args, active=active)
        if key == "mirror_ray":
            return dict(zip(r.hit._fields, r.hit), view=r.view, sky=r.sky)
        got = dict(k=r.k, cos=r.cos_theta)
        for j, ray in enumerate(SHADE_RAYS):
            got.update({f"{ray}_{f}": x
                        for f, x in zip(r.hits[j]._fields, r.hits[j])})
            got.update({f"{ray}_view": r.views[j], f"{ray}_sky": r.skies[j]})
        return got
    return dict(radiance=fn(**args, active=active, out=out))


def same_bits(x, w):
    """Equal, NaN where NaN: the kernels' and the plain versions' bits."""
    import torch
    return bool(((x == w) | (torch.isnan(x) & torch.isnan(w))).all())


def shade_bound(key, a, live, want):
    """The least time of one call of shade kernel `key` from the work of
    its live lanes (bound()): the mask's bytes as the kernel reads them,
    the live lanes' distinct input rows, their outputs and the rows a mix
    reads by its selects; the operations of the live lanes' setup, traces
    (the floor test, the winner's point and normal, a sphere test a
    sphere; the roots of the spheres whose disc test passes and the
    cubemap's texels are not counted, so the bound stays a lower one),
    skies and mixes."""
    shape = shade_shape(key, a)
    n_live = int(live.sum())
    mask = a.get("active")
    n_bytes = 0 if mask is None else gate_mask_bytes(mask, shape)
    written = shade_written(key, want, live)
    params = a["scene"].params
    marker = int(bool(params.point_light_enabled))
    env = a["scene"].env_map is not None and params.enable_env_map
    sky_op = OPS["cubemap"] + 3 if env else OPS["sky"]
    trace_op = OPS["an_floor"] + OPS["hit_out"]
    if key in ("glass_rays", "mirror_ray"):
        h, wo = a["h"], a["wo"]
        n_bytes += 12 * (gate_rows(h.p, shape, 3, live)
                         + gate_rows(h.n, shape, 3, live)
                         + gate_rows(wo, shape, 3, live))
        skies = sum(int(written[f].sum()) for f in written
                    if f.endswith("sky"))
        n_bytes += 12 * skies
        if key == "glass_rays":
            # the material id a row, the camera's position, three hits
            # and views (t, p, n, id, view: 44 B), k and cos
            n_bytes += 4 * gate_rows(h.mat, shape, 0, live) + 12
            n_bytes += n_live * (3 * 44 + 8)
            # setup: two normalizes, the ior, eta, reflect, cos, refract,
            # t_dir's mix and two normalizes: ~90; a ray: its origin, the
            # trace without the glass sphere, its view (sub and normalize)
            n_ops = n_live * (90 + 3 * (OPS["origin"] + trace_op
                                        + (2 + marker) * OPS["an_sphere"]
                                        + 3 + OPS["normalize"]))
        else:
            n_bytes += n_live * 44
            n_ops = n_live * (2 * OPS["normalize"] + 9 + OPS["origin"]
                              + trace_op + (3 + marker) * OPS["an_sphere"]
                              + 3)
        n_ops += skies * sky_op
    elif key == "glass_mix":
        valid = [want_t < 1e30 for want_t in (a["rays"].hits[j].t
                                              for j in range(3))]
        k_pos = (a["rays"].k > 0.0).expand(shape) & live
        n_bytes += 4 * gate_rows(a["h"].mat, shape, 0, live)
        # t x 3, k, cos, the reflected sky, the output; the reflected
        # light where it hit, the straight ray's light or sky, the bent
        # ray's where it refracts
        n_bytes += n_live * (12 + 8 + 12 + 12 + 12)
        n_bytes += 12 * (int((valid[0].expand(shape) & live).sum())
                         + int(k_pos.sum()))
        n_ops = n_live * 50 + int(k_pos.sum()) * 12
    else:
        valid = a["ray"].hit.t.expand(shape) < 1e30
        hit = valid & live
        n_hit = int(hit.sum())
        gi = a["gi"] is not None
        n_bytes += 4 * gate_rows(a["h"].mat, shape, 0, live)
        # t, the output; where the ray hit its id, the direct light and,
        # with GI, the bounce's t, cos and light or sky; else the sky
        n_bytes += n_live * 16 + n_hit * (16 + gi * 20) \
            + (n_live - n_hit) * 12
        n_ops = n_live * 4 + n_hit * (3 + gi * 21)
    return dict(lanes=shape.numel(), live_lanes=n_live, **bound(n_bytes,
                                                                n_ops))


def check_shade_call(key, a, timer, partial_seed):
    """One recorded call of shade kernel `key` against its dense plain
    version on the card, with the frame's own mask, none, a partial one
    and an empty one: every output bit for bit on the lanes live in both
    the mask and the frame's and written there (a rays kernel's skies
    where the mix reads them), a mix's `out` untouched on its dead lanes
    (filled with SENTINEL before), one launch each; else the difference
    is printed and the phase fails.  The call's live lanes, bound and
    times alone (the frame's mask)."""
    import torch
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    shape = shade_shape(key, a)
    want = shade_plain(key, a)
    frame_live = _live_of(shape, a.get("active"))
    g = torch.Generator(device="cuda").manual_seed(partial_seed)
    masks = {"frame": a.get("active"), "none": None,
             "partial": torch.rand(shape, generator=g, device="cuda") < 0.3,
             "empty": torch.zeros(shape, dtype=torch.bool, device="cuda")}
    mix = key in ("glass_mix", "mirror_mix")
    bad = {}
    for how, mask in masks.items():
        before = cuda_lib.LAUNCHES[key]
        out = (torch.full(shape + (3,), SENTINEL, device="cuda") if mix
               else None)
        got = shade_call(key, a, mask, out)
        torch.cuda.synchronize()
        if cuda_lib.LAUNCHES[key] != before + 1:
            raise AssertionError(f"{key} ({how} mask) did not launch once")
        mask_live = _live_of(shape, mask)
        for field, lanes in shade_written(key, want,
                                          mask_live & frame_live).items():
            x = got[field]
            w = want[field].expand(x.shape)
            x, w = x[lanes], w[lanes]
            if not same_bits(x, w):
                diff = (x.double() - w.double()).abs()
                n = int(((x != w) & ~(x.isnan() & w.isnan())).sum())
                bad[f"{how}:{field}"] = n
                print(f"an_shade: {key} ({how} mask) {field} differs from "
                      f"the plain version on {n} values, max abs "
                      f"{float(diff.nan_to_num(float('inf')).max())}",
                      file=sys.stderr, flush=True)
        if mix and not bool((out[~mask_live] == SENTINEL).all()):
            bad[f"{how}:dead lanes written"] = int(
                (out[~mask_live] != SENTINEL).any(-1).sum())
    if bad:
        raise AssertionError(f"{key} is not the plain version's bits on "
                             f"live lanes: {bad}")

    def call():
        shade_call(key, a, a.get("active"), a.get("out") if mix else None)
    # a mix call writes into the frame's radiance: time it on a copy
    if mix:
        a = dict(a, out=a["out"].clone())
    return dict(shade_bound(key, a, frame_live, want), max_abs_err=0.0,
                bitwise="live lanes, masks frame/none/partial/empty",
                ms=timer(call, 20),
                kernel_ms=kernel_ms(call, KERNELS[key]["kernel"]),
                plain_ms=timer(lambda: shade_plain(key, a), 3))


def shade_frame(height, width, preset_name, env, timer):
    """Every call one eager analytic frame of the preset makes to the four
    shade kernels (the third of a chain), checked and timed
    (check_shade_call): {kernel: [call record]}."""
    calls = record_kernel_inputs(None, height, width, "cuda", SHADE_KERNELS,
                                 preset_name, PROFILE_FRAME, env=env)
    return {key: [check_shade_call(key, a, timer, 31 * n + i)
                  for i, a in enumerate(calls[key])]
            for n, key in enumerate(SHADE_KERNELS)}


def check_an_shade(env, frames_an_full, frames_an, timer=None):
    """Phase an_shade: glass's and the mirror's rays and mix kernels on
    every call of a 1080p an_full frame (cubemaps/sky_day.png) and of an
    800x600 an_baseline frame, each with its recorded inputs against its
    plain version (check_shade_call), and their launches a frame in the
    frames phases.  Returns the phase's record with `records`, the
    kernels' records of the kernels line (an_full's frame, an_baseline's
    beside it under `an_baseline_` keys)."""
    timer = timer or cuda_ms
    full = shade_frame(HEIGHT, WIDTH, "full", env, timer)
    base = shade_frame(AN_HEIGHT, AN_WIDTH, "baseline", None, timer)
    records = {key: dict(gate_record(full[key]),
                         **gate_record(base[key], "an_baseline_"))
               for key in SHADE_KERNELS}
    per_frame = {name: {k: run["launches"][k] / run["frames"]
                        for k in SHADE_KERNELS + GATE_KERNELS
                        + ("an_direct",)}
                 for name, run in (("an_full", frames_an_full),
                                   ("an_baseline", frames_an))}
    over = [r for name, run in (("an_full", full), ("an_baseline", base))
            for k in SHADE_KERNELS
            for r in under_bound(run[k], kernel=k, frame=name)]
    below_bound("an_shade", over)
    fields = ("lanes", "live_lanes", "bound_ms", "bound_by", "bound_bytes",
              "kernel_ms", "ms", "plain_ms")
    return dict(records=records, launches_per_frame=per_frame,
                an_full={k: [{f: c[f] for f in fields} for c in full[k]]
                         for k in SHADE_KERNELS},
                an_baseline={k: [{f: c[f] for f in fields} for c in base[k]]
                             for k in SHADE_KERNELS})


# ---- phase hit_mix: both scenes' shading tails ----

# (label, BVH scene, preset, size, cubemap) of each frame the phase checks;
# the label prefixes the frame's keys in the kernels line (the first of
# each kernel's is its main record)
HIT_MIX_FRAMES = (("full", True, "full", (HEIGHT, WIDTH), False),
                  ("heavy", True, "heavy", (HEIGHT, WIDTH), False),
                  ("an_full", False, "full", (HEIGHT, WIDTH), True),
                  ("an_baseline", False, "baseline", (AN_HEIGHT, AN_WIDTH),
                   False),
                  ("an_heavy", False, "heavy", (HEIGHT, WIDTH), False))


def hit_mix_plain(key, a):
    """The dense plain version of a call of hit-mix kernel `key` on the
    card: the radiance."""
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    if key == "bvh_hit_mix":
        return lt.bvh_hit_mix_plain(a["scene"], a["radiance"], a["gi"],
                                    a["ao"])
    return lt.an_hit_mix_plain(a["scene"], a["h"], a["radiance"], a["gi"],
                               a["ao"])


def hit_mix_unread(a, live):
    """The arguments `a` of a hit-mix call with the per-lane inputs (the
    radiance, AO, GI's rows) set to valid values on the lanes `live` marks
    dead (unread); the live lanes as they were."""
    up = (0.0, 1.0, 0.0)
    shape = live.shape

    def fill(x, value):
        if x is None:
            return None
        return unread(x.expand(shape + x.shape[len(shape):]), live, value)
    out = dict(a, radiance=fill(a["radiance"], up), ao=fill(a["ao"], 1.0))
    gi = a["gi"]
    if gi is not None:
        rows = dict(hit=gi.hit._replace(t=fill(gi.hit.t, 1.0)),
                    cos_theta=fill(gi.cos_theta, 0.5), lit=fill(gi.lit, up))
        if hasattr(gi, "wi"):
            rows["wi"] = fill(gi.wi, up)
        else:
            rows["sky"] = fill(gi.sky, up)
        out["gi"] = gi._replace(**rows)
    return out


def hit_mix_writes(key, a, shape):
    """The lanes hit-mix kernel `key` writes where its mask is live: every
    one (BVH), the diffuse and the marker lanes (analytic)."""
    import torch
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    if key == "bvh_hit_mix":
        return torch.ones(shape, dtype=torch.bool, device="cuda")
    return lt.an_mix_lanes(a["h"].mat, a["scene"].params).expand(shape)


def hit_mix_bound(key, a, live, writes):
    """The least time of one call of hit-mix kernel `key` from the work of
    its live lanes (bound()): the mask's bytes as the kernel reads them;
    a written lane's radiance in and out, AO's distinct rows, and with GI
    its t and cosine, then where the cut keeps it its light (a hit) or
    direction (a miss) and the sky's distinct texels (BVH) or its light
    or sky (analytic); the analytic call's material ids, the marker's
    point and the camera; the operations of that arithmetic."""
    from opengl_raytracing_tpu_torch.constants import GI_MIN_COS_THETA
    shape = live.shape
    mask = a.get("active")
    n_bytes = 0 if mask is None else gate_mask_bytes(mask, shape)
    w = live & writes
    n_w = int(w.sum())
    gi, ao = a["gi"], a["ao"]
    params = a["scene"].params
    n_ops = 0
    if key == "an_hit_mix":
        marker = w & (a["h"].mat.expand(shape) == 4)
        n_marker = int(marker.sum())
        mixed = w & ~marker
        n_mix = n_w - n_marker
        n_bytes += 4 * gate_rows(a["h"].mat, shape, 0, live)
        n_bytes += 12 * gate_rows(a["h"].p, shape, 3, marker) + 12
        n_bytes += 24 * n_mix + 12 * n_marker
        # the marker: p - cam 3, dot 5, max and sqrt 2, the falloff 5, the
        # colour 3, the emissive 3; a mixed lane's type 5
        n_ops += 21 * n_marker + 5 * int(live.sum())
        if gi is not None:
            # t, cos, the light or the sky; the select, cos * inv_pi,
            # albedo, li, the cut, the scale and the sum
            n_bytes += 20 * n_mix
            n_ops += 15 * n_mix
    else:
        mixed, n_mix = w, n_w
        n_bytes += 24 * n_mix
        if gi is not None:
            kept = mixed & (gi.cos_theta.expand(shape) > GI_MIN_COS_THETA)
            miss = kept & ~(gi.hit.t.expand(shape) < 1e30)
            n_kept, n_miss = int(kept.sum()), int(miss.sum())
            n_bytes += 8 * n_mix + 12 * n_kept
            env = a["scene"].env_map is not None and params.enable_env_map
            texels = (cubemap_texels(a["scene"].env_map, gi.wi, miss)
                      if env and n_miss else 0)
            n_bytes += 12 * texels
            # the cut 1; a kept lane's select, albedo * q 4, li 3, lum 5,
            # the clamp's test 1 and scale 4, the scale and the sum 6
            n_ops += n_mix + 24 * n_kept + n_miss * (
                OPS["cubemap"] + 3 if env else OPS["sky"])
            n_ops += 6 * (n_mix - n_kept)
    if ao is not None:
        n_bytes += 4 * gate_rows(ao, shape, 0, mixed)
        n_ops += 3 * n_mix
    return dict(lanes=shape.numel(), live_lanes=int(live.sum()),
                written_lanes=n_w, **bound(n_bytes, n_ops))


def check_hit_mix_call(key, a, timer, partial_seed):
    """One recorded call of hit-mix kernel `key` against its dense plain
    version on the card, with the frame's own mask, none, a partial one
    and an empty one: the radiance bit for bit on the lanes live in both
    the mask and the frame's that the kernel writes, every other lane of
    `out` untouched (SENTINEL before the call), one launch each; else the
    difference is printed and the phase fails.  The call's live lanes,
    bound and times alone (the frame's mask)."""
    import torch
    from opengl_raytracing_tpu_torch.ops import cuda_lib, hit_mix_cuda
    shape = a["radiance"].shape[:-1]
    frame_live = _live_of(shape, a.get("active"))
    plain = hit_mix_unread(a, frame_live)
    want = hit_mix_plain(key, plain)
    writes = hit_mix_writes(key, a, shape)
    g = torch.Generator(device="cuda").manual_seed(partial_seed)
    masks = {"frame": a.get("active"), "none": None,
             "partial": torch.rand(shape, generator=g, device="cuda") < 0.3,
             "empty": torch.zeros(shape, dtype=torch.bool, device="cuda")}
    fn = getattr(hit_mix_cuda, KERNELS[key]["wrapper"])
    args = {k: v for k, v in plain.items() if k not in ("active",
                                                        "radiance")}
    bad = {}
    for how, mask in masks.items():
        written = _live_of(shape, mask) & writes
        out = torch.where(written[..., None], plain["radiance"],
                          torch.full_like(plain["radiance"], SENTINEL))
        before = cuda_lib.LAUNCHES[key]
        fn(**args, radiance=out, active=mask)
        torch.cuda.synchronize()
        if cuda_lib.LAUNCHES[key] != before + 1:
            raise AssertionError(f"{key} ({how} mask) did not launch once")
        both = written & frame_live
        x, w = out[both], want[both]
        if not same_bits(x, w):
            diff = (x.double() - w.double()).abs()
            n = int(((x != w) & ~(x.isnan() & w.isnan())).sum())
            bad[f"{how}:radiance"] = n
            print(f"hit_mix: {key} ({how} mask) differs from the plain "
                  f"version on {n} values, max abs "
                  f"{float(diff.nan_to_num(float('inf')).max())}",
                  file=sys.stderr, flush=True)
        if not bool((out[~written] == SENTINEL).all()):
            bad[f"{how}:dead lanes written"] = int(
                (out[~written] != SENTINEL).any(-1).sum())
    if bad:
        raise AssertionError(f"{key} is not the plain version's bits on "
                             f"live lanes: {bad}")
    radiance = plain["radiance"].clone()

    def call():  # in place on a copy of the frame's radiance
        fn(**args, radiance=radiance, active=a.get("active"))
    return dict(hit_mix_bound(key, a, frame_live, writes), max_abs_err=0.0,
                bitwise="written live lanes, masks frame/none/partial/empty",
                ms=timer(call, 20),
                kernel_ms=kernel_ms(call, KERNELS[key]["kernel"]),
                plain_ms=timer(lambda: hit_mix_plain(key, plain), 3))


def check_hit_mix(bvh, env, runs, timer=None):
    """Phase hit_mix: both hit-mix kernels on every call of HIT_MIX_FRAMES'
    frames (the third of a chain), each against its plain version
    (check_hit_mix_call), and their launches a frame in the frames phases
    `runs` ({label: run_frames record}).  Returns the phase's record with
    `records`, the kernels' records of the kernels line (each kernel's
    first frame; the others beside it under their label's keys)."""
    timer = timer or cuda_ms
    frames = {}
    for label, on_bvh, preset_name, (h, w), cube in HIT_MIX_FRAMES:
        key = "bvh_hit_mix" if on_bvh else "an_hit_mix"
        calls = record_kernel_inputs(bvh if on_bvh else None, h, w, "cuda",
                                     (key,), preset_name, PROFILE_FRAME,
                                     env=env if cube else None)[key]
        if len(calls) != 1:
            raise AssertionError(f"a {label} frame called {key} "
                                 f"{len(calls)} times")
        frames[label] = (key, [check_hit_mix_call(key, a, timer, 41 * n)
                               for n, a in enumerate(calls)])
    records = {}
    for label, (key, calls) in frames.items():
        rec = records.setdefault(key, {})
        rec.update(gate_record(calls, "" if not rec else f"{label}_"))
    per_frame = {name: {k: run["launches"][k] / run["frames"]
                        for k in HIT_MIX_KERNELS + ("sky",)}
                 for name, run in runs.items()}
    over = [r for label, (key, calls) in frames.items()
            for r in under_bound(calls, kernel=key, frame=label)]
    below_bound("hit_mix", over)
    fields = ("lanes", "live_lanes", "written_lanes", "bound_ms",
              "bound_by", "bound_bytes", "kernel_ms", "ms", "plain_ms")
    return dict(records=records, launches_per_frame=per_frame,
                frames={label: [{f: c[f] for f in fields} for c in calls]
                        for label, (_, calls) in frames.items()})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from opengl_raytracing_tpu_torch.ops import cuda_lib

    t0 = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    phase("device", t0, name=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    libs = cuda_lib.build_all()
    ptxas = {}
    for name, lib in libs.items():
        with open(lib[:-3] + ".log") as fh:
            ptxas[name] = [ln.strip() for ln in fh
                           if "registers" in ln or "spill" in ln]
    print("ptxas " + json.dumps(ptxas_of(libs["an_direct"][:-3] + ".log",
                                         KERNELS["bvh_direct"]["kernel"])),
          flush=True)
    phase("build", t0, seconds=time.time() - t0,
          libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          ptxas=ptxas)

    t0 = time.time()
    phase("native", t0, **check_native(smi))

    t0 = time.time()
    _, bvh = scene("cuda")
    records = check_kernels(bvh)
    records.update(check_an_kernel())
    env = sky_day("cuda")
    records.update(check_an_kernel(HEIGHT, WIDTH, preset_name="full",
                                   env=env))
    records.update(check_full_kernels(bvh))
    phase("kernels", t0, **records)

    t0 = time.time()
    frames = run_frames(bvh, HEIGHT, WIDTH, BVH_PATH, "verify_torch_bvh.png",
                        smi)
    phase("frames", t0, **frames)

    t0 = time.time()
    _, bvh_cpu = scene("cpu")
    phase("reference", t0, **check_reference(bvh, bvh_cpu, REF_HEIGHT,
                                             REF_WIDTH))

    t0 = time.time()
    phase("profile", t0, **profile(bvh, HEIGHT, WIDTH, BVH_STAGES,
                                   frames["ms_per_frame"]))

    t0 = time.time()
    frames_an = run_frames(None, AN_HEIGHT, AN_WIDTH, AN_PATH,
                           "verify_torch_analytic.png", smi,
                           expect=AN_BASELINE_LAUNCHES)
    phase("frames_analytic", t0, **frames_an)

    t0 = time.time()
    phase("reference_analytic", t0, **check_reference(
        None, None, AN_REF_HEIGHT, AN_REF_WIDTH, lanes=True))

    t0 = time.time()
    phase("profile_analytic", t0, **profile(None, AN_HEIGHT, AN_WIDTH,
                                            AN_STAGES,
                                            frames_an["ms_per_frame"]))

    t0 = time.time()
    frames_full = run_frames(bvh, HEIGHT, WIDTH, FULL_PATH,
                             "verify_torch_full.png", smi, "full")
    phase("frames_full", t0, **frames_full)

    t0 = time.time()
    phase("reference_full", t0, **check_reference(
        bvh, bvh_cpu, REF_HEIGHT, REF_WIDTH, "full", REF_FRAMES))

    t0 = time.time()
    phase("reference_analytic_full", t0, **check_reference(
        None, None, AN_FULL_REF_HEIGHT, AN_FULL_REF_WIDTH, "full",
        REF_FRAMES))

    t0 = time.time()
    prof_full = profile(bvh, HEIGHT, WIDTH, FULL_STAGES,
                        frames_full["ms_per_frame"], "full", PROFILE_FRAME)
    phase("profile_full", t0, **prof_full)

    # TAA's still-camera skip: the `full` chain above ran with the host
    # flag (moved=False: the still path alone); the same chain with the
    # flag unknown runs the branch-free form and must give the same frames
    t0 = time.time()
    branch_free = run_frames(bvh, HEIGHT, WIDTH, FULL_PATH, None, smi, "full",
                             moved=None)
    if branch_free["checksum"] != frames_full["checksum"]:
        raise AssertionError(
            f"TAA's skip changed the frames: checksum "
            f"{frames_full['checksum']} with it, {branch_free['checksum']} "
            f"in the branch-free form")
    prof_free = profile(bvh, HEIGHT, WIDTH, FULL_STAGES,
                        branch_free["ms_per_frame"], "full", PROFILE_FRAME,
                        moved=None)
    phase("taa_skip", t0, checksum_skip=frames_full["checksum"],
          checksum_branch_free=branch_free["checksum"],
          taa_device_ms_skip=prof_full.get("stages_device_ms", {}).get("taa"),
          taa_device_ms_branch_free=prof_free.get(
              "stages_device_ms", {}).get("taa"),
          device_busy_ms_skip=prof_full.get("device_busy_ms"),
          device_busy_ms_branch_free=prof_free.get("device_busy_ms"),
          kernel_launches_skip=prof_full.get("kernel_launches"),
          kernel_launches_branch_free=prof_free.get("kernel_launches"),
          ms_per_frame_skip=frames_full["ms_per_frame"],
          ms_per_frame_branch_free=branch_free["ms_per_frame"])

    # the bench's an_full: the analytic scene, `full` preset, day-sky cubemap
    t0 = time.time()
    frames_an_full = run_frames(None, HEIGHT, WIDTH, AN_FULL_PATH,
                                "verify_torch_an_full.png", smi, "full",
                                expect=AN_FULL_LAUNCHES, env=env)
    phase("frames_an_full", t0, **frames_an_full)

    t0 = time.time()
    phase("reference_an_full", t0, **check_reference(
        None, None, AN_FULL_REF_HEIGHT, AN_FULL_REF_WIDTH, "full",
        REF_FRAMES, env=True))

    t0 = time.time()
    phase("profile_an_full", t0, **profile(
        None, HEIGHT, WIDTH, AN_FULL_STAGES, frames_an_full["ms_per_frame"],
        "full", PROFILE_FRAME, env=env))

    # the analytic occupancy gates: the trace, AO, bounce and sky kernels
    # on every call of an an_full and an an_baseline frame
    t0 = time.time()
    gates = check_an_gates(env, frames_an_full, frames_an)
    records.update(gates.pop("records"))
    phase("an_gates", t0, **gates)

    # glass's and the mirror's rays and mix kernels on every call of an
    # an_full and an an_baseline frame
    t0 = time.time()
    shade = check_an_shade(env, frames_an_full, frames_an)
    records.update(shade.pop("records"))
    phase("an_shade", t0, **shade)

    # the bench's heavy: 4 samples a pixel on the bunny scene
    t0 = time.time()
    frames_heavy = run_frames(bvh, HEIGHT, WIDTH, FULL_PATH, None, smi,
                              "heavy", expect=HEAVY_LAUNCHES)
    phase("frames_heavy", t0, **frames_heavy)

    t0 = time.time()
    phase("reference_heavy", t0, **check_reference(
        bvh, bvh_cpu, REF_HEIGHT, REF_WIDTH, "heavy", REF_FRAMES))

    t0 = time.time()
    phase("profile_heavy", t0, **profile(
        bvh, HEIGHT, WIDTH, FULL_STAGES, frames_heavy["ms_per_frame"],
        "heavy", PROFILE_FRAME))

    # both scenes' shading tails on every call of the BVH `full` and
    # `heavy` frames and the an_full, an_baseline and analytic `heavy` ones
    t0 = time.time()
    hit_mix = check_hit_mix(bvh, env, {
        "full": frames_full, "heavy": frames_heavy,
        "an_full": frames_an_full, "an_baseline": frames_an})
    records.update(hit_mix.pop("records"))
    phase("hit_mix", t0, **hit_mix)

    # the bench's moving: `full` with a camera that moves every frame
    t0 = time.time()
    frames_moving = run_frames(bvh, HEIGHT, WIDTH, FULL_PATH, None, smi,
                               "full", camera="moving")
    phase("frames_moving", t0, **frames_moving)

    t0 = time.time()
    phase("reference_motion_view", t0, **check_reference(
        bvh, bvh_cpu, REF_HEIGHT, REF_WIDTH, "full", 2, camera="moving",
        show_motion=True))

    t0 = time.time()
    phase("reference_moving", t0, **check_reference(
        bvh, bvh_cpu, REF_HEIGHT, REF_WIDTH, "full", REF_FRAMES,
        camera="moving"))

    t0 = time.time()
    phase("profile_moving", t0, **profile(
        bvh, HEIGHT, WIDTH, FULL_STAGES, frames_moving["ms_per_frame"],
        "full", PROFILE_FRAME, camera="moving"))

    t0 = time.time()
    phase("reference_raster", t0, **check_raster_reference(
        bvh, bvh_cpu, REF_HEIGHT, REF_WIDTH))

    # the BVH-heavy scene (bench.py's measure_closefar): 81,920 triangles,
    # baseline, the close and the far camera
    tris6, bvh6 = scene("cuda", HEAVY_SUBDIV)
    frames_cf, prof_cf = {}, {}
    for name in CF_CAMERAS:
        t0 = time.time()
        frames_cf[name] = run_frames(bvh6, HEIGHT, WIDTH, BVH_PATH,
                                     f"verify_torch_{name}.png", smi,
                                     expect=CF_LAUNCHES, camera=name)
        prof_cf[name] = profile(bvh6, HEIGHT, WIDTH, BVH_STAGES,
                                frames_cf[name]["ms_per_frame"], camera=name)
        phase(f"frames_{name}", t0, **frames_cf[name],
              **{k: prof_cf[name].get(k) for k in (
                  "device_busy_ms", "idle_share", "kernel_launches",
                  "kernels_device_ms")})

    t0 = time.time()
    records_cf = check_cf_kernels(bvh6, tris6)
    phase("kernels_cf", t0, **records_cf)

    t0 = time.time()
    _, bvh6_cpu = scene("cpu", HEAVY_SUBDIV)
    phase("reference_cf", t0, **{
        name: check_reference(bvh6, bvh6_cpu, REF_HEIGHT, REF_WIDTH,
                              camera=name) for name in CF_CAMERAS})

    t0 = time.time()
    phase("profile_cf_close", t0, **prof_cf["cf_close"])

    t0 = time.time()
    graph_run = check_graph(bvh, bvh6, env, smi)
    phase("graph", t0, **graph_run)

    t0 = time.time()
    spp_batch = check_spp_batch(bvh, frames_heavy, graph_run["heavy"])
    phase("spp_batch", t0, **spp_batch)

    t0 = time.time()
    phase("params", t0, **check_params(smi))

    t0 = time.time()
    phase("raster", t0, **check_raster_graph(smi))

    t0 = time.time()
    app_run = check_app_headless(frames_full, frames_an_full, smi)
    phase("app_headless", t0, **app_run)

    t0 = time.time()
    phase("app_viewer", t0, **check_app_viewer(smi),
          jpeg_stream=check_viewer_jpeg(smi))

    t0 = time.time()
    sharded = check_sharded(bvh, frames_full, frames_moving, smi)
    phase("sharded", t0, **sharded)
    band = sharded["band_kernels"]["band"]

    t0 = time.time()
    phase("bench", t0, **check_bench({
        "baseline": frames, "full": frames_full, "heavy": frames_heavy,
        "moving": frames_moving, "an_baseline": frames_an,
        "an_full": frames_an_full, "cf_close": frames_cf["cf_close"],
        "cf_far": frames_cf["cf_far"]}))
    sharded_launches = sharded["nccl_one_rank_still"]["launches"]
    # a replayed one-rank band frame: what the counters add a replay, and
    # what the profiler saw the card run
    sharded_replay = sharded["nccl_one_rank_still_replay_vs_eager"]

    # each kernel's own count in the newest path that must run it; a
    # kernel no path runs (the filter entry alone) as `full` counted it
    launches = dict(frames_full["launches"])
    for path, run in ((AN_PATH, frames_an), (BVH_PATH, frames),
                      (FULL_PATH, frames_full)):
        launches.update({k: run["launches"][k] for k in path})
    # the analytic gates' kernels as the an_full chain launched them
    launches.update({k: frames_an_full["launches"][k]
                     for k in GATE_KERNELS + SHADE_KERNELS + ("an_hit_mix",)})
    launches["an_direct_env"] = frames_an_full["launches"]["an_direct"]
    # a replay's launches, summed over the graph phase's cases: what the
    # counters add a replay, and what the profiler saw the card run
    replayed = {how: {k: sum(graph_run[name][key].get(k, 0)
                             for name in GRAPH_CASES)
                      for k in frames_full["launches"]}
                for how, key in (("counted", "launches_per_replay"),
                                 ("profiled",
                                  "launches_per_replay_profiled"))}

    def line(k):
        r = records[k]
        return dict(name=KERNELS[k]["name"], route="cuda",
                    source=KERNELS[k]["source"],
                    replaces=KERNELS[k]["replaces"], launches=launches[k],
                    on_main_path=k in (BVH_PATH + AN_PATH + FULL_PATH
                                       + AN_FULL_PATH + ("an_direct_env",)),
                    port_only=bool(KERNELS[k].get("port_only")),
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], kernel_ms=r["kernel_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    share=(r["bound_ms"] / r["kernel_ms"]
                           if r["kernel_ms"] else None),
                    app_launches=app_run["launches_all"][k],
                    sharded_launches=sharded_launches[
                        KERNELS[k].get("counter", k)],
                    sharded_replay_launches=sharded_replay[
                        "launches_per_replay"].get(
                            KERNELS[k].get("counter", k), 0),
                    sharded_replay_launches_profiled=sharded_replay[
                        "launches_per_replay_profiled"].get(
                            KERNELS[k].get("counter", k), 0),
                    replay_launches=replayed["counted"][
                        KERNELS[k].get("counter", k)],
                    replay_launches_profiled=replayed["profiled"][
                        KERNELS[k].get("counter", k)],
                    library_ms=None)  # no single PyTorch call computes these

    def band_keys(k):
        # K4's fused entry on one 270-row band with its halo (sharded (a))
        if k != "svgf_present":
            return {}
        return dict(band_kernel_ms=band["kernel_ms"], band_ms=band["ms"],
                    band_plain_ms=band["plain_ms"],
                    band_bound_ms=band["bound_ms"],
                    band_bound_by=band["bound_by"])
    def spp_keys(k):
        # the kernels that take the sample axis: their batched call of a
        # 1080p `heavy` frame (phase spp_batch; K3: the analytic `heavy`
        # frame's primary call), one single-sample call beside it
        axis = KERNELS[k]["kernel"] in SAMPLE_AXIS_KERNELS
        r = spp_batch["records"].get(k)
        if r is None:
            return dict(sample_axis=axis)
        return dict(sample_axis=axis,
                    heavy_launches=launches_heavy.get(k),
                    spp_kernel_ms=r["kernel_ms"], spp_ms=r["ms"],
                    spp_plain_ms=r["plain_ms"], spp_bound_ms=r["bound_ms"],
                    spp_bound_by=r["bound_by"], spp_share=r["share"],
                    spp_max_abs_err=r["max_abs_err"],
                    spp_single_kernel_ms=r["single_kernel_ms"])
    launches_heavy = spp_batch["heavy_launches_per_frame"]

    def cf_keys(k):
        # the BVH-heavy scene: launches of the two 32-frame chains; K1 and
        # the BVH direct light alone on a cf_close frame's inputs
        if k not in BVH_PATH:
            return {}
        out = {f"{name}_launches": frames_cf[name]["launches"][k]
               for name in CF_CAMERAS}
        r = records_cf.get(k)
        if r is not None:
            out.update(cf_close_kernel_ms=r["kernel_ms"],
                       cf_close_ms=r["ms"], cf_close_plain_ms=r["plain_ms"],
                       cf_close_bound_ms=r["bound_ms"],
                       cf_close_bound_by=r["bound_by"],
                       cf_close_share=r["share"])
        return out
    def gate_keys(k):
        # the analytic gates' kernels: their calls on an an_baseline frame
        # beside the an_full frame's of the line (phase an_gates); the hit
        # mixes' on the other frames of phase hit_mix
        r = records.get(k, {})
        return {key: r[key] for key in r if key.startswith(
            ("an_baseline_", "heavy_", "an_heavy_"))}
    print(json.dumps({"kernels": [dict(line(k), **band_keys(k), **cf_keys(k),
                                       **spp_keys(k), **gate_keys(k))
                                  for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# phase graph: each case's (scene, preset, size, how) as its frames phase
# renders it, and its checksum of 32 frames as PR 11's frames phases gave
# it (H100 80GB HBM3, 700 W); the eager frame and the replayed one must
# both give it, bit for bit
GRAPH_CASES = {
    "baseline": ("bvh", "baseline", (HEIGHT, WIDTH), {}),
    "an_baseline": (None, "baseline", (AN_HEIGHT, AN_WIDTH), {}),
    "full": ("bvh", "full", (HEIGHT, WIDTH), {}),
    "an_full": (None, "full", (HEIGHT, WIDTH), {"env": True}),
    "heavy": ("bvh", "heavy", (HEIGHT, WIDTH), {}),
    "moving": ("bvh", "full", (HEIGHT, WIDTH), {"camera": "moving"}),
    "cf_close": ("bvh6", "baseline", (HEIGHT, WIDTH),
                 {"camera": "cf_close"}),
    "cf_far": ("bvh6", "baseline", (HEIGHT, WIDTH), {"camera": "cf_far"}),
}
PR11_CHECKSUMS = dict(baseline=87087872.0, an_baseline=26648676.0,
                      full=87136776.0, an_full=141605440.0,
                      heavy=87136776.0, moving=86964288.0,
                      cf_close=54046920.0, cf_far=90449184.0)
HOST_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
              "cudaStreamSynchronize")


def frame_events(fn, reps=3):
    """A call of `fn` as the profiler sees it, a call's worth over `reps`
    calls (`fn` called once before, unprofiled): device busy ms, device
    operations (kernels, copies, fills), host-to-device copies, and the
    host's CUDA runtime calls HOST_CALLS.  A window that saw no device
    activity is taken again, up to PROFILE_ATTEMPTS times; then the
    device numbers are None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        dev = [ev for ev in rows if ev.device_type == DeviceType.CUDA]
        host = {k: sum(ev.count for ev in rows if ev.key == k) / reps
                for k in HOST_CALLS}
        if dev:
            return dict(
                device_ms=sum(ev.self_device_time_total
                              for ev in dev) / 1e3 / reps,
                device_ops=sum(ev.count for ev in dev) / reps,
                h2d_copies=sum(ev.count for ev in dev
                               if "HtoD" in ev.key) / reps,
                host_calls=host, attempts=attempt)
        print(f"profile {attempt} of a frame saw no device activity",
              file=sys.stderr, flush=True)
    return dict(device_ms=None, device_ops=None, h2d_copies=None,
                host_calls=host, attempts=PROFILE_ATTEMPTS)


def kernel_rows(rows):
    """{launch counter: launches} of the hand-written kernels among the
    profiler's device rows, by kernel name."""
    return {k: sum(ev.count for ev in rows
                   if is_kernel(ev.key, KERNELS[k]["kernel"]))
            for k in KERNELS if "counter" not in KERNELS[k]}


def profiled_launches(fn, expect, reps=5):
    """Each hand-written kernel's launches a call of `fn` (a replayed
    frame: no wrapper runs, and the counters only add what the capture
    enqueued), as the profiler sees them on the card over `reps` calls;
    they must equal `expect` ({counter: launches a call}).  The profiler
    can drop a record, so a window that disagrees is taken again, as
    device_rows takes it, and the check fails only if none of
    PROFILE_ATTEMPTS windows agrees.  Returns (launches a call, windows
    taken)."""
    want = {k: round(expect.get(k, 0) * reps) for k in kernel_rows([])}
    taken = device_rows(fn, reps, "the replayed kernels",
                        lambda rows: kernel_rows(rows) == want)
    got = kernel_rows(taken[-1])
    if got != want:
        raise AssertionError(f"the profiler saw {got} kernel launches in "
                             f"{reps} replays, the counters {want} "
                             f"({len(taken)} windows)")
    return {k: n / reps for k, n in got.items()}, len(taken)


def graph_case(name, scene_of, env):
    """Phase graph, one case: 32 frames eager and 32 replayed, in turns
    (after one chain that captures), bit for bit one checksum and
    PR11_CHECKSUMS' own; the kernels' launches a replayed frame those of
    an eager one; one warm frame each way, its inputs staged inside the
    window as a caller stages them, under the profiler: no more than the
    block's host-to-device copy (and a replay's device copy of it), no
    stream synchronization; and the kernels' launches in replayed frames
    as the profiler sees them on the card, equal to what the counters add
    a replay (`profiled_launches`)."""
    import torch
    from opengl_raytracing_tpu_torch.models import (FrameInputs, RenderState,
                                                    frame_block, graph,
                                                    make_render_fn, preset)
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    scene_key, preset_name, (h, w), how = GRAPH_CASES[name]
    bvh = scene_of[scene_key] if scene_key else None
    env_map = env if how.get("env") else None
    params = preset(preset_name).replace(enable_env_map=int(env_map
                                                            is not None))
    fins = list(frame_inputs(h, w, FRAMES, "cuda", preset_name,
                             how.get("camera", "still")))
    fns = {jit: make_render_fn(h, w, "cuda", use_bvh=bvh is not None,
                               jit=jit) for jit in (True, False)}

    def chain(jit):
        state = RenderState.create(h, w, "cuda")
        sums = []
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        t0 = time.time()
        for fin in fins:
            state, out = fns[jit](params, fin, state, env_map, bvh)
            sums.append(out.image.sum())
        torch.cuda.synchronize()
        ms = (time.time() - t0) / FRAMES * 1e3
        launches = {k: (LAUNCHES[k] - before[k]) / FRAMES for k in LAUNCHES}
        return ms, float(torch.stack(sums).sum()), launches
    graph.clear()
    stats0 = graph.stats()
    chain(True)  # the capture
    pool_mb = graph.stats()["pool_bytes"] / 2**20
    runs = {True: [], False: []}
    for jit in (False, True, True, False):
        runs[jit].append(chain(jit))
    sums = {r[1] for rs in runs.values() for r in rs}
    if sums != {PR11_CHECKSUMS[name]}:
        raise AssertionError(f"graph {name}: checksums {sorted(sums)} "
                             f"(eager and replayed), PR 11's "
                             f"{PR11_CHECKSUMS[name]}")
    eager_launches, replay_launches = runs[False][0][2], runs[True][0][2]
    if replay_launches != eager_launches or not any(
            replay_launches.values()):
        raise AssertionError(f"graph {name}: a replay launches "
                             f"{replay_launches}, an eager frame "
                             f"{eager_launches}")
    stats = graph.stats()
    if stats["captures"] - stats0["captures"] != 1 or stats["replays"] \
            - stats0["replays"] != 3 * FRAMES - 1:
        raise AssertionError(f"graph {name}: {stats} after {stats0}")
    state = {jit: [RenderState.create(h, w, "cuda")] for jit in runs}

    def frame(jit):
        # the caller's staging of a frame's inputs, then the frame
        index = state[jit][0].frame_index
        src = fins[index % FRAMES]
        fin = FrameInputs.stage(frame_block.at_frame(src.words, index),
                                "cuda", src.moved)
        state[jit][0], _ = fns[jit](params, fin, state[jit][0], env_map,
                                    bvh)
    events = {jit: frame_events(lambda jit=jit: frame(jit), reps=5)
              for jit in runs}
    profiled, windows = profiled_launches(lambda: frame(True),
                                          replay_launches)
    for jit, ev in events.items():
        # the block's copy, and a replay's device copies of it and of the
        # parameter block into the graph's; the profiler may lose a
        # record, never add one
        copies = 3 if jit else 1
        calls = ev["host_calls"]
        if (ev["h2d_copies"] or 0) > 1 or calls["cudaMemcpyAsync"] > copies \
                or calls["cudaStreamSynchronize"] != 0:
            raise AssertionError(f"graph {name}: a warm "
                                 f"{'replayed' if jit else 'eager'} frame "
                                 f"makes {ev['h2d_copies']} host-to-device "
                                 f"copies, {calls['cudaMemcpyAsync']} copy "
                                 f"calls and "
                                 f"{calls['cudaStreamSynchronize']} stream "
                                 f"synchronizations")
    graph.clear()
    return dict(
        checksum=PR11_CHECKSUMS[name], size=[h, w], preset=preset_name,
        ms_per_frame_eager=[r[0] for r in runs[False]],
        ms_per_frame_replayed=[r[0] for r in runs[True]],
        launches_per_replay={k: v for k, v in replay_launches.items() if v},
        launches_per_replay_profiled={k: v for k, v in profiled.items()
                                      if v},
        profiled_windows=windows,
        captures=1, replays=3 * FRAMES - 1, pool_mb=pool_mb,
        replayed_frame=events[True], eager_frame=events[False])


def graph_app_turbo():
    """Phase graph, the app: `--scene bvh --preset full --turbo 8` at 1080p,
    4 steps (32 frames; the first moving the camera, so its chain replays
    the moving key, then the still one), with `--jit` and `--no-jit`:
    every step's image and the last accumulation bit for bit."""
    import torch
    from opengl_raytracing_tpu_torch.models import graph
    runs = {}
    for flag in ("--jit", "--no-jit"):
        graph.clear()
        stats0 = graph.stats()
        application = app_steps(app_args("--scene", "bvh", "--preset",
                                         "full", "--turbo", "8", flag), 0)
        images = []
        torch.cuda.synchronize()
        t0 = time.time()
        for step in range(4):
            if step == 0:
                application.act("look 4 0")
            images.append(application.step().clone())
        torch.cuda.synchronize()
        frames = application.app.render_state.frame_index
        runs[flag] = dict(
            images=images, accum=application.app.render_state.accum.clone(),
            ms_per_frame=(time.time() - t0) / frames * 1e3, frames=frames,
            eager_frames=application.eager_frames,
            captures=graph.stats()["captures"] - stats0["captures"])
    graph.clear()
    same = all(torch.equal(a, b) for a, b in zip(runs["--jit"]["images"],
                                                 runs["--no-jit"]["images"]))
    same = same and torch.equal(runs["--jit"]["accum"],
                                runs["--no-jit"]["accum"])
    if not same or runs["--jit"]["frames"] != 6 + 3 * 8 \
            or runs["--jit"]["eager_frames"] or runs["--jit"]["captures"] != 2:
        raise AssertionError(f"app turbo: replayed steps equal the eager "
                             f"ones {same}; {runs['--jit']['frames']} frames, "
                             f"{runs['--jit']['eager_frames']} eager, "
                             f"{runs['--jit']['captures']} captures")
    return dict(bitwise=True, frames=runs["--jit"]["frames"],
                captures=runs["--jit"]["captures"],
                ms_per_frame_replayed=runs["--jit"]["ms_per_frame"],
                ms_per_frame_eager=runs["--no-jit"]["ms_per_frame"])


# phase params: one data field a step, as the viewer's /set gets it
PARAM_SWEEP = (
    ("exposure", "1.6"), ("sun_yaw", "80"), ("point_light_intensity", "12"),
    ("svgf_strength", "0.4"), ("taa_history_avg_weight", "0.8"),
    ("ao_radius", "1.2"), ("mat_albedo_color", "0.2,0.7,0.3"),
    ("env_map_intensity", "0.7"), ("sun_intensity", "0.6"),
    ("sky_intensity", "1.3"), ("gi_scale_bvh", "0.35"),
    ("gi_scale_analytic", "0.5"), ("svgf_k_color", "2.0"),
    ("ao_min", "0.3"), ("point_light_color", "1,0.5,0.3"),
    ("taa_history_box_size", "0.1"))
ORBIT_STEPS = 32


def params_run(argv, steps, sweep):
    """One app run of phase params: make_app(argv), then `steps` steps,
    each after the /set of PARAM_SWEEP's next field where `sweep`.
    Returns the steps' images and last accumulation (copies), each step's
    ms (host clock to a synchronize), the run's captures, its eager
    frames, and the graphs' MB before and after."""
    import torch
    from opengl_raytracing_tpu_torch.app.viewer import make_handler
    from opengl_raytracing_tpu_torch.models import graph
    set_field = make_handler(None)._apply_set
    application = app_steps(app_args(*argv), 0)
    before = graph.stats()
    images, ms = [], []
    for i in range(steps):
        if sweep:
            set_field(application, *PARAM_SWEEP[i])
        torch.cuda.synchronize()
        t0 = time.time()
        images.append(application.step().clone())
        torch.cuda.synchronize()
        ms.append((time.time() - t0) * 1e3)
    after = graph.stats()
    return dict(images=images,
                accum=application.app.render_state.accum.clone(),
                ms=ms, captures=after["captures"] - before["captures"],
                eager_frames=application.eager_frames,
                graph_mb=[before["pool_bytes"] / 2**20,
                          after["pool_bytes"] / 2**20],
                params=application.app.params)


def check_params(smi):
    """Phase params (docstring, step 25h)."""
    import statistics
    import torch
    from opengl_raytracing_tpu_torch.models import graph
    from opengl_raytracing_tpu_torch.params import static_key
    day = os.path.join(ROOT, "cubemaps", "sky_day.png")
    scenes = {"bvh_full": ("--scene", "bvh", "--preset", "full"),
              "an_full": ("--scene", "analytic", "--preset", "full",
                          "--env", day)}
    out = dict(card=smi, sweep=[f for f, _ in PARAM_SWEEP])
    graph.clear()
    for name, argv in scenes.items():
        for what, extra, steps in (("sweep", (), len(PARAM_SWEEP)),
                                   ("orbit", ("--orbit",), ORBIT_STEPS)):
            runs = {flag: params_run(argv + extra + (flag,), steps,
                                     what == "sweep")
                    for flag in ("--jit", "--no-jit")}
            jit, eager = runs["--jit"], runs["--no-jit"]
            same = [bool(torch.equal(a, b)) for a, b in
                    zip(jit["images"], eager["images"])]
            same_accum = bool(torch.equal(jit["accum"], eager["accum"]))
            if not all(same) or not same_accum:
                raise AssertionError(
                    f"params {name} {what}: steps bit-equal to --no-jit "
                    f"{same}, last accumulation {same_accum}")
            if jit["captures"] != 1 or jit["eager_frames"] \
                    or eager["captures"]:
                raise AssertionError(
                    f"params {name} {what}: {jit['captures']} captures and "
                    f"{jit['eager_frames']} eager frames with --jit "
                    f"(one static configuration), {eager['captures']} "
                    f"captures with --no-jit")
            if static_key(jit["params"]) != static_key(eager["params"]) \
                    or jit["params"] != eager["params"]:
                raise AssertionError(f"params {name} {what}: the two runs "
                                     f"ended with other parameters")
            images = torch.stack(jit["images"])
            if not bool(torch.isfinite(images).all()) \
                    or float(images.min()) < 0.0 or float(images.max()) > 1.0:
                raise AssertionError(f"params {name} {what}: an image is "
                                     f"not finite in [0, 1]")
            distinct = len({float(x) for x in images.sum((1, 2, 3))})
            if distinct < steps // 2:
                raise AssertionError(f"params {name} {what}: only "
                                     f"{distinct} distinct images of "
                                     f"{steps} steps")
            out[f"{name}_{what}"] = dict(
                steps=steps, bitwise=True, captures=jit["captures"],
                eager_frames=jit["eager_frames"], distinct_images=distinct,
                checksum=float(images.sum()),
                ms_first_step_replayed=jit["ms"][0],
                ms_per_step_replayed=statistics.median(jit["ms"][1:]),
                ms_per_step_eager=statistics.median(eager["ms"][1:]),
                ms_per_step_replayed_mean=statistics.mean(jit["ms"][1:]),
                ms_per_step_eager_mean=statistics.mean(eager["ms"][1:]),
                graph_mb_before=jit["graph_mb"][0],
                graph_mb_after=jit["graph_mb"][1],
                point_light_yaw=float(jit["params"].point_light_yaw))
            print(f"params {name} {what}: {steps} steps bit-equal, "
                  f"{jit['captures']} capture, replayed "
                  f"{out[f'{name}_{what}']['ms_per_step_replayed']:.3f} "
                  f"ms/step, eager "
                  f"{out[f'{name}_{what}']['ms_per_step_eager']:.3f}",
                  flush=True)
    stats = graph.stats()
    out["graphs_held"], out["graph_mb_held"] = (stats["graphs"],
                                                stats["pool_bytes"] / 2**20)
    graph.clear()
    return out


RASTER_STEPS = 16
RASTER_SLIDER_AT = 8  # the step before which a slider moves


def check_raster_graph(smi):
    """Phase raster (docstring, step 25i): the app's raster preview (F2),
    `--scene bvh --preset full --orbit` at 1080p, RASTER_STEPS steps with
    the point light's colour set through the viewer's /set before step
    RASTER_SLIDER_AT, with `--jit` (a replay of the preview's graph) and
    `--no-jit`: every step bit for bit, one capture, ms a step both
    ways."""
    import statistics
    import torch
    from opengl_raytracing_tpu_torch.app.viewer import make_handler
    from opengl_raytracing_tpu_torch.models import graph
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    set_field = make_handler(None)._apply_set
    runs = {}
    for flag in ("--jit", "--no-jit"):
        graph.clear()
        stats0 = graph.stats()
        application = app_steps(app_args("--scene", "bvh", "--preset",
                                         "full", "--orbit", flag), 0)
        application.act("toggle_ray_mode")
        images, ms = [], []
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for i in range(RASTER_STEPS):
            if i == RASTER_SLIDER_AT:
                set_field(application, "point_light_color", "0.2,1,0.4")
            torch.cuda.synchronize()
            t0 = time.time()
            images.append(application.step().clone())
            torch.cuda.synchronize()
            ms.append((time.time() - t0) * 1e3)
        if application.app.ray_mode:
            raise AssertionError("the app did not enter the raster preview")
        stats = graph.stats()
        runs[flag] = dict(images=images, ms=ms, launches={
                              k: n / RASTER_STEPS
                              for k, n in LAUNCHES.items() if n},
                          captures=stats["captures"] - stats0["captures"],
                          replays=stats["replays"] - stats0["replays"],
                          pool_mb=stats["pool_bytes"] / 2**20)
    graph.clear()
    jit, eager = runs["--jit"], runs["--no-jit"]
    same = [bool(torch.equal(a, b)) for a, b in zip(jit["images"],
                                                    eager["images"])]
    distinct = len({float(x.sum()) for x in jit["images"]})
    if not all(same) or jit["captures"] != 1 \
            or jit["replays"] != RASTER_STEPS - 1 or eager["captures"] \
            or distinct < RASTER_STEPS // 2 \
            or jit["launches"] != {"closest": 1.0} \
            or eager["launches"] != jit["launches"]:
        raise AssertionError(f"raster: steps bit-equal to --no-jit {same}, "
                             f"{jit['captures']} captures and "
                             f"{jit['replays']} replays with --jit, "
                             f"{eager['captures']} with --no-jit, "
                             f"{distinct} distinct images, launches a step "
                             f"{jit['launches']} and {eager['launches']}")
    print(f"raster: {RASTER_STEPS} preview steps bit-equal to --no-jit, "
          f"{jit['captures']} capture", flush=True)
    return dict(card=smi, steps=RASTER_STEPS, bitwise=True,
                captures=jit["captures"], replays=jit["replays"],
                distinct_images=distinct, graph_mb=jit["pool_mb"],
                launches_per_step=jit["launches"],
                ms_per_step_replayed=statistics.median(jit["ms"][1:]),
                ms_per_step_eager=statistics.median(eager["ms"][1:]),
                ms_first_step_replayed=jit["ms"][0])


def check_graph(bvh, bvh6, env, smi):
    """Phase graph (docstring, step 25g)."""
    scene_of = {"bvh": bvh, "bvh6": bvh6}
    out = {name: graph_case(name, scene_of, env) for name in GRAPH_CASES}
    out["app_turbo"] = graph_app_turbo()
    out["card"] = smi
    return out


def _one_sample(args, s):
    """The arguments of the single-sample call that sample `s` of a batched
    call (`args`, recorded from a `heavy` frame) replaces: the sample's
    slice of every tensor with a leading sample axis, and the sample's
    value of a sampled seed (index * a + b + s * c, without the axis)."""
    from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
    from opengl_raytracing_tpu_torch.sampling import FrameValue
    shape = (args["h"] if "h" in args else args["h0"]).t.shape
    out = {}
    for k, v in args.items():
        if isinstance(v, Hit):
            v = Hit(*(x[s] for x in v))
        elif isinstance(v, FrameValue) and v.samples > 1:
            v = FrameValue(v.record, v.a, (v.b + s * v.c) & 0xFFFFFFFF)
        elif k == "vdir":
            v = v.expand(shape + (3,))[s]
        elif k in ("px", "py", "active") and v is not None:
            v = v.expand(shape)[s]
        elif k == "spp_dup":
            v = 0
        out[k] = v
    return out


def batch_vs_samples(bvh, height, width, spp=HEAVY_SPP, device="cuda",
                     timer=None):
    """The batched `heavy` frame against the form it replaced, on the card:
    `trace_and_shade` of the third frame of a `heavy` chain (BVH, or the
    analytic scene when `bvh` is None) against the spp single-sample
    shadings of the same kernels, each with the seed frame * spp + s, with
    the sky select, added in sample order and divided by spp: bit for bit.
    Both forms' kernel launches and eager ms (CUDA events, in turns: one
    by one, batched, batched, one by one)."""
    import torch
    from opengl_raytracing_tpu_torch.models import pipeline, preset
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
    from opengl_raytracing_tpu_torch.params import bind
    timer = timer or cuda_ms
    use_bvh = bvh is not None
    params = bind(preset("heavy").replace(enable_env_map=0), device)
    if int(params.spp_per_frame) != spp:
        raise AssertionError(f"heavy has {params.spp_per_frame} samples")
    fin = list(frame_inputs(height, width, PROFILE_FRAME, device,
                            "heavy"))[-1]
    scene = SceneCtx.create(params, fin.cam_pos, use_bvh=use_bvh, bvh=bvh)
    px, py, rd = pipeline.primary_rays(height, width, fin, params)
    frame = fin.frame

    def batched():
        return pipeline.trace_and_shade(scene, params, fin, px, py, rd,
                                        frame, use_bvh=use_bvh)[0]

    def one_by_one():
        ro = fin.cam_pos.expand(rd.shape)
        h_raw = scene.trace(ro, rd)
        hit = h_raw.valid
        h = pipeline._sanitize_hit(h_raw, ro, rd)
        ao = (lt.compute_ao(scene, h, frame, px, py,
                            active=hit if use_bvh else None)
              if params.enable_ao else None)
        sky = scene.sky(rd)
        total = None
        for s in range(spp):
            seed = frame * spp + s
            if use_bvh:
                one = pipeline._shade_bvh(scene, h, seed, frame, -rd, px, py,
                                          active=hit, ao=ao)
            else:
                one = pipeline._shade_analytic(scene, h, seed, frame, -rd,
                                               px, py, active=hit, ao=ao)
            one = torch.where(hit[..., None], one, sky)
            total = one if total is None else total + one
        return total / torch.full((), float(spp), device=device)
    out = {}
    images = {}
    for name, fn in (("batched", batched), ("one_by_one", one_by_one)):
        before = dict(LAUNCHES)
        images[name] = fn()
        out[f"{name}_launches"] = {k: LAUNCHES[k] - before[k]
                                   for k in LAUNCHES if LAUNCHES[k]
                                   - before[k]}
    a, b = images["batched"], images["one_by_one"]
    if not bool(torch.isfinite(a).all()) or not torch.equal(a, b):
        raise AssertionError(
            f"the batched {'heavy' if use_bvh else 'analytic heavy'} frame "
            f"differs from its samples one by one on "
            f"{int((a != b).any(-1).sum())} pixels (max abs "
            f"{float((a - b).abs().max())})")
    ms = {"batched": [], "one_by_one": []}
    for name in ("one_by_one", "batched", "batched", "one_by_one"):
        ms[name].append(timer(batched if name == "batched"
                              else one_by_one, 3))
    out.update(bitwise=True, pixels=height * width, samples=spp,
               batched_ms=ms["batched"], one_by_one_ms=ms["one_by_one"])
    # a CPU tensor runs the plain versions: no launch to count
    on_card = torch.device(device).type == "cuda"
    if on_card and use_bvh and (out["batched_launches"].get("bvh_direct"),
                                out["batched_launches"].get("bounce")) \
            != (2, 1):
        raise AssertionError(f"the batched frame launched "
                             f"{out['batched_launches']}")
    return out


def check_spp_batch(bvh, frames_heavy, graph_heavy, timer=None):
    """Phase spp_batch (docstring, step 25g'): each kernel that takes the
    sample axis, on a 1080p `heavy` frame's batched calls, against its
    plain version (step 3's gates; K3 on an analytic `heavy` frame), with
    one single-sample call's kernel time beside it; the batched frame bit
    for bit against its samples one by one; `heavy`'s launches a frame
    and phase graph's replayed frame beside the host loop's (HEAVY_LOOP)."""
    from opengl_raytracing_tpu_torch.ops import an_cuda, bvh_cuda
    timer = timer or cuda_ms
    calls = record_kernel_inputs(bvh, HEIGHT, WIDTH, "cuda",
                                 ("bounce", "bvh_direct"), "heavy",
                                 PROFILE_FRAME)
    if (len(calls["bvh_direct"]), len(calls["bounce"])) != (2, 1):
        raise AssertionError(f"a heavy frame called bvh_direct "
                             f"{len(calls['bvh_direct'])} and trace_bounce "
                             f"{len(calls['bounce'])} times")
    primary, gi = calls["bvh_direct"]
    bounce = calls["bounce"][0]
    if (primary["spp_dup"], primary["rng_frame"].samples,
            bounce["seed"].samples) != (HEAVY_SPP,) * 3:
        raise AssertionError("the heavy frame's calls do not carry its "
                             "sample axis")

    def singles(fn, args, kernel):
        # the spp single-sample calls the batched one replaces: the kernel
        # time of one, their average
        ones = [_one_sample(args, s) for s in range(HEAVY_SPP)]
        return kernel_ms(lambda: [fn(**a) for a in ones], kernel)
    records = {}
    for key, args, fn, check, counter in (
            ("bvh_direct", primary, an_cuda.direct_light_bvh,
             check_bvh_direct, "bvh_direct"),
            ("bvh_direct_bounce", gi, an_cuda.direct_light_bvh,
             check_bvh_direct, "bvh_direct"),
            ("bounce", bounce, bvh_cuda.trace_bounce, check_bounce,
             "bounce")):
        r = check(args, timer)
        r["single_kernel_ms"] = singles(fn, args,
                                        KERNELS[counter]["kernel"])
        records[key] = r
    del calls, primary, gi, bounce
    an = check_an_kernel(HEIGHT, WIDTH, preset_name="heavy",
                         record_as="an_direct")["an_direct"]
    an_calls = record_kernel_inputs(None, HEIGHT, WIDTH, "cuda",
                                    ("an_direct",), "heavy")["an_direct"]
    if an_calls[0]["rng_frame"].samples != HEAVY_SPP:
        raise AssertionError("the analytic heavy frame's primary call "
                             "carries no sample axis")
    an["single_kernel_ms"] = singles(an_cuda.direct_light, an_calls[0],
                                     KERNELS["an_direct"]["kernel"])
    records["an_direct"] = an
    del an_calls
    for r in records.values():
        r["share"] = (r["bound_ms"] / r["kernel_ms"] if r["kernel_ms"]
                      else None)
    launches = frames_heavy["launches"]
    if (launches["bvh_direct"], launches["bounce"]) != (2 * FRAMES,
                                                         FRAMES):
        raise AssertionError(f"frames_heavy launched {launches}")
    replayed = graph_heavy["replayed_frame"]
    return dict(
        records=records,
        frame_bvh=batch_vs_samples(bvh, HEIGHT, WIDTH),
        frame_analytic=batch_vs_samples(None, HEIGHT, WIDTH),
        heavy_launches_per_frame={k: v / FRAMES for k, v in launches.items()
                                  if v},
        heavy_launches_per_frame_before=dict(bvh_direct=8, bounce=4),
        heavy_replayed=dict(device_ms=replayed["device_ms"],
                            device_ops=replayed["device_ops"],
                            pool_mb=graph_heavy["pool_mb"],
                            ms_per_frame=graph_heavy[
                                "ms_per_frame_replayed"]),
        heavy_replayed_loop=HEAVY_LOOP)


def check_bench(chains):
    """Phase bench: `python3 bench_torch.py` at its defaults, the nine cases
    in their child processes.  It must exit 0 with nine case lines and no
    error; each case's checksum must equal, bit for bit, the checksum of
    the chain in `chains` ({case: run_frames record}) of the same
    configuration, and its kernel launches a frame that chain's;
    `realistic`, which no other phase renders, must give a finite checksum
    and REALISTIC_LAUNCHES.  Returns each case's median ms/frame, spread,
    checksum, device ms and idle share (the replayed frame: the bench's
    headline), the eager frame's median, the captures and the graphs'
    memory, the profiled frame's device operations and the host's kernel
    and graph launches, and the phase's seconds."""
    import math
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                          stdout=subprocess.PIPE, text=True, cwd=ROOT,
                          timeout=BENCH_TIMEOUT_S)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    cases = {ln["case"]: ln for ln in lines if "case" in ln}
    errors = {c: ln["error"] for c, ln in cases.items() if "error" in ln}
    if (proc.returncode != 0 or errors or len(cases) != len(BENCH_CASES)
            or set(cases) != set(BENCH_CASES)):
        raise AssertionError(f"bench_torch.py: rc {proc.returncode}, cases "
                             f"{sorted(cases)}, errors {errors}")
    for case, ln in cases.items():
        if case == "realistic":
            want_sum, per_frame = None, REALISTIC_LAUNCHES
        else:
            run = chains[case]
            want_sum = run["checksum"]
            per_frame = {k: v / run["frames"]
                         for k, v in run["launches"].items()}
        if not math.isfinite(ln["checksum"]) or (
                want_sum is not None and ln["checksum"] != want_sum):
            raise AssertionError(f"bench {case}: checksum {ln['checksum']}, "
                                 f"the frames phase's {want_sum}")
        got = {k: v for k, v in ln["kernel_launches"].items() if v}
        if got != {k: v for k, v in per_frame.items() if v}:
            raise AssertionError(f"bench {case}: launches a frame {got}, "
                                 f"expected {per_frame}")
    return dict(seconds=time.time() - t0, cases={
        c: {k: ln[k] for k in ("ms_per_frame", "spread", "checksum",
                               "device_ms", "idle", "ms_per_frame_eager",
                               "jit", "captures", "graph_pool_mb",
                               "launches", "host_kernel_launches",
                               "host_graph_launches")}
        for c, ln in cases.items()})


def band_planes(planes, n, k):
    """(first row, planes) of band k of n of whole-image planes, with
    HALO rows of its neighbours above and below (zeros past the image's
    edge), built with the renderer's own halo helpers."""
    import torch
    from opengl_raytracing_tpu_torch.parallel.shardmap import (band_of,
                                                               halo_rows,
                                                               with_halos)
    row0, bh = band_of(planes[0].shape[0], n, k)
    own = [x[row0:row0 + bh] for x in planes]
    zeros = torch.zeros_like(halo_rows(own, True))
    above = halo_rows([x[:row0] for x in planes], False) if k > 0 else zeros
    below = halo_rows([x[row0 + bh:] for x in planes], True) \
        if k < n - 1 else zeros
    return row0, with_halos(own, above, below)


def tap_rows(row0, bh, height):
    """The in-image tap rows of a band's pixels, summed over its rows (a
    whole image: 7 * height - 12)."""
    return sum(0 <= row0 + y + j < height for y in range(bh)
               for j in range(-3, 4))


def check_band_kernels(bvh, device="cuda", timer=None):
    """Phase sharded (a): K4's two filter entries on the SHARD_BANDS bands
    (270 rows, 3 halo rows) of the third frame of a 1080p `full` chain:
    each band's filter entry equals the plain band filter bit for bit and
    its fused entry the plain band present pass within PRESENT_MAX_ABS;
    the stitched bands equal the whole-image kernel's output bit for bit.
    A middle band's call: kernel alone, wrapper and plain times, bound;
    the whole image's fused call alone beside it."""
    import torch
    from opengl_raytracing_tpu_torch.ops import svgf_cuda
    from opengl_raytracing_tpu_torch.ops.svgf import (present_plain,
                                                      svgf_filter)
    from opengl_raytracing_tpu_torch.parallel.shardmap import HALO
    timer = timer or cuda_ms
    args = record_kernel_inputs(bvh, HEIGHT, WIDTH, device,
                                ("svgf_present",), "full",
                                PROFILE_FRAME)["svgf_present"][0]
    planes = [args[k] for k in ("accum", "motion", "gpos", "gnrm")]
    params = args["params"]
    whole = dict(svgf=svgf_cuda.svgf_filter(*planes, params),
                 svgf_present=svgf_cuda.svgf_present(*planes, params))
    got = dict(svgf=[], svgf_present=[])
    bands, timed = [], None
    for k in range(SHARD_BANDS):
        row0, ext = band_planes(planes, SHARD_BANDS, k)
        kw = dict(halo=HALO, row_offset=row0, full_height=HEIGHT)
        f = svgf_cuda.svgf_filter(*ext, params, **kw)
        p = svgf_cuda.svgf_present(*ext, params, **kw)
        want_p = present_plain(*ext, params, **kw)
        err = float((p - want_p).abs().max())
        if not torch.equal(f, svgf_filter(*ext, params, **kw)) \
                or not err <= PRESENT_MAX_ABS \
                or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"band {k}: K4's band entries disagree with "
                                 f"their plain versions (present max abs "
                                 f"{err})")
        got["svgf"].append(f)
        got["svgf_present"].append(p)
        bands.append(dict(row0=row0, rows=f.shape[0], present_max_abs=err,
                          present_bitwise=bool(torch.equal(p, want_p))))
        if k == 1:
            timed = (row0, ext, kw)
    for key, parts in got.items():
        if not torch.equal(torch.cat(parts), whole[key]):
            raise AssertionError(f"the stitched bands of {key} differ from "
                                 f"the whole-image kernel")
    row0, ext, kw = timed
    bh = ext[0].shape[0] - 2 * HALO
    ops = (bh * WIDTH * (OPS["svgf_pixel"] + OPS["present_pixel"])
           + tap_rows(row0, bh, HEIGHT) * (7 * WIDTH - 12) * OPS["svgf_tap"])

    def band_call():
        svgf_cuda.svgf_present(*ext, params, **kw)
    kernel = KERNELS["svgf_present"]["kernel"]
    return dict(
        bands=bands, stitched_bitwise=True, band_rows=bh, halo=HALO,
        band_row0=row0,
        band=dict(**bound(unique_bytes(*ext) + 12 * bh * WIDTH, ops),
                  ms=timer(band_call, 20), kernel_ms=kernel_ms(band_call,
                                                               kernel),
                  plain_ms=timer(lambda: present_plain(*ext, params, **kw),
                                 3)),
        whole_kernel_ms=kernel_ms(
            lambda: svgf_cuda.svgf_present(*planes, params), kernel))


def sharded_frames(mesh, bvh, preset_name, camera, frames, jit=True):
    """`frames` chained 1080p frames of the preset on the bunny scene
    through make_sharded_render_fn on this rank's band (`jit`: the
    compiled step, one CUDA graph a rank replayed; else the eager step),
    after one warm frame, the counters zeroed just before: the record (the
    checksum of this rank's image sums, launches, ms/frame, each frame's
    mean_lum; captures and replays over the warm frame and the chain, and
    the frames that ran eagerly after their key's capture), and the last
    frame's image and accumulation gathered on rank 0 (None elsewhere)."""
    import torch
    from opengl_raytracing_tpu_torch.models import RenderState, graph, preset
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    from opengl_raytracing_tpu_torch.parallel import (make_sharded_render_fn,
                                                      shard_image_rows)
    from opengl_raytracing_tpu_torch.parallel.shardmap import gather_rows
    params = preset(preset_name).replace(enable_env_map=0)
    fn = make_sharded_render_fn(mesh, HEIGHT, WIDTH, use_bvh=True, jit=jit)
    state = shard_image_rows(mesh, RenderState.create(HEIGHT, WIDTH,
                                                      mesh.device))
    fins = list(frame_inputs(HEIGHT, WIDTH, frames, mesh.device, preset_name,
                             camera))
    # warm: NCCL sets its communicators up at a group's first collective
    # of each kind, and the compiled step captures its key
    stats0 = graph.stats()
    warm = shard_image_rows(mesh, RenderState.create(HEIGHT, WIDTH,
                                                     mesh.device))
    fn(params, fins[0], RenderState(warm.accum, 1), None, bvh)
    sums, lums = [], []
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.time()
    for fin in fins:
        state, out, lum = fn(params, fin, state, None, bvh)
        sums.append(out.image.sum())
        lums.append(lum.clone())
    torch.cuda.synchronize()
    sec = (time.time() - t0) / frames
    launches = dict(LAUNCHES)
    stats = graph.stats()
    captures = stats["captures"] - stats0["captures"]
    replays = stats["replays"] - stats0["replays"]
    # (CPU tensors, a rehearsal, launch nothing)
    if mesh.device.type == "cuda" \
            and min(launches[k] for k in FULL_PATH) < frames:
        raise AssertionError(f"the band step skipped a kernel of the path: "
                             f"{launches}")
    # one key: captured by the warm frame, or by an earlier chain of it
    if jit and mesh.device.type == "cuda" \
            and (captures > 1 or captures + replays != frames + 1):
        raise AssertionError(f"the compiled band step: {captures} captures "
                             f"and {replays} replays in {frames + 1} frames "
                             f"of one key")
    image, accum = gather_rows(mesh, out.image), gather_rows(mesh,
                                                             state.accum)
    rec = dict(preset=preset_name, camera=camera, frames=frames,
               ranks=mesh.size, band=list(out.image.shape), jit=jit,
               ms_per_frame=sec * 1e3,
               checksum=float(torch.stack(sums).sum()), launches=launches,
               mean_lum=[float(x) for x in lums], captures=captures,
               replays=replays,
               eager_frames_after_capture=frames + 1 - captures - replays
               if jit and mesh.device.type == "cuda" else None,
               graph_pool_mb=stats["pool_bytes"] / 2**20)
    return rec, image, accum


def sharded_replay_vs_eager(mesh, bvh, camera, frames=FRAMES):
    """Phase sharded (b): the compiled band step against the eager one,
    `full` on this rank, `frames` frames in lockstep (an eager frame, then
    the replayed frame of the same inputs): every frame's image,
    accumulation and mean_lum bit for bit, and the chains' launches equal
    (the eager one's counted by the wrappers as they launch, the replayed
    one's added by the replays); then one warm replayed frame and one
    eager frame, their inputs staged inside the window as a caller stages
    them, under the profiler (`frame_events`: the host's cudaLaunchKernel
    and cudaGraphLaunch calls, copies, device ms); the kernels' launches
    in replayed band frames as the profiler sees them on the card, equal
    to what the counters add a replay (`profiled_launches`); the graphs'
    memory."""
    import torch
    from opengl_raytracing_tpu_torch.models import (FrameInputs, RenderState,
                                                    frame_block, graph,
                                                    preset)
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    from opengl_raytracing_tpu_torch.parallel import (make_sharded_render_fn,
                                                      shard_image_rows)
    params = preset("full").replace(enable_env_map=0)
    fins = list(frame_inputs(HEIGHT, WIDTH, frames, mesh.device, "full",
                             camera))
    fns = {jit: make_sharded_render_fn(mesh, HEIGHT, WIDTH, use_bvh=True,
                                       jit=jit) for jit in (False, True)}
    states = {jit: shard_image_rows(mesh, RenderState.create(
        HEIGHT, WIDTH, mesh.device)) for jit in fns}
    stats0 = graph.stats()
    chain_launches = {jit: dict.fromkeys(LAUNCHES, 0) for jit in fns}
    for i, fin in enumerate(fins):
        got = {}
        for jit, fn in fns.items():
            before = dict(LAUNCHES)
            states[jit], out, lum = fn(params, fin, states[jit], None, bvh)
            for k in LAUNCHES:
                chain_launches[jit][k] += LAUNCHES[k] - before[k]
            got[jit] = (out.image, states[jit].accum, lum)
        differ = [name for name, a, b in zip(("image", "accum", "mean_lum"),
                                             got[False], got[True])
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"{camera} frame {i}: the replayed band "
                                 f"step's {differ} differ from the eager "
                                 f"step's")
    if chain_launches[True] != chain_launches[False] \
            or not any(chain_launches[True].values()):
        raise AssertionError(f"{camera}: the replayed band chain launches "
                             f"{chain_launches[True]}, the eager one "
                             f"{chain_launches[False]}")
    stats = graph.stats()

    def frame(jit):
        # the caller's staging of a frame's inputs, then the step
        index = states[jit].frame_index
        src = fins[index % frames]
        fin = FrameInputs.stage(frame_block.at_frame(src.words, index),
                                mesh.device, src.moved)
        states[jit], _, _ = fns[jit](params, fin, states[jit], None, bvh)
    events = {jit: frame_events(lambda jit=jit: frame(jit), reps=5)
              for jit in fns}
    calls = events[True]["host_calls"]
    if calls["cudaLaunchKernel"] != 0 or calls["cudaGraphLaunch"] != 1 \
            or calls["cudaStreamSynchronize"] != 0:
        raise AssertionError(f"{camera}: a warm replayed band frame calls "
                             f"{calls}")
    before = dict(LAUNCHES)
    frame(True)
    per_replay = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    profiled, windows = profiled_launches(lambda: frame(True), per_replay)
    return dict(camera=camera, frames=frames, bitwise=True,
                captures=stats["captures"] - stats0["captures"],
                replays=stats["replays"] - stats0["replays"],
                chain_launches={k: v for k, v in chain_launches[True].items()
                                if v},
                launches_per_replay={k: v for k, v in per_replay.items()
                                     if v},
                launches_per_replay_profiled={k: v for k, v in
                                              profiled.items() if v},
                profiled_windows=windows,
                graph_pool_mb=stats["pool_bytes"] / 2**20,
                replayed_frame=events[True], eager_frame=events[False])


def sharded_in_turns(mesh, bvh, frames=FRAMES):
    """Phase sharded (b): 32-frame `full` chains in turns: render_frame
    replayed, the one-rank band step replayed, the band step eager,
    render_frame replayed (the host's time spreads between chains), each
    after an untimed chain that captures; ms a frame each; one frame's
    device launches, copies and busy ms each way (the band step's own
    work: the halo planes, the all-reduce)."""
    import torch
    from opengl_raytracing_tpu_torch.models import (RenderState,
                                                    make_render_fn, preset)
    from opengl_raytracing_tpu_torch.parallel import (make_sharded_render_fn,
                                                      shard_image_rows)
    params = preset("full").replace(enable_env_map=0)
    fins = list(frame_inputs(HEIGHT, WIDTH, frames, mesh.device, "full"))
    fns = dict(render_frame=make_render_fn(HEIGHT, WIDTH, mesh.device,
                                           use_bvh=True),
               band_replayed=make_sharded_render_fn(mesh, HEIGHT, WIDTH,
                                                    use_bvh=True),
               band_eager=make_sharded_render_fn(mesh, HEIGHT, WIDTH,
                                                 use_bvh=True, jit=False))

    def state():  # one rank: its band is the whole image
        return shard_image_rows(mesh, RenderState.create(HEIGHT, WIDTH,
                                                         mesh.device))

    def chain(name):
        st = state()
        torch.cuda.synchronize()
        t0 = time.time()
        for fin in fins:
            st = fns[name](params, fin, st, None, bvh)[0]
        torch.cuda.synchronize()
        return (time.time() - t0) / frames * 1e3
    for name in fns:
        chain(name)  # the capture
    ms = {name: [] for name in fns}
    for name in ("render_frame", "band_replayed", "band_eager",
                 "render_frame"):
        ms[name].append(chain(name))
    frame = {}
    for name, fn in fns.items():
        st = RenderState(state().accum, PROFILE_FRAME)
        frame[name] = device_events(
            lambda: fn(params, fins[PROFILE_FRAME], st, None, bvh))
    return dict(frames=frames, ms_per_frame_in_turns=ms, one_frame=frame)


def sharded_rank(mesh, frames):
    """One rank of the multi-card run: the `full` and `moving` chains of
    `frames` frames at 1080p on this rank's card through the compiled band
    step; rank 0's gathered last image and accumulation of each, as
    numpy."""
    from opengl_raytracing_tpu_torch.models import graph
    _, bvh = scene(mesh.device)
    out = {}
    for camera in ("still", "moving"):
        rec, image, accum = sharded_frames(mesh, bvh, "full", camera, frames)
        out[camera] = dict(
            rec, image=None if image is None else image.cpu().numpy(),
            accum=None if accum is None else accum.cpu().numpy())
    graph.clear()  # before the group, whose collectives the graphs hold
    return out


def bands_in_turn(bvh, preset_name, camera, frames=SHARD_FRAMES,
                  device="cuda"):
    """Phase sharded (c): the four bands of each frame in turn on this
    card (parallel.shardmap.render_bands_in_turn, the launch counters
    zeroed just before), then the same frames through render_frame: every
    frame's stitched image, motion and gbuffer and the last accumulation
    bit for bit.
    Returns the record and the single-card last image and accumulation."""
    import torch
    from opengl_raytracing_tpu_torch.models import (RenderState,
                                                    make_render_fn, preset)
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    from opengl_raytracing_tpu_torch.parallel.shardmap import (
        band_of, render_bands_in_turn)
    params = preset(preset_name).replace(enable_env_map=0)
    fins = list(frame_inputs(HEIGHT, WIDTH, frames, device, preset_name,
                             camera))
    states = [RenderState(torch.zeros((band_of(HEIGHT, SHARD_BANDS, k)[1],
                                       WIDTH, 4), device=device), 0)
              for k in range(SHARD_BANDS)]
    bands, lums = [], []
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for fin in fins:
        states, outs, lum = render_bands_in_turn(
            params, fin, states, None, bvh, height=HEIGHT, width=WIDTH,
            use_bvh=True)
        bands.append([torch.cat(planes) for planes in zip(*outs)])
        lums.append(lum)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if device != "cpu" \
            and min(launches[k] for k in FULL_PATH) < SHARD_BANDS * frames:
        raise AssertionError(f"a band skipped a kernel of the path: "
                             f"{launches}")
    fn = make_render_fn(HEIGHT, WIDTH, device, use_bvh=True)
    state = RenderState.create(HEIGHT, WIDTH, device)
    for i, fin in enumerate(fins):
        state, out = fn(params, fin, state, None, bvh)
        differ = {name: float((got - want).abs().max())
                  for name, got, want in zip(out._fields, bands[i], out)
                  if not torch.equal(got, want)}
        if differ:
            raise AssertionError(
                f"{preset_name} {camera} frame {i}: the stitched bands "
                f"differ from render_frame's, max abs {differ}")
        host = float(luminance_mean(out.image))
        if not abs(float(lums[i]) - host) < 1e-4:
            raise AssertionError(f"mean_lum {float(lums[i])}, host {host}")
    accum = torch.cat([s.accum for s in states])
    if not torch.equal(accum, state.accum):
        raise AssertionError(f"{preset_name} {camera}: the bands' "
                             f"accumulation differs from render_frame's")
    return dict(preset=preset_name, camera=camera, frames=frames,
                bands=SHARD_BANDS, launches=launches, bitwise=True,
                mean_lum=[float(x) for x in lums]), out.image, state.accum


def luminance_mean(image):
    import torch
    return (image @ torch.tensor([0.299, 0.587, 0.114],
                                 device=image.device)).mean()


def check_sharded(bvh, frames_full, frames_moving, smi, device="cuda"):
    """Phase sharded: K4's band entries (a), a one-rank NCCL group through
    make_sharded_render_fn (b), four bands in turn on this card (c), and
    min(cards, 4) NCCL ranks, one a card, where there are two or more.
    (device "cpu": the same with gloo and the plain versions, a rehearsal
    of the control flow at a small size.)"""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from opengl_raytracing_tpu_torch.models import graph
    from opengl_raytracing_tpu_torch.parallel import make_mesh
    from opengl_raytracing_tpu_torch.parallel.sharding import (
        COLLECTIVE_TIMEOUT_S, spawn_ranks)
    out = dict(card=smi, band_kernels=check_band_kernels(bvh, device))

    refs = {}
    for camera in ("still", "moving"):
        rec, image, accum = bands_in_turn(bvh, "full", camera, device=device)
        out[f"four_bands_{camera}"] = rec
        refs[camera] = (image.cpu().numpy(), accum.cpu().numpy())

    # (b) one rank, NCCL on this card: frames_full's and frames_moving's
    # chains, the same checksums
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo" if device == "cpu" else "nccl",
            init_method=f"file://{tmp}/store", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            mesh = make_mesh(cpu=device == "cpu")
            graph.clear()
            for camera, run in (("still", frames_full),
                                ("moving", frames_moving)):
                rec, image, _ = sharded_frames(mesh, bvh, "full", camera,
                                               FRAMES)
                if rec["checksum"] != run["checksum"]:
                    raise AssertionError(
                        f"one NCCL rank, {camera}: checksum "
                        f"{rec['checksum']}, render_frame's "
                        f"{run['checksum']}")
                if device != "cpu" and rec["captures"] != 1:
                    raise AssertionError(f"one NCCL rank, {camera}: "
                                         f"{rec['captures']} captures of "
                                         f"one key")
                host = float(luminance_mean(image))
                if not abs(rec["mean_lum"][-1] - host) < 1e-4:
                    raise AssertionError(f"mean_lum {rec['mean_lum'][-1]}, "
                                         f"host {host}")
                rec["mean_lum"] = rec["mean_lum"][-1]
                out[f"nccl_one_rank_{camera}"] = rec
                if device != "cpu":
                    lock = sharded_replay_vs_eager(mesh, bvh, camera)
                    out[f"nccl_one_rank_{camera}_replay_vs_eager"] = lock
                    print(f"sharded (b) {camera}: checksum "
                          f"{rec['checksum']}, {rec['captures']} capture "
                          f"(one key), {rec['eager_frames_after_capture']} "
                          f"eager frames after it, {FRAMES} frames bit-equal "
                          f"to the eager step; a warm replayed frame "
                          f"cudaLaunchKernel "
                          f"{lock['replayed_frame']['host_calls']['cudaLaunchKernel']}"
                          f", cudaGraphLaunch "
                          f"{lock['replayed_frame']['host_calls']['cudaGraphLaunch']}"
                          f"; kernels a replay, counted "
                          f"{lock['launches_per_replay']}, profiled "
                          f"{lock['launches_per_replay_profiled']}"
                          f"; graphs {lock['graph_pool_mb']:.1f} MB",
                          flush=True)
                graph.clear()
            if device != "cpu":
                out["nccl_one_rank_in_turns"] = sharded_in_turns(mesh, bvh)
        finally:
            graph.clear()  # before the group, whose collectives they hold
            dist.destroy_process_group()

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"sharded: the machine has {cards} card: the multi-card spawn "
              f"is not run", flush=True)
        out["multi_card"] = f"not run: {cards} card"
        return out
    n = min(cards, SHARD_BANDS)
    t0 = time.time()
    results = spawn_ranks(sharded_rank, n, SHARD_FRAMES, timeout=600.0)
    for camera, (image, accum) in refs.items():
        got = results[0][camera]
        if not (np.array_equal(got["image"], image)
                and np.array_equal(got["accum"], accum)):
            raise AssertionError(f"{n} NCCL ranks, {camera}: the gathered "
                                 f"replayed frame differs from the "
                                 f"single-card frame")
        host = float((got["image"] @ np.float32([0.299, 0.587, 0.114]))
                     .mean())
        if not all(abs(r[camera]["mean_lum"][-1] - host) < 1e-4
                   for r in results):
            raise AssertionError(f"{n} NCCL ranks, {camera}: mean_lum "
                                 f"{[r[camera]['mean_lum'][-1] for r in results]}"
                                 f", host {host}")
    out["multi_card"] = dict(
        ranks=n, seconds=time.time() - t0, bitwise=True,
        **{camera: [{k: v for k, v in r[camera].items()
                     if k not in ("image", "accum")} for r in results]
           for camera in refs})
    return out


def app_args(*argv, size=(HEIGHT, WIDTH)):
    """The headless CLI's arguments: `argv` at `size` (height, width)."""
    from opengl_raytracing_tpu_torch.app import headless
    return headless.build_parser().parse_args(
        ["--size", f"{size[1]}x{size[0]}", *argv])


def app_steps(args, frames, on_step=None):
    """make_app(args), then `frames` steps, each after --camera-anim's
    action as `headless.main` applies it; on_step(application, image)
    after each.  Returns the Application."""
    from opengl_raytracing_tpu_torch.app import headless
    application = headless.make_app(args)
    action = headless.camera_action(args)
    for _ in range(frames):
        if action is not None:
            application.act(action)
        img = application.step()
        if on_step is not None:
            on_step(application, img)
    return application


def device_events(fn):
    """Device launches (kernels and copies), host-to-device and
    device-to-host copies and device busy ms of one call of `fn`, from the
    profiler (device_rows: `fn` is called once before, unprofiled)."""
    rows = device_rows(fn, 1, "one call")[-1]
    return dict(launches=sum(ev.count for ev in rows),
                h2d_copies=sum(ev.count for ev in rows if "HtoD" in ev.key),
                d2h_copies=sum(ev.count for ev in rows if "DtoH" in ev.key),
                device_ms=sum(ev.self_device_time_total for ev in rows) / 1e3)


def app_frames(args, frames, expect):
    """`frames` steps of make_app(args) with the launch counters zeroed
    just before: each step's image finite and in [0,1], the launches a
    frame `expect` ({counter: launches}, every other counter 0).  Returns
    the record, the per-step image sums and the last image."""
    import torch
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    sums, bad = [], []

    def on_step(application, img):
        sums.append(img.sum())
        if img.shape != (application.app.height, application.app.width, 3) \
                or not img.is_cuda:
            bad.append(f"step {len(sums)}: {tuple(img.shape)} {img.device}")
        elif not bool(torch.isfinite(img).all()) or float(img.min()) < 0.0 \
                or float(img.max()) > 1.0:
            bad.append(f"step {len(sums)} not finite in [0,1]")
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.time()
    application = app_steps(args, frames, on_step)
    torch.cuda.synchronize()
    sec = (time.time() - t0) / frames
    launches = dict(LAUNCHES)
    if bad:
        raise AssertionError(f"app frames: {bad}")
    want = {k: expect.get(k, 0) * frames for k in launches}
    if launches != want:
        raise AssertionError(f"app launched {launches} in {frames} frames, "
                             f"not {want}")
    app = application.app
    rec = dict(frames=frames, size=[app.height, app.width],
               device=str(app.device), ms_per_frame=sec * 1e3,
               checksum=float(torch.stack(sums).sum()), launches=launches)
    return rec, sums, application


def check_app_headless(frames_full, frames_an_full, smi):
    """Phase app_headless (docstring, step 26)."""
    import tempfile
    import torch
    from opengl_raytracing_tpu_torch.app import headless
    from opengl_raytracing_tpu_torch.convert import camera_frame_inputs
    from opengl_raytracing_tpu_torch.models import (RenderState,
                                                    make_render_fn, preset)
    from opengl_raytracing_tpu_torch.utils.image import read_png
    day = os.path.join(ROOT, "cubemaps", "sky_day.png")
    noon = os.path.join(ROOT, "cubemaps", "sky_noon.hdr")
    bunny = os.path.join(ROOT, "models", "bunny_lp.obj")
    out = dict(card=smi)

    # (a) the bunny scene, `full`, still camera: frames_full's frames
    full_args = app_args("--scene", "bvh", "--preset", "full")
    full_expect = dict(closest=1, bvh_direct=2, bounce=1, ao=1,
                       svgf_present=1, sky=1, bvh_hit_mix=1)
    a, sums_a, app_a = app_frames(full_args, FRAMES, full_expect)
    if a["checksum"] != frames_full["checksum"]:
        raise AssertionError(f"app (a) checksum {a['checksum']} is not "
                             f"frames_full's {frames_full['checksum']}")
    last_a = (app_a.app.render_state.accum.clone(),
              app_a.last_output.image.clone())
    # one step against one render_frame call on the same scene: device
    # launches and host-to-device copies
    fn = make_render_fn(HEIGHT, WIDTH, "cuda", use_bvh=True)
    state = [RenderState.create(HEIGHT, WIDTH, "cuda")]
    fin = next(frame_inputs(HEIGHT, WIDTH, 1, "cuda", "full"))
    params = preset("full")

    def render_call():
        state[0], _ = fn(params, fin, state[0], None, app_a.app.bvh)
    a.update(step_events=device_events(app_a.step),
             render_frame_events=device_events(render_call),
             render_frame_ms_per_frame=frames_full["ms_per_frame"])
    # ms/frame of 32-frame chains in turns, render_frame, app, app,
    # render_frame, on one scene (host clock, ending in a synchronize)

    def app_chain():
        for _ in range(FRAMES):
            app_a.step()

    def render_chain():
        render(app_a.app.bvh, HEIGHT, WIDTH, FRAMES, "cuda",
               preset_name="full")
    turns = dict(render_frame=[], app=[])
    for name, chain in (("render_frame", render_chain), ("app", app_chain),
                        ("app", app_chain), ("render_frame", render_chain)):
        torch.cuda.synchronize()
        t0 = time.time()
        chain()
        torch.cuda.synchronize()
        turns[name].append((time.time() - t0) / FRAMES * 1e3)
    a["ms_per_frame_turns"] = turns
    out["a_full"] = a

    # (b) the analytic scene, `full`, the day-sky cross: frames_an_full's
    b, _, _ = app_frames(
        app_args("--scene", "analytic", "--preset", "full", "--env", day),
        FRAMES, AN_FULL_LAUNCHES)
    if b["checksum"] != frames_an_full["checksum"]:
        raise AssertionError(f"app (b) checksum {b['checksum']} is not "
                             f"frames_an_full's {frames_an_full['checksum']}")
    b["render_frame_ms_per_frame"] = frames_an_full["ms_per_frame"]
    out["b_an_full"] = b

    # (c) a model file, an HDR environment, a dollying camera
    c_argv = ("--scene", "bvh", "--preset", "full", "--model", bunny,
              "--env", noon, "--camera-anim", "dolly")
    c, _, app_c = app_frames(app_args(*c_argv), 8, full_expect)
    if app_c.app.bvh_tri_count != 5120 or app_c.app.env_map is None \
            or app_c.app.env_map.shape != (6, 64, 64, 3):
        raise AssertionError("app (c) did not load its model and cubemap")
    ref = {}
    for device in ("cpu", "cuda"):
        argv = c_argv + (("--cpu",) if device == "cpu" else ())
        ref[device] = app_steps(app_args(*argv, size=(REF_HEIGHT, REF_WIDTH)),
                                REF_FRAMES).last_output.image.cpu()
    c["reference"] = dict(size=[REF_HEIGHT, REF_WIDTH], frame=REF_FRAMES,
                          **_frame_gate(ref["cuda"], ref["cpu"], "app (c)"))
    out["c_model_hdr_dolly"] = c

    # (d) snapshot after 16 frames, resume for 16: (a)'s frames; (e) the
    # main call's frame_last.png
    half = FRAMES // 2
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snap.npz")
        t0 = time.time()
        rc = headless.main(["--scene", "bvh", "--preset", "full", "--size",
                            f"{WIDTH}x{HEIGHT}", "--frames", str(half),
                            "--snapshot", snap, "--out", tmp])
        main_s = time.time() - t0
        png = read_png(os.path.join(tmp, "frame_last.png"))
        sums_d = []
        app_d = app_steps(app_args("--scene", "bvh", "--preset", "full",
                                   "--resume", snap), half,
                          lambda _, img: sums_d.append(img.sum()))
    if rc != 0 or png.shape != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"headless.main returned {rc}, wrote "
                             f"frame_last.png of {png.shape}")
    same_sums = bool(torch.equal(torch.stack(sums_d),
                                 torch.stack(sums_a[half:])))
    same_last = (torch.equal(app_d.app.render_state.accum, last_a[0])
                 and torch.equal(app_d.last_output.image, last_a[1]))
    if not (same_sums and same_last) \
            or app_d.app.render_state.frame_index != FRAMES:
        raise AssertionError(f"resumed run differs from the uninterrupted "
                             f"one: step sums equal {same_sums}, last "
                             f"accumulation and image equal {same_last}")
    out["d_snapshot_resume"] = dict(frames=[half, half], bitwise=True,
                                    main_seconds=main_s)
    out["e_main_png"] = dict(shape=list(png.shape), mean=float(png.mean()))
    out["f_heavy_model"] = app_heavy_model(full_expect)
    # every counter over (a) and (b), and (b)'s K3 as the env kernel's
    out["launches_all"] = {k: a["launches"][k] + b["launches"][k]
                           for k in a["launches"]}
    out["launches_all"]["an_direct_env"] = b["launches"]["an_direct"]
    return out


def app_heavy_model(expect):
    """app_headless (f): make_bunny(6) written as an OBJ file, then the CLI's
    `--scene bvh --preset full --model <obj>` at 1080p, 32 frames: the
    load's seconds (make_app: parse, gather, tree, upload) and the native
    entries it called; the app's tree equals prepare_bvh's of the file's
    triangles (read by the Python reader, gathered by numpy), and the sum of
    its frames a render_frame chain's on that tree, bit for bit."""
    import tempfile
    import torch
    from opengl_raytracing_tpu_torch import native
    from opengl_raytracing_tpu_torch.app import headless
    from opengl_raytracing_tpu_torch.constants import (DEFAULT_BVH_SCALE,
                                                       DEFAULT_BVH_TRANSLATE)
    from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
    from opengl_raytracing_tpu_torch.scene import (gather_triangles,
                                                   load_obj, make_bunny,
                                                   model_transform, save_obj)
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "bunny6.obj")
        save_obj(obj, make_bunny(HEAVY_SUBDIV))
        args = app_args("--scene", "bvh", "--preset", "full", "--model", obj)
        before = dict(native.CALLS)
        app, load_s = timed(lambda: headless.make_app(args))
        calls = {k: native.CALLS[k] - before[k] for k in native.CALLS}
        rec, _, application = app_frames(args, FRAMES, expect)
        tris = gather_triangles(load_obj(obj), model_transform(
            DEFAULT_BVH_TRANSLATE, DEFAULT_BVH_SCALE))
    if app.app.bvh_tri_count != tris.shape[0] or \
            min(calls[k] for k in ("load_obj", "gather_triangles",
                                   "build_bvh")) < 1:
        raise AssertionError(f"app (f) did not load its model through the "
                             f"native entries: {calls}")
    bvh = prepare_bvh(tris, "cuda")
    if not all(torch.equal(a, b) for a, b in
               zip(application.app.bvh.arrays, bvh.arrays)):
        raise AssertionError("app (f): the app's tree is not prepare_bvh's "
                             "of the file's triangles")
    sums = []
    render(bvh, HEIGHT, WIDTH, FRAMES, "cuda",
           on_frame=lambda o: sums.append(o.image.sum()), preset_name="full")
    checksum = float(torch.stack(sums).sum())
    if rec["checksum"] != checksum:
        raise AssertionError(f"app (f) checksum {rec['checksum']} is not the "
                             f"render_frame chain's {checksum}")
    return dict(rec, tris=app.app.bvh_tri_count, nodes=app.app.bvh_node_count,
                load_seconds=load_s, native_calls_in_load=calls,
                render_frame_checksum=checksum)


def check_viewer_jpeg(smi):
    """app_viewer's JPEG stream: the viewer (BVH `full`, 1080p, 8 frames a
    step) with `--stream-format jpeg` for STREAM_SECONDS: frames encoded a
    second, the host's ms a loop turn in the step and in the encode (the
    native entropy coder), one /frame.png fetch decoding to 1080x1920x3,
    no failed frame."""
    import tempfile
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    from opengl_raytracing_tpu_torch import native
    from opengl_raytracing_tpu_torch.app import headless
    from opengl_raytracing_tpu_torch.app.viewer import (ViewerState,
                                                        make_handler)
    from opengl_raytracing_tpu_torch.utils.image import read_jpeg
    args = app_args("--scene", "bvh", "--preset", "full")
    args._viewer = True
    application = headless.make_app(args)
    vs = ViewerState(application, stream_format="jpeg")
    before = native.CALLS["jpeg_entropy_encode"]
    loop = threading.Thread(target=vs.loop, args=(30.0,), daemon=True)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(vs))
    port = server.server_address[1]
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    t_start = time.time()
    loop.start()
    serve.start()
    try:
        while vs.frames_encoded == 0 and time.time() < t_start + 240.0:
            time.sleep(0.05)
        t_first, n_first = time.time(), vs.frames_encoded
        time.sleep(STREAM_SECONDS)
        encoded, t_end = vs.frames_encoded, time.time()
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/frame.png",
                                      timeout=60).read()
        state = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/state", timeout=60).read())
    finally:
        vs.running = False
        loop.join(timeout=60)
        server.shutdown()
        server.server_close()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.jpg")
        with open(path, "wb") as fh:
            fh.write(body)
        shape = read_jpeg(path).shape
    rec = dict(card=smi, size=[HEIGHT, WIDTH], frames_encoded=encoded,
               stream_fps=(encoded - n_first) / max(t_end - t_first, 1e-9),
               step_ms=state["step_ms"], encode_ms=state["encode_ms"],
               jpeg_bytes=len(body), frame_shape=list(shape),
               native_encodes=native.CALLS["jpeg_entropy_encode"] - before,
               failed_frames=vs.failed_frames,
               seconds_to_first_frame=t_first - t_start)
    if encoded - n_first < 1 or shape != (HEIGHT, WIDTH, 3) \
            or vs.failed_frames or rec["native_encodes"] < encoded \
            or loop.is_alive():
        raise AssertionError(f"app_viewer jpeg stream: {rec}")
    return rec


def check_app_viewer(smi, timeout=240.0):
    """Phase app_viewer (docstring, step 27)."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    import torch
    from opengl_raytracing_tpu_torch.app import headless
    from opengl_raytracing_tpu_torch.app.viewer import (ViewerState,
                                                        make_handler)
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    from opengl_raytracing_tpu_torch.utils.image import read_png
    args = app_args("--scene", "bvh", "--preset", "full")
    args._viewer = True  # the viewer's default turbo
    application = headless.make_app(args)
    vs = ViewerState(application)
    before = dict(LAUNCHES)
    loop = threading.Thread(target=vs.loop, args=(30.0,), daemon=True)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(vs))
    port = server.server_address[1]
    serve = threading.Thread(target=server.serve_forever, daemon=True)

    def get(path):
        return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                      timeout=60).read()
    t_start = time.time()
    loop.start()
    serve.start()
    try:
        deadline = t_start + timeout
        served, distinct, shapes = 0, set(), set()
        t_first = None
        while len(distinct) < 3 and time.time() < deadline:
            png = get("/frame.png")
            if not png:
                time.sleep(0.05)
                continue
            t_first = t_first or time.time()
            served += 1
            if png not in distinct:
                distinct.add(png)
                path = os.path.join(ROOT, "out", "app_viewer_frame.png")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(png)
                shapes.add(read_png(path).shape)
            time.sleep(0.02)
        s0 = json.loads(get("/state"))
        moved = json.loads(get("/act?name=move_w"))["ok"]
        get("/set?exposure=2.0")
        t_move = time.time()
        s1 = json.loads(get("/state"))
        while s1["frame_index"] == s0["frame_index"] \
                and time.time() < deadline:
            time.sleep(0.05)
            s1 = json.loads(get("/state"))
        u8_on_card = application.last_u8 is not None and \
            application.last_u8.is_cuda
        # the stream's rate over a window of STREAM_SECONDS
        while time.time() < (t_first or t_start) + STREAM_SECONDS \
                and time.time() < deadline:
            time.sleep(0.1)
        s2 = json.loads(get("/state"))
        encoded = vs.frames_encoded
        t_quit = time.time()
        get("/act?name=quit")
        loop.join(timeout=60)
    finally:
        vs.running = False
        server.shutdown()
        server.server_close()
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    rec = dict(card=smi, size=[HEIGHT, WIDTH], turbo=application.turbo,
               frames_served=served, distinct_frames=len(distinct),
               frame_shapes=sorted(list(x) for x in shapes),
               frames_encoded=encoded,
               # frames encoded from the first served frame to the quit
               stream_fps=(encoded - 1) / max(t_quit - (t_first or t_quit),
                                              1e-9),
               steps=application.frame_count,
               # host ms a loop turn spends in the step (the uint8 copy
               # queued) and in the PNG encode, last 30 turns
               step_ms=s2["step_ms"], encode_ms=s2["encode_ms"],
               seconds_to_first_frame=(t_first or time.time()) - t_start,
               camera=[s0["camera"], s1["camera"]],
               exposure=[s0["exposure"], s1["exposure"]],
               state_after_move_s=time.time() - t_move,
               failed_frames=vs.failed_frames, u8_on_card=u8_on_card,
               loop_stopped=not loop.is_alive(), launches=launches)
    ok = (len(distinct) >= 3 and shapes == {(HEIGHT, WIDTH, 3)} and moved
          and s1["camera"] != s0["camera"] and s1["exposure"] == 2.0
          and s0["exposure"] != 2.0 and vs.failed_frames == 0
          and u8_on_card and not loop.is_alive()
          and min(launches[k] for k in FULL_PATH) > 0)
    if not ok:
        raise AssertionError(f"app_viewer: {rec}")
    return rec


# (label, module, attribute) of each stage a profile times; a label ending
# in "#" numbers the calls of that attribute within the frame, so the
# first call can be told from the later ones
BVH_STAGES = (
    ("render_frame", "models.pipeline", "render_frame"),
    ("trace_and_shade", "models.pipeline", "trace_and_shade"),
    ("primary_trace", "ops.bvh_cuda", "trace_closest"),
    ("direct_light", "ops.lighting", "direct_light_bvh"),
    ("store", "models.pipeline", "resolve_taa"),
    ("tonemap", "ops.svgf_cuda", "tonemap"),
    ("present", "models.pipeline", "present"),
)
AN_STAGES = (
    ("render_frame", "models.pipeline", "render_frame"),
    ("trace_and_shade", "models.pipeline", "trace_and_shade"),
    ("trace#", "ops.an_trace_cuda", "trace"),
    ("direct_light", "ops.an_cuda", "direct_light"),
    ("hit_mix", "ops.hit_mix_cuda", "an_hit_mix"),  # the marker
    ("mirror", "ops.lighting", "shade_mirror"),
    ("glass", "ops.lighting", "shade_glass"),
    ("store", "models.pipeline", "resolve_taa"),
    ("tonemap", "ops.svgf_cuda", "tonemap"),
    ("present", "models.pipeline", "present"),
)
FULL_STAGES = (
    ("render_frame", "models.pipeline", "render_frame"),
    ("trace_and_shade", "models.pipeline", "trace_and_shade"),
    ("trace_closest", "ops.bvh_cuda", "trace_closest"),  # the primary call
    ("trace_bounce", "ops.bvh_cuda", "trace_bounce"),  # inside GI
    ("direct_light#", "ops.lighting", "direct_light_bvh"),  # 1 inside GI
    ("gi", "ops.lighting", "gi_light_bvh"),  # its bounce and direct light
    ("ao", "ops.lighting", "compute_ao"),
    ("hit_mix", "ops.hit_mix_cuda", "bvh_hit_mix"),  # GI's tail, AO's product
    ("taa", "models.pipeline", "resolve_taa"),
    ("svgf", "ops.svgf_cuda", "svgf_present"),
    ("present", "models.pipeline", "present"),
)


AN_FULL_STAGES = (
    ("render_frame", "models.pipeline", "render_frame"),
    ("trace_and_shade", "models.pipeline", "trace_and_shade"),
    ("trace#", "ops.an_trace_cuda", "trace"),
    ("sky#", "ops.an_trace_cuda", "sky"),  # the cubemap lookups
    ("direct_light", "ops.an_cuda", "direct_light"),
    ("gi#", "ops.lighting", "gi_light_analytic"),  # 0 the primary's GI
    ("ao", "ops.lighting", "compute_ao"),
    ("hit_mix", "ops.hit_mix_cuda", "an_hit_mix"),  # GI's tail, AO, marker
    ("mirror", "ops.lighting", "shade_mirror"),
    ("glass", "ops.lighting", "shade_glass"),
    ("taa", "models.pipeline", "resolve_taa"),
    ("svgf", "ops.svgf_cuda", "svgf_present"),
    ("present", "models.pipeline", "present"),
)


@contextlib.contextmanager
def stage_ranges(stages):
    """Wrap each stage in a profiler range (the module attributes the
    frame calls through), and restore them after."""
    import torch
    saved = []

    def ranged(label, fn):
        count = [0]

        def wrapper(*args, **kw):
            name = label
            if label.endswith("#"):
                name = f"{label}{count[0]}"
                count[0] += 1
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return wrapper
    for label, mod, attr in stages:
        m = importlib.import_module(f"opengl_raytracing_tpu_torch.{mod}")
        saved.append((m, attr, getattr(m, attr)))
        setattr(m, attr, ranged(label, getattr(m, attr)))
    try:
        yield
    finally:
        for m, attr, fn in saved:
            setattr(m, attr, fn)


def profile(bvh, height, width, stages, frame_ms, preset_name="baseline",
            frames=1, **how):
    """Device time of the last of `frames` chained warm eager frames
    (`how`: render's env, camera and moved): by stage
    (inclusive device time of the kernels launched inside each range), by
    PyTorch operator, and of each hand-written kernel; the device's busy
    time against the unprofiled frame time gives its idle share.  A
    profile that saw no device activity is reported on stderr and the
    chain rendered again, up to PROFILE_ATTEMPTS times (device_rows)."""
    import torch
    from torch.profiler import ProfilerActivity
    # eager frames: a replayed frame has no stage ranges (phase graph
    # profiles the replayed frames)
    render(bvh, height, width, frames, "cuda", preset_name=preset_name,
           jit=False, **how)
    torch.cuda.synchronize()
    box = {}

    @contextlib.contextmanager
    def profiled():
        with stage_ranges(stages), torch.profiler.profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            yield
            torch.cuda.synchronize()
            box["wall_ms"] = (time.time() - t0) * 1e3
        box["prof"] = prof
    for attempt in range(PROFILE_ATTEMPTS):
        render(bvh, height, width, frames, "cuda", preset_name=preset_name,
               last=profiled, jit=False, **how)
        out = _frame_profile(box["prof"], stages, frame_ms)
        out["wall_ms_profiled"] = box["wall_ms"]
        if "device_busy_ms" in out:
            return out
        print(f"profile {attempt + 1} of a {preset_name} frame saw no device "
              f"activity", file=sys.stderr, flush=True)
    return out


def _frame_profile(prof, stages, frame_ms):
    """profile's record of one profiled frame."""
    from torch.autograd import DeviceType
    stages_ms, ops, kernels = {}, [], {}
    busy_ms, launches = 0.0, 0
    prefixes = tuple(label for label, _, _ in stages)
    for ev in prof.key_averages():
        self_ms = ev.self_device_time_total / 1e3
        is_stage = ev.key.startswith(prefixes)
        if ev.device_type == DeviceType.CUDA:
            if is_stage:
                continue  # a range's own span on the device timeline
            busy_ms += self_ms
            launches += ev.count
            for rec in KERNELS.values():
                if is_kernel(ev.key, rec["kernel"]):
                    kernels[rec["kernel"]] = dict(device_ms=self_ms,
                                                  launches=ev.count)
        elif is_stage:
            stages_ms[ev.key] = ev.device_time_total / 1e3
        elif ev.key.startswith("aten::") and self_ms > 0:
            ops.append((self_ms, ev.count, ev.key))
    ops.sort(reverse=True)
    if not busy_ms:
        return dict(device_time="not measured: the profiler saw no device "
                    "time")
    return dict(frame_ms=frame_ms,
                device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / frame_ms,
                kernel_launches=launches, stages_device_ms=stages_ms,
                kernels_device_ms=kernels,
                # the present pass: PyTorch's device time inside the stage
                # (its kernel, launched through ctypes, falls outside the
                # range) beside the kernel's own row
                present=dict(
                    torch_device_ms=stages_ms.get("present"),
                    kernel={k: v for k, v in kernels.items()
                            if k in (KERNELS["svgf_present"]["kernel"],
                                     KERNELS["tonemap"]["kernel"])}),
                top_ops=[dict(op=k, calls=c, device_ms=ms)
                         for ms, c, k in ops[:10]])


if __name__ == "__main__":
    sys.exit(main())
