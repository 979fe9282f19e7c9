#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--parent DIR]

Phases (any failure exits non-zero; nothing is swallowed):
  1. environment: torch / CUDA versions, the card's name and power limit,
     whether PIL imports, the build of every CUDA kernel from csrc/ (one
     nvcc each, in parallel) and its wall time, and each kernel's
     registers, shared memory and spills from its build log (the fused
     kernels once per feature set of the bounce core: <spheres,
     dielectric, media, textures>);
  2. K1 `bounce_fused_q` against its plain PyTorch version on the card
     (cornellBox tables, 131072 lanes = 512 blocks as in the flagship, 8
     levels, a mixed alive/depth state), and every level's starts taking
     the items base .. base+take-1 once each;
  3. K2 `harvest_levels_into` against its plain version on K1's records;
  4. exact accounting through the kernels (quad-only scene, background 1:
     image exactly 1; a multi-window render chaining the queue cursor),
     and a small cornellBox render on the kernels against the same render
     on the plain versions;
  5. the flagship through `go_raytracer_tpu_torch.cli.main`: cornellBox
     600x600, 100 spp, depth 50, 1<<17 lanes, launch counts read around
     it;
  6. per-kernel timings at the flagship's shapes (CUDA events), with one
     flagship window's starts checked item by item over all its levels
     and K2 held against its plain version on that window; cornellBox's K1
     beside its earlier time; K1 and K9 on book3 and cornellSmoke;
  7. the mesh path's intersectors at scene 8's shapes (modelExample: the
     65,536-triangle statue, 131,072 rays of a real bounce level, capped and
     dead lanes included): K4 `stream_rows` on every call one
     `binned_closest` makes, and K5 `bvh8_closest` on the level's rays as
     they lie and sorted as the walk route sorts them, against their plain
     versions (idx equal on every lane, t bit for bit), with the plain
     walk's steps per ray and per warp of 4, 8 and 32 sorted rays; K4's
     winners against K5's; both routes of `mesh_closest` against the plain
     skip-link walk; the blocks' group ranges (mean, max) at round 0 and
     over all rounds, and K4's work items;
  8. K3's cap entry (the dense classes' nearest t, one launch) against
     the tensor cap, and K3 `bounce` from the walk's winner (t, idx),
     the triangle gathered in the kernel, against its plain version (the
     gather of ops/bounce.ext_planes_from_hit, then bounce_ref) on that
     level;
  9. a small scene-8 render on the kernels against the same render, on
     the card and on the same random stream, with every kernel swapped
     for its plain version;
 10. one real scene-8 window (255 levels, starts at the first 204, 131,072
     lanes), whose start ranks and per-level bases come from the refill's
     cumulative sum: every level's starts take base .. base+take-1 once
     each, and K2 against its plain version on those records; then the
     scene-8 render through `cli.main --mesh binned`, launch counts read
     around it. To keep the script's time, this one render is CUT to 25
     spp (5x5 strata; 600x337, depth 50, 131,072 lanes otherwise as the
     registry has it) and held against the default route (the walk) at the
     same 25 spp in the same call; then the slice's main path, `-S 8` with
     no route named, through `cli.main` at the full registry
     configuration (250 spp = 225 strata): the walk route, through K5, K3
     (and its cap entry once a level) and K2 alone, the plain gather and
     cap never called, its levels replayed as a CUDA graph with the mesh
     level's glue kernel once a level and its plain glue never called
     (every kernel once a level run); then that render again under
     torch.profiler, the launch counters held to the kernels the card ran,
     by name, and its image to the main path's;
 11. timings of K3-K5 at those shapes with their bounds (K3 and its cap
     entry through the launch the mesh context prepared: ms per call, host
     us per call, device ms; K4 on every round
     of phase 7's call: each round, the sum and the largest; K5 on the
     level's rays as they lie and sorted), rounds and host reads per level,
     and the device's busy share of a scene-8 render at 1 spp under
     torch.profiler on the binned route and on the walk;
 12. K6 `bounce_fused` against its plain version (cornellBox tables,
     131072 lanes, 8 levels, a mixed alive/depth state, the take plane of
     a real refill), and K8 `bounce_fused_pos` likewise with `rem` mixed
     (zero, one, many) and the refill cut mid-call: the pointer planes
     equal on every lane that did not flip;
 13. one real flagship `queue` window (256 levels, 26 refill rows): K7
     `reverse_harvest_into` against `reverse_harvest_ref` +
     `write_rows_ref` on its records, every refill row's starts taking
     NIs[r] .. NIs[r]+count-1 once each;
 14. exact accounting through K6/K7 and K8 (image exactly 1, one window
     and several);
 15. the cornellBox flagship through `cli.main` under `--schedule queue`
     and `--schedule positional` at full width, held to the gates of the
     `queue_ik` flagship of phase 5 and to its image;
 16. timings of K6, K7 and K8 at the flagship's shapes with their bounds,
     and each schedule's device time by kernel under torch.profiler
     (cornellBox at 25 spp); K6 and K8 on book3 and cornellSmoke;
 17. K9 `bounce_fused_q_direct` against K1 on the same inputs (bit for
     bit, rows outside its levels untouched) and against its plain
     version with K1's tolerances; one flagship window through K1 and
     through K9 (bit for bit, the same levels recorded however late the
     host saw the drain); the cornellBox flagship through `cli.main
     --direct-rec`, held to phase 5's gates and to its segments;
 18. at phase 7's scene-8 level: K10 `stream_round_rows` on every round of
     one fused `binned_closest` against its plain version (t, idx, key,
     bits bit for bit) and the fused route against the unfused one (the
     same rounds, bit-equal results); K11 `stream2_rows` and K12
     `bvh_closest` against their plain versions (idx equal, t bit for
     bit; K11's rounds per unit equal), and K11's plain version on the
     earlier schedule, blocks of 128 rays and a window of 32 clusters (the
     same winners, its own rounds and work); the five
     routes' winners against K5's, every lane where two differ printed;
     then one uncut scene-8 window on the walk route with binned2 and the
     binary BVH walk fed the same rays at every level: the lanes whose
     winners differ, as ties (equal t) and non-ties, and the first one;
     and at every 32nd level of that window K5 against its plain version
     on the level's rays as they lie and sorted;
 19. renders through `cli.main`, launch counts read around each:
     `-S 8 --mesh binned2` (K11 once per level, no K4), `--b1-fused` (the
     binned route's fused rounds) and `--mesh walk --no-traverse8`, all
     three CUT to 25 spp (5x5 strata, the full frame) and, with phase 10's
     `--mesh binned` render, held to phase 10's 25-spp walk render; then
     `--mesh binned2` at the full registry configuration, held to phase
     10's uncut walk render;
 20. timings of K9-K12 at those shapes with their bounds (K10 on every
     round of phase 18's fused call, beside K4's rounds of phase 11, each
     round with its bound; K11's also under the work of the earlier
     schedule: blocks of 128, a window of 32), and
     the device's busy share of a 4-spp binned2 render under
     torch.profiler;
 21. book3 (glass sphere, sphere light) and cornellSmoke (two media): K1,
     K9, K6 and K8 against their plain versions at 131072 lanes on a mixed
     state (starts, ranks, time planes exact; NaN lanes counted), then
     both scenes at their registry configuration (600x600, 10 spp = 9
     strata, depth 50, 131072 lanes) through `cli.main` under `queue_ik`,
     `--direct-rec`, `--schedule queue` and `--schedule positional`:
     paths, no non-finite pixel, segments per path within 5% of the
     registry's mean path length, `--direct-rec` with `queue_ik`'s
     segments, the schedules' channel means within 1e-2 of `queue_ik`'s;
 22. simpleLight (marble noise) and book1 (checker, 389 spheres, moving
     ones among them, glass, metal, defocus): K1, K9, K6 and K8 against
     their plain versions as in phase 21 (the new rays counted over all
     lanes), K6 on a test scene with a checker ground and quad and a
     perlin, a marble and a turbulent sphere, the four kernels timed at
     the registry cadence (1) with their bounds, both scenes at their
     registry configuration (400x225, 100 spp, depth 50, 131072 lanes)
     through `cli.main` under the four routes with phase 21's gates (but
     at most TEX_NONFINITE_MAX non-finite pixel values: the reference's
     own 0/0 weight at an edge-on light sample), and one timed render
     each at `--cadence 8`;
 23. the culled closest-hit scan (every section of more than one block
     of 8 culled, spheres in Morton order, winners by (t,
     row), the box reciprocals hoisted where no box turns): each fused
     variant's and K3's registers, spill, staged shared bytes (the scan
     table's staged prefix) and resident blocks per SM (at least 4) on the
     seven dense scenes, on the synthetic scan scene at MAX_PRIMS = 4,096
     rows (scenes/synthetic.py, lambertian and metal, inactive rows) in two
     mixes, spheres past the staging budget and quads past it, and on the
     tie scene (the pair's second sphere moving, scanned first); on book1,
     both mixes and the tie scene K1, K9, K6 and K8 against their plain
     versions at one level, and K1 and K9 (on book1 also K6 and K8) at 8
     (the queue's outputs exact, the lanes' flags, alive bits and records
     within phases 21-22's fractions, the new rays too at one level), K9
     equal to K1 bit for bit, the coincident pair's tie going to the first
     row, K3 on the scan scenes, and on the tie scene K3 and its plain
     version at ray time 0 giving every ray that meets the pair to the
     first row; the cull bit for bit (rows cleared against rows moved out
     of reach); K1's device time per level on each scene with its
     brute-force bound and, on book1 and book2, its culled bound (the
     plain model's tests on the call's rays); with `--parent DIR`, K1,
     K9, K6, K8 and K3 (on both of its pools; on every registry scene bit
     for bit) held to the parent checkout's kernels on the same
     inputs (scripts/time_fused_kernels.py --save/--compare);
 24. quads (the earth map on a quad) and book2 (the earth map on a
     sphere; 1,006 spheres, 400 boxes, all staged, glass, two
     sphere media): their staged bytes against the
     kernel's shared memory, K1, K6 and K8 against their plain versions
     on an aged pool as in phase 21 with each call's image lanes counted
     and their texels held (TEXEL_MOVED_FRAC), K9 refusing both, the three
     kernels timed with their bounds (book2 also its culled bound), both
     scenes at their registry
     configuration (quads 400x400, book2 800x800, 100 spp, depth 50 and
     40, 131072 lanes) through `cli.main` under `queue_ik`, `--schedule
     queue` and `--schedule positional` (book2's CUT to 25 spp) with
     phase 22's gates, and `--direct-rec` exiting 2 naming the image
     textures;
 25. K3 `bounce` in full: in dense mode (the reference engine's bounce) on
     the seven dense scenes, one feature set each (ops/bounce.
     fused_features: cornellBox 0, book3 3, cornellSmoke 4, simpleLight 9,
     book1 11, quads 42, book2 47), at 131072 lanes, and in ext mode on
     scene 8, on scene 8 with a glass sphere and a fog medium
     (scenes/synthetic.glass_fog_statue) and on an image-textured mesh
     (synthetic.image_mesh), at 131072 lanes, from the walk's winner:
     against its plain version on camera rays and one level later (flag
     words within each scene's flip fraction, image lanes' texels within
     TEXEL_MOVED_FRAC), then timed (CUDA events, host us per call and
     device time) with its bound (book1 and book2 also their culled bound), registers,
     staged bytes and spill per variant;
 26. the reference engine's paths through `cli.main`, launch counts set to
     0 before each and read after: the slice's main path, cornellBox
     600x600 `--integrator wavefront` (its bounce on K3 alone), CUT to 16
     spp, held to two `queue_ik` seeds at 16 spp by channel means (within
     4 standard deviations of the two-seed difference), and with
     `--backend xla` (no kernel; 4 spp) held to K3 on the same random
     stream and to `queue_ik`; book2 800x800 on K3 with
     every feature (4 spp, CUT); modelExample 600x337 on the wavefront
     integrator (the tensor bounce, K5 once a level; 4 spp, CUT) and under
     `--schedule positional` (9 spp, CUT), held to the walk route;
     lanternhouse (`--obj assets/lanternhouse.obj`: triangle lights, no
     kernel carries it) through regen's unfused window at 600x337, 16 spp
     (CUT), depth 50; the five other dense scenes at 1 spp on the
     wavefront integrator and the two ext meshes through `render_regen`,
     counting K3's launches per feature set; each path's levels replay as
     CUDA graphs (stats "graph", levels run and recorded, ms a level run
     printed beside EAGER_MS_BEFORE's eager figures);
 27. gradients through the reference engine (autograd over
     `wavefront.radiance` mode "scan" backend "xla", `parallel/mesh`):
     GRAD.md's configuration, 128x128 @ 16 spp (4x4 strata, 262,144
     rays), depth 10, on cornellBox, book3 and cornellSmoke, every leaf
     and the camera origin: the gradient step (forward + backward between
     two synchronizes; the least of three; and the same gradient as one
     CUDA graph, its ms, pool and peak memory, its leaves against the
     eager one's, held within GRAPH_LEAF_TOL with deterministic
     algorithms on), the forward alone, forward
     segments, grad rays/s, peak memory above what was allocated before
     the step, every leaf finite, two runs'
     leaves within GRAD_RUN_TO_RUN (the scatter-add's atomic order), no
     kernel launched; GRAD.md's pathwise FD rows (central differences,
     common random numbers) within GRAD_FD_REL, the score-function rows
     and the camera printed; the card's gradient against the CPU's on the
     same uniforms at 32x32 @ 4 spp, depth 6, on the lanes whose paths
     agree (GRAD_CPU_RTOL); modelExample at 600x337 @ 1 spp, depth 10,
     its triangle hit on K5 (launches counted: one a level, no other
     kernel), every leaf finite; five `make_train_step` steps on
     cornellBox at GRAD.md's scale toward a target rendered with the true
     parameters from a perturbed white wall and light: the loss falls;
 28. multi-device on a one-rank NCCL group (`parallel/distributed
     .initialize` over a file:// rendezvous in a temporary directory; NCCL
     runs a rank per GPU and the machine has one): the slice's main path,
     `render_regen_sharded` on the cornellBox flagship at full registry
     size under `queue_ik` (K1, K2; launch counts set to 0 before it and
     read after), held to `render_regen` with the same seed bit for bit,
     image and segments, and the same under `--direct-rec` (K9),
     `queue` (K6, K7) and `positional` (K8); the `queue_ik` and `queue`
     loop times of both in fresh calls, in turns; one window's sum and the
     final gather
     timed alone; modelExample at 4 spp (phase 26's cut) held to
     `render_regen` bit for bit (K5, K3, K2); the sharded
     `make_train_step` on a 1 x 1 mesh against the one-device step on the
     same keyed uniforms at GRAD.md's 128x128 x 16 batches, three Adam
     steps: losses within MULTI_LOSS_RTOL, gradients and leaves within
     GRAD_RUN_TO_RUN; `render_sharded` on cornellBox at 1 spp (the
     reference engine): finite, segments per path within phase 5's gate;
     the sorted `queue` flagship (reorder=True) bit for bit too; the
     group destroyed at the end;
 29. the lane coherence sort (`render_regen(reorder=True)`): (a) the
     sort's permutation and gathered planes on the card against the CPU,
     bit for bit, on aged 131,072-lane pools of cornellBox, book1 and
     book2, the sort's ms, host and device time and launches a call, and
     K6's device time on those rays as they lie and sorted; (b) K7's
     unwinding entry `grt_harvest_rows_perm` on a recorded sorted window
     of each of those flagships against its plain version (bit for bit,
     every started item once, NaN past the last) and, with identity
     perms, against K7; its ms a window beside K7's on the same records,
     in turns, its plain version's and its bytes bound; its barrier share
     (its own grid's barriers alone, `K7P_PROBE_CU`), its time with L in
     three planes, and its registers and spill; (c) the three flagships
     (PERF.md §4) sorted and unsorted under `queue`, in turns: paths,
     non-finite values, segments per path within 5% of `regen_len`,
     channel means within 1e-2 of the unsorted render, launches (K6 and
     the unwinding entry only), loop times; scripts/ab_reorder.py's cell
     (book1, book2 at 25 spp, cadence 4: queue_ik, queue, sorted queue).
     K6's device time a call inside sorted and unsorted renders comes from
     scripts/ab_reorder_torch.py --profile, in fresh processes;
 30. the mesh window as one device program, on one real scene-8 window
     (255 levels, refill 204, 131,072 lanes): (a) the mesh level's glue
     kernel (`ops/mesh_level`, csrc/mesh_level.cu: `grt_mesh_refill`,
     `grt_mesh_record`) against its plain version at every level, bit for
     bit, both entries timed on a real level beside their plain versions
     and their bytes bound; (b) the window replayed as a CUDA graph
     against the same window run eagerly on the plain glue (same state,
     seed and cursor), on the walk and on binned2: records, bases,
     accumulator, cursor, segments and levels bit for bit; (c) the walk
     window graphed and eager (the glue kernel, no graph): per level the
     host-issued launches, the calls that wait on the device (torch.cuda's
     sync debug mode, with their source lines; at most one a window in the
     graphed one) and the wall ms;
 31. the reference engine and the gradient step as device programs
     (`engine_program_phase`): the reference engine's renders of
     cornellBox on K3 (4 spp) and on the tensor bounce, book3,
     cornellSmoke and modelExample on the walk (K5) at 1 spp, each level
     one CUDA graph replay, against the same renders run eagerly, bit for
     bit, with ms a level, levels run and recorded, and per level of one
     131,072-ray call host-issued and device launches, waits and wall
     ms; regen's unfused window on the tensor bounce for modelExample (4
     spp) and lanternhouse (300 wide, 1 spp), graphed against eager, the
     same image SHA-256; the launch counters of K3, K5 and the glue
     against the card's count under torch.profiler; new uniforms at every
     replay; `make_train_step` as one CUDA graph against the eager step,
     five steps on GRAD.md's cornellBox and on modelExample at 1 spp
     (losses within GRAPH_LOSS_RTOL, leaves within GRAPH_LEAF_TOL of
     their largest entry, ms a step, peak memory, waits a step);
then the `kernels` JSON line (K1-K12 and the mesh level's glue; K1, K6
and K8 name their image variant, K3 its feature sets and its cap entry,
K7 its unwinding entry, K3, K6 and K8 their redesign, K5 its launches on
phase 27's modelExample gradient, K1-K3 and K5-K9 their launches in
phase 28's sharded renders),
the nvidia-smi line, and the final
{"ok": true, "device": ...} line.

Without CUDA, or outside the repository, it exits non-zero and prints no
result.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

# peak rates of one H100 SXM (NVIDIA data sheet): HBM3 and float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations per traced segment of bounce_fused_q on cornellBox,
# counted from csrc/bounce_fused_q.cu: 6 quads x ~38, 2 rotated boxes x
# ~50, shading + light sample + pdf ~150 (the 14 hashes are integer work)
K1_OPS_PER_SEGMENT = 480
# the same count for the two scenes the fused kernels gained, from
# csrc/bounce_core.cuh: book3 has 6 quads, one rotated box and one sphere
# (~30), a second light whose sphere pdf every lane evaluates (~35) and the
# dielectric branch (~45 on the lanes that meet the glass); cornellSmoke
# has 6 quads and two rotated box media (~45 each: the slab in object
# space, the log of the free flight), and no box
# simpleLight: 3 spheres and a quad (~130) and shading, the quad light's
# sample and pdf (~150), and on a marble row (the ground and the large
# sphere: nearly every hit) 7 turbulence octaves x 8 corners x ~30 float
# operations (gradient, normalisation, weight, dot; the hash is integer
# work) and the sine (~1,700); book1: 389 sphere tests x ~30 (~11,700),
# shading, the sun's cone sample and sphere pdf (~220), the checker (~10),
# metal and glass (~45)
# quads: 5 quads x ~38, shading, the quad light's sample and pdf (~150),
# the marble on the one marble quad (~1,700 on its hits, a fifth of them:
# ~350) and an image lane's uv, index and texel (~40); book2: 1,006 sphere
# tests x ~25 (~25,000), 400 box slabs x ~40 in object space (~16,000),
# the quad, the two sphere media (~90), shading, the light's sample and pdf
# and the dielectric (~300), the marble on its sphere's hits (~400)
OPS_PER_SEGMENT = {"cornell_box": K1_OPS_PER_SEGMENT, "book3": 560,
                   "cornell_smoke": 470, "simple_light": 2000,
                   "book1": 12000, "quads_scene": 700, "book2": 42000}
# the same counts outside the closest-hit scan, for the scenes the kernels
# cull (book1: shading, the sun's sample and pdf, the checker, metal and
# glass; book2: the media, shading, the light's sample and pdf, the
# dielectric and the marble): the culled bound adds them to the scan's
# tests that the plain model counts on the timed rays (`culled_ops`)
NONSCAN_OPS = {"book1": 275, "book2": 790}
# the new scenes' registry configurations: (-S number, mean path length)
NEW_SCENES = {"book3": (3, 5.54), "cornell_smoke": (7, 2.91)}
# the textured scenes' (phase 22): simpleLight's marble noise, book1's
# checker, 389 spheres and defocus
TEX_SCENES = {"simple_light": (4, 1.69), "book1": (1, 2.60)}
# book3's glass sphere turns a rounding into a reflect/refract flip within a
# few levels: the fraction of lanes its checks allow to flip
# (tests/test_torch_fused.py measures 2.5e-3 against the JAX package)
DIEL_MISMATCH_FRAC = 5e-3
# phase 22's: simpleLight is held to K1's default, book1 (glass, fuzzed
# metal, 389 spheres on a radius-1000 ground sphere with its f32 acne) to
# book3's. At 8 levels on a random pool few lanes stay alive in both runs
# (1,143-4,642 of 131,072), and a ray that went another way from the acne
# is a large share of those: their rays are counted over all lanes. The
# pool's far hits on the ground sphere carry its acne into the marble's 7
# octaves, which moves the records of other lanes at every level: simpleLight
# K6 1.25e-3 of the records, 7.6e-3 of the lanes at one level or more
TEX_MISMATCH_FRAC = {"simple_light": 2e-3, "book1": DIEL_MISMATCH_FRAC}
# non-finite pixel values a phase-22 render may have: where a light is
# sampled exactly edge-on (simpleLight: a point on the light's plane;
# book1: the sun's cone edge) the mixture pdf and the scattering pdf are
# both 0 and the weight 0/0 is NaN, in the reference and the JAX package
# as here (the plain version reproduces it from the card's inputs); the
# tonemap writes it 0, as the reference's PrintColor does. One pixel (3
# values) per 9,000,000-path render was seen; 4 pixels are allowed
TEX_NONFINITE_MAX = 12
# the scenes with image textures (phase 24): quads' earth map on a quad,
# book2's on a sphere beside every other feature of the fused kernels
IMG_SCENES = {"quads_scene": (5, 1.47), "book2": (2, 5.08)}
# quads is held to K1's default. book2's marble sphere is ~900 units from
# the camera, where a root carries ~6e-4 units of float32 rounding, and
# its marble (0.5 (1 + sin(0.2 z + 10 turb(p))), 7 octaves each as steep
# as the first) turns a unit into ~100 rad: at one level 1,304 of its
# 16,610 marble lanes (7.9%, 1.0% of all lanes) leave rtol 2e-3, against
# 8 other lanes; over 8 levels of an aged pool 1.07e-2 of the records, and
# the glass, the medium filling the glass orb and the fog flip 6.0e-3 of
# the flag words (NVIDIA H100 80GB HBM3, 700 W). book2 is held to 2e-2.
IMG_MISMATCH_FRAC = {"quads_scene": 2e-3, "book2": 2e-2}
# of the image lanes that agree on their flags at level 0, those whose
# texel may move to a neighbour (a hit point one rounding apart), measured
# on NVIDIA H100 80GB HBM3, 700 W: quads 0 of 11,277 (K1, K6) and of 9,885
# (K8); book2 6 of 12,477 (K1, K6: 4.8e-4) and 3 of 3,917 (K8, one of them
# a lane whose winner flipped to the fog). book2's earth sphere is ~1,000
# units from the camera and 100 in radius, so a root's discriminant
# cancels ~100 to 1 and the hit carries ~3e-4 units of rounding; the JAX
# package and the plain version part on 1 of 321 lanes the same way
# (tests/test_torch_bounce.py)
TEXEL_MOVED_FRAC = {"quads_scene": 1e-3, "book2": 2e-3}
# how many columns away a moved texel may lie (texel_check in phase 24)
TEXEL_COLS = 16
# cornellBox's K1 per call as PERF.md §6 records it before this version of
# the core (NVIDIA H100 80GB HBM3, 700 W)
K1_EARLIER_MS = 0.1079
# plain-vs-kernel tolerances (module docstrings of ops/bounce.py and
# csrc/bounce_fused_q.cu: FMA contraction, rsqrtf and __sincosf differ
# from the plain ops by ~1e-6 relative, and a lane grazing an edge may
# branch the other way)
K1_RTOL = K1_ATOL = 2e-3
K1_MISMATCH_FRAC = 2e-3
# K3 shares K1's bounce core and its tolerance; alive and clamp flags may
# differ on this fraction of the lanes (a ray grazing an edge)
K3_MISMATCH_FRAC = 1e-3
# float arithmetic per test, counted from csrc/mt.cuh and
# csrc/traverse8.cu: one Moller-Trumbore test is 27 multiplies, 18 adds or
# subtracts and 1 divide; one slab test of a child box is 6 subtracts and 6
# multiplies. These sources are built with -fmad=false, so each multiply
# and each add is one operation of its own (the peak above counts a fused
# multiply-add as two). Compares and min/max are left out (9 compares per
# triangle test; 11 min/max and 7 compares per box test): they are not
# float arithmetic, so the bound is the lower for it.
MT_OPS = 46
BOX_OPS = 12
# per alive lane of `bounce` on scene 8, counted from csrc/bounce_core.cuh:
# 2 spheres x ~30, the ext fold, shading, the sphere-light sample and pdf,
# the metal reflection
K3_OPS_PER_SEGMENT = 300
# the same count on phase 25's other ext meshes: the glass sphere's test
# and the dielectric branch (~75) and the fog's sphere span and free
# flight (~35) beside scene 8's; the image mesh's ground sphere and quad
# light (~70), shading, the quad light's sample and pdf (~150) and the
# texel's index (~15)
K3_EXT_OPS = {"scene8": K3_OPS_PER_SEGMENT, "glass_fog": 410,
              "image_mesh": 235}
SCENE8_PATHS = 600 * 337 * 225
# what the kernels line says of K3
REDESIGN_K3 = ("redesigned: in ext mode the mesh winner is gathered inside "
               "the kernel from the walk's (t, idx), the dense cap is one "
               "launch of its cap entry, and the launch is prepared once a "
               "scene; phases 8, 10, 11 and 25")
# the seven dense registry scenes
REGISTRY_DENSE = ("cornell_box", "book3", "cornell_smoke", "simple_light",
                  "book1", "quads_scene", "book2")
# what the kernels line says of K6 and K8
REDESIGN_SCAN = ("redesigned: the closest-hit scan of "
                 "bounce_core.cuh over tight, culled blocks of every "
                 "section (spheres in Morton order), winners by (t, row), "
                 "the box reciprocals hoisted; timed per scene in phases "
                 "22-24")
# what the kernels line says of K7's unwinding entry
REDESIGN_K7P = ("redesigned: the lanes stay in place and L moves through "
                "two state buffers, one cooperative launch with a "
                "grid-wide barrier a row, K7's block-ballot ranks, no rank "
                "plane; timed on a window of each flagship in phase 29 (b)")


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=1):
    """Milliseconds per call of `fn` between two CUDA events around `reps`
    calls. With 10 calls or more the batch is run three times and the
    least taken: these calls are host-bound, and one stall of the host (a
    garbage collection, another process on its cores) would otherwise be
    spread over the batch."""
    import torch
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(3 if reps >= 10 else 1):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def host_us(fn, reps=40):
    """Host microseconds per call of `fn`, `reps` calls enqueued back to
    back before the synchronize (the least of three batches)."""
    import torch
    fn()
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return best


def queued_device_ms(run, reps=20):
    """Device ms per call of `run`: the launches queued behind a ~0.1 s
    spin of the device, so that they run back to back, between two CUDA
    events. None where the host took longer to queue them than the spin
    lasted (the events would then hold host gaps)."""
    import torch
    run()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    h0 = time.perf_counter()
    t0.record()
    for _ in range(reps):
        run()
    t1.record()
    queued_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    return None if queued_s > 0.05 else t0.elapsed_time(t1) / reps


def kernel_of(key, names):
    """True when a profiler event key is a launch of one of the kernels
    `names` (a template instance `void name<...>(...)` included)."""
    return any(key.startswith(nm) or key.startswith("void " + nm + "<")
               for nm in ((names,) if isinstance(names, str) else names))


def device_times(prof):
    """{kernel or copy name: microseconds on the device} of a profile:
    device-side events only (the host ops that launched them would count
    the same time twice)."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0 and "CUDA" in str(getattr(e, "device_type", "")):
            out[e.key] = t
    return out


def device_launches(prof, names):
    """{kernel name: its launches on the device} of a profile, for each of
    `names` (`kernel_of`): the kernels the card ran, a CUDA graph's nodes
    included, as the profiler's device events count them."""
    from torch.autograd import DeviceType

    keys = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {nm: sum(1 for k in keys if kernel_of(k, nm)) for nm in names}


def ppm_channel_means(path):
    """Channel means in [0, 1] of a P3 PPM as the CLI writes it."""
    import numpy as np
    with open(path) as fh:
        txt = fh.read().split()
    vals = np.asarray(txt[4:], dtype=np.float64).reshape(-1, 3)
    return vals.mean(axis=0) / float(txt[3])


def started_ranks_are_a_prefix(fl, take):
    """Per level, the started lanes' ranks (FL bits 3..) are exactly
    0 .. take-1: no item is skipped or given to two lanes."""
    import torch
    s, n = fl.shape
    started = (fl & 4) != 0
    lvl = torch.arange(s, device=fl.device)[:, None].expand(s, n)[started]
    hits = torch.zeros(s * n, dtype=torch.int32, device=fl.device)
    hits.index_add_(0, lvl * n + (fl[started] >> 3).long(),
                    torch.ones_like(lvl, dtype=torch.int32))
    want = torch.arange(n, device=fl.device)[None, :] < take[:, None]
    return torch.equal(hits.view(s, n), want.to(torch.int32))


@contextlib.contextmanager
def plain_versions(bounce, harvest, stream, traverse8):
    """Swap the mesh path's kernel wrappers (K3 and its dense cap, through
    `bounce.bounce` and the prepared `K3Launch`, K4, K5, K2 and the mesh
    level's glue) for their plain PyTorch versions, whatever device the
    tensors are on, so that a render on the card can be repeated op for
    op without the kernels, on the same random stream."""
    from go_raytracer_tpu_torch.ops import mesh_level

    saved = (bounce.bounce, stream.stream_rows, traverse8.bvh8_closest,
             harvest.harvest_levels_into, bounce.K3Launch.__call__,
             bounce.K3Launch.cap, mesh_level.refill, mesh_level.record)

    def plain_walk(nodes, tris, o, d, t_cap=None, *, max_stack=None):
        return traverse8.bvh8_closest_ref(nodes, tris, o, d, t_cap)

    def plain_harvest(acc, Vr, Vg, Vb, FL, bases, *, item_base, s_run,
                      refill_levels, max_contribution):
        rows = harvest.reverse_harvest_levels_ref(
            Vr, Vg, Vb, FL, refill_levels=refill_levels,
            max_contribution=max_contribution, s_run=s_run)
        return harvest.write_rows_ref(acc, rows, bases, item_base=item_base,
                                      n_rows=min(s_run, refill_levels))

    def plain_k3(self, o, d, time, alive, u, ext=None, out=None):
        return bounce.bounce_ref(self.tables, self.statics, o, d, time,
                                 alive, u, self.bg, ext, out, tri=self.tri)

    def plain_cap(self, ms, o, d, time, out=None):
        return bounce.dense_cap_ref(ms, o, d, time)

    bounce.bounce, stream.stream_rows = bounce.bounce_ref, stream.stream_rows_ref
    traverse8.bvh8_closest = plain_walk
    harvest.harvest_levels_into = plain_harvest
    bounce.K3Launch.__call__, bounce.K3Launch.cap = plain_k3, plain_cap
    # the mesh level's glue (its plain version reads the host, so the
    # render's levels run eagerly: `mesh_level.kernel_glue`)
    mesh_level.refill, mesh_level.record = (mesh_level.refill_ref,
                                            mesh_level.record_ref)
    try:
        yield
    finally:
        (bounce.bounce, stream.stream_rows, traverse8.bvh8_closest,
         harvest.harvest_levels_into, bounce.K3Launch.__call__,
         bounce.K3Launch.cap, mesh_level.refill, mesh_level.record) = saved


def tri_hit_bytes(bounce, tri, statics, idx, alive):
    """Bytes K3's ext gather needs of the distinct triangles the live lanes
    hit (`idx`, -1: none): v0, e0 and e1; has_vn, then the three vertex
    normals where the mesh has them, else the face normal; with images
    has_uv and the three vertex uv where present; the material columns of
    the scene's layout. Flags count as the plain tables' bools (1 B), the
    rest as float32. Returns (bytes, distinct triangles)."""
    import torch
    ids = torch.unique(idx[(idx >= 0) & alive]).long()
    has_vn = tri.tr.has_vn[ids]
    nbytes = ids.numel() * (36 + 1 + 4 * len(bounce._mat_layout(statics))) \
        + int(has_vn.sum()) * 36 + int((~has_vn).sum()) * 12
    if statics["has_image"]:
        nbytes += ids.numel() + int(tri.tr.has_uv[ids].sum()) * 24
    return nbytes, int(ids.numel())


def fused_bound(nbytes, segs, scene="cornell_box", ops=None):
    """(bound in ms, "bytes" or "operations") of a fused bounce call that
    moves `nbytes` and traces `segs` segments of `scene`, at `ops` float
    operations a segment (default the brute-force count of the scene,
    OPS_PER_SEGMENT)."""
    b = nbytes / HBM_BYTES_PER_S
    o = segs * (OPS_PER_SEGMENT[scene] if ops is None else ops) \
        / FP32_OPS_PER_S
    return max(b, o) * 1e3, "bytes" if b >= o else "operations"


def bounce_rays(bounce, run_ref):
    """The rays that enter the bounce of each level of `run_ref()` (a call
    of a fused kernel's plain version): [(ox, oy, oz, dx, dy, dz, tm,
    alive)], captured around the plain core."""
    core = bounce._bounce_core_ref
    got = []

    def capture(st_, prims, lights, bg_, ox, oy, oz, dx, dy, dz, alive, u,
                tm=None, **kw):
        got.append((ox, oy, oz, dx, dy, dz, tm, alive.clone()))
        return core(st_, prims, lights, bg_, ox, oy, oz, dx, dy, dz, alive,
                    u, tm=tm, **kw)

    bounce._bounce_core_ref = capture
    try:
        run_ref()
    finally:
        bounce._bounce_core_ref = core
    return got


def culled_ops(bounce, tables, statics, rays):
    """Float operations per segment of the culled scan on these rays
    [(ox, oy, oz, dx, dy, dz, tm, alive)]: the tests the plain model of the
    kernels' scan makes (`closest_culled_ref`, `scan_ops`), over the alive
    lanes of every level. The culled bound counts these beside the rest of
    the bounce (NONSCAN_OPS)."""
    import torch
    lay, _ = bounce.scan_tables(tables[0], statics)
    total, segs = 0.0, 0
    with torch.no_grad():
        for *ray, alive in rays:
            stats = {}
            bounce.closest_culled_ref(statics, tables[0], *ray, layout=lay,
                                      stats=stats)
            total += float(bounce.scan_ops(lay, stats)[alive].sum())
            segs += int(alive.sum())
    return total / max(segs, 1)


def aged_state(run, state, calls=8):
    """The lane state after `calls` calls of `run(state) -> new state`
    with a deep queue: the pool holds camera rays, bounced rays and dead
    lanes, as in a render."""
    for _ in range(calls):
        state = [s.clone() for s in run(state)]
    return state


def cornell_inputs(dev, n, seed=0, scene="cornell_box"):
    """A dense scene's tables (cornellBox unless `scene` names another
    registry function) and a mixed lane state at its registry camera."""
    import numpy as np
    import torch
    from go_raytracer_tpu_torch.ops import bounce
    from go_raytracer_tpu_torch.scenes import registry

    scene, cam = getattr(registry, scene)()
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tables = tuple(to(t) for t in bounce.pack_scene(scene))
    statics = bounce.scene_statics(scene)
    cam_row = to(bounce.pack_camera(cam.derived()))
    bg = to(np.asarray(scene.background, np.float32))
    rs = np.random.default_rng(seed)
    o = rs.uniform(50, 500, (n, 3)).astype(np.float32)
    d = (rs.normal(size=(n, 3)) * 300).astype(np.float32)
    state = [to(o[:, 0]), to(o[:, 1]), to(o[:, 2]), to(d[:, 0]),
             to(d[:, 1]), to(d[:, 2]),
             to(rs.uniform(0, 1, n).astype(np.float32)),
             to((rs.uniform(size=n) < 0.6).astype(np.int32)),
             to(rs.integers(0, 50, n).astype(np.int32))]
    return scene, cam, tables, statics, cam_row, bg, state


def scan_inputs(dev, n, n_sph, n_quad, n_box, seed=0, moving_pair=False):
    """The synthetic scan scene (scenes/synthetic.py: the coincident pair
    first, lambertian and metal spheres, some moving, quads, rotated
    boxes, every INACTIVE_EVERY-th row cleared to kind -1), no dielectric,
    with its camera and a mixed lane state of rays among its primitives,
    as cornell_inputs returns them; `moving_pair`: the tie scene."""
    import numpy as np
    import torch
    from go_raytracer_tpu_torch.ops import bounce
    from go_raytracer_tpu_torch.scenes import synthetic as syn

    scene, cam, tabs, statics = syn.build(n_sph, n_quad, n_box, seed=seed,
                                          dielectric=False,
                                          moving_pair=moving_pair)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    state = [to(x) for x in syn.lane_state(n, seed + 1)]
    return (scene, cam, tuple(to(t) for t in tabs), statics,
            to(bounce.pack_camera(cam.derived())),
            to(np.asarray(scene.background, np.float32)), state)


# the gradient phase (27): GRAD.md's configuration (128x128 @ 16 spp =
# 4x4 strata, depth 10) on the three registry scenes whose leaves cover
# the parameter vector, and modelExample at its full width
GRAD_SCENES = ("cornell_box", "book3", "cornell_smoke")
GRAD_WIDTH, GRAD_SPP, GRAD_DEPTH = 128, 16, 10
# modelExample's registry width (600x337), at 1 spp
GRAD_MESH_WIDTH = 600
# the pathwise rows of GRAD.md's FD table, held to central differences
# with common random numbers at GRAD_FD_REL (abs GRAD_FD_ABS), as
# tests/test_grad.py::test_grad_scale_cornell_fd holds them:
# (leaf, index or "light" for the light's texture row, eps, label).
# Texture row 0 of the three scenes is the red wall (0.65, 0.05, 0.05):
# GRAD.md and test_grad.py call it the white wall's; row 1 is the white
# wall's, held too
GRAD_FD_PATHWISE = {
    "cornell_box": [("tex_color", (0, 0), 1e-2,
                     "red-wall albedo R (GRAD.md's 'white-wall' row 0)"),
                    ("tex_color", (1, 0), 1e-2, "white-wall albedo R"),
                    ("tex_color", "light", 1e-1, "light emission R"),
                    ("background", (1,), 1e-2, "background G")],
    "book3": [("tex_color", (0, 0), 1e-2, "red-wall albedo R")],
    "cornell_smoke": [("tex_color", (0, 0), 1e-2, "red-wall albedo R")]}
# the score-function rows (ref_idx through the Schlick choice, the media
# density through the transit likelihood; GRAD.md's eps) and the camera
# origin (a silhouette's boundary term the estimator does not model):
# printed, finite, agreeing with the FD only in expectation
GRAD_FD_SCORE = {"book3": [("ref_idx", "diel", 2e-3, "glass ref_idx")],
                 "cornell_smoke": [("med_neg_inv_density", (0,), 2.0,
                                    "smoke neg_inv_density")]}
GRAD_FD_REL, GRAD_FD_ABS = 0.05, 5e-5
# two card runs of one gradient differ by the atomic order of the
# gathers' scatter-add backward: each leaf's largest difference against
# its largest entry
GRAD_RUN_TO_RUN = 1e-3
# the card's gradient against the CPU's on the same uniforms (32x32 @ 4
# spp, depth 6), on the lanes whose paths agree on both devices (at every
# level the same alive flag and a continuing origin, and in the end the
# radiance, within GRAD_LANE_TOL relative and absolute; a lane a rounding
# sent the other way, at most DIEL_MISMATCH_FRAC of them, is left out:
# radiance alone does not tell the glass's two branches apart where both
# reach the light with weight 1): each leaf's largest difference against
# its largest entry
GRAD_CPU_RTOL, GRAD_LANE_TOL = 1e-3, 2e-3
# a captured gradient against the eager one on the same uniforms: the
# backward's atomic scatter-adds add in another order (ROADMAP.md
# "Differences by design"), so each leaf within this share of its largest
# entry; losses within GRAPH_LOSS_RTOL
GRAPH_LEAF_TOL, GRAPH_LOSS_RTOL = 3.1e-6, 1e-6


def zero_launches():
    """Every kernel wrapper's launch count set to 0."""
    from go_raytracer_tpu_torch.ops import bounce, harvest, stream, stream2
    from go_raytracer_tpu_torch.ops import traverse, traverse8

    from go_raytracer_tpu_torch.ops import mesh_level

    bounce.launches = bounce.launches_bounce = bounce.launches_cap = 0
    bounce.launches_fused = bounce.launches_fused_pos = 0
    bounce.launches_direct = harvest.launches = harvest.launches_rows = 0
    harvest.launches_rows_perm = 0
    stream.launches = stream.launches_round = stream2.launches = 0
    traverse.launches = traverse8.launches = 0
    mesh_level.launches_refill = mesh_level.launches_record = 0


def launch_counts():
    """{kernel: launches since zero_launches}, K3's cap entry as "cap",
    the mesh level's glue entries as "refill" and "record"."""
    from go_raytracer_tpu_torch.ops import bounce, harvest, mesh_level
    from go_raytracer_tpu_torch.ops import stream, stream2, traverse
    from go_raytracer_tpu_torch.ops import traverse8

    return dict(K1=bounce.launches, K2=harvest.launches,
                refill=mesh_level.launches_refill,
                record=mesh_level.launches_record,
                K3=bounce.launches_bounce, cap=bounce.launches_cap,
                K4=stream.launches, K5=traverse8.launches,
                K6=bounce.launches_fused, K7=harvest.launches_rows,
                K7p=harvest.launches_rows_perm,
                K8=bounce.launches_fused_pos, K9=bounce.launches_direct,
                K10=stream.launches_round, K11=stream2.launches,
                K12=traverse.launches)


def gradient_phase(dev, card):
    """Phase 27: the gradient path (autograd over the reference engine,
    `wavefront.radiance` mode "scan" backend "xla", then an MSE and an
    Adam step through `parallel/mesh`) on the card. Returns its summary
    (rows per scene, modelExample's, the CPU agreement, the train
    losses); fails on a non-finite leaf, an FD row off its tolerance, a
    card gradient off the CPU's, a modelExample forward without K5, or a
    train loss that does not fall."""
    import dataclasses

    import numpy as np
    import torch

    from go_raytracer_tpu_torch.integrator import wavefront
    from go_raytracer_tpu_torch.ops import _cuda, bounce, harvest, stream
    from go_raytracer_tpu_torch.ops import stream2, trace, traverse, traverse8
    from go_raytracer_tpu_torch.parallel import mesh as pmesh
    from go_raytracer_tpu_torch.render import camera as camera_mod
    from go_raytracer_tpu_torch.scenes import registry

    def launches():
        return dict(K5=traverse8.launches, K3=bounce.launches_bounce,
                    other=bounce.launches + bounce.launches_cap
                    + bounce.launches_fused + bounce.launches_fused_pos
                    + bounce.launches_direct + harvest.launches
                    + harvest.launches_rows + stream.launches
                    + stream.launches_round + stream2.launches
                    + traverse.launches)

    def setup(name, width, spp, depth, device):
        scene, cam = getattr(registry, name)()
        cam.width, cam.samples_per_pixel, cam.max_depth = width, spp, depth
        if name != "model_example":
            cam.aspect_ratio = 1.0
        arrays = cam.derived().to(device)
        npix = width * cam.image_height
        sq = cam.spp_sqrt
        ids = torch.arange(npix, device=device).repeat(sq * sq)
        st = torch.arange(sq * sq, device=device).repeat_interleave(npix)
        s_i = torch.div(st, sq, rounding_mode="floor").float()
        s_j = (st % sq).float()
        ds = trace.to_device(scene, device)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in pmesh.extract_params(ds).items()}
        delta = torch.zeros(3, device=device, requires_grad=True)
        c0, p0 = arrays.center, arrays.pixel00

        def f(p, dlt, seed=5, uniforms=None, per_lane=False, mask=None,
              graph=None):
            """Mean radiance (nan_to_num) of the scene carrying p, the
            camera moved by dlt; uniforms from a generator seeded `seed`
            (common random numbers) or given as (u_cam, per-level u);
            `graph` is radiance's (under no_grad its levels replay as a
            CUDA graph by default)."""
            arr = dataclasses.replace(arrays, center=c0 + dlt,
                                      pixel00=p0 + dlt)
            if uniforms is None:
                g = torch.Generator(device=device).manual_seed(seed)
                u = torch.rand((ids.shape[0], camera_mod.N_U_RAYGEN),
                               generator=g, device=device)
                us = None
            else:
                g, (u, us) = None, uniforms
            o, d, t = camera_mod.generate_rays(arr, width, ids, s_i, s_j, u)
            L, stt = wavefront.radiance(pmesh.apply_params(ds, p), o, d, t,
                                        g, depth, cam.max_contribution,
                                        mode="scan", uniforms=us,
                                        graph=graph)
            L = torch.nan_to_num(L)
            if per_lane:
                return L
            if mask is not None:
                return (L * mask[:, None]).sum() / (3 * mask.sum()), stt
            return L.mean(), stt
        return scene, ds, params, delta, f, ids.shape[0]

    def grads_of(f, params, delta, **kw):
        for v in list(params.values()) + [delta]:
            v.grad = None
        loss, stt = f(params, delta, **kw)
        loss.backward()
        out = {k: (torch.zeros_like(v) if v.grad is None else v.grad.clone())
               for k, v in params.items()}
        out["camera"] = delta.grad.clone()
        return out, stt

    def rel_diff(a, b):
        scale = float(b.abs().max())
        return float((a - b).abs().max()) / scale if scale > 0 else \
            float((a - b).abs().max())

    def graphed_gradient(f, params, delta, n, n_u, ref):
        """The gradient of f on seed 5's uniforms as one CUDA graph: ms a
        replay (three), the graph pool's bytes, the peak over warm-up and
        capture, each leaf against the eager gradient `ref`."""
        uni = pmesh.StepUniforms.empty(n, GRAD_DEPTH + 1, n_u, dev)
        uni.draw(torch.Generator(device=dev).manual_seed(5))
        leaves = list(params.values()) + [delta]
        for v in leaves:
            v.grad = torch.zeros_like(v)

        def body():
            for v in leaves:
                v.grad.zero_()
            loss, _ = f(params, delta, uniforms=(uni.camera, uni.levels))
            loss.backward()
            return loss.detach()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pool0 = torch.cuda.memory_reserved()
        step = _cuda.StepGraph(body, True, dev)
        step()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        pool = torch.cuda.memory_reserved() - pool0
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v.grad.clone() for k, v in params.items()}
        got["camera"] = delta.grad.clone()
        rel = {k: rel_diff(got[k], ref[k]) for k in ref}
        del step
        # held with deterministic algorithms on, where the backward's
        # scatter-adds add in a fixed order: the eager gradient, then the
        # graphed one (in the default mode two eager runs already differ
        # in the atomics' last bits, `run_to_run`)
        torch.use_deterministic_algorithms(True)
        try:
            det_ref, _ = grads_of(f, params, delta)
            for v in leaves:
                v.grad = torch.zeros_like(v)
            step = _cuda.StepGraph(body, True, dev)
            step()
            step()
            step()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        det = {k: rel_diff(v.grad, det_ref[k]) for k, v in params.items()}
        det["camera"] = rel_diff(delta.grad, det_ref["camera"])
        check(max(det.values()) <= GRAPH_LEAF_TOL,
              f"the graphed gradient differs from the eager one with "
              f"deterministic algorithms: {det}")
        for v in leaves:
            v.grad = None
        del step
        return dict(step_ms=min(ms), step_ms_all=ms, pool_bytes=pool,
                    peak_bytes=peak, rel=rel, rel_deterministic=det)

    summary = {"card": card, "rows": {}}
    for name in GRAD_SCENES:
        scene, ds, params, delta, f, n = setup(name, GRAD_WIDTH, GRAD_SPP,
                                               GRAD_DEPTH, dev)
        kinds = scene.materials.kind
        light_tex = int(scene.materials.tex_id[np.where(kinds == 3)[0][0]])
        diel = int(np.where(kinds == 2)[0][0]) if (kinds == 2).any() else 0
        zero_launches()
        g0, stt = grads_of(f, params, delta)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases still hold is not the step's
        base = torch.cuda.memory_allocated()
        step_ms, runs = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gr, stt = grads_of(f, params, delta)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            runs.append(gr)
        peak = torch.cuda.max_memory_allocated() - base
        check(sum(launches().values()) == 0,
              f"{name}: the gradient path launched a kernel "
              f"{launches()}")
        fwd_ms = []
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                val, _ = f(params, delta)
                float(val)
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in runs[0].items():
            check(bool(torch.isfinite(v).all()),
                  f"{name}: the gradient of {k} is not finite")
        run_to_run = {k: rel_diff(runs[1][k], runs[0][k]) for k in runs[0]}
        check(max(run_to_run.values()) <= GRAD_RUN_TO_RUN,
              f"{name}: two card runs' gradients differ by {run_to_run}")
        # the same gradient as one CUDA graph (ops/_cuda.StepGraph): seed
        # 5's uniforms drawn once into fixed buffers, as f draws them, the
        # gradients zeroed in place, forward and backward captured
        gr_graph = graphed_gradient(f, params, delta, n,
                                    9 + ds.media.kind.shape[0], runs[0])
        segs = int(stt["segments"])
        best = min(step_ms)
        fd_rows = []

        def fd_row(leaf, idx, eps, label, gated):
            idx = (light_tex, 0) if idx == "light" else \
                (diel,) if idx == "diel" else idx
            with torch.no_grad():
                vals = []
                for sgn in (1, -1):
                    p2 = {k: v.detach().clone() for k, v in params.items()}
                    p2[leaf][idx] += sgn * eps
                    vals.append(float(f(p2, delta)[0]))
            fd = (vals[0] - vals[1]) / (2 * eps)
            an = float(runs[0][leaf][idx])
            rel = abs(an - fd) / max(abs(an), abs(fd), 1e-12)
            row = dict(param=label, leaf=leaf, idx=list(idx), analytic=an,
                       fd=fd, rel_err=rel, gated=gated)
            fd_rows.append(row)
            check(np.isfinite(an) and np.isfinite(fd),
                  f"{name} {label}: not finite ({an}, {fd})")
            if gated:
                check(abs(an - fd) <= GRAD_FD_REL * abs(fd) + GRAD_FD_ABS,
                      f"{name} {label}: analytic {an} against FD {fd}")

        for row in GRAD_FD_PATHWISE.get(name, []):
            fd_row(*row, gated=True)
        for row in GRAD_FD_SCORE.get(name, []):
            fd_row(*row, gated=False)
        if name == "cornell_box":
            with torch.no_grad():
                e = torch.tensor([1.0, 0.0, 0.0], device=dev)
                fd = (float(f(params, e)[0]) - float(f(params, -e)[0])) / 2.0
            an = float(runs[0]["camera"][0])
            fd_rows.append(dict(param="camera origin x", leaf="camera",
                                idx=[0], analytic=an, fd=fd,
                                rel_err=abs(an - fd) / max(abs(an), abs(fd),
                                                           1e-12),
                                gated=False))
        row = dict(rays=n, fwd_segments=segs, grad_step_ms=best,
                   grad_step_ms_all=step_ms, graph=gr_graph,
                   fwd_ms=min(fwd_ms),
                   grad_rays_per_s=segs / (best / 1e3),
                   peak_bytes=peak, run_to_run=run_to_run, fd=fd_rows)
        summary["rows"][name] = row
        print(f"[27] {name} {GRAD_WIDTH}x{GRAD_WIDTH} @ {GRAD_SPP} spp depth "
              f"{GRAD_DEPTH} on {card}: {n} rays, forward segments {segs}, "
              f"gradient step {best:.2f} ms (runs "
              f"{[round(x, 2) for x in step_ms]}), forward alone "
              f"{min(fwd_ms):.2f} ms, {segs / (best / 1e3):.4g} grad rays/s, "
              f"peak memory {peak / 2**30:.3f} GiB; run to run "
              f"{max(run_to_run.values()):.3g}")
        print(f"[27] {name}: the gradient step as one CUDA graph "
              f"{gr_graph['step_ms']:.2f} ms (runs "
              f"{[round(x, 2) for x in gr_graph['step_ms_all']]}; eager "
              f"{best:.2f} ms), pool {gr_graph['pool_bytes'] / 2**30:.3f} "
              f"GiB, peak {gr_graph['peak_bytes'] / 2**30:.3f} GiB, leaves "
              f"against the eager step's (of each leaf's largest) "
              f"{max(gr_graph['rel'].values()):.3g} (eager run to run "
              f"{max(run_to_run.values()):.3g}), with deterministic "
              f"algorithms {max(gr_graph['rel_deterministic'].values()):.3g}")
        for r in fd_rows:
            print(f"[27]   {name} {r['param']}: analytic {r['analytic']:.6g}"
                  f" FD {r['fd']:.6g} rel {r['rel_err']:.4f}"
                  + (" (gated)" if r["gated"] else " (printed)"))
        del runs, g0
        torch.cuda.empty_cache()

    # the card's gradient against the CPU's on the same uniforms
    summary["cpu"] = {}
    for name in GRAD_SCENES:
        per_dev = []
        rs = np.random.default_rng(11)
        for device in ("cpu", dev):
            scene, ds, params, delta, f, n = setup(name, 32, 4, 6, device)
            if not per_dev:
                n_u = 9 + ds.media.kind.shape[0]
                u_np = (rs.uniform(0, 1, (n, 5)).astype(np.float32),
                        rs.uniform(0, 1, (7, n, n_u)).astype(np.float32))
            un = tuple(torch.from_numpy(x).to(device) for x in u_np)
            levels = []
            bounce_fn = wavefront._bounce

            def recorded(*a, **k):
                out = bounce_fn(*a, **k)
                levels.append((out[3].detach().cpu(), out[5].cpu()))
                return out
            wavefront._bounce = recorded
            try:
                # the spy reads the host at every level: no graph
                with torch.no_grad():
                    lane_L = f(params, delta, uniforms=un, per_lane=True,
                               graph=False)
            finally:
                wavefront._bounce = bounce_fn
            per_dev.append((f, params, delta, un, lane_L.cpu(), levels))
        (fc, pc, dc, uc, Lc, lc), (fg, pg, dg, ug, Lg, lg) = per_dev
        close = lambda a, b: torch.isclose(a, b, rtol=GRAD_LANE_TOL,
                                           atol=GRAD_LANE_TOL)
        agree = close(Lc, Lg).all(-1)
        for (oc, ac), (og, ag) in zip(lc, lg):
            agree &= (ac == ag) & (~ac | close(oc, og).all(-1))
        flipped = 1.0 - float(agree.float().mean())
        check(flipped <= DIEL_MISMATCH_FRAC,
              f"{name}: {flipped} of the lanes differ between CPU and card")
        gc, _ = grads_of(fc, pc, dc, uniforms=uc, mask=agree.float())
        gg, _ = grads_of(fg, pg, dg, uniforms=ug,
                         mask=agree.float().to(dev))
        diffs = {k: rel_diff(gg[k].cpu(), gc[k]) for k in gc}
        summary["cpu"][name] = dict(flipped=flipped, rel=diffs)
        print(f"[27] {name} 32x32 @ 4 spp depth 6, card against CPU on the "
              f"same uniforms: {flipped:.3g} of the lanes flipped, leaf "
              f"differences (against each leaf's largest) "
              + json.dumps({k: float(f"{v:.3g}") for k, v in diffs.items()}))
        check(max(diffs.values()) <= GRAD_CPU_RTOL,
              f"{name}: card gradient off the CPU's by {diffs}")

    # modelExample at its full width, 1 spp: K5 carries the triangle hit
    scene, ds, params, delta, f, n = setup("model_example", GRAD_MESH_WIDTH,
                                           1, GRAD_DEPTH, dev)
    zero_launches()
    gm, stt = grads_of(f, params, delta)
    torch.cuda.synchronize()
    warm = launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gm, stt = grads_of(f, params, delta)
    torch.cuda.synchronize()
    ms8 = (time.perf_counter() - t0) * 1e3
    stt = dict(stt, segments=int(stt["segments"]))
    peak8 = torch.cuda.max_memory_allocated() - base
    k8 = launches()
    for k, v in gm.items():
        check(bool(torch.isfinite(v).all()),
              f"modelExample: the gradient of {k} is not finite")
    check(k8["K5"] == stt["levels"] == GRAD_DEPTH + 1 and k8["K3"] == 0
          and k8["other"] == 0 and warm == k8,
          f"modelExample gradient: K5 not launched once a level {k8}")
    tex = gm["tex_color"]
    kinds = scene.materials.kind
    rows8 = {lbl: int(scene.materials.tex_id[np.where(kinds == kd)[0][0]])
             for lbl, kd in (("ground albedo", 0), ("statue colour", 1),
                             ("sun emission", 3))}
    check(all(float(tex[r].abs().max()) > 0 for r in rows8.values()),
          "modelExample: an albedo or emission leaf has no gradient")
    summary["model_example"] = dict(
        rays=n, fwd_segments=stt["segments"], grad_step_ms=ms8,
        grad_rays_per_s=stt["segments"] / (ms8 / 1e3), peak_bytes=peak8,
        launches=k8, tex_rows={k: tex[r].tolist() for k, r in rows8.items()})
    print(f"[27] modelExample {GRAD_MESH_WIDTH} wide @ 1 spp depth "
          f"{GRAD_DEPTH} on {card}: "
          f"{n} rays, forward segments {stt['segments']}, gradient step "
          f"{ms8:.2f} ms, {stt['segments'] / (ms8 / 1e3):.4g} grad rays/s, "
          f"peak memory {peak8 / 2**30:.3f} GiB, launches {k8}; "
          + json.dumps(summary["model_example"]["tex_rows"]))
    del gm
    torch.cuda.empty_cache()

    # five Adam steps of make_train_step on cornellBox at GRAD.md's scale
    scene, cam = registry.cornell_box()
    cam.width, cam.aspect_ratio, cam.max_depth = GRAD_WIDTH, 1.0, GRAD_DEPTH
    npix = GRAD_WIDTH * GRAD_WIDTH
    train_step, params, opt = pmesh.make_train_step(
        scene, cam, n_rays=npix, n_sample_batches=GRAD_SPP,
        max_depth=GRAD_DEPTH, learning_rate=0.1, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    ids = pmesh.pixel_ids(npix, GRAD_SPP, dev)
    with torch.no_grad():
        ds = trace.to_device(scene, dev)
        target, _ = pmesh.render_batches(
            ds, cam.derived(), GRAD_WIDTH, ids, GRAD_DEPTH,
            cam.max_contribution,
            torch.Generator(device=dev).manual_seed(99))
        light_tex = int(scene.materials.tex_id[
            np.where(scene.materials.kind == 3)[0][0]])
        # the white wall (texture row 1) and the light, perturbed
        params["tex_color"][1] = torch.tensor([0.3, 0.3, 0.3], device=dev)
        params["tex_color"][light_tex] *= 0.4
    losses, train_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(train_step(params, ids, target))
        train_ms.append((time.perf_counter() - t0) * 1e3)
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"train step on cornellBox: the loss did not fall {losses}")
    summary["train"] = dict(losses=losses, step_ms=train_ms,
                            albedo=params["tex_color"][1].tolist(),
                            emission=params["tex_color"][light_tex].tolist())
    print(f"[27] make_train_step on cornellBox {GRAD_WIDTH}x{GRAD_WIDTH}, "
          f"{GRAD_SPP} batches, depth {GRAD_DEPTH}, Adam lr 0.1, on {card}: "
          f"losses {[round(x, 6) for x in losses]}, step ms "
          f"{[round(x, 1) for x in train_ms]}, white-wall albedo "
          f"{summary['train']['albedo']}, emission "
          f"{summary['train']['emission']}")
    return summary

# the multi-device phase (28): a one-rank NCCL group (a rank per GPU, and
# the machine has one card). MULTI_SEED seeds every render of the phase
MULTI_SEED = 7
MULTI_TIMEOUT_S = 300.0
# the flagship's schedules, each held to render_regen bit for bit, and the
# kernels each must launch under render_regen_sharded
MULTI_SCHEDULES = (("queue_ik", {}, ("K1", "K2")),
                   ("direct_rec", dict(direct_rec=True), ("K9", "K2")),
                   ("queue", dict(schedule="queue"), ("K6", "K7")),
                   ("positional", dict(schedule="positional"), ("K8",)),
                   ("reorder", dict(reorder=True), ("K6", "K7p")))
# modelExample cut as phase 26 cuts it, and render_sharded's cut
MULTI_MODEL_SPP, MULTI_WAVEFRONT_SPP = 4, 1
# the sharded train step against the one-device step on the same keyed
# uniforms: losses (relative) and, at every step, each leaf's gradient
# and value against its largest entry
MULTI_LOSS_RTOL = 1e-5
MULTI_TRAIN_STEPS = 3


def multidevice_phase(dev, card):
    """Phase 28: multi-device rendering and training on a one-rank NCCL
    group (`parallel/distributed.initialize` over a file:// rendezvous in
    a temporary directory, destroyed at the end). Returns its summary;
    fails where the group does not form, a sharded render differs from
    `render_regen` in one bit or does not launch its kernels, the sharded
    train step leaves the one-device step's losses or leaves, or
    `render_sharded` gives a non-finite image or segments per path off
    phase 5's gate."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from go_raytracer_tpu_torch.integrator import regen
    from go_raytracer_tpu_torch.ops import trace
    from go_raytracer_tpu_torch.parallel import distributed
    from go_raytracer_tpu_torch.parallel import mesh as pmesh
    from go_raytracer_tpu_torch.scenes import registry

    summary = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        check(distributed.initialize(f"file://{tmp}/rdzv", 1, 0, device=dev,
                                     timeout=MULTI_TIMEOUT_S),
              "distributed.initialize did not form the group")
        try:
            mesh = distributed.global_render_mesh()
            check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1,)
                  and mesh.device_type == "cuda",
                  f"group {dist.get_backend()}, mesh {tuple(mesh.shape)} "
                  f"on {mesh.device_type}")
            print(f"[28] one-rank {dist.get_backend()} group on {card}: "
                  f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}")
            fscene, fcam = registry.cornell_box()

            def both(scene, cam, **kw):
                """render_regen_sharded, then render_regen, same seed:
                (images, stats, launches) of each."""
                out = []
                for sharded in (True, False):
                    zero_launches()
                    if sharded:
                        img, st = regen.render_regen_sharded(
                            scene, cam, mesh, seed=MULTI_SEED, device=dev,
                            **kw)
                    else:
                        img, st = regen.render_regen(
                            scene, cam, seed=MULTI_SEED, device=dev, **kw)
                    out.append((img, st, launch_counts()))
                return out

            rows = {}
            for tag, kw, kernels in MULTI_SCHEDULES:
                (img_s, st_s, l_s), (img_1, st_1, l_1) = both(
                    fscene, fcam, **kw)
                diff = float(np.abs(img_s - img_1).max())
                rows[tag] = dict(
                    equal=bool(np.array_equal(img_s, img_1)), max_diff=diff,
                    segments=st_s["segments"],
                    segments_regen=st_1["segments"],
                    windows=st_s["windows"],
                    loop_s=[st_s["elapsed_s"], st_1["elapsed_s"]],
                    launches={k: l_s[k] for k in kernels},
                    launches_regen={k: l_1[k] for k in kernels},
                    segments_per_shard=st_s["segments_per_shard"])
                print(f"[28] cornellBox flagship 600x600 100spp depth 50 "
                      f"{tag} on {card}: render_regen_sharded vs render_regen"
                      f" (seed {MULTI_SEED}): equal "
                      f"{rows[tag]['equal']} (max diff {diff}), segments "
                      f"{st_s['segments']} / {st_1['segments']}, windows "
                      f"{st_s['windows']}, loop s {st_s['elapsed_s']:.5f} / "
                      f"{st_1['elapsed_s']:.5f}, launches "
                      f"{rows[tag]['launches']} / "
                      f"{rows[tag]['launches_regen']}")
                check(rows[tag]["equal"]
                      and st_s["segments"] == st_1["segments"],
                      f"{tag}: the one-rank sharded render is not "
                      "render_regen's")
                check(all(l_s[k] > 0 for k in kernels),
                      f"{tag}: the sharded render did not launch {kernels}"
                      f" ({l_s})")
                check(st_s["devices"] == 1
                      and st_s["segments_per_shard"] == [st_s["segments"]],
                      f"{tag}: stats {st_s['devices']}, "
                      f"{st_s['segments_per_shard']}")
            # the loop time of both in fresh calls, in turns (the first
            # pair above ran each schedule's first calls: allocations, and
            # the group's first collective)
            for tag, kw, _ in MULTI_SCHEDULES[::2]:
                loops = {"sharded": [], "regen": []}
                for sharded in (False, True, True, False):
                    if sharded:
                        st = regen.render_regen_sharded(
                            fscene, fcam, mesh, seed=MULTI_SEED, device=dev,
                            **kw)[1]
                    else:
                        st = regen.render_regen(fscene, fcam, seed=MULTI_SEED,
                                                device=dev, **kw)[1]
                    loops["sharded" if sharded else "regen"].append(
                        st["elapsed_s"])
                rows[tag]["loops"] = loops
                print(f"[28] {tag} flagship loop s, in turns (regen, sharded,"
                      f" sharded, regen) on {card}: sharded "
                      f"{[round(x, 5) for x in loops['sharded']]}, "
                      f"render_regen {[round(x, 5) for x in loops['regen']]}"
                      f", {rows[tag]['windows']} window(s)")
            # the collectives alone: one window's sum, the final gather
            shard = regen.Shard(0, 1, mesh.get_group(0))
            red = torch.zeros(3, dtype=torch.int64, device=dev)
            acc = torch.zeros((fcam.width * fcam.image_height
                               * fcam.spp_sqrt ** 2, 3),
                              dtype=torch.float32, device=dev)
            coll = dict(
                sum_ms=time_ms(lambda: dist.all_reduce(
                    red, group=shard.group), 100),
                sum_host_us=host_us(lambda: dist.all_reduce(
                    red, group=shard.group)),
                gather_ms=time_ms(lambda: shard.gather(acc), 3),
                gather_bytes=acc.numel() * 4)
            del acc
            torch.cuda.empty_cache()
            rows["collectives"] = coll
            print(f"[28] collectives on {card}: one window's sum (3 int64, "
                  f"NCCL all_reduce) {coll['sum_ms']:.5f} ms, host "
                  f"{coll['sum_host_us']:.1f} us; the accumulator's gather "
                  f"({coll['gather_bytes']} B) {coll['gather_ms']:.4f} ms")

            # modelExample, cut in spp as phase 26 cuts it
            mscene, mcam = registry.model_example()
            mcam.samples_per_pixel = MULTI_MODEL_SPP
            (img_s, st_s, l_s), (img_1, st_1, l_1) = both(mscene, mcam)
            rows["model_example"] = dict(
                equal=bool(np.array_equal(img_s, img_1)),
                max_diff=float(np.abs(img_s - img_1).max()),
                segments=[st_s["segments"], st_1["segments"]],
                loop_s=[st_s["elapsed_s"], st_1["elapsed_s"]],
                launches={k: l_s[k] for k in ("K5", "K3", "cap", "K2")})
            print(f"[28] modelExample 600x337 @ {MULTI_MODEL_SPP} spp "
                  f"(route {st_s['mesh']['route']}) on {card}: sharded vs "
                  f"render_regen: " + json.dumps(rows["model_example"]))
            check(rows["model_example"]["equal"]
                  and st_s["segments"] == st_1["segments"]
                  and np.isfinite(img_s).all(),
                  "modelExample: the one-rank sharded render is not "
                  "render_regen's")
            check(all(v > 0 for v in rows["model_example"]["launches"]
                      .values()),
                  f"modelExample: kernels not launched {l_s}")

            # the sharded train step against the one-device step
            scene, cam = registry.cornell_box()
            cam.width, cam.aspect_ratio = GRAD_WIDTH, 1.0
            cam.max_depth = GRAD_DEPTH
            npix = GRAD_WIDTH * GRAD_WIDTH
            ids = pmesh.pixel_ids(npix, GRAD_SPP, dev)
            with torch.no_grad():
                target, _ = pmesh.render_batches(
                    trace.to_device(scene, dev), cam.derived(), GRAD_WIDTH,
                    ids, GRAD_DEPTH, cam.max_contribution,
                    torch.Generator(device=dev).manual_seed(99))
            light = int(scene.materials.tex_id[
                np.where(scene.materials.kind == 3)[0][0]])
            runs = {}
            train_mesh = pmesh.make_mesh(1)
            for tag, m in (("one_device", None), ("sharded", train_mesh)):
                step, params, _ = pmesh.make_train_step(
                    scene, cam, n_rays=npix, n_sample_batches=GRAD_SPP,
                    max_depth=GRAD_DEPTH, learning_rate=0.1, device=dev,
                    generator=pmesh.KeyedUniforms(1), mesh=m)
                with torch.no_grad():
                    params["tex_color"][1] = torch.tensor([0.3, 0.3, 0.3],
                                                          device=dev)
                    params["tex_color"][light] *= 0.4
                losses, grads, ms = [], [], []
                for _ in range(MULTI_TRAIN_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses.append(step(params, ids, target))
                    ms.append((time.perf_counter() - t0) * 1e3)
                    grads.append({k: p.grad.clone() for k, p in
                                  params.items()})
                runs[tag] = (losses, grads, params, ms)

            def rel(a, b):
                scale = float(b.abs().max())
                return float((a - b).abs().max()) / scale if scale > 0 \
                    else float((a - b).abs().max())

            (l1, g1, p1, ms1), (ls_, gs, ps, mss) = runs["one_device"], \
                runs["sharded"]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ls_, l1))
            grad_rel = max(rel(a[k], b[k]) for a, b in zip(gs, g1)
                           for k in b)
            leaf_rel = max(rel(ps[k].detach(), p1[k].detach()) for k in p1)
            rows["train"] = dict(losses=ls_, losses_one_device=l1,
                                 loss_rel=loss_rel, grad_rel=grad_rel,
                                 leaf_rel=leaf_rel, step_ms=mss,
                                 step_ms_one_device=ms1)
            print(f"[28] sharded make_train_step (1 x 1 mesh) vs the "
                  f"one-device step, cornellBox {GRAD_WIDTH}x{GRAD_WIDTH}, "
                  f"{GRAD_SPP} batches, depth {GRAD_DEPTH}, KeyedUniforms(1),"
                  f" {MULTI_TRAIN_STEPS} Adam steps on {card}: losses "
                  f"{[round(x, 7) for x in ls_]} / "
                  f"{[round(x, 7) for x in l1]} (rel {loss_rel:.3g}), "
                  f"gradients {grad_rel:.3g}, leaves {leaf_rel:.3g} of their"
                  f" largest; step ms {[round(x, 1) for x in mss]} / "
                  f"{[round(x, 1) for x in ms1]}")
            check(np.isfinite(ls_).all() and loss_rel <= MULTI_LOSS_RTOL
                  and grad_rel <= GRAD_RUN_TO_RUN
                  and leaf_rel <= GRAD_RUN_TO_RUN,
                  f"sharded train step off the one-device step: "
                  f"{rows['train']}")
            del runs, g1, gs, p1, ps
            torch.cuda.empty_cache()

            # render_sharded on cornellBox, cut in spp
            wcam = registry.cornell_box()[1]
            wcam.samples_per_pixel = MULTI_WAVEFRONT_SPP
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, st = pmesh.render_sharded(fscene, wcam, mesh,
                                           seed=MULTI_SEED, device=dev)
            wall = time.perf_counter() - t0
            npx = wcam.width * wcam.image_height
            ratio = st["segments"] / npx
            rows["render_sharded"] = dict(
                segments=st["segments"], per_path=ratio, wall_s=wall,
                means=img.reshape(-1, 3).mean(0).tolist(),
                launches=sum(launch_counts().values()))
            print(f"[28] render_sharded cornellBox 600x600 @ "
                  f"{MULTI_WAVEFRONT_SPP} spp depth 50 (the reference "
                  f"engine, backend xla, mode while) on {card}: "
                  + json.dumps(rows["render_sharded"]))
            check(np.isfinite(img).all() and 2.78 <= ratio <= 3.08,
                  f"render_sharded: {rows['render_sharded']}")
        finally:
            dist.destroy_process_group()
    summary.update(rows)
    return summary


# the lane coherence sort's phase (29): the three flagships it is measured
# on (PERF.md §4), each at its registry configuration, and the cell of
# scripts/ab_reorder.py (book1 and book2 at 25 spp, cadence 4)
REORDER_SCENES = ("cornell_box", "book1", "book2")
REORDER_LANES = 1 << 17
REORDER_AB_SPP, REORDER_AB_CADENCE = 25, 4

# What phase 29 (b) times beside K7's unwinding entry, built from the
# checkout's csrc/harvest_rows.cu: the entry's cooperative grid and
# barriers with the work removed (its barrier share), and the entry with L
# in three float planes in place of one float4 a lane (its scatter then
# touches three sectors a lane, not one).
K7P_PROBE_CU = r"""
#include "%s"

__global__ void __launch_bounds__(BLOCK) barriers_only(int outer) {
  cg::grid_group grid = cg::this_grid();
  for (int r = outer - 1; r > 0; --r) grid.sync();
}

__global__ void __launch_bounds__(BLOCK) harvest_rows_perm_planes(
    HarvestRowsArgs a) {
  __shared__ int warp_starts[2][NWARP];
  cg::grid_group grid = cg::this_grid();
  const int tiles = a.n / BLOCK;
  const int first = blockIdx.x;
  const size_t n = a.n;
  RowIn w = row_in(a, a.outer - 1, first);
  int k = 0;
  for (int r = a.outer - 1; r >= 0; --r) {
    const float* cur = (const float*)a.state + (size_t)(r & 1) * 3 * n;
    float* prev = (float*)a.state + (size_t)((r + 1) & 1) * 3 * n;
    for (int tile = first; tile < tiles; tile += gridDim.x, ++k) {
      const int i = tile * BLOCK + threadIdx.x;
      if (tile != first) w = row_in(a, r, tile);
      float lr = 0.0f, lg = 0.0f, lb = 0.0f;
      if (r < a.outer - 1) {
        lr = __ldcg(cur + i);
        lg = __ldcg(cur + n + i);
        lb = __ldcg(cur + 2 * n + i);
      }
      level_step(a, w.last, lr, lg, lb);
      for (int j = a.cadence - 2; j >= 0; --j)
        level_step(a, load_level(a, ((size_t)r * a.cadence + j) * a.n + i),
                   lr, lg, lb);
      if (r < a.refill_outer) {
        const int rank = tile_rank(w.started, warp_starts[k & 1]);
        if (w.started) write_start(a, w.slot0 + rank, lr, lg, lb);
      }
      if (r > 0) {
        __stcg(prev + w.perm, lr);
        __stcg(prev + n + w.perm, lg);
        __stcg(prev + 2 * n + w.perm, lb);
      }
    }
    if (r > 0) {
      w = row_in(a, r - 1, first);
      grid.sync();
    }
  }
}

extern "C" int grt_probe_barriers(const HarvestRowsArgs* args,
                                  void* stream) {
  int blocks;
  const int err = perm_grid(args->n, &blocks);
  if (err) return err;
  int outer = args->outer;
  void* params[] = {&outer};
  return (int)cudaLaunchCooperativeKernel((const void*)barriers_only,
                                          dim3(blocks), dim3(BLOCK), params,
                                          0, (cudaStream_t)stream);
}

extern "C" int grt_probe_perm_planes(const HarvestRowsArgs* args,
                                     void* stream) {
  HarvestRowsArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  int blocks;
  int err = perm_grid(a.n, &blocks);
  if (!err) err = rank_rows(a, s);
  if (err) return err;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)harvest_rows_perm_planes, dim3(blocks), dim3(BLOCK),
      params, 0, s);
}
"""


def k7p_probe_build():
    """Start `nvcc` on K7P_PROBE_CU into build/k7p_probe/; returns what
    k7p_probe_load waits for."""
    from go_raytracer_tpu_torch.ops import _cuda

    out = os.path.join(os.path.dirname(_cuda.BUILD_DIR), "k7p_probe")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "probe.cu")
    with open(src, "w") as fh:
        fh.write(K7P_PROBE_CU % os.path.join(_cuda._CSRC, "harvest_rows.cu"))
    so, log = os.path.join(out, "probe.so"), os.path.join(out, "probe.log")
    with open(log, "w") as fh:
        proc = subprocess.Popen([_cuda._nvcc(), *_cuda.FLAGS, "-o", so, src],
                                stdout=fh, stderr=subprocess.STDOUT)
    return proc, so, log


def k7p_probe_load(build):
    """The probe library of k7p_probe_build, once built; fails with the
    compiler's output if it does not build."""
    import ctypes

    proc, so, log = build
    if proc.wait() != 0:
        with open(log) as fh:
            fail(f"the unwinding entry's probe does not build:\n{fh.read()}")
    lib = ctypes.CDLL(so)
    for name in ("grt_probe_barriers", "grt_probe_perm_planes"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def k7p_entry(fn):
    """`harvest.reverse_harvest_into(perms=)` launches `fn` (a probe
    entry, given the entry's arguments) in place of the unwinding entry."""
    import types

    from go_raytracer_tpu_torch.ops import _cuda

    library = _cuda.library
    _cuda.library = lambda name: types.SimpleNamespace(
        grt_harvest_rows_perm=fn)
    try:
        yield
    finally:
        _cuda.library = library


def reorder_scene_args(dev, sc):
    """Flagship `sc` on the card, as the sorted `queue` schedule takes it:
    (scene, camera, packed tables, statics, camera row, background, the
    coherence sort's Morton box)."""
    import numpy as np
    import torch

    from go_raytracer_tpu_torch.ops import bounce
    from go_raytracer_tpu_torch.scenes import registry

    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    scene, cam = getattr(registry, sc)()
    return (scene, cam, tuple(to(t) for t in bounce.pack_scene(scene)),
            bounce.scene_statics(scene), to(bounce.pack_camera(cam.derived())),
            to(np.asarray(scene.background, np.float32)),
            tuple(to(b) for b in bounce.coherence_bounds(scene)))


def sorted_window(dev, sc, n):
    """The first sorted `queue` window of flagship `sc` at `n` lanes,
    recorded on the card through `regen._queue_window(reorder=)`. Returns
    its records ((outer, cadence, n) each), buffers (STs, NIs, perms), the
    harvest's keywords, its levels, outer and refill rows, the paths it
    started and their segments, the launches it made and the acc that its
    unwinding entry wrote (NaN past the last started item)."""
    import torch

    from go_raytracer_tpu_torch.integrator import regen

    _, cam, tables, statics, cam_row, bg, bounds = reorder_scene_args(dev, sc)
    cad, sq = cam.regen_cadence, cam.spp_sqrt
    npix = cam.width * cam.image_height
    total = npix * sq * sq
    d1 = cam.max_depth + 1
    refill_l = 4 * d1
    window = -(-(refill_l + d1) // cad) * cad
    outer, rows = window // cad, -(-refill_l // cad)
    bufs = regen.SchedBuffers.empty(n, outer, cad, dev, rows, reorder=True)
    acc = torch.full((total + n, 3), float("nan"), dtype=torch.float32,
                     device=dev)
    zero_launches()
    _, _, cur = regen._queue_window(
        tables, statics, cam_row, bg, acc, regen._init_state(n, dev),
        torch.tensor(0, device=dev), regen.window_seeds(0, 0, outer).to(dev),
        0, total, bufs=bufs, reorder=bounds, width=cam.width, npix=npix,
        sqrt_spp=sq, window=window, refill=refill_l, cadence=cad,
        max_depth=cam.max_depth, max_contribution=cam.max_contribution,
        has_defocus=cam.defocus_angle > 0)
    torch.cuda.synchronize()
    launches = launch_counts()
    paths, segments, _ = (int(x) for x in cur.tolist())
    return dict(rec=[r.view(outer, cad, n) for r in bufs.rec], bufs=bufs,
                acc=acc, hkw=dict(cadence=cad, refill_outer=rows,
                                  max_contribution=cam.max_contribution),
                levels=window, outer=outer, rows=rows, paths=paths,
                segments=segments, launches=launches)


def reorder_phase(dev, card):
    """Phase 29: the lane coherence sort (`render_regen(reorder=True)`, the
    `queue` schedule with `coherence_sort` before every K6 call and K7's
    unwinding entry). Returns its summary, with the `kernels` line's
    figures of the unwinding entry under "k7p"; fails where the sort's
    permutation on the card is not the CPU's, the unwinding entry differs
    from its plain version (or, with identity perms, from K7) in one bit,
    or a sorted flagship misses a gate or does not launch K6 and the
    unwinding entry."""
    import numpy as np
    import torch

    from go_raytracer_tpu_torch.integrator import regen
    from go_raytracer_tpu_torch.ops import _cuda, bounce, harvest
    from go_raytracer_tpu_torch.scenes import registry

    n = REORDER_LANES
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    summary = {"card": card}
    probe_build = k7p_probe_build()

    # (a) the permutation, card against CPU, on aged pools; the sort's
    # launches, host and device time a call; K6 on the pool as it lies and
    # sorted (the same rays)
    pools = {}
    for sc in REORDER_SCENES:
        scene, cam, tables, statics, cam_row, bg, bounds = \
            reorder_scene_args(dev, sc)
        cad, sq = cam.regen_cadence, cam.spp_sqrt
        npix = cam.width * cam.image_height
        fkw = dict(has_defocus=cam.defocus_angle > 0, max_depth=cam.max_depth,
                   n_inner=cad)
        nxt = [npix // 2]

        def refill(st_):
            r_ = regen.queue_refill_planes(
                torch.tensor(nxt[0], device=dev), st_[7], npix * sq * sq,
                width=cam.width, npix=npix, sqrt_spp=sq)
            nxt[0] += int(r_[0].sum())
            return r_

        seed = torch.tensor([-987654321], dtype=torch.int32, device=dev)
        o6 = bounce.FusedOut.empty(n, cad, dev)
        pool = aged_state(lambda st_: bounce.bounce_fused(
            tables, statics, cam_row, bg, seed, *st_, *refill(st_), out=o6,
            **fkw)[3:], regen._init_state(n, dev))
        sorted_k = regen._init_state(n, dev)
        perm_k = torch.empty(n, dtype=torch.int32, device=dev)
        regen.coherence_sort(pool, *bounds, sorted_k, perm_k)
        cpu = torch.device("cpu")
        sorted_c = regen._init_state(n, cpu)
        perm_c = torch.empty(n, dtype=torch.int32)
        regen.coherence_sort([x.cpu() for x in pool],
                             *(b.cpu() for b in bounds), sorted_c, perm_c)
        torch.cuda.synchronize()
        same = torch.equal(perm_k.cpu(), perm_c) and all(
            torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
            for a, b in zip(sorted_k, sorted_c))
        sort_ms = time_ms(lambda: regen.coherence_sort(
            pool, *bounds, sorted_k, perm_k), 20)
        sort_host = host_us(lambda: regen.coherence_sort(
            pool, *bounds, sorted_k, perm_k))
        # the device time and launches a call from the profiler: queued
        # behind a spin (queued_device_ms), the sort's 61 launches a call
        # fill the launch queue and the host waits
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(10):
                regen.coherence_sort(pool, *bounds, sorted_k, perm_k)
            torch.cuda.synchronize()
        dev_events = [e for e in prof.key_averages()
                      if "CUDA" in str(getattr(e, "device_type", ""))
                      and getattr(e, "self_device_time_total", getattr(
                          e, "self_cuda_time_total", 0.0)) > 0]
        sort_launches = sum(e.count for e in dev_events) / 10
        sort_dev = sum(device_times(prof).values()) / 10 / 1e3 \
            if dev_events else None
        # K6 on the same rays as they lie and sorted, fresh outputs so
        # that every call sees the same inputs
        k6_dev = {}
        for tag, st_ in (("as_they_lie", pool), ("sorted", sorted_k)):
            nxt[0] = npix // 2
            r_ = refill(st_)
            o_ = bounce.FusedOut.empty(n, cad, dev)
            k6_dev[tag] = queued_device_ms(lambda: bounce.bounce_fused(
                tables, statics, cam_row, bg, seed, *st_, *r_, out=o_,
                **fkw))
        alive = int((pool[7] != 0).sum())
        pools[sc] = dict(equal=same, alive=alive, sort_ms=sort_ms,
                         sort_host_us=sort_host, sort_device_ms=sort_dev,
                         sort_launches=sort_launches, k6_device_ms=k6_dev)
        print(f"[29] (a) {sc}: coherence_sort on an aged {n}-lane pool "
              f"({alive} alive, cadence {cad}), card vs CPU: permutation "
              f"and planes equal {same}; the sort {sort_ms:.4f} ms a call, "
              f"host {sort_host:.1f} us, device {sort_dev} ms, "
              f"{sort_launches:g} launches; K6 device ms on these rays as "
              f"they lie {k6_dev['as_they_lie']} / sorted "
              f"{k6_dev['sorted']} on {card}")
        check(same, f"{sc}: the sort's permutation on the card is not the "
              "CPU's")
        del pool, sorted_k, sorted_c, o6
    summary["sort"] = pools

    # (b) the unwinding entry on a recorded sorted window of each flagship
    # with its real perms, against its plain version and, with identity
    # perms, K7; timed beside K7 on the same records, in turns, and beside
    # its own grid's barriers alone and its three-plane variant
    t_b = time.perf_counter()
    probe = k7p_probe_load(probe_build)
    regs = [ln for ln in _cuda.ptxas_report("harvest_rows")
            if ln.startswith("harvest_rows_perm:")]
    nan = float("nan")
    wins = {}
    for sc in REORDER_SCENES:
        w = sorted_window(dev, sc, n)
        rec, bufs, hkw, q_next = w["rec"], w["bufs"], w["hkw"], w["paths"]
        lw, outer, rows = w["launches"], w["outer"], w["rows"]
        check(lw["K6"] == outer and lw["K7p"] == 1 and lw["K7"] == 0,
              f"{sc}: the sorted window did not launch K6 a call and the "
              f"unwinding entry once: {lw}")
        acc_k = w["acc"]
        acc_p = torch.full_like(acc_k, nan)

        def run_plain():
            r_ = harvest.reverse_harvest_ref(*rec, bufs.sts, perms=bufs.perm,
                                             **hkw)
            harvest.write_rows_ref(acc_p, r_, bufs.nis, item_base=0,
                                   n_rows=rows)

        plain_ms = time_ms(run_plain, 1, warmup=0)
        check(not torch.isnan(acc_k[:q_next]).any()
              and bool(torch.isnan(acc_k[q_next:]).all()),
              f"{sc}: the unwinding entry missed a started item or wrote "
              "past them")
        err = (acc_k[:q_next] - acc_p[:q_next]).abs().max().item()
        equal = torch.equal(acc_k[:q_next], acc_p[:q_next])
        accs = {tag: torch.full_like(acc_k, nan)
                for tag in ("entry", "k7", "planes", "ident")}

        def call(tag, perms):
            return lambda: harvest.reverse_harvest_into(
                accs[tag], *rec, bufs.sts, bufs.nis, item_base=0,
                perms=perms, **hkw)

        ms = {"entry": [], "k7": []}
        for tag in ("entry", "k7", "k7", "entry"):
            ms[tag].append(time_ms(call(tag, None if tag == "k7"
                                        else bufs.perm), 10))
        check(torch.equal(accs["entry"][:q_next], acc_k[:q_next]),
              f"{sc}: the unwinding entry's timing run differs from the "
              "window's")
        with k7p_entry(probe.grt_probe_barriers):
            barrier_ms = time_ms(call("planes", bufs.perm), 10)
        with k7p_entry(probe.grt_probe_perm_planes):
            planes_ms = time_ms(call("planes", bufs.perm), 10)
        planes_equal = torch.equal(accs["planes"][:q_next], acc_k[:q_next])
        ident = torch.arange(n, dtype=torch.int32, device=dev).repeat(
            outer, 1)
        call("ident", ident)()
        torch.cuda.synchronize()
        ident_equal = torch.equal(accs["ident"][:q_next],
                                  accs["k7"][:q_next])
        # K7's bytes (16 a lane a level, 4 a lane a refill row, 12 a path,
        # the row bases) plus the perm rows the entry reads (rows
        # 1..outer-1); its state buffers are the design's traffic, not a
        # byte the harvest needs
        nbytes = w["levels"] * n * 16 + rows * n * 4 + q_next * 12 \
            + rows * 4 + (outer - 1) * n * 4
        entry_ms = min(ms["entry"])
        wins[sc] = dict(
            levels=w["levels"], outer=outer, rows=rows, paths=q_next,
            segments=w["segments"], equal=equal, max_abs_err=err,
            identity_equals_k7=ident_equal, ms=ms["entry"], k7_ms=ms["k7"],
            plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bytes=nbytes, barriers_ms=barrier_ms,
            barrier_share=barrier_ms / entry_ms, planes_ms=planes_ms,
            planes_equal=planes_equal)
        print(f"[29] (b) {sc} sorted queue window ({w['levels']} levels, "
              f"{outer} outer rows, {rows} refill rows, {n} lanes, {q_next} "
              f"paths): the unwinding entry vs its plain version equal "
              f"{equal} (max abs err {err}); with identity perms equal to "
              f"K7 {ident_equal}; ms a window, in turns, entry / K7 "
              f"{ms['entry'][0]:.4f} / {ms['k7'][0]:.4f}, "
              f"{ms['k7'][1]:.4f} / {ms['entry'][1]:.4f}; its {outer - 1} "
              f"barriers alone {barrier_ms:.4f} (share "
              f"{barrier_ms / entry_ms:.3f}); L in three planes "
              f"{planes_ms:.4f} (equal {planes_equal}); plain "
              f"{plain_ms:.2f}, bound {wins[sc]['bound_ms']:.4f} (bytes, "
              f"{nbytes} B); {regs} on {card}")
        check(equal and err == 0.0,
              f"{sc}: the unwinding entry differs from its plain version")
        check(ident_equal,
              f"{sc}: the unwinding entry with identity perms is not K7")
        check(planes_equal, f"{sc}: the three-plane probe differs from the "
              "unwinding entry")
        del w, rec, bufs, acc_k, acc_p, accs, ident
        torch.cuda.empty_cache()
    summary["k7p_windows"] = wins
    print(f"[29] (b) took {time.perf_counter() - t_b:.1f} s")

    # (c) the flagships sorted and unsorted: gates, launches, loops in
    # turns (unsorted, sorted, sorted, unsorted)
    flags = {}
    for sc in REORDER_SCENES:
        scene, cam = getattr(registry, sc)()
        runs = {False: [], True: []}
        for reorder in (False, True, True, False):
            zero_launches()
            img, st = regen.render_regen(scene, cam, seed=0, n_lanes=n,
                                         schedule="queue", reorder=reorder,
                                         device=dev)
            runs[reorder].append((img, st, launch_counts()))
        (img_u, st_u, l_u), (img_s, st_s, l_s) = runs[False][0], \
            runs[True][0]
        means_u = img_u.reshape(-1, 3).mean(0)
        means_s = img_s.reshape(-1, 3).mean(0)
        npath = cam.width * cam.image_height * cam.spp_sqrt ** 2
        ratio = st_s["segments"] / st_s["paths"]
        flags[sc] = dict(
            paths=st_s["paths"], segments=st_s["segments"],
            segments_unsorted=st_u["segments"], per_path=ratio,
            regen_len=cam.regen_len, windows=st_s["windows"],
            nonfinite=st_s["nonfinite"], means=means_s.tolist(),
            means_unsorted=means_u.tolist(),
            loop_s={"unsorted": [r[1]["elapsed_s"] for r in runs[False]],
                    "sorted": [r[1]["elapsed_s"] for r in runs[True]]},
            launches={k: l_s[k] for k in ("K6", "K7", "K7p", "K1")},
            launches_unsorted={k: l_u[k] for k in ("K6", "K7", "K7p")})
        print(f"[29] (c) {sc} {cam.width}x{cam.image_height} "
              f"{cam.samples_per_pixel} spp depth {cam.max_depth} cadence "
              f"{cam.regen_cadence}, {n} lanes, `queue` with reorder=True on "
              f"{card}: " + json.dumps(flags[sc]))
        check(st_s["schedule"] == "queue" and st_s["reorder"] is True,
              f"{sc}: stats {st_s['schedule']}, reorder {st_s.get('reorder')}")
        check(st_s["paths"] == npath, f"{sc}: paths {st_s['paths']}")
        check(st_s["nonfinite"] <= TEX_NONFINITE_MAX,
              f"{sc}: {st_s['nonfinite']} non-finite pixel values")
        check(abs(ratio / cam.regen_len - 1.0) <= 0.05,
              f"{sc}: segments/path {ratio} off regen_len {cam.regen_len}")
        check(np.abs(means_s - means_u).max() <= 1e-2,
              f"{sc}: channel means {means_s} vs unsorted {means_u}")
        check(l_s["K6"] > 0 and l_s["K7p"] == st_s["windows"]
              and l_s["K7"] == 0 and l_s["K1"] == 0,
              f"{sc}: the sorted render did not run K6 and the unwinding "
              f"entry alone ({l_s})")
        del runs, img_u, img_s
    summary["flagships"] = flags

    # scripts/ab_reorder.py's cell: book1 and book2 at 25 spp, cadence 4,
    # JAX's two arms (queue_ik unsorted, queue sorted) and queue unsorted
    ab = {}
    for sc in ("book1", "book2"):
        scene, cam = getattr(registry, sc)()
        cam.samples_per_pixel = REORDER_AB_SPP
        for tag, kw in (("queue_ik", {}), ("queue", dict(schedule="queue")),
                        ("queue_sorted", dict(reorder=True))):
            st = regen.render_regen(scene, cam, seed=0, n_lanes=n,
                                    cadence=REORDER_AB_CADENCE, device=dev,
                                    **kw)[1]
            ab[f"{sc}/{tag}"] = dict(
                loop_s=st["elapsed_s"], rays_per_s=st["rays_per_s"],
                segments=st["segments"], windows=st["windows"],
                occupancy=st["occupancy"])
    summary["ab_cell"] = ab
    print(f"[29] ab_reorder cell ({REORDER_AB_SPP} spp, cadence "
          f"{REORDER_AB_CADENCE}, one render an arm) on {card}: "
          + json.dumps(ab))

    b1 = wins["book1"]
    summary["k7p"] = dict(
        launches=sum(f["launches"]["K7p"] for f in flags.values()),
        launches_per_render={sc: f["launches"]["K7p"]
                             for sc, f in flags.items()},
        max_abs_err=max(v["max_abs_err"] for v in wins.values()),
        ms=min(b1["ms"]), plain_ms=b1["plain_ms"], bound_ms=b1["bound_ms"],
        k7_ms_same_records=min(b1["k7_ms"]), registers=regs,
        windows={sc: {k: v[k] for k in (
            "ms", "k7_ms", "bound_ms", "plain_ms", "barriers_ms",
            "barrier_share", "planes_ms")} for sc, v in wins.items()})
    return summary


# the runtime calls that put work on the card, as torch.profiler names them
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                    "cuGraphLaunch", "cudaMemcpyAsync", "cuMemcpyAsync",
                    "cudaMemsetAsync", "cuMemsetD")


def window_costs(run, levels):
    """Per level of the window `run()` runs (`levels()`: the levels it ran
    last): wall ms (host clock between two synchronizes, the least of
    three runs), calls that wait on the device (torch.cuda's sync debug
    mode, with the five source lines that make the most), and under
    torch.profiler the host-issued launches (runtime calls of
    HOST_LAUNCH_APIS: kernels, graph launches, copies, fills) and the
    device launches (kernels and copies on the card, a graph's nodes
    included)."""
    import collections
    import traceback
    import warnings

    import torch
    from torch.autograd import DeviceType

    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / levels())
    sites = collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            # the innermost frames of this repository that led to the wait
            own = [f"{os.path.basename(f.filename)}:{f.lineno}"
                   for f in traceback.extract_stack()[:-1]
                   if "go_raytracer_tpu_torch" in f.filename
                   or f.filename.endswith("chip_smoke.py")]
            sites[" < ".join([f"{os.path.basename(filename)}:{lineno}"]
                             + own[::-1][:3])] += 1

    # the switch into the debug mode is itself reported as a wait: it is
    # made before the warnings are gathered
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    waits = sum(sites.values()) / levels()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    host = collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CPU
        and e.name.startswith(HOST_LAUNCH_APIS))
    device = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return dict(wall_ms=min(walls), walls_ms=walls, waits=waits,
                wait_sites=[f"{k} {v}" for k, v in sites.most_common(5)],
                host_launches=sum(host.values()) / levels(),
                host_apis=dict(host), device_launches=device / levels(),
                levels=levels())


def mesh_window_phase(dev, card, main_launches):
    """Phase 30: the mesh window as one device program. On one real scene-8
    window (255 levels, refill 204, 131,072 lanes): (a) the glue kernel
    (`ops/mesh_level`: `refill`, `record`) against its plain version at
    every level, bit for bit, and both entries timed on a real level with
    their bytes bound; (b) the window replayed as a CUDA graph against the
    same window run eagerly on the plain glue, from the same state, seed
    and cursor, on the walk and on binned2: records, bases, accumulator,
    cursor, segments and levels bit for bit; (c) the graphed window and
    the eager one (the glue kernel, no graph) on the walk: per level the
    host-issued launches, the calls that wait on the device (at most one a
    window in the graphed one) and the wall ms. `main_launches`: the
    glue's launches on phase 10's main path.
    Returns the `kernels` line's entry of the glue kernel."""
    import dataclasses

    import numpy as np
    import torch

    from go_raytracer_tpu_torch.integrator import regen
    from go_raytracer_tpu_torch.ops import _cuda, mesh_level
    from go_raytracer_tpu_torch.scenes import registry

    scene, cam = registry.model_example()
    n = regen.MESH_MAX_LANES
    npix = cam.width * cam.image_height
    total = npix * cam.spp_sqrt ** 2
    d1 = cam.max_depth + 1
    window, refill = 5 * d1, 4 * d1
    geo = dict(width=cam.width, npix=npix, sqrt_spp=cam.spp_sqrt,
               window=window, refill=refill, max_depth=cam.max_depth,
               max_contribution=cam.max_contribution)

    def fresh(ctx, seed=0, bufs=None, sync=True):
        bufs = bufs or regen.WindowBuffers.empty(n, window, 1, dev)
        for r in bufs.rec:
            r.zero_()
        acc = torch.zeros((total + n, 3), dtype=torch.float32, device=dev)
        st, cur, n_run = regen._mesh_window(
            ctx, acc, regen._init_state_mesh(n, dev), 0,
            regen.window_generator(seed, 0, dev), total, bufs=bufs, **geo)
        if sync:
            torch.cuda.synchronize()
        return bufs, acc, cur, n_run

    def tensors(lv):
        return [getattr(lv, f.name) for f in dataclasses.fields(lv)]

    def clone_level(lv):
        return dataclasses.replace(lv, **{f.name: getattr(lv, f.name).clone()
                                          for f in dataclasses.fields(lv)})

    as_bits = lambda x: x.view(torch.int32) if x.is_floating_point() else x

    # (a) the glue kernel against its plain version at every level
    ctx = regen.MeshContext.build(scene, cam, dev, mesh="walk")
    ctx.graph = False
    real = dict(refill=mesh_level.refill, record=mesh_level.record)
    diffs = dict(refill=0, record=0, levels=0)
    err = [0.0]
    snap = {}

    def compare(name, mine, theirs):
        for a, b in zip(mine, theirs):
            if not torch.equal(as_bits(a), as_bits(b)):
                diffs[name] += 1
                if a.is_floating_point():
                    err[0] = max(err[0], float(
                        (a - b).abs().nan_to_num(float("inf")).max()))

    def refill_chk(lv, arrays, cam_row, base, **kw):
        lp, bp = clone_level(lv), base.clone()
        if int(lv.lvl[0]) == 5:
            snap["refill"] = (clone_level(lv), base.clone(), kw)
        real["refill"](lv, arrays, cam_row, base, **kw)
        mesh_level.refill_ref(lp, arrays, cam_row, bp, **kw)
        compare("refill", lv.state + [lv.start, lv.cnt, lv.lvl, base],
                lp.state + [lp.start, lp.cnt, lp.lvl, bp])
        diffs["levels"] += 1

    def record_chk(lv, rec, *res, max_depth):
        lp, rp = clone_level(lv), [r.clone() for r in rec]
        if int(lv.lvl[0]) == 6:
            snap["record"] = (clone_level(lv), rp, [x.clone() for x in res])
        real["record"](lv, rec, *res, max_depth=max_depth)
        mesh_level.record_ref(lp, rp, *res, max_depth=max_depth)
        compare("record", lv.state + [lv.cnt] + list(rec),
                lp.state + [lp.cnt] + rp)

    mesh_level.refill, mesh_level.record = refill_chk, record_chk
    try:
        _, _, cur_a, run_a = fresh(ctx)
    finally:
        mesh_level.refill, mesh_level.record = real["refill"], real["record"]
    print(f"[30] (a) one scene-8 window ({window} levels, refill {refill}, "
          f"{n} lanes; {run_a} levels run, [next item, segments, levels "
          f"recorded] {cur_a.tolist()}): the glue kernel against its plain "
          f"version at each of its {diffs['levels']} levels: refill "
          f"{diffs['refill']}, record {diffs['record']} differing tensors, "
          f"max abs err {err[0]}")
    check(diffs["levels"] == run_a > refill and diffs["refill"] == 0
          and diffs["record"] == 0,
          "the mesh level's glue kernel differs from its plain version")

    # both entries timed on a real level (level 5's refill and record),
    # each call on the snapshot's state: the device time of the entry's
    # kernels under torch.profiler (CUDA events round one launch would
    # hold the wrapper's host time)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def timed(fn, restore, names, reps=20):
        restore()
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                restore()
                fn()
            torch.cuda.synchronize()
        us = sum(v for k, v in device_times(prof).items()
                 if kernel_of(k, names))
        return us / 1e3 / reps

    lv0, base0, kw0 = snap["refill"]
    lv_r, base_r = clone_level(lv0), base0.clone()

    def restore_refill():
        for a, b in zip(tensors(lv_r), tensors(lv0)):
            a.copy_(b)

    refill_ms = timed(lambda: real["refill"](lv_r, ctx.arrays, ctx.cam_row,
                                             base_r, **kw0), restore_refill,
                      ("mesh_count", "mesh_refill"))
    lv1, rec1, res1 = snap["record"]
    lv_c, rec_c = clone_level(lv1), [r.clone() for r in rec1]

    def restore_record():
        for a, b in zip(tensors(lv_c), tensors(lv1)):
            a.copy_(b)

    record_ms = timed(lambda: real["record"](
        lv_c, rec_c, *res1, max_depth=cam.max_depth), restore_record,
                      ("mesh_record",))

    def plain_ms(fn, restore, reps=5):
        best = float("inf")
        for _ in range(reps):
            restore()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    refill_plain = plain_ms(lambda: mesh_level.refill_ref(
        lv_r, ctx.arrays, ctx.cam_row, base_r, **kw0), restore_refill)
    record_plain = plain_ms(lambda: mesh_level.record_ref(
        lv_c, rec_c, *res1, max_depth=cam.max_depth), restore_record)
    restore_refill()
    takes = n - int(lv0.alive.sum())
    takes = min(takes, int(kw0["item_end"]) - int(lv0.cnt[5, 2]))
    # bytes each entry must move on this level: refill reads alive, writes
    # the start word, and reads the uniforms and writes the state (o, d,
    # t, alive, depth: 33 B) of the lanes it starts; record reads alive,
    # depth, the start word, E, W, cf, alive', the new o and d, and writes
    # V, FL, o, d, alive and depth
    refill_bytes = n * (1 + 4) + takes * (20 + 33)
    record_bytes = n * (1 + 4 + 4 + 24 + 2 + 24) + n * (16 + 24 + 1 + 4)
    refill_bound = refill_bytes / HBM_BYTES_PER_S * 1e3
    record_bound = record_bytes / HBM_BYTES_PER_S * 1e3
    check(refill_ms > 0 and record_ms > 0,
          "the profiler saw no device time of the glue kernel")
    print(f"[30] (a) glue kernel on a real level ({takes} starts) on {card}:"
          f" device ms a call: refill {refill_ms:.5f} ms (plain "
          f"{refill_plain:.3f} ms, bound "
          f"{refill_bound:.5f} ms, {refill_bytes} B), record "
          f"{record_ms:.5f} ms (plain {record_plain:.3f} ms, bound "
          f"{record_bound:.5f} ms, {record_bytes} B); registers: "
          + " | ".join(_cuda.ptxas_report("mesh_level")))

    # (b) graphed against eager on the plain glue, bit for bit
    graph_rows = {}
    for route in ("walk", "binned2"):
        ctx_g = regen.MeshContext.build(scene, cam, dev, mesh=route)
        ctx_e = regen.MeshContext.build(scene, cam, dev, mesh=route)
        ctx_e.graph = False
        check(ctx_g.graph, f"{route}: the window is not graphed")
        bg_, ag, cg, ng = fresh(ctx_g, seed=3)
        mesh_level.refill = mesh_level.refill_ref
        mesh_level.record = mesh_level.record_ref
        try:
            be, ae, ce, ne = fresh(ctx_e, seed=3)
        finally:
            mesh_level.refill, mesh_level.record = (real["refill"],
                                                    real["record"])
        lev = int(cg[2])
        same = (torch.equal(cg, ce) and torch.equal(ag, ae) and all(
            torch.equal(a[:lev], b[:lev])
            for a, b in zip(bg_.rec + [bg_.base], be.rec + [be.base])))
        graph_rows[route] = dict(equal=same, cur=cg.tolist(),
                                 levels_run=[ng, ne])
        print(f"[30] (b) {route}: the window as a CUDA graph against the "
              f"same window eager on the plain glue (seed 3, cursor 0): "
              f"[next item, segments, levels recorded] {cg.tolist()} / "
              f"{ce.tolist()}, levels run {ng} / {ne}; records, bases and "
              f"accumulator " + ("equal bit for bit" if same else "DIFFER"))
        check(same and ctx_g.levels.graph is not None,
              f"{route}: the graphed window differs from the eager one")
        del bg_, ag, be, ae

    # (c) per level: host-issued launches, waits, wall ms, graphed and eager
    costs = {}
    bufs_c = regen.WindowBuffers.empty(n, window, 1, dev)
    for name, graph in (("graph", True), ("eager", False)):
        ctx_c = regen.MeshContext.build(scene, cam, dev, mesh="walk")
        ctx_c.graph = graph
        last = [0]

        def run_c(ctx_c=ctx_c):
            last[0] = fresh(ctx_c, seed=4, bufs=bufs_c, sync=False)[3]

        costs[name] = window_costs(run_c, lambda: last[0])
        print(f"[30] (c) the walk window {name} on {card}: per level "
              + json.dumps(costs[name]))
    check(costs["graph"]["waits"] * costs["graph"]["levels"] <= 1,
          "the graphed walk window waits on the device more than once")
    return {"name": "mesh_level", "route": "cuda",
            "source": "go_raytracer_tpu_torch/ops/csrc/mesh_level.cu",
            "replaces": "go_raytracer_tpu/integrator/regen.py:429 (fwd_step "
                        "outside bounce_fn, XLA; no pallas_call)",
            "launches": main_launches["refill"], "max_abs_err": err[0],
            "ms": refill_ms + record_ms,
            "plain_ms": refill_plain + record_plain,
            "bound_ms": refill_bound + record_bound, "bound_by": "bytes",
            "library_ms": None,
            "entries": [
                {"name": "grt_mesh_refill",
                 "launches": main_launches["refill"], "ms": refill_ms, "plain_ms": refill_plain,
                 "bound_ms": refill_bound, "bound_by": "bytes"},
                {"name": "grt_mesh_record",
                 "launches": main_launches["record"], "ms": record_ms, "plain_ms": record_plain,
                 "bound_ms": record_bound, "bound_by": "bytes"}],
            "graph_vs_eager": graph_rows, "window_costs": costs}


# phase 31: the reference engine's renders, graphed against eager: (scene,
# backend, spp at the registry width; CUT in spp: the eager tensor bounce
# takes 8-12 ms a level on the host)
ENGINE_RENDERS = (("cornell_box", "auto", 4), ("cornell_box", "xla", 1),
                  ("book3", "xla", 1), ("cornell_smoke", "xla", 1),
                  ("model_example", "xla", 1))
# the eager figures of these paths before they were graphed, ms a level
# (PERF.md §5, phase 26 before they were graphed): printed beside this
# run's
EAGER_MS_BEFORE = {"cornell_box auto": "0.531-0.813", "cornell_box xla": 8.19,
                   "model_example xla": 12.2, "lanternhouse regen": 37.2}
# the train steps held graphed against eager: GRAD.md's cornellBox step
# (phase 27's scale) and modelExample at its width, 1 batch
TRAIN_STEPS = 5


def engine_program_phase(dev, card):
    """Phase 31: the reference engine and the gradient step as device
    programs. (a) `render/renderer.render` of ENGINE_RENDERS with each
    level one CUDA graph replay against the same render with graph=False:
    image (SHA-256), segments and levels bit for bit, ms a level run,
    levels run and recorded; per level of one 131,072-ray radiance call,
    host-issued and device launches, waits (none in the graphed call) and
    wall ms (`window_costs`); (b) regen's unfused window on the tensor
    bounce (`--backend xla`) for modelExample and lanternhouse, graphed
    against eager: the same image SHA-256 and segments; (c) the launch
    counters of K3, K5 and the glue against the card's own count of their
    kernels under torch.profiler, on graphed calls captured before the
    profile; (d) two graphed
    calls on a continuing generator read new uniforms, the first seed
    again the first bits; (e) `make_train_step` graphed against eager,
    TRAIN_STEPS steps on GRAD.md's cornellBox and on modelExample at 1
    spp: timed in the default mode (ms a step, peak memory, waits and
    launches a step), held with deterministic algorithms on (losses
    within GRAPH_LOSS_RTOL relative, leaves within GRAPH_LEAF_TOL of their
    largest entry; the default mode's differences printed). Returns the
    phase's rows."""
    import copy
    import hashlib

    import numpy as np
    import torch

    from go_raytracer_tpu_torch.integrator import regen, wavefront
    from go_raytracer_tpu_torch.ops import bounce, mesh_level, trace
    from go_raytracer_tpu_torch.ops import traverse8
    from go_raytracer_tpu_torch.parallel import mesh as pmesh
    from go_raytracer_tpu_torch.render import camera as camera_mod
    from go_raytracer_tpu_torch.render import renderer
    from go_raytracer_tpu_torch.scenes import registry

    sha = lambda img: hashlib.sha256(np.ascontiguousarray(img).tobytes()) \
        .hexdigest()[:16]
    t_phase = time.perf_counter()
    clock = lambda: time.perf_counter() - t_phase
    rows = {"card": card, "renders": {}, "regen": {}, "train": {}}

    built = {}

    def scene_of(name):
        """The registry scene (built once: the mesh scenes' BVHs take
        seconds) and a fresh camera of it."""
        if name not in built:
            built[name] = (registry.model_example(
                obj_path="assets/lanternhouse.obj") if name == "lanternhouse"
                else getattr(registry, name)())
        scene, cam = built[name]
        return scene, copy.deepcopy(cam)

    def camera_rays(scene, cam, n, seed=3):
        """n camera rays of stratum 0 over the image's pixels in order."""
        gen0 = torch.Generator(device=dev).manual_seed(seed)
        ids = torch.arange(n, device=dev) % (cam.width * cam.image_height)
        zero = torch.zeros(n, device=dev)
        u_cam = torch.rand((n, camera_mod.N_U_RAYGEN), generator=gen0,
                           device=dev)
        return camera_mod.generate_rays(cam.derived().to(dev), cam.width,
                                        ids, zero, zero, u_cam)

    # (a) the reference engine's renders
    for name, backend, spp in ENGINE_RENDERS:
        tag = f"{name} {backend}"
        scene, cam = scene_of(name)
        cam.samples_per_pixel = spp
        out = {}
        # eager first, then the graphed render twice (each captures its
        # own levels): the first render of a process pays its warm-up
        for mode, graph in (("eager", False), ("graph0", None),
                            ("graph", None)):
            zero_launches()
            img, st = renderer.render(scene, cam, seed=0, device=dev,
                                      backend=backend, graph=graph)
            out[mode] = dict(sha=sha(img), segments=st["segments"],
                             levels=st["levels"], levels_run=st["levels_run"],
                             graph=st["graph"], elapsed_s=st["elapsed_s"],
                             ms_level=st["elapsed_s"] * 1e3
                             / max(st["levels_run"], 1),
                             K3=bounce.launches_bounce, K5=traverse8.launches)
        g, e = out["graph"], out["eager"]
        g["elapsed_s_first"] = out["graph0"]["elapsed_s"]
        same = (g["sha"] == e["sha"] == out["graph0"]["sha"]
                and g["segments"] == e["segments"]
                and g["levels"] == e["levels"])
        # one radiance call of 131,072 camera rays (stratum 0): per level
        scene_ds = trace.to_device(scene, dev)
        n = 1 << 17
        o, d, t = camera_rays(scene, cam, n)
        costs = {}
        # the eager call's costs on K3 alone (an eager profile of the
        # tensor bounce takes seconds; its host launches a level are its
        # device launches)
        for mode, graph in (("graph", None), ("eager", False))[
                :2 if backend == "auto" else 1]:
            last = [1]

            def run(graph=graph):
                gen = torch.Generator(device=dev).manual_seed(4)
                last[0] = wavefront.radiance(
                    scene_ds, o, d, t, gen, cam.max_depth,
                    cam.max_contribution, mode="while", backend=backend,
                    route={} if scene.has_tri_bvh else None,
                    graph=graph)[1]["levels_run"]

            costs[mode] = window_costs(run, lambda: last[0])
        del scene_ds
        torch.cuda.empty_cache()
        rows["renders"][tag] = dict(graph=g, eager=e, equal=same,
                                    per_level=costs, spp=spp,
                                    eager_ms_before=EAGER_MS_BEFORE.get(tag))
        print(f"[31] (a) {tag} {cam.width}x{cam.image_height} @ {spp} spp "
              f"on {card}: graphed {g['ms_level']:.4f} ms a level run "
              f"({g['levels_run']} run, {g['levels']} recorded, "
              f"{g['elapsed_s']:.3f} s; the first graphed render "
              f"{g['elapsed_s_first']:.3f} s), eager {e['ms_level']:.4f} ms "
              f"({e['levels_run']} run, {e['elapsed_s']:.3f} s; before this "
              f"slice {EAGER_MS_BEFORE.get(tag, 'not measured')}); image "
              f"SHA-256 {g['sha']} / {e['sha']}, segments {g['segments']} / "
              f"{e['segments']}: " + ("equal bit for bit" if same else
                                      "DIFFER"))
        print(f"[31] (a) {tag}: one call of {n} rays, per level: graphed "
              + json.dumps(costs["graph"]) + "; eager "
              + json.dumps(costs.get("eager")) + f" (+{clock():.1f} s)")
        check(same and g["graph"] and not e["graph"],
              f"{tag}: the graphed render differs from the eager one")
        check(costs["graph"]["waits"] == 0,
              f"{tag}: a graphed radiance call waits on the device")
        if backend == "auto":
            check(g["K3"] == g["levels_run"] and e["K3"] == e["levels_run"],
                  f"{tag}: K3 not launched once a level run")
        if name == "model_example":
            check(g["K5"] == g["levels_run"] and e["K5"] == e["levels_run"],
                  f"{tag}: K5 not launched once a level run")

    # (b) regen's unfused window on the tensor bounce, graphed vs eager
    for name, width, spp in (("model_example", 600, 4),
                             ("lanternhouse", 300, 1)):
        scene, cam = scene_of(name)
        cam.width, cam.samples_per_pixel = width, spp
        out = {}
        for mode, graph in (("graph", None), ("eager", False)):
            zero_launches()
            img, st = regen.render_regen(scene, cam, seed=0, device=dev,
                                         backend="xla", graph=graph)
            out[mode] = dict(sha=sha(img), segments=st["segments"],
                             levels=st["levels"], levels_run=st["levels_run"],
                             graph=st["graph"], elapsed_s=st["elapsed_s"],
                             ms_level=st["elapsed_s"] * 1e3
                             / max(st["levels_run"], 1),
                             glue=mesh_level.launches_record)
        g, e = out["graph"], out["eager"]
        same = g["sha"] == e["sha"] and g["segments"] == e["segments"]
        rows["regen"][name] = dict(graph=g, eager=e, equal=same)
        print(f"[31] (b) regen --backend xla {name} {width} wide @ {spp} spp "
              f"on {card}: graphed {g['ms_level']:.4f} ms a level run "
              f"({g['levels_run']} run, {g['elapsed_s']:.3f} s), eager "
              f"{e['ms_level']:.4f} ms ({e['levels_run']} run, "
              f"{e['elapsed_s']:.3f} s); SHA-256 {g['sha']} / {e['sha']}, "
              f"segments {g['segments']} / {e['segments']}: "
              + ("equal" if same else "DIFFER") + f" (+{clock():.1f} s)")
        check(same and g["graph"] and not e["graph"]
              and g["glue"] == g["levels_run"],
              f"regen --backend xla {name}: graphed differs from eager, or "
              f"its levels were not graphed")

    # (c) the counters against the card's count: one graphed radiance call
    # of K3 (cornellBox) and of K5 (modelExample) and one graphed regen
    # window on the tensor bounce (lanternhouse, the glue), each captured
    # by a call before it (a capture under the profiler costs seconds), in
    # one profile
    runs = {}
    for name, backend in (("cornell_box", "auto"), ("model_example", "xla")):
        scene, cam = scene_of(name)
        cam.max_depth = GRAD_DEPTH      # fewer levels: fewer events to read
        ds_c = trace.to_device(scene, dev)
        rays = camera_rays(scene, cam, 65536)

        def call(ds_c=ds_c, cam=cam, backend=backend, rays=rays):
            return wavefront.radiance(
                ds_c, *rays, torch.Generator(device=dev).manual_seed(2),
                cam.max_depth, cam.max_contribution, mode="while",
                backend=backend)[1]
        runs[name] = call
    scene, cam = scene_of("lanternhouse")
    cam.width, cam.samples_per_pixel, cam.max_depth = 200, 1, GRAD_DEPTH
    ctx = regen.MeshContext.build(scene, cam, dev, ext=False)
    n_w, d1 = 1 << 16, cam.max_depth + 1
    npix_w = cam.width * cam.image_height
    bufs_w = regen.WindowBuffers.empty(n_w, 5 * d1, 1, dev)

    def window():
        acc_w = torch.zeros((npix_w + n_w, 3), device=dev)
        _, cur_w, n_run = regen._mesh_window(
            ctx, acc_w, regen._init_state_mesh(n_w, dev), 0,
            regen.window_generator(0, 0, dev), npix_w, width=cam.width,
            npix=npix_w, sqrt_spp=1, window=5 * d1, refill=4 * d1,
            max_depth=cam.max_depth, max_contribution=cam.max_contribution,
            bufs=bufs_w)
        return dict(graph=ctx.graph, levels_run=n_run)
    runs["lanternhouse"] = window
    for fn in runs.values():
        fn()
        fn()
    torch.cuda.synchronize()
    names = {"cornell_box": ("bounce_level",),
             "model_example": ("bvh8_closest_kernel",),
             "lanternhouse": ("mesh_count", "mesh_refill", "mesh_record")}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # the profile's first launches are other kernels (a profile has
        # lost launches at its start, PERF.md §7)
        for _ in range(20):
            torch.ones(1 << 16, device=dev).cumsum_(0)
        torch.cuda.synchronize()
        zero_launches()
        st_c = {name: fn() for name, fn in runs.items()}
        torch.cuda.synchronize()
    mine = {"bounce_level": bounce.launches_bounce,
            "bvh8_closest_kernel": traverse8.launches,
            "mesh_count": mesh_level.launches_refill,
            "mesh_refill": mesh_level.launches_refill,
            "mesh_record": mesh_level.launches_record}
    seen = device_launches(prof, list(mine))
    del prof
    counted = {name: {k: mine[k] for k in ks} for name, ks in names.items()}
    on_card = {name: {k: seen[k] for k in ks} for name, ks in names.items()}
    rows["counters"] = dict(counted=counted, on_card=on_card,
                            levels_run={k: v["levels_run"]
                                        for k, v in st_c.items()})
    print(f"[31] (c) graphed calls under torch.profiler on {card}: "
          f"launches by the counters {counted}, on the device {on_card}, "
          f"levels run {rows['counters']['levels_run']} "
          f"(+{clock():.1f} s)")
    check(seen == mine and all(
        st_c[name]["graph"] and all(v == st_c[name]["levels_run"]
                                    for v in counted[name].values())
        for name in names),
          "the launch counters differ from the card's count or from the "
          "levels run")
    del ctx, bufs_w, runs
    torch.cuda.empty_cache()

    # (d) two replays read new uniforms
    scene, cam = registry.cornell_box()
    ds = trace.to_device(scene, dev)
    rays = camera_rays(scene, cam, 65536)
    gen = torch.Generator(device=dev).manual_seed(8)
    Ls, us = [], []
    for _ in range(3):
        Ls.append(wavefront.radiance(ds, *rays, gen, cam.max_depth,
                                     cam.max_contribution,
                                     backend="xla")[0])
        us.append(ds.engine["levels"].u.clone())
    again = wavefront.radiance(
        ds, *rays, torch.Generator(device=dev).manual_seed(8), cam.max_depth,
        cam.max_contribution, backend="xla")[0]
    fresh = (ds.engine["levels"].level is not None
             and not torch.equal(Ls[1], Ls[2])
             and not torch.equal(us[1], us[2])
             and torch.equal(again, Ls[0]))
    rows["fresh_uniforms"] = fresh
    print(f"[31] (d) graphed calls on one continuing generator read new "
          f"uniforms, the first seed again its bits: {fresh}")
    check(fresh, "graphed replays read frozen uniforms, or the same seed "
          "gave other bits")
    del ds, Ls, us
    torch.cuda.empty_cache()

    # (e) the train step as one graph against the eager step
    for name, width, batches in (("cornell_box", GRAD_WIDTH, GRAD_SPP),
                                 ("model_example", GRAD_MESH_WIDTH, 1)):
        scene, cam = scene_of(name)
        cam.width, cam.max_depth = width, GRAD_DEPTH
        if name == "cornell_box":
            cam.aspect_ratio = 1.0
        npix = width * cam.image_height
        ids = pmesh.pixel_ids(npix, batches, dev)
        with torch.no_grad():
            target, _ = pmesh.render_batches(
                trace.to_device(scene, dev), cam.derived().to(dev), width,
                ids, GRAD_DEPTH, cam.max_contribution,
                torch.Generator(device=dev).manual_seed(99))
        res = {}
        # timed in the default mode; compared with deterministic
        # algorithms on, where the backward's scatter-adds add in a fixed
        # order: Adam turns their last-bit differences into differences
        # of order its step in the leaves the render barely reads, so
        # the default mode's trajectories are printed, not held
        for mode, graph in (("graph", True), ("eager", False),
                            ("graph_det", True), ("eager_det", False)):
            torch.use_deterministic_algorithms(mode.endswith("_det"))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            step, params, _ = pmesh.make_train_step(
                scene, cam, n_rays=npix, n_sample_batches=batches,
                max_depth=GRAD_DEPTH, learning_rate=0.05, device=dev,
                graph=graph,
                generator=torch.Generator(device=dev).manual_seed(1))
            with torch.no_grad():
                params["tex_color"].mul_(0.8)
            losses, ms = [], []
            for _ in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step(params, ids, target))
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() - base
            leaves = {k: v.detach().clone() for k, v in params.items()}
            cost = window_costs(lambda: step(params, ids, target),
                                lambda: 1) if mode == "graph" else None
            res[mode] = dict(losses=losses, step_ms=ms, peak_bytes=peak,
                             per_step=cost, leaves=leaves)
            del step, params
        torch.use_deterministic_algorithms(False)

        def differ(a, b):
            loss = max(abs(x - y) / max(abs(y), 1e-30)
                       for x, y in zip(a["losses"], b["losses"]))
            leaf = {}
            for k, v in b["leaves"].items():
                scale = float(v.abs().max()) or 1.0
                leaf[k] = float((a["leaves"][k] - v).abs().max()) / scale
            return loss, leaf

        g, e = res["graph"], res["eager"]
        loss_rel, leaf_rel = differ(res["graph_det"], res["eager_det"])
        loss_def, leaf_def = differ(g, e)
        for r in res.values():
            del r["leaves"]
        rows["train"][name] = dict(
            graph=g, eager=e, loss_rel=loss_rel, leaf_rel=leaf_rel,
            default_mode=dict(loss_rel=loss_def, leaf_rel=leaf_def),
            deterministic_ms=dict(graph=res["graph_det"]["step_ms"],
                                  eager=res["eager_det"]["step_ms"]),
            rays=npix * batches)
        print(f"[31] (e) make_train_step {name} {width} wide x {batches} "
              f"batches, depth {GRAD_DEPTH}, on {card}: ms a step graphed "
              f"{[round(x, 2) for x in g['step_ms']]} (replays from the "
              f"third), eager {[round(x, 2) for x in e['step_ms']]}; peak "
              f"{g['peak_bytes'] / 2**30:.3f} / {e['peak_bytes'] / 2**30:.3f}"
              f" GiB; per step graphed " + json.dumps(g["per_step"])
              + f"; losses {g['losses']} / {e['losses']}; with "
              f"deterministic algorithms, largest relative loss difference "
              f"{loss_rel:.3g}, leaves (of each leaf's largest) "
              + json.dumps({k: float(f"{v:.3g}") for k, v in
                            leaf_rel.items()})
              + f"; in the default mode {loss_def:.3g}, "
              + json.dumps({k: float(f"{v:.3g}") for k, v in
                            leaf_def.items()}) + f" (+{clock():.1f} s)")
        check(loss_rel <= GRAPH_LOSS_RTOL
              and max(leaf_rel.values()) <= GRAPH_LEAF_TOL
              and np.isfinite(g["losses"]).all(),
              f"train step {name}: graphed differs from eager")
        check(g["per_step"]["waits"] <= 1,
              f"train step {name}: the graphed step waits more than once")
        torch.cuda.empty_cache()
    return rows


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout (the parent commit, "
                    "unpacked into a git-ignored directory): phase 23 then "
                    "holds the fused kernels' and K3's outputs to its "
                    "kernels' on the same inputs "
                    "(scripts/time_fused_kernels.py --save/--compare)")
    args = ap.parse_args()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from go_raytracer_tpu_torch import cli
        from go_raytracer_tpu_torch.integrator import regen
        from go_raytracer_tpu_torch.ops import _cuda, bounce, harvest
        from go_raytracer_tpu_torch.ops import mesh_level
        from go_raytracer_tpu_torch.render.camera import Camera
        from go_raytracer_tpu_torch.scene.builder import SceneBuilder
    except ImportError as e:
        fail(f"run from the repository root ({e})")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    t_start = time.perf_counter()
    try:
        import PIL
        pil = f"PIL {PIL.__version__} imports"
    except ImportError as e:
        pil = f"PIL does not import ({e})"
    print(f"[1] {pil} (the image-texture scenes decode assets/earthmap.jpg "
          f"through it)")

    def phase_start(k):
        print(f"[{k}] starts at {time.perf_counter() - t_start:.1f} s")

    # ---- 1. environment and build --------------------------------------
    print(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  ({card})")
    t0 = time.perf_counter()
    libs = _cuda.build_all()
    print(f"[1] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc wall {_cuda.build_seconds}): "
          + ", ".join(os.path.basename(p) for p in libs.values()))
    for name in libs:
        print(f"[1] {name}.cu: " + " | ".join(_cuda.ptxas_report(name)))

    # ---- 2. K1 against its plain version -------------------------------
    phase_start(2)
    # (a) starts at level 0 only: every lane's path is then its own, and
    #     per-lane mismatches stay local;
    # (b) refill at every level: one lane that branches the other way
    #     shifts the items of every later dead lane in flat order, so only
    #     the counts, the cursor chain and level 0 are compared per lane.
    n, n_inner = 1 << 17, 8
    scene, cam, tables, statics, cam_row, bg, state = cornell_inputs(dev, n)
    npix, sqrt_spp, width = 600 * 600, 10, 600
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=width,
              sqrt_spp=sqrt_spp, npix=npix)

    def k1_pair(refill_levels):
        seed4 = torch.tensor([-123456789, refill_levels, 1000, npix * 100],
                             dtype=torch.int32, device=dev)
        k_out = bounce.FusedQOut.empty(n, n_inner, dev)
        bounce.bounce_fused_q(tables, statics, cam_row, bg, seed4, *state,
                              out=k_out, **kw)
        torch.cuda.synchronize()
        p_out = bounce.FusedQOut.empty(n, n_inner, dev)
        bounce.bounce_fused_q_ref(tables, statics, cam_row, bg, seed4,
                                  *state, out=p_out, **kw)
        torch.cuda.synchronize()
        kt, pt = k_out.take.tolist(), p_out.take.tolist()
        print(f"[2] K1 refill {refill_levels} level(s): takes kernel {kt}\n"
              f"[2]                        plain  {pt}")
        check(kt[0] == pt[0] and k_out.base[0].item() == p_out.base[0].item(),
              "K1: level-0 take count / base differ")
        for o in (k_out, p_out):
            b_, t_ = o.base.tolist(), o.take.tolist()
            check(all(b_[j + 1] == b_[j] + t_[j] for j in range(n_inner - 1))
                  and o.cursor.item() == b_[-1] + t_[-1],
                  "K1: per-level bases do not chain the cursor")
        check(all(abs(a - b) <= K1_MISMATCH_FRAC * n for a, b in zip(kt, pt)),
              "K1: take counts differ beyond the mismatch fraction")
        check(started_ranks_are_a_prefix(k_out.rec[3], k_out.take),
              "K1: a level's starts skip or repeat an item")
        return k_out, p_out

    k_out, p_out = k1_pair(1)
    fl_k, fl_p = k_out.rec[3], p_out.rec[3]
    check(torch.equal(fl_k[0] & 4, fl_p[0] & 4)
          and torch.equal(fl_k[0] >> 3, fl_p[0] >> 3),
          "K1: level-0 starts or their ranks differ")
    fl_mis = ((fl_k & 7) != (fl_p & 7)).float().mean().item()
    alive_mis = (k_out.state[7] != p_out.state[7]).float().mean().item()
    close = torch.ones_like(fl_k, dtype=torch.bool)
    for a, b in zip(k_out.rec[:3], p_out.rec[:3]):
        close &= torch.isclose(a, b, rtol=K1_RTOL, atol=K1_ATOL,
                               equal_nan=True)
    v_mis = (~close).float().mean().item()
    agree0 = fl_k[0] == fl_p[0]
    k1_err = max((a[0] - b[0])[agree0].abs().max().item()
                 for a, b in zip(k_out.rec[:3], p_out.rec[:3]))
    alive_both = (k_out.state[7] > 0) & (p_out.state[7] > 0)
    o_mis = max((~torch.isclose(a[alive_both], b[alive_both], rtol=K1_RTOL,
                                atol=K1_ATOL)).float().mean().item()
                for a, b in zip(k_out.state[:3], p_out.state[:3]))
    print(f"[2] K1 mismatch fractions over {n_inner} levels: FL {fl_mis:.2e}"
          f"  alive {alive_mis:.2e}  V {v_mis:.2e}  origin {o_mis:.2e} "
          f"(limit {K1_MISMATCH_FRAC}, rtol=atol={K1_RTOL}); level-0 V max "
          f"abs err {k1_err:.3e}")
    for name, frac in (("FL", fl_mis), ("alive", alive_mis), ("V", v_mis),
                       ("origin", o_mis)):
        check(frac <= K1_MISMATCH_FRAC, f"K1: {name} mismatch {frac}")
    k_out, p_out = k1_pair(n_inner)
    seg_k, seg_p = k_out.seg.tolist(), p_out.seg.tolist()
    check(all(abs(a - b) <= K1_MISMATCH_FRAC * n for a, b in zip(seg_k, seg_p)),
          f"K1: alive counts {seg_k} vs {seg_p}")

    # ---- 3. K2 against its plain version -------------------------------
    phase_start(3)
    base0 = int(k_out.base[0])
    end = int(k_out.cursor[0])
    rows = end - base0 + n
    acc_k = torch.zeros((rows, 3), dtype=torch.float32, device=dev)
    acc_p = torch.zeros_like(acc_k)
    hk = dict(item_base=base0, s_run=n_inner, refill_levels=n_inner,
              max_contribution=cam.max_contribution)
    harvest.harvest_levels_into(acc_k, *k_out.rec, k_out.base, **hk)
    h_rows = harvest.reverse_harvest_levels_ref(
        *k_out.rec, refill_levels=n_inner,
        max_contribution=cam.max_contribution, s_run=n_inner)
    harvest.write_rows_ref(acc_p, h_rows, k_out.base, item_base=base0,
                           n_rows=n_inner)
    torch.cuda.synchronize()
    k2_err = (acc_k[:end - base0] - acc_p[:end - base0]).abs().max().item()
    print(f"[3] K2 accumulator over {end - base0} items: max abs err {k2_err}")
    check(k2_err == 0.0, "K2: accumulator differs from the plain version")

    # ---- 4. exact accounting, and kernels vs plain on a small render ---
    phase_start(4)
    def quad_scene(bg_):
        b = SceneBuilder(background=bg_)
        m = b.lambertian((0.5, 0.5, 0.5))
        b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0), m)
        b.add_light(b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0),
                           b.diffuse_light((1, 1, 1))))
        return b.build()

    c = Camera(width=32, aspect_ratio=1.0, samples_per_pixel=9, max_depth=4)
    c.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(quad_scene((1.0, 1.0, 1.0)), c, seed=0,
                                 n_lanes=4096, cadence=3, device=dev)
    check(np.abs(img - 1.0).max() == 0.0 and st["segments"] == 32 * 32 * 9,
          f"exact accounting: max |img-1| {np.abs(img - 1.0).max()}, "
          f"segments {st['segments']}")
    c = Camera(width=64, aspect_ratio=1.0, samples_per_pixel=16, max_depth=3)
    c.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(quad_scene((0.25, 0.5, 0.75)), c, seed=1,
                                 n_lanes=4096, cadence=2, refill_len=8,
                                 device=dev)
    err = np.abs(img - np.array([0.25, 0.5, 0.75], np.float32)).max()
    check(st["windows"] > 1 and err == 0.0,
          f"multi-window chaining: windows {st['windows']}, err {err}")
    print(f"[4] exact accounting ok; multi-window ok ({st['windows']} windows)")
    sc, cm = scene, cam
    cm.width, cm.samples_per_pixel, cm.max_depth = 32, 16, 50
    img_k, st_k = regen.render_regen(sc, cm, seed=3, n_lanes=4096, device=dev)
    img_p, st_p = regen.render_regen(sc, cm, seed=3, n_lanes=4096,
                                     device="cpu")
    pix_mis = (~np.isclose(img_k, img_p, rtol=1e-3, atol=1e-3)).any(-1).mean()
    print(f"[4] cornellBox 32 px, 16 spp: kernels vs plain: segments "
          f"{st_k['segments']} / {st_p['segments']}, mismatched pixels "
          f"{pix_mis:.4f}, mean {img_k.mean():.6f} / {img_p.mean():.6f}")
    check(abs(img_k.mean() - img_p.mean()) < 0.01 * img_p.mean()
          and pix_mis < 0.05, "kernels vs plain render disagree")

    # ---- 5. the flagship through the CLI -------------------------------
    phase_start(5)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    bounce.launches = 0
    harvest.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-S", "6", "-o",
                       os.path.join(out_dir, "cornellBox_flagship.ppm"),
                       "--stats", "--quiet"])
    k1_launches, k2_launches = bounce.launches, harvest.launches
    check(rc == 0, f"cli.main returned {rc}")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    flag5 = stats
    ratio = stats["segments"] / stats["paths"]
    print(f"[5] flagship cornellBox 600x600 100spp depth 50, 131072 lanes on "
          f"{card}: paths {stats['paths']}, segments {stats['segments']} "
          f"({ratio:.4f}/path), {stats['rays_per_s']:.6g} rays/s, elapsed "
          f"{stats['elapsed_s']:.4f} s, windows {stats['windows']}, "
          f"occupancy {stats['occupancy']:.4f}, nonfinite "
          f"{stats['nonfinite']}; launches K1 {k1_launches} K2 {k2_launches}")
    check(stats["paths"] == 36_000_000, "flagship: paths != 36,000,000")
    check(stats["nonfinite"] == 0, "flagship: non-finite pixels")
    check(2.78 <= ratio <= 3.08, f"flagship: segments/path {ratio}")
    check(k1_launches > 0 and k2_launches > 0,
          "flagship did not launch both kernels")
    # spread over repeats, and the device's busy share under the profiler
    from go_raytracer_tpu_torch.scenes import registry
    fscene, fcam = registry.cornell_box()
    reps = [regen.render_regen(fscene, fcam, seed=s, device=dev)[1]
            for s in (1, 2, 3)]
    print("[5] repeats (seeds 1-3): rays/s " + ", ".join(
        f"{r['rays_per_s']:.6g}" for r in reps) + "; elapsed s " + ", ".join(
        f"{r['elapsed_s']:.5f}" for r in reps))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, pst = regen.render_regen(fscene, fcam, seed=4, device=dev)
    dev_us = device_times(prof)
    render_us = sum(v for k, v in dev_us.items() if kernel_of(
        k, ("fused_q_level", "count_dead", "harvest_levels")))
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    if dev_us:
        print(f"[5] profiled render (seed 4): elapsed {pst['elapsed_s']:.5f} s"
              f" (render loop only), the port's kernels "
              f"{render_us / 1e6:.5f} s = {render_us / 1e6 / pst['elapsed_s']:.3f}"
              f" of it; all device events in the profile (incl. set-up and "
              f"image readback), ms: " + ", ".join(
                  f"{k[:40]} {v / 1e3:.3f}" for k, v in top))
    else:
        print("[5] profiler reported no device time: busy share not measured")

    # ---- 6. timings at the flagship's shapes ---------------------------
    phase_start(6)
    n = 1 << 17
    scene, cam, tables, statics, cam_row, bg, _ = cornell_inputs(dev, n)
    n_inner = cam.regen_cadence
    state = regen._init_state(n, dev)
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=600,
              sqrt_spp=10, npix=npix)
    out = bounce.FusedQOut.empty(n, n_inner, dev)
    # steady state: a few calls with a deep queue fill and age the pool
    seed4 = torch.tensor([7, n_inner, 0, npix * 100], dtype=torch.int32,
                         device=dev)
    for _ in range(8):
        bounce.bounce_fused_q(tables, statics, cam_row, bg, seed4, *state,
                              out=out, **kw)
        state = [s.clone() for s in out.state]
    st0 = [s.clone() for s in state]

    def run_k1():
        bounce.bounce_fused_q(tables, statics, cam_row, bg, seed4, *st0,
                              out=out, **kw)

    def run_k1_plain():
        bounce.bounce_fused_q_ref(tables, statics, cam_row, bg, seed4, *st0,
                                  out=out, **kw)

    k1_ms = time_ms(run_k1, 20)
    segs = int(out.seg.sum())
    k1_plain_ms = time_ms(run_k1_plain, 3)
    k1_bytes = n * (36 + 36) + n_inner * n * 16 \
        + sum(t.numel() * 4 for t in tables)
    k1_bound, k1_bound_by = fused_bound(k1_bytes, segs)
    print(f"[6] K1 {n} lanes x {n_inner} levels ({segs} segments): kernel "
          f"{k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms, bound "
          f"{k1_bound:.4f} ms ({k1_bound_by}) on {card}")
    # K1's two __global__ functions, per launch: a level moves the lane
    # state in and out and writes one record; count_dead reads alive once
    k1a_bytes = n * (36 + 36 + 16)
    k1a_bound = max(k1a_bytes / HBM_BYTES_PER_S, segs / n_inner
                    * K1_OPS_PER_SEGMENT / FP32_OPS_PER_S) * 1e3
    k1b_bound = (n * 4 + 4 * (n // bounce.BLOCK)) / HBM_BYTES_PER_S * 1e3
    lvl_us = sum(v for k, v in dev_us.items()
                 if kernel_of(k, "fused_q_level"))
    cnt_us = sum(v for k, v in dev_us.items() if kernel_of(k, "count_dead"))
    n_lvl = k1_launches * n_inner
    print(f"[6] K1a fused_q_level: bound {k1a_bound:.5f} ms per launch (bytes), "
          f"{k1a_bound * n_lvl:.4f} ms over the flagship's {n_lvl} launches; "
          f"profiled {lvl_us / 1e3 / n_lvl:.5f} ms per launch. K1b count_dead: "
          f"bound {k1b_bound:.6f} ms per launch (bytes), "
          f"{k1b_bound * k1_launches:.5f} ms over {k1_launches} launches; "
          f"profiled {cnt_us / 1e3 / k1_launches:.5f} ms per launch")

    # K2 on one flagship window's records
    _, cam = cornell_inputs(dev, 8)[:2]
    d1 = cam.max_depth + 1
    total = npix * 100
    refill = regen._auto_refill(total, n, d1, n_inner, cam)
    window = -(-(refill + d1) // n_inner) * n_inner
    bufs = regen.WindowBuffers.empty(n, window // n_inner, n_inner, dev)
    acc = torch.zeros((total + n, 3), dtype=torch.float32, device=dev)
    state = regen._init_state(n, dev)
    _, _, cur = regen._window_impl(
        tables, statics, cam_row, bg, acc, state,
        torch.zeros(1, dtype=torch.int32, device=dev),
        regen.window_seeds(0, 0, window // n_inner), 0, total, width=600,
        npix=npix, sqrt_spp=10, window=window, refill=refill,
        cadence=n_inner, max_depth=50, max_contribution=cam.max_contribution,
        bufs=bufs)
    next_item, _, s_run = (int(x) for x in cur.tolist())
    rec = [r[:s_run] for r in bufs.rec]
    bases = bufs.base.reshape(-1)
    takes = bufs.take.reshape(-1)[:s_run]
    b_, t_ = bases[:s_run].tolist(), takes.tolist()
    check(next_item == total and b_[0] == 0
          and all(b_[j + 1] == b_[j] + t_[j] for j in range(s_run - 1))
          and b_[-1] + t_[-1] == next_item,
          "flagship window: per-level bases do not chain the cursor")
    check(started_ranks_are_a_prefix(rec[3], takes),
          "flagship window: a level's starts skip or repeat an item")
    print(f"[6] flagship window: {s_run} levels, {next_item} items, each "
          f"started once at its own slot")
    hk = dict(item_base=0, s_run=s_run, refill_levels=refill,
              max_contribution=cam.max_contribution)
    acc2 = torch.zeros_like(acc)
    k2_ms = time_ms(lambda: harvest.harvest_levels_into(acc2, *rec, bases,
                                                       **hk), 10)
    check(torch.equal(acc2[:next_item], acc[:next_item]),
          "K2 timing run differs from the window's harvest")

    acc3 = torch.zeros_like(acc)

    def run_k2_plain():
        rows_ = harvest.reverse_harvest_levels_ref(
            *rec, refill_levels=refill,
            max_contribution=cam.max_contribution, s_run=s_run)
        harvest.write_rows_ref(acc3, rows_, bases, item_base=0,
                               n_rows=min(s_run, refill))

    k2_plain_ms = time_ms(run_k2_plain, 1, warmup=0)
    k2_win_err = (acc3[:next_item] - acc[:next_item]).abs().max().item()
    print(f"[6] K2 vs plain on the flagship window ({s_run} levels, "
          f"{next_item} paths): max abs err {k2_win_err}")
    check(k2_win_err == 0.0,
          "K2 differs from its plain version on the flagship window")
    k2_err = max(k2_err, k2_win_err)
    k2_bytes = s_run * n * 16 + next_item * 12 + s_run * 4
    k2_bound = k2_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[6] K2 {n} lanes x {s_run} levels, {next_item} paths: kernel "
          f"{k2_ms:.4f} ms, plain {k2_plain_ms:.2f} ms, bound {k2_bound:.4f}"
          f" ms (bytes) on {card}")
    print(f"[6] K1 on cornellBox (the core variant without spheres, "
          f"dielectric or media): {k1_ms:.4f} ms per call, against "
          f"{K1_EARLIER_MS} ms before this core ({k1_ms / K1_EARLIER_MS - 1:+.1%})")
    # K1 and K9 on the new scenes, at their registry cadence, on an aged
    # pool; a K9 call writes its levels at row 0 of a two-call buffer
    for sc in NEW_SCENES:
        _, cam_s, tab_s, st_s, row_s, bg_s, _ = cornell_inputs(dev, 8,
                                                               scene=sc)
        cad_s = cam_s.regen_cadence
        kw_s = dict(has_defocus=False, max_depth=50, n_inner=cad_s,
                    width=600, sqrt_spp=cam_s.spp_sqrt, npix=npix)
        seed_s = torch.tensor([7, cad_s, 0, npix * 10], dtype=torch.int32,
                              device=dev)
        o_s = bounce.FusedQOut.empty(n, cad_s, dev)
        st0_s = aged_state(lambda st_: bounce.bounce_fused_q(
            tab_s, st_s, row_s, bg_s, seed_s, *st_, out=o_s, **kw_s)[4:],
            regen._init_state(n, dev))
        tb_bytes = sum(t.numel() * 4 for t in tab_s)
        nbytes = n * (36 + 36) + cad_s * n * 16 + tb_bytes
        k1s = time_ms(lambda: bounce.bounce_fused_q(
            tab_s, st_s, row_s, bg_s, seed_s, *st0_s, out=o_s, **kw_s), 20)
        segs_s = int(o_s.seg.sum())
        k1s_plain = time_ms(lambda: bounce.bounce_fused_q_ref(
            tab_s, st_s, row_s, bg_s, seed_s, *st0_s, out=o_s, **kw_s), 3)
        bufs_s = regen.WindowBuffers.empty(n, 2, cad_s, dev).rec
        base_s = torch.zeros(1, dtype=torch.int32, device=dev)
        k9s = time_ms(lambda: bounce.bounce_fused_q_direct(
            tab_s, st_s, row_s, bg_s, seed_s, base_s, bufs_s, *st0_s,
            out=o_s, **kw_s), 20)
        k9s_plain = time_ms(lambda: bounce.bounce_fused_q_direct_ref(
            tab_s, st_s, row_s, bg_s, seed_s, base_s, bufs_s, *st0_s,
            out=o_s, **kw_s), 3)
        bnd, by = fused_bound(nbytes, segs_s, sc)
        print(f"[6] {sc}: K1 {n} lanes x {cad_s} levels ({segs_s} segments):"
              f" kernel {k1s:.4f} ms, plain {k1s_plain:.3f} ms; K9 (the same "
              f"levels written at a device base) {k9s:.4f} ms, plain "
              f"{k9s_plain:.3f} ms; bound {bnd:.4f} ms ({by}; "
              f"{OPS_PER_SEGMENT[sc]} operations per segment) on {card}")


    # ---- 7. K4 and K5 against their plain versions at scene 8's shapes --
    phase_start(7)
    from go_raytracer_tpu_torch.ops import intersect, stream, stream2, trace
    from go_raytracer_tpu_torch.ops import traverse, traverse8
    from go_raytracer_tpu_torch.scenes import registry as reg8

    scene8, cam8 = reg8.model_example()
    ctx = regen.MeshContext.build(scene8, cam8, dev)
    ms, bvh = ctx.ms, ctx.ms.tri_bvh
    n8 = regen.MESH_MAX_LANES
    npix8 = cam8.width * cam8.image_height
    geo = dict(width=cam8.width, npix=npix8, sqrt_spp=cam8.spp_sqrt)
    # three levels of a real window, then the fourth level's refill: the
    # pool holds camera rays, bounced rays and dead lanes
    gen = regen.window_generator(0, 0, dev)
    bufs3 = regen.WindowBuffers.empty(n8, 3, 1, dev)
    acc8 = torch.zeros((4 * n8, 3), dtype=torch.float32, device=dev)
    state8, cur7, _ = regen._mesh_window(
        ctx, acc8, regen._init_state_mesh(n8, dev), 0, gen, SCENE8_PATHS,
        window=3, refill=2, max_depth=cam8.max_depth,
        max_contribution=cam8.max_contribution, bufs=bufs3, **geo)
    nxt = int(cur7[0])
    del bufs3, acc8
    lv8 = mesh_level.MeshLevel.empty(n8, 1, ctx.n_u, dev)
    lv8.begin(state8, cur7[0])
    lv8.u_cam.uniform_(generator=gen)
    mesh_level.refill(lv8, ctx.arrays, ctx.cam_row,
                      torch.zeros(1, dtype=torch.int32, device=dev),
                      item_end=nxt + n8 // 4, refill=1, cadence=1, **geo)
    o8, d8, t8, alive8 = lv8.o, lv8.d, lv8.t, lv8.alive
    u8 = torch.rand((n8, 9), generator=gen, dtype=torch.float32, device=dev)
    cap8 = intersect.sphere_ts(ms.spheres, o8, d8, t8, 1e-3,
                               float("inf")).amin(dim=1)
    rays8 = (o8, d8)      # kept for phase 18 (phase 16 reuses the names)
    n_alive8 = int(alive8.sum())
    n_capped8 = int((torch.isfinite(cap8) & alive8).sum())
    print(f"[7] scene 8 level: {n8} lanes, {n_alive8} alive, {n_capped8} "
          f"capped by a sphere, {n8 - n_alive8} dead; statue "
          f"{scene8.triangles.count} triangles, {bvh.cl_lo.shape[0]} clusters,"
          f" {bvh.cl_lines.shape[0]} groups, BVH8 max stack {bvh.max_stack}")
    check(0 < n8 - n_alive8 < n8 and n_capped8 > 0,
          "scene 8 level has no mix of alive, capped and dead lanes")

    # K4: every call one binned_closest makes, against the plain version
    calls = []
    real_stream_rows = stream.stream_rows

    def spy(*a):
        out = real_stream_rows(*a)
        calls.append((a, out))
        return out

    stream.stream_rows = spy
    try:
        counters7 = {}
        bt8, bi8 = trace.binned_closest(ms, o8, d8, cap8, alive8,
                                        counters=counters7)
    finally:
        stream.stream_rows = real_stream_rows
    torch.cuda.synchronize()
    check(len(calls) == counters7["rounds"] > 0, "K4: no round ran")
    k4_err = 0.0
    for a, (kt, ki) in calls:
        pt, pi = stream.stream_rows_ref(*a)
        check(torch.equal(ki, pi), "K4: a winner differs from the plain version")
        check(torch.equal(kt, pt), "K4: t differs from the plain version")
        k4_err = max(k4_err, (kt - pt).abs().nan_to_num(0.0).max().item())
    k4_args = calls[0][0]
    k4_tests = int(((k4_args[2] - k4_args[1]).long().sum()) * 8 * stream.BLOCK)
    # the blocks' group ranges, and K4's work items (CH groups of a range
    # between multiples of CH), at round 0 and over all rounds
    n_grp8 = bvh.cl_lines.shape[0]
    spans7 = [(a[2].clamp(max=n_grp8) - a[1].clamp(min=0)).clamp(min=0)
              for a, _ in calls]
    items7 = [int(torch.where(sp > 0, (a[2].clamp(max=n_grp8) - 1) // stream.CH
                              - a[1].clamp(min=0) // stream.CH + 1, 0).sum())
              for (a, _), sp in zip(calls, spans7)]
    all7 = torch.cat(spans7).float()
    print(f"[7] K4 vs plain on the {len(calls)} rounds of one binned_closest "
          f"(pools {[c[0][3].numel() for c in calls]}): idx equal, t bit for "
          f"bit; round 0 tests {k4_tests} ray-triangle pairs; groups per "
          f"block's range: round 0 mean {spans7[0].float().mean().item():.2f}"
          f" max {int(spans7[0].max())}, all rounds mean "
          f"{all7.mean().item():.2f} max {int(all7.max())}; work items of "
          f"CH={stream.CH} groups: round 0 {items7[0]}, all rounds "
          f"{sum(items7)} ({items7})")

    # K5 against its plain version, on the level's rays as they lie and
    # sorted as the walk route sorts them, and against K4's winners
    cap0 = torch.where(alive8, cap8, 0.0)
    keyw = torch.where(alive8, trace.coherence_key(bvh, o8, d8), 0x7FFFFFFF)
    permw = torch.sort(keyw).indices
    k5_sorted = (o8[permw].contiguous(), d8[permw].contiguous(),
                 cap0[permw].contiguous())

    def k5_vs_plain(o_, d_, c_, what, visits=None):
        """K5 and its plain version on these rays: (t, idx, max abs err);
        fails unless idx is equal and t bit for bit."""
        kt, ki = traverse8.bvh8_closest(bvh.bvh8_nodes, bvh.bvh8_tris, o_,
                                        d_, c_, max_stack=bvh.max_stack)
        torch.cuda.synchronize()
        pt, pi = traverse8.bvh8_closest_ref(bvh.bvh8_nodes, bvh.bvh8_tris,
                                            o_, d_, c_, visits=visits)
        check(torch.equal(ki, pi) and torch.equal(kt, pt),
              f"K5 differs from its plain version ({what})")
        return kt, ki, (kt - pt).abs().nan_to_num(0.0).max().item()

    visits = {}
    kt5, ki5, k5_err = k5_vs_plain(o8, d8, cap0, "phase 7's level", visits)
    visits_s = {}
    _, ki5s, k5_err_s = k5_vs_plain(*k5_sorted, "phase 7's level, sorted",
                                    visits_s)
    check(torch.equal(ki5s, ki5[permw]), "K5: sorting the rays moves a winner")
    k5_err = max(k5_err, k5_err_s)
    # the plain walk's steps per ray (node visits + group tests) and the
    # most steps of a ray in each warp of 4, 8 and 32 sorted rays: a warp
    # of the kernel lasts as long as its heaviest ray
    steps5 = visits_s["ray_visits"] + visits_s["ray_groups"]
    warp5 = {wr: steps5.view(-1, wr).amax(dim=1).float() for wr in (4, 8, 32)}
    check(torch.equal(bi8, ki5) and torch.equal(bt8, kt5),
          "K4's winners (binned route) differ from K5's (walk)")
    wt8, wi8 = trace.mesh_closest(ms, o8, d8, cap8, alive8, mesh="walk")
    check(torch.equal(wi8, ki5) and torch.equal(wt8, kt5),
          "the walk route's sort and unsort change a result")
    n_hit8 = int((ki5 >= 0).sum())
    print(f"[7] K5 vs plain (team {traverse8.TEAM}, block {traverse8.BLOCK}),"
          f" on the rays as they lie and sorted: idx equal, t bit for bit; "
          f"{n_hit8} lanes hit the statue; walk work {visits['node_visits']} "
          f"node visits, {visits['group_tests']} group tests; steps per "
          f"sorted ray mean {steps5.float().mean().item():.2f} max "
          f"{int(steps5.max())}; the heaviest ray of a warp of 4 / 8 / 32 "
          f"sorted rays: mean " + " / ".join(
              f"{warp5[w].mean().item():.2f}" for w in (4, 8, 32))
          + ", max " + " / ".join(f"{int(warp5[w].max())}" for w in (4, 8, 32))
          + "; K4 winners == K5 winners")
    # both routes against the plain skip-link walk (its own Moller-Trumbore
    # form and closed intervals: an edge-grazing ray may differ)
    st8, si8 = trace.bvh_tri_closest(ms, o8, d8, trace.T_MIN, float("inf"))
    hit_s = torch.isfinite(st8) & (st8 < cap8) & alive8
    set_mis = ((ki5 >= 0) != hit_s).float().mean().item()
    both8 = (ki5 >= 0) & hit_s
    win_mis = (ki5[both8] != si8[both8]).float().mean().item()
    print(f"[7] both routes vs the plain skip-link walk: hit set differs on "
          f"{set_mis:.2e} of the lanes, winner on {win_mis:.2e} of the common "
          f"hits (limit 1e-3)")
    check(set_mis <= 1e-3 and win_mis <= 1e-3,
          "mesh_closest disagrees with the plain skip-link walk")

    # ---- 8. K3 against its plain version on that level -----------------
    phase_start(8)
    # the dense cap (K3's cap entry, one launch) against the tensor cap
    cap8_k = ctx.k3.cap(ms, o8, d8, t8)
    torch.cuda.synchronize()
    cap8_fin = torch.isfinite(cap8_k) & torch.isfinite(cap8)
    cap_set_mis = (torch.isfinite(cap8_k) != torch.isfinite(cap8)).float() \
        .mean().item()
    cap_off = (~torch.isclose(cap8_k[cap8_fin], cap8[cap8_fin], rtol=K1_RTOL,
                              atol=K1_ATOL)).float().mean().item()
    cap_err = (cap8_k[cap8_fin] - cap8[cap8_fin]).abs().max().item()
    print(f"[8] K3's cap entry vs the tensor cap at {n8} lanes: finite on "
          f"{int(cap8_fin.sum())} lanes, the finite set differs on "
          f"{cap_set_mis:.2e} of the lanes, t beyond rtol=atol={K1_RTOL} on "
          f"{cap_off:.2e} of the common ones (limit {K3_MISMATCH_FRAC}); max "
          f"abs err {cap_err:.3e}")
    check(cap8_fin.any() and cap_set_mis <= K3_MISMATCH_FRAC
          and cap_off <= K3_MISMATCH_FRAC,
          "K3's cap entry differs from the tensor cap")
    # K3 from the walk's winner (t, idx), gathered in the kernel, against
    # the plain gather (ops/bounce.ext_planes_from_hit) and bounce_ref
    hit8 = bounce.MeshHit(*trace.mesh_closest(ms, o8, d8, cap8, alive8))
    k3 = ctx.k3(o8, d8, t8, alive8, u8, ext=hit8)
    torch.cuda.synchronize()
    p3 = bounce.bounce_ref(ctx.tables, ctx.statics, o8, d8, t8, alive8, u8,
                           ctx.bg, ext=hit8, tri=ctx.tri)
    alive_mis3 = (k3[5] != p3[5]).float().mean().item()
    cf_mis3 = (k3[2] != p3[2]).float().mean().item()
    agree3 = k3[5] == p3[5]
    ew_off = torch.zeros(n8, dtype=torch.bool, device=dev)
    for a, b in ((k3[0], p3[0]), (k3[1], p3[1])):
        ew_off |= (~torch.isclose(a, b, rtol=K1_RTOL, atol=K1_ATOL,
                                  equal_nan=True)).any(dim=-1)
    ew_mis3 = (ew_off & agree3).float().mean().item()
    ok3 = agree3 & ~ew_off
    k3_err = max((a - b)[ok3].abs().nan_to_num(0.0).max().item()
                 for a, b in ((k3[0], p3[0]), (k3[1], p3[1])))
    go3 = agree3 & k3[5]
    ray_mis3 = max((~torch.isclose(a[go3], b[go3], rtol=K1_RTOL,
                                   atol=K1_ATOL)).float().mean().item()
                   for a, b in ((k3[3], p3[3]), (k3[4], p3[4])))
    print(f"[8] K3 vs plain at {n8} lanes from the walk's winner ("
          f"{int((hit8.idx >= 0).sum())} lanes hit the statue; the kernel "
          f"gathers the triangle): mismatch fractions"
          f" alive {alive_mis3:.2e}  clamp flag {cf_mis3:.2e}  E/W "
          f"{ew_mis3:.2e}  scattered ray {ray_mis3:.2e} (limit "
          f"{K3_MISMATCH_FRAC}, rtol=atol={K1_RTOL}); E/W max abs err "
          f"{k3_err:.3e}; {int(k3[5].sum())} lanes go on")
    for name, frac in (("alive", alive_mis3), ("clamp flag", cf_mis3),
                       ("E/W", ew_mis3), ("scattered ray", ray_mis3)):
        check(frac <= K3_MISMATCH_FRAC, f"K3: {name} mismatch {frac}")
    check(not k3[5][~alive8].any() and not k3[0][~alive8].any(),
          "K3: a dead lane shades or goes on")

    # ---- 9. a small scene-8 render: kernels against plain versions ------
    phase_start(9)
    reset_counts = zero_launches

    # 32,768 lanes hold all 20,736 paths at once, so every path keeps its
    # lane and its random numbers in both renders, and a lane that K3's
    # rounding sends the other way changes that one path only (with fewer
    # lanes it would shift every later item to another lane)
    sc8, cm8 = reg8.model_example()
    cm8.width, cm8.samples_per_pixel = 48, 16
    kw9 = dict(seed=3, n_lanes=1 << 15, device=dev)
    img_k, st_k = regen.render_regen(sc8, cm8, mesh="binned", **kw9)
    img_w, st_w = regen.render_regen(sc8, cm8, mesh="walk", **kw9)
    check(np.array_equal(img_k, img_w) and st_k["segments"] == st_w["segments"],
          "scene 8: the two routes render different images from one seed")
    reset_counts()
    with plain_versions(bounce, harvest, stream, traverse8):
        img_p, st_p = regen.render_regen(sc8, cm8, mesh="walk", **kw9)
    check(bounce.launches_bounce + bounce.launches_cap + stream.launches
          + traverse8.launches + harvest.launches + mesh_level.launches_refill
          + mesh_level.launches_record == 0,
          "the plain render launched a kernel")
    small_ratio = st_k["segments"] / st_k["paths"]
    mean_k, mean_p = img_k.mean(axis=(0, 1)), img_p.mean(axis=(0, 1))
    pix_off = (~np.isclose(img_k, img_p, rtol=1e-3, atol=1e-3)).any(-1).mean()
    print(f"[9] scene 8, 48x27, 16 spp, depth 50, 32768 lanes, one random "
          f"stream: kernels vs plain versions: segments {st_k['segments']} / "
          f"{st_p['segments']} ({small_ratio:.4f}/path), pixels beyond 1e-3 "
          f"{pix_off:.4f}, channel means {np.round(mean_k, 6).tolist()} / "
          f"{np.round(mean_p, 6).tolist()}; binned and walk images identical")
    check(st_k["paths"] == st_p["paths"] and st_k["nonfinite"] == 0,
          "scene 8 small render: paths or non-finite pixels")
    check(abs(st_k["segments"] - st_p["segments"]) <= 0.01 * st_p["segments"],
          "scene 8 small render: segments differ by more than 1%")
    check(np.abs(mean_k - mean_p).max() <= 1e-2 and pix_off <= 0.05,
          "scene 8 small render: channel means differ by more than 1e-2, or "
          "more than 5% of the pixels by more than 1e-3")

    # ---- 10. one flagship window, then the flagship through the CLI -----
    phase_start(10)
    # The mesh path's start ranks (FL bits 3..) and per-level bases come
    # from `refill_assign`'s cumulative sum, not from K1, and most starts
    # happen after level 0: record one window as the flagship runs it and
    # hold K2 against its plain version on those records.
    d1_8 = cam8.max_depth + 1
    refill8, window8 = 4 * d1_8, 5 * d1_8
    bufs8 = regen.WindowBuffers.empty(n8, window8, 1, dev)
    acc8_k = torch.zeros((SCENE8_PATHS + n8, 3), dtype=torch.float32,
                         device=dev)
    harvest.launches = 0
    # (the levels recorded: any run past the drained one record nothing)
    _, cur8, _ = regen._mesh_window(
        ctx, acc8_k, regen._init_state_mesh(n8, dev), 0,
        regen.window_generator(0, 0, dev), SCENE8_PATHS, window=window8,
        refill=refill8, max_depth=cam8.max_depth,
        max_contribution=cam8.max_contribution, bufs=bufs8, **geo)
    nxt8, seg8, s_run8 = cur8.tolist()
    check(harvest.launches == 1, "the mesh window did not launch K2 once")
    rec8 = [r[:s_run8] for r in bufs8.rec]
    bases8 = bufs8.base.reshape(-1)
    b8 = bases8[:s_run8].tolist()
    t8_ = [hi - lo for lo, hi in zip(b8, b8[1:] + [nxt8])]
    takes8 = torch.tensor(t8_, dtype=torch.int32, device=dev)
    later8 = sum(1 for x in t8_[1:] if x > 0)
    check(b8[0] == 0 and min(t8_) >= 0 and not any(t8_[refill8:]),
          "scene 8 window: bases go backwards or a level past the refill "
          "starts paths")
    check(later8 >= refill8 // 2,
          f"scene 8 window: only {later8} levels after the first start paths")
    check(started_ranks_are_a_prefix(rec8[3], takes8),
          "scene 8 window: a level's starts skip or repeat an item")
    hk8 = dict(item_base=0, s_run=s_run8, refill_levels=refill8,
               max_contribution=cam8.max_contribution)
    acc8_p = torch.zeros_like(acc8_k)

    def run_k2_plain8():
        rows_ = harvest.reverse_harvest_levels_ref(
            *rec8, refill_levels=refill8,
            max_contribution=cam8.max_contribution, s_run=s_run8)
        harvest.write_rows_ref(acc8_p, rows_, bases8, item_base=0,
                               n_rows=min(s_run8, refill8))

    k2_plain_ms8 = time_ms(run_k2_plain8, 1, warmup=0)
    k2_err8 = (acc8_k[:nxt8] - acc8_p[:nxt8]).abs().max().item()
    check(not acc8_k[nxt8:].any() and not acc8_p[nxt8:].any(),
          "scene 8 window: a row past the window's items is not zero")
    acc8_t = torch.zeros_like(acc8_k)
    k2_ms8 = time_ms(lambda: harvest.harvest_levels_into(
        acc8_t, *rec8, bases8, **hk8), 10)
    check(torch.equal(acc8_t[:nxt8], acc8_k[:nxt8]),
          "K2 timing run differs from the scene 8 window's harvest")
    k2_bound8 = (s_run8 * n8 * 16 + nxt8 * 12 + s_run8 * 4) \
        / HBM_BYTES_PER_S * 1e3
    print(f"[10] scene 8 window (window {window8}, refill {refill8}, {n8} "
          f"lanes): {s_run8} levels, {nxt8} paths started at "
          f"{later8 + 1} levels, {seg8} segments; each level's starts take "
          f"base..base+take-1 once; K2 vs plain: max abs err {k2_err8}; K2 "
          f"{k2_ms8:.4f} ms, plain {k2_plain_ms8:.2f} ms, bound "
          f"{k2_bound8:.4f} ms (bytes) on {card}")
    check(k2_err8 == 0.0,
          "K2 differs from its plain version on the scene 8 window")
    k2_err = max(k2_err, k2_err8)
    del bufs8, rec8, acc8_k, acc8_p, acc8_t

    def run_cli8(extra, image):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-S", "8", "-o", os.path.join(out_dir, image),
                           "--stats", "--quiet", *extra])
        check(rc == 0, f"cli.main -S 8 {extra} returned {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    # the binned route, cut to 25 spp (5x5 strata) for the script's time
    paths25 = 600 * 337 * 25
    reset_counts()
    s8 = run_cli8(["--mesh", "binned", "--spp", "25"],
                  "modelExample_binned25.ppm")
    k3_launches, k4_launches = bounce.launches_bounce, stream.launches
    k2_launches_8 = harvest.launches
    ratio8 = s8["segments"] / s8["paths"]
    m8 = s8["mesh"]
    print(f"[10] modelExample 600x337 CUT to 25 spp (full: 250), depth 50, "
          f"{s8['lanes']} lanes, binned route, on {card}: paths {s8['paths']},"
          f" segments {s8['segments']} ({ratio8:.4f}/path), "
          f"{s8['rays_per_s']:.6g} rays/s, elapsed {s8['elapsed_s']:.3f} s, "
          f"windows {s8['windows']}, levels {s8['levels']}, occupancy "
          f"{s8['occupancy']:.4f}, nonfinite {s8['nonfinite']}; launches K3 "
          f"{k3_launches} K4 {k4_launches} K2 {k2_launches_8} K5 "
          f"{traverse8.launches} K1 {bounce.launches}; rounds per level "
          f"{m8['rounds'] / s8['levels_run']:.3f}, host reads per level "
          f"{m8['host_reads'] / s8['levels_run']:.3f} (one per round, one "
          f"before the first; the level's counts stay on the device)")
    check(s8["paths"] == paths25, f"scene 8 binned: paths != {paths25}")
    check(s8["nonfinite"] == 0 and s8["schedule"] == "queue"
          and m8["route"] == "binned",
          "scene 8: non-finite pixels, wrong schedule or wrong route")
    check(abs(ratio8 - small_ratio) <= 0.05 * small_ratio,
          f"scene 8: segments/path {ratio8} vs the small render's {small_ratio}")
    check(k3_launches == s8["levels_run"] and k4_launches == m8["rounds"]
          and k2_launches_8 == s8["windows"],
          "scene 8: launch counts do not match levels, rounds and windows")
    check(k3_launches > 0 and k4_launches > 0 and k2_launches_8 > 0,
          "scene 8 binned render did not launch K3, K4 and K2")
    # the default route (the walk) at the same cut and seed, held against
    # the binned run.
    # Both routes return the same winners, so the two runs trace the same
    # paths unless a ray meets two triangles of different groups at one t
    # (the routes visit groups in different orders); after one such lane
    # the lanes' items and random numbers part ways, and the segment totals
    # then differ by their statistical spread.
    reset_counts()
    s8w25 = run_cli8(["--spp", "25"], "modelExample_walk25.ppm")
    with open(os.path.join(out_dir, "modelExample_binned25.ppm"), "rb") as fa, \
            open(os.path.join(out_dir, "modelExample_walk25.ppm"), "rb") as fb:
        same_image = fa.read() == fb.read()
    print(f"[10] modelExample, walk route, the same 25 spp on {card}: paths "
          f"{s8w25['paths']}, segments {s8w25['segments']}, elapsed "
          f"{s8w25['elapsed_s']:.3f} s, levels {s8w25['levels']}; launches K5 "
          f"{traverse8.launches} K4 {stream.launches}; segments equal to the "
          f"binned run's: {s8w25['segments'] == s8['segments']}, image files "
          f"identical: {same_image}")
    check(s8w25["paths"] == s8["paths"] and s8w25["nonfinite"] == 0
          and s8w25["mesh"]["route"] == "walk",
          "scene 8 default route at 25 spp: paths, non-finite pixels or a "
          "route other than the walk")
    check(traverse8.launches == s8w25["levels_run"] > 0
          and stream.launches == 0,
          "scene 8 walk route at 25 spp did not go through K5 alone")
    check(abs(s8w25["segments"] - s8["segments"]) <= 2e-3 * s8["segments"],
          "scene 8 at 25 spp: the routes' segments differ by more than 2e-3")
    # the slice's main path: `-S 8` with no route named (the walk), at the
    # full registry configuration
    reset_counts()
    # the plain gather and cap must not run on the card's path: count
    # their calls around the render
    plain_calls = {"ext_planes_from_hit": 0, "dense_cap_ref": 0}
    saved_plain = {k: getattr(bounce, k) for k in plain_calls}

    def counting(name):
        def fn(*a, **k):
            plain_calls[name] += 1
            return saved_plain[name](*a, **k)
        return fn

    for k in plain_calls:
        setattr(bounce, k, counting(k))
    # and the mesh level's plain glue
    glue_plain = {"refill_ref": 0, "record_ref": 0}
    saved_glue = {k: getattr(mesh_level, k) for k in glue_plain}

    def counting_glue(name):
        def fn(*a, **k):
            glue_plain[name] += 1
            return saved_glue[name](*a, **k)
        return fn

    for k in glue_plain:
        setattr(mesh_level, k, counting_glue(k))
    try:
        s8w = run_cli8([], "modelExample_walk.ppm")
    finally:
        for k, f in saved_plain.items():
            setattr(bounce, k, f)
        for k, f in saved_glue.items():
            setattr(mesh_level, k, f)
    # the mesh level's glue kernel on the main path (phase 30's kernels line)
    ml_launches_main8 = dict(refill=mesh_level.launches_refill,
                             record=mesh_level.launches_record)
    k5_launches = traverse8.launches
    k3_launches = bounce.launches_bounce    # K3 on the uncut main path
    cap_launches = bounce.launches_cap      # its dense cap entry
    k2_launches_main8 = harvest.launches
    others8 = (bounce.launches + bounce.launches_fused
               + bounce.launches_fused_pos + bounce.launches_direct
               + harvest.launches_rows + stream.launches
               + stream.launches_round + stream2.launches + traverse.launches)
    ratio8w = s8w["segments"] / s8w["paths"]
    print(f"[10] flagship modelExample 600x337 250spp (225 strata) depth 50, "
          f"{s8w['lanes']} lanes, walk route, on {card}: paths {s8w['paths']},"
          f" segments {s8w['segments']} ({ratio8w:.4f}/path), "
          f"{s8w['rays_per_s']:.6g} rays/s, elapsed {s8w['elapsed_s']:.3f} s,"
          f" windows {s8w['windows']}, levels {s8w['levels']}, occupancy "
          f"{s8w['occupancy']:.4f}; launches K5 {k5_launches} K3 "
          f"{k3_launches} (its cap entry {cap_launches}) K2 "
          f"{k2_launches_main8}, the other nine kernels {others8}; calls of "
          f"the plain gather and cap {plain_calls}")
    check(s8w["paths"] == SCENE8_PATHS and s8w["nonfinite"] == 0
          and s8w["mesh"]["route"] == "walk",
          "scene 8 main path: paths, non-finite pixels or a route other "
          "than the walk")
    check(k5_launches == s8w["levels_run"] > 0 and others8 == 0
          and k3_launches == s8w["levels_run"] == cap_launches
          and k2_launches_main8 == s8w["windows"]
          and not any(plain_calls.values()),
          "scene 8 main path did not go through K5, K3 (its cap entry "
          "once a level) and K2 alone")
    check(abs(ratio8w - small_ratio) <= 0.05 * small_ratio,
          f"scene 8 walk: segments/path {ratio8w} vs the small render's "
          f"{small_ratio}")
    print(f"[10] the main path's mesh levels: {s8w['levels_run']} run, "
          f"{s8w['levels']} recorded, CUDA graph {s8w['mesh']['graph']} "
          f"({s8w['mesh']['replays']} replays); glue kernel launches "
          f"{ml_launches_main8}, plain glue calls {glue_plain}")
    check(s8w["mesh"]["graph"] and not any(glue_plain.values())
          and ml_launches_main8 == dict(refill=s8w["levels_run"],
                                        record=s8w["levels_run"])
          and s8w["mesh"]["replays"] == s8w["levels_run"] - 1
          and s8w["levels"] <= s8w["levels_run"],
          "scene 8 main path: its levels did not replay as a CUDA graph "
          "through the glue kernel once a level")
    # the launch counters against the card's own count: the main path once
    # more, under torch.profiler, its kernels on the device counted by name
    # (the graph's nodes included; the render's levels run past a drain
    # follow the host's pace, so this run counts its own)
    reset_counts()
    with torch.profiler.profile(activities=acts) as prof10:
        s8p = run_cli8([], "modelExample_walk_profiled.ppm")
        torch.cuda.synchronize()
    counted10 = {"mesh_count": mesh_level.launches_refill,
                 "mesh_refill": mesh_level.launches_refill,
                 "mesh_record": mesh_level.launches_record,
                 "bounce_cap": bounce.launches_cap,
                 "bounce_level": bounce.launches_bounce,
                 "bvh8_closest_kernel": traverse8.launches,
                 "harvest_levels": harvest.launches}
    on_card10 = device_launches(prof10, counted10)
    del prof10
    with open(os.path.join(out_dir, "modelExample_walk.ppm"), "rb") as fa, \
            open(os.path.join(out_dir, "modelExample_walk_profiled.ppm"),
                 "rb") as fb:
        same10 = fa.read() == fb.read()
    print(f"[10] the main path again under torch.profiler: {s8p['levels_run']}"
          f" levels run, {s8p['mesh']['replays']} graph replays; launches "
          f"by the counters {counted10}, on the device {on_card10}; image "
          f"file identical to the main path's: {same10}")
    check(on_card10 == counted10
          and counted10["bounce_level"] == s8p["levels_run"]
          == counted10["mesh_record"] == counted10["bvh8_closest_kernel"]
          and counted10["harvest_levels"] == s8p["windows"]
          and s8p["mesh"]["replays"] == s8p["levels_run"] - 1
          and s8p["levels"] == s8w["levels"] and same10,
          "scene 8 main path: the launch counters differ from the kernels "
          "the card ran, or the profiled render differs")

    # ---- 11. timings of K3-K5, and the busy share of a scene-8 render --
    phase_start(11)
    k4_per = [time_ms(lambda a=a: real_stream_rows(*a), 20) for a, _ in calls]
    k4_ms = k4_per[0]
    k4_plain_ms = time_ms(lambda: stream.stream_rows_ref(*k4_args), 1, warmup=0)
    k4_bytes = bvh.cl_lines.numel() * 4 + n8 * (8 * 4 + 8) + 8 * (n8 // stream.BLOCK)
    k4_ops_s = k4_tests * MT_OPS / FP32_OPS_PER_S
    k4_bound = max(k4_bytes / HBM_BYTES_PER_S, k4_ops_s) * 1e3
    k4_by = "bytes" if k4_bytes / HBM_BYTES_PER_S >= k4_ops_s else "operations"
    k5_args = (bvh.bvh8_nodes, bvh.bvh8_tris, o8, d8, cap0)
    k5_ms = time_ms(lambda: traverse8.bvh8_closest(
        *k5_args, max_stack=bvh.max_stack), 20)
    k5_sorted_ms = time_ms(lambda: traverse8.bvh8_closest(
        bvh.bvh8_nodes, bvh.bvh8_tris, *k5_sorted, max_stack=bvh.max_stack),
        20)
    # the plain version on the rays the walk route hands K5 (sorted)
    k5_plain_ms = time_ms(lambda: traverse8.bvh8_closest_ref(
        bvh.bvh8_nodes, bvh.bvh8_tris, *k5_sorted), 1, warmup=0)
    # its tables (pack_tables' rows) read once, 28 bytes in and 8 out a ray
    k5_bytes = (bvh.bvh8_nodes.numel() + bvh.bvh8_tris.numel()) * 4 \
        + n8 * (28 + 8)
    k5_ops_s = (visits["node_visits"] * 8 * BOX_OPS
                + visits["group_tests"] * 8 * MT_OPS) / FP32_OPS_PER_S
    k5_bound = max(k5_bytes / HBM_BYTES_PER_S, k5_ops_s) * 1e3
    k5_by = "bytes" if k5_bytes / HBM_BYTES_PER_S >= k5_ops_s else "operations"
    # the sort of the walk route, timed beside the kernel it feeds
    walk_ms = time_ms(lambda: trace.mesh_closest(ms, o8, d8, cap8, alive8,
                                                 mesh="walk"), 10)
    binned_ms = time_ms(lambda: trace.binned_closest(ms, o8, d8, cap8, alive8),
                        5)
    # K3 from the walk's winner and its cap entry, through the launch the
    # mesh context prepared once: ms per call between CUDA events, host us
    # per call (enqueued back to back), device ms (queued behind a spin)
    k3_out8 = bounce.bounce_out(n8, dev)
    cap_out8 = torch.empty(n8, device=dev)
    k3_run = lambda: ctx.k3(o8, d8, t8, alive8, u8, ext=hit8, out=k3_out8)
    cap_run = lambda: ctx.k3.cap(ms, o8, d8, t8, out=cap_out8)
    k3_ms = time_ms(k3_run, 20)
    k3_host = host_us(k3_run)
    k3_dev = queued_device_ms(k3_run)
    cap_ms = time_ms(cap_run, 20)
    cap_host = host_us(cap_run)
    cap_dev = queued_device_ms(cap_run)
    k3_plain_ms = time_ms(lambda: bounce.bounce_ref(
        ctx.tables, ctx.statics, o8, d8, t8, alive8, u8, ctx.bg, ext=hit8,
        tri=ctx.tri), 3)
    cap_plain_ms = time_ms(lambda: bounce.dense_cap_ref(ms, o8, d8, t8), 3)
    # bytes: per lane the ray (24 B), time, alive, 9 uniforms, the walk's
    # (t, idx) in and 50 B out; what the gather needs of the distinct
    # triangles hit, and the packed tables read once
    tri_bytes, tris_hit = tri_hit_bytes(bounce, ctx.tri, ctx.statics,
                                        hit8.idx, alive8)
    k3_bytes = n8 * (24 + 4 + 1 + 36 + 8 + 50) + tri_bytes \
        + sum(t.numel() * 4 for t in ctx.tables)
    k3_ops_s = n_alive8 * K3_OPS_PER_SEGMENT / FP32_OPS_PER_S
    k3_bound = max(k3_bytes / HBM_BYTES_PER_S, k3_ops_s) * 1e3
    k3_by = "bytes" if k3_bytes / HBM_BYTES_PER_S >= k3_ops_s else "operations"
    k4_all_bound = sum(max(
        (bvh.cl_lines.numel() * 4 + a[3].numel() * 40
         + 8 * (a[3].numel() // stream.BLOCK)) / HBM_BYTES_PER_S,
        int(sp.sum()) * 8 * stream.BLOCK * MT_OPS / FP32_OPS_PER_S)
        for (a, _), sp in zip(calls, spans7)) * 1e3
    print(f"[11] K4 on every round of that binned_closest, on {card}: "
          f"{[round(x, 4) for x in k4_per]} ms; sum {sum(k4_per):.4f} ms, "
          f"largest {max(k4_per):.4f} ms, mean {sum(k4_per) / len(k4_per):.4f}"
          f" ms; the rounds' bounds sum to {k4_all_bound:.5f} ms")
    cap_bound = n8 * (24 + 4 + 4) / HBM_BYTES_PER_S * 1e3
    print(f"[11] at {n8} lanes of scene 8 on {card}: K3 from the walk's "
          f"winner {k3_ms:.4f} ms per call between CUDA events, host "
          f"{k3_host:.1f} us per call, device {k3_dev} ms; plain "
          f"{k3_plain_ms:.3f} ms, bound {k3_bound:.5f} ms ({k3_by}; "
          f"{tri_bytes} B of the {tris_hit} triangles hit); its "
          f"cap entry {cap_ms:.4f} ms, host {cap_host:.1f} us, device "
          f"{cap_dev} ms, plain (the tensor cap) {cap_plain_ms:.3f} ms, "
          f"bound {cap_bound:.5f} ms (bytes); K4 round 0 {k4_ms:.4f} ms, "
          f"plain {k4_plain_ms:.2f} ms, bound {k4_bound:.5f} ms ({k4_by}); K5 "
          f"{k5_ms:.4f} ms on the rays as they lie, {k5_sorted_ms:.4f} ms "
          f"sorted, plain {k5_plain_ms:.2f} ms, bound {k5_bound:.5f} "
          f"ms ({k5_by}); one binned_closest {binned_ms:.3f} ms "
          f"({counters7['rounds']} rounds), one walk-route mesh_closest "
          f"{walk_ms:.3f} ms")
    # device busy share: a one-window render under the profiler, CUT to
    # 1 spp for the script's time (the profile's post-processing grows with
    # the binned route's ~40 launches per round)
    sc8, cm8 = reg8.model_example()
    cm8.samples_per_pixel = 1
    _, ust = regen.render_regen(sc8, cm8, seed=5, device=dev, mesh="binned")
    with torch.profiler.profile(activities=acts) as prof8:
        _, pst8 = regen.render_regen(sc8, cm8, seed=5, device=dev,
                                     mesh="binned")
    dev_us8 = device_times(prof8)
    if dev_us8:
        all_us = sum(dev_us8.values())
        k4_names = ("stream_prep", "stream_items", "stream_finish")
        own_us = sum(v for k, v in dev_us8.items() if kernel_of(
            k, ("bounce_level", "bvh8_closest_kernel", "harvest_levels")
            + k4_names))
        per = lambda names, count: sum(
            v for k, v in dev_us8.items() if kernel_of(k, names)) / 1e3 / count
        print(f"[11] profiled device ms per launch in that render: K3 "
              f"bounce_level {per('bounce_level', pst8['levels_run']):.5f}, "
              f"K4 stream_prep + stream_items + stream_finish (all rounds) "
              f"{per(k4_names, pst8['mesh']['rounds']):.5f}, K2 "
              f"harvest_levels {per('harvest_levels', pst8['windows']):.5f}")
        top8 = sorted(dev_us8.items(), key=lambda kv: -kv[1])[:8]
        print(f"[11] scene 8 at 1 spp ({pst8['levels']} levels): render loop "
              f"{ust['elapsed_s']:.3f} s unprofiled, {pst8['elapsed_s']:.3f} s"
              f" under the profiler; device busy {all_us / 1e6:.3f} s = "
              f"{all_us / 1e6 / pst8['elapsed_s']:.3f} of the profiled loop "
              f"(incl. set-up and readback events), the port's kernels "
              f"{own_us / 1e6:.4f} s = {own_us / 1e6 / pst8['elapsed_s']:.4f};"
              f" top device events, ms: " + ", ".join(
                  f"{k[:48]} {v / 1e3:.2f}" for k, v in top8))
    else:
        print("[11] profiler reported no device time: busy share not measured")
    # the same on the main path's route, the walk
    _, ustw = regen.render_regen(sc8, cm8, seed=5, device=dev)
    with torch.profiler.profile(activities=acts) as prof8w:
        _, pst8w = regen.render_regen(sc8, cm8, seed=5, device=dev)
    dev_us8w = device_times(prof8w)
    if dev_us8w:
        all_w = sum(dev_us8w.values())
        perw = lambda name, count: sum(
            v for k, v in dev_us8w.items() if name in k) / 1e3 / count
        top8w = sorted(dev_us8w.items(), key=lambda kv: -kv[1])[:8]
        print(f"[11] scene 8 at 1 spp on the walk route ({pst8w['levels']} "
              f"levels): render loop {ustw['elapsed_s']:.3f} s unprofiled, "
              f"{pst8w['elapsed_s']:.3f} s under the profiler; device busy "
              f"{all_w / 1e6:.3f} s = {all_w / 1e6 / pst8w['elapsed_s']:.3f} "
              f"of the profiled loop; device ms per launch: K5 "
              f"bvh8_closest_kernel "
              f"{perw('bvh8_closest_kernel', pst8w['levels_run']):.5f}, K3 "
              f"bounce_level {perw('bounce_level', pst8w['levels_run']):.5f}, "
              f"K2 "
              f"{perw('harvest_levels', pst8w['windows']):.5f}; top device "
              f"events, ms: " + ", ".join(f"{k[:48]} {v / 1e3:.2f}"
                                          for k, v in top8w))
    else:
        print("[11] profiler reported no device time on the walk route: "
              "busy share not measured")

    # ---- 12. K6 and K8 against their plain versions ---------------------
    phase_start(12)
    n, n_inner = 1 << 17, 8
    scene, cam, tables, statics, cam_row, bg, state = cornell_inputs(dev, n)
    fkw = dict(has_defocus=False, max_depth=50, n_inner=n_inner)

    def queue_refill(st_, next_item, item_end):
        return regen.queue_refill_planes(
            torch.tensor(next_item, device=dev), st_[7], item_end, width=600,
            npix=npix, sqrt_spp=10)

    def fused_pair(name, k, p, frac=K1_MISMATCH_FRAC, tag="12", tex=False):
        """Mismatch fractions of one fused call, kernel against plain
        version, at most `frac` of the lanes each. With `tex` (a textured
        scene, where a rounding of a far hit point moves a noise value on
        other lanes at every level) the new rays are counted over all
        lanes, not over those alive in both, and a lane flips when one of
        its levels' records leaves the tolerance: at most levels x `frac`
        of the lanes. Returns (level-0 record max abs err, lanes that did
        not flip)."""
        krec, _, kseg, *kst = k
        levels = krec[0].shape[0]
        prec, _, pseg, *pst = p
        check(kseg[0].item() == pseg[0].item(),
              f"{name}: level-0 alive counts differ")
        check(all(abs(a - b) <= frac * n
                  for a, b in zip(kseg.tolist(), pseg.tolist())),
              f"{name}: alive counts {kseg.tolist()} vs {pseg.tolist()}")
        noflip = kst[7] == pst[7]
        alive_mis = (~noflip).float().mean().item()
        agree0 = torch.ones(n, dtype=torch.bool, device=dev)
        int_mis = v_mis = 0.0
        for a, b in zip(krec, prec):
            if a.dtype == torch.int32:
                int_mis = max(int_mis, (a != b).float().mean().item())
                noflip &= (a == b).all(dim=0)
                agree0 &= a[0] == b[0]
            else:
                off = ~torch.isclose(a, b, rtol=K1_RTOL, atol=K1_ATOL,
                                     equal_nan=True)
                v_mis = max(v_mis, off.float().mean().item())
                # a lane that took another way through glass keeps its
                # flags; its records tell
                noflip &= ~off.any(dim=0)
        err0 = max((a[0] - b[0])[agree0].abs().nan_to_num(0.0).max().item()
                   for a, b in zip(krec, prec) if a.dtype != torch.int32)
        alive_both = (kst[7] > 0) & (pst[7] > 0)
        ray_mis = max((~torch.isclose(a[alive_both], b[alive_both],
                                      rtol=K1_RTOL, atol=K1_ATOL))
                      .float().sum().item()
                      / (n if tex else max(int(alive_both.sum()), 1))
                      for a, b in zip(kst[:6], pst[:6]))
        flip = (~noflip).float().mean().item()
        print(f"[{tag}] {name} vs plain at {n} lanes x {levels} levels: "
              f"mismatch fractions flags {int_mis:.2e}  alive {alive_mis:.2e}"
              f"  records {v_mis:.2e}  "
              f"{'all' if tex else 'alive'} lanes' rays {ray_mis:.2e}  "
              f"flipped lanes {flip:.2e} (limit {frac}"
              f"{f', flipped lanes {levels} x {frac}' if tex else ''}, "
              f"rtol=atol={K1_RTOL}); level-0 record max abs err {err0:.3e};"
              f" alive per level {kseg.tolist()}")
        for what, mis in (("flags", int_mis), ("alive", alive_mis),
                          ("records", v_mis), ("rays", ray_mis),
                          ("flipped lanes", flip / (levels if tex else 1))):
            check(mis <= frac, f"{name}: {what} mismatch {mis}")
        check(torch.equal(kst[6][noflip], pst[6][noflip])
              and torch.equal(kst[8][noflip], pst[8][noflip]),
              f"{name}: time or depth differ on a lane that did not flip")
        return err0, noflip

    refill6 = queue_refill(state, 1000, npix * 100)
    check(int(refill6[0].sum()) == int((state[7] == 0).sum()) > 0,
          "K6: the refill did not take every dead lane")
    seed6 = torch.tensor([-123456789], dtype=torch.int32, device=dev)
    k6 = bounce.bounce_fused(tables, statics, cam_row, bg, seed6, *state,
                             *refill6, **fkw)
    torch.cuda.synchronize()
    p6 = bounce.bounce_fused_ref(tables, statics, cam_row, bg, seed6, *state,
                                 *refill6, **fkw)
    k6_err, _ = fused_pair("K6", k6, p6)
    check(k6[2][0].item() == n, "K6: not every lane is alive at level 0")

    rs = np.random.default_rng(5)
    to_f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    ptr8 = [to_f(rs.choice([0, 7, 599], n)), to_f(rs.integers(0, 599, n)),
            to_f(rs.choice([0, 9], n)), to_f(rs.choice([0, 3, 9], n)),
            to_f(rs.choice([0, 1, 2, 275], n))]
    seed8 = torch.tensor([24680, 5], dtype=torch.int32, device=dev)
    pkw = dict(width=600, sqrt_spp=10, **fkw)
    k8 = bounce.bounce_fused_pos(tables, statics, cam_row, bg, seed8, *state,
                                 *ptr8, **pkw)
    torch.cuda.synchronize()
    p8 = bounce.bounce_fused_pos_ref(tables, statics, cam_row, bg, seed8,
                                     *state, *ptr8, **pkw)
    k8_err, noflip8 = fused_pair("K8", k8, p8)
    check(all(torch.equal(a[noflip8], b[noflip8])
              for a, b in zip(k8[12:], p8[12:])),
          "K8: pi, pj, si, sj or rem differ on a lane that did not flip")
    st8_ = k8[0][7]
    check(torch.equal(st8_[0], p8[0][7][0]) and not st8_[5:].any()
          and bool(st8_[:5].any(dim=1).all())
          and torch.equal(st8_.sum(dim=0).float(), ptr8[4] - k8[16]),
          "K8: starts do not follow rem and the refill cut")
    print(f"[12] K8 starts per level {st8_.sum(dim=1).tolist()} (refill cut "
          f"after level 5); pointer planes equal on all "
          f"{int(noflip8.sum())} lanes that did not flip")

    # ---- 13. K7 on one real flagship queue window -----------------------
    phase_start(13)
    _, fcam6 = registry.cornell_box()
    d1 = fcam6.max_depth + 1
    total = npix * 100
    q_refill = 4 * d1
    q_window = -(-(q_refill + d1) // n_inner) * n_inner
    q_outer, q_rows = q_window // n_inner, -(-q_refill // n_inner)
    qbufs = regen.SchedBuffers.empty(n, q_outer, n_inner, dev, q_rows)
    nan = float("nan")
    acc_k = torch.full((total + n, 3), nan, dtype=torch.float32, device=dev)
    wkw = dict(width=600, sqrt_spp=10, window=q_window, refill=q_refill,
               cadence=n_inner, max_depth=50,
               max_contribution=fcam6.max_contribution)
    q_seeds = regen.window_seeds(0, 0, q_outer).to(dev)
    reset_counts()
    _, _, cur = regen._queue_window(
        tables, statics, cam_row, bg, acc_k, regen._init_state(n, dev),
        torch.tensor(0, device=dev), q_seeds, 0, total, npix=npix,
        bufs=qbufs, **wkw)
    torch.cuda.synchronize()
    check(bounce.launches_fused == q_outer and harvest.launches_rows == 1,
          "the queue window did not launch K6 once per call and K7 once")
    q_next, q_segs, _ = (int(x) for x in cur.tolist())
    q_counts = qbufs.sts.sum(dim=1).tolist()
    q_nis = qbufs.nis.tolist()
    check(q_nis[0] == 0 and q_next == q_nis[-1] + q_counts[-1]
          and all(q_nis[r + 1] == q_nis[r] + q_counts[r]
                  for r in range(q_rows - 1)),
          "queue window: the refill rows' bases do not chain the cursor")
    q_rec = [r.view(q_outer, n_inner, n) for r in qbufs.rec]
    hkw = dict(cadence=n_inner, refill_outer=q_rows,
               max_contribution=fcam6.max_contribution)
    acc_p = torch.full_like(acc_k, nan)

    def run_k7_plain():
        rows_ = harvest.reverse_harvest_ref(*q_rec, qbufs.sts, **hkw)
        harvest.write_rows_ref(acc_p, rows_, qbufs.nis, item_base=0,
                               n_rows=q_rows)

    k7_plain_ms = time_ms(run_k7_plain, 1, warmup=0)
    check(not torch.isnan(acc_k[:q_next]).any(),
          "K7: an item started in the window was not written")
    check(bool(torch.isnan(acc_k[q_next:]).all()),
          "K7: a row past the window's items was written")
    k7_err = (acc_k[:q_next] - acc_p[:q_next]).abs().max().item()
    print(f"[13] flagship queue window ({q_window} levels, {q_rows} refill "
          f"rows, {n} lanes): {q_next} paths started ({q_counts[0]} at row 0,"
          f" {min(q_counts)}-{max(q_counts[1:])} at the others), {q_segs} "
          f"segments; each row's starts take NIs[r]..NIs[r]+count-1 once; "
          f"K7 vs plain accumulator: max abs err {k7_err}")
    check(k7_err == 0.0, "K7 differs from its plain version on the window")
    acc_t = torch.full_like(acc_k, nan)
    k7_ms = time_ms(lambda: harvest.reverse_harvest_into(
        acc_t, *q_rec, qbufs.sts, qbufs.nis, item_base=0, **hkw), 10)
    check(torch.equal(acc_t[:q_next], acc_k[:q_next]),
          "K7 timing run differs from the window's harvest")
    k7_bytes = q_window * n * 16 + q_rows * n * 4 + q_next * 12 + q_rows * 4
    k7_bound = k7_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[13] K7 {n} lanes x {q_window} levels, {q_next} paths: kernel "
          f"{k7_ms:.4f} ms, plain {k7_plain_ms:.2f} ms, bound {k7_bound:.4f} "
          f"ms (bytes) on {card}")
    del acc_k, acc_p, acc_t, q_rec, qbufs

    # ---- 14. exact accounting through K6/K7 and K8 ----------------------
    phase_start(14)
    for sched in ("queue", "positional"):
        reset_counts()
        c = Camera(width=32, aspect_ratio=1.0, samples_per_pixel=9,
                   max_depth=4)
        c.position((0, 0, 5), (0, 0, 0))
        img, st = regen.render_regen(quad_scene((1.0, 1.0, 1.0)), c, seed=0,
                                     n_lanes=4096, cadence=3, schedule=sched,
                                     device=dev)
        check(np.abs(img - 1.0).max() == 0.0 and st["schedule"] == sched
              and st["segments"] == 32 * 32 * 9,
              f"exact accounting ({sched}): max |img-1| "
              f"{np.abs(img - 1.0).max()}, segments {st['segments']}")
        c = Camera(width=64, aspect_ratio=1.0, samples_per_pixel=16,
                   max_depth=3)
        c.position((0, 0, 5), (0, 0, 0))
        img, st = regen.render_regen(quad_scene((1.0, 1.0, 1.0)), c, seed=1,
                                     n_lanes=4096, cadence=2, refill_len=4,
                                     schedule=sched, device=dev)
        err = np.abs(img - 1.0).max()
        check(st["windows"] > 1 and err == 0.0
              and st["segments"] == 64 * 64 * 16,
              f"multi-window ({sched}): windows {st['windows']}, err {err}")
        used = (bounce.launches_fused, harvest.launches_rows) \
            if sched == "queue" else (bounce.launches_fused_pos,)
        check(all(u > 0 for u in used) and bounce.launches == 0,
              f"{sched}: the renders did not go through its kernels")
        print(f"[14] {sched}: exact accounting ok; multi-window ok "
              f"({st['windows']} windows)")

    # ---- 15. the two flagships through the CLI --------------------------
    phase_start(15)
    ik_means = ppm_channel_means(os.path.join(out_dir,
                                              "cornellBox_flagship.ppm"))
    flag = {}
    for sched in ("queue", "positional"):
        reset_counts()
        buf = io.StringIO()
        image = os.path.join(out_dir, f"cornellBox_{sched}.ppm")
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-S", "6", "--schedule", sched, "-o", image,
                           "--stats", "--quiet"])
        check(rc == 0, f"cli.main --schedule {sched} returned {rc}")
        fs = json.loads(buf.getvalue().strip().splitlines()[-1])
        fs["launches"] = (bounce.launches_fused, harvest.launches_rows,
                          bounce.launches_fused_pos)
        flag[sched] = fs
        ratio = fs["segments"] / fs["paths"]
        means = ppm_channel_means(image)
        ws = fs["window_s"]
        print(f"[15] flagship cornellBox 600x600 100spp depth 50, 131072 "
              f"lanes, schedule {sched}, on {card}: paths {fs['paths']}, "
              f"segments {fs['segments']} ({ratio:.4f}/path), "
              f"{fs['rays_per_s']:.6g} rays/s, elapsed {fs['elapsed_s']:.4f} "
              f"s, windows {fs['windows']}, occupancy {fs['occupancy']:.4f}, "
              f"nonfinite {fs['nonfinite']}; launches K6 {fs['launches'][0]} "
              f"K7 {fs['launches'][1]} K8 {fs['launches'][2]} K1 "
              f"{bounce.launches}; host s per window dispatch min "
              f"{min(ws):.4f} max {max(ws):.4f}; image channel means "
              f"{np.round(means, 5).tolist()} vs queue_ik "
              f"{np.round(ik_means, 5).tolist()}")
        check(fs["schedule"] == sched, f"{sched}: stats say {fs['schedule']}")
        check(fs["paths"] == 36_000_000, f"{sched}: paths != 36,000,000")
        check(fs["nonfinite"] == 0, f"{sched}: non-finite pixels")
        check(2.78 <= ratio <= 3.08, f"{sched}: segments/path {ratio}")
        check(np.abs(means - ik_means).max() <= 1e-2,
              f"{sched}: image channel means differ from queue_ik's by more "
              f"than 1e-2")
        check(bounce.launches == 0, f"{sched}: the render launched K1")
    k6_launches, k7_launches, _ = flag["queue"]["launches"]
    k8_launches = flag["positional"]["launches"][2]
    q_calls = q_outer * flag["queue"]["windows"]
    check(k6_launches == q_calls and k7_launches == flag["queue"]["windows"],
          "queue flagship: K6/K7 launches do not match calls and windows")
    check(k8_launches == q_outer * flag["positional"]["windows"]
          and flag["positional"]["launches"][:2] == (0, 0),
          "positional flagship: K8 launches do not match its calls")

    # ---- 16. timings of K6 and K8, and the schedules' device time -------
    phase_start(16)
    # steady state: a few refilled calls age the pool
    st6 = regen._init_state(n, dev)
    o6 = bounce.FusedOut.empty(n, n_inner, dev)
    o6.state = st6
    nxt6 = 0
    for _ in range(8):
        r6 = queue_refill(st6, nxt6, total)
        nxt6 += int(r6[0].sum())
        bounce.bounce_fused(tables, statics, cam_row, bg, seed6, *st6, *r6,
                            out=o6, **fkw)
    r6 = queue_refill(st6, nxt6, total)
    st6 = [x.clone() for x in st6]
    o6 = bounce.FusedOut.empty(n, n_inner, dev)
    run_k6 = lambda: bounce.bounce_fused(
        tables, statics, cam_row, bg, seed6, *st6, *r6, out=o6, **fkw)
    k6_ms = time_ms(run_k6, 20)
    segs6 = int(o6.seg.sum())
    k6_plain_ms = time_ms(lambda: bounce.bounce_fused_ref(
        tables, statics, cam_row, bg, seed6, *st6, *r6, out=o6, **fkw), 3)
    refill_ms = time_ms(lambda: queue_refill(st6, nxt6, total), 20)
    table_bytes = sum(t.numel() * 4 for t in tables)

    k6_bound, k6_by = fused_bound(n * (36 + 20 + 36) + n_inner * n * 16
                                  + table_bytes, segs6)
    print(f"[16] K6 {n} lanes x {n_inner} levels ({segs6} segments, "
          f"{int(r6[0].sum())} starts): kernel {k6_ms:.4f} ms, plain "
          f"{k6_plain_ms:.3f} ms, bound {k6_bound:.4f} ms ({k6_by}); the "
          f"refill's plain tensor code before each call {refill_ms:.4f} ms; "
          f"on {card}")
    quota, lane_base, first_pix, G = regen.pos_tables(npix, 100, n)
    st8 = regen._init_state_pos(n, dev, quota, lane_base, 100, 600)
    o8 = bounce.FusedOut.empty(n, n_inner, dev, positional=True)
    o8.state = st8
    seed8f = torch.tensor([13579, n_inner], dtype=torch.int32, device=dev)
    for _ in range(8):
        bounce.bounce_fused_pos(tables, statics, cam_row, bg, seed8f, *st8,
                                out=o8, **pkw)
    st8 = [x.clone() for x in st8]
    o8 = bounce.FusedOut.empty(n, n_inner, dev, positional=True)
    run_k8 = lambda: bounce.bounce_fused_pos(
        tables, statics, cam_row, bg, seed8f, *st8, out=o8, **pkw)
    k8_ms = time_ms(run_k8, 20)
    segs8 = int(o8.seg.sum())
    starts8 = int(o8.rec[7].sum())
    k8_plain_ms = time_ms(lambda: bounce.bounce_fused_pos_ref(
        tables, statics, cam_row, bg, seed8f, *st8, out=o8, **pkw), 3)
    k8_bound, k8_by = fused_bound(
        n * (56 + 56) + n_inner * n * 32 + table_bytes, segs8)
    print(f"[16] K8 {n} lanes x {n_inner} levels ({segs8} segments, "
          f"{starts8} starts, G = {G} pixel slots per lane): kernel "
          f"{k8_ms:.4f} ms, plain {k8_plain_ms:.3f} ms, bound {k8_bound:.4f} "
          f"ms ({k8_by}) on {card}")
    # K6 and K8 on the new scenes, at their registry cadence, on aged pools
    for sc in NEW_SCENES:
        _, cam_s, tab_s, st_s, row_s, bg_s, _ = cornell_inputs(dev, 8,
                                                               scene=sc)
        cad_s, sq_s = cam_s.regen_cadence, cam_s.spp_sqrt
        total_s = npix * sq_s * sq_s
        f_kw = dict(has_defocus=False, max_depth=50, n_inner=cad_s)
        tb_bytes = sum(t.numel() * 4 for t in tab_s)
        nxt_s = [0]

        def refill_s(st_):
            r_ = regen.queue_refill_planes(
                torch.tensor(nxt_s[0], device=dev), st_[7], total_s,
                width=600, npix=npix, sqrt_spp=sq_s)
            nxt_s[0] += int(r_[0].sum())
            return r_

        o6s = bounce.FusedOut.empty(n, cad_s, dev)
        st6s = aged_state(lambda st_: bounce.bounce_fused(
            tab_s, st_s, row_s, bg_s, seed6, *st_, *refill_s(st_), out=o6s,
            **f_kw)[3:], regen._init_state(n, dev))
        r6s = refill_s(st6s)
        k6s = time_ms(lambda: bounce.bounce_fused(
            tab_s, st_s, row_s, bg_s, seed6, *st6s, *r6s, out=o6s, **f_kw),
            20)
        segs6s = int(o6s.seg.sum())
        k6s_plain = time_ms(lambda: bounce.bounce_fused_ref(
            tab_s, st_s, row_s, bg_s, seed6, *st6s, *r6s, out=o6s, **f_kw), 3)
        b6s = fused_bound(n * (36 + 20 + 36) + cad_s * n * 16 + tb_bytes,
                          segs6s, sc)
        q_s, lb_s, _, _ = regen.pos_tables(npix, sq_s * sq_s, n)
        o8s = bounce.FusedOut.empty(n, cad_s, dev, positional=True)
        p_kw = dict(width=600, sqrt_spp=sq_s, **f_kw)
        seed8s = torch.tensor([13579, cad_s], dtype=torch.int32, device=dev)
        st8s = aged_state(lambda st_: bounce.bounce_fused_pos(
            tab_s, st_s, row_s, bg_s, seed8s, *st_, out=o8s, **p_kw)[3:],
            regen._init_state_pos(n, dev, q_s, lb_s, sq_s * sq_s, 600))
        k8s = time_ms(lambda: bounce.bounce_fused_pos(
            tab_s, st_s, row_s, bg_s, seed8s, *st8s, out=o8s, **p_kw), 20)
        segs8s = int(o8s.seg.sum())
        k8s_plain = time_ms(lambda: bounce.bounce_fused_pos_ref(
            tab_s, st_s, row_s, bg_s, seed8s, *st8s, out=o8s, **p_kw), 3)
        b8s = fused_bound(n * (56 + 56) + cad_s * n * 32 + tb_bytes, segs8s,
                          sc)
        print(f"[16] {sc}: K6 {n} lanes x {cad_s} levels ({segs6s} "
              f"segments): kernel {k6s:.4f} ms, plain {k6s_plain:.3f} ms, "
              f"bound {b6s[0]:.4f} ms ({b6s[1]}); K8 ({segs8s} segments) "
              f"kernel {k8s:.4f} ms, plain {k8s_plain:.3f} ms, bound "
              f"{b8s[0]:.4f} ms ({b8s[1]}) on {card}")
    # profiled at 25 spp (the flagship's 100 CUT for the script's time: the
    # profile's post-processing grows with the positional reverse scan's
    # ~10,000 launches per window)
    pcam = registry.cornell_box()[1]
    pcam.samples_per_pixel = 25
    for sched, own in (("queue", ("bounce_fused_levels", "count_starts",
                                  "scan_counts", "harvest_rows")),
                       ("positional", ("bounce_fused_pos_levels",))):
        with torch.profiler.profile(activities=acts) as prof_s:
            _, pst = regen.render_regen(fscene, pcam, seed=4, schedule=sched,
                                        device=dev)
        us = device_times(prof_s)
        if not us:
            print(f"[16] {sched}: profiler reported no device time: busy "
                  f"share not measured")
            continue
        own_us = {k: sum(v for kk, v in us.items() if kernel_of(kk, k))
                  for k in own}
        top = sorted(us.items(), key=lambda kv: -kv[1])[:8]
        print(f"[16] {sched}, cornellBox at 25 spp under the profiler (seed "
              f"4): loop {pst['elapsed_s']:.4f} s (the 100-spp flagship "
              f"{flag[sched]['elapsed_s']:.4f} s unprofiled), windows "
              f"{pst['windows']}; device busy "
              f"{sum(us.values()) / 1e6:.4f} s (incl. set-up and readback); "
              f"the port's kernels, ms (total / per wrapper call): "
              + ", ".join(
                  f"{k} {v / 1e3:.3f} / "
                  f"{v / 1e3 / (pst['windows'] * (1 if k in ('count_starts', 'scan_counts', 'harvest_rows') else q_outer)):.5f}"
                  for k, v in own_us.items())
              + "; top device events, ms: " + ", ".join(
                  f"{k[:44]} {v / 1e3:.2f}" for k, v in top))

    # ---- 17. K9: the direct-record queue --------------------------------
    phase_start(17)
    n, n_inner = 1 << 17, 8
    _, _, tables, statics, cam_row, bg, state = cornell_inputs(dev, n)
    kw17 = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=600,
                sqrt_spp=10, npix=npix)
    seed17 = torch.tensor([-123456789, 1, 1000, npix * 100],
                          dtype=torch.int32, device=dev)
    base17, rows17 = 5, 24
    base17_dev = torch.tensor([base17], dtype=torch.int32, device=dev)
    lv17 = slice(base17, base17 + n_inner)

    def marked_bufs():
        return [torch.full((rows17, n), -7.5, device=dev) for _ in range(3)] \
            + [torch.full((rows17, n), -9, dtype=torch.int32, device=dev)]

    kb17, k9o = marked_bufs(), bounce.FusedQOut.empty(n, n_inner, dev)
    bounce.launches_direct = 0
    bounce.bounce_fused_q_direct(tables, statics, cam_row, bg, seed17,
                                 base17_dev, kb17, *state, out=k9o, **kw17)
    k1o = bounce.FusedQOut.empty(n, n_inner, dev)
    bounce.bounce_fused_q(tables, statics, cam_row, bg, seed17, *state,
                          out=k1o, **kw17)
    torch.cuda.synchronize()
    check(bounce.launches_direct == 1, "K9 was not launched once")
    untouched = all(bool((b[:base17] == b[0, 0]).all())
                    and bool((b[base17 + n_inner:] == b[0, 0]).all())
                    for b in kb17)
    same17 = all(torch.equal(b[lv17], r) for b, r in zip(kb17, k1o.rec)) \
        and all(torch.equal(getattr(k9o, f), getattr(k1o, f))
                for f in ("seg", "take", "base", "cursor")) \
        and all(torch.equal(a, b) for a, b in zip(k9o.state, k1o.state))
    check(untouched and same17, "K9 differs from K1 on the same inputs, or "
          "wrote outside its rows")
    pb17, p9o = marked_bufs(), bounce.FusedQOut.empty(n, n_inner, dev)
    bounce.bounce_fused_q_direct_ref(tables, statics, cam_row, bg, seed17,
                                     base17_dev, pb17, *state, out=p9o,
                                     **kw17)
    fl_k, fl_p = kb17[3][lv17], pb17[3][lv17]
    check(torch.equal(fl_k[0] & 4, fl_p[0] & 4)
          and torch.equal(fl_k[0] >> 3, fl_p[0] >> 3)
          and k9o.take[0].item() == p9o.take[0].item(),
          "K9: level-0 starts, their ranks or the take count differ")
    fl_mis9 = ((fl_k & 7) != (fl_p & 7)).float().mean().item()
    close9 = torch.ones_like(fl_k, dtype=torch.bool)
    for a, b in zip(kb17[:3], pb17[:3]):
        close9 &= torch.isclose(a[lv17], b[lv17], rtol=K1_RTOL, atol=K1_ATOL,
                                equal_nan=True)
    v_mis9 = (~close9).float().mean().item()
    agree9 = fl_k[0] == fl_p[0]
    k9_err = max((a[base17] - b[base17])[agree9].abs().max().item()
                 for a, b in zip(kb17[:3], pb17[:3]))
    print(f"[17] K9 at {n} lanes x {n_inner} levels, rows {base17}.."
          f"{base17 + n_inner - 1} of a {rows17}-row buffer: equal to K1 bit "
          f"for bit (records, counts, bases, cursor, state), other rows "
          f"untouched; vs plain: mismatch FL {fl_mis9:.2e} V {v_mis9:.2e} "
          f"(limit {K1_MISMATCH_FRAC}, rtol=atol={K1_RTOL}), level-0 V max "
          f"abs err {k9_err:.3e}")
    check(fl_mis9 <= K1_MISMATCH_FRAC and v_mis9 <= K1_MISMATCH_FRAC,
          "K9 differs from its plain version beyond K1's tolerances")
    del kb17, pb17, k1o, p9o
    # one flagship window through K1 and through K9
    d1 = fcam.max_depth + 1
    total = npix * 100
    refill17 = regen._auto_refill(total, n, d1, n_inner, fcam)
    window17 = -(-(refill17 + d1) // n_inner) * n_inner
    win = {}
    for direct in (False, True):
        wb = regen.WindowBuffers.empty(n, window17 // n_inner, n_inner, dev)
        for r in wb.rec + [wb.seg]:
            r.zero_()
        acc17 = torch.zeros((total + n, 3), dtype=torch.float32, device=dev)
        _, _, cur = regen._window_impl(
            tables, statics, cam_row, bg, acc17, regen._init_state(n, dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            regen.window_seeds(0, 0, window17 // n_inner), 0, total,
            width=600, npix=npix, sqrt_spp=10, window=window17,
            refill=refill17, cadence=n_inner, max_depth=50,
            max_contribution=fcam.max_contribution, bufs=wb,
            direct_rec=direct)
        torch.cuda.synchronize()
        win[direct] = (cur.cpu(), wb, acc17)
    (c0, w0, a0), (c1, w1, a1) = win[False], win[True]
    # The loop notices the drain from an event it polls without waiting, so
    # how many calls run after the first drained one follows the host's
    # pace; those calls trace nothing, and the levels recorded are counted
    # on the device up to the first drained call. So the two windows'
    # counts (cursor, segments, levels) are equal, and so are the records,
    # bases and counts over those levels; a surplus call is empty.
    s_run17 = int(c0[2])
    calls17 = s_run17 // n_inner
    same_win = torch.equal(c0, c1) and all(
        torch.equal(x[:s_run17], y[:s_run17]) for x, y in zip(w0.rec, w1.rec)) \
        and all(torch.equal(getattr(w0, f)[:calls17], getattr(w1, f)[:calls17])
                for f in ("base", "seg", "take")) and torch.equal(a0, a1) \
        and not w0.seg[calls17:].any() and not w1.seg[calls17:].any()
    print(f"[17] flagship window ({window17} levels, refill {refill17}) "
          f"through K1 and through K9: {int(c0[2])} / {int(c1[2])} levels "
          f"recorded, {int(c0[0])} items, {int(c0[1])} segments; records, "
          f"bases, counts and accumulator over those levels equal bit for "
          f"bit, no segment after them: {same_win}")
    check(same_win, "the flagship window differs between K1 and K9")
    del win, w0, w1, a0, a1
    # the flagship through the CLI with --direct-rec
    reset_counts()
    buf = io.StringIO()
    image9 = os.path.join(out_dir, "cornellBox_direct_rec.ppm")
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-S", "6", "--direct-rec", "-o", image9, "--stats",
                       "--quiet"])
    check(rc == 0, f"cli.main --direct-rec returned {rc}")
    s9 = json.loads(buf.getvalue().strip().splitlines()[-1])
    k9_launches = bounce.launches_direct
    ratio9 = s9["segments"] / s9["paths"]
    with open(image9, "rb") as fa, open(os.path.join(
            out_dir, "cornellBox_flagship.ppm"), "rb") as fb:
        same9 = fa.read() == fb.read()
    print(f"[17] flagship cornellBox 600x600 100spp depth 50, 131072 lanes, "
          f"--direct-rec, on {card}: paths {s9['paths']}, segments "
          f"{s9['segments']} ({ratio9:.4f}/path; the K1 run: "
          f"{flag5['segments']}), elapsed {s9['elapsed_s']:.4f} s, windows "
          f"{s9['windows']}; launches K9 {k9_launches} K1 {bounce.launches} "
          f"K2 {harvest.launches}; image file identical to the K1 run's: "
          f"{same9}")
    check(s9["paths"] == 36_000_000 and s9["nonfinite"] == 0
          and 2.78 <= ratio9 <= 3.08 and s9["direct_rec"],
          "--direct-rec flagship: paths, non-finite pixels or segments/path")
    check(s9["segments"] == flag5["segments"],
          "--direct-rec flagship: segments differ from the K1 run's")
    check(k9_launches > 0 and bounce.launches == 0 and harvest.launches > 0,
          "--direct-rec flagship did not go through K9 and K2 alone")

    # ---- 18. K10, K11 and K12 at the scene-8 level ---------------------
    phase_start(18)
    o8, d8 = rays8
    # K10: every round of one fused binned_closest against the plain version
    calls10 = []
    real_round = stream.stream_round_rows

    def spy10(*a):
        out_ = real_round(*a)
        calls10.append((a, out_))
        return out_

    stream.stream_round_rows = spy10
    try:
        c10 = {}
        ft8, fi8 = trace.binned_closest(ms, o8, d8, cap8, alive8,
                                        b1_fused=True, counters=c10)
    finally:
        stream.stream_round_rows = real_round
    torch.cuda.synchronize()
    check(len(calls10) == c10["rounds"] > 0, "K10: no round ran")
    k10_err = 0.0
    for a, k_out in calls10:
        p_out = stream.stream_round_rows_ref(*a)
        check(all(torch.equal(x, y) for x, y in zip(k_out, p_out)),
              "K10 differs from its plain version (t, idx, key or bits)")
        k10_err = max(k10_err, (k_out[0] - p_out[0]).abs().nan_to_num(0.0)
                      .max().item())
    check(c10 == counters7 and torch.equal(fi8, bi8) and torch.equal(ft8, bt8),
          f"K10's route differs from the unfused binned route ({c10} vs "
          f"{counters7})")
    k10_rounds = [a for a, _ in calls10]
    k10_args = k10_rounds[0]
    print(f"[18] K10 vs plain on the {len(calls10)} rounds of one fused "
          f"binned_closest: t, idx, next key and bits equal bit for bit; the "
          f"same rounds ({c10['rounds']}) and host reads ({c10['host_reads']})"
          f" as the unfused route, and bit-equal (t, idx)")
    del calls10
    # K11 on the level's coherence-sorted rays
    key11 = torch.where(cap0 > 0, trace.coherence_key(bvh, o8, d8),
                        0x7FFFFFFF)
    perm11 = torch.sort(key11).indices
    k11_args = (bvh.cl2_lines, bvh.cl2_lo, bvh.cl2_hi, bvh.cl2_gs,
                *(x[perm11, k].contiguous() for x in (o8, d8)
                  for k in range(3)),
                cap0[perm11].contiguous(),
                torch.full((n8,), -1, dtype=torch.int32, device=dev))
    rounds11 = torch.zeros(n8 // stream2.UNIT, dtype=torch.int32, device=dev)
    kt11, ki11 = stream2.stream2_rows(*k11_args, rounds=rounds11)
    torch.cuda.synchronize()
    work11 = {}
    pt11, pi11 = stream2.stream2_rows_ref(*k11_args, work=work11)
    check(torch.equal(ki11, pi11) and torch.equal(kt11, pt11),
          "K11 differs from its plain version")
    check(torch.equal(rounds11.long(), work11["rounds"]),
          "K11's rounds per unit differ from its plain version's")
    k11_err = (kt11 - pt11).abs().nan_to_num(0.0).max().item()
    r11 = rounds11.float()
    # the same traversal on the earlier kernel's schedule (blocks of 128
    # rays, a window of 32 clusters): the same winners, its own rounds and
    # work
    work128 = {}
    pt128, pi128 = stream2.stream2_rows_ref(*k11_args, unit=128, range_w=32,
                                            work=work128)
    check(torch.equal(pi128, pi11) and torch.equal(pt128, pt11),
          "K11's plain version on the earlier schedule finds other winners")
    r128 = work128["rounds"].float()
    print(f"[18] K11 vs plain at {n8} coherence-sorted rays ("
          f"{bvh.cl2_lo.shape[0]} cl2 clusters, {n8 // stream2.UNIT} units of "
          f"{stream2.UNIT}, window {stream2.RANGE_W}, {stream2.TEAM} warps "
          f"per unit): idx equal, t bit for bit, rounds per unit "
          f"equal (mean {r11.mean().item():.2f}, max {int(r11.max())}); work "
          f"{work11['box_tests']} box tests, {work11['group_tests']} ray-group"
          f" tests; in blocks of 128 with a window of 32: the same winners, "
          f"rounds per block mean"
          f" {r128.mean().item():.2f} max {int(r128.max())}, work "
          f"{work128['box_tests']} box tests, {work128['group_tests']} "
          f"ray-group tests")
    # K12 on the walk route's sorted rays
    keyw = torch.where(alive8, trace.coherence_key(bvh, o8, d8), 0x7FFFFFFF)
    permw = torch.sort(keyw).indices
    k12_args = (bvh.bvh_nodes, bvh.bvh_tris, o8[permw].contiguous(),
                d8[permw].contiguous(), cap0[permw].contiguous())
    kt12, ki12 = traverse.bvh_closest(*k12_args, n_nodes=bvh.n_nodes)
    torch.cuda.synchronize()
    visits12 = {}
    pt12, pi12 = traverse.bvh_closest_ref(*k12_args, n_nodes=bvh.n_nodes,
                                          visits=visits12)
    check(torch.equal(ki12, pi12) and torch.equal(kt12, pt12),
          "K12 differs from its plain version")
    k12_err = (kt12 - pt12).abs().nan_to_num(0.0).max().item()
    print(f"[18] K12 vs plain at {n8} sorted rays ({bvh.n_nodes} nodes, leaf "
          f"size {bvh.leaf_size}): idx equal, t bit for bit; walk work "
          f"{visits12['node_visits']} node visits, {visits12['tri_tests']} "
          f"triangle tests")
    # the five routes' winners at this level
    routes18 = {
        "binned": (bt8, bi8), "binned+b1_fused": (ft8, fi8),
        "binned2": trace.mesh_closest(ms, o8, d8, cap8, alive8,
                                      mesh="binned2"),
        "walk": (kt5, ki5),
        "walk+bvh2": trace.mesh_closest(ms, o8, d8, cap8, alive8,
                                        mesh="walk", traverse8=False)}
    torch.cuda.synchronize()
    differ = torch.zeros(n8, dtype=torch.bool, device=dev)
    for name, (t_, i_) in routes18.items():
        differ |= (i_ != ki5) | (t_ != kt5)
    lanes18 = torch.nonzero(differ)[:, 0].tolist()
    print(f"[18] five routes at {n8} lanes against K5's winners: "
          f"{len(lanes18)} lane(s) where two differ"
          + "".join(f"\n[18]   lane {k}: " + ", ".join(
              f"{name} t {t_[k].item():.9g} idx {int(i_[k])}"
              for name, (t_, i_) in routes18.items()) for k in lanes18[:50]))
    check(len(lanes18) <= 1e-3 * n8,
          "the five routes differ on more than 1e-3 of the lanes")
    # Where the routes part in a whole render: one uncut window (255
    # levels, 204 of them refilling) on the walk route, and at every level
    # the same rays, caps and live lanes through binned2 and the binary BVH
    # walk too. A lane whose winners differ is a tie when both t are equal
    # (two triangles at one distance: each route keeps the first it meets)
    # and a fault otherwise (a route missed the nearer triangle).
    ctxw = regen.MeshContext.build(scene8, cam8, dev, mesh="walk")
    real_mc = trace.mesh_closest
    parts = {"levels": 0, "lanes": 0, "first": None, "k5_levels": 0,
             "binned2": [0, 0], "walk+bvh2": [0, 0]}   # [ties, non-ties]

    def mc_spy(ms_, o_, d_, t_cap=None, alive=None, **kw):
        t_w, i_w = real_mc(ms_, o_, d_, t_cap, alive, **kw)
        if parts["levels"] % 32 == 0:
            # K5 against its plain version on this level, the rays as they
            # lie and sorted as the walk route sorts them
            c_ = torch.where(alive, t_cap, 0.0)
            key_ = torch.where(alive, trace.coherence_key(bvh, o_, d_),
                               0x7FFFFFFF)
            p_ = torch.sort(key_).indices
            where = f"phase 18's window, level {parts['levels']}"
            k5_vs_plain(o_, d_, c_, where)
            k5_vs_plain(o_[p_].contiguous(), d_[p_].contiguous(),
                        c_[p_].contiguous(), where + ", sorted")
            parts["k5_levels"] += 1
        parts["levels"] += 1
        parts["lanes"] += int(alive.sum())
        for name, rk in (("binned2", dict(mesh="binned2")),
                         ("walk+bvh2", dict(mesh="walk", traverse8=False))):
            t_r, i_r = real_mc(ms_, o_, d_, t_cap, alive, **rk)
            diff = (i_r != i_w) | (t_r != t_w)
            tie = diff & (t_r == t_w)
            parts[name][0] += int(tie.sum())
            parts[name][1] += int((diff & ~tie).sum())
            if parts["first"] is None and bool(diff.any()):
                k = int(torch.nonzero(diff)[0, 0])
                ids = torch.tensor([max(int(i_w[k]), 0), max(int(i_r[k]), 0)],
                                   device=dev)
                t_mt, _, _, ok_mt = trace.tri_hit_gathered(
                    ms_.triangles, ids, o_[k].expand(2, 3), d_[k].expand(2, 3),
                    -float("inf"), float("inf"))
                parts["first"] = (
                    f"level {parts['levels'] - 1}, lane {k}: walk t "
                    f"{t_w[k].item():.9g} idx {int(i_w[k])}, {name} t "
                    f"{t_r[k].item():.9g} idx {int(i_r[k])}; cap "
                    f"{t_cap[k].item():.9g}; the plain Moller-Trumbore of "
                    f"the two triangles: t {t_mt[0].item():.9g} / "
                    f"{t_mt[1].item():.9g}, hit {bool(ok_mt[0])} / "
                    f"{bool(ok_mt[1])}")
        return t_w, i_w

    bufs18 = regen.WindowBuffers.empty(n8, window8, 1, dev)
    acc18 = torch.zeros((SCENE8_PATHS + n8, 3), dtype=torch.float32,
                        device=dev)
    # the spy reads the host at every level: the levels run eagerly
    ctxw.graph = False
    trace.mesh_closest = mc_spy
    try:
        _, _, s_run18 = regen._mesh_window(
            ctxw, acc18, regen._init_state_mesh(n8, dev), 0,
            regen.window_generator(0, 0, dev), SCENE8_PATHS, window=window8,
            refill=refill8, max_depth=cam8.max_depth,
            max_contribution=cam8.max_contribution, bufs=bufs18, **geo)
    finally:
        trace.mesh_closest = real_mc
    del bufs18, acc18
    print(f"[18] one uncut scene-8 window on the walk route ({parts['levels']}"
          f" levels, {parts['lanes']} live lanes), the same rays through "
          f"binned2 and the binary BVH walk: lanes whose winner differs from "
          f"the walk's (ties / non-ties) binned2 {parts['binned2'][0]} / "
          f"{parts['binned2'][1]}, walk+bvh2 {parts['walk+bvh2'][0]} / "
          f"{parts['walk+bvh2'][1]}; first: {parts['first']}; K5 equal to "
          f"its plain version (idx, t bit for bit) on {parts['k5_levels']} "
          f"of its levels, the rays as they lie and sorted")
    check(parts["levels"] == s_run18 > refill8,
          "the route comparison did not see every level of the window")

    # ---- 19. renders of the new routes through the CLI ------------------
    phase_start(19)
    walk25_means = ppm_channel_means(os.path.join(out_dir,
                                                  "modelExample_walk25.ppm"))

    def held_to(name, st_, image, ref, ref_image, ref_means):
        means = ppm_channel_means(os.path.join(out_dir, image))
        with open(os.path.join(out_dir, image), "rb") as fa, \
                open(os.path.join(out_dir, ref_image), "rb") as fb:
            same = fa.read() == fb.read()
        seg_rel = abs(st_["segments"] - ref["segments"]) / ref["segments"]
        print(f"[19] {name}: segments {st_['segments']} vs walk "
              f"{ref['segments']} (rel {seg_rel:.2e}), channel means "
              f"{np.round(means, 5).tolist()} vs {np.round(ref_means, 5).tolist()}"
              f", image file identical: {same}")
        check(st_["paths"] == ref["paths"] and st_["nonfinite"] == 0,
              f"{name}: paths or non-finite pixels")
        check(seg_rel <= 1e-3 and np.abs(means - ref_means).max() <= 1e-2,
              f"{name}: segments beyond 1e-3 or channel means beyond 1e-2 of "
              f"the walk route's")

    # phase 10's `--mesh binned` render, held to the default route's (the
    # walk) the same way
    held_to("binned, 25 spp", s8, "modelExample_binned25.ppm", s8w25,
            "modelExample_walk25.ppm", walk25_means)
    # the binned2 route at 25 spp (5x5 strata, the full frame), held to the
    # walk route's 25-spp render, then uncut below
    reset_counts()
    s8b2 = run_cli8(["--mesh", "binned2", "--spp", "25"],
                    "modelExample_binned2_25.ppm")
    k11_launches = stream2.launches
    print(f"[19] modelExample 600x337 at 25 spp, depth 50, "
          f"{s8b2['lanes']} lanes, binned2 route, on {card}: "
          f"paths {s8b2['paths']}, segments {s8b2['segments']}, "
          f"{s8b2['rays_per_s']:.6g} rays/s, elapsed {s8b2['elapsed_s']:.3f} "
          f"s, windows {s8b2['windows']}, levels {s8b2['levels']}, occupancy "
          f"{s8b2['occupancy']:.4f}; launches K11 {k11_launches} K3 "
          f"{bounce.launches_bounce} K2 {harvest.launches} K4 "
          f"{stream.launches} K10 {stream.launches_round} K5 "
          f"{traverse8.launches} K12 {traverse.launches}")
    check(s8b2["mesh"]["route"] == "binned2", "binned2: stats name another "
          "route")
    check(k11_launches == s8b2["levels_run"] > 0
          and bounce.launches_bounce == s8b2["levels_run"]
          and harvest.launches == s8b2["windows"]
          and stream.launches + stream.launches_round + traverse8.launches
          + traverse.launches == 0,
          "binned2 render did not go through K11 once per level, K3 and K2 "
          "alone")
    held_to("binned2, 25 spp", s8b2, "modelExample_binned2_25.ppm", s8w25,
            "modelExample_walk25.ppm", walk25_means)
    # the slice's main path at the full registry configuration (600x337,
    # 250 spp = 225 strata, depth 50, 131,072 lanes), held to phase 10's
    # uncut walk render
    reset_counts()
    s8b2u = run_cli8(["--mesh", "binned2"], "modelExample_binned2.ppm")
    k11_launches = stream2.launches
    print(f"[19] flagship modelExample 600x337 250spp (225 strata) depth 50,"
          f" {s8b2u['lanes']} lanes, binned2 route (main path), on {card}: "
          f"paths {s8b2u['paths']}, segments {s8b2u['segments']}, "
          f"{s8b2u['rays_per_s']:.6g} rays/s, elapsed "
          f"{s8b2u['elapsed_s']:.3f} s, windows {s8b2u['windows']}, levels "
          f"{s8b2u['levels']}, occupancy {s8b2u['occupancy']:.4f}; launches "
          f"K11 {k11_launches} K3 {bounce.launches_bounce} K2 "
          f"{harvest.launches}")
    check(s8b2u["paths"] == SCENE8_PATHS and s8b2u["mesh"]["route"]
          == "binned2", "binned2 flagship: paths or route")
    check(k11_launches == s8b2u["levels_run"] > 0
          and bounce.launches_bounce == s8b2u["levels_run"]
          and harvest.launches == s8b2u["windows"]
          and stream.launches + stream.launches_round + traverse8.launches
          + traverse.launches == 0,
          "binned2 flagship did not go through K11 once per level, K3 and K2 "
          "alone")
    held_to("binned2, uncut", s8b2u, "modelExample_binned2.ppm", s8w,
            "modelExample_walk.ppm", ppm_channel_means(
                os.path.join(out_dir, "modelExample_walk.ppm")))
    reset_counts()
    s8f = run_cli8(["--b1-fused", "--spp", "25"], "modelExample_fused25.ppm")
    k10_launches = stream.launches_round
    print(f"[19] modelExample 600x337 at 25 spp, binned + b1_fused, on {card}:"
          f" elapsed {s8f['elapsed_s']:.3f} s, levels {s8f['levels']}, rounds "
          f"{s8f['mesh']['rounds']}, host reads {s8f['mesh']['host_reads']}; "
          f"launches K10 {k10_launches} K4 {stream.launches}")
    check(k10_launches == s8f["mesh"]["rounds"] > 0 and stream.launches == 0
          and s8f["mesh"]["route"] == "binned+b1_fused",
          "--b1-fused render did not go through K10 alone")
    held_to("binned + b1_fused, 25 spp", s8f, "modelExample_fused25.ppm",
            s8w25, "modelExample_walk25.ppm", walk25_means)
    reset_counts()
    s8t = run_cli8(["--mesh", "walk", "--no-traverse8", "--spp", "25"],
                   "modelExample_bvh2_25.ppm")
    k12_launches = traverse.launches
    print(f"[19] modelExample 600x337 at 25 spp, walk on the binary BVH, on "
          f"{card}: elapsed {s8t['elapsed_s']:.3f} s, levels {s8t['levels']};"
          f" launches K12 {k12_launches} K5 {traverse8.launches}")
    check(k12_launches == s8t["levels_run"] > 0 and traverse8.launches == 0
          and s8t["mesh"]["route"] == "walk+bvh2",
          "--no-traverse8 render did not go through K12 alone")
    held_to("walk + bvh2, 25 spp", s8t, "modelExample_bvh2_25.ppm", s8w25,
            "modelExample_walk25.ppm", walk25_means)

    # ---- 20. timings of K9-K12 with their bounds ------------------------
    phase_start(20)
    st9 = [x.clone() for x in st0]
    k9_bufs = regen.WindowBuffers.empty(n, 2, n_inner, dev).rec
    o9 = bounce.FusedQOut.empty(n, n_inner, dev)
    base9 = torch.zeros(1, dtype=torch.int32, device=dev)
    k9_ms = time_ms(lambda: bounce.bounce_fused_q_direct(
        tables, statics, cam_row, bg, seed4, base9, k9_bufs, *st9, out=o9,
        **kw17), 20)
    segs9 = int(o9.seg.sum())
    k9_plain_ms = time_ms(lambda: bounce.bounce_fused_q_direct_ref(
        tables, statics, cam_row, bg, seed4, base9, k9_bufs, *st9, out=o9,
        **kw17), 3)
    k9_bytes = n * (36 + 36) + n_inner * n * 16 \
        + sum(t.numel() * 4 for t in tables)
    k9_bound, k9_by = fused_bound(k9_bytes, segs9)
    print(f"[20] K9 {n} lanes x {n_inner} levels ({segs9} segments): kernel "
          f"{k9_ms:.4f} ms, plain {k9_plain_ms:.3f} ms, bound {k9_bound:.4f} ms"
          f" ({k9_by}; K1's bytes) on {card}")

    def bound_of(nbytes, ops):
        b, o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        return max(b, o) * 1e3, "bytes" if b >= o else "operations"

    # K10 on every round of phase 18's fused call (the same rounds as phase
    # 11's K4 rounds), each beside its bound
    k10_per = [time_ms(lambda a=a: real_round(*a), 20) for a in k10_rounds]
    k10_ms = k10_per[0]
    k10_plain_ms = time_ms(lambda: stream.stream_round_rows_ref(*k10_args), 1,
                           warmup=0)
    k_cl = bvh.cl_lo.shape[0]
    n_mask = (k_cl + 31) // 32

    def k10_bound_of(a):
        n_r = a[7].numel()
        tests = int((a[4] - a[3]).clamp(min=0).long().sum()) * 8 * stream.BLOCK
        return bound_of(
            bvh.cl_lines.numel() * 4 + n_r * (8 * 4 + 8)
            + 16 * (n_r // stream.BLOCK) + n_r * 4 * (3 + n_mask),
            tests * MT_OPS + n_r * k_cl * BOX_OPS) + (tests,)

    k10_bounds = [k10_bound_of(a) for a in k10_rounds]
    k10_bound, k10_by, k10_tests = k10_bounds[0]
    n10 = k10_args[7].numel()
    print(f"[20] K10 round 0 at {n10} rays ({k10_tests} ray-triangle tests, "
          f"{k_cl} boxes per ray): kernel {k10_ms:.4f} ms, plain "
          f"{k10_plain_ms:.2f} ms, bound {k10_bound:.5f} ms ({k10_by}) on "
          f"{card}")
    print(f"[20] K10 on every round of that fused binned_closest, on {card}: "
          f"{[round(x, 4) for x in k10_per]} ms (K4 on the same rounds, "
          f"phase 11: {[round(x, 4) for x in k4_per]}); sum "
          f"{sum(k10_per):.4f} ms, largest {max(k10_per):.4f}, mean "
          f"{sum(k10_per) / len(k10_per):.4f} (K4 {sum(k4_per) / len(k4_per):.4f});"
          f" bounds per round {[round(b[0], 5) for b in k10_bounds]} ms, "
          f"summing to {sum(b[0] for b in k10_bounds):.5f}")
    k11_ms = time_ms(lambda: stream2.stream2_rows(*k11_args), 10)
    k11_plain_ms = time_ms(lambda: stream2.stream2_rows_ref(*k11_args), 1,
                           warmup=0)
    k11_bytes = (bvh.cl2_lines.numel() + bvh.cl2_lo.numel() * 2
                 + bvh.cl2_gs.numel()) * 4 + n8 * (6 * 4 + 4 + 4 + 4 + 4)
    k11_bound, k11_by = bound_of(
        k11_bytes, work11["group_tests"] * 8 * MT_OPS
        + work11["box_tests"] * BOX_OPS)
    k11_bound128, _ = bound_of(
        k11_bytes, work128["group_tests"] * 8 * MT_OPS
        + work128["box_tests"] * BOX_OPS)
    binned2_ms = time_ms(lambda: trace.mesh_closest(
        ms, o8, d8, cap8, alive8, mesh="binned2"), 10)
    print(f"[20] K11 at {n8} rays: kernel {k11_ms:.4f} ms, plain "
          f"{k11_plain_ms:.2f} ms, bound {k11_bound:.5f} ms ({k11_by}) under "
          f"this schedule's work (units of {stream2.UNIT}, window "
          f"{stream2.RANGE_W}), {k11_bound128:.5f} ms under the work of "
          f"blocks of 128 with a window of 32; rounds per unit mean {r11.mean().item():.2f} max "
          f"{int(r11.max())}; one binned2 mesh_closest (sort, K11, unsort) "
          f"{binned2_ms:.4f} ms; on {card}")
    k12_ms = time_ms(lambda: traverse.bvh_closest(*k12_args,
                                                  n_nodes=bvh.n_nodes), 20)
    k12_plain_ms = time_ms(lambda: traverse.bvh_closest_ref(
        *k12_args, n_nodes=bvh.n_nodes), 1, warmup=0)
    k12_bound, k12_by = bound_of(
        (bvh.bvh_nodes.numel() + bvh.bvh_tris.numel()) * 4 + n8 * (28 + 8),
        visits12["node_visits"] * BOX_OPS + visits12["tri_tests"] * MT_OPS)
    print(f"[20] K12 at {n8} rays: kernel {k12_ms:.4f} ms, plain "
          f"{k12_plain_ms:.2f} ms, bound {k12_bound:.5f} ms ({k12_by}) on "
          f"{card}")
    # device busy share of a 4-spp binned2 render (one launch per level, so
    # the profile stays small)
    sc8, cm8 = reg8.model_example()
    cm8.samples_per_pixel = 4
    _, ust2 = regen.render_regen(sc8, cm8, seed=5, device=dev, mesh="binned2")
    with torch.profiler.profile(activities=acts) as prof20:
        _, pst20 = regen.render_regen(sc8, cm8, seed=5, device=dev,
                                      mesh="binned2")
    us20 = device_times(prof20)
    if us20:
        all20 = sum(us20.values())
        k11_us = sum(v for k, v in us20.items() if "stream2_kernel" in k)
        top20 = sorted(us20.items(), key=lambda kv: -kv[1])[:8]
        print(f"[20] scene 8 at 4 spp on binned2 ({pst20['levels']} levels): "
              f"render loop {ust2['elapsed_s']:.3f} s unprofiled, "
              f"{pst20['elapsed_s']:.3f} s under the profiler; device busy "
              f"{all20 / 1e6:.3f} s = {all20 / 1e6 / pst20['elapsed_s']:.3f} of"
              f" the profiled loop; K11 {k11_us / 1e3:.2f} ms = "
              f"{k11_us / 1e3 / pst20['levels_run']:.4f} ms per level; top "
              f"device events, ms: " + ", ".join(f"{k[:48]} {v / 1e3:.2f}"
                                                 for k, v in top20))
    else:
        print("[20] profiler reported no device time: busy share not measured")

    # ---- 21. book3 and cornellSmoke on the fused kernels ----------------
    phase_start(21)
    n, n_inner = 1 << 17, 8

    def texel_check(tag, sc, name, krec, prec, probe, weights, flags,
                    images):
        """The texels of one fused call on a scene with image textures,
        against the plain version's (its `probe`: the texel each lane
        read, per level), on the image lanes that agree on the record
        planes `flags`, from the weights (the record planes `weights`):
        where the kernel's leaves the plain one by more than rtol 1e-4 the
        two read other texels if the three channels' ratios kernel/plain
        differ (a texel of another colour), and only the pdf ratio moved if
        they are one number (a light-pdf test that flipped). Held at level
        0, where both ran on the same rays: at least 100 image lanes, the
        texel the plain version's on all but TEXEL_MOVED_FRAC[sc] of the
        agreeing lanes, and the other texel one within a row and
        TEXEL_COLS columns of the plain one (the kernel's weight over the
        plain pdf ratio, within rtol 1e-3: a uv one rounding apart, not a
        wrong lookup; near a sphere's pole u moves 1/sin(theta) times as
        far as the normal) on all but one lane in ten, or one lane: a lane
        whose winner flipped to another diffuse one keeps its flags (book2:
        the earth sphere in the plain version, the fog around it in the
        kernel, its weight the fog's white). Later levels start from rays
        the two computed apart by a rounding, which a far hit (book2's
        marble, its earth sphere ~1,000 units away) carries into the next
        uv: their counts are printed. Returns (image lanes, lanes whose
        texel moved) at level 0."""
        img = torch.stack(probe) >= 0
        agree = img.clone()
        for f in flags:
            agree &= krec[f] == prec[f]
        w_k = torch.stack([krec[c] for c in weights], -1)
        w_p = torch.stack([prec[c] for c in weights], -1)
        off = (~torch.isclose(w_k, w_p, rtol=1e-4, atol=0.0)).any(-1) & agree
        # kernel/plain per channel, against the brightest channel's (a
        # channel black in both agrees with any ratio)
        q = w_k / w_p
        q0 = q.gather(-1, w_p.argmax(-1, keepdim=True))
        one_ratio = (torch.isclose(q, q0, rtol=1e-4, atol=0.0)
                     | ((w_p == 0) & (w_k == 0))).all(-1)
        moved = off & ~one_ratio
        n_img, n_agree, n_moved, n_ratio = (
            int(x[0].sum()) for x in (img, agree, moved, off & one_ratio))
        # the moved lanes' texel: the kernel weight over the plain ratio
        lanes = torch.nonzero(moved[0]).squeeze(1)
        texels = images.reshape(-1, 3)
        t_idx = probe[0][lanes]
        t_p = texels[t_idx]
        big = t_p.argmax(dim=1, keepdim=True)
        implied = w_k[0][lanes] * (t_p.gather(1, big)
                                   / w_p[0][lanes].gather(1, big))
        hm, wm = images.shape[1], images.shape[2]
        row, col = t_idx // wm % hm, t_idx % wm
        base = t_idx - row * wm - col
        step = torch.full_like(lanes, TEXEL_COLS + 1)
        for di in range(-TEXEL_COLS, TEXEL_COLS + 1):
            for dj in (-1, 0, 1):
                # columns wrap (u's seam), rows clamp (the poles)
                nb = base + (row + dj).clamp(0, hm - 1) * wm \
                    + (col + di) % wm
                hit = torch.isclose(implied, texels[nb], rtol=1e-3,
                                    atol=1e-6).all(dim=1)
                step = torch.where(hit, torch.minimum(
                    step, torch.full_like(step, abs(di))), step)
        near = step <= TEXEL_COLS
        for k in torch.nonzero(~near).squeeze(1).tolist()[:3]:
            print(f"[{tag}] {name}: moved lane {int(lanes[k])} (plain texel "
                  f"row {int(row[k])} column {int(col[k])}, "
                  f"{t_p[k].tolist()}; the kernel's weights over the plain "
                  f"ratio {implied[k].tolist()}; weights kernel "
                  f"{w_k[0][lanes[k]].tolist()} plain "
                  f"{w_p[0][lanes[k]].tolist()})")
        print(f"[{tag}] {name}: at level 0 {n_img} image lanes, {n_agree} "
              f"of them agree on their flags, the texel moved on {n_moved} "
              f"(limit {TEXEL_MOVED_FRAC[sc]} of them), {int(near.sum())} "
              f"of those to a texel within a row and {TEXEL_COLS} columns "
              f"(columns apart, each: {sorted(step.tolist())}), the pdf "
              f"ratio alone on {n_ratio}; over all {img.shape[0]} levels "
              f"{int(img.sum())} image lanes, {int(agree.sum())} agree, the "
              f"texel moved on {int(moved.sum())}")
        check(n_img >= 100 and n_moved <= TEXEL_MOVED_FRAC[sc] * n_agree
              and n_moved - int(near.sum()) <= max(1, n_moved // 10),
              f"{name}: too few image lanes, or the texel moved on "
              f"{n_moved} of {n_agree} at level 0, or "
              f"{n_moved - int(near.sum())} of them away from the texels "
              f"around the plain one")
        return n_img, n_moved

    def hold_dense_scene(tag, sc, frac, tex=False, image=False):
        """K1, K9, K6 and K8 against their plain versions on a registry
        scene's tables and camera (its width, height, strata and defocus),
        131072 lanes, 8 levels, a mixed state: starts, ranks and time
        planes exact, the rest within `frac` of the lanes. With `image` (a
        scene with image textures): the pool aged by K1 first, the queue
        from the image's middle row, K9 refusing the scene, and each
        call's texels held (`texel_check`). Returns the image lanes each
        kernel shaded and whose texel moved, {kernel: (lanes, moved)}."""
        _, cam_s, tab_s, st_s, row_s, bg_s, state = cornell_inputs(
            dev, n, scene=sc)
        sq_s, w_s, h_s = cam_s.spp_sqrt, cam_s.width, cam_s.image_height
        npix_s, dfc = w_s * h_s, cam_s.defocus_angle > 0
        q_kw = dict(has_defocus=dfc, max_depth=50, n_inner=n_inner,
                    width=w_s, sqrt_spp=sq_s, npix=npix_s)
        print(f"[{tag}] {sc}: statics {st_s}; core variant "
              f"{bounce.fused_features(st_s)}; defocus {dfc}")
        # the middle row's items: quads' first rows see no image
        cur0 = (h_s // 2) * w_s if image else 1000
        texels = {}
        if image:
            seed_a = torch.tensor([97, 1, cur0, npix_s * 10],
                                  dtype=torch.int32, device=dev)
            o_a = bounce.FusedQOut.empty(n, 1, dev)
            state = aged_state(lambda st_: bounce.bounce_fused_q(
                tab_s, st_s, row_s, bg_s, seed_a, *st_, out=o_a,
                **dict(q_kw, n_inner=1))[4:], regen._init_state(n, dev))
        # K1 with starts at level 0 only: the starts, their ranks and the
        # time planes (PRNG slot 4) exact, the rest within `frac`
        seed21 = torch.tensor([-123456789, 1, cur0, npix_s * 10],
                              dtype=torch.int32, device=dev)
        k_o = bounce.FusedQOut.empty(n, n_inner, dev)
        bounce.bounce_fused_q(tab_s, st_s, row_s, bg_s, seed21, *state,
                              out=k_o, **q_kw)
        torch.cuda.synchronize()
        p_o = bounce.FusedQOut.empty(n, n_inner, dev)
        probe = []
        bounce.bounce_fused_q_ref(tab_s, st_s, row_s, bg_s, seed21, *state,
                                  out=p_o, probe=probe, **q_kw)
        check(torch.equal(k_o.take, p_o.take)
              and torch.equal(k_o.base, p_o.base)
              and torch.equal(k_o.rec[3][0] & ~3, p_o.rec[3][0] & ~3)
              and torch.equal(k_o.state[6], p_o.state[6]),
              f"K1 on {sc}: takes, bases, level-0 starts and ranks, or the "
              f"time plane differ")
        fl_k, fl_p = k_o.rec[3] & 7, p_o.rec[3] & 7
        fl_mis = (fl_k != fl_p).float().mean().item()
        alive_mis = (k_o.state[7] != p_o.state[7]).float().mean().item()
        v_off = torch.zeros_like(fl_k, dtype=torch.bool)
        for a, b in zip(k_o.rec[:3], p_o.rec[:3]):
            v_off |= ~torch.isclose(a, b, rtol=K1_RTOL, atol=K1_ATOL,
                                    equal_nan=True)
        v_mis = v_off.float().mean().item()
        agree0 = fl_k[0] == fl_p[0]
        err0 = max((a[0] - b[0])[agree0].abs().nan_to_num(0.0).max().item()
                   for a, b in zip(k_o.rec[:3], p_o.rec[:3]))
        nan_k = [int(torch.isnan(k_o.rec[0][j]).sum()) for j in range(n_inner)]
        nan_p = [int(torch.isnan(p_o.rec[0][j]).sum()) for j in range(n_inner)]
        print(f"[{tag}] {sc}: K1 vs plain at {n} lanes x {n_inner} levels: "
              f"takes, bases, level-0 starts and ranks and the time plane "
              f"exact; mismatch fractions FL {fl_mis:.2e} alive "
              f"{alive_mis:.2e} V {v_mis:.2e} (limit {frac}, rtol=atol="
              f"{K1_RTOL}); level-0 V max abs err {err0:.3e}; NaN V lanes "
              f"per level kernel {nan_k} plain {nan_p}")
        for what, mis in (("FL", fl_mis), ("alive", alive_mis), ("V", v_mis)):
            check(mis <= frac, f"K1 on {sc}: {what} mismatch {mis}")
        if image:
            texels["K1"] = texel_check(tag, sc, f"K1 on {sc}",
                                       k_o.rec, p_o.rec, probe, (0, 1, 2), (3,), tab_s[4])
            base_i = torch.zeros(1, dtype=torch.int32, device=dev)
            try:
                bounce.bounce_fused_q_direct(
                    tab_s, st_s, row_s, bg_s, seed21, base_i,
                    [r.clone() for r in k_o.rec], *state, **q_kw)
                refused = False
            except NotImplementedError as e:
                refused = "image textures" in str(e)
            check(refused, f"K9 on {sc}: ran, or refused without naming the "
                  f"image textures")
            print(f"[{tag}] {sc}: K9 refuses the scene (image textures)")
        if not image:
            # K9 against K1 bit for bit at a device base, and against its
            # plain version
            base21 = torch.tensor([3], dtype=torch.int32, device=dev)
            kb = [torch.full((n_inner + 5, n), -7.5, device=dev)
                  for _ in range(3)] + [torch.full(
                      (n_inner + 5, n), -9, dtype=torch.int32, device=dev)]
            k9o = bounce.FusedQOut.empty(n, n_inner, dev)
            bounce.bounce_fused_q_direct(tab_s, st_s, row_s, bg_s, seed21,
                                         base21, kb, *state, out=k9o, **q_kw)
            torch.cuda.synchronize()
            lv = slice(3, 3 + n_inner)
            check(all(torch.equal(b[lv], r) for b, r in zip(kb, k_o.rec))
                  and all(torch.equal(a, b)
                          for a, b in zip(k9o.state, k_o.state))
                  and all(bool((b[:3] == b[0, 0]).all())
                          and bool((b[3 + n_inner:] == b[0, 0]).all())
                          for b in kb),
                  f"K9 on {sc} differs from K1, or wrote outside its rows")
            pb = [b.clone() for b in kb]
            bounce.bounce_fused_q_direct_ref(tab_s, st_s, row_s, bg_s,
                                             seed21, base21, pb, *state,
                                             **q_kw)
            fl9 = ((kb[3][lv] & 7) != (pb[3][lv] & 7)).float().mean().item()
            check(fl9 <= frac and torch.equal(kb[3][3] & ~3, pb[3][3] & ~3),
                  f"K9 on {sc}: flags differ from its plain version")
            print(f"[{tag}] {sc}: K9 equal to K1 bit for bit at rows "
                  f"3..{2 + n_inner}, other rows untouched; vs plain FL "
                  f"mismatch {fl9:.2e}")
        # K6 on the refill planes of a real refill, K8 with rem mixed and
        # the refill cut after level 5
        r21 = regen.queue_refill_planes(
            torch.tensor(cur0, device=dev), state[7], npix_s * 10,
            width=w_s, npix=npix_s, sqrt_spp=sq_s)
        f_kw = dict(has_defocus=dfc, max_depth=50, n_inner=n_inner)
        k6 = bounce.bounce_fused(tab_s, st_s, row_s, bg_s, seed6, *state,
                                 *r21, **f_kw)
        torch.cuda.synchronize()
        probe = []
        p6 = bounce.bounce_fused_ref(tab_s, st_s, row_s, bg_s, seed6, *state,
                                     *r21, probe=probe, **f_kw)
        fused_pair(f"K6 on {sc}", k6, p6, frac, tag=tag, tex=tex)
        if image:
            texels["K6"] = texel_check(tag, sc, f"K6 on {sc}",
                                       k6[0], p6[0], probe, (0, 1, 2), (3,), tab_s[4])
        rs = np.random.default_rng(5)
        to_f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        # (image) every column: the edge columns of quads see no image
        ptr21 = [to_f(rs.integers(0, w_s, n) if image
                      else rs.choice([0, 7, w_s - 1], n)),
                 to_f(rs.integers(0, h_s - 1, n)),
                 to_f(rs.choice([0, sq_s - 1], n)),
                 to_f(rs.choice([0, 1, sq_s - 1], n)),
                 to_f(rs.choice([0, 1, 2, 275], n))]
        seed21p = torch.tensor([24680, 5], dtype=torch.int32, device=dev)
        p_kw = dict(width=w_s, sqrt_spp=sq_s, **f_kw)
        k8 = bounce.bounce_fused_pos(tab_s, st_s, row_s, bg_s, seed21p, *state,
                                     *ptr21, **p_kw)
        torch.cuda.synchronize()
        probe = []
        p8 = bounce.bounce_fused_pos_ref(tab_s, st_s, row_s, bg_s, seed21p,
                                         *state, *ptr21, probe=probe, **p_kw)
        _, noflip21 = fused_pair(f"K8 on {sc}", k8, p8, frac, tag=tag,
                                 tex=tex)
        check(all(torch.equal(a[noflip21], b[noflip21])
                  for a, b in zip(k8[12:], p8[12:]))
              and torch.equal(k8[0][7][0], p8[0][7][0])
              and not k8[0][7][5:].any(),
              f"K8 on {sc}: pointer planes or starts differ")
        if image:
            texels["K8"] = texel_check(tag, sc, f"K8 on {sc}",
                                       k8[0], p8[0], probe, (3, 4, 5), (6, 7), tab_s[4])
        return texels

    for sc in NEW_SCENES:
        hold_dense_scene("21", sc, DIEL_MISMATCH_FRAC if sc == "book3"
                         else K1_MISMATCH_FRAC)

    # the registry configurations through the CLI, on the four routes of a
    # dense scene; launch counts read around each render
    def run_cli_dense(num, extra, image):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-S", str(num), "-o", os.path.join(out_dir, image),
                           "--stats", "--quiet", *extra])
        check(rc == 0, f"cli.main -S {num} {extra} returned {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    routes21 = (("queue_ik", [], "bounce_fused_q"),
                ("direct_rec", ["--direct-rec"], "bounce_fused_q_direct"),
                ("queue", ["--schedule", "queue"], "bounce_fused"),
                ("positional", ["--schedule", "positional"],
                 "bounce_fused_pos"))

    def render_dense_routes(tag, scenes, nonfinite_max=0, routes=routes21,
                            cut=None):
        """Each scene at its registry configuration through `cli.main`
        under `routes` (default the four): paths, non-finite pixels (at
        most `nonfinite_max` values), segments per path within 5% of the
        registry's, `--direct-rec` with `queue_ik`'s segments, the
        schedules' channel means within 1e-2 of `queue_ik`'s. `cut`:
        {(scene, route): spp} renders CUT to fewer samples, held to
        `queue_ik` at the same spp. Returns
        {scene: {route: stats}}."""
        out = {}
        for sc, (num, regen_len) in scenes.items():
            _, cam_s = cornell_inputs(dev, 8, scene=sc)[:2]
            res = {}
            for label, extra, kern in routes:
                spp_cut = (cut or {}).get((sc, label))
                spp_s = spp_cut or cam_s.samples_per_pixel
                paths_s = cam_s.width * cam_s.image_height \
                    * int(spp_s ** 0.5) ** 2
                if spp_cut:
                    extra = extra + ["--spp", str(spp_cut)]
                reset_counts()
                st_r = run_cli_dense(num, extra, f"{sc}_{label}.ppm")
                counts = {"bounce_fused_q": bounce.launches,
                          "bounce_fused_q_direct": bounce.launches_direct,
                          "bounce_fused": bounce.launches_fused,
                          "bounce_fused_pos": bounce.launches_fused_pos,
                          "harvest_levels": harvest.launches,
                          "reverse_harvest": harvest.launches_rows}
                st_r["means"] = ppm_channel_means(os.path.join(
                    out_dir, f"{sc}_{label}.ppm"))
                st_r["launches"] = counts
                res[label] = st_r
                ratio = st_r["segments"] / st_r["paths"]
                print(f"[{tag}] {sc} {cam_s.width}x{cam_s.image_height} "
                      f"{spp_s}spp{' (CUT)' if spp_cut else ''} "
                      f"({int(spp_s ** 0.5) ** 2} strata) depth "
                      f"{cam_s.max_depth}, 131072 "
                      f"lanes, {label}, on {card}: paths {st_r['paths']}, "
                      f"segments {st_r['segments']} ({ratio:.4f}/path, "
                      f"registry {regen_len}), {st_r['rays_per_s']:.6g} "
                      f"rays/s, render loop {st_r['elapsed_s']:.4f} s, "
                      f"windows {st_r['windows']}, nonfinite "
                      f"{st_r['nonfinite']}, channel means "
                      f"{np.round(st_r['means'], 5).tolist()}; launches "
                      + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
                check(st_r["paths"] == paths_s,
                      f"{sc} {label}: paths {st_r['paths']} != {paths_s}")
                check(st_r["nonfinite"] <= nonfinite_max,
                      f"{sc} {label}: {st_r['nonfinite']} non-finite pixel "
                      f"values (at most {nonfinite_max})")
                check(abs(ratio - regen_len) <= 0.05 * regen_len,
                      f"{sc} {label}: segments/path {ratio} vs {regen_len}")
                others = [k for k in ("bounce_fused_q", "bounce_fused_q_direct",
                                      "bounce_fused", "bounce_fused_pos")
                          if k != kern]
                check(counts[kern] > 0 and not any(counts[k] for k in others),
                      f"{sc} {label}: the render did not go through {kern} "
                      f"alone")
            check("direct_rec" not in res
                  or res["direct_rec"]["segments"]
                  == res["queue_ik"]["segments"],
                  f"{sc}: --direct-rec segments differ from queue_ik's")
            for label in ("queue", "positional"):
                ref_means = res["queue_ik"]["means"]
                spp_cut = (cut or {}).get((sc, label))
                if spp_cut:
                    # the image's gamma is taken per pixel, so fewer
                    # samples lower its means: held to queue_ik at the
                    # same spp
                    image = f"{sc}_queue_ik{spp_cut}.ppm"
                    run_cli_dense(num, ["--spp", str(spp_cut)], image)
                    ref_means = ppm_channel_means(os.path.join(out_dir,
                                                               image))
                    print(f"[{tag}] {sc} queue_ik at {spp_cut} spp (the "
                          f"reference of the CUT {label}): channel means "
                          f"{np.round(ref_means, 5).tolist()}")
                check(np.abs(res[label]["means"] - ref_means).max() <= 1e-2,
                      f"{sc} {label}: channel means beyond 1e-2 of "
                      f"queue_ik's")
            out[sc] = res
        return out

    render_dense_routes("21", NEW_SCENES)

    # ---- 22. simpleLight and book1 on the fused kernels -----------------
    phase_start(22)
    # the hand-written noise and checker, and defocus: K1, K9, K6 and K8
    # on both scenes against their plain versions, as in phase 21
    for sc in TEX_SCENES:
        hold_dense_scene("22", sc, TEX_MISMATCH_FRAC[sc], tex=True)
    # the perlin and turbulent kinds, which no registry scene has: K6 on a
    # checker ground and quad and one sphere of each noise kind
    tb = SceneBuilder(background=(0.2, 0.3, 0.4))
    tb.sphere((0, -1000, 0), 1000.0, tb.lambertian(
        tex=tb.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    tb.quad((-8, 0.01, -8.8), (16, 0, 0), (0, 6, 0), tb.lambertian(
        tex=tb.checker(0.5, (0.8, 0.1, 0.1), (0.1, 0.1, 0.8))))
    for kind, x in (("perlin", -4.0), ("marble", 0.0), ("turbulent", 4.0)):
        tb.sphere((x, 1.5, 0.0), 1.5, tb.lambertian(
            tex=tb.noise_texture(4, kind)))
    tb.add_light(tb.quad((-3, 7, -3), (6, 0, 0), (0, 0, 6),
                         tb.diffuse_light((6, 6, 6))))
    tsc = tb.build()
    to_d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ttab = tuple(to_d(t) for t in bounce.pack_scene(tsc))
    tst_ = bounce.scene_statics(tsc)
    rs22 = np.random.default_rng(22)
    o22 = rs22.uniform(-7, 7, (n, 3)).astype(np.float32)
    d22 = (rs22.normal(size=(n, 3)) * 3).astype(np.float32)
    st22 = [to_d(o22[:, k]) for k in range(3)] \
        + [to_d(d22[:, k]) for k in range(3)] \
        + [to_d(rs22.uniform(0, 1, n).astype(np.float32)),
           to_d(np.ones(n, np.int32)), to_d(np.zeros(n, np.int32))]
    none22 = [torch.zeros(n, dtype=torch.int32, device=dev)] \
        + [torch.zeros(n, device=dev)] * 4
    row22 = cornell_inputs(dev, 8, scene="book1")[4]
    bg22 = to_d(np.asarray(tsc.background, np.float32))
    # one level: the texture values at the first hit (later levels add
    # the grazing-edge flips of a closed scene, held on the registry ones)
    t_kw = dict(has_defocus=False, max_depth=50, n_inner=1)
    k6t = bounce.bounce_fused(ttab, tst_, row22, bg22, seed6, *st22,
                              *none22, **t_kw)
    torch.cuda.synchronize()
    p6t = bounce.bounce_fused_ref(ttab, tst_, row22, bg22, seed6, *st22,
                                  *none22, **t_kw)
    gray = ((p6t[0][0][0] == p6t[0][1][0]) & (p6t[0][1][0] == p6t[0][2][0])
            & (p6t[0][0][0] > 0)).sum().item()
    print(f"[22] perlin, marble, turbulent and checker test scene (variant "
          f"{bounce.fused_features(tst_)}): {gray} lanes shade a noise gray")
    fused_pair("K6 on the texture test scene", k6t, p6t, K1_MISMATCH_FRAC,
               tag="22", tex=True)
    check(gray > 1000, "the texture test scene shaded too few noise lanes")

    def time_dense_scene(tag, sc):
        """K1, K9 (not on a scene with image textures, which it refuses),
        K6 and K8 timed on a registry scene at its cadence, each on an aged
        pool, with their plain versions and bounds. The bytes count the
        tables once, an image table by the texels the call reads (12 B for
        each image lane of the plain version's call on the same inputs).
        Returns {kernel: ms, kernel + " bound": (ms, by)}."""
        _, cam_s, tab_s, st_s, row_s, bg_s, _ = cornell_inputs(dev, 8,
                                                               scene=sc)
        image = st_s["has_image"]

        def texel_bytes(ref, *args, **kw):
            """12 B for each texel the plain version's call reads."""
            if not image:
                return 0
            probe = []
            ref(*args, probe=probe, **kw)
            return 12 * int(sum((p_ >= 0).sum() for p_ in probe))

        cad_s, sq_s, w_s = cam_s.regen_cadence, cam_s.spp_sqrt, cam_s.width
        npix_s = w_s * cam_s.image_height
        total_s = npix_s * sq_s * sq_s
        dfc = cam_s.defocus_angle > 0
        tb_bytes = sum(t.numel() * t.element_size() for t in tab_s[:4])
        kw_s = dict(has_defocus=dfc, max_depth=50, n_inner=cad_s, width=w_s,
                    sqrt_spp=sq_s, npix=npix_s)
        seed_s = torch.tensor([7, cad_s, 0, total_s], dtype=torch.int32,
                              device=dev)
        o_s = bounce.FusedQOut.empty(n, cad_s, dev)
        st0_s = aged_state(lambda st_: bounce.bounce_fused_q(
            tab_s, st_s, row_s, bg_s, seed_s, *st_, out=o_s, **kw_s)[4:],
            regen._init_state(n, dev))
        t = {}
        t["K1"] = time_ms(lambda: bounce.bounce_fused_q(
            tab_s, st_s, row_s, bg_s, seed_s, *st0_s, out=o_s, **kw_s), 20)
        segs_s = int(o_s.seg.sum())
        t["K1 plain"] = time_ms(lambda: bounce.bounce_fused_q_ref(
            tab_s, st_s, row_s, bg_s, seed_s, *st0_s, out=o_s, **kw_s), 3)
        if not image:
            bufs_s = regen.WindowBuffers.empty(n, 2, cad_s, dev).rec
            base_s = torch.zeros(1, dtype=torch.int32, device=dev)
            t["K9"] = time_ms(lambda: bounce.bounce_fused_q_direct(
                tab_s, st_s, row_s, bg_s, seed_s, base_s, bufs_s, *st0_s,
                out=o_s, **kw_s), 20)
            t["K9 plain"] = time_ms(lambda: bounce.bounce_fused_q_direct_ref(
                tab_s, st_s, row_s, bg_s, seed_s, base_s, bufs_s, *st0_s,
                out=o_s, **kw_s), 3)
        by1 = n * (36 + 36) + cad_s * n * 16 + tb_bytes + texel_bytes(
            bounce.bounce_fused_q_ref, tab_s, st_s, row_s, bg_s, seed_s,
            *st0_s, out=o_s, **kw_s)
        b1 = fused_bound(by1, segs_s, sc) + (by1,)
        f_kw = dict(has_defocus=dfc, max_depth=50, n_inner=cad_s)
        nxt_s = [0]

        def refill_s(st_):
            r_ = regen.queue_refill_planes(
                torch.tensor(nxt_s[0], device=dev), st_[7], total_s,
                width=w_s, npix=npix_s, sqrt_spp=sq_s)
            nxt_s[0] += int(r_[0].sum())
            return r_

        o6s = bounce.FusedOut.empty(n, cad_s, dev)
        st6s = aged_state(lambda st_: bounce.bounce_fused(
            tab_s, st_s, row_s, bg_s, seed6, *st_, *refill_s(st_), out=o6s,
            **f_kw)[3:], regen._init_state(n, dev))
        r6s = refill_s(st6s)
        t["K6"] = time_ms(lambda: bounce.bounce_fused(
            tab_s, st_s, row_s, bg_s, seed6, *st6s, *r6s, out=o6s, **f_kw),
            20)
        segs6s = int(o6s.seg.sum())
        t["K6 plain"] = time_ms(lambda: bounce.bounce_fused_ref(
            tab_s, st_s, row_s, bg_s, seed6, *st6s, *r6s, out=o6s, **f_kw), 3)
        by6 = n * (36 + 20 + 36) + cad_s * n * 16 + tb_bytes + texel_bytes(
            bounce.bounce_fused_ref, tab_s, st_s, row_s, bg_s, seed6, *st6s,
            *r6s, out=o6s, **f_kw)
        b6 = fused_bound(by6, segs6s, sc) + (by6,)
        q_s, lb_s, _, _ = regen.pos_tables(npix_s, sq_s * sq_s, n)
        o8s = bounce.FusedOut.empty(n, cad_s, dev, positional=True)
        p_kw = dict(width=w_s, sqrt_spp=sq_s, **f_kw)
        seed8s = torch.tensor([13579, cad_s], dtype=torch.int32, device=dev)
        st8s = aged_state(lambda st_: bounce.bounce_fused_pos(
            tab_s, st_s, row_s, bg_s, seed8s, *st_, out=o8s, **p_kw)[3:],
            regen._init_state_pos(n, dev, q_s, lb_s, sq_s * sq_s, w_s))
        t["K8"] = time_ms(lambda: bounce.bounce_fused_pos(
            tab_s, st_s, row_s, bg_s, seed8s, *st8s, out=o8s, **p_kw), 20)
        segs8s = int(o8s.seg.sum())
        t["K8 plain"] = time_ms(lambda: bounce.bounce_fused_pos_ref(
            tab_s, st_s, row_s, bg_s, seed8s, *st8s, out=o8s, **p_kw), 3)
        by8 = n * (56 + 56) + cad_s * n * 32 + tb_bytes + texel_bytes(
            bounce.bounce_fused_pos_ref, tab_s, st_s, row_s, bg_s, seed8s,
            *st8s, out=o8s, **p_kw)
        b8 = fused_bound(by8, segs8s, sc) + (by8,)
        k9_txt = ("K9 refuses the scene" if image else
                  f"K9 {t['K9']:.4f} ms, plain {t['K9 plain']:.3f} ms")
        print(f"[{tag}] {sc}, {n} lanes x {cad_s} level(s) per call, on "
              f"{card}: K1 ({segs_s} segments) {t['K1']:.4f} ms, plain "
              f"{t['K1 plain']:.3f} ms, bound {b1[0]:.4f} ms ({b1[1]}); "
              f"{k9_txt}; K6 ({segs6s}"
              f" segments) {t['K6']:.4f} ms, plain {t['K6 plain']:.3f} ms, "
              f"bound {b6[0]:.4f} ms ({b6[1]}); K8 ({segs8s} segments) "
              f"{t['K8']:.4f} ms, plain {t['K8 plain']:.3f} ms, bound "
              f"{b8[0]:.4f} ms ({b8[1]}); {OPS_PER_SEGMENT[sc]} operations "
              f"per segment")
        t.update({"K1 bound": b1, "K6 bound": b6, "K8 bound": b8})
        if sc in NONSCAN_OPS:
            # the culled bound: the tests the plain model of the kernels'
            # scan makes on the rays of K1's timed call, and the rest
            rays1 = bounce_rays(bounce, lambda: bounce.bounce_fused_q_ref(
                tab_s, st_s, row_s, bg_s, seed_s, *st0_s, out=o_s, **kw_s))
            c_ops = culled_ops(bounce, tab_s, st_s, rays1) + NONSCAN_OPS[sc]
            c1, c6, c8 = (fused_bound(by, sg, sc, c_ops) for by, sg in (
                (b1[2], segs_s), (b6[2], segs6s), (b8[2], segs8s)))
            print(f"[{tag}] {sc}: culled bounds (the plain model's tests on "
                  f"K1's timed rays, {c_ops:.0f} operations a segment "
                  f"against the brute force's {OPS_PER_SEGMENT[sc]}): K1 "
                  f"{c1[0]:.4f} ms ({c1[1]}), K6 {c6[0]:.4f} ({c6[1]}), K8 "
                  f"{c8[0]:.4f} ({c8[1]})")
            t.update({"culled ops": c_ops, "K1 culled bound": c1,
                      "K6 culled bound": c6, "K8 culled bound": c8})
        return t

    # K1, K9, K6 and K8 timed on both scenes at their registry cadence,
    # each on an aged pool, with their bounds
    for sc in TEX_SCENES:
        time_dense_scene("22", sc)

    # the registry configurations through the CLI under the four routes;
    # these scenes' lights can be sampled exactly edge-on, where the
    # reference's mixture pdf and scattering pdf are both 0 and its weight
    # 0/0 is NaN (PrintColor writes that component as 0): a few such paths
    # per render are the reference's own, not a fault
    tex_res = render_dense_routes("22", TEX_SCENES,
                                  nonfinite_max=TEX_NONFINITE_MAX)
    # one timed run per scene at cadence 8, for the cadence work
    for sc, (num, regen_len) in TEX_SCENES.items():
        reset_counts()
        st_c = run_cli_dense(num, ["--cadence", "8"], f"{sc}_cadence8.ppm")
        ratio = st_c["segments"] / st_c["paths"]
        print(f"[22] {sc} at --cadence 8 (registry {regen_len}) on {card}: "
              f"segments {st_c['segments']} ({ratio:.4f}/path), render loop "
              f"{st_c['elapsed_s']:.4f} s against "
              f"{tex_res[sc]['queue_ik']['elapsed_s']:.4f} s at cadence 1, "
              f"K1 calls {bounce.launches} against "
              f"{tex_res[sc]['queue_ik']['launches']['bounce_fused_q']}, "
              f"nonfinite {st_c['nonfinite']}")
        check(abs(ratio - regen_len) <= 0.05 * regen_len
              and st_c["nonfinite"] <= TEX_NONFINITE_MAX,
              f"{sc} at cadence 8: segments/path {ratio} or non-finite "
              f"pixels")

    # ---- 23. the staged closest-hit scan --------------------------------
    phase_start(23)
    from go_raytracer_tpu_torch.scenes import synthetic as syn
    # the synthetic scan scene at MAX_PRIMS rows two ways: spheres past the
    # staging budget (its quads and boxes all read from global memory), and
    # quads past it (its spheres and a prefix of its quads staged, its
    # boxes read from global memory)
    scan_sets = {"scan_spheres": (3500, 300, 296),
                 "scan_quads": (200, 1800, 2096)}
    scan_in = {nm: scan_inputs(dev, n, *cnt, seed=23)
               for nm, cnt in scan_sets.items()}
    # the tie scene: the pair's second sphere moves away from the first
    # over the ray time, so the kernels' Morton order scans it first; at
    # ray time 0 the first must still win
    scan_in["tie"] = scan_inputs(dev, n, 40, 2, 1, seed=23, moving_pair=True)
    dense23 = {sc: cornell_inputs(dev, n, scene=sc)
               for sc in ("cornell_box", "book3", "cornell_smoke",
                          "simple_light", "book1", "quads_scene", "book2")}
    all23 = {**dense23, **scan_in}
    # every variant's registers, staged bytes and resident blocks per SM
    for sc, inp in all23.items():
        st_i = inp[3]
        feat = bounce.fused_features(st_i)
        # the scan table's sections (inactive spheres and boxes left out)
        lay_i, _ = bounce.scan_tables(inp[2][0], st_i)
        cnt = lay_i.counts
        libs23 = [("bounce_fused_q", "K1/K9"), ("bounce_fused", "K6"),
                  ("bounce_fused_pos", "K8")]
        if bounce.supported_ext_statics(st_i):
            libs23.append(("bounce", "K3"))
        parts = []
        for lib, kname in libs23:
            inf = _cuda.kernel_info(lib, feat, *cnt)
            parts.append(f"{kname} {inf['registers']} registers, "
                         f"{inf['dynamic_smem']} B staged + "
                         f"{inf['static_smem']} B static shared, "
                         f"{inf['blocks_per_sm']} blocks/SM, "
                         f"{inf['local_bytes']} B spill")
            check(lib == "bounce" or inf["blocks_per_sm"] >= 4,
                  f"{sc} {kname}: {inf['blocks_per_sm']} resident blocks "
                  f"per SM (the staged geometry must leave 4)")
        culled = [nm for nm, c in zip(("spheres", "quads", "boxes"), cnt)
                  if c > bounce.SCAN_BLOCK]
        print(f"[23] {sc} ({cnt[0]} spheres, {cnt[1]} quads, {cnt[2]} boxes;"
              f" variant {feat}; culled sections {culled or 'none'}, box "
              f"reciprocals {'per row' if lay_i.rot else 'hoisted'}; scan "
              f"table {lay_i.table.shape[0] * 16} B, {lay_i.stage_bytes} B "
              f"staged): " + "; ".join(parts))
        check(inf["dynamic_smem"] == lay_i.stage_bytes,
              f"{sc}: staged bytes {inf['dynamic_smem']} != "
              f"{lay_i.stage_bytes}")

    def hold_scan(name, inp, levels, frac, tex=False, fused=True):
        """K1 and K9 (and with `fused` K6 and K8) against their plain
        versions on a scene's tables (131072 lanes, starts at level 0 from
        the item queue): the queue's outputs exact (takes, bases, the
        cursor, the level-0 alive count, every start and its rank); the
        flag words' clamp and emit bits, the alive bits and depths and
        the records within rtol = atol = K1_RTOL on all but `frac` of the
        lanes, at one level as over several (a ray that grazes an edge
        takes the other side in the kernel, whose multiply-adds are
        fused, and not in the plain version: book1 flips 3 of 131,072
        lanes' flags at one level); K1's new rays too at one level, as
        phases 21-22 hold K1 over several levels without them (a lane
        that went another way at one level carries another ray from then
        on: 5.2e-3 of the scan scene's lanes after 8). K9 equal to K1 bit
        for bit. `tex`: a textured scene, whose K6 and K8 rays are
        counted over all lanes, as in phase 22. Returns K1's outputs and
        its level-0 record max abs err."""
        _, cam_s, tab_s, st_s, row_s, bg_s, state = inp
        sq_s, w_s = cam_s.spp_sqrt, cam_s.width
        npix_s = w_s * cam_s.image_height
        q_kw = dict(has_defocus=cam_s.defocus_angle > 0, max_depth=50,
                    n_inner=levels, width=w_s, sqrt_spp=sq_s, npix=npix_s)
        seed23 = torch.tensor([-123456789, 1, 1000, npix_s * sq_s * sq_s],
                              dtype=torch.int32, device=dev)
        k_o = bounce.FusedQOut.empty(n, levels, dev)
        bounce.bounce_fused_q(tab_s, st_s, row_s, bg_s, seed23, *state,
                              out=k_o, **q_kw)
        torch.cuda.synchronize()
        p_o = bounce.FusedQOut.empty(n, levels, dev)
        bounce.bounce_fused_q_ref(tab_s, st_s, row_s, bg_s, seed23, *state,
                                  out=p_o, **q_kw)
        fl_mis = (k_o.rec[3] != p_o.rec[3]).float().mean().item()
        alive_mis = (k_o.state[7] != p_o.state[7]).float().mean().item()
        depth_mis = (k_o.state[8] != p_o.state[8]).float().mean().item()
        v_off = torch.zeros_like(k_o.rec[3], dtype=torch.bool)
        for a, b in zip(k_o.rec[:3], p_o.rec[:3]):
            v_off |= ~torch.isclose(a, b, rtol=K1_RTOL, atol=K1_ATOL,
                                    equal_nan=True)
        v_mis = v_off.float().mean().item()
        both = (k_o.state[7] > 0) & (p_o.state[7] > 0)
        ray_mis = max((~torch.isclose(a[both], b[both], rtol=K1_RTOL,
                                      atol=K1_ATOL)).float().sum().item() / n
                      for a, b in zip(k_o.state[:6], p_o.state[:6]))
        agree0 = k_o.rec[3][0] == p_o.rec[3][0]
        err0 = max((a[0] - b[0])[agree0].abs().nan_to_num(0.0).max().item()
                   for a, b in zip(k_o.rec[:3], p_o.rec[:3]))
        print(f"[23] {name}: K1 vs plain at {n} lanes x {levels} level(s): "
              f"takes, bases, cursor, level-0 alive count, starts and ranks "
              f"exact; lanes whose flag words differ "
              f"{int((k_o.rec[3] != p_o.rec[3]).any(0).sum())}; mismatch "
              f"fractions FL {fl_mis:.2e} alive {alive_mis:.2e} depth "
              f"{depth_mis:.2e} records {v_mis:.2e} rays {ray_mis:.2e} "
              f"(limit {frac}); level-0 record max abs err {err0:.3e}")
        check(torch.equal(k_o.take, p_o.take) and torch.equal(k_o.base,
                                                              p_o.base)
              and torch.equal(k_o.cursor, p_o.cursor)
              and k_o.seg[0].item() == p_o.seg[0].item()
              and torch.equal(k_o.rec[3][0] & ~3, p_o.rec[3][0] & ~3),
              f"K1 on {name}: takes, bases, cursor, level-0 count or starts "
              f"differ")
        for what, mis in (("FL", fl_mis), ("alive", alive_mis),
                          ("depth", depth_mis), ("records", v_mis),
                          ("rays", ray_mis if levels == 1 else 0.0)):
            check(mis <= frac, f"K1 on {name}: {what} mismatch {mis}")
        # K9: K1's device code through the direct entry, bit for bit
        base23 = torch.tensor([3], dtype=torch.int32, device=dev)
        kb = [torch.full((levels + 5, n), -7.5, device=dev)
              for _ in range(3)] + [torch.full((levels + 5, n), -9,
                                               dtype=torch.int32, device=dev)]
        k9o = bounce.FusedQOut.empty(n, levels, dev)
        bounce.bounce_fused_q_direct(tab_s, st_s, row_s, bg_s, seed23, base23,
                                     kb, *state, out=k9o, **q_kw)
        torch.cuda.synchronize()
        lv = slice(3, 3 + levels)
        check(all(torch.equal(b[lv], r) for b, r in zip(kb, k_o.rec))
              and all(torch.equal(a, b) for a, b in zip(k9o.state, k_o.state))
              and all(bool((b[:3] == b[0, 0]).all())
                      and bool((b[3 + levels:] == b[0, 0]).all())
                      for b in kb),
              f"K9 on {name} differs from K1, or wrote outside its rows")
        if levels == 1:
            pb = [b.clone() for b in kb]
            bounce.bounce_fused_q_direct_ref(tab_s, st_s, row_s, bg_s, seed23,
                                             base23, pb, *state, **q_kw)
            check(torch.equal(kb[3] & ~3, pb[3] & ~3)
                  and (kb[3] != pb[3]).float().mean().item() <= frac,
                  f"K9 on {name}: starts differ from its plain version, or "
                  f"its flags beyond {frac}")
        if not fused:
            return k_o, err0
        # K6 and K8 through the same scan
        f_kw = dict(has_defocus=q_kw["has_defocus"], max_depth=50,
                    n_inner=levels)
        r23 = regen.queue_refill_planes(
            torch.tensor(1000, device=dev), state[7],
            npix_s * sq_s * sq_s, width=w_s, npix=npix_s, sqrt_spp=sq_s)
        k6 = bounce.bounce_fused(tab_s, st_s, row_s, bg_s, seed6, *state,
                                 *r23, **f_kw)
        torch.cuda.synchronize()
        p6 = bounce.bounce_fused_ref(tab_s, st_s, row_s, bg_s, seed6, *state,
                                     *r23, **f_kw)
        fused_pair(f"K6 on {name}", k6, p6, frac, tag="23", tex=tex)
        rs23 = np.random.default_rng(23)
        to_f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        ptr23 = [to_f(rs23.integers(0, w_s, n)),
                 to_f(rs23.integers(0, cam_s.image_height - 1, n)),
                 to_f(rs23.integers(0, sq_s, n)),
                 to_f(rs23.integers(0, sq_s, n)),
                 to_f(rs23.choice([0, 1, 2, 40], n))]
        seed23p = torch.tensor([24680, 1], dtype=torch.int32, device=dev)
        p_kw = dict(width=w_s, sqrt_spp=sq_s, **f_kw)
        k8 = bounce.bounce_fused_pos(tab_s, st_s, row_s, bg_s, seed23p, *state,
                                     *ptr23, **p_kw)
        torch.cuda.synchronize()
        p8 = bounce.bounce_fused_pos_ref(tab_s, st_s, row_s, bg_s, seed23p,
                                         *state, *ptr23, **p_kw)
        fused_pair(f"K8 on {name}", k8, p8, frac, tag="23", tex=tex)
        check(torch.equal(k8[0][7][0], p8[0][7][0]),
              f"K8 on {name}: its level-0 starts differ")
        return k_o, err0

    def hold_cull(name, inp, levels):
        """The sphere cull changes no winner, on the card, bit for bit: K1
        on the scene's table with every 13th sphere row from the sixth
        cleared to kind -1, against K1 on the table with the same rows
        moved straight below the ground sphere, 1e6 down (where no ray
        meets them first). A moved row stretches its block's bounds down
        there, so the two tables cull different blocks; every output
        (records, counts, cursor, lane state) must be the same bits."""
        _, cam_s, tab_s, st_s, row_s, bg_s, state = inp
        sq_s, w_s = cam_s.spp_sqrt, cam_s.width
        npix_s = w_s * cam_s.image_height
        q_kw = dict(has_defocus=cam_s.defocus_angle > 0, max_depth=50,
                    n_inner=levels, width=w_s, sqrt_spp=sq_s, npix=npix_s)
        seed_c = torch.tensor([77, 1, 0, npix_s * sq_s * sq_s],
                              dtype=torch.int32, device=dev)
        rows = torch.arange(st_s["sph_base"] + 5,
                            st_s["sph_base"] + st_s["n_sph"], 13, device=dev)
        cleared = tab_s[0].clone()
        cleared[rows] = -1.0
        moved = tab_s[0].clone()
        moved[rows, 1:4] = torch.tensor([0.0, -1e6, 0.0], device=dev)
        moved[rows, 4:7] = 0.0
        outs = []
        for prims in (cleared, moved):
            o_c = bounce.FusedQOut.empty(n, levels, dev)
            bounce.bounce_fused_q((prims,) + tuple(tab_s[1:]), st_s, row_s,
                                  bg_s, seed_c, *state, out=o_c, **q_kw)
            outs.append([t.view(torch.int32) if t.is_floating_point() else t
                         for t in (*o_c.rec, o_c.seg, o_c.take, o_c.base,
                                   o_c.cursor, *o_c.state)])
        torch.cuda.synchronize()
        n_diff = sum(int((a != b).sum()) for a, b in zip(*outs))
        print(f"[23] {name}: the cull, K1 at {n} lanes x {levels} level(s) "
              f"on {len(rows)} sphere rows cleared against the same rows "
              f"moved out of reach: {n_diff} output elements differ")
        check(n_diff == 0, f"{name}: the sphere cull changed a winner "
              f"({n_diff} output elements differ)")

    for sc in ("book1", "scan_spheres"):
        for lv in (1, 8):
            hold_cull(sc, all23[sc], lv)

    for sc in ("book1", *scan_sets, "tie"):
        frac23 = TEX_MISMATCH_FRAC["book1"] if sc == "book1" \
            else K1_MISMATCH_FRAC
        k_o1, _ = hold_scan(sc, all23[sc], 1, frac23, tex=sc in TEX_SCENES)
        # over 8 levels K6 and K8 on book1, as phase 22; on the scan scenes
        # K1 and K9 (K6 and K8 run the same scan, held above at one level)
        hold_scan(sc, all23[sc], 8, frac23, tex=sc in TEX_SCENES,
                  fused=sc == "book1")
        if sc == "tie":
            # K3 and its plain version on camera rays at ray time 0 aimed
            # at the pair: every one that meets it emits the first row's
            # colour, none the second's
            _, _, tab_s, st_s, _, bg_s, _ = all23[sc]
            order = bounce.scan_tables(tab_s[0], st_s)[0].order[0].tolist()
            g_t = torch.Generator(dev).manual_seed(231)
            o_t = torch.tensor([[0.0, 50.0, 20.0]], device=dev).expand(
                n, 3).contiguous()
            aim = torch.rand((n, 3), generator=g_t, device=dev) * 6.0 - 3.0
            d_t = (torch.tensor([0.0, 50.0, 0.0], device=dev) + aim
                   * torch.tensor([1.0, 1.0, 0.0], device=dev) - o_t)
            tm0 = torch.zeros(n, device=dev)
            alive_t = torch.ones(n, dtype=torch.bool, device=dev)
            u_t = torch.rand((n, bounce.N_U), generator=g_t, device=dev)
            first_c = torch.tensor(syn.TIE_FIRST, device=dev)
            second_c = torch.tensor(syn.TIE_SECOND, device=dev)
            where = "before" if order.index(1) < order.index(0) else "after"
            for what, fn in (("K3", bounce.bounce),
                             ("K3 plain", bounce.bounce_ref)):
                e_t = fn(tab_s, st_s, o_t, d_t, tm0, alive_t, u_t, bg_s)[0]
                torch.cuda.synchronize()
                n1 = int((e_t == first_c).all(1).sum())
                n2 = int((e_t == second_c).all(1).sum())
                print(f"[23] tie: {what} at ray time 0, the second sphere "
                      f"(row 1) scanned {where} the first: {n1} of {n} rays "
                      f"emit the first row's colour, {n2} the second's")
                check(order.index(1) < order.index(0) and n1 > n // 4
                      and n2 == 0, f"tie: {what} did not give the tie to "
                      f"the first row")
        if sc in scan_sets:
            # the coincident pair: every camera ray that meets it emits the
            # first row's colour
            fl0 = k_o1.rec[3][0]
            emit0 = ((fl0 & 4) != 0) & ((fl0 & 2) != 0)
            v0 = torch.stack([k_o1.rec[k][0] for k in range(3)], dim=1)
            first = (v0 == torch.tensor(syn.TIE_FIRST, device=dev)).all(1)
            second = (v0 == torch.tensor(syn.TIE_SECOND, device=dev)).all(1)
            print(f"[23] {sc}: {int(first[emit0].sum())} camera rays meet "
                  f"the coincident pair and emit the first row's colour, "
                  f"{int(second.sum())} the second's")
            check(int(first[emit0].sum()) > 1000 and not second.any(),
                  f"{sc}: the coincident pair's tie did not go to the "
                  f"first row")
            # K3 on the same tables, one level from given uniforms
            _, _, tab_s, st_s, _, bg_s, state = all23[sc]
            o23 = torch.stack(state[:3], dim=1).contiguous()
            d23 = torch.stack(state[3:6], dim=1).contiguous()
            alive23 = state[7] > 0
            u23 = torch.from_numpy(np.random.default_rng(230).uniform(
                0, 1, (n, bounce.N_U)).astype(np.float32)).to(dev)
            k3s = bounce.bounce(tab_s, st_s, o23, d23, state[6], alive23, u23,
                                bg_s)
            torch.cuda.synchronize()
            p3s = bounce.bounce_ref(tab_s, st_s, o23, d23, state[6], alive23,
                                    u23, bg_s)
            ew3 = max((~torch.isclose(a, b, rtol=K1_RTOL, atol=K1_ATOL,
                                      equal_nan=True)).any(dim=-1)
                      .float().mean().item()
                      for a, b in ((k3s[0], p3s[0]), (k3s[1], p3s[1])))
            go3s = k3s[5] & p3s[5]
            ray3 = max((~torch.isclose(a[go3s], b[go3s], rtol=K1_RTOL,
                                       atol=K1_ATOL)).float().sum().item() / n
                       for a, b in ((k3s[3], p3s[3]), (k3s[4], p3s[4])))
            al3 = (k3s[5] != p3s[5]).float().mean().item()
            cf3 = (k3s[2] != p3s[2]).float().mean().item()
            print(f"[23] {sc}: K3 vs plain at {n} lanes: mismatch fractions "
                  f"alive {al3:.2e} clamp flag {cf3:.2e} E/W {ew3:.2e} "
                  f"scattered rays {ray3:.2e} (limit {K3_MISMATCH_FRAC})")
            check(max(al3, cf3, ew3, ray3) <= K3_MISMATCH_FRAC,
                  f"K3 on {sc} differs from its plain version")

    # K1's device time per level on each scene, at its cadence on an aged
    # pool: the `fused_q_level` launches of 10 calls under torch.profiler,
    # taken only when the profile holds every launch (a long process's
    # profile can lose some), beside CUDA events around the same 10 calls
    # (count_dead and any host gap included)
    acts23 = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]
    for sc, inp in all23.items():
        _, cam_s, tab_s, st_s, row_s, bg_s, _ = inp
        cad_s = max(cam_s.regen_cadence, 1)
        sq_s, w_s = cam_s.spp_sqrt, cam_s.width
        npix_s = w_s * cam_s.image_height
        kw_s = dict(has_defocus=cam_s.defocus_angle > 0, max_depth=50,
                    n_inner=cad_s, width=w_s, sqrt_spp=sq_s, npix=npix_s)
        seed_s = torch.tensor([7, cad_s, 0, npix_s * sq_s * sq_s],
                              dtype=torch.int32, device=dev)
        o_s = bounce.FusedQOut.empty(n, cad_s, dev)
        st0_s = aged_state(lambda st_: bounce.bounce_fused_q(
            tab_s, st_s, row_s, bg_s, seed_s, *st_, out=o_s, **kw_s)[4:],
            regen._init_state(n, dev))

        def run23():
            bounce.bounce_fused_q(tab_s, st_s, row_s, bg_s, seed_s, *st0_s,
                                  out=o_s, **kw_s)

        ev_ms = time_ms(run23, 10) / cad_s
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts23) as prof23:
            for _ in range(10):
                run23()
            torch.cuda.synchronize()
        lvl_us, lvl_n = 0.0, 0
        for e in prof23.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if t > 0 and "CUDA" in str(getattr(e, "device_type", "")) \
                    and kernel_of(e.key, "fused_q_level"):
                lvl_us += t
                lvl_n += e.count
        prof_txt = (f"{lvl_us / lvl_n:.2f} us per level on the device"
                    if lvl_n == 10 * cad_s else
                    f"device time not measured (the profile holds {lvl_n} "
                    f"of {10 * cad_s} level launches)")
        # both bounds a level: the brute-force work (every row of every
        # section, OPS_PER_SEGMENT) and, on a scene the kernels cull, the
        # tests the plain model of the scan makes on this call's rays
        segs23 = int(o_s.seg.sum())
        by23 = n * 72 + cad_s * n * 16 + sum(
            t_.numel() * t_.element_size() for t_ in tab_s[:4])
        bnd_txt = "no bound (not a registry scene)"
        if sc in OPS_PER_SEGMENT:
            bb = fused_bound(by23, segs23, sc)
            bnd_txt = (f"brute-force bound {bb[0] * 1e3 / cad_s:.2f} us a "
                       f"level ({bb[1]})")
        if sc in NONSCAN_OPS:
            c_ops = culled_ops(bounce, tab_s, st_s, bounce_rays(
                bounce, lambda: bounce.bounce_fused_q_ref(
                    tab_s, st_s, row_s, bg_s, seed_s, *st0_s,
                    out=bounce.FusedQOut.empty(n, cad_s, dev), **kw_s))) \
                + NONSCAN_OPS[sc]
            cb = fused_bound(by23, segs23, sc, c_ops)
            bnd_txt += (f", culled bound {cb[0] * 1e3 / cad_s:.2f} us "
                        f"({cb[1]}: {c_ops:.0f} operations a segment)")
        print(f"[23] {sc}: K1 {prof_txt}; {ev_ms * 1e3:.2f} us per level "
              f"between CUDA events ({cad_s} level(s) a call, {n} lanes, "
              f"aged pool, {segs23} segments a call); {bnd_txt}; on {card}")

    if args.parent:
        # the kernels' outputs against the parent's on the same inputs:
        # K1, K9, K6, K8 and K3 on the registry scenes and the scan mixes
        # (scripts/time_fused_kernels.py): every differing element counted,
        # and those beyond rtol = atol = 2e-3 (an integer plane's: every
        # differing one) within the scene's flip fraction of the lanes
        tfk = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scripts", "time_fused_kernels.py")
        scenes_p = list(REGISTRY_DENSE) + ["scan_spheres", "scan_quads"]
        saved_p = os.path.join(out_dir, "kernels_parent.pt")
        outs_p = {}
        for tag_p, extra in (("parent", ["--repo", args.parent, "--save",
                                         saved_p]),
                             ("change", ["--compare", saved_p])):
            js_p = os.path.join(out_dir, f"time_fused_{tag_p}.json")
            run_p = subprocess.run(
                [sys.executable, tfk, "--scene", *scenes_p, "--out", js_p]
                + extra, capture_output=True, text=True, timeout=1200)
            check(run_p.returncode == 0, f"time_fused_kernels.py ({tag_p}) "
                  f"failed: {run_p.stderr[-2000:]}")
            with open(js_p) as fh:
                outs_p[tag_p] = json.load(fh)
        fracs = {**TEX_MISMATCH_FRAC, **IMG_MISMATCH_FRAC,
                 "book3": DIEL_MISMATCH_FRAC}
        for key, diffs in sorted(outs_p["change"].get("compare", {}).items()):
            sc_p, k_p = key.split("/")
            dev_p = outs_p["parent"]["scenes"][sc_p][k_p]["device_us"]
            dev_c = outs_p["change"]["scenes"][sc_p][k_p]["device_us"]
            frac_p = fracs.get(sc_p, K1_MISMATCH_FRAC)
            worst_p = max((f / n for _, c, _, f, _ in diffs
                           if isinstance(c, int)), default=0.0)
            print(f"[23] {key} against the parent's kernel on its inputs: "
                  + ("bit for bit" if not diffs else "; ".join(
                      f"plane {i} {c} elements differ ({nn} where the "
                      f"parent's is NaN; largest {m}, {f} beyond 2e-3)"
                      for i, c, m, f, nn in diffs))
                  + f"; device {dev_c} us (parent {dev_p}) on {card}")
            check(all(isinstance(c, int) for _, c, _, _, _ in diffs)
                  and worst_p <= frac_p,
                  f"{key}: {worst_p} of the lanes differ from the parent's "
                  f"kernel (limit {frac_p})")
            # K3 computes each lane as before: on every registry scene,
            # both pools, the parent's outputs bit for bit but where the
            # parent's weight is a 0 / 0 NaN (now 0)
            check(not (k_p.startswith("K3") and sc_p in REGISTRY_DENSE)
                  or all(c == nn for _, c, _, _, nn in diffs),
                  f"{key}: K3 differs from the parent's")

    # ---- 24. quads and book2: image textures read inside K1, K6, K8 -----
    phase_start(24)
    # the staged prefix of the scan table (bounce_core.cuh `stage_layout`:
    # each section's block bounds and rows; book2's whole
    # table, 57,104 B), held against the dynamic shared memory the kernel
    # launches with
    for sc in IMG_SCENES:
        st_i = dense23[sc][3]
        lay_i, _ = bounce.scan_tables(dense23[sc][2][0], st_i)
        cnt = lay_i.counts
        total_b = lay_i.table.shape[0] * 16
        inf = _cuda.kernel_info("bounce_fused_q", bounce.fused_features(st_i),
                                *cnt)
        print(f"[24] {sc}: {cnt[0]} spheres, {cnt[1]} quads, {cnt[2]} boxes;"
              f" scan table {total_b} B, {lay_i.stage_bytes} B staged (the "
              f"kernel's {inf['dynamic_smem']} B), "
              f"{total_b - lay_i.stage_bytes} B read from global memory")
        check(lay_i.stage_bytes == inf["dynamic_smem"]
              and (sc != "book2" or lay_i.stage_bytes == total_b),
              f"{sc}: staged bytes {inf['dynamic_smem']} != "
              f"{lay_i.stage_bytes}, or book2's table not staged whole")
    # K1, K6 and K8 against their plain versions on an aged pool, their
    # texels held; K9 refuses the scenes
    img_texels = {sc: hold_dense_scene("24", sc, IMG_MISMATCH_FRAC[sc],
                                       tex=True, image=True)
                  for sc in IMG_SCENES}
    img_times = {sc: time_dense_scene("24", sc) for sc in IMG_SCENES}
    # the registry configurations through the CLI under queue_ik, queue and
    # positional; --direct-rec exits 2 naming the image textures
    # (book2's `positional` CUT to 25 spp: ~30 s at 100)
    img_res = render_dense_routes(
        "24", IMG_SCENES, nonfinite_max=TEX_NONFINITE_MAX,
        routes=[r for r in routes21 if r[0] != "direct_rec"],
        cut={("book2", "positional"): 25})
    for sc, (num, _) in IMG_SCENES.items():
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["-S", str(num), "--direct-rec", "--quiet", "-o",
                           os.path.join(out_dir, f"{sc}_direct.ppm")])
        print(f"[24] {sc} --direct-rec: exit {rc}, "
              f"{err.getvalue().strip()!r}")
        check(rc == 2 and "image textures" in err.getvalue(),
              f"{sc} --direct-rec: exit {rc} without naming image textures")
    img_launches = {k: sum(img_res[sc][label]["launches"][k]
                           for sc in IMG_SCENES for label in img_res[sc])
                    for k in ("bounce_fused_q", "bounce_fused",
                              "bounce_fused_pos")}
    print(f"[24] image scenes: texels (image lanes, moved) {img_texels}; "
          f"launches of the image variant over the six renders "
          f"{img_launches}")
    # the image variant in the kernels line: feature bit 5 of the core
    # (ops/bounce.fused_features), and its launches in phase 24's renders
    img_variant = {k: f"image variant (feature bit {bounce.FEAT_IMG}: "
                      f"quads, book2): {v} launches in phase 24's renders"
                   for k, v in img_launches.items()}

    # ---- 25. K3 in both modes, every feature set ---------------------------
    phase_start(25)
    from go_raytracer_tpu_torch.render import camera as camera_mod
    from go_raytracer_tpu_torch.scene import builder as builder_mod
    from go_raytracer_tpu_torch.scene import obj_loader
    from go_raytracer_tpu_torch.scenes import synthetic

    def k3_case(tag, tables_, st_, bg_, rays, frac, ext_fn=None,
                texel_frac=None, ops=None, levels=2, nonscan=None, tri=None):
        """K3 (through a launch prepared for the scene, `K3Launch`)
        against `bounce_ref` on `levels` levels of one pool (camera rays,
        a tenth of the lanes dead; the next level on the kernel's rays),
        then K3 timed on the last level's inputs. Flag words (alive',
        clamp) may differ on `frac` of the lanes, E/W and the continuing
        rays on `frac` of the agreeing ones (rtol = atol = K1_RTOL); an
        image lane's texel may move on `texel_frac` of the image lanes. In
        ext mode `ext_fn` gives the walk's winner and `tri` the triangle
        tables. Returns the row of the PERF table."""
        o, d, t, alive, g = rays
        n = o.shape[0]
        n_u = bounce.N_U + st_["n_media"]
        worst = dict(flags=0.0, ew=0.0, ray=0.0, err=0.0)
        c0 = time.perf_counter()
        img_lanes = img_moved = 0
        k3l = bounce.K3Launch(tables_, st_, bg_, tri)
        for lvl in range(levels):
            u = torch.rand((n, n_u), generator=g, device=dev)
            ext = ext_fn(o, d, t, alive) if ext_fn else None
            k = k3l(o, d, t, alive, u, ext=ext)
            torch.cuda.synchronize()
            probe = []
            p = bounce.bounce_ref(tables_, st_, o, d, t, alive, u, bg_,
                                  ext=ext, probe=probe, tri=tri)
            flags = (k[5] == p[5]) & (k[2] == p[2])
            off = torch.zeros_like(alive)
            for a, b in ((k[0], p[0]), (k[1], p[1])):
                off |= (~torch.isclose(a, b, rtol=K1_RTOL, atol=K1_ATOL,
                                       equal_nan=True)).any(dim=-1)
            go = flags & k[5]
            ray_off = torch.zeros_like(alive)
            for a, b in ((k[3], p[3]), (k[4], p[4])):
                ray_off |= go & (~torch.isclose(a, b, rtol=K1_RTOL,
                                                atol=K1_ATOL)).any(dim=-1)
            ok = flags & ~off
            worst["flags"] = max(worst["flags"], 1 - flags.float().mean()
                                 .item())
            worst["ew"] = max(worst["ew"], (off & flags).float().mean().item())
            worst["ray"] = max(worst["ray"], ray_off.float().mean().item())
            worst["err"] = max(worst["err"], max(
                (a - b)[ok].abs().nan_to_num(0.0).max().item()
                for a, b in ((k[0], p[0]), (k[1], p[1]))))
            check(not k[5][~alive].any() and not k[1][~alive].any(),
                  f"K3 {tag}: a dead lane shades or goes on")
            if probe:
                img = (probe[0] >= 0) & flags
                img_lanes += int(img.sum())
                img_moved += int((img & off).sum())
            o, d, alive = k[3].contiguous(), k[4].contiguous(), k[5].clone()
        for name, val in (("flag words", worst["flags"]), ("E/W", worst["ew"]),
                          ("continuing rays", worst["ray"])):
            check(val <= frac, f"K3 {tag}: {name} mismatch {val} > {frac}")
        if texel_frac is not None:
            check(img_lanes > 0 and img_moved <= texel_frac * img_lanes,
                  f"K3 {tag}: texel moved on {img_moved} of {img_lanes} "
                  f"image lanes")
        # K3 timed on the last level's inputs (its mesh hit fixed)
        u = torch.rand((n, n_u), generator=g, device=dev)
        ext = ext_fn(o, d, t, alive) if ext_fn else None
        out = bounce.bounce_out(n, dev)
        run = lambda: k3l(o, d, t, alive, u, ext=ext, out=out)
        ms = time_ms(run, 20)
        dev_ms = queued_device_ms(run)
        host = host_us(run)
        plain_ms = time_ms(lambda: bounce.bounce_ref(
            tables_, st_, o, d, t, alive, u, bg_, ext=ext, tri=tri), 1,
            warmup=0)
        # bytes: per lane the ray, time and alive (29 B), the uniforms, in
        # ext mode the walk's (t, idx) and what the gather needs of the
        # triangles hit, 50 B out
        nbytes = n * (29 + 4 * n_u + (8 if ext is not None else 0) + 50)
        if ext is not None:
            nbytes += tri_hit_bytes(bounce, tri, st_, ext.idx, alive)[0]
        segs = int(alive.sum())
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = segs * ops / FP32_OPS_PER_S * 1e3
        feat = bounce.fused_features(st_)
        info = _cuda.kernel_info("bounce", feat, st_["n_sph"], st_["n_quad"],
                                 st_["n_box"])
        row = dict(feat=feat, lanes=n, alive=segs, ms=ms, device_ms=dev_ms,
                   host_us=host, plain_ms=plain_ms,
                   bound_ms=max(b_ms, o_ms),
                   bound_by="bytes" if b_ms >= o_ms else "operations",
                   err=worst["err"], info=info)
        if nonscan is not None:
            # the culled bound: the plain model's tests on the timed rays
            c_ops = culled_ops(bounce, tables_, st_, [(
                o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t,
                alive)]) + nonscan
            row["culled_bound_ms"] = max(b_ms, segs * c_ops / FP32_OPS_PER_S
                                         * 1e3)
            row["culled_ops"] = c_ops
        dev_txt = (f"{dev_ms:.5f} ms on the device (queued back to back)"
                   if dev_ms is not None else "device time not measured")
        print(f"[25] K3 {tag} (variant {feat}{', ext' if ext else ''}, "
              f"{n} lanes, {segs} alive at the timed level) vs plain over "
              f"{levels} level(s): mismatch fractions flag words "
              f"{worst['flags']:.2e} E/W {worst['ew']:.2e} continuing rays "
              f"{worst['ray']:.2e} (limit {frac}, rtol=atol={K1_RTOL}); E/W "
              f"max abs err {worst['err']:.3e}"
              + (f"; image lanes {img_lanes}, texel moved on {img_moved}"
                 if texel_frac is not None else "")
              + f"; {ms:.5f} ms per call between CUDA events, {dev_txt}, "
              f"host {host:.1f} us per call, plain {plain_ms:.3f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}: {nbytes} B, {ops} operations per alive "
              f"lane)"
              + (f", culled bound {row['culled_bound_ms']:.5f} ms "
                 f"({row['culled_ops']:.0f} operations per alive lane, the "
                 f"plain model's tests)" if nonscan is not None else "")
              + f"; {info['registers']} registers, "
              f"{info['dynamic_smem']} B staged, {info['blocks_per_sm']} "
              f"blocks/SM, {info['local_bytes']} B local (spill) per thread;"
              f" on {card}; the case took {time.perf_counter() - c0:.1f} s")
        return row

    def camera_pool(cam, n, seed):
        """Camera rays through random pixels of `cam`, a tenth dead."""
        g = torch.Generator(device=dev).manual_seed(seed)
        pid = torch.randint(0, cam.width * cam.image_height, (n,),
                            generator=g, device=dev)
        s0 = torch.zeros(n, device=dev)
        o, d, t = camera_mod.generate_rays(
            cam.derived(), cam.width, pid, s0, s0,
            torch.rand((n, camera_mod.N_U_RAYGEN), generator=g, device=dev))
        alive = torch.rand(n, generator=g, device=dev) > 0.1
        return o.contiguous(), d.contiguous(), t.contiguous(), alive, g

    k3_flip = {"cornell_box": K3_MISMATCH_FRAC, "book3": DIEL_MISMATCH_FRAC,
               "cornell_smoke": K3_MISMATCH_FRAC,
               "simple_light": TEX_MISMATCH_FRAC["simple_light"],
               "book1": TEX_MISMATCH_FRAC["book1"],
               "quads_scene": IMG_MISMATCH_FRAC["quads_scene"],
               "book2": IMG_MISMATCH_FRAC["book2"]}
    k3_rows = {}
    for sc, frac in k3_flip.items():
        scene_, cam_ = getattr(reg8, sc)()
        st_ = bounce.scene_statics(scene_)
        tab_ = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in bounce.pack_scene(scene_))
        bg_ = torch.tensor(np.asarray(scene_.background, np.float32),
                           device=dev)
        k3_rows[sc] = k3_case(
            sc, tab_, st_, bg_, camera_pool(cam_, 131072, 25), frac,
            texel_frac=TEXEL_MOVED_FRAC.get(sc), ops=OPS_PER_SEGMENT[sc],
            nonscan=NONSCAN_OPS.get(sc))

    def mesh_hit_of(ctx):
        """The walk's winner of each lane under the tensor cap."""
        def fn(o, d, t, alive):
            cap = bounce.dense_cap_ref(ctx.ms, o, d, t)
            return bounce.MeshHit(*trace.mesh_closest(ctx.ms, o, d, cap,
                                                      alive))
        return fn

    b_gf = builder_mod.SceneBuilder()
    look_gf = synthetic.glass_fog_statue(b_gf, obj_loader, builder_mod.Transform)
    b_im = builder_mod.SceneBuilder(background=(0.1, 0.1, 0.1))
    synthetic.image_mesh(b_im)
    ext_scenes = {"scene8": (scene8, ((10, 5, 10), (0, 0, 0))),
                  "glass_fog": (b_gf.build(), look_gf),
                  "image_mesh": (b_im.build(bvh_threshold=1),
                                 ((0, 4, 12), (0, 0, 0)))}
    for sc, (scene_, look) in ext_scenes.items():
        cam_ = Camera(aspect_ratio=16 / 9, width=600, samples_per_pixel=1,
                      max_depth=50, vertical_fov=40)
        cam_.position(*look, (0, 1, 0))
        ctx_ = regen.MeshContext.build(scene_, cam_, dev)
        k3_rows[sc] = k3_case(
            sc, ctx_.tables, ctx_.statics, ctx_.bg,
            camera_pool(cam_, regen.MESH_MAX_LANES, 26), K3_MISMATCH_FRAC,
            ext_fn=mesh_hit_of(ctx_), tri=ctx_.tri,
            texel_frac=TEXEL_MOVED_FRAC["quads_scene"]
            if ctx_.statics["has_image"] else None, ops=K3_EXT_OPS[sc])
    print("[25] bounce.cu variants (ptxas): "
          + " | ".join(_cuda.ptxas_report("bounce")))

    # ---- 26. the reference engine's paths through cli.main --------------
    phase_start(26)

    def ppm_pixels(path):
        with open(path) as fh:
            txt = fh.read().split()
        return np.asarray(txt[4:], dtype=np.float64).reshape(-1, 3) \
            / float(txt[3])

    def seed_sd(path_a, path_b):
        """Per channel, the standard deviation of the difference of two
        renders' channel means, from two seeds' per-pixel differences
        (pixels are independent): sqrt(mean((a - b)^2) / npix)."""
        a, b = ppm_pixels(path_a), ppm_pixels(path_b)
        return np.sqrt(((a - b) ** 2).mean(axis=0) / a.shape[0]), \
            np.abs(a.mean(axis=0) - b.mean(axis=0))

    def run_cli26(num, extra, image, before=None):
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-S", str(num), "-o", os.path.join(out_dir, image),
                           "--stats", "--quiet", *extra])
        check(rc == 0, f"cli.main -S {num} {extra} returned {rc}")
        st_ = json.loads(buf.getvalue().strip().splitlines()[-1])
        st_["launches"] = dict(
            K3=bounce.launches_bounce, K5=traverse8.launches,
            K2=harvest.launches,
            fused=bounce.launches + bounce.launches_fused
            + bounce.launches_fused_pos + bounce.launches_direct,
            other=harvest.launches_rows + stream.launches
            + stream.launches_round + stream2.launches + traverse.launches)
        st_["image"] = os.path.join(out_dir, image)
        lv = st_.get("levels_run") or st_.get("levels") or 1
        print(f"[26] -S {num} {' '.join(extra)} on {card}: paths "
              f"{st_['paths']}, segments {st_['segments']} "
              f"({st_['segments'] / st_['paths']:.4f}/path), elapsed "
              f"{st_['elapsed_s']:.3f} s, levels {st_.get('levels')} "
              f"recorded, {st_.get('levels_run')} run, graph "
              f"{st_.get('graph')}, "
              f"{st_['elapsed_s'] / lv * 1e3:.3f} ms per level run, backend "
              f"{st_.get('backend')}, nonfinite {st_['nonfinite']}, channel "
              f"means {np.round(ppm_channel_means(st_['image']), 5).tolist()}"
              f"; launches {st_['launches']}"
              + (f"; eager, before the levels were graphed, "
                 f"{EAGER_MS_BEFORE[before]} ms per level" if before
                 else ""))
        check(st_["nonfinite"] <= TEX_NONFINITE_MAX,
              f"-S {num} {extra}: {st_['nonfinite']} non-finite pixels")
        return st_

    def held(tag, st_, ref, ref2):
        """`st_`'s image against `ref`'s by channel means, within four
        standard deviations of the two-seed difference measured from
        `ref` and `ref2` (the same path at another seed)."""
        sd, spread = seed_sd(ref["image"], ref2["image"])
        diff = np.abs(ppm_channel_means(st_["image"])
                      - ppm_channel_means(ref["image"]))
        print(f"[26] {tag}: channel means differ by "
              f"{np.round(diff, 6).tolist()}; two seeds of the reference "
              f"differ by {np.round(spread, 6).tolist()}, standard deviation"
              f" of that difference {np.round(sd, 6).tolist()}, tolerance "
              f"4 sd")
        check((diff <= 4 * sd).all(), f"{tag}: channel means off by {diff}"
              f" (4 sd {4 * sd})")
        check(st_["paths"] == ref["paths"], f"{tag}: paths")

    # the slice's main path, counts set to 0 just before it: cornellBox at
    # full width through the wavefront integrator, its bounce on K3
    w6 = run_cli26(6, ["--integrator", "wavefront", "--spp", "16"],
                   "cornell_wavefront16.ppm", before="cornell_box auto")
    k3_wavefront_launches = w6["launches"]["K3"]
    check(w6["backend"] == "pallas" and w6["graph"]
          and k3_wavefront_launches == w6["levels_run"] > 0
          and w6["launches"]["fused"] + w6["launches"]["other"]
          + w6["launches"]["K5"] == 0,
          "cornellBox wavefront: the bounce did not go through K3 alone")
    q6a = run_cli26(6, ["--spp", "16"], "cornell_qik16_s0.ppm")
    q6b = run_cli26(6, ["--spp", "16", "--seed", "1"], "cornell_qik16_s1.ppm")
    held("cornellBox wavefront (K3) vs queue_ik, 600x600 16 spp", w6, q6a,
         q6b)
    # --backend xla (the eager bounce, ~15x K3's time a level: CUT to 4
    # spp), against K3 on the same random stream (the same paths but for
    # the flips of grazing rays) and against queue_ik
    x6 = run_cli26(6, ["--integrator", "wavefront", "--backend", "xla",
                       "--spp", "4"], "cornell_wavefront_xla4.ppm",
                   before="cornell_box xla")
    check(x6["backend"] == "xla" and x6["graph"]
          and sum(x6["launches"].values()) == 0,
          "cornellBox wavefront --backend xla launched a kernel, or its "
          "levels were not graphed")
    w6_4 = run_cli26(6, ["--integrator", "wavefront", "--spp", "4"],
                     "cornell_wavefront4.ppm")
    q6c = run_cli26(6, ["--spp", "4"], "cornell_qik4_s0.ppm")
    q6d = run_cli26(6, ["--spp", "4", "--seed", "1"], "cornell_qik4_s1.ppm")
    check(abs(x6["segments"] - w6_4["segments"]) <= 1e-3 * w6_4["segments"],
          "cornellBox wavefront: xla and auto segments differ by > 1e-3")
    held("cornellBox wavefront --backend xla vs --backend auto, 4 spp", x6,
         w6_4, q6d)
    held("cornellBox wavefront --backend xla vs queue_ik, 4 spp", x6, q6c,
         q6d)
    # book2 with every feature on K3
    w2 = run_cli26(2, ["--integrator", "wavefront", "--spp", "4"],
                   "book2_wavefront4.ppm")
    check(w2["backend"] == "pallas" and w2["launches"]["K3"]
          == w2["levels_run"] > 0 and w2["nonfinite"] <= TEX_NONFINITE_MAX,
          "book2 wavefront: not on K3, or non-finite pixels")
    q2a = run_cli26(2, ["--spp", "4"], "book2_qik4_s0.ppm")
    q2b = run_cli26(2, ["--spp", "4", "--seed", "1"], "book2_qik4_s1.ppm")
    held("book2 wavefront (K3, every feature) vs queue_ik, 800x800 4 spp",
         w2, q2a, q2b)
    # scene 8 through the wavefront integrator: the eager bounce, its
    # triangle hit on K5
    w8 = run_cli26(8, ["--integrator", "wavefront", "--spp", "4"],
                   "modelExample_wavefront4.ppm", before="model_example xla")
    check(w8["launches"]["K5"] == w8["levels_run"] > 0 and w8["graph"]
          and w8["launches"]["K3"] == 0 and w8["mesh"]["route"] == "walk",
          "scene 8 wavefront: the triangle hit is not on K5 once a level")
    r8a = run_cli26(8, ["--spp", "4"], "modelExample_walk4_s0.ppm")
    r8b = run_cli26(8, ["--spp", "4", "--seed", "1"],
                    "modelExample_walk4_s1.ppm")
    held("modelExample wavefront vs the walk route, 600x337 4 spp", w8, r8a,
         r8b)
    # scene 8 under `positional`: the eager bounce per level, K5 inside
    # (CUT to 9 spp: its eager levels were the phase's
    # longest path, 15 s at 25 spp)
    p8 = run_cli26(8, ["--schedule", "positional", "--spp", "9"],
                   "modelExample_positional9.ppm")
    check(p8["schedule"] == "positional" and p8["bounce"] == "wavefront"
          and p8["launches"]["K5"] == p8["levels"] > 0,
          "scene 8 positional: not the eager bounce with K5 a level")
    r8d = run_cli26(8, ["--spp", "9"], "modelExample_walk9_s0.ppm")
    r8c = run_cli26(8, ["--spp", "9", "--seed", "1"],
                    "modelExample_walk9_s1.ppm")
    held("modelExample positional vs the walk route, 600x337 9 spp", p8,
         r8d, r8c)
    # lanternhouse: triangle lights, no kernel carries it: regen's unfused
    # window on the eager bounce with the dense triangle class
    lh = run_cli26(8, ["--obj", "assets/lanternhouse.obj", "--spp", "16"],
                   "lanternhouse16.ppm", before="lanternhouse regen")
    lh_px = ppm_pixels(lh["image"])
    check(lh["bounce"] == "wavefront" and lh["backend"] == "xla"
          and lh["graph"] and lh["segments"] > 0 and lh_px.max() > 0.05
          and lh["paths"] == 600 * 337 * 16
          and sum(lh["launches"].values()) == lh["launches"]["K2"],
          "lanternhouse: not the eager bounce, or nothing rendered")
    # every dense scene at 1 spp on the wavefront integrator: K3's
    # launches per feature set in a render
    k3_render = {"cornell_box": k3_wavefront_launches,
                 "book2": w2["launches"]["K3"]}
    for sc, num in (("book1", 1), ("book3", 3), ("simple_light", 4),
                    ("quads_scene", 5), ("cornell_smoke", 7)):
        ws = run_cli26(num, ["--integrator", "wavefront", "--spp", "1"],
                       f"{sc}_wavefront1.ppm")
        check(ws["launches"]["K3"] == ws["levels_run"] > 0
              and ws["nonfinite"] <= TEX_NONFINITE_MAX,
              f"{sc} wavefront: not on K3, or non-finite pixels")
        k3_render[sc] = ws["launches"]["K3"]
    k3_render["scene8"] = k3_launches
    for sc in ("glass_fog", "image_mesh"):
        scene_, look = ext_scenes[sc]
        cam_ = Camera(aspect_ratio=16 / 9, width=300, samples_per_pixel=4,
                      max_depth=50, vertical_fov=40)
        cam_.position(*look, (0, 1, 0))
        reset_counts()
        img_, st_ = regen.render_regen(scene_, cam_, device=dev)
        k3_render[sc] = bounce.launches_bounce
        check(st_["bounce"] == "ext"
              and k3_render[sc] == st_["levels_run"] > 0
              and st_["nonfinite"] == 0,
              f"{sc}: the regen render did not bounce on K3 a level")
        print(f"[26] {sc} 300x168 4 spp through render_regen on {card}: "
              f"segments {st_['segments']}, levels {st_['levels_run']}, K3 "
              f"launches {k3_render[sc]}, channel means "
              f"{np.round(img_.mean(axis=(0, 1)), 5).tolist()}")
    print("[26] K3 rows (PERF.md §6): " + json.dumps(
        {sc: dict({k: v for k, v in r.items() if k != "info"},
                  launches_render=k3_render[sc], **r["info"])
         for sc, r in k3_rows.items()}))
    k3_variants = ("feature sets (ops/bounce.fused_features) dense mode "
                   + ", ".join(f"{sc} {k3_rows[sc]['feat']}"
                               for sc in k3_flip)
                   + "; ext mode from the walk's (t, idx), the winner "
                   "gathered in the kernel, " + ", ".join(
                       f"{sc} {k3_rows[sc]['feat']}" for sc in ext_scenes)
                   + "; launches in phase 26's renders "
                   + json.dumps(k3_render))

    # ---- 27. gradients through the reference engine -------------------
    phase_start(27)
    grad = gradient_phase(dev, card)
    print("[27] gradient rows (PERF.md): " + json.dumps(grad))

    # ---- 28. multi-device on a one-rank NCCL group ---------------------
    phase_start(28)
    multi = multidevice_phase(dev, card)
    print("[28] multi-device rows (PERF.md): " + json.dumps(multi))
    sharded = {k: v for tag in ("queue_ik", "direct_rec", "queue",
                                "positional", "model_example", "reorder")
               for k, v in multi[tag]["launches"].items()}
    sharded["K2"] = multi["queue_ik"]["launches"]["K2"]
    sharded["K6"] = multi["queue"]["launches"]["K6"]

    # ---- 29. the lane coherence sort (reorder=True) ---------------------
    phase_start(29)
    reo = reorder_phase(dev, card)
    print("[29] reorder rows (PERF.md): " + json.dumps(reo))
    k7p = reo["k7p"]

    # ---- 30. the mesh window as one device program ----------------------
    phase_start(30)
    ml_row = mesh_window_phase(dev, card, ml_launches_main8)

    # ---- 31. the reference engine and the gradient step as programs -----
    phase_start(31)
    engine = engine_program_phase(dev, card)
    print("[31] engine rows (PERF.md): " + json.dumps(engine))

    kernels = [
        {"name": "bounce_fused_q", "route": "cuda",
         "launches_sharded": sharded["K1"],
         "source": "go_raytracer_tpu_torch/ops/csrc/bounce_fused_q.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/bounce.py:2196",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": None,
         "variants": img_variant["bounce_fused_q"]},
        {"name": "reverse_harvest_levels", "route": "cuda",
         "launches_sharded": sharded["K2"],
         "source": "go_raytracer_tpu_torch/ops/csrc/harvest.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/harvest.py:273",
         "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "bounce", "route": "cuda",
         "launches_sharded": sharded["K3"],
         "source": "go_raytracer_tpu_torch/ops/csrc/bounce.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/bounce.py:1245",
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": None, "variants": k3_variants,
         "launches_engine_graph": engine["counters"]["counted"][
             "cornell_box"]["bounce_level"],
         "host_us": k3_host, "device_ms": k3_dev,
         "cap_entry": {"name": "bounce_cap", "launches": cap_launches,
                       "ms": cap_ms, "host_us": cap_host,
                       "device_ms": cap_dev, "plain_ms": cap_plain_ms,
                       "bound_ms": cap_bound, "bound_by": "bytes",
                       "max_abs_err": cap_err},
         "redesign": REDESIGN_K3},
        {"name": "stream_rows", "route": "cuda",
         "source": "go_raytracer_tpu_torch/ops/csrc/stream.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/stream.py:213",
         "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": None},
        {"name": "bvh8_closest", "route": "cuda",
         "launches_sharded": sharded["K5"],
         "source": "go_raytracer_tpu_torch/ops/csrc/traverse8.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/traverse8.py:238",
         "launches": k5_launches, "max_abs_err": k5_err,
         "ms": k5_sorted_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_by,
         "library_ms": None,
         "launches_grad": grad["model_example"]["launches"]["K5"],
         "launches_engine_graph": engine["counters"]["counted"][
             "model_example"]["bvh8_closest_kernel"]},
        {"name": "bounce_fused", "route": "cuda",
         "launches_sharded": sharded["K6"],
         "source": "go_raytracer_tpu_torch/ops/csrc/bounce_fused.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/bounce.py:1577",
         "launches": k6_launches, "max_abs_err": k6_err, "ms": k6_ms,
         "plain_ms": k6_plain_ms, "bound_ms": k6_bound, "bound_by": k6_by,
         "library_ms": None,
         "variants": img_variant["bounce_fused"],
         "redesign": REDESIGN_SCAN},
        {"name": "reverse_harvest", "route": "cuda",
         "launches_sharded": sharded["K7"],
         "source": "go_raytracer_tpu_torch/ops/csrc/harvest_rows.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/harvest.py:225",
         "launches": k7_launches, "max_abs_err": k7_err, "ms": k7_ms,
         "plain_ms": k7_plain_ms, "bound_ms": k7_bound, "bound_by": "bytes",
         "library_ms": None,
         "perm_entry": {"name": "reverse_harvest (unwinding the lane sort)",
                        "entry": "grt_harvest_rows_perm",
                        "replaces": "go_raytracer_tpu/integrator/regen.py:"
                                    "552 (its XLA reverse scan that "
                                    "unwinds the sort, :573)",
                        "launches": k7p["launches"],
                        "launches_per_render": k7p["launches_per_render"],
                        "launches_sharded": sharded["K7p"],
                        "max_abs_err": k7p["max_abs_err"], "ms": k7p["ms"],
                        "k7_ms_same_records": k7p["k7_ms_same_records"],
                        "plain_ms": k7p["plain_ms"],
                        "bound_ms": k7p["bound_ms"], "bound_by": "bytes",
                        "library_ms": None, "registers": k7p["registers"],
                        "windows": k7p["windows"],
                        "redesign": REDESIGN_K7P}},
        {"name": "bounce_fused_pos", "route": "cuda",
         "launches_sharded": sharded["K8"],
         "source": "go_raytracer_tpu_torch/ops/csrc/bounce_fused_pos.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/bounce.py:1842",
         "launches": k8_launches, "max_abs_err": k8_err, "ms": k8_ms,
         "plain_ms": k8_plain_ms, "bound_ms": k8_bound, "bound_by": k8_by,
         "library_ms": None,
         "variants": img_variant["bounce_fused_pos"],
         "redesign": REDESIGN_SCAN},
        {"name": "bounce_fused_q_direct", "route": "cuda",
         "launches_sharded": sharded["K9"],
         "source": "go_raytracer_tpu_torch/ops/csrc/bounce_fused_q.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/bounce.py:2343",
         "launches": k9_launches, "max_abs_err": k9_err, "ms": k9_ms,
         "plain_ms": k9_plain_ms, "bound_ms": k9_bound, "bound_by": k9_by,
         "library_ms": None},
        {"name": "stream_round_rows", "route": "cuda",
         "source": "go_raytracer_tpu_torch/ops/csrc/stream_round.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/stream.py:369",
         "launches": k10_launches, "max_abs_err": k10_err, "ms": k10_ms,
         "plain_ms": k10_plain_ms, "bound_ms": k10_bound,
         "bound_by": k10_by, "library_ms": None},
        {"name": "stream2_rows", "route": "cuda",
         "source": "go_raytracer_tpu_torch/ops/csrc/stream2.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/stream2.py:230",
         "launches": k11_launches, "max_abs_err": k11_err, "ms": k11_ms,
         "plain_ms": k11_plain_ms, "bound_ms": k11_bound,
         "bound_by": k11_by, "library_ms": None},
        {"name": "bvh_closest", "route": "cuda",
         "source": "go_raytracer_tpu_torch/ops/csrc/traverse.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/traverse.py:219",
         "launches": k12_launches, "max_abs_err": k12_err, "ms": k12_ms,
         "plain_ms": k12_plain_ms, "bound_ms": k12_bound,
         "bound_by": k12_by, "library_ms": None},
        ml_row,
    ]
    print(f"[end] {time.perf_counter() - t_start:.1f} s after the build "
          f"began")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
