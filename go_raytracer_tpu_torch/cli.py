"""Command-line renderer, flag-compatible with the JAX package's CLI and
the reference binary (main.go:416-480): -S scene number, -o output file,
-N thread count (accepted, unused).

Runs on the GPU; `--cpu` runs the plain PyTorch versions of the kernels
on the CPU instead. Without a GPU and without `--cpu` it exits with an
error rather than falling back. An unknown -S exits with 2 and the list of
valid scenes. `-S 1` (book1), `-S 2` (book2), `-S 3` (book3), `-S 4`
(simpleLight), `-S 5` (quads), `-S 6` (cornellBox) and `-S 7`
(cornellSmoke) run the dense path, book2 and quads with their image
textures read inside the kernels; `--direct-rec` on a scene with image
textures exits with 2 and a message naming them, as the JAX package
refuses it.
`-S 8` (a mesh) runs the mesh path; `--mesh` picks its closest-hit route:
`auto` (default: the walk, or binned with `--b1-fused`), `binned`
(`--b1-fused` fuses each round into one kernel), `binned2` (the
persistent-block intersector) or `walk` (the BVH8 walk; `--no-traverse8`
the binary BVH walk). The JAX package's auto is binned, a TPU choice; on
the H100 the walk is the fastest route every triangle BVH can run.
`--direct-rec` has the in-kernel-queue kernel write its records in place. These are the JAX
package's GRT_MESH, GRT_B1_FUSED, GRT_TRAVERSE8 and GRT_DIRECT_REC as
flags; where the JAX package would quietly take another route, the run
exits with 2 and a message. `--schedule queue` and
`--schedule positional` run a scene on those schedules instead of the
in-kernel queue (a mesh scene, or `--backend xla`, runs `queue` by
default and refuses `queue_ik` with exit 2). `--backend xla` runs the
reference engine's bounce (`integrator/wavefront._bounce`) in place of
the kernels; `--integrator wavefront` runs the reference engine's
stratified renderer (`render/renderer.py`), with `--mode` and `--batch`,
and `--backend auto` there runs its bounce as the K3 kernel where the
kernel carries the scene. On the GPU each level of the reference engine,
and of regen's unfused window on the walk or binned2 route or a scene
with no triangle BVH, replays as one CUDA graph. The stats say `graph`
(whether it replayed) and `levels_run` (levels run, which on the GPU may
pass a drain; `levels` counts those recorded).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="GPU path tracer (PyTorch + CUDA)")
    ap.add_argument("-S", "--scene", default="6",
                    help="scene number 1-8 or name (default cornellBox)")
    ap.add_argument("-o", "--out", default="image.ppm",
                    help="output image (.ppm or .png)")
    ap.add_argument("-N", "--threads", type=int, default=1,
                    help="accepted for reference CLI parity; unused")
    ap.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    ap.add_argument("--width", type=int, default=None, help="override image width")
    ap.add_argument("--max-depth", type=int, default=None, help="override max depth")
    ap.add_argument("--mode", choices=["while", "scan"], default="while",
                    help="wavefront loop form (wavefront integrator only)")
    ap.add_argument("--backend", choices=["auto", "xla", "pallas"], default="auto",
                    help="bounce backend: auto = the CUDA kernels where they "
                         "carry the scene, pallas = the kernels or an error, "
                         "xla = the reference engine's tensor-code bounce")
    ap.add_argument("--integrator", choices=["regen", "wavefront"],
                    default="regen",
                    help="regen (ray regeneration) or wavefront (the "
                         "reference engine's stratified renderer)")
    ap.add_argument("--regen", action="store_true",
                    help="(compat alias for --integrator regen)")
    ap.add_argument("--batch", type=int, default=1 << 17,
                    help="rays per launch (wavefront integrator only)")
    ap.add_argument("--lanes", type=int, default=1 << 17,
                    help="regen lane-pool size (multiple of 256)")
    ap.add_argument("--cadence", type=int, default=0,
                    help="bounce levels per kernel call; 0 = per-scene default")
    ap.add_argument("--schedule",
                    choices=["auto", "queue_ik", "queue", "positional"],
                    default="auto",
                    help="regen work assignment: auto = queue_ik (the item "
                         "queue refilled inside the kernel every level) for "
                         "dense scenes, queue for mesh scenes; on a dense "
                         "scene, queue refills the item queue before each "
                         "kernel call and positional gives every lane a "
                         "static block of items")
    ap.add_argument("--mesh", choices=["auto", "binned", "binned2", "walk"],
                    default="auto",
                    help="closest mesh hit: auto = the BVH walk (binned "
                         "with --b1-fused), the binned intersector, the "
                         "persistent-block binned intersector (one kernel "
                         "launch per level) or the BVH walk (JAX: GRT_MESH)")
    ap.add_argument("--b1-fused", action="store_true",
                    help="binned route: one fused kernel per round (stream, "
                         "mark, next candidates; JAX: GRT_B1_FUSED=1)")
    ap.add_argument("--no-traverse8", dest="traverse8", action="store_false",
                    help="walk route: the binary skip-link BVH walk instead "
                         "of the BVH8 walk (JAX: GRT_TRAVERSE8=0)")
    ap.add_argument("--direct-rec", action="store_true",
                    help="in-kernel queue: records written in place into the "
                         "window buffers (JAX: GRT_DIRECT_REC=1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obj", default="dragon.obj", help="OBJ path for scene 8")
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler trace (Chrome JSON) here")
    ap.add_argument("--checkpoint", default="",
                    help="accumulator checkpoint path (.npz); resumes if present")
    ap.add_argument("--stats", action="store_true", help="print JSON stats")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain versions")
    args = ap.parse_args(argv)

    from go_raytracer_tpu_torch.scenes import registry

    try:
        name, fn = registry.get_scene(args.scene)
    except KeyError:
        valid = ", ".join(f"{k}={v[0]}" for k, v in registry.SCENES.items())
        print(f"error: unknown scene {args.scene!r}; valid: {valid}",
              file=sys.stderr)
        return 2
    wavefront = args.integrator == "wavefront" and not args.regen
    if wavefront and (args.direct_rec or args.schedule != "auto"):
        print("error: --direct-rec and --schedule are options of the regen "
              "integrator", file=sys.stderr)
        return 2

    import torch

    from go_raytracer_tpu_torch.integrator import regen as regen_mod
    from go_raytracer_tpu_torch.render import film

    try:
        device = regen_mod.resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"Beginning render of {name!r} on {device} . . .", file=sys.stderr)
    t0 = time.perf_counter()
    try:
        scene, cam = (fn(obj_path=args.obj) if fn is registry.model_example
                      else fn())
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.spp is not None:
        cam.samples_per_pixel = args.spp
    if args.width is not None:
        cam.width = args.width
    if args.max_depth is not None:
        cam.max_depth = args.max_depth
    build_s = time.perf_counter() - t0

    prof = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        if wavefront:
            from go_raytracer_tpu_torch.render import renderer

            linear, stats = renderer.render(
                scene, cam, seed=args.seed, mode=args.mode,
                ray_batch=args.batch, device=device,
                verbose=not args.quiet,
                checkpoint_path=args.checkpoint or None, scene_name=name,
                backend=args.backend,
                route=dict(mesh=args.mesh, b1_fused=args.b1_fused,
                           traverse8=args.traverse8))
        else:
            linear, stats = regen_mod.render_regen(
                scene, cam, seed=args.seed, n_lanes=args.lanes,
                cadence=args.cadence, schedule=args.schedule, device=device,
                mesh=args.mesh, b1_fused=args.b1_fused,
                traverse8=args.traverse8, direct_rec=args.direct_rec,
                backend=args.backend,
                checkpoint_path=args.checkpoint or None,
                scene_name=name, verbose=not args.quiet)
    except (NotImplementedError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(args.profile)
    film.write_image(args.out, film.tonemap(torch.from_numpy(linear)).numpy())

    stats["scene"] = name
    stats["scene_build_s"] = build_s
    stats["out"] = args.out
    if args.stats:
        print(json.dumps(stats))
    elif not args.quiet:
        print(f"wrote {args.out}: {stats['paths']} paths, "
              f"{stats['rays_per_s']:.3g} rays/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
