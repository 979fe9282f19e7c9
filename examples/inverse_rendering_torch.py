"""Inverse rendering with the PyTorch port: recover scene parameters from
a rendered image.

The port's reference engine (integrator/wavefront.radiance, mode "scan")
is tensor code that autograd runs through, so scene recovery is plain
gradient descent: render a target image with the true parameters,
perturb them, and fit them back by minimising the MSE between fresh
renders and the target (Adam).

This recovers the Cornell-style box's back-wall albedo and the light's
emission together. The scene, flags, defaults and output fields are
examples/inverse_rendering.py's. Runs on the GPU unless --cpu is given;
there each fitting step replays as one CUDA graph.

Run:  python examples/inverse_rendering_torch.py [--steps 150] [--cpu]
          [--out inverse_rendering.npz]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_scene():
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder(background=(0, 0, 0))
    b.quad((2.5, 0, 0), (0, 2.5, 0), (0, 0, 2.5), b.lambertian((0.12, 0.45, 0.15)))
    b.quad((0, 0, 0), (0, 2.5, 0), (0, 0, 2.5), b.lambertian((0.65, 0.05, 0.05)))
    b.quad((0, 0, 0), (2.5, 0, 0), (0, 0, 2.5), b.lambertian((0.73, 0.73, 0.73)))
    b.quad((2.5, 2.5, 2.5), (-2.5, 0, 0), (0, 0, -2.5), b.lambertian((0.73, 0.73, 0.73)))
    # the parameter of interest: back wall albedo
    back = b.lambertian((0.73, 0.73, 0.73))
    b.quad((0, 0, 2.5), (2.5, 0, 0), (0, 2.5, 0), back)
    light = b.diffuse_light((9.0, 9.0, 9.0))
    lq = b.quad((1.55, 2.48, 1.5), (-0.6, 0, 0), (0, 0, -0.5), light)
    b.add_light(lq)
    return b.build(), back, light


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--width", type=int, default=24)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--out", default="inverse_rendering.npz")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from go_raytracer_tpu_torch.integrator import regen, wavefront
    from go_raytracer_tpu_torch.ops import _cuda
    from go_raytracer_tpu_torch.ops import trace as trace_mod
    from go_raytracer_tpu_torch.parallel import mesh as pmesh
    from go_raytracer_tpu_torch.render.camera import Camera

    device = regen.resolve_device("cpu" if args.cpu else None)
    scene, back_mat, light_mat = build_scene()
    back_tex = int(scene.materials.tex_id[back_mat])
    light_tex = int(scene.materials.tex_id[light_mat])

    cam = Camera(width=args.width, aspect_ratio=1.0, samples_per_pixel=1,
                 max_depth=args.max_depth, vertical_fov=40)
    cam.position((1.25, 1.25, -3.4), (1.25, 1.25, 0))
    arrays = cam.derived().to(device)
    npix = cam.width * cam.image_height
    ids = pmesh.pixel_ids(npix, args.spp, device)
    ds = trace_mod.to_device(scene, device)

    def render(params, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        img, _ = pmesh.render_batches(pmesh.apply_params(ds, params), arrays,
                                      cam.width, ids, cam.max_depth,
                                      cam.max_contribution, gen)
        return img

    true_params = {k: v.detach().clone()
                   for k, v in pmesh.extract_params(ds).items()}
    true_albedo = true_params["tex_color"][back_tex].cpu().numpy()
    true_emit = true_params["tex_color"][light_tex].cpu().numpy()

    # high-quality target (more samples than the fitting renders)
    print("rendering target...", file=sys.stderr)
    with torch.no_grad():
        target = torch.stack([render(true_params, 999 * 8 + k)
                              for k in range(8)]).mean(dim=0)

    # perturb: wrong back-wall albedo, wrong emission intensity
    params = {k: v.clone() for k, v in true_params.items()}
    params["tex_color"][back_tex] = torch.tensor([0.15, 0.6, 0.75])
    params["tex_color"][light_tex] = torch.tensor([4.0, 4.0, 4.0])
    for v in params.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=args.lr,
                           capturable=device.type == "cuda")
    # only the two free parameters move
    mask = torch.zeros_like(params["tex_color"])
    mask[back_tex] = 1.0
    mask[light_tex] = 1.0

    # A step reads its uniforms from fixed buffers, drawn before it from
    # the step's own generator in the order render() draws them, so that
    # on the GPU the whole step (render, loss, backward, mask, Adam,
    # clamp) replays as one CUDA graph (ops/_cuda.StepGraph).
    n_u = wavefront.N_FIXED_U + ds.media.kind.shape[0]
    uni = pmesh.StepUniforms.empty(ids.numel(), cam.max_depth + 1, n_u,
                                   device)

    def body():
        opt.zero_grad(set_to_none=False)
        img, _ = pmesh.render_batches(
            pmesh.apply_params(ds, params), arrays, cam.width, ids,
            cam.max_depth, cam.max_contribution, None,
            uniforms=(uni.camera, uni.levels))
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        for k, v in params.items():
            if v.grad is None:
                v.grad = torch.zeros_like(v)
            if k == "tex_color":
                v.grad.mul_(mask)
            else:
                v.grad.zero_()
        opt.step()
        with torch.no_grad():
            params["tex_color"].clamp_(0.0, 20.0)
        return loss.detach()

    step = _cuda.StepGraph(body, graph=device.type == "cuda", device=device)
    losses, alb_err, emit_err = [], [], []
    t0 = time.time()
    for i in range(args.steps):
        uni.draw(torch.Generator(device=device).manual_seed(1000 + i))
        loss = step()
        tex = params["tex_color"].detach().cpu().numpy()
        losses.append(loss.item())
        alb_err.append(float(np.abs(tex[back_tex] - true_albedo).max()))
        emit_err.append(float(np.abs(tex[light_tex] - true_emit).max()))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.5f} "
                  f"albedo_err {alb_err[-1]:.4f} emit_err {emit_err[-1]:.4f}",
                  file=sys.stderr)

    tex = params["tex_color"].detach().cpu().numpy()
    rec_albedo, rec_emit = tex[back_tex], tex[light_tex]
    with torch.no_grad():
        final = render(params, 7)
    np.savez(args.out,
             losses=np.asarray(losses),
             albedo_err=np.asarray(alb_err), emit_err=np.asarray(emit_err),
             true_albedo=true_albedo, recovered_albedo=rec_albedo,
             true_emission=true_emit, recovered_emission=rec_emit,
             target=target.cpu().numpy(), final=final.cpu().numpy())
    summary = {
        "elapsed_s": time.time() - t0,
        "device": str(device),
        "final_loss": losses[-1] if losses else None,
        "albedo_true": true_albedo.tolist(),
        "albedo_recovered": rec_albedo.tolist(),
        "albedo_abs_err": alb_err[-1] if alb_err else None,
        "emission_true": true_emit.tolist(),
        "emission_recovered": rec_emit.tolist(),
        "emission_abs_err": emit_err[-1] if emit_err else None,
        "out": args.out,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
