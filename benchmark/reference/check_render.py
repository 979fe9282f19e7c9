"""The comparison that decides a render cell's `correct`.

A render is a Monte Carlo estimate, and the program draws its random
numbers inside its kernels, keyed by the lane and level that its
schedule gave a path. So the reference does not follow the program's
paths: it renders the same pixels R times with numbers of its own, and
the comparison is a statistical one at those pixels, over the images
the window finished. Each pixel channel ("value") is scaled
by its pooled variance: the spread of the K program images and of the R
reference renders about their own means, so that no few bright, noisy
pixels carry the sums.

- `bias`: the mean over the values of the squared gap between the
  program's mean image and the reference's, over the variance that gap
  has when both sides estimate the same image (1/K + 1/R of a sample's),
  less 1. About 0; a wrong expectation anywhere in the sample raises it.
- `noise`: |log2| of the ratio of the program's per-image variance to the
  reference's, each value scaled by the pooled variance. About 0; a
  program that drops half of each pixel's samples reads about 1, one that
  returns the same image for every seed reads infinity.
- `energy`: the gap between the program's and the reference's summed
  radiance over the sample (each pixel's three channels together), over
  that gap's standard deviation, in absolute value: a z-score, about
  N(0, 1). A fault that moves the expectation the same way at many
  pixels (a surface that reflects a tenth too little) raises it far
  sooner than `bias`, which weighs each value's gap alone.
- `worst_image`: the largest over every image of the window of one
  image's mean squared gap to the reference's mean image, over its
  expected value (1 + 1/R of a sample's variance, pooled over every
  image and reference render), less 1. About 0; one altered image
  raises it.

`bias`, `noise` and `energy` read the K images that the run draws from
the seed among the window's (all of them where the window has fewer);
`worst_image` reads every image.

A gap over a pooled variance of K + R - 2 degrees of freedom reads (K +
R - 2) / (K + R - 4) on average, where the variance were known it would
read 1; `bias` and `worst_image` are scaled back by that factor, so that
they read about 0 whatever the number of images.

A value whose pooled variance is 0 (a pixel that sees only the light)
must agree to float32 rounding; a gap there reads infinity.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import pathtrace as pt


def sample_pixels(seed: int, height: int, width: int, n: int) -> np.ndarray:
    """n distinct flat pixel ids drawn from the seed."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x9A17])
    return np.sort(rng.choice(height * width, size=n, replace=False))


def render_pixels(cfg: dict, pixels: np.ndarray, seed: int, device,
                  dtype=torch.float32, max_rays: int = 1 << 19,
                  keep: float = 1.0, albedo: float = 1.0,
                  scene=None) -> np.ndarray:
    """(n, 3) float64 mean radiance of each pixel over every stratum of
    the configuration's camera, with the reference's own random numbers
    drawn from `seed`. `keep` < 1 keeps only that share of each pixel's
    samples, `albedo` scales the colour of every material that emits no
    light (planted faults). `scene`: the configuration's
    `pathtrace.Scene` in `dtype`, if already built."""
    cam = cfg["camera"]
    frame = pt.camera_frame(cam)
    sc = scene or pt.Scene(cfg, device, dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    q = frame["sqrt_spp"]
    strata = q * q
    per = max(1, int(strata * keep))
    pix = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    n_pix = pix.shape[0]
    ids = pix.repeat_interleave(per)
    st = torch.arange(per, device=device).repeat(n_pix)
    acc = torch.zeros((n_pix * per, 3), dtype=torch.float64, device=device)
    light = (sc.kind == pt.KINDS["diffuse_light"])[:, None]
    colors = torch.where(light, sc.colors, sc.colors * albedo)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for a in range(0, ids.shape[0], max_rays):
            i, s = ids[a:a + max_rays], st[a:a + max_rays]
            m = i.shape[0]
            ucam = torch.rand((m, pt.N_U_CAMERA), generator=g, device=device)
            o, d = pt.camera_rays(frame, i, (s // q).to(dtype),
                                  (s % q).to(dtype), ucam.to(dtype), dtype)
            L = pt.radiance(
                sc, o, d, cam["max_depth"], cam["max_contribution"],
                lambda lv: torch.rand((m, pt.N_U), generator=g, device=device),
                colors=colors)
            acc[a:a + m] = torch.nan_to_num(L.double(), nan=0.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return acc.view(n_pix, per, 3).mean(1).cpu().numpy()


def sample_images(seed: int, count: int, k: int) -> np.ndarray:
    """The sorted indices of the k images (all where count <= k) that
    `bias`, `noise` and `energy` read, drawn from the seed."""
    if count <= k:
        return np.arange(count)
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x1A6E])
    return np.sort(rng.choice(count, size=k, replace=False))


def numbers(program: np.ndarray, refs: np.ndarray,
            compared: np.ndarray | None = None) -> dict:
    """`bias`, `noise`, `energy` and `worst_image` of the program's
    (images, n, 3) values at the sampled pixels against R reference
    renders (R, n, 3); `compared`: the indices of the K images that
    `bias`, `noise` and `energy` read (default: all)."""
    every = np.asarray(program, dtype=np.float64)
    if compared is not None:
        program = every[compared]
    p = np.asarray(program, dtype=np.float64).reshape(len(program), -1)
    r = np.asarray(refs, dtype=np.float64).reshape(len(refs), -1)
    k, nr = p.shape[0], r.shape[0]
    if k < 2 or nr < 2 or k + nr < 5:
        raise ValueError("the comparison needs two images a side or more, "
                         "five in all")
    p_mean, r_mean = p.mean(0), r.mean(0)
    p_ss = ((p - p_mean) ** 2).sum(0)
    r_ss = ((r - r_mean) ** 2).sum(0)
    pooled = (p_ss + r_ss) / (k + nr - 2)
    live = pooled > 0
    dead_gap = (np.abs(p_mean - r_mean)
                / np.maximum(1.0, np.abs(r_mean)))[~live].max(initial=0.0)
    if dead_gap > 1e-5 or not live.any():
        return {"bias": math.inf, "noise": math.inf, "energy": math.inf,
                "worst_image": math.inf}
    w = 1.0 / pooled[live]
    dof = k + nr - 2
    unbias = (dof - 2) / dof
    gap = (p_mean - r_mean)[live]
    bias = unbias * float(np.mean(gap ** 2 * w) / (1.0 / k + 1.0 / nr)) - 1.0
    ratio = float(np.mean(p_ss[live] / (k - 1) * w)
                  / np.mean(r_ss[live] / (nr - 1) * w))
    noise = abs(math.log2(ratio)) if ratio > 0 else math.inf
    # the summed radiance: each pixel's channels together, pixels apart
    ps = np.asarray(program, dtype=np.float64).sum(-1)
    rs = np.asarray(refs, dtype=np.float64).sum(-1)
    pooled_s = (((ps - ps.mean(0)) ** 2).sum(0)
                + ((rs - rs.mean(0)) ** 2).sum(0)) / dof
    sd = math.sqrt(float(pooled_s.sum()) * (1.0 / k + 1.0 / nr))
    total = float((ps.mean(0) - rs.mean(0)).sum())
    energy = abs(total) / sd if sd > 0 else math.inf
    # each image against the variance of every image and reference render:
    # a value that a rare bright sample lights in one image of many is not
    # judged by the spread of a few images that missed it
    e = every.reshape(len(every), -1)
    dof_e = len(e) + nr - 2
    pooled_e = (((e - e.mean(0)) ** 2).sum(0) + r_ss) / dof_e
    live_e = pooled_e > 0
    per_image = (dof_e - 2) / dof_e * ((e[:, live_e] - r_mean[live_e]) ** 2
                                       / pooled_e[live_e]).mean(1) \
        / (1.0 + 1.0 / nr)
    return {"bias": bias, "noise": noise, "energy": energy,
            "worst_image": float(per_image.max()) - 1.0}
