#!/usr/bin/env python3
"""Check on the CPU that the culled scan of the bounce core changes no
winner: compile csrc/bounce_core.cuh with the host's C++ compiler against a
stand-in for the few CUDA built-ins it uses, and run `bounce_core` on many
rays twice: on the kernels' scan table (ops/bounce.scan_layout: spheres
in Morton order, every section of more than one block culled, winners by
(t, row)), and on the same rows in declaration order with every block's
bounds opened to the whole space, so that no block is skipped (the
reference's scan); every output of every ray must be equal bit for bit.

    python3 scripts/check_cull_host.py [--rays 300000] [--pad VALUE]
                                       [--cxx c++] [--flags "-O2 -mfma"]

The tables are book1's (389 spheres, 49 blocks), book2's (1,006 spheres,
a quad and 400 boxes, none rotated: the box reciprocals hoisted) and the
synthetic scan scene at 2,400 spheres, 40 quads and 20 rotated boxes
(scenes/synthetic.py, its inactive rows cleared; past the staging
budget, so its last spheres, its quads and its boxes are read from the
table). A third of the rays
are random over the scene's bounds, a third aimed at the rim of a random
sphere at its ray time, within 1e-3 of its radius, from 1-31 units away
or 100-500, and a third at a random point on an edge of a random quad or
box row's bounds (the sphere rim where the table has neither): the grazing
rays whose hits the rounding moves most. --pad replaces CULL_PAD in a
copy of the header and in the blocks' pads of the scan table (a mutation
check: a pad far below the one the header
derives must make rays differ, or the check would not see a wrong cull).
The build goes to build/check_cull_host/ (git-ignored). Exits non-zero if
a ray differs. The host's rounding is not the card's (no contraction
unless the flags ask for it, libm's sin and cos): it checks the cull's
logic and its margin, chip_smoke.py phase 23 the kernels on the card.
"""

import argparse
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from go_raytracer_tpu_torch.ops import bounce  # noqa: E402
from go_raytracer_tpu_torch.scenes import registry, synthetic  # noqa: E402

CSRC = os.path.join(ROOT, "go_raytracer_tpu_torch", "ops", "csrc")
OUT = os.path.join(ROOT, "build", "check_cull_host")

# the CUDA names bounce_core.cuh uses, for a host compiler: one thread, a
# block of one thread, read-only loads as plain loads
STANDIN = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x, y, z; };
static dim3 threadIdx{0, 0, 0}, blockDim{1, 1, 1};
template <class T> T __ldg(const T* p) { return *p; }
inline void __syncthreads() {}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline void __sincosf(float x, float* s, float* c) { *s = sinf(x); *c = cosf(x); }
inline float rsqrtf(float a) { return 1.0f / sqrtf(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
using std::isfinite;
typedef int cudaError_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes { size_t sharedSizeBytes, localSizeBytes; int numRegs; };
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, const void*) { return 0; }
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, const void*, int, size_t) {
  return 0;
}
"""

CHECK_SRC = r"""
#include "cuda_runtime.h"
#include "bounce_core.cuh"
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

float4 grt_geo[STAGE_BYTES / 16];

struct Out {
  float f[9];
  bool emit, cf, alive;
};

template <bool CULL, bool TEX>
static Out run(const BounceTables& T, const float* o, const float* d, float tm, const float* u) {
  const BounceResult a = bounce_core<true, true, false, TEX, CULL>(
      T, o[0], o[1], o[2], d[0], d[1], d[2], tm, u, nullptr, NoMediaU{});
  return Out{{a.vr, a.vg, a.vb, a.ox, a.oy, a.oz, a.dx, a.dy, a.dz}, a.emit, a.cf, a.alive};
}

template <bool CULL>
static std::vector<Out> run_all(const BounceTables& T, const std::vector<float>& rays) {
  stage_geometry(T);
  std::vector<Out> out;
  for (size_t i = 0; i < rays.size(); i += 7 + N_U) {
    const float* r = &rays[i];
    out.push_back(T.scale_col >= 0 ? run<CULL, true>(T, r, r + 3, r[6], r + 7)
                                   : run<CULL, false>(T, r, r + 3, r[6], r + 7));
  }
  return out;
}

int main(int argc, char** argv) {
  FILE* f = std::fopen(argv[1], "rb");
  int h[20];
  if (!f || std::fread(h, 4, 20, f) != 20) return 2;
  std::vector<float> P(h[0] * h[1]), Lt(h[2] * L_COLS), box(6);
  std::vector<float4> culled(h[19]), decl(h[19]);
  if (std::fread(P.data(), 4, P.size(), f) != P.size()) return 2;
  if (std::fread(Lt.data(), 4, Lt.size(), f) != Lt.size()) return 2;
  if (std::fread(box.data(), 4, 6, f) != 6) return 2;
  if (std::fread(culled.data(), 16, h[19], f) != (size_t)h[19]) return 2;
  if (std::fread(decl.data(), 16, h[19], f) != (size_t)h[19]) return 2;
  const int n_edge = h[15];
  std::vector<float> edge(6 * n_edge);  // bounds of the quad and box rows
  if (std::fread(edge.data(), 4, edge.size(), f) != edge.size()) return 2;
  std::fclose(f);
  float bg[3] = {0.7f, 0.8f, 1.0f};
  BounceTables T;
  T.prims = P.data();
  T.lights = Lt.data();
  T.med = nullptr;
  T.bg = bg;
  T.p_cols = h[1];
  T.quad_base = h[5];
  T.n_lights = h[9], T.n_lights_live = h[10];
  T.fr_col = h[11], T.n_media = 0, T.texk_col = h[12], T.scale_col = h[13];
  T.seed_col = h[14];
  T.n_sph = h[16], T.n_quad = h[17], T.n_box = h[18];
  T.rot = h[4];
  T.img = nullptr, T.img_wh = nullptr, T.img_h = T.img_w = 0;
  const StageLayout L = stage_layout(T.n_sph, T.n_quad, T.n_box);
  std::printf("scan table %d float4s, %d staged (%d B)\n", h[19], L.staged, L.bytes);
  std::mt19937 rng(1234);
  std::uniform_real_distribution<float> U(0, 1);
  std::normal_distribution<float> N(0, 1);
  const long long n = std::atoll(argv[2]);
  std::vector<float> rays;
  for (long long i = 0; i < n; ++i) {
    float o[3], d[3];
    const float tm = U(rng);
    const int kind = n_edge == 0 && i % 3 == 2 ? 1 : (int)(i % 3);
    if (kind == 0) {  // random rays over the scene's bounds
      for (int k = 0; k < 3; ++k) o[k] = box[k] + U(rng) * (box[3 + k] - box[k]);
      for (int k = 0; k < 3; ++k) d[k] = N(rng) * 3;
    } else if (kind == 1) {  // at the rim of an active sphere, near or far
      const float* g;
      do g = &P[(h[3] + rng() % h[6]) * h[1]]; while (g[0] < 0);
      const float c[3] = {g[1] + tm * g[4], g[2] + tm * g[5], g[3] + tm * g[6]};
      const float dist = i % 2 ? 1 + 30 * U(rng) : 100 + 400 * U(rng);
      float w[3] = {N(rng), N(rng), N(rng)}, v[3] = {N(rng), N(rng), N(rng)};
      const float wn = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
      for (int k = 0; k < 3; ++k) o[k] = c[k] + w[k] / wn * dist;
      const float vw = (v[0] * w[0] + v[1] * w[1] + v[2] * w[2]) / (wn * wn);
      for (int k = 0; k < 3; ++k) v[k] -= vw * w[k];
      const float vn = std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
      const float rim = std::fabs(g[7]) * (1 + (U(rng) - 0.5f) * 2e-3f);
      for (int k = 0; k < 3; ++k) d[k] = c[k] + v[k] / vn * rim - o[k];
    } else {  // at a point on an edge of a quad's or box's bounds
      const float* e = &edge[6 * (rng() % n_edge)];
      const int ax = rng() % 3;
      float p[3];
      for (int k = 0; k < 3; ++k)
        p[k] = k == ax ? e[k] + U(rng) * (e[3 + k] - e[k]) : (rng() & 1 ? e[3 + k] : e[k]);
      const float dist = i % 2 ? 1 + 30 * U(rng) : 100 + 400 * U(rng);
      float w[3] = {N(rng), N(rng), N(rng)};
      const float wn = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
      for (int k = 0; k < 3; ++k) o[k] = p[k] + w[k] / wn * dist;
      for (int k = 0; k < 3; ++k) d[k] = p[k] - o[k];
    }
    rays.insert(rays.end(), o, o + 3);
    rays.insert(rays.end(), d, d + 3);
    rays.push_back(tm);
    for (int k = 0; k < N_U; ++k) rays.push_back(U(rng));
  }
  T.scan = culled.data();
  const std::vector<Out> a = run_all<true>(T, rays);
  T.scan = decl.data();
  const std::vector<Out> b = run_all<true>(T, rays);
  long long differ = 0;
  for (long long i = 0; i < n; ++i) {
    const bool ok = std::memcmp(a[i].f, b[i].f, sizeof a[i].f) == 0 &&
                    a[i].emit == b[i].emit && a[i].cf == b[i].cf && a[i].alive == b[i].alive;
    differ += ok ? 0 : 1;
  }
  std::printf("%lld rays, %lld differ\n", n, differ);
  return differ != 0;
}
"""


def write_table(path, scene, prims=None, pad=None):
    """The packed tables, the core's table ints, the scene's bounds, the
    two scan tables (the kernels' and the declaration-order one) and the
    bounds of every quad and box row, as the C++ check reads them."""
    p, lights, *_ = bounce.pack_scene(scene)
    p = p if prims is None else prims
    st = bounce.scene_statics(scene)
    lay = bounce._mat_layout(st)
    col = lambda nm: bounce.MAT_BASE + lay.index(nm) if nm in lay else -1
    culled = bounce.scan_layout(
        p, st, pad=bounce.SCAN_PAD if pad is None else float(pad))
    decl = bounce.scan_layout(p, st, sphere_order="decl")
    assert culled.counts == decl.counts and culled.rot == decl.rot
    # the declaration-order table's blocks hold everything: no block is
    # skipped there
    at = 0
    for sec, n in enumerate(decl.counts):
        nb = -(-n // bounce.SCAN_BLOCK)
        bnd = decl.table[at:at + 2 * nb].reshape(nb, 2, 4)
        bnd[:, 0] = (-3e38, -3e38, -3e38, 0.0)
        bnd[:, 1] = (3e38, 3e38, 3e38, 0.0)
        at += 2 * nb + bounce.SCAN_F4[sec] * n
    edges = np.concatenate([np.concatenate([culled.row_lo[s],
                                            culled.row_hi[s]], axis=1)
                            for s in (1, 2)]).reshape(-1, 6)
    if len(edges):
        edges = edges[(edges[:, 3:] >= edges[:, :3]).all(axis=1)]
    lo = np.min([x.min(axis=0) for x in culled.row_lo if len(x)], axis=0)
    hi = np.max([x.max(axis=0) for x in culled.row_hi if len(x)], axis=0)
    bounds = np.concatenate([lo, hi]).astype(np.float32)
    hdr = np.array([p.shape[0], p.shape[1], lights.shape[0], st["sph_base"],
                    int(culled.rot), st["quad_base"], st["n_sph"],
                    st["box_base"], 0, st["n_lights"], st["n_lights_live"],
                    col("fr"), col("texk"), col("scale"), col("seed_img"),
                    len(edges), *culled.counts, culled.table.shape[0]],
                   np.int32)
    with open(path, "wb") as fh:
        for x in (hdr, np.ascontiguousarray(p, np.float32),
                  np.ascontiguousarray(lights, np.float32), bounds,
                  culled.table, decl.table,
                  np.ascontiguousarray(edges, np.float32)):
            fh.write(x.tobytes())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=300000)
    ap.add_argument("--pad", help="CULL_PAD of the copy under test")
    ap.add_argument("--cxx", default=shutil.which("c++") or "g++")
    ap.add_argument("--flags", default="-O2")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "cuda_runtime.h"), "w") as fh:
        fh.write(STANDIN)
    with open(os.path.join(CSRC, "bounce_core.cuh")) as fh:
        core = fh.read()
    if args.pad:
        core = re.sub(r"#define CULL_PAD \S+", f"#define CULL_PAD {args.pad}f",
                      core)
    with open(os.path.join(OUT, "bounce_core.cuh"), "w") as fh:
        fh.write(core)
    with open(os.path.join(OUT, "check.cpp"), "w") as fh:
        fh.write(CHECK_SRC)
    exe = os.path.join(OUT, "check")
    subprocess.run([args.cxx, "-std=c++17", *args.flags.split(), "-I", OUT,
                    "-o", exe, os.path.join(OUT, "check.cpp")], check=True)
    scan, _, tabs, st = synthetic.build(2400, 40, 20)
    tables = {"book1": (registry.book1()[0], None),
              "book2": (registry.book2()[0], None),
              "scan 2400/40/20": (scan, tabs[0])}
    bad = 0
    for name, (scene, prims) in tables.items():
        path = os.path.join(OUT, name.split()[0] + ".bin")
        write_table(path, scene, prims, args.pad)
        run = subprocess.run([exe, path, str(args.rays)], capture_output=True,
                             text=True)
        print(f"{name} (CULL_PAD {args.pad or 'as in the header'}, "
              f"{args.cxx} {args.flags}): "
              + run.stdout.strip().replace("\n", "; "))
        bad += run.returncode != 0
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
