// Per-tile soft-coverage device code shared by the rasterizer kernels
// (silhouette_fused.cu, silhouette_tiles.cu). Everything here is inline
// device code or a constant, so each translation unit gets its own copy.
//
// The math mirrors jrr_tpu_torch/render/coverage.py line for line, and so
// the Pallas kernels' jrr_tpu/render/silhouette_pallas.py:41-155 except for
// the routing of the min-distance gradient at ties (exact argmin here; see
// coverage.corner_row_grads).
//
// Layout every kernel shares: one CTA per tile, 128 threads, thread k owns
// candidate lane k (one triangle). Pass 1 computes, per pixel, log(1 - p)
// for the thread's triangle and block-reduces it over the 128 lanes (warp
// shuffles, then a 4-warp shared-memory step) into alpha = 1 - exp(sum).
// Pass 2 (the gradients) recomputes the coverage per pixel and accumulates
// the thread's six corner gradients in registers.

#pragma once

#include <cuda_runtime.h>

constexpr int kLanes = 128;  // candidate lanes per tile == threads per CTA
constexpr int kWarps = kLanes / 32;
constexpr int kMaxT2 = 256;  // tile <= 16

struct Edge {
  float cross, t, rx, ry, d2;
};

struct Tri {
  float x[3], y[3];   // corners A, B, C
  float inv_len2[3];  // 1 / max(|e|^2, 1e-12) of edges AB, BC, CA
};

__device__ __forceinline__ void set_inv_len2(Tri& f) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int n = (e + 1) % 3;
    const float ex = f.x[n] - f.x[e], ey = f.y[n] - f.y[e];
    f.inv_len2[e] = 1.f / fmaxf(ex * ex + ey * ey, 1e-12f);
  }
}

__device__ __forceinline__ Edge edge_terms(float px, float py, float ax, float ay,
                                           float bx, float by, float inv_len2) {
  Edge e;
  const float ex = bx - ax, ey = by - ay;
  const float qx = px - ax, qy = py - ay;
  e.cross = ex * qy - ey * qx;
  e.t = fminf(fmaxf((qx * ex + qy * ey) * inv_len2, 0.f), 1.f);
  e.rx = qx - e.t * ex;
  e.ry = qy - e.t * ey;
  e.d2 = e.rx * e.rx + e.ry * e.ry;
  return e;
}

// Coverage p of the thread's triangle at pixel (px, py), 0 for an invalid
// lane; fills the edge terms, the minimum squared distance and the inside
// flag for the backward.
__device__ __forceinline__ float coverage(const Tri& f, bool valid, float px, float py,
                                          float inv_sigma, float blur_px2,
                                          Edge e[3], float& dmin, bool& inside) {
  e[0] = edge_terms(px, py, f.x[0], f.y[0], f.x[1], f.y[1], f.inv_len2[0]);
  e[1] = edge_terms(px, py, f.x[1], f.y[1], f.x[2], f.y[2], f.inv_len2[1]);
  e[2] = edge_terms(px, py, f.x[2], f.y[2], f.x[0], f.y[0], f.inv_len2[2]);
  dmin = fminf(fminf(e[0].d2, e[1].d2), e[2].d2);
  inside = (e[0].cross >= 0.f && e[1].cross >= 0.f && e[2].cross >= 0.f) ||
           (e[0].cross <= 0.f && e[1].cross <= 0.f && e[2].cross <= 0.f);
  const float sd2 = inside ? -dmin : dmin;
  const float p = 1.f / (1.f + expf(sd2 * inv_sigma));  // sigmoid(-sd2 / sigma)
  return (valid && sd2 <= blur_px2) ? p : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1: per pixel, sum over the 128 lanes of log(max(1 - p, 1e-30)),
// left per warp in s_part[warp][pixel]; the caller adds the four warps.
__device__ __forceinline__ void lane_log_sums(const Tri& f, bool valid, float ox, float oy,
                                              int tile, float inv_sigma, float blur_px2,
                                              float (*s_part)[kMaxT2]) {
  const int t2 = tile * tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < t2; ++i) {
    const int row = i / tile;
    const float px = ox + (float)(i - row * tile), py = oy + (float)row;
    Edge e[3];
    float dmin;
    bool inside;
    const float p = coverage(f, valid, px, py, inv_sigma, blur_px2, e, dmin, inside);
    const float s = warp_sum(logf(fmaxf(1.f - p, 1e-30f)));
    if (lane == 0) s_part[warp][i] = s;
  }
}

__device__ __forceinline__ float log_sum_total(float (*s_part)[kMaxT2], int i) {
  return s_part[0][i] + s_part[1][i] + s_part[2][i] + s_part[3][i];
}

// Pass 2: dL/d(corner) of the thread's triangle given, per pixel, dL/dalpha
// (s_g) and Pi(1 - p) over the lanes (s_total), as coverage.py's
// corner_row_grads: the min-distance subgradient goes to the edges whose d2
// equals dmin exactly (each d2 is computed once, so the comparison is
// exact), split evenly at a tie, not to every edge within the Pallas
// kernels' 1e-4 (1 + dmin) band. (pixel, lane) pairs with p in {0, 1} have
// p (1 - p) == 0 and are skipped. gx/gy[c] receive dL/d(corner c).
__device__ __forceinline__ void corner_grads(const Tri& f, bool valid, float ox, float oy,
                                             int tile, float inv_sigma, float blur_px2,
                                             const float* s_g, const float* s_total,
                                             float gx[3], float gy[3]) {
  const int t2 = tile * tile;
#pragma unroll
  for (int c = 0; c < 3; ++c) gx[c] = gy[c] = 0.f;
  for (int i = 0; i < t2; ++i) {
    const int row = i / tile;
    const float px = ox + (float)(i - row * tile), py = oy + (float)row;
    Edge e[3];
    float dmin;
    bool inside;
    const float p = coverage(f, valid, px, py, inv_sigma, blur_px2, e, dmin, inside);
    if (p == 0.f || p == 1.f) continue;
    const float one_minus = fmaxf(1.f - p, 1e-30f);
    const float dl_dp = s_g[i] * s_total[i] / one_minus;
    const float dl_dsd2 = dl_dp * (-inv_sigma) * p * (1.f - p);
    const float dl_ddmin = inside ? -dl_dsd2 : dl_dsd2;
    bool sel[3];
    int nsel = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sel[j] = e[j].d2 <= dmin;
      nsel += sel[j];
    }
    const float route = dl_ddmin * (nsel <= 1 ? 1.f : (nsel <= 2 ? 0.5f : 1.f / 3.f));
#pragma unroll
    for (int j = 0; j < 3; ++j) {  // edge j runs corner j -> corner (j+1)%3
      if (!sel[j]) continue;
      const int n = (j + 1) % 3;
      const float w = route * -2.f;
      gx[j] += w * (1.f - e[j].t) * e[j].rx;
      gy[j] += w * (1.f - e[j].t) * e[j].ry;
      gx[n] += w * e[j].t * e[j].rx;
      gy[n] += w * e[j].t * e[j].ry;
    }
  }
}
