// Per-tile soft-coverage device code shared by the rasterizer kernels
// (silhouette_fused.cu, silhouette_tiles.cu). Everything here is inline
// device code or a constant, so each translation unit gets its own copy.
//
// The math mirrors jrr_tpu_torch/render/coverage.py line for line, and so
// the Pallas kernels' jrr_tpu/render/silhouette_pallas.py:41-155 except for
// the routing of the min-distance gradient at ties (exact argmin here; see
// coverage.corner_row_grads).
//
// Every kernel runs one CTA per tile (or lane-packed pair of tiles), 128
// threads, thread k owning candidate lane k (one triangle), and covers the
// tile on the pairs near a triangle only (pixel_box, near_log_sums,
// box_corner_grads): the alpha kernels fused_alpha_fwd_kernel and
// tiles_alpha_fwd_kernel (pass 1 only), the loss kernels
// fused_lossgrad_kernel and fused_lossgrad_packed_kernel, the alpha VJP
// fused_alpha_bwd_kernel and the round-1 backward tiles_alpha_bwd_kernel
// (passes 1 and 2). p > 0 only within the blur radius of a triangle (~1.1
// px at 224^2, 0.56 px at 112^2), so ~8% of the fused bins' (pixel, lane)
// pairs and ~2% of the round-1 tiles' can have p > 0. Each lane marks its
// pixels in a per-pixel 128-bit lane mask; pass 1 walks each pixel's set
// lanes, pass 2 each lane's own pixels. Pairs outside the box have p == 0
// exactly, so they add log(1) = 0 and no gradient. All six kernels run one
// pass 1 (near_log_sums), so on the same lanes they form the same
// Pi(1 - p) bit for bit. A lane-packed row splits its lanes into two
// halves, each a tile at its own origin: a half's lanes mark and sum only
// its own tile's pixels.

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

// Coverage p of the triangle at pixel (px, py); fills the edge terms, the
// minimum squared distance and the inside flag for the backward.
__device__ __forceinline__ float coverage(const Tri& f, float px, float py,
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
  return sd2 <= blur_px2 ? p : 0.f;
}

// One (pixel, lane) pair of pass 2: adds dL/d(corner) of the triangle at
// pixel (px, py) given dL/dalpha (g) and Pi(1 - p) over the lanes (total)
// there, as coverage.py's corner_row_grads: the min-distance subgradient
// goes to the edges whose d2 equals dmin exactly (each d2 is computed once,
// so the comparison is exact), split evenly at a tie, not to every edge
// within the Pallas kernels' 1e-4 (1 + dmin) band. Pairs with p in {0, 1}
// have p (1 - p) == 0 and are skipped. gx/gy[c] receive dL/d(corner c).
__device__ __forceinline__ void pixel_corner_grads(const Tri& f, float px, float py,
                                                   float inv_sigma, float blur_px2, float g,
                                                   float total, float gx[3], float gy[3]) {
  Edge e[3];
  float dmin;
  bool inside;
  const float p = coverage(f, px, py, inv_sigma, blur_px2, e, dmin, inside);
  if (p == 0.f || p == 1.f) return;
  const float one_minus = fmaxf(1.f - p, 1e-30f);
  const float dl_dp = g * total / one_minus;
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

// The blur radius grown by 2^-10: the edge distances round with an error
// of a few ulp of the edge length, and a pair the box dropped would lose
// its log term and its gradient; the pixels the growth adds cost nothing
// measurable. A face whose |2 area| is at most kSliver times the sum of its
// squared edge lengths (zero-area and edge-on faces, and NaN corners) can
// pass the inside test far from its box (all three cross products round to
// one sign, or are 0 for a point face), so it covers its whole tile. Why
// 2^-12 suffices: that ratio is at most sin(smallest angle) / 2, so other
// faces have a smallest angle above 2^-11. A pixel at distance D from such a
// face has a cross product of the wrong sign of at least |e| D sin(2^-12),
// while a cross product rounds by about 2^-22 |e| |q| (|q| the pixel's
// distance from the edge's first corner): the sign holds for |q| up to
// 2^10 D, 570 px at the smallest blur radius the path uses (0.56 px).
// render/coverage.py::near_box mirrors this test op for op.
constexpr float kBoxGrow = 1.0009765625f;  // 1 + 2^-10
constexpr float kSliver = 0.000244140625f;  // 2^-12

// The tile rows and columns (bits, tile <= 16) within the blur radius of
// the triangle's bounding box: every pixel (row, col) with p > 0 has both
// bits set. Pixel coordinates as coverage(): ox + col, oy + row.
struct PixelBox {
  unsigned rows, cols;
};

__device__ __forceinline__ PixelBox pixel_box(const Tri& f, float ox, float oy, int tile,
                                              float blur_px2) {
  const unsigned full = (1u << tile) - 1u;
  // Rounded one op at a time (no FMA contraction), as near_box.
  const float ex0 = __fsub_rn(f.x[1], f.x[0]), ey0 = __fsub_rn(f.y[1], f.y[0]);
  const float ex1 = __fsub_rn(f.x[2], f.x[1]), ey1 = __fsub_rn(f.y[2], f.y[1]);
  const float ex2 = __fsub_rn(f.x[0], f.x[2]), ey2 = __fsub_rn(f.y[0], f.y[2]);
  const float a2 = __fsub_rn(__fmul_rn(ex0, __fsub_rn(f.y[2], f.y[0])),
                             __fmul_rn(ey0, __fsub_rn(f.x[2], f.x[0])));
  float len2 = __fadd_rn(__fmul_rn(ex0, ex0), __fmul_rn(ey0, ey0));
  len2 = __fadd_rn(__fadd_rn(len2, __fmul_rn(ex1, ex1)), __fmul_rn(ey1, ey1));
  len2 = __fadd_rn(__fadd_rn(len2, __fmul_rn(ex2, ex2)), __fmul_rn(ey2, ey2));
  if (!(fabsf(a2) > __fmul_rn(len2, kSliver))) return {full, full};
  const float r = __fmul_rn(sqrtf(fmaxf(blur_px2, 0.f)), kBoxGrow);
  const float xmin = fminf(fminf(f.x[0], f.x[1]), f.x[2]);
  const float xmax = fmaxf(fmaxf(f.x[0], f.x[1]), f.x[2]);
  const float ymin = fminf(fminf(f.y[0], f.y[1]), f.y[2]);
  const float ymax = fmaxf(fmaxf(f.y[0], f.y[1]), f.y[2]);
  PixelBox box = {0u, 0u};
  for (int j = 0; j < tile; ++j) {
    const float px = ox + (float)j, py = oy + (float)j;
    if (px - xmax <= r && xmin - px <= r) box.cols |= 1u << j;
    if (py - ymax <= r && ymin - py <= r) box.rows |= 1u << j;
  }
  return box;
}

// The triangles of a tile's 128 lanes in shared memory, one row per
// coordinate (x0 x1 x2 y0 y1 y2 inv_len2[0..2]), so that any thread can
// evaluate any lane.
struct StagedTris {
  float v[9][kLanes];
};

__device__ __forceinline__ void stage_tri(StagedTris& s, const Tri& f, int k) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.v[c][k] = f.x[c];
    s.v[3 + c][k] = f.y[c];
    s.v[6 + c][k] = f.inv_len2[c];
  }
}

__device__ __forceinline__ Tri staged_tri(const StagedTris& s, int lane) {
  Tri f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.x[c] = s.v[c][lane];
    f.y[c] = s.v[3 + c][lane];
    f.inv_len2[c] = s.v[6 + c][lane];
  }
  return f;
}

// Per pixel i, the lanes whose box holds it: bit (k & 31) of
// s_lmask[i][k >> 5], set by thread k over its own box with atomicOr (an
// OR does not depend on the order). The box is taken at the lane's own
// tile's origin, so in a lane-packed row words 0-1 hold tile A's lanes at
// A's pixel i and words 2-3 tile B's at B's pixel i. A lane that must add
// nothing passes an empty box. Called by all 128 threads; the caller must
// __syncthreads() before reading s_lmask.
__device__ __forceinline__ void stage_lane_masks(PixelBox box, int tile,
                                                 unsigned (*s_lmask)[kWarps]) {
  const int k = threadIdx.x;
  unsigned* flat = &s_lmask[0][0];
  for (int w = k; w < tile * tile * kWarps; w += kLanes) flat[w] = 0u;
  __syncthreads();
  const unsigned bit = 1u << (k & 31);
  for (unsigned rs = box.rows; rs; rs &= rs - 1u) {
    const int row = __ffs(rs) - 1;
    for (unsigned cs = box.cols; cs; cs &= cs - 1u)
      atomicOr(&s_lmask[row * tile + __ffs(cs) - 1][k >> 5], bit);
  }
}

// Lane groups per item in box_log_sums: the most (a power of two, each
// group holding >= 16 of the item's `lanes` lanes) for which groups x items
// fit in the 128 threads. One tile (128 lanes): 2 at tile 8, 8 at tile 4; 1
// above 64 pixels, and above 128 a thread takes two pixels. Two packed
// tiles (64 lanes each, 2 T^2 items): 1 at tile 8, 4 at tile 4.
__device__ __forceinline__ int lane_groups(int items, int lanes) {
  int g = 1;
  while (32 * g <= lanes && 2 * g * items <= kLanes) g *= 2;
  return g;
}

// Pass 1 over the lane masks. The lanes form `halves` (1 or 2) equal sets,
// each a tile at its own origin: (ox, oy) for lanes [0, 128 / halves),
// (ox_b, oy_b) for the rest. Per half h and pixel i of its tile,
// s_logsum[h * T^2 + i] = sum over the half's lanes in pixel i's mask of
// log(max(1 - p, 1e-30)). G = lane_groups consecutive threads share an
// item, each walking the set bits of its share of the half's lanes in
// ascending lane order; their partial sums combine in a fixed butterfly
// (commutative at each step, so every thread of the group holds the same
// total). The lanes outside a pixel's mask would add log(1) = 0. Called
// by all 128 threads.
__device__ __forceinline__ void box_log_sums(const StagedTris& s_tri,
                                             unsigned (*s_lmask)[kWarps], int halves, float ox,
                                             float oy, float ox_b, float oy_b, int tile,
                                             float inv_sigma, float blur_px2, float* s_logsum) {
  const int t2 = tile * tile, items = halves * t2, lanes = kLanes / halves;
  const int groups = lane_groups(items, lanes), width = lanes / groups;
  for (int base = 0; base < items * groups; base += kLanes) {  // uniform across the CTA
    const int w = base + (int)threadIdx.x;
    const int item = w / groups, h = item < t2 ? 0 : 1;
    const int i = item - h * t2, lo = h * lanes + (w % groups) * width;
    float s = 0.f;
    if (item < items) {
      const int row = i / tile;
      const float px = (h ? ox_b : ox) + (float)(i - row * tile);
      const float py = (h ? oy_b : oy) + (float)row;
      for (int word = lo >> 5; word <= (lo + width - 1) >> 5; ++word) {
        unsigned m = s_lmask[i][word];
        if (width < 32) m &= ((1u << width) - 1u) << (lo & 31);
        while (m) {
          const int lane = word * 32 + __ffs(m) - 1;
          m &= m - 1u;
          Edge e[3];
          float dmin;
          bool inside;
          const float p = coverage(staged_tri(s_tri, lane), px, py, inv_sigma, blur_px2, e, dmin,
                                   inside);
          s += logf(fmaxf(1.f - p, 1e-30f));
        }
      }
    }
    for (int o = groups >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (item < items && w % groups == 0) s_logsum[item] = s;
  }
}

// Pass 1 of the near-pair kernels, called by all 128 threads: stages the
// thread's triangle f and its pixel box (empty for a lane that must add
// nothing), then leaves box_log_sums' per-pixel log sums in s_logsum, ready
// to read (it ends in a barrier). The box is at the lane's own tile's
// origin; the halves' origins are as box_log_sums'.
__device__ __forceinline__ void near_log_sums(const Tri& f, PixelBox box, int halves, float ox,
                                              float oy, float ox_b, float oy_b, int tile,
                                              float inv_sigma, float blur_px2, StagedTris& s_tri,
                                              unsigned (*s_lmask)[kWarps], float* s_logsum) {
  stage_tri(s_tri, f, threadIdx.x);
  stage_lane_masks(box, tile, s_lmask);
  __syncthreads();
  box_log_sums(s_tri, s_lmask, halves, ox, oy, ox_b, oy_b, tile, inv_sigma, blur_px2, s_logsum);
  __syncthreads();
}

// Pass 2 over the thread's own box: dL/d(corner) of the thread's triangle
// f, given per pixel dL/dalpha (s_g) and Pi(1 - p) (s_total), summed over
// the pixels of `box` in ascending pixel order. The pixels outside the box
// have p == 0 and would add nothing.
__device__ __forceinline__ void box_corner_grads(const Tri& f, PixelBox box, float ox, float oy,
                                                 int tile, float inv_sigma, float blur_px2,
                                                 const float* s_g, const float* s_total,
                                                 float gx[3], float gy[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) gx[c] = gy[c] = 0.f;
  for (unsigned rs = box.rows; rs; rs &= rs - 1u) {
    const int row = __ffs(rs) - 1;
    for (unsigned cs = box.cols; cs; cs &= cs - 1u) {
      const int col = __ffs(cs) - 1, i = row * tile + col;
      pixel_corner_grads(f, ox + (float)col, oy + (float)row, inv_sigma, blur_px2, s_g[i],
                         s_total[i], gx, gy);
    }
  }
}
