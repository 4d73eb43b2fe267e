// Fused page-gather soft-silhouette kernels for Hopper (sm_90a).
//
// Built by jrr_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. No
// --use_fast_math: alpha must match the plain PyTorch version to 1e-5, so the
// transcendentals are the accurate expf/logf.
//
// Bins contract (render/silhouette_fused.py): per frame b, coordinate tables
// tx/ty (B, PG, 128) f32 hold the Morton-ordered screen vertices; per tile t,
// pages[b, t, 0:P] (i32) lists the vertex pages its candidate faces touch
// (slot P-1 and unused slots = the dump page), idx[b, t, c, k] (i32) is
// corner c of candidate k as page_slot*128 + lane, origin[b, t] (f32 x, y)
// the tile's top-left pixel. A tile whose first page is the dump page has no
// candidates (alpha == 0).
//
// Both kernels: one CTA per (tile, frame), 128 threads, thread k owns
// candidate lane k. Each thread decodes its face's three corners through
// `pages` (staged in shared memory) and reads them from tx/ty (28 KB per
// frame, L2-resident across the frame's tiles). Pass 1 computes, per pixel,
// log(1 - p) for the thread's face and block-reduces it over the 128 lanes
// (warp shuffles, then a 4-warp shared-memory step) into alpha = 1 - exp(sum).
//
// The math mirrors jrr_tpu_torch/render/coverage.py line for line, and so
// the Pallas kernels' jrr_tpu/render/silhouette_pallas.py:41-155 except for
// the routing of the min-distance gradient at ties (exact argmin here; see
// coverage.corner_row_grads).

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;  // candidate lanes per tile == threads per CTA
constexpr int kWarps = kLanes / 32;
constexpr int kMaxPages = 32;
constexpr int kMaxT2 = 256;  // tile <= 16
// Gradient tables accumulate in int64 fixed point (value * 2^32): integer
// atomics commute, so the sums, and the refinement, are the same on every
// run. kernels.py converts back to f32 and checks that no sum can overflow.
constexpr float kFixedScale = 4294967296.0f;

struct Edge {
  float cross, t, rx, ry, d2;
};

struct Face {
  float x[3], y[3];      // corners A, B, C
  float inv_len2[3];     // 1 / max(|e|^2, 1e-12) of edges AB, BC, CA
  long long pos[3];      // flat table position of each corner
  int page[3];           // table page of each corner
};

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

// Coverage p of the thread's face at pixel (px, py); fills the edge terms,
// the minimum squared distance and the inside flag for the backward.
__device__ __forceinline__ float coverage(const Face& f, float px, float py,
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Thread k's face: corners through idx -> page slot -> page -> tables.
__device__ __forceinline__ Face load_face(const float* tx, const float* ty,
                                          const int* s_pages, const int* idx_t,
                                          int b, int PG, int k) {
  Face f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int v = idx_t[c * kLanes + k];
    f.page[c] = s_pages[v >> 7];
    f.pos[c] = ((long long)b * PG + f.page[c]) * kLanes + (v & 127);
    f.x[c] = tx[f.pos[c]];
    f.y[c] = ty[f.pos[c]];
  }
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int n = (e + 1) % 3;
    const float ex = f.x[n] - f.x[e], ey = f.y[n] - f.y[e];
    f.inv_len2[e] = 1.f / fmaxf(ex * ex + ey * ey, 1e-12f);
  }
  return f;
}

// Pass 1: per pixel, sum over the 128 lanes of log(max(1 - p, 1e-30)),
// left per warp in s_part[warp][pixel]; the caller adds the four warps.
__device__ __forceinline__ void lane_log_sums(const Face& f, float ox, float oy, int tile,
                                              float inv_sigma, float blur_px2,
                                              float (*s_part)[kMaxT2]) {
  const int t2 = tile * tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < t2; ++i) {
    const int row = i / tile;
    const float px = ox + (float)(i - row * tile), py = oy + (float)row;
    Edge e[3];
    float dmin;
    bool inside;
    const float p = coverage(f, px, py, inv_sigma, blur_px2, e, dmin, inside);
    const float s = warp_sum(logf(fmaxf(1.f - p, 1e-30f)));
    if (lane == 0) s_part[warp][i] = s;
  }
}

// Replaces jrr_tpu/render/silhouette_fused.py::_fused_fwd_kernel (:719).
// Bound on this card: operations — per (pixel, lane) ~70 f32 ops plus an
// expf, a logf and a division, against ~4 bytes of input per pixel; the
// inputs (tables, idx, pages) are read once per CTA. Design: empty tiles
// write zeros and exit before any gather; the lane product is exp of a
// shuffle-reduced log sum (no shared-memory transpose).
__global__ void __launch_bounds__(kLanes)
fused_alpha_fwd_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
                       const int* __restrict__ pages, const int* __restrict__ idx,
                       const float* __restrict__ origin, float* __restrict__ out,
                       int G2, int PG, int P, int tile, float inv_sigma, float blur_px2,
                       int dump_page) {
  __shared__ int s_pages[kMaxPages];
  __shared__ float s_part[kWarps][kMaxT2];
  const int t = blockIdx.x, b = blockIdx.y, k = threadIdx.x;
  const long long bt = (long long)b * G2 + t;
  const int t2 = tile * tile;
  float* out_t = out + bt * t2;
  const int* pages_t = pages + bt * P;
  if (pages_t[0] == dump_page) {  // no candidates: alpha == 0
    for (int i = k; i < t2; i += kLanes) out_t[i] = 0.f;
    return;
  }
  if (k < P) s_pages[k] = pages_t[k];
  __syncthreads();
  const Face f = load_face(tx, ty, s_pages, idx + bt * 3 * kLanes, b, PG, k);
  lane_log_sums(f, origin[2 * bt], origin[2 * bt + 1], tile, inv_sigma, blur_px2, s_part);
  __syncthreads();
  for (int i = k; i < t2; i += kLanes) {
    const float s = s_part[0][i] + s_part[1][i] + s_part[2][i] + s_part[3][i];
    out_t[i] = 1.f - expf(s);
  }
}

// Replaces jrr_tpu/render/silhouette_fused.py::_fused_lossgrad_kernel (:994).
// Per occupied tile: err[b, t] = sum over pixels of (alpha - mask)^2, and
// dL/dcorner (L = sum err) added into dtx/dty[b, page, lane]. Bound on this
// card: operations — pass 1 as in the forward, pass 2 recomputes the ~70
// ops per (pixel, lane) plus ~40 for the gradient; bytes (tables, idx,
// mask, and 768 atomics per tile) are a small share. Design: the per-pixel
// dL/dalpha and Pi(1 - p) from pass 1 stay in shared memory; pass 2 skips
// (pixel, lane) pairs with p in {0, 1}, whose gradient is exactly zero, and
// keeps the six corner gradients in registers, so each thread issues at
// most six atomicAdds (none for the dump page, whose rows the Pallas kernel
// never writes, :803-811). The atomics add int64 fixed point, not f32:
// float atomics reorder the sums from run to run, and 30 Adam steps
// amplify those last bits into parameter differences past 1e-3. Empty
// tiles exit; their err stays 0 and the wrapper adds their sum of mask^2.
__global__ void __launch_bounds__(kLanes)
fused_lossgrad_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
                      const int* __restrict__ pages, const int* __restrict__ idx,
                      const float* __restrict__ origin, const float* __restrict__ mask,
                      float* __restrict__ err, unsigned long long* __restrict__ dtx,
                      unsigned long long* __restrict__ dty,
                      int G2, int PG, int P, int tile, float inv_sigma, float blur_px2,
                      int dump_page) {
  __shared__ int s_pages[kMaxPages];
  __shared__ float s_part[kWarps][kMaxT2];
  __shared__ float s_total[kMaxT2];  // Pi(1 - p) per pixel
  __shared__ float s_g[kMaxT2];      // dL/dalpha = 2 (alpha - mask) per pixel
  __shared__ float s_sq[kMaxT2];     // (alpha - mask)^2 per pixel
  const int t = blockIdx.x, b = blockIdx.y, k = threadIdx.x;
  const long long bt = (long long)b * G2 + t;
  const int t2 = tile * tile;
  const int* pages_t = pages + bt * P;
  if (pages_t[0] == dump_page) return;
  if (k < P) s_pages[k] = pages_t[k];
  __syncthreads();
  const Face f = load_face(tx, ty, s_pages, idx + bt * 3 * kLanes, b, PG, k);
  const float ox = origin[2 * bt], oy = origin[2 * bt + 1];
  lane_log_sums(f, ox, oy, tile, inv_sigma, blur_px2, s_part);
  __syncthreads();
  const float* mask_t = mask + bt * t2;
  for (int i = k; i < t2; i += kLanes) {
    const float total = expf(s_part[0][i] + s_part[1][i] + s_part[2][i] + s_part[3][i]);
    const float diff = (1.f - total) - mask_t[i];
    s_total[i] = total;
    s_g[i] = 2.f * diff;
    s_sq[i] = diff * diff;
  }
  __syncthreads();
  if (k == 0) {
    float e = 0.f;
    for (int i = 0; i < t2; ++i) e += s_sq[i];
    err[bt] = e;
  }

  // Pass 2: corner gradients as coverage.py's corner_row_grads: the
  // min-distance subgradient goes to the edges whose d2 equals dmin exactly
  // (each d2 is computed once, so the comparison is exact), split evenly at
  // a tie, not to every edge within the Pallas kernel's 1e-4 (1 + dmin)
  // band. gx/gy[c] accumulate dL/d(corner c).
  float gx[3] = {0.f, 0.f, 0.f}, gy[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < t2; ++i) {
    const int row = i / tile;
    const float px = ox + (float)(i - row * tile), py = oy + (float)row;
    Edge e[3];
    float dmin;
    bool inside;
    const float p = coverage(f, px, py, inv_sigma, blur_px2, e, dmin, inside);
    if (p == 0.f || p == 1.f) continue;  // p (1 - p) == 0: no gradient
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
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (f.page[c] == dump_page) continue;
    // Two's complement: adding the cast of a negative value subtracts.
    const long long qx = llrintf(gx[c] * kFixedScale), qy = llrintf(gy[c] * kFixedScale);
    if (qx != 0) atomicAdd(dtx + f.pos[c], (unsigned long long)qx);
    if (qy != 0) atomicAdd(dty + f.pos[c], (unsigned long long)qy);
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).

int jrr_fused_alpha_fwd(const float* tx, const float* ty, const int* pages, const int* idx,
                        const float* origin, float* out, int B, int G2, int PG, int P,
                        int tile, float inv_sigma, float blur_px2, int dump_page,
                        void* stream) {
  dim3 grid(G2, B);
  fused_alpha_fwd_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
      tx, ty, pages, idx, origin, out, G2, PG, P, tile, inv_sigma, blur_px2, dump_page);
  return (int)cudaGetLastError();
}

int jrr_fused_lossgrad(const float* tx, const float* ty, const int* pages, const int* idx,
                       const float* origin, const float* mask, float* err,
                       unsigned long long* dtx, unsigned long long* dty, int B, int G2, int PG, int P, int tile, float inv_sigma,
                       float blur_px2, int dump_page, void* stream) {
  dim3 grid(G2, B);
  fused_lossgrad_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
      tx, ty, pages, idx, origin, mask, err, dtx, dty, G2, PG, P, tile, inv_sigma, blur_px2,
      dump_page);
  return (int)cudaGetLastError();
}

const char* jrr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
