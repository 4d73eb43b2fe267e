// Fused page-gather soft-silhouette kernels for Hopper (sm_90a).
//
// Built by jrr_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler -fPIC
// into the kernel library (plain C interface, loaded with ctypes). No
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
// All three kernels: one CTA per (tile, frame), 128 threads, thread k owns
// candidate lane k. Each thread decodes its face's three corners through
// `pages` (staged in shared memory) and reads them from tx/ty (28 KB per
// frame, L2-resident across the frame's tiles); the coverage passes are the
// shared ones of coverage.cuh.

#include <cuda_runtime.h>

#include "coverage.cuh"

namespace {

constexpr int kMaxPages = 32;
// Gradient tables accumulate in int64 fixed point (value * 2^32): integer
// atomics commute, so the sums, and the refinement, are the same on every
// run. kernels.py converts back to f32 and checks that no sum can overflow.
constexpr float kFixedScale = 4294967296.0f;

struct Face {
  Tri tri;
  long long pos[3];  // flat table position of each corner
  int page[3];       // table page of each corner
};

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
    f.tri.x[c] = tx[f.pos[c]];
    f.tri.y[c] = ty[f.pos[c]];
  }
  set_inv_len2(f.tri);
  return f;
}

// Adds the thread's corner gradients into the tables as fixed point: at
// most six atomics per thread, none for the dump page, whose rows the
// Pallas kernels never write (silhouette_fused.py:803-811).
__device__ __forceinline__ void add_fixed_point(const Face& f, const float gx[3],
                                                const float gy[3], int dump_page,
                                                unsigned long long* dtx,
                                                unsigned long long* dty) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (f.page[c] == dump_page) continue;
    // Two's complement: adding the cast of a negative value subtracts.
    const long long qx = llrintf(gx[c] * kFixedScale), qy = llrintf(gy[c] * kFixedScale);
    if (qx != 0) atomicAdd(dtx + f.pos[c], (unsigned long long)qx);
    if (qy != 0) atomicAdd(dty + f.pos[c], (unsigned long long)qy);
  }
}

// Stages the tile's page list in shared memory and loads thread k's face.
__device__ __forceinline__ Face stage_tile(const float* tx, const float* ty,
                                           const int* pages_t, const int* idx, int* s_pages,
                                           long long bt, int b, int PG, int P, int k) {
  if (k < P) s_pages[k] = pages_t[k];
  __syncthreads();
  return load_face(tx, ty, s_pages, idx + bt * 3 * kLanes, b, PG, k);
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
  const Face f = stage_tile(tx, ty, pages_t, idx, s_pages, bt, b, PG, P, k);
  lane_log_sums(f.tri, true, origin[2 * bt], origin[2 * bt + 1], tile, inv_sigma, blur_px2,
                s_part);
  __syncthreads();
  for (int i = k; i < t2; i += kLanes) out_t[i] = 1.f - expf(log_sum_total(s_part, i));
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
// most six atomicAdds. The atomics add int64 fixed point, not f32: float
// atomics reorder the sums from run to run, and 30 Adam steps amplify
// those last bits into parameter differences past 1e-3. Empty tiles exit;
// their err stays 0 and the wrapper adds their sum of mask^2.
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
  const Face f = stage_tile(tx, ty, pages_t, idx, s_pages, bt, b, PG, P, k);
  const float ox = origin[2 * bt], oy = origin[2 * bt + 1];
  lane_log_sums(f.tri, true, ox, oy, tile, inv_sigma, blur_px2, s_part);
  __syncthreads();
  const float* mask_t = mask + bt * t2;
  for (int i = k; i < t2; i += kLanes) {
    const float total = expf(log_sum_total(s_part, i));
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
  float gx[3], gy[3];
  corner_grads(f.tri, true, ox, oy, tile, inv_sigma, blur_px2, s_g, s_total, gx, gy);
  add_fixed_point(f, gx, gy, dump_page, dtx, dty);
}

// Replaces jrr_tpu/render/silhouette_fused.py::_fused_lossgrad_packed_kernel
// (:1155), the loss kernel on the lane-packed layout (pack_bins): a PRIMARY
// row (flags 1) carries tile A's candidates in lanes [0, 64) and its buddy
// tile B's in [64, 128); BUDDY rows (flags 2) are dump-marked and exit with
// the empty rows; NORMAL rows (flags 0) are fused_lossgrad_kernel's tiles,
// with the same arithmetic bit for bit. Lanes 0-63 are warps 0-1 and lanes
// 64-127 warps 2-3, so lane_log_sums' per-warp partials split the halves
// with no masked reduction: Pi over A = exp(s_part[0] + s_part[1]), over B
// = exp(s_part[2] + s_part[3]). Each thread evaluates its pixels at its own
// half's origin and runs corner_grads with its half's dL/dalpha and Pi(1 -
// p); B's mask row is read in place at mask[b, buddy[b, t]]. err[b, t]
// holds both tiles' sum for a primary. Bound and design as
// fused_lossgrad_kernel's; a packed pair costs one CTA where the unpacked
// layout spends two. The int64 fixed-point bound (kernels._fixed_point_bound)
// still holds: every lane of a row still covers T2 pixels of one tile with
// |dL/dalpha| <= 4, buddy rows add nothing, so a frame's G2 rows add at most
// G2 * 3 * 128 * T2 corner terms, as unpacked.
__global__ void __launch_bounds__(kLanes)
fused_lossgrad_packed_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
                             const int* __restrict__ pages, const int* __restrict__ idx,
                             const float* __restrict__ origin,
                             const float* __restrict__ origin_b, const int* __restrict__ flags,
                             const int* __restrict__ buddy, const float* __restrict__ mask,
                             float* __restrict__ err, unsigned long long* __restrict__ dtx,
                             unsigned long long* __restrict__ dty,
                             int G2, int PG, int P, int tile, float inv_sigma, float blur_px2,
                             int dump_page) {
  constexpr int kHalf = kLanes / 2;
  __shared__ int s_pages[kMaxPages];
  __shared__ float s_part[kWarps][kMaxT2];
  __shared__ float s_total[2][kMaxT2];  // Pi(1 - p) per pixel, per half
  __shared__ float s_g[2][kMaxT2];      // dL/dalpha per pixel, per half
  __shared__ float s_sq[2][kMaxT2];     // (alpha - mask)^2 per pixel, per half
  const int t = blockIdx.x, b = blockIdx.y, k = threadIdx.x;
  const long long bt = (long long)b * G2 + t;
  const int t2 = tile * tile;
  const int* pages_t = pages + bt * P;
  if (pages_t[0] == dump_page) return;  // empty and buddy rows
  const bool primary = flags[bt] == 1;
  const int half = (primary && k >= kHalf) ? 1 : 0;
  const Face f = stage_tile(tx, ty, pages_t, idx, s_pages, bt, b, PG, P, k);
  const float* org = half ? origin_b : origin;
  const float ox = org[2 * bt], oy = org[2 * bt + 1];
  lane_log_sums(f.tri, true, ox, oy, tile, inv_sigma, blur_px2, s_part);
  __syncthreads();
  const float* mask_a = mask + bt * t2;
  const float* mask_b = mask + ((long long)b * G2 + buddy[bt]) * t2;
  for (int i = k; i < t2; i += kLanes) {
    if (primary) {
      const float total_a = expf(s_part[0][i] + s_part[1][i]);
      const float total_b = expf(s_part[2][i] + s_part[3][i]);
      const float diff_a = (1.f - total_a) - mask_a[i];
      const float diff_b = (1.f - total_b) - mask_b[i];
      s_total[0][i] = total_a;
      s_total[1][i] = total_b;
      s_g[0][i] = 2.f * diff_a;
      s_g[1][i] = 2.f * diff_b;
      s_sq[0][i] = diff_a * diff_a;
      s_sq[1][i] = diff_b * diff_b;
    } else {
      const float total = expf(log_sum_total(s_part, i));
      const float diff = (1.f - total) - mask_a[i];
      s_total[0][i] = total;
      s_g[0][i] = 2.f * diff;
      s_sq[0][i] = diff * diff;
    }
  }
  __syncthreads();
  if (k == 0) {
    float e = 0.f;
    for (int i = 0; i < t2; ++i) e += s_sq[0][i];
    if (primary) {
      float e_b = 0.f;
      for (int i = 0; i < t2; ++i) e_b += s_sq[1][i];
      e += e_b;
    }
    err[bt] = e;
  }
  float gx[3], gy[3];
  corner_grads(f.tri, true, ox, oy, tile, inv_sigma, blur_px2, s_g[half], s_total[half], gx, gy);
  add_fixed_point(f, gx, gy, dump_page, dtx, dty);
}

// Replaces jrr_tpu/render/silhouette_fused.py::_fused_bwd_kernel (:814),
// the VJP of fused_alpha_fwd: given g = dL/dalpha (B, G2, T2), adds
// dL/dcorner into dtx/dty[b, page, lane]. It is the loss kernel with
// dL/dalpha read from g instead of formed from the mask: the same pass 1,
// pass 2 and fixed-point atomics (shared device code above), so its bound
// and design are those of fused_lossgrad_kernel. kernels.py bounds |g| so
// that no fixed-point sum can overflow. Empty tiles have no gradient.
__global__ void __launch_bounds__(kLanes)
fused_alpha_bwd_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
                       const int* __restrict__ pages, const int* __restrict__ idx,
                       const float* __restrict__ origin, const float* __restrict__ g,
                       unsigned long long* __restrict__ dtx,
                       unsigned long long* __restrict__ dty,
                       int G2, int PG, int P, int tile, float inv_sigma, float blur_px2,
                       int dump_page) {
  __shared__ int s_pages[kMaxPages];
  __shared__ float s_part[kWarps][kMaxT2];
  __shared__ float s_total[kMaxT2];  // Pi(1 - p) per pixel
  __shared__ float s_g[kMaxT2];      // dL/dalpha per pixel
  const int t = blockIdx.x, b = blockIdx.y, k = threadIdx.x;
  const long long bt = (long long)b * G2 + t;
  const int t2 = tile * tile;
  const int* pages_t = pages + bt * P;
  if (pages_t[0] == dump_page) return;
  const Face f = stage_tile(tx, ty, pages_t, idx, s_pages, bt, b, PG, P, k);
  const float ox = origin[2 * bt], oy = origin[2 * bt + 1];
  lane_log_sums(f.tri, true, ox, oy, tile, inv_sigma, blur_px2, s_part);
  __syncthreads();
  const float* g_t = g + bt * t2;
  for (int i = k; i < t2; i += kLanes) {
    s_total[i] = expf(log_sum_total(s_part, i));
    s_g[i] = g_t[i];
  }
  __syncthreads();
  float gx[3], gy[3];
  corner_grads(f.tri, true, ox, oy, tile, inv_sigma, blur_px2, s_g, s_total, gx, gy);
  add_fixed_point(f, gx, gy, dump_page, dtx, dty);
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
                       unsigned long long* dtx, unsigned long long* dty, int B, int G2,
                       int PG, int P, int tile, float inv_sigma, float blur_px2,
                       int dump_page, void* stream) {
  dim3 grid(G2, B);
  fused_lossgrad_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
      tx, ty, pages, idx, origin, mask, err, dtx, dty, G2, PG, P, tile, inv_sigma, blur_px2,
      dump_page);
  return (int)cudaGetLastError();
}

int jrr_fused_lossgrad_packed(const float* tx, const float* ty, const int* pages,
                              const int* idx, const float* origin, const float* origin_b,
                              const int* flags, const int* buddy, const float* mask, float* err,
                              unsigned long long* dtx, unsigned long long* dty, int B, int G2,
                              int PG, int P, int tile, float inv_sigma, float blur_px2,
                              int dump_page, void* stream) {
  dim3 grid(G2, B);
  fused_lossgrad_packed_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
      tx, ty, pages, idx, origin, origin_b, flags, buddy, mask, err, dtx, dty, G2, PG, P, tile,
      inv_sigma, blur_px2, dump_page);
  return (int)cudaGetLastError();
}

int jrr_fused_alpha_bwd(const float* tx, const float* ty, const int* pages, const int* idx,
                        const float* origin, const float* g, unsigned long long* dtx,
                        unsigned long long* dty, int B, int G2, int PG, int P, int tile,
                        float inv_sigma, float blur_px2, int dump_page, void* stream) {
  dim3 grid(G2, B);
  fused_alpha_bwd_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
      tx, ty, pages, idx, origin, g, dtx, dty, G2, PG, P, tile, inv_sigma, blur_px2,
      dump_page);
  return (int)cudaGetLastError();
}

const char* jrr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
