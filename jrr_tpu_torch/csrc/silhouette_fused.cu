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
// All four kernels: one CTA per (tile, frame), 128 threads, thread k owns
// candidate lane k. Each thread decodes its face's three corners through
// `pages` (staged in shared memory) and reads them from tx/ty (28 KB per
// frame, L2-resident across the frame's tiles); the coverage passes are the
// shared near-pair ones of coverage.cuh: pass 1 in the alpha kernel, passes
// 1 and 2 in the two loss kernels (fused_lossgrad_kernel,
// fused_lossgrad_packed_kernel) and the alpha VJP (fused_alpha_bwd_kernel),
// whose pass 2 and atomics are one helper (add_box_grads).

#include <cuda_runtime.h>

#include "coverage.cuh"

namespace {

constexpr int kMaxPages = 32;
// Gradient tables accumulate in int64 fixed point (value * 2^32): integer
// atomics commute, so the sums, and the refinement, are the same on every
// run. kernels.py converts back to f32 and checks that no sum can overflow.
constexpr float kFixedScale = 4294967296.0f;

// Flat table position of corner c of thread k's face: idx -> page slot ->
// page; the page itself in *page.
__device__ __forceinline__ long long corner_pos(const int* s_pages, const int* idx_t, int b,
                                                int PG, int c, int k, int* page) {
  const int v = idx_t[c * kLanes + k];
  *page = s_pages[v >> 7];
  return ((long long)b * PG + *page) * kLanes + (v & 127);
}

// Thread k's triangle: corners through idx -> page slot -> page -> tables.
__device__ __forceinline__ Tri load_tri(const float* tx, const float* ty, const int* s_pages,
                                        const int* idx_t, int b, int PG, int k) {
  Tri f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int page;
    const long long pos = corner_pos(s_pages, idx_t, b, PG, c, k, &page);
    f.x[c] = tx[pos];
    f.y[c] = ty[pos];
  }
  set_inv_len2(f);
  return f;
}

// Adds one corner's gradient into the tables as fixed point: two atomics
// at most, none for the dump page, whose rows the Pallas kernels never
// write (silhouette_fused.py:803-811).
__device__ __forceinline__ void add_corner_fixed_point(long long pos, int page, float gx, float gy,
                                                       int dump_page, unsigned long long* dtx,
                                                       unsigned long long* dty) {
  if (page == dump_page) return;
  // Two's complement: adding the cast of a negative value subtracts.
  const long long qx = llrintf(gx * kFixedScale), qy = llrintf(gy * kFixedScale);
  if (qx != 0) atomicAdd(dtx + pos, (unsigned long long)qx);
  if (qy != 0) atomicAdd(dty + pos, (unsigned long long)qy);
}

// Stages the tile's page list in shared memory and loads thread k's triangle.
__device__ __forceinline__ Tri stage_tile(const float* tx, const float* ty, const int* pages_t,
                                          const int* idx, int* s_pages, long long bt, int b,
                                          int PG, int P, int k) {
  if (k < P) s_pages[k] = pages_t[k];
  __syncthreads();
  return load_tri(tx, ty, s_pages, idx + bt * 3 * kLanes, b, PG, k);
}

// Pass 2 and the atomics of the gradient kernels (rows 1, 3 and 4), called
// by every thread once s_g (dL/dalpha) and s_total (Pi(1 - p)) hold the
// pixels of the thread's tile: box_corner_grads over the thread's box, then
// its six corner gradients into the tables, the table positions decoded
// again from idx (only the triangle stays live across the passes: the
// register budget of 8 CTAs per SM). At most six atomics.
__device__ __forceinline__ void add_box_grads(const Tri& tri, PixelBox box, float ox, float oy,
                                              int tile, float inv_sigma, float blur_px2,
                                              const float* s_g, const float* s_total,
                                              const int* s_pages, const int* idx_t, int b, int PG,
                                              int dump_page, unsigned long long* dtx,
                                              unsigned long long* dty) {
  float gx[3], gy[3];
  box_corner_grads(tri, box, ox, oy, tile, inv_sigma, blur_px2, s_g, s_total, gx, gy);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int page;
    const long long pos = corner_pos(s_pages, idx_t, b, PG, c, threadIdx.x, &page);
    add_corner_fixed_point(pos, page, gx[c], gy[c], dump_page, dtx, dty);
  }
}

// Replaces jrr_tpu/render/silhouette_fused.py::_fused_fwd_kernel (:719).
// alpha = 1 - exp(sum over the lanes of log max(1 - p, 1e-30)). Bound on
// this card: bytes — the coordinate tables and page lists read once and
// alpha written for every tile, empty ones included, outweigh the ~76 ops
// per (pixel, lane) pair in the face's pixel box and ~2 per other pair.
// Design: only ~8% of the pairs lie near their triangle, so the kernel
// runs the loss kernels' pass 1 (near_log_sums) and no pass 2: each lane
// stages its triangle and marks its pixel box, and each pixel sums its set
// lanes. The fused bins have no invalid lanes: the pad lanes hold the dump
// triangle, whose box is empty. On the same bins alpha is bit for bit the
// 1 - Pi(1 - p) of fused_lossgrad_kernel, and two launches agree bit for
// bit. Empty tiles write zeros and exit before any gather. At most 64
// registers, so that 8 CTAs fit on an SM.
__global__ void __launch_bounds__(kLanes, 8)
fused_alpha_fwd_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
                       const int* __restrict__ pages, const int* __restrict__ idx,
                       const float* __restrict__ origin, float* __restrict__ out,
                       int G2, int PG, int P, int tile, float inv_sigma, float blur_px2,
                       int dump_page) {
  __shared__ int s_pages[kMaxPages];
  __shared__ StagedTris s_tri;
  __shared__ unsigned s_lmask[kMaxT2][kWarps];  // per pixel, the lanes whose box holds it
  __shared__ float s_total[kMaxT2];             // log-sum over the lanes per pixel
  const int t = blockIdx.x, b = blockIdx.y, k = threadIdx.x;
  const long long bt = (long long)b * G2 + t;
  const int t2 = tile * tile;
  float* out_t = out + bt * t2;
  const int* pages_t = pages + bt * P;
  if (pages_t[0] == dump_page) {  // no candidates: alpha == 0
    for (int i = k; i < t2; i += kLanes) out_t[i] = 0.f;
    return;
  }
  const Tri tri = stage_tile(tx, ty, pages_t, idx, s_pages, bt, b, PG, P, k);
  const float ox = origin[2 * bt], oy = origin[2 * bt + 1];
  near_log_sums(tri, pixel_box(tri, ox, oy, tile, blur_px2), 1, ox, oy, ox, oy, tile, inv_sigma,
                blur_px2, s_tri, s_lmask, s_total);
  for (int i = k; i < t2; i += kLanes) out_t[i] = 1.f - expf(s_total[i]);
}

// The loss kernels' work on one row, near pairs only (coverage.cuh): a
// tile in all 128 lanes, or, for a lane-packed primary row, tile A in lanes
// [0, 64) at origin_t with mask row mask_a and tile B in [64, 128) at
// origin_bt with mask row mask_b. Each lane takes its pixel box at its own
// tile's origin, so the lane masks split at lane 64; pass 1 sums each
// half's lanes into its own tile's pixels (one log sum per pixel and
// half), pass 2 walks each lane's box with its half's dL/dalpha and
// Pi(1 - p). *err_t receives the row's sum of (alpha - mask)^2 over both
// tiles, and the corner gradients go into dtx/dty as int64 fixed point.
// For a row that is not primary the work and its order are those of a
// single tile whatever the caller, so the two loss kernels give such a row
// the same err bit for bit. The shared arrays hold T^2 values per half.
__device__ __forceinline__ void lossgrad_row(
    const float* tx, const float* ty, const int* pages_t, const int* idx, long long bt, int b,
    int PG, int P, const float* origin_t, const float* origin_bt, const float* mask_a,
    const float* mask_b, bool primary, int tile, float inv_sigma, float blur_px2, int dump_page,
    float* err_t, unsigned long long* dtx, unsigned long long* dty, int* s_pages,
    StagedTris& s_tri, unsigned (*s_lmask)[kWarps], float* s_total, float* s_g, float* s_sq) {
  const int k = threadIdx.x, t2 = tile * tile;
  const int halves = primary ? 2 : 1, h = (primary && k >= kLanes / 2) ? 1 : 0;
  const Tri tri = stage_tile(tx, ty, pages_t, idx, s_pages, bt, b, PG, P, k);
  const float* org = h ? origin_bt : origin_t;
  const float ox = org[0], oy = org[1];
  const PixelBox box = pixel_box(tri, ox, oy, tile, blur_px2);
  near_log_sums(tri, box, halves, origin_t[0], origin_t[1], origin_bt[0], origin_bt[1], tile,
                inv_sigma, blur_px2, s_tri, s_lmask, s_total);
  for (int j = k; j < halves * t2; j += kLanes) {
    const float total = expf(s_total[j]);
    const float diff = (1.f - total) - (j < t2 ? mask_a[j] : mask_b[j - t2]);
    s_total[j] = total;
    s_g[j] = 2.f * diff;
    s_sq[j] = diff * diff;
  }
  __syncthreads();
  if (k == 0) {
    float e = 0.f;
    for (int i = 0; i < t2; ++i) e += s_sq[i];
    if (primary) {
      float e_b = 0.f;
      for (int i = t2; i < 2 * t2; ++i) e_b += s_sq[i];
      e += e_b;
    }
    *err_t = e;
  }
  add_box_grads(tri, box, ox, oy, tile, inv_sigma, blur_px2, s_g + h * t2, s_total + h * t2,
                s_pages, idx + bt * 3 * kLanes, b, PG, dump_page, dtx, dty);
}

// Replaces jrr_tpu/render/silhouette_fused.py::_fused_lossgrad_kernel (:994).
// Per occupied tile: err[b, t] = sum over pixels of (alpha - mask)^2, and
// dL/dcorner (L = sum err) added into dtx/dty[b, page, lane]. Bound on this
// card: operations — ~76 per (pixel, lane) pair within the blur radius of
// its triangle (coverage, expf, logf and a division) and ~31 more per pair
// with 0 < p < 1, ~2 per other pair for the box test; bytes (tables, idx,
// mask, and up to 768 atomics per tile) are a small share. Design: only ~8%
// of the pairs lie near their triangle, so the kernel does work only
// there (lossgrad_row): each lane stages its triangle and its pixel box,
// and sets its bit in each of its box pixels' lane masks; pass 1 runs by pixel,
// 128 / T^2 threads walking the pixel's set lanes; pass 2 runs by lane over
// the lane's own box, skipping pairs with p in {0, 1}, whose gradient is
// exactly zero, and keeps the six corner gradients in registers, so each
// thread issues at most six atomicAdds. The per-pixel dL/dalpha and
// Pi(1 - p) stay in shared memory. The atomics add int64 fixed point, not
// f32: float atomics reorder the sums from run to run, and 30 Adam steps
// amplify those last bits into parameter differences past 1e-3. Nothing
// depends on the order threads run in, so two launches agree bit for bit.
// Empty tiles exit; their err stays 0 and the wrapper adds their sum of
// mask^2. At most 64 registers, so that 8 CTAs fit on an SM.
__global__ void __launch_bounds__(kLanes, 8)
fused_lossgrad_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
                      const int* __restrict__ pages, const int* __restrict__ idx,
                      const float* __restrict__ origin, const float* __restrict__ mask,
                      float* __restrict__ err, unsigned long long* __restrict__ dtx,
                      unsigned long long* __restrict__ dty,
                      int G2, int PG, int P, int tile, float inv_sigma, float blur_px2,
                      int dump_page) {
  __shared__ int s_pages[kMaxPages];
  __shared__ StagedTris s_tri;
  __shared__ unsigned s_lmask[kMaxT2][kWarps];  // per pixel, the lanes whose box holds it
  __shared__ float s_total[kMaxT2];  // log-sum over the lanes, then Pi(1 - p), per pixel
  __shared__ float s_g[kMaxT2];      // dL/dalpha = 2 (alpha - mask) per pixel
  __shared__ float s_sq[kMaxT2];     // (alpha - mask)^2 per pixel
  const int t = blockIdx.x, b = blockIdx.y;
  const long long bt = (long long)b * G2 + t;
  const int* pages_t = pages + bt * P;
  if (pages_t[0] == dump_page) return;
  const float* mask_t = mask + bt * tile * tile;
  lossgrad_row(tx, ty, pages_t, idx, bt, b, PG, P, origin + 2 * bt, origin + 2 * bt, mask_t,
               mask_t, false, tile, inv_sigma, blur_px2, dump_page, err + bt, dtx, dty, s_pages,
               s_tri, s_lmask, s_total, s_g, s_sq);
}

// Replaces jrr_tpu/render/silhouette_fused.py::_fused_lossgrad_packed_kernel
// (:1155), the loss kernel on the lane-packed layout (pack_bins): a PRIMARY
// row (flags 1) carries tile A's candidates in lanes [0, 64) and its buddy
// tile B's in [64, 128); BUDDY rows (flags 2) are dump-marked and exit with
// the empty rows; NORMAL rows (flags 0) are fused_lossgrad_kernel's tiles,
// with the same lanes in the same order (pack_bins keeps an unpacked
// tile's idx and page list), and run its work in its order (lossgrad_row),
// so their err equals that kernel's bit for bit (chip_smoke.py checks it).
// Bound on this card: as fused_lossgrad_kernel's, operations, each pair
// counted at its own half's origin. Design: near pairs only, as
// fused_lossgrad_kernel, with each half's pixel boxes at its own tile's
// origin: A's lanes mark and sum A's pixels, B's lanes B's, pass 1 runs
// over 2 T^2 (pixel, half) items, and pass 2 walks each lane's box with
// its half's dL/dalpha and Pi(1 - p). B's mask row is read in place at
// mask[b, buddy[b, t]]; err[b, t] holds both tiles' sum for a primary. A
// packed pair costs one CTA where the unpacked layout spends two. Both
// halves' unused lanes hold the dump triangle, whose box is empty. The
// int64 fixed-point bound (kernels._fixed_point_bound) still holds: every
// lane of a row still covers T2 pixels of one tile with |dL/dalpha| <= 4,
// buddy rows add nothing, so a frame's G2 rows add at most
// G2 * 3 * 128 * T2 corner terms, as unpacked. At most 64 registers, so
// that 8 CTAs fit on an SM.
__global__ void __launch_bounds__(kLanes, 8)
fused_lossgrad_packed_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
                             const int* __restrict__ pages, const int* __restrict__ idx,
                             const float* __restrict__ origin,
                             const float* __restrict__ origin_b, const int* __restrict__ flags,
                             const int* __restrict__ buddy, const float* __restrict__ mask,
                             float* __restrict__ err, unsigned long long* __restrict__ dtx,
                             unsigned long long* __restrict__ dty,
                             int G2, int PG, int P, int tile, float inv_sigma, float blur_px2,
                             int dump_page) {
  __shared__ int s_pages[kMaxPages];
  __shared__ StagedTris s_tri;
  __shared__ unsigned s_lmask[kMaxT2][kWarps];  // per pixel index, A's lanes then B's
  __shared__ float s_total[2 * kMaxT2];  // per pixel of A, then of B: log-sum, then Pi(1 - p)
  __shared__ float s_g[2 * kMaxT2];      // dL/dalpha per pixel, per half
  __shared__ float s_sq[2 * kMaxT2];     // (alpha - mask)^2 per pixel, per half
  const int t = blockIdx.x, b = blockIdx.y;
  const long long bt = (long long)b * G2 + t;
  const int t2 = tile * tile;
  const int* pages_t = pages + bt * P;
  if (pages_t[0] == dump_page) return;  // empty and buddy rows
  lossgrad_row(tx, ty, pages_t, idx, bt, b, PG, P, origin + 2 * bt, origin_b + 2 * bt,
               mask + bt * t2, mask + ((long long)b * G2 + buddy[bt]) * t2, flags[bt] == 1, tile,
               inv_sigma, blur_px2, dump_page, err + bt, dtx, dty, s_pages, s_tri, s_lmask,
               s_total, s_g, s_sq);
}

// Replaces jrr_tpu/render/silhouette_fused.py::_fused_bwd_kernel (:814),
// the VJP of fused_alpha_fwd: given g = dL/dalpha (B, G2, T2), adds
// dL/dcorner into dtx/dty[b, page, lane]. Bound on this card: as
// fused_lossgrad_kernel's, operations, with g read in place of the mask
// and no err written. Design: the loss kernel's near-pair passes with
// dL/dalpha read from g instead of formed from the mask. Pass 1
// (near_log_sums) as in every near-pair kernel; between the passes
// Pi(1 - p) = expf(log sum) and g[b, t, i] go into shared memory; pass 2
// and the atomics are the loss kernels' own (add_box_grads): by lane over
// the lane's box, pairs with p in {0, 1} skipped, at most six int64
// fixed-point atomics per thread, none to the dump page. So on the same
// bins with g = 2 (alpha - mask), alpha from fused_alpha_fwd (bit for bit
// the loss kernel's 1 - Pi(1 - p)), dtx/dty equal fused_lossgrad_kernel's
// bit for bit (chip_smoke.py checks it), and two launches agree bit for
// bit. kernels.py bounds |g| so that no fixed-point sum can overflow.
// Empty tiles have no gradient and exit before any gather. At most 64
// registers, so that 8 CTAs fit on an SM.
__global__ void __launch_bounds__(kLanes, 8)
fused_alpha_bwd_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
                       const int* __restrict__ pages, const int* __restrict__ idx,
                       const float* __restrict__ origin, const float* __restrict__ g,
                       unsigned long long* __restrict__ dtx,
                       unsigned long long* __restrict__ dty,
                       int G2, int PG, int P, int tile, float inv_sigma, float blur_px2,
                       int dump_page) {
  __shared__ int s_pages[kMaxPages];
  __shared__ StagedTris s_tri;
  __shared__ unsigned s_lmask[kMaxT2][kWarps];  // per pixel, the lanes whose box holds it
  __shared__ float s_total[kMaxT2];  // log-sum over the lanes, then Pi(1 - p), per pixel
  __shared__ float s_g[kMaxT2];      // dL/dalpha per pixel
  const int t = blockIdx.x, b = blockIdx.y, k = threadIdx.x;
  const long long bt = (long long)b * G2 + t;
  const int t2 = tile * tile;
  const int* pages_t = pages + bt * P;
  if (pages_t[0] == dump_page) return;
  const Tri tri = stage_tile(tx, ty, pages_t, idx, s_pages, bt, b, PG, P, k);
  const float ox = origin[2 * bt], oy = origin[2 * bt + 1];
  const PixelBox box = pixel_box(tri, ox, oy, tile, blur_px2);
  near_log_sums(tri, box, 1, ox, oy, ox, oy, tile, inv_sigma, blur_px2, s_tri, s_lmask, s_total);
  const float* g_t = g + bt * t2;
  for (int i = k; i < t2; i += kLanes) {
    s_total[i] = expf(s_total[i]);
    s_g[i] = g_t[i];
  }
  __syncthreads();
  add_box_grads(tri, box, ox, oy, tile, inv_sigma, blur_px2, s_g, s_total, s_pages,
                idx + bt * 3 * kLanes, b, PG, dump_page, dtx, dty);
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
