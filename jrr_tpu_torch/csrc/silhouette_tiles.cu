// Round-1 tile soft-silhouette kernels for Hopper (sm_90a): alpha from
// pre-gathered triangle rows, and its VJP back to those rows.
//
// Built by jrr_tpu_torch/kernels.py into the same library as
// silhouette_fused.cu (plain C interface, loaded with ctypes); accurate
// expf/logf, no --use_fast_math, so alpha matches the plain PyTorch version
// (render/silhouette.py::_tiles_alpha_xla) to 1e-5.
//
// Layout (render/silhouette_pallas.py::pack_tri): N tiles, each with
// origin[n] (f32 x, y) its top-left pixel, tri[n, 6, 128] (f32) the rows
// [ax ay bx by cx cy] of its candidate triangles, one per lane, and
// valid[n, 0, 128] (f32 1/0) which lanes hold a candidate. alpha[n, T2] and
// g[n, T2] are per pixel, row-major within the tile.
//
// Both kernels: one CTA per tile, 128 threads, thread k owns lane k; the
// coverage passes are the shared ones of coverage.cuh. A tile without a
// valid lane (most tiles of a body frame) writes its zero output and exits
// before reading any triangle.

#include <cuda_runtime.h>

#include "coverage.cuh"

namespace {

// Thread k's triangle from its tile's packed rows.
__device__ __forceinline__ Tri load_tri(const float* tri_n, int k) {
  Tri f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.x[c] = tri_n[(2 * c) * kLanes + k];
    f.y[c] = tri_n[(2 * c + 1) * kLanes + k];
  }
  set_inv_len2(f);
  return f;
}

// Replaces jrr_tpu/render/silhouette_pallas.py::_fwd_kernel (:169).
// alpha = 1 - exp(sum over valid lanes of log max(1 - p, 1e-30)), the lane
// product of _lane_prod (:61-74). Bound on this card: operations — ~76 f32
// ops plus an expf, a logf and a division per (pixel, valid lane), against
// 4 bytes of output per pixel and 28 bytes of input per lane. Design: the
// emptiness test is one block vote on the valid row, so an empty tile
// costs one 512-byte read and its zero write.
__global__ void __launch_bounds__(kLanes)
tiles_alpha_fwd_kernel(const float* __restrict__ origin, const float* __restrict__ tri,
                       const float* __restrict__ valid, float* __restrict__ out, int tile,
                       float inv_sigma, float blur_px2) {
  __shared__ float s_part[kWarps][kMaxT2];
  const long long n = blockIdx.x;
  const int k = threadIdx.x;
  const int t2 = tile * tile;
  float* out_n = out + n * t2;
  const bool v = valid[n * kLanes + k] > 0.f;
  if (!__syncthreads_or(v)) {  // no candidate: alpha == 0
    for (int i = k; i < t2; i += kLanes) out_n[i] = 0.f;
    return;
  }
  const Tri f = load_tri(tri + n * 6 * kLanes, k);
  lane_log_sums(f, v, origin[2 * n], origin[2 * n + 1], tile, inv_sigma, blur_px2, s_part);
  __syncthreads();
  for (int i = k; i < t2; i += kLanes) out_n[i] = 1.f - expf(log_sum_total(s_part, i));
}

// Replaces jrr_tpu/render/silhouette_pallas.py::_bwd_kernel (:182): given
// g = dL/dalpha, dtri[n, :, k] = dL/d(corners of lane k). It recomputes the
// coverage (pass 1 for Pi(1 - p) per pixel, pass 2 per lane) instead of
// storing it, as the Pallas kernel does, but routes the min-distance
// gradient to the exact argmin (coverage.cuh) where the Pallas kernel uses
// a 1e-4 band. Bound on this card: operations — pass 1 as in the forward,
// pass 2 adds ~107 ops per (pixel, lane) with 0 < p < 1; the (6, 128) rows
// written per tile are the byte share. Design: each thread keeps its six
// corner sums in registers and writes its lane of the tile's rows once,
// with no atomics, so the result repeats bit for bit; invalid lanes and
// empty tiles write zeros.
__global__ void __launch_bounds__(kLanes)
tiles_alpha_bwd_kernel(const float* __restrict__ origin, const float* __restrict__ tri,
                       const float* __restrict__ valid, const float* __restrict__ g,
                       float* __restrict__ dtri, int tile, float inv_sigma, float blur_px2) {
  __shared__ float s_part[kWarps][kMaxT2];
  __shared__ float s_total[kMaxT2];  // Pi(1 - p) per pixel
  __shared__ float s_g[kMaxT2];      // dL/dalpha per pixel
  const long long n = blockIdx.x;
  const int k = threadIdx.x;
  const int t2 = tile * tile;
  float* dtri_n = dtri + n * 6 * kLanes;
  const bool v = valid[n * kLanes + k] > 0.f;
  if (!__syncthreads_or(v)) {
#pragma unroll
    for (int r = 0; r < 6; ++r) dtri_n[r * kLanes + k] = 0.f;
    return;
  }
  const Tri f = load_tri(tri + n * 6 * kLanes, k);
  const float ox = origin[2 * n], oy = origin[2 * n + 1];
  lane_log_sums(f, v, ox, oy, tile, inv_sigma, blur_px2, s_part);
  __syncthreads();
  const float* g_n = g + n * t2;
  for (int i = k; i < t2; i += kLanes) {
    s_total[i] = expf(log_sum_total(s_part, i));
    s_g[i] = g_n[i];
  }
  __syncthreads();
  float gx[3], gy[3];
  corner_grads(f, v, ox, oy, tile, inv_sigma, blur_px2, s_g, s_total, gx, gy);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dtri_n[(2 * c) * kLanes + k] = gx[c];
    dtri_n[(2 * c + 1) * kLanes + k] = gy[c];
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).

int jrr_tiles_alpha_fwd(const float* origin, const float* tri, const float* valid, float* out,
                        int N, int tile, float inv_sigma, float blur_px2, void* stream) {
  tiles_alpha_fwd_kernel<<<N, kLanes, 0, (cudaStream_t)stream>>>(origin, tri, valid, out, tile,
                                                                  inv_sigma, blur_px2);
  return (int)cudaGetLastError();
}

int jrr_tiles_alpha_bwd(const float* origin, const float* tri, const float* valid,
                        const float* g, float* dtri, int N, int tile, float inv_sigma,
                        float blur_px2, void* stream) {
  tiles_alpha_bwd_kernel<<<N, kLanes, 0, (cudaStream_t)stream>>>(origin, tri, valid, g, dtri,
                                                                  tile, inv_sigma, blur_px2);
  return (int)cudaGetLastError();
}

}  // extern "C"
