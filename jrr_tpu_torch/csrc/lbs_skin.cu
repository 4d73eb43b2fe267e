// Linear-blend skinning for Hopper (sm_90a): the last step of the SMPL
// forward (models/smpl.py::smpl_forward) and its VJP.
//
// Built by jrr_tpu_torch/kernels.py into the same library as the rasterizer
// kernels (plain C interface, loaded with ctypes); float32 throughout, no
// fast math. Replaces no TPU kernel: jrr_tpu's SMPL is plain jnp.einsum,
// which XLA fuses. The port's einsum pair lowered the blend's 3x3 products
// to cuBLAS batched GEMV/GEMM calls over B*V problems of 3x3 (one 32x32
// tile per 3x3 block in the backward), and materialised the (B, V, 12)
// per-vertex transforms; these kernels keep those in registers.
//
// Layout: weights (V, J) row-major, the skinning weights shared by every
// frame; a (B, J, 12) the joints' affine transforms [R (3x3 row-major) | t]
// with the rest-pose correction applied; v_posed, verts, g, dv_posed
// (B, V, 3); da (B, J, 12). Per (frame, vertex) T = sum_j w[v, j] a[b, j]
// (12 floats) and verts = T[0:9] (3x3) * v_posed + T[9:12].
//
// Bound on this card, per forward + backward at B = 256, V = 6890: ops
// (T in the forward, its rotation in the backward and da: 288 + 216 + 288
// multiply-adds per (frame, vertex), ~2.8 GFLOP, ~0.04 ms at 67 TFLOP/s
// f32) against bytes (v_posed read twice, verts written, g read, dv_posed
// written: ~105 MB, ~0.03 ms at 3.35 TB/s).
// Design: a CTA works on 8 frames, whose transforms it stages in shared
// memory (read by every thread as broadcasts), and a range of vertices,
// whose weight rows it copies into shared memory with coalesced loads, once
// for the 8 frames. In the forward each thread then owns one vertex for the
// 8 frames. The backward's da = sum_v w[v, j] (g (x) [v_posed; 1]) is a
// (J x V) by (V x 12) product per frame: per tile of 32 vertices, each
// thread first owns one (frame, vertex) pair (dv_posed and the pair's 12
// products into shared memory), then one (frame, 3 joints) block of 36
// outputs over a quarter of the tile's vertices, so that a weight read
// serves 4 frames and a product row 8 lanes; each CTA writes its partial
// sums over its 256 vertices, and the last CTA of a frame group (an integer
// ticket) adds the partials in chunk order. Every sum runs in a fixed order
// and no float is added atomically, so two calls repeat bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;  // the most joints a call may have (SMPL's 24)
constexpr int kAffine = 12;  // entries of one affine transform
constexpr int kOut = kJoints * kAffine;
constexpr int kThreads = 256;
constexpr int kFrames = 8;      // frames per CTA
constexpr int kChunk = 256;     // vertices per CTA
constexpr int kTile = 32;       // vertices per backward tile: one per lane
constexpr int kWRow = 28;       // shared weight row: 24 floats, padded so rows fall in distinct banks
constexpr int kDFrame = kTile * kAffine + 4;  // shared product rows per frame, padded likewise
// The backward's second phase: a thread per (frame, 3 joints) and part of a tile.
constexpr int kQuarters = kThreads / (kFrames * kJoints / 3);

static_assert(kThreads == kFrames * 32, "the backward's first phase gives each frame a warp");
static_assert(kQuarters == 4 && kTile == 8 * kQuarters,
              "the backward's second phase splits a tile in 4 quarters of 8 vertices");

// The transforms of frames b .. b + nb - 1 into s (kFrames, 24, 12), zero past J and nb.
__device__ __forceinline__ void stage_affine(const float* __restrict__ a, int b, int nb, int J,
                                             float* s) {
  for (int i = threadIdx.x; i < kFrames * kOut; i += kThreads) {
    const int f = i / kOut, r = i % kOut, j = r / kAffine;
    s[i] = f < nb && j < J ? a[((long long)(b + f) * J + j) * kAffine + r % kAffine] : 0.f;
  }
}

// Weight rows v0 .. v0 + n - 1 into s (n, kWRow), zero past J and v_end:
// consecutive threads read consecutive floats.
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, int v0, int v_end, int J,
                                              int n, float* s) {
  for (int i = threadIdx.x; i < n * kJoints; i += kThreads) {
    const int u = i / kJoints, j = i % kJoints;
    s[u * kWRow + j] = v0 + u < v_end && j < J ? __ldg(w + (long long)(v0 + u) * J + j) : 0.f;
  }
}

// t = sum_j s_w[j] * s_a[j], j ascending.
__device__ __forceinline__ void blend(const float* s_w, const float4* s_a, float t[kAffine]) {
  float wv[kJoints];
#pragma unroll
  for (int q = 0; q < kJoints / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(s_w)[q];
    wv[4 * q] = x.x, wv[4 * q + 1] = x.y, wv[4 * q + 2] = x.z, wv[4 * q + 3] = x.w;
  }
#pragma unroll
  for (int d = 0; d < kAffine; ++d) t[d] = 0.f;
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 x = s_a[j * 3 + q];
      t[4 * q + 0] = fmaf(wv[j], x.x, t[4 * q + 0]);
      t[4 * q + 1] = fmaf(wv[j], x.y, t[4 * q + 1]);
      t[4 * q + 2] = fmaf(wv[j], x.z, t[4 * q + 2]);
      t[4 * q + 3] = fmaf(wv[j], x.w, t[4 * q + 3]);
    }
  }
}

// verts[b, v] = T_rot v_posed[b, v] + T_t. Grid (ceil(V / 256), ceil(B / 8)).
__global__ void __launch_bounds__(kThreads)
lbs_skin_fwd_kernel(const float* __restrict__ w, const float* __restrict__ a,
                    const float* __restrict__ vp, float* __restrict__ out, int B, int V, int J) {
  __shared__ float4 s_a[kFrames * kOut / 4];
  __shared__ float4 s_w[kChunk * kWRow / 4];
  const int b0 = blockIdx.y * kFrames, v0 = blockIdx.x * kChunk;
  const int nb = min(kFrames, B - b0);
  stage_affine(a, b0, nb, J, reinterpret_cast<float*>(s_a));
  stage_weights(w, v0, V, J, kChunk, reinterpret_cast<float*>(s_w));
  __syncthreads();
  const int v = v0 + threadIdx.x;
  if (v >= V) return;
  const float* s_wv = reinterpret_cast<const float*>(s_w) + threadIdx.x * kWRow;
  for (int f = 0; f < nb; ++f) {
    float t[kAffine];
    blend(s_wv, s_a + f * (kOut / 4), t);
    const long long o = ((long long)(b0 + f) * V + v) * 3;
    const float p0 = vp[o], p1 = vp[o + 1], p2 = vp[o + 2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      out[o + i] = fmaf(t[3 * i + 2], p2, fmaf(t[3 * i + 1], p1, t[3 * i] * p0)) + t[9 + i];
  }
}

// Shared memory of the backward: the staged transforms, weight rows and
// products while the tiles run, then the quarters' sums.
struct BwdTiles {
  float4 a[kFrames * kOut / 4];
  float4 w[kTile * kWRow / 4];
  float4 d[kFrames * kDFrame / 4];
};
constexpr int kRedFloats = kQuarters * kFrames * kOut;
constexpr int kTileFloats = (int)(sizeof(BwdTiles) / 4);
constexpr int kBwdFloats = kTileFloats > kRedFloats ? kTileFloats : kRedFloats;

// Given g = dL/dverts: dv_posed[b, v] = T_rot^T g[b, v], and
// da[b, j, :] = sum_v w[v, j] [g (x) v_posed, g] (the 9 products row-major,
// then g). Grid (C, ceil(B / 8)) with C = ceil(V / 256); partial
// (ceil(B / 8), C, 8, 288) and count (ceil(B / 8),) int32, zero on entry,
// are the wrapper's scratch.
__global__ void __launch_bounds__(kThreads)
lbs_skin_bwd_kernel(const float* __restrict__ w, const float* __restrict__ a,
                    const float* __restrict__ vp, const float* __restrict__ g,
                    float* __restrict__ dvp, float* __restrict__ da, float* __restrict__ partial,
                    int* __restrict__ count, int B, int V, int J) {
  __shared__ float4 s_buf[kBwdFloats / 4];
  __shared__ bool s_last;
  BwdTiles& s = *reinterpret_cast<BwdTiles*>(s_buf);
  const int c = blockIdx.x, fg = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b0 = fg * kFrames, nb = min(kFrames, B - b0);
  // Phase 1: thread (frame `warp`, vertex `lane` of the tile).
  const int b = b0 + warp;
  // Phase 2: thread (frame f2, joints 3 jg .. 3 jg + 2) over vertices 8 q .. 8 q + 7 of the tile.
  const int jg = lane & 7, f2 = 4 * (warp & 1) + (lane >> 3), q = warp >> 1;
  stage_affine(a, b0, nb, J, reinterpret_cast<float*>(s.a));
  float acc[3][kAffine] = {};
  const int v_end = min(V, (c + 1) * kChunk);
  const float* s_w = reinterpret_cast<const float*>(s.w);
  float* s_d = reinterpret_cast<float*>(s.d);
  for (int v0 = c * kChunk; v0 < v_end; v0 += kTile) {
    __syncthreads();  // the last tile's phase 2 has read s.w and s.d (and s.a is staged)
    stage_weights(w, v0, v_end, J, kTile, reinterpret_cast<float*>(s.w));
    __syncthreads();
    const int v = v0 + lane;
    float dt[kAffine] = {};
    if (warp < nb && v < v_end) {
      // The whole T, though dv_posed reads only its rotation: blending just
      // those 9 entries took the kernel from 127 to 80 registers and made it
      // no faster on an H100 (0.124-0.126 against 0.118 ms at B = 256).
      float t[kAffine];
      blend(s_w + lane * kWRow, s.a + warp * (kOut / 4), t);
      const long long o = ((long long)b * V + v) * 3;
      const float p[3] = {vp[o], vp[o + 1], vp[o + 2]};
      const float gg[3] = {g[o], g[o + 1], g[o + 2]};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dvp[o + k] = fmaf(t[6 + k], gg[2], fmaf(t[3 + k], gg[1], t[k] * gg[0]));
#pragma unroll
        for (int i = 0; i < 3; ++i) dt[3 * i + k] = gg[i] * p[k];
        dt[9 + k] = gg[k];
      }
    }
    float4* row = reinterpret_cast<float4*>(s_d + warp * kDFrame + lane * kAffine);
    row[0] = make_float4(dt[0], dt[1], dt[2], dt[3]);
    row[1] = make_float4(dt[4], dt[5], dt[6], dt[7]);
    row[2] = make_float4(dt[8], dt[9], dt[10], dt[11]);
    __syncthreads();
    for (int u = 8 * q; u < 8 * q + 8; ++u) {
      const float x[3] = {s_w[u * kWRow + 3 * jg], s_w[u * kWRow + 3 * jg + 1],
                          s_w[u * kWRow + 3 * jg + 2]};
      const float4* y4 = reinterpret_cast<const float4*>(s_d + f2 * kDFrame + u * kAffine);
      const float4 y0 = y4[0], y1 = y4[1], y2 = y4[2];
      const float y[kAffine] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w,
                                y2.x, y2.y, y2.z, y2.w};
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int d = 0; d < kAffine; ++d) acc[r][d] = fmaf(x[r], y[d], acc[r][d]);
    }
  }
  __syncthreads();
  float* s_red = reinterpret_cast<float*>(s_buf);  // (quarters, frames, 288)
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int d = 0; d < kAffine; ++d)
      s_red[(q * kFrames + f2) * kOut + (3 * jg + r) * kAffine + d] = acc[r][d];
  __syncthreads();
  float* part = partial + ((long long)fg * gridDim.x + c) * kFrames * kOut;
  for (int o = tid; o < kFrames * kOut; o += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kQuarters; ++k) sum += s_red[k * kFrames * kOut + o];
    part[o] = sum;
  }
  __threadfence();  // the partial is visible before the ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(count + fg, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* part_g = partial + (long long)fg * gridDim.x * kFrames * kOut;
  for (int o = tid; o < nb * kOut; o += kThreads) {
    const int f = o / kOut, r = o % kOut;
    if (r >= J * kAffine) continue;
    float sum = 0.f;
    for (int k = 0; k < (int)gridDim.x; ++k)
      sum += __ldcg(part_g + (long long)k * kFrames * kOut + o);
    da[((long long)(b0 + f) * J) * kAffine + r] = sum;
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).

int jrr_lbs_skin_fwd(const float* w, const float* a, const float* vp, float* out, int B, int V,
                     int J, void* stream) {
  const dim3 grid((V + kChunk - 1) / kChunk, (B + kFrames - 1) / kFrames);
  lbs_skin_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(w, a, vp, out, B, V, J);
  return (int)cudaGetLastError();
}

int jrr_lbs_skin_bwd(const float* w, const float* a, const float* vp, const float* g, float* dvp,
                     float* da, float* partial, int* count, int B, int V, int J, void* stream) {
  const dim3 grid((V + kChunk - 1) / kChunk, (B + kFrames - 1) / kFrames);
  lbs_skin_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(w, a, vp, g, dvp, da, partial,
                                                                   count, B, V, J);
  return (int)cudaGetLastError();
}

}  // extern "C"
