// Microbenchmarks of the fused rasterizer's primitives on Hopper (sm_90a):
// Hopper counterparts of the Pallas probes tools/kernel_probe.py,
// tools/kernel_probe2.py and tools/bf16_vpu_probe.py, at their shapes.
// Built into the kernel library by jrr_tpu_torch/kernels.py; driven by
// jrr_tpu_torch/probes/*.py and chip_smoke.py, which hold each one against
// its plain PyTorch version.
//
// Shapes: N tiles of an (8, 128) block each (the TPU's (sublane, lane)
// tile; here 8 rows of 128 threads), P = 8 page ids per tile, a table of
// at most 64 rows of 128 floats. Every kernel but the elementwise and FMA
// chains is one CTA of 128 threads per tile, thread k owning column k.
// Sums across CTAs (the read-modify-write probes) add int64 fixed point
// (value * 2^32) with atomics, the primitive the loss kernels' gradient
// tables rely on: integer adds commute, so the sums repeat bit for bit.
// Indices are taken modulo their axis length (row index & 7, lane & 127),
// so no input reads outside a shared-memory block; page ids are checked by
// the wrappers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 8;           // rows (TPU sublanes) per tile block, and page ids per tile
constexpr int kMaxTableRows = 64;  // table rows a CTA can hold in shared memory (32 KB)
constexpr float kFixedScale = 4294967296.0f;  // 2^32, as the loss kernels

__device__ __forceinline__ void add_fixed(unsigned long long* dst, float v) {
  const long long q = llrintf(v * kFixedScale);
  if (q != 0) atomicAdd(dst, (unsigned long long)q);  // two's complement: negatives subtract
}

// Replaces tools/kernel_probe.py::gather_kernel (:43). Per tile n: stage
// the 8 table rows pages[n, 0..7] in shared memory (the page workspace),
// out[n, r, k] = ws[idx >> 7][idx & 127] for idx = idx[n, r, k], then the
// backward's pattern dtab[pages[n, p]] += 0.5 * out[n, p]. Bound: bytes
// (idx read, out written once; ~no arithmetic). The Pallas kernel's one-hot
// MXU product and sublane select are a shared-memory read here.
__global__ void __launch_bounds__(kLanes)
paged_gather_rmw_kernel(const int* __restrict__ pages, const int* __restrict__ idx,
                        const float* __restrict__ table, float* __restrict__ out,
                        unsigned long long* __restrict__ dtab) {
  __shared__ float ws[kRows][kLanes];
  __shared__ int s_pages[kRows];
  const long long n = blockIdx.x;
  const int k = threadIdx.x;
  if (k < kRows) s_pages[k] = pages[n * kRows + k];
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kRows; ++p) ws[p][k] = table[s_pages[p] * kLanes + k];
  __syncthreads();
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = idx[(n * kRows + r) * kLanes + k];
    v[r] = ws[(i >> 7) & (kRows - 1)][i & (kLanes - 1)];
    out[(n * kRows + r) * kLanes + k] = v[r];
  }
#pragma unroll
  for (int p = 0; p < kRows; ++p) add_fixed(dtab + s_pages[p] * kLanes + k, 0.5f * v[p]);
}

// Replaces tools/kernel_probe.py::taa_kernel (:107) and the C / C2 probes
// of tools/kernel_probe2.py (:114, :130): take_along_axis on one (8, 128)
// block, along lanes (kAxis 2: out[r][k] = x[r][i]) or rows (kAxis 1:
// out[r][k] = x[i][k]). The block is staged in shared memory with coalesced
// reads, so the gather is a shared-memory read. Bound: bytes.
template <int kAxis>
__global__ void __launch_bounds__(kLanes)
take_along_axis_kernel(const float* __restrict__ x, const int* __restrict__ index,
                       float* __restrict__ out) {
  __shared__ float s_x[kRows][kLanes];
  const long long base = (long long)blockIdx.x * kRows * kLanes;
  const int k = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s_x[r][k] = x[base + r * kLanes + k];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = index[base + r * kLanes + k];
    out[base + r * kLanes + k] =
        kAxis == 2 ? s_x[r][i & (kLanes - 1)] : s_x[i & (kRows - 1)][k];
  }
}

// Replaces the A probe of tools/kernel_probe2.py (k_dynslice :73): rows of
// a resident table at dynamic row ids, out[n, p] = table[pages[n, p]]. The
// whole table (rows <= 64) sits in shared memory, loaded once per CTA, and
// each CTA copies the rows of kTilesPerCta tiles. Bound: bytes (out).
constexpr int kTilesPerCta = 8;
__global__ void __launch_bounds__(kLanes)
dyn_slice_kernel(const int* __restrict__ pages, const float* __restrict__ table,
                 float* __restrict__ out, int n_tiles, int table_rows) {
  __shared__ float s_table[kMaxTableRows][kLanes];
  const int k = threadIdx.x;
  for (int r = 0; r < table_rows; ++r) s_table[r][k] = table[r * kLanes + k];
  __syncthreads();
  for (int c = 0; c < kTilesPerCta; ++c) {
    const long long n = (long long)blockIdx.x * kTilesPerCta + c;
    if (n >= n_tiles) return;
#pragma unroll
    for (int p = 0; p < kRows; ++p)
      out[(n * kRows + p) * kLanes + k] = s_table[pages[n * kRows + p]][k];
  }
}

// Replaces the B probe of tools/kernel_probe2.py (k_onehot :90): the lane
// gather as the product of the row with a one-hot matrix,
// out[n, r, k] = sum_l x[n, r, l] * (l == il[n, r, k]), written out as 128
// f32 FMAs per output (no tensor cores). Exact: every term but one is a
// signed zero. Bound: operations (256 per output) against 8 bytes moved.
__global__ void __launch_bounds__(kLanes)
onehot_gather_kernel(const float* __restrict__ x, const int* __restrict__ il,
                     float* __restrict__ out) {
  __shared__ float s_x[kRows][kLanes];
  const long long base = (long long)blockIdx.x * kRows * kLanes;
  const int k = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s_x[r][k] = x[base + r * kLanes + k];
  __syncthreads();
  for (int r = 0; r < kRows; ++r) {
    const int lk = il[base + r * kLanes + k];
    float acc = 0.f;
#pragma unroll 16
    for (int l = 0; l < kLanes; ++l) acc = fmaf(s_x[r][l], l == lk ? 1.f : 0.f, acc);
    out[base + r * kLanes + k] = acc;
  }
}

// Replaces the D probe of tools/kernel_probe2.py (k_selred :146): select-
// reduce over the 8 rows, out[n, r, k] = sum_s (s == isub[n, r, k]) *
// x[n, s, k]. Thread k keeps its column of 8 values in registers. Exact
// (the other terms add zero). Bound: bytes.
__global__ void __launch_bounds__(kLanes)
select_reduce_kernel(const float* __restrict__ x, const int* __restrict__ isub,
                     float* __restrict__ out) {
  const long long base = (long long)blockIdx.x * kRows * kLanes;
  const int k = threadIdx.x;
  float col[kRows];
#pragma unroll
  for (int s = 0; s < kRows; ++s) col[s] = x[base + s * kLanes + k];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = isub[base + r * kLanes + k];
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < kRows; ++s) acc += s == i ? col[s] : 0.f;
    out[base + r * kLanes + k] = acc;
  }
}

// Replaces the E probe of tools/kernel_probe2.py (k_rmw :170): read-modify-
// write at dynamic rows, out[pages[n, p]] += x[n, p] over every tile, in
// int64 fixed point. Bound: bytes (x read once).
__global__ void __launch_bounds__(kLanes)
rmw_rows_kernel(const int* __restrict__ pages, const float* __restrict__ x,
                unsigned long long* __restrict__ out) {
  const long long n = blockIdx.x;
  const int k = threadIdx.x;
#pragma unroll
  for (int p = 0; p < kRows; ++p)
    add_fixed(out + pages[n * kRows + p] * kLanes + k, x[(n * kRows + p) * kLanes + k]);
}

// Replaces the F probe of tools/kernel_probe2.py (k_base :191), the
// elementwise anchor out = 2x + 1 (x * 2 is exact, so one fmaf rounds as
// the two-step version does). float4 per thread. Bound: bytes.
__global__ void elementwise_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                   long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    out[i] = make_float4(fmaf(v.x, 2.f, 1.f), fmaf(v.y, 2.f, 1.f), fmaf(v.z, 2.f, 1.f),
                         fmaf(v.w, 2.f, 1.f));
  }
}

// Replace tools/bf16_vpu_probe.py::_kernel (:36): `reps` steps of two
// dependent streams, acc = acc * c1 + c2 and y = y * c2 + c1, each step one
// fused multiply-add rounded once (fmaf, __hfma2), and out = acc + y in
// f32. The bf16 kernel packs two elements into one __nv_bfloat162 per
// instruction. c1 = 1 + 2^-10 is exact in f32 but rounds to 1 in bf16 (8
// significant bits), as in the Pallas probe. Bound: operations (4 flops
// per element and step).
constexpr float kC1 = 1.0009765625f;
constexpr float kC2 = -0.001953125f;  // -2^-9

__global__ void fma_chain_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                                     long long n, int reps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = x[i], y = x[i];
#pragma unroll 8
  for (int s = 0; s < reps; ++s) {
    acc = fmaf(acc, kC1, kC2);
    y = fmaf(y, kC2, kC1);
  }
  out[i] = acc + y;
}

__global__ void fma_chain_bf16_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                                      long long n2, int reps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 c1 = __float2bfloat162_rn(kC1), c2 = __float2bfloat162_rn(kC2);
  __nv_bfloat162 acc = __float22bfloat162_rn(x[i]);
  __nv_bfloat162 y = acc;
#pragma unroll 8
  for (int s = 0; s < reps; ++s) {
    acc = __hfma2(acc, c1, c2);
    y = __hfma2(y, c2, c1);
  }
  const float2 a = __bfloat1622float2(acc), b = __bfloat1622float2(y);
  out[i] = make_float2(a.x + b.x, a.y + b.y);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).

int jrr_paged_gather_rmw(const int* pages, const int* idx, const float* table, float* out,
                         unsigned long long* dtab, int n_tiles, void* stream) {
  paged_gather_rmw_kernel<<<n_tiles, kLanes, 0, (cudaStream_t)stream>>>(pages, idx, table, out,
                                                                          dtab);
  return (int)cudaGetLastError();
}

int jrr_take_along_axis(const float* x, const int* index, float* out, int n_tiles, int axis,
                        void* stream) {
  if (axis == 2)
    take_along_axis_kernel<2><<<n_tiles, kLanes, 0, (cudaStream_t)stream>>>(x, index, out);
  else
    take_along_axis_kernel<1><<<n_tiles, kLanes, 0, (cudaStream_t)stream>>>(x, index, out);
  return (int)cudaGetLastError();
}

int jrr_dyn_slice(const int* pages, const float* table, float* out, int n_tiles, int table_rows,
                  void* stream) {
  const int grid = (n_tiles + kTilesPerCta - 1) / kTilesPerCta;
  dyn_slice_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(pages, table, out, n_tiles,
                                                              table_rows);
  return (int)cudaGetLastError();
}

int jrr_onehot_gather(const float* x, const int* il, float* out, int n_tiles, void* stream) {
  onehot_gather_kernel<<<n_tiles, kLanes, 0, (cudaStream_t)stream>>>(x, il, out);
  return (int)cudaGetLastError();
}

int jrr_select_reduce(const float* x, const int* isub, float* out, int n_tiles, void* stream) {
  select_reduce_kernel<<<n_tiles, kLanes, 0, (cudaStream_t)stream>>>(x, isub, out);
  return (int)cudaGetLastError();
}

int jrr_rmw_rows(const int* pages, const float* x, unsigned long long* out, int n_tiles,
                 void* stream) {
  rmw_rows_kernel<<<n_tiles, kLanes, 0, (cudaStream_t)stream>>>(pages, x, out);
  return (int)cudaGetLastError();
}

int jrr_elementwise(const float* x, float* out, long long n, void* stream) {
  const long long n4 = n / 4;
  const int grid = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  elementwise_kernel<<<grid > 0 ? grid : 1, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, n4);
  return (int)cudaGetLastError();
}

int jrr_fma_chain(const float* x, float* out, long long n, int reps, int bf16, void* stream) {
  if (bf16) {
    const long long n2 = n / 2;
    fma_chain_bf16_kernel<<<(unsigned)((n2 + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const float2*)x, (float2*)out, n2, reps);
  } else {
    fma_chain_f32_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        x, out, n, reps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
