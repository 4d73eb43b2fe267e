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
// chains and the RMW at dynamic rows is one CTA of 128 threads per tile,
// thread k owning column k. Sums across CTAs (the read-modify-write
// probes) add int64 fixed point (value * 2^32), the form the loss kernels'
// gradient tables take: with global atomics in the gather + RMW probe,
// through per-CTA resident tables in the RMW probe. Integer adds commute,
// so the sums repeat bit for bit.
// Indices are taken modulo their axis length (row index & 7, lane & 127),
// so no input reads outside a shared-memory block; page ids are checked by
// the wrappers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cassert>

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
// int64 fixed point (each term llrintf(x * 2^32)). Bound: bytes (x read
// once: 25.7 MB at the probe's 6272 tiles). The Pallas kernel kept its
// output block resident in VMEM across the whole grid; the first design
// here added every term with a global int64 atomic (6.4 M atomics onto 7168
// addresses) and took twice as long as index_add_. Design: a resident
// accumulator per CTA. A persistent grid of one CTA per SM; 384 threads in
// three lane groups, thread g * 128 + k owning lane k of group g's private
// int64 copy of the table in shared memory (rows * 1 KB each: 168 KB at 56
// rows, 192 KB at 64, so dynamic shared memory). Group g walks every third
// tile of the CTA's share, kRmwUnroll tiles at a time with all their loads
// issued first. The row index is uniform across the group and each thread
// adds into its own lane: a plain read-add-write, no bank conflict, no
// atomic. The loads in flight bound this kernel: more groups per CTA keep
// more of them in flight than a longer unroll or more CTAs of one group
// each did, and four copies do not fit at 64 rows. The CTA adds its
// copies and writes one partial table; rmw_rows_reduce_kernel sums the
// partials per entry. No atomics at all: one flush atomic per entry and CTA would still
// be 132 * 7168 = 946 k int64 atomics on 7168 addresses, where the partials
// cost 7.5 MB of L2 traffic. Integer sums do not depend on their order, so
// the result is the same bit for bit on every run, and equals the atomic
// version's. The kernel checks its inputs itself (device asserts: page ids
// in [0, rows), |x| < x_limit so no sum overflows): the same checks as
// separate PyTorch reductions read x twice more and took longer than the
// kernel.
constexpr int kRmwGroups = 3;
constexpr int kRmwUnroll = 4;

__global__ void __launch_bounds__(kLanes * kRmwGroups)
rmw_rows_kernel(const int* __restrict__ pages, const float* __restrict__ x,
                long long* __restrict__ partial, int n_tiles, int table_rows, float x_limit) {
  extern __shared__ long long s_acc[];  // [kRmwGroups][table_rows][kLanes]
  const int k = threadIdx.x & (kLanes - 1), g = threadIdx.x / kLanes;
  const int entries = table_rows * kLanes;
  for (int e = threadIdx.x; e < kRmwGroups * entries; e += blockDim.x) s_acc[e] = 0;
  __syncthreads();
  long long* acc = s_acc + g * entries + k;
  // Group g takes tiles blockIdx.x + gridDim.x * (g + kRmwGroups * j), j = 0, 1, ...
  const long long step = (long long)gridDim.x * kRmwGroups;
  for (long long n0 = blockIdx.x + (long long)g * gridDim.x; n0 < n_tiles;
       n0 += step * kRmwUnroll) {
    float v[kRmwUnroll][kRows];
    int pg[kRmwUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kRmwUnroll; ++u) {
      const long long n = n0 + u * step;
      const bool live = n < n_tiles;
      const int4 p0 = live ? __ldg(reinterpret_cast<const int4*>(pages + n * kRows)) : int4{};
      const int4 p1 = live ? __ldg(reinterpret_cast<const int4*>(pages + n * kRows) + 1) : int4{};
      pg[u][0] = p0.x, pg[u][1] = p0.y, pg[u][2] = p0.z, pg[u][3] = p0.w;
      pg[u][4] = p1.x, pg[u][5] = p1.y, pg[u][6] = p1.z, pg[u][7] = p1.w;
#pragma unroll
      for (int p = 0; p < kRows; ++p)
        v[u][p] = live ? __ldg(x + (n * kRows + p) * kLanes + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRmwUnroll; ++u) {
#pragma unroll
      for (int p = 0; p < kRows; ++p) {
        assert(pg[u][p] >= 0 && pg[u][p] < table_rows && fabsf(v[u][p]) < x_limit);
        acc[pg[u][p] * kLanes] += llrintf(v[u][p] * kFixedScale);
      }
    }
  }
  __syncthreads();
  long long* part = partial + (long long)blockIdx.x * entries;
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    long long sum = 0;
#pragma unroll
    for (int gg = 0; gg < kRmwGroups; ++gg) sum += s_acc[gg * entries + e];
    part[e] = sum;
  }
}

// out[e] = sum over the n_parts partial tables of partial[part][e]. A CTA of
// 128 threads takes 16 entries, its 8 slices of threads every 8th partial
// each (128-byte rows, loads in flight across the slices); the slices' sums
// add in shared memory.
constexpr int kReduceCols = 16;
constexpr int kReduceSlices = kLanes / kReduceCols;

__global__ void __launch_bounds__(kLanes)
rmw_rows_reduce_kernel(const long long* __restrict__ partial, long long* __restrict__ out,
                       int n_parts, int entries) {
  __shared__ long long s_sum[kReduceSlices][kReduceCols];
  const int col = threadIdx.x % kReduceCols, slice = threadIdx.x / kReduceCols;
  const int e = blockIdx.x * kReduceCols + col;
  long long s = 0;
  if (e < entries) {
#pragma unroll 4
    for (int c = slice; c < n_parts; c += kReduceSlices)
      s += __ldg(partial + (long long)c * entries + e);
  }
  s_sum[slice][col] = s;
  __syncthreads();
  if (slice == 0 && e < entries) {
    long long total = 0;
#pragma unroll
    for (int i = 0; i < kReduceSlices; ++i) total += s_sum[i][col];
    out[e] = total;
  }
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

int jrr_rmw_rows(const int* pages, const float* x, long long* partial, long long* out,
                 int n_tiles, int table_rows, int n_ctas, float x_limit, void* stream) {
  // Above 48 KB of dynamic shared memory needs the opt-in, set once per
  // device for the largest table (outside any graph capture: the wrappers'
  // first call runs eagerly).
  static int opted_in_device = -1;
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess && device != opted_in_device) {
    rc = cudaFuncSetAttribute(rmw_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(kRmwGroups * kMaxTableRows * kLanes * sizeof(long long)));
    if (rc == cudaSuccess) opted_in_device = device;
  }
  if (rc != cudaSuccess) return (int)rc;
  const int entries = table_rows * kLanes;
  rmw_rows_kernel<<<n_ctas, kLanes * kRmwGroups, kRmwGroups * entries * sizeof(long long),
                    (cudaStream_t)stream>>>(pages, x, partial, n_tiles, table_rows, x_limit);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  rmw_rows_reduce_kernel<<<(entries + kReduceCols - 1) / kReduceCols, kLanes, 0,
                           (cudaStream_t)stream>>>(partial, out, n_ctas, entries);
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
