// Microbenchmarks of the fused rasterizer's primitives on Hopper (sm_90a):
// Hopper counterparts of the Pallas probes tools/kernel_probe.py,
// tools/kernel_probe2.py and tools/bf16_vpu_probe.py, at their shapes.
// Built into the kernel library by jrr_tpu_torch/kernels.py; driven by
// jrr_tpu_torch/probes/*.py and chip_smoke.py, which hold each one against
// its plain PyTorch version.
//
// Shapes: N tiles of an (8, 128) block each (the TPU's (sublane, lane)
// tile), P = 8 page ids per tile, a table of at most 64 rows of 128 floats.
// The row gather and the select-reduce are one CTA of 128 threads per tile,
// thread k owning column k. The lane gather gives each row of a
// tile to one warp (four lanes per thread, as float4) and walks many tiles
// per CTA; the dynamic-row copy is a persistent grid with the table resident
// per CTA. The read-modify-write probes (the gather + RMW and the RMW at
// dynamic rows) run one persistent CTA per SM of three 128-thread lane
// groups, each group adding int64 fixed point (value * 2^32, the form the
// loss kernels' gradient tables take) into its own resident copy of the
// table in shared memory; a second kernel sums the CTAs' partial tables. No
// atomics: integer adds commute, so the sums repeat bit for bit.
// Indices are taken modulo their axis length (row index & 7, lane & 127),
// so no input reads outside its block; page ids are checked in the kernels
// (device asserts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cassert>

namespace {

constexpr int kLanes = 128;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRows = 8;           // rows (TPU sublanes) per tile block, and page ids per tile
constexpr int kMaxTableRows = 64;  // table rows a CTA can hold in shared memory (32 KB)
constexpr float kFixedScale = 4294967296.0f;  // 2^32, as the loss kernels

// The read-modify-write probes' lane groups (private table copies) per CTA
// and the tiles a group loads ahead: more groups keep more loads in
// flight than a longer unroll or more CTAs of one group each did (E probe),
// and four int64 copies do not fit at 64 rows.
constexpr int kRmwGroups = 3;
constexpr int kRmwUnroll = 4;
constexpr float kHalf = 0.5f;  // the gather + RMW probe's backward scale

// The 8 page ids of tile n (16-byte aligned, uniform across the group: one
// broadcast load each half), zeros past the last tile.
__device__ __forceinline__ void load_pages(const int* __restrict__ pages, long long n, bool live,
                                           int pg[kRows]) {
  const int4 p0 = live ? __ldg(reinterpret_cast<const int4*>(pages + n * kRows)) : int4{};
  const int4 p1 = live ? __ldg(reinterpret_cast<const int4*>(pages + n * kRows) + 1) : int4{};
  pg[0] = p0.x, pg[1] = p0.y, pg[2] = p0.z, pg[3] = p0.w;
  pg[4] = p1.x, pg[5] = p1.y, pg[6] = p1.z, pg[7] = p1.w;
}

// pg[s] for a slot s in [0, 8) that differs from thread to thread: a
// select tree on its three bits, where pg[s] would put pg in local memory.
__device__ __forceinline__ int page_of_slot(const int pg[kRows], int s) {
  const int a0 = (s & 1) ? pg[1] : pg[0], a1 = (s & 1) ? pg[3] : pg[2];
  const int a2 = (s & 1) ? pg[5] : pg[4], a3 = (s & 1) ? pg[7] : pg[6];
  const int b0 = (s & 2) ? a1 : a0, b1 = (s & 2) ? a3 : a2;
  return (s & 4) ? b1 : b0;
}

// The CTA's resident int64 copies, one per lane group (entries each), summed
// into its partial table (after the caller's barrier).
__device__ __forceinline__ void write_partial(const long long* s_acc, long long* partial,
                                              int entries) {
  long long* part = partial + (long long)blockIdx.x * entries;
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    long long sum = 0;
#pragma unroll
    for (int gg = 0; gg < kRmwGroups; ++gg) sum += s_acc[gg * entries + e];
    part[e] = sum;
  }
}

// Replaces tools/kernel_probe.py::gather_kernel (:43). Per tile n:
// out[n, r, k] = table[pages[n, (i >> 7) & 7]][i & 127] for
// i = idx[n, r, k], then the backward's pattern dtab[pages[n, p]] +=
// 0.5 * out[n, p], in int64 fixed point (each term llrintf(0.5 out 2^32)).
// Bound: bytes (idx read, out written once; ~no arithmetic). The Pallas
// kernel's one-hot MXU product and sublane select are a shared-memory read
// here. The first design staged each tile's 8 rows in a workspace and added
// every term with a global int64 atomic (768 per tile, 6.4 M onto 7168
// addresses at the probe's shapes). Design: the E probe's (rmw_rows_kernel)
// with the gather in front. A persistent grid of one CTA per SM holds the
// whole f32 table in shared memory (28 KB at 56 rows, 32 KB at 64), so the
// per-tile workspace goes, and beside it kRmwGroups private int64 copies of
// dtab, one per lane group (172 KB at 56 rows; 192 KB + 32 KB = 229,376 B
// at 64, under the 232,448 B a CTA can opt in to). Group g walks every
// third tile of the CTA's share, kRmwUnroll tiles at a time with their page
// ids and indices loaded first; each thread gathers its column's 8 values
// from the resident table and adds the scaled rows into its own lane of its
// group's copy (the row uniform across the group): a plain read-add-write,
// no bank conflict, no atomic. The CTA adds its copies into one partial
// table and rmw_rows_reduce_kernel sums the partials per entry. Integer
// sums do not depend on their order, so dtab equals the atomic version's
// bit for bit, and out is exact. The kernel checks its inputs itself
// (device asserts: page ids in [0, rows), |table| < table_limit so no sum
// overflows), as the E probe does.
__global__ void __launch_bounds__(kLanes * kRmwGroups)
paged_gather_rmw_kernel(const int* __restrict__ pages, const int* __restrict__ idx,
                        const float* __restrict__ table, float* __restrict__ out,
                        long long* __restrict__ partial, int n_tiles, int table_rows,
                        float table_limit) {
  extern __shared__ long long s_acc[];  // [kRmwGroups][table_rows][kLanes], then the f32 table
  const int k = threadIdx.x & (kLanes - 1), g = threadIdx.x / kLanes;
  const int entries = table_rows * kLanes;
  float* s_table = reinterpret_cast<float*>(s_acc + kRmwGroups * entries);
  for (int e = threadIdx.x; e < kRmwGroups * entries; e += blockDim.x) s_acc[e] = 0;
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const float v = __ldg(table + e);
    assert(fabsf(v) < table_limit);
    s_table[e] = v;
  }
  __syncthreads();
  long long* acc = s_acc + g * entries + k;
  // Group g takes tiles blockIdx.x + gridDim.x * (g + kRmwGroups * j), j = 0, 1, ...
  const long long step = (long long)gridDim.x * kRmwGroups;
  for (long long n0 = blockIdx.x + (long long)g * gridDim.x; n0 < n_tiles;
       n0 += step * kRmwUnroll) {
    int pg[kRmwUnroll][kRows], ix[kRmwUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kRmwUnroll; ++u) {
      const long long n = n0 + u * step;
      const bool live = n < n_tiles;
      load_pages(pages, n, live, pg[u]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) ix[u][r] = live ? __ldg(idx + (n * kRows + r) * kLanes + k) : 0;
    }
#pragma unroll
    for (int u = 0; u < kRmwUnroll; ++u) {
      const long long n = n0 + u * step;
      if (n >= n_tiles) break;  // uniform across the group
#pragma unroll
      for (int r = 0; r < kRows; ++r) assert(pg[u][r] >= 0 && pg[u][r] < table_rows);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = ix[u][r];
        const float v = s_table[page_of_slot(pg[u], (i >> 7) & (kRows - 1)) * kLanes + (i & (kLanes - 1))];
        out[(n * kRows + r) * kLanes + k] = v;
        acc[pg[u][r] * kLanes] += llrintf(kHalf * v * kFixedScale);
      }
    }
  }
  __syncthreads();
  write_partial(s_acc, partial, entries);
}

// Replaces the row case of tools/kernel_probe.py::taa_kernel (:107) and the
// C2 probe of tools/kernel_probe2.py (:130): take_along_axis along the rows
// of one (8, 128) block, out[r][k] = x[i & 7][k] for i = index[r][k]. The
// block is staged in shared memory with coalesced reads, so the gather is a
// shared-memory read. Bound: bytes. (The lane case, taa_kernel's other axis
// and the C probe, is lane_gather_kernel's.)
__global__ void __launch_bounds__(kLanes)
row_gather_kernel(const float* __restrict__ x, const int* __restrict__ index,
                  float* __restrict__ out) {
  __shared__ float s_x[kRows][kLanes];
  const long long base = (long long)blockIdx.x * kRows * kLanes;
  const int k = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s_x[r][k] = x[base + r * kLanes + k];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    out[base + r * kLanes + k] = s_x[index[base + r * kLanes + k] & (kRows - 1)][k];
}

// Replaces the A probe of tools/kernel_probe2.py (k_dynslice :73): rows of
// a resident table at dynamic row ids, out[n, p] = table[pages[n, p]].
// Bound: bytes (out written: 25.7 MB at the probe's 6272 tiles; the table
// and the page ids are 1% of it). The first design gave each CTA 8 tiles,
// so 784 CTAs each read the whole table (22.5 MB of L2 reads against 25.7
// MB written) with scalar loads, read every page id alone and stored 4
// bytes per thread. Design: a persistent grid of kSliceCtasPerSm CTAs per SM
// (the SM count read from the device). Each CTA loads the table into shared
// memory once, as float4, while its warps' first page ids are in flight,
// then walks a contiguous share of the tiles: warp w takes every
// kSliceWarps-th tile of the share from the w-th, reads the tile's 8 page
// ids as two int4 loads (the next tile's issued before this tile's rows
// go out) and writes its 8 rows, each a whole 512-byte row as 32 float4
// streaming stores, all 8 in flight. The kernel checks the page ids itself
// (device asserts: in [0, rows)).
constexpr int kSliceWarps = 16;
constexpr int kSliceCtasPerSm = 1;

__global__ void __launch_bounds__(kSliceWarps * kWarp)
dyn_slice_kernel(const int* __restrict__ pages, const float4* __restrict__ table,
                 float4* __restrict__ out, int n_tiles, int table_rows) {
  __shared__ float4 s_table[kMaxTableRows * kWarp];  // row r: s_table[r * 32 .. r * 32 + 31]
  const int lane = threadIdx.x & (kWarp - 1), w = threadIdx.x / kWarp;
  const long long hi = (long long)n_tiles * (blockIdx.x + 1) / gridDim.x;
  long long n = (long long)n_tiles * blockIdx.x / gridDim.x + w;
  int pg[kRows];
  load_pages(pages, n, n < hi, pg);
  for (int e = threadIdx.x; e < table_rows * kWarp; e += blockDim.x) s_table[e] = __ldg(table + e);
  __syncthreads();
  for (; n < hi; n += kSliceWarps) {
    int next[kRows];
    load_pages(pages, n + kSliceWarps, n + kSliceWarps < hi, next);
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      assert(pg[p] >= 0 && pg[p] < table_rows);
      __stcs(out + (n * kRows + p) * kWarp + lane, s_table[pg[p] * kWarp + lane]);
    }
#pragma unroll
    for (int p = 0; p < kRows; ++p) pg[p] = next[p];
  }
}

// x[i & 127] of a warp's 128-float row held as one float4 per lane (lane j
// holds x[4j .. 4j + 3]): the four registers of lane (i >> 2) & 31, one
// shuffle each, and a select of register i & 3.
__device__ __forceinline__ float row_at(const float4& v, int i) {
  const int src = (i >> 2) & (kWarp - 1);
  const float a = __shfl_sync(kFullMask, v.x, src), b = __shfl_sync(kFullMask, v.y, src);
  const float c = __shfl_sync(kFullMask, v.z, src), d = __shfl_sync(kFullMask, v.w, src);
  return (i & 2) ? ((i & 1) ? d : c) : ((i & 1) ? b : a);
}

// Replaces the B probe of tools/kernel_probe2.py (k_onehot :90), the lane
// case of tools/kernel_probe.py::taa_kernel (:107) and the C probe of
// tools/kernel_probe2.py (:114): the lane gather out[n, r, k] =
// x[n, r, il[n, r, k]]. For B the TPU computes it as the row times a
// 128 x 128 one-hot matrix, only because its vector unit has no dynamic
// lane gather; the first design here copied that, 128 dependent f32 FMAs
// per output over shared-memory broadcasts, at 18% of the bytes bound. On
// Hopper a gather has no operand reuse, and tensor cores cannot help (a
// TF32 or bf16 product would round x, which must come through exactly).
// Bound: bytes (x and il read once, out written once: 77 MB at the probes'
// 6272 tiles). Design: a CTA of 8 warps takes a tile at a time, warp r its
// row r, and walks every gridDim-th tile (a grid of kGatherCtasPerSm CTAs
// per SM). Each thread loads four lanes of x and il as one float4 and one
// int4 (a warp reads its 512-byte rows whole), the next tile's loads issued
// before this tile's gathers; the gather is done in registers, four
// shuffles and a select per output (row_at), with no shared memory and no
// barrier; out goes out as float4 streaming stores. Shuffles rather than a
// shared-memory copy of the row: each warp holds exactly its row, so no
// store, barrier or bank conflict stands between the loads and the gather,
// and 16 shuffles per thread and row stay far below the card's shuffle
// rate at this byte count. With zero_outside (the one-hot product's
// function) an index outside [0, 128) gives 0, as no one-hot term matches;
// otherwise indices are taken modulo 128, as take_along_axis's. Exact.
constexpr int kGatherThreads = kRows * kWarp;  // one warp per row of the tile
constexpr int kGatherCtasPerSm = 6;

__device__ __forceinline__ float lane_value(const float4& v, int i, bool zero_outside) {
  const float g = row_at(v, i);
  return zero_outside && (unsigned)i >= (unsigned)kLanes ? 0.f : g;
}

__global__ void __launch_bounds__(kGatherThreads, kGatherCtasPerSm)
lane_gather_kernel(const float4* __restrict__ x, const int4* __restrict__ il,
                   float4* __restrict__ out, int n_tiles, int zero_outside) {
  constexpr int kTile4 = kRows * kLanes / 4;  // float4s per tile, one per thread
  const long long stride = gridDim.x;
  long long n = blockIdx.x;
  if (n >= n_tiles) return;
  const int t = threadIdx.x;
  float4 v = __ldcs(x + n * kTile4 + t);
  int4 i = __ldcs(il + n * kTile4 + t);
  for (; n < n_tiles; n += stride) {
    const bool more = n + stride < n_tiles;  // uniform across the CTA
    const float4 v_next = more ? __ldcs(x + (n + stride) * kTile4 + t) : float4{};
    const int4 i_next = more ? __ldcs(il + (n + stride) * kTile4 + t) : int4{};
    const bool z = zero_outside != 0;
    __stcs(out + n * kTile4 + t,
           make_float4(lane_value(v, i.x, z), lane_value(v, i.y, z), lane_value(v, i.z, z),
                       lane_value(v, i.w, z)));
    v = v_next;
    i = i_next;
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
      load_pages(pages, n, live, pg[u]);
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
  write_partial(s_acc, partial, entries);
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
// f32. c1 = 1 + 2^-10 is exact in f32 but rounds to 1 in bf16 (8
// significant bits), as in the Pallas probe. Bound: operations (4 flops
// per element and step), at the data sheet's 67 (f32) and 134 (packed
// bf16) TFLOP/s.
//
// What bounds it on this card: the FMA pipes. A sweep over the chain length
// (probes/bf16_probe.py::sweep) and the SASS show HFMA2.BF16_V2 issuing at
// 2 warp instructions per SM and clock, half the rate the data sheet's 134
// TFLOP/s assumes (FFMA issues at up to 4): the packed-bf16 chain's floor
// is the f32 chain's bound. The first design (one element pair per thread,
// a runtime loop unrolled 8 times, 8192 CTAs) spent 3 issue slots of 19 on
// the loop and ran loads, chain and stores as phases: the f32 chain reached
// 2.8 FFMA per SM and clock.
//
// Design, one template for both types: a persistent grid of
// kChainCtasPerSm CTAs per SM in which each thread walks every
// (grid size)-th float4, loading the next one before the chain of this one
// so that the memory traffic hides under the arithmetic; 128-bit loads and
// stores; 8 (f32) or 4 (bf16) independent chains per thread. The probe's
// chain length is a template argument, so its 200 steps unroll completely
// (as the Pallas body's Python loop does), 2-5% faster than the chunked
// instance at 200 steps; other lengths run the same body in unrolled
// chunks of kChainUnroll steps and a remainder loop. Two float4 per thread
// unrolled completely measured slower in f32 (3200 FMA of code).
constexpr float kC1 = 1.0009765625f;
constexpr float kC2 = -0.001953125f;  // -2^-9
constexpr int kChainThreads = 256;
constexpr int kChainCtasPerSm = 4;
constexpr int kChainUnroll = 25;
constexpr int kChainProbeReps = 200;  // bf16_vpu_probe.REPS

// One float4's four elements in float32: one FFMA per element and stream.
struct ChainF32 {
  struct Regs {
    float acc[4], y[4];
  };
  static __device__ __forceinline__ void init(const float4& v, Regs& r) {
    r.acc[0] = r.y[0] = v.x, r.acc[1] = r.y[1] = v.y;
    r.acc[2] = r.y[2] = v.z, r.acc[3] = r.y[3] = v.w;
  }
  static __device__ __forceinline__ void step(Regs& r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r.acc[i] = fmaf(r.acc[i], kC1, kC2);
      r.y[i] = fmaf(r.y[i], kC2, kC1);
    }
  }
  static __device__ __forceinline__ float4 result(const Regs& r) {
    return make_float4(r.acc[0] + r.y[0], r.acc[1] + r.y[1], r.acc[2] + r.y[2], r.acc[3] + r.y[3]);
  }
};

// One float4's four elements as two packed bf16 pairs (rounded to nearest
// from f32): one HFMA2 per pair and stream.
struct ChainBf16 {
  struct Regs {
    __nv_bfloat162 acc[2], y[2];
  };
  static __device__ __forceinline__ void init(const float4& v, Regs& r) {
    r.acc[0] = r.y[0] = __float22bfloat162_rn(make_float2(v.x, v.y));
    r.acc[1] = r.y[1] = __float22bfloat162_rn(make_float2(v.z, v.w));
  }
  static __device__ __forceinline__ void step(Regs& r) {
    const __nv_bfloat162 c1 = __float2bfloat162_rn(kC1), c2 = __float2bfloat162_rn(kC2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r.acc[i] = __hfma2(r.acc[i], c1, c2);
      r.y[i] = __hfma2(r.y[i], c2, c1);
    }
  }
  static __device__ __forceinline__ float4 result(const Regs& r) {
    const float2 a0 = __bfloat1622float2(r.acc[0]), y0 = __bfloat1622float2(r.y[0]);
    const float2 a1 = __bfloat1622float2(r.acc[1]), y1 = __bfloat1622float2(r.y[1]);
    return make_float4(a0.x + y0.x, a0.y + y0.y, a1.x + y1.x, a1.y + y1.y);
  }
};

// kReps > 0: exactly kReps steps, unrolled completely; kReps == 0: `reps`
// steps in unrolled chunks of kChainUnroll, then the remainder.
template <class Chain, int kReps>
__global__ void __launch_bounds__(kChainThreads)
fma_chain_kernel(const float4* __restrict__ x, float4* __restrict__ out, long long n4, int reps) {
  const long long stride = (long long)gridDim.x * kChainThreads;
  long long i = (long long)blockIdx.x * kChainThreads + threadIdx.x;
  float4 next = i < n4 ? __ldg(x + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (; i < n4; i += stride) {
    typename Chain::Regs r;
    Chain::init(next, r);
    if (i + stride < n4) next = __ldg(x + i + stride);
    if (kReps > 0) {
#pragma unroll
      for (int s = 0; s < kReps; ++s) Chain::step(r);
    } else {
      int s = 0;
      for (; s + kChainUnroll <= reps; s += kChainUnroll) {
#pragma unroll
        for (int u = 0; u < kChainUnroll; ++u) Chain::step(r);
      }
      for (; s < reps; ++s) Chain::step(r);
    }
    out[i] = Chain::result(r);
  }
}

// Above 48 KB of dynamic shared memory needs the opt-in, set once per
// device for the largest table (outside any graph capture: the wrappers'
// first call runs eagerly). *opted_in_device remembers the device.
template <typename Kernel>
cudaError_t opt_in_shared(Kernel kernel, int bytes, int* opted_in_device) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess && device != *opted_in_device) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc == cudaSuccess) *opted_in_device = device;
  }
  return rc;
}

// A persistent grid: per_sm CTAs on each SM of the current device, at most
// one per work item.
cudaError_t resident_grid(int per_sm, int items, int* grid) {
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *grid = sms * per_sm < items ? sms * per_sm : items;
  return rc;
}

// Sums the n_ctas partial tables of a read-modify-write probe into out.
cudaError_t reduce_partials(const long long* partial, long long* out, int n_ctas, int entries,
                            cudaStream_t stream) {
  rmw_rows_reduce_kernel<<<(entries + kReduceCols - 1) / kReduceCols, kLanes, 0, stream>>>(
      partial, out, n_ctas, entries);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).

int jrr_paged_gather_rmw(const int* pages, const int* idx, const float* table, float* out,
                         long long* partial, long long* dtab, int n_tiles, int table_rows,
                         int n_ctas, float table_limit, void* stream) {
  static int opted_in_device = -1;
  constexpr int kMaxBytes =
      (int)(kMaxTableRows * kLanes * (kRmwGroups * sizeof(long long) + sizeof(float)));
  cudaError_t rc = opt_in_shared(paged_gather_rmw_kernel, kMaxBytes, &opted_in_device);
  if (rc != cudaSuccess) return (int)rc;
  const int entries = table_rows * kLanes;
  const int bytes = (int)(entries * (kRmwGroups * sizeof(long long) + sizeof(float)));
  paged_gather_rmw_kernel<<<n_ctas, kLanes * kRmwGroups, bytes, (cudaStream_t)stream>>>(
      pages, idx, table, out, partial, n_tiles, table_rows, table_limit);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  return (int)reduce_partials(partial, dtab, n_ctas, entries, (cudaStream_t)stream);
}

int jrr_row_gather(const float* x, const int* index, float* out, int n_tiles, void* stream) {
  row_gather_kernel<<<n_tiles, kLanes, 0, (cudaStream_t)stream>>>(x, index, out);
  return (int)cudaGetLastError();
}

int jrr_dyn_slice(const int* pages, const float* table, float* out, int n_tiles, int table_rows,
                  void* stream) {
  int grid = 0;
  const cudaError_t rc = resident_grid(kSliceCtasPerSm, n_tiles, &grid);
  if (rc != cudaSuccess) return (int)rc;
  dyn_slice_kernel<<<grid, kSliceWarps * kWarp, 0, (cudaStream_t)stream>>>(
      pages, (const float4*)table, (float4*)out, n_tiles, table_rows);
  return (int)cudaGetLastError();
}

int jrr_lane_gather(const float* x, const int* il, float* out, int n_tiles, int zero_outside,
                    void* stream) {
  int grid = 0;
  const cudaError_t rc = resident_grid(kGatherCtasPerSm, n_tiles, &grid);
  if (rc != cudaSuccess) return (int)rc;
  lane_gather_kernel<<<grid, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const int4*)il, (float4*)out, n_tiles, zero_outside);
  return (int)cudaGetLastError();
}

int jrr_select_reduce(const float* x, const int* isub, float* out, int n_tiles, void* stream) {
  select_reduce_kernel<<<n_tiles, kLanes, 0, (cudaStream_t)stream>>>(x, isub, out);
  return (int)cudaGetLastError();
}

int jrr_rmw_rows(const int* pages, const float* x, long long* partial, long long* out,
                 int n_tiles, int table_rows, int n_ctas, float x_limit, void* stream) {
  static int opted_in_device = -1;
  cudaError_t rc = opt_in_shared(rmw_rows_kernel,
                                 (int)(kRmwGroups * kMaxTableRows * kLanes * sizeof(long long)),
                                 &opted_in_device);
  if (rc != cudaSuccess) return (int)rc;
  const int entries = table_rows * kLanes;
  rmw_rows_kernel<<<n_ctas, kLanes * kRmwGroups, kRmwGroups * entries * sizeof(long long),
                    (cudaStream_t)stream>>>(pages, x, partial, n_tiles, table_rows, x_limit);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  return (int)reduce_partials(partial, out, n_ctas, entries, (cudaStream_t)stream);
}

int jrr_elementwise(const float* x, float* out, long long n, void* stream) {
  const long long n4 = n / 4;
  const int grid = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  elementwise_kernel<<<grid > 0 ? grid : 1, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, n4);
  return (int)cudaGetLastError();
}

int jrr_fma_chain(const float* x, float* out, long long n, int reps, int bf16, void* stream) {
  const long long n4 = n / 4;
  int grid = 0;
  const cudaError_t rc =
      resident_grid(kChainCtasPerSm, (int)((n4 + kChainThreads - 1) / kChainThreads), &grid);
  if (rc != cudaSuccess) return (int)rc;
  void (*kernel)(const float4*, float4*, long long, int) =
      bf16 ? (reps == kChainProbeReps ? fma_chain_kernel<ChainBf16, kChainProbeReps>
                                      : fma_chain_kernel<ChainBf16, 0>)
           : (reps == kChainProbeReps ? fma_chain_kernel<ChainF32, kChainProbeReps>
                                      : fma_chain_kernel<ChainF32, 0>);
  kernel<<<grid, kChainThreads, 0, (cudaStream_t)stream>>>((const float4*)x, (float4*)out, n4, reps);
  return (int)cudaGetLastError();
}

}  // extern "C"
