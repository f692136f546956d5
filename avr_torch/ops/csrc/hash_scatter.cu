// Kernel A: table-gradient scatter-add for the hash-grid encodings.
//
//   out[r, :] += upd[i, :]  for every i with idx[i] == r      (out zeroed by the caller)
//
// Replaces the Pallas kernel avr_tpu/ops/hash_scatter.py:_tile_kernel (:872),
// reached through scatter_add_rows (:114). The TPU design sorts the (index,
// row) stream and sums each table tile with exact one-hot matmuls because the
// TPU has no atomics. Hopper has fp32 atomics in L2 and in shared memory, and
// this kernel makes one pass over the stream.
//
// What bounds it: not the bytes (idx and upd read once, out written once) but
// the L2 atomics. Every row that reaches L2 costs one vector RED (an fp32
// atomicAdd that returns nothing; float4 / float2 on sm_90); an H100's L2
// serves some 60-70 G of them and 135-155 G fp32 adds a second (PERF.md), and
// REDs on one address serialise. The streams the encodings give are
// level-major ([K_l, N] per level, N over (batch, ray, shell)): at the dense
// coarse levels consecutive shells repeat a row and a few thousand rows take
// millions of updates; at the hashed levels nearly every update is a row of
// its own. So the design spends as few REDs as the stream allows:
//
//  1. A block owns a chunk of kChunk = 2048 consecutive stream rows. Each of
//     its threads loads kRows = 8 consecutive rows with 16-byte loads (int4
//     indices, float4 updates; scalar loads where the pointers are not
//     16-byte aligned or the stream ends), marked evict-first: the stream is
//     read once and the table rows in L2 are what the REDs need.
//  2. Runs of equal adjacent indices are folded before any atomic. Each
//     thread sums its own runs in registers; a segmented scan over the warp
//     (head flags and partial sums from __shfl_up_sync) joins the runs that
//     cross lanes. A run then costs one add at its destination, or one per
//     warp (256 rows) that it spans.
//  3. What fits is privatised in shared memory: if the span [lo, hi] of the
//     chunk's in-range indices fits a slab of kSlabBytes (the span of a
//     dense coarse level's chunk: 2,048 rows at F = 4), the runs are summed
//     there and the block flushes one vector RED per row whose sum is not 0
//     (adding 0 would change nothing). Shared fp32 atomics are
//     compare-and-swap loops on sm_90 (SASS ATOMS.CAST.SPIN), so the lanes of
//     a warp first group equal keys (__match_any_sync) and one lane adds each
//     group's sum. A slab block takes longer than a block that sends its runs
//     to L2; that pays only where blocks queue for the SMs, so the design
//     uses the slab when the grid holds more blocks than the device runs at
//     once, and else launches without shared memory. The slab and the
//     block's static shared memory (some 4 KB) fit the 48 KB a block gets
//     without an opt-in; a larger slab (80 KB) cost occupancy at F = 4 and
//     timed slower.
//  4. Everything else takes one vector RED per folded run. Rows whose index
//     lies outside [0, n_rows) are dropped, as the plain version
//     (scatter_add_rows_reference) drops them.
//
// The sum order changes from run to run (atomics).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;                  // consecutive stream rows per thread
constexpr int kChunk = kThreads * kRows;  // stream rows per block
constexpr int kWarps = kThreads / 32;
constexpr int kSlabBytes = 40960;
constexpr int kMaxDevices = 64;
constexpr int32_t kNone = -1;             // a dropped row
constexpr unsigned kAll = 0xffffffffu;

template <int F>
__host__ __device__ constexpr int slab_rows() { return kSlabBytes / (4 * F); }

template <int F>
__device__ __forceinline__ void red_row(float* __restrict__ out, int32_t r, const float* v) {
  float* p = out + (int64_t)r * F;
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// The warp's runs that end at one row position go to the slab with one add
// per distinct row: lanes with equal keys (__match_any_sync) leave their sums
// in the warp's staging area and the lowest of them adds the group's sum.
// Shared-memory fp32 atomics are compare-and-swap loops on sm_90 (SASS
// ATOMS.CAST.SPIN), so two lanes of one instruction on one address cost a
// retry; after the grouping no two lanes meet.
template <int F>
__device__ __forceinline__ void add_warp(float* slab, int32_t lo, float* stage, int lane, int32_t key,
                                         const float* v) {
  const unsigned peers = __match_any_sync(kAll, key);
#pragma unroll
  for (int f = 0; f < F; ++f) stage[lane * F + f] = v[f];
  __syncwarp();
  if (key != kNone && lane == __ffs(peers) - 1) {
    float sum[F];
#pragma unroll
    for (int f = 0; f < F; ++f) sum[f] = v[f];
    for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
      const int b = __ffs(m) - 1;
#pragma unroll
      for (int f = 0; f < F; ++f) sum[f] += stage[b * F + f];
    }
    float* p = slab + (key - lo) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(p + f, sum[f]);
  }
  __syncwarp();
}

template <int F>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const int32_t* __restrict__ idx, const float* __restrict__ upd,
                        float* __restrict__ out, int64_t m_rows, int64_t n_rows, int vec,
                        int use_slab) {
  extern __shared__ float4 slab4[];
  __shared__ int32_t warp_lo[kWarps], warp_hi[kWarps];
  __shared__ float stage_all[kWarps * 32 * F];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * kChunk + (int64_t)threadIdx.x * kRows;

  // 1. Load kRows consecutive rows; dropped rows get the key kNone.
  int32_t k[kRows];
  float u[kRows * F];
  if (vec && r0 + kRows <= m_rows) {
    const int4* ip = reinterpret_cast<const int4*>(idx + r0);
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const int4 a = __ldcs(ip + q);
      k[4 * q] = a.x, k[4 * q + 1] = a.y, k[4 * q + 2] = a.z, k[4 * q + 3] = a.w;
    }
    const float4* up = reinterpret_cast<const float4*>(upd + r0 * F);
#pragma unroll
    for (int q = 0; q < kRows * F / 4; ++q) {
      const float4 b = __ldcs(up + q);
      u[4 * q] = b.x, u[4 * q + 1] = b.y, u[4 * q + 2] = b.z, u[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const bool in = r0 + j < m_rows;
      k[j] = in ? __ldcs(idx + r0 + j) : kNone;
#pragma unroll
      for (int f = 0; f < F; ++f) u[j * F + f] = in ? __ldcs(upd + (r0 + j) * F + f) : 0.f;
    }
  }
  int32_t lo = 0x7fffffff, hi = -1;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (k[j] < 0 || k[j] >= n_rows) k[j] = kNone;
    if (k[j] != kNone) lo = min(lo, k[j]), hi = max(hi, k[j]);
  }

  // The chunk's span of in-range rows decides the slab (uniform over the block).
  lo = __reduce_min_sync(kAll, lo);
  hi = __reduce_max_sync(kAll, hi);
  if (lane == 0) warp_lo[warp] = lo, warp_hi[warp] = hi;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) lo = min(lo, warp_lo[w]), hi = max(hi, warp_hi[w]);
  if (hi < 0) return;  // no row of the chunk is in range
  const bool slab = use_slab && (int64_t)hi - lo + 1 <= slab_rows<F>();
  float* vals = reinterpret_cast<float*>(slab4);
  if (slab) {
    const int n4 = ((hi - lo + 1) * F + 3) / 4;
    for (int e = threadIdx.x; e < n4; e += kThreads) slab4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

  // 2. Fold runs. The thread's trailing run: its key, its sum, whether it
  // covers all kRows rows.
  const int32_t tail = k[kRows - 1];
  float s[F];
#pragma unroll
  for (int f = 0; f < F; ++f) s[f] = u[(kRows - 1) * F + f];
  bool full = true;
#pragma unroll
  for (int j = kRows - 2; j >= 0; --j) {
    full = full && k[j] == tail;
    if (full) {
#pragma unroll
      for (int f = 0; f < F; ++f) s[f] += u[j * F + f];
    }
  }
  // Segmented inclusive scan over the lanes: a segment goes on through a lane
  // that is one run with the key of the lane before. Afterwards s is the sum
  // of the run that ends at this lane's last row, from its start in the warp.
  const int32_t prev_tail = __shfl_up_sync(kAll, tail, 1);
  int head = lane == 0 || !(full && prev_tail == tail);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int head_up = __shfl_up_sync(kAll, head, d);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float up = __shfl_up_sync(kAll, s[f], d);
      if (lane >= d && !head) s[f] += up;
    }
    if (lane >= d) head |= head_up;
  }
  // A lane whose first row continues the run of the lane before starts from
  // that run's sum; a lane whose last run goes on into the next lane leaves
  // it to that lane.
  const int32_t next_head = __shfl_down_sync(kAll, k[0], 1);
  const bool joins = lane > 0 && k[0] == prev_tail;
  const bool goes_on = lane < 31 && next_head == tail;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float c = __shfl_up_sync(kAll, s[f], 1);
    acc[f] = joins ? c : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j > 0 && k[j] != k[j - 1]) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.f;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += u[j * F + f];
    const bool ends = j == kRows - 1 ? !goes_on : k[j] != k[j + 1];
    if (slab) {
      add_warp<F>(vals, lo, stage_all + warp * 32 * F, lane, ends ? k[j] : kNone, acc);
    } else if (ends && k[j] != kNone) {
      red_row<F>(out, k[j], acc);
    }
  }
  if (!slab) return;
  __syncthreads();

  // 3. Flush: one RED per touched row.
  for (int r = threadIdx.x; r <= hi - lo; r += kThreads) {
    float v[F];
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = vals[r * F + f], any = any || v[f] != 0.f;
    if (any) red_row<F>(out, lo + r, v);
  }
}

// Blocks of the width-F kernel with the slab that device dev holds at once,
// read once per device.
template <int F>
int resident_blocks(int dev, int* n) {
  static std::atomic<int> known[kMaxDevices];  // 0: not read yet
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (known[dev].load() == 0) {
    int sms, per_sm;
    int e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_add_rows_kernel<F>, kThreads,
                                                             kSlabBytes);
    if (e != cudaSuccess) return e;
    known[dev].store(sms * per_sm);
  }
  *n = known[dev].load();
  return cudaSuccess;
}

template <int F>
int launch(const int32_t* idx, const float* upd, float* out, long long m_rows, long long n_rows,
           cudaStream_t s) {
  const long long blocks = (m_rows + kChunk - 1) / kChunk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int dev, resident;
  int e = (int)cudaGetDevice(&dev);
  if (e == cudaSuccess) e = resident_blocks<F>(dev, &resident);
  if (e != cudaSuccess) return e;
  // The slab only where blocks queue for the SMs.
  const int use_slab = blocks > resident;
  const int vec = ((uintptr_t)idx % 16 == 0) && ((uintptr_t)upd % 16 == 0);
  scatter_add_rows_kernel<F><<<(unsigned)blocks, kThreads, use_slab ? kSlabBytes : 0, s>>>(
      idx, upd, out, m_rows, n_rows, vec, use_slab);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched). idx int32 [m_rows], upd fp32
// [m_rows, f] and out fp32 [n_rows, f] (zeroed), all contiguous, upd and out
// aligned to their row width.
extern "C" int avr_scatter_add_rows(const void* idx, const void* upd, void* out, long long m_rows,
                                    long long n_rows, int f, void* stream) {
  if (m_rows <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* up = static_cast<const float*>(upd);
  float* op = static_cast<float*>(out);
  switch (f) {
    case 1: return launch<1>(ip, up, op, m_rows, n_rows, s);
    case 2: return launch<2>(ip, up, op, m_rows, n_rows, s);
    case 4: return launch<4>(ip, up, op, m_rows, n_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The layout for feature width f: stream rows per block, slab rows, and the
// blocks with the slab that the current device holds at once (a launch with
// more blocks than that uses the slab). Returns a cudaError_t code, or -1 for
// a bad f.
extern "C" int avr_scatter_add_rows_layout(int f, long long* out3) {
  int dev, resident = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  switch (f) {
    case 1: e = resident_blocks<1>(dev, &resident); break;
    case 2: e = resident_blocks<2>(dev, &resident); break;
    case 4: e = resident_blocks<4>(dev, &resident); break;
    default: return -1;
  }
  out3[0] = kChunk;
  out3[1] = kSlabBytes / (4 * f);
  out3[2] = resident;
  return e;
}
