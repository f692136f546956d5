// The MLPs' hidden-layer chain: the elementwise work between two matmuls.
//
// A hidden layer's matmul writes P [M, W] fp32, its rows laid out
// [K, B, R, C] (trial k, batch group b, ray r, shell c; q = r·C + c). The
// forward forms, in fp32 and in this order (each term present or not),
//
//   pre = ((P + (h_ray[k,r] + h_batch[k,b])) + bias[k]) + emb[k, ch[b]]
//
// and writes A = bf16(relu(pre)) and one mask
// bit per element, set where pre > 0 or pre is NaN: what torch's ReLU
// backward reads from its fp32 output. The backward takes the fp32
// cotangent g of A, writes g_pre = mask ? g : 0 in bf16 (or fp32) for the
// layer's two GEMMs, and sums g_pre in fp32: per (k, b) over the rows, from
// which a small second launch forms the bias gradient (over b), the
// embedding gradient (by channel) and the h_batch gradient; and per (k, r)
// over b and c, the h_ray gradient.
//
// No Pallas kernel did this. In the JAX package it is XLA's fusion of the
// adds, the ReLU and the convert around each `_matmul_cd`
// (avr_tpu/models/mlp.py). Eager PyTorch runs each add, the ReLU, the bf16
// cast, ReLU's backward, the two reductions and the cast of the cotangent
// as a pass of its own over an fp32 [M, W] tensor; the renderer also built
// the signal network's first-layer context h_ray + h_batch as a full
// [K, B, R, 1, W] tensor and accumulated its gradient once per chunk.
//
// What bounds it: bytes. The forward reads P (4 bytes an element) and
// writes A and the mask (2 + 1/8); the backward reads g and the mask and
// writes g_pre (2) and partial sums (4 / rows of a tile). The tables (bias,
// embeddings, context) are a few hundred kB and stay in L1/L2. The design:
//
// * A thread owns 8 consecutive elements of a row: two float4 loads, one
//   16-byte store of 8 bf16 values, one mask byte. W must be a multiple of 8.
// * Forward: one thread per 8 elements; the row is split into (k, b, r) by
//   two or three integer divisions. The tables are read by float4 where
//   their base is 16-byte aligned (a parameter may be a view at any offset
//   of a flat buffer), else by scalars.
// * Backward: a block of rpi × W/8 threads (rpi = 256 / (W/8)) owns a tile of
//   a (k, b) group; each thread sums its rows in registers, the block adds its
//   rpi sums in shared memory in a fixed order and writes one partial row per
//   (k, b, tile). Without the context a tile is rpi·nr rows, nr a thread.
//   With it a tile is whole rays, and a block loops over every b: the rpi
//   thread rows are G shell groups (G a power of two dividing rpi, at most C)
//   times rpi/G rays; a thread takes the shells c ≡ its group (mod G) of
//   NRAY rays and keeps each ray's sum over b and its shells in registers;
//   the G groups of a ray are added in shared memory. So any C works, and a
//   ray is never split across blocks.
//   The second launch adds the partials over the tiles in order. There are
//   no float atomics: a result repeats from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kSumLanes = 32;  // tile lanes of the sum kernel, 32 columns each

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void load8(const float* p, bool vec, float v[8]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ int64_t channel(const void* ch, int ch_i64, int b) {
  return ch_i64 ? static_cast<const int64_t*>(ch)[b] : (int64_t) static_cast<const int32_t*>(ch)[b];
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);  // a in the low half: the lower address
  return *reinterpret_cast<unsigned*>(&t);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// grid (units / 256), one thread per 8 elements; units = M·W/8 < 2^31.
__global__ void __launch_bounds__(kFwdThreads)
mlp_act_fwd_kernel(const float* __restrict__ p, const float* __restrict__ bias,
                   const float* __restrict__ emb, const void* __restrict__ ch, int ch_i64,
                   int ch_num, const float* __restrict__ h_ray, const float* __restrict__ h_batch,
                   __nv_bfloat16* __restrict__ out, uint8_t* __restrict__ mask, int units, int W, int B,
                   int R, int C) {
  const int u = blockIdx.x * kFwdThreads + threadIdx.x;
  if (u >= units) return;
  const int tw = W >> 3;
  const int m = u / tw;
  const int w0 = (u - m * tw) * 8;
  const int Q = R * C;
  const int kb = m / Q;
  const int q = m - kb * Q;
  const int k = kb / B;
  const int b = kb - k * B;

  float v[8];
  const float4* pr = reinterpret_cast<const float4*>(p + (int64_t)m * W + w0);
  const float4 a0 = __ldcs(pr), a1 = __ldcs(pr + 1);
  v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
  v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
  if (h_ray != nullptr) {
    float hr[8], hb[8];
    load8(h_ray + ((int64_t)k * R + q / C) * W + w0, aligned16(h_ray), hr);
    load8(h_batch + ((int64_t)k * B + b) * W + w0, aligned16(h_batch), hb);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], __fadd_rn(hr[i], hb[i]));
  }
  if (bias != nullptr) {
    float bb[8];
    load8(bias + (int64_t)k * W + w0, aligned16(bias), bb);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], bb[i]);
  }
  if (emb != nullptr) {
    const int64_t c = channel(ch, ch_i64, b);
    if (c < 0 || c >= ch_num) {  // a channel out of range reads as NaN, never as another row
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __int_as_float(0x7fc00000);
    } else {
      float e[8];
      load8(emb + ((int64_t)k * ch_num + c) * W + w0, aligned16(emb), e);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], e[i]);
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool keep = !(v[i] <= 0.0f);  // > 0, or NaN (which ReLU passes on)
    bits |= (unsigned)keep << i;
    v[i] = keep ? v[i] : 0.0f;
  }
  store8(out + (int64_t)m * W + w0, v);
  if (mask != nullptr) mask[u] = (uint8_t)bits;
}

// One row's 8 elements: g_pre = mask ? g : 0, stored, and added to the sums.
template <typename GT>
__device__ __forceinline__ void grad_row(const float* __restrict__ g,
                                         const uint8_t* __restrict__ mask, GT* __restrict__ gpre,
                                         int64_t m, int W, int tw, int cg, float cs[8],
                                         float* acc) {
  const float4* gr = reinterpret_cast<const float4*>(g + m * W + cg * 8);
  const float4 a0 = __ldcs(gr), a1 = __ldcs(gr + 1);
  const unsigned bits = __ldcs(mask + m * tw + cg);
  float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = (bits >> i) & 1u ? v[i] : 0.0f;
    cs[i] += v[i];
    if (acc != nullptr) acc[i] += v[i];
  }
  store8(gpre + m * W + cg * 8, v);
}

// grid (tiles, K, B / b_per_block); block rpi × W/8 threads; dynamic shared
// memory rpi·W floats. A tile is `units` units: rows (NRAY = 0; nr rows a
// thread, groups 1) or rays of C rows (NRAY > 0; nr = NRAY rays a thread,
// b_per_block = B, h_ray's gradient written to dray).
template <int NRAY, typename GT>
__global__ void __launch_bounds__(256)
mlp_act_bwd_kernel(const float* __restrict__ g, const uint8_t* __restrict__ mask,
                   GT* __restrict__ gpre, float* __restrict__ partial, float* __restrict__ dray,
                   int W, int B, int R, int C, int nr, int groups, int units, int n_tiles,
                   int b_per_block) {
  extern __shared__ float smem[];
  const int tw = W >> 3;
  const int rpi = blockDim.x / tw;
  const int cg = threadIdx.x % tw;
  const int s = threadIdx.x / tw;
  const int w0 = cg * 8;
  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int Q = R * C;
  const int u0 = tile * units;
  const int b_lo = blockIdx.z * b_per_block;
  const int b_hi = min(B, b_lo + b_per_block);
  const int sg = s % groups;        // the thread's shell group (0 without the context)
  const int per = rpi / groups;     // rays a round of the block's thread rows covers
  const int sr = s / groups;

  float ray[NRAY > 0 ? NRAY : 1][8];
#pragma unroll
  for (int j = 0; j < (NRAY > 0 ? NRAY : 1); ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) ray[j][i] = 0.0f;

  for (int b = b_lo; b < b_hi; ++b) {
    float cs[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const int64_t base = ((int64_t)k * B + b) * Q;
    if (NRAY > 0) {
#pragma unroll
      for (int j = 0; j < NRAY; ++j) {
        const int r = u0 + sr + j * per;
        if (r < R)
          for (int c = sg; c < C; c += groups)
            grad_row(g, mask, gpre, base + (int64_t)r * C + c, W, tw, cg, cs, ray[j]);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < nr; ++j) {
        const int q = u0 + s + j * rpi;
        if (q < Q) grad_row(g, mask, gpre, base + q, W, tw, cg, cs, nullptr);
      }
    }
    if (partial != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) smem[s * W + w0 + i] = cs[i];
      __syncthreads();
      if (s == 0) {
        for (int s2 = 1; s2 < rpi; ++s2)
#pragma unroll
          for (int i = 0; i < 8; ++i) cs[i] += smem[s2 * W + w0 + i];
        store8(partial + (((int64_t)k * B + b) * n_tiles + tile) * W + w0, cs);
      }
      __syncthreads();
    }
  }
  if (NRAY == 0) return;
#pragma unroll
  for (int j = 0; j < (NRAY > 0 ? NRAY : 1); ++j) {
    const int r = u0 + sr + j * per;
    if (groups == 1) {  // the thread holds the whole ray
      if (r < R) store8(dray + ((int64_t)k * R + r) * W + w0, ray[j]);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) smem[s * W + w0 + i] = ray[j][i];
    __syncthreads();
    if (sg == 0 && r < R) {  // the ray's groups in order
      for (int s2 = s + 1; s2 < s + groups; ++s2)
#pragma unroll
        for (int i = 0; i < 8; ++i) ray[j][i] += smem[s2 * W + w0 + i];
      store8(dray + ((int64_t)k * R + r) * W + w0, ray[j]);
    }
    __syncthreads();
  }
}

// grid (ceil(W / 32), K), 32 columns × kSumLanes lanes. For each (k, b): the
// partial rows added over the tiles (lane l takes tiles l, l + 32, ...; the
// lanes then in order), giving the h_batch gradient; their sum over b in
// order is the bias gradient, and by ch[b] the embedding gradient.
__global__ void __launch_bounds__(32 * kSumLanes)
mlp_act_sum_kernel(const float* __restrict__ partial, int n_tiles, int B, int W,
                   const void* __restrict__ ch, int ch_i64, int ch_num,
                   float* __restrict__ dbatch, float* __restrict__ dbias,
                   float* __restrict__ demb) {
  __shared__ float red[kSumLanes][33];
  const int tx = threadIdx.x & 31;
  const int lane = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  const int k = blockIdx.y;
  const bool live = col < W;
  const bool owner = lane == 0 && live;
  if (owner && demb != nullptr)
    for (int c = 0; c < ch_num; ++c) demb[((int64_t)k * ch_num + c) * W + col] = 0.0f;
  float bias_acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    float s = 0.0f;
    if (live) {
      const float* pp = partial + ((int64_t)k * B + b) * n_tiles * W + col;
      for (int t = lane; t < n_tiles; t += kSumLanes) s += pp[(int64_t)t * W];
    }
    red[lane][tx] = s;
    __syncthreads();
    if (owner) {
      float S = red[0][tx];
      for (int l = 1; l < kSumLanes; ++l) S += red[l][tx];
      if (dbatch != nullptr) dbatch[((int64_t)k * B + b) * W + col] = S;
      bias_acc += S;
      if (demb != nullptr) {
        const int64_t c = channel(ch, ch_i64, b);
        if (c >= 0 && c < ch_num) demb[((int64_t)k * ch_num + c) * W + col] += S;
      }
    }
    __syncthreads();
  }
  if (owner && dbias != nullptr) dbias[(int64_t)k * W + col] = bias_acc;
}

template <int NRAY, typename GT>
cudaError_t launch_bwd(dim3 grid, int threads, size_t smem, cudaStream_t s, const float* g,
                       const uint8_t* mask, void* gpre, float* partial, float* dray, int W, int B,
                       int R, int C, int nr, int groups, int units, int n_tiles, int b_per_block) {
  mlp_act_bwd_kernel<NRAY, GT><<<grid, threads, smem, s>>>(
      g, mask, static_cast<GT*>(gpre), partial, dray, W, B, R, C, nr, groups, units, n_tiles,
      b_per_block);
  return cudaGetLastError();
}

template <typename GT>
cudaError_t launch_bwd_nray(int nray, dim3 grid, int threads, size_t smem, cudaStream_t s,
                            const float* g, const uint8_t* mask, void* gpre, float* partial,
                            float* dray, int W, int B, int R, int C, int nr, int groups,
                            int units, int n_tiles, int b_per_block) {
  switch (nray) {
    case 0: return launch_bwd<0, GT>(grid, threads, smem, s, g, mask, gpre, partial, dray, W, B, R, C, nr, groups, units, n_tiles, b_per_block);
    case 1: return launch_bwd<1, GT>(grid, threads, smem, s, g, mask, gpre, partial, dray, W, B, R, C, nr, groups, units, n_tiles, b_per_block);
    case 2: return launch_bwd<2, GT>(grid, threads, smem, s, g, mask, gpre, partial, dray, W, B, R, C, nr, groups, units, n_tiles, b_per_block);
    case 4: return launch_bwd<4, GT>(grid, threads, smem, s, g, mask, gpre, partial, dray, W, B, R, C, nr, groups, units, n_tiles, b_per_block);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward. p [M, W] fp32 with M = K·B·R·C; bias [K, W], emb [K, ch_num, W],
// h_ray [K, R, W], h_batch [K, B, W] (each null or contiguous fp32; h_ray and
// h_batch together); ch [B] int32 or int64 (ch_i64). Writes out [M, W] bf16
// and, unless null, mask [M, W/8].
extern "C" int avr_mlp_act_fwd(const void* p, const void* bias, const void* emb, const void* ch,
                               int ch_i64, int ch_num, const void* h_ray, const void* h_batch,
                               void* out, void* mask, long long M, int W, int K, int B, int R, int C,
                               void* stream) {
  if (M <= 0) return 0;
  if (W <= 0 || W % 8 != 0 || K <= 0 || B <= 0 || R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)K * B * R * C != M || M * (W / 8) >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if ((h_ray == nullptr) != (h_batch == nullptr) || (emb != nullptr && ch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int units = (int)(M * (W / 8));
  const dim3 grid((units + kFwdThreads - 1) / kFwdThreads);
  mlp_act_fwd_kernel<<<grid, kFwdThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(bias), static_cast<const float*>(emb), ch,
      ch_i64, ch_num, static_cast<const float*>(h_ray), static_cast<const float*>(h_batch),
      static_cast<__nv_bfloat16*>(out), static_cast<uint8_t*>(mask), units, W, B, R, C);
  return (int)cudaGetLastError();
}

// Backward. g [M, W] fp32, mask [M, W/8] from the forward; writes gpre
// [M, W] (bf16, or fp32 with gpre_bf16 0) and, each unless null, dray
// [K, R, W] (nray > 0: nr = nray rays a thread, `groups` shell groups, one
// block over every b), dbatch [K, B, W], dbias [K, W] and demb
// [K, ch_num, W]. partial [K, B, n_tiles, W] is scratch, needed by any of
// dbatch, dbias, demb. A tile is `units` = (256 / (W/8))·nr rows, or
// (256 / (W/8) / groups)·nr rays; the caller picks nr, groups and b_per_block.
extern "C" int avr_mlp_act_bwd(const void* g, const void* mask, void* gpre, int gpre_bf16,
                               void* partial, void* dray, void* dbatch, void* dbias, void* demb,
                               const void* ch, int ch_i64, int ch_num, long long M, int W, int K,
                               int B, int R, int C, int nray, int nr, int groups, int units,
                               int n_tiles, int b_per_block, void* stream) {
  if (M <= 0) return 0;
  const int tw = W / 8;
  if (W <= 0 || W % 8 != 0 || tw > 256 || K <= 0 || B <= 0 || R <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const int rpi = 256 / tw;
  const int threads = rpi * tw;
  if ((long long)K * B * R * C != M || nr <= 0 || b_per_block <= 0 || groups <= 0 || rpi % groups != 0)
    return (int)cudaErrorInvalidValue;
  if ((dray != nullptr) != (nray > 0)) return (int)cudaErrorInvalidValue;
  if (nray > 0) {  // tiles of whole rays
    if (nr != nray || b_per_block < B || units != rpi / groups * nr || (long long)n_tiles * units < R)
      return (int)cudaErrorInvalidValue;
  } else if (groups != 1 || units != rpi * nr || (long long)n_tiles * units < (long long)R * C) {
    return (int)cudaErrorInvalidValue;
  }
  const bool sums = dbatch != nullptr || dbias != nullptr || demb != nullptr;
  if (sums && partial == nullptr) return (int)cudaErrorInvalidValue;
  if (demb != nullptr && ch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * W * rpi;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, K, (B + b_per_block - 1) / b_per_block);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  float* part = sums ? static_cast<float*>(partial) : nullptr;
  cudaError_t e = gpre_bf16
      ? launch_bwd_nray<__nv_bfloat16>(nray, grid, threads, smem, s, static_cast<const float*>(g),
                                       static_cast<const uint8_t*>(mask), gpre, part,
                                       static_cast<float*>(dray), W, B, R, C, nr, groups, units,
                                       n_tiles, b_per_block)
      : launch_bwd_nray<float>(nray, grid, threads, smem, s, static_cast<const float*>(g),
                               static_cast<const uint8_t*>(mask), gpre, part,
                               static_cast<float*>(dray), W, B, R, C, nr, groups, units, n_tiles,
                               b_per_block);
  if (e != cudaSuccess || !sums) return (int)e;
  mlp_act_sum_kernel<<<dim3((W + 31) / 32, K), 32 * kSumLanes, 0, s>>>(
      part, n_tiles, B, W, ch, ch_i64, ch_num, static_cast<float*>(dbatch),
      static_cast<float*>(dbias), static_cast<float*>(demb));
  return (int)cudaGetLastError();
}
