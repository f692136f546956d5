// Kernel B: fused multiresolution hash-grid encode, forward.
//
// For each (point n, level l): clamp x to [0,1]³, find the lattice cell and
// the fractional position, choose trilinear (K = 8 corners) or Kuhn simplex
// (K = 4 vertices) by the level's flag, hash or densely index every corner,
// gather the F-wide table rows, and sum them by weight in fp32:
//
//   out[n, l, :] = Σ_k w[l, k, n] · table[idx[l, k, n], :]
//
// In the JAX package this is XLA, not Pallas: hashgrid._indices_weights_klm
// (:434) → hash_scatter.gather_rows_lmajor (:1367) → hashgrid._interp_ksum
// (:726), run once per level group. Here one launch covers every level of a
// mixed ("hybridc") encode. The kernel also stores each corner's flat index
// and weight level-major ([K_l, N] blocks, level l starting at kbase_l·N)
// for the backward, which scatters w·grad into the table with kernel A. The
// gathered [L, K, N, F] rows never exist.
//
// The arithmetic follows _indices_weights_klm operation by operation so the
// indices are bit-equal to the JAX ones: s = x·res rounded before the floor
// (no FMA contraction), ties in the simplex ranks broken with `>` on one
// side and `>=` on the other (:484-486), the spatial hash multiplied in
// uint32 with wraparound and masked to the level's power-of-two size.
//
// What bounds it: bytes, from the random row gathers (L·K·N rows of 4·F B,
// served largely by L2 on the coarse levels) and the stores of the saved
// index/weight streams; the index math is a few dozen integer operations
// per corner. One thread per (point, level), level-major, so a warp shares
// one level's mode and metadata and its points are neighbours along a ray.
//
// round_bf16 = 1 rounds every gathered value to bfloat16 before the sum —
// gather_rows_lmajor(cast="bfloat16") without a bf16 copy of the table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMeta = 6;  // per level: res, size, offset, hashed, K, kbase

__device__ __forceinline__ int32_t corner_index(int cx, int cy, int cz, int res,
                                                int size, int offset, int hashed) {
  cx = min(cx, res);
  cy = min(cy, res);
  cz = min(cz, res);
  if (hashed) {
    uint32_t h = ((uint32_t)cx * 1u) ^ ((uint32_t)cy * 2654435761u) ^
                 ((uint32_t)cz * 805459861u);
    return (int32_t)(h & ((uint32_t)size - 1u)) + offset;
  }
  int stride = res + 1;
  return cx + cy * stride + cz * stride * stride + offset;
}

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table, int64_t r, float* v) {
  if constexpr (F == 4) {
    float4 a = __ldg(reinterpret_cast<const float4*>(table) + r);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (F == 2) {
    float2 a = __ldg(reinterpret_cast<const float2*>(table) + r);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __ldg(table + r);
  }
}

template <int F>
__global__ void hashgrid_encode_kernel(const float* __restrict__ x,
                                       const float* __restrict__ table,
                                       const int32_t* __restrict__ meta,
                                       float* __restrict__ out,
                                       int32_t* __restrict__ idx_out,
                                       float* __restrict__ w_out,
                                       int64_t n_points, int n_levels, int round_bf16) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_points * n_levels) return;
  const int l = (int)(t / n_points);
  const int64_t n = t - (int64_t)l * n_points;
  const int32_t* m = meta + l * kMeta;
  const int res = m[0], size = m[1], offset = m[2], hashed = m[3], K = m[4];
  const int64_t base = (int64_t)m[5] * n_points;  // this level's [K, N] block

  const float resf = (float)res;
  int p[3];
  float fr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float xv = fminf(fmaxf(x[n * 3 + a], 0.0f), 1.0f);
    float s = __fmul_rn(xv, resf);
    int pi = (int)floorf(s);
    pi = min(max(pi, 0), res - 1);
    p[a] = pi;
    fr[a] = __fsub_rn(s, (float)pi);
  }
  const float fx = fr[0], fy = fr[1], fz = fr[2];

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

  auto visit = [&](int k, int cx, int cy, int cz, float w) {
    int32_t r = corner_index(cx, cy, cz, res, size, offset, hashed);
    float v[F];
    load_row<F>(table, r, v);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float tv = round_bf16 ? __bfloat162float(__float2bfloat16_rn(v[f])) : v[f];
      acc[f] = __fadd_rn(acc[f], __fmul_rn(tv, w));
    }
    idx_out[base + k * n_points + n] = r;
    w_out[base + k * n_points + n] = w;
  };

  if (K == 4) {
    // Descending rank of each axis' frac, ties broken by axis index.
    const int rx = (fy > fx) + (fz > fx);
    const int ry = (fx >= fy) + (fz > fy);
    const int rz = (fx >= fz) + (fy >= fz);
    const float s1 = fmaxf(fx, fmaxf(fy, fz));
    const float s3 = fminf(fx, fminf(fy, fz));
    const float s2 = __fsub_rn(__fsub_rn(__fadd_rn(__fadd_rn(fx, fy), fz), s1), s3);
    const float w4[4] = {__fsub_rn(1.0f, s1), __fsub_rn(s1, s2), __fsub_rn(s2, s3), s3};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      visit(k, p[0] + (rx < k), p[1] + (ry < k), p[2] + (rz < k), w4[k]);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
      const float wx = bx ? fx : __fsub_rn(1.0f, fx);
      const float wy = by ? fy : __fsub_rn(1.0f, fy);
      const float wz = bz ? fz : __fsub_rn(1.0f, fz);
      visit(c, p[0] + bx, p[1] + by, p[2] + bz, __fmul_rn(__fmul_rn(wx, wy), wz));
    }
  }

  float* o = out + (n * n_levels + l) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = acc[f];
}

}  // namespace

// Returns a cudaError_t code (0 = launched).
//   x       fp32 [n_points, 3] contiguous
//   table   fp32 [rows, f] contiguous (16-byte aligned for f = 4, 8 for f = 2)
//   meta    int32 [n_levels, 6] on the device
//   out     fp32 [n_points, n_levels, f]
//   idx_out int32 [Σ_l K_l · n_points]; w_out fp32, same shape
extern "C" int avr_hashgrid_encode(const void* x, const void* table, const void* meta,
                                   void* out, void* idx_out, void* w_out,
                                   long long n_points, int n_levels, int f,
                                   int round_bf16, void* stream) {
  const long long total = n_points * (long long)n_levels;
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(table);
  const int32_t* mp = static_cast<const int32_t*>(meta);
  float* op = static_cast<float*>(out);
  int32_t* ip = static_cast<int32_t*>(idx_out);
  float* wp = static_cast<float*>(w_out);
  switch (f) {
    case 1:
      hashgrid_encode_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(
          xp, tp, mp, op, ip, wp, n_points, n_levels, round_bf16);
      break;
    case 2:
      hashgrid_encode_kernel<2><<<(unsigned)blocks, threads, 0, s>>>(
          xp, tp, mp, op, ip, wp, n_points, n_levels, round_bf16);
      break;
    case 4:
      hashgrid_encode_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(
          xp, tp, mp, op, ip, wp, n_points, n_levels, round_bf16);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
