// Hash-grid corner indices and weights, shared by the encode forward and its
// backward (hashgrid_encode.cu, hashgrid_encode_bwd.cu) so that the two can
// never disagree on a corner.
//
// The arithmetic follows hashgrid._indices_weights_klm (:434) of the JAX
// package operation by operation, so the indices are bit-equal to the JAX
// ones: s = x·res rounded before the floor (no FMA contraction), ties in the
// simplex ranks broken with `>` on one side and `>=` on the other (:484-486),
// the spatial hash multiplied in uint32 with wraparound and masked to the
// level's power-of-two size.
//
// Both kernels tile the work the same way: a block takes kTilePoints
// consecutive points and a group of kLevelsPerBlock consecutive levels, one
// warp per level. A warp is then 32 consecutive points of one level (at the
// flagship, one ray's 32 shells), so the level's metadata and mode are
// warp-uniform. The grid runs the point tiles of one level group before the
// next group, so the rows that the blocks in flight touch are those of two
// levels (8 MB at the flagship). A tile of every level, whole point rows,
// would put all of them in flight: 75 MB against the H100's 50 MB L2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avr {

constexpr int kTilePoints = 32;     // points per block: one per lane
constexpr int kLevelsPerBlock = 2;  // levels per block: one warp each
constexpr int kMaxLevels = 64;
constexpr int kMetaInts = 5;  // per level, as the host passes them: res, size, offset, hashed, K

struct Level {
  int res, size, offset, hashed, K;
};

// Passed by value as a kernel parameter: a warp reads its level's entry
// from the constant bank with a warp-uniform index.
struct Levels {
  int n;
  Level lv[kMaxLevels];
};

// Host side: meta int32 [n, kMetaInts] → Levels. Returns false if n is out of range.
inline bool levels_from_meta(const int* meta, int n, Levels* out) {
  if (n <= 0 || n > kMaxLevels) return false;
  out->n = n;
  for (int l = 0; l < n; ++l) {
    const int* m = meta + l * kMetaInts;
    out->lv[l] = Level{m[0], m[1], m[2], m[3], m[4]};
  }
  return true;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int32_t corner_row(int cx, int cy, int cz, const Level& L) {
  cx = min(cx, L.res);
  cy = min(cy, L.res);
  cz = min(cz, L.res);
  if (L.hashed) {
    uint32_t h = ((uint32_t)cx * 1u) ^ ((uint32_t)cy * 2654435761u) ^
                 ((uint32_t)cz * 805459861u);
    return (int32_t)(h & ((uint32_t)L.size - 1u)) + L.offset;
  }
  const int stride = L.res + 1;
  return cx + cy * stride + cz * stride * stride + L.offset;
}

// Calls visit(k, row, w) for every corner k = 0 .. K-1 of point xyz on level
// L, in the JAX package's corner order: trilinear corner bit d = (k >> d) & 1,
// simplex vertices in descending order of the fractional coordinates.
template <class Visit>
__device__ __forceinline__ void for_each_corner(const Level& L, const float* xyz, Visit&& visit) {
  const float resf = (float)L.res;
  int p[3];
  float fr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xv = fminf(fmaxf(xyz[a], 0.0f), 1.0f);
    const float s = __fmul_rn(xv, resf);
    int pi = (int)floorf(s);
    pi = min(max(pi, 0), L.res - 1);
    p[a] = pi;
    fr[a] = __fsub_rn(s, (float)pi);
  }
  const float fx = fr[0], fy = fr[1], fz = fr[2];
  if (L.K == 4) {
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
      visit(k, corner_row(p[0] + (rx < k), p[1] + (ry < k), p[2] + (rz < k), L), w4[k]);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
      const float wx = bx ? fx : __fsub_rn(1.0f, fx);
      const float wy = by ? fy : __fsub_rn(1.0f, fy);
      const float wz = bz ? fz : __fsub_rn(1.0f, fz);
      visit(c, corner_row(p[0] + bx, p[1] + by, p[2] + bz, L),
            __fmul_rn(__fmul_rn(wx, wy), wz));
    }
  }
}

// Shared-memory layout of a block's tile: the x of its points, then one
// [points, levels·F] row per point (levels = those of the block's group),
// padded by one word so that lanes writing their own point's row hit
// distinct banks.
__host__ __device__ __forceinline__ int tile_row_stride(int g_levels, int f) {
  return g_levels * f + 1;
}

__host__ __device__ __forceinline__ size_t tile_smem_bytes(int f) {
  return sizeof(float) * (3 * kTilePoints + kTilePoints * tile_row_stride(kLevelsPerBlock, f));
}

// The grid of either kernel: point tiles along x, level groups along y.
__host__ __forceinline__ dim3 tile_grid(long long n_points, int n_levels) {
  return dim3((unsigned)((n_points + kTilePoints - 1) / kTilePoints),
              (unsigned)((n_levels + kLevelsPerBlock - 1) / kLevelsPerBlock));
}

}  // namespace avr
