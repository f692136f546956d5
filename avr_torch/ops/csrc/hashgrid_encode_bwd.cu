// Hash-grid encode, backward: the table gradient.
//
//   d_table[row_k(n, l), :] += w_k(n, l) · g[n, l, :]   for every point n, level l, corner k
//                                                        (d_table zeroed by the caller)
//
// Replaces, on the training path, what the Pallas kernel
// avr_tpu/ops/hash_scatter.py:_tile_kernel (:872) computes inside the gather
// VJP (_gather_lmaj_bwd :1489): the VJP of _interp_ksum forms the per-corner
// updates w·g and the sorted scatter sums them into the table. The TPU sorts
// the update stream and sums each table tile with exact one-hot matmuls
// because it has no atomics. Here nothing is stored between the passes: each
// thread recomputes its corners and weights from x with the forward's header
// (hashgrid_index.cuh), forms w·g in registers and adds each row into the
// table gradient with one vector RED (fp32 atomicAdd that returns nothing;
// float4 / float2 on sm_90). The [M, F] update stream, the pass that filled
// it and the saved corner streams of the forward are gone.
//
// round_bf16 = 1 is the VJP of the JAX package's bf16 compute: the cotangent
// is bf16 and the corner update is bf16(bf16(g) · bf16(w)), summed in fp32.
//
// What bounds it: bytes (x, g, and the table gradient written once); the
// catch is contention. Where lanes of a warp hit the same row (the coarse
// levels, where a ray's 32 shells share a few cells), the warp combines them
// before the atomic: __match_any_sync groups equal rows, each lane leaves its
// update in shared memory, and the lowest lane of each group sums the group
// and issues one RED for it. The dense levels aggregate, which halves their
// time; the hashed ones issue one RED per lane, since aggregating them did
// not time faster beyond the run-to-run spread. The block tile and the
// level-group-major grid are the forward's, so the gradient rows in flight
// are those of two levels. Summation order changes from run to run (atomics).
//
// Trials (population training): g is [K, N, L, F] and d_table K gradients of
// table_rows rows each, one after another. Each thread computes its corners,
// weights and (on the dense levels) its warp's groups of equal rows once, and
// loops over the trials: per trial it stages that trial's slice of g and
// issues its REDs into that trial's gradient. For K = 1 the launch, its grid
// and its updates are those of a single table.

#include "hashgrid_index.cuh"

namespace {

using avr::kTilePoints;

template <int F>
__device__ __forceinline__ void red_row(float* __restrict__ d_table, int32_t r, const float* u) {
  float* p = d_table + (int64_t)r * F;
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(u[0], u[1], u[2], u[3]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(u[0], u[1]));
  } else {
    atomicAdd(p, u[0]);
  }
}

template <int F, bool RB>
__global__ void hashgrid_encode_bwd_kernel(const float* __restrict__ x,
                                           const float* __restrict__ g,
                                           const avr::Levels lv,
                                           float* __restrict__ d_table,
                                           int64_t n_points, int n_trials, int64_t table_rows) {
  extern __shared__ float smem[];
  float* xs = smem;                   // [32, 3]
  float* gt = smem + 3 * kTilePoints;  // [32, rs]: g, then each lane's update
  constexpr int G = avr::kLevelsPerBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n0 = (int64_t)blockIdx.x * kTilePoints;
  const int l0 = blockIdx.y * G;
  const int np = (int)(n_points - n0 < kTilePoints ? n_points - n0 : kTilePoints);
  const int gl = min(G, lv.n - l0);
  const int rs = avr::tile_row_stride(gl, F);

  for (int e = threadIdx.x; e < 3 * np; e += blockDim.x) xs[e] = x[n0 * 3 + e];
  __syncthreads();

  // Whole warps only (the matching below needs all 32 lanes): warps past
  // the group's levels do no work but stay for the block's barriers.
  const bool in_group = warp < gl;
  const bool valid = in_group && lane < np;
  bool aggregate = false;  // warp-uniform
  int nk = 0;
  int32_t rows[8];
  float ws[8];
  unsigned peers[8];
  if (in_group) {
    const avr::Level L = lv.lv[l0 + warp];
    nk = L.K;
    aggregate = !L.hashed;
    avr::for_each_corner(L, xs + 3 * (valid ? lane : 0), [&](int k, int32_t r, float w) {
      rows[k] = r;
      ws[k] = RB ? avr::bf16_round(w) : w;
      if (aggregate) peers[k] = __match_any_sync(0xffffffffu, valid ? r : -1);
    });
  }

  // The tile's [np, gl·F] slice of g, trial by trial.
  const int row = gl * F;
  const int64_t point_stride = (int64_t)lv.n * F;
  float* slot = gt + (valid ? lane : 0) * rs + warp * F;  // this lane's column of the tile
  for (int t = 0; t < n_trials; ++t) {
    const float* gs = g + ((int64_t)t * n_points + n0) * point_stride + l0 * F;
    for (int e = threadIdx.x; e < np * row; e += blockDim.x) {
      const int i = e / row, j = e - i * row;
      gt[i * rs + j] = gs[i * point_stride + j];
    }
    __syncthreads();
    if (in_group) {
      float* dt = d_table + (int64_t)t * table_rows * F;
      float gv[F];
#pragma unroll
      for (int f = 0; f < F; ++f) gv[f] = valid ? (RB ? avr::bf16_round(slot[f]) : slot[f]) : 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= nk) continue;
        float u[F];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float p = __fmul_rn(gv[f], ws[k]);
          u[f] = RB ? avr::bf16_round(p) : p;
        }
        if (!aggregate) {
          if (valid) red_row<F>(dt, rows[k], u);
          continue;
        }
        __syncwarp();  // the previous corner's sums have read every slot
        if (valid) {
#pragma unroll
          for (int f = 0; f < F; ++f) slot[f] = u[f];
        }
        __syncwarp();
        if (valid && lane == __ffs(peers[k]) - 1) {
#pragma unroll
          for (int f = 0; f < F; ++f) u[f] = 0.0f;
          for (unsigned m = peers[k]; m; m &= m - 1) {
            const float* s = gt + (__ffs(m) - 1) * rs + warp * F;
#pragma unroll
            for (int f = 0; f < F; ++f) u[f] += s[f];
          }
          red_row<F>(dt, rows[k], u);
        }
      }
    }
    __syncthreads();  // every slot is read before the next trial's g lands
  }
}

template <int F, bool RB>
void launch(const float* x, const float* g, const avr::Levels& lv, float* d_table,
            long long n_points, int n_trials, long long table_rows, cudaStream_t s) {
  hashgrid_encode_bwd_kernel<F, RB>
      <<<avr::tile_grid(n_points, lv.n), 32 * avr::kLevelsPerBlock, avr::tile_smem_bytes(F), s>>>(
          x, g, lv, d_table, n_points, n_trials, table_rows);
}

}  // namespace

// Returns a cudaError_t code (0 = launched).
//   x        fp32 [n_points, 3] contiguous
//   g        fp32 [n_trials, n_points, n_levels, f] contiguous (the encode output's cotangent)
//   meta     int32 [n_levels, 5] in host memory: res, size, offset, hashed, K
//   d_table  fp32 [n_trials, table_rows, f], zeroed, rows aligned to their width
extern "C" int avr_hashgrid_encode_bwd(const void* x, const void* g, const int* meta,
                                       void* d_table, long long n_points, int n_levels, int f,
                                       int round_bf16, int n_trials, long long table_rows,
                                       void* stream) {
  if (n_points <= 0) return 0;
  if (n_trials <= 0 || table_rows <= 0) return (int)cudaErrorInvalidValue;
  avr::Levels lv;
  if (!avr::levels_from_meta(meta, n_levels, &lv)) return (int)cudaErrorInvalidValue;
  if ((n_points + kTilePoints - 1) / kTilePoints > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* dp = static_cast<float*>(d_table);
  const bool rb = round_bf16 != 0;
  switch (f) {
    case 1:
      rb ? launch<1, true>(xp, gp, lv, dp, n_points, n_trials, table_rows, s)
         : launch<1, false>(xp, gp, lv, dp, n_points, n_trials, table_rows, s);
      break;
    case 2:
      rb ? launch<2, true>(xp, gp, lv, dp, n_points, n_trials, table_rows, s)
         : launch<2, false>(xp, gp, lv, dp, n_points, n_trials, table_rows, s);
      break;
    case 4:
      rb ? launch<4, true>(xp, gp, lv, dp, n_points, n_trials, table_rows, s)
         : launch<4, false>(xp, gp, lv, dp, n_points, n_trials, table_rows, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
