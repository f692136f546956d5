// Fused multiresolution hash-grid encode, forward.
//
// For each (point n, level l): clamp x to [0,1]³, find the lattice cell and
// the fractional position, choose trilinear (K = 8 corners) or Kuhn simplex
// (K = 4 vertices) by the level's flag, hash or densely index every corner
// (hashgrid_index.cuh), gather the F-wide table rows and sum them by weight:
//
//   out[n, l, :] = Σ_k w_k · table[row_k, :]          (k ascending, fp32 sum)
//
// In the JAX package this is XLA, not Pallas: hashgrid._indices_weights_klm
// (:434) → hash_scatter.gather_rows_lmajor (:1367) → hashgrid._interp_ksum
// (:726), run once per level group. Here one launch covers every level of a
// mixed ("hybridc") encode, and nothing but the output is stored: the
// backward (hashgrid_encode_bwd.cu) recomputes the corners from x with the
// same header, so the forward saves x alone.
//
// round_bf16 = 1 is the JAX package's bf16 compute on an fp32 table
// (gather_rows_lmajor casts the rows, _interp_ksum the weights):
//   out = bf16( Σ_k bf16( bf16(row_k) · bf16(w_k) ) )
// The product of two bf16 values is exact in fp32 and is then rounded; the
// sum is fp32, k ascending; the result is stored as fp32 holding a bf16 value.
//
// What bounds it: bytes, the random F-wide row gathers (K rows of 4·F B per
// point and level; the distinct rows once) and the [N, L, F] output; the
// index math is a few dozen integer operations per corner. The design:
// a block takes 32 points × 2 levels, one warp per level (hashgrid_index.cuh),
// and the grid runs one level group's point tiles before the next, so the
// rows in flight are those of two levels (4 MB each at the flagship) and
// stay in L2 while they are reused, as in a level-major order. Each warp
// stages its sums in shared memory and the block writes its [32, 2·F] tile
// as 2·F-float runs per point: whole sectors, consecutive threads on
// consecutive words, where a warp writing its own level's values would
// touch 32 sectors per store at a stride of L·F·4 bytes.
//
// A corners-only entry point (avr_hashgrid_corners) writes each corner's
// flat row and weight from the same header, level-major ([K_l, N] blocks,
// level l starting at N·Σ_{l'<l} K_{l'}). It exists so that the indices can
// be held bit-equal to the plain version on the card.

#include "hashgrid_index.cuh"

namespace {

using avr::kTilePoints;

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table, int32_t r, float* v) {
  if constexpr (F == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(table) + r);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(table) + r);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __ldg(table + r);
  }
}

template <int F, bool RB>
__global__ void hashgrid_encode_kernel(const float* __restrict__ x,
                                       const float* __restrict__ table,
                                       const avr::Levels lv,
                                       float* __restrict__ out,
                                       int64_t n_points) {
  extern __shared__ float smem[];
  float* xs = smem;                     // [32, 3]
  float* tile = smem + 3 * kTilePoints;  // [32, rs]
  constexpr int G = avr::kLevelsPerBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n0 = (int64_t)blockIdx.x * kTilePoints;
  const int l0 = blockIdx.y * G;
  const int np = (int)(n_points - n0 < kTilePoints ? n_points - n0 : kTilePoints);
  const int gl = min(G, lv.n - l0);  // levels of this group
  const int rs = avr::tile_row_stride(gl, F);

  for (int e = threadIdx.x; e < 3 * np; e += blockDim.x) xs[e] = x[n0 * 3 + e];
  __syncthreads();

  if (warp < gl && lane < np) {
    const avr::Level L = lv.lv[l0 + warp];
    float acc[F] = {};
    avr::for_each_corner(L, xs + 3 * lane, [&](int, int32_t r, float w) {
      float v[F];
      load_row<F>(table, r, v);
      const float wv = RB ? avr::bf16_round(w) : w;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float p = __fmul_rn(RB ? avr::bf16_round(v[f]) : v[f], wv);
        acc[f] = __fadd_rn(acc[f], RB ? avr::bf16_round(p) : p);
      }
    });
    float* t = tile + lane * rs + warp * F;
#pragma unroll
    for (int f = 0; f < F; ++f) t[f] = RB ? avr::bf16_round(acc[f]) : acc[f];
  }
  __syncthreads();

  const int row = gl * F;
  const int64_t point_stride = (int64_t)lv.n * F;
  float* o = out + n0 * point_stride + l0 * F;
  for (int e = threadIdx.x; e < np * row; e += blockDim.x) {
    const int i = e / row, j = e - i * row;
    o[i * point_stride + j] = tile[i * rs + j];
  }
}

__global__ void hashgrid_corners_kernel(const float* __restrict__ x, const avr::Levels lv,
                                        int32_t* __restrict__ idx_out,
                                        float* __restrict__ w_out, int64_t n_points) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_points * lv.n) return;
  const int l = (int)(t / n_points);
  const int64_t n = t - (int64_t)l * n_points;
  int kbase = 0;
  for (int i = 0; i < l; ++i) kbase += lv.lv[i].K;
  const int64_t base = (int64_t)kbase * n_points + n;
  const float xyz[3] = {x[n * 3], x[n * 3 + 1], x[n * 3 + 2]};
  const avr::Level L = lv.lv[l];
  avr::for_each_corner(L, xyz, [&](int k, int32_t r, float w) {
    idx_out[base + k * n_points] = r;
    w_out[base + k * n_points] = w;
  });
}

template <int F, bool RB>
void launch(const float* x, const float* table, const avr::Levels& lv, float* out,
            long long n_points, cudaStream_t s) {
  hashgrid_encode_kernel<F, RB>
      <<<avr::tile_grid(n_points, lv.n), 32 * avr::kLevelsPerBlock, avr::tile_smem_bytes(F), s>>>(
          x, table, lv, out, n_points);
}

}  // namespace

// Both entry points return a cudaError_t code (0 = launched).
//   x      fp32 [n_points, 3] contiguous
//   meta   int32 [n_levels, 5] in host memory: res, size, offset, hashed, K
//   table  fp32 [rows, f] contiguous, rows aligned to their width
//   out    fp32 [n_points, n_levels, f]
extern "C" int avr_hashgrid_encode(const void* x, const void* table, const int* meta,
                                   void* out, long long n_points, int n_levels, int f,
                                   int round_bf16, void* stream) {
  if (n_points <= 0) return 0;
  avr::Levels lv;
  if (!avr::levels_from_meta(meta, n_levels, &lv)) return (int)cudaErrorInvalidValue;
  if ((n_points + kTilePoints - 1) / kTilePoints > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(table);
  float* op = static_cast<float*>(out);
  const bool rb = round_bf16 != 0;
  switch (f) {
    case 1:
      rb ? launch<1, true>(xp, tp, lv, op, n_points, s)
         : launch<1, false>(xp, tp, lv, op, n_points, s);
      break;
    case 2:
      rb ? launch<2, true>(xp, tp, lv, op, n_points, s)
         : launch<2, false>(xp, tp, lv, op, n_points, s);
      break;
    case 4:
      rb ? launch<4, true>(xp, tp, lv, op, n_points, s)
         : launch<4, false>(xp, tp, lv, op, n_points, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

//   idx_out int32 [Σ_l K_l · n_points]; w_out fp32, same shape (level-major)
extern "C" int avr_hashgrid_corners(const void* x, const int* meta, void* idx_out, void* w_out,
                                    long long n_points, int n_levels, void* stream) {
  if (n_points <= 0) return 0;
  avr::Levels lv;
  if (!avr::levels_from_meta(meta, n_levels, &lv)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n_points * n_levels + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  hashgrid_corners_kernel<<<(unsigned)blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), lv, static_cast<int32_t*>(idx_out), static_cast<float*>(w_out),
      n_points);
  return (int)cudaGetLastError();
}
