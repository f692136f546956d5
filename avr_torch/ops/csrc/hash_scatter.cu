// Kernel A: table-gradient scatter-add for the hash-grid encodings.
//
//   out[r, :] += upd[i, :]  for every i with idx[i] == r      (out zeroed by the caller)
//
// Replaces the Pallas kernel avr_tpu/ops/hash_scatter.py:_tile_kernel (:872),
// reached through scatter_add_rows (:114) and the gather VJPs
// (_gather_lmaj_bwd :1489). The TPU design sorts the (index, row) stream and
// sums each table tile with exact one-hot matmuls because the TPU has no
// atomics. Hopper has fast fp32 atomics in L2, so this is the tinycudann
// design the reference used: one pass over the stream, one thread per update
// row, and the row added into the table with fp32 atomics that return
// nothing (RED). For F = 4 and F = 2 that is one vector atomicAdd
// (float4 / float2, global memory, sm_90 and later; atomic per element),
// so a warp instruction covers 32 whole rows instead of 32 scattered words.
//
// What bounds it: bytes. Each row moves 4 B of index + 4·F B of update, and
// the table gradient (n_rows·F·4 B) is written once; the adds are free next
// to that. The catch is contention: the two dense coarse levels of the
// flagship put ~1.3M of the 9M updates onto a few thousand rows, and atomics
// on one address serialise in L2. Summation order differs from run to run.
//
// Rows whose index lies outside [0, n_rows) are dropped, as the plain
// version (scatter_add_rows_reference) drops them; the encode kernel only
// produces indices inside the table.

#include <cuda_runtime.h>
#include <stdint.h>

template <int F>
__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ upd,
                                        float* __restrict__ out,
                                        int64_t m_rows, int64_t n_rows) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m_rows) return;
  int64_t r = idx[i];
  if (r < 0 || r >= n_rows) return;
  float* o = out + r * F;
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(o), reinterpret_cast<const float4*>(upd)[i]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(o), reinterpret_cast<const float2*>(upd)[i]);
  } else {
    atomicAdd(o, upd[i]);
  }
}

// Returns a cudaError_t code (0 = launched). idx int32 [m_rows], upd fp32
// [m_rows, f] and out fp32 [n_rows, f] (zeroed), both contiguous and
// aligned to their row width.
extern "C" int avr_scatter_add_rows(const void* idx, const void* upd, void* out,
                                    long long m_rows, long long n_rows, int f,
                                    void* stream) {
  if (m_rows <= 0) return 0;
  const int threads = 256;
  const long long blocks = (m_rows + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* up = static_cast<const float*>(upd);
  float* op = static_cast<float*>(out);
  switch (f) {
    case 1:
      scatter_add_rows_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(ip, up, op, m_rows, n_rows);
      break;
    case 2:
      scatter_add_rows_kernel<2><<<(unsigned)blocks, threads, 0, s>>>(ip, up, op, m_rows, n_rows);
      break;
    case 4:
      scatter_add_rows_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(ip, up, op, m_rows, n_rows);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
