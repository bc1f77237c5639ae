// Bitonic (dist, id) sort and merge kernel for Hopper (sm_90a).
//
// Replaces the two users of the Pallas launcher
// src/repro/kernels/topk/kernel.py `_launch_rows`:
//   * `bitonic_sort`  (body `_bitonic_body`): the full network,
//     k = 1..log2 M, j = k-1..0;
//   * `bitonic_merge` (body `_merge_body` -> `merge_network`): only the
//     last log2 M stages, k = log2 M, which sort a row that is already
//     bitonic (the caller builds it as A ++ filler ++ reversed(B)).
// One kernel serves both, selected by `merge_only`. Each row of (B, M)
// sorts ascending by (dist, id) lexicographically; an optional i32
// payload lane is permuted alongside (the engine's `expanded` flags).
//
// What bounds it on this card: neither bytes nor operations, but
// latency. A row is tiny (M = 16 for the proposals, 64 for the merge on
// the engine's main path), so the whole launch moves a few hundred KiB
// and does a few hundred thousand compares; what costs is the chain of
// log2 M * (log2 M + 1) / 2 dependent stages, each ended by a block
// barrier.
//
// Design: M/2 threads per row, one compare-exchange pair per thread per
// stage, keys and payload in shared memory. Rows are small, so a block
// packs several rows (up to 256 threads) to keep warps full; all rows
// of a block step through the same stage schedule between barriers.
// The comparison is `_cmp_exchange`'s rule applied per element exactly
// as the reference writes it — partner_less = dp < d || (dp == d &&
// ip < i); an element takes its partner's entry iff (ascending ==
// is_lower) ? partner_less : !partner_less — so the kernel reproduces
// the reference network bit for bit, including on exact (dist, id)
// ties. There is no arithmetic to round.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__global__ void bitonic_kernel(const float* __restrict__ din,
                               const int* __restrict__ iin,
                               const int* __restrict__ pin,
                               float* __restrict__ dout,
                               int* __restrict__ iout,
                               int* __restrict__ pout,
                               int B, int M, int log2m, int rows_per_block,
                               int merge_only) {
  extern __shared__ float smem[];
  const int half = M > 1 ? M / 2 : 1;
  const int local_row = threadIdx.x / half;
  const int lane = threadIdx.x - local_row * half;
  const long row = static_cast<long>(blockIdx.x) * rows_per_block + local_row;
  const bool active = row < B;
  const bool has_pay = pin != nullptr;

  float* sd = smem + local_row * M;
  int* si = reinterpret_cast<int*>(smem + rows_per_block * M) + local_row * M;
  int* sp = reinterpret_cast<int*>(smem + 2 * rows_per_block * M) + local_row * M;

  if (active) {
    for (int e = lane; e < M; e += half) {
      sd[e] = din[row * M + e];
      si[e] = iin[row * M + e];
      if (has_pay) sp[e] = pin[row * M + e];
    }
  }
  __syncthreads();

  for (int k = merge_only ? log2m : 1; k <= log2m; ++k) {
    for (int j = k - 1; j >= 0; --j) {
      const int stride = 1 << j;
      const int lo = ((lane >> j) << (j + 1)) | (lane & (stride - 1));
      const int hi = lo | stride;
      if (active) {
        const float d_lo = sd[lo], d_hi = sd[hi];
        const int i_lo = si[lo], i_hi = si[hi];
        const bool asc = (lo & (1 << k)) == 0;  // bit k is shared by lo, hi
        const bool less_lo = lex_less(d_hi, i_hi, d_lo, i_lo);  // lo's partner_less
        const bool less_hi = lex_less(d_lo, i_lo, d_hi, i_hi);  // hi's partner_less
        const bool take_lo = asc ? less_lo : !less_lo;          // lo: is_lower
        const bool take_hi = asc ? !less_hi : less_hi;          // hi: !is_lower
        sd[lo] = take_lo ? d_hi : d_lo;
        si[lo] = take_lo ? i_hi : i_lo;
        sd[hi] = take_hi ? d_lo : d_hi;
        si[hi] = take_hi ? i_lo : i_hi;
        if (has_pay) {
          const int p_lo = sp[lo], p_hi = sp[hi];
          sp[lo] = take_lo ? p_hi : p_lo;
          sp[hi] = take_hi ? p_lo : p_hi;
        }
      }
      __syncthreads();
    }
  }

  if (active) {
    for (int e = lane; e < M; e += half) {
      dout[row * M + e] = sd[e];
      iout[row * M + e] = si[e];
      if (has_pay) pout[row * M + e] = sp[e];
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. `pin`/`pout` are null without a
// payload lane. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() right after the launch.
extern "C" int bitonic_launch(const float* din, const int* iin, const int* pin,
                              float* dout, int* iout, int* pout, int B, int M,
                              int log2m, int rows_per_block, int merge_only,
                              void* stream) {
  const int half = M > 1 ? M / 2 : 1;
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(3) * rows_per_block * M * sizeof(float);
  bitonic_kernel<<<blocks, rows_per_block * half, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      din, iin, pin, dout, iout, pout, B, M, log2m, rows_per_block, merge_only);
  return static_cast<int>(cudaGetLastError());
}
