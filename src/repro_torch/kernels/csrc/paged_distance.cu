// Paged SiN distance kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/distance/kernel.py:40
// `paged_distances` (body `_distance_kernel`): for every tile t,
//     out[t] = (qq[t][:, None] - 2 * q[t] . page[page_ids[t]]^T)
//              + vnorm[page_ids[t]][None, :]
// accumulated in f32. Shapes: page_ids (T,) i32, q (T, QB, d) f32 or
// bf16, qq (T, QB) f32, db (NP, P, d) f32 or bf16, vnorm (NP, P) f32 ->
// out (T, QB, P) f32. Each of the four (q, db) type pairs is one
// instantiation of the kernel template, with its own C entry point.
//
// What bounds it on this card: bytes and operations about equally. At
// the search path's shape (T 4320, QB 8, P 64, d 128) the query tiles,
// the distinct pages and the output are 35 MB (10.5 us at 3.35 TB/s)
// and the products are 0.57 GFLOP (8.5 us at the f32 FMA peak of
// 67 TFLOP/s). So the design must keep the FMA pipes fed from shared
// memory and read each byte from HBM about once.
//
// Design:
// - Page runs. Block b walks `group` consecutive tiles. Tiles with the
//   same page are one run: their QB-row query tiles are consecutive rows
//   of q and of out, so a run is one flat block of run_len * QB query
//   rows against one page. The page is staged into shared memory only
//   when it differs from the one already there (the dispatcher sorts
//   tiles by page, about 17 tiles per page on the search path, so a
//   page is staged about once per block, not once per tile). Any page
//   order is correct: an unsorted id list just gives runs of one tile.
//   The wrapper sizes `group` so that one wave of the card holds every
//   block (11 tiles per block on the search path: 393 blocks, 3 per SM).
// - Staging with cp.async, 16 bytes per copy (4 when d % 4 != 0 or a
//   pointer is not 16-byte aligned), one warp per row, no divides. Rows
//   are padded to a pitch p with p / 4 odd, so that 16-byte reads of 8
//   neighbouring rows fall in distinct banks. The whole d is staged when
//   the page plus kMQ query rows fit the shared memory the launch asks
//   for (P 64, d 128: 66 KiB, three blocks per SM, whose staging overlaps
//   each other's compute); otherwise d is walked in chunks (d 784) and
//   both are staged again for each chunk.
// - bf16 operands are upcast to f32 as they are staged (16-byte loads of
//   8 values when d % 8 == 0 and the pointers are aligned, else one value
//   per load), so shared memory, its pitch and the compute loop are the
//   f32 kernel's. The upcast is exact, so a bf16 launch gives the bits of
//   the f32 launch on q.float() and db.float(). The loads are plain,
//   not cp.async: a block waits for its bf16 staging.
// - Register blocking. A chunk of at most kMQ = 64 flat query rows is
//   computed by 256 threads; a thread owns 2 page rows (r and r + P/2)
//   x 8 query rows, 16 accumulators: per 4 columns of d, 2 float4 of the
//   page and 8 of q (one address across the warp) for 64 FMAs. Tiles of
//   4 and 8 page rows were no faster on the card: what remains is the
//   staging, which a block does not overlap with its own compute.
// - Bits. Each output is one sequential __fmaf_rn chain over ascending
//   d from 0, and the result is (qq - 2 * dot) + vnorm: the same bits on
//   any input for any tiling, so the search path's counts do not depend
//   on the design. No tensor cores, no TF32: on integer-valued inputs
//   every step is exact.
//
// Registers and spills (nvcc -Xptxas -v, sm_90a, in chip_smoke.py's
// build phase): PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMQ = 64;      // flat query rows per compute chunk
constexpr int kQT = 8;       // query rows per thread
constexpr int kBlocksPerSM = 3;  // the wrapper's MAX_BLOCKS_PER_SM

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage columns [c0, c0 + w) of `rows` rows of src (row stride ld) into
// dst (row pitch `pitch`) as f32, zero-filling columns [w, w4). One warp
// per row; the caller waits (cp_async_wait_all) and synchronises.
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* src, long ld,
                                           int rows, int c0, int w, int w4,
                                           bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const float* s = src + r * ld + c0;
    float* o = dst + r * pitch;
    if (vec) {
      for (int c = 4 * lane; c < w; c += 128) cp_async16(o + c, s + c);
    } else {
      for (int c = lane; c < w4; c += 32) {
        if (c < w) cp_async4(o + c, s + c);
        else o[c] = 0.0f;
      }
    }
  }
}

// bf16 -> f32 is a 16-bit shift: of a 32-bit word holding two bf16
// values, element 0 is the low half.
__device__ __forceinline__ float4 upcast4(unsigned a, unsigned b) {
  return make_float4(__uint_as_float(a << 16),
                     __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16),
                     __uint_as_float(b & 0xffff0000u));
}

// The same for bf16 rows, upcast on the way: with `vec` (w % 8 == 0,
// 16-byte aligned rows) one 16-byte load of 8 values per lane and step.
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const __nv_bfloat16* src, long ld,
                                           int rows, int c0, int w, int w4,
                                           bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const __nv_bfloat16* s = src + r * ld + c0;
    float* o = dst + r * pitch;
    if (vec) {
      for (int c = 8 * lane; c < w; c += 256) {
        const uint4 u = *reinterpret_cast<const uint4*>(s + c);
        *reinterpret_cast<float4*>(o + c) = upcast4(u.x, u.y);
        *reinterpret_cast<float4*>(o + c + 4) = upcast4(u.z, u.w);
      }
    } else {
      for (int c = lane; c < w4; c += 32)
        o[c] = c < w ? __bfloat162float(s[c]) : 0.0f;
    }
  }
}

template <typename TQ, typename TD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
paged_distance_kernel(const int* __restrict__ page_ids,
                      const TQ* __restrict__ q,
                      const float* __restrict__ qq,
                      const TD* __restrict__ db,
                      const float* __restrict__ vnorm,
                      float* __restrict__ out, int T, int QB, int P, int d,
                      int NP, int dc, int group, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = 4 * ((dc / 4) | 1);
  const int NR = (P + 1) / 2;                 // row pairs: r and r + NR
  float* p_s = smem;                          // 2 NR x pitch
  float* q_s = smem + 2 * NR * pitch;         // kMQ x pitch
  const bool whole = dc >= d;                 // d staged in one chunk

  const int t_end = min(T, (blockIdx.x + 1) * group);
  int staged = -1;                            // page id held in p_s
  for (int t = blockIdx.x * group; t < t_end;) {
    int pid = page_ids[t];
    int t1 = t + 1;
    while (t1 < t_end && page_ids[t1] == pid) ++t1;
    pid = pid < 0 ? 0 : (pid >= NP ? NP - 1 : pid);
    const TD* page = db + static_cast<long>(pid) * P * d;
    const float* vn = vnorm + static_cast<long>(pid) * P;
    const long m_end = static_cast<long>(t1) * QB;

    for (long m0 = static_cast<long>(t) * QB; m0 < m_end; m0 += kMQ) {
      const int M = static_cast<int>(min(static_cast<long>(kMQ), m_end - m0));
      const int n_tasks = NR * ((M + kQT - 1) / kQT);
      for (int base = 0; base < n_tasks; base += kThreads) {
        const int task = base + threadIdx.x;
        const bool active = task < n_tasks;
        const int r = task % NR, qr = (task / NR) * kQT;
        float acc[2][kQT];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < kQT; ++j) acc[i][j] = 0.0f;

        for (int c0 = 0; c0 < d; c0 += dc) {
          const int w = min(dc, d - c0), w4 = (w + 3) & ~3;
          const bool new_page = !whole || staged != pid;
          const bool new_q = !whole || base == 0;
          if (new_page || new_q) {
            __syncthreads();    // every thread is done with the buffers
            if (new_page)
              stage_rows(p_s, pitch, page, d, P, c0, w, w4, vec);
            if (new_q) stage_rows(q_s, pitch, q + m0 * d, d, M, c0, w, w4,
                                  vec);
            cp_async_wait_all();
            __syncthreads();
            staged = whole ? pid : -1;
          }
          if (active) {
            const float* pa = p_s + r * pitch;
            const float* pb = p_s + (r + NR) * pitch;
            const float* qa = q_s + qr * pitch;
#pragma unroll 2
            for (int c = 0; c < w4; c += 4) {
              const float4 a = *reinterpret_cast<const float4*>(pa + c);
              const float4 b = *reinterpret_cast<const float4*>(pb + c);
#pragma unroll
              for (int j = 0; j < kQT; ++j) {
                const float4 x =
                    *reinterpret_cast<const float4*>(qa + j * pitch + c);
                acc[0][j] = __fmaf_rn(x.x, a.x, acc[0][j]);
                acc[0][j] = __fmaf_rn(x.y, a.y, acc[0][j]);
                acc[0][j] = __fmaf_rn(x.z, a.z, acc[0][j]);
                acc[0][j] = __fmaf_rn(x.w, a.w, acc[0][j]);
                acc[1][j] = __fmaf_rn(x.x, b.x, acc[1][j]);
                acc[1][j] = __fmaf_rn(x.y, b.y, acc[1][j]);
                acc[1][j] = __fmaf_rn(x.z, b.z, acc[1][j]);
                acc[1][j] = __fmaf_rn(x.w, b.w, acc[1][j]);
              }
            }
          }
        }

        if (active) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = r + i * NR;
            if (row >= P) continue;   // P odd: no partner row
            const float v = vn[row];
#pragma unroll
            for (int j = 0; j < kQT; ++j) {
              if (qr + j < M) {
                const long m = m0 + qr + j;
                // (qq - 2 * dot) + vnorm, in the reference's association
                const float x = __fsub_rn(qq[m], __fmul_rn(2.0f, acc[i][j]));
                out[m * P + row] = __fadd_rn(x, v);
              }
            }
          }
        }
      }
    }
    t = t1;
  }
}

// Shared memory of one block for page size P and d-chunk dc (the
// wrapper, kernels/distance/kernel.py, repeats this to choose dc).
size_t smem_bytes(int P, int dc) {
  const int pitch = 4 * ((dc / 4) | 1);
  return static_cast<size_t>(2 * ((P + 1) / 2) + kMQ) * pitch * sizeof(float);
}

template <typename TQ, typename TD>
int launch(const int* page_ids, const void* q, const float* qq,
           const void* db, const float* vnorm, float* out, int T, int QB,
           int P, int d, int NP, int dc, int group, int vec, void* stream) {
  const size_t smem = smem_bytes(P, dc);
  const cudaError_t err = cudaFuncSetAttribute(
      paged_distance_kernel<TQ, TD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = group > 0 ? (T + group - 1) / group : 0;
  paged_distance_kernel<TQ, TD><<<blocks, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      page_ids, static_cast<const TQ*>(q), qq, static_cast<const TD*>(db),
      vnorm, out, T, QB, P, d, NP, dc, group, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes, one per (q, db) type pair: each
// launches ceil(T / group) blocks on `stream` (the caller's current
// stream), allocates nothing, and returns the first CUDA error (setting
// the shared-memory attribute, or cudaGetLastError() right after the
// launch) so that a refused launch is reported. dc: the d-chunk, a
// multiple of 4 (>= d stages d whole); vec: 16-byte copies (d and the
// d-chunk a multiple of 16 bytes' worth of elements, q and db 16-byte
// aligned).
#define PAGED_DISTANCE_ENTRY(name, TQ, TD)                                 \
  extern "C" int name(const int* page_ids, const void* q, const float* qq, \
                      const void* db, const float* vnorm, float* out,      \
                      int T, int QB, int P, int d, int NP, int dc,         \
                      int group, int vec, void* stream) {                  \
    return launch<TQ, TD>(page_ids, q, qq, db, vnorm, out, T, QB, P, d,    \
                          NP, dc, group, vec, stream);                     \
  }

PAGED_DISTANCE_ENTRY(paged_distance_launch, float, float)
PAGED_DISTANCE_ENTRY(paged_distance_bf16q_launch, __nv_bfloat16, float)
PAGED_DISTANCE_ENTRY(paged_distance_bf16db_launch, float, __nv_bfloat16)
PAGED_DISTANCE_ENTRY(paged_distance_bf16q_bf16db_launch, __nv_bfloat16,
                     __nv_bfloat16)
