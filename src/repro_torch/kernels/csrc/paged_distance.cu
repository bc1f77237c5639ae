// Paged SiN distance kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/distance/kernel.py
// `paged_distances` (body `_distance_kernel`): for every tile t,
//     out[t] = qq[t][:, None] - 2 * q[t] . page[page_ids[t]]^T
//              + vnorm[page_ids[t]][None, :]
// accumulated in f32. Shapes: page_ids (T,) i32, q (T, QB, d) f32,
// qq (T, QB) f32, db (NP, P, d) f32, vnorm (NP, P) f32 -> out (T, QB, P).
//
// What bounds it on this card: memory. Each tile reads one page of
// P x d f32 (32 KiB at P = 64, d = 128) and QB x d query values, and
// does 2 * QB * P * d flops on them: at the engine's QB = 8 that is
// 4 flops per page byte, far below the ~20 flops per byte where the
// H100's f32 FMA rate (67 TFLOP/s) would take over from HBM
// (3.35 TB/s). A tile that repeats the previous tile's page (the
// dispatcher sorts tiles by page, as the paper's Allocator does) finds
// it in the 50 MB L2 instead of HBM — the analogue of the Pallas copy
// elision and the paper's pageLocBit page-buffer hit.
//
// Design: one thread block per tile. The block reads its own page id
// (there is no scalar prefetch on the GPU) and clamps it into the
// store (callers pass ids already in range). It stages the query tile and
// the page through shared memory in chunks of at most 32 columns of d
// (d is not assumed to be 128: a 784-wide page would not fit in shared
// memory whole), with rows padded by one word so that threads reading
// neighbouring page rows hit distinct banks. Each thread owns up to
// kOutPerThread (q, p) outputs and runs one sequential f32 FMA chain
// over d for each, then writes qq - 2 * dot + vnorm. No tensor cores,
// no TF32: on integer-valued inputs every step is exact, so the result
// is bit-identical to any other f32 evaluation order.
#include <cuda_runtime.h>

namespace {

constexpr int kOutPerThread = 4;

__global__ void paged_distance_kernel(const int* __restrict__ page_ids,
                                      const float* __restrict__ q,
                                      const float* __restrict__ qq,
                                      const float* __restrict__ db,
                                      const float* __restrict__ vnorm,
                                      float* __restrict__ out,
                                      int QB, int P, int d, int NP,
                                      int dchunk) {
  extern __shared__ float smem[];
  const int pitch = dchunk + 1;
  float* q_s = smem;               // QB x pitch
  float* p_s = smem + QB * pitch;  // P x pitch

  const long t = blockIdx.x;
  int pid = page_ids[t];
  pid = pid < 0 ? 0 : (pid >= NP ? NP - 1 : pid);
  const float* q_t = q + t * QB * d;
  const float* page = db + static_cast<long>(pid) * P * d;
  const int n_out = QB * P;

  for (int base = 0; base < n_out; base += blockDim.x * kOutPerThread) {
    float acc[kOutPerThread];
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) acc[k] = 0.0f;

    for (int c0 = 0; c0 < d; c0 += dchunk) {
      const int w = min(dchunk, d - c0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < QB * w; e += blockDim.x) {
        const int r = e / w, c = e - r * w;
        q_s[r * pitch + c] = q_t[static_cast<long>(r) * d + c0 + c];
      }
      for (int e = threadIdx.x; e < P * w; e += blockDim.x) {
        const int r = e / w, c = e - r * w;
        p_s[r * pitch + c] = page[static_cast<long>(r) * d + c0 + c];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kOutPerThread; ++k) {
        const int o = base + k * blockDim.x + threadIdx.x;
        if (o < n_out) {
          const float* a = q_s + (o / P) * pitch;
          const float* b = p_s + (o % P) * pitch;
          float s = acc[k];
          for (int c = 0; c < w; ++c) s = __fmaf_rn(a[c], b[c], s);
          acc[k] = s;
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) {
      const int o = base + k * blockDim.x + threadIdx.x;
      if (o < n_out) {
        const int qi = o / P, pi = o % P;
        // (qq - 2 * dot) + vnorm, in the reference's association order
        const float r = __fsub_rn(qq[t * QB + qi], __fmul_rn(2.0f, acc[k]));
        out[t * n_out + o] = __fadd_rn(r, vnorm[static_cast<long>(pid) * P + pi]);
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` (the caller's
// current stream), allocates nothing, and returns cudaGetLastError()
// right after the launch so that a refused launch is reported.
extern "C" int paged_distance_launch(const int* page_ids, const float* q,
                                     const float* qq, const float* db,
                                     const float* vnorm, float* out, int T,
                                     int QB, int P, int d, int NP, int dchunk,
                                     int threads, void* stream) {
  const size_t smem = static_cast<size_t>(QB + P) * (dchunk + 1) * sizeof(float);
  paged_distance_kernel<<<T, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      page_ids, q, qq, db, vnorm, out, QB, P, d, NP, dchunk);
  return static_cast<int>(cudaGetLastError());
}
