// Flash attention (online-softmax forward) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py:83
// `flash_attention` (body `_fa_kernel`): for q (B, H, S, dh) and k, v
// (B, Hkv, Skv, dh), H % Hkv == 0, query head h reads kv head
// h / (H / Hkv), and
//     s   = (q . k^T) * scale, then softcap * tanh(s / softcap) if set,
//     s   = NEG_INF where col >= s_orig, or (causal) col > row, or
//           (window > 0) row - col >= window — in that order,
//     out = softmax(s) . v
// with the softmax carried online over kv blocks in f32 (running max m,
// denominator l, accumulator acc), NEG_INF = -1e30 and a final
// l = max(l, 1e-30), exactly as `_fa_kernel` does. Inputs are f32 or
// bf16; everything is computed in f32 and the output has the input type.
//
// What bounds it on this card: f32 operations. At gemma3-1b's prefill
// shape (B 4, H 4, Hkv 1, S 1024, dh 256, window 512) a layer does about
// 6.4 GFLOP (4 * dh per unmasked (row, col) pair) on 40 MB of q, k, v
// and output: about 160 flops per byte, far above the ~20 where the
// H100's f32 FMA rate (67 TFLOP/s, no tensor cores) takes over from HBM
// (3.35 TB/s). So the design keeps the f32 FMA pipes fed from shared
// memory and spends no HBM traffic twice.
//
// Design: one thread block per (q block of 32 rows, head, batch); the
// TPU's sequential kv grid axis is a loop inside the block. The block
// stages its q tile once and each 32-row k and v tile in shared memory
// as f32 (rows padded by four words so that 16-byte reads of
// neighbouring rows fall in distinct banks). 8 warps each own 4 query
// rows: lane c computes the 4 scores of kv column c (float4 reads of q
// broadcast to the warp, one float4 read of k per lane), the row max
// and sum are warp shuffles, p goes through a per-warp shared row, and
// lane c accumulates output columns c, c + 32, ... of its warp's 4 rows
// in registers. Shared memory: 32 x (dh + 4) floats each for q, k and
// v, plus 32 x 32 for p — 104 KB at dh 256, above the 48 KB static
// limit, so the launch sets the dynamic-shared-memory attribute; two
// blocks fit one SM. Plain f32 FMA: no TF32, no tensor cores.
//
// Skipped blocks: the Pallas kernel iterates every kv block; this one
// loops only over the blocks that hold at least one unmasked (row, col)
// pair of its q block (the causal diagonal and the window bound the
// range). That changes no real row: every row has a valid column in the
// blocks kept, a fully masked block before it is wiped by the first
// real block's alpha = exp(NEG_INF - m) = 0, and one after it adds
// exp(NEG_INF - m) = 0. Padded rows beyond the caller's S are sliced off.
// The q blocks run heaviest first (reverse order), so the long causal
// rows do not trail the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;             // query rows per block
constexpr int kBK = 32;             // kv rows per inner step (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;  // query rows per warp
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copy `rows` x DH elements (row-major, contiguous) into shared memory
// as f32 with row pitch `pitch`, 16 bytes of input per load.
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int pitch) {
  constexpr int kVec = DH / 4;
  for (int e = threadIdx.x; e < rows * kVec; e += kThreads) {
    const int r = e / kVec, c = (e - r * kVec) * 4;
    const float4 x = reinterpret_cast<const float4*>(src)[e];
    *reinterpret_cast<float4*>(dst + r * pitch + c) = x;
  }
}

template <int DH>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      int rows, int pitch) {
  constexpr int kVec = DH / 8;
  for (int e = threadIdx.x; e < rows * kVec; e += kThreads) {
    const int r = e / kVec, c = (e - r * kVec) * 8;
    const uint4 raw = reinterpret_cast<const uint4*>(src)[e];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float* o = dst + r * pitch + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int S, int Skv, int s_orig, float scale,
                       int causal, int window, float softcap) {
  constexpr int kPitch = DH + 4;
  constexpr int kCol = (DH + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // kBQ x kPitch
  float* k_s = q_s + kBQ * kPitch;    // kBK x kPitch
  float* v_s = k_s + kBK * kPitch;    // kBK x kPitch
  float* p_s = v_s + kBK * kPitch;    // kBQ x kBK

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRows;        // this warp's first row in the block

  const T* kb = k + (static_cast<long>(b) * Hkv + hk) * Skv * DH;
  const T* vb = v + (static_cast<long>(b) * Hkv + hk) * Skv * DH;
  stage<DH>(q_s, q + ((static_cast<long>(b) * H + h) * S + q0) * DH, kBQ,
            kPitch);

  // the kv blocks that hold an unmasked (row, col) pair of this q block
  int kv_hi = (min(s_orig, Skv) + kBK - 1) / kBK;
  if (causal) kv_hi = min(kv_hi, (q0 + kBQ - 1) / kBK + 1);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  float m[kRows], l[kRows], acc[kRows][kCol];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCol; ++j) acc[r][j] = 0.0f;
  }

  for (int blk = kv_lo; blk < kv_hi; ++blk) {
    const int k0 = blk * kBK;
    __syncthreads();  // the previous step's k and v tiles are consumed
    stage<DH>(k_s, kb + static_cast<long>(k0) * DH, kBK, kPitch);
    stage<DH>(v_s, vb + static_cast<long>(k0) * DH, kBK, kPitch);
    __syncthreads();

    // scores of this warp's rows against kv column k0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float* kr = k_s + lane * kPitch;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kv4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv4 =
            *reinterpret_cast<const float4*>(q_s + (r0 + r) * kPitch + d);
        s[r] = __fmaf_rn(qv4.x, kv4.x, s[r]);
        s[r] = __fmaf_rn(qv4.y, kv4.y, s[r]);
        s[r] = __fmaf_rn(qv4.z, kv4.z, s[r]);
        s[r] = __fmaf_rn(qv4.w, kv4.w, s[r]);
      }
    }

    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + r0 + r;
      float x = s[r] * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      bool ok = col < s_orig;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && (row - col) < window;
      x = ok ? x : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = expf(x - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      p_s[(r0 + r) * kBK + lane] = p;
#pragma unroll
      for (int j = 0; j < kCol; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();  // p_s rows are written and read by this warp only

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pc[r] = p_s[(r0 + r) * kBK + c];
      const float* vr = v_s + c * kPitch + lane;
#pragma unroll
      for (int j = 0; j < kCol; ++j) {
        if (DH % 32 == 0 || lane + 32 * j < DH) {
          const float vv = vr[32 * j];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][j] = __fmaf_rn(pc[r], vv, acc[r][j]);
        }
      }
    }
    __syncwarp();  // p_s is read before the next step overwrites it
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float lr = fmaxf(l[r], 1e-30f);
    T* o = out + ((static_cast<long>(b) * H + h) * S + q0 + r0 + r) * DH;
#pragma unroll
    for (int j = 0; j < kCol; ++j)
      if (DH % 32 == 0 || lane + 32 * j < DH)
        store_out(o + lane + 32 * j, acc[r][j] / lr);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int S, int Skv, int s_orig, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kBQ + 2 * kBK) * (DH + 4) + kBQ * kBK) *
      sizeof(float);
  auto* kern = flash_attention_kernel<T, DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, S, Skv,
      s_orig, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              int B, int H, int Hkv, int S, int Skv, int s_orig, float scale,
              int causal, int window, float softcap, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, Hkv, S, Skv, s_orig,
                                  scale, causal, window, softcap, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, H, Hkv, S, Skv, s_orig,
                                  scale, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, H, Hkv, S, Skv, s_orig,
                                  scale, causal, window, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, Hkv, S, Skv, s_orig,
                                    scale, causal, window, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, H, Hkv, S, Skv, s_orig,
                                    scale, causal, window, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` (the caller's
// current stream), allocates nothing, and returns the first CUDA error
// (setting the shared-memory attribute, or cudaGetLastError() right
// after the launch) so that a refused launch is reported. S and Skv
// must be multiples of 32 (the wrapper pads); dh one of 16, 32, 64, 128,
// 256; `bf16` selects bf16 inputs and output, else f32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hkv, int S, int Skv, int dh,
                                      int s_orig, float scale, int causal,
                                      int window, float softcap, int bf16,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, B, H, Hkv, S, Skv,
                                    s_orig, scale, causal, window, softcap,
                                    st);
  return launch_dh<float>(dh, q, k, v, out, B, H, Hkv, S, Skv, s_orig, scale,
                          causal, window, softcap, st);
}
