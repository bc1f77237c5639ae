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
// Given an `lse` pointer (the training path), it also writes each row's
// log-sum-exp, lse = m + log(l) where l > 0 else 0 (B, H, S) f32, the
// convention of the reference's `_fa_fwd_impl`; the backward
// (flash_attention_bwd.cu) recomputes the probabilities from it. A null
// pointer (the serving path) writes nothing more.
//
// What bounds it on this card: f32 operations. At gemma3-1b's prefill
// shape (B 4, H 4, Hkv 1, S 1024, dh 256, window 512) a layer does about
// 6.4 GFLOP (4 * dh per unmasked (row, col) pair) on 42 MB of q, k, v
// and output: about 150 flops per byte, far above the ~20 where the
// H100's f32 FMA rate (67 TFLOP/s, no tensor cores) takes over from HBM
// (3.35 TB/s). An SM issues 4 warp-FMAs per clock, but its shared memory
// serves one 128-byte wavefront per clock, and a warp's 16-byte load
// takes four (one per quarter-warp). So the FMA pipes stay fed only if a
// thread does at least 4 FMAs per 4-byte word it loads from shared
// memory: an 8 x 8 register tile per thread in both products.
//
// Design: one block of 8 warps per (q block of 64 rows, head, batch),
// heaviest q blocks first across all heads and batches; the TPU's
// sequential kv grid axis is a loop inside the block over kv blocks of
// 64 rows. Warp w owns query rows 8w .. 8w + 7 in both products, so the
// scores, the softmax and p stay inside the warp.
// - Scores, split over d: lane (ds, cg) = (lane / 8, lane % 8) sums the
//   warp's 8 rows x kv columns cg + 8 j (j < 8) over the d columns
//   4 (ds + 4 t) .. + 3: per 4 columns of d, 8 float4 of q (one address
//   per quarter-warp) and 8 of k (8 consecutive rows per quarter-warp: no
//   bank conflict) for 256 FMAs. An xor-shuffle reduce-scatter over the
//   4 ds lanes (32 + 16 shuffles) leaves lane (ds, cg) with rows 2 ds,
//   2 ds + 1 x its 8 columns.
// - Softmax: the row max and sum are 3 xor shuffles across the 8 cg
//   lanes of a row; p goes to the warp's rows of shared memory, and
//   alpha and the final l reach the P.V lanes by shuffle.
// - P.V: lane c accumulates the warp's 8 rows x 8 output columns (4 c ..
//   4 c + 3 and 128 + 4 c .. at dh 256; dh / 32 at smaller dh) in
//   registers: per kv row, 8 p (float4 broadcasts over 4 rows) and 2
//   float4 of v (contiguous across the warp) for 64 FMAs.
// - Staging, one buffer each for k and v, with cp.async (16 bytes per
//   copy) as FlashAttention-2 orders it: v of a block is issued after the
//   barrier that opens the block and lands while its scores are
//   computed; k of the next block is issued after the barrier that
//   closes the scores and lands during P.V. Two __syncthreads per kv
//   block. bf16 inputs are converted while staging, in registers
//   (synchronously). Rows of a last block beyond S or Skv are zeroed.
// - Shared memory, rows padded by 4 words (pitch / 4 odd: 16-byte reads
//   of 8 neighbouring rows fall in distinct banks): q, k and v 64 x (dh +
//   4) each, p 64 x 68. At dh 256: 3 x 65 + 17 = 212 KiB of the 227 KiB
//   a block may have, so one block (8 warps) per SM. The launch sets the
//   dynamic-shared-memory attribute and returns its error.
// - Registers and spills (nvcc -Xptxas -v, sm_90a, in chip_smoke.py's
//   build phase): PERF.md. At dh 256 the 64 score and 64 output
//   accumulators take the thread to 254 registers, which is what holds
//   the block to 8 warps per SM and the kernel below its bound.
// Plain f32 FMA: no TF32, no tensor cores.
//
// Skipped blocks: the Pallas kernel iterates every kv block; this one
// loops only over the blocks that hold at least one unmasked (row, col)
// pair of its q block (the causal diagonal and the window bound the
// range). That changes no real row: every row has a valid column in the
// blocks kept, a fully masked block before it is wiped by the first
// real block's alpha = exp(NEG_INF - m) = 0, and one after it adds
// exp(NEG_INF - m) = 0. S and Skv are multiples of 32; the rows of the
// last q block beyond S are zero and never written, and the kv rows of
// the last block beyond Skv are zero and masked (col >= s_orig). The q blocks run
// heaviest first across all heads and batches, so the long causal rows
// do not trail the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // kv rows per inner step
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsW = kBQ / kWarps;  // query rows per warp
constexpr int kPPitch = kBK + 4;      // row pitch of p
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(x.x, x.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(x.z, x.w);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copy `rows` x DH elements (row-major, contiguous) into shared memory
// as f32 with row pitch `pitch`: f32 by cp.async, 16 bytes per copy (the
// caller commits and waits); bf16 by 16-byte loads converted in
// registers.
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int pitch) {
  constexpr int kVec = DH / 4;
  for (int e = threadIdx.x; e < rows * kVec; e += kThreads) {
    const int r = e / kVec, c = (e - r * kVec) * 4;
    cp_async16(dst + r * pitch + c, src + 4 * e);
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

// Stage `valid` rows of src (row-major, DH wide) into dst and zero the
// rest of its `rows` rows (a block's rows beyond S or Skv).
template <int DH, typename T>
__device__ __forceinline__ void stage_block(float* dst, const T* src,
                                            int valid, int rows) {
  stage<DH>(dst, src, valid, DH + 4);
  for (int e = threadIdx.x; e < (rows - valid) * DH; e += kThreads)
    dst[(valid + e / DH) * (DH + 4) + e % DH] = 0.0f;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int B, int H, int Hkv, int S,
                       int Skv, int s_orig, float scale, int causal,
                       int window, float softcap) {
  constexpr int kPitch = DH + 4;
  constexpr bool kVecV = DH >= 128;     // P.V columns as float4
  constexpr int kNC = DH >= 32 ? DH / 32 : 1;  // P.V columns per lane
  constexpr int kAcc = kVecV ? 4 * (DH / 128) : kNC;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // kBQ x kPitch
  float* k_s = q_s + kBQ * kPitch;      // kBK x kPitch
  float* v_s = k_s + kBK * kPitch;      // kBK x kPitch
  float* p_s = v_s + kBK * kPitch;      // kBQ x kPPitch

  // heaviest q blocks first across all heads and batches
  const int nqb = (S + kBQ - 1) / kBQ, bh = blockIdx.x % (H * B);
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x) / (H * B)) * kBQ;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = warp * kRowsW;         // this warp's first row
  const int ds = lane / 8, cg = lane % 8;  // score layout

  const T* kb = k + (static_cast<long>(b) * Hkv + hk) * Skv * DH;
  const T* vb = v + (static_cast<long>(b) * Hkv + hk) * Skv * DH;
  stage_block<DH>(q_s, q + ((static_cast<long>(b) * H + h) * S + q0) * DH,
                  min(kBQ, S - q0), kBQ);

  // the kv blocks that hold an unmasked (row, col) pair of this q block
  int kv_hi = (min(s_orig, Skv) + kBK - 1) / kBK;
  if (causal) kv_hi = min(kv_hi, (q0 + kBQ - 1) / kBK + 1);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  if (kv_lo < kv_hi)
    stage_block<DH>(k_s, kb + static_cast<long>(kv_lo) * kBK * DH,
                    min(kBK, Skv - kv_lo * kBK), kBK);
  cp_async_commit();

  // softmax state of rows w0 + 2 ds + a (the 8 cg lanes hold copies)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kRowsW][kAcc];
#pragma unroll
  for (int i = 0; i < kRowsW; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] = 0.0f;

  for (int blk = kv_lo; blk < kv_hi; ++blk) {
    const int k0 = blk * kBK, nk = min(kBK, Skv - k0);
    cp_async_wait_all();  // this thread's copies of k (and q) landed
    __syncthreads();      // everyone's; and v of the last block is consumed
    stage_block<DH>(v_s, vb + static_cast<long>(k0) * DH, nk, kBK);
    cp_async_commit();    // v lands while the scores are computed

    // partial scores of rows w0 + i, columns cg + 8 j over the d columns
    // 4 (ds + 4 t) .. + 3
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 4 * ds; c < DH; c += 16) {
      float4 x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = ld4(q_s + (w0 + i) * kPitch + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 y = ld4(k_s + (cg + 8 * j) * kPitch + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i][j] = __fmaf_rn(x[i].x, y.x, s[i][j]);
          s[i][j] = __fmaf_rn(x[i].y, y.y, s[i][j]);
          s[i][j] = __fmaf_rn(x[i].z, y.z, s[i][j]);
          s[i][j] = __fmaf_rn(x[i].w, y.w, s[i][j]);
        }
      }
    }
    // reduce-scatter over the 4 ds lanes: lane ds ends with rows 2 ds,
    // 2 ds + 1
    float t[4][8], u[2][8];
    {
      const bool up = ds & 2;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float send = up ? s[i][j] : s[i + 4][j];
          t[i][j] = (up ? s[i + 4][j] : s[i][j]) +
                    __shfl_xor_sync(0xffffffffu, send, 16);
        }
    }
    {
      const bool up = ds & 1;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float send = up ? t[i][j] : t[i + 2][j];
          u[i][j] = (up ? t[i + 2][j] : t[i][j]) +
                    __shfl_xor_sync(0xffffffffu, send, 8);
        }
    }

    // online softmax of rows w0 + 2 ds + a over columns k0 + cg + 8 j
    float alpha[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int rb = w0 + 2 * ds + a, row = q0 + rb;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + cg + 8 * j;
        float y = u[a][j] * scale;
        if (softcap > 0.0f) y = softcap * tanhf(y / softcap);
        bool ok = col < s_orig;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && (row - col) < window;
        u[a][j] = ok ? y : kNegInf;
        mx = fmaxf(mx, u[a][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(u[a][j] - m_new);
        p_s[rb * kPPitch + cg + 8 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      alpha[a] = expf(m[a] - m_new);
      l[a] = alpha[a] * l[a] + psum;
      m[a] = m_new;
    }

    cp_async_wait_all();  // this thread's copies of v landed
    __syncthreads();      // everyone's; and every warp is done with k
    if (blk + 1 < kv_hi)  // the next k lands while p . v is computed
      stage_block<DH>(k_s, kb + static_cast<long>(k0 + kBK) * DH,
                      min(kBK, Skv - k0 - kBK), kBK);
    cp_async_commit();

    // acc = alpha * acc + p . v for the warp's 8 rows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = __shfl_sync(0xffffffffu, alpha[i & 1], (i / 2) * 8);
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[i][j] *= al;
    }
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = ld4(p_s + (w0 + i) * kPPitch + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = v_s + (c + e) * kPitch;
        float pe[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pe[i] = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z
                                                             : pv[i].w;
        if constexpr (kVecV) {
#pragma unroll
          for (int hh = 0; hh < DH / 128; ++hh) {
            const float4 y = ld4(vr + 4 * lane + 128 * hh);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][4 * hh] = __fmaf_rn(pe[i], y.x, acc[i][4 * hh]);
              acc[i][4 * hh + 1] = __fmaf_rn(pe[i], y.y, acc[i][4 * hh + 1]);
              acc[i][4 * hh + 2] = __fmaf_rn(pe[i], y.z, acc[i][4 * hh + 2]);
              acc[i][4 * hh + 3] = __fmaf_rn(pe[i], y.w, acc[i][4 * hh + 3]);
            }
          }
        } else {
#pragma unroll
          for (int hh = 0; hh < kNC; ++hh) {
            const float y = lane + 32 * hh < DH ? vr[lane + 32 * hh] : 0.0f;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              acc[i][hh] = __fmaf_rn(pe[i], y, acc[i][hh]);
          }
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lraw = __shfl_sync(0xffffffffu, l[i & 1], (i / 2) * 8);
    const float mr = __shfl_sync(0xffffffffu, m[i & 1], (i / 2) * 8);
    const float lr = fmaxf(lraw, 1e-30f);
    if (q0 + w0 + i >= S) continue;
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long>(b) * H + h) * S + q0 + w0 + i] =
          lraw > 0.0f ? mr + logf(lr) : 0.0f;
    T* o = out + ((static_cast<long>(b) * H + h) * S + q0 + w0 + i) * DH;
    if constexpr (kVecV) {
#pragma unroll
      for (int hh = 0; hh < DH / 128; ++hh)
        store4(o + 4 * lane + 128 * hh,
               make_float4(acc[i][4 * hh] / lr, acc[i][4 * hh + 1] / lr,
                           acc[i][4 * hh + 2] / lr, acc[i][4 * hh + 3] / lr));
    } else {
#pragma unroll
      for (int hh = 0; hh < kNC; ++hh)
        if (lane + 32 * hh < DH) store1(o + lane + 32 * hh, acc[i][hh] / lr);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int Hkv, int S, int Skv, int s_orig,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kBQ + 2 * kBK) * (DH + 4) + kBQ * kPPitch) *
      sizeof(float);
  auto* kern = flash_attention_kernel<T, DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block per (q block, head, batch), heaviest q blocks first
  const int grid = ((S + kBQ - 1) / kBQ) * H * B;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, B, H, Hkv, S,
      Skv, s_orig, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int H, int Hkv, int S, int Skv, int s_orig,
              float scale, int causal, int window, float softcap,
              cudaStream_t stream) {
#define FLASH_LAUNCH(D)                                                     \
  return launch<T, D>(q, k, v, out, lse, B, H, Hkv, S, Skv, s_orig, scale, \
                      causal, window, softcap, stream)
  switch (dh) {
    case 16: FLASH_LAUNCH(16);
    case 32: FLASH_LAUNCH(32);
    case 64: FLASH_LAUNCH(64);
    case 128: FLASH_LAUNCH(128);
    case 256: FLASH_LAUNCH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_LAUNCH
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` (the caller's
// current stream), allocates nothing, and returns the first CUDA error
// (setting the shared-memory attribute, or cudaGetLastError() right
// after the launch) so that a refused launch is reported. S and Skv
// must be multiples of 32 (the wrapper pads); dh one of 16, 32, 64, 128,
// 256; `bf16` selects bf16 inputs and output, else f32; `lse` (B, H, S)
// f32, or null to write none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int H, int Hkv, int S, int Skv,
                                      int dh, int s_orig, float scale,
                                      int causal, int window, float softcap,
                                      int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, l, B, H, Hkv, S, Skv,
                                    s_orig, scale, causal, window, softcap,
                                    st);
  return launch_dh<float>(dh, q, k, v, out, l, B, H, Hkv, S, Skv, s_orig,
                          scale, causal, window, softcap, st);
}
