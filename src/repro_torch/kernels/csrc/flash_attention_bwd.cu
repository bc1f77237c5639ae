// Flash attention backward for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates its attention
// through the jnp custom VJP `flash_attention`
// (src/repro/models/attention.py:362), whose backward is the
// block-recomputing `_fa_bwd_impl` (:253). This kernel computes what that
// function computes, from the forward's output and its rows'
// log-sum-exp (flash_attention.cu writes them when given an lse pointer).
// For q (B, H, S, dh), k, v (B, Hkv, Skv, dh), H % Hkv == 0, query head h
// on kv head h / (H / Hkv), out and dout shaped as q, lse (B, H, S) f32:
//     D   = rowsum(dout * out)
//     s   = (q . k^T) * scale; under a softcap t = tanh(s / softcap),
//           s = softcap * t
//     P   = exp(s - lse) where (row, col) counts (col < s_orig, causal
//           col <= row, window row - col < window), else 0
//     dP  = dout . v^T
//     dS  = P * (dP - D), times (1 - t^2) under a softcap, times scale
//     dq  = dS . k;  dk = sum over the group's heads of dS^T . q;
//     dv  = sum over the group's heads of P^T . dout
// in f32, outputs in the input type (f32 or bf16).
//
// What bounds it on this card: f32 operations. Per unmasked (row, col)
// pair and head it does five products of dh multiply-adds (s and dP
// twice, once per pass below, dq, dk, dv): at gemma3-1b's training shape
// (B 4, H 4, Hkv 1, S 1024, dh 256) some 12 to 25 GFLOP per layer on
// 25 MB of operands, far above the ~20 flops per byte where the H100's
// f32 FMA rate (67 TFLOP/s, no tensor cores) takes over from HBM.
//
// Design (simple first; PERF.md has its time against the bound). No
// atomics: every output element is written once, by one thread, after a
// sum in a fixed order, so the same inputs give the same bits on every
// run (the restart check of the training path relies on it). Three
// kernels on the caller's stream:
// 1. rowdot: D per (batch, head, row), one warp per row.
// 2. dk/dv: one block of 8 warps per (kv block of 32 rows, kv head,
//    batch) keeps its k and v tiles in shared memory and loops over the
//    query heads of its group and, for each, over the q blocks that the
//    mask leaves live for its columns (causal: from the diagonal on;
//    window: up to the last row within `window` of its first column;
//    none when its first column is beyond s_orig), so the sum over the
//    group happens inside the block. Per q block it stages q, dout, lse
//    and D, recomputes s and dP (a 2 x 2 register tile of each per
//    thread, over float4 columns of d), writes P and dS to shared
//    memory, and adds P^T . dout and dS^T . q into its dk, dv
//    accumulators (2 kv rows x 4 float4 columns each per thread at dh
//    256).
// 3. dq: one block per (q block of 32 rows, head, batch), heaviest q
//    blocks first; it keeps q, dout, lse and D and loops over the live
//    kv blocks (the forward's range), adding dS . k into its dq
//    accumulators.
// S and Skv are multiples of 32 (the op pads), so no tile is ragged; the
// op's padding rows of q have dout = 0, so they add nothing (dP = 0 and
// D = 0 there). Shared memory: q, dout, k, v 32 x (dh + 4) each, P and dS
// 32 x 48: 142 KiB at dh 256 (the launch sets the dynamic shared-memory
// attribute), so one block per SM. Plain f32 FMA: no TF32, no tensor
// cores; wgmma and TMA are later work (ROADMAP B).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 32;              // rows of a q block and of a kv block
constexpr int kThreads = 256;
constexpr int kSPitch = kB + 16;    // row pitch of the P and dS tiles

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copy a kB x DH tile (contiguous rows) into shared memory as f32 with
// row pitch DH + 4.
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src) {
  constexpr int kVec = DH / 4;
  for (int e = threadIdx.x; e < kB * kVec; e += kThreads) {
    const int r = e / kVec, c = (e - r * kVec) * 4;
    *reinterpret_cast<float4*>(dst + r * (DH + 4) + c) =
        reinterpret_cast<const float4*>(src)[e];
  }
}

template <int DH>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src) {
  constexpr int kVec = DH / 8;
  for (int e = threadIdx.x; e < kB * kVec; e += kThreads) {
    const int r = e / kVec, c = (e - r * kVec) * 8;
    const uint4 raw = reinterpret_cast<const uint4*>(src)[e];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float* o = dst + r * (DH + 4) + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// The thread layout of a kB x DH accumulator: colT threads across the
// DH / 4 float4 columns (CT each, strided by colT), rowT = kThreads / colT
// row teams, RT rows each (strided by kB / RT); with more row teams than
// rows (dh 16) the surplus threads hold nothing.
template <int DH>
struct Acc {
  static constexpr int kC4 = DH / 4;
  static constexpr int colT = kC4 < 16 ? kC4 : 16;
  static constexpr int CT = kC4 / colT;
  static constexpr int rowT = kThreads / colT;
  static constexpr int RT = rowT >= kB ? 1 : kB / rowT;
  static constexpr int rowStride = kB / RT;
};

// acc[x][4u + e] += sum_b W(a_x, b) * X[b][4 (cteam + colT u) + e], with
// W(a, b) = W[b][a] (trans) or W[a][b], W a kB x kB tile of pitch
// kSPitch, X a kB x DH tile of pitch DH + 4.
template <int DH, bool kTrans>
__device__ __forceinline__ void accumulate(
    float (&acc)[Acc<DH>::RT][4 * Acc<DH>::CT], const float* W,
    const float* X, int rteam, int cteam) {
  using L = Acc<DH>;
  if (rteam >= L::rowStride) return;
#pragma unroll 4
  for (int b = 0; b < kB; ++b) {
    float w[L::RT];
#pragma unroll
    for (int x = 0; x < L::RT; ++x) {
      const int a = rteam + L::rowStride * x;
      w[x] = kTrans ? W[b * kSPitch + a] : W[a * kSPitch + b];
    }
#pragma unroll
    for (int u = 0; u < L::CT; ++u) {
      const float4 y = ld4(X + b * (DH + 4) + 4 * (cteam + L::colT * u));
#pragma unroll
      for (int x = 0; x < L::RT; ++x) {
        acc[x][4 * u] = __fmaf_rn(w[x], y.x, acc[x][4 * u]);
        acc[x][4 * u + 1] = __fmaf_rn(w[x], y.y, acc[x][4 * u + 1]);
        acc[x][4 * u + 2] = __fmaf_rn(w[x], y.z, acc[x][4 * u + 2]);
        acc[x][4 * u + 3] = __fmaf_rn(w[x], y.w, acc[x][4 * u + 3]);
      }
    }
  }
}

// Write a thread's accumulator rows into `dst` (kB x DH rows of the
// output, contiguous).
template <int DH, typename T>
__device__ __forceinline__ void write_acc(
    T* dst, const float (&acc)[Acc<DH>::RT][4 * Acc<DH>::CT], int rteam,
    int cteam) {
  using L = Acc<DH>;
  if (rteam >= L::rowStride) return;
#pragma unroll
  for (int x = 0; x < L::RT; ++x)
#pragma unroll
    for (int u = 0; u < L::CT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(dst + (rteam + L::rowStride * x) * DH +
                   4 * (cteam + L::colT * u) + e,
               acc[x][4 * u + e]);
}

// Scores and dP of the q block (rows q0 ..) against the kv block (cols
// k0 ..) from the staged tiles, then P and dS into shared memory. Thread
// (ti, tj) = (tid / 16, tid % 16) computes rows ti, ti + 16 x cols tj,
// tj + 16.
template <int DH>
__device__ __forceinline__ void probs(const float* q_s, const float* do_s,
                                      const float* k_s, const float* v_s,
                                      const float* lse_s, const float* d_s,
                                      float* p_s, float* ds_s, int q0, int k0,
                                      int s_orig, float scale, int causal,
                                      int window, float softcap) {
  constexpr int kPitch = DH + 4;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float dp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
  for (int c = 0; c < DH; c += 4) {
    float4 a[2], g[2], kk[2], vv[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      a[x] = ld4(q_s + (ti + 16 * x) * kPitch + c);
      g[x] = ld4(do_s + (ti + 16 * x) * kPitch + c);
      kk[x] = ld4(k_s + (tj + 16 * x) * kPitch + c);
      vv[x] = ld4(v_s + (tj + 16 * x) * kPitch + c);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        s[x][y] = __fmaf_rn(a[x].x, kk[y].x, s[x][y]);
        s[x][y] = __fmaf_rn(a[x].y, kk[y].y, s[x][y]);
        s[x][y] = __fmaf_rn(a[x].z, kk[y].z, s[x][y]);
        s[x][y] = __fmaf_rn(a[x].w, kk[y].w, s[x][y]);
        dp[x][y] = __fmaf_rn(g[x].x, vv[y].x, dp[x][y]);
        dp[x][y] = __fmaf_rn(g[x].y, vv[y].y, dp[x][y]);
        dp[x][y] = __fmaf_rn(g[x].z, vv[y].z, dp[x][y]);
        dp[x][y] = __fmaf_rn(g[x].w, vv[y].w, dp[x][y]);
      }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int rb = ti + 16 * x, cb = tj + 16 * y;
      const int row = q0 + rb, col = k0 + cb;
      float z = s[x][y] * scale, t = 0.0f;
      if (softcap > 0.0f) {
        t = tanhf(z / softcap);
        z = softcap * t;
      }
      bool ok = col < s_orig;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && (row - col) < window;
      const float p = ok ? expf(z - lse_s[rb]) : 0.0f;
      float ds = p * (dp[x][y] - d_s[rb]);
      if (softcap > 0.0f) ds = ds * (1.0f - t * t);
      p_s[rb * kSPitch + cb] = p;
      ds_s[rb * kSPitch + cb] = ds * scale;
    }
}

// Stage the q block's q and dout tiles and its rows' lse and D.
template <int DH, typename T>
__device__ __forceinline__ void stage_q(float* q_s, float* do_s,
                                        float* lse_s, float* d_s, const T* q,
                                        const T* dout, const float* lse,
                                        const float* rowdot, long row0) {
  stage<DH>(q_s, q + row0 * DH);
  stage<DH>(do_s, dout + row0 * DH);
  if (threadIdx.x < kB) {
    lse_s[threadIdx.x] = lse[row0 + threadIdx.x];
    d_s[threadIdx.x] = rowdot[row0 + threadIdx.x];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
              float* __restrict__ rowdot, long rows) {
  const long row = static_cast<long>(blockIdx.x) * (kThreads / 32) +
                   threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int c = lane; c < DH; c += 32)
    acc = __fmaf_rn(to_f(dout[row * DH + c]), to_f(out[row * DH + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) rowdot[row] = acc;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ rowdot, T* __restrict__ dk,
              T* __restrict__ dv, int B, int H, int Hkv, int S, int Skv,
              int s_orig, float scale, int causal, int window,
              float softcap) {
  using L = Acc<DH>;
  constexpr int kTile = kB * (DH + 4);
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile;
  float* q_s = v_s + kTile;
  float* do_s = q_s + kTile;
  float* p_s = do_s + kTile;
  float* ds_s = p_s + kB * kSPitch;
  float* lse_s = ds_s + kB * kSPitch;
  float* d_s = lse_s + kB;

  // kv blocks in the outer order: the early (causally heaviest) ones of
  // every head and batch in the first wave
  const int j = blockIdx.x / (Hkv * B), hb = blockIdx.x % (Hkv * B);
  const int hk = hb % Hkv, b = hb / Hkv, G = H / Hkv;
  const int k0 = j * kB;
  const long kv0 = (static_cast<long>(b) * Hkv + hk) * Skv + k0;
  stage<DH>(k_s, k + kv0 * DH);
  stage<DH>(v_s, v + kv0 * DH);

  // the q blocks whose rows see at least one of this block's columns
  int q_lo = causal ? k0 / kB : 0, q_hi = k0 < s_orig ? S / kB : 0;
  if (window > 0) q_hi = min(q_hi, (k0 + kB - 2 + window) / kB + 1);

  const int cteam = threadIdx.x % L::colT, rteam = threadIdx.x / L::colT;
  float acc_k[L::RT][4 * L::CT], acc_v[L::RT][4 * L::CT];
#pragma unroll
  for (int x = 0; x < L::RT; ++x)
#pragma unroll
    for (int e = 0; e < 4 * L::CT; ++e) acc_k[x][e] = acc_v[x][e] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const long qrow = (static_cast<long>(b) * H + hk * G + g) * S;
    for (int i = q_lo; i < q_hi; ++i) {
      __syncthreads();  // the last block's tiles are consumed
      stage_q<DH>(q_s, do_s, lse_s, d_s, q, dout, lse, rowdot,
                  qrow + i * kB);
      __syncthreads();
      probs<DH>(q_s, do_s, k_s, v_s, lse_s, d_s, p_s, ds_s, i * kB, k0,
                s_orig, scale, causal, window, softcap);
      __syncthreads();
      accumulate<DH, true>(acc_v, p_s, do_s, rteam, cteam);
      accumulate<DH, true>(acc_k, ds_s, q_s, rteam, cteam);
    }
  }
  write_acc<DH>(dk + kv0 * DH, acc_k, rteam, cteam);
  write_acc<DH>(dv + kv0 * DH, acc_v, rteam, cteam);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ rowdot,
             T* __restrict__ dq, int B, int H, int Hkv, int S, int Skv,
             int s_orig, float scale, int causal, int window,
             float softcap) {
  using L = Acc<DH>;
  constexpr int kTile = kB * (DH + 4);
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile;
  float* q_s = v_s + kTile;
  float* do_s = q_s + kTile;
  float* p_s = do_s + kTile;
  float* ds_s = p_s + kB * kSPitch;
  float* lse_s = ds_s + kB * kSPitch;
  float* d_s = lse_s + kB;

  // heaviest q blocks first across all heads and batches
  const int nqb = S / kB, bh = blockIdx.x % (H * B);
  const int i = nqb - 1 - static_cast<int>(blockIdx.x) / (H * B);
  const int h = bh % H, b = bh / H, hk = h / (H / Hkv);
  const int q0 = i * kB;
  const long row0 = (static_cast<long>(b) * H + h) * S + q0;
  stage_q<DH>(q_s, do_s, lse_s, d_s, q, dout, lse, rowdot, row0);

  // the kv blocks that hold an unmasked (row, col) pair of this q block
  int kv_hi = (min(s_orig, Skv) + kB - 1) / kB;
  if (causal) kv_hi = min(kv_hi, (q0 + kB - 1) / kB + 1);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) / kB : 0;

  const int cteam = threadIdx.x % L::colT, rteam = threadIdx.x / L::colT;
  float acc[L::RT][4 * L::CT];
#pragma unroll
  for (int x = 0; x < L::RT; ++x)
#pragma unroll
    for (int e = 0; e < 4 * L::CT; ++e) acc[x][e] = 0.0f;

  const long kvb = (static_cast<long>(b) * Hkv + hk) * Skv;
  for (int j = kv_lo; j < kv_hi; ++j) {
    __syncthreads();  // the last block's tiles are consumed
    stage<DH>(k_s, k + (kvb + j * kB) * DH);
    stage<DH>(v_s, v + (kvb + j * kB) * DH);
    __syncthreads();
    probs<DH>(q_s, do_s, k_s, v_s, lse_s, d_s, p_s, ds_s, q0, j * kB,
              s_orig, scale, causal, window, softcap);
    __syncthreads();
    accumulate<DH, false>(acc, ds_s, k_s, rteam, cteam);
  }
  write_acc<DH>(dq + row0 * DH, acc, rteam, cteam);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* rowdot, int B, int H, int Hkv, int S, int Skv, int s_orig,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long rows = static_cast<long>(B) * H * S;
  rowdot_kernel<T, DH><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                         kThreads, 0, stream>>>(static_cast<const T*>(out),
                                                dot, rowdot, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = (static_cast<size_t>(4) * kB * (DH + 4) +
                       2 * kB * kSPitch + 2 * kB) * sizeof(float);
  auto* kv_kern = bwd_kv_kernel<T, DH>;
  auto* q_kern = bwd_q_kernel<T, DH>;
  err = cudaFuncSetAttribute(kv_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(q_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kern<<<(Skv / kB) * Hkv * B, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, rowdot, static_cast<T*>(dk), static_cast<T*>(dv),
      B, H, Hkv, S, Skv, s_orig, scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kern<<<(S / kB) * H * B, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, rowdot, static_cast<T*>(dq), B, H, Hkv, S, Skv,
      s_orig, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const void* out, const void* dout, const float* lse, void* dq,
              void* dk, void* dv, float* rowdot, int B, int H, int Hkv,
              int S, int Skv, int s_orig, float scale, int causal, int window,
              float softcap, cudaStream_t stream) {
#define BWD_LAUNCH(D)                                                        \
  return launch<T, D>(q, k, v, out, dout, lse, dq, dk, dv, rowdot, B, H, Hkv, \
                      S, Skv, s_orig, scale, causal, window, softcap, stream)
  switch (dh) {
    case 16: BWD_LAUNCH(16);
    case 32: BWD_LAUNCH(32);
    case 64: BWD_LAUNCH(64);
    case 128: BWD_LAUNCH(128);
    case 256: BWD_LAUNCH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BWD_LAUNCH
}

}  // namespace

// Plain C entry point for ctypes. Launches its three kernels on `stream`
// (the caller's current stream), allocates nothing (`rowdot`, (B, H, S)
// f32, is the caller's scratch for D), and returns the first CUDA error
// (a launch, or setting the shared-memory attribute) so that a refused
// launch is reported. S and Skv must be multiples of 32 (the wrapper
// pads); dh one of 16, 32, 64, 128, 256; `bf16` selects bf16 q, k, v,
// out, dout and gradients, else f32; lse is f32 in both.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* rowdot, int B, int H, int Hkv, int S, int Skv, int dh, int s_orig,
    float scale, int causal, int window, float softcap, int bf16,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(rowdot);
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, dout, l, dq, dk, dv, d,
                                    B, H, Hkv, S, Skv, s_orig, scale, causal,
                                    window, softcap, st);
  return launch_dh<float>(dh, q, k, v, out, dout, l, dq, dk, dv, d, B, H,
                          Hkv, S, Skv, s_orig, scale, causal, window, softcap,
                          st);
}
