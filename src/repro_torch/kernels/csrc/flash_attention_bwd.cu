// Flash attention backward for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates its attention
// through the jnp custom VJP `flash_attention`
// (src/repro/models/attention.py:362), whose backward is the
// block-recomputing `_fa_bwd_impl` (:253). This file computes what that
// function computes, from the forward's output and its rows' log-sum-exp
// (flash_attention.cu writes them when given an lse pointer). For q
// (B, H, S, dh), k, v (B, Hkv, Skv, dh), H % Hkv == 0, query head h on kv
// head h / (H / Hkv), out and dout shaped as q, lse (B, H, S) f32:
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
// What bounds it on this card: f32 operations. Per live (row, col) pair
// and head there are five products of dh multiply-adds (s, dP, dq, dk,
// dv), 5 x 2 dh operations, at the f32 FMA rate (67 TFLOP/s; no tensor
// cores): at gemma3-1b's training shape (B 4, H 4, Hkv 1, S 1024, dh 256)
// 16.1 GFLOP at a window of 512 and 21.5 GFLOP causal, 0.24 and 0.32 ms,
// on 25 MB of operands (~20 flops per byte is where the FMA rate takes
// over from HBM). Each of the five products is computed once per live
// pair: nothing is recomputed.
//
// Design: two kernels on the caller's stream, no atomics. Every output
// and scratch element is written once, by one thread, after a sum in a
// fixed order, so the same inputs give the same bits on every run (the
// training path's restart check relies on it).
// 1. bwd_dq_kernel, row-parallel: one block of 8 warps per (q tile of 32
//    rows, head, batch), heaviest q tiles first across all heads and
//    batches. Its prologue computes D for its rows. It loops over the kv
//    tiles of 64 columns that hold a live pair of its rows (the band,
//    below), computes s and dP once, forms P and dS, writes both as f32
//    into the band scratch, and adds dS . k into its dq accumulators in
//    registers, in ascending kv order: three products per pair.
//    - s and dP split over d (flash_attention.cu's layout): warp w owns
//      rows 4w .. 4w + 3; lane (ds, cg) = (lane / 8, lane % 8) sums those
//      4 rows x columns cg + 8 j (j < 8) over d columns 4 (ds + 4 t) ..
//      + 3, a 4 x 8 register tile: per 4 columns of d, 4 float4 of q (one
//      address per quarter-warp) and 8 of k (8 neighbouring rows per
//      quarter-warp, no bank conflict) for 128 FMAs. An xor-shuffle
//      reduce-scatter over the 4 ds lanes leaves lane (ds, cg) with row
//      4w + ds of its 8 columns.
//    - dq: thread (rteam, cteam) holds 4 rows x 8 columns at dh 256 (the
//      `DqLayout`); per kv row one float4 of dS^T (a broadcast) and two
//      float4 of k (contiguous across the warp) for 32 FMAs.
//    - Staging with cp.async (16 bytes per copy), one buffer each for k
//      and v, ordered so that every copy lands behind a product: dP of a
//      tile (v) runs while its k lands; v of the next tile is issued
//      once dP is done and lands behind s, P, dS and dq; k of the next
//      tile is issued after dq. bf16 inputs are converted while staging,
//      in registers (synchronously). A last kv tile beyond Skv (Skv is a
//      multiple of 32, the tile 64) is zero-filled and masked.
// 2. bwd_dkdv_kernel, column-split: one block of 4 warps per (kv tile of
//    32 rows, slice of 64 dh columns, kv head, batch), kv tiles in
//    ascending order (the causally heaviest first), the slices of a tile
//    next to each other (they read the same P and dS, from L2). It sums
//    P^T . dout into dv (warps 0, 1) and dS^T . q into dk (warps 2, 3)
//    over the group's heads and the live q tiles of its columns, in that
//    fixed order, from the scratch: two products per pair, no softmax and
//    no recomputation, no partial sum across blocks. Per q row a thread
//    loads one float4 of P (or dS, its 4 kv rows) and two of dout (or q,
//    its 8 columns) for 32 FMAs. P, dS, q and dout tiles are staged with
//    cp.async, double-buffered: the next (head, q tile) lands while the
//    current one is summed.
// The band scratch: P and dS, f32, each laid out per (batch and kv head
// of the pass, head of the group, q tile, kv tile - first live kv tile of
// that q tile) x 32 x 64, at a width of the most live kv tiles any q
// tile has (`band_w`). A q tile's live columns are the interval
// `live_cols` returns (every column in it counts for one of its rows),
// so its live kv tiles are consecutive, none entirely masked; kernel 2
// takes a q tile for its 32 columns when that interval meets them. The
// wrapper (flash_attention/kernel.py: `live_cols`, `band_layout`,
// `band_plan`) computes the same intervals, the width and the scratch
// size, allocates the scratch, and passes the number of (batch, kv head)
// pairs per pass (`slice_bh`): above its budget of scratch bytes this
// entry runs both kernels over slices of the (batch, kv head) grid in
// turn, which changes no bit. At G3 the scratch is 75.5 MB (window 512,
// width 9) and 134.2 MB (causal, width 16), of which 56.6 and 71.3 MB
// are live tiles, written once and read by 4 dh slices.
// S and Skv are multiples of 32 (the op pads). The op's padding rows of q
// have dout = 0, so their P adds nothing to dv, and D = dP = 0 makes their
// dS 0. Shared memory at dh 256: kernel 1 q, dout 32 x 260 and k, v 64 x
// 260 f32, dS^T 64 x 36: 204 KiB, one block per SM; kernel 2 two stages
// of P, dS 32 x 32 and q, dout 32 x 64: 48 KiB, four blocks per SM. The
// launch sets the dynamic shared-memory attribute and returns its error.
// Registers (nvcc -Xptxas -v, sm_90a, chip_smoke.py's build phase):
// kernel 1 168 at dh 256 (96-168 at other head dims and in bf16), kernel
// 2 96 (71-96), no spills.
// Why no tensor cores: the repo's f32 contract (f32 matmuls stay IEEE,
// no TF32), so every product is plain f32 FMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;               // q rows of a band tile
constexpr int kBK = 64;               // kv columns of a band tile
constexpr int kTile = kBQ * kBK;      // floats of a band tile
constexpr int kBK2 = 32;              // kv rows of kernel 2's tile
constexpr int kThreads1 = 256;
constexpr int kThreads2 = 128;
constexpr int kDsPitch = kBQ + 4;     // row pitch of dS^T (64 x 36)

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(a, b);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(c, d);
}

// The live kv columns of the q tile whose first row is q0: [x, y], empty
// when x > y. Every column in it counts for at least one of the tile's
// rows (flash_attention/kernel.py `live_cols` is the same function).
__device__ __forceinline__ int2 live_cols(int q0, int s_orig, int causal,
                                          int window) {
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = (causal ? min(s_orig, q0 + kBQ) : s_orig) - 1;
  return make_int2(lo, hi);
}

// Copy `rows` rows of W elements (source row stride `sstride`) into
// shared memory as f32 with row pitch `dpitch`: f32 by cp.async, 16 bytes
// per copy (the caller commits and waits); bf16 by 16-byte loads
// converted in registers.
template <int W, int NT>
__device__ __forceinline__ void stage(float* dst, int dpitch, const float* src,
                                      long sstride, int rows) {
  constexpr int kVec = W / 4;
  for (int e = threadIdx.x; e < rows * kVec; e += NT) {
    const int r = e / kVec, c = (e - r * kVec) * 4;
    cp_async16(dst + r * dpitch + c, src + r * sstride + c);
  }
}

template <int W, int NT>
__device__ __forceinline__ void stage(float* dst, int dpitch,
                                      const __nv_bfloat16* src, long sstride,
                                      int rows) {
  constexpr int kVec = W / 8;
  for (int e = threadIdx.x; e < rows * kVec; e += NT) {
    const int r = e / kVec, c = (e - r * kVec) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * sstride + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    float* o = dst + r * dpitch + c;
    *reinterpret_cast<float4*>(o) = make_float4(f0.x, f0.y, f1.x, f1.y);
    *reinterpret_cast<float4*>(o + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

// Stage `valid` rows of a kv tile (row-major, DH wide) into a kBK-row
// buffer of pitch DH + 4 and zero the rest (a last tile beyond Skv).
template <int DH, typename T>
__device__ __forceinline__ void stage_kv(float* dst, const T* src,
                                         int valid) {
  stage<DH, kThreads1>(dst, DH + 4, src, DH, valid);
  for (int e = threadIdx.x; e < (kBK - valid) * DH; e += kThreads1)
    dst[(valid + e / DH) * (DH + 4) + e % DH] = 0.0f;
}

// A 32 x 64 product tile A . B^T of the q tile's rows (A, 32 x DH) and a
// kv tile's rows (B, 64 x DH), both of pitch DH + 4, split over d: lane
// (ds, cg) of warp w sums rows 4w .. 4w + 3 x columns cg + 8 j over the d
// columns 4 (ds + 4 t) .. + 3, then an xor reduce-scatter over the 4 ds
// lanes leaves it row 4w + ds: out[j] = (A . B^T)[4w + ds][cg + 8 j].
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int warp, int ds, int cg,
                                         float (&out)[8]) {
  constexpr int kPitch = DH + 4;
  float s[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
  for (int c = 4 * ds; c < DH; c += 16) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(A + (4 * warp + i) * kPitch + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 y = ld4(Bm + (cg + 8 * j) * kPitch + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = __fmaf_rn(x[i].x, y.x, s[i][j]);
        s[i][j] = __fmaf_rn(x[i].y, y.y, s[i][j]);
        s[i][j] = __fmaf_rn(x[i].z, y.z, s[i][j]);
        s[i][j] = __fmaf_rn(x[i].w, y.w, s[i][j]);
      }
    }
  }
  // lanes ds and ds ^ 2 swap halves: ds & 2 keeps rows 2, 3
  float t[2][8];
  const bool up2 = ds & 2;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float send = up2 ? s[a][j] : s[a + 2][j];
      t[a][j] = (up2 ? s[a + 2][j] : s[a][j]) +
                __shfl_xor_sync(0xffffffffu, send, 16);
    }
  // then ds and ds ^ 1: ds & 1 keeps the second row of the pair
  const bool up1 = ds & 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float send = up1 ? t[0][j] : t[1][j];
    out[j] = (up1 ? t[1][j] : t[0][j]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
}

// The thread layout of kernel 1's dq accumulators (32 x DH): colT threads
// across the DH / 4 float4 columns (CT each, strided by colT), rowT =
// kThreads1 / colT row teams of RT consecutive rows; with more row teams
// than rows (dh 16) the surplus threads hold nothing.
template <int DH>
struct DqLayout {
  static constexpr int kC4 = DH / 4;
  static constexpr int colT = kC4 < 32 ? kC4 : 32;
  static constexpr int CT = kC4 / colT;
  static constexpr int rowT = kThreads1 / colT;
  static constexpr int RT = rowT >= kBQ ? 1 : kBQ / rowT;
};

// acc[x][4u + e] += sum_b dS^T[b][rteam RT + x] * k[b][4 (cteam + colT u)
// + e] over the kv tile's 64 rows, in ascending b.
template <int DH>
__device__ __forceinline__ void dq_accumulate(
    float (&acc)[DqLayout<DH>::RT][4 * DqLayout<DH>::CT], const float* dst_s,
    const float* k_s, int rteam, int cteam) {
  using L = DqLayout<DH>;
  if (rteam * L::RT >= kBQ) return;
#pragma unroll 4
  for (int b = 0; b < kBK; ++b) {
    float w[L::RT];
    const float* wp = dst_s + b * kDsPitch + rteam * L::RT;
    if constexpr (L::RT == 4) {
      const float4 w4 = ld4(wp);
      w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
    } else if constexpr (L::RT == 2) {
      const float2 w2 = *reinterpret_cast<const float2*>(wp);
      w[0] = w2.x; w[1] = w2.y;
    } else {
#pragma unroll
      for (int x = 0; x < L::RT; ++x) w[x] = wp[x];
    }
#pragma unroll
    for (int u = 0; u < L::CT; ++u) {
      const float4 y = ld4(k_s + b * (DH + 4) + 4 * (cteam + L::colT * u));
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads1, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ out,
              const T* __restrict__ dout, const float* __restrict__ lse,
              T* __restrict__ dq, float* __restrict__ p_band,
              float* __restrict__ ds_band, int H, int Hkv, int S, int Skv,
              int s_orig, float scale, int causal, int window, float softcap,
              int band_w, int bh0, int nbh) {
  using L = DqLayout<DH>;
  constexpr int kPitch = DH + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // kBQ x kPitch
  float* do_s = q_s + kBQ * kPitch;       // kBQ x kPitch
  float* k_s = do_s + kBQ * kPitch;       // kBK x kPitch
  float* v_s = k_s + kBK * kPitch;        // kBK x kPitch
  float* dst_s = v_s + kBK * kPitch;      // kBK x kDsPitch: dS^T
  float* lse_s = dst_s + kBK * kDsPitch;  // kBQ
  float* d_s = lse_s + kBQ;               // kBQ

  // heaviest q tiles first across all heads and batches of the pass
  const int G = H / Hkv, nq = S / kBQ, per = nbh * G;
  const int i = nq - 1 - static_cast<int>(blockIdx.x) / per;
  const int hg = static_cast<int>(blockIdx.x) % per, bl = hg / G, g = hg % G;
  const int bh = bh0 + bl, b = bh / Hkv, hk = bh % Hkv, h = hk * G + g;
  const int q0 = i * kBQ;
  const long row0 = (static_cast<long>(b) * H + h) * S + q0;
  const T* kb = k + (static_cast<long>(b) * Hkv + hk) * Skv * DH;
  const T* vb = v + (static_cast<long>(b) * Hkv + hk) * Skv * DH;
  const int2 cols = live_cols(q0, s_orig, causal, window);
  const int lo = cols.x / kBK, hi = cols.x <= cols.y ? cols.y / kBK + 1 : lo;
  const long band0 =
      ((static_cast<long>(bl) * G + g) * nq + i) * band_w * kTile;

  stage<DH, kThreads1>(q_s, kPitch, q + row0 * DH, DH, kBQ);
  stage<DH, kThreads1>(do_s, kPitch, dout + row0 * DH, DH, kBQ);
  if (lo < hi) {
    stage_kv<DH>(v_s, vb + static_cast<long>(lo) * kBK * DH,
                 min(kBK, Skv - lo * kBK));
    stage_kv<DH>(k_s, kb + static_cast<long>(lo) * kBK * DH,
                 min(kBK, Skv - lo * kBK));
  }
  cp_async_commit();
  if (threadIdx.x < kBQ) lse_s[threadIdx.x] = lse[row0 + threadIdx.x];
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // D of the warp's rows 4w .. 4w + 3: lanes over d, then an xor sum
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = 4 * warp + x;
    const T* o = out + (row0 + r) * DH;
    float acc = 0.0f;
    for (int c = lane; c < DH; c += 32)
      acc = __fmaf_rn(do_s[r * kPitch + c], to_f(o[c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) d_s[r] = acc;
  }
  __syncthreads();

  const int ds = lane / 8, cg = lane % 8;   // the score layout
  const int rl = 4 * warp + ds, row = q0 + rl;
  const float lse_r = lse_s[rl], d_r = d_s[rl];
  const int rteam = threadIdx.x / L::colT, cteam = threadIdx.x % L::colT;
  float acc[L::RT][4 * L::CT];
#pragma unroll
  for (int x = 0; x < L::RT; ++x)
#pragma unroll
    for (int e = 0; e < 4 * L::CT; ++e) acc[x][e] = 0.0f;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kBK;
    cp_async_wait<1>();   // v of this tile landed (its k may be in flight)
    __syncthreads();
    float dp[8], sv[8];
    tile_dot<DH>(do_s, v_s, warp, ds, cg, dp);
    cp_async_wait<0>();
    __syncthreads();      // k landed for everyone; every warp is done with v
    if (j + 1 < hi)       // the next v lands behind s, P, dS and dq
      stage_kv<DH>(v_s, vb + static_cast<long>(k0 + kBK) * DH,
                   min(kBK, Skv - k0 - kBK));
    cp_async_commit();
    tile_dot<DH>(q_s, k_s, warp, ds, cg, sv);
    float* pt = p_band + band0 + (j - lo) * kTile + rl * kBK;
    float* dt = ds_band + band0 + (j - lo) * kTile + rl * kBK;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int cb = cg + 8 * jj, col = k0 + cb;
      float z = sv[jj] * scale, t = 0.0f;
      if (softcap > 0.0f) {
        t = tanhf(z / softcap);
        z = softcap * t;
      }
      bool ok = col < s_orig;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && (row - col) < window;
      const float p = ok ? expf(z - lse_r) : 0.0f;
      float dsv = p * (dp[jj] - d_r);
      if (softcap > 0.0f) dsv = dsv * (1.0f - t * t);
      dsv = dsv * scale;
      pt[cb] = p;
      dt[cb] = dsv;
      dst_s[cb * kDsPitch + rl] = dsv;
    }
    __syncthreads();      // dS^T complete
    dq_accumulate<DH>(acc, dst_s, k_s, rteam, cteam);
    __syncthreads();      // every warp is done with k and dS^T
    if (j + 1 < hi)       // the next k lands behind the next dP
      stage_kv<DH>(k_s, kb + static_cast<long>(k0 + kBK) * DH,
                   min(kBK, Skv - k0 - kBK));
    cp_async_commit();
  }

  if (rteam * L::RT < kBQ) {
#pragma unroll
    for (int x = 0; x < L::RT; ++x)
#pragma unroll
      for (int u = 0; u < L::CT; ++u)
        store4(dq + (row0 + rteam * L::RT + x) * DH +
                   4 * (cteam + L::colT * u),
               acc[x][4 * u], acc[x][4 * u + 1], acc[x][4 * u + 2],
               acc[x][4 * u + 3]);
  }
}

// Kernel 2's slice of dh: SL columns per block (NSL blocks per kv tile),
// CPT of them per thread (2, 4 or 8).
template <int DH>
struct Cols {
  static constexpr int SL = DH < 64 ? DH : 64;
  static constexpr int NSL = DH / SL;
  static constexpr int CPT = SL / 8;
  // floats of one stage: P and dS 32 x 32, q and dout 32 x SL
  static constexpr int kStage = 2 * kBQ * kBK2 + 2 * kBQ * SL;
};

// Column e of a thread's CPT columns in column group c.
template <int CPT>
__device__ __forceinline__ int col_of(int c, int e) {
  return CPT == 8 ? (e < 4 ? 4 * c + e : 32 + 4 * c + e - 4) : CPT * c + e;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads2, 4)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                const float* __restrict__ p_band,
                const float* __restrict__ ds_band, T* __restrict__ dk,
                T* __restrict__ dv, int H, int Hkv, int S, int Skv,
                int s_orig, int causal, int window, int band_w, int bh0,
                int nbh) {
  using C = Cols<DH>;
  extern __shared__ __align__(16) float smem[];   // two stages

  // kv tiles in ascending order (causally heaviest first), the slices of
  // a tile and pair next to each other
  const int G = H / Hkv, nq = S / kBQ, per = nbh * C::NSL;
  const int jt = static_cast<int>(blockIdx.x) / per;
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int bl = rem / C::NSL, sl = rem % C::NSL;
  const int bh = bh0 + bl, b = bh / Hkv, hk = bh % Hkv;
  const int k0 = jt * kBK2, s0 = sl * C::SL;

  // the q tiles whose live columns meet k0 .. k0 + 31: an interval, as
  // both ends of a q tile's live columns grow with its first row
  int i_lo = nq, i_hi = 0;
  for (int i = 0; i < nq; ++i) {
    const int2 c = live_cols(i * kBQ, s_orig, causal, window);
    if (c.x <= c.y && c.x < k0 + kBK2 && k0 <= c.y) {
      i_lo = min(i_lo, i);
      i_hi = i + 1;
    }
  }
  const int ni = max(0, i_hi - i_lo), steps = G * ni;

  // stage step s = (head g of the group, q tile i_lo + s % ni) into buf:
  // P, dS (32 q rows x this tile's 32 kv columns), q, dout (32 x SL)
  auto issue = [&](int s, float* buf) {
    const int g = s / ni, i = i_lo + s % ni, h = hk * G + g;
    const int lo = live_cols(i * kBQ, s_orig, causal, window).x / kBK;
    const long tile =
        (((static_cast<long>(bl) * G + g) * nq + i) * band_w +
         (k0 / kBK - lo)) * kTile + k0 % kBK;
    stage<kBK2, kThreads2>(buf, kBK2, p_band + tile, kBK, kBQ);
    stage<kBK2, kThreads2>(buf + kBQ * kBK2, kBK2, ds_band + tile, kBK, kBQ);
    const long row0 = (static_cast<long>(b) * H + h) * S + i * kBQ;
    stage<C::SL, kThreads2>(buf + 2 * kBQ * kBK2, C::SL, q + row0 * DH + s0,
                            DH, kBQ);
    stage<C::SL, kThreads2>(buf + 2 * kBQ * kBK2 + kBQ * C::SL, C::SL,
                            dout + row0 * DH + s0, DH, kBQ);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 2;    // 0: dv from P and dout; 1: dk from dS, q
  const int t = (warp % 2) * 4 + lane / 8, c = lane % 8;
  float acc[4][C::CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < C::CPT; ++e) acc[a][e] = 0.0f;

  if (steps > 0) issue(0, smem);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1, smem + ((s + 1) & 1) * C::kStage);
    cp_async_commit();
    cp_async_wait<1>();   // step s landed (s + 1 may be in flight)
    __syncthreads();
    const float* cur = smem + (s & 1) * C::kStage;
    const float* W = cur + role * kBQ * kBK2;
    const float* X = cur + 2 * kBQ * kBK2 + (1 - role) * kBQ * C::SL;
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      const float4 w = ld4(W + r * kBK2 + 4 * t);
      float x[C::CPT];
      const float* xr = X + r * C::SL;
      if constexpr (C::CPT == 8) {
        const float4 a = ld4(xr + 4 * c), bb = ld4(xr + 32 + 4 * c);
        x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
        x[4] = bb.x; x[5] = bb.y; x[6] = bb.z; x[7] = bb.w;
      } else if constexpr (C::CPT == 4) {
        const float4 a = ld4(xr + 4 * c);
        x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(xr + 2 * c);
        x[0] = a.x; x[1] = a.y;
      }
#pragma unroll
      for (int e = 0; e < C::CPT; ++e) {
        acc[0][e] = __fmaf_rn(w.x, x[e], acc[0][e]);
        acc[1][e] = __fmaf_rn(w.y, x[e], acc[1][e]);
        acc[2][e] = __fmaf_rn(w.z, x[e], acc[2][e]);
        acc[3][e] = __fmaf_rn(w.w, x[e], acc[3][e]);
      }
    }
    __syncthreads();      // every warp is done with this buffer
  }

  T* o = (role ? dk : dv) +
         ((static_cast<long>(b) * Hkv + hk) * Skv + k0 + 4 * t) * DH + s0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if constexpr (C::CPT == 2) {
      store1(o + a * DH + 2 * c, acc[a][0]);
      store1(o + a * DH + 2 * c + 1, acc[a][1]);
    } else {
#pragma unroll
      for (int e = 0; e < C::CPT; e += 4)
        store4(o + a * DH + col_of<C::CPT>(c, e), acc[a][e], acc[a][e + 1],
               acc[a][e + 2], acc[a][e + 3]);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* p_band, float* ds_band, int B, int H, int Hkv, int S,
           int Skv, int s_orig, float scale, int causal, int window,
           float softcap, int band_w, int slice_bh, cudaStream_t stream) {
  using C = Cols<DH>;
  if (slice_bh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* dot = static_cast<const T*>(dout);
  const size_t smem1 = (static_cast<size_t>(2 * kBQ + 2 * kBK) * (DH + 4) +
                        kBK * kDsPitch + 2 * kBQ) * sizeof(float);
  const size_t smem2 = static_cast<size_t>(2 * C::kStage) * sizeof(float);
  auto* k1 = bwd_dq_kernel<T, DH>;
  auto* k2 = bwd_dkdv_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / Hkv;
  // passes over slices of the (batch, kv head) grid; the scratch holds one
  for (int bh0 = 0; bh0 < B * Hkv; bh0 += slice_bh) {
    const int nbh = min(slice_bh, B * Hkv - bh0);
    k1<<<(S / kBQ) * nbh * G, kThreads1, smem1, stream>>>(
        qt, static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(out), dot, lse, static_cast<T*>(dq), p_band,
        ds_band, H, Hkv, S, Skv, s_orig, scale, causal, window, softcap,
        band_w, bh0, nbh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    k2<<<(Skv / kBK2) * nbh * C::NSL, kThreads2, smem2, stream>>>(
        qt, dot, p_band, ds_band, static_cast<T*>(dk), static_cast<T*>(dv),
        H, Hkv, S, Skv, s_orig, causal, window, band_w, bh0, nbh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const void* out, const void* dout, const float* lse, void* dq,
              void* dk, void* dv, float* p_band, float* ds_band, int B, int H,
              int Hkv, int S, int Skv, int s_orig, float scale, int causal,
              int window, float softcap, int band_w, int slice_bh,
              cudaStream_t stream) {
#define BWD_LAUNCH(D)                                                       \
  return launch<T, D>(q, k, v, out, dout, lse, dq, dk, dv, p_band, ds_band, \
                      B, H, Hkv, S, Skv, s_orig, scale, causal, window,     \
                      softcap, band_w, slice_bh, stream)
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

// Plain C entry point for ctypes. Launches its two kernels on `stream`
// (the caller's current stream) once per pass over `slice_bh` (batch, kv
// head) pairs, allocates nothing (`p_band`, `ds_band`: the caller's band
// scratch for one pass, f32, `band_w` tiles wide), and returns the first
// CUDA error (a launch, or setting the shared-memory attribute) so that a
// refused launch is reported. S and Skv must be multiples of 32 (the
// wrapper pads); dh one of 16, 32, 64, 128, 256; `bf16` selects bf16 q, k,
// v, out, dout and gradients, else f32; lse is f32 in both.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* p_band, void* ds_band, int B, int H, int Hkv, int S, int Skv,
    int dh, int s_orig, float scale, int causal, int window, float softcap,
    int bf16, int band_w, int slice_bh, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* pb = static_cast<float*>(p_band);
  float* db = static_cast<float*>(ds_band);
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, dout, l, dq, dk, dv, pb,
                                    db, B, H, Hkv, S, Skv, s_orig, scale,
                                    causal, window, softcap, band_w, slice_bh,
                                    st);
  return launch_dh<float>(dh, q, k, v, out, dout, l, dq, dk, dv, pb, db, B, H,
                          Hkv, S, Skv, s_orig, scale, causal, window, softcap,
                          band_w, slice_bh, st);
}
