// Bitonic (dist, id) sort and merge kernels for Hopper (sm_90a).
//
// Replace the two users of the Pallas launcher
// src/repro/kernels/topk/kernel.py `_launch_rows`:
//   * `bitonic_sort`  (:118, body `_bitonic_body`): the full network,
//     k = 1..log2 M, j = k-1..0;
//   * `bitonic_merge` (:130, body `_merge_body` -> `merge_network`): only
//     the last log2 M stages, k = log2 M, which sort a row that is
//     already bitonic (the caller builds it as A ++ filler ++ reversed(B)).
// Each row of (B, M) sorts ascending by (dist, id) lexicographically,
// with 0 to kMaxLanes payload lanes a launch (i32 or f32, moved as raw
// 32-bit words): one lane rides through the network itself; with more,
// each entry's input position rides and an epilogue in the same launch
// writes every output lane as out[r, j] = in[r, pos[r, j]], so the
// network's registers hold one payload word whatever the lanes. Four
// lanes a launch keep the launch's parameters small: at 32 a launch
// (520 bytes of pointers) one-lane rows took about 0.04 us more on an
// H100 (PERF.md). A second entry,
// `merge_unsorted_launch`, is the engine's Gather merge in one launch:
// mask the unsorted proposals, sort them, build the bitonic row with the
// sorted candidate list and merge it (see merge_unsorted_reg_kernel).
//
// What bounds them on this card: neither bytes nor operations, but
// latency. A row is tiny (16 proposals and a 64-wide merge row on the
// engine's main path), so a launch moves a few hundred KiB and does a
// few hundred thousand compares; what costs is the chain of dependent
// stages, log2 M * (log2 M + 1) / 2 for a sort.
//
// Design: two bodies that run the same network.
// - Register body, rows of M <= 128 (kRegMaxLog2). A row lives in the
//   registers of one warp: position p at lane p % 32, slot p / 32 (E =
//   M / 32 slots a lane); rows narrower than a warp take G = M lanes, and
//   32 / G rows share a warp. A stage of stride < G exchanges by
//   __shfl_xor_sync within the row's lane group, a stage of stride >= G
//   between a lane's own slots. No shared memory, no barrier: a stage
//   costs a shuffle's latency, not a block barrier. The network is
//   unrolled at compile time (one instance per log2 M), so every stride
//   and slot index is a constant. Rows past B are masked at load and
//   store only: every lane reaches every shuffle with the full mask.
// - Shared-memory body, wider rows up to the wrapper's MAX_M (2048):
//   M / 2 threads per row, one compare-exchange pair per thread per
//   stage, keys, payload and positions in shared memory, a block
//   barrier after every stage; small rows pack several to a block of up
//   to 256 threads.
// Both apply `_cmp_exchange`'s rule per element as the reference writes
// it: partner = idx ^ (1 << j), ascending iff bit k of idx is unset, and
// an element takes its partner's entry iff (ascending == is_lower) ?
// partner_less : !partner_less. Two orders decide partner_less:
// - a merge pass (`bitonic_merge`, the Gather merge's last stage) uses
//   the reference's IEEE compare, dp < d || (dp == d && ip < i), as the
//   plain `merge_network` does;
// - a sort (`bitonic_sort`, the Gather merge's proposal sort) orders by
//   (dist with NaN after every number and all NaNs equal, id, position
//   in the input row), each entry carrying its input position: a total
//   order, so the network gives the result of a stable sort, as
//   `lax.sort` (the reference's jnp tier) and the plain version's
//   `torch.sort` do, -0.0 / 0.0, NaN and exact (dist, id) ties included.
// So both bodies give the plain versions' bits. There is no arithmetic
// to round.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBigDist = 3.0e38f;        // repro_torch.utils.BIG_DIST
constexpr int kIdSentinel = 0x7fffffff;    // repro_torch.utils.ID_SENTINEL
constexpr int kRegMaxLog2 = 7;             // register body up to M = 128
constexpr int kRegWarps = 2;               // warps per register-body block
constexpr int kSmemThreads = 256;          // threads per shared-body block
constexpr int kMaxLanes = 4;               // payload lanes per launch

// The payload lanes of a launch, as 32-bit words: an i32 or f32 lane
// moves bit for bit (NaN payloads, signed zeros).
struct Lanes {
  const unsigned* in[kMaxLanes];
  unsigned* out[kMaxLanes];
  int n;
};

__device__ __forceinline__ bool partner_less(float dp, int ip, float d,
                                             int i) {
  return dp < d || (dp == d && ip < i);
}

// A sort's order: dist (NaN last, NaNs equal), then id, then position.
__device__ __forceinline__ bool sort_less(float dp, int ip, int op, float d,
                                          int i, int o) {
  const bool np = isnan(dp), n = isnan(d);
  if (np != n) return n;
  if (!np && dp != d) return dp < d;
  return ip < i || (ip == i && op < o);
}

// The order of a stage: a sort's (with the positions `o`) or a merge's.
template <bool SORT>
__device__ __forceinline__ bool less_than(float dp, int ip, int op, float d,
                                          int i, int o) {
  if constexpr (SORT)
    return sort_less(dp, ip, op, d, i, o);
  else
    return partner_less(dp, ip, d, i);
}

// A row of M = 2^LOG2M entries in registers: G lanes, E slots per lane,
// RPW rows per warp.
template <int LOG2M>
struct RegRow {
  static constexpr int M = 1 << LOG2M;
  static constexpr int G = M < 32 ? M : 32;
  static constexpr int E = M / G;
  static constexpr int RPW = 32 / G;
};

// Stage (K, J) over the slots below `width` (warp-uniform; the slots
// above it hold filler that no later step reads). With SORT, the input
// positions `o` ride along and break ties; without, `o` is not read.
template <int G, int E, int K, int J, bool PAY, bool SORT>
__device__ __forceinline__ void reg_stage(float (&d)[E], int (&id)[E],
                                          int (&p)[E], int (&o)[E], int g,
                                          int width) {
  constexpr int kStride = 1 << J;
  if constexpr (kStride < G) {
#pragma unroll
    for (int s = 0; s < E; ++s) {
      if (s * G < width) {
        const float dp = __shfl_xor_sync(kFull, d[s], kStride, G);
        const int ip = __shfl_xor_sync(kFull, id[s], kStride, G);
        int pp = 0, op = 0;
        if constexpr (PAY) pp = __shfl_xor_sync(kFull, p[s], kStride, G);
        if constexpr (SORT) op = __shfl_xor_sync(kFull, o[s], kStride, G);
        const int pos = s * G + g;
        const bool asc = (pos & (1 << K)) == 0;
        const bool lower = (pos & kStride) == 0;
        const bool pl = less_than<SORT>(dp, ip, op, d[s], id[s], o[s]);
        if (asc == lower ? pl : !pl) {
          d[s] = dp;
          id[s] = ip;
          if constexpr (PAY) p[s] = pp;
          if constexpr (SORT) o[s] = op;
        }
      }
    }
  } else {
    constexpr int kSx = kStride / G;   // partner slot = slot ^ kSx
#pragma unroll
    for (int a = 0; a < E; ++a) {
      if ((a & kSx) == 0 && a * G < width) {
        const int b = a | kSx;
        const bool asc = ((a * G + g) & (1 << K)) == 0;  // bit K shared
        const bool less_lo =
            less_than<SORT>(d[b], id[b], o[b], d[a], id[a], o[a]);
        const bool less_hi =
            less_than<SORT>(d[a], id[a], o[a], d[b], id[b], o[b]);
        const bool take_lo = asc ? less_lo : !less_lo;   // a: is_lower
        const bool take_hi = asc ? !less_hi : less_hi;   // b: !is_lower
        const float da = d[a], db = d[b];
        const int ia = id[a], ib = id[b];
        d[a] = take_lo ? db : da;
        id[a] = take_lo ? ib : ia;
        d[b] = take_hi ? da : db;
        id[b] = take_hi ? ia : ib;
        if constexpr (PAY) {
          const int pa = p[a], pb = p[b];
          p[a] = take_lo ? pb : pa;
          p[b] = take_hi ? pa : pb;
        }
        if constexpr (SORT) {
          const int oa = o[a], ob = o[b];
          o[a] = take_lo ? ob : oa;
          o[b] = take_hi ? oa : ob;
        }
      }
    }
  }
}

// Stages (K, J), (K, J-1), ..., (K, 0), (K+1, K), ... while k <= klast.
template <int G, int E, int LOG2M, int K, int J, bool PAY, bool SORT>
__device__ __forceinline__ void reg_stages(float (&d)[E], int (&id)[E],
                                           int (&p)[E], int (&o)[E], int g,
                                           int width, int klast) {
  if constexpr (K <= LOG2M) {
    if (K <= klast) {
      reg_stage<G, E, K, J, PAY, SORT>(d, id, p, o, g, width);
      if constexpr (J > 0)
        reg_stages<G, E, LOG2M, K, J - 1, PAY, SORT>(d, id, p, o, g, width,
                                                     klast);
      else
        reg_stages<G, E, LOG2M, K + 1, K, PAY, SORT>(d, id, p, o, g, width,
                                                     klast);
    }
  }
}

// The full network over positions below `width` = 2^klast, in the
// sort's order; `o` holds each entry's input position.
template <int LOG2M, bool PAY, int E = RegRow<LOG2M>::E>
__device__ __forceinline__ void reg_sort(float (&d)[E], int (&id)[E],
                                         int (&p)[E], int (&o)[E], int g,
                                         int klast) {
  reg_stages<RegRow<LOG2M>::G, E, LOG2M, 1, 0, PAY, true>(
      d, id, p, o, g, 1 << klast, klast);
}

// The last log2 M stages alone (k = log2 M: every stage ascending), in
// the merge's order.
template <int LOG2M, bool PAY, int E = RegRow<LOG2M>::E>
__device__ __forceinline__ void reg_merge(float (&d)[E], int (&id)[E],
                                          int (&p)[E], int g) {
  if constexpr (LOG2M > 0)
    reg_stages<RegRow<LOG2M>::G, E, LOG2M, LOG2M, LOG2M - 1, PAY, false>(
        d, id, p, p, g, 1 << LOG2M, LOG2M);
}

// The epilogue for n > 1 lanes and the `N` positions a thread holds:
// out[l][row, q[s]] = in[l][row, pos[s]] for every lane l. The row's
// words sit in L1 after the first lane's reads of them.
template <int N>
__device__ __forceinline__ void write_lanes(const Lanes& lanes, long base,
                                            const int (&q)[N],
                                            const int (&pos)[N]) {
  for (int l = 0; l < lanes.n; ++l) {
    const unsigned* src = lanes.in[l] + base;
    unsigned* dst = lanes.out[l] + base;
#pragma unroll
    for (int s = 0; s < N; ++s) dst[q[s]] = src[pos[s]];
  }
}

// Sort (merge_only = 0) or merge pass (merge_only = 1) of rows of M =
// 2^LOG2M in registers. The network carries one payload word an entry
// (`p`) whatever the lanes: the lane's own word when there is one lane,
// else the entry's input position (a sort's tie-break positions `o`
// ride besides).
template <int LOG2M>
__global__ void __launch_bounds__(kRegWarps * 32)
    bitonic_reg_kernel(const float* __restrict__ din,
                       const int* __restrict__ iin, float* __restrict__ dout,
                       int* __restrict__ iout,
                       const __grid_constant__ Lanes lanes, int B,
                       int merge_only) {
  using R = RegRow<LOG2M>;
  const int lane = threadIdx.x & 31;
  const int g = lane & (R::G - 1);
  const long row =
      (static_cast<long>(blockIdx.x) * kRegWarps + (threadIdx.x >> 5)) *
          R::RPW + lane / R::G;
  const bool active = row < B;
  const bool one = lanes.n == 1;
  float d[R::E];
  int id[R::E], p[R::E], o[R::E], q[R::E];
#pragma unroll
  for (int s = 0; s < R::E; ++s) {
    const long e = row * R::M + s * R::G + g;
    d[s] = active ? din[e] : 0.f;
    id[s] = active ? iin[e] : 0;
    o[s] = q[s] = s * R::G + g;
    p[s] = one && active ? static_cast<int>(lanes.in[0][e]) : o[s];
  }
  if (merge_only)
    reg_merge<LOG2M, true>(d, id, p, g);
  else
    reg_sort<LOG2M, true>(d, id, p, o, g, LOG2M);
  if (active) {
#pragma unroll
    for (int s = 0; s < R::E; ++s) {
      const long e = row * R::M + s * R::G + g;
      dout[e] = d[s];
      iout[e] = id[s];
      if (one) lanes.out[0][e] = static_cast<unsigned>(p[s]);
    }
    if (lanes.n > 1) write_lanes(lanes, row * R::M, q, p);
  }
}

// The engine's Gather merge of one row in registers. Candidates A
// (sorted, LA wide, an expanded byte each) and proposals B (unsorted, LB
// wide, a valid byte each) give the first out_w entries of
//   merge(A ++ filler ++ reversed(sort(B masked, padded to MB)[:LB]))
// with M = next_pow2(LA + LB), MB = next_pow2(LB) = 2^log2mb: the bits of
// sort_op(B) then merge_sorted_op(A, B). Invalid proposals become
// (BIG_DIST, ID_SENTINEL); proposals carry payload 0. B is sorted in its
// own registers (positions below MB); reversing it onto the top of the
// merge row is one shuffle a slot: row position q >= M - LB takes B's
// position M - 1 - q, at lane G - 1 - g, slot E - 1 - s.
template <int LOG2M>
__global__ void __launch_bounds__(kRegWarps * 32) merge_unsorted_reg_kernel(
    const float* __restrict__ cand_d, const int* __restrict__ cand_i,
    const unsigned char* __restrict__ cand_e,
    const float* __restrict__ new_d, const int* __restrict__ new_i,
    const unsigned char* __restrict__ new_valid, float* __restrict__ out_d,
    int* __restrict__ out_i, unsigned char* __restrict__ out_e, int R,
    int LA, int LB, int log2mb, int out_w) {
  using W = RegRow<LOG2M>;
  const int lane = threadIdx.x & 31;
  const int g = lane & (W::G - 1);
  const long row =
      (static_cast<long>(blockIdx.x) * kRegWarps + (threadIdx.x >> 5)) *
          W::RPW + lane / W::G;
  const bool active = row < R;
  float md[W::E], bd[W::E];
  int mi[W::E], mp[W::E], bi[W::E], bo[W::E];
#pragma unroll
  for (int s = 0; s < W::E; ++s) {
    const int q = s * W::G + g;
    md[s] = kBigDist;
    mi[s] = kIdSentinel;
    mp[s] = 0;
    if (active && q < LA) {
      md[s] = cand_d[row * LA + q];
      mi[s] = cand_i[row * LA + q];
      mp[s] = cand_e[row * LA + q];
    }
    bd[s] = kBigDist;
    bi[s] = kIdSentinel;
    bo[s] = q;
    if (active && q < LB && new_valid[row * LB + q]) {
      bd[s] = new_d[row * LB + q];
      bi[s] = new_i[row * LB + q];
    }
  }
  reg_sort<LOG2M, false>(bd, bi, bo, bo, g, log2mb);
#pragma unroll
  for (int s = 0; s < W::E; ++s) {
    const float vd = __shfl_sync(kFull, bd[W::E - 1 - s], W::G - 1 - g, W::G);
    const int vi = __shfl_sync(kFull, bi[W::E - 1 - s], W::G - 1 - g, W::G);
    if (s * W::G + g >= W::M - LB) {
      md[s] = vd;
      mi[s] = vi;
      mp[s] = 0;
    }
  }
  reg_merge<LOG2M, true>(md, mi, mp, g);
  if (active) {
#pragma unroll
    for (int s = 0; s < W::E; ++s) {
      const int q = s * W::G + g;
      if (q < out_w) {
        out_d[row * out_w + q] = md[s];
        out_i[row * out_w + q] = mi[s];
        out_e[row * out_w + q] = mp[s] != 0;
      }
    }
  }
}

// Stages k = kfirst..klast of the network over a row in shared memory:
// `pairs` threads of the row each own one compare-exchange pair, and
// every thread of the block reaches each barrier. `sp` may be null. With
// `so` (the entries' input positions) the stages sort in the sort's
// order, without it they merge in the merge's.
__device__ void smem_stages(float* sd, int* si, int* sp, int* so, int lane,
                            int pairs, int kfirst, int klast, bool active) {
  for (int k = kfirst; k <= klast; ++k) {
    for (int j = k - 1; j >= 0; --j) {
      const int stride = 1 << j;
      const int lo = ((lane >> j) << (j + 1)) | (lane & (stride - 1));
      const int hi = lo | stride;
      if (active && lane < pairs) {
        const float d_lo = sd[lo], d_hi = sd[hi];
        const int i_lo = si[lo], i_hi = si[hi];
        const bool asc = (lo & (1 << k)) == 0;  // bit k is shared by lo, hi
        bool less_lo, less_hi;
        if (so != nullptr) {
          const int o_lo = so[lo], o_hi = so[hi];
          less_lo = sort_less(d_hi, i_hi, o_hi, d_lo, i_lo, o_lo);
          less_hi = sort_less(d_lo, i_lo, o_lo, d_hi, i_hi, o_hi);
        } else {
          less_lo = partner_less(d_hi, i_hi, d_lo, i_lo);
          less_hi = partner_less(d_lo, i_lo, d_hi, i_hi);
        }
        const bool take_lo = asc ? less_lo : !less_lo;   // lo: is_lower
        const bool take_hi = asc ? !less_hi : less_hi;   // hi: !is_lower
        sd[lo] = take_lo ? d_hi : d_lo;
        si[lo] = take_lo ? i_hi : i_lo;
        sd[hi] = take_hi ? d_lo : d_hi;
        si[hi] = take_hi ? i_lo : i_hi;
        if (sp != nullptr) {
          const int p_lo = sp[lo], p_hi = sp[hi];
          sp[lo] = take_lo ? p_hi : p_lo;
          sp[hi] = take_hi ? p_lo : p_hi;
        }
        if (so != nullptr) {
          const int o_lo = so[lo], o_hi = so[hi];
          so[lo] = take_lo ? o_hi : o_lo;
          so[hi] = take_hi ? o_lo : o_hi;
        }
      }
      __syncthreads();
    }
  }
}

// bitonic_reg_kernel's work for rows of any width in shared memory:
// dist, id, the payload word (with lanes) and a sort's position, four
// words an entry whatever the lanes.
__global__ void bitonic_smem_kernel(const float* __restrict__ din,
                                    const int* __restrict__ iin,
                                    float* __restrict__ dout,
                                    int* __restrict__ iout,
                                    const __grid_constant__ Lanes lanes,
                                    int B, int M, int log2m,
                                    int rows_per_block, int merge_only) {
  extern __shared__ float smem[];
  const int half = M > 1 ? M / 2 : 1;
  const int local_row = threadIdx.x / half;
  const int lane = threadIdx.x - local_row * half;
  const long row = static_cast<long>(blockIdx.x) * rows_per_block + local_row;
  const bool active = row < B;
  const bool one = lanes.n == 1;
  const bool pay = lanes.n > 0;

  const int rm = rows_per_block * M;
  float* sd = smem + local_row * M;
  int* si = reinterpret_cast<int*>(smem + rm) + local_row * M;
  int* sp = reinterpret_cast<int*>(smem + 2 * rm) + local_row * M;
  int* so = reinterpret_cast<int*>(smem + 3 * rm) + local_row * M;

  if (active) {
    for (int e = lane; e < M; e += half) {
      sd[e] = din[row * M + e];
      si[e] = iin[row * M + e];
      if (pay) sp[e] = one ? static_cast<int>(lanes.in[0][row * M + e]) : e;
      so[e] = e;
    }
  }
  __syncthreads();
  smem_stages(sd, si, pay ? sp : nullptr, merge_only ? nullptr : so, lane,
              M / 2, merge_only ? log2m : 1, log2m, active);
  if (active) {
    for (int e = lane; e < M; e += half) {
      dout[row * M + e] = sd[e];
      iout[row * M + e] = si[e];
      if (one) lanes.out[0][row * M + e] = static_cast<unsigned>(sp[e]);
    }
    for (int l = 0; lanes.n > 1 && l < lanes.n; ++l) {
      const unsigned* src = lanes.in[l] + row * M;
      unsigned* dst = lanes.out[l] + row * M;
      for (int e = lane; e < M; e += half) dst[e] = src[sp[e]];
    }
  }
}

// The Gather merge of merge_unsorted_reg_kernel for rows wider than the
// register body: B sorts in its own MB-wide shared row, then lands
// reversed on the top of the merge row.
__global__ void merge_unsorted_smem_kernel(
    const float* __restrict__ cand_d, const int* __restrict__ cand_i,
    const unsigned char* __restrict__ cand_e,
    const float* __restrict__ new_d, const int* __restrict__ new_i,
    const unsigned char* __restrict__ new_valid, float* __restrict__ out_d,
    int* __restrict__ out_i, unsigned char* __restrict__ out_e, int R,
    int LA, int LB, int M, int log2m, int log2mb, int out_w,
    int rows_per_block) {
  extern __shared__ float smem[];
  const int half = M / 2;
  const int mb = 1 << log2mb;
  const int local_row = threadIdx.x / half;
  const int lane = threadIdx.x - local_row * half;
  const long row = static_cast<long>(blockIdx.x) * rows_per_block + local_row;
  const bool active = row < R;

  const int rm = rows_per_block * M;
  float* sd = smem + local_row * M;
  int* si = reinterpret_cast<int*>(smem + rm) + local_row * M;
  int* sp = reinterpret_cast<int*>(smem + 2 * rm) + local_row * M;
  const int rb = rows_per_block * mb;
  float* bd = smem + 3 * rm + local_row * mb;
  int* bi = reinterpret_cast<int*>(smem + 3 * rm + rb) + local_row * mb;
  int* bo = reinterpret_cast<int*>(smem + 3 * rm + 2 * rb) + local_row * mb;

  if (active) {
    for (int q = lane; q < M; q += half) {
      const bool a = q < LA;
      sd[q] = a ? cand_d[row * LA + q] : kBigDist;
      si[q] = a ? cand_i[row * LA + q] : kIdSentinel;
      sp[q] = a ? cand_e[row * LA + q] : 0;
    }
    for (int r = lane; r < mb; r += half) {
      const bool v = r < LB && new_valid[row * LB + r];
      bd[r] = v ? new_d[row * LB + r] : kBigDist;
      bi[r] = v ? new_i[row * LB + r] : kIdSentinel;
      bo[r] = r;
    }
  }
  __syncthreads();
  smem_stages(bd, bi, nullptr, bo, lane, mb / 2, 1, log2mb, active);
  if (active) {
    for (int r = lane; r < LB; r += half) {
      sd[M - 1 - r] = bd[r];
      si[M - 1 - r] = bi[r];
      sp[M - 1 - r] = 0;
    }
  }
  __syncthreads();
  smem_stages(sd, si, sp, nullptr, lane, half, log2m, log2m, active);
  if (active) {
    for (int q = lane; q < out_w; q += half) {
      out_d[row * out_w + q] = sd[q];
      out_i[row * out_w + q] = si[q];
      out_e[row * out_w + q] = sp[q] != 0;
    }
  }
}

// Calls f(std::integral_constant<int, log2m>) for log2m in
// [0, kRegMaxLog2].
template <typename F>
int with_log2m(int log2m, F&& f) {
  switch (log2m) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int log2_ceil(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() right after the launch.
// `shared` != 0 runs the shared-memory body at any width (to hold the two
// bodies against each other); otherwise rows of M <= 128 take the
// register body.

// Sort (merge_only = 0) or merge pass (merge_only = 1) over the rows of
// (B, M), M = 2^log2m, with 0..kMaxLanes payload lanes, each (B, M) of
// 32-bit words: lin[l] in, lout[l] out (host arrays of device pointers,
// null without lanes).
extern "C" int bitonic_launch(const float* din, const int* iin, float* dout,
                              int* iout, const void* const* lin,
                              void* const* lout, int nl, int B, int M,
                              int log2m, int merge_only, int shared,
                              void* stream) {
  if (nl < 0 || nl > kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  Lanes lanes{};
  for (int l = 0; l < nl; ++l) {
    lanes.in[l] = static_cast<const unsigned*>(lin[l]);
    lanes.out[l] = static_cast<unsigned*>(lout[l]);
  }
  lanes.n = nl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shared && log2m <= kRegMaxLog2) {
    return with_log2m(log2m, [&](auto l) {
      constexpr int kLog2 = decltype(l)::value;
      constexpr int rows = kRegWarps * RegRow<kLog2>::RPW;
      bitonic_reg_kernel<kLog2><<<(B + rows - 1) / rows, kRegWarps * 32, 0,
                                  st>>>(din, iin, dout, iout, lanes, B,
                                        merge_only);
      return static_cast<int>(cudaGetLastError());
    });
  }
  const int half = M > 1 ? M / 2 : 1;
  const int per_block = kSmemThreads / half > 0 ? kSmemThreads / half : 1;
  const int rows = B < per_block ? B : per_block;
  const size_t smem = static_cast<size_t>(4) * rows * M * sizeof(float);
  bitonic_smem_kernel<<<(B + rows - 1) / rows, rows * half, smem, st>>>(
      din, iin, dout, iout, lanes, B, M, log2m, rows, merge_only);
  return static_cast<int>(cudaGetLastError());
}

// The Gather merge: cand_* (R, LA) sorted, new_* (R, LB) unsorted with a
// valid byte each -> out_* (R, out_w), out_w <= LA + LB; bool operands
// are bytes (read as 0/nonzero, written as 0/1).
extern "C" int merge_unsorted_launch(
    const float* cand_d, const int* cand_i, const unsigned char* cand_e,
    const float* new_d, const int* new_i, const unsigned char* new_valid,
    float* out_d, int* out_i, unsigned char* out_e, int R, int LA, int LB,
    int out_w, int shared, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log2m = log2_ceil(LA + LB);
  const int log2mb = log2_ceil(LB);
  if (!shared && log2m <= kRegMaxLog2) {
    return with_log2m(log2m, [&](auto l) {
      constexpr int kLog2 = decltype(l)::value;
      constexpr int rows = kRegWarps * RegRow<kLog2>::RPW;
      merge_unsorted_reg_kernel<kLog2>
          <<<(R + rows - 1) / rows, kRegWarps * 32, 0, st>>>(
              cand_d, cand_i, cand_e, new_d, new_i, new_valid, out_d, out_i,
              out_e, R, LA, LB, log2mb, out_w);
      return static_cast<int>(cudaGetLastError());
    });
  }
  const int M = 1 << log2m;
  const int half = M / 2;
  const int per_block = kSmemThreads / half > 0 ? kSmemThreads / half : 1;
  const int rows = R < per_block ? R : per_block;
  const size_t smem =
      static_cast<size_t>(3 * M + 3 * (1 << log2mb)) * rows * sizeof(float);
  merge_unsorted_smem_kernel<<<(R + rows - 1) / rows, rows * half, smem, st>>>(
      cand_d, cand_i, cand_e, new_d, new_i, new_valid, out_d, out_i, out_e, R,
      LA, LB, M, log2m, log2mb, out_w, rows);
  return static_cast<int>(cudaGetLastError());
}
