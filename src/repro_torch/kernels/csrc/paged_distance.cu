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
// What bounds it on this card: bytes and operations about equally at the
// search path's shape (T 4320, QB 8, P 64, d 128: 35 MB, 10.5 us at
// 3.35 TB/s; 0.57 GFLOP, 8.5 us at the f32 FMA peak of 67 TFLOP/s); bytes
// at the router's (T 8, QB 2048, P 8: 9 MB of queries against 0.03 GFLOP)
// and the tiered sessions' (T 456 over 192 frames: 8.4 MB). The last two
// have few tiles, so a design whose parallelism comes from the tiles
// leaves most of the card idle there. In practice neither alone bounds
// it at the search's shape: 4 x 4 tiles read shared memory a third less
// per FMA than 2 x 4 ones and gained 2-3%; the rest is latency, not
// split further (the card gives no counters here).
//
// Design:
// - Work items over flat query rows. The T * QB query rows, tile after
//   tile, are cut into gridDim.x slices of equal length (block b takes
//   rows [M b / B, M (b + 1) / B)); the wrapper's launch_plan takes B
//   from the shapes and the SM count alone (one wave: the blocks that
//   fit on the card at once, fewer only when there are fewer rows), so
//   the grid grows with T * QB: 264 blocks at the router's, tiered and
//   search shapes, two to an SM. Page ids are device data (the captured
//   chunks read no ids on the host), so a block finds its page runs
//   itself: a step is at most MQ rows of its slice whose tiles share one
//   page id (a warp ballot over the next 32 tiles' ids finds where the
//   run ends). Blocks whose slices meet the same page each stage it; the
//   L2 serves the repeats.
// - Thread tiles scaled with P and with the rows a block has. A thread
//   owns PT page rows (r, r + NPG, ...) x QT query rows (g, g + NQG,
//   ..., interleaved so that the query rows a warp reads fall in distinct
//   banks), NPG = P / PT rounded up to a power of two (at most 256),
//   NQG = 256 / NPG query groups, QT in {1, 2, 4}; PT is a template
//   argument, the rest the plan's choice. Where every block of a wave
//   has a full step of 64 rows (the search's many tiles) and the page
//   fits whole, the plan takes PT 4 and a step of MQ = NQG * QT ~ 64
//   rows: P 64 takes 4 x 4 tiles, 8 shared-memory reads per 64 FMAs.
//   Else PT 2 and MQ ~ 32: P 64 takes 2 x 4 tiles over 32 rows, P 8
//   2 x 1 tiles over 64 rows, so all 256 threads hold a task at the
//   router's and tiered shapes, whose blocks have few rows. A step with
//   fewer rows computes only the rows it has (the thread's row count is
//   a template argument chosen per step, the same for the whole block),
//   and a warp whose query rows all lie past them skips the step. P above
//   PT * 256 is walked in sub-pages. Tiles of 2 x 8 and 4 x 8 were slower
//   on the card: with two page slots and 64 rows a step, or the
//   registers of 32 accumulators, one block of 8 warps fits an SM, too
//   few to hide the loads' latency.
// - Staging overlapped with compute. Two slots per operand and
//   cp.async with one commit group per step: while step k computes from
//   its slots, step k + 1's query rows, and its page when the page
//   changes, load into the other slots (cp.async.wait_group 1). The one
//   exception is an f32 page at PT 4: two slots of it would leave one
//   block to an SM, so it has one, and a new page loads into it once
//   step k is done with it (about once a block on the search's sorted
//   ids). The whole d is staged when the slots fit a block's share of an
//   SM (P 64, d 128: 99 KiB either way, two blocks to an SM); otherwise
//   d is walked in chunks (d 784: 136 wide), each chunk a step of its
//   own, and the accumulators carry across them. Inside a step the
//   loads of the next 4 columns are issued before the FMAs of the
//   current ones. f32 rows: 16-byte copies (4-byte ones with a
//   zero-filled tail when d % 4 != 0 or a pointer is not 16-byte
//   aligned), padded to a pitch p with p / 4 odd, so that 16-byte reads
//   of 8 neighbouring rows fall in distinct banks. qq and vnorm are
//   loaded while the step computes.
// - bf16 operands. Their slots hold raw rows at an odd number of 8-byte
//   units (8-byte copies), so that 8-byte reads of 16 neighbouring rows
//   fall in distinct banks. A bf16 page is read raw by the compute loop,
//   which upcasts it in registers (a 16-bit shift); two raw slots take
//   one f32 slot's bytes, so it is double-buffered at PT 4 too. bf16
//   query rows are upcast once a step into an f32 buffer that the loop
//   reads (the buffer and two raw slots take two f32 slots' bytes), at
//   the cost of a pass and a barrier: upcasting both operands in the
//   loop cost more. So the plan does not depend on the types. The upcast
//   is exact, so a bf16 launch gives the bits of the f32 launch on
//   q.float() and db.float(). When d % 8 != 0 or a pointer is not
//   16-byte aligned the rows are copied with plain loads, one value per
//   load, when the step is issued.
// - Bits. Each output is one sequential __fmaf_rn chain over ascending
//   d from 0 (across d-chunks too), and the result is
//   (qq - 2 * dot) + vnorm: the same bits on any input for any tiling, so
//   the search path's counts do not depend on the design. No tensor
//   cores, no TF32: on integer-valued inputs every step is exact.
//
// Registers and spills (nvcc -Xptxas -v, sm_90a, in chip_smoke.py's
// build phase): PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;  // the wrapper's MAX_BLOCKS_PER_SM
constexpr int kQTMax = 4;        // query rows of a thread, at most
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Row pitch (floats) of a staged f32 d-chunk of width dc: p / 4 odd, so
// that 16-byte reads of 8 neighbouring rows fall in distinct banks.
__host__ __device__ __forceinline__ int row_pitch(int dc) {
  return 4 * ((dc / 4) | 1);
}

// The row pitch, in elements, of a staged d-chunk of type T: bf16 rows
// take an odd number of 8-byte units, half an f32 row's bytes, so two
// bf16 slots fit in one f32 slot and the plan's shared memory does not
// depend on the types.
template <typename T>
__device__ __forceinline__ int elem_pitch(int dc) {
  return row_pitch(dc);
}
template <>
__device__ __forceinline__ int elem_pitch<__nv_bfloat16>(int dc) {
  return 4 * ((((dc + 3) & ~3) / 4) | 1);
}

// 4 consecutive values of a staged row, as they sit in shared memory
// (load) and as f32 (up). bf16 -> f32 is a 16-bit shift: of a 32-bit
// word holding two bf16 values, element 0 is the low half; exact.
template <typename T>
struct Four {
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static float4 up(Raw v) { return v; }
};
template <>
struct Four<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ static float4 up(Raw v) {
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
};

// Asynchronous copies of columns [c0, c0 + w) of n rows of src (row
// stride ld) into dst (row pitch `pitch`, in elements), one warp per row:
// with `vec` (w a whole number of 16-byte runs, src 16-byte aligned),
// 16-byte copies of f32 rows and 8-byte ones of bf16 rows. Otherwise f32
// rows take 4-byte copies and bf16 ones plain loads (the slot is free,
// and the caller's wait and barrier come before any read), and columns
// [w, w4) are zero-filled.
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* src, long ld, int n,
                                           int c0, int w, int w4, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps) {
    const float* g = src + r * ld + c0;
    float* o = dst + r * pitch;
    if (vec) {
      for (int c = 4 * lane; c < w; c += 128) cp_async16(o + c, g + c);
    } else {
      for (int c = lane; c < w4; c += 32) {
        if (c < w) cp_async4(o + c, g + c);
        else o[c] = 0.0f;
      }
    }
  }
}

__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int pitch,
                                           const __nv_bfloat16* src, long ld,
                                           int n, int c0, int w, int w4,
                                           bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps) {
    const __nv_bfloat16* g = src + r * ld + c0;
    __nv_bfloat16* o = dst + r * pitch;
    if (vec) {
      for (int c = 4 * lane; c < w; c += 128) cp_async8(o + c, g + c);
    } else {
      for (int c = lane; c < w4; c += 32)
        o[c] = c < w ? g[c] : __float2bfloat16(0.0f);
    }
  }
}

// One step of a block: n query rows from flat row m0, whose tiles share
// page pid, against page rows [sub * PR, sub * PR + PR) and columns
// [c0, c0 + dc) of d. The page sits in page slot ps, staged for this
// step when new_page.
struct Step {
  long m0;
  int n, pid, sub, c0, ps;
  bool new_page;
};

// The rows of [m0, end) whose tiles carry m0's tile's page id: the warp
// ballots over 32 tiles at a time for the first id that differs. Every
// thread of the block calls it with the same arguments.
__device__ __forceinline__ int run_rows(const int* __restrict__ page_ids,
                                        long m0, long end, int QB,
                                        int* pid) {
  const long t0 = m0 / QB, t_last = (end - 1) / QB;
  const int id = page_ids[t0];
  const int lane = threadIdx.x % 32;
  long stop = t_last + 1;
  for (long t = t0 + 1; t <= t_last; t += 32) {
    const long tt = t + lane;
    const unsigned diff =
        __ballot_sync(0xffffffffu, tt <= t_last && page_ids[tt] != id);
    if (diff) {
      stop = t + __ffs(diff) - 1;
      break;
    }
  }
  *pid = id;
  return static_cast<int>(min(end, stop * QB) - m0);
}

// acc[i][j] += the dot of query row g + j * nqg (qa + j * qs) with page
// row r + i * npg (pa + i * ps) over columns [0, w4), for i < PT and
// j < J: one __fmaf_rn after another over ascending columns. The loads of
// the next 4 columns are issued before the products of the current ones,
// so that their latency hides behind PT * J * 4 FMAs; bf16 rows are
// upcast as their values are used.
template <int PT, int J, typename TQ, typename TD>
__device__ __forceinline__ void dot_rows(float (&acc)[PT][kQTMax],
                                         const TD* pa, int ps,
                                         const TQ* qa, int qs, int w4) {
  using FD = Four<TD>;
  using FQ = Four<TQ>;
  typename FD::Raw a[PT];
  typename FQ::Raw x[J];
#pragma unroll
  for (int i = 0; i < PT; ++i) a[i] = FD::load(pa + i * ps);
#pragma unroll
  for (int j = 0; j < J; ++j) x[j] = FQ::load(qa + j * qs);
#pragma unroll 2
  for (int c = 0; c < w4; c += 4) {
    const int cn = c + 4 < w4 ? c + 4 : c;   // the last: its own again
    typename FD::Raw an[PT];
    typename FQ::Raw xn[J];
#pragma unroll
    for (int i = 0; i < PT; ++i) an[i] = FD::load(pa + i * ps + cn);
#pragma unroll
    for (int j = 0; j < J; ++j) xn[j] = FQ::load(qa + j * qs + cn);
    float4 af[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) af[i] = FD::up(a[i]);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 xf = FQ::up(x[j]);
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        acc[i][j] = __fmaf_rn(xf.x, af[i].x, acc[i][j]);
        acc[i][j] = __fmaf_rn(xf.y, af[i].y, acc[i][j]);
        acc[i][j] = __fmaf_rn(xf.z, af[i].z, acc[i][j]);
        acc[i][j] = __fmaf_rn(xf.w, af[i].w, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < PT; ++i) a[i] = an[i];
#pragma unroll
    for (int j = 0; j < J; ++j) x[j] = xn[j];
  }
}

// dot_rows<PT, jn>: J runs over the query-row counts a thread may have.
template <int PT, int J = 1, typename TQ, typename TD>
__device__ __forceinline__ void dot_rows_n(int jn, float (&acc)[PT][kQTMax],
                                           const TD* pa, int ps,
                                           const TQ* qa, int qs, int w4) {
  if constexpr (J < kQTMax) {
    if (jn == J) {
      dot_rows<PT, J>(acc, pa, ps, qa, qs, w4);
      return;
    }
    dot_rows_n<PT, J + 1>(jn, acc, pa, ps, qa, qs, w4);
  } else {
    dot_rows<PT, J>(acc, pa, ps, qa, qs, w4);
  }
}

template <typename TQ, typename TD, int PT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
paged_distance_kernel(const int* __restrict__ page_ids,
                      const TQ* __restrict__ q,
                      const float* __restrict__ qq,
                      const TD* __restrict__ db,
                      const float* __restrict__ vnorm,
                      float* __restrict__ out, int T, int QB, int P, int d,
                      int NP, int dc, int npg, int qt, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = row_pitch(dc);         // an f32 row's footprint
  const int nqg = kThreads / npg;          // query groups
  const int mq = nqg * qt;                 // query rows of a step
  const int pr = PT * npg;                 // page rows of a sub-page
  const int nsub = (P + pr - 1) / pr;
  const bool whole = dc >= d;              // d staged in one chunk
  // the page's slots: two (the next page loads while a step computes)
  // at PT 2, and of bf16 rows at PT 4, where two fit in one f32 slot;
  // one f32 slot for an f32 page at PT 4
  constexpr bool two = PT == 2 || std::is_same_v<TD, __nv_bfloat16>;
  const int pslots = PT == 2 ? 2 : 1;      // f32 slots' footprint
  const int pp = elem_pitch<TD>(dc), qp = elem_pitch<TQ>(dc);
  auto page_slot = [&](int s) {
    return reinterpret_cast<TD*>(smem) + s * pr * pp;
  };
  // the query rows: two slots of TQ rows; bf16 ones are upcast, a step
  // at a time, into an f32 buffer that the loop reads (the buffer first,
  // then the two raw slots: two f32 slots' bytes)
  constexpr bool q16 = std::is_same_v<TQ, __nv_bfloat16>;
  float* const qbuf = smem + pslots * pr * pitch;
  auto q_slot = [&](int s) {
    return q16 ? reinterpret_cast<TQ*>(qbuf + mq * pitch) + s * mq * qp
               : reinterpret_cast<TQ*>(qbuf + s * mq * pitch);
  };

  const long rows_all = static_cast<long>(T) * QB;
  const long begin = rows_all * blockIdx.x / gridDim.x;
  const long end = rows_all * (blockIdx.x + 1) / gridDim.x;
  if (begin >= end) return;

  const int r = threadIdx.x % npg, g = threadIdx.x / npg;
  auto clamp_page = [NP](int id) {
    return id < 0 ? 0 : (id >= NP ? NP - 1 : id);
  };
  auto page_rows = [&](const Step& s) { return min(pr, P - s.sub * pr); };
  auto stage_page = [&](const Step& s) {
    const int w = min(dc, d - s.c0), w4 = (w + 3) & ~3;
    stage_rows(page_slot(s.ps), pp,
               db + (static_cast<long>(s.pid) * P + s.sub * pr) * d, d,
               page_rows(s), s.c0, w, w4, vec);
  };
  // step s's query rows into query slot qslot, and its page into page
  // slot s.ps when the page is new and there are two page slots (with
  // one, the page is staged once step s - 1 is done with the slot)
  auto issue = [&](const Step& s, int qslot) {
    const int w = min(dc, d - s.c0), w4 = (w + 3) & ~3;
    if (s.new_page && two) stage_page(s);
    stage_rows(q_slot(qslot), qp, q + s.m0 * d, d, s.n, s.c0, w, w4, vec);
  };
  // the step after s, if the block has one
  auto advance = [&](const Step& s, Step* nx) {
    *nx = s;
    nx->new_page = true;
    nx->ps = two ? s.ps ^ 1 : 0;
    if (s.c0 + dc < d) {                   // the next d-chunk
      nx->c0 = s.c0 + dc;
      return true;
    }
    nx->c0 = 0;
    if (s.sub + 1 < nsub) {                // the next sub-page
      nx->sub = s.sub + 1;
      return true;
    }
    nx->sub = 0;
    nx->m0 = s.m0 + s.n;                   // the next query rows
    if (nx->m0 >= end) return false;
    int id;
    nx->n = run_rows(page_ids, nx->m0, min(nx->m0 + mq, end), QB, &id);
    nx->pid = clamp_page(id);
    if (whole && nsub == 1 && nx->pid == s.pid) {   // the page is staged
      nx->new_page = false;
      nx->ps = s.ps;
    }
    return true;
  };

  Step cur;
  {
    int id;
    cur.m0 = begin;
    cur.n = run_rows(page_ids, begin, min(begin + mq, end), QB, &id);
    cur.pid = clamp_page(id);
    cur.sub = cur.c0 = cur.ps = 0;
    cur.new_page = true;
  }
  issue(cur, 0);
  if (!two) stage_page(cur);
  cp_async_commit();

  float acc[PT][kQTMax];
  for (int k = 0;; ++k) {
    Step nxt;
    const bool more = advance(cur, &nxt);
    if (more) issue(nxt, (k + 1) & 1);
    cp_async_commit();

    // the query rows a thread computes: as many as the step's rows need
    // (the same for every thread, so no warp diverges)
    const int jn = min(qt, (cur.n + nqg - 1) / nqg);
    const int w = min(dc, d - cur.c0), w4 = (w + 3) & ~3;
    const int p0 = cur.sub * pr;
    const int prows = page_rows(cur);
    const bool last = cur.c0 + dc >= d;    // the last d-chunk: write out
    // the epilogue's operands, loaded while the step computes
    float qv[kQTMax], vv[PT];
    if (last) {
#pragma unroll
      for (int j = 0; j < kQTMax; ++j) {
        const int mm = g + j * nqg;
        qv[j] = j < jn && mm < cur.n ? qq[cur.m0 + mm] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int row = r + i * npg;
        vv[i] = row < prows ? vnorm[static_cast<long>(cur.pid) * P + p0 +
                                    row]
                            : 0.0f;
      }
    }

    cp_async_wait1();                      // step k's copies have landed
    __syncthreads();
    if constexpr (q16) {                   // upcast the step's query rows
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      const __nv_bfloat16* raw = q_slot(k & 1);
      for (int rr = warp; rr < cur.n; rr += kWarps)
        for (int c = 4 * lane; c < w4; c += 128)
          *reinterpret_cast<float4*>(qbuf + rr * pitch + c) =
              Four<__nv_bfloat16>::up(
                  Four<__nv_bfloat16>::load(raw + rr * qp + c));
      __syncthreads();
    }

    if (cur.c0 == 0) {
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int j = 0; j < kQTMax; ++j) acc[i][j] = 0.0f;
    }
    if (g < cur.n) {                       // else no query row here
      const TD* pa = page_slot(cur.ps) + r * pp;
      const float* qa = q16 ? qbuf + g * pitch
                            : reinterpret_cast<const float*>(q_slot(k & 1)) +
                                  g * pitch;
      // between a thread's page rows, and between its query rows
      dot_rows_n<PT>(jn, acc, pa, npg * pp, qa, nqg * pitch, w4);
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int row = r + i * npg;
        if (row >= prows) continue;
#pragma unroll
        for (int j = 0; j < kQTMax; ++j) {
          const int mm = g + j * nqg;
          if (j < jn && mm < cur.n) {
            const long m = cur.m0 + mm;
            // (qq - 2 * dot) + vnorm, in the reference's association
            const float x = __fsub_rn(qv[j], __fmul_rn(2.0f, acc[i][j]));
            out[m * P + p0 + row] = __fadd_rn(x, vv[i]);
          }
        }
      }
    }
    __syncthreads();                       // slots of step k are free
    if (!more) break;
    if (nxt.new_page && !two) {            // the one page slot is free
      stage_page(nxt);
      cp_async_commit();
    }
    cur = nxt;
  }
}

// Shared memory of one block: the page's pt * npg rows in two slots at
// pt 2 and one at pt 4, and two slots of the step's query rows, at the
// f32 pitch of d-chunk dc (the wrapper's kernels/distance/kernel.py
// smem_bytes).
size_t smem_bytes(int pt, int npg, int qt, int dc) {
  const int mq = (kThreads / npg) * qt;
  const int pslots = pt == 2 ? 2 : 1;
  return static_cast<size_t>(pslots * pt * npg + 2 * mq) * row_pitch(dc) *
         sizeof(float);
}

template <typename TQ, typename TD, int PT>
int launch(const int* page_ids, const void* q, const float* qq,
           const void* db, const float* vnorm, float* out, int T, int QB,
           int P, int d, int NP, int dc, int blocks, int npg, int qt,
           int vec, void* stream) {
  // the shared-memory attribute of this instantiation, raised once per
  // device to the largest size asked for (not on every launch: a launch
  // under graph capture sets nothing)
  static size_t attr[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= kMaxDevices))
    err = cudaErrorInvalidDevice;
  const size_t smem = smem_bytes(PT, npg, qt, dc);
  if (err == cudaSuccess && smem > attr[dev]) {
    err = cudaFuncSetAttribute(paged_distance_kernel<TQ, TD, PT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) attr[dev] = smem;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();    // a refused call leaves no error to later calls
    return static_cast<int>(err);
  }
  paged_distance_kernel<TQ, TD, PT><<<blocks, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      page_ids, static_cast<const TQ*>(q), qq, static_cast<const TD*>(db),
      vnorm, out, T, QB, P, d, NP, dc, npg, qt, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TD>
int dispatch(const int* page_ids, const void* q, const float* qq,
             const void* db, const float* vnorm, float* out, int T, int QB,
             int P, int d, int NP, int dc, int blocks, int npg, int qt,
             int pt, int vec, void* stream) {
  // the plans the kernel takes: a d-chunk of whole 16-byte runs of bf16
  // (raw slots stay aligned) unless it stages d whole
  if (npg < 1 || npg > kThreads || (npg & (npg - 1)) != 0 || qt < 1 ||
      qt > kQTMax || (qt & (qt - 1)) != 0 || (pt != 2 && pt != 4) ||
      dc < 4 || dc % 4 != 0 ||
      (dc < d && dc % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return pt == 4
             ? launch<TQ, TD, 4>(page_ids, q, qq, db, vnorm, out, T, QB, P,
                                 d, NP, dc, blocks, npg, qt, vec,
                                 stream)
             : launch<TQ, TD, 2>(page_ids, q, qq, db, vnorm, out, T, QB, P,
                                 d, NP, dc, blocks, npg, qt, vec,
                                 stream);
}

}  // namespace

// Plain C entry points for ctypes, one per (q, db) type pair: each
// launches `blocks` blocks of 256 threads on `stream` (the caller's
// current stream), allocates nothing, and returns the first CUDA error
// (a plan the kernel does not take, setting the shared-memory attribute,
// or cudaGetLastError() right after the launch) so that a refused launch
// is reported. The plan (kernels/distance/kernel.py launch_plan): dc,
// the d-chunk, a multiple of 4 (>= d stages d whole; a multiple of 8
// otherwise); npg, the page-row groups, a power of two <= 256; qt, the
// query rows of a thread, 1, 2 or 4; pt, its page rows, 2 (two page
// slots) or 4 (one); vec: 16-byte copies (d and the d-chunk a multiple of
// 16 bytes' worth of elements, q and db 16-byte aligned).
#define PAGED_DISTANCE_ENTRY(name, TQ, TD)                                 \
  extern "C" int name(const int* page_ids, const void* q, const float* qq, \
                      const void* db, const float* vnorm, float* out,      \
                      int T, int QB, int P, int d, int NP, int dc,         \
                      int blocks, int npg, int qt, int pt, int vec,        \
                      void* stream) {                                      \
    return dispatch<TQ, TD>(page_ids, q, qq, db, vnorm, out, T, QB, P, d,  \
                            NP, dc, blocks, npg, qt, pt, vec, stream);     \
  }

PAGED_DISTANCE_ENTRY(paged_distance_launch, float, float)
PAGED_DISTANCE_ENTRY(paged_distance_bf16q_launch, __nv_bfloat16, float)
PAGED_DISTANCE_ENTRY(paged_distance_bf16db_launch, float, __nv_bfloat16)
PAGED_DISTANCE_ENTRY(paged_distance_bf16q_bf16db_launch, __nv_bfloat16,
                     __nv_bfloat16)
