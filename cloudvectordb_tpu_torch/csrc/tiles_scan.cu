// Whole-row tile scan for Hopper (sm_90a), plain C interface: one entry
// point for the flat scan, the tile-table scan and the band scan.
//
// Replaces three Pallas kernels that compute the same thing and differ only
// in which arena tile a step reads:
//   ALL   cloudvectordb_tpu/ops/pallas_topk.py:117 flat_topk_pallas
//         (body _bucketed_topk_kernel :34): step j reads tile j;
//   TABLE cloudvectordb_tpu/ops/pallas_band.py:257 tiles_topk_pallas
//         (body _tiles_kernel :188): step j reads tile_table[qt, j];
//   BAND  cloudvectordb_tpu/ops/pallas_band.py:355 band_topk_pallas
//         (body _band_kernel :135): step j reads band_start[qt] + j.
// Built by cloudvectordb_tpu_torch/ops/_cuda.py with nvcc into a shared
// library and called through ctypes. The plain PyTorch version of the same
// contract is ops/band.py::_scan_reference.
//
// What it computes. Arena row g of the step's tile scores s = q . row[g]
// under the score mode, a pair of element types (queries, rows):
//   (int8, int8)   exact int32, then one rounding to f32;
//   (bf16, int8)   "hybrid": rows widened to bf16; products exact in f32,
//                  summed in f32;
//   (bf16, bf16)   products exact in f32, summed in f32;
//   (f32, f32)     f32 FMA (no TF32, no tensor cores);
//   (f32, bf16)    f32 queries against a bf16 store, rows widened to f32.
// (The CUDA-core body's top-2 sums the bf16 pairs in f64, one rounding to
// f32 at the end: closer to the exact score than an f32 sum, never
// farther.)
// With sqnorm (the flat index's l2) the score is 2 s - sqnorm[g]. Rows with
// g >= n_valid score -inf and are never read, so a ragged database needs no
// padded copy. Each query keeps L = l_buckets slots, merged as
// csrc/slot_merge.cuh says; with top2 (source TABLE, the reference's
// tiles_topk_pallas(top2=True)) two a slot, its best two distinct rows:
// on the tensor-core body's narrow block (tc_scan.cuh's TOP2) where its
// state fits shared memory, else on the CUDA-core body (the f32 pairs, and
// tensor-core pairs too deep for resident queries). The final top-k over
// the slots is the caller's.
//
// Three bodies. The TPU walks the steps as a sequential grid axis and
// carries the slots in VMEM; here one block owns some queries of one query
// tile and some consecutive slots, keeps their running (max, row), and loops
// over the steps itself, so no ordering between blocks is needed. Query
// blocks are the fastest grid index in the first two, so the blocks that
// read the same rows run together and share them in L2.
//
// The tensor-core body (csrc/tc_scan.cuh, shared with K1) takes the first
// three pairs from every source: K2 over int8 and bf16 rows, K3 and K7 on
// every main path. Each step is a small GEMM, the block's rows by its
// queries over the whole depth, on mma.sync (IMMA for int8, HMMA for bf16
// queries). What bounds it on an H100: K3 (hybrid, tile_q 32, p 96 at D
// 768) does 32 multiply-adds a byte of rows, far below the tensor cores'
// ridge, so the rows' bytes bound it (9.5 GB of distinct tiles, 2.8 ms at
// 3.35 TB/s); K7 (int8, tile_q 256, a band of the whole arena) and K2 int8
// (1M x 768 against 4096 queries: 6.4e12 int8 operations, 3.3 ms at the
// int8 peak, against 0.8 GB of rows) are operations-bound. The queries stay
// in shared memory, the rows stream through a cp.async ring, and a wide
// block (128 int8 queries x 64 rows) serves tile_q >= 128 (K7; K2, whose
// one query tile is the whole batch), so each row fetched from L2 feeds 128
// queries. The l2 bias joins the score in the merge.
//
// The f32 body (tiles_f32_kernel) takes the f32 pairs from every source:
// their contract is f32 FMA, which TF32 or 3xTF32 would round otherwise, so
// the f32 peak of 67 T flop/s bounds them (K2 f32 l2 at 1M x 128 against
// 10,000 queries: 2.6e12 flop, 38.2 ms). It is a register-tiled SIMT GEMM:
// a block of 256 threads takes 128 queries x 128 slots, each thread 8 x 8
// (query, slot) sums in registers; the depth streams in 32-dim chunks
// through a 3-stage ring, queries and rows row-major by 16-byte cp.async
// (8 a thread a chunk); the products go four dims at a time, each slot's
// four dims and then each query's one 16-byte shared load, 16 loads per
// 256 FMAs (the CUDA-core body below: 6 per 8). On an H100 it runs at
// about half the f32 peak; transposed stages by 4-byte cp.async (32 copies
// a thread a chunk) measured 17% slower, an 8 x 4 tile 10% slower still
// (PERF.md). The merge and the l2 bias run in registers once per (step, r);
// the best values stay in registers (up to 255 of them a thread, one block
// an SM) and the best rows in shared memory, written only when a value
// improves.
//
// The CUDA-core body (tiles_scan_kernel) takes what neither takes: a
// tensor-core pair whose resident queries would not fit in shared memory (D
// above 2,752 for bf16 queries, 5,504 for int8), and every top-2 call the
// narrow block cannot take: the f32 pairs (f32 FMA, no TF32, as their top-1
// body), the deep tensor-core pairs, and a tile state too large at the
// given tile_n / l_buckets. 256 threads over 32 queries x 64 slots stage
// rows and queries in chunks and score with dp4a (exact int32) or FMAs:
// f32 for top-1 and for the f32 pairs (their contract), f64 for the bf16
// pairs' top-2 (exact products and sums, one rounding to f32: the hybrid
// pair's raw scores reach the thousands at D 3072, where an f32 chain
// drifts past the exact score by 3.8e-3, and the top-2 holds compare with
// the exact score); with TOP2 each
// thread's 8 (query, slot) pairs keep the tile's best and runner-up in
// registers (tile_take2) and merge them into both slots (slot_merge2) after
// the tile's last r. It is right, not fast (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "slot_merge.cuh"
#include "tc_scan.cuh"

namespace {

enum Source { ALL = 0, TABLE = 1, BAND = 2 };
enum ElemType { F32 = 0, BF16 = 1, I8 = 2 };

template <int SRC>
__device__ __forceinline__ int step_tile(const int32_t* table, int qt, int steps, int j) {
  if (SRC == ALL) return j;
  if (SRC == TABLE) return table[(size_t)qt * steps + j];
  return table[qt] + j;  // BAND: band_start[qt] + j
}

// ---- the CUDA-core body: the tensor-core pairs whose resident queries
// would not fit in shared memory ------------------------------------------

constexpr int QB = 32;            // queries per block
constexpr int SB = 64;            // slots per block
constexpr int TX = 16;            // threads along slots
constexpr int TY = 16;            // threads along queries
constexpr int THREADS = TX * TY;  // 256
constexpr int QPT = QB / TY;      // queries per thread
constexpr int SPT = SB / TX;      // slots per thread
constexpr int KC = 64;            // 32-bit words per staged row chunk
constexpr int STRIDE = KC + 1;    // odd word stride: conflict-free columns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// Four int8 values p[e..e+3] as one little-endian word, zero at and past
// e_end; one aligned word load when the row width is a multiple of 4.
__device__ __forceinline__ int32_t load_i8x4(const int8_t* p, int e, int e_end,
                                             bool aligned) {
  if (aligned && e + 4 <= e_end) return *reinterpret_cast<const int32_t*>(p + e);
  uint32_t w = 0;
  for (int b = 0; b < 4; ++b)
    if (e + b < e_end) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[e + b])) << (8 * b);
  return static_cast<int32_t>(w);
}

// Dot products of the block's queries with the SB rows row0 .. row0+SB-1,
// accumulated into acc over the whole row width in chunks; the float pairs
// in f64 when F64, else in f32.
template <typename QT, typename RT, bool F64>
__device__ __forceinline__ void score_rows(const QT* __restrict__ q, const RT* __restrict__ db,
                                           uint32_t* smem, int q_lo, int nq_blk,
                                           long long row0, int n_rows_blk, int d,
                                           float (&out)[QPT][SPT]) {
  constexpr bool kInt8 = std::is_same<QT, int8_t>::value && std::is_same<RT, int8_t>::value;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  if constexpr (kInt8) {
    int32_t* q_s = reinterpret_cast<int32_t*>(smem);  // QB x STRIDE words
    int32_t* r_s = q_s + QB * STRIDE;                 // SB x STRIDE words
    const bool aligned = (d % 4) == 0;
    int acc[QPT][SPT] = {};
    for (int e0 = 0; e0 < d; e0 += 4 * KC) {
      const int kn = min(KC, (d - e0 + 3) / 4);
      __syncthreads();  // the previous chunk is done with the staged words
      for (int i = tid; i < QB * KC; i += THREADS) {
        const int qi = i / KC, k = i % KC;
        q_s[qi * STRIDE + k] = (qi < nq_blk && k < kn)
            ? load_i8x4(q + (size_t)(q_lo + qi) * d, e0 + 4 * k, d, aligned) : 0;
      }
      for (int i = tid; i < SB * KC; i += THREADS) {
        const int ri = i / KC, k = i % KC;
        r_s[ri * STRIDE + k] = (ri < n_rows_blk && k < kn)
            ? load_i8x4(db + (size_t)(row0 + ri) * d, e0 + 4 * k, d, aligned) : 0;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        int a[QPT], b[SPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) a[i] = q_s[(ty + TY * i) * STRIDE + k];
#pragma unroll
        for (int j = 0; j < SPT; ++j) b[j] = r_s[(tx + TX * j) * STRIDE + k];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < SPT; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) out[i][j] = __int2float_rn(acc[i][j]);
  } else {
    // with F64 every bf16 and int8 product is exact and so is the sum, to
    // one rounding to f32
    using Acc = typename std::conditional<F64, double, float>::type;
    float* q_s = reinterpret_cast<float*>(smem);  // QB x STRIDE
    float* r_s = q_s + QB * STRIDE;               // SB x STRIDE
    Acc acc[QPT][SPT] = {};
    for (int e0 = 0; e0 < d; e0 += KC) {
      const int kn = min(KC, d - e0);
      __syncthreads();
      for (int i = tid; i < QB * KC; i += THREADS) {
        const int qi = i / KC, k = i % KC;
        q_s[qi * STRIDE + k] = (qi < nq_blk && k < kn)
            ? to_f32(q[(size_t)(q_lo + qi) * d + e0 + k]) : 0.f;
      }
      for (int i = tid; i < SB * KC; i += THREADS) {
        const int ri = i / KC, k = i % KC;
        r_s[ri * STRIDE + k] = (ri < n_rows_blk && k < kn)
            ? to_f32(db[(size_t)(row0 + ri) * d + e0 + k]) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        Acc a[QPT], b[SPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) a[i] = q_s[(ty + TY * i) * STRIDE + k];
#pragma unroll
        for (int j = 0; j < SPT; ++j) b[j] = r_s[(tx + TX * j) * STRIDE + k];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            if constexpr (F64) acc[i][j] = fma(a[i], b[j], acc[i][j]);
            else acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) out[i][j] = static_cast<float>(acc[i][j]);
  }
}

template <int SRC, typename QT, typename RT, bool TOP2>
__global__ void __launch_bounds__(THREADS)
tiles_scan_kernel(const RT* __restrict__ db,         // (N, D) rows
                  const QT* __restrict__ q,          // (Q, D) queries
                  const int32_t* __restrict__ table,  // TABLE (n_qt, steps), BAND (n_qt,)
                  const float* __restrict__ sqnorm,   // (N,) or null: l2 bias
                  float* __restrict__ out_v,          // (Q, L)
                  int32_t* __restrict__ out_i,        // (Q, L)
                  float* __restrict__ out_v2,         // top-2: (Q, L) slot 2
                  int32_t* __restrict__ out_i2,
                  int tile_q, int steps, int tile_n, int l_buckets, int d,
                  int n_valid) {
  __shared__ __align__(16) uint32_t smem[(QB + SB) * STRIDE];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int qblocks = (tile_q + QB - 1) / QB;
  const int qt = blockIdx.y / qblocks;
  const int q_lo = qt * tile_q + (blockIdx.y % qblocks) * QB;
  const int nq_blk = min(QB, (qt + 1) * tile_q - q_lo);
  const int b0 = blockIdx.x * SB;
  const int r_per = tile_n / l_buckets;
  constexpr int K2 = TOP2 ? 2 : 1;  // slot ranks kept
  constexpr bool F64 = TOP2 && !std::is_same<QT, float>::value;  // see the header

  float best_v[K2][QPT][SPT];
  int best_i[K2][QPT][SPT];
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) slot_init(best_v[k][i][j], best_i[k][i][j]);

  for (int j = 0; j < steps; ++j) {
    const long long base = (long long)step_tile<SRC>(table, qt, steps, j) * tile_n;
    float tmx[K2][QPT][SPT];  // the tile's best (and runner-up) value
    int tr[K2][QPT][SPT];     // and its r
    for (int r = 0; r < r_per; ++r) {
      const long long row0 = base + (long long)r * l_buckets + b0;
      // rows of this block that exist and are live: slots below L, rows in
      // [0, n_valid); the rest are neither read nor ranked
      const long long live_hi = min((long long)min(SB, l_buckets - b0), (long long)n_valid - row0);
      const int n_rows_blk = row0 < 0 ? 0 : (int)max(0LL, live_hi);
      float s[QPT][SPT];
      score_rows<QT, RT, F64>(q, db, smem, q_lo, nq_blk, row0, n_rows_blk, d, s);
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int jj = 0; jj < SPT; ++jj) {
          const int sj = tx + TX * jj;
          float sc = -INFINITY;
          if (sj < n_rows_blk) {
            sc = s[i][jj];
            if (sqnorm != nullptr) sc = __fsub_rn(2.f * sc, sqnorm[row0 + sj]);
          }
          if constexpr (TOP2)
            tile_take2(sc, r, tmx[0][i][jj], tr[0][i][jj], tmx[1][i][jj], tr[1][i][jj]);
          else
            tile_take(sc, r, tmx[0][i][jj], tr[0][i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj) {
        const long long slot_row = base + b0 + tx + TX * jj;
        const long long row = slot_row + (long long)tr[0][i][jj] * l_buckets;
        if constexpr (TOP2)
          slot_merge2(tmx[0][i][jj], row, tmx[1][i][jj],
                      slot_row + (long long)tr[1][i][jj] * l_buckets, best_v[0][i][jj],
                      best_i[0][i][jj], best_v[1][i][jj], best_i[1][i][jj]);
        else
          slot_merge(tmx[0][i][jj], row, best_v[0][i][jj], best_i[0][i][jj]);
      }
  }

#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int qi = ty + TY * i, b = b0 + tx + TX * jj;
      if (qi < nq_blk && b < l_buckets) {
        const size_t o = (size_t)(q_lo + qi) * l_buckets + b;
        out_v[o] = best_v[0][i][jj];
        out_i[o] = best_i[0][i][jj];
        if constexpr (TOP2) {
          out_v2[o] = best_v[1][i][jj];
          out_i2[o] = best_i[1][i][jj];
        }
      }
    }
}

template <int SRC, typename QT, typename RT, bool TOP2 = false>
cudaError_t launch(const void* db, const void* q, const void* table, const void* sqnorm,
                   void* out_v, void* out_i, void* out_v2, void* out_i2, int n_qt,
                   int tile_q, int steps, int tile_n, int l_buckets, int d, int n_valid,
                   cudaStream_t stream) {
  const int qblocks = (tile_q + QB - 1) / QB;
  const dim3 grid((l_buckets + SB - 1) / SB, n_qt * qblocks);
  tiles_scan_kernel<SRC, QT, RT, TOP2><<<grid, THREADS, 0, stream>>>(
      static_cast<const RT*>(db), static_cast<const QT*>(q),
      static_cast<const int32_t*>(table), static_cast<const float*>(sqnorm),
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i), static_cast<float*>(out_v2),
      static_cast<int32_t*>(out_i2), tile_q, steps, tile_n, l_buckets, d, n_valid);
  return cudaGetLastError();
}

// The CUDA-core body's top-1 scans: the tensor-core pairs, every source.
template <int SRC>
cudaError_t launch_types(int qtype, int rtype, const void* db, const void* q,
                         const void* table, const void* sqnorm, void* out_v, void* out_i,
                         int n_qt, int tile_q, int steps, int tile_n, int l_buckets, int d,
                         int n_valid, cudaStream_t stream) {
#define CVDB_SCAN(QT, RT) \
  launch<SRC, QT, RT>(db, q, table, sqnorm, out_v, out_i, nullptr, nullptr, n_qt, tile_q, \
                      steps, tile_n, l_buckets, d, n_valid, stream)
  if (qtype == I8 && rtype == I8) return CVDB_SCAN(int8_t, int8_t);
  if (qtype == BF16 && rtype == I8) return CVDB_SCAN(__nv_bfloat16, int8_t);
  if (qtype == BF16 && rtype == BF16) return CVDB_SCAN(__nv_bfloat16, __nv_bfloat16);
#undef CVDB_SCAN
  return cudaErrorInvalidValue;
}

// The CUDA-core body's top-2 scans (K3: source TABLE), every pair K3 takes.
cudaError_t launch_types_top2(int qtype, int rtype, const void* db, const void* q,
                              const void* table, const void* sqnorm, void* out_v, void* out_i,
                              void* out_v2, void* out_i2, int n_qt, int tile_q, int steps,
                              int tile_n, int l_buckets, int d, int n_valid,
                              cudaStream_t stream) {
#define CVDB_SCAN2(QT, RT) \
  launch<TABLE, QT, RT, true>(db, q, table, sqnorm, out_v, out_i, out_v2, out_i2, n_qt, \
                              tile_q, steps, tile_n, l_buckets, d, n_valid, stream)
  if (qtype == I8 && rtype == I8) return CVDB_SCAN2(int8_t, int8_t);
  if (qtype == BF16 && rtype == I8) return CVDB_SCAN2(__nv_bfloat16, int8_t);
  if (qtype == BF16 && rtype == BF16) return CVDB_SCAN2(__nv_bfloat16, __nv_bfloat16);
  if (qtype == F32 && rtype == F32) return CVDB_SCAN2(float, float);
  if (qtype == F32 && rtype == BF16) return CVDB_SCAN2(float, __nv_bfloat16);
#undef CVDB_SCAN2
  return cudaErrorInvalidValue;
}

// ---- the rows a (step, r) reads, for the tensor-core and f32 bodies ----

// The arena row of slot 0 of a block of `sb` slots at b0, and how many of
// them are live: below L and in [0, n_valid); the rest are neither read nor
// ranked.
template <int SRC>
__device__ __forceinline__ RowBlock whole_rows(const int32_t* table, int steps, int tile_n,
                                               int l_buckets, int n_valid, int qt, int b0,
                                               int sb, int j, int r) {
  RowBlock x;
  const long long base = (long long)step_tile<SRC>(table, qt, steps, j) * tile_n;
  x.row0 = base + (long long)r * l_buckets + b0;
  const long long hi = min((long long)min(sb, l_buckets - b0), (long long)n_valid - x.row0);
  x.n_rows = x.row0 < 0 ? 0 : (int)max(0LL, hi);
  return x;
}

// ---- the tensor-core body: (int8, int8), (bf16, int8) and (bf16, bf16) ---

// The whole-row epilogue of tc_scan.cuh: no side data; a live pair's score
// is its product (int8: rounded once to f32), with the l2 bias.
template <int SRC>
struct WholeRow {
  const int32_t* table;
  const float* sqnorm;  // (N,) or null: l2 bias
  int steps, tile_n, l_buckets, n_valid, sb;
  static constexpr int side = 0;

  __device__ RowBlock rows(int qt, int b0, int j, int r) const {
    return whole_rows<SRC>(table, steps, tile_n, l_buckets, n_valid, qt, b0, sb, j, r);
  }

  __device__ void load_side(unsigned char*, const RowBlock&, int, int, int, int) const {}

  template <typename T>
  __device__ float score(T raw, int slot, int, const RowBlock& x, const unsigned char*) const {
    if (slot >= x.n_rows) return -INFINITY;
    float s;
    if constexpr (std::is_same<T, int>::value)
      s = __int2float_rn(raw);
    else
      s = raw;
    if (sqnorm != nullptr) s = __fsub_rn(2.f * s, sqnorm[x.row0 + slot]);
    return s;
  }
};

struct TcArgs {
  TcScan s;
  const int32_t* table;  // TABLE (n_qt, steps), BAND (n_qt,)
  const float* sqnorm;
  int n_valid;
};

template <int SRC, int PAIR, class C, bool TOP2 = false>
__global__ void __launch_bounds__(TC_THREADS, C::MT == 1 ? 2 : 1)
tiles_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WholeRow<SRC> epi{a.table, a.sqnorm, a.s.steps, a.s.tile_n, a.s.l_buckets, a.n_valid,
                          C::SB};
  tc_scan<PAIR, C, TOP2>(a.s, epi, smem);
}

// ---- the f32 body: (f32, f32) and (f32, bf16), f32 FMA on the CUDA cores --

// A block of 256 threads scores F_SB consecutive slots for F_QB queries.
// Thread (tx, ty) (tx = lane % 8 + 8 (warp % 2), ty = lane / 8 + 4 (warp /
// 2), both 0..15) holds queries ty + 16 i against slots tx + 16 j, i, j <
// 8. A stage holds F_KD dims of the block's queries (f32) and rows (f32 or
// bf16), row-major: each row at a stride of 16 bytes mod 128, so the eight
// rows a quarter-warp reads at one depth lie in distinct banks.
constexpr int F_QB = 128, F_SB = 128, F_KD = 32, F_STAGES = 3;
constexpr int F_QSTR = 4 * (F_KD + 4);  // bytes between two staged queries

// Bytes between two staged rows of elements of `esize` bytes.
__host__ __device__ inline int f32_row_stride(int esize) { return esize * F_KD + 16; }

// Bytes of one stage, and of the whole layout: F_STAGES stages, then the
// best rows (F_QB x F_SB ints).
__host__ __device__ inline int f32_stage_bytes(int esize) {
  return F_QB * F_QSTR + F_SB * f32_row_stride(esize);
}
__host__ __device__ inline int f32_smem_bytes(int esize) {
  return F_STAGES * f32_stage_bytes(esize) + 4 * F_QB * F_SB;
}

// The largest of 16, 8 and 4 that divides `bytes` (a row's width, so every
// piece of every row is aligned to it), else 0: byte loads.
__host__ __device__ inline int copy_size(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 0;
}

struct F32Args {
  const unsigned char* db;  // (N, D) rows, f32 or bf16
  const float* q;           // (Q, D)
  const int32_t* table;     // TABLE (n_qt, steps), BAND (n_qt,)
  const float* sqnorm;      // (N,) or null: l2 bias
  float* out_v;             // (Q, L)
  int32_t* out_i;
  int tile_q, steps, tile_n, l_buckets, d, n_valid;
  int copy, q_copy;  // copy_size of a row and of a query
};

// Bytes off0 .. off0 + span of `n` rows of row_bytes each from src into
// dst (rows `stride` bytes apart), zero past a row's end: cp.async of
// `size` bytes, or 4-byte words assembled from byte loads (size 0).
__device__ __forceinline__ void stage_rows(unsigned char* dst, int stride,
                                           const unsigned char* src, int row_bytes, int n,
                                           int off0, int span, int size) {
  const int piece = size ? size : 4;
  const int shift = __ffs(span / piece) - 1;  // pieces a row: a power of two
  for (int i = threadIdx.x; i < (n << shift); i += TC_THREADS) {
    const int ri = i >> shift, c = (i & ((1 << shift) - 1)) * piece;
    const unsigned char* row = src + (size_t)ri * row_bytes;
    const int off = off0 + c, m = max(0, min(piece, row_bytes - off));
    if (size) {
      cp_async_zfill(dst + ri * stride + c, m ? row + off : row, size, m);
    } else {
      uint32_t v = 0;
      for (int b = 0; b < m; ++b) v |= static_cast<uint32_t>(row[off + b]) << (8 * b);
      *reinterpret_cast<uint32_t*>(dst + ri * stride + c) = v;
    }
  }
}

// Dims 4 k4 .. 4 k4 + 3 of a staged row, as f32.
__device__ __forceinline__ float4 row_dims(const unsigned char* row, int k4, float) {
  return *reinterpret_cast<const float4*>(row + 16 * k4);
}
__device__ __forceinline__ float4 row_dims(const unsigned char* row, int k4, __nv_bfloat16) {
  const uint2 w = *reinterpret_cast<const uint2*>(row + 8 * k4);  // a bf16 is the high half of its f32
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

template <int SRC, typename RT>
__global__ void __launch_bounds__(TC_THREADS, 1)
tiles_f32_kernel(const F32Args a) {
  constexpr int ES = sizeof(RT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_bytes = f32_stage_bytes(ES), rstride = f32_row_stride(ES);
  int32_t* best_i = reinterpret_cast<int32_t*>(smem + F_STAGES * stage_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = (lane & 7) + 8 * (warp & 1), ty = (lane >> 3) + 4 * (warp >> 1);
  const int qblocks = (a.tile_q + F_QB - 1) / F_QB;
  const int qt = blockIdx.x / qblocks;
  const int q_lo = qt * a.tile_q + (blockIdx.x - qt * qblocks) * F_QB;
  const int nq_blk = min(F_QB, (qt + 1) * a.tile_q - q_lo);
  const int b0 = blockIdx.y * F_SB;
  const int R = a.tile_n / a.l_buckets;
  const int n_kc = (a.d + F_KD - 1) / F_KD;
  const long long total = (long long)a.steps * R * n_kc;
  const int row_bytes = a.d * ES;
  auto rows = [&](int j, int r) {
    return whole_rows<SRC>(a.table, a.steps, a.tile_n, a.l_buckets, a.n_valid, qt, b0, F_SB, j,
                           r);
  };

  // dims kc * F_KD .. of the block's queries and of the live rows of (j, r)
  // into a stage
  auto load = [&](int j, int r, int kc, int stage) {
    const RowBlock x = rows(j, r);
    unsigned char* qd = smem + stage * stage_bytes;
    stage_rows(qd, F_QSTR, reinterpret_cast<const unsigned char*>(a.q + (size_t)q_lo * a.d),
               4 * a.d, nq_blk, 4 * kc * F_KD, 4 * F_KD, a.q_copy);
    stage_rows(qd + F_QB * F_QSTR, rstride, a.db + x.row0 * row_bytes, row_bytes, x.n_rows,
               ES * kc * F_KD, ES * F_KD, a.copy);
  };

  float acc[8][8], best_v[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      acc[i][jj] = 0.f;
      slot_init(best_v[i][jj], best_i[(ty + 16 * i) * F_SB + tx + 16 * jj]);
    }

  // a stage's dims in order, four at a time: each slot's four dims loaded
  // once, then each query's, 32 FMAs a query
  auto compute = [&](int stage) {
    const unsigned char* qd = smem + stage * stage_bytes;
    const unsigned char* rd = qd + F_QB * F_QSTR;
#pragma unroll
    for (int k4 = 0; k4 < F_KD / 4; ++k4) {
      float4 b[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) b[jj] = row_dims(rd + (tx + 16 * jj) * rstride, k4, RT());
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(qd + (ty + 16 * i) * F_QSTR + 16 * k4);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float s = fmaf(q.x, b[jj].x, acc[i][jj]);
          s = fmaf(q.y, b[jj].y, s);
          s = fmaf(q.z, b[jj].z, s);
          acc[i][jj] = fmaf(q.w, b[jj].w, s);
        }
      }
    }
  };

  // after the last chunk of (j, r): each live pair's score (with the l2
  // bias) against its best so far, a strict '>' in (step, r) order, then
  // the sums restart
  auto merge = [&](int j, int r) {
    const RowBlock x = rows(j, r);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int slot = tx + 16 * jj;
      const bool live = slot < x.n_rows;
      const float bias = live && a.sqnorm != nullptr ? a.sqnorm[x.row0 + slot] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float sc = -INFINITY;
        if (live) sc = a.sqnorm != nullptr ? __fsub_rn(2.f * acc[i][jj], bias) : acc[i][jj];
        if (sc > best_v[i][jj]) {
          best_v[i][jj] = sc;
          best_i[(ty + 16 * i) * F_SB + slot] = static_cast<int>(x.row0 + slot);
        }
        acc[i][jj] = 0.f;
      }
    }
  };

  // the (step, r, chunk) walk: loads F_STAGES - 1 chunks ahead of the products
  int lj = 0, lr = 0, lkc = 0, ls = 0;
  auto advance = [&](int& j, int& r, int& kc) {
    if (++kc == n_kc) {
      kc = 0;
      if (++r == R) {
        r = 0;
        ++j;
      }
    }
  };
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < total) {
      load(lj, lr, lkc, ls);
      advance(lj, lr, lkc);
      ls = ls + 1 == F_STAGES ? 0 : ls + 1;
    }
    cp_commit();
  }
  int cj = 0, cr = 0, ckc = 0, cs = 0;
  for (long long it = 0; it < total; ++it) {
    cp_wait<F_STAGES - 2>();
    __syncthreads();  // chunk it is in for every thread; the stage of it - 1 is free
    if (it + F_STAGES - 1 < total) {
      load(lj, lr, lkc, ls);
      advance(lj, lr, lkc);
      ls = ls + 1 == F_STAGES ? 0 : ls + 1;
    }
    cp_commit();
    compute(cs);
    if (ckc == n_kc - 1) merge(cj, cr);
    advance(cj, cr, ckc);
    cs = cs + 1 == F_STAGES ? 0 : cs + 1;
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int qi = ty + 16 * i, slot = tx + 16 * jj, b = b0 + slot;
      if (qi < nq_blk && b < a.l_buckets) {
        const size_t o = (size_t)(q_lo + qi) * a.l_buckets + b;
        a.out_v[o] = best_v[i][jj];
        a.out_i[o] = best_i[qi * F_SB + slot];
      }
    }
}

// ---- dispatch ----------------------------------------------------------

// The tensor-core pair of (queries, rows), or -1.
inline int tc_pair(int qtype, int rtype) {
  if (qtype == I8 && rtype == I8) return P_I8;
  if (qtype == BF16 && rtype == I8) return P_HYB;
  if (qtype == BF16 && rtype == BF16) return P_BF16;
  return -1;
}

// Which body a call takes, whatever its source: the f32 body for the f32
// pairs; for the tensor-core pairs the wide block at int8 tile_q >= 128, else
// the narrow one, unless the resident queries overflow shared memory: then
// the CUDA-core body; -1 for a pair no body takes. Top-2 (r_per_tile rows a
// slot in a tile) takes the narrow block if its pair is a tensor-core one
// and its state fits, else the CUDA-core body.
enum Body { CUDA_CORE = 0, NARROW = 1, WIDE = 2, F32_BODY = 3 };

inline int body_of(int qtype, int rtype, int tile_q, int d, int top2 = 0, int r_per_tile = 1) {
  const bool f32_pair = qtype == F32 && (rtype == F32 || rtype == BF16);
  if (top2) {
    const int pair = tc_pair(qtype, rtype);
    if (pair >= 0 && tc_layout<Narrow>(pair, d, 0, tc_top2_bytes<Narrow>(true, r_per_tile))
                             .total <= SMEM_MAX)
      return NARROW;
    return pair >= 0 || f32_pair ? CUDA_CORE : -1;
  }
  if (qtype == F32) return f32_pair ? F32_BODY : -1;
  const int pair = tc_pair(qtype, rtype);
  if (pair < 0) return -1;
  if (tc_layout<Narrow>(pair, d).total > SMEM_MAX) return CUDA_CORE;
  if (pair == P_I8 && tile_q >= Wide::QB && tc_layout<Wide>(pair, d).total <= SMEM_MAX)
    return WIDE;
  return NARROW;
}

template <int SRC, int PAIR, class C, bool TOP2 = false>
cudaError_t launch_tc(const TcArgs& a, int n_qt, cudaStream_t stream) {
  const int smem =
      tc_layout<C>(PAIR, a.s.d, 0, tc_top2_bytes<C>(TOP2, a.s.tile_n / a.s.l_buckets)).total;
  const cudaError_t err = cudaFuncSetAttribute(
      tiles_tc_kernel<SRC, PAIR, C, TOP2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_qt * ((a.s.tile_q + C::QB - 1) / C::QB),
                  (a.s.l_buckets + C::SB - 1) / C::SB);
  tiles_tc_kernel<SRC, PAIR, C, TOP2><<<grid, TC_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// K3's top-2: source TABLE, the narrow block.
cudaError_t launch_tc_top2(int pair, const TcArgs& a, int n_qt, cudaStream_t s) {
  if (pair == P_I8) return launch_tc<TABLE, P_I8, Narrow, true>(a, n_qt, s);
  if (pair == P_HYB) return launch_tc<TABLE, P_HYB, Narrow, true>(a, n_qt, s);
  return launch_tc<TABLE, P_BF16, Narrow, true>(a, n_qt, s);
}

template <int SRC>
cudaError_t launch_tc_pair(int body, int pair, const TcArgs& a, int n_qt, cudaStream_t s) {
  if (body == WIDE) return launch_tc<SRC, P_I8, Wide>(a, n_qt, s);
  if (pair == P_I8) return launch_tc<SRC, P_I8, Narrow>(a, n_qt, s);
  if (pair == P_HYB) return launch_tc<SRC, P_HYB, Narrow>(a, n_qt, s);
  return launch_tc<SRC, P_BF16, Narrow>(a, n_qt, s);
}

template <int SRC, typename RT>
cudaError_t launch_f32(const F32Args& a, int n_qt, cudaStream_t stream) {
  const int smem = f32_smem_bytes(sizeof(RT));
  const cudaError_t err = cudaFuncSetAttribute(
      tiles_f32_kernel<SRC, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_qt * ((a.tile_q + F_QB - 1) / F_QB), (a.l_buckets + F_SB - 1) / F_SB);
  tiles_f32_kernel<SRC, RT><<<grid, TC_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int SRC>
cudaError_t launch_f32_rows(int rtype, const F32Args& a, int n_qt, cudaStream_t s) {
  return rtype == BF16 ? launch_f32<SRC, __nv_bfloat16>(a, n_qt, s)
                       : launch_f32<SRC, float>(a, n_qt, s);
}

}  // namespace

extern "C" {

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of the body a call takes: 0 for the CUDA-core body
// (static shared memory, grid y = query blocks of 32), -1 where no body
// takes the call (a pair without a scan); the tensor-core and f32 bodies put
// their query blocks on grid x.
// The body does not depend on the source or on l2; both stay in the
// signature, so that every build of this interface binds alike
// (scripts/torch_pq_scan_ab.py times variants).
int cvdb_tiles_scan_smem_bytes(int, int qtype, int rtype, int tile_q, int d, int, int top2,
                               int r_per_tile) {
  const int body = body_of(qtype, rtype, tile_q, d, top2, r_per_tile);
  if (body == F32_BODY) return f32_smem_bytes(rtype == BF16 ? 2 : 4);
  if (body == NARROW || body == WIDE) {
    const int pair = tc_pair(qtype, rtype);
    return body == WIDE ? tc_layout<Wide>(pair, d).total
                        : tc_layout<Narrow>(pair, d, 0,
                                            tc_top2_bytes<Narrow>(top2 != 0, r_per_tile))
                              .total;
  }
  return body == CUDA_CORE ? 0 : -1;
}

// Queries one block of that body takes.
int cvdb_tiles_scan_block_queries(int, int qtype, int rtype, int tile_q, int d, int, int top2,
                                  int r_per_tile) {
  const int body = body_of(qtype, rtype, tile_q, d, top2, r_per_tile);
  return body == F32_BODY ? F_QB : body == WIDE ? Wide::QB : body == NARROW ? Narrow::QB : QB;
}

// Launches the scan on `stream`; returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for an unknown source or type pair, or top-2
// outside source TABLE). out_v2/out_i2 (null: top-1) take slot 2's (Q, L)
// values and rows.
int cvdb_tiles_scan(int source, int qtype, int rtype, const void* db, const void* q,
                    const void* table, const void* sqnorm, void* out_v, void* out_i,
                    void* out_v2, void* out_i2, int n_qt, int tile_q, int steps, int tile_n,
                    int l_buckets, int d, int n_valid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool top2 = out_v2 != nullptr;
  if ((source != ALL && source != TABLE && source != BAND) || (top2 && source != TABLE))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int body = body_of(qtype, rtype, tile_q, d, top2, tile_n / l_buckets);
  if (body == F32_BODY) {
    const F32Args a{static_cast<const unsigned char*>(db), static_cast<const float*>(q),
                    static_cast<const int32_t*>(table), static_cast<const float*>(sqnorm),
                    static_cast<float*>(out_v), static_cast<int32_t*>(out_i), tile_q, steps,
                    tile_n, l_buckets, d, n_valid, copy_size(d * (rtype == BF16 ? 2 : 4)),
                    copy_size(4 * d)};
    err = source == ALL     ? launch_f32_rows<ALL>(rtype, a, n_qt, s)
          : source == TABLE ? launch_f32_rows<TABLE>(rtype, a, n_qt, s)
                            : launch_f32_rows<BAND>(rtype, a, n_qt, s);
  } else if (body == NARROW || body == WIDE) {
    const int pair = tc_pair(qtype, rtype);
    const int copy = copy_size(tc_layout<Narrow>(pair, d).row_bytes);
    const TcArgs a{{static_cast<const unsigned char*>(db), static_cast<const unsigned char*>(q),
                    static_cast<float*>(out_v), static_cast<int32_t*>(out_i), tile_q, steps,
                    tile_n, l_buckets, d, copy, static_cast<float*>(out_v2),
                    static_cast<int32_t*>(out_i2)},
                   static_cast<const int32_t*>(table), static_cast<const float*>(sqnorm),
                   n_valid};
    err = top2              ? launch_tc_top2(pair, a, n_qt, s)
          : source == ALL   ? launch_tc_pair<ALL>(body, pair, a, n_qt, s)
          : source == TABLE ? launch_tc_pair<TABLE>(body, pair, a, n_qt, s)
                            : launch_tc_pair<BAND>(body, pair, a, n_qt, s);
  } else if (body == CUDA_CORE && top2) {
    err = launch_types_top2(qtype, rtype, db, q, table, sqnorm, out_v, out_i, out_v2, out_i2,
                            n_qt, tile_q, steps, tile_n, l_buckets, d, n_valid, s);
  } else if (body == CUDA_CORE) {
    err = source == ALL ? launch_types<ALL>(qtype, rtype, db, q, table, sqnorm, out_v, out_i,
                                            n_qt, tile_q, steps, tile_n, l_buckets, d, n_valid, s)
          : source == TABLE
              ? launch_types<TABLE>(qtype, rtype, db, q, table, sqnorm, out_v, out_i, n_qt,
                                    tile_q, steps, tile_n, l_buckets, d, n_valid, s)
              : launch_types<BAND>(qtype, rtype, db, q, table, sqnorm, out_v, out_i, n_qt,
                                   tile_q, steps, tile_n, l_buckets, d, n_valid, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
