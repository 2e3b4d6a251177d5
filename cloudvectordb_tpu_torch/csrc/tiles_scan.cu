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
// With sqnorm (the flat index's l2) the score is 2 s - sqnorm[g]. Rows with
// g >= n_valid score -inf and are never read, so a ragged database needs no
// padded copy. Each query keeps L = l_buckets slots, merged as
// csrc/slot_merge.cuh says. The final top-k over the slots is the caller's.
//
// Two bodies. The TPU walks the steps as a sequential grid axis and carries
// the slots in VMEM; here one block owns some queries of one query tile and
// SB consecutive slots, keeps their running (max, row) in registers, and
// loops over the steps itself, so no ordering between blocks is needed.
//
// The tensor-core body (tiles_tc_kernel) takes TABLE and BAND over the
// first three pairs: K3 and K7 on every main path. Each step is a small
// GEMM, SB rows by the block's queries over the whole depth. What bounds it
// on an H100: K3 (hybrid, tile_q 32, p 96 at D 768) does 32 multiply-adds
// a byte of rows, far below the tensor cores' ridge, so the rows' bytes
// bound it (19.3 GB if no tile were shared between query tiles, 5.8 ms at
// 3.35 TB/s); K7 (int8, tile_q 256, a band of the whole arena) is
// operations-bound (7.9e13 int8 ops, 39.7 ms at the int8 peak). What the
// design does about it:
//   - the queries stay in shared memory for the block's life, staged once
//     (32 bf16 queries x 768 are 48 KB; 128 int8 queries, 96 KB);
//   - the rows stream through a ring (3 stages of 128 bytes of depth in the
//     narrow block, 4 of 256 in the wide one) by 16-byte cp.async (8- or
//     4-byte for narrower rows, plain loads for odd widths; zero past the
//     row's end), so the next chunks' loads overlap this chunk's products;
//     one barrier a chunk; a full chunk's steps are unrolled so one step's
//     fragment loads overlap the last step's products;
//   - the products run on mma.sync fed by ldmatrix: int8 x int8 as IMMA
//     m16n8k32 into int32 (exact: equal to the plain version bit for bit);
//     hybrid as HMMA m16n8k16 with each row's int8 widened to bf16 in
//     registers (exact: a byte permute into a float and one subtract), the
//     k order inside a k16 step permuted so one ldmatrix word and one
//     8-byte query load fill a lane's fragments; bf16 x bf16 as HMMA;
//   - the float pairs sum each 32-dim step from zero on the tensor core
//     and add it to the running sum compensated (add_comp): the hybrid
//     pair's raw scores reach the hundreds, where a chain of rounded f32
//     adds drifts past the plain version's own error;
//   - a wider block (128 int8 queries x 64 rows, warp tiles of 32 x 32)
//     serves tile_q >= 128, so K7's 16 query tiles read each row twice, not
//     eight times, and a warp's fragment loads feed twice the products;
//   - query blocks are the fastest grid index, so the blocks that read the
//     same rows (K7: every query tile of one slot block) run together and
//     share them in L2.
// A/B runs of these choices on an H100 are in PERF.md.
// The CUDA-core body (tiles_scan_kernel) takes the rest: ALL (K2) in every
// pair, and the f32 pairs, whose f32-FMA contract TF32 cannot hold. 256
// threads over 32 queries x 64 slots stage rows and queries in chunks in
// shared memory and score with dp4a or f32 FMAs; it is compute-bound on
// the CUDA cores and the shared-memory loads feeding them (6 loads per 8
// multiply-adds a thread). The tensor-core body also leaves to it a call
// whose resident queries would not fit in shared memory (D above 2,752
// for bf16 queries, 5,504 for int8; the wide block takes int8 D up to
// 1,152, the narrow one above that).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "slot_merge.cuh"

namespace {

constexpr int QB = 32;            // queries per block
constexpr int SB = 64;            // slots per block
constexpr int TX = 16;            // threads along slots
constexpr int TY = 16;            // threads along queries
constexpr int THREADS = TX * TY;  // 256
constexpr int QPT = QB / TY;      // queries per thread
constexpr int SPT = SB / TX;      // slots per thread
constexpr int KC = 64;            // 32-bit words per staged row chunk
constexpr int STRIDE = KC + 1;    // odd word stride: conflict-free columns

enum Source { ALL = 0, TABLE = 1, BAND = 2 };
enum ElemType { F32 = 0, BF16 = 1, I8 = 2 };

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

template <int SRC>
__device__ __forceinline__ int step_tile(const int32_t* table, int qt, int steps, int j) {
  if (SRC == ALL) return j;
  if (SRC == TABLE) return table[(size_t)qt * steps + j];
  return table[qt] + j;  // BAND: band_start[qt] + j
}

// Dot products of the block's queries with the SB rows row0 .. row0+SB-1,
// accumulated into acc over the whole row width in chunks.
template <typename QT, typename RT>
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
    float* q_s = reinterpret_cast<float*>(smem);  // QB x STRIDE
    float* r_s = q_s + QB * STRIDE;               // SB x STRIDE
    float acc[QPT][SPT] = {};
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
        float a[QPT], b[SPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) a[i] = q_s[(ty + TY * i) * STRIDE + k];
#pragma unroll
        for (int j = 0; j < SPT; ++j) b[j] = r_s[(tx + TX * j) * STRIDE + k];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < SPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) out[i][j] = acc[i][j];
  }
}

template <int SRC, typename QT, typename RT>
__global__ void __launch_bounds__(THREADS)
tiles_scan_kernel(const RT* __restrict__ db,         // (N, D) rows
                  const QT* __restrict__ q,          // (Q, D) queries
                  const int32_t* __restrict__ table,  // TABLE (n_qt, steps), BAND (n_qt,)
                  const float* __restrict__ sqnorm,   // (N,) or null: l2 bias
                  float* __restrict__ out_v,          // (Q, L)
                  int32_t* __restrict__ out_i,        // (Q, L)
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

  float best_v[QPT][SPT];
  int best_i[QPT][SPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < SPT; ++j) slot_init(best_v[i][j], best_i[i][j]);

  for (int j = 0; j < steps; ++j) {
    const long long base = (long long)step_tile<SRC>(table, qt, steps, j) * tile_n;
    float tmx[QPT][SPT];
    int tr[QPT][SPT];
    for (int r = 0; r < r_per; ++r) {
      const long long row0 = base + (long long)r * l_buckets + b0;
      // rows of this block that exist and are live: slots below L, rows in
      // [0, n_valid); the rest are neither read nor ranked
      const long long live_hi = min((long long)min(SB, l_buckets - b0), (long long)n_valid - row0);
      const int n_rows_blk = row0 < 0 ? 0 : (int)max(0LL, live_hi);
      float s[QPT][SPT];
      score_rows<QT, RT>(q, db, smem, q_lo, nq_blk, row0, n_rows_blk, d, s);
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
          tile_take(sc, r, tmx[i][jj], tr[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int jj = 0; jj < SPT; ++jj)
        slot_merge(tmx[i][jj], base + (long long)tr[i][jj] * l_buckets + b0 + tx + TX * jj,
                   best_v[i][jj], best_i[i][jj]);
  }

#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int qi = ty + TY * i, b = b0 + tx + TX * jj;
      if (qi < nq_blk && b < l_buckets) {
        out_v[(size_t)(q_lo + qi) * l_buckets + b] = best_v[i][jj];
        out_i[(size_t)(q_lo + qi) * l_buckets + b] = best_i[i][jj];
      }
    }
}

template <int SRC, typename QT, typename RT>
cudaError_t launch(const void* db, const void* q, const void* table, const void* sqnorm,
                   void* out_v, void* out_i, int n_qt, int tile_q, int steps, int tile_n,
                   int l_buckets, int d, int n_valid, cudaStream_t stream) {
  const int qblocks = (tile_q + QB - 1) / QB;
  const dim3 grid((l_buckets + SB - 1) / SB, n_qt * qblocks);
  tiles_scan_kernel<SRC, QT, RT><<<grid, THREADS, 0, stream>>>(
      static_cast<const RT*>(db), static_cast<const QT*>(q),
      static_cast<const int32_t*>(table), static_cast<const float*>(sqnorm),
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i), tile_q, steps, tile_n,
      l_buckets, d, n_valid);
  return cudaGetLastError();
}

template <int SRC>
cudaError_t launch_types(int qtype, int rtype, const void* db, const void* q,
                         const void* table, const void* sqnorm, void* out_v, void* out_i,
                         int n_qt, int tile_q, int steps, int tile_n, int l_buckets, int d,
                         int n_valid, cudaStream_t stream) {
#define CVDB_SCAN(QT, RT) \
  launch<SRC, QT, RT>(db, q, table, sqnorm, out_v, out_i, n_qt, tile_q, steps, tile_n, \
                      l_buckets, d, n_valid, stream)
  if (qtype == I8 && rtype == I8) return CVDB_SCAN(int8_t, int8_t);
  if (qtype == BF16 && rtype == I8) return CVDB_SCAN(__nv_bfloat16, int8_t);
  if (qtype == BF16 && rtype == BF16) return CVDB_SCAN(__nv_bfloat16, __nv_bfloat16);
  if (qtype == F32 && rtype == F32) return CVDB_SCAN(float, float);
  if (qtype == F32 && rtype == BF16) return CVDB_SCAN(float, __nv_bfloat16);
#undef CVDB_SCAN
  return cudaErrorInvalidValue;
}


// ---- the tensor-core body: TABLE and BAND over (int8, int8), (bf16, int8)
// and (bf16, bf16) ---------------------------------------------------------

// The three pairs it takes, and what a 32-byte step of row depth is to the
// tensor cores: I8 one IMMA m16n8k32 (s8 in, s32 out); HYB two HMMA
// m16n8k16 (bf16 in, f32 out) over 32 int8 values widened to bf16; BF16 one
// HMMA m16n8k16.
enum Pair { P_I8 = 0, P_HYB = 1, P_BF16 = 2 };

// A block of 8 warps scores SB = WM * MT * 16 consecutive slots (rows) for
// QB = WN * 32 queries of one query tile; warp w takes rows (w % WM) * MT *
// 16 .. (MT m16 tiles) and queries (w / WM) * 32 .. (four n8 tiles). The
// ring holds STAGES chunks of DEPTH bytes of depth of the SB rows, at a row
// stride of DEPTH + 16 bytes (an ldmatrix's 8 rows in distinct banks).
template <int WM_, int WN_, int MT_, int STAGES_, int DEPTH_>
struct TcCfg {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, STAGES = STAGES_, DEPTH = DEPTH_;
  static constexpr int SB = WM * MT * 16;
  static constexpr int QB = WN * 32;
  static constexpr int RSTR = DEPTH + 16;
};
using Narrow = TcCfg<8, 1, 1, 3, 128>;  // 128 rows x 32 queries, two blocks an SM
using Wide = TcCfg<2, 4, 2, 4, 256>;    // 64 rows x 128 queries: int8 queries, tile_q >= 128

constexpr int TC_THREADS = 256;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory one block may use on sm_90

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory: the block's queries, resident for its life (QB rows of
// q_stride bytes, zero past D), then the ring.
struct TcLayout {
  int row_bytes;  // bytes of one arena row
  int row_pad;    // row_bytes rounded up to 32: the depth the products run over
  int q_stride;   // bytes between two staged queries
  int q_total;    // bytes of the staged queries
  int stage;      // bytes of one ring stage
  int total;
};

template <class C>
__host__ __device__ inline TcLayout tc_layout(int pair, int d) {
  TcLayout l;
  l.row_bytes = d * (pair == P_BF16 ? 2 : 1);
  l.row_pad = round_up(l.row_bytes, 32);
  const int q_bytes = l.row_pad * (pair == P_HYB ? 2 : 1);
  // 32-bit fragment loads at byte 4t of 8 queries (I8, BF16) want a stride
  // of 16 mod 128 bytes, 64-bit loads at byte 8t (HYB) 32 mod 128
  const int want = pair == P_HYB ? 32 : 16;
  l.q_stride = q_bytes + ((want - q_bytes % 128) % 128 + 128) % 128;
  l.q_total = C::QB * l.q_stride;
  l.stage = C::SB * C::RSTR;
  l.total = l.q_total + C::STAGES * l.stage;
  return l;
}

struct TcArgs {
  const unsigned char* db;  // (N, D) rows
  const unsigned char* q;   // (Q, D) queries
  const int32_t* table;     // TABLE (n_qt, steps), BAND (n_qt,)
  float* out_v;             // (Q, L)
  int32_t* out_i;
  int tile_q, steps, tile_n, l_buckets, d, n_valid;
  int copy;  // bytes one cp.async moves (16, 8 or 4; the row width's largest), 0: plain loads
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `size` bytes from global to shared memory, the bytes past src_bytes zero.
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int size,
                                               int src_bytes) {
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else if (size == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit elements (here: 8 rows x 16 bytes each);
// lane 8i + r gives the address of row r of matrix i, and receives word
// lane % 4 of row lane / 4 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Fragments (PTX ISA), lane = 4 g + t: A rows g (a0, a2) and g + 8 (a1,
// a3); B column g; accumulator rows g (c0, c1) and g + 8 (c2, c3) at columns
// 2t, 2t + 1. s8 m16n8k32: a0/a1 hold k 4t .. 4t + 3, a2/a3 k 16 + 4t ..;
// b0 k 4t .., b1 k 16 + 4t ... bf16 m16n8k16: a0/a1 k 2t, 2t + 1, a2/a3 k
// 2t + 8, 2t + 9; b0 k 2t, 2t + 1, b1 k 2t + 8, 2t + 9.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes 2h and 2h + 1 of four int8 values, widened exactly to two bf16 (the
// lower byte in the lower half): each byte, offset by 128, is put under the
// exponent of 2^23 (0x4B0000xx is 2^23 + x), less 2^23 + 128 is the value,
// which bf16 holds exactly (|v| <= 128 needs 8 significant bits).
__device__ __forceinline__ uint32_t widen2(uint32_t w, int h) {
  const uint32_t u = w ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | (2 * h))) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 | (2 * h))) - 8388736.f;
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// What one warp keeps: the running products of its (row, query) pairs
// (float pairs: a sum and its rounding error), and their best (value, arena
// row) so far.
template <int PAIR, int MT>
struct WarpAcc {
  using T = typename std::conditional<PAIR == P_I8, int, float>::type;
  T acc[MT][4][4];
  float lo[PAIR == P_I8 ? 1 : MT][4][4];
  float best_v[MT][4][4];
  int best_i[MT][4][4];
};

// hi + lo += p, lo taking the rounding error of hi + p (Fast2Sum: exact
// when |hi| >= |p|, which holds once the sum has grown; no worse than the
// rounded add when it does not). The hybrid pair's raw scores reach the
// hundreds (bf16 unit queries against int8 rows), where f32 steps are 3e-5
// to 6e-5 and 24 rounded adds at D 768 drift by several steps; the
// compensated sum stays within about one (measured on an H100: PERF.md).
__device__ __forceinline__ void add_comp(float& hi, float& lo, float p) {
  const float s = hi + p;
  const float t = s - hi;
  lo += p - t;
  hi = s;
}

// The rows of one (step, r): the arena row of slot 0 of the block, and how
// many of its SB slots are live (below L and in [0, n_valid)).
struct RowBlock {
  long long row0;
  int n_rows;
};

template <int SRC, class C>
__device__ __forceinline__ RowBlock row_block(const TcArgs& a, int qt, int b0, int j, int r) {
  RowBlock x;
  const long long base = (long long)step_tile<SRC>(a.table, qt, a.steps, j) * a.tile_n;
  x.row0 = base + (long long)r * a.l_buckets + b0;
  const long long hi = min((long long)min(C::SB, a.l_buckets - b0), (long long)a.n_valid - x.row0);
  x.n_rows = x.row0 < 0 ? 0 : (int)max(0LL, hi);
  return x;
}

template <int SRC, int PAIR, class C>
__global__ void __launch_bounds__(TC_THREADS, C::MT == 1 ? 2 : 1)
tiles_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MT = C::MT;
  const TcLayout lay = tc_layout<C>(PAIR, a.d);
  unsigned char* q_s = smem;
  unsigned char* ring = smem + lay.q_total;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % C::WM, wq = warp / C::WM;
  // query blocks are the fastest grid index: blocks that read the same rows
  // (one slot block, every query tile) run together and share them in L2
  const int qblocks = (a.tile_q + C::QB - 1) / C::QB;
  const int qt = blockIdx.x / qblocks;
  const int q_lo = qt * a.tile_q + (blockIdx.x - qt * qblocks) * C::QB;
  const int nq_blk = min(C::QB, (qt + 1) * a.tile_q - q_lo);
  const int b0 = blockIdx.y * C::SB;
  const int R = a.tile_n / a.l_buckets;
  constexpr int DEPTH = C::DEPTH, RSTR = C::RSTR;
  const int n_kc = (lay.row_pad + DEPTH - 1) / DEPTH;
  const long long total = (long long)a.steps * R * n_kc;

  // the block's queries, once: zero past D and past the tile's last query
  {
    const int qe = PAIR == P_I8 ? 1 : 2;
    const int q_row = a.d * qe;
    const int words = lay.q_stride / 4;
    const bool aligned = q_row % 4 == 0;
    for (int i = tid; i < C::QB * words; i += TC_THREADS) {
      const int qi = i / words, w = i - qi * words;
      uint32_t v = 0;
      if (qi < nq_blk) {
        const unsigned char* src = a.q + (size_t)(q_lo + qi) * q_row;
        if (aligned && 4 * w + 4 <= q_row) {
          v = *reinterpret_cast<const uint32_t*>(src + 4 * w);
        } else {
          for (int b = 0; b < 4; ++b)
            if (4 * w + b < q_row) v |= static_cast<uint32_t>(src[4 * w + b]) << (8 * b);
        }
      }
      reinterpret_cast<uint32_t*>(q_s)[i] = v;
    }
  }

  // chunk kc (bytes kc*DEPTH .. of each row) of the live rows of (j, r) into a
  // stage: cp.async of `copy` bytes, zero past the row's end, up to row_pad
  auto load = [&](int j, int r, int kc, int stage) {
    const RowBlock x = row_block<SRC, C>(a, qt, b0, j, r);
    unsigned char* dst = ring + stage * lay.stage;
    const int off0 = kc * DEPTH;
    const int span = min(DEPTH, lay.row_pad - off0);
    const unsigned char* src = a.db + x.row0 * lay.row_bytes;
    // a row's pieces: DEPTH / copy of them (DEPTH bytes with plain loads), those
    // past the chunk's span skipped
    const int size = a.copy ? a.copy : 1;
    const int shift = __ffs(DEPTH / size) - 1;
    for (int i = tid; i < (x.n_rows << shift); i += TC_THREADS) {
      const int ri = i >> shift, c = (i & ((1 << shift) - 1)) * size;
      if (c >= span) continue;
      const int off = off0 + c;
      const unsigned char* row = src + (size_t)ri * lay.row_bytes;
      if (a.copy) {
        const int n = max(0, min(a.copy, lay.row_bytes - off));
        cp_async_zfill(dst + ri * RSTR + c, n ? row + off : row, a.copy, n);
      } else {
        dst[ri * RSTR + c] = off < lay.row_bytes ? row[off] : 0;
      }
    }
  };

  WarpAcc<PAIR, MT> w;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w.acc[mt][nt][e] = 0;
        if constexpr (PAIR != P_I8) w.lo[mt][nt][e] = 0.f;
        slot_init(w.best_v[mt][nt][e], w.best_i[mt][nt][e]);
      }

  // the products of one stage: its 32-byte depth steps, on the tensor cores
  auto compute = [&](int stage, int kc) {
    const unsigned char* rs = ring + stage * lay.stage;
    const int nsub = min(DEPTH, lay.row_pad - kc * DEPTH) / 32;
    // lane's ldmatrix row: matrix lane / 8 is rows 0-7 / 8-15 (bit 0) of
    // bytes 0-15 / 16-31 (bit 1)
    const unsigned char* a_row =
        rs + (wm * MT * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RSTR + (lane >> 4) * 16;
    const unsigned char* q_row = q_s + (wq * 32 + g) * lay.q_stride;
    auto step = [&](int s) {
      const int roff = kc * DEPTH + s * 32;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], a_row + mt * 16 * RSTR + s * 32);
      if constexpr (PAIR == P_HYB) {
        // the k order inside a k16 step is permuted: k 2t, 2t + 1, 2t + 8,
        // 2t + 9 are dims 4t .. 4t + 3, for rows (ldmatrix's word t) and
        // queries (one 8-byte load) alike
        uint32_t ah[2][MT][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            ah[h][mt][0] = widen2(af[mt][2 * h], 0);
            ah[h][mt][1] = widen2(af[mt][2 * h + 1], 0);
            ah[h][mt][2] = widen2(af[mt][2 * h], 1);
            ah[h][mt][3] = widen2(af[mt][2 * h + 1], 1);
          }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned char* qp = q_row + 8 * nt * lay.q_stride + 2 * roff + 8 * t4;
          const uint2 bq0 = *reinterpret_cast<const uint2*>(qp);
          const uint2 bq1 = *reinterpret_cast<const uint2*>(qp + 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // each 32-dim step is summed from zero and added to the running
            // sum in f32, compensated: the tensor core's own f32 sum
            // truncates, so a long chain of them drifts
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(p, ah[0][mt], bq0.x, bq0.y);
            mma_bf16(p, ah[1][mt], bq1.x, bq1.y);
#pragma unroll
            for (int e = 0; e < 4; ++e) add_comp(w.acc[mt][nt][e], w.lo[mt][nt][e], p[e]);
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned char* qp = q_row + 8 * nt * lay.q_stride + roff + 4 * t4;
          const uint32_t b0q = *reinterpret_cast<const uint32_t*>(qp);
          const uint32_t b1q = *reinterpret_cast<const uint32_t*>(qp + 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (PAIR == P_I8) {
              mma_s8(w.acc[mt][nt], af[mt], b0q, b1q);
            } else {
              float p[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(p, af[mt], b0q, b1q);
#pragma unroll
              for (int e = 0; e < 4; ++e) add_comp(w.acc[mt][nt][e], w.lo[mt][nt][e], p[e]);
            }
          }
        }
      }
    };
    // a full chunk unrolled, so one step's fragment loads overlap the
    // previous step's products; the last, partial chunk step by step
    if (nsub == DEPTH / 32) {
#pragma unroll
      for (int s = 0; s < DEPTH / 32; ++s) step(s);
    } else {
#pragma unroll 1
      for (int s = 0; s < nsub; ++s) step(s);
    }
  };

  // after the last chunk of (j, r): each live pair's score against its best
  // so far, a strict '>' in (step, r) order (what tile_take then slot_merge
  // give: the first maximum wins), then the sums restart
  auto merge = [&](int j, int r) {
    const RowBlock x = row_block<SRC, C>(a, qt, b0, j, r);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = (wm * MT + mt) * 16 + g + 8 * (e >> 1);
          float sc = -INFINITY;
          if (slot < x.n_rows) {
            if constexpr (PAIR == P_I8)
              sc = __int2float_rn(w.acc[mt][nt][e]);
            else
              sc = w.acc[mt][nt][e] + w.lo[mt][nt][e];
          }
          if (sc > w.best_v[mt][nt][e]) {
            w.best_v[mt][nt][e] = sc;
            w.best_i[mt][nt][e] = static_cast<int>(x.row0 + slot);
          }
          w.acc[mt][nt][e] = 0;
          if constexpr (PAIR != P_I8) w.lo[mt][nt][e] = 0.f;
        }
  };

  // the (step, r, chunk) walk: loads STAGES - 1 chunks ahead of the products
  int lj = 0, lr = 0, lkc = 0, ls = 0;  // next chunk to load, its stage
  auto advance = [&](int& j, int& r, int& kc) {
    if (++kc == n_kc) {
      kc = 0;
      if (++r == R) {
        r = 0;
        ++j;
      }
    }
  };
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < total) {
      load(lj, lr, lkc, ls);
      advance(lj, lr, lkc);
      ls = ls + 1 == C::STAGES ? 0 : ls + 1;
    }
    cp_commit();
  }
  int cj = 0, cr = 0, ckc = 0, cs = 0;
  for (long long it = 0; it < total; ++it) {
    cp_wait<C::STAGES - 2>();
    __syncthreads();  // chunk it is in for every thread; the stage of it - 1 is free
    if (it + C::STAGES - 1 < total) {
      load(lj, lr, lkc, ls);
      advance(lj, lr, lkc);
      ls = ls + 1 == C::STAGES ? 0 : ls + 1;
    }
    cp_commit();
    compute(cs, ckc);
    if (ckc == n_kc - 1) merge(cj, cr);
    advance(cj, cr, ckc);
    cs = cs + 1 == C::STAGES ? 0 : cs + 1;
  }
  cp_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = wq * 32 + 8 * nt + 2 * t4 + (e & 1);
        const int b = b0 + (wm * MT + mt) * 16 + g + 8 * (e >> 1);
        if (qi < nq_blk && b < a.l_buckets) {
          const size_t o = (size_t)(q_lo + qi) * a.l_buckets + b;
          a.out_v[o] = w.best_v[mt][nt][e];
          a.out_i[o] = w.best_i[mt][nt][e];
        }
      }
}

// Which body a call takes: 0 the CUDA-core kernel; 1 the tensor-core kernel,
// Narrow; 2 Wide.
inline int tc_pair(int qtype, int rtype) {
  if (qtype == I8 && rtype == I8) return P_I8;
  if (qtype == BF16 && rtype == I8) return P_HYB;
  if (qtype == BF16 && rtype == BF16) return P_BF16;
  return -1;
}

inline int tc_body(int source, int qtype, int rtype, int tile_q, int d, bool l2) {
  const int pair = tc_pair(qtype, rtype);
  if (source == ALL || l2 || pair < 0 || tc_layout<Narrow>(pair, d).total > SMEM_MAX) return 0;
  if (pair == P_I8 && tile_q >= Wide::QB && tc_layout<Wide>(pair, d).total <= SMEM_MAX) return 2;
  return 1;
}

template <int SRC, int PAIR, class C>
cudaError_t launch_tc(const TcArgs& a, int n_qt, cudaStream_t stream) {
  const int smem = tc_layout<C>(PAIR, a.d).total;
  const cudaError_t err = cudaFuncSetAttribute(
      tiles_tc_kernel<SRC, PAIR, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_qt * ((a.tile_q + C::QB - 1) / C::QB), (a.l_buckets + C::SB - 1) / C::SB);
  tiles_tc_kernel<SRC, PAIR, C><<<grid, TC_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int SRC>
cudaError_t launch_tc_pair(int body, int pair, const TcArgs& a, int n_qt, cudaStream_t s) {
  if (body == 2) return launch_tc<SRC, P_I8, Wide>(a, n_qt, s);
  if (pair == P_I8) return launch_tc<SRC, P_I8, Narrow>(a, n_qt, s);
  if (pair == P_HYB) return launch_tc<SRC, P_HYB, Narrow>(a, n_qt, s);
  return launch_tc<SRC, P_BF16, Narrow>(a, n_qt, s);
}

}  // namespace

extern "C" {

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of the body a call takes: 0 for the CUDA-core body
// (static shared memory, grid y = query blocks of 32), else the tensor-core
// body's (grid x = query blocks).
int cvdb_tiles_scan_smem_bytes(int source, int qtype, int rtype, int tile_q, int d, int l2) {
  const int body = tc_body(source, qtype, rtype, tile_q, d, l2 != 0);
  if (body == 0) return 0;
  const int pair = tc_pair(qtype, rtype);
  return body == 2 ? tc_layout<Wide>(pair, d).total : tc_layout<Narrow>(pair, d).total;
}

// Queries one block of that body takes.
int cvdb_tiles_scan_block_queries(int source, int qtype, int rtype, int tile_q, int d, int l2) {
  const int body = tc_body(source, qtype, rtype, tile_q, d, l2 != 0);
  return body == 2 ? Wide::QB : body == 1 ? Narrow::QB : QB;
}

// Launches the scan on `stream`; returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for an unknown source or type pair).
int cvdb_tiles_scan(int source, int qtype, int rtype, const void* db, const void* q,
                    const void* table, const void* sqnorm, void* out_v, void* out_i,
                    int n_qt, int tile_q, int steps, int tile_n, int l_buckets, int d,
                    int n_valid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int body = tc_body(source, qtype, rtype, tile_q, d, sqnorm != nullptr);
  if (body != 0) {
    const int pair = tc_pair(qtype, rtype);
    const int row_bytes = tc_layout<Narrow>(pair, d).row_bytes;
    const int copy = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : 0;
    const TcArgs a{static_cast<const unsigned char*>(db), static_cast<const unsigned char*>(q),
                   static_cast<const int32_t*>(table), static_cast<float*>(out_v),
                   static_cast<int32_t*>(out_i), tile_q, steps, tile_n, l_buckets, d, n_valid,
                   copy};
    err = source == TABLE ? launch_tc_pair<TABLE>(body, pair, a, n_qt, s)
                          : launch_tc_pair<BAND>(body, pair, a, n_qt, s);
    return static_cast<int>(err);
  }
  switch (source) {
    case ALL:
      err = launch_types<ALL>(qtype, rtype, db, q, table, sqnorm, out_v, out_i, n_qt, tile_q,
                              steps, tile_n, l_buckets, d, n_valid, s);
      break;
    case TABLE:
      err = launch_types<TABLE>(qtype, rtype, db, q, table, sqnorm, out_v, out_i, n_qt,
                                tile_q, steps, tile_n, l_buckets, d, n_valid, s);
      break;
    case BAND:
      err = launch_types<BAND>(qtype, rtype, db, q, table, sqnorm, out_v, out_i, n_qt,
                               tile_q, steps, tile_n, l_buckets, d, n_valid, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
