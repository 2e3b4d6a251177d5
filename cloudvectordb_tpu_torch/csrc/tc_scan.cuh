// The tensor-core scan body shared by tiles_scan.cu (K2, K3, K7 over whole
// rows) and tiles_resid.cu (K1 over residual rows): a block of 8 warps walks
// (step, r) row blocks of an arena, scores them against its queries on
// mma.sync, and keeps each (query, slot)'s best (value, arena row).
//
// What each source supplies is an epilogue (Epi): which rows a (step, r)
// reads (rows()), what it stages beside them (load_side(): the residual
// scan's local ids, valid_end, row scales and centroid term), and how a raw
// product becomes a score (score(): masks, the l2 bias, the residual
// epilogue). The ring, the fragments, the products and the merge are here,
// once.
//
// The design (A/B runs on an H100 in PERF.md):
//   - the queries stay in shared memory for the block's life, staged once;
//   - the rows stream through a ring of STAGES chunks of DEPTH bytes of
//     depth by 16-byte cp.async (8- or 4-byte for narrower rows, plain loads
//     for odd widths; zero past the row's end), so the next chunks' loads
//     overlap this chunk's products; one barrier a chunk; a full chunk's
//     steps are unrolled so one step's fragment loads overlap the last
//     step's products; an epilogue's side data rides in the stage of the
//     (step, r)'s last chunk, so the ring's barriers order it too;
//   - the products run on mma.sync fed by ldmatrix: int8 x int8 as IMMA
//     m16n8k32 into int32 (exact); hybrid as HMMA m16n8k16 with each row's
//     int8 widened to bf16 in registers (exact: a byte permute into a float
//     and one subtract), the k order inside a k16 step permuted so one
//     ldmatrix word and one 8-byte query load fill a lane's fragments; bf16
//     x bf16 as HMMA;
//   - the float pairs sum each 32-dim step from zero on the tensor core and
//     add it to the running sum compensated (add_comp): the hybrid pair's
//     raw scores reach the hundreds, where a chain of rounded f32 adds
//     drifts past the plain version's own error;
//   - a wider block (128 int8 queries x 64 rows, warp tiles of 32 x 32)
//     serves tile_q >= 128, so a row read from L2 feeds four times the
//     queries, and a warp's fragment loads feed twice the products;
//   - query blocks are the fastest grid index, so the blocks that read the
//     same rows (every query block of one slot block) run together and
//     share them in L2;
//   - top-2 (TOP2: each slot keeps its best two distinct rows, the
//     reference's _tile_second_best and _merge_top2) keeps slot 2 in
//     registers beside slot 1. With one r a tile (R = 1) a (step, r) is a
//     tile, so each merges straight into the slots (slot_merge2 with no
//     runner-up). With R > 1 the tile's best and runner-up build up over
//     its r in shared memory, each thread's own entries, and merge into
//     the slots after its last r, as K5 does (pq_scan.cu): a per-(step, r)
//     merge would rank exact ties otherwise than the reference.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "slot_merge.cuh"

// The three pairs the body takes, and what a 32-byte step of row depth is to
// the tensor cores: I8 one IMMA m16n8k32 (s8 in, s32 out); HYB two HMMA
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
// q_stride bytes, zero past D), then the ring; each stage holds the rows'
// chunk and, after it, `side` bytes of the epilogue's side data.
struct TcLayout {
  int row_bytes;  // bytes of one arena row
  int row_pad;    // row_bytes rounded up to 32: the depth the products run over
  int q_stride;   // bytes between two staged queries
  int q_total;    // bytes of the staged queries
  int rows;       // bytes of one stage's rows
  int stage;      // bytes of one ring stage: rows, then side data
  int total;
};

template <class C>
__host__ __device__ inline TcLayout tc_layout(int pair, int d, int side = 0, int extra = 0) {
  TcLayout l;
  l.row_bytes = d * (pair == P_BF16 ? 2 : 1);
  l.row_pad = round_up(l.row_bytes, 32);
  const int q_bytes = l.row_pad * (pair == P_HYB ? 2 : 1);
  // 32-bit fragment loads at byte 4t of 8 queries (I8, BF16) want a stride
  // of 16 mod 128 bytes, 64-bit loads at byte 8t (HYB) 32 mod 128
  const int want = pair == P_HYB ? 32 : 16;
  l.q_stride = q_bytes + ((want - q_bytes % 128) % 128 + 128) % 128;
  l.q_total = C::QB * l.q_stride;
  l.rows = C::SB * C::RSTR;
  l.stage = l.rows + round_up(side, 16);
  l.total = l.q_total + C::STAGES * l.stage + extra;  // extra: tc_top2_bytes
  return l;
}

// What the body reads and writes, whatever the epilogue.
struct TcScan {
  const unsigned char* db;  // (N, D) rows
  const unsigned char* q;   // (Q, D) queries
  float* out_v;             // (Q, L)
  int32_t* out_i;
  int tile_q, steps, tile_n, l_buckets, d;
  int copy;  // bytes one cp.async moves (16, 8 or 4; the row width's largest), 0: plain loads
  float* out_v2 = nullptr;  // top-2: (Q, L) slot 2
  int32_t* out_i2 = nullptr;
};

// Shared memory a top-2 scan keeps the tiles' best and runner-up in: four
// words (value, r, value, r) a (slot, query) pair of a thread, only when a
// tile has several r.
template <class C>
__host__ __device__ inline int tc_top2_bytes(bool top2, int r_per_tile) {
  return top2 && r_per_tile > 1 ? 16 * C::MT * 16 * TC_THREADS : 0;
}

// The rows of one (step, r): the arena row of slot 0 of the block, and how
// many of its SB slots are live.
struct RowBlock {
  long long row0;
  int n_rows;
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

// What one warp keeps: the running products of its (row, query) pairs
// (float pairs: a sum and its rounding error), and their best (value, arena
// row) so far (top-2: and their second best).
template <int PAIR, int MT, bool TOP2>
struct WarpAcc {
  using T = typename std::conditional<PAIR == P_I8, int, float>::type;
  T acc[MT][4][4];
  float lo[PAIR == P_I8 ? 1 : MT][4][4];
  float best_v[MT][4][4];
  int best_i[MT][4][4];
  float best_v2[TOP2 ? MT : 1][4][4];
  int best_i2[TOP2 ? MT : 1][4][4];
};

// The scan: one block's walk over (step, r, chunk), in the kernel that owns
// `smem` (the layout's total bytes of dynamic shared memory). Block x is
// (query tile, query block), query blocks fastest; block y a slot block.
template <int PAIR, class C, bool TOP2 = false, class Epi>
__device__ __forceinline__ void tc_scan(const TcScan& a, const Epi& epi, unsigned char* smem) {
  constexpr int MT = C::MT;
  const TcLayout lay = tc_layout<C>(PAIR, a.d, epi.side,
                                    tc_top2_bytes<C>(TOP2, a.tile_n / a.l_buckets));
  unsigned char* q_s = smem;
  unsigned char* ring = smem + lay.q_total;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % C::WM, wq = warp / C::WM;
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

  // the rows of (j, r), as the epilogue says
  auto rows = [&](int j, int r) { return epi.rows(qt, b0, j, r); };

  // chunk kc (bytes kc*DEPTH .. of each row) of the live rows of (j, r) into a
  // stage: cp.async of `copy` bytes, zero past the row's end, up to row_pad;
  // with the last chunk, the epilogue's side data of (j, r)
  auto load = [&](int j, int r, int kc, int stage) {
    const RowBlock x = rows(j, r);
    unsigned char* dst = ring + stage * lay.stage;
    if (kc == n_kc - 1) epi.load_side(dst + lay.rows, x, qt, q_lo, nq_blk, j);
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

  WarpAcc<PAIR, MT, TOP2> w;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w.acc[mt][nt][e] = 0;
        if constexpr (PAIR != P_I8) w.lo[mt][nt][e] = 0.f;
        slot_init(w.best_v[mt][nt][e], w.best_i[mt][nt][e]);
        if constexpr (TOP2) slot_init(w.best_v2[mt][nt][e], w.best_i2[mt][nt][e]);
      }
  // top-2 with R > 1: the tiles' (best, r, runner-up, r) of this thread's
  // pairs, entry ((f * MT * 16 + pair) * TC_THREADS + tid) for field f
  float* tile2 = reinterpret_cast<float*>(smem + lay.q_total + C::STAGES * lay.stage);

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

  // after the last chunk of (j, r): each pair's score (the epilogue's, from
  // the raw product and the stage's side data) against its best so far, a
  // strict '>' in (step, r) order (what tile_take then slot_merge give: the
  // first maximum wins; top-2: the file header), then the sums restart
  auto merge = [&](int j, int r, int stage) {
    const RowBlock x = rows(j, r);
    const unsigned char* side = ring + stage * lay.stage + lay.rows;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = (wm * MT + mt) * 16 + g + 8 * (e >> 1);
          const int qi = wq * 32 + 8 * nt + 2 * t4 + (e & 1);
          float sc;
          if constexpr (PAIR == P_I8)
            sc = epi.score(w.acc[mt][nt][e], slot, qi, x, side);
          else
            sc = epi.score(w.acc[mt][nt][e] + w.lo[mt][nt][e], slot, qi, x, side);
          if constexpr (TOP2) {
            const long long row = x.row0 + slot;
            float &v1 = w.best_v[mt][nt][e], &v2 = w.best_v2[mt][nt][e];
            int &i1 = w.best_i[mt][nt][e], &i2 = w.best_i2[mt][nt][e];
            if (R == 1) {
              slot_merge2(sc, row, -INFINITY, row, v1, i1, v2, i2);
            } else {
              constexpr int NP = MT * 16;
              const int k = (mt * 4 + nt) * 4 + e;
              float* tm1 = tile2 + k * TC_THREADS + tid;
              int* tr1 = reinterpret_cast<int*>(tm1 + NP * TC_THREADS);
              float* tm2 = tm1 + 2 * NP * TC_THREADS;
              int* tr2 = reinterpret_cast<int*>(tm1 + 3 * NP * TC_THREADS);
              tile_take2(sc, r, *tm1, *tr1, *tm2, *tr2);
              if (r == R - 1) {
                const long long row_r0 = row - (long long)r * a.l_buckets;
                slot_merge2(*tm1, row_r0 + (long long)*tr1 * a.l_buckets, *tm2,
                            row_r0 + (long long)*tr2 * a.l_buckets, v1, i1, v2, i2);
              }
            }
          } else if (sc > w.best_v[mt][nt][e]) {
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
    if (ckc == n_kc - 1) merge(cj, cr, cs);
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
          if constexpr (TOP2) {
            a.out_v2[o] = w.best_v2[mt][nt][e];
            a.out_i2[o] = w.best_i2[mt][nt][e];
          }
        }
      }
}
