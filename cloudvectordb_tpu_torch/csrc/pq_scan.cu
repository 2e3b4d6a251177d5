// PQ decode-and-score scan for Hopper (sm_90a) on the tensor cores, plain C
// interface: one kernel for the tile-table PQ scan and the full PQ scan.
//
// Replaces two Pallas kernels that compute the same thing and differ in
// which arena tile a step reads and in the residual term:
//   TABLE cloudvectordb_tpu/ops/pallas_pq.py:315 pq_tiles_topk_pallas
//         (body _pq_tiles_kernel :94): step j of query tile qt reads
//         tile_table[qt, j] and merges into pool j % n_pools; optional
//         residual centroid term, row mask (filtered search), l2 key and
//         top-2 slots; an entry at or past n_live (a segment's pad tile,
//         :162-167) is skipped whole: no code, local byte or centroid row
//         of it is read, nothing is scored or merged (ops/pq.py calls the
//         scan once a segment, over a view of the segment's rows);
//   ALL   cloudvectordb_tpu/ops/pallas_pq.py:510 pq_topk_pallas
//         (body _pq_scan_kernel :33): step j reads tile j, no residual
//         term, one pool.
// Built by cloudvectordb_tpu_torch/ops/_cuda.py with nvcc into a shared
// library and called through ctypes. The plain PyTorch version of the same
// contract is ops/pq.py::_pq_slots_reference.
//
// What it computes. Arena row g decodes to x[e] = cb[j][code(g, j)][e -
// j*dsub] (j = e / dsub), plus in residual mode ct[tile, local[g], e]; the
// score is the f32 dot of the bf16 query with x. Here it is taken in split
// form, score = q . cb^(g) + C[q, local(g)] with C[q, w] = q . ct[tile, w]:
// both terms are bf16 x bf16 products summed in f32, so only the order of
// the f32 sums differs from the reference (pallas_pq.py:183-204). Rows g >=
// n_valid score -inf and are never read (every offset into the codes, the
// local bytes, the mask and the bias is 64-bit: a 125M x 64 arena holds
// 8.0e9 code bytes; row ids stay below 2^31); with a row mask (one allow byte a
// row, pallas_pq.py:219-249) so do rows whose byte is 0, so a disallowed row
// never takes slot 1 or slot 2. The l2 key (pallas_pq.py:205-216) is
// q . x - |x|^2 / 2: here the score plus the row's bias -|x|^2 / 2, read
// from a per-row f32 table (pq_bias_kernel, below) that the caller writes
// once per arena state; x never exists in the scan, so the bias cannot come
// from it as the TPU's did. Codes are read through two
// strides, so the row-major (N, m) arena and a code-major (m, N) matrix
// (K6) need no copy. Each query keeps L = l_buckets slots per pool, two
// with top-2, merged as csrc/slot_merge.cuh says; output slot s = pool (or
// 2 pool, 2 pool + 1 with top-2) lies at out[s, query, b]. The final top-k
// over the slots is the caller's.
//
// How it maps to the card. One block owns QB queries of one query tile, SB
// = 2 QB consecutive slots and one pool, and loops over its pool's table
// entries itself, so no ordering between blocks is needed. Its queries are
// staged once in shared memory as bf16. Per step and per r the block's SB
// rows are scored by mma.sync m16n8k16 (bf16 in, f32 accumulate): rows are
// the A operand, queries the B operand. A row's A fragments never pass
// through shared memory: a lane's four values of a k-step are four
// consecutive dims of one codeword (the k order inside a step is permuted
// so; dsub % 4 == 0, else one value at a time), fetched by one 8-byte load
// from the bf16 codebooks addressed by the row's code byte, PF k-steps
// ahead of the product. Each warp takes 16 rows, all QB queries and half of
// the depth; the two halves are summed in shared memory in one fixed order
// (the last half first), and every thread then merges SB / 8 (query, slot)
// pairs, their values in registers (at QB 32 their rows too, and the tile's
// running best for r < R in shared memory; at QB 64 their rows in shared
// memory, the thread's own entries). The codes of the next row block are
// staged while the current one is scored. In residual mode C is formed once
// per (block, table entry) on the same path, 64 of the tile's W centroid
// rows at a time standing in for the decoded rows, 8 warps splitting the
// depth for each 32 queries, and C[q, local(g)] is added to each row's
// score. A row's mask byte and l2 bias are staged beside its local byte;
// one instantiation per (residual, mask, l2, top-2) keeps the serving
// variant as it was.
//
// The block width, read from the shape (block_queries): QB = 64 (16 warps,
// SB 128, one block an SM) where the query tile is a multiple of 64, each
// slot takes one row of a tile (R = 1: no running best to keep), the launch
// is unmasked and ranks by inner product, and its shared memory fits; else
// QB = 32 (8 warps, SB 64, two blocks an SM), whose instantiations and
// schedule are those the kernel had before it took a second width. QB 64
// is instantiated only for the variants the 64-query plans reach (TABLE
// residual or whole rows, top-1 or top-2, and ALL: 5 besides the 17 at QB
// 32), which keeps nvcc's time for this file near the 32-query build's; a
// masked or l2 launch at a 64-query tile runs at 32. At QB 64 each
// gathered A fragment feeds 8 MMAs instead of 4, so every row of a table
// entry is decoded once per 64 queries, and C and the staging of codes and
// local bytes happen once per 64 queries and 128 slots. Every (query, row)
// score is the same f32 sum at either width: the same k-steps of each half
// (and of each part of C's depth) on the same operands, the parts added in
// the same order, the merges in the same step order, so ids and scores are
// bit-identical (tests/port/test_torch_pq_scan_card.py holds a 64- or
// 128-query tile against its table run at tile_q 32).
//
// pq_bias_kernel: the l2 bias -|x|^2 / 2 of every arena row, a warp a row:
// the lanes take the row's dims in turn, x[e] is the f32 sum of the bf16
// codeword value and the bf16 centroid value (as interpret mode forms it),
// squares are summed in f64 and the warp's sums are added in a fixed
// shuffle order; one f32 a row.
//
// What bounds it, and what the design does about each limit. The least
// work of the function (chip_smoke.py::pq_bound) is small: the codes and
// centroid tiles of the tiles read, and the LUT-ADC form's m adds a (query,
// row) pair. An exact f32 lookup table (64 KB a query at m 64, nbits 8)
// leaves room for 3 queries an SM, and an f16 one breaks the 1e-4 score
// tolerance, so the card's route is the decode form on the tensor cores:
//   - the product: 2 * D flops a (query, row) on mma.sync, not f32 FMAs on
//     the CUDA cores (which held the earlier decode-in-shared-memory kernel
//     to 6.7 T flop/s on an H100);
//   - the decode: one 8-byte load per lane a k-step, no integer division
//     in the loop (a running (sub-space, offset) cursor), no shared-memory
//     round trip and no barrier per chunk; shared by the block's 32 or 64
//     queries. The codebooks (393 KB at m 64) exceed shared memory and
//     are read through L1/L2: these scattered loads (about 20 sectors a
//     warp a k-step at dsub 12) and each warp's wait on them are what
//     bound the kernel (A/B runs on an H100: PERF.md); QB 64 halves them
//     for a 64-query tile;
//   - the centroid term: W rows a table entry, not D adds a row;
//   - overlap: loads PF k-steps ahead; the next codes by cp.async, in
//     4-byte runs of a row of the row-major arena (K5) or 16-byte runs of
//     a sub-space of a code-major matrix (K6) (each 11-13% faster than
//     staging byte by byte in A/B runs on an H100: PERF.md); 16 warps an
//     SM at either width; three barriers a row block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "slot_merge.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int CW = 64;  // centroid rows of one pass of the residual term C
constexpr int SMEM_MAX = 232448;  // shared memory one block may use on sm_90 (ops/_cuda.py)

// The block at QB queries (32 or 64; file header).
template <int QB>
struct Shape {
  static constexpr int NT = QB / 8;          // n8 tiles of queries
  static constexpr int SB = 2 * QB;          // slots (rows) per block
  static constexpr int MT = SB / 16;         // its m16 tiles
  static constexpr int THREADS = 64 * MT;    // a warp a row tile and half of the depth
  static constexpr int RS = SB + 8;          // row stride (f32) of the score tile
  static constexpr int NJ = SB / 8;          // (query, slot) pairs a thread merges
  // QB 64: R = 1 only (no running best), and the slots' rows in shared
  // memory, so that the registers hold 8 x 4 accumulators and the values
  static constexpr bool WIDE = QB == 64;
};

// k-steps whose A fragments are loaded ahead of the product: 4, or 2 at QB
// 64 with top-2, whose second slot values take the registers a deeper ring
// would (A/B runs on an H100: PERF.md)
template <int QB, bool TOP2>
constexpr int PF = QB == 64 && TOP2 ? 2 : 4;

enum Source { ALL = 0, TABLE = 1 };
// how the codes of a row block are staged into shared memory: byte by
// byte, 4-byte runs of a row (row-major arena), 16-byte runs of a sub-space
// (code-major matrix)
enum CodeCopy { BYTES = 0, ROW4 = 1, SUB16 = 2 };

struct ScanArgs {
  const uint8_t* codes;     // code of (row g, sub-space j) at g*row_stride + j*sub_stride
  long long row_stride;
  long long sub_stride;
  const uint8_t* local;     // (N,) local list byte, residual mode
  const bf16* cb;           // (m, ncode, dsub)
  const bf16* ct;           // (n_tiles, W, D), residual mode
  const bf16* q;            // (n_qt * tile_q, D)
  const int32_t* table;     // (n_qt, steps), TABLE
  const uint8_t* mask;      // (N,) allow bytes, MASK
  const float* bias;        // (N,) f32 l2 bias -|x|^2 / 2, L2
  float* out_v;             // (n_slots, n_qt * tile_q, L)
  int32_t* out_i;
  int nq, tile_q, steps, tile_n, l_buckets, m, ncode, dsub, w, n_valid, n_pools;
  int n_live;               // table entries at or past it are skipped
  int code_copy;            // CodeCopy
};

__host__ __device__ inline int align16(int x) { return (x + 15) / 16 * 16; }

// Row stride (bf16) of the staged queries: D padded to a multiple of 16,
// plus a pad that puts consecutive rows 8 banks apart.
__host__ __device__ inline int q_stride(int dp) { return dp + 2 * (((8 - dp / 2) % 32 + 32) % 32); }

// Shared memory layout, in bytes: the queries, two code blocks, two
// local-byte blocks, two l2-bias blocks and two mask blocks (each present
// only when used), the score tile (QB x RS f32), at QB 32 the tile's running
// best per (query, slot) while r < R (value and r; two of each with top-2),
// the centroid term C (QB x W f32), at QB 64 the slots' rows (each
// thread's NJ, two of each with top-2).
struct Layout {
  int q, codes, local, bias, mask, red, tile, c, ids, total;
};

template <int QB>
__host__ __device__ inline Layout layout(int m, int dsub, int w, bool top2, bool mask, bool l2) {
  using S = Shape<QB>;
  const int dp = align16(m * dsub);
  Layout l;
  l.q = 0;
  l.codes = l.q + align16(QB * q_stride(dp) * 2);
  l.local = l.codes + 2 * align16(S::SB * (m + 4));
  l.bias = l.local + 2 * S::SB;
  l.mask = l.bias + (l2 ? 2 * S::SB * 4 : 0);
  l.red = l.mask + (mask ? 2 * S::SB : 0);
  l.tile = l.red + QB * S::RS * 4;
  l.c = l.tile + (S::WIDE ? 0 : QB * S::RS * (top2 ? 16 : 8));
  l.ids = l.c + align16(QB * w * 4);
  l.total = l.ids + (S::WIDE ? S::THREADS * S::NJ * (top2 ? 8 : 4) : 0);
  return l;
}

// The queries one block holds (file header): 64 where the query tile is a
// multiple of 64, R = 1, the launch is unmasked and ranks by inner product
// (the variants a 64-query plan reaches: QB 64 is instantiated for those
// alone, which keeps the build's time within a third of the 32-query
// one's), and the 64-query layout fits; else 32. The wrapper asks it
// (cvdb_pq_scan_block_queries) for the width of each launch it makes.
__host__ __device__ inline int block_queries(int tile_q, int tile_n, int l_buckets, int m,
                                             int dsub, int w, bool top2, bool mask, bool l2) {
  return tile_q % 64 == 0 && l_buckets == tile_n && !mask && !l2 &&
                 layout<64>(m, dsub, w, top2, false, false).total <= SMEM_MAX
             ? 64
             : 32;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES_>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES_ == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(BYTES_)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Fragments of mma.m16n8k16 (PTX ISA), lane = 4 g + t: A rows g and g + 8,
// B column g, accumulator c[4] rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at
// columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One row block of one step: its arena tile t, base row, r, first row and
// live rows (slots below L, rows in [0, n_valid)).
struct Block {
  int t, r, n_rows;
  long long base, row0;
};

// The depth order inside a k-step. Lane t's A values of a row at k 2t,
// 2t + 1, 2t + 8 and 2t + 9, and its B values at the same k, are taken from
// dims 4t .. 4t + 3 of the step's 16: a permutation of the sum's terms,
// which lets one 8-byte load fetch a lane's four values of a row.
template <int SRC, bool RESID, bool TOP2, bool MASK, bool L2, int QB>
__global__ void __launch_bounds__(Shape<QB>::THREADS, QB == 32 ? 2 : 1)
    pq_scan_kernel(const ScanArgs a) {
  using S = Shape<QB>;
  constexpr int SB = S::SB, RS = S::RS, THREADS = S::THREADS, NJ = S::NJ;
  // n8 tiles of queries for kloop and reduce: all QB, or the 32 of C's part
  using NT = std::integral_constant<int, S::NT>;
  using NT32 = std::integral_constant<int, 4>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout<QB>(a.m, a.dsub, RESID ? a.w : 0, TOP2, MASK, L2);
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  uint8_t* codes_s = smem + lay.codes;
  uint8_t* local_s = smem + lay.local;
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  uint8_t* mask_s = smem + lay.mask;
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* c_s = reinterpret_cast<float*>(smem + lay.c);
  float* tm1 = reinterpret_cast<float*>(smem + lay.tile);  // [query * RS + slot]
  int* tr1 = reinterpret_cast<int*>(tm1 + QB * RS);
  float* tm2 = reinterpret_cast<float*>(tr1 + QB * RS);  // top-2 only
  int* tr2 = reinterpret_cast<int*>(tm2 + QB * RS);
  const int codes_buf = (lay.local - lay.codes) / 2;
  const int d = a.m * a.dsub, dp = align16(d), nks = dp / 16, qs = q_stride(dp);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mt = warp & (S::MT - 1);      // the warp's 16 rows: 16 mt ..
  const int kh = warp >> (S::WIDE ? 3 : 2);  // and its half of the k-steps
  const int qblocks = (a.tile_q + QB - 1) / QB;
  const int qt = blockIdx.y / qblocks;
  const int q_lo = qt * a.tile_q + (blockIdx.y % qblocks) * QB;
  const int nq_blk = min(QB, (qt + 1) * a.tile_q - q_lo);
  const int b0 = blockIdx.x * SB;
  const int pid = blockIdx.z;
  const int L = a.l_buckets;
  const int R = S::WIDE ? 1 : a.tile_n / L;
  // code (row, sub-space) of a staged block at row * cr + sub * cs
  const int cr = a.code_copy == ROW4 ? a.m + 4 : 1;
  const int cs = a.code_copy == ROW4 ? 1 : SB;
  const bool whole = a.dsub % 4 == 0;  // a lane's 4 dims lie in one codeword
  const int n_steps = pid < a.steps ? (a.steps - pid + a.n_pools - 1) / a.n_pools : 0;
  const int n_it = n_steps * R;
  const int mq = tid >> 3, mr = tid & 7;  // the merge's query and first row

  // the block's queries, bf16, zero past D and past the tile's last query
  for (int i = tid; i < QB * dp; i += THREADS) {
    const int qi = i / dp, k = i - qi * dp;
    q_s[qi * qs + k] = (qi < nq_blk && k < d) ? a.q[(size_t)(q_lo + qi) * d + k]
                                               : __float2bfloat16(0.f);
  }

  auto block_of = [&](int it) {
    Block x;
    const int js = it / R;
    x.r = it - js * R;
    const int j = pid + js * a.n_pools;
    x.t = SRC == ALL ? j : a.table[(size_t)qt * a.steps + j];
    x.base = (long long)x.t * a.tile_n;
    x.row0 = x.base + (long long)x.r * L + b0;
    const long long hi = min((long long)min(SB, L - b0), (long long)a.n_valid - x.row0);
    x.n_rows = x.row0 < 0 ? 0 : (int)max(0LL, hi);
    return x;
  };

  // the first iteration at or after `it` whose table entry is below n_live
  // (n_it if none): an entry past it is skipped whole, its table word the
  // only thing read of it. The same for every thread of the block.
  auto next_live = [&](int it) {
    while (SRC == TABLE && it < n_it) {
      const int js = it / R;
      if (a.table[(size_t)qt * a.steps + pid + js * a.n_pools] < a.n_live) break;
      it = (js + 1) * R;
    }
    return it;
  };

  // the codes (as CodeCopy says), local bytes, l2 biases and mask bytes of
  // a row block into buffer bi; only live rows are read
  auto stage = [&](const Block& x, int bi) {
    uint8_t* dst = codes_s + bi * codes_buf;
    const uint8_t* src = a.codes + x.row0 * a.row_stride;
    if (a.code_copy == ROW4) {
      const int per = a.m / 4;
      for (int i = tid; i < x.n_rows * per; i += THREADS) {
        const int r = i / per, k = 4 * (i - r * per);
        cp_async<4>(dst + r * cr + k, src + r * a.row_stride + k);
      }
    } else {
      const int full = (a.code_copy == SUB16 && x.row0 % 16 == 0) ? x.n_rows / 16 : 0;
      for (int i = tid; i < a.m * full; i += THREADS) {
        const int s = i / full, k = 16 * (i - s * full);
        cp_async<16>(dst + s * SB + k, src + s * a.sub_stride + k);
      }
      const int rest = x.n_rows - 16 * full;
      for (int i = tid; i < a.m * rest; i += THREADS) {
        const int s = i / rest, r = 16 * full + i - s * rest;
        dst[s * SB + r] = src[r * a.row_stride + s * a.sub_stride];
      }
    }
    if (RESID || MASK || L2)
      for (int i = tid; i < x.n_rows; i += THREADS) {
        if (RESID) local_s[bi * SB + i] = a.local[x.row0 + i];
        if (L2) bias_s[bi * SB + i] = a.bias[x.row0 + i];
        if (MASK) mask_s[bi * SB + i] = a.mask[x.row0 + i];
      }
  };

  // k-steps [lo, hi) of the product of this warp's 16 rows (A, from
  // `load`) with the 8 N queries from q0 (B, from shared memory; N from the
  // type of nt_count): acc[nt] holds queries q0 + 8 nt ..; load(f) fetches
  // the next k-step's A values of rows g and g + 8
  float acc[S::NT][4];
  auto kloop = [&](auto nt_count, auto&& load, int ks_lo, int ks_hi, int q0) {
    constexpr int N = decltype(nt_count)::value;
#pragma unroll
    for (int nt = 0; nt < N; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    constexpr int F = PF<QB, TOP2>;
    uint2 fa[F][2];
#pragma unroll
    for (int i = 0; i < F; ++i)
      if (ks_lo + i < ks_hi) load(fa[i]);
    const bf16* qb = q_s + (q0 + g) * qs + 4 * t4;
    for (int base = ks_lo; base < ks_hi; base += F) {
#pragma unroll
      for (int i = 0; i < F; ++i) {
        const int ks = base + i;
        if (ks < ks_hi) {
          const uint32_t af[4] = {fa[i][0].x, fa[i][1].x, fa[i][0].y, fa[i][1].y};
          if (ks + F < ks_hi) load(fa[i]);
#pragma unroll
          for (int nt = 0; nt < N; ++nt) {
            const uint2 b = *reinterpret_cast<const uint2*>(qb + 8 * nt * qs + 16 * ks);
            mma_bf16(acc[nt], af, b.x, b.y);
          }
        }
      }
    }
  };

  // the depth cursor of this lane's loads: dim lp, and its sub-space ls and
  // offset le in it
  int lp = 0, ls = 0, le = 0;
  auto start = [&](int ks_lo) {
    lp = 16 * ks_lo + 4 * t4;
    ls = lp / a.dsub;
    le = lp - ls * a.dsub;
  };

  // A values of a row block's decoded rows 16 mt + g (+ 8): one 8-byte load
  // of the row's codeword, addressed by its code byte; zeros for dead rows
  // and past D
  auto row_loader = [&](const Block& x, int bi) {
    const uint8_t* codes = codes_s + bi * codes_buf;
    return [&, codes, n_rows = x.n_rows](uint2 (&f)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * mt + g + 8 * h;
        uint2 v = make_uint2(0, 0);
        if (row < n_rows && lp < d) {
          if (whole) {
            const int code = codes[row * cr + ls * cs];
            v = __ldg(reinterpret_cast<const uint2*>(a.cb + ((size_t)ls * a.ncode + code) * a.dsub +
                                                     le));
          } else {
            bf16 e4[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int p = lp + k, s = p / a.dsub;
              e4[k] = p < d ? a.cb[((size_t)s * a.ncode + codes[row * cr + s * cs]) * a.dsub +
                                   p - s * a.dsub]
                            : __float2bfloat16(0.f);
            }
            v = make_uint2(pack2(e4[0], e4[1]), pack2(e4[2], e4[3]));
          }
        }
        f[h] = v;
      }
      lp += 16;
      for (le += 16; le >= a.dsub; le -= a.dsub) ++ls;
    };
  };

  // A values of centroid rows w0 + 16 tile + g (+ 8) of tile t; zeros past
  // W and past D
  auto ct_loader = [&](const Block& x, int w0, int tile) {
    const bf16* rows = a.ct + ((size_t)x.t * a.w + w0) * d;
    return [&, rows, tile, wn = a.w - w0](uint2 (&f)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = 16 * tile + g + 8 * h;
        uint2 v = make_uint2(0, 0);
        if (w < wn && lp < d) {
          const bf16* p = rows + (size_t)w * d + lp;
          if (d % 4 == 0) {
            v = __ldg(reinterpret_cast<const uint2*>(p));
          } else {
            bf16 e4[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) e4[k] = lp + k < d ? p[k] : __float2bfloat16(0.f);
            v = make_uint2(pack2(e4[0], e4[1]), pack2(e4[2], e4[3]));
          }
        }
        f[h] = v;
      }
      lp += 16;
    };
  };

  // the nsplit parts of the depth summed into the score tile
  // red[query][row], in one fixed order: the last part written first, each
  // earlier one added to it. The warp holds rows 16 tile .. of part split
  // for kloop's queries.
  auto reduce = [&](auto nt_count, int tile, int split, int nsplit, bool live, int q0) {
    constexpr int N = decltype(nt_count)::value;
    for (int part = nsplit - 1; part >= 0; --part) {
      if (live && split == part) {
#pragma unroll
        for (int nt = 0; nt < N; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& r =
                red[(q0 + 8 * nt + 2 * t4 + (e & 1)) * RS + 16 * tile + g + 8 * (e >> 1)];
            r = part == nsplit - 1 ? acc[nt][e] : acc[nt][e] + r;
          }
      }
      __syncthreads();
    }
  };

  // the slots: values in registers, rows in registers (QB 32) or in this
  // thread's entries of shared memory (QB 64)
  float v1[NJ], v2[NJ];
  int i1r[S::WIDE ? 1 : NJ], i2r[S::WIDE ? 1 : NJ];
  int* ids_s = reinterpret_cast<int*>(smem + lay.ids) + tid;
  auto i1 = [&](int j) -> int& {
    if constexpr (S::WIDE) return ids_s[j * THREADS];
    else return i1r[j];
  };
  auto i2 = [&](int j) -> int& {
    if constexpr (S::WIDE) return ids_s[(NJ + j) * THREADS];
    else return i2r[j];
  };
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    slot_init(v1[j], i1(j));
    if (TOP2) slot_init(v2[j], i2(j));
  }

  // each of the thread's NJ (query mq, row mr + 8 j) scores into the tile's
  // running best (shared memory, this thread's own entries); after the last
  // r, into the slots. With R = 1 the score is the tile's best.
  auto merge = [&](const Block& x, int bi) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int row = mr + 8 * j, o = mq * RS + row;
      float sc = -INFINITY;
      if (row < x.n_rows && (!MASK || mask_s[bi * SB + row])) {
        sc = red[o];
        if (RESID) {
          const int l = local_s[bi * SB + row];
          if (l < a.w) sc += c_s[mq * a.w + l];
        }
        if (L2) sc += bias_s[bi * SB + row];
      }
      const long long col = b0 + row;
      if (R == 1) {
        if (TOP2)
          slot_merge2(sc, x.base + col, -INFINITY, x.base + col, v1[j], i1(j), v2[j], i2(j));
        else
          slot_merge(sc, x.base + col, v1[j], i1(j));
        continue;
      }
      if (TOP2)
        tile_take2(sc, x.r, tm1[o], tr1[o], tm2[o], tr2[o]);
      else
        tile_take(sc, x.r, tm1[o], tr1[o]);
      if (x.r != R - 1) continue;
      if (TOP2)
        slot_merge2(tm1[o], x.base + (long long)tr1[o] * L + col, tm2[o],
                    x.base + (long long)tr2[o] * L + col, v1[j], i1(j), v2[j], i2(j));
      else
        slot_merge(tm1[o], x.base + (long long)tr1[o] * L + col, v1[j], i1(j));
    }
  };

  int it = next_live(0);
  if (it < n_it) {
    Block cur = block_of(it), nxt = cur;
    stage(cur, 0);
    cp_commit();
    for (int k = 0; it < n_it; ++k) {  // k: the live iterations, whose parity picks the buffer
      cp_wait_all();
      __syncthreads();  // this block's codes and local bytes are in; the score tile is free
      const int it_next = next_live(it + 1);
      if (it_next < n_it) {
        nxt = block_of(it_next);
        stage(nxt, (k + 1) & 1);
      }
      cp_commit();
      if (RESID && cur.r == 0) {  // C[q, w] = q . ct[t, w], CW centroid rows at a time
        for (int w0 = 0; w0 < a.w; w0 += CW) {
          // up to 2 tiles of 16 centroid rows: 8 warps as 2 tiles x 4
          // quarters of the depth; else 4 tiles x 2 halves; 8 warps for
          // each 32 queries (at QB 64 warps 8-15 the second 32). At QB 32
          // mt and kh, the same values, keep the machine code it had.
          const int wn = min(CW, a.w - w0), quarters = wn <= 32;
          const int w8 = S::WIDE ? warp & 7 : warp, q0 = S::WIDE ? 32 * (warp >> 3) : 0;
          const int tile = quarters ? w8 & 1 : S::WIDE ? w8 & 3 : mt;
          const int split = quarters ? w8 >> 1 : S::WIDE ? w8 >> 2 : kh;
          const int nsplit = quarters ? 4 : 2;
          const int lo = split * nks / nsplit, hi = (split + 1) * nks / nsplit;
          const bool live = 16 * tile < wn;  // else: columns C never reads
          start(lo);
          if (live) kloop(NT32(), ct_loader(cur, w0, tile), lo, hi, q0);
          reduce(NT32(), tile, split, nsplit, live, q0);
          for (int i = tid; i < QB * wn; i += THREADS) {
            const int qi = i / wn, w = i - qi * wn;
            c_s[qi * a.w + w0 + w] = red[qi * RS + w];
          }
          __syncthreads();
        }
      }
      const int lo = kh * nks / 2, hi = (kh + 1) * nks / 2;
      const bool live = 16 * mt < cur.n_rows;  // else: dead rows
      start(lo);
      if (live) kloop(NT(), row_loader(cur, k & 1), lo, hi, 0);
      reduce(NT(), mt, kh, 2, live, 0);
      merge(cur, k & 1);
      cur = nxt;
      it = it_next;
    }
  }

  const int s1 = TOP2 ? 2 * pid : pid;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int b = b0 + mr + 8 * j;
    if (mq < nq_blk && b < L) {
      const size_t o = ((size_t)s1 * a.nq + q_lo + mq) * L + b;
      a.out_v[o] = v1[j];
      a.out_i[o] = i1(j);
      if (TOP2) {
        const size_t o2 = o + (size_t)a.nq * L;
        a.out_v[o2] = v2[j];
        a.out_i[o2] = i2(j);
      }
    }
  }
}

template <int SRC, bool RESID, bool TOP2, bool MASK, bool L2, int QB>
cudaError_t launch_width(const ScanArgs& a, int n_qt, cudaStream_t stream) {
  using S = Shape<QB>;
  const int smem = layout<QB>(a.m, a.dsub, RESID ? a.w : 0, TOP2, MASK, L2).total;
  const cudaError_t err =
      cudaFuncSetAttribute(pq_scan_kernel<SRC, RESID, TOP2, MASK, L2, QB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int qblocks = (a.tile_q + QB - 1) / QB;
  const dim3 grid((a.l_buckets + S::SB - 1) / S::SB, n_qt * qblocks, a.n_pools);
  pq_scan_kernel<SRC, RESID, TOP2, MASK, L2, QB><<<grid, S::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int SRC, bool RESID, bool TOP2, bool MASK, bool L2>
cudaError_t launch(const ScanArgs& a, int n_qt, cudaStream_t stream) {
  if constexpr (!MASK && !L2)
    if (block_queries(a.tile_q, a.tile_n, a.l_buckets, a.m, a.dsub, RESID ? a.w : 0, TOP2,
                      false, false) == 64)
      return launch_width<SRC, RESID, TOP2, false, false, 64>(a, n_qt, stream);
  return launch_width<SRC, RESID, TOP2, MASK, L2, 32>(a, n_qt, stream);
}

// TABLE's 20 instantiations: one per (residual, top-2, mask, l2) at QB 32,
// and the 4 unmasked inner-product ones at QB 64.
template <bool RESID, bool TOP2, bool MASK>
cudaError_t launch_l2(const ScanArgs& a, int n_qt, cudaStream_t s) {
  return a.bias ? launch<TABLE, RESID, TOP2, MASK, true>(a, n_qt, s)
                : launch<TABLE, RESID, TOP2, MASK, false>(a, n_qt, s);
}

template <bool RESID, bool TOP2>
cudaError_t launch_table(const ScanArgs& a, int n_qt, cudaStream_t s) {
  return a.mask ? launch_l2<RESID, TOP2, true>(a, n_qt, s)
                : launch_l2<RESID, TOP2, false>(a, n_qt, s);
}

// The l2 bias of rows [0, n): a warp a row (file header).
__global__ void __launch_bounds__(256) pq_bias_kernel(
    const uint8_t* __restrict__ codes, long long row_stride, long long sub_stride,
    const uint8_t* __restrict__ local, const bf16* __restrict__ cb, const bf16* __restrict__ ct,
    float* __restrict__ out, long long n, int tile_n, int m, int ncode, int dsub, int w) {
  const long long g = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (g >= n) return;
  const int d = m * dsub;
  const uint8_t* row = codes + g * row_stride;
  const bf16* crow = ct ? ct + (static_cast<long long>(g / tile_n) * w + local[g]) * d : nullptr;
  double acc = 0.0;
  for (int e = lane; e < d; e += 32) {
    const int j = e / dsub;
    float x = __bfloat162float(cb[(static_cast<long long>(j) * ncode +
                                   row[static_cast<long long>(j) * sub_stride]) * dsub + e -
                                  j * dsub]);
    if (crow) x += __bfloat162float(crow[e]);
    acc += static_cast<double>(x) * x;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[g] = static_cast<float>(-0.5 * acc);
}

}  // namespace

extern "C" {

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory a block of 32 queries needs (w = 0 without the
// residual term); the 64-query block is launched only where its own fits.
int cvdb_pq_scan_smem_bytes(int m, int dsub, int w, int top2, int mask, int l2) {
  return layout<32>(m, dsub, w, top2, mask, l2).total;
}

// The queries one block of a launch at these shapes holds: 32 or 64.
int cvdb_pq_scan_block_queries(int tile_q, int tile_n, int l_buckets, int m, int dsub, int w,
                               int top2, int mask, int l2) {
  return block_queries(tile_q, tile_n, l_buckets, m, dsub, w, top2, mask, l2);
}

// Launches the scan on `stream`; returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for a source/option pair it does not take: ALL is
// the non-residual, unmasked, one-pool ip scan). `ct` null means no
// residual term, `mask` null no row mask, `bias` null the ip key; table
// entries at or past `n_live` are skipped (INT_MAX: none).
int cvdb_pq_scan(int source, int top2, const void* codes, long long row_stride,
                 long long sub_stride, const void* local, const void* cb, const void* ct,
                 const void* q, const void* table, const void* mask, const void* bias,
                 void* out_v, void* out_i, int n_qt, int tile_q, int steps, int tile_n,
                 int l_buckets, int m, int ncode, int dsub, int w, int n_valid, int n_pools,
                 int n_live, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t p = reinterpret_cast<uintptr_t>(codes);
  const int copy = (sub_stride == 1 && row_stride % 4 == 0 && p % 4 == 0 && m % 4 == 0) ? ROW4
                   : (row_stride == 1 && sub_stride % 16 == 0 && p % 16 == 0)     ? SUB16
                                                                                   : BYTES;
  const ScanArgs a{static_cast<const uint8_t*>(codes), row_stride, sub_stride,
                   static_cast<const uint8_t*>(local), static_cast<const bf16*>(cb),
                   static_cast<const bf16*>(ct), static_cast<const bf16*>(q),
                   static_cast<const int32_t*>(table), static_cast<const uint8_t*>(mask),
                   static_cast<const float*>(bias), static_cast<float*>(out_v),
                   static_cast<int32_t*>(out_i), n_qt * tile_q, tile_q, steps, tile_n,
                   l_buckets, m, ncode, dsub, w, n_valid, n_pools, n_live, copy};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool resid = ct != nullptr;
  if (source == ALL && !resid && !top2 && !mask && !bias && n_pools == 1)
    err = launch<ALL, false, false, false, false>(a, n_qt, s);
  else if (source != TABLE)
    err = cudaErrorInvalidValue;
  else if (resid)
    err = top2 ? launch_table<true, true>(a, n_qt, s) : launch_table<true, false>(a, n_qt, s);
  else
    err = top2 ? launch_table<false, true>(a, n_qt, s) : launch_table<false, false>(a, n_qt, s);
  return static_cast<int>(err);
}

// Writes the l2 bias -|x|^2 / 2 of rows [0, n) to `out` on `stream`; `ct`
// and `local` null mean no residual term. Returns cudaGetLastError().
int cvdb_pq_row_bias(const void* codes, long long row_stride, long long sub_stride,
                     const void* local, const void* cb, const void* ct, void* out, long long n,
                     int tile_n, int m, int ncode, int dsub, int w, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const long long blocks = (n + 7) / 8;  // 8 warps a block, a row a warp
    pq_bias_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), row_stride, sub_stride,
        static_cast<const uint8_t*>(local), static_cast<const bf16*>(cb),
        static_cast<const bf16*>(ct), static_cast<float*>(out), n, tile_n, m, ncode, dsub, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
