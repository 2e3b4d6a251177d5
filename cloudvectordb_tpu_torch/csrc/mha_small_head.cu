// K4: masked multi-head attention over head-packed rows, forward and
// backward, for Hopper (sm_90a), plain C interface.
//
// Replaces cloudvectordb_tpu/ops/pallas_attn.py:109 mha_small_head (forward
// body _fwd_kernel :40, backward body _bwd_kernel :61, custom VJP :119-137).
// Built by cloudvectordb_tpu_torch/ops/_cuda.py with nvcc into a shared
// library and called through ctypes. The plain PyTorch version of the same
// contract is ops/attn.py (_fwd_plain, _bwd_plain).
//
// What it computes. q, k and v are (B, L, H*D) rows in f32 or bf16, head h
// in columns h*D .. (h+1)*D; mask is (B, L) int32 over keys. Per sequence b
// and head h, in f32: s = (q_h * scale) k_h^T; keys with mask == 0 score
// -1e30 (not -inf: a fully masked row then gives the mean of v over all L
// keys, as the reference does); p = softmax(s); o_h = p v_h, stored in q's
// type. The backward recomputes p and writes, in q's type,
//   dv_h = p^T do_h,  dp = do_h v_h^T,  ds = p * (dp - rowsum(dp * p)),
//   dq_h = scale * ds k_h,  dk_h = ds^T (q_h * scale).
//
// How it maps to the card. The TPU kernel holds one whole sequence in VMEM
// per grid step and loops over heads. Here one block owns 128 rows (queries
// for the forward and dq, keys for dk/dv) of one (sequence, head) and loops
// over the other side in tiles of 32 staged in shared memory as f32. A row
// is owned by D/16 adjacent threads, each holding 16 of its D values in
// registers; a dot product is their partial sums (four independent chains
// each) joined by warp shuffles, so every thread of the group sees the same
// score and no scores are kept in memory. The forward runs an online
// softmax (running max m and sum l per row, rescaled once per key tile) and
// writes m and l per row, f32 (B, H, L). The backward takes
// p = exp(s - m) * (1 / l) from them, the reference's normalisation of the
// same scores up to one rounding of the reciprocal, and runs two kernels,
// with no atomics, so every gradient is summed in one fixed order:
//   dq  per 128 queries, looping over keys: rowsum(dp * p) and
//       sum_j p dp k_j and sum_j p k_j in one pass, so that
//       dq = scale * (sum_j p dp k_j - rowsum * sum_j p k_j); it also writes
//       rowsum (B, H, L) for the second kernel. (A pre-pass for rowsum would
//       cost a second sweep; do . o would need o in f32, which the forward
//       does not keep for bf16 rows.) The cancellation in the last step
//       costs ~1e-7 of |sum_j p dp k_j| in f32, far inside the tolerances
//       of the checks (2e-5 f32, bf16 rounding for bf16).
//   dkdv per 128 keys, looping over queries: dv_j += p do_i and
//       dk_j += ds (q_i * scale), with rowsum read back per query.
//
// What bounds it. At the training shape (B 1536, L 128, H 12, D 32, bf16)
// the forward must read q, k, v and write o, 604 MB, 0.18 ms at 3.35 TB/s,
// and do 3.9e10 FLOP, 0.04 ms at the tensor cores' 989 TFLOP/s: the work is
// memory-bound. The backward reads q, k, v and do and writes dq, dk and dv
// (1.06 GB, 0.32 ms) for ~9.7e10 FLOP. This simple kernel runs f32 FMAs
// on the CUDA cores (33.5 T FMA/s at most) fed by broadcast shared-memory
// loads (one 16-byte load per four FMAs), so it is bound by the issue rate
// of those instructions and by the latency of each key's chain (dot,
// shuffle, exp, update), several times above the memory bound. mma.sync or
// wgmma for the two products per tile is the next step for speed; it does
// not change the contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int ROWS = 128;   // rows a block owns: queries (fwd, dq) or keys (dk/dv)
constexpr int TILE = 32;    // rows of the other side staged per step
constexpr int SLICE = 16;   // head values one thread holds
constexpr int PAD = 20;     // floats between slices in shared memory: the
                            // 2 or 4 slices of one row sit in distinct banks
constexpr float MASKED = -1e30f;
// blocks per SM the backward kernels are compiled for: 16 warps, so at
// most 128 registers a thread
#define BWD_BLOCKS(D) (512 / (ROWS * ((D) / SLICE)))

enum Elem { F32 = 0, BF16 = 1 };

__device__ __forceinline__ void load_slice(const float* p, float (&x)[SLICE]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int c = 0; c < SLICE / 4; ++c) {
    const float4 w = p4[c];
    x[4 * c] = w.x;
    x[4 * c + 1] = w.y;
    x[4 * c + 2] = w.z;
    x[4 * c + 3] = w.w;
  }
}

__device__ __forceinline__ void load_slice(const __nv_bfloat16* p, float (&x)[SLICE]) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < SLICE / 8; ++c) {
    const uint4 w4 = p4[c];
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // element 2e in the low half, 2e+1 in the high
      x[8 * c + 2 * e] = __uint_as_float(w[e] << 16);
      x[8 * c + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void store_slice(float* p, const float (&x)[SLICE]) {
  float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int c = 0; c < SLICE / 4; ++c)
    p4[c] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store_slice(__nv_bfloat16* p, const float (&x)[SLICE]) {
  uint4* p4 = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int c = 0; c < SLICE / 8; ++c)
    p4[c] = make_uint4(pack_bf16(x[8 * c], x[8 * c + 1]), pack_bf16(x[8 * c + 2], x[8 * c + 3]),
                       pack_bf16(x[8 * c + 4], x[8 * c + 5]),
                       pack_bf16(x[8 * c + 6], x[8 * c + 7]));
}

// Four independent partial sums: a chain of 4 dependent FMAs, not 16.
__device__ __forceinline__ float dot_slice(const float (&a)[SLICE], const float (&b)[SLICE]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < SLICE; ++e) s[e % 4] = fmaf(a[e], b[e], s[e % 4]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// Sum over the G adjacent lanes that own one row: every lane of the group
// gets the same bits (each step adds the same two values, in either order).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage TILE rows (stride `stride` elements, D values each, times `mul`) as
// f32 into dst[TILE][G][PAD].
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long stride, float mul) {
  constexpr int G = D / SLICE;
  for (int c = threadIdx.x; c < TILE * G; c += blockDim.x) {
    const int r = c / G, t = c % G;
    float x[SLICE];
    load_slice(src + r * stride + t * SLICE, x);
#pragma unroll
    for (int e = 0; e < SLICE; ++e) x[e] *= mul;
    store_slice(dst + (r * G + t) * PAD, x);
  }
}

struct Rows {  // where this thread's row and slice sit
  int b, h, row, t;
  long seq, hd, head;
};

template <int D>
__device__ __forceinline__ Rows rows_of(int L, int H) {
  constexpr int G = D / SLICE;
  const int tiles = L / ROWS;
  Rows r;
  r.b = blockIdx.x / tiles;
  r.row = (blockIdx.x % tiles) * ROWS + threadIdx.x / G;
  r.t = threadIdx.x % G;
  r.h = blockIdx.y;
  r.hd = static_cast<long>(H) * D;
  r.seq = static_cast<long>(r.b) * L;
  r.head = static_cast<long>(r.h) * D + r.t * SLICE;
  return r;
}

template <int D, typename T>
__global__ void __launch_bounds__(ROWS * (D / SLICE))
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ mask, T* __restrict__ o, float* __restrict__ row_max,
               float* __restrict__ row_sum, int L, int H, float scale) {
  constexpr int G = D / SLICE;
  __shared__ __align__(16) float ks[TILE * G * PAD];
  __shared__ __align__(16) float vs[TILE * G * PAD];
  __shared__ int live[TILE];
  const Rows r = rows_of<D>(L, H);
  const long key0 = r.seq * r.hd + static_cast<long>(r.h) * D;

  float qr[SLICE], acc[SLICE];
  load_slice(q + (r.seq + r.row) * r.hd + r.head, qr);
#pragma unroll
  for (int e = 0; e < SLICE; ++e) {
    qr[e] *= scale;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < L; j0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(ks, k + key0 + j0 * r.hd, r.hd, 1.f);
    stage<D>(vs, v + key0 + j0 * r.hd, r.hd, 1.f);
    if (threadIdx.x < TILE) live[threadIdx.x] = mask[r.seq + j0 + threadIdx.x];
    __syncthreads();
    float s[TILE];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      float kr[SLICE];
      load_slice(ks + (j * G + r.t) * PAD, kr);
      const float dot = group_sum<G>(dot_slice(qr, kr));
      s[j] = live[j] > 0 ? dot : MASKED;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)
    l *= alpha;
#pragma unroll
    for (int e = 0; e < SLICE; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      float vr[SLICE];
      load_slice(vs + (j * G + r.t) * PAD, vr);
#pragma unroll
      for (int e = 0; e < SLICE; ++e) acc[e] = fmaf(p, vr[e], acc[e]);
    }
    m = m_new;
  }
#pragma unroll
  for (int e = 0; e < SLICE; ++e) acc[e] = acc[e] / l;
  store_slice(o + (r.seq + r.row) * r.hd + r.head, acc);
  if (r.t == 0) {
    const long stat = (static_cast<long>(r.b) * H + r.h) * L + r.row;
    row_max[stat] = m;
    row_sum[stat] = l;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(ROWS * (D / SLICE), BWD_BLOCKS(D))
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ mask, const T* __restrict__ dout,
                  const float* __restrict__ row_max, const float* __restrict__ row_sum,
                  T* __restrict__ dq, float* __restrict__ delta, int L, int H, float scale) {
  constexpr int G = D / SLICE;
  __shared__ __align__(16) float ks[TILE * G * PAD];
  __shared__ __align__(16) float vs[TILE * G * PAD];
  __shared__ int live[TILE];
  const Rows r = rows_of<D>(L, H);
  const long key0 = r.seq * r.hd + static_cast<long>(r.h) * D;
  const long stat = (static_cast<long>(r.b) * H + r.h) * L + r.row;
  const float m = row_max[stat], inv_l = 1.f / row_sum[stat];

  float qr[SLICE], dor[SLICE], pdpk[SLICE], pk[SLICE];
  load_slice(q + (r.seq + r.row) * r.hd + r.head, qr);
  load_slice(dout + (r.seq + r.row) * r.hd + r.head, dor);
#pragma unroll
  for (int e = 0; e < SLICE; ++e) {
    qr[e] *= scale;
    pdpk[e] = 0.f;
    pk[e] = 0.f;
  }
  float rowsum = 0.f;
  for (int j0 = 0; j0 < L; j0 += TILE) {
    __syncthreads();
    stage<D>(ks, k + key0 + j0 * r.hd, r.hd, 1.f);
    stage<D>(vs, v + key0 + j0 * r.hd, r.hd, 1.f);
    if (threadIdx.x < TILE) live[threadIdx.x] = mask[r.seq + j0 + threadIdx.x];
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < TILE; ++j) {
      float kr[SLICE], vr[SLICE];
      load_slice(ks + (j * G + r.t) * PAD, kr);
      load_slice(vs + (j * G + r.t) * PAD, vr);
      const float dot = group_sum<G>(dot_slice(qr, kr));
      const float s = live[j] > 0 ? dot : MASKED;
      const float p = expf(s - m) * inv_l;
      const float dp = group_sum<G>(dot_slice(dor, vr));
      const float pdp = p * dp;
      rowsum += pdp;
#pragma unroll
      for (int e = 0; e < SLICE; ++e) {
        pdpk[e] = fmaf(pdp, kr[e], pdpk[e]);
        pk[e] = fmaf(p, kr[e], pk[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < SLICE; ++e) pdpk[e] = scale * (pdpk[e] - rowsum * pk[e]);
  store_slice(dq + (r.seq + r.row) * r.hd + r.head, pdpk);
  if (r.t == 0) delta[stat] = rowsum;
}

template <int D, typename T>
__global__ void __launch_bounds__(ROWS * (D / SLICE), BWD_BLOCKS(D))
mha_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ mask, const T* __restrict__ dout,
                    const float* __restrict__ row_max, const float* __restrict__ row_sum,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int L, int H, float scale) {
  constexpr int G = D / SLICE;
  __shared__ __align__(16) float qs[TILE * G * PAD];
  __shared__ __align__(16) float dos[TILE * G * PAD];
  __shared__ float sm[TILE], sl[TILE], sd[TILE];  // row max, 1 / row sum, rowsum(dp * p)
  const Rows r = rows_of<D>(L, H);  // r.row is a key here
  const long query0 = r.seq * r.hd + static_cast<long>(r.h) * D;
  const long stat0 = (static_cast<long>(r.b) * H + r.h) * L;
  const bool allow = mask[r.seq + r.row] > 0;

  float kr[SLICE], vr[SLICE], dkr[SLICE], dvr[SLICE];
  load_slice(k + (r.seq + r.row) * r.hd + r.head, kr);
  load_slice(v + (r.seq + r.row) * r.hd + r.head, vr);
#pragma unroll
  for (int e = 0; e < SLICE; ++e) {
    dkr[e] = 0.f;
    dvr[e] = 0.f;
  }
  for (int i0 = 0; i0 < L; i0 += TILE) {
    __syncthreads();
    stage<D>(qs, q + query0 + i0 * r.hd, r.hd, scale);
    stage<D>(dos, dout + query0 + i0 * r.hd, r.hd, 1.f);
    if (threadIdx.x < TILE) {
      sm[threadIdx.x] = row_max[stat0 + i0 + threadIdx.x];
      sl[threadIdx.x] = 1.f / row_sum[stat0 + i0 + threadIdx.x];
      sd[threadIdx.x] = delta[stat0 + i0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < TILE; ++i) {
      float qv[SLICE], dov[SLICE];
      load_slice(qs + (i * G + r.t) * PAD, qv);
      load_slice(dos + (i * G + r.t) * PAD, dov);
      const float dot = group_sum<G>(dot_slice(qv, kr));
      const float s = allow ? dot : MASKED;
      const float p = expf(s - sm[i]) * sl[i];
      const float dp = group_sum<G>(dot_slice(dov, vr));
      const float ds = p * (dp - sd[i]);
#pragma unroll
      for (int e = 0; e < SLICE; ++e) {
        dvr[e] = fmaf(p, dov[e], dvr[e]);
        dkr[e] = fmaf(ds, qv[e], dkr[e]);
      }
    }
  }
  store_slice(dk + (r.seq + r.row) * r.hd + r.head, dkr);
  store_slice(dv + (r.seq + r.row) * r.hd + r.head, dvr);
}

template <int D, typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                void* row_max, void* row_sum, int B, int L, int H, float scale,
                cudaStream_t stream) {
  const dim3 grid(B * (L / ROWS), H);
  mha_fwd_kernel<D, T><<<grid, ROWS * (D / SLICE), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<T*>(o), static_cast<float*>(row_max),
      static_cast<float*>(row_sum), L, H, scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* mask, const void* dout,
                const void* row_max, const void* row_sum, void* dq, void* dk, void* dv,
                void* delta, int B, int L, int H, float scale, cudaStream_t stream) {
  const dim3 grid(B * (L / ROWS), H);
  mha_bwd_dq_kernel<D, T><<<grid, ROWS * (D / SLICE), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(row_max), static_cast<const float*>(row_sum),
      static_cast<T*>(dq), static_cast<float*>(delta), L, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkdv_kernel<D, T><<<grid, ROWS * (D / SLICE), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(row_max), static_cast<const float*>(row_sum),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale);
  return cudaGetLastError();
}

bool shape_ok(int elem, int d, int B, int L, int H) {
  return (elem == F32 || elem == BF16) && (d == 16 || d == 32 || d == 64) && B > 0 && H > 0 &&
         H <= 65535 && L > 0 && L % ROWS == 0 &&
         static_cast<long>(B) * (L / ROWS) <= 0x7fffffffL;
}

}  // namespace

extern "C" {

const char* cvdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: o (B, L, H*d) in the rows' type, row_max and row_sum
// (B, H, L) f32. Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a type, d or L the kernel does not take.
int cvdb_mha_fwd(int elem, int d, const void* q, const void* k, const void* v, const void* mask,
                 void* o, void* row_max, void* row_sum, int B, int L, int H, float scale,
                 int device, void* stream) {
  if (!shape_ok(elem, d, B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CVDB_FWD(DD, T) fwd<DD, T>(q, k, v, mask, o, row_max, row_sum, B, L, H, scale, s)
  if (elem == F32)
    err = d == 16 ? CVDB_FWD(16, float) : d == 32 ? CVDB_FWD(32, float) : CVDB_FWD(64, float);
  else
    err = d == 16   ? CVDB_FWD(16, __nv_bfloat16)
          : d == 32 ? CVDB_FWD(32, __nv_bfloat16)
                    : CVDB_FWD(64, __nv_bfloat16);
#undef CVDB_FWD
  return static_cast<int>(err);
}

// Backward on `stream` from the forward's row_max and row_sum: dq, dk, dv
// (B, L, H*d) in the rows' type; delta (B, H, L) f32 is scratch (the
// per-query rowsum(dp * p)). Two launches, dq then dk/dv; returns the first
// non-zero cudaGetLastError().
int cvdb_mha_bwd(int elem, int d, const void* q, const void* k, const void* v, const void* mask,
                 const void* dout, const void* row_max, const void* row_sum, void* dq, void* dk,
                 void* dv, void* delta, int B, int L, int H, float scale, int device,
                 void* stream) {
  if (!shape_ok(elem, d, B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CVDB_BWD(DD, T) \
  bwd<DD, T>(q, k, v, mask, dout, row_max, row_sum, dq, dk, dv, delta, B, L, H, scale, s)
  if (elem == F32)
    err = d == 16 ? CVDB_BWD(16, float) : d == 32 ? CVDB_BWD(32, float) : CVDB_BWD(64, float);
  else
    err = d == 16   ? CVDB_BWD(16, __nv_bfloat16)
          : d == 32 ? CVDB_BWD(32, __nv_bfloat16)
                    : CVDB_BWD(64, __nv_bfloat16);
#undef CVDB_BWD
  return static_cast<int>(err);
}

}  // extern "C"
