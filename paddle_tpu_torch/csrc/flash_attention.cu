// Flash attention for Hopper (sm_90a) — the training kernels K3, K4, K5.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas_kernels/flash_attention.py:
//   pt_flash_fwd     ← `_fa_kernel`          (FA-2 forward: out and the
//                                             per-row logsumexp lse)
//   pt_flash_bwd_dq  ← `_fa_bwd_dq_kernel`   (dq)
//   pt_flash_bwd_dkv ← `_fa_bwd_dkv_kernel`  (dk and dv)
// on the [batch·heads, seq, head_dim] layout, causal (top-aligned
// diagonal: row >= col) or not, with an optional per-row valid key length
// `lens` (key-padding mask; the wrapper clamps it to seq_k).
//
// Two routes, chosen by the caller from the input type and head_dim
// (ops/cuda_kernels/flash_attention.py, `tensor_core_route`):
//   * tensor cores — bf16 with head_dim 64 or 128: pt_flash_fwd_tc
//     (`fa_fwd_tc_kernel`), pt_flash_bwd_dq_tc (`fa_bwd_dq_tc_kernel`)
//     and pt_flash_bwd_dkv_tc (`fa_bwd_dkv_tc_kernel`), at the end of
//     this file, on the helpers of mma_sm90.cuh;
//   * CUDA cores — everything else: the f32-math kernels right below,
//     exact in f32.
// A tensor-core entry point refuses what it does not take
// (cudaErrorInvalidValue); nothing falls back from one route to the other.
//
// What bounds them. At the GPT training shapes (b·h 192, s 1024, d 64,
// bf16, causal) each kernel does ~26-52 GFLOP on ~100-150 MB, about 250-
// 340 flops per byte: right at the H100's bf16 ridge (~295 flops/byte), so
// the least time is set by the tensor cores' 989 TFLOP/s and HBM's
// 3.35 TB/s about equally. The CUDA-core kernels do their math in f32
// (67 TFLOP/s peak), so they are compute-bound well above that bound;
// the tensor-core kernels' design is described above them.
//
// CUDA-core design. The Pallas grid walks (bh, q-block, kv-block) in order and
// carries the online-softmax state (m, l, acc) in VMEM from one kv step
// to the next; CUDA blocks run in parallel and in no order. So the
// forward and dq kernels give ONE block to a (bh, q-tile) pair and loop
// over the kv tiles inside it; the dk/dv kernel gives one block to a
// (bh, kv-tile) pair and loops over the q tiles. Tiles are BT x BT (BT =
// 64 for head_dim <= 64, 32 up to 128, 16 up to 256) with 256 threads in a
// 16 x 16 grid; each thread owns an RM x RM (RM = BT/16) piece of every
// score tile and RM rows x NG float4 column groups of every [BT, D]
// accumulator. Operands are staged in shared memory as f32 — "k-major"
// (transposed, [D][BT]) where a product contracts over head_dim, natural
// ([BT][D]) where it contracts over the tile — so each inner step is two
// vector loads and RM x RM (or RM x 4) FMAs. Row max and row sum of a
// score tile reduce across the 16 lanes of a row by shuffles.
//
// Semantics kept from the TPU kernels: scale 1/sqrt(D) applied to q·k in
// f32; masked entries are dropped with a select (never a multiply by a
// mask: lse is -1e30 on a row of length 0, so exp(s - lse) would be inf
// there); p is rounded to the input type before the PV product (forward)
// and the p·g product (dv); ds is rounded before ds·k (dq) and ds·q (dk);
// f32 accumulation; a row with no valid key gives exact zeros through
// safe_l and lse = -1e30; causal blocks skip whole tiles above the
// diagonal and `lens` skips whole tiles past the valid prefix; seq_q and
// seq_k need not be multiples of the tile (ragged tails are loaded as
// zeros and masked).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;   // a 16 x 16 thread grid

// ---- global <-> f32 conversions, 8 (load) or 4 (store) elements -------

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(x[0], x[1]);
  h[1] = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// round an f32 value to the input type and back (the TPU kernels'
// `.astype(v.dtype)` before a product)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---- shared-memory vector loads of N = 1, 2, 4 floats ------------------

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

// ---- tile staging: rows [0, n) of a [rows, D] global tile -> f32 smem --
// Rows n..BT-1 are zero-filled (ragged tails).

// transposed: dst[d * ld + r]
template <int BT, typename T>
__device__ __forceinline__ void stage_t(float* dst, int ld, const T* src,
                                        int n, int D) {
  const int chunks = BT * (D >> 3);
  for (int idx = threadIdx.x; idx < chunks; idx += kThreads) {
    const int r = idx % BT, c = idx / BT;   // neighbours take neighbour rows
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n) load8(src + (int64_t)r * D + 8 * c, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(8 * c + i) * ld + r] = x[i];
  }
}

// natural: dst[r * ld + d]
template <int BT, typename T>
__device__ __forceinline__ void stage_n(float* dst, int ld, const T* src,
                                        int n, int D) {
  const int per_row = D >> 3;
  const int chunks = BT * per_row;
  for (int idx = threadIdx.x; idx < chunks; idx += kThreads) {
    const int r = idx / per_row, c = idx % per_row;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n) load8(src + (int64_t)r * D + 8 * c, x);
    store4(dst + r * ld + 8 * c, x);
    store4(dst + r * ld + 8 * c + 4, x + 4);
  }
}

// c[RM][RM] += sum_k a[k][ty*RM + i] * b[k][tx*RM + j]  (both k-major)
template <int RM>
__device__ __forceinline__ void tile_dot(float (&c)[RM][RM], const float* a,
                                         const float* b, int ld, int K,
                                         int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RM];
    lds<RM>(a + k * ld + ty * RM, av);
    lds<RM>(b + k * ld + tx * RM, bv);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) c[i][j] += av[i] * bv[j];
  }
}

// acc[RM][4*NG] += sum_j a[j][ty*RM + i] * b[j][4*g .. 4*g+3],
// g = tx + 16*m (m < NG): a is k-major [BT][lda], b natural [BT][ldb]
template <int RM, int NG>
__device__ __forceinline__ void acc_dot(float (&acc)[RM][4 * NG],
                                        const float* a, int lda,
                                        const float* b, int ldb, int K,
                                        int D, int ty, int tx) {
  for (int j = 0; j < K; ++j) {
    float av[RM];
    lds<RM>(a + j * lda + ty * RM, av);
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      const int col = 4 * (tx + 16 * m);
      if (col < D) {
        float bv[4];
        lds<4>(b + j * ldb + col, bv);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][4 * m + e] += av[i] * bv[e];
      }
    }
  }
}

// reductions across the 16 lanes (tx) that share a thread row (ty)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// write acc * mul (rows row0 + ty*RM + i < n) to a [rows, D] global tile
template <int RM, int NG, typename T>
__device__ __forceinline__ void store_acc(T* dst, const float (&acc)[RM][4 * NG],
                                          const float* mul, int n, int D,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    if (r >= n) continue;
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      const int col = 4 * (tx + 16 * m);
      if (col < D) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * m + e] * mul[i];
        store4(dst + (int64_t)r * D + col, x);
      }
    }
  }
}

// number of kv tiles of `tile` keys a q tile [q0, q0 + rows) visits
__device__ __forceinline__ int kv_tiles(int q0, int rows, int tile, int kl,
                                        int causal) {
  int end = kl;
  if (causal && q0 + rows < end) end = q0 + rows;
  return end > 0 ? (end + tile - 1) / tile : 0;
}

// ---- K3: forward ---------------------------------------------------------

template <typename T, int RM, int NG>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lens,
              T* __restrict__ out, float* __restrict__ lse, int S, int SK,
              int D, int causal, float scale) {
  constexpr int BT = 16 * RM;
  constexpr int LT = BT + 4;
  const int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][LT]
  float* Kt = Qt + D * LT;                        // [D][LT]
  float* Vn = Kt + D * LT;                        // [BT][LD]
  float* Pt = Vn + BT * LD;                       // [BT][LT]: Pt[j][i]

  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - blockIdx.y : blockIdx.y;  // heavy first
  const int q0 = qt * BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kl = lens ? min(lens[bh], SK) : SK;
  const T* qb = q + ((int64_t)bh * S + q0) * D;
  const T* kb = k + (int64_t)bh * SK * D;
  const T* vb = v + (int64_t)bh * SK * D;

  stage_t<BT>(Qt, LT, qb, min(BT, S - q0), D);

  float m[RM], l[RM], acc[RM][4 * NG];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NG; ++e) acc[i][e] = 0.f;
  }

  const int n_kv = kv_tiles(q0, BT, BT, kl, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BT;
    __syncthreads();   // the last tile's readers are done with Kt/Vn/Pt
    // rows past the valid prefix stage as zeros (kl <= SK), as the TPU
    // kernel zeroes them: no 0 * inf can reach the accumulator
    const int nk = min(BT, kl - k0);
    stage_t<BT>(Kt, LT, kb + (int64_t)k0 * D, nk, D);
    stage_n<BT>(Vn, LD, vb + (int64_t)k0 * D, nk, D);
    __syncthreads();

    float s[RM][RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) s[i][j] = 0.f;
    tile_dot<RM>(s, Qt, Kt, LT, D, ty, tx);

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
      bool ok[RM];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int col = k0 + tx * RM + j;
        ok[j] = col < kl && (!causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        Pt[(tx * RM + j) * LT + ty * RM + i] = round_to(p, q);
      }
      l[i] = alpha * l[i] + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * NG; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();
    acc_dot<RM, NG>(acc, Pt, LT, Vn, LD, BT, D, ty, tx);
  }

  float inv[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float safe_l = l[i] == 0.f ? 1.f : l[i];   // no valid key: zeros
    inv[i] = 1.f / safe_l;
    const int row = q0 + ty * RM + i;
    if (tx == 0 && row < S) lse[(int64_t)bh * S + row] = m[i] + logf(safe_l);
  }
  store_acc<RM, NG>(out + ((int64_t)bh * S + q0) * D, acc, inv,
                    min(BT, S - q0), D, ty, tx);
}

// ---- K4: dq --------------------------------------------------------------

template <typename T, int RM, int NG>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ lens, T* __restrict__ dq, int S,
                 int SK, int D, int causal, float scale) {
  constexpr int BT = 16 * RM;
  constexpr int LT = BT + 4;
  const int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][LT]
  float* Gt = Qt + D * LT;                        // [D][LT]
  float* Kt = Gt + D * LT;                        // [D][LT]
  float* Vt = Kt + D * LT;                        // [D][LT]
  float* Kn = Vt + D * LT;                        // [BT][LD]
  float* dSt = Kn + BT * LD;                      // [BT][LT]: dSt[j][i]

  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kl = lens ? min(lens[bh], SK) : SK;
  const int nq = min(BT, S - q0);
  const int64_t qoff = ((int64_t)bh * S + q0) * D;
  const T* kb = k + (int64_t)bh * SK * D;
  const T* vb = v + (int64_t)bh * SK * D;

  stage_t<BT>(Qt, LT, q + qoff, nq, D);
  stage_t<BT>(Gt, LT, g + qoff, nq, D);
  float lse_r[RM], delta_r[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    lse_r[i] = r < nq ? lse[(int64_t)bh * S + q0 + r] : 0.f;
    delta_r[i] = r < nq ? delta[(int64_t)bh * S + q0 + r] : 0.f;
  }

  float acc[RM][4 * NG];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NG; ++e) acc[i][e] = 0.f;

  const int n_kv = kv_tiles(q0, BT, BT, kl, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BT;
    const int nk = min(BT, kl - k0);   // rows past the prefix: zeros
    __syncthreads();
    stage_t<BT>(Kt, LT, kb + (int64_t)k0 * D, nk, D);
    stage_t<BT>(Vt, LT, vb + (int64_t)k0 * D, nk, D);
    stage_n<BT>(Kn, LD, kb + (int64_t)k0 * D, nk, D);
    __syncthreads();

    float s[RM][RM], dp[RM][RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<RM>(s, Qt, Kt, LT, D, ty, tx);
    tile_dot<RM>(dp, Gt, Vt, LT, D, ty, tx);

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int col = k0 + tx * RM + j;
        const bool ok = row < S && col < kl && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        const float ds = ok ? p * (dp[i][j] - delta_r[i]) : 0.f;
        dSt[(tx * RM + j) * LT + ty * RM + i] = round_to(ds, q);
      }
    }
    __syncthreads();
    acc_dot<RM, NG>(acc, dSt, LT, Kn, LD, BT, D, ty, tx);
  }
  float mul[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) mul[i] = scale;
  store_acc<RM, NG>(dq + qoff, acc, mul, nq, D, ty, tx);
}

// ---- K5: dk, dv ----------------------------------------------------------

template <typename T, int RM, int NG>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ lens, T* __restrict__ dk,
                  T* __restrict__ dv, int S, int SK, int D, int causal,
                  float scale) {
  constexpr int BT = 16 * RM;
  constexpr int LT = BT + 4;
  const int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);   // [D][LT]
  float* Vt = Kt + D * LT;                        // [D][LT]
  float* Qt = Vt + D * LT;                        // [D][LT]
  float* Gt = Qt + D * LT;                        // [D][LT]
  float* Qn = Gt + D * LT;                        // [BT][LD]
  float* Gn = Qn + BT * LD;                       // [BT][LD]
  float* Pb = Gn + BT * LD;                       // [BT][LT]: P[i][j], dS[i][j]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kl = lens ? min(lens[bh], SK) : SK;
  const int nk = min(BT, SK - k0);
  const int64_t koff = ((int64_t)bh * SK + k0) * D;
  const T* qb = q + (int64_t)bh * S * D;
  const T* gb = g + (int64_t)bh * S * D;

  float dk_acc[RM][4 * NG], dv_acc[RM][4 * NG];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NG; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // a kv tile wholly past the valid prefix gets zero dk / dv
  if (k0 < kl) {
    stage_t<BT>(Kt, LT, k + koff, nk, D);
    stage_t<BT>(Vt, LT, v + koff, nk, D);
    // causal: q rows >= k0 only, and tiles are aligned (BT for both)
    const int qt0 = causal ? k0 / BT : 0;
    const int n_qt = (S + BT - 1) / BT;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BT;
      const int nq = min(BT, S - q0);
      __syncthreads();
      stage_t<BT>(Qt, LT, qb + (int64_t)q0 * D, nq, D);
      stage_t<BT>(Gt, LT, gb + (int64_t)q0 * D, nq, D);
      stage_n<BT>(Qn, LD, qb + (int64_t)q0 * D, nq, D);
      stage_n<BT>(Gn, LD, gb + (int64_t)q0 * D, nq, D);
      __syncthreads();

      // transposed score tiles: rows = kv (ty), cols = q (tx)
      float s[RM][RM], dp[RM][RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_dot<RM>(s, Kt, Qt, LT, D, ty, tx);
      tile_dot<RM>(dp, Vt, Gt, LT, D, ty, tx);

      float ds[RM][RM];
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int qrow = q0 + tx * RM + j;
        const bool qok = qrow < S;
        const float lse_q = qok ? lse[(int64_t)bh * S + qrow] : 0.f;
        const float delta_q = qok ? delta[(int64_t)bh * S + qrow] : 0.f;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int krow = k0 + ty * RM + i;
          const bool ok = qok && krow < kl && (!causal || krow <= qrow);
          const float p = ok ? expf(s[i][j] * scale - lse_q) : 0.f;
          ds[i][j] = ok ? p * (dp[i][j] - delta_q) : 0.f;
          Pb[(tx * RM + j) * LT + ty * RM + i] = round_to(p, q);
        }
      }
      __syncthreads();
      acc_dot<RM, NG>(dv_acc, Pb, LT, Gn, LD, BT, D, ty, tx);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j)
          Pb[(tx * RM + j) * LT + ty * RM + i] = round_to(ds[i][j], q);
      __syncthreads();
      acc_dot<RM, NG>(dk_acc, Pb, LT, Qn, LD, BT, D, ty, tx);
    }
  }
  float one[RM], mul[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    one[i] = 1.f;
    mul[i] = scale;
  }
  store_acc<RM, NG>(dk + koff, dk_acc, mul, nk, D, ty, tx);
  store_acc<RM, NG>(dv + koff, dv_acc, one, nk, D, ty, tx);
}

// ---- launch ----------------------------------------------------------------

template <int RM>
size_t smem_bytes(int n_kmajor, int n_natural, int D) {
  constexpr int BT = 16 * RM;
  return sizeof(float) * ((size_t)n_kmajor * D * (BT + 4) +
                          (size_t)n_natural * BT * (D + 4) +
                          (size_t)BT * (BT + 4));
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse_in, *delta;
  const int* lens;
  void *o0, *o1;
  float* lse_out;
  int BH, S, SK, D, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int RM, int NG>
cudaError_t launch_fwd(const Args& a) {
  const size_t smem = smem_bytes<RM>(2, 1, a.D);
  auto kernel = fa_fwd_kernel<T, RM, NG>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH, (a.S + 16 * RM - 1) / (16 * RM));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lens, static_cast<T*>(a.o0), a.lse_out,
      a.S, a.SK, a.D, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int RM, int NG>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = smem_bytes<RM>(4, 1, a.D);
  auto kernel = fa_bwd_dq_kernel<T, RM, NG>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH, (a.S + 16 * RM - 1) / (16 * RM));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse_in,
      a.delta, a.lens, static_cast<T*>(a.o0), a.S, a.SK, a.D, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int RM, int NG>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = smem_bytes<RM>(4, 2, a.D);
  auto kernel = fa_bwd_dkv_kernel<T, RM, NG>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH, (a.SK + 16 * RM - 1) / (16 * RM));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse_in,
      a.delta, a.lens, static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.S,
      a.SK, a.D, a.causal, a.scale);
  return cudaGetLastError();
}

// head_dim -> (RM, NG): D <= 64 → 64-row tiles, <= 128 → 32, <= 256 → 16
#define PT_FA_DISPATCH(NAME, FN)                                   \
  cudaError_t NAME(const Args& a, int bf16) {                       \
    if (a.D <= 64)                                                  \
      return bf16 ? FN<__nv_bfloat16, 4, 1>(a) : FN<float, 4, 1>(a); \
    if (a.D <= 128)                                                 \
      return bf16 ? FN<__nv_bfloat16, 2, 2>(a) : FN<float, 2, 2>(a); \
    return bf16 ? FN<__nv_bfloat16, 1, 4>(a) : FN<float, 1, 4>(a);   \
  }
PT_FA_DISPATCH(dispatch_fwd, launch_fwd)
PT_FA_DISPATCH(dispatch_dq, launch_dq)
PT_FA_DISPATCH(dispatch_dkv, launch_dkv)
#undef PT_FA_DISPATCH

bool bad_shape(int BH, int S, int SK, int D) {
  return BH <= 0 || S <= 0 || SK <= 0 || D <= 0 || D % 8 != 0 || D > 256;
}

// ==== tensor-core route: bf16, head_dim 64 / 128 (K3, K4, K5) =============
//
// What bounds them, and what the design does about it. The products run
// as mma.sync.m16n8k16 (bf16 x bf16 -> f32) on the tensor cores, so the
// CUDA cores' FMA ceiling is gone; what is left is feeding them:
// * operands are staged in shared memory as bf16, each tile once, by
//   cp.async into a ring of 2-3 stages: the next tiles are in flight while
//   tile t computes, and one barrier per tile suffices (the copy into a
//   stage is issued after the barrier that ends its last reader); rows
//   past the valid prefix or the ragged end are zero-filled by the copy
//   itself (source size 0);
// * rows are padded by 8 elements (16 bytes), so the 8 row addresses of
//   an ldmatrix phase fall in 8 different bank groups;
// * ldmatrix gives the fragments and ldmatrix.trans the transposed view of
//   the same tile (V in P·V; dO and Q in the dv / dk products), so no tile
//   is staged twice;
// * scores stay in registers: the f32 accumulator layout of two adjacent
//   n8 blocks is the A-operand layout of one k16 step, so P and dS are
//   rounded to bf16 in registers and fed straight back to the tensor
//   cores; they never touch shared memory;
// * the online softmax runs in registers: a row lives in the 4 lanes of a
//   quad, whose max reduces by two shuffles (the row sum stays per lane
//   until the end); exp is exp2 with log2(e) folded in; masking (by
//   select) only on the tiles that cross the diagonal, the valid prefix or
//   the ragged end.
// Blocks have 4 warps. At the training shape K3 and K5 reach under a
// fifth of their bound (PERF.md); the 230-250 registers a lane they take
// allow 2 blocks (8 warps) per SM, which likely leaves the ldmatrix ->
// mma -> softmax chains exposed (a hypothesis: no profiler of the SM's
// stalls runs on the card's machine). Not done yet: wgmma (the only way to the full 989
// TFLOP/s, and its accumulators need no ldmatrix for B), TMA + mbarrier
// staging, warp specialisation, and in K5 more keys per warp (each warp
// reads the whole Q / dO tile from shared memory for its 16 keys).
namespace tc {

using namespace pt_mma;
constexpr int kTcThreads = 128;            // 4 warps
constexpr int BK = 64;                     // keys per tile

// K3's m16 row tiles per warp: 2 at head_dim 64 (a warp owns 32 q rows, a
// block 128), so each K / V fragment read from shared memory feeds two
// products; 1 at 128, where one tile's accumulators and Q fragments
// already take over 200 registers a lane
template <int D>
constexpr int kFwdMT = D <= 64 ? 2 : 1;
// K3's K / V ring: 3 stages (tiles t+1 and t+2 in flight while t
// computes) at head_dim 64; 2 at 128, where 3 would leave room for one
// block per SM
template <int D>
constexpr int kFwdStages = D <= 64 ? 3 : 2;
// K5's Q / dO / lse / delta ring
constexpr int kDkvStages = 3;

// K5's q rows per tile: 64 at head_dim 64; 32 at 128, which keeps S, dP
// and the dk / dv accumulators (2 x 64 f32 per lane) in registers
template <int D>
constexpr int kDkvBQ = D <= 64 ? 64 : 32;

// K4's q rows per block (4 warps x 16) and its K / V ring; its kv tile:
// 64 keys at head_dim 64, 32 at 128, where S and dP (2 x BK/8 x 4 f32 a
// lane) sit beside a 16x128 f32 dq accumulator and the Q / dO fragments
constexpr int kDqBQ = 64;
constexpr int kDqStages = 3;
template <int D>
constexpr int kDqBK = D <= 64 ? 64 : 32;

// rows [0, n) of a [rows, D] global bf16 tile -> shared [R][D + 8] by
// cp.async (not committed) from a block of NT threads; rows n..R-1 are
// zero-filled
template <int R, int D, int NT>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int n) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  static_assert(R * CPR % NT == 0, "tile chunks per thread");
#pragma unroll
  for (int it = 0; it < R * CPR / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < n;
    cp_async16(smem_addr(dst + r * (D + 8) + 8 * c),
               src + (ok ? (int64_t)r * D + 8 * c : 0), ok ? 16 : 0);
  }
}

// ---- K3 on the tensor cores ------------------------------------------------
// One block per (bh, q tile of 64·MT rows), heavy causal tiles first. Warp
// w owns MT m16 tiles (16·MT q rows from 16·MT·w), their Q fragments in
// registers for the whole loop, so each K / V fragment it reads feeds MT
// products; it skips the kv tiles wholly above its rows. Scores stay in
// q·k units: scale·log2(e) is folded into the one FMA before exp2, and
// scale into lse at the end.

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fa_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ lens,
                 bf16* __restrict__ out, float* __restrict__ lse, int S,
                 int SK, int causal, float scale) {
  constexpr int MT = kFwdMT<D>, WR = 16 * MT, BQ = 4 * WR, LD = D + 8;
  constexpr int NT = kTcThreads, ST = kFwdStages<D>;
  constexpr int KS = D / 16;   // k16 steps over head_dim
  constexpr int NS = BK / 8;   // n8 blocks of a score tile
  constexpr int NO = D / 8;    // n8 blocks of the output
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);   // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                      // [ST][BK][LD]
  bf16* Vs = Ks + ST * BK * LD;                 // [ST][BK][LD]

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = q0 + warp * WR;   // the warp's first row
  const int r_lane = lane >> 2;    // this lane's rows: w0 + 16·mt + r_lane (+ 8)
  const int c_lane = 2 * (lane & 3);   // its first column in an n8 block
  const int kl = lens ? min(lens[bh], SK) : SK;
  const bf16* kb = k + (int64_t)bh * SK * D;
  const bf16* vb = v + (int64_t)bh * SK * D;
  const float sl2 = scale * kLog2e;

  const int n_kv = kv_tiles(q0, BQ, BK, kl, causal);
  // kv tile t into ring stage t % ST; rows past the valid prefix: zeros
  auto stage_kv = [&](int t) {
    if (t >= n_kv) return;
    const int k0 = t * BK, st = t % ST;
    stage_tile<BK, D, NT>(Ks + st * BK * LD, kb + (int64_t)k0 * D, kl - k0);
    stage_tile<BK, D, NT>(Vs + st * BK * LD, vb + (int64_t)k0 * D, kl - k0);
  };
  // one commit group per tile: the first also holds Q
  stage_tile<BQ, D, NT>(Qs, q + ((int64_t)bh * S + q0) * D, S - q0);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    stage_kv(t);
    cp_commit();
  }

  uint32_t qa[MT][KS][4];
  float o[MT][NO][4];
  float m[MT][2], l[MT][2];   // row max (q·k units); this lane's part of the row sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    cp_wait<ST - 2>();   // Q and tile t have landed ...
    __syncthreads();     // ... for every thread, and tile t - 1 is done with
    stage_kv(t + ST - 1);   // into the stage tile t - 1 used
    cp_commit();
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          frag_a<LD>(qa[mt][kk], Qs, warp * WR + 16 * mt, 16 * kk, lane);
    }
    const bf16* Kt = Ks + (t % ST) * BK * LD;
    const bf16* Vt = Vs + (t % ST) * BK * LD;
    if (causal && k0 > w0 + WR - 1) continue;   // every key above its rows

    float s[MT][NS][4];   // S = Q · Kᵀ
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4];
        frag_b<LD>(b, Kt, 8 * j, 16 * kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][j], qa[mt][kk], b[0], b[1]);
          mma_bf16(s[mt][j + 1], qa[mt][kk], b[2], b[3]);
        }
      }

    // the mask by select, on tiles that cross the prefix or the diagonal;
    // then the online softmax
    const bool edge = k0 + BK > kl || (causal && k0 + BK - 1 > w0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row0 = w0 + 16 * mt + r_lane;
      auto allowed = [&](int j, int e) {
        const int col = k0 + 8 * j + c_lane + (e & 1);
        return col < kl && (!causal || col <= row0 + 8 * (e >> 1));
      };
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge && !allowed(j, e)) s[mt][j][e] = kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
        }
      float mb[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        alpha[i] = fast_exp2((m[mt][i] - mx[i]) * sl2);
        m[mt][i] = mx[i];
        mb[i] = mx[i] * sl2;
        l[mt][i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(s[mt][j][e], sl2, -mb[e >> 1]));
          if (edge && !allowed(j, e)) p = 0.f;
          s[mt][j][e] = p;
          l[mt][e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] *= alpha[e >> 1];
    }

    // O += P · V: P rounded to bf16 in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        acc_to_a(a[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        frag_bt<LD>(b, Vt, 16 * kk, 8 * n, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][n], a[mt], b[0], b[1]);
          mma_bf16(o[mt][n + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[mt][i];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const int row = w0 + 16 * mt + r_lane + 8 * i;
      if (row >= S) continue;
      // no valid key: zeros and lse = -1e30 (the reference's safe_l)
      const float inv = sum == 0.f ? 1.f : 1.f / sum;
      if ((lane & 3) == 0)
        lse[(int64_t)bh * S + row] =
            sum == 0.f ? kNegInf : m[mt][i] * scale + logf(sum);
      bf16* dst = out + ((int64_t)bh * S + row) * D + c_lane;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(o[mt][n][2 * i] * inv, o[mt][n][2 * i + 1] * inv);
    }
}

// ---- K5 on the tensor cores ------------------------------------------------
// One block per (bh, 64-key kv tile); K and V staged once; the loop walks
// the q tiles (from the diagonal under causal) with Q, dO, lse and delta
// in a 3-stage ring. Warp w owns keys 16w..16w+15: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
// (keys x q) in registers, then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ, dSᵀ
// as bf16 A operands and dO, Q through ldmatrix.trans.

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fa_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lens, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int SK, int causal,
                     float scale) {
  constexpr int BQ = kDkvBQ<D>, NT = kTcThreads, ST = kDkvStages;
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;   // k16 steps over head_dim
  constexpr int NS = BQ / 8;   // n8 blocks of a (transposed) score tile
  constexpr int NO = D / 8;    // n8 blocks of dk / dv
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);   // [BK][LD]
  bf16* Vs = Ks + BK * LD;                      // [BK][LD]
  bf16* Qs = Vs + BK * LD;                      // [ST][BQ][LD]
  bf16* Gs = Qs + ST * BQ * LD;                 // [ST][BQ][LD]
  float* Ls = reinterpret_cast<float*>(Gs + ST * BQ * LD);  // [ST][BQ] lse
  float* Es = Ls + ST * BQ;                                  // [ST][BQ] delta

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int krow0 = k0 + warp * 16 + (lane >> 2);   // this lane's keys: krow0, krow0 + 8
  const int c_lane = 2 * (lane & 3);
  const int kl = lens ? min(lens[bh], SK) : SK;
  const int64_t koff = ((int64_t)bh * SK + k0) * D;
  const bf16* qb = q + (int64_t)bh * S * D;
  const bf16* gb = g + (int64_t)bh * S * D;
  const float* lb = lse + (int64_t)bh * S;
  const float* eb = delta + (int64_t)bh * S;
  const float sl2 = scale * kLog2e;

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // q tile qt (rows past S zero-filled) into ring stage `buf`
  auto stage_q = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    stage_tile<BQ, D, NT>(Qs + buf * BQ * LD, qb + (int64_t)q0 * D, S - q0);
    stage_tile<BQ, D, NT>(Gs + buf * BQ * LD, gb + (int64_t)q0 * D, S - q0);
    for (int i = threadIdx.x; i < 2 * BQ; i += NT) {
      const int r = i % BQ;
      const bool ok = q0 + r < S;
      cp_async4(smem_addr((i < BQ ? Ls : Es) + buf * BQ + r),
                (i < BQ ? lb : eb) + (ok ? q0 + r : 0), ok ? 4 : 0);
    }
  };

  if (k0 < kl) {   // a kv tile wholly past the valid prefix keeps zero dk / dv
    stage_tile<BK, D, NT>(Ks, k + koff, kl - k0);   // rows past the prefix: zeros
    stage_tile<BK, D, NT>(Vs, v + koff, kl - k0);
    // causal: q rows >= k0 only (k0 is a multiple of BQ)
    const int qt0 = causal ? k0 / BQ : 0;
    const int n_qt = (S + BQ - 1) / BQ;
    // one commit group per q tile: the first also holds K and V
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (qt0 + i < n_qt) stage_q(qt0 + i, i);
      cp_commit();
    }
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int i = qt - qt0, buf = i % ST;
      cp_wait<ST - 2>();   // K, V and q tile qt have landed ...
      __syncthreads();     // ... for every thread, and tile qt - 1 is done with
      if (qt + ST - 1 < n_qt) stage_q(qt + ST - 1, (i + ST - 1) % ST);
      cp_commit();
      const bf16* Qt = Qs + buf * BQ * LD;
      const bf16* Gt = Gs + buf * BQ * LD;
      const float* Lt = Ls + buf * BQ;
      const float* Et = Es + buf * BQ;

      float s[NS][4], dp[NS][4];   // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        frag_a<LD>(ka, Ks, warp * 16, 16 * kk, lane);
        frag_a<LD>(va, Vs, warp * 16, 16 * kk, lane);
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t b[4];
          frag_b<LD>(b, Qt, 8 * j, 16 * kk, lane);
          mma_bf16(s[j], ka, b[0], b[1]);
          mma_bf16(s[j + 1], ka, b[2], b[3]);
          frag_b<LD>(b, Gt, 8 * j, 16 * kk, lane);
          mma_bf16(dp[j], va, b[0], b[1]);
          mma_bf16(dp[j + 1], va, b[2], b[3]);
        }
      }

      // Pᵀ = exp(Sᵀ·scale − lse) (as exp2, log2(e) folded in) and dSᵀ =
      // Pᵀ∘(dPᵀ − delta); the mask by select on tiles that cross the
      // diagonal, the prefix or the end
      const int q0 = qt * BQ;
      const bool edge = q0 + BQ > S || k0 + BK > kl ||
                        (causal && k0 + warp * 16 + 15 > q0);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = 8 * j + c_lane;
        const float2 lq = *reinterpret_cast<const float2*>(Lt + c);
        const float2 eq = *reinterpret_cast<const float2*>(Et + c);
        const float lb2[2] = {lq.x * kLog2e, lq.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float del_e = (e & 1) ? eq.y : eq.x;
          float p = fast_exp2(fmaf(s[j][e], sl2, -lb2[e & 1]));
          float ds = p * (dp[j][e] - del_e);
          if (edge) {
            const int qr = q0 + c + (e & 1), kr = krow0 + 8 * (e >> 1);
            const bool ok = qr < S && kr < kl && (!causal || kr <= qr);
            p = ok ? p : 0.f;
            ds = ok ? ds : 0.f;
          }
          s[j][e] = p;
          dp[j][e] = ds;
        }
      }

      // dV += Pᵀ·dO, dK += dSᵀ·Q: Pᵀ and dSᵀ rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          frag_bt<LD>(b, Gt, 16 * kk, 8 * n, lane);
          mma_bf16(dva[n], pa, b[0], b[1]);
          mma_bf16(dva[n + 1], pa, b[2], b[3]);
          frag_bt<LD>(b, Qt, 16 * kk, 8 * n, lane);
          mma_bf16(dka[n], da, b[0], b[1]);
          mma_bf16(dka[n + 1], da, b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = krow0 + 8 * i;
    if (kr >= SK) continue;
    bf16* pk = dk + ((int64_t)bh * SK + kr) * D + c_lane;
    bf16* pv = dv + ((int64_t)bh * SK + kr) * D + c_lane;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(pk + 8 * n) =
          pack_bf16(dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(pv + 8 * n) =
          pack_bf16(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// ---- K4 on the tensor cores ------------------------------------------------
// One block per (bh, q tile of 64 rows), heavy causal tiles first. Warp w
// owns q rows 16w..16w+15: their Q and dO fragments, lse (in log2 units)
// and delta stay in registers for the whole loop over the kv tiles, which
// come through a 3-stage cp.async ring of K and V. Per tile: S = Q·Kᵀ and
// dP = dO·Vᵀ on the tensor cores, then in registers P = exp2(S·scale·log2e
// − lse·log2e) and dS = P∘(dP − delta), the mask by select on the tiles
// that cross the diagonal or the valid prefix, and dq += dS·K with dS
// rounded to bf16 as the A operand and K through ldmatrix.trans; dq is
// scaled once at the end. A warp skips the tiles wholly above its rows.

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fa_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ lens, bf16* __restrict__ dq,
                    int S, int SK, int causal, float scale) {
  constexpr int BQ = kDqBQ, BKQ = kDqBK<D>, NT = kTcThreads, ST = kDqStages;
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;    // k16 steps over head_dim
  constexpr int NS = BKQ / 8;   // n8 blocks of a score tile
  constexpr int NO = D / 8;     // n8 blocks of dq
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);   // [BQ][LD]
  bf16* Gs = Qs + BQ * LD;                      // [BQ][LD]
  bf16* Ks = Gs + BQ * LD;                      // [ST][BKQ][LD]
  bf16* Vs = Ks + ST * BKQ * LD;                // [ST][BKQ][LD]

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = q0 + warp * 16;       // the warp's first row
  const int r_lane = lane >> 2;        // this lane's rows: w0 + r_lane (+ 8)
  const int c_lane = 2 * (lane & 3);   // its first column in an n8 block
  const int kl = lens ? min(lens[bh], SK) : SK;
  const int64_t qoff = ((int64_t)bh * S + q0) * D;
  const bf16* kb = k + (int64_t)bh * SK * D;
  const bf16* vb = v + (int64_t)bh * SK * D;
  const float sl2 = scale * kLog2e;

  // a row with no valid key (kl == 0) visits no tile: exact zeros
  const int n_kv = kv_tiles(q0, BQ, BKQ, kl, causal);
  // kv tile t into ring stage t % ST; rows past the valid prefix: zeros
  auto stage_kv = [&](int t) {
    if (t >= n_kv) return;
    const int k0 = t * BKQ, st = t % ST;
    stage_tile<BKQ, D, NT>(Ks + st * BKQ * LD, kb + (int64_t)k0 * D, kl - k0);
    stage_tile<BKQ, D, NT>(Vs + st * BKQ * LD, vb + (int64_t)k0 * D, kl - k0);
  };
  // one commit group per tile: the first also holds Q and dO
  stage_tile<BQ, D, NT>(Qs, q + qoff, S - q0);
  stage_tile<BQ, D, NT>(Gs, g + qoff, S - q0);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    stage_kv(t);
    cp_commit();
  }

  // rows past S: lse 0 and delta 0 on zero Q / dO rows give dS = 0, and
  // they are not stored
  float lb2[2], del[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + r_lane + 8 * i;
    const bool ok = row < S;
    lb2[i] = ok ? lse[(int64_t)bh * S + row] * kLog2e : 0.f;
    del[i] = ok ? delta[(int64_t)bh * S + row] : 0.f;
  }

  uint32_t qa[KS][4], ga[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BKQ;
    cp_wait<ST - 2>();   // Q, dO and tile t have landed ...
    __syncthreads();     // ... for every thread, and tile t - 1 is done with
    stage_kv(t + ST - 1);   // into the stage tile t - 1 used
    cp_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        frag_a<LD>(qa[kk], Qs, warp * 16, 16 * kk, lane);
        frag_a<LD>(ga[kk], Gs, warp * 16, 16 * kk, lane);
      }
    }
    const bf16* Kt = Ks + (t % ST) * BKQ * LD;
    const bf16* Vt = Vs + (t % ST) * BKQ * LD;
    if (causal && k0 > w0 + 15) continue;   // every key above its rows

    float s[NS][4], dp[NS][4];   // S = Q·Kᵀ, dP = dO·Vᵀ
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4];
        frag_b<LD>(b, Kt, 8 * j, 16 * kk, lane);
        mma_bf16(s[j], qa[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qa[kk], b[2], b[3]);
        frag_b<LD>(b, Vt, 8 * j, 16 * kk, lane);
        mma_bf16(dp[j], ga[kk], b[0], b[1]);
        mma_bf16(dp[j + 1], ga[kk], b[2], b[3]);
      }

    // dS = P∘(dP − delta), P = exp(S·scale − lse) as exp2; the mask by
    // select on tiles that cross the prefix or the diagonal
    const bool edge = k0 + BKQ > kl || (causal && k0 + BKQ - 1 > w0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = fast_exp2(fmaf(s[j][e], sl2, -lb2[i]));
        float ds = p * (dp[j][e] - del[i]);
        if (edge) {
          const int col = k0 + 8 * j + c_lane + (e & 1);
          const int row = w0 + r_lane + 8 * i;
          ds = col < kl && (!causal || col <= row) ? ds : 0.f;
        }
        dp[j][e] = ds;
      }

    // dq += dS · K: dS rounded to bf16 in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < BKQ / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        frag_bt<LD>(b, Kt, 16 * kk, 8 * n, lane);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + r_lane + 8 * i;
    if (row >= S) continue;
    bf16* dst = dq + ((int64_t)bh * S + row) * D + c_lane;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <int D>
size_t dq_smem() {
  return sizeof(bf16) * (size_t)(2 * kDqBQ + 2 * kDqStages * kDqBK<D>) *
         (D + 8);
}

template <int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = dq_smem<D>();
  auto kernel = fa_bwd_dq_tc_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH, (a.S + kDqBQ - 1) / kDqBQ);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g), a.lse_in,
      a.delta, a.lens, static_cast<bf16*>(a.o0), a.S, a.SK, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <int D>
size_t fwd_smem() {
  return sizeof(bf16) * (size_t)(64 * kFwdMT<D> + 2 * kFwdStages<D> * BK) *
         (D + 8);
}

template <int D>
size_t dkv_smem() {
  constexpr int BQ = kDkvBQ<D>;
  return sizeof(bf16) * (size_t)(2 * BK + 2 * kDkvStages * BQ) * (D + 8) +
         sizeof(float) * 2 * kDkvStages * BQ;
}

template <int D>
cudaError_t launch_fwd(const Args& a) {
  const size_t smem = fwd_smem<D>();
  auto kernel = fa_fwd_tc_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = 64 * kFwdMT<D>;
  const dim3 grid(a.BH, (a.S + BQ - 1) / BQ);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.lens, static_cast<bf16*>(a.o0),
      a.lse_out, a.S, a.SK, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = dkv_smem<D>();
  auto kernel = fa_bwd_dkv_tc_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH, (a.SK + BK - 1) / BK);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
      a.lse_in, a.delta, a.lens, static_cast<bf16*>(a.o0),
      static_cast<bf16*>(a.o1), a.S, a.SK, a.causal, a.scale);
  return cudaGetLastError();
}

}  // namespace tc

// the tensor-core route takes bf16 with head_dim 64 or 128 only
bool tc_refuses(int BH, int S, int SK, int D, int bf16) {
  return bad_shape(BH, S, SK, D) || !bf16 || (D != 64 && D != 128);
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers
// to contiguous tensors: q/g/out/dq [BH, S, D], k/v/dk/dv [BH, SK, D] in
// one float type (bf16 = 1 → bfloat16, else float32); lse/delta [BH, S]
// float32; lens [BH] int32 or NULL (every row sees all SK keys). Launch
// on `stream`, do not synchronise, return the cudaError_t (0 = success).
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            const void* lens, void* out, void* lse, int BH,
                            int S, int SK, int D, int causal, float scale,
                            int bf16, void* stream) {
  if (bad_shape(BH, S, SK, D)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, nullptr, nullptr, nullptr, static_cast<const int*>(lens),
         out, nullptr, static_cast<float*>(lse), BH, S, SK, D, causal,
         scale, static_cast<cudaStream_t>(stream)};
  return (int)dispatch_fwd(a, bf16);
}

extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* g, const void* lse,
                               const void* delta, const void* lens,
                               void* dq, int BH, int S, int SK, int D,
                               int causal, float scale, int bf16,
                               void* stream) {
  if (bad_shape(BH, S, SK, D)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, g, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(lens),
         dq, nullptr, nullptr, BH, S, SK, D, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return (int)dispatch_dq(a, bf16);
}

extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* g, const void* lse,
                                const void* delta, const void* lens,
                                void* dk, void* dv, int BH, int S, int SK,
                                int D, int causal, float scale, int bf16,
                                void* stream) {
  if (bad_shape(BH, S, SK, D)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, g, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(lens),
         dk, dv, nullptr, BH, S, SK, D, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return (int)dispatch_dkv(a, bf16);
}

// The tensor-core route (K3, K4, K5): the same arguments as pt_flash_fwd
// / pt_flash_bwd_dq / pt_flash_bwd_dkv; bf16 must be 1 and D 64 or 128,
// else cudaErrorInvalidValue and nothing is launched.
extern "C" int pt_flash_fwd_tc(const void* q, const void* k, const void* v,
                               const void* lens, void* out, void* lse, int BH,
                               int S, int SK, int D, int causal, float scale,
                               int bf16, void* stream) {
  if (tc_refuses(BH, S, SK, D, bf16)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, nullptr, nullptr, nullptr, static_cast<const int*>(lens),
         out, nullptr, static_cast<float*>(lse), BH, S, SK, D, causal,
         scale, static_cast<cudaStream_t>(stream)};
  return (int)(D == 64 ? tc::launch_fwd<64>(a) : tc::launch_fwd<128>(a));
}

extern "C" int pt_flash_bwd_dq_tc(const void* q, const void* k,
                                  const void* v, const void* g,
                                  const void* lse, const void* delta,
                                  const void* lens, void* dq, int BH, int S,
                                  int SK, int D, int causal, float scale,
                                  int bf16, void* stream) {
  if (tc_refuses(BH, S, SK, D, bf16)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, g, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(lens),
         dq, nullptr, nullptr, BH, S, SK, D, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return (int)(D == 64 ? tc::launch_dq<64>(a) : tc::launch_dq<128>(a));
}

extern "C" int pt_flash_bwd_dkv_tc(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse, const void* delta,
                                   const void* lens, void* dk, void* dv,
                                   int BH, int S, int SK, int D, int causal,
                                   float scale, int bf16, void* stream) {
  if (tc_refuses(BH, S, SK, D, bf16)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, g, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(lens),
         dk, dv, nullptr, BH, S, SK, D, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return (int)(D == 64 ? tc::launch_dkv<64>(a) : tc::launch_dkv<128>(a));
}
