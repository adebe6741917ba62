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
// What bounds them. At the GPT training shapes (b·h 192, s 1024, d 64,
// bf16, causal) each kernel does ~26-52 GFLOP on ~100-150 MB, about 250-
// 340 flops per byte: right at the H100's bf16 ridge (~295 flops/byte), so
// the least time is set by the tensor cores' 989 TFLOP/s and HBM's
// 3.35 TB/s about equally. These kernels do their math in f32 on the CUDA
// cores (67 TFLOP/s peak), so they are compute-bound well above that
// bound: they are the simple, right first version. Tensor cores
// (mma/wgmma on bf16 tiles), TMA staging and warp specialisation are the
// later work (PERF.md).
//
// Design. The Pallas grid walks (bh, q-block, kv-block) in order and
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

// number of kv tiles a q tile [q0, q0 + BT) visits
__device__ __forceinline__ int kv_tiles(int q0, int BT, int kl, int causal) {
  int end = kl;
  if (causal && q0 + BT < end) end = q0 + BT;
  return end > 0 ? (end + BT - 1) / BT : 0;
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

  const int n_kv = kv_tiles(q0, BT, kl, causal);
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

  const int n_kv = kv_tiles(q0, BT, kl, causal);
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
