// Ragged paged attention for Hopper (sm_90a) — the serving kernels.
//
// K1, `rpa_kernel`, replaces the Pallas TPU kernel `_rpa_kernel`
// (paddle_tpu/ops/pallas_kernels/paged_attention.py:53, launched by
// `ragged_paged_attention`), for float pools and, with its dequant branch
// (:84-91, `_unpack_nibbles` :39), for int8 and packed-int4 pools. One
// query row per flat scheduled token attends to its own slot's KV prefix,
// read page by page through `page_tables[slot_ids[t]]`; decode tokens
// (one per sequence) and chunked-prefill tokens share one launch.
//
// K2, `rpa_qblock_kernel`, replaces `_rpa_qblock_kernel` (:131, launched
// by `_qblock_call` :332), the same function on the speculative verify
// layout: the T rows are slot-major blocks of qb = k+1 rows, one slot per
// block, and row i of a block masks at its own kv_len (draft j attends to
// drafts < j written in the same step, never to later ones).
//
// What bounds them: decode and verify attention are bandwidth-bound. A
// row reads kv_len rows of K and V and does 4 * kv_len * H * D flops on
// them, about one flop per byte in bf16 and four per byte in int8 — far
// below the ~295 flops/byte where the H100's tensor cores become the
// limit. The least time is the K/V code bytes plus the scale bytes over
// 3.35 TB/s. Quantized pools move 2x (int8) or 4x (int4) fewer code bytes
// than bf16, plus 4 bytes of scale per (row, head).
//
// K1 design. The Pallas grid walks (token, page) in order and carries the
// online-softmax state in VMEM scratch across grid steps; CUDA blocks run
// in parallel and in no order, so here ONE block owns one token and loops
// over that token's pages inside the block. Warps take heads (warp w
// serves heads w, w + nwarps, ...). Inside a warp, a group of G lanes owns
// one key row: each lane loads 8 contiguous head_dim elements (16 bytes
// in bf16, 8 bytes of int8 codes, 8 nibbles of int4), dequantizes them by
// the row's scale (gathered through the same page id), the group reduces
// the q·k dot by shuffles, and the warp folds the 32/G scores of a pass
// into the running max / sum / accumulator. In the split-halves int4
// layout element d < D/2 is the low nibble of byte d and element d >= D/2
// the high nibble of byte d - D/2, so a lane reads 8 consecutive bytes
// and takes one nibble of each. The page loop is bounded by
// ceil(kv_len_eff / P): page-table entries past it may hold stale ids and
// are never read.
//
// K2 design. One block per (slot block, head), one warp per row of the
// block (qb <= 16 warps). The block stages each page of its slot into
// shared memory ONCE — K and V dequantized to f32, [P, D] each, rows at
// or past the block's longest row zeroed — and every warp scores its own
// row against the staged page with K1's pass structure, so a page is read
// from device memory once per block instead of once per row (K1 would
// read it qb times). The page loop runs to ceil(max_i kv_eff_i / P), the
// block's longest row; a row that a page lies wholly past gets p = 0 on
// every key of it (the per-key `valid` gate), never exp(s - m) = 1 from
// an all-masked page.
//
// Simple first: no cp.async/TMA staging and no tensor cores yet (later
// work, see PERF.md).
//
// Semantics kept from the TPU kernels: scale 1/sqrt(D); f32 scores and
// f32 running m / l / acc; -1e30 on masked columns; V rows past kv_len
// never enter the accumulator (no 0 * NaN can form); p is rounded to the
// pool dtype before the PV product for bf16 pools and stays f32 for f32
// and quantized pools (their dequantized V is f32); l == 0 (kv_len 0)
// gives an exact zero row; kv_eff = base > 0 ? base + frontier_offset :
// 0; output in q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxQBlock = 16;

// pool kinds, as the wrapper passes them
constexpr int kF32 = 0, kBF16 = 1, kInt4 = 4, kInt8 = 8;

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;   // [N, P, H] for int8 / int4 pools, else unused
  const float* v_scales;
  const int* page_tables;  // [S, MP]
  const int* slot_ids;     // [T]
  const int* kv_lens;      // [T]
  void* out;               // [T, H, D]
  int T, H, D, P, MP, offset;
  float scale;
  int qb;                  // 0: K1; else K2's rows per slot block
  cudaStream_t stream;
};

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

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Pool<KIND>::load: head_dim elements [d0, d0 + 8) of pool row `row`
// (the flat (page * P + r) * H + h index) as f32, dequantized for int8 /
// int4 (code * scale, the reference's `k.astype(f32) * scales`).
// kRound: p is rounded to the pool dtype before the PV product.
template <int KIND>
struct Pool;

template <>
struct Pool<kF32> {
  static constexpr bool kRound = false;
  __device__ __forceinline__ static void load(const void* pool,
                                              const float*, int64_t row,
                                              int D, int d0, float (&x)[8]) {
    load8(static_cast<const float*>(pool) + row * D + d0, x);
  }
};

template <>
struct Pool<kBF16> {
  static constexpr bool kRound = true;
  __device__ __forceinline__ static void load(const void* pool,
                                              const float*, int64_t row,
                                              int D, int d0, float (&x)[8]) {
    load8(static_cast<const __nv_bfloat16*>(pool) + row * D + d0, x);
  }
};

template <>
struct Pool<kInt8> {
  static constexpr bool kRound = false;
  __device__ __forceinline__ static void load(const void* pool,
                                              const float* scales,
                                              int64_t row, int D, int d0,
                                              float (&x)[8]) {
    // 8 code bytes; a row is D bytes and D % 8 == 0, so 8-aligned
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(pool) + row * D + d0);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
    const float s = scales[row];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]) * s;
  }
};

__device__ __forceinline__ float nibble(unsigned byte, bool high) {
  const int n = static_cast<int>(high ? byte >> 4 : byte) & 0xF;
  return static_cast<float>((n ^ 8) - 8);   // sign extension
}

template <>
struct Pool<kInt4> {
  static constexpr bool kRound = false;
  __device__ __forceinline__ static void load(const void* pool,
                                              const float* scales,
                                              int64_t row, int D, int d0,
                                              float (&x)[8]) {
    const int half = D >> 1;
    const uint8_t* base = static_cast<const uint8_t*>(pool) + row * half;
    const float s = scales[row];
    if ((half & 7) == 0) {
      // the lane's 8 elements lie in one half: 8 consecutive bytes
      const bool high = d0 >= half;
      const uint2 u = *reinterpret_cast<const uint2*>(
          base + (high ? d0 - half : d0));
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = nibble(b[i], high) * s;
    } else {
      // D/2 not a multiple of 8: rows are not 8-byte aligned and a lane's
      // elements may straddle the halves — element by element
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = d0 + i;
        const bool high = e >= half;
        x[i] = nibble(base[high ? e - half : e], high) * s;
      }
    }
  }
};

__device__ __forceinline__ float round_p(float p, bool round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16(p)) : p;
}

// One pass of G-lane groups over kKeysPerPass key rows: fold the scores
// of the valid rows into the running (m, l, acc). s is this lane's part
// of its group's q·k dot, vv its 8 elements of the group's V row (zeros
// where not valid).
template <int KIND, int G>
__device__ __forceinline__ void fold_pass(bool valid, float s,
                                          const float (&vv)[8], float scale,
                                          float& m, float& l,
                                          float (&acc)[8]) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  s = valid ? s * scale : kNegInf;
  // running max over this pass's key rows (one per group)
  float mc = s;
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
    mc = fmaxf(mc, __shfl_xor_sync(kFull, mc, o));
  const float m_new = fmaxf(m, mc);
  const float alpha = expf(m - m_new);
  const float p = valid ? expf(s - m_new) : 0.f;
  float psum = p;
#pragma unroll
  for (int o = G; o < 32; o <<= 1) psum += __shfl_xor_sync(kFull, psum, o);
  l = alpha * l + psum;
  const float pc = round_p(p, Pool<KIND>::kRound);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = acc[i] * alpha + pc * vv[i];
  m = m_new;
}

// Fold the groups' partial accumulators (all share m), divide by l and
// store the row (kv_len 0 never ran a page: l == 0 → exact zeros).
template <typename QT, int G>
__device__ __forceinline__ void finish_row(float (&acc)[8], float l,
                                           bool store, QT* dst) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = G; o < 32; o <<= 1)
      acc[i] += __shfl_xor_sync(kFull, acc[i], o);
  }
  const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = acc[i] / safe_l;
  if (store) store8(dst, acc);
}

// G = lanes per key row (a power of two, G * 8 >= D).
template <typename QT, int KIND, int G>
__global__ void rpa_kernel(const Args a) {
  constexpr int kKeysPerPass = 32 / G;
  const QT* __restrict__ q = static_cast<const QT*>(a.q);
  QT* __restrict__ out = static_cast<QT*>(a.out);
  const int H = a.H, D = a.D, P = a.P;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int group = lane / G;        // which key row of the pass
  const int dim0 = (lane % G) * 8;   // this lane's 8 head_dim elements
  const bool has_dims = dim0 < D;

  const int base = a.kv_lens[t];
  const int kv = base > 0 ? base + a.offset : 0;
  const int n_pages = (kv + P - 1) / P;
  const int* table = a.page_tables + (int64_t)a.slot_ids[t] * a.MP;

  for (int h = warp; h < H; h += nwarps) {
    float qv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (has_dims) load8(q + ((int64_t)t * H + h) * D + dim0, qv);
    float m = kNegInf, l = 0.f;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

    for (int j = 0; j < n_pages; ++j) {
      const int64_t page = table[j];
      for (int r0 = 0; r0 < P; r0 += kKeysPerPass) {
        const int r = r0 + group;
        const bool valid = r < P && j * P + r < kv;
        float s = 0.f;
        float vv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (valid && has_dims) {
          const int64_t row = (page * P + r) * H + h;
          float kk[8];
          Pool<KIND>::load(a.k_pool, a.k_scales, row, D, dim0, kk);
#pragma unroll
          for (int i = 0; i < 8; ++i) s += qv[i] * kk[i];
          Pool<KIND>::load(a.v_pool, a.v_scales, row, D, dim0, vv);
        }
        fold_pass<KIND, G>(valid, s, vv, a.scale, m, l, acc);
      }
    }
    finish_row<QT, G>(acc, l, group == 0 && has_dims,
                      out + ((int64_t)t * H + h) * D + dim0);
  }
}

template <typename QT, int KIND, int G>
__global__ void rpa_qblock_kernel(const Args a) {
  constexpr int kKeysPerPass = 32 / G;
  extern __shared__ __align__(16) float smem[];
  const QT* __restrict__ q = static_cast<const QT*>(a.q);
  QT* __restrict__ out = static_cast<QT*>(a.out);
  const int H = a.H, D = a.D, P = a.P, qb = a.qb;
  float* ks = smem;            // [P, D] staged K page, f32
  float* vs = smem + P * D;    // [P, D] staged V page
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;   // this warp's row of the block
  const int group = lane / G;
  const int dim0 = (lane % G) * 8;
  const bool has_dims = dim0 < D;
  const int t = b * qb + warp;

  // per-row effective lengths; the block runs to its longest row
  int kvmax = 0;
  for (int i = 0; i < qb; ++i) {
    const int bi = a.kv_lens[b * qb + i];
    kvmax = max(kvmax, bi > 0 ? bi + a.offset : 0);
  }
  const int base = a.kv_lens[t];
  const int kv = base > 0 ? base + a.offset : 0;
  const int n_pages = min((kvmax + P - 1) / P, a.MP);
  // the slot-major contract: the block's slot is its first row's
  const int* table = a.page_tables + (int64_t)a.slot_ids[b * qb] * a.MP;
  const int chunks_per_row = D / 8;
  const int chunks = P * chunks_per_row;

  float qv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (has_dims) load8(q + ((int64_t)t * H + h) * D + dim0, qv);
  float m = kNegInf, l = 0.f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int j = 0; j < n_pages; ++j) {
    const int64_t page = table[j];
    __syncthreads();   // every warp is done with the previous page
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int r = c / chunks_per_row;
      const int d0 = (c - r * chunks_per_row) * 8;
      float kx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float vx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j * P + r < kvmax) {   // rows past the longest row stay zero
        const int64_t row = (page * P + r) * H + h;
        Pool<KIND>::load(a.k_pool, a.k_scales, row, D, d0, kx);
        Pool<KIND>::load(a.v_pool, a.v_scales, row, D, d0, vx);
      }
      store8(ks + r * D + d0, kx);
      store8(vs + r * D + d0, vx);
    }
    __syncthreads();
    for (int r0 = 0; r0 < P; r0 += kKeysPerPass) {
      const int r = r0 + group;
      const bool valid = r < P && j * P + r < kv;   // this row's own mask
      float s = 0.f;
      float vv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (valid && has_dims) {
        float kk[8];
        load8(ks + r * D + dim0, kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) s += qv[i] * kk[i];
        load8(vs + r * D + dim0, vv);
      }
      fold_pass<KIND, G>(valid, s, vv, a.scale, m, l, acc);
    }
  }
  finish_row<QT, G>(acc, l, group == 0 && has_dims,
                    out + ((int64_t)t * H + h) * D + dim0);
}

template <typename QT, int KIND, int G>
cudaError_t launch_g(const Args& a) {
  if (a.qb == 0) {
    const int nwarps = a.H < 16 ? a.H : 16;
    rpa_kernel<QT, KIND, G><<<a.T, 32 * nwarps, 0, a.stream>>>(a);
  } else {
    const size_t smem = 2 * (size_t)a.P * a.D * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          rpa_qblock_kernel<QT, KIND, G>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    rpa_qblock_kernel<QT, KIND, G>
        <<<dim3(a.T / a.qb, a.H), 32 * a.qb, smem, a.stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename QT, int KIND>
cudaError_t launch_kind(const Args& a) {
  const int rows = a.D / 8;  // lanes needed per key row
  if (rows <= 1) return launch_g<QT, KIND, 1>(a);
  if (rows <= 2) return launch_g<QT, KIND, 2>(a);
  if (rows <= 4) return launch_g<QT, KIND, 4>(a);
  if (rows <= 8) return launch_g<QT, KIND, 8>(a);
  if (rows <= 16) return launch_g<QT, KIND, 16>(a);
  return launch_g<QT, KIND, 32>(a);
}

template <typename QT>
cudaError_t launch_q(int kv_kind, const Args& a) {
  switch (kv_kind) {
    case kF32: return launch_kind<QT, kF32>(a);
    case kBF16: return launch_kind<QT, kBF16>(a);
    case kInt8: return launch_kind<QT, kInt8>(a);
    case kInt4: return launch_kind<QT, kInt4>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// to contiguous tensors: q/out [T, H, D]; pools [N, P, H, D] float32 /
// bfloat16 / int8, or [N, P, H, D/2] packed int4; k_scales / v_scales
// [N, P, H] float32 for int8 / int4 pools (ignored for float pools);
// page_tables [S, MP] int32; slot_ids / kv_lens [T] int32. q_bf16 selects
// a bfloat16 (1) or float32 (0) q; kv_kind is 0 f32, 1 bf16, 8 int8,
// 4 int4. qb == 0 launches K1; qb in 1..16 launches K2 on slot-major
// blocks of qb rows (T must be a multiple of qb). Launches on `stream`,
// does not synchronise, returns the cudaError_t of the launch
// (0 = success).
extern "C" int pt_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* page_tables,
    const void* slot_ids, const void* kv_lens, void* out, int T, int H,
    int D, int P, int MP, int offset, float scale, int q_bf16, int kv_kind,
    int qb, void* stream) {
  if (T <= 0 || H <= 0 || P <= 0 || MP <= 0 || D <= 0 || D % 8 != 0 ||
      D > 256 || qb < 0 || qb > kMaxQBlock || (qb > 0 && T % qb != 0) ||
      (qb > 0 && 2 * (size_t)P * D * sizeof(float) > 227 * 1024))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.page_tables = static_cast<const int*>(page_tables);
  a.slot_ids = static_cast<const int*>(slot_ids);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.out = out;
  a.T = T;
  a.H = H;
  a.D = D;
  a.P = P;
  a.MP = MP;
  a.offset = offset;
  a.scale = scale;
  a.qb = qb;
  a.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = q_bf16 ? launch_q<__nv_bfloat16>(kv_kind, a)
                                 : launch_q<float>(kv_kind, a);
  return (int)err;
}
