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
// K1 and K2 on the tensor cores (a bf16 q on a bf16, int8 or int4 pool,
// head_dim 64 or 128: every bf16 serving configuration's case;
// ops/cuda_kernels/paged_attention.py, `paged_route`): K1 is three
// launches, `rpa_tc_plan_kernel`, `rpa_tc_kernel` and
// `rpa_tc_merge_kernel`, K2 two, `rpa_tc_qblock_kernel` and
// `rpa_tc_qblock_merge_kernel`, described above them at the end of this
// file. An f32 q, an f32 pool and every other head_dim keep the kernels
// below (`rpa_kernel`, `rpa_qblock_kernel`): per-row / per-block passes
// in f32 on the CUDA cores, no cp.async staging — the exact f32 path.
//
// Semantics kept from the TPU kernels: scale 1/sqrt(D); f32 scores and
// f32 running m / l / acc; -1e30 on masked columns; V rows past kv_len
// never enter the accumulator (no 0 * NaN can form); p is rounded to the
// pool dtype before the PV product for bf16 pools and stays f32 for f32
// and quantized pools (their dequantized V is f32; the tensor-core route
// carries it as two bf16 halves, see there); l == 0 (kv_len 0)
// gives an exact zero row; kv_eff = base > 0 ? base + frontier_offset :
// 0; output in q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_sm90.cuh"

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

// ==== K1 and K2 on the tensor cores: bf16 q at head_dim 64 / 128 =========
//
// What held `rpa_kernel` back was its grid, not its arithmetic: one
// block per flat token walks all of that token's pages, so a decode tick
// (one row per live sequence) runs a handful of blocks on 132 SMs, and a
// prefill chunk of n rows of one slot reads the slot's pages n times.
// `rpa_qblock_kernel` had the same fault in another form: one block per
// (slot block, head) walking the slot's whole prefix a page at a time,
// two barriers and a synchronous f32 staging pass per page, the q·k
// products as lane-group dot products with nothing in flight. This route
// regroups the work, on the device and inside the launches, so the host
// plans nothing and copies nothing:
// * chunks (K1): runs of consecutive rows of one slot, cut at every 64th
//   row (rows t with t % 64 == 0 start a chunk, and so does every slot
//   change), so a chunk is at most 64 rows and any row order is right —
//   slots in any order, a 64-row tile holding the tail of one slot's rows
//   and the head of another's, rows of one slot apart. K2's contract
//   makes its chunks known without a plan: block b is rows
//   [b·qb, b·qb + qb) with the slot of row b·qb (the Pallas kernel's
//   `page_map`), qb <= 16;
// * split-KV: the keys 0..MP·P are cut into at most 8 splits of SL keys (a
//   multiple of the 64-key tile); a work item is (chunk, split) for each
//   split below the chunk's longest row. For K1 `rpa_tc_plan_kernel` (one
//   block) lists the items: chunk starts by flag, each chunk's longest row
//   by a forward scan of at most 64 rows, the item offsets by a block
//   scan; padding rows (kv_len 0) make no item. For K2 the grid is every
//   (block, split) pair: a block finds its longest row itself (one warp
//   reduction) and exits for a split past it;
// * the attention kernels (`rpa_tc_kernel<D, KIND>` for K1,
//   `rpa_tc_qblock_kernel<D, KIND>` for K2, one body `tc_item`): an item
//   stages the chunk's q rows once and its split's keys in 64-key tiles,
//   gathered through the slot's page table by cp.async into a ring (3
//   stages at head_dim 64, 2 at 128) — each page is read once per chunk,
//   not once per row. S = Q·Kᵀ and O += P·V run as mma.sync bf16 with f32
//   accumulators, the online softmax in registers (exp2, scale·log2 e
//   folded in), the mask (a row's own kv_len) by select on the tiles some
//   row of the warp ends in; a warp skips the tiles past all its rows.
//   K1: warp w owns rows 16w..16w+15 and all 64 keys of a tile. K2: the
//   block's <= 16 rows are one warp's m16 tile, so the four warps share
//   them and each takes its own 16-key quarter of every tile, keeping its
//   own (m, l, acc); at the item's end the four states meet in shared
//   memory (acc·2^(m − M) summed, over l·2^(m − M) summed). Chosen over a
//   16-row tile of one warp per block because it keeps K1's ring, tile
//   and barrier count as they are, has all 128 threads issue the cp.async
//   gathers, and leaves no warp idle at qb = 5. A row whose keys lie in
//   one split is written out directly; a longer row leaves its partial
//   (m, l, acc) in f32;
// * the merges (`rpa_tc_merge_kernel<D>` for K1,
//   `rpa_tc_qblock_merge_kernel<D>` for K2, one body): one warp per (row,
//   head) merges a row's split partials the same way and writes exact
//   zeros for rows of kv_len 0 (padding rows, K2's dead and narrow rows).
//
// Pools (KIND): bf16, int8, or packed int4 (split halves: element d < D/2
// is the low nibble of byte d, d >= D/2 the high nibble of byte d − D/2),
// the quantized kinds with [N, P, H] f32 k / v scales. For a quantized
// pool the ring stages the CODES (D or D/2 bytes a row, so a tile moves
// 2x or 4x fewer bytes) and, beside them, each key's two f32 scales
// (4-byte cp.async of scales[(page·P + r)·H + h]); one pass per tile then
// writes the codes as bf16 into the tile the fragment loaders read. int8
// codes and sign-extended nibbles are integers in [-128, 127], which bf16
// holds exactly.
//
// Numerics. bf16 pools: p is rounded to bf16 before P·V, as the Pallas
// kernel does for bf16 pools (`p.astype(vt.dtype)`). Quantized pools:
// the Pallas kernel dequantizes to f32 and keeps p in f32, so here
// S = (Q·codesᵀ) on the tensor cores with f32 accumulation, then each
// column times its key's k-scale — the reference's q·(code·scale) up to
// summation order, no approximation; for P·V the v-scale is folded into
// the weight, w = p·vscale in f32, split as w_hi = bf16(w) and
// w_lo = bf16(w − w_hi), and two mma.sync against the bf16 codes add
// w_hi·V + w_lo·V into one accumulator: the weights keep 2^-16 of
// relative precision (bf16's 8 significant bits, twice), against 2^-8 for
// a single bf16 weight. At 1-4 flops per byte the second product costs
// nothing measurable. The row sum l takes the unscaled p in f32.
// What bounds it: bytes (the slot's codes or bf16 rows read once per
// chunk), but at the serving shapes a tick is a few microseconds of work,
// so the launches' latency and the block scheduling are what the time
// shows (PERF.md). Entry: pt_ragged_paged_attention_tc.
namespace tc {

using namespace pt_mma;
constexpr int kThreads = 128;       // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPlanThreads = 1024;
constexpr int kMergeWarps = 8;
constexpr int BQ = 64;              // rows of a K1 chunk: 4 warps x 16
constexpr int BK = 64;              // keys of a kv tile
constexpr int kMaxSplits = 8;
static_assert(kThreads == 2 * BK, "one thread per key scale of a tile");
// the K / V ring: 3 stages at head_dim 64; 2 at 128 (87 KB for bf16
// pools: 2 blocks/SM)
template <int D>
constexpr int kStages = D <= 64 ? 3 : 2;

struct TcArgs {
  const bf16* q;             // [T, H, D]
  const void* k_pool;        // [N, P, H, D] bf16 / int8, [N, P, H, D/2] int4
  const void* v_pool;
  const float* k_scales;     // [N, P, H] for int8 / int4 pools
  const float* v_scales;
  const int* page_tables;    // [S, MP]
  const int* slot_ids;       // [T]
  const int* kv_lens;        // [T]
  bf16* out;                 // [T, H, D]
  int4* items;               // [T·NS]: (chunk row, rows, split, longest row)
  int* n_items;
  float2* part_ml;           // [NS, T, H]: (m · scale · log2 e, l)
  float* part_o;             // [NS, T, H, D]: unnormalized acc
  int T, H, P, MP, offset, SL, NS;
  int qb;                    // K2's rows per slot block (0 for K1)
  float scale;
};

// Shared memory of one attention block: the chunk's q rows [ROWS][LD]
// bf16, then for a bf16 pool the K / V ring [ST][BK][LD] bf16 each; for a
// quantized pool the code ring [ST][BK][CB] bytes each, the scale ring
// [ST][BK] f32 each and one bf16 K / V tile pair [BK][LD]. K2's merge of
// the four warps' states ([4][16][D] f32 acc, [4][16] (m, l)) reuses the
// ring.
template <int D, int KIND, bool QB>
struct Smem {
  static constexpr int LD = D + 8;
  static constexpr int ST = kStages<D>;
  static constexpr int ROWS = QB ? 16 : BQ;
  static constexpr bool kQuant = KIND != kBF16;
  static constexpr int CB = KIND == kInt4 ? D / 2 : D;   // bytes of a code row
  static constexpr size_t q = sizeof(bf16) * ROWS * LD;
  static constexpr size_t ring =
      kQuant ? (size_t)ST * BK * (2 * CB + 2 * sizeof(float)) +
                   2 * sizeof(bf16) * BK * LD
             : 2 * sizeof(bf16) * ST * BK * LD;
  static constexpr size_t merge =
      QB ? kWarps * 16 * (D * sizeof(float) + sizeof(float2)) : 0;
  static constexpr size_t bytes = q + (ring > merge ? ring : merge);
};

// a row's effective kv length: base + offset for a live row (base > 0),
// clamped to the MP·P keys its table can name; 0 for a padding row
__device__ __forceinline__ int kv_eff(const int* kv_lens, int t, int offset,
                                      int L) {
  const int base = kv_lens[t];
  return base > 0 ? max(0, min(base + offset, L)) : 0;
}

__global__ void __launch_bounds__(kPlanThreads)
rpa_tc_plan_kernel(const TcArgs a) {
  // rows are taken kPlanThreads at a time, a multiple of BQ, so no chunk
  // crosses from one round to the next; a round's slot ids and lengths
  // are staged in shared memory for the chunk starts' forward scans
  __shared__ int sid_s[kPlanThreads], kv_s[kPlanThreads];
  __shared__ int warp_sum[kPlanThreads / 32];
  __shared__ int carry;
  const int L = a.MP * a.P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  for (int base = 0; base < a.T; base += kPlanThreads) {
    const int i = base + tid;
    if (i < a.T) {
      sid_s[tid] = a.slot_ids[i];
      kv_s[tid] = kv_eff(a.kv_lens, i, a.offset, L);
    }
    __syncthreads();
    int n = 0, rows = 0, kvmax = 0;
    if (i < a.T && (i % BQ == 0 || sid_s[tid - 1] != sid_s[tid])) {
      int j = tid;   // a chunk starts: its rows and its longest row
      do {
        kvmax = max(kvmax, kv_s[j]);
        ++j;
      } while (base + j < a.T && (base + j) % BQ != 0 &&
               sid_s[j] == sid_s[tid]);
      rows = j - tid;
      n = (kvmax + a.SL - 1) / a.SL;   // its non-empty splits
    }
    // item offsets: an inclusive scan of n over the block
    int x = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int first = carry + (warp ? warp_sum[warp - 1] : 0) + x - n;
    for (int s = 0; s < n; ++s)
      a.items[first + s] = make_int4(i, rows, s, kvmax);
    __syncthreads();   // the round's shared arrays and carry are read
    if (tid == kPlanThreads - 1) carry = first + n;
  }
  __syncthreads();
  if (tid == 0) *a.n_items = carry;
}

// w_hi = bf16(w), w_lo = bf16(w − w_hi) for two weights, packed as A
// operand registers (the first weight in the low half)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// sixteen int8 codes → sixteen bf16 (exact)
__device__ __forceinline__ void codes_to_bf16(const int8_t* c, uint4& a,
                                              uint4& b) {
  a = make_uint4(pack_bf16(c[0], c[1]), pack_bf16(c[2], c[3]),
                 pack_bf16(c[4], c[5]), pack_bf16(c[6], c[7]));
  b = make_uint4(pack_bf16(c[8], c[9]), pack_bf16(c[10], c[11]),
                 pack_bf16(c[12], c[13]), pack_bf16(c[14], c[15]));
}

// One work item: rows [c0, c0 + n) of one slot, keys of split `split`
// up to the chunk's longest row `kvmax`, head blockIdx.y.
template <int D, int KIND, bool QB>
__device__ __forceinline__ void tc_item(const TcArgs& a, char* smem, int c0,
                                        int n, int split, int kvmax) {
  using SM = Smem<D, KIND, QB>;
  constexpr int LD = SM::LD, NT = kThreads, ST = SM::ST, CB = SM::CB;
  constexpr bool kQuant = SM::kQuant;
  constexpr int KS = D / 16;         // k16 steps over head_dim
  constexpr int NSW = QB ? 2 : 8;    // n8 blocks of a warp's score tile
  constexpr int KEYS = 8 * NSW;      // keys of a tile a warp scores
  constexpr int NO = D / 8;          // n8 blocks of the output
  constexpr int CPR = D / 8;         // 16-byte chunks of a bf16 row
  bf16* Qs = reinterpret_cast<bf16*>(smem);            // [ROWS][LD]
  char* ring = smem + SM::q;
  // bf16 pools: the ring itself; quantized: codes, scales, bf16 tiles
  bf16* Ks = reinterpret_cast<bf16*>(ring);             // [ST][BK][LD]
  bf16* Vs = Ks + ST * BK * LD;
  uint8_t* Kq = reinterpret_cast<uint8_t*>(ring);       // [ST][BK][CB]
  uint8_t* Vq = Kq + ST * BK * CB;
  float* Ksc = reinterpret_cast<float*>(Vq + ST * BK * CB);   // [ST][BK]
  float* Vsc = Ksc + ST * BK;
  bf16* Kc = reinterpret_cast<bf16*>(Vsc + ST * BK);    // [BK][LD]
  bf16* Vc = Kc + BK * LD;

  const int h = blockIdx.y, H = a.H, P = a.P, SL = a.SL;
  const int L = a.MP * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lane = lane >> 2;   // this lane's rows: RW + r_lane (+ 8)
  const int c_lane = 2 * (lane & 3);   // its first column in an n8 block
  const int RW = QB ? 0 : 16 * warp;   // the warp's first row
  const int KW = QB ? KEYS * warp : 0;   // its first key of a tile
  const float sl2 = a.scale * kLog2e;
  const int64_t plane = (int64_t)a.T * H;
  const int k_begin = split * SL;
  const int k_end = min(k_begin + SL, kvmax);
  const int n_kv = (k_end - k_begin + BK - 1) / BK;
  const int* table = a.page_tables + (int64_t)a.slot_ids[c0] * a.MP;
  int kvr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = RW + r_lane + 8 * i;
    kvr[i] = r < n ? kv_eff(a.kv_lens, c0 + r, a.offset, L) : 0;
  }
  const int wmax = __reduce_max_sync(kFull, max(kvr[0], kvr[1]));
  const int wmin = __reduce_min_sync(kFull, min(kvr[0], kvr[1]));

  __syncthreads();   // the last item's readers are done with Qs and the ring
  // the chunk's q rows of head h; rows n..ROWS-1 zero-filled
#pragma unroll
  for (int i = 0; i < SM::ROWS * CPR / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < n;
    cp_async16(smem_addr(Qs + r * LD + 8 * c),
               a.q + (ok ? ((int64_t)(c0 + r) * H + h) * D + 8 * c : 0),
               ok ? 16 : 0);
  }
  // kv tile t (keys k_begin + 64t ..) into ring stage t % ST, each key
  // through the slot's page table; keys past k_end: zeros (their table
  // entries, possibly stale, are never read)
  auto stage_kv = [&](int t) {
    if (t >= n_kv) return;
    const int k0 = k_begin + t * BK, st = t % ST;
    if constexpr (!kQuant) {
#pragma unroll
      for (int i = 0; i < BK * CPR / NT; ++i) {
        const int idx = threadIdx.x + i * NT;
        const int r = idx / CPR, c = idx % CPR;
        const int key = k0 + r;
        const bool ok = key < k_end;
        int64_t off = 0;
        if (ok)
          off = (((int64_t)table[key / P] * P + key % P) * H + h) * D + 8 * c;
        cp_async16(smem_addr(Ks + (st * BK + r) * LD + 8 * c),
                   static_cast<const bf16*>(a.k_pool) + off, ok ? 16 : 0);
        cp_async16(smem_addr(Vs + (st * BK + r) * LD + 8 * c),
                   static_cast<const bf16*>(a.v_pool) + off, ok ? 16 : 0);
      }
    } else {
      constexpr int CC = CB / 16;   // 16-byte chunks of a code row
#pragma unroll
      for (int i = 0; i < BK * CC / NT; ++i) {
        const int idx = threadIdx.x + i * NT;
        const int r = idx / CC, c = idx % CC;
        const int key = k0 + r;
        const bool ok = key < k_end;
        int64_t off = 0;
        if (ok)
          off = (((int64_t)table[key / P] * P + key % P) * H + h) * CB + 16 * c;
        cp_async16(smem_addr(Kq + (st * BK + r) * CB + 16 * c),
                   static_cast<const uint8_t*>(a.k_pool) + off, ok ? 16 : 0);
        cp_async16(smem_addr(Vq + (st * BK + r) * CB + 16 * c),
                   static_cast<const uint8_t*>(a.v_pool) + off, ok ? 16 : 0);
      }
      // threads 0..63 the k-scale of key k0 + tid, 64..127 the v-scale
      const int r = threadIdx.x & (BK - 1), key = k0 + r;
      const bool ok = key < k_end;
      int64_t row = 0;
      if (ok) row = ((int64_t)table[key / P] * P + key % P) * H + h;
      const bool is_k = threadIdx.x < BK;
      cp_async4(smem_addr((is_k ? Ksc : Vsc) + st * BK + r),
                (is_k ? a.k_scales : a.v_scales) + row, ok ? 4 : 0);
    }
  };
  // the codes of ring stage st as bf16 into Kc / Vc
  auto convert = [&](int st) {
    // chunks of a row: 16 int8 codes, or 8 bytes of nibble pairs
    constexpr int CH = D / 16;
#pragma unroll
    for (int i = 0; i < 2 * BK * CH / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      const bool is_v = idx >= BK * CH;
      const int j = is_v ? idx - BK * CH : idx;
      const int r = j / CH, c = j % CH;
      const uint8_t* src = (is_v ? Vq : Kq) + (st * BK + r) * CB;
      bf16* dst = (is_v ? Vc : Kc) + r * LD;
      if constexpr (KIND == kInt8) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + 16 * c);
        uint4 x, y;
        codes_to_bf16(reinterpret_cast<const int8_t*>(&u), x, y);
        *reinterpret_cast<uint4*>(dst + 16 * c) = x;
        *reinterpret_cast<uint4*>(dst + 16 * c + 8) = y;
      } else {
        // bytes 8c..8c+7: their low nibbles are elements 8c.., their high
        // nibbles elements D/2 + 8c..
        const uint2 u = *reinterpret_cast<const uint2*>(src + 8 * c);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] = pack_bf16(nibble(b[2 * e], false),
                            nibble(b[2 * e + 1], false));
          hi[e] = pack_bf16(nibble(b[2 * e], true),
                            nibble(b[2 * e + 1], true));
        }
        *reinterpret_cast<uint4*>(dst + 8 * c) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(dst + D / 2 + 8 * c) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
  };
  // one commit group per tile: the first also holds Q
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    stage_kv(t);
    cp_commit();
  }

  uint32_t qa[KS][4];
  float o[NO][4];
  float m[2] = {kNegInf, kNegInf};   // row max (q·k units)
  float l[2] = {0.f, 0.f};           // this lane's part of the row sum
#pragma unroll
  for (int nn = 0; nn < NO; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = k_begin + t * BK, st = t % ST;
    cp_wait<ST - 2>();   // Q and tile t have landed ...
    __syncthreads();     // ... for every thread, and tile t - 1 is done with
    stage_kv(t + ST - 1);   // into the stage tile t - 1 used
    cp_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        frag_a<LD>(qa[kk], Qs, RW, 16 * kk, lane);
    }
    const bf16* Kt = Ks + st * BK * LD;
    const bf16* Vt = Vs + st * BK * LD;
    if constexpr (kQuant) {
      convert(st);
      __syncthreads();   // the bf16 tiles are written
      Kt = Kc;
      Vt = Vc;
    }
    if (wmax <= k0 + KW) continue;   // every key past all of the warp's rows

    float s[NSW][4];   // S = Q · Kᵀ over the warp's keys KW..KW+KEYS-1
#pragma unroll
    for (int j = 0; j < NSW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NSW; j += 2) {
        uint32_t b[4];
        frag_b<LD>(b, Kt, KW + 8 * j, 16 * kk, lane);
        mma_bf16(s[j], qa[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qa[kk], b[2], b[3]);
      }
    // tile-local key of accumulator (j, e)
    auto key_of = [&](int j, int e) { return KW + 8 * j + c_lane + (e & 1); };
    if constexpr (kQuant) {   // q·code → q·(code · k-scale)
#pragma unroll
      for (int j = 0; j < NSW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= Ksc[st * BK + key_of(j, e)];
    }

    // the mask by select where some row of the warp ends in its keys;
    // then the online softmax
    const bool edge = k0 + KW + KEYS > wmin;
    auto masked = [&](int j, int e) {
      return edge && k0 + key_of(j, e) >= kvr[e >> 1];
    };
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NSW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked(j, e)) s[j][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float mb[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      alpha[i] = fast_exp2((m[i] - mx[i]) * sl2);
      m[i] = mx[i];
      mb[i] = mx[i] * sl2;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NSW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(s[j][e], sl2, -mb[e >> 1]));
        if (masked(j, e)) p = 0.f;
        l[e >> 1] += p;
        // quantized pools: the weight of a code row is p · v-scale
        if constexpr (kQuant) p *= Vsc[st * BK + key_of(j, e)];
        s[j][e] = p;
      }
#pragma unroll
    for (int nn = 0; nn < NO; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] *= alpha[e >> 1];

    // O += P · V with P in registers as the A operand: rounded to bf16
    // (bf16 pools), or as w_hi + w_lo (quantized pools)
#pragma unroll
    for (int kk = 0; kk < NSW / 2; ++kk) {
      uint32_t pa[4], pl[4];
      if constexpr (!kQuant) {
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      } else {
        split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], pa[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pl[3]);
      }
#pragma unroll
      for (int nn = 0; nn < NO; nn += 2) {
        uint32_t b[4];
        frag_bt<LD>(b, Vt, KW + 16 * kk, 8 * nn, lane);
        mma_bf16(o[nn], pa, b[0], b[1]);
        mma_bf16(o[nn + 1], pa, b[2], b[3]);
        if constexpr (kQuant) {
          mma_bf16(o[nn], pl, b[0], b[1]);
          mma_bf16(o[nn + 1], pl, b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  if constexpr (!QB) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const int r = RW + r_lane + 8 * i;
      // a row with no key in this split (kv_len 0 included) leaves nothing
      if (r >= n || kvr[i] <= k_begin) continue;
      const int64_t th = (int64_t)(c0 + r) * H + h;   // the (token, head) row
      if (kvr[i] <= SL) {   // split 0 holds the whole row: the output itself
        const float inv = 1.f / sum;
        bf16* dst = a.out + th * D + c_lane;
#pragma unroll
        for (int nn = 0; nn < NO; ++nn)
          *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
              pack_bf16(o[nn][2 * i] * inv, o[nn][2 * i + 1] * inv);
      } else {
        float* dst = a.part_o + (split * plane + th) * D + c_lane;
#pragma unroll
        for (int nn = 0; nn < NO; ++nn)
          *reinterpret_cast<float2*>(dst + 8 * nn) =
              make_float2(o[nn][2 * i], o[nn][2 * i + 1]);
        if ((lane & 3) == 0)
          a.part_ml[split * plane + th] = make_float2(m[i] * sl2, sum);
      }
    }
  } else {
    // K2: the four warps' states of the block's 16 rows meet in shared
    // memory (the ring is free: every copy has landed and been read)
    float* mo = reinterpret_cast<float*>(ring);                 // [4][16][D]
    float2* mml = reinterpret_cast<float2*>(mo + kWarps * 16 * D);   // [4][16]
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const int r = r_lane + 8 * i;
      float* dst = mo + (warp * 16 + r) * D + c_lane;
#pragma unroll
      for (int nn = 0; nn < NO; ++nn)
        *reinterpret_cast<float2*>(dst + 8 * nn) =
            make_float2(o[nn][2 * i], o[nn][2 * i + 1]);
      if ((lane & 3) == 0) mml[warp * 16 + r] = make_float2(m[i] * sl2, sum);
    }
    __syncthreads();
    // thread → (row r, E columns from e0); 8 threads a row
    constexpr int E = D / 8;
    const int r = threadIdx.x >> 3, e0 = (threadIdx.x & 7) * E;
    const int kv = r < n ? kv_eff(a.kv_lens, c0 + r, a.offset, L) : 0;
    if (kv > k_begin) {
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mml[w * 16 + r].x);
      float lsum = 0.f, acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float2 ml = mml[w * 16 + r];
        const float f = exp2f(ml.x - M);
        lsum += f * ml.y;
        const float* src = mo + (w * 16 + r) * D + e0;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += f * src[e];
      }
      const int64_t th = (int64_t)(c0 + r) * H + h;
      if (kv <= SL) {
        const float inv = 1.f / lsum;
        bf16* dst = a.out + th * D + e0;
#pragma unroll
        for (int e = 0; e < E; e += 2)
          *reinterpret_cast<uint32_t*>(dst + e) =
              pack_bf16(acc[e] * inv, acc[e + 1] * inv);
      } else {
        float* dst = a.part_o + (split * plane + th) * D + e0;
#pragma unroll
        for (int e = 0; e < E; e += 2)
          *reinterpret_cast<float2*>(dst + e) =
              make_float2(acc[e], acc[e + 1]);
        if (e0 == 0) a.part_ml[split * plane + th] = make_float2(M, lsum);
      }
    }
  }
}

template <int D, int KIND>
__global__ void __launch_bounds__(kThreads) rpa_tc_kernel(const TcArgs a) {
  extern __shared__ float4 smem4[];
  const int n_items = *a.n_items;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int4 it = a.items[w];
    tc_item<D, KIND, false>(a, reinterpret_cast<char*>(smem4), it.x, it.y,
                            it.z, it.w);
  }
}

// K2: blockIdx.x = slot block · NS + split
template <int D, int KIND>
__global__ void __launch_bounds__(kThreads)
rpa_tc_qblock_kernel(const TcArgs a) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x / a.NS, split = blockIdx.x % a.NS;
  const int c0 = b * a.qb, lane = threadIdx.x & 31;
  // the block's longest row (every warp reduces the same rows)
  const int kv = lane < a.qb
                     ? kv_eff(a.kv_lens, c0 + lane, a.offset, a.MP * a.P)
                     : 0;
  const int kvmax = __reduce_max_sync(kFull, kv);
  if (split * a.SL >= kvmax) return;   // no key of this split is needed
  tc_item<D, KIND, true>(a, reinterpret_cast<char*>(smem4), c0, a.qb, split,
                         kvmax);
}

// One warp per (row, head): merge a row's split partials (rows of one
// split were written by the attention kernel; kv_len 0: exact zeros)
template <int D>
__device__ __forceinline__ void merge_row(const TcArgs& a) {
  constexpr int E = D / 32;   // elements of the row a lane merges: 2 or 4
  const int64_t plane = (int64_t)a.T * a.H;
  const int64_t th = (int64_t)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (th >= plane) return;
  const int lane = threadIdx.x & 31;
  const int kv = kv_eff(a.kv_lens, (int)(th / a.H), a.offset, a.MP * a.P);
  const int ns = (kv + a.SL - 1) / a.SL;
  if (ns == 1) return;   // the attention kernel wrote the row
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  if (ns > 1) {          // else kv_len 0: exact zeros
    float M = kNegInf;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, a.part_ml[s * plane + th].x);
    float lsum = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float2 ml = a.part_ml[s * plane + th];
      const float w = exp2f(ml.x - M);
      lsum += w * ml.y;
      const float* src = a.part_o + (s * plane + th) * D + E * lane;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += w * src[e];
    }
    const float inv = 1.f / lsum;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= inv;
  }
  bf16* dst = a.out + th * D + E * lane;
#pragma unroll
  for (int e = 0; e < E; e += 2)
    *reinterpret_cast<uint32_t*>(dst + e) = pack_bf16(acc[e], acc[e + 1]);
}

template <int D>
__global__ void __launch_bounds__(32 * kMergeWarps)
rpa_tc_merge_kernel(const TcArgs a) {
  merge_row<D>(a);
}

// the same body as rpa_tc_merge_kernel under a symbol of its own, so that
// a profile (profile_serve's PAGED_KERNELS) attributes K2's merge to K2
template <int D>
__global__ void __launch_bounds__(32 * kMergeWarps)
rpa_tc_qblock_merge_kernel(const TcArgs a) {
  merge_row<D>(a);
}

// The split length (a multiple of the tile, at most kMaxSplits splits of
// the MP·P keys) and the workspace: for K1 (qb 0) the plan's items [T·NS]
// int4 and n_items in the int4 slot after them (K2 has no plan and no
// items), then part_ml [NS, T, H] float2, then part_o [NS, T, H, D] f32.
struct Layout {
  int NS, SL;
  size_t ml, part, bytes;
};

Layout layout(int T, int H, int D, int P, int MP, int qb) {
  const int L = MP * P;
  const int tiles = (L + BK - 1) / BK;
  const int ns = tiles < kMaxSplits ? tiles : kMaxSplits;
  Layout w;
  w.SL = (tiles + ns - 1) / ns * BK;
  w.NS = (L + w.SL - 1) / w.SL;
  const size_t rows = (size_t)w.NS * T * H;
  w.ml = qb ? 0 : sizeof(int4) * ((size_t)T * w.NS + 1);
  w.part = w.ml + (sizeof(float2) * rows + 15) / 16 * 16;
  w.bytes = w.part + sizeof(float) * rows * D;
  return w;
}

template <int D, int KIND, bool QB>
cudaError_t launch(const TcArgs& a, cudaStream_t stream) {
  // per device: its SM count, once this kernel's shared memory limit is
  // raised there (0 before): the setup runs once, not on every tick
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sm_count[kMaxDevices];
  constexpr size_t smem = Smem<D, KIND, QB>::bytes;
  void (*kernel)(TcArgs) =
      QB ? rpa_tc_qblock_kernel<D, KIND> : rpa_tc_kernel<D, KIND>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = sm_count[dev].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sm_count[dev].store(sms);
  }
  const int64_t rows = (int64_t)a.T * a.H;
  const unsigned merge_blocks =
      (unsigned)((rows + kMergeWarps - 1) / kMergeWarps);
  if constexpr (QB) {
    kernel<<<dim3(a.T / a.qb * a.NS, a.H), kThreads, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    rpa_tc_qblock_merge_kernel<D>
        <<<merge_blocks, 32 * kMergeWarps, 0, stream>>>(a);
    return cudaGetLastError();
  }
  rpa_tc_plan_kernel<<<1, kPlanThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // about 4 blocks per SM in all; a block with no item exits at once
  const int per_head = (4 * sms + a.H - 1) / a.H;
  const int g = a.T * a.NS < per_head ? a.T * a.NS : per_head;
  kernel<<<dim3(g, a.H), kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rpa_tc_merge_kernel<D><<<merge_blocks, 32 * kMergeWarps, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool QB>
cudaError_t launch_kind(int kv_kind, const TcArgs& a, cudaStream_t stream) {
  switch (kv_kind) {
    case kBF16: return launch<D, kBF16, QB>(a, stream);
    case kInt8: return launch<D, kInt8, QB>(a, stream);
    case kInt4: return launch<D, kInt4, QB>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

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

// The tensor-core route of K1 (qb 0) and K2 (qb in 1..16; see `namespace
// tc` above): q / out [T, H, D] bfloat16, pools [N, P, H, D] bfloat16 or
// int8, or [N, P, H, D/2] packed int4, k_scales / v_scales [N, P, H]
// float32 for the quantized pools (16-byte aligned pools), page_tables
// [S, MP], slot_ids / kv_lens [T] int32, `workspace` a device buffer of
// at least pt_ragged_paged_attention_tc_workspace(T, H, D, P, MP, qb)
// bytes.
// Refuses (cudaErrorInvalidValue, nothing launched) anything but a bf16 q
// (q_bf16 1) on a bf16, int8 or int4 pool (kv_kind 1, 8, 4) at D 64 or
// 128. K1 is three launches on `stream` (plan, attention, merge), K2 two
// (attention, merge); no synchronisation; returns the first launch error.
extern "C" long long pt_ragged_paged_attention_tc_workspace(int T, int H,
                                                            int D, int P,
                                                            int MP, int qb) {
  return (long long)tc::layout(T, H, D, P, MP, qb).bytes;
}

extern "C" int pt_ragged_paged_attention_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* page_tables,
    const void* slot_ids, const void* kv_lens, void* out, void* workspace,
    long long workspace_bytes, int T, int H, int D, int P, int MP,
    int offset, float scale, int q_bf16, int kv_kind, int qb, void* stream) {
  const bool quant = kv_kind == kInt8 || kv_kind == kInt4;
  if (T <= 0 || H <= 0 || P <= 0 || MP <= 0 || (D != 64 && D != 128) ||
      q_bf16 != 1 || !(kv_kind == kBF16 || quant) || qb < 0 ||
      qb > kMaxQBlock || (qb > 0 && T % qb != 0) ||
      (quant && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const tc::Layout w = tc::layout(T, H, D, P, MP, qb);
  if (workspace_bytes < (long long)w.bytes) return (int)cudaErrorInvalidValue;
  char* ws = static_cast<char*>(workspace);
  tc::TcArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.page_tables = static_cast<const int*>(page_tables);
  a.slot_ids = static_cast<const int*>(slot_ids);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.items = qb ? nullptr : reinterpret_cast<int4*>(ws);
  a.n_items =
      qb ? nullptr : reinterpret_cast<int*>(a.items + (size_t)T * w.NS);
  a.part_ml = reinterpret_cast<float2*>(ws + w.ml);
  a.part_o = reinterpret_cast<float*>(ws + w.part);
  a.T = T;
  a.H = H;
  a.P = P;
  a.MP = MP;
  a.offset = offset;
  a.SL = w.SL;
  a.NS = w.NS;
  a.qb = qb;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = qb ? tc::launch_kind<64, true>(kv_kind, a, s)
             : tc::launch_kind<64, false>(kv_kind, a, s);
  else
    err = qb ? tc::launch_kind<128, true>(kv_kind, a, s)
             : tc::launch_kind<128, false>(kv_kind, a, s);
  return (int)err;
}
