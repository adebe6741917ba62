// Ragged paged attention for Hopper (sm_90a) — the serving decode kernel.
//
// Replaces the Pallas TPU kernel `_rpa_kernel`
// (paddle_tpu/ops/pallas_kernels/paged_attention.py, launched by
// `ragged_paged_attention`) for float pools. One query row per flat
// scheduled token attends to its own slot's KV prefix, read page by page
// through `page_tables[slot_ids[t]]`; decode tokens (one per sequence)
// and chunked-prefill tokens (many per sequence) share one launch.
//
// What bounds it: decode attention is bandwidth-bound. Each token reads
// kv_len rows of K and V (kv_len * H * D * 2 * itemsize bytes) and does
// 4 * kv_len * H * D flops on them, about one flop per byte in bf16 —
// far below the ~295 flops/byte where the H100's tensor cores become the
// limit. The least time is the K/V bytes over 3.35 TB/s.
//
// Design. The Pallas grid walks (token, page) in order and carries the
// online-softmax state in VMEM scratch across grid steps; CUDA blocks run
// in parallel and in no order, so here ONE block owns one token and
// loops over that token's pages inside the block. Warps take heads
// (warp w serves heads w, w + nwarps, ...). Inside a warp, a group of
// G lanes owns one key row: each lane loads 8 contiguous head_dim
// elements (16 bytes in bf16, so a group reads one contiguous row and
// a warp reads 32/G rows per pass), the group reduces the q·k dot by
// shuffles, and the warp folds the 32/G scores of a pass into the
// running max / sum / accumulator. The page loop is bounded by
// ceil(kv_len_eff / P): page-table entries past it may hold stale ids
// and are never read. Simple first: no cp.async/TMA staging and no
// tensor cores yet (later work, see PERF.md).
//
// Semantics kept from the TPU kernel: scale 1/sqrt(D); f32 scores and
// f32 running m / l / acc; -1e30 on masked columns; V rows past kv_len
// never enter the accumulator (no 0 * NaN can form); p is rounded to the
// pool dtype before the PV product; l == 0 (kv_len 0) gives an exact zero
// row; kv_eff = base > 0 ? base + frontier_offset : 0; output in q's
// dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// p rounded to the pool dtype before the PV product (TPU kernel :117-119)
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

// G = lanes per key row (a power of two, G * 8 >= D).
template <typename QT, typename KT, int G>
__global__ void rpa_kernel(const QT* __restrict__ q,
                           const KT* __restrict__ k_pool,
                           const KT* __restrict__ v_pool,
                           const int* __restrict__ page_tables,
                           const int* __restrict__ slot_ids,
                           const int* __restrict__ kv_lens,
                           QT* __restrict__ out, int H, int D, int P,
                           int MP, int offset, float scale) {
  constexpr int kKeysPerPass = 32 / G;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int group = lane / G;        // which key row of the pass
  const int dim0 = (lane % G) * 8;   // this lane's 8 head_dim elements
  const bool has_dims = dim0 < D;

  const int base = kv_lens[t];
  const int kv = base > 0 ? base + offset : 0;
  const int n_pages = (kv + P - 1) / P;
  const int* table = page_tables + (int64_t)slot_ids[t] * MP;

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
          const int64_t row = ((page * P + r) * H + h) * D + dim0;
          float kk[8];
          load8(k_pool + row, kk);
#pragma unroll
          for (int i = 0; i < 8; ++i) s += qv[i] * kk[i];
          load8(v_pool + row, vv);
        }
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
        for (int o = G; o < 32; o <<= 1)
          psum += __shfl_xor_sync(kFull, psum, o);
        l = alpha * l + psum;
        const float pc = round_to(p, k_pool);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = acc[i] * alpha + pc * vv[i];
        m = m_new;
      }
    }
    // fold the groups' partial accumulators (all share m)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
        acc[i] += __shfl_xor_sync(kFull, acc[i], o);
    }
    // kv_len 0 never ran a page: l == 0 → exact zeros
    const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = acc[i] / safe_l;
    if (group == 0 && has_dims)
      store8(out + ((int64_t)t * H + h) * D + dim0, acc);
  }
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k_pool,
                         const void* v_pool, const int* page_tables,
                         const int* slot_ids, const int* kv_lens, void* out,
                         int T, int H, int D, int P, int MP, int offset,
                         float scale, cudaStream_t stream) {
  const int nwarps = H < 16 ? H : 16;
  const dim3 grid(T), block(32 * nwarps);
  const int rows = D / 8;  // lanes needed per key row
  const QT* qp = static_cast<const QT*>(q);
  const KT* kp = static_cast<const KT*>(k_pool);
  const KT* vp = static_cast<const KT*>(v_pool);
  QT* op = static_cast<QT*>(out);
#define PT_RPA_LAUNCH(G)                                                   \
  rpa_kernel<QT, KT, G><<<grid, block, 0, stream>>>(                       \
      qp, kp, vp, page_tables, slot_ids, kv_lens, op, H, D, P, MP, offset, \
      scale)
  if (rows <= 1) PT_RPA_LAUNCH(1);
  else if (rows <= 2) PT_RPA_LAUNCH(2);
  else if (rows <= 4) PT_RPA_LAUNCH(4);
  else if (rows <= 8) PT_RPA_LAUNCH(8);
  else if (rows <= 16) PT_RPA_LAUNCH(16);
  else PT_RPA_LAUNCH(32);
#undef PT_RPA_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers
// to contiguous tensors: q/out [T, H, D], pools [N, P, H, D], page_tables
// [S, MP] int32, slot_ids/kv_lens [T] int32. q_bf16 / kv_bf16 select
// bfloat16 (1) or float32 (0). Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch (0 = success).
extern "C" int pt_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_tables, const void* slot_ids, const void* kv_lens,
    void* out, int T, int H, int D, int P, int MP, int offset, float scale,
    int q_bf16, int kv_bf16, void* stream) {
  if (T <= 0 || H <= 0 || P <= 0 || MP <= 0 || D <= 0 || D % 8 != 0 ||
      D > 256)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_tables);
  const int* sid = static_cast<const int*>(slot_ids);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, pt, sid, lens, out, T, H, D, P, MP, offset,
        scale, s);
  else if (q_bf16)
    err = launch_typed<__nv_bfloat16, float>(q, k_pool, v_pool, pt, sid,
                                             lens, out, T, H, D, P, MP,
                                             offset, scale, s);
  else if (kv_bf16)
    err = launch_typed<float, __nv_bfloat16>(q, k_pool, v_pool, pt, sid,
                                             lens, out, T, H, D, P, MP,
                                             offset, scale, s);
  else
    err = launch_typed<float, float>(q, k_pool, v_pool, pt, sid, lens, out,
                                     T, H, D, P, MP, offset, scale, s);
  return (int)err;
}
