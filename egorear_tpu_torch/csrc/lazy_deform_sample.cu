// Lazy deformable sampling, forward, for Hopper (sm_90a).
//
// Replaces egorear_tpu/ops/deform_attn.py::_make_s_builder_kernel (the Pallas
// kernel that builds the packed bilinear sampling operator S on the TPU's MXU)
// TOGETHER WITH the XLA einsums of _lazy_sample_pallas_fwd that contract S with
// the features and the position table. Here nothing like S is ever formed: one
// kernel gathers the four bilinear corners of every sampling point straight
// from the feature rows and accumulates them.
//
// Contract (the same as lazy_deform_sample in the JAX package):
//   feat   (B, H*W, Cin)  fp32 or bf16, channels contiguous
//   pos    (G, H*W, C)    same dtype as feat, or absent (C == 0); batch element
//                         b reads table g = b / (B/G) (block, view-major fold)
//                         or g = b % G (interleaved, batch-major fold)
//   loc    (B, Q, nh, P, 2) fp32 in [0, 1] (x, y); pixel x = loc_x * W - 0.5
//   attn_w (B, Q, nh, P)  fp32
//   s_feat (B, Q, nh, Cin), s_pos (B, Q, nh, C), s_one (B, Q, nh, 1) in feat's
//   dtype: sum over points and in-range corners of attn_w * bilinear weight *
//   row; s_one is the same sum over a ones channel (border-clipped mass).
//   Accumulation is fp32, with one rounding of each output to feat's dtype.
//   Corners outside the grid contribute exactly zero. No atomics: two runs on
//   the same inputs give bitwise equal outputs.
//
// What bounds it on the H100: bytes, and before the bytes the latency of
// gathers. Each (b, q, head) row reads up to 4 * P corner rows of Cin (+ C)
// channels and does 2 flops per channel read, far below the ~20 flop/byte the
// card needs before compute matters. The gathered rows (~74 MB for the MVFex
// bf16 call at batch 16 with uniform locations) are 2.3x the distinct bytes
// and come mostly from L2, so the kernel has to keep many independent loads
// in flight on every SM. The design:
//   * one warp per (b, q, head) row, and nothing shared between warps: no
//     block barrier. A block is `rows_per_block` consecutive rows (the
//     caller's choice, with the shared memory it sizes), so the rows of one
//     (b, q), and the blocks of one b, run side by side: a batch element's
//     feature rows stay in L2 while its queries read them;
//   * pass 1 (the whole warp, 32 corners at a time): each lane computes one
//     corner's cell and guarded weight; a ballot compacts the row's in-grid
//     corners, in corner order, into a dense list in the warp's shared memory
//     with a count, and a shuffle tree sums their weights into s_one. Corners
//     outside the grid cost nothing after this pass;
//   * pass 2: the row's output vectors (VEC channels: 8 bf16 or 4 fp32, 16
//     bytes; 4 bf16, 8 bytes, where a row width is 4 mod 8) run across
//     kLanes lanes, and the list is split over kSplit lane groups, each
//     taking every kSplit-th corner; a lane issues kUnroll gathers before it
//     consumes any, with the corner records read from shared memory as
//     broadcasts. The kSplit partial sums meet through a fixed shuffle tree,
//     so the result does not depend on timing;
//   * at the flagship's batch 16 (3,840 or 4,096 rows) every warp is resident
//     at once: 64 registers a thread (the launch bounds) let an SM hold 32 of
//     them, 4,224 on the card, so there is one wave and no tail of blocks
//     waiting for a second one.
// What sets its pace on the card (PERF.md §6): the rate at which the gathered
// rows arrive from L2. Gathering 2 or 8 corners ahead instead of 4, 4 lane
// groups instead of 2, or 1 or 2 rows a block instead of 4 was no faster;
// loads that bypass L1 were slower. Reading a cell that several heads of one
// (b, q) hit only once, and staging rows with cp.async, are left out: the L1
// cache already serves a block's repeats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 2;               // lane groups splitting a corner list
constexpr int kLanes = 32 / kSplit;     // output vectors a warp works on at once
constexpr int kUnroll = 4;              // gathers a lane issues before using them
constexpr int kMaxThreads = 128;        // largest block the caller may ask for
constexpr int kMinBlocks = 8;           // so at most 64 registers a thread
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int VEC>
struct Raw;  // what one lane loads for VEC channels
template <>
struct Raw<float, 4> {
  using type = float4;
};
template <>
struct Raw<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};

template <typename R>
__device__ __forceinline__ R load_raw(const void* p) {
  return __ldg(reinterpret_cast<const R*>(p));
}

__device__ __forceinline__ void zero(float4& r) { r = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(uint4& r) { r = make_uint4(0u, 0u, 0u, 0u); }
__device__ __forceinline__ void zero(uint2& r) { r = make_uint2(0u, 0u); }

__device__ __forceinline__ float2 bf2(unsigned int u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ void unpack(const float4& r, float (&v)[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

__device__ __forceinline__ void unpack(const uint2& r, float (&v)[4]) {
  const float2 a = bf2(r.x), b = bf2(r.y);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const float2 a = bf2(r.x), b = bf2(r.y), c = bf2(r.z), d = bf2(r.w);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
}

__device__ __forceinline__ unsigned int pack_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]),
                                            pack_bf2(v[4], v[5]), pack_bf2(v[6], v[7]));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
lazy_deform_sample_kernel(const T* __restrict__ feat, const T* __restrict__ pos,
                          const float* __restrict__ loc,
                          const float* __restrict__ attn_w,
                          T* __restrict__ s_feat, T* __restrict__ s_pos,
                          T* __restrict__ s_one, int B, int H, int W, int Cin,
                          int C, int G, int pos_block, int Q, int nh, int P) {
  // Each warp's list: up to 4 * P records (cell, weight bits), 8 bytes each.
  extern __shared__ int2 corner_list[];
  using R = typename Raw<T, VEC>::type;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = B * Q * nh;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;  // (b * Q + q) * nh + h
  if (row >= rows) return;  // a whole warp: no barrier below spans warps
  const int K = 4 * P;  // corners of the row
  int2* list = corner_list + static_cast<size_t>(warp) * K;
  const int b = row / (Q * nh);

  // Pass 1: corner k = 4 p + c of the row, c = 2 dy + dx, one per lane. The
  // arithmetic is that of _build_s_operator: x = loc_x * W - 0.5,
  // x0 = floor(x), weights (1 - lx | lx) * (1 - ly | ly) * attn_w.
  const float2* loc_r = reinterpret_cast<const float2*>(loc) + static_cast<size_t>(row) * P;
  const float* w_r = attn_w + static_cast<size_t>(row) * P;
  int n = 0;
  float mass = 0.0f;
  for (int base = 0; base < K; base += 32) {
    const int k = base + lane;
    bool ok = false;
    int cell = 0;
    float wt = 0.0f;
    if (k < K) {
      const int p = k >> 2;
      const int dx = k & 1;
      const int dy = (k >> 1) & 1;
      const float2 l = __ldg(loc_r + p);
      const float a = __ldg(w_r + p);
      const float x = __fsub_rn(__fmul_rn(l.x, static_cast<float>(W)), 0.5f);
      const float y = __fsub_rn(__fmul_rn(l.y, static_cast<float>(H)), 0.5f);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float lx = x - x0f;
      const float ly = y - y0f;
      const int xc = static_cast<int>(x0f) + dx;
      const int yc = static_cast<int>(y0f) + dy;
      ok = xc >= 0 && xc < W && yc >= 0 && yc < H;
      const float wy = (dy ? ly : 1.0f - ly) * a;
      wt = wy * (dx ? lx : 1.0f - lx);
      cell = yc * W + xc;
    }
    const unsigned in_grid = __ballot_sync(kFull, ok);
    if (ok) {
      list[n + __popc(in_grid & ((1u << lane) - 1u))] = make_int2(cell, __float_as_int(wt));
      mass += wt;
    }
    n += __popc(in_grid);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mass += __shfl_xor_sync(kFull, mass, o);
  if (lane == 0) store1(s_one + row, mass);
  __syncwarp();

  // Pass 2: lane (split, u) sums corners split, split + kSplit, ... of output
  // vector v0 + u; vectors [0, vf) are s_feat's, the rest s_pos's.
  const int u = lane % kLanes;
  const int split = lane / kLanes;
  const int vf = Cin / VEC;
  const int vrow = vf + C / VEC;
  const size_t HW = static_cast<size_t>(H) * W;
  const int g = pos_block ? b / (B / G) : b % G;
  const T* feat_b = feat + static_cast<size_t>(b) * HW * Cin;
  for (int v0 = 0; v0 < vrow; v0 += kLanes) {
    const int v = v0 + u;
    const bool active = v < vrow;
    const T* src = feat_b + static_cast<size_t>(v) * VEC;
    int stride = Cin;
    T* dst = s_feat + static_cast<size_t>(row) * Cin + static_cast<size_t>(v) * VEC;
    if (active && v >= vf) {
      const int vp = v - vf;
      src = pos + static_cast<size_t>(g) * HW * C + static_cast<size_t>(vp) * VEC;
      stride = C;
      dst = s_pos + static_cast<size_t>(row) * C + static_cast<size_t>(vp) * VEC;
    }
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int k0 = split; k0 < n; k0 += kSplit * kUnroll) {
      R raw[kUnroll];
      float wk[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {  // issue the gathers together
        const int k = k0 + j * kSplit;
        if (active && k < n) {
          const int2 rec = list[k];
          wk[j] = __int_as_float(rec.y);
          raw[j] = load_raw<R>(src + static_cast<size_t>(rec.x) * stride);
        } else {
          wk[j] = 0.0f;
          zero(raw[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        float val[VEC];
        unpack(raw[j], val);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wk[j], val[e], acc[e]);
      }
    }
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], o);
    }
    if (active && split == 0) store_vec(dst, acc);
  }
}

template <typename T, int VEC>
int launch(const void* feat, const void* pos, const void* loc,
           const void* attn_w, void* s_feat, void* s_pos, void* s_one, int B,
           int H, int W, int Cin, int C, int G, int pos_block, int Q, int nh,
           int P, int rows_per_block, int smem_bytes, cudaStream_t stream) {
  auto kernel = lazy_deform_sample_kernel<T, VEC>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows = B * Q * nh;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  kernel<<<blocks, 32 * rows_per_block, smem_bytes, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(pos),
      static_cast<const float*>(loc), static_cast<const float*>(attn_w),
      static_cast<T*>(s_feat), static_cast<T*>(s_pos), static_cast<T*>(s_one),
      B, H, W, Cin, C, G, pos_block, Q, nh, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// A lane loads 16 bytes of a row (4 fp32 or 8 bf16 channels), or 8 bytes (4
// bf16) where Cin or C is 4 mod 8, so that every load stays aligned.
// rows_per_block: warps a block, 1 to 4. smem_bytes: the block's dynamic
// shared memory, rows_per_block * 4 * P * 8 (the caller sizes it, and refuses
// what a block cannot hold). Returns the CUDA error code of the launch (0 on
// success). The caller validates shapes, dtypes, contiguity and alignment
// (feat, pos: channels in multiples of 4 and 16-byte bases; loc 8-byte
// aligned) beforehand.
extern "C" int egorear_lazy_deform_sample(
    const void* feat, const void* pos, const void* loc, const void* attn_w,
    void* s_feat, void* s_pos, void* s_one, int B, int H, int W, int Cin, int C,
    int G, int pos_block, int Q, int nh, int P, int dtype, int rows_per_block,
    int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_block < 1 || 32 * rows_per_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float, 4>(feat, pos, loc, attn_w, s_feat, s_pos, s_one, B, H,
                            W, Cin, C, G, pos_block, Q, nh, P, rows_per_block,
                            smem_bytes, s);
  if (dtype == 1 && Cin % 8 == 0 && C % 8 == 0)
    return launch<__nv_bfloat16, 8>(feat, pos, loc, attn_w, s_feat, s_pos, s_one,
                                    B, H, W, Cin, C, G, pos_block, Q, nh, P,
                                    rows_per_block, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 4>(feat, pos, loc, attn_w, s_feat, s_pos, s_one,
                                    B, H, W, Cin, C, G, pos_block, Q, nh, P,
                                    rows_per_block, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
