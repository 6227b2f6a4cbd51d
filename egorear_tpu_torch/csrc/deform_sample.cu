// Per-head deformable sampling (the mmcv MSDA contract), forward, for Hopper
// (sm_90a).
//
// Replaces egorear_tpu/ops/deform_attn.py::_make_deform_kernel, the Pallas
// kernel that, per (batch * head), builds the dense bilinear sampling
// operator S (Q, H*W) from iota compares and emits S @ value as one MXU
// matmul. Here nothing like S is formed: one kernel gathers the four bilinear
// corners of every sampling point straight from the value map, reading each
// head's channel slice in place (no transpose of value to head-major).
//
// Contract (deformable_sampling in the JAX package):
//   value  (B, H, W, nh, ch) fp32 or bf16, contiguous; head h of cell i is
//          the ch-long slice at i * nh * ch + h * ch
//   loc    (B, Q, nh, P, 2) fp32 in [0, 1] (x, y); pixel x = loc_x * W - 0.5
//   attn_w (B, Q, nh, P)  fp32
//   out    (B, Q, nh * ch) in value's dtype: for each head the sum over points
//          and in-range corners of attn_w * bilinear weight * value slice.
//   Accumulation is fp32 and the corner weights stay fp32. (The Pallas kernel
//   rounds S to value's dtype before its dot; for bf16 that is a rounding of
//   each weight which this kernel does not make.) Corners outside the grid
//   contribute exactly zero. No atomics: two runs on the same inputs give
//   bitwise equal outputs.
//
// What bounds it on the H100: bytes. Each (b, q, head) row reads up to
// 4 * P corner slices of ch channels (128 bytes for the flagship's bf16
// ch = 64) and does 2 flops per channel read, far below the ~20 flop/byte
// the card needs before compute matters. At the flagship's batch 16 the
// whole call gathers a few MB, so besides the bytes it pays for each
// dependent round trip to memory a row takes and needs many loads in
// flight. The design (that of lazy_deform_sample.cu, applied to one head's
// slice):
//   * one warp per (b, q, head) row, nothing shared between warps and no
//     block barrier. A block is `rows_per_block` consecutive rows (the
//     caller's choice, with the shared memory it sizes), so the heads of one
//     (b, q) and the queries of one b run side by side;
//   * pass 1 (the whole warp): the row's points are loaded 32 at a time, one
//     a lane, and handed by shuffles to the lanes of their corners, so a row
//     of up to 32 points waits for one load; each lane computes one corner's
//     cell and guarded weight with the arithmetic of _make_deform_kernel, and
//     a ballot compacts the row's in-grid corners, in corner order, into a
//     dense list in the warp's shared memory. Corners outside the grid (61 %
//     with uniform locations) cost nothing after it;
//   * pass 2: a head slice is read in `lanes` vectors of VEC channels (16
//     bytes: 8 bf16 or 4 fp32; 8 bytes, 4 bf16, where ch is 4 mod 8; one
//     channel where ch or value's base allows no vector), and the warp's
//     32 / lanes lane groups split the list, each taking every k-th corner
//     and issuing kUnroll gathers before it consumes any. The groups'
//     partial sums meet through a fixed shuffle tree, so the result does not
//     depend on timing;
//   * at batch 16 (3,840 or 4,096 rows) every warp is resident at once: at
//     most 64 registers a thread (the launch bounds; 56 on the 16-byte paths)
//     let an SM hold 9 blocks of 4 rows, 1,188 on the card, so there is one
//     wave and no tail.
// What sets its pace on the card (PERF.md §6): under CUDA-event timing an
// empty launch already takes ~0.005 ms, and the same call with every point
// off the grid (launch, corner lists, store) ~0.007 ms; beyond that the
// MVFex bf16 call's gathers take about its byte bound. 8 gathers ahead
// instead of 4, a load of the points per corner instead of per point, and 1
// or 2 rows a block instead of 4 were no faster in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;         // gathers a lane issues before using them
constexpr int kMaxThreads = 128;   // largest block the caller may ask for
constexpr int kMinBlocks = 8;      // so at most 64 registers a thread
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int VEC>
struct Raw;  // what one lane loads for VEC channels
template <>
struct Raw<float, 4> {
  using type = float4;
};
template <>
struct Raw<float, 1> {
  using type = float;
};
template <>
struct Raw<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};
template <>
struct Raw<__nv_bfloat16, 1> {
  using type = unsigned short;
};

template <typename R>
__device__ __forceinline__ R load_raw(const void* p) {
  return __ldg(reinterpret_cast<const R*>(p));
}

__device__ __forceinline__ void zero(float4& r) { r = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& r) { r = 0.f; }
__device__ __forceinline__ void zero(uint4& r) { r = make_uint4(0u, 0u, 0u, 0u); }
__device__ __forceinline__ void zero(uint2& r) { r = make_uint2(0u, 0u); }
__device__ __forceinline__ void zero(unsigned short& r) { r = 0; }

__device__ __forceinline__ float2 bf2(unsigned int u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ void unpack(const float4& r, float (&v)[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

__device__ __forceinline__ void unpack(const float& r, float (&v)[1]) { v[0] = r; }

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const float2 a = bf2(r.x), b = bf2(r.y), c = bf2(r.z), d = bf2(r.w);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
}

__device__ __forceinline__ void unpack(const uint2& r, float (&v)[4]) {
  const float2 a = bf2(r.x), b = bf2(r.y);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void unpack(const unsigned short& r, float (&v)[1]) {
  v[0] = __bfloat162float(__ushort_as_bfloat16(r));
}

__device__ __forceinline__ unsigned int pack_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) { *p = v[0]; }

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]),
                                            pack_bf2(v[4], v[5]), pack_bf2(v[6], v[7]));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
deform_sample_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                     const float* __restrict__ attn_w, T* __restrict__ out,
                     int B, int H, int W, int Q, int nh, int ch, int P,
                     int lanes) {
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
  const int h = row % nh;
  const int b = row / (Q * nh);

  // Pass 1: corner k = 4 p + c of the row, c = 2 dy + dx, one per lane. The
  // points are loaded 32 at a time, one a lane, and handed to the 4 lanes of
  // their corners by shuffles, so a row waits for one load for P <= 32. The
  // arithmetic is that of _make_deform_kernel: x = loc_x * W - 0.5,
  // x0 = floor(x), weight (1 - lx | lx) * (1 - ly | ly) * attn_w.
  const float2* loc_r = reinterpret_cast<const float2*>(loc) + static_cast<size_t>(row) * P;
  const float* w_r = attn_w + static_cast<size_t>(row) * P;
  int n = 0;
  for (int p0 = 0; p0 < P; p0 += 32) {
    float2 l = make_float2(0.0f, 0.0f);
    float a = 0.0f;
    if (p0 + lane < P) {
      l = __ldg(loc_r + p0 + lane);
      a = __ldg(w_r + p0 + lane);
    }
    for (int base = 4 * p0; base < min(K, 4 * p0 + 128); base += 32) {
      const int k = base + lane;
      const int src = (k >> 2) - p0;  // the lane that holds corner k's point
      const float lx_in = __shfl_sync(kFull, l.x, src);
      const float ly_in = __shfl_sync(kFull, l.y, src);
      const float a_k = __shfl_sync(kFull, a, src);
      const int dx = k & 1;
      const int dy = (k >> 1) & 1;
      const float x = __fsub_rn(__fmul_rn(lx_in, static_cast<float>(W)), 0.5f);
      const float y = __fsub_rn(__fmul_rn(ly_in, static_cast<float>(H)), 0.5f);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float lx = x - x0f;
      const float ly = y - y0f;
      const int xc = static_cast<int>(x0f) + dx;
      const int yc = static_cast<int>(y0f) + dy;
      const bool ok = k < K && xc >= 0 && xc < W && yc >= 0 && yc < H;
      const float wt = __fmul_rn(__fmul_rn(dx ? lx : 1.0f - lx, dy ? ly : 1.0f - ly), a_k);
      const unsigned in_grid = __ballot_sync(kFull, ok);
      if (ok) list[n + __popc(in_grid & ((1u << lane) - 1u))] = make_int2(yc * W + xc, __float_as_int(wt));
      n += __popc(in_grid);
    }
  }
  __syncwarp();

  // Pass 2: lane (split, u) sums corners split, split + groups, ... of the
  // slice's vector v0 + u.
  const int groups = 32 / lanes;
  const int u = lane % lanes;
  const int split = lane / lanes;
  const int vpr = ch / VEC;  // vectors a head slice (VEC divides ch)
  const size_t stride = static_cast<size_t>(nh) * ch;  // elements a grid cell
  const T* value_h = value + static_cast<size_t>(b) * H * W * stride +
                     static_cast<size_t>(h) * ch;
  T* out_r = out + static_cast<size_t>(row) * ch;
  for (int v0 = 0; v0 < vpr; v0 += lanes) {
    const int v = v0 + u;
    const bool active = v < vpr;
    const T* src = value_h + static_cast<size_t>(v) * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int k0 = split; k0 < n; k0 += groups * kUnroll) {
      R raw[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {  // issue the gathers together
        const int k = k0 + j * groups;
        if (active && k < n) {
          raw[j] = load_raw<R>(src + static_cast<size_t>(list[k].x) * stride);
        } else {
          zero(raw[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {  // weights read as they are used
        const int k = k0 + j * groups;
        const float wk = active && k < n ? __int_as_float(list[k].y) : 0.0f;
        float val[VEC];
        unpack(raw[j], val);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wk, val[e], acc[e]);
      }
    }
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], o);
    }
    if (active && split == 0) store_vec(out_r + static_cast<size_t>(v) * VEC, acc);
  }
}

template <typename T, int VEC>
int launch(const void* value, const void* loc, const void* attn_w, void* out,
           int B, int H, int W, int Q, int nh, int ch, int P,
           int rows_per_block, int smem_bytes, cudaStream_t stream) {
  auto kernel = deform_sample_kernel<T, VEC>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // Lanes a slice: the vectors of a slice rounded up to a power of two, at
  // most a warp (wider slices take several passes of 32 vectors).
  int lanes = 1;
  while (lanes < ch / VEC && lanes < 32) lanes *= 2;
  const int rows = B * Q * nh;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  kernel<<<blocks, 32 * rows_per_block, smem_bytes, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn_w), static_cast<T*>(out), B, H, W, Q, nh,
      ch, P, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// vec: channels a load, chosen by the caller so that every head slice starts
// on a load boundary: 4 (fp32) or 8 (bf16) for 16-byte loads, 4 (bf16) for
// 8-byte loads, or 1. rows_per_block: warps a block, 1 to 4. smem_bytes: the
// block's dynamic shared memory, sized by the caller (one list of 4 * P
// records a warp; it refuses what a block cannot hold). Returns the CUDA error code of
// the launch (0 on success). The caller validates shapes, dtypes, contiguity
// and alignment (loc 8-byte aligned) beforehand.
extern "C" int egorear_deform_sample(const void* value, const void* loc,
                                     const void* attn_w, void* out, int B,
                                     int H, int W, int Q, int nh, int ch, int P,
                                     int vec, int dtype, int rows_per_block,
                                     int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_block < 1 || 32 * rows_per_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(value, loc, attn_w, out, B, H, W, Q, nh, ch, P,
                            rows_per_block, smem_bytes, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(value, loc, attn_w, out, B, H, W, Q, nh, ch, P,
                            rows_per_block, smem_bytes, s);
  using bf16 = __nv_bfloat16;
  if (dtype == 1 && vec == 8)
    return launch<bf16, 8>(value, loc, attn_w, out, B, H, W, Q, nh, ch, P,
                           rows_per_block, smem_bytes, s);
  if (dtype == 1 && vec == 4)
    return launch<bf16, 4>(value, loc, attn_w, out, B, H, W, Q, nh, ch, P,
                           rows_per_block, smem_bytes, s);
  if (dtype == 1 && vec == 1)
    return launch<bf16, 1>(value, loc, attn_w, out, B, H, W, Q, nh, ch, P,
                           rows_per_block, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
