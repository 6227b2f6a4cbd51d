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
//   contribute exactly zero.
//
// What bounds it on the H100: gathered bytes. Each (b, q, head) reads up to
// 4 * P corner slices of ch channels and does 2 flops per channel read, far
// below the ~20 flop/byte the card needs before compute matters. The design:
//   * one block per (b, q) serves all nh heads; a first pass computes each
//     point's 4 corner indices and guarded weights once into shared memory
//     (an out-of-range corner gets index -1 and is never read);
//   * output vectors of VEC channels (4 where alignment allows, else 1) run
//     across `lanes` threads, so a warp reads a corner's head slice as one
//     contiguous stretch (ch = 64 bf16: 128 B) and all lanes reading one head
//     take the corner index from shared memory as a broadcast;
//   * the P points of each output vector are split over kSplit threads whose
//     partial sums meet in shared memory: at the flagship shapes nh * ch / 4
//     is only 64 (MVFex) or 32 (pose3d) vectors a query, and one thread per
//     vector would leave each thread a chain of 64 dependent gathers and the
//     card too few loads in flight. Blocks are 128 or 256 threads.
// Making it faster (several queries per block to share corners, wgmma or TMA
// for the gathers) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 4;      // point slices per output vector
constexpr int kMaxLanes = 64;  // output vectors a block works on at once

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) { *p = v[0]; }

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kSplit * kMaxLanes)
deform_sample_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                     const float* __restrict__ attn_w, T* __restrict__ out,
                     int H, int W, int Q, int nh, int ch, int P) {
  extern __shared__ float4 smem4[];
  const int NP = nh * P;  // points of this (b, q), all heads
  int* s_idx = reinterpret_cast<int*>(smem4);               // (NP, 4) corners
  float* s_w = reinterpret_cast<float*>(s_idx + 4 * NP);    // (NP, 4) weights
  float* s_part = s_w + 4 * NP;                             // (kSplit, lanes, VEC)

  const int bq = blockIdx.x;  // b * Q + q
  const int b = bq / Q;

  // Pass 1: corner indices and guarded weights, one thread per (head, point).
  // The arithmetic is that of _make_deform_kernel: x = loc_x * W - 0.5,
  // x0 = floor(x), weights (1 - lx | lx) * (1 - ly | ly) * attn_w.
  for (int t = threadIdx.x; t < NP; t += blockDim.x) {
    const size_t pt = static_cast<size_t>(bq) * NP + t;
    const float x = __fsub_rn(__fmul_rn(loc[2 * pt], static_cast<float>(W)), 0.5f);
    const float y = __fsub_rn(__fmul_rn(loc[2 * pt + 1], static_cast<float>(H)), 0.5f);
    const float a = attn_w[pt];
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float lx = x - x0f;
    const float ly = y - y0f;
    const int x0 = static_cast<int>(x0f);
    const int y0 = static_cast<int>(y0f);
    const bool in_x0 = x0 >= 0 && x0 < W;
    const bool in_x1 = x0 + 1 >= 0 && x0 + 1 < W;
    const bool in_y0 = y0 >= 0 && y0 < H;
    const bool in_y1 = y0 + 1 >= 0 && y0 + 1 < H;
    const float wy0 = (1.0f - ly) * a;
    const float wy1 = ly * a;
    const bool ok[4] = {in_y0 && in_x0, in_y0 && in_x1, in_y1 && in_x0,
                        in_y1 && in_x1};
    const int idx[4] = {y0 * W + x0, y0 * W + x0 + 1, (y0 + 1) * W + x0,
                        (y0 + 1) * W + x0 + 1};
    const float wt[4] = {wy0 * (1.0f - lx), wy0 * lx, wy1 * (1.0f - lx), wy1 * lx};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_idx[4 * t + c] = ok[c] ? idx[c] : -1;
      s_w[4 * t + c] = ok[c] ? wt[c] : 0.0f;
    }
  }
  __syncthreads();

  // Pass 2: thread (split, lane) sums points split, split + kSplit, ... of
  // output vector `item`; the kSplit partials meet in shared memory.
  const int vpr = ch / VEC;  // vectors per head slice (VEC divides ch)
  const int items = nh * vpr;
  const int lanes = blockDim.x / kSplit;
  const int lane = threadIdx.x % lanes;
  const int split = threadIdx.x / lanes;
  const size_t row = static_cast<size_t>(nh) * ch;  // elements per grid cell
  const T* value_b = value + static_cast<size_t>(b) * H * W * row;
  T* out_q = out + static_cast<size_t>(bq) * row;
  for (int base = 0; base < items; base += lanes) {
    const int item = base + lane;
    const int h = item / vpr;
    const int off = h * ch + (item - h * vpr) * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    if (item < items) {
      const T* src = value_b + off;
      const int* idx = s_idx + 4 * h * P;
      const float* w = s_w + 4 * h * P;
      for (int p = split; p < P; p += kSplit) {
        float val[4][VEC];
#pragma unroll
        for (int c = 0; c < 4; ++c) {  // issue the corner loads together
          const int i = idx[4 * p + c];
          if (i >= 0) {
            load_vec(src + static_cast<size_t>(i) * row, val[c]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) val[c][e] = 0.0f;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wk = w[4 * p + c];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wk, val[c][e], acc[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_part[(split * lanes + lane) * VEC + e] = acc[e];
    __syncthreads();
    if (split == 0 && item < items) {
      float sum[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum[e] = s_part[lane * VEC + e];
      for (int s = 1; s < kSplit; ++s) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) sum[e] += s_part[(s * lanes + lane) * VEC + e];
      }
      store_vec(out_q + off, sum);
    }
    __syncthreads();
  }
}

template <typename T, int VEC>
int launch(const void* value, const void* loc, const void* attn_w, void* out,
           int B, int H, int W, int Q, int nh, int ch, int P,
           cudaStream_t stream) {
  const int items = nh * (ch / VEC);
  int lanes = 32;
  while (lanes < items && lanes < kMaxLanes) lanes *= 2;
  const int threads = kSplit * lanes;
  const size_t smem = static_cast<size_t>(nh) * P * 4 * (sizeof(int) + sizeof(float)) +
                      sizeof(float) * kSplit * lanes * VEC;
  deform_sample_kernel<T, VEC><<<B * Q, threads, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn_w), static_cast<T*>(out), H, W, Q, nh, ch, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(int vec, const void* value, const void* loc, const void* attn_w,
               void* out, int B, int H, int W, int Q, int nh, int ch, int P,
               cudaStream_t stream) {
  if (vec == 4)
    return launch<T, 4>(value, loc, attn_w, out, B, H, W, Q, nh, ch, P, stream);
  if (vec == 1)
    return launch<T, 1>(value, loc, attn_w, out, B, H, W, Q, nh, ch, P, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// vec: channels a load, 4 (ch % 4 == 0 and value's base aligned to 4
// elements) or 1. Returns the cudaGetLastError() code of the launch (0 on
// success). The caller validates shapes, dtypes, contiguity and alignment.
extern "C" int egorear_deform_sample(const void* value, const void* loc,
                                     const void* attn_w, void* out, int B,
                                     int H, int W, int Q, int nh, int ch, int P,
                                     int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec<float>(vec, value, loc, attn_w, out, B, H, W, Q, nh, ch, P, s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(vec, value, loc, attn_w, out, B, H, W, Q, nh,
                                     ch, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
