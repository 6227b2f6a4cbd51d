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
//   Accumulation is fp32. Corners outside the grid contribute exactly zero.
//
// What bounds it on the H100: gathered bytes. Each (b, q, head) row reads up
// to 4 * P corner rows of Cin (+ C) channels and does 2 flops per channel
// read, far below the ~20 flop/byte the card needs before compute matters.
// The design keeps every byte it reads useful:
//   * one block per (b, q) serves all nh heads; a first pass computes each
//     point's 4 corner indices and guarded weights once into shared memory
//     (an out-of-range corner gets index -1 and is never read);
//   * channels run across threads, 4 per thread, so a warp reads one corner
//     row as a single contiguous 256 B (bf16, 128 channels) or 512 B (fp32)
//     stretch, and all lanes of a warp read the same corner index from shared
//     memory as a broadcast;
//   * the position table is indexed by its group, never broadcast over the
//     batch, so the small (G, HW, C) table stays resident in L2.
// Making it faster (several rows per block to reuse corners across heads,
// asynchronous copies to keep more loads in flight) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lazy_deform_sample_kernel(const T* __restrict__ feat, const T* __restrict__ pos,
                          const float* __restrict__ loc,
                          const float* __restrict__ attn_w,
                          T* __restrict__ s_feat, T* __restrict__ s_pos,
                          T* __restrict__ s_one, int B, int H, int W, int Cin,
                          int C, int G, int pos_block, int Q, int nh, int P) {
  extern __shared__ unsigned char smem_raw[];
  const int NP = nh * P;  // points of this (b, q), all heads
  const int K = 4 * P;    // corners per head
  int* s_idx = reinterpret_cast<int*>(smem_raw);
  float* s_w = reinterpret_cast<float*>(s_idx + 4 * NP);

  const int bq = blockIdx.x;  // b * Q + q
  const int b = bq / Q;
  const int HW = H * W;

  // Pass 1: corner indices and guarded weights, one thread per (head, point).
  // The arithmetic is that of _build_s_operator: x = loc_x * W - 0.5,
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
    const float cx0 = 1.0f - lx;
    const float cx1 = lx;
    const int h = t / P;
    const int p = t - h * P;
    const int base = h * K + 4 * p;
    const bool ok[4] = {in_y0 && in_x0, in_y0 && in_x1, in_y1 && in_x0,
                        in_y1 && in_x1};
    const int idx[4] = {y0 * W + x0, y0 * W + x0 + 1, (y0 + 1) * W + x0,
                        (y0 + 1) * W + x0 + 1};
    const float wt[4] = {wy0 * cx0, wy0 * cx1, wy1 * cx0, wy1 * cx1};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_idx[base + c] = ok[c] ? idx[c] : -1;
      s_w[base + c] = ok[c] ? wt[c] : 0.0f;
    }
  }
  __syncthreads();

  // s_one: the border-clipped bilinear mass of each head's points.
  for (int h = threadIdx.x; h < nh; h += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc += s_w[h * K + k];
    store1(s_one + static_cast<size_t>(bq) * nh + h, acc);
  }

  // Pass 2: channels across threads, 4 per thread. Items of one warp share
  // a head and read one contiguous stretch of each corner row.
  const int vf = Cin / 4;
  const int vrow = vf + C / 4;
  const int g = pos_block ? b / (B / G) : b % G;
  const T* feat_b = feat + static_cast<size_t>(b) * HW * Cin;
  const T* pos_g = C > 0 ? pos + static_cast<size_t>(g) * HW * C : nullptr;
  for (int item = threadIdx.x; item < nh * vrow; item += blockDim.x) {
    const int h = item / vrow;
    const int v = item - h * vrow;
    const size_t row = static_cast<size_t>(bq) * nh + h;
    const T* src;
    T* dst;
    int stride;
    if (v < vf) {
      src = feat_b + 4 * v;
      stride = Cin;
      dst = s_feat + row * Cin + 4 * v;
    } else {
      src = pos_g + 4 * (v - vf);
      stride = C;
      dst = s_pos + row * C + 4 * (v - vf);
    }
    const int* idx = s_idx + h * K;
    const float* w = s_w + h * K;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int i = idx[k];
      if (i >= 0) {
        const float4 val = load4(src + static_cast<size_t>(i) * stride);
        const float wk = w[k];
        acc.x = fmaf(wk, val.x, acc.x);
        acc.y = fmaf(wk, val.y, acc.y);
        acc.z = fmaf(wk, val.z, acc.z);
        acc.w = fmaf(wk, val.w, acc.w);
      }
    }
    store4(dst, acc);
  }
}

template <typename T>
int launch(const void* feat, const void* pos, const void* loc,
           const void* attn_w, void* s_feat, void* s_pos, void* s_one, int B,
           int H, int W, int Cin, int C, int G, int pos_block, int Q, int nh,
           int P, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nh) * P * 4 * (sizeof(int) + sizeof(float));
  lazy_deform_sample_kernel<T><<<B * Q, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(pos),
      static_cast<const float*>(loc), static_cast<const float*>(attn_w),
      static_cast<T*>(s_feat), static_cast<T*>(s_pos), static_cast<T*>(s_one),
      B, H, W, Cin, C, G, pos_block, Q, nh, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaGetLastError() code of the launch (0 on success). The
// caller validates shapes, dtypes, contiguity and alignment beforehand.
extern "C" int egorear_lazy_deform_sample(
    const void* feat, const void* pos, const void* loc, const void* attn_w,
    void* s_feat, void* s_pos, void* s_one, int B, int H, int W, int Cin, int C,
    int G, int pos_block, int Q, int nh, int P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(feat, pos, loc, attn_w, s_feat, s_pos, s_one, B, H, W,
                         Cin, C, G, pos_block, Q, nh, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, pos, loc, attn_w, s_feat, s_pos, s_one,
                                 B, H, W, Cin, C, G, pos_block, Q, nh, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
