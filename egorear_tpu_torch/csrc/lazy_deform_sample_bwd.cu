// Lazy deformable sampling, backward, for Hopper (sm_90a).
//
// Replaces the backward role of egorear_tpu/ops/deform_attn.py::
// _make_s_builder_kernel: _lazy_bwd_rule builds the packed bilinear sampling
// operator S again with that Pallas kernel and contracts it transposed with
// the upstream gradients (d_feat, d_pos), then forms the adjoint field
// A = feat . g_feat + pos . g_pos + g_one over the whole grid and reads it at
// the corners through one-hot matmuls (d_loc, d_attn_w). Here nothing like S
// or the dense A is formed: one kernel visits each sampling point's 4
// bilinear corners, computes A only there, and scatters the transposed
// contraction with atomics.
//
// Contract (the VJP of lazy_deform_sample.cu; the same as _lazy_bwd_rule):
//   feat (B, H*W, Cin), pos (G, H*W, C) or absent (C == 0), T = fp32 | bf16;
//   loc (B, Q, nh, P, 2) fp32, attn_w (B, Q, nh, P) fp32;
//   g_feat (B, Q, nh, Cin), g_pos (B, Q, nh, C), g_one (B, Q, nh, 1) in T.
//   Outputs, all fp32:
//     d_feat (B, H*W, Cin)  += attn_w * w_c * g_feat   (nullptr: not wanted)
//     d_pos  (G, H*W, C)    += attn_w * w_c * g_pos, summed over each group
//                              (nullptr: not wanted)
//     d_w    (B, Q, nh, P)   = sum_c w_c * A_c
//     d_loc  (B, Q, nh, P, 2) = attn_w * (W * sum_c wy_c dwx_c A_c,
//                                         H * sum_c dwy_c wx_c A_c)
//   d_feat and d_pos must be zeroed by the caller; d_loc and d_w are written.
//   Border masks are piecewise constant: an out-of-grid corner has w_c = 0
//   and zero derivatives, as the one-hot factors of the TPU path.
//
// Order of sums. d_feat and d_pos are summed with fp32 atomicAdd, whose order
// changes from run to run, so those two outputs are not bitwise reproducible:
// each cell's sum differs between runs by a few fp32 roundings of its terms
// (about 1e-6 of the cell's magnitude at the flagship shapes). The d_pos
// table is hit by every batch element of its group, so contention falls
// there. d_loc and d_w are owned by one warp each and are deterministic.
//
// What bounds it on the H100: bytes. Per point it reads up to 4 corner rows
// of Cin (+ C) channels and does 2 flops per channel read for A, plus one
// atomic add per channel per corner for each wanted scatter; far below the
// flop/byte balance of the card. The design:
//   * one block per (b, q) serves all nh heads; a first pass computes each
//     point's 4 corner indices, bilinear weights and their x/y derivatives
//     into shared memory once (an out-of-range corner gets index -1 and is
//     never read), and stages every head's upstream-gradient row (g_feat |
//     g_pos) in fp32 shared memory, so each is read from device memory once;
//   * one warp per head; lanes walk the channels, 4 per lane, so a warp reads
//     one corner row as a contiguous stretch and all lanes read the same
//     corner index from shared memory as a broadcast;
//   * A_c is a warp reduction (shuffles) of the lanes' partial dot products:
//     no shared-memory round trip and no block barrier per corner.
// Making it faster (wgmma for the dots, a deterministic per-cell reduction in
// place of atomics, vector atomics) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void scatter4(float* p, float s, float4 g) {
  atomicAdd(p + 0, s * g.x);
  atomicAdd(p + 1, s * g.y);
  atomicAdd(p + 2, s * g.z);
  atomicAdd(p + 3, s * g.w);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lazy_deform_sample_bwd_kernel(const T* __restrict__ feat,
                              const T* __restrict__ pos,
                              const float* __restrict__ loc,
                              const float* __restrict__ attn_w,
                              const T* __restrict__ g_feat,
                              const T* __restrict__ g_pos,
                              const T* __restrict__ g_one,
                              float* __restrict__ d_feat,
                              float* __restrict__ d_pos,
                              float* __restrict__ d_loc,
                              float* __restrict__ d_w, int B, int H, int W,
                              int Cin, int C, int G, int pos_block, int Q,
                              int nh, int P) {
  extern __shared__ float4 smem4[];
  const int NP = nh * P;    // points of this (b, q), all heads
  const int rowlen = Cin + C;  // a multiple of 4
  float* s_g = reinterpret_cast<float*>(smem4);  // (nh, rowlen) upstream grads
  int* s_idx = reinterpret_cast<int*>(s_g + nh * rowlen);  // (NP, 4)
  float* s_wb = reinterpret_cast<float*>(s_idx + 4 * NP);  // w_c = wy * wx
  float* s_gx = s_wb + 4 * NP;                             // wy * dwx
  float* s_gy = s_gx + 4 * NP;                             // dwy * wx
  float* s_aw = s_gy + 4 * NP;                             // (NP,) attn_w

  const int bq = blockIdx.x;  // b * Q + q
  const int b = bq / Q;
  const int HW = H * W;
  const int vf = Cin / 4;
  const int vrow = vf + C / 4;

  // Pass 1a: corner records, one thread per (head, point). The arithmetic is
  // that of the forward kernel and of _lazy_bwd_rule.
  for (int t = threadIdx.x; t < NP; t += blockDim.x) {
    const size_t pt = static_cast<size_t>(bq) * NP + t;
    const float x = __fsub_rn(__fmul_rn(loc[2 * pt], static_cast<float>(W)), 0.5f);
    const float y = __fsub_rn(__fmul_rn(loc[2 * pt + 1], static_cast<float>(H)), 0.5f);
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
    const bool ok[4] = {in_y0 && in_x0, in_y0 && in_x1, in_y1 && in_x0,
                        in_y1 && in_x1};
    const int idx[4] = {y0 * W + x0, y0 * W + x0 + 1, (y0 + 1) * W + x0,
                        (y0 + 1) * W + x0 + 1};
    const float wy[4] = {1.0f - ly, 1.0f - ly, ly, ly};
    const float wx[4] = {1.0f - lx, lx, 1.0f - lx, lx};
    const float dwy[4] = {-1.0f, -1.0f, 1.0f, 1.0f};
    const float dwx[4] = {-1.0f, 1.0f, -1.0f, 1.0f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_idx[4 * t + c] = ok[c] ? idx[c] : -1;
      s_wb[4 * t + c] = ok[c] ? wy[c] * wx[c] : 0.0f;
      s_gx[4 * t + c] = ok[c] ? wy[c] * dwx[c] : 0.0f;
      s_gy[4 * t + c] = ok[c] ? dwy[c] * wx[c] : 0.0f;
    }
    s_aw[t] = attn_w[pt];
  }
  // Pass 1b: every head's (g_feat | g_pos) row, in fp32.
  for (int i = threadIdx.x; i < nh * vrow; i += blockDim.x) {
    const int h = i / vrow;
    const int v = i - h * vrow;
    const size_t row = static_cast<size_t>(bq) * nh + h;
    const float4 gv = v < vf ? load4(g_feat + row * Cin + 4 * v)
                             : load4(g_pos + row * C + 4 * (v - vf));
    reinterpret_cast<float4*>(s_g + h * rowlen)[v] = gv;
  }
  __syncthreads();

  // Pass 2: one warp per head, channels across lanes, 4 per lane.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = C > 0 ? (pos_block ? b / (B / G) : b % G) : 0;
  const T* feat_b = feat + static_cast<size_t>(b) * HW * Cin;
  const T* pos_g = C > 0 ? pos + static_cast<size_t>(g) * HW * C : nullptr;
  float* dfeat_b = d_feat ? d_feat + static_cast<size_t>(b) * HW * Cin : nullptr;
  float* dpos_g = (d_pos && C > 0) ? d_pos + static_cast<size_t>(g) * HW * C : nullptr;
  for (int h = warp; h < nh; h += kWarps) {
    const float g1 = load1(g_one + static_cast<size_t>(bq) * nh + h);
    const float4* gh = reinterpret_cast<const float4*>(s_g + h * rowlen);
    for (int p = 0; p < P; ++p) {
      const int t = h * P + p;
      const float a = s_aw[t];
      int idx[4];
      float sw[4];
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        idx[c] = s_idx[4 * t + c];
        sw[c] = a * s_wb[4 * t + c];
      }
      for (int v = lane; v < vrow; v += 32) {
        const bool is_feat = v < vf;
        const int stride = is_feat ? Cin : C;
        const T* src = is_feat ? feat_b + 4 * v : pos_g + 4 * (v - vf);
        float* dst = is_feat ? (dfeat_b ? dfeat_b + 4 * v : nullptr)
                             : (dpos_g ? dpos_g + 4 * (v - vf) : nullptr);
        const float4 gv = gh[v];
        float4 val[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {  // issue the corner loads together
          val[c] = idx[c] >= 0 ? load4(src + static_cast<size_t>(idx[c]) * stride)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (idx[c] >= 0) {
            part[c] += dot4(val[c], gv);
            if (dst) scatter4(dst + static_cast<size_t>(idx[c]) * stride, sw[c], gv);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) part[c] = warp_sum(part[c]);
      if (lane == 0) {
        float dw = 0.0f, dx = 0.0f, dy = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float A = part[c] + g1;  // masked corners have zero weights
          dw = fmaf(s_wb[4 * t + c], A, dw);
          dx = fmaf(s_gx[4 * t + c], A, dx);
          dy = fmaf(s_gy[4 * t + c], A, dy);
        }
        const size_t pt = static_cast<size_t>(bq) * NP + t;
        d_w[pt] = dw;
        d_loc[2 * pt] = a * static_cast<float>(W) * dx;
        d_loc[2 * pt + 1] = a * static_cast<float>(H) * dy;
      }
    }
  }
}

template <typename T>
int launch(const void* feat, const void* pos, const void* loc,
           const void* attn_w, const void* g_feat, const void* g_pos,
           const void* g_one, float* d_feat, float* d_pos, float* d_loc,
           float* d_w, int B, int H, int W, int Cin, int C, int G,
           int pos_block, int Q, int nh, int P, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(nh) * (Cin + C) +
                      static_cast<size_t>(nh) * P * (4 * 16 + 4);
  lazy_deform_sample_bwd_kernel<T><<<B * Q, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(pos),
      static_cast<const float*>(loc), static_cast<const float*>(attn_w),
      static_cast<const T*>(g_feat), static_cast<const T*>(g_pos),
      static_cast<const T*>(g_one), d_feat, d_pos, d_loc, d_w, B, H, W, Cin,
      C, G, pos_block, Q, nh, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaGetLastError() code of the launch (0 on success). The
// caller validates shapes, dtypes, contiguity and alignment beforehand and
// zeroes d_feat and d_pos (either may be null: that gradient is skipped).
extern "C" int egorear_lazy_deform_sample_bwd(
    const void* feat, const void* pos, const void* loc, const void* attn_w,
    const void* g_feat, const void* g_pos, const void* g_one, void* d_feat,
    void* d_pos, void* d_loc, void* d_w, int B, int H, int W, int Cin, int C,
    int G, int pos_block, int Q, int nh, int P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* df = static_cast<float*>(d_feat);
  float* dp = static_cast<float*>(d_pos);
  float* dl = static_cast<float*>(d_loc);
  float* dw = static_cast<float*>(d_w);
  if (dtype == 0)
    return launch<float>(feat, pos, loc, attn_w, g_feat, g_pos, g_one, df, dp,
                         dl, dw, B, H, W, Cin, C, G, pos_block, Q, nh, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, pos, loc, attn_w, g_feat, g_pos, g_one,
                                 df, dp, dl, dw, B, H, W, Cin, C, G, pos_block,
                                 Q, nh, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
