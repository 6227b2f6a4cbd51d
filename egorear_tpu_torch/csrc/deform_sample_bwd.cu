// Per-head deformable sampling (the mmcv MSDA contract), backward, for Hopper
// (sm_90a).
//
// Replaces the VJP of egorear_tpu/ops/deform_attn.py::_sample_pallas_vjp:
// _pallas_bwd_rule (:276) is jax.vjp of the XLA _sample_onehot, which
// reaches the corners through dense one-hot interpolation matrices. Here one
// kernel visits each sampling point's 4 bilinear corners, forms the adjoint
// only there and scatters the transposed sampling with atomics.
//
// Contract (the VJP of deform_sample.cu; the same as jax.vjp(_sample_onehot)):
//   value (B, H, W, nh, ch) in T = fp32 | bf16; loc (B, Q, nh, P, 2) fp32;
//   attn_w (B, Q, nh, P) fp32; g (B, Q, nh * ch) in T. Outputs, all fp32:
//     d_value (B, H, W, nh, ch) += attn_w * w_c * g[h]   (nullptr: not wanted)
//     d_w     (B, Q, nh, P)      = sum_c w_c * A_c
//     d_loc   (B, Q, nh, P, 2)   = attn_w * (W * sum_c wy_c dwx_c A_c,
//                                            H * sum_c dwy_c wx_c A_c)
//   with A_c = value[b, corner c, h] . g[b, q, h]. d_value must be zeroed by
//   the caller; d_loc and d_w are written. Border masks are piecewise
//   constant: an out-of-grid corner has w_c = 0 and zero derivatives, as the
//   one-hot factors of _sample_onehot.
//
// Order of sums. d_value is summed with fp32 atomicAdd, whose order changes
// from run to run, so d_value is not bitwise reproducible: each element's sum
// differs between runs by a few fp32 roundings of its terms (about 1e-6 of
// the element's magnitude), which the 1e-4 (fp32) and 1e-2 (bf16, after the
// cast) tolerances of the checks against the plain version cover. Contention
// is light: every batch element scatters into its own value map, and only the
// points of one (b, head) that share a corner meet on an address. d_loc and
// d_w are owned by one thread group each and are deterministic.
//
// What bounds it on the H100: bytes. Per point it reads up to 4 corner
// slices of ch channels and does 2 flops per channel read for A plus one
// atomic add per channel per corner for d_value; far below the flop/byte
// balance of the card. The design:
//   * one block per (b, q) serves all nh heads; a first pass computes each
//     point's 4 corner indices, bilinear weights and their x/y derivatives
//     into shared memory once (an out-of-range corner gets index -1 and is
//     never read), and stages the upstream-gradient row g[b, q] in fp32
//     shared memory, so it is read from device memory once;
//   * a group of `group` lanes (a power of two, the smallest that covers the
//     ch / VEC vectors of a head slice, at most a warp) takes one (head,
//     point) at a time; its lanes walk the channels VEC at a time, so the
//     group reads each corner's head slice as one contiguous stretch;
//   * A_c is a shuffle reduction within the group: no shared-memory round
//     trip and no block barrier per point.
// Making it faster (a deterministic per-cell reduction or vector atomics in
// place of scalar atomics, d_value without the fp32 scratch for bf16, wider
// blocks) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Sum over the `group` lanes of each aligned group of a warp. Every lane of
// the warp calls it (the shuffles take the full mask).
__device__ __forceinline__ float group_sum(float v, int group) {
  for (int o = group / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
deform_sample_bwd_kernel(const T* __restrict__ value,
                         const float* __restrict__ loc,
                         const float* __restrict__ attn_w,
                         const T* __restrict__ g, float* __restrict__ d_value,
                         float* __restrict__ d_loc, float* __restrict__ d_w,
                         int H, int W, int Q, int nh, int ch, int P, int group) {
  extern __shared__ float4 smem4[];
  const int NP = nh * P;    // points of this (b, q), all heads
  const int rowlen = nh * ch;  // elements per grid cell, and of g[b, q]
  float* s_g = reinterpret_cast<float*>(smem4);            // (rowlen,) upstream grad
  int* s_idx = reinterpret_cast<int*>(s_g + rowlen);        // (NP, 4)
  float* s_wb = reinterpret_cast<float*>(s_idx + 4 * NP);   // w_c = wy * wx
  float* s_gx = s_wb + 4 * NP;                              // wy * dwx
  float* s_gy = s_gx + 4 * NP;                              // dwy * wx
  float* s_aw = s_gy + 4 * NP;                              // (NP,) attn_w

  const int bq = blockIdx.x;  // b * Q + q
  const int b = bq / Q;

  // Pass 1a: corner records, one thread per (head, point). The arithmetic is
  // that of the forward kernel.
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
  // Pass 1b: the upstream-gradient row of every head, in fp32.
  const T* g_q = g + static_cast<size_t>(bq) * rowlen;
  for (int i = threadIdx.x; i < rowlen; i += blockDim.x) s_g[i] = load1(g_q + i);
  __syncthreads();

  // Pass 2: one group of lanes per (head, point); channels across the lanes.
  const int lane = threadIdx.x % group;
  const int gid = threadIdx.x / group;
  const int groups = blockDim.x / group;
  const int vpr = ch / VEC;  // vectors per head slice (VEC divides ch)
  const size_t row = static_cast<size_t>(rowlen);
  const T* value_b = value + static_cast<size_t>(b) * H * W * row;
  float* dv_b = d_value ? d_value + static_cast<size_t>(b) * H * W * row : nullptr;
  // The loop bound is the same for every thread of the block, so every lane
  // of a warp reaches the group reduction together.
  for (int base = 0; base < NP; base += groups) {
    const int t = base + gid;  // h * P + p
    const bool active = t < NP;
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (active) {
      const int h = t / P;
      const float a = s_aw[t];
      int idx[4];
      float sw[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        idx[c] = s_idx[4 * t + c];
        sw[c] = a * s_wb[4 * t + c];
      }
      for (int v = lane; v < vpr; v += group) {
        const int off = h * ch + v * VEC;
        float gv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) gv[e] = s_g[off + e];
        float val[4][VEC];
#pragma unroll
        for (int c = 0; c < 4; ++c) {  // issue the corner loads together
          if (idx[c] >= 0) {
            load_vec(value_b + static_cast<size_t>(idx[c]) * row + off, val[c]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) val[c][e] = 0.0f;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (idx[c] < 0) continue;
#pragma unroll
          for (int e = 0; e < VEC; ++e) part[c] = fmaf(val[c][e], gv[e], part[c]);
          if (dv_b) {
            float* dst = dv_b + static_cast<size_t>(idx[c]) * row + off;
#pragma unroll
            for (int e = 0; e < VEC; ++e) atomicAdd(dst + e, sw[c] * gv[e]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) part[c] = group_sum(part[c], group);
    if (active && lane == 0) {
      float dw = 0.0f, dx = 0.0f, dy = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // masked corners have zero weights
        dw = fmaf(s_wb[4 * t + c], part[c], dw);
        dx = fmaf(s_gx[4 * t + c], part[c], dx);
        dy = fmaf(s_gy[4 * t + c], part[c], dy);
      }
      const float a = s_aw[t];
      const size_t pt = static_cast<size_t>(bq) * NP + t;
      d_w[pt] = dw;
      d_loc[2 * pt] = a * static_cast<float>(W) * dx;
      d_loc[2 * pt + 1] = a * static_cast<float>(H) * dy;
    }
  }
}

template <typename T, int VEC>
int launch(const void* value, const void* loc, const void* attn_w,
           const void* g, float* d_value, float* d_loc, float* d_w, int B,
           int H, int W, int Q, int nh, int ch, int P, cudaStream_t stream) {
  const int vpr = ch / VEC;
  int group = 1;
  while (group < vpr && group < 32) group *= 2;
  const size_t smem = sizeof(float) * static_cast<size_t>(nh) * ch +
                      static_cast<size_t>(nh) * P * (4 * 16 + 4);
  deform_sample_bwd_kernel<T, VEC><<<B * Q, kThreads, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn_w), static_cast<const T*>(g), d_value,
      d_loc, d_w, H, W, Q, nh, ch, P, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(int vec, const void* value, const void* loc, const void* attn_w,
               const void* g, float* d_value, float* d_loc, float* d_w, int B,
               int H, int W, int Q, int nh, int ch, int P, cudaStream_t stream) {
  if (vec == 4)
    return launch<T, 4>(value, loc, attn_w, g, d_value, d_loc, d_w, B, H, W, Q,
                        nh, ch, P, stream);
  if (vec == 1)
    return launch<T, 1>(value, loc, attn_w, g, d_value, d_loc, d_w, B, H, W, Q,
                        nh, ch, P, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// vec: channels a load, 4 (ch % 4 == 0, value's base aligned to 4 elements,
// g contiguous and 16-byte aligned) or 1. Returns the cudaGetLastError() code
// of the launch (0 on success). The caller validates shapes, dtypes,
// contiguity and alignment beforehand and zeroes d_value (which may be null:
// that gradient is skipped).
extern "C" int egorear_deform_sample_bwd(
    const void* value, const void* loc, const void* attn_w, const void* g,
    void* d_value, void* d_loc, void* d_w, int B, int H, int W, int Q, int nh,
    int ch, int P, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dv = static_cast<float*>(d_value);
  float* dl = static_cast<float*>(d_loc);
  float* dw = static_cast<float*>(d_w);
  if (dtype == 0)
    return launch_vec<float>(vec, value, loc, attn_w, g, dv, dl, dw, B, H, W, Q,
                             nh, ch, P, s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(vec, value, loc, attn_w, g, dv, dl, dw, B,
                                     H, W, Q, nh, ch, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
