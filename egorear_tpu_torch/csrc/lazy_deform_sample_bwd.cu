// Lazy deformable sampling, backward, for Hopper (sm_90a).
//
// Replaces the backward role of egorear_tpu/ops/deform_attn.py::
// _make_s_builder_kernel: _lazy_bwd_rule builds the packed bilinear sampling
// operator S again with that Pallas kernel and contracts it transposed with
// the upstream gradients (d_feat, d_pos), then forms the adjoint field
// A = feat . g_feat + pos . g_pos + g_one over the whole grid and reads it at
// the corners through one-hot matmuls (d_loc, d_attn_w). Here nothing like S
// or the dense A is formed: the kernels visit each sampling point's 4
// bilinear corners and compute A only there.
//
// Contract (the VJP of lazy_deform_sample.cu; the same as _lazy_bwd_rule):
//   feat (B, H*W, Cin), pos (G, H*W, C) or absent (C == 0), T = fp32 | bf16;
//   loc (B, Q, nh, P, 2) fp32, attn_w (B, Q, nh, P) fp32;
//   g_feat (B, Q, nh, Cin), g_pos (B, Q, nh, C), g_one (B, Q, nh, 1) in T.
//   Outputs:
//     d_feat (B, H*W, Cin) in T  = sum of attn_w * w_c * g_feat over the
//                                  corners on each cell, written in full
//                                  (zero where none lands; nullptr: not
//                                  wanted)
//     d_pos  (G, H*W, C) fp32   += attn_w * w_c * g_pos, summed over each
//                                  group (zeroed by the caller; nullptr: not
//                                  wanted)
//     d_w    (B, Q, nh, P) fp32  = sum_c w_c * A_c
//     d_loc  (B, Q, nh, P, 2) fp32 = attn_w * (W * sum_c wy_c dwx_c A_c,
//                                              H * sum_c dwy_c wx_c A_c)
//   Border masks are piecewise constant: an out-of-grid corner has w_c = 0
//   and zero derivatives, as the one-hot factors of the TPU path.
//
// What bounds it on the H100: bytes. Per point it reads up to 4 corner rows
// of Cin (+ C) channels and does 2 flops per channel read for A; far below
// the flop/byte balance of the card. What cost time in a single kernel that
// scattered d_feat and d_pos with scalar fp32 atomics: the reduction
// instructions into the (G, H*W, C) table that every batch element of a
// group hits, and around it an fp32 d_feat scratch zeroed before and cast
// after. Two kernels:
//
//  1. lazy_deform_sample_bwd_adjoint_kernel, one block per (b, q), all heads.
//     A first pass puts each point's corner records (index, w_c and its x/y
//     factors; an out-of-range corner gets index -1 and is never read) and
//     every head's (g_feat | g_pos) row, in fp32, into shared memory. Then
//     one warp per point (8 warps walk the block's nh * P points side by
//     side): lanes take 4 channels each of the corner rows, and the 4 corner
//     sums are reduced together in 6 shuffles (each lane ends with one
//     corner's sum), so d_loc and d_w leave after 3 more.
//     d_pos: one warp per in-range corner adds attn_w * w_c * g_pos[h] to
//     the table with one float4 atomicAdd per 4 channels (sm_90's vector
//     reduction), a quarter of the reduction instructions of scalar atomics.
//     Few corners repeat a cell within a (b, q) (about 1 % with uniform
//     locations, 18 % with the flagship's own), so merging them in shared
//     memory first cost more than it saved.
//  2. lazy_deform_sample_bwd_dfeat_kernel owns d_feat: only the Q * nh * P
//     points of batch element b touch d_feat[b], so a block of 512 threads
//     takes b and a run of up to 8 bands of cells (a band's fp32 tile is at
//     most 64 KB; the runs are sized so that the grid is about two blocks
//     per SM, which the shared memory allows). It stages b's g_feat rows in
//     shared memory and sorts the corners of b that land in its cells by
//     band, in id order within a band (a stable counting sort, 8 bytes an
//     entry). Then band by band it sums attn_w * w_c * g_feat into the
//     tile: warp w owns the tile rows r with r % 16 == w and walks the
//     band's entries 32 a step (ballot, matches in lane order), lanes own
//     channel columns, so no atomics; and it writes the band once, in T.
//     No zero-fill and no cast outside, and d_feat is bitwise reproducible.
//
// Order of sums. d_feat, d_loc and d_w are summed in a fixed order and are
// bitwise reproducible from run to run. d_pos is added with atomics whose
// order changes from run to run (each cell differs between runs by a few
// fp32 roundings of its terms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDThreads = 512;         // kernel 2
constexpr int kDWarps = kDThreads / 32;
constexpr int kMaxBands = 8;           // bands a kernel-2 block owns, at most
constexpr int kTileBytes = 64 * 1024;  // kernel 2's fp32 band tile, at most
constexpr int kSmemDefault = 48 * 1024;  // above this, opt in per kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 unpack4(uint2 u) {
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return unpack4(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float s, float4 g, float4& acc) {
  acc.x = fmaf(s, g.x, acc.x);
  acc.y = fmaf(s, g.y, acc.y);
  acc.z = fmaf(s, g.z, acc.z);
  acc.w = fmaf(s, g.w, acc.w);
}

// The 4 bilinear corners of point pt, in the order (y0, x0), (y0, x1),
// (y1, x0), (y1, x1): flat cell index (-1 out of the grid), w_c = wy * wx
// and its x and y factors wy * dwx, dwy * wx (zero out of the grid). The
// arithmetic is that of the forward kernel and of _lazy_bwd_rule.
__device__ __forceinline__ void corner_records(const float* __restrict__ loc,
                                               size_t pt, int H, int W,
                                               int idx[4], float wb[4],
                                               float gx[4], float gy[4]) {
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
  const int cell[4] = {y0 * W + x0, y0 * W + x0 + 1, (y0 + 1) * W + x0,
                       (y0 + 1) * W + x0 + 1};
  const float wy[4] = {1.0f - ly, 1.0f - ly, ly, ly};
  const float wx[4] = {1.0f - lx, lx, 1.0f - lx, lx};
  const float dwy[4] = {-1.0f, -1.0f, 1.0f, 1.0f};
  const float dwx[4] = {-1.0f, 1.0f, -1.0f, 1.0f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    idx[c] = ok[c] ? cell[c] : -1;
    wb[c] = ok[c] ? wy[c] * wx[c] : 0.0f;
    gx[c] = ok[c] ? wy[c] * dwx[c] : 0.0f;
    gy[c] = ok[c] ? dwy[c] * wx[c] : 0.0f;
  }
}

// Warp sums of 4 values at once: lane l returns the sum over the warp of
// p[(l >> 3) & 3], so lanes 0, 8, 16, 24 hold the sums of p[0..3].
__device__ __forceinline__ float warp_sum4(const float p[4], int lane) {
  const bool hi16 = lane & 16;
  float k0 = hi16 ? p[2] : p[0];
  float k1 = hi16 ? p[3] : p[1];
  k0 += __shfl_xor_sync(kFull, hi16 ? p[0] : p[2], 16);
  k1 += __shfl_xor_sync(kFull, hi16 ? p[1] : p[3], 16);
  const bool hi8 = lane & 8;
  float k = hi8 ? k1 : k0;
  k += __shfl_xor_sync(kFull, hi8 ? k0 : k1, 8);
  k += __shfl_xor_sync(kFull, k, 4);
  k += __shfl_xor_sync(kFull, k, 2);
  k += __shfl_xor_sync(kFull, k, 1);
  return k;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lazy_deform_sample_bwd_adjoint_kernel(const T* __restrict__ feat,
                                      const T* __restrict__ pos,
                                      const float* __restrict__ loc,
                                      const float* __restrict__ attn_w,
                                      const T* __restrict__ g_feat,
                                      const T* __restrict__ g_pos,
                                      const T* __restrict__ g_one,
                                      float* __restrict__ d_pos,
                                      float* __restrict__ d_loc,
                                      float* __restrict__ d_w, int B, int H,
                                      int W, int Cin, int C, int G,
                                      int pos_block, int Q, int nh, int P) {
  extern __shared__ float4 smem4[];
  const int NP = nh * P;       // points of this (b, q), all heads
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
  const int g = C > 0 ? (pos_block ? b / (B / G) : b % G) : 0;
  float* dpos_g = (d_pos && C > 0) ? d_pos + static_cast<size_t>(g) * HW * C : nullptr;

  // Pass 1: corner records, one thread per (head, point); every head's
  // (g_feat | g_pos) row in fp32.
  for (int t = threadIdx.x; t < NP; t += kThreads) {
    const size_t pt = static_cast<size_t>(bq) * NP + t;
    int idx[4];
    float wb[4], gx[4], gy[4];
    corner_records(loc, pt, H, W, idx, wb, gx, gy);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_idx[4 * t + c] = idx[c];
      s_wb[4 * t + c] = wb[c];
      s_gx[4 * t + c] = gx[c];
      s_gy[4 * t + c] = gy[c];
    }
    s_aw[t] = attn_w[pt];
  }
  for (int i = threadIdx.x; i < nh * vrow; i += kThreads) {
    const int h = i / vrow;
    const int v = i - h * vrow;
    const size_t row = static_cast<size_t>(bq) * nh + h;
    const float4 gv = v < vf ? load4(g_feat + row * Cin + 4 * v)
                             : load4(g_pos + row * C + 4 * (v - vf));
    reinterpret_cast<float4*>(s_g + h * rowlen)[v] = gv;
  }
  __syncthreads();

  // Pass 2: the adjoint at the corners, one warp per point, 4 channels a
  // lane; d_loc and d_w from lane 0.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* feat_b = feat + static_cast<size_t>(b) * HW * Cin;
  const T* pos_g = C > 0 ? pos + static_cast<size_t>(g) * HW * C : nullptr;
  for (int t = warp; t < NP; t += kWarps) {
    const int h = t / P;
    const float4* gh = reinterpret_cast<const float4*>(s_g + h * rowlen);
    int idx[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) idx[c] = s_idx[4 * t + c];
    // Loaded here, so that its latency overlaps the corner loads.
    const float g1 = load1(g_one + static_cast<size_t>(bq) * nh + h);
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int v = lane; v < vrow; v += 32) {
      const bool is_feat = v < vf;
      const int stride = is_feat ? Cin : C;
      const T* src = is_feat ? feat_b + 4 * v : pos_g + 4 * (v - vf);
      const float4 gv = gh[v];
      float4 val[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // issue the corner loads together
        val[c] = idx[c] >= 0 ? load4(src + static_cast<size_t>(idx[c]) * stride)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) part[c] += dot4(val[c], gv);
    }
    const float sum = warp_sum4(part, lane);
    const float sum1 = __shfl_sync(kFull, sum, 8);
    const float sum2 = __shfl_sync(kFull, sum, 16);
    const float sum3 = __shfl_sync(kFull, sum, 24);
    if (lane == 0) {
      const float A[4] = {sum + g1, sum1 + g1, sum2 + g1, sum3 + g1};
      float dw = 0.0f, dx = 0.0f, dy = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // masked corners have zero weights
        dw = fmaf(s_wb[4 * t + c], A[c], dw);
        dx = fmaf(s_gx[4 * t + c], A[c], dx);
        dy = fmaf(s_gy[4 * t + c], A[c], dy);
      }
      const float a = s_aw[t];
      const size_t pt = static_cast<size_t>(bq) * NP + t;
      d_w[pt] = dw;
      d_loc[2 * pt] = a * static_cast<float>(W) * dx;
      d_loc[2 * pt + 1] = a * static_cast<float>(H) * dy;
    }
  }

  // Pass 3 (d_pos wanted): one warp per in-range corner adds
  // attn_w * w_c * g_pos[h] with float4 reductions.
  if (dpos_g) {
    const int vc = C / 4;
    for (int e = warp; e < 4 * NP; e += kWarps) {
      const int cell = s_idx[e];
      if (cell < 0) continue;
      const int t = e >> 2;
      const float s = s_aw[t] * s_wb[e];
      const float4* gp = reinterpret_cast<const float4*>(s_g + (t / P) * rowlen + Cin);
      float4* dst = reinterpret_cast<float4*>(dpos_g + static_cast<size_t>(cell) * C);
      for (int v = lane; v < vc; v += 32) {
        const float4 gv = gp[v];
        atomicAdd(dst + v, make_float4(s * gv.x, s * gv.y, s * gv.z, s * gv.w));
      }
    }
  }
}

// 4 channels of T as stored: what one vector load or store moves.
template <typename T> struct Raw4;
template <> struct Raw4<float> { using type = float4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };

// 4 channels from shared memory, as fp32.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  return unpack4(*reinterpret_cast<const uint2*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kDThreads, 2)
lazy_deform_sample_bwd_dfeat_kernel(const float* __restrict__ loc,
                                    const float* __restrict__ attn_w,
                                    const T* __restrict__ g_feat,
                                    T* __restrict__ d_feat, int H, int W,
                                    int Cin, int Q, int nh, int P, int band,
                                    int nbands, int bands_per_block) {
  extern __shared__ float4 smem4[];
  const int groups = (nbands + bands_per_block - 1) / bands_per_block;
  const int b = blockIdx.x / groups;
  const int band0 = (blockIdx.x - b * groups) * bands_per_block;
  const int nb = min(bands_per_block, nbands - band0);  // <= kMaxBands
  const int HW = H * W;
  const int cell0 = band0 * band;               // the block owns the cells
  const int cell1 = min(cell0 + nb * band, HW);  // [cell0, cell1) of d_feat[b]
  const int rows = Q * nh;                      // upstream-gradient rows of b
  const int NPb = rows * P;                     // sampling points of b
  const int ncol = Cin / 4;
  float* s_tile = reinterpret_cast<float*>(smem4);            // (band, Cin)
  int* s_key = reinterpret_cast<int*>(s_tile + band * Cin);    // kept corners:
  float* s_scale = reinterpret_cast<float*>(s_key + 4 * NPb);  //  r | row << 16
  T* s_gf = reinterpret_cast<T*>(s_scale + 4 * NPb);           //  and a * w_c
  int* s_off = reinterpret_cast<int*>(s_gf + rows * Cin);      // (kMaxBands, kDWarps)
  int* s_start = s_off + kMaxBands * kDWarps;                  // (kMaxBands + 1,)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // b's g_feat rows, as stored.
  using V = typename Raw4<T>::type;
  const V* gsrc = reinterpret_cast<const V*>(g_feat + static_cast<size_t>(b) * rows * Cin);
  for (int i = threadIdx.x; i < rows * ncol; i += kDThreads)
    reinterpret_cast<V*>(s_gf)[i] = __ldg(gsrc + i);

  // The corners of b that land in the block's cells, sorted by band and in
  // id order (4 * point + corner) within a band: thread t takes points
  // [t * K, (t + 1) * K) and counts its corners per band; prefix sums in
  // (band, warp, lane) order give each thread its offsets (a stable
  // counting sort); then it writes its corners there.
  const int K = (NPb + kDThreads - 1) / kDThreads;
  const int p0 = min(static_cast<int>(threadIdx.x) * K, NPb);
  const int p1 = min(p0 + K, NPb);
  const size_t pb = static_cast<size_t>(b) * NPb;
  int idx[4];
  float wb[4], gx[4], gy[4];
  int cnt[kMaxBands];
#pragma unroll
  for (int j = 0; j < kMaxBands; ++j) cnt[j] = 0;
  for (int p = p0; p < p1; ++p) {
    corner_records(loc, pb + p, H, W, idx, wb, gx, gy);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = idx[c] >= cell0 && idx[c] < cell1 ? (idx[c] - cell0) / band : -1;
#pragma unroll
      for (int j = 0; j < kMaxBands; ++j) cnt[j] += k == j;
    }
  }
  int off[kMaxBands];
#pragma unroll
  for (int j = 0; j < kMaxBands; ++j) {
    int x = cnt[j];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    off[j] = x - cnt[j];  // exclusive, within the warp
    if (lane == 31) s_off[j * kDWarps + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix sums of the warp totals, (band, warp) order
    constexpr int kPer = kMaxBands * kDWarps / 32;
    int v[kPer];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      v[i] = s_off[lane * kPer + i];
      sum += v[i];
    }
    int x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    int run = x - sum;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      s_off[lane * kPer + i] = run;
      run += v[i];
    }
    if (lane == 31) s_start[kMaxBands] = x;
  }
  __syncthreads();
  if (threadIdx.x < kMaxBands) s_start[threadIdx.x] = s_off[threadIdx.x * kDWarps];
#pragma unroll
  for (int j = 0; j < kMaxBands; ++j) off[j] += s_off[j * kDWarps + warp];
  for (int p = p0; p < p1; ++p) {
    corner_records(loc, pb + p, H, W, idx, wb, gx, gy);
    const float a = attn_w[pb + p];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (idx[c] >= cell0 && idx[c] < cell1) {
        const int rel = idx[c] - cell0;
        const int k = rel / band;
        int o = 0;
#pragma unroll
        for (int j = 0; j < kMaxBands; ++j) {
          if (j == k) o = off[j]++;
        }
        s_key[o] = (rel - k * band) | ((p / P) << 16);
        s_scale[o] = a * wb[c];
      }
    }
  }

  // Band by band: warp w sums the band's corners on the tile rows r with
  // r % kDWarps == w into the fp32 tile, in list order (32 entries a step,
  // matches taken in lane order); lanes own channel columns. Then the band
  // is written once, in T.
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < nb; ++k) {
    const int bi = band0 + k;
    const int nrows = min(band, HW - bi * band);
    __syncthreads();  // the list is complete; the last band is written out
    for (int i = threadIdx.x; i < band * ncol; i += kDThreads)
      reinterpret_cast<float4*>(s_tile)[i] = zero;
    __syncthreads();
    const int hi = s_start[k + 1];
    for (int base = s_start[k]; base < hi; base += 32) {
      const int j = base + lane;
      const int key = j < hi ? s_key[j] : -1;
      const float s = j < hi ? s_scale[j] : 0.0f;
      unsigned m = __ballot_sync(kFull, key >= 0 && (key & (kDWarps - 1)) == warp);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const int kk = __shfl_sync(kFull, key, src);
        const float ss = __shfl_sync(kFull, s, src);
        const T* gr = s_gf + (kk >> 16) * Cin;
        float4* acc = reinterpret_cast<float4*>(s_tile + (kk & 0xffff) * Cin);
        for (int v = lane; v < ncol; v += 32) {
          float4 cur = acc[v];
          fma4(ss, lds4(gr + 4 * v), cur);
          acc[v] = cur;
        }
      }
    }
    __syncthreads();
    T* out = d_feat + (static_cast<size_t>(b) * HW + bi * band) * Cin;
    for (int i = threadIdx.x; i < nrows * ncol; i += kDThreads)
      store4(out + 4 * i, reinterpret_cast<const float4*>(s_tile)[i]);
  }
}

// Shared memory of each kernel; egorear_tpu_torch/ops/deform_attn.py::
// _bwd_smem_bytes mirrors these, and the wrapper refuses what exceeds the
// card's limit before any launch.
size_t adjoint_smem(int nh, int P, int Cin, int C) {
  return sizeof(float) * static_cast<size_t>(nh) * (Cin + C) +
         static_cast<size_t>(nh) * P * (4 * 16 + 4);
}

int dfeat_band(int HW, int Cin) {
  const int band = kTileBytes / (4 * Cin);
  return band < 1 ? 1 : (band > HW ? HW : band);
}

template <typename T>
size_t dfeat_smem(int band, int Q, int nh, int P, int Cin) {
  return sizeof(float) * static_cast<size_t>(band) * Cin +
         static_cast<size_t>(8) * 4 * Q * nh * P +
         sizeof(T) * static_cast<size_t>(Q) * nh * Cin +
         4 * (kMaxBands * kDWarps + kMaxBands + 1);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch(const void* feat, const void* pos, const void* loc,
           const void* attn_w, const void* g_feat, const void* g_pos,
           const void* g_one, void* d_feat, float* d_pos, float* d_loc,
           float* d_w, int B, int H, int W, int Cin, int C, int G,
           int pos_block, int Q, int nh, int P, cudaStream_t stream) {
  const size_t smem1 = adjoint_smem(nh, P, Cin, C);
  auto* k1 = lazy_deform_sample_bwd_adjoint_kernel<T>;
  cudaError_t err = allow_smem(k1, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<B * Q, kThreads, smem1, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(pos),
      static_cast<const float*>(loc), static_cast<const float*>(attn_w),
      static_cast<const T*>(g_feat), static_cast<const T*>(g_pos),
      static_cast<const T*>(g_one), d_pos, d_loc, d_w, B, H, W, Cin, C, G,
      pos_block, Q, nh, P);
  err = cudaGetLastError();
  if (err != cudaSuccess || d_feat == nullptr) return static_cast<int>(err);

  // d_feat: bands of cells, several to a block so that the grid is about
  // two blocks per SM and each block reads b's points and g_feat once.
  const int HW = H * W;
  const int band = dfeat_band(HW, Cin);
  const int nbands = (HW + band - 1) / band;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_block = (B * nbands + 2 * sms - 1) / (2 * sms);
  if (per_block > kMaxBands) per_block = kMaxBands;
  const int groups = (nbands + per_block - 1) / per_block;
  const size_t smem2 = dfeat_smem<T>(band, Q, nh, P, Cin);
  auto* k2 = lazy_deform_sample_bwd_dfeat_kernel<T>;
  err = allow_smem(k2, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<B * groups, kDThreads, smem2, stream>>>(
      static_cast<const float*>(loc), static_cast<const float*>(attn_w),
      static_cast<const T*>(g_feat), static_cast<T*>(d_feat), H, W, Cin, Q,
      nh, P, band, nbands, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the first CUDA error of the launches (0 on success). The caller
// validates shapes, dtypes, contiguity, alignment and shared memory
// beforehand, allocates d_feat in feat's dtype and zeroes d_pos (fp32);
// either may be null: that gradient is skipped.
extern "C" int egorear_lazy_deform_sample_bwd(
    const void* feat, const void* pos, const void* loc, const void* attn_w,
    const void* g_feat, const void* g_pos, const void* g_one, void* d_feat,
    void* d_pos, void* d_loc, void* d_w, int B, int H, int W, int Cin, int C,
    int G, int pos_block, int Q, int nh, int P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dp = static_cast<float*>(d_pos);
  float* dl = static_cast<float*>(d_loc);
  float* dw = static_cast<float*>(d_w);
  if (dtype == 0)
    return launch<float>(feat, pos, loc, attn_w, g_feat, g_pos, g_one, d_feat,
                         dp, dl, dw, B, H, W, Cin, C, G, pos_block, Q, nh, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, pos, loc, attn_w, g_feat, g_pos, g_one,
                                 d_feat, dp, dl, dw, B, H, W, Cin, C, G,
                                 pos_block, Q, nh, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
