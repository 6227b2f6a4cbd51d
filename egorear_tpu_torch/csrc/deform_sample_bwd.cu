// Per-head deformable sampling (the mmcv MSDA contract), backward, for Hopper
// (sm_90a).
//
// Replaces the VJP of egorear_tpu/ops/deform_attn.py::_sample_pallas_vjp:
// _pallas_bwd_rule (:276) is jax.vjp of the XLA _sample_onehot, which
// reaches the corners through dense one-hot interpolation matrices. Here the
// kernels visit each sampling point's 4 bilinear corners and form the
// adjoint only there.
//
// Contract (the VJP of deform_sample.cu; the same as jax.vjp(_sample_onehot)):
//   value (B, H, W, nh, ch) in T = fp32 | bf16; loc (B, Q, nh, P, 2) fp32;
//   attn_w (B, Q, nh, P) fp32; g (B, Q, nh * ch) in T. Outputs:
//     d_value (B, H, W, nh, ch) in T = sum of attn_w * w_c * g[b, q, h] over
//                                      the corners on each (b, cell, head)
//                                      slice, written in full (zero where
//                                      none lands; nullptr: not wanted)
//     d_w     (B, Q, nh, P) fp32     = sum_c w_c * A_c
//     d_loc   (B, Q, nh, P, 2) fp32  = attn_w * (W * sum_c wy_c dwx_c A_c,
//                                                H * sum_c dwy_c wx_c A_c)
//   with A_c = value[b, corner c, h] . g[b, q, h]. Border masks are piecewise
//   constant: an out-of-grid corner has w_c = 0 and zero derivatives, as the
//   one-hot factors of _sample_onehot.
//
// What bounds it on the H100: bytes, and most of them are d_value's. It is
// dense, (B, H, W, nh, ch), while the points of a batch element touch few of
// its slices (at the flagship's MVFex call 960 points, of whose 3,840
// corners about 39 % land in the grid, for 16,384 (cell, head) slices). A
// kernel that scattered with fp32 atomics paid an fp32 zero-fill before and
// a cast to T after, twice d_value's bytes in fp32 besides its own store.
// Two kernels, no atomics into device memory and no scratch:
//
//  1. deform_sample_bwd_adjoint_kernel: a group of 4 L lanes per point, L
//     lanes a corner, each with up to kLoads loads of VEC channels of its
//     corner's slice in flight (at ch = 64 in bf16: L = 1, eight 16-byte
//     loads, 8 points a warp). Every lane computes the point's corners from loc (the
//     same instructions for the whole group) and dots its part of its
//     corner's slice with g[b, q, h]; L - 1 shuffles sum a corner, 3 more
//     bring the 4 sums to the group's first lane, which writes d_loc and
//     d_w. The grid is (b, q) rows by runs of their points.
//  2. deform_sample_bwd_dvalue_kernel owns d_value: only the Q * nh * P
//     points of batch element b touch d_value[b], so a block of 512 threads
//     takes b and a run of span cells (256 at the MVFex call, 512 at pose3d:
//     several blocks an SM in turn, so that one block's list and rounds
//     overlap another's stores). It stages b's g
//     rows in shared memory as stored and lists the corners of b that land
//     in its cells in id order (4 * point + corner; a count, a block scan and
//     the write: 8 bytes an entry), setting a bit for each (cell, head) slice
//     a corner touches. Then it writes zeros to every untouched slice of its
//     cells in one stream of 16-byte stores with no barrier in it (at the
//     flagship 9 slices in 10). A prefix count of the bits ranks the touched
//     slices. Then in rounds of cap ranks, with no block barrier either:
//     warp w owns the ranks r with r % 16 == w, walks the list (ballot,
//     matches in lane order) and sums attn_w * w_c * g into the fp32 tile
//     slot of each of its slices, lanes owning channel columns; then writes
//     each slot once, in T, and zeroes it. At the flagship one or two rounds.
//
// Shared memory of kernel 2, in this order: the fp32 tile (cap, ch), the
// list's keys and scales (4 * Q * nh * P each, 4 bytes an element), the
// block scan (kScanInts ints), the touched bits of the span's slices and
// their ranks by word (each in words, rounded up to 16 bytes), the slice of
// each rank (at most one for each corner, or for each slice), and b's g
// rows as stored (Q, nh * ch). The wrapper sizes it
// (egorear_tpu_torch/ops/deform_attn.py::_sampling_bwd_layout, which also
// picks span and cap), refuses what exceeds a block's opt-in limit, and
// passes all three numbers here.
//
// Order of sums. Each slice of d_value is summed by one warp in list order,
// each column by one lane, in fp32, and rounded to T once; A_c by a fixed
// shuffle tree. d_value, d_loc and d_w are bitwise reproducible from run to
// run (the shared-memory atomics only set bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAThreads = 256;  // kernel 1
constexpr int kLoads = 8;       // kernel 1: loads a lane has in flight
constexpr int kDThreads = 512;  // kernel 2
constexpr int kDWarps = kDThreads / 32;
// Kernel 2's block scan: kDWarps warp totals and their sum, rounded up so
// that what follows stays 16-byte aligned.
constexpr int kScanInts = 20;
static_assert(kScanInts >= kDWarps + 1 && kScanInts % 4 == 0, "scan does not fit");
// Kernel 2's list keys: the slice among the block's (18 bits) and the g row
// q * nh + h (14 bits: shared memory holds fewer than 7,300 points).
constexpr int kRowShift = 18;
constexpr int kSmemDefault = 48 * 1024;  // above this, opt in
constexpr unsigned kFull = 0xffffffffu;

// VEC channels of T from device memory, as fp32.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

__device__ __forceinline__ float2 bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = bf2(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = bf2(u.x), b = bf2(u.y);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[1]) {
  v[0] = to_float(p[0]);
}

__device__ __forceinline__ void from_float(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// The 4 bilinear corners of point pt, in the order (y0, x0), (y0, x1),
// (y1, x0), (y1, x1): flat cell index (-1 out of the grid), w_c = wy * wx
// and its x and y factors wy * dwx, dwy * wx (zero out of the grid). The
// arithmetic is that of the forward kernel and of _sample_onehot.
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kAThreads)
deform_sample_bwd_adjoint_kernel(const T* __restrict__ value,
                                 const float* __restrict__ loc,
                                 const float* __restrict__ attn_w,
                                 const T* __restrict__ g,
                                 float* __restrict__ d_loc,
                                 float* __restrict__ d_w, int H, int W, int Q,
                                 int nh, int ch, int P, int lg_L) {
  // blockIdx.x: the (b, q) row; blockIdx.y: a run of its nh * P points, one
  // a group of 4 L lanes, L = 2^lg_L lanes a corner.
  const int bq = blockIdx.x;
  const int NP = nh * P;
  const int L = 1 << lg_L;
  const int lane = threadIdx.x & (4 * L - 1);
  const int corner = lane >> lg_L;
  const int l = lane & (L - 1);
  const int p0 = blockIdx.y * (kAThreads >> (lg_L + 2)) + (threadIdx.x >> (lg_L + 2));
  // An idle group repeats the last point, so that every lane of a warp
  // reaches the shuffles; it writes nothing.
  const bool active = p0 < NP;
  const int p = active ? p0 : NP - 1;  // h * P + point
  const int h = p / P;
  const size_t pt = static_cast<size_t>(bq) * NP + p;
  int idx[4];
  float wb[4], gx[4], gy[4];
  corner_records(loc, pt, H, W, idx, wb, gx, gy);
  const int cell = corner == 0 ? idx[0] : corner == 1 ? idx[1] : corner == 2 ? idx[2] : idx[3];
  const size_t rowlen = static_cast<size_t>(nh) * ch;
  const int nvec = ch / VEC;  // loads of a corner slice, L lanes share them

  float part = 0.0f;
  if (cell >= 0) {
    const T* src = value + (static_cast<size_t>(bq / Q) * H * W + cell) * rowlen + h * ch;
    const T* gr = g + (static_cast<size_t>(bq) * nh + h) * ch;
    for (int v0 = l; v0 < nvec; v0 += kLoads * L) {
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {  // issued together
        const int v = v0 + k * L;
        if (v < nvec) {
          float val[VEC], gv[VEC];
          load_vec(src + v * VEC, val);
          load_vec(gr + v * VEC, gv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) part = fmaf(val[e], gv[e], part);
        }
      }
    }
  }
  for (int o = L / 2; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
  const float A[4] = {part, __shfl_down_sync(kFull, part, L),
                      __shfl_down_sync(kFull, part, 2 * L),
                      __shfl_down_sync(kFull, part, 3 * L)};
  if (active && lane == 0) {
    float dw = 0.0f, dx = 0.0f, dy = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // masked corners have zero weights
      dw = fmaf(wb[c], A[c], dw);
      dx = fmaf(gx[c], A[c], dx);
      dy = fmaf(gy[c], A[c], dy);
    }
    const float a = attn_w[pt];
    d_w[pt] = dw;
    d_loc[2 * pt] = a * static_cast<float>(W) * dx;
    d_loc[2 * pt + 1] = a * static_cast<float>(H) * dy;
  }
}

// 4 channels of T from shared memory, as fp32.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = bf2(u.x), b = bf2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void fma4(float s, float4 g, float4& acc) {
  acc.x = fmaf(s, g.x, acc.x);
  acc.y = fmaf(s, g.y, acc.y);
  acc.z = fmaf(s, g.z, acc.z);
  acc.w = fmaf(s, g.w, acc.w);
}

// 16 bytes of T from fp32 tile values, rounded once.
__device__ __forceinline__ uint4 pack16(const float* p, float) {
  const float4 v = lds4(p);
  return make_uint4(__float_as_uint(v.x), __float_as_uint(v.y),
                    __float_as_uint(v.z), __float_as_uint(v.w));
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack16(const float* p, __nv_bfloat16) {
  const float4 a = lds4(p);
  const float4 b = lds4(p + 4);
  return make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y),
                    bf16x2(b.z, b.w));
}

// Whether slice s of the block's cells has a corner: bit s of s_bits.
__device__ __forceinline__ bool touched(const uint32_t* s_bits, int s) {
  return (s_bits[s >> 5] >> (s & 31)) & 1u;
}

// Exclusive prefix sum of every thread's n over the block, in (warp, lane)
// order; *total gets the sum. s_scan holds kScanInts ints; all threads call.
__device__ __forceinline__ int block_scan(int n, int* s_scan, int* total) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int x = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kDWarps ? s_scan[lane] : 0;
    int y = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += z;
    }
    if (lane < kDWarps) s_scan[lane] = y - v;
    if (lane == 31) s_scan[kDWarps] = y;
  }
  __syncthreads();
  *total = s_scan[kDWarps];
  const int out = s_scan[warp] + x - n;
  __syncthreads();  // s_scan may be used again
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kDThreads, 2)
deform_sample_bwd_dvalue_kernel(const float* __restrict__ loc,
                                const float* __restrict__ attn_w,
                                const T* __restrict__ g,
                                T* __restrict__ d_value, int H, int W, int Q,
                                int nh, int ch, int P, int span, int cap,
                                int vec_store) {
  extern __shared__ float4 smem4[];
  const int HW = H * W;
  const int groups = (HW + span - 1) / span;
  const int b = blockIdx.x / groups;
  const int cell0 = (blockIdx.x - b * groups) * span;  // the block owns the
  const int cell1 = min(cell0 + span, HW);              // cells [cell0, cell1)
  const int rowlen = nh * ch;                           // channels of a cell
  const int rows = Q * nh;                              // g rows of b
  const int NPb = rows * P;                             // sampling points of b
  const int nsl = span * nh;                            // slices of the range
  const int nwords = (nsl + 127) / 128 * 4;
  const int nranks = (min(4 * NPb, nsl) + 3) / 4 * 4;
  float* s_tile = reinterpret_cast<float*>(smem4);                  // (cap, ch)
  unsigned* s_key = reinterpret_cast<unsigned*>(s_tile + cap * ch);  // the list:
  float* s_scale = reinterpret_cast<float*>(s_key + 4 * NPb);        //  key, a * w_c
  int* s_scan = reinterpret_cast<int*>(s_scale + 4 * NPb);           // (kScanInts,)
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_scan + kScanInts);  // (nwords,)
  int* s_wrank = reinterpret_cast<int*>(s_bits + nwords);            // (nwords,)
  int* s_slice = s_wrank + nwords;                                   // (nranks,)
  T* s_g = reinterpret_cast<T*>(s_slice + nranks);                   // (rows, ch)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The tile starts at zero (each slot is zeroed again when it is written),
  // no slice is touched, and b's g rows are staged as stored.
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int ntile = cap * ch;  // cap is a multiple of 16
  for (int i = threadIdx.x; i < ntile / 4; i += kDThreads)
    reinterpret_cast<float4*>(s_tile)[i] = zero;
  for (int i = threadIdx.x; i < nwords; i += kDThreads) s_bits[i] = 0u;
  const int ng = rows * ch;
  const T* gb = g + static_cast<size_t>(b) * ng;
  if ((ng * sizeof(T)) % 16 == 0 && ch % 4 == 0) {  // both sides 16-byte aligned
    for (int i = threadIdx.x; i < static_cast<int>(ng * sizeof(T) / 16); i += kDThreads)
      reinterpret_cast<uint4*>(s_g)[i] = __ldg(reinterpret_cast<const uint4*>(gb) + i);
  } else {
    for (int i = threadIdx.x; i < ng; i += kDThreads) s_g[i] = gb[i];
  }

  // The list: the corners of b that land in the block's cells, in id order
  // (4 * point + corner). Thread t takes points [t * K, (t + 1) * K): it
  // counts its corners, a block scan gives its offset, then it writes them
  // there and sets the bits of their slices.
  const int K = (NPb + kDThreads - 1) / kDThreads;
  const int p0 = min(static_cast<int>(threadIdx.x) * K, NPb);
  const int p1 = min(p0 + K, NPb);
  const size_t pb = static_cast<size_t>(b) * NPb;
  int idx[4];
  float wb[4], gx[4], gy[4];
  int n = 0;
  for (int p = p0; p < p1; ++p) {
    corner_records(loc, pb + p, H, W, idx, wb, gx, gy);
#pragma unroll
    for (int c = 0; c < 4; ++c) n += idx[c] >= cell0 && idx[c] < cell1;
  }
  int total;
  int o = block_scan(n, s_scan, &total);
  for (int p = p0; p < p1; ++p) {
    corner_records(loc, pb + p, H, W, idx, wb, gx, gy);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (idx[c] >= cell0 && idx[c] < cell1) {
        const int row = p / P;  // q * nh + h
        const int sg = (idx[c] - cell0) * nh + (row - (row / nh) * nh);
        s_key[o] = static_cast<unsigned>(sg) | (static_cast<unsigned>(row) << kRowShift);
        s_scale[o] = attn_w[pb + p] * wb[c];
        ++o;
        atomicOr(&s_bits[sg >> 5], 1u << (sg & 31));
      }
    }
  }
  __syncthreads();

  // Every slice of the block's cells that no corner touched is zero: one
  // stream of stores, SV channels (16 bytes) a thread, with no barrier.
  constexpr int SV = 16 / sizeof(T);
  const int cps = ch / SV;  // 16-byte chunks of a slice (vec_store: ch % SV == 0)
  const int lg_cps = (cps & (cps - 1)) == 0 ? __ffs(cps) - 1 : -1;
  T* out_b = d_value + (static_cast<size_t>(b) * HW + cell0) * rowlen;
  if (vec_store) {
    const int nv = (cell1 - cell0) * rowlen / SV;
    for (int i = threadIdx.x; i < nv; i += kDThreads) {
      const int sg = lg_cps >= 0 ? i >> lg_cps : i / cps;
      if (!touched(s_bits, sg)) reinterpret_cast<uint4*>(out_b)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int ne = (cell1 - cell0) * rowlen;
    for (int i = threadIdx.x; i < ne; i += kDThreads) {
      if (!touched(s_bits, i / ch)) from_float(0.0f, out_b + i);
    }
  }

  // Ranks of the touched slices, in slice order: s_wrank[w] counts the
  // touched slices before word w, s_slice[rank] is the slice.
  const int KW = (nwords + kDThreads - 1) / kDThreads;
  const int w0 = min(static_cast<int>(threadIdx.x) * KW, nwords);
  const int w1 = min(w0 + KW, nwords);
  int nw = 0;
  for (int w = w0; w < w1; ++w) nw += __popc(s_bits[w]);
  int ntouched;
  int r = block_scan(nw, s_scan, &ntouched);
  for (int w = w0; w < w1; ++w) {
    s_wrank[w] = r;
    for (uint32_t m = s_bits[w]; m; m &= m - 1) s_slice[r++] = 32 * w + __ffs(m) - 1;
  }
  __syncthreads();

  // Rounds of cap ranks, with no block barrier: warp w owns the ranks with
  // rank % 16 == w (tile slot rank % cap). It walks the list 32 entries a
  // step (ballot, matches in lane order) and sums attn_w * w_c * g of its
  // slices' corners into their slots, lanes owning channel columns; then
  // writes each of its slots once, in T, and zeroes it.
  const bool vec4 = (ch & 3) == 0;
  for (int lo = 0; lo < ntouched; lo += cap) {
    const int hi = min(lo + cap, ntouched);
    for (int base = 0; base < total; base += 32) {
      const int j = base + lane;
      const unsigned key = j < total ? s_key[j] : 0u;
      const float sc = j < total ? s_scale[j] : 0.0f;
      const int sg = static_cast<int>(key & ((1u << kRowShift) - 1));
      const int rank = s_wrank[sg >> 5] + __popc(s_bits[sg >> 5] & ((1u << (sg & 31)) - 1u));
      unsigned m = __ballot_sync(kFull, j < total && rank >= lo && rank < hi &&
                                            (rank & (kDWarps - 1)) == warp);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const unsigned kk = __shfl_sync(kFull, key, src);
        const float ss = __shfl_sync(kFull, sc, src);
        const int slot = __shfl_sync(kFull, rank, src) - lo;
        float* acc = s_tile + slot * ch;
        const T* gr = s_g + (kk >> kRowShift) * ch;
        if (vec4) {
          for (int v = lane; v < ch / 4; v += 32) {
            float4 cur = reinterpret_cast<float4*>(acc)[v];
            fma4(ss, lds4(gr + 4 * v), cur);
            reinterpret_cast<float4*>(acc)[v] = cur;
          }
        } else {
          for (int v = lane; v < ch; v += 32) acc[v] = fmaf(ss, to_float(gr[v]), acc[v]);
        }
      }
    }
    __syncwarp();
    for (int rk = lo + warp; rk < hi; rk += kDWarps) {  // lo is a multiple of 16
      float* acc = s_tile + (rk - lo) * ch;
      T* dst = out_b + static_cast<size_t>(s_slice[rk]) * ch;
      if (vec_store) {
        for (int c = lane; c < cps; c += 32) {
          reinterpret_cast<uint4*>(dst)[c] = pack16(acc + c * SV, T());
#pragma unroll
          for (int z = 0; z < SV; z += 4) reinterpret_cast<float4*>(acc + c * SV)[z / 4] = zero;
        }
      } else {
        for (int v = lane; v < ch; v += 32) {
          from_float(acc[v], dst + v);
          acc[v] = 0.0f;
        }
      }
    }
    __syncwarp();
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int VEC>
int launch(const void* value, const void* loc, const void* attn_w,
           const void* g, void* d_value, float* d_loc, float* d_w, int B,
           int H, int W, int Q, int nh, int ch, int P, int span,
           int cap, int smem_bytes, cudaStream_t stream) {
  // Kernel 1: a group of 4 L lanes per point, L the least power of two
  // (at most 8) with which a lane makes at most kLoads loads of a corner.
  int lg_L = 0;
  while ((kLoads << lg_L) < ch / VEC && lg_L < 3) ++lg_L;
  const int points_per_block = kAThreads >> (lg_L + 2);
  const dim3 grid1(B * Q, (nh * P + points_per_block - 1) / points_per_block);
  deform_sample_bwd_adjoint_kernel<T, VEC><<<grid1, kAThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn_w), static_cast<const T*>(g), d_loc, d_w,
      H, W, Q, nh, ch, P, lg_L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || d_value == nullptr) return static_cast<int>(err);

  // Kernel 2: a block for each run of span cells of each batch element.
  const int groups = (H * W + span - 1) / span;
  const int vec_store = ch % (16 / static_cast<int>(sizeof(T))) == 0 &&
                        reinterpret_cast<uintptr_t>(d_value) % 16 == 0;
  auto* k2 = deform_sample_bwd_dvalue_kernel<T>;
  err = allow_smem(k2, static_cast<size_t>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<B * groups, kDThreads, static_cast<size_t>(smem_bytes), stream>>>(
      static_cast<const float*>(loc), static_cast<const float*>(attn_w),
      static_cast<const T*>(g), static_cast<T*>(d_value), H, W, Q, nh, ch, P,
      span, cap, vec_store);
  return static_cast<int>(cudaGetLastError());
}

// Channels a load of value and g: 16 bytes where every head slice starts on
// a 16-byte boundary, else 8 bytes (bf16) or 4 channels on a 4-channel
// boundary, else 1.
int vector_width(const void* value, int ch, int elem) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(value);
  const int wide = 16 / elem;
  if (ch % wide == 0 && p % 16 == 0) return wide;
  if (ch % 4 == 0 && p % (4 * elem) == 0) return 4;
  return 1;
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// span, cap and smem_bytes: kernel 2's cells a block, tile slots and shared
// memory, from the wrapper. Returns the first CUDA error of the launches (0 on success). The
// caller validates shapes, dtypes, contiguity and shared memory beforehand,
// hands g contiguous with a 16-byte aligned base, and allocates d_value in
// value's dtype (which may be null: that gradient is skipped); every output
// is written in full.
extern "C" int egorear_deform_sample_bwd(
    const void* value, const void* loc, const void* attn_w, const void* g,
    void* d_value, void* d_loc, void* d_w, int B, int H, int W, int Q, int nh,
    int ch, int P, int span, int cap, int smem_bytes, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(d_loc);
  float* dw = static_cast<float*>(d_w);
  if (dtype == 0) {
    const int vec = vector_width(value, ch, 4);
    if (vec == 4)
      return launch<float, 4>(value, loc, attn_w, g, d_value, dl, dw, B, H, W,
                              Q, nh, ch, P, span, cap, smem_bytes, s);
    return launch<float, 1>(value, loc, attn_w, g, d_value, dl, dw, B, H, W, Q,
                            nh, ch, P, span, cap, smem_bytes, s);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const int vec = vector_width(value, ch, 2);
    if (vec == 8)
      return launch<bf16, 8>(value, loc, attn_w, g, d_value, dl, dw, B, H, W,
                             Q, nh, ch, P, span, cap, smem_bytes, s);
    if (vec == 4)
      return launch<bf16, 4>(value, loc, attn_w, g, d_value, dl, dw, B, H, W,
                             Q, nh, ch, P, span, cap, smem_bytes, s);
    return launch<bf16, 1>(value, loc, attn_w, g, d_value, dl, dw, B, H, W, Q,
                           nh, ch, P, span, cap, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
