// Backward of CoDeNet's co-designed depthwise deformable 3x3 convolution,
// stride 1, padding 1, channels-last, for Hopper (sm_90a).
//
// With B_t the bilinear sampling of tap t (p + a_t * s[n, p], s clamped to
// [-7, 8], each corner zeroed outside the map) and g the output cotangent:
//
//   dx[n, q, c] = sum_t sum_p B_t[p, q] * g[n, p, c] * w[t, c]   (col2im)
//   dw[t, c]    = sum_{n, p} g[n, p, c] * (B_t x)[n, p, c]
//   ds[n, p]    = sum_{t != 4} sum_c (D_t x)[n, p, c] * g[n, p, c] * w[t, c]
//
// D_t = dB_t/ds: for the corner (dy, dx) of a tap, its weight wy * wx moves
// by dwy * wx + wy * dwx with dwy = (dy ? +a_i : -a_i), dwx = (dx ? +a_j :
// -a_j). At an integer coordinate that is the one-sided derivative towards
// floor + 1 (that corner possibly off the map), as plain autograd through
// floor() gives it. The centre tap has a = 0 and adds nothing to ds. ds is
// zero where s lies outside (-7, 8) (strict): the op clamps s there.
// x and g are f32 or bf16, read and accumulated in f32; dx is written once
// in x's type; ds and dw are f32, zeroed by the caller.
//
// Replaces the JAX package's ops/deform_pallas.py::_bwd_kernel (and the
// `_bwd` wrapper's ds mask). That kernel built dense (tile x HW) bilinear
// matrices in VMEM and contracted them on the MXU, so col2im became a
// transposed matmul with no atomics, in banded / rolled / channel-chunked
// regimes sized for Mosaic's scoped VMEM. None of that carries over.
//
// What bounds it on an H100: on paper, operations at every model shape.
// Per element of x it does about 251 flops (9 taps x (4-corner sample, gw,
// 4 col2im products and adds, dw FMA) + 8 off-centre taps x (4-corner d/ds,
// ds FMA)); the op has to read x, g, s and w once and write dx (in x's
// type), ds and dw once: 12 bytes per element in f32. At 32 x 8 x 8 x 1024
// f32 that is 7.9 us of f32 CUDA-core operations at 67 TFLOP/s against
// 7.5 us of bytes at 3.35 TB/s (PERF.md has every shape). Below the
// arithmetic sit 36 gathers of x and 36 col2im adds per element: one
// instruction per warp each, over 32 neighbouring channels. The design
// keeps both on the SM (L1 and shared memory), so that neither goes to
// device memory as scattered traffic. What sets its time on the card
// (about 10x the bound, PERF.md): the col2im adds, since a shared-memory
// f32 atomicAdd is a compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN),
// two dependent round trips each; and at the 32 x 32 map the gathers,
// which come from L2 once the tile fills the SM's shared memory.
//
// - one block per (image n, channel slice [c0, c0 + cb)), blockIdx.x =
//   n * slices + slice. A thread owns one channel of the slice and keeps
//   its 9 tap weights and 9 dw partials in registers; the block's threads
//   cover blockDim / cb positions at a time and walk the image's H * W
//   output positions in groups of kGroup. 1024 threads where the block is
//   alone on its SM, else 512 (two blocks to an SM): the 64 registers a
//   thread fill the register file either way;
// - per position, first the 36 gathers (no branch between them, so all
//   are in flight together) with dw and ds, then the 36 col2im adds;
// - dx: the block's slice of dx for the whole image is an f32 tile
//   [H * W][cb] in dynamic shared memory (neighbouring channels in
//   neighbouring banks). Each col2im term goes there by a shared-memory
//   atomicAdd; at the end the block writes the tile once to
//   dx[n, :, c0:c0+cb] in x's type, coalesced over channels. No other
//   block writes that slice, so dx needs no zeroing, no global atomics and
//   no cast pass. s's clamp bounds a tap's reach at +-9 rows, but the
//   main path's maps have at most 32 rows: the tile is the whole image;
// - x stays in device memory and is gathered through __ldg: the block's
//   slice of x is as large as its tile, and the 36 reads per element hit
//   L1 / L2;
// - geometry: per group, the 9 x 4 corner indices, weights and
//   d(weight)/ds of each position, computed once per block into shared
//   memory (s is shared by all channels);
// - ds: each position's partial is reduced over the slice's channels (a
//   warp shuffle of width min(cb, 32), then one shared atomicAdd per warp
//   segment), masked to (-7, 8), and added to ds with one global atomicAdd
//   per (position, slice);
// - dw: the per-thread partials are reduced over the block's position
//   lanes in shared memory, then one global atomicAdd per (block, tap,
//   channel).
// The launch plan (cb, threads, shared bytes; the grid follows) is
// ops/deform_cuda.py::bwd_plan's; this file checks it against its layout.
//
// Plain C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() after the launch.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 9;
constexpr int kCenter = 4;
constexpr int kCorners = 4;
constexpr int kGeo = kTaps * kCorners;  // corners per position
constexpr int kGroup = 64;              // positions per geometry group
constexpr int kMaxThreads = 1024;     // so 64 registers a thread at most
constexpr int kSmemBudget = 232448;     // a block's shared memory on sm_90
constexpr float kSLo = -7.0f;
constexpr float kSHi = 8.0f;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A block's dynamic shared memory, in this order: the geometry of one
// group (per position and tap, the 4 corners' indices, weights and
// d(weight)/ds as one int4 and two float4s); the group's ds partials; the
// slice's dw partials [9][cb]; the dx tile [hw][cb]. 4 bytes each.
long long smem_bytes(int hw, int cb) {
  return 4LL * (kGroup * (3 * kGeo + 1) + kTaps * cb
                + static_cast<long long>(hw) * cb);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
codesign_deform_bwd_kernel(const T* __restrict__ x, const float* __restrict__ s,
                           const T* __restrict__ g, const float* __restrict__ w,
                           T* __restrict__ dx, float* __restrict__ ds,
                           float* __restrict__ dw, int h, int wd, int c,
                           int cb, int slices) {
  extern __shared__ float4 smem[];
  const int hw = h * wd;
  int4* geo_idx = reinterpret_cast<int4*>(smem);  // [kGroup * 9]
  float4* geo_wgt = smem + kGroup * kTaps;
  float4* geo_dwgt = geo_wgt + kGroup * kTaps;
  float* grp_ds = reinterpret_cast<float*>(geo_dwgt + kGroup * kTaps);
  float* slice_dw = grp_ds + kGroup;
  float* tile = slice_dw + kTaps * cb;

  const int log_cb = __ffs(cb) - 1;
  const int n = blockIdx.x / slices;
  const int c0 = (blockIdx.x % slices) * cb;
  const int cl = threadIdx.x & (cb - 1);
  const int lane_pos = threadIdx.x >> log_cb;
  const int lanes = blockDim.x >> log_cb;
  const int ch = c0 + cl;
  const bool active = ch < c;
  const int width = cb < 32 ? cb : 32;  // threads of one position in a warp
  const long long img = static_cast<long long>(n) * hw;
  const T* ximg = x + img * c + (active ? ch : 0);
  const T* gimg = g + img * c + (active ? ch : 0);

  for (int i = threadIdx.x; i < hw * cb; i += blockDim.x) tile[i] = 0.f;
  for (int i = threadIdx.x; i < kTaps * cb; i += blockDim.x) {
    slice_dw[i] = 0.f;
  }

  float wt[kTaps];
  float dw_acc[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    wt[t] = active ? w[t * c + ch] : 0.f;
    dw_acc[t] = 0.f;
  }

  for (int p0 = 0; p0 < hw; p0 += kGroup) {
    // Geometry: one (position, tap) pair per thread; e == pi * 9 + t.
    for (int e = threadIdx.x; e < kGroup * kTaps; e += blockDim.x) {
      const int pi = e / kTaps;
      const int t = e % kTaps;
      const int p = p0 + pi;
      int idx[kCorners] = {0, 0, 0, 0};
      float wgt[kCorners] = {0.f, 0.f, 0.f, 0.f};
      float dwgt[kCorners] = {0.f, 0.f, 0.f, 0.f};
      if (p < hw) {
        const float py = static_cast<float>(p / wd);
        const float px = static_cast<float>(p % wd);
        const float sv = fminf(fmaxf(s[img + p], kSLo), kSHi);
        const float ai = static_cast<float>(t / 3 - 1);
        const float aj = static_cast<float>(t % 3 - 1);
        const float sy = py + ai * sv;  // a * s is exact: a in {-1, 0, 1}
        const float sx = px + aj * sv;
        const float y0f = floorf(sy);
        const float x0f = floorf(sx);
        const float fy = sy - y0f;
        const float fx = sx - x0f;
        const int y0 = static_cast<int>(y0f);
        const int x0 = static_cast<int>(x0f);
#pragma unroll
        for (int k = 0; k < kCorners; ++k) {
          const int dy = k >> 1;
          const int dxk = k & 1;
          const int yy = y0 + dy;
          const int xx = x0 + dxk;
          if (yy >= 0 && yy < h && xx >= 0 && xx < wd) {
            const float wy = dy ? fy : 1.0f - fy;
            const float wx = dxk ? fx : 1.0f - fx;
            const float dwy = dy ? ai : -ai;
            const float dwx = dxk ? aj : -aj;
            idx[k] = yy * wd + xx;
            wgt[k] = wy * wx;
            dwgt[k] = dwy * wx + wy * dwx;
          }
        }
      }
      geo_idx[e] = make_int4(idx[0], idx[1], idx[2], idx[3]);
      geo_wgt[e] = make_float4(wgt[0], wgt[1], wgt[2], wgt[3]);
      geo_dwgt[e] = make_float4(dwgt[0], dwgt[1], dwgt[2], dwgt[3]);
    }
    for (int i = threadIdx.x; i < kGroup; i += blockDim.x) grp_ds[i] = 0.f;
    __syncthreads();

    // kGroup is a multiple of lanes: every thread of a warp takes the same
    // number of turns, as the shuffle below needs.
    for (int pi = lane_pos; pi < kGroup; pi += lanes) {
      const int p = p0 + pi;
      float ds_part = 0.f;
      if (active && p < hw) {
        const float gv = load(gimg + static_cast<long long>(p) * c);
        // Gathers first: 36 loads with no branch between them, all in
        // flight at once; dw and ds from them.
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          // one 16-byte broadcast read each for the tap's 4 corners
          const int4 q4 = geo_idx[pi * kTaps + t];
          const float4 w4 = geo_wgt[pi * kTaps + t];
          const float4 d4 = t != kCenter ? geo_dwgt[pi * kTaps + t]
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          const int idx[kCorners] = {q4.x, q4.y, q4.z, q4.w};
          const float wgts[kCorners] = {w4.x, w4.y, w4.z, w4.w};
          const float dwgts[kCorners] = {d4.x, d4.y, d4.z, d4.w};
          float sample = 0.f;
          float dsample = 0.f;
#pragma unroll
          for (int k = 0; k < kCorners; ++k) {
            const float xv = load(ximg + static_cast<long long>(idx[k]) * c);
            sample += wgts[k] * xv;
            if (t != kCenter) dsample += dwgts[k] * xv;
          }
          dw_acc[t] += gv * sample;
          if (t != kCenter) ds_part += gv * wt[t] * dsample;
        }
        // Then col2im into the tile. Each shared f32 atomicAdd is a
        // compare-and-swap loop on sm_90a: kept apart from the gathers, so
        // that its branches do not hold the loads back.
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const int4 q4 = geo_idx[pi * kTaps + t];
          const float4 w4 = geo_wgt[pi * kTaps + t];
          const int idx[kCorners] = {q4.x, q4.y, q4.z, q4.w};
          const float wgts[kCorners] = {w4.x, w4.y, w4.z, w4.w};
          const float gw = gv * wt[t];
#pragma unroll
          for (int k = 0; k < kCorners; ++k) {
            // the weight is the same for every channel of a position
            if (wgts[k] != 0.f) {
              atomicAdd(tile + (idx[k] << log_cb) + cl, gw * wgts[k]);
            }
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        if (off < width) {
          ds_part += __shfl_xor_sync(0xffffffffu, ds_part, off, width);
        }
      }
      if ((threadIdx.x & (width - 1)) == 0) atomicAdd(grp_ds + pi, ds_part);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kGroup; i += blockDim.x) {
      const int p = p0 + i;
      if (p < hw) {
        const float sv = s[img + p];
        if (sv > kSLo && sv < kSHi) atomicAdd(ds + img + p, grp_ds[i]);
      }
    }
    __syncthreads();  // the next group overwrites the geometry and grp_ds
  }

  // The tile is complete (the walk ended on a barrier): write it once.
  for (int i = threadIdx.x; i < hw * cb; i += blockDim.x) {
    const int cc = c0 + (i & (cb - 1));
    if (cc < c) {
      store(dx + (img + (i >> log_cb)) * c + cc, tile[i]);
    }
  }
  if (active) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      atomicAdd(slice_dw + t * cb + cl, dw_acc[t]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTaps * cb; i += blockDim.x) {
    const int cc = c0 + (i & (cb - 1));
    if (cc < c) atomicAdd(dw + (i >> log_cb) * c + cc, slice_dw[i]);
  }
}

template <typename T>
int launch(const void* x, const void* s, const void* g, const void* w,
           void* dx, void* ds, void* dw, int h, int wd, int c, int cb,
           int threads, int smem, int slices, long long blocks,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      codesign_deform_bwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  codesign_deform_bwd_kernel<T><<<static_cast<unsigned int>(blocks), threads,
                                  smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const T*>(g), static_cast<const float*>(w),
      static_cast<T*>(dx), static_cast<float*>(ds), static_cast<float*>(dw),
      h, wd, c, cb, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, g: (n, h, wd, c) contiguous in that
// type; s: (n, h, wd) float32; w: (9, c) float32 tap weights, row-major
// taps. dx (n, h, wd, c) in x's type, written whole; ds (n, h, wd) and dw
// (9, c): float32, zeroed by the caller. cb, threads, smem: the launch plan
// (ops/deform_cuda.py::bwd_plan): cb a power of two, threads a multiple of
// 32 and of cb with threads / cb dividing kGroup, smem as smem_bytes gives
// it, within the budget.
extern "C" int codesign_deform_bwd(const void* x, const void* s,
                                   const void* g, const void* w, void* dx,
                                   void* ds, void* dw, int n, int h, int wd,
                                   int c, int dtype, int cb, int threads,
                                   int smem, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || cb <= 0 || (cb & (cb - 1))
      || threads <= 0 || threads > kMaxThreads || threads % 32
      || threads % cb || kGroup % (threads / cb)
      || static_cast<long long>(h) * wd > INT_MAX / cb
      || smem != smem_bytes(h * wd, cb) || smem > kSmemBudget) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slices = (c + cb - 1) / cb;
  const long long blocks = static_cast<long long>(n) * slices;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, s, g, w, dx, ds, dw, h, wd, c, cb, threads, smem,
                         slices, blocks, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, s, g, w, dx, ds, dw, h, wd, c, cb,
                                 threads, smem, slices, blocks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
