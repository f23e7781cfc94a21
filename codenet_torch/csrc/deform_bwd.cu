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
// dx, ds and dw are f32; the caller zeroes them and casts dx back to x's
// type. Inputs x and g are f32 or bf16, read and accumulated in f32.
//
// Replaces the JAX package's ops/deform_pallas.py::_bwd_kernel (and the
// `_bwd` wrapper's ds mask). That kernel built dense (tile x HW) bilinear
// matrices in VMEM and contracted them on the MXU, so col2im became a
// transposed matmul with no atomics, in banded / rolled / channel-chunked
// regimes sized for Mosaic's scoped VMEM. None of that carries over.
//
// What bounds it on an H100: on paper, operations at the model's deepest
// shape. Per element of x it does about 251 flops (9 taps x (4-corner
// sample, gw, 4 col2im products and adds, dw FMA) + 8 off-centre taps x
// (4-corner d/ds, ds FMA)); the op has to read x, g, s and w once and write
// dx (in x's type), ds and dw once. At 32 x 8 x 8 x 1024 f32 that is
// 25.3 MB and 0.53 GFLOP: 7.5 us of bytes at 3.35 TB/s against 7.9 us of
// f32 CUDA-core operations at 67 TFLOP/s (PERF.md has every shape). The
// f32 dx buffer, its zeroing and the cast are this design's own cost, not
// the op's, and count in its measured time only.
// In practice the 36 scattered atomicAdds per element into dx set its time.
//
// Design, simple and correct first:
// - blockIdx.y picks a slice of blockDim.x channels, one per thread, so a
//   thread owns one channel and keeps its 9 tap weights and its 9 dw
//   partial sums in registers; blockIdx.x walks groups of kPos consecutive
//   output positions of the flattened (N * H * W) grid, grid-stride;
// - per group, the 9 x 4 corner indices, weights and d(weight)/ds of each
//   position are computed once into shared memory (s is shared by all
//   channels);
// - dx: one atomicAdd per non-zero corner weight into the zeroed f32
//   buffer (neighbouring threads hit neighbouring channels: coalesced);
// - dw: one atomicAdd per (block, tap, channel) at the end;
// - ds: each position's partial over this block's channels is reduced with
//   warp shuffles and shared memory, masked, and added with one atomicAdd
//   (several channel slices may share a position).
// Banding dx in shared memory, vector atomics, wgmma and TMA are later work.
//
// Plain C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 9;
constexpr int kCenter = 4;
constexpr int kCorners = 4;
constexpr int kPos = 8;        // output positions per group
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kTargetBlocks = 132 * 4;  // a few blocks per SM
constexpr float kSLo = -7.0f;
constexpr float kSHi = 8.0f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
codesign_deform_bwd_kernel(const T* __restrict__ x, const float* __restrict__ s,
                           const T* __restrict__ g, const float* __restrict__ w,
                           float* __restrict__ dx, float* __restrict__ ds,
                           float* __restrict__ dw, int h, int wd, int c,
                           long long total, long long groups) {
  __shared__ int s_idx[kPos][kTaps][kCorners];
  __shared__ float s_wgt[kPos][kTaps][kCorners];
  __shared__ float s_dwgt[kPos][kTaps][kCorners];
  __shared__ float s_mask[kPos];
  __shared__ float s_red[kMaxWarps][kPos];

  const int hw = h * wd;
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = ch < c;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  float wt[kTaps];
  float dw_acc[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    wt[t] = active ? w[t * c + ch] : 0.f;
    dw_acc[t] = 0.f;
  }

  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long pos0 = grp * kPos;

    // Geometry: one (position, tap) pair per thread.
    for (int e = threadIdx.x; e < kPos * kTaps; e += blockDim.x) {
      const int pi = e / kTaps;
      const int t = e % kTaps;
      const long long pos = pos0 + pi;
      int idx[kCorners] = {0, 0, 0, 0};
      float wgt[kCorners] = {0.f, 0.f, 0.f, 0.f};
      float dwgt[kCorners] = {0.f, 0.f, 0.f, 0.f};
      if (pos < total) {
        const int p = static_cast<int>(pos % hw);
        const float py = static_cast<float>(p / wd);
        const float px = static_cast<float>(p % wd);
        const float sv = fminf(fmaxf(s[pos], kSLo), kSHi);
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
#pragma unroll
      for (int k = 0; k < kCorners; ++k) {
        s_idx[pi][t][k] = idx[k];
        s_wgt[pi][t][k] = wgt[k];
        s_dwgt[pi][t][k] = dwgt[k];
      }
    }
    if (threadIdx.x < kPos) {
      const long long pos = pos0 + threadIdx.x;
      const float sv = pos < total ? s[pos] : 0.f;
      s_mask[threadIdx.x] =
          (pos < total && sv > kSLo && sv < kSHi) ? 1.f : 0.f;
    }
    __syncthreads();

    float ds_loc[kPos];
#pragma unroll
    for (int pi = 0; pi < kPos; ++pi) {
      ds_loc[pi] = 0.f;
      const long long pos = pos0 + pi;
      if (active && pos < total) {
        const long long base = (pos / hw) * hw * static_cast<long long>(c);
        const T* img = x + base + ch;
        float* dimg = dx + base + ch;
        const float gv = to_float(g[pos * c + ch]);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const float gw = gv * wt[t];
          float sample = 0.f;
          float dsample = 0.f;
#pragma unroll
          for (int k = 0; k < kCorners; ++k) {
            const float wgt = s_wgt[pi][t][k];
            const long long off =
                static_cast<long long>(s_idx[pi][t][k]) * c;
            const float xv = to_float(img[off]);
            sample += wgt * xv;
            if (t != kCenter) dsample += s_dwgt[pi][t][k] * xv;
            // the weight is the same for every channel: no divergence
            if (wgt != 0.f) atomicAdd(dimg + off, gw * wgt);
          }
          dw_acc[t] += gv * sample;
          if (t != kCenter) ds_loc[pi] += gw * dsample;
        }
      }
    }

    // ds: reduce each position's partial over the block's channels.
#pragma unroll
    for (int pi = 0; pi < kPos; ++pi) {
      const float v = warp_sum(ds_loc[pi]);
      if (lane == 0) s_red[warp][pi] = v;
    }
    __syncthreads();
    if (threadIdx.x < kPos) {
      const long long pos = pos0 + threadIdx.x;
      float v = 0.f;
      for (int k = 0; k < nwarps; ++k) v += s_red[k][threadIdx.x];
      if (pos < total && s_mask[threadIdx.x] != 0.f) atomicAdd(ds + pos, v);
    }
    __syncthreads();  // the next group overwrites the shared geometry
  }

  if (active) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) atomicAdd(dw + t * c + ch, dw_acc[t]);
  }
}

template <typename T>
void launch(const void* x, const void* s, const void* g, const void* w,
            void* dx, void* ds, void* dw, int n, int h, int wd, int c,
            cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * h * wd;
  const long long groups = (total + kPos - 1) / kPos;
  const int threads = c >= kMaxThreads ? kMaxThreads : ((c + 31) / 32) * 32;
  const int slices = (c + threads - 1) / threads;
  long long gx = kTargetBlocks / slices;
  if (gx < 1) gx = 1;
  if (gx > groups) gx = groups;
  const dim3 grid(static_cast<unsigned int>(gx),
                  static_cast<unsigned int>(slices));
  codesign_deform_bwd_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const T*>(g), static_cast<const float*>(w),
      static_cast<float*>(dx), static_cast<float*>(ds),
      static_cast<float*>(dw), h, wd, c, total, groups);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, g: (n, h, wd, c) contiguous in that
// type; s: (n, h, wd) float32; w: (9, c) float32 tap weights, row-major
// taps. dx (n, h, wd, c), ds (n, h, wd) and dw (9, c): float32, zeroed by
// the caller.
extern "C" int codesign_deform_bwd(const void* x, const void* s,
                                   const void* g, const void* w, void* dx,
                                   void* ds, void* dw, int n, int h, int wd,
                                   int c, int dtype, void* stream) {
  const long long total = static_cast<long long>(n) * h * wd;
  if (total <= 0 || c <= 0 || (c + kMaxThreads - 1) / kMaxThreads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, s, g, w, dx, ds, dw, n, h, wd, c, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, s, g, w, dx, ds, dw, n, h, wd, c, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
