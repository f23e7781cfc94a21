// Forward of CoDeNet's co-designed depthwise deformable 3x3 convolution,
// stride 1, padding 1, channels-last, for Hopper (sm_90a).
//
//   out[n, p, c] = sum_t w[t, c] * bilinear(x[n, :, :, c], p + a_t * s[n, p])
//
// a_t in {-1, 0, 1}^2 row-major, s clamped to [-7, 8], each of the four
// bilinear corners zeroed separately outside the map, f32 accumulation,
// output in the input's type (f32 or bf16).
//
// Replaces the JAX package's ops/deform_pallas.py::_fwd_kernel. That kernel
// turned the gather into dense (tile x HW) interpolation matrices built in
// VMEM and contracted on the MXU, because a TPU has no fast gather; its
// banded / rolled / channel-chunked regimes exist for Mosaic's scoped VMEM
// and the 128x128 systolic array. None of that carries over.
//
// What bounds it on an H100: memory. Per output element the kernel does
// 9 taps x 4 corners (about 90 flops) and moves one input and one output
// element; at 3.35 TB/s the bytes take longer than the flops at the fp32
// CUDA-core rate for every shape the model uses (PERF.md). The 36 reads per
// output element hit only the 3x3 * |s| neighbourhood of p, so after the
// first touch they come from L1/L2, and device memory sees each x element
// about once.
//
// Design, for that bound:
// - one block takes kPos consecutive output positions of the flattened
//   (N * H * W) grid; s is shared by all channels, so the 9 taps' 4 corner
//   offsets and weights are computed once per position into shared memory;
// - its threads then stride over C: neighbouring threads read neighbouring
//   channels of x[n, q, :] (C is contiguous), so every gather is coalesced;
// - each thread keeps its 9 tap weights in registers across the kPos
//   positions, accumulates in f32 and writes the output coalesced.
// Invalid corners carry weight 0 and index 0, so the inner loop has no
// branch. Tensor cores, TMA and vectorised loads are left for later work.
//
// Plain C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 9;
constexpr int kCorners = 4;
constexpr int kPos = 8;  // output positions per block
constexpr float kSLo = -7.0f;
constexpr float kSHi = 8.0f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void codesign_deform_fwd_kernel(const T* __restrict__ x,
                                           const float* __restrict__ s,
                                           const float* __restrict__ w,
                                           T* __restrict__ out, int h, int wd,
                                           int c, long long total) {
  __shared__ int s_idx[kPos][kTaps][kCorners];
  __shared__ float s_wgt[kPos][kTaps][kCorners];

  const int hw = h * wd;
  const long long pos0 = static_cast<long long>(blockIdx.x) * kPos;

  // Geometry: one (position, tap) pair per thread.
  for (int e = threadIdx.x; e < kPos * kTaps; e += blockDim.x) {
    const int pi = e / kTaps;
    const int t = e % kTaps;
    const long long pos = pos0 + pi;
    int idx[kCorners] = {0, 0, 0, 0};
    float wgt[kCorners] = {0.f, 0.f, 0.f, 0.f};
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
        const int dx = k & 1;
        const int yy = y0 + dy;
        const int xx = x0 + dx;
        if (yy >= 0 && yy < h && xx >= 0 && xx < wd) {
          idx[k] = yy * wd + xx;
          wgt[k] = (dy ? fy : 1.0f - fy) * (dx ? fx : 1.0f - fx);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCorners; ++k) {
      s_idx[pi][t][k] = idx[k];
      s_wgt[pi][t][k] = wgt[k];
    }
  }
  __syncthreads();

  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float wt[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) wt[t] = w[t * c + ch];
    for (int pi = 0; pi < kPos; ++pi) {
      const long long pos = pos0 + pi;
      if (pos >= total) break;
      const T* img = x + (pos / hw) * hw * static_cast<long long>(c) + ch;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < kCorners; ++k) {
          v += s_wgt[pi][t][k] *
               to_float(img[static_cast<long long>(s_idx[pi][t][k]) * c]);
        }
        acc += wt[t] * v;
      }
      store(out + pos * c + ch, acc);
    }
  }
}

template <typename T>
void launch(const void* x, const void* s, const void* w, void* out, int n,
            int h, int wd, int c, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * h * wd;
  const int threads = c >= 256 ? 256 : ((c + 31) / 32) * 32;
  const long long blocks = (total + kPos - 1) / kPos;
  codesign_deform_fwd_kernel<T><<<static_cast<unsigned int>(blocks), threads,
                                  0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<T*>(out), h, wd, c, total);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: (n, h, wd, c) contiguous;
// s: (n, h, wd) float32; w: (9, c) float32 tap weights, row-major taps.
extern "C" int codesign_deform_fwd(const void* x, const void* s,
                                   const void* w, void* out, int n, int h,
                                   int wd, int c, int dtype, void* stream) {
  const long long blocks =
      (static_cast<long long>(n) * h * wd + kPos - 1) / kPos;
  if (blocks <= 0 || c <= 0 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, s, w, out, n, h, wd, c, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, s, w, out, n, h, wd, c, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
