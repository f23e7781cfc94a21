// Backward of a depthwise 3x3 convolution, padding 1, stride 1 or 2,
// channels-last f32, for Hopper (sm_90a): dx, dW and db from one pass
// over x and dy.
//
// With y[n, oy, ox, c] = sum_{ky, kx} x[n, s*oy - 1 + ky, s*ox - 1 + kx, c]
// * w[c, ky, kx] (+ b[c]) and dy its cotangent:
//
//   dx[n, iy, ix, c] = sum over the taps with (iy + 1 - ky) and
//                      (ix + 1 - kx) multiples of s of
//                      dy[n, (iy + 1 - ky) / s, (ix + 1 - kx) / s, c]
//                      * w[c, ky, kx]
//   dW[c, ky, kx]    = sum_{n, oy, ox} dy[n, oy, ox, c]
//                      * x[n, s*oy - 1 + ky, s*ox - 1 + kx, c]
//   db[c]            = sum_{n, oy, ox} dy[n, oy, ox, c]
//
// It replaces no TPU kernel: the JAX package leaves the depthwise convs'
// VJP to XLA. It replaces the three engines cuDNN ran for these convs'
// backward in the port's train step (a dgrad and two wgrads, which read
// x and dy once for dW and dy again for dx).
//
// What bounds it on an H100: bytes. dx and dW need x and dy read once
// and dx written once (12 bytes per element of x at stride 1); the 18
// FMAs per element are 0.04 ms of f32 CUDA-core time over config d's 20
// convs at batch 32 against 1.23 ms of bytes at 3.35 TB/s. The design
// moves each of those bytes between device memory and the SM once:
//
// - one block per (image n, band of `rows` output rows, channel slice
//   [c0, c0 + cb)); blockIdx.x = (n * bands + band) * slices + slice, so
//   that the slices of one band, which share its rows' sectors, run
//   together;
// - the block stages its band's dy rows (rows + 1, and one more above at
//   stride 1) and x rows (stride * (rows - 1) + 3 of them, the halo
//   included) into shared memory with cp.async, in that order and as two
//   groups (dx, which reads dy alone, runs while x arrives), as vectors
//   of `vec` channels (16 bytes, or 8 or 4 where c or the addresses ask),
//   zero-filled outside the map and past c: a one-position frame on both
//   sides makes every tap read in bounds, so the loops carry no masks;
// - dx: a thread owns an input column (at stride 2 a pair of columns)
//   and a channel vector and walks the band's input rows down, keeping a
//   3 x 3 window of dy (at stride 2 the 2 x 2 that a 2 x 2 group of dx
//   reads: each tap set picked by the rows' and columns' parity) in
//   registers, so a step reads one row of new dy from shared memory and
//   writes dx once, coalesced over channels. Bands own disjoint dx rows:
//   no atomics, no zeroing;
// - dW and db: a thread owns an output column and a channel vector and
//   walks the band's output rows, a 3 x 3 window of x in registers, the
//   9 tap sums and the bias sum in registers; then a butterfly of warp
//   shuffles and a fixed-order sum over the warps in shared memory give
//   the block's partials, written once to part[n * bands + band][k][c];
// - a second, small kernel sums those partials over the images and
//   bands in a fixed order into dW (c, 9) and db (c): no atomics
//   anywhere, so two runs give equal bits.
//
// The launch plan (vec, cb, rows, threads, shared bytes; the grid
// follows) is ops/dwconv_cuda.py::dw_bwd_plan's; this file checks it
// against its layout. Plain C interface for ctypes: pointers and the
// stream as void*, returns cudaGetLastError() after the launches.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // so 128 registers a thread at most
constexpr int kMaxSlice = 32;  // a slice's vectors at most
constexpr int kTaps = 9;
constexpr int kSums = kTaps + 1;  // the 9 tap sums, then the bias sum
constexpr int kReduceGroups = 8;  // warps of the reduction kernel
constexpr int kSmemBudget = 232448;  // a block's shared memory on sm_90

template <int V>
struct Pack {
  float v[V];
};

template <int V>
__device__ __forceinline__ Pack<V> lds(const float* p) {
  Pack<V> r;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r.v[0] = t.x; r.v[1] = t.y;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void stg(float* p, const Pack<V>& a) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2],
                                                a.v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a.v[0], a.v[1]);
  } else {
    *p = a.v[0];
  }
}

// d = sum of a[i] * w[i] over the channels of one vector, with w the
// tap's weights of those channels
template <int V>
__device__ __forceinline__ void fma_tap(Pack<V>& d, const Pack<V>& a,
                                        const float (&w)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) d.v[j] = fmaf(a.v[j], w[j], d.v[j]);
}

// one vector of `bytes` from global to shared memory; zeros where !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `PENDING` committed groups are still in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Dynamic shared memory of a block, f32: the x tile [xrows][w + 2][cb]
// and the dy tile [dyrows][wo + 2][cb]; after the passes the same bytes
// hold the dW partials of each thread group [groups][kSums][cb].
long long smem_bytes(int wd, int wo, int cb, int vec, int rows, int stride,
                     int threads) {
  const long long tiles =
      static_cast<long long>(stride * (rows - 1) + 3) * (wd + 2)
      + static_cast<long long>(rows + 1 + (stride == 1)) * (wo + 2);
  const int groups = threads / std::max(cb / vec, 32);
  const long long red = static_cast<long long>(groups) * kSums;
  return 4LL * cb * (tiles > red ? tiles : red);
}

template <int V, int S>
__global__ void __launch_bounds__(kMaxThreads, 2)
dwconv_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  const float* __restrict__ w, float* __restrict__ dx,
                  float* __restrict__ part, int h, int wd, int c, int ho,
                  int wo, int cb, int rows, int bands, int slices) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kDy0 = S == 1 ? 1 : 0;  // dy rows staged above the band
  const int cbv = cb / V;
  const int slice = blockIdx.x % slices;
  const int band = (blockIdx.x / slices) % bands;
  const int img = blockIdx.x / (slices * bands);
  const int c0 = slice * cb;
  const int o0 = band * rows;
  const int nr = min(rows, ho - o0);  // output rows of this band
  const int xrows = S * (nr - 1) + 3;
  const int xcols = wd + 2;
  const int dyrows = nr + 1 + kDy0;
  const int dycols = wo + 2;
  float* xs = smem;
  float* dys = smem + static_cast<long long>(xrows) * xcols * cb;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const long long x_img = static_cast<long long>(img) * h * wd * c;
  const long long dy_img = static_cast<long long>(img) * ho * wo * c;

  // stage the dy rows [o0 - kDy0, o0 + nr], then the x rows
  // [S*o0 - 1, S*(o0 + nr - 1) + 1], each with a zero column on both
  // sides, as two groups: dx needs only the first, so it runs while the
  // second is in flight
  for (int i = t; i < dyrows * dycols * cbv; i += nt) {
    const int v = i % cbv;
    const int pos = i / cbv;
    const int oy = o0 - kDy0 + pos / dycols;
    const int ox = pos % dycols - 1;
    const int ch = c0 + v * V;
    const bool ok = oy >= 0 && oy < ho && ox >= 0 && ox < wo && ch < c;
    const float* src =
        ok ? dy + dy_img + (static_cast<long long>(oy) * wo + ox) * c + ch
           : dy;
    cp_async<4 * V>(dys + static_cast<long long>(pos) * cb + v * V, src, ok);
  }
  cp_async_commit();
  for (int i = t; i < xrows * xcols * cbv; i += nt) {
    const int v = i % cbv;
    const int pos = i / cbv;
    const int iy = S * o0 - 1 + pos / xcols;
    const int ix = pos % xcols - 1;
    const int ch = c0 + v * V;
    const bool ok = iy >= 0 && iy < h && ix >= 0 && ix < wd && ch < c;
    const float* src =
        ok ? x + x_img + (static_cast<long long>(iy) * wd + ix) * c + ch : x;
    cp_async<4 * V>(xs + static_cast<long long>(pos) * cb + v * V, src, ok);
  }
  cp_async_commit();

  // the thread's channel vector (nt is a multiple of cbv, so it is
  // the same for every item the thread takes) and its 9 tap weights
  const int v = t % cbv;
  const int ch = c0 + v * V;
  const bool ch_ok = ch < c;
  float wk[kTaps][V];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      wk[k][j] = ch + j < c ? __ldg(w + static_cast<long long>(ch + j)
                                    * kTaps + k) : 0.0f;
    }
  }
  cp_async_wait<1>();  // the dy tile
  __syncthreads();

  auto dy_at = [&](int r, int col) {  // dy tile row r, column col
    return lds<V>(dys + (static_cast<long long>(r) * dycols + col) * cb
                  + v * V);
  };
  auto x_at = [&](int r, int col) {
    return lds<V>(xs + (static_cast<long long>(r) * xcols + col) * cb
                  + v * V);
  };
  auto dx_at = [&](int iy, int ix) {
    return dx + x_img + (static_cast<long long>(iy) * wd + ix) * c + ch;
  };

  // dx of the band's input rows
  if constexpr (S == 1) {
    // dx[iy][ix] = sum a[dr][dc] * w[2 - dr][2 - dc] with a[dr][dc] the
    // dy tile at row iy - o0 + dr, column ix + dc
    for (int item = t; item < wd * cbv; item += nt) {
      const int ix = item / cbv;
      Pack<V> a[3][3];
#pragma unroll
      for (int dr = 0; dr < 2; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) a[dr][dc] = dy_at(dr, ix + dc);
      }
      for (int r = 0; r < nr; ++r) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) a[2][dc] = dy_at(r + 2, ix + dc);
        Pack<V> d = {};
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            fma_tap(d, a[dr][dc], wk[(2 - dr) * 3 + 2 - dc]);
          }
        }
        if (ch_ok) stg(dx_at(o0 + r, ix), d);
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          a[0][dc] = a[1][dc];
          a[1][dc] = a[2][dc];
        }
      }
    }
  } else {
    // a 2 x 2 group of dx, rows 2m, 2m + 1 and columns 2j, 2j + 1, reads
    // dy rows m, m + 1 and columns j, j + 1 (p: row m, q: row m + 1)
    for (int item = t; item < wo * cbv; item += nt) {
      const int j = item / cbv;
      const bool odd_col = 2 * j + 1 < wd;
      Pack<V> p0 = dy_at(0, j + 1), p1 = dy_at(0, j + 2);
      for (int r = 0; r < nr; ++r) {
        const Pack<V> q0 = dy_at(r + 1, j + 1), q1 = dy_at(r + 1, j + 2);
        const int iy = 2 * (o0 + r);
        Pack<V> d = {};
        fma_tap(d, p0, wk[4]);
        if (ch_ok) stg(dx_at(iy, 2 * j), d);
        if (odd_col) {
          d = Pack<V>{};
          fma_tap(d, p1, wk[3]);
          fma_tap(d, p0, wk[5]);
          if (ch_ok) stg(dx_at(iy, 2 * j + 1), d);
        }
        if (iy + 1 < h) {
          d = Pack<V>{};
          fma_tap(d, q0, wk[1]);
          fma_tap(d, p0, wk[7]);
          if (ch_ok) stg(dx_at(iy + 1, 2 * j), d);
          if (odd_col) {
            d = Pack<V>{};
            fma_tap(d, q1, wk[0]);
            fma_tap(d, q0, wk[2]);
            fma_tap(d, p1, wk[6]);
            fma_tap(d, p0, wk[8]);
            if (ch_ok) stg(dx_at(iy + 1, 2 * j + 1), d);
          }
        }
        p0 = q0;
        p1 = q1;
      }
    }
  }

  cp_async_wait<0>();  // the x tile
  __syncthreads();

  // dW and db: acc[ky * 3 + kx] += dy[oy][ox] * x tile at row
  // S * (oy - o0) + ky, column S * ox + kx; acc[9] += dy[oy][ox]
  float acc[kSums][V];
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.0f;
  }
  for (int item = t; item < wo * cbv; item += nt) {
    const int ox = item / cbv;
    Pack<V> a[3][3];
#pragma unroll
    for (int kr = 0; kr < 3 - S; ++kr) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) a[kr][kx] = x_at(kr, S * ox + kx);
    }
    for (int r = 0; r < nr; ++r) {
#pragma unroll
      for (int kr = 3 - S; kr < 3; ++kr) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          a[kr][kx] = x_at(S * r + kr, S * ox + kx);
        }
      }
      const Pack<V> d = dy_at(r + kDy0, ox + 1);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[kTaps][j] += d.v[j];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[k][j] = fmaf(d.v[j], a[k / 3][k % 3].v[j], acc[k][j]);
        }
      }
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        if constexpr (S == 1) {
          a[0][kx] = a[1][kx];
          a[1][kx] = a[2][kx];
        } else {
          a[0][kx] = a[2][kx];
        }
      }
    }
  }

  // the block's sums: over a warp's lanes that share a vector (lanes
  // cbv apart), then over the groups in order
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    if (off < cbv) break;
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[k][j] += __shfl_xor_sync(0xffffffffu, acc[k][j], off);
      }
    }
  }
  const int gsize = max(cbv, 32);
  const int groups = nt / gsize;
  __syncthreads();  // the tiles are read: their bytes take the partials
  float* red = smem;
  if (t % gsize < cbv) {
    const int g = t / gsize;
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[(g * kSums + k) * cb + v * V + j] = acc[k][j];
      }
    }
  }
  __syncthreads();
  const long long prow = static_cast<long long>(img * bands + band) * kSums;
  for (int o = t; o < kSums * cb; o += nt) {
    const int k = o / cb;
    const int cc = o % cb;
    if (c0 + cc < c) {
      float s = 0.0f;
      for (int g = 0; g < groups; ++g) s += red[(g * kSums + k) * cb + cc];
      part[(prow + k) * c + c0 + cc] = s;
    }
  }
}

// dW[ch][k] (k < 9) and db[ch] (k = 9): part[p][k][ch] summed over p in a
// fixed order: warp g takes p = g, g + 8, ..., then warp 0 adds the 8.
// blockIdx.x = k * chunks + chunk, 32 channels a chunk.
__global__ void __launch_bounds__(32 * kReduceGroups)
dwconv_bwd_reduce(const float* __restrict__ part, float* __restrict__ dw,
                  float* __restrict__ db, int c, int parts) {
  __shared__ float red[kReduceGroups][33];
  const int chunks = (c + 31) / 32;
  const int k = blockIdx.x / chunks;
  const int lane = threadIdx.x % 32;
  const int g = threadIdx.x / 32;
  const int ch = (blockIdx.x % chunks) * 32 + lane;
  float s = 0.0f;
  if (ch < c) {
    for (int p = g; p < parts; p += kReduceGroups) {
      s += part[(static_cast<long long>(p) * kSums + k) * c + ch];
    }
  }
  red[g][lane] = s;
  __syncthreads();
  if (g == 0 && ch < c) {
    float tot = 0.0f;
    for (int i = 0; i < kReduceGroups; ++i) tot += red[i][lane];
    if (k < kTaps) {
      dw[static_cast<long long>(ch) * kTaps + k] = tot;
    } else {
      db[ch] = tot;
    }
  }
}

template <int V, int S>
int launch(const float* x, const float* dy, const float* w, float* dx,
           float* part, float* dw, float* db, int n, int h, int wd, int c,
           int cb, int rows, int threads, int smem, cudaStream_t stream) {
  const int ho = (h - 1) / S + 1;
  const int wo = (wd - 1) / S + 1;
  const int bands = (ho + rows - 1) / rows;
  const int slices = (c + cb - 1) / cb;
  const long long blocks = static_cast<long long>(n) * bands * slices;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dwconv_bwd_kernel<V, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dwconv_bwd_kernel<V, S><<<static_cast<unsigned int>(blocks), threads,
                            smem, stream>>>(x, dy, w, dx, part, h, wd, c, ho,
                                            wo, cb, rows, bands, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (c + 31) / 32;
  dwconv_bwd_reduce<<<(db ? kSums : kTaps) * chunks, 32 * kReduceGroups, 0,
                      stream>>>(part, dw, db, c, n * bands);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, h, wd, c) f32 contiguous (an NCHW tensor in channels_last);
// dy: (n, ho, wo, c) likewise, ho = (h - 1) / stride + 1 (wo alike); w:
// (c, 9) f32 tap weights, row-major taps. dx (n, h, wd, c) written whole;
// part: (n * bands, 10, c) f32 scratch; dw (c, 9) written whole; db (c)
// written where not null. vec, cb, rows, threads, smem: the launch plan
// (ops/dwconv_cuda.py::dw_bwd_plan): vec 1, 2 or 4 dividing c (x and dy
// aligned to its bytes), cb / vec a power of two up to kMaxSlice, threads
// a multiple of 32 and of cb / vec up to kMaxThreads, smem as smem_bytes
// gives it, within the budget.
extern "C" int dwconv_bwd(const void* x, const void* dy, const void* w,
                          void* dx, void* part, void* dw, void* db, int n,
                          int h, int wd, int c, int stride, int vec, int cb,
                          int rows, int threads, int smem, void* stream) {
  const int cbv = vec > 0 ? cb / vec : 0;
  const int ho = stride > 0 ? (h - 1) / stride + 1 : 0;
  const int wo = stride > 0 ? (wd - 1) / stride + 1 : 0;
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || (stride != 1 && stride != 2)
      || (vec != 1 && vec != 2 && vec != 4) || c % vec || cb % vec
      || cbv <= 0 || cbv > kMaxSlice || (cbv & (cbv - 1))
      || rows <= 0 || rows > ho || threads <= 0 || threads > kMaxThreads
      || threads % 32 || threads % cbv
      || smem != smem_bytes(wd, wo, cb, vec, rows, stride, threads)
      || smem > kSmemBudget
      || reinterpret_cast<uintptr_t>(x) % (4 * vec)
      || reinterpret_cast<uintptr_t>(dy) % (4 * vec)
      || reinterpret_cast<uintptr_t>(dx) % (4 * vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  const float* wf = static_cast<const float*>(w);
  float* dxf = static_cast<float*>(dx);
  float* pf = static_cast<float*>(part);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DWCONV_LAUNCH(V, S)                                                 \
  if (vec == V && stride == S) {                                            \
    return launch<V, S>(xf, dyf, wf, dxf, pf, dwf, dbf, n, h, wd, c, cb,   \
                        rows, threads, smem, st);                       \
  }
  DWCONV_LAUNCH(4, 1)
  DWCONV_LAUNCH(4, 2)
  DWCONV_LAUNCH(2, 1)
  DWCONV_LAUNCH(2, 2)
  DWCONV_LAUNCH(1, 1)
  DWCONV_LAUNCH(1, 2)
#undef DWCONV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
