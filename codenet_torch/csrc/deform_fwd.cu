// Forward of CoDeNet's co-designed depthwise deformable 3x3 convolution,
// stride 1, padding 1, channels-last, for Hopper (sm_90a).
//
//   out[n, p, c] = sum_t w[t, c] * bilinear(x[n, :, :, c], p + a_t * s[n, p])
//
// a_t in {-1, 0, 1}^2 row-major, s clamped to [-7, 8], each of the four
// bilinear corners zeroed separately outside the map, f32 accumulation
// (per tap the corners in order (0,0), (0,1), (1,0), (1,1), then the taps
// row-major), output in the input's type (f32 or bf16).
//
// Replaces the JAX package's ops/deform_pallas.py::_fwd_kernel. That kernel
// turned the gather into dense (tile x HW) interpolation matrices built in
// VMEM and contracted on the MXU, because a TPU has no fast gather; its
// banded / rolled / channel-chunked regimes exist for Mosaic's scoped VMEM
// and the 128x128 systolic array. None of that carries over.
//
// What bounds it on an H100: on paper, bytes at every model shape. Per
// output element the op does 9 taps x 4 corners (about 90 flops) and has
// to move one input and one output element; at 3.35 TB/s the bytes take
// longer than the flops at the fp32 CUDA-core rate (PERF.md has every
// shape). In practice it is bound by the 36 gathers per element: from
// global memory they are 36 scalar reads each, served by L2 once an
// image's slice outgrows L1. Here they are 16-byte reads of shared
// memory, and what sets the time is that memory's data path: 36 reads of
// 16 bytes per thread and position at the least (4 wavefronts per warp
// each), plus the geometry's, plus bank conflicts where a quarter-warp's
// eight reads span two positions (a slice under 128 bytes). The launch
// plan prefers 128-byte slices for that reason, even at the cost of a
// banded tile or one block per SM (PERF.md has the measurements).
//
// Design, for that bound:
// - one block per (image n, band of `rows` output rows, channel slice
//   [c0, c0 + cb)), blockIdx.x = (n * bands + band) * slices + slice. A tap
//   reaches |a * s| <= 8 rows and the lower corner one more, so the band's
//   outputs read input rows [r0 - 8, r0 + rows + 8] clipped to the map. The
//   block stages those rows of its slice into dynamic shared memory once,
//   in x's own type, with cp.async copies of one channel vector each; every
//   gather then hits shared memory and x leaves L2 about once (rows + 17
//   over rows times for a banded map);
// - a thread owns one vector of V channels of the slice (16 bytes: 4 f32
//   or 8 bf16; 8, 4 or 2 bytes where C or a pointer's alignment demands
//   it) and one position lane, keeps its 9 x V tap weights in registers,
//   makes 36 vector gathers per position and writes its V outputs with one
//   store;
// - geometry: the band's positions are walked in groups of kGroup; per
//   group it is computed once per block into shared memory (s is shared
//   by all channels). A tap's 4 corners are 2 rows x 2 columns, and its 9
//   taps share 3 row coordinates (a_i) and 3 column coordinates (a_j): so
//   a position's geometry is 6 float4 records, one per axis coordinate,
//   each with the two corners' tile offsets and weights (1 - f, f; 0 off
//   the map). A thread reads them with 6 16-byte loads per position, not
//   18 for a table of per-tap indices and weights, and forms a corner's
//   weight as wy * wx, the product such a table would hold. An off-map
//   corner reads inside the tile with weight 0, so the gathers have no
//   branch;
// - w is read through a (tap stride, channel stride) pair, so the model's
//   permuted view of its OIHW weight goes in without a copy.
// The launch plan (rows, cb, V, threads, shared bytes; the grid follows) is
// ops/deform_cuda.py::fwd_plan's; this file checks it against its layout.
//
// Plain C interface for ctypes: pointers and the stream as void*, returns
// cudaGetLastError() after the launch.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 9;
constexpr int kCorners = 4;
constexpr int kGroup = 128;          // positions per geometry group
constexpr int kMaxThreads = 512;     // so 128 registers a thread at most
constexpr int kReach = 8;            // rows a tap reaches: |a * s| <= 8
constexpr int kSmemBudget = 232448;  // a block's shared memory on sm_90
constexpr float kSLo = -7.0f;
constexpr float kSHi = 8.0f;

int tile_rows(int h, int rows) {
  const int halo = rows + 2 * kReach + 1;
  return halo < h ? halo : h;
}

constexpr int kAxes = 6;  // per position: 3 row and 3 column records

// A block's dynamic shared memory, in this order: the geometry of one
// group (per position kAxes float4 records); the tile [tile rows * wd][cb]
// in x's type.
long long smem_bytes(int h, int wd, int rows, int cb, int esize) {
  return 16LL * kGroup * kAxes
         + static_cast<long long>(tile_rows(h, rows)) * wd * cb * esize;
}

// V values of T from / to one aligned access of V * sizeof(T) bytes, as
// f32 (bf16 is the high half of an f32; stores round to nearest even).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&f)[V]) {
  if constexpr (V == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  } else if constexpr (V == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    f[0] = r.x; f[1] = r.y;
  } else {
    f[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __bfloat162float(*p);
  } else {
    unsigned int u[V / 2];
    if constexpr (V == 8) {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      u[0] = r.x; u[1] = r.y; u[2] = r.z; u[3] = r.w;
    } else if constexpr (V == 4) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      u[0] = r.x; u[1] = r.y;
    } else {
      u[0] = *reinterpret_cast<const unsigned int*>(p);
    }
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      f[2 * j] = __uint_as_float(u[j] << 16);
      f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&f)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    *p = f[0];
  }
}

__device__ __forceinline__ unsigned int bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16(f[0]);
  } else {
    unsigned int u[V / 2];
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      u[j] = bf16_bits(f[2 * j]) | (bf16_bits(f[2 * j + 1]) << 16);
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else {
      *reinterpret_cast<unsigned int*>(p) = u[0];
    }
  }
}

// One vector of V elements from global to shared memory: cp.async where
// the hardware copies that size (4, 8 or 16 bytes), else a plain copy.
template <typename T, int V>
__device__ __forceinline__ void stage_vec(T* dst, const T* src) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 4) {
    __pipeline_memcpy_async(dst, src, kBytes);
  } else {
    *dst = *src;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
codesign_deform_fwd_kernel(const T* __restrict__ x,
                           const float* __restrict__ s,
                           const float* __restrict__ w,
                           T* __restrict__ out, int h, int wd, int c,
                           int w_tap, int w_ch, int rows, int cb,
                           int log_vpp, int bands, int slices) {
  extern __shared__ float4 smem[];
  float4* geo = smem;  // [kGroup][kAxes]
  T* tile = reinterpret_cast<T*>(smem + kGroup * kAxes);

  const int hw = h * wd;
  const int slice = blockIdx.x % slices;
  const int nb = blockIdx.x / slices;
  const int band = nb % bands;
  const int n = nb / bands;
  const int c0 = slice * cb;
  const int r0 = band * rows;
  const int r1 = min(h, r0 + rows);
  const int lo = max(0, r0 - kReach);
  const int hi = min(h, r1 + kReach + 1);
  const long long img = static_cast<long long>(n) * hw;
  const int vpp = 1 << log_vpp;  // vectors per position of the slice

  // Stage x[n, lo:hi, :, c0:c0+cb] as tile[(row - lo) * wd + col][cb].
  // Vectors past c are left unwritten: no thread reads them.
  {
    const T* xband = x + (img + static_cast<long long>(lo) * wd) * c + c0;
    const int vecs = (hi - lo) * wd * vpp;
    for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
      const int q = i >> log_vpp;
      const int cv = (i & (vpp - 1)) * V;
      if (c0 + cv < c) {
        stage_vec<T, V>(tile + q * cb + cv,
                        xband + static_cast<long long>(q) * c + cv);
      }
    }
    __pipeline_commit();
  }

  // This thread: channels [ch, ch + V) of the slice, position lane pl.
  const int cv = (threadIdx.x & (vpp - 1)) * V;
  const int pl = threadIdx.x >> log_vpp;
  const int lanes = blockDim.x >> log_vpp;
  const int ch = c0 + cv;
  const bool active = ch < c;
  float wt[kTaps][V];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      wt[t][j] = active ? w[t * w_tap + (ch + j) * w_ch] : 0.f;
    }
  }

  const int p_first = r0 * wd;         // the band's first output position
  const int band_pos = (r1 - r0) * wd;
  for (int g0 = 0; g0 < band_pos; g0 += kGroup) {
    // Geometry: one (position, axis record) pair per thread; e == pi * 6
    // + a. Records 0-2 are the rows of a_i = -1, 0, 1, records 3-5 the
    // columns of a_j = -1, 0, 1: {byte offset in the tile of the lower and
    // the upper corner's row (or column), as int bits; their weights,
    // 1 - f and f, each 0 off the map}. An off-map corner's offset is 0,
    // inside the tile.
    for (int e = threadIdx.x; e < kGroup * kAxes; e += blockDim.x) {
      const int pi = e / kAxes;
      const int a = e - pi * kAxes;
      float4 rec = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g0 + pi < band_pos) {
        const int p = p_first + g0 + pi;
        const int py = p / wd;
        const bool is_row = a < 3;
        const float sv = fminf(fmaxf(s[img + p], kSLo), kSHi);
        const float av = static_cast<float>((is_row ? a : a - 3) - 1);
        // a * s is exact: a in {-1, 0, 1}
        const float sc =
            static_cast<float>(is_row ? py : p - py * wd) + av * sv;
        const float c0f = floorf(sc);
        const float f = sc - c0f;
        const int c0 = static_cast<int>(c0f);
        // [lo, hi) holds every row of the map the band can reach, so this
        // is the test for "on the map"
        const int first = is_row ? lo : 0;
        const int end = is_row ? hi : wd;
        const int stride =
            (is_row ? wd * cb : cb) * static_cast<int>(sizeof(T));
        const bool on0 = c0 >= first && c0 < end;
        const bool on1 = c0 + 1 >= first && c0 + 1 < end;
        rec = make_float4(__int_as_float(on0 ? (c0 - first) * stride : 0),
                          __int_as_float(on1 ? (c0 + 1 - first) * stride : 0),
                          on0 ? 1.0f - f : 0.f, on1 ? f : 0.f);
      }
      geo[e] = rec;
    }
    __pipeline_wait_prior(0);  // this thread's tile copies have landed
    __syncthreads();           // everyone's, and the group's geometry

    const int gn = min(kGroup, band_pos - g0);
    if (active) {
      const char* base = reinterpret_cast<const char*>(tile + cv);
      for (int pi = pl; pi < gn; pi += lanes) {
        // 6 broadcast reads of 16 bytes for the position's 36 corners
        float4 rec[kAxes];
#pragma unroll
        for (int a = 0; a < kAxes; ++a) rec[a] = geo[pi * kAxes + a];
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const float4 ry = rec[t / 3];
          const float4 rx = rec[3 + t % 3];
          const int oy[2] = {__float_as_int(ry.x), __float_as_int(ry.y)};
          const int ox[2] = {__float_as_int(rx.x), __float_as_int(rx.y)};
          const float wy[2] = {ry.z, ry.w};
          const float wx[2] = {rx.z, rx.w};
          float sample[V];
#pragma unroll
          for (int j = 0; j < V; ++j) sample[j] = 0.f;
#pragma unroll
          for (int k = 0; k < kCorners; ++k) {
            // the corner's weight, as a table of 4 per tap would hold it;
            // 0 where its row or its column is off the map
            const float wgt = wy[k >> 1] * wx[k & 1];
            float xv[V];
            load_vec<V>(reinterpret_cast<const T*>(base + oy[k >> 1]
                                                   + ox[k & 1]),
                        xv);
#pragma unroll
            for (int j = 0; j < V; ++j) sample[j] += wgt * xv[j];
          }
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] += wt[t][j] * sample[j];
        }
        store_vec<V>(out + (img + p_first + g0 + pi) * c + ch, acc);
      }
    }
    __syncthreads();  // the next group overwrites the geometry
  }
}

template <typename T, int V>
int launch(const void* x, const void* s, const void* w, void* out, int h,
           int wd, int c, int w_tap, int w_ch, int rows, int cb, int log_vpp,
           int threads, int smem, int bands, int slices, long long blocks,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      codesign_deform_fwd_kernel<T, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  codesign_deform_fwd_kernel<T, V><<<static_cast<unsigned int>(blocks),
                                     threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<T*>(out), h, wd, c, w_tap,
      w_ch, rows, cb, log_vpp, bands, slices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(int vec, const void* x, const void* s, const void* w,
               void* out, int h, int wd, int c, int w_tap, int w_ch,
               int rows, int cb, int log_vpp, int threads, int smem,
               int bands, int slices, long long blocks, cudaStream_t stream) {
  switch (vec * static_cast<int>(sizeof(T))) {
    case 16:
      return launch<T, 16 / sizeof(T)>(x, s, w, out, h, wd, c, w_tap, w_ch,
                                       rows, cb, log_vpp, threads, smem,
                                       bands, slices, blocks, stream);
    case 8:
      return launch<T, 8 / sizeof(T)>(x, s, w, out, h, wd, c, w_tap, w_ch,
                                      rows, cb, log_vpp, threads, smem,
                                      bands, slices, blocks, stream);
    case 4:
      return launch<T, 4 / sizeof(T)>(x, s, w, out, h, wd, c, w_tap, w_ch,
                                      rows, cb, log_vpp, threads, smem,
                                      bands, slices, blocks, stream);
    default:
      return launch<T, 1>(x, s, w, out, h, wd, c, w_tap, w_ch, rows, cb,
                          log_vpp, threads, smem, bands, slices, blocks,
                          stream);
  }
}

bool power_of_two(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: (n, h, wd, c) contiguous in
// that type; s: (n, h, wd) float32; w: float32 tap weights, w[t, c] at
// w + t * w_tap + c * w_ch (t row-major). rows, cb, vec, threads, smem: the
// launch plan (ops/deform_cuda.py::fwd_plan): 1 <= rows <= h; vec a power
// of two of at most 16 bytes dividing c, with x and out aligned to vec
// elements; cb a power of two, a multiple of vec; threads a multiple of 32
// and of cb / vec, at most kMaxThreads and at most kGroup * cb / vec; smem
// as smem_bytes gives it, within the budget.
extern "C" int codesign_deform_fwd(const void* x, const void* s,
                                   const void* w, void* out, int n, int h,
                                   int wd, int c, int dtype, int w_tap,
                                   int w_ch, int rows, int cb, int vec,
                                   int threads, int smem, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == 0 ? 4 : 2;
  const int vpp = vec > 0 ? cb / vec : 0;
  const uintptr_t align = static_cast<uintptr_t>(vec) * esize;
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || rows < 1 || rows > h
      || !power_of_two(vec) || vec * esize > 16 || c % vec
      || !power_of_two(cb) || cb < vec
      || reinterpret_cast<uintptr_t>(x) % align
      || reinterpret_cast<uintptr_t>(out) % align
      || threads <= 0 || threads > kMaxThreads || threads % 32
      || threads % vpp || threads / vpp > kGroup
      || smem != smem_bytes(h, wd, rows, cb, esize) || smem > kSmemBudget
      || static_cast<long long>(h) * wd > INT_MAX
      || static_cast<long long>(h) * wd * c > LLONG_MAX / n
      || static_cast<long long>(c) * w_ch + 9LL * w_tap > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bands = (h + rows - 1) / rows;
  const int slices = (c + cb - 1) / cb;
  const long long blocks = static_cast<long long>(n) * bands * slices;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int log_vpp = __builtin_ctz(vpp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_vec<float>(vec, x, s, w, out, h, wd, c, w_tap, w_ch, rows,
                             cb, log_vpp, threads, smem, bands, slices,
                             blocks, st);
  }
  return launch_vec<__nv_bfloat16>(vec, x, s, w, out, h, wd, c, w_tap, w_ch,
                                   rows, cb, log_vpp, threads, smem, bands,
                                   slices, blocks, st);
}
