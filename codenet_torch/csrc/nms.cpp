// Host NMS and soft-NMS over float32 boxes, behind a plain C interface
// (loaded with ctypes by ops/nms.py).
//
// The port's copy of the JAX package's native/nms.cpp (its nms, soft_nms,
// soft_nms_merge and soft_nms_39; reference lib/models/external/
// nms.pyx:24-391), with the same float32 arithmetic in the same order:
// greedy hard NMS; soft-NMS (hard, linear or gaussian decay) in place,
// where a row whose score falls below the threshold is overwritten by the
// last live row and the logical N shrinks; and the coordinate-merging
// variant. Rows are `stride` floats, C-contiguous.

#include <algorithm>
#include <cmath>
#include <vector>

namespace {

float decay(float ov, float sigma, float Nt, int method) {
  if (method == 1) return ov > Nt ? 1.f - ov : 1.f;
  if (method == 2) return std::exp(-(ov * ov) / sigma);
  return ov > Nt ? 0.f : 1.f;
}

long argmax_score(const float* boxes, long i, long n, long stride) {
  long maxpos = i;
  for (long pos = i + 1; pos < n; ++pos)
    if (boxes[pos * stride + 4] > boxes[maxpos * stride + 4]) maxpos = pos;
  return maxpos;
}

// IoU of row b with the box (tx1, ty1, tx2, ty2) of area tarea, in the
// reference's +1 pixel convention; false where they do not intersect.
bool overlap(const float* b, float tx1, float ty1, float tx2, float ty2,
             float tarea, float* ov) {
  float area = (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f);
  float iw = std::min(tx2, b[2]) - std::max(tx1, b[0]) + 1.f;
  if (!(iw > 0)) return false;
  float ih = std::min(ty2, b[3]) - std::max(ty1, b[1]) + 1.f;
  if (!(ih > 0)) return false;
  float ua = tarea + area - iw * ih;
  *ov = iw * ih / ua;
  return true;
}

}  // namespace

extern "C" {

// Greedy hard NMS over (n, stride >= 5) dets [x1 y1 x2 y2 score ...]:
// writes the kept row indices, highest score first (ties in row order),
// into keep (room for n); returns their count.
long codenet_nms(const float* d, long n, long stride, float thresh,
                 long* keep) {
  std::vector<long> order(n);
  for (long i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](long a, long b) {
    return d[a * stride + 4] > d[b * stride + 4];
  });
  std::vector<char> suppressed(n, 0);
  std::vector<float> areas(n);
  for (long i = 0; i < n; ++i) {
    const float* b = d + i * stride;
    areas[i] = (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f);
  }
  long kept = 0;
  for (long oi = 0; oi < n; ++oi) {
    long i = order[oi];
    if (suppressed[i]) continue;
    keep[kept++] = i;
    const float* bi = d + i * stride;
    for (long oj = oi + 1; oj < n; ++oj) {
      long j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = d + j * stride;
      float w = std::max(0.f, std::min(bi[2], bj[2])
                                  - std::max(bi[0], bj[0]) + 1.f);
      float h = std::max(0.f, std::min(bi[3], bj[3])
                                  - std::max(bi[1], bj[1]) + 1.f);
      float inter = w * h;
      if (inter / (areas[i] + areas[j] - inter) >= thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// Soft-NMS in place over (n, stride >= 5) boxes (whole rows swap and
// copy: stride 5 for ctdet, 39 for multi_pose); returns the shrunk N'.
long codenet_soft_nms(float* boxes, long n, long stride, float sigma,
                      float Nt, float threshold, int method) {
  long N = n;
  for (long i = 0; i < N; ++i) {
    long maxpos = argmax_score(boxes, i, N, stride);
    if (maxpos != i)
      for (long c = 0; c < stride; ++c)
        std::swap(boxes[i * stride + c], boxes[maxpos * stride + c]);
    const float tx1 = boxes[i * stride + 0], ty1 = boxes[i * stride + 1];
    const float tx2 = boxes[i * stride + 2], ty2 = boxes[i * stride + 3];
    const float tarea = (tx2 - tx1 + 1.f) * (ty2 - ty1 + 1.f);
    for (long pos = i + 1; pos < N; ++pos) {
      float* b = boxes + pos * stride;
      float ov;
      if (!overlap(b, tx1, ty1, tx2, ty2, tarea, &ov)) continue;
      b[4] *= decay(ov, sigma, Nt, method);
      if (b[4] < threshold) {
        for (long c = 0; c < stride; ++c) b[c] = boxes[(N - 1) * stride + c];
        --N;
        --pos;
      }
    }
  }
  return N;
}

// Coordinate-merging soft-NMS in place over (n, stride >= 7) rows
// [x1 y1 x2 y2 score ts bs]. The reference's quirks are kept: the max-row
// swap and the tail-discard copy move columns 0-4 only, and the
// accumulators start from the pre-swap row i's columns 5-6.
long codenet_soft_nms_merge(float* boxes, long n, long stride, float sigma,
                            float Nt, float threshold, int method,
                            float weight_exp) {
  long N = n;
  for (long i = 0; i < N; ++i) {
    long maxpos = argmax_score(boxes, i, N, stride);
    if (maxpos != i)
      for (long c = 0; c < 5; ++c)
        std::swap(boxes[i * stride + c], boxes[maxpos * stride + c]);
    float* bi = boxes + i * stride;
    float mx1 = bi[0] * bi[5], my1 = bi[1] * bi[5];
    float mx2 = bi[2] * bi[6], my2 = bi[3] * bi[6];
    float mts = bi[5], mbs = bi[6];
    const float tx1 = bi[0], ty1 = bi[1], tx2 = bi[2], ty2 = bi[3];
    const float tarea = (tx2 - tx1 + 1.f) * (ty2 - ty1 + 1.f);
    for (long pos = i + 1; pos < N; ++pos) {
      float* b = boxes + pos * stride;
      float ov;
      if (!overlap(b, tx1, ty1, tx2, ty2, tarea, &ov)) continue;
      float weight = decay(ov, sigma, Nt, method);
      float mw = std::pow(1.f - weight, weight_exp);
      mx1 += b[0] * b[5] * mw;
      my1 += b[1] * b[5] * mw;
      mx2 += b[2] * b[6] * mw;
      my2 += b[3] * b[6] * mw;
      mts += b[5] * mw;
      mbs += b[6] * mw;
      b[4] *= weight;
      if (b[4] < threshold) {
        for (long c = 0; c < 5; ++c) b[c] = boxes[(N - 1) * stride + c];
        --N;
        --pos;
      }
    }
    bi[0] = mx1 / mts;
    bi[1] = my1 / mts;
    bi[2] = mx2 / mbs;
    bi[3] = my2 / mbs;
  }
  return N;
}

}  // extern "C"
