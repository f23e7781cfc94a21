// KITTI offline detection evaluator (C++), reference-grade scorer.
//
// Fresh implementation of the metric computed by the reference's
// tools/kitti_eval/evaluate_object_3d_offline.cpp (948 LoC, shelled out to
// by lib/datasets/dataset/kitti.py:84-88): 41-recall-point curves with the
// official 11-point sampled AP (every 4th of the 41 points — the number the
// reference binary prints) for 2D detection, bird's-eye-view and 3D boxes,
// plus AOS (orientation), at the three KITTI difficulty levels
// (easy/moderate/hard gates on min height / occlusion / truncation).
//
// Protocol details mirrored exactly (differentially tested against the
// reference's prebuilt binary in tests/test_kitti_eval.py):
//  - recall-threshold pass matches each GT to the HIGHEST-SCORE candidate;
//    the PR pass matches the GREATEST-OVERLAP non-ignored candidate,
//    falling back to an ignored (too-small) detection only when nothing
//    else matched; assignments are consumed across GTs within an image.
//  - neighbor classes (Van~Car, Person_sitting~Pedestrian) and
//    difficulty-filtered same-class GTs are "ignored" (absorb detections,
//    count neither TP nor FN); all other classes are skipped outright.
//  - detections overlapping a DontCare area (intersection / detection
//    area > class min-overlap) are subtracted from the FP count.
//  - detection min-height test truncates the height to int (the binary's
//    int32_t cast); the GT height test compares doubles.
//
// Exposed as a C ABI for ctypes (codenet_torch/eval/kitti_eval.py): the
// caller passes flat arrays of GT and detection records; results are the
// per-class/difficulty APs plus (optionally) the full 41-point curves.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int kNSample = 41;
// MIN_OVERLAP[metric][class] (car, ped, cyc): the reference binary ships
// with the RELAXED ground/3D thresholds (its strict variant is commented
// out at evaluate_object_3d_offline.cpp:55)
constexpr double kMinOverlap[3][3] = {
    {0.7, 0.5, 0.5},     // image (2D)
    {0.5, 0.25, 0.25},   // ground (BEV)
    {0.5, 0.25, 0.25}};  // 3D
// difficulty gates: MIN_HEIGHT, MAX_OCCLUSION, MAX_TRUNCATION
constexpr double kMinHeight[3] = {40.0, 25.0, 25.0};
constexpr int kMaxOcclusion[3] = {0, 1, 2};
constexpr double kMaxTruncation[3] = {0.15, 0.3, 0.5};

struct Box {  // one GT or detection record
  int cls;         // 0 car, 1 ped, 2 cyc; -2 van, -3 person_sitting,
                   // -1 dontcare, 99 other
  double x1, y1, x2, y2;
  double h, w, l;  // dimensions
  double tx, ty, tz;
  double ry;
  double alpha;
  double score;
  int occlusion;
  double truncation;
};

// criterion: -1 inter/union, 0 inter/area(a), 1 inter/area(b)
double box2d_overlap(const Box& a, const Box& b, int criterion) {
  double ix = std::min(a.x2, b.x2) - std::max(a.x1, b.x1);
  double iy = std::min(a.y2, b.y2) - std::max(a.y1, b.y1);
  if (ix <= 0 || iy <= 0) return 0.0;
  double inter = ix * iy;
  double a_area = (a.x2 - a.x1) * (a.y2 - a.y1);
  double b_area = (b.x2 - b.x1) * (b.y2 - b.y1);
  if (criterion == 0) return inter / a_area;
  if (criterion == 1) return inter / b_area;
  return inter / (a_area + b_area - inter);
}

struct Pt {
  double x, y;
};

// corners of a rotated BEV rectangle (x-z plane, yaw ry)
void bev_corners(const Box& b, Pt out[4]) {
  double c = std::cos(b.ry), s = std::sin(b.ry);
  double dx[4] = {b.l / 2, b.l / 2, -b.l / 2, -b.l / 2};
  double dz[4] = {b.w / 2, -b.w / 2, -b.w / 2, b.w / 2};
  for (int i = 0; i < 4; ++i) {
    out[i].x = b.tx + c * dx[i] + s * dz[i];
    out[i].y = b.tz - s * dx[i] + c * dz[i];
  }
}

// polygon area (shoelace, abs)
double poly_area(const std::vector<Pt>& p) {
  double a = 0;
  for (size_t i = 0; i < p.size(); ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % p.size()];
    a += u.x * v.y - v.x * u.y;
  }
  return std::fabs(a) / 2;
}

// Sutherland-Hodgman clip of subject polygon by convex clip polygon
std::vector<Pt> clip_poly(std::vector<Pt> subject, const Pt clip[4]) {
  for (int e = 0; e < 4 && !subject.empty(); ++e) {
    Pt A = clip[e];
    Pt B = clip[(e + 1) % 4];
    auto inside = [&](const Pt& p) {
      return (B.x - A.x) * (p.y - A.y) - (B.y - A.y) * (p.x - A.x) <= 1e-12;
    };
    auto intersect = [&](const Pt& p, const Pt& q) {
      double a1 = B.y - A.y, b1 = A.x - B.x;
      double c1 = a1 * A.x + b1 * A.y;
      double a2 = q.y - p.y, b2 = p.x - q.x;
      double c2 = a2 * p.x + b2 * p.y;
      double det = a1 * b2 - a2 * b1;
      Pt r;
      if (std::fabs(det) < 1e-12) {
        r = p;
      } else {
        r.x = (b2 * c1 - b1 * c2) / det;
        r.y = (a1 * c2 - a2 * c1) / det;
      }
      return r;
    };
    std::vector<Pt> out;
    for (size_t i = 0; i < subject.size(); ++i) {
      Pt cur = subject[i];
      Pt prev = subject[(i + subject.size() - 1) % subject.size()];
      bool cin = inside(cur), pin = inside(prev);
      if (cin) {
        if (!pin) out.push_back(intersect(prev, cur));
        out.push_back(cur);
      } else if (pin) {
        out.push_back(intersect(prev, cur));
      }
    }
    subject = out;
  }
  return subject;
}

// ensure clockwise order for the clip convention above
void make_cw(Pt p[4]) {
  double a = 0;
  for (int i = 0; i < 4; ++i)
    a += p[i].x * p[(i + 1) % 4].y - p[(i + 1) % 4].x * p[i].y;
  if (a > 0) std::swap(p[1], p[3]);
}

double bev_inter_area(const Box& a, const Box& b) {
  Pt ca[4], cb[4];
  bev_corners(a, ca);
  bev_corners(b, cb);
  make_cw(ca);
  make_cw(cb);
  std::vector<Pt> subject(ca, ca + 4);
  auto inter = clip_poly(subject, cb);
  if (inter.size() < 3) return 0.0;
  return poly_area(inter);
}

double bev_overlap(const Box& a, const Box& b, int criterion) {
  double ia = bev_inter_area(a, b);
  double a_area = std::fabs(a.l * a.w), b_area = std::fabs(b.l * b.w);
  if (criterion == 0) return a_area > 0 ? ia / a_area : 0.0;
  if (criterion == 1) return b_area > 0 ? ia / b_area : 0.0;
  double ua = a_area + b_area - ia;
  return ua > 0 ? ia / ua : 0.0;
}

double box3d_overlap(const Box& a, const Box& b, int criterion) {
  double ia = bev_inter_area(a, b);
  // y axis points down; box spans [ty - h, ty]
  double ymin = std::max(a.ty - a.h, b.ty - b.h);
  double ymax = std::min(a.ty, b.ty);
  double iv = ia * std::max(0.0, ymax - ymin);
  double a_vol = std::fabs(a.l * a.w * a.h), b_vol = std::fabs(b.l * b.w * b.h);
  if (criterion == 0) return a_vol > 0 ? iv / a_vol : 0.0;
  if (criterion == 1) return b_vol > 0 ? iv / b_vol : 0.0;
  double uv = a_vol + b_vol - iv;
  return uv > 0 ? iv / uv : 0.0;
}

enum Metric { kImage = 0, kGround = 1, kBox3D = 2 };

double overlap(const Box& det, const Box& gt, Metric m, int criterion) {
  switch (m) {
    case kImage:
      return box2d_overlap(det, gt, criterion);
    case kGround:
      return bev_overlap(det, gt, criterion);
    default:
      return box3d_overlap(det, gt, criterion);
  }
}

struct ImageData {
  std::vector<Box> gts;
  std::vector<Box> dets;
};

struct PrData {
  double tp = 0, fp = 0, fn = 0, similarity = 0;
  std::vector<double> v;  // TP-candidate scores (recall-threshold pass)
};

// cleanData: classify GTs (0 valid / 1 ignored / -1 skip), collect
// DontCare areas, classify detections (0 valid / 1 too-small / -1 other)
void clean_data(const ImageData& img, int cls, int difficulty,
                std::vector<int>* ignored_gt, std::vector<Box>* dontcare,
                std::vector<int>* ignored_det, double* n_gt) {
  for (const Box& g : img.gts) {
    int valid_class;
    if (g.cls == cls)
      valid_class = 1;
    else if ((cls == 0 && g.cls == -2) || (cls == 1 && g.cls == -3))
      valid_class = 0;  // neighbor class (Van~Car, Person_sitting~Ped)
    else
      valid_class = -1;
    double height = g.y2 - g.y1;
    bool ignore = g.occlusion > kMaxOcclusion[difficulty] ||
                  g.truncation > kMaxTruncation[difficulty] ||
                  height < kMinHeight[difficulty];
    if (valid_class == 1 && !ignore) {
      ignored_gt->push_back(0);
      *n_gt += 1;
    } else if (valid_class == 0 || (ignore && valid_class == 1)) {
      ignored_gt->push_back(1);
    } else {
      ignored_gt->push_back(-1);
    }
    if (g.cls == -1) dontcare->push_back(g);
  }
  for (const Box& d : img.dets) {
    // the binary casts the detection height to int32 before comparing
    int height = (int)std::fabs(d.y1 - d.y2);
    if (height < kMinHeight[difficulty])
      ignored_det->push_back(1);
    else if (d.cls == cls)
      ignored_det->push_back(0);
    else
      ignored_det->push_back(-1);
  }
}

// computeStatistics: one image at one score threshold (or, with
// compute_fp=false, the recall-threshold pass collecting TP scores)
PrData compute_stats(const ImageData& img, int cls,
                     const std::vector<int>& ignored_gt,
                     const std::vector<int>& ignored_det,
                     const std::vector<Box>& dontcare, bool compute_fp,
                     Metric metric, bool compute_aos, double thresh) {
  PrData stat;
  const double kNoDetection = -1e7;
  double min_ov = kMinOverlap[metric][cls];
  std::vector<double> delta;
  std::vector<bool> assigned(img.dets.size(), false);
  std::vector<bool> ignored_threshold(img.dets.size(), false);
  if (compute_fp)
    for (size_t j = 0; j < img.dets.size(); ++j)
      if (img.dets[j].score < thresh) ignored_threshold[j] = true;

  for (size_t i = 0; i < img.gts.size(); ++i) {
    if (ignored_gt[i] == -1) continue;

    int det_idx = -1;
    double valid_detection = kNoDetection;
    double max_overlap = 0;
    bool assigned_ignored_det = false;

    for (size_t j = 0; j < img.dets.size(); ++j) {
      if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j])
        continue;
      double ov = overlap(img.dets[j], img.gts[i], metric, -1);
      if (!compute_fp && ov > min_ov &&
          img.dets[j].score > valid_detection) {
        // recall-threshold pass: highest-score candidate wins
        det_idx = (int)j;
        valid_detection = img.dets[j].score;
      } else if (compute_fp && ov > min_ov &&
                 (ov > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        // PR pass: greatest-overlap non-ignored candidate wins
        max_overlap = ov;
        det_idx = (int)j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && ov > min_ov &&
                 valid_detection == kNoDetection && ignored_det[j] == 1) {
        // ignored (too-small) detection only if nothing else matched
        det_idx = (int)j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
      stat.fn += 1;
    } else if (valid_detection != kNoDetection &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = true;  // absorbed, counts neither way
    } else if (valid_detection != kNoDetection) {
      stat.tp += 1;
      stat.v.push_back(img.dets[det_idx].score);
      if (compute_aos)
        delta.push_back(img.gts[i].alpha - img.dets[det_idx].alpha);
      assigned[det_idx] = true;
    }
  }

  if (compute_fp) {
    for (size_t j = 0; j < img.dets.size(); ++j)
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_threshold[j]))
        stat.fp += 1;
    // detections overlapping DontCare areas (inter / det area) are not FPs
    double nstuff = 0;
    for (const Box& dc : dontcare) {
      for (size_t j = 0; j < img.dets.size(); ++j) {
        if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_threshold[j])
          continue;
        double ov = overlap(img.dets[j], dc, metric, 0);
        if (ov > min_ov) {
          assigned[j] = true;
          nstuff += 1;
        }
      }
    }
    stat.fp -= nstuff;

    if (compute_aos) {
      // FPs contribute 0 similarity; TPs contribute (1+cos(delta))/2.
      // An image with neither at this threshold is skipped (-1 marker).
      if (stat.tp > 0 || stat.fp > 0) {
        double s = 0;
        for (double d : delta) s += (1.0 + std::cos(d)) / 2.0;
        stat.similarity = s;
      } else {
        stat.similarity = -1;
      }
    }
  }
  return stat;
}

// score thresholds for the 41 recall sample points (official logic)
std::vector<double> thresholds_from_scores(std::vector<double> scores,
                                           double n_gt) {
  std::sort(scores.begin(), scores.end(), std::greater<double>());
  std::vector<double> th;
  double current_recall = 0;
  for (size_t i = 0; i < scores.size(); ++i) {
    double l_recall = (i + 1) / n_gt;
    double r_recall =
        (i < scores.size() - 1) ? (i + 2) / n_gt : l_recall;
    if ((r_recall - current_recall) < (current_recall - l_recall) &&
        i < scores.size() - 1)
      continue;
    th.push_back(scores[i]);
    current_recall += 1.0 / (kNSample - 1.0);
  }
  return th;
}

void eval_class(const std::vector<ImageData>& images, int cls,
                int difficulty, Metric metric, bool compute_aos,
                double* ap_out, double* aos_out, double* curve_p,
                double* curve_a) {
  size_t n = images.size();
  std::vector<std::vector<int>> ignored_gt(n), ignored_det(n);
  std::vector<std::vector<Box>> dontcare(n);
  double n_gt = 0;
  std::vector<double> v;
  for (size_t i = 0; i < n; ++i) {
    clean_data(images[i], cls, difficulty, &ignored_gt[i], &dontcare[i],
               &ignored_det[i], &n_gt);
    PrData tmp = compute_stats(images[i], cls, ignored_gt[i],
                               ignored_det[i], dontcare[i], false, metric,
                               false, 0.0);
    v.insert(v.end(), tmp.v.begin(), tmp.v.end());
  }
  auto thresholds = thresholds_from_scores(v, n_gt);

  std::vector<PrData> pr(thresholds.size());
  for (size_t i = 0; i < n; ++i) {
    for (size_t t = 0; t < thresholds.size(); ++t) {
      PrData tmp = compute_stats(images[i], cls, ignored_gt[i],
                                 ignored_det[i], dontcare[i], true, metric,
                                 compute_aos, thresholds[t]);
      pr[t].tp += tmp.tp;
      pr[t].fp += tmp.fp;
      pr[t].fn += tmp.fn;
      if (tmp.similarity != -1) pr[t].similarity += tmp.similarity;
    }
  }

  // precision/AOS curve over the 41 recall sample points
  std::vector<double> precision(kNSample, 0.0);
  std::vector<double> aos(kNSample, 0.0);
  for (size_t t = 0; t < thresholds.size(); ++t) {
    double denom = pr[t].tp + pr[t].fp;
    precision[t] = denom > 0 ? pr[t].tp / denom : 0;
    if (compute_aos) aos[t] = denom > 0 ? pr[t].similarity / denom : 0;
  }
  // monotone smoothing over the threshold range (official)
  for (size_t t = 0; t < thresholds.size(); ++t) {
    precision[t] = *std::max_element(precision.begin() + t,
                                     precision.begin() + thresholds.size());
    if (compute_aos)
      aos[t] = *std::max_element(aos.begin() + t,
                                 aos.begin() + thresholds.size());
  }
  // the reference binary's printed AP: 11-point sampling of the 41 points
  double sum_p = 0, sum_a = 0;
  for (int i = 0; i < kNSample; i += 4) {
    sum_p += precision[i];
    sum_a += aos[i];
  }
  *ap_out = sum_p / 11.0 * 100.0;
  if (aos_out) *aos_out = compute_aos ? sum_a / 11.0 * 100.0 : -1;
  if (curve_p)
    for (int i = 0; i < kNSample; ++i) curve_p[i] = precision[i];
  if (curve_a)
    for (int i = 0; i < kNSample; ++i)
      curve_a[i] = compute_aos ? aos[i] : -1;
}

}  // namespace

extern "C" {

// Flat record layout (doubles):
// [cls, x1, y1, x2, y2, h, w, l, tx, ty, tz, ry, alpha, score, occ, trunc]
constexpr int kRecord = 16;

// results layout: for each cls(3) x difficulty(3):
//   [ap2d, aos, ap_bev, ap_3d] => 36 doubles
// curves (optional, may be NULL): for each cls(3) x difficulty(3) x
//   [p2d, aos, p_bev, p_3d]: 41 doubles each => 3*3*4*41 = 1476 doubles
int kitti_evaluate(const double* gt_data, const long* gt_counts,
                   const double* det_data, const long* det_counts,
                   long n_images, double* results, double* curves) {
  std::vector<ImageData> images(n_images);
  long gofs = 0, dofs = 0;
  auto parse = [](const double* r) {
    Box b;
    b.cls = (int)r[0];
    b.x1 = r[1]; b.y1 = r[2]; b.x2 = r[3]; b.y2 = r[4];
    b.h = r[5]; b.w = r[6]; b.l = r[7];
    b.tx = r[8]; b.ty = r[9]; b.tz = r[10];
    b.ry = r[11]; b.alpha = r[12]; b.score = r[13];
    b.occlusion = (int)r[14]; b.truncation = r[15];
    return b;
  };
  for (long i = 0; i < n_images; ++i) {
    for (long g = 0; g < gt_counts[i]; ++g)
      images[i].gts.push_back(parse(gt_data + (gofs + g) * kRecord));
    gofs += gt_counts[i];
    for (long d = 0; d < det_counts[i]; ++d)
      images[i].dets.push_back(parse(det_data + (dofs + d) * kRecord));
    dofs += det_counts[i];
  }
  int idx = 0;
  for (int cls = 0; cls < 3; ++cls) {
    for (int dif = 0; dif < 3; ++dif) {
      double ap2d, aos, apbev, ap3d;
      double* c = curves ? curves + ((cls * 3 + dif) * 4) * kNSample
                         : nullptr;
      eval_class(images, cls, dif, kImage, true, &ap2d, &aos,
                 c ? c : nullptr, c ? c + kNSample : nullptr);
      eval_class(images, cls, dif, kGround, false, &apbev, nullptr,
                 c ? c + 2 * kNSample : nullptr, nullptr);
      eval_class(images, cls, dif, kBox3D, false, &ap3d, nullptr,
                 c ? c + 3 * kNSample : nullptr, nullptr);
      results[idx++] = ap2d;
      results[idx++] = aos;
      results[idx++] = apbev;
      results[idx++] = ap3d;
    }
  }
  return 0;
}

}  // extern "C"
