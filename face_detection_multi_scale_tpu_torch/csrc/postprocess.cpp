// Native host-side postprocess: pairwise IoU with the +1 pixel convention
// (the WIDER FACE evaluation's, eval/widerface.py), greedy NMS, the grid /
// anchor decode of one pyramid level, and the letterbox coordinate
// inverse.
//
// The port's copy of the JAX package's native/postprocess.cpp, function
// for function: the counterpart of the reference's Cython IoU kernel
// (reference widerface_evaluate/box_overlaps.pyx:15-55) and of the ncnn
// C++ detector's scalar decode / NMS (reference
// cpp/yolov7-face-ncnn/src/yolov7face.cpp:43-156), which the standalone
// detector app (fdms_detect.cpp) links. Exposed through a plain C ABI and
// loaded via ctypes (face_detection_multi_scale_tpu_torch/native/
// __init__.py), which builds it with g++ -O3 -shared -fPIC -std=c++17 into
// the package's _build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline float sigmoidf(float x) { return 1.0f / (1.0f + std::exp(-x)); }

}  // namespace

extern "C" {

// Pairwise IoU with the +1 pixel area convention.
// boxes: (n, 4) xyxy row-major; query: (k, 4); out: (n, k).
void bbox_overlaps_plus1(const double* boxes, int64_t n, const double* query,
                         int64_t k, double* out) {
  std::vector<double> qarea(k);
  for (int64_t j = 0; j < k; ++j) {
    qarea[j] = (query[j * 4 + 2] - query[j * 4 + 0] + 1) *
               (query[j * 4 + 3] - query[j * 4 + 1] + 1);
  }
  for (int64_t i = 0; i < n; ++i) {
    const double bx1 = boxes[i * 4 + 0], by1 = boxes[i * 4 + 1];
    const double bx2 = boxes[i * 4 + 2], by2 = boxes[i * 4 + 3];
    const double barea = (bx2 - bx1 + 1) * (by2 - by1 + 1);
    for (int64_t j = 0; j < k; ++j) {
      const double iw =
          std::min(bx2, query[j * 4 + 2]) - std::max(bx1, query[j * 4 + 0]) + 1;
      double v = 0.0;
      if (iw > 0) {
        const double ih = std::min(by2, query[j * 4 + 3]) -
                          std::max(by1, query[j * 4 + 1]) + 1;
        if (ih > 0) {
          const double ua = barea + qarea[j] - iw * ih;
          v = iw * ih / ua;
        }
      }
      out[i * k + j] = v;
    }
  }
}

// Greedy NMS (torchvision semantics: descending score, suppress when
// IoU > threshold). boxes (n, 4) xyxy, scores (n,). Writes kept indices
// into keep (capacity max_det) and returns the number kept.
int64_t greedy_nms(const float* boxes, const float* scores, int64_t n,
                   float iou_thres, int64_t max_det, int32_t* keep) {
  std::vector<int32_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = static_cast<int32_t>(i);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return scores[a] > scores[b];
  });
  std::vector<float> areas(n);
  for (int64_t i = 0; i < n; ++i) {
    const float w = std::max(0.0f, boxes[i * 4 + 2] - boxes[i * 4 + 0]);
    const float h = std::max(0.0f, boxes[i * 4 + 3] - boxes[i * 4 + 1]);
    areas[i] = w * h;
  }
  std::vector<char> suppressed(n, 0);
  int64_t kept = 0;
  for (int64_t oi = 0; oi < n && kept < max_det; ++oi) {
    const int32_t i = order[oi];
    if (suppressed[i]) continue;
    keep[kept++] = i;
    const float ix1 = boxes[i * 4 + 0], iy1 = boxes[i * 4 + 1];
    const float ix2 = boxes[i * 4 + 2], iy2 = boxes[i * 4 + 3];
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int32_t j = order[oj];
      if (suppressed[j]) continue;
      const float xx1 = std::max(ix1, boxes[j * 4 + 0]);
      const float yy1 = std::max(iy1, boxes[j * 4 + 1]);
      const float xx2 = std::min(ix2, boxes[j * 4 + 2]);
      const float yy2 = std::min(iy2, boxes[j * 4 + 3]);
      const float iw = std::max(0.0f, xx2 - xx1);
      const float ih = std::max(0.0f, yy2 - yy1);
      const float inter = iw * ih;
      const float iou = inter / (areas[i] + areas[j] - inter);
      if (iou > iou_thres) suppressed[j] = 1;
    }
  }
  return kept;
}

// Decode one pyramid level's raw head map.
// raw: (na, ny, nx, no) float32 — the per-anchor channel layout after the
// reference's (bs, na, no, ny, nx) view, transposed to channels-last.
// anchors: (na, 2) pixel units. Output rows: (na*ny*nx, no) decoded
// [x, y, w, h, obj, cls..., kpt_x, kpt_y, kpt_conf, ...] with the
//   xy = (sig(t)*2 - 0.5 + grid) * stride
//   wh = (sig(t)*2)^2 * anchor
//   kpt_xy = (t*2 - 0.5 + grid) * stride, kpt_conf = sig(t)
// transform (models/yolo.py:290-295 semantics).
void decode_level(const float* raw, int64_t na, int64_t ny, int64_t nx,
                  int64_t no, int64_t nc, int64_t nkpt, const float* anchors,
                  float stride, float* out) {
  const int64_t det = 5 + nc;
  for (int64_t a = 0; a < na; ++a) {
    const float aw = anchors[a * 2 + 0];
    const float ah = anchors[a * 2 + 1];
    for (int64_t gy = 0; gy < ny; ++gy) {
      for (int64_t gx = 0; gx < nx; ++gx) {
        const float* r = raw + ((a * ny + gy) * nx + gx) * no;
        float* o = out + ((a * ny + gy) * nx + gx) * no;
        o[0] = (sigmoidf(r[0]) * 2.0f - 0.5f + gx) * stride;
        o[1] = (sigmoidf(r[1]) * 2.0f - 0.5f + gy) * stride;
        const float sw = sigmoidf(r[2]) * 2.0f;
        const float sh = sigmoidf(r[3]) * 2.0f;
        o[2] = sw * sw * aw;
        o[3] = sh * sh * ah;
        for (int64_t c = 4; c < det; ++c) o[c] = sigmoidf(r[c]);
        for (int64_t kp = 0; kp < nkpt; ++kp) {
          const float* kr = r + det + kp * 3;
          float* ko = o + det + kp * 3;
          ko[0] = (kr[0] * 2.0f - 0.5f + gx) * stride;
          ko[1] = (kr[1] * 2.0f - 0.5f + gy) * stride;
          ko[2] = sigmoidf(kr[2]);
        }
      }
    }
  }
}

// Letterbox inverse: scale/clip (n, 4) xyxy coords from the padded frame
// (in_h, in_w) back to the original (out_h, out_w) frame.
void scale_coords_inverse(double* coords, int64_t n, double in_h, double in_w,
                          double out_h, double out_w) {
  const double gain = std::min(in_h / out_h, in_w / out_w);
  const double pad_x = (in_w - out_w * gain) / 2.0;
  const double pad_y = (in_h - out_h * gain) / 2.0;
  for (int64_t i = 0; i < n; ++i) {
    double* c = coords + i * 4;
    c[0] = (c[0] - pad_x) / gain;
    c[2] = (c[2] - pad_x) / gain;
    c[1] = (c[1] - pad_y) / gain;
    c[3] = (c[3] - pad_y) / gain;
    c[0] = std::min(std::max(c[0], 0.0), out_w);
    c[2] = std::min(std::max(c[2], 0.0), out_w);
    c[1] = std::min(std::max(c[1], 0.0), out_h);
    c[3] = std::min(std::max(c[3], 0.0), out_h);
  }
}

}  // extern "C"
