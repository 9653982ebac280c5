// Native host-side pairwise IoU with the +1 pixel convention, the IoU of
// the WIDER FACE evaluation (eval/widerface.py).
//
// The port's copy of the bbox_overlaps_plus1 function of the JAX package's
// native/postprocess.cpp, unchanged: the counterpart of the reference's
// Cython IoU kernel (reference widerface_evaluate/box_overlaps.pyx:15-55).
// That file's decode, greedy NMS and letterbox inverse come to the port
// with its standalone C++ detector app. Exposed through a plain C ABI and
// loaded via ctypes (face_detection_multi_scale_tpu_torch/native/
// __init__.py), which builds it with g++ -O3 -shared -fPIC -std=c++17 into
// the package's _build/.

#include <algorithm>
#include <cstdint>
#include <vector>

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

}  // extern "C"
