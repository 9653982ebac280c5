// Standalone native detector: consumes raw per-stride head maps and emits
// final detections, the analog of the reference's ncnn C++ app (reference
// cpp/yolov7-face-ncnn/src/main.cpp + yolov7face.cpp:101-205), which
// likewise consumed raw-head network outputs (cpp/export.py:62-70) and did
// decode + NMS natively. The port's copy of the JAX package's
// native/fdms_detect.cpp, unchanged but for this header.
//
// Input: a binary dump written by
// face_detection_multi_scale_tpu_torch.native.dump_raw_heads:
//   int64 n_levels, nc, nkpt
//   per level: int64 na, ny, nx, no; float32 stride;
//              float32 anchors[na*2]; float32 raw[na*ny*nx*no]
// Output: one line per detection, "x1 y1 x2 y2 conf" in input-frame
// pixels, descending confidence.
//
// Build (native.build_app, into the package's _build/):
//   g++ -O3 -std=c++17 fdms_detect.cpp postprocess.cpp -o fdms_detect

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void decode_level(const float* raw, int64_t na, int64_t ny, int64_t nx,
                  int64_t no, int64_t nc, int64_t nkpt, const float* anchors,
                  float stride, float* out);
int64_t greedy_nms(const float* boxes, const float* scores, int64_t n,
                   float iou_thres, int64_t max_det, int32_t* keep);
}

namespace {

template <typename T>
bool read_n(FILE* f, T* dst, size_t n) {
  return fread(dst, sizeof(T), n, f) == n;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr,
            "usage: %s <raw_heads.bin> [conf_thres=0.25] [iou_thres=0.45] "
            "[max_det=300]\n",
            argv[0]);
    return 2;
  }
  const float conf_thres = argc > 2 ? atof(argv[2]) : 0.25f;
  const float iou_thres = argc > 3 ? atof(argv[3]) : 0.45f;
  const int64_t max_det = argc > 4 ? atoll(argv[4]) : 300;

  FILE* f = fopen(argv[1], "rb");
  if (!f) {
    fprintf(stderr, "cannot open %s\n", argv[1]);
    return 1;
  }
  int64_t n_levels, nc, nkpt;
  if (!read_n(f, &n_levels, 1) || !read_n(f, &nc, 1) ||
      !read_n(f, &nkpt, 1)) {
    fprintf(stderr, "bad header\n");
    return 1;
  }

  std::vector<float> boxes, scores;
  for (int64_t lvl = 0; lvl < n_levels; ++lvl) {
    int64_t na, ny, nx, no;
    float stride;
    if (!read_n(f, &na, 1) || !read_n(f, &ny, 1) || !read_n(f, &nx, 1) ||
        !read_n(f, &no, 1) || !read_n(f, &stride, 1)) {
      fprintf(stderr, "bad level header %lld\n", (long long)lvl);
      return 1;
    }
    std::vector<float> anchors(na * 2);
    std::vector<float> raw(na * ny * nx * no);
    if (!read_n(f, anchors.data(), anchors.size()) ||
        !read_n(f, raw.data(), raw.size())) {
      fprintf(stderr, "bad level payload %lld\n", (long long)lvl);
      return 1;
    }
    std::vector<float> dec(raw.size());
    decode_level(raw.data(), na, ny, nx, no, nc, nkpt, anchors.data(),
                 stride, dec.data());
    // two-stage gate: obj > thr, then conf = obj * max(cls) > thr
    // (reference utils/general.py:509-547)
    const int64_t rows = na * ny * nx;
    for (int64_t r = 0; r < rows; ++r) {
      const float* p = dec.data() + r * no;
      const float obj = p[4];
      if (obj <= conf_thres) continue;
      float best_cls = 0.0f;
      for (int64_t c = 0; c < nc; ++c) best_cls = std::max(best_cls, p[5 + c]);
      const float conf = obj * best_cls;
      if (conf <= conf_thres) continue;
      const float cx = p[0], cy = p[1], w = p[2], h = p[3];
      boxes.push_back(cx - w / 2);
      boxes.push_back(cy - h / 2);
      boxes.push_back(cx + w / 2);
      boxes.push_back(cy + h / 2);
      scores.push_back(conf);
    }
  }
  fclose(f);

  const int64_t n = static_cast<int64_t>(scores.size());
  std::vector<int32_t> keep(std::min<int64_t>(max_det, n > 0 ? n : 1));
  const int64_t kept =
      n ? greedy_nms(boxes.data(), scores.data(), n, iou_thres, max_det,
                     keep.data())
        : 0;
  for (int64_t i = 0; i < kept; ++i) {
    const int32_t j = keep[i];
    printf("%.3f %.3f %.3f %.3f %.5f\n", boxes[j * 4 + 0], boxes[j * 4 + 1],
           boxes[j * 4 + 2], boxes[j * 4 + 3], scores[j]);
  }
  return 0;
}
