// Greedy-NMS keep mask over score-sorted candidates, for sm_90a.
//
// Replaces face_detection_multi_scale_tpu/ops/pallas_nms.py::_kernel_seq
// (reached through nms_keep_pallas). Contract, per image b:
//   boxes (B, K, 4) f32 xyxy, sorted by descending score; valid (B, K) u8;
//   keep[i] = valid[i] and no j < i with keep[j] and IoU(i, j) > thr,
//   IoU(i, j) = inter / ((area_i + area_j) - inter) in IEEE f32.
// Any K >= 1: the last tile is masked. Boxes must be finite.
//
// What bounds it on the card: operations. A greedy scan of the data needs
// one IoU (about 12 f32 operations, one of them an IEEE division) per pair
// of a candidate and an earlier keeper; the bytes are only the boxes and the
// masks (18 bytes a candidate). But the scan is a chain of dependent
// decisions, and a one-block-per-image walk leaves most of the card idle
// (B blocks on 132 SMs). So the work is split in two kernels on the stream:
//   * pass 1 (nms_mask_kernel) computes every IoU a scan could need, all
//     K^2/2 pairs, over the whole card: one block per (image, row tile,
//     column tile >= row tile), B x T(T+1)/2 blocks of kTile threads, T =
//     ceil(K / 64). Both tiles' boxes are staged in shared memory; thread r
//     writes the 64-bit word of row i = 64 * row tile + r for the column
//     tile: bit c set when j = 64 * column tile + c > i, both are valid and
//     IoU(i, j) > thr. No block depends on another. The words go into a
//     scratch buffer of B x K x ceil(K / 64) words (the wrapper's); words
//     left of the diagonal are never written nor read.
//   * pass 2 (nms_scan_kernel) is one block per image. It walks the row
//     tiles in score order with a `removed` bit vector (ceil(K / 64) words)
//     in shared memory: one thread resolves the tile's 64 rows serially from
//     the diagonal words alone (64 dependent steps on registers), then the
//     block ORs the kept rows' words right of the diagonal into `removed`,
//     each thread one word and a share of the kept rows, loads unrolled so
//     they are in flight together. The next tile's diagonal words are
//     loaded while the current tile's rows are ORed in, since they do not
//     depend on the scan.
// One call of the wrapper is these two launches.
//
// Bit-exactness: the file is built with -fmad=false and the arithmetic
// below uses the explicitly rounded intrinsics, so no multiply-add is
// contracted into an FMA; the division is IEEE (no fast math). Zero-area
// pairs give 0/0 = NaN, and NaN > thr is false, as in the plain version.
// A pair with no intersection skips the division when thr >= 0: 0 / u is
// 0 or NaN, neither > thr, so the bit is the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // rows or columns of a tile == bits of a word

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

// IoU(row r, column c) > thr, with the operation order of the plain version
// (ops/boxes.py::box_iou with r the later candidate, c the earlier one).
__device__ __forceinline__ bool overlaps(float4 r, float ar, float4 c, float ac,
                                         float thr) {
  const float iw = clamp0(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)));
  const float ih = clamp0(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)));
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.f && thr >= 0.f) return false;
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(ar, ac), inter)) > thr;
}

// Pass 1. blockIdx.x enumerates the (row tile, column tile >= row tile)
// pairs row by row, blockIdx.y is the image.
__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                unsigned long long* __restrict__ mask, int k, int n_tiles,
                float thr) {
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];
  __shared__ unsigned s_valid[2];  // the column tile's valid bits
  // pair index p -> (rt, ct): row tile rt starts at rt*T - rt*(rt-1)/2
  const long long p = blockIdx.x;
  const double t2 = 2.0 * n_tiles + 1.0;
  int rt = static_cast<int>((t2 - sqrt(t2 * t2 - 8.0 * p)) / 2.0);
  rt = max(0, min(rt, n_tiles - 1));
  auto first = [n_tiles](long long r) { return r * n_tiles - r * (r - 1) / 2; };
  while (rt > 0 && first(rt) > p) --rt;
  while (rt + 1 < n_tiles && first(rt + 1) <= p) ++rt;
  const int ct = rt + static_cast<int>(p - first(rt));

  const size_t off = static_cast<size_t>(blockIdx.y) * k;
  const int tid = threadIdx.x;
  const int j = ct * kTile + tid;
  const bool jin = j < k;
  const float4 cb = jin ? boxes[off + j] : make_float4(0.f, 0.f, 0.f, 0.f);
  s_box[tid] = cb;
  s_area[tid] = box_area(cb);
  const unsigned vb = __ballot_sync(0xffffffffu, jin && valid[off + j] != 0);
  if ((tid & 31) == 0) s_valid[tid >> 5] = vb;
  __syncthreads();

  const int i = rt * kTile + tid;
  if (i >= k) return;
  const int words = n_tiles;
  unsigned long long bits = 0ull;
  if (valid[off + i] != 0) {
    const float4 me = boxes[off + i];
    const float my_area = box_area(me);
    unsigned long long cols =
        s_valid[0] | static_cast<unsigned long long>(s_valid[1]) << 32;
    if (ct == rt)  // columns j > i only
      cols &= tid == kTile - 1 ? 0ull : ~0ull << (tid + 1);
    while (cols != 0ull) {
      const int c = __ffsll(static_cast<long long>(cols)) - 1;
      cols &= cols - 1ull;
      if (overlaps(s_box[c], s_area[c], me, my_area, thr)) bits |= 1ull << c;
    }
  }
  mask[(off + i) * words + ct] = bits;
}

constexpr int kScanThreads = 256;
constexpr int kUnroll = 8;  // kept rows whose words are loaded together

// Pass 2, one block per image.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int k, int words) {
  extern __shared__ unsigned long long s_removed[];  // words
  __shared__ unsigned long long s_diag[2][kTile];    // diagonal words, ring
  __shared__ unsigned s_vbits[2][2];                 // valid bits, ring
  __shared__ unsigned long long s_kept;
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * k;
  mask += off * words;
  valid += off;
  keep += off;

  // tile t's diagonal words and valid bits into ring slot t % 2 (warps 0-1)
  auto load_diag = [&](int t) {
    if (tid < kTile) {
      const int i = t * kTile + tid;
      const bool in = i < k;
      s_diag[t & 1][tid] = in ? mask[static_cast<size_t>(i) * words + t] : 0ull;
      const unsigned v = __ballot_sync(0xffffffffu, in && valid[i] != 0);
      if ((tid & 31) == 0) s_vbits[t & 1][tid >> 5] = v;
    }
  };
  for (int w = tid; w < words; w += kScanThreads) s_removed[w] = 0ull;
  load_diag(0);
  __syncthreads();
  for (int t = 0; t < words; ++t) {
    if (tid == 0) {  // the tile's rows in order, from the diagonal words
      const unsigned long long vb =
          s_vbits[t & 1][0] |
          static_cast<unsigned long long>(s_vbits[t & 1][1]) << 32;
      const unsigned long long* diag = s_diag[t & 1];
      unsigned long long removed = s_removed[t], kept = 0ull;
#pragma unroll 8
      for (int r = 0; r < kTile; ++r) {
        const unsigned long long bit = 1ull << r;
        if ((vb & bit) && !(removed & bit)) {
          kept |= bit;
          removed |= diag[r];
        }
      }
      s_kept = kept;
    }
    __syncthreads();
    const unsigned long long kept = s_kept;
    if (tid < kTile && t * kTile + tid < k)
      keep[t * kTile + tid] = static_cast<uint8_t>((kept >> tid) & 1ull);
    if (t + 1 < words) load_diag(t + 1);
    // the kept rows' words right of the diagonal into `removed`: `groups`
    // groups of threads split the rows, a group's threads the words
    const int n_w = words - t - 1;
    if (kept != 0ull && n_w > 0) {
      const int groups = max(1, min(kTile / kUnroll, kScanThreads / n_w));
      const int per = kScanThreads / groups;
      const int g = tid / per;
      const unsigned long long* rows =
          mask + static_cast<size_t>(t) * kTile * words;
      for (int w = t + 1 + tid % per; g < groups && w < words; w += per) {
        unsigned long long acc = 0ull;
        for (int r0 = g * kUnroll; r0 < kTile; r0 += groups * kUnroll) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int r = r0 + u;
            if ((kept >> r) & 1ull) acc |= rows[static_cast<size_t>(r) * words + w];
          }
        }
        if (acc != 0ull) atomicOr(&s_removed[w], acc);
      }
    }
    __syncthreads();
  }
}

// The fixpoint version. Replaces
// face_detection_multi_scale_tpu/ops/pallas_nms.py::_kernel (reached through
// nms_keep_pallas(kernel_version="fixpoint")): Jacobi sweeps over the whole
// candidate list,
//   keep'[i] = valid[i] and no j < i with keep[j] and IoU(i, j) > thr,
// from keep = valid, until a sweep changes nothing (at most K sweeps, as the
// TPU kernel bounds its loop). The fixpoint is sequential greedy NMS, so the
// result equals the seq kernel's. Bounded by operations like the seq kernel,
// but doing sweeps x K^2/2 IoU tests at worst; the design keeps only the two
// keep vectors in shared memory (2K bytes), reads the boxes from device
// memory (cached: every lane of a warp reads the same column j at once), and
// tests a pair only where keep[j] is set. One block per image.
constexpr int kFixThreads = 256;
__global__ void __launch_bounds__(kFixThreads)
nms_keep_fixpoint_kernel(const float4* __restrict__ boxes,
                         const uint8_t* __restrict__ valid,
                         uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* s_old = smem;      // keep before the sweep
  uint8_t* s_new = smem + k;  // keep after it
  const size_t off = static_cast<size_t>(blockIdx.x) * k;
  boxes += off;
  valid += off;
  keep += off;

  for (int i = threadIdx.x; i < k; i += blockDim.x) s_old[i] = valid[i] != 0;
  __syncthreads();
  for (int sweep = 0; sweep < k; ++sweep) {
    int changed = 0;
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      uint8_t v = valid[i] != 0;
      if (v) {
        const float4 me = boxes[i];
        const float my_area = box_area(me);
        for (int j = 0; j < i; ++j) {
          if (!s_old[j]) continue;
          const float4 c = boxes[j];
          if (overlaps(me, my_area, c, box_area(c), thr)) {
            v = 0;
            break;
          }
        }
      }
      s_new[i] = v;
      changed |= v != s_old[i];
    }
    changed = __syncthreads_or(changed);  // every s_new written, s_old read
    if (!changed) break;
    for (int i = threadIdx.x; i < k; i += blockDim.x) s_old[i] = s_new[i];
    __syncthreads();
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) keep[i] = s_old[i];
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Launches the fixpoint kernel; the same interface as fdms_nms_keep below.
extern "C" int fdms_nms_keep_fixpoint(const void* boxes, const void* valid,
                                      void* keep, int b, int k, float thr,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * static_cast<size_t>(k);
  err = set_smem(reinterpret_cast<const void*>(nms_keep_fixpoint_kernel),
                 smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_keep_fixpoint_kernel<<<b, kFixThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1 on `stream` of `device`; returns cudaGetLastError() (0 on
// success). boxes: (b, k, 4) f32, 16-byte aligned; valid: (b, k) bytes;
// mask: b * k * ceil(k / 64) 64-bit words, allocated by the caller.
extern "C" int fdms_nms_mask(const void* boxes, const void* valid, void* mask,
                             int b, int k, float thr, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long t = (k + kTile - 1) / kTile;
  const long long pairs = t * (t + 1) / 2;
  if (b > 65535 || pairs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  nms_mask_kernel<<<dim3(static_cast<unsigned>(pairs), b), kTile, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<unsigned long long*>(mask), k, static_cast<int>(t), thr);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: the keep mask (b, k) bytes from pass 1's words; the same pointers
// and shape as fdms_nms_mask.
extern "C" int fdms_nms_scan(const void* mask, const void* valid, void* keep,
                             int b, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int words = (k + kTile - 1) / kTile;
  const size_t smem = sizeof(unsigned long long) * words;
  err = set_smem(reinterpret_cast<const void*>(nms_scan_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<b, kScanThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k,
      words);
  return static_cast<int>(cudaGetLastError());
}
