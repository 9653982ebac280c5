// Greedy-NMS keep mask over score-sorted candidates, for sm_90a.
//
// Replaces face_detection_multi_scale_tpu/ops/pallas_nms.py::_kernel_seq
// (reached through nms_keep_pallas). Contract, per image b:
//   boxes (B, K, 4) f32 xyxy, sorted by descending score; valid (B, K) u8;
//   keep[i] = valid[i] and no j < i with keep[j] and IoU(i, j) > thr,
//   IoU(i, j) = inter / ((area_i + area_j) - inter) in IEEE f32.
// Any K >= 1: the last tile is masked. Boxes must be finite.
//
// What bounds it on the card: operations. The greedy scan needs one IoU
// (about 12 f32 operations, one of them an IEEE division) per pair of a
// candidate and an earlier keeper; the bytes are only the boxes and the
// masks (18 bytes a candidate). The design therefore works from shared
// memory and never writes the K x K suppression matrix anywhere, which is
// the property the TPU kernel was built for:
//   * one block per image walks the candidates in score order, one tile of
//     kTile rows at a time, one row per thread;
//   * a tile is first cleared against the FINAL keep bits of the earlier
//     tiles: each earlier tile that kept something is staged through shared
//     memory as one chunk, and every thread tests its row against the set
//     bits only (so the work follows the number of keepers, not K^2/2);
//   * the tile's own strict lower triangle is then resolved in order: each
//     thread writes a bit row of overlaps with earlier rows of the tile, and
//     one warp scans the rows, holding the tile's keep bits in its lanes;
//   * keep bits for the whole image live in shared memory (K/8 bytes), so
//     K = 16384 (256 KB of boxes, above what a block may hold) works: the
//     boxes stay in device memory and only one chunk is resident at a time.
// Making it fast (more than B blocks, warp-level scans of the external
// phase, bit-packed rows across blocks) is later work.
//
// Bit-exactness: the file is built with -fmad=false and the arithmetic
// below uses the explicitly rounded intrinsics, so no multiply-add is
// contracted into an FMA; the division is IEEE (no fast math). Zero-area
// pairs give 0/0 = NaN, and NaN > thr is false, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;          // rows per tile == threads per block
constexpr int kWords = kTile / 32;  // 32-bit keep words per tile

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

// IoU(row r, column c) > thr, with the operation order of the plain version.
__device__ __forceinline__ bool overlaps(float4 r, float ar, float4 c, float ac,
                                         float thr) {
  const float iw = clamp0(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)));
  const float ih = clamp0(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)));
  const float inter = __fmul_rn(iw, ih);
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(ar, ac), inter)) > thr;
}

size_t smem_bytes(int k) {
  const int n_tiles = (k + kTile - 1) / kTile;
  return sizeof(float4) * kTile            // s_box
         + sizeof(float) * kTile           // s_area
         + sizeof(unsigned) * kTile * kWords  // s_ov
         + sizeof(unsigned) * kWords       // s_alive
         + sizeof(unsigned) * n_tiles * kWords;  // s_keep
}

__global__ void __launch_bounds__(kTile)
nms_keep_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);         // chunk or tile boxes
  float* s_area = reinterpret_cast<float*>(s_box + kTile);  // their areas
  unsigned* s_ov = reinterpret_cast<unsigned*>(s_area + kTile);  // [w][row]
  unsigned* s_alive = s_ov + kTile * kWords;  // tile rows still alive, bits
  unsigned* s_keep = s_alive + kWords;        // final keep bits, whole image

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t off = static_cast<size_t>(blockIdx.x) * k;
  boxes += off;
  valid += off;
  keep += off;
  const int n_tiles = (k + kTile - 1) / kTile;

  for (int w = tid; w < n_tiles * kWords; w += kTile) s_keep[w] = 0u;
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int i = t * kTile + tid;
    const bool in = i < k;
    const float4 me = in ? boxes[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float my_area = box_area(me);
    bool alive = in && valid[i] != 0;

    // 1) suppression by the final keeps of the earlier tiles, one earlier
    //    (always full) tile per shared-memory chunk
    for (int c = 0; c < t; ++c) {
      const unsigned* kw = s_keep + c * kWords;
      unsigned any = 0u;
      for (int w = 0; w < kWords; ++w) any |= kw[w];
      if (any == 0u) continue;  // the same for every thread of the block
      __syncthreads();          // the previous chunk's readers are done
      const float4 cb = boxes[c * kTile + tid];
      s_box[tid] = cb;
      s_area[tid] = box_area(cb);
      __syncthreads();
      for (int w = 0; w < kWords && alive; ++w) {
        unsigned m = kw[w];
        while (m != 0u) {
          const int j = w * 32 + __ffs(m) - 1;
          m &= m - 1u;
          if (overlaps(me, my_area, s_box[j], s_area[j], thr)) {
            alive = false;
            break;
          }
        }
      }
    }

    // 2) the tile's strict lower triangle, resolved in score order
    __syncthreads();  // the last chunk's readers are done
    s_box[tid] = me;
    s_area[tid] = my_area;
    const unsigned alive_bits = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) s_alive[warp] = alive_bits;
    __syncthreads();
    for (int w = 0; w < kWords; ++w) {
      unsigned bits = 0u;
      if (alive) {
        const int n = min(32, tid - w * 32);  // columns j < tid only
        const unsigned cols = s_alive[w];     // dead columns never keep
        for (int jj = 0; jj < n; ++jj) {
          const int j = w * 32 + jj;
          if (((cols >> jj) & 1u) &&
              overlaps(me, my_area, s_box[j], s_area[j], thr))
            bits |= 1u << jj;
        }
      }
      s_ov[w * kTile + tid] = bits;
    }
    __syncthreads();
    if (warp == 0) {
      unsigned kept = 0u;  // lane w holds keep word w of this tile
      const int rows = min(kTile, k - t * kTile);
      for (int r = 0; r < rows; ++r) {
        const unsigned hit = lane < kWords ? (s_ov[lane * kTile + r] & kept) : 0u;
        const bool suppressed = __any_sync(0xffffffffu, hit != 0u);
        if (!suppressed && lane == (r >> 5) && ((s_alive[r >> 5] >> (r & 31)) & 1u))
          kept |= 1u << (r & 31);
      }
      if (lane < kWords) s_keep[t * kWords + lane] = kept;
    }
    __syncthreads();
    if (in) keep[i] = static_cast<uint8_t>((s_keep[t * kWords + warp] >> lane) & 1u);
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
__global__ void __launch_bounds__(kTile)
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
  nms_keep_fixpoint_kernel<<<b, kTile, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}

// Launches the kernel on `stream` of `device` and returns cudaGetLastError()
// (0 on success). boxes: (b, k, 4) f32, 16-byte aligned; valid, keep: (b, k)
// bytes. The caller allocates `keep`.
extern "C" int fdms_nms_keep(const void* boxes, const void* valid, void* keep,
                             int b, int k, float thr, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_keep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_keep_kernel<<<b, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}
