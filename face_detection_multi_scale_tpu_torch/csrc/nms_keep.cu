// Greedy-NMS keep mask over score-sorted candidates, for sm_90a.
//
// Replaces face_detection_multi_scale_tpu/ops/pallas_nms.py::_kernel_seq
// (reached through nms_keep_pallas); the fixpoint version further down
// replaces its _kernel. Contract, per image b:
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

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
// nms_keep_pallas(kernel_version="fixpoint")): Jacobi sweeps
//   keep'[i] = valid[i] and no j < i with keep[j] and IoU(i, j) > thr,
// each from the previous sweep's keep alone, from keep = valid until a
// sweep changes nothing or K sweeps are done (the TPU kernel's bound). The
// fixpoint is sequential greedy NMS, so the mask equals the seq kernel's;
// reaching it by sweeps, not by a forward scan, is the cross-check.
//
// What bounds it on the card: the TPU kernel recomputes every IoU in every
// sweep. Here pass 1 above (nms_mask_kernel, the seq kernel's, unchanged)
// tests each pair once into the bit rows, and a sweep is integer logic:
//   removed[w] = OR of row i's word w over the kept rows i < 64 (w + 1),
//   keep'[w] = valid bits[w] & ~removed[w].
// A sweep then costs the reads of the kept rows' words (the scratch, 16.8
// MB at B = 8, K = 4096, stays in the 50 MB L2) and one barrier, and a
// chain of suppressions settles about one candidate a sweep, so the design
// keeps a sweep short rather than few:
//   * nms_sweep_kernel: one thread-block cluster of C blocks per image
//     (the wrapper's FIXPOINT_CLUSTER). Rank r owns the words [lo(r),
//     lo(r + 1)) (split_word): word w gathers from 64 (w + 1) rows, so the
//     split evens out each block's share of the triangle's area. Every
//     block keeps the whole keep vector, double-buffered, and the valid
//     bits in shared memory (K / 8 bytes each).
//   * In a sweep a warp takes row tiles (64 rows, one keep word) in turn;
//     g lanes (the owned word count rounded up to a power of two, at most
//     32) read consecutive words of one kept row, so a row's owned words
//     are one coalesced load, 32 / g rows at once and kFixUnroll loads in
//     flight a lane; the words are ORed into the block's `removed` words
//     with shared-memory atomics. Only rows whose keep bit is set are read,
//     and only their words at or right of the diagonal word: pass 1 never
//     writes the others.
//   * A block writes its new words into every block's next buffer through
//     distributed shared memory; a block whose words changed writes the
//     sweep's number into every block's flag of that parity. One
//     barrier.cluster (arrive.release, wait.acquire) ends the sweep; every
//     block then reads the same flag and all stop after the same sweep.
//     Blocks that own no word (K <= 64 (C - 1)) arrive at every barrier all
//     the same.
//   * keep is written once, at the end, each block its own words' rows;
//     rank 0 writes the sweep count (sweeps computed, the last one that
//     changed nothing included, at most K).
constexpr int kFixThreads = 512;
constexpr int kFixUnroll = 8;  // kept rows' words a lane loads together

// The first word of rank r when c ranks split `words` words: the least w
// with w (w + 1) c >= r words (words + 1).
__device__ __forceinline__ int split_word(int r, int c, int words) {
  const long long target = static_cast<long long>(r) * words * (words + 1LL);
  int w = static_cast<int>(
      sqrt(static_cast<double>(target) / c + 0.25) - 0.5);
  w = max(0, min(words, w));
  while (w > 0 && (w - 1LL) * w * c >= target) --w;
  while (w < words && w * (w + 1LL) * c < target) ++w;
  return w;
}

// Grid (C, B), clusters of C blocks along x: blockIdx.y is the image.
__global__ void __launch_bounds__(kFixThreads)
nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                 const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                 int* __restrict__ sweeps, int k, int words) {
  extern __shared__ __align__(16) unsigned long long s_fix[];
  unsigned long long* const s_valid = s_fix + 2 * words;
  unsigned long long* const s_removed = s_fix + 3 * words;  // owned words
  __shared__ int s_flag[2];  // the last sweep, by parity, that changed keep
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int lo = split_word(static_cast<int>(cluster.block_rank()), n_ranks,
                            words);
  const int hi = split_word(static_cast<int>(cluster.block_rank()) + 1,
                            n_ranks, words);
  const int n = hi - lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = static_cast<size_t>(blockIdx.y) * k;
  mask += off * words;
  valid += off;
  keep += off;

  // every row's valid bit, 32 rows a ballot; keep starts as valid
  unsigned* const v32 = reinterpret_cast<unsigned*>(s_valid);
  for (int base = 0; base < 64 * words; base += kFixThreads) {
    const int i = base + tid;
    const unsigned v = __ballot_sync(0xffffffffu, i < k && valid[i] != 0);
    if (lane == 0 && i < 64 * words) v32[i >> 5] = v;
  }
  __syncthreads();
  for (int w = tid; w < words; w += kFixThreads) s_fix[w] = s_valid[w];
  for (int t = tid; t < n; t += kFixThreads) s_removed[t] = 0ull;
  if (tid < 2) s_flag[tid] = 0;
  cluster.sync();  // set before any block writes into another

  int g = 1;  // lanes a row: the owned words, a power of two up to 32
  while (g < n && g < 32) g <<= 1;
  const int at_once = 32 / g, q = lane % g, sub = lane / g;
  int sweep = 0;
  for (;;) {
    // the keep buffers: s_fix[0, words) and s_fix[words, 2 words)
    const unsigned long long* const cur = s_fix + (sweep & 1) * words;
    unsigned long long* const nxt = s_fix + ((sweep + 1) & 1) * words;
    for (int u = warp; u < hi; u += kFixThreads / 32) {  // row tiles
      const unsigned long long kb = cur[u];
      if (kb == 0ull) continue;
      const unsigned long long* rows =
          mask + static_cast<size_t>(u) * kTile * words;
      for (int w0 = max(lo, u); w0 < hi; w0 += g) {
        const int w = w0 + q;
        if (w >= hi) continue;
        unsigned long long acc = 0ull;
        for (int r0 = sub; r0 < kTile; r0 += at_once * kFixUnroll) {
          unsigned long long v[kFixUnroll];
#pragma unroll
          for (int t = 0; t < kFixUnroll; ++t) {
            const int r = r0 + t * at_once;
            v[t] = r < kTile && ((kb >> r) & 1ull)
                       ? __ldg(rows + static_cast<size_t>(r) * words + w)
                       : 0ull;
          }
#pragma unroll
          for (int t = 0; t < kFixUnroll; ++t) acc |= v[t];
        }
        if (acc != 0ull) atomicOr(&s_removed[w - lo], acc);
      }
    }
    __syncthreads();
    ++sweep;
    for (int t = tid; t < n; t += kFixThreads) {
      const int w = lo + t;
      const unsigned long long nw = s_valid[w] & ~s_removed[t];
      s_removed[t] = 0ull;
      for (int p = 0; p < n_ranks; ++p) *cluster.map_shared_rank(nxt + w, p) = nw;
      if (nw != cur[w])
        for (int p = 0; p < n_ranks; ++p)
          *cluster.map_shared_rank(&s_flag[(sweep - 1) & 1], p) = sweep;
    }
    cluster.sync();
    if (s_flag[(sweep - 1) & 1] != sweep || sweep == k) break;
  }
  // no block touches another's shared memory after the last barrier
  const unsigned long long* const fin = s_fix + (sweep & 1) * words;
  for (int i = kTile * lo + tid; i < min(k, kTile * hi); i += kFixThreads)
    keep[i] = static_cast<uint8_t>((fin[i >> 6] >> (i & 63)) & 1ull);
  if (cluster.block_rank() == 0 && tid == 0) sweeps[blockIdx.y] = sweep;
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Clears the error a refused call leaves behind, so the next launch's
// cudaGetLastError() does not report it again.
int fail(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

size_t sweep_smem(int k) {  // two keep buffers, valid bits, removed words
  return 4 * sizeof(unsigned long long) * ((k + kTile - 1) / kTile);
}

cudaLaunchConfig_t sweep_config(int b, int cluster, size_t smem,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b);
  cfg.blockDim = dim3(kFixThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cudaOccupancyMaxActiveClusters for the sweep kernel at (device, cluster,
// shared memory), once per key: the kernel's attributes are set first.
cudaError_t active_clusters(int device, int cluster, size_t smem, int* out) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, size_t>, int> known;
  std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_tuple(device, cluster, smem);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(nms_sweep_kernel), smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sweep_config(1, cluster, smem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(out, nms_sweep_kernel, &cfg);
  if (err == cudaSuccess) known[key] = *out;
  return err;
}

}  // namespace

// How many clusters of `cluster` sweep blocks the card holds at once for K
// candidates (cudaOccupancyMaxActiveClusters) into *out; returns the CUDA
// error (0 on success).
extern "C" int fdms_nms_sweep_clusters(int k, int cluster, int device,
                                       int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return fail(err);
  if (cluster < 1) return fail(cudaErrorInvalidValue);
  err = active_clusters(device, cluster, sweep_smem(k), out);
  return err == cudaSuccess ? 0 : fail(err);
}

// The fixpoint version's sweeps on `stream` of `device`, from pass 1's
// `mask` (fdms_nms_mask's, the same b and k): keep (b, k) bytes and sweeps
// (b) int32, one cluster of `cluster` blocks per image. A cluster size the
// card cannot schedule is an error (cudaErrorLaunchOutOfResources when
// cudaOccupancyMaxActiveClusters gives 0), never a slower launch.
extern "C" int fdms_nms_sweep(const void* mask, const void* valid, void* keep,
                              void* sweeps, int b, int k, int cluster,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return fail(err);
  if (b > 65535 || cluster < 1) return fail(cudaErrorInvalidValue);
  const size_t smem = sweep_smem(k);
  int active = 0;
  err = active_clusters(device, cluster, smem, &active);
  if (err != cudaSuccess) return fail(err);
  if (active < 1) return fail(cudaErrorLaunchOutOfResources);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sweep_config(
      b, cluster, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, nms_sweep_kernel, static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
      static_cast<int*>(sweeps), k, (k + kTile - 1) / kTile);
  if (err != cudaSuccess) return fail(err);
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
