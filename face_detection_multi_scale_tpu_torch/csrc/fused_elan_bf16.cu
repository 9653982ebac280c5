// One fused E-ELAN group per launch in bf16, for sm_90a: the TMA route.
//
// Replaces face_detection_multi_scale_tpu/ops/pallas_elan.py::_elan_kernel
// (wrapper fused_elan) with dtype bfloat16, for the inputs that the plan
// (ops/elan_kernel.elan_tma_plan) routes here: channels_last (NHWC) x,
// every channel count a multiple of 8 (whole 16-byte runs), 16-byte
// aligned pointers, at most 4 chain convs. csrc/fused_elan.cu's bf16
// instantiation (fdms_fused_elan_bf16) takes the rest; the plan routes,
// this file launches what it is given or fails.
//
// The group, each conv followed by act(acc + bias): x = optional absorbed
// 3x3 stride-s "pre" conv of the input, a = 1x1(x), b = 1x1(x), y1 =
// 3x3(b), yk = 3x3(y_{k-1}), out = 1x1(concat(members)), SAME zero padding
// of every 3x3. It computes what _elan_kernel computes with dtype bf16, at
// the same rounding points: bf16 operands with f32 products and sums, bias
// and activation in f32, then a round to nearest even to bf16 of every
// member, chain step, absorbed pre conv and the output.
//
// What bounds it on the card: operations, at 989 TFLOP/s (bf16 tensor
// cores), the group's bytes (x, weights, out once) over 3.35 TB/s being
// smaller. The design:
//   * whole groups for full-width strips of th output rows (a persistent
//     loop over (image, strip)): every intermediate is recomputed on the
//     strip's vertical halo (n_chain rows for b, one less a chain conv), so
//     one launch does the group. Strips span the image's width, so a window
//     of any conv is whole rows of the image and its positions, flattened
//     row-major, are one run of TMA's im2col walk: over the group input's
//     own NHWC tensor, or over a workspace window. Images of at most
//     `single` rows are one strip without halo, each conv a SAME conv over
//     the image. Only the window's rows inside the image are computed; a
//     window row outside it is stored as zeros (the SAME padding that the
//     next 3x3 reads), and TMA's zero fill supplies the padding columns;
//   * the intermediates of a strip live in the team's slot of each region
//     of a device workspace (region-major: region r holds teams windows of
//     its rows x W x C, so each region is one 4-D NHWC tensor, N = team).
//     A cluster of up to 8 blocks shares a strip and deals each conv's
//     (position, channel) block steps out, meeting at a cluster barrier
//     after each conv whose output another conv reads;
//   * a block is a producer warpgroup (one thread issues), two consumer
//     warpgroups and an epilogue warpgroup, one block an SM. The producer
//     keeps a ring of kStages stages full by TMA, each completing on a full
//     mbarrier: a stage is one tap and 64 channels (128-byte rows) of 128
//     positions (one im2col load) and the weights' 64 x N box (64-row
//     tiled loads of the packed weights). The consumers issue
//     wgmma.m64nNk16 bf16 -> f32 with A and B both from shared memory
//     through 128-byte-swizzle descriptors (TMA writes that swizzle), four
//     k16 steps a stage, keep one stage's products in flight
//     (wait_group 1) and release the stage before on its empty mbarrier.
//     The sums stay in the accumulators over a block step's whole K (bf16
//     results are rounded to 8 bits; the tolerance is 1e-2 of max |plain|).
//     No block barrier is left in the K loop. setmaxnreg moves registers
//     from the producer to the consumers at run time (ptxas compiles every
//     role within the launch bound's 128 a thread);
//   * N, the output channels of a block step, is 64 or 128 per conv,
//     chosen by the plan from c_out, so A is staged once for up to 128
//     channels; M is 128 positions, a warpgroup 64. An N of 256 (128 f32
//     accumulators a thread) was built and measured: at the launch bound's
//     168 registers a thread (a 384-thread block) ptxas spilled and
//     serialized every wgmma of the kernel, and the first eight card cases
//     took 13.0 ms against 5.04 without it (PERF.md);
//   * the weights reach the kernel packed once, where the group's weights
//     are built (ops/elan_kernel.pack_tma_weights, ElanWeights): each
//     conv's K steps in order, a step's c_out x 64 block contiguous (zero
//     past a source's channels), one 2-D map over all of them;
//   * the consumers hand a block step's f32 sums to the epilogue warpgroup
//     through shared memory and go on to the next block step; the epilogue
//     adds the bias, applies the activation in f32 (silu as v / (1 +
//     exp(-v)), as csrc/fused_elan.cu computes it), rounds to bf16 and
//     stores 16-byte runs (NHWC: a position's channels are
//     contiguous in the workspace and in the channels_last output), while
//     the tensor cores work on the next block step;
//   * the workspace's epilogue stores (generic proxy) reach the other
//     blocks' TMA loads (async proxy) through fence.proxy.async and the
//     cluster barrier's release / acquire.
// The plan in ops/elan_kernel.py computes every window, map, corner and
// weight row; tests/test_torch_elan_bf16_route.py emulates this walk.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The roles, a warpgroup each or two: the consumers (the products), the
// epilogue (bias, activation, stores), the producer (one thread issues the
// copies). setmaxnreg gives the producer's registers to the consumers.
constexpr int kConsumers = 256;
constexpr int kEpiThreads = 128;
constexpr int kThreads = kConsumers + kEpiThreads + 128;
constexpr int kProducer = kConsumers + kEpiThreads;  // its issuing thread
// ptxas allots every thread the launch bound's share of the register file
// (kRegs); at run time the producer gives all but 40 of its own to the
// consumers (kConsumerRegs), as much as their count lets them take
constexpr int kRegs = 65536 / kThreads / 8 * 8;
constexpr int kConsumerRegs =
    kRegs + (kRegs - 40) * 128 / kConsumers / 8 * 8;
static_assert(kConsumerRegs <= 256, "setmaxnreg takes at most 256");
constexpr int kBM = 128;                    // positions a block step
constexpr int kKC = 64;                     // channels a stage (128 bytes)
constexpr int kStages = 4;                  // the TMA ring
constexpr int kBNMax = 128;
constexpr int kATile = kBM * kKC * 2;       // 16 KB
constexpr int kBTile = kBNMax * kKC * 2;    // 16 KB
// the f32 sums a block step hands from the consumers to the epilogue:
// 128 rows of kBNMax + 8 floats (the pad spreads a warp's float2 stores
// over the 32 banks)
constexpr int kHandPitch = kBNMax + 8;
constexpr int kOffB = kStages * kATile;
constexpr int kOffHand = kOffB + kStages * kBTile;
constexpr int kOffBar = kOffHand + kBM * kHandPitch * 4;
constexpr int kSmem = kOffBar + 16 * kStages + 1024;  // + alignment
static_assert(kSmem <= 232448, "shared memory");

constexpr int kMaxConvs = 8;    // pre, b, a, y1..y4, out
constexpr int kMaxSrc = 6;      // the transition's members
constexpr int kMaxMaps = 16;
constexpr int kMaxRegions = 8;

enum Act { kSilu = 0, kLeaky = 1, kRelu = 2 };

// The profiling build (-DFDMS_ELAN_PROFILE; tools/elan_profile.py): the
// first thread of each consumer warpgroup (slots 0, 1), of the epilogue
// warpgroup (slot 2) and the producer's issuing thread (slot 3) add the
// clocks of each phase into their block's slots. Consumers: wait (a
// stage's full mbarrier), math, hand (the last products and the hand-over,
// waiting for the epilogue to be done with the last one); epilogue: hand
// wait (for the consumers' sums), epilogue (bias, activation, stores),
// zero (rows outside the image); all: cluster sync; the producer: its
// empty-mbarrier waits.
enum Phase {
  kWait, kMath, kHand, kHandWait, kEpilogue, kZero, kClusterSync,
  kProducerWait, kTotal, kSteps, kPhases
};
#ifdef FDMS_ELAN_PROFILE
constexpr int kProfBlocks = 1024;
__device__ unsigned long long g_prof[kProfBlocks][4][kPhases];
#define PROF_T(t) const long long t = clock64()
#define PROF_ADD(slot, phase, v) \
  if (blockIdx.x < kProfBlocks) g_prof[blockIdx.x][slot][phase] += (v)
#else
#define PROF_T(t)
#define PROF_ADD(slot, phase, v)
#endif
#define PROF_SINCE(slot, phase, t) PROF_ADD(slot, phase, clock64() - t)

// One source of a conv: an im2col map over the group input (image) or a
// workspace region, its corners' lower offsets (the first output column's
// and, for a region, the output window's first row's window corner), the
// traversal stride, taps (1 or 9) and channels.
struct SrcDesc {
  int8_t map, lw, lh, stride, image, taps;
  int16_t cin;
};

struct ConvDesc {
  SrcDesc src[kMaxSrc];
  int n_src, c_out, bn;
  int dst;      // region index, or -1: the output
  int o_dst;    // the output window: rows ty - o_dst .. ty + th + o_dst
  int w_row;    // first row (of 64 bf16) of the packed weights
  int k_steps;  // stages a block step: taps x ceil(cin / 64) summed
  int sync;     // a cluster barrier after this conv
};

struct Region {
  long long off;  // element offset in the workspace
  int c, rows;    // channels; window rows (teams windows of rows x w x c)
};

struct Params {
  CUtensorMap maps[kMaxMaps];
  CUtensorMap wmap;
  ConvDesc conv[kMaxConvs];
  Region reg[kMaxRegions];
  const float* bias[kMaxConvs];
  uint16_t* out;  // (batch, h, w, cout) bf16 bits
  uint16_t* ws;
  int batch, h, w, th, strips, n_conv, cluster, act, zero_rows;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 128 positions' inputs for one tap and 64 channels from c: the im2col box
// whose first position's window corner is (w, h) of image / team n, read
// at tap offset (dx, dy), completing on `bar`.
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int c, int w, int h,
                                           int n, uint16_t dx, uint16_t dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h),
      "r"(n), "h"(dx), "h"(dy)
      : "memory");
}

// The 64 x 64 weight box at packed row `row`.
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row)
      : "memory");
}

// wgmma's descriptor of a K-major operand in 128-byte rows, 128-byte
// swizzle: start address, leading offset (unused: a k16 step's 32 bytes lie
// in one swizzled row; 1 by convention), stride offset 1024 (8 rows). A
// k16 step at byte kk of the rows takes the start address + kk.
__device__ __forceinline__ uint64_t sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) | 1ull << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// d (+)= A B^T over 16 K: the warpgroup's 64 positions x N channels, A and
// B K-major bf16 through their descriptors, f32 sums; scale_d = 0
// overwrites d. Element 4 j + 2 h + e of d is (position 16 warp + g + 8 h,
// channel 8 j + 2 t4 + e), g = lane / 4, t4 = lane % 4.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across a wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Every thread of the cluster here; the writes before visible after
// (release / acquire), and the generic proxy's global writes ordered before
// the async proxy's (TMA's) reads of them.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kSilu) return v / (1.0f + expf(-v));
  if (act == kLeaky) return v > 0.0f ? v : v * 0.1f;
  return v > 0.0f ? v : 0.0f;
}

__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Where a conv of the current strip stands: its output window's first row,
// the rows inside the image and the positions M (those rows x w).
struct Window {
  int wy0, y_lo, m;
};

__device__ __forceinline__ Window window(const Params& P, const ConvDesc& C,
                                         int ty) {
  Window g;
  g.wy0 = ty - C.o_dst;
  g.y_lo = max(g.wy0, 0);
  const int y_hi = min(ty + P.th + C.o_dst, P.h);
  g.m = max(y_hi - g.y_lo, 0) * P.w;
  return g;
}

// The producer warpgroup (its first thread issues; the others meet the
// cluster barriers): every stage of every block step of this block, in the
// consumers' order.
__device__ __forceinline__ void produce(const Params& P, uint32_t s_a,
                                        uint32_t s_b, uint32_t full,
                                        uint32_t empty, int rank, int team,
                                        int teams) {
  const bool lead = threadIdx.x == kProducer;
  const int n_tiles = P.batch * P.strips;
  int it = 0;
  for (int tile = team; tile < n_tiles; tile += teams) {
    const int n = tile / P.strips;
    const int ty = (tile % P.strips) * P.th;
    for (int c = 0; c < P.n_conv; ++c) {
      const ConvDesc& C = P.conv[c];
      const Window g = window(P, C, ty);
      const int n_nb = (C.c_out + C.bn - 1) / C.bn;
      const int steps = lead ? (g.m + kBM - 1) / kBM * n_nb : 0;
      const uint32_t bytes = kATile + C.bn * kKC * 2;
      for (int t = rank; t < steps; t += P.cluster) {
        const int m0 = t / n_nb * kBM, n0 = t % n_nb * C.bn;
        const int y = g.y_lo + m0 / P.w, x = m0 % P.w;
        int row = C.w_row + n0;
        for (int si = 0; si < C.n_src; ++si) {
          const SrcDesc S = C.src[si];
          const int k = S.taps == 9 ? 3 : 1;
          const int col = S.lw + x * S.stride;
          const int hrow = S.lh + (S.image ? y * S.stride : y - g.wy0);
          const int nn = S.image ? n : team;
          for (int cb = 0; cb < S.cin; cb += kKC) {
            for (int tap = 0; tap < S.taps; ++tap, ++it, row += C.c_out) {
              const int s = it % kStages;
              if (it >= kStages) {
                PROF_T(t0);
                mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
                PROF_SINCE(3, kProducerWait, t0);
              }
              mbar_expect_tx(full + 8 * s, bytes);
              tma_im2col(s_a + s * kATile, &P.maps[S.map], full + 8 * s, cb,
                         col, hrow, nn, static_cast<uint16_t>(tap % k),
                         static_cast<uint16_t>(tap / k));
              for (int i = 0; i < C.bn; i += 64)
                tma_rows(s_b + s * kBTile + i * kKC * 2, &P.wmap,
                         full + 8 * s, row + i);
            }
          }
        }
      }
      __syncwarp();
      if (C.sync) cluster_sync();
    }
  }
}

// Named barriers (0 is __syncthreads'): the hand-over of a block step's
// sums from the consumers (arrive) to the epilogue (sync), and back.
enum Barrier { kHandFull = 1, kHandEmpty = 2 };

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kConsumers + kEpiThreads)
               : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(kConsumers + kEpiThreads)
               : "memory");
}

// One block step of the consumers: the products over its whole K, then the
// sums handed to the epilogue warpgroup through shared memory (once it is
// done with the last ones), and on to the next block step. `it` counts the
// ring's stages, as the producer does; `handed` the hand-overs.
template <int BN>
__device__ __forceinline__ void block_step(const ConvDesc& C, uint32_t s_a,
                                           uint32_t s_b, uint32_t full,
                                           uint32_t empty, float* hand,
                                           int& it, int& handed) {
  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 127) == 0;
  float acc[BN / 2];
  const int nk = C.k_steps;
  for (int j = 0; j < nk; ++j, ++it) {
    const int s = it % kStages;
    PROF_T(t0);
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    PROF_T(t1);
    const uint32_t a = s_a + s * kATile + wg * 64 * kKC * 2;
    const uint32_t b = s_b + s * kBTile;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC * 2; kk += 32)
      wgmma_ss(acc, sw128(a + kk), sw128(b + kk), j > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // stage it - 1's products are done: free it
    fence_acc(acc);
    if (j > 0 && leader) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    if (leader) {
      PROF_ADD(wg, kWait, t1 - t0);
      PROF_SINCE(wg, kMath, t1);
      PROF_ADD(wg, kSteps, 1);
    }
  }
  PROF_T(t2);
  wgmma_wait<0>();
  fence_acc(acc);
  if (leader) mbar_arrive(empty + 8 * ((it - 1) % kStages));
  // element 4 j + 2 h + e is (row 64 wg + 16 warp + g + 8 h, channel 8 j +
  // 2 t4 + e)
  const int lane = threadIdx.x & 31;
  const int row = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float* dst = hand + row * kHandPitch + 2 * (lane & 3);
  if (handed > 0) named_sync(kHandEmpty);  // the last sums are read
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(dst + 8 * h * kHandPitch + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __threadfence_block();
  named_arrive(kHandFull);
  ++handed;
  if (leader) PROF_SINCE(wg, kHand, t2);
}

// The consumer warpgroups: every block step of this block.
__device__ __forceinline__ void consume(const Params& P, uint32_t s_a,
                                        uint32_t s_b, uint32_t full,
                                        uint32_t empty, uint8_t* smem,
                                        int rank, int team, int teams) {
  const int tid = threadIdx.x;
  float* hand = reinterpret_cast<float*>(smem + kOffHand);
  const int n_tiles = P.batch * P.strips;
  int it = 0, handed = 0;
  for (int tile = team; tile < n_tiles; tile += teams) {
    const int ty = (tile % P.strips) * P.th;
    for (int c = 0; c < P.n_conv; ++c) {
      const ConvDesc& C = P.conv[c];
      const Window g = window(P, C, ty);
      const int n_nb = (C.c_out + C.bn - 1) / C.bn;
      const int steps = (g.m + kBM - 1) / kBM * n_nb;
      for (int t = rank; t < steps; t += P.cluster) {
        if (C.bn == 128)
          block_step<128>(C, s_a, s_b, full, empty, hand, it, handed);
        else
          block_step<64>(C, s_a, s_b, full, empty, hand, it, handed);
      }
      if (C.sync) {
        PROF_T(t1);
        cluster_sync();
        if ((tid & 127) == 0) PROF_SINCE(tid >> 7, kClusterSync, t1);
      }
    }
  }
  if (handed > 0) named_sync(kHandEmpty);  // the epilogue's last arrival
}

// The epilogue warpgroup: each block step's handed sums plus the bias, the
// activation in f32, rounded to bf16 and stored as 16-byte runs (a lane 8
// channels of one position, 8 lanes 128 contiguous bytes), while the
// consumers run the next block step; then after each conv the zero rows of
// its window outside the image (halo strips only).
__device__ __forceinline__ void finish(const Params& P, uint8_t* smem,
                                       int rank, int team, int teams) {
  // a warp stores 4 positions at a time, the warpgroup(s) kEpiRows
  constexpr int kEpiRows = kEpiThreads / 8;
  constexpr int kRowsE = kBM / kEpiRows;
  const int e = threadIdx.x - kConsumers;
  const int lane = e & 31, ew = e >> 5;
  const float* hand = reinterpret_cast<const float*>(smem + kOffHand);
  const int act = P.act;
  const int n_tiles = P.batch * P.strips;
  for (int tile = team; tile < n_tiles; tile += teams) {
    const int n = tile / P.strips;
    const int ty = (tile % P.strips) * P.th;
    for (int c = 0; c < P.n_conv; ++c) {
      const ConvDesc& C = P.conv[c];
      const Window g = window(P, C, ty);
      const float* bias = P.bias[c];
      // position (y, x) is row `rows0 + y` of `base`'s (rows, w, c_out)
      // view: the output image n, or the team's window of the region
      uint16_t* base;
      long long rows0;
      if (C.dst < 0) {
        base = P.out;
        rows0 = static_cast<long long>(n) * P.h;
      } else {
        const Region& r = P.reg[C.dst];
        base = P.ws + r.off;
        rows0 = static_cast<long long>(team) * r.rows - g.wy0;
      }
      const int n_nb = (C.c_out + C.bn - 1) / C.bn;
      const int steps = (g.m + kBM - 1) / kBM * n_nb;
      for (int t = rank; t < steps; t += P.cluster) {
        const int m0 = t / n_nb * kBM, n0 = t % n_nb * C.bn;
        // this lane's kRowsE positions (rows kEpiRows i + 4 ew + lane / 8)
        // and their destinations, null past the window's last position
        uint16_t* dst[kRowsE];
#pragma unroll
        for (int i = 0; i < kRowsE; ++i) {
          const int m = m0 + kEpiRows * i + 4 * ew + (lane >> 3);
          dst[i] = nullptr;
          if (m < g.m) {
            const int q = m / P.w;
            dst[i] = base + ((rows0 + g.y_lo + q) * P.w + (m - q * P.w)) *
                                C.c_out;
          }
        }
        PROF_T(t0);
        named_sync(kHandFull);
        PROF_T(t1);
        for (int c8 = 8 * (lane & 7); c8 < C.bn; c8 += 64) {
          const int co = n0 + c8;
          if (co >= C.c_out) break;
          const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + co));
          const float4 b1 =
              __ldg(reinterpret_cast<const float4*>(bias + co + 4));
#pragma unroll
          for (int i = 0; i < kRowsE; ++i) {
            const float* src =
                hand + (kEpiRows * i + 4 * ew + (lane >> 3)) * kHandPitch + c8;
            const float4 v0 = *reinterpret_cast<const float4*>(src);
            const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
            uint4 o;
            o.x = pack_bf16(activate(v0.x + b0.x, act),
                            activate(v0.y + b0.y, act));
            o.y = pack_bf16(activate(v0.z + b0.z, act),
                            activate(v0.w + b0.w, act));
            o.z = pack_bf16(activate(v1.x + b1.x, act),
                            activate(v1.y + b1.y, act));
            o.w = pack_bf16(activate(v1.z + b1.z, act),
                            activate(v1.w + b1.w, act));
            if (dst[i] != nullptr)
              *reinterpret_cast<uint4*>(dst[i] + co) = o;
          }
        }
        named_arrive(kHandEmpty);
        if (e == 0) {
          PROF_ADD(2, kHandWait, t1 - t0);
          PROF_SINCE(2, kEpilogue, t1);
          PROF_ADD(2, kSteps, 1);
        }
      }
      if (C.dst >= 0 && P.zero_rows) {
        // the window's rows outside the image, as zeros: 16-byte runs
        PROF_T(t2);
        const Region& r = P.reg[C.dst];
        const int wh = P.th + 2 * C.o_dst;
        const int above = max(-g.wy0, 0);
        const int below = max(g.wy0 + wh - P.h, 0);
        const long long row_runs = static_cast<long long>(P.w) * C.c_out / 8;
        const long long runs = (above + below) * row_runs;
        int4* zbase = reinterpret_cast<int4*>(
            P.ws + r.off + static_cast<long long>(team) * r.rows * P.w * C.c_out);
        for (long long q = rank * kEpiThreads + e; q < runs;
             q += static_cast<long long>(P.cluster) * kEpiThreads) {
          const long long rr = q / row_runs;
          const long long wrow = rr < above ? rr : wh - below + (rr - above);
          zbase[wrow * row_runs + q % row_runs] = make_int4(0, 0, 0, 0);
        }
        if (e == 0) PROF_SINCE(2, kZero, t2);
      }
      if (C.sync) {
        PROF_T(t3);
        cluster_sync();
        if (e == 0) PROF_SINCE(2, kClusterSync, t3);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_elan_tma_kernel(const __grid_constant__ Params P) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  PROF_T(t_kernel);
  const uint32_t s_a = smem_u32(smem);
  const uint32_t s_b = s_a + kOffB;
  const uint32_t full = s_a + kOffBar;        // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStages;  // empty[s] at empty + 8 s
  const int rank = static_cast<int>(blockIdx.x) % P.cluster;
  const int team = static_cast<int>(blockIdx.x) / P.cluster;
  const int teams = static_cast<int>(gridDim.x) / P.cluster;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the role, warp-uniform by construction (so ptxas can allot each role
  // its registers)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kProducer / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    produce(P, s_a, s_b, full, empty, rank, team, teams);
    if (threadIdx.x == kProducer) PROF_SINCE(3, kTotal, t_kernel);
  } else if (role >= kConsumers / 128) {
    finish(P, smem, rank, team, teams);
    if (threadIdx.x == kConsumers) PROF_SINCE(2, kTotal, t_kernel);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    consume(P, s_a, s_b, full, empty, smem, rank, team, teams);
    if ((threadIdx.x & 127) == 0) PROF_SINCE(threadIdx.x >> 7, kTotal, t_kernel);
  }
}

// the driver's tensor-map encoders, looked up once through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

void* driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? fn
                                                                    : nullptr;
}

struct Encoders {
  EncodeTiled tiled;
  EncodeIm2col im2col;
};

const Encoders& encoders() {
  static const Encoders e{
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled")),
      reinterpret_cast<EncodeIm2col>(
          driver_entry("cuTensorMapEncodeIm2col"))};
  return e;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One im2col map: (C, W, H, N) bf16 at `base`, N `n_stride` elements apart,
// the bounding box's corners, the traversal stride; boxes of 128 positions
// x 64 channels, 128-byte swizzle, zeros outside the tensor.
cudaError_t encode_im2col(CUtensorMap* map, void* base, const long long* m) {
  const long long c = m[2], w = m[3], h = m[4], n = m[5], n_stride = m[6];
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * c),
                                 static_cast<cuuint64_t>(2 * w * c),
                                 static_cast<cuuint64_t>(2 * n_stride)};
  const int lower[2] = {static_cast<int>(m[7]), static_cast<int>(m[8])};
  const int upper[2] = {static_cast<int>(m[9]), static_cast<int>(m[10])};
  const cuuint32_t traversal[4] = {1, static_cast<cuuint32_t>(m[11]),
                                   static_cast<cuuint32_t>(m[11]), 1};
  if (!aligned16(base)) return cudaErrorInvalidValue;
  const CUresult r = encoders().im2col(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, lower,
      upper, kKC, kBM, traversal, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The packed weights: (rows, 64) bf16, 64 x 64 boxes, 128-byte swizzle.
cudaError_t encode_weights(CUtensorMap* map, void* base, long long rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kKC),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kKC * 2};
  const cuuint32_t box[2] = {kKC, 64};
  const cuuint32_t unit[2] = {1, 1};
  if (!aligned16(base)) return cudaErrorInvalidValue;
  const CUresult r = encoders().tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

#ifdef FDMS_ELAN_PROFILE
// The profiling build's counters: copies blocks x 4 x kPhases of them (the
// two consumer warpgroups, the epilogue, the producer) into `out` (at most
// kProfBlocks blocks), then zeroes them. Returns the number of phases a
// slot holds, or a negative CUDA error.
extern "C" int fdms_fused_elan_tma_profile(unsigned long long* out,
                                           int blocks) {
  const size_t n = sizeof(unsigned long long) * 4 * kPhases *
                   static_cast<size_t>(blocks < kProfBlocks ? blocks
                                                            : kProfBlocks);
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, n);
  static unsigned long long zeros[kProfBlocks][4][kPhases];
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros));
  return err == cudaSuccess ? static_cast<int>(kPhases) : -static_cast<int>(err);
}
#endif

// Launches one group as ops/elan_kernel.elan_tma_plan laid it out, on
// `stream` of `device`; returns a CUDA error code, 0 when the launch was
// accepted. ptrs: x, out, workspace, packed weights, then n_conv biases
// (f32, a conv's c_out each). d, int64s: batch, h, w, th, strips, n_conv,
// cluster, grid, act, zero_rows, n_maps, weight rows, n_regions; n_maps x
// 12 map specs (base 0 = x, 1 = workspace; element offset; C, W, H, N, N
// stride; lower w, h; upper w, h; traversal stride); n_regions x 3 (offset,
// channels, rows); n_conv x (9 + 7 kMaxSrc) conv specs (n_src, c_out, bn,
// dst, o_dst, w_row, k_steps, sync, unused; then per source map, lw, lh,
// stride, image, taps, cin). Every check the plan makes is made again here;
// a plan the card cannot take is an error, never another route.
extern "C" int fdms_fused_elan_tma(void* const* ptrs, const long long* d,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static Params P;  // host staging of the kernel's parameter block
  P.batch = static_cast<int>(d[0]);
  P.h = static_cast<int>(d[1]);
  P.w = static_cast<int>(d[2]);
  P.th = static_cast<int>(d[3]);
  P.strips = static_cast<int>(d[4]);
  P.n_conv = static_cast<int>(d[5]);
  P.cluster = static_cast<int>(d[6]);
  const int grid = static_cast<int>(d[7]);
  P.act = static_cast<int>(d[8]);
  P.zero_rows = static_cast<int>(d[9]);
  const int n_maps = static_cast<int>(d[10]);
  const long long w_rows = d[11];
  const int n_regions = static_cast<int>(d[12]);
  if (P.n_conv < 1 || P.n_conv > kMaxConvs || n_maps < 1 ||
      n_maps > kMaxMaps || n_regions > kMaxRegions || P.cluster < 1 ||
      P.cluster > 8 || grid < 1 || grid % P.cluster != 0 || P.act < 0 ||
      P.act > 2 || !encoders().tiled || !encoders().im2col)
    return static_cast<int>(cudaErrorInvalidValue);
  void* x = ptrs[0];
  P.out = static_cast<uint16_t*>(ptrs[1]);
  P.ws = static_cast<uint16_t*>(ptrs[2]);
  if (!aligned16(P.out)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* m = d + 13;
  for (int i = 0; i < n_maps; ++i, m += 12) {
    void* base = static_cast<char*>(m[0] == 0 ? x : ptrs[2]) + 2 * m[1];
    err = encode_im2col(&P.maps[i], base, m);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = encode_weights(&P.wmap, ptrs[3], w_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int r = 0; r < n_regions; ++r, m += 3) {
    P.reg[r].off = m[0];
    P.reg[r].c = static_cast<int>(m[1]);
    P.reg[r].rows = static_cast<int>(m[2]);
    if (m[0] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int c = 0; c < P.n_conv; ++c, m += 9 + 7 * kMaxSrc) {
    ConvDesc& C = P.conv[c];
    C.n_src = static_cast<int>(m[0]);
    C.c_out = static_cast<int>(m[1]);
    C.bn = static_cast<int>(m[2]);
    C.dst = static_cast<int>(m[3]);
    C.o_dst = static_cast<int>(m[4]);
    C.w_row = static_cast<int>(m[5]);
    C.k_steps = static_cast<int>(m[6]);
    C.sync = static_cast<int>(m[7]);
    P.bias[c] = static_cast<const float*>(ptrs[4 + c]);
    if (C.n_src < 1 || C.n_src > kMaxSrc || C.c_out % 8 != 0 ||
        (C.bn != 64 && C.bn != 128) || C.dst >= n_regions ||
        C.o_dst < 0 || (C.dst >= 0 && P.reg[C.dst].c != C.c_out) ||
        reinterpret_cast<uintptr_t>(P.bias[c]) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    int k_steps = 0;
    for (int s = 0; s < C.n_src; ++s) {
      const long long* q = m + 9 + 7 * s;
      SrcDesc& S = C.src[s];
      S.map = static_cast<int8_t>(q[0]);
      S.lw = static_cast<int8_t>(q[1]);
      S.lh = static_cast<int8_t>(q[2]);
      S.stride = static_cast<int8_t>(q[3]);
      S.image = static_cast<int8_t>(q[4]);
      S.taps = static_cast<int8_t>(q[5]);
      S.cin = static_cast<int16_t>(q[6]);
      if (q[0] < 0 || q[0] >= n_maps || (q[5] != 1 && q[5] != 9) ||
          q[6] < 1 || q[6] % 8 != 0 || q[6] > 32767)
        return static_cast<int>(cudaErrorInvalidValue);
      k_steps += S.taps * ((S.cin + kKC - 1) / kKC);
    }
    if (k_steps != C.k_steps) return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(fused_elan_tma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_elan_tma_kernel, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory a block takes (the plan's smem_bytes).
extern "C" int fdms_fused_elan_tma_smem() { return kSmem; }
