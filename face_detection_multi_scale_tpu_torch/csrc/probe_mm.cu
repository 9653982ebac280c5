// Matmul-layout probe on the tensor cores, for sm_90a.
//
// Replaces tools/probe_mosaic_mm.py::kern, the JAX package's probe of the
// fused-ELAN kernel's inner strip products. Contract, for every cell c of
// the grid (each cell does the same work on the same data):
//   out[c, n] = sum over rows m of (A @ W)[m, n], f32,
// with bf16 inputs x (R, C, K) = x2 (R*C, K), w (K, N), w9 (9K, N) and the
// products accumulated in f32, R, C, K, N = 36, 176, 128, 64:
//   pre2d: A = x2, W = w                      (M = 6336 rows)
//   flat:  A = x read as (r, c) rows, W = w   (the same bytes as pre2d)
//   taps:  sum over the 9 taps (dy, dx) of A = x[dy:dy+34, dx:dx+174], W = w
//          (M = 5916 rows a tap)
//   cat9:  A = the 9 shifted windows side by side along K (dy-major, then
//          dx; K = 1152), W = w9
// Every row's product is computed: the column sum never moves in front of
// the product, which would cut the work M-fold and defeat the probe. Every
// block computes one cell.
//
// What bounds it on the card: operations for taps and cat9 (0.87 GFLOP a
// cell on 1.6 MB of inputs that every cell shares, so after the first cell
// they come from L2); for pre2d and flat the bound is operations too, but
// each cell re-reads x's 1.62 MB from L2 for 0.1 GFLOP, so L2's rate is
// what they meet first. The design:
//   * the product is taken transposed, D (64 channels x 176 positions) =
//     W^T A^T, so the positions are wgmma's N: one wgmma m64n176k16 (bf16
//     -> f32) covers a whole x row of positions, A (W^T) and B (x rows) both
//     from shared memory through descriptors. Two consumer warpgroups each
//     take every other output row; a producer warpgroup stages;
//   * M is enumerated in x's own flattened coordinates p = r*176 + c, so
//     the A row of tap (dy, dx) at p is x2[p + 176*dy + dx]: a tap is a
//     constant row offset into rows already staged. x rows (176 positions
//     and the 2 halo rows of the next) go through a ring of 4 slots, each
//     staged once and read by every tap of the up to three output rows
//     that reach it: x crosses from L2 once a cell, not nine times. A slot
//     holds the K planes apart ([16 B of K][row]), so a window that starts
//     at any row is a run of whole wgmma core matrices (8 rows x 16 B)
//     and a tap is only a descriptor's start address;
//   * output columns c = 174, 175 lie outside the 34 x 174 tap window: their
//     accumulator elements are left out of the column sum (they hold real
//     x values wrapped from the next row, so zero padding would not do);
//   * the weights: w (16 KB) stays resident for pre2d, flat and taps; cat9's
//     w9 (147 KB) does not fit beside the x ring, so its 16 KB tap slabs
//     stream through a ring of 3 slots, each slab serving both warpgroups
//     (a pair of output rows). A slab is staged in 16-byte runs of 8
//     channels of one K row, which wgmma reads MN-major (bf16's transpose
//     bit), so no copy transposes it;
//   * staging is asynchronous: the producer warps fill slots with cp.async
//     (16 bytes a lane, conflict-free in shared memory), each fill
//     completing on the slot's mbarrier; the consumers wait on it, issue
//     their wgmmas and release the slot on a second mbarrier when the
//     tensor cores are done, while later slots are in flight. A lane's
//     addresses are set once per slot; the loop adds constants. A second
//     instantiation (fdms_probe_mm_counted) also counts the bytes its
//     cp.asyncs read from device memory, so a run measures what the plan
//     stages rather than taking the plan's word for it;
//   * the tensor cores' accumulation does not round to nearest: on an H100
//     a chain over every chunk drifted 2.3e-4 of max |plain| from the plain
//     version, where chains of at most 72 k16 steps (a K = 1152 dot
//     product) stay within 1e-6. taps adds each tap's K = 128 product into
//     f32 totals with ordinary adds (the JAX kernel's acc + d), cat9 chains
//     the 72 steps of its K = 1152 product and then adds; each thread's
//     totals are its channels' column sums, summed over the warpgroup and
//     the two warpgroups in a fixed order, so every row of out is the same.
// Later work: TMA multicast of x over a cluster for pre2d and flat.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 36, kC = 176, kK = 128, kN = 64;
constexpr int kOutRows = kR - 2;          // output rows of the tap window
constexpr int kPlanes = kK / 8;           // 16-byte K planes of a row
constexpr int kSlots = 4;                 // the x ring
constexpr int kSlotRows = kC + 2;         // an x row and 2 halo rows
constexpr int kPlaneBytes = kSlotRows * 16;
constexpr int kSlotBytes = kPlanes * kPlaneBytes;
constexpr int kSlabBytes = kK * kN * 2;   // W, or one tap's slab of w9
constexpr int kGroupBytes = kK * 16;      // 8 channels of a slab
constexpr int kConsumers = 2;             // warpgroups
constexpr int kProducers = 4;             // warps
constexpr int kThreads = 32 * (4 * kConsumers + kProducers);
constexpr int kAcc = kC / 2;              // accumulator floats a thread

enum Variant { kPre2d = 0, kFlat = 1, kTaps = 2, kCat9 = 3 };

template <int V>
struct Plan {
  static constexpr bool kTapped = V == kTaps || V == kCat9;
  static constexpr int kTiles = kTapped ? kOutRows : kR;  // output rows
  static constexpr int kDy = kTapped ? 3 : 1;             // taps a side
  static constexpr int kRows = kTapped ? kSlotRows : kC;  // staged a slot
  static constexpr int kWSlots = V == kCat9 ? 3 : 1;
  // consumer warps that release an x slot: both warpgroups for the taps
  static constexpr int kXReleases = 4 * (kTapped ? 2 : 1);
  static constexpr int kBarOff = kSlots * kSlotBytes + kWSlots * kSlabBytes;
  static constexpr int kBars = 2 * kSlots + 2 * kWSlots;
  static constexpr int kRedOff = kBarOff + 8 * kBars;
  static constexpr int kSmem = kRedOff + 4 * kConsumers * kN;
  // bytes the plan copies from device memory into shared memory a cell
  // (fdms_probe_mm_counted measures them)
  static constexpr long long kXBytes =
      256LL * ((kR - 1) * kRows + (kTapped ? kC : kRows));
  static constexpr long long kWBytes =
      static_cast<long long>(kSlabBytes) *
      (V == kCat9 ? 9 * (kOutRows / 2) : 1);
};
static_assert(Plan<kCat9>::kSmem <= 232448, "shared memory");
static_assert(kOutRows % 2 == 0, "cat9's slabs serve pairs of rows");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, zeros where !ok; with kCount,
// adds the bytes read from device memory to `copied`. Through L1 (.ca): on
// the H100 this kernel runs up to 3x faster with it than with the
// L1-bypassing .cg form (tools/probe_mm_ab.py, PERF.md §6; why is open,
// §7).
template <bool kCount>
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok, uint32_t& copied) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
  if (kCount) copied += ok ? 16 : 0;
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

// arrives on `bar` once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
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

// cp.async's writes (generic proxy) visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor, no swizzle: start address,
// leading and stride byte offsets, each >> 4. The leading offset steps
// along K between core matrices (8 x 16 bytes), the stride offset along
// M or N between groups of 8: K-major x slots (K planes apart, 8 rows at
// 128 bytes) and the MN-major weights (K rows at 128 bytes, 8-channel
// groups apart) alike.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

// d (+)= W^T B over 16 K rows: the 64 channels x 176 positions of the
// warpgroup's tile. a: the weights, MN-major (transposed); b: 176 x rows,
// K-major; scale_d = 0 overwrites d. Element 4 j + 2 h + e of d is
// (channel 16 warp + gid + 8 h, position 8 j + 2 tig + e).
__device__ __forceinline__ void wgmma_176(float (&d)[kAcc], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87}, %88, %89, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
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

// Producer warp pw's part of the copy of x row `row` (flattened rows
// 176 row .. + kRows) into a slot, K plane kc of slot row q at
// kc * kPlaneBytes + q * 16: rows 2 pw + 8 i and the next. Lane: plane
// 4 (lane / 8) + lane % 4, row offset lane / 4 % 2, so the 8 lanes of a
// quarter warp hit 32 distinct banks and the warp reads two whole rows (512
// contiguous bytes) a step. Rows past x are zeros.
template <int V, bool kCount>
__device__ __forceinline__ void stage_row(uint32_t slot, const uint16_t* src,
                                          int row, int pw, int lane,
                                          uint32_t& copied) {
  const int kc = 4 * (lane >> 3) + (lane & 3), qo = (lane >> 2) & 1;
  const uint16_t* s = src + (static_cast<long long>(row) * kC + qo) * kK +
                      kc * 8;
  const uint32_t d = slot + kc * kPlaneBytes + qo * 16;
  const int left = (kR - row) * kC - qo;  // rows of x from this lane's first
#pragma unroll 4
  for (int q = 2 * pw; q < Plan<V>::kRows; q += 2 * kProducers)
    cp_async16<kCount>(d + q * 16, q < left ? s + q * kK : src, q < left,
                       copied);
}

// Producer warp pw's part of the copy of a K = 128 slab of weights, (K, N)
// row-major in device memory, into a slot in 16-byte runs: channel group g
// (8 channels) at g * kGroupBytes, K row k of it at k * 16; K rows 8 (pw +
// 4 i) + lane % 8, groups lane / 8 (+ 4), so a quarter warp writes 128
// contiguous bytes.
template <bool kCount>
__device__ __forceinline__ void stage_slab(uint32_t slot, const uint16_t* w,
                                           int pw, int lane,
                                           uint32_t& copied) {
  const int kl = lane & 7, gl = lane >> 3;
  const uint16_t* s = w + kl * kN + gl * 8;
  const uint32_t d = slot + gl * kGroupBytes + kl * 16;
#pragma unroll
  for (int kb = pw; kb < kK / 8; kb += kProducers)
#pragma unroll
    for (int gh = 0; gh < 2; ++gh)
      cp_async16<kCount>(d + kb * 128 + gh * 4 * kGroupBytes,
                         s + kb * 8 * kN + gh * 32, true, copied);
}

// Adds a tile's accumulator into the thread's two channel totals (its
// channels gid and gid + 8); with `mask`, positions 174 and 175 (tig 3's
// columns of j = 21) are left out.
__device__ __forceinline__ void add_tile(const float (&d)[kAcc], bool mask,
                                         float& t0, float& t1) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kAcc / 4 - 1; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += d[4 * j + q];
  if (!mask)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += d[kAcc - 4 + q];
  t0 += s[0] + s[1];
  t1 += s[2] + s[3];
}

// kCount: also add the bytes the cp.asyncs read from device memory to
// *staged (over every block)
template <int V, bool kCount>
__global__ void __launch_bounds__(kThreads, 1)
probe_mm_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ x2,
                const uint16_t* __restrict__ w, float* __restrict__ out,
                unsigned long long* __restrict__ staged) {
  using P = Plan<V>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t s_x = smem_u32(smem);
  const uint32_t s_w = s_x + kSlots * kSlotBytes;
  const uint32_t bars = s_x + P::kBarOff;
  // full_x[kSlots], empty_x[kSlots], full_w[kWSlots], empty_w[kWSlots]
  const uint32_t full_x = bars, empty_x = bars + 8 * kSlots;
  const uint32_t full_w = bars + 16 * kSlots;
  const uint32_t empty_w = full_w + 8 * P::kWSlots;
  float* red = reinterpret_cast<float*>(smem + P::kRedOff);  // (2, kN)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full_x + 8 * i, 32 * kProducers);
      mbar_init(empty_x + 8 * i, P::kXReleases);
    }
    for (int i = 0; i < P::kWSlots; ++i) {
      mbar_init(full_w + 8 * i, 32 * kProducers);
      mbar_init(empty_w + 8 * i, 4 * kConsumers);
    }
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // the producer warps: slots in the order the consumers need them
    const int pw = warp - 4 * kConsumers;
    const uint16_t* src = V == kFlat ? x : x2;
    uint32_t copied = 0;  // kCount: bytes this lane's cp.asyncs read
    auto load_row = [&](int row) {
      const int slot = row & (kSlots - 1);
      if (row >= kSlots)
        mbar_wait(empty_x + 8 * slot, (row / kSlots - 1) & 1);
      stage_row<V, kCount>(s_x + slot * kSlotBytes, src, row, pw, lane,
                           copied);
      mbar_arrive_cp_async(full_x + 8 * slot);
    };
    if (V == kCat9) {
      // a pair of output rows 2q, 2q + 1 reads x rows 2q .. 2q + 3 and the
      // 9 slabs; x row 2q + 1 + dy is first read at tap 3 dy
      load_row(0);
      load_row(1);
      int ws = 0, phase = 0;
      for (int q = 0; q < kOutRows / 2; ++q) {
        for (int t = 0; t < 9; ++t) {
          if (t == 3 || t == 6) load_row(2 * q + 1 + t / 3);
          if (q > 0 || t >= P::kWSlots) mbar_wait(empty_w + 8 * ws, phase ^ 1);
          stage_slab<kCount>(s_w + ws * kSlabBytes, w + t * kK * kN, pw,
                             lane, copied);
          mbar_arrive_cp_async(full_w + 8 * ws);
          if (++ws == P::kWSlots) ws = 0, phase ^= 1;
        }
      }
    } else {
      stage_slab<kCount>(s_w, w, pw, lane, copied);
      mbar_arrive_cp_async(full_w);
      for (int row = 0; row < kR; ++row) load_row(row);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (kCount) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        copied += __shfl_xor_sync(0xffffffffu, copied, m);
      if (lane == 0) atomicAdd(staged, static_cast<unsigned long long>(copied));
    }
  } else {
    // a consumer warpgroup: output rows g, g + 2, ...
    const int g = warp >> 2, wq = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    const bool mask = P::kTapped && tig == 3;
    const bool signal = lane == 0;  // one arrival a warp
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    float t0 = 0.f, t1 = 0.f;
    if (P::kTapped && g == 1 && signal) mbar_arrive(empty_x);  // row 0
    if (V != kCat9) {
      mbar_wait(full_w, 0);
      fence_async_proxy();
    }
    int ws = 0, phase = 0;  // cat9: the slab ring's position
    for (int o = g; o < P::kTiles; o += kConsumers) {
#pragma unroll 1
      for (int dy = 0; dy < P::kDy; ++dy) {
        const int row = o + dy, slot = row & (kSlots - 1);
        mbar_wait(full_x + 8 * slot, (row / kSlots) & 1);
        fence_async_proxy();
        const uint32_t b0 = s_x + slot * kSlotBytes;
#pragma unroll 1
        for (int dx = 0; dx < P::kDy; ++dx) {
          uint32_t a0 = s_w;
          if (V == kCat9) {
            mbar_wait(full_w + 8 * ws, phase);
            fence_async_proxy();
            a0 = s_w + ws * kSlabBytes;
          }
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < kK / 16; ++s)
            wgmma_176(acc,
                      desc(a0 + s * 256, 128, kGroupBytes),
                      desc(b0 + 2 * s * kPlaneBytes + dx * 16, kPlaneBytes,
                           128),
                      V == kCat9 ? (dy | dx | s) != 0 : s != 0);
          wgmma_commit();
          if (V == kCat9) {
            // the previous slab's products are done: release it
            wgmma_wait<1>();
            if ((dy | dx) != 0 && signal)
              mbar_arrive(empty_w + 8 * (ws == 0 ? P::kWSlots - 1 : ws - 1));
            if (++ws == P::kWSlots) ws = 0, phase ^= 1;
          } else {
            wgmma_wait<0>();
            add_tile(acc, mask, t0, t1);
          }
        }
      }
      if (V == kCat9) {
        wgmma_wait<0>();
        if (signal)
          mbar_arrive(empty_w + 8 * (ws == 0 ? P::kWSlots - 1 : ws - 1));
        add_tile(acc, mask, t0, t1);
      }
      // x rows this warpgroup reads no more: o, and with the taps o + 1
      if (signal) {
        mbar_arrive(empty_x + 8 * (o & (kSlots - 1)));
        if (P::kTapped) mbar_arrive(empty_x + 8 * ((o + 1) & (kSlots - 1)));
      }
    }
    // the column sums of the thread's channels over its quad, then over
    // the two warpgroups
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      t0 += __shfl_xor_sync(0xffffffffu, t0, m);
      t1 += __shfl_xor_sync(0xffffffffu, t1, m);
    }
    if (tig == 0) {
      red[g * kN + 16 * wq + gid] = t0;
      red[g * kN + 16 * wq + gid + 8] = t1;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
    if (tid < kN)
      out[static_cast<long long>(blockIdx.x) * kN + tid] =
          red[tid] + red[kN + tid];
  }
}

template <int V, bool kCount>
cudaError_t launch(const void* x, const void* x2, const void* w, void* out,
                   int cells, cudaStream_t stream, void* staged) {
  const cudaError_t err = cudaFuncSetAttribute(
      probe_mm_kernel<V, kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan<V>::kSmem);
  if (err != cudaSuccess) return err;
  probe_mm_kernel<V, kCount><<<cells, kThreads, Plan<V>::kSmem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(x2),
      static_cast<const uint16_t*>(w), static_cast<float*>(out),
      static_cast<unsigned long long*>(staged));
  return cudaGetLastError();
}

template <bool kCount>
int run(int variant, const void* x, const void* x2, const void* w,
        const void* w9, void* out, int cells, int device, void* stream,
        void* staged) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kPre2d: err = launch<kPre2d, kCount>(x, x2, w, out, cells, s, staged);
      break;
    case kFlat: err = launch<kFlat, kCount>(x, x2, w, out, cells, s, staged);
      break;
    case kTaps: err = launch<kTaps, kCount>(x, x2, w, out, cells, s, staged);
      break;
    case kCat9: err = launch<kCat9, kCount>(x, x2, w9, out, cells, s, staged);
      break;
    default: return -1;
  }
  return static_cast<int>(err);
}

template <int V>
void plan(long long* p) {
  p[0] = Plan<V>::kXBytes;
  p[1] = Plan<V>::kWBytes;
}

}  // namespace

// Launches variant `variant` (0 pre2d, 1 flat, 2 taps, 3 cat9) over `cells`
// blocks on `stream` of `device`; returns cudaGetLastError() (0 on success,
// -1 for an unknown variant). x, x2: (36*176*128) bf16; w: (128, 64) bf16;
// w9: (1152, 64) bf16; every pointer 16-byte aligned. out: (cells, 64) f32,
// allocated by the caller.
extern "C" int fdms_probe_mm(int variant, const void* x, const void* x2,
                             const void* w, const void* w9, void* out,
                             int cells, int device, void* stream) {
  return run<false>(variant, x, x2, w, w9, out, cells, device, stream,
                    nullptr);
}

// fdms_probe_mm, launching the instantiation that also adds the bytes its
// cp.asyncs read from device memory, over every block, to *staged (one
// unsigned 64-bit integer on the device, zeroed by the caller).
extern "C" int fdms_probe_mm_counted(int variant, const void* x,
                                     const void* x2, const void* w,
                                     const void* w9, void* out, int cells,
                                     int device, void* stream, void* staged) {
  return run<true>(variant, x, x2, w, w9, out, cells, device, stream, staged);
}

// The staging plan of variant `variant`, for the wrapper to check its own
// constants against: the x and weight bytes it copies into shared memory
// a cell. Returns 0, or -1 for an unknown variant.
extern "C" int fdms_probe_mm_plan(int variant, long long* out) {
  switch (variant) {
    case kPre2d: plan<kPre2d>(out); return 0;
    case kFlat: plan<kFlat>(out); return 0;
    case kTaps: plan<kTaps>(out); return 0;
    case kCat9: plan<kCat9>(out); return 0;
    default: return -1;
  }
}
