// One conv of W8A8 serving, int8 in and int8 out, for sm_90a.
//
// Replaces the int8 conv of face_detection_multi_scale_tpu/models/quant.py
// (quant_apply's `conv`, :521-530): XLA's conv_general_dilated with an int32
// result and the requant epilogue fused into it. Contract (NHWC, as there):
//   x (B, H, W, Cin) int8; w (Cout, kh, kw, Cin / groups) int8 (OHWI);
//   alpha, bias (Cout,) f32; inv_out f32; stride >= 1; symmetric pads;
//   y32[b, i, j, n] = sum over (dy, dx, c) of x[b, i*s - ph + dy,
//                      j*s - pw + dx, group(n) * Cin/groups + c] * w[n, dy, dx, c]
//                      (zero outside the image), exact in int32;
//   z = act(f32(y32) * alpha[n] + bias[n]), two rounded f32 operations;
//   y[b, i, j, n] = clip(rint(z * inv_out), -127, 127) as int8.
// act: 0 none, 1 silu z / (1 + exp(-z)), 2 leaky (slope 0.1), 3 relu.
//
// What bounds it on the card. A conv of the walk does 2 * B*Ho*Wo * Cout *
// kh*kw*Cin/groups int8 operations on x + w + y bytes. The zoo's 3x3 convs
// at 64-1024 channels need hundreds of operations a byte, far past the
// 1979 TOPS / 3.35 TB/s = 590 of the card's int8 tensor cores, so they are
// bound by operations; the 1x1 convs at 32-128 channels, the stem at 3 or
// 12 input channels and the depthwise convs are bound by bytes.
//
// Three routes; the caller's plan (ops/qconv_kernel.qconv_plan) names one
// and this file launches it or fails, never another:
//   * wgmma (groups == 1, Cin % 16 == 0, x and w 16-byte aligned): an
//     implicit GEMM, M = B*Ho*Wo output pixels, N = Cout, K = (tap,
//     channel), on wgmma.m64nNk32 s8 x s8 -> s32 with both operands
//     K-major in shared memory, as s8 requires and as NHWC x and OHWI w
//     already are. A tile is 128 pixels x BN channels (BN 128, or 64 when
//     Cout is not a multiple of 128). A K step is one tap and one run of
//     `span` channels (128, 64 or 32 bytes: the widest that divides Cin; a
//     Cin of 16 mod 32 takes 32 with the last run half past Cin, which TMA
//     fills with zeros, so the products of the next tap's weights there
//     are 0). A block has three roles. A producer warp keeps a ring of
//     kStages stages full by TMA, each completing on its mbarrier. Two
//     consumer warpgroups, 64 pixels each, issue span / 32 wgmmas a stage
//     and release it on a second mbarrier once the tensor cores are done
//     with it (one wgmma group stays in flight), then hand the tile's int32
//     sums through shared memory to two epilogue warpgroups and go on to
//     the next tile. The epilogue requants them (the activation a template
//     parameter, so the elements' chains interleave), stages the int8 tile
//     in shared memory and stores whole 16-byte runs (bytes only where
//     Cout % 16 != 0), masking the M and N tails. The stages are swizzled
//     at `span` bytes (TMA writes and wgmma reads the same pattern), so
//     neither side has bank conflicts. The grid is persistent, a block an
//     SM walking the tiles, so one tile's copies and products overlap the
//     last one's epilogue.
//     Activations come by TMA's im2col mode: the tensor map holds the
//     conv's geometry (the window corners -pad and pad - (k - 1), the
//     stride as the traversal stride), and one load of (channel run, first
//     pixel, tap offset) brings 128 output pixels' inputs for that tap,
//     walking W, then H, then the image, as M is flattened, with zeros for
//     the padding and for pixels past the last image. Tiled-mode boxes per
//     tap would need output rectangles, which waste most of a tile on the
//     20- and 10-pixel maps at 128 pixels a tile; im2col keeps M flat, so
//     only the last tile of a conv has a tail. Weights come by a 2-D tiled
//     map over (Cout, kh*kw*Cin), rows past Cout read as zeros.
//     Small grids (too few tiles to fill the 132 SMs, as on the 20- and
//     10-pixel maps at b8) split K over the `split` blocks of a cluster,
//     one cluster a tile: each sums its share of the K steps, the others
//     leave their int32 partial tiles in their own shared memory, and the
//     first block adds them through distributed shared memory and alone
//     runs the epilogue, so a conv stays one launch with no int32 round
//     trip to device memory (int32 sums are exact in any order). The
//     tensor maps are encoded here, on the host, once per (x, w) pointers
//     and conv shape (the caching allocator hands a walk the same
//     activation addresses from request to request), through the driver's
//     encode functions from cudaGetDriverEntryPoint, so the library needs
//     no -lcuda; they reach the kernel as __grid_constant__ parameters.
//     On the card (PERF.md) the 3x3 convs on maps of 40 px and up run at
//     400-800 int8 TOPS and the products alone at up to ~1000; what is
//     left is the epilogue, silu's correctly rounded division and
//     exponential above all, which the bit-exact contract keeps.
//   * mma (groups == 1, what TMA cannot take: ragged Cin, misaligned
//     pointers; and, by the plan's rule, a K under 64 bytes on more tiles
//     than SMs, where it measured faster): the first kernel, on
//     mma.sync.m16n8k32 s8. A block owns a
//     128 x 64 tile; its 4 warps, 2 x 2, own 64 x 32 each, accumulators in
//     registers. K runs flat over (tap, channel) in tiles of 64 bytes, so a
//     ragged Cin (3, 12, 56, 104, 216) wastes nothing but the last K tile's
//     tail, staged in shared memory in two stages: the next tile's copies
//     (cp.async with a zero fill for padding and the ragged edge; 16, 8 or
//     4 bytes a copy, the widest that Cin and the pointers' alignment
//     allow, else bytes stored by the threads) are in flight while the
//     tensor cores work on the current one. Each staged row is padded to
//     80 bytes, so the fragment loads of a warp hit 32 different banks. A
//     row table in shared memory holds each output pixel's image row and
//     top-left input corner.
//   * direct (groups > 1, depthwise in the zoo): one thread an output
//     value, the Cin/groups products summed in int32.
// The file is built with -fmad=false, and the epilogue uses the explicitly
// rounded intrinsics, so no multiply-add contracts into an FMA.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

// the mma route
constexpr int kBM = 128;                // output pixels a block
constexpr int kBN = 64;                 // output channels a block
constexpr int kBK = 64;                 // K bytes a staged tile
constexpr int kRow = kBK + 16;          // padded staged row, bytes
constexpr int kThreads = 128;           // 4 warps, 2 x 2
// the direct route
constexpr int kDirectThreads = 256;
// the wgmma route
constexpr int kWBM = 128;               // output pixels a block
constexpr int kSpanMax = 128;           // K bytes a stage, at most
constexpr int kStages = 4;              // the TMA ring
constexpr int kConsumers = 2 * kWBM;    // a warpgroup per 64 pixels
// the consumers, as many epilogue threads, and the producer warp
constexpr int kWThreads = 2 * kConsumers + 32;
constexpr int kSplitMax = 8;            // the portable cluster size

enum Route { kDirect = 0, kMma = 1, kWgmma = 2 };

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* alpha;
  const float* bias;
  int8_t* y;
  float inv_out;
  int b, h, wd, cin, ho, wo, cout, kh, kw, stride, ph, pw, groups, act;
  int m;  // B * Ho * Wo
  int k;  // kh * kw * Cin / groups
  // wgmma route: K bytes a step, steps a tap, steps in all, blocks a tile
  int span, chunks, steps, split;
};

__device__ __forceinline__ int8_t requant(int acc, float alpha, float bias,
                                          float inv_out, int act) {
  float z = __fadd_rn(__fmul_rn(__int2float_rn(acc), alpha), bias);
  if (act == 1) {
    z = __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
  } else if (act == 2) {
    z = z > 0.0f ? z : __fmul_rn(z, 0.1f);
  } else if (act == 3) {
    z = z > 0.0f ? z : 0.0f;
  }
  const float q = fminf(fmaxf(rintf(__fmul_rn(z, inv_out)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy VEC bytes from global `src` to shared `dst`, or zeros when !ok.
template <int VEC>
__device__ __forceinline__ void stage(int8_t* dst, const int8_t* src, bool ok) {
  if constexpr (VEC == 1) {
    *dst = ok ? *src : int8_t(0);
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(VEC), "r"(ok ? VEC : 0));
  }
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
qconv_mma_kernel(const Params p) {
  __shared__ __align__(16) int8_t a_s[2][kBM * kRow];
  __shared__ __align__(16) int8_t b_s[2][kBN * kRow];
  __shared__ int row_bh[kBM], row_ih[kBM], row_iw[kBM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  for (int r = tid; r < kBM; r += kThreads) {
    const int m = m0 + r;
    if (m < p.m) {
      const int ow = m % p.wo;
      const int t = m / p.wo;
      row_bh[r] = (t / p.ho) * p.h;
      row_ih[r] = (t % p.ho) * p.stride - p.ph;
      row_iw[r] = ow * p.stride - p.pw;
    } else {  // past the last pixel: every tap reads as padding
      row_bh[r] = 0;
      row_ih[r] = -(1 << 29);
      row_iw[r] = 0;
    }
  }
  __syncthreads();

  // each thread stages one VEC-byte column of the tile, every RS-th row
  constexpr int kVpr = kBK / VEC;
  constexpr int kRs = kThreads / kVpr;
  const int col = (tid % kVpr) * VEC;
  const int r0 = tid / kVpr;
  auto load_tile = [&](int st, int k0) {
    const int kk = k0 + col;
    const bool k_ok = kk < p.k;
    const int tap = kk / p.cin;
    const int c = kk - tap * p.cin;
    const int dy = tap / p.kw;
    const int dx = tap - dy * p.kw;
    for (int r = r0; r < kBM; r += kRs) {
      const int ih = row_ih[r] + dy;
      const int iw = row_iw[r] + dx;
      const bool ok = k_ok && ih >= 0 && ih < p.h && iw >= 0 && iw < p.wd;
      const int8_t* src =
          ok ? p.x + ((static_cast<long long>(row_bh[r] + ih) * p.wd + iw) *
                          p.cin + c)
             : p.x;
      stage<VEC>(&a_s[st][r * kRow + col], src, ok);
    }
    for (int r = r0; r < kBN; r += kRs) {
      const int n = n0 + r;
      const bool ok = k_ok && n < p.cout;
      const int8_t* src =
          ok ? p.w + (static_cast<long long>(n) * p.k + kk) : p.w;
      stage<VEC>(&b_s[st][r * kRow + col], src, ok);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (p.k + kBK - 1) / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) load_tile((j + 1) & 1, (j + 1) * kBK);
    cp_async_commit();
    cp_async_wait_one();  // tile j has landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    const int8_t* as = a_s[j & 1];
    const int8_t* bs = b_s[j & 1];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* p0 = as + (wm * 64 + mt * 16 + g) * kRow + ks + t4 * 4;
        af[mt][0] = *reinterpret_cast<const unsigned*>(p0);
        af[mt][1] = *reinterpret_cast<const unsigned*>(p0 + 8 * kRow);
        af[mt][2] = *reinterpret_cast<const unsigned*>(p0 + 16);
        af[mt][3] = *reinterpret_cast<const unsigned*>(p0 + 8 * kRow + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* q0 = bs + (wn * 32 + nt * 8 + g) * kRow + ks + t4 * 4;
        bf[nt][0] = *reinterpret_cast<const unsigned*>(q0);
        bf[nt][1] = *reinterpret_cast<const unsigned*>(q0 + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();  // stage j & 1 is refilled at iteration j + 1
  }

  // accumulator (mt, nt, e): row g + 8 * (e >> 1), column 2 * t4 + (e & 1)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (m >= p.m) continue;
      int8_t* out = p.y + static_cast<long long>(m) * p.cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + nt * 8 + t4 * 2 + e;
          if (n < p.cout)
            out[n] = requant(acc[mt][nt][half * 2 + e], p.alpha[n], p.bias[n],
                             p.inv_out, p.act);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kDirectThreads)
qconv_direct_kernel(const Params p) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kDirectThreads + threadIdx.x;
  if (idx >= static_cast<long long>(p.m) * p.cout) return;
  const int n = static_cast<int>(idx % p.cout);
  const int m = static_cast<int>(idx / p.cout);
  const int ow = m % p.wo;
  const int t = m / p.wo;
  const int oh = t % p.ho;
  const int bi = t / p.ho;
  const int cg = p.cin / p.groups;
  const int c0 = (n / (p.cout / p.groups)) * cg;
  int acc = 0;
  for (int dy = 0; dy < p.kh; ++dy) {
    const int ih = oh * p.stride - p.ph + dy;
    if (ih < 0 || ih >= p.h) continue;
    for (int dx = 0; dx < p.kw; ++dx) {
      const int iw = ow * p.stride - p.pw + dx;
      if (iw < 0 || iw >= p.wd) continue;
      const int8_t* xp =
          p.x + ((static_cast<long long>(bi) * p.h + ih) * p.wd + iw) * p.cin +
          c0;
      const int8_t* wp =
          p.w + (static_cast<long long>(n) * p.kh * p.kw + dy * p.kw + dx) * cg;
      for (int c = 0; c < cg; ++c)
        acc += static_cast<int>(xp[c]) * static_cast<int>(wp[c]);
    }
  }
  p.y[idx] = requant(acc, p.alpha[n], p.bias[n], p.inv_out, p.act);
}

// ---------------------------------------------------------------------------
// the wgmma route
// ---------------------------------------------------------------------------

// A block's shared memory, from a 1024-byte aligned base (the period of the
// 128-byte swizzle): the ring's A stages (128 pixels x span bytes), its B
// stages (BN channels x span bytes), the int32 sums the consumers hand to
// the epilogue (kConsumers threads x BN / 2), the int8 output tile (rows
// padded by 16 bytes), the tile's scales and biases, the full and empty
// mbarriers. A split's int32 partial tile reuses the ring once the K loop
// is done.
template <int BN>
struct WLayout {
  static constexpr int kATile = kWBM * kSpanMax;
  static constexpr int kBTile = BN * kSpanMax;
  static constexpr int kB = kStages * kATile;
  static constexpr int kHand = kB + kStages * kBTile;
  static constexpr int kAcc = BN / 2;  // int32 sums a consumer thread
  static constexpr int kOut = kHand + kConsumers * kAcc * 4;
  static constexpr int kPitch = BN + 16;
  static constexpr int kScale = kOut + kWBM * kPitch;  // 2 BN floats
  static constexpr int kBar = kScale + 8 * BN;
  static constexpr int kSmem = kBar + 16 * kStages + 1024;  // + alignment
};
static_assert(WLayout<128>::kSmem <= 232448, "shared memory");
static_assert(kConsumers * WLayout<128>::kAcc * 4 <= WLayout<128>::kHand &&
                  kConsumers * WLayout<64>::kAcc * 4 <= WLayout<64>::kHand,
              "a split's partial tile fits in the ring");

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

// arrives on `bar` and adds `bytes` to the transfers its phase waits for
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

// The inputs of 128 output pixels for one tap and `span` channels from c:
// the im2col box whose first pixel's window corner is (w, h) of image n,
// read at tap offset (dx, dy), completing on `bar`.
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

// The (BN channels x span K bytes) weight box at K offset k, channel n.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int n) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(n)
      : "memory");
}

// wgmma's shared-memory matrix descriptor of a K-major operand swizzled at
// `span` bytes: start address, leading offset (unused when a wgmma's 32 K
// bytes lie in one swizzled row; 1 by convention), stride offset (8 rows of
// `span` bytes), layout (1: 128-byte, 2: 64-byte, 3: 32-byte swizzle). A
// wgmma at K byte kk of the rows takes the start address + kk.
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, int span) {
  const uint64_t layout = span == 128 ? 1 : span == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) | 1ull << 16 |
         static_cast<uint64_t>((8 * span) >> 4) << 32 | layout << 62;
}

// d (+)= A B^T over 32 K bytes: the warpgroup's 64 pixels x N channels, A
// and B K-major through their descriptors; scale_d = 0 overwrites d.
// Element 4 j + 2 h + e of d is (pixel 16 warp + g + 8 h, channel 8 j +
// 2 t4 + e), g = lane / 4, t4 = lane % 4.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
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

// keeps the compiler from moving reads of the accumulators above the wait
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Named barriers of the roles (0 is __syncthreads'): the consumers alone,
// the epilogue warpgroups alone, and the hand-over of a tile's sums from
// the consumers (arrive) to the epilogue (sync) and back.
enum Barrier { kConsumersDone = 1, kEpilogue = 2, kHandFull = 3,
               kHandEmpty = 4 };

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The activation, fixed at compile time (as requant's, op for op).
template <int ACT>
__device__ __forceinline__ float activate(float z) {
  if constexpr (ACT == 1) {
    return __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
  } else if constexpr (ACT == 2) {
    return z > 0.0f ? z : __fmul_rn(z, 0.1f);
  } else if constexpr (ACT == 3) {
    return z > 0.0f ? z : 0.0f;
  } else {
    return z;
  }
}

__device__ __forceinline__ uint32_t round_int8(float z, float inv_out) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(z, inv_out)), -127.0f), 127.0f);
  return static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(q)));
}

// requant (op for op) of one consumer thread's handed sums (src[q *
// kConsumers], int4 q holding elements 4 q .. 4 q + 3) into the staged int8
// tile: element 4 j + 2 hh + e at row `row` + 8 hh, column 8 j + `col` + e,
// with that column's scale and bias from the tile's staged copies. The
// activation is a template parameter, so no element branches on it, and
// the elements go in chunks of 16 whose chains interleave (for silu every
// exponential before the divisions, whose slow-path checks branch); a pair
// of columns is one 2-byte store.
template <int BN, int ACT>
__device__ __forceinline__ void requant_tile(const int4* src,
                                             const float* alpha,
                                             const float* bias, float inv_out,
                                             int8_t* out_s, int pitch,
                                             int row, int col) {
  constexpr int kJ = 4;  // column groups of 8 a chunk
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kJ) {
    float z[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int4 v = src[(j0 + j) * kConsumers];
      const int c = 8 * (j0 + j) + col;
      const int a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        z[j][i] = __fadd_rn(
            __fmul_rn(__int2float_rn(a[i]), alpha[c + (i & 1)]),
            bias[c + (i & 1)]);
    }
    if constexpr (ACT == 1) {
      float d[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[j][i] = __fadd_rn(1.0f, expf(-z[j][i]));
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) z[j][i] = __fdiv_rn(z[j][i], d[j][i]);
    } else {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) z[j][i] = activate<ACT>(z[j][i]);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint16_t*>(
            out_s + (row + 8 * hh) * pitch + 8 * (j0 + j) + col) =
            static_cast<uint16_t>(round_int8(z[j][2 * hh], inv_out) |
                                  round_int8(z[j][2 * hh + 1], inv_out)
                                      << 8);
  }
}

// A block walks the output tiles t = its cluster, then + the clusters in
// the grid (tile t: pixels (t / tiles_n) * 128, channels (t % tiles_n) *
// BN). Unsplit, the grid is at most a block an SM and persistent: the
// producer runs on into the next tile's K steps while the consumers work.
// Split, the grid holds one cluster a tile. SPAN is the K bytes of a step
// (the swizzle), so a step's wgmmas unroll. The consumer warpgroups hand
// each tile's sums to two epilogue warpgroups through shared memory and go
// on to the next tile's products, so the requant of one tile runs beside
// the tensor cores' work on the next.
template <int BN, int SPAN>
__global__ void __launch_bounds__(kWThreads, 1)
qconv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w, const Params p) {
  using L = WLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_a = smem_u32(smem);
  const uint32_t s_b = s_a + L::kB;
  const uint32_t full = s_a + L::kBar;       // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStages;  // empty[s] at empty + 8 s
  int4* handed = reinterpret_cast<int4*>(smem + L::kHand);  // [q][thread]
  int8_t* out_s = reinterpret_cast<int8_t*>(smem + L::kOut);

  const int tid = threadIdx.x;
  const int split = p.split;
  const int rank = blockIdx.x % split;  // the block's rank in its cluster
  const int clusters = gridDim.x / split;
  const int tiles_n = (p.cout + BN - 1) / BN;
  const int tiles = ((p.m + kWBM - 1) / kWBM) * tiles_n;
  const int first = blockIdx.x / split;
  const int nk = p.steps / split;       // a block's K steps of a tile

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 128);  // one a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * kConsumers) {
    // the producer warp: one lane issues every copy of the block
    if (tid == 2 * kConsumers) {
      const uint32_t bytes = (kWBM + BN) * SPAN;
      int it = 0;  // the block's K steps so far, over its tiles
      for (int t = first; t < tiles; t += clusters) {
        const int m0 = (t / tiles_n) * kWBM;
        const int n0 = (t % tiles_n) * BN;
        const int hw = p.ho * p.wo;
        const int img = m0 / hw;
        const int oh = (m0 - img * hw) / p.wo;
        const int ow = m0 - img * hw - oh * p.wo;
        const int w0 = ow * p.stride - p.pw;  // the first pixel's window
        const int h0 = oh * p.stride - p.ph;
        for (int j = 0; j < nk; ++j, ++it) {
          const int s = it % kStages;
          if (it >= kStages)
            mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const int step = rank * nk + j;
          const int tap = step / p.chunks;
          const int c = (step - tap * p.chunks) * SPAN;
          const int dy = tap / p.kw;
          const int dx = tap - dy * p.kw;
          mbar_expect_tx(full + 8 * s, bytes);
          tma_im2col(s_a + s * L::kATile, &tm_x, full + 8 * s, c, w0, h0,
                     img, static_cast<uint16_t>(dx),
                     static_cast<uint16_t>(dy));
          tma_tile(s_b + s * L::kBTile, &tm_w, full + 8 * s,
                   tap * p.cin + c, n0);
        }
      }
    }
    __syncwarp();
    if (split > 1) {  // the consumers' two cluster barriers below
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }

  if (tid >= kConsumers) {
    // the epilogue warpgroups: thread e requants consumer thread e's sums
    // into the staged int8 tile, then all store it in 16-byte runs
    const int e = tid - kConsumers;
    if (split > 1) {
      cg::this_cluster().sync();
      cg::this_cluster().sync();
      if (rank != 0) return;
    }
    const int row = 64 * (e >> 7) + 16 * ((e >> 5) & 3) + ((e & 31) >> 2);
    const int col = 2 * (e & 3);
    float* scale = reinterpret_cast<float*>(smem + L::kScale);  // alpha, bias
    for (int t = first; t < tiles; t += clusters) {
      const int m0 = (t / tiles_n) * kWBM;
      const int n0 = (t % tiles_n) * BN;
      // the tile's scales and biases, zero past Cout, staged once: the
      // last tile's requant is done with them (the barrier after it)
      for (int i = e; i < 2 * BN; i += kConsumers) {
        const int n = n0 + (i < BN ? i : i - BN);
        scale[i] =
            n < p.cout ? __ldg((i < BN ? p.alpha : p.bias) + n) : 0.0f;
      }
      named_sync(kHandFull, 2 * kConsumers);  // tile t's sums are handed
      named_sync(kEpilogue, kConsumers);  // the scales are in; out_s is free
      const int4* src = handed + e;
      switch (p.act) {
        case 1:
          requant_tile<BN, 1>(src, scale, scale + BN, p.inv_out, out_s,
                              L::kPitch, row, col);
          break;
        case 2:
          requant_tile<BN, 2>(src, scale, scale + BN, p.inv_out, out_s,
                              L::kPitch, row, col);
          break;
        case 3:
          requant_tile<BN, 3>(src, scale, scale + BN, p.inv_out, out_s,
                              L::kPitch, row, col);
          break;
        default:
          requant_tile<BN, 0>(src, scale, scale + BN, p.inv_out, out_s,
                              L::kPitch, row, col);
      }
      if (t + clusters < tiles)  // the consumers may hand the next tile
        named_arrive(kHandEmpty, 2 * kConsumers);
      named_sync(kEpilogue, kConsumers);  // the int8 tile is staged
      constexpr int kRuns = BN / 16;
      const bool whole = (p.cout & 15) == 0;  // every run 16-byte aligned
      for (int i = e; i < kWBM * kRuns; i += kConsumers) {
        const int r = i / kRuns;
        const int c = (i - r * kRuns) * 16;
        const int m = m0 + r;
        const int n = n0 + c;
        if (m >= p.m || n >= p.cout) continue;
        const int8_t* src = out_s + r * L::kPitch + c;
        int8_t* dst = p.y + static_cast<long long>(m) * p.cout + n;
        if (whole) {
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        } else {
          for (int b = 0; b < 16 && n + b < p.cout; ++b) dst[b] = src[b];
        }
      }
    }
    return;
  }

  // the consumer warpgroups: the products, 64 pixels x BN channels each
  const int wg = tid >> 7;
  const bool leader = (tid & 127) == 0;  // arrives for its warpgroup
  int acc[L::kAcc];
#pragma unroll
  for (int i = 0; i < L::kAcc; ++i) acc[i] = 0;
  int it = 0;
  for (int t = first; t < tiles; t += clusters) {
    for (int j = 0; j < nk; ++j, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t a = s_a + s * L::kATile + wg * 64 * SPAN;
      const uint32_t b = s_b + s * L::kBTile;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SPAN; kk += 32)
        wgmma_s8(acc, sw_desc(a + kk, SPAN), sw_desc(b + kk, SPAN),
                 j > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // step it - 1's products are done: free its stage
      fence_acc(acc);
      if (j > 0 && leader) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (leader) mbar_arrive(empty + 8 * ((it - 1) % kStages));

    if (split > 1) {
      // one tile a cluster: the other blocks hand their partial sums to
      // rank 0 through the ring, which no copy refills now
      int4* part = reinterpret_cast<int4*>(smem);
      cg::cluster_group cluster = cg::this_cluster();
      if (rank != 0) {
        named_sync(kConsumersDone, kConsumers);  // the ring is read
#pragma unroll
        for (int q = 0; q < L::kAcc / 4; ++q)
          part[q * kConsumers + tid] =
              make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                        acc[4 * q + 3]);
      }
      cluster.sync();
      if (rank == 0) {
        for (int r = 1; r < split; ++r) {
          const int4* rp = cluster.map_shared_rank(part, r);
#pragma unroll
          for (int q = 0; q < L::kAcc / 4; ++q) {
            const int4 v = rp[q * kConsumers + tid];
            acc[4 * q] += v.x;
            acc[4 * q + 1] += v.y;
            acc[4 * q + 2] += v.z;
            acc[4 * q + 3] += v.w;
          }
        }
      }
      cluster.sync();  // rank 0 is done reading the others' shared memory
      if (rank != 0) return;
    }

    // hand the sums to the epilogue warpgroups
    if (t != first)  // they have read the last tile's
      named_sync(kHandEmpty, 2 * kConsumers);
#pragma unroll
    for (int q = 0; q < L::kAcc / 4; ++q)
      handed[q * kConsumers + tid] = make_int4(
          acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    __threadfence_block();
    named_arrive(kHandFull, 2 * kConsumers);
  }
}

template <int VEC>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.m + kBM - 1) / kBM, (p.cout + kBN - 1) / kBN);
  qconv_mma_kernel<VEC><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
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

CUtensorMapSwizzle swizzle(int span) {
  return span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
}

// x (B, H, W, Cin) as the conv's im2col view: the window corners -pad and
// pad - (k - 1) bound the first pixel of each window, the stride is the
// traversal stride, a box is 128 pixels x span channels.
cudaError_t encode_x(CUtensorMap* map, const Params& p) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.cin),
                              static_cast<cuuint64_t>(p.wd),
                              static_cast<cuuint64_t>(p.h),
                              static_cast<cuuint64_t>(p.b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(p.cin),
                                 static_cast<cuuint64_t>(p.wd) * p.cin,
                                 static_cast<cuuint64_t>(p.h) * p.wd * p.cin};
  const int lower[2] = {-p.pw, -p.ph};
  const int upper[2] = {p.pw - (p.kw - 1), p.ph - (p.kh - 1)};
  const cuuint32_t traversal[4] = {1, static_cast<cuuint32_t>(p.stride),
                                   static_cast<cuuint32_t>(p.stride), 1};
  const CUresult r = encoders().im2col(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(p.x), dims,
      strides, lower, upper, p.span, kWBM, traversal,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(p.span),
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// w (Cout, kh*kw*Cin) as 2-D tiles of BN rows x span K bytes.
cudaError_t encode_w(CUtensorMap* map, const Params& p, int bn) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.k),
                              static_cast<cuuint64_t>(p.cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(p.span),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encoders().tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p.w), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(p.span),
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
cudaLaunchConfig_t wgmma_config(const Params& p, int blocks,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kWThreads);
  cfg.dynamicSmemBytes = WLayout<BN>::kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  return cfg;
}

// The kernel's shared-memory attribute, and for a split the clusters the
// card holds at once (cudaOccupancyMaxActiveClusters), once per (device,
// BN, span, split): a cluster size the card cannot schedule shows only as
// 0.
template <int BN, int SPAN>
cudaError_t wgmma_ready(const Params& p, int device) {
  static std::mutex lock;
  static std::map<std::tuple<int, int>, int> known;
  std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_tuple(device, p.split);
  auto hit = known.find(key);
  if (hit == known.end()) {
    cudaError_t err = cudaFuncSetAttribute(
        qconv_wgmma_kernel<BN, SPAN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, WLayout<BN>::kSmem);
    if (err != cudaSuccess) return err;
    int active = 1;
    if (p.split > 1) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          wgmma_config<BN>(p, p.split, nullptr, &attr);
      err = cudaOccupancyMaxActiveClusters(
          &active, qconv_wgmma_kernel<BN, SPAN>, &cfg);
      if (err != cudaSuccess) return err;
    }
    hit = known.emplace(key, active).first;
  }
  return hit->second > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

// A launch's two tensor maps, kept per (device, x and w pointers, conv
// shape, split) for each (BN, span): a map holds nothing but its pointer
// and the geometry, so an entry stays right while both pointers keep
// those shapes. A miss also readies the kernel (wgmma_ready). One lookup
// a launch.
struct WgmmaMaps {
  CUtensorMap x, w;
};

template <int BN, int SPAN>
cudaError_t wgmma_maps(const Params& p, int device, WgmmaMaps* maps) {
  static std::mutex lock;
  static std::map<std::array<long long, 14>, WgmmaMaps> known;
  const std::array<long long, 14> key = {
      device, static_cast<long long>(reinterpret_cast<uintptr_t>(p.x)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(p.w)), p.b, p.h,
      p.wd, p.cin, p.cout, p.kh, p.kw, p.stride, p.ph, p.pw, p.split};
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *maps = hit->second;
    return cudaSuccess;
  }
  cudaError_t err = wgmma_ready<BN, SPAN>(p, device);
  if (err == cudaSuccess) err = encode_x(&maps->x, p);
  if (err == cudaSuccess) err = encode_w(&maps->w, p, BN);
  if (err != cudaSuccess) return err;
  if (known.size() >= 4096) known.clear();
  known.emplace(key, *maps);
  return cudaSuccess;
}

template <int BN, int SPAN>
cudaError_t launch_wgmma(const Params& p, int blocks, int device,
                         cudaStream_t stream) {
  WgmmaMaps maps;
  cudaError_t err = wgmma_maps<BN, SPAN>(p, device, &maps);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wgmma_config<BN>(p, blocks, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, qconv_wgmma_kernel<BN, SPAN>, maps.x,
                           maps.w, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the plan of the last accepted launch (fdms_qconv_last_plan)
long long g_plan[9] = {-1, 0, 0, 0, 0, 0, 0, 0, 0};

void record(int route, int bm, int bn, int bk, int split, int steps,
            long long grid_x, long long grid_y, int vec) {
  const long long v[9] = {route, bm, bn, bk, split, steps, grid_x, grid_y,
                          vec};
  for (int i = 0; i < 9; ++i) g_plan[i] = v[i];
}

}  // namespace

// y = requant(conv(x, w)) on `stream`. `a` holds 18 ints: the shapes b,
// h, wd, cin, cout, kh, kw, stride, ph, pw, groups, act, then the plan's
// route (0 direct, 1 mma, 2 wgmma), N tile bn, K split, grid of `blocks`
// (wgmma), copy width vec (mma), and the device. Returns a CUDA error
// code, 0 when the launch was accepted. A plan the shapes, the pointers
// or the card cannot take is an error (cudaErrorInvalidValue, or
// cudaErrorLaunchOutOfResources for a cluster the card cannot schedule),
// never another route. The caller checks shapes, types and contiguity,
// and that every tensor has fewer than 2^31 elements.
extern "C" int fdms_qconv(const void* x, const void* w, const void* alpha,
                          const void* bias, float inv_out, void* y,
                          const int* a, void* stream) {
  const int b = a[0], h = a[1], wd = a[2], cin = a[3], cout = a[4],
            kh = a[5], kw = a[6], stride = a[7], ph = a[8], pw = a[9],
            groups = a[10], act = a[11], route = a[12], bn = a[13],
            split = a[14], blocks = a[15], vec = a[16], device = a[17];
  g_plan[0] = -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups < 1 || cin % groups || cout % groups || stride < 1 || act < 0 ||
      act > 3 || ph < 0 || pw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.alpha = static_cast<const float*>(alpha);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<int8_t*>(y);
  p.inv_out = inv_out;
  p.b = b;
  p.h = h;
  p.wd = wd;
  p.cin = cin;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.ph = ph;
  p.pw = pw;
  p.groups = groups;
  p.act = act;
  p.ho = (h + 2 * ph - kh) / stride + 1;
  p.wo = (wd + 2 * pw - kw) / stride + 1;
  const long long m = static_cast<long long>(b) * p.ho * p.wo;
  if (m <= 0 || cout <= 0) return 0;
  if (m * cout >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.m = static_cast<int>(m);
  p.k = kh * kw * (cin / groups);
  // the wgmma route's K steps: a tap's channels in runs of `span` bytes
  p.span = cin % 128 == 0 ? 128 : cin % 64 == 0 ? 64 : 32;
  p.chunks = (cin + p.span - 1) / p.span;
  p.steps = kh * kw * p.chunks;
  p.split = split;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kDirect) {
    const long long blocks = (m * cout + kDirectThreads - 1) / kDirectThreads;
    qconv_direct_kernel<<<static_cast<unsigned>(blocks), kDirectThreads, 0,
                          s>>>(p);
    err = cudaGetLastError();
    if (err == cudaSuccess) record(kDirect, 0, 0, 0, 1, 0, blocks, 1, 0);
    return static_cast<int>(err);
  }
  if (groups != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kMma) {
    if ((cout + kBN - 1) / kBN > 65535 ||
        !(vec == 1 || vec == 4 || vec == 8 || vec == 16) || cin % vec ||
        !aligned(x, vec) || !aligned(w, vec))
      return static_cast<int>(cudaErrorInvalidValue);
    err = vec == 16  ? launch_mma<16>(p, s)
          : vec == 8 ? launch_mma<8>(p, s)
          : vec == 4 ? launch_mma<4>(p, s)
                     : launch_mma<1>(p, s);
    if (err == cudaSuccess)
      record(kMma, kBM, kBN, kBK, 1, (p.k + kBK - 1) / kBK,
             (m + kBM - 1) / kBM, (cout + kBN - 1) / kBN, vec);
    return static_cast<int>(err);
  }
  // wgmma: what TMA and the tile take (16-byte runs and pointers, the
  // im2col corners in [-128, 127], a traversal stride of at most 8), and a
  // grid of one cluster a tile (split) or of at most a block a tile
  const long long tiles = ((m + kWBM - 1) / kWBM) * ((cout + bn - 1) / bn);
  if (route != kWgmma || cin % 16 || !aligned(x, 16) || !aligned(w, 16) ||
      (bn != 64 && bn != 128) || split < 1 || split > kSplitMax ||
      p.steps % split || stride > 8 || ph > 127 || pw > 127 ||
      ph - (kh - 1) < -128 || pw - (kw - 1) < -128 || blocks < 1 ||
      (split > 1 ? blocks != tiles * split : blocks > tiles) ||
      !encoders().tiled || !encoders().im2col)
    return static_cast<int>(cudaErrorInvalidValue);
  const int combo = (bn == 128 ? 3 : 0) + (p.span == 128 ? 2
                                           : p.span == 64 ? 1 : 0);
  switch (combo) {
    case 0: err = launch_wgmma<64, 32>(p, blocks, device, s); break;
    case 1: err = launch_wgmma<64, 64>(p, blocks, device, s); break;
    case 2: err = launch_wgmma<64, 128>(p, blocks, device, s); break;
    case 3: err = launch_wgmma<128, 32>(p, blocks, device, s); break;
    case 4: err = launch_wgmma<128, 64>(p, blocks, device, s); break;
    default: err = launch_wgmma<128, 128>(p, blocks, device, s); break;
  }
  if (err == cudaSuccess)
    record(kWgmma, kWBM, bn, p.span, split, p.steps, blocks, 1, 16);
  return static_cast<int>(err);
}

// The plan of the last launch fdms_qconv accepted, as it launched it:
// route, bm, bn, bk (K bytes a step), split, K steps, grid x, grid y, vec;
// route -1 when the last call launched nothing.
extern "C" void fdms_qconv_last_plan(long long* out) {
  for (int i = 0; i < 9; ++i) out[i] = g_plan[i];
}
