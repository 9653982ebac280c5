// One fused E-ELAN group per launch, for sm_90a.
//
// Replaces face_detection_multi_scale_tpu/ops/pallas_elan.py::_elan_kernel
// (wrapper fused_elan). The group, each conv followed by act(acc + bias):
//   x  = 3x3 stride-s conv of the input (optional absorbed "pre" conv)
//   a  = 1x1(x),  b = 1x1(x)
//   y1 = 3x3(b),  yk = 3x3(y_{k-1}) for k = 2..n_chain
//   out = 1x1(concat(members)),  members a subset of {a, b, y1..yn}
// with SAME zero padding of every 3x3 (pad 1). Activations are NCHW and
// weights OHWI (the wrapper's repack of torch's OIHW), both f32 or both
// bf16; biases (C,) f32. act: silu, leaky 0.1 or relu. One template, two
// instantiations: f32 (fdms_fused_elan, below) and bf16
// (fdms_fused_elan_bf16, the last paragraph of this note).
//
// What bounds the f32 form on the card: operations. The group's arithmetic (about
// 56 GFLOP per 640x640 w6 image) is several times its bytes (x, weights,
// out once) over 3.35 TB/s, at any rate the card offers for f32-accurate
// products. The fastest such rate is the tensor cores' in 3xTF32: every f32
// operand v is split into big = tf32(v) and small = tf32(v - big), and a
// product is big*big + big*small + small*big (the small*small term, below
// f32's last bit, is dropped): three TF32 products a multiply-add, so a
// bound of 495 / 3 = 165 TFLOP/s. The design:
//   * whole groups are computed for TH x TW output tiles (a persistent
//     loop over (image, tile)); every intermediate is recomputed on the
//     tile's halo (n_chain pixels for b, shrinking by one per chain conv),
//     so no tile needs another's data and one launch does the group; only
//     the halo's points inside the image are computed. Larger tiles cut
//     that recompute (PERF.md has the plan's A/B evidence);
//   * the intermediates of a tile live in a private slice of a workspace in
//     device memory (the wrapper allocates it; the executor never sees it),
//     laid out channels innermost (HWC) within each region's window, so one
//     K chunk of a position is one contiguous run. A cluster of up to 8
//     blocks shares a slice and splits each conv's (position, channel) block
//     steps, meeting at a cluster barrier after each conv, so groups with
//     few tiles (the deep, narrow-spatial ones) still spread over the SMs;
//   * SAME padding: every intermediate is stored as zero at its window's
//     points outside the image (TPU: mask_zero after every conv), and every
//     read of the input outside the image returns zero, so tiles at the
//     four borders and ragged last tiles come out as the unfused convs do;
//   * each conv is an implicit GEMM, M = positions, N = output channels,
//     K = (source, input channel, tap), on the tensor cores: a block step
//     covers 128 positions x 64 channels, two warpgroups of 64 x 64, each
//     issuing wgmma m64n64k8 TF32 -> f32 (A from registers, B from shared
//     memory), three per 3xTF32 product;
//   * K runs in chunks of 32 channels of one tap of one source, so a chunk's
//     addressing (tap offset, first channel) is set once per chunk and no
//     element needs an integer division. Chunks go through a ring of
//     shared-memory stages filled by cp.async: the next chunks are in
//     flight while the tensor cores work on chunk k, one block barrier per
//     chunk, one block an SM. A workspace source and the weights (which the
//     wrapper hands over as OHWI, a tap's input channels contiguous) are
//     copied 16 bytes at a time; the group input (NCHW, a chunk's channels
//     a plane apart, zero-filled outside the image) 4 bytes at a time. A
//     3x3 conv over a workspace window takes its K order as blocks of 32
//     channels, then the nine taps, and stages A once a block: the whole
//     window rows its 128 positions' taps reach (one contiguous run), which
//     every tap then reads at its own offset, so A crosses from device
//     memory once, not nine times. The weights land in wgmma's K-major
//     core-matrix layout, and each thread splits the quads it copied into
//     big and small parts in place once they land; A is split in registers
//     as its fragments are loaded;
//   * the tensor cores' accumulation does not round to nearest, so a
//     chunk's products (12 wgmma steps into one register tile) are added
//     into an f32 register tile with ordinary adds, and the next chunk
//     starts from zero (the lesson of csrc/probe_mm.cu).
// The result is not bit-identical to a f32 convolution; it is held within
// 1e-5 of max |plain| per group (tests/test_fused_elan.py's bound).
//
// The bf16 form computes what _elan_kernel computes with dtype bfloat16:
// bf16 operands, f32 products and sums (preferred_element_type=f32), bias
// and activation in f32, then every member, chain step, absorbed pre conv
// and the output rounded to bf16 (round to nearest even), so the workspace
// holds bf16 as the TPU kernel's VMEM held x.dtype. Its bound is the
// group's FLOPs over 989 TFLOP/s (bf16 tensor cores), or its bytes over
// 3.35 TB/s if larger. The design is the f32 one with 2-byte elements:
// each k16 step is one wgmma m64n64k16 bf16 -> f32 (A from registers, two
// bf16 a register; no split); B's core matrices are 8 channels x 8 K
// values (16 bytes), the same byte strides as TF32's 8 x 4; a 16-byte copy
// moves 8 values; the NCHW group input and ragged channels, which a
// 2-byte element cannot cp.async, are read with plain loads. The chunk's
// products (two wgmma steps) are added into the f32 totals as in f32.
// A channels_last bf16 group whose channel counts are whole 16-byte runs
// (every zoo group) takes csrc/fused_elan_bf16.cu instead, the TMA route
// redesigned for Hopper (ops/elan_kernel.elan_route); this instantiation
// serves NCHW inputs and ragged channel counts.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // positions per block step
constexpr int kBN = 64;   // output channels per block step
constexpr int kKC = 32;   // K rows per chunk: channels of one tap
constexpr int kStages = 3;
// a 3x3 conv over a workspace window stages A once per 32 channels for all
// nine taps: the rows of the window the block step's taps reach, up to
// kHaloPoints points (two such stages)
constexpr int kHaloPoints = 384;
// two warpgroups of m64n64 tiles; each warp stages 8 channels of B
static_assert(kThreads == 256 && kBM == 128 && kBN == 64 && kKC == 32,
              "the warp layouts below assume these sizes");

// The sizes that follow from the element type T: float (f32) or uint16_t
// (the bits of a bf16). A "quad" is one 16-byte run: 4 f32 or 8 bf16.
template <typename T>
struct Elem {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  // A staging rows ([position][k]): 36 floats or 40 bf16, so a warp's
  // fragment loads (8 rows x 4 columns of 4 bytes) hit 32 banks
  static constexpr int kLdA = kKC + (kBf16 ? 8 : 4);
  static constexpr int kAElems = kBM * kLdA;  // a chunk's A stage
  static constexpr int kHaloElems = kHaloPoints * kLdA;
  static constexpr int kQuads = kKC / kVec;            // 16-byte runs a row
  static constexpr int kRowsPerPass = kThreads / kQuads;  // workspace gather
  static constexpr int kPasses = kBM / kRowsPerPass;
  // B (64 channels x 32 K rows) in wgmma's K-major layout without swizzle:
  // core matrices of 8 channels x 16 bytes (4 f32 or 8 bf16 K rows),
  // channel groups 128 bytes apart (SBO), K quads 1024 bytes apart (LBO);
  // f32: the big parts, then the small parts
  static constexpr int kBElems = kBN * kKC;
  static constexpr int kBQuadsPerThread = kBElems / kVec / kThreads;
  static constexpr int kBStageElems = (kBf16 ? 1 : 2) * kBElems;
  static constexpr int kAAreaElems = kStages * kAElems > 2 * kHaloElems
                                          ? kStages * kAElems
                                          : 2 * kHaloElems;
  static constexpr int kSmemBytes = static_cast<int>(sizeof(T)) *
                                    (kStages * kBStageElems + kAAreaElems);
  // the K column of a thread's first A fragment element: tig (TF32) or
  // 2 tig (a bf16 pair)
  static constexpr int kACol = kBf16 ? 2 : 1;
};
constexpr int kMaxChain = 8;
constexpr int kMaxMembers = kMaxChain + 2;

enum Act { kSilu = 0, kLeaky = 1, kRelu = 2 };

// The profiling build (-DFDMS_ELAN_PROFILE; tools/elan_profile.py): the
// first thread of each warpgroup adds the clocks of each phase into its
// block's slots; the plain build compiles none of it.
enum Phase {
  kWait, kSplit, kBarrier, kIssue, kMath, kEpilogue, kSetup, kClusterSync,
  kTotal, kChunks, kPhases
};
#ifdef FDMS_ELAN_PROFILE
constexpr int kProfBlocks = 1024;
__device__ unsigned long long g_prof[kProfBlocks][2][kPhases];
#define PROF_T(t) const long long t = clock64()
#define PROF_ADD(phase, v)                                       \
  if ((threadIdx.x & 127) == 0 && blockIdx.x < kProfBlocks)      \
  g_prof[blockIdx.x][threadIdx.x >> 7][phase] += (v)
#else
#define PROF_T(t)
#define PROF_ADD(phase, v)
#endif
#define PROF_SINCE(phase, t) PROF_ADD(phase, clock64() - t)

template <typename T>
struct Params {
  const T* x;    // (B, cin, H, W) or, with pre, (B, pre_cin, sH, sW)
  T* out;        // (B, cout, H, W)
  T* ws;         // global workspace, ws_stride elements per cluster
  const T *wp, *wa, *wb, *wt;
  const float *bp, *ba, *bb, *bt;
  const T* wc[kMaxChain];
  const float* bc[kMaxChain];
  long long ws_stride;
  // element offsets of a team's workspace regions, laid out by the wrapper
  // (ops/elan_kernel.py::workspace_layout): x (pre only), b, a (if a
  // member), y1..yn, each holding its window, channels innermost
  long long off_x, off_b, off_a, off_y[kMaxChain];
  int batch, h, w, cin, ccv, cch, cout, n_chain, pre_cin, pre_stride, act;
  int n_members, tile_h, tile_w, cluster;
  int members[kMaxMembers];  // -2 = a, -1 = b, k >= 0 = y_{k+1}
};

// A conv's input. An image source is the NCHW input of one image (`plane`
// elements a channel, rows of `ld`), read inside its dh x dw domain only
// and as zero outside. A workspace source is an HWC window whose element
// (0, 0) is domain point (oy, ox), rows of `ld` points, `cin` elements a
// point; it covers every tap its consumer reads and holds zeros outside
// the domain already. `w` points at the OHWI weights of this input's
// channels, `w_co` elements apart from one output channel to the next.
template <typename T>
struct Src {
  const T* p;
  long long plane;
  int oy, ox, ld, dh, dw, cin;
  const T* w;
  long long w_co;
  bool image;
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kSilu) return v / (1.0f + expf(-v));
  if (act == kLeaky) return v > 0.0f ? v : v * 0.1f;
  return v > 0.0f ? v : 0.0f;
}

// v stored as T: f32 as it is, bf16 rounded to nearest even
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// two neighbours at once (p aligned to twice the element)
__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put2(uint16_t* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 or 16 bytes from global to shared memory, zeros where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest `kStages - 2` has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// v rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32, by an integer add and a mask on the full-rate pipes
// (the conversion instruction runs at a quarter of their rate)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = big + small, each TF32 (ops/elan_kernel.py::tf32_split)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// cp.async's and plain stores' writes (generic proxy) visible to the
// tensor cores' reads (async proxy)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor, no swizzle: start address,
// leading (K) and stride (channel group) byte offsets, each >> 4
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3fff) |
         static_cast<uint64_t>(1024 >> 4) << 16 |
         static_cast<uint64_t>(128 >> 4) << 32;
}

// d (+)= A B over 8 K rows for the warpgroup's 64 positions x 64 channels:
// A from registers (rows 16 warp + gid (+8), K columns tig (+4) of the
// warp's slice), B through its descriptor; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= A B over 16 K rows, bf16 operands, f32 sums: A from registers
// (rows 16 warp + gid (+8), K columns 2 tig, +1 (+8) of the warp's slice,
// two bf16 a register), B K-major through its descriptor
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Where the K chunks of a conv stand: source, first channel, tap (ky, kx).
// The K order is sources, then blocks of 32 channels, then taps.
struct Cursor {
  int s, ky, kx, ci0;
};

template <typename T>
__device__ __forceinline__ void advance(Cursor& c, const Src<T>* srcs,
                                        int n_src, int k) {
  if (++c.kx < k) return;
  c.kx = 0;
  if (++c.ky < k) return;
  c.ky = 0;
  c.ci0 += kKC;
  if (c.ci0 < srcs[c.s].cin) return;
  c.ci0 = 0;
  if (++c.s == n_src) c.s = 0;  // a rotated order wraps around
}

// The cursor at chunk `idx` of the conv's K order, once per block step.
template <typename T>
__device__ Cursor cursor_at(const Src<T>* srcs, int n_src, int k, int idx) {
  Cursor c = {0, 0, 0, 0};
  for (int s = 0; s < n_src; ++s) {
    const int n = k * k * ((srcs[s].cin + kKC - 1) / kKC);
    if (idx < n) {
      const int tap = idx % (k * k);
      c = {s, tap / k, tap % k, idx / (k * k) * kKC};
      break;
    }
    idx -= n;
  }
  return c;
}

// The gathering geometry of one block step, set once per step: the tap
// (0, 0) input point of each position this thread copies, in domain
// coordinates, and whether the position is a real one. Workspace chunks:
// kPasses positions (tid / kQuads + kRowsPerPass i) x channels kVec (tid
// % kQuads) .. + kVec - 1; image chunks: 2 positions (16 warp + 8 i + lane % 8) x K
// rows lane / 8 + 4 j.
template <typename T>
struct Gather {
  int hy[Elem<T>::kPasses], hx[Elem<T>::kPasses];
  bool hok[Elem<T>::kPasses];
  int iy[2], ix[2];
  bool iok[2];
};

// The weight quads a thread stages: channel 8 warp + lane % 8 and K quads
// lane / 8 + 4 i, so 8 lanes fill one core matrix (128 contiguous bytes)
// and a channel's quads are read 64 bytes at a time
__device__ __forceinline__ int b_channel() {
  return 8 * (threadIdx.x >> 5) + (threadIdx.x & 7);
}
__device__ __forceinline__ int b_quad(int i) {
  return (threadIdx.x & 31) / 8 + 4 * i;
}
// element offset of (channel n, K quad kq) in the B layout
template <typename T>
__device__ __forceinline__ int b_offset(int n, int kq) {
  constexpr int v = Elem<T>::kVec;
  return (kq * (kBN / 8) + n / 8) * (8 * v) + (n % 8) * v;
}

// The A rows a block step's 3x3 taps reach in a workspace window: from
// window row r0, n_pts points (whole rows of ld points).
struct Halo {
  int r0, n_pts;
};

// One element of a source that cp.async cannot stage: the element (4
// bytes) with cp.async; a bf16 (2 bytes) with a plain load of the
// read-only group input or weights
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                      bool ok) {
  cp_async4(dst, src, ok);
}
__device__ __forceinline__ void stage1(uint16_t* dst, const uint16_t* src,
                                      bool ok) {
  *dst = ok ? __ldg(src) : static_cast<uint16_t>(0);
}

// Stage chunk `c` of the block step: B (64 channels x 32 K rows, core
// matrices) into `sB` and, unless `sA` is null, A into `sA`: with `halo`
// the block of 32 channels of the region's points ([point][k]), else the
// chunk's 128 positions x 32 K rows ([position][k]).
template <typename T>
__device__ __forceinline__ void load_chunk(T* sA, T* sB, const Src<T>* srcs,
                                           const Cursor& c,
                                           const Gather<T>& g,
                                           const Halo* halo, int k, int ct0,
                                           int c_out) {
  using El = Elem<T>;
  constexpr int v = El::kVec;
  const int tid = threadIdx.x;
  const Src<T>& S = srcs[c.s];
  if (sA == nullptr) {
    // a tap after the first of a channel block: its A is staged already
  } else if (halo != nullptr) {
    // whole rows, so the region is one run of points
    const T* base =
        S.p + static_cast<long long>(halo->r0) * S.ld * S.cin + c.ci0;
    const bool vec =
        S.cin % v == 0 && (reinterpret_cast<uintptr_t>(S.p) & 15) == 0;
    for (int q = tid; q < halo->n_pts * El::kQuads; q += kThreads) {
      const int pnt = q / El::kQuads, qq = (q % El::kQuads) * v;
      T* dst = sA + pnt * El::kLdA + qq;
      const T* src = base + static_cast<long long>(pnt) * S.cin + qq;
      if (vec && c.ci0 + qq + v <= S.cin) {
        cp_async16(dst, src, true);
      } else {
#pragma unroll
        for (int e = 0; e < v; ++e)
          dst[e] = c.ci0 + qq + e < S.cin ? __ldcg(src + e) : T{};
      }
    }
  } else if (S.image) {
    // 8 lanes read 8 neighbouring positions of one channel plane
    const int lane = tid & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = (tid >> 5) * 16 + 8 * i + lane % 8;
      const int y = g.iy[i] + c.ky, x = g.ix[i] + c.kx;
      const bool in = g.iok[i] && y >= 0 && y < S.dh && x >= 0 && x < S.dw;
      const T* base = S.p + (in ? static_cast<long long>(y) * S.ld + x : 0);
#pragma unroll
      for (int j = 0; j < kKC / 4; ++j) {
        const int r = lane / 8 + 4 * j;
        const int ci = c.ci0 + r;
        const bool ok = in && ci < S.cin;
        stage1(sA + p * El::kLdA + r, ok ? base + ci * S.plane : S.p, ok);
      }
    }
  } else {
    const int q = (tid % El::kQuads) * v;
    const int ci = c.ci0 + q;
    const bool vec =
        S.cin % v == 0 && (reinterpret_cast<uintptr_t>(S.p) & 15) == 0;
#pragma unroll
    for (int i = 0; i < El::kPasses; ++i) {
      const int p = tid / El::kQuads + El::kRowsPerPass * i;
      T* dst = sA + p * El::kLdA + q;
      const T* src =
          S.p + (static_cast<long long>(g.hy[i] + c.ky - S.oy) * S.ld +
                 (g.hx[i] + c.kx - S.ox)) * S.cin + ci;
      if (vec && ci + v <= S.cin) {
        cp_async16(dst, g.hok[i] ? src : S.p, g.hok[i]);
      } else {
        // channels that are not a whole, aligned quad: plain L2 loads (the
        // workspace is written by other blocks of the cluster, so never L1)
#pragma unroll
        for (int e = 0; e < v; ++e)
          dst[e] = g.hok[i] && ci + e < S.cin ? __ldcg(src + e) : T{};
      }
    }
  }
  // weights (OHWI: a tap's input channels contiguous), 16 bytes of a core
  // matrix row a copy
  const int n = b_channel();
  const int co = ct0 + n;
  const bool cok = co < c_out;
  const T* wrow = S.w + (cok ? co * S.w_co : 0) + (c.ky * k + c.kx) * S.cin;
  const bool wvec = S.w_co % v == 0 && S.cin % v == 0 &&
                    (reinterpret_cast<uintptr_t>(S.w) & 15) == 0;
#pragma unroll
  for (int i = 0; i < El::kBQuadsPerThread; ++i) {
    const int kq = b_quad(i);
    const int ci = c.ci0 + v * kq;
    T* dst = sB + b_offset<T>(n, kq);
    if (wvec && ci + v <= S.cin) {
      cp_async16(dst, cok ? wrow + ci : S.w, cok);
    } else {
#pragma unroll
      for (int e = 0; e < v; ++e) {
        const bool ok = cok && ci + e < S.cin;
        stage1(dst + e, ok ? wrow + ci + e : S.w, ok);
      }
    }
  }
}

// Split the weight quads this thread staged into `sB` (landed) into big
// parts in place and small parts in the second B region, then make them
// visible to the tensor cores' reads (the async proxy).
__device__ __forceinline__ void split_b(float* sB) {
  using El = Elem<float>;
  const int n = b_channel();
#pragma unroll
  for (int i = 0; i < El::kBQuadsPerThread; ++i) {
    float4* big =
        reinterpret_cast<float4*>(sB + b_offset<float>(n, b_quad(i)));
    float4* small = big + El::kBElems / 4;
    const float4 v = *big;
    uint32_t b[4], s[4];
    split_tf32(v.x, b[0], s[0]);
    split_tf32(v.y, b[1], s[1]);
    split_tf32(v.z, b[2], s[2]);
    split_tf32(v.w, b[3], s[3]);
    *big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                       __uint_as_float(b[2]), __uint_as_float(b[3]));
    *small = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                         __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
  fence_async_proxy();
}

// What the tensor cores read of a landed B stage: f32 weights split into
// their big and small parts; bf16 as they are, made visible to the async
// proxy
__device__ __forceinline__ void ready_b(float* sB) { split_b(sB); }
__device__ __forceinline__ void ready_b(uint16_t*) { fence_async_proxy(); }

// The products of one staged chunk (its weights split): acc = A(the
// warpgroup's 64 positions) B over the chunk's 32 K rows, 3xTF32, the
// small terms first; `a0` and `a1` are this thread's staged A rows gid and
// gid + 8 of its warp, from column tig. Returns when the tensor cores are
// done with acc.
__device__ __forceinline__ void mma_chunk(const float* a0, const float* a1,
                                          const float* sB, float (&acc)[32]) {
  uint32_t ab[kKC / 8][4], as[kKC / 8][4];
#pragma unroll
  for (int s = 0; s < kKC / 8; ++s) {
    // a0 (row gid, column tig), a1 row gid + 8, a2/a3 column tig + 4
    split_tf32(a0[8 * s], ab[s][0], as[s][0]);
    split_tf32(a1[8 * s], ab[s][1], as[s][1]);
    split_tf32(a0[8 * s + 4], ab[s][2], as[s][2]);
    split_tf32(a1[8 * s + 4], ab[s][3], as[s][3]);
  }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kKC / 8; ++s) {
    const float* big = sB + 2 * s * (kBN / 8) * 32;
    wgmma_tf32(acc, as[s], b_desc(big), s > 0);
    wgmma_tf32(acc, ab[s], b_desc(big + Elem<float>::kBElems), 1);
    wgmma_tf32(acc, ab[s], b_desc(big), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The products of one staged bf16 chunk: acc = A B over its 32 K rows, two
// k16 steps; `a0` and `a1` are this thread's staged A rows gid and gid + 8
// of its warp, from column 2 tig. Returns when the tensor cores are done
// with acc.
__device__ __forceinline__ void mma_chunk(const uint16_t* a0,
                                          const uint16_t* a1,
                                          const uint16_t* sB,
                                          float (&acc)[32]) {
  uint32_t a[kKC / 16][4];
#pragma unroll
  for (int s = 0; s < kKC / 16; ++s) {
    // row gid, row gid + 8, then both 8 K columns on
    a[s][0] = *reinterpret_cast<const uint32_t*>(a0 + 16 * s);
    a[s][1] = *reinterpret_cast<const uint32_t*>(a1 + 16 * s);
    a[s][2] = *reinterpret_cast<const uint32_t*>(a0 + 16 * s + 8);
    a[s][3] = *reinterpret_cast<const uint32_t*>(a1 + 16 * s + 8);
  }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kKC / 16; ++s)
    wgmma_bf16(acc, a[s], b_desc(sB + 2 * s * (kBN / 8) * 64), s > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// One conv stage over the output window (oy, ox, oh x ow) of a domain
// dh x dw with `c_out` channels: sum over `srcs`, + bias, act. Only the
// window's points inside the domain are computed. With `dst_ld` > 0 the
// window is stored whole into `dst` (HWC, rows of oh x ow points, c_out
// elements a point), zero at its points outside the domain (the SAME padding
// its 3x3 consumer reads); with dst_ld == 0 the points are stored into the
// NCHW image `dst` (planes dh x dw). The (position, channel) block steps
// are dealt out over the `n_ranks` blocks of the cluster; every thread of
// the block takes part.
template <typename T>
__device__ void conv_stage(T* smem, const Src<T>* srcs, int n_src, int k,
                           int stride, const float* bias, int act, int oy,
                           int ox, int oh, int ow, int dh, int dw, int c_out,
                           T* dst, int dst_ld, int rank, int n_ranks) {
  using El = Elem<T>;
  constexpr int kLdA = El::kLdA, kQuads = El::kQuads;
  constexpr int kPasses = El::kPasses, kRowsPerPass = El::kRowsPerPass;
  PROF_T(t_setup);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int y0 = max(oy, 0), y1 = min(oy + oh, dh);
  const int x0 = max(ox, 0), x1 = min(ox + ow, dw);
  const int in_w = max(x1 - x0, 0);
  const int n_pos = max(y1 - y0, 0) * in_w;
  if (dst_ld > 0 && n_pos < oh * ow) {
    // the window's points outside the domain
    for (int pt = rank * kThreads + tid; pt < oh * ow;
         pt += n_ranks * kThreads) {
      const int gy = oy + pt / ow, gx = ox + pt % ow;
      if (gy < 0 || gy >= dh || gx < 0 || gx >= dw) {
        T* d = dst + static_cast<long long>(pt) * c_out;
        for (int c = 0; c < c_out; ++c) d[c] = T{};
      }
    }
  }
  const int n_pt = (n_pos + kBM - 1) / kBM;
  const int n_ct = (c_out + kBN - 1) / kBN;
  const int pad = k / 2, taps = k * k;
  int n_chunks = 0;
  for (int s = 0; s < n_src; ++s)
    n_chunks += taps * ((srcs[s].cin + kKC - 1) / kKC);
  // a 3x3 conv over one workspace window stages A once for its nine taps
  // when the rows a block step reaches fit a halo stage
  const Src<T>& S0 = srcs[0];
  const bool use_halo =
      k == 3 && n_src == 1 && stride == 1 && !S0.image && in_w > 0 &&
      ((kBM + in_w - 1) / in_w + 3) * S0.ld <= kHaloPoints;
  T* const sA0 = smem + kStages * El::kBStageElems;  // the A area
  PROF_SINCE(kSetup, t_setup);
  for (int t = rank; t < n_pt * n_ct; t += n_ranks) {
    PROF_T(t_step);
    const int pt = t / n_ct, ct = t % n_ct;
    const int ct0 = ct * kBN;
    Gather<T> g;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int pos = pt * kBM + tid / kQuads + kRowsPerPass * i;
      g.hok[i] = pos < n_pos;
      const int p = g.hok[i] ? pos : 0;
      g.hy[i] = (y0 + p / in_w) * stride - pad;
      g.hx[i] = (x0 + p % in_w) * stride - pad;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = pt * kBM + (tid >> 5) * 16 + 8 * i + (tid & 7);
      g.iok[i] = pos < n_pos;
      const int p = g.iok[i] ? pos : 0;
      g.iy[i] = (y0 + p / in_w) * stride - pad;
      g.ix[i] = (x0 + p % in_w) * stride - pad;
    }
    // the halo region of this step and, at tap (0, 0), the region points
    // of this thread's A rows gid and gid + 8
    Halo halo = {0, 0};
    int hb[2] = {0, 0};
    if (use_halo) {
      const int p_lo = pt * kBM, p_hi = min(p_lo + kBM, n_pos) - 1;
      halo.r0 = y0 + p_lo / in_w - 1 - S0.oy;
      halo.n_pts = (p_hi / in_w - p_lo / in_w + 3) * S0.ld;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = p_lo + 16 * warp + gid + 8 * h;
        const int p = pos < n_pos ? pos : p_lo;
        hb[h] = (y0 + p / in_w - 1 - S0.oy - halo.r0) * S0.ld +
                (x0 + p % in_w - 1 - S0.ox);
      }
    }
    float tot[32], acc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) tot[q] = acc[q] = 0.0f;

    PROF_SINCE(kSetup, t_step);
    __syncthreads();  // the previous step's readers of the stages are done
    // the ring: chunk c's weights in B stage c % kStages and its A in A
    // stage c % kStages, or with the halo the block of 32 channels of
    // chunks c - c % 9 .. + 8 in halo stage c / 9 % 2, loaded with the
    // block's first tap; kStages - 1 chunks in flight ahead of the one the
    // tensor cores work on; one group per chunk (empty past the last), so
    // a fixed wait count finds chunk c landed. Each block starts at
    // another block of channels (a sum in another order), so the SMs do
    // not all read the same weights at once.
    Cursor ahead = cursor_at(srcs, n_src, k, blockIdx.x % n_chunks / taps *
                                                 taps);
    auto issue = [&](int c) {
      T* sA = nullptr;
      if (!use_halo)
        sA = sA0 + (c % kStages) * El::kAElems;
      else if (c % taps == 0)
        sA = sA0 + (c / taps % 2) * El::kHaloElems;
      load_chunk(sA, smem + (c % kStages) * El::kBStageElems, srcs, ahead,
                 g, use_halo ? &halo : nullptr, k, ct0, c_out);
      advance(ahead, srcs, n_src, k);
    };
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_chunks) issue(c);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      PROF_T(t0);
      cp_async_wait_ring();
      PROF_T(t1);
      T* sB = smem + (c % kStages) * El::kBStageElems;
      ready_b(sB);
      PROF_T(t2);
      __syncthreads();  // chunk c landed and split; chunk c - 1 is done
      PROF_T(t3);
      if (c + kStages - 1 < n_chunks) issue(c + kStages - 1);
      cp_async_commit();
      PROF_T(t4);
      const T *a0, *a1;
      if (use_halo) {
        const T* base =
            sA0 + (c / taps % 2) * El::kHaloElems + tig * El::kACol;
        const int off = (c % taps / 3) * S0.ld + c % 3;
        a0 = base + (hb[0] + off) * kLdA;
        a1 = base + (hb[1] + off) * kLdA;
      } else {
        a0 = sA0 + (c % kStages) * El::kAElems + (16 * warp + gid) * kLdA +
             tig * El::kACol;
        a1 = a0 + 8 * kLdA;
      }
      mma_chunk(a0, a1, sB, acc);
#pragma unroll
      for (int q = 0; q < 32; ++q) tot[q] += acc[q];
      PROF_ADD(kWait, t1 - t0);
      PROF_ADD(kSplit, t2 - t1);
      PROF_ADD(kBarrier, t3 - t2);
      PROF_ADD(kIssue, t4 - t3);
      PROF_SINCE(kMath, t4);
      PROF_ADD(kChunks, 1);
    }
    PROF_T(t_epi);

    // epilogue: element 4 j + 2 h + e of the tile is (row 16 warp + gid +
    // 8 h, column 8 j + 2 tig + e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = pt * kBM + 16 * warp + gid + 8 * h;
      if (pos >= n_pos) continue;
      const int gy = y0 + pos / in_w, gx = x0 + pos % in_w;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int co = ct0 + 8 * j + 2 * tig;
        if (co >= c_out) continue;
        const bool two = co + 1 < c_out;
        const float v0 = activate(tot[4 * j + 2 * h] + bias[co], act);
        const float v1 =
            two ? activate(tot[4 * j + 2 * h + 1] + bias[co + 1], act) : 0.0f;
        if (dst_ld > 0) {
          // HWC: the two channels side by side
          T* d = dst + (static_cast<long long>(gy - oy) * dst_ld +
                        (gx - ox)) * c_out + co;
          if (two &&
              (reinterpret_cast<uintptr_t>(d) & (2 * sizeof(T) - 1)) == 0) {
            put2(d, v0, v1);
          } else {
            put(d, v0);
            if (two) put(d + 1, v1);
          }
        } else {
          const long long plane = static_cast<long long>(dh) * dw;
          T* d = dst + co * plane + static_cast<long long>(gy) * dw + gx;
          put(d, v0);
          if (two) put(d + plane, v1);
        }
      }
    }
    PROF_SINCE(kEpilogue, t_epi);
  }
}

template <typename T>
__device__ __forceinline__ Src<T> window(const T* p, int oy, int ox,
                                         int cols, int dh, int dw, int cin,
                                         const T* w, long long w_co) {
  Src<T> s;
  s.p = p;
  s.plane = 0;
  s.oy = oy;
  s.ox = ox;
  s.ld = cols;
  s.dh = dh;
  s.dw = dw;
  s.cin = cin;
  s.w = w;
  s.w_co = w_co;
  s.image = false;
  return s;
}

template <typename T>
__device__ __forceinline__ Src<T> image(const T* p, int dh, int dw, int cin,
                                        const T* w, long long w_co) {
  Src<T> s = window(p, 0, 0, dw, dh, dw, cin, w, w_co);
  s.plane = static_cast<long long>(dh) * dw;
  s.image = true;
  return s;
}

// Every block of the cluster at this point, and their workspace writes
// visible to each other (release/acquire at cluster scope).
__device__ __forceinline__ void sync_cluster(int n_ranks) {
  PROF_T(t);
  if (n_ranks > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  PROF_SINCE(kClusterSync, t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_elan_kernel(const Params<T> P) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* const smem = reinterpret_cast<T*>(smem_bytes);
  PROF_T(t_kernel);
  // a cluster of `n_ranks` blocks shares each tile and its workspace
  const int n_ranks = P.cluster;
  const int rank = static_cast<int>(blockIdx.x) % n_ranks;
  const long long team = blockIdx.x / n_ranks, n_teams = gridDim.x / n_ranks;
  T* ws = P.ws + team * P.ws_stride;
  const int TH = P.tile_h, TW = P.tile_w, p = P.n_chain;
  const int EH = TH + 2 * p, EW = TW + 2 * p;  // the b window
  const int H = P.h, W = P.w;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int per_img = tiles_x * tiles_y;
  const long long n_tiles = static_cast<long long>(P.batch) * per_img;
  const bool has_pre = P.pre_cin > 0;
  bool has_a = false;
  for (int m = 0; m < P.n_members; ++m) has_a |= P.members[m] == -2;

  // the team's workspace regions, where the wrapper put them
  T* xbuf = ws + P.off_x;
  T* bbuf = ws + P.off_b;
  T* abuf = ws + P.off_a;
  T* ybuf[kMaxChain];
  for (int kk = 0; kk < P.n_chain; ++kk) ybuf[kk] = ws + P.off_y[kk];

  for (long long tile = team; tile < n_tiles; tile += n_teams) {
    const int n = static_cast<int>(tile / per_img);
    const int rem = static_cast<int>(tile % per_img);
    const int ty = (rem / tiles_x) * TH, tx = (rem % tiles_x) * TW;
    sync_cluster(n_ranks);  // the previous tile's readers are done

    // the group input x over the b window (halo p)
    Src<T> src[kMaxMembers];
    Src<T> xs;
    if (has_pre) {
      const int s = P.pre_stride;
      const T* img = P.x + static_cast<long long>(n) * P.pre_cin *
                               (static_cast<long long>(H) * s) * (W * s);
      src[0] = image(img, H * s, W * s, P.pre_cin, P.wp,
                     static_cast<long long>(P.pre_cin) * 9);
      conv_stage(smem, src, 1, 3, s, P.bp, P.act, ty - p, tx - p, EH, EW, H,
                 W, P.cin, xbuf, EW, rank, n_ranks);
      sync_cluster(n_ranks);
      xs = window<T>(xbuf, ty - p, tx - p, EW, H, W, P.cin, nullptr,
                     P.cin);
    } else {
      const T* img =
          P.x + static_cast<long long>(n) * P.cin * static_cast<long long>(H) * W;
      xs = image<T>(img, H, W, P.cin, nullptr, P.cin);
    }

    // the two 1x1 branches
    src[0] = xs;
    src[0].w = P.wb;
    conv_stage(smem, src, 1, 1, 1, P.bb, P.act, ty - p, tx - p, EH, EW, H, W,
               P.ccv, bbuf, EW, rank, n_ranks);
    if (has_a) {
      src[0].w = P.wa;
      conv_stage(smem, src, 1, 1, 1, P.ba, P.act, ty, tx, TH, TW, H, W, P.ccv,
                 abuf, TW, rank, n_ranks);
    }
    sync_cluster(n_ranks);

    // the 3x3 chain, the window shrinking by one pixel a side per conv
    for (int kk = 0; kk < P.n_chain; ++kk) {
      const int o_in = p - kk, o = o_in - 1;
      const int c_in = kk == 0 ? P.ccv : P.cch;
      src[0] = window(kk == 0 ? bbuf : ybuf[kk - 1], ty - o_in, tx - o_in,
                      TW + 2 * o_in, H, W, c_in, P.wc[kk],
                      static_cast<long long>(c_in) * 9);
      conv_stage(smem, src, 1, 3, 1, P.bc[kk], P.act, ty - o, tx - o,
                 TH + 2 * o, TW + 2 * o, H, W, P.cch, ybuf[kk], TW + 2 * o,
                 rank, n_ranks);
      sync_cluster(n_ranks);
    }

    // the transition over the members, in order; rows of wt follow them
    long long off = 0;
    for (int m = 0; m < P.n_members; ++m) {
      const int id = P.members[m];
      if (id == -2) {
        src[m] = window(abuf, ty, tx, TW, H, W, P.ccv, P.wt + off, 0);
        off += P.ccv;
      } else if (id == -1) {
        src[m] = window(bbuf, ty - p, tx - p, EW, H, W, P.ccv, P.wt + off, 0);
        off += P.ccv;
      } else {
        const int o = p - id - 1;
        src[m] = window(ybuf[id], ty - o, tx - o, TW + 2 * o, H, W, P.cch,
                        P.wt + off, 0);
        off += P.cch;
      }
    }
    for (int m = 0; m < P.n_members; ++m) src[m].w_co = off;
    T* out = P.out + static_cast<long long>(n) * P.cout *
                         static_cast<long long>(H) * W;
    conv_stage(smem, src, P.n_members, 1, 1, P.bt, P.act, ty, tx, TH, TW, H,
               W, P.cout, out, 0, rank, n_ranks);
  }
  PROF_SINCE(kTotal, t_kernel);
}

}  // namespace

#ifdef FDMS_ELAN_PROFILE
// The profiling build's counters: copies blocks x 2 x kPhases of them into
// `out` (at most kProfBlocks blocks), then zeroes them. Returns the number
// of phases a block slot holds, or a negative CUDA error.
extern "C" int fdms_fused_elan_profile(unsigned long long* out, int blocks) {
  const size_t n = sizeof(unsigned long long) * 2 * kPhases *
                   static_cast<size_t>(blocks < kProfBlocks ? blocks
                                                            : kProfBlocks);
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, n);
  static unsigned long long zeros[kProfBlocks][2][kPhases];
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros));
  return err == cudaSuccess ? static_cast<int>(kPhases) : -static_cast<int>(err);
}
#endif

namespace {

// fdms_fused_elan(_bf16)'s body for element type T
template <typename T>
int launch(void* const* ptrs, const long long* ints, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params<T> P;
  P.x = static_cast<const T*>(ptrs[0]);
  P.out = static_cast<T*>(ptrs[1]);
  P.ws = static_cast<T*>(ptrs[2]);
  P.wp = static_cast<const T*>(ptrs[3]);
  P.bp = static_cast<const float*>(ptrs[4]);
  P.wa = static_cast<const T*>(ptrs[5]);
  P.ba = static_cast<const float*>(ptrs[6]);
  P.wb = static_cast<const T*>(ptrs[7]);
  P.bb = static_cast<const float*>(ptrs[8]);
  P.wt = static_cast<const T*>(ptrs[9]);
  P.bt = static_cast<const float*>(ptrs[10]);
  P.batch = static_cast<int>(ints[0]);
  P.h = static_cast<int>(ints[1]);
  P.w = static_cast<int>(ints[2]);
  P.cin = static_cast<int>(ints[3]);
  P.ccv = static_cast<int>(ints[4]);
  P.cch = static_cast<int>(ints[5]);
  P.cout = static_cast<int>(ints[6]);
  P.n_chain = static_cast<int>(ints[7]);
  P.pre_cin = static_cast<int>(ints[8]);
  P.pre_stride = static_cast<int>(ints[9]);
  P.act = static_cast<int>(ints[10]);
  P.tile_h = static_cast<int>(ints[11]);
  P.tile_w = static_cast<int>(ints[12]);
  const int grid = static_cast<int>(ints[13]);
  P.ws_stride = ints[14];
  P.cluster = static_cast<int>(ints[15]);
  P.n_members = static_cast<int>(ints[16]);
  if (P.n_chain < 1 || P.n_chain > kMaxChain || P.n_members < 1 ||
      P.n_members > kMaxMembers || P.cluster < 1 || P.cluster > 8 ||
      grid % P.cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int kk = 0; kk < P.n_chain; ++kk) {
    P.wc[kk] = static_cast<const T*>(ptrs[11 + 2 * kk]);
    P.bc[kk] = static_cast<const float*>(ptrs[12 + 2 * kk]);
  }
  for (int m = 0; m < P.n_members; ++m)
    P.members[m] = static_cast<int>(ints[17 + m]);
  const long long* off = ints + 17 + P.n_members;
  P.off_x = off[0];
  P.off_b = off[1];
  P.off_a = off[2];
  for (int kk = 0; kk < P.n_chain; ++kk) P.off_y[kk] = off[3 + kk];
  err = cudaFuncSetAttribute(fused_elan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Elem<T>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Elem<T>::kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_elan_kernel<T>, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one group on `stream` of `device`; returns cudaGetLastError()
// (0 on success). ptrs: x, out, workspace, wp, bp (null without pre), wa,
// ba, wb, bb, wt, bt, then n_chain pairs (w_k, b_k). ints: batch, h, w,
// cin, ccv, cch, cout, n_chain, pre_cin, pre_stride, act, tile_h, tile_w,
// grid, ws_stride, cluster, n_members, then the n_members member ids (-2 =
// a, -1 = b, k = y_{k+1}), then the workspace offsets (in elements): x, b,
// a, y1..y_{n_chain}. grid is a multiple of cluster (at most 8, the
// portable cluster size). fdms_fused_elan: every tensor f32;
// fdms_fused_elan_bf16: x, out, workspace and kernels bf16, biases f32.
extern "C" int fdms_fused_elan(void* const* ptrs, const long long* ints,
                               int device, void* stream) {
  return launch<float>(ptrs, ints, device, stream);
}
extern "C" int fdms_fused_elan_bf16(void* const* ptrs, const long long* ints,
                                    int device, void* stream) {
  return launch<uint16_t>(ptrs, ints, device, stream);
}
