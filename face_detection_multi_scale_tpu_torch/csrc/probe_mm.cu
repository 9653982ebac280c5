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
// the product, which would cut the work M-fold and defeat the probe.
//
// What bounds it on the card: operations. A cell does 2*M*K*N FLOPs (9x
// that for taps and cat9) on 1.6 MB of inputs that every cell shares, so
// after the first cell the inputs come from L2. The design feeds the
// tensor cores (mma.sync m16n8k16, bf16 -> f32) from shared memory:
//   * one block of 8 warps per cell;
//   * the block stages W transposed, W^T (N, KW), into shared memory once
//     (w9: 147 KB, so dynamic shared memory above 48 KB);
//   * it walks M in chunks of MC rows, staging each chunk's A rows (16-byte
//     loads) through shared memory; the variants differ only in how a
//     chunk's rows are addressed: 2-D rows (pre2d), (r, c) arithmetic over
//     the same bytes (flat), one shifted window per pass (taps: an implicit
//     GEMM, 9 passes a chunk), or an explicit im2col tile of MC x 1152 that
//     holds the 9 windows of each row (cat9);
//   * each warp accumulates its 16-row x (8*NT)-column tile of one staged
//     chunk (one pass) in the mma accumulators, then adds it into a second
//     register tile with ordinary f32 adds and starts the next chunk from
//     zero: the tensor cores' accumulation does not round to nearest, and
//     on an H100 a chain over every chunk (up to 13,000 mma steps for cat9)
//     drifted 2.3e-4 of max |plain| from the plain version, where chains of
//     one chunk (at most 72 steps, a K = 1152 dot product) stay within
//     1e-6;
//   * at the end the 16 rows are summed with warp shuffles, then the warps
//     along M in shared memory.
// Rows past M (the ragged last chunk) are staged as zeros and add nothing.
// Row strides in shared memory are padded by 8 bf16, so the fragment loads
// of a warp fall in 32 distinct banks. Double-buffered staging (cp.async or
// TMA) and wgmma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 36, kC = 176, kK = 128, kN = 64;
constexpr int kRq = kR - 2, kCq = kC - 2;  // the tap window, 34 x 174
constexpr int kThreads = 256;              // 8 warps
constexpr int kPad = 8;                    // bf16 of padding per shared row

enum Variant { kPre2d = 0, kFlat = 1, kTaps = 2, kCat9 = 3 };

template <int V>
struct Plan {
  static constexpr int KA = V == kCat9 ? 9 * kK : kK;  // A row width
  static constexpr int MW = V == kCat9 ? 2 : 8;         // warps along M
  static constexpr int NT = kN / 8 / (8 / MW);          // n-tiles a warp
  static constexpr int MC = 16 * MW;                    // rows a chunk
  static constexpr int M = V == kPre2d || V == kFlat ? kR * kC : kRq * kCq;
  static constexpr int PASSES = V == kTaps ? 9 : 1;     // windows a chunk
  static constexpr int LDA = KA + kPad, LDW = KA + kPad;
  static constexpr size_t kSmem = sizeof(uint16_t) * (kN * LDW + MC * LDA);
};

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The K-vector (kK bf16, 16-byte aligned) of global row `m` of pass or tap
// `t`, or nullptr past M.
template <int V>
__device__ __forceinline__ const uint16_t* a_row(const uint16_t* x,
                                                 const uint16_t* x2, int m,
                                                 int t) {
  if (m >= Plan<V>::M) return nullptr;
  if (V == kPre2d) return x2 + static_cast<size_t>(m) * kK;
  if (V == kFlat) {
    const int r = m / kC, c = m % kC;
    return x + (static_cast<size_t>(r) * kC + c) * kK;
  }
  const int r = m / kCq + t / 3, c = m % kCq + t % 3;  // window of tap t
  return x + (static_cast<size_t>(r) * kC + c) * kK;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
probe_mm_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ x2,
                const uint16_t* __restrict__ w, float* __restrict__ out) {
  using P = Plan<V>;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* s_w = smem;                  // W^T: (kN, LDW)
  uint16_t* s_a = smem + kN * P::LDW;    // A chunk: (MC, LDA)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % P::MW, wn = warp / P::MW;

  // W (KA, kN) row-major -> W^T in shared memory, once
  for (int i = tid; i < P::KA * kN; i += kThreads)
    s_w[(i % kN) * P::LDW + i / kN] = w[i];

  float tot[P::NT][4];  // the sum over chunks, f32 adds
  for (int nt = 0; nt < P::NT; ++nt)
    for (int q = 0; q < 4; ++q) tot[nt][q] = 0.f;

  constexpr int kVecs = P::KA / 8;  // 16-byte vectors in an A row
  const uint16_t* a_lo = s_a + (wm * 16 + gid) * P::LDA + tig * 2;
  const uint16_t* a_hi = a_lo + 8 * P::LDA;
  for (int m0 = 0; m0 < P::M; m0 += P::MC) {
    for (int pass = 0; pass < P::PASSES; ++pass) {
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < P::MC * kVecs; i += kThreads) {
        const int row = i / kVecs, v = i % kVecs;
        // cat9: vector v of the row is vector v % 16 of tap v / 16
        const int tap = V == kCat9 ? v / (kK / 8) : pass;
        const uint16_t* src = a_row<V>(x, x2, m0 + row, tap);
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (src != nullptr)
          val = reinterpret_cast<const uint4*>(src)[v % (kK / 8)];
        *reinterpret_cast<uint4*>(s_a + row * P::LDA + v * 8) = val;
      }
      __syncthreads();
      float acc[P::NT][4];  // this chunk's products, mma accumulators
      for (int nt = 0; nt < P::NT; ++nt)
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
      for (int k0 = 0; k0 < P::KA; k0 += 16) {
        uint32_t a[4];
        a[0] = ld32(a_lo + k0);
        a[1] = ld32(a_hi + k0);
        a[2] = ld32(a_lo + k0 + 8);
        a[3] = ld32(a_hi + k0 + 8);
        for (int nt = 0; nt < P::NT; ++nt) {
          const uint16_t* b = s_w + ((wn * P::NT + nt) * 8 + gid) * P::LDW +
                              k0 + tig * 2;
          mma_bf16(acc[nt], a, ld32(b), ld32(b + 8));
        }
      }
      for (int nt = 0; nt < P::NT; ++nt)
        for (int q = 0; q < 4; ++q) tot[nt][q] += acc[nt][q];
    }
  }

  // column sums: rows gid and gid + 8 of each lane, then over the 8 groups,
  // then over the warps along M
  __syncthreads();
  float* s_red = reinterpret_cast<float*>(smem);  // (MW, kN)
  for (int nt = 0; nt < P::NT; ++nt) {
    float s0 = tot[nt][0] + tot[nt][2], s1 = tot[nt][1] + tot[nt][3];
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (gid == 0) {
      const int col = (wn * P::NT + nt) * 8 + tig * 2;
      s_red[wm * kN + col] = s0;
      s_red[wm * kN + col + 1] = s1;
    }
  }
  __syncthreads();
  if (tid < kN) {
    float s = 0.f;
    for (int i = 0; i < P::MW; ++i) s += s_red[i * kN + tid];
    out[static_cast<size_t>(blockIdx.x) * kN + tid] = s;
  }
}

template <int V>
cudaError_t launch(const void* x, const void* x2, const void* w, void* out,
                   int cells, cudaStream_t stream) {
  const size_t smem = Plan<V>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_mm_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  probe_mm_kernel<V><<<cells, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(x2),
      static_cast<const uint16_t*>(w), static_cast<float*>(out));
  return cudaGetLastError();
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kPre2d: err = launch<kPre2d>(x, x2, w, out, cells, s); break;
    case kFlat: err = launch<kFlat>(x, x2, w, out, cells, s); break;
    case kTaps: err = launch<kTaps>(x, x2, w, out, cells, s); break;
    case kCat9: err = launch<kCat9>(x, x2, w9, out, cells, s); break;
    default: return -1;
  }
  return static_cast<int>(err);
}
