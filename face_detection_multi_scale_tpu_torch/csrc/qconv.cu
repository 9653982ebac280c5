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
// Design (the first kernel: simple and right; wgmma on s8, TMA and writing
// into a concat's channel slice are later work):
//   * groups == 1: an implicit GEMM, M = B*Ho*Wo output pixels, N = Cout,
//     K = kh*kw*Cin taken flat (a K index is (tap, channel)), so a ragged
//     Cin (3, 12, 56, 104, 216) wastes nothing but the last K tile's tail.
//     A block owns a 128 x 64 (pixels x channels) tile; its 4 warps, 2 x 2,
//     own 64 x 32 each, 16 int32 mma.sync.m16n8k32.s8.s8.s32 tiles a k-step,
//     accumulators in registers. K runs in tiles of 64 bytes staged in
//     shared memory, two stages: the next tile's copies (cp.async with a
//     zero fill for padding and the ragged edge; 16, 8 or 4 bytes a copy,
//     the widest that Cin and the pointers' alignment allow, else bytes
//     stored by the threads) are in flight while the tensor cores work on
//     the current one. Each staged row is padded to 80 bytes, so the
//     fragment loads of a warp (rows g, words t) hit 32 different banks.
//     A row table in shared memory holds each output pixel's image row and
//     top-left input corner. The epilogue converts, scales, activates and
//     rounds in registers and writes int8.
//   * groups > 1 (depthwise in the zoo): a direct path, one thread an output
//     value, the Cin/groups products summed in int32.
// The file is built with -fmad=false, and the epilogue uses the explicitly
// rounded intrinsics, so no multiply-add contracts into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                // output pixels a block
constexpr int kBN = 64;                 // output channels a block
constexpr int kBK = 64;                 // K bytes a staged tile
constexpr int kRow = kBK + 16;          // padded staged row, bytes
constexpr int kThreads = 128;           // 4 warps, 2 x 2
constexpr int kDirectThreads = 256;

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

template <int VEC>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.m + kBM - 1) / kBM, (p.cout + kBN - 1) / kBN);
  qconv_mma_kernel<VEC><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// y = requant(conv(x, w)) on `stream` of `device`; returns a CUDA error
// code, 0 when the launch was accepted. The caller checks shapes, types and
// contiguity, and that every tensor has fewer than 2^31 elements.
extern "C" int fdms_qconv(const void* x, const void* w, const void* alpha,
                          const void* bias, float inv_out, void* y, int b,
                          int h, int wd, int cin, int cout, int kh, int kw,
                          int stride, int ph, int pw, int groups, int act,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups < 1 || cin % groups || cout % groups || stride < 1 || act < 0 ||
      act > 3)
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups > 1) {
    const long long blocks = (m * cout + kDirectThreads - 1) / kDirectThreads;
    qconv_direct_kernel<<<static_cast<unsigned>(blocks), kDirectThreads, 0,
                          s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if ((cout + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the widest copy that Cin (so every K offset) and both pointers allow
  const auto fits = [&](int v) {
    return cin % v == 0 && aligned(x, v) && aligned(w, v);
  };
  if (fits(16)) return static_cast<int>(launch_mma<16>(p, s));
  if (fits(8)) return static_cast<int>(launch_mma<8>(p, s));
  if (fits(4)) return static_cast<int>(launch_mma<4>(p, s));
  return static_cast<int>(launch_mma<1>(p, s));
}
