// One fused E-ELAN group per launch, for sm_90a.
//
// Replaces face_detection_multi_scale_tpu/ops/pallas_elan.py::_elan_kernel
// (wrapper fused_elan). The group, each conv followed by act(acc + bias):
//   x  = 3x3 stride-s conv of the input (optional absorbed "pre" conv)
//   a  = 1x1(x),  b = 1x1(x)
//   y1 = 3x3(b),  yk = 3x3(y_{k-1}) for k = 2..n_chain
//   out = 1x1(concat(members)),  members a subset of {a, b, y1..yn}
// with SAME zero padding of every 3x3 (pad 1). Activations are NCHW f32,
// weights OIHW f32 (torch's layouts), biases (C,). act: silu, leaky 0.1 or
// relu. Full f32 products and sums (no TF32, no tensor cores).
//
// What bounds it on the card: operations. The group's arithmetic (about
// 56 GFLOP per 640x640 w6 image) over f32's 67 TFLOP/s is several times
// its bytes (x, weights, out once) over 3.35 TB/s. The TPU kernel's point
// was to keep every intermediate out of device memory; this design does
// the same per output tile:
//   * whole groups are computed for TH x TW output tiles (a persistent
//     loop over (image, tile)); every intermediate is recomputed on the
//     tile's halo (n_chain pixels for b, shrinking by one per chain conv),
//     so no tile needs another's data and one launch does the group; only
//     the halo's points inside the image are computed, and an image of at
//     most 20 x 20 is one tile (no recompute);
//   * the intermediates of a tile live in a workspace: the block's dynamic
//     shared memory when they fit (227 KB), else a private slice of a
//     scratch buffer in device memory (the wrapper allocates it; the
//     executor never sees it) shared by a cluster of up to 8 blocks that
//     split each conv's (position, channel) steps between them and meet at
//     a cluster barrier after each conv, so groups with few tiles (the
//     deep, narrow-spatial ones) still spread over the SMs;
//   * SAME padding: every intermediate is stored as zero outside the image
//     (TPU: mask_zero after every conv), and every read of the input or of
//     an intermediate outside the image returns zero, so tiles at the four
//     borders and ragged last tiles come out as the unfused convs do;
//   * each conv is an implicit GEMM over K = (input channel, ky, kx) in
//     OIHW order: a block step covers 128 positions x 64 output channels;
//     the block gathers 16 K rows of the input window and of the weights
//     into shared memory (12 KB, beside the workspace), then each thread
//     accumulates 4 positions x 8 channels (32 f32 accumulators, one fmaf
//     per K row in K order, the order of the plain convolution's sums).
// Making it fast (tensor-core f32 emulation or bf16, double-buffered
// cp.async/TMA staging, warp specialisation) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMP = 4;                 // positions per thread
constexpr int kMC = 8;                 // output channels per thread
constexpr int kTileP = 32 * kMP;       // positions per block step
constexpr int kTileC = kWarps * kMC;   // channels per block step
constexpr int kMaxChain = 8;
constexpr int kMaxMembers = kMaxChain + 2;

enum Act { kSilu = 0, kLeaky = 1, kRelu = 2 };

struct Params {
  const float* x;    // (B, cin, H, W) or, with pre, (B, pre_cin, sH, sW)
  float* out;        // (B, cout, H, W)
  float* ws;         // global workspace, ws_stride floats per cluster
  const float *wp, *bp, *wa, *ba, *wb, *bb, *wt, *bt;
  const float* wc[kMaxChain];
  const float* bc[kMaxChain];
  long long ws_stride;
  // float offsets of a team's workspace regions, laid out by the wrapper
  // (ops/elan_kernel.py::workspace_layout): x (pre only), b, a (if a
  // member), y1..yn, each holding its window
  long long off_x, off_b, off_a, off_y[kMaxChain];
  int batch, h, w, cin, ccv, cch, cout, n_chain, pre_cin, pre_stride, act;
  int n_members, tile_h, tile_w, use_smem, cluster;
  int members[kMaxMembers];  // -2 = a, -1 = b, k >= 0 = y_{k+1}
};

// A conv's input: `p` holds channel planes of a (rows x ld) window whose
// element (0, 0) is domain point (oy, ox); the domain is dh x dw. `w` points
// at the OIHW weights of this input's channels, `w_co` floats apart from one
// output channel to the next. An image source (`bounded`) is read only
// inside its domain, zero outside; a workspace window always covers every
// tap its consumer reads and holds zeros outside the domain already, so it
// is read without bounds checks.
struct Src {
  const float* p;
  long long plane;
  int oy, ox, ld, dh, dw, cin;
  const float* w;
  long long w_co;
  bool bounded;
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kSilu) return v / (1.0f + expf(-v));
  if (act == kLeaky) return v > 0.0f ? v : v * 0.1f;
  return v > 0.0f ? v : 0.0f;
}

// Shared-memory staging of one K chunk of the implicit GEMM: kKC rows of
// the gathered input (one per (input channel, tap), kTileP positions) and
// of the weights (kTileC output channels).
constexpr int kKC = 16;
struct Stage {
  float a[kKC][kTileP];
  float b[kKC][kTileC];
};
__shared__ __align__(16) Stage g_st;

// acc[i][j] += sum over k of in(k, position i) * w(channel j, k), k running
// over the source's (input channel, ky, kx) in OIHW order, one k at a time
// (the order of the plain convolution's sums). The block gathers kKC rows of
// the input window and of the weights into shared memory, then each thread
// runs its 4 positions x 8 channels from there.
//   lp, ly, lx, lok: the position this thread gathers (its output point,
//     whether it is a real one);
//   co0: the first of the 8 channels of this thread's warp, c_out channels.
template <int K, bool kBounded>
__device__ __forceinline__ void accumulate(const Src& s, int ly,
                                           int lx, bool lok, int co0,
                                           int c_out, int ct0,
                                           float (&acc)[kMP][kMC]) {
  constexpr int KK = K * K;
  const int n_k = s.cin * KK;
  const int lane = threadIdx.x & 31;
  const int lp = threadIdx.x % kTileP;           // gather: position
  const int lk = threadIdx.x / kTileP;           // gather: first k row
  const int wc = threadIdx.x / (kThreads / kTileC);  // weights: channel
  const int wk = (threadIdx.x % (kThreads / kTileC)) * (kKC * kTileC / kThreads);
  const long long base =
      lok ? static_cast<long long>(ly - s.oy) * s.ld + (lx - s.ox) : 0;
  const float* wrow = s.w + (ct0 + wc) * s.w_co;
  const bool wok = ct0 + wc < c_out;
  for (int k0 = 0; k0 < n_k; k0 += kKC) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int r = lk; r < kKC; r += kThreads / kTileP) {
      const int k = k0 + r;
      float v = 0.0f;
      if (k < n_k && lok) {
        const int ci = k / KK, tap = k % KK;
        const int ky = tap / K, kx = tap % K;
        if (kBounded) {
          const int y = ly + ky, x = lx + kx;
          if (y >= 0 && y < s.dh && x >= 0 && x < s.dw)
            v = s.p[ci * s.plane + static_cast<long long>(y - s.oy) * s.ld +
                    (x - s.ox)];
        } else {
          v = s.p[ci * s.plane + base + ky * s.ld + kx];
        }
      }
      g_st.a[r][lp] = v;
    }
#pragma unroll
    for (int r = 0; r < kKC * kTileC / kThreads; ++r) {
      const int k = k0 + wk + r;
      g_st.b[wk + r][wc] = (wok && k < n_k) ? __ldg(wrow + k) : 0.0f;
    }
    __syncthreads();
    const int n = min(kKC, n_k - k0);
    for (int r = 0; r < n; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&g_st.a[r][lane * kMP]);
      const float4 b0 = *reinterpret_cast<const float4*>(&g_st.b[r][co0]);
      const float4 b1 = *reinterpret_cast<const float4*>(&g_st.b[r][co0 + 4]);
      const float av[kMP] = {a.x, a.y, a.z, a.w};
      const float bv[kMC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kMP; ++i)
#pragma unroll
        for (int j = 0; j < kMC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// One conv stage over the output window (oy, ox, oh x ow) of a domain
// dh x dw with `c_out` channels: sum over `srcs`, + bias, act. Only the
// window's points inside the domain are computed. With `dst_ld` > 0 the
// window is stored whole into `dst` (channel planes of oh x ow), zero at
// its points outside the domain (the SAME padding its 3x3 consumer reads);
// with dst_ld == 0 the points are stored into the NCHW image `dst` (planes
// dh x dw). The (position, channel) steps are dealt out over the `n_ranks`
// blocks of the cluster; every thread of the block takes part.
__device__ void conv_stage(const Src* srcs, int n_src, int k, int stride,
                           const float* bias, int act, int oy, int ox, int oh,
                           int ow, int dh, int dw, int c_out, float* dst,
                           int dst_ld, int rank, int n_ranks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int y0 = max(oy, 0), y1 = min(oy + oh, dh);
  const int x0 = max(ox, 0), x1 = min(ox + ow, dw);
  const int in_w = max(x1 - x0, 0);
  const int n_pos = max(y1 - y0, 0) * in_w;
  if (dst_ld > 0 && n_pos < oh * ow) {
    // the window's points outside the domain
    const long long n = static_cast<long long>(c_out) * oh * ow;
    for (long long e = rank * kThreads + threadIdx.x; e < n;
         e += static_cast<long long>(n_ranks) * kThreads) {
      const int pt = static_cast<int>(e % (oh * ow));
      const int gy = oy + pt / ow, gx = ox + pt % ow;
      if (gy < 0 || gy >= dh || gx < 0 || gx >= dw) dst[e] = 0.0f;
    }
  }
  const int n_pt = (n_pos + kTileP - 1) / kTileP;
  const int n_ct = (c_out + kTileC - 1) / kTileC;
  const int pad = k / 2;
  for (int t = rank; t < n_pt * n_ct; t += n_ranks) {
    const int pt = t / n_ct, ct = t % n_ct;
    // the point this thread gathers, and the tap (0, 0) input point of it
    const int lpos = pt * kTileP + threadIdx.x % kTileP;
    const bool lok = lpos < n_pos;
    const int ly = (y0 + (lok ? lpos / in_w : 0)) * stride - pad;
    const int lx = (x0 + (lok ? lpos % in_w : 0)) * stride - pad;
    const int ct0 = ct * kTileC, co0 = warp * kMC;
    float acc[kMP][kMC];
#pragma unroll
    for (int i = 0; i < kMP; ++i)
#pragma unroll
      for (int j = 0; j < kMC; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < n_src; ++s) {
      const bool b = srcs[s].bounded;
      if (k == 1 && b)
        accumulate<1, true>(srcs[s], ly, lx, lok, co0, c_out, ct0, acc);
      else if (k == 1)
        accumulate<1, false>(srcs[s], ly, lx, lok, co0, c_out, ct0, acc);
      else if (b)
        accumulate<3, true>(srcs[s], ly, lx, lok, co0, c_out, ct0, acc);
      else
        accumulate<3, false>(srcs[s], ly, lx, lok, co0, c_out, ct0, acc);
    }
#pragma unroll
    for (int i = 0; i < kMP; ++i) {
      const int pos = pt * kTileP + lane * kMP + i;
      if (pos >= n_pos) continue;
      const int gy = y0 + pos / in_w, gx = x0 + pos % in_w;
#pragma unroll
      for (int j = 0; j < kMC; ++j) {
        const int co = ct0 + co0 + j;
        if (co >= c_out) continue;
        const float v = activate(acc[i][j] + bias[co], act);
        if (dst_ld > 0)
          dst[static_cast<long long>(co) * oh * ow +
              static_cast<long long>(gy - oy) * dst_ld + (gx - ox)] = v;
        else
          dst[static_cast<long long>(co) * dh * dw +
              static_cast<long long>(gy) * dw + gx] = v;
      }
    }
  }
}

__device__ __forceinline__ Src window(const float* p, int oy, int ox, int rows,
                                      int cols, int dh, int dw, int cin,
                                      const float* w, long long w_co) {
  Src s;
  s.p = p;
  s.plane = static_cast<long long>(rows) * cols;
  s.oy = oy;
  s.ox = ox;
  s.ld = cols;
  s.dh = dh;
  s.dw = dw;
  s.cin = cin;
  s.w = w;
  s.w_co = w_co;
  s.bounded = false;
  return s;
}

// Every block of the cluster at this point, and their workspace writes
// visible to each other (release/acquire at cluster scope).
__device__ __forceinline__ void sync_cluster(int n_ranks) {
  if (n_ranks > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fused_elan_kernel(const Params P) {
  extern __shared__ __align__(16) float smem[];
  // a cluster of `n_ranks` blocks shares each tile and its workspace
  const int n_ranks = P.cluster;
  const int rank = static_cast<int>(blockIdx.x) % n_ranks;
  const long long team = blockIdx.x / n_ranks, n_teams = gridDim.x / n_ranks;
  float* ws = P.use_smem ? smem : P.ws + team * P.ws_stride;
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
  float* xbuf = ws + P.off_x;
  float* bbuf = ws + P.off_b;
  float* abuf = ws + P.off_a;
  float* ybuf[kMaxChain];
  for (int kk = 0; kk < P.n_chain; ++kk) ybuf[kk] = ws + P.off_y[kk];

  for (long long tile = team; tile < n_tiles; tile += n_teams) {
    const int n = static_cast<int>(tile / per_img);
    const int rem = static_cast<int>(tile % per_img);
    const int ty = (rem / tiles_x) * TH, tx = (rem % tiles_x) * TW;
    sync_cluster(n_ranks);  // the previous tile's readers are done

    // the group input x over the b window (halo p)
    Src src[kMaxMembers];
    Src xs;
    if (has_pre) {
      const int s = P.pre_stride;
      const float* img = P.x + static_cast<long long>(n) * P.pre_cin *
                                   (static_cast<long long>(H) * s) * (W * s);
      src[0] = window(img, 0, 0, H * s, W * s, H * s, W * s, P.pre_cin, P.wp,
                      static_cast<long long>(P.pre_cin) * 9);
      src[0].bounded = true;
      conv_stage(src, 1, 3, s, P.bp, P.act, ty - p, tx - p, EH, EW, H, W,
                 P.cin, xbuf, EW, rank, n_ranks);
      sync_cluster(n_ranks);
      xs = window(xbuf, ty - p, tx - p, EH, EW, H, W, P.cin, nullptr, P.cin);
    } else {
      const float* img =
          P.x + static_cast<long long>(n) * P.cin * static_cast<long long>(H) * W;
      xs = window(img, 0, 0, H, W, H, W, P.cin, nullptr, P.cin);
      xs.bounded = true;
    }

    // the two 1x1 branches
    src[0] = xs;
    src[0].w = P.wb;
    conv_stage(src, 1, 1, 1, P.bb, P.act, ty - p, tx - p, EH, EW, H, W, P.ccv,
               bbuf, EW, rank, n_ranks);
    if (has_a) {
      src[0].w = P.wa;
      conv_stage(src, 1, 1, 1, P.ba, P.act, ty, tx, TH, TW, H, W, P.ccv, abuf,
                 TW, rank, n_ranks);
    }
    sync_cluster(n_ranks);

    // the 3x3 chain, the window shrinking by one pixel a side per conv
    for (int kk = 0; kk < P.n_chain; ++kk) {
      const int o_in = p - kk, o = o_in - 1;
      const int c_in = kk == 0 ? P.ccv : P.cch;
      src[0] = window(kk == 0 ? bbuf : ybuf[kk - 1], ty - o_in, tx - o_in,
                      TH + 2 * o_in, TW + 2 * o_in, H, W, c_in, P.wc[kk],
                      static_cast<long long>(c_in) * 9);
      conv_stage(src, 1, 3, 1, P.bc[kk], P.act, ty - o, tx - o, TH + 2 * o,
                 TW + 2 * o, H, W, P.cch, ybuf[kk], TW + 2 * o, rank, n_ranks);
      sync_cluster(n_ranks);
    }

    // the transition over the members, in order; rows of wt follow them
    long long off = 0;
    for (int m = 0; m < P.n_members; ++m) {
      const int id = P.members[m];
      if (id == -2) {
        src[m] = window(abuf, ty, tx, TH, TW, H, W, P.ccv, P.wt + off, 0);
        off += P.ccv;
      } else if (id == -1) {
        src[m] = window(bbuf, ty - p, tx - p, EH, EW, H, W, P.ccv, P.wt + off,
                        0);
        off += P.ccv;
      } else {
        const int o = p - id - 1;
        src[m] = window(ybuf[id], ty - o, tx - o, TH + 2 * o, TW + 2 * o, H, W,
                        P.cch, P.wt + off, 0);
        off += P.cch;
      }
    }
    for (int m = 0; m < P.n_members; ++m) src[m].w_co = off;
    float* out = P.out + static_cast<long long>(n) * P.cout *
                             static_cast<long long>(H) * W;
    conv_stage(src, P.n_members, 1, 1, P.bt, P.act, ty, tx, TH, TW, H, W,
               P.cout, out, 0, rank, n_ranks);
  }
}

}  // namespace

// Launches one group on `stream` of `device`; returns cudaGetLastError()
// (0 on success). ptrs: x, out, workspace (may be null with use_smem), wp,
// bp (null without pre), wa, ba, wb, bb, wt, bt, then n_chain pairs
// (w_k, b_k). ints: batch, h, w, cin, ccv, cch, cout, n_chain, pre_cin,
// pre_stride, act, tile_h, tile_w, use_smem, grid, smem_bytes, ws_stride,
// cluster, n_members, then the n_members member ids (-2 = a, -1 = b,
// k = y_{k+1}), then the workspace offsets: x, b, a, y1..y_{n_chain}.
// grid is a multiple of cluster (at most 8, the portable cluster size).
extern "C" int fdms_fused_elan(void* const* ptrs, const long long* ints,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params P;
  P.x = static_cast<const float*>(ptrs[0]);
  P.out = static_cast<float*>(ptrs[1]);
  P.ws = static_cast<float*>(ptrs[2]);
  P.wp = static_cast<const float*>(ptrs[3]);
  P.bp = static_cast<const float*>(ptrs[4]);
  P.wa = static_cast<const float*>(ptrs[5]);
  P.ba = static_cast<const float*>(ptrs[6]);
  P.wb = static_cast<const float*>(ptrs[7]);
  P.bb = static_cast<const float*>(ptrs[8]);
  P.wt = static_cast<const float*>(ptrs[9]);
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
  P.use_smem = static_cast<int>(ints[13]);
  const int grid = static_cast<int>(ints[14]);
  const size_t smem = static_cast<size_t>(ints[15]);
  P.ws_stride = ints[16];
  P.cluster = static_cast<int>(ints[17]);
  P.n_members = static_cast<int>(ints[18]);
  if (P.n_chain < 1 || P.n_chain > kMaxChain || P.n_members < 1 ||
      P.n_members > kMaxMembers || P.cluster < 1 || P.cluster > 8 ||
      grid % P.cluster != 0 || (P.use_smem && P.cluster != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int kk = 0; kk < P.n_chain; ++kk) {
    P.wc[kk] = static_cast<const float*>(ptrs[11 + 2 * kk]);
    P.bc[kk] = static_cast<const float*>(ptrs[12 + 2 * kk]);
  }
  for (int m = 0; m < P.n_members; ++m)
    P.members[m] = static_cast<int>(ints[19 + m]);
  const long long* off = ints + 19 + P.n_members;
  P.off_x = off[0];
  P.off_b = off[1];
  P.off_a = off[2];
  for (int kk = 0; kk < P.n_chain; ++kk) P.off_y[kk] = off[3 + kk];
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_elan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_elan_kernel, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
