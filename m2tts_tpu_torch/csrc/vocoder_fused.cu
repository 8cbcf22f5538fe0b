// Fused HiFi-GAN-lite vocoder for Hopper (sm_90a) in f32: one launch per
// upsample stage, with the input conv fused into the first stage and the
// output conv + tanh into the last.
//
// Replaces, for compute_dtype='f32', the TPU kernels
// m2tts_tpu/ops/pallas/vocoder_packed.py (fused_vocoder_packed_forward) and
// m2tts_tpu/ops/pallas/vocoder.py (fused_vocoder_forward). Both compute one
// function and differ only in how they lay it onto the TPU's 128 lanes;
// Hopper has no lane axis to fill, so this one kernel serves both
// contracts. The bf16 path runs on tensor cores (vocoder_tc.cu); f32 stays
// here because neither bf16 nor TF32 tensor cores meet the f32 tolerance.
//
// Per stage (input rate T_in, rate r, C_in -> C_out channels), each block
// owns q_tile input frames of one utterance, i.e. N = q_tile*r output
// frames, and keeps in shared memory:
//   x   input frames with a halo (2 a side; 3 for the last stage); for
//       the first stage computed from the mel window by
//       the input conv,
//   y   = leaky(tconv(x)) on the N output frames plus e = 2 (last: 3) a side,
//   h   = leaky(conv1(y)) on N plus e-1 a side,
//   xo  = y + conv2(h) on N plus 1 a side (last stage only; it feeds the
//       output conv).
// Other stages write y + conv2(h) to device memory.
// Values at positions outside [0, T_stage) are zero at every stage's own
// rate, which is exactly the SAME padding of the unfused vocoder.
//
// Arithmetic: f32 FMA loops throughout, as vocoder_mm_forward (its plain
// PyTorch version) computes under compute_dtype='f32'.
//
// Shared-memory buffers are channel-major ([channel][row]), so a thread
// reads the RT+2 consecutive rows its RT x CT output tile needs once per
// input channel and uses them for all three taps of the k=3 conv; weights
// come from global memory (L1/L2) as CT-wide vectors.
//
// The transposed conv is the sub-pixel matmul on the packed [3*C_in,
// r*C_out] matrix; for phase j < r/2 its x_{q+1} tap block is zero and for
// j >= r/2 its x_{q-1} block is (pack_tconv builds it so), and both are
// skipped.
//
// Bound: at the flagship widths the vocoder does ~11.9 MFLOP per mel frame
// against ~74 KB of f32 intermediates per frame between stages, so it is
// bound by operations; without tensor cores, by the f32 FMA rate. Weights
// (4.8 MB in f32) are read from global memory and live in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRT = 8;                  // largest row tile of a pass
constexpr size_t kSmemBudget = 112 * 1024; // two blocks per SM

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

// Load CT consecutive weights, aligned to CT elements.
template <int CT>
__device__ __forceinline__ void load_w(const float* __restrict__ p, float (&w)[CT]) {
  if constexpr (CT == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < CT; ++c) w[c] = __ldg(p + c);
  }
}

// Store CT consecutive values to global memory, aligned to CT elements.
template <int CT>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (CT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < CT; ++c) p[c] = v[c];
  }
}

template <int RT, int CT, int OFF>
__device__ __forceinline__ void fma_tile(float (&acc)[RT][CT], const float (&xv)[RT + 2],
                                         const float (&w)[CT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(xv[i + OFF], w[c], acc[i][c]);
}

__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int round_up(int a, int b) { return (a + b - 1) / b * b; }

// One k=3 matmul pass over a channel-major shared-memory buffer, tiled RT
// rows x CT columns per thread. Output row o of phase j reads input rows
// o + d + 1 (d = -1, 0, 1), weight rows (d+1)*cin + k, columns
// j*ncols + c. The input buffer must hold round_up(n_out, RT) + 2 rows:
// rows past the tile's end are computed and dropped. store(j, o, c0, v)
// writes the CT finished values of one row.
template <int RT, int CT, typename Store>
__device__ __forceinline__ void conv_pass(int n_out, int n_phase, int ncols, const float* in,
                                          int ld_in, const float* __restrict__ W, int ldw,
                                          const float* __restrict__ bias, int cin,
                                          bool tconv, int r, Store store) {
  const int nrb = (n_out + RT - 1) / RT;
  const int ncb = ncols / CT;
  const int ntask = n_phase * nrb * ncb;
  const size_t tap = (size_t)cin * ldw;
  for (int t = threadIdx.x; t < ntask; t += blockDim.x) {
    const int cb = t % ncb;
    const int rest = t / ncb;
    const int rb = rest % nrb;
    const int j = rest / nrb;
    const int c0 = cb * CT;
    const int o0 = rb * RT;
    float acc[RT][CT];
    {
      float bv[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) bv[c] = __ldg(bias + c0 + c);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[i][c] = bv[c];
    }
    const bool lo = !tconv || j < r / 2;   // tap d = -1 is live
    const bool hi = !tconv || j >= r / 2;  // tap d = +1 is live
    const float* xk = in + o0;
    const float* wk = W + (size_t)j * ncols + c0;
#pragma unroll 2
    for (int k = 0; k < cin; ++k, xk += ld_in, wk += ldw) {
      float xv[RT + 2];
#pragma unroll
      for (int q = 0; q < RT + 2; ++q) xv[q] = xk[q];
      float w[CT];
      if (lo) {
        load_w<CT>(wk, w);
        fma_tile<RT, CT, 0>(acc, xv, w);
      }
      load_w<CT>(wk + tap, w);
      fma_tile<RT, CT, 1>(acc, xv, w);
      if (hi) {
        load_w<CT>(wk + 2 * tap, w);
        fma_tile<RT, CT, 2>(acc, xv, w);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
      if (o0 + i < n_out) store(j, o0 + i, c0, acc[i]);
  }
}

template <int RT, typename Store>
__device__ __forceinline__ void conv_ct(int n_out, int n_phase, int ncols, const float* in,
                                        int ld_in, const float* __restrict__ W, int ldw,
                                        const float* __restrict__ bias, int cin, bool tconv,
                                        int r, Store store) {
  // 4-column tiles: measured faster than 8 on the H100 (8 x 8 tiles spill
  // at the two-blocks-per-SM register budget)
  if (ncols % 4 == 0)
    conv_pass<RT, 4>(n_out, n_phase, ncols, in, ld_in, W, ldw, bias, cin, tconv, r, store);
  else
    conv_pass<RT, 1>(n_out, n_phase, ncols, in, ld_in, W, ldw, bias, cin, tconv, r, store);
}

template <typename Store>
__device__ __forceinline__ void conv_any(int n_out, int n_phase, int ncols, const float* in,
                                         int ld_in, const float* __restrict__ W, int ldw,
                                         const float* __restrict__ bias, int cin, bool tconv,
                                         int r, Store store) {
  // short passes take 4-row tiles, so fewer computed rows are dropped
  if (n_out >= 24)
    conv_ct<8>(n_out, n_phase, ncols, in, ld_in, W, ldw, bias, cin, tconv, r, store);
  else
    conv_ct<4>(n_out, n_phase, ncols, in, ld_in, W, ldw, bias, cin, tconv, r, store);
}

struct StageParams {
  const void* x;   // first stage: mel [B, T_in, c_mel] f32; else [B, T_in, c_in] T
  void* out;       // last stage: audio [B, T_in*r] f32; else [B, T_in*r, c_out] T
  const void* w_in; const float* b_in;   // input conv [3*c_mel, c_in] (first)
  const void* w_t;  const float* b_t;    // tconv [3*c_in, r*c_out], bias [c_out]
  const void* w_r1; const float* b_r1;   // resblock conv1 [3*c_out, c_out]
  const void* w_r2; const float* b_r2;   // resblock conv2 [3*c_out, c_out]
  const void* w_o;  const float* b_o;    // output conv [3*c_out, 1] (last)
  int T_in, c_mel, c_in, c_out, r, q_tile, first, last;
};

// Buffer geometry of one block; identical for every block of a launch.
// Each buffer is [channels][ld] with ld >= its rows, chosen so that
// neighbouring channels fall on different shared-memory banks.
struct Geometry {
  int e, nqy, nx, ny, nh;
  int ldx, ldy, ldh, ldo, ldm;
  size_t off_y, off_h, off_xo, off_m, bytes;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

__host__ __device__ inline int lead_dim(int rows) { return rows | 1; }  // odd word stride

__host__ __device__ inline Geometry geometry(const StageParams& p) {
  Geometry g;
  const int N = p.q_tile * p.r;
  g.e = 2 + p.last;
  g.nqy = p.q_tile + floordiv(g.e - 1, p.r) + (g.e + p.r - 1) / p.r + 1;
  g.nx = g.nqy + 2;
  g.ny = N + 2 * g.e;
  g.nh = N + 2 * g.e - 2;
  const int n_o = p.last ? N + 2 : N;
  // rows each buffer must hold: its values, or the padded tile reads of the
  // pass that consumes it
  g.ldx = lead_dim(max(g.nx, round_up(g.nqy, kMaxRT) + 2));
  g.ldy = lead_dim(max(g.ny, round_up(g.nh, kMaxRT) + 2));
  g.ldh = lead_dim(max(g.nh, round_up(n_o, kMaxRT) + 2));
  g.ldo = p.last ? lead_dim(N + 2) : 0;
  g.ldm = p.first ? lead_dim(max(g.nx + 2, round_up(g.nx, kMaxRT) + 2)) : 0;
  size_t off = align16((size_t)p.c_in * g.ldx * 4);
  g.off_y = off;  off += align16((size_t)p.c_out * g.ldy * 4);
  g.off_h = off;  off += align16((size_t)p.c_out * g.ldh * 4);
  g.off_xo = off; off += align16((size_t)(p.last ? p.c_out : 0) * g.ldo * 4);
  g.off_m = off;  off += align16((size_t)(p.first ? p.c_mel : 0) * g.ldm * 4);
  g.bytes = off;
  return g;
}

__global__ void __launch_bounds__(kThreads, 2) vocoder_stage_kernel(StageParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g = geometry(p);
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = reinterpret_cast<float*>(smem + g.off_y);
  float* sh = reinterpret_cast<float*>(smem + g.off_h);
  float* sxo = reinterpret_cast<float*>(smem + g.off_xo);
  float* sm = reinterpret_cast<float*>(smem + g.off_m);

  const int b = blockIdx.y;
  const int r = p.r, cin = p.c_in, cout = p.c_out;
  const int q0 = blockIdx.x * p.q_tile;
  const int nq = min(p.q_tile, p.T_in - q0);
  const int T_in = p.T_in;
  const int T_out = T_in * r;
  const int p0 = q0 * r;
  const int N = nq * r;
  const int e = g.e;
  const int qy_lo = floordiv(p0 - e, r);
  const int nqy = floordiv(p0 + N + e - 1, r) - qy_lo + 1;
  const int xlo = qy_lo - 1;
  const int nx = nqy + 2;
  const int ny = N + 2 * e;
  const int nh = N + 2 * e - 2;
  const int y0 = p0 - e;      // position of sy row 0
  const int h0 = p0 - e + 1;  // position of sh row 0

  // ---- x window (positions xlo .. xlo+nx-1), zero outside [0, T_in)
  if (p.first) {
    const float* mel = static_cast<const float*>(p.x) + (size_t)b * T_in * p.c_mel;
    const int nm = nx + 2;  // mel positions xlo-1 ..
    for (int idx = threadIdx.x; idx < nm * p.c_mel; idx += blockDim.x) {
      const int row = idx / p.c_mel, c = idx - row * p.c_mel;
      const int pos = xlo - 1 + row;
      const float v = (pos >= 0 && pos < T_in) ? mel[(size_t)pos * p.c_mel + c] : 0.f;
      sm[c * g.ldm + row] = v;
    }
    __syncthreads();
    conv_any(nx, 1, cin, sm, g.ldm, static_cast<const float*>(p.w_in), cin, p.b_in,
                p.c_mel, false, r, [&](int, int o, int c0, const auto& v) {
                  const int pos = xlo + o;
                  const bool in = pos >= 0 && pos < T_in;
#pragma unroll
                  for (int c = 0; c < (int)(sizeof(v) / sizeof(float)); ++c)
                    sx[(c0 + c) * g.ldx + o] = in ? v[c] : 0.f;
                });
  } else {
    const float* x = static_cast<const float*>(p.x) + (size_t)b * T_in * cin;
    for (int idx = threadIdx.x; idx < nx * cin; idx += blockDim.x) {
      const int row = idx / cin, c = idx - row * cin;
      const int pos = xlo + row;
      sx[c * g.ldx + row] =
          (pos >= 0 && pos < T_in) ? x[(size_t)pos * cin + c] : 0.f;
    }
  }
  __syncthreads();

  // ---- y = leaky(tconv(x)), as r phases of input-rate rows
  conv_any(nqy, r, cout, sx, g.ldx, static_cast<const float*>(p.w_t), r * cout, p.b_t,
              cin, true, r, [&](int j, int o, int c0, const auto& v) {
                const int pos = (qy_lo + o) * r + j;
                const int iy = pos - y0;
                if (iy >= 0 && iy < ny) {
                  const bool in = pos >= 0 && pos < T_out;
#pragma unroll
                  for (int c = 0; c < (int)(sizeof(v) / sizeof(float)); ++c)
                    sy[(c0 + c) * g.ldy + iy] = in ? leaky(v[c]) : 0.f;
                }
              });
  __syncthreads();

  // ---- h = leaky(conv1(y))
  conv_any(nh, 1, cout, sy, g.ldy, static_cast<const float*>(p.w_r1), cout, p.b_r1, cout,
              false, r, [&](int, int o, int c0, const auto& v) {
                const int pos = h0 + o;
                const bool in = pos >= 0 && pos < T_out;
#pragma unroll
                for (int c = 0; c < (int)(sizeof(v) / sizeof(float)); ++c)
                  sh[(c0 + c) * g.ldh + o] = in ? leaky(v[c]) : 0.f;
              });
  __syncthreads();

  // ---- x' = y + conv2(h), residual add in f32
  const int o_start = p.last ? p0 - 1 : p0;
  const int n_o = p.last ? N + 2 : N;
  float* out = static_cast<float*>(p.out);
  conv_any(n_o, 1, cout, sh, g.ldh, static_cast<const float*>(p.w_r2), cout, p.b_r2, cout,
              false, r, [&](int, int o, int c0, const auto& v) {
                constexpr int CT = sizeof(v) / sizeof(float);
                const int pos = o_start + o;
                float xv[CT];
#pragma unroll
                for (int c = 0; c < CT; ++c) xv[c] = sy[(c0 + c) * g.ldy + pos - y0] + v[c];
                if (p.last) {
                  const bool in = pos >= 0 && pos < T_out;
#pragma unroll
                  for (int c = 0; c < CT; ++c) sxo[(c0 + c) * g.ldo + o] = in ? xv[c] : 0.f;
                } else {
                  store_vec<CT>(out + ((size_t)b * T_out + pos) * cout + c0, xv);
                }
              });

  if (p.last) {
    __syncthreads();
    // ---- audio = tanh(output_conv(x')), one sample per thread
    const float* wo = static_cast<const float*>(p.w_o);
    float* audio = static_cast<float*>(p.out) + (size_t)b * T_out;
    const float bo = __ldg(p.b_o);
    for (int o = threadIdx.x; o < N; o += blockDim.x) {
      float acc = bo;
      for (int k = 0; k < cout; ++k) {
        const float* xr = sxo + (size_t)k * g.ldo + o;
#pragma unroll
        for (int d = 0; d < 3; ++d) acc = fmaf(xr[d], wo[d * cout + k], acc);
      }
      audio[p0 + o] = tanhf(acc);
    }
  }
}

// Largest power-of-two tile with at most 256 output frames whose buffers
// fit the shared-memory budget (at least 1).
int pick_q_tile(StageParams p) {
  int q = 1;
  while (q * 2 * p.r <= 256) {
    p.q_tile = q * 2;
    if (geometry(p).bytes > kSmemBudget) break;
    q *= 2;
  }
  return q;
}

int launch_stage(StageParams p, int B, cudaStream_t stream) {
  p.q_tile = pick_q_tile(p);
  const Geometry g = geometry(p);
  if (g.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vocoder_stage_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)g.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T_in + p.q_tile - 1) / p.q_tile, B);
  vocoder_stage_kernel<<<grid, kThreads, g.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One vocoder stage in f32. Pointers are device pointers. Returns a
// cudaError_t.
int m2tts_vocoder_stage(const void* x, void* out, const void* w_in, const float* b_in,
                        const void* w_t, const float* b_t, const void* w_r1,
                        const float* b_r1, const void* w_r2, const float* b_r2,
                        const void* w_o, const float* b_o, int B, int T_in, int c_mel,
                        int c_in, int c_out, int r, int first, int last, void* stream) {
  if (B < 1 || T_in < 1 || c_in < 1 || c_out < 1 || r < 2 || r % 2 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (first && c_mel < 1) return (int)cudaErrorInvalidValue;
  if ((long long)T_in * r > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  StageParams p{x, out, w_in, b_in, w_t, b_t, w_r1, b_r1, w_r2, b_r2, w_o, b_o,
                T_in, c_mel, c_in, c_out, r, 1, first, last};
  return launch_stage(p, B, static_cast<cudaStream_t>(stream));
}

// Tile (input frames per block) and shared-memory bytes the stage launch
// uses, for the wrapper's docs and the smoke script's report.
int m2tts_vocoder_stage_plan(int T_in, int c_mel, int c_in, int c_out, int r, int first,
                             int last, int* q_tile, long long* smem_bytes) {
  StageParams p{};
  p.T_in = T_in; p.c_mel = c_mel; p.c_in = c_in; p.c_out = c_out; p.r = r;
  p.first = first; p.last = last;
  p.q_tile = pick_q_tile(p);
  *q_tile = p.q_tile;
  *smem_bytes = (long long)geometry(p).bytes;
  return 0;
}

}  // extern "C"
