// Fused HiFi-GAN-lite vocoder stage on Hopper tensor cores (sm_90a), bf16
// matmul inputs with f32 accumulation: one launch per upsample stage, the
// input conv fused into the first stage and the output conv + tanh into the
// last.
//
// Replaces, for compute_dtype='bf16', the TPU kernels
// m2tts_tpu/ops/pallas/vocoder_packed.py (fused_vocoder_packed_forward) and
// m2tts_tpu/ops/pallas/vocoder.py (fused_vocoder_forward). The f32 path is
// the 3xTF32 kernel of vocoder_tc32.cu; both include tc_common.cuh.
//
// Per stage (input rate T_in, rate r, C_in -> C_out channels), a block owns
// q_tile input frames of one utterance, N = q_tile*r output frames, and keeps
// in shared memory, time-major and zero outside [0, T_stage) at the stage's
// own rate (SAME padding):
//   mel window (first stage) -> x = conv_in(mel)  (first) or the x window,
//   y = leaky(tconv(x)) on N + 2e rows (e = 2; 3 for the last stage),
//   h = leaky(conv1(y)) on N + 2e - 2 rows,
//   xo = y + conv2(h) on N + 2 rows (last stage; it feeds the output conv).
// Other stages write y + conv2(h) to device memory in bf16.
//
// Products: every k=3 conv and the sub-pixel tconv is a sum over three taps
// of [rows, C] @ [C, cols] products, done by wgmma (m64nNk16, f32 += bf16 x
// bf16) with both operands read from shared memory through descriptors in
// the no-swizzle K-major layout. Activations are stored as [C/8][row][8]:
// each 8-row x 8-channel core matrix is 128 contiguous bytes, so the tap at
// row offset d is the same buffer with its start moved by 16*d bytes (no
// copy, no realignment). The tconv's dead taps (x_{q+1} for phase j < r/2,
// x_{q-1} for j >= r/2) are neither copied nor issued, except in a column
// group that straddles the two halves (r = 2 with one warpgroup a phase),
// where the dead tap's zero block is multiplied.
//
// Weights are too large to stay resident (stage 0's tconv alone is 1 MB of
// live bf16), so every pass streams them as chunks [taps][K/8][cols][8]
// (packed on the host in the order the kernel consumes them) through a
// two-slot ring in shared memory: thread 0 issues cp.async.bulk into an
// mbarrier while the warpgroups run wgmma on the other slot. Each block
// re-reads its stage's weights from L2.
//
// Rounding points (those of the TPU kernel and of vocoder_mm_stage): matmul
// inputs bf16, sums f32, biases, the residual add and tanh f32, activations
// rounded to bf16 after the input conv, after each leaky ReLU and after each
// residual add. The output conv (one column) is an f32 FMA dot product.
//
// Bound: operations in the wide stages (~12 MFLOP per mel frame in all),
// the bytes of the bf16 stage outputs in the narrow last two (~37 KB per
// mel frame across the stages).

#include <cuda_bf16.h>

#include "tc_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---- wgmma m64nNk16, f32 += bf16 x bf16, A and B from shared memory
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <int NW>
__device__ __forceinline__ void wgmma(float (&d)[NW / 2], uint64_t a, uint64_t b) {
  if constexpr (NW == 16) wgmma_n16(d, a, b);
  else if constexpr (NW == 32) wgmma_n32(d, a, b);
  else wgmma_n64(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// stmatrix: 8x8 bf16 matrices from accumulator-layout registers (lane l
// holds row l/4, columns 2(l%4), +1); lane 8m + i gives the shared address
// of row i of matrix m, so each matrix row (16 bytes) can go anywhere.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d));
}

__device__ __forceinline__ void stmatrix_x2(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n"
               :: "r"(addr), "r"(a), "r"(b));
}

struct TcParams {
  const void* x;              // first: mel [B, T_in, c_mel] f32; else [B, T_in, cip] bf16
  void* out;                  // last: audio [B, T_in*r] f32; else [B, T_in*r, cop] bf16
  const bf16* w;              // weight chunks of every pass, in consumption order
  const int* chunk_off;       // byte offset of chunk i in w; nchunks + 1 entries
  const float* b_in;          // [cip] (first)
  const float* b_t;           // [cop]
  const float* b_r1;          // [cop]
  const float* b_r2;          // [cop]
  const bf16* w_o;            // [3 * cop] (last)
  const float* b_o;           // [1] (last)
  int T_in, c_mel, cmp, cip, cop, r, first, last, q_tile, nw;
  int kc_in, kc_t, kc_r, slot_bytes, nchunks;
};

// Row counts, m-tiles and shared-memory layout of a full block (q_tile input
// frames). Row pitches are odd (in 16-byte units) so that eight channel
// groups of one row fall on different banks.
struct TcGeom {
  int e, nqy, nx, ny, nh, n_o;
  int rm, rx, ry, rh, ro;
  size_t off_ring, off_y, off_h, off_m, off_o, bytes;
};

__host__ __device__ inline TcGeom geometry(const TcParams& p) {
  TcGeom g;
  const int N = p.q_tile * p.r;
  g.e = 2 + p.last;
  g.nqy = floordiv(N + g.e - 1, p.r) - floordiv(-g.e, p.r) + 1;
  g.nx = g.nqy + 2;
  g.ny = N + 2 * g.e;
  g.nh = N + 2 * g.e - 2;
  g.n_o = p.last ? N + 2 : N;
  // each buffer holds its rows, or the 64-row tiles (+2 tap rows) of the
  // pass that reads it, whichever is more
  const int wn_in = col_wgs(p.cip, p.nw), wn_t = col_wgs(p.r * p.cop, p.nw);
  const int wn_r = col_wgs(p.cop, p.nw);
  g.rm = p.first ? odd(max(g.nx + 2, tile_rows(g.nx, wn_in) + 2)) : 0;
  g.rx = odd(max(g.nx, tile_rows(g.nqy, wn_t) + 2));
  g.ry = odd(max(g.ny, tile_rows(g.nh, wn_r) + 2));
  g.rh = odd(max(g.nh, tile_rows(g.n_o, wn_r) + 2));
  g.ro = p.last ? odd(N + 2) : 0;
  const size_t ring = (size_t)kSlots * p.slot_bytes;
  const size_t y = (size_t)p.cop * g.ry * 2, h = (size_t)p.cop * g.rh * 2;
  const size_t x = (size_t)p.cip * g.rx * 2, m = (size_t)p.cmp * g.rm * 2;
  // x (and the mel window) share h's region: both are dead before conv1
  // writes h
  g.off_ring = 128;
  g.off_y = align128(g.off_ring + ring);
  g.off_h = align128(g.off_y + y);
  g.off_m = align128(g.off_h + x);
  g.off_o = align128(max(g.off_h + h, g.off_m + m));
  g.bytes = align128(g.off_o + (size_t)p.cop * g.ro * 2);
  return g;
}

// One k=3 pass: out[o, col] = sum_t A[o + t] @ W_t[:, col] over the rows
// of mt 64-row tiles, cols < ncols, K = cin. A is [cin/8][ra][8] bf16 in
// shared memory; the weights arrive as chunks of kc input channels x NG
// columns (NG = wn * NW; warpgroup wg owns column block wg when wn == 2,
// else the half wg of the m-tiles). A chunk holds the taps live for any of
// its columns; a tconv column's dead tap is a zero block there. Every
// branch around a wgmma depends on block-uniform values only, so that
// ptxas keeps the wgmmas asynchronous.
// The epilogue stores the tiles with stmatrix, 8 rows x 8 channels at a
// time: val(row, col0, dc, v0, v1) turns columns col0 + dc, +1 of the
// warpgroup's column block col0 (bias added) into the packed bf16 pair to
// store, dst(row, col0, dc) gives the shared address of the 8 channels from
// col0 + dc of a row (a scratch address for a row that is not stored).
template <int NW, typename Val, typename Dst>
__device__ __forceinline__ void tc_pass(Ring& ring, const bf16* A, int ra, int cin, int ncols,
                                        int mt, int kc, bool tconv, int r, int cop,
                                        const float* __restrict__ bias, Val val, Dst dst) {
  const int wg = threadIdx.x >> 7;
  const int wn = col_wgs(ncols, NW);
  const int NG = wn * NW;
  const int nsub = wn == 2 ? wg : 0;
  const int mh = wn == 2 ? mt : (mt + 1) / 2;  // m-tiles a warpgroup runs
  const int mbase = wn == 2 ? 0 : wg * mh;
  const int kg = kc / 8, nks = kc / 16, nkc = cin / kc;
  const int half = (r / 2) * cop;  // first column of the phases with a dead x_{q-1}
  const uint32_t a_base = smem_addr(A);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;

  for (int g0 = 0; g0 < ncols; g0 += NG) {
    const int col0 = g0 + nsub * NW;
    const int t0 = tconv && g0 >= half ? 1 : 0;
    const int t1 = tconv && g0 + NG <= half ? 2 : 3;
    float acc[kMTW][NW / 2];
#pragma unroll
    for (int i = 0; i < kMTW; ++i)
#pragma unroll
      for (int v = 0; v < NW / 2; ++v) acc[i][v] = 0.f;

    for (int kci = 0; kci < nkc; ++kci) {
      const int c = ring.next++;
      const uint32_t b_base = ring.wait(c);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < kMTW; ++i) {
        const int mtile = mbase + i;
        if (i < mh) {
          for (int ks = 0; ks < nks; ++ks) {
            for (int t = t0; t < t1; ++t) {
              const uint64_t da = desc(
                  a_base + (uint32_t)(((kci * kg + 2 * ks) * ra + mtile * 64 + t) * 16),
                  ra * 16, 128);
              const uint64_t db = desc(
                  b_base + (uint32_t)((((t - t0) * kg + 2 * ks) * NG + nsub * NW) * 16),
                  NG * 16, 128);
              wgmma<NW>(acc[i], da, db);
            }
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      __syncthreads();  // every warpgroup is done with the slot
      if (threadIdx.x == 0 && c + kSlots < ring.nchunks) ring.issue(c + kSlots);
    }

    // Fence the accumulators before the epilogue reads them: without it
    // ptxas inserts a warpgroup.arrive inside the epilogue's tile branches
    // and then serialises every wgmma of the kernel.
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");

    // the bias of a tconv column is its channel's, col % cop
    const float* bcol = bias + (tconv ? col0 - col0 / cop * cop : col0) + 2 * (lane & 3);
    float2 bv[NW / 8];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) bv[j] = make_float2(__ldg(bcol + 8 * j), __ldg(bcol + 8 * j + 1));
#pragma unroll
    for (int i = 0; i < kMTW; ++i) {
      if (i < mh) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row0 = (mbase + i) * 64 + warp * 16 + 8 * hh;
          uint32_t u[NW / 8];
#pragma unroll
          for (int j = 0; j < NW / 8; ++j)
            u[j] = val(row0 + (lane >> 2), col0, 8 * j + 2 * (lane & 3),
                       acc[i][j * 4 + hh * 2] + bv[j].x, acc[i][j * 4 + hh * 2 + 1] + bv[j].y);
#pragma unroll
          for (int j = 0; j < NW / 8; j += 4) {
            if constexpr (NW >= 32)
              stmatrix_x4(dst(row0 + (lane & 7), col0, 8 * (j + (lane >> 3))), u[j], u[j + 1],
                          u[j + 2], u[j + 3]);
            else
              stmatrix_x2(dst(row0 + (lane & 7), col0, 8 * ((lane >> 3) & 1)), u[0], u[1]);
          }
        }
      }
    }
  }
}

// bf16 pair at channel c (even) of row `row` in a [C/8][pitch][8] buffer
__device__ __forceinline__ __nv_bfloat162* at(bf16* buf, int pitch, int row, int c) {
  return reinterpret_cast<__nv_bfloat162*>(buf + ((size_t)(c >> 3) * pitch + row) * 8 + (c & 7));
}

template <int NW>
__global__ void __launch_bounds__(kThreads, NW == 64 ? 1 : NW == 32 ? 2 : 3) tc_stage_kernel(const TcParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TcGeom g = geometry(p);
  bf16* sy = reinterpret_cast<bf16*>(smem + g.off_y);
  bf16* sh = reinterpret_cast<bf16*>(smem + g.off_h);
  bf16* sx = sh;  // dead before conv1 writes h
  bf16* sm = reinterpret_cast<bf16*>(smem + g.off_m);
  bf16* so = reinterpret_cast<bf16*>(smem + g.off_o);

  const int b = blockIdx.y, r = p.r, cip = p.cip, cop = p.cop;
  const int T_in = p.T_in, T_out = T_in * r;
  const int q0 = blockIdx.x * p.q_tile;
  const int nq = min(p.q_tile, T_in - q0);
  const int p0 = q0 * r, N = nq * r, e = g.e;
  const int qy_lo = floordiv(p0 - e, r);
  const int nqy = floordiv(p0 + N + e - 1, r) - qy_lo + 1;
  const int xlo = qy_lo - 1, nx = nqy + 2;
  const int ny = N + 2 * e, nh = N + 2 * e - 2, n_o = p.last ? N + 2 : N;
  const int y0 = p0 - e, h0 = p0 - e + 1, o_start = p.last ? p0 - 1 : p0;
  const uint32_t ay = smem_addr(sy), ah = smem_addr(sh), ao = smem_addr(so);
  const uint32_t scratch = smem_addr(smem + 64);  // rows that are not stored
  // shared address of channels c..c+7 of a row in a [C/8][pitch][8] buffer
  auto row_at = [](uint32_t base, int pitch, int row, int c) {
    return base + (uint32_t)(((c >> 3) * pitch + row) << 4);
  };

  Ring ring{smem_addr(smem), smem_addr(smem + g.off_ring),
            reinterpret_cast<const unsigned char*>(p.w), p.chunk_off, p.slot_bytes,
            p.nchunks, 0};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int c = 0; c < kSlots && c < p.nchunks; ++c) ring.issue(c);

  // ---- x window (positions xlo .. xlo+nx-1), zero outside [0, T_in)
  if (p.first) {
    const float* mel = static_cast<const float*>(p.x) + (size_t)b * T_in * p.c_mel;
    const int ng = p.cmp / 8;
    for (int idx = threadIdx.x; idx < (nx + 2) * ng; idx += blockDim.x) {
      const int row = idx / ng, gi = idx - row * ng;
      const int pos = xlo - 1 + row;
      const bool in = pos >= 0 && pos < T_in;
      __align__(16) bf16 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = gi * 8 + k;
        v[k] = __float2bfloat16_rn(in && c < p.c_mel ? mel[(size_t)pos * p.c_mel + c] : 0.f);
      }
      *reinterpret_cast<uint4*>(sm + ((size_t)gi * g.rm + row) * 8) =
          *reinterpret_cast<const uint4*>(v);
    }
    fence_async_smem();
    __syncthreads();
    tc_pass<NW>(ring, sm, g.rm, p.cmp, cip, cdiv(nx, 64), p.kc_in, false, r, cop, p.b_in,
                [&](int o, int, int, float v0, float v1) {
                  const int pos = xlo + o;
                  return pos >= 0 && pos < T_in ? pack_bf16(v0, v1) : 0u;
                },
                [&](int o, int col0, int dc) {
                  return o < nx ? row_at(ah, g.rx, o, col0 + dc) : scratch;
                });
  } else {
    const bf16* x = static_cast<const bf16*>(p.x) + (size_t)b * T_in * cip;
    const int ng = cip / 8;
    // all 16-byte copies in flight at once; rows outside [0, T_in) are
    // zero-filled
    for (int idx = threadIdx.x; idx < nx * ng; idx += blockDim.x) {
      const int row = idx / ng, gi = idx - row * ng;
      const int pos = xlo + row;
      const bool in = pos >= 0 && pos < T_in;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_addr(sx + ((size_t)gi * g.rx + row) * 8)),
                      "l"(x + (in ? (size_t)pos * cip + gi * 8 : 0)), "r"(in ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  fence_async_smem();
  __syncthreads();

  // ---- y = leaky(tconv(x)): phase j of input-rate row o is output p = q*r + j
  tc_pass<NW>(ring, sx, g.rx, cip, r * cop, cdiv(nqy, 64), p.kc_t, true, r, cop, p.b_t,
              [&](int o, int col0, int, float v0, float v1) {
                const int pos = (qy_lo + o) * r + col0 / cop;
                return pos >= 0 && pos < T_out ? pack_bf16(leaky(v0), leaky(v1)) : 0u;
              },
              [&](int o, int col0, int dc) {
                const int j = col0 / cop;
                const int iy = (qy_lo + o) * r + j - y0;
                return o < nqy && iy >= 0 && iy < ny ? row_at(ay, g.ry, iy, col0 - j * cop + dc)
                                                     : scratch;
              });
  fence_async_smem();
  __syncthreads();

  // ---- h = leaky(conv1(y))
  tc_pass<NW>(ring, sy, g.ry, cop, cop, cdiv(nh, 64), p.kc_r, false, r, cop, p.b_r1,
              [&](int o, int, int, float v0, float v1) {
                const int pos = h0 + o;
                return pos >= 0 && pos < T_out ? pack_bf16(leaky(v0), leaky(v1)) : 0u;
              },
              [&](int o, int col0, int dc) {
                return o < nh ? row_at(ah, g.rh, o, col0 + dc) : scratch;
              });
  fence_async_smem();
  __syncthreads();

  // ---- x' = y + conv2(h), residual add in f32, into xo (last stage) or
  // in place over y (other stages), for a coalesced copy to device memory.
  // Not into h: a later column group's products still read all of h. In
  // place is safe: the thread that stores an element of x' has just read
  // its y, and no product of this pass reads y.
  // (every tile row's y row lies inside sy, so the read needs no guard)
  tc_pass<NW>(ring, sh, g.rh, cop, cop, cdiv(n_o, 64), p.kc_r, false, r, cop, p.b_r2,
              [&](int o, int col0, int dc, float v0, float v1) {
                const int pos = o_start + o;
                const float2 yv = __bfloat1622float2(*at(sy, g.ry, pos - y0, col0 + dc));
                return pos >= 0 && pos < T_out ? pack_bf16(yv.x + v0, yv.y + v1) : 0u;
              },
              [&](int o, int col0, int dc) {
                return o >= n_o ? scratch
                       : p.last ? row_at(ao, g.ro, o, col0 + dc)
                                : row_at(ay, g.ry, o + e, col0 + dc);
              });
  __syncthreads();

  if (!p.last) {
    // rows p0 .. p0+N-1 of this utterance are one contiguous run; they are
    // rows e .. e+N-1 of y's buffer
    bf16* out = static_cast<bf16*>(p.out) + ((size_t)b * T_out + p0) * cop;
    const int ng = cop / 8;
    for (int idx = threadIdx.x; idx < N * ng; idx += blockDim.x) {
      const int row = idx / ng, gi = idx - row * ng;
      *reinterpret_cast<uint4*>(out + (size_t)row * cop + gi * 8) =
          *reinterpret_cast<const uint4*>(sy + ((size_t)gi * g.ry + row + e) * 8);
    }
  }

  if (p.last) {
    // ---- audio = tanh(output_conv(x')), one sample per thread
    float* audio = static_cast<float*>(p.out) + (size_t)b * T_out;
    const float bo = __ldg(p.b_o);
    for (int o = threadIdx.x; o < N; o += blockDim.x) {
      float acc = bo;
      for (int gi = 0; gi < cop / 8; ++gi) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const uint4 u = *reinterpret_cast<const uint4*>(so + ((size_t)gi * g.ro + o + d) * 8);
          const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(xv[k]);
            const int c = d * cop + gi * 8 + 2 * k;
            acc = fmaf(f.x, __bfloat162float(p.w_o[c]), acc);
            acc = fmaf(f.y, __bfloat162float(p.w_o[c + 1]), acc);
          }
        }
      }
      audio[p0 + o] = tanhf(acc);
    }
  }
}

template <int NW>
int launch(const TcParams& p, int B, cudaStream_t stream) {
  const TcGeom g = geometry(p);
  if (g.bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  if ((p.first && !fits(p.cip, NW, g.nx, kMTW)) || !fits(p.r * p.cop, NW, g.nqy, kMTW) ||
      !fits(p.cop, NW, g.nh, kMTW) || !fits(p.cop, NW, g.n_o, kMTW))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tc_stage_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)g.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(p.T_in, p.q_tile), B);
  tc_stage_kernel<NW><<<grid, kThreads, g.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One vocoder stage on tensor cores. Channel counts cmp, cip, cop are the
// padded ones (multiples of 16, and of nw for cip and cop); nw (16, 32 or
// 64) is the column width of a warpgroup's tile; kc_* are the input
// channels of one weight chunk of each pass; chunk_off (device, int32)
// holds the byte offsets of the nchunks chunks in w, in the order the passes
// consume them. Returns a cudaError_t.
int m2tts_vocoder_tc_stage(const void* x, void* out, const void* w, const int* chunk_off,
                           const float* b_in, const float* b_t, const float* b_r1,
                           const float* b_r2, const void* w_o, const float* b_o, int B, int T_in,
                           int c_mel, int cmp, int cip, int cop, int r, int first, int last,
                           int q_tile, int nw, int kc_in, int kc_t, int kc_r, int slot_bytes,
                           int nchunks, void* stream) {
  if (B < 1 || B > 65535 || T_in < 1 || q_tile < 1 || r < 2 || r % 2 || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)T_in * r > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (cip % nw || cop % nw || cip % 16 || cop % 16 || (first && (cmp % 16 || c_mel < 1)))
    return (int)cudaErrorInvalidValue;
  if (kc_t % 16 || cip % kc_t || kc_r % 16 || cop % kc_r ||
      (first && (kc_in % 16 || cmp % kc_in)) || slot_bytes % 128)
    return (int)cudaErrorInvalidValue;
  const TcParams p{x, out, static_cast<const bf16*>(w), chunk_off, b_in, b_t, b_r1, b_r2,
                   static_cast<const bf16*>(w_o), b_o, T_in, c_mel, cmp, cip, cop, r, first,
                   last, q_tile, nw, kc_in, kc_t, kc_r, slot_bytes, nchunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared-memory bytes of a stage launch, as the kernel lays them out.
long long m2tts_vocoder_tc_smem(int cmp, int cip, int cop, int r, int first, int last,
                                int q_tile, int nw, int slot_bytes) {
  TcParams p{};
  p.cmp = cmp; p.cip = cip; p.cop = cop; p.r = r; p.first = first; p.last = last;
  p.q_tile = q_tile; p.nw = nw; p.slot_bytes = slot_bytes;
  return (long long)geometry(p).bytes;
}

}  // extern "C"
