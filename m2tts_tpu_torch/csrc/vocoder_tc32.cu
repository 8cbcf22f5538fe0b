// Fused HiFi-GAN-lite vocoder stage on Hopper tensor cores (sm_90a) in f32,
// by the 3xTF32 split: one launch per upsample stage, the input conv fused
// into the first stage and the output conv + tanh into the last.
//
// Replaces, for compute_dtype='f32', the TPU kernels
// m2tts_tpu/ops/pallas/vocoder_packed.py (fused_vocoder_packed_forward) and
// m2tts_tpu/ops/pallas/vocoder.py (fused_vocoder_forward). The bf16 path is
// vocoder_tc.cu, whose design this kernel follows (blocks, passes, weight
// ring, epilogue rows); what differs is below.
//
// 3xTF32: one TF32 product keeps 11 significant bits, short of the f32 bar
// (atol 3e-5 / rtol 1e-4). Each operand v is split into a TF32 high part and
// a low part; the three products hi*hi + hi*lo + lo*hi drop only lo*lo and
// are summed in f32 by wgmma m64nNk8 f32.tf32.tf32. The weights are split
// once on the host, hi = rna_tf32(v), lo = rna_tf32(v - hi) (v to 2^-22
// relative). The activations are split per fragment in two instructions:
// hi = v with its low 13 bits cleared (truncation, |v - hi| < 2^-10 |v|),
// lo = v - hi, exact in f32, of which the tensor core reads the TF32 bits
// (2^-11 of lo lost). Each product then errs by about 2^-20 relative.
//
// Operands. Activations stay f32 in shared memory as [C/4][row][4]: each
// 8-row x 4-channel core matrix is 128 contiguous bytes, and the tap at row
// offset d is d rows further down. In the input and residual convs (and the
// tconv of the narrow stages) A, the activations, comes from registers: each
// thread loads its fragment (rows lane/4 and +8 of its warp's 16, channels
// lane%4 and +4 of the k-step) with plain shared loads, splits it and
// issues the register-A wgmma, so shared memory holds 4 bytes an
// activation, not 8. A row past the buffer is clamped to its last row: it
// only feeds an output row that is never stored, so the buffers hold their
// rows exactly (no padding to whole m-tiles, unlike the bf16 kernel's
// descriptor-read A), which buys a larger q_tile. B, the weights, is read
// from shared memory by descriptor: the wrapper splits each packed weight
// once into its hi and lo planes and streams chunks [2][taps][K/4][cols][4]
// (hi plane, then lo) through the same cp.async.bulk + mbarrier ring as the
// bf16 kernel.
//
// What sets the pace is the work around each product, not the tensor cores:
// every register fragment costs four shared loads, its split and their
// addressing. So a fragment feeds as many columns as it can (a warpgroup's
// tconv tile is F = 1, 2 or 4 column blocks of NW, one wgmma each on the
// same A registers), and the wgmmas of all of a warpgroup's m-tiles for one
// k-step and tap are one commit group; each thread loads the next step's
// raw fragments right after issuing a group. In the wide stages (r >= 4)
// the tconv's few rows (nqy, 21 and 42 at the flagship's tiling) would fill
// a third to two thirds of a 64-row m-tile, so there the tconv swaps its
// operands (tc32_tconv_swapped): the weight chunk is A, the x window, split
// once into TF32 hi and lo planes, is B with the time rows on N, and no
// thread touches a fragment.
//
// The wide stages re-read their weights from L2 once per block (5.5 MB a
// block in stage 0 at the flagship widths). Sharing them over a cluster of
// 2 or 4 blocks by TMA multicast, with a cluster barrier per chunk, made
// every stage slower on the H100, so each block streams its own.
//
// Arithmetic: every sum f32, no intermediate rounding, as vocoder_mm_stage
// in f32; the output conv (one column) is an f32 FMA dot product with tanh.
//
// Bound: operations on the TF32 tensor cores (3 x ~12 MFLOP per mel frame at
// the flagship widths, 495 TFLOP/s); the weight stream from L2 is the first
// thing a block waits on in the wide stages.

#include "tc_common.cuh"

namespace {

// ---- wgmma m64nNk8, f32 += tf32 x tf32, A from registers, B from shared
// memory
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int NW>
__device__ __forceinline__ void wgmma(float (&d)[NW / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NW == 16) wgmma_n16(d, a, b);
  else if constexpr (NW == 32) wgmma_n32(d, a, b);
  else wgmma_n64(d, a, b);
}

// ---- wgmma m64nNk8, f32 += tf32 x tf32, A and B from shared memory (the
// swapped tconv, N = its time rows)
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n24(float (&d)[12], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "%12, %13, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 16) wgmma_ss_n16(d, a, b);
  else if constexpr (N == 24) wgmma_ss_n24(d, a, b);
  else if constexpr (N == 32) wgmma_ss_n32(d, a, b);
  else if constexpr (N == 48) wgmma_ss_n48(d, a, b);
  else wgmma_ss_n64(d, a, b);
}

// v = hi + lo: hi is v truncated to TF32, lo the exact rest (see above)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

// Blocks an SM: the narrow stages' tiles need fewer registers.
__host__ __device__ constexpr int blocks_per_sm(int nw) { return nw == 64 ? 1 : 2; }

// m-tiles (64 rows) a warpgroup accumulates: kMT in the input and residual
// convs; in the tconv fewer as its tile widens to F column blocks, so that
// its accumulators stay within 2 x NW registers a thread
constexpr int kMT = 3;
__host__ __device__ constexpr int tconv_mt(int f) { return f == 1 ? kMT : f == 2 ? 2 : 1; }


struct Tc32Params {
  const void* x;              // first: mel [B, T_in, c_mel]; else [B, T_in, cip]; f32
  void* out;                  // last: audio [B, T_in*r]; else [B, T_in*r, cop]; f32
  const float* w;             // weight chunks of every pass, in consumption order
  const int* chunk_off;       // byte offset of chunk i in w; nchunks + 1 entries
  const float* b_in;          // [cip] (first)
  const float* b_t;           // [cop]
  const float* b_r1;          // [cop]
  const float* b_r2;          // [cop]
  const float* w_o;           // [3 * cop] (last)
  const float* b_o;           // [1] (last)
  int T_in, c_mel, cmp, cip, cop, r, first, last, q_tile, nw, ft, nq;
  int kc_in, kc_t, kc_r, slot_bytes, nchunks;
};

// Row counts and shared-memory layout of a full block (q_tile input
// frames). Each buffer holds exactly the rows its pass reads; pitches are
// odd (in 16-byte units) so that neighbouring channel groups of one row
// fall on different banks.
struct Tc32Geom {
  int e, nqy, nx, ny, nh, n_o;
  int rm, rx, ry, rh, ro;
  size_t off_ring, off_y, off_h, off_m, off_o, bytes;
};

__host__ __device__ inline Tc32Geom geometry(const Tc32Params& p) {
  Tc32Geom g;
  const int N = p.q_tile * p.r;
  g.e = 2 + p.last;
  g.nqy = floordiv(N + g.e - 1, p.r) - floordiv(-g.e, p.r) + 1;
  g.nx = g.nqy + 2;
  g.ny = N + 2 * g.e;
  g.nh = N + 2 * g.e - 2;
  g.n_o = p.last ? N + 2 : N;
  g.rm = p.first ? odd(g.nx + 2) : 0;
  g.rx = odd(p.nq ? max(g.nx, p.nq + 2) : g.nx);
  g.ry = odd(g.ny);
  g.rh = odd(g.nh);
  g.ro = p.last ? odd(N + 2) : 0;
  const size_t ring = (size_t)kSlots * p.slot_bytes;
  const size_t y = (size_t)p.cop * g.ry * 4, h = (size_t)p.cop * g.rh * 4;
  // x: one f32 plane, or (swapped tconv) its TF32 hi and lo planes
  const size_t x = (size_t)p.cip * g.rx * (p.nq ? 8 : 4), m = (size_t)p.cmp * g.rm * 4;
  // x (and the mel window) share h's region: both are dead before conv1
  // writes h
  g.off_ring = 128;
  g.off_y = align128(g.off_ring + ring);
  g.off_h = align128(g.off_y + y);
  g.off_m = align128(g.off_h + x);
  g.off_o = align128(max(g.off_h + h, g.off_m + m));
  g.bytes = align128(g.off_o + (size_t)p.cop * g.ro * 4);
  return g;
}

// One k=3 pass: out[o, col] = sum_t A[o + t] @ W_t[:, col] over the rows
// of mt 64-row tiles, cols < ncols, K = cin. A is [cin/4][ra][4] f32 in
// shared memory; the weights arrive as chunks of kc input channels x NG
// columns (NG = wn * F * NW; warpgroup wg owns column tile wg when wn == 2,
// else the half wg of the m-tiles, at most MT of them), hi plane then lo
// plane. A chunk holds the taps live for any of its columns; a tconv
// column's dead tap is a zero block there. Every branch around a wgmma
// depends on block-uniform values only, so that ptxas keeps the wgmmas
// asynchronous.
// The epilogue stores two channels at a time: val(row, col0, dc, v0, v1)
// turns columns col0 + dc, +1 of the NW-column block col0 (bias added) into
// the pair to store, dst(row, col0, dc) gives its shared address (a scratch
// address for a row that is not stored).
template <int NW, int F, int MT, typename Val, typename Dst>
__device__ __forceinline__ void tc32_pass(Ring& ring, const float* A, int ra, int cin, int ncols,
                                          int mt, int kc, bool tconv, int r, int cop,
                                          const float* __restrict__ bias, Val val, Dst dst) {
  constexpr int NT = F * NW;  // columns of a warpgroup's tile
  const int wg = threadIdx.x >> 7;
  const int wn = col_wgs(ncols, NT);
  const int NG = wn * NT;
  const int nsub = wn == 2 ? wg : 0;
  const int mh = wn == 2 ? mt : (mt + 1) / 2;  // m-tiles a warpgroup runs
  const int mbase = wn == 2 ? 0 : wg * mh;
  const int kg = kc / 4, nks = kc / 8, nkc = cin / kc;
  const int half = (r / 2) * cop;  // first column of the phases with a dead x_{q-1}
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  // this thread's fragment rows in m-tile 0 (tap 0), and its channel
  const int row_lane = mbase * 64 + warp * 16 + (lane >> 2);
  const float* a_lane = A + (lane & 3);

  for (int g0 = 0; g0 < ncols; g0 += NG) {
    const int col0 = g0 + nsub * NT;
    const int t0 = tconv && g0 >= half ? 1 : 0;
    const int t1 = tconv && g0 + NG <= half ? 2 : 3;
    const uint32_t lo_plane = (uint32_t)((t1 - t0) * kc * NG * 4);
    float acc[MT][F][NW / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int b = 0; b < F; ++b)
#pragma unroll
        for (int v = 0; v < NW / 2; ++v) acc[i][b][v] = 0.f;

    for (int kci = 0; kci < nkc; ++kci) {
      const int c = ring.next++;
      const uint32_t b_base = ring.wait(c);
      const float* a_chunk = a_lane + (size_t)kci * kg * ra * 4;
      // raw fragments of k-step ks, tap t: rows row_lane + 64 i + t (+8) of
      // m-tile i, channel groups 2 ks (+1)
      float raw[MT][4] = {};
      auto load = [&](int ks, int t) {
        const float* g_lo = a_chunk + (size_t)(2 * ks) * ra * 4;
        const float* g_hi = g_lo + (size_t)ra * 4;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < mh) {
            const int r0 = min(row_lane + 64 * i + t, ra - 1);
            const int r1 = min(row_lane + 64 * i + t + 8, ra - 1);
            raw[i][0] = g_lo[r0 * 4];
            raw[i][1] = g_lo[r1 * 4];
            raw[i][2] = g_hi[r0 * 4];
            raw[i][3] = g_hi[r1 * 4];
          }
        }
      };
      load(0, t0);
      for (int ks = 0, t = t0; ks < nks;) {
        const uint64_t dh = desc(
            b_base + (uint32_t)((((t - t0) * kg + 2 * ks) * NG + nsub * NT) * 16), NG * 16, 128);
        const uint64_t dl = dh + (lo_plane >> 4);  // the lo plane, same offsets
        // the last group read fh/fl: let it finish, then split these
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        // (every m-tile's, used or not: a branch here makes ptxas serialise
        // the wgmmas)
        uint32_t fh[MT][4], fl[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) split_tf32(raw[i][v], fh[i][v], fl[i][v]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < mh) {
#pragma unroll
            for (int b = 0; b < F; ++b) {  // column block b: NW columns further
              wgmma<NW>(acc[i][b], fh[i], dl + b * NW);
              wgmma<NW>(acc[i][b], fl[i], dh + b * NW);
              wgmma<NW>(acc[i][b], fh[i], dh + b * NW);
            }
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (++t == t1) t = t0, ++ks;  // the next tap, then the next k-step
        if (ks < nks) load(ks, t);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      __syncthreads();  // every warpgroup is done with the slot
      if (threadIdx.x == 0 && c + kSlots < ring.nchunks) ring.issue(c + kSlots);
    }

    // Fence the accumulators before the epilogue reads them (as in the
    // bf16 kernel: without it ptxas may serialise every wgmma).
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");

#pragma unroll
    for (int b = 0; b < F; ++b) {
      const int colb = col0 + b * NW;
      // the bias of a tconv column is its channel's, col % cop
      const float* bcol = bias + (tconv ? colb - colb / cop * cop : colb) + 2 * (lane & 3);
      float2 bv[NW / 8];
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
        bv[j] = make_float2(__ldg(bcol + 8 * j), __ldg(bcol + 8 * j + 1));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mh) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = (mbase + i) * 64 + warp * 16 + 8 * hh + (lane >> 2);
#pragma unroll
            for (int j = 0; j < NW / 8; ++j) {
              const int dc = 8 * j + 2 * (lane & 3);
              st_shared_f2(dst(row, colb, dc),
                           val(row, colb, dc, acc[i][b][j * 4 + hh * 2] + bv[j].x,
                               acc[i][b][j * 4 + hh * 2 + 1] + bv[j].y));
            }
          }
        }
      }
    }
  }
}

// The tconv with A and B swapped, for stages whose tconv rows (nqy <= NQ,
// a multiple of 8 up to 64) would fill little of a 64-row m-tile:
// D^T[col][row] = W^T[col][K] X^T[K][row]. The weight chunk is A, its
// columns on M (the chunk layout is the one the register-A tconv reads as
// B, with 256-column groups); the x window is B, its time rows on N, from
// its TF32 hi and lo planes `xplane` bytes apart. Both come by descriptor,
// so no thread touches a fragment; each warpgroup owns two of a group's
// four 64-column m-tiles. put(o, col, v) stores tconv row o of column col.
template <int NQ, typename Put>
__device__ __forceinline__ void tc32_tconv_swapped(Ring& ring, uint32_t xb, int rx,
                                                   uint32_t xplane, int cin, int ncols, int kc,
                                                   int r, int cop, const float* __restrict__ bias,
                                                   Put put) {
  constexpr int NG = 256;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int kg = kc / 4, nks = kc / 8, nkc = cin / kc;
  const int half = (r / 2) * cop;  // first column of the phases with a dead x_{q-1}
  for (int g0 = 0; g0 < ncols; g0 += NG) {
    const int t0 = g0 >= half ? 1 : 0;
    const int t1 = g0 + NG <= half ? 2 : 3;
    const uint32_t lo_plane = (uint32_t)((t1 - t0) * kc * NG * 4);
    float acc[2][NQ / 2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int v = 0; v < NQ / 2; ++v) acc[i][v] = 0.f;
    for (int kci = 0; kci < nkc; ++kci) {
      const int c = ring.next++;
      const uint32_t b_base = ring.wait(c);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int ks = 0; ks < nks; ++ks) {
        for (int t = t0; t < t1; ++t) {
          const uint64_t dx =
              desc(xb + (uint32_t)(((kci * kg + 2 * ks) * rx + t) * 16), rx * 16, 128);
          const uint64_t dxl = dx + (xplane >> 4);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint64_t dw = desc(
                b_base + (uint32_t)((((t - t0) * kg + 2 * ks) * NG + (2 * wg + i) * 64) * 16),
                NG * 16, 128);
            const uint64_t dwl = dw + (lo_plane >> 4);
            wgmma_ss<NQ>(acc[i], dw, dxl);
            wgmma_ss<NQ>(acc[i], dwl, dx);
            wgmma_ss<NQ>(acc[i], dw, dx);
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      __syncthreads();  // every warpgroup is done with the slot
      if (threadIdx.x == 0 && c + kSlots < ring.nchunks) ring.issue(c + kSlots);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = g0 + (2 * wg + i) * 64 + warp * 16 + 8 * hh + (lane >> 2);
        const float b = __ldg(bias + col % cop);
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const int o = 8 * j + 2 * (lane & 3);
          put(o, col, acc[i][j * 4 + hh * 2] + b);
          put(o + 1, col, acc[i][j * 4 + hh * 2 + 1] + b);
        }
      }
    }
  }
}

template <int NW, int F, int NQ>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(NW)) tc32_stage_kernel(const Tc32Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tc32Geom g = geometry(p);
  float* sy = reinterpret_cast<float*>(smem + g.off_y);
  float* sh = reinterpret_cast<float*>(smem + g.off_h);
  float* sx = sh;  // dead before conv1 writes h
  float* sm = reinterpret_cast<float*>(smem + g.off_m);
  float* so = reinterpret_cast<float*>(smem + g.off_o);

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
  // shared address of channel c (even) of a row in a [C/4][pitch][4] buffer
  auto at = [](uint32_t base, int pitch, int row, int c) {
    return base + (uint32_t)((((c >> 2) * pitch + row) << 4) + ((c & 3) << 2));
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
    const int ng = p.cmp / 4;
    for (int idx = threadIdx.x; idx < (nx + 2) * ng; idx += blockDim.x) {
      const int row = idx / ng, gi = idx - row * ng;
      const int pos = xlo - 1 + row;
      const bool in = pos >= 0 && pos < T_in;
      float4 v;
      float* vp = &v.x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = gi * 4 + k;
        vp[k] = in && c < p.c_mel ? mel[(size_t)pos * p.c_mel + c] : 0.f;
      }
      *reinterpret_cast<float4*>(sm + ((size_t)gi * g.rm + row) * 4) = v;
    }
    __syncthreads();
    tc32_pass<NW, 1, kMT>(ring, sm, g.rm, p.cmp, cip, cdiv(nx, 64), p.kc_in, false, r, cop, p.b_in,
                  [&](int o, int, int, float v0, float v1) {
                    const int pos = xlo + o;
                    return pos >= 0 && pos < T_in ? make_float2(v0, v1) : make_float2(0.f, 0.f);
                  },
                  [&](int o, int col0, int dc) {
                    return o < nx ? at(ah, g.rx, o, col0 + dc) : scratch;
                  });
  } else {
    const float* x = static_cast<const float*>(p.x) + (size_t)b * T_in * cip;
    const int ng = cip / 4;
    // all 16-byte copies in flight at once; rows outside [0, T_in) are
    // zero-filled
    for (int idx = threadIdx.x; idx < nx * ng; idx += blockDim.x) {
      const int row = idx / ng, gi = idx - row * ng;
      const int pos = xlo + row;
      const bool in = pos >= 0 && pos < T_in;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_addr(sx + ((size_t)gi * g.rx + row) * 4)),
                      "l"(x + (in ? (size_t)pos * cip + gi * 4 : 0)), "r"(in ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // ---- y = leaky(tconv(x)): phase j of input-rate row o is output p = q*r + j
  if constexpr (NQ > 0) {
    // split x into its TF32 hi plane (in place) and lo plane
    const int n = cip * g.rx;
    uint32_t* xh = reinterpret_cast<uint32_t*>(sx);
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      uint32_t hi, lo;
      split_tf32(sx[idx], hi, lo);
      xh[idx] = hi;
      xh[n + idx] = lo;
    }
    fence_async_smem();
    __syncthreads();
    tc32_tconv_swapped<NQ>(ring, smem_addr(sx), g.rx, (uint32_t)(n * 4), cip, r * cop, p.kc_t, r,
                           cop, p.b_t, [&](int o, int col, float v) {
                             const int j = col / cop, ch = col - j * cop;
                             const int pos = (qy_lo + o) * r + j, iy = pos - y0;
                             if (o < nqy && iy >= 0 && iy < ny)
                               sy[((size_t)(ch >> 2) * g.ry + iy) * 4 + (ch & 3)] =
                                   pos >= 0 && pos < T_out ? leaky(v) : 0.f;
                           });
  } else {
    tc32_pass<NW, F, tconv_mt(F)>(
        ring, sx, g.rx, cip, r * cop, cdiv(nqy, 64), p.kc_t, true, r, cop, p.b_t,
        [&](int o, int col0, int, float v0, float v1) {
          const int pos = (qy_lo + o) * r + col0 / cop;
          return pos >= 0 && pos < T_out ? make_float2(leaky(v0), leaky(v1))
                                         : make_float2(0.f, 0.f);
        },
        [&](int o, int col0, int dc) {
          const int j = col0 / cop;
          const int iy = (qy_lo + o) * r + j - y0;
          return o < nqy && iy >= 0 && iy < ny ? at(ay, g.ry, iy, col0 - j * cop + dc) : scratch;
        });
  }
  __syncthreads();

  // ---- h = leaky(conv1(y))
  tc32_pass<NW, 1, kMT>(ring, sy, g.ry, cop, cop, cdiv(nh, 64), p.kc_r, false, r, cop, p.b_r1,
                [&](int o, int, int, float v0, float v1) {
                  const int pos = h0 + o;
                  return pos >= 0 && pos < T_out ? make_float2(leaky(v0), leaky(v1))
                                                 : make_float2(0.f, 0.f);
                },
                [&](int o, int col0, int dc) {
                  return o < nh ? at(ah, g.rh, o, col0 + dc) : scratch;
                });
  __syncthreads();

  // ---- x' = y + conv2(h), into xo (last stage) or in place over y (other
  // stages), for a coalesced copy to device memory. Not into h: a later
  // column group's products still read all of h. In place is safe: the
  // thread that stores an element of x' has just read its y, and no product
  // of this pass reads y. A row that is not stored reads no y (its row may
  // lie past y's buffer).
  tc32_pass<NW, 1, kMT>(ring, sh, g.rh, cop, cop, cdiv(n_o, 64), p.kc_r, false, r, cop, p.b_r2,
                [&](int o, int col0, int dc, float v0, float v1) {
                  const int pos = o_start + o;
                  if (o >= n_o || pos < 0 || pos >= T_out) return make_float2(0.f, 0.f);
                  const float2 yv =
                      *reinterpret_cast<const float2*>(sy + ((size_t)((col0 + dc) >> 2) * g.ry +
                                                             pos - y0) * 4 + ((col0 + dc) & 3));
                  return make_float2(yv.x + v0, yv.y + v1);
                },
                [&](int o, int col0, int dc) {
                  return o >= n_o ? scratch
                         : p.last ? at(ao, g.ro, o, col0 + dc)
                                  : at(ay, g.ry, o + e, col0 + dc);
                });
  __syncthreads();

  if (!p.last) {
    // rows p0 .. p0+N-1 of this utterance are one contiguous run; they are
    // rows e .. e+N-1 of y's buffer
    float* out = static_cast<float*>(p.out) + ((size_t)b * T_out + p0) * cop;
    const int ng = cop / 4;
    for (int idx = threadIdx.x; idx < N * ng; idx += blockDim.x) {
      const int row = idx / ng, gi = idx - row * ng;
      *reinterpret_cast<float4*>(out + (size_t)row * cop + gi * 4) =
          *reinterpret_cast<const float4*>(sy + ((size_t)gi * g.ry + row + e) * 4);
    }
  } else {
    // ---- audio = tanh(output_conv(x')), one sample per thread
    float* audio = static_cast<float*>(p.out) + (size_t)b * T_out;
    const float bo = __ldg(p.b_o);
    for (int o = threadIdx.x; o < N; o += blockDim.x) {
      float acc = bo;
      for (int gi = 0; gi < cop / 4; ++gi) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float4 u = *reinterpret_cast<const float4*>(so + ((size_t)gi * g.ro + o + d) * 4);
          const float* w = p.w_o + d * cop + gi * 4;
          acc = fmaf(u.x, __ldg(w), acc);
          acc = fmaf(u.y, __ldg(w + 1), acc);
          acc = fmaf(u.z, __ldg(w + 2), acc);
          acc = fmaf(u.w, __ldg(w + 3), acc);
        }
      }
      audio[p0 + o] = tanhf(acc);
    }
  }
}

template <int NW, int F, int NQ>
int launch(const Tc32Params& p, int B, cudaStream_t stream) {
  const Tc32Geom g = geometry(p);
  if (g.bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  const int ncols = p.r * p.cop;
  const bool tconv_fits =
      NQ ? g.nqy <= NQ && ncols % 256 == 0 && (p.r / 2 * p.cop) % 256 == 0
         : fits(ncols, F * NW, g.nqy, tconv_mt(F)) && ncols % (F * NW) == 0;
  if ((p.first && !fits(p.cip, NW, g.nx, kMT)) || !tconv_fits || !fits(p.cop, NW, g.nh, kMT) ||
      !fits(p.cop, NW, g.n_o, kMT))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tc32_stage_kernel<NW, F, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)g.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(p.T_in, p.q_tile), B);
  tc32_stage_kernel<NW, F, NQ><<<grid, kThreads, g.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NW>
int launch_f(const Tc32Params& p, int B, cudaStream_t stream) {
  if (p.nq) {  // the swapped tconv: the 64-column kernels only
    if constexpr (NW == 64) {
      switch (p.nq) {
        case 16: return launch<NW, 2, 16>(p, B, stream);
        case 24: return launch<NW, 2, 24>(p, B, stream);
        case 32: return launch<NW, 2, 32>(p, B, stream);
        case 48: return launch<NW, 2, 48>(p, B, stream);
        case 64: return launch<NW, 2, 64>(p, B, stream);
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (p.ft) {
    case 1: return launch<NW, 1, 0>(p, B, stream);
    case 2: return launch<NW, 2, 0>(p, B, stream);
    case 4: return launch<NW, 4, 0>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One f32 vocoder stage on tensor cores (3xTF32). Channel counts cmp, cip,
// cop are the padded ones (multiples of 16, and of nw for cip and cop); nw
// (16, 32 or 64) is the column width of a warpgroup's tile, ft (1, 2 or 4)
// the tconv's tile in blocks of nw columns, nq (0, or 16, 24, 32, 48 or 64
// with nw = 64 and ft = 2) the time rows of the swapped tconv; kc_* are the
// input channels of one weight chunk of each pass (multiples of 8);
// chunk_off (device, int32)
// holds the byte offsets of the nchunks chunks in w, in the order the passes
// consume them. Returns a cudaError_t.
int m2tts_vocoder_tc32_stage(const void* x, void* out, const void* w, const int* chunk_off,
                             const float* b_in, const float* b_t, const float* b_r1,
                             const float* b_r2, const void* w_o, const float* b_o, int B,
                             int T_in, int c_mel, int cmp, int cip, int cop, int r, int first,
                             int last, int q_tile, int nw, int ft, int nq, int kc_in,
                             int kc_t, int kc_r, int slot_bytes, int nchunks, void* stream) {
  if (B < 1 || B > 65535 || T_in < 1 || q_tile < 1 || r < 2 || r % 2 || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)T_in * r > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (cip % nw || cop % nw || cip % 16 || cop % 16 || (first && (cmp % 16 || c_mel < 1)))
    return (int)cudaErrorInvalidValue;
  if (kc_t % 8 || cip % kc_t || kc_r % 8 || cop % kc_r ||
      (first && (kc_in % 8 || cmp % kc_in)) || slot_bytes % 128)
    return (int)cudaErrorInvalidValue;
  const Tc32Params p{x, out, static_cast<const float*>(w), chunk_off, b_in, b_t, b_r1, b_r2,
                     static_cast<const float*>(w_o), b_o, T_in, c_mel, cmp, cip, cop, r, first,
                     last, q_tile, nw, ft, nq, kc_in, kc_t, kc_r, slot_bytes, nchunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 16: return launch_f<16>(p, B, s);
    case 32: return launch_f<32>(p, B, s);
    case 64: return launch_f<64>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared-memory bytes of a stage launch, as the kernel lays them out.
long long m2tts_vocoder_tc32_smem(int cmp, int cip, int cop, int r, int first, int last,
                                  int q_tile, int nw, int slot_bytes, int nq) {
  Tc32Params p{};
  p.cmp = cmp; p.cip = cip; p.cop = cop; p.r = r; p.first = first; p.last = last;
  p.q_tile = q_tile; p.nw = nw; p.slot_bytes = slot_bytes; p.nq = nq;
  return (long long)geometry(p).bytes;
}

}  // extern "C"
