// Whole-anneal Ising kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ising_anneal.py:59 (_anneal_kernel,
// launched by fused_anneal_kernel's pallas_call). One launch runs the whole
// chip anneal: T Euler steps of
//     q = sign_pm1(v, vdd/2);  s = scales_from_cols(t, col) * drive_dt;
//     dv = (q * s) @ J^T;      v = clip(v + dv, 0, vdd)
// for every (problem, run). The schedule is derived in-kernel from the step
// index; there is no (T, N) operand.
//
// Bound on this card: operations. The work is 2*P*R*N^2*T operations (a
// multiply and an add per coupling per run per step) against a few MB of
// J / v traffic, read and written once. At the fig5 grid (P=400, R=300,
// N=64, T=1920) that is ~1.9e12 operations on 0.03 GB: the fp32 CUDA-core
// rate bounds the f32 variant, the int8 / bf16 tensor rates the others.
//
// Design. The launch geometry is the wrapper's plan (anneal_launch_plan in
// kernels/ising_anneal.py), checked here by plan_geometry. A run tile of
// runs belongs to one problem; its spins are split over warps_per_tile
// warps, each owning spins_per_warp of them (64 on the tensor cores, 128
// for f32 above 64 spins); a block holds tiles_per_block run tiles of one
// problem, and the blocks lie problem-major on grid.x. Three regimes, by
// where J^T lives:
//   * registers (N <= 64, one warp a tile): J^T stays in the warp's
//     registers for the whole anneal and a step reads no shared memory
//     (f32: one row of the step's scaled spins, written and read by the
//     warp alone);
//   * shared: the block stages J^T in shared memory once;
//   * streamed: J^T is read from device memory each step (it stays in L2
//     while it fits); a simple path that is right, not yet a fast one.
// Above 64 spins the warps of a run tile exchange the step's spins through
// a double-buffered shared buffer, one __syncthreads a step.
//
// bf16 and int8 run on the tensor cores through warp-level mma.sync:
// m16n8k16 bf16 with f32 sums, m16n8k32 s8 with s32 sums. A warp owns 16
// runs (the mma's M) of its spins, and keeps their voltages in the
// accumulator's register layout: lane (g, c) = (lane/4, lane%4) holds runs
// g and g+8 of columns 2c, 2c+1 of each 8-spin n-tile. Each step, per
// thread: ADC, scale, round to bf16 (or pack +-1 into int8), and pack
// straight into the next mma's A fragment:
//   * bf16: the accumulators of n-tiles 2k and 2k+1 ARE the A fragment of
//     k-tile k (the register reuse flash attention uses for P@V);
//   * int8: the k-tile is 32 deep and its A layout differs, so J^T's rows
//     are laid out in a permuted order (INT8_K_PERM in the wrapper): slot
//     k = 16h + 4c + i of quad lane c takes column 16h + 8(i/2) + 2c + i%2,
//     which is what the lane already holds (n-tiles 2h, 2h+1).
// The B fragments come from a layout the wrapper makes once a call
// (mma_fragment_index): each lane's four B registers of two n-tiles are 16
// contiguous bytes, so a warp reads them with one 16-byte load a lane and
// no bank conflict, what ldmatrix.x4 would give from a swizzled tile, with
// the swizzle done once outside the loop. The column scales depend on
// (step, column) only: each lane computes two a step (one bf16 pair) and
// the lanes that need them take them by shuffle; each column's schedule
// state advances a slot at a time (ColumnSchedule), so a step costs two
// IEEE divisions and an expf a column, and step t+1's pair is computed
// while step t's mma run.
//
// Why mma.sync and not wgmma: each step's A operand is made from the
// previous step's result, 1920 times in a row. mma.sync keeps that chain
// inside one warp's registers. wgmma needs 64-run tiles a warpgroup and B
// in shared memory: at the main shape (8192 runs) that leaves at most one
// warpgroup an SM, and each step would round-trip the spins through shared
// memory. A later version may try wgmma with A taken from registers.
//
// f32 stays on the CUDA cores, one fmaf chain per (spin, run) in ascending
// j, the order of the first kernel: TF32 or a split sum would change its
// results. Thread tile 2 spins (lane, lane+32) x 8 runs with J^T in
// registers (N <= 64; two broadcast 16-byte loads of the step's spins feed
// 16 fmaf), or 4 neighbouring spins x 8 runs with J^T in shared or device
// memory (three 16-byte loads feed 32 fmaf).
//
// Numerics, held to the plain version (fused_anneal_torch) op for op:
//   * floor modulo: jnp.mod floors, C's % truncates; slot - j is negative
//     before the first refresh pass and last_sel is negative in the pre-load
//     pass, so both go through floor_mod.
//   * float32 order of scales_from_cols: age = (float)step / substeps -
//     (float)last_sel; decay = expf(-age / (C * tau)) with C * tau the f32
//     constant (640.0 by default); where(rails_off, 0, decay) * drive_dt.
//     Built without --use_fast_math so / and expf stay IEEE / libm.
//   * int8: exact int32 sums, then (float)acc * drive_dt, rounded, then
//     the add (no contraction).
//   * bf16: sq = bf16(q * s) = +-bf16(s), products exact in f32. Under the
//     default device model every partial sum is exact in f32 (a multiple of
//     2^-17 below 2), so any order gives the plain version's bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum JType { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum Regime { kRegisters = 0, kShared = 1, kStreamed = 2 };

constexpr int kSmemMax = 232448;
constexpr int kMaxN = 1024;
constexpr int kRegN = 64;      // the register regime's spins (padded)
constexpr int kMmaRuns = 16;   // runs a warp owns on the tensor cores
constexpr int kF32Runs = 8;    // runs a warp owns on the CUDA cores
constexpr int kF32Slice = 128; // spins a warp owns, f32 above 64 spins
constexpr int kMmaSlice = 64;  // spins a warp owns on the tensor cores
constexpr unsigned kFull = 0xffffffffu;

struct Schedule {
  int n_steps;
  int substeps;
  int cols;          // cols_per_tile, C
  int pert_enabled;
  int period_slots;
  int off_slots;
  float settle_start;  // (anneal_sweeps - settle_sweeps) * C
  int has_leak;
  float c_tau;         // C * tau_leak_sweeps as f32
  float drive_dt;
  float vdd;
  float thr;
};

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;  // b > 0
}

// scales_from_cols(step, col) * drive_dt for one column, stepped through
// step = 0, 1, 2, ...: the integer part is advanced a slot at a time (no
// integer division in the step loop; one floor_mod a refresh), the float
// part is op for op the reference's:
//   slot = step / substeps;  j = col mod C;  d = (slot - j) mod C;
//   last_sel = slot - d, or j - C before the first refresh (pre);
//   rails_off = pert && last_sel mod period < off && !pre
//               && (float)last_sel < settle_start;
//   age = (float)step / substeps - (float)last_sel;
//   decay = leak ? expf(-age / (C * tau)) : 1;
//   (rails_off ? 0 : decay) * drive_dt.
struct ColumnSchedule {
  int j, d, last_sel;
  bool rails_off;

  __device__ __forceinline__ void start(int col, const Schedule& sc) {
    j = floor_mod(col, sc.cols);
    d = floor_mod(-j, sc.cols);
    last_sel = INT_MIN;
    select(0, sc);
  }
  __device__ __forceinline__ void select(int slot, const Schedule& sc) {
    int ls = slot - d;
    const bool pre = ls < 0;
    if (pre) ls = j - sc.cols;
    if (ls != last_sel) {  // a refresh (pre and not-pre differ in sign)
      last_sel = ls;
      rails_off = sc.pert_enabled &&
                  floor_mod(ls, sc.period_slots) < sc.off_slots && !pre &&
                  (float)ls < sc.settle_start;
    }
  }
  __device__ __forceinline__ void next_slot(int slot, const Schedule& sc) {
    d = d + 1 == sc.cols ? 0 : d + 1;
    select(slot, sc);
  }
  // tf = (float)step / (float)substeps
  __device__ __forceinline__ float scale(float tf, const Schedule& sc) const {
    float decay = 1.0f;
    if (sc.has_leak) decay = expf(-(tf - (float)last_sel) / sc.c_tau);
    return (rails_off ? 0.0f : decay) * sc.drive_dt;
  }
};

// The step, its slot and (float)step / substeps, shared by a thread's
// columns; advance() moves them and the columns to the next step.
struct StepClock {
  int t = 0, sub = 0, slot = 0;
  float tf = 0.0f;

  template <int K>
  __device__ __forceinline__ void advance(ColumnSchedule (&cs)[K],
                                          const Schedule& sc) {
    ++t;
    if (++sub == sc.substeps) {
      sub = 0;
      ++slot;
#pragma unroll
      for (int k = 0; k < K; ++k) cs[k].next_slot(slot, sc);
    }
    tf = (float)t / (float)sc.substeps;
  }
};

// The block's problem and first run. Blocks lie on grid.x, problem-major
// (grid.y would cap a problem at 65535 run blocks).
struct BlockRuns {
  int p, r0;
};

__device__ __forceinline__ BlockRuns block_runs(int R, int block_r) {
  const int blocks_r = (R + block_r - 1) / block_r;
  const int b = (int)blockIdx.x;
  const int p = b / blocks_r;
  return {p, (b - p * blocks_r) * block_r};
}

__device__ __forceinline__ float clip(float x, const Schedule& sc) {
  return fminf(fmaxf(x, 0.0f), sc.vdd);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The bf16 scales of two neighbouring columns, packed low then high.
__device__ __forceinline__ uint32_t scale_pair(const ColumnSchedule (&cs)[2],
                                               float tf, const Schedule& sc) {
  return bf16_bits(cs[0].scale(tf, sc)) | bf16_bits(cs[1].scale(tf, sc)) << 16;
}

// Sign bits that turn the bf16 pair (s_lo, s_hi) into (q_lo s_lo, q_hi s_hi).
__device__ __forceinline__ uint32_t neg_mask(float lo, float hi, float thr) {
  return (lo >= thr ? 0u : 0x8000u) | (hi >= thr ? 0u : 0x80000000u);
}

__device__ __forceinline__ uint32_t spin_byte(float x, float thr) {
  return x >= thr ? 0x01u : 0xffu;
}

__device__ __forceinline__ uint32_t spins4(float a, float b, float c, float d,
                                           float thr) {
  return spin_byte(a, thr) | spin_byte(b, thr) << 8 |
         spin_byte(c, thr) << 16 | spin_byte(d, thr) << 24;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16 / int8 on the tensor cores
// ---------------------------------------------------------------------------

// Bf: (P, KT, n_pad/16, 32) uint4, the fragment layout of J; v0, out:
// (P, R, N) f32. Shared memory: [J^T fragments (shared regime)] then, per
// run tile, two step buffers of KT A fragments (32 lanes x 16 bytes each).
template <int JT, int REGIME>
__global__ void __launch_bounds__(REGIME == kRegisters ? 256 : 512)
anneal_mma(const uint4* __restrict__ Bf, const float* __restrict__ v0,
           float* __restrict__ out, int R, int N, int n_pad, int block_r,
           Schedule sc) {
  constexpr int SLICE = kMmaSlice;
  using Acc = std::conditional_t<JT == kBF16, float, int>;
  constexpr int KD = JT == kBF16 ? 16 : 32;  // k-tile depth
  constexpr int NT = SLICE / 8;              // n-tiles a warp
  constexpr int KL = SLICE / KD;             // k-tiles of a warp's spins
  constexpr int NU = NT / 2;                 // n-tile pairs a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = n_pad / SLICE;
  const int KT = n_pad / KD;
  const int UT = n_pad / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = warp / W, w = warp - tile * W;
  const int g = lane >> 2, c = lane & 3;
  const BlockRuns br = block_runs(R, block_r);
  const int p = br.p;
  const size_t b_words = (size_t)KT * UT * 32;
  const uint4* Bp = Bf + (size_t)p * b_words;
  uint4* Bs = reinterpret_cast<uint4*>(smem);
  uint4* Abuf = Bs + (REGIME == kShared ? b_words : 0) +
                (size_t)tile * 2 * KT * 32;
  if constexpr (REGIME == kShared) {
    for (size_t i = threadIdx.x; i < b_words; i += blockDim.x)
      Bs[i] = __ldg(Bp + i);
    __syncthreads();
  }
  // registers regime: the warp's whole J^T (SLICE == n_pad == 64)
  uint4 breg[REGIME == kRegisters ? KL : 1][REGIME == kRegisters ? NU : 1];
  if constexpr (REGIME == kRegisters) {
#pragma unroll
    for (int kt = 0; kt < KL; ++kt)
#pragma unroll
      for (int u = 0; u < NU; ++u)
        breg[kt][u] = __ldg(Bp + (kt * UT + u) * 32 + lane);
  }

  const int r0 = br.r0 + tile * kMmaRuns;
  const int s0 = w * SLICE;
  // v[nt][e]: spin s0 + 8nt + 2c + (e & 1), run r0 + g + 8(e >> 1)
  float v[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = s0 + 8 * nt + 2 * c + (e & 1);
      const int r = r0 + g + 8 * (e >> 1);
      v[nt][e] = (i < N && r < R) ? v0[((size_t)p * R + r) * N + i] : sc.vdd;
    }

  // bf16: lane L owns the scales of columns s0 + 2L, +1 as one bf16 pair;
  // the lane (g, c) of n-tile nt takes the pair of its columns 2c, 2c+1
  // from lane 4nt + c by shuffle. Step t+1's pair is computed during step
  // t's mma.
  ColumnSchedule cs[2];
  StepClock clk;
  uint32_t pair = 0;
  if constexpr (JT == kBF16) {
    cs[0].start(s0 + 2 * lane, sc);
    cs[1].start(s0 + 2 * lane + 1, sc);
    pair = scale_pair(cs, clk.tf, sc);
  }

  for (int t = 0; t < sc.n_steps; ++t) {
    uint32_t a[KL][4];
    if constexpr (JT == kBF16) {
#pragma unroll
      for (int kt = 0; kt < KL; ++kt) {
        const int n0 = 2 * kt, n1 = 2 * kt + 1;
        const uint32_t lo = __shfl_sync(kFull, pair, 4 * n0 + c);
        const uint32_t hi = __shfl_sync(kFull, pair, 4 * n1 + c);
        a[kt][0] = lo ^ neg_mask(v[n0][0], v[n0][1], sc.thr);
        a[kt][1] = lo ^ neg_mask(v[n0][2], v[n0][3], sc.thr);
        a[kt][2] = hi ^ neg_mask(v[n1][0], v[n1][1], sc.thr);
        a[kt][3] = hi ^ neg_mask(v[n1][2], v[n1][3], sc.thr);
      }
    } else {
#pragma unroll
      for (int kt = 0; kt < KL; ++kt) {
        const float(&x0)[4] = v[4 * kt];
        const float(&x1)[4] = v[4 * kt + 1];
        const float(&x2)[4] = v[4 * kt + 2];
        const float(&x3)[4] = v[4 * kt + 3];
        a[kt][0] = spins4(x0[0], x0[1], x1[0], x1[1], sc.thr);
        a[kt][1] = spins4(x0[2], x0[3], x1[2], x1[3], sc.thr);
        a[kt][2] = spins4(x2[0], x2[1], x3[0], x3[1], sc.thr);
        a[kt][3] = spins4(x2[2], x2[3], x3[2], x3[3], sc.thr);
      }
    }

    if constexpr (JT == kBF16) {
      clk.advance(cs, sc);
      pair = scale_pair(cs, clk.tf, sc);
    }

    Acc acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
    if constexpr (REGIME == kRegisters) {
#pragma unroll
      for (int kt = 0; kt < KL; ++kt)
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          mma(acc[2 * u], a[kt], breg[kt][u].x, breg[kt][u].y);
          mma(acc[2 * u + 1], a[kt], breg[kt][u].z, breg[kt][u].w);
        }
    } else {
      uint4* A = Abuf + (t & 1) * KT * 32;
#pragma unroll
      for (int kt = 0; kt < KL; ++kt)
        A[(w * KL + kt) * 32 + lane] =
            make_uint4(a[kt][0], a[kt][1], a[kt][2], a[kt][3]);
      __syncthreads();
      const uint4* Bw = (REGIME == kShared ? Bs : Bp) + w * NU * 32 + lane;
#pragma unroll 2
      for (int kt = 0; kt < KT; ++kt) {
        const uint4 av = A[kt * 32 + lane];
        const uint32_t af[4] = {av.x, av.y, av.z, av.w};
        const uint4* Bk = Bw + (size_t)kt * UT * 32;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const uint4 b = REGIME == kShared ? Bk[u * 32] : __ldg(Bk + u * 32);
          mma(acc[2 * u], af, b.x, b.y);
          mma(acc[2 * u + 1], af, b.z, b.w);
        }
      }
    }

#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dv;
        if constexpr (JT == kBF16) {
          dv = acc[nt][e];
        } else {
          dv = __fmul_rn((float)acc[nt][e], sc.drive_dt);
        }
        v[nt][e] = clip(__fadd_rn(v[nt][e], dv), sc);
      }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = s0 + 8 * nt + 2 * c + (e & 1);
      const int r = r0 + g + 8 * (e >> 1);
      if (i < N && r < R) out[((size_t)p * R + r) * N + i] = v[nt][e];
    }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void scaled_spins(float4* dst, const float (&v)[8],
                                             float s, float thr) {
  float q[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) q[r] = (v[r] >= thr ? 1.0f : -1.0f) * s;
  dst[0] = make_float4(q[0], q[1], q[2], q[3]);
  dst[1] = make_float4(q[4], q[5], q[6], q[7]);
}

// N <= 64. Jt: (P, 64, 64) J^T zero-padded. Lane owns spins lane and
// lane+32 of 8 runs; its two J^T columns live in registers. Shared memory:
// per warp, two rows (by step parity) of 64 spins x 8 runs.
__global__ void __launch_bounds__(256)
anneal_f32_registers(const float* __restrict__ Jt,
                     const float* __restrict__ v0, float* __restrict__ out,
                     int R, int N, int block_r, Schedule sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const BlockRuns br = block_runs(R, block_r);
  const int p = br.p;
  const float* Jp = Jt + (size_t)p * kRegN * kRegN;
  float jr[2][kRegN];
#pragma unroll
  for (int j = 0; j < kRegN; ++j) {
    jr[0][j] = __ldg(Jp + j * kRegN + lane);
    jr[1][j] = __ldg(Jp + j * kRegN + 32 + lane);
  }
  const int r0 = br.r0 + warp * kF32Runs;
  float v[2][kF32Runs];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < kF32Runs; ++r) {
      const int i = lane + 32 * m, rr = r0 + r;
      v[m][r] = (i < N && rr < R) ? v0[((size_t)p * R + rr) * N + i] : sc.vdd;
    }
  float4* rows = reinterpret_cast<float4*>(smem) + warp * 2 * kRegN * 2;
  ColumnSchedule cs[2];
  StepClock clk;
  cs[0].start(lane, sc);
  cs[1].start(lane + 32, sc);

  for (int t = 0; t < sc.n_steps; ++t) {
    float4* row = rows + (t & 1) * kRegN * 2;  // row[2j], row[2j+1]: spin j
#pragma unroll
    for (int m = 0; m < 2; ++m)
      scaled_spins(row + 2 * (lane + 32 * m), v[m], cs[m].scale(clk.tf, sc),
                   sc.thr);
    clk.advance(cs, sc);
    __syncwarp();
    float acc[2][kF32Runs];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < kF32Runs; ++r) acc[m][r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kRegN; ++j) {
      const float4 qa = row[2 * j], qb = row[2 * j + 1];
      const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int r = 0; r < kF32Runs; ++r)
          acc[m][r] = fmaf(jr[m][j], q[r], acc[m][r]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < kF32Runs; ++r)
        v[m][r] = clip(__fadd_rn(v[m][r], acc[m][r]), sc);
  }

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < kF32Runs; ++r) {
      const int i = lane + 32 * m, rr = r0 + r;
      if (i < N && rr < R) out[((size_t)p * R + rr) * N + i] = v[m][r];
    }
}

// Any N. Jt: (P, N, n_pad) J^T zero-padded to whole 128-spin slices. Lane
// owns 4 neighbouring spins of 8 runs. Shared memory: [J^T (shared
// regime)] then, per run tile, two rows (by step parity) of N spins x 8
// runs, written by the tile's warps and read by all of them.
template <int REGIME>
__global__ void __launch_bounds__(512)
anneal_f32_split(const float* __restrict__ Jt, const float* __restrict__ v0,
                 float* __restrict__ out, int R, int N, int n_pad,
                 int block_r, Schedule sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = n_pad / kF32Slice;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = warp / W, w = warp - tile * W;
  const BlockRuns br = block_runs(R, block_r);
  const int p = br.p;
  const size_t j_words = (size_t)N * n_pad;
  const float* Jp = Jt + (size_t)p * j_words;
  float* Js = reinterpret_cast<float*>(smem);
  float4* rows = reinterpret_cast<float4*>(
                     Js + (REGIME == kShared ? j_words : 0)) +
                 (size_t)tile * 2 * N * 2;
  if constexpr (REGIME == kShared) {
    const float4* src = reinterpret_cast<const float4*>(Jp);
    float4* dst = reinterpret_cast<float4*>(Js);
    for (size_t i = threadIdx.x; i < j_words / 4; i += blockDim.x)
      dst[i] = __ldg(src + i);
    __syncthreads();
  }
  const int i0 = w * kF32Slice + 4 * lane;
  const int r0 = br.r0 + tile * kF32Runs;
  float v[4][kF32Runs];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int r = 0; r < kF32Runs; ++r) {
      const int i = i0 + m, rr = r0 + r;
      v[m][r] = (i < N && rr < R) ? v0[((size_t)p * R + rr) * N + i] : sc.vdd;
    }

  ColumnSchedule cs[4];
  StepClock clk;
#pragma unroll
  for (int m = 0; m < 4; ++m) cs[m].start(i0 + m, sc);

  for (int t = 0; t < sc.n_steps; ++t) {
    float4* row = rows + (size_t)(t & 1) * N * 2;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = i0 + m;
      if (i < N) scaled_spins(row + 2 * i, v[m], cs[m].scale(clk.tf, sc),
                              sc.thr);
    }
    clk.advance(cs, sc);
    __syncthreads();
    float acc[4][kF32Runs];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int r = 0; r < kF32Runs; ++r) acc[m][r] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < N; ++j) {
      const float4 qa = row[2 * j], qb = row[2 * j + 1];
      const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const size_t at = (size_t)j * n_pad + i0;
      const float4 jv4 =
          REGIME == kShared ? *reinterpret_cast<const float4*>(Js + at)
                            : __ldg(reinterpret_cast<const float4*>(Jp + at));
      const float jv[4] = {jv4.x, jv4.y, jv4.z, jv4.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int r = 0; r < kF32Runs; ++r)
          acc[m][r] = fmaf(jv[m], q[r], acc[m][r]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int r = 0; r < kF32Runs; ++r)
        v[m][r] = clip(__fadd_rn(v[m][r], acc[m][r]), sc);
  }

#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int r = 0; r < kF32Runs; ++r) {
      const int i = i0 + m, rr = r0 + r;
      if (i < N && rr < R) out[((size_t)p * R + rr) * N + i] = v[m][r];
    }
}

// ---------------------------------------------------------------------------
// plan check and launch
// ---------------------------------------------------------------------------

struct Geometry {
  int n_pad, j_rows, warps_per_tile, max_threads, smem;
};

// The geometry anneal_launch_plan computes for (j_dtype, regime, N,
// spins_per_warp, tiles_per_block); false where the kernel has none.
bool plan_geometry(int jt, int regime, int N, int slice, int G,
                   Geometry* geo) {
  if (G < 1 || regime < kRegisters || regime > kStreamed) return false;
  if (regime == kRegisters) {
    if (N > kRegN || slice != kRegN) return false;
    geo->n_pad = kRegN;
    geo->max_threads = 256;
  } else {
    if (slice != (jt == kF32 ? kF32Slice : kMmaSlice)) return false;
    geo->n_pad = (N + slice - 1) / slice * slice;
    geo->max_threads = 512;
  }
  geo->warps_per_tile = geo->n_pad / slice;
  long long smem;
  if (jt == kF32) {
    geo->j_rows = regime == kRegisters ? kRegN : N;
    smem = (long long)G * 2 * geo->j_rows * kF32Runs * 4;
    if (regime == kShared) smem += (long long)N * geo->n_pad * 4;
  } else {
    const int kd = jt == kBF16 ? 16 : 32, bytes = jt == kBF16 ? 2 : 1;
    geo->j_rows = geo->n_pad;
    smem = regime == kRegisters
               ? 0 : (long long)G * 2 * (geo->n_pad / kd) * 512;
    if (regime == kShared) smem += (long long)geo->n_pad * geo->n_pad * bytes;
  }
  if (smem > kSmemMax) return false;
  geo->smem = (int)smem;
  return true;
}

template <typename Kernel, typename... Args>
cudaError_t run(Kernel kernel, dim3 grid, int threads, int smem,
                cudaStream_t stream, Args... args) {
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int JT>
cudaError_t run_mma(int regime, dim3 grid, int threads, int smem,
                    cudaStream_t s, const void* Jl, const float* v,
                    float* o, int R, int N, int n_pad, int block_r,
                    const Schedule& sc) {
  const uint4* B = static_cast<const uint4*>(Jl);
  if (regime == kRegisters)
    return run(anneal_mma<JT, kRegisters>, grid, threads, smem, s, B, v, o, R,
               N, n_pad, block_r, sc);
  if (regime == kShared)
    return run(anneal_mma<JT, kShared>, grid, threads, smem, s, B, v, o, R, N,
               n_pad, block_r, sc);
  return run(anneal_mma<JT, kStreamed>, grid, threads, smem, s, B, v, o, R,
             N, n_pad, block_r, sc);
}

// What the entry point returns for a refused plan (build.REFUSED).
constexpr int kRefused = -1;

}  // namespace

// Plain C entry point, loaded with ctypes. Returns 0 on success, kRefused
// (-1) for a plan that does not match the shape or that the kernel cannot
// run, else the launch's own cudaError_t, checked right after it. j_dtype: 0 f32, 1 bf16, 2 int8; regime: 0 registers, 1 shared,
// 2 streamed. Jl is J as layout_j lays it out for the plan.
extern "C" int ising_anneal(const void* Jl, const void* v0, void* out, int P,
                            int R, int N, int j_dtype, int regime, int n_pad,
                            int j_rows, int spins_per_warp, int warps_per_tile,
                            int tiles_per_block, int smem_bytes, int n_steps,
                            int substeps, int cols, int pert_enabled,
                            int period_slots, int off_slots,
                            float settle_start, int has_leak, float c_tau,
                            float drive_dt, float vdd, float thr,
                            void* stream) {
  if (P <= 0 || R <= 0 || N <= 0 || N > kMaxN || cols <= 0 ||
      substeps <= 0 || (pert_enabled && period_slots <= 0) || j_dtype < kF32 ||
      j_dtype > kI8)
    return kRefused;
  Geometry geo;
  if (!plan_geometry(j_dtype, regime, N, spins_per_warp, tiles_per_block,
                     &geo) ||
      geo.n_pad != n_pad || geo.j_rows != j_rows ||
      geo.warps_per_tile != warps_per_tile || geo.smem != smem_bytes)
    return kRefused;
  const int threads = 32 * tiles_per_block * warps_per_tile;
  if (threads > geo.max_threads) return kRefused;
  const int block_r =
      tiles_per_block * (j_dtype == kF32 ? kF32Runs : kMmaRuns);
  const long long blocks = (long long)P * ((R + block_r - 1) / block_r);
  if (blocks > INT_MAX) return kRefused;
  Schedule sc{n_steps, substeps, cols, pert_enabled, period_slots, off_slots,
              settle_start, has_leak, c_tau, drive_dt, vdd, thr};
  const float* v = static_cast<const float*>(v0);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  cudaError_t err;
  switch (j_dtype) {
    case kF32: {
      const float* Jt = static_cast<const float*>(Jl);
      if (regime == kRegisters)
        err = run(anneal_f32_registers, grid, threads, smem_bytes, s, Jt, v,
                  o, R, N, block_r, sc);
      else if (regime == kShared)
        err = run(anneal_f32_split<kShared>, grid, threads, smem_bytes, s, Jt,
                  v, o, R, N, n_pad, block_r, sc);
      else
        err = run(anneal_f32_split<kStreamed>, grid, threads, smem_bytes, s,
                  Jt, v, o, R, N, n_pad, block_r, sc);
      break;
    }
    case kBF16:
      err = run_mma<kBF16>(regime, grid, threads, smem_bytes, s, Jl, v, o, R,
                           N, n_pad, block_r, sc);
      break;
    default:
      err = run_mma<kI8>(regime, grid, threads, smem_bytes, s, Jl, v, o, R, N,
                         n_pad, block_r, sc);
  }
  return (int)err;
}
