// One whole lattice timestep: kernel K3 of the port.
//
// Replaces the Pallas TPU kernel kmc_tpu/ops/pallas_lattice.py (_kernel,
// launched by padded_block_call and tiled_block_call, entered by
// pallas_lattice_step).  It computes _step_core, bit for bit equal to the
// plain version kmc_tpu_torch/lattice/step.py:lattice_step_arrays:
//   1. controls: four scalar hash uniforms of (step, seed*16) give the hop
//      axis, the reaction direction and the reaction parity offset;
//   2. hop: per-cell uniforms (hop, sign), then a + pass and a - pass
//      along the hop axis, each moving a particle into an empty neighbour;
//      a cell that received a particle in the + pass does not move again;
//   3. merge along the reaction direction under the global parity mask;
//   4. split along the same direction under the same mask.
// The displacement (dy, dx) of each particle rides along.
//
// Tiles.  One block of 320 threads owns a 32 x 32 tile and loads it with a
// width-4 ghost frame (40 x 40 cells) of grid and disp into shared memory,
// wrapping periodically.  The directions are drawn on the device from the
// step and seed tensors (no host read-back) and are uniform across the
// grid.  The kernel reads `step` and never writes it: other blocks are
// still reading it.
//
// Wrap tables.  At block start 80 threads fill four tables of 40 ints: the
// block-wrapped frame row rb[fy] = floor_mod(by0 + fy, h) and column cb[fx],
// and their hash coordinates rg[fy] = floor_mod(row0 + rb[fy], full_h) and
// cg[fx].  These 160 entries are the only runtime modulos of the block.  A
// frame cell's global index is rb[fy] * w + cb[fx], its hash counter
// rg[fy] * full_w + cg[fx], its parity coordinate row0 + rb[fy] or
// col0 + cb[fx].  The same code serves edge tiles, offset blocks, grids
// smaller than a frame and sizes that are no multiple of 32.
//
// Ownership.  Thread t owns the frame cells c = k * 320 + t, k = 0..4, for
// the whole step: 1,600 cells in five full rounds.  Each owned cell's
// frame position is worked out once, as three bit masks: on the frame's
// outer ring, in the tile, reaction parity on.  The step's directions are
// linear offsets in the frame, +-(hy * 40 + hx) for the hops and
// +-(ry * 40 + rx) for the reactions, so a sub-pass reads c +- off with no
// division and no clamp.  No sub-pass computes or writes a ring cell: the
// load writes the ring into both buffers and it stays so.
//
// The ring invariant.  Each logical sub-pass (hop +, hop -, merge, split)
// reads one neighbour on each side, so it widens the border of wrong cells
// by at most one: after the load only the values beyond the frame are
// unknown, after sub-pass p the cells within p of the frame's edge may be
// wrong.  The halo is 4, so after the four the tile is exact.  The last
// sub-pass runs on the tile only and writes out_grid / out_disp to global
// memory directly.
//
// Decide and apply.  Merge and split each run as a decide pass, which
// stores one bit a cell, and an apply pass, with a barrier between:
//   merge(c)  = g(c) > 0 && g(c+r) > 0 && g(c) + g(c+r) <= 8 && parity(c)
//               && u_merge(c) < ass;   absorbed(c) = merge(c-r)
//   split(c)  = g(c) >= 2 && g(c+r) == 0 && parity(c) && u_split(c) < diss;
//               receives(c) = split(c-r)
// so a cell hashes only its own counter (the hash is a pure function of
// counter, step and salt: the bits are those of the plain version).  The
// pair of passes still reads one neighbour on each side (the ring
// invariant holds).  Load, two hops, four reaction passes: seven barriers.
//
// Where the hashes are drawn.  u_hop and u_sgn only where the loaded
// value is > 0 (an empty cell attempts nothing); u_merge and u_split only
// in the decide passes, where the occupancy and parity terms above hold.
// Hop flags need no moved mask: a cell that wants to hop was occupied at
// the load, so it received nothing in the + pass, and a cell wants one
// sign only, so it did not move in the + pass if it wants the - one.
//
// Numbers.  Uniform draws and comparisons are float32 as in the plain
// version; the hop draw is multiplied by the float32 reciprocal of
// hop_prob, which is what XLA makes of the JAX package's division by a
// constant.  Built without fast math and with -fmad=false.
//
// Block mode.  The C entry takes the block's global origin (row0, col0)
// and the full grid size: the block wraps periodically onto itself, and
// the hashes and the parity use global coordinates, as padded_block_call
// does on the TPU.  The whole grid is row0 = col0 = 0 and full = block.
//
// Bound.  One read and one write of grid (int32) and disp (int32 x 2): 24
// bytes a cell, 6,291,456 B at 512 x 512, 1.878 us at 3.35 TB/s; 480.78 us
// at 8192 x 8192.  The integer work any design must do a cell (the
// counter, the two hop draws, the flags, four sub-passes: 97 operations)
// takes 1.52 us and 389.2 us at 16.7e12 32-bit integer operations a
// second (132 SMs x 64 lanes x 1.98 GHz), so bytes bound K3.  The ghost
// frame re-reads (40/32)^2 = 1.56x the tile's bytes, mostly from L2.
// ptxas (sm_90a, on the H100): 32 registers, 43,840 B of static shared
// memory, no spill; 5 blocks fit an SM by shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int FRAME_W = TILE + 2 * HALO;
constexpr int FRAME = FRAME_W * FRAME_W;
constexpr int THREADS = 320;
constexpr int CELLS = FRAME / THREADS;   // frame cells a thread owns
static_assert(CELLS * THREADS == FRAME, "every round is full");
constexpr int MAX_SPECIES = 8;

constexpr uint32_t M1 = 0x2C1B3C6Du;
constexpr uint32_t M2 = 0x297A2D39u;
constexpr uint32_t STEP_P = 0x9E3779B1u;
constexpr uint32_t SALT_P = 0x85EBCA77u;
constexpr uint32_t SALT_CTRL = 0, SALT_HOP = 1, SALT_MERGE = 2,
                   SALT_SPLIT = 3, SALT_SIGN = 4;

// hop flags of a frame cell, fixed for the whole step
constexpr unsigned char WANT_POS = 1, WANT_NEG = 2;

struct LatticeArgs {
  int h, w;             // block size (the whole grid in whole-grid mode)
  int row0, col0;       // global coordinates of the block's [0, 0] cell
  int full_h, full_w;   // full grid size, for the hash coordinates
  float inv_hop;        // float32(1 / float32(hop_prob))
  float ass, diss;      // float32(ass_prob), float32(diss_prob)
};

__device__ __forceinline__ uint32_t avalanche(uint32_t x) {
  x ^= x >> 15;
  x *= M1;
  x ^= x >> 12;
  x *= M2;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t counter, uint32_t step,
                                             uint32_t salt) {
  uint32_t x = counter + step * STEP_P + salt * SALT_P;
  x = avalanche(x);
  return avalanche(x ^ (step + salt));
}

// top 24 bits, through int32, times 2^-24 (exact)
__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return static_cast<float>(static_cast<int>(bits >> 8)) *
         5.9604644775390625e-08f;
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(THREADS)
lattice_step_kernel(LatticeArgs a, const int* __restrict__ grid,
                    const int2* __restrict__ disp, const int* __restrict__ step_p,
                    const int* __restrict__ seed_p, int* __restrict__ out_grid,
                    int2* __restrict__ out_disp) {
  __shared__ int g[2][FRAME];
  __shared__ int2 d[2][FRAME];
  __shared__ unsigned char bit[2][FRAME];   // merge, split decisions
  __shared__ unsigned char fl[FRAME];       // hop flags
  __shared__ int rb[FRAME_W], cb[FRAME_W];  // block-wrapped row / column
  __shared__ int rg[FRAME_W], cg[FRAME_W];  // their hash coordinates

  const uint32_t step = static_cast<uint32_t>(*step_p);
  const uint32_t salt = static_cast<uint32_t>(*seed_p) * 16u;

  // ---- controls (lattice/step.py step_controls) ----
  int ctrl[4];
  for (int k = 0; k < 4; ++k) {
    const float u = to_uniform(hash_u32(0xDEADBEEFu + k, step, salt + SALT_CTRL));
    ctrl[k] = static_cast<int>(u * (k < 2 ? 4.0f : 2.0f));
  }
  const int hop_axis = ctrl[0] & 1;         // 0: along x, 1: along y
  const int rct_dir = ctrl[1];              // (0,1) (1,0) (0,-1) (-1,0)
  const int par_off = ctrl[3];
  const int hy = hop_axis, hx = 1 - hop_axis;
  const int ry = (rct_dir == 1) - (rct_dir == 3);
  const int rx = (rct_dir == 0) - (rct_dir == 2);
  const bool rct_is_y = (rct_dir & 1) != 0;
  const int hop_off = hy * FRAME_W + hx;    // frame-index offsets
  const int rct_off = ry * FRAME_W + rx;

  // ---- wrap tables: the block's only runtime modulos ----
  const int tid = threadIdx.x;
  if (tid < FRAME_W) {
    rb[tid] = floor_mod(static_cast<int>(blockIdx.y) * TILE - HALO + tid, a.h);
    rg[tid] = floor_mod(a.row0 + rb[tid], a.full_h);
  } else if (tid < 2 * FRAME_W) {
    const int f = tid - FRAME_W;
    cb[f] = floor_mod(static_cast<int>(blockIdx.x) * TILE - HALO + f, a.w);
    cg[f] = floor_mod(a.col0 + cb[f], a.full_w);
  }
  __syncthreads();

  // ---- load the owned cells; hop draws where a particle sits ----
  unsigned ring = 0, inner = 0, par = 0;   // bit k: of owned cell k
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const int c = k * THREADS + tid;
    const int fy = c / FRAME_W, fx = c % FRAME_W;
    const bool on_ring =
        fy == 0 || fy == FRAME_W - 1 || fx == 0 || fx == FRAME_W - 1;
    ring |= static_cast<unsigned>(on_ring) << k;
    inner |= static_cast<unsigned>(fy >= HALO && fy < HALO + TILE &&
                                   fx >= HALO && fx < HALO + TILE) << k;
    const int by = rb[fy], bx = cb[fx];
    const int pc = rct_is_y ? a.row0 + by : a.col0 + bx;
    par |= static_cast<unsigned>((pc & 1) == par_off) << k;
    const int gi = by * a.w + bx;
    const int gv = grid[gi];
    const int2 dv = disp[gi];
    g[0][c] = gv;
    d[0][c] = dv;
    if (on_ring) {   // no pass writes the ring: both buffers keep the load
      g[1][c] = gv;
      d[1][c] = dv;
      bit[0][c] = 0;
      bit[1][c] = 0;
    }
    unsigned char f = 0;
    if (gv > 0) {
      const uint32_t counter =
          static_cast<uint32_t>(rg[fy]) * static_cast<uint32_t>(a.full_w) +
          static_cast<uint32_t>(cg[fx]);
      const float u_hop =
          to_uniform(hash_u32(counter, step, salt + SALT_HOP)) * a.inv_hop;
      if (u_hop * static_cast<float>(gv) < 1.0f) {
        const float u_sgn =
            to_uniform(hash_u32(counter, step, salt + SALT_SIGN));
        f = u_sgn < 0.5f ? WANT_POS : WANT_NEG;
      }
    }
    fl[c] = f;
  }
  __syncthreads();

  // ---- two signed hop passes (lattice/step.py _hop_pass) ----
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int src = pass, dst = pass ^ 1;
    const int off = pass == 0 ? hop_off : -hop_off;
    const int sy = pass == 0 ? hy : -hy, sx = pass == 0 ? hx : -hx;
    const unsigned char want = pass == 0 ? WANT_POS : WANT_NEG;
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      if (ring >> k & 1) continue;
      const int c = k * THREADS + tid;
      const int s = c - off;   // the cell that may move here
      const int gv = g[src][c];
      if ((fl[c] & want) && g[src][c + off] == 0) {   // moves out
        g[dst][c] = 0;
        d[dst][c] = make_int2(0, 0);
      } else if (gv == 0 && (fl[s] & want)) {         // receives
        const int2 sd = d[src][s];
        g[dst][c] = g[src][s];
        d[dst][c] = make_int2(sd.x + sy, sd.y + sx);
      } else {
        g[dst][c] = gv;
        d[dst][c] = d[src][c];
      }
    }
    __syncthreads();
  }

  // ---- merge (lattice/step.py _react_substep): decide on buffer 0 ----
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    if (ring >> k & 1) continue;
    const int c = k * THREADS + tid;
    const int gv = g[0][c];
    bool merge = false;
    if (gv > 0 && (par >> k & 1)) {
      const int nb = g[0][c + rct_off];
      if (nb > 0 && gv + nb <= MAX_SPECIES) {
        const int fy = c / FRAME_W, fx = c % FRAME_W;
        const uint32_t counter =
            static_cast<uint32_t>(rg[fy]) * static_cast<uint32_t>(a.full_w) +
            static_cast<uint32_t>(cg[fx]);
        merge = to_uniform(hash_u32(counter, step, salt + SALT_MERGE)) < a.ass;
      }
    }
    bit[0][c] = merge;
  }
  __syncthreads();

  // ---- merge: apply, buffers 0 -> 1 ----
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    if (ring >> k & 1) continue;
    const int c = k * THREADS + tid;
    if (bit[0][c - rct_off]) {           // absorbed by its -r neighbour
      g[1][c] = 0;
      d[1][c] = make_int2(0, 0);
    } else {
      const int gv = g[0][c];
      g[1][c] = bit[0][c] ? gv + g[0][c + rct_off] : gv;
      d[1][c] = d[0][c];
    }
  }
  __syncthreads();

  // ---- split: decide on buffer 1 ----
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    if (ring >> k & 1) continue;
    const int c = k * THREADS + tid;
    bool split = false;
    if (g[1][c] >= 2 && (par >> k & 1) && g[1][c + rct_off] == 0) {
      const int fy = c / FRAME_W, fx = c % FRAME_W;
      const uint32_t counter =
          static_cast<uint32_t>(rg[fy]) * static_cast<uint32_t>(a.full_w) +
          static_cast<uint32_t>(cg[fx]);
      split = to_uniform(hash_u32(counter, step, salt + SALT_SPLIT)) < a.diss;
    }
    bit[1][c] = split;
  }
  __syncthreads();

  // ---- split: apply on the tile, buffer 1 -> out_grid / out_disp ----
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    if (!(inner >> k & 1)) continue;
    const int c = k * THREADS + tid;
    const int by = static_cast<int>(blockIdx.y) * TILE + c / FRAME_W - HALO;
    const int bx = static_cast<int>(blockIdx.x) * TILE + c % FRAME_W - HALO;
    if (by >= a.h || bx >= a.w) continue;
    const int s = c - rct_off;          // the cell that may eject into c
    const bool receives = bit[1][s];
    out_grid[by * a.w + bx] = g[1][c] - bit[1][c] + receives;
    out_disp[by * a.w + bx] = receives ? d[1][s] : d[1][c];
  }
}

}  // namespace

extern "C" {

// One step of the (h, w) block `grid` (int32) / `disp` (int32 [h, w, 2])
// into `out_grid` / `out_disp` (distinct buffers) at the step and seed
// held in the int32 scalars `step` and `seed` on the device.  Launches on
// `stream` (a cudaStream_t) and returns cudaGetLastError(): nonzero when
// the launch was refused.
int kmc_lattice_step(const int* grid, const int* disp, const int* step,
                     const int* seed, int* out_grid, int* out_disp, int h,
                     int w, int row0, int col0, int full_h, int full_w,
                     float inv_hop, float ass, float diss, void* stream) {
  const LatticeArgs a{h, w, row0, col0, full_h, full_w, inv_hop, ass, diss};
  const dim3 blocks((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  lattice_step_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, grid, reinterpret_cast<const int2*>(disp), step, seed, out_grid,
      reinterpret_cast<int2*>(out_disp));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
