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
// Design.  The TPU kernel resolved the direction at trace time (8 static
// variants under lax.switch) and cut the grid into VMEM-sized tiles with
// width-4 periodic ghosts.  Here one thread block owns a 32 x 32 tile and
// loads it with a width-4 ghost frame (40 x 40 cells) of grid and disp
// into shared memory, wrapping the global loads periodically.  It hashes
// every frame cell on its wrapped global coordinate, then runs the four
// sub-passes in shared memory (double-buffered, a barrier after each) and
// writes only its interior.  Each sub-pass reads one neighbour on each
// side, so after four of them the width-4 frame has absorbed all the
// wrong values of its edge and the interior is exact.  The directions are
// drawn on the device from the step and seed tensors (no host read-back);
// the branch is uniform across the grid.  The kernel reads `step` and
// never writes it: other blocks are still reading it.  Uniform draws and
// comparisons are float32 as in the plain version; the hop draw is
// multiplied by the float32 reciprocal of hop_prob, which is what XLA
// makes of the JAX package's division by a constant.  Built without fast
// math and with -fmad=false.
//
// Block mode.  The C entry takes the block's global origin (row0, col0)
// and the full grid size: the block wraps periodically onto itself, and
// the hashes and the parity use global coordinates, as padded_block_call
// does on the TPU.  The whole grid is row0 = col0 = 0 and full = block.
//
// Bound.  One read and one write of grid (int32) and disp (int32 x 2):
// 12 bytes a cell each way, 24 in all.  At 512 x 512 that is 6,291,456 B,
// 1.88 us at 3.35 TB/s; at 8192 x 8192 480.8 us.  The ~143 integer
// operations a cell (four hashes of two avalanche rounds, the four
// sub-passes) take 1.12 us at 512 x 512 at 33.5 Tops/s, so bytes bound K3.
// The ghost frame re-reads (40/32)^2 = 1.56x the interior's bytes, mostly
// from L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int FRAME_W = TILE + 2 * HALO;
constexpr int FRAME = FRAME_W * FRAME_W;
constexpr int THREADS = 512;
constexpr int MAX_SPECIES = 8;

constexpr uint32_t M1 = 0x2C1B3C6Du;
constexpr uint32_t M2 = 0x297A2D39u;
constexpr uint32_t STEP_P = 0x9E3779B1u;
constexpr uint32_t SALT_P = 0x85EBCA77u;
constexpr uint32_t SALT_CTRL = 0, SALT_HOP = 1, SALT_MERGE = 2,
                   SALT_SPLIT = 3, SALT_SIGN = 4;

// flag bits of a frame cell, fixed for the whole step
constexpr unsigned char WANT_POS = 1, WANT_NEG = 2, MERGE_OK = 4,
                        SPLIT_OK = 8;

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

// frame index of (fy, fx) clamped to the frame: an edge cell reads itself
// for a missing neighbour; its result is wrong and never reaches the
// interior within the four sub-passes
__device__ __forceinline__ int at(int fy, int fx) {
  fy = min(max(fy, 0), FRAME_W - 1);
  fx = min(max(fx, 0), FRAME_W - 1);
  return fy * FRAME_W + fx;
}

__global__ void __launch_bounds__(THREADS)
lattice_step_kernel(LatticeArgs a, const int* __restrict__ grid,
                    const int2* __restrict__ disp, const int* __restrict__ step_p,
                    const int* __restrict__ seed_p, int* __restrict__ out_grid,
                    int2* __restrict__ out_disp) {
  __shared__ int g[2][FRAME];
  __shared__ int2 d[2][FRAME];
  __shared__ unsigned char mv[2][FRAME];
  __shared__ unsigned char fl[FRAME];

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

  // ---- load the frame, draw its uniforms ----
  const int by0 = blockIdx.y * TILE - HALO;
  const int bx0 = blockIdx.x * TILE - HALO;
  for (int c = threadIdx.x; c < FRAME; c += THREADS) {
    const int by = floor_mod(by0 + c / FRAME_W, a.h);
    const int bx = floor_mod(bx0 + c % FRAME_W, a.w);
    const int gi = by * a.w + bx;
    const int gv = grid[gi];
    g[0][c] = gv;
    d[0][c] = disp[gi];
    mv[0][c] = 0;
    const int gy = floor_mod(a.row0 + by, a.full_h);
    const int gx = floor_mod(a.col0 + bx, a.full_w);
    const uint32_t counter =
        static_cast<uint32_t>(gy) * static_cast<uint32_t>(a.full_w) +
        static_cast<uint32_t>(gx);
    const float u_hop =
        to_uniform(hash_u32(counter, step, salt + SALT_HOP)) * a.inv_hop;
    const float u_sgn = to_uniform(hash_u32(counter, step, salt + SALT_SIGN));
    const float u_m = to_uniform(hash_u32(counter, step, salt + SALT_MERGE));
    const float u_s = to_uniform(hash_u32(counter, step, salt + SALT_SPLIT));
    const bool attempt =
        gv > 0 && u_hop * static_cast<float>(max(gv, 1)) < 1.0f;
    const bool pos = u_sgn < 0.5f;
    const int pc = rct_is_y ? a.row0 + by : a.col0 + bx;
    const bool parity = (pc & 1) == par_off;
    fl[c] = (attempt && pos ? WANT_POS : 0) | (attempt && !pos ? WANT_NEG : 0) |
            (parity && u_m < a.ass ? MERGE_OK : 0) |
            (parity && u_s < a.diss ? SPLIT_OK : 0);
  }
  __syncthreads();

  // ---- two signed hop passes (lattice/step.py _hop_pass) ----
  for (int pass = 0; pass < 2; ++pass) {
    const int src = pass, dst = pass ^ 1;
    const int sy = pass == 0 ? hy : -hy, sx = pass == 0 ? hx : -hx;
    const unsigned char want = pass == 0 ? WANT_POS : WANT_NEG;
    for (int c = threadIdx.x; c < FRAME; c += THREADS) {
      const int fy = c / FRAME_W, fx = c % FRAME_W;
      const int gv = g[src][c];
      const int nb = g[src][at(fy + sy, fx + sx)];
      const bool move = gv > 0 && (fl[c] & want) && !mv[src][c] && nb == 0;
      const int s = at(fy - sy, fx - sx);   // the cell that may move here
      const int sg = g[src][s];
      const bool in = sg > 0 && (fl[s] & want) && !mv[src][s] && gv == 0;
      int2 dv = d[src][c];
      if (move) dv = make_int2(0, 0);
      if (in) {
        const int2 sd = d[src][s];
        dv = make_int2(sd.x + sy, sd.y + sx);
      }
      g[dst][c] = (move ? 0 : gv) + (in ? sg : 0);
      d[dst][c] = dv;
      mv[dst][c] = (mv[src][c] && !move) || in;
    }
    __syncthreads();
  }

  // ---- merge (lattice/step.py _react_substep), buffers 0 -> 1 ----
  for (int c = threadIdx.x; c < FRAME; c += THREADS) {
    const int fy = c / FRAME_W, fx = c % FRAME_W;
    const int gv = g[0][c];
    const int nb = g[0][at(fy + ry, fx + rx)];
    const bool merge =
        gv > 0 && nb > 0 && gv + nb <= MAX_SPECIES && (fl[c] & MERGE_OK);
    const int s = at(fy - ry, fx - rx);
    const int sg = g[0][s];
    const bool absorbed =
        sg > 0 && gv > 0 && sg + gv <= MAX_SPECIES && (fl[s] & MERGE_OK);
    g[1][c] = absorbed ? 0 : (merge ? gv + nb : gv);
    d[1][c] = absorbed ? make_int2(0, 0) : d[0][c];
  }
  __syncthreads();

  // ---- split, buffers 1 -> 0 ----
  for (int c = threadIdx.x; c < FRAME; c += THREADS) {
    const int fy = c / FRAME_W, fx = c % FRAME_W;
    const int gv = g[1][c];
    const int nb = g[1][at(fy + ry, fx + rx)];
    const bool split = gv >= 2 && nb == 0 && (fl[c] & SPLIT_OK);
    const int s = at(fy - ry, fx - rx);
    const int sg = g[1][s];
    const bool receives = sg >= 2 && gv == 0 && (fl[s] & SPLIT_OK);
    g[0][c] = (split ? gv - 1 : gv) + (receives ? 1 : 0);
    d[0][c] = receives ? d[1][s] : d[1][c];
  }
  __syncthreads();

  // ---- write the interior ----
  for (int c = threadIdx.x; c < TILE * TILE; c += THREADS) {
    const int ty = c / TILE, tx = c % TILE;
    const int by = blockIdx.y * TILE + ty, bx = blockIdx.x * TILE + tx;
    if (by < a.h && bx < a.w) {
      const int f = (ty + HALO) * FRAME_W + tx + HALO;
      out_grid[by * a.w + bx] = g[0][f];
      out_disp[by * a.w + bx] = d[0][f];
    }
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
