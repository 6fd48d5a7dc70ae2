// The idealize core of one replica, shared by the port's two align kernels:
// K1 (align_batched.cu, one block per replica of a batch) and K2 (align.cu,
// one block for the single trajectory).  Both kernels run this body, so
// they compute the same arithmetic to the bit.  It replaces the body of the
// Pallas TPU kernels kmc_tpu/ops/pallas_align_batched.py (_align_kernel_b)
// and kmc_tpu/ops/pallas_align.py (_align_kernel).
//
// For the replica `rep`, with one thread per molecule (receptors first,
// then ligands from the next warp boundary, so no warp runs a receptor's
// seat and a ligand's one after the other) and the block's dynamic shared
// memory holding the replica's tables, it computes what the TPU kernels
// compute as align_depth rounds of BFS depth, then align_depth snap
// sweeps:
//   - depth: synchronous min-propagation from the cluster roots;
//   - parent = the first neighbour column at depth - 1 (A: trans, then
//     cis; B: partner columns 0, 1, 2);
//   - root-ligand lay-down: z := plane_z and a z-axis quaternion that
//     keeps template bead 1's azimuth;
//   - snap sweep d: receptors at depth d seated on a ligand parent
//     (trans) or a receptor parent (cis), ligands at depth d re-seated on
//     their receptor parent with lay-down;
//   - markers for active molecules no sweep reached (snap = 2, b_laid
//     bit 1).
//
// Schedule: one pass per depth level.  The load phase also lays down the
// root ligands (they are level-0 cells, which nobody reads before the
// first barrier).  Pass d then computes BFS round d from the round-(d-1)
// depths (a ping-pong pair of depth buffers), takes a newly reached
// molecule's parent from those same depths, and seats the level-d
// receptors AND the level-d ligands from the poses as they stood at the
// start of the pass.
//
// Invariant.  Min-propagation gives a molecule its BFS distance in the
// round equal to that distance and never changes it after, so the
// molecules whose depth changes in round d are exactly the level-d cells,
// and their parents are level-(d-1) cells, fixed since pass d - 1.  Pass d
// therefore writes only level-d cells and reads only level-(d-1) cells
// (and the depth buffer of round d - 1): one barrier a pass orders all of
// it, and a ligand child of a level-(d-1) receptor never waits for the
// level-d receptors written beside it.  A pass in which no depth changes
// has no level-d cell, so no level-(d+1) cell can appear and every later
// pass is a no-op: the block leaves the loop when the pass's barrier,
// __syncthreads_or(changed), returns 0 (uniform, so every thread leaves
// together).  A call issues at most align_depth + 1 block-wide barriers
// (the load's and one a pass), and stops at the deepest level present.
//
// The arithmetic is the TPU kernels': transcendental-free direction
// vectors (cos psi, sin psi) and half-angle z-quaternions.  Every
// expression keeps the plain version's order of operations, and the build
// uses -fmad=false with IEEE sqrtf and division, so the results equal
// align_core_batched_plain to the bit.
//
// Bound.  At SimConfig() (150 + 50 molecules) a replica moves about
// 12.8 KB and does a few hundred flops a molecule: 0.004 us at 3.35 TB/s.
// One block of 224 threads per replica is a chain of dependent phases
// (the load's global reads; then each pass: a shared depth read, the
// seat's chain of IEEE square roots and divisions, a barrier), so latency
// bounds it, not bytes or flops; the design shortens the chain, from 42
// barriers a call to one a level present.  chip_smoke.py's phase 8 times
// the kernels and the cost of one pass.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Constants of the configuration, filled by the Python wrappers
// (kmc_tpu_torch/ops/align_batched.py, ops/align.py) in float32 as the
// JAX kernels round them.
struct AlignParams {
  int na, nb, depth;
  float ra;        // receptor bead radius
  float t_off0;    // trans seat offset along the ligand site direction
  float c_off0;    // cis seat offset
  float ra_seat;   // ra + B re-seat distance
  float plane_z;   // membrane plane (ligand lay-down z)
  float bead1[3];  // template bead 1 center (root lay-down reference)
  float site[3][3];  // template outward site of beads 1..3
  float bead[3][3];  // template center of beads 1..3
};

namespace kmc_core {

constexpr int kInf = 30000;   // depth of a molecule no root reaches

// The ligand template as K1 reads it: from the kernel's parameters, chosen
// with constant indices so the parameters stay in the constant bank.
struct ParamTemplate {
  const AlignParams& p;
  __device__ __forceinline__ float bead1(int c) const { return p.bead1[c]; }
  __device__ __forceinline__ float site(int j, int c) const {
    return j == 0 ? p.site[0][c] : (j == 1 ? p.site[1][c] : p.site[2][c]);
  }
  __device__ __forceinline__ float bead(int j, int c) const {
    return j == 0 ? p.bead[0][c] : (j == 1 ? p.bead[1][c] : p.bead[2][c]);
  }
};

// The ligand template as K2 reads it: rows of the f32[4, 4, 3] input in
// device memory (tmpl[j][0] = center of bead j, tmpl[j][1] = its site).
struct GlobalTemplate {
  const float* t;
  __device__ __forceinline__ float bead1(int c) const { return t[12 + c]; }
  __device__ __forceinline__ float site(int j, int c) const {
    return t[(j + 1) * 12 + 3 + c];
  }
  __device__ __forceinline__ float bead(int j, int c) const {
    return t[(j + 1) * 12 + c];
  }
};

// Thread of the first ligand: receptors fill whole warps and ligands start
// at the next warp boundary while the block stays within 1024 threads, so
// no warp runs both a receptor's and a ligand's seat one after the other;
// else ligands follow the receptors directly.
__host__ __device__ inline int ligand_base(int na, int nb) {
  const int a_pad = (na + 31) / 32 * 32;
  return a_pad + nb <= 1024 ? a_pad : na;
}

// Threads of one block: up to the last ligand's, rounded up to a warp.
inline int block_threads(int na, int nb) {
  return (ligand_base(na, nb) + nb + 31) / 32 * 32;
}

// Dynamic shared memory one block needs for na receptors and nb ligands:
// receptor poses float4[na] (x, y, cos psi, sin psi), ligand quaternions
// float4[nb], ligand centers float4[nb] (x, y, z, unused), two depth
// buffers int[2][n] and the receptor sites int[na].
inline int smem_bytes(int na, int nb) {
  return static_cast<int>((na + 2 * nb) * sizeof(float4) +
                          (2 * (na + nb) + na) * sizeof(int));
}

// (w, z) of the z-axis quaternion rotating by atan2(det, dot), from the
// half-angle identities (pallas_align_batched._quat_z_cs).
__device__ __forceinline__ void quat_z_cs(float dot, float det, float* w,
                                          float* z) {
  const float r = fmaxf(sqrtf(dot * dot + det * det), 1e-12f);
  const float c = dot / r;
  const float ch = sqrtf(fmaxf((1.0f + c) * 0.5f, 0.0f));
  float sh = sqrtf(fmaxf((1.0f - c) * 0.5f, 0.0f));
  if (det < 0.0f) sh = -sh;
  *w = ch;
  *z = sh;
}

// x, y of v rotated by the unit quaternion q (geometry.quat_rotate).
__device__ __forceinline__ void rot_xy(float qw, float qx, float qy, float qz,
                                       float vx, float vy, float vz, float* ox,
                                       float* oy) {
  const float tx = qy * vz - qz * vy;
  const float ty = qz * vx - qx * vz;
  const float tz = qx * vy - qy * vx;
  *ox = vx + 2.0f * (qw * tx + qy * tz - qz * ty);
  *oy = vy + 2.0f * (qw * ty + qz * tx - qx * tz);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The core for replica `rep`: arrays are the batch's, [B, ...] row-major;
// thread t < na is receptor t, thread ligand_base(na, nb) + j is ligand j.
template <class Template>
__device__ __forceinline__ void align_replica(
    const AlignParams& p, const Template& tm, int rep,
    const float* __restrict__ a_xy, const float* __restrict__ a_dir,
    const float* __restrict__ b_center, const float* __restrict__ b_quat,
    const int* __restrict__ a_trans, const int* __restrict__ a_site,
    const int* __restrict__ a_cis, const int* __restrict__ b_partner,
    const int* __restrict__ b_laid, const int* __restrict__ is_root,
    const int* __restrict__ act, float* __restrict__ o_a_xy,
    float* __restrict__ o_a_dir, int* __restrict__ o_snap,
    float* __restrict__ o_b_center, float* __restrict__ o_b_quat,
    int* __restrict__ o_b_laid) {
  const int na = p.na, nb = p.nb, n = na + nb;
  const int t = threadIdx.x;
  const int b_base = ligand_base(na, nb);

  // shared tables of this replica (16-byte rows first, so each pose is
  // one 16-byte access); depths are indexed by molecule, A then B
  extern __shared__ float4 smem4[];
  float4* s_a = smem4;              // [na]: x, y, cos psi, sin psi
  float4* s_bq = s_a + na;          // [nb]: w, x, y, z
  float4* s_bc = s_bq + nb;         // [nb]: x, y, z, unused
  int* s_din = reinterpret_cast<int*>(s_bc + nb);   // [n]: depths in
  int* s_dout = s_din + n;                          // [n]: depths out
  int* s_site = s_dout + n;                         // [na]

  const bool is_a = t < na;
  const bool is_b = t >= b_base && t < b_base + nb;
  const int bi = t - b_base;
  const int mol = is_a ? t : na + bi;   // molecule index if is_a or is_b

  // ---- load: own pose and topology; root-ligand lay-down ----
  int trans = -1, site = -1, cis = -1, bp0 = -1, bp1 = -1, bp2 = -1;
  int laid = 0, root = 0, active = 0;
  if (is_a || is_b) {
    const size_t k = static_cast<size_t>(rep) * n + mol;
    root = is_root[k];
    active = act[k];
  }
  // template vectors of the ligand bead this receptor binds (site 1..3),
  // and, for a ligand, x and y of beads 1..3 (its parent's pick)
  float svx = 0.0f, svy = 0.0f, svz = 0.0f, bvx = 0.0f, bvy = 0.0f,
        bvz = 0.0f;
  float g0x = 0.0f, g0y = 0.0f, g1x = 0.0f, g1y = 0.0f, g2x = 0.0f,
        g2y = 0.0f;
  int laid_new = 0;
  if (is_a) {
    const size_t i = static_cast<size_t>(rep) * na + t;
    s_a[t] = make_float4(a_xy[2 * i], a_xy[2 * i + 1], a_dir[2 * i],
                         a_dir[2 * i + 1]);
    trans = a_trans[i];
    site = a_site[i];
    cis = a_cis[i];
    s_site[t] = site;
    const int sj = clampi(site, 1, 3) - 1;
    svx = tm.site(sj, 0);
    svy = tm.site(sj, 1);
    svz = tm.site(sj, 2);
    bvx = tm.bead(sj, 0);
    bvy = tm.bead(sj, 1);
    bvz = tm.bead(sj, 2);
  } else if (is_b) {
    const size_t j = static_cast<size_t>(rep) * nb + bi;
    float4 c = make_float4(b_center[3 * j], b_center[3 * j + 1],
                           b_center[3 * j + 2], 0.0f);
    float4 q = make_float4(b_quat[4 * j], b_quat[4 * j + 1],
                           b_quat[4 * j + 2], b_quat[4 * j + 3]);
    bp0 = b_partner[3 * j];
    bp1 = b_partner[3 * j + 1];
    bp2 = b_partner[3 * j + 2];
    laid = b_laid[j];
    laid_new = laid;
    g0x = tm.bead(0, 0);
    g0y = tm.bead(0, 1);
    g1x = tm.bead(1, 0);
    g1y = tm.bead(1, 1);
    g2x = tm.bead(2, 0);
    g2y = tm.bead(2, 1);
    if (root == 1 && active == 1 && laid == 0) {
      const float tx = tm.bead1(0), ty = tm.bead1(1), tz = tm.bead1(2);
      float bdx, bdy;
      rot_xy(q.x, q.y, q.z, q.w, tx, ty, tz, &bdx, &bdy);
      float w, z;
      quat_z_cs(tx * bdx + ty * bdy, tx * bdy - ty * bdx, &w, &z);
      q = make_float4(w, 0.0f, 0.0f, z);
      c.z = p.plane_z;
      laid_new = 1;
    }
    s_bq[bi] = q;
    s_bc[bi] = c;
  }
  int depth = root == 1 ? 0 : kInf;
  if (is_a || is_b) s_din[mol] = depth;
  __syncthreads();

  // ---- one pass per depth level ----
  const int ab = clampi(trans - na, 0, nb - 1);   // A -> its trans B
  const int ac = clampi(cis, 0, na - 1);          // A -> its cis A
  const int b0 = clampi(bp0, 0, na - 1), b1 = clampi(bp1, 0, na - 1),
            b2 = clampi(bp2, 0, na - 1);
  int snap = 0;
  for (int d = 1; d <= p.depth; ++d) {
    // BFS round d from the round-(d-1) depths, which also name the parent
    int nd = depth;
    int pt = kInf, pc = kInf, p0 = kInf, p1 = kInf, p2 = kInf;
    if (is_a) {
      if (trans >= 0) pt = s_din[na + ab];
      if (cis >= 0) pc = s_din[ac];
      const int gt = trans >= 0 ? pt + 1 : kInf;
      const int gc = cis >= 0 ? pc + 1 : kInf;
      nd = min(nd, min(gt, gc));
    } else if (is_b) {
      if (bp0 >= 0) p0 = s_din[b0];
      if (bp1 >= 0) p1 = s_din[b1];
      if (bp2 >= 0) p2 = s_din[b2];
      if (bp0 >= 0) nd = min(nd, p0 + 1);
      if (bp1 >= 0) nd = min(nd, p1 + 1);
      if (bp2 >= 0) nd = min(nd, p2 + 1);
    }
    // a depth changes only from kInf to d: this molecule is a level-d cell
    const bool reached = nd != depth;
    if (reached && active == 1 && is_a) {
      // A child: seat on its trans B or cis A parent (level d - 1)
      const bool from_trans = pt == d - 1;
      const bool from_cis = !from_trans && pc == d - 1;
      if (from_trans) {
        const float4 q = s_bq[ab];
        const float4 cp = s_bc[ab];
        const float cpx = cp.x, cpy = cp.y;
        float sx, sy, bx, by;
        rot_xy(q.x, q.y, q.z, q.w, svx, svy, svz, &sx, &sy);
        rot_xy(q.x, q.y, q.z, q.w, bvx, bvy, bvz, &bx, &by);
        const float bsx = cpx + sx, bsy = cpy + sy;
        float utx = bsx - (cpx + bx);
        float uty = bsy - (cpy + by);
        const float un = fmaxf(sqrtf(utx * utx + uty * uty), 1e-9f);
        utx = utx / un;
        uty = uty / un;
        s_a[t] = make_float4(bsx + p.t_off0 * utx, bsy + p.t_off0 * uty,
                             -utx, -uty);
        snap = 1;
      } else if (from_cis) {
        const float4 pa = s_a[ac];
        const float uxp = pa.z, uyp = pa.w;
        s_a[t] = make_float4(pa.x - p.ra * uxp - p.c_off0 * uxp,
                             pa.y - p.ra * uyp - p.c_off0 * uyp, -uxp, -uyp);
        snap = 1;
      }
    } else if (reached && active == 1 && is_b) {
      // B child: re-seat on its receptor parent (level d - 1)
      const int parent_b = p0 == d - 1 ? bp0
                         : p1 == d - 1 ? bp1
                         : p2 == d - 1 ? bp2 : -1;
      if (parent_b >= 0) {
        const int pa = clampi(parent_b, 0, na - 1);
        const int pj = clampi(s_site[pa], 1, 3) - 1;
        const float ghx = pj == 0 ? g0x : (pj == 1 ? g1x : g2x);
        const float ghy = pj == 0 ? g0y : (pj == 1 ? g1y : g2y);
        const float4 ap = s_a[pa];
        const float ux2 = ap.z, uy2 = ap.w;
        const float cx2 = ap.x + p.ra_seat * ux2;
        const float cy2 = ap.y + p.ra_seat * uy2;
        float w, z;
        quat_z_cs(ghx * (-ux2) + ghy * (-uy2), ghx * (-uy2) - ghy * (-ux2),
                  &w, &z);
        s_bc[bi] = make_float4(cx2, cy2, p.plane_z, 0.0f);
        s_bq[bi] = make_float4(w, 0.0f, 0.0f, z);
        laid_new = 1;
      }
    }
    depth = nd;
    if (is_a || is_b) s_dout[mol] = nd;
    int* const s_tmp = s_din;
    s_din = s_dout;
    s_dout = s_tmp;
    if (!__syncthreads_or(reached)) break;
  }

  // ---- unreached markers and outputs (each thread its own cells) ----
  const bool unreached = active == 1 && root == 0 && depth >= kInf;
  if (is_a) {
    const size_t i = static_cast<size_t>(rep) * na + t;
    const float4 a = s_a[t];
    o_a_xy[2 * i] = a.x;
    o_a_xy[2 * i + 1] = a.y;
    o_a_dir[2 * i] = a.z;
    o_a_dir[2 * i + 1] = a.w;
    o_snap[i] = unreached ? 2 : snap;
  } else if (is_b) {
    const size_t j = static_cast<size_t>(rep) * nb + bi;
    const float4 c = s_bc[bi], q = s_bq[bi];
    o_b_center[3 * j] = c.x;
    o_b_center[3 * j + 1] = c.y;
    o_b_center[3 * j + 2] = c.z;
    o_b_quat[4 * j] = q.x;
    o_b_quat[4 * j + 1] = q.y;
    o_b_quat[4 * j + 2] = q.z;
    o_b_quat[4 * j + 3] = q.w;
    o_b_laid[j] = unreached ? laid_new + 2 : laid_new;
  }
}

}  // namespace kmc_core
