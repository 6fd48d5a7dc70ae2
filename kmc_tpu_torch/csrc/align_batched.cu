// Replica-batched idealize core: kernel K1 of the port.
//
// Replaces the Pallas TPU kernel kmc_tpu/ops/pallas_align_batched.py
// (_align_kernel_b, launched by align_core_batched).  For each replica it
// computes, in order:
//   1. BFS depth over the bond graph by align_depth rounds of synchronous
//      min-propagation from the cluster roots;
//   2. parent = the first neighbour column at depth - 1 (A: trans, then
//      cis; B: partner columns 0, 1, 2);
//   3. root-ligand lay-down: z := plane_z and a z-axis quaternion that
//      keeps template bead 1's azimuth;
//   4. align_depth snap sweeps: receptors seated on a ligand parent
//      (trans) or a receptor parent (cis), then ligands re-seated on their
//      receptor parent with lay-down;
//   5. markers for active molecules the sweeps never reached
//      (snap = 2, b_laid bit 1).
//
// Design.  The TPU kernel expressed every gather as a one-hot masked lane
// reduction over [rb, m, n] masks and kept all data struct-of-arrays,
// because Mosaic has no dynamic gather and cannot concatenate lanes.  On
// Hopper none of that is needed: one thread block per replica, one thread
// per molecule, the replica's poses, depths and site indices in shared
// memory, and real indexed loads.  Depth rounds and snap sweeps are
// separated by __syncthreads(); each phase reads shared state into
// registers, synchronises, then writes, so every round sees exactly the
// previous round's values, as the vectorised TPU kernel does.  Nothing
// carries between blocks.  The arithmetic is the TPU kernel's:
// transcendental-free direction vectors (cos psi, sin psi) and half-angle
// z-quaternions (_quat_z_cs, _rot_const), so the two agree to float32
// rounding.
//
// Bound.  At the main path's B = 64 replicas of 150 + 50 molecules the
// kernel reads 8,000 and writes 4,600 bytes per replica: 0.8 MB, a quarter
// of a microsecond at 3.35 TB/s, and a few hundred flops per molecule.  It
// is bound by latency (16 dependent phases with block-wide barriers) and
// launch cost, not by bytes or flops; 64 blocks fill half of the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kInf = 30000;   // depth of a molecule no root reaches

}  // namespace

// Constants of the configuration, filled by the Python wrapper
// (kmc_tpu_torch/ops/align_batched.py) in float32 as the JAX kernel
// rounds them.
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

namespace {

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

__global__ void align_batched_kernel(
    AlignParams p, const float* __restrict__ a_xy,
    const float* __restrict__ a_dir, const float* __restrict__ b_center,
    const float* __restrict__ b_quat, const int* __restrict__ a_trans,
    const int* __restrict__ a_site, const int* __restrict__ a_cis,
    const int* __restrict__ b_partner, const int* __restrict__ b_laid,
    const int* __restrict__ is_root, const int* __restrict__ act,
    float* __restrict__ o_a_xy, float* __restrict__ o_a_dir,
    int* __restrict__ o_snap, float* __restrict__ o_b_center,
    float* __restrict__ o_b_quat, int* __restrict__ o_b_laid) {
  const int na = p.na, nb = p.nb, n = na + nb;
  const int rep = blockIdx.x;
  const int t = threadIdx.x;

  // shared tables of this replica: A poses, B poses, depths, A sites
  extern __shared__ float smem[];
  float* s_ax = smem;
  float* s_ay = s_ax + na;
  float* s_adx = s_ay + na;
  float* s_ady = s_adx + na;
  float* s_bc = s_ady + na;        // [nb][3]
  float* s_bq = s_bc + 3 * nb;     // [nb][4]
  int* s_depth = reinterpret_cast<int*>(s_bq + 4 * nb);  // [n]: A then B
  int* s_site = s_depth + n;       // [na]

  const bool is_a = t < na;
  const bool is_b = t >= na && t < n;
  const int bi = t - na;

  // ---- load: own pose and topology into shared memory / registers ----
  int trans = -1, site = -1, cis = -1, bp0 = -1, bp1 = -1, bp2 = -1;
  int laid = 0, root = 0, active = 0;
  if (is_a) {
    const size_t i = static_cast<size_t>(rep) * na + t;
    s_ax[t] = a_xy[2 * i];
    s_ay[t] = a_xy[2 * i + 1];
    s_adx[t] = a_dir[2 * i];
    s_ady[t] = a_dir[2 * i + 1];
    trans = a_trans[i];
    site = a_site[i];
    cis = a_cis[i];
    s_site[t] = site;
  } else if (is_b) {
    const size_t j = static_cast<size_t>(rep) * nb + bi;
    for (int c = 0; c < 3; ++c) s_bc[3 * bi + c] = b_center[3 * j + c];
    for (int c = 0; c < 4; ++c) s_bq[4 * bi + c] = b_quat[4 * j + c];
    bp0 = b_partner[3 * j];
    bp1 = b_partner[3 * j + 1];
    bp2 = b_partner[3 * j + 2];
    laid = b_laid[j];
  }
  if (t < n) {
    const size_t k = static_cast<size_t>(rep) * n + t;
    root = is_root[k];
    active = act[k];
  }
  int depth = root == 1 ? 0 : kInf;
  if (t < n) s_depth[t] = depth;
  __syncthreads();

  // ---- 1. BFS depth by synchronous min-propagation ----
  const int ab = clampi(trans - na, 0, nb - 1);   // A -> its trans B
  const int ac = clampi(cis, 0, na - 1);          // A -> its cis A
  const int b0 = clampi(bp0, 0, na - 1), b1 = clampi(bp1, 0, na - 1),
            b2 = clampi(bp2, 0, na - 1);
  for (int round = 0; round < p.depth; ++round) {
    int nd = depth;
    if (is_a) {
      const int gt = trans >= 0 ? s_depth[na + ab] + 1 : kInf;
      const int gc = cis >= 0 ? s_depth[ac] + 1 : kInf;
      nd = min(nd, min(gt, gc));
    } else if (is_b) {
      if (bp0 >= 0) nd = min(nd, s_depth[b0] + 1);
      if (bp1 >= 0) nd = min(nd, s_depth[b1] + 1);
      if (bp2 >= 0) nd = min(nd, s_depth[b2] + 1);
    }
    __syncthreads();
    depth = nd;
    if (t < n) s_depth[t] = depth;
    __syncthreads();
  }

  // ---- 2. parent = first neighbour column at depth - 1 ----
  bool from_trans = false, from_cis = false;
  int parent_b = -1;
  if (is_a) {
    const int pt = trans >= 0 ? s_depth[na + ab] : kInf;
    const int pc = cis >= 0 ? s_depth[ac] : kInf;
    from_trans = pt == depth - 1;
    from_cis = !from_trans && pc == depth - 1;
  } else if (is_b) {
    const int p0 = bp0 >= 0 ? s_depth[b0] : kInf;
    const int p1 = bp1 >= 0 ? s_depth[b1] : kInf;
    const int p2 = bp2 >= 0 ? s_depth[b2] : kInf;
    parent_b = p0 == depth - 1 ? bp0
             : p1 == depth - 1 ? bp1
             : p2 == depth - 1 ? bp2 : -1;
  }
  const int pa = clampi(parent_b, 0, na - 1);     // B -> chosen parent A

  // ---- 3. root ligand lay-down in place ----
  int laid_new = laid;
  if (is_b && root == 1 && active == 1 && laid == 0) {
    float* q = s_bq + 4 * bi;
    const float tx = p.bead1[0], ty = p.bead1[1], tz = p.bead1[2];
    float bdx, bdy;
    rot_xy(q[0], q[1], q[2], q[3], tx, ty, tz, &bdx, &bdy);
    float w, z;
    quat_z_cs(tx * bdx + ty * bdy, tx * bdy - ty * bdx, &w, &z);
    q[0] = w;
    q[1] = 0.0f;
    q[2] = 0.0f;
    q[3] = z;
    s_bc[3 * bi + 2] = p.plane_z;
    laid_new = 1;
  }

  // template vectors of the ligand bead this receptor binds (site 1..3),
  // and, for a ligand, of the bead its parent receptor binds
  const int sj = clampi(site, 1, 3) - 1;
  const float svx = p.site[sj][0], svy = p.site[sj][1], svz = p.site[sj][2];
  const float bvx = p.bead[sj][0], bvy = p.bead[sj][1], bvz = p.bead[sj][2];
  const int pj = clampi(s_site[pa], 1, 3) - 1;
  const float ghx = p.bead[pj][0], ghy = p.bead[pj][1];
  __syncthreads();

  // ---- 4. snap sweeps, depth 1 .. align_depth ----
  int snap = 0;
  for (int d = 1; d <= p.depth; ++d) {
    // A children: read parents, barrier, write
    const bool sel_a = is_a && active == 1 && depth == d &&
                       (from_trans || from_cis);
    float nx = 0.0f, ny = 0.0f, ndx = 0.0f, ndy = 0.0f;
    if (sel_a && from_trans) {
      const float* q = s_bq + 4 * ab;
      const float cpx = s_bc[3 * ab], cpy = s_bc[3 * ab + 1];
      float sx, sy, bx, by;
      rot_xy(q[0], q[1], q[2], q[3], svx, svy, svz, &sx, &sy);
      rot_xy(q[0], q[1], q[2], q[3], bvx, bvy, bvz, &bx, &by);
      const float bsx = cpx + sx, bsy = cpy + sy;
      float utx = bsx - (cpx + bx);
      float uty = bsy - (cpy + by);
      const float un = fmaxf(sqrtf(utx * utx + uty * uty), 1e-9f);
      utx = utx / un;
      uty = uty / un;
      nx = bsx + p.t_off0 * utx;
      ny = bsy + p.t_off0 * uty;
      ndx = -utx;
      ndy = -uty;
    } else if (sel_a) {
      const float uxp = s_adx[ac], uyp = s_ady[ac];
      nx = s_ax[ac] - p.ra * uxp - p.c_off0 * uxp;
      ny = s_ay[ac] - p.ra * uyp - p.c_off0 * uyp;
      ndx = -uxp;
      ndy = -uyp;
    }
    __syncthreads();
    if (sel_a) {
      s_ax[t] = nx;
      s_ay[t] = ny;
      s_adx[t] = ndx;
      s_ady[t] = ndy;
      snap = 1;
    }
    __syncthreads();

    // B children: re-seat on this round's receptor poses
    if (is_b && active == 1 && depth == d && parent_b >= 0) {
      const float ux2 = s_adx[pa], uy2 = s_ady[pa];
      const float cx2 = s_ax[pa] + p.ra_seat * ux2;
      const float cy2 = s_ay[pa] + p.ra_seat * uy2;
      float w, z;
      quat_z_cs(ghx * (-ux2) + ghy * (-uy2), ghx * (-uy2) - ghy * (-ux2), &w,
                &z);
      float* c = s_bc + 3 * bi;
      float* q = s_bq + 4 * bi;
      c[0] = cx2;
      c[1] = cy2;
      c[2] = p.plane_z;
      q[0] = w;
      q[1] = 0.0f;
      q[2] = 0.0f;
      q[3] = z;
      laid_new = 1;
    }
    __syncthreads();
  }

  // ---- 5. unreached markers and outputs ----
  const bool unreached = active == 1 && root == 0 && depth >= kInf;
  if (is_a) {
    const size_t i = static_cast<size_t>(rep) * na + t;
    o_a_xy[2 * i] = s_ax[t];
    o_a_xy[2 * i + 1] = s_ay[t];
    o_a_dir[2 * i] = s_adx[t];
    o_a_dir[2 * i + 1] = s_ady[t];
    o_snap[i] = unreached ? 2 : snap;
  } else if (is_b) {
    const size_t j = static_cast<size_t>(rep) * nb + bi;
    for (int c = 0; c < 3; ++c) o_b_center[3 * j + c] = s_bc[3 * bi + c];
    for (int c = 0; c < 4; ++c) o_b_quat[4 * j + c] = s_bq[4 * bi + c];
    o_b_laid[j] = unreached ? laid_new + 2 : laid_new;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for na receptors and nb ligands.
int kmc_align_batched_smem(int na, int nb) {
  return static_cast<int>((4 * na + 7 * nb) * sizeof(float) +
                          (2 * na + nb) * sizeof(int));
}

// Launches one block per replica on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): nonzero when the launch was refused.
int kmc_align_batched(const AlignParams* params, int batch, const float* a_xy,
                      const float* a_dir, const float* b_center,
                      const float* b_quat, const int* a_trans,
                      const int* a_site, const int* a_cis,
                      const int* b_partner, const int* b_laid,
                      const int* is_root, const int* act, float* o_a_xy,
                      float* o_a_dir, int* o_snap, float* o_b_center,
                      float* o_b_quat, int* o_b_laid, void* stream) {
  const AlignParams p = *params;
  const int n = p.na + p.nb;
  const int threads = ((n + 31) / 32) * 32;
  const int smem = kmc_align_batched_smem(p.na, p.nb);
  if (batch > 0) {
    align_batched_kernel<<<batch, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        p, a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis, b_partner,
        b_laid, is_root, act, o_a_xy, o_a_dir, o_snap, o_b_center, o_b_quat,
        o_b_laid);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
