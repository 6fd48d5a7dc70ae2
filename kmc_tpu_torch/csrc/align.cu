// Single-replica idealize core: kernel K2 of the port.
//
// Replaces the Pallas TPU kernel kmc_tpu/ops/pallas_align.py
// (_align_kernel, built by _core_for, entered by align_core): the
// idealize core of the single trajectory, which every step of step_fn,
// run and the CLI without --replicas runs once.  It computes the core of
// align_core.cuh for one replica: BFS depth, parents, root lay-down,
// align_depth snap sweeps and the unreached markers.
//
// Operands are the TPU kernel's: the integer topology as [n, 1] columns
// (a_trans, a_site, a_cis [na, 1]; b_laid [nb, 1]; is_root, act [n, 1]),
// receptor directions (cos psi, sin psi) in and out, and the ligand
// template f32[4, 4, 3] as an input, as the TPU kernel takes it; out come
// the snapped poses, the snap codes 0/1/2 [na, 1] and the laid bits
// [nb, 1] (bit 0 laid, bit 1 unreached).
//
// Design.  The TPU kernel gathers by one-hot [n, n] matrix products on the
// MXU, because Mosaic has no dynamic gather.  Here one thread block holds
// the replica, one thread per molecule, with its poses, depths and site
// indices in shared memory and real indexed loads, and runs one pass per
// depth level with one barrier a pass, stopping at the deepest level
// present (align_core.cuh states the invariant).  Each thread reads from
// the template in device memory only the rows it uses (its own site row,
// the three bead rows a ligand's parent may bind, bead 1 for a root
// ligand); the by-value parameters are never written, so they stay in the
// constant bank.  The body is K1's, so K1 at batch 1 and K2 give the same
// bits.
//
// Bound.  At SimConfig() (150 + 50 molecules) one call reads 8,192 bytes
// (the template included) and writes 4,600: 12.8 KB, about 0.004 us at
// 3.35 TB/s.  One block of 224 threads on one SM runs a chain of at most
// align_depth + 1 barrier-separated phases, so the launch and the phases'
// latency bound it, not bytes or flops.

#include "align_core.cuh"

namespace {

__global__ void align_single_kernel(
    AlignParams p, const float* __restrict__ tmpl,
    const float* __restrict__ a_xy, const float* __restrict__ a_dir,
    const float* __restrict__ b_center, const float* __restrict__ b_quat,
    const int* __restrict__ a_trans, const int* __restrict__ a_site,
    const int* __restrict__ a_cis, const int* __restrict__ b_partner,
    const int* __restrict__ b_laid, const int* __restrict__ is_root,
    const int* __restrict__ act, float* __restrict__ o_a_xy,
    float* __restrict__ o_a_dir, int* __restrict__ o_snap,
    float* __restrict__ o_b_center, float* __restrict__ o_b_quat,
    int* __restrict__ o_b_laid) {
  kmc_core::align_replica(p, kmc_core::GlobalTemplate{tmpl}, 0, a_xy, a_dir,
                          b_center, b_quat, a_trans, a_site, a_cis, b_partner,
                          b_laid, is_root, act, o_a_xy, o_a_dir, o_snap,
                          o_b_center, o_b_quat, o_b_laid);
}

}  // namespace

extern "C" {

// Shared memory the block needs for na receptors and nb ligands.
int kmc_align_smem(int na, int nb) { return kmc_core::smem_bytes(na, nb); }

// Launches the one block on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): nonzero when the launch was refused.  The template
// fields of `params` are not read: the kernel takes them from `tmpl`.
int kmc_align(const AlignParams* params, const float* tmpl, const float* a_xy,
              const float* a_dir, const float* b_center, const float* b_quat,
              const int* a_trans, const int* a_site, const int* a_cis,
              const int* b_partner, const int* b_laid, const int* is_root,
              const int* act, float* o_a_xy, float* o_a_dir, int* o_snap,
              float* o_b_center, float* o_b_quat, int* o_b_laid,
              void* stream) {
  const AlignParams p = *params;
  const int threads = kmc_core::block_threads(p.na, p.nb);
  const int smem = kmc_core::smem_bytes(p.na, p.nb);
  align_single_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, tmpl, a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis,
      b_partner, b_laid, is_root, act, o_a_xy, o_a_dir, o_snap, o_b_center,
      o_b_quat, o_b_laid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
