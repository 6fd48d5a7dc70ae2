// Replica-batched idealize core: kernel K1 of the port.
//
// Replaces the Pallas TPU kernel kmc_tpu/ops/pallas_align_batched.py
// (_align_kernel_b, launched by align_core_batched).  For each replica of
// the batch it runs the core of align_core.cuh: BFS depth, parents, root
// lay-down, align_depth snap sweeps and the unreached markers.
//
// Design.  The TPU kernel expressed every gather as a one-hot masked lane
// reduction over [rb, m, n] masks and kept all data struct-of-arrays,
// because Mosaic has no dynamic gather and cannot concatenate lanes.  On
// Hopper none of that is needed: one thread block per replica, one thread
// per molecule, the replica's poses, depths and site indices in shared
// memory, and real indexed loads.  The block runs one pass per depth level
// with one barrier a pass and stops at the deepest level present in its
// replica (align_core.cuh states the invariant).  Nothing carries between
// blocks.
//
// Bound.  At the main path's B = 64 replicas of 150 + 50 molecules the
// kernel reads 8,000 and writes 4,600 bytes per replica: 0.8 MB, a quarter
// of a microsecond at 3.35 TB/s, and a few hundred flops per molecule.  It
// is bound by latency (a chain of at most align_depth + 1 dependent phases
// with block-wide barriers) and launch cost, not by bytes or flops; 64
// blocks fill half of the 132 SMs, and the ensemble CLI's 512 fit in one
// wave when 4 blocks of 224 threads fit an SM.

#include "align_core.cuh"

namespace {

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
  kmc_core::align_replica(p, kmc_core::ParamTemplate{p}, blockIdx.x, a_xy,
                          a_dir, b_center, b_quat, a_trans, a_site, a_cis,
                          b_partner, b_laid, is_root, act, o_a_xy, o_a_dir,
                          o_snap, o_b_center, o_b_quat, o_b_laid);
}

}  // namespace

extern "C" {

// Shared memory one block needs for na receptors and nb ligands.
int kmc_align_batched_smem(int na, int nb) {
  return kmc_core::smem_bytes(na, nb);
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
  const int threads = kmc_core::block_threads(p.na, p.nb);
  const int smem = kmc_core::smem_bytes(p.na, p.nb);
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
