"""Halo exchange for domain-decomposed lattices (port of
``kmc_tpu/parallel/halo.py``).

The grid is cut over a ``grid_mesh`` (nx, ny) of ranks: rank (ix, iy) owns
the block of rows ``ix * H / nx ...`` and columns ``iy * W / ny ...``, and
holds it as a LatticeState of that block (step, seed and time are the
same on every rank).  One lattice step reads neighbours through four
chained sub-passes, so a block needs width-4 ghost strips from its four
neighbours, corners included:

* ``halo_pad`` pulls them with ``dist.batch_isend_irecv``, rows first (the
  top strip is the upper neighbour's last rows), then the columns of the
  row-padded block, so the corners come from the diagonal neighbours.  On
  an axis of one rank the pulled strip is the rank's own, as ``ppermute``
  gives there, and nothing is sent.  ``refresh_ghosts`` does the same in
  place on a block that is padded already.
* ``halo_chunk`` pads once, runs a step function on the padded block at
  its global origin (row0 - 4, col0 - 4) each step, refreshing the ghost
  strips between steps, and crops the interior once.  It is the one body
  of ``make_halo_lattice_step`` (the plain step), ``make_halo_pallas_step``
  (``lattice_block_call``: the kernel K3 on the card, the plain version on
  CPU tensors) and ``lattice/step.py:make_sharded_lattice_step`` (K3 over
  a chunk).  The block wraps onto itself, but a step reaches only 4
  cells, so the wrap touches ghost cells alone.

The hashes and the parity of a step are functions of global coordinates,
step and seed, so the decomposition changes no bit.  The ghost strips of
two messages between the same pair of ranks are posted in the same order
on both sides (NCCL matches them by order) and carry distinct tags (gloo
matches by tag).
"""

from __future__ import annotations

import torch

from kmc_tpu_torch.config import LatticeConfig
from kmc_tpu_torch.lattice.grid import LatticeState
from kmc_tpu_torch.parallel.mesh import GridMesh

HALO = 4   # ghost width of one lattice step


def block_origin(cfg: LatticeConfig, mesh: GridMesh) -> tuple[int, int]:
    """Global (row, column) of this rank's block's first cell; checks that
    the grid cuts into even blocks of at least HALO cells a side (K3 pairs
    cells by parity)."""
    nx, ny = mesh.shape
    if cfg.height % nx or cfg.width % ny:
        raise ValueError(f"a {cfg.height} x {cfg.width} grid does not cut "
                         f"into {nx} x {ny} equal blocks")
    lh, lw = cfg.height // nx, cfg.width // ny
    if lh % 2 or lw % 2 or min(lh, lw) < HALO:
        raise ValueError(f"blocks of {lh} x {lw}: each side must be even "
                         f"and at least {HALO}")
    return mesh.coords[0] * lh, mesh.coords[1] * lw


def _pull(pairs, prev: int, nxt: int, n: int):
    """For each (last, first) strip pair along an axis of ``n`` ranks: the
    previous rank's ``last`` strip and the next rank's ``first`` strip."""
    if n == 1:
        return list(pairs)
    import torch.distributed as dist

    ops, got = [], []
    for k, (last, first) in enumerate(pairs):
        last, first = last.contiguous(), first.contiguous()
        from_prev, from_next = torch.empty_like(last), torch.empty_like(first)
        ops += [dist.P2POp(dist.isend, last, nxt, tag=2 * k),
                dist.P2POp(dist.isend, first, prev, tag=2 * k + 1),
                dist.P2POp(dist.irecv, from_prev, prev, tag=2 * k),
                dist.P2POp(dist.irecv, from_next, nxt, tag=2 * k + 1)]
        got.append((from_prev, from_next))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def refresh_ghosts(padded, mesh: GridMesh, width: int = HALO) -> None:
    """Rewrite, in place, the ghost frame of padded blocks
    [h + 2 width, w + 2 width(, c)] from the neighbours' interiors: full
    padded rows first, then full padded columns, so the corners come from
    the diagonal neighbours.  The interiors are not touched."""
    nx, ny = mesh.shape
    h = padded[0].shape[0] - 2 * width
    w = padded[0].shape[1] - 2 * width
    rows = _pull([(p[h:h + width], p[width:2 * width]) for p in padded],
                 mesh.up, mesh.down, nx)
    for p, (top, bot) in zip(padded, rows):
        p[:width] = top
        p[h + width:] = bot
    cols = _pull([(p[:, w:w + width], p[:, width:2 * width]) for p in padded],
                 mesh.left, mesh.right, ny)
    for p, (left, right) in zip(padded, cols):
        p[:, :width] = left
        p[:, w + width:] = right


def halo_pad_blocks(blocks, mesh: GridMesh, width: int = HALO):
    """``halo_pad`` of several [h, w(, c)] blocks, their strips sent
    together: each body copied once into a new padded buffer, then its
    ghost frame filled by ``refresh_ghosts``."""
    out = []
    for b in blocks:
        p = b.new_empty((b.shape[0] + 2 * width, b.shape[1] + 2 * width,
                         *b.shape[2:]))
        p[width:-width, width:-width] = b
        out.append(p)
    refresh_ghosts(out, mesh, width)
    return out


def halo_pad(local, width: int, mesh: GridMesh):
    """A local [h, w(, c)] block padded with ``width``-cell periodic ghost
    strips pulled from the four neighbours: [h + 2 width, w + 2 width(, c)]."""
    return halo_pad_blocks([local], mesh, width)[0]


def crop(padded, width: int = HALO):
    """The interior of a padded block, contiguous."""
    return padded[width:-width, width:-width].contiguous()


def halo_chunk(cfg: LatticeConfig, mesh: GridMesh, step_arrays, n: int):
    """``n`` steps of this rank's block (a LatticeState of the block)
    through ``step_arrays`` (the plain step, or K3's wrapper): pad once;
    each step refreshes the ghost strips (after the first) and runs
    ``step_arrays`` on the padded block at its global origin
    (row0 - 4, col0 - 4); crop once at the end.  The pad, the refreshes
    and the crop are torch.profiler ranges (``halo.pad``, ``halo.refresh``,
    ``halo.crop``), which the halo timing reads; a few microseconds of host
    time each when no profiler runs."""
    span = torch.profiler.record_function
    row0, col0 = block_origin(cfg, mesh)

    def f(state: LatticeState) -> LatticeState:
        with span("halo.pad"):
            grid, disp = halo_pad_blocks([state.grid, state.disp], mesh)
        step, time = state.step, state.time
        for i in range(n):
            if i:
                with span("halo.refresh"):
                    refresh_ghosts([grid, disp], mesh)
            grid, disp = step_arrays(grid, disp, step, state.seed, cfg,
                                     row0 - HALO, col0 - HALO)
            step, time = step + 1, time + 1.0
        with span("halo.crop"):
            grid, disp = crop(grid), crop(disp)
        return state._replace(grid=grid, disp=disp, step=step, time=time)

    return f


def make_halo_lattice_step(cfg: LatticeConfig, mesh: GridMesh):
    """One step of this rank's block (a LatticeState of the block): pad,
    the plain step at the padded block's global origin, crop."""
    from kmc_tpu_torch.lattice.step import lattice_step_arrays

    return halo_chunk(cfg, mesh, lattice_step_arrays, 1)


def make_halo_pallas_step(cfg: LatticeConfig, mesh: GridMesh):
    """``make_halo_lattice_step`` through ``lattice_block_call``: the
    kernel K3 on the padded block on the card (one launch a step), the
    plain version on the CPU."""
    from kmc_tpu_torch.ops.lattice import lattice_block_call

    return halo_chunk(cfg, mesh, lattice_block_call, 1)


def shard_lattice(state: LatticeState, cfg: LatticeConfig,
                  mesh: GridMesh) -> LatticeState:
    """This rank's block of a whole-grid state, on its device."""
    r0, c0 = block_origin(cfg, mesh)
    lh, lw = cfg.height // mesh.shape[0], cfg.width // mesh.shape[1]
    dev = mesh.device
    return LatticeState(
        grid=state.grid[r0:r0 + lh, c0:c0 + lw].to(dev).contiguous(),
        disp=state.disp[r0:r0 + lh, c0:c0 + lw].to(dev).contiguous(),
        step=state.step.to(dev), seed=state.seed.to(dev),
        time=state.time.to(dev))


def gather_lattice(state: LatticeState, cfg: LatticeConfig,
                   mesh: GridMesh):
    """The whole grid assembled from every rank's block, on rank 0 (for a
    checkpoint or a comparison); None on the other ranks."""
    from kmc_tpu_torch.parallel.distributed import gather_to_rank0

    nx, ny = mesh.shape
    parts = gather_to_rank0([state.grid[None], state.disp[None]])
    if parts is None:
        return None
    grid, disp = (torch.cat([torch.cat(list(p[i * ny:(i + 1) * ny]), 1)
                             for i in range(nx)], 0) for p in parts)
    return state._replace(grid=grid, disp=disp)
