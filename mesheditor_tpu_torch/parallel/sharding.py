"""Multi-device scaling over torch.distributed (counterpart of
mesheditor_tpu/parallel/sharding.py).

The reference is one controller over a jax.sharding.Mesh: GSPMD partitions the element and
object axes and inserts a psum wherever a replicated result reads sharded data. The port is
SPMD instead: one process per rank (parallel/launch.py), every rank runs the same calls, and
each of those reduction points is an explicit collective:

- tp (tensor-parallel analog): one large eigensolve shards its ELEMENTS. Each rank holds a
  contiguous slice, applies it to the replicated panel, and one all_reduce over the tp
  group completes every element sum (the applies and diagonals in fem/assembly.py, the
  coarse Galerkin pencil and the smoothed-aggregation volume spread in solve/amg.py, the
  host path's whole pencil in solve/lobpcg.py). The sum of the partials is the whole
  apply only if every rank holds the same panel, so the replicated work must give the
  same bits on every rank: it is made of deterministic operations on summed (hence
  bit-equal) data (the AMG restrict is a fixed-order segmented sum for that reason), and
  host decisions that gate a collective take the group's first rank's values
  (solve/eigs.py, solve/lobpcg.py).
- dp (data-parallel analog): the polyphonic render shards the OBJECTS. Each rank keeps a
  contiguous block of the bank and renders it through the same impact or coupled kernel;
  the event, voice and track tables stay replicated, driven by the same host calls on every
  rank; the resonator mix is an all_reduce over the dp group, the click is added once after
  it, and each voice's carries come from the rank that owns its object.

Every collective is a sum all_reduce or a broadcast, the two that gloo also does on CUDA
tensors, so one code path runs under NCCL (a card per rank) and gloo (ranks sharing a card,
or the CPU). A gather is the all_reduce of a zero-padded buffer, which is exact. Slices are
contiguous and as even as the count allows: uneven slices need no padding.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.distributed as dist

# Collectives this process has made through this layer, and the bytes each rank handed in.
ALL_REDUCES = 0
ALL_REDUCE_BYTES = 0
BROADCASTS = 0


def _bounds(n: int, parts: int, index: int) -> tuple[int, int]:
    """[lo, hi) of part `index` when n items are cut into `parts` contiguous parts."""
    return n * index // parts, n * (index + 1) // parts


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a device mesh: the size of each axis (`shape[axis]`, as the
    reference's call sites read it), the rank's index along each axis, one process group
    per axis (the ranks that differ from this one along that axis only) and the rank's
    device."""

    shape: dict
    coords: dict
    groups: dict
    device: torch.device


def make_mesh(n_devices: int | None = None, axis_names=("dp", "tp"), *, device) -> Mesh:
    """A mesh over the ranks of the default process group, on this rank's `device`. 1-D
    puts every rank on the one axis; 2-D factors n into dp x tp with the largest tp <=
    sqrt(n) that divides n (prime and small counts degenerate tp to 1), rank r at
    (r // tp, r % tp). Every rank must call this, in the same order as its other
    collectives: each axis group is created by all ranks (torch.distributed.new_group)."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh({n}): the process group has {world} ranks; a mesh "
                         "covers every rank")
    rank = dist.get_rank()
    names = tuple(axis_names)
    if len(names) == 1:
        return Mesh({names[0]: n}, {names[0]: rank},
                    {names[0]: dist.new_group(list(range(n)))}, torch.device(device))
    if len(names) != 2:
        raise ValueError(f"a mesh has one or two axes, not {names}")
    tp = next(c for c in range(int(np.sqrt(n)), 0, -1) if n % c == 0)
    dp = n // tp
    grid = np.arange(n).reshape(dp, tp)
    groups = {}
    for axis, rows in ((names[1], grid), (names[0], grid.T)):
        for row in rows:  # every rank creates every group, in the same order
            g = dist.new_group(row.tolist())
            if rank in row:
                groups[axis] = g
    return Mesh({names[0]: dp, names[1]: tp}, {names[0]: rank // tp, names[1]: rank % tp},
                groups, torch.device(device))


def _group_sum(t: torch.Tensor, group) -> torch.Tensor:
    global ALL_REDUCES, ALL_REDUCE_BYTES
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    ALL_REDUCES += 1
    ALL_REDUCE_BYTES += t.numel() * t.element_size()
    return t


@dataclass(frozen=True)
class ElementSlice:
    """This rank's contiguous slice [lo, lo + len) of the n_elements elements of a
    tensor-parallel group: the collectives an element-sharded pencil needs."""

    group: object
    lo: int
    n_elements: int
    device: torch.device

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The group's sum of the partial `t` (the same bits on every rank)."""
        return _group_sum(t, self.group)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole element array from each rank's slice: an all_reduce of a zero-padded
        buffer, exact for every dtype."""
        whole = torch.zeros((self.n_elements, *local.shape[1:]), dtype=local.dtype,
                            device=local.device)
        whole[self.lo : self.lo + local.shape[0]] = local
        return self.sum(whole)

    def agree(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as the group's first rank holds it, shape included (broadcast)."""
        global BROADCASTS
        src = dist.get_global_rank(self.group, 0)
        dims = torch.tensor(t.shape, dtype=torch.int64, device=t.device)
        dist.broadcast(dims, src=src, group=self.group)
        shape = tuple(int(d) for d in dims.tolist())
        out = (t.clone().contiguous() if shape == tuple(t.shape)
               else torch.zeros(shape, dtype=t.dtype, device=t.device))
        dist.broadcast(out, src=src, group=self.group)
        BROADCASTS += 2
        return out

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any rank of the group."""
        return bool(self.sum(torch.tensor([float(flag)], device=self.device)).item() > 0)


def shard_element_ops(ops, mesh: Mesh, axis: str = "tp"):
    """The production tensor-parallel entry: the assembled `ElementOperators` re-cut to this
    rank's contiguous slice of the elements, on the mesh's device, with the diagonal fixes
    whole. The result has the same interface; every element sum it makes is summed over the
    `axis` group (fem/assembly.py). Uneven slices need no padding."""
    from ..fem.assembly import ElementOperators

    e = int(ops.elem_nodes.shape[0])
    lo, hi = _bounds(e, mesh.shape[axis], mesh.coords[axis])
    dev = mesh.device
    tp = ElementSlice(mesh.groups[axis], lo, e, dev)

    def part(t):
        return t[lo:hi].to(dev).contiguous()

    # Every replicated array must have the same bits on every rank (the partial applies act
    # on one panel); the fixes come from index_add_ sums, so take the first rank's.
    return ElementOperators(
        elem_nodes=part(ops.elem_nodes),
        k_blocks=part(ops.k_blocks),
        rho_vol=part(ops.rho_vol),
        m_unit=ops.m_unit.to(dev),
        k_fix=tp.agree(ops.k_fix.to(dev)),
        m_fix=tp.agree(ops.m_fix.to(dev)),
        n_dofs=ops.n_dofs,
        tp=tp,
    )


@dataclass(frozen=True)
class ObjectBlock:
    """This rank's contiguous block [lo, hi) of the n_objects objects of a data-parallel
    group: how replicated tables map onto the local bank, and the collectives the render
    needs (synth/impact.py, synth/coupled.py, synth/render.py:finish_block)."""

    group: object
    lo: int
    hi: int
    n_objects: int

    def local(self, obj: int) -> int | None:
        """The local row of global object `obj`, or None when another rank owns it."""
        return obj - self.lo if self.lo <= obj < self.hi else None

    def local_impacts(self, impacts):
        """The impact table as this rank's bank sees it: rows on other ranks' objects are
        inactive, the rest index local objects."""
        mine = impacts.active & (impacts.obj >= self.lo) & (impacts.obj < self.hi)
        return replace(impacts, active=mine, obj=torch.where(mine, impacts.obj - self.lo, 0))

    def local_voices(self, voices):
        """The voice table as this rank's bank sees it: a voice on another rank's object
        gets object -1, which no render step reads."""
        mine = (voices.obj >= self.lo) & (voices.obj < self.hi)
        return voices.replace(obj=torch.where(mine, voices.obj - self.lo, -1))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return _group_sum(t, self.group)

    def owned(self, voices, carry: torch.Tensor) -> torch.Tensor:
        """A voice carry after a block, with each live voice's row taken from the rank that
        owns its object (a masked all_reduce), so the replicated voice table stays equal on
        every rank. Other rows are the same on every rank already."""
        live = voices.active & (voices.obj >= 0) & (voices.obj < self.n_objects)
        mine = live & (voices.obj >= self.lo) & (voices.obj < self.hi)
        total = self.sum(torch.where(mine, carry, torch.zeros_like(carry)))
        return torch.where(live, total, carry)


def shard_synth(synth, mesh: Mesh, axis: str = "dp"):
    """Object-shard a live ModalSynth: the bank params and resonator state keep this rank's
    contiguous block of objects (the DealObjects analog, ModalAudio.cpp:708-740); the impact
    table, voice table and track pool stay replicated, and every rank must drive them with
    the same host calls. Each rank renders its objects through the same impact or coupled
    kernel as an unsharded synth; the mix reduces over the `axis` group. Unlike the
    reference (sharding.py:129), the kernels stay on: each shard is one device's program."""
    from ..synth.bank import BankParams, BankState

    if synth.shard is not None:
        raise ValueError("the synth is sharded already")
    if synth.device != mesh.device:
        raise ValueError(f"the synth lives on {synth.device}, the mesh on {mesh.device}")
    o = synth.n_objects
    n_sh = mesh.shape[axis]
    if o < n_sh:
        raise ValueError(f"{o} objects cannot fill {n_sh} {axis} ranks")
    lo, hi = _bounds(o, n_sh, mesh.coords[axis])
    p = synth.params
    synth.params = BankParams(
        coeff_re=p.coeff_re[lo:hi].contiguous(), coeff_im=p.coeff_im[lo:hi].contiguous(),
        disp_scale=p.disp_scale[lo:hi].contiguous(), shapes=p.shapes[lo:hi].contiguous(),
        out_gain=p.out_gain[lo:hi].contiguous(), sample_rate=p.sample_rate)
    synth.state = BankState(z_re=synth.state.z_re[lo:hi].contiguous(),
                            z_im=synth.state.z_im[lo:hi].contiguous())
    synth.shard = ObjectBlock(mesh.groups[axis], lo, hi, o)
    return synth


def shard_elements(elem_dofs, k_blocks, rho_vol, mesh: Mesh, axis: str = "tp"):
    """This rank's contiguous slice of the element arrays (numpy or torch), on the mesh's
    device: (elem_dofs (E_r, 30) int64, k_blocks (E_r, 30, 30), rho_vol (E_r,))."""
    e = int(np.shape(elem_dofs)[0])
    lo, hi = _bounds(e, mesh.shape[axis], mesh.coords[axis])
    dev = mesh.device
    return (torch.as_tensor(np.asarray(elem_dofs)[lo:hi], dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(k_blocks)[lo:hi], device=dev),
            torch.as_tensor(np.asarray(rho_vol)[lo:hi], device=dev))


def sharded_pencil_ops(mesh: Mesh, elem_dofs, k_blocks, rho_vol, m_unit, n_dofs, axis="tp"):
    """Matrix-free K@X / M@X (no diagonal fixes, as the reference's) with this rank's
    element slice from shard_elements and X replicated: each rank computes its partial
    scatter and an all_reduce over the `axis` group completes the sum."""
    from ..fem.assembly import _apply_node

    group = mesh.groups[axis]
    nodes = (elem_dofs[:, 0::3] // 3).contiguous()  # (E_r, 10): dof 3a+c is node a
    m_unit = torch.as_tensor(np.asarray(m_unit), device=mesh.device)

    def kmat(x):
        return _group_sum(_apply_node(nodes, k_blocks, x, n_dofs), group)

    def mmat(x):
        return _group_sum(_apply_node(nodes, (rho_vol, m_unit), x, n_dofs), group)

    return kmat, mmat


def sharded_subspace_step(mesh: Mesh, kmat, mmat, axis="tp"):
    """One Rayleigh-Ritz subspace-refinement step over the sharded pencil. The X panel is
    replicated; the matvecs run element-sharded under `kmat`/`mmat` (which all_reduce
    internally), and the small dense Rayleigh-Ritz is the same on every rank."""

    def step(x, sigma):
        kx = kmat(x)
        mx = mmat(x)
        a = x.T @ (kx - sigma * mx)
        b = x.T @ mx
        a = 0.5 * (a + a.T)
        b = 0.5 * (b + b.T)
        bw, bu = torch.linalg.eigh(b)
        good = bw > 1e-12 * bw.abs().max()
        inv_sqrt = torch.where(good, 1.0 / torch.sqrt(torch.where(good, bw, 1.0)), 0.0)
        w = bu * inv_sqrt[None, :]
        h = w.T @ a @ w
        theta, q = torch.linalg.eigh(0.5 * (h + h.T))
        return x @ (w @ q), theta + sigma

    return step


def batched_render_step(mesh: Mesh, axis="dp"):
    """Object-sharded resonator advance, plain torch at the inputs' dtype: each rank
    advances its contiguous block of the (O, K) grid for one block of samples and the mono
    mix reduces with an all_reduce over the `axis` group, the data-parallel analog of the
    reference's DealObjects worker split. step(z_re, z_im, c_re, c_im, out_gain, excite_t)
    takes the whole (replicated) arrays and returns (this rank's z_re, z_im, the mix (S,))."""
    group = mesh.groups[axis]
    n_sh, index = mesh.shape[axis], mesh.coords[axis]

    def step(z_re, z_im, c_re, c_im, out_gain, excite_t):
        lo, hi = _bounds(z_re.shape[0], n_sh, index)
        zr, zi, cr, ci = (t[lo:hi] for t in (z_re, z_im, c_re, c_im))
        g = out_gain[lo:hi, None]
        out = torch.empty(excite_t.shape[0], dtype=z_re.dtype, device=z_re.device)
        for s in range(excite_t.shape[0]):
            zr, zi = zr * cr - zi * ci + excite_t[s], zr * ci + zi * cr
            out[s] = (g * zi).sum()
        return zr, zi, _group_sum(out, group)

    return step
