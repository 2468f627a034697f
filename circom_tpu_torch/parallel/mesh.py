"""The witness batch split over several devices.

The port of the JAX package's parallel/mesh.py.  Witnesses in a batch
are independent, so the batch axis (the last) is cut into one equal
slice a device, as `PartitionSpec(None, None, "batch")` cuts it, and each
slice runs on its device through that device's copy of the program
(`WitnessProgram.for_device`: one plan, carried to each device): no
collective on the witness path.  The R1CS checker runs on each shard's
device the same way, the shards' batch slices in turns; its verdicts,
joined in batch order, are the only reduction.

A mesh is an ordered list of devices and an axis name.  A device may
appear more than once: `[cuda:0] * 4` runs four shards one after another
on one card, and `[cpu] * 8` is the CPU analog of the JAX tests' eight
virtual devices.  Shards on distinct cards are launched one after
another with no host sync between them, so they overlap.  The JAX
module's `use_fused` and `_without_pl_gather` answer Mosaic under
`shard_map` and have no counterpart: a program runs on the backend chosen
at its construction (`mode="scan"` for JAX's `use_fused=False`: the scan
executor at `unroll_threshold=0`, whose tables `for_device` carries to
each device like the fused backends' plans).
"""

from dataclasses import dataclass

import torch

from ..convert import move, u32_on
from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    devices: tuple      # torch.device of each shard, in batch order
    axis: str = "batch"

    def __len__(self):
        return len(self.devices)


def make_mesh(n_devices=None, axis="batch", devices=None):
    """A mesh over `devices` (any list of devices, repeats allowed), or by
    default over the cards, cuda:0 .. cuda:(n_devices - 1), every card
    when n_devices is None.  Without a card, or with fewer cards than
    n_devices, it raises: there is no fallback to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "devices=[torch.device('cpu')] * n for a "
                               "mesh on the CPU")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 0 < n <= count:
            raise ValueError(f"make_mesh: {n} devices asked for, {count} "
                             f"cards present (pass devices= to repeat "
                             f"one)")
        devices = [f"cuda:{i}" for i in range(n)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices, axis)


def split(x, mesh):
    """uint32 (..., B), an array or a tensor -> one uint32 tensor
    (..., B / len(mesh)) a shard, each on its device, in batch order.
    B must be a multiple of the mesh's size."""
    n = len(mesh)
    B = x.shape[-1]
    if B % n:
        raise ValueError(f"a batch of {B} does not split over {n} "
                         f"devices")
    b = B // n
    return [u32_on(x[..., k * b:(k + 1) * b], d).contiguous()
            for k, d in enumerate(mesh.devices)]


def shard_program(program, mesh):
    """A function of uint32 inputs (n_inputs, L, B) that runs
    `program.run` on each shard's device and returns the shard outputs,
    a tuple of uint32 (n_witness, L, B / len(mesh)) tensors in batch
    order, each on its own device."""
    progs = [program.for_device(d) for d in mesh.devices]

    def step(inputs):
        return tuple(p.run(x) for p, x in zip(progs, split(inputs, mesh)))
    return step


def shard_program_mixed(program, mesh):
    """As shard_program over `program.run_mixed`: a tuple, in batch order,
    of (narrow int32 (n_nw, B / n), wide uint32 (n_wd, L, B / n)) a
    shard, the out_specs of the JAX module's shard_program_mixed."""
    progs = [program.for_device(d) for d in mesh.devices]

    def step(inputs):
        return tuple(p.run_mixed(x)
                     for p, x in zip(progs, split(inputs, mesh)))
    return step


def shard_checker(checker, mesh):
    """A function of the shard outputs that runs `checker.check` on each
    shard's device and returns the bool (B,) verdicts in batch order, on
    the mesh's first device.  The checker's batch slices are launched in
    turns, slice s of every shard before slice s + 1 of any, so that the
    cards' checks overlap."""
    checkers = [checker.for_device(d) for d in mesh.devices]
    first = mesh.devices[0]

    def check(shards):
        if len(shards) != len(checkers):
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{len(checkers)}")
        runs = [c.verdicts(z) for c, z in zip(checkers, shards)]
        oks = [[] for _ in runs]
        live = list(range(len(runs)))
        while live:
            for k in list(live):
                v = next(runs[k], None)
                if v is None:
                    live.remove(k)
                else:
                    oks[k].append(v[0])
        return torch.cat([move(torch.cat(o), first) for o in oks])
    return check


def gather(shards):
    """Shard outputs joined on the host along the batch axis: a tensor,
    or for shard_program_mixed's pairs a (narrow, wide) pair."""
    if isinstance(shards[0], tuple):
        return tuple(gather([s[k] for s in shards])
                     for k in range(len(shards[0])))
    dtype = shards[0].dtype
    parts = [s.view(torch.int32).cpu() if dtype == torch.uint32 else s.cpu()
             for s in shards]
    out = torch.cat(parts, dim=-1)
    return out.view(torch.uint32) if dtype == torch.uint32 else out
