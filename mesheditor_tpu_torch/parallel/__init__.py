"""The multi-device layer over torch.distributed (counterpart of mesheditor_tpu/parallel):
element-sharded solves (tp) and object-sharded renders (dp), one process per rank.
`launch.spawn` starts the ranks; `dryrun.dryrun_multichip` drives both paths."""

from .sharding import (
    make_mesh,
    shard_element_ops,
    shard_synth,
    shard_elements,
    sharded_pencil_ops,
    batched_render_step,
    sharded_subspace_step,
)

__all__ = [
    "make_mesh",
    "shard_element_ops",
    "shard_synth",
    "shard_elements",
    "sharded_pencil_ops",
    "batched_render_step",
    "sharded_subspace_step",
]
