"""Elastic scaling: reshape the training job onto a different mesh.

Port of ``src/repro/ckpt/elastic.py``. On failure of a node the
controller restarts with fewer (or more) ranks; checkpoints hold whole
leaves (host arrays + manifest; param shards and ZeRO-1 slices are
gathered on save, ``CheckpointManager(dp=...)``), so a restore onto the
new mesh only cuts them again. :func:`plan_rescale` derives the rescale
plan and validates batch divisibility (copied, imports rewritten);
:func:`reshard_state` is rewritten: the reference ``device_put``s the
state onto the new mesh's shardings, the port cuts a whole state into
this rank's part of the new world's mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.bench.spec import Placement
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding as sh


@dataclass
class RescalePlan:
    old_shape: tuple
    new_shape: tuple
    new_axes: tuple
    global_batch: int
    note: str


def _as_placement(old: Union[Placement, dict, str, int, tuple]) -> Placement:
    """Normalize the pre-failure mesh spelling. Bare tuples are the
    legacy ``(data, model)`` mesh shape; everything else goes through
    :meth:`Placement.of` so axes are named, not positional."""
    if isinstance(old, tuple):
        if len(old) == 1:
            return Placement.of({"dp": old[0]})
        if len(old) == 2:
            return Placement.of({"dp": old[0], "tp": old[1]})
        raise ValueError(
            f"ambiguous bare mesh shape {old!r}; pass a Placement "
            f"(e.g. {{'dp': 4, 'tp': 2}}) so axes are named")
    return Placement.of(old)


def plan_rescale(c: ModelConfig, shape: ShapeConfig,
                 old_placement: Union[Placement, dict, str, int, tuple],
                 lost_devices: int) -> RescalePlan:
    """Shrink the data axis to the largest feasible size after losing
    ``lost_devices`` chips; keep the model axis (TP degree is a property
    of the model fit, not of cluster health).

    Only dp/tp placements are rescalable here: a pipeline (``pp``) or
    pod axis changes the program, not just the shardings, so those are
    rejected rather than silently mis-planned.
    """
    p = _as_placement(old_placement)
    sizes = p.dict()
    unsupported = sorted(a for a, n in sizes.items()
                         if a not in ("dp", "tp") and n > 1)
    if unsupported:
        raise ValueError(
            f"plan_rescale supports dp/tp placements only; cannot rescale "
            f"axes {unsupported} of {p.label!r} (a pipeline/pod mesh needs "
            f"a stage-aware plan, not a data-axis shrink)")
    model = sizes.get("tp", 1)
    old_total = p.n_devices
    avail = old_total - lost_devices
    new_data = avail // model
    # batch must stay divisible by the data axis
    while new_data > 1 and shape.global_batch % new_data != 0:
        new_data -= 1
    if new_data < 1:
        raise ValueError("not enough devices for TP degree")
    return RescalePlan(
        old_shape=(sizes.get("dp", 1), model),
        new_shape=(new_data, model),
        new_axes=("data", "model"),
        global_batch=shape.global_batch,
        note=f"lost {lost_devices} chips -> data axis {new_data}",
    )


def reshard_state(state, c: ModelConfig, plan: RescalePlan,
                  shape: ShapeConfig, mesh: Optional[object] = None):
    """Build the new mesh (collective: the world must hold
    ``plan.new_shape``'s ranks) and its sharding plan, and cut a whole
    ``(params, opt_state)`` into this rank's part (param shards, ZeRO-1
    slices). Returns ``(mesh, sharding plan, (params, opt_state),
    zero)``; ``zero`` is the layout the train step takes."""
    mesh = make_mesh(plan.new_shape, plan.new_axes) if mesh is None \
        else mesh
    p = sh.make_plan(c, mesh, shape)
    params, opt_state = state
    params, opt_state, zero = sh.shard_train_state(p, params, opt_state, c)
    return mesh, p, (params, opt_state), zero
