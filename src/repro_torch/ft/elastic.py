"""Elastic reconfiguration: shrink/regrow the data axis after host loss.

Counterpart of the reference's ``repro/ft/elastic.py``.  The checkpoint
format is mesh-agnostic (whole logical arrays, restored and then placed
under the NEW mesh's shardings), so elasticity reduces to:
  1. pick the largest viable data-axis size for the surviving hosts
     (:func:`plan_reshard`),
  2. rebuild the mesh (:func:`build_mesh`),
  3. restore the last checkpoint and place it under the new shardings
     (:func:`reshard_tree`, the reference's ``jax.device_put``),
  4. rescale the data pipeline (global batch keeps its size by growing the
     per-host microbatch, or shrinks if configured).
"""
from __future__ import annotations

import dataclasses

from ..launch.mesh import _mesh
from ..parallel import sharding as shd


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: dict
    new_shape: dict
    lost_hosts: int
    batch_policy: str          # "keep_global" | "shrink"
    note: str = ""


def plan_reshard(mesh, n_failed_hosts: int, devices_per_host: int = 4,
                 batch_policy: str = "keep_global") -> ElasticPlan:
    """Largest data-axis size that fits the surviving device count while
    keeping the model axis intact (TP degree is architectural)."""
    old = shd.axis_sizes(mesh)
    model = old.get("model", 1)
    pod = old.get("pod", 1)
    total = 1
    for v in old.values():
        total *= v
    surviving = total - n_failed_hosts * devices_per_host
    new_data = surviving // (model * pod)
    if new_data < 1:
        raise RuntimeError("not enough devices for one data replica")
    new = dict(old)
    new["data"] = new_data
    return ElasticPlan(old_shape=old, new_shape=new,
                       lost_hosts=n_failed_hosts,
                       batch_policy=batch_policy,
                       note=f"{surviving}/{total} devices")


def build_mesh(plan: ElasticPlan, device="cuda"):
    """The plan's new mesh: a DeviceMesh over the first ranks of the
    default process group, on ``device``'s type (raises without a GPU for
    ``"cuda"``)."""
    return _mesh(tuple(plan.new_shape.values()),
                 tuple(plan.new_shape.keys()), device)


def reshard_tree(tree, spec_tree, new_mesh, rules=None):
    """``distribute_tensor`` every leaf of ``tree`` under the new mesh's
    shardings of its ParamSpec in ``spec_tree`` (same structure); returns
    the tree of DTensors (``parallel/sharding.py::place_tree``)."""
    return shd.place_tree(tree, spec_tree, new_mesh, rules)
