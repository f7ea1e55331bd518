"""Production meshes (torch port of ``repro.launch.mesh``): refused.

The JAX package builds TPU v5e pod meshes here (256 chips as (data=16,
model=16), or 2 pods as (pod=2, data=16, model=16)) and a small mesh over
the host's devices.  The port trains on one card (its one mesh type,
``engine.sharding.ProvisioningMesh``, shards provisioning only), so both
are refused with the port's one reason
(:func:`~repro_torch.engine.sharding.refuse_multi_card`).
"""
from __future__ import annotations

from repro_torch.engine.sharding import refuse_multi_card


def make_production_mesh(*, multi_pod: bool = False):
    refuse_multi_card("make_production_mesh (TPU v5e pods)")


def make_host_mesh(model: int | None = None):
    refuse_multi_card("make_host_mesh")
