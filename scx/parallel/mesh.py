"""Device mesh / sharding — the engine's distributed backend.

The reference is a single-process engine with no networking (SURVEY §2
parallelism item 7); its scale story is thread pools.  This engine's scale
story is SPMD over a jax.sharding.Mesh:

  * 'dp'  — the env/scene axis: thousands of independent city scenes sharded
    across chips (the data-parallel analogue; BASELINE config #2/#5).
  * 'sp'  — a spatial axis: framebuffer tile rows of each env sharded across
    chips (the sequence/spatial-parallel analogue for one big frame).

Collectives ride ICI via jax.lax (psum/all_gather) inside shard_map;
multi-host extends the same mesh over DCN (jax.distributed.initialize by the
launcher).  Everything here works identically on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=N) — that is how the test
suite and the driver's dry run exercise it without N real chips.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(dp: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """Mesh with ('dp','sp') axes; dp defaults to n_devices // sp."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // sp
    assert dp * sp <= n, f"mesh {dp}x{sp} needs {dp*sp} devices, have {n}"
    dev = np.asarray(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(dev, axis_names=("dp", "sp"))


def shard_env_batch(batch, mesh: Mesh):
    """Place a [ENV, ...] pytree with ENV split over 'dp', replicated on 'sp'."""
    def put(x):
        spec = P("dp", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, batch)


def replicate(tree, mesh: Mesh):
    return jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree
    )


def env_sharded(step_fn, mesh: Mesh):
    """jit a per-env-batch step with env-dim in/out shardings over 'dp'."""
    shard = NamedSharding(mesh, P("dp"))

    @functools.partial(jax.jit, in_shardings=shard, out_shardings=shard)
    def run(batch):
        return jax.vmap(step_fn)(batch)

    return run


def psum_stats(stats: dict, axis_names=("dp", "sp")):
    """Cross-device scalar reduction (inside shard_map)."""
    return jax.tree.map(lambda x: jax.lax.psum(x, axis_names), stats)


def all_gather_stats(x, axis_name="dp"):
    return jax.lax.all_gather(x, axis_name)


def sharded_sim_render_step(step_env_fn, render_rows_fn, mesh: Mesh, img_h: int):
    """Build the full distributed step: envs over 'dp', framebuffer rows of
    each env over 'sp', global stats via psum over both axes.

    step_env_fn:    state_slice -> state_slice (per single env)
    render_rows_fn: (state_slice, row0, n_rows) -> [n_rows, W, C] image rows
    Returns f(batch) -> (batch', images [local layout], stats) under jit.
    """
    from jax import shard_map

    sp = mesh.shape["sp"]
    rows_per = img_h // sp

    def local(batch):
        # batch: the local 'dp' slice of envs, replicated over 'sp'
        batch = jax.vmap(step_env_fn)(batch)
        sp_idx = jax.lax.axis_index("sp")
        row0 = sp_idx * rows_per
        images = jax.vmap(lambda s: render_rows_fn(s, row0, rows_per))(batch)
        stats = {"alive": jnp.sum(batch.alive.astype(jnp.int32))}
        stats = jax.tree.map(lambda x: jax.lax.psum(x, ("dp",)), stats)
        return batch, images, stats

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp"),),
        out_specs=(P("dp"), P("dp", "sp", None, None), P()),
        check_vma=False,
    )
    return jax.jit(fn)
