"""Clipped-surrogate PPO over the batched city envs, fully on device.

The reference engine has no training story (SURVEY §2 parallelism item 6:
ML-style strategies absent); this module is the capability the rebuild
adds on top of parity.  Shape of the thing:

  * collection: `CityRLEnv.make_trajectory_rollout` scans the FULL engine
    step (physics + traffic + raster) with the actor-critic inline — raw
    observations never cross the host link; the rollout stores only what
    the update phase needs (`store`, caller-chosen).
  * update: `cfg.epochs` x `cfg.minibatches` clipped-PPO steps as nested
    lax.scan — one compiled program per train step, optimizer included.
  * scale-out: the same train step runs under shard_map over the mesh's
    'dp' axis — envs shard, params replicate, gradient/statistic pmean
    over ICI (the standard DP recipe, applied to RL).

No framework dependency beyond optax: params are plain pytrees and the
actor-critic is a pure function, exactly like every engine system.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from scx.rl.gae import gae


@dataclass(frozen=True)
class PPOConfig:
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    gamma: float = 0.99
    lam: float = 0.95
    epochs: int = 4
    minibatches: int = 4
    # advantage whitening over the (global, when sharded) batch
    normalize_adv: bool = True


def ppo_loss(params, apply, mb, cfg: PPOConfig):
    """Clipped-surrogate loss on one minibatch.

    `apply(params, store) -> (logp, value, entropy)` recomputes the policy
    on the stored step data; `mb` carries {'store', 'logp_old', 'adv',
    'ret'} rows. Returns (loss, metrics dict).
    """
    logp, value, entropy = apply(params, mb["store"])
    ratio = jnp.exp(logp - mb["logp_old"])
    adv = mb["adv"]
    unclipped = ratio * adv
    clipped = jnp.clip(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
    policy_loss = -jnp.mean(jnp.minimum(unclipped, clipped))
    value_loss = 0.5 * jnp.mean((value - mb["ret"]) ** 2)
    ent = jnp.mean(entropy)
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * ent
    metrics = {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": ent,
        "clip_frac": jnp.mean(
            (jnp.abs(ratio - 1.0) > cfg.clip_eps).astype(jnp.float32)
        ),
    }
    return loss, metrics


def _update_epochs(params, opt_state, flat, apply, opt, cfg: PPOConfig,
                   key, axis):
    """cfg.epochs passes of cfg.minibatches clipped steps over the flat
    [B, ...] rows, as a nested scan (one XLA program; the minibatch gather
    is a [mb]-row gather per step — rows, not elements).
    """
    import optax

    n_rows = flat["logp_old"].shape[0]
    mb_rows = n_rows // cfg.minibatches
    if mb_rows < 1:
        # trace-time shape error beats silent NaNs from empty-slice means
        raise ValueError(
            f"PPO minibatching: {n_rows} (local) rollout rows cannot fill "
            f"{cfg.minibatches} minibatches — raise length/n_envs or lower "
            "cfg.minibatches (note rows-per-shard = length * envs / mesh "
            "lanes when sharded; the n_rows % minibatches remainder rows "
            "are redrawn each epoch by the permutation, never trained on "
            "twice within one)."
        )

    def mb_body(carry, idx):
        params, opt_state = carry
        mb = jax.tree.map(lambda x: x[idx], flat)
        (_, metrics), grads = jax.value_and_grad(
            ppo_loss, has_aux=True
        )(params, apply, mb, cfg)
        if axis is not None:
            grads = jax.lax.pmean(grads, axis)
            metrics = jax.lax.pmean(metrics, axis)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), metrics

    def epoch_body(carry, ek):
        perm = jax.random.permutation(ek, n_rows)
        idxs = perm[: mb_rows * cfg.minibatches].reshape(
            cfg.minibatches, mb_rows
        )
        return jax.lax.scan(mb_body, carry, idxs)

    keys = jax.random.split(key, cfg.epochs)
    (params, opt_state), metrics = jax.lax.scan(
        epoch_body, (params, opt_state), keys
    )
    # [epochs, minibatches] metric traces -> last-pass means
    metrics = jax.tree.map(lambda m: jnp.mean(m[-1]), metrics)
    return params, opt_state, metrics


def make_ppo_train_step(
    env,
    actor_critic,
    apply,
    length: int,
    opt,
    cfg: PPOConfig = PPOConfig(),
    mesh=None,
):
    """Build the one-launch PPO train step over `env` (a CityRLEnv).

    Args:
      actor_critic: `(params, obs, key) -> (actions, logp, value,
        store)` — the collection-phase policy (see
        CityRLEnv.make_trajectory_rollout).
      apply: `(params, store) -> (logp, value, entropy)` — the update-phase
        recomputation on stored rows.
      length: rollout horizon per train step. ONE train step is ONE XLA
        launch containing the rollout PLUS epochs x minibatches full-batch
        grad passes — against the ~60 s launch watchdog (CLAUDE.md quirk
        9) budget roughly length * n_envs * (1 + epochs) engine-step
        equivalents, not just the rollout; there is no AdaptiveChunker on
        this path, so size the horizon conservatively and loop on the
        host.
      opt: an optax GradientTransformation.
      mesh: optional jax.sharding.Mesh — envs shard over ALL mesh axes
        (flattened), params replicate, gradients/whitening moments pmean
        across every lane, so no device idles regardless of the mesh's
        dp/sp split (scx.parallel.mesh.make_mesh). n_envs must divide the
        device count.

    Returns (train_step, place):
      train_step(params, opt_state, batch, cache, key) ->
          (params, opt_state, batch, cache, metrics)
      place(tree): shards an env pytree onto the mesh; identity when mesh
      is None.
      When the env uses static_bake AND a mesh is given, train_step takes
      a trailing `baked` argument (pass place(env.baked)): the per-env
      baked columns must be sharded explicitly — a closure capture would
      replicate them across shards and break the per-shard vmap.
    """
    thread_baked = mesh is not None and getattr(env, "baked", None) is not None
    rollout = env.make_trajectory_rollout(
        actor_critic, length, thread_baked=thread_baked
    )

    def local(params, opt_state, batch, cache, key, axis, baked=None):
        if axis is not None:
            for name in (axis if isinstance(axis, tuple) else (axis,)):
                key = jax.random.fold_in(key, jax.lax.axis_index(name))
        k_roll, k_upd = jax.random.split(key)
        if thread_baked:
            batch, cache, traj = rollout(batch, cache, params, k_roll, baked)
        else:
            batch, cache, traj = rollout(batch, cache, params, k_roll)
        adv, ret = gae(
            traj["reward"], traj["value"], traj["last_value"],
            cfg.gamma, cfg.lam,
        )
        if cfg.normalize_adv:
            if axis is None:
                mean, mean_sq = jnp.mean(adv), jnp.mean(adv**2)
            else:  # global whitening: moments pmean'd across shards
                mean = jax.lax.pmean(jnp.mean(adv), axis)
                mean_sq = jax.lax.pmean(jnp.mean(adv**2), axis)
            adv = (adv - mean) / (jnp.sqrt(mean_sq - mean**2) + 1e-6)
        # one flat row per AGENT-step: logp is [L, N] single-agent or
        # [L, N, K] multi-agent — flatten every leading (batch) axis and
        # the same count off each store leaf (multi-agent store leaves
        # must therefore carry the agent axis: [L, N, K, ...])
        lead = traj["logp"].ndim
        flat = {
            "store": jax.tree.map(
                lambda x: x.reshape((-1,) + x.shape[lead:]), traj["store"]
            ),
            "logp_old": traj["logp"].reshape(-1),
            "adv": adv.reshape(-1),
            "ret": ret.reshape(-1),
        }
        params, opt_state, metrics = _update_epochs(
            params, opt_state, flat, apply, opt, cfg, k_upd, axis
        )
        mean_return = jnp.mean(jnp.sum(traj["reward"], axis=0))
        if axis is not None:
            mean_return = jax.lax.pmean(mean_return, axis)
        metrics = dict(metrics, mean_return=mean_return)
        return params, opt_state, batch, cache, metrics

    if mesh is None:
        # donate the env state + warm-start caches (outputs alias inputs;
        # hundreds of MB at fleet scale — every caller threads them, see
        # the returned signature). Params/opt_state stay undonated: they
        # are small and callers may keep snapshots for eval/checkpoints.
        # place() COPIES here: the documented pattern is
        # `batch = place(env.state)`, and donating env.state's own buffers
        # would delete them under the env's feet (the sharded
        # place() already copies via device_put-with-sharding).
        train_step = jax.jit(
            partial(local, axis=None), donate_argnums=(2, 3)
        )
        return train_step, lambda tree: jax.tree.map(
            lambda x: jnp.array(x, copy=True), tree
        )

    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    # flatten every mesh axis onto the env dim: a ('dp','sp') mesh would
    # otherwise replicate the whole rollout+update on each 'sp' lane
    axes = tuple(mesh.axis_names)
    env_spec = P(axes)
    if thread_baked:
        def with_baked(params, opt_state, batch, cache, key, baked):
            return local(params, opt_state, batch, cache, key, axes, baked)

        sharded = shard_map(
            with_baked,
            mesh=mesh,
            in_specs=(P(), P(), env_spec, env_spec, P(), env_spec),
            out_specs=(P(), P(), env_spec, env_spec, P()),
            check_vma=False,
        )
    else:
        sharded = shard_map(
            partial(local, axis=axes),
            mesh=mesh,
            in_specs=(P(), P(), env_spec, env_spec, P()),
            out_specs=(P(), P(), env_spec, env_spec, P()),
            check_vma=False,
        )

    def place(tree):
        def put(x):
            spec = P(axes, *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))

        return jax.tree.map(put, tree)

    # same donation as the unsharded path (baked, when present, is NOT
    # donated: it is reused across train steps)
    return jax.jit(sharded, donate_argnums=(2, 3)), place
