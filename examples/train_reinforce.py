"""On-device RL training on the batched city envs — the workload BASELINE
config #5 exists for, end to end: a conv policy consumes the 128x128 RGB-D
observations on chip, drives the player vehicle, and REINFORCE updates flow
on the same chip. Nothing but scalars crosses the host link per iteration.

The reference engine has no RL story at all; this is the capability the
rebuild adds on top of parity (vectorized envs = sc_sandbox
scenes, reward = forward progress of the player vehicle).

Usage:
  python examples/train_reinforce.py [--envs 256] [--iters 20] [--len 16]
  (CPU smoke: --envs 8 --obs 16 --capacity 32 --iters 2 --len 4)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def policy_init(key, obs_hw: int, channels: int = 8):
    """Tiny conv torso + linear head -> Gaussian over 4 controls.

    Plain pytree params (no framework dependency): the policy is a pure
    function, exactly like every engine system."""
    k1, k2, k3 = jax.random.split(key, 3)
    c = channels
    params = {
        "conv1": jax.random.normal(k1, (4, 4, 4, c)) * 0.1,   # HWIO, stride 4
        "conv2": jax.random.normal(k2, (4, 4, c, c * 2)) * 0.1,
        "head": jax.random.normal(k3, (c * 2, 4)) * 0.01,
        "bias": jnp.zeros((4,)),
        "log_std": jnp.full((4,), -0.5),
    }
    return params


def policy_apply(params, obs, key):
    """obs [N,H,W,4] -> (actions [N,4], logp [N]).

    tanh-squashed Gaussian: throttle/brake/handbrake in [0,1], steer in
    [-1,1] (the CityRLEnv action convention)."""
    x = obs
    x = jax.lax.conv_general_dilated(
        x, params["conv1"], (4, 4), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    x = jax.nn.relu(x)
    x = jax.lax.conv_general_dilated(
        x, params["conv2"], (4, 4), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    x = jax.nn.relu(x)
    x = jnp.mean(x, axis=(1, 2))                      # global average pool
    mean = x @ params["head"] + params["bias"]        # [N,4]
    std = jnp.exp(params["log_std"])
    eps = jax.random.normal(key, mean.shape)
    # score-function estimator: the log-density must be a function of the
    # params with the SAMPLE held fixed (logp of eps alone is constant in
    # the mean — zero gradient into the torso)
    raw = jax.lax.stop_gradient(mean + std * eps)
    z = (raw - mean) / std
    logp = jnp.sum(
        -0.5 * (z**2) - params["log_std"] - 0.5 * jnp.log(2 * jnp.pi), axis=-1
    )
    from scx.app.rlenv import squash_raw_actions

    return squash_raw_actions(raw), logp


def make_sharded_train_step(env, policy, length: int, opt, mesh=None):
    """Data-parallel REINFORCE over the device mesh: envs shard over 'dp',
    the policy params replicate, per-shard gradients reduce with pmean —
    the standard DP training recipe (params everywhere, batch split,
    gradient all-reduce over ICI), applied to the RL fleet.

    Returns (train_step, place) where
      train_step(params, opt_state, batch, cache, key) ->
          (params, opt_state, batch, cache, loss, mean_return)
    and place(batch_or_cache) shards an env pytree onto the mesh.
    Per-shard advantage normalization (each chip whitens its own envs)."""
    import optax
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from scx.parallel.mesh import make_mesh, shard_env_batch

    if mesh is None:
        mesh = make_mesh()
    rollout = env.make_policy_rollout(policy, length)

    def local(params, batch, cache, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("dp"))

        def loss_fn(p):
            b, c, (rews, logps, _) = rollout(batch, cache, p, key)
            rets = jnp.cumsum(rews[::-1], axis=0)[::-1]
            adv = rets - jnp.mean(rets, axis=1, keepdims=True)
            adv = adv / (jnp.std(adv) + 1e-6)
            loss = -jnp.mean(logps * jax.lax.stop_gradient(adv))
            return loss, (b, c, jnp.mean(jnp.sum(rews, axis=0)))

        (loss, (batch, cache, ep_rew)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        # the DP collective: gradients (and scalars) average across chips
        grads = jax.lax.pmean(grads, "dp")
        loss = jax.lax.pmean(loss, "dp")
        ep_rew = jax.lax.pmean(ep_rew, "dp")
        return grads, loss, ep_rew, batch, cache

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P("dp"), P("dp"), P()),
        out_specs=(P(), P(), P(), P("dp"), P("dp")),
        check_vma=False,
    )

    @jax.jit
    def train_step(params, opt_state, batch, cache, key):
        grads, loss, ep_rew, batch, cache = sharded(params, batch, cache, key)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, batch, cache, loss, ep_rew

    def place(tree):
        return shard_env_batch(tree, mesh)

    return train_step, place


def save_policy(path: str, params: dict):
    """Policy params -> one .npz (same dependency-light convention as
    scx.app.checkpoint for sim state)."""
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_policy(path: str) -> dict:
    with np.load(path) as data:
        return {k: jnp.asarray(data[k]) for k in data.files}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=160)
    ap.add_argument("--obs", type=int, default=128)
    ap.add_argument("--traffic", type=int, default=8)
    ap.add_argument("--len", type=int, default=16, dest="length")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--sharded", action="store_true",
        help="data-parallel over the device mesh (envs shard over 'dp', "
             "gradients pmean across chips)",
    )
    ap.add_argument("--save", type=str, default=None,
                    help="write the trained policy to this .npz")
    ap.add_argument("--resume", type=str, default=None,
                    help="load initial policy params from this .npz")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (Pallas kernels in "
                         "interpret mode)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import optax

    from scx.app.rlenv import CityRLEnv

    t0 = time.time()
    env = CityRLEnv(
        n_envs=args.envs,
        capacity=args.capacity,
        obs_size=args.obs,
        n_traffic=args.traffic,
    )
    print(f"built {args.envs} envs in {time.time()-t0:.1f}s", flush=True)

    key = jax.random.PRNGKey(args.seed)
    key, pk = jax.random.split(key)
    params = (
        load_policy(args.resume) if args.resume else policy_init(pk, args.obs)
    )
    opt = optax.adam(args.lr)
    opt_state = opt.init(params)

    if args.sharded:
        train_sharded, place = make_sharded_train_step(
            env, policy_apply, args.length, opt
        )
        batch, cache = place(env.state), place(env.cache)
        for it in range(args.iters):
            key, rk = jax.random.split(key)
            t0 = time.time()
            params, opt_state, batch, cache, loss, ep_rew = train_sharded(
                params, opt_state, batch, cache, rk
            )
            jax.block_until_ready(loss)
            print(
                f"iter {it:3d}  loss {float(loss):+.4f}  "
                f"mean return {float(ep_rew):+.3f} m  "
                f"({args.envs * args.length / (time.time()-t0):,.0f} env-steps/s "
                f"over {jax.device_count()} devices)",
                flush=True,
            )
        if args.save:
            save_policy(args.save, params)
            print(f"saved policy -> {args.save}", flush=True)
        print("done", flush=True)
        return

    rollout = env.make_policy_rollout(policy_apply, args.length)

    def loss_fn(params, batch, cache, key):
        batch, cache, (rews, logps, _means) = rollout(batch, cache, params, key)
        # reward-to-go returns, mean baseline over the fleet
        rets = jnp.cumsum(rews[::-1], axis=0)[::-1]            # [L,N]
        adv = rets - jnp.mean(rets, axis=1, keepdims=True)
        adv = adv / (jnp.std(adv) + 1e-6)
        loss = -jnp.mean(logps * jax.lax.stop_gradient(adv))
        return loss, (batch, cache, jnp.mean(jnp.sum(rews, axis=0)))

    @jax.jit
    def train_step(params, opt_state, batch, cache, key):
        (loss, (batch, cache, ep_rew)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params, batch, cache, key)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, batch, cache, loss, ep_rew

    batch, cache = env.state, env.cache
    for it in range(args.iters):
        key, rk = jax.random.split(key)
        t0 = time.time()
        params, opt_state, batch, cache, loss, ep_rew = train_step(
            params, opt_state, batch, cache, rk
        )
        jax.block_until_ready(loss)
        print(
            f"iter {it:3d}  loss {float(loss):+.4f}  "
            f"mean return {float(ep_rew):+.3f} m  "
            f"({args.envs * args.length / (time.time()-t0):,.0f} env-steps/s)",
            flush=True,
        )
    if args.save:
        save_policy(args.save, params)
        print(f"saved policy -> {args.save}", flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    main()
