"""On-device PPO on the batched city envs (scx.rl) — actor-critic with a
shared conv torso, GAE, clipped updates, optional data-parallel sharding
over the device mesh. Counterpart to examples/train_reinforce.py with the
production algorithm instead of the pedagogical one.

The rollout stores 4x average-pooled observations (not raw 128x128 pixels):
the torso consumes the pooled image in BOTH phases, so PPO's update epochs
recompute logp/value exactly while the stored trajectory stays ~16x
smaller than raw — the "store encodings, not pixels" trade
CityRLEnv.make_trajectory_rollout exposes.

Usage:
  python examples/train_ppo.py [--envs 256] [--iters 20] [--len 16]
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

POOL = 4  # obs avg-pool factor before the torso (and in the stored rows)
_LOG_2PI = float(np.log(2.0 * np.pi))


def net_init(key, obs_hw: int, channels: int = 8):
    """Shared conv torso + policy/value heads, plain pytree params."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    c = channels
    return {
        "conv1": jax.random.normal(k1, (3, 3, 4, c)) * 0.1,
        "conv2": jax.random.normal(k2, (3, 3, c, c * 2)) * 0.1,
        "pi_head": jax.random.normal(k3, (c * 2, 4)) * 0.01,
        "pi_bias": jnp.zeros((4,)),
        "v_head": jax.random.normal(k4, (c * 2, 1)) * 0.01,
        "v_bias": jnp.zeros((1,)),
        "log_std": jnp.full((4,), -0.5),
    }


def _pool(obs):
    n, h, w, c = obs.shape
    return jnp.mean(
        obs.reshape(n, h // POOL, POOL, w // POOL, POOL, c), axis=(2, 4)
    )


def _torso(params, pobs):
    x = jax.lax.conv_general_dilated(
        pobs, params["conv1"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    x = jax.nn.relu(x)
    x = jax.lax.conv_general_dilated(
        x, params["conv2"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    x = jax.nn.relu(x)
    return jnp.mean(x, axis=(1, 2))  # [N, C]


def _heads(params, feats):
    mean = feats @ params["pi_head"] + params["pi_bias"]
    # [..., 0]: feats may carry an agent axis ([N, K, C] in multi-agent
    # state mode) — [:, 0] would slice the wrong axis there
    value = (feats @ params["v_head"] + params["v_bias"])[..., 0]
    return mean, params["log_std"], value


def _logp_of_raw(mean, log_std, raw):
    z = (raw - mean) * jnp.exp(-log_std)
    return jnp.sum(-0.5 * (z**2) - log_std - 0.5 * _LOG_2PI, axis=-1)


def actor_critic(params, obs, key):
    """Collection phase: (actions, logp, value, store) per
    CityRLEnv.make_trajectory_rollout."""
    pobs = _pool(obs)
    feats = _torso(params, pobs)
    mean, log_std, value = _heads(params, feats)
    raw = mean + jnp.exp(log_std) * jax.random.normal(key, mean.shape)
    logp = _logp_of_raw(mean, log_std, raw)
    from scx.app.rlenv import squash_raw_actions

    return squash_raw_actions(raw), logp, value, {"pobs": pobs, "raw": raw}


def ac_apply(params, store):
    """Update phase: recompute (logp, value, entropy) on stored rows."""
    feats = _torso(params, store["pobs"])
    mean, log_std, value = _heads(params, feats)
    logp = _logp_of_raw(mean, log_std, store["raw"])
    entropy = jnp.sum(log_std + 0.5 * (_LOG_2PI + 1.0)) * jnp.ones(
        logp.shape
    )
    return logp, value, entropy


def state_net_init(key, obs_dim: int, hidden: int = 64):
    """MLP actor-critic for obs_mode='state' (16-float state vectors)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "w1": jax.random.normal(k1, (obs_dim, hidden)) * (1.0 / obs_dim**0.5),
        "b1": jnp.zeros((hidden,)),
        "pi_head": jax.random.normal(k2, (hidden, 4)) * 0.01,
        "pi_bias": jnp.zeros((4,)),
        "v_head": jax.random.normal(k3, (hidden, 1)) * 0.01,
        "v_bias": jnp.zeros((1,)),
        "log_std": jnp.full((4,), -0.5),
    }


def state_actor_critic(params, obs, key):
    """Collection phase over state vectors; store = the obs row itself
    (16 floats/step — no pooling trade needed)."""
    feats = jax.nn.relu(obs @ params["w1"] + params["b1"])
    mean, log_std, value = _heads(params, feats)
    raw = mean + jnp.exp(log_std) * jax.random.normal(key, mean.shape)
    logp = _logp_of_raw(mean, log_std, raw)
    from scx.app.rlenv import squash_raw_actions

    return squash_raw_actions(raw), logp, value, {"obs": obs, "raw": raw}


def state_ac_apply(params, store):
    feats = jax.nn.relu(store["obs"] @ params["w1"] + params["b1"])
    mean, log_std, value = _heads(params, feats)
    logp = _logp_of_raw(mean, log_std, store["raw"])
    entropy = jnp.sum(log_std + 0.5 * (_LOG_2PI + 1.0)) * jnp.ones(logp.shape)
    return logp, value, entropy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=160)
    ap.add_argument("--obs", type=int, default=128)
    ap.add_argument("--traffic", type=int, default=8)
    ap.add_argument("--len", type=int, default=16, dest="length")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sharded", action="store_true",
                    help="envs shard over the mesh 'dp' axis, gradients "
                         "pmean across chips")
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (Pallas kernels in "
                         "interpret mode)")
    ap.add_argument("--obs-mode", choices=("rgbd", "state"), default="rgbd",
                    dest="obs_mode",
                    help="state = 16-float state vectors (no raster): MLP "
                         "actor-critic, ~raster-free training throughput")
    ap.add_argument("--agents", type=int, default=1,
                    help="policy cars per env (shared policy; needs "
                         "--obs-mode state for per-agent observations)")
    args = ap.parse_args()
    if args.agents > 1 and args.obs_mode != "state":
        ap.error("--agents > 1 requires --obs-mode state (pixel obs are "
                 "agent-0's view only)")
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import optax

    from scx.app.rlenv import CityRLEnv
    from scx.rl import PPOConfig, make_ppo_train_step
    from train_reinforce import load_policy, save_policy  # sibling example

    t0 = time.time()
    env = CityRLEnv(
        n_envs=args.envs,
        capacity=args.capacity,
        obs_size=args.obs,
        n_traffic=args.traffic,
        obs_mode=args.obs_mode,
        n_agents=args.agents,
    )
    print(f"built {args.envs} envs in {time.time()-t0:.1f}s", flush=True)

    if args.obs_mode == "state":
        init, ac, apply = (
            lambda k: state_net_init(k, env.STATE_OBS_DIM),
            state_actor_critic,
            state_ac_apply,
        )
    else:
        init, ac, apply = lambda k: net_init(k, args.obs), actor_critic, ac_apply
    key = jax.random.PRNGKey(args.seed)
    key, pk = jax.random.split(key)
    params = load_policy(args.resume) if args.resume else init(pk)
    opt = optax.adam(args.lr)
    opt_state = opt.init(params)
    cfg = PPOConfig(epochs=args.epochs, minibatches=args.minibatches)

    mesh = None
    if args.sharded:
        from scx.parallel.mesh import make_mesh

        mesh = make_mesh()
    train_step, place = make_ppo_train_step(
        env, ac, apply, args.length, opt, cfg, mesh=mesh
    )
    batch, cache = place(env.state), place(env.cache)

    for it in range(args.iters):
        key, rk = jax.random.split(key)
        t0 = time.time()
        params, opt_state, batch, cache, metrics = train_step(
            params, opt_state, batch, cache, rk
        )
        jax.block_until_ready(metrics["loss"])
        rate = args.envs * args.length / (time.time() - t0)
        print(
            f"iter {it:3d}  loss {float(metrics['loss']):+.4f}  "
            f"pi {float(metrics['policy_loss']):+.4f}  "
            f"vf {float(metrics['value_loss']):.4f}  "
            f"clip {float(metrics['clip_frac']):.2f}  "
            f"return {float(metrics['mean_return']):+.3f} m  "
            f"({rate:,.0f} env-steps/s"
            + (f" over {jax.device_count()} devices)" if args.sharded
               else ")"),
            flush=True,
        )
    if args.save:
        save_policy(args.save, params)
        print(f"saved policy -> {args.save}", flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    main()
