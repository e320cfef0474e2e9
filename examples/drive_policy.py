"""Evaluate a trained policy driving the city — the inference counterpart
to train_reinforce.py / train_ppo.py.

Loads a policy .npz, runs it in the loop on CityRLEnv (the SAME
observation distribution it trained on), and shows what the agent sees:
env 0's RGB-D chase view as terminal ANSI frames (or PNGs with --out).

Usage:
  python examples/drive_policy.py --policy /tmp/pi.npz --frames 120
  python examples/drive_policy.py --frames 60            # random policy
  python examples/drive_policy.py --ppo --policy ppo.npz # PPO param layout
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", type=str, default=None,
                    help=".npz from train_reinforce/train_ppo --save")
    ap.add_argument("--ppo", action="store_true",
                    help="policy file uses the PPO actor-critic layout")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--envs", type=int, default=4)
    ap.add_argument("--obs", type=int, default=128)
    ap.add_argument("--capacity", type=int, default=160)
    ap.add_argument("--traffic", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None,
                    help="save frames as PNG/PPM here instead of ANSI")
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--term-cols", type=int, default=96)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (Pallas kernels in "
                         "interpret mode)")
    ap.add_argument("--obs-mode", choices=("rgbd", "state"), default="rgbd",
                    dest="obs_mode",
                    help="state = the policy consumes 16-float state "
                         "vectors (train_ppo --obs-mode state layout); the "
                         "chase view is still rendered for display")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from scx.app.rlenv import CityRLEnv
    from scx.app.viewer import frame_to_ansi, save_frame
    from train_reinforce import load_policy, policy_apply, policy_init

    if args.obs_mode == "state":
        from train_ppo import state_actor_critic, state_net_init

        def apply(params, obs, key):
            actions, _logp, _v, _store = state_actor_critic(params, obs, key)
            return actions

        def init(pk, _obs_hw):
            from scx.app.rlenv import CityRLEnv as _E

            return state_net_init(pk, _E.STATE_OBS_DIM)
    elif args.ppo:
        from train_ppo import actor_critic, net_init

        def apply(params, obs, key):
            actions, _logp, _v, _store = actor_critic(params, obs, key)
            return actions

        init = net_init
    else:
        def apply(params, obs, key):
            actions, _logp = policy_apply(params, obs, key)
            return actions

        init = policy_init

    t0 = time.time()
    env = CityRLEnv(
        n_envs=args.envs, capacity=args.capacity, obs_size=args.obs,
        n_traffic=args.traffic, obs_mode=args.obs_mode,
    )
    print(f"built {args.envs} envs in {time.time()-t0:.1f}s", flush=True)

    key = jax.random.PRNGKey(args.seed)
    if args.policy:
        params = load_policy(args.policy)
        print(f"loaded policy {args.policy}", flush=True)
    else:
        key, pk = jax.random.split(key)
        params = init(pk, args.obs)
        print("no --policy given: driving with a fresh random policy",
              flush=True)

    @jax.jit
    def eval_step(batch, cache, obs, params, key):
        # obs carries through the loop (the step renders the NEXT one):
        # rendering is the dominant per-step cost, never pay it twice
        actions = apply(params, obs, key)
        batch, cache, obs2, rew, _info = env._step_impl(
            batch, cache, actions
        )
        return batch, cache, obs2, rew

    batch, cache = env.state, env.cache
    obs = jax.jit(env._obs_batched)(batch)
    # state mode: the policy never sees pixels, but the human does —
    # render the chase view on demand for display only
    view = jax.jit(env._render_obs_batched)
    total_rew = np.zeros(args.envs, np.float32)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for i in range(args.frames):
        key, sk = jax.random.split(key)
        batch, cache, obs, rew = eval_step(batch, cache, obs, params, sk)
        total_rew += np.asarray(rew)
        if args.obs_mode == "state":
            if args.out and i % args.every != 0:
                continue  # skip unseen renders entirely
            rgb = np.asarray(view(batch)[0, :, :, :3])
        else:
            rgb = np.asarray(obs[0, :, :, :3])  # env 0's view, drop depth
        if args.out:
            if i % args.every == 0:
                p = save_frame(
                    os.path.join(args.out, f"drive_{i:04d}"), rgb
                )
                print(f"frame {i:4d}  reward {float(rew[0]):+.3f}  -> {p}",
                      flush=True)
        else:
            print("\x1b[H\x1b[2J" + frame_to_ansi(rgb, args.term_cols))
            print(
                f"frame {i:4d}  step reward {float(rew[0]):+.3f}  "
                f"return(env0) {total_rew[0]:+.2f} m",
                flush=True,
            )
    print(
        "mean return over fleet: "
        f"{float(np.mean(total_rew)):+.2f} m over {args.frames} steps",
        flush=True,
    )


if __name__ == "__main__":
    main()
