"""Contact warm starting — accumulated impulses carried across steps.

Bullet's btPersistentManifold caches contact points and their accumulated
impulses between steps and warm-starts the sequential-impulse solver with
them (the reference gets this for free from btDiscreteDynamicsWorld,
sc_physics.cpp:283-302). The equivalent here is a fixed-shape cache keyed by
pair identity:

  * pairs are keyed by the (key_a, key_b) identity of the two bodies — by
    default their row indices (stable in a fixed-capacity scene), or, when
    the caller passes `key_id`, a persistent per-body id column. Stable ids
    let the cache survive row reshuffling: the spatially-sharded bigscene
    migrates entity rows between shards and rebuilds ghost rows every step,
    so row indices churn while entity uids don't (scx/parallel/bigscene.py).
  * matching last step's pairs to this step's is a [P,P] equality one-hot
    followed by a [P,P]@[P,K*3] matmul instead of a searchsorted over
    sorted keys. Keys are unique (one
    row per pair), so each one-hot row has at most a single 1 — the matmul
    IS the gather.
  * within a pair, contacts keep their candidate-slot id (face-A corner k /
    face-B corner k / edge end k), which is stable while the SAT case is
    stable — a [4,4] one-hot match re-associates impulses when top-k
    reorders them.
  * keys are stored in (A,B) role order and only match in the same order:
    the contact normal and candidate slots are role-dependent, so a pair
    whose A/B roles flipped (row-order inversion, e.g. at the step an
    entity migrates across a shard boundary) cold-starts for one step
    rather than applying sign-flipped impulses.

Warm-started impulses are applied to the velocities up front and the solver
iterations only correct the residual — fewer iterations for equal stack
stability (the round-1 solve was 8 cold Jacobi sweeps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from scx.core import struct

from scx.physics.contacts import MAX_CONTACTS_PER_PAIR

_EMPTY = jnp.int32(-1)


@struct.dataclass
class ContactCache:
    """Per-scene warm-start cache, fixed capacity [max_pairs]."""

    key_a: jax.Array     # [P] i32 stable id of body A (-1 empty slot)
    key_b: jax.Array     # [P] i32 stable id of body B (-1 empty slot)
    cand: jax.Array      # [P,K] i32 candidate slot per stored contact (-1 none)
    lam: jax.Array       # [P,K*3] f32 accumulated (ln, l1, l2) per contact


def empty_contact_cache(max_pairs: int, k: int = MAX_CONTACTS_PER_PAIR) -> ContactCache:
    return ContactCache(
        key_a=jnp.full((max_pairs,), _EMPTY, jnp.int32),
        key_b=jnp.full((max_pairs,), _EMPTY, jnp.int32),
        cand=jnp.full((max_pairs, k), -1, jnp.int32),
        lam=jnp.zeros((max_pairs, k * 3), jnp.float32),
    )


def _pair_keys(ia, ib, pair_valid, key_id):
    """(key_a, key_b) columns for this step's pairs; -1 where invalid."""
    if key_id is None:
        ka, kb = ia, ib
    else:
        ka, kb = key_id[ia], key_id[ib]
    ka = jnp.where(pair_valid, ka, _EMPTY).astype(jnp.int32)
    kb = jnp.where(pair_valid, kb, _EMPTY).astype(jnp.int32)
    return ka, kb


def gather_warm_impulses(cache: ContactCache, ia, ib, pair_valid, cand,
                         n_bodies, key_id=None):
    """Warm impulses for this step's contacts.

    ia/ib/pair_valid: this step's pairs [P]; cand: [P*K] candidate slots from
    generate_contacts; key_id: optional [N] i32 stable per-body id column
    (row indices when None). Returns lam0 [P*K, 3] (zeros where unmatched).
    """
    del n_bodies  # keys are (id_a, id_b) pairs; no flat fold needed
    p = ia.shape[0]
    k = MAX_CONTACTS_PER_PAIR
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    # pair match as a one-hot [P,P] matmul: an equality matrix plus a
    # [P,P]@[P,K*3] matmul instead of binary-searching a sorted key
    # column. Whether a sort beats it on the GPU is not measured yet.
    onehot = (
        (ka[:, None] == cache.key_a[None, :])
        & (kb[:, None] == cache.key_b[None, :])
        & pair_valid[:, None]
        & (cache.key_a != _EMPTY)[None, :]
    ).astype(jnp.float32)
    prev_lam = (onehot @ cache.lam).reshape(p, k, 3)          # [P,K,3]
    prev_cand_f = onehot @ (cache.cand + 1).astype(jnp.float32)  # 0 = none
    prev_cand = prev_cand_f.astype(jnp.int32) - 1             # [P,K]
    cur_cand = cand.reshape(p, k)
    # re-associate by candidate slot: [P, cur K, prev K] one-hot match
    m = (cur_cand[:, :, None] == prev_cand[:, None, :]) & (
        prev_cand[:, None, :] >= 0
    )
    lam0 = jnp.einsum("pst,ptc->psc", m.astype(jnp.float32), prev_lam)
    return lam0.reshape(p * k, 3)


def store_impulses(
    cache: ContactCache, ia, ib, pair_valid, cand, lam, contact_valid,
    n_bodies, key_id=None,
) -> ContactCache:
    """New cache from this step's solve results (lam [P*K,3])."""
    del n_bodies
    p = ia.shape[0]
    k = MAX_CONTACTS_PER_PAIR
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    lam_masked = jnp.where(contact_valid[:, None], lam, 0.0).reshape(p, k * 3)
    cand_masked = jnp.where(contact_valid, cand, -1).reshape(p, k)
    return cache.replace(
        key_a=ka,
        key_b=kb,
        cand=cand_masked.astype(jnp.int32),
        lam=lam_masked.astype(jnp.float32),
    )
