"""scx.core.struct: frozen pytree dataclasses (the flax.struct subset the
engine uses) and the compile-cache location helper."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from scx.core import cache, struct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@struct.dataclass
class _Thing:
    x: jax.Array
    y: jax.Array
    n: int = struct.field(pytree_node=False, default=3)


def test_static_fields_live_in_the_treedef():
    t = _Thing(jnp.ones(2), jnp.zeros(3), n=5)
    leaves, tree = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 2
    back = jax.tree_util.tree_unflatten(tree, leaves)
    assert back.n == 5 and isinstance(back, _Thing)
    # a different static value is a different treedef
    other = jax.tree_util.tree_structure(_Thing(jnp.ones(2), jnp.zeros(3), n=6))
    assert other != tree


def test_replace_returns_a_changed_copy():
    t = _Thing(jnp.ones(2), jnp.zeros(3))
    u = t.replace(n=7, y=jnp.ones(3))
    assert (u.n, float(u.y.sum()), t.n, float(t.y.sum())) == (7, 3.0, 3, 0.0)
    with pytest.raises(Exception):
        t.x = jnp.zeros(2)  # frozen


def test_jit_and_vmap_over_a_struct():
    @jax.jit
    def f(t):
        return t.replace(x=t.x * t.n)

    out = f(_Thing(jnp.ones(2), jnp.zeros(3), n=4))
    assert out.x.tolist() == [4.0, 4.0] and out.n == 4
    batched = jax.vmap(lambda t: t.x.sum())(
        _Thing(jnp.ones((5, 2)), jnp.zeros((5, 3)))
    )
    assert batched.shape == (5,)


def test_engine_imports_without_flax():
    runner = (
        "import sys; sys.modules['flax'] = None\n"
        "import scx.app.rlenv, scx.app.sandbox\n"
        "print('IMPORT_OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", runner], cwd=ROOT, capture_output=True,
        text=True, timeout=240, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "IMPORT_OK" in proc.stdout


@pytest.mark.parametrize("env_dir", [None, "x"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """$JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache."""
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        assert cache.cache_dir() == want
