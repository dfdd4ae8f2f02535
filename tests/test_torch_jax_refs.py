"""The JAX references of the port's parity tests, jitted.

An eager JAX call compiles every primitive apart. For a reference made of
many small operations (a transform's ring stage, a SED over a frequency
grid) that is most of a test's time, and one jax.jit of the whole call is
far cheaper; for a large composition called once (a TOD pass) the two cost
about the same. `jit_call(fn, *args)` runs fn under one jax.jit, made at
the first call with a given set of static arguments and kept: every
argument whose leaves hold no array (Python scalars, configs, None) is
static, every array, key or pytree of arrays is traced. A reference that
reads module state (a SED's tables) must not go through it: jax keys its
traces by the function, so a changed table would not be seen. The one
test here holds a jitted reference to its eager self.
"""
import jax
import jax.numpy as jnp
import numpy as np

_CACHE = {}


def _traced(x) -> bool:
    return any(isinstance(v, (jax.Array, np.ndarray))
               for v in jax.tree_util.tree_leaves(x))


def jit_call(fn, *args, **kw):
    """fn(*args, **kw) under jax.jit, every argument without arrays static
    (module docstring); the compiled function is kept per static set."""
    static = tuple(i for i, a in enumerate(args) if not _traced(a))
    names = tuple(sorted(k for k, v in kw.items() if not _traced(v)))
    key = (fn, static, names)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(fn, static_argnums=static,
                              static_argnames=names)
    return _CACHE[key](*args, **kw)


def test_jitted_reference_matches_eager():
    """A reference with static scalars, a key and arrays: jitted equals
    eager to 1e-12, and its compiled function is made once."""
    from commander_tpu.tod import model as JM

    rng = np.random.default_rng(0)
    resid = rng.standard_normal((2, 2, 64))
    args = tuple(map(jnp.asarray, (resid, np.ones_like(resid),
                                   np.full((2, 2), 0.5),
                                   np.full((2, 2), -1.5),
                                   np.full((2, 2), 0.15))))
    key = jax.random.PRNGKey(1)
    n0 = len(_CACHE)
    for _ in range(2):
        got = jit_call(JM.sample_ncorr, key, *args, 10.0)
    ref = JM.sample_ncorr(key, *args, 10.0)
    assert np.abs(np.asarray(got) - np.asarray(ref)).max() <= 1e-12 * max(
        np.abs(np.asarray(ref)).max(), 1.0)
    assert len(_CACHE) == n0 + 1
