"""NUTS: the port's batched, lockstep-by-depth transition and ``run_nuts``
against the JAX package's ``make_nuts_kernel`` and ``run_nuts`` under
``vmap``, with the JAX kernel's own draws injected.

A JAX transition's draws follow from its key: ``kp, kd, _ = split(key,
3)``, the momentum normals from ``kp``; each doubling ``key_d, kdir,
kmerge = split(tree_key, 3)`` (``tree_key`` = ``kd``, then ``key_d``),
its direction ``bernoulli(kdir)`` and merge uniform from ``kmerge``; each
leaf of it ``s, ks = split(s)`` from ``key_d``, its uniform from ``ks``.
``jax_tables`` rebuilds them as the port's tables. With them every
chain's depth, leaves run and divergence are identical, and its accept
probability (within rtol 1e-5, or 1e-6 absolute: a probability of 6e-11
carries the f32 rounding of its dH ~ 23 as a relative error) and new
position agree within rtol 1e-5 (f32 sums in other orders). In
``run_nuts`` every warmup transition's float64-adapted step size agrees
within rtol 1e-5 with a loop of the JAX package's own kernel and
dual-averaging update for the first three transitions. Later ones
drift further: dual averaging's first moves carry chains past the
leapfrog's stability edge (a step of 0.55 on a scale of 0.2), where the
accept rate moves some 30 times faster than the step, so the runner's
final step sizes and metric (1e-4 of its largest entry) after ten
warmup transitions are held within rtol 1e-4, and its samples, drawn at step sizes that far apart over trees
of up to 31 leaves, within 2e-3 of max|x|; depths and divergences stay
identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import random

from gravinv3dhmc_tpu.inversion import nuts as jnuts
from gravinv3dhmc_tpu_torch.inversion import nuts as tnuts

torch.set_num_threads(2)

RTOL = 1e-5
DEPTH = 5


def jax_tables(chain_keys, M, max_depth=DEPTH):
    """``draws(it)`` for chains keyed ``chain_keys`` whose runs split their
    key into ``n`` transition keys (``transition_keys``) or take it as the
    transition key itself (``n`` None)."""
    def table(keys):
        z, dirs, merge, leaf = [], [], [], []
        for key in keys:
            kp, kd, _ = random.split(key, 3)
            z.append(np.asarray(random.normal(kp, (M,), jnp.float32)))
            tk = kd
            row_d, row_m, row_l = [], [], []
            for d in range(max_depth):
                tk, kdir, kmerge = random.split(tk, 3)
                row_d.append(bool(random.bernoulli(kdir)))
                row_m.append(float(random.uniform(kmerge,
                                                  dtype=jnp.float32)))
                s, us = tk, []
                for _ in range(2 ** (max_depth - 1)):
                    s, ks = random.split(s)
                    us.append(float(random.uniform(ks, dtype=jnp.float32)))
                row_l.append(us)
            dirs.append(row_d)
            merge.append(row_m)
            leaf.append(row_l)
        return dict(z=np.stack(z), dir=np.array(dirs),
                    merge=np.array(merge, np.float32),
                    leaf=np.array(leaf, np.float32))
    return table


def _gaussian(nan_above=None):
    scales = np.float32([0.2, 0.5, 1.0, 2.0, 5.0, 1.5])

    def jpot(x):
        U = 0.5 * jnp.sum((x / scales) ** 2)
        if nan_above is not None:
            U = jnp.where(x[0] > nan_above, jnp.nan, U)
        return U, x / scales ** 2

    st = torch.from_numpy(scales)

    def tpot(x):
        U = 0.5 * ((x / st) ** 2).sum(-1)
        if nan_above is not None:
            U = torch.where(x[:, 0] > nan_above, torch.nan, U)
        return U, x / st ** 2

    return jpot, tpot, 6


def _transition(jpot, tpot, x0, eps, inv_mass, seed):
    C, M = x0.shape
    keys = random.split(random.PRNGKey(seed), C)
    jk = jnuts.make_nuts_kernel(jpot, max_depth=DEPTH)
    U0, g0 = jax.vmap(jpot)(jnp.asarray(x0))
    xj, Uj, gj, sj = jax.jit(jax.vmap(jk, in_axes=(0, 0, 0, 0, 0, None)))(
        jnp.asarray(x0), U0, g0, keys, jnp.asarray(eps),
        jnp.asarray(inv_mass))
    tk = tnuts.make_nuts_kernel(tpot, max_depth=DEPTH)
    xt = torch.from_numpy(x0)
    Ut, gt = tpot(xt)
    out_t = tk(xt, Ut, gt, jax_tables(None, M)(keys),
               torch.from_numpy(eps), torch.from_numpy(inv_mass))
    return (xj, Uj, gj, sj), out_t


def _same(out_j, out_t):
    (xj, Uj, gj, sj), (xt, Ut, gt, st) = out_j, out_t
    for k in ("depth", "n_leapfrog", "diverging"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]), k)
    np.testing.assert_allclose(st["accept_prob"].numpy(),
                               np.asarray(sj["accept_prob"]), rtol=RTOL,
                               atol=1e-6)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=RTOL * np.abs(xj).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=RTOL * np.abs(np.asarray(gj)).max())


def test_transition_matches_jax():
    """Eight chains whose step sizes span 0.02 to 6: deep trees, shallow
    ones and divergences in one batch, under a diagonal metric."""
    jpot, tpot, M = _gaussian()
    rng = np.random.RandomState(0)
    x0 = rng.normal(0, 1, (8, M)).astype(np.float32)
    eps = np.float32([0.02, 0.05, 0.1, 0.2, 0.4, 0.8, 2.0, 6.0])
    inv_mass = np.float32(rng.uniform(0.5, 2.0, M))
    out_j, out_t = _transition(jpot, tpot, x0, eps, inv_mass, seed=1)
    _same(out_j, out_t)
    depth = out_t[3]["depth"].numpy()
    assert depth.max() == DEPTH and depth.min() < DEPTH - 2
    assert out_t[3]["diverging"].any() and not out_t[3]["diverging"].all()


def test_a_turned_chain_stays_bit_still():
    """A chain's transition is bit for bit the same alone and in a batch
    whose other chains build deeper trees after it has stopped."""
    _, tpot, M = _gaussian()
    rng = np.random.RandomState(2)
    x0 = torch.from_numpy(rng.normal(0, 1, (4, M)).astype(np.float32))
    eps = torch.tensor([1.5, 0.01, 0.02, 0.03])
    keys = random.split(random.PRNGKey(3), 4)
    table = jax_tables(None, M)(keys)
    kern = tnuts.make_nuts_kernel(tpot, max_depth=DEPTH)
    U, g = tpot(x0)
    batch = kern(x0, U, g, table, eps, torch.ones(M))
    alone = kern(x0[:1], U[:1], g[:1], {k: v[:1] for k, v in table.items()},
                 eps[:1], torch.ones(M))
    assert batch[3]["depth"][0] < batch[3]["depth"][1:].min()
    for a, b in zip(batch[:3], alone[:3]):
        assert torch.equal(a[:1], b)
    for k in alone[3]:
        assert torch.equal(batch[3][k][:1], alone[3][k])


def test_nan_potential_is_a_divergence():
    """A potential that turns NaN past x0 = 0.5 diverges the chains that
    step there, in both packages alike; the others are untouched. A tree
    that stops inside its last subtree counts the leaves it ran."""
    jpot, tpot, M = _gaussian(nan_above=0.5)
    x0 = np.zeros((4, M), np.float32)
    x0[:, 0] = [0.3, 0.45, -1.0, -2.0]
    eps = np.float32([0.5, 0.5, 0.01, 0.01])
    out_j, out_t = _transition(jpot, tpot, x0, eps, np.ones(M, np.float32),
                               seed=4)
    _same(out_j, out_t)
    div = out_t[3]["diverging"].numpy()
    assert div[:2].all() and not div[2:].any()
    # the leaves run: chain 0 diverged on the 2nd leaf of its depth-1
    # subtree, so 2 leaves where 2^depth - 1 would say 3
    assert out_t[3]["depth"][0] == 2 and out_t[3]["n_leapfrog"][0] == 2
    assert np.isfinite(out_t[0].numpy()).all()


def _jax_warmup_step_sizes(jpot, x0, per_chain, n, step_size0):
    """The step size of each of the first ``n`` (< 2/5 of the warmup)
    transitions of JAX ``run_nuts``, from its own kernel and float64 dual
    averaging run one transition at a time."""
    kern = jax.jit(jax.vmap(jnuts.make_nuts_kernel(jpot, max_depth=DEPTH),
                            in_axes=(0, 0, 0, 0, 0, None)))
    x = jnp.asarray(x0)
    U, g = jax.vmap(jpot)(x)
    da = jax.vmap(lambda _: jnuts.dual_averaging_init(step_size0))(
        jnp.arange(x0.shape[0]))
    out = []
    for it in range(n):
        eps = jnp.exp(da["log_eps"]).astype(jnp.float32)
        out.append(np.asarray(eps))
        x, U, g, st = kern(x, U, g, jnp.stack([k[it] for k in per_chain]),
                           eps, jnp.ones(x0.shape[1], jnp.float32))
        da = jax.vmap(jnuts.dual_averaging_update)(da, st["accept_prob"])
    return np.stack(out)


def test_run_nuts_warmup_step_sizes_match_jax():
    """``run_nuts`` over 4 chains (vmapped in JAX): each warmup
    transition's float64-adapted step size, the final step sizes, metric,
    depths and divergences, and the samples."""
    jpot, tpot, M = _gaussian()
    C, nw, ns = 4, 10, 3
    x0 = np.random.RandomState(5).normal(0, 1, (C, M)).astype(np.float32)
    chain_keys = random.split(random.PRNGKey(6), C)
    kw = dict(n_warmup=nw, n_samples=ns, step_size0=0.3, max_depth=DEPTH)
    xs_j, st_j = jax.jit(jax.vmap(
        lambda x, k: jnuts.run_nuts(jpot, x, k, **kw)))(jnp.asarray(x0),
                                                         chain_keys)
    per_chain = [random.split(k, nw + ns) for k in chain_keys]
    table = jax_tables(None, M)

    def draws(it):
        return table([keys[it] for keys in per_chain])

    xs_t, st_t = tnuts.run_nuts(tpot, torch.from_numpy(x0), draws=draws,
                                **kw)
    warm_j = _jax_warmup_step_sizes(jpot, x0, per_chain, 3, 0.3)
    np.testing.assert_allclose(st_t["warm_step_size"][:3].numpy(), warm_j,
                               rtol=RTOL)
    assert len(np.unique(warm_j)) > C
    np.testing.assert_allclose(st_t["step_size"].numpy(),
                               np.asarray(st_j["step_size"]), rtol=1e-4)
    im_j = np.asarray(st_j["inv_mass"])
    np.testing.assert_allclose(st_t["inv_mass"].numpy(), im_j, rtol=0,
                               atol=1e-4 * im_j.max())
    np.testing.assert_array_equal(st_t["depths"].numpy().T,
                                  np.asarray(st_j["depths"]))
    np.testing.assert_array_equal(st_t["divergences"].numpy().T,
                                  np.asarray(st_j["divergences"]))
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0,
                               atol=2e-3 * np.abs(np.asarray(xs_j)).max())
    assert st_t["state"]["dual_averaging"]["log_eps"].dtype == torch.float64
    assert st_t["warm_step_size"].shape == (nw, C)


def test_nuts_recovers_anisotropic_gaussian():
    """As the JAX package's test, with the generator's draws: the scales
    0.2, 1, 5 within 30 %, no divergence, the metric near the variances."""
    scales = torch.tensor([0.2, 1.0, 5.0])

    def pot(x):
        return 0.5 * ((x / scales) ** 2).sum(-1), x / scales ** 2

    xs, stats = tnuts.run_nuts(pot, torch.zeros(4, 3), n_warmup=150,
                               n_samples=200, step_size0=0.5, max_depth=6,
                               seed=0)
    xs = xs.reshape(-1, 3).numpy()
    rel = np.abs(xs.std(0) / scales.numpy() - 1)
    assert (rel < 0.3).all()
    assert int(stats["divergences"].sum()) == 0
    ratio = stats["inv_mass"].numpy() / scales.numpy() ** 2
    assert (ratio > 0.3).all() and (ratio < 3.0).all()
