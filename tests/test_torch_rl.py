"""`repro_torch.rl` (vtrace, env, replay, agents) against the JAX package.

Both packages get the same numpy inputs, the same `ac_init`/`q_init`
weights (JAX's, through `repro_torch.bridge`) and JAX's own draws: the
port samples an action as argmax(logits + Gumbel) and a replay index by
inverting the priorities' cumsum at total * (1 - u), which is how
`jax.random.categorical` and `jax.random.choice(..., p=p)` draw in jax
0.9.0.  Each helper that rebuilds JAX's draws first asserts that it
reproduces JAX's own sample on its keys.  Tolerances: V-trace, n-step
returns, replay weights rtol 1e-6; one round of each architecture, params
and loss, rtol 1e-5 and atol 1e-6; integer leaves (actions, env states,
replay indices) exactly.

The second half holds the counterparts of tests/test_rl.py's ten tests on
the port's own generators, seeded as the JAX tests key theirs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hyp_compat import given, settings, st  # noqa: E402

from repro.rl import agents as JA  # noqa: E402
from repro.rl import env as JEnv  # noqa: E402
from repro.rl import replay as JR  # noqa: E402
from repro.rl import vtrace as JV  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.rl import agents as TA  # noqa: E402
from repro_torch.rl import env as TEnv  # noqa: E402
from repro_torch.rl import replay as TR  # noqa: E402
from repro_torch.rl import vtrace as TV  # noqa: E402

KEY = jax.random.PRNGKey(0)
JENV = JEnv.ChainEnv(length=8, horizon=24)
TENV = TEnv.ChainEnv(length=8, horizon=24)
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _port(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             "cpu")


def _assert_tree_close(t, j, **tol):
    jl = jax.tree_util.tree_leaves(j)
    tl = TA.tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), np.asarray(b), **(tol or TOL))


# ---------------------------------------------------------------------------
# JAX's draws
# ---------------------------------------------------------------------------
def _gumbels(key, workers, length, A=2):
    """The Gumbel draws behind `batched_rollout(..., split(key, workers),
    length)`: (workers, length, A)."""
    def one(k):
        keys = jax.random.split(k, length)
        return jax.vmap(lambda kk: jax.random.gumbel(
            jax.random.split(kk)[0], (A,)))(keys)
    return np.asarray(jax.vmap(one)(jax.random.split(key, workers)))


def rollout_draws(key, workers, length, jparams, jstates, policy):
    """_gumbels, after checking that argmax(logits + g) gives the actions
    of JAX's own rollout from (jparams, jstates) on `key`."""
    g = _gumbels(key, workers, length)
    _, traj = JEnv.batched_rollout(JENV, jparams, policy, jstates,
                                   jax.random.split(key, workers), length)
    assert np.array_equal(np.argmax(np.asarray(traj["logits"]) + g, -1),
                          np.asarray(traj["action"]))
    return g


def choice_uniforms(key, p, batch):
    """The uniforms behind `jax.random.choice(key, n, (batch,), p=p)`,
    after checking that the cumsum inversion draws JAX's indices."""
    u = jax.random.uniform(key, (batch,))
    cum = jnp.cumsum(p)
    mine = jnp.searchsorted(cum, cum[-1] * (1 - u))
    want = jax.random.choice(key, p.shape[0], (batch,), p=p)
    assert np.array_equal(np.asarray(mine), np.asarray(want))
    return np.asarray(u)


def _eps_greedy(eps=0.2):
    def logits(params, obs):
        q = JA.mlp_apply(params, obs)
        greedy = jax.nn.one_hot(jnp.argmax(q, -1), q.shape[-1])
        return jnp.log((1 - eps) * greedy + eps / q.shape[-1] + 1e-9)
    return logits


def _jstates(n, key=KEY):
    return jax.vmap(JENV.reset)(jax.random.split(key, n))


# ---------------------------------------------------------------------------
# V-trace and n-step returns
# ---------------------------------------------------------------------------
def _vtrace_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(behavior_logp=-np.abs(f(*shape)),
                target_logp=-np.abs(f(*shape)),
                rewards=f(*shape),
                discounts=(0.97 * (rng.uniform(size=shape) > 0.2))
                .astype(np.float32),
                values=f(*shape), bootstrap_value=f(*shape[:-1]))


@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.5, 2.0), (1e-9, 1e-9)])
def test_vtrace_equals_jax_batched(clip):
    """One call on (B, T) equals JAX's vtrace row by row, at rtol 1e-6 and
    an atol of 1e-6 of the row's largest element: an advantage near zero
    cancels O(1) terms, where XLA's fused multiply-adds and torch's
    separate roundings part by an ulp of those terms (1.2e-7 found at
    clip (0.5, 2.0))."""
    inp = _vtrace_inputs((3, 12))
    kw = dict(clip_rho=clip[0], clip_c=clip[1])
    out = TV.vtrace(**{k: _t(v) for k, v in inp.items()}, **kw)
    for b in range(3):
        want = JV.vtrace(**{k: jnp.asarray(v[b]) for k, v in inp.items()},
                         **kw)
        for got, ref in ((out.vs[b], want.vs), (out.pg_adv[b], want.pg_adv)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(_np(got), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max())


def test_nstep_returns_equals_jax():
    inp = _vtrace_inputs((2, 16), seed=1)
    got = TV.nstep_returns(_t(inp["rewards"]), _t(inp["discounts"]),
                           _t(inp["bootstrap_value"]))
    for b in range(2):
        want = JV.nstep_returns(inp["rewards"][b], inp["discounts"][b],
                                inp["bootstrap_value"][b])
        np.testing.assert_allclose(_np(got[b]), np.asarray(want),
                                   rtol=1e-6)


def test_vtrace_outputs_carry_no_gradient():
    inp = {k: _t(v).requires_grad_(True)
           for k, v in _vtrace_inputs((4,)).items()}
    out = TV.vtrace(**inp)
    assert not out.vs.requires_grad and not out.pg_adv.requires_grad


# ---------------------------------------------------------------------------
# env and rollouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("workers", [None, 5])
def test_rollout_equals_jax(workers):
    """Actions, obs, rewards, dones and the final env states equal JAX's;
    behavior logits at fp32 rounding.  `workers=None`: one actor."""
    jp = JA.ac_init(KEY, 8, 2)
    key = jax.random.PRNGKey(7)
    n = workers or 1
    g = rollout_draws(key, n, 24, jp, _jstates(n), JA.policy_logits)
    if workers is None:
        js, jt = JEnv.rollout(JENV, jp, JA.policy_logits, JENV.reset(key),
                              jax.random.split(key, 1)[0], 24)
        ts, tt = TEnv.rollout(TENV, _port(jp), TA.policy_logits,
                              TENV.reset(), _t(g[0]), 24)
    else:
        js, jt = JEnv.batched_rollout(JENV, jp, JA.policy_logits,
                                      _jstates(n), jax.random.split(key, n),
                                      24)
        ts, tt = TEnv.batched_rollout(TENV, _port(jp), TA.policy_logits,
                                      TENV.reset((n,)), _t(g), 24)
    for k in ("action", "obs", "reward", "done"):
        assert np.array_equal(_np(tt[k]), np.asarray(jt[k])), k
    assert tt["action"].dtype == torch.int32
    np.testing.assert_allclose(_np(tt["logits"]), np.asarray(jt["logits"]),
                               rtol=1e-6, atol=1e-6)
    for k in ("pos", "t"):
        assert np.array_equal(_np(ts[k]), np.asarray(js[k])), k


def test_env_step_auto_resets_like_jax():
    """Every (pos, t, action) of the chain: the same next state and
    timestep as JAX's step."""
    pos, t, a = np.meshgrid(np.arange(8), np.arange(24), np.arange(2),
                            indexing="ij")
    pos, t, a = (x.reshape(-1).astype(np.int32) for x in (pos, t, a))
    js, jts = jax.vmap(lambda p, tt, aa: JENV.step(
        {"pos": p, "t": tt}, aa, KEY))(pos, t, a)
    ts, tts = TENV.step({"pos": _t(pos), "t": _t(t)}, _t(a))
    for k in ("pos", "t"):
        assert np.array_equal(_np(ts[k]), np.asarray(js[k]))
    for k in ("obs", "reward", "done"):
        assert np.array_equal(_np(tts[k]), np.asarray(jts[k]))


@pytest.mark.parametrize("policy", ["ac", "q"])
def test_episode_return_equals_jax(policy):
    if policy == "ac":
        jp, jf, tf = JA.ac_init(KEY, 8, 2), JA.policy_logits, TA.policy_logits
    else:
        jp, jf, tf = (JA.q_init(JENV, KEY).params, JA.greedy_q_policy,
                      TA.greedy_q_policy)
    want = float(JEnv.episode_return(JENV, jp, jf, jax.random.PRNGKey(1)))
    got = float(TEnv.episode_return(TENV, _port(jp), tf))
    assert got == pytest.approx(want, rel=1e-6)


def test_port_generator_draws_are_gumbel_and_seeded():
    """The port's own draws: the same generator seed, the same actions;
    the draws' mean is Euler's constant."""
    g = TEnv.gumbel((200_000,), torch.Generator().manual_seed(3))
    assert float(g.mean()) == pytest.approx(0.5772, abs=0.01)
    p = TA.ac_init(torch.Generator().manual_seed(0), 8, 2)
    a = TEnv.rollout(TENV, p, TA.policy_logits, TENV.reset((3,)),
                     torch.Generator().manual_seed(1), 16)[1]["action"]
    b = TEnv.rollout(TENV, p, TA.policy_logits, TENV.reset((3,)),
                     torch.Generator().manual_seed(1), 16)[1]["action"]
    assert torch.equal(a, b) and a.shape == (3, 16)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------
def _filled_replays(n_add=3, cap=64, seed=0):
    rng = np.random.default_rng(seed)
    jrep = JR.replay_init(cap, {"x": jax.ShapeDtypeStruct((2,), jnp.float32),
                                "a": jax.ShapeDtypeStruct((), jnp.int32)})
    trep = TR.replay_init(cap, {"x": torch.zeros(2),
                                "a": torch.zeros((), dtype=torch.int32)})
    for _ in range(n_add):
        items = {"x": rng.normal(size=(24, 2)).astype(np.float32),
                 "a": rng.integers(0, 2, 24).astype(np.int32)}
        td = rng.normal(size=24).astype(np.float32)
        jrep = JR.replay_add(jrep, items, td)
        trep = TR.replay_add(trep, {k: _t(v) for k, v in items.items()},
                             _t(td))
    return jrep, trep


def test_replay_add_and_sample_equal_jax():
    """Ring writes, priorities, indices and IS weights equal JAX's.

    The priorities' cumsums are compared bit for bit and differ: XLA's
    CPU cumsum is an associative scan, torch's a running sum (accumulated
    in double on the CPU), so some of their 64 elements part by at most
    one ulp of the total.  A draw could only part where
    total * (1 - u) falls inside such a gap; none of these 512 does."""
    jrep, trep = _filled_replays()
    assert (trep.cursor, trep.size) == (int(jrep.cursor), int(jrep.size))
    for k in ("x", "a"):
        assert np.array_equal(_np(trep.storage[k]),
                              np.asarray(jrep.storage[k]))
    np.testing.assert_allclose(_np(trep.priorities),
                               np.asarray(jrep.priorities), rtol=1e-6)
    p = jrep.priorities / jnp.clip(jnp.sum(jrep.priorities), 1e-9)
    jcum = np.asarray(jnp.cumsum(p))
    tcum = _np(torch.cumsum(_t(p), 0))
    gap = np.abs(jcum - tcum)
    assert gap.max() <= np.spacing(np.float32(jcum[-1]))
    key = jax.random.PRNGKey(11)
    u = choice_uniforms(key, p, 512)
    jitems, jidx, jw = JR.replay_sample(jrep, key, 512)
    titems, tidx, tw = TR.replay_sample(trep, _t(u), 512)
    assert np.array_equal(_np(tidx), np.asarray(jidx))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=1e-6)
    for k in ("x", "a"):
        assert np.array_equal(_np(titems[k]), np.asarray(jitems[k]))


def test_replay_update_priorities_equals_jax_and_keeps_the_old_buffer():
    jrep, trep = _filled_replays(n_add=1)
    idx = np.array([0, 5, 9], np.int32)
    td = np.array([3.0, -0.5, 100.0], np.float32)
    jnew = JR.replay_update_priorities(jrep, idx, td)
    before = trep.priorities.clone()
    tnew = TR.replay_update_priorities(trep, _t(idx).long(), _t(td))
    np.testing.assert_allclose(_np(tnew.priorities),
                               np.asarray(jnew.priorities), rtol=1e-6)
    assert torch.equal(trep.priorities, before)   # functional, as in JAX


def _sampled_priorities(js, ka, gamma=0.97):
    """The normalized priorities `gorila_round(js, key)` samples from:
    its replay after this round's adds (JAX's acting half, restated)."""
    env_states, traj = JEnv.batched_rollout(
        JENV, js.params, _eps_greedy(), js.env_states,
        jax.random.split(ka, js.env_states["pos"].shape[0]), 16)
    next_obs = jnp.concatenate(
        [traj["obs"][:, 1:], jax.vmap(JENV.obs)(env_states)[:, None]], 1)
    flat = {"obs": traj["obs"].reshape(-1, 8),
            "action": traj["action"].reshape(-1),
            "reward": traj["reward"].reshape(-1),
            "done": traj["done"].reshape(-1),
            "next_obs": next_obs.reshape(-1, 8)}
    q_next = jnp.max(JA.mlp_apply(js.params, flat["next_obs"]), -1)
    tgt = flat["reward"] + gamma * (1 - flat["done"]) * q_next
    q_cur = jnp.take_along_axis(JA.mlp_apply(js.params, flat["obs"]),
                                flat["action"][:, None], 1)[:, 0]
    rep = JR.replay_add(js.replay, flat, tgt - q_cur)
    return rep.priorities / jnp.clip(jnp.sum(rep.priorities), 1e-9)


# ---------------------------------------------------------------------------
# one round of each architecture
# ---------------------------------------------------------------------------
ROUNDS = ["gorila", "apex", "a3c", "impala", "impala_naive", "dppo"]


@pytest.mark.parametrize("arch", ROUNDS)
def test_round_equals_jax(arch):
    """One round from the same weights, env states and JAX's draws:
    params and loss at rtol 1e-5 / atol 1e-6, env states equal."""
    key = jax.random.PRNGKey(3)
    workers = 4
    if arch in ("gorila", "apex"):
        prio = arch == "apex"
        js = JA.q_init(JENV, KEY, actors=workers)
        # one round first, so the learner samples a replay that holds
        # two rounds of data and a target that lags the params
        js, _ = JA.gorila_round(js, jax.random.PRNGKey(2), env=JENV,
                                prioritized=prio)
        tp, ttgt = _port(js.params), _port(js.target)
        trep = TR.Replay({k: _t(v) for k, v in js.replay.storage.items()},
                         _t(js.replay.priorities), int(js.replay.cursor),
                         int(js.replay.size))
        ts = TA.QLearnerState(tp, ttgt, trep,
                              {k: _t(v) for k, v in js.env_states.items()},
                              int(js.step))
        ka, ks, _ = jax.random.split(key, 3)
        g = rollout_draws(ka, workers, 16, js.params, js.env_states,
                          _eps_greedy())
        jn, jm = JA.gorila_round(js, key, env=JENV, prioritized=prio)
        u = choice_uniforms(ks, _sampled_priorities(js, ka), 64)
        tn, tm = TA.gorila_round(ts, {"gumbel": _t(g), "uniform": _t(u)},
                                 env=TENV, prioritized=prio)
        _assert_tree_close(tn.params, jn.params)
        _assert_tree_close(tn.target, jn.target)
        np.testing.assert_allclose(_np(tn.replay.priorities),
                                   np.asarray(jn.replay.priorities),
                                   rtol=1e-5, atol=1e-6)
        assert tn.step == int(jn.step)
        for k in ("loss", "mean_td"):
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), **TOL)
        tstates, jstates = tn.env_states, jn.env_states
    else:
        jp = JA.ac_init(KEY, 8, 2)
        # a stale actor replica for IMPALA: the params one a3c round ago
        jactor = JA.a3c_round(jp, _jstates(workers), jax.random.PRNGKey(9),
                              env=JENV)[0] if arch.startswith("impala") \
            else jp
        jst = _jstates(workers)
        g = rollout_draws(key, workers, 16, jactor, jst, JA.policy_logits)
        tst = TENV.reset((workers,))
        if arch == "a3c":
            jr = JA.a3c_round(jp, jst, key, env=JENV)
            tr = TA.a3c_round(_port(jp), tst, _t(g), env=TENV)
        elif arch == "dppo":
            jr = JA.dppo_round(jp, jst, key, env=JENV)
            tr = TA.dppo_round(_port(jp), tst, _t(g), env=TENV)
        else:
            uv = arch == "impala"
            jr = JA.impala_round(jp, jactor, jst, key, env=JENV,
                                 use_vtrace=uv)
            tr = TA.impala_round(_port(jp), _port(jactor), tst, _t(g),
                                 env=TENV, use_vtrace=uv)
        _assert_tree_close(tr[0], jr[0])
        np.testing.assert_allclose(_np(tr[2]["loss"]),
                                   np.asarray(jr[2]["loss"]), **TOL)
        tstates, jstates = tr[1], jr[1]
    for k in ("pos", "t"):
        assert np.array_equal(_np(tstates[k]), np.asarray(jstates[k]))


def test_bridge_round_trips_rl_params():
    """The RL MLPs are lists of {"w", "b"} layers: the bridge keeps the
    lists, and numpy -> port -> numpy is exact."""
    jp = jax.tree_util.tree_map(np.asarray, JA.ac_init(KEY, 8, 2))
    tp = params_from_numpy(jp, "cpu")
    assert isinstance(tp["pi"], list) and set(tp["pi"][0]) == {"w", "b"}
    back = params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(a, b)
    assert params_to_numpy(params_from_numpy((jp["v"][1]["b"],), "cpu")) \
        [0].shape == (1,)


# ---------------------------------------------------------------------------
# tests/test_rl.py's claims on the port's own generators
# ---------------------------------------------------------------------------
def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ret(params, policy_fn):
    return float(TEnv.episode_return(TENV, params, policy_fn))


def test_vtrace_reduces_to_nstep_on_policy():
    g = _gen(0)
    T = 12
    logp = -torch.abs(torch.randn(T, generator=g))
    rewards = torch.randn(T, generator=g)
    discounts = 0.9 * torch.ones(T)
    values = torch.randn(T, generator=g)
    boot = torch.randn((), generator=g)
    out = TV.vtrace(logp, logp, rewards, discounts, values, boot)
    want = TV.nstep_returns(rewards, discounts, boot)
    np.testing.assert_allclose(_np(out.vs), _np(want), rtol=1e-5)


def test_vtrace_clipping_bounds_correction():
    """With clip_rho -> 0 the targets collapse to V (no correction)."""
    g = _gen(1)
    T = 8
    rewards = torch.randn(T, generator=g)
    values = torch.randn(T, generator=g)
    out = TV.vtrace(-torch.ones(T), torch.zeros(T), rewards,
                    0.9 * torch.ones(T), values, torch.zeros(()),
                    clip_rho=1e-9, clip_c=1e-9)
    np.testing.assert_allclose(_np(out.vs), _np(values), atol=1e-5)


def test_replay_ring_and_prioritized_sampling():
    rep = TR.replay_init(8, {"x": torch.zeros(2)})
    items = {"x": torch.arange(12, dtype=torch.float32).reshape(6, 2)}
    rep = TR.replay_add(rep, items, torch.ones(6))
    assert rep.size == 6 and rep.cursor == 6
    rep = TR.replay_add(rep, items, torch.ones(6))  # wraps
    assert rep.size == 8 and rep.cursor == 4
    # skew priorities: slot 0 gets huge priority
    rep = TR.replay_update_priorities(rep, torch.tensor([0]),
                                      torch.tensor([100.0]))
    _, idx, w = TR.replay_sample(rep, _gen(0), 256)
    counts = np.bincount(_np(idx), minlength=8)
    assert counts[0] > 0.5 * 256  # dominates sampling
    assert float(torch.max(w)) <= 1.0 + 1e-6


def test_gorila_learns_chain():
    """The JAX test's 300 rounds from seed 0.  At 300 rounds the chain's
    Q-learner is marginal in both packages: 11 of JAX's keys 0-19 and 12
    of the port's seeds 0-19 reach the goal (ROADMAP queue 3)."""
    state = TA.q_init(TENV, _gen(0), actors=4)
    r0 = _ret(state.params, TA.greedy_q_policy)
    g = _gen(0)
    for _ in range(300):
        state, m = TA.gorila_round(state, g, env=TENV)
    r1 = _ret(state.params, TA.greedy_q_policy)
    assert r1 >= r0
    assert r1 > 0.5  # reaches the goal most of the time


def test_apex_prioritized_variant_learns():
    state = TA.q_init(TENV, _gen(0), actors=4)
    g = _gen(5)
    for _ in range(300):
        state, m = TA.gorila_round(state, g, env=TENV, prioritized=True)
    assert _ret(state.params, TA.greedy_q_policy) > 0.5


def test_a3c_learns_chain():
    params = TA.ac_init(_gen(0), TENV.obs_dim, TENV.num_actions)
    states = TENV.reset((4,))
    r0 = _ret(params, TA.policy_logits)
    g = _gen(2)
    for _ in range(400):
        params, states, m = TA.a3c_round(params, states, g, env=TENV)
    r1 = _ret(params, TA.policy_logits)
    assert r1 >= r0 and r1 > 0.5


def test_dppo_learns_chain():
    params = TA.ac_init(_gen(0), TENV.obs_dim, TENV.num_actions)
    states = TENV.reset((4,))
    g = _gen(3)
    for _ in range(150):
        params, states, m = TA.dppo_round(params, states, g, env=TENV)
    assert _ret(params, TA.policy_logits) > 0.5


def test_impala_vtrace_beats_uncorrected_under_staleness():
    """Actors refresh params only every `refresh` rounds; with V-trace the
    learner tolerates the staleness and is never worse than without."""

    def run(use_vtrace, seed, refresh=8, rounds=400):
        params = TA.ac_init(_gen(seed), TENV.obs_dim, TENV.num_actions)
        actor_params = params
        states = TENV.reset((4,))
        g = _gen(seed + 2)
        for i in range(rounds):
            params, states, _ = TA.impala_round(
                params, actor_params, states, g, env=TENV,
                use_vtrace=use_vtrace)
            if (i + 1) % refresh == 0:
                actor_params = params
        return _ret(params, TA.policy_logits)

    rets_v = [run(True, s) for s in (0, 10)]
    rets_n = [run(False, s) for s in (0, 10)]
    assert np.mean(rets_v) > 0.5
    assert np.mean(rets_v) >= np.mean(rets_n) - 0.05


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=2, max_value=24),
       st.floats(min_value=8.0, max_value=64.0))
def test_replay_sample_respects_priorities_never_unwritten(n, factor):
    """For ANY fill level and boost factor the draws come only from the
    written region, the boosted slot is the modal draw, and its
    importance weight is the batch minimum."""
    cap = 32
    rep = TR.replay_init(cap, {"x": torch.zeros(())})
    rep = TR.replay_add(rep, {"x": torch.arange(n, dtype=torch.float32)},
                        torch.ones(n))
    j = n // 2
    rep = TR.replay_update_priorities(rep, torch.tensor([j]),
                                      torch.tensor([factor]))
    items, idx, w = TR.replay_sample(rep, _gen(n * 1009 + int(factor)), 512)
    idx, w = _np(idx), _np(w)
    assert (idx < n).all()
    counts = np.bincount(idx, minlength=cap)
    assert counts[j] == counts.max()
    assert counts[n:].sum() == 0
    assert np.array_equal(_np(items["x"]), idx.astype(np.float32))
    assert np.isclose(w[idx == j].min(), w.min())


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=1, max_value=64),
       st.integers(min_value=1, max_value=8))
def test_stratified_assign_balances_any_shape(n, shards):
    """The port's `stratified_assign`: balanced shards, the top band dealt
    one per shard."""
    from repro_torch.core.replay_shard import stratified_assign
    rng = np.random.default_rng(n * 8 + shards)
    prios = rng.uniform(0.1, 10.0, size=n)
    assign = stratified_assign(prios, shards)
    sizes = np.bincount(assign, minlength=shards)
    assert sizes.max() - sizes.min() <= 1
    k = min(n, shards)
    top = np.argsort(-prios, kind="stable")[:k]
    assert len(set(assign[top])) == k
