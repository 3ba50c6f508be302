"""Port vs JAX: ISGD trajectories on the tiny transformer and the tiny SSM
stack.

Both packages train from the same JAX-initialized f32 weights on the same
FCPR batches through ``make_train_step`` for three epochs of four batches.
They must accelerate at the same steps with the same ``sub_iters``, and
their losses agree within 1e-5 relative (f32 rounding differences in the
two frameworks' reductions, measured at about 3e-7).

(a) ``k_sigma = -3`` puts the limit far below ψ: every post-warm-up step
    accelerates and every Alg.2 trip runs to ``stop``.
(b) ``k_sigma = 1`` on a setup (seed 2, ζ = 1) where no decision of the
    port lies within 1e-3 relative of its limit, asserted below.

The JAX package's ``nesterov``/``adagrad``/``adam`` treat every tuple in
the param tree as a leaf (``is_leaf=isinstance(t, tuple)``), which breaks
on the transformer's ``blocks`` tuple; the JAX side gets ``blocks`` as a
list, which the model indexes the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import zoo_config as j_zoo_config
from repro.core import ISGDConfig as J_ISGDConfig
from repro.core import isgd as J_isgd
from repro.core.schedule import constant_lr as j_constant_lr
from repro.data.fcpr import FCPRSampler as JFCPR
from repro.models import build_model as j_build_model
from repro.models import transformer as JT
from repro.optim import RULES as J_RULES
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import zoo_config
from repro_torch.convert import params_from_jax
from repro_torch.core import ISGDConfig, constant_lr, isgd
from repro_torch.data import FCPRSampler, make_lm_tokens
from repro_torch.models import build_model
from repro_torch.optim import RULES
from repro_torch.train import make_train_step

torch.set_num_threads(2)
STEPS, BATCH, LR, STOP = 12, 2, 0.005, 3


def _run_both(rule, k_sigma, seed, zeta, model="transformer"):
    CFG, JCFG = zoo_config(model, "tiny"), j_zoo_config(model, "tiny")
    data = make_lm_tokens(0, 4 * BATCH, 64, CFG.vocab_size)
    jp = JT.init_params(jax.random.PRNGKey(seed), JCFG, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)

    jm = j_build_model(JCFG, kernels="reference", param_dtype=jnp.float32)
    jinit, jstep = j_make_train_step(
        jm.loss_fn, J_RULES[rule](),
        J_ISGDConfig(n_batches=4, k_sigma=k_sigma, stop=STOP, zeta=zeta),
        lr_fn=j_constant_lr(LR))
    jparams = dict(jp, blocks=list(jp["blocks"]))
    jstate = jinit(jparams)
    jsamp = JFCPR(data, batch_size=BATCH, seed=1)
    ref = []
    for j in range(STEPS):
        jstate, jparams, m = jstep(jstate, jparams, jsamp(j))
        ref.append((float(m["loss"]), bool(m["accelerated"]), int(m["sub_iters"])))

    tm = build_model(CFG, kernels="reference", param_dtype=torch.float32,
                     device="cpu")
    tm.module.load_state_dict(params_from_jax(tree, CFG))
    seen = []                        # every ψ the port evaluates, in order

    def loss_fn(batch):
        total, aux = tm.loss_fn(batch)
        seen.append(total.item())
        return total, aux

    tinit, tstep = make_train_step(
        loss_fn, RULES[rule](),
        ISGDConfig(n_batches=4, k_sigma=k_sigma, stop=STOP, zeta=zeta),
        lr_fn=constant_lr(LR))
    params = tm.params()
    state = tinit(params)
    samp = FCPRSampler(data, batch_size=BATCH, seed=1)
    port, margins = [], []
    for j in range(STEPS):
        seen.clear()
        batch = {"tokens": torch.from_numpy(samp(j)["tokens"])}
        state, params, m = tstep(state, params, batch)
        port.append((float(m["loss"]), m["accelerated"], m["sub_iters"]))
        limit = float(m["limit"])
        if np.isfinite(limit):
            # the step's test, then each trip's test of the previous ψ
            # (the ψ of the last trip is tested only when stop is not hit)
            tested = seen if m["sub_iters"] < STOP else seen[:-1]
            margins += [abs(p - limit) / abs(limit) for p in tested]
    assert state.accel_count == int(jstate.accel_count)
    assert state.sub_iters == int(jstate.sub_iters)
    return ref, port, margins


def _assert_same(ref, port):
    assert [r[1:] for r in ref] == [p[1:] for p in port]
    np.testing.assert_allclose([p[0] for p in port], [r[0] for r in ref],
                               rtol=1e-5)


@pytest.mark.parametrize("rule", ["sgd", "momentum", "nesterov"])
def test_trajectory_every_step_accelerates(rule):
    ref, port, margins = _run_both(rule, k_sigma=-3.0, seed=0, zeta=None)
    _assert_same(ref, port)
    assert [p[1:] for p in port[4:]] == [(True, STOP)] * (STEPS - 4)
    assert min(margins) > 1e-3


@pytest.mark.parametrize("rule", ["sgd", "momentum", "nesterov"])
def test_trajectory_k1_matches_jax(rule):
    ref, port, margins = _run_both(rule, k_sigma=1.0, seed=2, zeta=1.0)
    _assert_same(ref, port)
    assert sum(p[1] for p in port) >= 3          # the branch really fires
    assert min(margins) > 1e-3, min(margins)


def test_solve_subproblem_matches_jax():
    """A fixed analytic loss ψ(w) = ½‖w − c‖²: the same iterations and the
    same weights from both Alg.2 loops, for several limits.

    The weights agree within rtol 2e-5: the two frameworks sum ψ in another
    order, and the step scales by ψ − limit, which cancels to a few ulps of
    ψ when the limit sits just under it (limit = 0.99·ψ): one ulp of ψ is
    then about 6e-6 of ψ − limit, and so of the gradient part of the step."""
    rng = np.random.RandomState(0)
    c = rng.randn(6).astype(np.float32)
    w = rng.randn(6).astype(np.float32)
    cfg_kw = dict(n_batches=4, stop=5, epsilon=0.1, zeta=0.3)

    def j_lg(p):
        return 0.5 * jnp.sum((p["w"] - c) ** 2), {"w": p["w"] - c}

    def t_lg(params):
        d = params[0] - torch.from_numpy(c)
        return 0.5 * torch.sum(d * d), [d]

    entry = float(0.5 * np.sum((w - c) ** 2))
    for limit in (entry * 0.99, entry * 0.5, entry * 0.01, entry * 2):
        jw, jused = J_isgd.solve_subproblem(
            j_lg, {"w": jnp.asarray(w)}, jnp.float32(limit),
            jnp.float32(entry), 0.1, J_ISGDConfig(**cfg_kw))
        tw, tused = isgd.solve_subproblem(
            t_lg, [torch.from_numpy(w.copy())],
            torch.tensor(limit, dtype=torch.float32),
            torch.tensor(entry, dtype=torch.float32), 0.1,
            ISGDConfig(**cfg_kw))
        assert tused == int(jused)
        np.testing.assert_allclose(tw[0].numpy(), np.asarray(jw["w"]),
                                   rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("k_sigma,seed,zeta", [(-3.0, 0, None), (1.0, 6, 1.0)],
                         ids=["every-step", "k1"])
def test_trajectory_ssm_matches_jax(k_sigma, seed, zeta):
    """The momentum rule on ``paper-ssm-tiny`` (SSD mixer layers, no MLP).
    For k_sigma = 1, seed 6 is a setup where the branch fires three times
    and no decision lies within 1e-3 relative of its limit."""
    ref, port, margins = _run_both("momentum", k_sigma=k_sigma, seed=seed,
                                   zeta=zeta, model="ssm")
    _assert_same(ref, port)
    assert sum(p[1] for p in port) >= 3          # the branch really fires
    assert min(margins) > 1e-3, min(margins)
