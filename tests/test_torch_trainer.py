"""Port vs JAX: the training loop's surface beyond the step.

  * ``core.batch_model`` (Eq. 21–24) equals the JAX package's copy exactly
    on a grid, and ``single_class_batches`` / ``iid_batches`` give the same
    arrays for one seed;
  * ``make_loss_and_grad(loss_fn, micro_batches=2)`` on the tiny
    transformer (f32) matches JAX's on the same params and batch: loss
    within 1e-6 relative, every gradient leaf within 1e-5 relative plus
    1e-5 of the leaf's largest |g| (the two frameworks sum in another
    order, and an element near zero carries the rounding of the larger
    terms summed into it; the largest deviation is 1.9e-6 of the leaf's
    largest |g|);
  * the fused engine with ``micro_batches=2`` is bit-exact with the
    per-step engine with ``micro_batches=2`` (the same body, in a plain loop
    on the CPU);
  * ``train(..., eval_fn, eval_every)`` on lenet-8x8 (the setup of
    ``tests/test_torch_cnn.py``) evaluates at the reference's steps with
    its accuracies within 1e-6, and ``wall_est`` is ``not step_sync``;
  * ``train``, ``make_loss_and_grad``, ``make_step_core`` and
    ``make_chunked_train_step`` have the reference's parameters.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cnns as J_CNNS
from repro.configs import zoo_config as j_zoo_config
from repro.core import ISGDConfig as J_ISGDConfig
from repro.core import batch_model as J_BM
from repro.data import synthetic as J_SYN
from repro.data.fcpr import FCPRSampler as JFCPR
from repro.models import build_model as j_build_model
from repro.models import cnn as JC
from repro.models import transformer as JT
from repro.optim import momentum as j_momentum
from repro.train import chunked as J_CHUNKED
from repro.train import trainer as J_TRAINER
from repro_torch.configs import paper_cnns as T_CNNS
from repro_torch.configs import zoo_config
from repro_torch.convert import cnn_from_jax, params_from_jax
from repro_torch.core import ISGDConfig
from repro_torch.core import batch_model as T_BM
from repro_torch.data import DeviceRing, FCPRSampler, make_lm_tokens
from repro_torch.data import synthetic as T_SYN
from repro_torch.models import build_model
from repro_torch.models.cnn import CNN, cnn_accuracy, cnn_loss_fn
from repro_torch.optim import momentum
from repro_torch.train import chunked as T_CHUNKED
from repro_torch.train import trainer as T_TRAINER
from repro_torch.train import (TrainLog, make_chunked_train_step,
                               make_loss_and_grad, make_step_core, train)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# copies held to the originals
# ---------------------------------------------------------------------------
def test_batch_model_equals_jax_on_a_grid():
    n_b = np.array([1, 10, 50, 128, 500, 1000, 3000])
    for c1, c2 in ((1e3, 0.01), (5e4, 0.2), (2e5, 1e-3)):
        np.testing.assert_array_equal(T_BM.iter_time(n_b, c1, c2),
                                      J_BM.iter_time(n_b, c1, c2))
        for T in (1, 10, 1e3, 1e5):
            np.testing.assert_array_equal(T_BM.loss_bound(n_b, T),
                                          J_BM.loss_bound(n_b, T))
        for psi in (0.5, 0.05, 0.01):
            np.testing.assert_array_equal(
                T_BM.predicted_time_to_loss(n_b, psi, c1, c2),
                J_BM.predicted_time_to_loss(n_b, psi, c1, c2))
            assert T_BM.optimal_batch_size(psi, c1, c2) == \
                J_BM.optimal_batch_size(psi, c1, c2)


@pytest.mark.parametrize("call", [
    ("single_class_batches", (0, 8), dict(image_size=8, channels=1)),
    ("single_class_batches", (5, 4), dict(num_classes=4, image_size=6,
                                          class_spread=0.5)),
    ("iid_batches", (0, 3, 2), dict(image_size=8, channels=1)),
    ("iid_batches", (7, 2, 3), dict(num_classes=5, image_size=6,
                                    noise=0.3)),
], ids=lambda c: c[0] if isinstance(c, str) else None)
def test_fig1_batches_identical_to_jax(call):
    name, args, kw = call
    want = getattr(J_SYN, name)(*args, **kw)
    got = getattr(T_SYN, name)(*args, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_signatures_match_jax():
    def names(fn):
        return list(inspect.signature(fn).parameters)

    assert names(T_TRAINER.train) == names(J_TRAINER.train)
    for p in ("eval_fn", "eval_every", "step_sync", "observer"):
        assert (inspect.signature(T_TRAINER.train).parameters[p].default
                == inspect.signature(J_TRAINER.train).parameters[p].default)
    for t_fn, j_fn in ((T_TRAINER.make_loss_and_grad, J_TRAINER.make_loss_and_grad),
                       (T_TRAINER.make_step_core, J_TRAINER.make_step_core),
                       (T_CHUNKED.make_chunked_train_step,
                        J_CHUNKED.make_chunked_train_step)):
        t_mb = inspect.signature(t_fn).parameters["micro_batches"]
        j_mb = inspect.signature(j_fn).parameters["micro_batches"]
        assert t_mb.default == j_mb.default == 1


# ---------------------------------------------------------------------------
# micro-batches
# ---------------------------------------------------------------------------
def test_micro_batches_match_jax():
    cfg, jcfg = zoo_config("transformer", "tiny"), j_zoo_config("transformer", "tiny")
    data = make_lm_tokens(3, 4, 64, cfg.vocab_size)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    jm = j_build_model(jcfg, kernels="reference", param_dtype=jnp.float32)
    jlg = J_TRAINER.make_loss_and_grad(jm.loss_fn, 2)
    (jl, ja), jg = jlg(jp, {"tokens": jnp.asarray(data["tokens"])})

    tm = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                     device="cpu")
    tm.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    lg = make_loss_and_grad(tm.loss_fn, micro_batches=2)
    (tl, ta), tg = lg(tm.params(), {"tokens": torch.from_numpy(data["tokens"])})

    assert tl.dtype == ta.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jg), cfg)
    names = [n for n, _ in tm.module.named_parameters()]
    assert len(tg) == len(names) == len(want)
    for name, g in zip(names, tg):
        assert g.dtype == torch.float32
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_micro_batches_refuse_a_ragged_split():
    lg = make_loss_and_grad(lambda b: (b["x"].sum(), b["x"].sum()), 2)
    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match="micro_batches=2"):
        lg([w], {"x": torch.ones(5, 3) * w})


def _regression(batch_size=8, n_batches=4, dim=6, seed=0):
    """The outlier-batch regression of ``tests/test_torch_chunked.py``."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(batch_size * n_batches, dim).astype(np.float32)
    ys = ((xs @ rng.randn(dim, 1).astype(np.float32)).ravel()
          / np.sqrt(dim)).astype(np.float32)
    ys[:batch_size] += 3.0
    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch_size, seed=1)
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=1.0, stop=3,
                      zeta=0.01)

    def make():
        params = [torch.zeros(dim, requires_grad=True),
                  torch.zeros((), requires_grad=True)]

        def loss_fn(batch):
            loss = torch.mean((batch["x"] @ params[0] + params[1]
                               - batch["y"]) ** 2)
            return loss, loss
        return params, loss_fn
    return make, sampler, icfg


def _tiny_transformer():
    cfg = zoo_config("transformer", "tiny")
    sampler = FCPRSampler(make_lm_tokens(0, 16, 32, cfg.vocab_size),
                          batch_size=4, seed=1)
    icfg = ISGDConfig(n_batches=4, k_sigma=-3.0, stop=2)

    def make():
        m = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                        device="cpu")
        m.init(0)
        return m.params(), m.loss_fn
    return make, sampler, icfg


def _lr_fn(psi_bar):
    return 0.01 + 0.001 * torch.clamp(psi_bar, max=1.0)


@pytest.mark.parametrize("problem,steps", [(_regression, 32),
                                           (_tiny_transformer, 8)],
                         ids=["regression", "tiny-transformer"])
def test_fused_micro_batches_bit_exact_with_per_step(problem, steps):
    make, sampler, icfg = problem()
    params, loss_fn = make()
    init_fn, step = make_step_core(loss_fn, momentum(0.9), icfg,
                                   lr_fn=_lr_fn, micro_batches=2)
    state = init_fn(params)
    ref = TrainLog()
    for j in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in sampler(j).items()}
        state, params, m = step(state, params, batch)
        ref.append(m, 0.0)

    cparams, closs = make()
    ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size, device="cpu")
    cinit, chunk = make_chunked_train_step(closs, momentum(0.9), icfg,
                                           chunk_steps=4, lr_fn=_lr_fn,
                                           micro_batches=2)
    cstate = cinit(cparams)
    got = TrainLog()
    for c in range(steps // 4):
        cstate, cparams, ms = chunk(cstate, cparams, ring.arrays, c * 4)
        got.extend(ms, 0.0)
    for key in ("losses", "limits", "psi_bar", "accelerated", "sub_iters"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key),
                                      err_msg=key)
    for a, b in zip(params, cparams):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert sum(ref.accelerated) > 0, "subproblem never fired"


# ---------------------------------------------------------------------------
# evaluation and walls
# ---------------------------------------------------------------------------
LENET_8X8 = dict(name="lenet-8x8", image_size=8, channels=1, num_classes=10,
                 hidden=(24,))


def test_train_evals_match_jax_lenet8x8():
    """momentum, init seed 1, k_sigma 1 (``tests/test_torch_cnn.py``'s
    setup, whose decisions are clear of their limits), three epochs, an
    evaluation every epoch on 300 held-out images of another seed."""
    jcfg = J_CNNS.CNNConfig(convs=(J_CNNS.ConvSpec(4, 3, pool=2),
                                   J_CNNS.ConvSpec(8, 3, pool=2)), **LENET_8X8)
    tcfg = T_CNNS.CNNConfig(convs=(T_CNNS.ConvSpec(4, 3, pool=2),
                                   T_CNNS.ConvSpec(8, 3, pool=2)), **LENET_8X8)
    data = T_SYN.make_classification(0, 64, 8, 1, 10, noise=0.2,
                                     class_spread=3.0)
    test = T_SYN.make_classification(9, 300, 8, 1, 10, noise=0.2,
                                     class_spread=3.0)
    kw = dict(n_batches=8, k_sigma=1.0, stop=3, zeta=0.02)
    jp = JC.init_cnn(jax.random.PRNGKey(1), jcfg)
    Xj, yj = jnp.asarray(test["images"]), jnp.asarray(test["labels"])
    _, _, jlog, jevals = J_TRAINER.train(
        jp, lambda p, b: JC.cnn_loss_fn(p, jcfg, b), j_momentum(0.9),
        JFCPR(data, batch_size=8, seed=1), steps=24, isgd_cfg=J_ISGDConfig(**kw),
        lr_fn=lambda _: jnp.asarray(0.03),
        eval_fn=lambda p: JC.cnn_accuracy(p, jcfg, Xj, yj), eval_every=8)

    module = CNN(tcfg, device="cpu")
    module.load_state_dict(cnn_from_jax(jax.tree.map(np.asarray, jp)))
    Xt, yt = torch.from_numpy(test["images"]), torch.from_numpy(test["labels"])
    _, state, log, evals = train(
        list(module.parameters()), lambda b: cnn_loss_fn(module, b),
        momentum(0.9), FCPRSampler(data, batch_size=8, seed=1), steps=24,
        isgd_cfg=ISGDConfig(**kw), lr_fn=lambda _: torch.tensor(0.03),
        eval_fn=lambda p: cnn_accuracy(module, Xt, yt), eval_every=8)

    assert [e[0] for e in evals] == [e[0] for e in jevals] == [8, 16, 24]
    np.testing.assert_allclose([e[2] for e in evals],
                               [float(e[2]) for e in jevals], rtol=0, atol=1e-6)
    assert log.accelerated == jlog.accelerated and sum(log.accelerated) >= 2
    assert log.sub_iters == jlog.sub_iters
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=1e-5)
    assert all(e[1] >= 0 for e in evals)
    assert [e[1] for e in evals] == sorted(e[1] for e in evals)


@pytest.mark.parametrize("step_sync", [False, True])
def test_wall_est_is_not_step_sync(step_sync):
    make, sampler, icfg = _regression()
    params, loss_fn = make()
    calls = []

    def eval_fn(p):
        calls.append(len(p))
        return float(p[1].detach())

    _, state, log, evals = train(params, loss_fn, momentum(0.9), sampler,
                                 steps=12, isgd_cfg=icfg, lr_fn=_lr_fn,
                                 eval_fn=eval_fn, eval_every=4,
                                 step_sync=step_sync)
    assert log.wall_est == [not step_sync] * 12
    assert len(log.losses) == 12 and state.iter == 12
    assert [e[0] for e in evals] == [4, 8, 12] and calls == [2, 2, 2]
    assert log.wall == sorted(log.wall)
    # an eval's wall is taken after its flush, so after its step's
    assert all(w >= log.wall[s - 1] for s, w, _ in evals)
