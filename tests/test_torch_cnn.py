"""Port vs JAX: the paper's CNNs, their data and their ISGD trajectory.

  * ``make_classification`` (and the mnist/cifar/imagenet-like presets) is
    array-identical to the JAX package's for one seed;
  * the config tables are field for field the JAX package's;
  * ``cnn_logits`` and ``cnn_loss_fn`` agree with JAX on the same weights
    (``convert.cnn_from_jax``) for LeNet (28 px), CIFAR-quick (16 px) and
    AlexNet-small (64 px, batch 2), f32: losses within 1e-5 relative,
    logits within 1e-5 relative plus 1e-5 of the largest |logit| (logits
    near zero carry the rounding of the larger terms summed into them);
  * the lenet-8x8 network of ``tests/test_async_ps.py`` (its data, batch,
    stop, ζ and LR) trains through both packages' ``make_train_step`` for
    three epochs with sgd, momentum and nesterov: the same accelerate and
    sub_iters sequences, losses within 1e-5 relative, and no decision of
    the port within 1e-3 relative of its limit (so f32 rounding cannot flip
    one). That test's k_sigma = 1.5 fires the subproblem at most once in
    three epochs, with a decision 1e-5 from its limit for sgd, so each rule
    takes an init seed and k_sigma where it fires at least twice with every
    decision clear of its limit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cnns as J_CNNS
from repro.core import ISGDConfig as J_ISGDConfig
from repro.data import synthetic as J_SYN
from repro.data.fcpr import FCPRSampler as JFCPR
from repro.models import cnn as JC
from repro.optim import RULES as J_RULES
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import paper_cnns as T_CNNS
from repro_torch.convert import cnn_from_jax, cnn_to_jax
from repro_torch.core import ISGDConfig
from repro_torch.data import FCPRSampler
from repro_torch.data import synthetic as T_SYN
from repro_torch.models.cnn import (CNN, cnn_accuracy, cnn_logits,
                                    cnn_loss_fn, init_cnn, same_pad)
from repro_torch.optim import RULES
from repro_torch.train import make_train_step

torch.set_num_threads(2)


@pytest.mark.parametrize("call", [
    ("make_classification", (0, 50, 8, 1, 10), dict(noise=0.2, class_spread=3.0)),
    ("make_classification", (3, 40, 16, 3, 10),
     dict(noise=0.7, class_skew=0.3, class_spread=2.0, difficulty=1.5)),
    ("make_classification", (1, 20, 64, 3, 1000), dict(noise=0.5, difficulty=2.0)),
    ("mnist_like", (), dict(seed=2, n=30)),
    ("cifar_like", (), dict(seed=2, n=30)),
    ("imagenet_like", (), dict(seed=2, n=10)),
], ids=lambda c: c[0] if isinstance(c, str) else None)
def test_classification_data_identical_to_jax(call):
    name, args, kw = call
    want = getattr(J_SYN, name)(*args, **kw)
    got = getattr(T_SYN, name)(*args, **kw)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_cnn_configs_equal_jax():
    assert list(T_CNNS.PAPER_CNNS) == list(J_CNNS.PAPER_CNNS)
    for name, j in J_CNNS.PAPER_CNNS.items():
        t = T_CNNS.PAPER_CNNS[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert t.family == j.family == "cnn"
    for n in ("LENET", "CIFAR_QUICK", "ALEXNET_SMALL"):
        assert dataclasses.asdict(getattr(T_CNNS, n)) == \
            dataclasses.asdict(getattr(J_CNNS, n))
    assert dataclasses.asdict(T_CNNS.ConvSpec(8, 3)) == \
        dataclasses.asdict(J_CNNS.ConvSpec(8, 3))


@pytest.mark.parametrize("n,k,s,want", [
    (64, 11, 4, (3, 4)),      # AlexNet-small conv1: asymmetric
    (16, 3, 2, (0, 1)),       # its first pool
    (28, 5, 1, (2, 2)), (14, 2, 2, (0, 0)), (7, 3, 2, (1, 1)),
])
def test_same_pad_is_jax_same(n, k, s, want):
    assert same_pad(n, k, s) == want
    lo, hi = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert (lo, hi) == want


CASES = [("lenet", 28, 4), ("cifar-quick", 16, 4), ("alexnet-small", 64, 2)]


def _both(name, size, seed=0):
    jcfg = dataclasses.replace(J_CNNS.PAPER_CNNS[name], image_size=size)
    tcfg = dataclasses.replace(T_CNNS.PAPER_CNNS[name], image_size=size)
    jp = JC.init_cnn(jax.random.PRNGKey(seed), jcfg)
    module = CNN(tcfg, device="cpu")
    module.load_state_dict(cnn_from_jax(jax.tree.map(np.asarray, jp)))
    return jcfg, jp, module


@pytest.mark.parametrize("name,size,batch", CASES, ids=[c[0] for c in CASES])
def test_cnn_logits_and_loss_match_jax(name, size, batch):
    jcfg, jp, module = _both(name, size)
    data = T_SYN.make_classification(5, batch, size, jcfg.channels,
                                     jcfg.num_classes)
    want = np.asarray(JC.cnn_logits(jp, jcfg, jnp.asarray(data["images"])))
    with torch.no_grad():
        got = cnn_logits(module, torch.from_numpy(data["images"])).numpy()
    assert got.shape == want.shape == (batch, jcfg.num_classes)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    jl = JC.cnn_loss_fn(jp, jcfg, {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        tl = cnn_loss_fn(module, {k: torch.from_numpy(v)
                                  for k, v in data.items()})
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    acc = cnn_accuracy(module, torch.from_numpy(data["images"]),
                       torch.from_numpy(data["labels"]))
    jacc = JC.cnn_accuracy(jp, jcfg, jnp.asarray(data["images"]),
                           jnp.asarray(data["labels"]))
    assert acc == jacc


def test_cnn_weights_round_trip_and_init_scales():
    jcfg, jp, module = _both("lenet", 28)
    back = cnn_to_jax(module.state_dict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    fresh = init_cnn(CNN(T_CNNS.LENET, device="cpu"), seed=0).state_dict()
    ref = cnn_from_jax(jax.tree.map(np.asarray, jp))
    assert fresh.keys() == ref.keys()
    for name, p in fresh.items():
        assert p.shape == ref[name].shape
        if name.endswith(".b"):
            assert not p.any() and not ref[name].any()
        else:                 # the reference's scale, not its draws
            ratio = float(p.std() / ref[name].std())
            assert 0.8 < ratio < 1.25, (name, ratio)


LENET_8X8 = dict(name="lenet-8x8", image_size=8, channels=1, num_classes=10,
                 hidden=(24,))
STEPS = 24                                   # 3 epochs of 8 batches


@pytest.mark.parametrize("rule,seed,k_sigma", [
    ("sgd", 0, 0.5), ("momentum", 1, 1.0), ("nesterov", 1, 1.0)])
def test_lenet8x8_trajectory_matches_jax(rule, seed, k_sigma):
    jcfg = J_CNNS.CNNConfig(convs=(J_CNNS.ConvSpec(4, 3, pool=2),
                                   J_CNNS.ConvSpec(8, 3, pool=2)),
                            **LENET_8X8)
    tcfg = T_CNNS.CNNConfig(convs=(T_CNNS.ConvSpec(4, 3, pool=2),
                                   T_CNNS.ConvSpec(8, 3, pool=2)),
                            **LENET_8X8)
    data = T_SYN.make_classification(0, 64, 8, 1, 10, noise=0.2,
                                     class_spread=3.0)
    kw = dict(n_batches=8, k_sigma=k_sigma, stop=3, zeta=0.02)
    jp = JC.init_cnn(jax.random.PRNGKey(seed), jcfg)

    jinit, jstep = j_make_train_step(lambda p, b: JC.cnn_loss_fn(p, jcfg, b),
                                     J_RULES[rule](), J_ISGDConfig(**kw),
                                     lr_fn=lambda _: jnp.asarray(0.03),
                                     donate=False)
    jstate, jparams = jinit(jp), jp
    jsamp = JFCPR(data, batch_size=8, seed=1)
    ref = []
    for j in range(STEPS):
        jstate, jparams, m = jstep(jstate, jparams,
                                   {k: jnp.asarray(v) for k, v in jsamp(j).items()})
        ref.append((float(m["loss"]), bool(m["accelerated"]),
                    int(m["sub_iters"])))

    module = CNN(tcfg, device="cpu")
    module.load_state_dict(cnn_from_jax(jax.tree.map(np.asarray, jp)))
    seen = []                      # every ψ the port evaluates, in order

    def loss_fn(batch):
        total, aux = cnn_loss_fn(module, batch)
        seen.append(float(total.detach()))
        return total, aux

    tinit, tstep = make_train_step(loss_fn, RULES[rule](), ISGDConfig(**kw),
                                   lr_fn=lambda _: torch.tensor(0.03))
    params = list(module.parameters())
    state = tinit(params)
    samp = FCPRSampler(data, batch_size=8, seed=1)
    port, margins = [], []
    for j in range(STEPS):
        seen.clear()
        batch = {k: torch.from_numpy(v) for k, v in samp(j).items()}
        state, params, m = tstep(state, params, batch)
        port.append((float(m["loss"]), m["accelerated"], m["sub_iters"]))
        limit = float(m["limit"])
        if np.isfinite(limit):
            tested = seen if m["sub_iters"] < kw["stop"] else seen[:-1]
            margins += [abs(p - limit) / abs(limit) for p in tested]
    assert [p[1:] for p in port] == [r[1:] for r in ref]
    np.testing.assert_allclose([p[0] for p in port], [r[0] for r in ref],
                               rtol=1e-5)
    assert state.accel_count == int(jstate.accel_count) >= 2
    assert min(margins) > 1e-3, min(margins)
