"""Port vs JAX: the tiny dense transformer's loss and every gradient.

Weights come from the JAX ``init_params`` and are carried over with
``params_from_jax``. The port's ``kernels="cuda"`` on the CPU runs the
kernels' plain versions and is compared with JAX ``"interpret"`` (the Pallas
kernels in interpret mode); ``"reference"`` with ``"reference"``. In f32:
loss within 1e-5 relative, each gradient leaf within 1e-4 of its max-abs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import zoo_config as j_zoo_config
from repro.models import build_model as j_build_model
from repro.models import transformer as JT
from repro_torch.configs import zoo_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import build_model

torch.set_num_threads(2)
CFG = zoo_config("transformer", "tiny")
JCFG = j_zoo_config("transformer", "tiny")


def _jax_params(seed=0):
    return JT.init_params(jax.random.PRNGKey(seed), JCFG, dtype=jnp.float32)


def _tokens(B=2, S=64, seed=0):
    return np.random.RandomState(seed).randint(0, CFG.vocab_size,
                                               size=(B, S)).astype(np.int32)


def test_configs_match_jax():
    for tier in ("tiny", "base"):
        a, b = zoo_config("transformer", tier), j_zoo_config("transformer", tier)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "norm_eps", "rope_theta",
                  "tie_embeddings", "sliding_window", "padded_vocab"):
            assert getattr(a, f) == getattr(b, f), (tier, f)
        assert a.param_count() == b.param_count()
    assert 318e6 < zoo_config("transformer", "base").param_count() < 320e6


@pytest.mark.parametrize("kernels,j_kernels", [("cuda", "interpret"),
                                               ("reference", "reference")])
def test_tiny_model_matches_jax(kernels, j_kernels):
    jp = _jax_params()
    toks = _tokens()
    jm = j_build_model(JCFG, kernels=j_kernels, param_dtype=jnp.float32)
    (jl, jaux), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})

    m = build_model(CFG, kernels=kernels, param_dtype=torch.float32,
                    device="cpu")
    m.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), CFG))
    total, aux = m.loss_fn({"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(total, m.params())
    assert total.dtype == torch.float32
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)

    names = [n for n, _ in m.module.named_parameters()]
    port = params_to_jax(dict(zip(names, grads)), CFG)
    ref = jax.tree.map(np.asarray, jg)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-4 * float(np.abs(b).max())), port, ref)


def test_params_round_trip_exact():
    tree = jax.tree.map(np.asarray, _jax_params(seed=3))
    back = params_to_jax(params_from_jax(tree, CFG), CFG)
    assert (jax.tree.structure(back) == jax.tree.structure(tree))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), back, tree)
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    back = params_to_jax(params_from_jax(bf, CFG), CFG)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.view(np.uint16),
                                                            b.view(np.uint16)),
                 back, bf)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal; this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(CFG)
    with pytest.raises(ValueError):
        build_model(CFG, kernels="pallas", device="cpu")
