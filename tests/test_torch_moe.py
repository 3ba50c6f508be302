"""Port vs JAX: the MoE layer (``repro_torch.models.moe``) and the
``paper-moe`` zoo configs, on the CPU in f32.

  * ``_capacity`` equals the reference's over a grid of (g, top_k, E, cf);
  * ``_route_groups`` equals the reference's ``_route_group`` of each group
    in ``y`` (atol 1e-5 · max|y|), ``aux`` (rtol 1e-5) and the routed
    experts (equal), with capacity drops (cf 1.25, asserted to occur) and
    without (cf 1e9);
  * ``moe_forward`` with shared experts, one group shorter than 128 and
    two groups a row, equals the reference's;
  * ``paper-moe-tiny``'s total loss, data loss and every gradient equal
    JAX's with the JAX init carried over (cuda↔interpret and
    reference↔reference; losses rtol 1e-5, each gradient leaf atol
    1e-4 · its max|g|, as ``tests/test_torch_model.py``);
  * the tiny and base configs and ``param_count(active_only)`` equal the
    reference's.

Routing is a top-k over f32 router probabilities; XLA and torch may
differ in a logit's last bit, and a near-tie would then route a token to
another expert. The seeds here are ones where every gap between the
sorted top k + 1 probabilities of every token is above ``MARGIN``, and
each test asserts it (``routing_margin``), so a flip cannot pass unseen.
The fused engine's bit-exactness on ``paper-moe-tiny`` is a case of
``tests/test_torch_chunked.py::test_chunked_bit_exact_vs_per_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JModelConfig
from repro.configs import zoo_config as j_zoo_config
from repro.models import build_model as j_build_model
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import ModelConfig, zoo_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import build_model
from repro_torch.models import moe as M

torch.set_num_threads(2)
MARGIN = 1e-4


def routing_margin(monkeypatch) -> list:
    """Record, for every ``_router`` call from now on, the smallest gap
    between consecutive sorted probabilities among each token's top k + 1
    (the gaps that decide which experts, and in which order). -> the list
    the gaps are appended to."""
    gaps = []
    router = M._router

    def recording(p, x, top_k):
        probs, gates, idx = router(p, x, top_k)
        s = torch.sort(probs.detach(), dim=-1, descending=True).values
        k = min(top_k + 1, s.shape[-1])
        gaps.append(float((s[..., :k - 1] - s[..., 1:k]).min()))
        return probs, gates, idx
    monkeypatch.setattr(M, "_router", recording)
    return gaps


def _moe_params(cfg, seed=0):
    """The JAX ``init_moe`` leaves in f32, as numpy and as torch."""
    jp = JM.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    npp = {k: np.asarray(v) for k, v in jp.items()}
    return jp, {k: torch.from_numpy(v.copy()) for k, v in npp.items()}


def _jax_top_k(jp, x, k):
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


@pytest.mark.parametrize("g", [1, 4, 16, 64, 128])
@pytest.mark.parametrize("top_k,E", [(1, 4), (2, 4), (2, 8), (6, 64)])
def test_capacity_matches_jax(g, top_k, E):
    for cf in (0.5, 1.0, 1.25, 2.0, 1e9):
        assert M._capacity(g, top_k, E, cf) == JM._capacity(g, top_k, E, cf)


@pytest.mark.parametrize("cf", [1.25, 1e9], ids=["drops", "no-drop"])
def test_route_group_matches_jax(cf, monkeypatch):
    g, d, E, k = 128, 64, 8, 2
    cfg = JModelConfig(name="t", family="moe", num_layers=1, d_model=d,
                       num_experts=E, top_k=k, moe_d_ff=96)
    jp, tp = _moe_params(cfg, seed=1)
    x = np.random.RandomState(3).randn(g, d).astype(np.float32)
    jy, jaux = JM._route_group(jp, jnp.asarray(x), k, E, cf)

    gaps = routing_margin(monkeypatch)
    _, _, idx = M._router(tp, torch.from_numpy(x)[None], k)
    y, aux = M._route_groups(tp, torch.from_numpy(x)[None], k, E, cf)
    assert min(gaps) > MARGIN, gaps
    np.testing.assert_array_equal(idx[0].numpy(), _jax_top_k(jp, x, k))
    np.testing.assert_allclose(y[0].numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)

    # drops: slots past an expert's capacity C
    C = M._capacity(g, k, E, cf)
    over = np.maximum(np.bincount(idx.numpy().ravel(), minlength=E) - C, 0)
    assert (over.sum() > 0) == (cf == 1.25), (C, over)


@pytest.mark.parametrize("S", [48, 256], ids=["S48-one-group", "S256-two-groups"])
def test_moe_forward_matches_jax(S, monkeypatch):
    B, d = 2, 64
    fields = dict(name="t", family="moe", num_layers=1, d_model=d,
                  num_experts=4, num_shared_experts=2, top_k=2, moe_d_ff=32,
                  moe_capacity_factor=1.25)
    jcfg, cfg = JModelConfig(**fields), ModelConfig(**fields)
    jp, tp = _moe_params(jcfg, seed=2)
    x = np.random.RandomState(4).randn(B, S, d).astype(np.float32)
    jy, jaux = JM.moe_forward(jp, jcfg, jnp.asarray(x))
    gaps = routing_margin(monkeypatch)
    y, aux = M.moe_forward(tp, cfg, torch.from_numpy(x))
    assert min(gaps) > MARGIN, gaps
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


def test_configs_match_jax():
    for tier in ("tiny", "base"):
        a, b = zoo_config("moe", tier), j_zoo_config("moe", tier)
        assert a == ModelConfig(**{f: getattr(b, f) for f in
                                   ModelConfig.__dataclass_fields__})
        for active in (False, True):
            assert a.param_count(active) == b.param_count(active_only=active)
    base = zoo_config("moe", "base")
    assert base.param_count() == 281_616_384
    assert base.param_count(active_only=True) == 154_214_400


@pytest.mark.parametrize("kernels,j_kernels", [("cuda", "interpret"),
                                               ("reference", "reference")])
def test_tiny_moe_matches_jax(kernels, j_kernels, monkeypatch):
    cfg, jcfg = zoo_config("moe", "tiny"), j_zoo_config("moe", "tiny")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                            size=(2, 64)).astype(np.int32)
    jm = j_build_model(jcfg, kernels=j_kernels, param_dtype=jnp.float32)
    (jl, jdata), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})

    m = build_model(cfg, kernels=kernels, param_dtype=torch.float32,
                    device="cpu")
    m.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    gaps = routing_margin(monkeypatch)
    total, data = m.loss_fn({"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(total, m.params())
    assert min(gaps) > MARGIN, gaps
    assert float(jl) != float(jdata)          # the aux term is in ψ
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(data.item(), float(jdata), rtol=1e-5)

    names = [n for n, _ in m.module.named_parameters()]
    port = params_to_jax(dict(zip(names, grads)), cfg)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-4 * float(np.abs(b).max())),
        port, jax.tree.map(np.asarray, jg))
