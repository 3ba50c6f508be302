"""Port vs JAX: the ten assigned architectures' configs and layer plans,
their weights' round trip, and the launcher's ``--arch`` / ``--model moe``.

For every ``ARCH_IDS`` entry, on the CPU:

  * the config, its ``reduced()`` variant, ``block_size()``,
    ``param_count`` (all and active) and the ``stack_plan`` specs (prefix,
    block, block count) equal the reference's;
  * ``params_to_jax(params_from_jax(t))`` returns the JAX init tree
    exactly, f32 and bf16 (raw 16-bit patterns), and the port's module
    takes it (``load_state_dict``, strict).

Loss and gradients of each reduced config against JAX are in
``tests/test_torch_arch_attn.py`` and ``tests/test_torch_arch_moe_ssm.py``
(``arch_matches_jax`` below), split so that each file stays well under
90 s on one worker.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from test_torch_moe import MARGIN, routing_margin

torch.set_num_threads(2)
B, S = 2, 32                     # S: two SSD chunks of 16, twice the window 16


def _specs(plan):
    prefix, block, n = plan
    return ([dataclasses.astuple(s) for s in prefix],
            [dataclasses.astuple(s) for s in block], n)


def _jax_params(jcfg, seed=0, dtype=jnp.float32):
    return jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(seed), jcfg, max_seq=S, dtype=dtype))


def test_arch_ids_match_jax():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_plan_match_jax(arch):
    for reduce in (False, True):
        cfg, jcfg = get_config(arch), j_get_config(arch)
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.block_size() == jcfg.block_size()
        for active in (False, True):
            assert cfg.param_count(active) == jcfg.param_count(active_only=active)
        assert _specs(T.stack_plan(cfg)) == _specs(JT.stack_plan(jcfg))
        assert [cfg._is_moe_layer(i) for i in range(cfg.num_layers)] == \
            [jcfg._is_moe_layer(i) for i in range(cfg.num_layers)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_round_trip_exact(arch):
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    tree = _jax_params(jcfg, seed=3)
    sd = params_from_jax(tree, cfg)
    m = build_model(cfg, param_dtype=torch.float32, device="cpu")
    m.init(0, max_seq=S)
    m.module.load_state_dict(sd)                       # strict: every leaf
    back = params_to_jax(sd, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    bf = _jax_params(jcfg, seed=3, dtype=jnp.bfloat16)
    back = params_to_jax(params_from_jax(bf, cfg), cfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a.view(np.uint16) if a.dtype.itemsize == 2 else a,
        b.view(np.uint16) if b.dtype.itemsize == 2 else b), back, bf)


def test_param_count_counts_encdec_mlps_as_swiglu():
    """A reference quirk the port copies (ROADMAP Queue C): the analytic
    ``param_count`` counts every decoder MLP as SwiGLU, 3·d·d_ff, but an
    enc-dec decoder's MLP is ``gelu2``, two matrices, 2·d·d_ff; so
    whisper's count is d·d_ff a layer too high (100.7 M of 911.9 M at full
    size). Both packages agree on the count and on the layers."""
    cfg, jcfg = get_config("whisper_medium"), j_get_config("whisper_medium")
    d, ff = cfg.d_model, cfg.d_ff
    assert cfg._mlp_params(0) == jcfg._mlp_params(0) == 3 * d * ff
    assert T.layer_spec(cfg, 0).mlp == JT.layer_spec(jcfg, 0).mlp == "gelu2"
    small = cfg.reduced()
    m = build_model(small, param_dtype=torch.float32, device="cpu")
    mlp = m.module.layers[0].mlp
    assert sorted(mlp) == ["wi", "wo"]
    assert sum(p.numel() for p in mlp.values()) == 2 * small.d_model * small.d_ff


def arch_matches_jax(arch, kernels, j_kernels, monkeypatch):
    """Loss, data loss and every gradient of ``arch``'s reduced config,
    port against JAX, f32, the JAX init carried over: losses within 1e-5
    relative, each gradient leaf within 1e-4 of its max|g|. A VLM's or an
    enc-dec model's frontend embeddings are seeded random values, so that
    the splice, the loss mask and the encoder are all exercised; MoE
    routing margins are asserted as in ``tests/test_torch_moe.py``."""
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab_size,
                                   size=(B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["frontend_embeds"] = rng.randn(
            B, cfg.num_image_tokens, cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        batch["frontend_embeds"] = rng.randn(
            B, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    jp = _jax_params(jcfg)
    jm = j_build_model(jcfg, kernels=j_kernels, param_dtype=jnp.float32)
    (jl, jdata), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})

    m = build_model(cfg, kernels=kernels, param_dtype=torch.float32,
                    device="cpu")
    m.init(0, max_seq=S)
    m.module.load_state_dict(params_from_jax(jp, cfg))
    gaps = routing_margin(monkeypatch)
    total, data = m.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(total, m.params())
    assert min(gaps, default=1.0) > MARGIN, gaps
    assert bool(gaps) == bool(cfg.num_experts)
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(data.item(), float(jdata), rtol=1e-5)
    names = [n for n, _ in m.module.named_parameters()]
    port = params_to_jax(dict(zip(names, grads)), cfg)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-4 * float(np.abs(b).max())),
        port, jax.tree.map(np.asarray, jg))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _launch(*args):
    return launcher.main(["--device", "cpu", "--precision", "f32",
                          "--n-seqs", "8", *args])


@pytest.mark.parametrize("chunk", ["1", "4"], ids=["per-step", "chunked"])
def test_launcher_trains_tiny_moe(chunk):
    res = _launch("--model", "moe", "--tier", "tiny", "--batch", "2",
                  "--seq", "64", "--steps", "8", "--k-sigma", "-3",
                  "--chunk-steps", chunk)
    assert res["steps"] == 8 and len(res["log"].losses) == 8
    assert all(np.isfinite(res["log"].losses))
    assert int(res["state"].accel_count) > 0


def test_launcher_trains_reduced_mixtral():
    res = _launch("--arch", "mixtral_8x22b", "--reduced", "--batch", "2",
                  "--seq", "32", "--steps", "3")
    assert res["steps"] == 3 and all(np.isfinite(res["log"].losses))


def test_launcher_whisper_fused_equals_per_step():
    """The fused engine's ring carries the frontend embeddings tiled per
    sample: its losses equal the per-step run's, which adds them to each
    host batch."""
    args = ("--arch", "whisper_medium", "--reduced", "--batch", "2",
            "--seq", "32", "--steps", "4")
    per_step = _launch(*args)["log"]
    fused = _launch(*args, "--chunk-steps", "4")["log"]
    assert fused.losses == per_step.losses
    assert all(np.isfinite(fused.losses))


@pytest.mark.parametrize("extra", [(), ("--model", "moe", "--arch",
                                        "mixtral_8x22b")],
                         ids=["neither", "both"])
def test_launcher_needs_exactly_one_of_arch_and_model(extra):
    with pytest.raises(SystemExit, match="exactly one of --arch or --model"):
        _launch("--steps", "1", *extra)


def test_launcher_refuses_reduced_zoo_model():
    with pytest.raises(SystemExit, match="--reduced applies to --arch"):
        _launch("--model", "moe", "--reduced", "--steps", "1")
