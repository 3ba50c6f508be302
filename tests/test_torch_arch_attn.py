"""Port vs JAX: loss and gradients of the reduced attention-only
architectures (dense GQA, enc-dec, VLM, sliding window with global
layers), in both kernel modes. See ``arch_matches_jax`` in
``tests/test_torch_arch.py``. Also the layer functions' options that the
full-sequence forward leaves at their defaults."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from test_torch_arch import arch_matches_jax

ARCHS = ["internlm2_1_8b", "whisper_medium", "starcoder2_3b",
         "deepseek_coder_33b", "internvl2_2b", "gemma3_12b"]


@pytest.mark.parametrize("kernels,j_kernels", [("cuda", "interpret"),
                                               ("reference", "reference")])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_matches_jax(arch, kernels, j_kernels, monkeypatch):
    arch_matches_jax(arch, kernels, j_kernels, monkeypatch)


def _draw(rng, *shape, fan_in=1):
    return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)


@pytest.mark.parametrize("case", ["attend_q_offset", "attend_q_offset_window",
                                  "mla_noncausal", "mla_q_offset", "mlp_gelu"])
def test_layer_options_match_jax(case):
    """The options that only the decode halves (ROADMAP A13) will set, port
    against JAX at f32: a block of queries at an offset into the keys
    (``_attend_chunked``'s and ``_mla_attend``'s ``q_offset``, with and
    without a window), non-causal MLA, and the gated MLP with GELU."""
    rng = np.random.RandomState(0)
    if case.startswith("attend"):
        q = _draw(rng, 2, 8, 4, 16)
        k, v = _draw(rng, 2, 24, 2, 16), _draw(rng, 2, 24, 2, 16)
        kw = dict(causal=True, q_offset=16,
                  window=6 if case.endswith("window") else None)
        ref = JL._attend_chunked(*map(jnp.asarray, (q, k, v)), **kw)
        out = L._attend_chunked(*map(torch.from_numpy, (q, k, v)), **kw)
    elif case.startswith("mla"):
        arch = "deepseek_v2_lite_16b"
        cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
        H, d, r = cfg.num_heads, cfg.d_model, cfg.kv_lora_rank
        dr, dn, dv = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
        p = {"wk_b": _draw(rng, r, H * dn, fan_in=r),
             "wv_b": _draw(rng, r, H * dv, fan_in=r),
             "wo": _draw(rng, H * dv, d, fan_in=H * dv)}
        ins = (_draw(rng, 2, 8, H, dn), _draw(rng, 2, 8, H, dr),
               _draw(rng, 2, 24, r), _draw(rng, 2, 24, 1, dr))
        kw = (dict(causal=False) if case == "mla_noncausal"
              else dict(causal=True, q_offset=16))
        ref = JL._mla_attend({n: jnp.asarray(w) for n, w in p.items()}, jcfg,
                             *map(jnp.asarray, ins), **kw)
        out = L._mla_attend({n: torch.from_numpy(w) for n, w in p.items()}, cfg,
                            *map(torch.from_numpy, ins), **kw)
    else:
        p = {"wg": _draw(rng, 32, 64, fan_in=32), "wi": _draw(rng, 32, 64, fan_in=32),
             "wo": _draw(rng, 64, 32, fan_in=64)}
        x = _draw(rng, 2, 8, 32)
        ref = JL.mlp({n: jnp.asarray(w) for n, w in p.items()}, jnp.asarray(x),
                     activation="gelu")
        out = L.mlp({n: torch.from_numpy(w) for n, w in p.items()},
                    torch.from_numpy(x), activation="gelu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
