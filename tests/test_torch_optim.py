"""Port vs JAX: every base update rule, from the same weights and grads.

Tolerance is ulp-scale (rtol 2e-7, atol 1e-8 after two applies): the two
frameworks may contract a mul+add into an fma differently, so bit-exactness
is not a fair demand here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import RULES as J_RULES
from repro_torch.optim import RULES

torch.set_num_threads(2)
SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_matches_jax(name):
    assert sorted(RULES) == sorted(J_RULES)
    rng = np.random.RandomState(0)
    w = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(2)]
    lr = np.float32(0.05)

    jr = J_RULES[name]()
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    js = jr.init(jp)
    tr = RULES[name]()
    tp = [torch.from_numpy(w[k].copy()) for k in SHAPES]
    ts = tr.init(tp)
    for g in grads:
        js, jp = jr.apply(js, jp, {k: jnp.asarray(v) for k, v in g.items()},
                          jnp.asarray(lr))
        ts = tr.apply(ts, tp, [torch.from_numpy(g[k]) for k in SHAPES],
                      torch.tensor(lr))
    for k, t in zip(SHAPES, tp):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                   rtol=2e-7, atol=1e-8)
