"""Port vs JAX: the SPC loss queue, the LR schedules and the data copies.

The queue's state must match byte for byte: ``_sq`` makes every Σ² term
exact, so nothing is left to compiler contraction or reduction order.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import control as JC
from repro.core import schedule as JS
from repro.data.fcpr import FCPRSampler as JFCPR
from repro.data.synthetic import make_lm_tokens as j_tokens
from repro_torch.core import control as TC
from repro_torch.core import schedule as TS
from repro_torch.data import FCPRSampler, make_lm_tokens

torch.set_num_threads(2)


def _loss_stream(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return (2.0 + rng.randn(n) * 0.3).astype(np.float32)


def _queues(n_b=5):
    """The same stream through both queues: FIFO pushes, then per-batch
    table writes at out-of-order slots. Yields (jax_queue, port_queue)
    after every write."""
    losses = _loss_stream()
    jq, tq = JC.init_queue(n_b), TC.init_queue(n_b, device="cpu")
    for i, x in enumerate(losses):
        if i < 14:
            jq, tq = JC.push(jq, jnp.float32(x)), TC.push(tq, torch.tensor(x))
        else:
            slot = (i * 3) % n_b
            jq = JC.push_at(jq, slot, jnp.float32(x))
            tq = TC.push_at(tq, slot, torch.tensor(x))
        yield jq, tq


def test_queue_bytes_match_jax():
    for jq, tq in _queues():
        for name in ("buf", "total", "total_sq", "count", "idx"):
            a = np.asarray(getattr(jq, name))
            b = getattr(tq, name).numpy()
            assert a.dtype == b.dtype, name
            assert a.tobytes() == b.tobytes(), name


def test_queue_stats_match_jax():
    """mean is bit-exact (same two operands); std and the limit reduce the
    buffer in another order, so they agree to f32 rounding (rtol 1e-6)."""
    for k in (3.0, 1.0, -3.0):
        for jq, tq in _queues():
            assert np.asarray(JC.mean(jq)).tobytes() == TC.mean(tq).numpy().tobytes()
            np.testing.assert_allclose(TC.std(tq).numpy(), np.asarray(JC.std(jq)),
                                       rtol=1e-6, atol=1e-7)
            jl = np.asarray(JC.control_limit(jq, k))
            tl = TC.control_limit(tq, k).numpy()
            assert np.isinf(jl) == np.isinf(tl)
            if np.isfinite(jl):
                np.testing.assert_allclose(tl, jl, rtol=1e-6)


def test_sq_bitexact():
    x = (np.random.RandomState(1).randn(4096) * 10).astype(np.float32)
    a = np.asarray(JC._sq(jnp.asarray(x)))
    b = TC._sq(torch.from_numpy(x)).numpy()
    assert a.tobytes() == b.tobytes()


def test_schedules_match_jax():
    jd = JS.loss_driven_lr([2.0, 1.2], [0.015, 0.0015, 0.00015])
    td = TS.loss_driven_lr([2.0, 1.2], [0.015, 0.0015, 0.00015])
    for psi in (5.0, 2.0, 1.9999, 1.2, 0.5, 0.0):
        a = np.asarray(jd(jnp.float32(psi)))
        b = td(torch.tensor(psi, dtype=torch.float32)).numpy()
        assert a.tobytes() == b.tobytes()
    a = np.asarray(JS.constant_lr(0.05)(jnp.float32(1.0)))
    b = TS.constant_lr(0.05)(torch.tensor(1.0)).numpy()
    assert a.tobytes() == b.tobytes() and b.dtype == np.float32


def test_data_copies_match_jax():
    """The port's numpy copies draw from RandomState in the same order:
    identical tokens, identical FCPR batches (including an under-shuffled
    permutation)."""
    a = j_tokens(3, 20, 48, 300)["tokens"]
    b = make_lm_tokens(3, 20, 48, 300)["tokens"]
    assert a.dtype == b.dtype and np.array_equal(a, b)
    for q in (1.0, 0.5):
        js = JFCPR({"tokens": a}, batch_size=6, seed=1, shuffle_quality=q)
        ts = FCPRSampler({"tokens": b}, batch_size=6, seed=1, shuffle_quality=q)
        assert js.n_batches == ts.n_batches
        for j in range(2 * ts.n_batches):
            assert np.array_equal(js(j)["tokens"], ts(j)["tokens"])
