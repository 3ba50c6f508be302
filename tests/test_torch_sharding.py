"""Port vs JAX: the placement rules (``repro_torch.sharding.rules``).

For every parameter of ``paper-transformer``, ``paper-moe`` and
``paper-ssm`` at the tiny tier and of the ten arch configs' ``reduced()``,
on the meshes ``(data, model)`` ∈ {(1,2), (2,2), (4,2), (2,1)}, the port's
``param_spec`` of its per-layer leaf equals the reference's
``param_spec`` of the stacked leaf with the block axis dropped (the
layout map of the rules module). The one stated difference: a per-layer
vector is replicated in the port, where the reference's stacked
``(n_blocks, d)`` copy may take the 2-D rule; the test checks that this
is the only difference. The reference's rules read only ``mesh.shape``, so
a stand-in with that dict serves. ``data_specs`` and
``activation_rule_table`` equal the reference's on those meshes and on a
``(pod, data, model)`` one. The JAX trees are shapes only
(``jax.eval_shape``).
"""
import jax
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import zoo_config as j_zoo_config
from repro.models import build_model as j_build_model
from repro.sharding import rules as J
from repro_torch.configs import ARCH_IDS
from repro_torch.sharding import rules as R

MESHES = [(1, 2), (2, 2), (4, 2), (2, 1)]
CONFIGS = [("zoo", m) for m in ("transformer", "moe", "ssm")] + \
    [("arch", a) for a in ARCH_IDS]


class Mesh:
    """The reference's rules read ``mesh.shape`` only."""

    def __init__(self, **shape):
        self.shape = shape


def _cfg(kind, name):
    return j_zoo_config(name, "tiny") if kind == "zoo" \
        else j_get_config(name).reduced()


def _key(k):
    return k.key if hasattr(k, "key") else k.idx


def _port_leaf(keys, jcfg):
    """JAX leaf path -> (the port's name, stacked over a leading axis)."""
    from repro.models.transformer import stack_plan
    head = keys[0]
    if head in ("prefix",):
        return f"layers.{keys[1]}." + ".".join(map(str, keys[2:])), False
    if head == "blocks":
        prefix, _, _ = stack_plan(jcfg)
        return (f"layers.{len(prefix) + keys[1]}."
                + ".".join(map(str, keys[2:]))), True
    if head == "encoder":
        return "encoder.0." + ".".join(map(str, keys[1:])), True
    return ".".join(map(str, keys)), False


def _pad(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


@pytest.mark.parametrize("data,model", MESHES,
                         ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("kind,name", CONFIGS, ids=[n for _, n in CONFIGS])
def test_param_spec_equals_the_reference(kind, name, data, model):
    jcfg = _cfg(kind, name)
    jm = j_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            max_seq=64))
    mesh = Mesh(data=data, model=model)
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    assert flat
    vectors = 0
    for path, leaf in flat:
        keys = [_key(k) for k in path]
        jpath = "/".join(str(k) for k in path)
        ref = _pad(J.param_spec(mesh, jpath, leaf.shape), len(leaf.shape))
        port_name, stacked = _port_leaf(keys, jcfg)
        pshape = leaf.shape[1:] if stacked else leaf.shape
        got = _pad(R.param_spec({"data": data, "model": model}, port_name,
                                pshape), len(pshape))
        if stacked and len(pshape) == 1 and ref != (None,) * 2:
            # the stated layout difference: a per-layer vector stays whole
            assert got == (None,), (port_name, got)
            vectors += 1
            continue
        want = ref[1:] if stacked else ref
        assert not stacked or ref[0] is None, (jpath, ref)
        assert got == want, (jpath, port_name, pshape, got, want)
        assert R.params_shardings({"data": data, "model": model},
                                  {port_name: pshape})[port_name] == \
            R.param_spec({"data": data, "model": model}, port_name, pshape)
    # only vectors of 128 or more elements differ (the 128 floor)
    assert vectors <= sum(1 for _, leaf in flat
                          if len(leaf.shape) == 2 and leaf.shape[1] >= 128)


@pytest.mark.parametrize("shape", [dict(data=1, model=2),
                                   dict(data=2, model=2),
                                   dict(data=4, model=2),
                                   dict(data=2, model=1),
                                   dict(pod=2, data=2, model=2)],
                         ids=["1x2", "2x2", "4x2", "2x1", "pod2x2x2"])
def test_data_specs_and_activation_table_equal_the_reference(shape):
    mesh = Mesh(**shape)
    assert R.batch_axes(shape) == J.batch_axes(mesh)
    for batch in (1, 3, 8, 16):
        for seq_shard in (False, True):
            ref = J.data_specs(mesh, batch, seq_shard=seq_shard)
            got = R.data_specs(shape, batch, seq_shard=seq_shard)
            assert tuple(tuple(s) for s in ref) == got, (batch, seq_shard)
            ref_t = J.activation_rule_table(mesh, batch, seq_shard=seq_shard)
            got_t = R.activation_rule_table(shape, batch,
                                            seq_shard=seq_shard)
            assert {k: tuple(v) for k, v in ref_t.items()} == got_t


def test_pick_spec_and_make_constrain_resolve_as_the_reference():
    import torch
    mesh = Mesh(data=2, model=4)
    cands = [("data", "model"), (None, "model"), (None, None)]
    for shape in [(4, 8), (3, 8), (3, 6), (8, 12)]:
        assert R.pick_spec(mesh.shape, shape, cands) == \
            tuple(J.pick_spec(mesh, shape, cands))
    table = R.activation_rule_table(mesh.shape, 8)
    fn = R.make_constrain(mesh.shape, table)
    x = torch.zeros(8, 3, 6)
    assert fn(x, "hidden") is x and fn.seen["hidden"] == ("data", None,
                                                          None)
    assert fn(torch.zeros(8, 3, 16), "logits") is not None
    assert fn.seen["logits"] == ("data", None, "model")
    assert fn(x, "unknown") is x
