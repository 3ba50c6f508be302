"""Mixture-of-Experts layer: top-k router and GShard-style capacity dispatch.

Port of ``repro.models.moe``, serving's ``moe_decode`` included. Tokens are routed in groups of ``GROUP_SIZE``: within each
group, one-hot dispatch and combine tensors of shape (g, E, C) move tokens
to per-expert buffers of capacity C and back. Every shape is static and
every sum a dense product, so a step captures into a CUDA graph as it is
(no host read, no data-dependent shape) and runs the same sums in the same
order at every replay: no ``index_add_`` or scatter-add, whose atomics
would make the sums order-dependent. The reference runs no Pallas kernel
here either; these are plain products under ``--kernels cuda`` too.

Router load balancing is the Switch auxiliary loss: E · Σ_e (fraction of
tokens whose top-1 expert is e) · (mean router probability of e).

Under the hybrid engine's tensor-parallel split (``tp``, the placement of
``launch.shardings``) a rank holds its E/M experts (expert parallel) or
every expert's ``moe_d_ff``/M slice, and where they split its shared
experts' width/M; ``moe_forward`` reads which off the weights' shapes.
The router stays whole: its logits, the gates, the slots (the cumsum over
all E), ``keep`` and the aux loss are the same bits on every rank, so
capacity drops fall as without the split. Under expert parallel a rank
builds its dispatch and combine tensors only for its own experts. Each
rank's output is a partial sum, summed once a layer over the model ranks
(``tp.reduce_out``). The experts' input and the gates pass through
``tp.copy_in``, whose backward sums their gradients over the ranks: the
gates' gradient holds only the rank's experts' (or ``d_ff`` slice's)
share, and the router's gradient must be the whole one, the same bits on
every rank, as the placement assumes of a leaf gathered over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

GROUP_SIZE = 128


def init_moe(cfg, dtype, device) -> dict:
    """Uninitialised MoE leaves (``transformer.init_params`` fills them):
    an f32 router (d, E), the experts' SwiGLU weights (E, d, ff) / (E, ff,
    d) in ``dtype``, and with ``num_shared_experts`` a dense SwiGLU of
    width ff · num_shared_experts (``swg``, ``swi``, ``swo``)."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    w = dict(dtype=dtype, device=device)
    p = {"router": torch.empty((d, E), dtype=torch.float32, device=device),
         "wg": torch.empty((E, d, ff), **w),
         "wi": torch.empty((E, d, ff), **w),
         "wo": torch.empty((E, ff, d), **w)}
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        p.update(swg=torch.empty((d, sff), **w), swi=torch.empty((d, sff), **w),
                 swo=torch.empty((sff, d), **w))
    return p


def _capacity(g: int, top_k: int, num_experts: int, cf: float) -> int:
    c = int(g * top_k * cf / num_experts)
    return max(4, min(g, c))


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot`` by comparison: static, no host read (an index
    equal to n gives a zero row)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _router(p, x, top_k: int):
    """x: (n, g, d) -> (probs (n, g, E) f32, gates (n, g, k) renormalised
    over the top k, expert_idx (n, g, k) in descending probability)."""
    probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
    gates, expert_idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, expert_idx


def _route_groups(p, x, top_k: int, num_experts: int, cf: float = 1.25,
                  tp=None, xs=None):
    """x: (n, g, d), n token groups -> (y (n, g, d), aux (n,)): the JAX
    ``_route_group`` of each group. ``tp``: the model split where the
    experts are split (module doc); ``y`` is then the rank's partial sum.
    ``xs``: the experts' input (x through ``tp.copy_in``; default x)."""
    n, g, d = x.shape
    E = num_experts
    C = _capacity(g, top_k, E, cf)
    probs, gates, expert_idx = _router(p, x, top_k)

    # slot of each (token, k) in its expert's buffer: an exclusive cumsum of
    # the one-hots over the group's slots, token-major and k-minor
    onehot = _one_hot(expert_idx, E, torch.int32)                # (n, g, k, E)
    flat = onehot.reshape(n, g * top_k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = (pos * flat).sum(-1).reshape(n, g, top_k)
    keep = pos < C
    gates = gates * keep                    # after the renormalisation

    # the rank's experts [e0, e0 + El): all E but under expert parallel
    El, e0 = p["wg"].shape[0], 0
    if tp is not None:
        gates = tp.copy_in(gates)
        if El < E:
            e0 = tp.rank * El
    xs = x if xs is None else xs

    # dispatch / combine (n, g, El, C); a dropped slot selects column C, cut
    eo = _one_hot(expert_idx - e0, El, x.dtype)[..., None]       # (n,g,k,El,1)
    slot = _one_hot(torch.where(keep, pos, C), C + 1, x.dtype)[..., :C]
    slot = slot[:, :, :, None, :]                                # (n,g,k,1,C)
    disp = (eo * slot).sum(2)
    comb = (gates[..., None, None].to(x.dtype) * eo * slot).sum(2)

    xe = torch.einsum("ngec,ngd->necd", disp, xs)                # (n, El, C, d)
    h = F.silu(torch.einsum("necd,edf->necf", xe, p["wg"]))
    h = h * torch.einsum("necd,edf->necf", xe, p["wi"])
    ye = torch.einsum("necf,efd->necd", h, p["wo"])
    y = torch.einsum("ngec,necd->ngd", comb, ye)

    me = probs.mean(1)                                           # (n, E)
    ce = _one_hot(expert_idx[..., 0], E, torch.float32).mean(1)  # top-1 share
    aux = E * torch.sum(me * ce, dim=-1)
    return y, aux


def _shared(p, x):
    """The shared experts: a dense SwiGLU (or the rank's slice of it)."""
    return (F.silu(x @ p["swg"]) * (x @ p["swi"])) @ p["swo"]


def moe_forward(p, cfg, x, tp=None):
    """x: (B, S, d) -> (y, aux): the row-major tokens in groups of
    g = min(GROUP_SIZE, S); aux is the mean over groups. ``tp``: the
    model split (module doc); the experts and the shared experts each run
    split where their weights hold a slice, the split parts' partial sums
    summed once over the model ranks, a whole part added after."""
    B, S, d = x.shape
    g = min(GROUP_SIZE, S)
    E, ff, ns = cfg.num_experts, cfg.moe_d_ff, cfg.num_shared_experts
    split = tp is not None and (p["wg"].shape[0] < E or p["wg"].shape[2] < ff)
    shared = tp is not None and ns and p["swg"].shape[1] < ff * ns
    xs = tp.copy_in(x) if split or shared else x
    y, aux = _route_groups(p, x.reshape(B * S // g, g, d), cfg.top_k, E,
                           cfg.moe_capacity_factor, tp if split else None,
                           xs.reshape(B * S // g, g, d))
    y = y.reshape(B, S, d)
    if not ns:
        return (tp.reduce_out(y) if split else y), aux.mean()
    s = _shared(p, xs if shared else x)
    if split == shared:
        y = y + s
        return (tp.reduce_out(y) if split else y), aux.mean()
    # one part split, the other whole: sum the split one, then add
    part, whole = (y, s) if split else (s, y)
    return tp.reduce_out(part) + whole, aux.mean()


def moe_decode(p, cfg, x):
    """Decode-time MoE. x: (B, 1, d) -> (y, aux): the whole batch routed as
    one group of B tokens, so C = max(4, min(B, ⌊B·k·cf/E⌋)) slots an
    expert and rows that are not decoding (a retired slot) still take
    capacity: where slots drop, one row's output depends on the others,
    as in the reference."""
    B, _, d = x.shape
    y, aux = _route_groups(p, x.reshape(1, B, d), cfg.top_k, cfg.num_experts,
                           cfg.moe_capacity_factor)
    y = y.reshape(B, 1, d)
    if cfg.num_shared_experts:
        y = y + _shared(p, x)
    return y, aux[0]
