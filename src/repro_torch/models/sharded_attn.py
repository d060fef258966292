"""Explicitly sharded decode attention (the reference's
``models/sharded_attn.py``, there a ``shard_map``).

A sharding propagator left to itself may reshard a head-dim-sharded KV
cache to a heads-sharded layout for the decode attention contraction: a
full-cache all-gather a step.  Here the cache write and both attention
contractions run on each rank's local shards, the batch over the data
axes and the head dim (MLA: the latent rank and the rope dim) over
``model``, so the only collective is one all-reduce sum of the
(B, H, 1, T) partial logits over the ``model`` sub-group; then the scale,
the softcap, the validity mask and the softmax, and the output on the
local head-dim slice.  The cache never leaves its sharding.

Activated by the ``decode_attn`` rule of ``models/shard_hooks.py``,
``(mesh, dp_axes, tp_axis)`` with a ``DeviceMesh``, for cached one-token
steps; without it the models take their plain path.

The full-sequence attention of a sharded program (training, prefill) runs
the same way under the ``attention`` rule (same form): ``local_heads``
hands each rank its block of the q/k/v projections, the batch over the
data axes and the heads over ``model``, and the plain attention runs on
it with no collective; ``local_experts`` does the same for the MoE
experts under the ``experts`` rule.  Left to DTensor, the head reshapes,
the rotary pairs and the (batch x heads) flatten of the score contraction
either fail to propagate or propagate to strided shards, depending on the
release, and the MoE contractions run whole on every rank of ``model``.
``local_rows`` (the embedding gather), ``summed`` (partial activations
before a matmul) and ``whole_heads`` (head splits that do not divide the
mesh) keep the rest of a sharded program off DTensor's weak spots.

Inputs may be DTensors (a program placed on the mesh) or plain tensors
that hold the whole value on every rank (replicated parameters); the
caches are DTensors in the placements ``cache_shardings`` gives them.  The
outputs follow the queries: a DTensor on the local head-dim slice, or, for
plain queries, the whole tensor (gathered after the attention).
"""

from __future__ import annotations

import math

import torch

from repro_torch.compat import (DTensor, Partial, Replicate, axis_size,
                                from_local, funcol, mesh_dim, place,
                                to_placements)
from repro_torch.models.layers import _rowwise_write, _softcap


def normalize(mesh_info, batch: int):
    """Drop the dp axes when the batch doesn't divide them (e.g. batch 1
    long-context decode: the cache is data-replicated there)."""
    if mesh_info is None:
        return None
    mesh, dp_axes, tp_axis = mesh_info
    dp = int(math.prod([axis_size(mesh, a) for a in dp_axes])) \
        if dp_axes else 1
    if batch % dp != 0:
        return (mesh, (), tp_axis)
    return mesh_info


def applicable(cfg, batch: int, dh: int, mesh_info) -> bool:
    if mesh_info is None:
        return False
    mesh, dp_axes, tp_axis = normalize(mesh_info, batch)
    tp = axis_size(mesh, tp_axis)
    return dh % tp == 0 and (dh // tp) % 2 == 0


def mla_applicable(cfg, batch: int, mesh_info) -> bool:
    if mesh_info is None:
        return False
    mesh, dp_axes, tp_axis = normalize(mesh_info, batch)
    tp = axis_size(mesh, tp_axis)
    return (cfg.kv_lora_rank % tp == 0
            and cfg.qk_rope_dim % tp == 0 and (cfg.qk_rope_dim // tp) % 2 == 0)


class _Shards:
    """Moves tensors between their global form and this rank's shard under
    the (batch over dp, dim ``d`` over tp) spec of one call."""

    def __init__(self, mesh, dp_axes, tp_axis):
        self.mesh, self.tp = mesh, tp_axis
        self.dp = tuple(dp_axes) if dp_axes else None

    def placements(self, ndim: int, tp_dim=None):
        spec = [self.dp] + [None] * (ndim - 1)
        if tp_dim is not None:
            spec[tp_dim] = self.tp
        return to_placements(spec, self.mesh)

    def local(self, x, tp_dim=None):
        pl = self.placements(x.dim(), tp_dim)
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, pl).to_local()
        return place(x, self.mesh, pl).to_local()

    def glob(self, local, shape, tp_dim, whole: bool):
        d = from_local(local.contiguous(), self.mesh,
                       self.placements(len(shape), tp_dim), shape)
        return d.full_tensor() if whole else d

    def psum_tp(self, x):
        """The one collective: a sum over the ``model`` sub-group."""
        out = funcol.all_reduce(x, "sum", (self.mesh,
                                           mesh_dim(self.mesh, self.tp)))
        return funcol.wait_tensor(out)


def _valid(idx, t: int, device):
    n_written = torch.clamp(idx + 1, max=t)                         # (bb,)
    return torch.arange(t, device=device)[None, :] < n_written[:, None]


def mla_decode_attention(q_eff, q_rope, c_new, kr_new, cache_c, cache_kr,
                         idx, *, mesh_info, sm_scale: float):
    """Absorbed-MLA decode attention in latent space, the cache never
    resharded.

    q_eff: (B,1,H,R) latent-space queries (q_nope @ W_uk); q_rope:
    (B,1,H,Dr); c_new: (B,1,R); kr_new: (B,1,1,Dr); cache_c: (B,T,R);
    cache_kr: (B,T,1,Dr).  Returns (out_lat (B,1,H,R), new cache_c, new
    cache_kr); R and Dr are sharded over ``model`` and the partial logits
    are summed once.  The arithmetic is the port's plain MLA decode."""
    mesh, dp_axes, tp_axis = normalize(mesh_info, q_eff.shape[0])
    sh = _Shards(mesh, dp_axes, tp_axis)
    qe, qr = sh.local(q_eff, 3), sh.local(q_rope, 3)
    cn, krn = sh.local(c_new, 2), sh.local(kr_new, 3)
    cc, ckr = sh.local(cache_c, 2), sh.local(cache_kr, 3)
    idx_l = sh.local(idx)
    t = cc.shape[1]
    cc = _rowwise_write(cc, cn, idx_l)
    ckr = _rowwise_write(ckr, krn, idx_l)
    logits = (torch.einsum("bshr,btr->bhst", qe.float(), cc.float())
              + torch.einsum("bshd,btd->bhst", qr.float(),
                             ckr[:, :, 0].float()))
    logits = sh.psum_tp(logits) * sm_scale
    logits = torch.where(_valid(idx_l, t, logits.device)[:, None, None, :],
                         logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out_lat = torch.einsum("bhst,btr->bshr", probs,
                           cc.float()).to(q_eff.dtype)
    whole = not isinstance(q_eff, DTensor)
    return (sh.glob(out_lat, q_eff.shape, 3, whole),
            sh.glob(cc, cache_c.shape, 2, False),
            sh.glob(ckr, cache_kr.shape, 3, False))


def decode_attention(q, k_new, v_new, cache_k, cache_v, idx, *, mesh_info,
                     softcap=None):
    """q: (B,1,H,Dh); k_new/v_new: (B,1,Hkv,Dh); caches: (B,T,Hkv,Dh).

    Returns (out (B,1,H,Dh), new_cache_k, new_cache_v); the caches keep
    their (batch over data, head_dim over model) sharding throughout.  The
    arithmetic is the port's plain decode (``attention_scores``: fp32
    scores divided by sqrt(Dh))."""
    mesh, dp_axes, tp_axis = normalize(mesh_info, q.shape[0])
    sh = _Shards(mesh, dp_axes, tp_axis)
    b, s, h, dh = q.shape
    hkv = cache_k.shape[2]
    q_l = sh.local(q, 3)
    kn, vn = sh.local(k_new, 3), sh.local(v_new, 3)
    ck, cv = sh.local(cache_k, 3), sh.local(cache_v, 3)
    idx_l = sh.local(idx)
    t = ck.shape[1]
    ck = _rowwise_write(ck, kn, idx_l)
    cv = _rowwise_write(cv, vn, idx_l)
    bb, dl = q_l.shape[0], q_l.shape[-1]
    qg = q_l.float().reshape(bb, s, hkv, h // hkv, dl)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, ck.float())
    logits = sh.psum_tp(logits) / math.sqrt(dh)
    logits = _softcap(logits, softcap)
    valid = _valid(idx_l, t, logits.device)[:, None, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, cv.float())
    out = out.reshape(bb, s, h, dl).to(q.dtype)
    whole = not isinstance(q, DTensor)
    return (sh.glob(out, q.shape, 3, whole),
            sh.glob(ck, cache_k.shape, 3, False),
            sh.glob(cv, cache_v.shape, 3, False))


def local_heads(fn, mesh_info, xs, heads):
    """``fn`` on this rank's block of the flat (B, S, n * d) projections
    ``xs`` (DTensors): the batch over the data axes when it divides them,
    the heads over ``model`` when the query heads ``heads[0]`` divide it.

    ``heads[i]``: the head count of ``xs[i]``, or None for a tensor every
    head shares (MLA's rotary key), which every rank takes whole.  Key /
    value heads that do not divide ``model`` (8 kv heads on 16 ranks) are
    taken whole and each rank keeps the groups its query heads read.
    ``fn`` gets the local blocks and returns this rank's (B_l, S, h_l * dv)
    output, which comes back as a DTensor placed as the queries.  The
    gradient of a block that ranks share is a partial sum over ``model``.
    """
    mesh, dp_axes, tp_axis = normalize(mesh_info, xs[0].shape[0])
    tp, tdim = axis_size(mesh, tp_axis), mesh_dim(mesh, tp_axis)
    n_q = heads[0]
    split = n_q % tp == 0
    r = mesh.get_local_rank(tp_axis) if split else 0
    lo_q, hi_q = (r * n_q // tp, (r + 1) * n_q // tp) if split else (0, n_q)
    dp = tuple(dp_axes) or None
    blocks = []
    for x, n in zip(xs, heads):
        if not isinstance(x, DTensor):
            raise TypeError(f"an 'attention' sharding rule is set but the "
                            f"model got a plain {tuple(x.shape)} tensor")
        sharded = split and n is not None and n % tp == 0
        pl = to_placements((dp, None, tp_axis if sharded else None), mesh)
        grad_pl = list(pl)
        if split and not sharded:
            grad_pl[tdim] = Partial()
        block = x.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
        if split and n is not None and not sharded:
            g = n_q // n
            d = x.shape[-1] // n
            block = block[..., lo_q // g * d:((hi_q - 1) // g + 1) * d]
        blocks.append(block)
    out = fn(*blocks)
    width = out.shape[-1] // (hi_q - lo_q) * n_q
    pl = to_placements((dp, None, tp_axis if split else None), mesh)
    return from_local(out.contiguous(), mesh, pl,
                      (xs[0].shape[0], xs[0].shape[1], width))


def local_rows(table, tokens):
    """``table[tokens]`` for a DTensor table: the table gathered whole, the
    gather on each rank's tokens, the rows placed as the tokens.  DTensor's
    own rules for the gather and its gradient differ between releases
    (some fail on a batch split over two mesh dims, some on the gradient's
    scatter-add).  The table's gradient is a partial sum over the mesh
    dims that split the tokens."""
    mesh = table.device_mesh
    tok = tokens if isinstance(tokens, DTensor) else place(
        tokens, mesh, [Replicate()] * mesh.ndim)
    grad_pl = [Partial() if p.is_shard() else Replicate()
               for p in tok.placements]
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad_pl)
    rows = whole[tok.to_local()]
    return from_local(rows, mesh, list(tok.placements),
                      tuple(tok.shape) + tuple(table.shape[1:]))


def summed(x):
    """``x`` with its partial sums reduced: a DTensor that is Partial over a
    mesh dim becomes Replicate there.  A matmul on a partial activation is
    exact, but DTensor then gathers the whole weight on every rank of that
    dim, and every rank multiplies all of it."""
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def whole_heads(x, n: int):
    """``x`` (.., n * d) with every mesh dim that splits its last dim into
    pieces of less than whole heads (``n`` not divisible) replicated;
    ``n`` = 1: every mesh dim that splits the last dim."""
    mesh = x.device_mesh
    pl = [Replicate() if p.is_shard(x.dim() - 1)
          and (n == 1 or n % mesh.size(i)) else p
          for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def local_experts(fn, mesh_info, xt, dispatch, combine, *weights):
    """The MoE experts on this rank's block: the token groups of ``xt``
    (n, g, d) over the data axes when they divide them, and the experts of
    the one-hots (n, g, e, slots) and of the weights (e, ...) over
    ``model``: each rank takes e / m experts, or, where m ranks outnumber
    the e experts (grok-1's 8 on 16), one expert and its share of the
    slots (the 'experts' rule is set where one divides the other).  ``fn``
    gets the local blocks and returns (n_l, g, d), this rank's share: the
    result is a partial sum over ``model``.  The gradients of what ranks
    share (the tokens, over ``model``; the weights, over the data axes and
    where ranks share an expert) are partial sums too."""
    mesh, dp_axes, tp_axis = normalize(mesh_info, xt.shape[0])
    tp, tdim = axis_size(mesh, tp_axis), mesh_dim(mesh, tp_axis)
    e, slots = dispatch.shape[2], dispatch.shape[3]
    share = 1 if e % tp == 0 else tp // e       # ranks an expert spans
    if e % tp and (tp % e or slots % share):
        raise ValueError(f"{e} experts of {slots} slots do not split over "
                         f"{tp} ranks of {tp_axis!r}")
    dp = tuple(dp_axes) or None
    split = tp_axis if share == 1 else None

    def block(x, spec, grad_partial):
        pl = to_placements(spec, mesh)
        grad = [Partial() if (i == tdim and share > 1) or (
            i in grad_partial) else p for i, p in enumerate(pl)]
        return x.redistribute(mesh, pl).to_local(grad_placements=grad)

    dp_dims = {mesh_dim(mesh, a) for a in dp or ()}
    x_l = xt.redistribute(mesh, to_placements((dp, None, None), mesh))
    pl_x = list(x_l.placements)
    grad_x = list(pl_x)
    grad_x[tdim] = Partial()
    x_l = x_l.to_local(grad_placements=grad_x)
    d_l, c_l = (block(r, (dp, None, split, None), set())
                for r in (dispatch, combine))
    w_l = [block(w, (split,), dp_dims) for w in weights]
    if share > 1:
        ex, part = divmod(mesh.get_local_rank(tp_axis), share)
        n = slots // share
        d_l, c_l = (r[:, :, ex:ex + 1, part * n:(part + 1) * n]
                    for r in (d_l, c_l))
        w_l = [w[ex:ex + 1] for w in w_l]
    out = fn(x_l, d_l, c_l, *w_l)
    pl_o = list(pl_x)
    pl_o[tdim] = Partial()
    return from_local(out.contiguous(), mesh, pl_o, tuple(xt.shape))
