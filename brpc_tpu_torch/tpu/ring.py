"""Ring attention on one device: the port of ``brpc_tpu/tpu/ring.py``.

In the JAX package each of ``sp`` devices of a mesh axis owns S/sp of the
sequence; keys and values take sp - 1 hops around the ring
(``lax.ppermute``) while every device accumulates its queries' attention
over each visiting block with an online softmax. Here the sp ring
positions run in turn on one device: at hop i, position ``my`` works on
the key block that originated at position ``src = (my - i) % sp`` (the JAX
order), and the hop's ppermute becomes indexing into that block. This is
the replay that the JAX package's ``tools/kernel_bench.py``
(``bench_ring_path``) runs on one chip. Over a mesh (``tpu/mesh.py``),
B splits over a batch axis and H over a head axis and each slice runs
its own ring, as the JAX ring's ``shard_map`` over (batch, sequence,
head) axes does. Over a mesh with a rank per position
(``tpu/launch.py``) each sp rank holds its S/sp block and the hop is a
send: K and V take sp - 1 hops to the next sp rank
(``batch_isend_irecv``), posted before the hop's attention so the send
overlaps it (:func:`ring_attention_local`, each rank's body; the global
:func:`ring_attention` over such a mesh runs it on every rank).

Two lanes, as in JAX:

- ``use_flash=False``: :func:`_block_attend` in fp32, differentiable by
  autograd; the numerics oracle.
- ``use_flash=True``: an autograd function whose forward threads the
  running (m, l, acc) state of each position through
  :func:`~brpc_tpu_torch.tpu.pallas_ops.flash_attention_carry` (the carry
  kernel on the card) hop after hop, and whose backward runs the dQ and
  dK/dV kernels (``_flash_bwd_bhsd``) per hop at the hop's absolute
  offsets, accumulating dq, dk and dv in fp32; dk and dv land on their
  key block's home position (over ranks they travel with their block,
  one hop more than K and V, as ``lax.ppermute`` sends them in the JAX
  ring). When causal, a key block wholly in a position's future is
  skipped without a launch, as the ``lax.cond`` of the JAX ring skips
  it.
"""

from __future__ import annotations

import itertools

import torch

from brpc_tpu_torch.tpu import launch, pallas_ops
from brpc_tpu_torch.tpu.pallas_ops import NEG_INF


def full_attention_reference(q, k, v, causal: bool = False):
    """Unsharded reference for numerics tests: q, k, v [B, S, H, D], in the
    inputs' dtype as in JAX; causal aligned at 0."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def _block_attend(q, k, v, o, m, l, mask):
    """One online-softmax accumulation step. q [B, sq, H, D], k, v
    [B, sk, H, D]; o [B, sq, H, D] the accumulator, m, l [B, H, sq] the
    running max and normaliser; mask [sq, sk] bool (True = attend) or
    None."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask[None, None], scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # guard the all-masked case (exp(NEG_INF - NEG_INF) would be exp(0))
    alive = m_new > NEG_INF / 2
    p = torch.where(alive[..., None], torch.exp(scores - m_new[..., None]),
                    0.0)
    corr = torch.where(alive, torch.exp(m - m_new), 0.0)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o * corr.transpose(1, 2)[..., None] + pv, m_new, l_new


def _hops(sp: int, sq: int, sk: int, skip_future: bool):
    """(my, src) of every hop, in the ring's order: hop i of each position
    in turn, position ``my`` on the key block of ``src = (my - i) % sp``.
    With ``skip_future`` a block wholly in my's future is left out."""
    for i in range(sp):
        for my in range(sp):
            src = (my - i) % sp
            if skip_future and src * sk > my * sq + sq - 1:
                continue
            yield my, src


def _ring_plain(q, k, v, sp: int, causal: bool):
    """The lax lane: every hop, masked by absolute positions, in fp32."""
    b, s, h, d = q.shape
    sq, sk = s // sp, k.shape[1] // sp
    qf, kf, vf = q.float(), k.float(), v.float()
    state = [(torch.zeros(b, sq, h, d, device=q.device),
              torch.full((b, h, sq), NEG_INF, device=q.device),
              torch.zeros(b, h, sq, device=q.device)) for _ in range(sp)]
    for my, src in _hops(sp, sq, sk, skip_future=False):
        mask = None
        if causal:
            q_pos = my * sq + torch.arange(sq, device=q.device)
            k_pos = src * sk + torch.arange(sk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        state[my] = _block_attend(
            qf[:, my * sq:(my + 1) * sq], kf[:, src * sk:(src + 1) * sk],
            vf[:, src * sk:(src + 1) * sk], *state[my], mask)
    outs = []
    for o, _, l in state:
        l_safe = torch.where(l == 0, 1.0, l)
        outs.append(o / l_safe.transpose(1, 2)[..., None])
    return torch.cat(outs, dim=1).to(q.dtype)


def _blocks(x, sp: int):
    """[B, S, H, D] -> [sp, B*H, S/sp, D], contiguous: block j is ring
    position j's share in the kernels' [N, S, D] layout."""
    b, s, h, d = x.shape
    return x.reshape(b, sp, s // sp, h, d).permute(1, 0, 3, 2, 4) \
        .contiguous().view(sp, b * h, s // sp, d)


def _unblocks(x, b: int, h: int):
    """The inverse of :func:`_blocks`: [sp, B*H, s, D] -> [B, sp*s, H, D]."""
    sp, _, s, d = x.shape
    return x.view(sp, b, h, s, d).permute(1, 0, 3, 2, 4).reshape(
        b, sp * s, h, d)


class _RingFlash(torch.autograd.Function):
    """The flash lane: carry-kernel forward, per-hop backward kernels (the
    JAX package's ``_make_ring_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, sp, causal, block_q, block_k):
        b, _, h, d = q.shape
        qb, kb, vb = (_blocks(t, sp) for t in (q, k, v))
        n, sq, sk = qb.shape[1], qb.shape[2], kb.shape[2]
        bq = pallas_ops._fit_block(sq, block_q)
        bk = pallas_ops._fit_block(sk, block_k)
        state = [(torch.full((n, sq, 1), NEG_INF, device=q.device),
                  torch.zeros(n, sq, 1, device=q.device),
                  torch.zeros(n, sq, d, device=q.device))
                 for _ in range(sp)]
        for my, src in _hops(sp, sq, sk, skip_future=causal):
            state[my] = pallas_ops.flash_attention_carry(
                qb[my], kb[src], vb[src], *state[my], my * sq, src * sk,
                causal=causal, block_q=bq, block_k=bk)
        m, l, acc = (torch.stack(x) for x in zip(*state))
        l_safe = torch.where(l == 0, 1.0, l)
        out = (acc / l_safe).to(q.dtype)                 # [sp, N, sq, D]
        lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.args = (b, h, sp, causal, bq, bk)
        return _unblocks(out, b, h)

    @staticmethod
    def backward(ctx, do):
        qb, kb, vb, out, lse = ctx.saved_tensors
        b, h, sp, causal, bq, bk = ctx.args
        sq, sk = qb.shape[2], kb.shape[2]
        dob = _blocks(do.to(qb.dtype), sp)
        # delta depends only on (o, do): once per ring position
        delta = [pallas_ops._flash_delta(out[j], dob[j]) for j in range(sp)]
        dq, dk, dv = (torch.zeros(t.shape, device=t.device)
                      for t in (qb, kb, vb))
        for my, src in _hops(sp, sq, sk, skip_future=causal):
            dq_b, dk_b, dv_b = pallas_ops._flash_bwd_bhsd(
                qb[my], kb[src], vb[src], lse[my], dob[my], delta[my],
                my * sq, src * sk, causal, bq, bk)
            dq[my] += dq_b.float()
            dk[src] += dk_b.float()  # the block's home position
            dv[src] += dv_b.float()
        return (_unblocks(dq, b, h).to(qb.dtype),
                _unblocks(dk, b, h).to(kb.dtype),
                _unblocks(dv, b, h).to(vb.dtype), None, None, None, None)


def _ring(q, k, v, sp: int, causal: bool, use_flash: bool, block_q: int,
          block_k: int):
    """One replayed ring of ``sp`` positions over q, k, v [B, S, H, D]."""
    if sp < 1 or q.shape[1] % sp or k.shape[1] % sp:
        raise ValueError(f"sequence lengths ({q.shape[1]}, {k.shape[1]}) "
                         f"must divide into sp={sp} blocks")
    if use_flash:
        return _RingFlash.apply(q, k, v, sp, causal, block_q, block_k)
    return _ring_plain(q, k, v, sp, causal)


def _axis_size(mesh, name) -> int:
    return 1 if name is None else int(mesh.shape[name])


def ring_attention(q, k, v, mesh, axis: str = None, causal: bool = False,
                   batch_axis: str = None, head_axis: str = None,
                   use_flash: bool = False, block_q: int = 512,
                   block_k: int = 1024):
    """Attention over q, k, v [B, S, H, D] split into sequence blocks
    along a ring, every ring position replayed on the tensors' device.
    Exact, not approximate; differentiable in both lanes.

    ``mesh`` is a :class:`~brpc_tpu_torch.tpu.mesh.Mesh` with ``axis``
    the sequence axis (sp = ``mesh.shape[axis]``), as the JAX ring takes
    it; ``batch_axis`` splits B and ``head_axis`` splits H over their
    axes' positions (attention is independent per batch element and per
    head, so only the sequence axis communicates), and each (batch,
    head) slice runs its own ring. An int ``mesh`` is sp itself, one
    slice. ``use_flash`` runs each hop through the carry kernel and the
    backward kernels (see the module docstring); the blocks are fitted
    to each sequence block as in JAX."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"ring_attention takes [B, S, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if isinstance(mesh, int):
        if axis is not None or batch_axis or head_axis:
            raise ValueError("an int sp takes no mesh axes")
        return _ring(q, k, v, mesh, causal, use_flash, block_q, block_k)
    if mesh.ranked:
        spec = (batch_axis, axis, head_axis)
        for t in (q, k, v):
            mesh.block(t, spec, rank=0)   # refuse an uneven split here
        return _RankRing.apply(q, k, v, mesh, spec, causal, use_flash,
                               block_q, block_k)
    sp = _axis_size(mesh, axis)
    nb, nh = _axis_size(mesh, batch_axis), _axis_size(mesh, head_axis)
    if b % nb or h % nh:
        raise ValueError(f"B={b} / H={h} do not split over {batch_axis}="
                         f"{nb} / {head_axis}={nh}")
    bl, hl = b // nb, h // nh
    rows = []
    for i in range(nb):
        bs = slice(i * bl, (i + 1) * bl)
        rows.append(torch.cat([
            _ring(q[bs, :, j * hl:(j + 1) * hl],
                  k[bs, :, j * hl:(j + 1) * hl],
                  v[bs, :, j * hl:(j + 1) * hl], sp, causal, use_flash,
                  block_q, block_k) for j in range(nh)], dim=2))
    return torch.cat(rows)


# ------------------------------------------------ a rank per position
class _Hop(torch.autograd.Function):
    """One ring hop of the plain lane: the tensors go to rank ``nxt`` and
    ``prv``'s arrive; backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, nxt, prv, *ts):
        ctx.peers = (nxt, prv)
        return tuple(_send_recv(ts, nxt, prv).wait())

    @staticmethod
    def backward(ctx, *gs):
        nxt, prv = ctx.peers
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None, None, *_send_recv(gs, prv, nxt).wait())


def _send_recv(ts, to: int, frm: int):
    """Posts the sends of ``ts`` to rank ``to`` and the receives of as
    many like tensors from rank ``frm``."""
    ts = [t.contiguous() for t in ts]
    return launch.exchange([(t, to) for t in ts],
                           [((t.shape, t.dtype), frm) for t in ts],
                           ts[0].device)


def _ring_ranks_plain(q, k, v, mesh, axis: str, causal: bool):
    """The lax lane on this rank's blocks [B, s, H, D]: every hop, masked
    by absolute positions, in fp32; differentiable through the hops."""
    sp, my = mesh.shape[axis], mesh.coord(axis)
    nxt, prv = mesh.peer(axis, my + 1), mesh.peer(axis, my - 1)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf, kc, vc = q.float(), k.float(), v.float()
    o = torch.zeros(b, sq, h, d, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros(b, h, sq, device=q.device)
    for i in range(sp):
        src = (my - i) % sp
        mask = None
        if causal:
            q_pos = my * sq + torch.arange(sq, device=q.device)
            k_pos = src * sk + torch.arange(sk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        o, m, l = _block_attend(qf, kc, vc, o, m, l, mask)
        if i < sp - 1:
            kc, vc = _Hop.apply(nxt, prv, kc, vc)
    l_safe = torch.where(l == 0, 1.0, l)
    return (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)


def _bhsd(x):
    """[B, s, H, D] -> the kernels' [B*H, s, D], contiguous."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


class _RingFlashRanks(torch.autograd.Function):
    """The flash lane on this rank's blocks: the carry kernel per hop
    forward, the dQ and dK/dV kernels per hop backward, K and V sent to
    the next sp rank while the hop's kernel runs."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, block_q, block_k):
        sp, my = mesh.shape[axis], mesh.coord(axis)
        nxt, prv = mesh.peer(axis, my + 1), mesh.peer(axis, my - 1)
        b, sq, h, d = q.shape
        sk = k.shape[1]
        qb, kb, vb = _bhsd(q), _bhsd(k), _bhsd(v)
        n = qb.shape[0]
        bq = pallas_ops._fit_block(sq, block_q)
        bk = pallas_ops._fit_block(sk, block_k)
        m = torch.full((n, sq, 1), NEG_INF, device=q.device)
        l = torch.zeros(n, sq, 1, device=q.device)
        acc = torch.zeros(n, sq, d, device=q.device)
        kc, vc = kb, vb
        for i in range(sp):
            src = (my - i) % sp
            hop = _send_recv((kc, vc), nxt, prv) if i < sp - 1 else None
            if not (causal and src * sk > my * sq + sq - 1):
                m, l, acc = pallas_ops.flash_attention_carry(
                    qb, kc, vc, m, l, acc, my * sq, src * sk,
                    causal=causal, block_q=bq, block_k=bk)
            if hop is not None:
                kc, vc = hop.wait()
        l_safe = torch.where(l == 0, 1.0, l)
        out = (acc / l_safe).to(q.dtype)                   # [N, sq, D]
        lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.args = (mesh, axis, causal, bq, bk, b, h)
        return out.view(b, h, sq, d).permute(0, 2, 1, 3).contiguous()

    @staticmethod
    def backward(ctx, do):
        qb, kb, vb, out, lse = ctx.saved_tensors
        mesh, axis, causal, bq, bk, b, h = ctx.args
        sp, my = mesh.shape[axis], mesh.coord(axis)
        nxt, prv = mesh.peer(axis, my + 1), mesh.peer(axis, my - 1)
        sq, sk = qb.shape[1], kb.shape[1]
        dob = _bhsd(do.to(qb.dtype))
        delta = pallas_ops._flash_delta(out, dob)
        dq = torch.zeros(qb.shape, device=qb.device)
        # the block this rank holds and its gradient accumulators travel
        # together; after sp sends of the accumulators they are home
        kc, vc = kb, vb
        dk = torch.zeros(kb.shape, device=kb.device)
        dv = torch.zeros(vb.shape, device=vb.device)
        for i in range(sp):
            src = (my - i) % sp
            hop = _send_recv((kc, vc), nxt, prv) if i < sp - 1 else None
            if not (causal and src * sk > my * sq + sq - 1):
                dq_b, dk_b, dv_b = pallas_ops._flash_bwd_bhsd(
                    qb, kc, vc, lse, dob, delta, my * sq, src * sk, causal,
                    bq, bk)
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            dk, dv = _send_recv((dk, dv), nxt, prv).wait()
            if hop is not None:
                kc, vc = hop.wait()

        def back(x, dtype):
            return x.view(b, h, -1, x.shape[-1]).permute(0, 2, 1, 3) \
                .to(dtype).contiguous()

        return (back(dq, qb.dtype), back(dk, kb.dtype), back(dv, vb.dtype),
                None, None, None, None, None)


def ring_attention_local(q, k, v, mesh, axis: str, causal: bool = False,
                         use_flash: bool = False, block_q: int = 512,
                         block_k: int = 1024):
    """One rank's share of the ring over ``axis`` of a mesh with a rank per
    position: q, k, v [B, S/sp, H, D] are this rank's sequence block (of
    its batch and head slices), and every rank of the axis calls this at
    once. Differentiable in both lanes."""
    if not mesh.ranked:
        raise ValueError("ring_attention_local runs on a mesh with a rank "
                         "per position")
    if use_flash:
        return _RingFlashRanks.apply(q, k, v, mesh, axis, causal, block_q,
                                     block_k)
    return _ring_ranks_plain(q, k, v, mesh, axis, causal)


class _RankRing(torch.autograd.Function):
    """The global ring over a rank mesh, from rank 0: forward runs each
    rank's block and keeps its graph there; backward sends each rank its
    block of the output gradient and gathers dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, spec, causal, use_flash, block_q,
                block_k):
        key = f"ring-{next(_keys)}"
        grad = any(t.requires_grad for t in (q, k, v))
        outs = mesh.run(_rank_ring_fwd, key, q.detach().cpu(),
                        k.detach().cpu(), v.detach().cpu(), spec, causal,
                        use_flash, block_q, block_k, grad)
        ctx.args = (mesh, key, spec)
        return mesh.assemble(outs, spec).to(q.device)

    @staticmethod
    def backward(ctx, do):
        mesh, key, spec = ctx.args
        got = mesh.run(_rank_ring_bwd, key, do.detach().cpu(), spec)
        return tuple(mesh.assemble([g[i] for g in got], spec).to(do.device)
                     for i in range(3)) + (None,) * 6


_keys = itertools.count()


def _rank_ring_fwd(mesh, key, q, k, v, spec, causal, use_flash, block_q,
                   block_k, grad):
    ins = [mesh.block(t, spec).to(mesh.device).requires_grad_(grad)
           for t in (q, k, v)]
    with torch.set_grad_enabled(grad):
        out = ring_attention_local(*ins, mesh, spec[1], causal=causal,
                                   use_flash=use_flash, block_q=block_q,
                                   block_k=block_k)
    if grad:
        launch.state()[key] = (ins, out)
    return out.detach()


def _rank_ring_bwd(mesh, key, do, spec):
    ins, out = launch.state().pop(key)
    return torch.autograd.grad(out, ins,
                               mesh.block(do, spec).to(out.device))
