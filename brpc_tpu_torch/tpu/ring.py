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
head) axes does. Positions on separate cards, with the hop as a send to
the neighbour rank, are ROADMAP Queue 1 item 7(d).

Two lanes, as in JAX:

- ``use_flash=False``: :func:`_block_attend` in fp32, differentiable by
  autograd; the numerics oracle.
- ``use_flash=True``: an autograd function whose forward threads the
  running (m, l, acc) state of each position through
  :func:`~brpc_tpu_torch.tpu.pallas_ops.flash_attention_carry` (the carry
  kernel on the card) hop after hop, and whose backward runs the dQ and
  dK/dV kernels (``_flash_bwd_bhsd``) per hop at the hop's absolute
  offsets, accumulating dq, dk and dv in fp32; dk and dv land on their
  key block's home position. When causal, a key block wholly in a
  position's future is skipped without a launch, as the ``lax.cond`` of
  the JAX ring skips it.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.tpu import pallas_ops
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
