"""Mamba2 SSD (state-space duality) block: the chunked parallel form and
the O(1) decode recurrence (port of `repro.models.ssm`).

The chunk decomposition of the Mamba2 paper: a within-chunk quadratic
("attention-like") term and a cross-chunk linear state recurrence, the
latter a Python loop over the chunks (the reference's `lax.scan`). The
reference's three- and four-operand einsums are written as pairwise
products here (PyTorch contracts a multi-operand einsum left to right
unless `opt_einsum` is installed), so that no intermediate outgrows the
[b, nc, h, cl, cl] decay matrix; the f32 sums run in another order than
XLA's.

Shapes: x [B, S, d_model] → d_inner = expand·d_model split into
nh = d_inner / head_dim heads of size P; state size N per head (one shared
B/C group, mamba2's default ngroups = 1).

The cache (`SSMCache`): `state` f32 [B, nh, P, N] and `conv` [B, K-1, c]
(c = d_inner + 2N), written in place. As in the reference, the conv state
a call leaves has the type of the cached state and this call's inputs
together (`torch.promote_types`; the reference's `jnp.concatenate`
promotes): an f32 model over a bf16 cache keeps an f32 conv state from
its first call on, and the cache then holds that tensor. A call of S > 1
tokens with a cache (the prefill) runs the chunked SSD from a zero state
and ignores the cache's `state`, as the reference does ("the engine only
prefills into empty caches"); it does read the cache's conv state.

`pick_chunk(S, chunk)` takes the largest divisor of S up to `chunk`: a
prime S gives chunk 1, a loop of S steps.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal, _param, rms_norm


@dataclasses.dataclass
class SSMCache:
    """One SSM layer's cache: `state` f32 [B, nh, P, N] and `conv`
    [B, K-1, c], both written in place."""

    state: torch.Tensor
    conv: torch.Tensor


class SSM(nn.Module):
    """An SSM mixer's parameters, in the reference's layouts: `in_proj`
    [d, 2·d_in + 2N + nh], `conv_w` [K, c], `conv_b` [c], `dt_bias`,
    `A_log`, `D` [nh] (always f32), `out_norm` [d_in], `out_proj`
    [d_in, d]."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        d_in = s.expand * d
        nh = d_in // s.head_dim
        c = d_in + 2 * s.d_state
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = _param(d, 2 * d_in + 2 * s.d_state + nh, **kw)
        self.conv_w = _param(s.d_conv, c, **kw)
        self.conv_b = _param(c, **kw)
        self.dt_bias = _param(nh, **f32)
        self.A_log = _param(nh, **f32)
        self.D = _param(nh, **f32)
        self.out_norm = _param(d_in, **kw)
        self.out_proj = _param(d_in, d, **kw)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., L] → out[..., i, j] = sum_{k=j+1..i} a_k (i >= j), -inf else."""
    L = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # sum_{j+1..i} = cum_i - cum_j
    ii = torch.arange(L, device=a.device)
    return torch.where(ii[:, None] >= ii[None, :], diff, float("-inf"))


def pick_chunk(S: int, chunk: int) -> int:
    """Largest divisor of S that is <= chunk."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD forward.

    x: [b, s, h, p]; dt: [b, s, h] (positive); A: [h] (negative);
    Bm, Cm: [b, s, n] (single group). Returns y [b, s, h, p] and the final
    state [b, h, p, n].
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: chunk {chunk} does not divide {s} steps")
    nc, cl = s // chunk, chunk

    xr = x.reshape(b, nc, cl, h, p)
    dtr = dt.reshape(b, nc, cl, h)
    Br = Bm.reshape(b, nc, cl, n)
    Cr = Cm.reshape(b, nc, cl, n)
    a = dtr * A[None, None, None, :]  # [b, nc, cl, h] log-decay a step
    a_h = a.movedim(-1, 2)  # [b, nc, h, cl]
    dt_h = dtr.movedim(-1, 2)  # [b, nc, h, cl]
    x_h = xr.permute(0, 1, 3, 2, 4)  # [b, nc, h, cl, p]

    # 1) within-chunk (diagonal blocks): the attention-like quadratic term,
    #    scores · L · dt over j, then the product with x over j.
    scores = Cr @ Br.transpose(-1, -2)  # [b, nc, cl(i), cl(j)]
    w = torch.exp(_segsum(a_h))  # L [b, nc, h, i, j], then scores · L · dt
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        # exp's backward reads its output: no product in place.
        w = w * scores[:, :, None] * dt_h[:, :, :, None, :]
    else:  # serving: in place, the decay matrix is the largest intermediate
        w.mul_(scores[:, :, None]).mul_(dt_h[:, :, :, None, :])
    y_diag = w @ x_h  # [b, nc, h, i, p]
    del w

    # 2) chunk-final states: the decayed sum of the inputs within each chunk.
    a_cum = torch.cumsum(a_h, dim=-1)  # [b, nc, h, cl]
    a_tail = a_cum[..., -1:] - a_cum  # decay from step j to the chunk's end
    xw = x_h * (torch.exp(a_tail) * dt_h)[..., None]  # [b, nc, h, j, p]
    states = xw.transpose(-1, -2) @ Br[:, :, None]  # [b, nc, h, p, n]
    del xw

    # 3) cross-chunk recurrence: H_c = H_{c-1}·exp(sum a_c) + states_c; the
    #    state entering each chunk is kept.
    chunk_decay = torch.exp(a_cum[..., -1])  # [b, nc, h]
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # [b, nc, h, p, n]

    # 4) off-diagonal contribution: the decayed incoming state read by C.
    decay_in = torch.exp(a_cum)  # [b, nc, h, cl]: from the chunk's start to step i
    y_off = (Cr[:, :, None] @ h_prev.transpose(-1, -2)) * decay_in[..., None]  # [b, nc, h, i, p]

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y, carry


def _recurrence(state, xh, dt, A, Bm, Cm):
    """The O(1) decode recurrence, one step at a time: state [B, nh, P, N]
    f32, xh [B, S, nh, P], dt [B, S, nh], Bm, Cm [B, S, N] → (y [B, S, nh,
    P], the new state)."""
    ys = []
    for t in range(xh.shape[1]):
        xt, dtt, Bt, Ct = xh[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        dec = torch.exp(dtt * A[None, :])  # [B, nh]
        state = state * dec[..., None, None] + \
            (dtt[:, :, None] * xt)[..., None] * Bt[:, None, None, :]
        ys.append((state @ Ct[:, None, :, None])[..., 0])  # [B, nh, P]
    return torch.stack(ys, dim=1), state


def _scan(xh, dt, A, Bm, Cm, chunk: int, state=None):
    """(y [B, S, nh, P], the final state [B, nh, P, N]): the decode
    recurrence from `state`, or the chunked SSD from a zero state (a
    prefill with a cache starts there too: the module docstring). Sharded
    (DTensors), xh, dt and A are laid out with the batch over the DP axes
    and the heads over `tp` where they divide, Bm and Cm (one group, shared
    by every head) with the batch alone, and each rank scans its own
    (batch, heads) block on its local tensors."""
    def run(xh, dt, A, Bm, Cm, state):
        if state is not None:
            return _recurrence(state, xh, dt, A, Bm, Cm)
        return ssd_chunked(xh, dt, A, Bm, Cm, chunk)

    if not pspec.is_dtensor(xh):
        return run(xh, dt, A, Bm, Cm, state)
    from torch.distributed.tensor import DTensor, Shard

    tp = "tp" if pspec.fits(xh.shape[2], "tp") else None
    xh, dt = pspec.layout(xh, "dp", None, tp, None), pspec.layout(dt, "dp", None, tp)
    A = pspec.layout(A, tp)
    Bm, Cm = (pspec.layout(t, "dp", None, None) for t in (Bm, Cm))
    args = [pspec.local(xh), pspec.local(dt), pspec.local(A, ("dp",)),
            *(pspec.local(t, ("tp",) if tp else ()) for t in (Bm, Cm)),
            None if state is None else pspec.local(pspec.layout(state, "dp", tp, None, None))]
    y, final = run(*args)
    mesh = xh.device_mesh
    B, S, nh, P = xh.shape
    N = Bm.shape[-1]
    # The state's batch and heads (dims 0, 1) laid out as xh's (dims 0, 2).
    st_pl = tuple(Shard({0: 0, 2: 1}[p.dim]) if isinstance(p, Shard) else p
                  for p in xh.placements)
    return (DTensor.from_local(y.contiguous(), mesh, xh.placements, run_check=False,
                               shape=xh.shape, stride=(S * nh * P, nh * P, P, 1)),
            DTensor.from_local(final.contiguous(), mesh, st_pl, run_check=False,
                               shape=(B, nh, P, N), stride=(nh * P * N, P * N, N, 1)))


def ssm_block(cfg: ModelConfig, p: SSM, x: torch.Tensor, *, cache: SSMCache | None = None):
    """The full mamba2 mixer. x: [B, S, d] → ([B, S, d], cache written in
    place, or None)."""
    s = cfg.ssm
    B_, S, d = x.shape
    d_in = s.expand * d
    nh = d_in // s.head_dim
    n = s.d_state

    # Sharded, the projection is laid out whole before it is split (a split
    # of its tp-sharded columns would leave each piece, and its gradient, in
    # a layout the next products cannot take).
    zxbcdt = pspec.constrain(x @ p.in_proj, "dp", "sp", None)
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [d_in, d_in, n, n, nh], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)  # [B, S, c]; c = d_in + 2n

    K = s.d_conv
    if cache is not None:
        kind = torch.promote_types(cache.conv.dtype, conv_in.dtype)
        padded = torch.cat([cache.conv.to(kind), conv_in.to(kind)], dim=1)
    else:
        padded = F.pad(conv_in, (0, 0, K - 1, 0))
    new_conv_state = padded[:, -(K - 1):, :]
    # causal depthwise conv.
    conv_out = sum(padded[:, i:i + S, :] * p.conv_w[i][None, None, :] for i in range(K))
    conv_out = F.silu(conv_out + p.conv_b[None, None, :])
    xs, Bm, Cm = torch.split(conv_out, [d_in, n, n], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias[None, None, :])  # [B, S, nh]
    A = -torch.exp(p.A_log.float())  # [nh]
    xh = xs.float().reshape(B_, S, nh, s.head_dim)

    y, state = _scan(xh, dt, A, Bm.float(), Cm.float(), pick_chunk(S, s.chunk),
                     cache.state if cache is not None and S == 1 else None)
    if cache is not None:
        cache.state.copy_(state)
        if cache.conv.dtype == new_conv_state.dtype:
            cache.conv.copy_(new_conv_state)
        else:  # the promoted type, as the reference's cache takes it
            cache.conv = new_conv_state.contiguous()

    y = y + xh * p.D.float()[None, None, :, None]
    y = y.reshape(B_, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.out_norm, cfg.norm_eps)
    return y @ p.out_proj, cache


def init_ssm(cfg: ModelConfig, gen: torch.Generator, dtype) -> SSM:
    """Random SSM weights at the reference's scales (in_proj d^-0.5,
    conv_w 0.1, out_proj d_in^-0.5), drawn on the generator's device;
    conv_b, dt_bias, A_log and out_norm zero, D one."""
    s, d = cfg.ssm, cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    c = d_in + 2 * s.d_state
    e = 2 * d_in + 2 * s.d_state + nh
    p = SSM(cfg, device=gen.device, dtype=dtype)
    p.in_proj.data = _normal(gen, (d, e), d ** -0.5, dtype)
    p.conv_w.data = _normal(gen, (s.d_conv, c), 0.1, dtype)
    p.out_proj.data = _normal(gen, (d_in, d), d_in ** -0.5, dtype)
    p.D.data.fill_(1.0)
    return p
