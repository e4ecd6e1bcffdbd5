"""The token mixer of a KDA (Kimi Delta Attention) layer, in plain PyTorch.

KDA (the Kimi Linear report, arXiv:2510.26692; flash-linear-attention's
`KimiDeltaAttention`) is a gated delta rule with a decay per key channel.
Per head, with q, k l2-normalized (q also times d^-1/2):

    S_t = Diag(exp g_t) S_{t-1};  S_t += beta_t k_t (v_t - S_t^T k_t)^T;  o_t = S_t^T q_t

from S_0 = 0, g_t <= 0 the log decay of each key channel.

`chunk_kda` computes it in chunks of `CHUNK` positions (the WY form of the
delta rule): within a chunk, with G the decays' running sum from the
chunk's start, K~ = exp(G) * k, and the strictly lower A[i, j] =
sum_d k_i k_j exp(G_i - G_j),

    (I + diag(beta) A) [W | U'] = diag(beta) [K~ | V]     (one batched triangular solve)
    U = U' - W S;   O = (exp(G) * q) S + A_qk U;   S <- exp(G_last) * S + (exp(G_last - G) * k)^T U

with A_qk[i, j] = sum_d q_i k_j exp(G_i - G_j) for j <= i.  Only the
states pass from chunk to chunk (a loop of L / CHUNK steps); the rest is
batched over every chunk at once.

The pairwise decays are never factored as exp(G_i) * exp(-G_j): a step's
decay reaches -11 and more, so exp(-G_j) overflows f32 within a few
positions.  Each block of `GROUP` columns j is scaled from its first
position r instead: exp(G_i - G_j) = exp(min(G_i - G_r, 0)) * exp(G_r - G_j)
for every i >= j >= r.  The first factor is at most 1, the second at most
exp(-(GROUP - 1) * min g): exact while no step decays faster than -29 in
every one of GROUP - 1 = 3 positions in a row (exp(87) < the f32 maximum).
Where i < j the entry is masked, and both factors are bounded there too.

`kda_mixer` is the block between its projections and its output
projection: the three short causal convolutions with SiLU, the decay gate
g = -exp(A_log) * softplus(f + dt_bias), beta = sigmoid(b), the chunked
core (span `kda_core`, its own device events; the core reads q, k, v in
the compute dtype and g, beta in f32 and writes o in the compute dtype),
and the gated output norm RMSNorm(o) * w * sigmoid(gate).
`KDAMixer` runs it as an autograd function that keeps only its inputs and
computes the mixer again in the backward, under autograd (the chunked
form's intermediates are several hundred MB a layer at 48 x 170 tokens).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from macsa_tpu_torch.utils.logging import span

CHUNK = 16   # positions a chunk
GROUP = 4    # columns scaled from one reference position
L2_EPS = 1e-6
BACKWARD_TOKENS = 4096  # positions a slice of the backward's recomputation
PER_SEQUENCE = (0, 1, 2, 6, 9, 10)  # `kda_mixer`'s inputs with a row per sequence


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def chunk_kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
              beta: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """q, k, v [B, L, H, D], g [B, L, H, D] f32 (log decays <= 0), beta
    [B, L, H] f32 -> o [B, L, H, D] in `out_dtype`, computed in f32.
    Positions are padded at the end to whole chunks with g = beta = 0 (no
    decay, no write), which leaves the earlier positions' outputs as they
    are."""
    b, l, h, d = q.shape
    q = l2norm(q.float()) * d ** -0.5
    k = l2norm(k.float())
    v = v.float()
    pad = -l % CHUNK
    n, ng = (l + pad) // CHUNK, CHUNK // GROUP

    def chunks(x):  # [B, L, H, ...] -> [B, H, N, C, ...]
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        return x.view(b, n, CHUNK, h, *x.shape[3:]).movedim(3, 1)

    q, k, v, g, beta = (chunks(x) for x in (q, k, v, g, beta))
    cum = g.cumsum(3)
    ref = cum[..., ::GROUP, :].unsqueeze(4)                               # [B,H,N,ng,1,D]
    rows = torch.exp((cum.unsqueeze(3) - ref).clamp(max=0))               # [B,H,N,ng,C,D]
    cols = (k.view(b, h, n, ng, GROUP, d)
            * torch.exp(ref - cum.view(b, h, n, ng, GROUP, d))).transpose(-1, -2)

    def pairwise(x):  # sum_d x_i k_j exp(G_i - G_j) -> [B, H, N, C, C]
        return (x.unsqueeze(3) * rows).matmul(cols).movedim(3, 4).reshape(b, h, n, CHUNK, CHUNK)

    lower = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=q.device).tril()
    a_qk = torch.where(lower, pairwise(q), 0.0)
    a_kk = torch.where(lower.tril(-1), pairwise(k), 0.0)
    del rows, cols
    rhs = beta.unsqueeze(-1) * torch.cat([k * cum.exp(), v], -1)
    w, u0 = torch.linalg.solve_triangular(beta.unsqueeze(-1) * a_kk, rhs, upper=False,
                                          unitriangular=True).split(d, -1)
    last = cum[..., -1:, :]
    qg = q * cum.exp()
    k_end = (k * torch.exp(last - cum)).transpose(-1, -2)                 # [B,H,N,D,C]
    decay = last.exp().transpose(-1, -2)                                  # [B,H,N,D,1]
    out, s = [], None
    for i in range(n):
        if s is None:  # the zero state of the first chunk
            u = u0[:, :, i]
            out.append(a_qk[:, :, i].matmul(u))
            s = k_end[:, :, i].matmul(u)
            continue
        u = u0[:, :, i] - w[:, :, i].matmul(s)
        out.append(qg[:, :, i].matmul(s) + a_qk[:, :, i].matmul(u))
        s = decay[:, :, i] * s + k_end[:, :, i].matmul(u)
    o = torch.stack(out, 2).movedim(1, 3).reshape(b, n * CHUNK, h, d)[:, :l]
    return o.to(out_dtype)


def short_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution along L, zero left padding,
    no bias: x [B, L, C], weight [C, 1, K] -> [B, L, C] in x's dtype."""
    y = F.conv1d(F.pad(x.transpose(1, 2), (weight.shape[-1] - 1, 0)), weight.to(x.dtype),
                 groups=weight.shape[0])
    return F.silu(y).transpose(1, 2)


def kda_mixer(pq, pk, pv, wq, wk, wv, f, a_log, dt_bias, b, gate, norm_weight,
              heads: int, eps: float, traced: bool = False) -> torch.Tensor:
    """The block between the projections and `o_proj`.  pq, pk, pv, f, gate
    [B, L, H*D], b [B, L, H] in the compute dtype (the projections'
    outputs; `gate` with its bias); the convolutions' weights [H*D, 1, K],
    `a_log` [H], `dt_bias` [H*D], `norm_weight` [D] in f32 -> [B, L, H*D]
    in the compute dtype.  `traced` opens the span `kda_core` around the
    chunked core (the forward's call, not the backward's recomputation)."""
    bs, l, width = pq.shape
    dt = pq.dtype
    q, k, v = (short_conv(p, w).reshape(bs, l, heads, -1)
               for p, w in ((pq, wq), (pk, wk), (pv, wv)))
    d = width // heads
    g = -a_log.float().exp()[:, None] * F.softplus(f.float().view(bs, l, heads, d)
                                                   + dt_bias.view(heads, d))
    beta = b.float().sigmoid()
    if traced:
        with span("kda_core", device=True) as s:
            o = chunk_kda(q, k, v, g, beta, dt)
            if s is not None:
                s.counts.update(seqs=bs, length=l)
    else:
        o = chunk_kda(q, k, v, g, beta, dt)
    of = o.float()
    y = (of * torch.rsqrt(of.square().mean(-1, keepdim=True) + eps) * norm_weight
         * gate.float().view(bs, l, heads, d).sigmoid())
    return y.to(dt).reshape(bs, l, width)


class KDAMixer(torch.autograd.Function):
    """`kda_mixer` keeping only its inputs for the backward, which runs the
    mixer again under autograd and takes the gradients of that, a slice of
    the sequences at a time (`BACKWARD_TOKENS` positions a slice, whole
    sequences): the recomputed chunked form's intermediates are held for
    one slice only.  The sequences are independent, so the slices' input
    gradients are the whole's rows and the weights' are their sum."""

    @staticmethod
    def forward(ctx, pq, pk, pv, wq, wk, wv, f, a_log, dt_bias, b, gate, norm_weight,
                heads, eps):
        ctx.save_for_backward(pq, pk, pv, wq, wk, wv, f, a_log, dt_bias, b, gate, norm_weight)
        ctx.heads, ctx.eps = heads, eps
        return kda_mixer(pq, pk, pv, wq, wk, wv, f, a_log, dt_bias, b, gate, norm_weight,
                         heads, eps, traced=True)

    @staticmethod
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[:12]
        saved = ctx.saved_tensors
        bs, l = saved[0].shape[:2]
        rows = max(1, BACKWARD_TOKENS // l)
        grads = [None] * 12
        for start in range(0, bs, rows):
            part = slice(start, start + rows)
            with torch.enable_grad():
                inputs = [(t[part] if i in PER_SEQUENCE else t).detach().requires_grad_(n)
                          for i, (t, n) in enumerate(zip(saved, needs))]
                y = kda_mixer(*inputs, ctx.heads, ctx.eps)
            wanted = [i for i in range(12) if needs[i]]
            for i, g in zip(wanted, torch.autograd.grad(y, [inputs[i] for i in wanted],
                                                        dy[part])):
                if i not in PER_SEQUENCE:
                    grads[i] = g if grads[i] is None else grads[i] + g
                    continue
                if grads[i] is None:
                    grads[i] = torch.empty_like(saved[i])
                grads[i][part] = g
        return tuple(grads) + (None, None)
