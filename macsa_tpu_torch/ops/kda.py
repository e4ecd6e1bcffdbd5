"""The token mixer of a KDA (Kimi Delta Attention) layer: plain PyTorch
around the chunked core, whose CUDA kernels are `csrc/kda_core.cu`.

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
`chunk_kda` is the reference the tests and `chip_smoke.py` hold the others
against.

The kernels' form (`subchunk_kda` forward, `chunk_kda_backward` backward:
the plain versions of `csrc/kda_core.cu`) takes chunks of `KCHUNK` = 64
positions and factors the pairwise decays at the start of each sub-chunk
of `SUB` = 16: the block of rows of sub-chunk I and the columns before its
first position r is (x_i exp(G_i - G_r)) (k_j exp(G_r - G_j))^T, both
factors at most 1, and a sub-chunk's own 16 x 16 block takes exp(G_i - G_j)
pair by pair.  That is exact for any finite g <= 0.  `KDACore` is the
core as an autograd function keeping only its inputs: the kernels on a
CUDA tensor (`forward_kernels`, `backward_kernels`), `subchunk_kda` and
`chunk_kda_backward` on a CPU one, so both devices run one algorithm.

`kda_mixer` is the block between its projections and its output
projection: the three short causal convolutions with SiLU, the decay gate
g = -exp(A_log) * softplus(f + dt_bias), beta = sigmoid(b), the chunked
core (span `kda_core`, its own device events; the core reads q, k, v in
the compute dtype and g, beta in f32 and writes o in the compute dtype),
and the gated output norm RMSNorm(o) * w * sigmoid(gate).
`KDAMixer` runs it as an autograd function that keeps only its inputs and
computes the mixer again in the backward, under autograd (whose graph
holds the convolutions' and gates' tensors and `KDACore`'s inputs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.utils.logging import span

CHUNK = 16   # positions a chunk of `chunk_kda`
GROUP = 4    # columns scaled from one reference position
KCHUNK = 64  # positions a chunk of the kernels' form (`subchunk_kda`, `csrc/kda_core.cu`)
SUB = 16     # positions a sub-chunk there
L2_EPS = 1e-6
BACKWARD_TOKENS = 8192  # positions a slice of the backward's recomputation (48 x 170: one)
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


def _work_dtype(*xs: torch.Tensor) -> torch.dtype:
    return torch.float64 if any(x.dtype == torch.float64 for x in xs) else torch.float32


def _in_chunks(x: torch.Tensor, n: int, pad: int) -> torch.Tensor:
    """[B, L, H, ...] -> [B, H, N, KCHUNK, ...], zero-padded at the end."""
    x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    return x.view(x.shape[0], n, KCHUNK, *x.shape[2:]).movedim(3, 1)


def _out_of_chunks(x: torch.Tensor, l: int) -> torch.Tensor:
    """[B, H, N, KCHUNK, ...] -> [B, L, H, ...]."""
    b, h, n = x.shape[:3]
    return x.movedim(1, 3).reshape(b, n * KCHUNK, h, *x.shape[4:])[:, :l]


def _pairwise(x: torch.Tensor, k: torch.Tensor, cum: torch.Tensor, strict: bool) -> torch.Tensor:
    """A[i, j] = sum_d x_i k_j exp(G_i - G_j) for j <= i (j < i if
    `strict`) within each chunk: x, k, cum [B, H, N, C, D] -> [B, H, N, C, C].
    A sub-chunk's own block takes each pair's decay as it is; the block of
    rows of sub-chunk I and columns before its first position r is the
    product of (x_i exp(G_i - G_r)) and (k_j exp(G_r - G_j)), both factors at
    most 1."""
    c = x.shape[3]
    a = x.new_zeros(*x.shape[:3], c, c)
    lower = torch.ones(SUB, SUB, dtype=torch.bool, device=x.device).tril(-int(strict))
    for r in range(0, c, SUB):
        rows = slice(r, r + SUB)
        e = torch.exp((cum[..., rows, None, :] - cum[..., None, rows, :]).clamp(max=0))
        a[..., rows, rows] = torch.where(lower, (x[..., rows, None, :] * k[..., None, rows, :]
                                                 * e).sum(-1), 0.0)
        if r:
            ref = cum[..., r:r + 1, :]
            a[..., rows, :r] = ((x[..., rows, :] * torch.exp(cum[..., rows, :] - ref))
                                .matmul((k[..., :r, :] * torch.exp(ref - cum[..., :r, :]))
                                        .transpose(-1, -2)))
    return a


def _pairwise_backward(da: torch.Tensor, x: torch.Tensor, k: torch.Tensor,
                       cum: torch.Tensor):
    """The gradients of `_pairwise` from dA (zero where A is not computed),
    in its sub-chunk form: (dx, dk, dG)."""
    dx, dk = torch.zeros_like(x), torch.zeros_like(k)
    for r in range(0, x.shape[3], SUB):
        rows = slice(r, r + SUB)
        e = torch.exp((cum[..., rows, None, :] - cum[..., None, rows, :]).clamp(max=0))
        blk = da[..., rows, rows].unsqueeze(-1) * e                       # [.., i, j, D]
        dx[..., rows, :] += (blk * k[..., None, rows, :]).sum(-2)
        dk[..., rows, :] += (blk * x[..., rows, None, :]).sum(-3)
        if r:
            ref = cum[..., r:r + 1, :]
            left_e, right_e = torch.exp(cum[..., rows, :] - ref), torch.exp(ref - cum[..., :r, :])
            off = da[..., rows, :r]
            dx[..., rows, :] += left_e * off.matmul(k[..., :r, :] * right_e)
            dk[..., :r, :] += right_e * off.transpose(-1, -2).matmul(x[..., rows, :] * left_e)
    return dx, dk, x * dx - k * dk


def _subchunk_parts(q, k, v, g, beta):
    """The chunked form at KCHUNK positions a chunk with the sub-chunk
    factoring (the kernels' arithmetic), in f32 (f64 for f64 inputs):
    everything the forward computes, the state entering each chunk too."""
    b, l, h, d = q.shape
    work = _work_dtype(q, k, v, g, beta)
    pad = -l % KCHUNK
    n = (l + pad) // KCHUNK
    p = {"qn": l2norm(q.to(work)) * d ** -0.5, "kn": l2norm(k.to(work)), "v": v.to(work),
         "g": g.to(work), "beta": beta.to(work)}
    p = {key: _in_chunks(x, n, pad) for key, x in p.items()}
    qn, kn, vv, beta = p["qn"], p["kn"], p["v"], p["beta"]
    cum = p["g"].cumsum(3)
    eye = torch.eye(KCHUNK, dtype=work, device=q.device)
    p["a_qk"] = _pairwise(qn, kn, cum, strict=False)
    p["a_kk"] = _pairwise(kn, kn, cum, strict=True)
    p["t"] = torch.linalg.solve_triangular(eye + beta.unsqueeze(-1) * p["a_kk"],
                                           eye.expand(*p["a_kk"].shape), upper=False,
                                           unitriangular=True)
    p["kg"] = kn * cum.exp()
    p["qg"] = qn * cum.exp()
    last = cum[..., -1:, :]
    p["kd"] = kn * torch.exp(last - cum)
    p["gamma"] = last.exp().transpose(-1, -2)                              # [B,H,N,D,1]
    p["w"] = p["t"].matmul(beta.unsqueeze(-1) * p["kg"])
    p["u0"] = p["t"].matmul(beta.unsqueeze(-1) * vv)
    s = q.new_zeros(b, h, d, d, dtype=work)
    s_in, out = [], []
    for i in range(n):
        s_in.append(s)
        u = p["u0"][:, :, i] - p["w"][:, :, i].matmul(s)
        out.append(p["qg"][:, :, i].matmul(s) + p["a_qk"][:, :, i].matmul(u))
        s = p["gamma"][:, :, i] * s + p["kd"][:, :, i].transpose(-1, -2).matmul(u)
    p.update(cum=cum, s_in=torch.stack(s_in, 2), o=torch.stack(out, 2), n=n, pad=pad)
    return p


def subchunk_kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                 beta: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """`chunk_kda`'s function in the kernels' form: chunks of KCHUNK, the
    pairwise decays of sub-chunks of SUB positions factored at the rows'
    sub-chunk start (every factor at most 1: exact for any finite g <= 0)."""
    return _out_of_chunks(_subchunk_parts(q, k, v, g, beta)["o"], q.shape[1]).to(out_dtype)


def _l2norm_backward(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """d/dx of l2norm(x) against dy: r dy - x r^3 (x . dy)."""
    r = torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)
    return r * dy - x * r ** 3 * (x * dy).sum(-1, keepdim=True)


def chunk_kda_backward(q, k, v, g, beta, do):
    """The core's gradients (dq, dk, dv, dg, dbeta, in the inputs' dtypes)
    from do, by the kernels' hand-derived sweep: the chunks' states again,
    then over the chunks in reverse with dS, the state's gradient,

        dU = A_qk^T dO + Kd dS;   dS <- Qg^T dO + exp(G_last) * dS - W^T dU

    (Qg = exp(G) q, Kd = exp(G_last - G) k), and within each chunk the
    gradients of the state's products, of the triangular solve (dB = T^T dX,
    dM = -dB X^T for X = T B, M = I + diag(beta) A_kk) and of the pairwise
    decays in their sub-chunk form; dg is the reverse running sum of dG over
    the chunk.  The plain version of what the backward kernels compute."""
    b, l, h, d = q.shape
    p = _subchunk_parts(q, k, v, g, beta)
    work = p["qn"].dtype
    n, pad = p["n"], p["pad"]
    dout = _in_chunks(do.to(work), n, pad)
    w, u0, a_qk, kd, qg = p["w"], p["u0"], p["a_qk"], p["kd"], p["qg"]
    ds = torch.zeros_like(p["s_in"][:, :, 0])
    du, ds_out = torch.empty_like(u0), torch.empty_like(p["s_in"])
    for i in reversed(range(n)):
        ds_out[:, :, i] = ds
        du[:, :, i] = (a_qk[:, :, i].transpose(-1, -2).matmul(dout[:, :, i])
                       + kd[:, :, i].matmul(ds))
        ds = (qg[:, :, i].transpose(-1, -2).matmul(dout[:, :, i]) + p["gamma"][:, :, i] * ds
              - w[:, :, i].transpose(-1, -2).matmul(du[:, :, i]))
    s_in = p["s_in"]
    u = u0 - w.matmul(s_in)
    dqg = dout.matmul(s_in.transpose(-1, -2))
    dkd = u.matmul(ds_out.transpose(-1, -2))
    dw = -du.matmul(s_in.transpose(-1, -2))
    da_qk = dout.matmul(u.transpose(-1, -2)).tril()
    dgamma = (s_in * ds_out).sum(-1)                                       # [B,H,N,D]
    tt = p["t"].transpose(-1, -2)
    dbk, dbv = tt.matmul(dw), tt.matmul(du)
    dm = -(dbk.matmul(w.transpose(-1, -2)) + dbv.matmul(u0.transpose(-1, -2))).tril(-1)
    bt = p["beta"].unsqueeze(-1)
    dbeta = (dm * p["a_kk"]).sum(-1) + (dbk * p["kg"]).sum(-1) + (dbv * p["v"]).sum(-1)
    dv = bt * dbv
    dq_a, dk_a, dcum = _pairwise_backward(da_qk, p["qn"], p["kn"], p["cum"])
    dk_b, dk_c, dcum_b = _pairwise_backward(bt * dm, p["kn"], p["kn"], p["cum"])
    eg = p["cum"].exp()
    dqn = dq_a + eg * dqg
    dkg = bt * dbk
    dkn = dk_a + dk_b + dk_c + eg * dkg + torch.exp(p["cum"][..., -1:, :] - p["cum"]) * dkd
    dcum = dcum + dcum_b + qg * dqg + p["kg"] * dkg - kd * dkd
    dcum[..., -1, :] += (kd * dkd).sum(-2) + p["gamma"].squeeze(-1) * dgamma
    dg = dcum.flip(3).cumsum(3).flip(3)
    dq = _l2norm_backward(q.to(work), _out_of_chunks(dqn, l) * d ** -0.5)
    dk = _l2norm_backward(k.to(work), _out_of_chunks(dkn, l))
    return (dq.to(q.dtype), dk.to(k.dtype), _out_of_chunks(dv, l).to(v.dtype),
            _out_of_chunks(dg, l).to(g.dtype), _out_of_chunks(dbeta, l).to(beta.dtype))


def _kernel_args(q, k, v, g, beta):
    """The kernels' inputs made contiguous, after checking what
    `csrc/kda_core.cu` takes: CUDA q, k, v [B, L, H, 128] of one dtype (f32
    or bf16), g [B, L, H, 128] and beta [B, L, H] in f32."""
    b, l, h, d = q.shape
    if not (q.is_cuda and q.shape == k.shape == v.shape == g.shape and beta.shape == (b, l, h)
            and d == 128 and q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16)
            and g.dtype == beta.dtype == torch.float32):
        raise ValueError(f"KDA kernels: CUDA q, k, v [B, L, H, 128] (f32 or bf16), f32 g "
                         f"[B, L, H, 128] and beta [B, L, H]; got {q.shape} {q.dtype}, "
                         f"{k.shape} {k.dtype}, {v.shape} {v.dtype}, {g.shape} {g.dtype}, "
                         f"{beta.shape} {beta.dtype} on {q.device}")
    return [x.contiguous() for x in (q, k, v, g, beta)]


def _is_bf16(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"KDA kernels: f32 or bf16, got {dtype}")
    return int(dtype == torch.bfloat16)


@cuda_lib.on_tensor_device
def forward_kernels(q, k, v, g, beta, out_dtype):
    """`subchunk_kda` on the card (`csrc/kda_core.cu`, `macsa_kda_fwd`)."""
    q, k, v, g, beta = _kernel_args(q, k, v, g, beta)
    b, l, h, d = q.shape
    lib = cuda_lib.library()
    scratch = torch.empty(lib.macsa_kda_scratch_floats(b, l, h, 0), dtype=torch.float32,
                          device=q.device)
    o = torch.empty(b, l, h, d, dtype=out_dtype, device=q.device)
    cuda_lib.check(lib.macsa_kda_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), beta.data_ptr(), o.data_ptr(),
        scratch.data_ptr(), b, l, h, _is_bf16(q.dtype), _is_bf16(out_dtype),
        cuda_lib.stream_handle(q.device)), "macsa_kda_fwd")
    cuda_lib.launch_counts["kda_fwd"] += 1
    return o


@cuda_lib.on_tensor_device
def backward_kernels(q, k, v, g, beta, do):
    """`chunk_kda_backward` on the card (`macsa_kda_bwd`): (dq, dk, dv, dg,
    dbeta) in the inputs' dtypes."""
    q, k, v, g, beta = _kernel_args(q, k, v, g, beta)
    do = do.contiguous()
    b, l, h, _ = q.shape
    lib = cuda_lib.library()
    scratch = torch.empty(lib.macsa_kda_scratch_floats(b, l, h, 1), dtype=torch.float32,
                          device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dg, dbeta = torch.empty_like(g), torch.empty_like(beta)
    cuda_lib.check(lib.macsa_kda_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), beta.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dg.data_ptr(), dbeta.data_ptr(),
        scratch.data_ptr(), b, l, h, _is_bf16(q.dtype), _is_bf16(do.dtype),
        cuda_lib.stream_handle(q.device)), "macsa_kda_bwd")
    cuda_lib.launch_counts["kda_bwd"] += 1
    return dq, dk, dv, dg, dbeta


class KDACore(torch.autograd.Function):
    """The chunked core keeping only its inputs for the backward.  A CUDA
    tensor runs the kernels (`forward_kernels`; `backward_kernels`, which
    computes the states again); a CPU tensor their plain versions,
    `subchunk_kda` and `chunk_kda_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, g, beta, out_dtype):
        ctx.save_for_backward(q, k, v, g, beta)
        if q.is_cuda:
            return forward_kernels(q, k, v, g, beta, out_dtype)
        return subchunk_kda(q, k, v, g, beta, out_dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, g, beta = ctx.saved_tensors
        if do.is_cuda:
            return (*backward_kernels(q, k, v, g, beta, do), None)
        return (*chunk_kda_backward(q, k, v, g, beta, do), None)


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
            o = KDACore.apply(q, k, v, g, beta, dt)
            if s is not None:
                s.counts.update(seqs=bs, length=l)
    else:
        o = KDACore.apply(q, k, v, g, beta, dt)
    of = o.float()
    y = (of * torch.rsqrt(of.square().mean(-1, keepdim=True) + eps) * norm_weight
         * gate.float().view(bs, l, heads, d).sigmoid())
    return y.to(dt).reshape(bs, l, width)


class KDAMixer(torch.autograd.Function):
    """`kda_mixer` keeping only its inputs for the backward, which runs the
    mixer again under autograd and takes the gradients of that, a slice of
    the sequences at a time (`BACKWARD_TOKENS` positions a slice, whole
    sequences): the recomputed mixer's tensors are held for one slice
    only.  The sequences are independent, so the slices' input gradients
    are the whole's rows and the weights' are their sum."""

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
