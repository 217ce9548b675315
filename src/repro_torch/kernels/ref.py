"""Plain PyTorch versions of the kernels (the counterparts of
``repro.kernels.ref``).

They are what a kernel wrapper runs on a CPU tensor, what the tests hold
the JAX package against, and the yardstick ``chip_smoke.py`` holds each
CUDA kernel against on the card.  On a CUDA tensor the main path never
calls them: ``kernels.ops`` launches the kernel instead.
"""
from __future__ import annotations

import torch


# ------------------------------------------------- redundancy vote
def pairwise_agreement_ref(pub: torch.Tensor,
                           atol: float = 0.0) -> torch.Tensor:
    """pub: (E, M, T). Returns (E, M, M) int32 — for each expert e, the
    number of elements on which copies i and j agree (within atol)."""
    diff = (pub[:, :, None, :] - pub[:, None, :, :]).abs()
    return (diff <= atol).sum(dim=-1).to(torch.int32)


def _gather_copy(flat: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """flat (E, M, T), winner (E,) -> flat[e, winner[e]] (E, T)."""
    idx = winner[:, None, None].expand(-1, 1, flat.shape[-1])
    return flat.gather(1, idx)[:, 0]


def redundancy_vote_ref(pub: torch.Tensor, atol: float = 0.0):
    """pub: (E, M, *tail) — expert e's result as published by edge m.

    Replica-level majority vote (paper Step 3): the accepted copy of
    expert e is the one agreeing (on every element) with the largest
    coalition; ties go to the lowest edge index.  Returns
    (trusted (E, *tail), support (E,) int32)."""
    E, M = pub.shape[:2]
    flat = pub.reshape(E, M, -1)
    T = flat.shape[-1]
    full_agree = (pairwise_agreement_ref(flat, atol) == T).to(torch.int32)
    support_per = full_agree.sum(dim=-1, dtype=torch.int32)     # (E, M)
    winner = support_per.argmax(dim=-1)                        # first max
    trusted = _gather_copy(flat, winner)
    support = support_per.gather(1, winner[:, None])[:, 0]
    return trusted.reshape((E,) + pub.shape[2:]), support


def redundancy_vote_winner_ref(pub: torch.Tensor, active: torch.Tensor,
                               atol: float = 0.0):
    """Vote restricted to ``active`` copies (reputation exclusion,
    paper §VI-D): excluded edges neither count toward majorities nor can
    be elected.  active: (M,) {0,1}.  Returns (trusted (E, *tail),
    support (E,) int32, flags (E, M) int32, winner (E,) int32): winner[e]
    is the elected copy, the first max of the masked score as
    ``jnp.argmax`` takes it, and trusted[e] is pub[e, winner[e]]."""
    E, M = pub.shape[:2]
    flat = pub.reshape(E, M, -1)
    T = flat.shape[-1]
    full_agree = (pairwise_agreement_ref(flat, atol) == T).to(torch.int32)
    a = active.to(torch.int32)
    support_per = (full_agree * a[None, None, :]).sum(dim=-1,
                                                      dtype=torch.int32)
    score = support_per * a[None, :] - (1 - a[None, :])        # bar excluded
    winner = score.argmax(dim=-1)                              # first max
    trusted = _gather_copy(flat, winner)
    support = support_per.gather(1, winner[:, None])[:, 0]
    flags = full_agree.gather(
        1, winner[:, None, None].expand(-1, 1, M))[:, 0] * a[None, :]
    return (trusted.reshape((E,) + pub.shape[2:]), support, flags,
            winner.to(torch.int32))


def redundancy_vote_masked_ref(pub: torch.Tensor, active: torch.Tensor,
                               atol: float = 0.0):
    """``redundancy_vote_winner_ref`` without the winner: (trusted (E,
    *tail), support (E,) int32, flags (E, M) int32), the counterpart of
    JAX's ``redundancy_vote_masked_ref``."""
    return redundancy_vote_winner_ref(pub, active, atol)[:3]


# ------------------------------------------------- grouped expert GEMM
def moe_gemm_ref(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d), w: (E, d, f) -> (E, C, f): f32 accumulate, cast to
    ``buf.dtype``."""
    out = torch.einsum("ecd,edf->ecf", buf.float(), w.float())
    return out.to(buf.dtype)


# ------------------------------------------------- audit recompute MLP
def rows_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (C, d) @ w (d, f) -> (C, f) as C independent one-row products.

    A CPU GEMM blocks its rows, so a row of a 94-row product can differ
    in its last bit from the same row computed alone.  Batching the rows
    as separate (1, d) @ (d, f) products makes each row's bytes depend on
    that row only — what lets the optimistic framework hash a leaf
    recomputed from its real rows the same as one cut from a padded
    call."""
    return torch.bmm(x[:, None, :], w.expand(x.shape[0], *w.shape))[:, 0]


def mlp_rows_ref(p, x: torch.Tensor) -> torch.Tensor:
    """One expert's 2-layer MLP (``p``: w1, b1, w2, b2), row by row."""
    h = torch.relu(rows_matmul_ref(x, p["w1"]) + p["b1"])
    return rows_matmul_ref(h, p["w2"]) + p["b2"]


def audit_mlp_ref(params, x: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Grouped gather-MLP: out[s] = mlp(params[gid[s]], x[s]).

    params: stacked {w1 (E,d,h), b1 (E,h), w2 (E,h,o), b2 (E,o)};
    x: (S, C, d); gid: (S,) integer.  The bank is gathered by gid and the
    per-expert MLP applied per sample and row by row, so on the CPU a row
    is bitwise the eager S=1 recompute of that row, whatever C the call
    pads to."""
    S, C = x.shape[:2]
    out = torch.empty((S, C, params["w2"].shape[-1]), dtype=torch.float32,
                      device=x.device)
    for s, g in enumerate(gid.tolist()):
        out[s] = mlp_rows_ref({k: v[g] for k, v in params.items()}, x[s])
    return out


# ------------------------------------------------- flash attention
NEG_INF = -1e30


def attention_mask(Sq: int, Sk: int, device, *, causal: bool, window: int,
                   q_offset: int) -> torch.Tensor:
    """(Sq, Sk) bool: query row i (absolute position ``q_offset + i``)
    may attend key j."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0,
                  return_lse: bool = False):
    """Naive softmax attention (the counterpart of JAX
    ``kernels/ref.py::attention_ref``, with the kernel's ``q_offset``).

    q: (B, Sq, H, D), k/v: (B, Sk, KH, D) with H = KH * G; query row i
    sits at absolute position ``q_offset + i``, key j at j.  Masked
    scores are set to -1e30, so a row with every key masked averages v
    over the Sk keys.  Scores, softmax and the weighted sum run in
    float32; the output is cast to ``q.dtype``.  ``return_lse`` also
    returns the log-sum-exp of each row's scaled, soft-capped and masked
    scores, (B, H, Sq) float32: what the backward recomputes the softmax
    from (a row with no valid key has none that means anything; the
    backward gives it the uniform weights it had)."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qh = q.float().reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * (D ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Sk, q.device, causal=causal, window=window,
                          q_offset=q_offset)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_offset: int = 0):
    """The gradient of ``attention_ref``, written out step by step (no
    autograd), in float32: (dq, dk, dv) in q's, k's and v's shapes.

    o is the forward's output and lse its (B, H, Sq) log-sum-exp; with
    s the scaled (and soft-capped) scores, P = exp(s - lse) on the mask,
    dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dO o)), then the
    softcap's tanh derivative and the scale, dQ = dS K and dK = dS^T Q.
    GQA: dk and dv sum the G query heads of their group.  Masked scores
    are constants (-1e30), so they carry no gradient; a row with no
    valid key weighs every key 1/Sk, as the forward did, and gives dv
    that weight and q no gradient."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = D ** -0.5
    qh = q.float().reshape(B, Sq, KH, G, D)
    doh = do.float().reshape(B, Sq, KH, G, D)
    kf, vf = k.float(), v.float()
    raw = torch.einsum("bqhgd,bkhd->bhgqk", qh, kf) * scale
    if softcap:
        th = torch.tanh(raw / softcap)
        s = softcap * th
    else:
        s = raw
    mask = attention_mask(Sq, Sk, q.device, causal=causal, window=window,
                          q_offset=q_offset)
    alive = mask.any(dim=-1)[:, None]                     # (Sq, 1)
    p = torch.exp(s - lse.float().reshape(B, KH, G, Sq)[..., None])
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    p = torch.where(alive, p, torch.full((), 1.0 / Sk, device=q.device))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, doh)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", doh, vf)
    delta = (do.float() * o.float()).sum(dim=-1)          # (B, Sq, H)
    delta = delta.reshape(B, Sq, KH, G).permute(0, 2, 3, 1)[..., None]
    ds = torch.where(mask, p * (dp - delta), torch.zeros((), device=q.device))
    if softcap:
        ds = ds * (1.0 - th * th)
    ds = ds * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qh)
    return dq, dk, dv


# ------------------------------------------------- RG-LRU scan
def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 from h = 0, as a sequential
    loop.  a, b: (B, S, C) -> h (B, S, C) float32.  Each step rounds the
    product and then the sum (no fused multiply-add), as the CUDA kernel
    does; the kernel's chunked association (``kernels/rglru_scan.py``)
    agrees with this loop bit for bit over its first chunk and within
    rounding after it."""
    a, b = a.float(), b.float()
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                       dh: torch.Tensor):
    """The gradient of ``rglru_scan_ref`` as the reverse loop (no
    autograd): with c_t = dh_t + a_{t+1} c_{t+1} (a_S = 0), db_t = c_t and
    da_t = c_t h_{t-1} (h_{-1} = 0).  a, h (the forward's output), dh
    (B, S, C) -> (da, db) (B, S, C) float32.  Each step rounds the
    product and then the sum, as the CUDA kernel does, which agrees with
    this loop bit for bit over the last 64 steps and within rounding
    before them."""
    a, h, dh = a.float(), h.float(), dh.float()
    S = a.shape[1]
    c = torch.zeros_like(a[:, 0])
    zero = torch.zeros_like(c)
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(S - 1, -1, -1):
        a_next = a[:, t + 1] if t + 1 < S else zero
        c = a_next * c + dh[:, t]
        db[:, t] = c
        da[:, t] = c * (h[:, t - 1] if t > 0 else zero)
    return da, db


# ------------------------------------------------- SSD scan
def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bmat: torch.Tensor, Cmat: torch.Tensor,
                 state0: torch.Tensor):
    """The sequential SSM recurrence (the counterpart of JAX
    ``kernels/ref.py::ssd_scan_ref``).

    x: (B, S, H, P), dt: (B, S, H), A: (H,), Bmat/Cmat: (B, S, N),
    state0: (B, H, P, N).  h_t = exp(dt_t A) h_{t-1} + dt_t x_t (outer)
    B_t and y_t = C_t . h_t.  Returns (y (B, S, H, P), state (B, H, P, N))
    in float32."""
    x, dt, A = x.float(), dt.float(), A.float()
    Bmat, Cmat = Bmat.float(), Cmat.float()
    state = state0.float()
    ys = torch.empty_like(x)
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t] * A)                       # (B, H)
        ds = torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bmat[:, t])
        state = state * decay[:, :, None, None] + ds
        ys[:, t] = torch.einsum("bn,bhpn->bhp", Cmat[:, t], state)
    return ys, state


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bmat: torch.Tensor, Cmat: torch.Tensor,
                     dy: torch.Tensor, chunk: int = 128, *,
                     dtype: torch.dtype = torch.float32):
    """The gradient of ``ssd_scan_ref`` from a zero state, written out
    step by step (no autograd): (dx, ddt, dA, dB, dC) in the operands'
    shapes, in ``dtype`` (float32; float64 for a ground truth).

    With a_t = exp(dt_t A) and h_t = a_t h_{t-1} + dt_t x_t B_t^T, the
    reverse loop carries g_t = dl/dh_t = dy_t C_t^T + a_{t+1} g_{t+1} and
    gives dx_t = dt_t g_t B_t, dB_t = sum_h dt_t g_t^T x_t, dC_t = sum_h
    h_t^T dy_t, ddt_t = x_t . (g_t B_t) + A a_t <g_t, h_{t-1}> and dA =
    sum_{b,t} dt_t a_t <g_t, h_{t-1}>.  The (B, H, P, N) state of every
    step would take S of them (10.7 GB at mamba2-2.7b's layer), so the
    forward keeps the state at each boundary of ``chunk`` =
    min(chunk, S) steps, and the reverse loop recomputes a chunk's states
    from its boundary before it walks the chunk backwards."""
    x, dt, A, Bmat, Cmat, dy = (t.to(dtype) for t in (x, dt, A, Bmat, Cmat,
                                                      dy))
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S) if S else 1
    a = torch.exp(dt * A)                                     # (B, S, H)

    def advance(state, t):
        ds = torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bmat[:, t])
        return state * a[:, t, :, None, None] + ds

    bounds, state = [], torch.zeros((Bsz, H, P, N), dtype=dtype,
                                    device=x.device)
    for t in range(S):
        if t % Q == 0:
            bounds.append(state)
        state = advance(state, t)
    dx, dB, dC = (torch.empty_like(t) for t in (x, Bmat, Cmat))
    ddt = torch.empty_like(dt)
    dA = torch.zeros_like(A)
    g = torch.zeros((Bsz, H, P, N), dtype=dtype, device=x.device)
    for c0 in range((len(bounds) - 1) * Q, -1, -Q):
        hs = [bounds[c0 // Q]]                 # h_{c0-1}, h_c0, ..., h_end
        for t in range(c0, min(c0 + Q, S)):
            hs.append(advance(hs[-1], t))
        for t in range(min(c0 + Q, S) - 1, c0 - 1, -1):
            h_prev, h_t = hs[t - c0], hs[t - c0 + 1]
            g = g + torch.einsum("bhp,bn->bhpn", dy[:, t], Cmat[:, t])
            dC[:, t] = torch.einsum("bhp,bhpn->bn", dy[:, t], h_t)
            gB = torch.einsum("bhpn,bn->bhp", g, Bmat[:, t])
            dx[:, t] = dt[:, t, :, None] * gB
            dB[:, t] = torch.einsum("bh,bhpn,bhp->bn", dt[:, t], g, x[:, t])
            dda = a[:, t] * torch.einsum("bhpn,bhpn->bh", g, h_prev)
            ddt[:, t] = (x[:, t] * gB).sum(-1) + A * dda
            dA = dA + (dt[:, t] * dda).sum(0)
            g = g * a[:, t, :, None, None]
    return dx, ddt, dA, dB, dC
