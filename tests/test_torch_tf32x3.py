"""The arithmetic of the port's kernels, emulated on the CPU.

``moe_gemm.cu``, ``flash_attention.cu``, ``ssd_scan.cu`` and
``audit_mlp.cu`` run their float32 products on the tensor cores as 3xTF32
(``csrc/tf32x3.cuh``): each operand is split as
hi = tf32(x), rounded to nearest with ties away from zero onto 10 mantissa
bits (the value ``cvt.rna.tf32.f32`` gives), and lo = x - hi, which the
tensor core reads cut to TF32 (its low 13 bits dropped); a * b is taken as
a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, accumulated in float32.  Here the
rounding is done by int32 bit arithmetic, as in the kernels, and the
products by float32 matmuls, at the shapes of the port's main paths
(experts cut to 2), and held against float64 at the bars the card tests
use: 3xTF32 meets them, one TF32 product per product does not.

The tensor cores accumulate in their own order and may round their sums
differently from a float32 matmul on the CPU, so this is the argument for
the route, not the proof: ``tests/test_torch_cuda.py`` holds the kernels
themselves against their plain versions on the card.

``rglru_chunked`` is the chunked association of ``rglru_scan.cu`` in plain
torch, step for step (each product and each sum rounded on its own), so
the kernel gives its bits exactly (``rglru_bwd_chunked`` the same for its
reverse scan, the backward); ``tests/test_torch_kernels.py`` holds it
against JAX's associative scan, ``tests/test_torch_cuda.py`` the kernel
against it on the card.  ``attention_bwd_tiled`` is
``flash_attention_bwd.cu``'s order of sums (its tiles, zeroed per-tile
sums, the head sum, dQ's order of key tiles) with 3xTF32 products, held
against a float64 backward as the card tests hold the kernel."""
import contextlib
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero): add half of
    TF32's last place to the magnitude bits, drop the low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the low 13 bits, as the tensor core
    reads a float32 register given as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_cut(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The two small terms first, then hi * hi, as the kernels order them."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)     # hi * hi alone


def _randn(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def attention(q, k, v, mm, *, causal, window):
    """Softmax attention in q's dtype with its two products through
    ``mm``: q (B, S, H, D), k/v (B, S, KH, D), masked scores at -1e30."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    qh = q.reshape(B, S, KH, H // KH, D).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]            # (B, KH, 1, D, S)
    s = mm(qh, kt) * D ** -0.5                         # (B, KH, G, S, S)
    pos = torch.arange(S)
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    s = torch.where(keep, s, torch.full((), -1e30, dtype=s.dtype))
    o = mm(torch.softmax(s, dim=-1), v.permute(0, 2, 1, 3)[:, :, None])
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def test_split_keeps_21_bits():
    """hi has TF32's 10 mantissa bits and is within half of its last place
    of x; hi + lo is within 2^-21 of x: the dropped lo * lo term and lo's
    cut bits are each under 2^-21 of a product."""
    x = _randn(0, 100_000) * torch.from_numpy(
        np.exp(np.random.default_rng(1).uniform(-20, 20, 100_000))
        .astype(np.float32))
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= hi.abs() * 2.0 ** -11).all()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= x.abs().double() * 2.0 ** -21).all()


# (E, C, d, f): the B-MoE expert layers with E cut from 10 to 2
GEMM_CASES = {"layer1": (2, 376, 784, 256), "layer2": (2, 376, 256, 10)}


@pytest.mark.parametrize("route,meets_bar", [("3xtf32", True),
                                             ("1xtf32", False)])
@pytest.mark.parametrize("layer", sorted(GEMM_CASES))
def test_moe_gemm_arithmetic(layer, route, meets_bar):
    """Within the card test's fp32 bar (rtol 1e-5, atol 8e-5) of float64
    with 3xTF32, not with one TF32 product."""
    E, C, d, f = GEMM_CASES[layer]
    buf, w = _randn(C + d, E, C, d), _randn(d + f, E, d, f)
    mm = mm_3xtf32 if route == "3xtf32" else mm_1xtf32
    got = mm(buf, w).double()
    want = buf.double() @ w.double()
    assert torch.allclose(got, want, rtol=1e-5, atol=8e-5) == meets_bar, \
        float((got - want).abs().max())


# (S, H, KH, D, window): qwen2.5-3b's causal GQA heads at S = 512, and a
# recurrentgemma-style D = 256 MQA layer with a window inside the sequence
ATTN_CASES = {"causal_gqa_d128": (512, 16, 2, 128, 0),
              "window_d256": (384, 4, 1, 256, 100)}


@pytest.mark.parametrize("route,meets_bar", [("3xtf32", True),
                                             ("1xtf32", False)])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_arithmetic(case, route, meets_bar):
    """Within the card test's fp32 bar (2e-4) of float64 with 3xTF32 in
    both products, not with one TF32 product."""
    S, H, KH, D, window = ATTN_CASES[case]
    q, k, v = (_randn(seed, 1, S, n, D) for seed, n in
               ((S, H), (S + 1, KH), (S + 2, KH)))
    mm = mm_3xtf32 if route == "3xtf32" else mm_1xtf32
    got = attention(q, k, v, mm, causal=True, window=window).double()
    want = attention(q.double(), k.double(), v.double(), torch.matmul,
                     causal=True, window=window)
    assert torch.allclose(got, want, rtol=2e-4, atol=2e-4) == meets_bar, \
        float((got - want).abs().max())


def ssd_chunk_parts(x, dt, A, Bm, Cm, Q, mm):
    """The pieces of ``ssd_scan.cu``'s chunk-parallel SSD in x's dtype,
    from a zero state, with its four products through ``mm``: C B^T once
    per chunk, the chunk states (w o x)^T B, the state pass, then the
    outputs (exp(cum) o C) s^T + (C B^T o L o dt_j) x.  x (B, S, H, P), dt
    (B, S, H), A (H,), Bm / Cm (B, S, N).  Returns a dict of the chunked
    operands (``xc`` (B, nc, H, Q, P), ``dtc`` (B, nc, H, Q), ``Bc``,
    ``Cc`` (B, nc, Q, N)), the cumsum ``cumd`` summed in float64 as the
    kernels sum it and ``cum``, it rounded to x's dtype, ``cb`` (B, nc, 1,
    Q, Q), ``L`` (masked before the exponential; the output launch's, from
    differences of ``cum``) and ``Ld`` (from differences of ``cumd``,
    rounded once, as the chunk states and the backward take them),
    ``decay`` exp(cum_Q) (B, nc, H), the states ``s`` entering each chunk
    (B, nc, H, P, N) and ``y`` (B, nc, H, Q, P)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // Q
    xc = x.reshape(B, nc, Q, H, P).permute(0, 1, 3, 2, 4)    # (B,nc,H,Q,P)
    dtc = dt.reshape(B, nc, Q, H).permute(0, 1, 3, 2)         # (B,nc,H,Q)
    Bc, Cc = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)
    cumd = torch.cumsum(dtc.double() * A.double()[:, None], dim=-1)
    cum = cumd.to(x.dtype)
    cb = mm(Cc, Bc.transpose(-1, -2))[:, :, None]              # (B,nc,1,Q,Q)
    w = torch.exp((cumd[..., -1:] - cumd).to(x.dtype)) * dtc
    ds = mm((w[..., None] * xc).transpose(-1, -2), Bc[:, :, None])
    decay = torch.exp(cum[..., -1])                            # (B,nc,H)
    states = [torch.zeros_like(ds[:, 0])]
    for c in range(nc - 1):
        states.append(decay[:, c, :, None, None] * states[-1] + ds[:, c])
    s = torch.stack(states, 1)                                 # (B,nc,H,P,N)
    pos = torch.arange(Q, device=x.device)
    causal = pos[None, :] <= pos[:, None]
    seg = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    L = torch.where(causal, torch.exp(seg), 0.0)               # masked first
    segd = (cumd[..., :, None] - cumd[..., None, :]).to(x.dtype)
    Ld = torch.where(causal, torch.exp(torch.where(causal, segd, 0.0)), 0.0)
    scores = cb * L * dtc[..., None, :]
    y = (mm(torch.exp(cum)[..., None] * Cc[:, :, None], s.transpose(-1, -2))
         + mm(scores, xc))
    return dict(xc=xc, dtc=dtc, Bc=Bc, Cc=Cc, cum=cum, cumd=cumd, cb=cb,
                L=L, Ld=Ld, decay=decay, s=s, y=y)


def ssd_chunks(x, dt, A, Bm, Cm, Q, mm):
    """The chunk-parallel SSD of ``ssd_scan.cu`` (``ssd_chunk_parts``):
    y (B, S, H, P)."""
    B, S, H, P = x.shape
    return ssd_chunk_parts(x, dt, A, Bm, Cm, Q, mm)["y"].permute(
        0, 1, 3, 2, 4).reshape(B, S, H, P)


def _lanes_incl(v):
    """A warp's inclusive sums over its last axis (32 lanes) in the
    kernel's association: shifts 1, 2, 4, 8, 16, each step reading the
    previous step's values."""
    for o in (1, 2, 4, 8, 16):
        prev = torch.cat([torch.zeros_like(v[..., :o]), v[..., :-o]], -1)
        v = v + prev
    return v


def _lanes_incl_rev(v):
    """The same from the last lane down: lane l gets lanes >= l."""
    return torch.flip(_lanes_incl(torch.flip(v, [-1])), [-1])


def _lanes_sum(v):
    """A warp's xor tree (16, 8, 4, 2, 1) over its last axis: every lane
    ends with the same sum; lane 0's."""
    lane = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def _pad_last(v, n):
    return torch.cat([v, v.new_zeros(v.shape[:-1] + (n - v.shape[-1],))], -1)


def _crossing_sums(D):
    """sum_{i>=k, j<k} D_ij (D (..., Q, Q)) as ssd_scan_bwd.cu forms it:
    per 64-column half, lane l's pair (v0, v1), the lanes' v0 + v1 scanned,
    base = carry + lane l-1's inclusive sum, then base and base + v0 (each
    row's exclusive prefix, its sum so far carried to the next half); each
    column's sum over its rows at and below the diagonal, row by row within
    four groups of 32 rows, then the groups in order."""
    Q = D.shape[-1]
    lead = D.shape[:-2]
    Dp = D.new_zeros(lead + (128, 128))
    Dp[..., :Q, :Q] = D
    carry = D.new_zeros(lead + (128,))
    cross = D.new_zeros(lead + (128,))
    rows = torch.arange(128, device=D.device)
    for j0 in range(0, Q, 64):
        v = Dp[..., j0:j0 + 64].reshape(lead + (128, 32, 2))
        incl = _lanes_incl(v[..., 0] + v[..., 1])
        ex = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
        base = carry[..., None] + ex
        R = torch.stack([base, base + v[..., 0]], -1).reshape(
            lead + (128, 64))
        carry = carry + incl[..., 31]
        keep = (rows[:, None] >= j0 + torch.arange(64, device=D.device)) \
            & (rows[:, None] < Q)
        R = torch.where(keep, R, 0.0)
        parts = []
        for g0 in range(0, 128, 32):
            part = D.new_zeros(lead + (64,))
            for i in range(g0, g0 + 32):
                part = part + R[..., i, :]
            parts.append(part)
        cross[..., j0:j0 + 64] = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    return cross[..., :Q]


def _suffix_sums(v):
    """sum_{i>=k} v_i over the last axis (<= 128 entries) as the kernel's
    warp forms it: 4 entries a lane from the right, the lanes' totals
    scanned, then entry + the later lanes' sum."""
    Q = v.shape[-1]
    w = _pad_last(v, 128).reshape(v.shape[:-1] + (32, 4))
    t3 = w[..., 3]
    t2 = w[..., 2] + t3
    t1 = w[..., 1] + t2
    t0 = w[..., 0] + t1
    incl = _lanes_incl_rev(t0)
    ex = torch.cat([incl[..., 1:], torch.zeros_like(incl[..., :1])], -1)
    out = torch.stack([t0 + ex, t1 + ex, t2 + ex, t3 + ex], -1)
    return out.reshape(v.shape[:-1] + (128,))[..., :Q]


def _prefix_sums(v):
    """sum_{j<k} v_j, the mirror of ``_suffix_sums``: 4 entries a lane from
    the left, the lanes' totals scanned, then the earlier lanes' sum +
    the lane's entries before k."""
    Q = v.shape[-1]
    w = _pad_last(v, 128).reshape(v.shape[:-1] + (32, 4))
    p0 = w[..., 0]
    p1 = p0 + w[..., 1]
    p2 = p1 + w[..., 2]
    p3 = p2 + w[..., 3]
    incl = _lanes_incl(p3)
    ex = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
    out = torch.stack([ex, ex + p0, ex + p1, ex + p2], -1)
    return out.reshape(v.shape[:-1] + (128,))[..., :Q]


def _block_dot(a, b):
    """<a, b> over the last two axes as launch d's 256 threads sum it:
    thread t's elements t, t + 256, ... by fused multiply-adds, each warp's
    xor tree, then the 8 warps in order from zero."""
    fa, fb = a.flatten(-2), b.flatten(-2)
    n = fa.shape[-1]
    pad = -n % 256
    fa, fb = _pad_last(fa, n + pad), _pad_last(fb, n + pad)
    fa = fa.reshape(fa.shape[:-1] + (-1, 256))
    fb = fb.reshape(fb.shape[:-1] + (-1, 256))
    acc = fa.new_zeros(fa.shape[:-2] + (256,))
    for u in range(fa.shape[-2]):       # fmaf: one rounding of a * b + acc
        acc = (fa[..., u, :].double() * fb[..., u, :].double()
               + acc.double()).to(fa.dtype)
    warps = _lanes_sum(acc.reshape(acc.shape[:-1] + (8, 32)))
    tot = acc.new_zeros(acc.shape[:-1])
    for w in range(8):
        tot = tot + warps[..., w]
    return tot


def ssd_bwd_chunks(x, dt, A, Bm, Cm, dy, Q, mm, slice_k: int = 8,
                   head_group=None):
    """The backward of ``ssd_scan_bwd.cu`` in x's dtype, its products
    through ``mm``, in its order of sums; returns (dx, ddt, dA, dB, dC).

    It recomputes the forward's pieces (``ssd_chunk_parts``), C B^T
    again summed in float64 and rounded once, as the kernel's own launch
    sums it; then, with G_c = dl/ds_c, the local part (exp(cum) o dy)^T C and the reverse state
    pass G_c = that + exp(cum_Q) G_c+1 (G_nc = 0).  Per (chunk, head):
    acc = exp(cum_Q - cum) o (B G_c+1^T), the state's part, plus (C B^T o
    L)^T dy, the scores' part; dx = dt o acc; dda_k, dl/d(dt_k A), sums
    what crosses step k: the pairs j < k <= i of D = X o C B^T, with X =
    (dy x^T) o L o dt_j the head's part of dCB (``_crossing_sums``), the
    inter-chunk terms exp(cum_i) dy_i . (s_c C_i) at i >= k
    (``_suffix_sums``), the state writes dt_j x_j . (state part)_j at j < k
    (``_prefix_sums``), and the carried state's decay exp(cum_Q) <s_c,
    G_c+1> (``_block_dot``), added in that order; ddt = A dda + x . acc;
    dA: per (b, chunk, head) the sum of dt o dda by 4-entry lanes and a
    warp's xor tree, then over the batch and the chunks in order.  dB and
    dC sum the heads in groups of ``head_group`` (default
    ``default_head_group``, the kernel's): a group's dCB is its heads' X
    added in head order from zero; its dC = sum_h (exp(cum) o dy) s_c then
    dCB B, its dB = sum_h (w o x) G_c+1 then dCB^T C, every ``slice_k``
    keys of each product summed from zero and added in order (the kernel
    adds each 8-key step); the groups' partials added in group order."""
    from repro_torch.kernels.ssd_scan import default_head_group
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // Q
    HG = min(H, head_group or default_head_group(H, S, Q, N))
    f = ssd_chunk_parts(x, dt, A, Bm, Cm, Q, mm)
    xc, dtc, Bc, Cc, cum, L, s = (f[k] for k in ("xc", "dtc", "Bc", "Cc",
                                                 "cum", "Ld", "s"))
    f["cb"] = (Cc.double() @ Bc.double().transpose(-1, -2)).to(
        x.dtype)[:, :, None]
    dyc = dy.reshape(B, nc, Q, H, P).permute(0, 1, 3, 2, 4)
    # exp(cum_Q - cum), the difference taken in float64 and rounded once
    tail = torch.exp((f["cumd"][..., -1:] - f["cumd"]).to(x.dtype))
    gloc = mm((torch.exp(cum)[..., None] * dyc).transpose(-1, -2),
              Cc[:, :, None])                                  # (B,nc,H,P,N)
    nxt = [torch.zeros_like(gloc[:, 0])]       # G_c+1 for c = nc-1 .. 0
    for c in range(nc - 1, 0, -1):
        nxt.append(gloc[:, c] + f["decay"][:, c, :, None, None] * nxt[-1])
    g_next = torch.stack(nxt[::-1], 1)                         # (B,nc,H,P,N)
    inter = torch.exp(cum) * (dyc * mm(Cc[:, :, None],
                                       s.transpose(-1, -2))).sum(-1)
    acc_s = tail[..., None] * mm(
        Bc[:, :, None], g_next.transpose(-1, -2))              # (B,nc,H,Q,P)
    acc = acc_s + mm((f["cb"] * L).transpose(-1, -2), dyc)
    dxc = dtc[..., None] * acc
    u_s, u = (xc * acc_s).sum(-1), (xc * acc).sum(-1)
    X = mm(dyc, xc.transpose(-1, -2)) * L * dtc[..., None, :]
    dda = ((_crossing_sums(X * f["cb"]) + _suffix_sums(inter))
           + _prefix_sums(dtc * u_s)) \
        + (f["decay"] * _block_dot(s, g_next))[..., None]
    ddtc = A[:, None] * dda + u
    r = _pad_last(dtc * dda, 128).reshape(dda.shape[:-1] + (32, 4))
    dap = _lanes_sum(((r[..., 0] + r[..., 1]) + r[..., 2]) + r[..., 3])
    dA = x.new_zeros(H)
    for b in range(B):
        for c in range(nc):
            dA = dA + dap[b, c]
    w = tail * dtc
    dC = dB = None
    for h0 in range(0, H, HG):
        heads = range(h0, min(H, h0 + HG))
        dcb = x.new_zeros((B, nc, Q, Q))
        for h in heads:
            dcb = dcb + X[:, :, h]
        pC, pB = torch.zeros_like(Cc), torch.zeros_like(Bc)
        for h in heads:
            aC = torch.exp(cum[:, :, h])[..., None] * dyc[:, :, h]
            aB = w[:, :, h, :, None] * xc[:, :, h]
            for k in range(0, P, slice_k):
                pC = pC + mm(aC[..., k:k + slice_k],
                             s[:, :, h, k:k + slice_k])
                pB = pB + mm(aB[..., k:k + slice_k],
                             g_next[:, :, h, k:k + slice_k])
        for k in range(0, Q, slice_k):
            pC = pC + mm(dcb[..., k:k + slice_k], Bc[:, :, k:k + slice_k])
            pB = pB + mm(dcb[:, :, k:k + slice_k].transpose(-1, -2),
                         Cc[:, :, k:k + slice_k])
        dC = pC if dC is None else dC + pC
        dB = pB if dB is None else dB + pB
    return (dxc.permute(0, 1, 3, 2, 4).reshape(B, S, H, P),
            ddtc.permute(0, 1, 3, 2).reshape(B, S, H), dA,
            dB.reshape(B, S, N), dC.reshape(B, S, N))


def ssd_recurrence_f64(x, dt, A, Bm, Cm):
    """ref.ssd_scan_ref's sequential recurrence from zero, in float64."""
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1],
                        dtype=torch.float64)
    ys = torch.empty_like(x)
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t] * A)
        ds = torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        state = state * decay[:, :, None, None] + ds
        ys[:, t] = torch.einsum("bn,bhpn->bhp", Cm[:, t], state)
    return ys


def _ssd_inputs(seed, B, S, H, P, N):
    """As chip_smoke.py's check_ssd draws them: dt = 0.1 softplus(z), A =
    -|z| - 0.1, B and C at scale 0.5."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))) * 0.1
    A = -np.abs(rng.standard_normal(H)) - 0.1
    Bm = rng.standard_normal((B, S, N)) * 0.5
    Cm = rng.standard_normal((B, S, N)) * 0.5
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, dt, A, Bm, Cm)]


# (B, S, H, P, N, Q): mamba2-2.7b's chunk shape (P 64, N 128, Q 128) over
# three chunks, heads cut from 80 to 2 and 4
SSD_CASES = {"mamba2_h2": (1, 384, 2, 64, 128, 128),
             "mamba2_h4_b2": (2, 384, 4, 64, 128, 128)}


@pytest.mark.parametrize("route,meets_bar", [("3xtf32", True),
                                             ("1xtf32", False)])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_arithmetic(case, route, meets_bar):
    """Within the card test's fp32 bar (2e-4) of the float64 recurrence
    with 3xTF32 in all four products, not with one TF32 product."""
    B, S, H, P, N, Q = SSD_CASES[case]
    x, dt, A, Bm, Cm = _ssd_inputs(S + H, B, S, H, P, N)
    mm = mm_3xtf32 if route == "3xtf32" else mm_1xtf32
    got = ssd_chunks(x, dt, A, Bm, Cm, Q, mm).double()
    want = ssd_recurrence_f64(x, dt, A, Bm, Cm)
    assert torch.allclose(got, want, rtol=2e-4, atol=2e-4) == meets_bar, \
        float((got - want).abs().max())


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunk_state_algebra(case):
    """The decomposition in float32 with float32 products is the plain
    sequential recurrence (ref.ssd_scan_ref) within 1e-5."""
    B, S, H, P, N, Q = SSD_CASES[case]
    x, dt, A, Bm, Cm = _ssd_inputs(S + H, B, S, H, P, N)
    got = ssd_chunks(x, dt, A, Bm, Cm, Q, torch.matmul)
    state0 = torch.zeros(B, H, P, N)
    want = ref.ssd_scan_ref(x, dt, A, Bm, Cm, state0)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def ssd_chunked_grads(x, dt, A, Bm, Cm, dy, Q):
    """The five gradients of the chunked form from zero
    (``models.ssm.ssd_chunked``, the port's copy of the JAX package's,
    whose ``jax.vjp`` is the authority) by autograd, in x's dtype."""
    from repro_torch.models.ssm import ssd_chunked
    ts = [t.detach().clone().requires_grad_(True)
          for t in (x, dt, A, Bm, Cm)]
    s0 = x.new_zeros((x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1]))
    y = ssd_chunked(*ts, s0, Q)[0]
    return torch.autograd.grad(y, ts, dy)


def ssd_bwd_refs(x, dt, A, Bm, Cm, dy, Q):
    """The gradients ``ssd_bwd_errors`` compares: ``ref.ssd_scan_bwd_ref``
    in float64 (the truth) and in float32, and the chunked form's by
    autograd."""
    return (ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, Q,
                                 dtype=torch.float64),
            ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, Q),
            ssd_chunked_grads(x, dt, A, Bm, Cm, dy, Q))


def ssd_bwd_errors(got, x, dt, A, Bm, Cm, dy, Q, refs=None):
    """Per gradient of ``got`` (dx, ddt, dA, dB, dC): its float64 error
    and the float32 errors of the two plain routes, the sequential reverse
    loop (``ssd_scan_bwd_ref``) and the chunked form by autograd, each
    against ``ref.ssd_scan_bwd_ref`` in float64.  ``refs``:
    ``ssd_bwd_refs``' result for these operands, if at hand."""
    truth, plain, chunked = refs or ssd_bwd_refs(x, dt, A, Bm, Cm, dy, Q)

    def err(a, t):
        return float((a.double().cpu() - t.cpu()).abs().max())
    return {n: (err(g, t), err(p, t), err(c, t))
            for n, g, t, p, c in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                     truth, plain, chunked)}


def _ssd_bwd_inputs(seed, B, S, H, P, N, decay=1.0):
    """``_ssd_inputs`` with dt and A scaled by ``decay``, and dy (unit
    normal) from the next seed."""
    x, dt, A, Bm, Cm = _ssd_inputs(seed, B, S, H, P, N)
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, S, H, P)).astype(np.float32))
    return x, dt * decay, A * decay, Bm, Cm, dy


# (B, S, H, P, N, Q, decay): mamba2-2.7b's chunk shape over three chunks,
# ragged chunks of 100, and dt and A x4 (cum down to about -300 a chunk)
SSD_BWD_CASES = {"mamba2_h2": (1, 384, 2, 64, 128, 128, 1.0),
                 "ragged_q100": (2, 300, 3, 64, 128, 100, 1.0),
                 "strong_decay": (2, 512, 4, 64, 128, 128, 4.0)}


@contextlib.contextmanager
def one_thread():
    """The reverse loops are thousands of small ops: with the test workers'
    threads oversubscribing the cores they ran 60x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ssd_bwd_case(case):
    """A case's operands, chunk and ``ssd_bwd_refs``, once per process."""
    B, S, H, P, N, Q, decay = SSD_BWD_CASES[case]
    args = _ssd_bwd_inputs(S + H, B, S, H, P, N, decay)
    with one_thread():
        return args, Q, ssd_bwd_refs(*args, Q)


@pytest.mark.parametrize("route,meets_bar", [("3xtf32", True),
                                             ("1xtf32", False)])
@pytest.mark.parametrize("case", sorted(SSD_BWD_CASES))
def test_ssd_bwd_arithmetic(case, route, meets_bar):
    """The backward's decomposition with 3xTF32 in every product is within
    twice the larger float32 error of the two plain routes on all five
    gradients (it is a chunked form: at mamba2_h2 its dB error is 2.4x
    the loop's, the chunked form's 1.7x); with one TF32 product it misses
    on every case."""
    args, Q, refs = _ssd_bwd_case(case)
    mm = mm_3xtf32 if route == "3xtf32" else mm_1xtf32
    with one_thread():
        errs = ssd_bwd_errors(ssd_bwd_chunks(*args, Q, mm), *args, Q,
                              refs=refs)
    assert all(e <= 2.0 * max(p, c)
               for e, p, c in errs.values()) == meets_bar, errs


@pytest.mark.parametrize("case", sorted(SSD_BWD_CASES))
def test_ssd_bwd_chunk_algebra(case):
    """The decomposition with float32 products is the sequential reverse
    loop (``ref.ssd_scan_bwd_ref``) within rtol 1e-4 / atol 1e-4 (the
    gradients reach 10^2; at dt and A x4 the chunked form's own float32
    error reaches 1.5e-3 on ddt, so that case is held at rtol 1e-4 / atol
    5e-3)."""
    args, Q, (_, want, _) = _ssd_bwd_case(case)
    with one_thread():
        got = ssd_bwd_chunks(*args, Q, torch.matmul)
    atol = 1e-4 if SSD_BWD_CASES[case][-1] == 1.0 else 5e-3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-4, atol=atol)


# (case, heads a group of the head sums): one group, a size that does not
# divide H, one head a group
SSD_BWD_GROUPS = [("mamba2_h2", 2), ("mamba2_h2", 1), ("ragged_q100", 3),
                  ("ragged_q100", 2), ("ragged_q100", 1), ("strong_decay", 4),
                  ("strong_decay", 3), ("strong_decay", 1)]


@pytest.mark.parametrize("case,head_group", SSD_BWD_GROUPS)
def test_ssd_bwd_head_groups(case, head_group):
    """With the head sums of dCB, dB and dC in groups of ``head_group``
    heads, the groups' partials added in order, the decomposition with
    3xTF32 products stays within ``test_ssd_bwd_arithmetic``'s float64 bar
    on all five gradients, and dx, ddt and dA, which no group touches, are
    the same bits as with one group."""
    args, Q, refs = _ssd_bwd_case(case)
    H = args[0].shape[2]
    with one_thread():
        got = ssd_bwd_chunks(*args, Q, mm_3xtf32, head_group=head_group)
        one = got if head_group == H else ssd_bwd_chunks(
            *args, Q, mm_3xtf32, head_group=H)
        errs = ssd_bwd_errors(got, *args, Q, refs=refs)
    assert all(e <= 2.0 * max(p, c) for e, p, c in errs.values()), errs
    assert all(torch.equal(a, b) for a, b in zip(got[:3], one[:3]))


# ------------------------------------------------------------ audit_mlp
def sliced_mm(a, b, mm, depth: int = 32):
    """a (..., K) @ b (..., K, N) as audit_mlp.cu sums it: each ``depth``
    deep K slice through ``mm`` from zero, the slices added in order."""
    acc = None
    for k0 in range(0, a.shape[-1], depth):
        t = mm(a[..., k0:k0 + depth], b[..., k0:k0 + depth, :])
        acc = t if acc is None else acc + t
    return acc


def audit_mlp_tc(params, x, gid, mm):
    """``audit_mlp.cu``'s arithmetic: both layers over 32-deep K slices
    through ``mm``, bias and ReLU between, then layer 2's bias.  params:
    stacked {w1 (E, d, h), b1, w2 (E, h, o), b2}; x (S, C, d); gid (S,)."""
    w1, b1, w2, b2 = (params[k][gid] for k in ("w1", "b1", "w2", "b2"))
    h = torch.relu(sliced_mm(x, w1, mm) + b1[:, None])
    return sliced_mm(h, w2, mm) + b2[:, None]


def _audit_inputs(seed, E, S, C, d, h, o):
    """As chip_smoke.py's check_audit_mlp draws them: w1 and w2 scaled by
    their fan-in, unit biases and x."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    params = {"w1": f(E, d, h) / d ** 0.5, "b1": f(E, h),
              "w2": f(E, h, o) / h ** 0.5, "b2": f(E, o)}
    return params, f(S, C, d), torch.from_numpy(rng.integers(0, E, S))


# (E, S, C, d, h, o): the commitment build and a merged drain over a
# (window+1) N = 30 expert stacked bank, at the paper's 784 -> 256 -> 10
AUDIT_CASES = {"commit": (10, 40, 94, 784, 256, 10),
               "merged": (30, 8, 94, 784, 256, 10)}


@pytest.mark.parametrize("route,meets_bar", [("3xtf32", True),
                                             ("1xtf32", False)])
@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_mlp_arithmetic(case, route, meets_bar):
    """Within the card test's bar (1e-5) of float64 with 3xTF32 in both
    layers, not with one TF32 product."""
    params, x, gid = _audit_inputs(7, *AUDIT_CASES[case])
    mm = mm_3xtf32 if route == "3xtf32" else mm_1xtf32
    got = audit_mlp_tc(params, x, gid, mm).double()
    want = audit_mlp_tc({k: v.double() for k, v in params.items()},
                        x.double(), gid, torch.matmul)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5) == meets_bar, \
        float((got - want).abs().max())


# ------------------------------------------------------------ RG-LRU scan
def rglru_chunked(a, b, L: int):
    """``rglru_scan.cu``'s chunked scan of h_t = a_t h_{t-1} + b_t from
    h = 0, in a's dtype and on its device: chunks of L steps; for chunks
    0 .. nc-2 the product of a (P) and the end state from h = 0 (H); the
    carried-in state of chunk k folded in chunk order (H_0, then
    P_j carry + H_j); then each chunk re-run from its state.  Every product
    and every sum is its own rounded operation, as in the kernel.  The
    chunks step together, which changes no value: the last one is padded
    with a = 1, b = 0 past S and cut off."""
    B, S, C = a.shape
    nc = -(-S // L)
    pad = nc * L - S
    ap = torch.cat([a, a.new_ones(B, pad, C)], 1).reshape(B, nc, L, C)
    bp = torch.cat([b, b.new_zeros(B, pad, C)], 1).reshape(B, nc, L, C)
    p = torch.ones_like(ap[:, :, 0])
    h = torch.zeros_like(ap[:, :, 0])
    for t in range(L):                     # summaries, every chunk at once
        h = ap[:, :, t] * h + bp[:, :, t]
        p = p * ap[:, :, t]
    carry = [torch.zeros_like(h[:, 0])]
    if nc > 1:
        carry.append(h[:, 0])
    for j in range(1, nc - 1):
        carry.append(p[:, j] * carry[-1] + h[:, j])
    h = torch.stack(carry, 1)
    out = torch.empty_like(ap)
    for t in range(L):
        h = ap[:, :, t] * h + bp[:, :, t]
        out[:, :, t] = h
    return out.reshape(B, nc * L, C)[:, :S]


def rglru_bwd_chunked(a, h, dh, L: int):
    """``rglru_scan.cu``'s reverse chunked scan, the gradient of the scan:
    c_t = a_{t+1} c_{t+1} + dh_t (a_S = 0), db_t = c_t, da_t = c_t h_{t-1}.
    For chunks 1 .. nc-1, from c = 0 past the chunk's end, the product of
    the a_{t+1} (P) and the c at its first step (H); the c carried into
    chunk k folded from the last chunk down (H_{nc-1}, then P_j carry +
    H_j for j = nc-2 .. k+1); then each chunk re-run from its carry.
    Every product and sum its own rounded operation, as in the kernel; the
    last chunk is padded past S with a = 1, dh = 0, which keep c at 0."""
    B, S, C = a.shape
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(x, fill):
        x = torch.cat([x, torch.full((B, pad, C), fill, dtype=x.dtype,
                                     device=x.device)], 1)
        return x.reshape(B, nc, L, C)

    zero = torch.zeros_like(a[:, :1])
    an = chunks(torch.cat([a[:, 1:], zero], 1), 1.0)     # a_{t+1}
    hp = chunks(torch.cat([zero, h[:, :-1]], 1), 0.0)    # h_{t-1}
    dp = chunks(dh, 0.0)
    p = torch.ones_like(an[:, :, 0])
    c = torch.zeros_like(an[:, :, 0])
    for t in range(L - 1, -1, -1):         # summaries, every chunk at once
        c = an[:, :, t] * c + dp[:, :, t]
        p = p * an[:, :, t]
    carry = [torch.zeros_like(c[:, 0])]
    if nc > 1:
        carry.append(c[:, nc - 1])
    for j in range(nc - 2, 0, -1):
        carry.append(p[:, j] * carry[-1] + c[:, j])
    c = torch.stack(carry[::-1], 1)        # chunk k's carry at k
    da, db = torch.empty_like(an), torch.empty_like(an)
    for t in range(L - 1, -1, -1):
        c = an[:, :, t] * c + dp[:, :, t]
        db[:, :, t] = c
        da[:, :, t] = c * hp[:, :, t]
    return (da.reshape(B, nc * L, C)[:, :S], db.reshape(B, nc * L, C)[:, :S])


def _ab(seed, B, S, C):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, C)).astype(
        np.float32)),
            torch.from_numpy(rng.standard_normal((B, S, C)).astype(
                np.float32)))


# S at, around and below the kernel's chunk of 64, and a layer-like length
RGLRU_LENGTHS = [(2, 128, 33), (2, 63, 33), (2, 65, 33), (3, 200, 17),
                 (2, 20, 9), (2, 1, 5), (1, 4096, 64)]


@pytest.mark.parametrize("B,S,C", RGLRU_LENGTHS)
def test_rglru_chunked_association(B, S, C):
    """The chunked association against the sequential loop
    (ref.rglru_scan_ref) at the card test's 1e-5; over the first chunk it
    is the loop bit for bit."""
    a, b = _ab(S + C, B, S, C)
    got = rglru_chunked(a, b, 64)
    want = ref.rglru_scan_ref(a, b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    n = min(S, 64)
    assert torch.equal(got[:, :n].view(torch.int32),
                       want[:, :n].view(torch.int32))


@pytest.mark.parametrize("B,S,C", RGLRU_LENGTHS)
def test_rglru_bwd_chunked_association(B, S, C):
    """The reverse chunked association against the reverse loop
    (ref.rglru_scan_bwd_ref) at 1e-5; up to two chunks (the carry into
    chunk 0 is the last chunk's own c) it is the loop bit for bit, and the
    last chunk always is."""
    a, b = _ab(S + C, B, S, C)
    h = ref.rglru_scan_ref(a, b)
    dh = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (B, S, C)).astype(np.float32))
    got = rglru_bwd_chunked(a, h, dh, 64)
    want = ref.rglru_scan_bwd_ref(a, h, dh)
    last = (S - 1) // 64 * 64
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(g[:, last:], w[:, last:])
        if S <= 128:
            assert torch.equal(g, w)


# ------------------------------------------------------------ attention backward
def attention_bwd_tiled(q, k, v, o, do, lse, *, causal, window, q_offset=0,
                        softcap=0.0, bq=32, bk=64):
    """``flash_attention_bwd.cu``'s order of sums in plain torch float32,
    its products in 3xTF32 (``mm_3xtf32``): S and dP over d in the
    kernel's 8-column steps (columns 0, 1, 4, 5, 8, 9, 12, 13 then 2, 3,
    6, 7, ... of each 16, the order of its 16-byte loads), each step's
    product added to the running sum with one rounded add; dK and dV per
    query head and key, query tiles of ``bq`` rows in descending order
    (ascending under a window without the causal mask), each tile's
    product a fresh sum added once; dk and dv the G heads' sums
    added in head order; dQ by key tiles of ``bk`` keys (the kernel's
    block: 32 at D 256), each tile's product a fresh sum added once, in
    the kernel's order of blocks (ascending, descending under a window
    without the causal mask).  Tiles the mask leaves out add exact zeros,
    so they are not skipped here.  P, dS and the rows with no valid key as
    ``ref.attention_bwd_ref``."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qh, doh = q.transpose(1, 2), do.transpose(1, 2)       # (B, H, Sq, D)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)    # (B, H, Sk, D)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
    s = torch.zeros(B, H, Sq, Sk)
    dp = torch.zeros(B, H, Sq, Sk)
    for kk in range(0, D, 16):
        for first in (0, 2):
            cols = [kk + c + first for c in (0, 1, 4, 5, 8, 9, 12, 13)]
            s = s + mm_3xtf32(qh[..., cols], kh[..., cols].transpose(-1, -2))
            dp = dp + mm_3xtf32(doh[..., cols],
                                vh[..., cols].transpose(-1, -2))
    scale = D ** -0.5
    raw = s * scale
    th = torch.tanh(raw / softcap) if softcap else None
    sc = softcap * th if softcap else raw
    mask = ref.attention_mask(Sq, Sk, q.device, causal=causal, window=window,
                              q_offset=q_offset)
    alive = mask.any(dim=-1)[:, None]
    p = torch.where(mask, torch.exp(sc - lse[..., None]), torch.zeros(()))
    p = torch.where(alive, p, torch.full((), 1.0 / Sk))
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]  # (B, H, Sq, 1)
    ds = torch.where(mask, p * (dp - delta), torch.zeros(()))
    if softcap:
        ds = ds * (1.0 - th * th)
    ds = ds * scale
    dkh = torch.zeros(B, H, Sk, D)
    dvh = torch.zeros(B, H, Sk, D)
    up = bool(window) and not causal
    for i0 in (range(0, Sq, bq) if up else reversed(range(0, Sq, bq))):
        pt = p[:, :, i0:i0 + bq].transpose(-1, -2)
        dst = ds[:, :, i0:i0 + bq].transpose(-1, -2)
        dvh = dvh + mm_3xtf32(pt, doh[:, :, i0:i0 + bq])
        dkh = dkh + mm_3xtf32(dst, qh[:, :, i0:i0 + bq])
    dk = dkh[:, 0::G]
    dv = dvh[:, 0::G]
    for g in range(1, G):
        dk = dk + dkh[:, g::G]
        dv = dv + dvh[:, g::G]
    dq = torch.zeros(B, H, Sq, D)
    starts = range(0, Sk, bk)
    for k0 in (reversed(starts) if up else starts):
        dq = dq + mm_3xtf32(ds[..., k0:k0 + bk], kh[:, :, k0:k0 + bk])
    return (dq.transpose(1, 2), dk.transpose(1, 2).contiguous(),
            dv.transpose(1, 2).contiguous())


def attention_grad_f64(q, k, v, do, *, causal, window, q_offset=0,
                       softcap=0.0):
    """dq, dk, dv of attention in float64 by autograd."""
    q, k, v = (t.double().requires_grad_(True) for t in (q, k, v))
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.reshape(B, Sq, KH, H // KH, D), k) * D ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = ref.attention_mask(Sq, Sk, q.device, causal=causal,
                              window=window, q_offset=q_offset)
    s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype))
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v)
    return torch.autograd.grad(o.reshape(B, Sq, H, D), (q, k, v),
                               do.double())


# (B, Sq, Sk, H, KH, D, causal, window, softcap, q_offset): a causal GQA
# layer (G = 4), a recurrentgemma-like D 256 MQA layer with a window, a
# ragged non-causal cross-attention with a softcap under GQA, and a window
# without the causal mask (dQ's key tiles in descending order)
ATTN_BWD_CASES = {"causal_gqa_d64": (1, 160, 160, 8, 2, 64, True, 0, 0.0, 0),
                  "window_d256": (1, 200, 200, 4, 1, 256, True, 48, 0.0, 0),
                  "cross_softcap_d128": (2, 70, 100, 4, 2, 128, False, 0,
                                         30.0, 0),
                  "window_only_d64": (1, 150, 150, 4, 2, 64, False, 40, 0.0,
                                      0)}


@pytest.mark.parametrize("case", sorted(ATTN_BWD_CASES))
def test_attention_bwd_tiled_association(case):
    """The backward kernel's order of sums, 3xTF32 products emulated, is no
    further from a float64 backward than twice the plain version's error,
    on each of dq, dk and dv."""
    B, Sq, Sk, H, KH, D, causal, window, softcap, q_offset = \
        ATTN_BWD_CASES[case]
    q, do = (_randn(seed, B, Sq, H, D) for seed in (D, D + 1))
    k, v = (_randn(seed, B, Sk, KH, D) for seed in (D + 2, D + 3))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    o, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    got = attention_bwd_tiled(q, k, v, o, do, lse, bk=32 if D == 256 else 64,
                              **kw)
    want = ref.attention_bwd_ref(q, k, v, o, do, lse, **kw)
    exact = attention_grad_f64(q, k, v, do, **kw)
    for g, w, x, name in zip(got, want, exact, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err_t = float((g.double() - x).abs().max())
        err_p = float((w.double() - x).abs().max())
        assert err_t <= 2 * err_p, (name, err_t, err_p)
