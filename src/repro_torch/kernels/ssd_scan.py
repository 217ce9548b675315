"""Mamba-2 chunked SSD scan: the wrapper of the CUDA kernel in
``csrc/ssd_scan.cu`` (the port of ``repro.kernels.ssd_scan.ssd_scan``).

``ssd_scan(x, dt, A, Bmat, Cmat, chunk=128)`` takes x (B, S, H, P), dt
(B, S, H), A (H,) and Bmat, Cmat (B, S, N), float32, and returns y
(B, S, H, P) float32 from a zero initial state, in chunks of
Q = min(chunk, S) steps; S must be a multiple of Q.  x and dt may be
strided views of the model's tensors (x's last dimension contiguous), so
nothing is transposed or copied.  It takes CUDA tensors only and launches
the kernels or raises; ``kernels.ops.ssd_scan`` is the device dispatch that
gives CPU tensors the plain version.

One call runs up to four CUDA launches on the current stream (C B^T per
chunk, the chunk states with a second chunk, the state pass with a third,
the outputs) over scratch this wrapper allocates with ``torch.empty``.

``ssd_scan_bwd(x, dt, A, Bmat, Cmat, dy, chunk=128)`` is the gradient, the
kernels of ``csrc/ssd_scan_bwd.cu``: from the five operands (the forward's
C B^T and states are recomputed, not kept) and dy (B, S, H, P), it returns
(dx, ddt, dA, dB, dC) in the operands' shapes, contiguous float32, in up
to nine CUDA launches over ``torch.empty`` scratch (at mamba2-2.7b's layer
the states and their gradients, 2 x 81 MB, are the largest).  dA sums over
the batch; every other output's row b depends on row b alone.  The sums
of dCB, dB and dC over the heads run in groups of
``default_head_group(H, S, Q, N)`` heads, the groups' partials added in
order.
``launches`` and ``bwd_launches`` count calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# the kernel's register tiles: head dim, state size and chunk length
MAX_P, MAX_N, MAX_Q = 64, 128, 128

# the backward's head sums of dB and dC run on at least this many blocks
# where the heads allow: two waves of the H100's 132 SMs
HEAD_GROUP_BLOCKS = 2 * 132

# calls that launched the forward and the backward kernels since the last
# reset (ops.reset_launch_counts)
launches = 0
bwd_launches = 0


def check_operands(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bmat: torch.Tensor, Cmat: torch.Tensor,
                   chunk: int) -> int:
    """Validate the operands of either route; returns the chunk length
    Q = min(chunk, S)."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan wants x (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    B, S, H, _ = x.shape
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or Bmat.dim() != 3 or tuple(Bmat.shape[:2]) != (B, S)
            or Cmat.shape != Bmat.shape):
        raise ValueError(f"ssd_scan shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bmat.shape)}, C {tuple(Cmat.shape)}")
    ops = (x, dt, A, Bmat, Cmat)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"ssd_scan takes float32 operands, got "
                        f"{[str(t.dtype) for t in ops]}")
    if any(t.device != x.device for t in ops):
        raise ValueError("ssd_scan operands on different devices")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} must be >= 1")
    Q = min(chunk, S)
    if S and S % Q:
        raise ValueError(f"S={S} not divisible by chunk={Q}")
    return Q


def _check_launch(x, dt, A, Bmat, Cmat, chunk: int, what: str) -> int:
    """The checks both launches share; returns the chunk length Q."""
    Q = check_operands(x, dt, A, Bmat, Cmat, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches on CUDA tensors, got {x.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError(f"{what} is built for sm_90a (Hopper); device "
                           f"{torch.cuda.get_device_name(x.device)} is not")
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    if P > MAX_P or N > MAX_N or Q > MAX_Q:
        raise ValueError(f"{what} takes head dim <= {MAX_P}, state <= "
                         f"{MAX_N} and chunk <= {MAX_Q}; got P={P}, N={N}, "
                         f"Q={Q}")
    if x.stride(3) != 1 or Bmat.stride(2) != 1 or Cmat.stride(2) != 1:
        raise ValueError(f"{what} needs the last dimension of x, B and C "
                         "contiguous")
    nc = S // Q if Q else 0
    if B > 65535 or nc > 65535:
        raise ValueError(f"{what}: batch {B} or {nc} chunks exceed the "
                         f"grid's limit of 65535")
    return Q


def default_head_group(H: int, S: int, Q: int, N: int) -> int:
    """Heads a group of the backward's head sums: the fewest groups that
    give the dB and dC launch (one block per group, dB or dC, 64-wide N
    tile and chunk) ``HEAD_GROUP_BLOCKS`` blocks a row of the batch, at
    most one a head, the heads then dealt evenly.  It reads the shape but
    not the batch, so a row's sums do not depend on the batch."""
    tiles = 2 * -(-N // 64) * (S // Q)
    groups = min(H, -(-HEAD_GROUP_BLOCKS // tiles))
    return -(-H // groups)


def _strides(x, dt, Bmat, Cmat):
    return (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *Bmat.stride()[:2],
        *Cmat.stride()[:2])


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor,
             chunk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernels on CUDA tensors."""
    global launches
    Q = _check_launch(x, dt, A, Bmat, Cmat, chunk, "ssd_scan")
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or N == 0:
        return y.zero_()
    nc = S // Q
    A = A.contiguous()
    dev = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((B, nc, Q, -(-Q // 4) * 4), **dev)
    st = torch.empty((B, nc - 1, H, P, N), **dev)
    decay = torch.empty((B, nc, H), **dev)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ssd_scan_f32(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                Bmat.data_ptr(), Cmat.data_ptr(),
                                y.data_ptr(), cb.data_ptr(), st.data_ptr(),
                                decay.data_ptr(),
                                _strides(x, dt, Bmat, Cmat), B, S, H, P, N,
                                Q, stream)
    build.check(code, "ssd_scan")
    launches += 1
    return y


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bmat: torch.Tensor, Cmat: torch.Tensor, dy: torch.Tensor,
                 chunk: int = 128):
    """Launch the backward's CUDA kernels on CUDA tensors: (dx, ddt, dA,
    dB, dC)."""
    global bwd_launches
    Q = _check_launch(x, dt, A, Bmat, Cmat, chunk, "ssd_scan_bwd")
    if x.shape[2] > 65535:
        raise ValueError(f"ssd_scan_bwd: {x.shape[2]} heads exceed the "
                         f"grid's limit of 65535")
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != torch.float32 \
            or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd wants dy float32 of x's shape "
                         f"{tuple(x.shape)} on {x.device}, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    dev = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((B, S, H, P), **dev)
    ddt = torch.empty((B, S, H), **dev)
    dA = torch.empty((H,), **dev)
    dB = torch.empty((B, S, N), **dev)
    dC = torch.empty((B, S, N), **dev)
    outs = (dx, ddt, dA, dB, dC)
    if dx.numel() == 0 or N == 0:
        return tuple(t.zero_() for t in outs)
    nc = S // Q
    LQ = -(-Q // 4) * 4
    HG = default_head_group(H, S, Q, N)
    NG = -(-H // HG)
    A, dy = A.contiguous(), dy.contiguous()
    cb = torch.empty((B, nc, Q, LQ), **dev)
    st = torch.empty((B, nc - 1, H, P, N), **dev)
    gst = torch.empty((B, nc - 1, H, P, N), **dev)
    decay = torch.empty((B, nc, H), **dev)
    dap = torch.empty((B, nc, H), **dev)
    cum = torch.empty((B, nc, H, Q), dtype=torch.float64, device=x.device)
    xcb = torch.empty((B, nc, H, Q, LQ), **dev)
    dcbp = torch.empty((NG, B, nc, Q, LQ), **dev)
    part = torch.empty((NG, 2, B, S, N) if NG > 1 else (0,), **dev)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ssd_scan_bwd_f32(
            *(t.data_ptr() for t in (x, dt, A, Bmat, Cmat, dy, *outs, cb, st,
                                     decay, gst, cum, xcb, dcbp, part,
                                     dap)),
            _strides(x, dt, Bmat, Cmat), B, S, H, P, N, Q, HG, stream)
    build.check(code, "ssd_scan_bwd")
    bwd_launches += 1
    return outs
