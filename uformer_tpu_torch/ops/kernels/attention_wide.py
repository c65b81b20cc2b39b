"""Windows above 8 (N = win² > 64 tokens, any size) in kernels 4, 5 and 6.

Kernel source `csrc/attention_wide.cu`. A window of 81 tokens or more does
not fit one 64-row tile, so these wrappers run a short chain of kernels
where windows 1-8 run one: the q | k | v projection over 64-row tiles of
tokens (`wide_gemm_mma` on the tensor cores in bf16, `[Wq | Wkv]` read in place
as two parts; after LN1 and the modulator where they apply, `wide_xm`),
the window core with a key-chunked online softmax (64 query rows of one
window and head, 64-key chunks, the SW-MSA mask inline from region ids;
in bf16 on the tensor cores, `csrc/wide_core_mma.cuh`, `core_windows`
windows a block sharing each staged bias block; in fp32 `wide_core_fwd`
on the CUDA cores, the bias read per chunk; each launch counted on its
wrapper by body, `core_mma_launches` or `core_fma_launches`), the output
projection; the backward recomputes q, k, v and dO = g Wo^T (in the
working dtype), runs the core's VJP without atomics over groups of
windows (and, where one window's heads pass the budget, of heads) whose
fp32 dS fits `DS_BUDGET` (`ds_groups`), folding each group's dS into
dbias in a fixed order (one group: the whole batch at once): in bf16 on
the tensor cores (`csrc/wide_core_bwd_mma.cuh`: the forward's core for O
and the row statistics, then dq and dk | dv at JAX's rounding points,
`bwd_core_windows` windows a block whose dS leaves summed), in fp32 on
the CUDA cores (`wide_core_bwd_q`, `wide_core_bwd_kv`), each launch
counted by body on `count` as the forward's; then dxm and the LayerNorm
VJP on the fp32 dxm, and reduces the weight, bias, modulator and
LayerNorm gradients by `csrc/wgrad.cu` (`wgrad`, `colsum`) in a fixed
order. Each is called by its kernel's wrapper (`fused_window_attention`,
`fused_attention_block`, `fused_attention_block_bwd`) on CUDA tensors
only, after the wrapper's checks; the plain versions are the wrappers'.
"""

from __future__ import annotations

import torch

from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load
from uformer_tpu_torch.ops.kernels.wgrad import colsum, sm_count, wgrad

MAX_C = 1024  # the LayerNorm VJP's lanes hold at most 32 channels each
LN_ROWS = 64  # tokens of one block of the LayerNorm VJP (its dln partial)
# bytes of fp32 dS the backward holds at once: a module constant (a test
# may lower it), not an option; one window's head takes N² 4 bytes
DS_BUDGET = 256 << 20
INT_MAX = 2 ** 31 - 1  # the kernels' token, block, stride and dS-row indices
ROWS = 64  # query rows of a core block, keys of a chunk
# windows a block of the bf16 core: 4 at head dims 56-64, 2 below
# (`core_windows`)
MMA_WIDE_HEADS = 56
BWD_MAX_G = 2  # windows a block of the bf16 backward's dq and dk | dv passes

def core_windows(Bw: int, nH: int, N: int, D: int, sms: int) -> int:
    """Windows G a block of the bf16 core (four warps a window): 4 at head
    dims of MMA_WIDE_HEADS and up, where a window's q, K and V tiles
    (45 KB) leave room for one block an SM at any G, so four windows give
    it 16 warps; 2 below, where two 2-window blocks fit an SM (16 warps)
    at half the warps a barrier waits for; halved while the grid
    (nH ceil(N / 64) ceil(Bw / G) blocks) has fewer blocks than the
    `sms` SMs, and never above Bw. A block stages each bias block once
    for its G windows. On an H100 G 2 ran 10-25% faster than 4 at head
    dims 8-32, and 4 11-17% faster than 2 at 64 (PERF.md §6)."""
    tiles = -(-N // ROWS)
    G = 4 if D >= MMA_WIDE_HEADS else 2
    while G > 1 and (G > Bw or nH * tiles * -(-Bw // G) < sms):
        G //= 2
    return G


def bwd_core_windows(Bw: int, nH: int, N: int, sms: int) -> int:
    """Windows G a block of the bf16 backward's dq and dk | dv passes
    (four warps a window; their accumulators take up to 255 registers a
    thread, so at most BWD_MAX_G windows): BWD_MAX_G, halved while the
    grid (nH ceil(N / 64) ceil(Bw / G) blocks) has fewer blocks than the
    `sms` SMs, and never above Bw. A block stages each bias block once for
    its G windows and sums their dS before it leaves, so the dS scratch
    and colsum's read shrink G times."""
    tiles = -(-N // ROWS)
    G = BWD_MAX_G
    while G > 1 and (G > Bw or nH * tiles * -(-Bw // G) < sms):
        G //= 2
    return G


def check_int32(**sizes: int) -> None:
    """Raise before any launch where a size passes the kernels' 32-bit
    indices, naming it."""
    for name, n in sizes.items():
        if n > INT_MAX:
            raise ValueError(f"attention_wide: {name} = {n} passes the "
                             f"kernels' 32-bit index ({INT_MAX})")


def ds_groups(Bw: int, nH: int, N: int, G: int = 1):
    """The backward core's groups, in the order their dS folds into
    dbias: (first window, windows, first head, heads), each group's fp32
    dS (ceil(windows / G) x heads x N² floats: G windows a block summed
    before they leave) within DS_BUDGET where one head of one window fits
    it. Every head of as many windows as fit (a multiple of G, but for
    the last group); where one window's heads do not, one window at a
    time in groups of heads."""
    per_head = N * N * 4
    heads = max(1, min(nH, DS_BUDGET // per_head))
    if heads < nH:
        return [(w0, 1, h0, min(heads, nH - h0)) for w0 in range(Bw)
                for h0 in range(0, nH, heads)]
    n = max(1, min(Bw, G * (DS_BUDGET // (nH * per_head))))
    return [(w0, min(n, Bw - w0), 0, nH) for w0 in range(0, Bw, n)]


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _at(t: torch.Tensor, offset: int) -> int:
    """The address of element `offset` of contiguous t."""
    return t.data_ptr() + offset * t.element_size()


def _gemm(lib, a, b, bias, out, *, b_trans: bool, stream, b2=None,
          bias2=None):
    """out (M, Nn) = a (M, K) b + bias; b (K, Nn), or (Nn, K) with b_trans.
    With b2, b's rows continue in b2's ([b | b2], K x (Nn1 + Nn2), or
    with b_trans its transpose) and the bias in bias2, unconcatenated."""
    M, K = a.shape
    Nn = out.shape[1]
    err = lib.uf_wide_gemm(_bf16(a), int(b_trans),
                           int(out.dtype == torch.float32), a.data_ptr(),
                           b.data_ptr(), _launch.ptr(b2), b.shape[1],
                           _launch.ptr(bias), _launch.ptr(bias2),
                           out.data_ptr(), M, K, Nn, stream)
    _launch.check(err, "attention_wide gemm kernel")


def _xm(lib, x, mod, ln_s, ln_b, has_ln: bool, stream):
    """xm = [LN](x) + mod: x itself where neither applies."""
    Bw, N, C = x.shape
    if not has_ln and mod is None:
        return x
    xm = torch.empty_like(x)
    err = lib.uf_wide_xm(_bf16(x), x.data_ptr(), _launch.ptr(mod),
                         _launch.ptr(ln_s) if has_ln else None,
                         _launch.ptr(ln_b) if has_ln else None,
                         xm.data_ptr(), Bw * N, N, C, int(has_ln), stream)
    _launch.check(err, "attention_wide xm kernel")
    return xm


def _qkv(lib, xm, wq, bq, wkv, bkv, stream):
    """The (Bw N, 3C) rows of q | k | v in xm's dtype."""
    C = xm.shape[-1]
    qkv = torch.empty(xm.numel() // C, 3 * C, dtype=xm.dtype,
                      device=xm.device)
    _gemm(lib, xm.view(-1, C), wq, bq, qkv, b_trans=False, stream=stream,
          b2=wkv, bias2=bkv)
    return qkv


def _core(lib, q, k, v, in_view, bias, out, out_view, *, Bw, nH, N, D, H,
          W, win, shift, w_off, scale, scale_q, count):
    """The forward core on q, k, v (data pointers) of shared strides
    `in_view` into `out` (strides `out_view`), (window, head, token); the
    body by dtype, its launch counted on the wrapper `count`: the
    tensor-core body (bf16, csrc/wide_core_mma.cuh) in
    `core_mma_launches`, the CUDA-core one (fp32, wide_core_fwd) in
    `core_fma_launches`."""
    bf16 = out.dtype == torch.bfloat16
    G = core_windows(Bw, nH, N, D, sm_count(out.device)) if bf16 else 1
    err = lib.uf_wide_core(int(bf16), q, k, v, *in_view, bias.data_ptr(),
                           out.data_ptr(), *out_view, Bw, nH, N, D, H, W,
                           win, shift, w_off, float(scale), int(scale_q), G,
                           _launch.stream(out))
    _launch.check(err, "attention_wide core kernel")
    if bf16:
        count.core_mma_launches += 1
    else:
        count.core_fma_launches += 1


def wide_window_attention(q, k, v, bias, *, win, shift, H, W, scale, count):
    """Kernel 4 at N > 64: q, k, v (nH, Bw, N, D) -> (nH, Bw, N, D), the
    fp32 logits scaled (as `window_attention_reference`); the core's
    launch counted on `count` (`_core`)."""
    nH, Bw, N, D = q.shape
    check_int32(blocks=nH * Bw * -(-N // ROWS), head_stride=Bw * N * D)
    lib = load()
    out = torch.empty_like(q)
    view = (N * D, Bw * N * D, D)  # (window, head, token) strides
    with torch.cuda.device(q.device):
        _core(lib, q.data_ptr(), k.data_ptr(), v.data_ptr(), view, bias, out,
              view, Bw=Bw, nH=nH, N=N, D=D, H=H, W=W, win=win, shift=shift,
              w_off=0, scale=scale, scale_q=False, count=count)
    return out


def wide_attention_block(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias,
                         *, win, shift, H, W, scale, num_heads, has_ln,
                         w_off, count):
    """Kernel 5 at N > 64 on (Bw, N, C) windows: [LN] + mod, q | k | v,
    the core (q rounded times the rounded scale, as the block's plain
    version; its launch counted on `count`), the output projection."""
    Bw, N, C = x.shape
    D = C // num_heads
    check_int32(tokens=Bw * N, blocks=Bw * num_heads * -(-N // ROWS),
                window_stride=N * 3 * C)
    lib = load()
    stream = _launch.stream(x)
    with torch.cuda.device(x.device):
        qkv = _qkv(lib, _xm(lib, x, mod, ln_s, ln_b, has_ln, stream), wq, bq,
                   wkv, bkv, stream)
        o = torch.empty(Bw * N, C, dtype=x.dtype, device=x.device)
        _core(lib, qkv.data_ptr(), qkv[:, C:].data_ptr(),
              qkv[:, 2 * C:].data_ptr(), (N * 3 * C, D, 3 * C), bias, o,
              (N * C, D, C), Bw=Bw, nH=num_heads, N=N, D=D, H=H, W=W,
              win=win, shift=shift, w_off=w_off, scale=scale, scale_q=True,
              count=count)
        y = torch.empty_like(x)
        _gemm(lib, o, wo, bo, y.view(-1, C), b_trans=False, stream=stream)
    return y


def wide_block_bwd_parts(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias,
                         *, win, shift, H, W, scale, num_heads, has_ln,
                         count):
    """Kernel 6 at N > 64, unrun, as `attention_bwd_parts` returns it:
    ([(name, run)], result). The parts: "recompute" (xm, q | k | v, dO =
    g Wo^T in the working dtype), "core" (O, dq | dk | dv and dbias: per
    `ds_groups` group its dS into a scratch of at most DS_BUDGET bytes,
    folded into dbias by colsum; bf16 on the tensor cores, its launch
    counted in `count.core_mma_launches`, fp32 on the CUDA cores in
    `count.core_fma_launches`), "dxm" (dxm = dqkv [Wq | Wkv]^T in fp32,
    then dx by the LayerNorm VJP), the two weight gradients by `wgrad`,
    and "colsum" (dmod over windows, dln over the VJP's blocks)."""
    Bw, N, C = x.shape
    D = C // num_heads
    if C > MAX_C:
        raise ValueError(f"backward kernel at windows above 8 needs C <= "
                         f"{MAX_C}: C={C}")
    bf16 = x.dtype == torch.bfloat16
    sms = sm_count(x.device)
    G = bwd_core_windows(Bw, num_heads, N, sms) if bf16 else 1
    groups = ds_groups(Bw, num_heads, N, G)
    _, n0, _, hg = groups[0]  # the largest group
    ds_rows = -(-n0 // min(G, n0))  # its dS rows
    check_int32(tokens=Bw * N, blocks=Bw * num_heads * -(-N // ROWS),
                window_stride=N * 3 * C, ds_row=ds_rows * hg * N * N)
    lib = load()
    dev, dt, f32 = x.device, x.dtype, torch.float32
    M = Bw * N
    stream = _launch.stream(x)
    buf = {}
    out = {}
    ln_blocks = -(-M // LN_ROWS)

    def recompute():
        buf["xm"] = _xm(lib, x, mod, ln_s, ln_b, has_ln, stream)
        buf["qkv"] = qkv = _qkv(lib, buf["xm"], wq, bq, wkv, bkv, stream)
        # dO in the working dtype: JAX's dog_h, rounded once (bf16)
        buf["do"] = do = torch.empty(M, C, dtype=dt, device=dev)
        _gemm(lib, g.view(-1, C), wo, None, do, b_trans=True, stream=stream)

    def core():
        buf["o"] = o = torch.empty(M, C, dtype=dt, device=dev)
        buf["dqkv"] = dqkv = torch.empty(M, 3 * C, dtype=dt, device=dev)
        buf["ds"] = ds = torch.empty(ds_rows * hg * N * N, dtype=f32,
                                     device=dev)
        # bf16: a float4 a row (m log2 e, 1 / l, rowsum(dO O), 0); fp32:
        # the row max and sum
        buf["stats"] = stats = torch.empty(n0 * hg * N * (4 if bf16 else 2),
                                           dtype=f32, device=dev)
        buf["dbias"] = dbias = (torch.empty(num_heads * N * N, dtype=f32,
                                            device=dev)
                                if len(groups) > 1 else None)
        for w0, n, h0, nh in groups:
            t0, c0 = w0 * N, h0 * D  # first token, first head's column
            ptrs = (_at(buf["qkv"], t0 * 3 * C + c0),
                    _at(buf["do"], t0 * C + c0), _at(bias, h0 * N * N),
                    _at(o, t0 * C + c0), _at(dqkv, t0 * 3 * C + c0),
                    ds.data_ptr(), stats.data_ptr(), n, nh, N, D, C, H, W,
                    win, shift, w0, float(scale))
            gn = min(G, n)  # a group of one window takes one a block
            if bf16:
                err = lib.uf_wide_core_bwd_mma(
                    *ptrs, gn, core_windows(n, nh, N, D, sms), stream)
            else:
                err = lib.uf_wide_core_bwd(*ptrs, stream)
            _launch.check(err, "attention_wide backward core kernel")
            rows = -(-n // gn)
            part = colsum(ds[:rows * nh * N * N].view(rows, nh * N * N))
            if dbias is None:
                buf["dbias"] = part
            elif w0 == 0:
                dbias[h0 * N * N:(h0 + nh) * N * N].copy_(part)
            else:
                dbias[h0 * N * N:(h0 + nh) * N * N].add_(part)
        if bf16:
            count.core_mma_launches += 1
        else:
            count.core_fma_launches += 1

    def dxm():
        buf["dxm"] = dxm_ = torch.empty(M, C, dtype=f32, device=dev)
        _gemm(lib, buf["dqkv"], wq, None, dxm_, b_trans=True, stream=stream,
              b2=wkv)
        out["dx"] = dx = torch.empty_like(x)
        buf["dln"] = dln = (torch.empty(ln_blocks, 2 * C, dtype=f32,
                                        device=dev) if has_ln else None)
        err = lib.uf_wide_ln_bwd(
            _bf16(x), x.data_ptr(), dxm_.data_ptr(),
            _launch.ptr(ln_s) if has_ln else None, dx.data_ptr(),
            _launch.ptr(dln), M, C, int(has_ln), LN_ROWS, ln_blocks, stream)
        _launch.check(err, "attention_wide LayerNorm VJP kernel")

    def reduce(key, fn):
        def run():
            out[key] = fn()
        return run

    parts = [("recompute", recompute), ("core", core), ("dxm", dxm),
             ("wgrad dWqkv", reduce("dw", lambda: wgrad(
                 buf["xm"].view(-1, C), buf["dqkv"], colsum_b=True))),
             ("wgrad dWo", reduce("dwo", lambda: wgrad(
                 buf["o"], g.view(-1, C), colsum_b=True))),
             ("colsum", reduce("sums", lambda: (
                 buf["dbias"].view(num_heads, N, N),
                 colsum(buf["dxm"].view(Bw, N * C)).view(N, C)
                 if mod is not None else None,
                 colsum(buf["dln"]) if has_ln else None)))]

    def result():
        dw, db = out["dw"]
        dwo, dbo = out["dwo"]
        dbias, dmod, dln = out["sums"]
        return (out["dx"], dmod, dln[:C] if has_ln else None,
                dln[C:] if has_ln else None, dw[:, :C].contiguous(), db[:C],
                dw[:, C:].contiguous(), db[C:], dwo, dbo, dbias)

    return parts, result
