#!/usr/bin/env python3
"""Kernel 6's bf16 dbias above window 8 in a torch emulation of the wide
backward's rounding points (`uformer_tpu_torch/csrc/attention_wide.cu`),
against its gate:

    python3 wide_bwd_emulation.py --case           # phase 23's draw
    python3 wide_bwd_emulation.py --case --device cuda   # and the kernel
    python3 wide_bwd_emulation.py --seeds 200-224 --C 16 --heads 2 --win 24

The emulation takes q, k and v as the kernel does (LN1 rounded, the
projection in fp32 plus the fp32 bias rounded once, as JAX's `proj`),
dO = g Wo^T in fp32, the softmax, dP and dS = P (dP - rowsum(P dP)) in
fp32, and dbias summed over windows in fp32, with the logits in each of
two forms: "jax", the fp32 q k^T times the scale (JAX's kernel 6,
`attention_block.py:674-678`, and the port's), and "q", q rounded times
the rounded scale (the forward's, and the port's backward before it took
JAX's); dO stays fp32 in both (the CUDA-core core's; the tensor-core
core's own points, dO rounded to bf16 among them, are emulated in
`tests/test_torch_port_wide_core_bwd_mma.py`). Each is held against the fp32 plain VJP (fp32 weights), beside
the plain bf16 VJP, over GEOM_DRAWS draws pooled, by `chip_smoke.py`'s
gate (max error within 1.5x the plain bf16 VJP's + 1e-3 max(1,
max|ref|)); the line gives each form's error over its gate.

--case     the operands of phase 23's kernel-6 case at window 24, shift
           0, C 16, 2 heads, LN (`above16_kernel_checks`' draws from its
           seed, in its order); with --device cuda also the kernel's own
           dbias (`fused_attention_block_bwd`) against the "jax" form.
--seeds    golden-rule operands from each seed (`chip_smoke.GoldenDraws`)
           at --C, --heads, --win, shift 0, LN, 8 windows.
"""

from __future__ import annotations

import argparse

import torch

import chip_smoke as cs
from uformer_tpu_torch.ops import kernels as K

BF = torch.bfloat16
CASE = (24, 0, (16, 2, True, False))  # phase 23: win, shift, block case


def rnd(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF).float()


def emulated_dbias(x, g, p, *, num_heads: int, scale: float, logits: str):
    """dbias (nH, N, N) of the wide backward at bf16 operands p (the
    kernels' dict: bf16 matrices, fp32 vectors), LN on, no modulator."""
    Bw, N, C = x.shape
    nH, D = num_heads, C // num_heads
    xm = rnd(torch.nn.functional.layer_norm(x, (C,), p["ln_s"], p["ln_b"],
                                            eps=1e-5))
    q = rnd(xm @ p["wq"].float() + p["bq"])
    kv = rnd(xm @ p["wkv"].float() + p["bkv"])
    dO = g @ p["wo"].float().T

    def heads(t):
        return t.reshape(Bw, N, nH, D).transpose(1, 2)

    qh, kh, vh, dOh = heads(q), heads(kv[..., :C]), heads(kv[..., C:]), \
        heads(dO)
    if logits == "jax":
        s = (qh @ kh.transpose(-1, -2)) * scale
    else:
        s = rnd(qh * rnd(torch.tensor(scale)).item()) @ kh.transpose(-1, -2)
    P = torch.softmax(s + p["bias"][None], -1)
    dP = dOh @ vh.transpose(-1, -2)
    return (P * (dP - (P * dP).sum(-1, keepdim=True))).sum(0)


def case_operands(device):
    """Phase 23's kernel-6 case at CASE: its parameters and its draws of
    (x, g), from `above16_kernel_checks`' generator in its order."""
    draw = cs.GoldenDraws(25, device)
    mat, xin = draw.mat, draw.xin
    for win in cs.ABOVE16_WINDOWS:  # kernel 4's operands come first
        N, Bw = win * win, cs.ABOVE16_IMAGES * 4
        for _ in (0, win // 2):
            for nH, D in cs.ABOVE16_CORE_CASES:
                xin(nH, Bw, N, D), xin(nH, Bw, N, D)
                mat(nH, N, N, fan_in=nH), xin(nH, Bw, N, D)
    for win in cs.ABOVE16_WINDOWS:
        for shift in (0, win // 2):
            for c in cs.ABOVE16_BLOCK_CASES:
                N, Bw = win * win, cs.ABOVE16_IMAGES * 4
                C, nH, _, with_mod = c
                prm = draw.attn_prm(C, nH, N, with_mod)
                xin(Bw, N, C)  # timed_compare's input
                xs = [(xin(Bw, N, C), xin(Bw, N, C))
                      for _ in range(cs.GEOM_DRAWS)]
                if (win, shift, c) == CASE:
                    return prm, xs
    raise AssertionError("CASE is not one of phase 23's")


def seed_operands(seed: int, C: int, nH: int, N: int, device):
    draw = cs.GoldenDraws(seed, device)
    prm = draw.attn_prm(C, nH, N, False)
    return prm, [(draw.xin(8, N, C), draw.xin(8, N, C))
                 for _ in range(cs.GEOM_DRAWS)]


def reading(prm, xs, win: int, kernel: bool) -> dict:
    """Each form's pooled max error over its gate, per-draw errors."""
    C = prm[torch.float32]["wq"].shape[0]
    nH = prm[torch.float32]["bias"].shape[0]
    kw = dict(win=win, shift=0, H=2 * win, W=2 * win,
              scale=(C // nH) ** -0.5, num_heads=nH, has_ln=True)
    p32, p16 = (list(prm[dt].values()) for dt in (torch.float32, BF))
    out = {"plain": [], "jax": [], "q": [], "kernel": [],
           "kernel_vs_jax": []}
    top = 0.0
    for x, g in xs:
        ref = K.attention_block_vjp_reference(x, g, *p32, **kw)[-1]
        top = max(top, float(ref.abs().max()))
        low = K.attention_block_vjp_reference(x.to(BF), g.to(BF), *p16,
                                              **kw)[-1].float()
        out["plain"].append(float((low - ref).abs().max()))
        emu = {}
        for form in ("jax", "q"):
            emu[form] = emulated_dbias(x, g, prm[BF], num_heads=nH,
                                       scale=kw["scale"], logits=form)
            out[form].append(float((emu[form] - ref).abs().max()))
        if kernel:
            got = K.fused_attention_block_bwd(x.to(BF), g.to(BF), *p16,
                                              **kw)[-1]
            out["kernel"].append(float((got - ref).abs().max()))
            out["kernel_vs_jax"].append(float((got - emu["jax"]).abs().max()))
    gate = 1.5 * max(out["plain"]) + 1e-3 * max(1.0, top)
    ratios = {f: max(out[f]) / gate for f in ("jax", "q", "kernel")
              if out[f]}
    return {"over_gate": ratios, "per_draw": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", action="store_true")
    ap.add_argument("--seeds")
    ap.add_argument("--C", type=int, default=16)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--win", type=int, default=24)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.case:
        prm, xs = case_operands(device)
        r = reading(prm, xs, CASE[0], device.type == "cuda")
        print("case", {k: round(v, 4) for k, v in r["over_gate"].items()},
              {k: [f"{e:.3e}" for e in v] for k, v in r["per_draw"].items()
               if v}, flush=True)
    if args.seeds:
        first, last = map(int, args.seeds.split("-"))
        for seed in range(first, last + 1):
            prm, xs = seed_operands(seed, args.C, args.heads,
                                    args.win * args.win, device)
            r = reading(prm, xs, args.win, False)
            print(seed, {k: round(v, 4) for k, v in r["over_gate"].items()},
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
