"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(``python3 chip_smoke.py --stack-floor`` prints only the plain encoder
stack's own noise floor, which sets ENC_STACK_MEAN_REL.)

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the kernels of manga_ocr_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (MangaOCRConfig.base(), batch 32 and 256,
   S=197, D=768), with CUDA-event times of both: A, B, C on int8 params;
   D (three forms), E and F on bf16 params; the decode-step kernels J
   (steps 0, 150 and 303 of a 305-row cache, and the cache row it writes),
   K and B's post-LN step form on a quantize_decoder decoder (and, at batch
   32, on the bf16 decoder).  Each kernel's bound (the least time the card
   could take: bytes over the memory rate or operations over the peak rate
   of their type, the larger) is computed from the same shapes, and E is
   also timed as one scaled_dot_product_attention call.
4. Drives TorchMangaOcrEngine at full width (random weights from a numpy
   seed) through ocr_page on crops from tests/fixtures/eval:
   - int8 serving (kernels A, B, C), also through the HTTP server;
   - unquantized serving (quantize_int8=False: kernels E, D, C);
   checking the launch counters of every kernel, the encoder output and the
   decode tokens against the plain path's, and printing crops/s on one
   256-crop page.  Then the step-by-step greedy decode (head_kernel and
   step_mlp_kernel "fused": kernels F and D) at B=32 over 100 steps, its
   tokens scored by the plain step decode; and one page through the exact
   reference path (serving_kernels=False), which must launch no kernel.
   Last, the fused whole-layer step decode (step_kernel "fused_layer",
   head_kernel "fused") through ocr_forward on 32 crops: kernels A and B
   in the encoder, then per step J, K and B's step form per layer and F;
   its launch counts checked exactly and its tokens scored by the plain
   fused_layer step decode on the plain encoder output; its cross-K/V +
   decode time at batch 32 and 256 beside kernel C's on the same encoder
   output.
5. The encoder's kernel variants at full width: A's bf16 form, G (also
   timed as one scaled_dot_product_attention call), H (int8 and bf16) and
   I (int8 and bf16: one and two layers at the per-kernel bounds, twelve
   at stack_lpc 12 and 5) held against their plain versions at B=256, H's
   and I's bf16 form also timed as one torch.nn.TransformerEncoder call;
   then each encoder configuration through ocr_forward on 32
   crops with kernel C as the decode (serving() on bf16 params: A's bf16
   form and D; fused_layer on MLP-only int8 params: A's bf16 form and B;
   merged_layer int8 and bf16: H; stacked int8 and bf16 at lpc 12 and 5:
   I; encode(fused_attention=True): G and D), launch counts exact, the
   encoder output against the plain encoder's, the tokens scored by
   teacher forcing; and one page through the engine with
   serving_kernels=False on a merged_layer bf16 config (H and C).
6. The forms of kernels A and C that complete the port: A's sdpa_int8
   form held against its plain version at B=256 (and sdpa_headpack shown
   bit-identical to A's default form); C's int8_w form, its fuse_kv form
   (bf16 and int8 weights, scored by the unfused plain decoder over the
   slabs of the final LN, timed beside precompute_cross_kv_packed + the
   unfused kernel) at B=256, and C's time with each stage ablated.  Then
   the slice's paths: the int8 engine with attn_sdpa_int8 and
   fuse_cross_kv through ocr_page (A 12 in the sdpa_int8 form, B 12 and C
   1 in the fuse_kv form per dispatch, no slab precompute; teacher-forced
   tokens, crops/s, the stage split), and ocr_forward on 32 crops with
   quantize_decoder weights, with and without fuse_cross_kv (C's int8_w
   form; exact counts, teacher-forced tokens).
7. Prints its total seconds, one JSON line of kernel results, then the
   device line {"ok": true, "device": {...}} last.  Any failed check exits
   non-zero before the device line.
"""

from __future__ import annotations

import base64
import glob
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()

# Tolerances of the kernel checks (kernel vs plain version, same inputs, on
# the card).  The int8 products are exact in both; what differs is the f32
# summation order of the LN statistics and the softmax, and exp/division
# rounding.  Those move a value across an int8 rounding boundary now and
# then (one quantization step of one activation) and across a bf16 rounding
# boundary of the output (one bf16 ulp is 2^-8..2^-7 of the value).  So the
# bounds are relative to the largest output magnitude: the largest
# difference a few bf16 ulps of it, the mean difference near zero.
ENC_MAX_REL = 2.0**-5  # 4..8 bf16 ulps at the largest magnitude
ENC_MEAN_REL = 1e-3
# Greedy decode cannot be held to bit-identical tokens: on random weights a
# difference in the last bit of one f32 sum (another summation order) flips
# a bf16 rounding now and then, later an argmax at a near-tie, and from there
# the two free-running decodes legitimately follow different histories (the
# free-running agreement is printed, not checked).  So each kernel token is
# scored instead by the plain version fed the kernel's own tokens (teacher
# forcing): at every emitted position, the plain model's largest logit minus
# its logit for the kernel's token must be 0 up to numerical noise, bounded
# relative to the largest logit.  A wrong kernel picks tokens whose gap is of
# the order of the logits themselves.
DECODE_PREFIX = 8  # free-running rows identical for this many steps: printed
DECODE_GAP_REL = 2.0**-6
# End to end, twelve encoder layers compound the per-layer differences (an
# int8 rounding flip in one layer moves the next layer's inputs), and the
# plain decoder then runs on the plain encoder output.
ENC_STACK_MAX_REL = 2.0**-4
ENGINE_GAP_REL = 2.0**-5
# The mean difference compounds too: twelve random-weight layers amplify a
# last-bit difference of their inputs into a mean difference of a few 1e-3
# of the largest output.  ``python3 chip_smoke.py --stack-floor`` prints that
# floor (the plain stack's own response to a one-ulp change of 1% of its
# inputs, and the difference between two plain stacks that differ only in
# dividing or multiplying by the reciprocal in the softmax; PERF.md records
# it); the kernels' 12-layer differences are held to 2^-7 of the largest
# output, about twice it.  Slices of one and two layers are held to the
# per-kernel bounds above.
ENC_STACK_MEAN_REL = 2.0**-7
# A library yardstick must compute the kernel's function: its output's
# change of x (the blocks' own contribution, which a wrongly loaded weight
# changes wholesale) must agree with the plain version's to this share.
LIBRARY_SAME_REL = 2.0**-1
# Kernel F returns ids only: an id passes when the plain head's logit there
# is within this share of the top logit (bf16 near-ties, as for C).
HEAD_GAP_REL = 2.0**-6
# Weight std of the random model: the HF-like init.  (With std 0.1 the
# random network is chaotic: two plain versions that differ only in f32
# summation order, on the card and on the host, disagree by up to 19% of the
# top logit under teacher forcing, so no bound there can tell a wrong kernel
# from noise; at 0.02 they agree to 0.25%.)
WEIGHT_STD = 0.02
SEED = 0
STEP_DECODE_LEN = 101  # the step-by-step decode path: 100 steps
# Published peaks of one H100 SXM (dense): the memory rate and the tensor
# core rates by input type; the bounds below are computed against them.
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def log_ptxas(build_log: str) -> None:
    """Each kernel that spills, and each that takes more than 64 registers a
    thread (kernel C's row choice counts on two 512-thread blocks per SM)."""
    import re

    name = ""
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        regs = re.search(r"Used (\d+) registers", ln)
        if ("spill" in ln and " 0 bytes spill" not in ln) or (regs and int(regs.group(1)) > 64):
            log(f"ptxas: {name[:90]}: {ln.strip()}")


def cuda_ms(fn, reps: int = 5, warm: bool = True) -> float:
    """Mean time of ``fn`` over ``reps`` runs, after one warm run (skipped
    with ``warm=False`` where the caller has just run ``fn``)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_encoder_kernels(params, cfg, results: dict) -> None:
    """Kernels A and B against their plain versions at B=32 and 256, on the
    prepared weights the encoder passes them."""
    import torch

    from manga_ocr_tpu_torch.ops import flash_attention as fa
    from manga_ocr_tpu_torch.ops import fused_mlp as fm
    from manga_ocr_tpu_torch.ops.encoder_weights import layer_view, prepare_layers

    enc = params["encoder"]["layers"]
    ecfg = cfg.encoder
    attn = {k: {n: t[0] for n, t in v.items()} for k, v in enc["attn"].items()}
    # the weights as the encoder reads them: prepared once per params
    lw = layer_view(prepare_layers(enc, torch.bfloat16), 0)
    ln1 = (enc["ln1"]["scale"][0], enc["ln1"]["bias"][0])
    ln2 = (enc["ln2"]["scale"][0], enc["ln2"]["bias"][0])
    mlp_w = (lw.fc1.w, enc["mlp"]["fc1"]["bias"][0], lw.fc2.w, enc["mlp"]["fc2"]["bias"][0])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s = ecfg.seq_len
    for batch in (32, 256):
        x = torch.randn((batch, s, ecfg.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(eps=ecfg.layer_norm_eps, valid_len=s)
        d = ecfg.hidden_size
        cases = {
            "fused_attn_layer": (
                lambda: fa.fused_attn_layer(x, attn, *ln1, ecfg.num_heads,
                                            prepared=(lw.qkv, lw.o), **kw),
                lambda: fa.fused_attn_layer_reference(x, attn, *ln1, ecfg.num_heads, **kw),
                cost_attn_layer(batch, s, d),
            ),
            "fused_mlp_block": (
                lambda: fm.fused_mlp_block(x, *ln2, *mlp_w, eps=ecfg.layer_norm_eps,
                                           gelu_mode=ecfg.gelu_mode),
                lambda: fm.fused_mlp_block_reference(x, *ln2, *mlp_w, eps=ecfg.layer_norm_eps,
                                                     gelu_mode=ecfg.gelu_mode),
                cost_mlp_int8(batch * s, d, ecfg.intermediate_size),
            ),
        }
        if batch == 256:  # A's int8 SDPA form, on the serving path of the slice
            cases["fused_attn_layer[sdpa_int8]"] = (
                lambda: fa.fused_attn_layer(x, attn, *ln1, ecfg.num_heads,
                                            prepared=(lw.qkv, lw.o), sdpa_int8=True, **kw),
                lambda: fa.fused_attn_layer_reference(x, attn, *ln1, ecfg.num_heads,
                                                      sdpa_int8=True, **kw),
                cost_attn_layer(batch, s, d, sdpa_int8=True),
            )
        for name, (kern, plain, cost) in cases.items():
            results[name] = hold(name, f"B={batch}", kern, plain, cost)
    # sdpa_headpack is A's default SDPA (JAX's zero blocks add exact zeros)
    packed = fa.fused_attn_layer(x, attn, *ln1, ecfg.num_heads, prepared=(lw.qkv, lw.o),
                                 sdpa_headpack=True, **kw)
    if not torch.equal(packed, fa.fused_attn_layer(x, attn, *ln1, ecfg.num_heads,
                                                   prepared=(lw.qkv, lw.o), **kw)):
        fail("fused_attn_layer: sdpa_headpack differs from the default form")
    log("fused_attn_layer[sdpa_headpack] B=256: bit-identical to the default form")


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """The least time in ms the card could take for work that moves
    ``nbytes`` (each input read once, each output written once) and does
    ``ops`` operations by input type: the larger of the two times, and which
    one sets it."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = sum(n / H100_OPS_PER_S[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# Bytes and operations of each kernel's work at the shapes it is called
# with (multiply-adds count 2; bf16 inputs at the bf16 rate, int8 at int8).
def cost_attn_layer(b, s, d, sdpa_int8=False):  # A: LN + 4 int8 projections + SDPA + residual
    m = b * s
    sdpa = 2 * 2 * b * s * s * d
    if sdpa_int8:
        return 2 * m * d * 2 + 4 * d * d, {"int8": 4 * 2 * m * d * d + sdpa}
    return 2 * m * d * 2 + 4 * d * d, {"int8": 4 * 2 * m * d * d, "bf16": sdpa}


def cost_attn_layer_bf16(b, s, d):  # A's bf16 form: LN + 4 bf16 projections + SDPA
    m = b * s
    return 2 * m * d * 2 + 4 * d * d * 2, {"bf16": 4 * 2 * m * d * d + 2 * 2 * b * s * s * d}


def cost_layers(b, s, d, inter, int8, n_layers=1):  # H (one layer), I (n): x in, x out once
    m = b * s
    w_bytes = (4 * d * d + 2 * d * inter) * (1 if int8 else 2)
    proj = 2 * m * (4 * d * d + 2 * d * inter)
    ops = {"int8": proj, "bf16": 2 * 2 * b * s * s * d} if int8 else \
        {"bf16": proj + 2 * 2 * b * s * s * d}
    return 2 * m * d * 2 + n_layers * w_bytes, {k: n_layers * v for k, v in ops.items()}


def cost_mlp_int8(m, d, inter):  # B: two int8 GEMMs over m rows
    return 2 * m * d * 2 + 2 * d * inter, {"int8": 2 * 2 * m * d * inter}


def cost_mlp_bf16(m, d, inter):  # D
    return 2 * m * d * 2 + 2 * d * inter * 2, {"bf16": 2 * 2 * m * d * inter}


def cost_attention_packed(b, s, d):  # E: q, k, v in, context out
    return 4 * b * s * d * 2, {"bf16": 2 * 2 * b * s * s * d}


def cost_head(b, d, v):  # F: transform + vocab GEMV, ids out
    return b * d * 2 + (d * d + d * v) * 2 + b * 4, {"bf16": 2 * b * (d * d + d * v)}


def cost_self_step(b, d, step, int8_w):  # J at ``step``: the live cache rows
    w_bytes = 4 * d * d * (1 if int8_w else 2)
    proj = {"int8" if int8_w else "bf16": 2 * b * 4 * d * d}
    attn = 2 * 2 * b * (step + 1) * d
    return (2 * b * d * 2 + 2 * (step + 1) * b * d * 2 + w_bytes,
            {**proj, "bf16": proj.get("bf16", 0) + attn})


def cost_cross_step(b, s, d, int8_w, int8_kv):  # K: the slabs once
    kv = 2 * b * s * d * (1 if int8_kv else 2) + ((b * s + b * d) * 4 if int8_kv else 0)
    proj = {"int8" if int8_w else "bf16": 2 * b * 2 * d * d}
    attn = 2 * 2 * b * s * d
    return (2 * b * d * 2 + kv + 2 * d * d * (1 if int8_w else 2),
            {**proj, "bf16": proj.get("bf16", 0) + attn})


def cost_decode_loop(cfg, lengths, s, int8_w=False, fuse_kv=False):
    """C: the row-steps this run's rows needed.  The layers' projections at
    the int8 rate under int8_w; the head, the attentions and fuse_kv's
    prologue (the cross k/v projections of s rows per layer) in bf16.
    Bytes: the slabs in (or, under fuse_kv, the raw encoder rows and the
    cross k/v weights), the weights, the tokens out."""
    d, inter, v, n_l = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    b = lengths.shape[0]
    n = lengths.long() - 1  # steps each row ran to its EOS (or the last step)
    row_steps = int(n.sum())
    key_reads = int((n * (n + 1) // 2).sum())  # self-attention keys over all row-steps
    proj = row_steps * 2 * n_l * (6 * d * d + 2 * d * inter)
    bf16 = row_steps * (2 * (d * d + d * v) + n_l * 2 * 2 * s * d) + n_l * 2 * 2 * key_reads * d
    ops = {"int8": proj, "bf16": bf16} if int8_w else {"bf16": proj + bf16}
    w_bytes = n_l * (6 * d * d + 2 * d * inter) * (1 if int8_w else 2) + (d * d + d * v) * 2
    if fuse_kv:
        ops["bf16"] += n_l * 2 * 2 * b * s * d * d
        src = b * s * d * 2 + n_l * 2 * d * d * 2
    else:
        src = 2 * n_l * b * s * d * 2
    return src + w_bytes + b * (int(lengths.max()) + 1) * 4, ops


def compare(name: str, label: str, got, want, max_rel: float = ENC_MAX_REL,
            mean_rel: float = ENC_MEAN_REL) -> tuple[float, float]:
    """Shape, finiteness, and the max and mean error relative to the
    largest output; fails past the tolerances."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        fail(f"{name} {label}: shape {tuple(got.shape)} or non-finite output")
    err = (got.float() - want.float()).abs()
    max_abs, mean_abs = float(err.max()), float(err.mean())
    top = float(want.float().abs().max())
    if max_abs > max_rel * top or mean_abs > mean_rel * top:
        fail(f"{name} {label}: error {max_abs}/{mean_abs} over "
             f"{max_rel * top}/{mean_rel * top}")
    return max_abs, mean_abs


def hold(name: str, label: str, kern, plain, cost, library=None,
         tolerance: tuple[float, float] = (ENC_MAX_REL, ENC_MEAN_REL)) -> dict:
    """One kernel against its plain version on the same inputs: shape,
    finiteness, max and mean error relative to the largest output, and
    CUDA-event times of both (and of ``library``, one PyTorch call that
    computes the same function, where there is one).  Returns the record of
    the kernels line, with the bound computed from ``cost``."""
    import torch

    got, want = kern(), plain()
    torch.cuda.synchronize()
    max_abs, mean_abs = compare(name, label, got, want, *tolerance)
    top = float(want.float().abs().max())
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    library_ms = cuda_ms(library) if library is not None else None
    bound_ms, bound_by = bound(*cost)
    log(f"{name} {label}: max_abs_err={max_abs} mean_abs_err={mean_abs} "
        f"max_abs_out={top} ms={ms} plain_ms={plain_ms} library_ms={library_ms} "
        f"bound_ms={bound_ms} ({bound_by})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def check_bf16_kernels(params, cfg, results: dict) -> None:
    """Kernels D (encoder pre-LN on [B*197, 768]; the step forms pre_ln=False
    and post_ln on [B, 768]), E and F against their plain versions at B=32
    and 256, on bf16 params."""
    import torch
    import torch.nn.functional as F

    from manga_ocr_tpu_torch.ops import flash_attention as fa
    from manga_ocr_tpu_torch.ops import fused_head as fh
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    ecfg, dcfg = cfg.encoder, cfg.decoder
    enc, dl = params["encoder"]["layers"], params["decoder"]["layers"]
    e_w = (enc["mlp"]["fc1"]["kernel"][0], enc["mlp"]["fc1"]["bias"][0],
           enc["mlp"]["fc2"]["kernel"][0], enc["mlp"]["fc2"]["bias"][0])
    e_ln = (enc["ln2"]["scale"][0], enc["ln2"]["bias"][0])
    d_w = (dl["mlp"]["fc1"]["kernel"][0], dl["mlp"]["fc1"]["bias"][0],
           dl["mlp"]["fc2"]["kernel"][0], dl["mlp"]["fc2"]["bias"][0])
    d_ln = (dl["mlp_ln"]["scale"][0], dl["mlp_ln"]["bias"][0])
    t, p = params["decoder"]["head"]["transform"], params["decoder"]["head"]["proj"]
    head_w = (t["dense"]["kernel"], t["dense"]["bias"], t["ln"]["scale"], t["ln"]["bias"],
              p["kernel"], p["bias"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    s, d = ecfg.seq_len, ecfg.hidden_size

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    inter = ecfg.intermediate_size
    heads, dh = ecfg.num_heads, ecfg.head_dim
    for batch in (32, 256):
        x = randn(batch, s, d)
        kw = dict(eps=ecfg.layer_norm_eps, gelu_mode=ecfg.gelu_mode)
        results["fused_mlp_block_bf16"] = hold(
            "fused_mlp_block_bf16", f"encoder pre-LN B={batch}",
            lambda: fm.fused_mlp_block_bf16(x, *e_ln, *e_w, **kw),
            lambda: fm.fused_mlp_block_bf16_reference(x, *e_ln, *e_w, **kw),
            cost_mlp_bf16(batch * s, d, inter))
        rows = randn(batch, d)
        for label, ln_kw in (("pre_ln=False", dict(pre_ln=False)),
                             ("post_ln", dict(pre_ln=False, post_ln=True))):
            hold("fused_mlp_block_bf16", f"step {label} B={batch}",
                 lambda: fm.fused_mlp_block_bf16(rows, *d_ln, *d_w, **ln_kw),
                 lambda: fm.fused_mlp_block_bf16_reference(rows, *d_ln, *d_w, **ln_kw),
                 cost_mlp_bf16(batch, d, inter))
        q, k, v = randn(batch, s, d), randn(batch, s, d), randn(batch, s, d)
        # the library yardstick: one scaled_dot_product_attention call on
        # the same q/k/v (head views, no copy) with the valid_len key mask
        key_mask = (torch.arange(s, device="cuda") < s)[None, :]  # keys < valid_len = S

        def heads_view(t):
            return t.view(batch, s, heads, dh).transpose(1, 2)

        results["attention_packed"] = hold(
            "attention_packed", f"B={batch}",
            lambda: fa.attention_packed(q, k, v, heads),
            lambda: fa.attention_packed_reference(q, k, v, heads),
            cost_attention_packed(batch, s, d),
            library=lambda: F.scaled_dot_product_attention(
                heads_view(q), heads_view(k), heads_view(v), attn_mask=key_mask))

        h = randn(batch, dcfg.hidden_size)
        ids = fh.fused_greedy_head(h, *head_w, eps=dcfg.layer_norm_eps)
        logits = fh.head_logits_reference(h, *head_w, eps=dcfg.layer_norm_eps)
        torch.cuda.synchronize()
        if ids.shape != (batch,) or int(((ids < 0) | (ids >= dcfg.vocab_size)).sum()):
            fail(f"fused_greedy_head B={batch}: bad ids")
        top = logits.amax(-1)
        gap = top - logits.gather(1, ids.long()[:, None])[:, 0]
        rel = float((gap / top.abs()).max())
        same = float((ids.long() == logits.argmax(-1)).float().mean())
        ms = cuda_ms(lambda: fh.fused_greedy_head(h, *head_w, eps=dcfg.layer_norm_eps))
        plain_ms = cuda_ms(lambda: fh.fused_greedy_head_reference(h, *head_w,
                                                                  eps=dcfg.layer_norm_eps))
        log(f"fused_greedy_head B={batch}: max gap {float(gap.max())} (rel {rel}), ids equal "
            f"to the plain argmax {same}; ms={ms} plain_ms={plain_ms}")
        if rel > HEAD_GAP_REL:
            fail(f"fused_greedy_head B={batch}: an id {rel} below the top logit "
                 f"(bound {HEAD_GAP_REL})")
        bound_ms, bound_by = bound(*cost_head(batch, dcfg.hidden_size, dcfg.vocab_size))
        log(f"fused_greedy_head B={batch}: bound_ms={bound_ms} ({bound_by})")
        results["fused_greedy_head"] = {"max_abs_err": float(gap.max()), "ms": ms,
                                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                                        "bound_by": bound_by, "library_ms": None}


def check_step_kernels(params, params_bf16, cfg, results: dict) -> None:
    """Kernels J, K and B's post-LN step form against their plain versions
    at batch 32 and 256 on the int8 decoder (quantize_decoder) with int8
    cross-K/V, and at batch 32 also on the bf16 decoder with bf16 slabs.
    J at steps 0, 150 and 303 of the 305-row cache of a 299-step decode in
    chunks of 8 (rows past ``step`` hold noise, which must weigh nothing),
    with the cache row it writes held against the plain version's."""
    import torch

    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.ops import common
    from manga_ocr_tpu_torch.ops import decode_layer as dl
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    dcfg = cfg.decoder
    d, heads, eps, inter = dcfg.hidden_size, dcfg.num_heads, dcfg.layer_norm_eps, \
        dcfg.intermediate_size
    s_enc = cfg.encoder.seq_len
    t_len = 1 + -(-(cfg.max_length - 1) // 8) * 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    one, zero = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    for batch in (32, 256):
        enc = torch.randn((batch, s_enc, d), generator=gen, device="cuda")
        enc = common.layer_norm(enc, one, zero, 1e-12).to(torch.bfloat16)
        forms = (("int8", params), ("bf16", params_bf16)) if batch == 32 else (("int8", params),)
        for form, p in forms:
            int8 = form == "int8"
            tag = f"{form} B={batch}"
            w = dec.prepare_fused_layer(p["decoder"], dcfg, torch.bfloat16)[0]
            ck, cv = randn(t_len, batch, d), randn(t_len, batch, d)
            pck, pcv = ck.clone(), cv.clone()
            recs = []
            for step in (0, 150, t_len - 2):
                x = randn(batch, d)
                recs.append(hold(
                    "fused_self_attn_step", f"{tag} step={step}",
                    lambda: dl.fused_self_attn_step(x, w["self"], w["self_ln"], ck, cv, step,
                                                    heads, eps)[0],
                    lambda: dl.fused_self_attn_step_reference(x, w["self"], w["self_ln"], pck,
                                                              pcv, step, heads, eps)[0],
                    cost_self_step(batch, d, step, int8)))
                row_err = [compare("fused_self_attn_step", f"{tag} cache {n} row {step}", a[step],
                                   b[step])[0] for n, a, b in (("k", ck, pck), ("v", cv, pcv))]
                log(f"fused_self_attn_step {tag} step={step}: written cache rows k/v max_abs_err "
                    f"{row_err}")
            j = {key: sum(r[key] for r in recs) / len(recs)
                 for key in ("ms", "plain_ms", "bound_ms")}  # mean over the three steps
            j.update(max_abs_err=max(r["max_abs_err"] for r in recs),
                     bound_by=recs[-1]["bound_by"], library_ms=None)
            log(f"fused_self_attn_step {tag}: mean over steps 0, 150, {t_len - 2}: {j}")

            cross = dec.precompute_cross_kv_packed(p["decoder"], enc, dcfg, int8=int8)
            ks, vs = (cross.k_scale[0], cross.v_scale[0]) if int8 else (None, None)
            x = randn(batch, d)
            k = hold("fused_cross_attn_step", tag,
                     lambda: dl.fused_cross_attn_step(x, w["cross"], w["cross_ln"], cross.k[0],
                                                      cross.v[0], ks, vs, heads, eps, s_enc),
                     lambda: dl.fused_cross_attn_step_reference(
                         x, w["cross"], w["cross_ln"], cross.k[0], cross.v[0], ks, vs, heads,
                         eps, s_enc),
                     cost_cross_step(batch, s_enc, d, int8, int8))

            rows = randn(batch, d)
            args = (rows, w["mlp_ln"]["scale"], w["mlp_ln"]["bias"], w["w1"], w["b1"], w["w2"],
                    w["b2"])
            plain = fm.fused_mlp_block_reference if int8 else fm.fused_mlp_block_bf16_reference
            kw = dict(eps=eps, pre_ln=False, post_ln=True)
            mlp = hold("fused_mlp_block", f"step form (post-LN) {tag}",
                       lambda: fm.fused_mlp_block(*args, **kw), lambda: plain(*args, **kw),
                       (cost_mlp_int8 if int8 else cost_mlp_bf16)(batch, d, inter))
            if int8:
                results["fused_self_attn_step"], results["fused_cross_attn_step"] = j, k
                results["fused_mlp_block[step]"] = mlp


def live_gap_stats(gaps, top, lengths) -> dict:
    """Teacher-forced gaps over the positions a row really emitted."""
    import torch

    steps = gaps.shape[1]
    live = torch.arange(steps, device=gaps.device)[None, :] + 1 < lengths[:, None]
    g, t = gaps[live], top[live].abs()
    return {"max_gap": float(g.max()), "max_rel_gap": float((g / t).max()),
            "nonzero_share": float((g > 0).float().mean()), "positions": int(live.sum())}


def hold_decode(name: str, label: str, run, plain, dec_params, cross, dcfg, cost) -> dict:
    """One form of kernel C against its plain version on the same inputs:
    the kernel's tokens scored by teacher forcing (the plain decoder with
    ``dec_params`` over the slabs ``cross``, fed the kernel's tokens), the
    free-running agreement printed, CUDA-event times of both; ``cost`` maps
    the kernel's lengths to the bound's (bytes, operations)."""
    import torch

    from manga_ocr_tpu_torch.ops import decode_loop as dl

    (tok, lens), (ptok, plens) = run(), plain()
    torch.cuda.synchronize()
    if int(tok[:, 0].ne(dcfg.bos_token_id).sum()) or tok.shape != ptok.shape:
        fail(f"{name} {label}: bad token matrix")
    share = float(((tok == ptok).all(1) & (lens == plens)).float().mean())
    prefix = float((tok[:, : DECODE_PREFIX + 1] == ptok[:, : DECODE_PREFIX + 1])
                   .all(1).float().mean())
    first_div = sorted(int((a != b).nonzero()[0]) for a, b in zip(tok, ptok) if (a != b).any())
    stats = live_gap_stats(*dl.teacher_forced_gaps(dec_params, cross, dcfg, tok), lens)
    ms, plain_ms = cuda_ms(run, reps=2), cuda_ms(plain, reps=1, warm=False)
    bound_ms, bound_by = bound(*cost(lens))
    log(f"{name} {label}: teacher-forced {stats}; free-running: identical "
        f"rows {share}, rows identical for {DECODE_PREFIX} steps {prefix}, first "
        f"divergence steps {first_div[:40]}; mean length {float(lens.float().mean())}; "
        f"ms={ms} plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by})")
    if stats["max_rel_gap"] > DECODE_GAP_REL:
        fail(f"{name} {label}: a token {stats['max_rel_gap']} below the plain model's maximum "
             f"(bound {DECODE_GAP_REL})")
    return {"max_abs_err": stats["max_gap"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_decode_kernel(params, cfg, results: dict) -> None:
    """Kernel C (bf16 weights, precomputed slabs) against its plain version
    at B=32 and 256, steps=299."""
    import torch

    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.ops import common
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    dcfg = cfg.decoder
    steps = cfg.max_length - 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    d = cfg.encoder.hidden_size
    one, zero = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    for batch in (32, 256):
        enc = torch.randn((batch, cfg.encoder.seq_len, d), generator=gen, device="cuda")
        enc = common.layer_norm(enc, one, zero, 1e-12).to(torch.bfloat16)
        cross = dec.precompute_cross_kv_packed(params["decoder"], enc, dcfg, int8=False)
        results["greedy_decode_loop"] = hold_decode(
            "greedy_decode_loop", f"B={batch}",
            lambda: dl.greedy_decode_loop(params["decoder"], cross, dcfg, steps),
            lambda: dl.greedy_decode_loop_reference(params["decoder"], cross, dcfg, steps),
            params["decoder"], cross, dcfg,
            lambda lens: cost_decode_loop(dcfg, lens, cfg.encoder.seq_len))


def check_decode_forms(raw, cfg, results: dict) -> None:
    """Kernel C's int8_w and fuse_kv forms (and both together) against
    their plain versions at B=256, steps=299: fuse_kv on a raw encoder
    output, scored by the unfused plain decoder over the slabs of its final
    LN (which is what fuse_kv computes), and timed beside
    precompute_cross_kv_packed + the unfused kernel on the same input.
    Then the ablation split: kernel C (bf16, slabs) with each stage skipped,
    every row running all 299 steps (EOS set past the vocab)."""
    import dataclasses

    import torch

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder
    from manga_ocr_tpu_torch.ops import common
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    dcfg, s, d = cfg.decoder, cfg.encoder.seq_len, cfg.encoder.hidden_size
    steps, batch = cfg.max_length - 1, 256
    decs = {"bf16": mdl.cast_params(raw["decoder"], torch.bfloat16),
            "int8_w": _cast_quantized(quantize_decoder(raw["decoder"]), torch.bfloat16)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    enc_raw = (2 * torch.randn((batch, s, d), generator=gen, device="cuda") + 0.5)
    enc_raw = enc_raw.to(torch.bfloat16)
    fln = {"scale": 1 + 0.1 * torch.randn(d, generator=gen, device="cuda"),
           "bias": 0.1 * torch.randn(d, generator=gen, device="cuda")}
    enc = common.layer_norm(enc_raw, fln["scale"], fln["bias"], dcfg.layer_norm_eps)
    fuse = dict(enc_raw=enc_raw, s_valid=s, enc_final_ln=fln)
    for form, p in decs.items():
        cross = dec.precompute_cross_kv_packed(p, enc, dcfg, int8=False)
        int8_w = form == "int8_w"
        if int8_w:
            results["greedy_decode_loop[int8_w]"] = hold_decode(
                "greedy_decode_loop[int8_w]", f"B={batch}",
                lambda: dl.greedy_decode_loop(p, cross, dcfg, steps),
                lambda: dl.greedy_decode_loop_reference(p, cross, dcfg, steps),
                p, cross, dcfg, lambda lens: cost_decode_loop(dcfg, lens, s, int8_w=True))
        rec = hold_decode(
            "greedy_decode_loop[fuse_kv]", f"{form} weights B={batch}",
            lambda: dl.greedy_decode_loop(p, None, dcfg, steps, **fuse),
            lambda: dl.greedy_decode_loop_reference(p, None, dcfg, steps, **fuse),
            p, cross, dcfg, lambda lens: cost_decode_loop(dcfg, lens, s, int8_w, fuse_kv=True))
        unfused_ms = cuda_ms(lambda: dl.greedy_decode_loop(
            p, dec.precompute_cross_kv_packed(
                p, common.layer_norm(enc_raw, fln["scale"], fln["bias"], dcfg.layer_norm_eps),
                dcfg, int8=False),
            dcfg, steps), reps=2)
        log(f"greedy_decode_loop[fuse_kv] {form} weights B={batch}: {rec['ms']} ms against "
            f"final LN + precompute_cross_kv_packed + unfused kernel C {unfused_ms} ms")
        if not int8_w:
            results["greedy_decode_loop[fuse_kv]"] = rec

    # the ablation split of a step (a record, not a check)
    full = dataclasses.replace(dcfg, eos_token_id=dcfg.vocab_size)  # never emitted
    p = decs["bf16"]
    cross = dec.precompute_cross_kv_packed(p, enc, full, int8=False)
    times = {}
    for stage in ("", "self", "cross", "mlp", "head"):
        times[stage or "none"] = cuda_ms(
            lambda: dl.greedy_decode_loop(p, cross, full, steps, ablate=stage), reps=1)
    split = {k: (times["none"] - v) / steps for k, v in times.items() if k != "none"}
    log(f"greedy_decode_loop ablation B={batch} ({steps} steps, every row live): ms with the "
        f"stage skipped {times}; per-step ms of each stage (full - ablated) / steps {split}; "
        f"full per step {times['none'] / steps} on {card_line()}")


def check_page_tokens(engine, crops) -> None:
    """End to end: per bucket of a page, the kernel path's encoder output
    against the plain path's, and the kernel path's tokens scored by the
    plain decoder on the plain encoder output (teacher-forced gaps)."""
    import torch

    from manga_ocr_tpu_torch.parallel import batching
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.ops import decode_loop as dl
    from manga_ocr_tpu_torch.ops import preprocess as pp

    texts_k, texts_p, batches = [], [], batching.prep_page_gray(crops, pp.ORIENT_VERTICAL)
    with torch.inference_mode():
        for b in batches:
            px = pp.model_preprocess(torch.from_numpy(b.crops).cuda(),
                                     torch.from_numpy(b.sizes).cuda(),
                                     engine.cfg.encoder.image_size).to(engine.dtype)
            enc_k = mdl.encode(engine.params, px, engine.cfg, use_kernels=True)
            enc_p = mdl.encode(engine.params, px, engine.cfg, use_kernels=False)
            enc_rel = float((enc_k.float() - enc_p.float()).abs().max() / enc_p.float().abs().max())
            out = mdl.ocr_forward(engine.params, px, engine.cfg, engine.max_length)
            plain = mdl.ocr_forward(engine.params, px, engine.cfg, engine.max_length,
                                    use_kernels=False)
            cross = dec.precompute_cross_kv_packed(engine.params["decoder"], enc_p,
                                                   engine.cfg.decoder, int8=False)
            stats = live_gap_stats(
                *dl.teacher_forced_gaps(engine.params["decoder"], cross, engine.cfg.decoder,
                                        out.tokens[:, : out.lengths.max()].contiguous()),
                out.lengths,
            )
            log(f"bucket {b.bucket_hw} x{b.crops.shape[0]}: encoder max rel err {enc_rel}; "
                f"kernel tokens teacher-forced by the plain path {stats}")
            if enc_rel > ENC_STACK_MAX_REL or stats["max_rel_gap"] > ENGINE_GAP_REL:
                fail(f"bucket {b.bucket_hw}: encoder {enc_rel} / gap {stats['max_rel_gap']} "
                     f"over {ENC_STACK_MAX_REL} / {ENGINE_GAP_REL}")
            for texts, o in ((texts_k, out), (texts_p, plain)):
                texts.append(engine.tokenizer.decode_batch(o.tokens.cpu().numpy()[: b.valid],
                                                           o.lengths.cpu().numpy()[: b.valid]))
    k = batching.scatter_results(batches, texts_k)
    p = batching.scatter_results(batches, texts_p)
    log(f"free-running texts, kernel path vs plain path: {sum(a == b for a, b in zip(k, p))} "
        f"of {len(k)} identical")


def load_crops() -> list:
    import numpy as np
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures", "eval", "*.png")))
    if not paths:
        fail("no crops under tests/fixtures/eval")
    return [np.asarray(Image.open(p).convert("RGB"))[..., ::-1].copy() for p in paths]


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from manga_ocr_tpu_torch.ops.decode_layer import fused_cross_attn_step, fused_self_attn_step
    from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop
    from manga_ocr_tpu_torch.ops.encoder_stack import encoder_stack
    from manga_ocr_tpu_torch.ops.flash_attention import (
        attention_packed,
        fused_attention,
        fused_attn_layer,
        fused_encoder_layer,
    )
    from manga_ocr_tpu_torch.ops.fused_head import fused_greedy_head
    from manga_ocr_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_block_bf16

    return {w.__name__: w for w in (fused_attn_layer, fused_mlp_block, greedy_decode_loop,
                                    fused_mlp_block_bf16, attention_packed, fused_greedy_head,
                                    fused_self_attn_step, fused_cross_attn_step, fused_attention,
                                    fused_encoder_layer, encoder_stack)}


# Launch counts by form (``launches_by_form``), read as "wrapper[form]".
COUNTED_FORMS = {"fused_attn_layer": ("sdpa_int8",), "greedy_decode_loop": ("int8_w", "fuse_kv")}


def counted(fn):
    """Run ``fn`` with every launch count (and the CUDA calls of
    precompute_cross_kv_packed, which C's fuse_kv form must not need) set
    to 0 just before; return its result and the counts read just after,
    the forms of COUNTED_FORMS as "wrapper[form]"."""
    import torch

    from manga_ocr_tpu_torch.models.decoder import precompute_cross_kv_packed

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
        for form in getattr(w, "launches_by_form", {}):
            w.launches_by_form[form] = 0
    precompute_cross_kv_packed.calls = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: w.launches for name, w in wrappers.items()}
    for name, forms in COUNTED_FORMS.items():
        counts.update({f"{name}[{f}]": wrappers[name].launches_by_form[f] for f in forms})
    counts["precompute_cross_kv_packed"] = precompute_cross_kv_packed.calls
    return out, counts


def drive_page(engine, crops, label: str, per_dispatch: dict, results: dict,
               record: dict | None = None) -> list:
    """One ocr_page over the fixture crops: launch counts must be
    ``per_dispatch`` x dispatches (0 for every other kernel), the texts well
    formed and input-dependent.  Each wrapper's count goes to its record in
    ``results`` (under the name ``record`` maps it to, if any)."""
    from manga_ocr_tpu_torch.parallel import batching

    texts, counts = counted(lambda: engine.ocr_page(crops))
    n_dispatch = len(batching.prep_page_gray(crops, 1))
    log(f"{label}: ocr_page over {len(crops)} crops in {n_dispatch} dispatches: "
        f"launches {counts}")
    want = {name: per_dispatch.get(name, 0) * n_dispatch for name in counts}
    if counts != want:
        fail(f"{label}: launch counts {counts}, expected {want}")
    for name in per_dispatch:
        key = (record or {}).get(name, name)
        if key in results:  # None or the slab precompute: no kernel record
            results[key]["launches"] = counts[name]
    if len(texts) != len(crops) or not all(isinstance(t, str) for t in texts):
        fail(f"{label}: ocr_page returned malformed texts")
    if len(set(texts)) < 2:
        fail(f"{label}: every crop decoded to the same text: outputs do not depend on the input")
    log(f"{label} texts: {texts}")
    return texts


def page_rate(engine, crops, label: str) -> float:
    """crops/s of ocr_page on one 256-crop page (the fixtures cycled), after a
    warm page."""
    import torch

    page = [crops[i % len(crops)] for i in range(256)]
    engine.ocr_page(page)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 2
    for _ in range(reps):
        engine.ocr_page(page)
    rate = reps * len(page) / (time.perf_counter() - t0)
    log(f"{label} ocr_page 256 crops: {rate} crops/s on {card_line()}")
    return rate


def stage_split(engine, crops, label: str) -> None:
    """CUDA-event times of the largest dispatch of a 256-crop page, split
    into preprocess, encoder, and cross-K/V + decode (under fuse_cross_kv:
    the encoder without its final LN, then kernel C's fuse_kv form, which
    applies it)."""
    import torch

    from manga_ocr_tpu_torch.models import vit
    from manga_ocr_tpu_torch.parallel import batching
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.ops import decode_loop as dl
    from manga_ocr_tpu_torch.ops import preprocess as pp

    cfg, fuse = engine.cfg, engine.cfg.decoder.fuse_cross_kv

    def decode(enc):
        if fuse:
            return dl.greedy_decode_loop(
                engine.params["decoder"], None, cfg.decoder, engine.max_length - 1,
                enc_raw=enc, s_valid=cfg.encoder.seq_len,
                enc_final_ln=engine.params["encoder"]["final_ln"])[1]
        return mdl.greedy_decode(engine.params, enc, cfg, engine.max_length).lengths

    page = [crops[i % len(crops)] for i in range(256)]
    b = max(batching.prep_page_gray(page, pp.ORIENT_VERTICAL), key=lambda b: b.crops.shape[0])
    crops_d = torch.from_numpy(b.crops).cuda()
    sizes = torch.from_numpy(b.sizes).cuda()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        for _ in range(2):  # the second run is timed
            ev[0].record()
            px = pp.model_preprocess(crops_d, sizes, engine.cfg.encoder.image_size).to(engine.dtype)
            ev[1].record()
            enc = vit.encode(engine.params["encoder"], px, cfg.encoder, raw_padded=fuse)
            ev[2].record()
            lengths = decode(enc)
            ev[3].record()
            torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    log(f"{label} dispatch B={b.crops.shape[0]} ({b.valid} crops, bucket {b.bucket_hw}): "
        f"preprocess {ms[0]} ms, encoder {ms[1]} ms, "
        f"{'C fuse_kv (final LN, cross-K/V, decode)' if fuse else 'cross-K/V + decode'} "
        f"{ms[2]} ms (mean length {float(lengths.float().mean())})")


def check_server(engine, crops) -> None:
    from PIL import Image

    from manga_ocr_tpu_torch import serve as srv

    httpd = srv.serve(engine, port=0)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        log(f"/healthz: {health}")
        if health.get("status") != "ok" or health.get("device_count", 0) < 1:
            fail(f"/healthz: {health}")
        pngs = []
        for c in crops[:5]:
            buf = io.BytesIO()
            Image.fromarray(c[..., ::-1]).save(buf, format="PNG")
            pngs.append(buf.getvalue())
        single = []
        for data in pngs[:3]:
            req = urllib.request.Request(f"{url}/ocr", data=data, method="POST")
            with urllib.request.urlopen(req, timeout=600) as resp:
                single.append(json.loads(resp.read())["text"])
        body = json.dumps({"images": [base64.b64encode(p).decode() for p in pngs]}).encode()
        req = urllib.request.Request(f"{url}/ocr_batch", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            batch = json.loads(resp.read())["texts"]
    finally:
        httpd.shutdown()
        httpd.service.close()
    direct = engine.ocr_page(crops[:5])
    log(f"server /ocr {single} /ocr_batch {batch}")
    if single != direct[:3] or batch != direct:
        fail(f"server texts differ from the engine's: {single} {batch} vs {direct}")


def step_gaps(params, enc, cfg, tokens, lengths) -> dict:
    """Teacher forcing for the step-by-step decode: the plain step decode
    (every kernel's plain version, logits from the reference head) fed the
    kernel run's tokens; at each emitted position, its top logit minus its
    logit for the kernel's token."""
    import torch

    from manga_ocr_tpu_torch.models import decoder as dec

    dcfg = cfg.decoder
    b, steps = tokens.shape[0], tokens.shape[1] - 1
    prepared = None
    if dcfg.step_kernel == "fused_layer":
        cross = dec.precompute_cross_kv_packed(params["decoder"], enc, dcfg)
        prepared = dec.prepare_fused_layer(params["decoder"], dcfg, enc.dtype)
    else:
        cross = dec.precompute_cross_kv(params["decoder"], enc, dcfg)
    cache = dec.init_cache(dcfg, b, steps + 1, enc.dtype, enc.device)
    gaps = torch.zeros((b, steps), device=enc.device)
    top = torch.ones_like(gaps)
    n = int(lengths.max()) - 1
    for t in range(n):
        lg, cache = dec.decode_step(params["decoder"], tokens[:, t], t, cache, cross, dcfg,
                                    use_kernels=False, prepared=prepared)
        top[:, t] = lg.amax(-1)
        gaps[:, t] = top[:, t] - lg.gather(1, tokens[:, t + 1].long()[:, None])[:, 0]
    return live_gap_stats(gaps, top, lengths)


def run_step_decode(engine, crops, results: dict) -> None:
    """Path 2: the step-by-step greedy decode with kernels F (head) and D
    (step MLP, pre_ln=False) at full width, B=32, max length 101, on the
    unquantized engine's params and encoder output for 32 fixture crops."""
    import dataclasses

    import torch

    from manga_ocr_tpu_torch.parallel import batching
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.ops import preprocess as pp

    cfg = engine.cfg
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, step_kernel="xla", head_kernel="fused", step_mlp_kernel="fused",
        cross_kv_int8=True, head_phased=False,
    ))
    # 100 steps (cut from 299 to keep the script's run time down: every step
    # launches the same kernels on the same shapes)
    chunk, max_len = 8, STEP_DECODE_LEN
    page = [crops[i % len(crops)] for i in range(32)]
    with torch.inference_mode():
        px = torch.cat([
            pp.model_preprocess(torch.from_numpy(b.crops).cuda(), torch.from_numpy(b.sizes).cuda(),
                                cfg.encoder.image_size)[: b.valid]
            for b in batching.prep_page_gray(page, pp.ORIENT_VERTICAL)
        ]).to(engine.dtype)
        enc = mdl.encode(engine.params, px, cfg)
        t0 = time.perf_counter()
        out, counts = counted(lambda: mdl.greedy_decode(engine.params, enc, cfg, max_len, chunk))
        secs = time.perf_counter() - t0
        tok, lens = out.tokens, out.lengths
        if tok.shape != (32, max_len) or int(tok[:, 0].ne(cfg.decoder.bos_token_id).sum()):
            fail("step decode: bad token matrix")
        # steps the loop ran: whole chunks until every row has emitted EOS
        n_chunks = -(-(max_len - 1) // chunk)
        eos = tok[:, 1:] == cfg.decoder.eos_token_id
        if bool(eos.any(1).all()):
            last = int(eos.float().argmax(1).max())
            n_chunks = min(n_chunks, last // chunk + 1)
        steps = n_chunks * chunk
        layers = cfg.decoder.num_layers
        log(f"step decode B=32: {steps} steps in {secs:.3f} s, launches {counts}, mean length "
            f"{float(lens.float().mean())}")
        want = {name: 0 for name in counts}
        want.update(fused_greedy_head=steps, fused_mlp_block_bf16=layers * steps)
        if counts != want:
            fail(f"step decode: launch counts {counts}, expected {want}")
        results["fused_greedy_head"]["launches"] = counts["fused_greedy_head"]
        stats = step_gaps(engine.params, enc, cfg, tok, lens)
        plain = mdl.greedy_decode(engine.params, enc, cfg, max_len, chunk, use_kernels=False)
        same = float(((plain.tokens == tok).all(1) & (plain.lengths == lens)).float().mean())
        log(f"step decode B=32: kernel tokens teacher-forced by the plain step decode {stats}; "
            f"free-running rows identical to the plain decode {same}")
        if stats["max_rel_gap"] > ENGINE_GAP_REL:
            fail(f"step decode: a token {stats['max_rel_gap']} below the plain model's maximum "
                 f"(bound {ENGINE_GAP_REL})")


def run_fused_layer_slice(params, crops, results: dict) -> None:
    """Path 4: the fused whole-layer step decode at full width, through
    ``ocr_forward`` on 32 fixture crops, 299 steps in chunks of 8:
    MangaOCRConfig.serving() with step_kernel "fused_layer" and head_kernel
    "fused", the encoder from quantize_encoder(quantize_attn_proj=True) and
    the decoder from quantize_decoder, cast to bf16 (int8 weights and f32
    scales kept).  Launch counts exact (A and B per encoder layer; per step
    J, K and B per decoder layer and F); the tokens scored by the plain
    fused_layer step decode on the plain encoder output; then the cross-K/V
    + decode time at batch 32 and 256 beside kernel C's on the same encoder
    output (a record, not a check)."""
    import dataclasses

    import torch

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized, _params_to
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder, quantize_encoder
    from manga_ocr_tpu_torch.ops import preprocess as pp
    from manga_ocr_tpu_torch.parallel import batching

    serving = MangaOCRConfig.serving()
    cfg = dataclasses.replace(serving, decoder=dataclasses.replace(
        serving.decoder, step_kernel="fused_layer", head_kernel="fused"))
    raw = _params_to(params, "cuda")
    qparams = {
        "encoder": _cast_quantized(quantize_encoder(raw["encoder"], quantize_attn_proj=True),
                                   torch.bfloat16),
        "decoder": _cast_quantized(quantize_decoder(raw["decoder"]), torch.bfloat16),
    }
    chunk, max_len = 8, cfg.max_length
    page = [crops[i % len(crops)] for i in range(32)]
    with torch.inference_mode():
        px = torch.cat([
            pp.model_preprocess(torch.from_numpy(b.crops).cuda(), torch.from_numpy(b.sizes).cuda(),
                                cfg.encoder.image_size)[: b.valid]
            for b in batching.prep_page_gray(page, pp.ORIENT_VERTICAL)
        ]).to(torch.bfloat16)
        t0 = time.perf_counter()
        out, counts = counted(lambda: mdl.ocr_forward(qparams, px, cfg, max_len, chunk))
        secs = time.perf_counter() - t0
        tok, lens = out.tokens, out.lengths
        if tok.shape != (32, max_len) or int(tok[:, 0].ne(cfg.decoder.bos_token_id).sum()):
            fail("fused_layer slice: bad token matrix")
        n_chunks = -(-(max_len - 1) // chunk)
        eos = tok[:, 1:] == cfg.decoder.eos_token_id
        if bool(eos.any(1).all()):
            n_chunks = min(n_chunks, int(eos.float().argmax(1).max()) // chunk + 1)
        steps = n_chunks * chunk
        n_enc, n_dec = cfg.encoder.num_layers, cfg.decoder.num_layers
        log(f"fused_layer slice B=32: ocr_forward with {steps} decode steps in {secs:.3f} s, "
            f"launches {counts}, mean length {float(lens.float().mean())}")
        want = {name: 0 for name in counts}
        want.update(fused_attn_layer=n_enc, fused_mlp_block=n_enc + n_dec * steps,
                    fused_self_attn_step=n_dec * steps, fused_cross_attn_step=n_dec * steps,
                    fused_greedy_head=steps, precompute_cross_kv_packed=1)
        if counts != want:
            fail(f"fused_layer slice: launch counts {counts}, expected {want}")
        for name in ("fused_self_attn_step", "fused_cross_attn_step"):
            results[name]["launches"] = counts[name]
        results["fused_mlp_block[step]"]["launches"] = counts["fused_mlp_block"] - n_enc

        enc_k = mdl.encode(qparams, px, cfg)
        enc_p = mdl.encode(qparams, px, cfg, use_kernels=False)
        enc_rel = float((enc_k.float() - enc_p.float()).abs().max() / enc_p.float().abs().max())
        stats = step_gaps(qparams, enc_p, cfg, tok, lens)
        log(f"fused_layer slice B=32: encoder max rel err {enc_rel}; kernel tokens "
            f"teacher-forced by the plain fused_layer step decode on the plain encoder "
            f"output {stats}")
        if enc_rel > ENC_STACK_MAX_REL or stats["max_rel_gap"] > ENGINE_GAP_REL:
            fail(f"fused_layer slice: encoder {enc_rel} / gap {stats['max_rel_gap']} over "
                 f"{ENC_STACK_MAX_REL} / {ENGINE_GAP_REL}")

        c_params = {"encoder": qparams["encoder"],
                    "decoder": mdl.cast_params(raw["decoder"], torch.bfloat16)}
        for batch in (32, 256):
            enc_b = enc_k.repeat(batch // 32, 1, 1)
            times = {}
            for label, p, c in (("fused_layer", qparams, cfg), ("kernel C", c_params, serving)):
                mdl.greedy_decode(p, enc_b, c, max_len, chunk)  # warm
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                res = mdl.greedy_decode(p, enc_b, c, max_len, chunk)
                ev[1].record()
                torch.cuda.synchronize()
                times[label] = (ev[0].elapsed_time(ev[1]), float(res.lengths.float().mean()))
            log(f"cross-K/V + decode B={batch} (ms, mean length): fused_layer "
                f"{times['fused_layer']}, kernel C {times['kernel C']} on {card_line()}")


def check_encoder_variants(raw, results: dict) -> None:
    """A's bf16 form, G, H (int8, bf16) and I (int8, bf16; lpc 12 and 5)
    against their plain versions at B=256, full width.  The int8 forms take
    the serving GELU (sigmoid), the bf16 forms the exact one (erf), as the
    serving configurations pair them.  I is held to the per-kernel bounds
    on its first one and two layers, and to the twelve-layer bounds on the
    whole stack: the layers compound the per-layer differences."""
    import torch
    import torch.nn.functional as F

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import layer_params
    from manga_ocr_tpu_torch.models.quantize import quantize_encoder
    from manga_ocr_tpu_torch.ops import encoder_stack as es
    from manga_ocr_tpu_torch.ops import flash_attention as fa
    from manga_ocr_tpu_torch.ops.encoder_weights import layer_view, prepare_layers

    ecfg = MangaOCRConfig.base().encoder
    b, s, d, heads, dh = 256, ecfg.seq_len, ecfg.hidden_size, ecfg.num_heads, ecfg.head_dim
    inter, eps, n_l = ecfg.intermediate_size, ecfg.layer_norm_eps, ecfg.num_layers
    forms = {
        "int8": (_cast_quantized(quantize_encoder(raw["encoder"], quantize_attn_proj=True),
                                 torch.bfloat16)["layers"], "sigmoid"),
        "bf16": (mdl.cast_params(raw["encoder"], torch.bfloat16)["layers"], "erf"),
    }
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    x = randn(b, s, d)
    layers, _ = forms["bf16"]
    lp, lw = layer_params(layers, 0), layer_view(prepare_layers(layers, torch.bfloat16), 0)
    ln1 = (lp["ln1"]["scale"], lp["ln1"]["bias"])
    results["fused_attn_layer[bf16]"] = hold(
        "fused_attn_layer[bf16]", f"B={b}",
        lambda: fa.fused_attn_layer(x, lp["attn"], *ln1, heads, eps, valid_len=s,
                                    prepared=(lw.qkv, lw.o)),
        lambda: fa.fused_attn_layer_reference(x, lp["attn"], *ln1, heads, eps, valid_len=s),
        cost_attn_layer_bf16(b, s, d))

    q, k, v = randn(b, heads, s, dh), randn(b, heads, s, dh), randn(b, heads, s, dh)
    results["fused_attention"] = hold(
        "fused_attention", f"B={b}", lambda: fa.fused_attention(q, k, v),
        lambda: fa.fused_attention_reference(q, k, v), cost_attention_packed(b, s, d),
        library=lambda: F.scaled_dot_product_attention(q, k, v))
    del q, k, v

    for form, (layers, gelu) in forms.items():
        lp = layer_params(layers, 0)
        lw = layer_view(prepare_layers(layers, torch.bfloat16), 0)
        scratch = launch.encoder_scratch(b * s, d, inter, form == "int8", "cuda")
        lib_h = lib_i = None
        if form == "bf16":  # erf GELU: TransformerEncoder's "gelu"
            lib_h, lib_i = (library_encoder(layers, n, heads, eps, x) for n in (1, n_l))
        results[f"fused_encoder_layer[{form}]"] = hold(
            f"fused_encoder_layer[{form}]", f"gelu={gelu} B={b}",
            lambda: fa.fused_encoder_layer(x, lp, heads, eps, gelu, lw, scratch),
            lambda: fa.fused_encoder_layer_reference(x, lp, heads, eps, gelu),
            cost_layers(b, s, d, inter, form == "int8"), library=lib_h)
        del scratch
        # I's own entry at the per-kernel bounds: one layer, and two layers
        # as two calls (per-call weight offsets) and as one (per-layer
        # offsets inside the slab)
        for n, lpc in ((1, 1), (2, 1), (2, 2)):
            head = first_layers(layers, n)
            hold(f"encoder_stack[{form}]", f"{n} layer(s) lpc={lpc} gelu={gelu} B={b}",
                 lambda: es.encoder_stack(x, head, heads, eps, lpc, gelu),
                 lambda: es.encoder_stack_reference(x, head, heads, eps, lpc, gelu),
                 cost_layers(b, s, d, inter, form == "int8", n))
        for lpc in (12, 5):
            rec = hold(
                f"encoder_stack[{form}]", f"lpc={lpc} gelu={gelu} B={b}",
                lambda: es.encoder_stack(x, layers, heads, eps, lpc, gelu),
                lambda: es.encoder_stack_reference(x, layers, heads, eps, lpc, gelu),
                cost_layers(b, s, d, inter, form == "int8", n_l),
                library=lib_i, tolerance=(ENC_STACK_MAX_REL, ENC_STACK_MEAN_REL))
            if lpc == 12:
                results[f"encoder_stack[{form}]"] = rec
        del lib_h, lib_i
        torch.cuda.empty_cache()


def first_layers(layers: dict, n: int) -> dict:
    """The first ``n`` layers of a stacked [L, ...] tree (views)."""
    return {k: first_layers(v, n) if isinstance(v, dict) else v[:n] for k, v in layers.items()}


def library_encoder(layers: dict, n: int, heads: int, eps: float, x):
    """The library yardstick of H's and I's bf16 form (erf GELU): the first
    ``n`` layers of the bf16 tree loaded into torch.nn.TransformerEncoder
    (pre-LN, exact GELU, eval mode, no grad: PyTorch's fused encoder-layer
    op), as one call on ``x``.  It is checked to compute the plain
    version's function and then only timed; the port never calls it."""
    import torch

    from manga_ocr_tpu_torch.ops import encoder_stack as es

    enc = torch_encoder(layers, n, heads, eps, x.device, x.dtype)
    with torch.inference_mode():
        got = enc(x)
        want = es.encoder_stack_reference(x, first_layers(layers, n), heads, eps, n, "erf")
    step = (want.float() - x.float()).abs().max()
    rel = float(((got.float() - want.float()).abs().max() / step))
    log(f"library TransformerEncoder ({n} layer(s)): max_abs_err against the plain version "
        f"{float((got.float() - want.float()).abs().max())}, {rel} of the largest change of x")
    if not rel <= LIBRARY_SAME_REL:
        fail(f"the TransformerEncoder yardstick of {n} layer(s) computes another function "
             f"({rel} of the largest change of x)")
    del got, want

    def run():
        with torch.inference_mode():
            return enc(x)
    return run


def torch_encoder(layers: dict, n: int, heads: int, eps: float, device, dtype):
    """torch.nn.TransformerEncoder holding the first ``n`` layers of a float
    stacked tree: pre-LN, exact GELU, eval mode, no grad."""
    import torch

    from manga_ocr_tpu_torch.models.params import layer_params

    d, inter = layers["mlp"]["fc1"]["kernel"].shape[-2:]
    layer = torch.nn.TransformerEncoderLayer(
        d, heads, inter, dropout=0.0, activation="gelu", layer_norm_eps=eps, batch_first=True,
        norm_first=True, device=device, dtype=dtype)
    enc = torch.nn.TransformerEncoder(layer, n, enable_nested_tensor=False)
    with torch.no_grad():
        for l, mod in enumerate(enc.layers):
            p = layer_params(layers, l)
            a, m = p["attn"], p["mlp"]
            mod.self_attn.in_proj_weight.copy_(torch.cat([a[k]["kernel"].T for k in "qkv"]))
            mod.self_attn.in_proj_bias.copy_(torch.cat([a[k]["bias"] for k in "qkv"]))
            for dst, src in ((mod.self_attn.out_proj, a["o"]), (mod.linear1, m["fc1"]),
                             (mod.linear2, m["fc2"])):
                dst.weight.copy_(src["kernel"].T)
                dst.bias.copy_(src["bias"])
            for dst, src in ((mod.norm1, p["ln1"]), (mod.norm2, p["ln2"])):
                dst.weight.copy_(src["scale"])
                dst.bias.copy_(src["bias"])
    return enc.eval().requires_grad_(False)


def stack_floor() -> None:
    """``--stack-floor``: what the plain 12-layer stack itself does with
    last-bit differences, at B=256 on the smoke test's weights, for both
    forms: its output on x against its output on x with 1% of the elements
    moved by one bf16 ulp, and against twelve plain H blocks (the same
    math, the softmax multiplying by the reciprocal of its sum).  Plain
    versions only; no kernel is built."""
    import torch

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params, layer_params
    from manga_ocr_tpu_torch.models.quantize import quantize_encoder
    from manga_ocr_tpu_torch.ops import encoder_stack as es
    from manga_ocr_tpu_torch.ops import flash_attention as fa

    cfg = MangaOCRConfig.base()
    ecfg = cfg.encoder
    raw = init_params(cfg, SEED, "cuda", std=WEIGHT_STD)
    forms = {
        "int8": (_cast_quantized(quantize_encoder(raw["encoder"], quantize_attn_proj=True),
                                 torch.bfloat16)["layers"], "sigmoid"),
        "bf16": (mdl.cast_params(raw["encoder"], torch.bfloat16)["layers"], "erf"),
    }
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn((256, ecfg.seq_len, ecfg.hidden_size), generator=gen,
                    device="cuda").to(torch.bfloat16)
    heads, eps = ecfg.num_heads, ecfg.layer_norm_eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    moved = x.clone().view(-1)
    idx = torch.randint(0, moved.numel(), (moved.numel() // 100,), generator=gen, device="cuda")
    moved[idx] = (moved[idx].float() * (1 + 2.0**-8)).to(torch.bfloat16)
    for form, (layers, gelu) in forms.items():
        want = es.encoder_stack_reference(x, layers, heads, eps, 12, gelu)
        top = float(want.float().abs().max())
        h = x
        for l in range(layers["ln1"]["scale"].shape[0]):
            h = fa.fused_encoder_layer_reference(h, layer_params(layers, l), heads, eps, gelu)
        for label, other in (("one-ulp input change", moved.view_as(x)),
                             ("reciprocal softmax", None)):
            got = h if other is None else es.encoder_stack_reference(other, layers, heads, eps,
                                                                     12, gelu)
            err = (got.float() - want.float()).abs()
            log(f"encoder_stack[{form}] plain-version floor, {label}: max_abs={float(err.max())} "
                f"mean_abs={float(err.mean())} max_abs_out={top} (mean/top "
                f"{float(err.mean()) / top})")


def run_encoder_configs(params, crops, results: dict) -> None:
    """Each encoder configuration of this slice at full width on 32 fixture
    crops, with kernel C as the decode (max length 300): through
    ocr_forward, or for G through encode(fused_attention=True) and
    greedy_decode (the JAX package reaches G only through encode).  Launch
    counts exact; the encoder output against the plain encoder's; the
    tokens scored by the plain decode on the plain encoder output (teacher
    forcing)."""
    import dataclasses

    import torch

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized, _params_to
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models import vit
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.quantize import quantize_encoder
    from manga_ocr_tpu_torch.ops import decode_loop as dl
    from manga_ocr_tpu_torch.ops import preprocess as pp
    from manga_ocr_tpu_torch.parallel import batching

    raw = _params_to(params, "cuda")
    bf16 = mdl.cast_params(raw, torch.bfloat16)

    def quantized(attn_proj):
        return {"encoder": _cast_quantized(quantize_encoder(raw["encoder"], attn_proj),
                                           torch.bfloat16), "decoder": bf16["decoder"]}

    def enc(cfg, **kw):
        return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, **kw))

    serving, serving_bf16 = MangaOCRConfig.serving(), MangaOCRConfig.serving(quantized=False)
    n_l = serving.encoder.num_layers
    q8 = quantized(True)
    # label: (config, params, fused_attention, expected launches, results record)
    runs = {
        "serving() on bf16 params": (serving, bf16, None, {"fused_attn_layer": n_l,
                                     "fused_mlp_block_bf16": n_l}, "fused_attn_layer[bf16]"),
        "fused_layer on MLP-only int8 params": (serving, quantized(False), None, {
            "fused_attn_layer": n_l, "fused_mlp_block": n_l}, None),
        "merged_layer int8": (enc(serving, attn_kernel="merged_layer"), q8, None,
                              {"fused_encoder_layer": n_l}, "fused_encoder_layer[int8]"),
        "merged_layer bf16": (enc(serving_bf16, attn_kernel="merged_layer"), bf16, None,
                              {"fused_encoder_layer": n_l}, "fused_encoder_layer[bf16]"),
        "stacked int8 lpc=12": (enc(serving, attn_kernel="stacked"), q8, None,
                                {"encoder_stack": 1}, "encoder_stack[int8]"),
        "stacked int8 lpc=5": (enc(serving, attn_kernel="stacked", stack_lpc=5), q8, None,
                               {"encoder_stack": 3}, None),
        "stacked bf16 lpc=12": (enc(serving_bf16, attn_kernel="stacked"), bf16, None,
                                {"encoder_stack": 1}, "encoder_stack[bf16]"),
        "stacked bf16 lpc=5": (enc(serving_bf16, attn_kernel="stacked", stack_lpc=5), bf16, None,
                               {"encoder_stack": 3}, None),
        "encode(fused_attention=True)": (enc(serving_bf16, attn_kernel="xla"), bf16, True,
                                         {"fused_attention": n_l, "fused_mlp_block_bf16": n_l},
                                         "fused_attention"),
    }
    page = [crops[i % len(crops)] for i in range(32)]
    with torch.inference_mode():
        px = torch.cat([
            pp.model_preprocess(torch.from_numpy(b.crops).cuda(), torch.from_numpy(b.sizes).cuda(),
                                serving.encoder.image_size)[: b.valid]
            for b in batching.prep_page_gray(page, pp.ORIENT_VERTICAL)
        ]).to(torch.bfloat16)
        for label, (cfg, p, fused, per_run, record) in runs.items():
            def forward(use_kernels=True):
                if fused:
                    e = vit.encode(p["encoder"], px, cfg.encoder, use_kernels=use_kernels,
                                   fused_attention=True)
                    return mdl.greedy_decode(p, e, cfg, use_kernels=use_kernels)
                return mdl.ocr_forward(p, px, cfg, use_kernels=use_kernels)

            forward()  # warm: weight preparation, allocator growth
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, counts = counted(forward)
            secs = time.perf_counter() - t0
            want = {name: 0 for name in counts}
            want.update(per_run, greedy_decode_loop=1, precompute_cross_kv_packed=1)
            if counts != want:
                fail(f"{label}: launch counts {counts}, expected {want}")
            if record is not None:
                name = next(n for n in per_run if record.startswith(n))
                results[record]["launches"] = counts[name]
            if out.tokens.shape != (32, cfg.max_length) or \
                    int(out.tokens[:, 0].ne(cfg.decoder.bos_token_id).sum()):
                fail(f"{label}: bad token matrix")
            enc_k = vit.encode(p["encoder"], px, cfg.encoder, fused_attention=fused)
            enc_p = vit.encode(p["encoder"], px, cfg.encoder, use_kernels=False,
                               fused_attention=fused)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            vit.encode(p["encoder"], px, cfg.encoder, fused_attention=fused)
            ev[1].record()
            torch.cuda.synchronize()
            enc_rel = float((enc_k.float() - enc_p.float()).abs().max()
                            / enc_p.float().abs().max())
            cross = dec.precompute_cross_kv_packed(p["decoder"], enc_p, cfg.decoder, int8=False)
            stats = live_gap_stats(
                *dl.teacher_forced_gaps(p["decoder"], cross, cfg.decoder,
                                        out.tokens[:, : out.lengths.max()].contiguous()),
                out.lengths)
            log(f"{label} B=32: ocr_forward {secs:.3f} s (encoder {ev[0].elapsed_time(ev[1])} "
                f"ms), launches {counts}; encoder max rel err {enc_rel}; kernel tokens "
                f"teacher-forced by the plain path {stats}")
            if enc_rel > ENC_STACK_MAX_REL or stats["max_rel_gap"] > ENGINE_GAP_REL:
                fail(f"{label}: encoder {enc_rel} / gap {stats['max_rel_gap']} over "
                     f"{ENC_STACK_MAX_REL} / {ENGINE_GAP_REL}")


def run_merged_layer_engine(params, crops, results: dict) -> None:
    """One page through the engine with serving_kernels=False (cfg as
    given) on a merged_layer bf16 encoder and the whole-loop decode: H once
    per layer, C once per dispatch."""
    import dataclasses

    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    cfg = MangaOCRConfig.serving(quantized=False)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder,
                                                               attn_kernel="merged_layer"))
    engine = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), device="cuda",
                                 serving_kernels=False)
    engine.ocr_page(crops[:2])
    drive_page(engine, crops, "merged_layer engine",
               {"fused_encoder_layer": cfg.encoder.num_layers, "greedy_decode_loop": 1,
                "precompute_cross_kv_packed": 1}, results,
               record={"fused_encoder_layer": "fused_encoder_layer[bf16]"})


def run_slice_engine(params, crops, results: dict) -> float:
    """Path 1 of this slice: the int8 serving engine with kernel A's int8
    SDPA (attn_sdpa_int8) and kernel C's fuse_kv form (fuse_cross_kv), on
    the fixture page.  Per dispatch exactly: A 12 (all in the sdpa_int8
    form), B 12, C 1 (in the fuse_kv form), and no slab precompute; the
    tokens scored by teacher forcing; crops/s on the 256-crop page."""
    import dataclasses

    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    cfg = MangaOCRConfig.base()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, attn_sdpa_int8=True),
                              decoder=dataclasses.replace(cfg.decoder, fuse_cross_kv=True))
    engine = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), device="cuda")
    engine.ocr_page(crops[:2])
    label = "int8 engine, sdpa_int8 + fuse_kv"
    n_l = cfg.encoder.num_layers
    drive_page(engine, crops, label,
               {"fused_attn_layer": n_l, "fused_attn_layer[sdpa_int8]": n_l,
                "fused_mlp_block": n_l, "greedy_decode_loop": 1, "greedy_decode_loop[fuse_kv]": 1},
               results, record={"fused_attn_layer": None, "fused_mlp_block": None,
                                "greedy_decode_loop": None})
    check_page_tokens(engine, crops)
    rate = page_rate(engine, crops, label)
    stage_split(engine, crops, label)
    return rate


def run_int8_decoder_forward(params, crops, results: dict) -> None:
    """Path 2 of this slice: ocr_forward on 32 fixture crops under
    MangaOCRConfig.serving() on quantize_encoder(quantize_attn_proj=True) +
    quantize_decoder params (cast to bf16, int8 weights and f32 scales
    kept): kernel C in its int8_w form, once over precomputed slabs and
    once with fuse_cross_kv (int8_w + fuse_kv).  Launch counts exact; the
    tokens scored by the plain int8 decoder on the plain encoder output."""
    import dataclasses

    import torch

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized, _params_to
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder, quantize_encoder
    from manga_ocr_tpu_torch.ops import decode_loop as dl
    from manga_ocr_tpu_torch.ops import preprocess as pp
    from manga_ocr_tpu_torch.parallel import batching

    raw = _params_to(params, "cuda")
    qparams = {
        "encoder": _cast_quantized(quantize_encoder(raw["encoder"], quantize_attn_proj=True),
                                   torch.bfloat16),
        "decoder": _cast_quantized(quantize_decoder(raw["decoder"]), torch.bfloat16),
    }
    serving = MangaOCRConfig.serving()
    page = [crops[i % len(crops)] for i in range(32)]
    int8_w_launches = 0
    with torch.inference_mode():
        px = torch.cat([
            pp.model_preprocess(torch.from_numpy(b.crops).cuda(), torch.from_numpy(b.sizes).cuda(),
                                serving.encoder.image_size)[: b.valid]
            for b in batching.prep_page_gray(page, pp.ORIENT_VERTICAL)
        ]).to(torch.bfloat16)
        enc_p = mdl.encode(qparams, px, serving, use_kernels=False)
        cross = dec.precompute_cross_kv_packed(qparams["decoder"], enc_p, serving.decoder, int8=False)
        for fuse in (False, True):
            cfg = dataclasses.replace(serving, decoder=dataclasses.replace(
                serving.decoder, fuse_cross_kv=fuse))
            label = f"ocr_forward int8 decoder{' + fuse_cross_kv' if fuse else ''} B=32"
            mdl.ocr_forward(qparams, px, cfg)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, counts = counted(lambda: mdl.ocr_forward(qparams, px, cfg))
            secs = time.perf_counter() - t0
            n_l = cfg.encoder.num_layers
            want = {name: 0 for name in counts}
            want.update({"fused_attn_layer": n_l, "fused_mlp_block": n_l, "greedy_decode_loop": 1,
                         "greedy_decode_loop[int8_w]": 1, "greedy_decode_loop[fuse_kv]": int(fuse),
                         "precompute_cross_kv_packed": int(not fuse)})
            if counts != want:
                fail(f"{label}: launch counts {counts}, expected {want}")
            int8_w_launches += counts["greedy_decode_loop[int8_w]"]
            if out.tokens.shape != (32, cfg.max_length) or \
                    int(out.tokens[:, 0].ne(cfg.decoder.bos_token_id).sum()):
                fail(f"{label}: bad token matrix")
            stats = live_gap_stats(
                *dl.teacher_forced_gaps(qparams["decoder"], cross, cfg.decoder,
                                        out.tokens[:, : out.lengths.max()].contiguous()),
                out.lengths)
            log(f"{label}: {secs:.3f} s, launches {counts}; kernel tokens teacher-forced by the "
                f"plain int8 decoder on the plain encoder output {stats}")
            if stats["max_rel_gap"] > ENGINE_GAP_REL:
                fail(f"{label}: gap {stats['max_rel_gap']} over {ENGINE_GAP_REL}")
    results["greedy_decode_loop[int8_w]"]["launches"] = int8_w_launches


def run_reference_engine(params, crops) -> None:
    """The exact reference path (serving_kernels=False) on the card: one
    page, well-formed texts, and no kernel launched."""
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine

    engine = TorchMangaOcrEngine(params, MangaOCRConfig.base(), CharTokenizer.synthetic(),
                                 device="cuda", serving_kernels=False)
    t0 = time.perf_counter()
    texts, counts = counted(lambda: engine.ocr_page(crops))
    log(f"reference path: ocr_page over {len(crops)} crops in {time.perf_counter() - t0:.2f} s, "
        f"launches {counts}; texts {texts}")
    if any(counts.values()):
        fail(f"reference path launched kernels: {counts}")
    if len(texts) != len(crops) or not all(isinstance(t, str) for t in texts):
        fail("reference path: ocr_page returned malformed texts")
    if len(set(texts)) < 2:
        fail("reference path: every crop decoded to the same text")


def phase(label: str) -> None:
    """The seconds since the last phase mark (where the run's time goes)."""
    now = time.time()
    log(f"phase {label}: {now - phase.t:.1f} s")
    phase.t = now


phase.t = T0


def run_engines(results: dict) -> dict:
    import torch

    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    cfg = MangaOCRConfig.base()
    crops = load_crops()
    params = init_params(cfg, SEED, "cpu", std=WEIGHT_STD)
    rates = {}

    # -- int8 serving: kernels A, B, C; the HTTP server ------------------------
    t0 = time.time()
    engine = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), device="cuda")
    log(f"int8 engine built in {time.time() - t0:.1f} s")
    engine.ocr_page(crops[:2])  # first call: library load, allocator growth
    drive_page(engine, crops, "int8 engine",
               {"fused_attn_layer": 12, "fused_mlp_block": 12, "greedy_decode_loop": 1,
                "precompute_cross_kv_packed": 1}, results)
    check_page_tokens(engine, crops)
    rates["int8"] = page_rate(engine, crops, "int8 engine")
    stage_split(engine, crops, "int8 engine")
    check_server(engine, crops)
    del engine
    phase("int8 engine")

    # -- unquantized serving: kernels E, D, C -----------------------------------
    engine = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), device="cuda",
                                 quantize_int8=False)
    engine.ocr_page(crops[:2])
    drive_page(engine, crops, "bf16 engine",
               {"attention_packed": 12, "fused_mlp_block_bf16": 12, "greedy_decode_loop": 1,
                "precompute_cross_kv_packed": 1}, results)
    check_page_tokens(engine, crops)
    rates["bf16"] = page_rate(engine, crops, "bf16 engine")
    stage_split(engine, crops, "bf16 engine")

    phase("bf16 engine")
    # -- the step-by-step decode: kernels F, D ------------------------------------
    run_step_decode(engine, crops, results)
    del engine
    phase("step decode")

    # -- the exact reference path: no kernel --------------------------------------
    run_reference_engine(params, crops)
    phase("reference path")

    # -- the fused whole-layer step decode: kernels A, B, J, K, F -----------------
    torch.cuda.empty_cache()
    run_fused_layer_slice(params, crops, results)
    phase("fused_layer decode")

    # -- the encoder variants: A's bf16 form, G, H, I; with C ------------------
    torch.cuda.empty_cache()
    run_encoder_configs(params, crops, results)
    run_merged_layer_engine(params, crops, results)
    phase("encoder variants")

    # -- this slice: A sdpa_int8 + C fuse_kv (engine); C int8_w (ocr_forward) --
    torch.cuda.empty_cache()
    rates["int8 sdpa_int8+fuse_kv"] = run_slice_engine(params, crops, results)
    phase("sdpa_int8 + fuse_kv engine")
    run_int8_decoder_forward(params, crops, results)
    phase("int8 decoder ocr_forward")
    return rates


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import torch

        import manga_ocr_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    if sys.argv[1:] == ["--stack-floor"]:
        stack_floor()
        return 0
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}; usage: chip_smoke.py [--stack-floor]")

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.kernels import build
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig, with_serving_kernels
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder, quantize_encoder

    t0 = time.time()
    build.load(verbose=True)
    log(f"kernels built in {time.time() - t0:.1f} s")
    log_ptxas(build.last_build_log)
    phase("build")

    cfg = with_serving_kernels(MangaOCRConfig.base(), quantized=True)
    raw = init_params(cfg, SEED, "cuda", std=WEIGHT_STD)
    params = {
        "encoder": _cast_quantized(quantize_encoder(raw["encoder"], quantize_attn_proj=True),
                                   torch.bfloat16),
        "decoder": mdl.cast_params(raw["decoder"], torch.bfloat16),
    }
    results: dict = {}
    check_encoder_kernels(params, cfg, results)
    check_encoder_variants(raw, results)
    phase("encoder kernels")
    check_decode_kernel(params, cfg, results)
    phase("kernel C")
    check_decode_forms(raw, cfg, results)
    phase("kernel C forms and ablation")
    del params
    check_bf16_kernels(mdl.cast_params(raw, torch.bfloat16),
                       with_serving_kernels(MangaOCRConfig.base(), quantized=False), results)
    check_step_kernels({"decoder": _cast_quantized(quantize_decoder(raw["decoder"]),
                                                   torch.bfloat16)},
                       {"decoder": mdl.cast_params(raw["decoder"], torch.bfloat16)}, cfg, results)
    del raw
    torch.cuda.empty_cache()
    phase("bf16 and step kernels")
    rates = run_engines(results)

    src = {"fused_attn_layer": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                                "manga_ocr_tpu/ops/flash_attention.py:617"),
           "fused_mlp_block": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                               "manga_ocr_tpu/ops/fused_mlp.py:165"),
           "greedy_decode_loop": ("manga_ocr_tpu_torch/csrc/decode_loop.cu",
                                  "manga_ocr_tpu/ops/decode_loop.py:579"),
           "fused_mlp_block_bf16": ("manga_ocr_tpu_torch/csrc/mlp_bf16.cu",
                                    "manga_ocr_tpu/ops/fused_mlp.py:188"),
           "attention_packed": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                                "manga_ocr_tpu/ops/flash_attention.py:197"),
           "fused_greedy_head": ("manga_ocr_tpu_torch/csrc/fused_head.cu",
                                 "manga_ocr_tpu/ops/fused_head.py:109"),
           "fused_self_attn_step": ("manga_ocr_tpu_torch/csrc/decode_layer.cu",
                                    "manga_ocr_tpu/ops/decode_layer.py:201"),
           "fused_cross_attn_step": ("manga_ocr_tpu_torch/csrc/decode_layer.cu",
                                     "manga_ocr_tpu/ops/decode_layer.py:336"),
           "fused_mlp_block[step]": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                                     "manga_ocr_tpu/ops/fused_mlp.py:165"),
           "fused_attn_layer[bf16]": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                                      "manga_ocr_tpu/ops/flash_attention.py:617"),
           "fused_attention": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                               "manga_ocr_tpu/ops/flash_attention.py:111"),
           "fused_encoder_layer[int8]": ("manga_ocr_tpu_torch/csrc/encoder_layer.cu",
                                         "manga_ocr_tpu/ops/flash_attention.py:770"),
           "fused_encoder_layer[bf16]": ("manga_ocr_tpu_torch/csrc/encoder_layer.cu",
                                         "manga_ocr_tpu/ops/flash_attention.py:770"),
           "encoder_stack[int8]": ("manga_ocr_tpu_torch/csrc/encoder_layer.cu",
                                   "manga_ocr_tpu/ops/encoder_stack.py:190"),
           "encoder_stack[bf16]": ("manga_ocr_tpu_torch/csrc/encoder_layer.cu",
                                   "manga_ocr_tpu/ops/encoder_stack.py:190"),
           "greedy_decode_loop[int8_w]": ("manga_ocr_tpu_torch/csrc/decode_loop.cu",
                                          "manga_ocr_tpu/ops/decode_loop.py:579"),
           "greedy_decode_loop[fuse_kv]": ("manga_ocr_tpu_torch/csrc/decode_loop.cu",
                                           "manga_ocr_tpu/ops/decode_loop.py:579"),
           "fused_attn_layer[sdpa_int8]": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                                           "manga_ocr_tpu/ops/flash_attention.py:617")}
    missing = [name for name, r in results.items() if "launches" not in r]
    if missing:
        fail(f"no main-path launch count for {missing}")
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
         **{k: r[k] for k in keys}}
        for name, r in results.items()
    ]
    log(f"engine crops_per_s {rates}")
    log(f"chip_smoke total {time.time() - T0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
