"""Smoke test of the PyTorch + CUDA serving path on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the kernels of manga_ocr_tpu_torch/csrc with nvcc (sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   serving shapes (MangaOCRConfig.base(), batch 32 and 256, S=197, D=768),
   with CUDA-event times of both.
4. Drives TorchMangaOcrEngine at full width (random weights from a numpy
   seed) through ocr_page on crops from tests/fixtures/eval and through the
   HTTP server; checks the launch counters, the server's texts against the
   engine's, and the kernel path's texts against the plain path's; prints
   the engine's crops/s.
5. Prints one JSON line of kernel results, then the device line
   {"ok": true, "device": {...}} last.  Any failed check exits non-zero
   before the device line.
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
# Weight std of the random model: the HF-like init.  (With std 0.1 the
# random network is chaotic: two plain versions that differ only in f32
# summation order, on the card and on the host, disagree by up to 19% of the
# top logit under teacher forcing, so no bound there can tell a wrong kernel
# from noise; at 0.02 they agree to 0.25%.)
WEIGHT_STD = 0.02
SEED = 0


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


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean time of ``fn`` over ``reps`` runs, after one warm run."""
    import torch

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
    """Kernels A and B against their plain versions at B=32 and 256."""
    import torch

    from manga_ocr_tpu_torch.ops import flash_attention as fa
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    enc = params["encoder"]["layers"]
    ecfg = cfg.encoder
    attn = {k: {n: t[0] for n, t in v.items()} for k, v in enc["attn"].items()}
    fc1, fc2 = enc["mlp"]["fc1"], enc["mlp"]["fc2"]
    ln1 = (enc["ln1"]["scale"][0], enc["ln1"]["bias"][0])
    ln2 = (enc["ln2"]["scale"][0], enc["ln2"]["bias"][0])
    mlp_w = ((fc1["w_q"][0], fc1["scale"][0]), fc1["bias"][0],
             (fc2["w_q"][0], fc2["scale"][0]), fc2["bias"][0])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s = ecfg.seq_len
    for batch in (32, 256):
        x = torch.randn((batch, s, ecfg.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(eps=ecfg.layer_norm_eps, valid_len=s)
        cases = {
            "fused_attn_layer": (
                lambda: fa.fused_attn_layer(x, attn, *ln1, ecfg.num_heads, **kw),
                lambda: fa.fused_attn_layer_reference(x, attn, *ln1, ecfg.num_heads, **kw),
            ),
            "fused_mlp_block": (
                lambda: fm.fused_mlp_block(x, *ln2, *mlp_w, eps=ecfg.layer_norm_eps,
                                           gelu_mode=ecfg.gelu_mode),
                lambda: fm.fused_mlp_block_reference(x, *ln2, *mlp_w, eps=ecfg.layer_norm_eps,
                                                     gelu_mode=ecfg.gelu_mode),
            ),
        }
        for name, (kern, plain) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got.float()).all():
                fail(f"{name} B={batch}: shape {tuple(got.shape)} or non-finite output")
            err = (got.float() - want.float()).abs()
            max_abs, mean_abs = float(err.max()), float(err.mean())
            top = float(want.float().abs().max())
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            log(f"{name} B={batch}: max_abs_err={max_abs} mean_abs_err={mean_abs} "
                f"max_abs_out={top} ms={ms} plain_ms={plain_ms}")
            if max_abs > ENC_MAX_REL * top or mean_abs > ENC_MEAN_REL * top:
                fail(f"{name} B={batch}: error {max_abs}/{mean_abs} over "
                     f"{ENC_MAX_REL * top}/{ENC_MEAN_REL * top}")
            results[name] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                             "batch": batch}


def live_gap_stats(gaps, top, lengths) -> dict:
    """Teacher-forced gaps over the positions a row really emitted."""
    import torch

    steps = gaps.shape[1]
    live = torch.arange(steps, device=gaps.device)[None, :] + 1 < lengths[:, None]
    g, t = gaps[live], top[live].abs()
    return {"max_gap": float(g.max()), "max_rel_gap": float((g / t).max()),
            "nonzero_share": float((g > 0).float().mean()), "positions": int(live.sum())}


def check_decode_kernel(params, cfg, results: dict) -> None:
    """Kernel C against its plain version at B=32 and 256, steps=299."""
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
        cross = dec.precompute_cross_kv_packed(params["decoder"], enc, dcfg)
        run = lambda: dl.greedy_decode_loop(params["decoder"], cross, dcfg, steps)
        plain = lambda: dl.greedy_decode_loop_reference(params["decoder"], cross, dcfg, steps)
        (tok, lens), (ptok, plens) = run(), plain()
        torch.cuda.synchronize()
        if tok.shape != (batch, steps + 1) or int(tok[:, 0].ne(dcfg.bos_token_id).sum()):
            fail(f"greedy_decode_loop B={batch}: bad token matrix")
        same_row = (tok == ptok).all(1) & (lens == plens)
        share = float(same_row.float().mean())
        prefix = float((tok[:, : DECODE_PREFIX + 1] == ptok[:, : DECODE_PREFIX + 1])
                       .all(1).float().mean())
        first_div = sorted(int((a != b).nonzero()[0]) for a, b in zip(tok, ptok) if (a != b).any())
        stats = live_gap_stats(*dl.teacher_forced_gaps(params["decoder"], cross, dcfg, tok), lens)
        ms, plain_ms = cuda_ms(run, reps=2), cuda_ms(plain, reps=1)
        log(f"greedy_decode_loop B={batch}: teacher-forced {stats}; free-running: identical "
            f"rows {share}, rows identical for {DECODE_PREFIX} steps {prefix}, first "
            f"divergence steps {first_div[:40]}; mean length {float(lens.float().mean())}; "
            f"ms={ms} plain_ms={plain_ms}")
        if stats["max_rel_gap"] > DECODE_GAP_REL:
            fail(f"greedy_decode_loop B={batch}: a token {stats['max_rel_gap']} below the "
                 f"plain model's maximum (bound {DECODE_GAP_REL})")
        results["greedy_decode_loop"] = {"max_abs_err": stats["max_gap"], "ms": ms,
                                         "plain_ms": plain_ms, "batch": batch}


def check_page_tokens(engine, crops) -> None:
    """End to end: per bucket of a page, the kernel path's encoder output
    against the plain path's, and the kernel path's tokens scored by the
    plain decoder on the plain encoder output (teacher-forced gaps)."""
    import torch

    from manga_ocr_tpu.parallel import batching
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
                                                   engine.cfg.decoder)
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


def run_engine(results: dict) -> dict:
    import torch
    from PIL import Image

    from manga_ocr_tpu.models.config import MangaOCRConfig
    from manga_ocr_tpu.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch import serve as srv
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop
    from manga_ocr_tpu_torch.ops.flash_attention import fused_attn_layer
    from manga_ocr_tpu_torch.ops.fused_mlp import fused_mlp_block

    cfg = MangaOCRConfig.base()
    t0 = time.time()
    params = init_params(cfg, SEED, "cpu", std=WEIGHT_STD)
    engine = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), device="cuda")
    log(f"engine built in {time.time() - t0:.1f} s")
    crops = load_crops()
    engine.ocr_page(crops[:2])  # first call: library load, allocator growth

    wrappers = (fused_attn_layer, fused_mlp_block, greedy_decode_loop)
    for w in wrappers:
        w.launches = 0
    texts = engine.ocr_page(crops)
    counts = {w.__name__: w.launches for w in wrappers}
    from manga_ocr_tpu.parallel import batching

    n_dispatch = len(batching.prep_page_gray(crops, 1))
    log(f"ocr_page over {len(crops)} crops in {n_dispatch} dispatches: launches {counts}")
    want = {"fused_attn_layer": 12 * n_dispatch, "fused_mlp_block": 12 * n_dispatch,
            "greedy_decode_loop": n_dispatch}
    if counts != want:
        fail(f"launch counts {counts}, expected {want}")
    for name, n in counts.items():
        results[name]["launches"] = n
    if len(texts) != len(crops) or not all(isinstance(t, str) for t in texts):
        fail("ocr_page returned malformed texts")
    if len(set(texts)) < 2:
        fail("every crop decoded to the same text: outputs do not depend on the input")
    log(f"texts: {texts}")
    check_page_tokens(engine, crops)

    # throughput: one 256-crop page (the fixtures cycled), after a warm page
    page = [crops[i % len(crops)] for i in range(256)]
    engine.ocr_page(page)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 2
    for _ in range(reps):
        engine.ocr_page(page)
    rate = reps * len(page) / (time.perf_counter() - t0)
    log(f"engine ocr_page 256 crops: {rate} crops/s on {card_line()}")

    # the HTTP server
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
    return {"crops_per_s": rate}


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

    from manga_ocr_tpu.models.config import MangaOCRConfig, with_serving_kernels
    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.kernels import build
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.quantize import quantize_encoder

    t0 = time.time()
    build.load(verbose=True)
    log(f"kernels built in {time.time() - t0:.1f} s")
    spills = [ln for ln in build.last_build_log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
    for ln in spills:
        log(f"ptxas: {ln.strip()}")

    cfg = with_serving_kernels(MangaOCRConfig.base(), quantized=True)
    raw = init_params(cfg, SEED, "cuda", std=WEIGHT_STD)
    params = {
        "encoder": _cast_quantized(quantize_encoder(raw["encoder"], quantize_attn_proj=True),
                                   torch.bfloat16),
        "decoder": mdl.cast_params(raw["decoder"], torch.bfloat16),
    }
    del raw
    results: dict = {}
    check_encoder_kernels(params, cfg, results)
    check_decode_kernel(params, cfg, results)
    del params
    torch.cuda.empty_cache()
    engine = run_engine(results)

    src = {"fused_attn_layer": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                                "manga_ocr_tpu/ops/flash_attention.py:617"),
           "fused_mlp_block": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                               "manga_ocr_tpu/ops/fused_mlp.py:165"),
           "greedy_decode_loop": ("manga_ocr_tpu_torch/csrc/decode_loop.cu",
                                  "manga_ocr_tpu/ops/decode_loop.py:579")}
    kernels = [
        {"name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, r in results.items()
    ]
    log(f"engine crops_per_s={engine['crops_per_s']}")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
