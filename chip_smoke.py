"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(``python3 chip_smoke.py --stack-floor`` prints only the plain encoder
stack's own noise floor, which sets ENC_STACK_MEAN_REL;
``python3 chip_smoke.py --core-times ROOT...`` only the attention core's
times, built and timed from each tree ROOT in turn;
``python3 chip_smoke.py --gemm-times ROOT...`` the bf16 and the int8 GEMM's
times at the main paths' shapes, kernels J's and K's attention cores alone
at B=32 and 256, kernel F's device time at B=32 and 256 and the times and
profiler splits of the step decode (B=32) and the fused_layer decode (B=32
and 256) that launch it, kernel C's
forms at B=256 (serving, fuse_kv with its profiled split, the unfused
path, int8_w, int8_w + fuse_kv), the three engines' crops/s (int8, bf16,
int8 with attn_sdpa_int8 + fuse_cross_kv) and a torch.profiler split of
one H bf16 layer, one A int8 and one B call at B=256 and one dispatch of
each engine, from each tree in turn;
``python3 chip_smoke.py --tp-times ROOT...`` the plain engine's and the
tensor-parallel engine's crops/s and the train step's ms on one device,
a (1, 2) and a (2, 2) mesh of cuda:0, from each tree in turn.)

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the kernels of manga_ocr_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together, and prints the ptxas line of the
   attention core (registers, spill bytes) for each head-dim form; a spill
   fails.  Then holds the attention core that A, E, G, H and I share
   against its plain version at full width on ragged shapes: S = 5, 16,
   17, 37, 197, every key and the last three masked, in each stride layout
   (A's q|k|v rows, E's packed, G's head-major), f32 and bf16 output, the
   softmax by division and by the reciprocal multiply.  Then the bf16 GEMM
   that every bf16 projection runs on (TMA + mbarrier ring + wgmma): its
   ptxas line per tile instantiation (a spill fails), its GELU (the erf
   polynomial's reciprocal branch-free) against the division form that B,
   C and F use, on all 2^32 f32 inputs, and the kernel against its plain
   version at the main paths' shapes (the encoder block's four products at
   M = 256 x 197, the decode step's at M = 32 and 256), each with its
   device time, TFLOP/s, bound and one torch.addmm call's time.  Then the
   int8 GEMM under every int8 projection (TMA + mbarrier ring + s8 wgmma;
   its ptxas lines are printed with the bf16 GEMM's) against its plain
   version, bit for bit (the GELU modes within a few f32 ulps), at the
   encoder block's four shapes, the decode step's and M = 1, 17 and 197,
   each with its device time, TOP/s, bound and one torch._int_mm call's
   time.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (MangaOCRConfig.base(), batch 32 and 256,
   S=197, D=768), with CUDA-event times of both: A, B, C on int8 params;
   D (three forms), E and F on bf16 params (F: the ptxas lines of its
   vocab product, row pass and reduce, a spill failing; each id within
   HEAD_GAP_REL of the plain top logit and planted ties at their lowest
   id; one torch.addmm of its vocab product as a yardstick); the
   decode-step kernels J (steps 0, 1, 150 and 303 of a 305-row cache and
   both sides of its core's first two chunk edges, and the cache row it
   writes), K (s_valid 197 and 150) and B's post-LN step form on a
   quantize_decoder decoder with int8 slabs and on the bf16 decoder with
   bf16 slabs, at batch 32 and 256, J's and K's int8 context (their cores'
   output for the int8 out projection) bit for bit against ln_quant_rows
   of the same core's f32 context; their cores alone (CUDA-graph device
   time beside the bytes bound, one scaled_dot_product_attention call as
   a yardstick) and their ptxas lines (a spill fails).  Each kernel's bound (the least time the card
   could take: bytes over the memory rate or operations over the peak rate
   of their type, the larger) is computed from the same shapes, and E is
   also timed as one scaled_dot_product_attention call.  Kernel C's
   serving form runs on the cluster kernel (csrc/decode_cluster.cu), held
   at B=32, a ragged B=40 and B=256 beside the present kernel's serving form
   (kernel="loop") on the same inputs, with the grid, the bound, the slab
   and cache re-read floor and, at B=256, the stage split of its profiled
   instance; its ptxas lines are printed after the build.
4. Drives TorchMangaOcrEngine at full width (random weights from a numpy
   seed) through ocr_page on crops from tests/fixtures/eval:
   - int8 serving (kernels A, B, C), also through the HTTP server;
   - unquantized serving (quantize_int8=False: kernels E, D, C);
   checking the launch counters of every kernel (kernel C in its cluster
   form on both engines' dispatches), the encoder output and the
   decode tokens against the plain path's, and printing crops/s on one
   256-crop page.  Then (phase "wire and coalescing", run_wire) the int8
   engine with wire gray and packed, coalesce on and off, on the 256-crop
   page and a five-bucket page: launches A 12, B 12, C 1 a bucket, the
   packed prep's PackedBatch items, ``fused`` where coalescing applies,
   the transfers and readbacks counted against the design (fused gray
   wire 1 and 1; else 2 transfers a bucket; 1 readback under coalesce,
   else 1 a bucket), every bucket's [lengths | tokens] rows bit-equal to
   the bucket program's on the unsent gray batch, and the coalesced
   readback on 2 x cuda:0 bit-equal to the per-bucket one; with each
   page's wire bytes, the stage split, ocr_page's and ocr_pages' crops/s,
   and the dispatch path's host synchronizations.  Then (phase "engine
   graphs", run_graphs) aot=True, one CUDA graph per (bucket, padded
   batch), on the int8 and the bf16 engine: every bucket's rows bit-equal
   to the same engine's eager bucket program on the 256-crop, the 8-crop
   and the five-bucket page (int8: wire gray and packed, coalesce on and
   off; bf16: gray coalesced), shapes captured at
   their first dispatch and then every page dispatched before any is read,
   which must launch no kernel wrapper (the graphs run the kernels);
   ocr_pages over GRAPH_STREAM pages, lookahead 2, its rows bit-equal,
   with the shapes captured in the order opposite to the one the pages
   reach them in and one shape outside the warmed set, which must be
   captured from the lookahead thread and counted once in COMPILE_EVENTS;
   the capture seconds a shape, the device memory warmup() and
   warmup(full=True) hold beside the eager engine's, and ocr_page crops/s
   with the StageTimer's "dispatch" ms a page, eager against graph, at
   budgets 300 and 24, on the 256-crop and the 8-crop page, and ocr_pages'
   crops/s.  Then the step-by-step
   greedy decode (head_kernel and step_mlp_kernel "fused": kernels F and
   D) at B=32 over 100 steps, its tokens scored by the plain step decode;
   and one page through the exact reference path (serving_kernels=False),
   which must launch no kernel.
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
6. Kernel C's batch invariance: its four cluster forms (serving, fuse_kv,
   int8_w, int8_w + fuse_kv) on the first B rows of one encoder output at
   B = 16, 128, 240, 256 and 384 (16-row tiles, one wave, and tiles of
   17-32 rows, each grid printed), every row's [lengths | tokens]
   bit-equal across the batch sizes.  Then the forms of kernels A and C
   that complete the port: A's sdpa_int8
   form held against its plain version at B=256 (and sdpa_headpack shown
   bit-identical to A's default form); C's int8_w form on the cluster
   kernel's int8 instance (s8 projections), held and timed beside the
   present kernel's (kernel="loop") on the same inputs, with both grids
   and the int8 instance's stage split; its fuse_kv form (the prologue --
   the final LN's row pass and the bf16 GEMM into the slabs -- then the
   cluster kernel, with bf16 weights and with int8 ones; both scored by
   the unfused plain decoder over the slabs of the final LN and timed
   beside final LN + precompute_cross_kv_packed + the unfused kernel; the
   bf16 form also held and timed on the present kernel, kernel="loop",
   with the prologue's own device time and the grid) at B=256, int8_w and
   fuse_kv timed at B=512 with their grids, and C's time with each stage
   ablated on the present kernel.  Then
   the slice's paths: the int8 engine with attn_sdpa_int8 and
   fuse_cross_kv through ocr_page (A 12 in the sdpa_int8 form, B 12 and C
   1 in the fuse_kv and the cluster form per dispatch, no slab precompute;
   teacher-forced tokens, crops/s, the stage split), and ocr_forward on 32
   crops with quantize_decoder weights, with and without fuse_cross_kv
   (C's int8_w form on the cluster kernel; exact counts, teacher-forced
   tokens).
7. The dual pass: ocr_preprocess at B=256 (the fixture crops cycled and
   bucketed, one call per bucket) for each orientation on the card, held
   against the port's own host run of the same calls (NONE, HORIZONTAL
   and VERTICAL byte for byte; AUTO within PRE_MAX_PIXEL_SHARE differing
   pixels and PRE_ANGLE_ATOL_DEG), with CUDA-event ms per orientation and
   the largest bucket's shape; then ocr_page_dual through the int8
   serving engine on the fixture crops (one ocr_page of the raw and the
   binarized crops: A 12, B 12, C 1 per dispatch exactly; both rows'
   tokens teacher-forced by the plain path; crops/s of a 128-crop dual
   page); then the CER harness as a user runs it, ``python -m
   manga_ocr_tpu_torch.eval tests/fixtures/eval --checkpoint
   tests/fixtures/tiny_random_seed0 --device cuda`` in a subprocess, whose
   report must equal the host's (20 crops, 22 strings, exact match 1.0).
8. The user's entry points on an HF checkpoint directory at full width:
   the seed-0 base params written by save_hf_checkpoint (write time, file
   size) and read back by load_hf_checkpoint, every leaf bit-equal;
   MangaOcr(dir) on the card called once per fixture crop (A 12, B 12, C 1
   in its cluster form per call, each string equal to ocr_page([crop]) of
   an int8 engine built in-process from the same bf16-loaded params), then
   from 8 threads on all the crops (fewer dispatches than calls; the
   strings of crops dispatched at their single-call shape exact, the
   others teacher-forced by the plain path within ENGINE_GAP_REL); and
   ``python -m manga_ocr_tpu_torch.cli --checkpoint DIR --device cuda ocr``
   on the fixture pngs in a subprocess, its lines equal to an in-process
   f32-loaded engine's; MangaOcr's first-call latency and the command
   line's wall time beside the card's name and power limit.
9. Training at full width (manga_ocr_tpu_torch.train on MangaOCRConfig.base(),
   f32): one B=2 step's loss and every leaf's gradient on the card against
   the host's (TRAIN_LOSS_REL, TRAIN_GRAD_REL), and the same step with TF32
   products and under bf16 autocast, each of which must fail those bounds
   (the controls); train() at B=32, T=32 for
   30 steps (warmup 5, a train state saved every 15) with the median step
   time by CUDA events, crops/s and the peak device memory, every logged
   loss finite, then resumed to step 32; and ``main --steps 2 --export-hf
   DIR`` in-process, its directory read by MangaOcr on the fixture crops (A
   12, B 12, C 1 per call; the page teacher-forced by the plain path
   within DECODE_GAP_REL).
   Then Latin recognizer training (phase "latin training": train_latin on
   the full-width CRNN, 96 classes, f32, no kernel): one B=32 step card
   against host (TRAIN_LOSS_REL, TRAIN_GRAD_REL) with the process's TF32
   flags on, which the step overrides: in f32 on every leaf but conv0-conv5
   (printed; see LATIN_PIXEL_SUMS), in f64 on every leaf; a TF32 loss and
   backward that must miss the f32 bounds (reported if it does not); 50
   steps by CUDA events (median and worst step, lines/s, peak memory, the
   card's idle share while the host renders the next batch, a profiled
   step's top five kernels); the closed loop of tests/test_latin_closed_loop.py
   from JAX's PRNGKey(0) init (tests/fixtures/latin_closed_loop_init) with
   data seeds 0-3 side by side in child processes (``chip_smoke.py
   --latin-loop SEED DIR``, at most 4000 steps; its plateau escape is
   heavy-tailed, see LATIN_LOOP_SEEDS), each saved, reloaded on the card
   and read by TorchLatinEngine as it ends, until one reads >= 20 of 24
   held-out lines exactly;
   ``train_latin.main(["--steps", "20", "--out", DIR])`` at its defaults,
   the directory loaded back.
   Between the two (phase "closed loop"), scripts/torch_closed_loop_fullsize.py's
   run at base() width cut to CLOSED_LOOP_STEPS steps of B=32 (its render
   process, the clipped AdamW step, a checkpoint in a temporary
   directory), its held-out read of CLOSED_LOOP_EVAL crops through the
   int8 serving engine and the serving_kernels=False bf16 control, and
   ocr_forward's crops/s at budget 300 and 32: steps/s, the host's share
   of the loop, exact/CER (a plumbing check: the model has barely
   trained) and the rates printed; a non-finite loss or one at or above
   ln(vocab) fails.
10. Detection (no kernel of its own; plain PyTorch on the card, host
   contours on the machine's own tier -- cv2 where OpenCV is installed,
   else the native tracer -- never the NumPy fallback; the native tracer
   is built, timed and held against cv2's findContours on (a)'s masks
   wherever OpenCV is there): (a)
   the full-width bubble segmenter (DetectorConfig(): input 512, base 32,
   depth 4) on numpy seed-0 weights over 8 pages of 1700x1200, card against
   host on two of them (probabilities within DET_PROB_ATOL, masks equal
   except where the host's probability is within DET_MASK_EPS of the
   threshold, with the process's TF32 flags on, which segment_pages
   overrides; a TF32 run printed beside it), segment_pages at B=1, 2, 4, 6
   and 8 by CUDA events with the peak device memory of each, a chapter of 32
   pages through detect_bubble_masks (DISPATCH_PAGES a dispatch) with its
   ms a page and peak memory, the host contour time a page by tier, and
   detect_pages' pages/s; (b) the JAX package's detection closed loop trained
   on the card from its initial weights
   (tests/fixtures/detector_closed_loop_init.npz) and held to its bounds on
   6 held-out pages; (c) PagePipeline(engine.ocr_page).process_pages over 8
   drawn pages with glyph text in their bubbles, (b)'s detector and the int8
   engine (A 12, B 12, C 1 a dispatch exactly; every job's text equal to
   engine.ocr_page on the same crops; a TypesetArea on every JobResult;
   crops/s); (d) detect_text_regions on a page of glyph-text columns: every
   proposal read in one ocr_page call.
11. The other detector and recognizer families (no kernel of their own;
   plain PyTorch on the card, f32 with TF32 off), seed-0 numpy weights on
   (10)'s pages: "onnx", the full-width U-Net written as an ONNX graph and
   opened by BubbleDetector.from_checkpoint, its executor held against the
   port's UNet on the card and against the host, page masks card against
   host, ms a page; "yolo", YoloSegConfig() at 640 held card against host,
   its forward and host postprocess timed, its OR-ed masks (cls bias
   lowered until YOLO_CANDIDATES anchors a page pass) cropped and read by
   (10)'s int8 engine (A 12, B 12, C 1 a dispatch exactly); "latin",
   TorchLatinEngine at the published CRAFT and CRNN widths held card against
   host (a 768 and a 1024 bucket, a 64- and a 512-wide line batch),
   detect_boxes_batch timed over (10)'s pages and its chapter (peak memory
   held to one dispatch's), each bucket's CRAFT dispatch swept over pages;
   then its last conv refitted to a glyph page's ink (CRAFT_PEAK_SHARE):
   boxes on glyph pages, recognize_lines timed, readtext and text mode on
   craft_proposer (regions required, text mode's proposals read by the int8
   engine: A 12, B 12, C 1 a dispatch exactly).
12. Text erasure and typeset export (phase "inpaint"; no kernel of its own:
   plain PyTorch on the card, f32 with TF32 off): the LaMa generator at the
   published big-lama width (InpaintConfig(num_blocks=18): ngf 64, 3
   downsamples, ratio 0.75) on numpy seed-0 weights; one 512x512 window of
   (10c)'s page with a text-block hole on the card against the port's host
   path (the head's logits within LAMA_LOGIT_REL of the largest, known
   pixels bit-equal, differing hole pixels counted), with the process's TF32
   flags on, which inpaint_batch overrides; inpaint_batch on 512x512
   regions at B=1, 2, 4, 8 and on one 1704x1200 page by CUDA events with
   each one's peak device memory and TFLOP/s (B=8 uncapped: cuDNN's FFT
   convolutions), LamaInpainter.inpaint_many on the 8 regions in
   DISPATCH_PIXELS dispatches, and a torch.profiler split of a page call
   (convolutions, FFTs, the rest); then every area of (10c)'s
   page with the most regions erased through erase_area_for_settings with
   inpaint_model_key "big_lama" (the phase fails if the inpainter raised
   on an area, or if a pixel outside an area's mask changed), a Project of
   the page's areas saved and loaded, and export.batch_save and export_pdf
   into a temporary directory (the written page equal to render_page's),
   with ms per area and per page and the host ms of render + save.
13. The process command (phase "process"; host layers: settings, the
   translation service over HTTP, the registry's TesseractEngine probe,
   the project and the export) as a user runs it, in-process:
   cli.main(["--device", "cuda", "process", FOLDER, "--out", OUT,
   "--detector", NPZ, "--settings", S, "--translate", "--provider",
   "openrouter"]) on (10c)'s 8 pages written as PNGs, (10a)'s full-width
   U-Net saved by models/detector.save_params (the form --detector reads:
   DetectorConfig()), and a settings.json whose openrouter URL points at a
   stub chat-completions server on 127.0.0.1 in a thread of this script
   (its reply a function of each request's own prompt); the command builds
   the full-width int8 engine on seed-0 weights at max length 300 (A, B,
   C).  It must exit 0 and write a project.json that load_project reads,
   one *_typeset.png per page with areas, every area with OCR text
   carrying the stub's reply to that text; the stub must count requests;
   the launches over the run must be A 12, B 12, C 1 per dispatch exactly;
   every area's text must equal PagePipeline(engine.ocr_page) on the same
   pages with the same detector and the command's own engine.  Then
   shorter runs: --detect-mode text on (10d)'s glyph-column page,
   --enhanced on two pages (with tesseract where it is installed, else the
   same model's second pass; which one ran is printed), and
   --detector-type yolo on (11)'s YOLO weights with the lowered cls bias
   (yolo_seg.save_params), each with exact launch counts.  Prints pages/s
   by the host clock, the host split (engine build, detection, OCR,
   translation round trips, save_project + batch_save), launches per
   dispatch and the stub's request count.
14. Data-parallel serving (phase "data-parallel serving"; the device guard
   of every kernel launch, no kernel of its own) on a mesh of every card
   where there are several, else a virtual mesh of DP_VIRTUAL x cuda:0:
   torch.cuda.device_count() and the refusal of --mesh-data over more cards
   than are visible; the full-width int8 engine on the mesh (exact launch
   counts: A 12, B 12, C 1 per shard dispatch), the [lengths | tokens]
   matrix of each bucket of the 256-crop page against the single-device
   engine's (every row bit-equal; where one differs, the stage and C's
   grids are printed and the run fails), both engines' crops/s; BubbleDetector,
   LamaInpainter (big-lama) and TorchLatinEngine's CRAFT maps and CRNN
   logits on the mesh against one device on each shard's slice (bit-equal;
   LaMa within one level on 0.5% of pixels); then one rank a mesh device in
   child processes (``chip_smoke.py --dp-rank RANK N PORT OUT``: gloo on
   one card, NCCL on several; parallel/multihost's initialize,
   make_global_mesh, global_batch, gather_to_hosts, sync), their gathered
   matrix held to one process's run of the same bucket as above.
15. Tensor parallelism (phase "tensor parallelism"; no kernel: the model
   axis runs the plain routes) at base() width in f32, TF32 held off, on a
   (1, 2) mesh (two cards, else TP_VIRTUAL x cuda:0) and, where four cards
   are visible, a (2, 2) mesh (else the fixture crops' texts on a (2, 2)
   mesh of 4 x cuda:0): the engine on the fixture crops (no launch)
   and each bucket's rows of the 256-crop page against the single-device
   plain engine's (bit-equal, or the differing rows teacher-forced within
   TP_GAP_REL), both crops/s and a page's peak memory; one train step's
   loss and gradients against one device's (phase "training"'s bounds),
   the data rows' params bit-equal after it, ms a B=32 step against one
   device's and its peak memory; two gloo ranks on cuda:0 on a (2, 2)
   global mesh (``chip_smoke.py --tp-rank RANK PORT OUT BACKEND``) taking
   one step together against one process (equal losses and params, the
   loss within 2e-5, the params within 3 lr), and where two cards or more
   are visible two NCCL ranks, one card each, held the same way.
16. The throughput bench (phase "benchmark"): ``python -m
   manga_ocr_tpu_torch.benchmark`` in a child process under a short
   BENCH_BUDGET_S (phase D off), its lines echoed as they arrive: every
   line must parse, the first scored line must come within
   BENCH_FIRST_LINE_S, the last must carry phases A-C's keys with positive
   rates and both utilisation shares in (0, BENCH_MFU_MAX].  Then its
   programs in-process at B=256: one rung-2 call (A 12, B 12, C 1 in its
   cluster form exactly), utils.metrics.trace of one call (CUDA kernels
   required), its CUDA graph replay's rows bit-equal to the eager call's
   with no wrapper launched; the budget-300 program's lengths
   min(stop, unstopped length), its tokens equal to the unstopped ones up
   to each row's length.
17. Prints its total seconds, one JSON line of kernel results, then the
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


def log_core_ptxas(build_log: str) -> None:
    """The attention core's ptxas lines (registers, spill bytes) for each
    head-dim instantiation; fails if any spills or none is found."""
    import re

    name, found = "", 0
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        dh = re.search(r"attention_kernelILi(\d+)E", name)
        if dh is None or not ("spill" in ln or "registers" in ln):
            continue
        log(f"ptxas: attention core dh<={dh.group(1)}: {ln.strip()}")
        if "spill" in ln:
            found += 1
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln)):
                fail(f"the attention core (dh<={dh.group(1)}) spills: {ln.strip()}")
    if not found:
        fail("no ptxas line of the attention core in the build log")


def log_gemm_ptxas(build_log: str) -> None:
    """The ptxas lines (registers, stack, spill bytes) of both GEMMs on the
    gemm_sm90.cuh pipeline (bf16: Bf16Op, int8: S8Op) for each tile
    instantiation, but kernel F's ArgmaxStore ones; fails if any spills or
    either GEMM has none."""
    import re

    name, found = "", {"bf16": 0, "int8": 0}
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        tile = re.search(r"gemm_kernel\w*?(Bf16Op|S8Op)\w*?TileILi(\d+)ELi(\d+)ELi(\d+)E", name)
        if tile is None or "ArgmaxStore" in name or not ("spill" in ln or "registers" in ln):
            continue  # (kernel F's vocab product: log_head_ptxas)
        form = "bf16" if tile.group(1) == "Bf16Op" else "int8"
        label = "{} GEMM {}x{} tiles, {} stages".format(form, *tile.groups()[1:])
        log(f"ptxas: {label}: {ln.strip()}")
        if "spill" in ln:
            found[form] += 1
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln)):
                fail(f"the {label} spills: {ln.strip()}")
    for form, n in found.items():
        if not n:
            fail(f"no ptxas line of the {form} GEMM in the build log")


def log_head_ptxas(build_log: str) -> None:
    """Kernel F's ptxas lines (registers, stack, spill bytes): its vocab
    product (the bf16 GEMM's tiles with the ArgmaxStore epilogue), its row
    pass per chunk count and its reduce; fails if any spills or one of the
    three has none."""
    import re

    name, found = "", {"vocab product": 0, "row pass": 0, "reduce": 0}
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        if not ("spill" in ln or "registers" in ln):
            continue
        tile = re.search(r"gemm_kernel\w*?Bf16Op\w*?TileILi(\d+)ELi(\d+)ELi(\d+)E\w*?ArgmaxStore",
                         name)
        rows = re.search(r"head_rows_kernelILi(\d+)E", name)
        if tile:
            form, label = "vocab product", "F vocab product {}x{} tiles, {} stages".format(
                *tile.groups())
        elif rows:
            form, label = "row pass", f"F row pass, {rows.group(1)} chunks a lane"
        elif "head_reduce_kernel" in name:
            form, label = "reduce", "F reduce"
        else:
            continue
        log(f"ptxas: {label}: {ln.strip()}")
        if "spill" in ln:
            found[form] += 1
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln)):
                fail(f"the {label} spills: {ln.strip()}")
    for form, n in found.items():
        if not n:
            fail(f"no ptxas line of kernel F's {form} in the build log")


def log_step_ptxas(build_log: str) -> None:
    """The ptxas lines (registers, stack, spill bytes) of kernels J's and
    K's attention cores (csrc/decode_layer.cu) for each copy width and K/V
    type; fails if any spills or either core has none."""
    import re

    name, found = "", {"self": 0, "cross": 0}
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        core = re.search(r"(self|cross)_attn_coreI(a|13__nv_bfloat16)?Li(\d+)E", name)
        if core is None or not ("spill" in ln or "registers" in ln):
            continue
        kind, kv, width = core.groups()
        kv = {"a": " int8", "13__nv_bfloat16": " bf16"}.get(kv, "")
        label = (f"{'J' if kind == 'self' else 'K'} core{kv}, "
                 f"{f'{width}-byte cp.async' if width != '0' else 'plain loads'}")
        log(f"ptxas: {label}: {ln.strip()}")
        if "spill" in ln:
            found[kind] += 1
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln)):
                fail(f"the {label} spills: {ln.strip()}")
    for kind, n in found.items():
        if not n:
            fail(f"no ptxas line of the {kind}-attention core in the build log")


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


# The attention core's ragged shapes: partial query and key tiles (S not a
# multiple of 16), a single tile, and the key mask (valid_len = S - 3).
CORE_SEQS = (5, 16, 17, 37, 197)
CORE_LAYOUTS = ("qkv", "packed", "heads")


def core_inputs(layout: str, b: int, s: int, heads: int, dh: int, gen):
    """q, k, v in one of the three layouts the attention core reads (A's
    q|k|v GEMM output [B*S, 3D], E's three [B, S, D], G's three
    [B, H, S, dh]), their (batch, head, row) element strides, an output
    tensor of the layout's own shape with its strides, and the [B, H, S, dh]
    head view of a tensor of either shape."""
    import torch

    d = heads * dh

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if layout == "heads":
        q, k, v = randn(b, heads, s, dh), randn(b, heads, s, dh), randn(b, heads, s, dh)
        strides = (heads * s * dh, s * dh, dh)
        out_shape, out_strides = (b, heads, s, dh), strides

        def view(t):
            return t
    else:
        if layout == "qkv":
            qkv = randn(b * s, 3 * d)
            q, k, v = qkv, qkv[:, d:], qkv[:, 2 * d:]
            strides = (s * 3 * d, dh, 3 * d)
        else:
            q, k, v = randn(b, s, d), randn(b, s, d), randn(b, s, d)
            strides = (s * d, dh, d)
        out_shape, out_strides = (b, s, d), (s * d, dh, d)

        def view(t):
            return t.reshape(b, s, -1)[..., :d].reshape(b, s, heads, dh).transpose(1, 2)
    return (q, k, v), strides, out_shape, out_strides, view


def check_attention_core() -> None:
    """The attention core that A, E, G, H and I share, against its plain
    version (``_sdpa_reference``) at full width (12 heads of dh 64) on the
    ragged shapes: S in CORE_SEQS with every key and with valid_len = S - 3,
    each stride layout, f32 and bf16 output, the softmax by division and by
    the reciprocal multiply."""
    import torch

    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops.flash_attention import _sdpa_reference

    heads, dh, b = 12, 64, 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst, cases = 0.0, 0
    for layout in CORE_LAYOUTS:
        for s in CORE_SEQS:
            (q, k, v), strides, out_shape, out_strides, view = core_inputs(
                layout, b, s, heads, dh, gen)
            for valid in (s, s - 3):
                for out_dtype in (torch.float32, torch.bfloat16):
                    for divide in (True, False):
                        out = torch.empty(out_shape, dtype=out_dtype, device="cuda")
                        launch._attention(q, k, v, strides, out, out_strides, b, s, heads, dh,
                                          valid, 1.0 / dh**0.5, divide)
                        want = _sdpa_reference(view(q).float(), view(k).float(),
                                               view(v).float(), valid, divide, torch.bfloat16)
                        max_abs, _ = compare("attention core",
                                             f"{layout} S={s} valid={valid} {out_dtype} "
                                             f"divide={divide}", view(out),
                                             want.to(out_dtype))
                        worst = max(worst, max_abs / float(want.abs().max()))
                        cases += 1
    log(f"attention core: {cases} ragged cases within bounds, largest max_abs_err "
        f"{worst} of the largest output")


def core_times() -> dict:
    """CUDA-event ms of the attention core alone at the main path's shape
    (B=256, S=197, 12 heads of dh 64, every key), in each stride layout,
    output type and softmax normalisation (division or the reciprocal
    multiply), 20 launches each after a warm one."""
    import torch

    from manga_ocr_tpu_torch.kernels import launch

    b, s, heads, dh = 256, 197, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    times = {}
    for layout in CORE_LAYOUTS:
        (q, k, v), strides, out_shape, out_strides, _ = core_inputs(layout, b, s, heads, dh, gen)
        for out_dtype in (torch.float32, torch.bfloat16):
            out = torch.empty(out_shape, dtype=out_dtype, device="cuda")
            for divide in (True, False):
                times[f"{layout} {str(out_dtype)[6:]} {'divide' if divide else 'reciprocal'}"] = \
                    cuda_ms(lambda: launch._attention(q, k, v, strides, out, out_strides, b, s,
                                                      heads, dh, s, 1.0 / dh**0.5, divide),
                            reps=20)
    return times


# ``--core-times ROOT...`` and ``--gemm-times ROOT...``: one function of
# this file (core_times, compare_child) run in one child process per ROOT (a
# tree of the repository, e.g. another commit unpacked with git archive,
# whose kernels the child builds), in the order given: list a pair as
# A B B A to compare two trees on one card.
TREE_CHILD = """
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
print(json.dumps(runpy.run_path(sys.argv[2])[sys.argv[3]]()))
"""


def compare_trees(fn_name: str, roots: list) -> None:
    for root in roots:
        out = subprocess.run([sys.executable, "-c", TREE_CHILD, os.path.abspath(root),
                              os.path.abspath(__file__), fn_name], capture_output=True,
                             text=True, cwd=os.path.abspath(root))
        if out.returncode != 0:
            fail(f"{fn_name} of {root}: {out.stderr.strip()[-2000:]}")
        lines = out.stdout.strip().splitlines()
        for ln in lines[:-1]:
            log(f"[{root}] {ln}")
        log(f"{fn_name} of {root}: {lines[-1]}")


# The bf16 GEMM (csrc/mlp_bf16.cu) at the shapes of the main paths: the
# four products of an encoder block at B=256 (H, I, A's bf16 form and D on
# 256 x 197 rows) and the decode step's at B=32 and 256 (J's q|k|v and K's
# q, f32 out; J's and K's o; D's step form), in the mode each path uses.
GEMM_SHAPES = [(f"{name} M={m}", m, n, k, mode) for m in (256 * 197,)
               for name, n, k, mode in (("qkv", 2304, 768, "bias"), ("o", 768, 768, "residual"),
                                        ("fc1", 3072, 768, "gelu_erf"),
                                        ("fc2", 768, 3072, "residual"))] + \
    [(f"step {name} M={m}", m, n, k, mode) for m in (32, 256)
     for name, n, k, mode in (("qkv", 2304, 768, "f32"), ("q", 768, 768, "f32"),
                              ("o", 768, 768, "residual"), ("fc1", 3072, 768, "gelu_erf"),
                              ("fc2", 768, 3072, "residual"))]


def gemm_inputs(m: int, n: int, k: int, mode: str, gen):
    """a, b, bias, the epilogue code and the residual (None unless
    ``mode`` is "residual") of one GEMM shape."""
    import torch

    from manga_ocr_tpu_torch.kernels import launch

    code = {"gelu_erf": launch.BF16_GELU_ERF, "residual": launch.BF16_RESIDUAL,
            "f32": launch.BF16_F32, "bias": launch.BF16_BIAS}[mode]
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device="cuda") * WEIGHT_STD).to(torch.bfloat16)
    bias = torch.randn((n,), generator=gen, device="cuda") * 0.1
    res = (torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)
           if mode == "residual" else None)
    return a, b, bias, code, res


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph, replayed once after a warm replay (no host launch gaps)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def cost_gemm(m, n, k, mode):  # the bf16 GEMM: a, b, bias (and residual) in, out once
    out = 4 if mode == "f32" else 2
    return ((m * k + k * n) * 2 + n * 4 + m * n * (out + (2 if mode == "residual" else 0)),
            {"bf16": 2 * m * n * k})


def check_bf16_gemm() -> None:
    """The GEMM's gelu_erf (branch-free reciprocal) against its division
    form on every f32 input, then gemm_times(check=True)."""
    from manga_ocr_tpu_torch.kernels import launch

    bad = launch.check_gelu_erf_rcp("cuda")
    if bad:
        fail(f"gelu_erf (branch-free reciprocal) differs from its division form on {bad} f32 "
             "inputs")
    log("gelu_erf (branch-free reciprocal) equals its division form bit for bit on all 2^32 "
        "f32 inputs")
    gemm_times(check=True)


def gemm_times(check: bool = False) -> dict:
    """Device ms (CUDA graph) of the bf16 GEMM alone at each GEMM_SHAPES
    shape.  With ``check``, also holds it against its plain version
    (``bf16_gemm_reference``) and logs its TFLOP/s and share of the bf16
    peak, its bound, the plain version's time and one torch.addmm call's on
    the same operands as the library yardstick (timed only; the port never
    calls it)."""
    import torch

    from manga_ocr_tpu_torch.kernels import launch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    times = {}
    for label, m, n, k, mode in GEMM_SHAPES:
        a, b, bias, code, res = gemm_inputs(m, n, k, mode, gen)
        reps = 10 if m > 4096 else 50
        if check:
            from manga_ocr_tpu_torch.ops.fused_mlp import bf16_gemm_reference

            got = launch.bf16_gemm(a, b, bias, code, res)
            want = bf16_gemm_reference(a, b, bias, code, res)
            torch.cuda.synchronize()
            max_abs, _ = compare("bf16 GEMM", label, got, want)
            del got, want
        ms = times[label] = graph_ms(lambda: launch.bf16_gemm(a, b, bias, code, res), reps)
        if check:
            plain_ms = cuda_ms(lambda: bf16_gemm_reference(a, b, bias, code, res))
            bias16 = bias.to(torch.bfloat16)
            library_ms = graph_ms(lambda: torch.addmm(bias16, a, b), reps)
            bound_ms, bound_by = bound(*cost_gemm(m, n, k, mode))
            tflops = 2 * m * n * k / ms / 1e9
            log(f"bf16 GEMM {label} N={n} K={k} {mode}: max_abs_err={max_abs} ms={ms} "
                f"TFLOP/s={tflops} ({tflops / 989:.3f} of the bf16 peak) bound_ms={bound_ms} "
                f"({bound_by}) library_ms={library_ms} (torch.addmm) plain_ms={plain_ms}")
        del a, b, bias, res
        torch.cuda.empty_cache()
    return times


# The int8 GEMM (csrc/gemm_int8.cu) at the shapes of the main paths: the
# four products of an encoder block at B=256 (A's int8 form, B, H and I on
# 256 x 197 rows, with the serving encoder's sigmoid GELU) and the decode
# step's at B=32 and 256 (J's q|k|v and K's q, f32 out; J's and K's o; B's
# step form with the erf GELU), in the mode each path uses; fc1's product
# with no GELU, in f32 and in bf16 (what the GELU and what the f32 bytes
# cost its epilogue); then the encoder's four at ragged row counts (one
# row, a partial 64-row tile, one crop), held only.
INT8_ENCODER_PRODUCTS = (("qkv", 2304, 768, "bf16"), ("o", 768, 768, "residual"),
                         ("fc1", 3072, 768, "gelu_sigmoid"), ("fc2", 768, 3072, "residual"))
INT8_GEMM_SHAPES = [(f"{name} M={m}", m, n, k, mode) for m in (256 * 197,)
                    for name, n, k, mode in INT8_ENCODER_PRODUCTS] + \
    [(f"step {name} M={m}", m, n, k, mode) for m in (32, 256)
     for name, n, k, mode in (("qkv", 2304, 768, "f32"), ("q", 768, 768, "f32"),
                              ("o", 768, 768, "residual"), ("fc1", 3072, 768, "gelu_erf"),
                              ("fc2", 768, 3072, "residual"))] + \
    [(f"fc1[{mode}] M=50432", 256 * 197, 3072, 768, mode) for mode in ("f32", "bf16")]
INT8_GEMM_RAGGED = [(f"{name} M={m}", m, n, k, mode) for m in (1, 17, 197)
                    for name, n, k, mode in INT8_ENCODER_PRODUCTS]
# The GELU modes compute expf and a division, whose last bit may differ
# between the kernel's and PyTorch's builds of them: held to a few f32 ulps
# of the largest output.  The other modes must be bit for bit.
INT8_GELU_REL = 2.0**-20


def int8_gemm_inputs(m: int, n: int, k: int, mode: str, gen):
    """a [M, K], b_t [N, K] (int8 over the whole range, as row-quantized
    activations and weights are), sx, sw, bias, the epilogue code and the
    residual (None unless ``mode`` is "residual") of one int8 GEMM shape."""
    import torch

    from manga_ocr_tpu_torch.kernels import launch

    code = {"bf16": launch.GEMM_BF16, "gelu_sigmoid": launch.GEMM_GELU_F32,
            "residual": launch.GEMM_RESIDUAL_BF16, "f32": launch.GEMM_F32,
            "gelu_erf": launch.GEMM_GELU_ERF_F32}[mode]
    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)

    a, b_t = ints(m, k), ints(n, k)
    sx = (torch.rand((m,), generator=gen, device="cuda") + 0.5) * (4.0 / 127)
    sw = (torch.rand((n,), generator=gen, device="cuda") + 0.5) * (4 * WEIGHT_STD / 127)
    bias = torch.randn((n,), generator=gen, device="cuda") * 0.1
    res = (torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)
           if mode == "residual" else None)
    return a, b_t, sx, sw, bias, code, res


def hold_int8_gemm(label: str, args: tuple, mode: str) -> float:
    """The int8 GEMM against int8_gemm_reference on the same inputs: bit for
    bit, or within INT8_GELU_REL for the GELU modes; returns the largest
    difference."""
    import torch

    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops.fused_mlp import int8_gemm_reference

    got, want = launch.int8_gemm(*args), int8_gemm_reference(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.isfinite(got.float()).all():
        fail(f"int8 GEMM {label}: {got.dtype} {tuple(got.shape)} or non-finite output")
    exact = torch.equal(got, want)
    max_abs = float((got.float() - want.float()).abs().max())
    if not exact and (not mode.startswith("gelu") or
                      max_abs > INT8_GELU_REL * float(want.float().abs().max())):
        fail(f"int8 GEMM {label} {mode}: differs from its plain version by up to {max_abs}")
    del got, want
    return max_abs


def int8_gemm_times(check: bool = False) -> dict:
    """Device ms (CUDA graph) of the int8 GEMM alone at each
    INT8_GEMM_SHAPES shape, through ``launch.int8_gemm`` (whose signature
    every tree shares).  With ``check``, also holds it against
    int8_gemm_reference there and at INT8_GEMM_RAGGED, and logs its TOP/s
    and share of the int8 peak, its bound, the plain version's time and one
    torch._int_mm call's (the int32 product alone, on the same operands) as
    the library yardstick (timed only; the port never calls it)."""
    import torch

    from manga_ocr_tpu_torch.kernels import launch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    times = {}
    for label, m, n, k, mode in INT8_GEMM_SHAPES + (INT8_GEMM_RAGGED if check else []):
        a, b_t, sx, sw, bias, code, res = int8_gemm_inputs(m, n, k, mode, gen)
        args = (a, b_t, sx, sw, bias, code, res)
        max_abs = hold_int8_gemm(label, args, mode) if check else None
        if (label, m, n, k, mode) in INT8_GEMM_RAGGED:
            log(f"int8 GEMM {label} N={n} K={k} {mode}: max_abs_err={max_abs}")
            continue
        reps = 10 if m > 4096 else 50
        ms = times[label] = graph_ms(lambda: launch.int8_gemm(*args), reps)
        if check:
            from manga_ocr_tpu_torch.ops.fused_mlp import int8_gemm_reference

            plain_ms = cuda_ms(lambda: int8_gemm_reference(*args))
            library_ms = None
            if m > 16:  # torch._int_mm takes M > 16
                b_kn = b_t.t()
                try:
                    torch._int_mm(a, b_kn)
                except RuntimeError:  # a layout it refuses: its own copy, not timed
                    b_kn = b_kn.contiguous()
                library_ms = graph_ms(lambda: torch._int_mm(a, b_kn), reps)
            bound_ms, bound_by = bound(*cost_int8_gemm(m, n, k, mode))
            tops = 2 * m * n * k / ms / 1e9
            log(f"int8 GEMM {label} N={n} K={k} {mode}: max_abs_err={max_abs} ms={ms} "
                f"TOP/s={tops} ({tops / 1979:.3f} of the int8 peak) bound_ms={bound_ms} "
                f"({bound_by}) library_ms={library_ms} (torch._int_mm) plain_ms={plain_ms}")
        del a, b_t, sx, sw, bias, res, args
        torch.cuda.empty_cache()
    return times


def cost_int8_gemm(m, n, k, mode):  # a, b_t, scales, bias (and residual) in, out once
    out = 2 if mode in ("bf16", "residual") else 4
    return (m * k + n * k + m * 4 + n * 8 + m * n * (out + (2 if mode == "residual" else 0)),
            {"int8": 2 * m * n * k})


def device_ms_by_kernel(prof) -> list:
    """(kernel name, device ms, launches) of a torch.profiler run, largest
    first: the device's own events only (kernels, copies), not the host
    operators that launched them."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def log_profile(label: str, prof) -> None:
    rows = device_ms_by_kernel(prof)
    if not rows:
        log(f"profile {label}: the trace shows no device time")
        return
    total = sum(ms for _, ms, _ in rows)
    log(f"profile {label}: device ms {total} in {len(rows)} kernels; by kernel (ms, share, "
        f"launches):")
    for name, ms, n in rows[:12]:
        log(f"  {ms:10.4f} ms  {ms / total:6.1%}  {n:6d}  {name[:110]}")


def traced(label: str, fn) -> None:
    """``fn`` once to warm, then once under torch.profiler, printed as
    device ms by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    log_profile(label, prof)


def profile_split() -> None:
    """torch.profiler traces, each printed as device ms by kernel name: one
    H bf16 layer at B=256; one A int8 call and one B call at B=256 on the
    int8 serving encoder's weights, prepared as the encoder reads them; and
    the largest dispatch of a 256-crop page (preprocess, encoder, cross-K/V
    and decode) on the bf16 and the int8 engine and on the int8 engine with
    attn_sdpa_int8 + fuse_cross_kv."""
    import torch

    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig, with_serving_kernels
    from manga_ocr_tpu_torch.models.params import init_params, layer_params
    from manga_ocr_tpu_torch.models.quantize import quantize_encoder
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.ops import flash_attention as fa
    from manga_ocr_tpu_torch.ops import fused_mlp as fm
    from manga_ocr_tpu_torch.ops import preprocess as pp
    from manga_ocr_tpu_torch.ops.encoder_weights import layer_view, prepare_layers
    from manga_ocr_tpu_torch.parallel import batching

    cfg = MangaOCRConfig.base()
    ecfg = with_serving_kernels(cfg, quantized=True).encoder
    raw = init_params(cfg, SEED, "cuda", std=WEIGHT_STD)["encoder"]
    layers = mdl.cast_params(raw, torch.bfloat16)["layers"]
    lp, lw = layer_params(layers, 0), layer_view(prepare_layers(layers, torch.bfloat16), 0)
    b, s, d = 256, ecfg.seq_len, ecfg.hidden_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    scratch = launch.encoder_scratch(b * s, d, ecfg.intermediate_size, False, "cuda")
    traced("H bf16 layer B=256", lambda: fa.fused_encoder_layer(
        x, lp, ecfg.num_heads, ecfg.layer_norm_eps, "erf", lw, scratch))
    del layers, lp, lw, scratch

    enc = _cast_quantized(quantize_encoder(raw, quantize_attn_proj=True),
                          torch.bfloat16)["layers"]
    attn = {k: {n: t[0] for n, t in v.items()} for k, v in enc["attn"].items()}
    lw = layer_view(prepare_layers(enc, torch.bfloat16), 0)
    ln1 = (enc["ln1"]["scale"][0], enc["ln1"]["bias"][0])
    ln2 = (enc["ln2"]["scale"][0], enc["ln2"]["bias"][0])
    mlp_w = (lw.fc1.w, enc["mlp"]["fc1"]["bias"][0], lw.fc2.w, enc["mlp"]["fc2"]["bias"][0])
    eps = ecfg.layer_norm_eps
    traced("A int8 B=256", lambda: fa.fused_attn_layer(
        x, attn, *ln1, ecfg.num_heads, eps=eps, valid_len=s, prepared=(lw.qkv, lw.o)))
    traced("B B=256", lambda: fm.fused_mlp_block(x, *ln2, *mlp_w, eps=eps,
                                                 gelu_mode=ecfg.gelu_mode))
    del raw, enc, attn, lw, mlp_w, x

    crops = load_crops()
    page = [crops[i % len(crops)] for i in range(256)]
    bt = max(batching.prep_page_gray(page, pp.ORIENT_VERTICAL), key=lambda t: t.crops.shape[0])
    crops_d, sizes = torch.from_numpy(bt.crops).cuda(), torch.from_numpy(bt.sizes).cuda()
    for form, c, quantize in (("bf16", cfg, False), ("int8", cfg, True),
                              ("int8 sdpa_int8+fuse_kv", slice_config(), True)):
        engine = TorchMangaOcrEngine(init_params(cfg, SEED, "cpu", std=WEIGHT_STD), c,
                                     CharTokenizer.synthetic(), device="cuda",
                                     quantize_int8=quantize)

        def dispatch():
            with torch.inference_mode():
                px = pp.model_preprocess(crops_d, sizes, ecfg.image_size).to(engine.dtype)
                return mdl.ocr_forward(engine.params, px, engine.cfg, engine.max_length).lengths
        traced(f"{form} engine dispatch B={bt.crops.shape[0]}", dispatch)
        del engine
        torch.cuda.empty_cache()


def slice_config():
    """MangaOCRConfig.base() with kernel A's int8 SDPA (attn_sdpa_int8) and
    kernel C's fuse_kv form (fuse_cross_kv): the int8 engine of phase 6."""
    import dataclasses

    from manga_ocr_tpu_torch.models.config import MangaOCRConfig

    cfg = MangaOCRConfig.base()
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, attn_sdpa_int8=True),
        decoder=dataclasses.replace(cfg.decoder, fuse_cross_kv=True))


def engine_rates() -> dict:
    """crops/s of the int8 and the bf16 engine, and of the int8 engine with
    attn_sdpa_int8 + fuse_cross_kv, on one 256-crop page."""
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    cfg = MangaOCRConfig.base()
    crops = load_crops()
    params = init_params(cfg, SEED, "cpu", std=WEIGHT_STD)
    rates = {}
    for form, c, quantize in (("int8", cfg, True), ("bf16", cfg, False),
                              ("int8 sdpa_int8+fuse_kv", slice_config(), True)):
        engine = TorchMangaOcrEngine(params, c, CharTokenizer.synthetic(), device="cuda",
                                     quantize_int8=quantize)
        engine.ocr_page(crops[:2])
        rates[form] = page_rate(engine, crops, f"{form} engine")
        del engine
    return rates


def decode_times() -> dict:
    """Kernel C at B=256, 299 steps, bf16 decoder weights, on a random raw
    encoder output and final LN: CUDA-event ms (mean of 2 after a warm run)
    of the serving form over precomputed slabs (also on their first 32
    rows), the fuse_kv form, final LN
    + precompute_cross_kv_packed + the serving form (the unfused path), and
    the int8_w form (quantize_decoder weights) over the same slabs; then one
    profiled fuse_kv decode, printed as device ms by kernel.  Then int8_w
    with fuse_kv.  Only entry points every tree shares (each tree routes
    the int8 forms its own way)."""
    import torch

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder
    from manga_ocr_tpu_torch.ops import common
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    cfg = MangaOCRConfig.base()
    dcfg, s, d = cfg.decoder, cfg.encoder.seq_len, cfg.encoder.hidden_size
    steps, batch, eps = cfg.max_length - 1, 256, cfg.decoder.layer_norm_eps
    raw = init_params(cfg, SEED, "cuda", std=WEIGHT_STD)["decoder"]
    p = mdl.cast_params(raw, torch.bfloat16)
    q = _cast_quantized(quantize_decoder(raw), torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    enc_raw = (2 * torch.randn((batch, s, d), generator=gen, device="cuda") + 0.5)
    enc_raw = enc_raw.to(torch.bfloat16)
    fln = {"scale": 1 + 0.1 * torch.randn(d, generator=gen, device="cuda"),
           "bias": 0.1 * torch.randn(d, generator=gen, device="cuda")}
    fuse = dict(enc_raw=enc_raw, s_valid=s, enc_final_ln=fln)

    def slabs(params):
        return dec.precompute_cross_kv_packed(
            params, common.layer_norm(enc_raw, fln["scale"], fln["bias"], eps), dcfg, int8=False)

    cross = slabs(p)
    cross32 = dec.CrossKVPacked(cross.k[:, :32].contiguous(), cross.v[:, :32].contiguous())
    times = {"C serving B=32": cuda_ms(lambda: dl.greedy_decode_loop(p, cross32, dcfg, steps),
                                       reps=2)}
    runs = {"serving": lambda: dl.greedy_decode_loop(p, cross, dcfg, steps),
            "fuse_kv": lambda: dl.greedy_decode_loop(p, None, dcfg, steps, **fuse),
            "unfused (final LN + precompute + serving)":
                lambda: dl.greedy_decode_loop(p, slabs(p), dcfg, steps),
            "int8_w": lambda: dl.greedy_decode_loop(q, cross, dcfg, steps),
            "int8_w + fuse_kv": lambda: dl.greedy_decode_loop(q, None, dcfg, steps, **fuse)}
    times.update({f"C {name} B={batch}": cuda_ms(fn, reps=2) for name, fn in runs.items()})
    traced(f"C fuse_kv B={batch}", runs["fuse_kv"])
    return times


def head_decode_times() -> dict:
    """Kernel F alone at B=32 and 256 (CUDA-graph device ms, and one
    torch.profiler split by kernel, printed), on the bf16 head of the random
    model; then the two decodes that launch it on a random encoder output:
    the step-by-step decode (F and D, 100 steps) at B=32 and the fused_layer
    decode (J, K, B's step form and F; 299 steps, quantize_decoder
    weights) at B=32 and 256 (the B=32 rows repeated), each after a warm
    run: the median of three CUDA-event times
    (host-bound: eager launches), the device ms of one profiled run (the
    kernels' own time, also printed by kernel) and its ln_quant_rows
    launches.  Only entry points every tree shares."""
    import dataclasses
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder
    from manga_ocr_tpu_torch.ops import fused_head as fh

    cfg = MangaOCRConfig.base()
    dcfg = cfg.decoder
    raw = init_params(cfg, SEED, "cuda", std=WEIGHT_STD)["decoder"]
    dec = mdl.cast_params(raw, torch.bfloat16)
    t, p = dec["head"]["transform"], dec["head"]["proj"]
    head_w = (t["dense"]["kernel"], t["dense"]["bias"], t["ln"]["scale"], t["ln"]["bias"],
              p["kernel"], p["bias"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    times = {}
    for batch in (32, 256):
        h = torch.randn((batch, dcfg.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
        times[f"F B={batch}"] = graph_ms(
            lambda: fh.fused_greedy_head(h, *head_w, eps=dcfg.layer_norm_eps), 50)
        traced(f"F B={batch}", lambda: fh.fused_greedy_head(h, *head_w, eps=dcfg.layer_norm_eps))
    enc = torch.randn((32, cfg.encoder.seq_len, cfg.encoder.hidden_size), generator=gen,
                      device="cuda").to(torch.bfloat16)
    enc256 = enc.repeat(8, 1, 1)
    step = dataclasses.replace(cfg, decoder=dataclasses.replace(
        dcfg, step_kernel="xla", head_kernel="fused", step_mlp_kernel="fused",
        cross_kv_int8=True, head_phased=False))
    fused = dataclasses.replace(cfg, decoder=dataclasses.replace(
        dcfg, step_kernel="fused_layer", head_kernel="fused", cross_kv_int8=True))
    qdec = _cast_quantized(quantize_decoder(raw), torch.bfloat16)
    for label, params, c, max_len, e in (
            ("step decode B=32", dec, step, STEP_DECODE_LEN, enc),
            ("fused_layer decode B=32", qdec, fused, cfg.max_length, enc),
            ("fused_layer decode B=256", qdec, fused, cfg.max_length, enc256)):
        def run():
            with torch.inference_mode():
                return mdl.greedy_decode({"decoder": params}, e, c, max_len, 8)

        run()  # warm
        wall = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = run()
            ev[1].record()
            torch.cuda.synchronize()
            wall.append(ev[0].elapsed_time(ev[1]))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        log_profile(label, prof)
        times[label] = statistics.median(wall)
        rows = device_ms_by_kernel(prof)
        times[label + " device"] = sum(ms for _, ms, _ in rows)
        times[label + " ln_quant_rows launches"] = sum(n for name, _, n in rows
                                                       if "ln_quant_rows" in name)
        times[label + " mean length"] = float(out.lengths.float().mean())
    return times


def compare_child() -> dict:
    """What ``--gemm-times`` reads of one tree: both GEMMs' times, kernels
    J's and K's cores alone, kernel F's and its decodes' times, kernel C's
    forms' times, the three engines' page rates, and the profiler split
    (printed)."""
    times = gemm_times()
    int8_times = int8_gemm_times()
    core_ms = step_core_times()
    head_times = head_decode_times()
    c_times = decode_times()
    rates = engine_rates()
    profile_split()
    return {"gemm_ms": times, "int8_gemm_ms": int8_times, "step_core_ms": core_ms,
            "head_ms": head_times,
            "decode_ms": c_times, "crops_per_s": rates}


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


def cost_cross_step(b, s, d, int8_w, int8_kv):  # K: the slabs' s live keys once
    kv = 2 * b * s * d * (1 if int8_kv else 2) + ((b * s + b * d) * 4 if int8_kv else 0)
    proj = {"int8" if int8_w else "bf16": 2 * b * 2 * d * d}
    attn = 2 * 2 * b * s * d
    return (2 * b * d * 2 + kv + 2 * d * d * (1 if int8_w else 2),
            {**proj, "bf16": proj.get("bf16", 0) + attn})


def cost_self_core(b, d, step, out_row):  # J's core: q|k|v in, live rows, new rows, ctx out
    return (b * 3 * d * 4 + 2 * step * b * d * 2 + 2 * b * d * 2 + b * out_row,
            {"bf16": 2 * 2 * b * (step + 1) * d})


def cost_cross_core(b, n, d, kv_bytes, out_row):  # K's core: q, the n live keys, ctx out
    scales = (b * n + b * d) * 4 if kv_bytes == 1 else 0
    return (b * d * 4 + 2 * b * n * d * kv_bytes + scales + b * out_row,
            {"bf16": 2 * 2 * b * n * d})


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
    and 256, on bf16 params; first F's ptxas lines."""
    import torch
    import torch.nn.functional as F

    from manga_ocr_tpu_torch.kernels import build
    from manga_ocr_tpu_torch.ops import flash_attention as fa
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    log_head_ptxas(build.last_build_log)

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

        results["fused_greedy_head"] = check_head(randn(batch, dcfg.hidden_size), head_w, dcfg)


# Kernel F's planted ties at full width (zero weight columns, one large
# bias): inside one 64-column slot, across two slots of one 256-column tile,
# across tiles of the vocab product and the JAX kernel's 512-column tiles.
HEAD_TIES = ([40, 9], [200, 140], [5000, 300, 6143])


def check_head(h, head_w, dcfg) -> dict:
    """Kernel F on rows ``h`` [B, 768] against its plain version: every id
    within HEAD_GAP_REL of the plain top logit, the planted ties exactly at
    their lowest column; the kernel's and the plain version's times, the
    bound, and one torch.addmm of the [B, 768] x [768, 6144] vocab product
    as a yardstick (a part of F's function only: no library time)."""
    import torch

    from manga_ocr_tpu_torch.ops import fused_head as fh

    batch, eps = h.shape[0], dcfg.layer_norm_eps
    ids = fh.fused_greedy_head(h, *head_w, eps=eps)
    logits = fh.head_logits_reference(h, *head_w, eps=eps)
    torch.cuda.synchronize()
    if ids.shape != (batch,) or int(((ids < 0) | (ids >= dcfg.vocab_size)).sum()):
        fail(f"fused_greedy_head B={batch}: bad ids")
    top = logits.amax(-1)
    gap = top - logits.gather(1, ids.long()[:, None])[:, 0]
    rel = float((gap / top.abs()).max())
    same = float((ids.long() == logits.argmax(-1)).float().mean())
    if rel > HEAD_GAP_REL:
        fail(f"fused_greedy_head B={batch}: an id {rel} below the top logit "
             f"(bound {HEAD_GAP_REL})")
    wt, bt, lns, lnb, wp, bp = head_w
    for ties in HEAD_TIES:
        wp_t, bp_t = wp.clone(), bp.clone()
        wp_t[:, ties] = 0
        bp_t[ties] = 1000.0
        got = fh.fused_greedy_head(h, wt, bt, lns, lnb, wp_t, bp_t, eps=eps)
        if got.tolist() != [min(ties)] * batch:
            fail(f"fused_greedy_head B={batch}: ties planted at {ties} gave ids "
                 f"{sorted(set(got.tolist()))}, not {min(ties)}")
        del wp_t, bp_t
    ms = cuda_ms(lambda: fh.fused_greedy_head(h, *head_w, eps=eps))
    plain_ms = cuda_ms(lambda: fh.fused_greedy_head_reference(h, *head_w, eps=eps))
    hid = fh.head_hidden_reference(h, wt, bt, lns, lnb, eps).to(torch.bfloat16)
    wp16, bp16 = wp.to(torch.bfloat16), bp.to(torch.bfloat16)
    addmm_ms = cuda_ms(lambda: torch.addmm(bp16, hid, wp16))
    bound_ms, bound_by = bound(*cost_head(batch, dcfg.hidden_size, dcfg.vocab_size))
    log(f"fused_greedy_head B={batch}: max gap {float(gap.max())} (rel {rel}), ids equal "
        f"to the plain argmax {same}, planted ties {list(HEAD_TIES)} at their lowest id; "
        f"ms={ms} plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by}); yardstick: "
        f"torch.addmm of the vocab product alone {addmm_ms} ms")
    return {"max_abs_err": float(gap.max()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# Kernel J's steps held on the card (j_steps): the first two, both sides
# of its core's first two chunk edges (its ring of two stages wraps at the
# second), the middle and the last of a 299-step decode's 305-row cache.
J_TIMED_STEPS = (0, 150, 303)  # the kernels line's J: the mean over these
K_RAGGED = 150  # K's ragged s_valid (of 197)


def check_step_kernels(params, params_bf16, cfg, results: dict) -> None:
    """Kernels J, K and B's post-LN step form against their plain versions
    at batch 32 and 256, on the int8 decoder (quantize_decoder) with int8
    cross-K/V and on the bf16 decoder with bf16 slabs.  J at j_steps of the
    305-row cache of a 299-step decode in chunks of 8 (rows past ``step``
    hold noise, which must weigh nothing), with the cache row it writes
    held against the plain version's; K at s_valid 197 and K_RAGGED.  On
    the int8 decoder each core's int8 context (the out projection's input)
    equals ln_quant_rows of the same core's f32 context bit for bit."""
    import torch

    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.ops import common
    from manga_ocr_tpu_torch.ops import decode_layer as dl
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    dcfg = cfg.decoder
    d, heads, eps, inter = dcfg.hidden_size, dcfg.num_heads, dcfg.layer_norm_eps, \
        dcfg.intermediate_size
    s_enc, scale = cfg.encoder.seq_len, (d // heads) ** -0.5
    t_len = 1 + -(-(cfg.max_length - 1) // 8) * 8
    if t_len - 2 != J_TIMED_STEPS[-1]:
        fail(f"J's last step {t_len - 2} is not J_TIMED_STEPS' {J_TIMED_STEPS[-1]}")
    c = launch.attn_step_plan(32, heads, d // heads, t_len, 2, True)["chunk"]
    j_steps = sorted({s for s in (0, 1, c - 1, c, c + 1, 2 * c - 1, 2 * c, 2 * c + 1)
                      if s <= t_len - 2} | set(J_TIMED_STEPS))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    one, zero = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def int8_epilogue(label, core, *args):
        ctx = core(*args, torch.float32)
        hq, sx = core(*args, torch.int8)
        want_q, want_sx = launch.ln_quant_rows(ctx)
        if not (torch.equal(hq, want_q) and torch.equal(sx, want_sx)):
            fail(f"{label}: the int8 context differs from ln_quant_rows of the f32 context")

    for batch in (32, 256):
        enc = torch.randn((batch, s_enc, d), generator=gen, device="cuda")
        enc = common.layer_norm(enc, one, zero, 1e-12).to(torch.bfloat16)
        for form, p in (("int8", params), ("bf16", params_bf16)):
            int8 = form == "int8"
            tag = f"{form} B={batch}"
            w = dec.prepare_fused_layer(p["decoder"], dcfg, torch.bfloat16)[0]
            ck, cv = randn(t_len, batch, d), randn(t_len, batch, d)
            pck, pcv = ck.clone(), cv.clone()
            recs = {}
            for step in j_steps:
                x = randn(batch, d)
                recs[step] = hold(
                    "fused_self_attn_step", f"{tag} step={step}",
                    lambda: dl.fused_self_attn_step(x, w["self"], w["self_ln"], ck, cv, step,
                                                    heads, eps)[0],
                    lambda: dl.fused_self_attn_step_reference(x, w["self"], w["self_ln"], pck,
                                                              pcv, step, heads, eps)[0],
                    cost_self_step(batch, d, step, int8))
                row_err = [compare("fused_self_attn_step", f"{tag} cache {n} row {step}", a[step],
                                   b[step])[0] for n, a, b in (("k", ck, pck), ("v", cv, pcv))]
                log(f"fused_self_attn_step {tag} step={step}: written cache rows k/v max_abs_err "
                    f"{row_err}")
                if int8:
                    int8_epilogue(f"J core {tag} step={step}", launch.self_attn_step,
                                  dl._proj_in(x, w["self"]["qkv"]), ck.clone(), cv.clone(),
                                  heads, step, scale)
            timed = [recs[step] for step in J_TIMED_STEPS]
            j = {key: sum(r[key] for r in timed) / len(timed)
                 for key in ("ms", "plain_ms", "bound_ms")}
            j.update(max_abs_err=max(r["max_abs_err"] for r in recs.values()),
                     bound_by=timed[-1]["bound_by"], library_ms=None)
            log(f"fused_self_attn_step {tag}: mean over steps {J_TIMED_STEPS}: {j}")

            cross = dec.precompute_cross_kv_packed(p["decoder"], enc, dcfg, int8=int8)
            ks, vs = (cross.k_scale[0], cross.v_scale[0]) if int8 else (None, None)
            x = randn(batch, d)
            for s_valid in (s_enc, K_RAGGED):
                k = hold("fused_cross_attn_step", f"{tag} s_valid={s_valid}",
                         lambda: dl.fused_cross_attn_step(x, w["cross"], w["cross_ln"],
                                                          cross.k[0], cross.v[0], ks, vs, heads,
                                                          eps, s_valid),
                         lambda: dl.fused_cross_attn_step_reference(
                             x, w["cross"], w["cross_ln"], cross.k[0], cross.v[0], ks, vs, heads,
                             eps, s_valid),
                         cost_cross_step(batch, s_valid, d, int8, int8))
                if int8:
                    int8_epilogue(f"K core {tag} s_valid={s_valid}", launch.cross_attn_step,
                                  dl._proj_in(x, w["cross"]["q"]), cross.k[0], cross.v[0], ks, vs,
                                  heads, s_valid, scale)
                if s_valid == s_enc:
                    k_full = k

            rows = randn(batch, d)
            args = (rows, w["mlp_ln"]["scale"], w["mlp_ln"]["bias"], w["w1"], w["b1"], w["w2"],
                    w["b2"])
            plain = fm.fused_mlp_block_reference if int8 else fm.fused_mlp_block_bf16_reference
            kw = dict(eps=eps, pre_ln=False, post_ln=True)
            mlp = hold("fused_mlp_block", f"step form (post-LN) {tag}",
                       lambda: fm.fused_mlp_block(*args, **kw), lambda: plain(*args, **kw),
                       (cost_mlp_int8 if int8 else cost_mlp_bf16)(batch, d, inter))
            if int8:
                results["fused_self_attn_step"], results["fused_cross_attn_step"] = j, k_full
                results["fused_mlp_block[step]"] = mlp
    log("J and K cores: every int8 context equal to ln_quant_rows of the f32 context, bit for "
        "bit")


def step_core_times() -> dict:
    """Kernels J's and K's attention cores alone at full width (8 heads of
    dh 96, D 768) at B=32 and 256: CUDA-graph device ms through the
    launchers every tree shares (launch.self_attn_step, cross_attn_step),
    J the mean over J_TIMED_STEPS of a 305-row cache, K over the 197 keys
    of int8 and of bf16 slabs, by output: f32 (every tree), the int8
    context (None where the tree's core has no such output) and bf16.
    Each beside its bytes bound; as a yardstick, one
    scaled_dot_product_attention call on the bf16 form's inputs (it rounds
    q to bf16: not the same function).  Printed; returns the ms."""
    import statistics

    import torch
    import torch.nn.functional as F

    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig

    cfg = MangaOCRConfig.base()
    d, heads, s = cfg.decoder.hidden_size, cfg.decoder.num_heads, cfg.encoder.seq_len
    dh, t_len = d // heads, 1 + -(-(cfg.max_length - 1) // 8) * 8
    scale = dh**-0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    outs = (("f32", torch.float32, 4 * d), ("int8", torch.int8, d + 4),
            ("bf16", torch.bfloat16, 2 * d))

    def device_ms(fn):
        try:
            return graph_ms(fn, 20)
        except ValueError:  # a tree whose core does not write this output
            return None

    times = {}
    for b in (32, 256):
        qkv = torch.randn((b, 3 * d), generator=gen, device="cuda")
        ck, cv = (torch.randn((t_len, b, d), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        for out, dtype, row in outs:
            ms = [device_ms(lambda: launch.self_attn_step(qkv, ck, cv, heads, step, scale, dtype))
                  for step in J_TIMED_STEPS]
            bnd = statistics.mean(bound(*cost_self_core(b, d, step, row))[0]
                                  for step in J_TIMED_STEPS)
            times[f"J core {out} B={b}"] = None if None in ms else statistics.mean(ms)
            log(f"J core alone, {out} context, B={b}: device ms {ms} (mean "
                f"{times[f'J core {out} B={b}']}), bound {bnd} (bytes)")
        q = qkv[:, :d].to(torch.bfloat16).view(b, heads, 1, dh)
        sdpa = [graph_ms(lambda: F.scaled_dot_product_attention(
            q, *(c[:step + 1].view(step + 1, b, heads, dh).permute(1, 2, 0, 3)
                 for c in (ck, cv))), 20) for step in J_TIMED_STEPS]
        times[f"J yardstick SDPA B={b}"] = statistics.mean(sdpa)
        log(f"J yardstick: one scaled_dot_product_attention call (q rounded to bf16, the cache "
            f"rows t <= step), B={b}: device ms {sdpa}")

        qf = torch.randn((b, d), generator=gen, device="cuda")
        k8, v8 = (torch.randint(-127, 128, (b, s, d), generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks = torch.rand((b, s), generator=gen, device="cuda") * 0.02
        vs = torch.rand((b, d), generator=gen, device="cuda") * 0.02
        kb, vb = (torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        for slab, k, v, scales in (("int8", k8, v8, (ks, vs)), ("bf16", kb, vb, (None, None))):
            for out, dtype, row in outs:
                ms = device_ms(lambda: launch.cross_attn_step(qf, k, v, *scales, heads, s, scale,
                                                              dtype))
                times[f"K core {slab} slabs {out} B={b}"] = ms
                bnd = bound(*cost_cross_core(b, s, d, k.element_size(), row))[0]
                log(f"K core alone, {slab} slabs, {out} context, B={b}: device ms {ms}, bound "
                    f"{bnd} (bytes)")
        kt, vt = (t.view(b, s, heads, dh).transpose(1, 2) for t in (kb, vb))
        qb = qf.to(torch.bfloat16).view(b, heads, 1, dh)
        times[f"K yardstick SDPA B={b}"] = graph_ms(
            lambda: F.scaled_dot_product_attention(qb, kt, vt), 20)
        log(f"K yardstick: one scaled_dot_product_attention call on the bf16 slabs (q rounded to "
            f"bf16), B={b}: device ms {times[f'K yardstick SDPA B={b}']}")
    return times


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


def reread_floor(cfg, lengths, s) -> float:
    """The least time in ms the serving decode's K/V reads could take when
    no cache holds them (the slabs alone are 310 MB at B=256): every
    row-step reads its row's cross slabs (layers x K, V x s x D bf16) and
    its live self cache (layers x K, V x (t + 1) x D bf16), at the memory
    rate, for the row-steps this run's rows needed."""
    d, n_l = cfg.hidden_size, cfg.num_layers
    n = lengths.long() - 1  # steps each row ran
    row_steps = int(n.sum())
    cache_keys = int((n * (n + 1) // 2).sum())
    nbytes = n_l * 2 * d * 2 * (row_steps * s + cache_keys)
    return nbytes / H100_BYTES_PER_S * 1e3


# The cluster kernels' instances by (mangled) name: bf16 and int8_w, each
# also profiled (kProf).
CLUSTER_INSTANCES = {"decode_cluster_kernelILb0E": "serving (bf16)",
                     "decode_cluster_kernelILb1E": "bf16 profiled",
                     "decode_cluster_i8_kernelILb0E": "int8_w",
                     "decode_cluster_i8_kernelILb1E": "int8_w profiled"}


def log_cluster_ptxas(build_log: str) -> None:
    """The cluster kernels' ptxas lines (registers, stack, spill bytes) of
    their four instances (bf16 and int8_w, each also profiled) and of the
    phases they call apart (projections bf16 and s8, vocab argmax,
    attention, the int8 row passes).  A record: the body runs at the
    128-register cap of its 512 threads and spills a little (PERF.md)."""
    import re

    name = ""
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'|Function properties for (\S+)", ln)
        if m:
            name = m.group(1) or m.group(2)
            continue
        if "decode_cluster_cu" in name and ("spill" in ln or "registers" in ln):
            short = re.sub(r".*decode_cluster_cu_\w{8}", "", name)[:40]
            inst = next((v for k, v in CLUSTER_INSTANCES.items() if k in name), "")
            log(f"ptxas: cluster kernel {short}{f' [{inst}]' if inst else ''}: {ln.strip()}")


def check_decode_kernel(params, cfg, results: dict) -> None:
    """Kernel C's serving form (bf16 weights, precomputed slabs) on the
    cluster kernel against its plain version at B=32, a ragged B=40 and
    B=256, steps=299, teacher-forced within DECODE_GAP_REL; the present
    kernel's serving form (kernel="loop") on the same inputs, held to the
    same bound and timed beside it; the grid (clusters launched and seated,
    rows a tile), the bound and the slab and cache re-read floor; at B=256
    the cluster kernel's stage split (its profiled instance)."""
    import torch

    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.ops import common
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    dcfg = cfg.decoder
    steps = cfg.max_length - 1
    s_len = cfg.encoder.seq_len
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    d = cfg.encoder.hidden_size
    one, zero = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    for batch in (32, 40, 256):
        enc = torch.randn((batch, s_len, d), generator=gen, device="cuda")
        enc = common.layer_norm(enc, one, zero, 1e-12).to(torch.bfloat16)
        cross = dec.precompute_cross_kv_packed(params["decoder"], enc, dcfg, int8=False)
        recs, grids = {}, {}
        for kernel in ("cluster", "loop"):
            recs[kernel] = hold_decode(
                f"greedy_decode_loop[{kernel}]", f"B={batch}",
                lambda: dl.greedy_decode_loop(params["decoder"], cross, dcfg, steps, kernel=kernel),
                lambda: dl.greedy_decode_loop_reference(params["decoder"], cross, dcfg, steps),
                params["decoder"], cross, dcfg,
                lambda lens: cost_decode_loop(dcfg, lens, s_len))
            grids[kernel] = dict(dl.greedy_decode_loop.last_grid)
        lens = dl.greedy_decode_loop(params["decoder"], cross, dcfg, steps)[1]
        floor = reread_floor(dcfg, lens, s_len)
        log(f"greedy_decode_loop serving form B={batch}: cluster kernel {recs['cluster']['ms']} ms "
            f"(grid {grids['cluster']}), present kernel {recs['loop']['ms']} ms (grid "
            f"{grids['loop']}): {recs['loop']['ms'] / recs['cluster']['ms']:.3f}x; bound "
            f"{recs['cluster']['bound_ms']} ms ({recs['cluster']['bound_by']}), slab and cache "
            f"re-read floor {floor} ms, on {card_line()}")
        if batch == 256:
            results["greedy_decode_loop[cluster]"] = recs["cluster"]
            clocks = dl.cluster_stage_clocks(params["decoder"], cross, dcfg, steps)
            total = sum(clocks.values())
            log(f"greedy_decode_loop[cluster] B={batch} stage split (first CTA's clocks, profiled "
                f"instance): { {k: round(v / total, 4) for k, v in clocks.items()} }, "
                f"{total / steps:.0f} clocks a step on {card_line()}")


# Kernel C's rows must not depend on the bucket's batch size: one 16-row
# tile (16), one wave of 16-row tiles (128, 240), a wave of wider tiles
# where the bucket needs more 16-row tiles than the card seats clusters
# and one wave of at most 32 rows a tile holds it (256: 18 rows on an
# H100, which seats 15 clusters of 8), and two waves of 16-row tiles
# where it does not (384).
C_INVARIANCE_BATCHES = (16, 128, 240, 256, 384)


def check_batch_invariance(decs: dict, fln: dict, dcfg, steps: int, s: int, d: int) -> None:
    """Kernel C's four cluster forms (serving, fuse_kv, int8_w, int8_w +
    fuse_kv) on the first B rows of one random raw encoder output at each B
    of C_INVARIANCE_BATCHES: every row's [lengths | tokens] must be
    bit-equal to the same row's at the largest B, and the grids must cover
    16-row tiles and tiles of more than 16 rows.  The serving and int8_w
    forms read slices of slabs precomputed once at the largest B, so that
    only the kernel's rows are compared."""
    import numpy as np
    import torch

    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.ops import common
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    top = max(C_INVARIANCE_BATCHES)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    enc_raw = (2 * torch.randn((top, s, d), generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
    enc = common.layer_norm(enc_raw, fln["scale"], fln["bias"], dcfg.layer_norm_eps)
    rows_seen = set()
    for form, weights, fuse in (("serving", "bf16", False), ("fuse_kv", "bf16", True),
                                ("int8_w", "int8_w", False), ("int8_w + fuse_kv", "int8_w", True)):
        p = decs[weights]
        cross = None if fuse else dec.precompute_cross_kv_packed(p, enc, dcfg, int8=False)
        mats, grids = {}, {}
        for b in C_INVARIANCE_BATCHES:
            if fuse:
                out = dl.greedy_decode_loop(p, None, dcfg, steps, enc_raw=enc_raw[:b], s_valid=s,
                                            enc_final_ln=fln)
            else:
                part = dec.CrossKVPacked(cross.k[:, :b].contiguous(), cross.v[:, :b].contiguous())
                out = dl.greedy_decode_loop(p, part, dcfg, steps)
            grids[b] = dict(dl.greedy_decode_loop.last_grid)
            if grids[b]["form"] != "cluster":
                fail(f"kernel C {form} B={b}: ran the {grids[b]['form']} kernel")
            rows_seen.add(grids[b]["rows_per_tile"])
            tokens, lengths = out
            mats[b] = torch.cat([lengths[:, None], tokens], dim=1).cpu().numpy()
        ref = mats[top]
        differ = {b: int((m != ref[:b]).any(axis=1).sum()) for b, m in mats.items()}
        log(f"kernel C {form}: rows differing from B={top}'s by B {differ}; grids "
            f"{ {b: grids[b] for b in C_INVARIANCE_BATCHES} }; median length "
            f"{float(np.median(ref[:, 0]))} on {card_line()}")
        if any(differ.values()):
            fail(f"kernel C {form}: a row's tokens depend on the batch size: {differ}")
    if not (16 in rows_seen and max(rows_seen) > 16):
        fail(f"kernel C batch invariance: tiles of {sorted(rows_seen)} rows; the check needs "
             f"16-row tiles and wider ones")


def check_decode_forms(raw, cfg, results: dict) -> None:
    """Kernel C's batch invariance (``check_batch_invariance``), then its
    int8_w and fuse_kv forms (and both together) against
    their plain versions at B=256, steps=299.  int8_w over precomputed
    slabs on the cluster kernel's int8 instance, and on the present kernel
    (kernel="loop") on the same inputs, both held (teacher-forced within
    DECODE_GAP_REL) and timed in this process, with both grids and the
    int8 instance's stage split (its profiled instance).  fuse_kv on a raw
    encoder output, scored by the unfused plain decoder over the slabs of
    its final LN (which is what fuse_kv computes), and timed beside final
    LN + precompute_cross_kv_packed + the unfused kernel on the same input;
    with bf16 and with int8 weights it runs the prologue (final LN row
    pass, the bf16 GEMM into the slabs) and the cluster kernel; the bf16
    form is also held and timed on the present kernel (kernel="loop"), and
    the prologue's own device time and the grid are printed.  Then C's
    int8_w and fuse_kv forms at B=512 with their grids, and the ablation
    split: the present kernel (bf16, slabs) with each stage skipped, every
    row running all 299 steps (EOS set past the vocab)."""
    import dataclasses

    import torch

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.kernels import launch
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
    check_batch_invariance(decs, fln, dcfg, steps, s, d)
    for form, p in decs.items():
        cross = dec.precompute_cross_kv_packed(p, enc, dcfg, int8=False)
        int8_w = form == "int8_w"
        if int8_w:
            recs, grids = {}, {}
            for kernel in ("auto", "loop"):
                recs[kernel] = hold_decode(
                    "greedy_decode_loop[int8_w" + (", kernel=loop]" if kernel == "loop" else "]"),
                    f"B={batch}",
                    lambda: dl.greedy_decode_loop(p, cross, dcfg, steps, kernel=kernel),
                    lambda: dl.greedy_decode_loop_reference(p, cross, dcfg, steps),
                    p, cross, dcfg, lambda lens: cost_decode_loop(dcfg, lens, s, int8_w=True))
                grids[kernel] = dict(dl.greedy_decode_loop.last_grid)
            if grids["auto"]["form"] != "cluster" or grids["loop"]["form"] != "loop":
                fail(f"greedy_decode_loop[int8_w]: ran the {grids['auto']['form']} kernel by "
                     f"default and the {grids['loop']['form']} one under kernel=loop")
            results["greedy_decode_loop[int8_w]"] = recs["auto"]
            log(f"greedy_decode_loop[int8_w] B={batch}: cluster kernel (int8 instance) "
                f"{recs['auto']['ms']} ms (grid {grids['auto']}), present kernel "
                f"{recs['loop']['ms']} ms (grid {grids['loop']}): "
                f"{recs['loop']['ms'] / recs['auto']['ms']:.3f}x; bound {recs['auto']['bound_ms']} "
                f"ms ({recs['auto']['bound_by']}) on {card_line()}")
            clocks = dl.cluster_stage_clocks(p, cross, dcfg, steps)
            total = sum(clocks.values())
            log(f"greedy_decode_loop[int8_w] B={batch} stage split (first CTA's clocks, profiled "
                f"int8 instance): { {k: round(v / total, 4) for k, v in clocks.items()} }, "
                f"{total / steps:.0f} clocks a step on {card_line()}")
        want_form = "cluster"
        rec = hold_decode(
            "greedy_decode_loop[fuse_kv]", f"{form} weights B={batch}",
            lambda: dl.greedy_decode_loop(p, None, dcfg, steps, **fuse),
            lambda: dl.greedy_decode_loop_reference(p, None, dcfg, steps, **fuse),
            p, cross, dcfg, lambda lens: cost_decode_loop(dcfg, lens, s, int8_w, fuse_kv=True))
        grid = dict(dl.greedy_decode_loop.last_grid)
        if grid["form"] != want_form:
            fail(f"greedy_decode_loop[fuse_kv] {form} weights: ran the {grid['form']} kernel, "
                 f"expected the {want_form} kernel")
        unfused_ms = cuda_ms(lambda: dl.greedy_decode_loop(
            p, dec.precompute_cross_kv_packed(
                p, common.layer_norm(enc_raw, fln["scale"], fln["bias"], dcfg.layer_norm_eps),
                dcfg, int8=False),
            dcfg, steps), reps=2)
        log(f"greedy_decode_loop[fuse_kv] {form} weights B={batch}: {rec['ms']} ms (grid {grid}) "
            f"against final LN + precompute_cross_kv_packed + unfused kernel C {unfused_ms} ms "
            f"on {card_line()}")
        if int8_w:
            continue
        results["greedy_decode_loop[fuse_kv]"] = rec
        loop = hold_decode(
            "greedy_decode_loop[fuse_kv, kernel=loop]", f"{form} weights B={batch}",
            lambda: dl.greedy_decode_loop(p, None, dcfg, steps, kernel="loop", **fuse),
            lambda: dl.greedy_decode_loop_reference(p, None, dcfg, steps, **fuse),
            p, cross, dcfg, lambda lens: cost_decode_loop(dcfg, lens, s, fuse_kv=True))
        if dl.greedy_decode_loop.last_grid["form"] != "loop":
            fail("greedy_decode_loop[fuse_kv] kernel=loop did not run the present kernel")
        prologue_ms = cuda_ms(lambda: dl.cross_kv_prologue(p, enc_raw, s, fln,
                                                           dcfg.layer_norm_eps))
        fln32 = tuple(fln[n].float().contiguous() for n in ("scale", "bias"))
        ln_ms = cuda_ms(lambda: launch.ln_rows_bf16(enc_raw.view(batch * s, d), fln32,
                                                    dcfg.layer_norm_eps))
        log(f"greedy_decode_loop[fuse_kv] bf16 weights B={batch}: prologue + cluster kernel "
            f"{rec['ms']} ms, present kernel (kernel=loop) {loop['ms']} ms: "
            f"{loop['ms'] / rec['ms']:.3f}x; unfused path {unfused_ms} ms; the prologue alone "
            f"{prologue_ms} ms (final LN row pass {ln_ms} ms, {2 * dcfg.num_layers} GEMMs "
            f"[{batch * s}, {d}] x [{d}, {d}] {prologue_ms - ln_ms} ms); bound "
            f"{rec['bound_ms']} ms ({rec['bound_by']}) on {card_line()}")

    # int8_w (the cluster kernel's int8 instance) and fuse_kv (the prologue
    # and the cluster kernel) at B=512 (a bucket of BATCH_SCHEDULE), a record
    wide = 512
    enc_raw2 = enc_raw.repeat(2, 1, 1)
    enc2 = common.layer_norm(enc_raw2, fln["scale"], fln["bias"], dcfg.layer_norm_eps)
    for form, kw in (("int8_w", {}), ("fuse_kv", dict(enc_raw=enc_raw2, s_valid=s,
                                                     enc_final_ln=fln))):
        p = decs["int8_w" if form == "int8_w" else "bf16"]
        cross = None if kw else dec.precompute_cross_kv_packed(p, enc2, dcfg, int8=False)
        ms = cuda_ms(lambda: dl.greedy_decode_loop(p, cross, dcfg, steps, **kw), reps=1)
        grid = dl.greedy_decode_loop.last_grid
        log(f"greedy_decode_loop[{form}] B={wide}: {ms} ms, grid {grid} on {card_line()}")
        if grid["form"] != "cluster":
            fail(f"greedy_decode_loop[{form}] B={wide} ran the {grid['form']} kernel")
    del enc_raw2, enc2

    # the ablation split of the present kernel's step (a record, not a
    # check; the ablate forms run on it, so its unablated form is the base)
    full = dataclasses.replace(dcfg, eos_token_id=dcfg.vocab_size)  # never emitted
    p = decs["bf16"]
    cross = dec.precompute_cross_kv_packed(p, enc, full, int8=False)
    times = {}
    for stage in ("", "self", "cross", "mlp", "head"):
        times[stage or "none"] = cuda_ms(
            lambda: dl.greedy_decode_loop(p, cross, full, steps, ablate=stage, kernel="loop"),
            reps=1)
    split = {k: (times["none"] - v) / steps for k, v in times.items() if k != "none"}
    log(f"greedy_decode_loop ablation B={batch} ({steps} steps, every row live): ms with the "
        f"stage skipped {times}; per-step ms of each stage (full - ablated) / steps {split}; "
        f"full per step {times['none'] / steps} on {card_line()}")


def check_page_tokens(engine, crops, orientation: int = 1,
                      gap_rel: float = ENGINE_GAP_REL) -> None:
    """End to end: per bucket of a page (prepared as ``ocr_page`` prepares it
    under ``orientation``, Vertical by default), the kernel path's encoder
    output against the plain path's, and the kernel path's tokens scored by
    the plain decoder on the plain encoder output (teacher-forced gaps
    within ``gap_rel`` of the top logit)."""
    import torch

    from manga_ocr_tpu_torch.parallel import batching
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.ops import decode_loop as dl
    from manga_ocr_tpu_torch.ops import preprocess as pp

    texts_k, texts_p, batches = [], [], batching.prep_page_gray(crops, orientation)
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
            if enc_rel > ENC_STACK_MAX_REL or stats["max_rel_gap"] > gap_rel:
                fail(f"bucket {b.bucket_hw}: encoder {enc_rel} / gap {stats['max_rel_gap']} "
                     f"over {ENC_STACK_MAX_REL} / {gap_rel}")
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
COUNTED_FORMS = {"fused_attn_layer": ("sdpa_int8",),
                 "greedy_decode_loop": ("cluster", "int8_w", "fuse_kv")}


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


def page_rate(engine, crops, label: str, n: int = 256) -> float:
    """crops/s of ocr_page on one ``n``-crop page (the fixtures cycled),
    after a warm page."""
    import torch

    page = [crops[i % len(crops)] for i in range(n)]
    engine.ocr_page(page)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 2
    for _ in range(reps):
        engine.ocr_page(page)
    rate = reps * len(page) / (time.perf_counter() - t0)
    log(f"{label} ocr_page {n} crops: {rate} crops/s on {card_line()}")
    return rate


def stage_split(engine, crops, label: str) -> None:
    """CUDA-event times of the largest dispatch of a 256-crop page, split
    into preprocess, encoder, and cross-K/V + decode (under fuse_cross_kv:
    the encoder without its final LN, then kernel C's fuse_kv form, which
    applies it in its prologue).  Each timed dispatch must launch kernel C
    once, on the cluster kernel (and once in the fuse_kv form under
    fuse_cross_kv)."""
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
    before = dict(dl.greedy_decode_loop.launches_by_form)
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
    forms = {f: n - before[f] for f, n in dl.greedy_decode_loop.launches_by_form.items()}
    if forms != {"cluster": 2, "int8_w": 0, "fuse_kv": 2 if fuse else 0}:
        fail(f"{label} stage split: kernel C's launches by form {forms} in two dispatches")
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


WIRE_SETTINGS = (("gray", True), ("gray", False), ("packed", True), ("packed", False))
WIRE_STREAM_PAGES = 8  # ocr_pages' stream of 256-crop pages, lookahead 2
WIRE_PER_DISPATCH = {"fused_attn_layer": 12, "fused_mlp_block": 12, "greedy_decode_loop": 1,
                     "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}


def wire_page(crops) -> list:
    """The fixture crops, then four each of three crops tiled from them:
    tall (348 x 85), large (370 x 303) and wide (130 x 214, turned tall by
    the Vertical rule), so that the page spans five buckets."""
    import numpy as np

    tall = np.concatenate([crops[0]] * 3, axis=0)
    large = np.tile(crops[3], (5, 3, 1))
    wide = np.tile(crops[2], (3, 5, 1))[:130, :214]
    return list(crops) + [np.ascontiguousarray(c) for c in (tall, large, wide) for _ in range(4)]


def wire_design(wire: str, coalesce: bool, n: int) -> tuple:
    """(transfers to the card, copies back) of an ``n``-bucket page in one
    wire setting: the fused gray wire one buffer, else two a bucket (crops
    or rows, extents or meta); one readback under coalesce, else one a
    bucket."""
    fused = coalesce and n > 1
    return (1 if fused and wire == "gray" else 2 * n), (1 if fused else n)


def dispatch_syncs(engine, page) -> dict:
    """The host synchronizations on ``_dispatch_page``'s path over ``page``
    (``torch.cuda.set_sync_debug_mode("warn")``), counted by the innermost
    line of the port that led to each and the line that raised it; and the
    host seconds of the dispatch and of the readback after it."""
    import collections
    import traceback
    import warnings

    import torch

    port = os.path.join(ROOT, "manga_ocr_tpu_torch")
    sites = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return  # e.g. the mode's own notice that it is a prototype
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(port)]
        where = (f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno} "
                 f"`{ours[-1].line}`" if ours else "outside the port")
        sites[f"{where} -> {os.path.basename(filename)}:{lineno}: {message}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            dispatched = engine._dispatch_page(page, 1, None)
            t1 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    engine._page_rows(dispatched)
    t2 = time.perf_counter()
    return {"syncs": dict(sites), "dispatch_s": t1 - t0, "readback_s": t2 - t1}


def run_wire(params, crops) -> None:
    """Phase "wire and coalescing": the int8 engine (MangaOCRConfig.base())
    with wire gray and packed, coalesce on and off, on the 256-crop page
    (two buckets) and wire_page's (five).  Holds, per setting: kernel
    launches A 12, B 12, C 1 a bucket exactly; prep_page_packed's
    PackedBatch items on the card's machine (the native library loaded);
    ``fused`` on a multi-bucket page under coalesce (one HostCopy) and on
    no single-bucket page; the StageTimer's "h2d" and "readback" counts
    against wire_design; every bucket's [lengths | tokens] rows bit-equal
    to _bucket_program's on the gray batch sent with no wire at all.  Then
    the coalesced and the per-bucket readback on a mesh of 2 x cuda:0,
    bit-equal to each other.  Prints each page's wire bytes, each setting's
    stage split of a timed 256-crop page, ocr_page's crops/s and
    ocr_pages' over WIRE_STREAM_PAGES pages (lookahead 2), and the host
    synchronizations on the dispatch path."""
    import numpy as np
    import torch

    from manga_ocr_tpu_torch import native
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.engine.engine import HostCopy
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.parallel import batching
    from manga_ocr_tpu_torch.parallel import mesh as meshlib
    from manga_ocr_tpu_torch.utils.metrics import StageTimer

    card = card_line()
    cfg, tok = MangaOCRConfig.base(), CharTokenizer.synthetic()
    big = [crops[i % len(crops)] for i in range(256)]
    pages = {"256-crop page": big, "five-bucket page": wire_page(crops)}
    if native.load() is None:
        fail("wire: the native prep library did not load, so the packed wire would ship "
             "gray batches")
    n_buckets = {}
    for label, page in pages.items():
        gray, packed = batching.prep_page_gray(page, 1), batching.prep_page_packed(page, 1)
        if not all(isinstance(b, batching.PackedBatch) for b in packed):
            fail(f"wire: prep_page_packed returned {[type(b).__name__ for b in packed]}")
        n_buckets[label] = len(gray)
        gray_bytes = sum(b.crops.nbytes + b.sizes.nbytes for b in gray)
        packed_bytes = sum(b.flat.nbytes + 12 * b.sizes.shape[0] for b in packed)
        log(f"wire bytes, {label} ({len(page)} crops, buckets "
            f"{[(b.bucket_hw, b.crops.shape[0]) for b in gray]}): gray {gray_bytes} in "
            f"{2 * len(gray)} transfers, fused gray {gray_bytes} in 1, packed {packed_bytes} "
            f"in {2 * len(packed)} ({packed_bytes / gray_bytes:.4f} of gray) on {card}")
    if n_buckets["five-bucket page"] < 3:
        fail(f"wire: the multi-bucket page spans {n_buckets['five-bucket page']} buckets")

    # the reference rows: each gray batch straight into the bucket program, no wire
    base = TorchMangaOcrEngine(params, cfg, tok, device="cuda")
    base.ocr_page(crops[:2])  # first call
    want = {}
    with torch.inference_mode():
        for label, page in pages.items():
            want[label] = [
                base._bucket_program(torch.from_numpy(b.crops).cuda(),
                                     torch.from_numpy(b.sizes).cuda()).cpu().numpy()[: b.valid]
                for b in batching.prep_page_gray(page, 1)]
    sync = dispatch_syncs(base, big)
    log(f"wire: host synchronizations on the dispatch path of the 256-crop page (gray, "
        f"coalesced) by line: {sync['syncs']}; the dispatch returned after "
        f"{sync['dispatch_s']:.4f} s, the readback then waited {sync['readback_s']:.4f} s "
        f"(host clock) on {card}")
    del base

    def hold(label, name, rows):
        if len(rows) != len(want[label]):
            fail(f"wire {name}, {label}: {len(rows)} buckets, expected {len(want[label])}")
        for i, (g, w) in enumerate(zip(rows, want[label])):
            if g.shape != w.shape or not np.array_equal(g, w):
                fail(f"wire {name}, {label}: bucket {i} rows differ from the bucket program's "
                     f"({int((g != w).any(axis=1).sum()) if g.shape == w.shape else g.shape} "
                     f"rows)")

    rates = {}
    for wire, coalesce in WIRE_SETTINGS:
        name = f"wire={wire}, coalesce={coalesce}"
        engine = TorchMangaOcrEngine(params, cfg, tok, device="cuda", wire=wire,
                                     coalesce=coalesce)
        engine.ocr_page(crops[:2])  # first call
        n = n_buckets["five-bucket page"]
        texts, counts = counted(lambda: engine.ocr_page(pages["five-bucket page"]))
        expect = {k: WIRE_PER_DISPATCH.get(k, 0) * n for k in counts}
        if counts != expect:
            fail(f"wire {name}: launches {counts} on {n} buckets, expected {expect}")
        want_type = batching.PackedBatch if wire == "packed" else batching.BucketedBatch
        for label, page in pages.items():
            dispatched = engine._dispatch_page(page, 1, None)
            outs, fused = dispatched
            if not all(isinstance(b, want_type) for b, _ in outs):
                fail(f"wire {name}, {label}: batches {[type(b).__name__ for b, _ in outs]}")
            if (fused is not None) != coalesce or (coalesce and (
                    len(fused) != 1 or not isinstance(fused[0], HostCopy))):
                fail(f"wire {name}, {label}: fused {fused} on {len(outs)} buckets")
            hold(label, name, engine._page_rows(dispatched))
            timer = StageTimer()
            got_texts = engine.ocr_page(page, timer=timer)
            split = timer.summary()
            design = wire_design(wire, coalesce, len(outs))
            if (split["h2d"]["count"], split["readback"]["count"]) != design:
                fail(f"wire {name}, {label}: h2d / readback {split['h2d']['count']} / "
                     f"{split['readback']['count']}, by design {design}")
            log(f"wire {name}, {label}: {design[0]} transfer(s) to the card, {design[1]} "
                f"readback(s); stage split of a timed page {json.dumps(split)} on {card}")
            if label == "five-bucket page" and got_texts != texts:
                fail(f"wire {name}: a timed page read other strings than an untimed one")
        if engine._dispatch_page(crops[:2], 1, None)[1] is not None:
            fail(f"wire {name}: fused set on a single-bucket page")
        rate = rates.setdefault(name, {})
        rate["ocr_page"] = page_rate(engine, crops, f"wire {name}")
        engine.ocr_pages([big], lookahead=2)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.ocr_pages([big] * WIRE_STREAM_PAGES, lookahead=2)
        rate["ocr_pages"] = WIRE_STREAM_PAGES * len(big) / (time.perf_counter() - t0)
        log(f"wire {name} ocr_pages {WIRE_STREAM_PAGES} x {len(big)} crops, lookahead 2: "
            f"{rate['ocr_pages']} crops/s on {card}")
        del engine
    log(f"wire crops/s by setting (ocr_page one 256-crop page; ocr_pages "
        f"{WIRE_STREAM_PAGES} of them, lookahead 2): {json.dumps(rates)} on {card}")

    # the readback half under a mesh: 2 x cuda:0, coalesced against per bucket
    mesh = meshlib.make_mesh(2, devices=[torch.device("cuda", 0)] * 2)
    sharded = {c: TorchMangaOcrEngine(params, cfg, tok, device="cuda", mesh=mesh, coalesce=c)
               for c in (True, False)}
    sharded[True].ocr_page(crops[:2])  # first call
    for label, page in pages.items():
        rows = {}
        for c, engine in sharded.items():
            dispatched = engine._dispatch_page(page, 1, None)
            if (dispatched[1] is not None) != c or (c and len(dispatched[1]) != 2):
                fail(f"wire on 2 x cuda:0, coalesce={c}, {label}: fused {dispatched[1]}")
            rows[c] = engine._page_rows(dispatched)
        for i, (a, b) in enumerate(zip(rows[True], rows[False])):
            if a.shape != b.shape or not np.array_equal(a, b):
                fail(f"wire on 2 x cuda:0, {label}: bucket {i}'s coalesced rows differ from "
                     f"the per-bucket readback's")
        log(f"wire on 2 x cuda:0, {label}: {len(rows[True])} buckets' rows, coalesced (one "
            f"readback a data device) bit-equal to the per-bucket readback")
    del sharded
    torch.cuda.empty_cache()


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


GRAPH_STREAM = 8  # ocr_pages' pages in the graphs' stream check and rate, lookahead 2
GRAPH_BUDGETS = (300, 24)  # max_length: the serving budget; above a trained model's p95 length (~20)
GRAPH_FULL_BATCHES = (8, 16, 32, 64, 128, 256, 512)  # warmup(full=True)'s batch schedule
GRAPH_STEP_LEN = 8  # max_length of the step-by-step decode's check (no graph; its steps cut)


def page_shapes(page) -> list:
    """The (bucket, padded batch) shapes of ``page``'s dispatches, in order."""
    from manga_ocr_tpu_torch.parallel import batching

    return [(b.bucket_hw, b.crops.shape[0]) for b in batching.prep_page_gray(page, 1)]


def bucket_rows(engine, page) -> list:
    """Each gray batch of ``page`` through ``engine``'s eager bucket program
    (its own params, no graph, no wire): [valid, 1 + L] int32 rows a bucket."""
    import torch

    from manga_ocr_tpu_torch.parallel import batching

    with torch.inference_mode():
        return [engine._bucket_program(torch.from_numpy(b.crops).cuda(),
                                       torch.from_numpy(b.sizes).cuda()).cpu().numpy()[: b.valid]
                for b in batching.prep_page_gray(page, 1)]


def hold_rows(label: str, got: list, want: list) -> None:
    import numpy as np

    if len(got) != len(want):
        fail(f"{label}: {len(got)} buckets, expected {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.array_equal(g, w):
            fail(f"{label}: bucket {i}'s rows differ from the eager bucket program's "
                 f"({int((g != w).any(axis=1).sum()) if g.shape == w.shape else g.shape} rows)")


def wrapper_launches() -> int:
    return sum(w.launches for w in kernel_wrappers().values())


def device_mib() -> tuple:
    """(allocated, reserved, held by CUDA graphs' private pools) device MiB
    after a synchronize and empty_cache."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pools = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))
    return (torch.cuda.memory_allocated() / 2**20, torch.cuda.memory_reserved() / 2**20,
            pools / 2**20)


def graph_rate(engine, page, reps: int) -> tuple:
    """(ocr_page crops/s over ``reps`` pages, the StageTimer's "dispatch" ms
    a page over ``reps`` timed pages), after a warm page."""
    import torch

    from manga_ocr_tpu_torch.utils.metrics import StageTimer

    engine.ocr_page(page)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.ocr_page(page)
    rate = reps * len(page) / (time.perf_counter() - t0)
    timer = StageTimer()
    for _ in range(reps):
        engine.ocr_page(page, timer=timer)
    return rate, timer.summary()["dispatch"]["total_s"] * 1000 / reps


def run_graphs(params, crops) -> None:
    """Phase "engine graphs": TorchMangaOcrEngine(aot=True) at full width,
    one CUDA graph per (bucket, padded batch) shape (engine/graphs.py), held
    bit for bit against the same engine's eager bucket program and measured
    against the eager engine (see the module docstring, item 4)."""
    import threading

    import numpy as np
    import torch

    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.utils.metrics import COMPILE_EVENTS

    card = card_line()
    cfg, tok = MangaOCRConfig.base(), CharTokenizer.synthetic()
    big = [crops[i % len(crops)] for i in range(256)]
    small = [crops[i % len(crops)] for i in range(8)]
    pages = {"256-crop page": big, "8-crop page": small, "five-bucket page": wire_page(crops)}
    for label, page in pages.items():
        log(f"graphs: {label} dispatches {page_shapes(page)}")

    def engine_of(**kw):
        return TorchMangaOcrEngine(params, cfg, tok, device="cuda", **kw)

    # -- rows: graph against eager, bit for bit --------------------------------
    t0 = time.time()
    settings = [("int8", True, w, c) for w, c in WIRE_SETTINGS] + [("bf16", False, "gray", True)]
    want = {}
    for form, q, wire, coalesce in settings:
        name = f"{form} engine, wire={wire}, coalesce={coalesce}"
        engine = engine_of(quantize_int8=q, wire=wire, coalesce=coalesce, aot=True)
        if not engine._aot:
            fail(f"graphs {name}: aot=True is off on one CUDA device")
        if form not in want:  # the form's first engine; the others quantize the same params
            want[form] = {label: bucket_rows(engine, page) for label, page in pages.items()}
        for label, page in pages.items():  # each shape captured at its first dispatch
            hold_rows(f"graphs {name}, {label}", engine._page_rows(
                engine._dispatch_page(page, 1, None)), want[form][label])
        before = wrapper_launches()
        dispatched = {label: engine._dispatch_page(page, 1, None) for label, page in pages.items()}
        for label, d in dispatched.items():
            hold_rows(f"graphs {name}, {label}, all pages dispatched first",
                      engine._page_rows(d), want[form][label])
        if wrapper_launches() != before:
            fail(f"graphs {name}: replays launched {wrapper_launches() - before} kernel wrappers")
        secs = {f"{hw[0]}x{hw[1]}@{n}": round(c.seconds, 4)
                for (hw, n), c in engine._graphs.captures.items()}
        log(f"graphs {name}: every bucket's rows bit-equal to the eager bucket program's on "
            f"the three pages, twice; {len(secs)} shapes captured, capture s by shape "
            f"{json.dumps(secs)} on {card}")
        del engine, dispatched
    # the step-by-step decode (serving_kernels=False) reads its "done" flags on
    # the host between chunks: the server, graphs on by default, serves it
    # eagerly from its warmup on
    from manga_ocr_tpu_torch import serve

    argv = ["--serving-kernels", "off", "--max-length", str(GRAPH_STEP_LEN)]
    engines = [serve.build_engine(serve.parser().parse_args(argv + extra))
               for extra in (["--no-aot"], [])]
    if engines[1]._aot or engines[1]._graphs is not None:
        fail("graphs: serve.py --serving-kernels off captures the step-by-step decode")
    engines[1].warmup()
    step_want = bucket_rows(engines[0], small)
    for engine in engines:
        hold_rows("graphs: serving_kernels=False, 8-crop page", engine._page_rows(
            engine._dispatch_page(small, 1, None)), step_want)
    log(f"graphs: serve.py --serving-kernels off (aot on by default) captures nothing, warms "
        f"and serves the 8-crop page eagerly, rows bit-equal to --no-aot's "
        f"(max_length {GRAPH_STEP_LEN})")
    del engines, engine
    torch.cuda.empty_cache()
    log(f"graphs: rows checked in {time.time() - t0:.1f} s")

    # -- ocr_pages: capture order opposite to dispatch order; one unwarmed shape --
    t0 = time.time()
    extra = [crops[i % len(crops)] for i in range(40)]  # batches 32 and 16
    stream = [big, pages["five-bucket page"], small, big, extra, pages["five-bucket page"],
              small, big][:GRAPH_STREAM]
    engine = engine_of(aot=True)
    new = [s for s in page_shapes(extra) if all(s not in page_shapes(p) for p in stream
                                                 if p is not extra)]
    if not new:
        fail(f"graphs: the extra page's shapes {page_shapes(extra)} are all elsewhere")
    reached = []
    for page in stream:
        reached += [s for s in page_shapes(page) if s not in reached and s not in new]
    for hw, n in reversed(reached):
        engine.warmup(bucket_hws=[hw], batch_sizes=[n])
    if list(engine._graphs.captures) != reached[::-1]:
        fail(f"graphs: warmup captured {list(engine._graphs.captures)}")
    record, threads = engine._graphs._record, []

    def traced_record(cap, program):
        threads.append(threading.get_ident())
        record(cap, program)

    engine._graphs._record = traced_record
    got, page_rows = [], engine._page_rows

    def recorded_rows(page, stage=None):
        got.append(page_rows(page, stage))
        return got[-1]

    engine._page_rows = recorded_rows
    COMPILE_EVENTS.reset()
    texts = engine.ocr_pages(stream, lookahead=2)
    events = COMPILE_EVENTS.summary()
    engine._page_rows = page_rows
    eager = {id(page): want["int8"][label] for label, page in pages.items()}
    eager[id(extra)] = bucket_rows(engine, extra)
    for i, page in enumerate(stream):
        hold_rows(f"graphs ocr_pages, page {i}", got[i], eager[id(page)])
    if len(texts) != len(stream) or [len(t) for t in texts] != [len(p) for p in stream]:
        fail(f"graphs ocr_pages: {[len(t) for t in texts]} strings for the pages")
    want_events = {"unplanned_compile": len(new),
                   **{f"unplanned:{hw[0]}x{hw[1]}@{n}": 1 for hw, n in new}}
    if events != want_events or len(threads) != len(new) or \
            threading.get_ident() in threads:
        fail(f"graphs ocr_pages: COMPILE_EVENTS {events} (expected {want_events}), "
             f"{len(threads)} captures, in the calling thread: {threading.get_ident() in threads}")
    sync = dispatch_syncs(engine, big)
    log(f"graphs ocr_pages over {len(stream)} pages, lookahead 2: every row bit-equal to the "
        f"eager bucket program's; {len(reached)} shapes captured in the order opposite to the "
        f"pages', {new} first reached from the lookahead thread and captured there, "
        f"COMPILE_EVENTS {events}; host synchronizations on a replayed 256-crop page's "
        f"dispatch {sync['syncs']}, the dispatch returned after {sync['dispatch_s']:.4f} s "
        f"(host clock); {time.time() - t0:.1f} s on {card}")
    del engine
    torch.cuda.empty_cache()

    # -- capture: seconds and device memory ------------------------------------
    memory, secs = {}, {}
    for label, kw, full in (("eager engine, warmup()", {}, False),
                            ("graph engine, warmup()", {"aot": True}, False),
                            ("graph engine, warmup(full=True)", {"aot": True}, True)):
        a0, r0, p0 = device_mib()
        t0 = time.time()
        engine = engine_of(**kw)
        engine.warmup(full=full, batch_sizes=GRAPH_FULL_BATCHES if full else None)
        seconds = time.time() - t0
        a1, r1, p1 = device_mib()
        memory[label] = {"allocated_mib": round(a1 - a0, 1), "graph_pool_mib": round(p1 - p0, 1),
                         "reserved_mib": round(r1 - r0, 1), "reserved_after_mib": round(r1, 1),
                         "build_and_warmup_s": round(seconds, 2)}
        if engine._graphs is not None:
            caps = [c.seconds for c in engine._graphs.captures.values()]
            secs[label] = {"shapes": len(caps), "min": round(min(caps), 4),
                           "median": round(float(np.median(caps)), 4), "max": round(max(caps), 4)}
        del engine
        a2, _, p2 = device_mib()  # the engine's graphs and pool go with it
        memory[label]["after_del_mib"] = {"allocated": round(a2 - a0, 1),
                                          "graph_pool": round(p2 - p0, 1)}
    torch.cuda.empty_cache()
    log(f"graphs: device memory the engine holds after its warmup (MiB beyond the run's "
        f"before it: allocated, in graph pools, reserved; then reserved in all; then what "
        f"stays allocated and pooled once the engine is dropped) "
        f"{json.dumps(memory)}; capture s a shape {json.dumps(secs)} on {card}")

    # -- speed: eager against graph, budgets 300 and 24 ------------------------------
    rates = {}
    for budget in GRAPH_BUDGETS:
        # the card's work hides the host at the serving budget: one turn each
        order = ("eager", "graph") if budget == 300 else ("eager", "graph", "graph", "eager")
        for mode in order:
            engine = engine_of(max_length=budget, aot=mode == "graph")
            r = rates.setdefault(f"budget {budget}", {}).setdefault(mode, [])
            big_rate, big_ms = graph_rate(engine, big, 2)
            small_rate, small_ms = graph_rate(engine, small, 3 if budget == 300 else 5)
            engine.ocr_pages([big], lookahead=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.ocr_pages([big] * GRAPH_STREAM, lookahead=2)
            r.append({"256-crop ocr_page crops/s": big_rate, "256-crop dispatch ms": big_ms,
                      "8-crop ocr_page crops/s": small_rate, "8-crop dispatch ms": small_ms,
                      "ocr_pages crops/s": GRAPH_STREAM * len(big) / (time.perf_counter() - t0)})
            del engine
        torch.cuda.empty_cache()
    log(f"graphs: int8 engine, eager against graph (budget 300 eager, graph; 24 eager, graph, "
        f"graph, eager): ocr_page crops/s and the StageTimer's dispatch ms a page on the 256-crop "
        f"and the 8-crop page, ocr_pages crops/s over {GRAPH_STREAM} 256-crop pages "
        f"(lookahead 2): {json.dumps(rates)} on {card}")


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
            want["greedy_decode_loop[cluster]"] = 1
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
                "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}, results,
               record={"fused_encoder_layer": "fused_encoder_layer[bf16]"})


def run_slice_engine(params, crops, results: dict) -> float:
    """Path 1 of this slice: the int8 serving engine with kernel A's int8
    SDPA (attn_sdpa_int8) and kernel C's fuse_kv form (fuse_cross_kv), on
    the fixture page.  Per dispatch exactly: A 12 (all in the sdpa_int8
    form), B 12, C 1 (in the fuse_kv form, on the cluster kernel after its
    prologue), and no slab precompute; the tokens scored by teacher
    forcing; crops/s on the 256-crop page."""
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    cfg = slice_config()
    engine = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), device="cuda")
    engine.ocr_page(crops[:2])
    label = "int8 engine, sdpa_int8 + fuse_kv"
    n_l = cfg.encoder.num_layers
    drive_page(engine, crops, label,
               {"fused_attn_layer": n_l, "fused_attn_layer[sdpa_int8]": n_l,
                "fused_mlp_block": n_l, "greedy_decode_loop": 1, "greedy_decode_loop[fuse_kv]": 1,
                "greedy_decode_loop[cluster]": 1},
               results, record={"fused_attn_layer": None, "fused_mlp_block": None,
                                "greedy_decode_loop": None, "greedy_decode_loop[cluster]": None})
    check_page_tokens(engine, crops)
    rate = page_rate(engine, crops, label)
    stage_split(engine, crops, label)
    return rate


def run_int8_decoder_forward(params, crops, results: dict) -> None:
    """Path 2 of this slice: ocr_forward on 32 fixture crops under
    MangaOCRConfig.serving() on quantize_encoder(quantize_attn_proj=True) +
    quantize_decoder params (cast to bf16, int8 weights and f32 scales
    kept): kernel C in its int8_w form on the cluster kernel, once over
    precomputed slabs and once with fuse_cross_kv (int8_w + fuse_kv).
    Launch counts exact; the tokens scored by the plain int8 decoder on the
    plain encoder output."""
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
                         "greedy_decode_loop[int8_w]": 1, "greedy_decode_loop[cluster]": 1,
                         "greedy_decode_loop[fuse_kv]": int(fuse),
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


# ocr_preprocess on the card against the port's own CPU run of the same call,
# with the tolerances of tests/test_torch_ocr_preprocess.py (which holds the
# CPU run against the JAX package): NONE, HORIZONTAL and VERTICAL byte for
# byte; AUTO's f32 moment sums (another reduction order) and the cos/sin of
# its f32 angle may differ in the last bit.
PRE_ANGLE_ATOL_DEG = 1e-3
PRE_MAX_PIXEL_SHARE = 1e-3
PRE_BATCH = 256


def check_ocr_preprocess(crops) -> dict:
    """ocr_preprocess at B=256 (the fixture crops cycled, bucketed by
    ``batching.bucket_crops``, one call per bucket) for each orientation:
    the card against the host, and the card's CUDA-event ms per page."""
    import numpy as np
    import torch

    from manga_ocr_tpu_torch.ops import preprocess as pp
    from manga_ocr_tpu_torch.parallel import batching

    page = [crops[i % len(crops)] for i in range(PRE_BATCH)]
    batches = batching.bucket_crops(page)
    big = max(range(len(batches)), key=lambda i: batches[i].crops.size)
    largest = batches[big]
    log(f"ocr_preprocess page: {PRE_BATCH} crops in {len(batches)} buckets "
        f"{[b.crops.shape for b in batches]}; largest bucket {largest.crops.shape}")
    on_card = [(torch.from_numpy(b.crops).cuda(), torch.from_numpy(b.sizes).cuda())
               for b in batches]
    times = {}
    for orient, name in ((pp.ORIENT_NONE, "none"), (pp.ORIENT_HORIZONTAL, "horizontal"),
                         (pp.ORIENT_VERTICAL, "vertical"), (pp.ORIENT_AUTO, "auto")):
        def run():
            return [pp.ocr_preprocess(c, orient, s) for c, s in on_card]

        with torch.inference_mode():
            outs = [(o.cpu().numpy(), a.cpu().numpy()) for o, a in run()]
            times[name] = cuda_ms(run, reps=5, warm=False)
            largest_ms = cuda_ms(lambda: pp.ocr_preprocess(on_card[big][0], orient,
                                                           on_card[big][1]), reps=5)
        n_px = n_diff = 0
        angle_err = 0.0
        for b, (out, ang) in zip(batches, outs):
            want, want_ang = pp.ocr_preprocess(torch.from_numpy(b.crops), orient,
                                               torch.from_numpy(b.sizes))
            n_px += out.size
            n_diff += int((out != want.numpy()).sum())
            angle_err = max(angle_err, float(np.abs(ang - want_ang.numpy()).max()))
        share = n_diff / n_px
        log(f"ocr_preprocess {name}: card vs host {n_diff} of {n_px} pixels differ "
            f"(share {share}), largest angle difference {angle_err} deg; "
            f"{times[name]} ms for the page's {len(batches)} calls, {largest_ms} ms for the "
            f"largest bucket {largest.crops.shape} (CUDA events) on {card_line()}")
        exact = orient != pp.ORIENT_AUTO
        if exact and (n_diff or angle_err):
            fail(f"ocr_preprocess {name}: the card differs from the host ({n_diff} pixels, "
                 f"angles {angle_err}); must be byte for byte")
        if share > PRE_MAX_PIXEL_SHARE or angle_err > PRE_ANGLE_ATOL_DEG:
            fail(f"ocr_preprocess {name}: pixel share {share} / angle {angle_err} over "
                 f"{PRE_MAX_PIXEL_SHARE} / {PRE_ANGLE_ATOL_DEG}")
    return times


def run_dual_engine(params, crops, results: dict) -> float:
    """This slice's path: ocr_page_dual through the int8 serving engine at
    full width on the fixture crops -- ocr_preprocess (Auto-Detect) per
    bucket on the card, then one ocr_page of the raw and the binarized
    crops.  Per dispatch exactly A 12, B 12, C 1 (cluster form) and one slab
    precompute; both rows' tokens scored by teacher forcing against the
    plain path; crops/s of a 128-crop dual page (each crop two rows)."""
    import torch

    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.ops import preprocess as pp
    from manga_ocr_tpu_torch.parallel import batching

    engine = TorchMangaOcrEngine(params, MangaOCRConfig.base(), CharTokenizer.synthetic(),
                                 device="cuda")
    engine.ocr_page_dual(crops[:2])  # first call: library load, allocator growth
    pairs, counts = counted(lambda: engine.ocr_page_dual(crops))
    pre = engine._binarized_variants(crops)
    n_dispatch = len(batching.prep_page_gray(crops + pre, pp.ORIENT_AUTO))
    per_dispatch = {"fused_attn_layer": 12, "fused_mlp_block": 12, "greedy_decode_loop": 1,
                    "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}
    log(f"dual engine: ocr_page_dual over {len(crops)} crops ({2 * len(crops)} rows) in "
        f"{n_dispatch} dispatches: launches {counts}")
    want = {name: per_dispatch.get(name, 0) * n_dispatch for name in counts}
    if counts != want:
        fail(f"dual engine: launch counts {counts}, expected {want}")
    if len(pairs) != len(crops) or not all(
            len(p) == 2 and all(isinstance(t, str) for t in p) for p in pairs):
        fail("dual engine: ocr_page_dual returned malformed pairs")
    if len({p[0] for p in pairs}) < 2:
        fail("dual engine: every crop decoded to the same text")
    log(f"dual engine pairs: {pairs}")
    check_page_tokens(engine, crops + pre, pp.ORIENT_AUTO)
    page = [crops[i % len(crops)] for i in range(128)]
    engine.ocr_page_dual(page)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 2
    for _ in range(reps):
        engine.ocr_page_dual(page)
    rate = reps * len(page) / (time.perf_counter() - t0)
    log(f"dual engine ocr_page_dual 128 crops: {rate} crops/s on {card_line()}")
    # its two halves by the host clock (each ends in a readback)
    t0 = time.perf_counter()
    pre = engine._binarized_variants(page)
    t1 = time.perf_counter()
    engine.ocr_page(page + pre, pp.ORIENT_AUTO)
    t2 = time.perf_counter()
    log(f"dual engine, the same page by halves: binarized variants (bucket, ocr_preprocess, "
        f"readback, crop) {(t1 - t0) * 1e3} ms, ocr_page of the {2 * len(page)} rows "
        f"{(t2 - t1) * 1e3} ms (host clock) on {card_line()}")
    return rate


def check_eval_harness() -> None:
    """The CER harness on the card, as a user runs it (a subprocess of
    ``python -m manga_ocr_tpu_torch.eval``, the fixtures' checkpoint): its
    report must equal the host's (the one tests/test_torch_eval.py holds to
    the JAX harness) and score every string exactly."""
    import contextlib

    from manga_ocr_tpu_torch import eval as ev

    args = [os.path.join("tests", "fixtures", "eval"), "--checkpoint",
            os.path.join("tests", "fixtures", "tiny_random_seed0")]
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "manga_ocr_tpu_torch.eval", *args,
                          "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if out.returncode:
        fail(f"eval harness on the card exited {out.returncode}: {out.stderr[-2000:]}")
    card = json.loads(out.stdout)
    log(f"eval harness on the card in {time.time() - t0:.1f} s: n {card['n']}, n_scored "
        f"{card['n_scored']}, mean_cer {card['mean_cer']}, exact_match {card['exact_match']}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev.main([os.path.join(ROOT, a) if not a.startswith("--") else a for a in args]
                + ["--device", "cpu"])
    host = json.loads(buf.getvalue())
    if card != host:
        diff = [(c["name"], c["hyp"], h["hyp"], c.get("dual_hyp"), h.get("dual_hyp"))
                for c, h in zip(card["items"], host["items"]) if c != h]
        fail(f"eval harness: the card's report differs from the host's: {diff}")
    if (card["n"], card["n_scored"], card["exact_match"]) != (20, 22, 1.0):
        fail(f"eval harness: n {card['n']}, n_scored {card['n_scored']}, exact_match "
             f"{card['exact_match']}; expected 20, 22, 1.0")


def same_tree(got, want) -> list:
    """The leaf paths where two parameter trees differ (bit for bit)."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return ["<keys>"]
        return [f"{k}/{p}" for k in want for p in same_tree(got[k], want[k])]
    return [] if got.dtype == want.dtype and torch.equal(got, want) else [""]


def run_hf_entry_points() -> None:
    """The entry points a user calls, on an HF checkpoint directory at full
    width: the seed-0 base params written by ``save_hf_checkpoint`` and read
    back bit for bit by ``load_hf_checkpoint``; ``MangaOcr(dir)`` on the card
    called once per fixture crop (A 12, B 12 and C 1 in its cluster form per
    dispatch; each string that of an int8 engine built here from the same
    bf16-loaded params), then from 8 threads (fewer dispatches than calls;
    a crop dispatched at its single-call shape gives its single-call string;
    a batch holding others runs again at the same shapes, reads the same
    strings and is teacher-forced by the plain path); and ``python -m
    manga_ocr_tpu_torch.cli ocr`` in a subprocess, whose lines must equal an
    in-process f32-loaded engine's."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from manga_ocr_tpu_torch.compat import MangaOcr
    from manga_ocr_tpu_torch.core.files import safe_open_image
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.convert import load_hf_checkpoint, save_hf_checkpoint
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.parallel import batching

    cfg = MangaOCRConfig.base()
    params = init_params(cfg, SEED, "cpu", std=WEIGHT_STD)
    tok = CharTokenizer.synthetic()
    crops = load_crops()
    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures", "eval", "*.png")))
    per_dispatch = {"fused_attn_layer": 12, "fused_mlp_block": 12, "greedy_decode_loop": 1,
                    "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}
    with tempfile.TemporaryDirectory() as d:
        # -- (a) write, (b) read back ---------------------------------------------
        t0 = time.perf_counter()
        save_hf_checkpoint(d, params, cfg, tokenizer=tok)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(d, "model.safetensors"))
        t0 = time.perf_counter()
        loaded, cfg2 = load_hf_checkpoint(d)
        load_s = time.perf_counter() - t0
        log(f"HF checkpoint: save_hf_checkpoint {write_s:.3f} s, model.safetensors {size} "
            f"bytes; load_hf_checkpoint {load_s:.3f} s (host clock) on {card_line()}")
        diff = same_tree(loaded, params)
        if cfg2 != cfg or diff:
            fail(f"HF checkpoint round trip: config equal {cfg2 == cfg}, leaves differ {diff}")
        log("HF checkpoint round trip: every leaf bit-equal, config equal")

        # -- (c) MangaOcr: one call a crop, then 8 threads ----------------------------
        t0 = time.perf_counter()
        reader = MangaOcr(d)
        build_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            reader(crops[0])
            first_s = time.perf_counter() - t0
            single = []
            for i, crop in enumerate(crops):
                text, counts = counted(lambda: reader(crop))
                want = {name: per_dispatch.get(name, 0) for name in counts}
                if counts != want:
                    fail(f"MangaOcr call {i}: launch counts {counts}, expected {want}")
                single.append(text)
            ref = TorchMangaOcrEngine(load_hf_checkpoint(d, torch.bfloat16)[0], cfg, tok,
                                      device="cuda")
            ref_texts = [ref.ocr_page([c])[0] for c in crops]
            if single != ref_texts:
                fail(f"MangaOcr strings differ from the in-process int8 engine's: "
                     f"{[(i, a, b) for i, (a, b) in enumerate(zip(single, ref_texts)) if a != b]}")
            log(f"MangaOcr: {len(crops)} single calls, each A 12, B 12, C 1 (cluster form); "
                f"strings equal the in-process int8 engine's; {len(set(single))} distinct")
            del ref
            # record what the microbatcher hands the engine, to know each crop's
            # dispatch shape in the threaded run
            batches = []
            engine_call = reader._batcher.batch_fn

            def recording(batch):
                out = engine_call(batch)
                batches.append(list(batch))
                return out

            reader._batcher.batch_fn = recording
            with ThreadPoolExecutor(8) as ex:
                threaded, counts = counted(lambda: list(ex.map(reader, crops)))
            reader._batcher.batch_fn = engine_call
            n_dispatch = counts["greedy_decode_loop"]
            want = {name: per_dispatch.get(name, 0) * n_dispatch for name in counts}
            planned = sum(len(batching.prep_page_gray(b, 1)) for b in batches)
            log(f"MangaOcr from 8 threads: {len(crops)} calls in {len(batches)} batches of "
                f"{[len(b) for b in batches]} crops, {n_dispatch} dispatches; launches {counts}")
            if counts != want or planned != n_dispatch:
                fail(f"MangaOcr threaded: launch counts {counts}, expected {want} "
                     f"({planned} dispatches planned)")
            if n_dispatch >= len(crops):
                fail(f"MangaOcr threaded: {n_dispatch} dispatches for {len(crops)} calls: "
                     f"the calls did not coalesce")
            index = {id(c): i for i, c in enumerate(crops)}
            exact = scored = 0
            for b in batches:
                shape = {}
                for bb in batching.prep_page_gray(b, 1):
                    for j in bb.indices:
                        shape[index[id(b[j])]] = (bb.bucket_hw, bb.crops.shape[0])
                alone = {i: batching.prep_page_gray([crops[i]], 1)[0] for i in shape}
                differ = [i for i in shape
                          if shape[i] != (alone[i].bucket_hw, alone[i].crops.shape[0])]
                for i in shape:
                    if i not in differ and threaded[i] != single[i]:
                        fail(f"MangaOcr threaded: crop {i} at its single-call shape "
                             f"{shape[i]} read {threaded[i]!r}, alone {single[i]!r}")
                exact += len(shape) - len(differ)
                if differ:  # the batch again, at the shapes it ran at: scored
                    rerun = dict(zip((index[id(c)] for c in b), reader.engine.ocr_page(b)))
                    if any(threaded[i] != rerun[i] for i in differ):
                        fail(f"MangaOcr threaded: a batch run again reads otherwise: "
                             f"{[(threaded[i], rerun[i]) for i in differ]}")
                    check_page_tokens(reader.engine, b)
                    scored += len(differ)
            log(f"MangaOcr threaded: {exact} crops at their single-call shape, strings "
                f"exact; {scored} at another shape, teacher-forced within {ENGINE_GAP_REL}")
        finally:
            reader.close()

        # -- (d) the command line in a subprocess -----------------------------------
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "manga_ocr_tpu_torch.cli", "--checkpoint", d,
                              "--device", "cuda", "ocr", *paths], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if out.returncode:
            fail(f"cli ocr on the card exited {out.returncode}: {out.stderr[-2000:]}")
        engine = TorchMangaOcrEngine(loaded, cfg2, CharTokenizer.from_vocab_file(
            os.path.join(d, "vocab.txt")), device="cuda")
        texts = engine.ocr_page([safe_open_image(p) for p in paths])
        want_lines = [f"{p}\t{t}" for p, t in zip(paths, texts)]
        if out.stdout.splitlines() != want_lines:
            fail(f"cli ocr lines differ from the in-process engine's: {out.stdout[-2000:]}")
        log(f"cli ocr: {len(paths)} lines equal the in-process f32-loaded engine's; "
            f"its own timing {out.stderr.strip().splitlines()[-1]}")
    # -- (e) --------------------------------------------------------------------------
    log(f"HF entry points: MangaOcr built in {build_s:.3f} s, first call {first_s:.3f} s; "
        f"cli ocr subprocess wall {cli_s:.3f} s (host clock) on {card_line()}")


# Training at full width: the card's loss and gradient against the host's on
# the same step (f32 both; the summation order differs), each leaf's gradient
# within GRAD_REL of its largest |g| plus GRAD_ATOL (the attention key biases'
# gradient is 0 up to summation noise on both devices).  A step with TF32
# products, or under bf16 autocast, must fall outside these bounds: on an H100
# the f32 step's loss is bit-equal and its worst leaf within 0.03 of the
# gradient bound, while TF32 reads a loss gap of 1.3e-5 and a leaf gap of
# 1.2e-3 of its max |g| (10x the bound), so 1e-4 and 1e-3 would let TF32 by.
TRAIN_LOSS_REL = 1e-6
TRAIN_GRAD_REL, TRAIN_GRAD_ATOL = 1e-4, 1e-7
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 32, 32, 30, 5
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 is off)


def grad_gaps(tag: str, label: str, run, ref) -> bool:
    """Logs a step's loss and gradient gaps to the host's: ``run`` and
    ``ref`` are (loss, {leaf: gradient on the host}); True where the loss is
    within TRAIN_LOSS_REL and every leaf within TRAIN_GRAD_REL of its max |g|
    plus TRAIN_GRAD_ATOL."""
    loss, grads = run
    ref_loss, ref_grads = ref
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    shares = {name: float((grads[name] - g).abs().max())
              / (TRAIN_GRAD_REL * float(g.abs().max()) + TRAIN_GRAD_ATOL)
              for name, g in ref_grads.items()}
    worst_leaf = max(shares, key=shares.get)
    g = ref_grads[worst_leaf]
    rel = float((grads[worst_leaf] - g).abs().max() / g.abs().max().clamp_min(1e-30))
    log(f"{tag}: {label}: loss {loss!r} against the host's {ref_loss!r}, relative gap "
        f"{loss_rel:.3e} (bound {TRAIN_LOSS_REL}); {len(ref_grads)} gradient leaves, the "
        f"worst {worst_leaf} at {shares[worst_leaf]:.3f} of its bound (gap / max|g| "
        f"{rel:.3e}, bound {TRAIN_GRAD_REL} + {TRAIN_GRAD_ATOL} / max|g|)")
    return loss_rel <= TRAIN_LOSS_REL and shares[worst_leaf] <= 1.0


def train_step_flops(cfg, b: int, t: int) -> float:
    """The products of one training step (forward, and twice that for the
    backward), from the shapes: the encoder's patch embedding, projections,
    attention and MLP over S tokens; the decoder's over the T - 1 inputs,
    its cross K/V over S and the head's vocab product."""
    e, d = cfg.encoder, cfg.decoder
    s, t = e.seq_len, t - 1
    enc = 2 * (s - 1) * e.patch_size ** 2 * e.num_channels * e.hidden_size + e.num_layers * (
        2 * s * e.hidden_size * 4 * e.hidden_size + 4 * s * s * e.hidden_size
        + 4 * s * e.hidden_size * e.intermediate_size)
    dec = d.num_layers * (
        2 * t * d.hidden_size * 6 * d.hidden_size + 4 * t * t * d.hidden_size
        + 2 * s * e.hidden_size * 2 * d.hidden_size + 4 * t * s * d.hidden_size
        + 4 * t * d.hidden_size * d.intermediate_size
    ) + 2 * t * d.hidden_size * (d.hidden_size + d.vocab_size)
    return 3.0 * b * (enc + dec)


def run_training() -> None:
    """The training path (``manga_ocr_tpu_torch.train``) at full width on the
    card: (a) one B=2 step's loss and every leaf's gradient against the
    host's on the same numpy seed-0 weights and ``synthetic_dataset`` batch,
    and the same step in TF32 and under bf16 autocast outside the bounds;
    (b) ``train()`` at B=32, T=32 for 30 steps (warmup 5, a train state
    saved every 15) with each step's CUDA-event time, crops/s and the peak
    device memory, every logged loss finite, then resumed to step 32; (c)
    ``main --steps 2 --export-hf DIR`` in-process, and ``MangaOcr(DIR)`` on
    the fixture crops: A 12, B 12, C 1 per dispatch, the page's tokens
    teacher-forced by the plain path within DECODE_GAP_REL."""
    import contextlib
    import math
    import statistics
    import tempfile

    import torch
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from manga_ocr_tpu_torch import train as trainlib
    from manga_ocr_tpu_torch.compat import MangaOcr
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    cfg = MangaOCRConfig.base()
    tok = CharTokenizer.synthetic()

    # -- (a) one step, card against host; a TF32 and a bf16 step as controls ------
    batch = next(trainlib.synthetic_dataset(cfg, tok, 2, TRAIN_SEQ, seed=SEED))
    tree = init_params(cfg, SEED, "cpu", std=WEIGHT_STD)
    adamw = trainlib.make_optimizer(1e-4)

    def grads_of(node, prefix=""):
        if isinstance(node, dict):
            return {name: g for k, v in node.items()
                    for name, g in grads_of(v, f"{prefix}/{k}" if prefix else k).items()}
        return {prefix: node.grad.cpu()} if node.is_floating_point() else {}

    def loss_and_grads(dev: str, label: str):
        params, _ = trainlib.init_train_state(cfg, adamw, device=dev, init_params=tree)
        t0 = time.perf_counter()
        loss = trainlib.loss_fn(params, trainlib.TrainBatch(*(t.to(dev) for t in batch)), cfg)
        loss.backward()
        log(f"training (a): {label} loss and backward in {time.perf_counter() - t0:.3f} s")
        return loss.item(), grads_of(params)

    ref = loss_and_grads("cpu", "host f32")

    def gaps(label: str, run) -> bool:
        return grad_gaps("training (a)", label, run, ref)

    if not gaps("card f32", loss_and_grads("cuda", "card f32")):
        fail("training (a): the card's f32 loss or gradient is outside its bound")
    # the controls: a step whose products are not f32 must fail the same bounds
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        controls = {"card TF32 (control)": loss_and_grads("cuda", "card TF32")}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    with torch.autocast("cuda", dtype=torch.bfloat16):
        controls["card bf16 autocast (control)"] = loss_and_grads("cuda", "card bf16 autocast")
    passed = [label for label, run in controls.items() if gaps(label, run)]
    if passed:
        fail(f"training (a): {passed} within the f32 bounds: they do not tell f32 from it")
    del ref, controls, tree

    # -- (b) train() at full width, each step timed by CUDA events --------------
    # an event after each optimizer step: step i's time is from the end of step
    # i - 1's update to the end of its own, on the card's clock (the host's
    # batch and loss read between two steps included)
    events = []

    def mark(*_):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    hook = register_optimizer_step_post_hook(mark)
    try:
        with tempfile.TemporaryDirectory() as d:
            data = trainlib.synthetic_dataset(cfg, tok, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, logged = trainlib.train(cfg, data, TRAIN_STEPS, warmup_steps=TRAIN_WARMUP,
                                            checkpoint_dir=d, checkpoint_every=15, log_every=1,
                                            seed=SEED, device="cuda")
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]  # steps 2..30
            del params
            events.clear()
            t0 = time.perf_counter()
            _, resumed = trainlib.train(cfg, data, TRAIN_STEPS + 2, warmup_steps=TRAIN_WARMUP,
                                        checkpoint_dir=d, checkpoint_every=15, resume=True,
                                        log_every=1, device="cuda")
            resume_s = time.perf_counter() - t0
            with open(os.path.join(d, "train_state.json")) as f:
                saved_step = json.load(f)["step"]
    finally:
        hook.remove()
    # where a step's device time goes: one step under the profiler, by kernel
    torch.cuda.empty_cache()
    params, opt_state = trainlib.init_train_state(cfg, adamw, SEED)
    step = trainlib.make_train_step(cfg)
    one = trainlib.TrainBatch(*(t.to("cuda") for t in next(data)))
    traced(f"training step B={TRAIN_BATCH} T={TRAIN_SEQ}", lambda: step(params, opt_state, one))
    # the same steps back to back on that one batch: no data thread, no loss read
    alone = cuda_ms(lambda: step(params, opt_state, one), reps=5, warm=False)
    del params, opt_state
    median = statistics.median(ms[2:])
    flops = train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    log(f"training (b): base() B={TRAIN_BATCH} T={TRAIN_SEQ}, {len(ms) + 1} steps: median step "
        f"{median:.3f} ms by CUDA events after step 3 (min {min(ms[2:]):.3f}, max "
        f"{max(ms[2:]):.3f}; second {ms[0]:.3f}), {TRAIN_BATCH * 1e3 / median:.1f} crops/s; "
        f"{flops / 1e12:.3f} TFLOP a step, {flops / median / 1e9:.2f} TFLOP/s "
        f"({flops / median / 1e9 / (H100_F32_FLOPS / 1e12):.1%} of the f32 peak); peak device "
        f"memory {peak} bytes; train() wall {wall:.3f} s with 2 train-state saves (host "
        f"clock); back to back on one device batch {alone:.3f} ms a step, on {card_line()}")
    log(f"training (b): losses {logged}")
    log(f"training (b): resumed to step {saved_step} in {resume_s:.3f} s, losses {resumed}")
    if (len(logged) != TRAIN_STEPS or len(ms) != TRAIN_STEPS - 1 or len(resumed) != 2
            or saved_step != TRAIN_STEPS + 2 or not all(math.isfinite(x) for x in logged + resumed)):
        fail(f"training (b): {len(logged)} + {len(resumed)} losses, {len(ms)} step times, step "
             f"read back {saved_step}, finite {all(math.isfinite(x) for x in logged + resumed)}")

    # -- (c) the command line with --export-hf, then MangaOcr on its output -----
    crops = load_crops()
    per_dispatch = {"fused_attn_layer": 12, "fused_mlp_block": 12, "greedy_decode_loop": 1,
                    "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}
    with tempfile.TemporaryDirectory() as d:
        out_dir = os.path.join(d, "hf")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = trainlib.main(["--steps", "2", "--seed", str(SEED), "--export-hf", out_dir])
        main_s = time.perf_counter() - t0
        lines = printed.getvalue().splitlines()
        log(f"training (c): main --steps 2 --export-hf in {main_s:.3f} s: {lines}")
        if rc or not any(x.startswith("log[0] loss=") for x in lines) or \
                f"exported HF-format checkpoint to {out_dir}" not in lines:
            fail(f"training (c): main returned {rc}, printed {lines}")
        reader = MangaOcr(out_dir)
        try:
            texts = []
            for i, crop in enumerate(crops):
                text, counts = counted(lambda: reader(crop))
                want = {name: per_dispatch.get(name, 0) for name in counts}
                if counts != want:
                    fail(f"training (c): MangaOcr call {i}: launch counts {counts}, expected {want}")
                texts.append(text)
            log(f"training (c): MangaOcr on the exported directory, {len(crops)} calls, each "
                f"A 12, B 12, C 1 (cluster form); {len(set(texts))} distinct strings: {texts}")
            check_page_tokens(reader.engine, crops, gap_rel=DECODE_GAP_REL)
        finally:
            reader.close()


# Latin recognizer training (train_latin) at the published CRNN width on
# train_latin's command-line defaults; the card's step held to the host's
# with the training phase's bounds (TRAIN_LOSS_REL, TRAIN_GRAD_REL), a TF32
# step outside them.  The f32 gradients of conv0-conv5 are sums over every
# pixel of the rendered lines ahead of the last pool, whose flat paper and ink
# tie the max pools, and they cancel heavily: the card's f32 reductions (cuDNN
# or not) read 1.1e-4 to 1.15e-3 of max |g| off the f64 gradient, the host's
# 1e-5 to 5e-5, while both devices in f64 agree within ~1e-6 on every leaf
# (scripts/torch_latin_numerics.py grads).  So
# the f32 step holds the loss and the other leaves to the bounds and prints
# conv0-conv5; the same step in f64 holds every leaf.  The closed loop is
# tests/test_latin_closed_loop.py's, from JAX's PRNGKey(0) init committed as
# a checkpoint directory (from the port's numpy seed 0 its loss is still ~4.5
# after 2000 steps on the host).  Its escape from the all-blank CTC plateau is
# a heavy-tailed event at these settings: on the host both packages leave it
# at step 1722, but on the card, where the reductions' summation order varies
# from run to run, the same code left it at steps 860 to 2097 in nine runs,
# not by step 2000 in three more and not by 4000 in one; in f64 not by 3000
# in two runs; at B=64 at 985 to 1512 in nine runs and not by 3000 in two
# (scripts/torch_latin_numerics.py escape, and this phase); in this script
# after the earlier phases, four side by side all ended at 2000 between loss
# 0.67 and 3.70.  So four loops run side by side in child processes, data
# seeds 0 (JAX's) to 3, with JAX's settings but a cap of 4000 steps, and the
# first that ends below loss 0.5 and reads 20 of the 24 lines stops the rest.
# The closed loop's short run (phase "closed loop"): the full-size
# closed loop's script (scripts/torch_closed_loop_fullsize.py) at base()
# width for CLOSED_LOOP_STEPS steps of B=32, its held-out read of
# CLOSED_LOOP_EVAL crops and both model-only rates.  A plumbing check:
# so few steps leave the loss near the unigram entropy and the reads wrong.
CLOSED_LOOP_STEPS = 100
CLOSED_LOOP_RATE_ITERS, CLOSED_LOOP_RATE_PASSES = 6, 2  # the model-only rates' calls a pass, passes
CLOSED_LOOP_EVAL = 32


def run_closed_loop() -> None:
    """``run`` of scripts/torch_closed_loop_fullsize.py on the card: its
    render pool (a render process feeding the batches), CLOSED_LOOP_STEPS
    clipped AdamW steps of B=32 on base() in f32 into a temporary
    checkpoint directory, the held-out read of CLOSED_LOOP_EVAL crops
    through the int8 serving engine (A, B, C) and the serving_kernels=False
    bf16 control at max length 300, and ocr_forward's crops/s at budget 300
    and 32 on 256 crops (CLOSED_LOOP_RATE_ITERS calls a pass, CLOSED_LOOP_RATE_PASSES
    passes).  Prints steps/s, the loop's share of time waiting
    on the host for a batch, exact/CER and the rates; fails on a non-finite
    loss, a loss at or above ln(vocab), no checkpoint, or no rate."""
    import math
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_closed_loop_fullsize as cl

    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        s = cl.run(MangaOCRConfig.base(), CharTokenizer.synthetic(), CLOSED_LOOP_STEPS, 32,
                   eval_n=CLOSED_LOOP_EVAL, tp_batch=256, ckpt_dir=path, pool_min=1000,
                   iters=CLOSED_LOOP_RATE_ITERS, passes=CLOSED_LOOP_RATE_PASSES)
        saved = sorted(os.listdir(path))
    info = s["train"]
    log(f"closed loop, base() from scratch: {info['steps']} steps of B=32 in "
        f"{info['train_s']} s ({info['steps_per_s']} steps/s), waiting on the host "
        f"{info['host_share']} of the loop, final loss {info['final_loss']}, pool "
        f"{info['pool']} crops; checkpoint {saved}; held-out {s['eval_n']} crops: int8 serving "
        f"exact {s['exact_fused_int8']} CER {s['cer_fused_int8']}, bf16 control exact "
        f"{s['exact_xla_bf16']} CER {s['cer_xla_bf16']}, agreement {s['fused_vs_xla_agree']}; "
        f"ocr_forward crops/s at budget 300 {s['crops_per_s_budget300_trained']} (median length "
        f"{s['len_median']}), at 32 {s['crops_per_s_budget32']}; {time.time() - t0:.1f} s on "
        f"{card_line()}")
    vocab = MangaOCRConfig.base().decoder.vocab_size
    if not (math.isfinite(info["final_loss"]) and info["final_loss"] < math.log(vocab)):
        fail(f"closed loop: final loss {info['final_loss']} (ln vocab {math.log(vocab):.3f})")
    if "weights.npz" not in saved or not (s["crops_per_s_budget300_trained"] > 0
                                          and s["crops_per_s_budget32"] > 0):
        fail(f"closed loop: checkpoint {saved}, rates {s['crops_per_s_budget300_trained']}, "
             f"{s['crops_per_s_budget32']}")


LATIN_PIXEL_SUMS = tuple(f"features/conv{i}/" for i in range(6))
LATIN_BATCH, LATIN_WIDTH, LATIN_MAX_CHARS, LATIN_LR = 32, 128, 16, 1e-3
LATIN_TIMED_STEPS = 50
LATIN_LOOP_INIT = os.path.join("tests", "fixtures", "latin_closed_loop_init")
LATIN_LOOP_WIDTH, LATIN_LOOP_CHARS, LATIN_LOOP_STEPS = 96, 6, 4000  # JAX's test: 2000
LATIN_LOOP_LINES, LATIN_LOOP_EXACT = 24, 20
LATIN_LOOP_SEEDS, LATIN_LOOP_TIMEOUT_S = (0, 1, 2, 3), 480


def latin_loop(seed: int, out: str) -> None:
    """One closed loop of phase "latin training" (c), run as ``chip_smoke.py
    --latin-loop SEED OUT`` in a child process: JAX's PRNGKey(0) init, the
    synthetic lines of numpy seed ``seed``, adam(1e-3) at B=32 for at most
    2000 steps, stopping after step 100 once the loss is below 0.05; the
    trained tree saved to ``out`` and read back; one JSON line."""
    import torch

    from manga_ocr_tpu_torch import train as trainlib
    from manga_ocr_tpu_torch import train_latin as tl

    init, cfg, charset = tl.load_crnn_checkpoint(os.path.join(ROOT, LATIN_LOOP_INIT), "cuda")
    params, opt_state = tl.init_ctc_train_state(
        cfg, trainlib.make_optimizer(LATIN_LR, weight_decay=0.0), device="cuda", init_params=init)
    step = tl.make_ctc_train_step()
    data = tl.synthetic_line_dataset(cfg, charset, LATIN_BATCH, LATIN_LOOP_WIDTH,
                                     LATIN_LOOP_CHARS, seed=seed)
    t0 = time.perf_counter()
    for i in range(LATIN_LOOP_STEPS):
        params, opt_state, loss = step(params, opt_state, next(data))
        loss = loss.item()
        if i > 100 and loss < 0.05:
            break
    wall = time.perf_counter() - t0
    tl.save_crnn_checkpoint(out, params, cfg, charset)
    reread = dict(trainlib._leaves(tl.load_crnn_checkpoint(out, "cuda")[0]))
    same = all(torch.equal(t.detach(), reread[name]) for name, t in trainlib._leaves(params))
    print(json.dumps({"seed": seed, "steps": i + 1, "loss": loss, "s": wall, "reread": same}),
          flush=True)


def run_latin_training() -> None:
    """``manga_ocr_tpu_torch.train_latin`` on the card: (a) one step of the
    full-width CRNN (96 classes, output 512, hidden 256, height 32; numpy
    seed-0 weights; B=32, width 128, max 16 characters, adamw(1e-3)) card
    against host with the process's TF32 flags on (the step holds them
    off): the loss and every leaf's gradient but conv0-conv5's (printed) in
    f32, every leaf in f64; the same f32 loss and backward with cuDNN's and
    matmul's TF32 on outside the f32 bounds; (b) 50 steps timed by
    CUDA events: median and worst step, lines/s, peak device memory, the
    share of the card's time idle between steps while the host renders the
    next batch, one profiled step's top five kernels; (c) the closed loop
    (digits, output 64, hidden 48, width 96, B=32, adam(1e-3) from JAX's
    PRNGKey(0) init, at most 2000 steps) in four child processes side by
    side, data seeds 0-3 (``latin_loop``): each trained tree saved and read
    back bit for bit, each one below loss 0.5 loaded on the card and read
    by TorchLatinEngine on 24 held-out lines; at least one must read 20
    exactly (see LATIN_LOOP_SEEDS); (d) ``main(["--steps", "20",
    "--out", DIR])`` at its defaults, the directory loaded back."""
    import contextlib
    import math
    import statistics
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from manga_ocr_tpu_torch import train as trainlib
    from manga_ocr_tpu_torch import train_latin as tl
    from manga_ocr_tpu_torch.engine.latin import DEFAULT_CHARSET, TorchLatinEngine
    from manga_ocr_tpu_torch.models import crnn

    cfg = crnn.CrnnConfig(num_classes=len(DEFAULT_CHARSET) + 1)
    tree = crnn.init_crnn_params(cfg, SEED, "cpu")
    data = tl.synthetic_line_dataset(cfg, DEFAULT_CHARSET, LATIN_BATCH, LATIN_WIDTH,
                                     LATIN_MAX_CHARS, seed=SEED)
    batch = next(data)
    adamw = trainlib.make_optimizer(LATIN_LR, weight_decay=tl.ADAMW_DECAY)
    step = tl.make_ctc_train_step()
    log(f"latin training: CrnnConfig {cfg} ({len(DEFAULT_CHARSET)} characters), "
        f"{sum(t.numel() for _, t in trainlib._leaves(tree))} parameters, B={LATIN_BATCH}, "
        f"width {LATIN_WIDTH} ({tl._ctc_frames(LATIN_WIDTH)} frames), max {LATIN_MAX_CHARS} "
        f"characters")

    @contextlib.contextmanager
    def tf32():
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    def grads_of(params) -> dict:
        return {name: t.grad.cpu() for name, t in trainlib._leaves(params)}

    # -- (a) one step, card against host (f32, then f64); a TF32 control ----------
    def one_step(dev: str, label: str):
        params, opt_state = tl.init_ctc_train_state(cfg, adamw, device=dev, init_params=tree)
        t0 = time.perf_counter()
        _, _, loss = step(params, opt_state, batch)
        loss = loss.item()
        log(f"latin training (a): {label} step in {time.perf_counter() - t0:.3f} s")
        return loss, grads_of(params)

    def held(run):
        loss, grads = run
        return loss, {n: g for n, g in grads.items() if not n.startswith(LATIN_PIXEL_SUMS)}

    def pixel_sums(label: str, run, ref) -> None:
        gaps = {n: float((run[1][n] - g).abs().max() / g.abs().max())
                for n, g in ref[1].items() if n.startswith(LATIN_PIXEL_SUMS)}
        log(f"latin training (a): {label}, conv0-conv5 (printed, not held in f32): gap / max|g| "
            + ", ".join(f"{n} {v:.2e}" for n, v in gaps.items()))

    ref = one_step("cpu", "host f32")
    with tf32():  # the process's flags on: the step holds TF32 off itself
        card = one_step("cuda", "card f32 (process TF32 flags on)")
    if not grad_gaps("latin training (a)", "card f32, all but conv0-conv5", held(card), held(ref)):
        fail("latin training (a): the card's f32 loss or gradient is outside its bound")
    pixel_sums("card f32", card, ref)
    params, _ = tl.init_ctc_train_state(cfg, adamw, device="cuda", init_params=tree)
    with tf32():
        loss = tl.ctc_loss_fn(params, tl.CtcBatch(*(t.cuda() for t in batch)))
        loss.backward()
    control = (loss.item(), grads_of(params))
    pixel_sums("card TF32 (control)", control, ref)
    if grad_gaps("latin training (a)", "card TF32 (control), all but conv0-conv5", held(control),
                 held(ref)):
        log("latin training (a): the TF32 control is WITHIN the f32 bounds: they do not tell "
            "TF32 from f32 on this step (reported; nothing widened)")

    def f64_run(dev: str):
        """The network in f64 (the CTC recurrence in f32, as ctc_loss casts)."""
        def f64(node):
            if isinstance(node, dict):
                return {k: f64(v) for k, v in node.items()}
            return node.detach().to(dev, torch.float64).requires_grad_(True)

        params = f64(tree)
        loss = tl.ctc_loss_fn(params, tl.CtcBatch(batch.images.to(dev, torch.float64),
                                                  batch.labels.to(dev),
                                                  batch.label_paddings.to(dev)))
        loss.backward()
        return loss.item(), grads_of(params)

    if not grad_gaps("latin training (a)", "card f64 against host f64, every leaf",
                     f64_run("cuda"), f64_run("cpu")):
        fail("latin training (a): the card's f64 loss or gradient is outside its bound")
    del params, ref, card, control

    # -- (b) the step timed: CUDA events around each step, the host's next() apart --
    params, opt_state = tl.init_ctc_train_state(cfg, adamw, device="cuda", init_params=tree)
    step(params, opt_state, batch)  # warm: cuDNN's plans, the allocator
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    starts, ends, host_s, losses = [], [], 0.0, []
    t0 = time.perf_counter()
    for _ in range(LATIN_TIMED_STEPS):
        h0 = time.perf_counter()
        b = next(data)
        host_s += time.perf_counter() - h0
        starts.append(torch.cuda.Event(enable_timing=True))
        starts[-1].record()
        params, opt_state, loss = step(params, opt_state, b)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(e) for a, e in zip(starts, ends)]
    idle = [e.elapsed_time(a) for e, a in zip(ends, starts[1:])]
    losses = [x.item() for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f"latin training (b): losses {losses}")
    median = statistics.median(ms)
    busy = sum(ms)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    rows = device_ms_by_kernel(prof)
    total = sum(r[1] for r in rows)
    log(f"latin training (b): {LATIN_TIMED_STEPS} steps B={LATIN_BATCH} width {LATIN_WIDTH}: "
        f"median step {median:.3f} ms by CUDA events (worst {max(ms):.3f}, best {min(ms):.3f}), "
        f"{LATIN_BATCH * 1e3 / median:.1f} lines/s a step, {LATIN_TIMED_STEPS * LATIN_BATCH / wall:.1f} "
        f"lines/s by the host clock over the run ({wall:.3f} s); the card idle between steps "
        f"{sum(idle):.3f} ms of {busy + sum(idle):.3f} ({sum(idle) / (busy + sum(idle)):.1%}) "
        f"while the host renders the next batch (next(): {host_s * 1e3 / LATIN_TIMED_STEPS:.3f} "
        f"ms a batch, {host_s / wall:.1%} of the wall); peak device memory {peak} bytes; "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; on {card_line()}")
    log(f"latin training (b): one profiled step, device ms {total:.4f} in {len(rows)} kernels; "
        f"the top five (ms, share, launches):")
    for name, kms, n in rows[:5]:
        log(f"  {kms:10.4f} ms  {kms / total:6.1%}  {n:6d}  {name[:110]}")
    del params, opt_state

    # -- (c) the closed loop on the card, read back through TorchLatinEngine ------
    _, lcfg, charset = tl.load_crnn_checkpoint(LATIN_LOOP_INIT, "cpu")
    rng = np.random.default_rng(7)
    refs, crops = [], []
    for _ in range(LATIN_LOOP_LINES):
        n = int(rng.integers(1, LATIN_LOOP_CHARS + 1))
        text = "".join(charset[k] for k in rng.integers(0, len(charset), size=n))
        img, drawn = tl.render_line(text, charset, lcfg.input_height, LATIN_LOOP_WIDTH, rng)
        refs.append(text[:drawn])
        crops.append(img)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = {seed: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--latin-loop", str(seed),
             os.path.join(d, str(seed))], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, OMP_NUM_THREADS="1")) for seed in LATIN_LOOP_SEEDS}
        runs, winner = {}, None
        try:
            # read each loop as it ends; the first that reads stops the others
            while winner is None and len(runs) < len(procs):
                if time.perf_counter() - t0 > LATIN_LOOP_TIMEOUT_S:
                    fail(f"latin training (c): the closed loops ran past {LATIN_LOOP_TIMEOUT_S} s")
                for seed, proc in procs.items():
                    if seed in runs or proc.poll() is None:
                        continue
                    out, err = proc.communicate()
                    if proc.returncode:
                        fail(f"latin training (c): loop {seed} exited {proc.returncode}: "
                             f"{err[-2000:]}")
                    run = runs[seed] = json.loads(out.strip().splitlines()[-1])
                    run["at_s"], run["exact"] = time.perf_counter() - t0, None
                    if not run["reread"]:
                        fail(f"latin training (c): loop {seed}'s directory does not read back "
                             f"as its trained tree")
                    if run["loss"] < 0.5:
                        loaded, got_cfg, got_charset = tl.load_crnn_checkpoint(
                            os.path.join(d, str(seed)), "cuda")
                        if (got_cfg, got_charset) != (lcfg, charset):
                            fail(f"latin training (c): loop {seed}'s directory reads as "
                                 f"{got_cfg}, {got_charset!r}")
                        eng = TorchLatinEngine(
                            crnn_params=loaded, crnn_cfg=lcfg, charset=charset, device="cuda",
                            rec_width_buckets=(LATIN_LOOP_WIDTH, 2 * LATIN_LOOP_WIDTH))
                        got = eng.recognize_lines(crops)
                        run["exact"] = sum(g == r for g, r in zip(got, refs))
                        run["pairs"] = list(zip(refs, got))[:4]
                    log(f"latin training (c): data seed {seed}: {run['steps']} steps in "
                        f"{run['s']:.3f} s ({run['s'] * 1e3 / run['steps']:.3f} ms a step with "
                        f"the loss read, beside the other loops), final loss {run['loss']:.4f}; "
                        f"the saved tree read back bit for bit; "
                        + (f"reloaded on the card, {run['exact']}/{LATIN_LOOP_LINES} held-out "
                           f"lines read exactly (first pairs {run['pairs']})"
                           if run["exact"] is not None else "not read (loss >= 0.5)"))
                    if run["exact"] is not None and run["exact"] >= LATIN_LOOP_EXACT:
                        winner = seed
                        break
                time.sleep(0.2)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
    stopped = [seed for seed in LATIN_LOOP_SEEDS if seed not in runs]
    log(f"latin training (c): data seed {winner} trained a recognizer that reads, "
        f"{runs[winner]['at_s'] if winner is not None else float('nan'):.3f} s after the "
        f"{len(procs)} loops started (host clock); ended without reading: "
        f"{[s for s in runs if s != winner]}; stopped unfinished: {stopped}; on {card_line()}")
    if winner is None:
        fail(f"latin training (c): no closed loop trained a recognizer that reads: {runs}")

    # -- (d) the command line at its defaults ------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "latin")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = tl.main(["--steps", "20", "--out", out])
        main_s = time.perf_counter() - t0
        lines = printed.getvalue().splitlines()
        log(f"latin training (d): main --steps 20 --out DIR in {main_s:.3f} s (host clock) on "
            f"{card_line()}: {lines}")
        if rc or [x.split("=")[0] for x in lines] != ["step 0: ctc_loss", "step 19: ctc_loss",
                                                       f"saved {out}"] or \
                not all(math.isfinite(float(x.split("=")[1])) for x in lines[:2]):
            fail(f"latin training (d): main returned {rc}, printed {lines}")
        _, got_cfg, got_charset = tl.load_crnn_checkpoint(out, "cuda")
        if (got_cfg, got_charset) != (cfg, DEFAULT_CHARSET):
            fail(f"latin training (d): the directory reads as {got_cfg}, charset "
                 f"{got_charset!r}")


# -- the detection phase ---------------------------------------------------------

DET_PAGES = 8
DET_CHAPTER = 32  # a chapter folder's pages of one scan size
DET_PAGE_HW = (1700, 1200)  # a common scan size for manga raws
# The segmenter runs f32 with TF32 off on both devices: its probabilities
# differ by summation order only.  A mask pixel may flip where the host's
# probability lies this close to the threshold; elsewhere masks are equal.
DET_PROB_ATOL = 1e-4
DET_MASK_EPS = 1e-3
DET_INIT = os.path.join("tests", "fixtures", "detector_closed_loop_init.npz")


# The int8 engine's launches per ocr_page dispatch (kernels A, B, C).
INT8_PER_DISPATCH = {"fused_attn_layer": 12, "fused_mlp_block": 12, "greedy_decode_loop": 1,
                     "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}


def ocr_engine():
    """The int8 engine at base() width (kernels A, B, C), after its first call."""
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    cfg = MangaOCRConfig.base()
    engine = TorchMangaOcrEngine(init_params(cfg, SEED, "cpu", std=WEIGHT_STD), cfg,
                                 CharTokenizer.synthetic(), device="cuda")
    engine.ocr_page(load_crops()[:2])  # first call: library load, allocator growth
    return engine


def unet_flops(cfg) -> float:
    """2 x the multiply-adds of the U-Net's convolutions on one page."""
    from manga_ocr_tpu_torch.models.detector import _channels

    total = 0.0
    # paths: ("down" | "up", level, conv), ("mid", conv), ("head",)
    for path, cin, cout, k in _channels(cfg):
        level = cfg.depth if path[0] == "mid" else path[1] if len(path) == 3 else 0
        side = cfg.input_size >> level
        total += 2.0 * side * side * cin * cout * k * k
    return total


def paste_text(page, rng, y0: int, x0: int, h: int, w: int, chars: list) -> None:
    """Ink of a ``train.render_text_crop`` column of random characters, drawn
    at 3x into ``page`` [y0:y0+h, x0:x0+w] (its paper and border left out)."""
    import numpy as np

    from manga_ocr_tpu_torch.train import render_text_crop

    text = "".join(rng.choice(chars, size=int(rng.integers(3, 9))))
    crop = render_text_crop(text, rng, 64, hw=(max(8, h // 3), max(8, w // 3)))[..., 0]
    crop = np.repeat(np.repeat(crop, 3, axis=0), 3, axis=1)[:h, :w]
    region = page[y0 : y0 + crop.shape[0], x0 : x0 + crop.shape[1]]
    ink = crop < 128
    region[ink] = crop[ink][:, None]


def detection_pages(n: int, seed: int) -> tuple[list, list]:
    """``n`` bubble pages of DET_PAGE_HW (the closed loop's drawer, numpy
    only) with a column of glyph text in each bubble; and the bubble counts."""
    import numpy as np

    from manga_ocr_tpu_torch.core.geometry import polygon_bounding_rect
    from manga_ocr_tpu_torch.detect import contours as cont
    from manga_ocr_tpu_torch.detect import synthetic
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    chars = [t for t in CharTokenizer.synthetic().id_to_token[4:] if len(t) == 1]
    rng = np.random.default_rng(seed)
    pages, drawn = [], []
    while len(pages) < n:
        page, gt, k = synthetic.draw_page(rng, *DET_PAGE_HW)
        if k == 0:
            continue
        for poly in cont.mask_to_polygons(gt):
            r = polygon_bounding_rect(poly)
            h, w = int(r.h * 0.6), 60
            paste_text(page, rng, r.top + (r.h - h) // 2, r.left + (r.w - w) // 2, h, w, chars)
        pages.append(page)
        drawn.append(k)
    return pages, drawn


def text_page(seed: int):
    """A white DET_PAGE_HW page with eight columns of glyph text: the
    text-mode detector's input."""
    import numpy as np

    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    chars = [t for t in CharTokenizer.synthetic().id_to_token[4:] if len(t) == 1]
    rng = np.random.default_rng(seed)
    page = np.full((*DET_PAGE_HW, 3), 255, np.uint8)
    for col in range(8):
        h = int(rng.integers(240, 600))
        paste_text(page, rng, int(rng.integers(60, DET_PAGE_HW[0] - h - 60)), 80 + col * 135,
                   h, 60, chars)
    return page


def tracer_matches_cv2(got: list, ref: list) -> bool:
    """The native tracer's polygons against cv2's external contours of the
    same mask, by bounding box: every cv2 component of three or more pixels
    is found with its box, and every other traced component lies inside a
    cv2 component's box (the tracer also traces islands in holes, which
    RETR_EXTERNAL leaves out, and drops one- and two-pixel components)."""
    from manga_ocr_tpu_torch.core.geometry import polygon_bounding_rect

    def box(p):
        r = polygon_bounding_rect(p)
        return (r.left, r.top, r.right, r.bottom)

    def inside(b):
        return any(o != b and o[0] <= b[0] and o[1] <= b[1] and b[2] <= o[2] and b[3] <= o[3]
                   for o in outer)

    def small(b):
        return (b[2] - b[0] + 1) * (b[3] - b[1] + 1) <= 2

    traced = {box(p) for p in got}
    outer = [box(p) for p in ref]
    return (all(b in traced for b in outer if not small(b))
            and all(b in outer or inside(b) for b in traced))


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def iou(a, b) -> float:
    import numpy as np

    union = np.logical_or(a > 0, b > 0).sum()
    return float(np.logical_and(a > 0, b > 0).sum() / union) if union else 1.0


def run_detection():
    """The detection path on the card (no kernel: plain PyTorch on the
    device; host contours on the machine's default tier, cv2 where OpenCV is
    installed, else the native tracer; the native tracer must build, and is
    timed and held against cv2's findContours on (a)'s masks where OpenCV
    is there).  (a) The
    full-width segmenter (DetectorConfig(): 512, base 32, depth 4) on numpy
    seed-0 weights over DET_PAGES pages of DET_PAGE_HW: card against host
    (f32) on two pages -- probabilities within
    DET_PROB_ATOL, masks equal except where the host's probability is within
    DET_MASK_EPS of the threshold -- with the process's TF32 flags on, which
    segment_pages must override (a TF32 run is printed beside it, not held);
    segment_pages at B=1, 2, DISPATCH_PAGES, DISPATCH_PAGES + 2 and
    DET_PAGES by CUDA events with each one's peak device memory;
    DET_CHAPTER pages through detect_bubble_masks; the host contour time a
    page by tier and detect_pages' pages/s.  (b) The JAX closed
    loop on the card: its config trained from its initial weights
    (DET_INIT) for 150 steps, then detect_pages on 6 held-out 96x128 pages:
    exact bubble counts, IoU >= 0.6 a page and >= 0.75 on average.  (c)
    PagePipeline(engine.ocr_page).process_pages over DET_PAGES pages with
    (b)'s detector and the int8 engine at base() width: A 12, B 12, C 1 a
    dispatch exactly, every job's text equal to engine.ocr_page on the same
    crops, every JobResult with its TypesetArea.  (d) detect_text_regions on
    one page through the engine: every proposal read in one ocr_page call.
    Returns (c)'s engine and the stage that phase "inpaint" erases: (c)'s
    page with the most regions and its JobResults."""
    import numpy as np
    import torch

    from manga_ocr_tpu_torch import native
    from manga_ocr_tpu_torch.detect import contours as cont
    from manga_ocr_tpu_torch.detect import synthetic
    from manga_ocr_tpu_torch.detect.detector import DISPATCH_PAGES, BubbleDetector
    from manga_ocr_tpu_torch.detect.text_detect import detect_text_regions
    from manga_ocr_tpu_torch.models import detector as seg
    from manga_ocr_tpu_torch.ops.image import resize_bilinear
    from manga_ocr_tpu_torch.parallel import batching
    from manga_ocr_tpu_torch.runtime.pipeline import PagePipeline
    from manga_ocr_tpu_torch.typeset.area import TypesetArea

    card = card_line()
    if native.load() is None:
        fail("detection: the native mask library did not build")
    cv2 = cont.cv2 if cont.HAS_CV2 else None
    default_tier = "cv2" if cv2 is not None else "native"
    log(f"detection: OpenCV {cv2.__version__ + ' present' if cv2 else 'absent'}; host contours "
        f"on the {default_tier} tier")
    for tier in cont.TIER_COUNTS:
        cont.TIER_COUNTS[tier] = 0
    h, w = DET_PAGE_HW

    # -- (a) full width: card against host, times -----------------------------------
    cfg = seg.DetectorConfig()
    tree = seg.init_params(cfg, SEED, "cpu")
    det = BubbleDetector(tree, cfg, device="cuda")
    flops = unet_flops(cfg)
    t0 = time.time()
    chapter, drawn = detection_pages(DET_CHAPTER, SEED)
    pages = chapter[:DET_PAGES]
    log(f"detection (a): {DET_CHAPTER} pages of {h}x{w} drawn in {time.time() - t0:.1f} s, "
        f"{sum(drawn[:DET_PAGES])} bubbles on the first {DET_PAGES}; U-Net {cfg}: "
        f"{sum(p.numel() for p in det._net.parameters())} parameters, "
        f"{flops / 1e9:.2f} GFLOP a page")
    rgb = np.ascontiguousarray(np.stack(pages)[..., ::-1])
    t0 = time.time()
    host = seg.segment_probs(tree, rgb[:2], cfg, h, w).numpy()  # the tree is on the host
    host_s = time.time() - t0
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        prob = seg.segment_probs(det._net, rgb[:2], cfg, h, w).cpu().numpy()
        mask = seg.segment_pages(det._net, rgb[:2], cfg, h, w).cpu().numpy()
        flags_after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        with torch.no_grad():  # the control: the same graph with TF32 products
            x = resize_bilinear(torch.from_numpy(rgb[:2]).cuda(), cfg.input_size,
                                cfg.input_size, channels_last=True)
            p32 = seg.forward(det._net, (x / 255.0).permute(0, 3, 1, 2).contiguous(), cfg)
            tf32 = resize_bilinear(p32, h, w, channels_last=False).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    if flags_after != (True, True):
        fail(f"detection (a): segment_pages left the TF32 flags at {flags_after}")
    err = float(np.abs(prob - host).max())
    near = np.abs(host - cfg.threshold) <= DET_MASK_EPS
    host_mask = (host > cfg.threshold).astype(np.uint8) * 255
    flipped = int(((mask != host_mask) & ~near).sum())
    log(f"detection (a): card vs host on 2 pages (host {host_s:.1f} s): max |p| diff {err:.3e} "
        f"(bound {DET_PROB_ATOL}); mask share {float((mask > 0).mean()):.4f}; "
        f"{int(near.sum())} of {near.size} pixels within {DET_MASK_EPS} of the threshold, "
        f"{int((mask != host_mask).sum())} differ, {flipped} of them outside; TF32 control "
        f"(not held): max |p| diff {float(np.abs(tf32 - host).max()):.3e}")
    if err > DET_PROB_ATOL or flipped:
        fail(f"detection (a): card and host disagree: {err} > {DET_PROB_ATOL} or {flipped} "
             f"mask pixels flipped away from the threshold")
    dev_pages = torch.from_numpy(rgb).cuda()
    ms, peak = {}, {}
    for b in sorted({1, 2, DISPATCH_PAGES, DISPATCH_PAGES + 2, DET_PAGES}):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms[b] = cuda_ms(lambda: seg.segment_pages(det._net, dev_pages[:b], cfg, h, w)) / b
        peak[b] = torch.cuda.max_memory_allocated() / 2**30
    traced(f"segment_pages B={DISPATCH_PAGES}",
           lambda: seg.segment_pages(det._net, dev_pages[:DISPATCH_PAGES], cfg, h, w))
    del dev_pages
    torch.cuda.empty_cache()
    det.detect_bubble_masks(chapter[:DISPATCH_PAGES])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chapter_masks = det.detect_bubble_masks(chapter)
    chapter_ms = (time.perf_counter() - t0) * 1e3 / len(chapter)
    chapter_peak = torch.cuda.max_memory_allocated() / 2**30
    masks = chapter_masks[:DET_PAGES]
    t0 = time.perf_counter()
    polys = [cont.mask_to_polygons(m, min_area=det.min_area) for m in masks]
    contour_ms = (time.perf_counter() - t0) * 1e3 / len(masks)
    t0 = time.perf_counter()
    traced_polys = [native.trace_external_contours(m) for m in masks]
    native_ms = (time.perf_counter() - t0) * 1e3 / len(masks)
    if cv2 is not None:
        for m, got in zip(masks, traced_polys):
            ref, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
            if not tracer_matches_cv2(got, [c.reshape(-1, 2) for c in ref]):
                fail("detection (a): the native tracer's components differ from cv2's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.detect_pages(chapter)
    torch.cuda.synchronize()
    rate = len(chapter) / (time.perf_counter() - t0)
    log(f"detection (a): segment_pages from device-resident uint8 pages, ms a page (peak device "
        f"memory): " + ", ".join(f"B={b} {ms[b]:.3f} ({peak[b]:.2f} GiB)" for b in ms)
        + f"; at B={DISPATCH_PAGES} {flops / ms[DISPATCH_PAGES] / 1e9:.1f} TFLOP/s, "
        f"{flops / ms[DISPATCH_PAGES] / 1e9 / (H100_F32_FLOPS / 1e12):.1%} of the f32 peak; "
        f"a chapter of {len(chapter)} pages through detect_bubble_masks ({DISPATCH_PAGES} a "
        f"dispatch) {chapter_ms:.3f} ms a page by the host clock, peak {chapter_peak:.2f} GiB; "
        f"host contours on the {default_tier} tier {contour_ms:.2f} ms a page, the native tracer "
        f"{native_ms:.2f} ms a page{' (its components = cv2 components)' if cv2 else ''}, "
        f"regions {[len(p) for p in polys]}; detect_pages over the chapter {rate:.2f} pages/s "
        f"on {card}")
    del det
    torch.cuda.empty_cache()

    # -- (b) the closed loop on the card ---------------------------------------------
    cl_cfg = synthetic.CLOSED_LOOP_CFG
    t0 = time.time()
    net, losses = synthetic.train_segmenter(
        seg.load_params(os.path.join(ROOT, DET_INIT), cl_cfg, "cuda"), cl_cfg, device="cuda")
    torch.cuda.synchronize()
    train_s = time.time() - t0
    if not all(np.isfinite(losses)) or losses[-1] >= 0.15:
        fail(f"detection (b): the segmenter did not train: losses {losses[0]} .. {losses[-1]}")
    cl_det = BubbleDetector(net, cl_cfg, min_area=80.0, device="cuda")
    rng = np.random.default_rng(42)
    held, gts, counts = [], [], []
    while len(held) < 6:
        bgr, gt, n = synthetic.draw_page(rng, *synthetic.CLOSED_LOOP_PAGE_HW)
        if n:
            held.append(bgr)
            gts.append(gt)
            counts.append(n)
    ious, got_counts = [], []
    for dets, gt in zip(cl_det.detect_pages(held), gts):
        pred = np.zeros_like(gt)
        for d in dets:
            cont.fill_polygon(pred, np.asarray(d["polygon"]), 255)
        ious.append(iou(pred, gt))
        got_counts.append(len(dets))
    log(f"detection (b): closed loop trained in {train_s:.1f} s ({len(losses)} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}); held-out bubbles {got_counts} of {counts}, "
        f"IoU {[round(v, 4) for v in ious]} (mean {float(np.mean(ious)):.4f}) on {card}")
    if got_counts != counts or min(ious) < 0.6 or float(np.mean(ious)) < 0.75:
        fail("detection (b): the closed loop missed JAX's bounds (exact counts, IoU >= 0.6 "
             "a page, >= 0.75 on average)")

    # -- (c) the page path: detect -> crop -> OCR --------------------------------------
    engine = ocr_engine()
    tpages, drawn = detection_pages(DET_PAGES, SEED + 1)
    items = [(f"page{i:02d}.png", p) for i, p in enumerate(tpages)]
    pipe = PagePipeline(engine.ocr_page)
    t0 = time.perf_counter()
    out, launch = counted(lambda: pipe.process_pages(items, cl_det.detect_bubbles))
    wall = time.perf_counter() - t0
    pipe.close()
    per_page = [out[p] for p, _ in items]
    n_jobs = sum(len(rs) for rs in per_page)
    n_dispatch = sum(len(batching.prep_page_gray([r.job.cropped_image for r in rs], 1))
                     for rs in per_page if rs)
    per = INT8_PER_DISPATCH
    want = {name: per.get(name, 0) * n_dispatch for name in launch}
    log(f"detection (c): process_pages over {len(items)} pages: {n_jobs} regions found against "
        f"{sum(drawn)} bubbles drawn ({[len(rs) for rs in per_page]} / {drawn}), "
        f"{n_dispatch} dispatches, launches {nonzero(launch)}; {n_jobs / wall:.2f} crops/s "
        f"({wall:.2f} s) on {card}")
    if not n_jobs:
        fail("detection (c): no region found on any page")
    if launch != want:
        fail(f"detection (c): launch counts {launch}, expected {want}")
    if not all(isinstance(r.area, TypesetArea) and r.error is None for rs in per_page for r in rs):
        fail("detection (c): a JobResult without its TypesetArea")
    for rs in per_page:
        if rs and engine.ocr_page([r.job.cropped_image for r in rs]) != [r.original_text
                                                                         for r in rs]:
            fail("detection (c): a page's texts differ from engine.ocr_page on its crops")
    log(f"detection (c): every job's text equals engine.ocr_page on its page's crops; "
        f"texts {[r.original_text for r in per_page[0]]}")
    most = max(range(len(items)), key=lambda i: len(per_page[i]))
    stage = (tpages[most], per_page[most])

    # -- (d) text mode ----------------------------------------------------------------
    page = text_page(SEED)
    calls = []

    def ocr_page(crops):
        calls.append(list(crops))
        return engine.ocr_page(crops)

    t0 = time.perf_counter()
    regions, launch = counted(lambda: detect_text_regions(page, ocr_page))
    text_s = time.perf_counter() - t0
    if len(calls) != 1:
        fail(f"detection (d): {len(calls)} ocr_page calls, expected one")
    n_dispatch = len(batching.prep_page_gray(calls[0], 1))
    want = {name: per.get(name, 0) * n_dispatch for name in launch}
    log(f"detection (d): detect_text_regions: {len(calls[0])} proposals read in one ocr_page "
        f"call ({n_dispatch} dispatches, launches {nonzero(launch)}), {len(regions)} regions kept, "
        f"{text_s * 1e3:.1f} ms on {card}")
    if launch != want:
        fail(f"detection (d): launch counts {launch}, expected {want}")
    ran = nonzero(cont.TIER_COUNTS)
    if list(ran) != [default_tier]:
        fail(f"detection: host contours ran on tiers {ran}, not the {default_tier} one")
    log(f"detection: host contour tier {default_tier} ({ran})")
    return engine, stage


# -- the other detector and recognizer families: ONNX, YOLOv8-seg, CRAFT + CRNN -----

# The ONNX executor against the port's own UNet on the card: one function
# (the same convolutions, bias added apart) through two routes, f32 with TF32
# off in both; they differ by cuDNN's algorithm choice only.
ONNX_ROUTES_ATOL = 1e-5
# The executor's page mask goes through uint8 and PIL before its threshold: a
# pixel may flip card against host where the uint8 maps differ by one step and
# the host's resized value lies this close to 0.5.
ONNX_MASK_EPS = 2.0 / 255
# YOLO, CRAFT and CRNN card against host, f32 with TF32 off on both: the
# largest difference relative to the host output's largest magnitude.
FAMILY_REL = 1e-5
# Random YOLO heads put sigmoid(cls) near 0.5 (their cls logits lie within
# ~0.03 of 0), so every anchor passes conf_threshold 0.25 and the host's O(n^2)
# NMS and page-sized masks dominate.  A trained model's scores pass on few
# anchors: the stand-in lowers the cls branches' output bias so that this many
# anchors a page pass (the median over the pages; the bias is read off this
# run's logits, and the counts at the biases around it are printed).
YOLO_CANDIDATES = 8
# Random CRAFT maps are near flat (within ~0.003 of 0.048 over a page) and
# peak along the padded page's edges: no box, or one page-sized one.  The
# stand-in for a trained model's maps refits the last 1x1 conv as a
# least-squares probe of the head's features onto the ink of phase
# "detection"'s glyph page, scaled so that the probe's top ink share of that
# page's pixels reach low_text, and this fraction of it text_threshold.
CRAFT_PEAK_SHARE = 0.25
# A chapter through detect_boxes_batch may take this many times the peak
# device memory of one page's CRAFT dispatch (DISPATCH_PAGES and DISPATCH_PIXELS
# bound it).
LATIN_CHAPTER_PEAK = 1.25
LATIN_LINES = 320


def family_err(got, want) -> float:
    """max |got - want| over the largest |want| (both moved to the host)."""
    import numpy as np

    got, want = (np.asarray(v.detach().float().cpu() if hasattr(v, "detach") else v)
                 for v in (got, want))
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def flops_of(fn) -> float:
    """The FLOPs torch's counter attributes to ``fn`` (2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def peak_gib(fn):
    """``fn()`` and the peak device memory it allocated, in GiB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def run_onnx() -> None:
    """The ONNX executor on the card (no kernel: plain PyTorch).  The
    full-width DetectorConfig() U-Net on phase "detection"'s seed-0 weights,
    written as an ONNX graph by the port's writer (convert_onnx.unet_graph)
    to a temporary file and opened by BubbleDetector.from_checkpoint: the
    executor's [512, 512] probability map on the card against the port's own
    UNet forward on the card (ONNX_ROUTES_ATOL) and against the executor on
    the host (DET_PROB_ATOL); detect_bubble_masks over DET_PAGES pages of
    DET_PAGE_HW (one page at a time, the PIL resizes on the host) with ms a
    page by CUDA events (the graph) and by the host clock (the page), the
    peak device memory, and the mask pixels flipped card against host on
    those pages (none outside ONNX_MASK_EPS of the threshold)."""
    import tempfile

    import numpy as np
    import torch

    from manga_ocr_tpu_torch.detect.detector import BubbleDetector, OnnxWrappedDetector
    from manga_ocr_tpu_torch.models import convert_onnx, onnx_lite
    from manga_ocr_tpu_torch.models import detector as seg

    card = card_line()
    cfg = seg.DetectorConfig()
    tree = seg.init_params(cfg, SEED, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "unet.onnx")
        t0 = time.perf_counter()
        onnx_lite.save_model(convert_onnx.unet_graph(tree, cfg), path)
        write_s, size = time.perf_counter() - t0, os.path.getsize(path)
        t0 = time.perf_counter()
        det = BubbleDetector.from_checkpoint(path)
        load_s = time.perf_counter() - t0
    if not isinstance(det, OnnxWrappedDetector) or det._onnx.device.type != "cuda":
        fail(f"onnx: from_checkpoint gave {type(det).__name__} on {det._onnx.device}")
    onnx = det._onnx
    ops = sorted({n.op_type for n in onnx.graph.nodes})
    x = torch.from_numpy(np.random.default_rng(SEED).random((1, 3, 512, 512), dtype=np.float32))
    card_prob = onnx.probabilities(x)[0, 0]
    net = BubbleDetector(tree, cfg, device="cuda")._net
    with seg.fp32_products(), torch.no_grad():
        direct = seg.forward(net, x.cuda(), cfg)[0]
    routes = float((card_prob - direct).abs().max())
    t0 = time.perf_counter()
    with torch.no_grad():
        host_prob = convert_onnx.run_graph(onnx.graph, {onnx.input_name: x})[0][0, 0]
    host_s = time.perf_counter() - t0
    host_err = float((card_prob.cpu() - host_prob).abs().max())
    log(f"onnx: U-Net {cfg} as a graph of {len(onnx.graph.nodes)} nodes ({', '.join(ops)}), "
        f"{size / 2**20:.1f} MiB written in {write_s:.2f} s, from_checkpoint {load_s:.2f} s; "
        f"[512, 512] map: executor vs UNet on the card max |p| diff {routes:.3e} (bound "
        f"{ONNX_ROUTES_ATOL}), card vs host executor {host_err:.3e} (bound {DET_PROB_ATOL}; host "
        f"{host_s:.1f} s)")
    if routes > ONNX_ROUTES_ATOL or host_err > DET_PROB_ATOL:
        fail("onnx: the executor disagrees with the UNet forward or with the host")
    pages, _ = detection_pages(DET_PAGES, SEED)
    det.detect_bubble_masks(pages[:1])  # warm
    t0 = time.perf_counter()
    masks, peak = peak_gib(lambda: det.detect_bubble_masks(pages))
    page_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
    graph_ms = cuda_ms(lambda: onnx.probabilities(x))
    host_det = convert_onnx.OnnxBubbleDetector(onnx.graph, device="cpu")
    flipped = near = differ = 0
    t0 = time.perf_counter()
    for page, mask in zip(pages, masks):
        host_map = host_det.page_probabilities(page)
        band = np.abs(host_map - 0.5) <= ONNX_MASK_EPS
        diff = mask != (host_map > 0.5).astype(np.uint8) * 255
        near += int(band.sum())
        differ += int(diff.sum())
        flipped += int((diff & ~band).sum())
    host_page_s = (time.perf_counter() - t0) / len(pages)
    log(f"onnx: detect_bubble_masks over {len(pages)} pages of {DET_PAGE_HW[0]}x{DET_PAGE_HW[1]}, "
        f"one a call: {page_ms:.3f} ms a page by the host clock, the graph {graph_ms:.3f} ms by "
        f"CUDA events, peak {peak:.2f} GiB; mask share {[round(float((m > 0).mean()), 4) for m in masks]}; "
        f"card vs host on the {len(pages)} pages (host {host_page_s:.1f} s a page): {differ} mask "
        f"pixels differ, {flipped} of them outside {ONNX_MASK_EPS:.4f} of the threshold ({near} "
        f"within); on {card}")
    if flipped:
        fail(f"onnx: {flipped} mask pixels flipped card against host away from the threshold")


def run_yolo(engine=None) -> dict:
    """YOLOv8-seg on the card (no kernel: plain PyTorch).  YoloSegConfig()
    (n-scale, 640) on numpy seed-0 weights over DET_PAGES pages of
    DET_PAGE_HW: infer's preds and protos on the card against the host's on
    one page (FAMILY_REL); the forward by CUDA events at B=1 and B=8 with
    the peak memory and TFLOP/s; the host postprocess on one page as drawn
    (random heads: every anchor passes conf_threshold), then with the cls
    branches' output bias lowered so that YOLO_CANDIDATES anchors pass on
    the median page (read off the pages' logits, the counts at the biases
    around it printed), YoloBubbleDetector on every page (candidates past
    conf_threshold, instances kept, host-clock ms a page) and its OR-ed
    masks through mask_to_polygons(min_area=200), crops_from_detections and
    the int8 engine's ocr_page (``engine``, else built here): A 12, B 12, C 1
    a dispatch exactly.  Returns the stand-in's weights (the JAX layout,
    numpy leaves, the cls bias lowered)."""
    import numpy as np
    import torch

    from manga_ocr_tpu_torch.detect import contours as cont
    from manga_ocr_tpu_torch.detect.detector import crops_from_detections
    from manga_ocr_tpu_torch.models import yolo_seg as ys
    from manga_ocr_tpu_torch.parallel import batching

    card = card_line()
    cfg = ys.YoloSegConfig()
    tree = ys.init_params_numpy(cfg, SEED)
    params, host = ys.params_from_jax(tree, "cuda"), ys.params_from_jax(tree, "cpu")
    pages, drawn = detection_pages(DET_PAGES, SEED)
    h, w = DET_PAGE_HW
    rgb = np.ascontiguousarray(np.stack(pages)[..., ::-1])
    cp, cq = ys.infer(params, rgb[:1], cfg)
    t0 = time.perf_counter()
    hp, hq = ys.infer(host, rgb[:1], cfg)
    host_s = time.perf_counter() - t0
    errs = family_err(cp, hp), family_err(cq, hq)
    dev = torch.from_numpy(rgb).cuda()
    flops = flops_of(lambda: ys.infer(params, dev[:1], cfg))
    ms, peak = {}, {}
    for b in (1, DET_PAGES):
        ms[b], peak[b] = peak_gib(lambda: cuda_ms(lambda: ys.infer(params, dev[:b], cfg)) / b)
    cp_all = ys.infer(params, dev, cfg)[0].cpu().numpy()
    log(f"yolo: {cfg} ({sum(p.numel() for p in tree_tensors(params))} parameters, "
        f"{flops / 1e9:.2f} GFLOP a page at {cfg.input_size}); card vs host on one page (host "
        f"{host_s:.1f} s): preds {errs[0]:.3e}, protos {errs[1]:.3e} of the largest (bound "
        f"{FAMILY_REL}); infer (resize + forward) ms a page: "
        + ", ".join(f"B={b} {ms[b]:.3f} ({peak[b]:.2f} GiB)" for b in ms)
        + f"; at B={DET_PAGES} {flops / ms[DET_PAGES] / 1e9:.1f} TFLOP/s, "
        f"{flops / ms[DET_PAGES] / 1e9 / (H100_F32_FLOPS / 1e12):.1%} of the f32 peak; on {card}")
    if max(errs) > FAMILY_REL:
        fail("yolo: card and host disagree")
    rm, nc = cfg.reg_max, cfg.num_classes

    def passing(preds):
        return int((1 / (1 + np.exp(-preds[:, 4 * rm: 4 * rm + nc].max(-1)))
                    >= cfg.conf_threshold).sum())

    preds, protos = cp[0].cpu().numpy(), cq[0].cpu().numpy()
    cls = preds[:, 4 * rm: 4 * rm + nc]
    t0 = time.perf_counter()
    inst = ys.postprocess(preds, protos, cfg, h, w)
    post_s = time.perf_counter() - t0
    log(f"yolo: random heads, one page: cls logits {np.percentile(cls, [0, 50, 99, 100]).round(4)}, "
        f"{passing(preds)} of {len(preds)} anchors past {cfg.conf_threshold}, {len(inst)} instances "
        f"kept; host postprocess {post_s:.2f} s")
    del inst
    # the stand-in: the bias that puts conf_threshold between the k-th and
    # (k+1)-th largest cls logit of the median page
    top = -np.sort(-cp_all[..., 4 * rm: 4 * rm + nc].max(-1), -1)  # [pages, anchors], falling
    floor = float(np.log(cfg.conf_threshold / (1 - cfg.conf_threshold)))
    biases = {k: floor - float(np.median((top[:, k - 1] + top[:, k]) / 2))
              for k in (1, 2, 4, YOLO_CANDIDATES, 32, 128, 1024)}
    cls_bias = biases[YOLO_CANDIDATES]
    log(f"yolo: the stand-in's sweep, cls bias: anchors past {cfg.conf_threshold} a page: "
        + "; ".join(f"{b:+.6f}: {[int((t + b >= floor).sum()) for t in top]}"
                    for b in biases.values()))
    for branch in tree["heads"]["cls"]:
        branch["out"]["bias"] += np.float32(cls_bias)
    det = ys.YoloBubbleDetector(ys.params_from_jax(tree, "cpu"), cfg)
    det.detect_bubble_mask(pages[0])  # warm
    t0 = time.perf_counter()
    masks = [det.detect_bubble_mask(p) for p in pages]
    page_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
    bp, bq = ys.infer(det.params, rgb, cfg)
    bp, bq = bp.cpu().numpy(), bq.cpu().numpy()
    cand = [passing(p) for p in bp]
    t0 = time.perf_counter()
    kept = [len(ys.postprocess(p, q, cfg, h, w)) for p, q in zip(bp, bq)]
    post_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
    crops = []
    for page, mask in zip(pages, masks):
        dets = [{"polygon": p, "text": None} for p in cont.mask_to_polygons(mask, min_area=200)]
        crops.append(crops_from_detections(page, dets)[0])
    engine = engine or ocr_engine()
    t0 = time.perf_counter()
    texts, launch = counted(lambda: [engine.ocr_page(c) for c in crops if c])
    ocr_s = time.perf_counter() - t0
    n_dispatch = sum(len(batching.prep_page_gray(c, 1)) for c in crops if c)
    want = {name: INT8_PER_DISPATCH.get(name, 0) * n_dispatch for name in launch}
    log(f"yolo: cls bias {cls_bias:+.6f} (YOLO_CANDIDATES {YOLO_CANDIDATES}): candidates {cand}, "
        f"instances kept {kept}, bubbles drawn {drawn}; YoloBubbleDetector {page_ms:.1f} ms a "
        f"page by the host clock (host postprocess {post_ms:.1f} of it); mask share "
        f"{[round(float((m > 0).mean()), 4) for m in masks]}; crops {[len(c) for c in crops]} "
        f"read in {n_dispatch} dispatches ({ocr_s:.2f} s), launches {nonzero(launch)}; on {card}")
    if not sum(len(c) for c in crops):
        fail("yolo: no crop reached the OCR engine")
    if launch != want:
        fail(f"yolo: launch counts {launch}, expected {want}")
    if not all(isinstance(t, str) for page in texts for t in page):
        fail("yolo: the OCR engine returned a non-string")
    return tree


def tree_tensors(tree):
    """The tensors of a parameter tree."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree]


def line_crops(n: int, seed: int) -> list:
    """``n`` gray line crops of glyph text, 24-48 high and 2-14 glyphs wide."""
    import numpy as np

    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.train import render_text_crop

    chars = [t for t in CharTokenizer.synthetic().id_to_token[4:] if len(t) == 1]
    rng = np.random.default_rng(seed)
    crops = []
    for _ in range(n):
        k, hgt = int(rng.integers(2, 15)), int(rng.integers(24, 49))
        text = "".join(rng.choice(chars, size=k))
        crop = render_text_crop(text, rng, 64, hw=(k * hgt, hgt))[..., 0]
        crops.append(np.ascontiguousarray(np.rot90(crop)))  # the column laid down as a line
    return crops


def run_latin(engine=None) -> None:
    """The Latin engine on the card (no kernel: plain PyTorch; cuDNN's
    convolutions and LSTM, TF32 off).  TorchLatinEngine with CraftConfig()
    and CrnnConfig() at their published widths on the port's numpy seed-0
    weights: craft_forward on the card against the host on one 768 and one
    1024 bucket, crnn_forward on a 64-wide and a 512-wide batch
    (FAMILY_REL); detect_boxes_batch on the random maps over DET_PAGES pages
    of DET_PAGE_HW (one 1024 bucket: ms a page, peak device memory, TFLOP/s
    against the f32 peak) and over a chapter of DET_CHAPTER pages (ms a page;
    its peak held to LATIN_CHAPTER_PEAK times one page's dispatch); each
    bucket's CRAFT dispatch at page counts around the engine's
    (DISPATCH_PAGES, DISPATCH_PIXELS; ms a page, peak memory: cuDNN's
    algorithm choice) and a profile of the 1024 bucket at B = 2 and
    DET_PAGES; then the stand-in for a trained model's score maps (the last
    conv refitted to the ink of phase "detection"'s page of glyph columns,
    CRAFT_PEAK_SHARE) and detect_boxes_batch over DET_PAGES such pages
    (boxes required); recognize_lines over LATIN_LINES line crops
    (lines/s); readtext on the glyph page (regions required); and text mode
    (detect_text_regions with craft_proposer(engine)) on that page, its
    proposals read in one ocr_page call of the int8 engine (``engine``,
    else built here): A 12, B 12, C 1 a dispatch exactly."""
    from collections import Counter

    import numpy as np
    import torch

    from manga_ocr_tpu_torch.detect.text_detect import craft_proposer, detect_text_regions
    from manga_ocr_tpu_torch.engine.latin import (DISPATCH_PAGES, DISPATCH_PIXELS,
                                                  TorchLatinEngine, _round_up)
    from manga_ocr_tpu_torch.models import craft as craft_mod
    from manga_ocr_tpu_torch.models import crnn as crnn_mod
    from manga_ocr_tpu_torch.models.detector import fp32_products
    from manga_ocr_tpu_torch.parallel import batching

    card = card_line()
    t0 = time.perf_counter()
    latin = TorchLatinEngine(device="cuda")
    n_craft = sum(t.numel() for t in tree_tensors(latin.craft_params))
    n_crnn = sum(t.numel() for t in tree_tensors(latin.crnn_params))
    init_s = time.perf_counter() - t0
    host_craft = craft_mod.init_craft_params(latin.craft_cfg, 0, "cpu")
    host_crnn = crnn_mod.Crnn(crnn_mod.init_crnn_params(latin.crnn_cfg, 0, "cpu"))
    chapter, _ = detection_pages(DET_CHAPTER, SEED)
    pages = chapter[:DET_PAGES]
    errs, host_s = {}, {}
    for side, page in ((768, pages[0][:700, :560]), (1024, pages[0])):
        rgb, got_side, ph, pw, _ = latin._prep_for_detection(np.ascontiguousarray(page[..., ::-1]))
        if got_side != side:
            fail(f"latin: a {page.shape[:2]} page went to the {got_side} bucket, not {side}")
        batch = np.zeros((1, side, side, 3), np.uint8)
        batch[0, :ph, :pw] = rgb
        card_maps = craft_mod.detect_maps(latin.craft_params, batch)
        t0 = time.perf_counter()
        host_maps = craft_mod.detect_maps(host_craft, batch)
        host_s[f"craft {side}"] = time.perf_counter() - t0
        errs[f"craft {side}"] = max(family_err(c, h) for c, h in zip(card_maps, host_maps))
    rng = np.random.default_rng(SEED)
    for width in (64, 512):
        x = torch.from_numpy(rng.uniform(-1, 1, (32, 1, 32, width)).astype(np.float32))
        with torch.no_grad():
            with fp32_products():
                card_logits = crnn_mod.crnn_forward(latin.crnn, x.cuda())
            t0 = time.perf_counter()
            host_logits = crnn_mod.crnn_forward(host_crnn, x)
            host_s[f"crnn {width}"] = time.perf_counter() - t0
        errs[f"crnn {width}"] = family_err(card_logits, host_logits)
    log(f"latin: CRAFT {latin.craft_cfg.vgg_channels} ({n_craft} parameters), CRNN "
        f"{latin.crnn_cfg} ({n_crnn} parameters), built on the card in {init_s:.1f} s; card vs "
        f"host (largest-relative, bound {FAMILY_REL}): "
        + ", ".join(f"{k} {v:.3e} (host {host_s[k]:.1f} s)" for k, v in errs.items()))
    if max(errs.values()) > FAMILY_REL:
        fail("latin: card and host disagree")

    rgbs = [np.ascontiguousarray(p[..., ::-1]) for p in chapter]
    latin.detect_boxes_batch(rgbs[:1])  # warm
    t0 = time.perf_counter()
    boxes, peak = peak_gib(lambda: latin.detect_boxes_batch(rgbs[:DET_PAGES]))
    det_ms = (time.perf_counter() - t0) * 1e3 / DET_PAGES
    side = latin._prep_for_detection(rgbs[0])[1]

    def step(s):  # the engine's pages a dispatch in the bucket of side s
        return max(1, min(DISPATCH_PAGES, DISPATCH_PIXELS // s**2))

    dev = {s: torch.zeros((max(DET_PAGES, 16), s, s, 3), dtype=torch.uint8,
                          device="cuda") for s in latin.det_buckets}
    flops = flops_of(lambda: craft_mod.detect_maps(latin.craft_params, dev[side][:1]))
    sweep = {}  # (bucket, B pages a dispatch): ms a page, peak GiB (cuDNN's choice)
    for s in latin.det_buckets:
        more = {2, 4, DET_PAGES} if s == side else {16} if s == min(latin.det_buckets) else set()
        for b in sorted({1, step(s), 2 * step(s)} | more):
            sweep[s, b] = peak_gib(lambda: cuda_ms(
                lambda: craft_mod.detect_maps(latin.craft_params, dev[s][:b])) / b)
    maps_ms = sweep[side, 1][0]
    for b in (2, DET_PAGES):  # which convolutions cuDNN picked at each batch
        traced(f"CRAFT {side} B={b}", lambda: craft_mod.detect_maps(latin.craft_params,
                                                                    dev[side][:b]))
    del dev
    t0 = time.perf_counter()
    chapter_boxes, chapter_peak = peak_gib(lambda: latin.detect_boxes_batch(rgbs))
    chapter_ms = (time.perf_counter() - t0) * 1e3 / len(rgbs)
    log(f"latin: detect_boxes_batch over {DET_PAGES} pages of {DET_PAGE_HW[0]}x{DET_PAGE_HW[1]} "
        f"(the {side} bucket, {step(side)} a dispatch; random maps): {det_ms:.2f} ms a "
        f"page by the host clock, CRAFT {maps_ms:.2f} ms a page by CUDA events ({flops / 1e9:.1f} "
        f"GFLOP a page, {flops / maps_ms / 1e9:.1f} TFLOP/s, "
        f"{flops / maps_ms / 1e9 / (H100_F32_FLOPS / 1e12):.1%} of the f32 peak), peak "
        f"{peak:.2f} GiB; boxes {[len(b) for b in boxes]}; a chapter of {len(rgbs)} pages "
        f"{chapter_ms:.2f} ms a page, peak {chapter_peak:.2f} GiB; each bucket's CRAFT at B pages "
        f"a dispatch, ms a page (peak GiB): " + ", ".join(f"{s}: B={b} {m:.2f} ({g:.2f})"
                                                         for (s, b), (m, g) in sweep.items())
        + f"; on {card}")
    if chapter_boxes[:DET_PAGES] != boxes:
        fail("latin: the chapter's first pages' boxes differ from the same pages' alone")
    if chapter_peak > LATIN_CHAPTER_PEAK * sweep[side, 1][1]:
        fail(f"latin: the chapter's peak {chapter_peak:.2f} GiB passes {LATIN_CHAPTER_PEAK} x "
             f"one page's dispatch ({sweep[side, 1][1]:.2f} GiB)")

    glyphs = text_page(SEED)
    # the stand-in for a trained model's maps: the last 1x1 conv refitted as
    # a least-squares probe of the head's features onto the glyph page's ink
    last = latin.craft_params["conv_cls"][4]
    hc2 = last["kernel"].shape[1]
    last["kernel"] = torch.eye(hc2, device="cuda")[:, :, None, None].contiguous()
    last["bias"] = torch.zeros(hc2, device="cuda")
    scaled, gside, ph, pw, _ = latin._prep_for_detection(np.ascontiguousarray(glyphs[..., ::-1]))
    batch = np.zeros((1, gside, gside, 3), np.uint8)
    batch[0, :ph, :pw] = scaled
    with fp32_products(), torch.no_grad():
        x = craft_mod.normalize_images(torch.from_numpy(batch).cuda()).permute(0, 3, 1, 2)
        feats = craft_mod.craft_forward(latin.craft_params, x.contiguous())[0]
    mh, mw = (ph + 1) // 2, (pw + 1) // 2
    dark = np.zeros((2 * mh, 2 * mw), bool)
    dark[:ph, :pw] = scaled.mean(-1) < 128
    ink = dark.reshape(mh, 2, mw, 2).any((1, 3)).ravel()  # at the maps' half resolution
    a = np.concatenate([feats[:, :mh, :mw].reshape(hc2, -1).T.double().cpu().numpy(),
                        np.ones((mh * mw, 1))], 1)
    w = np.linalg.lstsq(a, ink.astype(np.float64), rcond=None)[0]
    probe, share = a @ w, float(ink.mean())
    cfg = latin.craft_cfg
    lo, hi = (float(np.quantile(probe, 1 - q)) for q in (share, share * CRAFT_PEAK_SHARE))
    if not hi > lo:
        fail(f"latin: the ink probe is flat at its top ({lo} .. {hi})")
    gain = (cfg.text_threshold - cfg.low_text) / (hi - lo)
    shift = (cfg.low_text - gain * lo, cfg.link_threshold - gain * lo)
    last["kernel"] = torch.tensor(np.stack([gain * w[:hc2]] * 2), dtype=torch.float32,
                                  device="cuda")[:, :, None, None].contiguous()
    last["bias"] = torch.tensor([gain * w[hc2] + b for b in shift], dtype=torch.float32,
                                device="cuda")
    log(f"latin: the maps' stand-in: a probe of the head's {hc2} features fitted to the glyph "
        f"page's ink ({share:.2%} of its map pixels; correlation "
        f"{np.corrcoef(probe, ink)[0, 1]:.3f}), low_text at its top {share:.2%} and "
        f"text_threshold at its top {share * CRAFT_PEAK_SHARE:.2%} (CRAFT_PEAK_SHARE "
        f"{CRAFT_PEAK_SHARE}), the affinity map the same probe with link_threshold at low_text's "
        f"place: gain {gain:.6g}, biases {[round(v, 6) for v in shift]}")

    glyph_rgbs = [np.ascontiguousarray(text_page(SEED + i)[..., ::-1]) for i in range(DET_PAGES)]
    t0 = time.perf_counter()
    glyph_boxes = latin.detect_boxes_batch(glyph_rgbs)
    glyph_ms = (time.perf_counter() - t0) * 1e3 / len(glyph_rgbs)
    log(f"latin: on the stand-in's maps, detect_boxes_batch over {len(glyph_rgbs)} glyph pages "
        f"{glyph_ms:.2f} ms a page by the host clock, boxes {[len(b) for b in glyph_boxes]}")
    if not sum(len(b) for b in glyph_boxes):
        fail("latin: detect_boxes_batch found no box on the stand-in's maps")
    lines = line_crops(LATIN_LINES, SEED)
    latin.recognize_lines(lines[:8])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = latin.recognize_lines(lines)
    rec_s = time.perf_counter() - t0
    if len(texts) != len(lines) or not all(isinstance(t, str) for t in texts):
        fail("latin: recognize_lines returned the wrong strings")
    t0 = time.perf_counter()
    found = latin.readtext(glyphs)
    read_s = time.perf_counter() - t0
    engine = engine or ocr_engine()
    calls = []

    def ocr_page(crops):
        calls.append(list(crops))
        return engine.ocr_page(crops)

    t0 = time.perf_counter()
    regions, launch = counted(lambda: detect_text_regions(glyphs, ocr_page,
                                                          proposer=craft_proposer(latin)))
    text_s = time.perf_counter() - t0
    n_dispatch = sum(len(batching.prep_page_gray(c, 1)) for c in calls)
    want = {name: INT8_PER_DISPATCH.get(name, 0) * n_dispatch for name in launch}
    buckets = Counter(_round_up(max(8, round(c.shape[1] * 32 / c.shape[0])),
                                latin.rec_width_buckets) for c in lines)
    log(f"latin: recognize_lines over {len(lines)} line crops {len(lines) / rec_s:.1f} lines/s "
        f"({rec_s * 1e3:.1f} ms; by width bucket {dict(sorted(buckets.items()))}), "
        f"texts {texts[:4]}; readtext on the glyph page {read_s * 1e3:.1f} ms, {len(found)} "
        f"regions; "
        f"text mode {text_s * 1e3:.1f} ms, ocr_page calls {[len(c) for c in calls]} in "
        f"{n_dispatch} dispatches, launches {nonzero(launch)}, {len(regions)} regions; on {card}")
    if not found:
        fail("latin: readtext found no region")
    if len(calls) != 1 or not calls[0] or not regions:
        fail(f"latin: text mode made {len(calls)} ocr_page calls and kept {len(regions)} regions")
    if launch != want:
        fail(f"latin: text mode's launch counts {launch}, expected {want}")


# -- text erasure and typeset export: LaMa, cleanup, render, project, export --------

# The generator runs f32 with TF32 off on both devices: its logits differ by
# summation order only (36 FFC units, each with an rFFT2/irFFT2 pair), bounded
# relative to the largest logit.  Random He-init weights over 36 residual
# units saturate the sigmoid, so the uint8 hole pixels say little: their
# differing count is printed, the logits are held.
LAMA_LOGIT_REL = 1e-4
LAMA_REGION = 512
LAMA_BATCHES = (1, 2, 4, 8)
LAMA_PAGE_HW = (1704, 1200)  # DET_PAGE_HW padded to a multiple of 2**3


def lama_flops(cfg, h: int, w: int, dense_up: bool = False) -> float:
    """2 x the multiply-adds of the generator's convolutions on an h x w
    region (multiples of 2**downsamples): each conv on its output pixels, a
    transposed conv on its input pixels (or, with ``dense_up``, as the dense
    conv on its output); the FFTs left out."""
    d = cfg.downsamples

    def mac(cin, cout, k, level, wd=None):
        return cin * cout * k * k * (h >> level) * (wd or (w >> level))

    total = mac(4, cfg.feats(0), 7, 0) + mac(cfg.feats(0), 3, 7, 0)
    for i in range(d):
        cout = cfg.deep_channels if i == d - 1 else cfg.feats(i + 1)
        total += mac(cfg.feats(i), cout, 3, i + 1)
        total += mac(cfg.feats(i + 1), cfg.feats(i), 3, i if dense_up else i + 1)
    cl, cg = cfg.cl, cfg.cg
    unit = (mac(cl, cl, 3, d) + mac(cg, cl, 3, d) + mac(cl, cg, 3, d)
            + mac(cg, cg // 2, 1, d) + mac(cg // 2, cg, 1, d)
            + mac(cg, cg, 1, d, (w >> d) // 2 + 1))  # the Fourier unit's 1x1
    return 2.0 * (total + 2 * cfg.num_blocks * unit)


def split_by_kind(rows) -> dict:
    """Device ms of profiled kernels by kind: convolutions (cuDNN's and
    torch's conv kernels, implicit GEMMs), FFTs (cuFFT) and the rest."""
    conv_words = ("conv", "gemm", "xmma", "fprop", "dgrad", "wgrad", "winograd", "cudnn",
                  "fft2d_r2c", "fft2d_c2r", "flip_filter")
    out = {"convolutions": 0.0, "ffts": 0.0, "rest": 0.0}
    for name, ms, _ in rows:
        n = name.lower()
        kind = ("convolutions" if any(w in n for w in conv_words)
                else "ffts" if "fft" in n or "bluestein" in n else "rest")
        out[kind] += ms
    return out


def run_inpaint(stage) -> None:
    """Text erasure and typeset export on the card (no kernel: plain
    PyTorch, f32 with TF32 off).  ``stage``: a page of DET_PAGE_HW and its
    JobResults from PagePipeline (run_detection's (c)).  (a) The LaMa
    generator at big-lama width on numpy seed-0 weights, one LAMA_REGION²
    window with a text-block hole card against host: the head's logits,
    known pixels, differing hole pixels; (b) inpaint_batch at LAMA_BATCHES
    regions and on one LAMA_PAGE_HW page by CUDA events with peak memory,
    inpaint_many on the regions (DISPATCH_PIXELS a dispatch; its first
    dispatch equal to inpaint_batch's), and a profiled page call split by
    kind; (c) every area of the page
    erased through erase_area_for_settings with the "big_lama" inpainter
    (no fall-through, nothing outside an area's mask changed), a Project
    saved and loaded, batch_save and export_pdf into a temporary directory,
    the written page equal to render_page's."""
    import logging
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from manga_ocr_tpu_torch.core import files as fio
    from manga_ocr_tpu_torch.core.project import Project, load_project, save_project
    from manga_ocr_tpu_torch.models import inpaint as ip
    from manga_ocr_tpu_torch.models.detector import fp32_products
    from manga_ocr_tpu_torch.runtime import export
    from manga_ocr_tpu_torch.typeset import cleanup as cl
    from manga_ocr_tpu_torch.typeset.render import render_page

    card = card_line()
    page, results = stage
    if not results:
        fail("inpaint: the stage's page has no area")
    cfg = ip.InpaintConfig(num_blocks=18)
    t0 = time.time()
    tree = ip.init_params(cfg, SEED, "cpu")
    inp = ip.LamaInpainter(tree, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in inp._net.parameters())
    s = LAMA_REGION
    region_flops = lama_flops(cfg, s, s)
    page_flops = lama_flops(cfg, *LAMA_PAGE_HW)
    log(f"inpaint: {cfg}: {n_params} parameters ({n_params * 4 / 1e6:.1f} MB f32), on the card "
        f"in {time.time() - t0:.1f} s; {region_flops / 1e12:.4f} TFLOP a {s}x{s} region "
        f"({lama_flops(cfg, s, s, dense_up=True) / 1e12:.4f} with the transposed convs dense), "
        f"{page_flops / 1e12:.4f} a {LAMA_PAGE_HW[0]}x{LAMA_PAGE_HW[1]} page (deep map "
        f"{LAMA_PAGE_HW[0] >> 3}x{LAMA_PAGE_HW[1] >> 3})")

    # -- (a) card against host on one region ---------------------------------------------
    ph, pw = page.shape[:2]
    masks = [cl.build_cleanup_mask(page.shape, r.area.cleanup_polygon) for r in results]
    r0 = results[0].area.rect
    y0 = min(max(0, r0.top + r0.h // 2 - s // 2), ph - s)
    x0 = min(max(0, r0.left + r0.w // 2 - s // 2), pw - s)
    img = np.ascontiguousarray(page[y0 : y0 + s, x0 : x0 + s])[None]
    msk = np.ascontiguousarray(masks[0][y0 : y0 + s, x0 : x0 + s])[None]
    x = torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255.0
    m = torch.from_numpy(msk > 0).float()
    t0 = time.time()
    with fp32_products(), torch.no_grad():
        host_logits = ip.head_logits(tree, x, m, cfg)
    host_s = time.time() - t0
    host_u8 = ip.inpaint_batch(tree, img, msk, cfg).numpy()
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with fp32_products(), torch.no_grad():
            dev_logits = ip.head_logits(inp._net, x.cuda(), m.cuda(), cfg).cpu()
        dev_u8 = ip.inpaint_batch(inp._net, img, msk, cfg).cpu().numpy()
        flags_after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        with torch.no_grad():  # the control: the same graph with TF32 products
            tf32_logits = ip.head_logits(inp._net, x.cuda(), m.cuda(), cfg).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    top = float(host_logits.abs().max())
    rel = float((dev_logits - host_logits).abs().max()) / top
    tf32_rel = float((tf32_logits - host_logits).abs().max()) / top
    hole = np.repeat((msk > 0)[..., None], 3, axis=-1)
    known_ok = (np.array_equal(dev_u8[~hole], img[~hole])
                and np.array_equal(host_u8[~hole], img[~hole]))
    n_diff = int((dev_u8 != host_u8)[hole].sum())
    saturated = float((host_logits.abs() > 10).float().mean())
    log(f"inpaint (a): a {s}x{s} window at ({y0}, {x0}), {int(hole[..., 0].sum())} hole pixels: "
        f"logits card vs host max |diff| {rel:.3e} of the largest ({top:.4g}; bound "
        f"{LAMA_LOGIT_REL}); TF32 control (not held) {tf32_rel:.3e}; {saturated:.1%} of the "
        f"logits beyond +-10; known pixels {'bit-equal' if known_ok else 'DIFFER'}; "
        f"{n_diff} of {int(hole.sum())} hole values differ; host {host_s:.1f} s on {card}")
    if flags_after != (True, True):
        fail(f"inpaint (a): inpaint_batch left the TF32 flags at {flags_after}")
    if rel > LAMA_LOGIT_REL or not known_ok:
        fail(f"inpaint (a): card and host disagree: logits {rel} > {LAMA_LOGIT_REL} or known "
             f"pixels changed")

    # -- (b) times ------------------------------------------------------------------------
    n = max(LAMA_BATCHES)
    offs = [(int(yy), int(xx))
            for yy, xx in zip(np.linspace(0, ph - s, n), np.linspace(pw - s, 0, n))]
    dimgs = torch.from_numpy(np.stack([page[a : a + s, b : b + s] for a, b in offs])).cuda()
    dmsks = torch.from_numpy(np.repeat(msk, n, axis=0)).cuda()
    ms, peak = {}, {}
    for b in LAMA_BATCHES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms[b] = cuda_ms(lambda: ip.inpaint_batch(inp._net, dimgs[:b], dmsks[:b], cfg), reps=3) / b
        peak[b] = torch.cuda.max_memory_allocated() / 2**30
    regions = [page[a : a + s, b : b + s] for a, b in offs]
    inp.inpaint_many(regions, [msk[0]] * n)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    many = inp.inpaint_many(regions, [msk[0]] * n)
    many_ms = (time.perf_counter() - t0) * 1e3 / n
    per = ip.DISPATCH_PIXELS // (s * s)
    first = ip.inpaint_batch(inp._net, dimgs[:per], dmsks[:per], cfg).cpu().numpy()
    if not all(np.array_equal(a, b) for a, b in zip(many, first)):
        fail("inpaint (b): inpaint_many's first dispatch differs from inpaint_batch's")
    del dimgs, dmsks
    full = np.zeros(page.shape[:2], np.uint8)
    for mk in masks:
        full |= mk
    pimg = np.pad(page, ((0, LAMA_PAGE_HW[0] - ph), (0, LAMA_PAGE_HW[1] - pw), (0, 0)), mode="edge")
    pmsk = np.pad(full, ((0, LAMA_PAGE_HW[0] - ph), (0, LAMA_PAGE_HW[1] - pw)))
    dpage = torch.from_numpy(pimg[None]).cuda()
    dpmsk = torch.from_numpy(pmsk[None]).cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    page_ms = cuda_ms(lambda: ip.inpaint_batch(inp._net, dpage, dpmsk, cfg), reps=3)
    page_peak = torch.cuda.max_memory_allocated() / 2**30
    rate = lambda flops, t: flops / t / 1e9  # noqa: E731  (TFLOP/s from ms)
    log(f"inpaint (b): inpaint_batch on {s}x{s} regions, ms a region (peak device memory, "
        f"TFLOP/s): " + ", ".join(f"B={b} {ms[b]:.3f} ({peak[b]:.2f} GiB, "
                                  f"{rate(region_flops, ms[b]):.1f})" for b in ms)
        + f"; inpaint_many on the {n} regions ({per} a dispatch, DISPATCH_PIXELS) "
        f"{many_ms:.3f} ms a region by the host clock"
        + f"; one {LAMA_PAGE_HW[0]}x{LAMA_PAGE_HW[1]} page {page_ms:.3f} ms ({page_peak:.2f} GiB, "
        f"{rate(page_flops, page_ms):.1f} TFLOP/s, "
        f"{rate(page_flops, page_ms) / (H100_F32_FLOPS / 1e12):.1%} of the f32 peak) on {card}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ip.inpaint_batch(inp._net, dpage, dpmsk, cfg)
        torch.cuda.synchronize()
    log_profile(f"inpaint_batch page {LAMA_PAGE_HW[0]}x{LAMA_PAGE_HW[1]}", prof)
    split = split_by_kind(device_ms_by_kernel(prof))
    total = sum(split.values())
    log(f"inpaint (b): the page call's device ms by kind: "
        + ", ".join(f"{k} {v:.3f} ({v / total:.1%})" for k, v in split.items() if total))
    del dpage, dpmsk
    torch.cuda.empty_cache()

    # -- (c) the stage: erase every area, then project -> render -> save ------------------
    raised = []

    class Catch(logging.Handler):
        def emit(self, record):
            raised.append(record.getMessage())

    calls = [0]

    def big_lama(image, mask):
        calls[0] += 1
        return inp(image, mask)

    settings = {"inpaint_model_key": "big_lama", "use_inpaint": True,
                "use_background_box": True, "inpaint_padding": 2}
    handler = Catch(logging.WARNING)
    logger = logging.getLogger(cl.__name__)
    logger.addHandler(handler)
    out = page.copy()
    area_ms = []
    try:
        for r, mk in zip(results, masks):
            before = out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cl.erase_area_for_settings(out, r.area, settings,
                                             inpainters={"big_lama": big_lama})
            area_ms.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(out[mk == 0], before[mk == 0]):
                fail("inpaint (c): erasing an area changed pixels outside its mask")
    finally:
        logger.removeHandler(handler)
    want_calls = sum(bool(mk.any()) for mk in masks)
    if raised or calls[0] != want_calls:
        fail(f"inpaint (c): the inpainter ran {calls[0]} times for {want_calls} areas; fell "
             f"through: {raised}")
    erased_share = float((out != page).any(-1).mean())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "page01.png")
        fio.save_image(path, page, "PNG")
        proj = Project(project_dir=tmp, settings=dict(settings))
        for r in results:
            proj.add_area(path, r.area, push_undo=False)
        save_project(proj, os.path.join(tmp, "project.json"))
        back = load_project(os.path.join(tmp, "project.json"))
        areas = back.image_state(path).areas
        if [a.to_payload() for a in areas] != [r.area.to_payload() for r in results]:
            fail("inpaint (c): the project's areas did not survive save and load")
        t0 = time.perf_counter()
        composed = render_page(page, areas)
        render_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        written = export.batch_save(back)
        save_ms = (time.perf_counter() - t0) * 1e3
        pdf = export.export_pdf(back, os.path.join(tmp, "book.pdf"))
        with open(pdf, "rb") as f:
            pdf_head = f.read(5)
        pdf_kb = os.path.getsize(pdf) / 1e3
        if written != [export.typeset_output_path(path, "PNG")]:
            fail(f"inpaint (c): batch_save wrote {written}")
        saved_page = fio.safe_open_image(written[0])
        if saved_page is None or not np.array_equal(saved_page, composed) or pdf_head != b"%PDF-":
            fail("inpaint (c): the written page differs from render_page's, or no PDF")
    log(f"inpaint (c): {len(results)} areas of a {ph}x{pw} page erased through "
        f"erase_area_for_settings with the big_lama inpainter ({calls[0]} calls, no "
        f"fall-through, nothing outside a mask changed, {erased_share:.2%} of the page's "
        f"pixels changed): ms an area {[round(v, 1) for v in area_ms]}, {sum(area_ms):.1f} ms "
        f"the page; Project saved and loaded; render_page {render_ms:.1f} ms, batch_save "
        f"(render + PNG) {save_ms:.1f} ms a page by the host clock, PDF {pdf_kb:.0f} kB on "
        f"{card}")


# -- the process command ------------------------------------------------------------


def stub_reply(prompt: str) -> str:
    """The stub translator's reply: a function of the prompt's own text."""
    text = next((ln[len("Text: "):] for ln in prompt.splitlines() if ln.startswith("Text: ")),
                None)
    return f"EN<{text}>"


def stub_translator():
    """A chat-completions server on 127.0.0.1 in a thread of this process:
    each reply is ``stub_reply`` of the request's prompt.  Returns (server,
    URL, the request bodies received)."""
    import http.server
    import threading

    bodies = []

    class Handler(http.server.BaseHTTPRequestHandler):
        # the headers and the body go out as two writes: without TCP_NODELAY
        # the body waits for the client's delayed ACK (~40 ms a request)
        disable_nagle_algorithm = True

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            bodies.append(body)
            prompt = json.loads(body)["messages"][-1]["content"]
            out = json.dumps({"choices": [{"message": {"content": stub_reply(prompt)}}],
                              "usage": {"prompt_tokens": 1, "completion_tokens": 1}}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}/v1/chat/completions", bodies


class HostSplit:
    """Wraps functions and methods (looked up at call time by the command)
    with timers for one run: seconds and calls by label, each call's
    seconds in call order; the engine that ``_build_engine`` returned; every
    ocr_page call's crops and orientation.  The wrapped functions compute
    what they did before."""

    def __init__(self):
        self.s, self.n, self.each, self.ocr_calls, self.engine, self._undo = {}, {}, {}, [], None, []

    def wrap(self, owner, name: str, label: str) -> None:
        orig = getattr(owner, name)
        split = self

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = orig(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                split.s[label] = split.s.get(label, 0.0) + dt
                split.n[label] = split.n.get(label, 0) + 1
                split.each.setdefault(label, []).append(dt)
            if label == "engine build":
                split.engine = out
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, orig))

    def record_ocr(self, cls) -> None:
        orig = cls.ocr_page
        split = self

        def ocr_page(engine, crops, orientation=1, timer=None):
            split.ocr_calls.append((list(crops), orientation))
            return orig(engine, crops, orientation, timer)

        cls.ocr_page = ocr_page
        self._undo.append((cls, "ocr_page", orig))

    def undo(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []

    def dispatches(self) -> int:
        from manga_ocr_tpu_torch.parallel import batching

        return sum(len(batching.prep_page_gray(c, o)) for c, o in self.ocr_calls if c)


def run_cli_process(label: str, folder: str, out: str, args: list) -> tuple:
    """``cli.main(["--device", "cuda", "process", folder, "--out", out,
    *args])`` in-process with the host split's timers on: its launches
    must be A 12, B 12, C 1 per dispatch of its ocr_page calls exactly.
    Returns (wall seconds, launch counts, HostSplit)."""
    from manga_ocr_tpu_torch import cli
    from manga_ocr_tpu_torch.core import project as proj
    from manga_ocr_tpu_torch.detect import detector as det
    from manga_ocr_tpu_torch.detect import text_detect
    from manga_ocr_tpu_torch.engine.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models import yolo_seg
    from manga_ocr_tpu_torch.runtime import export
    from manga_ocr_tpu_torch.translate.service import TranslationService

    split = HostSplit()
    split.wrap(cli, "_build_engine", "engine build")
    split.wrap(det.BubbleDetector, "detect_bubbles", "detection")
    split.wrap(yolo_seg.YoloBubbleDetector, "detect_bubble_mask", "detection")
    split.wrap(text_detect, "detect_text_regions", "text detection (its OCR included)")
    split.wrap(TorchMangaOcrEngine, "ocr_page", "OCR")
    split.wrap(TorchMangaOcrEngine, "ocr_page_dual", "dual pass")
    split.wrap(TranslationService, "translate_with_ai", "translation round trips")
    split.wrap(proj, "save_project", "save_project + batch_save")
    split.wrap(export, "batch_save", "save_project + batch_save")
    split.record_ocr(TorchMangaOcrEngine)
    argv = ["--device", "cuda", "process", folder, "--out", out, *args]
    try:
        t0 = time.perf_counter()
        rc, launch = counted(lambda: cli.main(argv))
        wall = time.perf_counter() - t0
    finally:
        split.undo()
    n_dispatch = split.dispatches()
    want = {name: INT8_PER_DISPATCH.get(name, 0) * n_dispatch for name in launch}
    log(f"process {label}: cli.main({argv[2:]}) exit {rc} in {wall:.2f} s; "
        f"{len(split.ocr_calls)} ocr_page calls, {n_dispatch} dispatches, launches "
        f"{nonzero(launch)} ({json.dumps({k: v // max(n_dispatch, 1) for k, v in nonzero(launch).items()})} "
        f"a dispatch); host split s {json.dumps({k: round(v, 4) for k, v in split.s.items()})}, "
        f"calls {json.dumps(split.n)}")
    if rc != 0:
        fail(f"process {label}: exit {rc}")
    if not n_dispatch or launch != want:
        fail(f"process {label}: launch counts {launch}, expected {want}")
    return wall, launch, split


def typeset_pages(project, folder: str, label: str) -> None:
    """One ``*_typeset.png`` per page with areas, none for the others."""
    from manga_ocr_tpu_torch.runtime.export import typeset_output_path

    with_areas = sorted(p for p, st in project.images.items() if st.areas)
    written = sorted(glob.glob(os.path.join(folder, "*_typeset.png")))
    if not with_areas or written != sorted(typeset_output_path(p, "PNG") for p in with_areas):
        fail(f"process {label}: typeset pages {written} for the pages with areas {with_areas}")


def run_process(yolo_tree: dict) -> None:
    """The process command on the card (module docstring, 13)."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from manga_ocr_tpu_torch.core.project import load_project
    from manga_ocr_tpu_torch.detect import postprocess
    from manga_ocr_tpu_torch.detect.detector import BubbleDetector
    from manga_ocr_tpu_torch.models import detector as seg
    from manga_ocr_tpu_torch.models import yolo_seg as ys
    from manga_ocr_tpu_torch.runtime.pipeline import PagePipeline

    card = card_line()
    # the stub lives on this host: keep any proxy setting away from it
    os.environ["NO_PROXY"] = ",".join(filter(None, [os.environ.get("NO_PROXY"),
                                                    "127.0.0.1", "localhost"]))
    tesseract = shutil.which("tesseract")
    transport = "requests" if importlib.util.find_spec("requests") else "urllib"
    httpd, url, bodies = stub_translator()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_process_")
    try:
        t0 = time.perf_counter()
        pages, drawn = detection_pages(DET_PAGES, SEED + 1)
        folder = os.path.join(tmp, "pages")
        os.makedirs(folder)
        for i, page in enumerate(pages):
            Image.fromarray(page[..., ::-1]).save(os.path.join(folder, f"page{i:02d}.png"))
        npz = os.path.join(tmp, "unet.npz")
        seg.save_params(seg.init_params(seg.DetectorConfig(), SEED, "cpu"), npz)
        settings = os.path.join(tmp, "settings.json")
        with open(settings, "w") as f:
            json.dump({"apis": {"openrouter": {"keys": ["stub"]}},
                       "translate": {"openrouter": {"url": url}}}, f)
        log(f"process: {len(pages)} pages of {DET_PAGE_HW[0]}x{DET_PAGE_HW[1]} ({sum(drawn)} "
            f"bubbles drawn), the U-Net and settings written in {time.perf_counter() - t0:.1f} s; "
            f"tesseract {tesseract or 'not found: the same model reads the second pass'}; "
            f"robust_post on {transport}")

        # -- the main run: U-Net detection, OCR, translation, project, export -----------
        out = os.path.join(tmp, "out")
        wall, launch, split = run_cli_process(
            "main", folder, out, ["--detector", npz, "--settings", settings, "--translate",
                                  "--provider", "openrouter"])
        project = load_project(os.path.join(out, "project.json"))
        typeset_pages(project, folder, "main")
        paths = sorted(os.path.join(folder, n) for n in os.listdir(folder)
                       if not n.endswith("_typeset.png"))
        areas = {p: project.images[p].areas if p in project.images else [] for p in paths}
        n_areas = sum(len(a) for a in areas.values())
        wrong = [(a.original_text, a.text) for a in sum(areas.values(), [])
                 if a.original_text and a.text != stub_reply(f"Text: {a.original_text}")]
        if not bodies or wrong or not any(a.original_text for a in sum(areas.values(), [])):
            fail(f"process main: {len(bodies)} stub requests; areas whose text is not the "
                 f"stub's reply to their OCR text: {wrong[:5]}")
        # the same pages through PagePipeline, the same detector and the command's engine
        detector = BubbleDetector.from_checkpoint(npz, device="cuda")
        pipe = PagePipeline(split.engine.ocr_page)
        ref = pipe.process_pages(
            [(p, np.asarray(Image.open(p).convert("RGB"))[..., ::-1].copy()) for p in paths],
            lambda page: postprocess.split_extended_bubbles(detector.detect_bubbles(page)))
        pipe.close()
        for p in paths:
            got = [a.original_text for a in areas[p]]
            want = [r.original_text for r in ref[p] if r.area is not None]
            if got != want:
                fail(f"process main: {p}: texts {got} != PagePipeline's {want}")
        n_dispatch = split.dispatches()
        build_s = split.s.get("engine build", 0.0)
        page_split = {k: round(v / len(paths), 4) for k, v in split.s.items()
                      if k != "engine build"}
        log(f"process main: {len(paths)} pages, {n_areas} areas {[len(a) for a in areas.values()]}, "
            f"texts equal to PagePipeline(engine.ocr_page)'s; {len(bodies)} stub requests, every "
            f"area's text the stub's reply to its own; {len(paths) / wall:.3f} pages/s end to end "
            f"({len(paths) / (wall - build_s):.3f} without the {build_s:.2f} s engine build) by the "
            f"host clock; host split s a page {json.dumps(page_split)} (translation: the sum over "
            f"its {split.n.get('translation round trips', 0)} calls, concurrent on 8 threads; ms "
            f"a call in call order {[round(t * 1e3, 2) for t in split.each.get('translation round trips', [])]}); "
            f"launches a dispatch "
            f"{json.dumps({k: v // n_dispatch for k, v in nonzero(launch).items()})}; on {card}")
        del detector, split
        torch.cuda.empty_cache()
        # robust_post's other transport branch, urllib, with requests hidden
        from manga_ocr_tpu_torch.utils import http as mhttp

        saved = sys.modules.get("requests")
        sys.modules["requests"] = None  # `import requests` raises ImportError
        try:
            t0 = time.perf_counter()
            resp = mhttp.robust_post(url, json={"messages": [{"role": "user",
                                                              "content": "Text: 猫"}]})
            urllib_ms = (time.perf_counter() - t0) * 1e3
        finally:
            if saved is None:
                sys.modules.pop("requests", None)
            else:
                sys.modules["requests"] = saved
        if not resp.ok or resp.json()["choices"][0]["message"]["content"] != "EN<猫>":
            fail(f"process: robust_post on urllib: HTTP {resp.status_code} {resp.text[:200]}")
        log(f"process: robust_post on urllib (requests hidden) {urllib_ms:.2f} ms a round trip")

        # -- shorter runs: text mode, the dual pass, YOLO (no --translate) ---------------
        n_requests = len(bodies)

        def short(label: str, page_list: list, args: list) -> None:
            sub = os.path.join(tmp, label)
            os.makedirs(sub)
            for i, page in enumerate(page_list):
                Image.fromarray(page[..., ::-1]).save(os.path.join(sub, f"page{i:02d}.png"))
            sub_out = os.path.join(tmp, f"{label}_out")
            wall, _, split = run_cli_process(label, sub, sub_out, args)
            proj = load_project(os.path.join(sub_out, "project.json"))
            typeset_pages(proj, sub, label)
            texts = [a.original_text for st in proj.images.values() for a in st.areas]
            log(f"process {label}: {len(page_list)} pages, {len(texts)} areas, "
                f"{len(page_list) / wall:.3f} pages/s end to end; texts {texts[:8]}; on {card}")
            if len(bodies) != n_requests:
                fail(f"process {label}: requests reached the stub without --translate")
            torch.cuda.empty_cache()

        short("text", [text_page(SEED)], ["--detect-mode", "text"])
        short("enhanced", pages[:2], ["--detector", npz, "--enhanced"])
        yolo_npz = os.path.join(tmp, "yolo.npz")
        ys.save_params(ys.params_from_jax(yolo_tree, "cpu"), yolo_npz)
        short("yolo", pages[:2], ["--detector", yolo_npz, "--detector-type", "yolo"])
        log(f"process: the dual pass's second engine: "
            f"{'tesseract at ' + tesseract if tesseract else 'the same model (no tesseract)'}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- data-parallel serving (phase "data-parallel serving") ------------------------------
DP_VIRTUAL = 2  # the mesh on one card: a virtual mesh of DP_VIRTUAL x cuda:0
DP_PAGES = 8  # U-Net pages of DET_PAGE_HW (4 a dispatch on one device)
DP_LAMA_REGIONS = 8  # 512x512 regions (DISPATCH_PIXELS: 4 a dispatch on one device)
DP_CRAFT_PAGES = 8  # 512x512 pages (CRAFT's cap at that bucket: 4 a dispatch)
DP_LINES = 64  # CRNN lines
DP_RANK_TIMEOUT_S = 300
# pages timed on both engines: at 256 crops every card's kernel C runs one
# wave of clusters (15 tiles of up to 18 rows), at 1024 one device needs four
DP_PAGE_SIZES = (256, 1024)


def dp_devices() -> list:
    """The phase's data devices: every card where there are several, else a
    virtual mesh of DP_VIRTUAL x cuda:0."""
    import torch

    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * DP_VIRTUAL


def dp_label(devices: list) -> str:
    names = sorted({str(d) for d in devices})
    return f"{len(devices)} x {names[0]}" if len(names) == 1 else ", ".join(names)


def host_timed(fn) -> tuple:
    """``fn()``'s result and the host seconds of a second call, the cards
    synchronised (the first call warms cuDNN and the allocator)."""
    import torch

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    fn()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def dp_matrices(engine, page) -> list:
    """``[lengths | tokens]`` of each bucket of ``page`` (as ocr_page
    prepares it, Vertical): (batch, host matrix of its valid rows)."""
    dispatched = engine._dispatch_page(page, 1, None)
    return list(zip([b for b, _ in dispatched[0]], engine._page_rows(dispatched)))


def dp_hold_rows(label: str, engine, b, got, want, n: int) -> None:
    """Rows of one bucket from a run split ``n`` ways against the
    single-device run's: every row bit-equal (the encoder and kernel C
    compute each row alone).  Where rows differ, the run fails after
    printing which stage differs (the encoder's output of the shards
    against the whole batch's) and kernel C's grids at both batch sizes."""
    import torch

    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.ops import decode_loop as dl
    from manga_ocr_tpu_torch.ops import preprocess as pp

    same = (got == want).all(axis=1)
    if same.all():
        log(f"{label}: bucket {b.bucket_hw} x{b.crops.shape[0]}: {len(got)} rows bit-equal")
        return
    rows = b.crops.shape[0] // n
    with torch.inference_mode():
        px = pp.model_preprocess(torch.from_numpy(b.crops).cuda(), torch.from_numpy(b.sizes).cuda(),
                                 engine.cfg.encoder.image_size).to(engine.dtype)
        whole = mdl.encode(engine.params, px, engine.cfg).float()
        parts = torch.cat([mdl.encode(engine.params, px[i * rows:(i + 1) * rows], engine.cfg)
                           for i in range(n)]).float()
        enc_diff = float((whole - parts).abs().max())
        grids = []  # kernel C's grid at the whole batch's size and at a shard's
        for x in (px, px[:rows]):
            mdl.ocr_forward(engine.params, x, engine.cfg, max_length=engine.max_length)
            grids.append(dl.greedy_decode_loop.last_grid)
    where = "encoder (kernels A, B)" if enc_diff else "decode (kernel C)"
    fail(f"{label}: bucket {b.bucket_hw} x{b.crops.shape[0]}: {int((~same).sum())} of {len(got)} "
         f"rows differ from the single-device run; the encoder's output of the shards differs "
         f"from the whole batch's by {enc_diff} (so the {where} depends on the batch; C's grid "
         f"at B={b.crops.shape[0]} {grids[0]}, at B={rows} {grids[1]})")


def dp_bucket():
    """The 256-crop page's largest bucket (Vertical), as ocr_page prepares it."""
    from manga_ocr_tpu_torch.parallel import batching

    crops = load_crops()
    page = [crops[i % len(crops)] for i in range(256)]
    return max(batching.prep_page_gray(page, 1), key=lambda b: b.crops.shape[0])


def dp_rank(rank: int, n: int, port: int, out: str) -> None:
    """One of the phase's ``n`` ranks (``chip_smoke.py --dp-rank RANK N PORT
    OUT``; gloo where the ranks share a card, NCCL where each has its own):
    its rows of the 256-crop page's largest bucket through the int8 engine's
    ocr_forward on its device, every rank's [lengths | tokens] read back by
    gather_to_hosts (rank 0 writes it)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.parallel import multihost as mh
    from manga_ocr_tpu_torch.ops import preprocess as pp

    mh.initialize(f"127.0.0.1:{port}", num_processes=n, process_id=rank)
    mesh = mh.make_global_mesh()
    b = dp_bucket()
    rows = b.crops.shape[0] // n
    crops, offset = mh.global_batch(b.crops[rank * rows:(rank + 1) * rows], mesh)
    sizes, _ = mh.global_batch(b.sizes[rank * rows:(rank + 1) * rows], mesh)
    with torch.cuda.device(crops.device):  # the engine's default "cuda" is this rank's card
        engine = ocr_engine()
    with torch.inference_mode():
        px = pp.model_preprocess(crops, sizes.int(), engine.cfg.encoder.image_size).to(engine.dtype)
        o = mdl.ocr_forward(engine.params, px, engine.cfg, max_length=engine.max_length)
        got = mh.gather_to_hosts(torch.cat([o.lengths[:, None], o.tokens], dim=1))
    mh.sync("gathered")
    log(f"dp rank {rank}: backend {dist.get_backend()}, mesh {mesh}, rows {offset}.."
        f"{offset + rows - 1} on {crops.device}, gathered {got.shape}")
    if rank == 0:
        np.save(out, got)
    dist.destroy_process_group()


def run_data_parallel() -> None:
    """Data-parallel serving on the phase's mesh (``dp_devices``: every card
    where there are several, else a virtual mesh of DP_VIRTUAL x cuda:0):
    (a) the full-width int8 engine sharded against the single-device
    engine: exact launch counts (A 12, B 12, C 1 per shard dispatch), each
    bucket's [lengths | tokens] of the 256-crop page (dp_hold_rows), both
    engines' crops/s; (b) BubbleDetector (DetectorConfig()) on DP_PAGES
    pages of DET_PAGE_HW and one odd-shape page, LamaInpainter (big-lama) on
    DP_LAMA_REGIONS 512x512 regions, TorchLatinEngine's CRAFT maps on
    DP_CRAFT_PAGES 512x512 pages and CRNN logits on DP_LINES lines, each
    sharded and held to one device's outputs on the same per-device slices
    (bit-equal; LaMa's pixels within one level on 0.5% of pixels, as the CPU
    tests hold), recognize_lines' strings compared; (c) one rank a mesh
    device in child processes (``--dp-rank``), their gather_to_hosts held to
    one process's run of the same bucket (dp_hold_rows)."""
    import argparse
    import socket
    import tempfile

    import numpy as np
    import torch

    from manga_ocr_tpu_torch import cli
    from manga_ocr_tpu_torch.detect.detector import BubbleDetector
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.engine.latin import TorchLatinEngine
    from manga_ocr_tpu_torch.models import detector as seg
    from manga_ocr_tpu_torch.models import inpaint as ip
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.parallel import mesh as meshlib

    card = card_line()
    n_cards = torch.cuda.device_count()
    devices = dp_devices()
    n, where = len(devices), dp_label(devices)
    log(f"data-parallel serving: torch.cuda.device_count() = {n_cards}; the mesh {where} on "
        f"{card}")
    try:
        cli._mesh(argparse.Namespace(mesh_data=n_cards + 1, device="cuda"))
        fail(f"--mesh-data {n_cards + 1} built a mesh on {n_cards} card(s)")
    except ValueError as e:
        log(f"--mesh-data {n_cards + 1} on {n_cards} card(s) raises: {e}")
    mesh = meshlib.make_mesh(n, devices=devices)
    if n_cards > 1 and cli._mesh(argparse.Namespace(mesh_data=n, device="cuda")).data_devices \
            != devices:
        fail(f"--mesh-data {n} does not take the {n_cards} visible cards")

    # -- (a) the int8 engine: sharded against single-device -------------------------------
    cfg = MangaOCRConfig.base()
    params = init_params(cfg, SEED, "cpu", std=WEIGHT_STD)
    tok = CharTokenizer.synthetic()
    single = TorchMangaOcrEngine(params, cfg, tok, device="cuda")
    sharded = TorchMangaOcrEngine(params, cfg, tok, device="cuda", mesh=mesh)
    crops = load_crops()
    sharded.ocr_page(crops[:2])  # first call
    per_shard = {"fused_attn_layer": 12, "fused_mlp_block": 12, "greedy_decode_loop": 1,
                 "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}
    drive_page(sharded, crops, f"int8 engine on {where}", {k: n * v for k, v in per_shard.items()},
               {}, record={k: None for k in per_shard})
    page = [crops[i % len(crops)] for i in range(256)]
    want, got = dp_matrices(single, page), dp_matrices(sharded, page)
    for (b, w), (_, g) in zip(want, got):
        dp_hold_rows(f"int8 engine on {where} vs one device", single, b, g, w, n)
    for size in DP_PAGE_SIZES:
        rate_single = page_rate(single, crops, "int8 engine, one device", size)
        rate_sharded = page_rate(sharded, crops, f"int8 engine, mesh {where}", size)
        log(f"data-parallel int8 engine crops/s on a {size}-crop page: one device {rate_single}, "
            f"{where} {rate_sharded} ({rate_sharded / rate_single:.3f}x) on {card}")
    del single, sharded
    torch.cuda.empty_cache()

    # -- (b) the secondary models: one device on each shard's slice, then the mesh -----------
    def per_slice(fn, items, k):
        rows = -(-k // n)
        return [out for i in range(0, k, rows) for out in fn(items[i:i + rows])]

    dcfg = seg.DetectorConfig()
    tree = seg.init_params(dcfg, SEED, "cpu")
    pages, _ = detection_pages(DP_PAGES, SEED)
    odd = np.ascontiguousarray(pages[0][: DET_PAGE_HW[0] - 100, : DET_PAGE_HW[1] - 100])
    one, det = (BubbleDetector(tree, dcfg, device="cuda"),
                BubbleDetector(tree, dcfg, device="cuda", mesh=mesh))
    want, t_one = host_timed(lambda: per_slice(one.detect_bubble_masks, pages, DP_PAGES)
                             + one.detect_bubble_masks([odd]))
    got, t_dp = host_timed(lambda: det.detect_bubble_masks(pages + [odd]))
    diff = [int((a != b).sum()) for a, b in zip(got, want)]
    log(f"BubbleDetector on {where}: {DP_PAGES} pages of {DET_PAGE_HW} and one odd, differing "
        f"mask pixels per page {diff}; host clock after a warm call {t_one:.3f} s one device, "
        f"{t_dp:.3f} s sharded, on {card}")
    if any(diff) or det._params_repl is None or not any(m.any() for m in want):
        fail("BubbleDetector: the sharded masks differ from one device's (or never split)")
    del one, det

    icfg = ip.InpaintConfig(num_blocks=18)
    itree = ip.init_params(icfg, SEED, "cpu")
    rng = np.random.default_rng(SEED)
    regions, holes = [], []
    for k in range(DP_LAMA_REGIONS):
        y, x = int(rng.integers(0, DET_PAGE_HW[0] - 512)), int(rng.integers(0, DET_PAGE_HW[1] - 512))
        regions.append(np.ascontiguousarray(pages[k % DP_PAGES][y:y + 512, x:x + 512]))
        m = np.zeros((512, 512), np.uint8)
        m[128:384, 160:352] = 255
        holes.append(m)
    one, lama = (ip.LamaInpainter(itree, icfg, device="cuda"),
                 ip.LamaInpainter(itree, icfg, device="cuda", mesh=mesh))
    want, t_one = host_timed(lambda: per_slice(
        lambda idx: one.inpaint_many([regions[i] for i in idx], [holes[i] for i in idx]),
        list(range(DP_LAMA_REGIONS)), DP_LAMA_REGIONS))
    got, t_dp = host_timed(lambda: lama.inpaint_many(regions, holes))
    worst = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) for a, b in zip(got, want))
    share = max(float((a != b).any(-1).mean()) for a, b in zip(got, want))
    log(f"LamaInpainter on {where}: {DP_LAMA_REGIONS} regions of 512x512, largest difference "
        f"{worst} levels on {share} of pixels at most; host clock after a warm call {t_one:.3f} s "
        f"one device, {t_dp:.3f} s sharded, on {card}")
    if worst > 1 or share > 0.005 or lama._params_repl is None:
        fail("LamaInpainter: the sharded regions differ from one device's (or never split)")
    del one, lama, itree
    torch.cuda.empty_cache()

    latin = TorchLatinEngine(device="cuda")
    latin_dp = TorchLatinEngine(latin.craft_params, latin.crnn_params, device="cuda", mesh=mesh)
    batch = np.stack([np.ascontiguousarray(p[:512, :512, ::-1]) for p in pages[:DP_CRAFT_PAGES]])
    want = [np.concatenate(m) for m in zip(*per_slice(
        lambda x: [latin.detect_maps(x)], batch, DP_CRAFT_PAGES))]
    got = latin_dp.detect_maps(batch)
    errs = [family_err(g, w) for g, w in zip(got, want)]
    x = np.random.default_rng(SEED).normal(size=(DP_LINES, 32, 128, 1)).astype(np.float32)
    lw = np.concatenate(per_slice(lambda v: [latin.recognize_logits(v)], x, DP_LINES))
    lerr = family_err(latin_dp.recognize_logits(x), lw)
    lines = line_crops(DP_LINES, SEED)
    same_texts = sum(a == b for a, b in zip(latin_dp.recognize_lines(lines),
                                            latin.recognize_lines(lines)))
    log(f"TorchLatinEngine on {where}: CRAFT maps of {DP_CRAFT_PAGES} pages of 512x512 "
        f"(region, affinity) largest-relative error {errs}, CRNN logits of {DP_LINES} lines "
        f"{lerr}, against one device on each shard's slice; recognize_lines: {same_texts} of "
        f"{len(lines)} strings equal to one device's (its whole buckets in one dispatch), on "
        f"{card}")
    if max(errs) > 0 or lerr > 0 or latin_dp._craft_repl is None or latin_dp._crnn_repl is None:
        fail("TorchLatinEngine: the sharded maps or logits differ from one device's")
    del latin, latin_dp
    torch.cuda.empty_cache()

    # -- (c) one rank a mesh device -----------------------------------------------------------
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    b = dp_bucket()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gathered.npy")
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                            "LOCAL_WORLD_SIZE")}
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank",
                                   str(r), str(n), str(port), out], env=env, cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        try:
            for r, proc in enumerate(procs):
                text, _ = proc.communicate(timeout=DP_RANK_TIMEOUT_S)
                log("\n".join(f"  rank {r}: {ln}" for ln in text.splitlines()[-6:]))
                if proc.returncode != 0:
                    fail(f"dp rank {r} exited {proc.returncode}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        gathered = np.load(out)
        log(f"{n} ranks on {where}: {time.time() - t0:.1f} s with their start")
    engine = ocr_engine()
    with torch.inference_mode():
        whole = engine._run_bucket(b.crops, b.sizes).cpu().numpy()
    if gathered.shape != whole.shape:
        fail(f"gather_to_hosts: {gathered.shape}, one process {whole.shape}")
    dp_hold_rows(f"{n} ranks' gather_to_hosts vs one process", engine, b, gathered, whole, n)


# Tensor parallelism (the plain routes on model columns, shard_params, the mesh train step)
# at base() width in f32 with TF32 held off: a (1, 2) mesh of two cards where
# several are visible, else of TP_VIRTUAL x cuda:0, and a (2, 2) mesh where
# four cards are.  The tensor-parallel engine's rows are held to the
# single-device plain engine's: bit-equal, or else each differing row's
# tokens teacher-forced by the plain decoder, the chosen token within
# TP_GAP_REL of the top logit (f32 partial sums in another order).
TP_VIRTUAL = 2
TP_GAP_REL = 1e-4
TP_CHECK_BATCH = 8  # the step's loss and gradients against one device
TP_TIMED_STEPS = 3
TP_RANK_TIMEOUT_S = 300


def tp_meshes() -> list:
    """(label, mesh) of each mesh of the phase."""
    import torch

    from manga_ocr_tpu_torch.parallel import mesh as meshlib

    n = torch.cuda.device_count()
    pair = [torch.device("cuda", i) for i in range(2)] if n > 1 else \
        [torch.device("cuda", 0)] * TP_VIRTUAL
    out = [(f"(1, 2) on {dp_label(pair)}", meshlib.make_mesh(1, 2, devices=pair))]
    if n >= 4:
        four = [torch.device("cuda", i) for i in range(4)]
        out.append((f"(2, 2) on {dp_label(four)}", meshlib.make_mesh(2, 2, devices=four)))
    return out


def sync_cards() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def tp_batch(cfg, n: int):
    """``n`` synthetic rows (numpy seed SEED) whose loss masks differ from
    row to row in the second half (the second rank's rows)."""
    from manga_ocr_tpu_torch import train as trainlib
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    b = next(trainlib.synthetic_dataset(cfg, CharTokenizer.synthetic(), n, TRAIN_SEQ, seed=SEED))
    mask = b.loss_mask.clone()
    for r in range(n // 2, n):
        mask[r, 2 + r:] = 0.0
    return trainlib.TrainBatch(b.pixel_values, b.tokens, mask)


def params_digest(tree) -> str:
    import hashlib

    from manga_ocr_tpu_torch import train as trainlib

    h = hashlib.sha256()
    for _, t in trainlib._leaves(tree):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def tp_times() -> dict:
    """``--tp-times``' child (base() in f32, TF32 held off): crops/s of one
    256-crop page (after a warm one, host clock) through the plain engine on
    cuda:0 and the tensor-parallel engine on (1, 2) and (2, 2) meshes of
    cuda:0, and ms a B=TRAIN_BATCH, T=TRAIN_SEQ train step (mean of
    TP_TIMED_STEPS after a warm one, host clock, synchronised) on each."""
    import torch

    from manga_ocr_tpu_torch import train as trainlib
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.detector import fp32_products
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.parallel import mesh as meshlib

    cfg = MangaOCRConfig.base()
    params = init_params(cfg, SEED, "cpu", std=WEIGHT_STD)
    tok = CharTokenizer.synthetic()
    crops = load_crops()
    page = [crops[i % len(crops)] for i in range(256)]
    timed = next(trainlib.synthetic_dataset(cfg, tok, TRAIN_BATCH, TRAIN_SEQ, seed=SEED))
    meshes = {"one device": None}
    for shape in ((1, 2), (2, 2)):
        meshes[f"{shape}"] = meshlib.make_mesh(*shape, devices=[torch.device("cuda", 0)] *
                                               (shape[0] * shape[1]))
    out = {}
    with fp32_products():
        for label, mesh in meshes.items():
            engine = TorchMangaOcrEngine(params, cfg, tok, dtype=torch.float32, device="cuda",
                                         serving_kernels=False, mesh=mesh)
            engine.ocr_page(page)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.ocr_page(page)
            out[f"engine {label} crops/s"] = len(page) / (time.perf_counter() - t0)
            del engine
            p, st = trainlib.init_train_state(cfg, trainlib.make_optimizer(1e-4), device="cuda",
                                              init_params=params, mesh=mesh)
            fn = trainlib.make_train_step(cfg, mesh)
            batch = timed if mesh is not None else trainlib.TrainBatch(*(t.cuda() for t in timed))
            fn(p, st, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TP_TIMED_STEPS):
                fn(p, st, batch)
            torch.cuda.synchronize()
            out[f"step {label} ms"] = (time.perf_counter() - t0) * 1e3 / TP_TIMED_STEPS
            del p, st
            torch.cuda.empty_cache()
    out["card"] = card_line()
    return out


def tp_rank(rank: int, port: int, out: str, backend: str) -> None:
    """One of the phase's two ranks (``chip_smoke.py --tp-rank RANK PORT OUT
    BACKEND``): under gloo both on cuda:0, under NCCL rank r on cuda:r; a
    (2 data x 2 model) global mesh, one data row of two columns a rank (both
    on the rank's card); this rank's half of tp_batch(TP_CHECK_BATCH)
    through one train step (lr 1e-4); its loss and its params' digest to
    ``OUT``."""
    import torch
    import torch.distributed as dist

    from manga_ocr_tpu_torch import train as trainlib
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.detector import fp32_products
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.parallel import mesh as meshlib
    from manga_ocr_tpu_torch.parallel import multihost as mh

    mh.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank, backend=backend)
    card = (lambda r: torch.device("cuda", r)) if backend == "nccl" else \
        (lambda r: torch.device("cuda", 0))
    mesh = mh.make_global_mesh(n_model=2, devices=[
        mh.RankDevice(r, card(r)) for r in range(2) for _ in range(2)])
    cfg = MangaOCRConfig.base()
    batch = tp_batch(cfg, TP_CHECK_BATCH)
    half = TP_CHECK_BATCH // 2
    mine = trainlib.TrainBatch(*(t[rank * half:(rank + 1) * half] for t in batch))
    with fp32_products():
        grid, state = trainlib.init_train_state(
            cfg, trainlib.make_optimizer(1e-4), device="cuda",
            init_params=init_params(cfg, SEED, "cpu", std=WEIGHT_STD), mesh=mesh)
        t0 = time.perf_counter()
        grid, state, loss = trainlib.make_train_step(cfg, mesh)(grid, state, mine)
        loss = float(loss)
        step_s = time.perf_counter() - t0
    full = meshlib.unshard_params(grid[rank])
    digest = params_digest(full)
    mh.sync("stepped")
    log(f"tp rank {rank}: backend {dist.get_backend()} on {card(rank)}, mesh {mesh.shape}, rows "
        f"{rank * half}..{(rank + 1) * half - 1}, loss {loss!r} in {step_s:.3f} s (host clock)")
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"loss": loss, "digest": digest}, f)
    if rank == 0:
        torch.save({k: t.detach().cpu() for k, t in trainlib._leaves(full)}, f"{out}.params")
    dist.destroy_process_group()


def tp_hold_rows(label: str, engine, b, got, want) -> None:
    """Rows of one bucket from the tensor-parallel engine against the
    single-device plain engine's: bit-equal, or else each differing row's
    tokens teacher-forced by the plain decoder on the single engine's
    encoder output, every chosen token within TP_GAP_REL of the top logit."""
    import numpy as np
    import torch

    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import vit
    from manga_ocr_tpu_torch.ops import preprocess as pp

    same = (got == want).all(axis=1)
    if same.all():
        log(f"{label}: bucket {b.bucket_hw} x{b.crops.shape[0]}: {len(got)} rows bit-equal to "
            f"one device's")
        return
    bad = np.flatnonzero(~same)
    cfg = engine.cfg
    with torch.inference_mode():
        px = pp.model_preprocess(torch.from_numpy(b.crops[bad]).cuda(),
                                 torch.from_numpy(b.sizes[bad]).cuda(),
                                 cfg.encoder.image_size).to(engine.dtype)
        enc = vit.encode(engine.params["encoder"], px, cfg.encoder)
        toks = torch.from_numpy(np.ascontiguousarray(got[bad, 1:])).cuda()
        logits = dec.forward_full(engine.params["decoder"], toks[:, :-1], enc, cfg.decoder)
        chosen = logits.gather(-1, toks[:, 1:, None].long())[..., 0]
        top = logits.amax(-1)
        live = torch.arange(toks.shape[1] - 1, device="cuda")[None] < \
            torch.from_numpy(got[bad, 0]).cuda()[:, None] - 1
        gap = ((top - chosen) / top.abs().clamp_min(1e-30))[live]
    worst = float(gap.max()) if gap.numel() else 0.0
    log(f"{label}: bucket {b.bucket_hw} x{b.crops.shape[0]}: {len(bad)} of {len(got)} rows "
        f"differ from one device's; their tokens teacher-forced by the plain decoder: largest "
        f"gap to the top logit {worst!r} of it over {int(live.sum())} tokens (bound {TP_GAP_REL})")
    if worst > TP_GAP_REL:
        fail(f"{label}: tensor-parallel rows' gap {worst} over {TP_GAP_REL}")


def run_tensor_parallel() -> None:
    """Tensor parallelism at base() width, f32, TF32 held off, on each of
    tp_meshes(): (a) the engine (serving_kernels defaults off on a model axis
    of 2) on the fixture crops with no kernel launched, each bucket's rows of
    the 256-crop page held to the single-device plain engine's
    (tp_hold_rows), crops/s of both and the peak device memory of a page;
    (b) one train step on a TP_CHECK_BATCH batch whose masks differ by row
    (lr 0: the gradients stay) against one device's loss_fn and backward
    (TRAIN_LOSS_REL, TRAIN_GRAD_REL, as phase "training"), the replicas
    bit-equal after it, then ms a step at TRAIN_BATCH x TRAIN_SEQ against one
    device's (host clock, the cards synchronised) and the peak memory;
    (c) two gloo ranks on cuda:0 (``--tp-rank``) taking one step together on
    a (2, 2) global mesh: equal losses and param digests, the loss within
    2e-5 of one process's step on the whole batch, the params within 3 lr of
    it; then, where two cards or more are visible, two NCCL ranks on cuda:0
    and cuda:1 the same way."""
    import numpy as np
    import torch

    from manga_ocr_tpu_torch import train as trainlib
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.detector import fp32_products
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.parallel import mesh as meshlib

    card = card_line()
    cfg = MangaOCRConfig.base()
    params = init_params(cfg, SEED, "cpu", std=WEIGHT_STD)
    tok = CharTokenizer.synthetic()
    crops = load_crops()
    page = [crops[i % len(crops)] for i in range(256)]

    def peak_gib(fn) -> tuple:
        """``fn``'s host seconds (the cards synchronised) and peak device
        memory by card in GiB."""
        sync_cards()
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)
        t0 = time.perf_counter()
        fn()
        sync_cards()
        return time.perf_counter() - t0, [round(torch.cuda.max_memory_allocated(i) / 2**30, 3)
                                          for i in range(torch.cuda.device_count())]

    with fp32_products():
        # -- (a) the engine ------------------------------------------------------------
        single = TorchMangaOcrEngine(params, cfg, tok, dtype=torch.float32, device="cuda",
                                     serving_kernels=False)
        want = dp_matrices(single, page)  # also the warm page
        t, mem_single = peak_gib(lambda: single.ocr_page(page))
        rate_single = len(page) / t
        for label, mesh in tp_meshes():
            tp = TorchMangaOcrEngine(params, cfg, tok, dtype=torch.float32, device="cuda",
                                     mesh=mesh)
            if not tp._tensor_parallel or tp.cfg != cfg:
                fail(f"tensor parallelism {label}: the engine did not take the plain TP route")
            texts, counts = counted(lambda: tp.ocr_page(crops))
            if any(counts.values()) or len(set(texts)) < 2 or len(texts) != len(crops):
                fail(f"tensor parallelism {label}: launches {counts}, {len(set(texts))} texts")
            for (b, w), (_, g) in zip(want, dp_matrices(tp, page)):
                tp_hold_rows(f"tensor-parallel engine {label}", single, b, g, w)
            t, mem = peak_gib(lambda: tp.ocr_page(page))
            rate = len(page) / t
            log(f"tensor-parallel engine {label}: {rate} crops/s on the 256-crop page (one page "
                f"after a warm one, host clock) against one device's plain engine {rate_single} "
                f"({rate / rate_single:.3f}x); peak device memory of the page by card {mem} GiB "
                f"(one device {mem_single}), on {card}")
            del tp
        if torch.cuda.device_count() < 4:
            # several data rows in one decode loop (ocr_forward_rows) on one card
            quad = meshlib.make_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4)
            tp = TorchMangaOcrEngine(params, cfg, tok, dtype=torch.float32, device="cuda",
                                     mesh=quad)
            got, counts = counted(lambda: dp_matrices(tp, crops))
            if any(counts.values()):
                fail(f"tensor parallelism (2, 2) on 4 x cuda:0: launches {counts}")
            for (b, w), (_, g) in zip(dp_matrices(single, crops), got):
                tp_hold_rows("tensor-parallel engine (2, 2) on 4 x cuda:0", single, b, g, w)
            del tp
        del single
        torch.cuda.empty_cache()

        # -- (b) the train step -----------------------------------------------------------
        check = tp_batch(cfg, TP_CHECK_BATCH)
        one, _ = trainlib.init_train_state(cfg, trainlib.make_optimizer(0.0, 0.0),
                                           device="cuda", init_params=params)
        loss = trainlib.loss_fn(one, trainlib.TrainBatch(*(t.cuda() for t in check)), cfg)
        loss.backward()
        ref = (loss.item(), {k: p.grad.cpu() for k, p in trainlib._leaves(one)})
        del one, loss
        timed = next(trainlib.synthetic_dataset(cfg, tok, TRAIN_BATCH, TRAIN_SEQ, seed=SEED))

        def step_ms(mesh) -> tuple:
            p, st = trainlib.init_train_state(cfg, trainlib.make_optimizer(1e-4), device="cuda",
                                              init_params=params, mesh=mesh)
            fn = trainlib.make_train_step(cfg, mesh)
            batch = timed if mesh is not None else trainlib.TrainBatch(*(t.cuda() for t in timed))

            def steps():
                for _ in range(TP_TIMED_STEPS):
                    fn(p, st, batch)

            fn(p, st, batch)
            _, mem = peak_gib(lambda: fn(p, st, batch))
            t, _ = peak_gib(steps)
            return t * 1e3 / TP_TIMED_STEPS, mem

        ms_single, mem_single = step_ms(None)
        for label, mesh in tp_meshes():
            grid, st = trainlib.init_train_state(cfg, trainlib.make_optimizer(0.0, 0.0),
                                                 device="cuda", init_params=params, mesh=mesh)
            _, _, loss = trainlib.make_train_step(cfg, mesh)(grid, st, check)
            grads = {k: g.cpu() for k, g in trainlib._leaves(
                meshlib.unshard_params(grid[0], get=lambda t: t.grad))}
            if not grad_gaps("tensor parallelism (b)", f"train step {label} vs one device",
                             (float(loss), grads), ref):
                fail(f"tensor parallelism (b) {label}: loss or gradient outside its bound")
            digests = {params_digest(meshlib.unshard_params(cols)) for cols in grid}
            if len(digests) != 1:
                fail(f"tensor parallelism (b) {label}: the data rows' params differ")
            del grid, st, grads
            ms, mem = step_ms(mesh)
            log(f"tensor-parallel train step {label}: B={TRAIN_BATCH} T={TRAIN_SEQ} {ms:.3f} ms a "
                f"step (host clock, cards synchronised, mean of {TP_TIMED_STEPS}) against one "
                f"device's {ms_single:.3f} ({ms / ms_single:.3f}x); peak device memory by card "
                f"{mem} GiB (one device {mem_single}); the data rows' params bit-equal after a "
                f"step, on {card}")
        torch.cuda.empty_cache()

        # -- (c) two ranks: gloo on one card, NCCL on two ---------------------------------
        p, st = trainlib.init_train_state(cfg, trainlib.make_optimizer(1e-4), device="cuda",
                                          init_params=params)
        _, _, loss = trainlib.make_train_step(cfg)(p, st, trainlib.TrainBatch(
            *(t.cuda() for t in check)))
        loss = float(loss)
        one_process = {k: t.detach().cpu() for k, t in trainlib._leaves(p)}
        del p, st
        torch.cuda.empty_cache()
        backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
        for backend in backends:
            ranks, ranked = tp_ranks(backend)
            worst = max(float((ranked[k] - t).abs().max()) for k, t in one_process.items())
            rel = abs(ranks[0]["loss"] - loss) / abs(loss)
            where = "cuda:0" if backend == "gloo" else "cuda:0 and cuda:1"
            log(f"2 {backend} ranks on {where}, one train step on a (2, 2) global mesh: losses "
                f"{ranks[0]['loss']!r} and {ranks[1]['loss']!r}, one process {loss!r} (relative "
                f"gap {rel:.3e}, bound 2e-5); params digests equal "
                f"{ranks[0]['digest'] == ranks[1]['digest']}; largest |param - one process's| "
                f"{worst!r} (bound 3 lr = 3e-4), on {card}")
            if ranks[0]["loss"] != ranks[1]["loss"] or ranks[0]["digest"] != ranks[1]["digest"] \
                    or rel > 2e-5 or not worst <= 3e-4 or not np.isfinite(loss):
                fail(f"tensor parallelism (c) {backend}: the ranks disagree with each other or "
                     f"one process")


def tp_ranks(backend: str) -> tuple:
    """Two ``--tp-rank`` children under ``backend`` -> (each rank's loss and
    digest, rank 0's params on the host)."""
    import socket
    import tempfile

    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "tp")
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                            "LOCAL_WORLD_SIZE")}
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank",
                                   str(r), str(port), out, backend], env=env, cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            for r, proc in enumerate(procs):
                text, _ = proc.communicate(timeout=TP_RANK_TIMEOUT_S)
                log("\n".join(f"  rank {r}: {ln}" for ln in text.splitlines()[-4:]))
                if proc.returncode != 0:
                    fail(f"tp rank {r} ({backend}) exited {proc.returncode}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        ranks = []
        for r in range(2):
            with open(f"{out}.{r}.json") as f:
                ranks.append(json.load(f))
        ranked = torch.load(f"{out}.params")
        log(f"2 {backend} ranks: {time.time() - t0:.1f} s with their start")
    return ranks, ranked


BENCH_CHILD_BUDGET_S = 240  # the bench child's BENCH_BUDGET_S
BENCH_CHILD_TIMEOUT_S = 420
BENCH_FIRST_LINE_S = 120  # the first scored line arrives within this
BENCH_MFU_MAX = 1.05  # a share above this means the FLOP count or the timed window is wrong
BENCH_KEYS = ("metric", "value", "unit", "config", "headline_kind", "model_gflops_per_crop",
              "mfu_vs_bf16_peak", "mfu_vs_int8_peak", "full_path_crops_per_s",
              "full_path_h2d_ms", "full_path_attempts", "full_path_stage_ms",
              "crops_per_s_budget300_realistic", "budget300_mean_emitted_len",
              "budget300_batch", "bench_wall_s")


def bench_child() -> dict:
    """``python -m manga_ocr_tpu_torch.benchmark`` in a child process, as a
    user runs it, under BENCH_CHILD_BUDGET_S (phase D off: no trained
    checkpoint here).  Its stdout lines are echoed as they arrive, each must
    parse, the first scored one must come within BENCH_FIRST_LINE_S, and
    the last must carry every key of phases A-C with positive rates and
    both utilisation shares in (0, BENCH_MFU_MAX].  Returns the last line."""
    import tempfile
    import threading

    env = dict(os.environ, BENCH_BUDGET_S=str(BENCH_CHILD_BUDGET_S),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    lines, first_s = [], None
    with tempfile.TemporaryDirectory() as tmp, \
            open(os.path.join(tmp, "stderr"), "w+") as err:
        env["MANGA_OCR_TRAINED_CKPT"] = os.path.join(tmp, "no_trained_checkpoint")
        t0 = time.time()
        proc = subprocess.Popen([sys.executable, "-m", "manga_ocr_tpu_torch.benchmark"],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        watchdog = threading.Timer(BENCH_CHILD_TIMEOUT_S, proc.kill)
        watchdog.start()
        try:
            for text in proc.stdout:
                log(f"  bench +{time.time() - t0:.1f} s: {text.rstrip()}")
                try:
                    line = json.loads(text)
                except json.JSONDecodeError:
                    fail(f"bench: a stdout line does not parse: {text!r}")
                if first_s is None and line.get("value", 0) > 0:
                    first_s = time.time() - t0
                lines.append(line)
            rc = proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        notes = err.read().splitlines()
    wall = time.time() - t0
    log("\n".join(f"  bench stderr: {n}" for n in notes[-40:]))
    if rc != 0:
        fail(f"bench exited {rc} after {wall:.1f} s")
    if first_s is None or first_s > BENCH_FIRST_LINE_S:
        fail(f"bench: first scored line at {first_s} s (limit {BENCH_FIRST_LINE_S} s)")
    last = lines[-1]
    missing = [k for k in BENCH_KEYS if k not in last]
    if missing:
        fail(f"bench: the last line lacks {missing}")
    if not (last["value"] > 0 and last["full_path_crops_per_s"] > 0
            and last["crops_per_s_budget300_realistic"] > 0):
        fail(f"bench: rates {last['value']}, {last['full_path_crops_per_s']}, "
             f"{last['crops_per_s_budget300_realistic']}")
    shares = (last["mfu_vs_bf16_peak"], last["mfu_vs_int8_peak"])
    if not all(0 < m <= BENCH_MFU_MAX for m in shares):
        fail(f"bench: utilisation shares {shares} outside (0, {BENCH_MFU_MAX}]")
    log(f"bench: {len(lines)} lines, the first scored at {first_s:.1f} s, {wall:.1f} s in all; "
        f"{last['value']} crops/s ({last['config']}), full path "
        f"{last['full_path_crops_per_s']}, budget 300 {last['crops_per_s_budget300_realistic']} "
        f"(mean length {last['budget300_mean_emitted_len']}), mfu bf16 {shares[0]} int8 "
        f"{shares[1]} on {card_line()}")
    return last


def run_benchmark() -> None:
    """Phase "benchmark": the bench as a user runs it (``bench_child``), then
    its programs in-process at B=256 on the seed-0 weights: one rung-2 call
    counted (A 12, B 12, C 1 in its cluster form), ``utils.metrics.trace``
    of one eager call (it must hold CUDA kernels), the rows of its CUDA
    graph replay (which must launch no wrapper) bit-equal to the eager
    call's; the budget-300 program's lengths equal to min(stop, the
    unstopped length) and its tokens to the unstopped ones up to each
    row's length."""
    import functools
    import tempfile

    import torch

    from manga_ocr_tpu_torch import benchmark as bm
    from manga_ocr_tpu_torch.engine import graphs
    from manga_ocr_tpu_torch.utils import metrics

    bench_child()
    t0 = time.time()
    dev = torch.device("cuda")
    b = bm.BATCH_SIZES[0]
    sp = bm._serving_params(bm._base_params_host(), dev)
    _, serving = bm.rung_configs()
    want = {"fused_attn_layer": 12, "fused_mlp_block": 12, "greedy_decode_loop": 1,
            "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}
    with torch.inference_mode():
        px = bm._pixels(b, serving.encoder.image_size, dev)
        call = functools.partial(bm.ocr_fn(serving), sp, px)
        eager, counts = counted(call)
        expected = {name: want.get(name, 0) for name in counts}
        if counts != expected:
            fail(f"bench rung 2: launch counts {counts}, expected {expected}")
        with tempfile.TemporaryDirectory() as tmp:
            with metrics.trace(tmp):
                call()
                torch.cuda.synchronize()
            (name,) = os.listdir(tmp)
            with open(os.path.join(tmp, name)) as f:
                events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if not kernels:
            fail(f"bench: metrics.trace wrote {len(events)} events and no CUDA kernel")
        log(f"metrics.trace of one rung-2 call: {len(events)} events, {len(kernels)} CUDA "
            f"kernels, {sum(e.get('dur', 0) for e in kernels) / 1000:.2f} device ms")
        replay = graphs.graphed(call, graphs.Recorder(dev))
        before = wrapper_launches()
        got = replay()
        torch.cuda.synchronize()
        if wrapper_launches() != before:
            fail("bench rung 2: the graph replay launched a kernel wrapper")
        for name, g, e in (("tokens", got.tokens, eager.tokens),
                           ("lengths", got.lengths, eager.lengths)):
            if not torch.equal(g, e):
                rows = int((g != e).reshape(b, -1).any(1).sum())
                fail(f"bench rung 2: graph replay's {name} differ from eager on {rows} rows")
        stops = torch.as_tensor(bm.committed_lengths(b), device=dev)
        stopped = bm.ocr_fn(serving, bm.BUDGET300, 8, stops)(sp, px)
        free = bm.ocr_fn(serving, bm.BUDGET300, 8)(sp, px)
        want_len = torch.minimum(stops, free.lengths)
        if not torch.equal(stopped.lengths, want_len):
            rows = int((stopped.lengths != want_len).sum())
            fail(f"bench budget 300: {rows} rows' lengths are not min(stop, unstopped length)")
        live = torch.arange(bm.BUDGET300, device=dev)[None, :] < stopped.lengths[:, None]
        if bool(((stopped.tokens != free.tokens) & live).any()):
            fail("bench budget 300: tokens differ from the unstopped decode within the length")
    log(f"bench programs, B={b}: rung 2 launches {counts}, its graph replay bit-equal to eager; "
        f"budget 300 lengths min(stop, unstopped) (mean {float(stopped.lengths.float().mean()):.2f}, "
        f"unstopped mean {float(free.lengths.float().mean()):.2f}), tokens equal within each "
        f"length; {time.time() - t0:.1f} s")


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
                "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}, results)
    check_page_tokens(engine, crops)
    rates["int8"] = page_rate(engine, crops, "int8 engine")
    stage_split(engine, crops, "int8 engine")
    check_server(engine, crops)
    del engine
    phase("int8 engine")

    # -- the wire formats and page coalescing on the int8 engine: A, B, C -------
    run_wire(params, crops)
    phase("wire and coalescing")

    # -- compile-once dispatches: one CUDA graph per (bucket, padded batch) ---------
    run_graphs(params, crops)
    phase("engine graphs")

    # -- unquantized serving: kernels E, D, C -----------------------------------
    engine = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), device="cuda",
                                 quantize_int8=False)
    engine.ocr_page(crops[:2])
    drive_page(engine, crops, "bf16 engine",
               {"attention_packed": 12, "fused_mlp_block_bf16": 12, "greedy_decode_loop": 1,
                "greedy_decode_loop[cluster]": 1, "precompute_cross_kv_packed": 1}, results)
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

    # -- the dual pass: ocr_preprocess on the card; A, B, C; the CER harness -----
    torch.cuda.empty_cache()
    pre_ms = check_ocr_preprocess(crops)
    log(f"ocr_preprocess B={PRE_BATCH} ms by orientation {json.dumps(pre_ms)} on {card_line()}")
    phase("ocr_preprocess")
    rates["int8 dual"] = run_dual_engine(params, crops, results)
    phase("dual engine")
    check_eval_harness()
    phase("eval harness")

    # -- the user's entry points on an HF checkpoint directory: A, B, C ----------
    torch.cuda.empty_cache()
    run_hf_entry_points()
    phase("HF checkpoint entry points")

    # -- training at full width; its export served by MangaOcr: A, B, C ---------
    torch.cuda.empty_cache()
    run_training()
    phase("training")

    # -- the full-size closed loop's script, cut to CLOSED_LOOP_STEPS: A, B, C -------
    torch.cuda.empty_cache()
    run_closed_loop()
    phase("closed loop")

    # -- Latin recognizer training at the published CRNN width; no kernel -----------
    torch.cuda.empty_cache()
    run_latin_training()
    phase("latin training")

    # -- detection: the U-Net on the card, native contours; A, B, C ---------------
    torch.cuda.empty_cache()
    engine, stage = run_detection()
    phase("detection")

    # -- the other detector and recognizer families; A, B, C on their crops -------
    torch.cuda.empty_cache()
    run_onnx()
    phase("onnx")
    yolo_tree = run_yolo(engine)
    phase("yolo")
    run_latin(engine)
    phase("latin")

    # -- text erasure and typeset export: LaMa at big-lama width on (c)'s page ---------
    del engine
    torch.cuda.empty_cache()
    run_inpaint(stage)
    phase("inpaint")

    # -- the process command: detect -> OCR (A, B, C) -> translate -> typeset -> export --
    torch.cuda.empty_cache()
    run_process(yolo_tree)
    phase("process")

    # -- data-parallel serving on a virtual mesh of cuda:0; two gloo ranks ------------------
    torch.cuda.empty_cache()
    run_data_parallel()
    phase("data-parallel serving")

    # -- tensor parallelism: the TP engine, the mesh train step, two gloo ranks -----------
    torch.cuda.empty_cache()
    run_tensor_parallel()
    phase("tensor parallelism")

    # -- the throughput bench as a user runs it; its programs: A, B, C -------------------
    torch.cuda.empty_cache()
    run_benchmark()
    phase("benchmark")
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
    if sys.argv[1:2] == ["--core-times"] and sys.argv[2:]:
        compare_trees("core_times", sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--tp-times"] and sys.argv[2:]:
        compare_trees("tp_times", sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--gemm-times"] and sys.argv[2:]:
        compare_trees("compare_child", sys.argv[2:])
        return 0
    if sys.argv[1:] == ["--stack-floor"]:
        stack_floor()
        return 0
    if sys.argv[1:2] == ["--latin-loop"] and len(sys.argv) == 4:
        latin_loop(int(sys.argv[2]), sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--dp-rank"] and len(sys.argv) == 6:
        dp_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
        return 0
    if sys.argv[1:2] == ["--tp-rank"] and len(sys.argv) == 6:
        tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        return 0
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}; usage: chip_smoke.py "
             f"[--stack-floor | --core-times ROOT... | --gemm-times ROOT... | --tp-times ROOT... | "
             f"--latin-loop SEED DIR | --dp-rank RANK N PORT OUT | --tp-rank RANK PORT OUT "
             f"BACKEND]")

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.kernels import build
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig, with_serving_kernels
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder, quantize_encoder

    t0 = time.time()
    build.load()
    log(f"kernels built in {time.time() - t0:.1f} s")
    log_ptxas(build.last_build_log)
    log_cluster_ptxas(build.last_build_log)
    log_core_ptxas(build.last_build_log)
    log_gemm_ptxas(build.last_build_log)
    log_step_ptxas(build.last_build_log)
    phase("build")
    check_attention_core()
    log(f"attention core alone, B=256: ms {json.dumps(core_times())} on {card}")
    phase("attention core")
    check_bf16_gemm()
    phase("bf16 GEMM")
    int8_gemm_times(check=True)
    phase("int8 GEMM")

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
    log(f"J and K cores alone: device ms {json.dumps(step_core_times())} on {card}")
    phase("bf16 and step kernels")
    rates = run_engines(results)

    src = {"fused_attn_layer": ("manga_ocr_tpu_torch/csrc/encoder.cu",
                                "manga_ocr_tpu/ops/flash_attention.py:617"),
           "fused_mlp_block": ("manga_ocr_tpu_torch/csrc/gemm_int8.cu",
                               "manga_ocr_tpu/ops/fused_mlp.py:165"),
           "greedy_decode_loop[cluster]": ("manga_ocr_tpu_torch/csrc/decode_cluster.cu",
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
           "fused_mlp_block[step]": ("manga_ocr_tpu_torch/csrc/gemm_int8.cu",
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
           "greedy_decode_loop[int8_w]": ("manga_ocr_tpu_torch/csrc/decode_cluster.cu",
                                          "manga_ocr_tpu/ops/decode_loop.py:579"),
           # the fuse_kv route: the prologue (mlp_bf16.cu's LN row pass and bf16
           # GEMM) and the cluster kernel
           "greedy_decode_loop[fuse_kv]": ("manga_ocr_tpu_torch/csrc/decode_cluster.cu",
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
