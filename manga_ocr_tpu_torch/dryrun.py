"""A multi-device dry run of everything that runs on a mesh (counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``).

The JAX package re-executes itself under a virtual CPU platform to get n
devices; here a virtual mesh is a list of devices, so the run needs no
second process: ``dryrun_multichip(n)`` builds a mesh of the first n cards,
or of n x ``cuda:0`` where fewer are visible (and raises where CUDA is
unavailable); ``dryrun_multichip(8, "cpu")`` an 8-way mesh of the CPU.

    python -c "from manga_ocr_tpu_torch.dryrun import dryrun_multichip; dryrun_multichip(8, 'cpu')"
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _devices(n: int, device) -> list:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: device='cuda' but CUDA is unavailable")
        if torch.cuda.device_count() >= n:
            return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """On ``n_devices`` devices of ``device``'s type, at the tiny config:

    - one train step on a (n/2 data x 2 model) mesh (n/1 x 1 where n is odd),
      its loss finite, every replica bit-equal after it;
    - tensor-parallel inference on that mesh, the data rows' slices through
      ``models.model.ocr_forward_rows``, tokens equal to one device's;
    - the tensor-parallel engine's ``ocr_page`` (``serving_kernels=False``)
      on 8 crops, strings equal to the single-device engine's;
    - the int8 serving-kernel engine on an (n x 1) data mesh, strings equal
      to one device's;
    - ``BubbleDetector``, ``TorchLatinEngine`` and ``LamaInpainter`` on the
      data mesh against one device (n + 1 inputs, so the padded split runs).

    Raises on any disagreement; returns a summary and prints it."""
    from manga_ocr_tpu_torch import train as trainlib
    from manga_ocr_tpu_torch.detect.detector import BubbleDetector
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.engine import latin as latin_mod
    from manga_ocr_tpu_torch.models import craft as craft_mod
    from manga_ocr_tpu_torch.models import crnn as crnn_mod
    from manga_ocr_tpu_torch.models import detector as seg
    from manga_ocr_tpu_torch.models import inpaint as inpaint_mod
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.parallel import mesh as meshlib

    devices = _devices(n_devices, device)
    dev0 = devices[0]
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_model
    mesh = meshlib.make_mesh(n_data, n_model, devices=devices)
    cfg = MangaOCRConfig.tiny()
    tok = CharTokenizer.synthetic()
    rng = np.random.default_rng(0)

    # -- the (data x model) train step ----------------------------------------------
    opt = trainlib.make_optimizer()
    params, opt_state = trainlib.init_train_state(cfg, opt, 0, dev0.type, mesh=mesh)
    b, t, img = n_devices * 2, 8, cfg.encoder.image_size
    tokens = rng.integers(4, cfg.decoder.vocab_size, size=(b, t)).astype(np.int32)
    tokens[:, 0] = cfg.decoder.bos_token_id
    batch = trainlib.TrainBatch(
        torch.from_numpy(rng.normal(size=(b, img, img, 3)).astype(np.float32)),
        torch.from_numpy(tokens), torch.ones((b, t), dtype=torch.float32))
    params, opt_state, loss = trainlib.make_train_step(cfg, mesh)(params, opt_state, batch)
    loss = float(loss)
    assert math.isfinite(loss), "train step produced a non-finite loss"
    rows = [meshlib.unshard_params(cols) for cols in params]
    flat = [torch.utils._pytree.tree_leaves(r) for r in rows]
    assert all(torch.equal(a.cpu(), b.cpu()) for f in flat[1:] for a, b in zip(flat[0], f)), \
        "replicas differ after the train step"

    # -- tensor-parallel inference on the same mesh ------------------------------------
    infer = init_params(cfg, 1, "cpu", std=0.1)
    grid = meshlib.shard_params(infer, mesh)
    px = torch.from_numpy(rng.normal(size=(b, img, img, 3)).astype(np.float32))
    per = b // n_data
    with torch.inference_mode():
        rows = mdl.ocr_forward_rows(
            grid, [px[i * per:(i + 1) * per].to(mesh.devices[i, 0]) for i in range(n_data)],
            cfg, max_length=8)
        got = torch.cat([r.tokens.cpu() for r in rows])
        want = mdl.ocr_forward(init_params(cfg, 1, dev0, std=0.1), px.to(dev0), cfg,
                               max_length=8).tokens.cpu()
    assert torch.equal(got, want), "tensor-parallel tokens differ from one device's"

    # -- the engine: tensor-parallel, then the serving kernels on a data mesh ----------
    crop_shapes = [(60, 100), (100, 60), (120, 120), (40, 200)]
    page = [rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8) for h, w in crop_shapes] * 2
    eng_params = init_params(cfg, 2, "cpu", std=0.1)
    kw = dict(max_length=8, dtype=torch.float32, device=dev0.type)
    texts = TorchMangaOcrEngine(eng_params, cfg, tok, mesh=mesh, serving_kernels=False,
                                **kw).ocr_page(page)
    single = TorchMangaOcrEngine(eng_params, cfg, tok, serving_kernels=False, **kw)
    assert texts == single.ocr_page(page), "tensor-parallel engine differs from one device's"
    dp_mesh = meshlib.make_mesh(n_devices, 1, devices=devices)
    fused = TorchMangaOcrEngine(eng_params, cfg, tok, mesh=dp_mesh, **kw)
    assert fused.cfg.decoder.step_kernel == "fused_loop", "a data mesh must serve with kernels"
    fused_texts = fused.ocr_page(page)
    assert fused_texts == TorchMangaOcrEngine(eng_params, cfg, tok, **kw).ocr_page(page), \
        "the sharded serving engine differs from one device's"

    # -- the secondary models on the data mesh -----------------------------------------
    det_cfg = seg.DetectorConfig(input_size=32, base_channels=4, depth=2)
    det_params = seg.params_from_jax(seg.init_params_numpy(det_cfg, 3))
    det_pages = [rng.integers(0, 256, size=(48, 64, 3)).astype(np.uint8)
                 for _ in range(n_devices + 1)]
    masks = BubbleDetector(det_params, det_cfg, device=dev0.type,
                           mesh=dp_mesh).detect_bubble_masks(det_pages)
    ref = BubbleDetector(det_params, det_cfg, device=dev0.type).detect_bubble_masks(det_pages)
    assert all(np.array_equal(a, b) for a, b in zip(masks, ref)), \
        "sharded bubble detection differs from one device's"

    craft_cfg = craft_mod.CraftConfig(vgg_channels=(4, 8, 16, 32, 32, 64), head_channels=8)
    crnn_cfg = crnn_mod.CrnnConfig(num_classes=4, output_channel=32, hidden_size=16)
    latin_kw = dict(charset="abc", craft_cfg=craft_cfg, crnn_cfg=crnn_cfg, det_buckets=(64,),
                    rec_width_buckets=(32,), device=dev0.type)
    craft_p = craft_mod.params_from_jax(craft_mod.init_craft_params_numpy(craft_cfg, 0))
    crnn_p = crnn_mod.params_from_jax(crnn_mod.init_crnn_params_numpy(crnn_cfg, 0))
    latin = latin_mod.TorchLatinEngine(craft_p, crnn_p, mesh=dp_mesh, **latin_kw)
    boxes = latin.detect_boxes_batch(det_pages)
    assert boxes == latin_mod.TorchLatinEngine(craft_p, crnn_p, **latin_kw).detect_boxes_batch(
        det_pages), "sharded CRAFT boxes differ from one device's"
    assert latin._craft_repl is not None

    inp_cfg = inpaint_mod.InpaintConfig(base_channels=4, num_blocks=1, downsamples=2,
                                        max_features=16)
    inp_params = inpaint_mod.params_from_jax(inpaint_mod.init_params_numpy(inp_cfg, 4))
    regions = [rng.integers(0, 256, size=(24, 24, 3)).astype(np.uint8)
               for _ in range(n_devices + 1)]
    holes = [rng.integers(0, 2, size=(24, 24)).astype(np.uint8) * 255 for _ in regions]
    out = inpaint_mod.LamaInpainter(inp_params, inp_cfg, device=dev0.type,
                                    mesh=dp_mesh).inpaint_many(regions, holes)
    ref = inpaint_mod.LamaInpainter(inp_params, inp_cfg, device=dev0.type).inpaint_many(
        regions, holes)
    worst = max(int(np.abs(a.astype(np.int16) - r.astype(np.int16)).max())
                for a, r in zip(out, ref))
    assert worst <= 1, f"sharded inpainting differs from one device's by {worst} levels"

    summary = {"mesh": (n_data, n_model), "devices": [str(d) for d in devices],
               "train_loss": loss, "tokens": tuple(got.shape), "tp_texts": len(texts),
               "dp_texts": len(fused_texts), "det_pages": len(masks),
               "craft_pages": len(boxes), "inpaint_regions": len(out)}
    print(f"dryrun_multichip ok: mesh=({n_data} data x {n_model} model) on {sorted(set(summary['devices']))}, "
          f"train loss={loss:.4f}, decode tokens={tuple(got.shape)}, the tensor-parallel engine "
          f"read {len(texts)} crops and the {n_devices}-way serving engine {len(fused_texts)}, "
          f"each as one device; bubble detector ({len(masks)} pages), CRAFT ({len(boxes)} "
          f"pages) and LaMa ({len(out)} regions) sharded with one device's outputs")
    return summary
