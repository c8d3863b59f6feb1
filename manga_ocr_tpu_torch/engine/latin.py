"""Latin OCR engine on PyTorch (CRAFT detect -> CTC recognize, batched;
counterpart of ``manga_ocr_tpu/engine/latin.py``'s ``TpuLatinEngine``).

The reference covers Latin text via pip black boxes (EasyOCR et al.,
engine dispatch ``main_window.py:9805-9919``) -- one torch call per image.
This engine runs the same two-model pipeline (``models/craft.py`` +
``models/crnn.py``) batched on the device:

- the detector runs on square, size-bucketed padded images (a bucket's
  pages in CRAFT dispatches of at most ``DISPATCH_PAGES`` pages and
  ``DISPATCH_PIXELS`` pixels),
- ALL detected line crops go to width-bucketed recognizer batches -- one
  recognizer dispatch per width bucket, not one per line,
- host work is limited to box extraction (data-dependent, the port's
  ``detect/craft_boxes.py``) and CTC decode.

Weights: EasyOCR's published ``.pth`` checkpoints convert via
``models/convert_latin.py``, and a recognizer trained by ``train_latin``
loads from its checkpoint directory (``from_checkpoints``); without them
the engine draws the port's numpy init (seed 0), not JAX's ``PRNGKey(0)``.
Engine contract: ``perform_ocr(bgr, settings) -> str`` with
``"[ERROR: ...]"`` sentinel strings.  Under a mesh (``parallel.mesh``), a
CRAFT or CRNN batch of at least the data-axis size is split across the data
devices.
"""

from __future__ import annotations

import numpy as np
import torch

from manga_ocr_tpu_torch.detect import craft_boxes
from manga_ocr_tpu_torch.models import craft as craft_mod
from manga_ocr_tpu_torch.models import crnn as crnn_mod
from manga_ocr_tpu_torch.models.detector import fp32_products
from manga_ocr_tpu_torch.parallel import mesh as meshlib

# Default charset: blank(0) + these characters in order.  A converted
# checkpoint's training charset MUST be passed explicitly (the class-count
# check below catches mismatches); this default exists for tests and for
# models fine-tuned locally against it.
DEFAULT_CHARSET = (
    "0123456789!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~ "
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
)

_DET_BUCKETS = (256, 512, 768, 1024)  # square pads, multiples of 16
# The pages and padded pixels one CRAFT dispatch takes (at least one page):
# 4 pages of the 256 or 512 bucket, 1 of 768 or 1024.  On an H100, cuDNN runs
# the 1024 bucket's convolutions as FFTs at 2 and 4 pages a dispatch, 4-7x
# slower a page than at 1 (~18 against 1.3 GiB), and one page is as fast a page
# as eight at a sixteenth of the memory; 16 pages of 256 take ~10 GiB against
# 1.3 for 4 of 512 (PERF.md; chip_smoke.py phase "latin" sweeps them).
DISPATCH_PAGES = 4
DISPATCH_PIXELS = 1024 * 1024
_REC_WIDTH_BUCKETS = (64, 128, 256, 512)


def _round_up(v: int, buckets: tuple) -> int:
    for b in buckets:
        if v <= b:
            return b
    return buckets[-1]


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on(v, device) for v in tree]
    return tree.detach().to(device)


class TorchLatinEngine:
    """CRAFT + CTC recognizer as one batched engine.

    ``craft_params`` / ``crnn_params``: the port's trees
    (``models.craft.params_from_jax`` etc.), copied once to ``device``
    (default ``"cuda"``, which raises where CUDA is unavailable
    rather than running on the CPU); None draws the port's numpy init on
    first use of that half.

    ``mesh``: a ``parallel.mesh.Mesh`` whose devices replace ``device``
    (they must be of its type).  CRAFT page batches (at most
    ``DISPATCH_PAGES`` and ``DISPATCH_PIXELS`` a device) and CRNN line
    batches of at least the data-axis size are zero-padded and split
    across the data devices, each half's weights replicated once per raw
    tree; smaller batches run on the first device."""

    def __init__(
        self,
        craft_params: dict | None = None,
        crnn_params: dict | None = None,
        charset: str = DEFAULT_CHARSET,
        craft_cfg: craft_mod.CraftConfig | None = None,
        crnn_cfg: crnn_mod.CrnnConfig | None = None,
        det_buckets: tuple = _DET_BUCKETS,
        rec_width_buckets: tuple = _REC_WIDTH_BUCKETS,
        mesh=None,
        device="cuda",
    ):
        self.device = meshlib.serving_devices(mesh, device, "TorchLatinEngine")[0]
        self.mesh = mesh
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchLatinEngine: device='cuda' but CUDA is unavailable")
        self.craft_cfg = craft_cfg or craft_mod.CraftConfig()
        self.crnn_cfg = crnn_cfg or crnn_mod.CrnnConfig(num_classes=len(charset) + 1)
        self.charset = charset
        if len(charset) + 1 != self.crnn_cfg.num_classes:
            raise ValueError(
                f"charset size {len(charset)} + blank != num_classes "
                f"{self.crnn_cfg.num_classes}"
            )
        # params init lazily per half: recognition-only callers never pay
        # the (large) random CRAFT init, and vice versa
        self._craft_params = None if craft_params is None else _on(craft_params, self.device)
        self._crnn = None if crnn_params is None else crnn_mod.Crnn(_on(crnn_params, self.device))
        self.det_buckets = det_buckets
        self.rec_width_buckets = rec_width_buckets

    @property
    def craft_params(self) -> dict:
        if self._craft_params is None:
            self._craft_params = craft_mod.init_craft_params(self.craft_cfg, 0, self.device)
        return self._craft_params

    @property
    def crnn(self) -> crnn_mod.Crnn:
        if self._crnn is None:
            self._crnn = crnn_mod.Crnn(crnn_mod.init_crnn_params(self.crnn_cfg, 0, self.device))
        return self._crnn

    @property
    def crnn_params(self) -> dict:
        return self.crnn.params

    def _replicas(self, raw: dict, cache_attr: str, make=lambda tree: tree) -> list:
        """``make`` of the tree ``raw`` on each data device, made once per
        raw tree and cached in ``cache_attr``."""
        cached = getattr(self, cache_attr, None)
        if cached is None or cached[0] is not raw:
            cached = (raw, [make(t) for t in meshlib.dp_replicate(raw, self.mesh)])
            setattr(self, cache_attr, cached)
        return cached[1]

    # -- detection ---------------------------------------------------------

    def _prep_for_detection(self, rgb: np.ndarray) -> tuple[np.ndarray, int, int, int, float]:
        """Scale-to-fit + pick the pad bucket for one image.

        Returns ``(scaled_rgb, side, h, w, scale)`` where ``(h, w)`` are the
        scaled dims that occupy the top-left of the ``side``-square pad."""
        h, w = rgb.shape[:2]
        side = _round_up(max(h, w), self.det_buckets)
        scale = min(1.0, side / max(h, w, 1))
        if scale < 1.0:
            rgb = _resize_rgb(rgb, (int(h * scale), int(w * scale)))
            h, w = rgb.shape[:2]
        return rgb, side, h, w, scale

    def _boxes_from_maps(
        self, region: np.ndarray, affinity: np.ndarray, h: int, w: int, scale: float
    ) -> list[tuple[int, int, int, int]]:
        """Half-res score maps (one image) -> boxes in original image coords."""
        region = np.asarray(region[: (h + 1) // 2, : (w + 1) // 2])
        affinity = np.asarray(affinity[: (h + 1) // 2, : (w + 1) // 2])
        boxes = craft_boxes.extract_boxes(
            region,
            affinity,
            text_threshold=self.craft_cfg.text_threshold,
            link_threshold=self.craft_cfg.link_threshold,
            low_text=self.craft_cfg.low_text,
        )
        if scale < 1.0:
            inv = 1.0 / scale
            boxes = [
                (int(x * inv), int(y * inv), int(bw * inv), int(bh * inv))
                for x, y, bw, bh in boxes
            ]
        return boxes

    def detect_maps(self, batch_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One CRAFT dispatch: uint8 RGB [N, side, side, 3] -> host (region,
        affinity) maps [N, side/2, side/2]; split across the mesh where it
        holds at least the data-axis size of pages."""
        n = batch_u8.shape[0]
        if not meshlib.splits(self.mesh, n):
            region, affinity = craft_mod.detect_maps(self.craft_params, batch_u8)
            return region.cpu().numpy(), affinity.cpu().numpy()
        repl = self._replicas(self.craft_params, "_craft_repl")
        maps = [craft_mod.detect_maps(p, x)
                for p, x in zip(repl, meshlib.dp_shard_batch(batch_u8, self.mesh))]
        return (meshlib.dp_gather([m[0] for m in maps], n),
                meshlib.dp_gather([m[1] for m in maps], n))

    def detect_boxes(self, rgb: np.ndarray) -> list[tuple[int, int, int, int]]:
        """RGB uint8 [H,W,3] -> [(x,y,w,h)] text boxes in image coords."""
        rgb, side, h, w, scale = self._prep_for_detection(rgb)
        padded = np.zeros((1, side, side, 3), np.uint8)
        padded[0, :h, :w] = rgb
        region, affinity = self.detect_maps(padded)
        return self._boxes_from_maps(region[0], affinity[0], h, w, scale)

    def detect_boxes_batch(self, images: list[np.ndarray]) -> list[list[tuple[int, int, int, int]]]:
        """Batched multi-page detection: images grouped by pad bucket, a
        bucket's pages in CRAFT dispatches of at most ``DISPATCH_PAGES`` and
        ``DISPATCH_PIXELS`` a device (vs the reference's per-image torch call
        in the AutoDetector sweep, ``workers.py:448-482``)."""
        prepped = [self._prep_for_detection(np.asarray(img)) for img in images]
        per_bucket: dict[int, list[int]] = {}
        for i, (_, side, _, _, _) in enumerate(prepped):
            per_bucket.setdefault(side, []).append(i)
        out: list[list[tuple[int, int, int, int]]] = [[] for _ in images]
        for side, bucket in sorted(per_bucket.items()):
            cap = max(1, min(DISPATCH_PAGES, DISPATCH_PIXELS // (side * side)))
            for part in meshlib.dispatch_slices(len(bucket), cap, self.mesh):
                idxs = bucket[part]
                batch = np.zeros((len(idxs), side, side, 3), np.uint8)
                for row, i in enumerate(idxs):
                    rgb, _, h, w, _ = prepped[i]
                    batch[row, :h, :w] = rgb
                region, affinity = self.detect_maps(batch)
                for row, i in enumerate(idxs):
                    _, _, h, w, scale = prepped[i]
                    out[i] = self._boxes_from_maps(region[row], affinity[row], h, w, scale)
        return out

    # -- recognition -------------------------------------------------------

    def recognize_logits(self, batch: np.ndarray) -> np.ndarray:
        """One CRNN dispatch: normalized gray crops [N, H, W, 1] f32 -> host
        logits [N, W/4 - 1, K]; split across the mesh where it holds at least
        the data-axis size of lines."""
        n = batch.shape[0]
        if not meshlib.splits(self.mesh, n):
            nets, shards = [self.crnn], [torch.from_numpy(batch).to(self.device)]
        else:
            nets = self._replicas(self.crnn_params, "_crnn_repl", crnn_mod.Crnn)
            shards = meshlib.dp_shard_batch(batch, self.mesh)
        with fp32_products():
            logits = [crnn_mod.crnn_forward(net, x.permute(0, 3, 1, 2).contiguous())
                      for net, x in zip(nets, shards)]
        return meshlib.dp_gather(logits, n)

    def recognize_lines(self, gray_crops: list[np.ndarray]) -> list[str]:
        """Gray uint8 line crops (any sizes) -> texts, ONE recognizer
        dispatch per width bucket."""
        if not gray_crops:
            return []
        ih = self.crnn_cfg.input_height
        # resize each to input height, keep aspect, group by width bucket
        per_bucket: dict[int, list[tuple[int, np.ndarray, int]]] = {}
        for i, crop in enumerate(gray_crops):
            ch, cw = crop.shape[:2]
            if ch == 0 or cw == 0:
                per_bucket.setdefault(0, []).append((i, None, 0))
                continue
            nw = max(8, int(round(cw * ih / ch)))
            resized = _resize_gray(crop, (ih, nw))
            bucket = _round_up(nw, self.rec_width_buckets)
            if nw > bucket:  # wider than the largest bucket: squeeze
                resized = _resize_gray(crop, (ih, bucket))
                nw = bucket
            per_bucket.setdefault(bucket, []).append((i, resized, nw))
        texts = [""] * len(gray_crops)
        for bucket, items in per_bucket.items():
            if bucket == 0:
                continue
            batch = np.zeros((len(items), ih, bucket, 1), np.float32)
            widths = np.zeros(len(items), np.int64)
            for row, (_, resized, nw) in enumerate(items):
                batch[row, :, :nw, 0] = resized.astype(np.float32)
                widths[row] = nw
            batch = (batch / 255.0 - 0.5) / 0.5
            logits = self.recognize_logits(batch)[: len(items)]
            # valid columns: feature T = W/4 - 1 at the default geometry
            t_valid = np.maximum(widths // 4 - 1, 1)
            decoded = crnn_mod.ctc_greedy(logits, t_valid, blank_id=self.crnn_cfg.blank_id)
            for (idx, _, _), ids in zip(items, decoded):
                texts[idx] = "".join(
                    self.charset[k - 1] for k in ids if 0 < k <= len(self.charset)
                )
        return texts

    # -- engine contract ---------------------------------------------------

    def readtext(self, bgr: np.ndarray) -> list[tuple[tuple, str]]:
        """EasyOCR-shaped API: [(box, text)] per detected region."""
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        boxes = self.detect_boxes(rgb)
        gray = _to_gray(rgb)
        crops = [gray[y : y + h, x : x + w] for x, y, w, h in boxes]
        texts = self.recognize_lines(crops)
        return [(b, t) for b, t in zip(boxes, texts) if t]

    def perform_ocr(self, cv_bgr_image: np.ndarray, settings: dict | None = None) -> str:
        try:
            img = np.asarray(cv_bgr_image)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=2)
            results = self.readtext(img)
            lines = craft_boxes.group_lines([b for b, _ in results])
            by_box = {tuple(b): t for b, t in results}
            return "\n".join(
                " ".join(by_box[tuple(b)] for b in line if tuple(b) in by_box)
                for line in lines
            ).strip()
        except Exception as e:  # sentinel contract (workers.py:296 checks)
            return f"[ERROR: Latin engine failed: {e}]"

    @classmethod
    def from_checkpoints(
        cls, craft_path: str, crnn_path: str, charset: str | None = None, **kw
    ) -> "TorchLatinEngine":
        """Build from checkpoints.

        ``craft_path``: torch ``.pth`` (EasyOCR's published detector).
        ``crnn_path``: torch ``.pth`` OR a native checkpoint dir written by
        ``train_latin.save_crnn_checkpoint`` in either package (whose
        manifest carries the config and the training charset -- an explicit
        ``charset`` argument overrides it; for ``.pth`` the charset defaults
        to :data:`DEFAULT_CHARSET`)."""
        import os

        from manga_ocr_tpu_torch.models import convert_latin as cl

        craft_params = craft_mod.params_from_jax(
            cl.convert_craft_state_dict(cl.load_torch_checkpoint(craft_path)))
        if os.path.isdir(crnn_path):
            from manga_ocr_tpu_torch.train_latin import load_crnn_checkpoint

            crnn_params, crnn_cfg, manifest_charset = load_crnn_checkpoint(crnn_path, "cpu")
            kw.setdefault("crnn_cfg", crnn_cfg)
            charset = charset or manifest_charset
        else:
            crnn_params = crnn_mod.params_from_jax(
                cl.convert_crnn_state_dict(cl.load_torch_checkpoint(crnn_path)))
            num_classes = crnn_params["head"]["bias"].shape[0]
            kw.setdefault("crnn_cfg", crnn_mod.CrnnConfig(num_classes=num_classes))
            charset = charset or DEFAULT_CHARSET
        num_classes = crnn_params["head"]["bias"].shape[0]
        if len(charset) + 1 != num_classes:
            raise ValueError(
                f"checkpoint has {num_classes} classes; charset must have "
                f"{num_classes - 1} characters"
            )
        return cls(craft_params, crnn_params, charset=charset, **kw)


# -- small host helpers (PIL-free, cv2-free) --------------------------------


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    # cv2-parity fixed-point luma (same coefficients as the batching gray)
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)


def _resize_gray(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Nearest-ish bilinear resize via index sampling (host, small crops)."""
    h, w = img.shape[:2]
    nh, nw = hw
    ys = np.clip(((np.arange(nh) + 0.5) * h / nh - 0.5).round().astype(int), 0, h - 1)
    xs = np.clip(((np.arange(nw) + 0.5) * w / nw - 0.5).round().astype(int), 0, w - 1)
    return img[ys][:, xs]


def _resize_rgb(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    h, w = img.shape[:2]
    nh, nw = hw
    ys = np.clip(((np.arange(nh) + 0.5) * h / nh - 0.5).round().astype(int), 0, h - 1)
    xs = np.clip(((np.arange(nw) + 0.5) * w / nw - 0.5).round().astype(int), 0, w - 1)
    return img[ys][:, xs]
