"""HTTP OCR serving around ``TorchMangaOcrEngine`` (counterpart of
``manga_ocr_tpu/serve.py``): a stdlib ``http.server`` endpoint with
microbatching, so concurrent single-crop requests coalesce into padded
page-size dispatches.

- ``POST /ocr``       — body: raw image bytes (PNG/JPEG/WebP) -> {"text"}
- ``POST /ocr_batch`` — body: JSON {"images": [base64, ...]} -> {"texts"}
- ``GET  /healthz``   — liveness + the torch device
- ``GET  /stats``     — throughput + stage timing counters

Run: python -m manga_ocr_tpu_torch.serve --port 8080 --seed 0
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from manga_ocr_tpu_torch.runtime.pipeline import MicroBatcher
from manga_ocr_tpu_torch.utils.metrics import GLOBAL_TIMER, OCR_COUNTER

# Unauthenticated stdlib server: cap request bodies.
MAX_REQUEST_BYTES = 32 * 1024 * 1024


def _decode_image(data: bytes) -> np.ndarray:
    from PIL import Image

    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return rgb[..., ::-1].copy()


class OcrService:
    """Engine + microbatcher wrapper used by the HTTP handler (and tests)."""

    def __init__(self, engine, window_ms: float = 10.0):
        self.engine = engine
        self.batcher = MicroBatcher(engine.ocr_page, window_ms=window_ms)

    def ocr_bytes(self, data: bytes) -> str:
        img = _decode_image(data)
        with GLOBAL_TIMER.stage("ocr_request"):
            text = self.batcher.ocr(img)
        OCR_COUNTER.add(1)
        return text

    def ocr_batch_b64(self, images_b64: list[str]) -> list[str]:
        crops = [_decode_image(base64.b64decode(s)) for s in images_b64]
        with GLOBAL_TIMER.stage("ocr_batch_request"):
            texts = self.engine.ocr_page(crops)
        OCR_COUNTER.add(len(crops))
        return texts

    def close(self):
        self.batcher.close()


def make_handler(service: OcrService, device: torch.device):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, ensure_ascii=False).encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (ConnectionError, BrokenPipeError):
                # the client went away mid-reply: nothing to tell it
                self.close_connection = True

        def do_GET(self):
            if self.path == "/healthz":
                if device.type == "cuda":
                    devices = [torch.cuda.get_device_name(i)
                               for i in range(torch.cuda.device_count())]
                else:
                    devices = [str(device)]
                self._reply(200, {"status": "ok", "backend": device.type,
                                  "device_count": len(devices), "devices": devices})
            elif self.path == "/stats":
                self._reply(200, {
                    "stages": GLOBAL_TIMER.summary(),
                    "ocr_total": OCR_COUNTER.total,
                    "ocr_rate_per_s": round(OCR_COUNTER.rate(), 2),
                })
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            # Validate Content-Length ourselves: a negative value would
            # bypass the size cap and a malformed one escape as a ValueError.
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._reply(400, {"error": "invalid Content-Length"})
                return
            if length < 0 or length > MAX_REQUEST_BYTES:
                self._reply(413, {"error": f"request too large (> {MAX_REQUEST_BYTES} bytes)"})
                return
            try:
                data = self.rfile.read(length)
            except (ConnectionError, BrokenPipeError):
                self.close_connection = True
                return
            try:
                if self.path == "/ocr":
                    self._reply(200, {"text": service.ocr_bytes(data)})
                elif self.path == "/ocr_batch":
                    req = json.loads(data)
                    self._reply(200, {"texts": service.ocr_batch_b64(req.get("images", []))})
                else:
                    self._reply(404, {"error": "not found"})
            except (TimeoutError, FuturesTimeout) as e:
                self._reply(503, {"error": f"busy: {e}"})
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(
    engine, port: int = 8080, window_ms: float = 10.0, host: str = "127.0.0.1"
) -> ThreadingHTTPServer:
    """Start the server on a daemon thread and return it (loopback by
    default: the service has no auth).  Stop it with ``httpd.shutdown()``
    and ``httpd.service.close()``."""
    service = OcrService(engine, window_ms)
    httpd = ThreadingHTTPServer((host, port), make_handler(service, engine.device))
    httpd.service = service  # type: ignore[attr-defined]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def build_engine(args):
    """A ``TorchMangaOcrEngine`` from command-line arguments: random weights
    from ``--seed`` at ``MangaOCRConfig.base()`` width (no checkpoint loader
    is ported yet), the synthetic tokenizer, ``--dtype`` and
    ``--serving-kernels`` as in the JAX server (``auto`` leaves the choice
    to the engine; ``off`` is the exact reference path)."""
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    cfg = MangaOCRConfig.base()
    flag = args.serving_kernels
    return TorchMangaOcrEngine(
        init_params(cfg, args.seed, "cpu"), cfg, CharTokenizer.synthetic(),
        max_length=args.max_length, device=args.device,
        dtype=torch.float32 if args.dtype == "float32" else torch.bfloat16,
        serving_kernels=None if flag == "auto" else flag == "on",
    )


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--max-length", type=int, default=300)
    p.add_argument("--window-ms", type=float, default=10.0)
    p.add_argument(
        "--dtype", default="bfloat16", choices=("bfloat16", "float32"),
        help="compute dtype (the CUDA kernels take bfloat16)",
    )
    p.add_argument(
        "--serving-kernels", default="auto", choices=("auto", "on", "off"),
        help="int8 serving kernels: auto (engine default), on, or off (exact "
        "reference math)",
    )
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    engine = build_engine(args)
    engine.warmup()
    httpd = serve(engine, args.port, args.window_ms, host=args.host)
    print(f"serving on {args.host}:{args.port}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        httpd.service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
