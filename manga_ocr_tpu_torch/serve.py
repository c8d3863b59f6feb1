"""HTTP OCR serving around ``TorchMangaOcrEngine``.

Reuses the JAX package's service and handler (``manga_ocr_tpu/serve.py``:
microbatched ``POST /ocr``, ``POST /ocr_batch``, ``GET /stats``) and replaces
only ``GET /healthz``, which there imports ``jax``; here it reports the
torch device.

Run: python -m manga_ocr_tpu_torch.serve --port 8080 --seed 0
"""

from __future__ import annotations

import argparse
import threading
from http.server import ThreadingHTTPServer

import torch

from manga_ocr_tpu.serve import OcrService, make_handler


def make_torch_handler(service: OcrService, device: torch.device):
    base = make_handler(service)

    class Handler(base):
        def do_GET(self):
            if self.path != "/healthz":
                return super().do_GET()
            if device.type == "cuda":
                devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
            else:
                devices = [str(device)]
            self._reply(
                200,
                {"status": "ok", "backend": device.type, "device_count": len(devices),
                 "devices": devices},
            )

    return Handler


def serve(
    engine, port: int = 8080, window_ms: float = 10.0, host: str = "127.0.0.1"
) -> ThreadingHTTPServer:
    """Start the server on a daemon thread and return it (loopback by
    default: the service has no auth).  Stop it with ``httpd.shutdown()``
    and ``httpd.service.close()``."""
    service = OcrService(engine, window_ms)
    httpd = ThreadingHTTPServer((host, port), make_torch_handler(service, engine.device))
    httpd.service = service  # type: ignore[attr-defined]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def build_engine(args):
    """A ``TorchMangaOcrEngine`` from command-line arguments: random weights
    from ``--seed`` at ``MangaOCRConfig.base()`` width (no checkpoint loader
    is ported yet), the synthetic tokenizer, ``--dtype`` and
    ``--serving-kernels`` as in the JAX server (``auto`` leaves the choice
    to the engine; ``off`` is the exact reference path)."""
    from manga_ocr_tpu.models.config import MangaOCRConfig
    from manga_ocr_tpu.models.tokenizer import CharTokenizer
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.params import init_params

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
