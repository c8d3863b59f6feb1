"""The port's HTTP server (real sockets, tiny CPU engine): /ocr and
/ocr_batch return the engine's own texts, /healthz reports the torch device
without importing jax, and the port package never imports jax at all."""

import base64
import io
import json
import os
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from manga_ocr_tpu_torch import serve as srv
from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
from manga_ocr_tpu_torch.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models.params import init_params
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _crop(seed):
    return np.random.default_rng(seed).integers(0, 255, size=(40, 60, 3)).astype(np.uint8)


def _png(bgr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(bgr[..., ::-1]).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def server():
    cfg = MangaOCRConfig.tiny()
    engine = TorchMangaOcrEngine(
        init_params(cfg, 0, "cpu", std=0.1), cfg, CharTokenizer.synthetic(),
        max_length=8, dtype=torch.float32, device="cpu",
    )
    httpd = srv.serve(engine, port=0)
    yield engine, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.service.close()


def _post(url, data, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_healthz_reports_torch_device(server):
    _, url = server
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
        body = json.loads(resp.read())
    assert body == {"status": "ok", "backend": "cpu", "device_count": 1, "devices": ["cpu"]}


def test_ocr_single_equals_engine(server):
    engine, url = server
    crops = [_crop(i) for i in range(3)]
    direct = engine.ocr_page(crops)
    got = [_post(f"{url}/ocr", _png(c))[1]["text"] for c in crops]
    assert got == direct


def test_ocr_batch_equals_engine(server):
    engine, url = server
    crops = [_crop(i) for i in range(4)]
    body = json.dumps({"images": [base64.b64encode(_png(c)).decode() for c in crops]}).encode()
    status, out = _post(f"{url}/ocr_batch", body, {"Content-Type": "application/json"})
    assert status == 200 and out["texts"] == engine.ocr_page(crops)


def test_stats_and_unknown_routes(server):
    _, url = server
    with urllib.request.urlopen(f"{url}/stats", timeout=30) as resp:
        assert "ocr_total" in json.loads(resp.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nope", timeout=30)
    assert e.value.code == 404


@pytest.mark.parametrize(
    "flags, attn, dtype",
    [([], "fused_layer", torch.bfloat16), (["--serving-kernels", "on"], "fused_layer", torch.bfloat16),
     (["--serving-kernels", "off", "--dtype", "float32"], "xla", torch.float32)],
    ids=["auto", "on", "off_f32"],
)
def test_build_engine_honours_flags(monkeypatch, flags, attn, dtype):
    """``--serving-kernels`` and ``--dtype`` reach the engine (the base
    config is swapped for the tiny one to keep the test small)."""
    monkeypatch.setattr(MangaOCRConfig, "base", staticmethod(MangaOCRConfig.tiny))
    args = srv.parser().parse_args(["--device", "cpu", "--max-length", "6", *flags])
    engine = srv.build_engine(args)
    assert engine.cfg.encoder.attn_kernel == attn
    assert engine.dtype == dtype and engine.max_length == 6
    assert engine.params["decoder"]["tok_embed"].dtype == dtype
    assert engine.cfg.decoder.step_kernel == ("xla" if attn == "xla" else "fused_loop")


def test_port_never_imports_jax():
    """Import every module of the port and run the tiny engine and server
    with ``jax`` blocked by an import hook."""
    script = textwrap.dedent(
        """
        import importlib, json, pkgutil, sys, urllib.request

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith("jax.") or name == "jaxlib":
                    raise ImportError("jax is blocked")

        sys.meta_path.insert(0, Block())
        import numpy as np, torch
        import manga_ocr_tpu_torch
        for m in pkgutil.walk_packages(manga_ocr_tpu_torch.__path__, "manga_ocr_tpu_torch."):
            importlib.import_module(m.name)
        from manga_ocr_tpu_torch import serve as srv
        from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
        from manga_ocr_tpu_torch.models.config import MangaOCRConfig
        from manga_ocr_tpu_torch.models.params import init_params
        from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

        cfg = MangaOCRConfig.tiny()
        eng = TorchMangaOcrEngine(init_params(cfg, 0, "cpu"), cfg, CharTokenizer.synthetic(),
                                  max_length=6, dtype=torch.float32, device="cpu")
        crop = np.zeros((40, 60, 3), np.uint8)
        assert len(eng.ocr_page([crop])) == 1
        httpd = srv.serve(eng, port=0)
        url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
        assert json.loads(urllib.request.urlopen(url, timeout=30).read())["status"] == "ok"
        httpd.shutdown(); httpd.service.close()
        assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
        print("NO_JAX_OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
