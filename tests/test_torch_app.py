"""The port's application layers against the JAX package's, on the same inputs
through shared fakes (no network): the settings file (defaults, merge, round
trip, key rotation), ``robust_post`` (retry and fatal-4xx rules with an
injected ``sleep``), ``_default_transport`` in its ``requests`` and
``urllib`` branches against a loopback server, the rate limiter (windows,
blocking acquire, costs, store round trip), the styles store, every
translation provider, ``TranslationService`` (``translate_with_ai`` with the
DeepL fallback and the no-key sentinel, ``translate_for_job``,
``translate_batch``, ``review_scene``, ``review_batch``), ``AiOcrEngine``
with its payload ladder and disk cache, the review workflows on one
``Project``, and the engine registry (dispatch rules on recording engines,
``_latin_preprocess`` byte for byte per orientation setting on the fixture
crops, ``TesseractEngine`` on a stand-in binary, the lazy engines, and the
``device="cuda"`` refusal without CUDA).  One recording transport serves both
packages: each call's URL, body bytes, headers and timeout are held equal,
and so are the return values."""

import dataclasses
import glob
import http.server
import json
import os
import stat
import sys
import threading
import types

import numpy as np
import pytest
import torch

from manga_ocr_tpu.core import project as jproject
from manga_ocr_tpu.core import review as jreview
from manga_ocr_tpu.core import settings as jsettings
from manga_ocr_tpu.core.geometry import Rect as JRect
from manga_ocr_tpu.engine import ai_ocr as jai
from manga_ocr_tpu.engine import registry as jreg
from manga_ocr_tpu.translate import prompts as jprompts
from manga_ocr_tpu.translate import providers as jprov
from manga_ocr_tpu.translate import service as jservice
from manga_ocr_tpu.translate import styles as jstyles
from manga_ocr_tpu.typeset.area import TypesetArea as JArea
from manga_ocr_tpu.utils import http as jhttp
from manga_ocr_tpu.utils import rate_limit as jrate
from manga_ocr_tpu_torch.core import project as tproject
from manga_ocr_tpu_torch.core import review as treview
from manga_ocr_tpu_torch.core import settings as tsettings
from manga_ocr_tpu_torch.core.geometry import Rect as TRect
from manga_ocr_tpu_torch.engine import ai_ocr as tai
from manga_ocr_tpu_torch.engine import registry as treg
from manga_ocr_tpu_torch.translate import prompts as tprompts
from manga_ocr_tpu_torch.translate import providers as tprov
from manga_ocr_tpu_torch.translate import service as tservice
from manga_ocr_tpu_torch.translate import styles as tstyles
from manga_ocr_tpu_torch.typeset.area import TypesetArea as TArea
from manga_ocr_tpu_torch.utils import http as thttp
from manga_ocr_tpu_torch.utils import rate_limit as trate
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(
        settings=jsettings, http=jhttp, rate=jrate, prov=jprov, service=jservice,
        prompts=jprompts, styles=jstyles, ai=jai, reg=jreg, review=jreview,
        project=jproject, Rect=JRect, Area=JArea, device=()),
    "torch": types.SimpleNamespace(
        settings=tsettings, http=thttp, rate=trate, prov=tprov, service=tservice,
        prompts=tprompts, styles=tstyles, ai=tai, reg=treg, review=treview,
        project=tproject, Rect=TRect, Area=TArea, device=("cpu",)),
}


class Recorder:
    """A transport both packages call: records (url, body, headers, timeout)
    and answers with ``reply(url, body) -> (status, payload)``."""

    def __init__(self, reply):
        self.reply = reply
        self.calls = []

    def __call__(self, url, data, headers, timeout):
        self.calls.append((url, bytes(data), dict(headers), timeout))
        status, payload = self.reply(url, data)
        if isinstance(payload, Exception):
            raise payload
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        return thttp.HttpResponse(status, body)


def same(fn):
    """``fn(pkg)`` on each package: the results must be equal; returns the
    port's."""
    out = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- settings ------------------------------------------------------------------------


def test_settings_defaults_merge_round_trip_and_rotation(tmp_path):
    assert same(lambda p: p.settings.default_settings())["tpu"]["latin_craft_checkpoint"] == ""
    base = {"a": {"b": 1, "c": [1, 2]}, "d": 3}
    over = {"a": {"b": {"x": 1}, "e": 5}, "d": {"y": 2}, "f": None}
    assert same(lambda p: p.settings.deep_merge(base, over)) == {
        "a": {"b": {"x": 1}, "c": [1, 2], "e": 5}, "d": {"y": 2}, "f": None}

    def run(name, p):
        d = tmp_path / name
        d.mkdir()
        created = p.settings.load_or_create_settings(str(d / "new.json"))  # written
        user = d / "user.json"
        user.write_text(json.dumps({"general": {"save_format": "WEBP"}, "custom": 1,
                                    "apis": {"gemini": {"keys": ["k1", "", "k2"]}}}))
        (d / "bad.json").write_text("{not json")
        bad = p.settings.load_or_create_settings(str(d / "bad.json"))
        s = p.settings.Settings(str(user))
        got = [s.get("general.save_format"), s.get("general.save_quality"), s.get("custom"),
               s.get("no.such.key", "dflt"), s.get("general.save_format.deeper")]
        s.set("tpu.max_decode_length", 128)
        s.set("new.block.key", [1])
        s.add_key("gemini", "k3")
        s.add_key("gemini", "k1")
        keys = [s.get_active_key("gemini") for _ in range(5)] + [s.get_active_key("deepl")]
        s.save()
        again = p.settings.Settings(str(user))
        return (created, bad == created, got, keys, s.as_dict() == again.as_dict(),
                (d / "new.json").read_bytes(), user.read_bytes(),
                p.settings.Settings().as_dict())

    out = {name: run(name, pkg) for name, pkg in PKGS.items()}
    assert out["torch"] == out["jax"]
    assert out["torch"][3] == ["k1", "k2", "k3", "k1", "k2", None]


# -- HTTP -------------------------------------------------------------------------------


@pytest.mark.parametrize("statuses,want", [
    ([503, 429, 200], 200), ([401], 401), ([404], 404), ([500, 500, 500, 500], 500),
    ([429, 403], 403), (["err", "err", 200], 200), (["err"] * 4, "ConnectionError"),
], ids=["5xx_429_ok", "401", "404", "exhausted", "429_then_403", "network_then_ok",
        "network_exhausted"])
def test_robust_post_retry_and_fatal_rules(statuses, want, monkeypatch):
    def run(p):
        monkeypatch.setattr(p.http, "_jitter", lambda: 0.25)
        order = list(statuses)

        def reply(url, data):
            s = order.pop(0)
            return (0, OSError("down")) if s == "err" else (s, {"n": len(rec.calls)})

        rec = Recorder(reply)
        sleeps = []
        try:
            resp = p.http.robust_post("http://stub/x", json={"q": "テキスト", "n": [1, 2]},
                                      headers={"X-K": "v"}, timeout=7.5, transport=rec,
                                      sleep=sleeps.append)
            result = (resp.status_code, resp.content, resp.ok)
        except ConnectionError as e:
            result = ("ConnectionError", str(e))
        return result, rec.calls, sleeps

    result, calls, sleeps = same(run)
    assert result[0] == want
    assert len(sleeps) == len(calls) - 1
    assert sleeps == [1.5**a + 0.25 for a in range(len(sleeps))]
    assert all(c[2] == {"X-K": "v", "Content-Type": "application/json"} for c in calls)


def test_robust_post_data_bytes_and_defaults():
    def run(p):
        rec = Recorder(lambda url, data: (200, b"raw"))
        resp = p.http.robust_post("http://stub/y", data=b"\x00\x01", transport=rec)
        r = p.http.HttpResponse(201, "é".encode(), {"h": "1"})
        return rec.calls, resp.text, (r.ok, r.text, r.headers, p.http.HttpResponse(302, b"").ok)

    calls, text, resp = same(run)
    assert resp == (True, "é", {"h": "1"}, False)
    assert calls == [("http://stub/y", b"\x00\x01", {}, 60.0)] and text == "raw"
    assert same(lambda p: p.http.HttpResponse(200, b'{"a": [1]}').json()) == {"a": [1]}


class _Echo(http.server.BaseHTTPRequestHandler):
    seen = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).seen.append((self.path, body, self.headers.get("Content-Type"),
                                self.headers.get("X-K")))
        status = 404 if self.path.endswith("/missing") else 200
        out = json.dumps({"path": self.path, "len": len(body)}).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


@pytest.fixture()
def echo_server(monkeypatch):
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    _Echo.seen = []
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


@pytest.mark.parametrize("branch", ["urllib", "requests"])
def test_default_transport_against_a_loopback_server(branch, echo_server, monkeypatch):
    if branch == "urllib":
        monkeypatch.setitem(sys.modules, "requests", None)  # `import requests` raises
    else:
        pytest.importorskip("requests")

    def run(p):
        got = []
        for path in ("/ok", "/missing"):
            r = p.http._default_transport(echo_server + path, b'{"x": 1}',
                                          {"Content-Type": "application/json", "X-K": "v"},
                                          10.0)
            got.append((r.status_code, r.json(), r.ok, r.headers.get("Content-Type")))
        resp = p.http.robust_post(echo_server + "/retry", json={"t": "漫画"}, timeout=10.0,
                                  sleep=lambda s: None)
        got.append((resp.status_code, resp.json()))
        return got

    out = same(run)
    assert out[0][:3] == (200, {"path": "/ok", "len": 8}, True)
    assert out[1][:3] == (404, {"path": "/missing", "len": 8}, False)
    assert [s[0] for s in _Echo.seen] == ["/ok", "/missing", "/retry"] * 2
    assert _Echo.seen[:3] == _Echo.seen[3:]
    assert _Echo.seen[0][2:] == ("application/json", "v")


# -- rate limiter and styles ------------------------------------------------------------


def test_rate_limiter_windows_acquire_costs_and_store(tmp_path):
    def run(p):
        now = [1000.0]
        sleeps = []

        def sleep(s):
            sleeps.append(s)
            now[0] += s

        limits = {"m": p.rate.ModelLimits(rpm=2, rpd=3, input_cost_per_1k=0.5,
                                          output_cost_per_1k=1.5)}
        store = str(tmp_path / f"usage_{id(p)}.json")
        lim = p.rate.RateLimiter(limits, store_path=store, clock=lambda: now[0], sleep=sleep)
        trace = [lim.try_acquire("m"), lim.try_acquire("m"), lim.try_acquire("m"),
                 lim.seconds_until_slot("m")]
        now[0] += 59.0
        trace += [lim.try_acquire("m"), lim.seconds_until_slot("m")]
        now[0] += 1.0
        trace += [lim.try_acquire("m"), lim.seconds_until_slot("m"),
                  lim.acquire("m", timeout=5.0), lim.try_acquire("free")]
        trace.append(lim.add_cost("m", 1200, 300))
        trace.append(lim.add_cost("unknown", 10, 10))
        summary = lim.usage_summary()
        lim.save()
        with open(store) as f:
            saved = json.load(f)
        back = p.rate.RateLimiter(limits, store_path=store, clock=lambda: now[0], sleep=sleep)
        blocked = p.rate.RateLimiter(
            {"b": p.rate.ModelLimits(rpm=1)}, clock=lambda: now[0], sleep=sleep)
        blocked.try_acquire("b")
        waited = blocked.acquire("b")
        return (trace, summary, saved, back.usage_summary(), sleeps, waited,
                {k: dataclasses.astuple(v) for k, v in p.rate.DEFAULT_LIMITS.items()})

    out = same(run)
    assert out[0][:3] == [True, True, False] and out[5] is True
    assert out[1]["m"]["rpd_used"] == out[3]["m"]["rpd_used"] == 3
    assert out[1]["m"]["tokens"] == out[3]["m"]["tokens"] == {"input": 1200, "output": 300}


def test_translation_styles_round_trip(tmp_path):
    def run(p):
        path = tmp_path / f"styles_{id(p)}.json"
        path.write_text(json.dumps({"Mine": "Pirate speak.", "Formal": "Very stiff."}))
        st = p.styles.TranslationStyles(str(path))
        st.set("Added", "Terse.")
        st.delete("Casual")
        st.save()
        again = p.styles.TranslationStyles(str(path))
        (tmp_path / f"bad_{id(p)}.json").write_text("[1, 2")
        bad = p.styles.TranslationStyles(str(tmp_path / f"bad_{id(p)}.json"))
        prompt = p.prompts.build_translation_prompt("猫", style_notes=again.get("Mine"))
        return again.names(), [again.get(n) for n in again.names()], bad.names(), \
            path.read_bytes(), prompt

    names, _, bad, _, prompt = same(run)
    assert "Added" in names and "Mine" in names and "Casual" in bad
    assert "Pirate speak." in prompt


# -- providers and the translation service ---------------------------------------------------


def _chat(text, usage=(11, 7)):
    return {"choices": [{"message": {"content": text}}],
            "usage": {"prompt_tokens": usage[0], "completion_tokens": usage[1]}}


def _gemini(text, usage=(5, 3)):
    return {"candidates": [{"content": {"parts": [{"text": text[:2]}, {"text": text[2:]}]}}],
            "usageMetadata": {"promptTokenCount": usage[0], "candidatesTokenCount": usage[1]}}


def _provider_reply(url, data):
    body = json.loads(data)
    if "generativelanguage" in url:
        prompt = body["contents"][0]["parts"][0]["text"]
        return 200, _gemini(f" G<{prompt[-12:]}> ")
    if "deepl" in url:
        return 200, {"translations": [{"text": f"D<{body['text'][0]}>"}]}
    return 200, _chat(f" C<{body['messages'][-1]['content'][-12:]}> ")


def test_each_provider_sends_the_jax_requests():
    def run(p):
        rec = Recorder(_provider_reply)
        out = []
        g = p.prov.GeminiClient("gk", transport=rec, timeout=9.0)
        out += [g.generate("こんにちは"), vars(g.last_usage)]
        out.append(g.generate("x", model="gemini-2.5-flash"))
        o = p.prov.OpenAIClient("ok", transport=rec)
        out += [o.generate("hi", system="be terse"), vars(o.last_usage),
                o.generate("hi", model="gpt-5-mini")]
        r = p.prov.OpenRouterClient("rk", transport=rec)
        out.append(r.generate("yo", model="meta/llama"))
        r2 = p.prov.OpenRouterClient("rk", base_url="http://stub/v1/chat", transport=rec)
        out.append(r2.generate("yo"))
        for key in ("free:fx", "pro"):
            d = p.prov.DeepLClient(key, transport=rec)
            out += [d.translate("猫", target_lang="en"), d.translate("犬", "de", source_lang="ja")]
        return out, rec.calls

    out, calls = same(run)
    assert out[0] == "G<こんにちは>" and out[1] == {"input_tokens": 5, "output_tokens": 3}
    assert len(calls) == 10
    assert calls[-1][0].startswith("https://api.deepl.com")


@pytest.mark.parametrize("reply", [
    (403, {"error": "denied"}), (200, {"candidates": []}), (200, {"choices": []}),
    (200, {"translations": []})], ids=["http_403", "gemini_shape", "chat_shape", "deepl_shape"])
def test_provider_errors_are_the_jax_errors(reply):
    def run(p):
        rec = Recorder(lambda url, data: reply)
        errs = []
        for call in (lambda: p.prov.GeminiClient("k", transport=rec).generate("a"),
                     lambda: p.prov.OpenAIClient("k", transport=rec).generate("a"),
                     lambda: p.prov.DeepLClient("k", transport=rec).translate("a")):
            try:
                errs.append(("ok", call()))
            except p.prov.ProviderError as e:
                errs.append(("ProviderError", str(e)))
        return errs, rec.calls

    errs, _ = same(run)
    assert any(kind == "ProviderError" for kind, _ in errs)


def _service(p, rec, keys=(("gemini", "g1"), ("gemini", "g2"), ("deepl", "d:fx"),
                           ("openrouter", "r1"), ("openai", "o1"))):
    s = p.settings.Settings()
    for provider, key in keys:
        s.add_key(provider, key)
    s.set("translate.openrouter.url", "http://stub/openrouter/chat")
    return p.service.TranslationService(s, transport=rec)


def test_translate_with_ai_fallback_and_sentinels():
    def run(p):
        rec = Recorder(_provider_reply)
        svc = _service(p, rec)
        out = [svc.translate_with_ai("猫です"),
               svc.translate_with_ai("犬", provider="openrouter", model="x/y", target_lang="Indonesian"),
               svc.translate_with_ai("鳥", provider="openai", is_enhanced=True,
                                     ocr_results={"manga_ocr": "鳥", "preprocessed": "烏"},
                                     context="a scene"),
               svc.translate_with_ai("魚", provider="nope"),  # ProviderError -> DeepL
               svc.translate_text("魚", target_lang="Japanese"),
               svc.translate_text("魚", target_lang="French")]
        failing = Recorder(lambda url, data: (403, {"e": 1}) if "deepl" not in url
                           else _provider_reply(url, data))
        out.append(_service(p, failing).translate_with_ai("蛙"))  # AI 403 -> DeepL
        dead = Recorder(lambda url, data: (403, {"e": 1}))
        out.append(_service(p, dead).translate_with_ai("蛙"))  # both fail -> sentinel
        out.append(_service(p, rec, keys=()).translate_with_ai("蛙"))  # no key at all
        boom = Recorder(lambda url, data: (200, b"not json"))
        out.append(_service(p, boom).translate_with_ai("蛙"))  # unexpected -> sentinel
        usage = svc.limiter.usage_summary()
        for v in usage.values():
            v.pop("rpm_used")
        return out, rec.calls + failing.calls + dead.calls, usage

    out, calls, _ = same(run)
    assert out[0].startswith("G<") and out[3] == "D<魚>" and out[6] == "D<蛙>"
    assert out[7] == out[8] == "[ERROR: translation failed via gemini/gemini-2.5-flash-lite]"
    assert out[9].startswith("[ERROR: JSONDecodeError")
    assert calls[0][0].endswith("?key=g1") and calls[1][0] == "http://stub/openrouter/chat"


def test_translate_for_job_batch_scene_and_review():
    replies = {"batch": "1. one\n2) two\n\n4. four", "scene": "[Text 1]\nOriginal: x\nA\n[Text 2] B",
               "review": 'sure ```json\n[{"index": 0, "verdict": "fix", "suggestion": "S"}, 3]```'}

    def reply(url, data):
        if "generativelanguage" not in url:
            return _provider_reply(url, data)
        prompt = json.loads(data)["contents"][0]["parts"][0]["text"]
        kind = ("batch" if "numbered" in prompt else "scene" if "[Text 1]" in prompt
                else "review" if "JSON array" in prompt else None)
        return (200, _gemini(replies[kind])) if kind else _provider_reply(url, data)

    def run(p):
        rec = Recorder(reply)
        svc = _service(p, rec)
        out = [svc.translate_for_job("猫", {"use_ai_only_translate": True,
                                            "ai_model": ("openrouter", "m/x"),
                                            "is_enhanced": True,
                                            "ocr_results": {"a": "1", "b": "2"}}),
               svc.translate_for_job("猫", {"use_deepl_only_translate": True,
                                            "target_lang": "Indonesian"}),
               svc.translate_for_job("猫", None),
               svc.translate_batch(["a", "b", "c", "d"]), svc.translate_batch([]),
               svc.review_scene([("o1", "t1"), ("o2", "t2")], instruction="tighter"),
               svc.review_scene([]),
               svc.review_batch([("o1", "t1")], mode="quality"), svc.review_batch([])]
        nokey = _service(p, rec, keys=())
        out += [nokey.translate_batch(["a", "b"]), nokey.review_scene([("o", "t")]),
                nokey.review_batch([("o", "t")])]
        return out, rec.calls

    out, calls = same(run)
    assert out[3] == ["one", "two", None, "four"] and out[5] == ["A", "B"]
    assert out[7] == [{"index": 0, "verdict": "fix", "suggestion": "S"}]
    assert out[9] == [None, None] and out[10] == [None] and out[11] == []


def test_prompt_builders_and_parsers_as_jax():
    entries = [("原文", "translation"), ("二", 'has "quotes"')]
    for name in ("build_batch_prompt", "build_scene_prompt", "build_review_prompt"):
        args = (["a", "b"],) if name == "build_batch_prompt" else (entries,)
        assert same(lambda p: getattr(p.prompts, name)(*args)) is not None
    for reply in ("1. a\n 2: b \n3)\nx", "[text 2] two\n[Text 1]\none\n[Text 9] nine", "no"):
        same(lambda p: (p.prompts.parse_numbered_response(reply, 3),
                        p.prompts.parse_scene_response(reply, 3),
                        p.prompts.parse_json_array_response(reply)))
    assert same(lambda p: p.prompts.parse_json_array_response("[1, {\"a\": 2}, bad")) == []


# -- AI-OCR --------------------------------------------------------------------------------


def _crop(seed=0, hw=(40, 60)):
    rng = np.random.default_rng(seed)
    img = np.full((*hw, 3), 240, np.uint8)
    img[15:25, 10:50] = rng.integers(0, 60, (10, 40, 3), dtype=np.uint8)
    return img


def test_ai_ocr_ladder_cache_and_gemini(tmp_path):
    def run(p):
        seq = [400, 422, 200, 200]
        ladder = Recorder(lambda url, data: (seq.pop(0), _chat("ドラゴン")))
        cache = tmp_path / f"cache_{id(p)}"
        eng = p.ai.AiOcrEngine("https://api.example/v1/chat/completions", api_key="k",
                               model="gpt-4o-mini", cache_dir=str(cache), transport=ladder)
        out = [eng.perform_ocr(_crop(), {"ocr_lang": "ja"}),
               eng.perform_ocr(_crop(), {"ocr_lang": "ja"}),  # from the cache
               eng.perform_ocr(_crop(1), {"ocr_lang": "en", "ocr_ai_model_id": "gpt-5-x"})]
        files = sorted((f.name, f.read_bytes()) for f in cache.iterdir())
        gem = Recorder(lambda url, data: (200, _gemini("文字")))
        g = p.ai.AiOcrEngine("https://generativelanguage.googleapis.com/v1beta/models/m:gen",
                             api_key="gk", transport=gem)
        out += [g.perform_ocr(_crop(2), {"ai_ocr_prompt": "custom"}),
                p.ai.AiOcrEngine("https://generativelanguage.googleapis.com/x",
                                 transport=Recorder(lambda u, d: (200, {}))).perform_ocr(_crop()),
                p.ai.AiOcrEngine("https://generativelanguage.googleapis.com/x",
                                 transport=Recorder(lambda u, d: (401, {}))).perform_ocr(_crop()),
                p.ai.AiOcrEngine("https://x/v1", transport=Recorder(
                    lambda u, d: (422, {}))).perform_ocr(_crop()),
                p.ai.AiOcrEngine("https://x/v1").perform_ocr(np.zeros((0, 0, 3), np.uint8)),
                p.ai.ocr_prompt("ja"), p.ai.ocr_prompt("en")]
        return out, ladder.calls, gem.calls, files

    out, ladder, gem, files = same(run)
    assert out[:2] == ["ドラゴン", "ドラゴン"] and out[3] == "文字"
    assert [json.loads(c[1])["messages"][0]["content"][1]["type"] for c in ladder[:2]] == [
        "image_url", "input_image"]
    assert len(ladder) == 3 + 1 and len(files) == 2  # the second call hit the cache
    assert out[6] == "[ERROR: AI_OCR: HTTP 422]"
    assert gem[0][0].endswith("?key=gk")


def test_engine_from_settings_as_jax(tmp_path):
    root = {"ocr": {"openrouter": {"url": " https://or/v1 ", "api_key": "ok",
                                   "models": [{"id": "a"}, {"id": "b", "active": True}]},
                    "other": {"url": "", "api_key": "x"}}}

    def run(p):
        out = []
        for job in ({"ocr_ai_provider": "openrouter"},
                    {"ocr_ai_provider": "openrouter", "ocr_ai_model_name": "named"},
                    {"ocr_ai_provider": "other"}, {}):
            e = p.ai.engine_from_settings(root, job, cache_dir=str(tmp_path / "c"))
            out.append(None if e is None else (e.url, e.api_key, e.model, e.cache_dir))
        return out

    assert same(run)[:2] == [("https://or/v1", "ok", "b", str(tmp_path / "c")),
                             ("https://or/v1", "ok", "named", str(tmp_path / "c"))]


# -- review ------------------------------------------------------------------------------------


def _project(p, n=3):
    proj = p.project.Project()
    for i in range(n):
        area = p.Area(rect=p.Rect(0, i * 50, 100, 40), text=f"tr{i}")
        proj.add_area("p.png", area, push_undo=False)
        proj.register_history_entry("p.png", area, f"orig{i}", f"tr{i}")
    for e in proj.history_entries:
        e["timestamp"] = 0.0
    return proj


def _payload(proj):
    out = proj.to_payload()
    out.pop("saved_at")
    return out


def test_review_pass_scenes_and_suggestions_on_one_project():
    review = json.dumps([{"index": 0, "verdict": "fix", "suggestion": "Better zero"},
                         {"index": 1, "verdict": "ok", "suggestion": "ignored"},
                         {"index": 2, "verdict": "fix", "suggestion": ""},
                         {"index": 7, "verdict": "fix", "suggestion": "out of range"},
                         {"index": "1", "verdict": "fix"}])

    def reply(url, data):
        prompt = json.loads(data)["contents"][0]["parts"][0]["text"]
        if "[Text 1]" in prompt:
            return 200, _gemini("[Text 1]\nScene one\n[Text 2]\nScene two")
        return 200, _gemini(review)

    def run(p):
        rec = Recorder(reply)
        svc = _service(p, rec)
        proj = _project(p)
        mgr = p.review.SceneManager(proj)
        ids = [e["id"] for e in proj.history_entries]
        scene = mgr.create_scene("ch1", ids[1:])
        mgr.create_scene("ch1", ids[1:])
        mgr.create_scene("gone", ids[:1])
        mgr.delete_scene("gone")
        mgr.delete_scene("never")
        revised = mgr.revise_with_ai("ch1", svc, instruction="snappier")
        updated = mgr.apply_to_areas("ch1")
        empty = (mgr.scene_entries("none"), mgr.revise_with_ai("none", svc))
        records = p.review.run_review_pass(proj, svc)
        quality = p.review.run_review_pass(proj, svc, mode="quality", history_ids=ids[:2])
        none = p.review.run_review_pass(proj, svc, history_ids=[])
        applied = p.review.apply_review_suggestions(proj, records)
        applied_all = p.review.apply_review_suggestions(proj, quality, only_fix=False)
        return (scene, revised, updated, empty, records, quality, none, applied, applied_all,
                _payload(proj), rec.calls)

    out = same(run)
    assert out[1] == [("h2", "Scene one"), ("h3", "Scene two")] and out[2] == 2
    assert out[4][0] == {"history_id": "h1", "verdict": "fix", "suggestion": "Better zero",
                         "mode": "proofread"}
    assert out[7] == 1 and out[9]["scene_order"] == ["ch1"]


# -- the engine registry ------------------------------------------------------------------------


class RecordingEngine:
    def __init__(self, replies):
        self.replies = list(replies)
        self.seen = []

    def perform_ocr(self, image, settings=None):
        self.seen.append((np.asarray(image).copy(), dict(settings or {})))
        reply = self.replies.pop(0)
        if isinstance(reply, Exception):
            raise reply
        return reply


def _registry(p, engines: dict):
    reg = p.reg.EngineRegistry(*p.device)
    for name, eng in engines.items():
        reg.register(name, eng)
    return reg


DISPATCH_CASES = {
    "japanese_to_manga_ocr": ({"ocr_engine": "Tesseract", "ocr_lang": "jpn"},
                              {"Manga-OCR": ["jp"], "Tesseract": ["never"]}),
    "ai_gets_the_raw_crop": ({"ocr_engine": "AI_OCR", "ocr_lang": "en"},
                             {"AI_OCR": ["ai"], "Manga-OCR": ["never"]}),
    "latin_preprocessed": ({"ocr_engine": "Tesseract", "ocr_lang": "en",
                            "orientation": "Vertical"}, {"Tesseract": ["latin"]}),
    "latin_empty_retries_raw": ({"ocr_engine": "Tesseract", "ocr_lang": "en"},
                                {"Tesseract": ["  ", "raw worked"]}),
    "latin_error_retries_raw": ({"ocr_engine": "EasyOCR", "ocr_lang": "ko",
                                 "orientation": "Horizontal"},
                                {"EasyOCR": ["[ERROR: x]", "raw"]}),
    "engine_raises": ({"ocr_engine": "Manga-OCR", "ocr_lang": "ja"},
                      {"Manga-OCR": [ValueError("boom")]}),
    "not_installed": ({"ocr_engine": "PaddleOCR", "ocr_lang": "en"}, {}),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_registry_dispatch_rules_as_jax(case):
    settings, replies = DISPATCH_CASES[case]
    crop = _crop(3, (45, 70))

    def run(p):
        engines = {k: RecordingEngine(v) for k, v in replies.items()}
        reg = _registry(p, engines)
        out = reg.perform_ocr(crop.copy(), dict(settings))
        seen = {k: [(img.shape, img.tobytes(), s) for img, s in e.seen]
                for k, e in engines.items()}
        return out, seen

    out, seen = same(run)
    if case == "latin_preprocessed":
        img = np.frombuffer(seen["Tesseract"][0][1], np.uint8)
        assert set(np.unique(img)) <= {0, 255}
    if case.startswith("latin_") and case.endswith("raw"):
        assert seen[list(seen)[0]][1][1] == crop.tobytes()
    if case in ("japanese_to_manga_ocr", "ai_gets_the_raw_crop"):
        assert [len(v) for v in seen.values()] == [1, 0]
        assert seen[list(seen)[0]][0][1] == crop.tobytes()
    if case == "engine_raises":
        assert out == "[ERROR: Manga-OCR: ValueError: boom]"


def test_registry_lazy_engines_languages_and_probes():
    def run(p):
        reg = _registry(p, {"Manga-OCR": RecordingEngine([]), "AI_OCR": RecordingEngine([])})
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) == 1:
                raise OSError("offline")
            return RecordingEngine(["ok"])

        reg.register_lazy("Flaky", flaky)
        reg.register_lazy("Probed", lambda: RecordingEngine([]), probe=lambda: False)
        reg.register_lazy("Bad", lambda: 1 / 0, probe=lambda: 1 / 0)
        first = reg.get("Flaky")  # the failed factory stays registered
        avail = reg.available_engines()
        langs = reg.ocr_languages()
        return first is None, avail, langs, reg.get("missing"), len(calls)

    out = same(run)
    assert out[1] == ["AI_OCR", "Flaky", "Manga-OCR"]

    def defaults(p):
        reg = p.reg.make_default_registry(RecordingEngine([]), RecordingEngine([]),
                                          settings={"tpu": {"latin_craft_checkpoint": "/nope/c",
                                                            "latin_crnn_checkpoint": "/nope/r"}},
                                          **({"device": "cpu"} if p.device else {}))
        names = sorted(set(reg._engines) | set(reg._factories))
        return names, reg.available_engines(), reg.get("Latin (TPU)")

    names, avail, latin = same(defaults)
    assert "Latin (TPU)" in names and "Latin (TPU)" not in avail and latin is None
    assert {"Tesseract", "EasyOCR", "PaddleOCR", "DocTR", "RapidOCR"} <= set(names)


def _fixture_crops():
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "eval", "*.png")))
    return [np.asarray(Image.open(p).convert("RGB"))[..., ::-1].copy() for p in paths]


@pytest.mark.parametrize("orientation", ["Auto-Detect", "Vertical", "Horizontal", "sideways"])
def test_latin_preprocess_bytes_equal_jax(orientation):
    crops = _fixture_crops()
    assert len(crops) == 20
    for crop in crops:
        want = jreg._latin_preprocess(crop, {"orientation": orientation})
        got = treg._latin_preprocess(crop, {"orientation": orientation}, "cpu")
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_registry_refuses_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        treg.EngineRegistry()
    with pytest.raises(RuntimeError, match="CUDA"):
        treg.make_default_registry()
    assert treg.EngineRegistry("cpu").device == torch.device("cpu")


def test_tesseract_engine_on_a_stand_in_binary(tmp_path, monkeypatch):
    """No tesseract here: a stand-in script records its arguments and prints
    a reply; both packages call it the same way."""
    log = tmp_path / "argv.txt"
    fake = tmp_path / "tesseract"
    fake.write_text(f"#!/bin/sh\necho \"$2 $3 $4 $5 $6 $7 $8 $9\" >> {log}\n"
                    "[ \"$4\" = bad ] && { echo oops >&2; exit 3; }\necho ' read it '\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)

    def run(p):
        eng = p.reg.TesseractEngine(str(fake))
        return [eng.perform_ocr(_crop(), None),
                eng.perform_ocr(_crop(), {"orientation": "Vertical", "tesseract_lang": "jpn"}),
                eng.perform_ocr(_crop(), {"tesseract_lang": "bad"})]

    out = same(run)
    assert out[:2] == ["read it", "read it"] and out[2] == "[ERROR: TESSERACT: oops\n]"
    lines = log.read_text().splitlines()
    assert lines[:3] == lines[3:] and lines[1] == "stdout -l jpn --oem 1 --psm 5 "
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))

    def missing(p):
        try:
            p.reg.TesseractEngine()
        except RuntimeError as e:
            return str(e)

    assert same(missing) == "tesseract binary not found"
