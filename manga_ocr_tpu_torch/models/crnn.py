"""CTC text recognizer on PyTorch (VGG-BiLSTM-CTC, the EasyOCR recognition
net; counterpart of ``manga_ocr_tpu/models/crnn.py``).

The reference's Latin OCR engines recognize text through pip black boxes
(EasyOCR dispatch at ``main_window.py:9805-9810``).  EasyOCR's recognizer is
the "None-VGG-BiLSTM-CTC" configuration of the public
deep-text-recognition-benchmark model zoo:

- feature extractor: 7-conv VGG over gray line crops (H fixed, W variable),
  pooling H fully away -> a per-column feature sequence [B, T, C]
  (T = W/4 - 1 at the default geometry),
- sequence model: two bidirectional LSTMs (torch gate order i, f, g, o, one
  summed bias), each followed by a linear projection,
- prediction: linear to charset+1 logits per column; CTC greedy decode
  (collapse repeats, drop blank index 0) on the host.

Plain PyTorch on the device, f32 with TF32 off (``engine/latin.py`` runs it
under ``fp32_products``; cuDNN's LSTM obeys the same flag); the JAX graph
has no Pallas kernel.  Each BiLSTM is an ``nn.LSTM`` built on the meta
device and loaded from the tree (``_lstm_module``), never drawn from
torch's default init.  Both directions run over the whole padded bucket
width, as JAX's ``lax.scan`` does: packing sequences by their valid widths
would change the backward direction's output.  ``crnn_forward(...,
grad=True)`` is the training forward (``train_latin``): the LSTMs compute
with the tree's own tensors (``_lstm_call``), so gradients reach them.

Parameters keep the JAX package's tree with PyTorch's layouts: OIHW convs,
[O, I] linears, LSTM directions as ``{"w_ih": [4H, I], "w_hh": [4H, H],
"bias": [4H]}``; ``params_from_jax``/``params_to_jax`` cross to JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CrnnConfig:
    num_classes: int = 97  # charset + blank(0); easyocr english_g2 ~97
    input_height: int = 32
    output_channel: int = 512  # VGG final width; stage widths derive /8,/4,/2
    hidden_size: int = 256
    blank_id: int = 0

    @property
    def stage_channels(self) -> tuple:
        oc = self.output_channel
        return (oc // 8, oc // 4, oc // 2, oc)


def _conv(x, p, pad=None):
    w = p["kernel"]
    return F.conv2d(x, w, p["bias"], 1,
                    w.shape[-1] // 2 if pad is None else pad)


def features_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Gray line crops [B, 1, H, W] (float, (v/255 - .5)/.5) -> per-column
    features [B, T, C]; T = W/4 - 1 at the default geometry."""
    r = torch.relu
    x = F.max_pool2d(r(_conv(x, params["conv0"])), 2, 2)
    x = F.max_pool2d(r(_conv(x, params["conv1"])), 2, 2)
    x = r(_conv(x, params["conv2"]))
    x = F.max_pool2d(r(_conv(x, params["conv3"])), (2, 1), (2, 1))
    x = r(_conv(x, params["conv4"]))  # BN folded into kernel+bias
    x = F.max_pool2d(r(_conv(x, params["conv5"])), (2, 1), (2, 1))
    x = r(_conv(x, params["conv6"], pad=0))  # 2x2 conv, valid
    # H is pooled to 1 at input_height=32 (32->16->8->4->2->1); the mean over
    # any residual H is the torch model's adaptive average pool
    return x.mean(dim=2).transpose(1, 2)  # [B, W', C]


def _lstm_module(dirs: list) -> nn.LSTM:
    """A one-layer ``nn.LSTM`` (bidirectional for two directions) holding the
    given directions' weights: built on the meta device (no default init, no
    draw from torch's RNG), materialized on the weights' device, ``bias_ih``
    the summed bias and ``bias_hh`` zero, its weights flattened for cuDNN."""
    w_ih = dirs[0]["w_ih"]
    with torch.device("meta"):
        m = nn.LSTM(w_ih.shape[1], dirs[0]["w_hh"].shape[1], batch_first=True,
                    bidirectional=len(dirs) == 2)
    m = m.to_empty(device=w_ih.device)
    with torch.no_grad():
        for d, sfx in zip(dirs, ("", "_reverse")):
            getattr(m, f"weight_ih_l0{sfx}").copy_(d["w_ih"])
            getattr(m, f"weight_hh_l0{sfx}").copy_(d["w_hh"])
            getattr(m, f"bias_ih_l0{sfx}").copy_(d["bias"])
            getattr(m, f"bias_hh_l0{sfx}").zero_()
    m.flatten_parameters()
    return m.eval().requires_grad_(False)


def _lstm_scan(p: dict, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One direction of the LSTM over [B, T, I] -> [B, T, H]; ``reverse``
    runs from the last column with zero state and keeps the output aligned
    with its input column (the backward half of a BiLSTM)."""
    m = _lstm_module([p])
    with torch.no_grad():
        out, _ = m(x.flip(1) if reverse else x)
    return out.flip(1) if reverse else out


def _lstm_call(dirs: list):
    """The BiLSTM over the given directions as a callable [B, T, I] ->
    ([B, T, 2H], state) that computes with the tree's own tensors, so
    gradients reach them: a meta-built ``nn.LSTM`` called through
    ``torch.func.functional_call`` with ``w_ih``, ``w_hh`` and the summed
    ``bias`` as ``bias_ih``, and ``bias_hh`` a zero constant that is never
    a leaf of the tree (JAX has one bias a direction, so no optimizer may
    train a second).  The module is in training mode, since cuDNN refuses
    an RNN backward in eval mode; it has no dropout, so the math is the
    same."""
    with torch.device("meta"):
        m = nn.LSTM(dirs[0]["w_ih"].shape[1], dirs[0]["w_hh"].shape[1], batch_first=True,
                    bidirectional=len(dirs) == 2)
    tensors = {}
    for d, sfx in zip(dirs, ("", "_reverse")):
        tensors[f"weight_ih_l0{sfx}"] = d["w_ih"]
        tensors[f"weight_hh_l0{sfx}"] = d["w_hh"]
        tensors[f"bias_ih_l0{sfx}"] = d["bias"]
        tensors[f"bias_hh_l0{sfx}"] = torch.zeros_like(d["bias"], requires_grad=False)
    m.train()
    return lambda x: torch.func.functional_call(m, tensors, (x,))


class Crnn:
    """The recognizer's tree on one device, with each BiLSTM as an
    ``nn.LSTM`` (``_lstm_module``) built once."""

    def __init__(self, params: dict):
        self.params = params
        self.lstms = [_lstm_module([params[f"rnn{n}"]["fwd"], params[f"rnn{n}"]["bwd"]])
                      for n in range(2)]


def bilstm_forward(p: dict, lstm, x: torch.Tensor) -> torch.Tensor:
    """BidirectionalLSTM block: biLSTM + linear (torch module shape);
    ``lstm`` an ``nn.LSTM`` or ``_lstm_call``'s callable."""
    h, _ = lstm(x)  # [B, T, 2H]: forward, then backward
    return F.linear(h, p["linear"]["kernel"], p["linear"]["bias"])


def _logits(p: dict, x: torch.Tensor, lstms: list) -> torch.Tensor:
    h = features_forward(p["features"], x)
    for n, lstm in enumerate(lstms):
        h = bilstm_forward(p[f"rnn{n}"], lstm, h)
    return F.linear(h, p["head"]["kernel"], p["head"]["bias"])


def crnn_forward(params, x: torch.Tensor, grad: bool = False) -> torch.Tensor:
    """[B, 1, H, W] normalized gray crops -> per-column logits [B, T, K].
    ``params``: a ``Crnn`` or the port's tree; ``grad=True`` (the port's
    tree only) carries gradients to the tree's leaves, else no graph is
    built."""
    if grad:
        lstms = [_lstm_call([params[f"rnn{n}"]["fwd"], params[f"rnn{n}"]["bwd"]])
                 for n in range(2)]
        return _logits(params, x, lstms)
    net = params if isinstance(params, Crnn) else Crnn(params)
    with torch.no_grad():
        return _logits(net.params, x, net.lstms)


def ctc_greedy(logits: np.ndarray, lengths: np.ndarray | None, blank_id: int = 0):
    """Host-side CTC best-path decode: argmax per column, collapse repeats,
    drop blanks.  ``lengths``: optional valid column count per row (width-
    padded batches).  Returns list of id lists."""
    ids = np.asarray(logits).argmax(axis=-1)  # [B, T]
    out = []
    for b in range(ids.shape[0]):
        t_end = int(lengths[b]) if lengths is not None else ids.shape[1]
        row, prev = [], blank_id
        for t in range(t_end):
            k = int(ids[b, t])
            if k != blank_id and k != prev:
                row.append(k)
            prev = k
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# Parameters (random; real weights via models/convert_latin.py)
# ---------------------------------------------------------------------------


def init_crnn_params_numpy(cfg: CrnnConfig, seed: int = 0) -> dict:
    """Random weights in the JAX package's layout (HWIO convs, [I, O]
    linears, [I, 4H] / [H, 4H] LSTM weights; numpy f32), drawn as JAX's
    ``init_crnn_params`` draws them -- He-normal convs with zero biases,
    linears and LSTMs uniform in +-1/sqrt(fan) -- from
    ``np.random.default_rng(seed)`` in tree order."""
    rng = np.random.default_rng(seed)
    c1, c2, c3, c4 = cfg.stage_channels
    hs = cfg.hidden_size

    def conv(k, cin, cout):
        w = rng.standard_normal((k, k, cin, cout), dtype=np.float32)
        return {"kernel": (w * np.sqrt(2.0 / (k * k * cin))).astype(np.float32),
                "bias": np.zeros((cout,), np.float32)}

    def uniform(scale, shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    def linear(cin, cout):
        s = 1.0 / np.sqrt(cin)
        return {"kernel": uniform(s, (cin, cout)), "bias": uniform(s, (cout,))}

    def lstm_dir(cin):
        s = 1.0 / np.sqrt(hs)
        return {"w_ih": uniform(s, (cin, 4 * hs)), "w_hh": uniform(s, (hs, 4 * hs)),
                "bias": uniform(s, (4 * hs,))}

    features = {"conv0": conv(3, 1, c1), "conv1": conv(3, c1, c2), "conv2": conv(3, c2, c3),
                "conv3": conv(3, c3, c3), "conv4": conv(3, c3, c4), "conv5": conv(3, c4, c4),
                "conv6": conv(2, c4, c4)}
    return {
        "features": features,
        "rnn0": {"fwd": lstm_dir(c4), "bwd": lstm_dir(c4), "linear": linear(2 * hs, hs)},
        "rnn1": {"fwd": lstm_dir(hs), "bwd": lstm_dir(hs), "linear": linear(2 * hs, hs)},
        "head": linear(hs, cfg.num_classes),
    }


def _convert(tree, conv, mat):
    """Apply ``conv`` to each conv leaf's kernel and ``mat`` to each linear
    kernel and LSTM weight (the two layouts differ by a transpose each)."""
    out = {"features": {k: {"kernel": conv(p["kernel"]), "bias": mat(p["bias"], False)}
                        for k, p in tree["features"].items()}}
    for n in range(2):
        r = tree[f"rnn{n}"]
        out[f"rnn{n}"] = {
            d: {"w_ih": mat(r[d]["w_ih"]), "w_hh": mat(r[d]["w_hh"]), "bias": mat(r[d]["bias"], False)}
            for d in ("fwd", "bwd")}
        out[f"rnn{n}"]["linear"] = {"kernel": mat(r["linear"]["kernel"]),
                                    "bias": mat(r["linear"]["bias"], False)}
    out["head"] = {"kernel": mat(tree["head"]["kernel"]), "bias": mat(tree["head"]["bias"], False)}
    return out


def params_from_jax(tree, device="cpu") -> dict:
    """The JAX package's tree (numpy or JAX arrays) -> the port's (tensors on
    ``device``)."""

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32))

    return _convert(
        tree,
        lambda k: tensor(k).permute(3, 2, 0, 1).contiguous().to(device),
        lambda a, t=True: (tensor(a).T.contiguous() if t else tensor(a)).to(device))


def params_to_jax(params) -> dict:
    """The port's tree (or a ``Crnn``) -> the JAX package's layout as numpy f32."""
    if isinstance(params, Crnn):
        params = params.params

    def host(a):
        return a.detach().cpu()

    return _convert(
        params,
        lambda k: np.ascontiguousarray(host(k).permute(2, 3, 1, 0).numpy()),
        lambda a, t=True: np.ascontiguousarray((host(a).T if t else host(a)).numpy()))


def init_crnn_params(cfg: CrnnConfig, seed: int = 0, device="cpu") -> dict:
    """``init_crnn_params_numpy`` as the port's tree on ``device``."""
    return params_from_jax(init_crnn_params_numpy(cfg, seed), device)
