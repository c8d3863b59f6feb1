"""The port's multi-process mesh (``parallel/multihost.py``) on
``torch.distributed``: two gloo ranks, each a subprocess that imports torch
and the port only, form one global mesh, run the port's ``ocr_forward`` on
their own rows (2 and 3: unequal counts) through ``global_batch`` and read
every rank's tokens back with ``gather_to_hosts``.  Both ranks' gathers
must be equal, and equal to one process running the whole batch; the
tolerance is token matrices equal.  Then the two ranks take one train step
together on a (2 data x 2 model) global mesh (each rank one data row of two
CPU columns), on their own rows with loss masks that differ by rank: both
report the same loss, within 2e-5 relative of one process's loss on the
whole batch (the JAX package's bound), and hold bit-equal params after it.
``make_global_mesh``'s per-process block check runs here on fake
devices."""

import inspect
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from manga_ocr_tpu_torch.models import model as mdl
from manga_ocr_tpu_torch.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models.params import init_params
from manga_ocr_tpu_torch.parallel import multihost as mh
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (2, 3)  # each rank's rows of the global batch
MAX_LEN = 8

WORKER = """
import json, sys
sys.path.insert(0, {repo!r})
rank, port = int(sys.argv[1]), sys.argv[2]
import numpy as np
import torch
import torch.distributed as dist
from manga_ocr_tpu_torch.models import model as mdl
from manga_ocr_tpu_torch.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models.params import init_params
from manga_ocr_tpu_torch.parallel import multihost as mh

{train_rows}

mh.initialize(f"127.0.0.1:{{port}}", num_processes=2, process_id=rank)
mh.initialize(f"127.0.0.1:{{port}}", num_processes=2, process_id=rank)  # idempotent
mesh = mh.make_global_mesh()
cfg = MangaOCRConfig.tiny()
params = init_params(cfg, 0, "cpu", std=0.1)  # the same numpy seed on every rank
size = cfg.encoder.image_size
local = np.random.default_rng(100 + rank).normal(size=({rows}[rank], size, size, 3))
px, offset = mh.global_batch(local.astype(np.float32), mesh)
with torch.inference_mode():
    out = mdl.ocr_forward(params, px, cfg, max_length={max_len})
tokens = mh.gather_to_hosts(out.tokens)
lengths = mh.gather_to_hosts(out.lengths)

# one train step on a (2 data x 2 model) global mesh: a row of two CPU
# columns per rank; this rank's rows of the global batch, its own masks
import hashlib
from manga_ocr_tpu_torch import train as ttr
from manga_ocr_tpu_torch.parallel import mesh as meshlib
tmesh = mh.make_global_mesh(n_model=2, devices=[
    mh.RankDevice(r, torch.device("cpu")) for r in range(2) for _ in range(2)])
grid, state = ttr.init_train_state(cfg, ttr.make_optimizer(), device="cpu", init_params=params,
                                   mesh=tmesh)
toks, masks = train_rows(cfg)
lo = sum({rows}[:rank])
batch = ttr.TrainBatch(torch.from_numpy(local.astype(np.float32)),
                       torch.from_numpy(toks[lo:lo + {rows}[rank]]),
                       torch.from_numpy(masks[lo:lo + {rows}[rank]]))
grid, state, loss = ttr.make_train_step(cfg, tmesh)(grid, state, batch)
mine = [i for i, cols in enumerate(grid) if cols is not None]
full = meshlib.unshard_params(grid[mine[0]])
digest = hashlib.sha256()
for _, t in ttr._leaves(full):
    digest.update(t.detach().numpy().tobytes())
mh.sync("done")
print("RESULT " + json.dumps({{
    "rank": rank, "backend": dist.get_backend(), "shape": mesh.shape,
    "devices": [[d.process_index, str(d.device)] for d in mesh.data_devices],
    "offset": offset, "tokens": tokens.tolist(), "lengths": lengths.tolist(),
    "train_shape": tmesh.shape, "rows_here": mine, "loss": float(loss),
    "params": digest.hexdigest()}}), flush=True)
dist.destroy_process_group()
"""


def train_rows(cfg):
    """The global batch's tokens (BOS first) and loss masks: rank 0's rows
    count every label, rank 1's rows fewer, one count a row."""
    toks = np.random.default_rng(7).integers(4, cfg.decoder.vocab_size,
                                             size=(sum(ROWS), 8)).astype(np.int32)
    toks[:, 0] = cfg.decoder.bos_token_id
    masks = np.ones(toks.shape, np.float32)
    for r in range(ROWS[0], sum(ROWS)):
        masks[r, 2 + r:] = 0.0
    return toks, masks


TRAIN_ROWS = """import numpy as np
ROWS = {rows}


""" + inspect.getsource(train_rows)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _full_batch(size: int) -> np.ndarray:
    return np.concatenate([np.random.default_rng(100 + r).normal(size=(n, size, size, 3))
                           for r, n in enumerate(ROWS)]).astype(np.float32)


def test_two_gloo_ranks_gather_the_single_process_tokens(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, rows=ROWS, max_len=MAX_LEN,
                                    train_rows=TRAIN_ROWS.format(rows=ROWS)))
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    d = json.loads(line[len("RESULT "):])
                    results[d["rank"]] = d
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert set(results) == {0, 1}
    for r in (0, 1):
        assert results[r]["backend"] == "gloo"  # no CUDA here
        assert results[r]["shape"] == {"data": 2, "model": 1}
        assert results[r]["devices"] == [[0, "cpu"], [1, "cpu"]]
    assert (results[0]["offset"], results[1]["offset"]) == (0, ROWS[0])
    assert results[0]["tokens"] == results[1]["tokens"]
    assert results[0]["lengths"] == results[1]["lengths"]

    cfg = MangaOCRConfig.tiny()
    with torch.inference_mode():
        ref = mdl.ocr_forward(init_params(cfg, 0, "cpu", std=0.1),
                              torch.from_numpy(_full_batch(cfg.encoder.image_size)), cfg, max_length=MAX_LEN)
    np.testing.assert_array_equal(np.asarray(results[0]["tokens"]), ref.tokens.numpy())
    np.testing.assert_array_equal(np.asarray(results[0]["lengths"]), ref.lengths.numpy())
    assert len({tuple(t) for t in results[0]["tokens"]}) > 1  # tokens depend on the rows

    # the train step: one (2, 2) mesh over both ranks, one data row each
    from manga_ocr_tpu_torch import train as ttr

    for r in (0, 1):
        assert results[r]["train_shape"] == {"data": 2, "model": 2}
        assert results[r]["rows_here"] == [r]
    assert results[0]["loss"] == results[1]["loss"]
    assert results[0]["params"] == results[1]["params"]
    toks, masks = train_rows(cfg)
    with torch.no_grad():
        want = ttr.loss_fn(init_params(cfg, 0, "cpu", std=0.1), ttr.TrainBatch(
            torch.from_numpy(_full_batch(cfg.encoder.image_size)), torch.from_numpy(toks),
            torch.from_numpy(masks)), cfg)
    np.testing.assert_allclose(results[0]["loss"], float(want), rtol=2e-5)


class FakeDev:
    def __init__(self, pid, i=0):
        self.process_index = pid
        self.device = torch.device("cpu")
        self.i = i


def test_make_global_mesh_blocks_per_process():
    devs = [FakeDev(0, i) for i in range(4)] + [FakeDev(1, i) for i in range(4)]
    mesh = mh.make_global_mesh(n_model=2, devices=devs)
    assert mesh.shape == {"data": 4, "model": 2}
    assert [[(d.process_index, d.i) for d in row] for row in mesh.devices] == [
        [(0, 0), (0, 1)], [(0, 2), (0, 3)], [(1, 0), (1, 1)], [(1, 2), (1, 3)]]
    assert mh.make_global_mesh(devices=devs).shape == {"data": 8, "model": 1}


def test_make_global_mesh_rejects_cross_host_model_shard():
    """4 + 2 devices divide into model=3 globally but not per process: a
    model shard would straddle two hosts, so it is refused."""
    devs = [FakeDev(0)] * 4 + [FakeDev(1)] * 2
    with pytest.raises(ValueError, match="not divisible"):
        mh.make_global_mesh(n_model=3, devices=devs)
    with pytest.raises(ValueError, match="do not divide"):
        mh.make_global_mesh(n_model=4, devices=devs)


def test_initialize_needs_an_address(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mh.initialize(num_processes=1, process_id=0)
